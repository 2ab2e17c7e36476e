"""WALL-E's parallel-sampler architecture (N rollout samplers, the
agent/learner loop, the policy and experience queues) behind the
``SamplerBackend`` seam, with the fused engine on CUDA graphs.

The entry point is ``repro_torch.experiment.run``; the names below keep the
reference's imports (``from repro.core import SyncRunner, make_backend,
...``) working on the port. They load on first use, so a process that
imports only ``core.ipc`` (a rollout worker, before it builds its rollout)
does not import torch through this package.
"""
import importlib

_EXPORTS = {
    "CollectStats": "backends", "InlineBackend": "backends",
    "ProcessBackend": "backends", "SamplerBackend": "backends",
    "ShardedBackend": "backends",
    "ThreadedBackend": "backends", "make_backend": "backends",
    "FusedRunner": "fused", "TrainState": "fused",
    "make_fused_train_loop": "fused",
    "AsyncOrchestrator": "orchestrator", "IterationLog": "orchestrator",
    "SyncRunner": "orchestrator",
    "Experience": "queues", "ExperienceQueue": "queues",
    "PolicyStore": "queues",
    "WorkerSpec": "sampler",
}
_MODULES = ("backends", "fused", "orchestrator", "queues", "sampler",
            "timing")

__all__ = sorted((*_EXPORTS, *_MODULES))


def __getattr__(name):
    if name in _MODULES:
        return importlib.import_module(f"{__name__}.{name}")
    if name in _EXPORTS:
        module = importlib.import_module(f"{__name__}.{_EXPORTS[name]}")
        return getattr(module, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
