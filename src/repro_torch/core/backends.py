"""Sampler backends (port of ``repro/core/backends.py``: inline, threaded
and process; the sharded backend is in ROADMAP.md).

A backend owns the sampler carries and produces, per iteration, one merged
trajectory plus per-sampler timing:

* ``InlineBackend``   — the serial N-sampler sweep in one process, each
  rollout timed, so the critical path of a parallel deployment (the max
  over samplers) can be reported from one process.
* ``ThreadedBackend`` — the same rollouts launched from one thread each,
  then joined. The rollout loop holds the GIL between launches, so little
  overlaps; every thread launches on the caller's current stream.
* ``ProcessBackend``  — the paper's deployment: N worker processes, each
  rebuilt from a ``WorkerSpec`` on the run's device, fed through the
  shared-memory transport of ``core/ipc.py``. Trajectories merge in
  worker-index order, so with matched per-worker seeds ``process ==
  inline`` bit for bit.

A collect runs on the caller's current stream and ends with that stream's
barrier (``timing.stream_synchronize``), so under the overlap schedule
(``orchestrator.SyncRunner``) it neither waits for the learn on the
learner's stream nor is counted in its time. The process backend publishes
whatever params it is given: under overlap, the runner's snapshot of the
params the learn is about to update.

Every backend is a context manager; ``close()`` releases what it holds
(threads, worker processes, shared memory) and is idempotent.
"""
from __future__ import annotations

import dataclasses
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch import registry
from repro_torch.core.timing import on_stream, stream_synchronize
from repro_torch.data import trajectory

# the kernel sources a rollout worker launches: the env step (GAE, the
# replay ring and the sum tree run in the learner)
WORKER_SOURCES = ("env_step",)


@dataclasses.dataclass
class CollectStats:
    """Per-iteration collection accounting."""
    per_sampler_seconds: List[float]
    samples: int
    respawns: int = 0        # cumulative supervised worker respawns
    active_workers: int = 0  # live fleet size (process backend only)


class BackendCloseMixin:
    """Context manager + no-op ``close`` shared by backends and runners."""

    def close(self) -> None:
        pass

    def __enter__(self):
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def timed_rollout(rollout: Callable, params: Any, carry: Any):
    """Run one rollout to completion on the current stream: ``(carry',
    traj, dt)``."""
    t0 = time.perf_counter()
    carry, traj = rollout(params, carry)
    stream_synchronize(traj["rewards"].device)
    return carry, traj, time.perf_counter() - t0


def merge_trajs(trajs: Sequence[Any]) -> Any:
    return trajectory.merge(list(trajs)) if len(trajs) > 1 else trajs[0]


def to_device(traj: Dict[str, np.ndarray], device) -> Dict[str, torch.Tensor]:
    """A trajectory read from the ring, as tensors on ``device``. The
    arrays must be the reader's own copies (``ShmRing.read`` makes them):
    on the CPU the tensors alias them."""
    return {k: torch.from_numpy(v).to(device) for k, v in traj.items()}


class InlineBackend(BackendCloseMixin):
    """The serial sweep: N logical samplers run back to back, each timed,
    so the critical path of a parallel deployment (the max over samplers)
    can be reported from one process."""

    def __init__(self, rollout: Callable, carries: List[Any]):
        self.rollout = rollout
        self.carries = carries
        self.num_samplers = len(carries)

    def collect(self, params):
        trajs, times = [], []
        for i in range(self.num_samplers):
            self.carries[i], traj, dt = timed_rollout(
                self.rollout, params, self.carries[i])
            trajs.append(traj)
            times.append(dt)
        merged = merge_trajs(trajs)
        return merged, CollectStats(times, trajectory.num_samples(merged))


class ThreadedBackend(BackendCloseMixin):
    """Fan-out/join over sampler threads (``AsyncOrchestrator``'s sampler
    loop, made synchronous): each sampler runs its rollout in its own
    thread, on the stream current in the thread that called ``collect``.
    Each carry holds its own generator, so the trajectories are the inline
    backend's bit for bit."""

    def __init__(self, rollout: Callable, carries: List[Any]):
        self.rollout = rollout
        self.carries = carries
        self.num_samplers = len(carries)
        self._pool = ThreadPoolExecutor(max_workers=self.num_samplers)

    def _one(self, i: int, params, stream):
        with on_stream(stream):
            self.carries[i], traj, dt = timed_rollout(
                self.rollout, params, self.carries[i])
        return traj, dt

    def collect(self, params):
        device = self.carries[0][1].device
        stream = (torch.cuda.current_stream(device)
                  if device.type == "cuda" else None)
        futures = [self._pool.submit(self._one, i, params, stream)
                   for i in range(self.num_samplers)]
        results = [f.result() for f in futures]
        merged = merge_trajs([r[0] for r in results])
        return merged, CollectStats([r[1] for r in results],
                                    trajectory.num_samples(merged))

    def close(self) -> None:
        self._pool.shutdown(wait=True)


class ProcessBackend(BackendCloseMixin):
    """N rollout worker processes behind the ``collect`` contract.

    Params go out through the versioned shared-memory channel (one publish
    per ``collect``); trajectories come back through the ring, onto
    ``device``, and merge in worker-index order. With a ``supervisor``
    (the default through ``repro_torch.experiment``) a worker that dies
    mid-sweep is respawned and its command issued again; without one a
    worker's death or exception surfaces as ``ipc.WorkerCrashed`` from
    ``collect``. ``close`` reaps everything.
    """

    def __init__(self, pool, device, supervisor=None):
        self.pool = pool
        self.device = torch.device(device)
        self.supervisor = supervisor

    @property
    def num_samplers(self) -> int:
        return self.pool.num_workers

    def collect(self, params):
        self.pool.publish(params)
        source = self.supervisor if self.supervisor is not None else self.pool
        trajs, times, _loops = source.collect()
        merged = merge_trajs([to_device(t, self.device) for t in trajs])
        return merged, CollectStats(
            times, trajectory.num_samples(merged),
            respawns=(self.supervisor.respawns if self.supervisor else 0),
            active_workers=self.pool.num_workers)

    def close(self) -> None:
        # a supervised pool tolerates worker death: a fault landing after
        # the last collect must not resurface from close()
        self.pool.close(raise_on_crash=self.supervisor is None)


def build_worker_pool(*, worker_specs: Sequence[Any], params: Any,
                      slots_per_worker: int = 1,
                      active_workers: Optional[Sequence[int]] = None,
                      fault_plan=None):
    """Spawn a ``ProcessWorkerPool`` for ``worker_specs``.

    The ring is sized from ``worker_specs[0].traj_example()`` (a CPU
    rollout of one step over one env: nothing runs on the card here) and
    the params channel from ``params``. Where the workers launch kernels on
    the card, their sources are built first, once, so N workers do not each
    start ``nvcc`` on a cold cache. The pool is provisioned for all
    ``worker_specs``, but only ``active_workers`` (default: all) start.
    """
    from repro_torch.core import ipc
    from repro_torch.kernels import build, select
    if any(torch.device(s.device).type == "cuda"
           and select.canonical(s.kernels) == "cuda" for s in worker_specs):
        build.build_all(WORKER_SOURCES)
    return ipc.ProcessWorkerPool(worker_specs, params,
                                 worker_specs[0].traj_example(),
                                 slots_per_worker=slots_per_worker,
                                 active_workers=active_workers,
                                 fault_plan=fault_plan)


def _build_inline(*, rollout: Callable, carries: List[Any], **_ignored):
    return InlineBackend(rollout, carries)


def _build_threaded(*, rollout: Callable, carries: List[Any], **_ignored):
    return ThreadedBackend(rollout, carries)


def _build_process(*, worker_specs: Optional[Sequence[Any]] = None,
                   params: Any = None, device=None, fault_plan=None,
                   supervisor_cfg=None, **_ignored):
    if worker_specs is None or params is None or device is None:
        raise ValueError(
            "the process backend is built from WorkerSpecs, the learner's "
            "params (to size the shared-memory channel) and the run's "
            "device; build it through repro_torch.experiment "
            "(backend='process')")
    pool = build_worker_pool(worker_specs=worker_specs, params=params,
                             slots_per_worker=1, fault_plan=fault_plan)
    supervisor = None
    if supervisor_cfg is None or supervisor_cfg.max_respawns > 0:
        from repro_torch.core.supervisor import WorkerSupervisor
        supervisor = WorkerSupervisor(pool, supervisor_cfg)
    return ProcessBackend(pool, device, supervisor=supervisor)


registry.register("backend", "inline", _build_inline)
registry.register("backend", "threaded", _build_threaded)
registry.register("backend", "process", _build_process)
