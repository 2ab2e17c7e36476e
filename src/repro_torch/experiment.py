"""One declarative spec, one entry point (port of ``repro/experiment.py``).

    from repro_torch.experiment import ExperimentSpec, Schedule, run
    result = run(ExperimentSpec(env="cheetah", algo="ppo"))       # on cuda
    result = run(spec, device="cpu")                              # on the CPU

``ExperimentSpec``/``Schedule`` keep the reference's fields and
``to_dict``/``from_dict`` JSON, so a spec written by either package loads in
the other. The device is an argument of ``build``/``run``, not a spec field:
it defaults to ``cuda`` and, with no CUDA device, raises rather than run on
the CPU unasked.

Ported so far: runtimes ``sync``, ``async`` and ``fused``, backends
``inline``, ``threaded`` and ``process``, algos ``ppo``, ``trpo``, ``ddpg`` and
``sac``, buffers ``fifo``, ``uniform`` and ``prioritized`` (with
``buffer_kwargs``), envs ``pendulum``, ``cartpole`` and ``cheetah``, with
``num_samplers × global_batch`` or ``env_batch`` collection; staleness
correction, fault injection and elastic worker fleets; the overlap schedule
(``schedule.overlap``: collect k+1 under learn k) on the sync and fused
runtimes. Anything else is rejected with a message naming ROADMAP.md,
never ignored: overlap over a learner mesh too (the reference's
``offset=1`` mesh and ``pin_params``), with the sharded learner.

The actor plane: ``backend="process"`` (``schedule.num_workers`` workers,
default ``num_samplers``) collects with worker processes, each rebuilt from
a ``WorkerSpec`` on the run's device (the reference pins its workers to the
CPU) and fed through shared memory (``core/ipc.py``), supervised by
default; worker i takes sampler i's seed, so ``process == inline`` bit for
bit. With ``runtime="async"`` the samplers free-run (threads, or the
workers into the shared ring, two slots each) while the learner drains
them.

The fused runtime (``core/fused.py``) collects with one carry of
``global_batch`` envs (or ``env_batch``) seeded ``seed``, as the reference
does, and runs each collect -> learn iteration as one CUDA-graph replay on
the card (eagerly on the CPU), ``schedule.chunk`` iterations between host
syncs; its backend must be ``inline``.

The runner owns the plane state ``(buffer_state, generator)``. The
generator lives on the device and is seeded from ``schedule.seed`` with its
own tag (``_PLANE_SEED_TAG``), apart from the params generator (``seed``)
and the samplers' (``seed + i``). It cannot reproduce the reference's
``fold_in(PRNGKey(seed), 0xB0FF)`` stream: torch and JAX draw different
numbers from the same seed.

Matmuls run in full float32: ``build`` sets
``torch.backends.cuda.matmul.allow_tf32`` and
``torch.backends.cudnn.allow_tf32`` to False (process-wide), as the
reference's float32 math assumes.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional

import torch

from repro_torch import kernels as kernels_mod
from repro_torch import registry
from repro_torch.algos.api import make_train_step
from repro_torch.core import sampler as sampler_mod
from repro_torch.algos.staleness import StalenessConfig
from repro_torch.core.fused import FusedRunner
from repro_torch.core.orchestrator import (
    AsyncOrchestrator,
    IterationLog,
    SyncRunner,
)
from repro_torch.envs.vector import VectorEnv

RUNTIMES = ("sync", "async", "fused")

# added to the seed of the plane's generator, so that it never equals the
# params generator's seed or a sampler's (seed + i)
_PLANE_SEED_TAG = 0xB0FF << 32


@dataclasses.dataclass(frozen=True)
class Schedule:
    """How much work, split how (the reference's fields, unchanged)."""
    num_samplers: int = 4
    global_batch: int = 16
    horizon: int = 128
    iterations: int = 10
    seed: int = 0
    chunk: Optional[int] = None
    min_batches_per_update: int = 1
    num_workers: Optional[int] = None
    env_batch: Optional[int] = None
    learner_devices: Optional[int] = None
    learner_microbatches: int = 1
    fsdp: bool = False
    overlap: bool = False
    learner_pods: int = 1
    max_respawns: int = 3
    min_workers: Optional[int] = None
    max_workers: Optional[int] = None


@dataclasses.dataclass(frozen=True)
class ExperimentSpec:
    """One experiment: registry names + plain data (the reference's
    fields, unchanged)."""
    env: str = "pendulum"
    algo: str = "ppo"
    backend: str = "inline"
    runtime: str = "sync"
    buffer: Optional[str] = None
    kernels: str = "auto"
    model: Dict[str, Any] = dataclasses.field(default_factory=dict)
    schedule: Schedule = dataclasses.field(default_factory=Schedule)
    env_kwargs: Dict[str, Any] = dataclasses.field(default_factory=dict)
    algo_kwargs: Dict[str, Any] = dataclasses.field(default_factory=dict)
    buffer_kwargs: Dict[str, Any] = dataclasses.field(default_factory=dict)
    staleness: Optional[Any] = None
    faults: Optional[str] = None

    def __post_init__(self):
        # a StalenessConfig is kept as its dict, so that to_dict/from_dict
        # round-trip through plain data
        if dataclasses.is_dataclass(self.staleness) and not isinstance(
                self.staleness, type):
            object.__setattr__(self, "staleness", self.staleness.to_dict())

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "ExperimentSpec":
        d = dict(d)
        sched = d.get("schedule", {})
        if not isinstance(sched, Schedule):
            d["schedule"] = Schedule(**sched)
        return cls(**d)


@dataclasses.dataclass
class ExperimentResult:
    spec: ExperimentSpec
    logs: List[IterationLog]
    runner: Any

    @property
    def params(self):
        return self.runner.params


def resolve_device(device=None) -> torch.device:
    """``None`` means the CUDA device, which must exist; pass ``"cpu"`` to
    run on the CPU."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; repro_torch runs on the GPU "
                "by default — pass device='cpu' (--device cpu) to run on "
                "the CPU")
        device = "cuda"
    return torch.device(device)


def _not_ported(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported to repro_torch yet; see ROADMAP.md for the "
        f"porting order (the JAX package repro runs it)")


def _validate(spec: ExperimentSpec) -> None:
    """Reject every choice this port cannot run yet, by name
    (``NotImplementedError``), and every combination the reference rejects
    (``ValueError``, the reference's checks)."""
    if spec.runtime not in RUNTIMES:
        raise _not_ported(f"runtime {spec.runtime!r}")
    for kind, name in (("env", spec.env), ("algo", spec.algo),
                       ("backend", spec.backend)):
        if not registry.contains(kind, name):
            raise _not_ported(f"{kind} {name!r} (ported: "
                              f"{', '.join(registry.choices(kind))})")
    if spec.buffer is not None and not registry.contains("buffer",
                                                         spec.buffer):
        raise _not_ported(f"buffer {spec.buffer!r}")
    sched = spec.schedule
    if spec.runtime == "fused" and spec.backend != "inline":
        raise ValueError(
            f"runtime 'fused' fuses collection into the train loop; "
            f"backend must be 'inline' (got {spec.backend!r})")
    if spec.runtime == "async" and spec.backend not in ("threaded",
                                                        "process"):
        raise ValueError(
            f"runtime 'async' runs free-running samplers: threads "
            f"(backend='threaded') or worker processes collecting into "
            f"the shared-memory ring (backend='process'); got "
            f"{spec.backend!r}")
    if (StalenessConfig.parse(spec.staleness).enabled
            and spec.runtime != "async"):
        raise ValueError(
            f"staleness correction reweights samples by the params-version "
            f"gap the async runtime stamps onto experience; under "
            f"runtime={spec.runtime!r} that gap is identically zero: use "
            f"runtime='async' or staleness='off'")
    if spec.faults and spec.backend != "process":
        raise ValueError(
            f"fault injection kills and hangs worker processes; backend "
            f"must be 'process' (got {spec.backend!r})")
    if ((sched.min_workers is not None or sched.max_workers is not None)
            and not (spec.runtime == "async"
                     and spec.backend == "process")):
        raise ValueError(
            "elastic sizing (schedule.min_workers/max_workers) grows and "
            "shrinks a free-running worker-process fleet; it requires "
            "runtime='async' with backend='process'")
    if sched.env_batch is not None and spec.backend == "process":
        raise ValueError(
            "schedule.env_batch selects vector collection (one VectorEnv "
            "batch, a single carry); the process backend splits the batch "
            "across workers: use num_samplers × global_batch for it")
    if sched.overlap and spec.runtime == "async":
        raise ValueError(
            "schedule.overlap pipelines the sync/fused loop; the async "
            "runtime's free-running samplers already overlap collect "
            "with learn by construction — drop overlap or use "
            "runtime='sync'")
    if int(sched.learner_devices or 1) > 1 or sched.learner_microbatches > 1:
        raise _not_ported(
            "the sharded learner (learner_devices / learner_microbatches)"
            + (", and the overlap schedule over a learner mesh"
               if sched.overlap else ""))
    if sched.fsdp or sched.learner_pods > 1:
        raise _not_ported("fsdp / learner_pods")


def _resolve_buffer(spec: ExperimentSpec, algo):
    """Buffer name -> instance, checked against the algo's batch diet
    (``ValueError`` on a mismatch, as in the reference). A replay
    buffer's n-step discount comes from the algorithm's gamma."""
    name = spec.buffer or algo.default_buffer
    kwargs = dict(spec.buffer_kwargs)
    buffer = registry.make("buffer", name, **kwargs)
    if algo.on_policy and buffer.kind != "trajectory":
        raise ValueError(
            f"algo {spec.algo!r} is on-policy and learns from whole "
            f"trajectories; buffer {name!r} serves flat transition "
            f"minibatches — use buffer='fifo'")
    if not algo.on_policy and buffer.kind != "transitions":
        raise ValueError(
            f"algo {spec.algo!r} is off-policy and learns from replay "
            f"minibatches; buffer {name!r} passes trajectories through — "
            f"use buffer='uniform' or 'prioritized'")
    algo_gamma = getattr(getattr(algo, "cfg", None), "gamma", None)
    if buffer.kind == "transitions" and algo_gamma is not None:
        if "gamma" in kwargs:
            raise ValueError(
                "set the discount through algo_kwargs={'gamma': ...} — "
                "the buffer derives its n-step discount from the "
                "algorithm's gamma, so buffer_kwargs['gamma'] would "
                "silently diverge from it")
        buffer.gamma = float(algo_gamma)
    return buffer


def build(spec: ExperimentSpec, device=None):
    """Resolve a spec into a runner on ``device`` (without driving it): a
    ``SyncRunner``, an ``AsyncOrchestrator`` under ``runtime="async"``, or
    a ``FusedRunner`` under ``runtime="fused"``.

    Params are drawn from a CPU generator seeded ``seed`` (so a seed gives
    the same weights on every device); sampler i's carry from a generator
    on ``device`` seeded ``seed + i`` (in worker i's process for the process
    backend), or one carry seeded ``seed`` for ``env_batch`` collection and
    for the fused runtime, as the reference derives its keys; the plane's
    generator on ``device`` seeded ``seed + _PLANE_SEED_TAG``.
    """
    _validate(spec)
    device = resolve_device(device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    sched = spec.schedule
    env = registry.make("env", spec.env, **dict(spec.env_kwargs))
    vector = sched.env_batch is not None
    if vector:
        env = VectorEnv(env, sched.env_batch)
    algo_kwargs = {**dict(spec.model), **dict(spec.algo_kwargs)}
    algo = registry.make("algo", spec.algo, **algo_kwargs)
    # before the buffer and the train step: the transition schema and the
    # learner both follow algo.staleness
    stale_cfg = StalenessConfig.parse(spec.staleness)
    algo.enable_staleness(stale_cfg)
    buffer = _resolve_buffer(spec, algo)
    kernels_mod.set_kernel_mode(spec.kernels)
    params, opt_state = algo.init(
        torch.Generator().manual_seed(sched.seed), env, device)
    train_step = make_train_step(algo, buffer)
    example = (algo.transition_example(env, device)
               if buffer.kind == "transitions" else None)
    plane_generator = torch.Generator(device=device)
    plane_generator.manual_seed(sched.seed + _PLANE_SEED_TAG)
    plane_state = (buffer.init(example), plane_generator)
    async_kwargs = dict(staleness=stale_cfg,
                        min_batches_per_update=sched.min_batches_per_update)
    if spec.runtime == "fused":
        # one carry of the whole batch, seeded ``seed``, as the reference's
        # fused runner collects
        carry = sampler_mod.init_env_carry(
            env, sched.seed, env.batch if vector else sched.global_batch,
            device)
        return FusedRunner(env, None, params, opt_state, carry,
                           horizon=sched.horizon, chunk=sched.chunk,
                           rollout=algo.make_rollout(env, sched.horizon),
                           train_step=train_step, plane_state=plane_state,
                           overlap=sched.overlap)
    if vector:
        seeds, per = [sched.seed], env.batch
    else:
        # process backend: the worker count may be set apart
        # (schedule.num_workers); worker i takes sampler i's seed
        n = sched.num_samplers
        if spec.backend == "process":
            n = sched.num_workers or sched.num_samplers
        per = sampler_mod.split_batch(sched.global_batch, n)
        seeds = [sched.seed + i for i in range(n)]
    if spec.backend == "process":
        return _build_process(spec, device, seeds, per, algo_kwargs,
                              train_step, params, opt_state, plane_state,
                              async_kwargs)
    rollout = algo.make_rollout(env, sched.horizon)
    carries = [sampler_mod.init_env_carry(env, s, per, device)
               for s in seeds]
    if spec.runtime == "async":
        return AsyncOrchestrator(train_step, params, opt_state, plane_state,
                                 rollout=rollout, carries=carries,
                                 **async_kwargs)
    backend = registry.make("backend", spec.backend, rollout=rollout,
                            carries=carries)
    return SyncRunner(backend, train_step, params, opt_state,
                      plane_state=plane_state, overlap=sched.overlap)


def _build_process(spec: ExperimentSpec, device, seeds, per: int,
                   algo_kwargs, train_step, params, opt_state, plane_state,
                   async_kwargs):
    """The process backend's runner: one ``WorkerSpec`` per worker up to
    ``max_workers`` (the elastic headroom: slots and specs are provisioned
    up front, only ``len(seeds)`` workers start), supervised unless
    ``max_respawns`` is 0. Lock-step under ``sync``; under ``async`` the
    workers free-run into two ring slots each (one being drained, one
    being filled)."""
    from repro_torch.core.backends import build_worker_pool
    from repro_torch.core.faults import FaultPlan
    from repro_torch.core.supervisor import SupervisorConfig, WorkerSupervisor
    sched = spec.schedule
    n = len(seeds)
    min_w = sched.min_workers if sched.min_workers is not None else 1
    max_w = sched.max_workers if sched.max_workers is not None else n
    if not 1 <= min_w <= n <= max_w:
        raise ValueError(
            f"elastic bounds must satisfy 1 <= min_workers({min_w}) "
            f"<= num_workers({n}) <= max_workers({max_w})")
    sup_cfg = SupervisorConfig(max_respawns=sched.max_respawns,
                               min_workers=sched.min_workers,
                               max_workers=sched.max_workers)
    worker_specs = [
        sampler_mod.WorkerSpec(
            env=spec.env, algo=spec.algo, horizon=sched.horizon, batch=per,
            seed=sched.seed + i, kernels=spec.kernels,
            env_kwargs=dict(spec.env_kwargs), algo_kwargs=algo_kwargs,
            device=str(device))
        for i in range(max_w)]
    fault_plan = FaultPlan.parse(spec.faults, seed=sched.seed)
    if spec.runtime == "async":
        pool = build_worker_pool(worker_specs=worker_specs, params=params,
                                 slots_per_worker=2,
                                 active_workers=list(range(n)),
                                 fault_plan=fault_plan)
        supervisor = (WorkerSupervisor(pool, sup_cfg)
                      if sup_cfg.max_respawns > 0 or sup_cfg.elastic
                      else None)
        return AsyncOrchestrator(train_step, params, opt_state, plane_state,
                                 pool=pool, device=device,
                                 supervisor=supervisor, **async_kwargs)
    backend = registry.make("backend", "process", worker_specs=worker_specs,
                            params=params, device=device,
                            fault_plan=fault_plan, supervisor_cfg=sup_cfg)
    return SyncRunner(backend, train_step, params, opt_state,
                      plane_state=plane_state, overlap=sched.overlap)


def run(spec: ExperimentSpec, iterations: Optional[int] = None,
        device=None) -> ExperimentResult:
    """Build the spec's runner on ``device`` and drive it; the runner is
    closed in a ``finally`` (sampler threads, worker processes and shared
    memory are released even when the run raises)."""
    runner = build(spec, device=device)
    try:
        logs = runner.run(iterations if iterations is not None
                          else spec.schedule.iterations)
    finally:
        runner.close()
    return ExperimentResult(spec=spec, logs=logs, runner=runner)
