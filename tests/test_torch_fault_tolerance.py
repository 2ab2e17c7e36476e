"""Fault tolerance of the port's actor plane, as
``tests/test_fault_tolerance.py`` holds the reference's: the fault plan
(``parse`` and ``decide`` equal to ``repro.core.faults`` over a grid),
supervised respawn after a kill, the crash-loop budget, a torn write
reclaimed, an async run under chaos, the windowed per-iteration
accounting, the autoscale band and elastic growth within bounds, and the
spec checks.

Worker faults come from seeded ``FaultPlan`` schedules, checked against
``decide`` before the run; the asserts are on counts (at least one
respawn, every iteration completes), never on wall time."""
import dataclasses
import itertools

import numpy as np
import pytest
import torch

from repro import experiment as jax_experiment
from repro.core import faults as jax_faults
from repro_torch import experiment
from repro_torch.core.faults import KINDS, FaultPlan, decide
from repro_torch.core.ipc import WorkerCrashed
from repro_torch.core.queues import Experience
from repro_torch.core.supervisor import SupervisorConfig, WorkerSupervisor
from repro_torch.experiment import ExperimentSpec, Schedule

TINY = dict(num_samplers=2, global_batch=4, horizon=8, iterations=2, seed=0)


def _spec(backend, runtime="sync", staleness=None, faults=None, **sched):
    return ExperimentSpec(env="pendulum", algo="ppo", backend=backend,
                          runtime=runtime, model={"hidden": 16},
                          staleness=staleness, faults=faults,
                          schedule=Schedule(**{**TINY, **sched}))


def _first(plan, kind, worker):
    return min(s for s in range(16) if decide(plan, worker, 1, s) == kind)


# ================================================================ the plan
@pytest.mark.parametrize("text", [
    "kill:0.2,torn:0.05,delay:0.1:80,seed:7", "kill:0.3", "torn:0.3",
    "hang:0.1,delay:0.5", " kill:0.1 , ,seed:3"])
def test_fault_plan_parse_and_decide_match_jax(text):
    plan = FaultPlan.parse(text, seed=5)
    jplan = jax_faults.FaultPlan.parse(text, seed=5)
    assert plan.to_dict() == jplan.to_dict() and plan.any
    assert FaultPlan.from_dict(plan.to_dict()) == plan
    grid = itertools.product(range(3), range(1, 4), range(40))
    assert [decide(plan, w, inc, s) for w, inc, s in grid] == [
        jax_faults.decide(jplan, w, inc, s)
        for w, inc, s in itertools.product(range(3), range(1, 4), range(40))]


def test_fault_plan_errors_and_off_match_jax():
    for mod in (jax_faults, None):
        cls = FaultPlan if mod is None else mod.FaultPlan
        with pytest.raises(ValueError, match="unknown fault kind"):
            cls.parse("explode:0.5")
        with pytest.raises(ValueError, match="probabilit"):
            cls(kill=1.5)
        with pytest.raises(ValueError, match=">= 0"):
            cls(torn=-0.1)
    assert FaultPlan.parse(None) is None and FaultPlan.parse("") is None
    assert not FaultPlan().any and KINDS == jax_faults.KINDS
    assert all(decide(FaultPlan(), 0, 1, s) is None for s in range(64))
    plan = FaultPlan.parse("kill:0.3")
    draws = [decide(plan, 0, 1, s) for s in range(64)]
    assert "kill" in draws
    assert draws != [decide(plan, 0, 2, s) for s in range(64)]


# ==================================================== supervised lock-step
def test_supervised_collect_respawns_after_kill():
    """SIGKILL a worker between sweeps: the next sweep completes, the
    worker runs again under a fresh incarnation, and no trajectory is lost
    or consumed twice."""
    runner = experiment.build(_spec("process", max_respawns=3),
                              device="cpu")
    try:
        sup = runner.backend.supervisor
        assert sup is not None                       # supervision is on
        pool = runner.backend.pool
        _, s0 = runner.backend.collect(runner.params)
        pool._procs[0].kill()
        pool._procs[0].join(timeout=30)
        merged, s1 = runner.backend.collect(runner.params)
        assert sup.respawns == 1 and pool._incarnation[0] == 2
        assert s1.respawns == 1 and s1.active_workers == 2
        assert s1.samples == s0.samples == merged["rewards"].numel()
        assert len(sup.recovery_s) == 1 and sup.recovery_s[0] > 0
        assert [e.kind for e in sup.events] == ["respawn"]
        runner.backend.collect(runner.params)
        assert sup._consec[0] == 0                   # success resets it
        # the reports of both of worker 0's incarnations are kept
        assert sorted(pool.worker_launches) == [(0, 1), (0, 2), (1, 1)]
    finally:
        runner.close()


def test_crash_loop_budget_exhausts_with_pointed_error():
    """Budget 1: the first failure respawns, a second in a row raises
    ``WorkerCrashed`` naming the worker; ``close`` does not raise it
    again."""
    runner = experiment.build(_spec("process", max_respawns=1),
                              device="cpu")
    sup = runner.backend.supervisor
    try:
        with pytest.raises(WorkerCrashed, match="#1 is crash-looping"):
            for _ in range(3):
                sup._respawn(1, "test-injected failure")
        assert sup.respawns == 1
        assert 1 in runner.backend.pool._crash_surfaced
    finally:
        runner.close()


def test_torn_fault_reclaimed_in_lockstep():
    """A worker that dies mid-write (seqlock left odd) is detected, its
    slot repaired and its sweep issued again: the consumer never hangs
    and never reads the torn payload."""
    plan = FaultPlan.parse("torn:0.3", seed=0)
    assert min(_first(plan, "torn", w) for w in (0, 1)) < 4
    res = experiment.run(_spec("process", faults="torn:0.3", iterations=4,
                               max_respawns=8), device="cpu")
    sup = res.runner.backend.supervisor
    assert len(res.logs) == 4 and res.logs[-1].respawns >= 1
    assert sup.slots_reclaimed >= 1
    assert all(lg.samples == TINY["global_batch"] * TINY["horizon"]
               and np.isfinite(lg.mean_return) for lg in res.logs)
    for p in res.params.parameters():
        assert torch.isfinite(p).all()
    # every incarnation reported, a torn one before its death
    pool = res.runner.backend.pool
    assert set(pool.worker_launches) == {
        (w, i) for w in (0, 1) for i in range(1, pool._incarnation[w] + 1)}


# =========================================================== async free-run
def test_async_chaos_completes_with_respawns():
    """Free-running workers SIGKILLed on a seeded schedule: the learner
    keeps draining, the supervisor respawns, every update completes."""
    plan = FaultPlan.parse("kill:0.3", seed=0)
    assert min(_first(plan, "kill", w) for w in (0, 1)) <= 2
    res = experiment.run(_spec("process", runtime="async", faults="kill:0.3",
                               iterations=5, max_respawns=12),
                         device="cpu")
    logs = res.logs
    assert len(logs) == 5 and logs[-1].respawns >= 1
    assert all(lg.samples > 0 and lg.staleness >= 0.0 for lg in logs)
    procs = res.runner.pool._procs
    assert all(p is None or not p.is_alive() for p in procs)


class _StubPool:
    """Stands in for ``ProcessWorkerPool``: hands the orchestrator a fixed
    script of (policy_version, collect_s, loop_s) experiences, so the
    per-iteration accounting is checked against exact numbers."""

    def __init__(self, script, version=10):
        self.version = version
        self.num_workers = 2
        self._exps = [
            (Experience(traj={"obs": np.zeros((4, 2, 3), np.float32),
                              "rewards": np.zeros((4, 2), np.float32),
                              "dones": np.zeros((4, 2), bool)},
                        policy_version=v, sampler_id=0, collect_seconds=c),
             loop)
            for v, c, loop in script]
        self._i = 0

    def start_freerun(self):
        pass

    def publish(self, params):
        self.version += 1

    def next_experience(self, timeout=1.0):
        if self._i >= len(self._exps):
            return None
        exp = self._exps[self._i]
        self._i += 1
        return exp

    def close(self, raise_on_crash=True):
        pass


def test_pool_accounting_is_windowed_per_iteration():
    """``staleness`` and ``worker_utilization`` are this iteration's
    window: a gap-5 batch after a gap-0 batch logs 5.0, not 2.5."""
    from repro_torch.core.orchestrator import AsyncOrchestrator

    # iteration 1: gap 10-10=0, util 0.5/1.0; publish -> version 11
    # iteration 2: gap 11-6=5, util 0.25/1.0
    pool = _StubPool([(10, 0.5, 1.0), (6, 0.25, 1.0)], version=10)

    def train_step(p, o, s, batch):
        assert batch["rewards"].device.type == "cpu"
        return p, o, s, {"loss": torch.mean(batch["rewards"])}

    orch = AsyncOrchestrator(train_step, {"w": torch.zeros(2)}, None, (),
                             pool=pool, device="cpu")
    logs = orch.run(2, timeout=30.0)
    assert len(logs) == 2
    assert logs[0].staleness == 0.0 and logs[1].staleness == 5.0
    assert logs[0].worker_utilization == pytest.approx(0.5)
    assert logs[1].worker_utilization == pytest.approx(0.25)
    assert all(lg.active_workers == 2 and lg.respawns == 0 for lg in logs)
    assert orch.store.version == 2


# ================================================================ elastic
class _ElasticStubPool:
    def __init__(self, active=2, max_workers=4):
        self.active = list(range(active))
        self.max_workers = max_workers

    def grow(self):
        wid = len(self.active)
        self.active.append(wid)
        return wid

    def shrink(self):
        return self.active.pop() if len(self.active) > 1 else None


def test_autoscale_band_cooldown_and_clamps():
    pool = _ElasticStubPool(active=2, max_workers=4)
    sup = WorkerSupervisor(pool, SupervisorConfig(
        min_workers=2, max_workers=3, resize_cooldown=1))
    assert sup.autoscale(0.95) == ("grow", 2)        # above band: grow
    assert sup.autoscale(0.95) is None               # cooldown
    assert sup.autoscale(0.95) is None               # ceiling (3)
    assert len(pool.active) == 3
    assert sup.autoscale(0.7) is None                # inside the band
    assert sup.autoscale(0.1) == ("shrink", 2)
    assert sup.autoscale(0.1) is None                # cooldown again
    assert sup.autoscale(0.1) is None                # floor (2)
    assert len(pool.active) == 2
    assert [e.kind for e in sup.events] == ["grow", "shrink"]
    off = WorkerSupervisor(_ElasticStubPool(), SupervisorConfig())
    assert off.autoscale(0.99) is None and off.autoscale(0.0) is None


def test_async_elastic_pool_grows_within_bounds():
    """An async run provisioned to max_workers=3 starts at 2 and stays
    within [1, 3] while autoscaling between updates."""
    res = experiment.run(_spec("process", runtime="async", iterations=4,
                               min_workers=1, max_workers=3), device="cpu")
    actives = [lg.active_workers for lg in res.logs]
    assert len(actives) == 4 and actives[0] == 2
    assert all(1 <= a <= 3 for a in actives)
    assert res.runner.pool.max_workers == 3          # provisioned up front


# ============================================================ spec checks
@pytest.mark.parametrize("kwargs,match", [
    (dict(backend="inline", staleness="decay"), "async"),
    (dict(backend="threaded", staleness="vtrace"), "async"),
    (dict(backend="inline", runtime="async"), "async"),
    (dict(backend="inline", faults="kill:0.2"), "process"),
    (dict(backend="threaded", runtime="async", faults="kill:0.2"),
     "process"),
    (dict(backend="inline", max_workers=4), "elastic"),
    (dict(backend="process", min_workers=1), "elastic"),
    (dict(backend="process", runtime="async", min_workers=3,
          max_workers=4), "min_workers"),
    (dict(backend="process", runtime="async", max_workers=1),
     "max_workers"),
])
def test_spec_validation_errors_match_jax(kwargs, match):
    """The port rejects what the reference rejects, with a message of the
    same meaning, before any worker starts."""
    spec = _spec(**kwargs)
    with pytest.raises(ValueError, match=match):
        experiment.build(spec, device="cpu")
    with pytest.raises(ValueError, match=match):
        jax_experiment.build(jax_experiment.ExperimentSpec.from_dict(
            spec.to_dict()))


def test_trpo_rejects_staleness_like_jax():
    spec = dataclasses.replace(_spec("threaded", runtime="async",
                                     staleness="decay"), algo="trpo")
    with pytest.raises(ValueError, match="trpo"):
        experiment.build(spec, device="cpu")
    with pytest.raises(ValueError, match="trpo"):
        jax_experiment.build(jax_experiment.ExperimentSpec.from_dict(
            spec.to_dict()))
