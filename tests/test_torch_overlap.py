"""The overlap schedule (``Schedule.overlap``, ``--overlap``) on the CPU,
mirroring the reference's overlap tests (``tests/test_fsdp_pipeline.py``).

After two serial iterations, iteration k's learn runs while iteration
k+1's collect does, and that collect acts with the params learn k starts
from. On the CPU the sync runtime issues the learn from its learner thread
and the fused runtime runs both halves eagerly, so every comparison here
is exact: an overlapped run equals a serial loop written out by hand with
the same stale params (the same ops on the same inputs), the fused
pipeline equals the sync one on the same single carry, and the process
and threaded backends equal inline. Against the JAX package: the
``OverlapClock`` accounting on the same calls, exactly, and the schedule
of the logs (``staleness``, where ``overlap_saved_s`` is 0, ``samples``,
the keys); their numbers differ, since torch and JAX draw different
random streams.
"""
import dataclasses
import json
import sys
import threading
from concurrent.futures import Future

import pytest
import torch

from repro import experiment as jax_experiment
from repro.core import orchestrator as jax_orchestrator
from repro_torch import kernels
from repro_torch.core.fused import FusedRunner, state_tensors
from repro_torch.core.orchestrator import OverlapClock, SyncRunner, tree_ready
from repro_torch.core.queues import snapshot
from repro_torch.data import trajectory
from repro_torch.experiment import ExperimentSpec, Schedule, build, run
from repro_torch.launch import train

ITERS = 6
STALENESS = [0.0, 0.0, 0.0, 1.0, 1.0, 1.0]
SAVED_IS_ZERO = [True, True, False, False, False, True]

SPECS = {
    "ppo pendulum": ExperimentSpec(env="pendulum", algo="ppo"),
    "sac cheetah prioritized": ExperimentSpec(
        env="cheetah", algo="sac", buffer="prioritized",
        buffer_kwargs={"capacity": 64, "batch_size": 8, "n_step": 2}),
    "trpo cartpole": ExperimentSpec(env="cartpole", algo="trpo"),
    "ddpg pendulum uniform": ExperimentSpec(
        env="pendulum", algo="ddpg", buffer="uniform",
        buffer_kwargs={"capacity": 40, "batch_size": 8}),
}


def _spec(label, runtime="sync", overlap=True, **sched):
    base = dict(num_samplers=1, global_batch=6, horizon=12,
                iterations=ITERS, overlap=overlap)
    return dataclasses.replace(
        SPECS[label], runtime=runtime, model={"hidden": 16},
        env_kwargs={"max_episode_steps": 5},
        schedule=Schedule(**{**base, **sched}))


def _carried(runner):
    """Params, optimizer state and the plane's buffer state, in order (a
    fifo plane's trajectory by key: the process backend's ring gives its
    leaves in another order)."""
    plane = runner.plane_state[0] if runner.plane_state else None
    if isinstance(plane, dict):
        plane = [plane[k] for k in sorted(plane)]
    return state_tensors((runner.params, runner.opt_state, plane))


def _assert_same_run(a, b):
    ta, tb = _carried(a.runner), _carried(b.runner)
    assert len(ta) == len(tb) > 0
    for x, y in zip(ta, tb):
        assert x.dtype == y.dtype and torch.equal(x, y)
    assert ([lg.mean_return for lg in a.logs]
            == [lg.mean_return for lg in b.logs])


# ================================================================ pieces
def test_overlap_clock_matches_jax():
    """The same ``note_serial`` / ``saved`` calls give the reference's
    numbers exactly, including the cases of
    ``test_overlap_clock_accounting``."""
    calls = [("saved", 0.5, False), ("saved", 0.5, True),
             ("note", 0.3), ("note", 0.2), ("saved", 0.5, True),
             ("saved", 0.1, True), ("saved", 0.7, False), ("note", 0.25),
             ("note", 0.05), ("saved", 0.06, True), ("saved", 0.04, True)]
    ours, theirs = OverlapClock(), jax_orchestrator.OverlapClock()
    for call in calls:
        if call[0] == "note":
            ours.note_serial(call[1])
            theirs.note_serial(call[1])
            assert ours.learn_ref == theirs.learn_ref
        else:
            assert ours.saved(*call[1:]) == theirs.saved(*call[1:])
    assert ours.learn_ref == 0.05


def test_tree_ready_on_host_values_futures_and_device_tensors():
    """Ready, as in the reference, for host values and ``None``; a
    future once it is done; a device tensor cannot tell."""
    for value in (None, 1.0, {"b": 1.0, "c": [2, None]}):
        assert tree_ready(value) and jax_orchestrator.tree_ready(value)
    assert tree_ready({"a": torch.ones(2), "b": 1.0})
    done, pending = Future(), Future()
    done.set_result(1)
    assert tree_ready((done, None)) and not tree_ready([done, pending])
    with pytest.raises(TypeError, match="Event"):
        tree_ready(torch.empty(2, device="meta"))


def test_launch_counts_are_kept_across_threads():
    """More threads than cores add to one wrapper's count with a short
    switch interval: no count is lost."""
    wrapper = kernels.KERNELS["gae"]
    kernels.reset_launch_counts()
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(
            target=lambda: [kernels.counts.add(wrapper) for _ in range(2000)])
            for _ in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(interval)
    assert kernels.launch_counts()["gae"] == 16 * 2000
    kernels.reset_launch_counts()


# ============================================================ the schedule
@pytest.mark.parametrize("runtime", ["sync", "fused"])
def test_overlap_within_warmup_equals_serial(runtime):
    """Runs of at most the two warm-up iterations never pipeline: they
    equal ``overlap=False`` bit for bit."""
    for iters in (1, 2):
        serial = run(_spec("ppo pendulum", runtime, overlap=False,
                           iterations=iters), device="cpu")
        over = run(_spec("ppo pendulum", runtime, iterations=iters),
                   device="cpu")
        _assert_same_run(serial, over)
        assert [lg.staleness for lg in over.logs] == [0.0] * iters
        assert [lg.overlap_saved_s for lg in over.logs] == [0.0] * iters


@pytest.mark.parametrize("label", ["ppo pendulum", "sac cheetah prioritized"])
def test_overlap_equals_the_stale_schedule_by_hand(label):
    """A 6-iteration overlapped run equals a serial loop in which collect
    k+1 acts with a snapshot of the params learn k starts from, bit for
    bit: params, optimizer, plane and every mean return."""
    over = run(_spec(label), device="cpu")
    assert [lg.staleness for lg in over.logs] == STALENESS

    hand = build(_spec(label, overlap=False), device="cpu")
    step, collect = hand._train_step, hand.backend.collect
    params, opt, plane = hand.params, hand.opt_state, hand.plane_state
    merged, _ = collect(params)
    returns = []
    for k in range(ITERS):
        acting = snapshot(params) if k >= 2 else None
        params, opt, plane, _ = step(params, opt, plane, merged)
        returns.append(float(trajectory.episode_returns(merged)))
        if k + 1 < ITERS:
            merged, _ = collect(acting if acting is not None else params)
    hand.params, hand.opt_state, hand.plane_state = params, opt, plane
    hand.close()
    got, want = _carried(over.runner), _carried(hand)
    assert len(got) == len(want) > 0
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert [lg.mean_return for lg in over.logs] == returns
    assert any(r != 0.0 for r in returns)


@pytest.mark.parametrize("label", list(SPECS))
def test_fused_overlap_equals_sync_overlap(label):
    """The fused pipeline (a collect engine and a learn engine, one carry
    of the whole batch) equals the sync runtime's overlap with one sampler
    of that batch, bit for bit, and keeps the collect's params copy apart
    from the params the learn updates."""
    sync = run(_spec(label), device="cpu")
    fused = run(_spec(label, "fused"), device="cpu")
    assert isinstance(fused.runner, FusedRunner) and fused.runner.overlap
    _assert_same_run(sync, fused)
    for runner, copy in ((sync.runner, sync.runner._collect_params),
                         (fused.runner, fused.runner.halves[0].state[0])):
        live = {t.untyped_storage().data_ptr()
                for t in state_tensors(runner.params)}
        assert not live & {t.untyped_storage().data_ptr()
                           for t in state_tensors(copy)}


@pytest.mark.parametrize("runtime", ["sync", "fused"])
def test_overlap_log_accounting(runtime):
    """The reference's formulas: ``overlap_saved_s`` is the next
    collect's seconds (the learn was still running) or the serial learn
    reference (iteration 1's learn) capped by them; fused
    ``collect_time == collect_time_serial``, the collect's own seconds."""
    logs = run(_spec("ppo pendulum", runtime), device="cpu").logs
    ref = logs[1].learn_time
    for k, lg in enumerate(logs):
        assert lg.learn_time >= 0.0 and lg.collect_time > 0.0
        assert lg.collect_time == lg.collect_time_serial
        if k in (2, 3, 4):
            nxt = logs[k + 1].collect_time
            assert lg.overlap_saved_s in (nxt, min(ref, nxt)), (k, lg)
        else:
            assert lg.overlap_saved_s == 0.0
    assert [lg.staleness for lg in logs] == STALENESS


def test_fused_overlap_notes_the_kind_of_learn_it_pipelines():
    """The serial learn whose seconds the clock notes (``note_serial``) is
    the same kind of learn, eager or a replay, as every pipelined
    iteration's. The order of the fused runner's learn calls and notes is
    recorded; no time is read. On the CPU nothing is captured, so every
    learn, the noted one too, is eager (on the card every learn after
    iteration 0 is a replay: ``test_torch_overlap_gpu.py``)."""
    runner = build(_spec("ppo pendulum", "fused"), device="cpu")
    learn, clock = runner.halves[1], runner._overlap_clock
    events = []

    def record(kind, fn):
        def call(*args, **kwargs):
            events.append(kind)
            return fn(*args, **kwargs)
        return call

    learn.eager = record("eager", learn.eager)
    learn.replay = record("replay", learn.replay)
    clock.note_serial = record("note", clock.note_serial)
    runner.run(ITERS)
    runner.close()
    learns = [e for e in events if e != "note"]
    noted = [events[i - 1] for i, e in enumerate(events) if e == "note"]
    assert len(learns) == ITERS and noted
    # one note, right after serial iteration 1's learn
    assert events.index("note") == 2 and len(noted) == 1
    pipelined = set(learns[2:])
    assert set(noted) == pipelined == {"eager"}
    assert learn.graph is None and learn.replays == 0
    # the learn runs before the collect on the CPU: it always ends first
    assert runner.learn_done_first == [None, None] + [True] * (ITERS - 3) + [
        None]


@pytest.mark.parametrize("runtime", ["sync", "fused"])
def test_overlap_schedule_matches_jax(runtime):
    """The same spec through both packages: the same ``staleness`` list,
    ``overlap_saved_s`` 0 on the same iterations (the warm-up ones and the
    last), the same ``samples`` and ``IterationLog`` keys."""
    spec = _spec("ppo pendulum", runtime)
    ours = [lg.as_dict() for lg in run(spec, device="cpu").logs]
    theirs = [lg.as_dict() for lg in jax_experiment.run(
        jax_experiment.ExperimentSpec.from_dict(spec.to_dict())).logs]
    for logs in (ours, theirs):
        assert [lg["staleness"] for lg in logs] == STALENESS
        assert [lg["overlap_saved_s"] == 0.0 for lg in logs] == SAVED_IS_ZERO
        assert all(lg["overlap_saved_s"] >= 0.0 for lg in logs)
    assert [lg["samples"] for lg in ours] == [lg["samples"] for lg in theirs]
    assert [set(lg) for lg in ours] == [set(lg) for lg in theirs]


def test_async_overlap_and_overlap_without_train_step_raise():
    spec = ExperimentSpec(env="pendulum", algo="ppo", backend="threaded",
                          runtime="async", model={"hidden": 16},
                          schedule=Schedule(num_samplers=1, global_batch=4,
                                            horizon=8, overlap=True))
    with pytest.raises(ValueError, match="async"):
        build(spec, device="cpu")
    with pytest.raises(ValueError, match="async"):
        jax_experiment.build(jax_experiment.ExperimentSpec.from_dict(
            spec.to_dict()))
    with pytest.raises(ValueError, match="train_step"):
        SyncRunner(build(_spec("ppo pendulum"), device="cpu").backend, None,
                   None, None, overlap=True)


# ====================================================== backends and CLI
@pytest.mark.parametrize("backend", ["process", "threaded"])
def test_overlap_over_workers_equals_inline(backend):
    """Two worker processes (or threads) under overlap equal the inline
    sweep of two samplers under overlap, bit for bit: the process backend
    publishes the stale params copy to its workers."""
    sched = dict(num_samplers=2, global_batch=8)
    inline = run(_spec("ppo pendulum", **sched), device="cpu")
    other = run(dataclasses.replace(_spec("ppo pendulum", **sched),
                                    backend=backend), device="cpu")
    _assert_same_run(inline, other)
    assert [lg.staleness for lg in other.logs] == STALENESS


@pytest.mark.parametrize("backend", ["inline", "fused"])
def test_train_cli_overlap(capsys, backend):
    result = train.main(["--env", "pendulum", "--algo", "ppo", "--backend",
                         backend, "--overlap", "--num-samplers", "1",
                         "--global-batch", "4", "--horizon", "8",
                         "--iterations", "5", "--hidden", "16",
                         "--device", "cpu"])
    logs = [json.loads(line)
            for line in capsys.readouterr().out.strip().splitlines()]
    assert result.spec.schedule.overlap and result.runner.overlap
    assert [lg["staleness"] for lg in logs] == [0.0, 0.0, 0.0, 1.0, 1.0]
    assert [lg["overlap_saved_s"] == 0.0 for lg in logs] == [
        True, True, False, False, True]
    assert all(lg["samples"] == 32 for lg in logs)
    assert set(logs[0]) == {
        f.name for f in dataclasses.fields(jax_experiment.IterationLog)}
