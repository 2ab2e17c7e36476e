"""The overlap schedule on the card: two CUDA streams, and on the fused
runtime a collect graph and a learn graph.

Every test here needs a CUDA device and skips without one. The file
imports neither ``jax`` nor ``repro``, so it runs where only PyTorch is
installed:

    PYTHONPATH=src python -m pytest --noconftest -m gpu \
        tests/test_torch_overlap_gpu.py

Bounds: all exact. The pipelined halves run the same ops on the same
inputs whichever stream runs them and whether they are replayed from a
graph or not, so the fused pipeline equals the sync runtime's on the same
single carry bit for bit, and the kernels equal their plain versions.
"""
import dataclasses

import pytest
import torch

from repro_torch import kernels
from repro_torch.core.fused import state_generators, state_tensors
from repro_torch.core.queues import snapshot
from repro_torch.data import trajectory
from repro_torch.experiment import ExperimentSpec, Schedule, build, run

ITERS = 6

SPECS = {
    "ppo cheetah": ExperimentSpec(env="cheetah", algo="ppo"),
    "sac cheetah prioritized": ExperimentSpec(
        env="cheetah", algo="sac", buffer="prioritized",
        buffer_kwargs={"capacity": 4096, "batch_size": 64}),
}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _spec(label, runtime, overlap=True, iterations=ITERS, **change):
    change = {"env_kwargs": {"max_episode_steps": 25}, **change}
    return dataclasses.replace(
        SPECS[label], runtime=runtime,
        schedule=Schedule(num_samplers=1, global_batch=32, horizon=40,
                          iterations=iterations, overlap=overlap), **change)


def _carried(runner):
    plane = runner.plane_state[0] if runner.plane_state else None
    if isinstance(plane, dict):
        plane = [plane[k] for k in sorted(plane)]
    return [t.detach().clone() for t in state_tensors(
        (runner.params, runner.opt_state, plane))]


def _same(a, b):
    ta, tb = _carried(a.runner), _carried(b.runner)
    assert len(ta) == len(tb) > 0
    assert all(x.dtype == y.dtype and torch.equal(x, y)
               for x, y in zip(ta, tb))
    assert ([lg.mean_return for lg in a.logs]
            == [lg.mean_return for lg in b.logs])
    assert any(lg.mean_return != 0.0 for lg in a.logs)


@pytest.mark.gpu
@pytest.mark.parametrize("label", list(SPECS))
def test_fused_overlap_equals_sync_overlap_on_the_card(cuda, label):
    """Two graphs on two streams against the eager learn of the learner
    thread and the eager collect, on the same carry: bit for bit, with
    the reference's staleness stamps."""
    sync = run(_spec(label, "sync"))
    fused = run(_spec(label, "fused"))
    _same(sync, fused)
    for result in (sync, fused):
        assert [lg.staleness for lg in result.logs] == [0, 0, 0, 1, 1, 1]


@pytest.mark.gpu
@pytest.mark.parametrize("label", list(SPECS))
def test_overlap_equals_the_stale_schedule_by_hand_on_the_card(cuda, label):
    """The sync runtime's overlap (two streams, a learner thread) equals
    a serial loop on the default stream in which collect k+1 acts with a
    snapshot of the params learn k starts from, bit for bit."""
    over = run(_spec(label, "sync"))
    hand = build(_spec(label, "sync", overlap=False))
    step, collect = hand._train_step, hand.backend.collect
    params, opt, plane = hand.params, hand.opt_state, hand.plane_state
    merged, _ = collect(params)
    returns = []
    for k in range(ITERS):
        acting = snapshot(params) if k >= 2 else params
        params, opt, plane, _ = step(params, opt, plane, merged)
        returns.append(float(trajectory.episode_returns(merged)))
        if k + 1 < ITERS:
            merged, _ = collect(acting)
    hand.params, hand.opt_state, hand.plane_state = params, opt, plane
    hand.close()
    got, want = _carried(over.runner), _carried(hand)
    assert len(got) == len(want) > 0
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert [lg.mean_return for lg in over.logs] == returns


@pytest.mark.gpu
@pytest.mark.parametrize("runtime", ["sync", "fused"])
def test_overlap_within_warmup_equals_serial_on_the_card(cuda, runtime):
    """Runs of at most the two warm-up iterations equal ``overlap=False``
    bit for bit."""
    short = {"max_episode_steps": 15}
    for iters in (1, 2):
        _same(run(_spec("ppo cheetah", runtime, overlap=False,
                        iterations=iters, env_kwargs=short)),
              run(_spec("ppo cheetah", runtime, iterations=iters,
                        env_kwargs=short)))


@pytest.mark.gpu
@pytest.mark.parametrize("label", list(SPECS))
def test_fused_overlap_kernels_equal_plain_versions(cuda, label):
    kernels.reset_launch_counts()
    got = run(_spec(label, "fused"))
    counts = kernels.launch_counts()
    assert sum(counts.values()) > 0
    kernels.reset_launch_counts()
    want = run(_spec(label, "fused", kernels="ref"))
    assert sum(kernels.launch_counts().values()) == 0
    _same(got, want)


@pytest.mark.gpu
def test_overlap_graphs_pools_generators_and_launches(cuda):
    """Each half's graph has a memory pool of its own and registers its
    own generators (the env carry's with the collect, the plane's with
    the learn); a run's launches are its iterations times both graphs'
    launches per replay (an eager half calls what its replay launches)."""
    kernels.reset_launch_counts()
    result = run(_spec("sac cheetah prioritized", "fused"))
    counts = kernels.launch_counts()
    collect, learn = result.runner.halves
    assert collect.graph is not None and learn.graph is not None
    assert collect.graph.pool() != learn.graph.pool()
    c_gens = {id(g) for g in state_generators(collect.state)}
    l_gens = {id(g) for g in state_generators(learn.state)}
    assert c_gens and l_gens and not c_gens & l_gens
    per = {}
    for engine in (collect, learn):
        for k, v in engine.graph_stats["launches_per_replay"].items():
            per[k] = per.get(k, 0) + v
    assert per["cheetah_step"] == 40 and per["sumtree_update"] == 5
    assert counts == {k: ITERS * per.get(k, 0) for k in counts}


@pytest.mark.gpu
@pytest.mark.parametrize("label", list(SPECS))
def test_fused_overlap_notes_a_replayed_learn(cuda, label):
    """The serial learn the clock notes is a replay of the learn graph, as
    every pipelined learn is: the learn is captured after its one eager
    iteration (iteration 0), so when ``note_serial`` is called the learn
    has replayed once, and the learn's kernels have counted the eager
    iteration and that replay. The schedule is the reference's."""
    runner = build(_spec(label, "fused"))
    learn, collect = runner.halves[1], runner.halves[0]
    clock = runner._overlap_clock
    seen = []
    note = clock.note_serial

    def record(seconds):
        seen.append((learn.eager_iterations, learn.replays,
                     kernels.launch_counts()))
        note(seconds)

    clock.note_serial = record
    kernels.reset_launch_counts()
    logs = runner.run(ITERS)
    runner.close()
    assert len(seen) == 1
    eager, replays, counts = seen[0]
    assert (eager, replays) == (1, 1)
    assert learn.eager_iterations == 1 and learn.replays == ITERS - 1
    per = learn.graph_stats["launches_per_replay"]
    mine = set(per) - set(collect.graph_stats["launches_per_replay"])
    assert mine
    for k in mine:
        assert counts[k] == (eager + replays) * per[k], (k, counts, per)
    assert [lg.staleness for lg in logs] == [0, 0, 0, 1, 1, 1]
    assert [lg.overlap_saved_s == 0.0 for lg in logs] == [
        True, True, False, False, False, True]


@pytest.mark.gpu
@pytest.mark.parametrize("runtime", ["sync", "fused"])
def test_collect_params_never_share_storage_with_the_learners(cuda,
                                                              runtime):
    result = run(_spec("ppo cheetah", runtime))
    runner = result.runner
    copy = (runner._collect_params if runtime == "sync"
            else runner.halves[0].state[0])
    live = {t.untyped_storage().data_ptr()
            for t in state_tensors(runner.params)}
    mine = {t.untyped_storage().data_ptr() for t in state_tensors(copy)}
    assert live and mine and not live & mine
