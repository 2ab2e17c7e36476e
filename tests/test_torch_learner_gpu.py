"""The data-parallel learner on the card: the sharded replay's kernel calls
at the per-shard shapes, the learner over the mesh ``[cuda:0, cuda:0]``
(two shard threads on one card), and the microbatched fused graph.

Every test here needs a CUDA device and skips without one. The file
imports neither ``jax`` nor ``repro``, so it runs where only PyTorch is
installed:

    PYTHONPATH=src python -m pytest --noconftest -m gpu \
        tests/test_torch_learner_gpu.py

Bounds: the sharded draws, rows, weights and tree writes equal the
unsharded kernels' exactly (the shard roots are the unsharded tree's own
nodes, and the top of the descent is built from them with its sums); the
per-shard kernels equal their plain versions bit for bit; PPO over two
shards within 1e-5 of one device, SAC and DDPG within 0.05 (the
reference's D = 4 bounds); a fused microbatched run equals the stepped one
bit for bit.
"""
import dataclasses
import math

import pytest
import torch

from repro_torch import kernels
from repro_torch.core.fused import state_tensors
from repro_torch.data import buffers, replay
from repro_torch.distributed.learner import run_shards
from repro_torch.distributed.replay_sharded import (
    ShardedPrioritizedBuffer,
    ShardedUniformBuffer,
    ShardStates,
)
from repro_torch.experiment import ExperimentSpec, Schedule, build, run
from repro_torch.kernels.gae import ops as gae_ops
from repro_torch.kernels.sum_tree import ops as tree_ops
from repro_torch.kernels.sum_tree import sumtree_build


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _storage(rows, gen, device):
    return {"obs": torch.randn(rows, 14, generator=gen, device=device),
            "rewards": torch.randn(rows, generator=gen, device=device),
            "dones": torch.rand(rows, generator=gen, device=device) < 0.1}


def _ring(storage, lo, hi, device):
    return replay.ReplayState(
        {k: v[lo:hi].clone() for k, v in storage.items()},
        torch.zeros((), dtype=torch.int32, device=device),
        torch.tensor(hi - lo, dtype=torch.int32, device=device), True)


def _paired(cap, d, device, seed=0):
    gen = torch.Generator(device=device).manual_seed(seed)
    mass = torch.rand(cap, generator=gen, device=device)
    mass[torch.rand(cap, generator=gen, device=device) < 0.3] = 0.0
    storage = _storage(cap, gen, device)
    c = cap // d
    one = torch.ones((), device=device)
    shards = ShardStates(buffers.PrioritizedState(
        _ring(storage, s * c, (s + 1) * c, device),
        sumtree_build(mass[s * c:(s + 1) * c]), one) for s in range(d))
    whole = buffers.PrioritizedState(_ring(storage, 0, cap, device),
                                     sumtree_build(mass), one)
    return shards, whole, gen


def _in_shards(mesh, fn):
    outs = run_shards(mesh, fn, [(s,) for s in range(len(mesh))])
    return {k: torch.cat([o[k] for o in outs]) for k in outs[0]}


@pytest.mark.gpu
@pytest.mark.parametrize("cap,d,batch", [(1 << 20, 2, 256), (1 << 16, 4, 64),
                                         (1 << 10, 2, 4096)])
def test_sharded_prioritized_sample_equals_the_unsharded_kernels(cuda, cap,
                                                                 d, batch):
    shards, whole, gen = _paired(cap, d, cuda)
    buf = ShardedPrioritizedBuffer(buffers.PrioritizedBuffer(cap, batch), d)
    uniforms = torch.rand(batch, generator=gen, device=cuda)
    kernels.reset_launch_counts()
    got = _in_shards([cuda] * d, lambda s: buf.sample_with(shards[s],
                                                            uniforms))
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    assert counts["sumtree_find"] == counts["ring_gather"] == d
    want = buffers.PrioritizedBuffer(cap, batch).sample_with(whole, uniforms)
    for k in want:
        assert torch.equal(got[k], want[k]), k
    roots = sum(float(st.tree.total) for st in shards)
    assert math.isclose(roots, float(whole.tree.total), rel_tol=1e-6)

    idx = want["indices"]
    pri = torch.rand(batch, generator=gen, device=cuda) + 0.1
    bl = batch // d
    kernels.reset_launch_counts()
    new = run_shards([cuda] * d, lambda s: buf.update_priorities(
        shards[s], idx[s * bl:(s + 1) * bl], pri[s * bl:(s + 1) * bl]),
        [(s,) for s in range(d)])
    torch.cuda.synchronize()
    assert kernels.launch_counts()["sumtree_update"] == d
    want_st = buffers.PrioritizedBuffer(cap, batch).update_priorities(
        whole, idx, pri)
    assert torch.equal(torch.cat([st.tree.flat[:cap // d] for st in new]),
                       want_st.tree.levels[0])
    assert torch.equal(torch.stack([st.tree.total for st in new]),
                       want_st.tree.levels[-1 - int(math.log2(d))])
    for st in new:
        assert bool((st.tree.winner == -1).all())
        assert torch.equal(st.max_priority, want_st.max_priority)


@pytest.mark.gpu
def test_sharded_uniform_sample_gathers_each_row_from_its_owner(cuda):
    cap, d, batch = 1 << 12, 2, 256
    gen = torch.Generator(device=cuda).manual_seed(3)
    storage = _storage(cap, gen, cuda)
    c = cap // d
    shards = ShardStates(_ring(storage, s * c, (s + 1) * c, cuda)
                         for s in range(d))
    buf = ShardedUniformBuffer(buffers.UniformBuffer(cap, batch), d)
    got = _in_shards([cuda] * d, lambda s: buf.sample(
        shards[s], torch.Generator(device=cuda).manual_seed(11)))
    idx = got["indices"].to(torch.int64)
    assert int(idx.max()) >= c                    # both shards drawn from
    for k, v in storage.items():
        assert torch.equal(got[k], v[idx]), k


@pytest.mark.gpu
def test_per_shard_kernel_shapes_equal_the_plain_versions(cuda):
    """GAE at the paper's 10 × 16 samplers split over 2 shards (T 125 ×
    80), the find and a masked update in a 2^19-leaf subtree."""
    gen = torch.Generator(device=cuda).manual_seed(5)
    r, v, lv = (torch.randn(s, generator=gen, device=cuda)
                for s in ((125, 80), (125, 80), (80,)))
    dn = torch.rand(125, 80, generator=gen, device=cuda) < 0.05
    got = gae_ops.gae_cuda(r, v, dn, lv, gamma=0.99, lam=0.95)
    want = gae_ops.gae_ref(r, v, dn, lv, 0.99, 0.95)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    cap = 1 << 19
    tree = sumtree_build(torch.rand(cap, generator=gen, device=cuda))
    m = (torch.arange(256, device=cuda) + torch.rand(
        256, generator=gen, device=cuda)) / torch.tensor(
        256.0, device=cuda) * tree.total
    assert torch.equal(tree_ops.sumtree_find_batch(tree, m, impl="cuda"),
                       tree_ops.sumtree_find_batch_ref(tree, m))
    idx = torch.randint(0, cap, (256,), generator=gen, device=cuda,
                        dtype=torch.int32)
    idx = torch.where(torch.rand(256, generator=gen, device=cuda) < 0.5,
                      idx, cap)                     # another shard's rows
    vals = torch.rand(256, generator=gen, device=cuda)
    want_tree = tree_ops.SumTree.of(tree.flat.clone())
    tree_ops.sumtree_update_ref(want_tree, idx, vals)
    tree_ops.sumtree_update(tree, idx, vals, impl="cuda")
    assert torch.equal(tree.flat, want_tree.flat)


SMALL = dict(num_samplers=2, global_batch=16, horizon=32, iterations=3)


def _params(res):
    return [p.detach().clone() for p in res.params.parameters()]


@pytest.mark.gpu
@pytest.mark.parametrize("algo,buffer,tol", [("ppo", None, 1e-5),
                                             ("sac", "prioritized", 0.05),
                                             ("ddpg", "prioritized", 0.05)])
def test_two_shards_on_one_card_match_one_device(cuda, algo, buffer, tol):
    spec = ExperimentSpec(
        env="cheetah", algo=algo, buffer=buffer,
        buffer_kwargs={"capacity": 4096, "batch_size": 64} if buffer else {},
        schedule=Schedule(**SMALL))
    one = run(spec, device=cuda)
    kernels.reset_launch_counts()
    two = run(dataclasses.replace(spec, schedule=dataclasses.replace(
        spec.schedule, learner_devices=2)), device=cuda, mesh=[cuda, cuda])
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    diff = max(float((a - b).abs().max())
               for a, b in zip(_params(one), _params(two)))
    assert diff < tol, diff
    it = SMALL["iterations"]
    if algo == "ppo":
        assert counts["gae"] == 2 * it
    else:
        assert counts["ring_insert"] == 2 * it
        assert counts["sumtree_find"] == counts["ring_gather"] == 2 * it * 4
        assert counts["sumtree_update"] == 2 * it * 5


@pytest.mark.gpu
@pytest.mark.parametrize("algo,buffer", [("ppo", None),
                                         ("sac", "prioritized")])
def test_fused_microbatched_replays_equal_the_stepped_run(cuda, algo,
                                                          buffer):
    sched = Schedule(num_samplers=1, global_batch=16, horizon=32,
                     iterations=5, learner_microbatches=2)
    spec = ExperimentSpec(
        env="cheetah", algo=algo, buffer=buffer,
        buffer_kwargs={"capacity": 4096, "batch_size": 64} if buffer else {},
        schedule=sched)

    def carried(res):
        r = res.runner
        carry = (r.state.env_carry if hasattr(r, "state")
                 else r.backend.carries[0])
        return [x.detach().clone() for x in state_tensors(
            (res.params, r.opt_state, carry,
             r.plane_state[0] if r.plane_state else None))]

    stepped = run(spec, device=cuda)
    fused = run(dataclasses.replace(spec, runtime="fused"), device=cuda)
    assert fused.runner.graph_stats["launches_per_replay"]
    assert [lg.mean_return for lg in fused.logs] == \
        [lg.mean_return for lg in stepped.logs]
    a, b = carried(fused), carried(stepped)
    assert len(a) == len(b) > 0
    assert all(torch.equal(x, y) for x, y in zip(a, b))


@pytest.mark.gpu
def test_more_learner_devices_than_cards_raises(cuda):
    d = torch.cuda.device_count() + 1
    with pytest.raises(ValueError, match=f"learner_devices={d}"):
        build(ExperimentSpec(env="cheetah", schedule=Schedule(
            num_samplers=2, global_batch=2 * d, learner_devices=d)),
            device=cuda)
