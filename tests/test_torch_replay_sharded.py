"""The sharded replay (``repro_torch.distributed.replay_sharded``) and
``sumtree_update_masked``, against ``tests/test_replay_sharded.py``: the
masked tree update against the reference's, the dispatch and its errors,
D = 1 bit for bit against the unsharded buffers, and D = 4 (four shard
threads of this process) drawing exactly the unsharded buffer's indices
(the port's and the JAX package's) with roots that sum to the unsharded
root, the realized per-shard counts of the stratified masses, and the
priority write-back on the same leaves.

Bounds: all exact but where JAX computes a weight (``p ** -beta``, its
``pow`` against ATen's: rtol 1e-6, as ``tests/test_torch_buffers.py``) and
the roots' sum against the root (rtol 1e-6, the reference's bound; the
pairwise sum the sharded descent builds is exact).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data import buffers as jax_buffers
from repro.data import replay as jax_replay
from repro.kernels.sum_tree import sumtree_update_masked as jax_masked
from repro_torch.data import buffers, replay
from repro_torch.distributed.learner import run_shards
from repro_torch.distributed.replay_sharded import (
    ShardedPrioritizedBuffer,
    ShardedUniformBuffer,
    ShardStates,
    shard_buffer,
)
from repro_torch.kernels.sum_tree import SumTree, sumtree_build
from repro_torch.kernels.sum_tree.ref import (
    sumtree_update_masked,
    sumtree_update_ref,
)


def _tree(n, seed):
    leaves = np.random.RandomState(seed).uniform(0.1, 1.0, n).astype(
        np.float32)
    return leaves, sumtree_build(torch.from_numpy(leaves))


def _copy(tree):
    return SumTree.of(tree.flat.clone())


# ======================================================= masked tree update
def test_sumtree_update_masked_all_true_matches_unmasked():
    _, tree = _tree(16, 1)
    idx = torch.tensor([3, 7, 0, 12])
    vals = torch.tensor([0.5, 2.0, 0.1, 1.5])
    want = sumtree_update_ref(_copy(tree), idx, vals)
    got = sumtree_update_masked(_copy(tree), idx, vals,
                                torch.ones(4, dtype=torch.bool))
    assert torch.equal(got.flat, want.flat)


def test_sumtree_update_masked_partial_rows_untouched():
    _, tree = _tree(16, 2)
    idx = torch.tensor([3, 7, 0, 12])
    vals = torch.tensor([0.5, 2.0, 0.1, 1.5])
    mask = torch.tensor([True, False, True, False])
    got = sumtree_update_masked(_copy(tree), idx, vals, mask)
    want = sumtree_update_ref(_copy(tree), torch.tensor([3, 0]),
                              torch.tensor([0.5, 0.1]))
    assert torch.equal(got.flat, want.flat)


@pytest.mark.parametrize("mask", [[1, 1, 1, 1, 1, 1], [1, 0, 1, 0, 0, 1],
                                  [0, 0, 0, 0, 0, 0], [0, 1, 1, 1, 1, 0]])
def test_sumtree_update_masked_matches_the_reference(mask):
    """The port's plain version and the reference's on the same inputs,
    duplicate indices included (the last kept write wins)."""
    leaves, tree = _tree(32, 3)
    idx = np.array([5, 9, 5, 31, 0, 9], np.int32)
    vals = np.array([0.25, 1.5, 3.0, 0.75, 2.0, 0.5], np.float32)
    m = np.array(mask, bool)
    jtree = jax_buffers.sumtree_build(jnp.asarray(leaves))
    want = jax_masked(jtree, jnp.asarray(idx), jnp.asarray(vals),
                      jnp.asarray(m))
    got = sumtree_update_masked(tree, torch.from_numpy(idx),
                                torch.from_numpy(vals), torch.from_numpy(m))
    for g, w in zip(got.levels, want.levels):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


# =================================================== dispatch + validation
def test_shard_buffer_dispatch_and_validation():
    assert isinstance(shard_buffer(buffers.UniformBuffer(64, 16), 4),
                      ShardedUniformBuffer)
    assert isinstance(shard_buffer(buffers.PrioritizedBuffer(64, 16), 4),
                      ShardedPrioritizedBuffer)
    fifo = buffers.FifoBuffer()
    assert shard_buffer(fifo, 4) is fifo                  # trajectory kind
    with pytest.raises(ValueError, match="power-of-two"):
        ShardedPrioritizedBuffer(buffers.PrioritizedBuffer(64, 16), 3)
    with pytest.raises(ValueError, match="batch_size"):
        ShardedUniformBuffer(buffers.UniformBuffer(64, 15), 4)
    with pytest.raises(ValueError, match="capacity"):
        ShardedUniformBuffer(buffers.UniformBuffer(66, 16), 4)


def test_sharded_buffer_outside_a_step_raises():
    buf = ShardedUniformBuffer(buffers.UniformBuffer(8, 4), 2)
    state = _uniform_states(8, 2)[0][0]
    with pytest.raises(RuntimeError, match="shard threads"):
        buf.sample(state, torch.Generator().manual_seed(0))


# ======================================================== paired states
def _storage(cap, seed):
    rng = np.random.RandomState(seed)
    return {"obs": torch.arange(cap, dtype=torch.float32)[:, None],
            "rewards": torch.from_numpy(rng.randn(cap).astype(np.float32))}


def _ring(storage, lo, hi):
    return replay.ReplayState({k: v[lo:hi].clone()
                               for k, v in storage.items()},
                              torch.zeros((), dtype=torch.int32),
                              torch.tensor(hi - lo, dtype=torch.int32), True)


def _paired_states(cap, d, seed=0):
    """D local prioritized states (shard ``s`` holds global leaves
    ``[s * C_loc, (s + 1) * C_loc)``) and the unsharded state over the
    same leaves and storage."""
    rng = np.random.RandomState(seed)
    leaves = rng.uniform(0.1, 2.0, cap).astype(np.float32)
    storage = _storage(cap, seed + 1)
    c = cap // d
    shards = ShardStates(
        buffers.PrioritizedState(
            _ring(storage, s * c, (s + 1) * c),
            sumtree_build(torch.from_numpy(leaves[s * c:(s + 1) * c])),
            torch.ones(()))
        for s in range(d))
    ref = buffers.PrioritizedState(_ring(storage, 0, cap),
                                   sumtree_build(torch.from_numpy(leaves)),
                                   torch.ones(()))
    return shards, ref, leaves, storage


def _uniform_states(cap, d, seed=3):
    storage = _storage(cap, seed)
    c = cap // d
    return (ShardStates(_ring(storage, s * c, (s + 1) * c)
                        for s in range(d)), _ring(storage, 0, cap))


def _in_shards(d, fn):
    """``fn(s)`` in D lockstep shard threads; the shards' outputs, each a
    dict of this shard's rows, concatenated in shard order."""
    outs = run_shards(["cpu"] * d, fn, [(s,) for s in range(d)])
    return {k: torch.cat([o[k] for o in outs]) for k in outs[0]}


# ==================================================== D = 1: bit for bit
def test_sharded_prioritized_d1_bitwise():
    cap, batch = 32, 16
    buf = ShardedPrioritizedBuffer(buffers.PrioritizedBuffer(cap, batch), 1)
    shards, ref, _, _ = _paired_states(cap, 1)
    got = buf.sample(shards[0], torch.Generator().manual_seed(7))
    want = buffers.PrioritizedBuffer(cap, batch).sample(
        ref, torch.Generator().manual_seed(7))
    assert list(got) == list(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and torch.equal(got[k],
                                                             want[k]), k


def test_sharded_uniform_d1_bitwise():
    cap, batch = 32, 16
    buf = ShardedUniformBuffer(buffers.UniformBuffer(cap, batch), 1)
    shards, ref = _uniform_states(cap, 1)
    got = buf.sample(shards[0], torch.Generator().manual_seed(11))
    want = buffers.UniformBuffer(cap, batch).sample(
        ref, torch.Generator().manual_seed(11))
    assert list(got) == list(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and torch.equal(got[k],
                                                             want[k]), k


def test_sharded_prioritized_d1_update_priorities():
    cap, batch = 32, 16
    buf = ShardedPrioritizedBuffer(buffers.PrioritizedBuffer(cap, batch), 1)
    shards, ref, _, _ = _paired_states(cap, 1)
    idx = torch.from_numpy(np.random.RandomState(4).permutation(cap)[:batch]
                           .astype(np.int32))
    pri = (idx.to(torch.float32) % 7 + 1.0) * 0.3
    got = buf.update_priorities(shards[0], idx, pri)
    want = buffers.PrioritizedBuffer(cap, batch).update_priorities(
        ref, idx, pri)
    assert torch.equal(got.tree.flat, want.tree.flat)
    assert torch.equal(got.max_priority, want.max_priority)


# ================================================ D = 4: exact, in-process
CAP, BATCH, D = 32, 16, 4


def test_sharded_prioritized_d4_matches_the_unsharded_buffer():
    """Four shards draw the unsharded buffer's exact global leaves, rows
    and weights from the same generator state; the shard roots sum to the
    root; each shard draws what the stratified masses allot to its
    interval; the priority write-back lands on the same leaves with the
    same values."""
    buf = ShardedPrioritizedBuffer(buffers.PrioritizedBuffer(CAP, BATCH), D)
    ref = buffers.PrioritizedBuffer(CAP, BATCH)
    shards, state_ref, _, _ = _paired_states(CAP, D)
    got = _in_shards(D, lambda s: buf.sample(
        shards[s], torch.Generator().manual_seed(7)))
    want = ref.sample(state_ref, torch.Generator().manual_seed(7))
    for k in want:
        assert torch.equal(got[k], want[k]), k

    roots = np.array([float(st.tree.total) for st in shards], np.float64)
    np.testing.assert_allclose(roots.sum(), float(state_ref.tree.total),
                               rtol=1e-6)
    u = ((torch.arange(BATCH, dtype=torch.float32)
          + torch.rand(BATCH, generator=torch.Generator().manual_seed(7)))
         / BATCH).numpy().astype(np.float64)
    m = u * roots.sum()
    prefix = np.concatenate([[0.0], np.cumsum(roots)])
    owner = np.clip(np.searchsorted(prefix, m, side="right") - 1, 0, D - 1)
    realized = np.bincount(got["indices"].numpy() // (CAP // D), minlength=D)
    np.testing.assert_array_equal(realized, np.bincount(owner, minlength=D))

    idx = want["indices"]
    pri = (idx.to(torch.float32) % 7 + 1.0) * 0.3
    bl = BATCH // D
    new = run_shards(["cpu"] * D, lambda s: buf.update_priorities(
        shards[s], idx[s * bl:(s + 1) * bl], pri[s * bl:(s + 1) * bl]),
        [(s,) for s in range(D)])
    want_st = ref.update_priorities(state_ref, idx, pri)
    assert torch.equal(torch.cat([st.tree.levels[0] for st in new]),
                       want_st.tree.levels[0])
    for st in new:
        assert torch.equal(st.max_priority, want_st.max_priority)


def test_sharded_prioritized_d4_matches_jax():
    """The same draw against the JAX package's unsharded buffer, its
    uniforms injected: the same leaves and rows."""
    shards, _, leaves, storage = _paired_states(CAP, D)
    jstate = jax_buffers.PrioritizedState(
        jax_replay.ReplayState(
            {k: jnp.asarray(v.numpy()) for k, v in storage.items()},
            jnp.zeros((), jnp.int32), jnp.asarray(CAP, jnp.int32)),
        jax_buffers.sumtree_build(jnp.asarray(leaves)),
        jnp.ones((), jnp.float32))
    key = jax.random.PRNGKey(7)
    want = jax_buffers.PrioritizedBuffer(CAP, BATCH).sample(jstate, key)
    u = torch.from_numpy(np.array(jax.random.uniform(key, (BATCH,))))
    buf = ShardedPrioritizedBuffer(buffers.PrioritizedBuffer(CAP, BATCH), D)
    got = _in_shards(D, lambda s: buf.sample_with(shards[s], u))
    for k in ("indices", "obs", "rewards"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]),
                                      err_msg=k)
    np.testing.assert_allclose(got["weights"].numpy(),
                               np.asarray(want["weights"]), rtol=1e-6)


def test_sharded_uniform_d4_draws_its_owners_rows():
    """Each drawn global slot's row comes from the shard that owns it: the
    assembled batch is the unsharded storage's rows at those slots."""
    buf = ShardedUniformBuffer(buffers.UniformBuffer(CAP, BATCH), D)
    shards, ref = _uniform_states(CAP, D)
    got = _in_shards(D, lambda s: buf.sample(
        shards[s], torch.Generator().manual_seed(11)))
    idx = got["indices"].to(torch.int64)
    assert int(idx.min()) >= 0 and int(idx.max()) < CAP
    assert len(set(idx.tolist()) & set(range(CAP // D, CAP))) > 0
    for k, v in ref.storage.items():
        assert torch.equal(got[k], v[idx]), k
    assert torch.equal(got["weights"], torch.ones(BATCH))


def test_sharded_init_places_each_shard_on_its_device():
    buf = ShardedPrioritizedBuffer(buffers.PrioritizedBuffer(64, 16), 2,
                                   devices=["cpu", "cpu"])
    example = {"obs": torch.zeros(1, 3), "rewards": torch.zeros(1),
               "dones": torch.zeros(1, dtype=torch.bool)}
    states = buf.init(example)
    assert isinstance(states, ShardStates) and len(states) == 2
    assert all(st.tree.capacity == 32 and st.ring.storage["obs"].shape ==
               (32, 3) for st in states)
    assert states[0].ring.storage["obs"].data_ptr() != \
        states[1].ring.storage["obs"].data_ptr()
