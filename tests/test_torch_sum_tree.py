"""Sum-tree parity: the port's plain versions against the JAX refs
(``impl="ref"``), exact, at capacities 1 to 1024: build, the batched
stratified descent (zero-mass leaves and masses at the edges included) and
the update with duplicate indices (last write wins). Inputs are made with
numpy and handed to both sides.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.sum_tree import ops as jax_tree
from repro.kernels.sum_tree import ref as jax_tree_ref
from repro_torch import kernels
from repro_torch.kernels.sum_tree import ops as tree_ops
from repro_torch.kernels.sum_tree import ref as tree_ref

CAPS = [1, 2, 8, 64, 1024]


def _leaves(cap, seed):
    rng = np.random.default_rng(seed)
    x = rng.random(cap).astype(np.float32)
    x[rng.random(cap) < 0.3] = 0.0          # zero-mass leaves
    return x


def _assert_levels(got: tree_ref.SumTree, want):
    assert len(got.levels) == len(want.levels)
    for g, w in zip(got.levels, want.levels):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("cap", CAPS)
def test_build_matches_jax(cap):
    x = _leaves(cap, cap)
    got = tree_ref.sumtree_build(torch.from_numpy(x))
    _assert_levels(got, jax_tree_ref.sumtree_build(jnp.asarray(x)))
    assert got.flat.shape == (2 * cap - 1,)
    assert float(got.total) == float(got.levels[-1][0])
    # the levels are views of the flat state
    assert got.levels[0].data_ptr() == got.flat.data_ptr()


@pytest.mark.parametrize("cap", CAPS)
def test_find_matches_jax(cap):
    x = _leaves(cap, cap + 1)
    want_tree = jax_tree_ref.sumtree_build(jnp.asarray(x))
    total = np.float32(want_tree.total)
    rng = np.random.default_rng(cap)
    B = 64
    masses = ((np.arange(B) + rng.random(B)) / B * total).astype(np.float32)
    masses[:3] = [0.0, total, np.nextafter(total, np.float32(0))]
    want = jax_tree.sumtree_find_batch(want_tree, jnp.asarray(masses),
                                       impl="ref")
    got = tree_ops.sumtree_find_batch(
        tree_ref.sumtree_build(torch.from_numpy(x)), torch.from_numpy(masses))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("cap", CAPS)
def test_update_with_duplicates_matches_jax(cap):
    rng = np.random.default_rng(cap + 2)
    x = _leaves(cap, cap + 2)
    idx = rng.integers(0, cap, 48).astype(np.int32)
    idx[-4:] = idx[0]                      # duplicates: the last one wins
    vals = rng.random(48).astype(np.float32)
    vals[5] = 0.0
    want = jax_tree.sumtree_update(jax_tree_ref.sumtree_build(jnp.asarray(x)),
                                   jnp.asarray(idx), jnp.asarray(vals),
                                   impl="ref")
    tree = tree_ref.sumtree_build(torch.from_numpy(x))
    got = tree_ops.sumtree_update(tree, torch.from_numpy(idx),
                                  torch.from_numpy(vals))
    assert got.flat is tree.flat           # in place
    _assert_levels(got, want)
    assert float(got.levels[0][int(idx[0])]) == float(vals[-1])


@pytest.mark.parametrize("cap", [1, 8, 1024])
def test_update_wraps_negative_and_drops_out_of_range_like_jax(cap):
    """jnp's scatter counts an index in [-cap, 0) from the end and drops
    one outside [-cap, cap); duplicates resolve after that wrap."""
    rng = np.random.default_rng(cap + 5)
    x = _leaves(cap, cap + 5)
    idx = np.array([-1, cap - 1, cap, -cap - 1, -cap, 0, 2 * cap, -cap // 2,
                    cap // 2, 1 << 30, -(1 << 30)], dtype=np.int32)
    vals = rng.random(idx.shape[0]).astype(np.float32)
    want = jax_tree.sumtree_update(jax_tree_ref.sumtree_build(jnp.asarray(x)),
                                   jnp.asarray(idx), jnp.asarray(vals),
                                   impl="ref")
    got = tree_ops.sumtree_update(tree_ref.sumtree_build(torch.from_numpy(x)),
                                  torch.from_numpy(idx),
                                  torch.from_numpy(vals))
    _assert_levels(got, want)


def test_flat_layout_matches_jax_flatten():
    x = np.arange(16, dtype=np.float32)
    want = jax_tree.tree_flatten(jax_tree_ref.sumtree_build(jnp.asarray(x)))
    got = tree_ref.sumtree_build(torch.from_numpy(x))
    np.testing.assert_array_equal(got.flat.numpy(), np.asarray(want))
    levels = tree_ops.tree_unflatten(got.flat, 16)
    np.testing.assert_array_equal(
        tree_ops.tree_flatten(levels).numpy(), got.flat.numpy())
    assert tree_ops.level_sizes(16) == (16, 8, 4, 2, 1)
    assert tree_ops.level_offsets((16, 8, 4, 2, 1)) == (0, 16, 24, 28, 30)
    with pytest.raises(ValueError, match="power of two"):
        tree_ops.level_sizes(12)


def test_scratch_and_cpu_selection():
    kernels.reset_launch_counts()
    tree = tree_ref.sumtree_build(torch.ones(8))
    assert tree.winner.dtype == torch.int32
    assert bool((tree.winner == -1).all()) and tree.capacity == 8
    tree_ops.sumtree_update(tree, torch.tensor([1, 1]),
                            torch.tensor([2.0, 3.0]), impl="cuda")
    tree_ops.sumtree_find_batch(tree, torch.tensor([0.5]), impl="cuda")
    assert float(tree.total) == 10.0
    assert kernels.launch_counts()["sumtree_update"] == 0
    assert kernels.launch_counts()["sumtree_find"] == 0



@pytest.mark.parametrize("cap", [1, 2, 1024, 1 << 20])
def test_cpu_tree_capacity_and_scratch(cap):
    """The capacity comes from the flat array; a CPU tree's scratch is one
    int32 per leaf at -1 (the plain version leaves it so)."""
    tree = tree_ref.SumTree.of(torch.zeros(2 * cap - 1))
    assert tree.capacity == cap
    assert tree.winner.shape == (cap,) and tree.winner.dtype == torch.int32
    tree_ops.sumtree_update(tree, torch.tensor([0, cap - 1, -1]),
                            torch.tensor([1.0, 2.0, 4.0]))
    assert bool((tree.winner == -1).all())
    assert float(tree.total) == (4.0 if cap == 1 else 5.0)
