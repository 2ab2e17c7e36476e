"""Plain PyTorch sum tree, the prioritized-replay substrate (port of
``repro/kernels/sum_tree/ref.py``).

The reference keeps the tree as a tuple of per-level arrays, leaves first,
and the TPU kernels take the levels concatenated into one flat array. Here
the flat array *is* the state: ``SumTree.flat`` is ``(2 * cap - 1,)``
float32, leaves first, and ``SumTree.levels`` are views into it, so neither
a kernel call nor a plain one concatenates anything. The tree also owns the
CUDA update kernels' scratch, ``winner``, kept at -1 between calls: on a
CUDA tree of the size ``ops.update_scratch_size`` gives (one int32 per leaf,
then the kernels' flags and counter), on a CPU tree one per leaf, unused.

``sumtree_update_ref`` writes into the tree in place, as the CUDA kernel
does. ``sumtree_update_masked`` (the sharded replay's form) is not ported.
"""
from __future__ import annotations

from typing import NamedTuple, Sequence, Tuple

import torch


def level_sizes(capacity: int) -> Tuple[int, ...]:
    """Per-level lengths of the flat layout, leaves first."""
    if capacity < 1 or capacity & (capacity - 1):
        raise ValueError(f"sum-tree capacity must be a power of two, "
                         f"got {capacity}")
    sizes = [capacity]
    while sizes[-1] > 1:
        sizes.append(sizes[-1] // 2)
    return tuple(sizes)


def level_offsets(sizes: Sequence[int]) -> Tuple[int, ...]:
    offs, off = [], 0
    for s in sizes:
        offs.append(off)
        off += s
    return tuple(offs)


def tree_unflatten(flat: torch.Tensor, capacity: int
                   ) -> Tuple[torch.Tensor, ...]:
    """Per-level views of a flat tree, leaves first."""
    sizes = level_sizes(capacity)
    if flat.shape != (2 * capacity - 1,):
        raise ValueError(f"a flat tree of capacity {capacity} has shape "
                         f"({2 * capacity - 1},); got {tuple(flat.shape)}")
    return tuple(flat[off:off + size]
                 for off, size in zip(level_offsets(sizes), sizes))


class SumTree(NamedTuple):
    """A binary sum tree: ``levels[0]`` are the leaf masses (capacity a
    power of two), ``levels[k]`` the pairwise sums of ``levels[k - 1]``,
    ``levels[-1]`` the total ``(1,)``; all views of ``flat``."""

    flat: torch.Tensor      # (2 * cap - 1,) float32, leaves first
    winner: torch.Tensor    # int32 at -1: the update kernels' scratch

    @classmethod
    def of(cls, flat: torch.Tensor) -> "SumTree":
        """Wrap a flat tree (leaves-first levels concatenated)."""
        cap = (flat.shape[0] + 1) // 2
        level_sizes(cap)
        size = cap
        if flat.is_cuda:            # the layout of csrc/sum_tree.cu
            from repro_torch.kernels.sum_tree import ops
            size = ops.update_scratch_size(cap)
        return cls(flat, torch.full((size,), -1, dtype=torch.int32,
                                    device=flat.device))

    @property
    def capacity(self) -> int:
        return (self.flat.shape[0] + 1) // 2

    @property
    def levels(self) -> Tuple[torch.Tensor, ...]:
        return tree_unflatten(self.flat, self.capacity)

    @property
    def total(self) -> torch.Tensor:
        """The root mass, a 0-dim view."""
        return self.flat[-1]


def tree_flatten(levels: Sequence[torch.Tensor]) -> torch.Tensor:
    """Concatenate per-level arrays (the reference's layout) leaves first
    into the flat layout."""
    return torch.cat([torch.as_tensor(x).reshape(-1) for x in levels])


def sumtree_build(leaves: torch.Tensor) -> SumTree:
    """The tree over ``leaves`` (cap,), each parent the pairwise sum
    ``x[0::2] + x[1::2]`` of its level."""
    cap = leaves.shape[0]
    tree = SumTree.of(torch.empty(2 * cap - 1, dtype=torch.float32,
                                  device=leaves.device))
    levels = tree.levels
    levels[0].copy_(leaves)
    for lo, hi in zip(levels[:-1], levels[1:]):
        hi.copy_(lo[0::2] + lo[1::2])
    return tree


def sumtree_find_batch_ref(tree: SumTree, masses: torch.Tensor
                           ) -> torch.Tensor:
    """Stratified root-to-leaf descent for every mass, one gather per
    level: at each node go right when ``mass >= left`` and subtract
    ``left``. Returns int32 leaf indices of ``masses``' shape."""
    idx = torch.zeros(masses.shape, dtype=torch.int32, device=masses.device)
    for level in tree.levels[-2::-1]:
        idx = idx * 2
        left = level[idx]
        go_right = masses >= left
        masses = torch.where(go_right, masses - left, masses)
        idx = torch.where(go_right, idx + 1, idx)
    return idx


def sumtree_update_ref(tree: SumTree, idx: torch.Tensor,
                       leaf_values: torch.Tensor) -> SumTree:
    """Set the leaf masses at ``idx``, then recompute the touched
    root-to-leaf paths from the post-write children; in place.

    As with the reference's jnp scatter, an index in ``[-cap, 0)`` counts
    from the end and one outside ``[-cap, cap)`` is dropped. That scatter
    is in order, so among duplicate indices the last write wins. A PyTorch
    index assignment with duplicates is undefined unless the duplicates
    carry one value, so every write of a slot carries its winner's value:
    a stable sort by index, then the last of each run. Shapes never depend
    on the data (no host read, so a CUDA graph can capture it): a dropped
    index rewrites a slot that is written anyway, with the value it gets,
    or leaf 0 with its own value when nothing is kept. Parent writes need
    no such care: every write of a parent stores the same sum, and a
    recomputed parent of an untouched path its old one."""
    cap = tree.capacity
    idx = idx.reshape(-1).to(torch.int64)
    values = leaf_values.reshape(-1).to(torch.float32)
    n = idx.shape[0]
    if n == 0:
        return tree
    levels = tree.levels
    idx = torch.where(idx < 0, idx + cap, idx)
    kept = (idx >= 0) & (idx < cap)
    key, order = torch.sort(torch.where(kept, idx, cap), stable=True)
    last = torch.ones_like(key, dtype=torch.bool)
    last[:-1] = key[1:] != key[:-1]
    pos = torch.arange(n, device=key.device)
    run_end = torch.flip(torch.cummin(torch.flip(
        torch.where(last, pos, n), (0,)), 0).values, (0,))
    winning = values[order[run_end]]
    any_kept = key[0] < cap
    spare_slot = torch.where(any_kept, key[0], 0)
    spare_value = torch.where(any_kept, winning[0], levels[0][0])
    slot = torch.where(key < cap, key, spare_slot)
    levels[0][slot] = torch.where(key < cap, winning, spare_value)
    child = slot
    for lo, hi in zip(levels[:-1], levels[1:]):
        parent = child // 2
        hi[parent] = lo[2 * parent] + lo[2 * parent + 1]
        child = parent
    return tree
