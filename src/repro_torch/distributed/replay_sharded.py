"""Sharded experience buffers: per-shard rings and sum-trees whose sampled
batch is the single buffer's (port of
``repro/distributed/replay_sharded.py``).

The wrappers run inside the shard threads of a learner step
(``learner.ShardedLearner``): ``add``, ``sample`` and
``update_priorities`` take this shard's local state and trajectory slice
and meet the other shards only through the collectives of the active
``grad_sync.Shard``. ``init`` is the one call made outside a step: it
allocates every shard's local state on its mesh device and returns them as
``ShardStates``, the plane state the runner carries between steps.

Layout
------
* **uniform**: shard ``s`` owns global slots ``[s * C_loc, (s + 1) *
  C_loc)``, ``C_loc = capacity / D``. Every shard adds its ``B / D``-wide
  trajectory slice, so head and fill size stay equal across shards with
  no collective.
* **prioritized**: one sum tree per shard over its ``C_loc`` leaves. With
  capacity and D powers of two each shard's tree is exactly a subtree of
  the single buffer's tree, and the shard roots are that tree's nodes
  ``log2(D)`` levels below its root. So the descent factors exactly: the
  top ``log2(D)`` levels, built here from the gathered shard roots with
  the same pairwise sums, pick the owning shard and the mass left over,
  and the owner's own descent (the ``sumtree_find`` kernel on the card)
  finishes it. Every shard draws the same ``B`` stratified uniforms (the
  shards' generators hold one state), so the drawn global leaves are the
  single tree's, index for index.

Each sampled row is gathered by its owner and assembled by selecting, row
by row, the owner's copy (exact: no arithmetic on the rows); each shard
then keeps rows ``[s * B / D, (s + 1) * B / D)`` as its minibatch.
Priority feedback inverts the routing: every shard gathers all ``(index,
priority)`` pairs and writes only the leaves it owns, through the
``sumtree_update`` kernel with the others' indices set out of range (the
plain form is ``kernels.sum_tree.ref.sumtree_update_masked``).

With D = 1 no collective runs and every row is its own shard's, so both
wrappers compute what ``UniformBuffer`` and ``PrioritizedBuffer`` do, bit
for bit.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import torch

from repro_torch.data import replay
from repro_torch.data.buffers import (
    PrioritizedBuffer,
    PrioritizedState,
    UniformBuffer,
)
from repro_torch.distributed import grad_sync
from repro_torch.kernels.replay_ring import ring_gather
from repro_torch.kernels.sum_tree import sumtree_find_batch, sumtree_update


class ShardStates(tuple):
    """A sharded buffer's per-shard states, in shard order (state ``s`` on
    mesh device ``s``): the plane state of a learner of D > 1 shards."""


def _shard(num_shards: int) -> Optional[grad_sync.Shard]:
    """This thread's shard of the active learner step (None at D = 1)."""
    shard = grad_sync.reduce_axes()
    if shard is None and num_shards > 1:
        raise RuntimeError(
            f"a buffer sharded {num_shards} ways runs inside the shard "
            f"threads of a learner step (distributed/learner.py)")
    if shard is not None and shard.size != num_shards:
        raise ValueError(f"a buffer sharded {num_shards} ways inside a "
                         f"step of {shard.size} shards")
    return shard


def _gather(shard, x) -> List:
    return [x] if shard is None else shard.all_gather(x)


def _assemble(shard, rows: Dict[str, torch.Tensor], owner: torch.Tensor
              ) -> Dict[str, torch.Tensor]:
    """Each row from the shard that owns it: ``owner`` (B,) names it, the
    same on every shard; one exchange for all leaves."""
    if shard is None:
        return rows
    keys = list(rows)
    parts = shard.all_gather([rows[k] for k in keys])
    out = {}
    for i, k in enumerate(keys):
        x = parts[0][i]
        for s in range(1, len(parts)):
            mask = (owner == s).reshape((-1,) + (1,) * (x.dim() - 1))
            x = torch.where(mask, parts[s][i], x)
        out[k] = x
    return out


def _my_rows(x: torch.Tensor, rank: int, block: int) -> torch.Tensor:
    return x[rank * block:(rank + 1) * block]


def _init_shards(local, example, devices, num_shards: int) -> ShardStates:
    if devices is None:
        devices = [next(iter(example.values())).device] * num_shards
    return ShardStates(local.init({k: v.to(d) for k, v in example.items()})
                       for d in devices)


def _check_even(inner, num_shards: int) -> None:
    if inner.capacity % num_shards:
        raise ValueError(
            f"buffer capacity {inner.capacity} must divide evenly "
            f"over {num_shards} learner shards")
    if inner.batch_size % num_shards:
        raise ValueError(
            f"buffer batch_size {inner.batch_size} must divide evenly "
            f"over {num_shards} learner shards")


class ShardedUniformBuffer:
    """The uniform replay ring sharded along its slots (module
    docstring)."""

    name = "uniform"
    kind = "transitions"

    def __init__(self, inner: UniformBuffer, num_shards: int,
                 devices: Optional[Sequence] = None):
        _check_even(inner, num_shards)
        self.inner = inner
        self.num_shards = int(num_shards)
        self.devices = devices
        self.local_capacity = inner.capacity // num_shards
        self.local = UniformBuffer(self.local_capacity, inner.batch_size,
                                   inner.n_step, inner.gamma)
        self.batch_size = inner.batch_size

    def init(self, example: Dict[str, torch.Tensor]) -> ShardStates:
        return _init_shards(self.local, example, self.devices,
                            self.num_shards)

    def add(self, state: replay.ReplayState, traj) -> replay.ReplayState:
        return self.local.add(state, traj)

    def sample(self, state: replay.ReplayState, generator: torch.Generator
               ) -> Dict[str, torch.Tensor]:
        """One draw over the ``D * size`` global slots, the same on every
        shard (``replay.sample_indices``' draw, modulo ``D * size``)."""
        shard = _shard(self.num_shards)
        d, b = self.num_shards, self.batch_size
        rank = shard.rank if shard is not None else 0
        replay.ensure_nonempty(state)
        size = torch.clamp(state.size, min=1)
        bits = torch.randint(0, replay._DRAW_HIGH, (b,), generator=generator,
                             device=generator.device, dtype=torch.int64)
        draw = torch.remainder(bits, d * size)
        rows = ring_gather(state.storage,
                           torch.remainder(draw, size).to(torch.int32))
        rows = _assemble(shard, rows, torch.div(draw, size,
                                                rounding_mode="floor"))
        bl = b // d
        batch = {k: _my_rows(v, rank, bl) for k, v in rows.items()}
        batch["indices"] = _my_rows(draw, rank, bl).to(torch.int32)
        batch["weights"] = torch.ones(bl, dtype=torch.float32,
                                      device=draw.device)
        return batch

    def update_priorities(self, state, indices, priorities):
        return state


def _top_descent(totals: torch.Tensor, u: torch.Tensor):
    """The single tree's descent through its top ``log2(D)`` levels, built
    from the shard roots ``totals`` (D,) with its pairwise sums:
    ``(root, owning shard (B,), mass left for the owner's descent (B,))``
    for the stratified uniforms ``u``, as ``sumtree_find_batch_ref``
    descends (right when ``mass >= left``, subtracting ``left``)."""
    levels = [totals]
    while levels[-1].shape[0] > 1:
        x = levels[-1]
        levels.append(x[0::2] + x[1::2])
    total = levels[-1][0]
    m = u * total
    idx = torch.zeros(u.shape, dtype=torch.int64, device=u.device)
    for level in levels[-2::-1]:
        idx = idx * 2
        left = level[idx]
        go_right = m >= left
        m = torch.where(go_right, m - left, m)
        idx = torch.where(go_right, idx + 1, idx)
    return total, idx, m


class ShardedPrioritizedBuffer:
    """Per-shard sum trees whose global root is the pairwise sum of the
    shard roots (module docstring)."""

    name = "prioritized"
    kind = "transitions"

    def __init__(self, inner: PrioritizedBuffer, num_shards: int,
                 devices: Optional[Sequence] = None):
        if num_shards & (num_shards - 1):
            raise ValueError(
                f"prioritized replay shards over a power-of-two learner "
                f"count (got {num_shards}) so each shard's tree is a "
                f"complete subtree of the reference")
        _check_even(inner, num_shards)
        self.inner = inner
        self.num_shards = int(num_shards)
        self.devices = devices
        self.local_capacity = inner.capacity // num_shards
        self.local = PrioritizedBuffer(
            self.local_capacity, inner.batch_size, inner.n_step,
            inner.gamma, inner.alpha, inner.beta, inner.eps)
        self.batch_size = inner.batch_size

    def init(self, example: Dict[str, torch.Tensor]) -> ShardStates:
        return _init_shards(self.local, example, self.devices,
                            self.num_shards)

    def add(self, state: PrioritizedState, traj) -> PrioritizedState:
        # max_priority is the same on every shard (each update takes the
        # max over all shards' priorities), so new transitions enter at it
        # with no collective
        return self.local.add(state, traj)

    def sample(self, state: PrioritizedState, generator: torch.Generator
               ) -> Dict[str, torch.Tensor]:
        return self.sample_with(state, torch.rand(
            self.batch_size, generator=generator, device=generator.device))

    def sample_with(self, state: PrioritizedState, uniforms: torch.Tensor
                    ) -> Dict[str, torch.Tensor]:
        """This shard's rows of the batch for the stratified draw
        ``uniforms`` (B,), the same on every shard."""
        shard = _shard(self.num_shards)
        d, local = self.num_shards, self.local
        rank = shard.rank if shard is not None else 0
        replay.ensure_nonempty(state.ring)
        B = uniforms.shape[0]
        totals = torch.stack(_gather(shard, state.tree.total))
        # divide by a tensor, as PrioritizedBuffer.sample_with does
        u = ((torch.arange(B, dtype=torch.float32, device=uniforms.device)
              + uniforms) / torch.full((), float(B),
                                       device=uniforms.device))
        total, owner, mass = _top_descent(totals, u)
        idx = sumtree_find_batch(state.tree, mass)
        size = torch.clamp(state.ring.size, min=1)
        idx = torch.minimum(idx, size - 1)
        probs = state.tree.levels[0][idx] / torch.clamp(total, min=local.eps)
        weights = ((d * size).to(torch.float32)
                   * torch.clamp(probs, min=local.eps)) ** (-local.beta)
        rows = ring_gather(state.ring.storage, idx)
        rows["indices"] = rank * self.local_capacity + idx
        rows["weights"] = weights
        rows = _assemble(shard, rows, owner)
        w_all = rows.pop("weights")
        bl = B // d
        batch = {k: _my_rows(v, rank, bl) for k, v in rows.items()}
        batch["weights"] = _my_rows(w_all / torch.max(w_all), rank, bl)
        return batch

    def update_priorities(self, state: PrioritizedState, indices,
                          priorities) -> PrioritizedState:
        """Every shard's ``(index, priority)`` rows, each written by the
        shard that owns its leaf."""
        shard = _shard(self.num_shards)
        local, cap = self.local, self.local_capacity
        rank = shard.rank if shard is not None else 0
        idx_all = torch.cat(_gather(shard, indices))
        p = torch.abs(torch.cat(_gather(shard, priorities))) + local.eps
        owned = torch.div(idx_all, cap, rounding_mode="floor") == rank
        # sumtree_update_masked through the update kernel: a row another
        # shard owns gets index ``cap``, which the update drops
        tree = sumtree_update(state.tree,
                              torch.where(owned, idx_all % cap, cap),
                              p ** local.alpha)
        return PrioritizedState(state.ring, tree,
                                torch.maximum(state.max_priority,
                                              torch.max(p)))


def shard_buffer(buffer, num_shards: int,
                 devices: Optional[Sequence] = None):
    """Wrap a transitions buffer for a learner of ``num_shards`` shards on
    ``devices`` (a trajectory buffer is split with the trajectory and is
    returned unchanged)."""
    if getattr(buffer, "kind", None) != "transitions":
        return buffer
    if isinstance(buffer, PrioritizedBuffer):
        return ShardedPrioritizedBuffer(buffer, num_shards, devices)
    if isinstance(buffer, UniformBuffer):
        return ShardedUniformBuffer(buffer, num_shards, devices)
    raise ValueError(
        f"no sharded form for buffer {getattr(buffer, 'name', buffer)!r}")
