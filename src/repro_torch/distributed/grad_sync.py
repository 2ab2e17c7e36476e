"""Gradient synchronisation and microbatch accumulation (port of
``repro/distributed/grad_sync.py``, its replicated schedule).

Every algorithm update routes its gradients through ``value_and_grad``
below instead of calling ``torch.autograd.grad`` directly. Outside a
context the call is exactly ``loss_fn(params, batch)`` then
``torch.autograd.grad`` (bit for bit: the D = 1 guarantee). Inside one
(``activate``, entered by ``learner.ShardedLearner``) it

* optionally splits the batch into M microbatches and takes the mean of
  their gradients (gradient accumulation), and
* takes the mean of each gradient across the D shards of the step, the
  reference's one ``pmean`` per loss.

The shards run in threads of one process (``learner.py``), so the
reference's mesh axes become a ``Shard``: this thread's member of a
``ShardGroup``, whose collectives are barrier-synchronised reductions
taken in shard order. Each shard therefore computes the same mean, the
clip and the optimizer update are recomputed identically per shard, and
the replicas stay equal without a broadcast.

The context is thread-local: each shard's thread enters its own. FSDP
(the reference's ``FsdpInfo``, ``gather_params``, ``shard_params``,
``expand_like``, ``localize_like`` and ``fsdp_sumsq``) is not ported; it
is ROADMAP.md item 10d.
"""
from __future__ import annotations

import contextlib
import threading
from typing import Any, List, NamedTuple, Optional, Sequence

import torch

# a collective's wait; a shard that is this late is taken to have failed
DEFAULT_TIMEOUT_S = 600.0


class ShardGroup:
    """The D shards of one learner step, each a thread on ``devices[s]``.

    A collective is an exchange: every shard posts its value, waits at the
    barrier, reads all D values, and waits again before the slots are
    reused. ``abort`` breaks the barrier, so a shard that fails ends the
    others' waits (``threading.BrokenBarrierError``) instead of leaving
    them blocked; a wait longer than ``timeout`` seconds breaks it too."""

    def __init__(self, devices: Sequence, timeout: float = DEFAULT_TIMEOUT_S):
        self.devices = [torch.device(d) for d in devices]
        self.size = len(self.devices)
        self._barrier = threading.Barrier(self.size, timeout=timeout)
        self._slots: List[Any] = [None] * self.size

    def member(self, rank: int) -> "Shard":
        return Shard(self, rank)

    def abort(self) -> None:
        self._barrier.abort()

    def exchange(self, rank: int, value: Any) -> List[Any]:
        """Every shard's ``value``, in shard order."""
        self._slots[rank] = value
        self._barrier.wait()
        out = list(self._slots)
        self._barrier.wait()
        return out


class Shard:
    """One shard's view of its group: the collectives of the reference's
    ``lax.pmean``/``psum`` over the learner mesh, on this shard's device.
    ``x`` is a tensor or a sequence of tensors (one exchange for all)."""

    def __init__(self, group: ShardGroup, rank: int):
        self.group = group
        self.rank = rank
        self.size = group.size
        self.device = group.devices[rank]

    def all_gather(self, x):
        """Every shard's ``x``, in shard order, moved to this device."""
        return [_to(v, self.device) for v in self.group.exchange(self.rank,
                                                                 x)]

    def psum(self, x):
        """The sum over shards, added in shard order, so every shard gets
        the same bits."""
        parts = self.all_gather(x)
        if isinstance(x, torch.Tensor):
            acc = parts[0]
            for p in parts[1:]:
                acc = acc + p
            return acc
        acc = list(parts[0])
        for p in parts[1:]:
            acc = [a + b for a, b in zip(acc, p)]
        return type(x)(acc) if isinstance(x, tuple) else acc

    def pmean(self, x):
        s = self.psum(x)
        if isinstance(x, torch.Tensor):
            return s / self.size
        out = [t / self.size for t in s]
        return type(x)(out) if isinstance(x, tuple) else out


def _to(value, device):
    if isinstance(value, torch.Tensor):
        return value.to(device)
    return [v.to(device) for v in value]


class _GradSyncCtx(NamedTuple):
    shard: Optional[Shard]            # the collectives (None: one shard)
    microbatches: int                 # M accumulation steps (1: off)


_local = threading.local()


@contextlib.contextmanager
def activate(shard: Optional[Shard], microbatches: int = 1):
    """Enter the sync context for this thread, for one train step."""
    prev = active()
    _local.ctx = _GradSyncCtx(
        shard if shard is not None and shard.size > 1 else None,
        max(1, int(microbatches)))
    try:
        yield _local.ctx
    finally:
        _local.ctx = prev


def active() -> Optional[_GradSyncCtx]:
    return getattr(_local, "ctx", None)


def reduce_axes() -> Optional[Shard]:
    """What the current step must reduce batch statistics over (e.g.
    advantage normalisation): this thread's ``Shard``, or None outside a
    step of D > 1 shards. The reference returns its mesh axes."""
    ctx = active()
    return ctx.shard if ctx is not None else None


def pmean(x):
    """The mean of ``x`` (a tensor or a sequence of tensors) across the
    active shards; ``x`` itself outside a step of D > 1 shards."""
    shard = reduce_axes()
    return x if shard is None else shard.pmean(x)


def sync(grads):
    """``pmean`` a gradient list across the active shards (a no-op
    otherwise), for gradients computed outside ``value_and_grad``, such as
    SAC's temperature gradient."""
    return pmean(grads)


def _slice_batch(batch, lo: int, hi: int, n: int):
    """Rows ``lo:hi`` of every leaf with the batch's leading dim ``n``;
    any other leaf (a scalar, a generator) whole."""
    def one(x):
        if isinstance(x, torch.Tensor) and x.dim() and x.shape[0] == n:
            return x[lo:hi]
        return x
    if isinstance(batch, dict):
        return {k: one(v) for k, v in batch.items()}
    return type(batch)(one(v) for v in batch)


def _leaves(tree) -> List[Any]:
    if isinstance(tree, dict):
        return list(tree.values())
    if isinstance(tree, (list, tuple)):
        return list(tree)
    return [tree]


def _combine_aux(parts: List[Any], mb: int):
    """Fold the M microbatches' aux back to the full batch's layout:
    per-sample leaves (leading dim ``mb``, e.g. TD errors feeding
    priorities) are concatenated, anything else (per-microbatch scalars,
    e.g. loss terms) is averaged."""
    first = parts[0]
    if isinstance(first, torch.Tensor):
        if first.dim() >= 1 and first.shape[0] == mb:
            return torch.cat(parts, dim=0)
        return torch.mean(torch.stack(parts), dim=0)
    if isinstance(first, dict):
        return {k: _combine_aux([p[k] for p in parts], mb) for k in first}
    if isinstance(first, (list, tuple)):
        out = [_combine_aux([p[i] for p in parts], mb)
               for i in range(len(first))]
        return type(first)(out) if isinstance(first, tuple) else out
    return first


def value_and_grad(loss_fn, params, batch, has_aux: bool = False):
    """``(out, grads)``: ``out = loss_fn(params, batch)`` (``(loss, aux)``
    with ``has_aux``) and the gradient of the loss with respect to
    ``params`` (a module's parameters, in order, or a sequence of
    tensors), routed through the active context.

    ``loss_fn`` must mean-reduce its loss over the batch's leading dim, so
    that microbatch and shard means compose exactly. Under M > 1 the
    returned loss and the averaged aux are detached."""
    wrt = (list(params.parameters()) if isinstance(params, torch.nn.Module)
           else list(params))
    ctx = active()
    m = ctx.microbatches if ctx is not None else 1
    if m <= 1:
        out = loss_fn(params, batch)
        loss = out[0] if has_aux else out
        grads = torch.autograd.grad(loss, wrt)
    else:
        n = max(x.shape[0] for x in _leaves(batch)
                if isinstance(x, torch.Tensor) and x.dim())
        if n % m:
            raise ValueError(
                f"microbatch accumulation needs the per-shard batch ({n}) "
                f"divisible by learner_microbatches ({m})")
        mb = n // m
        losses, auxes, per_slice = [], [], []
        for i in range(m):
            o = loss_fn(params, _slice_batch(batch, i * mb, (i + 1) * mb, n))
            loss = o[0] if has_aux else o
            per_slice.append(torch.autograd.grad(loss, wrt))
            losses.append(loss.detach())
            if has_aux:
                auxes.append(o[1])
        grads = tuple(torch.mean(torch.stack(g), dim=0)
                      for g in zip(*per_slice))
        loss = torch.mean(torch.stack(losses))
        out = (loss, _combine_aux(auxes, mb)) if has_aux else loss
    if ctx is not None and ctx.shard is not None:
        grads = ctx.shard.pmean(tuple(grads))
    return out, grads
