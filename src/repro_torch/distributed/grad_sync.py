"""Gradient synchronisation, microbatch accumulation and FSDP (port of
``repro/distributed/grad_sync.py``).

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

FSDP (the reference's DESIGN.md §11): when the learner activates the
context with an ``FsdpInfo``, params and Adam moments are stored sharded
along the fsdp axes, and

* ``gather_params`` all-gathers each sharded leaf of a shard's params to
  full at the step's entry (an exchange, concatenated in shard order
  along the leaf's storage dim), so the algorithm sees full params;
* ``value_and_grad`` reduce-scatters the gradient of every sharded leaf:
  the shard-order sum divided by D that ``pmean`` takes, of this shard's
  slice only, so each shard ends the loss holding its slice of the mean
  gradient, bit for bit the slice of the replicated schedule's;
* the moments update on those slices (``optim/adam.py``, weight decay
  through ``localize_like``); ``apply_updates`` all-gathers the update
  slices back to full (``expand_like``), and ``fsdp_sumsq`` feeds the
  clip's global norm;
* ``shard_params`` slices the params back to storage at the step's exit.

Which leaves are sharded is decided on the host from full shapes
(``learner.ShardedLearner.fsdp_layout``) and carried as tables keyed by
``(the reference's leaf name, shape)``; a port parameter's reference name
comes from ``sharding.reference_leaf``, and the gradients
``value_and_grad`` returns under FSDP carry their names
(``NamedLeaves``), as the reference's pytree paths do.

The context is thread-local: each shard's thread enters its own.
"""
from __future__ import annotations

import contextlib
import threading
from typing import Any, Dict, List, NamedTuple, Optional, Sequence, Tuple

import torch

from repro_torch.distributed.sharding import reference_leaf

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

    def gather_cat(self, xs: Sequence[torch.Tensor], dims: Sequence[int]
                   ) -> List[torch.Tensor]:
        """The all-gather of FSDP: each ``xs[i]`` (this shard's slice) with
        every other shard's, concatenated in shard order along
        ``dims[i]``, on this device. One exchange for all leaves."""
        parts = self.group.exchange(self.rank, list(xs))
        return [torch.cat([p[i].to(self.device) for p in parts], dim=d)
                for i, d in enumerate(dims)]

    def reduce_mean(self, xs: Sequence[torch.Tensor],
                    dims: Sequence[Optional[int]]) -> List[torch.Tensor]:
        """The mean over shards of each ``xs[i]``: whole where ``dims[i]``
        is None (``pmean``), else only this shard's slice along
        ``dims[i]`` (the reduce-scatter). Either is added in shard order
        and divided by the shard count, so a slice has the bits of the
        same elements of ``pmean``. One exchange for all leaves."""
        parts = self.group.exchange(self.rank, list(xs))
        out = []
        for i, d in enumerate(dims):
            if d is None:
                pieces = [p[i] for p in parts]
            else:
                n = xs[i].shape[d] // self.size
                pieces = [p[i].narrow(d, self.rank * n, n) for p in parts]
            acc = pieces[0].to(self.device)
            for x in pieces[1:]:
                acc = acc + x.to(self.device)
            out.append(acc / self.size)
        return out


def _to(value, device):
    if isinstance(value, torch.Tensor):
        return value.to(device)
    return [v.to(device) for v in value]


class FsdpInfo(NamedTuple):
    """The FSDP storage layout of one learner, decided on the host.

    Keys are ``(the reference's leaf name, shape)`` with shapes in the
    port's layout; values are the port's storage dim. The learner checks
    that no replicated leaf's key equals a sharded leaf's local key
    (``ShardedLearner.fsdp_layout``), so each table is unambiguous."""
    size: int                                   # product of axis sizes
    full_table: Dict[Tuple[str, tuple], int]    # (name, full shape) -> dim
    local_table: Dict[Tuple[str, tuple], int]   # (name, local shape) -> dim


class NamedLeaves(tuple):
    """A tuple of tensors with the reference's leaf name of each, as a
    pytree's paths carry them: the gradients ``value_and_grad`` returns
    under FSDP, which ``fsdp_sumsq`` reads."""

    def __new__(cls, leaves, names):
        obj = super().__new__(cls, leaves)
        obj.names = tuple(names)
        return obj


class _GradSyncCtx(NamedTuple):
    shard: Optional[Shard]            # the collectives (None: one shard)
    microbatches: int                 # M accumulation steps (1: off)
    fsdp: Optional[FsdpInfo] = None   # sharded param storage (None: off)


_local = threading.local()


@contextlib.contextmanager
def activate(shard: Optional[Shard], microbatches: int = 1,
             fsdp: Optional[FsdpInfo] = None):
    """Enter the sync context for this thread, for one train step."""
    prev = active()
    shard = shard if shard is not None and shard.size > 1 else None
    _local.ctx = _GradSyncCtx(shard, max(1, int(microbatches)),
                              fsdp if shard is not None else None)
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


def fsdp_active() -> Optional[FsdpInfo]:
    """The active FSDP layout, or None (the replicated schedule, or no
    step)."""
    ctx = active()
    return ctx.fsdp if ctx is not None else None


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


# ------------------------------------------------------- FSDP reshaping
def _named(params) -> Tuple[List[str], List[torch.Tensor]]:
    """The reference's leaf name of each tensor of ``params`` (a module, in
    ``parameters()`` order, or ``NamedLeaves``), and the tensors; a plain
    sequence has no names ("")."""
    if isinstance(params, torch.nn.Module):
        named = list(params.named_parameters())
        return ([reference_leaf(n, p.shape)[0][-1] for n, p in named],
                [p for _, p in named])
    tensors = list(params)
    names = getattr(params, "names", None) or [""] * len(tensors)
    return list(names), tensors


def _this_shard() -> Shard:
    """This thread's shard of the active step."""
    return active().shard


def gather_params(params):
    """Entry all-gather, in place: every sharded leaf of ``params`` (a
    module in storage layout: each sharded leaf holds this shard's slice)
    becomes the full leaf, in one exchange. Replicated leaves pass through.
    A no-op outside FSDP. Returns ``params``."""
    f = fsdp_active()
    if f is None:
        return params
    names, tensors = _named(params)
    picked = [(p, f.local_table.get((n, tuple(p.shape))))
              for n, p in zip(names, tensors)]
    picked = [(p, d) for p, d in picked if d is not None]
    if picked:
        full = _this_shard().gather_cat([p.detach() for p, _ in picked],
                                       [d for _, d in picked])
        for (p, _), x in zip(picked, full):
            p.data = x
    return params


def shard_params(params):
    """Exit slice, in place: every sharded leaf of ``params`` (full)
    keeps only this shard's slice, copied so the full leaf can be freed
    (no collective). A no-op outside FSDP. Returns ``params``."""
    f = fsdp_active()
    if f is None:
        return params
    rank = _this_shard().rank
    names, tensors = _named(params)
    for n, p in zip(names, tensors):
        d = f.full_table.get((n, tuple(p.shape)))
        if d is not None:
            local = p.shape[d] // f.size
            p.data = p.data.narrow(d, rank * local, local).clone()
    return params


def _fsdp_dim(small, big, size: int, what: str) -> int:
    dims = [d for d in range(len(big)) if small[d] != big[d]]
    if (len(small) != len(big) or len(dims) != 1
            or small[dims[0]] * size != big[dims[0]]):
        raise ValueError(f"{what}: {tuple(small)} is not a {size}-way fsdp "
                         f"slice of {tuple(big)}")
    return dims[0]


def expand_like(u, p):
    """All-gather storage-layout leaves up to full shape: ``u`` and ``p``
    are tensors, or sequences of them (one exchange for all); a leaf of
    ``u`` whose shape differs from its ``p`` in one dim, by the shard
    count, is gathered along it. No-op outside FSDP and on equal
    shapes."""
    f = fsdp_active()
    single = isinstance(u, torch.Tensor)
    us, ps = ([u], [p]) if single else (list(u), list(p))
    if f is not None:
        idx = [i for i, (a, b) in enumerate(zip(us, ps))
               if a.shape != b.shape]
        if idx:
            dims = [_fsdp_dim(us[i].shape, ps[i].shape, f.size,
                              "expand_like") for i in idx]
            full = _this_shard().gather_cat([us[i] for i in idx], dims)
            for i, x in zip(idx, full):
                us[i] = x
    return us[0] if single else us


def localize_like(p, g):
    """Slice a full leaf ``p`` down to ``g``'s storage-layout shape, this
    shard's slice (the inverse of ``expand_like``, e.g. weight decay's
    param term next to a scattered gradient). No-op outside FSDP or on
    equal shapes."""
    f = fsdp_active()
    if f is None or p.shape == g.shape:
        return p
    d = _fsdp_dim(g.shape, p.shape, f.size, "localize_like")
    n = g.shape[d]
    return p.narrow(d, _this_shard().rank * n, n)


def fsdp_sumsq(tensors):
    """The global sum of squares of a mixed-layout gradient list (float32):
    replicated leaves are equal on every shard, so their square sums add
    locally; sharded leaves each hold a disjoint slice, so their square
    sums are added across the shards (``psum``, in shard order). Needs the
    leaves' names (``NamedLeaves``, as ``value_and_grad`` returns
    them)."""
    f = fsdp_active()
    names = getattr(tensors, "names", None)
    if names is None:
        raise ValueError(
            "fsdp_sumsq needs the gradients' leaf names: pass the "
            "NamedLeaves that grad_sync.value_and_grad returns")
    repl, shard = [], []
    for n, x in zip(names, tensors):
        s = torch.sum(torch.square(x.float()))
        (shard if f.local_table.get((n, tuple(x.shape))) is not None
         else repl).append(s)
    total = sum(repl) if repl else torch.zeros((), device=tensors[0].device)
    if shard:
        total = total + _this_shard().psum(sum(shard))
    return total


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
    returned loss and the averaged aux are detached. Under FSDP the
    gradient of every sharded leaf comes back reduce-scattered (this
    shard's slice of the mean) and replicated leaves whole, as
    ``NamedLeaves``."""
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
        if ctx.fsdp is not None:
            # mean over shards, landed in storage layout: each sharded
            # leaf's slice (the reduce-scatter), the rest whole
            names, _ = _named(params)
            dims = [ctx.fsdp.full_table.get((n, tuple(g.shape)))
                    for n, g in zip(names, grads)]
            grads = NamedLeaves(ctx.shard.reduce_mean(grads, dims), names)
        else:
            grads = ctx.shard.pmean(tuple(grads))
    return out, grads
