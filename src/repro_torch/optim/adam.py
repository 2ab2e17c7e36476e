"""Adam / AdamW, written out by hand (port of ``repro/optim/adam.py``).

The moments are plain lists in the order of the parameters; the update
follows the reference's expression order (``adam.py`` ``update``), so one
step from identical params and grads matches it to float32 rounding. Not
``torch.optim.Adam``, whose expression order differs.

``AdamState.step`` is a 0-dim int32 tensor on the params' device, as the
reference's is an array, and the bias corrections (and a schedule's rate)
are computed from it on that device. So an update reads nothing on the
host, and one captured in a CUDA graph (``core/fused.py``) computes what the
eager one does, bit for bit.

The reference's options: ``lr`` a float or a schedule (``optim/schedules.py``:
the step in, a 0-dim float32 rate out), decoupled ``weight_decay``
(``delta + wd * p``), and ``moment_dtype``, which stores the moments in that
dtype (bfloat16 for the LM trainer) while the math runs in float32; each
update is cast to its parameter's dtype. On float32 tensors with a float
``lr`` and no decay every cast is the identity, so that path computes what
it did before the options came.
"""
from __future__ import annotations

import dataclasses
from typing import (Any, Callable, List, NamedTuple, Optional, Sequence,
                    Tuple, Union)

import torch

from repro_torch.distributed import grad_sync

Schedule = Union[float, Callable[[torch.Tensor], torch.Tensor]]


class AdamState(NamedTuple):
    step: torch.Tensor               # 0-dim int32, on the params' device
    mu: List[torch.Tensor]
    nu: List[torch.Tensor]


@dataclasses.dataclass(frozen=True)
class Optimizer:
    """``init(params) -> state`` and ``update(grads, state, params) ->
    (updates, state')`` (``adam``'s ``AdamState``, ``sgd``'s
    ``SgdState``)."""
    init: Callable[[Sequence[torch.Tensor]], Any]
    update: Callable[..., Tuple[List[torch.Tensor], Any]]


def adam(lr: Schedule, b1: float = 0.9, b2: float = 0.999,
         eps: float = 1e-8, weight_decay: float = 0.0,
         moment_dtype: Optional[str] = None) -> Optimizer:
    """AdamW over a list of tensors: ``update(grads, state, params) ->
    (updates, state')``. Moments stored in ``moment_dtype`` (a torch dtype
    name such as ``"bfloat16"``; default: each param's dtype)."""

    def init(params):
        def zeros_like(p):
            dt = getattr(torch, moment_dtype) if moment_dtype else p.dtype
            return torch.zeros(p.shape, dtype=dt, device=p.device)
        return AdamState(
            torch.zeros((), dtype=torch.int32, device=params[0].device),
            [zeros_like(p) for p in params],
            [zeros_like(p) for p in params])

    def update(grads, state, params):
        step = state.step + 1
        lr_t = lr(step) if callable(lr) else lr
        # float32 powers of the betas on the device, as the reference's
        # ``b1 ** t``; dividing by these 0-dim tensors is a true division
        t = step.to(torch.float32)
        bc1 = 1.0 - torch.pow(torch.full_like(t, b1), t)
        bc2 = 1.0 - torch.pow(torch.full_like(t, b2), t)
        updates, mu, nu = [], [], []
        for g, m, v, p in zip(grads, state.mu, state.nu, params):
            gf = g.float()
            m2 = b1 * m.float() + (1 - b1) * gf
            v2 = b2 * v.float() + (1 - b2) * gf * gf
            delta = (m2 / bc1) / (torch.sqrt(v2 / bc2) + eps)
            if weight_decay:
                pf = (grad_sync.localize_like(p.detach(), g)
                      if grad_sync.fsdp_active() else p.detach())
                delta = delta + weight_decay * pf.float()
            updates.append((-lr_t * delta).to(p.dtype))
            mu.append(m2.to(m.dtype))
            nu.append(v2.to(v.dtype))
        return updates, AdamState(step, mu, nu)

    return Optimizer(init=init, update=update)


def apply_updates(params: Sequence[torch.Tensor],
                  updates: Sequence[torch.Tensor]) -> None:
    """``p <- p + u`` for each parameter, in place, the update cast to the
    parameter's dtype; under FSDP each update slice is all-gathered to its
    parameter's full shape first."""
    if grad_sync.fsdp_active() is not None:
        updates = grad_sync.expand_like(list(updates), list(params))
    with torch.no_grad():
        for p, u in zip(params, updates):
            p.add_(u.to(p.dtype))
