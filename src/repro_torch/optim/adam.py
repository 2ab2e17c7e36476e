"""Adam, written out by hand (port of ``repro/optim/adam.py``).

The moments are plain lists in the order of the parameters; the update
follows the reference's expression order (``adam.py`` ``update``), so one
step from identical params and grads matches it to float32 rounding. Not
``torch.optim.Adam``, whose expression order differs.

``AdamState.step`` is a 0-dim int32 tensor on the params' device, as the
reference's is an array, and the bias corrections are computed from it on
that device. So an update reads nothing on the host, and one captured in a
CUDA graph (``core/fused.py``) computes what the eager one does, bit for
bit.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, List, NamedTuple, Sequence, Tuple

import torch


class AdamState(NamedTuple):
    step: torch.Tensor               # 0-dim int32, on the params' device
    mu: List[torch.Tensor]
    nu: List[torch.Tensor]


@dataclasses.dataclass(frozen=True)
class Optimizer:
    init: Callable[[Sequence[torch.Tensor]], AdamState]
    update: Callable[..., Tuple[List[torch.Tensor], AdamState]]


def adam(lr: float, b1: float = 0.9, b2: float = 0.999,
         eps: float = 1e-8) -> Optimizer:
    """Adam over a list of float32 tensors: ``update(grads, state, params)
    -> (updates, state')``."""

    def init(params):
        return AdamState(
            torch.zeros((), dtype=torch.int32, device=params[0].device),
            [torch.zeros_like(p) for p in params],
            [torch.zeros_like(p) for p in params])

    def update(grads, state, params):
        step = state.step + 1
        # float32 powers of the betas on the device, as the reference's
        # ``b1 ** t``; dividing by these 0-dim tensors is a true division
        t = step.to(torch.float32)
        bc1 = 1.0 - torch.pow(torch.full_like(t, b1), t)
        bc2 = 1.0 - torch.pow(torch.full_like(t, b2), t)
        updates, mu, nu = [], [], []
        for g, m, v in zip(grads, state.mu, state.nu):
            m2 = b1 * m + (1 - b1) * g
            v2 = b2 * v + (1 - b2) * g * g
            delta = (m2 / bc1) / (torch.sqrt(v2 / bc2) + eps)
            updates.append(-lr * delta)
            mu.append(m2)
            nu.append(v2)
        return updates, AdamState(step, mu, nu)

    return Optimizer(init=init, update=update)


def apply_updates(params: Sequence[torch.Tensor],
                  updates: Sequence[torch.Tensor]) -> None:
    """``p <- p + u`` for each parameter, in place."""
    with torch.no_grad():
        for p, u in zip(params, updates):
            p.add_(u)
