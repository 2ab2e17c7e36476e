"""Adam, written out by hand (port of ``repro/optim/adam.py``).

The moments are plain lists in the order of the parameters; the update
follows the reference's expression order (``adam.py`` ``update``), so one
step from identical params and grads matches it to float32 rounding. Not
``torch.optim.Adam``, whose expression order differs.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, List, NamedTuple, Sequence, Tuple

import numpy as np
import torch


class AdamState(NamedTuple):
    step: int
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
        return AdamState(0, [torch.zeros_like(p) for p in params],
                         [torch.zeros_like(p) for p in params])

    def update(grads, state, params):
        step = state.step + 1
        # the reference computes the bias corrections on float32 scalars
        t = np.float32(step)
        bc1 = float(np.float32(1.0) - np.float32(b1) ** t)
        bc2 = float(np.float32(1.0) - np.float32(b2) ** t)
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
