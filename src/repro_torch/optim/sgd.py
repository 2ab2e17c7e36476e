"""SGD with optional momentum (port of ``repro/optim/sgd.py``).

Over a list of float32 tensors, as ``adam``: ``update(grads, state, params)
-> (updates, state')``. ``lr`` is a float or a schedule
(``optim/schedules.py``), evaluated at the new step on the params' device.
"""
from __future__ import annotations

from typing import Callable, List, NamedTuple, Optional, Union

import torch

from repro_torch.optim.adam import Optimizer

Schedule = Union[float, Callable[[torch.Tensor], torch.Tensor]]


class SgdState(NamedTuple):
    step: torch.Tensor                       # 0-dim int32, on the device
    velocity: Optional[List[torch.Tensor]]   # None without momentum


def _lr_at(lr: Schedule, step: torch.Tensor) -> torch.Tensor:
    """The rate at ``step``: the schedule's, or the float as a float32
    0-dim tensor on ``step``'s device (the reference's ``_lr_at``)."""
    if callable(lr):
        return lr(step)
    return torch.full((), lr, dtype=torch.float32, device=step.device)


def sgd(lr: Schedule, momentum: float = 0.0) -> Optimizer:
    def init(params):
        vel = [torch.zeros_like(p) for p in params] if momentum else None
        return SgdState(torch.zeros((), dtype=torch.int32,
                                    device=params[0].device), vel)

    def update(grads, state, params):
        del params
        step = state.step + 1
        lr_t = _lr_at(lr, step)
        if momentum:
            vel = [momentum * v + g for v, g in zip(state.velocity, grads)]
            return [-lr_t * v for v in vel], SgdState(step, vel)
        return [-lr_t * g for g in grads], SgdState(step, None)

    return Optimizer(init=init, update=update)
