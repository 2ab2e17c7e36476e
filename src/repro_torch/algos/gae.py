"""Generalised advantage estimation, the learner-facing entry point (port of
``repro/algos/gae.py``, single-device branch). The recurrence is the
``gae`` op of the kernel plane (``kernels/gae``), which also holds the
re-exported ``discounted_returns``."""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels.gae import discounted_returns  # noqa: F401
from repro_torch.kernels.gae import gae as _gae_op


def gae(rewards: torch.Tensor, values: torch.Tensor, dones: torch.Tensor,
        last_value: torch.Tensor, gamma: float = 0.99, lam: float = 0.95,
        *, impl: Optional[str] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Advantages + returns; rewards/values/dones (T, ...) time-major,
    last_value (...) the bootstrap. ``dones[t]`` ends the episode at t."""
    return _gae_op(rewards, values, dones, last_value, gamma, lam, impl=impl)


def normalize(adv: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    """Standardise advantages over the whole batch (population std, as
    ``jnp.std``)."""
    return (adv - torch.mean(adv)) / (torch.std(adv, correction=0) + eps)
