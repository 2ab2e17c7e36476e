"""Generalised advantage estimation, the learner-facing entry point (port of
``repro/algos/gae.py``). The recurrence is the ``gae`` op of the kernel
plane (``kernels/gae``), which also holds the re-exported
``discounted_returns``. ``normalize`` takes the global batch's
statistics inside a sharded learner step (``distributed/grad_sync.py``)."""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.distributed import grad_sync
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
    ``jnp.std``).

    Inside a learner step of D > 1 shards (``grad_sync.activate``) each
    shard holds a slice of the batch, so the mean and the variance are
    averaged across shards: every shard normalises by the global
    statistics. Outside one this is the plain expression, bit for bit."""
    shard = grad_sync.reduce_axes()
    if shard is None:
        return (adv - torch.mean(adv)) / (torch.std(adv, correction=0) + eps)
    m = shard.pmean(torch.mean(adv))
    var = shard.pmean(torch.mean((adv - m) ** 2))
    return (adv - m) / (torch.sqrt(var) + eps)
