"""Plain PyTorch versions of the GAE family (port of
``repro/kernels/gae/ref.py``): ``gae_ref`` and ``discounted_returns_ref``,
each a reverse scan as a Python loop, with the reference's expressions in
the reference's order. ``gamma * lam`` folds in double before it meets a
tensor, as in the reference."""
from __future__ import annotations

from typing import Tuple

import torch


def gae_ref(rewards: torch.Tensor, values: torch.Tensor, dones: torch.Tensor,
            last_value: torch.Tensor, gamma: float = 0.99, lam: float = 0.95
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Advantages + returns.

    rewards/values/dones: (T, ...) time-major; last_value: (...) bootstrap.
    ``dones[t]`` marks that the episode ended *at* step t (no bootstrap
    across the boundary). Returns (advantages, returns), both (T, ...).
    """
    nonterm = 1.0 - dones.to(torch.float32)
    adv_next, v_next = torch.zeros_like(last_value), last_value
    advs = [None] * rewards.shape[0]
    for t in reversed(range(rewards.shape[0])):
        r, v, nt = rewards[t], values[t], nonterm[t]
        delta = r + gamma * v_next * nt - v
        adv = delta + gamma * lam * nt * adv_next
        advs[t] = adv
        adv_next, v_next = adv, v
    advs = torch.stack(advs)
    return advs, advs + values


def discounted_returns_ref(rewards: torch.Tensor, dones: torch.Tensor,
                           last_value: torch.Tensor, gamma: float = 0.99
                           ) -> torch.Tensor:
    """Discounted returns-to-go: ``R_t = r_t + gamma * nt_t * R_{t+1}``,
    bootstrapped from ``last_value``. Shapes as ``gae_ref``; ``T = 0``
    gives an empty result."""
    nonterm = 1.0 - dones.to(torch.float32)
    carry = last_value
    rets = [None] * rewards.shape[0]
    for t in reversed(range(rewards.shape[0])):
        carry = rewards[t] + gamma * nonterm[t] * carry
        rets[t] = carry
    return torch.stack(rets) if rets else torch.empty_like(rewards)
