"""Functional env wrappers: observation/reward normalisation (port of
``repro/envs/wrappers.py``).

The running statistics are a ``RunningNorm`` of tensors carried explicitly
by the caller, so the wrappers stay pure: each sampler can keep its own,
and ``merge_norm_states`` combines two (Chan et al.'s parallel variance)
when the learner wants global normalisation. The expressions are the
reference's, in its order.
"""
from __future__ import annotations

from typing import NamedTuple

import torch


class RunningNorm(NamedTuple):
    mean: torch.Tensor       # (dim,)
    var: torch.Tensor        # (dim,), population variance
    count: torch.Tensor      # 0-dim float32


def init_norm(dim: int, device=None) -> RunningNorm:
    return RunningNorm(torch.zeros(dim, device=device),
                       torch.ones(dim, device=device),
                       torch.zeros((), device=device))


def update_norm(state: RunningNorm, batch: torch.Tensor) -> RunningNorm:
    """Welford batch update. batch (N, dim)."""
    b_mean = torch.mean(batch, dim=0)
    b_var = torch.var(batch, dim=0, correction=0)
    b_count = batch.shape[0]
    delta = b_mean - state.mean
    tot = state.count + b_count
    mean = state.mean + delta * b_count / tot
    m_a = state.var * state.count
    m_b = b_var * b_count
    m2 = m_a + m_b + delta ** 2 * state.count * b_count / tot
    return RunningNorm(mean, m2 / tot, tot)


def merge_norm_states(a: RunningNorm, b: RunningNorm) -> RunningNorm:
    """Combine two shards' statistics (parallel variance)."""
    delta = b.mean - a.mean
    tot = a.count + b.count
    mean = a.mean + delta * b.count / tot
    m2 = (a.var * a.count + b.var * b.count
          + delta ** 2 * a.count * b.count / tot)
    return RunningNorm(mean, m2 / tot, tot)


def normalize_obs(state: RunningNorm, obs: torch.Tensor,
                  clip: float = 10.0) -> torch.Tensor:
    return torch.clamp((obs - state.mean) / torch.sqrt(state.var + 1e-8),
                       -clip, clip)
