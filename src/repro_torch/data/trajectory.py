"""On-policy trajectory containers (port of ``repro/data/trajectory.py``).

A trajectory is a dict of time-major tensors ``(T, B, ...)`` from one
sampler rollout, plus ``last_value`` ``(B,)``.
"""
from __future__ import annotations

from typing import Dict, List

import torch

def merge(trajs: List[Dict[str, torch.Tensor]]) -> Dict[str, torch.Tensor]:
    """Concatenate sampler outputs along the batch axis (dim 1 of the step
    keys, dim 0 of ``last_value``)."""
    return {k: torch.cat([t[k] for t in trajs],
                         dim=0 if k == "last_value" else 1)
            for k in trajs[0]}


def num_samples(traj: Dict[str, torch.Tensor]) -> int:
    T, B = traj["rewards"].shape[:2]
    return T * B


def episode_returns(traj: Dict[str, torch.Tensor]) -> torch.Tensor:
    """Mean undiscounted return of episodes *completed* inside the batch."""
    rew, dones = traj["rewards"], traj["dones"].to(torch.bool)
    acc = torch.zeros_like(rew[0])
    total = torch.zeros_like(rew[0])
    count = torch.zeros(rew.shape[1], dtype=torch.int64, device=rew.device)
    for r, d in zip(rew, dones):
        acc = acc + r
        total = torch.where(d, total + acc, total)
        count = count + d
        acc = torch.where(d, torch.zeros_like(acc), acc)
    return torch.sum(total) / torch.clamp(torch.sum(count), min=1)
