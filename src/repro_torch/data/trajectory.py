"""On-policy trajectory containers (port of ``repro/data/trajectory.py``).

A trajectory is a dict of time-major tensors ``(T, B, ...)`` from one
sampler rollout, plus ``last_value`` ``(B,)``.
"""
from __future__ import annotations

from typing import Dict, List

import torch

REQUIRED_KEYS = ("obs", "actions", "rewards", "dones", "logp", "values")


def validate(traj: Dict[str, torch.Tensor]) -> None:
    """Every key of ``REQUIRED_KEYS`` is present (``KeyError``) and leads
    with the rewards' ``(T, B)`` (``ValueError``)."""
    for k in REQUIRED_KEYS:
        if k not in traj:
            raise KeyError(f"trajectory missing key {k!r}")
    T, B = traj["rewards"].shape[:2]
    for k in REQUIRED_KEYS:
        if tuple(traj[k].shape[:2]) != (T, B):
            raise ValueError(
                f"{k} has shape {tuple(traj[k].shape)}, expected leading "
                f"({T},{B})")


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
    """Mean undiscounted return of episodes *completed* inside the batch.

    The sums run in the rewards' dtype and the episode count is cast to it
    before the division, as JAX promotes them: so float16 and bfloat16
    rewards give the reference's value of that dtype."""
    rew, dones = traj["rewards"], traj["dones"].to(torch.bool)
    acc = torch.zeros_like(rew[0])
    total = torch.zeros_like(rew[0])
    count = torch.zeros(rew.shape[1], dtype=torch.int64, device=rew.device)
    for r, d in zip(rew, dones):
        acc = acc + r
        total = torch.where(d, total + acc, total)
        count = count + d
        acc = torch.where(d, torch.zeros_like(acc), acc)
    return torch.sum(total) / torch.clamp(torch.sum(count), min=1).to(
        total.dtype)
