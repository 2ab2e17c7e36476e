"""Batched environment API (port of ``repro/envs/base.py``).

The reference writes single-instance envs and batches them with ``vmap``;
here the batch dimension is written out. An ``Env`` bundles:

* ``reset(generator, batch, device) -> (state, obs)``: ``batch`` fresh
  instances drawn from ``generator`` (state leaves ``(B, ...)``);
* ``batch_step(state, actions, reset_state, reset_obs) -> (state', obs,
  rewards, dones)``: the fused physics step + auto-reset select against the
  given reset candidates (the ``env_step`` op, so on the card one kernel).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Tuple

import torch

EnvState = Tuple[torch.Tensor, ...]


@dataclasses.dataclass(frozen=True)
class Env:
    name: str
    obs_dim: int
    act_dim: int
    reset: Callable[[torch.Generator, int, Any], Tuple[EnvState, torch.Tensor]]
    batch_step: Callable[..., Tuple[EnvState, torch.Tensor, torch.Tensor,
                                    torch.Tensor]]
    max_episode_steps: int = 1000


def auto_reset_batch(env: Env):
    """``step(state, actions, generator) -> (state', obs, rewards, dones)``:
    draw one batch of reset candidates from ``generator``, then take the
    fused step + auto-reset select. Ended episodes restart transparently;
    rewards stay the terminal transition's."""

    def step(state, actions, generator):
        reset_state, reset_obs = env.reset(generator, actions.shape[0],
                                           actions.device)
        return env.batch_step(state, actions, reset_state, reset_obs)

    return step
