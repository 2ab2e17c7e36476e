"""Batched environment API (port of ``repro/envs/base.py``).

The reference writes single-instance envs and batches them with ``vmap``;
here the batch dimension is written out. An ``Env`` bundles:

* ``reset(generator, batch, device) -> (state, obs)``: ``batch`` fresh
  instances drawn from ``generator`` (state leaves ``(B, ...)``);
* ``batch_step(state, actions, reset_state, reset_obs) -> (state', obs,
  rewards, dones)``: the fused physics step + auto-reset select against the
  given reset candidates (the ``env_step`` op, so on the card one kernel).

``auto_reset`` wraps that into a step that draws its own reset candidates;
``select_reset_batch`` is the select itself, a leafwise ``where``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Tuple

import torch

from repro_torch.kernels.env_step.ref import select_reset_batch  # noqa: F401

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


def auto_reset(env: Env):
    """The reference's ``auto_reset`` on the batched API: ``step(state,
    actions, generator) -> (state', obs, rewards, dones)`` where every
    instance whose episode ended restarts from a fresh reset. Where
    ``dones`` is set, the obs is the reset obs and every state leaf, the
    step counter too, is the reset state's; the reward is the terminal
    transition's, never the reset's. The reference wraps a
    single-instance step and batches it with ``vmap``, which its
    ``auto_reset_batch`` equals bit for bit; every env of the port is
    batched, so this is that batched step."""
    return auto_reset_batch(env)
