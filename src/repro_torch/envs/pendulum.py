"""Pendulum swing-up (port of ``repro/envs/pendulum.py``).

Dynamics and reward follow Gym Pendulum-v1; the physics live in
``kernels/env_step/ref.py`` and run through the ``env_step`` op.
"""
from __future__ import annotations

import math

import torch

from repro_torch.envs.base import Env
from repro_torch.kernels.env_step import ops as env_step_ops
from repro_torch.kernels.env_step import ref as env_step_ref
from repro_torch.kernels.env_step.ref import PENDULUM_MAX_TORQUE as MAX_TORQUE


def make(max_episode_steps: int = 200, reward_scale: float = 1.0,
         max_torque: float = MAX_TORQUE, dtype=torch.float32) -> Env:
    dtype = env_step_ref.obs_dtype(dtype, "repro_torch/envs/pendulum.py")
    reward_scale = float(reward_scale)
    params = dict(max_episode_steps=max_episode_steps,
                  reward_scale=reward_scale, max_torque=max_torque)

    def reset(generator, batch, device):
        th = torch.empty(batch, device=device).uniform_(
            -math.pi, math.pi, generator=generator)
        thdot = torch.empty(batch, device=device).uniform_(
            -1.0, 1.0, generator=generator)
        state = (th, thdot, torch.zeros(batch, dtype=torch.int32,
                                        device=device))
        return state, env_step_ref.pendulum_obs(state).to(dtype)

    def batch_step(state, actions, reset_state, reset_obs, impl=None):
        return env_step_ops.env_step("pendulum", state, actions, reset_state,
                                     reset_obs, dtype=dtype, impl=impl,
                                     **params)

    return Env(name="pendulum", obs_dim=3, act_dim=1, reset=reset,
               batch_step=batch_step, max_episode_steps=max_episode_steps)
