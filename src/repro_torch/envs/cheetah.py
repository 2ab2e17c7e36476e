"""Planar "cheetah-like" locomotion (port of ``repro/envs/cheetah.py``).

A 6-joint planar chain standing in for MuJoCo HalfCheetah-v2, the paper's
task. Observation (14-d): 6 joint angles, 6 joint velocities, body velocity,
body pitch. Action: 6 joint torques in [-1, 1]. Reward: vx - 0.1 * ||a||^2.
The physics live in ``kernels/env_step/ref.py`` and run through the
``env_step`` op.
"""
from __future__ import annotations

import torch

from repro_torch.envs.base import Env
from repro_torch.kernels.env_step import ops as env_step_ops
from repro_torch.kernels.env_step import ref as env_step_ref
from repro_torch.kernels.env_step.ref import CHEETAH_N_JOINTS as N_JOINTS


def make(max_episode_steps: int = 1000, reward_scale: float = 1.0,
         ctrl_cost: float = 0.1) -> Env:
    reward_scale = float(reward_scale)
    params = dict(max_episode_steps=max_episode_steps,
                  reward_scale=reward_scale, ctrl_cost=ctrl_cost)

    def reset(generator, batch, device):
        th = torch.empty(batch, N_JOINTS, device=device).uniform_(
            -0.1, 0.1, generator=generator)
        om = torch.empty(batch, N_JOINTS, device=device).uniform_(
            -0.1, 0.1, generator=generator)
        zeros = torch.zeros(batch, device=device)
        state = (th, om, zeros, zeros.clone(),
                 torch.zeros(batch, dtype=torch.int32, device=device))
        return state, env_step_ref.cheetah_obs(state)

    def batch_step(state, actions, reset_state, reset_obs, impl=None):
        return env_step_ops.env_step("cheetah", state, actions, reset_state,
                                     reset_obs, impl=impl, **params)

    return Env(name="cheetah", obs_dim=2 * N_JOINTS + 2, act_dim=N_JOINTS,
               reset=reset, batch_step=batch_step,
               max_episode_steps=max_episode_steps)
