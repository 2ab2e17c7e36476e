"""Continuous-action cart-pole balance (port of ``repro/envs/cartpole.py``).

Classic cart-pole physics (Barto-Sutton-Anderson) with a continuous force
action in [-1, 1] * 10 N; reward 1 per step upright minus a small control
cost. Episodes end on pole fall, track exit, or ``max_episode_steps``.
The physics live in ``kernels/env_step/ref.py`` and run through the
``env_step`` op.
"""
from __future__ import annotations

import torch

from repro_torch.envs.base import Env
from repro_torch.kernels.env_step import ops as env_step_ops
from repro_torch.kernels.env_step import ref as env_step_ref
from repro_torch.kernels.env_step.ref import CARTPOLE_FORCE_MAX as FORCE_MAX


def make(max_episode_steps: int = 500, reward_scale: float = 1.0,
         force_max: float = FORCE_MAX) -> Env:
    reward_scale = float(reward_scale)
    params = dict(max_episode_steps=max_episode_steps,
                  reward_scale=reward_scale, force_max=force_max)

    def reset(generator, batch, device):
        # one (4, B) draw: x, xdot, th, thdot, each a contiguous row
        vals = torch.empty(4, batch, device=device).uniform_(
            -0.05, 0.05, generator=generator)
        state = (*vals.unbind(0),
                 torch.zeros(batch, dtype=torch.int32, device=device))
        return state, env_step_ref.cartpole_obs(state)

    def batch_step(state, actions, reset_state, reset_obs, impl=None):
        return env_step_ops.env_step("cartpole", state, actions, reset_state,
                                     reset_obs, impl=impl, **params)

    return Env(name="cartpole", obs_dim=4, act_dim=1, reset=reset,
               batch_step=batch_step, max_episode_steps=max_episode_steps)
