"""Plain PyTorch version of the env-step kernel family (port of
``repro/kernels/env_step/ref.py``).

The batched physics of pendulum, cart-pole and cheetah fused with the
auto-reset select, over ``(B,)``/``(B, 6)`` state leaves. The expressions and their
order are the reference's; Python constants fold in double before they meet
a float32 tensor, exactly as in the reference (e.g. ``3 * G / (2 * L)`` is
15.0 before it multiplies ``sin(th)``). Where the order matters and torch
has a reduction of its own (the 5-term thrust mean, the 6-term sums), the
terms are added left to right, and means divide by a tensor (a division by
a Python scalar may become a multiply by its reciprocal on the card). The
CUDA kernel in ``csrc/env_step.cu`` evaluates the same expressions.

Reset candidates are inputs: they are drawn by the env modules from a
``torch.Generator`` and selected where ``done`` is set; rewards stay the
terminal transition's (the ``auto_reset`` contract).
"""
from __future__ import annotations

import math

import torch

# --------------------------------------------------------------- constants
PENDULUM_MAX_SPEED = 8.0
PENDULUM_MAX_TORQUE = 2.0
PENDULUM_DT = 0.05
PENDULUM_G = 10.0
PENDULUM_M = 1.0
PENDULUM_L = 1.0

CARTPOLE_GRAVITY = 9.8
CARTPOLE_M_CART = 1.0
CARTPOLE_M_POLE = 0.1
CARTPOLE_L_POLE = 0.5          # half-length
CARTPOLE_FORCE_MAX = 10.0
CARTPOLE_DT = 0.02
CARTPOLE_X_LIMIT = 2.4
CARTPOLE_TH_LIMIT = 12 * math.pi / 180

CHEETAH_N_JOINTS = 6
CHEETAH_DT = 0.05
CHEETAH_DAMPING = 1.5
CHEETAH_STIFFNESS = 4.0
CHEETAH_GEAR = 6.0
CHEETAH_COUPLING = 0.8


def _angle_norm(x: torch.Tensor) -> torch.Tensor:
    """``((x + pi) % (2 pi)) - pi`` with jnp's floor-mod ``%``: the exact
    ``fmod``, plus the divisor where the remainder is negative (the
    divisor, 2 pi, is positive)."""
    r = torch.fmod(x + math.pi, 2 * math.pi)
    r = torch.where((r != 0) & (r < 0), r + 2 * math.pi, r)
    return r - math.pi


def _div(x: torch.Tensor, c: float) -> torch.Tensor:
    """``x / c`` as a true division by the float32 constant (a division by
    a Python scalar may become a multiply by its reciprocal on the card)."""
    return x / torch.full_like(x, c)


def _mean_seq(cols) -> torch.Tensor:
    """Mean of a sequence of equal-shaped tensors, summed left to right."""
    total = cols[0]
    for c in cols[1:]:
        total = total + c
    return _div(total, float(len(cols)))


def select_reset_batch(done, reset_state, reset_obs, state, obs):
    """Leafwise ``where(done, reset, stepped)`` over the batch, ``done``
    broadcast up each leaf's trailing dims."""

    def pick(r, n):
        mask = done.reshape(done.shape + (1,) * (n.dim() - done.dim()))
        return torch.where(mask, r, n)

    state = tuple(pick(r, n) for r, n in zip(reset_state, state))
    return state, pick(reset_obs, obs)


# ================================================================ pendulum
def pendulum_obs(state) -> torch.Tensor:
    th, thdot, _ = state
    return torch.stack([torch.cos(th), torch.sin(th),
                        thdot / PENDULUM_MAX_SPEED], dim=-1)


def pendulum_step_batch_ref(state, actions, reset_state, reset_obs, *,
                            max_episode_steps, reward_scale, max_torque):
    """Batched pendulum step + auto-reset. state leaves (B,), (B,),
    int32 (B,); actions (B, 1)."""
    th, thdot, t = state
    u = torch.clamp(actions[:, 0], -max_torque, max_torque)
    cost = _angle_norm(th) ** 2 + 0.1 * thdot ** 2 + 0.001 * u ** 2
    thdot = thdot + (3 * PENDULUM_G / (2 * PENDULUM_L) * torch.sin(th)
                     + 3.0 / (PENDULUM_M * PENDULUM_L ** 2) * u) * PENDULUM_DT
    thdot = torch.clamp(thdot, -PENDULUM_MAX_SPEED, PENDULUM_MAX_SPEED)
    th = th + thdot * PENDULUM_DT
    t = t + 1
    done = t >= max_episode_steps
    reward = -cost
    if reward_scale != 1.0:
        reward = reward * reward_scale
    obs = pendulum_obs((th, thdot, t))
    state, obs = select_reset_batch(done, reset_state, reset_obs,
                                    (th, thdot, t), obs)
    return state, obs, reward, done


# ================================================================ cartpole
def cartpole_obs(state) -> torch.Tensor:
    x, xdot, th, thdot, _ = state
    return torch.stack([x, xdot, th, thdot], dim=-1)


def cartpole_step_batch_ref(state, actions, reset_state, reset_obs, *,
                            max_episode_steps, reward_scale, force_max):
    """Batched cart-pole step + auto-reset. state leaves (B,) x4, int32
    (B,); actions (B, 1). The force uses the clipped action, the reward's
    control cost the unclipped one, as in the reference."""
    x, xdot, th, thdot, t = state
    a0 = actions[:, 0]
    force = torch.clamp(a0, -1.0, 1.0) * force_max
    total_m = CARTPOLE_M_CART + CARTPOLE_M_POLE
    pm_l = CARTPOLE_M_POLE * CARTPOLE_L_POLE
    costh, sinth = torch.cos(th), torch.sin(th)
    temp = _div(force + pm_l * (thdot * thdot) * sinth, total_m)
    th_acc = ((CARTPOLE_GRAVITY * sinth - costh * temp)
              / (CARTPOLE_L_POLE
                 * (4.0 / 3.0
                    - _div(CARTPOLE_M_POLE * (costh * costh), total_m))))
    x_acc = temp - _div(pm_l * th_acc * costh, total_m)
    x = x + CARTPOLE_DT * xdot
    xdot = xdot + CARTPOLE_DT * x_acc
    th = th + CARTPOLE_DT * thdot
    thdot = thdot + CARTPOLE_DT * th_acc
    t = t + 1
    fell = ((torch.abs(x) > CARTPOLE_X_LIMIT)
            | (torch.abs(th) > CARTPOLE_TH_LIMIT))
    done = fell | (t >= max_episode_steps)
    reward = 1.0 - 0.01 * (a0 * a0) - 1.0 * fell
    if reward_scale != 1.0:
        reward = reward * reward_scale
    obs = cartpole_obs((x, xdot, th, thdot, t))
    state, obs = select_reset_batch(done, reset_state, reset_obs,
                                    (x, xdot, th, thdot, t), obs)
    return state, obs, reward, done


# ================================================================= cheetah
def cheetah_obs(state) -> torch.Tensor:
    th, om, vx, pitch, _ = state
    return torch.cat([th, om, torch.stack([vx, pitch], dim=-1)], dim=-1)


def cheetah_step_batch_ref(state, actions, reset_state, reset_obs, *,
                           max_episode_steps, reward_scale, ctrl_cost):
    """Batched cheetah step + auto-reset. th/om (B, 6), vx/pitch (B,),
    t int32 (B,); actions (B, 6)."""
    th, om, vx, pitch, t = state
    a = torch.clamp(actions, -1.0, 1.0)
    neighbour = CHEETAH_COUPLING * (torch.roll(th, 1, dims=-1) - th)
    om = om + CHEETAH_DT * (CHEETAH_GEAR * a - CHEETAH_DAMPING * om
                            - CHEETAH_STIFFNESS * th + neighbour)
    th = th + CHEETAH_DT * om
    thrust = _mean_seq((torch.sin(th[:, :-1] - th[:, 1:])
                        * (om[:, :-1] - om[:, 1:])).unbind(-1))
    vx = 0.9 * vx + CHEETAH_DT * (8.0 * thrust)
    pitch = 0.95 * pitch + 0.05 * _mean_seq(th.unbind(-1))
    t = t + 1
    a_sq = (a * a).unbind(-1)
    ctrl = a_sq[0]
    for c in a_sq[1:]:
        ctrl = ctrl + c
    reward = vx - ctrl_cost * ctrl
    if reward_scale != 1.0:
        reward = reward * reward_scale
    done = t >= max_episode_steps
    obs = cheetah_obs((th, om, vx, pitch, t))
    state, obs = select_reset_batch(done, reset_state, reset_obs,
                                    (th, om, vx, pitch, t), obs)
    return state, obs, reward, done


STEP_BATCH_REF = {
    "pendulum": pendulum_step_batch_ref,
    "cartpole": cartpole_step_batch_ref,
    "cheetah": cheetah_step_batch_ref,
}
