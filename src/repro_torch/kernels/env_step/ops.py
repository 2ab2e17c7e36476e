"""The env-step op: fused batched physics + auto-reset (port of
``repro/kernels/env_step/ops.py``).

``env_step(name, state, actions, reset_state, reset_obs, **params)`` takes
the reference layout (state leaves ``(B,)``/``(B, 6)``, ``t`` int32, actions
``(B, act_dim)``, reset candidates alike) and returns ``(next_state, obs,
rewards, dones)`` with ``dones`` bool. Selection (``kernels.select``): a CPU
tensor takes the plain version (``ref.py``); a CUDA tensor launches the
kernel of ``csrc/env_step.cu`` unless the mode is ``ref``.

The kernels replace ``pendulum_step_pallas``, ``cartpole_step_pallas``
and ``cheetah_step_pallas`` (``repro/kernels/env_step/env_step_pallas.py``).
They are HBM-bound: each instance reads its state and action and writes
its outputs once (cheetah 205 B, cart-pole 65 B, pendulum 45 B per
instance), and reads its reset candidates (cheetah 116 B, cart-pole 36 B,
pendulum 24 B) only where its episode ended, for a few dozen float
operations. Each wrapper counts its launches in ``<wrapper>.launches``.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

from repro_torch.kernels import build, counts, select, stream
from repro_torch.kernels.env_step import ref

ENV_NAMES: Tuple[str, ...] = tuple(ref.STEP_BATCH_REF)

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = build.library("env_step")
    lib.pendulum_step.argtypes = [_I] + [_P] * 14 + [_I, _F, _F, _F, _F, _P]
    lib.pendulum_step.restype = _I
    lib.cartpole_step.argtypes = [_I] + [_P] * 20 + [_I] + [_F] * 7 + [_P]
    lib.cartpole_step.restype = _I
    lib.cheetah_step.argtypes = [_I] + [_P] * 20 + [_I, _F, _F, _P]
    lib.cheetah_step.restype = _I
    return lib


def _check(named, device):
    """Each ``(name, tensor, shape, dtype)`` must match, be contiguous and
    lie on ``device``; the kernel takes nothing else."""
    for name, x, shape, dtype in named:
        if (tuple(x.shape) != shape or x.dtype != dtype
                or x.device != device or not x.is_contiguous()):
            raise ValueError(
                f"env_step kernel: {name} must be a contiguous {dtype} "
                f"tensor of shape {shape} on {device}; got {x.dtype} "
                f"{tuple(x.shape)} on {x.device}"
                f"{'' if x.is_contiguous() else ' (non-contiguous)'}")


def _raise_on(rc: int, kernel: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{kernel} kernel launch failed: cudaError {rc}")


def pendulum_step_cuda(state, actions, reset_state, reset_obs, *,
                       max_episode_steps, reward_scale, max_torque):
    """Launch the pendulum kernel; same contract as
    ``ref.pendulum_step_batch_ref``."""
    th, thdot, t = state
    rth, rtd, rt = reset_state
    B, dev, f32 = th.shape[0], th.device, torch.float32
    _check([("th", th, (B,), f32), ("thdot", thdot, (B,), f32),
            ("t", t, (B,), torch.int32), ("actions", actions, (B, 1), f32),
            ("reset th", rth, (B,), f32), ("reset thdot", rtd, (B,), f32),
            ("reset t", rt, (B,), torch.int32),
            ("reset obs", reset_obs, (B, 3), f32)], dev)
    oth, otd, ot = (torch.empty_like(th), torch.empty_like(thdot),
                    torch.empty_like(t))
    obs = torch.empty_like(reset_obs)
    rew = torch.empty_like(th)
    done = torch.empty((B,), dtype=torch.bool, device=dev)
    if B == 0:
        return (oth, otd, ot), obs, rew, done
    rc = _lib().pendulum_step(
        B, th.data_ptr(), thdot.data_ptr(), t.data_ptr(), actions.data_ptr(),
        rth.data_ptr(), rtd.data_ptr(), rt.data_ptr(), reset_obs.data_ptr(),
        oth.data_ptr(), otd.data_ptr(), ot.data_ptr(), obs.data_ptr(),
        rew.data_ptr(), done.data_ptr(), int(max_episode_steps),
        float(max_torque), float(reward_scale),
        # folded in double on the host, as the reference's Python folds them
        3 * ref.PENDULUM_G / (2 * ref.PENDULUM_L),
        3.0 / (ref.PENDULUM_M * ref.PENDULUM_L ** 2),
        stream.current(dev))
    _raise_on(rc, "pendulum_step")
    counts.add(pendulum_step_cuda)
    return (oth, otd, ot), obs, rew, done


pendulum_step_cuda.launches = 0


def cartpole_step_cuda(state, actions, reset_state, reset_obs, *,
                       max_episode_steps, reward_scale, force_max):
    """Launch the cart-pole kernel; same contract as
    ``ref.cartpole_step_batch_ref``."""
    x, xdot, th, thdot, t = state
    rx, rxd, rth, rtd, rt = reset_state
    B, dev, f32 = x.shape[0], x.device, torch.float32
    _check([("x", x, (B,), f32), ("xdot", xdot, (B,), f32),
            ("th", th, (B,), f32), ("thdot", thdot, (B,), f32),
            ("t", t, (B,), torch.int32), ("actions", actions, (B, 1), f32),
            ("reset x", rx, (B,), f32), ("reset xdot", rxd, (B,), f32),
            ("reset th", rth, (B,), f32), ("reset thdot", rtd, (B,), f32),
            ("reset t", rt, (B,), torch.int32),
            ("reset obs", reset_obs, (B, 4), f32)], dev)
    out_state = tuple(torch.empty_like(v) for v in state)
    obs = torch.empty_like(reset_obs)
    rew = torch.empty_like(x)
    done = torch.empty((B,), dtype=torch.bool, device=dev)
    if B == 0:
        return out_state, obs, rew, done
    rc = _lib().cartpole_step(
        B, *(v.data_ptr() for v in state), actions.data_ptr(),
        *(v.data_ptr() for v in reset_state), reset_obs.data_ptr(),
        *(v.data_ptr() for v in out_state), obs.data_ptr(), rew.data_ptr(),
        done.data_ptr(), int(max_episode_steps), float(force_max),
        float(reward_scale),
        # folded in double on the host, as the reference's Python folds
        # them, then rounded once to float, as JAX rounds them where they
        # meet a float32 array
        ref.CARTPOLE_M_CART + ref.CARTPOLE_M_POLE,
        ref.CARTPOLE_M_POLE * ref.CARTPOLE_L_POLE, 4.0 / 3.0,
        ref.CARTPOLE_X_LIMIT, ref.CARTPOLE_TH_LIMIT,
        stream.current(dev))
    _raise_on(rc, "cartpole_step")
    counts.add(cartpole_step_cuda)
    return out_state, obs, rew, done


cartpole_step_cuda.launches = 0


def cheetah_step_cuda(state, actions, reset_state, reset_obs, *,
                      max_episode_steps, reward_scale, ctrl_cost):
    """Launch the cheetah kernel; same contract as
    ``ref.cheetah_step_batch_ref``."""
    th, om, vx, pitch, t = state
    rth, rom, rvx, rpi, rt = reset_state
    B, dev, f32 = vx.shape[0], vx.device, torch.float32
    J = ref.CHEETAH_N_JOINTS
    _check([("th", th, (B, J), f32), ("om", om, (B, J), f32),
            ("vx", vx, (B,), f32), ("pitch", pitch, (B,), f32),
            ("t", t, (B,), torch.int32), ("actions", actions, (B, J), f32),
            ("reset th", rth, (B, J), f32), ("reset om", rom, (B, J), f32),
            ("reset vx", rvx, (B,), f32), ("reset pitch", rpi, (B,), f32),
            ("reset t", rt, (B,), torch.int32),
            ("reset obs", reset_obs, (B, 2 * J + 2), f32)], dev)
    oth, oom = torch.empty_like(th), torch.empty_like(om)
    ovx, opi, ot = (torch.empty_like(vx), torch.empty_like(pitch),
                    torch.empty_like(t))
    obs = torch.empty_like(reset_obs)
    rew = torch.empty_like(vx)
    done = torch.empty((B,), dtype=torch.bool, device=dev)
    if B == 0:
        return (oth, oom, ovx, opi, ot), obs, rew, done
    rc = _lib().cheetah_step(
        B, th.data_ptr(), om.data_ptr(), vx.data_ptr(), pitch.data_ptr(),
        t.data_ptr(), actions.data_ptr(), rth.data_ptr(), rom.data_ptr(),
        rvx.data_ptr(), rpi.data_ptr(), rt.data_ptr(), reset_obs.data_ptr(),
        oth.data_ptr(), oom.data_ptr(), ovx.data_ptr(), opi.data_ptr(),
        ot.data_ptr(), obs.data_ptr(), rew.data_ptr(), done.data_ptr(),
        int(max_episode_steps), float(ctrl_cost), float(reward_scale),
        stream.current(dev))
    _raise_on(rc, "cheetah_step")
    counts.add(cheetah_step_cuda)
    return (oth, oom, ovx, opi, ot), obs, rew, done


cheetah_step_cuda.launches = 0

STEP_BATCH_CUDA = {
    "pendulum": pendulum_step_cuda,
    "cartpole": cartpole_step_cuda,
    "cheetah": cheetah_step_cuda,
}


def env_step(name: str, state, actions, reset_state, reset_obs, *,
             impl=None, **params):
    """Fused batched physics step + auto-reset select for env ``name``.

    Returns ``(next_state, obs, rewards, dones)``; the reset candidates
    replace the stepped state and obs wherever ``dones`` is set, and
    rewards stay the terminal transition's. ``params`` are the env's
    ``make`` kwargs (horizon, scales)."""
    if name not in ref.STEP_BATCH_REF:
        raise KeyError(f"no env_step kernel for env {name!r}; choose from "
                       f"{sorted(ref.STEP_BATCH_REF)} (others: ROADMAP.md)")
    if select.use_kernel(impl, actions):
        return STEP_BATCH_CUDA[name](state, actions, reset_state, reset_obs,
                                     **params)
    return ref.STEP_BATCH_REF[name](state, actions, reset_state, reset_obs,
                                    **params)
