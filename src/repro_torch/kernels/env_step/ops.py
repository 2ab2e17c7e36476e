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
instance), and reads its reset candidates (cheetah 116 B where its episode
ended; cart-pole 36 B and pendulum 24 B on every row), for a few dozen
float operations. Each wrapper counts its launches in
``<wrapper>.launches``.

On the stepped runtimes a rollout makes one wrapper call per env step, and
the call's host time is many times the kernel's device time, so the launch
path is kept short. A call checks its leaves (``_check``: shape, dtype,
contiguity, device; the message names the refused leaf) before it builds
or launches anything; allocates its outputs, one tensor each
(``_outputs``); packs every pointer, the stream and the scalars into one
``struct`` block in the layout of the kernel's ``*Args`` struct
(``_pack``); and launches the kernel with one converted ``ctypes``
argument (``_call``). The block is built per call, so threads that launch
at once (sampler threads, the overlap learner) never share it.
"""
from __future__ import annotations

import ctypes
import functools
import struct
from typing import Tuple

import torch

from repro_torch.kernels import build, counts, select, stream
from repro_torch.kernels.env_step import ref

ENV_NAMES: Tuple[str, ...] = tuple(ref.STEP_BATCH_REF)

_F32, _I32 = torch.float32, torch.int32

# The argument blocks of ``csrc/env_step.cu`` (PendulumArgs, CartpoleArgs,
# CheetahArgs): input pointers, output pointers (the next state's leaves,
# obs, rewards, dones), the stream, B and the
# horizon, then the float scalars; "0P" pads the end as the C struct is
# padded. ``_lib`` checks each size against the library's.
_ARGS = {"pendulum": struct.Struct("@15P2i4f0P"),
         "cartpole": struct.Struct("@21P2i7f0P"),
         "cheetah": struct.Struct("@21P2i2f0P")}

# (name, dtype) of each leaf a wrapper takes, in its argument block's order
_PENDULUM_LEAVES = (("th", _F32), ("thdot", _F32), ("t", _I32),
                    ("actions", _F32), ("reset th", _F32),
                    ("reset thdot", _F32), ("reset t", _I32),
                    ("reset obs", _F32))
_CARTPOLE_LEAVES = (("x", _F32), ("xdot", _F32), ("th", _F32),
                    ("thdot", _F32), ("t", _I32), ("actions", _F32),
                    ("reset x", _F32), ("reset xdot", _F32),
                    ("reset th", _F32), ("reset thdot", _F32),
                    ("reset t", _I32), ("reset obs", _F32))
_CHEETAH_LEAVES = (("th", _F32), ("om", _F32), ("vx", _F32),
                   ("pitch", _F32), ("t", _I32), ("actions", _F32),
                   ("reset th", _F32), ("reset om", _F32),
                   ("reset vx", _F32), ("reset pitch", _F32),
                   ("reset t", _I32), ("reset obs", _F32))

# folded in double on the host, as the reference's Python folds them, then
# rounded once to float by ``struct`` (as JAX rounds them where they meet
# a float32 array)
_PENDULUM_CONSTS = (3 * ref.PENDULUM_G / (2 * ref.PENDULUM_L),
                    3.0 / (ref.PENDULUM_M * ref.PENDULUM_L ** 2))
_CARTPOLE_CONSTS = (ref.CARTPOLE_M_CART + ref.CARTPOLE_M_POLE,
                    ref.CARTPOLE_M_POLE * ref.CARTPOLE_L_POLE, 4.0 / 3.0,
                    ref.CARTPOLE_X_LIMIT, ref.CARTPOLE_TH_LIMIT)


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = build.library("env_step")
    for name, args in _ARGS.items():
        size = getattr(lib, f"{name}_args_size")()
        if size != args.size:
            raise RuntimeError(f"env_step: {name}'s argument block is "
                               f"{size} bytes in the library, {args.size} "
                               f"in ops.py")
        fn = getattr(lib, f"{name}_step")
        fn.argtypes = [ctypes.c_char_p]
        fn.restype = ctypes.c_int
    return lib


def _check(tensors, shapes, leaves, device):
    """Each tensor must have its shape and its leaf's dtype (``leaves``:
    ``(name, dtype)`` each), be contiguous and lie on ``device``; the kernel
    takes nothing else."""
    for x, shape, (name, dtype) in zip(tensors, shapes, leaves):
        if (x.dtype is not dtype or x.shape != shape
                or not x.is_contiguous() or x.device != device):
            raise ValueError(
                f"env_step kernel: {name} must be a contiguous {dtype} "
                f"tensor of shape {shape} on {device}; got {x.dtype} "
                f"{tuple(x.shape)} on {x.device}"
                f"{'' if x.is_contiguous() else ' (non-contiguous)'}")


def _outputs(state, reset_obs):
    """Fresh outputs of a step, each its own contiguous tensor: the next
    state's leaves shaped like ``state``'s, obs like ``reset_obs``, then
    rewards float32 and dones bool, both ``(B,)``."""
    t = state[-1]
    return (*[torch.empty_like(x) for x in state], torch.empty_like(reset_obs),
            torch.empty_like(t, dtype=_F32),
            torch.empty_like(t, dtype=torch.bool))


def _pack(name, tensors, dev, B, horizon, floats):
    """The argument block of ``name``: ``tensors``' pointers, the stream,
    B, the horizon and the float scalars."""
    return _ARGS[name].pack(*[x.data_ptr() for x in tensors],
                            stream.current(dev), B, int(horizon), *floats)


def _call(name, block):
    """Launch ``name``'s kernel on its argument block."""
    rc = getattr(_lib(), f"{name}_step")(block)
    if rc != 0:
        raise RuntimeError(f"{name}_step kernel launch failed: "
                           f"cudaError {rc}")


def _launch(name, tensors, dev, B, horizon, floats):
    """Pack the argument block of ``name`` and launch its kernel."""
    _call(name, _pack(name, tensors, dev, B, horizon, floats))


def pendulum_step_cuda(state, actions, reset_state, reset_obs, *,
                       max_episode_steps, reward_scale, max_torque):
    """Launch the pendulum kernel; same contract as
    ``ref.pendulum_step_batch_ref``."""
    th, thdot, t = state
    rth, rtd, rt = reset_state
    B, dev = th.shape[0], th.device
    v = (B,)
    inputs = (th, thdot, t, actions, rth, rtd, rt, reset_obs)
    _check(inputs, (v, v, v, (B, 1), v, v, v, (B, 3)), _PENDULUM_LEAVES,
           dev)
    outs = _outputs(state, reset_obs)
    if B:
        _launch("pendulum", inputs + outs, dev, B, max_episode_steps,
                (float(max_torque), float(reward_scale), *_PENDULUM_CONSTS))
        counts.add(pendulum_step_cuda)
    return outs[:3], *outs[3:]


pendulum_step_cuda.launches = 0


def cartpole_step_cuda(state, actions, reset_state, reset_obs, *,
                       max_episode_steps, reward_scale, force_max):
    """Launch the cart-pole kernel; same contract as
    ``ref.cartpole_step_batch_ref``."""
    x, xdot, th, thdot, t = state
    rx, rxd, rth, rtd, rt = reset_state
    B, dev = x.shape[0], x.device
    v = (B,)
    inputs = (x, xdot, th, thdot, t, actions, rx, rxd, rth, rtd, rt,
              reset_obs)
    _check(inputs, (v, v, v, v, v, (B, 1), v, v, v, v, v, (B, 4)),
           _CARTPOLE_LEAVES, dev)
    outs = _outputs(state, reset_obs)
    if B:
        _launch("cartpole", inputs + outs, dev, B, max_episode_steps,
                (float(force_max), float(reward_scale), *_CARTPOLE_CONSTS))
        counts.add(cartpole_step_cuda)
    return outs[:5], *outs[5:]


cartpole_step_cuda.launches = 0


def cheetah_step_cuda(state, actions, reset_state, reset_obs, *,
                      max_episode_steps, reward_scale, ctrl_cost):
    """Launch the cheetah kernel; same contract as
    ``ref.cheetah_step_batch_ref``."""
    th, om, vx, pitch, t = state
    rth, rom, rvx, rpi, rt = reset_state
    B, dev = vx.shape[0], vx.device
    v, j = (B,), (B, ref.CHEETAH_N_JOINTS)
    inputs = (th, om, vx, pitch, t, actions, rth, rom, rvx, rpi, rt,
              reset_obs)
    _check(inputs, (j, j, v, v, v, j, j, j, v, v, v, (B, 2 * j[1] + 2)),
           _CHEETAH_LEAVES, dev)
    outs = _outputs(state, reset_obs)
    if B:
        _launch("cheetah", inputs + outs, dev, B, max_episode_steps,
                (float(ctrl_cost), float(reward_scale)))
        counts.add(cheetah_step_cuda)
    return outs[:5], *outs[5:]


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
