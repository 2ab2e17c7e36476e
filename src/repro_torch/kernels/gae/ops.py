"""The GAE family's ops (port of ``repro/kernels/gae/ops.py``).

``gae`` and ``discounted_returns`` take the reference layout, time-major
``(T, ...)`` with any batch shape. A CPU tensor takes the plain version
(``ref.py``); a CUDA tensor launches the kernel of ``csrc/gae.cu`` (unless
the mode is ``ref``), with the batch dims flattened to one column axis and
the caller's shape restored on the way out.

The kernels replace ``gae_pallas`` and ``discounted_returns_pallas``
(``repro/kernels/gae/gae_pallas.py``). Both are HBM-bound: GAE moves 17
bytes per ``(t, b)`` element for 7 float operations, the returns 9 bytes
for 4. ``gae_cuda.launches`` and ``discounted_returns_cuda.launches``
count their launches.
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional, Tuple

import torch

from repro_torch.kernels import build, counts, select, stream
from repro_torch.kernels.gae.ref import discounted_returns_ref, gae_ref


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = build.library("gae")
    lib.gae.argtypes = ([ctypes.c_int] * 2 + [ctypes.c_void_p] * 6
                        + [ctypes.c_float] * 2 + [ctypes.c_void_p])
    lib.gae.restype = ctypes.c_int
    lib.discounted_returns.argtypes = ([ctypes.c_int] * 2
                                       + [ctypes.c_void_p] * 4
                                       + [ctypes.c_float, ctypes.c_void_p])
    lib.discounted_returns.restype = ctypes.c_int
    return lib


def _flatten_batch(x: torch.Tensor) -> torch.Tensor:
    """(T, ...) -> (T, prod(...)); a scalar batch becomes one column. The
    width is spelled out, since ``-1`` is ambiguous for ``T = 0``."""
    return x.reshape(x.shape[0], math.prod(x.shape[1:]))


def _check(kernel: str, named, device) -> None:
    """Each ``(name, tensor, shape, dtype)`` must match, be contiguous and
    lie on ``device``; the kernel takes nothing else."""
    for name, x, shape, dtype in named:
        if (tuple(x.shape) != shape or x.dtype != dtype or x.device != device
                or not x.is_contiguous()):
            raise ValueError(
                f"{kernel} kernel: {name} must be a contiguous {dtype} "
                f"tensor of shape {shape} on {device}; got {x.dtype} "
                f"{tuple(x.shape)} on {x.device}")


def gae_cuda(rewards: torch.Tensor, values: torch.Tensor,
             dones: torch.Tensor, last_value: torch.Tensor, *,
             gamma: float, lam: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the GAE kernel. rewards/values (T, B) float32, dones (T, B)
    bool, last_value (B,) float32, all contiguous on one CUDA device."""
    T, B = rewards.shape
    dev = rewards.device
    _check("gae", [("rewards", rewards, (T, B), torch.float32),
                   ("values", values, (T, B), torch.float32),
                   ("dones", dones, (T, B), torch.bool),
                   ("last_value", last_value, (B,), torch.float32)], dev)
    adv, ret = torch.empty_like(rewards), torch.empty_like(rewards)
    if T == 0 or B == 0:
        return adv, ret
    rc = _lib().gae(T, B, rewards.data_ptr(), values.data_ptr(),
                    dones.data_ptr(), last_value.data_ptr(), adv.data_ptr(),
                    ret.data_ptr(), float(gamma),
                    # folded in double on the host, as Python folds it
                    gamma * lam,
                    stream.current(dev))
    if rc != 0:
        raise RuntimeError(f"gae kernel launch failed: cudaError {rc}")
    counts.add(gae_cuda)
    return adv, ret


gae_cuda.launches = 0


def discounted_returns_cuda(rewards: torch.Tensor, dones: torch.Tensor,
                            last_value: torch.Tensor, *,
                            gamma: float) -> torch.Tensor:
    """Launch the discounted-returns kernel. rewards (T, B) float32, dones
    (T, B) bool, last_value (B,) float32, all contiguous on one CUDA
    device."""
    T, B = rewards.shape
    dev = rewards.device
    _check("discounted_returns",
           [("rewards", rewards, (T, B), torch.float32),
            ("dones", dones, (T, B), torch.bool),
            ("last_value", last_value, (B,), torch.float32)], dev)
    ret = torch.empty_like(rewards)
    if T == 0 or B == 0:
        return ret
    rc = _lib().discounted_returns(
        T, B, rewards.data_ptr(), dones.data_ptr(), last_value.data_ptr(),
        ret.data_ptr(), float(gamma),
        stream.current(dev))
    if rc != 0:
        raise RuntimeError(
            f"discounted_returns kernel launch failed: cudaError {rc}")
    counts.add(discounted_returns_cuda)
    return ret


discounted_returns_cuda.launches = 0


def gae(rewards: torch.Tensor, values: torch.Tensor, dones: torch.Tensor,
        last_value: torch.Tensor, gamma: float = 0.99, lam: float = 0.95,
        *, impl: Optional[str] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Advantages + returns; see ``ref.gae_ref`` for semantics. Float16
    or bfloat16 rewards (an env of that dtype) are cast up to the values'
    dtype first, exactly, as JAX promotes them where they meet the values:
    both paths then take float32."""
    rewards = rewards.to(torch.promote_types(rewards.dtype, values.dtype))
    if not select.use_kernel(impl, rewards):
        return gae_ref(rewards, values, dones, last_value, gamma, lam)
    adv, ret = gae_cuda(_flatten_batch(rewards), _flatten_batch(values),
                        _flatten_batch(dones), last_value.reshape(-1),
                        gamma=gamma, lam=lam)
    return adv.reshape(rewards.shape), ret.reshape(rewards.shape)


def discounted_returns(rewards: torch.Tensor, dones: torch.Tensor,
                       last_value: torch.Tensor, gamma: float = 0.99,
                       *, impl: Optional[str] = None) -> torch.Tensor:
    """Discounted returns-to-go; see ``ref.discounted_returns_ref``.
    Float16 or bfloat16 rewards are cast up to ``last_value``'s dtype
    first, as in ``gae``."""
    rewards = rewards.to(torch.promote_types(rewards.dtype,
                                             last_value.dtype))
    if not select.use_kernel(impl, rewards):
        return discounted_returns_ref(rewards, dones, last_value, gamma)
    ret = discounted_returns_cuda(_flatten_batch(rewards),
                                  _flatten_batch(dones),
                                  last_value.reshape(-1), gamma=gamma)
    return ret.reshape(rewards.shape)
