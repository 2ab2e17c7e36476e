"""The GAE op (port of ``gae`` in ``repro/kernels/gae/ops.py``).

``gae`` takes the reference layout, time-major ``(T, ...)`` with any batch
shape. A CPU tensor takes the plain version (``ref.gae_ref``); a CUDA
tensor launches the kernel of ``csrc/gae.cu`` (unless the mode is ``ref``),
with the batch dims flattened to one column axis and the caller's shape
restored on the way out.

The kernel replaces ``gae_pallas`` (``repro/kernels/gae/gae_pallas.py``).
It is HBM-bound: 17 bytes per ``(t, b)`` element for 7 float operations.
``gae_cuda.launches`` counts its launches.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from repro_torch.kernels import build, select
from repro_torch.kernels.gae.ref import gae_ref


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = build.library("gae")
    lib.gae.argtypes = ([ctypes.c_int] * 2 + [ctypes.c_void_p] * 6
                        + [ctypes.c_float] * 2 + [ctypes.c_void_p])
    lib.gae.restype = ctypes.c_int
    return lib


def _flatten_batch(x: torch.Tensor) -> torch.Tensor:
    """(T, ...) -> (T, prod(...)); a scalar batch becomes one column."""
    return x.reshape(x.shape[0], -1)


def gae_cuda(rewards: torch.Tensor, values: torch.Tensor,
             dones: torch.Tensor, last_value: torch.Tensor, *,
             gamma: float, lam: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the GAE kernel. rewards/values (T, B) float32, dones (T, B)
    bool, last_value (B,) float32, all contiguous on one CUDA device."""
    T, B = rewards.shape
    dev = rewards.device
    for name, x, shape, dtype in [
            ("rewards", rewards, (T, B), torch.float32),
            ("values", values, (T, B), torch.float32),
            ("dones", dones, (T, B), torch.bool),
            ("last_value", last_value, (B,), torch.float32)]:
        if (tuple(x.shape) != shape or x.dtype != dtype or x.device != dev
                or not x.is_contiguous()):
            raise ValueError(
                f"gae kernel: {name} must be a contiguous {dtype} tensor of "
                f"shape {shape} on {dev}; got {x.dtype} {tuple(x.shape)} on "
                f"{x.device}")
    adv, ret = torch.empty_like(rewards), torch.empty_like(rewards)
    if T == 0 or B == 0:
        return adv, ret
    rc = _lib().gae(T, B, rewards.data_ptr(), values.data_ptr(),
                    dones.data_ptr(), last_value.data_ptr(), adv.data_ptr(),
                    ret.data_ptr(), float(gamma),
                    # folded in double on the host, as Python folds it
                    gamma * lam,
                    torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"gae kernel launch failed: cudaError {rc}")
    gae_cuda.launches += 1
    return adv, ret


gae_cuda.launches = 0


def gae(rewards: torch.Tensor, values: torch.Tensor, dones: torch.Tensor,
        last_value: torch.Tensor, gamma: float = 0.99, lam: float = 0.95,
        *, impl: Optional[str] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Advantages + returns; see ``ref.gae_ref`` for semantics."""
    if not select.use_kernel(impl, rewards):
        return gae_ref(rewards, values, dones, last_value, gamma, lam)
    adv, ret = gae_cuda(_flatten_batch(rewards), _flatten_batch(values),
                        _flatten_batch(dones), last_value.reshape(-1),
                        gamma=gamma, lam=lam)
    return adv.reshape(rewards.shape), ret.reshape(rewards.shape)
