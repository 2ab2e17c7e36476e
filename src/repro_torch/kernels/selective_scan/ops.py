"""The selective-scan op (port of ``repro/kernels/selective_scan/ops.py``).

``selective_scan`` takes the reference's layout (all float32): dt/x
``(B,S,Di)``, A ``(Di,N)``, b/c ``(B,S,N)``, h0 ``(B,Di,N)``, and returns
``(y (B,S,Di), h_final (B,Di,N))``. A CPU tensor takes the plain version
(``ref.py``, the sequential recurrence); a CUDA tensor launches the kernel
of ``csrc/selective_scan.cu`` (unless the mode is ``ref``).

The kernel replaces the Pallas ``selective_scan``
(``repro/kernels/selective_scan/selective_scan.py``). Unlike that kernel it
takes any ``Di`` and any ``S`` (no block or chunk multiples) and a state of
at most ``MAX_STATE`` entries per channel. ``selective_scan_cuda.launches``
counts its launches.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from repro_torch.kernels import build, select
from repro_torch.kernels.selective_scan.ref import selective_scan_ref

MAX_STATE = 16          # the kernel holds h[N] in registers


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = build.library("selective_scan")
    lib.selective_scan.argtypes = ([ctypes.c_int] * 4
                                   + [ctypes.c_void_p] * 9)
    lib.selective_scan.restype = ctypes.c_int
    return lib


def selective_scan_cuda(dt: torch.Tensor, A: torch.Tensor, b: torch.Tensor,
                        c: torch.Tensor, x: torch.Tensor, h0: torch.Tensor
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the scan kernel on contiguous float32 CUDA tensors of the
    shapes above."""
    B, S, Di = x.shape
    N = A.shape[-1]
    dev = x.device
    for name, t, shape in (("dt", dt, (B, S, Di)), ("A", A, (Di, N)),
                           ("b", b, (B, S, N)), ("c", c, (B, S, N)),
                           ("x", x, (B, S, Di)), ("h0", h0, (B, Di, N))):
        if (tuple(t.shape) != shape or t.dtype != torch.float32
                or t.device != dev or not t.is_contiguous()):
            raise ValueError(
                f"selective_scan kernel: {name} must be a contiguous float32 "
                f"tensor of shape {shape} on {dev}; got {t.dtype} "
                f"{tuple(t.shape)} on {t.device}")
    if dev.type != "cuda":
        raise ValueError(f"selective_scan kernel: tensors on {dev}, not cuda")
    if not 1 <= N <= MAX_STATE:
        raise ValueError(f"selective_scan kernel: state size N={N} outside "
                         f"[1, {MAX_STATE}]")
    y = torch.empty_like(x)
    h_final = torch.empty_like(h0)
    if B == 0 or Di == 0:
        return y, h_final
    rc = _lib().selective_scan(
        B, S, Di, N, dt.data_ptr(), A.data_ptr(), b.data_ptr(), c.data_ptr(),
        x.data_ptr(), h0.data_ptr(), y.data_ptr(), h_final.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"selective_scan kernel launch failed: "
                           f"cudaError {rc}")
    selective_scan_cuda.launches += 1
    return y, h_final


selective_scan_cuda.launches = 0


def selective_scan(dt: torch.Tensor, A: torch.Tensor, b: torch.Tensor,
                   c: torch.Tensor, x: torch.Tensor, h0: torch.Tensor, *,
                   impl: Optional[str] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The Mamba1 scan; see ``ref.selective_scan_ref`` for the semantics.
    The kernel gets contiguous copies of strided inputs."""
    if not select.use_kernel(impl, x):
        return selective_scan_ref(dt, A, b, c, x, h0)
    return selective_scan_cuda(*(t.contiguous() for t in (dt, A, b, c, x,
                                                          h0)))
