"""The flash-attention op (port of
``repro/kernels/flash_attention/ops.py``), in the model's layout: q
``(B,S,K,G,hd)``, k/v ``(B,S,K,hd)``, out like q.

A CPU tensor takes the plain version (``ref.attention_ref``, transposed to
its ``(B,H,S,hd)`` layout and back); a CUDA tensor launches the kernel of
``csrc/flash_attention.cu`` (unless the mode is ``ref``), which reads the
model layout in place by its strides. The kernel replaces the Pallas
``flash_attention`` (``repro/kernels/flash_attention/flash_attention.py``);
unlike it, it takes any ``Sq`` and ``Skv`` (no block multiples) and counts
query rows and key columns both from 0. ``flash_attention_cuda.launches``
counts its launches.

``models.attention.attention_block`` calls ``flash_attention_cuda`` itself
under the kernel mode; its plain path is the model's own ``swa`` /
``full_causal``.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from repro_torch.kernels import build, select
from repro_torch.kernels.flash_attention.ref import attention_ref

HEAD_DIMS = (32, 64, 128)
DTYPES = {torch.float32: 0, torch.bfloat16: 1}

_I, _L, _P = ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = build.library("flash_attention")
    lib.flash_attention.argtypes = ([_I] * 9 + [ctypes.c_float]
                                    + [_P, _L, _L, _P, _P, _L, _L,
                                       _P, _L, _L, _P])
    lib.flash_attention.restype = ctypes.c_int
    return lib


def _check_packed(name: str, t: torch.Tensor, lead: int) -> None:
    """Dims after the first ``lead`` (heads, hd) must be packed: the kernel
    reads a row's heads at ``head * hd``."""
    inner = t.shape[lead:]
    expected = 1
    for size, stride in zip(reversed(inner), reversed(t.stride()[lead:])):
        if size > 1 and stride != expected:
            raise ValueError(f"flash_attention kernel: {name}'s head and "
                             f"feature dims must be packed; strides "
                             f"{t.stride()}")
        expected *= size


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, causal: bool = True, window: int = 0
                         ) -> torch.Tensor:
    """Launch the kernel. q (B,Sq,K,G,hd), k/v (B,Skv,K,hd), all float32
    or all bfloat16 on one CUDA device; hd in ``HEAD_DIMS``."""
    if q.dim() != 5 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"flash_attention kernel: q must be (B,S,K,G,hd) "
                         f"and k, v (B,S,K,hd); got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    B, Sq, K, G, hd = q.shape
    Skv = k.shape[1]
    if k.shape[0] != B or k.shape[2] != K or k.shape[3] != hd:
        raise ValueError(f"flash_attention kernel: k/v {tuple(k.shape)} "
                         f"do not match q {tuple(q.shape)}")
    if hd not in HEAD_DIMS:
        raise ValueError(f"flash_attention kernel: head_dim {hd} not in "
                         f"{HEAD_DIMS}")
    if q.dtype not in DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"flash_attention kernel: q, k, v must all be "
                         f"float32 or all bfloat16; got {q.dtype}, "
                         f"{k.dtype}, {v.dtype}")
    dev = q.device
    if dev.type != "cuda" or k.device != dev or v.device != dev:
        raise ValueError(f"flash_attention kernel: q, k, v must lie on one "
                         f"CUDA device; got {q.device}, {k.device}, "
                         f"{v.device}")
    if k.stride() != v.stride():
        raise ValueError("flash_attention kernel: k and v must share strides")
    _check_packed("q", q, 2)
    _check_packed("k", k, 2)
    o = torch.empty((B, Sq, K, G, hd), dtype=q.dtype, device=dev)
    if o.numel() == 0:
        return o
    rc = _lib().flash_attention(
        DTYPES[q.dtype], hd, B, K * G, Sq, Skv, G, int(causal), int(window),
        hd ** -0.5, q.data_ptr(), q.stride(0), q.stride(1), k.data_ptr(),
        v.data_ptr(), k.stride(0), k.stride(1), o.data_ptr(), o.stride(0),
        o.stride(1), torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: "
                           f"cudaError {rc}")
    flash_attention_cuda.launches += 1
    return o


flash_attention_cuda.launches = 0


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0,
                    impl: Optional[str] = None) -> torch.Tensor:
    """Model layout in and out; see ``ref.attention_ref`` for the
    semantics (``Sq == Skv``)."""
    if select.use_kernel(impl, q):
        return flash_attention_cuda(q, k, v, causal=causal, window=window)
    B, S, K, G, hd = q.shape
    o = attention_ref(q.reshape(B, S, K * G, hd).transpose(1, 2),
                      k.transpose(1, 2), v.transpose(1, 2), causal=causal,
                      window=window)
    return o.transpose(1, 2).reshape(B, S, K, G, hd)
