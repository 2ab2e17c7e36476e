"""The decode-attention op (port of
``repro/kernels/decode_attention/ops.py``), in the model's layout: q
``(B,K,G,hd)``, caches ``(B,Sc,K,hd)``, valid ``(Sc,)`` bool (or uint8 /
int32), out ``(B,K,G,hd)``.

A CPU tensor takes the plain version (``ref.decode_ref``, on the caches
transposed to its ``(B,K,Sc,hd)`` layout); a CUDA tensor launches the kernel
of ``csrc/decode_attention.cu`` (unless the mode is ``ref``), which reads the
caches in place by their strides: the reference's op transposes the whole
cache on every call, the kernel copies nothing. The kernel replaces the
Pallas ``decode_attention``
(``repro/kernels/decode_attention/decode_attention.py``) and takes any
``Sc`` up to ``MAX_SLOTS`` (its scores live in shared memory).
``decode_attention_cuda.launches`` counts its launches.

``models.attention.attention_decode_block`` calls ``decode_attention_cuda``
itself under the kernel mode; its plain path is the model's own ``decode``.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from repro_torch.kernels import build, select
from repro_torch.kernels.decode_attention.ref import decode_ref

HEAD_DIMS = (32, 64, 128)
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# the scores of one (b, h) in the 227 KB of shared memory a block may use,
# less the kernel's static arrays
MAX_SLOTS = (232448 - 1024) // 4

_I, _L, _P = ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = build.library("decode_attention")
    lib.decode_attention.argtypes = ([_I] * 6 + [ctypes.c_float]
                                     + [_P, _L, _P, _P, _L, _L, _P, _P, _P])
    lib.decode_attention.restype = ctypes.c_int
    return lib


def decode_attention_cuda(q: torch.Tensor, k_cache: torch.Tensor,
                          v_cache: torch.Tensor, valid: torch.Tensor
                          ) -> torch.Tensor:
    """Launch the kernel. q (B,K,G,hd) and the caches (B,Sc,K,hd), all
    float32 or all bfloat16 on one CUDA device, each with its head and
    feature dims packed; valid (Sc,) bool or uint8."""
    if q.dim() != 4 or k_cache.dim() != 4 or v_cache.shape != k_cache.shape:
        raise ValueError(f"decode_attention kernel: q must be (B,K,G,hd) "
                         f"and the caches (B,Sc,K,hd); got "
                         f"{tuple(q.shape)}, {tuple(k_cache.shape)}, "
                         f"{tuple(v_cache.shape)}")
    B, K, G, hd = q.shape
    Sc = k_cache.shape[1]
    if (k_cache.shape[0] != B or k_cache.shape[2] != K
            or k_cache.shape[3] != hd):
        raise ValueError(f"decode_attention kernel: caches "
                         f"{tuple(k_cache.shape)} do not match q "
                         f"{tuple(q.shape)}")
    if hd not in HEAD_DIMS:
        raise ValueError(f"decode_attention kernel: head_dim {hd} not in "
                         f"{HEAD_DIMS}")
    if (q.dtype not in DTYPES or k_cache.dtype != q.dtype
            or v_cache.dtype != q.dtype):
        raise ValueError(f"decode_attention kernel: q and the caches must "
                         f"all be float32 or all bfloat16; got {q.dtype}, "
                         f"{k_cache.dtype}, {v_cache.dtype}")
    if valid.shape != (Sc,) or valid.dtype not in (torch.bool, torch.uint8):
        raise ValueError(f"decode_attention kernel: valid must be a bool or "
                         f"uint8 ({Sc},) vector; got {valid.dtype} "
                         f"{tuple(valid.shape)}")
    dev = q.device
    if dev.type != "cuda" or any(t.device != dev
                                 for t in (k_cache, v_cache, valid)):
        raise ValueError("decode_attention kernel: q, the caches and valid "
                         "must lie on one CUDA device")
    if (q.stride()[1:] != (G * hd, hd, 1)
            or k_cache.stride()[2:] != (hd, 1)
            or v_cache.stride() != k_cache.stride()
            or not valid.is_contiguous()):
        raise ValueError(f"decode_attention kernel: head and feature dims "
                         f"must be packed and k, v share strides; got "
                         f"{q.stride()}, {k_cache.stride()}, "
                         f"{v_cache.stride()}")
    if Sc > MAX_SLOTS:
        raise ValueError(f"decode_attention kernel: {Sc} cache slots; at "
                         f"most {MAX_SLOTS}")
    o = torch.empty((B, K, G, hd), dtype=q.dtype, device=dev)
    if o.numel() == 0:
        return o
    rc = _lib().decode_attention(
        DTYPES[q.dtype], hd, B, K * G, Sc, G, hd ** -0.5, q.data_ptr(),
        q.stride(0), k_cache.data_ptr(), v_cache.data_ptr(),
        k_cache.stride(0), k_cache.stride(1), valid.data_ptr(), o.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"decode_attention kernel launch failed: "
                           f"cudaError {rc}")
    decode_attention_cuda.launches += 1
    return o


decode_attention_cuda.launches = 0


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, valid: torch.Tensor, *,
                     impl: Optional[str] = None) -> torch.Tensor:
    """Model layout in and out; see ``ref.decode_ref`` for the
    semantics."""
    if select.use_kernel(impl, q):
        return decode_attention_cuda(q, k_cache, v_cache, valid)
    B, K, G, hd = q.shape
    o = decode_ref(q.reshape(B, K * G, hd), k_cache.transpose(1, 2),
                   v_cache.transpose(1, 2), valid)
    return o.reshape(B, K, G, hd)
