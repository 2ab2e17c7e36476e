"""The flash-attention op (port of
``repro/kernels/flash_attention/ops.py``), in the model's layout: q
``(B,S,K,G,hd)``, k/v ``(B,S,K,hd)``, out like q.

A CPU tensor takes the plain version (``ref.attention_ref``, transposed to
its ``(B,H,S,hd)`` layout and back); a CUDA tensor launches the kernel of
``csrc/flash_attention.cu`` (unless the mode is ``ref``), which reads the
model layout in place by its strides. The kernel replaces the Pallas
``flash_attention`` (``repro/kernels/flash_attention/flash_attention.py``);
like it, it takes one sequence length for q and k/v (both paths raise
otherwise), but any length, not only block multiples. By dtype: bfloat16
runs on the tensor cores (``wgmma``, tiles brought in by TMA), float32 on
the CUDA cores (the tensor cores have no full-float32 mode); neither is a
fallback for the other. ``flash_attention_cuda.launches`` counts its
launches.

``models.attention.attention_block`` calls ``flash_attention_cuda`` itself
under the kernel mode; its plain path is the model's own ``swa`` /
``full_causal``.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from repro_torch.kernels import build, counts, select, stream
from repro_torch.kernels.flash_attention.ref import attention_ref

HEAD_DIMS = (32, 64, 128)
DTYPES = {torch.float32: 0, torch.bfloat16: 1}

_I, _L, _P = ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = build.library("flash_attention")
    lib.flash_attention.argtypes = ([_I] * 8 + [ctypes.c_float]
                                    + [_P, _L, _L, _P, _P, _L, _L,
                                       _P, _L, _L, _P])
    lib.flash_attention.restype = ctypes.c_int
    return lib


def _check_one_length(q_shape, k_shape) -> None:
    if len(q_shape) >= 2 and len(k_shape) >= 2 and q_shape[1] != k_shape[1]:
        raise ValueError(f"flash_attention: q and k/v must have one sequence "
                         f"length (prefill); got {q_shape[1]} and "
                         f"{k_shape[1]}")


def _check_packed(name: str, shape, strides) -> None:
    """The head and feature dims (after batch and sequence) must be packed:
    the kernel reads a row's heads at ``head * hd``. (A dim of length 1 may
    carry any stride.)"""
    expected = 1
    for size, stride in zip(reversed(shape[2:]), reversed(strides[2:])):
        if size > 1 and stride != expected:
            raise ValueError(f"flash_attention kernel: {name}'s head and "
                             f"feature dims must be packed; strides "
                             f"{strides}")
        expected *= size


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, causal: bool = True, window: int = 0
                         ) -> torch.Tensor:
    """Launch the kernel. q (B,S,K,G,hd), k/v (B,S,K,hd), all float32 or
    all bfloat16 on one CUDA device; hd in ``HEAD_DIMS``; in bfloat16 the
    tensors 16-byte aligned, with batch and sequence strides that are
    multiples of 16 bytes (the TMA tensor maps need them)."""
    q_shape, k_shape = q.shape, k.shape
    _check_one_length(q_shape, k_shape)
    if len(q_shape) != 5 or len(k_shape) != 4 or v.shape != k_shape:
        raise ValueError(f"flash_attention kernel: q must be (B,S,K,G,hd) "
                         f"and k, v (B,S,K,hd); got {tuple(q_shape)}, "
                         f"{tuple(k_shape)}, {tuple(v.shape)}")
    B, S, K, G, hd = q_shape
    if k_shape[0] != B or k_shape[2] != K or k_shape[3] != hd:
        raise ValueError(f"flash_attention kernel: k/v {tuple(k_shape)} "
                         f"do not match q {tuple(q_shape)}")
    if hd not in HEAD_DIMS:
        raise ValueError(f"flash_attention kernel: head_dim {hd} not in "
                         f"{HEAD_DIMS}")
    dtype = q.dtype
    if dtype not in DTYPES or k.dtype != dtype or v.dtype != dtype:
        raise ValueError(f"flash_attention kernel: q, k, v must all be "
                         f"float32 or all bfloat16; got {dtype}, "
                         f"{k.dtype}, {v.dtype}")
    dev = q.device
    if dev.type != "cuda" or k.device != dev or v.device != dev:
        raise ValueError(f"flash_attention kernel: q, k, v must lie on one "
                         f"CUDA device; got {dev}, {k.device}, {v.device}")
    q_st, k_st = q.stride(), k.stride()
    if v.stride() != k_st:
        raise ValueError("flash_attention kernel: k and v must share strides")
    if q_st[2:] != (G * hd, hd, 1):
        _check_packed("q", q_shape, q_st)
    if k_st[2:] != (hd, 1):
        _check_packed("k", k_shape, k_st)
    q_ptr, k_ptr, v_ptr = q.data_ptr(), k.data_ptr(), v.data_ptr()
    if dtype == torch.bfloat16 and (
            (q_ptr | k_ptr | v_ptr) % 16
            or (B > 1 and (q_st[0] % 8 or k_st[0] % 8))
            or (S > 1 and (q_st[1] % 8 or k_st[1] % 8))):
        raise ValueError(f"flash_attention kernel: bfloat16 q, k, v must be "
                         f"16-byte aligned, with batch and sequence strides "
                         f"that are multiples of 16 bytes (TMA); strides "
                         f"{q_st}, {k_st}")
    o = torch.empty_like(q)      # q's layout: heads and features packed
    if o.numel() == 0:
        return o
    o_st = o.stride()
    rc = _lib().flash_attention(
        DTYPES[dtype], hd, B, K * G, S, G, int(causal), int(window),
        hd ** -0.5, q_ptr, q_st[0], q_st[1], k_ptr, v_ptr, k_st[0], k_st[1],
        o.data_ptr(), o_st[0], o_st[1], stream.current(dev))
    if rc != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: "
                           f"cudaError {rc}")
    counts.add(flash_attention_cuda)
    return o


flash_attention_cuda.launches = 0


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0,
                    impl: Optional[str] = None) -> torch.Tensor:
    """Model layout in and out; see ``ref.attention_ref`` for the
    semantics. q and k/v must have one sequence length."""
    _check_one_length(q.shape, k.shape)
    if select.use_kernel(impl, q):
        return flash_attention_cuda(q, k, v, causal=causal, window=window)
    B, S, K, G, hd = q.shape
    o = attention_ref(q.reshape(B, S, K * G, hd).transpose(1, 2),
                      k.transpose(1, 2), v.transpose(1, 2), causal=causal,
                      window=window)
    return o.transpose(1, 2).reshape(B, S, K, G, hd)
