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
(``repro/kernels/decode_attention/decode_attention.py``) and, like it,
takes any ``Sc``: it splits the cache into chunks of slots across blocks
(``plan_chunk`` picks their size) and combines them in a second launch.
``decode_attention_cuda.launches`` counts calls of the op; each call is two
kernel launches (the split pass and the combine).

``models.attention.attention_decode_block`` calls ``decode_attention_cuda``
itself under the kernel mode; its plain path is the model's own ``decode``.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from repro_torch.kernels import build, counts, select, stream
from repro_torch.kernels.decode_attention.ref import decode_ref

HEAD_DIMS = (32, 64, 128)
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
SMS = 132                  # an H100 SXM's streaming multiprocessors
SUB_TILE = 32              # slots per sub-tile of the split pass

_I, _L, _P = ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = build.library("decode_attention")
    lib.decode_attention.argtypes = ([_I] * 7 + [ctypes.c_float]
                                     + [_P, _L, _P, _P, _L, _L, _P, _P, _P,
                                        _P])
    lib.decode_attention.restype = ctypes.c_int
    return lib


def plan_chunk(B: int, K: int, Sc: int, sms: int = SMS) -> int:
    """Slots per chunk of the split pass, which runs ``B * K *
    ceil(Sc / chunk)`` blocks. With ``T = ceil(sms / (B * K))`` chunks per
    (b, kv head) the blocks cover ``sms`` SMs; the chunk is the largest
    multiple of 32 of which ``Sc`` holds ``T`` whole ones,
    ``32 * floor(Sc / (32 * T))``, and 32 where ``Sc`` is too short for
    that. E.g. 64 slots (160 blocks) at B 1, K 5, Sc 2,048, and 32
    (120 blocks) at B 4, K 5, Sc 176."""
    per_head = -(-sms // (B * K))
    return SUB_TILE * max(1, Sc // (SUB_TILE * per_head))


@functools.cache
def _plan(B: int, K: int, G: int, hd: int, Sc: int, index: int):
    """(chunk, float32 scratch elements) of a call on device ``index``."""
    sms = torch.cuda.get_device_properties(index).multi_processor_count
    chunk = plan_chunk(B, K, Sc, sms)
    return chunk, B * K * G * max(1, -(-Sc // chunk)) * (hd + 2)


def decode_attention_cuda(q: torch.Tensor, k_cache: torch.Tensor,
                          v_cache: torch.Tensor, valid: torch.Tensor
                          ) -> torch.Tensor:
    """Launch the kernel (two launches: split and combine). q (B,K,G,hd)
    and the caches (B,Sc,K,hd), all float32 or all bfloat16 on one CUDA
    device, each with its head and feature dims packed and the caches' rows
    16-byte aligned; valid (Sc,) bool or uint8."""
    q_shape, c_shape = q.shape, k_cache.shape
    if len(q_shape) != 4 or len(c_shape) != 4 or v_cache.shape != c_shape:
        raise ValueError(f"decode_attention kernel: q must be (B,K,G,hd) "
                         f"and the caches (B,Sc,K,hd); got "
                         f"{tuple(q_shape)}, {tuple(c_shape)}, "
                         f"{tuple(v_cache.shape)}")
    B, K, G, hd = q_shape
    Sc = c_shape[1]
    if c_shape[0] != B or c_shape[2] != K or c_shape[3] != hd:
        raise ValueError(f"decode_attention kernel: caches "
                         f"{tuple(c_shape)} do not match q {tuple(q_shape)}")
    if hd not in HEAD_DIMS:
        raise ValueError(f"decode_attention kernel: head_dim {hd} not in "
                         f"{HEAD_DIMS}")
    dtype = q.dtype
    if (dtype not in DTYPES or k_cache.dtype != dtype
            or v_cache.dtype != dtype):
        raise ValueError(f"decode_attention kernel: q and the caches must "
                         f"all be float32 or all bfloat16; got {dtype}, "
                         f"{k_cache.dtype}, {v_cache.dtype}")
    if valid.shape != (Sc,) or valid.dtype not in (torch.bool, torch.uint8):
        raise ValueError(f"decode_attention kernel: valid must be a bool or "
                         f"uint8 ({Sc},) vector; got {valid.dtype} "
                         f"{tuple(valid.shape)}")
    dev = q.device
    if (dev.type != "cuda" or k_cache.device != dev
            or v_cache.device != dev or valid.device != dev):
        raise ValueError("decode_attention kernel: q, the caches and valid "
                         "must lie on one CUDA device")
    q_st, c_st = q.stride(), k_cache.stride()
    if (q_st[1:] != (G * hd, hd, 1) or c_st[2:] != (hd, 1)
            or v_cache.stride() != c_st or not valid.is_contiguous()):
        raise ValueError(f"decode_attention kernel: head and feature dims "
                         f"must be packed and k, v share strides; got "
                         f"{q_st}, {c_st}, {v_cache.stride()}")
    k_ptr, v_ptr = k_cache.data_ptr(), v_cache.data_ptr()
    per16 = 16 // k_cache.element_size()      # elements in 16 bytes
    if (k_ptr | v_ptr) % 16 or c_st[0] % per16 or c_st[1] % per16:
        raise ValueError(f"decode_attention kernel: the caches' rows must be "
                         f"16-byte aligned (16-byte copies); strides {c_st}")
    o = torch.empty_like(q)      # contiguous: q's inner dims are packed
    if o.numel() == 0:
        return o
    chunk, n_part = _plan(B, K, G, hd, Sc, dev.index)
    part = q.new_empty(n_part, dtype=torch.float32)
    rc = _lib().decode_attention(
        DTYPES[dtype], hd, B, K, G, Sc, chunk, hd ** -0.5, q.data_ptr(),
        q_st[0], k_ptr, v_ptr, c_st[0], c_st[1], valid.data_ptr(),
        part.data_ptr(), o.data_ptr(), stream.current(dev))
    if rc != 0:
        raise RuntimeError(f"decode_attention kernel launch failed: "
                           f"cudaError {rc}")
    counts.add(decode_attention_cuda)
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
