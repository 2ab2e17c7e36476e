"""The replay-ring ops (port of ``repro/kernels/replay_ring/ops.py``).

Dict-of-leaves layout, as ``data/replay.py`` stores it: each leaf is
``(capacity, ...)``. A CPU tensor takes the plain version (``ref.py``); a
CUDA tensor launches the kernels of ``csrc/replay_ring.cu`` (unless the mode
is ``ref``), one launch per leaf, each leaf seen as ``(capacity,
row_bytes)``.

``ring_insert`` writes into ``storage`` in place and returns it (the TPU
kernel aliases storage to its output; the reference returns a new dict).

The kernels replace ``ring_insert_pallas`` and ``ring_gather_pallas``
(``repro/kernels/replay_ring/replay_ring_pallas.py``). They only move bytes,
so they are exact for every dtype and bound by HBM bytes: each copied row
read once and written once. ``ring_insert_cuda.launches`` and
``ring_gather_cuda.launches`` count their launches.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Dict, Optional

import torch

from repro_torch.kernels import build, select, stream
from repro_torch.kernels.replay_ring.ref import ring_gather_ref, ring_insert_ref

_P = ctypes.c_void_p
_L = ctypes.c_longlong


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = build.library("replay_ring")
    lib.ring_insert.argtypes = [_P, _P, _L, _L, _L, _L, _P]
    lib.ring_insert.restype = ctypes.c_int
    lib.ring_gather.argtypes = [_P, _P, _P, _L, _L, _L, _P]
    lib.ring_gather.restype = ctypes.c_int
    return lib


def _row_bytes(storage: torch.Tensor) -> int:
    return storage[0].numel() * storage.element_size()


def _check_storage(kernel: str, storage: torch.Tensor) -> None:
    if (storage.dim() < 1 or storage.shape[0] < 1
            or storage.device.type != "cuda" or not storage.is_contiguous()):
        raise ValueError(
            f"{kernel} kernel: storage must be a contiguous CUDA tensor of "
            f"shape (capacity >= 1, ...); got {storage.dtype} "
            f"{tuple(storage.shape)} on {storage.device}")


def _raise_on(rc: int, kernel: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{kernel} kernel launch failed: cudaError {rc}")


def ring_insert_cuda(storage: torch.Tensor, batch: torch.Tensor,
                     start: int) -> torch.Tensor:
    """Launch the insert kernel on one leaf: batch row j to slot
    ``(start + j) % cap`` of ``storage``, in place. ``batch`` (N, ...) has
    storage's dtype, trailing shape and device and is contiguous."""
    _check_storage("ring_insert", storage)
    if (batch.dtype != storage.dtype or batch.device != storage.device
            or batch.shape[1:] != storage.shape[1:]
            or not batch.is_contiguous()):
        raise ValueError(
            f"ring_insert kernel: batch must be a contiguous "
            f"{storage.dtype} tensor of shape (N, "
            f"{', '.join(map(str, storage.shape[1:]))}) on {storage.device};"
            f" got {batch.dtype} {tuple(batch.shape)} on {batch.device}")
    cap, n = storage.shape[0], batch.shape[0]
    row_bytes = _row_bytes(storage)
    if n == 0 or row_bytes == 0:
        return storage
    rc = _lib().ring_insert(
        storage.data_ptr(), batch.data_ptr(), cap, n, int(start) % cap,
        row_bytes, stream.current(storage.device))
    _raise_on(rc, "ring_insert")
    ring_insert_cuda.launches += 1
    return storage


ring_insert_cuda.launches = 0


def ring_gather_cuda(storage: torch.Tensor, idx: torch.Tensor
                     ) -> torch.Tensor:
    """Launch the gather kernel on one leaf: ``(B, ...)`` rows of
    ``storage`` at ``idx`` (B,) int32 (indexed as jnp does: negative from
    the end, then clamped into ``[0, cap)``)."""
    _check_storage("ring_gather", storage)
    if (idx.dim() != 1 or idx.dtype != torch.int32
            or idx.device != storage.device or not idx.is_contiguous()):
        raise ValueError(
            f"ring_gather kernel: idx must be a contiguous int32 tensor of "
            f"shape (B,) on {storage.device}; got {idx.dtype} "
            f"{tuple(idx.shape)} on {idx.device}")
    out = torch.empty((idx.shape[0],) + tuple(storage.shape[1:]),
                      dtype=storage.dtype, device=storage.device)
    row_bytes = _row_bytes(storage)
    if idx.shape[0] == 0 or row_bytes == 0:
        return out
    rc = _lib().ring_gather(
        out.data_ptr(), storage.data_ptr(), idx.data_ptr(), storage.shape[0],
        idx.shape[0], row_bytes,
        stream.current(storage.device))
    _raise_on(rc, "ring_gather")
    ring_gather_cuda.launches += 1
    return out


ring_gather_cuda.launches = 0


def ring_insert(storage: Dict[str, torch.Tensor],
                batch: Dict[str, torch.Tensor], start: int, *,
                impl: Optional[str] = None) -> Dict[str, torch.Tensor]:
    """Insert (N, ...) rows at the ring head ``start`` (wraps), in place;
    returns ``storage``. Batch leaves are cast to the storage dtype."""
    if not select.use_kernel(impl, next(iter(storage.values()))):
        return ring_insert_ref(storage, batch, start)
    for k, dst in storage.items():
        ring_insert_cuda(dst, batch[k].to(dst.dtype).contiguous(), start)
    return storage


def ring_gather(storage: Dict[str, torch.Tensor], idx: torch.Tensor, *,
                impl: Optional[str] = None) -> Dict[str, torch.Tensor]:
    """The rows at ``idx`` (B,) from every leaf."""
    if not select.use_kernel(impl, next(iter(storage.values()))):
        return ring_gather_ref(storage, idx)
    idx = idx.to(torch.int32).contiguous()
    return {k: ring_gather_cuda(v, idx) for k, v in storage.items()}
