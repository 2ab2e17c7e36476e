"""The replay-ring ops (port of ``repro/kernels/replay_ring/ops.py``).

Dict-of-leaves layout, as ``data/replay.py`` stores it: each leaf is
``(capacity, ...)``. A CPU tensor takes the plain version (``ref.py``); a
CUDA tensor launches the kernels of ``csrc/replay_ring.cu`` (unless the mode
is ``ref``), which replace ``ring_insert_pallas`` and ``ring_gather_pallas``
(``repro/kernels/replay_ring/replay_ring_pallas.py``).

The kernels only move bytes, so they are exact for every dtype and bound by
HBM bytes: each copied row read once and written once. At the main path's
shapes a launch per leaf cost more than the bytes, so each op is one host
call and one launch for all the leaves of a storage dict (at most
``MAX_LEAVES``), its table passed by value: both ops can be captured in a
CUDA graph. An insert copies one contiguous span of rows per leaf
(``insert_spans``) into the ring from the head ``start``, which may be a
0-dim tensor on the device: the kernel reads it there and does the wrap
itself, so a ring whose head lives on the device is written without a
host read. A gather reads each
row's index once and writes every leaf's rows into one byte buffer
(``gather_layout``), returned as per-leaf views. The plans are pure Python,
and a storage dict is checked once per distinct set of leaves.
``ring_insert_cuda.launches`` and ``ring_gather_cuda.launches`` count
launches, one per op call that copies anything.

``ring_insert`` writes into ``storage`` in place and returns it (the TPU
kernel aliases storage to its output; the reference returns a new dict).
"""
from __future__ import annotations

import array
import ctypes
import functools
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple, Union

import torch

from repro_torch.kernels import build, counts, select, stream
from repro_torch.kernels.replay_ring.ref import ring_gather_ref, ring_insert_ref

MAX_LEAVES = 16          # kMaxLeaves of csrc/replay_ring.cu
GATHER_TILE_ROWS = 8     # kTileRows: the gather kernel's rows per block
ALIGN = 16               # byte alignment of each leaf's gather output

_P = ctypes.c_void_p
_L = ctypes.c_longlong


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = build.library("replay_ring")
    lib.ring_insert.argtypes = [_P, ctypes.c_int, _P, _L, _L, _P]
    lib.ring_insert.restype = ctypes.c_int
    lib.ring_gather.argtypes = [_P, ctypes.c_int, _P, _P, _L, _L, _P]
    lib.ring_gather.restype = ctypes.c_int
    return lib


def insert_spans(row_bytes: Sequence[int], cap: int, n: int
                 ) -> List[Tuple[int, int, int]]:
    """The source span ``(leaf, src_offset, nbytes)`` of each leaf that an
    insert of ``n`` rows into leaves of ``cap`` rows of ``row_bytes`` each
    copies: the rows ``j >= n - cap`` (the last writes win when ``n >
    cap``), none for a leaf of zero-width rows or an empty insert. Byte
    ``o`` of a leaf's span lands at byte ``(head * rb + o) % (cap * rb)``
    of that leaf, where ``head = (start + max(0, n - cap)) % cap`` is the
    slot of the first copied row, which the kernel computes from the start
    it reads."""
    first = max(0, n - cap)
    return [(leaf, first * rb, (n - first) * rb)
            for leaf, rb in enumerate(row_bytes) if rb and n > first]


def gather_layout(row_bytes: Sequence[int], rows: int
                  ) -> Tuple[List[int], int]:
    """(byte offset of each leaf's ``(rows, ...)`` block, total bytes) of a
    gather's one output buffer: the blocks in leaf order, each starting at a
    multiple of ``ALIGN``."""
    offsets, end = [], 0
    for rb in row_bytes:
        offsets.append(-(-end // ALIGN) * ALIGN)
        end = offsets[-1] + rows * rb
    return offsets, -(-end // ALIGN) * ALIGN


class Leaves(NamedTuple):
    """What the kernels need of a storage dict's leaves."""
    cap: int
    device: torch.device
    dtypes: Tuple[torch.dtype, ...]
    trailing: Tuple[Tuple[int, ...], ...]
    strides: Tuple[Tuple[int, ...], ...]
    row_bytes: Tuple[int, ...]
    ptrs: Tuple[int, ...]

    @classmethod
    def of(cls, leaves: Sequence[torch.Tensor]) -> "Leaves":
        return cls(leaves[0].shape[0], leaves[0].device,
                   tuple(t.dtype for t in leaves),
                   tuple(tuple(t.shape[1:]) for t in leaves),
                   tuple(t.stride() for t in leaves),
                   tuple(t[0].numel() * t.element_size() for t in leaves),
                   tuple(t.data_ptr() for t in leaves))


@functools.lru_cache(maxsize=64)
def gather_plan(leaves: Leaves, rows: int):
    """(bytes of the output buffer, each leaf's view of it as ``(dtype,
    shape, stride, storage offset in elements)``, the kernel's table of
    ``(storage pointer, output byte offset, row bytes)`` for the leaves of
    nonzero width) of a gather of ``rows`` rows, laid out by
    ``gather_layout``."""
    offsets, total = gather_layout(leaves.row_bytes, rows)
    views = tuple((dtype, (rows,) + shape, stride, off // dtype.itemsize)
                  for dtype, shape, stride, off in zip(
                      leaves.dtypes, leaves.trailing, leaves.strides,
                      offsets))
    table = array.array("q", [
        x for ptr, off, rb in zip(leaves.ptrs, offsets, leaves.row_bytes)
        if rb for x in (ptr, off, rb)])
    return total, views, table


def gather_views(buf: torch.Tensor, views) -> List[torch.Tensor]:
    """The leaves' views of a gather's byte buffer ``buf`` (``gather_plan``'s
    ``views``): ``buf`` is viewed once per distinct dtype (its length is a
    multiple of ``ALIGN``), and each leaf's block is cut from that with
    ``as_strided``."""
    typed, out = {}, []
    for dtype, shape, stride, offset in views:
        t = typed.get(dtype)
        if t is None:
            t = typed[dtype] = buf.view(dtype)
        out.append(t.as_strided(shape, stride, offset))
    return out


_checked: Dict[tuple, Leaves] = {}


def _check_storage(kernel: str, storage: Dict[str, torch.Tensor]) -> Leaves:
    if not 1 <= len(storage) <= MAX_LEAVES:
        raise ValueError(f"{kernel} kernel: storage must have 1 to "
                         f"{MAX_LEAVES} leaves (the kernel's table holds "
                         f"MAX_LEAVES = {MAX_LEAVES}); got {len(storage)}")
    leaves = list(storage.values())
    for t in leaves:
        if (t.dim() < 1 or t.shape[0] < 1 or t.device.type != "cuda"
                or not t.is_contiguous()):
            raise ValueError(
                f"{kernel} kernel: storage must be contiguous CUDA tensors "
                f"of shape (capacity >= 1, ...); got {t.dtype} "
                f"{tuple(t.shape)} on {t.device}")
    cap, device = leaves[0].shape[0], leaves[0].device
    if any(t.shape[0] != cap or t.device != device for t in leaves):
        raise ValueError(
            f"{kernel} kernel: storage leaves must share one capacity and "
            f"device; got {[(tuple(t.shape), str(t.device)) for t in leaves]}")
    plan = Leaves.of(leaves)
    if sum(plan.row_bytes) * GATHER_TILE_ROWS >= 1 << 31:
        raise ValueError(f"{kernel} kernel: rows of {sum(plan.row_bytes)} "
                         f"bytes are too wide")
    return plan


def _leaves(kernel: str, storage: Dict[str, torch.Tensor]) -> Leaves:
    """``storage`` checked, once per distinct set of leaves (pointer, shape,
    dtype, contiguity): the check is all a plan depends on."""
    key = tuple((t.data_ptr(), t.shape, t.dtype, t.is_contiguous())
                for t in storage.values())
    hit = _checked.get(key)
    if hit is None:
        hit = _check_storage(kernel, storage)
        if len(_checked) >= 64:
            _checked.clear()
        _checked[key] = hit
    return hit


def _raise_on(rc: int, kernel: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{kernel} kernel launch failed: cudaError {rc}")


Start = Union[int, torch.Tensor]


def _start_on(start: Start, device: torch.device) -> torch.Tensor:
    """The head as the 0-dim int32 on ``device`` that the insert kernel
    reads (a replay ring's own head is one already): a host int is written
    there by a fill, since a copy from the host could not be captured in a
    CUDA graph."""
    if not isinstance(start, torch.Tensor):
        return torch.full((), int(start), dtype=torch.int32, device=device)
    if (start.dim() != 0 or start.device != device
            or start.dtype.is_floating_point or start.dtype == torch.bool):
        raise ValueError(
            f"ring_insert: start must be an int or a 0-dim integer tensor "
            f"on {device}; got {start.dtype} {tuple(start.shape)} on "
            f"{start.device}")
    return start if start.dtype == torch.int32 else start.to(torch.int32)


def ring_insert_cuda(storage: Dict[str, torch.Tensor],
                     batch: Dict[str, torch.Tensor], start: Start
                     ) -> Dict[str, torch.Tensor]:
    """Launch the insert kernel once, for all the leaves: batch row j to
    slot ``(start + j) % cap`` of each leaf of ``storage``, in place.
    ``start`` is an int or a 0-dim integer tensor on the storage's device,
    which the kernel reads there. Each batch leaf (N, ...) has its storage
    leaf's dtype, trailing shape and device and is contiguous, with one N
    for all."""
    leaves = _leaves("ring_insert", storage)
    index = leaves.device.index
    n = None
    src = []
    for k, dtype, trailing in zip(storage, leaves.dtypes, leaves.trailing):
        b = batch[k]
        if n is None:
            n = b.shape[0] if b.dim() else -1
        if (b.dtype != dtype or b.dim() == 0 or b.shape[0] != n
                or b.shape[1:] != trailing or b.get_device() != index
                or not b.is_contiguous()):
            raise ValueError(
                f"ring_insert kernel: batch leaf {k!r} must be a contiguous "
                f"{dtype} tensor of shape (N, "
                f"{', '.join(map(str, trailing))}) on {leaves.device}, one "
                f"N for all leaves; got {b.dtype} {tuple(b.shape)} on "
                f"{b.device}")
        src.append(b.data_ptr())
    spans = insert_spans(leaves.row_bytes, leaves.cap, n)
    if not spans:
        return storage
    start = _start_on(start, leaves.device)
    table = array.array("q", [
        x for leaf, off, nbytes in spans
        for x in (src[leaf] + off, leaves.ptrs[leaf], nbytes,
                  leaves.row_bytes[leaf])])
    _raise_on(_lib().ring_insert(
        table.buffer_info()[0], len(spans), start.data_ptr(),
        max(0, n - leaves.cap), leaves.cap, stream.current(leaves.device)),
        "ring_insert")
    counts.add(ring_insert_cuda)
    return storage


ring_insert_cuda.launches = 0


def ring_gather_cuda(storage: Dict[str, torch.Tensor], idx: torch.Tensor
                     ) -> Dict[str, torch.Tensor]:
    """Launch the gather kernel once, for all the leaves: the ``(B, ...)``
    rows of each leaf of ``storage`` at ``idx`` (B,) int32 (indexed as jnp
    does: negative from the end, then clamped into ``[0, cap)``), as views
    of one output buffer."""
    leaves = _leaves("ring_gather", storage)
    if (idx.dim() != 1 or idx.dtype != torch.int32
            or idx.get_device() != leaves.device.index
            or not idx.is_contiguous()):
        raise ValueError(
            f"ring_gather kernel: idx must be a contiguous int32 tensor of "
            f"shape (B,) on {leaves.device}; got {idx.dtype} "
            f"{tuple(idx.shape)} on {idx.device}")
    rows = idx.shape[0]
    total, views, table = gather_plan(leaves, rows)
    buf = torch.empty(total, dtype=torch.uint8, device=leaves.device)
    if rows and table:
        _raise_on(_lib().ring_gather(
            table.buffer_info()[0], len(table) // 3, buf.data_ptr(),
            idx.data_ptr(), leaves.cap, rows, stream.current(leaves.device)),
            "ring_gather")
        counts.add(ring_gather_cuda)
    return dict(zip(storage, gather_views(buf, views)))


ring_gather_cuda.launches = 0


def ring_insert(storage: Dict[str, torch.Tensor],
                batch: Dict[str, torch.Tensor], start: Start, *,
                impl: Optional[str] = None) -> Dict[str, torch.Tensor]:
    """Insert (N, ...) rows at the ring head ``start`` (an int or a 0-dim
    integer tensor on the storage's device; wraps), in place; returns
    ``storage``. Batch leaves are cast to the storage dtype."""
    if not select.use_kernel(impl, next(iter(storage.values()))):
        return ring_insert_ref(storage, batch, start)
    return ring_insert_cuda(storage, {
        k: _cast(batch[k], dst.dtype) for k, dst in storage.items()}, start)


def _cast(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    # ``.to`` costs host time even when it returns ``x`` itself
    return (x if x.dtype == dtype else x.to(dtype)).contiguous()


def ring_gather(storage: Dict[str, torch.Tensor], idx: torch.Tensor, *,
                impl: Optional[str] = None) -> Dict[str, torch.Tensor]:
    """The rows at ``idx`` (B,) from every leaf."""
    if not select.use_kernel(impl, next(iter(storage.values()))):
        return ring_gather_ref(storage, idx)
    return ring_gather_cuda(storage, _cast(idx, torch.int32))
