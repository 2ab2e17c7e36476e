"""The sum-tree ops (port of ``repro/kernels/sum_tree/ops.py``).

The state is ``ref.SumTree``: the flat leaves-first layout the TPU kernels
take, kept flat on the device, with the levels as views. So no call
concatenates or splits levels (the reference's ops do, around each kernel).
A CPU tensor takes the plain version (``ref.py``); a CUDA tensor launches
the kernels of ``csrc/sum_tree.cu`` (unless the mode is ``ref``).

``sumtree_update`` writes into the tree in place and returns it.

The kernels replace ``sumtree_find_pallas`` and ``sumtree_update_pallas``
(``repro/kernels/sum_tree/sum_tree_pallas.py``). Both are exact. The bound
is HBM bytes of the nodes touched; the descent's time is the latency of
its dependent trips to global memory, one per 5 levels at the replay's
batch (``find_trips``). A find is one launch. An update is one host call
(one launch up to 256 indices, two above); its scratch, ``SumTree.winner``
on a CUDA tree, has the size the library gives (``update_scratch_size``).
``sumtree_find_cuda.launches`` and ``sumtree_update_cuda.launches`` count
calls.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from repro_torch.kernels import build, counts, select, stream
from repro_torch.kernels.sum_tree.ref import (  # noqa: F401
    SumTree,
    level_offsets,
    level_sizes,
    sumtree_find_batch_ref,
    sumtree_update_ref,
    tree_flatten,
    tree_unflatten,
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = build.library("sum_tree")
    lib.sumtree_find.argtypes = [_P, _P, _P, _L, _I, _I, _P]
    lib.sumtree_find.restype = _I
    lib.sumtree_update.argtypes = [_P, _P, _P, _P, _L, _I, _I, _P]
    lib.sumtree_update.restype = _I
    lib.sumtree_update_scratch.argtypes = [_L]
    lib.sumtree_update_scratch.restype = _L
    lib.sumtree_find_trips.argtypes = [_I, _I]
    lib.sumtree_find_trips.restype = _I
    return lib


def find_trips(capacity: int, batch: int) -> int:
    """The dependent global round trips the descent kernel makes per mass
    for ``batch`` masses in a tree of ``capacity`` leaves, as
    ``csrc/sum_tree.cu`` counts them."""
    return _lib().sumtree_find_trips(capacity.bit_length() - 1, batch)


@functools.cache
def update_scratch_size(capacity: int) -> int:
    """int32 entries of the update kernels' scratch for ``capacity``
    leaves, as ``csrc/sum_tree.cu`` lays it out."""
    return _lib().sumtree_update_scratch(capacity)


def _check(kernel: str, named, device) -> None:
    """Each ``(name, tensor, shape, dtype)`` must match, be contiguous and
    lie on the CUDA ``device``."""
    for name, x, shape, dtype in named:
        if (tuple(x.shape) != shape or x.dtype != dtype or x.device != device
                or device.type != "cuda" or not x.is_contiguous()):
            raise ValueError(
                f"{kernel} kernel: {name} must be a contiguous {dtype} tensor"
                f" of shape {shape} on a CUDA device ({device}); got "
                f"{x.dtype} {tuple(x.shape)} on {x.device}")


def _raise_on(rc: int, kernel: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{kernel} kernel launch failed: cudaError {rc}")


def _check_capacity(kernel: str, cap: int) -> None:
    if cap > 1 << 31:
        raise ValueError(f"{kernel} kernel: int32 indices address at most "
                         f"2^31 leaves; got capacity {cap}")


def sumtree_find_cuda(tree: SumTree, masses: torch.Tensor) -> torch.Tensor:
    """Launch the descent kernel: masses (B,) float32 -> leaf indices (B,)
    int32."""
    cap, dev = tree.capacity, tree.flat.device
    _check_capacity("sumtree_find", cap)
    B = masses.shape[0] if masses.dim() == 1 else -1
    _check("sumtree_find", [
        ("flat", tree.flat, (2 * cap - 1,), torch.float32),
        ("masses", masses, (B,), torch.float32)], dev)
    out = torch.empty(B, dtype=torch.int32, device=dev)
    if B == 0:
        return out
    rc = _lib().sumtree_find(tree.flat.data_ptr(), masses.data_ptr(),
                             out.data_ptr(), cap, cap.bit_length() - 1, B,
                             stream.current(dev))
    _raise_on(rc, "sumtree_find")
    counts.add(sumtree_find_cuda)
    return out


sumtree_find_cuda.launches = 0


def sumtree_update_cuda(tree: SumTree, idx: torch.Tensor,
                        values: torch.Tensor) -> SumTree:
    """Launch the update kernel, in place: idx (B,) int32 (one in
    ``[-cap, 0)`` counts from the end, one outside ``[-cap, cap)`` is
    dropped, as in the plain version), values (B,) float32."""
    cap, dev = tree.capacity, tree.flat.device
    _check_capacity("sumtree_update", cap)
    B = idx.shape[0] if idx.dim() == 1 else -1
    _check("sumtree_update", [
        ("flat", tree.flat, (2 * cap - 1,), torch.float32),
        ("winner", tree.winner, (update_scratch_size(cap),), torch.int32),
        ("idx", idx, (B,), torch.int32),
        ("values", values, (B,), torch.float32)], dev)
    if B == 0:
        return tree
    rc = _lib().sumtree_update(tree.flat.data_ptr(), tree.winner.data_ptr(),
                               idx.data_ptr(), values.data_ptr(), cap,
                               cap.bit_length() - 1, B, stream.current(dev))
    _raise_on(rc, "sumtree_update")
    counts.add(sumtree_update_cuda)
    return tree


sumtree_update_cuda.launches = 0


def sumtree_find_batch(tree: SumTree, masses: torch.Tensor, *,
                       impl: Optional[str] = None) -> torch.Tensor:
    """Stratified descent for a batch of masses -> int32 leaf indices."""
    if not select.use_kernel(impl, tree.flat):
        return sumtree_find_batch_ref(tree, masses)
    return sumtree_find_cuda(tree, masses.reshape(-1).to(torch.float32)
                             .contiguous()).reshape(masses.shape)


def sumtree_update(tree: SumTree, idx: torch.Tensor,
                   leaf_values: torch.Tensor, *,
                   impl: Optional[str] = None) -> SumTree:
    """Batched leaf write (last write wins among duplicate indices) and
    parent recomputation, in place; returns ``tree``."""
    if not select.use_kernel(impl, tree.flat):
        return sumtree_update_ref(tree, idx, leaf_values)
    return sumtree_update_cuda(
        tree, idx.reshape(-1).to(torch.int32).contiguous(),
        leaf_values.reshape(-1).to(torch.float32).contiguous())
