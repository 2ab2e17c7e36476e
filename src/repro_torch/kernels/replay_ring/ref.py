"""Plain PyTorch versions of the replay-ring ops (port of
``repro/kernels/replay_ring/ref.py``).

Storage is a dict of leaves, each ``(capacity, ...)``. Unlike the
reference, ``ring_insert_ref`` writes into ``storage`` in place (the TPU
kernel aliases storage to its output for the same reason: the ring is the
largest buffer of the plane) and returns it.
"""
from __future__ import annotations

from typing import Dict, Union

import torch


def ring_insert_ref(storage: Dict[str, torch.Tensor],
                    batch: Dict[str, torch.Tensor],
                    start: Union[int, torch.Tensor]
                    ) -> Dict[str, torch.Tensor]:
    """Write (N, ...) rows at the ring head ``start`` (wrapping), in place.

    The reference scatters row j to ``(start + j) % cap`` in order, so when
    N > cap the last write to a slot wins. Duplicate indices in a PyTorch
    index assignment are undefined, so only rows ``j >= N - cap`` are
    written: each slot once, with the row that wins in the reference.
    ``start`` may be a 0-dim integer tensor on the storage's device: the
    slots are computed from it there, so nothing is read on the host."""
    dst0 = next(iter(storage.values()))
    cap, device = dst0.shape[0], dst0.device
    n = next(iter(batch.values())).shape[0]
    first = max(0, n - cap)
    if n == first:
        return storage
    start = (start.to(torch.int64) if isinstance(start, torch.Tensor)
             else torch.full((), int(start), dtype=torch.int64,
                             device=device))
    slots = torch.remainder(
        start + first + torch.arange(n - first, device=device), cap)
    for k, dst in storage.items():
        dst.index_copy_(0, slots, batch[k][first:].to(dst.dtype))
    return storage


def ring_gather_ref(storage: Dict[str, torch.Tensor],
                    idx: torch.Tensor) -> Dict[str, torch.Tensor]:
    """The rows at ``idx`` (B,) from every leaf. As in jnp indexing, a
    negative index counts from the end and the result is clamped into
    ``[0, cap)``."""
    cap = next(iter(storage.values())).shape[0]
    idx = torch.clamp(torch.where(idx < 0, idx + cap, idx), 0, cap - 1)
    return {k: v[idx] for k, v in storage.items()}
