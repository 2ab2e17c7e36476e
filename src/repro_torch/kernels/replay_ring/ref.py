"""Plain PyTorch versions of the replay-ring ops (port of
``repro/kernels/replay_ring/ref.py``).

Storage is a dict of leaves, each ``(capacity, ...)``. Unlike the
reference, ``ring_insert_ref`` writes into ``storage`` in place (the TPU
kernel aliases storage to its output for the same reason: the ring is the
largest buffer of the plane) and returns it.
"""
from __future__ import annotations

from typing import Dict

import torch


def ring_insert_ref(storage: Dict[str, torch.Tensor],
                    batch: Dict[str, torch.Tensor],
                    start: int) -> Dict[str, torch.Tensor]:
    """Write (N, ...) rows at the ring head ``start`` (wrapping), in place.

    The reference scatters row j to ``(start + j) % cap`` in order, so when
    N > cap the last write to a slot wins. Duplicate indices in a PyTorch
    index assignment are undefined, so only rows ``j >= N - cap`` are
    written: each slot once, with the row that wins in the reference. They
    land in at most two contiguous runs of slots."""
    cap = next(iter(storage.values())).shape[0]
    n = next(iter(batch.values())).shape[0]
    first = max(0, n - cap)
    head = (start + first) % cap
    split = min(n - first, cap - head)
    for k, dst in storage.items():
        rows = batch[k][first:].to(dst.dtype)
        dst[head:head + split] = rows[:split]
        dst[:rows.shape[0] - split] = rows[split:]
    return storage


def ring_gather_ref(storage: Dict[str, torch.Tensor],
                    idx: torch.Tensor) -> Dict[str, torch.Tensor]:
    """The rows at ``idx`` (B,) from every leaf. As in jnp indexing, a
    negative index counts from the end and the result is clamped into
    ``[0, cap)``."""
    cap = next(iter(storage.values())).shape[0]
    idx = torch.clamp(torch.where(idx < 0, idx + cap, idx), 0, cap - 1)
    return {k: v[idx] for k, v in storage.items()}
