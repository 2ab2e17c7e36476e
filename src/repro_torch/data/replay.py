"""Uniform replay ring (port of ``repro/data/replay.py``).

The scatter-insert goes through the replay-ring op (``kernels/replay_ring``):
the plain version for CPU tensors, one CUDA launch for all the storage
leaves on the card. Storage is written in place; the buffers
(``data/buffers.py``) gather their minibatches with ``ring_gather``.

``index`` and ``size`` are host ints, not device scalars as in the
reference: both follow from the shapes of what was added, so the
wraparound and ``ensure_nonempty`` cost no device sync. A CUDA-graph fused
engine (ROADMAP.md queue 1 item 6) would need them on the device again and
will revisit this.
"""
from __future__ import annotations

from typing import Dict, NamedTuple

import torch

from repro_torch.kernels.replay_ring import ring_insert


class ReplayState(NamedTuple):
    storage: Dict[str, torch.Tensor]   # each (capacity, ...)
    index: int                         # next write slot
    size: int                          # filled entries


def init_replay(capacity: int, example: Dict[str, torch.Tensor]
                ) -> ReplayState:
    """Zeroed storage of ``capacity`` rows shaped like ``example``'s
    (1, ...) leaves, on their device."""
    storage = {k: torch.zeros((capacity,) + tuple(v.shape[1:]),
                              dtype=v.dtype, device=v.device)
               for k, v in example.items()}
    return ReplayState(storage, 0, 0)


def add_batch(state: ReplayState, batch: Dict[str, torch.Tensor]
              ) -> ReplayState:
    """Insert (N, ...) transitions at the ring head (wraps around)."""
    cap = next(iter(state.storage.values())).shape[0]
    n = next(iter(batch.values())).shape[0]
    storage = ring_insert(state.storage, batch, state.index)
    return ReplayState(storage, (state.index + n) % cap,
                       min(state.size + n, cap))


def ensure_nonempty(state: ReplayState) -> None:
    """Sampling an empty ring is a caller error (it would yield
    zero-filled slot-0 transitions); the composed train step always adds
    a trajectory before it samples."""
    if state.size == 0:
        raise ValueError(
            "sample() on an empty replay buffer — add_batch at least one "
            "transition first (an empty ring would yield zero-filled "
            "slot-0 transitions)")


def sample_indices(state: ReplayState, generator: torch.Generator,
                   batch_size: int) -> torch.Tensor:
    """Uniform int32 slot indices over the filled prefix, drawn from
    ``generator`` on its device."""
    ensure_nonempty(state)
    return torch.randint(0, state.size, (batch_size,), generator=generator,
                         device=generator.device, dtype=torch.int32)

