"""Uniform replay ring (port of ``repro/data/replay.py``).

The scatter-insert goes through the replay-ring op (``kernels/replay_ring``):
the plain version for CPU tensors, one CUDA launch for all the storage
leaves on the card. Storage is written in place; the buffers
(``data/buffers.py``) gather their minibatches with ``ring_gather``.

``index`` and ``size`` are 0-dim int32 tensors on the storage's device, as
in the reference. ``add_batch`` moves them on the device, the insert kernel
reads the head from device memory and does the wrap itself, and
``sample_indices`` draws below ``size`` without reading it on the host. So
an add and a sample read nothing on the host, and both can be captured in
a CUDA graph (the fused engine, ``core/fused.py``). Whether the ring was
ever added to follows from the shapes of what was added; ``filled`` keeps
that on the host, and ``ensure_nonempty`` reads it instead of ``size``.
"""
from __future__ import annotations

from typing import Dict, NamedTuple

import torch

from repro_torch.kernels.replay_ring import ring_insert

# the draw behind sample_indices: 62 random bits, reduced modulo the size
_DRAW_HIGH = 1 << 62


class ReplayState(NamedTuple):
    storage: Dict[str, torch.Tensor]   # each (capacity, ...)
    index: torch.Tensor                # next write slot, 0-dim int32
    size: torch.Tensor                 # filled entries, 0-dim int32
    filled: bool = False               # any row added (size > 0), on host


def init_replay(capacity: int, example: Dict[str, torch.Tensor]
                ) -> ReplayState:
    """Zeroed storage of ``capacity`` rows shaped like ``example``'s
    (1, ...) leaves, with head and size, on their device."""
    storage = {k: torch.zeros((capacity,) + tuple(v.shape[1:]),
                              dtype=v.dtype, device=v.device)
               for k, v in example.items()}
    device = next(iter(example.values())).device
    return ReplayState(storage,
                       torch.zeros((), dtype=torch.int32, device=device),
                       torch.zeros((), dtype=torch.int32, device=device))


def add_batch(state: ReplayState, batch: Dict[str, torch.Tensor]
              ) -> ReplayState:
    """Insert (N, ...) transitions at the ring head (wraps around)."""
    cap = next(iter(state.storage.values())).shape[0]
    n = next(iter(batch.values())).shape[0]
    storage = ring_insert(state.storage, batch, state.index)
    return ReplayState(storage, torch.remainder(state.index + n, cap),
                       torch.clamp(state.size + n, max=cap),
                       state.filled or n > 0)


def ensure_nonempty(state: ReplayState) -> None:
    """Sampling an empty ring is a caller error (it would yield
    zero-filled slot-0 transitions); the composed train step always adds
    a trajectory before it samples. Reads the host flag ``filled``, so it
    costs no device sync and holds inside a CUDA-graph capture."""
    if not state.filled:
        raise ValueError(
            "sample() on an empty replay buffer — add_batch at least one "
            "transition first (an empty ring would yield zero-filled "
            "slot-0 transitions)")


def sample_indices(state: ReplayState, generator: torch.Generator,
                   batch_size: int) -> torch.Tensor:
    """Uniform int32 slot indices over the filled prefix, drawn from
    ``generator`` on its device: 62 random bits each, modulo ``size`` (a
    bias below 2^-30 for any ring that fits on the card), so the bound
    stays on the device."""
    ensure_nonempty(state)
    bits = torch.randint(0, _DRAW_HIGH, (batch_size,), generator=generator,
                         device=generator.device, dtype=torch.int64)
    return torch.remainder(bits, state.size).to(torch.int32)
