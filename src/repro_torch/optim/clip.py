"""Gradient clipping (port of ``repro/optim/clip.py``)."""
from __future__ import annotations

from typing import List, Sequence, Tuple

import torch

from repro_torch.distributed import grad_sync


def global_norm(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    """The float32 norm of all leaves together: each leaf is upcast before
    it is squared and summed, as the reference does. Under FSDP the
    sharded leaves' square sums are added across the shards
    (``grad_sync.fsdp_sumsq``)."""
    if grad_sync.fsdp_active() is not None:
        return torch.sqrt(grad_sync.fsdp_sumsq(tensors))
    return torch.sqrt(sum(torch.sum(torch.square(x.float()))
                          for x in tensors))


def clip_by_global_norm(tensors: Sequence[torch.Tensor], max_norm: float
                        ) -> Tuple[List[torch.Tensor], torch.Tensor]:
    """Scale every tensor by ``min(1, max_norm / (norm + 1e-9))``, in
    float32 and cast back to its own dtype; returns the scaled tensors and
    the float32 pre-clip norm."""
    norm = global_norm(tensors)
    # a true division, as the reference's (``max_norm / t`` in torch is a
    # reciprocal times max_norm)
    scale = torch.clamp(torch.full_like(norm, max_norm) / (norm + 1e-9),
                        max=1.0)
    return [(x.float() * scale).to(x.dtype) for x in tensors], norm
