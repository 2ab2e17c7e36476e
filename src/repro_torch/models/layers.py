"""Layer initialisers (port of ``dense_init`` in ``repro/models/layers.py``)."""
from __future__ import annotations

from typing import Optional, Tuple

import torch


def dense_init(generator: torch.Generator, shape: Tuple[int, int],
               dtype=torch.float32, scale: Optional[float] = None
               ) -> torch.Tensor:
    """Truncated-normal (at ±3) fan-in init of an ``(in, out)`` matrix,
    drawn on the generator's device."""
    if scale is None:
        scale = shape[0] ** -0.5
    w = torch.empty(shape, dtype=torch.float32, device=generator.device)
    torch.nn.init.trunc_normal_(w, 0.0, 1.0, -3.0, 3.0, generator=generator)
    return (w * scale).to(dtype)
