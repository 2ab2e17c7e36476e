"""Rotary position embeddings (port of ``repro/models/rope.py``).

Plain RoPE only. The reference's M-RoPE (Qwen2-VL's three position rows)
belongs to the vision-language family, which the port does not run yet;
``rope_cos_sin`` raises for it.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch


def rope_cos_sin(positions: torch.Tensor, head_dim: int, theta: float,
                 sections: Tuple[int, ...] = ()
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Return (cos, sin) of shape ``(..., S, head_dim/2)`` for integer
    ``positions`` of shape ``(..., S)``."""
    if sections:
        raise NotImplementedError(
            "M-RoPE (vision-language archs) is not ported to repro_torch yet")
    half = head_dim // 2
    # the frequencies in float32 numpy, as the reference computes them
    freqs = theta ** (-np.arange(half, dtype=np.float32) / half)
    freqs = torch.from_numpy(np.asarray(freqs, np.float32)).to(
        positions.device)
    angles = positions[..., None].float() * freqs
    return torch.cos(angles), torch.sin(angles)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor
               ) -> torch.Tensor:
    """Rotate ``x`` of shape ``(B, S, n_heads, head_dim)``; cos/sin are
    ``(B, S, head_dim/2)`` (broadcast over the head axis)."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    c = cos[..., None, :].float()
    s = sin[..., None, :].float()
    out = torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)
    return out.to(x.dtype)
