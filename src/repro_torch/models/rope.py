"""Rotary position embeddings: classic RoPE + Qwen2-VL M-RoPE (port of
``repro/models/rope.py``).

M-RoPE splits the ``head_dim/2`` frequency channels into (t, h, w)
sections; each section reads its angle from the matching row of a 3-row
position id tensor [arXiv:2409.12191]. Plain RoPE is the one-section
special case.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch


def rope_cos_sin(positions: torch.Tensor, head_dim: int, theta: float,
                 sections: Tuple[int, ...] = ()
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Return (cos, sin) of shape ``(..., S, head_dim/2)`` for integer
    ``positions`` of shape ``(..., S)``, or ``(3, ..., S)`` with M-RoPE
    ``sections``."""
    half = head_dim // 2
    # the frequencies in float32 numpy, as the reference computes them
    freqs = theta ** (-np.arange(half, dtype=np.float32) / half)
    freqs = torch.from_numpy(np.asarray(freqs, np.float32)).to(
        positions.device)
    if sections:
        if not positions.shape[0] == len(sections) == 3:
            raise ValueError(f"M-RoPE takes (3, ..., S) positions and 3 "
                             f"sections; got {tuple(positions.shape)} and "
                             f"{sections}")
        sec_id = torch.from_numpy(np.repeat(np.arange(3),
                                            np.asarray(sections))).to(
            positions.device)
        # (half, ..., S): pick the t/h/w position row per frequency channel
        pos = positions[sec_id].movedim(0, -1)         # (..., S, half)
        angles = pos.float() * freqs
    else:
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
