"""Plain PyTorch version of flash attention (port of
``repro/kernels/flash_attention/ref.py``): the naive masked softmax."""
from __future__ import annotations

import math

import torch


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True, window: int = 0) -> torch.Tensor:
    """q (B,H,Sq,hd); k/v (B,K,Skv,hd). Naive O(S^2) reference in float32,
    rows aligned to the ends (``Sq == Skv`` at prefill). Returns q's
    dtype."""
    B, H, Sq, hd = q.shape
    K, Skv = k.shape[1], k.shape[2]
    G = H // K
    kr = torch.repeat_interleave(k, G, dim=1).float()
    vr = torch.repeat_interleave(v, G, dim=1).float()
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), kr) / torch.tensor(
        math.sqrt(hd), dtype=torch.float32)
    rows = torch.arange(Sq, device=q.device)[:, None] + (Skv - Sq)
    cols = torch.arange(Skv, device=q.device)[None, :]
    mask = torch.ones((Sq, Skv), dtype=torch.bool, device=q.device)
    if causal:
        mask &= cols <= rows
    if window:
        mask &= rows - cols < window
    s = torch.where(mask[None, None], s, -torch.inf)
    p = torch.softmax(s, dim=-1)
    p = torch.where(mask[None, None], p, 0.0)
    return torch.einsum("bhqk,bhkd->bhqd", p, vr).to(q.dtype)
