"""Plain PyTorch version of decode attention (port of
``repro/kernels/decode_attention/ref.py``)."""
from __future__ import annotations

import math

import torch


def decode_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               valid: torch.Tensor) -> torch.Tensor:
    """q (B,H,hd); k/v (B,K,Sc,hd); valid (Sc,). Returns (B,H,hd) in q's
    dtype, computed in float32."""
    B, H, hd = q.shape
    G = H // k.shape[1]
    kr = torch.repeat_interleave(k, G, dim=1).float()
    vr = torch.repeat_interleave(v, G, dim=1).float()
    s = torch.einsum("bhd,bhsd->bhs", q.float(), kr) / torch.tensor(
        math.sqrt(hd), dtype=torch.float32)
    s = torch.where(valid.bool()[None, None, :], s, -torch.inf)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhs,bhsd->bhd", p, vr).to(q.dtype)
