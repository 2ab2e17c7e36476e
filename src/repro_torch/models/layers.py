"""Shared building blocks (port of ``repro/models/layers.py``).

Conventions, as in the reference:

* Weights are ``(in, out)`` matrices and a product is ``x @ w`` in the
  activation dtype (``matmul``); the reference's ``{"w": ...}`` leaves keep
  their layout, so ``convert.py`` copies them without a transpose.
* Parameters live in small ``nn.Module`` containers whose attribute names are
  the reference's dict keys (``RMSNorm.scale``, ``MLP.w1``...), and the
  functions take the container where the reference takes the dict.
* A container built with ``generator=None`` is left uninitialised
  (``torch.empty``), for weights copied in afterwards.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn


def param_dtype(cfg) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def dense_init(generator: torch.Generator, shape: Tuple[int, ...],
               dtype=torch.float32, scale: Optional[float] = None
               ) -> torch.Tensor:
    """Truncated-normal (at ±3) fan-in init of an ``(in, out)`` matrix,
    drawn on the generator's device."""
    if scale is None:
        scale = shape[0] ** -0.5
    w = torch.empty(shape, dtype=torch.float32, device=generator.device)
    torch.nn.init.trunc_normal_(w, 0.0, 1.0, -3.0, 3.0, generator=generator)
    return (w * scale).to(dtype)


def weight(generator: Optional[torch.Generator], shape: Tuple[int, ...],
           dtype, device, scale: Optional[float] = None) -> nn.Parameter:
    """A ``dense_init`` parameter, or an empty one when ``generator`` is
    None."""
    if generator is None:
        return nn.Parameter(torch.empty(shape, dtype=dtype, device=device))
    return nn.Parameter(dense_init(generator, shape, dtype, scale))


def matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` in the activation dtype."""
    return torch.matmul(x, w)


# ------------------------------------------------------------------ norms
class RMSNorm(nn.Module):
    def __init__(self, d: int, dtype, device=None):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(d, dtype=dtype, device=device))


def rmsnorm(p: RMSNorm, x: torch.Tensor, eps: float) -> torch.Tensor:
    """RMS norm in float32, cast back to ``x``'s dtype."""
    xf = x.float()
    var = xf.square().mean(-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * p.scale.float()).to(x.dtype)


# ------------------------------------------------------------------ SwiGLU
class MLP(nn.Module):
    """SwiGLU: ``w1`` gate, ``w3`` up, ``w2`` down."""

    def __init__(self, d_model: int, d_ff: int, dtype,
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        self.w1 = weight(generator, (d_model, d_ff), dtype, device)
        self.w3 = weight(generator, (d_model, d_ff), dtype, device)
        self.w2 = weight(generator, (d_ff, d_model), dtype, device)


def mlp(p: MLP, x: torch.Tensor) -> torch.Tensor:
    gate = F.silu(matmul(x, p.w1).float())
    up = matmul(x, p.w3).float()
    return matmul((gate * up).to(x.dtype), p.w2)


# ------------------------------------------------------------------ embed
class Embedding(nn.Module):
    def __init__(self, vocab: int, d_model: int, dtype,
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        self.table = weight(generator, (vocab, d_model), dtype, device,
                            scale=0.02)


def embed(p: Embedding, tokens: torch.Tensor) -> torch.Tensor:
    return p.table[tokens]


class Linear(nn.Module):
    """``{"w": (in, out)}`` and, with ``bias``, a zero ``b``."""

    def __init__(self, d_in: int, d_out: int, dtype, bias: bool = False,
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        self.w = weight(generator, (d_in, d_out), dtype, device)
        self.b = (nn.Parameter(torch.zeros(d_out, dtype=dtype, device=device))
                  if bias else None)


def linear(p: Linear, x: torch.Tensor) -> torch.Tensor:
    y = matmul(x, p.w)
    if p.b is not None:
        y = y + p.b.to(y.dtype)
    return y
