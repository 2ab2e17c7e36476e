"""Mixture-of-Experts MLP: top-k routing with GShard-style capacity dispatch
(port of ``repro/models/moe.py``).

Dispatch and combine are grouped einsums (group = batch row): the one-hot
dispatch tensor is ``(B, S*k, E, C)`` with per-group capacity
``C = ceil(S*k/E * capacity_factor)``; a slot past ``C`` in its expert is
dropped. The router runs in float32; its weights are Mixtral's softmax
over the top-k logits, and the load-balance aux loss is the Switch
Transformer's. Products the reference asks in float32
(``preferred_element_type``) are taken on float32 copies of their inputs.

The reference's ``dist_ctx.constrain*`` calls are layout hints for a
sharded mesh and do nothing on one device; the port leaves them out.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.models import layers

GROUP_TOKENS = 1024     # GShard-style dispatch group (capacity is per group)


class MoE(nn.Module):
    """``router (D, E)`` and the experts' SwiGLU ``w1``/``w3 (E, D, F)``,
    ``w2 (E, F, D)`` (the reference's ``init_moe``)."""

    def __init__(self, cfg, generator: Optional[torch.Generator] = None,
                 device=None):
        super().__init__()
        dtype = layers.param_dtype(cfg)
        if generator is not None:
            device = generator.device
        e, d, f = cfg.n_experts, cfg.d_model, cfg.d_ff
        self.router = layers.weight(generator, (d, e), dtype, device,
                                    scale=0.02)
        # each expert's matrix fan-in scaled, as ``dense_init`` of (in, out)
        self.w1 = layers.weight(generator, (e, d, f), dtype, device,
                                scale=d ** -0.5)
        self.w3 = layers.weight(generator, (e, d, f), dtype, device,
                                scale=d ** -0.5)
        self.w2 = layers.weight(generator, (e, f, d), dtype, device,
                                scale=f ** -0.5)


def capacity(cfg, seq_len: int) -> int:
    slots = seq_len * cfg.top_k
    return max(1, math.ceil(slots / cfg.n_experts * cfg.capacity_factor))


def route(cfg, router_w: torch.Tensor, x: torch.Tensor
          ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """x (B,S,D) -> (weights (B,S,k) f32, idx (B,S,k), probs (B,S,E),
    aux)."""
    logits = torch.matmul(x.float(), router_w.float())
    probs = torch.softmax(logits, dim=-1)
    top_v, top_i = torch.topk(logits, cfg.top_k, dim=-1)
    weights = torch.softmax(top_v, dim=-1)              # Mixtral renorm
    # Switch load-balance loss: E * sum_e f_e * p_e
    sel = F.one_hot(top_i, cfg.n_experts).float()
    frac = torch.mean(torch.sum(sel, dim=2), dim=(0, 1))  # per expert
    mean_p = torch.mean(probs, dim=(0, 1))
    aux = cfg.n_experts * torch.sum(frac * mean_p)
    return weights, top_i, probs, aux


def moe_block(cfg, p: MoE, x: torch.Tensor
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k MoE MLP. x (B,S,D) -> (y (B,S,D), aux loss f32 scalar).
    Sequences longer than ``GROUP_TOKENS`` (and a multiple of it) are cut
    into groups of that many tokens, so dispatch memory is per group."""
    B, S, D = x.shape
    if S > GROUP_TOKENS and S % GROUP_TOKENS == 0:
        g = S // GROUP_TOKENS
        y, aux = _moe_grouped(cfg, p, x.reshape(B * g, GROUP_TOKENS, D))
        return y.reshape(B, S, D), aux
    return _moe_grouped(cfg, p, x)


def _moe_grouped(cfg, p: MoE, x: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    B, S, D = x.shape
    E, k = cfg.n_experts, cfg.top_k
    C = capacity(cfg, S)
    weights, top_i, _, aux = route(cfg, p.router, x)

    # ---- slot bookkeeping: flatten (S, k) -> T routed slots per group
    T = S * k
    e_slot = top_i.reshape(B, T)                        # expert per slot
    w_slot = weights.reshape(B, T)
    e_oh = F.one_hot(e_slot, E).float()                 # (B,T,E)
    rank = torch.cumsum(e_oh, dim=1) - e_oh             # position in expert
    rank_sel = torch.sum(rank * e_oh, dim=-1)           # (B,T)
    keep = rank_sel < C
    # dispatch[b,t,e,c] = 1 iff slot t -> (expert e, capacity slot c); a
    # dropped slot's rank is past C (one_hot gives it no row, as jax's)
    c_oh = F.one_hot(rank_sel.long().clamp(max=C - 1), C).float()
    disp = (e_oh[..., None] * c_oh[:, :, None, :]
            * keep[..., None, None].float())            # (B,T,E,C)
    comb = disp * w_slot[..., None, None]

    disp = disp.to(x.dtype)
    xs = torch.repeat_interleave(x, k, dim=1) if k > 1 else x  # (B,T,D)
    buf = torch.einsum("btec,btd->becd", disp.float(), xs.float()).to(
        x.dtype)

    # ---- expert FFN (SwiGLU), batched over E
    gate = torch.einsum("becd,edf->becf", buf.float(), p.w1.float())
    up = torch.einsum("becd,edf->becf", buf.float(), p.w3.float())
    act = (F.silu(gate) * up).to(x.dtype)
    out = torch.einsum("becf,efd->becd", act.float(), p.w2.float())

    y = torch.einsum("btec,becd->btd", comb, out)
    y = y.reshape(B, S, k, D).sum(dim=2) if k > 1 else y.reshape(B, S, D)
    return y.to(x.dtype), aux
