"""Decoder-only sequence model for serving (port of
``repro/models/transformer.py``): dense, SSM and hybrid families.

``LM`` holds the reference's ``init_params`` pytree as modules: the stacked
``layers`` tree (leading ``L`` axis) becomes an ``nn.ModuleList`` of
``Layer``s, one per layer, and the layer loop is a Python loop (the
reference's ``lax.scan``). The serving entry points:

* ``prefill``     — the prompt, the decode state, and last-token logits;
* ``decode_step`` — one token against the state.

Two differences from the reference, both for the serving loop on the card:
the decode state is updated **in place** (the K/V slot, the conv ring and
the SSM state; the reference returns new arrays), and its ``"pos"`` is a
Python int, so that ``write_idx = pos % C`` never waits for the device.
Its other keys are the reference's: ``k``/``v`` ``(L,B,C,K,hd)``,
``cache_pos (C,)`` int32, ``conv (L,B,conv-1,Di)`` and ``ssm (L,B,Di,N)``
float32.

The MoE, audio and vision-language families (``models/moe.py``, frontend
embeds, M-RoPE) and the training forward (``forward``, ``value``,
``token_logp_entropy``) wait for later slices of the port; ``LM`` raises
for those configs.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.kernels.selective_scan.ops import selective_scan
from repro_torch.models import attention, layers, rope, ssm


def _check_ported(cfg) -> None:
    if cfg.is_moe:
        raise NotImplementedError(
            f"{cfg.name}: the MoE block (models/moe.py) is not ported to "
            f"repro_torch yet; it comes with the MoE slice of the port")
    if cfg.frontend != "none" or cfg.m_rope_sections:
        raise NotImplementedError(
            f"{cfg.name}: frontend embeds and M-RoPE are not ported to "
            f"repro_torch yet; they come with the audio and vision-language "
            f"slice of the port")


# ===================================================================== init
class Layer(nn.Module):
    """One layer's parameters, per family (the reference's
    ``_init_layer``)."""

    def __init__(self, cfg, generator: Optional[torch.Generator] = None,
                 device=None):
        super().__init__()
        dtype = layers.param_dtype(cfg)
        norm = lambda: layers.RMSNorm(cfg.d_model, dtype, device)  # noqa
        if cfg.has_attention:
            self.attn_norm = norm()
            self.attn = attention.Attention(cfg, generator, device)
        if cfg.is_ssm:
            if cfg.family == "ssm":
                self.ssm_norm = norm()
            self.ssm = ssm.SSM(cfg, generator, device)
        if cfg.family == "hybrid":
            self.fuse_norm_attn = norm()
            self.fuse_norm_ssm = norm()
        if cfg.d_ff:
            self.mlp_norm = norm()
            self.mlp = layers.MLP(cfg.d_model, cfg.d_ff, dtype, generator,
                                  device)


class LM(nn.Module):
    """The reference's params pytree: ``embed``, ``layers``, ``final_norm``,
    ``lm_head``, ``value_head`` and, with meta tokens, ``meta_tokens``.
    Drawn from ``generator`` on its device, or left uninitialised on
    ``device`` when ``generator`` is None (``convert.lm_params_from_jax``
    fills it)."""

    def __init__(self, cfg, generator: Optional[torch.Generator] = None,
                 device=None):
        super().__init__()
        _check_ported(cfg)
        if generator is not None:
            device = generator.device
        dtype = layers.param_dtype(cfg)
        d, V = cfg.d_model, cfg.vocab_size
        self.embed = layers.Embedding(V, d, dtype, generator, device)
        self.layers = nn.ModuleList(Layer(cfg, generator, device)
                                    for _ in range(cfg.n_layers))
        self.final_norm = layers.RMSNorm(d, dtype, device)
        self.lm_head = layers.Linear(d, V, dtype, False, generator, device)
        self.value_head = layers.Linear(d, 1, dtype, True, generator, device)
        self.meta_tokens = (layers.weight(generator, (cfg.n_meta_tokens, d),
                                          dtype, device, scale=0.02)
                            if cfg.n_meta_tokens else None)


@torch.no_grad()
def init_params(cfg, generator: torch.Generator) -> LM:
    """Random weights from ``generator``, on its device (the reference's
    ``init_params``; the draws differ from ``jax.random``'s)."""
    return LM(cfg, generator)


# ================================================================ positions
def _rope_tables(cfg, positions: torch.Tensor):
    """positions (B,S) -> (cos, sin) of (B,S,half)."""
    return rope.rope_cos_sin(positions, cfg.head_dim, cfg.rope_theta,
                             cfg.m_rope_sections)


def default_positions(cfg, batch: int, seq: int, device) -> torch.Tensor:
    return torch.arange(seq, dtype=torch.int32, device=device).expand(
        batch, seq)


def embed_inputs(cfg, params: LM, tokens: torch.Tensor) -> torch.Tensor:
    """Token embeds with the meta tokens prepended."""
    h = layers.embed(params.embed, tokens)
    if params.meta_tokens is not None:
        B = tokens.shape[0]
        meta = params.meta_tokens[None].expand(B, *params.meta_tokens.shape)
        h = torch.cat([meta, h], dim=1)
    return h


# ================================================================== heads
def lm_logits(cfg, params: LM, h: torch.Tensor) -> torch.Tensor:
    """Full logits in float32 (products of the weight dtype summed in
    float32, the reference's ``preferred_element_type``)."""
    return torch.matmul(h.float(), params.lm_head.w.float())


# ============================================================ decode cache
def cache_len(cfg, seq_len: int) -> int:
    if cfg.sliding_window:
        return min(cfg.sliding_window, seq_len)
    return seq_len


def init_decode_state(cfg, batch: int, seq_len: int,
                      device) -> Dict[str, Any]:
    """Zero-initialised decode state sized for ``seq_len`` total
    positions."""
    dtype = layers.param_dtype(cfg)
    L = cfg.n_layers
    state: Dict[str, Any] = {"pos": 0}
    if cfg.has_attention:
        C = cache_len(cfg, seq_len)
        K, hd = cfg.n_kv_heads, cfg.head_dim
        state["k"] = torch.zeros((L, batch, C, K, hd), dtype=dtype,
                                 device=device)
        state["v"] = torch.zeros_like(state["k"])
        state["cache_pos"] = torch.full((C,), -1, dtype=torch.int32,
                                        device=device)
    if cfg.is_ssm:
        state["conv"] = torch.zeros((L, batch, cfg.ssm_conv - 1,
                                     cfg.d_inner), dtype=dtype,
                                    device=device)
        state["ssm"] = torch.zeros((L, batch, cfg.d_inner, cfg.ssm_state),
                                   dtype=torch.float32, device=device)
    return state


def _ssm_decode(cfg, p: Layer, xn, caches):
    """The SSM step of one layer; writes the conv ring and the state back
    into ``caches`` and returns y."""
    y, conv, state = ssm.ssm_decode_block(cfg, p.ssm, xn, caches["conv"],
                                          caches["ssm"])
    caches["conv"].copy_(conv)
    caches["ssm"].copy_(state)
    return y


def _layer_decode(cfg, p: Layer, h, cos, sin, caches, valid, write_idx):
    """One layer, one token; ``caches`` are this layer's views of the
    state, updated in place. Returns h."""
    if cfg.family == "ssm":
        return h + _ssm_decode(cfg, p, layers.rmsnorm(p.ssm_norm, h,
                                                      cfg.norm_eps), caches)
    xn = layers.rmsnorm(p.attn_norm, h, cfg.norm_eps)
    a, _, _ = attention.attention_decode_block(
        cfg, p.attn, xn, cos, sin, caches["k"], caches["v"], valid,
        write_idx)
    if cfg.family == "hybrid":
        s = _ssm_decode(cfg, p, xn, caches)
        mixed = 0.5 * (layers.rmsnorm(p.fuse_norm_attn, a, cfg.norm_eps)
                       + layers.rmsnorm(p.fuse_norm_ssm, s, cfg.norm_eps))
        h = h + mixed
    else:
        h = h + a
    if cfg.d_ff:
        xm = layers.rmsnorm(p.mlp_norm, h, cfg.norm_eps)
        h = h + layers.mlp(p.mlp, xm)
    return h


_CACHE_KEYS = ("k", "v", "conv", "ssm")


@torch.no_grad()
def decode_step(cfg, params: LM, state: Dict[str, Any], token: torch.Tensor
                ) -> Tuple[Dict[str, Any], torch.Tensor]:
    """One sampler inner step: token (B,1) int -> (state, logits (B,V)
    f32). ``state`` is updated in place and returned."""
    pos = state["pos"]
    h = layers.embed(params.embed, token)            # (B,1,D)
    cos = sin = valid = write_idx = None
    if cfg.has_attention:
        p_ids = torch.full((h.shape[0], 1), pos, dtype=torch.int32,
                           device=h.device)
        cos, sin = _rope_tables(cfg, p_ids)
        C = state["k"].shape[2]
        write_idx = pos % C
        cache_pos = state["cache_pos"]
        cache_pos[write_idx] = pos
        valid = cache_pos >= 0
        if cfg.sliding_window:
            valid &= cache_pos > pos - cfg.sliding_window
    keys = [k for k in _CACHE_KEYS if k in state]
    for i, layer in enumerate(params.layers):
        caches = {k: state[k][i] for k in keys}
        h = _layer_decode(cfg, layer, h, cos, sin, caches, valid, write_idx)
    state["pos"] = pos + 1
    h = layers.rmsnorm(params.final_norm, h, cfg.norm_eps)
    return state, lm_logits(cfg, params, h[:, 0])


# ================================================================= prefill
@torch.no_grad()
def prefill(cfg, params: LM, tokens: torch.Tensor, gen_budget: int = 0, *,
            positions: Optional[torch.Tensor] = None
            ) -> Tuple[Dict[str, Any], torch.Tensor]:
    """Process the prompt, build the decode state, return last-token
    logits (B,V) f32.

    The cache is sized for the internal prompt length (meta tokens
    included) plus ``gen_budget`` further decode steps, capped at the
    sliding window for SWA archs.
    """
    h = embed_inputs(cfg, params, tokens)
    B, P, _ = h.shape
    if positions is None:
        positions = default_positions(cfg, B, P, h.device)
    cos = sin = None
    if cfg.has_attention:
        cos, sin = _rope_tables(cfg, positions)
    state = init_decode_state(cfg, B, P + gen_budget, h.device)
    C = state["k"].shape[2] if "k" in state else 0

    for i, lp in enumerate(params.layers):
        if cfg.family == "ssm":
            xn = layers.rmsnorm(lp.ssm_norm, h, cfg.norm_eps)
            y, state["conv"][i], state["ssm"][i] = _ssm_prefill(cfg, lp.ssm,
                                                                xn)
            h = h + y
            continue
        xn = layers.rmsnorm(lp.attn_norm, h, cfg.norm_eps)
        a, k, v = attention.attention_block(cfg, lp.attn, xn, cos, sin,
                                            return_kv=True)
        if cfg.family == "hybrid":
            s, state["conv"][i], state["ssm"][i] = _ssm_prefill(cfg, lp.ssm,
                                                                xn)
            mixed = 0.5 * (
                layers.rmsnorm(lp.fuse_norm_attn, a, cfg.norm_eps)
                + layers.rmsnorm(lp.fuse_norm_ssm, s, cfg.norm_eps))
            h = h + mixed
        else:
            h = h + a
        state["k"][i] = _fill_cache(k, C, P)
        state["v"][i] = _fill_cache(v, C, P)
        if cfg.d_ff:
            xm = layers.rmsnorm(lp.mlp_norm, h, cfg.norm_eps)
            h = h + layers.mlp(lp.mlp, xm)

    state["pos"] = P
    if cfg.has_attention:
        slot = torch.arange(C, device=h.device)
        if P >= C:          # ring already wrapped: slot s holds token index
            base = (slot - P % C) % C + (P - C)
            tok_idx = torch.where(base < P - C, base + C, base)
            state["cache_pos"] = tok_idx.to(torch.int32)
        else:
            state["cache_pos"] = torch.where(slot < P, slot, -1).to(
                torch.int32)
    h = layers.rmsnorm(params.final_norm, h, cfg.norm_eps)
    return state, lm_logits(cfg, params, h[:, -1])


def _fill_cache(kv: torch.Tensor, C: int, P: int) -> torch.Tensor:
    """Place the last min(P, C) keys at their ring slots (slot = t % C)."""
    if P >= C:
        return torch.roll(kv[:, P - C:], P % C, dims=1)
    return F.pad(kv, (0, 0, 0, 0, 0, C - P))


def _ssm_prefill(cfg, p: ssm.SSM, x: torch.Tensor):
    """Run the SSM over the prompt, return (y, conv_state, ssm_state). The
    scan is the CUDA kernel under the kernel mode on a CUDA tensor."""
    di = cfg.d_inner
    xz = layers.matmul(x, p.in_proj)
    xin, z = xz[..., :di], xz[..., di:]
    xc = F.silu(ssm.causal_conv(p, xin).float()).to(x.dtype)
    dt, b, c = ssm._ssm_inputs(cfg, p, xc)
    A = -torch.exp(p.A_log)
    h0 = torch.zeros((x.shape[0], di, cfg.ssm_state), dtype=torch.float32,
                     device=x.device)
    y, h_last = selective_scan(dt, A, b, c, xc.float(), h0)
    y = y + p.D * xc.float()
    y = y * F.silu(z.float())
    out = layers.matmul(y.to(x.dtype), p.out_proj)
    # conv ring state = the last (conv-1) raw inputs, left-padded if short
    keep = cfg.ssm_conv - 1
    xin_p = F.pad(xin, (0, 0, max(0, keep - x.shape[1]), 0))
    return out, xin_p[:, xin_p.shape[1] - keep:], h_last
