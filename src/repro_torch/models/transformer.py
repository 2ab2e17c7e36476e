"""Decoder-only sequence model: dense / MoE / SSM / hybrid / audio / vlm
(port of ``repro/models/transformer.py``).

``LM`` holds the reference's ``init_params`` pytree as modules: the stacked
``layers`` tree (leading ``L`` axis) becomes an ``nn.ModuleList`` of
``Layer``s, one per layer, and the layer loop is a Python loop (the
reference's ``lax.scan``). The entry points:

* ``forward``     — full-sequence hidden states and the MoE aux loss
  (training), with the reference's activation-rematerialisation modes
  through ``torch.utils.checkpoint``;
* ``value``, ``token_logp_entropy`` — the heads the PPO loss reads;
* ``prefill``     — the prompt, the decode state, and last-token logits;
* ``decode_step`` — one token against the state.

Training runs the plain paths (the reference trains with
``impl="reference"``; the CUDA kernels have no backward): attention is
always the plain ``swa`` / ``full_causal`` in ``forward``, and the scan is
the plain chunked one unless ``impl`` names the kernel. Serving
(``prefill``, ``decode_step``) follows the process-global kernel mode.

Two differences from the reference, both for the serving loop on the card:
the decode state is updated **in place** (the K/V slot, the conv ring and
the SSM state; the reference returns new arrays), and its ``"pos"`` is a
Python int, so that ``write_idx = pos % C`` never waits for the device.
Its other keys are the reference's: ``k``/``v`` ``(L,B,C,K,hd)``,
``cache_pos (C,)`` int32, ``conv (L,B,conv-1,Di)`` and ``ssm (L,B,Di,N)``
float32.
"""
from __future__ import annotations

import functools
import math
from typing import Any, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils import checkpoint as ckpt

from repro_torch.kernels.selective_scan.ops import selective_scan
from repro_torch.models import attention, layers, moe, rope, ssm


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
            if cfg.is_moe:
                self.moe = moe.MoE(cfg, generator, device)
            else:
                self.mlp = layers.MLP(cfg.d_model, cfg.d_ff, dtype,
                                      generator, device)


class LM(nn.Module):
    """The reference's params pytree: ``embed``, ``layers``, ``final_norm``,
    ``lm_head``, ``value_head`` and, with meta tokens, ``meta_tokens``.
    Drawn from ``generator`` on its device, or left uninitialised on
    ``device`` when ``generator`` is None (``convert.lm_params_from_jax``
    fills it)."""

    def __init__(self, cfg, generator: Optional[torch.Generator] = None,
                 device=None):
        super().__init__()
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
    """positions (B,S) or (3,B,S) -> (cos, sin) of (B,S,half)."""
    return rope.rope_cos_sin(positions, cfg.head_dim, cfg.rope_theta,
                             cfg.m_rope_sections)


def default_positions(cfg, batch: int, seq: int, device) -> torch.Tensor:
    """``arange(seq)`` per row, (B,S); (3,B,S) for M-RoPE archs."""
    pos = torch.arange(seq, dtype=torch.int32, device=device).expand(
        batch, seq)
    if cfg.m_rope_sections:
        pos = pos.expand(3, batch, seq)
    return pos


# ============================================================== layer body
def _layer_fwd(cfg, p: Layer, h: torch.Tensor, cos, sin, impl: str
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One layer, full sequence. Returns (h, moe_aux). Attention takes its
    plain path whatever the kernel mode, as the reference's does."""
    aux = torch.zeros((), dtype=torch.float32, device=h.device)
    if cfg.family == "ssm":
        h = h + ssm.ssm_block(cfg, p.ssm, layers.rmsnorm(p.ssm_norm, h,
                                                         cfg.norm_eps),
                              impl=impl)
        return h, aux
    xn = layers.rmsnorm(p.attn_norm, h, cfg.norm_eps)
    a = attention.attention_block(cfg, p.attn, xn, cos, sin, impl="ref")
    if cfg.family == "hybrid":
        s = ssm.ssm_block(cfg, p.ssm, xn, impl=impl)
        mixed = 0.5 * (layers.rmsnorm(p.fuse_norm_attn, a, cfg.norm_eps)
                       + layers.rmsnorm(p.fuse_norm_ssm, s, cfg.norm_eps))
        h = h + mixed
    else:
        h = h + a
    if cfg.d_ff:
        y, moe_aux = _mlp(cfg, p, layers.rmsnorm(p.mlp_norm, h,
                                                 cfg.norm_eps))
        h = h + y
        if moe_aux is not None:
            aux = moe_aux
    return h, aux


def _mlp(cfg, p: Layer, xm: torch.Tensor
         ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """The layer's MLP on the normed stream: (y, the MoE aux loss, or None
    for a SwiGLU MLP)."""
    if cfg.is_moe:
        return moe.moe_block(cfg, p.moe, xm)
    return layers.mlp(p.mlp, xm), None


# ================================================================= forward
def embed_inputs(cfg, params: LM, tokens: torch.Tensor,
                 extra_embeds: Optional[torch.Tensor] = None
                 ) -> torch.Tensor:
    """Token embeds with (meta tokens | frontend embeds) prepended."""
    h = layers.embed(params.embed, tokens)
    prefix = []
    if params.meta_tokens is not None:
        B = tokens.shape[0]
        prefix.append(params.meta_tokens[None].expand(
            B, *params.meta_tokens.shape))
    if extra_embeds is not None:
        prefix.append(extra_embeds.to(h.dtype))
    if prefix:
        h = torch.cat(prefix + [h], dim=1)
    return h


def _near_sqrt_factor(L: int) -> int:
    """Largest divisor of L that is <= sqrt(L) (1 if L is prime)."""
    for d in range(int(math.isqrt(L)), 0, -1):
        if L % d == 0:
            return d
    return 1


REMAT_MODES = ("none", "full", "scan2", "dots", "scan2_dots")
# what the reference's ``dots_with_no_batch_dims_saveable`` keeps: the
# outputs of products without batch dimensions, here the projections' 2-D
# matmuls (the attention and expert einsums are batched and recomputed)
_SAVED_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _dots_policy(ctx, op, *args, **kwargs):
    return (ckpt.CheckpointPolicy.MUST_SAVE if op in _SAVED_DOTS
            else ckpt.CheckpointPolicy.PREFER_RECOMPUTE)


def _checkpointed(fn, dots: bool = False):
    """``fn`` under ``torch.utils.checkpoint`` (non-reentrant); with
    ``dots``, the matmul outputs are saved and the rest recomputed."""
    kw = {}
    if dots:
        kw["context_fn"] = functools.partial(
            ckpt.create_selective_checkpoint_contexts, _dots_policy)

    def run(*args):
        return ckpt.checkpoint(fn, *args, use_reentrant=False, **kw)
    return run


def forward(cfg, params: LM, tokens: torch.Tensor, *,
            positions: Optional[torch.Tensor] = None,
            extra_embeds: Optional[torch.Tensor] = None,
            impl: str = "reference",
            remat: str = "scan2") -> Tuple[torch.Tensor, torch.Tensor]:
    """tokens (B, S_tok) -> (hidden (B, S_total, D), moe_aux f32 scalar).

    remat (what backward keeps; the values are the same in every mode):
    ``"none"``; ``"full"`` (one checkpoint a layer); ``"scan2"`` (groups of
    ``_near_sqrt_factor(L)`` layers, each group checkpointed and each layer
    in it too); ``"dots"`` (each layer checkpointed, its matmul outputs
    saved); ``"scan2_dots"`` (``"scan2"`` with the inner layers' matmul
    outputs saved). Where ``L`` has no factor above 1 the two ``scan2``
    modes checkpoint each layer, as the reference's fall back."""
    if remat not in REMAT_MODES:
        raise ValueError(f"unknown remat {remat!r}; choose from "
                         f"{REMAT_MODES}")
    h = embed_inputs(cfg, params, tokens, extra_embeds)
    B, S, _ = h.shape
    if positions is None:
        positions = default_positions(cfg, B, S, h.device)
    cos = sin = None
    if cfg.has_attention:
        cos, sin = _rope_tables(cfg, positions)

    def body(layer):
        return lambda x: _layer_fwd(cfg, layer, x, cos, sin, impl)

    L = cfg.n_layers
    two_level = remat in ("scan2", "scan2_dots")
    L1 = _near_sqrt_factor(L) if two_level else 1
    auxes: List[torch.Tensor] = []
    if two_level and L1 > 1:
        L2 = L // L1

        def group(g):
            def run(x):
                aux = []
                for layer in params.layers[g * L2:(g + 1) * L2]:
                    x, a = _checkpointed(body(layer),
                                         dots=remat == "scan2_dots")(x)
                    aux.append(a)
                return x, torch.stack(aux).sum()
            return run

        for g in range(L1):
            h, a = _checkpointed(group(g))(h)
            auxes.append(a)
    else:
        for layer in params.layers:
            fn = body(layer)
            if remat in ("full", "scan2", "scan2_dots"):
                fn = _checkpointed(fn)
            elif remat == "dots":
                fn = _checkpointed(fn, dots=True)
            h, a = fn(h)
            auxes.append(a)
    h = layers.rmsnorm(params.final_norm, h, cfg.norm_eps)
    return h, torch.stack(auxes).sum()


# ================================================================== heads
def lm_logits(cfg, params: LM, h: torch.Tensor) -> torch.Tensor:
    """Full logits in float32 (products of the weight dtype summed in
    float32, the reference's ``preferred_element_type``)."""
    return torch.matmul(h.float(), params.lm_head.w.float())


def value(cfg, params: LM, h: torch.Tensor) -> torch.Tensor:
    """Value head (B,S) f32."""
    return layers.linear(params.value_head, h)[..., 0].float()


def _chunk_logp_entropy(w: torch.Tensor, hc: torch.Tensor, tc: torch.Tensor
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    z = torch.matmul(hc.float(), w.float())             # (B,chunk,V) f32
    lse = torch.logsumexp(z, dim=-1)
    tgt = torch.gather(z, -1, tc[..., None].long())[..., 0]
    p = torch.softmax(z, dim=-1)
    ent = lse - torch.sum(p * z, dim=-1)
    return tgt - lse, ent


def token_logp_entropy(cfg, params: LM, h: torch.Tensor,
                       targets: torch.Tensor, chunk: int = 256
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-token log-prob of ``targets`` and entropy, chunked over S (each
    chunk checkpointed, so backward recomputes its logits): the (B,S,V)
    float32 logits never exist whole. Returns two (B,S) f32 tensors."""
    S = h.shape[1]
    if S % chunk:
        chunk = S
    w = params.lm_head.w
    run = _checkpointed(functools.partial(_chunk_logp_entropy, w))
    logp, ent = zip(*(run(h[:, s0:s0 + chunk], targets[:, s0:s0 + chunk])
                      for s0 in range(0, S, chunk)))
    return torch.cat(logp, dim=1), torch.cat(ent, dim=1)


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
        h = h + _mlp(cfg, p, layers.rmsnorm(p.mlp_norm, h, cfg.norm_eps))[0]
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
        if cfg.m_rope_sections:
            p_ids = p_ids.expand(3, *p_ids.shape)
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
            positions: Optional[torch.Tensor] = None,
            extra_embeds: Optional[torch.Tensor] = None
            ) -> Tuple[Dict[str, Any], torch.Tensor]:
    """Process the prompt, build the decode state, return last-token
    logits (B,V) f32.

    The cache is sized for the internal prompt length (tokens + frontend
    embeds + meta tokens) plus ``gen_budget`` further decode steps, capped
    at the sliding window for SWA archs.
    """
    h = embed_inputs(cfg, params, tokens, extra_embeds)
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
            h = h + _mlp(cfg, lp, xm)[0]

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
