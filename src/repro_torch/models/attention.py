"""Attention: GQA, sliding window, QKV bias, RoPE, cache-aware (port of
``repro/models/attention.py``).

Layout, as in the reference: q ``(B, S, K, G, hd)`` (K kv heads, G query
heads per kv head), k/v ``(B, S, K, hd)``; softmax statistics in float32.

The model's plain paths are the reference's own functions:

* ``full_causal`` — causal attention by recursive halving (dense lower-left
  rectangles with streaming-softmax stats, diagonal squares recursed);
* ``swa`` — banded attention, each query block against a fixed-size band of
  a left-padded K/V;
* ``decode`` — one query row against a (ring) cache, masked by slot
  validity.

``attention_block`` and ``attention_decode_block`` call the CUDA kernels
(``kernels.flash_attention``, ``kernels.decode_attention``) instead on a
CUDA tensor under the kernel mode (``kernels.select``), the seam the
reference draws for the scan with ``ssm_block``'s ``impl``. In bfloat16 the
flash kernel rounds p to bfloat16 for the PV product (the tensor cores take
it so), as ``_block_stats`` does; the decode kernel keeps p in float32
where ``decode`` rounds it to the value dtype first, so in bfloat16 it
differs from the plain path by that rounding. In float32 both kernels keep
p in float32, as the plain paths do. The reference's sharding hints
(``_head_plan``, ``_constrain_heads``) wait for the distributed slice.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.kernels import select
from repro_torch.kernels.decode_attention.ops import decode_attention_cuda
from repro_torch.kernels.flash_attention.ops import flash_attention_cuda
from repro_torch.models import layers, rope


# ===================================================================== init
class Attention(nn.Module):
    """``wq (D, H*hd)``, ``wk``/``wv (D, K*hd)``, ``wo (H*hd, D)`` and, with
    ``cfg.qkv_bias``, zero biases ``bq``/``bk``/``bv``."""

    def __init__(self, cfg, generator: Optional[torch.Generator] = None,
                 device=None):
        super().__init__()
        dtype = layers.param_dtype(cfg)
        if generator is not None:
            device = generator.device
        d, hd = cfg.d_model, cfg.head_dim
        qd, kvd = cfg.n_heads * hd, cfg.n_kv_heads * hd
        for name, shape in (("wq", (d, qd)), ("wk", (d, kvd)),
                            ("wv", (d, kvd)), ("wo", (qd, d))):
            setattr(self, name, layers.weight(generator, shape, dtype,
                                              device))
        self.qkv_bias = bool(cfg.qkv_bias)
        if self.qkv_bias:
            for name, n in (("bq", qd), ("bk", kvd), ("bv", kvd)):
                setattr(self, name, nn.Parameter(
                    torch.zeros(n, dtype=dtype, device=device)))


def project_qkv(cfg, p: Attention, x: torch.Tensor, cos: torch.Tensor,
                sin: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """x (B,S,D) -> q (B,S,K,G,hd), k/v (B,S,K,hd); RoPE applied."""
    B, S, _ = x.shape
    K, G, hd = cfg.n_kv_heads, cfg.q_per_kv, cfg.head_dim
    q = layers.matmul(x, p.wq)
    k = layers.matmul(x, p.wk)
    v = layers.matmul(x, p.wv)
    if p.qkv_bias:
        q = q + p.bq.to(q.dtype)
        k = k + p.bk.to(k.dtype)
        v = v + p.bv.to(v.dtype)
    q = q.reshape(B, S, K * G, hd)
    k = k.reshape(B, S, K, hd)
    v = v.reshape(B, S, K, hd)
    q = rope.apply_rope(q, cos, sin).reshape(B, S, K, G, hd)
    k = rope.apply_rope(k, cos, sin)
    return q, k, v


def attn_out(cfg, p: Attention, o: torch.Tensor) -> torch.Tensor:
    """o (B,S,K,G,hd) -> (B,S,D)."""
    B, S = o.shape[:2]
    return layers.matmul(o.reshape(B, S, -1), p.wo)


# ============================================================ softmax stats
class Stats(NamedTuple):
    acc: torch.Tensor   # (B, Sq, K, G, hd) f32 — unnormalised weighted values
    m: torch.Tensor     # (B, Sq, K, G)     f32 — running max
    l: torch.Tensor     # (B, Sq, K, G)     f32 — running denominator


def _empty_stats(q: torch.Tensor) -> Stats:
    B, Sq, K, G, hd = q.shape
    kw = dict(dtype=torch.float32, device=q.device)
    return Stats(torch.zeros((B, Sq, K, G, hd), **kw),
                 torch.full((B, Sq, K, G), -torch.inf, **kw),
                 torch.zeros((B, Sq, K, G), **kw))


def _block_stats(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 mask: Optional[torch.Tensor]) -> Stats:
    """One dense (q-block x kv-block) contribution. mask: (Sq, Skv) or
    None. Products of the input dtype, summed in float32 (the reference's
    ``preferred_element_type``)."""
    scale = q.shape[-1] ** -0.5
    s = torch.einsum("bqkgh,bskh->bqkgs", q.float(), k.float()) * scale
    if mask is not None:
        s = torch.where(mask[None, :, None, None, :], s, -torch.inf)
    m = s.amax(-1)
    # rows that are fully masked keep m=-inf; exp(-inf - -inf) is nan
    finite = torch.isfinite(m)
    m_safe = torch.where(finite, m, 0.0)
    p = torch.exp(s - m_safe[..., None])
    if mask is not None:
        p = torch.where(mask[None, :, None, None, :], p, 0.0)
    l = p.sum(-1)
    acc = torch.einsum("bqkgs,bskh->bqkgh", p.to(v.dtype).float(), v.float())
    return Stats(acc, torch.where(finite, m, -torch.inf), l)


def _merge(a: Stats, b: Stats) -> Stats:
    """Combine two stats over the same Q rows, disjoint KV sets."""
    m = torch.maximum(a.m, b.m)
    m_safe = torch.where(torch.isfinite(m), m, 0.0)
    ca = torch.where(torch.isfinite(a.m), torch.exp(a.m - m_safe), 0.0)
    cb = torch.where(torch.isfinite(b.m), torch.exp(b.m - m_safe), 0.0)
    return Stats(a.acc * ca[..., None] + b.acc * cb[..., None], m,
                 a.l * ca + b.l * cb)


def _concat_q(a: Stats, b: Stats) -> Stats:
    return Stats(*(torch.cat([x, y], dim=1) for x, y in zip(a, b)))


def _finalize(s: Stats, dtype) -> torch.Tensor:
    l = torch.where(s.l == 0.0, 1.0, s.l)
    return (s.acc / l[..., None]).to(dtype)


# ================================================== dense rectangle, chunked
def _dense_stats(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 kv_block: int) -> Stats:
    """Unmasked attention of q against all of k/v, over KV blocks."""
    Sk = k.shape[1]
    if Sk <= kv_block:
        return _block_stats(q, k, v, None)
    if Sk % kv_block:
        raise ValueError(f"Skv={Sk} not divisible by {kv_block}")
    out = _empty_stats(q)
    for s0 in range(0, Sk, kv_block):
        out = _merge(out, _block_stats(q, k[:, s0:s0 + kv_block],
                                       v[:, s0:s0 + kv_block], None))
    return out


def _tril(n: int, device) -> torch.Tensor:
    return torch.ones((n, n), dtype=torch.bool, device=device).tril()


# ======================================================= causal (recursive)
def _causal_stats(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  leaf: int, kv_block: int) -> Stats:
    """Exact-FLOPs causal attention over a diagonal square (Sq == Skv)."""
    Sq = q.shape[1]
    if Sq <= leaf or Sq % 2:
        return _block_stats(q, k, v, _tril(Sq, q.device))
    h = Sq // 2
    top = _causal_stats(q[:, :h], k[:, :h], v[:, :h], leaf, kv_block)
    diag = _causal_stats(q[:, h:], k[:, h:], v[:, h:], leaf, kv_block)
    rect = _dense_stats(q[:, h:], k[:, :h], v[:, :h], kv_block)
    return _concat_q(top, _merge(rect, diag))


def full_causal(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                leaf: int = 1024, kv_block: int = 1024) -> torch.Tensor:
    """Causal attention. q (B,S,K,G,hd), k/v (B,S,K,hd) -> (B,S,K,G,hd)."""
    S = q.shape[1]
    if S & (S - 1) or S <= leaf:        # non-power-of-two: one masked leaf
        if S > 8192:
            raise ValueError(
                f"non-power-of-two S={S} too large for dense leaf")
        return _finalize(_block_stats(q, k, v, _tril(S, q.device)), q.dtype)
    return _finalize(_causal_stats(q, k, v, leaf, kv_block), q.dtype)


# ============================================================ sliding window
def _pad_seq(x: torch.Tensor, before: int, after: int) -> torch.Tensor:
    """Zero-pad axis 1 of x."""
    return F.pad(x, (0, 0) * (x.dim() - 2) + (before, after))


def swa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, window: int, *,
        q_block: int = 512) -> torch.Tensor:
    """Banded causal attention, O(S * window) FLOPs: each Q block of
    ``q_block`` rows attends to the band ``[q0 - wpad, q0 + q_block)`` of a
    left-padded KV."""
    S = q.shape[1]
    if S <= window:
        # window covers everything: plain causal is exact
        return full_causal(q, k, v, leaf=min(512, S))
    q_block = min(q_block, S)
    if S % q_block:
        # pad up to a q_block multiple; padded tail rows are sliced off and
        # real queries never attend to padded keys (causality)
        pad = math.ceil(S / q_block) * q_block - S
        out = swa(_pad_seq(q, 0, pad), _pad_seq(k, 0, pad),
                  _pad_seq(v, 0, pad), window, q_block=q_block)
        return out[:, :S]
    wpad = math.ceil(window / 128) * 128
    band = wpad + q_block
    kp, vp = _pad_seq(k, wpad, 0), _pad_seq(v, wpad, 0)
    rel_q = torch.arange(q_block, device=q.device)[:, None]   # local row
    rel_k = torch.arange(band, device=q.device)[None, :] - wpad
    # key global idx = q0 + rel_k ; query global idx = q0 + rel_q
    base_mask = (rel_k <= rel_q) & (rel_q - rel_k < window)
    outs = []
    for q0 in range(0, S, q_block):
        valid = (q0 + rel_k) >= 0              # mask out left padding
        st = _block_stats(q[:, q0:q0 + q_block], kp[:, q0:q0 + band],
                          vp[:, q0:q0 + band], base_mask & valid)
        outs.append(_finalize(st, q.dtype))
    return torch.cat(outs, dim=1)


# ================================================================== decode
def decode(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
           valid: torch.Tensor) -> torch.Tensor:
    """Single-token attention against a KV cache. q ``(B,K,G,hd)``;
    k_cache/v_cache ``(B,Sc,K,hd)``; valid ``(Sc,)`` bool (slot holds a live
    key). Returns ``(B,K,G,hd)``."""
    scale = q.shape[-1] ** -0.5
    s = torch.einsum("bkgh,bskh->bkgs", q.float(), k_cache.float()) * scale
    s = torch.where(valid[None, None, None, :], s, -torch.inf)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bkgs,bskh->bkgh", p.to(v_cache.dtype).float(),
                        v_cache.float()).to(q.dtype)


# ============================================================== full apply
def attention_block(cfg, p: Attention, x: torch.Tensor, cos: torch.Tensor,
                    sin: torch.Tensor, *, return_kv: bool = False):
    """Prefill attention for one layer. x (B,S,D). The flash kernel under
    the kernel mode on a CUDA tensor, else ``swa`` / ``full_causal``."""
    q, k, v = project_qkv(cfg, p, x, cos, sin)
    if select.use_kernel(None, q):
        o = flash_attention_cuda(q, k, v, causal=True,
                                 window=cfg.sliding_window)
    elif cfg.sliding_window:
        o = swa(q, k, v, cfg.sliding_window)
    else:
        o = full_causal(q, k, v)
    y = attn_out(cfg, p, o)
    return (y, k, v) if return_kv else y


def attention_decode_block(cfg, p: Attention, x: torch.Tensor,
                           cos: torch.Tensor, sin: torch.Tensor,
                           k_cache: torch.Tensor, v_cache: torch.Tensor,
                           valid: torch.Tensor, write_idx: int):
    """Decode one token. x (B,1,D); caches (B,Sc,K,hd). Writes this token's
    k/v into slot ``write_idx`` of the caches in place (the reference
    returns updated copies) and returns (y, k_cache, v_cache). The decode
    kernel under the kernel mode on a CUDA tensor, else ``decode``."""
    B = x.shape[0]
    q, k, v = project_qkv(cfg, p, x, cos, sin)  # q (B,1,K,G,hd), k (B,1,K,hd)
    k_cache[:, write_idx] = k[:, 0]
    v_cache[:, write_idx] = v[:, 0]
    if select.use_kernel(None, q):
        o = decode_attention_cuda(q[:, 0], k_cache, v_cache, valid)
    else:
        o = decode(q[:, 0], k_cache, v_cache, valid)
    y = attn_out(cfg, p, o.reshape(B, 1, *o.shape[1:]))
    return y, k_cache, v_cache
