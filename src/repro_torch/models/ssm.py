"""Mamba1 selective-SSM block (port of ``repro/models/ssm.py``).

``SSM`` holds the reference's ``init_ssm`` parameters. Prefill
(``transformer._ssm_prefill``) runs ``kernels.selective_scan`` over the
prompt: the CUDA kernel under the kernel mode on a CUDA tensor, else the
sequential recurrence (``selective_scan_ref``), which stands in for the
reference's chunked associative scan (the same function, another order of
float sums).

Training (``ssm_block``, ``impl="reference"``) runs ``selective_scan``
here: the reference's chunked scan, chunks of ``chunk`` steps threaded in
order, each solved by the reference's associative scan (``_assoc_scan``,
``jax.lax.associative_scan``'s even/odd recursion written out), so
autograd differentiates it and the state held is ``(B, chunk, Di, N)``.
The kernel route (``impl`` ``"pallas"`` or ``"cuda"``) runs the CUDA scan,
which has no backward: it raises where a gradient is required.

Decode is the O(1) single-step recurrence on the conv ring and the state.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.kernels.selective_scan import ops as scan_ops
from repro_torch.models import layers


class SSM(nn.Module):
    """The reference's ``init_ssm`` dict as parameters: ``(in, out)``
    projections, the depthwise conv ``conv_w (conv, Di)``, ``dt_bias``,
    ``A_log (Di, N)`` and ``D (Di,)`` (both float32 whatever the dtype)."""

    def __init__(self, cfg, generator: Optional[torch.Generator] = None,
                 device=None):
        super().__init__()
        dtype = layers.param_dtype(cfg)
        di, n, r = cfg.d_inner, cfg.ssm_state, cfg.ssm_dt_rank
        if generator is not None:
            device = generator.device
        w = lambda shape, scale=None: layers.weight(  # noqa: E731
            generator, shape, dtype, device, scale)
        self.in_proj = w((cfg.d_model, 2 * di))
        self.conv_w = w((cfg.ssm_conv, di), 0.5)
        self.conv_b = nn.Parameter(torch.zeros(di, dtype=dtype,
                                               device=device))
        self.x_proj = w((di, r + 2 * n))
        self.dt_proj = w((r, di))
        # S4D-real A init: A[:, j] = -(j+1)
        a = np.tile(np.arange(1, n + 1, dtype=np.float32), (di, 1))
        # dt bias: softplus^-1 of dt ~ U[1e-3, 1e-1], the reference's draw
        dt = np.exp(np.random.RandomState(0).uniform(
            np.log(1e-3), np.log(1e-1), size=(di,))).astype(np.float32)
        dt_bias = dt + np.log1p(-np.exp(-dt))
        self.dt_bias = nn.Parameter(
            torch.from_numpy(dt_bias).to(device=device, dtype=dtype))
        self.A_log = nn.Parameter(torch.from_numpy(np.log(a)).to(device))
        self.D = nn.Parameter(torch.ones(di, dtype=torch.float32,
                                         device=device))
        self.out_proj = w((di, cfg.d_model))


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``log(1 + exp(x))`` as ``jax.nn.softplus`` computes it
    (``logaddexp(x, 0)``)."""
    return torch.clamp_min(x, 0) + torch.log1p(torch.exp(-x.abs()))


# ============================================================== projections
def _ssm_inputs(cfg, p: SSM, xc: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """xc (B,S,Di) (post-conv, post-silu) -> dt (f32), B_ssm, C_ssm."""
    r, n = cfg.ssm_dt_rank, cfg.ssm_state
    proj = layers.matmul(xc, p.x_proj)
    dt_raw, b, c = proj[..., :r], proj[..., r:r + n], proj[..., r + n:]
    dt = softplus(layers.matmul(dt_raw, p.dt_proj).float()
                  + p.dt_bias.float())
    return dt, b.float(), c.float()


def causal_conv(p: SSM, x: torch.Tensor) -> torch.Tensor:
    """Depthwise causal 1-D conv. x (B,S,Di) -> (B,S,Di): the taps summed in
    float32 in tap order and rounded once to x's dtype (no cuDNN, so no
    TF32)."""
    conv = p.conv_w.shape[0]
    S = x.shape[1]
    xp = F.pad(x, (0, 0, conv - 1, 0))
    w = p.conv_w.float()
    y = xp[:, 0:S].float() * w[0]
    for j in range(1, conv):
        y = y + xp[:, j:j + S].float() * w[j]
    y = y.to(x.dtype)
    return y + p.conv_b.to(y.dtype)


# ============================================================ chunked scan
def _scan_combine(a, b):
    """Associative combine for (decay, increment) pairs; ``a`` is the
    earlier element."""
    a1, b1 = a
    a2, b2 = b
    return a1 * a2, a2 * b1 + b2


def _interleave(even: torch.Tensor, odd: torch.Tensor) -> torch.Tensor:
    """Along axis 1: even[0], odd[0], even[1], odd[1], ..."""
    n = even.shape[1] + odd.shape[1]
    out = even.new_empty((even.shape[0], n) + tuple(even.shape[2:]))
    out = out.index_copy(1, torch.arange(0, n, 2, device=even.device), even)
    return out.index_copy(1, torch.arange(1, n, 2, device=even.device), odd)


def _assoc_scan(elems):
    """Inclusive scan of ``(decay, increment)`` pairs along axis 1, by the
    even/odd recursion of ``jax.lax.associative_scan``: combine adjacent
    pairs, scan those, then fill in the even positions."""
    n = elems[0].shape[1]
    if n < 2:
        return elems
    reduced = _scan_combine([e[:, 0:-1:2] for e in elems],
                            [e[:, 1::2] for e in elems])
    odd = _assoc_scan(reduced)
    if n % 2 == 0:
        even = _scan_combine([e[:, :-1] for e in odd],
                             [e[:, 2::2] for e in elems])
    else:
        even = _scan_combine(odd, [e[:, 2::2] for e in elems])
    even = [torch.cat([e[:, :1], r], dim=1) for e, r in zip(elems, even)]
    return [_interleave(e, o) for e, o in zip(even, odd)]


def selective_scan(dt: torch.Tensor, A: torch.Tensor, b: torch.Tensor,
                   c: torch.Tensor, xc: torch.Tensor, h0: torch.Tensor,
                   *, chunk: int = 256
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Selective-SSM scan (all-float32 inputs), differentiable.

    dt (B,S,Di), A (Di,N), b/c (B,S,N), xc (B,S,Di), h0 (B,Di,N).
    Returns y (B,S,Di) and the final state (B,Di,N).
    """
    S = xc.shape[1]
    if S % chunk:
        chunk = S                                       # single chunk
    h, ys = h0, []
    for s0 in range(0, S, chunk):
        sl = slice(s0, s0 + chunk)
        dt_c, b_c, c_c, x_c = dt[:, sl], b[:, sl], c[:, sl], xc[:, sl]
        abar = torch.exp(dt_c[..., None] * A)           # (B,Q,Di,N)
        bx = (dt_c * x_c)[..., None] * b_c[:, :, None, :]
        pa, pb = _assoc_scan([abar, bx])
        h_t = pa * h[:, None] + pb                      # (B,Q,Di,N)
        ys.append(torch.einsum("bqdn,bqn->bqd", h_t, c_c))
        h = h_t[:, -1]
    return torch.cat(ys, dim=1), h


# ================================================================== blocks
KERNEL_IMPLS = ("pallas", "cuda")


def ssm_block(cfg, p: SSM, x: torch.Tensor, *, impl: str = "reference"
              ) -> torch.Tensor:
    """Full Mamba1 mixer for training/prefill. x (B,S,D) -> (B,S,D).

    ``impl="reference"``: the plain chunked scan above. ``"pallas"`` (the
    reference's name) or ``"cuda"``: ``kernels.selective_scan`` (the CUDA
    kernel on a CUDA tensor), forward only, so it raises ``RuntimeError``
    where autograd would need its gradient."""
    if impl not in ("reference",) + KERNEL_IMPLS:
        raise ValueError(f"unknown ssm impl {impl!r}")
    B = x.shape[0]
    di = cfg.d_inner
    xz = layers.matmul(x, p.in_proj)
    xin, z = xz[..., :di], xz[..., di:]
    xc = F.silu(causal_conv(p, xin).float()).to(x.dtype)
    dt, b, c = _ssm_inputs(cfg, p, xc)
    A = -torch.exp(p.A_log)
    h0 = torch.zeros((B, di, cfg.ssm_state), dtype=torch.float32,
                     device=x.device)
    if impl in KERNEL_IMPLS:
        if torch.is_grad_enabled() and any(
                t.requires_grad for t in (dt, A, b, c, xc)):
            raise RuntimeError(
                f"ssm_block(impl={impl!r}): the selective-scan kernel has "
                f"no backward; train with impl='reference' (the reference "
                f"trains on its plain scan too)")
        y, _ = scan_ops.selective_scan(dt, A, b, c, xc.float(), h0,
                                       impl="cuda")
    else:
        y, _ = selective_scan(dt, A, b, c, xc.float(), h0)
    y = y + p.D * xc.float()
    y = y * F.silu(z.float())
    return layers.matmul(y.to(x.dtype), p.out_proj)


def ssm_decode_block(cfg, p: SSM, x: torch.Tensor, conv_state: torch.Tensor,
                     ssm_state: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One decode step. x (B,1,D); conv_state (B,conv-1,Di); ssm_state
    (B,Di,N). Returns (y (B,1,D), conv_state', ssm_state') as new tensors;
    ``transformer.decode_step`` copies them into its state."""
    di = cfg.d_inner
    xz = layers.matmul(x[:, 0], p.in_proj)                 # (B, 2Di)
    xin, z = xz[..., :di], xz[..., di:]
    window = torch.cat([conv_state, xin[:, None]], dim=1)  # (B,conv,Di)
    xconv = torch.einsum("bwd,wd->bd", window.float(), p.conv_w.float())
    xconv = xconv + p.conv_b.float()
    xc = F.silu(xconv)                                     # (B,Di) f32
    dt, b, c = _ssm_inputs(cfg, p, xc[:, None].to(x.dtype))
    dt, b, c = dt[:, 0], b[:, 0], c[:, 0]                  # (B,Di), (B,N)
    A = -torch.exp(p.A_log)
    abar = torch.exp(dt[..., None] * A)                    # (B,Di,N)
    bx = (dt * xc)[..., None] * b[:, None, :]
    h = abar * ssm_state + bx
    y = torch.einsum("bdn,bn->bd", h, c) + p.D * xc
    y = y * F.silu(z.float())
    out = layers.matmul(y[:, None].to(x.dtype), p.out_proj)
    return out, window[:, 1:].to(conv_state.dtype), h
