"""The LM kernels' plain versions and the model's attention paths, against
the JAX package on the CPU.

Inputs are made from a seed with numpy and passed to both packages. The
Pallas kernels run in interpret mode, as ``tests/test_kernels.py`` runs
them, at shapes they take (block multiples).

Bounds: ``attention_ref``/``decode_ref`` and the model's ``full_causal``,
``swa`` and ``decode`` within ``tests/test_kernels.py``'s bounds, 2e-5 in
float32 and 3e-2 in bfloat16 (sums in another order; in bfloat16 the
output rounds to 8 bits); ``selective_scan_ref`` within 2e-4, against the
JAX ref, the Pallas kernel and the model's chunked associative scan
(another order of the same float32 recurrence).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.decode_attention import decode_attention_op
from repro.kernels.decode_attention import decode_ref as jax_decode_ref
from repro.kernels.flash_attention import attention_ref as jax_attention_ref
from repro.kernels.flash_attention import flash_attention as jax_flash
from repro.kernels.selective_scan import selective_scan as jax_scan_kernel
from repro.kernels.selective_scan import (
    selective_scan_ref as jax_selective_scan_ref,
)
from repro.models import attention as jax_attention
from repro.models import ssm as jax_ssm
from repro_torch.kernels.decode_attention import decode_attention, decode_ref
from repro_torch.kernels.flash_attention import attention_ref, flash_attention
from repro_torch.kernels.selective_scan import (
    selective_scan,
    selective_scan_ref,
)
from repro_torch.kernels.selective_scan import ops as scan_ops
from repro_torch.models import attention

TOL = {"float32": 2e-5, "bfloat16": 3e-2}
SCAN_TOL = 2e-4


def _normal(rng, shape, dtype="float32"):
    """The same values for both packages: float32 numpy, rounded to
    ``dtype`` on each side."""
    x = rng.standard_normal(shape).astype(np.float32)
    return (jnp.asarray(x, dtype=dtype),
            torch.from_numpy(x).to(getattr(torch, dtype)))


def _close(got: torch.Tensor, want, tol):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), atol=tol)


# ------------------------------------------------------- flash attention
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,H,K,S,hd,causal,window", [
    (1, 4, 2, 128, 64, True, 0),
    (2, 2, 2, 96, 32, True, 0),
    (1, 4, 1, 128, 64, True, 40),       # SWA
    (1, 2, 2, 64, 64, False, 0),        # non-causal
    (1, 8, 2, 64, 128, True, 0),        # GQA 4:1
    (1, 2, 1, 37, 32, False, 9),        # ragged S, window without causality
])
def test_attention_ref_matches_jax(B, H, K, S, hd, causal, window, dtype):
    rng = np.random.default_rng(S * hd + H)
    (jq, q), (jk, k), (jv, v) = (_normal(rng, s, dtype) for s in (
        (B, H, S, hd), (B, K, S, hd), (B, K, S, hd)))
    got = attention_ref(q, k, v, causal=causal, window=window)
    assert got.dtype == q.dtype
    _close(got, jax_attention_ref(jq, jk, jv, causal=causal, window=window),
           TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("S,window,causal,qb,kb", [
    (128, 0, True, 64, 64), (128, 40, True, 32, 64), (64, 0, False, 64, 32)])
def test_attention_ref_matches_pallas_interpret(S, window, causal, qb, kb,
                                                dtype):
    B, H, K, hd = 1, 4, 2, 32
    rng = np.random.default_rng(S + window)
    (jq, q), (jk, k), (jv, v) = (_normal(rng, s, dtype) for s in (
        (B, H, S, hd), (B, K, S, hd), (B, K, S, hd)))
    want = jax_flash(jq, jk, jv, causal=causal, window=window, q_block=qb,
                     kv_block=kb)
    _close(attention_ref(q, k, v, causal=causal, window=window), want,
           TOL[dtype])


def test_flash_attention_op_takes_the_model_layout():
    """``flash_attention`` on CPU tensors: the plain version through the
    model layout (q (B,S,K,G,hd)), against JAX's ``swa`` on that layout."""
    rng = np.random.default_rng(5)
    B, S, K, G, hd = 2, 100, 2, 2, 32
    (jq, q), (jk, k), (jv, v) = (_normal(rng, s) for s in (
        (B, S, K, G, hd), (B, S, K, hd), (B, S, K, hd)))
    got = flash_attention(q, k, v, causal=True, window=30)
    assert got.shape == (B, S, K, G, hd)
    _close(got, jax_attention.swa(jq, jk, jv, 30, q_block=32), TOL["float32"])


# ------------------------------------------------------ decode attention
@pytest.mark.parametrize("B,K,G,Sc,hd,kb,dtype", [
    (2, 2, 4, 256, 64, 128, "float32"), (1, 4, 1, 128, 32, 128, "bfloat16"),
    (3, 1, 5, 64, 64, 64, "float32"), (2, 2, 2, 96, 128, 32, "bfloat16")])
def test_decode_ref_matches_jax_and_pallas(B, K, G, Sc, hd, kb, dtype):
    rng = np.random.default_rng(Sc + hd + G)
    (jq, q), (jk, kc), (jv, vc) = (_normal(rng, s, dtype) for s in (
        (B, K, G, hd), (B, Sc, K, hd), (B, Sc, K, hd)))
    valid = rng.random(Sc) < 0.6
    valid[0] = True
    jvalid, tvalid = jnp.asarray(valid), torch.from_numpy(valid)
    got = decode_ref(q.reshape(B, K * G, hd), kc.transpose(1, 2),
                     vc.transpose(1, 2), tvalid)
    want = jax_decode_ref(jq.reshape(B, K * G, hd),
                          jnp.transpose(jk, (0, 2, 1, 3)),
                          jnp.transpose(jv, (0, 2, 1, 3)), jvalid)
    _close(got, want, TOL[dtype])
    pallas = decode_attention_op(jq, jk, jv, jvalid, kv_block=kb)
    op = decode_attention(q, kc, vc, tvalid)
    assert op.shape == (B, K, G, hd)
    _close(op, pallas, TOL[dtype])


# ----------------------------------------------- the model's attention
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("S,leaf,kv_block", [
    (100, 1024, 1024),      # one masked leaf (not a power of two)
    (64, 16, 8),            # recursive halving, chunked rectangles
    (64, 64, 64)])
def test_full_causal_matches_jax(S, leaf, kv_block, dtype):
    rng = np.random.default_rng(S + leaf)
    B, K, G, hd = 2, 2, 2, 32
    (jq, q), (jk, k), (jv, v) = (_normal(rng, s, dtype) for s in (
        (B, S, K, G, hd), (B, S, K, hd), (B, S, K, hd)))
    got = attention.full_causal(q, k, v, leaf=leaf, kv_block=kv_block)
    want = jax_attention.full_causal(jq, jk, jv, leaf=leaf,
                                     kv_block=kv_block)
    assert got.dtype == q.dtype
    _close(got, want, TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("S,window,q_block", [
    (160, 64, 64),          # bands of a padded KV
    (150, 64, 64),          # S not a q_block multiple: padded, sliced
    (48, 64, 512)])         # window covers everything: plain causal
def test_swa_matches_jax(S, window, q_block, dtype):
    rng = np.random.default_rng(S + window)
    B, K, G, hd = 1, 2, 3, 32
    (jq, q), (jk, k), (jv, v) = (_normal(rng, s, dtype) for s in (
        (B, S, K, G, hd), (B, S, K, hd), (B, S, K, hd)))
    got = attention.swa(q, k, v, window, q_block=q_block)
    _close(got, jax_attention.swa(jq, jk, jv, window, q_block=q_block),
           TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_matches_jax(dtype):
    rng = np.random.default_rng(11)
    B, K, G, Sc, hd = 2, 2, 3, 72, 32
    (jq, q), (jk, kc), (jv, vc) = (_normal(rng, s, dtype) for s in (
        (B, K, G, hd), (B, Sc, K, hd), (B, Sc, K, hd)))
    valid = rng.random(Sc) < 0.5
    valid[3] = True
    got = attention.decode(q, kc, vc, torch.from_numpy(valid))
    want = jax_attention.decode(jq, jk, jv, jnp.asarray(valid))
    _close(got, want, TOL[dtype])


# -------------------------------------------------------- selective scan
def _scan_inputs(rng, B, S, Di, N, h0_scale=0.0):
    x = {
        "dt": np.log1p(np.exp(rng.standard_normal((B, S, Di)))) * 0.1,
        "A": -np.exp(rng.standard_normal((Di, N)) * 0.2),
        "b": rng.standard_normal((B, S, N)),
        "c": rng.standard_normal((B, S, N)),
        "x": rng.standard_normal((B, S, Di)),
        "h0": rng.standard_normal((B, Di, N)) * h0_scale,
    }
    x = {k: v.astype(np.float32) for k, v in x.items()}
    order = ("dt", "A", "b", "c", "x", "h0")
    return ([jnp.asarray(x[k]) for k in order],
            [torch.from_numpy(x[k]) for k in order])


def _scan_close(got, want):
    for g, w in zip(got, want):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, atol=SCAN_TOL,
                                   rtol=SCAN_TOL)


@pytest.mark.parametrize("B,S,Di,N,h0_scale", [
    (2, 64, 32, 16, 0.0), (1, 37, 20, 5, 1.0), (3, 1, 8, 1, 1.0)])
def test_selective_scan_ref_matches_jax_ref(B, S, Di, N, h0_scale):
    rng = np.random.default_rng(B * S + Di)
    jargs, targs = _scan_inputs(rng, B, S, Di, N, h0_scale)
    got = selective_scan_ref(*targs)
    _scan_close(got, jax_selective_scan_ref(*jargs))
    # on CPU tensors the op takes the plain version
    assert all(torch.equal(a, b) for a, b in zip(selective_scan(*targs),
                                                  got))


@pytest.mark.parametrize("B,S,Di,N,db,tc", [
    (2, 64, 64, 16, 32, 32), (1, 96, 32, 8, 32, 32)])
def test_selective_scan_ref_matches_pallas_interpret(B, S, Di, N, db, tc):
    rng = np.random.default_rng(S + Di)
    jargs, targs = _scan_inputs(rng, B, S, Di, N, 0.5)
    want = jax_scan_kernel(*jargs, d_block=db, t_chunk=tc)
    _scan_close(selective_scan_ref(*targs), want)


@pytest.mark.parametrize("S,chunk", [(96, 32), (88, 256)])
def test_selective_scan_ref_matches_the_models_chunked_scan(S, chunk):
    rng = np.random.default_rng(S)
    jargs, targs = _scan_inputs(rng, 2, S, 24, 8, 0.5)
    want = jax_ssm.selective_scan(*jargs, chunk=chunk)
    _scan_close(selective_scan_ref(*targs), want)


def test_selective_scan_state_chaining():
    """The port's plain scan over two halves, with the state carried,
    equals JAX's scan over the whole (the Pallas kernel in interpret mode,
    as ``tests/test_kernels.py::test_selective_scan_state_chaining`` runs
    it)."""
    rng = np.random.default_rng(128)
    jargs, targs = _scan_inputs(rng, 1, 128, 32, 8)
    y_full, h_full = jax_scan_kernel(*jargs, d_block=32, t_chunk=32)
    dt, A, b, c, x, h = targs
    ys = []
    for sl in (slice(0, 64), slice(64, 128)):
        y, h = selective_scan_ref(dt[:, sl], A, b[:, sl], c[:, sl], x[:, sl],
                                  h)
        ys.append(y)
    _scan_close((torch.cat(ys, 1), h), (y_full, h_full))


@pytest.mark.parametrize("B,S,Di,sms,chunks", [
    (4, 144, 3200, 132, 1),      # hymba's prefill, run (a): one walk
    (1, 4224, 3200, 132, 33),    # the long request: 100 blocks, chunked
    (4, 16, 8192, 132, 1),       # falcon-mamba-7b's prefill
    (1, 0, 64, 132, 1), (1, 1, 64, 132, 1), (1, 128, 64, 132, 1),
    (1, 129, 64, 132, 2), (2, 383, 64, 132, 3),
    (16, 5000, 32, 8, 1),        # 2 blocks per SM: one walk
    (15, 5000, 32, 8, 40),       # fewer: chunks of 128
    (1, 100000, 32, 132, 782)])
def test_scan_chunk_plan(B, S, Di, sms, chunks):
    chunk = scan_ops.plan_chunk(B, S, Di, sms)
    assert scan_ops.n_chunks(S, chunk) == chunks
    assert chunk >= 1 and (chunks - 1) * chunk < max(S, 1) <= chunks * chunk
    assert chunks == 1 or chunk == scan_ops.CHUNK
