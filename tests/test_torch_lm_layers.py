"""The LM layers of the port against the JAX package on the CPU, at the
``hymba-1.5b-reduced`` and ``falcon-mamba-7b-reduced`` widths (float32).

Weights come from the JAX package's ``init_params`` (seed 0) and are
carried across by ``convert.lm_params_from_jax``; activations are made from
a seed with numpy. Bound: 2e-5 absolute on float32 outputs of order one
(sums in another order; ``exp``, ``cos``, ``sin``, ``rsqrt`` may differ by
an ulp), 0 where the port only moves values.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import attention as jax_attention
from repro.models import layers as jax_layers
from repro.models import rope as jax_rope
from repro.models import ssm as jax_ssm
from repro.models import transformer as jax_transformer
from repro_torch import convert
from repro_torch.configs import get_config
from repro_torch.models import attention, layers, rope, ssm

TOL = 2e-5


@functools.lru_cache(maxsize=None)
def _model(arch):
    jcfg = jax_get_config(arch)
    tree = jax.tree.map(np.asarray, jax_transformer.init_params(
        jcfg, jax.random.PRNGKey(0)))
    return jcfg, tree, get_config(arch), convert.lm_params_from_jax(
        get_config(arch), tree)


def _layer0(tree, key):
    return jax.tree.map(lambda x: jnp.asarray(x[0]), tree["layers"][key])


def _x(shape, seed=0):
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    return jnp.asarray(x), torch.from_numpy(x)


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=tol, rtol=0)


def test_rmsnorm_and_mlp_match_jax():
    jcfg, tree, cfg, model = _model("hymba-1.5b-reduced")
    jx, x = _x((2, 7, cfg.d_model))
    lyr = model.layers[0]
    # a norm scale that is not all ones
    scale = np.linspace(0.5, 1.5, cfg.d_model).astype(np.float32)
    with torch.no_grad():
        lyr.mlp_norm.scale.copy_(torch.from_numpy(scale))
    _close(layers.rmsnorm(lyr.mlp_norm, x, cfg.norm_eps),
           jax_layers.rmsnorm({"scale": jnp.asarray(scale)}, jx,
                              jcfg.norm_eps))
    _close(layers.mlp(lyr.mlp, x), jax_layers.mlp(_layer0(tree, "mlp"), jx))


def test_embed_and_linear_match_jax():
    jcfg, tree, cfg, model = _model("hymba-1.5b-reduced")
    tokens = np.random.default_rng(1).integers(0, cfg.vocab_size, (2, 5))
    got = layers.embed(model.embed, torch.from_numpy(tokens))
    want = jax_layers.embed(tree["embed"], jnp.asarray(tokens))
    np.testing.assert_array_equal(got.detach().numpy(), np.asarray(want))
    jx, x = _x((3, cfg.d_model))
    _close(layers.linear(model.value_head, x),
           jax_layers.linear(tree["value_head"], jx))


@pytest.mark.parametrize("theta", [10_000.0, 500_000.0])
def test_rope_matches_jax(theta):
    pos = np.random.default_rng(2).integers(0, 5000, (2, 9)).astype(np.int32)
    jcs = jax_rope.rope_cos_sin(jnp.asarray(pos), 32, theta)
    cs = rope.rope_cos_sin(torch.from_numpy(pos), 32, theta)
    for got, want in zip(cs, jcs):
        # angles up to 5000 rad: cos/sin of one float32 angle, 2 ulp at 1
        _close(got, want, 2.5e-7)
    jx, x = _x((2, 9, 4, 32), seed=3)
    _close(rope.apply_rope(x, *cs), jax_rope.apply_rope(jx, *jcs))


def test_ssm_parts_match_jax():
    jcfg, tree, cfg, model = _model("falcon-mamba-7b-reduced")
    jp, p = _layer0(tree, "ssm"), model.layers[0].ssm
    jx, x = _x((2, 11, cfg.d_inner), seed=4)
    _close(ssm.causal_conv(p, x), jax_ssm.causal_conv(jp, jx))
    for got, want in zip(ssm._ssm_inputs(cfg, p, x),
                         jax_ssm._ssm_inputs(jcfg, jp, jx)):
        _close(got, want)
    jh, h = _x((2, 3, cfg.d_model), seed=5)
    jconv, conv = _x((2, cfg.ssm_conv - 1, cfg.d_inner), seed=6)
    jstate, state = _x((2, cfg.d_inner, cfg.ssm_state), seed=7)
    got = ssm.ssm_decode_block(cfg, p, h[:, :1], conv, state)
    want = jax_ssm.ssm_decode_block(jcfg, jp, jh[:, :1], jconv, jstate)
    for g, w in zip(got, want):
        _close(g, w)


def test_ssm_init_matches_jax_where_it_is_not_random():
    """A, D, the conv bias and the dt bias (numpy's RandomState(0) draw)
    are the reference's values; the random matrices have its shapes."""
    jcfg, tree, cfg, _ = _model("hymba-1.5b-reduced")
    p = ssm.SSM(cfg, torch.Generator().manual_seed(0))
    jp = _layer0(tree, "ssm")
    for name in ("A_log", "D", "conv_b", "dt_bias"):
        np.testing.assert_array_equal(getattr(p, name).detach().numpy(),
                                      np.asarray(jp[name]))
    for name, param in p.named_parameters():
        assert tuple(param.shape) == jp[name].shape, name


def _rope_tables(cfg, B, S, start=0):
    pos = np.broadcast_to(np.arange(start, start + S, dtype=np.int32),
                          (B, S))
    jcs = jax_rope.rope_cos_sin(jnp.asarray(pos), cfg.head_dim,
                                cfg.rope_theta)
    return jcs, rope.rope_cos_sin(torch.from_numpy(pos.copy()),
                                  cfg.head_dim, cfg.rope_theta)


@pytest.mark.parametrize("S", [20, 90])     # inside and past the window 64
def test_project_qkv_and_attention_block_match_jax(S):
    jcfg, tree, cfg, model = _model("hymba-1.5b-reduced")
    jp, p = _layer0(tree, "attn"), model.layers[0].attn
    jx, x = _x((2, S, cfg.d_model), seed=S)
    jcs, cs = _rope_tables(cfg, 2, S)
    for got, want in zip(attention.project_qkv(cfg, p, x, *cs),
                         jax_attention.project_qkv(jcfg, jp, jx, *jcs)):
        _close(got, want)
    got = attention.attention_block(cfg, p, x, *cs, return_kv=True)
    want = jax_attention.attention_block(jcfg, jp, jx, *jcs, return_kv=True)
    for g, w in zip(got, want):
        _close(g, w)


def test_attention_decode_block_matches_jax():
    jcfg, tree, cfg, model = _model("hymba-1.5b-reduced")
    jp, p = _layer0(tree, "attn"), model.layers[0].attn
    C, K, hd = 40, cfg.n_kv_heads, cfg.head_dim
    jk, k = _x((2, C, K, hd), seed=8)
    jv, v = _x((2, C, K, hd), seed=9)
    valid = np.random.default_rng(10).random(C) < 0.7
    valid[17] = True
    jx, x = _x((2, 1, cfg.d_model), seed=11)
    jcs, cs = _rope_tables(cfg, 2, 1, start=57)
    got = attention.attention_decode_block(cfg, p, x, *cs, k, v,
                                           torch.from_numpy(valid), 17)
    want = jax_attention.attention_decode_block(
        jcfg, jp, jx, *jcs, jk, jv, jnp.asarray(valid), 17)
    for g, w in zip(got, want):
        _close(g, w)
    assert got[1] is k and got[2] is v        # the caches, written in place
