"""The port's MoE block, M-RoPE tables and Adam options against the JAX
package on the CPU (float32 unless stated), plus the four MoE properties
of ``tests/test_moe_ssm.py`` on the port.

MoE: the JAX package's ``init_moe`` weights carried across, activations
from a seed with numpy, at a capacity factor that drops tokens (0.5) and
at one that drops none; routing indices exactly, weights, probs, the aux
loss and the block's output within 1e-5 (``tests/conftest.py``'s
default). M-RoPE: cos/sin within 1e-6 (``cos``/``sin`` of the same
float32 angles may differ by an ulp). Adam: three steps on injected
identical gradients, each package's own chain, run op by op on the JAX
side (``jax.jit`` contracts multiply-adds): float32 moments and updates
within 1e-6 relative, bfloat16 ones within one bfloat16 ulp (2^-8
relative). The updates are compared, not the stepped params: a first
Adam step turns each gradient's sign into ±lr.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import moe as jax_moe
from repro.models import rope as jax_rope
from repro.optim.adam import adam as jax_adam
from repro.optim.adam import apply_updates as jax_apply_updates
from repro.optim import schedules as jax_schedules
from repro_torch.configs import get_config
from repro_torch.models import layers, moe, rope
from repro_torch.optim import adam, apply_updates, schedules
from test_torch_lm_common import one_torch_thread  # noqa: F401

TOL = dict(atol=1e-5, rtol=1e-5)


def _cfgs(**kw):
    jcfg = jax_get_config("mixtral-8x7b-reduced")
    cfg = get_config("mixtral-8x7b-reduced")
    return (dataclasses.replace(jcfg, **kw), dataclasses.replace(cfg, **kw))


def _moe_params(jcfg, cfg, seed=11):
    jp = jax.tree.map(np.asarray, jax_moe.init_moe(
        jcfg, jax.random.PRNGKey(seed)))
    p = moe.MoE(cfg)
    with torch.no_grad():
        for name, t in p.named_parameters():
            t.copy_(torch.from_numpy(np.array(jp[name], np.float32)))
    return jp, p


def _x(shape, seed=3):
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    return jnp.asarray(x), torch.from_numpy(x)


@pytest.mark.parametrize("capacity_factor,shape", [
    (0.5, (2, 16)), (1.25, (2, 16)), (4.0, (1, 8)), (0.5, (1, 2048))])
def test_route_and_moe_block_match_jax(capacity_factor, shape):
    """At factor 0.5 a group's capacity holds half its routed slots, so
    tokens are dropped; (1, 2048) runs the two dispatch groups of
    ``GROUP_TOKENS``."""
    jcfg, cfg = _cfgs(capacity_factor=capacity_factor)
    jp, p = _moe_params(jcfg, cfg)
    jx, x = _x(shape + (cfg.d_model,))
    w, idx, probs, aux = moe.route(cfg, p.router, x)
    jw, jidx, jprobs, jaux = jax_moe.route(jcfg, jnp.asarray(jp["router"]),
                                           jx)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    for got, want in ((w, jw), (probs, jprobs), (aux, jaux)):
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                                   **TOL)
    y, aux = moe.moe_block(cfg, p, x)
    jy, jaux = jax_moe.moe_block(jcfg, jax.tree.map(jnp.asarray, jp), jx)
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(jy), **TOL)
    np.testing.assert_allclose(float(aux.detach()), float(jaux), **TOL)
    S = shape[1] if shape[1] <= moe.GROUP_TOKENS else moe.GROUP_TOKENS
    dropped = moe.capacity(cfg, S) * cfg.n_experts < S * cfg.top_k
    assert dropped == (capacity_factor == 0.5)


# ------------------------------------- tests/test_moe_ssm.py's properties
def _own(**kw):
    cfg = get_config("mixtral-8x7b-reduced")
    cfg = dataclasses.replace(cfg, **kw) if kw else cfg
    return cfg, moe.MoE(cfg, torch.Generator().manual_seed(11))


def _xt(shape):
    return torch.randn(shape, generator=torch.Generator().manual_seed(11))


@torch.no_grad()
def test_router_weights_sum_to_one():
    cfg, p = _own()
    w, idx, probs, aux = moe.route(cfg, p.router, _xt((2, 16, cfg.d_model)))
    torch.testing.assert_close(w.sum(-1), torch.ones(2, 16), rtol=1e-5,
                               atol=1e-5)
    assert int(idx.max()) < cfg.n_experts
    # aux loss is E * sum f_e p_e >= 1 (Cauchy-Schwarz, = 1 iff uniform)
    assert float(aux) >= 0.99


@torch.no_grad()
def test_moe_equals_dense_when_single_expert():
    """E=1, k=1, ample capacity: MoE output == plain SwiGLU of expert 0."""
    cfg, p = _own(n_experts=1, top_k=1, capacity_factor=2.0)
    x = _xt((2, 8, cfg.d_model))
    y, _ = moe.moe_block(cfg, p, x)
    dense = layers.MLP(cfg.d_model, cfg.d_ff, torch.float32)
    for name in ("w1", "w3", "w2"):
        getattr(dense, name).copy_(getattr(p, name)[0])
    torch.testing.assert_close(y, layers.mlp(dense, x), atol=2e-5,
                               rtol=0)


@torch.no_grad()
def test_moe_capacity_drops_tokens():
    """With capacity_factor -> 0, (almost) everything is dropped -> y ~ 0."""
    cfg, p = _own(capacity_factor=1e-6)
    y, _ = moe.moe_block(cfg, p, _xt((1, 16, cfg.d_model)))
    # capacity is max(1, ...) = 1 slot per expert: most tokens dropped
    assert float((y.abs() > 0).float().mean()) < 0.6


@torch.no_grad()
def test_moe_permutation_equivariance():
    """Permuting tokens within a group permutes outputs identically
    (capacity permitting): routing does not depend on position."""
    cfg, p = _own(capacity_factor=4.0)
    x = _xt((1, 8, cfg.d_model))
    perm = torch.tensor([3, 1, 7, 0, 5, 2, 6, 4])
    y1, _ = moe.moe_block(cfg, p, x)
    y2, _ = moe.moe_block(cfg, p, x[:, perm])
    torch.testing.assert_close(y1[:, perm], y2, atol=2e-5, rtol=0)


# ----------------------------------------------------------------- M-RoPE
@pytest.mark.parametrize("sections", [(6, 5, 5), (16, 24, 24)])
def test_m_rope_tables_match_jax(sections):
    head_dim = 2 * sum(sections)
    rng = np.random.default_rng(2)
    pos = rng.integers(0, 4000, (3, 2, 9)).astype(np.int32)
    got = rope.rope_cos_sin(torch.from_numpy(pos), head_dim, 1e6, sections)
    want = jax_rope.rope_cos_sin(jnp.asarray(pos), head_dim, 1e6, sections)
    for g, w in zip(got, want):
        assert g.shape == (2, 9, head_dim // 2)
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-6,
                                   rtol=0)
    # each channel reads its own section's row: equal rows give plain RoPE
    same = np.broadcast_to(pos[:1], pos.shape).copy()
    m_cos, m_sin = rope.rope_cos_sin(torch.from_numpy(same), head_dim, 1e6,
                                     sections)
    p_cos, p_sin = rope.rope_cos_sin(torch.from_numpy(pos[0]), head_dim,
                                     1e6)
    assert torch.equal(m_cos, p_cos) and torch.equal(m_sin, p_sin)
    with pytest.raises(ValueError, match="M-RoPE"):
        rope.rope_cos_sin(torch.from_numpy(pos[0]), head_dim, 1e6, sections)


# ------------------------------------------------------------------- Adam
SHAPES = ((4, 8), (8,), (3, 5))
ADAM_CASES = {
    "schedule_decay": dict(dtype="float32", moment=None, wd=0.1,
                           lr="schedule"),
    "bf16_moments": dict(dtype="float32", moment="bfloat16", wd=0.0,
                         lr=3e-4),
    "bf16_params_and_moments": dict(dtype="bfloat16", moment="bfloat16",
                                    wd=0.01, lr=3e-4),
}


def _assert_close(got, want, dtype):
    want = np.asarray(want, np.float32)
    got = got.detach().float().numpy()
    rtol = 2.0 ** -8 if dtype == "bfloat16" else 1e-6
    np.testing.assert_allclose(got, want, rtol=rtol, atol=0)


@pytest.mark.parametrize("case", list(ADAM_CASES))
def test_adam_options_match_jax(case):
    c = ADAM_CASES[case]
    rng = np.random.default_rng(4)
    jdt = jnp.dtype(c["dtype"])
    tdt = getattr(torch, c["dtype"])
    p0 = [rng.standard_normal(s).astype(np.float32) for s in SHAPES]
    jparams = [jnp.asarray(x).astype(jdt) for x in p0]
    params = [torch.from_numpy(x).to(tdt) for x in p0]
    if c["lr"] == "schedule":
        jlr = jax_schedules.linear_warmup_cosine(1e-3, 2, 10)
        lr = schedules.linear_warmup_cosine(1e-3, 2, 10)
    else:
        jlr = lr = c["lr"]
    jopt = jax_adam(jlr, weight_decay=c["wd"], moment_dtype=c["moment"])
    opt = adam(lr, weight_decay=c["wd"], moment_dtype=c["moment"])
    jstate, state = jopt.init(jparams), opt.init(params)
    mdt = c["moment"] or c["dtype"]
    assert all(m.dtype == getattr(torch, mdt) for m in state.mu + state.nu)
    for _ in range(3):
        g = [rng.standard_normal(s).astype(np.float32) for s in SHAPES]
        jupd, jstate = jopt.update([jnp.asarray(x).astype(jdt) for x in g],
                                   jstate, jparams)
        upd, state = opt.update([torch.from_numpy(x).to(tdt) for x in g],
                                state, params)
        for u, ju, m, jm, v, jv in zip(upd, jupd, state.mu, jstate.mu,
                                       state.nu, jstate.nu):
            assert u.dtype == tdt
            _assert_close(u, ju, c["dtype"])
            _assert_close(m, jm, mdt)
            _assert_close(v, jv, mdt)
        jparams = jax_apply_updates(jparams, jupd)
        apply_updates(params, upd)
        assert int(state.step) == int(jstate.step)
