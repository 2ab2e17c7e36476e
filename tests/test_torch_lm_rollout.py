"""The port's LM rollout (``core.sampler.make_lm_rollout``) against the
JAX package's on the CPU (reduced widths, float32), and the training
mixer's kernel route.

The JAX package's weights are carried across; the reference's
``make_lm_rollout`` runs with a key, and the port's with that key's Gumbel
noise injected (``jax.random.gumbel`` over ``jax.random.split(key,
gen_len)``), after checking in JAX that the noise reproduces
``categorical``'s tokens: tokens and rewards equal, logp within 1e-5
(``tests/conftest.py``'s default).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import sampler as jax_sampler
from repro.envs import lm_env as jax_lm_env
from repro.models import transformer as jax_transformer
from repro_torch import convert
from repro_torch.core.sampler import make_lm_rollout
from repro_torch.models import ssm
from test_torch_lm_common import _model
from test_torch_lm_common import one_torch_thread  # noqa: F401

GEN, B, P = 6, 3, 5


@pytest.mark.parametrize("arch", ["hymba-1.5b-reduced",
                                  "mixtral-8x7b-reduced",
                                  "qwen2-vl-7b-reduced",
                                  "falcon-mamba-7b-reduced"])
def test_lm_rollout_matches_jax_with_its_gumbel_noise(arch):
    jcfg, tree, cfg, model = _model(arch)
    jparams = jax.tree.map(jnp.asarray, tree)
    jenv = jax_lm_env.make(jcfg.vocab_size, episode_len=GEN)
    prompt = np.random.default_rng(9).integers(
        0, cfg.vocab_size, (B, P), dtype=np.int32)
    key = jax.random.PRNGKey(3)
    want = jax.tree.map(np.asarray, jax.jit(jax_sampler.make_lm_rollout(
        jcfg, jenv, GEN))(jparams, jnp.asarray(prompt), key))
    gumbel = np.stack([np.asarray(jax.random.gumbel(
        k, (B, cfg.vocab_size), jnp.float32))
        for k in jax.random.split(key, GEN)])
    # in JAX, this noise gives categorical's tokens
    prefill = jax.jit(functools.partial(jax_transformer.prefill, jcfg,
                                        gen_budget=GEN))
    decode = jax.jit(functools.partial(jax_transformer.decode_step, jcfg))
    state, logits = prefill(jparams, jnp.asarray(prompt))
    toks = []
    for t in range(GEN):
        tok = jnp.argmax(logits + gumbel[t], axis=-1)
        toks.append(np.asarray(tok))
        state, logits = decode(jparams, state, tok[:, None])
    np.testing.assert_array_equal(np.stack(toks, 1), want["tokens"])

    env = convert.lm_env_from_jax(jenv.vocab_size, jenv.episode_len,
                                  jenv.reward_table)
    got = make_lm_rollout(cfg, env, GEN)(model, torch.from_numpy(prompt),
                                         gumbel=torch.from_numpy(gumbel))
    assert set(got) == set(want)
    for k in want:
        assert tuple(got[k].shape) == want[k].shape == (
            (B, P) if k == "prompt" else (B, GEN))
        assert not got[k].is_inference()
    np.testing.assert_array_equal(got["tokens"].numpy(), want["tokens"])
    np.testing.assert_array_equal(got["prompt"].numpy(), want["prompt"])
    np.testing.assert_allclose(got["logp"].numpy(), want["logp"],
                               atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(got["rewards"].numpy(), want["rewards"],
                               atol=1e-7, rtol=0)


def test_lm_rollout_draws_from_its_generator():
    _, _, cfg, model = _model("h2o-danube-3-4b-reduced")
    env = convert.lm_env_from_jax(cfg.vocab_size, GEN,
                                  np.zeros(cfg.vocab_size, np.float32))
    rollout = make_lm_rollout(cfg, env, GEN)
    prompt = torch.zeros((B, P), dtype=torch.long)
    a, b = (rollout(model, prompt, generator=torch.Generator().manual_seed(
        s)) for s in (1, 1))
    assert torch.equal(a["tokens"], b["tokens"])
    assert bool(torch.isfinite(a["logp"]).all() & (a["logp"] <= 0).all())
    with pytest.raises(ValueError, match="generator"):
        rollout(model, prompt)


def test_ssm_block_kernel_route_refuses_autograd():
    """The kernel route has no backward: under autograd it raises rather
    than fall back; without a gradient it runs (on the CPU through the
    kernel's plain version) and agrees with the plain chunked scan."""
    _, _, cfg, model = _model("falcon-mamba-7b-reduced")
    p = model.layers[0].ssm
    x = 0.1 * torch.randn((2, 9, cfg.d_model),
                          generator=torch.Generator().manual_seed(2))
    for impl in ("pallas", "cuda"):
        with pytest.raises(RuntimeError, match="no backward"):
            ssm.ssm_block(cfg, p, x, impl=impl)
        with torch.no_grad():
            torch.testing.assert_close(
                ssm.ssm_block(cfg, p, x, impl=impl),
                ssm.ssm_block(cfg, p, x, impl="reference"),
                atol=1e-5, rtol=1e-5)
    with pytest.raises(ValueError, match="impl"):
        ssm.ssm_block(cfg, p, x, impl="triton")
