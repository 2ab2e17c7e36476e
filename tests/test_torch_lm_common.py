"""What the port's LM training tests share (no tests of its own): the
reduced archs, the JAX package's weights carried across, one PPO batch
per arch made from a seed with numpy, and the gradient check
(``tests/test_torch_lm_train.py``, ``tests/test_torch_lm_grads*.py``).

Gradients: 1e-5 absolute plus 1e-4 relative (the backward sums each
gradient over B·S positions and, for the MoE router, the top-k choices, in
another order than XLA's fused backward)."""
import copy
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.algos import ppo as jax_ppo
from repro.configs import get_config as jax_get_config
from repro.models import transformer as jax_transformer
from repro_torch import convert
from repro_torch.algos.ppo import PPOConfig, lm_ppo_loss
from repro_torch.configs import get_config

ARCHS = ["hymba-1.5b-reduced", "h2o-danube-3-4b-reduced",
         "falcon-mamba-7b-reduced", "mixtral-8x7b-reduced",
         "qwen2-vl-7b-reduced", "musicgen-medium-reduced"]
B, S = 2, 12
TOL = dict(atol=1e-5, rtol=1e-5)
GRAD_TOL = dict(atol=1e-5, rtol=1e-4)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for these small tensors, so a module run beside
    loaded test workers does not oversubscribe the host's cores (restored
    after the module); imported by each LM training test module."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@functools.lru_cache(maxsize=None)
def _model(arch):
    jcfg = jax_get_config(arch)
    tree = jax.tree.map(np.asarray, jax_transformer.init_params(
        jcfg, jax.random.PRNGKey(0)))
    cfg = get_config(arch)
    return jcfg, tree, cfg, convert.lm_params_from_jax(cfg, tree)


@functools.lru_cache(maxsize=None)
def _batch(arch):
    """The PPO batch as numpy arrays: tokens, targets, the float leaves,
    frontend embeds where the arch takes them and, for M-RoPE, (3, B, S)
    positions whose three rows differ."""
    cfg = get_config(arch)
    rng = np.random.default_rng(7)
    b = {"tokens": rng.integers(0, cfg.vocab_size, (B, S), dtype=np.int32),
         "targets": rng.integers(0, cfg.vocab_size, (B, S), dtype=np.int32),
         "behavior_logp": (-2.0 - rng.random((B, S))).astype(np.float32),
         "advantages": rng.standard_normal((B, S)).astype(np.float32),
         "returns": rng.standard_normal((B, S)).astype(np.float32),
         "mask": (rng.random((B, S)) < 0.8).astype(np.float32)}
    if cfg.frontend_embeds:
        b["extra_embeds"] = (0.5 * rng.standard_normal(
            (B, cfg.frontend_embeds, cfg.d_model))).astype(np.float32)
    if cfg.m_rope_sections:
        total = S + cfg.frontend_embeds + cfg.n_meta_tokens
        t = np.arange(total, dtype=np.int32)
        b["positions"] = np.broadcast_to(
            np.stack([t, t // 3, t % 5]), (B, 3, total)).transpose(
            1, 0, 2).copy()
    return b


def _jax(b):
    return {k: jnp.asarray(v) for k, v in b.items()}


def _torch(b):
    return {k: torch.from_numpy(v) for k, v in b.items()}


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               **tol)


def _grad_tree(model):
    """The gradients of ``model``'s parameters as the reference's tree."""
    grads = copy.deepcopy(model)
    with torch.no_grad():
        for g, p in zip(grads.parameters(), model.parameters()):
            g.copy_(p.grad)
    return convert.lm_params_to_jax(grads)


def check_lm_ppo_loss_and_grads(arch):
    """``lm_ppo_loss`` (aux_coef 0.1) and its gradients against the JAX
    package's, within ``GRAD_TOL``."""
    jcfg, tree, cfg, model = _model(arch)
    b = _batch(arch)
    jcfg_ppo = jax_ppo.PPOConfig(aux_coef=0.1)
    (jloss, jm), jgrads = jax.value_and_grad(
        lambda p: jax_ppo.lm_ppo_loss(jcfg, p, _jax(b), jcfg_ppo),
        has_aux=True)(jax.tree.map(jnp.asarray, tree))
    model = copy.deepcopy(model)
    loss, m = lm_ppo_loss(cfg, model, _torch(b), PPOConfig(aux_coef=0.1))
    loss.backward()
    _close(loss, jloss)
    for k in ("pg_loss", "v_loss", "entropy", "aux"):
        _close(m[k], jm[k])
    got = jax.tree_util.tree_flatten_with_path(_grad_tree(model))[0]
    want = jax.tree_util.tree_flatten_with_path(jgrads)[0]
    assert [p for p, _ in got] == [p for p, _ in want]
    for (path, g), (_, w) in zip(got, want):
        np.testing.assert_allclose(g, np.asarray(w), err_msg=str(path),
                                   **GRAD_TOL)
