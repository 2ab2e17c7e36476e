"""The gradients of the port's token-level PPO loss against the JAX
package's on the CPU, at reduced widths (float32): the reduced archs of the
dense, ssm, M-RoPE and audio families. The model, batch, check and bounds
are ``tests/test_torch_lm_common.py``'s; ``tests/test_torch_lm_grads.py``
holds hymba-1.5b-reduced and mixtral-8x7b-reduced. Also the trainer's
bfloat16 steps against the reference's.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.algos import ppo as jax_ppo
from repro.configs import get_config as jax_get_config
from repro.models import transformer as jax_transformer
from repro.optim.adam import adam as jax_adam
from repro_torch import convert
from repro_torch.algos.ppo import PPOConfig, make_lm_train_step
from repro_torch.configs import get_config
from repro_torch.optim import adam
from test_torch_lm_common import check_lm_ppo_loss_and_grads
from test_torch_lm_common import one_torch_thread  # noqa: F401


@pytest.mark.parametrize("arch", ["h2o-danube-3-4b-reduced",
                                  "falcon-mamba-7b-reduced",
                                  "qwen2-vl-7b-reduced",
                                  "musicgen-medium-reduced"])
def test_lm_ppo_loss_and_grads_match_jax(arch):
    check_lm_ppo_loss_and_grads(arch)


def test_bfloat16_train_steps_track_jax():
    """The LM trainer's dtype at reduced width: bfloat16 params and Adam
    moments (``adam(lr, moment_dtype=cfg.dtype)``, as ``--mode lm``), the
    JAX package's weights carried across, four steps on the same random
    batches: each step's loss and grad norm within 2e-2 relative of the
    reference's. Both packages round every bfloat16 op (2^-8 relative) at
    their own points, and each step's params carry the last's rounding;
    one CPU run gave at most 0.6 % here."""
    arch = "hymba-1.5b-reduced"
    jcfg = dataclasses.replace(jax_get_config(arch), dtype="bfloat16")
    cfg = dataclasses.replace(get_config(arch), dtype="bfloat16")
    tree = jax_transformer.init_params(jcfg, jax.random.PRNGKey(0))
    model = convert.lm_params_from_jax(cfg, jax.tree.map(np.asarray, tree))
    jopt = jax_adam(3e-4, moment_dtype=jcfg.dtype)
    opt = adam(3e-4, moment_dtype=cfg.dtype)
    jstate, state = jopt.init(tree), opt.init(list(model.parameters()))
    jstep = jax.jit(jax_ppo.make_lm_train_step(jcfg, jopt,
                                               jax_ppo.PPOConfig()))
    step = make_lm_train_step(cfg, opt, PPOConfig())
    rng = np.random.default_rng(0)
    B, S = 2, 16
    for _ in range(4):
        toks = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
        normal = rng.standard_normal((B, S)).astype(np.float32)
        batch = {"tokens": toks, "targets": toks,
                 "behavior_logp": np.full((B, S), -5.0, np.float32),
                 "advantages": normal, "returns": normal,
                 "mask": np.ones((B, S), np.float32)}
        tree, jstate, jm = jstep(tree, jstate, {
            k: jnp.asarray(v) for k, v in batch.items()})
        model, state, m = step(model, state, {
            k: torch.from_numpy(v) for k, v in batch.items()})
        for k in ("loss", "grad_norm"):
            np.testing.assert_allclose(float(m[k]), float(jm[k]),
                                       rtol=2e-2, err_msg=k)
    assert all(x.dtype == torch.bfloat16 for x in state.mu + state.nu)
