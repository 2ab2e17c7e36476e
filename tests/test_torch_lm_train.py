"""The port's LM training forward against the JAX package on the CPU, at
reduced widths (float32): ``forward`` in every remat mode, ``value``,
``token_logp_entropy``, ``lm_ppo_loss`` and its gradients, for
``hymba-1.5b-reduced`` and the five reduced archs of the families the
port trains (dense, ssm, MoE, M-RoPE + vision embeds, audio embeds);
``tests/test_torch_lm_grads.py`` holds the loss's gradients.

Weights come from the JAX package's ``init_params`` (seed 0) and are
carried across by ``convert.lm_params_from_jax``; tokens, frontend embeds,
M-RoPE positions and the PPO batch are made from a seed with numpy.
Forward, heads and loss: ``tests/conftest.py``'s default bound, 1e-5
absolute and relative (sums in another order; the port runs the reference's
chunked associative scan and attention recursion op by op). The five remat
modes give bit-identical gradients: they recompute the same ops on the same
inputs. Also the four properties of ``tests/test_lm_ppo.py`` on the port.
"""
import copy
import dataclasses
import functools

import numpy as np
import pytest
import torch

from repro.models import transformer as jax_transformer
from repro_torch.algos.ppo import PPOConfig, lm_ppo_loss
from repro_torch.configs import get_config
from repro_torch.models import transformer
from test_torch_lm_common import (ARCHS, B, S, _batch, _close, _jax,
                                  _model, _torch)
from test_torch_lm_common import one_torch_thread  # noqa: F401

REMATS = ("none", "full", "scan2", "dots", "scan2_dots")

@functools.lru_cache(maxsize=None)
def _jax_forward(arch):
    jcfg, tree, _, _ = _model(arch)
    jb = _jax(_batch(arch))
    h, aux = jax_transformer.forward(
        jcfg, tree, jb["tokens"], positions=jb.get("positions"),
        extra_embeds=jb.get("extra_embeds"), remat="none")
    hs = h[:, -S:]
    logp, ent = jax_transformer.token_logp_entropy(jcfg, tree, hs,
                                                   jb["targets"])
    return tuple(np.asarray(x) for x in (
        h, aux, jax_transformer.value(jcfg, tree, h), logp, ent))


@pytest.mark.parametrize("remat", REMATS)
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_value_logp_match_jax(arch, remat):
    _, _, cfg, model = _model(arch)
    tb = _torch(_batch(arch))
    h, aux = transformer.forward(cfg, model, tb["tokens"],
                                 positions=tb.get("positions"),
                                 extra_embeds=tb.get("extra_embeds"),
                                 remat=remat)
    want_h, want_aux, want_v, want_logp, want_ent = _jax_forward(arch)
    _close(h, want_h)
    _close(aux, want_aux)
    assert (float(aux.detach()) > 0) == cfg.is_moe
    _close(transformer.value(cfg, model, h), want_v)
    logp, ent = transformer.token_logp_entropy(cfg, model, h[:, -S:],
                                               tb["targets"])
    _close(logp, want_logp)
    _close(ent, want_ent)


@pytest.mark.parametrize("arch", ["hymba-1.5b-reduced",
                                  "mixtral-8x7b-reduced",
                                  "qwen2-vl-7b-reduced"])
def test_remat_modes_give_bit_identical_grads(arch):
    """At 4 layers, so the two ``scan2`` modes nest (2 groups of 2): every
    mode's gradients equal ``"none"``'s bit for bit, and its loss too."""
    cfg = dataclasses.replace(get_config(arch), n_layers=4)
    base = transformer.init_params(cfg, torch.Generator().manual_seed(1))
    tb = _torch(_batch(arch))
    out = {}
    for remat in REMATS:
        model = copy.deepcopy(base)
        loss, _ = lm_ppo_loss(cfg, model, tb, PPOConfig(), remat=remat)
        loss.backward()
        out[remat] = (loss.detach(), [p.grad for p in model.parameters()])
    loss0, grads0 = out["none"]
    assert all(g is not None for g in grads0)
    for remat in REMATS[1:]:
        loss, grads = out[remat]
        assert torch.equal(loss, loss0), remat
        assert all(torch.equal(a, b) for a, b in zip(grads, grads0)), remat


def test_forward_rejects_an_unknown_remat():
    _, _, cfg, model = _model("h2o-danube-3-4b-reduced")
    with pytest.raises(ValueError, match="remat"):
        transformer.forward(cfg, model, torch.zeros((1, 4), dtype=torch.long),
                            remat="scan3")


# ------------------------------------ tests/test_lm_ppo.py's properties
def _prop_batch(cfg, mask=None):
    rng = np.random.default_rng(5)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, S)))
    return {"tokens": toks, "targets": torch.roll(toks, -1, dims=1),
            "behavior_logp": torch.full((B, S), -2.0),
            "advantages": torch.from_numpy(
                rng.standard_normal((B, S)).astype(np.float32)),
            "returns": torch.from_numpy(
                rng.standard_normal((B, S)).astype(np.float32)),
            "mask": torch.ones((B, S)) if mask is None else mask}


def _own(arch):
    cfg = get_config(arch)
    return cfg, transformer.init_params(cfg,
                                        torch.Generator().manual_seed(5))


@torch.no_grad()
def test_masked_positions_do_not_affect_loss():
    cfg, params = _own("h2o-danube-3-4b-reduced")
    mask = torch.ones((B, S))
    mask[:, S // 2:] = 0.0
    batch = _prop_batch(cfg, mask)
    loss1, _ = lm_ppo_loss(cfg, params, batch, PPOConfig())
    batch2 = dict(batch)
    for k, v in (("advantages", 1e3), ("returns", -1e3),
                 ("behavior_logp", 0.0)):
        batch2[k] = batch[k].clone()
        batch2[k][:, S // 2:] = v
    loss2, _ = lm_ppo_loss(cfg, params, batch2, PPOConfig())
    assert float(loss1) == pytest.approx(float(loss2), rel=1e-6)


@torch.no_grad()
def test_zero_advantage_reduces_to_value_entropy():
    cfg, params = _own("h2o-danube-3-4b-reduced")
    batch = _prop_batch(cfg)
    batch["advantages"] = torch.zeros((B, S))
    _, m = lm_ppo_loss(cfg, params, batch, PPOConfig())
    assert float(m["pg_loss"]) == pytest.approx(0.0, abs=1e-6)


@torch.no_grad()
def test_moe_aux_included():
    cfg, params = _own("mixtral-8x7b-reduced")
    loss_with, m = lm_ppo_loss(cfg, params, _prop_batch(cfg),
                               PPOConfig(aux_coef=1.0))
    loss_without, _ = lm_ppo_loss(cfg, params, _prop_batch(cfg),
                                  PPOConfig(aux_coef=0.0))
    assert float(m["aux"]) > 0
    assert float(loss_with) == pytest.approx(
        float(loss_without) + float(m["aux"]), rel=1e-4)


def test_logp_entropy_chunked_matches_full():
    cfg, params = _own("h2o-danube-3-4b-reduced")
    g = torch.Generator().manual_seed(5)
    h = torch.randn((B, S, cfg.d_model), generator=g)
    tgt = torch.randint(0, cfg.vocab_size, (B, S), generator=g)
    logp_c, ent_c = transformer.token_logp_entropy(cfg, params, h, tgt,
                                                   chunk=4)
    z = transformer.lm_logits(cfg, params, h)
    lse = torch.logsumexp(z, -1)
    logp_f = torch.gather(z, -1, tgt[..., None])[..., 0] - lse
    ent_f = lse - torch.sum(torch.softmax(z, -1) * z, -1)
    torch.testing.assert_close(logp_c, logp_f, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(ent_c, ent_f, rtol=1e-4, atol=1e-4)
