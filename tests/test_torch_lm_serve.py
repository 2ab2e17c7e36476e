"""The LM serving slice as a whole, against the JAX package on the CPU.

Weights come from the JAX package's ``init_params`` and are carried across
by ``convert.lm_params_from_jax``; prompts and forced tokens are made from
a seed with numpy; sampling noise is JAX's Gumbel noise, injected through
the port's noise source (``jax.random.categorical`` is ``argmax(logits +
gumbel)``).

Bounds: logits within 5e-5 (float32, of order 4; every layer's sums run in
another order, measured below 1e-5) and the decode state within 2e-5;
``pos`` and ``cache_pos`` exactly; sampled tokens exactly.
"""
import contextlib
import dataclasses
import functools
import io
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.core import serving as jax_serving
from repro.envs import lm_env as jax_lm_env
from repro.launch import serve as jax_serve
from repro.models import transformer as jax_transformer
from repro_torch import convert
from repro_torch.configs import get_config
from repro_torch.core.serving import Request, SlotServer
from repro_torch.envs import lm_env
from repro_torch.launch import serve
from repro_torch.models import transformer

LOGIT_TOL = 5e-5
STATE_TOL = 2e-5


@functools.lru_cache(maxsize=None)
def _model(arch, seed=0):
    jcfg = jax_get_config(arch)
    tree = jax.tree.map(np.asarray, jax_transformer.init_params(
        jcfg, jax.random.PRNGKey(seed)))
    cfg = get_config(arch)
    return jcfg, tree, cfg, convert.lm_params_from_jax(cfg, tree)


class JaxGumbel:
    """A noise source that splits a JAX key per draw, as the JAX
    ``SlotServer`` does, and returns ``jax.random.gumbel`` noise."""

    def __init__(self, seed):
        self.key = jax.random.PRNGKey(seed)

    def __call__(self, shape):
        self.key, k = jax.random.split(self.key)
        return torch.from_numpy(np.array(jax.random.gumbel(k, shape)))


@pytest.mark.parametrize("arch,prompt_len", [
    ("hymba-1.5b-reduced", 8),
    ("hymba-1.5b-reduced", 80),        # + 8 meta tokens > window 64: wraps
    ("falcon-mamba-7b-reduced", 8),
    ("h2o-danube-3-4b-reduced", 70),   # dense family, SWA ring
])
def test_prefill_and_decode_match_jax(arch, prompt_len):
    jcfg, tree, cfg, model = _model(arch)
    B, steps = 2, 8
    rng = np.random.default_rng(prompt_len)
    prompt = rng.integers(0, cfg.vocab_size, (B, prompt_len)).astype(np.int32)
    forced = rng.integers(0, cfg.vocab_size, (steps, B, 1)).astype(np.int32)

    jstate, jlogits = jax_transformer.prefill(jcfg, tree, jnp.asarray(prompt),
                                              gen_budget=steps)
    state, logits = transformer.prefill(cfg, model, torch.from_numpy(prompt),
                                        gen_budget=steps)
    jstep = jax.jit(functools.partial(jax_transformer.decode_step, jcfg))
    for t in range(steps + 1):
        np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                                   atol=LOGIT_TOL, rtol=0)
        if t == steps:
            break
        jstate, jlogits = jstep(tree, jstate, jnp.asarray(forced[t]))
        state, logits = transformer.decode_step(cfg, model, state,
                                                torch.from_numpy(forced[t]))
    assert set(state) == set(jstate)
    assert state["pos"] == int(jstate["pos"]) == cfg.n_meta_tokens + \
        prompt_len + steps
    for key, want in jstate.items():
        if key in ("pos", "cache_pos"):
            np.testing.assert_array_equal(np.asarray(state[key]),
                                          np.asarray(want))
        else:
            np.testing.assert_allclose(state[key].numpy(), np.asarray(want),
                                       atol=STATE_TOL, rtol=0)
    if "cache_pos" in state and prompt_len + cfg.n_meta_tokens > \
            cfg.sliding_window:
        assert int(state["cache_pos"].min()) > 0      # the ring wrapped


def test_generate_matches_jax_with_its_noise():
    jcfg, tree, cfg, model = _model("hymba-1.5b-reduced")
    B, P, gen_len = 2, 12, 10
    prompt = np.random.default_rng(3).integers(
        0, cfg.vocab_size, (B, P)).astype(np.int32)
    key = jax.random.PRNGKey(7)
    want = jax.jit(lambda p, t, k: jax_serve.generate(jcfg, p, t, gen_len, k)
                   )(tree, jnp.asarray(prompt), key)
    keys = iter(jax.random.split(key, gen_len))
    noise = lambda shape: torch.from_numpy(  # noqa: E731
        np.array(jax.random.gumbel(next(keys), shape)))
    toks, logits = serve.generate(cfg, model, torch.from_numpy(prompt),
                                  gen_len, noise=noise)
    assert toks.shape == (B, gen_len) and logits.shape == (
        B, gen_len, cfg.vocab_size)
    np.testing.assert_array_equal(toks.numpy(), np.asarray(want))


# ------------------------------------------------------------- SlotServer
def _server(slots=3, prompt_len=6, max_new=5, eos=None):
    """The ``tests/test_serving.py`` server, on the port's own weights."""
    cfg = get_config("h2o-danube-3-4b-reduced")
    params = transformer.init_params(cfg, torch.Generator().manual_seed(0))
    return cfg, SlotServer(cfg, params, slots=slots, prompt_len=prompt_len,
                           max_new_tokens=max_new, eos_id=eos)


def _prompt(seed, n, vocab):
    return torch.from_numpy(np.random.default_rng(seed).integers(0, vocab, n))


def test_slot_server_all_requests_complete():
    cfg, server = _server()
    for i in range(7):              # 7 requests on 3 slots -> 3 waves
        server.submit(Request(request_id=i,
                              prompt=_prompt(i, 6, cfg.vocab_size),
                              max_new_tokens=5))
    completions = server.run()
    assert sorted(c.request_id for c in completions) == list(range(7))
    for c in completions:
        assert 1 <= len(c.tokens) <= 5
        assert all(0 <= t < cfg.vocab_size for t in c.tokens)
        assert c.latency > 0 and c.queue_wait >= 0
    snap = server.snapshot()
    assert snap["requests"] == 7 and snap["slots"] == 3
    assert snap["dispatches"] == 3 * 5        # one per emitted step, 3 waves


def test_slot_server_eos_stops_early_and_counts_waste():
    cfg, server = _server(slots=2, max_new=30, eos=0)
    for i in range(2):
        server.submit(Request(request_id=i,
                              prompt=_prompt(10 + i, 6, cfg.vocab_size),
                              max_new_tokens=30))
    completions = server.run()
    assert len(completions) == 2
    for c in completions:
        assert len(c.tokens) <= 30
        if len(c.tokens) < 30:
            assert c.tokens[-1] == 0
    assert server.decode_steps >= 1


def test_slot_server_per_request_budget_respected():
    cfg, server = _server(slots=2, max_new=8)
    p = torch.zeros(6, dtype=torch.int64)
    server.submit(Request(request_id=0, prompt=p, max_new_tokens=2))
    server.submit(Request(request_id=1, prompt=p, max_new_tokens=8))
    completions = {c.request_id: c for c in server.run()}
    assert len(completions[0].tokens) == 2
    assert len(completions[1].tokens) == 8
    assert server.wasted_slot_steps > 0     # request 0 rode out the wave
    with pytest.raises(ValueError, match="left-padded"):
        server.submit(Request(request_id=2, prompt=torch.zeros(5),
                              max_new_tokens=1))


def test_slot_server_matches_jax_with_its_noise():
    """Same weights, prompts and Gumbel noise: the port's completions are
    the JAX server's, token for token, through EOS stops and a padded last
    wave."""
    jcfg, tree, cfg, model = _model("hymba-1.5b-reduced")
    prompts = np.random.default_rng(4).integers(
        0, cfg.vocab_size, (5, 6)).astype(np.int32)
    budgets = [4, 7, 7, 2, 7]

    def jax_server(eos_id):
        server = jax_serving.SlotServer(jcfg, tree, slots=2, prompt_len=6,
                                        max_new_tokens=7, eos_id=eos_id,
                                        seed=3)
        for i, (p, n) in enumerate(zip(prompts, budgets)):
            server.submit(jax_serving.Request(i, jnp.asarray(p), n))
        return server, {c.request_id: c.tokens for c in server.run()}

    # an EOS id that request 2 emits as its third token, so it stops early
    eos_id = jax_server(None)[1][2][2]
    jserver, want = jax_server(eos_id)
    server = SlotServer(cfg, model, slots=2, prompt_len=6, max_new_tokens=7,
                        eos_id=eos_id, noise=JaxGumbel(3))
    for i, (p, n) in enumerate(zip(prompts, budgets)):
        server.submit(Request(i, torch.from_numpy(p), n))
    got = {c.request_id: c.tokens for c in server.run()}
    assert got == want
    assert len(got[2]) <= 3 and got[2][-1] == eos_id
    assert server.decode_steps == jserver.decode_steps
    assert server.wasted_slot_steps == jserver.wasted_slot_steps
    assert set(server.snapshot()) == set(jserver.snapshot())


# ----------------------------------------------------- CLI, env, convert
def test_serve_cli_runs_on_cpu_and_needs_a_device_flag(monkeypatch):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        run = serve.main(["--arch", "hymba-1.5b-reduced", "--device", "cpu",
                          "--batch", "2", "--prompt-len", "80",
                          "--gen-len", "8", "--requests", "2"])
    lines = out.getvalue().splitlines()
    assert len(lines) == 3
    for r, line in enumerate(lines[:2]):
        assert line.startswith(f"request {r}: 8 tokens x 2 seqs in ")
        assert "mean reward" in line
    counts = json.loads(lines[2])["kernel_launches"]
    assert counts["flash_attention"] == counts["selective_scan"] == 0
    for req in run.requests:
        assert req.tokens.shape == (2, 8)
        assert ((req.tokens >= 0) & (req.tokens < run.cfg.vocab_size)).all()
        assert torch.isfinite(req.logits).all()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        serve.main(["--arch", "hymba-1.5b-reduced", "--requests", "1"])


def test_lm_env_rewards_match_jax():
    jenv = jax_lm_env.make(512, episode_len=6)
    env = convert.lm_env_from_jax(512, 6, np.asarray(jenv.reward_table))
    toks = np.random.default_rng(5).integers(0, 512, (3, 6))
    toks[:, 3] = toks[:, 2]                           # a repeat
    np.testing.assert_allclose(
        env.token_rewards(torch.from_numpy(toks)).numpy(),
        np.asarray(jenv.token_rewards(jnp.asarray(toks))), atol=1e-7)
    own = lm_env.make(512, episode_len=6)
    assert own.reward_table.shape == (512,)
    assert 0.3 < float(own.reward_table.std()) < 0.7


@pytest.mark.parametrize("arch,dtype", [
    ("hymba-1.5b-reduced", "float32"), ("falcon-mamba-7b-reduced", "float32"),
    ("qwen1.5-32b-reduced", "float32"), ("hymba-1.5b-reduced", "bfloat16")])
def test_lm_params_round_trip(arch, dtype):
    jcfg = dataclasses.replace(jax_get_config(arch), dtype=dtype)
    cfg = dataclasses.replace(get_config(arch), dtype=dtype)
    tree = jax.tree.map(np.asarray, jax_transformer.init_params(
        jcfg, jax.random.PRNGKey(1)))
    model = convert.lm_params_from_jax(cfg, tree)
    assert model.embed.table.dtype == getattr(torch, dtype)
    back = convert.lm_params_to_jax(model)
    want = jax.tree_util.tree_flatten_with_path(tree)[0]
    got = jax.tree_util.tree_flatten_with_path(back)[0]
    assert [p for p, _ in got] == [p for p, _ in want]
    for (path, g), (_, w) in zip(got, want):
        assert g.dtype == np.float32
        np.testing.assert_array_equal(g, np.asarray(w, np.float32),
                                      err_msg=str(path))
    tree["lm_head"]["w"] = tree["lm_head"]["w"][:, :-1]
    with pytest.raises(ValueError, match="shape"):
        convert.lm_params_from_jax(cfg, tree)


@pytest.mark.parametrize("arch", ["mixtral-8x7b-reduced",
                                  "qwen2-vl-7b-reduced"])
def test_unported_families_raise(arch):
    """These two families (MoE; M-RoPE with frontend embeds) were refused
    by name until the LM training slice ported them; the test keeps its
    name and now holds them to the reference instead: the model builds,
    and prefill (with frontend embeds where the arch takes them) and four
    forced decode steps give the JAX package's logits and state."""
    jcfg, tree, cfg, model = _model(arch)
    assert transformer.init_params(cfg, torch.Generator()).layers
    B, P, steps = 2, 8, 4
    rng = np.random.default_rng(11)
    prompt = rng.integers(0, cfg.vocab_size, (B, P)).astype(np.int32)
    forced = rng.integers(0, cfg.vocab_size, (steps, B, 1)).astype(np.int32)
    extra = (rng.standard_normal((B, cfg.frontend_embeds, cfg.d_model))
             .astype(np.float32) if cfg.frontend_embeds else None)
    jstate, jlogits = jax_transformer.prefill(
        jcfg, tree, jnp.asarray(prompt), gen_budget=steps,
        extra_embeds=None if extra is None else jnp.asarray(extra))
    state, logits = transformer.prefill(
        cfg, model, torch.from_numpy(prompt), gen_budget=steps,
        extra_embeds=None if extra is None else torch.from_numpy(extra))
    jstep = jax.jit(functools.partial(jax_transformer.decode_step, jcfg))
    for t in range(steps + 1):
        np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                                   atol=LOGIT_TOL, rtol=0)
        if t == steps:
            break
        jstate, jlogits = jstep(tree, jstate, jnp.asarray(forced[t]))
        state, logits = transformer.decode_step(cfg, model, state,
                                                torch.from_numpy(forced[t]))
    for key in ("k", "v"):
        np.testing.assert_allclose(state[key].numpy(),
                                   np.asarray(jstate[key]), atol=STATE_TOL,
                                   rtol=0)
    assert state["pos"] == int(jstate["pos"]) == P + steps + \
        cfg.frontend_embeds
