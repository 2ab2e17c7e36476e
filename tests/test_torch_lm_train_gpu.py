"""LM training and the LM rollout on the card (a CUDA device).

Every test here needs a CUDA device and skips without one. The file
imports neither ``jax`` nor ``repro``, so it runs where only PyTorch is
installed:

    PYTHONPATH=src python -m pytest --noconftest -m gpu \
        tests/test_torch_lm_train_gpu.py

Bounds: float32 with TF32 off. The rollout's behaviour logp (the kernels:
flash and decode attention, the scan) against the plain paths: the plain
decode path teacher-forced with the rollout's tokens, and the training
``forward`` + ``token_logp_entropy`` over the whole context ``[prompt,
tokens[:, :-1]]``, within 2e-4: ``chip_smoke.py``'s 1e-4 on float32
logits of 4 layers, twice (a logp is a logit minus a log-sum-exp of
them). An MoE arch is held to the decode path only: its capacity is per
dispatch group, so the forward over the whole context drops other slots
than the prefill and the one-token decode steps do (the reference's
GShard semantics; with a capacity that drops nothing the two agree to
1e-6 on the CPU).
"""
import dataclasses
import math

import pytest
import torch

from repro_torch import kernels
from repro_torch.configs import get_config
from repro_torch.core.sampler import make_lm_rollout
from repro_torch.envs import lm_env
from repro_torch.launch import train
from repro_torch.models import ssm, transformer

LOGP_TOL = 2e-4
GEN, B, P = 8, 3, 6


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def plain_logps(cfg, params, prompt, tokens):
    """The behaviour logp of ``tokens`` by the plain paths: teacher-forced
    decode, and the training forward over ``[prompt, tokens[:, :-1]]``."""
    T = tokens.shape[1]
    prev = kernels.set_kernel_mode("ref")
    try:
        with torch.no_grad():
            state, logits = transformer.prefill(cfg, params, prompt,
                                                gen_budget=T)
            decode = []
            for t in range(T):
                decode.append(torch.log_softmax(logits, -1).gather(
                    -1, tokens[:, t:t + 1])[:, 0])
                state, logits = transformer.decode_step(
                    cfg, params, state, tokens[:, t:t + 1])
            context = torch.cat([prompt, tokens[:, :-1]], dim=1)
            h, _ = transformer.forward(cfg, params, context, remat="none")
            fwd, _ = transformer.token_logp_entropy(cfg, params, h[:, -T:],
                                                    tokens)
    finally:
        kernels.set_kernel_mode(prev)
    return torch.stack(decode, 1), fwd


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["hymba-1.5b-reduced",
                                  "falcon-mamba-7b-reduced",
                                  "mixtral-8x7b-reduced",
                                  "qwen2-vl-7b-reduced"])
def test_lm_rollout_through_the_kernels_matches_the_plain_paths(cuda, arch):
    cfg = get_config(arch)
    gen = torch.Generator(device=cuda).manual_seed(1)
    params = transformer.init_params(cfg, gen)
    env = lm_env.make(cfg.vocab_size, episode_len=GEN, device=cuda)
    prompt = torch.randint(0, cfg.vocab_size, (B, P), generator=gen,
                           device=cuda)
    kernels.reset_launch_counts()
    prev = kernels.set_kernel_mode("cuda")
    try:
        traj = make_lm_rollout(cfg, env, GEN)(params, prompt,
                                              generator=gen)
    finally:
        kernels.set_kernel_mode(prev)
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    L = cfg.n_layers
    assert counts["selective_scan"] == (L if cfg.is_ssm else 0)
    assert counts["flash_attention"] == (L if cfg.has_attention else 0)
    assert counts["decode_attention"] == (GEN * L if cfg.has_attention
                                          else 0)
    decode, fwd = plain_logps(cfg, params, prompt, traj["tokens"])
    torch.testing.assert_close(traj["logp"], decode, atol=LOGP_TOL, rtol=0)
    if not cfg.is_moe:
        torch.testing.assert_close(traj["logp"], fwd, atol=LOGP_TOL,
                                   rtol=0)
    assert torch.equal(traj["rewards"], env.token_rewards(traj["tokens"]))


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["hymba-1.5b-reduced",
                                  "mixtral-8x7b-reduced"])
def test_lm_train_step_on_the_card(cuda, arch):
    run = train.main(["--mode", "lm", "--arch", arch, "--steps", "2",
                      "--batch", "2", "--seq-len", "16"])
    assert all(p.device.type == "cuda" for p in run.params.parameters())
    for m in run.metrics:
        assert all(math.isfinite(v) for v in m.values()), m
    assert all(torch.isfinite(p).all() for p in run.params.parameters())
    fresh = transformer.init_params(
        run.cfg, torch.Generator(device=cuda).manual_seed(0))
    assert any(not torch.equal(a, b) for a, b in
               zip(run.params.parameters(), fresh.parameters()))


@pytest.mark.gpu
def test_lm_train_step_in_bfloat16_on_the_card(cuda):
    """The full-width dtype: bfloat16 params and Adam moments."""
    from repro_torch.algos.ppo import PPOConfig, make_lm_train_step
    from repro_torch.optim import adam
    cfg = dataclasses.replace(get_config("hymba-1.5b-reduced"),
                              dtype="bfloat16")
    params = transformer.init_params(
        cfg, torch.Generator(device=cuda).manual_seed(0))
    opt = adam(3e-4, moment_dtype=cfg.dtype)
    state = opt.init(list(params.parameters()))
    step = make_lm_train_step(cfg, opt, PPOConfig())
    batch = train.lm_batch(cfg, 2, 16,
                           torch.Generator(device=cuda).manual_seed(1))
    for _ in range(2):
        params, state, m = step(params, state, batch)
        assert math.isfinite(float(m["loss"]))
        assert math.isfinite(float(m["grad_norm"]))
    assert all(x.dtype == torch.bfloat16 for x in state.mu + state.nu)


@pytest.mark.gpu
def test_ssm_block_kernel_route_refuses_autograd_on_the_card(cuda):
    cfg = get_config("falcon-mamba-7b-reduced")
    params = transformer.init_params(
        cfg, torch.Generator(device=cuda).manual_seed(2))
    p = params.layers[0].ssm
    gen = torch.Generator(device=cuda).manual_seed(3)
    x = 0.1 * torch.randn((2, 9, cfg.d_model), device=cuda, generator=gen)
    with pytest.raises(RuntimeError, match="no backward"):
        ssm.ssm_block(cfg, p, x, impl="pallas")
    kernels.reset_launch_counts()
    with torch.no_grad():
        got = ssm.ssm_block(cfg, p, x, impl="cuda")
        want = ssm.ssm_block(cfg, p, x, impl="reference")
    torch.cuda.synchronize()
    assert kernels.launch_counts()["selective_scan"] == 1
    torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)
