"""The port's main path as a whole, on the CPU: rollout-step parity with the
JAX package (injected action noise and reset candidates), CPU runs of both
collection modes, the train CLI, the default-device rule, the rejection of
what is not ported, spec JSON shared with the JAX package, and an import
scan that keeps ``repro_torch`` free of ``jax`` and ``repro``.
"""
import ast
import dataclasses
import json
import math
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import envs as jax_envs
from repro import experiment as jax_experiment
from repro.kernels.env_step import ops as jax_env_ops
from repro.models import mlp_policy as jax_policy
from repro_torch import convert, envs, kernels
from repro_torch.algos.api import PPOAlgorithm
from repro_torch.core import sampler
from repro_torch.experiment import ExperimentSpec, Schedule, build, run
from repro_torch.launch import train

ROOT = Path(__file__).resolve().parents[1]


@pytest.mark.parametrize("name", ["pendulum", "cheetah"])
def test_rollout_step_matches_jax(name):
    """One step of the sampler body from identical weights, state, noise
    and reset candidates: the JAX side composes the reference's policy and
    env step by hand, the port runs its pure rollout step."""
    B, horizon = 16, 3
    jenv = jax_envs.make(name, max_episode_steps=horizon)
    params = jax.tree.map(np.asarray, jax_policy.init_policy(
        jax.random.PRNGKey(0), jenv.obs_dim, jenv.act_dim, hidden=64))
    ks = jax.random.split(jax.random.PRNGKey(1), 2)
    state, obs = jax.vmap(jenv.reset)(jax.random.split(ks[0], B))
    rstate, robs = jax.vmap(jenv.reset)(jax.random.split(ks[1], B))
    # a third of the instances at their last step: the reset select fires
    t = np.asarray(state[-1]).copy()
    t[: B // 3] = horizon - 1
    state = tuple(state[:-1]) + (jnp.asarray(t),)
    noise = np.random.default_rng(0).standard_normal(
        (B, jenv.act_dim)).astype(np.float32)

    jp = jax.tree.map(jnp.asarray, params)
    mean, std = jax_policy.policy_dist(jp, obs)
    act = mean + std * noise
    want_out = {"obs": obs, "actions": act,
                "logp": jax_policy.gaussian_logp(mean, std, act),
                "values": jax_policy.value_apply(jp, obs)}
    env_params = {"pendulum": dict(max_torque=2.0),
                  "cheetah": dict(ctrl_cost=0.1)}[name]
    want_state, want_obs, rew, done = jax_env_ops.env_step(
        name, state, act, rstate, robs, impl="ref",
        max_episode_steps=horizon, reward_scale=1.0, **env_params)
    want_out.update(rewards=rew, dones=done)

    def tt(x):
        return torch.from_numpy(np.array(x))

    env = envs.make(name, max_episode_steps=horizon)
    step = sampler.make_rollout_step(PPOAlgorithm(), env.batch_step)
    got_state, got_obs, out = step(
        convert.params_from_jax(params), tuple(map(tt, state)), tt(obs),
        tt(noise), tuple(map(tt, rstate)), tt(robs))
    for k, w in want_out.items():
        g = out[k].detach().numpy()
        assert g.dtype == np.asarray(w).dtype and g.shape == w.shape, k
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=2e-6, err_msg=k)
    for g, w in zip(list(got_state) + [got_obs],
                    list(want_state) + [want_obs]):
        np.testing.assert_allclose(g.detach().numpy(), w, rtol=1e-5,
                                   atol=2e-6)
    assert out["dones"].sum() >= B // 3


def test_batched_step_draws_reset_candidates_from_the_generator():
    env = envs.make("cheetah", max_episode_steps=2)
    state, obs, g = sampler.init_env_carry(env, 3, 5, "cpu")
    actions = torch.zeros(5, env.act_dim)
    g2 = torch.Generator().set_state(g.get_state())
    got = sampler.batched_step(env)(state, actions, g)
    rs, ro = env.reset(g2, 5, "cpu")
    want = env.batch_step(state, actions, rs, ro)
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("name,schedule", [
    ("pendulum", Schedule(num_samplers=2, global_batch=8, horizon=30,
                          iterations=2)),
    ("cheetah", Schedule(num_samplers=2, global_batch=8, horizon=30,
                         iterations=2)),
    ("cheetah", Schedule(env_batch=8, horizon=30, iterations=2)),
])
def test_cpu_run(name, schedule):
    kernels.reset_launch_counts()
    spec = ExperimentSpec(env=name, algo="ppo",
                          env_kwargs={"max_episode_steps": 10},
                          schedule=schedule)
    result = run(spec, device="cpu")
    batch = schedule.env_batch or schedule.global_batch
    assert len(result.logs) == 2
    for log in result.logs:
        assert log.samples == batch * schedule.horizon
        assert math.isfinite(log.mean_return) and log.mean_return != 0.0
        assert log.collect_time > 0 and log.learn_time > 0
    assert kernels.launch_counts() == {k: 0 for k in kernels.KERNELS}
    for p in result.params.parameters():
        assert p.device.type == "cpu" and torch.isfinite(p).all()
    # same seed, same run
    again = run(spec, device="cpu")
    for a, b in zip(result.params.parameters(), again.params.parameters()):
        assert torch.equal(a, b)


def test_train_cli_cpu(capsys):
    train.main(["--mode", "rl", "--env", "cheetah", "--algo", "ppo",
                "--num-samplers", "2", "--global-batch", "4",
                "--horizon", "8", "--iterations", "2", "--device", "cpu"])
    lines = capsys.readouterr().out.strip().splitlines()
    logs = [json.loads(line) for line in lines]
    assert [lg["iteration"] for lg in logs] == [0, 1]
    assert all(lg["samples"] == 32 for lg in logs)
    # the same keys as the JAX package's IterationLog
    assert set(logs[0]) == {
        f.name for f in dataclasses.fields(jax_experiment.IterationLog)}


def test_default_device_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build(ExperimentSpec(env="cheetah",
                             schedule=Schedule(num_samplers=1,
                                               global_batch=2, horizon=4)))


@pytest.mark.parametrize("change", [
    dict(runtime="fused"), dict(runtime="async"), dict(backend="process"),
    dict(algo="sac"), dict(env="cartpole"), dict(buffer="uniform"),
    dict(staleness="decay"), dict(algo_kwargs={"aux_coef": 0.1}),
    dict(schedule=Schedule(learner_devices=2)),
    dict(schedule=Schedule(overlap=True)),
])
def test_unported_choices_are_rejected(change):
    spec = ExperimentSpec(**{"env": "cheetah", **change})
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        build(spec, device="cpu")


def test_spec_json_is_shared_with_jax():
    jspec = jax_experiment.ExperimentSpec(
        env="cheetah", algo="ppo", kernels="pallas", model={"hidden": 32},
        schedule=jax_experiment.Schedule(num_samplers=2, global_batch=4,
                                         horizon=6, iterations=1))
    d = json.loads(json.dumps(jspec.to_dict()))
    spec = ExperimentSpec.from_dict(d)
    assert spec.to_dict() == d
    assert jax_experiment.ExperimentSpec.from_dict(
        json.loads(json.dumps(spec.to_dict()))) == jspec
    result = run(spec, device="cpu")
    assert result.logs[0].samples == 24
    assert result.params.pi[0].out_features == 32
    assert kernels.kernel_mode() == "cuda"          # 'pallas' read as 'cuda'
    kernels.set_kernel_mode("auto")


def _imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_port_imports_neither_jax_nor_repro():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 20
    for f in files:
        for mod in _imports(f):
            top = mod.split(".")[0]
            assert top not in ("jax", "jaxlib", "repro", "flax", "optax"), (
                f"{f.relative_to(ROOT)} imports {mod}")
