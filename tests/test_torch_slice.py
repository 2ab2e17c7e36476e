"""The port's main path as a whole, on the CPU: rollout-step parity with the
JAX package (injected action noise and reset candidates), CPU runs of both
collection modes, the train CLI, the default-device rule, the rejection of
what is not ported, spec JSON shared with the JAX package, and an import
scan that keeps ``repro_torch`` free of ``jax`` and ``repro``.

The off-policy slice: one composed SAC × prioritized train step (observe,
then 4 sample -> learn -> priority updates) on a trajectory the JAX package
collected, against the JAX step, with the JAX draws injected; CPU runs of
SAC with both replay buffers through the CLI; ``next_obs`` in the rollout;
the buffer checks; a SAC spec's JSON shared with the JAX package.

Slice 3: cart-pole in the rollout-step parity and the CPU runs; one
composed DDPG × prioritized train step against the JAX step; CPU runs of
TRPO, DDPG and cart-pole through the CLI, each of which raises without
``--device cpu`` when there is no CUDA device.
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
from repro.algos import api as jax_api
from repro.core import sampler as jax_sampler
from repro.data import buffers as jax_buffers
from repro.kernels.env_step import ops as jax_env_ops
from repro.models import mlp_policy as jax_policy
from repro_torch import convert, envs, kernels, registry
from repro_torch.algos import sac
from repro_torch.algos.api import DDPGAlgorithm, PPOAlgorithm, make_train_step
from repro_torch.core import sampler
from repro_torch.data import buffers
from repro_torch.experiment import ExperimentSpec, Schedule, build, run
from repro_torch.launch import train

ROOT = Path(__file__).resolve().parents[1]


@pytest.mark.parametrize("name", ["pendulum", "cheetah", "cartpole"])
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
                  "cartpole": dict(force_max=10.0),
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
    ("cartpole", Schedule(num_samplers=2, global_batch=8, horizon=30,
                          iterations=2)),
    ("cartpole", Schedule(env_batch=8, horizon=30, iterations=2)),
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
    dict(runtime="fused",
         schedule=Schedule(overlap=True, learner_devices=2, fsdp=True)),
    dict(runtime="async", backend="threaded",
         schedule=Schedule(learner_devices=2)),
    dict(backend="process", schedule=Schedule(learner_microbatches=2)),
    dict(backend="threaded", schedule=Schedule(learner_pods=2)),
    dict(backend="sharded"),
    dict(schedule=Schedule(fsdp=True)),
    dict(runtime="async", backend="process", schedule=Schedule(fsdp=True)),
    dict(algo_kwargs={"aux_coef": 0.1}),
    dict(schedule=Schedule(learner_devices=2)),
    # the reference's overlap over a learner mesh (offset=1, pin_params)
    dict(schedule=Schedule(overlap=True, learner_devices=2)),
])
def test_unported_choices_are_rejected(change):
    spec = ExperimentSpec(**{"env": "cheetah", **change})
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        build(spec, device="cpu")


@pytest.mark.parametrize("change", [
    dict(algo="ppo", buffer="uniform"),
    dict(algo="ppo", buffer="prioritized"),
    dict(algo="sac", buffer="fifo"),
    dict(algo="sac", buffer="uniform", buffer_kwargs={"gamma": 0.9}),
])
def test_buffer_mismatch_raises_value_error(change):
    """As the reference's ``_resolve_buffer``: an on-policy algo takes only
    a trajectory buffer, an off-policy one only a replay buffer, and the
    discount comes from the algo, never from ``buffer_kwargs``."""
    spec = ExperimentSpec(env="cheetah", **change)
    with pytest.raises(ValueError):
        build(spec, device="cpu")
    with pytest.raises(ValueError):
        jax_experiment.build(jax_experiment.ExperimentSpec.from_dict(
            spec.to_dict()))


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


# ------------------------------------------------------- off-policy slice
def test_rollout_records_next_obs():
    env = envs.make("cheetah", max_episode_steps=3)
    algo = sac.SACAlgorithm(hidden=8)
    params, _ = algo.init(torch.Generator().manual_seed(0), env, "cpu")
    carry = sampler.init_env_carry(env, 1, 4, "cpu")
    _, traj = sampler.make_algo_rollout(algo, env, 5)(params, carry)
    assert set(traj) == {"obs", "actions", "rewards", "dones", "next_obs"}
    assert traj["next_obs"].shape == traj["obs"].shape == (5, 4, 14)
    # next_obs is the next step's obs (post-reset where an episode ended)
    assert torch.equal(traj["next_obs"][:-1], traj["obs"][1:])
    assert traj["dones"].any()


class _InjectedSAC(sac.SACAlgorithm):
    """SAC whose ``sample`` takes the next injected draw (stratified
    uniforms and the two learner noises) instead of the generator's."""

    def __init__(self, draws, **kwargs):
        super().__init__(**kwargs)
        self.draws = iter(draws)

    def sample(self, buffer, state, generator):
        u, noise_next, noise_new = next(self.draws)
        batch = buffer.sample_with(state, u)
        batch["noise_next"], batch["noise_new"] = noise_next, noise_new
        return batch


def test_sac_prioritized_train_step_matches_jax():
    """One composed step on a JAX-collected cheetah trajectory. Bounds:
    the replay ring exactly; params within 2e-5 (4 Adam steps on each
    loss, gradients differing in their last bits, as in
    ``tests/test_torch_ppo.py``); the tree within ``rtol=1e-5`` (its
    leaves are ``(|td| + eps) ** alpha`` of the learner's TD errors); the
    metrics within ``rtol=1e-4``. Params this close after 4 updates also
    mean that both sides drew the same minibatches."""
    T, N, CAP, BATCH, HIDDEN = 16, 4, 256, 32, 32
    jenv = jax_envs.make("cheetah", max_episode_steps=10)
    jalgo = jax_api.registry.make("algo", "sac", hidden=HIDDEN)
    jbuf = jax_buffers.PrioritizedBuffer(capacity=CAP, batch_size=BATCH)
    params, opt_state = jalgo.init(jax.random.PRNGKey(0), jenv)
    carry = jax_sampler.init_env_carry(jenv, jax.random.PRNGKey(1), N)
    _, traj = jax.jit(jax_sampler.make_algo_rollout(jalgo, jenv, T))(
        params, carry)
    assert np.asarray(traj["dones"]).any()
    key = jax.random.PRNGKey(2)
    plane = (jbuf.init(jalgo.transition_example(jenv)), key)
    p_j, s_j, (b_j, _), m_j = jax.jit(jax_api.make_train_step(jalgo, jbuf))(
        params, opt_state, plane, traj)

    # the draws the JAX step made: one key per update, split into the
    # buffer's and the learner's, the learner's into k_next and k_new
    draws = []
    for k in jax.random.split(key, 5)[1:]:
        k_buf, k_learn = jax.random.split(k)
        k_next, k_new = jax.random.split(k_learn)
        draws.append(tuple(torch.from_numpy(np.array(x)) for x in (
            jax.random.uniform(k_buf, (BATCH,)),
            jax.random.normal(k_next, (BATCH, 6)),
            jax.random.normal(k_new, (BATCH, 6)))))
    env = envs.make("cheetah", max_episode_steps=10)
    algo = _InjectedSAC(draws, hidden=HIDDEN)
    tbuf = buffers.PrioritizedBuffer(capacity=CAP, batch_size=BATCH)
    plane_t = (tbuf.init(algo.transition_example(env, "cpu")), None)
    indices = []
    update = tbuf.update_priorities

    def record(state, idx, prio):
        indices.append(idx.clone())
        return update(state, idx, prio)

    tbuf.update_priorities = record
    p_t, s_t, (b_t, _), m_t = make_train_step(algo, tbuf)(
        convert.sac_params_from_jax(jax.tree.map(np.asarray, params)),
        convert.sac_adam_states_from_jax(jax.tree.map(np.asarray,
                                                      opt_state)),
        plane_t, {k: torch.from_numpy(np.array(v)) for k, v in traj.items()})

    assert len(indices) == 4 and s_t[0].step == 4
    for k, v in b_t.ring.storage.items():
        np.testing.assert_array_equal(v.numpy(), np.asarray(b_j.ring.storage[k]))
    for g, w in zip(b_t.tree.levels, b_j.tree.levels):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5)
    for g, w in zip(jax.tree.leaves(convert.sac_params_to_jax(p_t)),
                    jax.tree.leaves(jax.tree.map(np.asarray, p_j))):
        np.testing.assert_allclose(g, w, rtol=0, atol=2e-5)
    for k in m_j:
        np.testing.assert_allclose(float(m_t[k]), float(m_j[k]), rtol=1e-4,
                                   atol=1e-6, err_msg=k)


@pytest.mark.parametrize("buffer", ["uniform", "prioritized"])
def test_sac_train_cli_cpu(capsys, buffer):
    kernels.reset_launch_counts()
    train.main(["--env", "cheetah", "--algo", "sac", "--buffer", buffer,
                "--device", "cpu", "--num-samplers", "2", "--global-batch",
                "8", "--horizon", "16", "--iterations", "2",
                "--replay-capacity", "1024", "--replay-batch", "32"])
    logs = [json.loads(line)
            for line in capsys.readouterr().out.strip().splitlines()]
    assert [lg["iteration"] for lg in logs] == [0, 1]
    for lg in logs:
        assert lg["samples"] == 8 * 16
        assert all(math.isfinite(lg[k]) for k in
                   ("mean_return", "collect_time", "learn_time"))
    assert kernels.launch_counts() == {k: 0 for k in kernels.KERNELS}


def test_sac_cpu_run_is_seeded():
    spec = ExperimentSpec(
        env="pendulum", algo="sac", buffer="prioritized",
        buffer_kwargs={"capacity": 100, "batch_size": 16, "n_step": 2},
        model={"hidden": 16}, env_kwargs={"max_episode_steps": 10},
        schedule=Schedule(num_samplers=2, global_batch=4, horizon=12,
                          iterations=2))
    first, again = run(spec, device="cpu"), run(spec, device="cpu")
    assert all(lg.mean_return != 0.0 for lg in first.logs)
    ring, tree, _ = first.runner.plane_state[0]
    assert tree.capacity == 128 and ring.size == 2 * 4 * 11
    assert float(tree.total) > 0.0
    for a, b in zip(first.params.parameters(), again.params.parameters()):
        assert torch.isfinite(a).all() and torch.equal(a, b)
    assert torch.equal(tree.flat, again.runner.plane_state[0].tree.flat)


def test_sac_spec_json_is_shared_with_jax():
    jspec = jax_experiment.ExperimentSpec(
        env="cheetah", algo="sac", buffer="prioritized",
        buffer_kwargs={"capacity": 64, "batch_size": 8, "n_step": 3},
        model={"hidden": 16},
        schedule=jax_experiment.Schedule(num_samplers=2, global_batch=4,
                                         horizon=6, iterations=1))
    d = json.loads(json.dumps(jspec.to_dict()))
    spec = ExperimentSpec.from_dict(d)
    assert spec.to_dict() == d
    assert jax_experiment.ExperimentSpec.from_dict(
        json.loads(json.dumps(spec.to_dict()))) == jspec
    result = run(spec, device="cpu")
    assert result.logs[0].samples == 24
    ring = result.runner.plane_state[0].ring
    assert ring.size == 4 * 4 and ring.storage["obs"].shape == (64, 14)
    assert result.params.actor[0].out_features == 16
    assert "sac" in registry.choices("algo")


# -------------------------------------------------------------- slice 3
class _InjectedDDPG(DDPGAlgorithm):
    """DDPG whose ``sample`` takes the next injected stratified uniforms
    instead of the generator's."""

    def __init__(self, draws, **kwargs):
        super().__init__(**kwargs)
        self.draws = iter(draws)

    def sample(self, buffer, state, generator):
        return buffer.sample_with(state, next(self.draws))


def test_ddpg_prioritized_train_step_matches_jax():
    """One composed step on a JAX-collected cheetah trajectory: observe,
    then 4 sample -> learn -> priority updates. Bounds as in the SAC case
    above: the ring exactly, params within 2e-5, the metrics within
    ``rtol=1e-4``; the tree within ``rtol=1e-5`` plus 1e-5 of its largest
    mass: DDPG's priority ``|q - target|`` is one difference (SAC's the
    mean of two), so where q nears the target the weights' last-bit
    differences (lr 1e-3, three times SAC's) become large relative ones
    in the smallest leaves."""
    T, N, CAP, BATCH, HIDDEN = 16, 4, 256, 32, 32
    jenv = jax_envs.make("cheetah", max_episode_steps=10)
    jalgo = jax_api.registry.make("algo", "ddpg", hidden=HIDDEN)
    jbuf = jax_buffers.PrioritizedBuffer(capacity=CAP, batch_size=BATCH)
    params, opt_state = jalgo.init(jax.random.PRNGKey(0), jenv)
    carry = jax_sampler.init_env_carry(jenv, jax.random.PRNGKey(1), N)
    _, traj = jax.jit(jax_sampler.make_algo_rollout(jalgo, jenv, T))(
        params, carry)
    assert np.asarray(traj["dones"]).any()
    key = jax.random.PRNGKey(2)
    plane = (jbuf.init(jalgo.transition_example(jenv)), key)
    p_j, s_j, (b_j, _), m_j = jax.jit(jax_api.make_train_step(jalgo, jbuf))(
        params, opt_state, plane, traj)

    # the buffer's draw of each update: its key split into the buffer's
    # and the (unused) learner's
    draws = [torch.from_numpy(np.array(jax.random.uniform(
        jax.random.split(k)[0], (BATCH,))))
        for k in jax.random.split(key, 5)[1:]]
    env = envs.make("cheetah", max_episode_steps=10)
    algo = _InjectedDDPG(draws, hidden=HIDDEN)
    tbuf = buffers.PrioritizedBuffer(capacity=CAP, batch_size=BATCH)
    plane_t = (tbuf.init(algo.transition_example(env, "cpu")), None)
    p_t, s_t, (b_t, _), m_t = make_train_step(algo, tbuf)(
        convert.ddpg_params_from_jax(jax.tree.map(np.asarray, params)),
        convert.ddpg_adam_states_from_jax(jax.tree.map(np.asarray,
                                                       opt_state)),
        plane_t, {k: torch.from_numpy(np.array(v)) for k, v in traj.items()})

    assert s_t[0].step == s_t[1].step == 4
    for k, v in b_t.ring.storage.items():
        np.testing.assert_array_equal(v.numpy(),
                                      np.asarray(b_j.ring.storage[k]))
    for g, w in zip(b_t.tree.levels, b_j.tree.levels):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-5,
                                   atol=1e-5 * float(w.max()))
    for g, w in zip(jax.tree.leaves(convert.ddpg_params_to_jax(p_t)),
                    jax.tree.leaves(jax.tree.map(np.asarray, p_j))):
        np.testing.assert_allclose(g, w, rtol=0, atol=2e-5)
    assert set(m_t) == set(m_j)
    for k in m_j:
        np.testing.assert_allclose(float(m_t[k]), float(m_j[k]), rtol=1e-4,
                                   atol=1e-6, err_msg=k)


SLICE3_CLI = {
    "trpo cheetah": ["--algo", "trpo", "--env", "cheetah"],
    "ddpg cheetah prioritized": [
        "--algo", "ddpg", "--env", "cheetah", "--buffer", "prioritized",
        "--replay-capacity", "1024", "--replay-batch", "32"],
    "ppo cartpole": ["--algo", "ppo", "--env", "cartpole"],
    "ppo cartpole env-batch": ["--algo", "ppo", "--env", "cartpole",
                               "--env-batch", "8"],
}


@pytest.mark.parametrize("run_name", list(SLICE3_CLI))
def test_slice3_train_cli_cpu(capsys, run_name):
    kernels.reset_launch_counts()
    train.main(SLICE3_CLI[run_name] + [
        "--device", "cpu", "--num-samplers", "2", "--global-batch", "8",
        "--horizon", "16", "--iterations", "2"])
    logs = [json.loads(line)
            for line in capsys.readouterr().out.strip().splitlines()]
    assert [lg["iteration"] for lg in logs] == [0, 1]
    for lg in logs:
        assert lg["samples"] == 8 * 16
        assert all(math.isfinite(lg[k]) for k in
                   ("mean_return", "collect_time", "learn_time"))
    assert kernels.launch_counts() == {k: 0 for k in kernels.KERNELS}


@pytest.mark.parametrize("run_name", list(SLICE3_CLI))
def test_slice3_train_cli_without_cuda_raises(monkeypatch, run_name):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train.main(SLICE3_CLI[run_name] + [
            "--num-samplers", "2", "--global-batch", "8", "--horizon", "16",
            "--iterations", "1"])


def test_trpo_and_ddpg_cpu_runs_are_seeded():
    for spec in (
            ExperimentSpec(env="cartpole", algo="trpo", model={"hidden": 16},
                           schedule=Schedule(num_samplers=2, global_batch=4,
                                             horizon=50, iterations=2)),
            ExperimentSpec(env="pendulum", algo="ddpg", buffer="prioritized",
                           buffer_kwargs={"capacity": 100, "batch_size": 16},
                           model={"hidden": 16},
                           env_kwargs={"max_episode_steps": 10},
                           schedule=Schedule(num_samplers=2, global_batch=4,
                                             horizon=12, iterations=2))):
        first, again = run(spec, device="cpu"), run(spec, device="cpu")
        assert all(lg.mean_return != 0.0 for lg in first.logs), spec.algo
        for a, b in zip(first.params.parameters(), again.params.parameters()):
            assert torch.isfinite(a).all() and torch.equal(a, b)
    assert {"trpo", "ddpg"} <= set(registry.choices("algo"))
    assert "cartpole" in registry.choices("env")
