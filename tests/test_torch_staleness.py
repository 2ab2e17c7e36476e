"""Staleness correction in the port (``repro_torch.algos.staleness`` and
its hooks) against the JAX package: ``StalenessConfig`` parsing and
validation; ``decay_weights`` and ``vtrace_rho`` on seeded inputs; PPO's
weighted loss and a whole weighted ``learn`` with the same injected
``staleness_gap``; ``off`` leaving the learner bit for bit; and the
off-policy ``staleness_w`` leaf riding the replay buffer into the
learner's ``weights``.

Tolerances: the weights within 1e-6 relative (float32 ``pow`` and ``exp``
of XLA and ATen may differ in the last bits); the loss and gradients and
the weights after a ``learn`` within the bounds ``tests/test_torch_ppo.py``
states for the unweighted learner (2e-5 absolute after 16 Adam steps)."""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import envs as jax_envs
from repro import registry as jax_registry
from repro.algos import ppo as jax_ppo
from repro.algos import staleness as jax_staleness
from repro.core import sampler as jax_sampler
from repro.models import mlp_policy as jax_policy
from repro.optim import adam as jax_adam
from repro_torch import convert, envs, registry
from repro_torch.algos import ppo, staleness
from repro_torch.optim import adam

HORIZON, BATCH = 32, 8


@pytest.fixture(scope="module")
def collected():
    """(params, traj, gap) from the JAX package: cheetah with 20-step
    episodes, and a seeded version gap of 0 to 3 per sampler column."""
    env = jax_envs.make("cheetah", max_episode_steps=20)
    params = jax_policy.init_policy(jax.random.PRNGKey(1), env.obs_dim,
                                    env.act_dim, hidden=64)
    carry = jax_sampler.init_env_carry(env, jax.random.PRNGKey(2), BATCH)
    _, traj = jax.jit(jax_sampler.make_env_rollout(env, HORIZON))(
        params, carry)
    traj = {k: np.asarray(v) for k, v in traj.items()}
    gap = np.broadcast_to(
        np.random.default_rng(0).integers(0, 4, BATCH).astype(np.float32),
        (HORIZON, BATCH)).copy()
    return jax.tree.map(np.asarray, params), traj, gap


def _torch(tree):
    return {k: torch.from_numpy(np.array(v)) for k, v in tree.items()}


@pytest.mark.parametrize("value", [
    None, "off", "decay", "vtrace", {"mode": "vtrace", "decay": 0.8},
    {"mode": "decay", "decay": 1.0, "rho_clip": 2.0}])
def test_staleness_config_parse_matches_jax(value):
    got = staleness.StalenessConfig.parse(value)
    want = jax_staleness.StalenessConfig.parse(value)
    assert got.to_dict() == want.to_dict()
    assert got.enabled == want.enabled
    assert staleness.StalenessConfig.parse(got) is got
    assert staleness.MODES == jax_staleness.MODES


@pytest.mark.parametrize("kwargs,match", [
    (dict(mode="banana"), "mode"), (dict(mode="decay", decay=1.5), "decay"),
    (dict(mode="decay", decay=0.0), "decay"),
    (dict(mode="vtrace", rho_clip=0.0), "rho_clip")])
def test_staleness_config_validation_matches_jax(kwargs, match):
    for cls in (staleness.StalenessConfig, jax_staleness.StalenessConfig):
        with pytest.raises(ValueError, match=match):
            cls(**kwargs)


@pytest.mark.parametrize("decay", [0.5, 0.9, 0.99, 1.0])
def test_decay_weights_match_jax(decay):
    rng = np.random.default_rng(int(decay * 100))
    gap = np.concatenate([rng.integers(0, 40, 200),
                          rng.uniform(0, 8, 56)]).astype(np.float32)
    cfg = dict(mode="decay", decay=decay)
    got = staleness.decay_weights(staleness.StalenessConfig(**cfg),
                                  torch.from_numpy(gap))
    want = jax_staleness.decay_weights(jax_staleness.StalenessConfig(**cfg),
                                       jnp.asarray(gap))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=0)


@pytest.mark.parametrize("rho_clip", [0.5, 1.0, 2.0])
def test_vtrace_rho_matches_jax(rho_clip):
    rng = np.random.default_rng(7)
    now, mu = (rng.standard_normal(256).astype(np.float32) for _ in range(2))
    cfg = dict(mode="vtrace", rho_clip=rho_clip)
    got = staleness.vtrace_rho(staleness.StalenessConfig(**cfg),
                               torch.from_numpy(now), torch.from_numpy(mu))
    want = jax_staleness.vtrace_rho(jax_staleness.StalenessConfig(**cfg),
                                    jnp.asarray(now), jnp.asarray(mu))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=0)
    assert float(got.max()) <= rho_clip


def test_weighted_loss_and_grads_match_jax(collected):
    params, traj, gap = collected
    rng = np.random.default_rng(1)
    n = HORIZON * BATCH
    batch = {
        "obs": traj["obs"].reshape(n, -1),
        "actions": traj["actions"].reshape(n, -1),
        "behavior_logp": traj["logp"].reshape(n),
        "advantages": rng.standard_normal(n).astype(np.float32),
        "returns": rng.standard_normal(n).astype(np.float32),
        "weights": (0.9 ** gap).reshape(n).astype(np.float32),
    }
    (loss_j, _), g_j = jax.value_and_grad(
        lambda p: jax_ppo.mlp_ppo_loss(p, jax.tree.map(jnp.asarray, batch),
                                       jax_ppo.PPOConfig()),
        has_aux=True)(jax.tree.map(jnp.asarray, params))
    policy = convert.params_from_jax(params)
    loss_t, _ = ppo.mlp_ppo_loss(policy, _torch(batch), ppo.PPOConfig())
    grads = torch.autograd.grad(loss_t, list(policy.parameters()))
    np.testing.assert_allclose(float(loss_t.detach()), float(loss_j),
                               rtol=1e-5)
    for a, b in zip(grads, convert._flat(jax.tree.map(np.asarray, g_j))):
        np.testing.assert_allclose(a.numpy(), b, rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("mode", ["decay", "vtrace"])
def test_weighted_learn_matches_jax(collected, mode):
    """One ``learn`` on a trajectory stamped with the same gap, both
    packages: 16 weighted Adam steps."""
    params, traj, gap = collected
    traj = {**traj, "staleness_gap": gap}
    opt_j = jax_adam(3e-4)
    learn_j = jax.jit(jax_ppo.make_mlp_learner(
        opt_j, jax_ppo.PPOConfig(),
        staleness=jax_staleness.StalenessConfig(mode=mode)))
    jp = jax.tree.map(jnp.asarray, params)
    p_j, _, m_j = learn_j(jp, opt_j.init(jp),
                          {k: jnp.asarray(v) for k, v in traj.items()})

    policy = convert.params_from_jax(params)
    opt_t = adam(3e-4)
    learn_t = ppo.make_mlp_learner(
        opt_t, ppo.PPOConfig(),
        staleness=staleness.StalenessConfig(mode=mode))
    policy, _, m_t = learn_t(policy, opt_t.init(list(policy.parameters())),
                             _torch(traj))
    got = convert.params_to_jax(policy)
    for a, b in zip(jax.tree.leaves(got),
                    jax.tree.leaves(jax.tree.map(np.asarray, p_j))):
        np.testing.assert_allclose(a, b, rtol=0, atol=2e-5)
    for k in ("loss", "pg_loss", "v_loss"):
        np.testing.assert_allclose(float(m_t[k]), float(m_j[k]), rtol=1e-3,
                                   atol=1e-5)


def test_off_leaves_the_learner_bit_for_bit(collected):
    """``off`` installs nothing, and a learner built with staleness but fed
    a trajectory with no gap (every lock-step path) is the plain learner,
    bit for bit; unit weights give the unweighted loss exactly."""
    params, traj, _ = collected
    results = []
    for cfg in (None, staleness.StalenessConfig(mode="decay")):
        policy = convert.params_from_jax(params)
        opt = adam(3e-4)
        learn = ppo.make_mlp_learner(opt, ppo.PPOConfig(), staleness=cfg)
        policy, _, m = learn(policy, opt.init(list(policy.parameters())),
                             _torch(traj))
        results.append((list(policy.parameters()), m["loss"]))
    (p1, l1), (p2, l2) = results
    assert all(torch.equal(a, b) for a, b in zip(p1, p2))
    assert torch.equal(l1, l2)

    algo = registry.make("algo", "ppo")
    learn = algo._learn
    algo.enable_staleness("off")
    assert algo._learn is learn and not algo.staleness.enabled

    n = HORIZON * BATCH
    batch = _torch({"obs": traj["obs"].reshape(n, -1),
                    "actions": traj["actions"].reshape(n, -1),
                    "behavior_logp": traj["logp"].reshape(n),
                    "advantages": traj["rewards"].reshape(n),
                    "returns": traj["values"].reshape(n)})
    policy = convert.params_from_jax(params)
    off, _ = ppo.mlp_ppo_loss(policy, batch, ppo.PPOConfig())
    ones, _ = ppo.mlp_ppo_loss(policy, {**batch, "weights": torch.ones(n)},
                               ppo.PPOConfig())
    assert torch.equal(off, ones)


def test_offpolicy_staleness_weight_rides_the_buffer():
    """Enabled, the replay schema gains ``staleness_w``; ``observe`` stores
    ``decay ** gap`` per transition (its first step's, as JAX's does) and
    ``sample`` multiplies it into ``weights``. Disabled, the schema is
    unchanged."""
    env, jenv = envs.make("pendulum"), jax_envs.make("pendulum")
    algo = registry.make("algo", "ddpg", hidden=16)
    jalgo = jax_registry.make("algo", "ddpg", hidden=16)
    assert "staleness_w" not in algo.transition_example(env, "cpu")
    algo.enable_staleness({"mode": "decay", "decay": 0.5})
    jalgo.enable_staleness({"mode": "decay", "decay": 0.5})
    ex = algo.transition_example(env, "cpu")
    assert set(ex) == set(jalgo.transition_example(jenv))
    T, B = 6, 2
    rng = np.random.default_rng(3)
    traj = {"obs": rng.standard_normal((T, B, 3)).astype(np.float32),
            "actions": rng.standard_normal((T, B, 1)).astype(np.float32),
            "rewards": rng.standard_normal((T, B)).astype(np.float32),
            "next_obs": rng.standard_normal((T, B, 3)).astype(np.float32),
            "dones": np.zeros((T, B), bool),
            "staleness_gap": np.tile(np.array([0.0, 2.0], np.float32),
                                     (T, 1))}
    buf = registry.make("buffer", "uniform", capacity=32, batch_size=8,
                        n_step=3)
    jbuf = jax_registry.make("buffer", "uniform", capacity=32, batch_size=8,
                             n_step=3)
    state = algo.observe(buf, buf.init(ex), _torch(traj))
    jstate = jalgo.observe(jbuf, jbuf.init(jalgo.transition_example(jenv)),
                           jax.tree.map(jnp.asarray, traj))
    got = state.storage["staleness_w"][:state.size]
    want = np.asarray(jstate.storage["staleness_w"])[:int(jstate.size)]
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6)
    assert sorted(set(got.tolist())) == [0.25, 1.0]
    batch = algo.sample(buf, state, torch.Generator().manual_seed(0))
    assert "staleness_w" not in batch
    idx = batch["indices"].long()
    assert torch.equal(batch["weights"],
                       state.storage["staleness_w"][idx])
    # lock-step paths record no gap: unit weights
    plain = {k: v for k, v in traj.items() if k != "staleness_gap"}
    state = algo.observe(buf, buf.init(ex), _torch(plain))
    assert bool((state.storage["staleness_w"][:state.size] == 1.0).all())


def test_enable_staleness_rejects_unsupported_algo():
    for reg in (registry, jax_registry):
        algo = reg.make("algo", "trpo", hidden=16)
        with pytest.raises(ValueError, match="trpo"):
            algo.enable_staleness("decay")
        algo.enable_staleness("off")                 # off is always fine
    assert registry.make("algo", "sac").supports_staleness
    assert registry.make("algo", "ppo").supports_staleness


def test_spec_keeps_a_staleness_config_as_plain_data():
    """A ``StalenessConfig`` in a spec is kept as its dict, so the spec's
    JSON round-trips and loads in the JAX package alike."""
    from repro import experiment as jax_experiment
    from repro_torch.experiment import ExperimentSpec
    cfg = staleness.StalenessConfig(mode="vtrace", decay=0.8)
    spec = ExperimentSpec(runtime="async", backend="threaded",
                          staleness=cfg)
    assert spec.staleness == cfg.to_dict()
    d = json.loads(json.dumps(spec.to_dict()))
    assert ExperimentSpec.from_dict(d) == spec
    jspec = jax_experiment.ExperimentSpec(
        runtime="async", backend="threaded",
        staleness=jax_staleness.StalenessConfig(mode="vtrace", decay=0.8))
    assert jspec.to_dict() == d
