"""PPO parity: the port's learner against the JAX learner on one trajectory
that the JAX package collected, from the same weights.

One ``learn`` is GAE, normalisation and 4 epochs × 4 minibatches = 16
Adam steps over contiguous slices, deterministic on both sides. The
weights after it agree within 2e-5 absolute: each Adam step moves a weight
by about lr = 3e-4 whatever the gradient's size, the gradients differ in
their last bits (other summation orders in matmuls and means), and over 16
steps a weight whose gradient is near zero can take a few steps of
opposite sign.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import envs as jax_envs
from repro.algos import ppo as jax_ppo
from repro.core import sampler as jax_sampler
from repro.models import mlp_policy as jax_policy
from repro.optim import adam as jax_adam
from repro_torch import convert
from repro_torch.algos import ppo
from repro_torch.optim import adam

HORIZON, BATCH = 32, 8


@pytest.fixture(scope="module")
def collected():
    """(params, traj) from the JAX package: cheetah with 20-step episodes,
    so the trajectory holds terminals."""
    env = jax_envs.make("cheetah", max_episode_steps=20)
    params = jax_policy.init_policy(jax.random.PRNGKey(1), env.obs_dim,
                                    env.act_dim, hidden=64)
    carry = jax_sampler.init_env_carry(env, jax.random.PRNGKey(2), BATCH)
    rollout = jax.jit(jax_sampler.make_env_rollout(env, HORIZON))
    _, traj = rollout(params, carry)
    traj = {k: np.asarray(v) for k, v in traj.items()}
    assert traj["dones"].any()
    return jax.tree.map(np.asarray, params), traj


def torch_traj(traj):
    return {k: torch.from_numpy(v.copy()) for k, v in traj.items()}


def test_clipped_surrogate_matches_jax():
    rng = np.random.default_rng(0)
    logp, blogp, adv = (rng.standard_normal(256).astype(np.float32)
                        for _ in range(3))
    want = jax_ppo.clipped_surrogate(jnp.asarray(logp), jnp.asarray(blogp),
                                     jnp.asarray(adv), 0.2)
    got = ppo.clipped_surrogate(torch.from_numpy(logp),
                                torch.from_numpy(blogp),
                                torch.from_numpy(adv), 0.2)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-7)


def test_loss_and_grads_match_jax(collected):
    params, traj = collected
    cfg = jax_ppo.PPOConfig()
    rng = np.random.default_rng(1)
    n = HORIZON * BATCH
    batch = {
        "obs": traj["obs"].reshape(n, -1),
        "actions": traj["actions"].reshape(n, -1),
        "behavior_logp": traj["logp"].reshape(n),
        "advantages": rng.standard_normal(n).astype(np.float32),
        "returns": rng.standard_normal(n).astype(np.float32),
    }
    (loss_j, m_j), g_j = jax.value_and_grad(
        lambda p: jax_ppo.mlp_ppo_loss(p, jax.tree.map(jnp.asarray, batch),
                                       cfg), has_aux=True)(
        jax.tree.map(jnp.asarray, params))
    policy = convert.params_from_jax(params)
    loss_t, m_t = ppo.mlp_ppo_loss(
        policy, {k: torch.from_numpy(v.copy()) for k, v in batch.items()},
        ppo.PPOConfig())
    grads = torch.autograd.grad(loss_t, list(policy.parameters()))
    np.testing.assert_allclose(float(loss_t.detach()), float(loss_j),
                               rtol=1e-5)
    for k in m_j:
        np.testing.assert_allclose(float(m_t[k]), float(m_j[k]), rtol=1e-4,
                                   atol=1e-6)
    for a, b in zip(grads, convert._flat(jax.tree.map(np.asarray, g_j))):
        np.testing.assert_allclose(a.numpy(), b, rtol=1e-4, atol=1e-6)


def test_learn_matches_jax(collected):
    params, traj = collected
    opt_j = jax_adam(3e-4)
    learn_j = jax.jit(jax_ppo.make_mlp_learner(opt_j, jax_ppo.PPOConfig()))
    jp = jax.tree.map(jnp.asarray, params)
    p_j, s_j, m_j = learn_j(jp, opt_j.init(jp),
                            {k: jnp.asarray(v) for k, v in traj.items()})

    policy = convert.params_from_jax(params)
    opt_t = adam(3e-4)
    learn_t = ppo.make_mlp_learner(opt_t, ppo.PPOConfig())
    policy, s_t, m_t = learn_t(policy, opt_t.init(list(policy.parameters())),
                               torch_traj(traj))
    assert s_t.step == int(s_j.step) == 16
    got = convert.params_to_jax(policy)
    moved = 0.0
    for a, b, p0 in zip(jax.tree.leaves(got),
                        jax.tree.leaves(jax.tree.map(np.asarray, p_j)),
                        jax.tree.leaves(params)):
        np.testing.assert_allclose(a, b, rtol=0, atol=2e-5)
        moved = max(moved, float(np.abs(b - p0).max()))
    assert moved > 1e-3          # the learner did move the weights
    for k in ("loss", "pg_loss", "v_loss", "entropy"):
        np.testing.assert_allclose(float(m_t[k]), float(m_j[k]), rtol=1e-3,
                                   atol=1e-5)
