"""SAC parity: the port's SAC against the JAX package's on identical
weights, optimizer state, batch and noise.

The JAX side draws its noise from keys (``sample_action``'s
``normal(key, mean.shape)``; ``sac_update`` splits its key into ``k_next``
and ``k_new``); the same normals are made with ``jax.random`` and injected
into the port (``noise``, ``batch["noise_next"]``, ``batch["noise_new"]``).

Bounds: ``sample_action`` within ``rtol=1e-5, atol=1e-6``. One
``sac_update`` (critic, actor and temperature Adam steps, polyak targets):
params, Adam moments, metrics and priorities within ``rtol=1e-5,
atol=2e-6``. Matmuls and means sum in other orders on the two sides, so
gradients differ in their last bits, and an Adam step moves a weight by
about lr = 3e-4 times a ratio of moments that those bits perturb.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.algos import sac as jax_sac
from repro.models.mlp_policy import gaussian_logp as jax_gaussian_logp
from repro.optim import adam as jax_adam
from repro_torch import convert
from repro_torch.algos import sac
from repro_torch.models.mlp_policy import gaussian_logp
from repro_torch.optim import adam

OBS, ACT, HIDDEN, B = 5, 3, 32, 64
TOL = dict(rtol=1e-5, atol=2e-6)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _t(x):
    return torch.from_numpy(np.array(x))


def test_sample_action_matches_jax():
    params = _np(jax_sac.init_sac(jax.random.PRNGKey(3), OBS, ACT, HIDDEN))
    obs = jax.random.normal(jax.random.PRNGKey(4), (B, OBS)) * 3.0
    key = jax.random.PRNGKey(5)
    want_a, want_logp = jax.jit(jax_sac.sample_action)(params["actor"], obs,
                                                       key)
    net = convert.sac_params_from_jax(params).actor
    got_a, got_logp = sac.sample_action(
        net, _t(obs), _t(jax.random.normal(key, (B, ACT))))
    np.testing.assert_allclose(got_a.detach().numpy(), want_a, rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(got_logp.detach().numpy(), want_logp,
                               rtol=1e-5, atol=1e-6)
    assert (got_a.abs() < 1.0).all()


def test_softplus_is_logaddexp_without_a_threshold():
    """``jax.nn.softplus`` has no linear branch above 20 as ``F.softplus``
    has. (XLA on the CPU flushes the subnormal softplus(-100) to zero,
    hence the absolute floor far below float32's smallest normal.)"""
    x = np.array([-100.0, -3.0, 0.0, 0.5, 19.0, 25.0, 100.0], np.float32)
    np.testing.assert_allclose(sac.softplus(_t(x)).numpy(),
                               np.asarray(jax.nn.softplus(jnp.asarray(x))),
                               rtol=1e-6, atol=1e-37)


def test_naive_logp_check_fails_only_where_the_action_saturates():
    """The record of ``tests/test_sac.py::test_sample_action_squashed_logp``
    on the port. That test holds the stable squash correction against the
    naive ``log(1 - a^2 + 1e-6)`` within 1e-3 and fails in JAX on 1 of its
    128 samples. The port, on the same weights, observations and noise,
    fails it on the same sample and on no other, and that sample's action
    is saturated (|a| > 0.9999), where the naive form's 1e-6 guard is no
    longer small against ``1 - a^2``. The stable form itself agrees with
    JAX's."""
    key = jax.random.PRNGKey(0)
    params = jax_sac.init_sac(key, obs_dim=3, act_dim=2, hidden=16)
    obs = jax.random.normal(key, (128, 3))

    @jax.jit
    def jax_check(actor, obs):
        """The JAX test's computation."""
        j_a, j_logp = jax_sac.sample_action(actor, obs, jax.random.PRNGKey(1))
        mean, std = jax_sac.actor_dist(actor, obs)
        u = jnp.arctanh(jnp.clip(j_a, -0.999999, 0.999999))
        return j_logp, jax_gaussian_logp(mean, std, u) - jnp.sum(
            jnp.log(1.0 - j_a ** 2 + 1e-6), axis=-1)

    j_logp, j_naive = jax_check(params["actor"], obs)
    j_off = ~np.isclose(j_logp, j_naive, rtol=1e-3, atol=1e-3)

    net = convert.sac_params_from_jax(_np(params)).actor
    with torch.no_grad():
        a, logp = sac.sample_action(net, _t(obs), _t(jax.random.normal(
            jax.random.PRNGKey(1), (128, 2))))
        m, s = sac.actor_dist(net, _t(obs))
        naive = gaussian_logp(m, s, torch.atanh(torch.clamp(
            a, -0.999999, 0.999999))) - torch.sum(
            torch.log(1.0 - a ** 2 + 1e-6), dim=-1)
    off = ~np.isclose(logp.numpy(), naive.numpy(), rtol=1e-3, atol=1e-3)
    np.testing.assert_allclose(logp.numpy(), j_logp, rtol=1e-5, atol=1e-5)
    saturated = a.abs().max(dim=-1).values.numpy() > 0.9999
    assert off.sum() == j_off.sum() == 1
    assert (off == j_off).all() and (off == saturated).all()


@pytest.fixture(scope="module")
def update_inputs():
    """Params and Adam states after one JAX update (so the moments are not
    zero), and the batch and key of the next update."""
    params = jax_sac.init_sac(jax.random.PRNGKey(0), OBS, ACT, HIDDEN)
    cfg = jax_sac.SACConfig()
    opts = (jax_adam(cfg.actor_lr), jax_adam(cfg.critic_lr),
            jax_adam(cfg.alpha_lr))
    states = (opts[0].init(params["actor"]), opts[1].init(params["critic"]),
              opts[2].init(params["log_alpha"]))
    rng = np.random.default_rng(0)

    def batch():
        return {
            "obs": rng.standard_normal((B, OBS)).astype(np.float32),
            "actions": rng.uniform(-0.99, 0.99, (B, ACT)).astype(np.float32),
            "rewards": rng.standard_normal(B).astype(np.float32),
            "next_obs": rng.standard_normal((B, OBS)).astype(np.float32),
            "discounts": np.where(rng.random(B) < 0.2, 0.0,
                                  0.99).astype(np.float32),
            "weights": rng.uniform(0.2, 1.0, B).astype(np.float32)}

    update = jax.jit(lambda p, s, b, k: jax_sac.sac_update(p, s, b, k, cfg,
                                                           *opts))
    params, states, _ = update(
        params, states, {k: jnp.asarray(v) for k, v in batch().items()},
        jax.random.PRNGKey(1))
    return _np(params), _np(states), batch(), jax.random.PRNGKey(2), update


def test_sac_update_matches_jax(update_inputs):
    params, states, batch, key, update = update_inputs
    p_j, s_j, m_j = update(params, states,
                           {k: jnp.asarray(v) for k, v in batch.items()}, key)
    k_next, k_new = jax.random.split(key)
    tb = {k: _t(v) for k, v in batch.items()}
    tb["noise_next"] = _t(jax.random.normal(k_next, (B, ACT)))
    tb["noise_new"] = _t(jax.random.normal(k_new, (B, ACT)))
    tcfg = sac.SACConfig()
    p_t, s_t, m_t = sac.sac_update(
        convert.sac_params_from_jax(params),
        convert.sac_adam_states_from_jax(states), tb, tcfg,
        adam(tcfg.actor_lr), adam(tcfg.critic_lr), adam(tcfg.alpha_lr))

    got, want = convert.sac_params_to_jax(p_t), _np(p_j)
    assert jax.tree.structure(got) == jax.tree.structure(want)
    moved = 0.0
    for g, w, p0 in zip(jax.tree.leaves(got), jax.tree.leaves(want),
                        jax.tree.leaves(params)):
        np.testing.assert_allclose(g, w, **TOL)
        moved = max(moved, float(np.abs(w - p0).max()))
    assert moved > 1e-4                 # the update did move the weights
    got_s = convert.sac_adam_states_to_jax(s_t)
    for g, w in zip(got_s, _np(s_j)):
        assert g[0] == int(w.step) == 2
        for a, b in zip(jax.tree.leaves((g[1], g[2])),
                        jax.tree.leaves((w.mu, w.nu))):
            np.testing.assert_allclose(a, b, **TOL)
    assert set(m_t) == set(m_j)
    for k in m_j:
        np.testing.assert_allclose(m_t[k].numpy(), np.asarray(m_j[k]), **TOL,
                                   err_msg=k)
    assert m_t["priorities"].shape == (B,)


def test_sac_algorithm_init_and_act():
    algo = sac.SACAlgorithm(hidden=16)
    env = type("E", (), {"obs_dim": OBS, "act_dim": ACT})
    params, (a_s, c_s, al_s) = algo.init(torch.Generator().manual_seed(0),
                                         env, "cpu")
    assert params.actor[-1].out_features == 2 * ACT
    assert len(c_s.mu) == 12 and len(a_s.mu) == 6 and al_s.mu[0].shape == ()
    for t, s in zip(params.target_critic.parameters(),
                    params.critic.parameters()):
        assert torch.equal(t, s) and not t.requires_grad
    action, extras = algo.act(params, torch.zeros(4, OBS),
                              torch.zeros(4, ACT))
    assert action.shape == (4, ACT) and extras == {}
    assert float(params.log_alpha.detach()) == pytest.approx(np.log(0.1))
