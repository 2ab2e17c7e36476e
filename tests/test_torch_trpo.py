"""TRPO parity: the port's natural-gradient update against the JAX
package's, on trajectories the JAX package collected, from the same
weights; plus the invariants of ``tests/test_trpo.py`` on the port.

Tolerances, each measured against JAX on the CPU with room to spare:

* the flat vector: exact (the same numbers in the same order);
* ``fisher_vp``: ``rtol=1e-4, atol=1e-6`` (matmuls and means sum in
  other orders, and the jvp of a grad compounds their last bits);
* the CG solution after ``cg_iters = 10``: ``rtol=1e-3`` of its largest
  element (ten Fisher products, each carrying the bound above; CG
  amplifies their differences along the Fisher's small eigenvalues);
* one whole update: ``step_coef`` exactly, on batches where JAX's choice
  has margin (each candidate up to the accepted one misses or meets both
  tests by more than 1e-3 of their scale, far beyond the port's
  difference from JAX); policy weights within 2e-4 absolute, value
  weights within 1e-5 (25 gradient steps), ``kl`` and
  ``surrogate_gain`` within ``rtol=1e-3``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import envs as jax_envs
from repro.algos import gae as jax_gae
from repro.algos import trpo as jax_trpo
from repro.core import sampler as jax_sampler
from repro.models import mlp_policy as jax_policy
from repro_torch import convert, registry
from repro_torch.algos import trpo
from repro_torch.algos.api import TRPOAlgorithm

HIDDEN, HORIZON, BATCH = 16, 64, 8


def _t(tree):
    """A numpy/JAX tree -> the same tree of torch tensors."""
    return jax.tree.map(lambda x: torch.from_numpy(np.array(x)), tree)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _collect(name):
    env = jax_envs.make(name)
    params = jax_policy.init_policy(jax.random.PRNGKey(0), env.obs_dim,
                                    env.act_dim, HIDDEN)
    rollout = jax.jit(jax_sampler.make_env_rollout(env, HORIZON))
    _, traj = rollout(params, jax_sampler.init_env_carry(
        env, jax.random.PRNGKey(1), BATCH))
    return _np(params), _np(traj)


@pytest.fixture(scope="module", params=["pendulum", "cartpole"])
def collected(request):
    """(params, traj, pi, obs, old_mean, old_std) on the JAX side."""
    params, traj = _collect(request.param)
    pi = {"pi": params["pi"], "log_std": params["log_std"]}
    obs = traj["obs"].reshape(-1, traj["obs"].shape[-1])
    old_mean, old_std = jax_trpo._dist(pi, obs)
    return params, traj, pi, obs, np.asarray(old_mean), np.asarray(old_std)


def test_flatten_order_and_round_trip_match_jax(collected):
    params, _, pi, _, _, _ = collected
    want, _ = jax_trpo._flatten(pi)
    tree = trpo.policy_tree(convert.params_from_jax(params))
    got, meta = trpo._flatten({"pi": tree["pi"], "log_std": tree["log_std"]})
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    back = trpo._unflatten(got, meta)
    assert jax.tree.structure(back) == jax.tree.structure(pi)
    for g, w in zip(jax.tree.leaves(back), jax.tree.leaves(pi)):
        np.testing.assert_array_equal(g.numpy(), w)


def test_cg_solves_spd_system_like_jax():
    rng = np.random.default_rng(0)
    a = rng.standard_normal((12, 12)).astype(np.float32)
    spd = a @ a.T + 0.5 * np.eye(12, dtype=np.float32)
    b = rng.standard_normal(12).astype(np.float32)
    want = jax_trpo.conjugate_gradient(lambda v: jnp.asarray(spd) @ v,
                                       jnp.asarray(b), iters=24)
    t_spd = torch.from_numpy(spd)
    x = trpo.conjugate_gradient(lambda v: t_spd @ v, torch.from_numpy(b),
                                iters=24)
    np.testing.assert_allclose((t_spd @ x).numpy(), b, atol=1e-3)
    np.testing.assert_allclose(x.numpy(), np.asarray(want), rtol=1e-3,
                               atol=1e-3)


def _fvp_pair(collected, damping):
    _, _, pi, obs, old_mean, old_std = collected
    flat, meta = jax_trpo._flatten(pi)
    jax_fvp = jax.jit(lambda v: jax_trpo.fisher_vp(
        pi, obs, old_mean, old_std, v, meta, damping))
    t_pi = _t(pi)
    _, t_meta = trpo._flatten(t_pi)
    t_obs, t_mean, t_std = _t((obs, old_mean, old_std))

    def port_fvp(v):
        return trpo.fisher_vp(t_pi, t_obs, t_mean, t_std, v, t_meta,
                              damping)

    return flat.shape[0], jax_fvp, port_fvp


def test_fisher_vp_matches_jax(collected):
    n, jax_fvp, port_fvp = _fvp_pair(collected, damping=0.1)
    v = np.random.default_rng(1).standard_normal(n).astype(np.float32)
    want = np.asarray(jax_fvp(jnp.asarray(v)))
    got = port_fvp(torch.from_numpy(v)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-6)


def test_fisher_vp_psd_and_symmetric(collected):
    n, _, port_fvp = _fvp_pair(collected, damping=0.0)
    rng = np.random.default_rng(2)
    v, w = (torch.from_numpy(rng.standard_normal(n).astype(np.float32))
            for _ in range(2))
    assert float(torch.dot(v, port_fvp(v))) >= -1e-5
    np.testing.assert_allclose(float(torch.dot(w, port_fvp(v))),
                               float(torch.dot(v, port_fvp(w))), rtol=1e-3,
                               atol=1e-5)


def test_cg_on_fisher_matches_jax(collected):
    n, jax_fvp, port_fvp = _fvp_pair(collected, damping=0.1)
    b = np.random.default_rng(3).standard_normal(n).astype(np.float32)
    want = np.asarray(jax_trpo.conjugate_gradient(jax_fvp, jnp.asarray(b),
                                                  10))
    got = trpo.conjugate_gradient(port_fvp, torch.from_numpy(b), 10).numpy()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-3 * float(np.abs(want).max()))


def test_kl_zero_at_same_params(collected):
    _, _, pi, obs, old_mean, old_std = collected
    t_obs, t_mean, t_std = _t((obs, old_mean, old_std))
    kl = trpo.mean_kl(_t(pi), t_mean, t_std, t_obs)
    assert float(kl) == pytest.approx(0.0, abs=1e-6)


def _jax_candidates(params, traj, cfg):
    """The JAX update's line-search candidates, as ``trpo_update`` makes
    them: ``(coef, surrogate gain, kl)`` per candidate."""
    adv, _ = jax_gae.gae(traj["rewards"], traj["values"], traj["dones"],
                         traj["last_value"], cfg.gamma, cfg.lam)
    batch = {"obs": traj["obs"].reshape(-1, traj["obs"].shape[-1]),
             "actions": traj["actions"].reshape(
                 -1, traj["actions"].shape[-1]),
             "behavior_logp": traj["logp"].reshape(-1),
             "advantages": jax_gae.normalize(adv).reshape(-1)}
    pi = {"pi": params["pi"], "log_std": params["log_std"]}
    old_mean, old_std = jax_trpo._dist(pi, batch["obs"])
    flat0, meta = jax_trpo._flatten(pi)
    g, _ = jax_trpo._flatten(jax.grad(jax_trpo.surrogate)(pi, batch))
    avp = lambda v: jax_trpo.fisher_vp(pi, batch["obs"], old_mean, old_std,
                                       v, meta, cfg.cg_damping)
    step = jax_trpo.conjugate_gradient(avp, g, cfg.cg_iters)
    full = jnp.sqrt(2 * cfg.max_kl / jnp.maximum(
        jnp.dot(step, avp(step)), 1e-10)) * step
    base = jax_trpo.surrogate(pi, batch)
    coef, out = jnp.ones(()), []
    for _ in range(cfg.backtrack_iters):
        cand = jax_trpo._unflatten(flat0 + coef * full, meta)
        out.append((float(coef),
                    float(jax_trpo.surrogate(cand, batch) - base),
                    float(jax_trpo.mean_kl(cand, old_mean, old_std,
                                           batch["obs"]))))
        coef = coef * cfg.backtrack_coef
    return out


@pytest.mark.parametrize("name,max_kl,want_coef", [
    ("pendulum", 0.01, 1.0), ("cartpole", 0.01, 1.0),
    ("cartpole", 3.0, 0.8), ("cartpole", 10.0, 0.512)])
def test_trpo_update_matches_jax(name, max_kl, want_coef):
    params, traj = _collect(name)
    jcfg = jax_trpo.TRPOConfig(max_kl=max_kl)
    # JAX's choice has margin: every candidate up to the accepted one
    # passes or fails both tests by more than 1e-3 of their scale
    for coef, gain, kl in _jax_candidates(params, traj, jcfg):
        assert abs(gain) > 1e-3 * 0.01 and abs(kl - 1.5 * max_kl) > (
            1e-3 * max_kl), (coef, gain, kl)
        if gain > 0 and kl <= 1.5 * max_kl:
            break
    p_j, _, m_j = jax.jit(jax_trpo.make_trpo_learner(jcfg))(params, None,
                                                            traj)
    learn = trpo.make_trpo_learner(trpo.TRPOConfig(max_kl=max_kl))
    policy, opt_state, m_t = learn(convert.params_from_jax(params), None,
                                   _t(traj))
    assert opt_state is None
    assert float(m_t["step_coef"]) == float(m_j["step_coef"])
    assert float(m_j["step_coef"]) == pytest.approx(want_coef)
    got, want = convert.params_to_jax(policy), _np(p_j)
    for key, atol in (("pi", 2e-4), ("log_std", 2e-4), ("vf", 1e-5)):
        for g, w in zip(jax.tree.leaves(got[key]),
                        jax.tree.leaves(want[key])):
            np.testing.assert_allclose(g, w, rtol=0, atol=atol, err_msg=key)
    for k in ("kl", "surrogate_gain"):
        np.testing.assert_allclose(float(m_t[k]), float(m_j[k]), rtol=1e-3,
                                   err_msg=k)


def test_trpo_update_respects_trust_region_and_improves():
    params, traj = _collect("pendulum")
    cfg = trpo.TRPOConfig(max_kl=0.01)
    before = convert.params_from_jax(params)
    policy, _, metrics = trpo.make_trpo_learner(cfg)(
        convert.params_from_jax(params), None, _t(traj))
    assert float(metrics["kl"]) <= 1.5 * cfg.max_kl + 1e-6
    assert float(metrics["surrogate_gain"]) >= 0.0
    moved = any(float((a - b).detach().abs().max()) > 0 for a, b in zip(
        before.pi.parameters(), policy.pi.parameters()))
    assert moved or float(metrics["step_coef"]) == 0.0


def test_trpo_algorithm_init_and_registry():
    algo = registry.make("algo", "trpo", hidden=8, lr=0.01)
    assert isinstance(algo, TRPOAlgorithm) and algo.cfg.vf_lr == 0.01
    env = type("E", (), {"obs_dim": 4, "act_dim": 1})
    params, opt_state = algo.init(torch.Generator().manual_seed(0), env,
                                  "cpu")
    assert opt_state is None and params.pi[0].out_features == 8
    action, extras = algo.act(params, torch.zeros(3, 4), torch.zeros(3, 1))
    assert action.shape == (3, 1) and set(extras) == {"logp", "values"}
