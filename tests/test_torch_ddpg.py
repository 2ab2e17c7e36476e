"""DDPG parity: the port's DDPG against the JAX package's on identical
weights, optimizer state, batch and exploration noise.

The JAX side draws its exploration noise from a key (``explore_action``'s
``normal(key, a.shape)``); the same normals are made with ``jax.random``
and injected into the port. The update itself draws nothing.

Bounds: ``explore_action`` within ``rtol=1e-6, atol=1e-6``. One
``ddpg_update`` (critic, then actor Adam steps, then Polyak targets):
params, Adam moments, metrics and priorities within ``rtol=1e-5,
atol=5e-6``. Matmuls and means sum in other orders on the two sides, so
gradients differ in their last bits, and an Adam step moves a weight by
about lr = 1e-3 times a ratio of moments that those bits perturb. The
Polyak average on the port is checked exactly against its own formula.
"""
import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.algos import ddpg as jax_ddpg
from repro.optim import adam as jax_adam
from repro_torch import convert, registry
from repro_torch.algos import ddpg
from repro_torch.algos.api import DDPGAlgorithm
from repro_torch.data import buffers
from repro_torch.optim import adam

OBS, ACT, HIDDEN, B = 5, 3, 32, 64
TOL = dict(rtol=1e-5, atol=5e-6)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _t(x):
    return torch.from_numpy(np.array(x))


def _batch(rng, legacy):
    """A replay minibatch: the experience plane's form (``discounts`` and
    importance ``weights``) or the legacy 1-step form (``dones``)."""
    out = {"obs": rng.standard_normal((B, OBS)).astype(np.float32),
           "actions": rng.uniform(-1, 1, (B, ACT)).astype(np.float32),
           "rewards": rng.standard_normal(B).astype(np.float32),
           "next_obs": rng.standard_normal((B, OBS)).astype(np.float32)}
    if legacy:
        out["dones"] = rng.random(B) < 0.2
    else:
        out["discounts"] = np.where(rng.random(B) < 0.2, 0.0,
                                    0.99 ** 3).astype(np.float32)
        out["weights"] = rng.uniform(0.2, 1.0, B).astype(np.float32)
    return out


def test_explore_action_matches_jax():
    params = _np(jax_ddpg.init_ddpg(jax.random.PRNGKey(3), OBS, ACT, HIDDEN))
    obs = jax.random.normal(jax.random.PRNGKey(4), (B, OBS)) * 3.0
    key, cfg = jax.random.PRNGKey(5), jax_ddpg.DDPGConfig(noise_std=0.5)
    want = jax.jit(lambda p, o: jax_ddpg.explore_action(p, o, key, cfg))(
        params, obs)
    got = ddpg.explore_action(
        convert.ddpg_params_from_jax(params), _t(obs),
        _t(jax.random.normal(key, (B, ACT))),
        ddpg.DDPGConfig(noise_std=0.5)).detach()
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
    assert float(got.abs().max()) <= 1.0 and (got.abs() == 1.0).any()


@pytest.fixture(scope="module", params=[False, True], ids=["plane", "legacy"])
def update_inputs(request):
    """Params and Adam states after one JAX update (so the moments are not
    zero), and the batch of the next update."""
    legacy = request.param
    params = jax_ddpg.init_ddpg(jax.random.PRNGKey(0), OBS, ACT, HIDDEN)
    cfg = jax_ddpg.DDPGConfig()
    opts = (jax_adam(cfg.actor_lr), jax_adam(cfg.critic_lr))
    states = (opts[0].init(params["actor"]), opts[1].init(params["critic"]))
    rng = np.random.default_rng(0)
    update = jax.jit(lambda p, s, b: jax_ddpg.ddpg_update(p, s, b, cfg,
                                                          *opts))
    params, states, _ = update(
        params, states,
        {k: jnp.asarray(v) for k, v in _batch(rng, legacy).items()})
    return _np(params), _np(states), _batch(rng, legacy), update


def test_ddpg_update_matches_jax(update_inputs):
    params, states, batch, update = update_inputs
    p_j, s_j, m_j = update(params, states,
                           {k: jnp.asarray(v) for k, v in batch.items()})
    tcfg = ddpg.DDPGConfig()
    p_t, s_t, m_t = ddpg.ddpg_update(
        convert.ddpg_params_from_jax(params),
        convert.ddpg_adam_states_from_jax(states),
        {k: _t(v) for k, v in batch.items()}, tcfg, adam(tcfg.actor_lr),
        adam(tcfg.critic_lr))

    got, want = convert.ddpg_params_to_jax(p_t), _np(p_j)
    assert jax.tree.structure(got) == jax.tree.structure(want)
    for name in want:
        moved = 0.0
        for g, w, p0 in zip(jax.tree.leaves(got[name]),
                            jax.tree.leaves(want[name]),
                            jax.tree.leaves(params[name])):
            np.testing.assert_allclose(g, w, **TOL, err_msg=name)
            moved = max(moved, float(np.abs(w - p0).max()))
        assert moved > 1e-6, name       # every net moved, targets too
    for g, w in zip(convert.ddpg_adam_states_to_jax(s_t), _np(s_j)):
        assert g[0] == int(w.step) == 2
        for a, b in zip(jax.tree.leaves((g[1], g[2])),
                        jax.tree.leaves((w.mu, w.nu))):
            np.testing.assert_allclose(a, b, **TOL)
    assert set(m_t) == set(m_j)
    for k in m_j:
        np.testing.assert_allclose(m_t[k].numpy(), np.asarray(m_j[k]), **TOL,
                                   err_msg=k)
    assert m_t["priorities"].shape == (B,)


def test_priorities_are_td_errors_before_the_critic_step():
    """``|q - target|`` with q from the critic as it was before the
    update and the target from the old target nets."""
    params = ddpg.init_ddpg(torch.Generator().manual_seed(1), OBS, ACT, 16)
    batch = {k: _t(v) for k, v in
             _batch(np.random.default_rng(2), legacy=False).items()}
    with torch.no_grad():
        a_next = ddpg.actor_apply(params.target_actor, batch["next_obs"])
        target = batch["rewards"] + batch["discounts"] * ddpg.critic_apply(
            params.target_critic, batch["next_obs"], a_next)
        want = torch.abs(ddpg.critic_apply(params.critic, batch["obs"],
                                           batch["actions"]) - target)
    cfg = ddpg.DDPGConfig()
    opts = (adam(cfg.actor_lr), adam(cfg.critic_lr))
    _, _, metrics = ddpg.ddpg_update(
        params, (opts[0].init(list(params.actor.parameters())),
                 opts[1].init(list(params.critic.parameters()))),
        batch, cfg, *opts)
    assert torch.equal(metrics["priorities"], want)
    assert torch.equal(metrics["q_mean"], torch.mean(target))


def test_polyak_targets_follow_the_updated_nets():
    params = ddpg.init_ddpg(torch.Generator().manual_seed(3), OBS, ACT, 16)
    cfg = ddpg.DDPGConfig(tau=0.1)
    with torch.no_grad():           # targets apart from the online nets
        for p in params.target_actor.parameters():
            p.add_(0.5)
    before = copy.deepcopy(params)
    opts = (adam(cfg.actor_lr), adam(cfg.critic_lr))
    batch = {k: _t(v) for k, v in
             _batch(np.random.default_rng(4), legacy=True).items()}
    ddpg.ddpg_update(params, (opts[0].init(list(params.actor.parameters())),
                              opts[1].init(list(params.critic.parameters()))),
                     batch, cfg, *opts)
    for tname, name in (("target_actor", "actor"),
                        ("target_critic", "critic")):
        for t, t0, s, s0 in zip(getattr(params, tname).parameters(),
                                getattr(before, tname).parameters(),
                                getattr(params, name).parameters(),
                                getattr(before, name).parameters()):
            assert not torch.equal(s, s0)           # the online net moved
            assert torch.equal(t, (1 - cfg.tau) * t0 + cfg.tau * s)
            assert not t.requires_grad


def test_ddpg_update_improves_critic():
    """As ``tests/test_algos.py::test_ddpg_update_improves_critic``."""
    params = ddpg.init_ddpg(torch.Generator().manual_seed(0), 3, 2, 16)
    cfg = ddpg.DDPGConfig()
    opts = (adam(1e-3), adam(1e-3))
    states = (opts[0].init(list(params.actor.parameters())),
              opts[1].init(list(params.critic.parameters())))
    g = torch.Generator().manual_seed(0)
    batch = {"obs": torch.randn(32, 3, generator=g),
             "actions": torch.rand(32, 2, generator=g) * 2 - 1,
             "rewards": torch.randn(32, generator=g),
             "next_obs": torch.randn(32, 3, generator=g),
             "dones": torch.zeros(32)}
    losses = []
    for _ in range(20):
        params, states, metrics = ddpg.ddpg_update(params, states, batch,
                                                   cfg, *opts)
        losses.append(float(metrics["critic_loss"]))
    assert losses[-1] < losses[0]
    d = max(float((a - b).detach().abs().max()) for a, b in zip(
        params.target_critic.parameters(), params.critic.parameters()))
    assert d > 0.0


def test_ddpg_algorithm_init_act_and_sample():
    algo = registry.make("algo", "ddpg", hidden=8, lr=0.01)
    assert isinstance(algo, DDPGAlgorithm)
    assert algo.cfg.actor_lr == algo.cfg.critic_lr == 0.01
    assert algo.updates_per_collect == 4 and algo.learner_noise == ()
    env = type("E", (), {"obs_dim": OBS, "act_dim": ACT})
    params, (a_s, c_s) = algo.init(torch.Generator().manual_seed(0), env,
                                   "cpu")
    assert len(a_s.mu) == len(c_s.mu) == 6
    assert params.critic[0].in_features == OBS + ACT
    for t, s in zip(params.target_actor.parameters(),
                    params.actor.parameters()):
        assert torch.equal(t, s) and not t.requires_grad
    action, extras = algo.act(params, torch.zeros(4, OBS),
                              torch.full((4, ACT), 100.0))
    assert extras == {} and torch.equal(action, torch.ones(4, ACT))
    # DDPG's learner draws nothing: a sampled batch is the buffer's alone
    buf = buffers.UniformBuffer(capacity=16, batch_size=4)
    state = buf.add(buf.init(algo.transition_example(env, "cpu")), {
        "obs": torch.zeros(3, 2, OBS), "actions": torch.zeros(3, 2, ACT),
        "rewards": torch.zeros(3, 2), "dones": torch.zeros(3, 2, dtype=bool),
        "next_obs": torch.zeros(3, 2, OBS)})
    batch = algo.sample(buf, state, torch.Generator().manual_seed(0))
    assert not any(k.startswith("noise") for k in batch)
