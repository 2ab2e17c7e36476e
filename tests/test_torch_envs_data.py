"""Auto-reset and trajectory validation of the port, mirroring
``tests/test_envs_data.py``'s auto-reset and layout tests on the port's
batched ``Env`` API, held against the JAX reference.

``auto_reset(env)`` steps a batch and restarts every instance whose
episode ended: the obs is the reset obs, every state leaf (the step counter
too) the reset state's, and the reward the terminal transition's. Its
reset candidates come from the step's generator, so a copy of the
generator's state predicts them; the terminal transition itself is the
JAX reference's single-instance step on the same state, so the reward is
held against the reference. Bounds: ``t``, ``done`` and selected leaves
exactly; float32 physics within 4 float32 steps at the leaf's magnitude
(XLA's and ATen's ``sin``/``cos`` differ by an ulp).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import envs as jax_envs
from repro.data import trajectory as jax_trajectory
from repro.envs.base import select_reset_batch as jax_select
from repro_torch import envs
from repro_torch.algos.api import PPOAlgorithm
from repro_torch.core import sampler
from repro_torch.data import trajectory
from repro_torch.envs import auto_reset, select_reset_batch


def f32_close(got, want):
    got, want = np.asarray(got), np.asarray(want)
    scale = np.spacing(np.float32(max(np.abs(want).max(initial=0), 1e-30)))
    np.testing.assert_array_less(np.abs(got - want), 4 * scale + 1e-45)


def predicted_reset(env, generator, batch):
    """The reset candidates ``auto_reset``'s next step draws: a copy of
    ``generator`` in its current state draws the same."""
    twin = torch.Generator().set_state(generator.get_state())
    return env.reset(twin, batch, "cpu")


def test_auto_reset_restarts_episode():
    env = envs.make("pendulum")            # 200-step episodes
    gen = torch.Generator().manual_seed(0)
    step = auto_reset(env)
    state, obs = env.reset(gen, 4, "cpu")
    saw_done = False
    for _ in range(205):
        state, obs, rew, done = step(state, torch.zeros(4, 1), gen)
        saw_done |= bool(done.any())
    assert saw_done
    # after the auto-reset the step counters went back below the limit
    assert int(state[2].max()) < 200


@pytest.mark.parametrize("name", ["pendulum", "cartpole", "cheetah"])
def test_auto_reset_terminal_step_semantics(name):
    """On ``done`` the reset obs replaces the terminal obs, the state swaps
    to the reset state leafwise, and the reward is still the terminal
    transition's: the JAX reference's single-instance step on the same
    state and action, vmapped."""
    B, horizon = 6, 3
    env = envs.make(name, max_episode_steps=horizon)
    jenv = jax_envs.make(name, max_episode_steps=horizon)
    gen = torch.Generator().manual_seed(42)
    step = auto_reset(env)
    state, obs = env.reset(gen, B, "cpu")
    action = torch.full((B, env.act_dim), 0.3)
    for i in range(horizon):
        reset_state, reset_obs = predicted_reset(env, gen, B)
        raw_state, raw_obs, raw_rew, raw_done = jax.vmap(
            lambda s, a: jenv.step(s, a, jax.random.PRNGKey(0)))(
            tuple(jnp.asarray(x.numpy()) for x in state),
            jnp.asarray(action.numpy()))
        state, obs, rew, done = step(state, action, gen)
        assert bool(done.all()) == (i == horizon - 1)
        np.testing.assert_array_equal(done.numpy(), np.asarray(raw_done))
        f32_close(rew.numpy(), raw_rew)
        if bool(done.all()):
            np.testing.assert_array_equal(obs.numpy(), reset_obs.numpy())
            assert np.abs(obs.numpy() - np.asarray(raw_obs)).max() > 0
            for got, want in zip(state, reset_state):
                assert torch.equal(got, want)
        else:
            f32_close(obs.numpy(), raw_obs)
            for got, want in zip(state, raw_state):
                if got.dtype == torch.int32:
                    np.testing.assert_array_equal(got.numpy(),
                                                  np.asarray(want))
                else:
                    f32_close(got.numpy(), want)


def test_auto_reset_step_counter_leaf_swaps():
    """The step counter (state[2] on pendulum) swaps with the state: it
    returns to the reset value 0 after a terminal step."""
    env = envs.make("pendulum", max_episode_steps=2)
    gen = torch.Generator().manual_seed(0)
    step = auto_reset(env)
    state, _ = env.reset(gen, 3, "cpu")
    counters = []
    for _ in range(5):
        state, _, _, _ = step(state, torch.zeros(3, 1), gen)
        counters.append(state[2].tolist())
    assert counters == [[1] * 3, [0] * 3, [1] * 3, [0] * 3, [1] * 3]


def test_select_reset_batch_matches_jax():
    """The select alone: ``done`` broadcast up each leaf's trailing dims,
    as the reference's."""
    rng = np.random.default_rng(0)
    done = rng.random(7) < 0.5
    leaves = [rng.standard_normal((7, 6)).astype(np.float32),
              rng.integers(0, 9, 7).astype(np.int32)]
    resets = [rng.standard_normal((7, 6)).astype(np.float32),
              np.zeros(7, np.int32)]
    obs, r_obs = (rng.standard_normal((7, 14)).astype(np.float32)
                  for _ in range(2))
    got = select_reset_batch(torch.from_numpy(done),
                             tuple(map(torch.from_numpy, resets)),
                             torch.from_numpy(r_obs),
                             tuple(map(torch.from_numpy, leaves)),
                             torch.from_numpy(obs))
    want = jax_select(jnp.asarray(done), tuple(map(jnp.asarray, resets)),
                      jnp.asarray(r_obs), tuple(map(jnp.asarray, leaves)),
                      jnp.asarray(obs))
    for g, w in zip((*got[0], got[1]), (*want[0], want[1])):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def _rollout_traj(horizon=16, batch=4):
    env = envs.make("pendulum")
    algo = PPOAlgorithm(hidden=16)
    params, _ = algo.init(torch.Generator().manual_seed(0), env, "cpu")
    rollout = algo.make_rollout(env, horizon)
    c1 = sampler.init_env_carry(env, 1, batch, "cpu")
    c2 = sampler.init_env_carry(env, 2, batch, "cpu")
    return env, rollout(params, c1)[1], rollout(params, c2)[1]


def test_rollout_traj_layout_and_merge():
    env, t1, t2 = _rollout_traj()
    trajectory.validate(t1)
    assert t1["obs"].shape == (16, 4, env.obs_dim)
    assert t1["actions"].shape == (16, 4, env.act_dim)
    assert t1["last_value"].shape == (4,)
    merged = trajectory.merge([t1, t2])
    trajectory.validate(merged)
    assert merged["obs"].shape == (16, 8, env.obs_dim)
    assert merged["last_value"].shape == (8,)
    assert trajectory.num_samples(merged) == 16 * 8


def test_validate_refuses_like_the_reference():
    """A missing key is a ``KeyError`` and a leaf whose leading dims are
    not the rewards' ``(T, B)`` a ``ValueError``, with the reference's
    messages; ``REQUIRED_KEYS`` is the reference's."""
    assert trajectory.REQUIRED_KEYS == jax_trajectory.REQUIRED_KEYS
    _, t1, _ = _rollout_traj(horizon=4, batch=2)
    bad = dict(t1)
    del bad["logp"]
    with pytest.raises(KeyError, match="trajectory missing key 'logp'"):
        trajectory.validate(bad)
    bad = dict(t1, values=t1["values"][:3])
    with pytest.raises(ValueError,
                       match=r"values has shape \(3, 2\), expected leading "
                             r"\(4,2\)"):
        trajectory.validate(bad)
    jbad = {k: jnp.asarray(v.numpy()) for k, v in bad.items()}
    with pytest.raises(ValueError, match="expected leading"):
        jax_trajectory.validate(jbad)
