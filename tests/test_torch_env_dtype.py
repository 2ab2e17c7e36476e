"""Envs with float16 and bfloat16 observations and rewards: the port against
the JAX package on the CPU.

The reference's envs take ``dtype`` and keep their physics and state in
float32; only the obs and the reward are cast at the end (``.astype``), and
the reset candidates' obs arrive in ``dtype``. The port's plain version
casts the same way (the CUDA kernels store each of those types themselves;
``test_torch_kernels_gpu.py`` holds them against it on the card).

Bounds: the obs and rewards of a step, and the obs of a reset, bit for bit
against the JAX *ref* (``impl="ref"``, never the Pallas interpret output,
which drifts on this JAX: ROADMAP.md); ``t`` and ``done`` exactly; the
float32 state within ``test_torch_env_step.py``'s 4 float32 steps at the
leaf's magnitude (XLA's and ATen's ``sin``/``cos`` differ by an ulp). A PPO
learn on a bfloat16 and a float16 trajectory the JAX package collected, and
a SAC update on a half-precision replay batch, within 1e-5 of JAX from the
same weights. ``episode_returns`` on half-precision rewards equals JAX's
value in JAX's dtype.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import envs as jax_envs
from repro.algos import ppo as jax_ppo
from repro.algos import sac as jax_sac
from repro.algos.gae import gae as jax_gae
from repro.core import sampler as jax_sampler
from repro.data import buffers as jax_buffers
from repro.data import trajectory as jax_trajectory
from repro.kernels.env_step import ref as jax_env_ref
from repro.models import mlp_policy as jax_policy
from repro.optim import adam as jax_adam
from repro_torch import convert, envs
from repro_torch.algos import gae as gae_mod
from repro_torch.algos import ppo, sac
from repro_torch.data import buffers, trajectory
from repro_torch.experiment import ExperimentSpec, Schedule, build
from repro_torch.kernels.env_step import ops as env_ops
from repro_torch.optim import adam

HORIZON = 5
PARAMS = {"pendulum": dict(max_torque=2.0), "cartpole": dict(force_max=10.0),
          "cheetah": dict(ctrl_cost=0.1)}
DTYPES = {"float16": (torch.float16, jnp.float16),
          "bfloat16": (torch.bfloat16, jnp.bfloat16)}
NAMES = ["pendulum", "cartpole", "cheetah"]
TOL = dict(rtol=1e-5, atol=1e-5)


def to_torch(x):
    """A numpy array (ml_dtypes' bfloat16 too) as a torch tensor."""
    x = np.asarray(x)
    if x.dtype.name == "bfloat16":
        return torch.from_numpy(x.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(x.copy())


def half_bits(x):
    """The bits of a 2-byte float array or tensor, as uint16."""
    if isinstance(x, torch.Tensor):
        return x.view(torch.int16).numpy().view(np.uint16)
    return np.asarray(x).view(np.uint16)


def f32_close(got, want):
    """Within 4 float32 steps at the leaf's magnitude."""
    got, want = np.asarray(got), np.asarray(want)
    scale = np.spacing(np.float32(max(np.abs(want).max(initial=0), 1e-30)))
    np.testing.assert_array_less(np.abs(got - want), 4 * scale + 1e-45)


def make_inputs(name, B, seed, dtype):
    """numpy (state, actions, reset_state, reset_obs) with a third of the
    rows at their last step; the reset obs in ``dtype`` (a jnp dtype)."""
    rng = np.random.default_rng(seed)

    def f(*shape, lo=-1.0, hi=1.0):
        return rng.uniform(lo, hi, shape).astype(np.float32)

    t = rng.integers(0, HORIZON - 1, B).astype(np.int32)
    t[rng.permutation(B)[: max(1, B // 3)]] = HORIZON - 1
    rt = np.zeros(B, np.int32)
    if name == "pendulum":
        state = (f(B, lo=-3 * np.pi, hi=3 * np.pi), f(B, lo=-8, hi=8), t)
        reset, actions, obs_dim = (f(B, lo=-np.pi, hi=np.pi), f(B), rt), \
            f(B, 1, lo=-3, hi=3), 3
    elif name == "cartpole":
        state = (f(B, lo=-2.5, hi=2.5), f(B, lo=-2, hi=2),
                 f(B, lo=-0.25, hi=0.25), f(B, lo=-2, hi=2), t)
        reset = tuple(f(B, lo=-0.05, hi=0.05) for _ in range(4)) + (rt,)
        actions, obs_dim = f(B, 1, lo=-2, hi=2), 4
    else:
        state = (f(B, 6), f(B, 6), f(B, lo=-2, hi=2), f(B), t)
        reset = (f(B, 6, lo=-0.1, hi=0.1), f(B, 6, lo=-0.1, hi=0.1),
                 np.zeros(B, np.float32), np.zeros(B, np.float32), rt)
        actions, obs_dim = f(B, 6, lo=-2, hi=2), 14
    reset_obs = np.asarray(jnp.asarray(f(B, obs_dim)).astype(dtype))
    return state, actions, reset, reset_obs


@pytest.mark.parametrize("B", [1, 257])
@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_env_step_in_half_precision_matches_jax_ref(dtype, name, B):
    """The port's env (its ``make`` with ``dtype``) against the JAX ref at
    the same dtype: obs and rewards bit for bit, the reset select firing."""
    tdt, jdt = DTYPES[dtype]
    state, a, rs, ro = make_inputs(name, B, seed=B, dtype=jdt)
    params = dict(max_episode_steps=HORIZON, reward_scale=0.5,
                  **PARAMS[name])
    want = jax_env_ref.STEP_BATCH_REF[name](
        tuple(map(jnp.asarray, state)), jnp.asarray(a),
        tuple(map(jnp.asarray, rs)), jnp.asarray(ro), dtype=jdt, **params)
    env = envs.make(name, dtype=dtype, **{k: v for k, v in params.items()})
    got = env.batch_step(tuple(map(to_torch, state)), to_torch(a),
                         tuple(map(to_torch, rs)), to_torch(ro))
    (g_state, g_obs, g_rew, g_done), (w_state, w_obs, w_rew, w_done) = \
        got, want
    assert g_obs.dtype == g_rew.dtype == tdt
    np.testing.assert_array_equal(half_bits(g_obs), half_bits(w_obs))
    np.testing.assert_array_equal(half_bits(g_rew), half_bits(w_rew))
    np.testing.assert_array_equal(g_done.numpy(), np.asarray(w_done))
    assert g_done.any()
    for g, w in zip(g_state, w_state):
        if g.dtype == torch.int32:
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        else:
            f32_close(g.numpy(), w)


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_env_reset_in_half_precision_matches_jax(dtype, name):
    """A reset's obs are the reference's obs of the drawn state, cast once:
    bit for bit; the state stays float32 (int32 ``t``)."""
    tdt, jdt = DTYPES[dtype]
    env = envs.make(name, dtype=tdt)
    state, obs = env.reset(torch.Generator().manual_seed(5), 64, "cpu")
    obs_fn = {"pendulum": jax_env_ref.pendulum_obs,
              "cartpole": jax_env_ref.cartpole_obs,
              "cheetah": jax_env_ref.cheetah_obs}[name]
    want = jax.vmap(lambda s: obs_fn(s, jdt))(
        tuple(jnp.asarray(x.numpy()) for x in state))
    assert obs.dtype == tdt and obs.shape == want.shape
    np.testing.assert_array_equal(half_bits(obs), half_bits(want))
    assert {x.dtype for x in state} == {torch.float32, torch.int32}


@pytest.mark.parametrize("dtype", ["float64", "int32", torch.float64,
                                   "float8", None])
@pytest.mark.parametrize("name", NAMES)
def test_another_dtype_is_refused_by_name(name, dtype):
    """Only float32, float16 and bfloat16: any other dtype is a
    ``ValueError`` that names the env's file, from ``make`` and from a
    spec; the op refuses it too, on the CPU as on the card."""
    with pytest.raises(ValueError, match=f"repro_torch/envs/{name}.py"):
        envs.make(name, dtype=dtype)
    with pytest.raises(ValueError, match=f"repro_torch/envs/{name}.py"):
        build(ExperimentSpec(env=name, env_kwargs={"dtype": dtype},
                             schedule=Schedule(num_samplers=1,
                                               global_batch=2, horizon=2)),
              device="cpu")
    state, a, rs, ro = make_inputs(name, 4, seed=0, dtype=jnp.float32)
    with pytest.raises(ValueError, match="env_step/ops.py"):
        env_ops.env_step(name, tuple(map(to_torch, state)), to_torch(a),
                         tuple(map(to_torch, rs)), to_torch(ro),
                         dtype=dtype, max_episode_steps=HORIZON,
                         reward_scale=1.0, **PARAMS[name])


@pytest.mark.parametrize("alias", ["float16", "half", "f2", np.float16,
                                   torch.float16, "float32", "single",
                                   "f4", np.float32, torch.float32,
                                   "bfloat16", jnp.bfloat16, torch.bfloat16])
def test_dtype_names_resolve_as_jnp_dtype_reads_them(alias):
    """A name, alias or numpy type of float16, float32 or bfloat16 gives
    the obs dtype the reference's ``jnp.dtype`` gives."""
    _, obs = envs.make("pendulum", dtype=alias).reset(
        torch.Generator().manual_seed(0), 2, "cpu")
    want = (str(alias).removeprefix("torch.")
            if isinstance(alias, torch.dtype) else jnp.dtype(alias).name)
    assert str(obs.dtype).removeprefix("torch.") == want


def test_process_backend_refuses_bfloat16_by_name():
    """numpy, which carries the process backend's trajectories, has no
    bfloat16 (the reference's workers fail on it): the port refuses the
    spec before it starts a worker; float16 is built."""
    spec = ExperimentSpec(env="pendulum", backend="process",
                          env_kwargs={"dtype": "bfloat16"},
                          schedule=Schedule(num_samplers=2, global_batch=4,
                                            horizon=2))
    with pytest.raises(ValueError, match="numpy has no bfloat16"):
        build(spec, device="cpu")


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_episode_returns_and_gae_on_half_rewards_match_jax(dtype):
    """``episode_returns`` runs in the rewards' dtype and casts the episode
    count to it before dividing, as JAX promotes: the same value in the
    same dtype. GAE casts the rewards up exactly, as JAX promotes them
    where they meet the float32 values: the same advantages."""
    tdt, jdt = DTYPES[dtype]
    T, B = 100, 24
    returns = jax.jit(jax_trajectory.episode_returns)
    for seed in range(8):
        rng = np.random.default_rng(seed)
        r = np.asarray(jnp.asarray(
            (rng.standard_normal((T, B)) * 10 - 5).astype(np.float32)
        ).astype(jdt))
        d = rng.random((T, B)) < 0.05
        want = returns({"rewards": jnp.asarray(r), "dones": jnp.asarray(d)})
        got = trajectory.episode_returns({"rewards": to_torch(r),
                                          "dones": torch.from_numpy(d)})
        assert got.dtype == tdt and str(want.dtype) == dtype
        assert half_bits(got.reshape(1))[0] == half_bits(
            np.asarray(want).reshape(1))[0], seed
    v = rng.standard_normal((T, B)).astype(np.float32)
    lv = rng.standard_normal(B).astype(np.float32)
    want = jax_gae(jnp.asarray(r), jnp.asarray(v), jnp.asarray(d),
                   jnp.asarray(lv), impl="ref")
    got = gae_mod.gae(to_torch(r), torch.from_numpy(v), torch.from_numpy(d),
                      torch.from_numpy(lv))
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)


@pytest.fixture(scope="module", params=list(DTYPES))
def half_trajectory(request):
    """(dtype, params, traj) from the JAX package: cheetah with 20-step
    episodes and obs and rewards in ``dtype``, so the trajectory holds
    terminals."""
    dtype = request.param
    env = jax_envs.make("cheetah", max_episode_steps=20, dtype=dtype)
    params = jax_policy.init_policy(jax.random.PRNGKey(1), env.obs_dim,
                                    env.act_dim, hidden=32)
    carry = jax_sampler.init_env_carry(env, jax.random.PRNGKey(2), 8)
    _, traj = jax.jit(jax_sampler.make_env_rollout(env, 32))(params, carry)
    traj = {k: np.asarray(v) for k, v in traj.items()}
    assert traj["dones"].any() and traj["obs"].dtype.name == dtype
    assert traj["rewards"].dtype.name == dtype
    return dtype, jax.tree.map(np.asarray, params), traj


def test_ppo_learn_on_a_half_precision_trajectory_matches_jax(
        half_trajectory):
    """One PPO learn (GAE on the half rewards, 2 Adam steps on the half
    obs) from the same weights: within 1e-5 of JAX."""
    dtype, params, traj = half_trajectory
    cfg = dict(epochs=1, minibatches=2)
    opt_j = jax_adam(3e-4)
    jp = jax.tree.map(jnp.asarray, params)
    p_j, _, m_j = jax.jit(jax_ppo.make_mlp_learner(
        opt_j, jax_ppo.PPOConfig(**cfg)))(
        jp, opt_j.init(jp), {k: jnp.asarray(v) for k, v in traj.items()})
    policy = convert.params_from_jax(params)
    opt_t = adam(3e-4)
    tt = {k: to_torch(v) for k, v in traj.items()}
    assert tt["obs"].dtype == DTYPES[dtype][0]
    policy, s_t, m_t = ppo.make_mlp_learner(opt_t, ppo.PPOConfig(**cfg))(
        policy, opt_t.init(list(policy.parameters())), tt)
    assert int(s_t.step) == 2
    moved = 0.0
    for g, w, p0 in zip(jax.tree.leaves(convert.params_to_jax(policy)),
                        jax.tree.leaves(jax.tree.map(np.asarray, p_j)),
                        jax.tree.leaves(params)):
        np.testing.assert_allclose(g, w, **TOL)
        moved = max(moved, float(np.abs(w - p0).max()))
    assert moved > 1e-4
    for k in ("loss", "pg_loss", "v_loss", "entropy"):
        np.testing.assert_allclose(float(m_t[k]), float(m_j[k]), rtol=1e-4,
                                   atol=1e-5)


def test_sac_update_on_a_half_precision_batch_matches_jax(half_trajectory):
    """n-step transitions of the half-precision trajectory (float32
    rewards and discounts, obs left in their dtype) on both sides, then one
    SAC update on a minibatch of them with the JAX draws injected: within
    1e-5 of JAX."""
    dtype, _, traj = half_trajectory
    traj = dict(traj)
    traj["next_obs"] = np.concatenate([traj["obs"][1:], traj["obs"][-1:]])
    keys = ("obs", "actions", "rewards", "dones", "next_obs")
    want = jax_buffers.nstep_transitions(
        {k: jnp.asarray(traj[k]) for k in keys}, 3, 0.99)
    got = buffers.nstep_transitions({k: to_torch(traj[k]) for k in keys}, 3,
                                    0.99)
    for k in want:
        assert str(got[k].dtype).removeprefix("torch.") == str(
            want[k].dtype), k
        np.testing.assert_allclose(got[k].float().numpy(),
                                   np.asarray(want[k], np.float32),
                                   rtol=1e-6, atol=1e-6, err_msg=k)
    rows = np.random.default_rng(0).permutation(want["rewards"].shape[0])[:64]
    batch = {k: np.asarray(v)[rows] for k, v in want.items()}
    batch["weights"] = np.ones(64, np.float32)
    obs_dim, act_dim = traj["obs"].shape[-1], traj["actions"].shape[-1]
    params = jax_sac.init_sac(jax.random.PRNGKey(0), obs_dim, act_dim, 32)
    cfg = jax_sac.SACConfig()
    opts = (jax_adam(cfg.actor_lr), jax_adam(cfg.critic_lr),
            jax_adam(cfg.alpha_lr))
    states = (opts[0].init(params["actor"]), opts[1].init(params["critic"]),
              opts[2].init(params["log_alpha"]))
    key = jax.random.PRNGKey(2)
    p_j, _, m_j = jax.jit(lambda p, st, b, k: jax_sac.sac_update(
        p, st, b, k, cfg, *opts))(
        params, states, {k: jnp.asarray(v) for k, v in batch.items()}, key)
    k_next, k_new = jax.random.split(key)
    tb = {k: to_torch(v) for k, v in batch.items()}
    assert tb["obs"].dtype == DTYPES[dtype][0]
    tb["noise_next"] = to_torch(jax.random.normal(k_next, (64, act_dim)))
    tb["noise_new"] = to_torch(jax.random.normal(k_new, (64, act_dim)))
    tcfg = sac.SACConfig()
    p_t, _, m_t = sac.sac_update(
        convert.sac_params_from_jax(jax.tree.map(np.asarray, params)),
        convert.sac_adam_states_from_jax(jax.tree.map(np.asarray, states)),
        tb, tcfg, adam(tcfg.actor_lr), adam(tcfg.critic_lr),
        adam(tcfg.alpha_lr))
    for g, w in zip(jax.tree.leaves(convert.sac_params_to_jax(p_t)),
                    jax.tree.leaves(jax.tree.map(np.asarray, p_j))):
        np.testing.assert_allclose(g, w, **TOL)
    for k in m_j:
        np.testing.assert_allclose(m_t[k].numpy(), np.asarray(m_j[k]),
                                   **TOL, err_msg=k)
