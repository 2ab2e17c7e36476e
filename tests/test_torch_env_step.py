"""Env-step parity: the port's plain PyTorch env step against the JAX
reference (``impl="ref"``). The CUDA kernel against the plain version is in
``test_torch_kernels_gpu.py``.

Tolerances:

* ``t`` and ``done`` exact; rows that end their episode hand back the reset
  candidates exactly.
* float leaves, port vs JAX on the CPU: within 4 float32 steps at the
  largest magnitude of the step's output. XLA's and ATen's ``sin``/``cos``
  differ by an ulp and XLA contracts some ``a*b + c`` into FMAs, and the
  difference propagates through cancellation (e.g. ``th`` near 30 feeds
  ``cos(th)``), so a per-element ulp count near zero is no bound. For
  cart-pole this is the JAX suite's own ``PARITY_ULPS["cartpole"] = 4``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import envs as jax_envs
from repro.kernels.env_step import ops as jax_env_ops
from repro_torch import envs
from repro_torch.kernels import select
from repro_torch.kernels.env_step import ops as env_ops
from repro_torch.kernels.env_step import ref as env_ref

HORIZON = 5
PARAMS = {"pendulum": dict(max_torque=2.0), "cartpole": dict(force_max=10.0),
          "cheetah": dict(ctrl_cost=0.1)}


def make_inputs(name, B, seed):
    """numpy (state, actions, reset_state, reset_obs) with a third of the
    rows at their last step, so the reset select fires."""
    rng = np.random.default_rng(seed)

    def f(*shape, lo=-1.0, hi=1.0):
        return rng.uniform(lo, hi, shape).astype(np.float32)

    t = rng.integers(0, HORIZON - 1, B).astype(np.int32)
    t[rng.permutation(B)[: max(1, B // 3)]] = HORIZON - 1
    rt = np.zeros(B, np.int32)
    if name == "pendulum":
        state = (f(B, lo=-3 * np.pi, hi=3 * np.pi), f(B, lo=-8, hi=8), t)
        reset = (f(B, lo=-np.pi, hi=np.pi), f(B), rt)
        return state, f(B, 1, lo=-3, hi=3), reset, f(B, 3)
    if name == "cartpole":
        # x and th around their limits (2.4, 12 degrees), so some poles
        # fall and some carts leave the track; actions beyond the clip
        state = (f(B, lo=-2.5, hi=2.5), f(B, lo=-2, hi=2),
                 f(B, lo=-0.25, hi=0.25), f(B, lo=-2, hi=2), t)
        reset = tuple(f(B, lo=-0.05, hi=0.05) for _ in range(4)) + (rt,)
        return state, f(B, 1, lo=-2, hi=2), reset, f(B, 4)
    state = (f(B, 6), f(B, 6), f(B, lo=-2, hi=2), f(B), t)
    reset = (f(B, 6, lo=-0.1, hi=0.1), f(B, 6, lo=-0.1, hi=0.1),
             np.zeros(B, np.float32), np.zeros(B, np.float32), rt)
    return state, f(B, 6, lo=-2, hi=2), reset, f(B, 14)


def flat(out):
    """(state, obs, rew, done) of either package -> list of numpy arrays."""
    state, obs, rew, done = out
    return [x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
            for x in (*state, obs, rew, done)]


def to_torch(tree, device="cpu"):
    if isinstance(tree, tuple):
        return tuple(to_torch(x, device) for x in tree)
    return torch.from_numpy(tree).to(device)


def assert_step_close(got, want, *, ulps=4):
    """Exact on int/bool; floats within ``ulps`` float32 steps at the
    largest magnitude of the output."""
    scale = max(float(np.abs(w).max(initial=0)) for w in want
                if w.dtype.kind == "f")
    atol = ulps * float(np.spacing(np.float32(max(scale, 1.0))))
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        if w.dtype.kind in "iub":
            np.testing.assert_array_equal(g, w)
        else:
            np.testing.assert_allclose(g, w, rtol=0, atol=atol)


@pytest.mark.parametrize("name", ["pendulum", "cheetah", "cartpole"])
@pytest.mark.parametrize("B", [1, 7, 700, 31, 33, 4097])
@pytest.mark.parametrize("reward_scale", [1.0, 0.5])
def test_plain_env_step_matches_jax_ref(name, B, reward_scale):
    state, a, rs, ro = make_inputs(name, B, seed=B)
    params = dict(max_episode_steps=HORIZON, reward_scale=reward_scale,
                  **PARAMS[name])
    step = jax.jit(lambda s, a, rs, ro: jax_env_ops.env_step(
        name, s, a, rs, ro, impl="ref", **params))
    want = flat(step(jax.tree.map(jnp.asarray, state), jnp.asarray(a),
                     jax.tree.map(jnp.asarray, rs), jnp.asarray(ro)))
    got = flat(env_ops.env_step(name, to_torch(state), to_torch(a),
                                to_torch(rs), to_torch(ro), **params))
    assert_step_close(got, want)
    done = got[-1]
    assert done.dtype == np.bool_ and done.sum() >= max(1, B // 3)
    # ended rows carry the reset candidates, bit for bit
    n_state = len(state)
    for leaf, cand in zip(got[:n_state], rs):
        np.testing.assert_array_equal(leaf[done], cand[done])
    np.testing.assert_array_equal(got[n_state][done], ro[done])


@pytest.mark.parametrize("B", [31, 33, 4097])
@pytest.mark.parametrize("ends", ["all", "none"])
def test_plain_cheetah_step_matches_jax_ref_when_all_or_no_episode_ends(
        B, ends):
    """Every row at its last step (each takes its reset candidates), or
    none: the batch sizes around the CUDA kernel's 5 envs a warp and 20 a
    block."""
    state, a, rs, ro = make_inputs("cheetah", B, seed=B + 2)
    state = state[:4] + (np.full(B, HORIZON - 1 if ends == "all"
                                 else HORIZON - 2, np.int32),)
    params = dict(max_episode_steps=HORIZON, reward_scale=1.0,
                  **PARAMS["cheetah"])
    step = jax.jit(lambda s, a, rs, ro: jax_env_ops.env_step(
        "cheetah", s, a, rs, ro, impl="ref", **params))
    want = flat(step(jax.tree.map(jnp.asarray, state), jnp.asarray(a),
                     jax.tree.map(jnp.asarray, rs), jnp.asarray(ro)))
    got = flat(env_ops.env_step("cheetah", to_torch(state), to_torch(a),
                                to_torch(rs), to_torch(ro), **params))
    assert_step_close(got, want)
    done = got[-1]
    assert done.all() if ends == "all" else not done.any()
    if ends == "all":
        for leaf, cand in zip(got[:len(state)], rs):
            np.testing.assert_array_equal(leaf, cand)
        np.testing.assert_array_equal(got[len(state)], ro)


@pytest.mark.parametrize("impl", ["auto", "cuda", "pallas", "ref"])
def test_cpu_tensor_takes_plain_version(impl):
    """On a CPU tensor every mode runs the plain version and launches
    nothing."""
    state, a, rs, ro = make_inputs("cheetah", 9, seed=1)
    before = env_ops.cheetah_step_cuda.launches
    params = dict(max_episode_steps=HORIZON, reward_scale=1.0, ctrl_cost=0.1)
    got = flat(env_ops.env_step("cheetah", to_torch(state), to_torch(a),
                                to_torch(rs), to_torch(ro), impl=impl,
                                **params))
    want = flat(env_ref.cheetah_step_batch_ref(
        to_torch(state), to_torch(a), to_torch(rs), to_torch(ro), **params))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert env_ops.cheetah_step_cuda.launches == before


def test_select_modes():
    x = torch.zeros(1)
    assert select.canonical("pallas") == "cuda"
    assert select.canonical("auto") == "cuda"
    assert not select.use_kernel("cuda", x)
    with pytest.raises(ValueError, match="unknown kernel mode"):
        select.use_kernel("triton", x)
    with pytest.raises(ValueError, match="no kernel"):
        select.use_kernel("auto", torch.zeros(1, device="meta"))
    prev = select.set_kernel_mode("pallas")
    try:
        assert select.kernel_mode() == "cuda"
    finally:
        select.set_kernel_mode(prev)


def test_kernel_wrapper_rejects_bad_layout():
    """The wrapper checks shapes and types before it builds or launches
    anything; the TPU kernel's (leaf, B) layout is refused."""
    state, a, rs, ro = make_inputs("cheetah", 4, seed=2)
    st = to_torch(state)
    bad = (st[0].T.contiguous(),) + st[1:]
    with pytest.raises(ValueError, match="th must be"):
        env_ops.cheetah_step_cuda(bad, to_torch(a), to_torch(rs),
                                  to_torch(ro), max_episode_steps=HORIZON,
                                  reward_scale=1.0, ctrl_cost=0.1)
    with pytest.raises(KeyError, match="hopper"):
        env_ops.env_step("hopper", st, to_torch(a), to_torch(rs),
                         to_torch(ro))
    cst, ca, crs, cro = make_inputs("cartpole", 4, seed=2)
    cst = to_torch(cst)
    with pytest.raises(ValueError, match="actions must be"):
        env_ops.cartpole_step_cuda(cst, to_torch(ca).reshape(1, 4),
                                   to_torch(crs), to_torch(cro),
                                   max_episode_steps=HORIZON,
                                   reward_scale=1.0, force_max=10.0)
    with pytest.raises(ValueError, match="reset obs must be"):
        env_ops.cartpole_step_cuda(cst, to_torch(ca), to_torch(crs),
                                   to_torch(cro)[:, :3].contiguous(),
                                   max_episode_steps=HORIZON,
                                   reward_scale=1.0, force_max=10.0)


def test_cartpole_falls_and_rewards_like_the_reference():
    """Hand-built rows: upright, tilted past 12 degrees, off the track, and
    an action beyond the clip (the force is clipped, the control cost
    takes the raw action); ``t`` restarts with the reset."""
    zeros = torch.zeros(4)
    state = (torch.tensor([0.0, 0.0, 2.45, 0.0]), zeros.clone(),
             torch.tensor([0.0, 0.3, 0.0, 0.0]), zeros.clone(),
             torch.tensor([3, 3, 3, 3], dtype=torch.int32))
    actions = torch.tensor([[0.0], [0.0], [0.0], [3.0]])
    reset = tuple(torch.full((4,), 0.01) for _ in range(4)) + (
        torch.zeros(4, dtype=torch.int32),)
    (x, _, _, _, t), obs, rew, done = env_ref.cartpole_step_batch_ref(
        state, actions, reset, torch.full((4, 4), 0.01),
        max_episode_steps=HORIZON, reward_scale=1.0, force_max=10.0)
    assert done.tolist() == [False, True, True, False]
    np.testing.assert_allclose(rew.numpy(), [1.0, 0.0, 0.0, 1.0 - 0.09],
                               rtol=1e-6)
    assert t.tolist() == [4, 0, 0, 4]
    assert float(x[3]) == 0.0 and float(obs[1, 0]) == np.float32(0.01)


def test_cartpole_env_matches_the_reference_env():
    """The env's contract: obs (B, 4), one action, horizon 500, resets
    uniform in [-0.05, 0.05] with ``t`` 0."""
    env = envs.make("cartpole")
    jenv = jax_envs.make("cartpole")
    assert (env.obs_dim, env.act_dim, env.max_episode_steps) == (
        jenv.obs_dim, jenv.act_dim, jenv.max_episode_steps) == (4, 1, 500)
    state, obs = env.reset(torch.Generator().manual_seed(0), 256, "cpu")
    assert obs.shape == (256, 4) and obs.dtype == torch.float32
    assert float(obs.abs().max()) <= 0.05 and float(obs.abs().max()) > 0.04
    assert torch.equal(obs, torch.stack(state[:4], dim=-1))
    assert state[4].dtype == torch.int32 and not state[4].any()



@pytest.mark.parametrize("name", ["pendulum", "cartpole"])
@pytest.mark.parametrize("B", [1, 31, 33, 65, 4097])
@pytest.mark.parametrize("ends", ["all", "none"])
def test_plain_pendulum_and_cartpole_steps_match_jax_ref_when_all_or_no_episode_ends(
        name, B, ends):
    """Every row at its last step, or none (cart-pole's carts and poles
    then inside the fall limits, so none falls): the batch sizes around
    the CUDA kernels' warps of 32 envs."""
    state, a, rs, ro = make_inputs(name, B, seed=B + 3)
    t = np.full(B, HORIZON - 1 if ends == "all" else HORIZON - 2, np.int32)
    state = state[:-1] + (t,)
    if name == "cartpole" and ends == "none":
        # |x| <= 2.3 and |th| <= 0.16, then a step of at most 0.04 each
        state = (state[0] * np.float32(2.3 / 2.5), state[1],
                 state[2] * np.float32(0.16 / 0.25), state[3], t)
    params = dict(max_episode_steps=HORIZON, reward_scale=1.0,
                  **PARAMS[name])
    step = jax.jit(lambda s, a, rs, ro: jax_env_ops.env_step(
        name, s, a, rs, ro, impl="ref", **params))
    want = flat(step(jax.tree.map(jnp.asarray, state), jnp.asarray(a),
                     jax.tree.map(jnp.asarray, rs), jnp.asarray(ro)))
    got = flat(env_ops.env_step(name, to_torch(state), to_torch(a),
                                to_torch(rs), to_torch(ro), **params))
    assert_step_close(got, want)
    done = got[-1]
    assert done.all() if ends == "all" else not done.any()
    if ends == "all":
        for leaf, cand in zip(got[:len(state)], rs):
            np.testing.assert_array_equal(leaf, cand)
        np.testing.assert_array_equal(got[len(state)], ro)


WRAPPER_LEAVES = {
    "pendulum": ["th", "thdot", "t", "actions", "reset th", "reset thdot",
                 "reset t", "reset obs"],
    "cartpole": ["x", "xdot", "th", "thdot", "t", "actions", "reset x",
                 "reset xdot", "reset th", "reset thdot", "reset t",
                 "reset obs"],
    "cheetah": ["th", "om", "vx", "pitch", "t", "actions", "reset th",
                "reset om", "reset vx", "reset pitch", "reset t",
                "reset obs"],
}


def _spoil(x, fault):
    """``x`` with one fault: another shape (one more trailing column),
    another dtype, a strided view of the same shape, or on another
    device."""
    if fault == "shape":
        return (torch.zeros(x.shape + (1,), dtype=x.dtype) if x.dim() == 1
                else torch.zeros(x.shape[0], x.shape[1] + 1, dtype=x.dtype))
    if fault == "dtype":
        return x.to(torch.float64 if x.dtype == torch.float32
                    else torch.int64)
    if fault == "non-contiguous":
        return torch.zeros(x.shape + (2,), dtype=x.dtype)[..., 0]
    return torch.zeros(x.shape, dtype=x.dtype, device="meta")


@pytest.mark.parametrize("fault", ["shape", "dtype", "non-contiguous",
                                   "device"])
@pytest.mark.parametrize("name,leaf", [
    (name, k) for name in WRAPPER_LEAVES
    for k in range(len(WRAPPER_LEAVES[name]))])
def test_kernel_wrappers_refuse_each_bad_leaf_before_any_build(
        monkeypatch, name, leaf, fault):
    """Each wrapper refuses a leaf of the wrong shape or dtype, a strided
    one or one on another device, names it, and neither builds nor
    launches anything."""
    def no_build():
        raise AssertionError("the wrapper reached the library")

    monkeypatch.setattr(env_ops, "_lib", no_build)
    state, a, rs, ro = (to_torch(x) for x in make_inputs(name, 4, seed=5))
    flat_in = [*state, a, *rs, ro]
    flat_in[leaf] = _spoil(flat_in[leaf], fault)
    n = len(state)
    args = (tuple(flat_in[:n]), flat_in[n], tuple(flat_in[n + 1:2 * n + 1]),
            flat_in[-1])
    label = WRAPPER_LEAVES[name][leaf]
    # B and the device are those of one leaf (cheetah's vx, else the
    # first); moved to another device, that leaf makes every other one
    # disagree, and the first of those is refused
    fixes = 2 if name == "cheetah" else 0
    if fault == "device" and leaf == fixes:
        label = WRAPPER_LEAVES[name][1 if fixes == 0 else 0]
    with pytest.raises(ValueError,
                       match=f"env_step kernel: {label} must be a "
                             f"contiguous") as info:
        env_ops.STEP_BATCH_CUDA[name](*args, max_episode_steps=HORIZON,
                                      reward_scale=1.0, **PARAMS[name])
    if fault == "non-contiguous":
        assert str(info.value).endswith("(non-contiguous)")


@pytest.mark.parametrize("B", [0, 1, 16, 4097])
@pytest.mark.parametrize("name", ["pendulum", "cartpole", "cheetah"])
def test_output_allocation_gives_fresh_disjoint_outputs(name, B):
    """``_outputs`` of each env's leaves: the next state's leaves shaped
    and typed like the state's, obs like the reset obs, rewards float32
    and dones bool, all contiguous, on the inputs' device, no two sharing
    a byte, none sharing one with an input."""
    state, _, _, ro = (to_torch(x) for x in make_inputs(name, B, seed=2))
    outs = env_ops._outputs(state, ro)
    assert len(outs) == len(state) + 3
    want = [*state, ro, torch.zeros(B), torch.zeros(B, dtype=torch.bool)]
    for x, w in zip(outs, want):
        assert (x.shape, x.dtype, x.device) == (w.shape, w.dtype, w.device)
        assert x.is_contiguous()

    def spans(xs):
        return [(x.data_ptr(), x.data_ptr() + x.numel() * x.element_size())
                for x in xs if x.numel()]

    spans_out = sorted(spans(outs))
    assert all(end <= start
               for (_, end), (start, _) in zip(spans_out, spans_out[1:]))
    assert not any(s < e_in and s_in < e for s, e in spans_out
                   for s_in, e_in in spans([*state, ro]))


@pytest.mark.parametrize("name", ["pendulum", "cartpole", "cheetah"])
def test_kernel_wrappers_at_zero_envs_return_empty_outputs(monkeypatch, name):
    """B = 0: the wrapper checks its leaves and returns empty outputs of
    the plain version's shapes and dtypes, without building or
    launching."""
    def no_build():
        raise AssertionError("the wrapper reached the library")

    monkeypatch.setattr(env_ops, "_lib", no_build)
    wrapper = env_ops.STEP_BATCH_CUDA[name]
    before = wrapper.launches
    args = tuple(to_torch(x) for x in make_inputs(name, 3, seed=1))
    empty = tuple(tuple(leaf[:0] for leaf in x) if isinstance(x, tuple)
                  else x[:0] for x in args)
    params = dict(max_episode_steps=HORIZON, reward_scale=1.0,
                  **PARAMS[name])
    got = flat(wrapper(*empty, **params))
    want = flat(env_ref.STEP_BATCH_REF[name](*empty, **params))
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
    assert wrapper.launches == before
