"""Policy and optimizer parity: the port's Gaussian-MLP policy from
converted JAX params, one hand-written Adam step and global-norm clipping
with injected gradients, all against the JAX package on the same inputs.

Tolerance 1e-5 relative / 1e-6 absolute on float32: XLA and ATen run the
64-wide matmuls and the sums with other summation orders.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import mlp_policy as jax_policy
from repro.optim import adam as jax_adam
from repro.optim import clip_by_global_norm as jax_clip
from repro_torch import convert
from repro_torch.models import layers, mlp_policy
from repro_torch.optim import adam, apply_updates, clip_by_global_norm

TOL = dict(rtol=1e-5, atol=1e-6)
OBS, ACT = 14, 6


def jax_params(seed=0):
    return jax.tree.map(np.asarray, jax_policy.init_policy(
        jax.random.PRNGKey(seed), OBS, ACT, hidden=64))


def test_convert_round_trip_is_exact():
    tree = jax_params()
    back = convert.params_to_jax(convert.params_from_jax(tree))
    for a, b in zip(jax.tree.leaves(tree), jax.tree.leaves(back)):
        np.testing.assert_array_equal(a, b)


def test_policy_matches_jax():
    tree = jax_params(1)
    policy = convert.params_from_jax(tree)
    rng = np.random.default_rng(0)
    obs = rng.standard_normal((32, OBS)).astype(np.float32)
    act = rng.standard_normal((32, ACT)).astype(np.float32)
    noise = rng.standard_normal((32, ACT)).astype(np.float32)
    jp = jax.tree.map(jnp.asarray, tree)
    mean_j, std_j = jax_policy.policy_dist(jp, jnp.asarray(obs))
    with torch.no_grad():
        mean_t, std_t = policy.dist(torch.from_numpy(obs))
        logp_t = policy.logp(torch.from_numpy(obs), torch.from_numpy(act))
        v_t = policy.value(torch.from_numpy(obs))
        a_t, alogp_t = policy.sample_action(torch.from_numpy(obs),
                                            torch.from_numpy(noise))
    np.testing.assert_allclose(mean_t.numpy(), mean_j, **TOL)
    np.testing.assert_allclose(std_t.numpy(), std_j, **TOL)
    np.testing.assert_allclose(
        logp_t.numpy(),
        jax_policy.action_logp(jp, jnp.asarray(obs), jnp.asarray(act)), **TOL)
    np.testing.assert_allclose(
        v_t.numpy(), jax_policy.value_apply(jp, jnp.asarray(obs)), **TOL)
    np.testing.assert_allclose(float(policy.entropy().detach()),
                               float(jax_policy.entropy(jp)), **TOL)
    # the reference's sample_action is mean + std * normal(key): inject it
    a_j = mean_j + std_j * jnp.asarray(noise)
    np.testing.assert_allclose(a_t.numpy(), a_j, **TOL)
    np.testing.assert_allclose(
        alogp_t.numpy(), jax_policy.gaussian_logp(mean_j, std_j, a_j), **TOL)


def test_init_policy_shapes_and_init():
    g = torch.Generator().manual_seed(0)
    policy = mlp_policy.init_policy(g, OBS, ACT, hidden=64)
    shapes = [tuple(p.shape) for p in policy.parameters()]
    assert shapes == [(ACT,), (64, OBS), (64,), (64, 64), (64,), (ACT, 64),
                      (ACT,), (64, OBS), (64,), (64, 64), (64,), (1, 64),
                      (1,)]
    assert torch.all(policy.log_std == mlp_policy.LOG_STD_INIT)
    w = layers.dense_init(torch.Generator().manual_seed(1), (256, 512))
    assert float(w.abs().max()) <= 3 * 256 ** -0.5
    assert abs(float(w.std()) * 256 ** 0.5 - 0.987) < 0.02  # N(0,1) cut at 3
    again = mlp_policy.init_policy(torch.Generator().manual_seed(0), OBS,
                                   ACT, hidden=64)
    for a, b in zip(policy.parameters(), again.parameters()):
        assert torch.equal(a, b)


def _grads_like(tree, seed, scale):
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda x: (scale * rng.standard_normal(x.shape)).astype(np.float32),
        tree)


def test_adam_steps_match_jax():
    tree = jax_params(2)
    opt_j = jax_adam(3e-4)
    state_j = opt_j.init(jax.tree.map(jnp.asarray, tree))
    params_j = jax.tree.map(jnp.asarray, tree)
    policy = convert.params_from_jax(tree)
    params_t = list(policy.parameters())
    opt_t = adam(3e-4)
    state_t = opt_t.init(params_t)
    for step in range(3):           # the bias corrections change per step
        g = _grads_like(tree, step, 0.1)
        upd_j, state_j = opt_j.update(jax.tree.map(jnp.asarray, g), state_j,
                                      params_j)
        params_j = jax.tree.map(lambda p, u: p + u, params_j, upd_j)
        g_t = [torch.from_numpy(np.ascontiguousarray(x))
               for x in convert._flat(g)]
        upd_t, state_t = opt_t.update(g_t, state_t, params_t)
        apply_updates(params_t, upd_t)
    assert state_t.step == int(state_j.step) == 3
    want = convert._flat(jax.tree.map(np.asarray, params_j))
    for p, w in zip(params_t, want):
        np.testing.assert_allclose(p.detach().numpy(), w, **TOL)
    mu = convert.adam_state_from_jax(jax.tree.map(np.asarray, state_j))
    for a, b in zip(state_t.mu + state_t.nu, mu.mu + mu.nu):
        np.testing.assert_allclose(a.numpy(), b.numpy(), **TOL)


@pytest.mark.parametrize("scale,max_norm", [(1.0, 0.5), (1e-3, 0.5)])
def test_clip_by_global_norm_matches_jax(scale, max_norm):
    g = _grads_like(jax_params(), 4, scale)
    clipped_j, norm_j = jax_clip(jax.tree.map(jnp.asarray, g), max_norm)
    clipped_t, norm_t = clip_by_global_norm(
        [torch.from_numpy(np.ascontiguousarray(x)) for x in convert._flat(g)],
        max_norm)
    np.testing.assert_allclose(float(norm_t), float(norm_j), **TOL)
    want = convert._flat(jax.tree.map(np.asarray, clipped_j))
    for a, b in zip(clipped_t, want):
        np.testing.assert_allclose(a.numpy(), b, **TOL)
    if scale == 1.0:                # the clipped tree has norm max_norm
        total = float(torch.sqrt(sum((x ** 2).sum() for x in clipped_t)))
        assert abs(total - max_norm) < 1e-5


@pytest.mark.parametrize("scale,max_norm", [(1.0, 0.5), (1e-3, 0.5)])
def test_clip_by_global_norm_bfloat16_matches_jax(scale, max_norm):
    """bfloat16 leaves (a 4,096-wide one among them): both sides square,
    sum and scale in float32 and cast back. The float32 norms differ only
    by summation order, so they agree to 1e-6 relative; a clipped value is
    the float32 product rounded to bfloat16, so a scale one float32 ulp off
    may move it by at most one bfloat16 ulp, and that is the bound held."""
    g = convert._flat(_grads_like(jax_params(), 5, scale))
    g.append((scale * np.random.default_rng(6).standard_normal(4096)
              ).astype(np.float32))
    clipped_j, norm_j = jax_clip([jnp.asarray(x, jnp.bfloat16) for x in g],
                                 max_norm)
    grads_t = [torch.from_numpy(np.ascontiguousarray(x)).to(torch.bfloat16)
               for x in g]
    clipped_t, norm_t = clip_by_global_norm(grads_t, max_norm)
    assert norm_t.dtype == torch.float32 and norm_j.dtype == jnp.float32
    np.testing.assert_allclose(float(norm_t), float(norm_j), rtol=1e-6)
    for a, b in zip(clipped_t, clipped_j):
        assert a.dtype == torch.bfloat16 and b.dtype == jnp.bfloat16
        got = a.float().numpy()
        want = np.asarray(b, np.float32)
        # one bfloat16 ulp of the larger magnitude: 2^(exponent - 7)
        ulp = np.exp2(np.floor(np.log2(np.maximum(
            np.maximum(np.abs(got), np.abs(want)), 1e-30))) - 7)
        assert np.all(np.abs(got - want) <= ulp)
