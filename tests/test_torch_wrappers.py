"""Running normalisation (``envs/wrappers.py``) of the port against the JAX
package's, within 1e-6 (relative, and absolute at the statistics' scale):
a batch update from the initial state and from a carried one, Chan's merge
of two shards against both the JAX merge and the update on the
concatenated batch, and the clipped normalisation. Fixed seeds, no
Hypothesis draws.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.envs import wrappers as jax_wrappers
from repro_torch.envs import wrappers

TOL = dict(rtol=1e-6, atol=1e-6)
SEEDS = [0, 1, 2, 3]


def batch(rng, n, dim=3, scale=10.0, shift=0.0):
    return (rng.standard_normal((n, dim)) * scale + shift).astype(np.float32)


def close(got, want, **tol):
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **(tol or TOL))


def to_jax(state):
    return jax_wrappers.RunningNorm(*(jnp.asarray(x.numpy()) for x in state))


@pytest.mark.parametrize("seed", SEEDS)
def test_update_matches_jax(seed):
    rng = np.random.default_rng(seed)
    x1, x2 = batch(rng, 2 + 7 * seed), batch(rng, 30, shift=3.0)
    got = wrappers.update_norm(wrappers.init_norm(3), torch.from_numpy(x1))
    want = jax_wrappers.update_norm(jax_wrappers.init_norm(3),
                                    jnp.asarray(x1))
    close(got, want)
    got = wrappers.update_norm(got, torch.from_numpy(x2))
    want = jax_wrappers.update_norm(want, jnp.asarray(x2))
    close(got, want)
    assert float(got.count) == x1.shape[0] + x2.shape[0]
    # the statistics of the whole stream
    both = np.concatenate([x1, x2])
    np.testing.assert_allclose(got.mean.numpy(), both.mean(0), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(got.var.numpy(), both.var(0), rtol=1e-5,
                               atol=1e-4)


@pytest.mark.parametrize("seed", SEEDS)
def test_merge_matches_jax_and_the_concatenated_update(seed):
    """merge(stats(A), stats(B)) == JAX's merge, and == stats(A ++ B) up
    to float32 rounding: what lets each sampler keep its own statistics."""
    rng = np.random.default_rng(10 + seed)
    a, b = batch(rng, 3 + seed), batch(rng, 25, scale=2.0, shift=-4.0)
    sa = wrappers.update_norm(wrappers.init_norm(3), torch.from_numpy(a))
    sb = wrappers.update_norm(wrappers.init_norm(3), torch.from_numpy(b))
    got = wrappers.merge_norm_states(sa, sb)
    want = jax_wrappers.merge_norm_states(to_jax(sa), to_jax(sb))
    close(got, want)
    whole = wrappers.update_norm(wrappers.init_norm(3),
                                 torch.from_numpy(np.concatenate([a, b])))
    close(got, whole, rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("clip", [10.0, 2.0])
@pytest.mark.parametrize("seed", SEEDS)
def test_normalize_matches_jax_and_clips(seed, clip):
    rng = np.random.default_rng(20 + seed)
    state = wrappers.update_norm(wrappers.init_norm(3),
                                 torch.from_numpy(batch(rng, 16)))
    obs = batch(rng, 8, scale=40.0)
    obs[0] = [1e6, -1e6, 0.0]
    got = wrappers.normalize_obs(state, torch.from_numpy(obs), clip=clip)
    want = jax_wrappers.normalize_obs(to_jax(state), jnp.asarray(obs),
                                      clip=clip)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert float(got.abs().max()) <= clip
    assert float(got[0, 0]) == clip and float(got[0, 1]) == -clip


def test_init_norm_matches_jax():
    got, want = wrappers.init_norm(5), jax_wrappers.init_norm(5)
    close(got, want)
    assert got.count.shape == () and got.count.dtype == torch.float32
