"""GAE parity: the port's plain GAE against the JAX reference ``gae_ref``
and ``normalize`` against the reference's. The CUDA kernel against the
plain version is in ``test_torch_kernels_gpu.py``.

Port vs JAX on the CPU: the same expressions in the same order, but XLA
may contract ``r + (gamma * v_next) * nt`` into an FMA inside its scan, so
the comparison allows 4 float32 steps at the output's largest magnitude.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.algos import gae as jax_gae_mod
from repro.kernels.gae.ref import gae_ref as jax_gae_ref
from repro_torch.algos import gae as gae_mod


def inputs(shape, seed, p_done=0.1):
    rng = np.random.default_rng(seed)
    r = rng.standard_normal(shape).astype(np.float32)
    v = rng.standard_normal(shape).astype(np.float32)
    d = rng.random(shape) < p_done
    lv = rng.standard_normal(shape[1:]).astype(np.float32)
    return r, v, d, lv


def assert_close(got, want, ulps=4):
    scale = max(float(np.abs(w).max(initial=0)) for w in want)
    atol = ulps * float(np.spacing(np.float32(max(scale, 1.0))))
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == w.dtype
        np.testing.assert_allclose(g, w, rtol=0, atol=atol)


@pytest.mark.parametrize("shape", [(1, 1), (125, 160), (16, 3, 5)])
@pytest.mark.parametrize("gamma,lam", [(0.99, 0.95), (0.9, 1.0)])
def test_plain_gae_matches_jax_ref(shape, gamma, lam):
    r, v, d, lv = inputs(shape, seed=sum(shape))
    want = [np.asarray(x) for x in jax_gae_ref(
        jnp.asarray(r), jnp.asarray(v), jnp.asarray(d), jnp.asarray(lv),
        gamma, lam)]
    got = [x.numpy() for x in gae_mod.gae(
        torch.from_numpy(r), torch.from_numpy(v), torch.from_numpy(d),
        torch.from_numpy(lv), gamma, lam)]
    assert_close(got, want)


def test_gae_hand_checked():
    """Two steps, the episode ending at t=0: no bootstrap across it."""
    r = torch.tensor([[1.0], [2.0]])
    v = torch.tensor([[0.5], [0.25]])
    d = torch.tensor([[True], [False]])
    lv = torch.tensor([4.0])
    adv, ret = gae_mod.gae(r, v, d, lv, gamma=0.5, lam=0.5)
    a1 = 2.0 + 0.5 * 4.0 - 0.25
    a0 = 1.0 - 0.5
    np.testing.assert_allclose(adv.numpy(), [[a0], [a1]])
    np.testing.assert_allclose(ret.numpy(), [[a0 + 0.5], [a1 + 0.25]])


def test_normalize_matches_jax():
    x = np.random.default_rng(3).standard_normal((64, 8)).astype(np.float32)
    want = np.asarray(jax_gae_mod.normalize(jnp.asarray(x)))
    got = gae_mod.normalize(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)

