"""GAE parity: the port's plain GAE and discounted returns against the JAX
references ``gae_ref`` and ``discounted_returns_ref``, and ``normalize``
against the reference's. The CUDA kernels against the plain versions are
in ``test_torch_kernels_gpu.py``.

Port vs JAX on the CPU: the same expressions in the same order, but XLA
may contract ``r + (gamma * v_next) * nt`` into an FMA inside its scan, so
the comparison allows 4 float32 steps at the output's largest magnitude.
For the discounted returns XLA does contract ``r + (gamma * nt) * carry``
into one FMA (with ``gamma = 1`` the product is exact and so is the
result). The port's plain version is therefore held exactly against the
reference's recurrence evaluated in numpy, one rounding per operation in
the reference's order, and within the same 4 steps against XLA's result.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.algos import gae as jax_gae_mod
from repro.kernels.gae.ref import discounted_returns_ref as jax_returns_ref
from repro.kernels.gae.ref import gae_ref as jax_gae_ref
from repro_torch.algos import gae as gae_mod
from repro_torch.kernels.gae import ops as gae_ops


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


# (T, B) beside the CUDA kernel's 32-column blocks and 128-step chunks
EDGE_SHAPES = [(31, 31), (31, 33), (33, 31), (33, 33), (129, 31), (129, 33)]


@pytest.mark.parametrize("shape", [(1, 1), (125, 160), (16, 3, 5)]
                         + EDGE_SHAPES)
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


@pytest.mark.parametrize("shape", EDGE_SHAPES)
@pytest.mark.parametrize("ended_at", ["t=0", "t=T-1"])
def test_plain_gae_matches_jax_ref_with_episode_ends_at_the_edges(shape,
                                                                  ended_at):
    """Every column's episode ends at the first or at the last step only:
    the bootstrap is cut at the walk's last step or at its first."""
    r, v, _, lv = inputs(shape, seed=sum(shape) + 1)
    d = np.zeros(shape, bool)
    d[0 if ended_at == "t=0" else -1] = True
    want = [np.asarray(x) for x in jax_gae_ref(
        jnp.asarray(r), jnp.asarray(v), jnp.asarray(d), jnp.asarray(lv),
        0.99, 0.95)]
    got = [x.numpy() for x in gae_mod.gae(
        torch.from_numpy(r), torch.from_numpy(v), torch.from_numpy(d),
        torch.from_numpy(lv), 0.99, 0.95)]
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



def _returns_in_numpy(r, d, lv, gamma):
    """The reference's recurrence in numpy float32, one rounding per
    operation in its order: ``r + (gamma * nt) * carry``."""
    nt = np.float32(1.0) - d.astype(np.float32)
    carry, out = lv.copy(), np.empty_like(r)
    for t in reversed(range(r.shape[0])):
        carry = r[t] + (np.float32(gamma) * nt[t]) * carry
        out[t] = carry
    return out


@pytest.mark.parametrize("shape", [(1, 1), (7, 1), (125, 160), (16, 3, 5)])
@pytest.mark.parametrize("gamma", [0.99, 0.9, 1.0])
def test_plain_discounted_returns_matches_jax_ref(shape, gamma):
    r, _, d, lv = inputs(shape, seed=sum(shape))
    got = gae_mod.discounted_returns(
        torch.from_numpy(r), torch.from_numpy(d), torch.from_numpy(lv),
        gamma).numpy()
    want = np.asarray(jax_returns_ref(jnp.asarray(r), jnp.asarray(d),
                                      jnp.asarray(lv), gamma))
    assert got.shape == want.shape and got.dtype == want.dtype
    np.testing.assert_array_equal(got, _returns_in_numpy(r, d, lv, gamma))
    if gamma == 1.0:
        np.testing.assert_array_equal(got, want)
    else:
        assert_close([got], [want])


def test_discounted_returns_hand_checked():
    """Three steps, the episode ending at t=1: no bootstrap across it."""
    r = torch.tensor([[1.0], [2.0], [4.0]])
    d = torch.tensor([[False], [True], [False]])
    ret = gae_mod.discounted_returns(r, d, torch.tensor([8.0]), gamma=0.5)
    np.testing.assert_array_equal(ret.numpy(), [[2.0], [2.0], [8.0]])


def test_discounted_returns_empty_and_cpu_mode():
    """T = 0 gives an empty result; on CPU tensors every mode takes the
    plain version and launches nothing."""
    empty = gae_mod.discounted_returns(torch.zeros(0, 3),
                                       torch.zeros(0, 3, dtype=torch.bool),
                                       torch.zeros(3))
    assert empty.shape == (0, 3)
    r, _, d, lv = inputs((5, 4), seed=1)
    before = gae_ops.discounted_returns_cuda.launches
    for impl in ("auto", "cuda", "ref"):
        got = gae_ops.discounted_returns(
            torch.from_numpy(r), torch.from_numpy(d), torch.from_numpy(lv),
            impl=impl)
        np.testing.assert_array_equal(
            got.numpy(), _returns_in_numpy(r, d, lv, 0.99))
    assert gae_ops.discounted_returns_cuda.launches == before
