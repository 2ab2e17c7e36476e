"""The CUDA kernels against their plain PyTorch versions on the card.

Every test here needs a CUDA device and skips without one. The file
imports neither ``jax`` nor ``repro``, so it runs where only PyTorch is
installed:

    PYTHONPATH=src python -m pytest --noconftest -m gpu \
        tests/test_torch_kernels_gpu.py

Bounds: ``t``, ``done`` and GAE exact (``-fmad=false`` and only ``+ - *``:
the kernel rounds the plain version's expressions the same way); env float
leaves within 4 ulp per element, or 4 ulp of the leaf's magnitude where
cancellation leaves a value near zero (``sinf``/``cosf`` may differ from
ATen's by an ulp).
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels.env_step import ops as env_ops
from repro_torch.kernels.env_step import ref as env_ref
from repro_torch.kernels.gae import ops as gae_ops

HORIZON = 5
PARAMS = {"pendulum": dict(max_torque=2.0), "cheetah": dict(ctrl_cost=0.1)}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def env_inputs(name, B, device):
    rng = np.random.default_rng(B)

    def f(*shape, lo=-1.0, hi=1.0):
        return torch.from_numpy(
            rng.uniform(lo, hi, shape).astype(np.float32)).to(device)

    t = rng.integers(0, HORIZON - 1, B).astype(np.int32)
    t[rng.permutation(B)[: max(1, B // 3)]] = HORIZON - 1
    t = torch.from_numpy(t).to(device)
    rt = torch.zeros(B, dtype=torch.int32, device=device)
    if name == "pendulum":
        return ((f(B, lo=-10, hi=10), f(B, lo=-8, hi=8), t),
                f(B, 1, lo=-3, hi=3), (f(B), f(B), rt), f(B, 3))
    zeros = torch.zeros(B, device=device)
    return ((f(B, 6), f(B, 6), f(B, lo=-2, hi=2), f(B), t),
            f(B, 6, lo=-2, hi=2),
            (f(B, 6), f(B, 6), zeros, zeros.clone(), rt), f(B, 14))


def leaves(out):
    state, obs, rew, done = out
    return [x.cpu().numpy() for x in (*state, obs, rew, done)]


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["pendulum", "cheetah"])
@pytest.mark.parametrize("B", [1, 700, 16384])
def test_env_step_kernel_matches_plain(cuda, name, B):
    state, a, rs, ro = env_inputs(name, B, cuda)
    params = dict(max_episode_steps=HORIZON, reward_scale=0.5,
                  **PARAMS[name])
    before = env_ops.STEP_BATCH_CUDA[name].launches
    got = env_ops.env_step(name, state, a, rs, ro, impl="cuda", **params)
    want = env_ref.STEP_BATCH_REF[name](state, a, rs, ro, **params)
    torch.cuda.synchronize()
    assert env_ops.STEP_BATCH_CUDA[name].launches == before + 1
    for g, w in zip(leaves(got), leaves(want)):
        assert g.dtype == w.dtype and g.shape == w.shape
        if w.dtype.kind in "iub":
            np.testing.assert_array_equal(g, w)
        else:
            floor = np.spacing(np.float32(max(np.abs(w).max(), 1e-30)))
            tol = 4 * np.maximum(np.spacing(np.abs(w)), floor)
            assert (np.abs(g - w) <= tol).all()


@pytest.mark.gpu
def test_env_step_ref_mode_launches_nothing(cuda):
    state, a, rs, ro = env_inputs("cheetah", 64, cuda)
    before = env_ops.cheetah_step_cuda.launches
    env_ops.env_step("cheetah", state, a, rs, ro, impl="ref",
                     max_episode_steps=HORIZON, reward_scale=1.0,
                     ctrl_cost=0.1)
    assert env_ops.cheetah_step_cuda.launches == before


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(1, 1), (125, 160), (128, 4096),
                                   (16, 3, 5)])
def test_gae_kernel_matches_plain(cuda, shape):
    rng = np.random.default_rng(7)
    r, v = (torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
            .to(cuda) for _ in range(2))
    d = torch.from_numpy(rng.random(shape) < 0.1).to(cuda)
    lv = torch.from_numpy(
        rng.standard_normal(shape[1:]).astype(np.float32)).to(cuda)
    before = gae_ops.gae_cuda.launches
    got = gae_ops.gae(r, v, d, lv, impl="cuda")
    want = gae_ops.gae_ref(r, v, d, lv)
    torch.cuda.synchronize()
    assert gae_ops.gae_cuda.launches == before + 1
    for g, w in zip(got, want):
        assert g.shape == w.shape and torch.equal(g, w)
