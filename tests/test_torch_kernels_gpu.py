"""The CUDA kernels against their plain PyTorch versions on the card.

Every test here needs a CUDA device and skips without one. The file
imports neither ``jax`` nor ``repro``, so it runs where only PyTorch is
installed:

    PYTHONPATH=src python -m pytest --noconftest -m gpu \
        tests/test_torch_kernels_gpu.py

Bounds: ``t``, ``done``, GAE and the discounted returns exact
(``-fmad=false`` and only ``+ - *``: the kernel rounds the plain version's
expressions the same way), also at the tile edges of their 64-step chunks
and 32-column blocks; env float
leaves within 4 ulp per element, or 4 ulp of the leaf's magnitude where
cancellation leaves a value near zero (``sinf``/``cosf`` may differ from
ATen's by an ulp); the cheetah step at its tile edges bit for bit, as it
has measured on the H100. The replay-ring and sum-tree kernels exactly: they move
bytes, or compare and subtract/add as the plain versions do.

The LM kernels against their plain versions with ``tests/test_kernels.py``'s
bounds for the Pallas kernels: flash and decode attention ``atol`` 2e-5 in
float32 and 3e-2 in bfloat16 (sums in another order; in bfloat16 the
output rounds to 8 bits); the selective scan 2e-4, relative where the
state grows over a long sequence (``expf`` and ATen's ``exp`` may differ
by an ulp, and y's sum over the state runs in another order). The hymba
model at reduced size, kernels against plain paths, within 1e-4 on the
logits (float32 sums in another order through two layers).
"""
import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.kernels import select
from repro_torch.kernels.decode_attention import ops as dec_ops
from repro_torch.kernels.env_step import ops as env_ops
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.env_step import ref as env_ref
from repro_torch.kernels.gae import ops as gae_ops
from repro_torch.kernels.replay_ring import ops as ring_ops
from repro_torch.kernels.selective_scan import ops as scan_ops
from repro_torch.kernels.sum_tree import ops as tree_ops
from repro_torch.kernels.sum_tree import ref as tree_ref
from repro_torch.models import transformer

HORIZON = 5
PARAMS = {"pendulum": dict(max_torque=2.0), "cartpole": dict(force_max=10.0),
          "cheetah": dict(ctrl_cost=0.1)}


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
    if name == "cartpole":          # around the fall limits
        return ((f(B, lo=-2.5, hi=2.5), f(B, lo=-2, hi=2),
                 f(B, lo=-0.25, hi=0.25), f(B, lo=-2, hi=2), t),
                f(B, 1, lo=-2, hi=2),
                tuple(f(B, lo=-0.05, hi=0.05) for _ in range(4)) + (rt,),
                f(B, 4))
    zeros = torch.zeros(B, device=device)
    return ((f(B, 6), f(B, 6), f(B, lo=-2, hi=2), f(B), t),
            f(B, 6, lo=-2, hi=2),
            (f(B, 6), f(B, 6), zeros, zeros.clone(), rt), f(B, 14))


def leaves(out):
    state, obs, rew, done = out
    return [x.cpu().numpy() for x in (*state, obs, rew, done)]


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["pendulum", "cheetah", "cartpole"])
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


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(1, 1), (125, 160), (128, 4096),
                                   (125, 163), (16, 3, 5), (0, 4), (5, 0)])
def test_discounted_returns_kernel_matches_plain(cuda, shape):
    rng = np.random.default_rng(11)
    r = torch.from_numpy(rng.standard_normal(shape).astype(np.float32)
                         ).to(cuda)
    d = torch.from_numpy(rng.random(shape) < 0.1).to(cuda)
    lv = torch.from_numpy(
        rng.standard_normal(shape[1:]).astype(np.float32)).to(cuda)
    before = gae_ops.discounted_returns_cuda.launches
    got = gae_ops.discounted_returns(r, d, lv, 0.97, impl="cuda")
    want = gae_ops.discounted_returns_ref(r, d, lv, 0.97)
    torch.cuda.synchronize()
    launched = int(r.numel() > 0)
    assert gae_ops.discounted_returns_cuda.launches == before + launched
    assert got.shape == want.shape and torch.equal(got, want)


# the redesigned kernels' tile edges: gae's 32-column blocks, 32-row
# vector loads and 64-step chunks, cheetah's 5 envs a warp and 20 a block
# (chip_smoke.py checks the same edges)
GAE_EDGE_T = [1, 31, 32, 33, 125, 128, 129, 1000]
GAE_EDGE_B = [1, 31, 33, 160, 4096, 4097]


def _gae_inputs(T, B, dones, device, seed):
    rng = np.random.default_rng(seed)
    r, v = (torch.from_numpy(rng.standard_normal((T, B)).astype(np.float32))
            .to(device) for _ in range(2))
    d = torch.zeros((T, B), dtype=torch.bool)
    if dones == "all":
        d[:] = True
    elif dones == "t=0":
        d[0] = True
    elif dones == "t=T-1":
        d[-1] = True
    elif dones == "10%":
        d = torch.from_numpy(rng.random((T, B)) < 0.1)
    lv = torch.from_numpy(rng.standard_normal(B).astype(np.float32)).to(device)
    return r, v, d.to(device), lv


@pytest.mark.gpu
@pytest.mark.parametrize("dones", ["none", "all", "t=0", "t=T-1", "10%"])
@pytest.mark.parametrize("B", GAE_EDGE_B)
@pytest.mark.parametrize("T", GAE_EDGE_T)
def test_gae_kernel_at_tile_edges(cuda, T, B, dones):
    """Bit for bit against the plain version, one launch a call."""
    r, v, d, lv = _gae_inputs(T, B, dones, cuda, seed=T * B)
    before = gae_ops.gae_cuda.launches
    got = gae_ops.gae_cuda(r, v, d, lv, gamma=0.99, lam=0.95)
    want = gae_ops.gae_ref(r, v, d, lv, 0.99, 0.95)
    torch.cuda.synchronize()
    assert gae_ops.gae_cuda.launches == before + 1
    for g, w in zip(got, want):
        assert torch.equal(g, w)


# the redesigned returns kernel's edges: its 64-step chunks and 32-column
# blocks (chip_smoke.py checks the same)
RETURNS_EDGE_T = [1, 63, 64, 65, 128, 129]
RETURNS_EDGE_B = [1, 31, 32, 33, 160, 163, 4096]


@pytest.mark.gpu
@pytest.mark.parametrize("dones", ["none", "all", "t=0", "t=T-1", "10%"])
@pytest.mark.parametrize("B", RETURNS_EDGE_B)
@pytest.mark.parametrize("T", RETURNS_EDGE_T)
def test_discounted_returns_kernel_at_tile_edges(cuda, T, B, dones):
    """Bit for bit against the plain version, one launch a call."""
    r, _, d, lv = _gae_inputs(T, B, dones, cuda, seed=T * B + 1)
    before = gae_ops.discounted_returns_cuda.launches
    got = gae_ops.discounted_returns_cuda(r, d, lv, gamma=0.99)
    want = gae_ops.discounted_returns_ref(r, d, lv, 0.99)
    torch.cuda.synchronize()
    assert gae_ops.discounted_returns_cuda.launches == before + 1
    assert torch.equal(got, want)


@pytest.mark.gpu
@pytest.mark.parametrize("unaligned", ["rewards", "dones"])
@pytest.mark.parametrize("T,B", [(64, 32), (125, 160), (129, 4096)])
def test_discounted_returns_kernel_takes_unaligned_inputs(cuda, T, B,
                                                          unaligned):
    """An input one element past an aligned start takes the scalar loads,
    bit for bit as the vector ones."""
    r, _, d, lv = _gae_inputs(T, B, "10%", cuda, seed=T + B)
    if unaligned == "rewards":
        r = torch.cat([torch.zeros(1, device=cuda), r.reshape(-1)])[1:]
        r = r.view(T, B)
        assert r.data_ptr() % 16
    else:
        d = torch.cat([torch.zeros(1, dtype=torch.bool, device=cuda),
                       d.reshape(-1)])[1:].view(T, B)
        assert d.data_ptr() % 4
    before = gae_ops.discounted_returns_cuda.launches
    got = gae_ops.discounted_returns_cuda(r, d, lv, gamma=0.99)
    want = gae_ops.discounted_returns_ref(r, d, lv, 0.99)
    torch.cuda.synchronize()
    assert gae_ops.discounted_returns_cuda.launches == before + 1
    assert torch.equal(got, want)


@pytest.mark.gpu
@pytest.mark.parametrize("T,B", [(0, 160), (5, 0), (0, 0)])
def test_discounted_returns_kernel_with_nothing_to_scan(cuda, T, B):
    r, _, d, lv = _gae_inputs(T, B, "none", cuda, seed=1)
    before = gae_ops.discounted_returns_cuda.launches
    got = gae_ops.discounted_returns_cuda(r, d, lv, gamma=0.99)
    assert got.shape == (T, B)
    assert gae_ops.discounted_returns_cuda.launches == before


@pytest.mark.gpu
@pytest.mark.parametrize("ends", ["none", "all", "mixed"])
@pytest.mark.parametrize("B", [1, 16, 31, 33, 4096, 4097])
def test_cheetah_step_kernel_at_tile_edges(cuda, B, ends):
    """Every leaf bit for bit against the plain version, one launch a
    call, with no, every or a third of the episodes ending."""
    state, a, rs, ro = env_inputs("cheetah", B, cuda)
    if ends != "mixed":
        state = state[:4] + (torch.full_like(
            state[4], HORIZON - 1 if ends == "all" else HORIZON - 2),)
    params = dict(max_episode_steps=HORIZON, reward_scale=0.5,
                  **PARAMS["cheetah"])
    before = env_ops.cheetah_step_cuda.launches
    got = env_ops.cheetah_step_cuda(state, a, rs, ro, **params)
    want = env_ref.cheetah_step_batch_ref(state, a, rs, ro, **params)
    torch.cuda.synchronize()
    assert env_ops.cheetah_step_cuda.launches == before + 1
    for g, w in zip(leaves(got), leaves(want)):
        assert g.dtype == w.dtype and np.array_equal(g, w)
    n_done = int(got[3].sum())
    assert n_done == {"none": 0, "all": B}.get(ends, n_done)


# pendulum's and cart-pole's warps and 256-thread blocks
ENV_EDGE_B = [1, 31, 32, 33, 255, 256, 257, 4097, 16384]


def _bits(x):
    """A float32 tensor's bits as int32, so NaNs compare by their bits."""
    return x.view(torch.int32) if x.dtype == torch.float32 else x


def _assert_same_bits(got, want):
    for g, w in zip((*got[0], *got[1:]), (*want[0], *want[1:])):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert torch.equal(_bits(g), _bits(w))


def _ends(name, state, ends):
    """``state`` with no, every or (``mixed``) a third of the rows at their
    last step; cart-pole's "none" keeps its carts and poles inside the fall
    limits."""
    if ends == "mixed":
        return state
    t = torch.full_like(state[-1], HORIZON - 1 if ends == "all"
                        else HORIZON - 2)
    state = state[:-1] + (t,)
    if name == "cartpole" and ends == "none":
        state = (state[0] * (2.3 / 2.5), state[1], state[2] * (0.16 / 0.25),
                 state[3], t)
    return state


@pytest.mark.gpu
@pytest.mark.parametrize("ends", ["none", "all", "mixed"])
@pytest.mark.parametrize("B", ENV_EDGE_B)
@pytest.mark.parametrize("name", ["pendulum", "cartpole"])
def test_pendulum_and_cartpole_steps_at_block_edges(cuda, name, B, ends):
    """Every leaf bit for bit against the plain version, one launch a
    call, with no, every or a third of the episodes ending."""
    state, a, rs, ro = env_inputs(name, B, cuda)
    state = _ends(name, state, ends)
    params = dict(max_episode_steps=HORIZON, reward_scale=0.5,
                  **PARAMS[name])
    wrapper = env_ops.STEP_BATCH_CUDA[name]
    before = wrapper.launches
    got = wrapper(state, a, rs, ro, **params)
    want = env_ref.STEP_BATCH_REF[name](state, a, rs, ro, **params)
    torch.cuda.synchronize()
    assert wrapper.launches == before + 1
    _assert_same_bits(got, want)
    n_done = int(got[3].sum())
    assert n_done == {"none": 0, "all": B}.get(ends, n_done)
    assert ends != "mixed" or n_done >= B // 3


def _sweep(cuda):
    """Float32 bit patterns: every 4,099th of the 2^32, and by hand +-0,
    subnormals, the trig's slow path past |x| = 105,615, the largest
    floats, +-inf and NaNs."""
    x = torch.arange(-(1 << 31), 1 << 31, 4099, device=cuda,
                     dtype=torch.int64).to(torch.int32).view(torch.float32)
    special = torch.tensor(
        [0.0, -0.0, 1e-45, -1e-45, 1.1754942e-38, -1.1754942e-38,
         1.1754944e-38, 105614.99, 105615.0, 105615.01, -105615.0, 1e10,
         -1e10, 3.4028235e38, -3.4028235e38, float("inf"), float("-inf"),
         float("nan")], device=cuda)
    return torch.cat([x, special])


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["pendulum", "cartpole"])
def test_env_step_kernels_over_a_trig_sweep(cuda, name):
    """The sweep as pendulum's next angle (thdot set to cancel the step's
    own increment, so the obs hold sincosf's cos and sin of each angle) and
    as cart-pole's angle: every leaf bit for bit against the plain
    version, whose ``torch.cos``/``torch.sin`` are CUDA's cosf and sinf."""
    x = _sweep(cuda)
    n = x.shape[0]
    z = torch.zeros(n, device=cuda)
    t = torch.zeros(n, dtype=torch.int32, device=cuda)
    if name == "pendulum":
        u = torch.full((n, 1), -0.0, device=cuda)
        y = (15.0 * torch.sin(x) + 3.0 * u[:, 0]) * 0.05
        state, a = (x, torch.where(y == 0, y, -y), t), u
        rs, ro = (z, z, t), torch.zeros(n, 3, device=cuda)
    else:
        state, a = (z, z, x, z, t), torch.zeros(n, 1, device=cuda)
        rs, ro = (z, z, z, z, t), torch.zeros(n, 4, device=cuda)
    params = dict(max_episode_steps=HORIZON, reward_scale=1.0,
                  **PARAMS[name])
    got = env_ops.STEP_BATCH_CUDA[name](state, a, rs, ro, **params)
    want = env_ref.STEP_BATCH_REF[name](state, a, rs, ro, **params)
    torch.cuda.synchronize()
    _assert_same_bits(got, want)
    if name == "pendulum":
        fin = torch.isfinite(x)
        assert torch.equal(_bits(want[0][0])[fin], _bits(x)[fin])


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["pendulum", "cartpole"])
def test_env_step_kernels_pass_nan_like_plain(cuda, name):
    """NaN in the actions and in every float leaf of the state and of the
    reset candidates, on rows that end and rows that do not: the kernel's
    outputs equal the plain version's bit for bit."""
    state, a, rs, ro = env_inputs(name, 1000, cuda)
    gen = torch.Generator(device=cuda).manual_seed(3)
    for leaf in (*state[:-1], a, *rs[:-1], ro):
        leaf.view(-1)[torch.randperm(leaf.numel(), generator=gen,
                                     device=cuda)[:60]] = float("nan")
    params = dict(max_episode_steps=HORIZON, reward_scale=1.0,
                  **PARAMS[name])
    got = env_ops.STEP_BATCH_CUDA[name](state, a, rs, ro, **params)
    want = env_ref.STEP_BATCH_REF[name](state, a, rs, ro, **params)
    torch.cuda.synchronize()
    _assert_same_bits(got, want)
    assert bool(torch.isnan(got[2]).any())


@pytest.mark.gpu
@pytest.mark.parametrize("B", [1, 33, 4097])
def test_cartpole_step_with_unaligned_reset_obs(cuda, B):
    """A contiguous reset obs that starts 4 bytes past a 16-byte boundary
    (the kernel then moves its rows a float at a time): bit for bit."""
    state, a, rs, ro = env_inputs("cartpole", B, cuda)
    ro = torch.cat([torch.zeros(1, device=cuda), ro.view(-1)])[1:].view(B, 4)
    assert ro.is_contiguous() and ro.data_ptr() % 16 == 4
    params = dict(max_episode_steps=HORIZON, reward_scale=1.0,
                  **PARAMS["cartpole"])
    got = env_ops.cartpole_step_cuda(state, a, rs, ro, **params)
    want = env_ref.cartpole_step_batch_ref(state, a, rs, ro, **params)
    torch.cuda.synchronize()
    _assert_same_bits(got, want)
    assert int(got[3].sum()) >= B // 3


def _capture(fn):
    """``fn`` run once on a side stream (build, load), then captured in a
    CUDA graph; returns the graph and the captured call's outputs."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = fn()
    return graph, out


@pytest.mark.gpu
def test_gae_kernel_replays_from_a_cuda_graph(cuda):
    """One call captured in a CUDA graph, replayed on fresh inputs copied
    into the captured ones, equals an eager call on the same inputs."""
    T, B = 129, 4097
    r, v, d, lv = (torch.zeros_like(x) for x in
                   _gae_inputs(T, B, "none", cuda, seed=0))
    graph, (adv, ret) = _capture(
        lambda: gae_ops.gae_cuda(r, v, d, lv, gamma=0.99, lam=0.95))
    for seed, dones in enumerate(("10%", "t=0", "all")):
        for x, y in zip((r, v, d, lv), _gae_inputs(T, B, dones, cuda, seed)):
            x.copy_(y)
        graph.replay()
        want = gae_ops.gae_cuda(r, v, d, lv, gamma=0.99, lam=0.95)
        torch.cuda.synchronize()
        assert torch.equal(adv, want[0]) and torch.equal(ret, want[1])


@pytest.mark.gpu
def test_cheetah_step_kernel_replays_from_a_cuda_graph(cuda):
    """As for gae: a captured call replayed on fresh states equals an
    eager call, the reset select included."""
    B = 4097
    fresh = [env_inputs("cheetah", B + k, cuda) for k in range(3)]
    args = [tuple(x[:B].clone() for x in leaf) if isinstance(leaf, tuple)
            else leaf[:B].clone() for leaf in fresh[0]]
    params = dict(max_episode_steps=HORIZON, reward_scale=1.0,
                  **PARAMS["cheetah"])
    graph, out = _capture(
        lambda: env_ops.cheetah_step_cuda(*args, **params))
    for inputs in fresh:
        for dst, src in zip(args, inputs):
            for x, y in (zip(dst, src) if isinstance(dst, tuple)
                         else [(dst, src)]):
                x.copy_(y[:B])
        graph.replay()
        want = env_ops.cheetah_step_cuda(*args, **params)
        torch.cuda.synchronize()
        assert int(want[3].sum()) > 0
        for g, w in zip(leaves(out), leaves(want)):
            assert np.array_equal(g, w)


@pytest.mark.gpu
def test_new_kernels_reject_what_they_cannot_take(cuda):
    r = torch.zeros(4, 3, device=cuda)
    with pytest.raises(ValueError, match="dones"):
        gae_ops.discounted_returns_cuda(r, torch.zeros(4, 3, device=cuda),
                                        torch.zeros(3, device=cuda),
                                        gamma=0.9)
    state, a, rs, ro = env_inputs("cartpole", 8, cuda)
    with pytest.raises(ValueError, match="th must be"):
        env_ops.cartpole_step_cuda(
            (state[0], state[1], state[2].double(), state[3], state[4]), a,
            rs, ro, max_episode_steps=HORIZON, reward_scale=1.0,
            force_max=10.0)


def _leaf(rng, shape, dtype, device):
    if dtype == torch.bool:
        x = rng.random(shape) < 0.5
    elif dtype == torch.int32:
        x = rng.integers(-9, 9, shape).astype(np.int32)
    else:
        x = rng.standard_normal(shape).astype(np.float32)
    return torch.from_numpy(x).to(device=device, dtype=dtype)


# 56-byte rows (16-byte aligned only at even slots), 4-, 16-, 3-, 8- and
# 10-byte rows, and a leaf of zero-width rows
LEAVES = [((14,), torch.float32), ((), torch.float32), ((4,), torch.float32),
          ((3,), torch.bool), ((2,), torch.int32), ((5,), torch.bfloat16),
          ((0,), torch.float32)]


def _ring(rng, rows, device):
    return {f"l{i}": _leaf(rng, (rows,) + s, d, device)
            for i, (s, d) in enumerate(LEAVES)}


@pytest.mark.gpu
@pytest.mark.parametrize("cap,n,start", [
    (17, 5, 0), (17, 5, 15), (12, 12, 7), (8, 11, 3), (1, 1, 0), (1, 3, 0),
    (1 << 20, 20000, (1 << 20) - 7000), (4096, 20000, 100),
    # odd heads: source and destination differ mod 16 (the 56-byte rows)
    # and mod 4 (the bool and bfloat16 rows), over many blocks
    (1 << 20, 20000, (1 << 20) - 7001), (4099, 3000, 1001)])
def test_ring_insert_kernel_matches_plain(cuda, cap, n, start):
    rng = np.random.default_rng(cap + n)
    storage, batch = _ring(rng, cap, cuda), _ring(rng, n, cuda)
    want = ring_ops.ring_insert_ref({k: v.clone() for k, v in storage.items()},
                                    batch, start)
    before = ring_ops.ring_insert_cuda.launches
    got = ring_ops.ring_insert(storage, batch, start, impl="cuda")
    torch.cuda.synchronize()
    assert got is storage
    assert ring_ops.ring_insert_cuda.launches == before + 1
    for k in want:
        assert torch.equal(got[k], want[k]), k


@pytest.mark.gpu
@pytest.mark.parametrize("cap,B", [(17, 6), (1, 1), (64, 64), (1 << 20, 256)])
def test_ring_gather_kernel_matches_plain(cuda, cap, B):
    rng = np.random.default_rng(cap * 7 + B)
    storage = _ring(rng, cap, cuda)
    idx = rng.integers(0, cap, B).astype(np.int32)
    idx[:2] = [cap + 5, -1][:B]                  # clamped / from the end
    idx = torch.from_numpy(idx).to(cuda)
    before = ring_ops.ring_gather_cuda.launches
    got = ring_ops.ring_gather(storage, idx, impl="cuda")
    want = ring_ops.ring_gather_ref(storage, idx)
    torch.cuda.synchronize()
    assert ring_ops.ring_gather_cuda.launches == before + 1
    for k in want:
        assert got[k].dtype == want[k].dtype
        assert got[k].shape == want[k].shape and torch.equal(got[k], want[k])


@pytest.mark.gpu
def test_ring_ops_with_nothing_to_copy_launch_nothing(cuda):
    rng = np.random.default_rng(2)
    storage = _ring(rng, 64, cuda)
    empty = {"z": torch.zeros(64, 0, device=cuda)}
    before = (ring_ops.ring_insert_cuda.launches,
              ring_ops.ring_gather_cuda.launches)
    ring_ops.ring_insert(storage, _ring(rng, 0, cuda), 5, impl="cuda")
    ring_ops.ring_insert(empty, {"z": torch.ones(3, 0, device=cuda)}, 5,
                         impl="cuda")
    got = ring_ops.ring_gather(storage, torch.zeros(0, dtype=torch.int32,
                                                    device=cuda), impl="cuda")
    assert all(v.shape[0] == 0 for v in got.values())
    got = ring_ops.ring_gather(empty, torch.ones(4, dtype=torch.int32,
                                                 device=cuda), impl="cuda")
    assert got["z"].shape == (4, 0)
    torch.cuda.synchronize()
    assert (ring_ops.ring_insert_cuda.launches,
            ring_ops.ring_gather_cuda.launches) == before


@pytest.mark.gpu
def test_ring_insert_then_gather_replay_from_a_cuda_graph(cuda):
    """One insert and one gather captured in a CUDA graph, replayed on
    fresh rows and indices copied into the captured inputs, equal the
    plain versions run eagerly on the same inputs."""
    rng = np.random.default_rng(11)
    cap, n, B, start = 4099, 3000, 256, 2001       # wraps, odd head
    storage, batch = _ring(rng, cap, cuda), _ring(rng, n, cuda)
    idx = torch.zeros(B, dtype=torch.int32, device=cuda)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):                # build, load, check once
        ring_ops.ring_insert(storage, batch, start, impl="cuda")
        ring_ops.ring_gather(storage, idx, impl="cuda")
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        ring_ops.ring_insert(storage, batch, start, impl="cuda")
        out = ring_ops.ring_gather(storage, idx, impl="cuda")
    for _ in range(2):
        for k, v in _ring(rng, n, cuda).items():
            batch[k].copy_(v)
        idx.copy_(torch.from_numpy(
            rng.integers(-cap, cap + 9, B).astype(np.int32)))
        want = ring_ops.ring_insert_ref(
            {k: v.clone() for k, v in storage.items()}, batch, start)
        want_out = ring_ops.ring_gather_ref(want, idx)
        graph.replay()
        torch.cuda.synchronize()
        for k in want:
            assert torch.equal(storage[k], want[k]), k
            assert torch.equal(out[k], want_out[k]), k


def _tree(cap, seed, device):
    rng = np.random.default_rng(seed)
    x = rng.random(cap).astype(np.float32)
    x[rng.random(cap) < 0.3] = 0.0               # zero-mass leaves
    return tree_ref.sumtree_build(torch.from_numpy(x).to(device)), rng


@pytest.mark.gpu
@pytest.mark.parametrize("cap", [1, 2, 1024, 1 << 20])
def test_sumtree_find_kernel_matches_plain(cuda, cap):
    tree, rng = _tree(cap, cap, cuda)
    total = float(tree.total)
    B = 256
    m = ((np.arange(B) + rng.random(B)) / B * total).astype(np.float32)
    m[:2] = [0.0, total]
    masses = torch.from_numpy(m).to(cuda)
    before = tree_ops.sumtree_find_cuda.launches
    got = tree_ops.sumtree_find_batch(tree, masses, impl="cuda")
    want = tree_ops.sumtree_find_batch_ref(tree, masses)
    torch.cuda.synchronize()
    assert tree_ops.sumtree_find_cuda.launches == before + 1
    assert got.dtype == torch.int32 and torch.equal(got, want)


# the redesigned find's edges: trees with no level to read (cap 1) up to
# 2^20 leaves, batches around a block (8 masses of a warp each, 256 of a
# thread each) and around the switch from a warp a mass to a thread a mass
# past 4,096, and masses at the descent's ties and extremes (chip_smoke.py
# checks the same)
FIND_EDGE_CAP = [1, 2, 32, 1024, 1 << 20]
FIND_EDGE_B = [1, 8, 9, 31, 32, 33, 256, 257, 4096, 4097, 20000]


def _find_edge_inputs(cap, B, device, seed):
    """A tree of integer masses (every sum exact in float32, so a mass
    equal to a prefix sum ties with the stored nodes), with zero-mass
    leaves, a run of them and a zero-mass right subtree; and B masses: 0,
    the root, above the root, a negative one, NaN, the stored prefix sums
    at the leaves around every power of two (so at every chunk of levels
    some descent turns) and at random leaves, then stratified ones."""
    rng = np.random.default_rng(seed)
    x = rng.integers(1, 8, cap).astype(np.float32)
    x[rng.random(cap) < 0.3] = 0.0
    x[cap // 8: cap // 8 + cap // 16] = 0.0
    x[3 * cap // 4:] = 0.0
    prefix = np.concatenate([[0.0], np.cumsum(x, dtype=np.float64)])
    total = prefix[-1]
    turns = sorted({i for j in range(cap.bit_length())
                    for i in (2 ** j - 1, 2 ** j, 2 ** j + 1) if i <= cap})
    special = np.array([0.0, total, total + 1.0, -1.0, np.nan]
                       + [prefix[i] for i in turns]
                       + list(prefix[rng.integers(0, cap + 1, 8)]))
    strat = (np.arange(B) + rng.random(B)) / max(B, 1) * total
    m = np.concatenate([np.roll(special, B), strat])[:B].astype(np.float32)
    tree = tree_ref.sumtree_build(torch.from_numpy(x).to(device))
    return tree, torch.from_numpy(m).to(device)


@pytest.mark.gpu
@pytest.mark.parametrize("B", FIND_EDGE_B)
@pytest.mark.parametrize("cap", FIND_EDGE_CAP)
def test_sumtree_find_kernel_at_its_edges(cuda, cap, B):
    """Bit for bit against the plain version, one launch a call."""
    tree, masses = _find_edge_inputs(cap, B, cuda, seed=cap + B)
    before = tree_ops.sumtree_find_cuda.launches
    got = tree_ops.sumtree_find_cuda(tree, masses)
    want = tree_ops.sumtree_find_batch_ref(tree, masses)
    torch.cuda.synchronize()
    assert tree_ops.sumtree_find_cuda.launches == before + 1
    assert got.dtype == torch.int32 and torch.equal(got, want)


@pytest.mark.gpu
def test_sumtree_find_kernel_with_no_mass_launches_nothing(cuda):
    tree, _ = _tree(1024, 3, cuda)
    before = tree_ops.sumtree_find_cuda.launches
    got = tree_ops.sumtree_find_cuda(tree, torch.ones(0, device=cuda))
    assert got.shape == (0,) and got.dtype == torch.int32
    assert tree_ops.sumtree_find_cuda.launches == before


@pytest.mark.gpu
@pytest.mark.parametrize("cap,B,consecutive", [
    (1, 3, False), (2, 5, False), (1024, 256, False), (1 << 20, 256, False),
    (1 << 20, 20000, True), (4096, 20000, True)])
def test_sumtree_update_kernel_matches_plain(cuda, cap, B, consecutive):
    tree, rng = _tree(cap, cap + B, cuda)
    if consecutive:                              # an add: N > cap wraps
        idx = (np.arange(B) + cap // 3) % cap
    else:
        idx = rng.integers(0, cap, B)
        idx[-B // 4:] = idx[0]                   # duplicates: last one wins
    idx = torch.from_numpy(idx.astype(np.int32)).to(cuda)
    vals = torch.from_numpy(rng.random(B).astype(np.float32)).to(cuda)
    want = tree_ref.SumTree.of(tree.flat.clone())
    tree_ops.sumtree_update_ref(want, idx, vals)
    before = tree_ops.sumtree_update_cuda.launches
    got = tree_ops.sumtree_update(tree, idx, vals, impl="cuda")
    torch.cuda.synchronize()
    assert tree_ops.sumtree_update_cuda.launches == before + 1
    assert got.flat is tree.flat and torch.equal(got.flat, want.flat)
    assert bool((tree.winner == -1).all())       # scratch left reset


@pytest.mark.gpu
@pytest.mark.parametrize("cap", [1, 1024])
def test_sumtree_update_kernel_wraps_and_drops_like_plain(cuda, cap):
    tree, rng = _tree(cap, cap + 1, cuda)
    idx = torch.tensor([-1, cap - 1, cap, -cap - 1, -cap, 0, 2 * cap,
                        -cap // 2, cap // 2, 1 << 30, -(1 << 30)],
                       dtype=torch.int32, device=cuda)
    vals = torch.from_numpy(rng.random(idx.shape[0]).astype(np.float32)
                            ).to(cuda)
    want = tree_ref.SumTree.of(tree.flat.clone())
    tree_ops.sumtree_update_ref(want, idx, vals)
    tree_ops.sumtree_update(tree, idx, vals, impl="cuda")
    torch.cuda.synchronize()
    assert torch.equal(tree.flat, want.flat)
    assert bool((tree.winner == -1).all())


@pytest.mark.gpu
def test_replay_and_tree_ref_mode_launch_nothing(cuda):
    storage = {"x": torch.zeros(8, 2, device=cuda)}
    tree, _ = _tree(8, 0, cuda)
    idx = torch.tensor([1, 2], dtype=torch.int32, device=cuda)
    before = {w: w.launches for w in (
        ring_ops.ring_insert_cuda, ring_ops.ring_gather_cuda,
        tree_ops.sumtree_find_cuda, tree_ops.sumtree_update_cuda)}
    ring_ops.ring_insert(storage, {"x": torch.ones(3, 2, device=cuda)}, 6,
                         impl="ref")
    ring_ops.ring_gather(storage, idx, impl="ref")
    tree_ops.sumtree_find_batch(tree, torch.ones(2, device=cuda), impl="ref")
    tree_ops.sumtree_update(tree, idx, torch.ones(2, device=cuda),
                            impl="ref")
    torch.cuda.synchronize()
    assert all(w.launches == n for w, n in before.items())
    assert storage["x"][[6, 7, 0]].eq(1.0).all()


@pytest.mark.gpu
def test_replay_kernels_reject_what_they_cannot_take(cuda):
    storage = {"x": torch.zeros(8, 3, device=cuda),
               "y": torch.zeros(8, device=cuda)}
    with pytest.raises(ValueError, match="batch"):
        ring_ops.ring_insert_cuda(storage, {"x": torch.ones(2, 4, device=cuda),
                                            "y": torch.ones(2, device=cuda)},
                                  0)
    with pytest.raises(ValueError, match="batch"):   # one N for all leaves
        ring_ops.ring_insert_cuda(storage, {"x": torch.ones(2, 3, device=cuda),
                                            "y": torch.ones(3, device=cuda)},
                                  0)
    with pytest.raises(ValueError, match="idx"):
        ring_ops.ring_gather_cuda(storage, torch.zeros(2, dtype=torch.int64,
                                                       device=cuda))
    tree, _ = _tree(8, 0, cuda)
    with pytest.raises(ValueError, match="masses"):
        tree_ops.sumtree_find_cuda(tree, torch.ones(2, 1, device=cuda))
    with pytest.raises(ValueError, match="values"):
        tree_ops.sumtree_update_cuda(
            tree, torch.zeros(2, dtype=torch.int32, device=cuda),
            torch.ones(3, device=cuda))


# ------------------------------------------------------------ LM kernels
def _randn(rng, shape, device, dtype=torch.float32):
    return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)
                            ).to(device=device, dtype=dtype)


def _scan_inputs(rng, B, S, Di, N, device, h0_scale=0.0):
    softplus = lambda x: np.log1p(np.exp(x))  # noqa: E731
    f = lambda x: torch.from_numpy(x.astype(np.float32)).to(device)  # noqa
    dt = f(softplus(rng.standard_normal((B, S, Di))) * 0.1)
    A = f(-np.exp(rng.standard_normal((Di, N)) * 0.2))
    b, c, x = (f(rng.standard_normal(s)) for s in ((B, S, N), (B, S, N),
                                                   (B, S, Di)))
    h0 = f(rng.standard_normal((B, Di, N)) * h0_scale)
    return dt, A, b, c, x, h0


@pytest.mark.gpu
@pytest.mark.parametrize("B,S,Di,N,h0_scale", [
    (4, 144, 3200, 16, 0.0),       # hymba's prefill
    (3, 37, 100, 5, 0.0),          # ragged Di, S and N
    (1, 1, 1, 1, 1.0),
    (2, 300, 256, 16, 1.0),        # nonzero h0, several staged chunks
    (1, 4224, 256, 16, 0.5),       # the long request's S
])
def test_selective_scan_kernel_matches_plain(cuda, B, S, Di, N, h0_scale):
    rng = np.random.default_rng(B * S + Di + N)
    args = _scan_inputs(rng, B, S, Di, N, cuda, h0_scale)
    before = scan_ops.selective_scan_cuda.launches
    y, h = scan_ops.selective_scan(*args, impl="cuda")
    yr, hr = scan_ops.selective_scan_ref(*args)
    torch.cuda.synchronize()
    assert scan_ops.selective_scan_cuda.launches == before + 1
    for got, want in ((y, yr), (h, hr)):
        assert got.shape == want.shape and got.dtype == torch.float32
        torch.testing.assert_close(got, want, atol=2e-4, rtol=2e-4)


def _sms(device):
    return torch.cuda.get_device_properties(device).multi_processor_count


@pytest.mark.gpu
@pytest.mark.parametrize("B,S,Di,N,h0_scale,chunked", [
    (1, 4224, 3200, 16, 0.0, True),    # hymba's long request
    (4, 16, 8192, 16, 0.0, False),     # falcon-mamba-7b's prefill
    (1, scan_ops.CHUNK, 64, 16, 1.0, False),       # one chunk
    (1, scan_ops.CHUNK + 1, 64, 16, 1.0, True),    # two, one step over
    (2, 3 * scan_ops.CHUNK - 1, 64, 16, 1.0, True),
    (1, 1000, 40, 1, 1.0, True),
    (2, 700, 70, 5, 1.0, True),
    (3, 0, 64, 16, 1.0, False),        # no step: h_final is h0
])
def test_selective_scan_kernel_chunks_and_edges(cuda, B, S, Di, N, h0_scale,
                                                chunked):
    """The one-walk and chunked paths against the plain version: at the
    serve runs' long shapes, at S just below and above one chunk, at
    N 1, 5 and 16 with a nonzero h0, and with no step at all."""
    chunk = scan_ops.plan_chunk(B, S, Di, _sms(cuda))
    assert (scan_ops.n_chunks(S, chunk) > 1) == chunked, chunk
    rng = np.random.default_rng(B * S + Di + N)
    args = _scan_inputs(rng, B, S, Di, N, cuda, h0_scale)
    before = scan_ops.selective_scan_cuda.launches
    y, h = scan_ops.selective_scan(*args, impl="cuda")
    yr, hr = scan_ops.selective_scan_ref(*args)
    torch.cuda.synchronize()
    assert scan_ops.selective_scan_cuda.launches == before + 1
    for got, want in ((y, yr), (h, hr)):
        assert got.shape == want.shape and got.dtype == torch.float32
        torch.testing.assert_close(got, want, atol=2e-4, rtol=2e-4)
    if S == 0:
        assert torch.equal(h, args[-1])


@pytest.mark.gpu
@pytest.mark.parametrize("cap,B", [
    (1 << 20, 20000),        # the add: marked first, two level groups
    (1 << 20, 1000), (1024, 5000), (2048, 1000)])   # marked; one group
def test_sumtree_update_kernel_duplicates_across_blocks(cuda, cap, B):
    """Consecutive indices that wrap past the end, with duplicates
    thousands of positions apart (in different blocks of the marking launch
    and, at 2^20, in different subtrees): the last write wins and the
    parents match the plain version bit for bit."""
    tree, rng = _tree(cap, 77, cuda)
    idx = (np.arange(B) + cap - 5000) % cap          # wraps past the end
    far = rng.choice(B, 600, replace=False)
    idx[far[:300]] = idx[far[300:]]                  # twins far apart
    idx[B - 1] = idx[0]                              # first and last block
    idx[-256:-200] = -7                              # counts from the end
    idx[5:9] = [cap, -cap - 1, 1 << 30, -(1 << 30)]  # dropped
    idx = torch.from_numpy(idx.astype(np.int32)).to(cuda)
    vals = torch.from_numpy(rng.random(B).astype(np.float32)).to(cuda)
    want = tree_ref.SumTree.of(tree.flat.clone())
    tree_ops.sumtree_update_ref(want, idx, vals)
    tree_ops.sumtree_update(tree, idx, vals, impl="cuda")
    torch.cuda.synchronize()
    assert torch.equal(tree.flat, want.flat)
    assert tree.winner.shape == (tree_ops.update_scratch_size(cap),)
    assert bool((tree.winner == -1).all())


@pytest.mark.gpu
@pytest.mark.parametrize("cap,B", [
    (1 << 23, 256),          # the one-block walk, 23 levels
    (1 << 20, 257)])         # one more: marked, then a block per subtree
def test_sumtree_update_kernel_at_the_one_block_limits(cuda, cap, B):
    tree, rng = _tree(cap, B, cuda)
    idx = rng.integers(-cap, cap, B)
    idx[-B // 4:] = idx[1]                       # duplicates: last one wins
    idx = torch.from_numpy(idx.astype(np.int32)).to(cuda)
    vals = torch.from_numpy(rng.random(B).astype(np.float32)).to(cuda)
    want = tree_ref.SumTree.of(tree.flat.clone())
    tree_ops.sumtree_update_ref(want, idx, vals)
    tree_ops.sumtree_update(tree, idx, vals, impl="cuda")
    torch.cuda.synchronize()
    assert torch.equal(tree.flat, want.flat)
    assert bool((tree.winner == -1).all())


@pytest.mark.gpu
@pytest.mark.parametrize("B", [256, 20000])
def test_sumtree_update_replays_from_a_cuda_graph(cuda, B):
    """One update captured in a CUDA graph, replayed on fresh indices and
    values copied into the captured inputs, equals the plain version run
    eagerly on the same tree and inputs, and leaves the whole scratch at -1:
    at B 256 the one-block walk, at B 20,000 (an add: consecutive indices
    that wrap past the end, with duplicates) the marking and subtree
    kernels with their flags and done counter."""
    cap = 1 << 20
    tree, rng = _tree(cap, 5, cuda)
    idx = torch.zeros(B, dtype=torch.int32, device=cuda)
    vals = torch.zeros(B, device=cuda)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):                # build, load, check once
        tree_ops.sumtree_update(tree, idx, vals, impl="cuda")
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        tree_ops.sumtree_update(tree, idx, vals, impl="cuda")
    for r in range(3):
        if B == 256:
            fresh = rng.integers(-cap, cap + 9, B)
        else:
            fresh = (np.arange(B) + cap - 7000 + 3 * r) % cap
            fresh[rng.choice(B, 500, replace=False)] = fresh[
                rng.choice(B, 500)]                  # twins anywhere
        fresh[-B // 4:] = fresh[0]               # duplicates: last one wins
        idx.copy_(torch.from_numpy(fresh.astype(np.int32)))
        vals.copy_(torch.from_numpy(rng.random(B).astype(np.float32)))
        want = tree_ref.SumTree.of(tree.flat.clone())
        tree_ops.sumtree_update_ref(want, idx, vals)
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(tree.flat, want.flat)
        assert bool((tree.winner == -1).all())


ATTN_TOL = {torch.float32: 2e-5, torch.bfloat16: 3e-2}
# chip_smoke.py's second attention bound, which scales with the output:
# each row's max |error| over the RMS of that row of the float32 result on
# the same (upcast) inputs. Long rows average many keys, so |o| falls far
# under ATTN_TOL's absolute bound there
ATTN_REL_TOL = {torch.float32: 1e-4, torch.bfloat16: 5e-2}


def _assert_row_scaled_close(got, exact, dtype):
    w = exact.double()
    rel = (got.double() - w).abs().amax(-1) / w.square().mean(-1).sqrt()
    assert float(rel.max()) <= ATTN_REL_TOL[dtype], float(rel.max())


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,S,K,G,hd,causal,window", [
    (4, 144, 5, 5, 64, True, 2048),      # hymba's prefill
    (1, 300, 2, 2, 32, True, 100),       # window inside the sequence
    (1, 200, 1, 4, 128, True, 0),        # causal, no window
    (2, 129, 2, 1, 64, False, 0),        # non-causal
    (1, 37, 2, 3, 64, False, 9),         # window without causality
])
def test_flash_attention_kernel_matches_plain(cuda, dtype, B, S, K, G, hd,
                                              causal, window):
    rng = np.random.default_rng(S * hd + K)
    q = _randn(rng, (B, S, K, G, hd), cuda, dtype)
    k = _randn(rng, (B, S, K, hd), cuda, dtype)
    v = _randn(rng, (B, S, K, hd), cuda, dtype)
    before = fa_ops.flash_attention_cuda.launches
    got = fa_ops.flash_attention(q, k, v, causal=causal, window=window,
                                 impl="cuda")
    want = fa_ops.flash_attention(q, k, v, causal=causal, window=window,
                                  impl="ref")
    torch.cuda.synchronize()
    assert fa_ops.flash_attention_cuda.launches == before + 1
    assert got.shape == want.shape and got.dtype == dtype
    torch.testing.assert_close(got.float(), want.float(),
                               atol=ATTN_TOL[dtype], rtol=0)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,K,G,Sc,hd,p_valid", [
    (4, 5, 5, 176, 64, 0.6),             # hymba's decode, random slots
    (1, 5, 5, 2048, 64, 1.0),            # a full ring
    (3, 1, 5, 256, 32, 0.5),
    (2, 2, 2, 384, 128, 0.7),
    (1, 2, 1, 1, 64, 1.0),
])
def test_decode_attention_kernel_matches_plain(cuda, dtype, B, K, G, Sc, hd,
                                               p_valid):
    rng = np.random.default_rng(Sc * hd + G)
    q = _randn(rng, (B, K, G, hd), cuda, dtype)
    kc = _randn(rng, (B, Sc, K, hd), cuda, dtype)
    vc = _randn(rng, (B, Sc, K, hd), cuda, dtype)
    valid = rng.random(Sc) < p_valid
    valid[0] = True
    valid = torch.from_numpy(valid).to(cuda)
    before = dec_ops.decode_attention_cuda.launches
    got = dec_ops.decode_attention(q, kc, vc, valid, impl="cuda")
    want = dec_ops.decode_attention(q, kc, vc, valid, impl="ref")
    torch.cuda.synchronize()
    assert dec_ops.decode_attention_cuda.launches == before + 1
    assert got.shape == want.shape and got.dtype == dtype
    torch.testing.assert_close(got.float(), want.float(),
                               atol=ATTN_TOL[dtype], rtol=0)


@pytest.mark.gpu
def test_decode_attention_kernel_reads_cache_views(cuda):
    """The kernel reads one layer's slice of the (L,B,C,K,hd) cache in
    place, and a slot-less row (no valid slot) gives 0."""
    rng = np.random.default_rng(3)
    cache = _randn(rng, (3, 2, 40, 2, 32), cuda)
    q = _randn(rng, (2, 2, 3, 32), cuda)
    valid = torch.from_numpy(rng.random(40) < 0.5).to(cuda)
    got = dec_ops.decode_attention_cuda(q, cache[1], cache[2], valid)
    want = dec_ops.decode_attention(q, cache[1], cache[2], valid, impl="ref")
    torch.testing.assert_close(got, want, atol=2e-5, rtol=0)
    none = dec_ops.decode_attention_cuda(q, cache[1], cache[2],
                                         torch.zeros_like(valid))
    assert torch.equal(none, torch.zeros_like(none))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,S,K,G,hd,causal,window", [
    (1, 1000, 2, 3, 64, True, 0),        # S not a multiple of the tiles
    (1, 4224, 5, 5, 64, True, 2048),     # the long request
    (1, 1000, 1, 1, 128, True, 90),      # window edge inside a tile, G 1
    (2, 1000, 2, 2, 32, True, 300),
])
def test_flash_attention_kernel_at_ragged_lengths(cuda, dtype, B, S, K, G,
                                                  hd, causal, window):
    rng = np.random.default_rng(S + hd + window)
    q = _randn(rng, (B, S, K, G, hd), cuda, dtype)
    k = _randn(rng, (B, S, K, hd), cuda, dtype)
    v = _randn(rng, (B, S, K, hd), cuda, dtype)
    got = fa_ops.flash_attention_cuda(q, k, v, causal=causal, window=window)
    want = fa_ops.flash_attention(q, k, v, causal=causal, window=window,
                                  impl="ref")
    exact = fa_ops.flash_attention(q.float(), k.float(), v.float(),
                                   causal=causal, window=window, impl="ref")
    torch.cuda.synchronize()
    assert got.shape == want.shape and got.dtype == dtype
    torch.testing.assert_close(got.float(), want.float(),
                               atol=ATTN_TOL[dtype], rtol=0)
    _assert_row_scaled_close(got, exact, dtype)


def _decode_inputs(rng, B, K, G, Sc, hd, device, dtype, slots=None):
    q = _randn(rng, (B, K, G, hd), device, dtype)
    kc = _randn(rng, (B, Sc, K, hd), device, dtype)
    vc = _randn(rng, (B, Sc, K, hd), device, dtype)
    if slots is None:
        valid = rng.random(Sc) < 0.9
        valid[0] = True
    else:
        valid = np.zeros(Sc, dtype=bool)
        valid[list(slots)] = True
    return q, kc, vc, torch.from_numpy(valid).to(device)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,K,G,Sc,hd,slots", [
    (2, 5, 5, 1, 64, None),              # one slot
    (1, 5, 5, 2048, 64, (0, 2047)),      # whole chunks without a valid slot
    (1, 2, 5, 70000, 64, None),          # past the old shared-memory limit
])
def test_decode_attention_kernel_edges(cuda, dtype, B, K, G, Sc, hd, slots):
    rng = np.random.default_rng(Sc + G)
    q, kc, vc, valid = _decode_inputs(rng, B, K, G, Sc, hd, cuda, dtype,
                                      slots)
    before = dec_ops.decode_attention_cuda.launches
    got = dec_ops.decode_attention_cuda(q, kc, vc, valid)
    want = dec_ops.decode_attention(q, kc, vc, valid, impl="ref")
    exact = dec_ops.decode_attention(q.float(), kc.float(), vc.float(),
                                     valid, impl="ref")
    torch.cuda.synchronize()
    assert dec_ops.decode_attention_cuda.launches == before + 1
    torch.testing.assert_close(got.float(), want.float(),
                               atol=ATTN_TOL[dtype], rtol=0)
    _assert_row_scaled_close(got, exact, dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kernel,B,S,K,G,hd", [
    ("flash", 4, 144, 5, 5, 64),         # hymba's prefill, window 2,048
    ("decode", 4, 176, 5, 5, 64),        # hymba's decode
    ("decode", 1, 2048, 5, 5, 64),       # the long request's full ring
])
def test_attention_kernel_error_scales_with_output(cuda, dtype, kernel, B, S,
                                                   K, G, hd):
    """At the serve runs' shapes each row's error stays a small share of
    that row's RMS, which a wrong kernel (a key tile dropped, zeros) cannot
    meet where |o| is below ATTN_TOL."""
    rng = np.random.default_rng(S + B)
    if kernel == "flash":
        q = _randn(rng, (B, S, K, G, hd), cuda, dtype)
        k = _randn(rng, (B, S, K, hd), cuda, dtype)
        v = _randn(rng, (B, S, K, hd), cuda, dtype)
        got = fa_ops.flash_attention_cuda(q, k, v, causal=True, window=2048)
        exact = fa_ops.flash_attention(q.float(), k.float(), v.float(),
                                       causal=True, window=2048, impl="ref")
    else:
        q, kc, vc, valid = _decode_inputs(rng, B, K, G, S, hd, cuda, dtype)
        got = dec_ops.decode_attention_cuda(q, kc, vc, valid)
        exact = dec_ops.decode_attention(q.float(), kc.float(), vc.float(),
                                         valid, impl="ref")
    torch.cuda.synchronize()
    _assert_row_scaled_close(got, exact, dtype)


@pytest.mark.gpu
def test_decode_attention_kernel_in_a_cuda_graph(cuda):
    """Captured in a CUDA graph and replayed, the two launches give what
    the eager call gives, on new cache contents too."""
    rng = np.random.default_rng(11)
    q, kc, vc, valid = _decode_inputs(rng, 4, 5, 5, 176, 64, cuda,
                                      torch.bfloat16)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        dec_ops.decode_attention_cuda(q, kc, vc, valid)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        replayed = dec_ops.decode_attention_cuda(q, kc, vc, valid)
    for _ in range(2):
        graph.replay()
        eager = dec_ops.decode_attention_cuda(q, kc, vc, valid)
        torch.cuda.synchronize()
        assert torch.equal(replayed, eager)
        kc.copy_(_randn(rng, tuple(kc.shape), cuda, torch.bfloat16))


@pytest.mark.gpu
def test_attention_kernels_reject_unaligned_layouts(cuda):
    """The bf16 flash kernel's TMA maps and the decode kernel's 16-byte
    copies need 16-byte aligned rows: anything else raises ValueError."""
    buf = torch.zeros(1 + 2 * 8 * 2 * 32, dtype=torch.bfloat16, device=cuda)
    kv = buf[1:].view(2, 8, 2, 32)              # 2-byte offset
    q = torch.zeros(2, 8, 2, 1, 32, dtype=torch.bfloat16, device=cuda)
    with pytest.raises(ValueError, match="16-byte"):
        fa_ops.flash_attention_cuda(q, kv, kv)
    cache = buf[1:].view(2, 8, 2, 32)
    with pytest.raises(ValueError, match="16-byte"):
        dec_ops.decode_attention_cuda(
            torch.zeros(2, 2, 1, 32, dtype=torch.bfloat16, device=cuda),
            cache, cache, torch.ones(8, dtype=torch.bool, device=cuda))


@pytest.mark.gpu
def test_lm_kernels_reject_what_they_cannot_take(cuda):
    q = torch.zeros(1, 8, 1, 1, 48, device=cuda)
    kv = torch.zeros(1, 8, 1, 48, device=cuda)
    with pytest.raises(ValueError, match="head_dim"):
        fa_ops.flash_attention_cuda(q, kv, kv)
    q64, kv64 = q.new_zeros(1, 8, 1, 1, 64), kv.new_zeros(1, 8, 1, 64)
    with pytest.raises(ValueError, match="bfloat16"):
        fa_ops.flash_attention_cuda(q64.double(), kv64.double(),
                                    kv64.double())
    with pytest.raises(ValueError, match="valid"):
        dec_ops.decode_attention_cuda(
            torch.zeros(1, 1, 1, 64, device=cuda),
            torch.zeros(1, 8, 1, 64, device=cuda),
            torch.zeros(1, 8, 1, 64, device=cuda),
            torch.ones(7, dtype=torch.bool, device=cuda))
    args = _scan_inputs(np.random.default_rng(0), 1, 4, 8, 17, cuda)
    with pytest.raises(ValueError, match="state size"):
        scan_ops.selective_scan_cuda(*args)


@pytest.mark.gpu
@pytest.mark.parametrize("arch,prompt_len", [("hymba-1.5b-reduced", 80),
                                             ("falcon-mamba-7b-reduced", 9)])
def test_lm_kernels_vs_plain_paths_end_to_end(cuda, arch, prompt_len):
    """prefill and 4 decode steps with the kernels and with the model's
    plain paths, from the same weights and tokens (a hymba prompt past the
    window of 64, so the ring wraps)."""
    cfg = get_config(arch)
    params = transformer.init_params(
        cfg, torch.Generator(device=cuda).manual_seed(0))
    rng = np.random.default_rng(1)
    prompt = torch.from_numpy(rng.integers(0, cfg.vocab_size,
                                           (2, prompt_len))).to(cuda)
    forced = torch.from_numpy(rng.integers(0, cfg.vocab_size, (4, 2, 1))
                              ).to(cuda)
    runs = {}
    for mode in ("cuda", "ref"):
        previous = select.set_kernel_mode(mode)
        try:
            state, logits = transformer.prefill(cfg, params, prompt, 4)
            out = [logits]
            for tok in forced:
                state, logits = transformer.decode_step(cfg, params, state,
                                                        tok)
                out.append(logits)
        finally:
            select.set_kernel_mode(previous)
        runs[mode] = (out, state)
    for got, want in zip(runs["cuda"][0], runs["ref"][0]):
        torch.testing.assert_close(got, want, atol=1e-4, rtol=0)
    for key, want in runs["ref"][1].items():
        if key != "pos":
            torch.testing.assert_close(runs["cuda"][1][key], want,
                                       atol=1e-4, rtol=0)


@pytest.mark.gpu
def test_process_collect_on_cuda_equals_inline(cuda):
    """Two rollout worker processes on the card (each its own CUDA
    context, launching the cheetah kernel) collect what the inline backend
    collects, bit for bit, over two sweeps; each worker reports its cuda
    device and its cheetah launches."""
    import dataclasses

    from repro_torch import experiment
    from repro_torch.experiment import ExperimentSpec, Schedule
    spec = ExperimentSpec(env="cheetah", algo="ppo",
                          env_kwargs={"max_episode_steps": 5},
                          schedule=Schedule(num_samplers=2, global_batch=32,
                                            horizon=12, seed=1))
    inline = experiment.build(spec, device=cuda)
    proc = experiment.build(dataclasses.replace(spec, backend="process"),
                            device=cuda)
    try:
        for _ in range(2):
            want, _ = inline.backend.collect(inline.params)
            got, _ = proc.backend.collect(proc.params)
            assert sorted(got) == sorted(want)
            for k in want:
                assert got[k].device.type == "cuda"
                assert torch.equal(got[k], want[k]), k
        info = proc.backend.pool.worker_launches
        assert sorted(info) == [(0, 1), (1, 1)]
        for i in info.values():
            assert i["device"].startswith("cuda")
            assert i["memory_reserved_mib"] > 0
            assert i["launches"]["cheetah_step"] == 2 * 12
    finally:
        inline.close()
        proc.close()
