"""The CUDA kernels against their plain PyTorch versions on the card.

Every test here needs a CUDA device and skips without one. The file
imports neither ``jax`` nor ``repro``, so it runs where only PyTorch is
installed:

    PYTHONPATH=src python -m pytest --noconftest -m gpu \
        tests/test_torch_kernels_gpu.py

Bounds: ``t``, ``done``, GAE and the discounted returns exact
(``-fmad=false`` and only ``+ - *``: the kernel rounds the plain version's
expressions the same way); env float
leaves within 4 ulp per element, or 4 ulp of the leaf's magnitude where
cancellation leaves a value near zero (``sinf``/``cosf`` may differ from
ATen's by an ulp). The replay-ring and sum-tree kernels exactly: they move
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
    return torch.from_numpy(x).to(device)


LEAVES = [((14,), torch.float32), ((), torch.float32), ((4,), torch.float32),
          ((3,), torch.bool), ((2,), torch.int32)]


@pytest.mark.gpu
@pytest.mark.parametrize("cap,n,start", [
    (17, 5, 0), (17, 5, 15), (12, 12, 7), (8, 11, 3), (1, 1, 0), (1, 3, 0),
    (1 << 20, 20000, (1 << 20) - 7000), (4096, 20000, 100)])
def test_ring_insert_kernel_matches_plain(cuda, cap, n, start):
    rng = np.random.default_rng(cap + n)
    storage = {f"l{i}": _leaf(rng, (cap,) + s, d, cuda)
               for i, (s, d) in enumerate(LEAVES)}
    batch = {f"l{i}": _leaf(rng, (n,) + s, d, cuda)
             for i, (s, d) in enumerate(LEAVES)}
    want = ring_ops.ring_insert_ref({k: v.clone() for k, v in storage.items()},
                                    batch, start)
    before = ring_ops.ring_insert_cuda.launches
    got = ring_ops.ring_insert(storage, batch, start, impl="cuda")
    torch.cuda.synchronize()
    assert got is storage
    assert ring_ops.ring_insert_cuda.launches == before + len(LEAVES)
    for k in want:
        assert torch.equal(got[k], want[k]), k


@pytest.mark.gpu
@pytest.mark.parametrize("cap,B", [(17, 6), (1, 1), (64, 64), (1 << 20, 256)])
def test_ring_gather_kernel_matches_plain(cuda, cap, B):
    rng = np.random.default_rng(cap * 7 + B)
    storage = {f"l{i}": _leaf(rng, (cap,) + s, d, cuda)
               for i, (s, d) in enumerate(LEAVES)}
    idx = rng.integers(0, cap, B).astype(np.int32)
    idx[:2] = [cap + 5, -1][:B]                  # clamped / from the end
    idx = torch.from_numpy(idx).to(cuda)
    before = ring_ops.ring_gather_cuda.launches
    got = ring_ops.ring_gather(storage, idx, impl="cuda")
    want = ring_ops.ring_gather_ref(storage, idx)
    torch.cuda.synchronize()
    assert ring_ops.ring_gather_cuda.launches == before + len(LEAVES)
    for k in want:
        assert got[k].shape == want[k].shape and torch.equal(got[k], want[k])


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
    storage = torch.zeros(8, 3, device=cuda)
    with pytest.raises(ValueError, match="batch"):
        ring_ops.ring_insert_cuda(storage, torch.ones(2, 4, device=cuda), 0)
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


ATTN_TOL = {torch.float32: 2e-5, torch.bfloat16: 3e-2}


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
