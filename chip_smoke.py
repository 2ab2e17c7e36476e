#!/usr/bin/env python3
"""Smoke test of the PyTorch port (``src/repro_torch``) on one CUDA card.

    python3 chip_smoke.py

Phases, each of which raises (and so exits non-zero) on failure:

1. device: the card's name and power limit from ``nvidia-smi``;
2. build: every CUDA kernel of the slices, compiled from ``src/repro_torch/
   kernels/csrc`` (one ``nvcc`` per source, all at once);
3. kernels: each kernel's wrapper on card tensors at the shapes the main
   path gives it (and a larger env batch with a third of the rows at their
   last step, so the reset select fires), held against its plain PyTorch
   version on the same inputs: ``t``/``done``, GAE and the discounted
   returns (T × B = 1 × 1, 125 × 160, 128 × 4096, a ragged 125 × 163, 0 × 5)
   exactly, env float leaves within 4 ulp (or 4 ulp of the leaf's magnitude
   near zero; cart-pole at B = 1, 16, 700 and 4096 with poles falling and a
   reward scale of 0.5); the replay ring (N > cap, wraparound, cap 1,
   float, bool and int rows) and the sum tree (capacities 1, 2, 1024 and
   2^20, zero-mass leaves, updates with duplicate indices) exactly; the LM
   kernels at the serve runs' shapes and ragged ones: the selective scan
   (hymba's prefill B 4 × S 144 × Di 3,200 × N 16, the long request's
   S 4,224, B 3 × S 37 × Di 100 × N 5, a nonzero h0) within 2e-4 relative
   to max(1, |value|), flash attention (hymba at S 144 and 4,224 with the
   window 2,048, hd 128 causal, hd 32 non-causal, a ragged window) and
   decode attention (176 slots with a random validity mask, a full ring of
   2,048, hd 32 and 128) within 2e-5 in float32 and 3e-2 in bfloat16;
4. main path, each run with the launch counts set to 0 just before it and
   read just after: PPO on cheetah through the train CLI with the paper's
   budget (10 samplers × 16 envs × 125 steps = 20,000 samples per
   iteration, 3 iterations), the vector path (one 4096-env batch, 128
   steps, 2 iterations), and the CLI's default env, pendulum (10 × 16 ×
   125, 2 iterations); then SAC on cheetah through the train CLI with
   prioritized replay (the same budget, 3 iterations; replay capacity
   1,000,000, i.e. 2^20 slots, and minibatch 256, the SAC paper's), and SAC
   on pendulum with uniform replay (2 iterations); then, through the train
   CLI, PPO on cart-pole (10 × 16 × 125, 3 iterations, and one 4096-env
   batch × 128 steps, 2 iterations), TRPO on cheetah (10 × 16 × 125, 3
   iterations) and DDPG on cheetah with prioritized replay (the SAC run's
   budget and replay, 3 iterations). Every log must be finite with the
   expected sample count, and each kernel's count must equal the steps,
   learns, inserts, draws and priority updates the run made. Then LM
   serving at full width and depth with random weights: (a) the serve CLI
   with its defaults on hymba-1.5b (batch 4, prompt 16 + 128 meta tokens,
   32 tokens, 3 requests), (b) one prompt of 4,096 (P = 4,224, past the
   window of 2,048: the ring wraps), (c) the wave server (4 slots, 10
   requests in 3 waves, budgets 32 and 12, an EOS id), and falcon-mamba-7b
   cut to 8 of 64 layers (batch 4, prompt 16, 16 tokens, 2 requests);
   tokens in [0, vocab), logits finite, and per prefill one scan and one
   flash launch per layer, per decode step one decode launch per layer;
5. reference: small PPO, SAC prioritized, TRPO cart-pole and DDPG
   prioritized pendulum runs with the kernels, and the same runs with the
   plain versions (``kernels="ref"``), must end with the same weights bit
   for bit (with the SAC and DDPG replay rings and trees too); hymba-1.5b
   in float32 cut to 4 layers (TF32 off), batch 2, prompts of 16 and of
   2,100 (past the window), 8 decode steps, the plain paths teacher-forced
   with the kernels' tokens: prefill and every step's logits and the final
   k, v, conv and ssm state within ``LM_F32_TOL``; and in bfloat16 run
   (a)'s first request, whose max logit difference and top-1 agreement
   over the prefill and 8 steps are reported, not bounded;
6. timings: each kernel's median time per call (CUDA events around
   back-to-back calls, host launch included) and its device time alone
   (calls captured in a CUDA graph and replayed), the same two for its
   plain version, the least time the card could take (bytes at 3.35 TB/s
   or float32 operations at 67 TFLOP/s, H100 SXM data sheet; an env step's
   reset candidates count only for the rows whose episode ends, the only
   rows whose candidates the kernel reads; a tree op's nodes only where
   this call's paths touch them), and, where one PyTorch call per leaf
   computes the same function (``index_copy_`` for the ring insert,
   ``index_select`` for the gather), that call's time, printed as one JSON
   line ``{"kernels": [...]}``. A replay-ring time covers one call of the
   op over the 5 stored leaves (5 launches). The discounted returns lie on
   no path (neither package calls them outside tests and benchmarks); they
   are timed at the GAE shapes. The LM kernels are timed in bfloat16 at run
   (a)'s shapes and at the long request's; their operations count the
   products of the (row, key) pairs the masks let through at the bf16
   tensor-core rate (989 TFLOP/s), the scan's at the float32 rate, and
   their library yardstick is one ``scaled_dot_product_attention`` call
   (``enable_gqa``, the band or validity mask) on the same values in its
   own layout; the scan has none.

The last line is ``{"ok": true, "device": {...}}``; it is printed only when
every phase passed. Without a CUDA device the script exits non-zero at once.
"""
from __future__ import annotations

import contextlib
import dataclasses
import io
import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

HBM_BYTES_PER_S = 3.35e12      # H100 SXM, NVIDIA data sheet
F32_OPS_PER_S = 67e12          # H100 SXM float32 outside the tensor cores
BF16_OPS_PER_S = 989e12        # H100 SXM bf16 tensor cores, dense
ENV_ULPS = 4
# the LM kernels against their plain versions (tests/test_kernels.py's
# bounds for the Pallas kernels): attention in float32 / bfloat16, and the
# scan, relative where the state grows over a long sequence
ATTN_TOL = {torch.float32: 2e-5, torch.bfloat16: 3e-2}
SCAN_TOL = 2e-4
# cuda vs ref, float32 hymba-1.5b at 4 layers, on logits of magnitude ~5
# and on the final state: the kernels sum in another order than the plain
# paths (the flash kernel rescales per key, the decode kernel reduces over
# slots in a tree, the scan sums y over the state in another order),
# through 4 layers, the fused norms and a 32,001-wide head
LM_F32_TOL = 1e-4

# float operations per instance / element, counted from the kernel bodies
# (adds, multiplies, divides, transcendentals and clamps, one each)
# (ring ops: none; tree ops per node visited: a compare, a subtract and a
# select on the way down, one add per parent on the way up)
OPS = {"pendulum_step": 30, "cartpole_step": 40, "cheetah_step": 150,
       "gae": 7, "discounted_returns": 4, "ring_insert": 0, "ring_gather": 0,
       "sumtree_find": 3, "sumtree_update": 1}
REPLACES = {
    "pendulum_step": "src/repro/kernels/env_step/env_step_pallas.py:102",
    "cartpole_step": "src/repro/kernels/env_step/env_step_pallas.py:177",
    "cheetah_step": "src/repro/kernels/env_step/env_step_pallas.py:254",
    "gae": "src/repro/kernels/gae/gae_pallas.py:117",
    "discounted_returns": "src/repro/kernels/gae/gae_pallas.py:150",
    "ring_insert": "src/repro/kernels/replay_ring/replay_ring_pallas.py:56",
    "ring_gather": "src/repro/kernels/replay_ring/replay_ring_pallas.py:77",
    "sumtree_find": "src/repro/kernels/sum_tree/sum_tree_pallas.py:103",
    "sumtree_update": "src/repro/kernels/sum_tree/sum_tree_pallas.py:126",
    "flash_attention":
        "src/repro/kernels/flash_attention/flash_attention.py:112",
    "decode_attention":
        "src/repro/kernels/decode_attention/decode_attention.py:77",
    "selective_scan": "src/repro/kernels/selective_scan/selective_scan.py:73",
}
SOURCES = {
    "pendulum_step": "src/repro_torch/kernels/csrc/env_step.cu",
    "cartpole_step": "src/repro_torch/kernels/csrc/env_step.cu",
    "cheetah_step": "src/repro_torch/kernels/csrc/env_step.cu",
    "gae": "src/repro_torch/kernels/csrc/gae.cu",
    "discounted_returns": "src/repro_torch/kernels/csrc/gae.cu",
    "ring_insert": "src/repro_torch/kernels/csrc/replay_ring.cu",
    "ring_gather": "src/repro_torch/kernels/csrc/replay_ring.cu",
    "sumtree_find": "src/repro_torch/kernels/csrc/sum_tree.cu",
    "sumtree_update": "src/repro_torch/kernels/csrc/sum_tree.cu",
    "flash_attention": "src/repro_torch/kernels/csrc/flash_attention.cu",
    "decode_attention": "src/repro_torch/kernels/csrc/decode_attention.cu",
    "selective_scan": "src/repro_torch/kernels/csrc/selective_scan.cu",
}
CHEETAH_LEAVES = {"obs": (14,), "actions": (6,), "rewards": (),
                  "next_obs": (14,), "discounts": ()}
CAP = 1 << 20


def log(msg: str) -> None:
    print(msg, flush=True)


# ----------------------------------------------------------- comparisons
def ulp_distance(a, b):
    """Per-element distance in float32 steps (0 == bitwise equal)."""
    ia = a.view(np.int32).astype(np.int64)
    ib = b.view(np.int32).astype(np.int64)
    ia = np.where(ia < 0, np.int64(-(2 ** 31)) - ia, ia)
    ib = np.where(ib < 0, np.int64(-(2 ** 31)) - ib, ib)
    return np.abs(ia - ib)


def compare(name, got, want, float_ulps):
    """Exact on int/bool leaves; float leaves within ``float_ulps`` steps,
    or ``float_ulps`` steps of the leaf's largest magnitude (cancellation
    near zero). Returns (max ulp, max abs error) over float leaves."""
    worst_ulp, worst_abs = 0, 0.0
    for i, (g, w) in enumerate(zip(got, want)):
        g, w = g.cpu().numpy(), w.cpu().numpy()
        assert g.dtype == w.dtype and g.shape == w.shape, (
            f"{name} leaf {i}: {g.dtype}{g.shape} vs {w.dtype}{w.shape}")
        if g.dtype.kind in "iub":
            assert np.array_equal(g, w), f"{name} leaf {i} differs"
            continue
        err = np.abs(g.astype(np.float64) - w.astype(np.float64))
        ulps = ulp_distance(g, w)
        scale = np.spacing(np.float32(max(np.abs(w).max(initial=0), 1e-30)))
        ok = (ulps <= float_ulps) | (err <= float_ulps * float(scale))
        assert ok.all(), (f"{name} leaf {i}: {int((~ok).sum())} elements "
                          f"past {float_ulps} ulp (max {int(ulps.max())})")
        worst_ulp = max(worst_ulp, int(ulps.max(initial=0)))
        worst_abs = max(worst_abs, float(err.max(initial=0)))
    return worst_ulp, worst_abs


def leaves(out):
    state, obs, rew, done = out
    return list(state) + [obs, rew, done]


# ---------------------------------------------------------------- inputs
def env_inputs(name, B, horizon, seed):
    """Random state/actions/reset candidates on the card; a third of the
    rows at their last step."""
    rng = np.random.default_rng(seed)
    dev = "cuda"

    def f(*shape, lo=-1.0, hi=1.0):
        return torch.from_numpy(
            rng.uniform(lo, hi, shape).astype(np.float32)).to(dev)

    t = rng.integers(0, horizon - 1, B).astype(np.int32)
    t[: B // 3] = horizon - 1
    rng.shuffle(t)
    t = torch.from_numpy(t).to(dev)
    rt = torch.zeros(B, dtype=torch.int32, device=dev)
    if name == "pendulum":
        state = (f(B, lo=-3 * math.pi, hi=3 * math.pi), f(B, lo=-8, hi=8), t)
        reset = (f(B, lo=-math.pi, hi=math.pi), f(B), rt)
        return (state, f(B, 1, lo=-3, hi=3), reset, f(B, 3),
                dict(max_torque=2.0))
    if name == "cartpole":
        # x and th around their limits (2.4, 12 degrees): poles fall and
        # carts leave the track; actions beyond the force clip
        state = (f(B, lo=-2.5, hi=2.5), f(B, lo=-2, hi=2),
                 f(B, lo=-0.25, hi=0.25), f(B, lo=-2, hi=2), t)
        reset = tuple(f(B, lo=-0.05, hi=0.05) for _ in range(4)) + (rt,)
        return state, f(B, 1, lo=-2, hi=2), reset, f(B, 4), dict(
            force_max=10.0)
    state = (f(B, 6), f(B, 6), f(B, lo=-2, hi=2), f(B), t)
    reset = (f(B, 6, lo=-0.1, hi=0.1), f(B, 6, lo=-0.1, hi=0.1),
             torch.zeros(B, device=dev), torch.zeros(B, device=dev), rt)
    return state, f(B, 6, lo=-2, hi=2), reset, f(B, 14), dict(ctrl_cost=0.1)


def gae_inputs(T, B, seed):
    rng = np.random.default_rng(seed)
    r = rng.standard_normal((T, B)).astype(np.float32)
    v = rng.standard_normal((T, B)).astype(np.float32)
    d = rng.random((T, B)) < 0.05
    lv = rng.standard_normal(B).astype(np.float32)
    return [torch.from_numpy(x).to("cuda") for x in (r, v, d, lv)]


def ring_leaves(rows, gen, kinds=None):
    """Random leaves of ``rows`` rows on the card: the SAC cheetah
    transition schema by default, else ``{name: (trailing shape, dtype)}``."""
    kinds = kinds or {k: (s, torch.float32) for k, s in
                      CHEETAH_LEAVES.items()}
    out = {}
    for k, (shape, dtype) in kinds.items():
        size = (rows,) + tuple(shape)
        if dtype == torch.bool:
            out[k] = torch.rand(size, generator=gen, device="cuda") < 0.5
        elif dtype == torch.int32:
            out[k] = torch.randint(-9, 9, size, generator=gen,
                                   device="cuda", dtype=torch.int32)
        else:
            out[k] = torch.randn(size, generator=gen, device="cuda")
    return out


MIXED_LEAVES = {"f14": ((14,), torch.float32), "f": ((), torch.float32),
                "f4": ((4,), torch.float32), "b3": ((3,), torch.bool),
                "i2": ((2,), torch.int32)}


def random_tree(cap, filled, gen):
    """A sum tree on the card with ``filled`` leading leaves of positive
    mass (a third of them zero), the rest zero."""
    from repro_torch.kernels.sum_tree import sumtree_build
    leaves = torch.zeros(cap, device="cuda")
    x = torch.rand(filled, generator=gen, device="cuda")
    leaves[:filled] = torch.where(x < 0.33, torch.zeros_like(x), x)
    return sumtree_build(leaves)


def stratified_masses(tree, B, gen):
    u = torch.rand(B, generator=gen, device="cuda")
    return ((torch.arange(B, device="cuda") + u)
            / torch.tensor(float(B), device="cuda")) * tree.total


def tree_path_nodes(idx, cap):
    """Distinct parents on the root paths of leaf indices ``idx``, level by
    level above the leaves: the nodes a descent reads the left child of,
    and an update rewrites."""
    idx = idx.to(torch.int64)
    return [int(torch.unique(idx >> (k + 1)).numel())
            for k in range(cap.bit_length() - 1)]


def tree_update_bytes(idx, cap):
    """Bytes a batched leaf update must move beyond ``idx`` and the values:
    each distinct leaf written once, each touched parent written once, and
    each child of a touched parent read only where it is not itself on a
    touched path (a touched child's value was just written by the call)."""
    idx = idx.to(torch.int64)
    touched = [int(torch.unique(idx >> k).numel())
               for k in range(cap.bit_length())]
    return 4 * touched[0] + sum(4 * p + 4 * (2 * p - c)
                                for c, p in zip(touched, touched[1:]))


# ---------------------------------------------------------------- timing
def time_ms(fn, reps, rounds=5):
    """Median over ``rounds`` of the mean time of ``reps`` back-to-back
    calls, between CUDA events, after a warm-up."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    samples = []
    for _ in range(rounds):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        stop.record()
        torch.cuda.synchronize()
        samples.append(start.elapsed_time(stop) / reps)
    return statistics.median(samples)


def graph_ms(fn, reps):
    """Device time per call: ``reps`` calls captured in one CUDA graph,
    replayed between CUDA events, so the host's launch cost is left out."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    return time_ms(graph.replay, 1) / reps


def measure(kernel, shape, n, moved, fn, plain, reps, plain_reps,
            library=None, plain_graph=True, ops=None, rate=F32_OPS_PER_S):
    """Timings of one kernel and its plain version on the same inputs:
    ``ms``/``plain_ms`` per call as the main path makes it (host launch
    included), ``device_ms``/``plain_device_ms`` from graph replay (None
    where the plain version syncs with the host and so cannot be
    captured), and ``library_ms`` for one PyTorch call of the same
    function, where there is one. ``ops`` at ``rate`` replaces the
    per-instance count ``OPS[kernel] * n``."""
    b_ms, b_by = bound(kernel, n, moved, ops, rate)
    return {"ms": time_ms(fn, reps), "plain_ms": time_ms(plain, plain_reps),
            "device_ms": graph_ms(fn, reps),
            "plain_device_ms": (graph_ms(plain, plain_reps) if plain_graph
                                else None),
            "library_ms": None if library is None else time_ms(library, reps),
            "bound_ms": b_ms, "bound_by": b_by, "shape": shape,
            "bytes": moved}


def nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


def bound(kernel, n, moved, ops=None, rate=F32_OPS_PER_S):
    """(bound_ms, bound_by) for ``n`` instances/elements moving ``moved``
    bytes (or ``ops`` operations at ``rate``)."""
    t_bytes = moved / HBM_BYTES_PER_S * 1e3
    t_ops = (OPS[kernel] * n if ops is None else ops) / rate * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# -------------------------------------------------------------- LM slice
HYMBA = dict(B=4, P=16 + 128, gen=32)       # run (a): prompt 16 + 128 meta
LONG = dict(B=1, P=4096 + 128, gen=16)      # run (b): past the window 2048


def scan_inputs(B, S, Di, N, gen, h0_scale=0.0):
    """Random scan inputs on the card: dt = softplus(normal) / 10 and
    A = -exp(normal / 5), as tests/test_kernels.py draws them."""
    def rnd(*shape):
        return torch.randn(shape, generator=gen, device="cuda")
    dt = torch.nn.functional.softplus(rnd(B, S, Di)) * 0.1
    A = -torch.exp(rnd(Di, N) * 0.2)
    return dt, A, rnd(B, S, N), rnd(B, S, N), rnd(B, S, Di), rnd(
        B, Di, N) * h0_scale


def attn_inputs(B, S, K, G, hd, dtype, gen):
    def rnd(*shape):
        return torch.randn(shape, generator=gen, device="cuda").to(dtype)
    return rnd(B, S, K, G, hd), rnd(B, S, K, hd), rnd(B, S, K, hd)


def decode_inputs(B, K, G, Sc, hd, dtype, p_valid, gen):
    q = torch.randn((B, K, G, hd), generator=gen, device="cuda").to(dtype)
    kc, vc = (torch.randn((B, Sc, K, hd), generator=gen, device="cuda"
                          ).to(dtype) for _ in range(2))
    valid = torch.rand(Sc, generator=gen, device="cuda") < p_valid
    valid[0] = True
    return q, kc, vc, valid


def max_err(got, want, rel=False):
    """max |got - want|; with ``rel``, over max(1, |want|)."""
    err = (got.double() - want.double()).abs()
    if rel:
        err = err / want.double().abs().clamp_min(1.0)
    return float(err.max())


def check_lm_kernels(errs, gen):
    """Phase 3 for the LM kernels: each wrapper against its plain version
    at the serve runs' shapes and at ragged ones."""
    from repro_torch.kernels.decode_attention import ops as dec_ops
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.selective_scan import ops as scan_ops

    def note(name, err):
        errs[name] = (None, max(errs[name][1], err))

    for B, S, Di, N, h0 in ((HYMBA["B"], HYMBA["P"], 3200, 16, 0.0),
                            (LONG["B"], LONG["P"], 3200, 16, 0.0),
                            (3, 37, 100, 5, 0.0), (2, 300, 256, 16, 1.0)):
        args = scan_inputs(B, S, Di, N, gen, h0)
        got = scan_ops.selective_scan_cuda(*args)
        want = scan_ops.selective_scan_ref(*args)
        torch.cuda.synchronize()
        err = max(max_err(g, w, rel=True) for g, w in zip(got, want))
        assert err <= SCAN_TOL, f"selective_scan B={B} S={S}: {err}"
        note("selective_scan", max(max_err(g, w) for g, w in zip(got, want)))
        log(f"check selective_scan B={B} S={S} Di={Di} N={N} h0*{h0}: "
            f"max rel err {err:.3g}")
    for B, S, K, G, hd, causal, window, dtypes in (
            (HYMBA["B"], HYMBA["P"], 5, 5, 64, True, 2048,
             (torch.bfloat16, torch.float32)),
            (LONG["B"], LONG["P"], 5, 5, 64, True, 2048,
             (torch.bfloat16, torch.float32)),
            (2, 300, 2, 4, 128, True, 0, (torch.bfloat16, torch.float32)),
            (2, 129, 2, 2, 32, False, 0, (torch.bfloat16, torch.float32)),
            (1, 77, 4, 1, 32, True, 20, (torch.float32,))):
        for dtype in dtypes:
            q, k, v = attn_inputs(B, S, K, G, hd, dtype, gen)
            got = fa_ops.flash_attention_cuda(q, k, v, causal=causal,
                                              window=window)
            want = fa_ops.flash_attention(q, k, v, causal=causal,
                                          window=window, impl="ref")
            torch.cuda.synchronize()
            err = max_err(got, want)
            assert err <= ATTN_TOL[dtype], (
                f"flash_attention S={S} hd={hd} {dtype}: {err}")
            note("flash_attention", err)
            log(f"check flash_attention B={B} S={S} K={K} G={G} hd={hd} "
                f"causal={causal} window={window} {dtype}: max abs err "
                f"{err:.3g}")
    for B, K, G, Sc, hd, p_valid in ((HYMBA["B"], 5, 5, 176, 64, 0.6),
                                     (LONG["B"], 5, 5, 2048, 64, 1.0),
                                     (3, 2, 3, 300, 32, 0.5),
                                     (2, 2, 4, 500, 128, 0.8)):
        for dtype in (torch.bfloat16, torch.float32):
            q, kc, vc, valid = decode_inputs(B, K, G, Sc, hd, dtype, p_valid,
                                             gen)
            got = dec_ops.decode_attention_cuda(q, kc, vc, valid)
            want = dec_ops.decode_attention(q, kc, vc, valid, impl="ref")
            torch.cuda.synchronize()
            err = max_err(got, want)
            assert err <= ATTN_TOL[dtype], (
                f"decode_attention Sc={Sc} hd={hd} {dtype}: {err}")
            note("decode_attention", err)
            log(f"check decode_attention B={B} K={K} G={G} Sc={Sc} hd={hd} "
                f"valid {int(valid.sum())} {dtype}: max abs err {err:.3g}")


def serve_cli(argv):
    """The serve CLI's request lines and launch counts (and its run, kept
    in ``serve_cli.result``)."""
    from repro_torch.launch import serve
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        serve_cli.result = serve.main(argv)
    lines = buf.getvalue().splitlines()
    for line in lines:
        log(f"  {line}")
    return lines


def check_generated(label, run_requests, vocab):
    for r in run_requests:
        assert bool(((r.tokens >= 0) & (r.tokens < vocab)).all()), label
        assert bool(torch.isfinite(r.logits).all()), f"{label}: logits"


def lm_serve_runs(counted, runs, zero_counts):
    """Phase 4 for the LM slice: hymba-1.5b at full width and depth through
    the serve CLI (run (a), the CLI's defaults, and run (b), a prompt past
    the window), the wave server, and falcon-mamba-7b cut to 8 layers.
    Returns run (a)'s result."""
    from repro_torch.configs import get_config
    from repro_torch.core.serving import Request, SlotServer
    from repro_torch.launch import serve
    from repro_torch.models import transformer

    hymba = get_config("hymba-1.5b")
    L = hymba.n_layers
    label = "serve hymba-1.5b (a) B=4 prompt 16 gen 32 x3"
    t0 = time.perf_counter()
    lines = counted(label, lambda: serve_cli(
        ["--arch", "hymba-1.5b", "--batch", "4", "--prompt-len", "16",
         "--gen-len", "32", "--requests", "3"]))
    run_a = serve_cli.result
    log(f"  {label}: {time.perf_counter() - t0:.2f} s with the init")
    assert len(lines) == 4 and json.loads(lines[-1])["kernel_launches"]
    check_generated(label, run_a.requests, hymba.vocab_size)
    assert runs[label] == zero_counts(selective_scan=3 * L,
                                      flash_attention=3 * L,
                                      decode_attention=3 * 32 * L), runs

    label = "serve hymba-1.5b (b) B=1 prompt 4096 gen 16"
    lines = counted(label, lambda: serve_cli(
        ["--arch", "hymba-1.5b", "--batch", "1", "--prompt-len", "4096",
         "--gen-len", "16", "--requests", "1"]))
    assert LONG["P"] > hymba.sliding_window       # the ring wraps
    check_generated(label, serve_cli.result.requests, hymba.vocab_size)
    assert runs[label] == zero_counts(selective_scan=L, flash_attention=L,
                                      decode_attention=16 * L), runs
    serve_cli.result = None

    label = "SlotServer hymba-1.5b 4 slots x 10 requests"
    server = SlotServer(hymba, run_a.params, slots=4, prompt_len=16,
                        max_new_tokens=32, eos_id=2, seed=1)
    gen = torch.Generator(device="cuda").manual_seed(5)
    for i in range(10):
        server.submit(Request(i, torch.randint(
            0, hymba.vocab_size, (16,), generator=gen, device="cuda"),
            max_new_tokens=32 if i % 3 else 12))
    done = counted(label, server.run)
    assert sorted(c.request_id for c in done) == list(range(10))
    for c in done:
        assert 1 <= len(c.tokens) <= 32
        assert all(0 <= t < hymba.vocab_size for t in c.tokens)
    snap = server.snapshot()
    log(f"  snapshot: {json.dumps(snap)}")
    assert snap["requests"] == 10 and snap["slots"] == 4
    assert runs[label] == zero_counts(
        selective_scan=3 * L, flash_attention=3 * L,
        decode_attention=server.decode_steps * L), runs

    label = "serve falcon-mamba-7b 8 of 64 layers B=4 prompt 16 gen 16 x2"
    falcon = dataclasses.replace(get_config("falcon-mamba-7b"), n_layers=8)
    gen = torch.Generator(device="cuda").manual_seed(0)

    def falcon_run():
        params = transformer.init_params(falcon, gen)
        out = []
        for _ in range(2):
            prompt = torch.randint(0, falcon.vocab_size, (4, 16),
                                   generator=gen, device="cuda")
            t0 = time.perf_counter()
            toks, logits = serve.generate(falcon, params, prompt, 16, gen)
            torch.cuda.synchronize()
            log(f"  falcon request: 16 tokens x 4 seqs in "
                f"{time.perf_counter() - t0:.2f}s")
            out.append(serve.RequestRun(prompt, toks, logits, 0.0))
        return out

    check_generated(label, counted(label, falcon_run), falcon.vocab_size)
    assert runs[label] == zero_counts(selective_scan=2 * 8), runs
    return run_a


def teacher_forced(cfg, params, prompt, gen_len, tokens=None, gen=None):
    """prefill and ``gen_len`` decode steps, fed ``tokens`` (B, gen_len)
    or tokens sampled from ``gen``; returns (tokens, logits before each
    step and after the last, final state)."""
    from repro_torch.models import transformer
    from repro_torch.serve import sampling
    state, logits = transformer.prefill(cfg, params, prompt,
                                        gen_budget=gen_len)
    seen, fed = [logits], []
    noise = None if tokens is not None else sampling.gumbel_source(gen)
    for t in range(gen_len):
        tok = (tokens[:, t] if tokens is not None
               else sampling.sample(logits, noise))
        fed.append(tok)
        state, logits = transformer.decode_step(cfg, params, state,
                                                tok[:, None])
        seen.append(logits)
    return torch.stack(fed, 1), seen, state


def lm_cuda_vs_ref(run_a):
    """Phase 5 for the LM slice: the kernels against the model's plain
    paths end to end, float32 (bounded) and bfloat16 (reported)."""
    from repro_torch import kernels
    from repro_torch.configs import get_config
    from repro_torch.models import transformer

    cfg = dataclasses.replace(get_config("hymba-1.5b"), n_layers=4,
                              dtype="float32")
    params = transformer.init_params(
        cfg, torch.Generator(device="cuda").manual_seed(3))
    report = {}
    for prompt_len in (16, 2100):
        gen = torch.Generator(device="cuda").manual_seed(prompt_len)
        prompt = torch.randint(0, cfg.vocab_size, (2, prompt_len),
                               generator=gen, device="cuda")
        out = {}
        for mode in ("cuda", "ref"):
            kernels.reset_launch_counts()
            prev = kernels.set_kernel_mode(mode)
            try:
                out[mode] = teacher_forced(
                    cfg, params, prompt, 8,
                    tokens=out["cuda"][0] if mode == "ref" else None,
                    gen=gen)
            finally:
                kernels.set_kernel_mode(prev)
            torch.cuda.synchronize()
            lm = {k: v for k, v in kernels.launch_counts().items()
                  if k in ("selective_scan", "flash_attention",
                           "decode_attention")}
            assert all((n > 0) == (mode == "cuda") for n in lm.values()), (
                mode, lm)
        (_, got_l, got_s), (_, want_l, want_s) = out["cuda"], out["ref"]
        logit_err = max(max_err(g, w) for g, w in zip(got_l, want_l))
        state_err = {k: max_err(got_s[k], want_s[k])
                     for k in ("k", "v", "conv", "ssm")}
        assert torch.equal(got_s["cache_pos"], want_s["cache_pos"])
        assert logit_err <= LM_F32_TOL and max(state_err.values()) <= \
            LM_F32_TOL, (prompt_len, logit_err, state_err)
        report[f"f32 prompt {prompt_len}"] = {
            "P": prompt_len + cfg.n_meta_tokens, "max_abs_logit_err":
            logit_err, "max_abs_state_err": state_err,
            "logit_magnitude": max(float(w.abs().max()) for w in want_l)}
        log(f"reference: hymba-1.5b f32 4 layers, prompt {prompt_len} "
            f"(P {prompt_len + cfg.n_meta_tokens}), cuda vs ref: max "
            f"|dlogit| {logit_err:.3g} over prefill + 8 steps, state "
            f"{json.dumps(state_err)} (bound {LM_F32_TOL})")
    del params

    # bfloat16: run (a)'s first request, teacher-forced through the plain
    # paths, against the logits the kernels gave
    req = run_a.requests[0]
    prev = kernels.set_kernel_mode("ref")
    try:
        _, want_l, _ = teacher_forced(run_a.cfg, run_a.params, req.prompt, 8,
                                      tokens=req.tokens[:, :8])
    finally:
        kernels.set_kernel_mode(prev)
    got_l = [req.logits[:, t] for t in range(9)]
    err = max(max_err(g, w) for g, w in zip(got_l, want_l))
    agree = float(torch.stack([g.argmax(-1) == w.argmax(-1) for g, w in
                               zip(got_l, want_l)]).float().mean())
    report["bf16 run (a) request 0"] = {"max_abs_logit_err": err,
                                        "top1_agreement": agree}
    log(f"reference: hymba-1.5b bf16 run (a) request 0, cuda vs ref over "
        f"prefill + 8 steps: max |dlogit| {err:.3g}, top-1 agreement "
        f"{agree:.4f} (reported, no bound)")
    return report


def time_lm_kernels(timings, gen):
    """Phase 6 for the LM kernels, at run (a)'s shapes ("main") and the long
    request's: call and device ms, plain ms, the bound, and one
    scaled_dot_product_attention call with the same mask as the library
    yardstick for the attention kernels."""
    from repro_torch.kernels.decode_attention import ops as dec_ops
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.selective_scan import ops as scan_ops
    sdpa = torch.nn.functional.scaled_dot_product_attention
    K, G, hd, W = 5, 5, 64, 2048
    for label, shp in (("main", HYMBA), ("long", LONG)):
        B, S = shp["B"], shp["P"]
        long = label == "long"
        q, k, v = attn_inputs(B, S, K, G, hd, torch.bfloat16, gen)
        o = fa_ops.flash_attention_cuda(q, k, v, causal=True, window=W)
        rows = torch.arange(S, device="cuda")
        band = (rows[None, :] <= rows[:, None]) & (
            rows[:, None] - rows[None, :] < W)
        pairs = int(band.sum())                  # (row, key) pairs seen
        qh = q.reshape(B, S, K * G, hd).transpose(1, 2).contiguous()
        kh, vh = (t.transpose(1, 2).contiguous() for t in (k, v))
        timings[label, "flash_attention"] = measure(
            "flash_attention", f"B={B} S={S} H=25 K=5 hd=64 window {W} bf16",
            0, nbytes(q, k, v, o),
            lambda: fa_ops.flash_attention_cuda(q, k, v, causal=True,
                                                window=W),
            lambda: fa_ops.flash_attention(q, k, v, causal=True, window=W,
                                           impl="ref"),
            20 if long else 200, 3 if long else 20,
            library=lambda: sdpa(qh, kh, vh, attn_mask=band,
                                 enable_gqa=True),
            plain_graph=not long, ops=4 * hd * pairs * B * K * G,
            rate=BF16_OPS_PER_S)

        Sc = min(W, S + shp["gen"])
        qd, kc, vc, valid = decode_inputs(B, K, G, Sc, hd, torch.bfloat16,
                                          1.0, gen)
        od = dec_ops.decode_attention_cuda(qd, kc, vc, valid)
        n_valid = int(valid.sum())
        qdh = qd.reshape(B, K * G, 1, hd)
        kch, vch = (t.transpose(1, 2).contiguous() for t in (kc, vc))
        timings[label, "decode_attention"] = measure(
            "decode_attention", f"B={B} Sc={Sc} ({n_valid} valid) H=25 K=5 "
            f"hd=64 bf16", 0,
            nbytes(qd, od, valid) + 2 * B * K * n_valid * hd * 2,
            lambda: dec_ops.decode_attention_cuda(qd, kc, vc, valid),
            lambda: dec_ops.decode_attention(qd, kc, vc, valid, impl="ref"),
            200, 50,
            library=lambda: sdpa(qdh, kch, vch,
                                 attn_mask=valid.view(1, 1, 1, Sc),
                                 enable_gqa=True),
            ops=4 * hd * n_valid * B * K * G, rate=BF16_OPS_PER_S)

        Di, N = 3200, 16
        args = scan_inputs(B, S, Di, N, gen)
        y, h = scan_ops.selective_scan_cuda(*args)
        timings[label, "selective_scan"] = measure(
            "selective_scan", f"B={B} S={S} Di={Di} N={N}", 0,
            nbytes(*args, y, h),
            lambda: scan_ops.selective_scan_cuda(*args),
            lambda: scan_ops.selective_scan_ref(*args),
            20 if long else 100, 1 if long else 3, plain_graph=not long,
            # per (b, t, d, n): dt * A, exp, abar * h, dx * B, +, h * C, +
            ops=7 * B * S * Di * N)


# ------------------------------------------------------------------ main
def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing to check", file=sys.stderr)
        return 1
    from repro_torch import kernels
    from repro_torch.experiment import ExperimentSpec, Schedule, run
    from repro_torch.kernels import build
    from repro_torch.kernels.env_step import ops as env_ops
    from repro_torch.kernels.env_step import ref as env_ref
    from repro_torch.kernels.gae import ops as gae_ops
    from repro_torch.kernels.replay_ring import ops as ring_ops
    from repro_torch.kernels.sum_tree import ops as tree_ops
    from repro_torch.kernels.sum_tree.ref import SumTree
    from repro_torch.launch import train

    # 1. device
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    log(f"device: {smi}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # 2. build
    t0 = time.perf_counter()
    secs = build.build_all()
    log(f"build: {time.perf_counter() - t0:.2f} s wall "
        f"({', '.join(f'{k} {v:.2f} s' for k, v in secs.items())})")
    for name in build.SOURCES:
        for line in build.build_log(name).splitlines():
            if "registers" in line or "spill" in line:
                log(f"  ptxas[{name}]: {line.strip()}")

    # 3. kernels against their plain versions
    errs = {k: (0, 0.0) for k in kernels.KERNELS}
    horizon = 50
    for name, wrapper in (("pendulum", env_ops.pendulum_step_cuda),
                          ("cheetah", env_ops.cheetah_step_cuda)):
        for B in (16, 4096, 16384):
            state, a, rs, ro, p = env_inputs(name, B, horizon, seed=B)
            params = dict(max_episode_steps=horizon, reward_scale=1.0, **p)
            got = wrapper(state, a, rs, ro, **params)
            want = env_ref.STEP_BATCH_REF[name](state, a, rs, ro, **params)
            torch.cuda.synchronize()
            u, e = compare(f"{name} B={B}", leaves(got), leaves(want),
                           ENV_ULPS)
            key = f"{name}_step"
            errs[key] = (max(errs[key][0], u), max(errs[key][1], e))
            done = got[3]
            assert int(done.sum()) >= B // 3, "reset select did not fire"
            log(f"check {key} B={B}: max {u} ulp, max abs err {e:.3g}, "
                f"{int(done.sum())} resets")
    for B in (1, 16, 700, 4096):
        state, a, rs, ro, p = env_inputs("cartpole", B, horizon, seed=B + 1)
        params = dict(max_episode_steps=horizon, reward_scale=0.5, **p)
        got = env_ops.cartpole_step_cuda(state, a, rs, ro, **params)
        want = env_ref.cartpole_step_batch_ref(state, a, rs, ro, **params)
        torch.cuda.synchronize()
        u, e = compare(f"cartpole B={B}", leaves(got), leaves(want),
                       ENV_ULPS)
        key = "cartpole_step"
        errs[key] = (max(errs[key][0], u), max(errs[key][1], e))
        done = got[3]
        fell = int((done & (state[4] + 1 < horizon)).sum())
        assert int(done.sum()) >= B // 3 and (B < 16 or fell > 0), (
            "cart-pole: no reset or no fall")
        log(f"check {key} B={B}: max {u} ulp, max abs err {e:.3g}, "
            f"{int(done.sum())} resets ({fell} falls)")
    for T, B in ((125, 160), (128, 4096), (125, 160 + 3)):
        r, v, d, lv = gae_inputs(T, B, seed=T * B)
        got = gae_ops.gae_cuda(r, v, d, lv, gamma=0.99, lam=0.95)
        want = gae_ops.gae_ref(r, v, d, lv, 0.99, 0.95)
        torch.cuda.synchronize()
        u, e = compare(f"gae {T}x{B}", got, want, 0)
        errs["gae"] = (max(errs["gae"][0], u), max(errs["gae"][1], e))
        log(f"check gae T={T} B={B}: exact (max {u} ulp)")
    for T, B in ((1, 1), (125, 160), (128, 4096), (125, 160 + 3), (0, 5)):
        r, _, d, lv = gae_inputs(T, B, seed=T * B + 1)
        got = gae_ops.discounted_returns_cuda(r, d, lv, gamma=0.99)
        want = gae_ops.discounted_returns_ref(r, d, lv, 0.99)
        torch.cuda.synchronize()
        u, e = compare(f"discounted_returns {T}x{B}", [got], [want], 0)
        key = "discounted_returns"
        errs[key] = (max(errs[key][0], u), max(errs[key][1], e))
        log(f"check {key} T={T} B={B}: exact (max {u} ulp)")

    gen = torch.Generator(device="cuda").manual_seed(0)

    def exact(name, got, want):
        for k in want:
            assert got[k].dtype == want[k].dtype and torch.equal(
                got[k], want[k]), f"{name}: leaf {k} differs"

    for cap, n, start in ((17, 5, 15), (12, 12, 7), (8, 11, 3), (1, 1, 0),
                          (1, 3, 0), (CAP, 20000, CAP - 7000)):
        for kinds in (MIXED_LEAVES, None):
            storage = ring_leaves(cap, gen, kinds)
            batch = ring_leaves(n, gen, kinds)
            want = ring_ops.ring_insert_ref(
                {k: v.clone() for k, v in storage.items()}, batch, start)
            got = ring_ops.ring_insert(storage, batch, start, impl="cuda")
            torch.cuda.synchronize()
            exact(f"ring_insert cap={cap} n={n}", got, want)
        log(f"check ring_insert cap={cap} N={n} start={start}: exact")
    for cap, B in ((17, 6), (1, 1), (CAP, 256)):
        storage = ring_leaves(cap, gen, MIXED_LEAVES)
        idx = torch.randint(0, cap, (B,), generator=gen, device="cuda",
                            dtype=torch.int32)
        idx[0] = cap + 5 if B > 1 else idx[0]    # clamped into the ring
        if B > 1:
            idx[1] = -1                          # counts from the end
        got = ring_ops.ring_gather(storage, idx, impl="cuda")
        want = ring_ops.ring_gather_ref(storage, idx)
        torch.cuda.synchronize()
        exact(f"ring_gather cap={cap} B={B}", got, want)
        log(f"check ring_gather cap={cap} B={B}: exact")
    for cap in (1, 2, 1024, CAP):
        tree = random_tree(cap, min(cap, 60000), gen)
        masses = stratified_masses(tree, 256, gen)
        masses[:2] = torch.stack([torch.zeros((), device="cuda"),
                                  tree.total])
        got = tree_ops.sumtree_find_batch(tree, masses, impl="cuda")
        want = tree_ops.sumtree_find_batch_ref(tree, masses)
        torch.cuda.synchronize()
        assert torch.equal(got, want), f"sumtree_find cap={cap} differs"
        for B, consecutive in ((256, False), (20000, True)):
            if consecutive:
                idx = (torch.arange(B, device="cuda") + cap // 3) % cap
            else:
                idx = torch.randint(0, cap, (B,), generator=gen,
                                    device="cuda")
                idx[-B // 4:] = idx[0]           # duplicates: last one wins
                # one from the end, its twin, and two that are dropped
                idx[1:5] = torch.tensor([-1, cap - 1, cap, -cap - 1])
            idx = idx.to(torch.int32)
            vals = torch.rand(B, generator=gen, device="cuda")
            want = SumTree.of(tree.flat.clone())
            tree_ops.sumtree_update_ref(want, idx, vals)
            tree_ops.sumtree_update(tree, idx, vals, impl="cuda")
            torch.cuda.synchronize()
            assert torch.equal(tree.flat, want.flat), (
                f"sumtree_update cap={cap} B={B} differs")
            assert bool((tree.winner == -1).all()), "scratch not reset"
        log(f"check sumtree_find/sumtree_update cap={cap}: exact")
    check_lm_kernels(errs, gen)

    # 4. main path
    runs = {}

    def counted(label, fn):
        kernels.reset_launch_counts()
        out = fn()
        torch.cuda.synchronize()
        runs[label] = kernels.launch_counts()
        log(f"main path [{label}]: launches {runs[label]}")
        return out

    def cli(argv):
        """The train CLI's printed logs (and its result, kept in
        ``cli.result``)."""
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            cli.result = train.main(argv)
        return [json.loads(line) for line in buf.getvalue().splitlines()]

    def check_logs(label, logs, iters, samples):
        assert len(logs) == iters, f"{label}: {len(logs)} logs"
        for lg in logs:
            lg = lg if isinstance(lg, dict) else lg.as_dict()
            assert lg["samples"] == samples, f"{label}: {lg}"
            for k in ("mean_return", "collect_time", "learn_time"):
                assert math.isfinite(lg[k]), f"{label}: {k} {lg}"
            log(f"  {label} it {lg['iteration']}: "
                f"mean_return {lg['mean_return']:.4f} "
                f"collect {lg['collect_time']:.3f} s "
                f"(serial {lg['collect_time_serial']:.3f} s) "
                f"learn {lg['learn_time']:.3f} s samples {lg['samples']}")

    def zero_counts(**nonzero):
        """Launch counts: ``nonzero`` as given, every other kernel 0."""
        return {**{k: 0 for k in kernels.KERNELS}, **nonzero}

    n, per, h = 10, 16, 125
    logs = counted("cheetah N=10", lambda: cli(
        ["--mode", "rl", "--env", "cheetah", "--algo", "ppo",
         "--num-samplers", str(n), "--global-batch", str(n * per),
         "--horizon", str(h), "--iterations", "3"]))
    check_logs("cheetah N=10", logs, 3, n * per * h)
    assert runs["cheetah N=10"] == zero_counts(cheetah_step=3 * n * h,
                                               gae=3)

    vec = counted("cheetah vector B=4096", lambda: run(ExperimentSpec(
        env="cheetah", algo="ppo", schedule=Schedule(
            env_batch=4096, horizon=128, iterations=2))))
    check_logs("cheetah vector", vec.logs, 2, 4096 * 128)
    assert runs["cheetah vector B=4096"] == zero_counts(
        cheetah_step=2 * 128, gae=2)

    pend = counted("pendulum N=10", lambda: run(ExperimentSpec(
        env="pendulum", algo="ppo", schedule=Schedule(
            num_samplers=n, global_batch=n * per, horizon=h,
            iterations=2))))
    check_logs("pendulum N=10", pend.logs, 2, n * per * h)
    assert runs["pendulum N=10"] == zero_counts(pendulum_step=2 * n * h,
                                                gae=2)
    for res in (vec, pend):
        for p in res.params.parameters():
            assert torch.isfinite(p).all(), "non-finite weights"

    updates, n_leaves = 4, len(CHEETAH_LEAVES)
    logs = counted("sac cheetah N=10 prioritized", lambda: cli(
        ["--env", "cheetah", "--algo", "sac", "--buffer", "prioritized",
         "--num-samplers", str(n), "--global-batch", str(n * per),
         "--horizon", str(h), "--iterations", "3",
         "--replay-capacity", "1000000", "--replay-batch", "256"]))
    check_logs("sac cheetah N=10 prioritized", logs, 3, n * per * h)
    assert runs["sac cheetah N=10 prioritized"] == zero_counts(
        cheetah_step=3 * n * h, ring_insert=3 * n_leaves,
        ring_gather=3 * n_leaves * updates, sumtree_find=3 * updates,
        sumtree_update=3 * (1 + updates)), runs
    ring, tree, max_p = cli.result.runner.plane_state[0]
    assert tree.capacity == CAP and ring.size == 3 * n * per * h
    assert int((tree.levels[0] > 0).sum()) == ring.size
    total = float(tree.total)
    assert math.isclose(total, float(tree.levels[0].double().sum()),
                        rel_tol=1e-4), total
    assert math.isfinite(float(max_p)) and float(max_p) >= 1.0
    log(f"  sac prioritized: ring {ring.size} of {CAP}, tree total "
        f"{total:.6g}, max priority {float(max_p):.6g}")
    sac_runs = [cli.result]

    sac_pend = counted("sac pendulum N=10 uniform", lambda: run(
        ExperimentSpec(env="pendulum", algo="sac", buffer="uniform",
                       buffer_kwargs={"capacity": 1_000_000,
                                      "batch_size": 256},
                       schedule=Schedule(num_samplers=n,
                                         global_batch=n * per, horizon=h,
                                         iterations=2))))
    check_logs("sac pendulum N=10 uniform", sac_pend.logs, 2, n * per * h)
    assert sac_pend.logs[-1].mean_return != 0.0, "no pendulum episode ended"
    assert runs["sac pendulum N=10 uniform"] == zero_counts(
        pendulum_step=2 * n * h, ring_insert=2 * n_leaves,
        ring_gather=2 * n_leaves * updates), runs
    sac_runs.append(sac_pend)
    for res in sac_runs:
        for p in res.params.parameters():
            assert torch.isfinite(p).all(), "non-finite SAC weights"

    # slice 3: cart-pole, TRPO and DDPG through the train CLI
    def finite_params(label):
        for p in cli.result.params.parameters():
            assert torch.isfinite(p).all(), f"{label}: non-finite weights"

    label = "ppo cartpole N=10"
    logs = counted(label, lambda: cli(
        ["--env", "cartpole", "--algo", "ppo", "--num-samplers", str(n),
         "--global-batch", str(n * per), "--horizon", str(h),
         "--iterations", "3"]))
    check_logs(label, logs, 3, n * per * h)
    assert all(lg["mean_return"] > 0.0 for lg in logs), "no pole fell"
    assert runs[label] == zero_counts(cartpole_step=3 * n * h, gae=3), runs
    finite_params(label)

    label = "ppo cartpole vector B=4096"
    logs = counted(label, lambda: cli(
        ["--env", "cartpole", "--algo", "ppo", "--env-batch", "4096",
         "--horizon", "128", "--iterations", "2"]))
    check_logs(label, logs, 2, 4096 * 128)
    assert all(lg["mean_return"] > 0.0 for lg in logs), "no pole fell"
    assert runs[label] == zero_counts(cartpole_step=2 * 128, gae=2), runs
    finite_params(label)

    label = "trpo cheetah N=10"
    logs = counted(label, lambda: cli(
        ["--env", "cheetah", "--algo", "trpo", "--num-samplers", str(n),
         "--global-batch", str(n * per), "--horizon", str(h),
         "--iterations", "3"]))
    check_logs(label, logs, 3, n * per * h)
    assert runs[label] == zero_counts(cheetah_step=3 * n * h, gae=3), runs
    assert cli.result.runner.opt_state is None
    finite_params(label)

    label = "ddpg cheetah N=10 prioritized"
    logs = counted(label, lambda: cli(
        ["--env", "cheetah", "--algo", "ddpg", "--buffer", "prioritized",
         "--num-samplers", str(n), "--global-batch", str(n * per),
         "--horizon", str(h), "--iterations", "3",
         "--replay-capacity", "1000000", "--replay-batch", "256"]))
    check_logs(label, logs, 3, n * per * h)
    assert runs[label] == zero_counts(
        cheetah_step=3 * n * h, ring_insert=3 * n_leaves,
        ring_gather=3 * n_leaves * updates, sumtree_find=3 * updates,
        sumtree_update=3 * (1 + updates)), runs
    ring, tree, max_p = cli.result.runner.plane_state[0]
    assert tree.capacity == CAP and ring.size == 3 * n * per * h
    assert int((tree.levels[0] > 0).sum()) == ring.size
    assert math.isclose(float(tree.total),
                        float(tree.levels[0].double().sum()), rel_tol=1e-4)
    assert math.isfinite(float(max_p)) and float(max_p) >= 1.0
    finite_params(label)
    log(f"  ddpg prioritized: ring {ring.size} of {CAP}, tree total "
        f"{float(tree.total):.6g}, max priority {float(max_p):.6g}")

    # slice 4: LM serving, hymba-1.5b and falcon-mamba-7b
    run_a = lm_serve_runs(counted, runs, zero_counts)

    # 5. reference: kernels vs plain versions end to end on small runs
    def cuda_vs_ref(label, spec, plane=lambda res: []):
        """Run ``spec`` with the kernels and with the plain versions; the
        kernels must have launched only in the first, episodes must have
        ended in every iteration, and the final weights (and
        ``plane(result)``'s tensors) must be bit for bit equal."""
        finals = {}
        for mode in ("cuda", "ref"):
            kernels.reset_launch_counts()
            res = run(dataclasses.replace(spec, kernels=mode))
            torch.cuda.synchronize()
            counts = kernels.launch_counts()
            assert (sum(counts.values()) > 0) == (mode == "cuda"), counts
            finals[mode] = ([p.detach().clone()
                             for p in res.params.parameters()]
                            + [x.clone() for x in plane(res)],
                            [lg.mean_return for lg in res.logs])
        (got, got_ret), (want, want_ret) = finals["cuda"], finals["ref"]
        assert got_ret == want_ret and all(r != 0.0 for r in got_ret), (
            label, got_ret, want_ret)
        assert all(torch.equal(a, b) for a, b in zip(got, want)), (
            f"{label}: cuda vs ref differ")
        log(f"reference: {label}, cuda vs ref kernels: {len(got)} tensors "
            f"bit for bit equal, mean returns {got_ret}")

    def replay_plane(res):
        """The replay ring's leaves, the tree and the max priority."""
        ring, tree, max_p = res.runner.plane_state[0]
        return [tree.flat, max_p, *ring.storage.values()]

    small = Schedule(num_samplers=2, global_batch=8, horizon=40,
                     iterations=2)
    cuda_vs_ref("PPO cheetah", ExperimentSpec(
        env="cheetah", algo="ppo", env_kwargs={"max_episode_steps": 25},
        schedule=small))
    cuda_vs_ref("SAC prioritized cheetah", ExperimentSpec(
        env="cheetah", algo="sac", buffer="prioritized",
        buffer_kwargs={"capacity": 4096, "batch_size": 64},
        env_kwargs={"max_episode_steps": 25}, schedule=small), replay_plane)
    cuda_vs_ref("TRPO cartpole", ExperimentSpec(
        env="cartpole", algo="trpo", schedule=Schedule(
            num_samplers=2, global_batch=16, horizon=60, iterations=2)))
    cuda_vs_ref("DDPG prioritized pendulum", ExperimentSpec(
        env="pendulum", algo="ddpg", buffer="prioritized",
        buffer_kwargs={"capacity": 4096, "batch_size": 64},
        env_kwargs={"max_episode_steps": 25}, schedule=small), replay_plane)
    lm_report = lm_cuda_vs_ref(run_a)
    del run_a

    # 6. timings at the main path's shapes (10 samplers of 16 envs), and at
    # the vector path's
    timings = {}
    for label, B, T, gB in (("main", per, h, n * per),
                            ("vector", 4096, 128, 4096)):
        for name in ("pendulum", "cartpole", "cheetah"):
            state, a, rs, ro, p = env_inputs(name, B, horizon, seed=7)
            params = dict(max_episode_steps=horizon, reward_scale=1.0, **p)
            wrapper = kernels.KERNELS[f"{name}_step"]
            out = wrapper(state, a, rs, ro, **params)
            # the kernel reads a row's reset candidates only where its
            # episode ends, so only those rows' candidates count
            resets = int(out[3].sum())
            timings[label, f"{name}_step"] = measure(
                f"{name}_step", f"B={B}", B,
                nbytes(*state, a, *leaves(out))
                + nbytes(*rs, ro) * resets // B,
                lambda: wrapper(state, a, rs, ro, **params),
                lambda: env_ref.STEP_BATCH_REF[name](state, a, rs, ro,
                                                     **params), 200, 50)
        r, v, d, lv = gae_inputs(T, gB, seed=3)
        adv, ret = gae_ops.gae_cuda(r, v, d, lv, gamma=0.99, lam=0.95)
        timings[label, "gae"] = measure(
            "gae", f"T={T} B={gB}", T * gB, nbytes(r, v, d, lv, adv, ret),
            lambda: gae_ops.gae_cuda(r, v, d, lv, gamma=0.99, lam=0.95),
            lambda: gae_ops.gae_ref(r, v, d, lv, 0.99, 0.95), 200, 5)
        ret = gae_ops.discounted_returns_cuda(r, d, lv, gamma=0.99)
        timings[label, "discounted_returns"] = measure(
            "discounted_returns", f"T={T} B={gB}", T * gB,
            nbytes(r, d, lv, ret),
            lambda: gae_ops.discounted_returns_cuda(r, d, lv, gamma=0.99),
            lambda: gae_ops.discounted_returns_ref(r, d, lv, 0.99), 200, 5)
    # the replay path at the SAC cheetah run's shapes: 20,000 transitions
    # of 144 B inserted into 2^20 slots, 256 drawn from 60,000 filled ones
    n_rows, B = n * per * h, 256
    storage = ring_leaves(CAP, gen)
    batch = ring_leaves(n_rows, gen)
    start = CAP - 7000
    pos = (torch.arange(n_rows, device="cuda") + start) % CAP
    row_bytes = nbytes(*(v[:1] for v in storage.values()))
    timings["main", "ring_insert"] = measure(
        "ring_insert", f"N={n_rows} cap={CAP} leaves={n_leaves}", 0,
        2 * n_rows * row_bytes,
        lambda: ring_ops.ring_insert(storage, batch, start, impl="cuda"),
        lambda: ring_ops.ring_insert_ref(storage, batch, start), 50, 20,
        library=lambda: [storage[k].index_copy_(0, pos, batch[k])
                         for k in storage])
    idx = torch.randint(0, 3 * n_rows, (B,), generator=gen, device="cuda",
                        dtype=torch.int32)
    idx64 = idx.to(torch.int64)
    timings["main", "ring_gather"] = measure(
        "ring_gather", f"B={B} cap={CAP} leaves={n_leaves}", 0,
        # each distinct row read once, each sampled row written once
        (int(torch.unique(idx).numel()) + B) * row_bytes + nbytes(idx),
        lambda: ring_ops.ring_gather(storage, idx, impl="cuda"),
        lambda: ring_ops.ring_gather_ref(storage, idx), 200, 50,
        library=lambda: [torch.index_select(v, 0, idx64)
                         for v in storage.values()])
    del storage, batch
    tree = random_tree(CAP, 3 * n_rows, gen)
    masses = stratified_masses(tree, B, gen)
    found = tree_ops.sumtree_find_cuda(tree, masses)
    nodes = tree_path_nodes(found, CAP)
    timings["main", "sumtree_find"] = measure(
        "sumtree_find", f"B={B} cap={CAP}", B * (CAP.bit_length() - 1),
        4 * sum(nodes) + nbytes(masses, found),
        lambda: tree_ops.sumtree_find_cuda(tree, masses),
        lambda: tree_ops.sumtree_find_batch_ref(tree, masses), 200, 50)
    for label, upd_idx in (
            ("main", found),
            ("add", ((torch.arange(n_rows, device="cuda") + start) % CAP)
             .to(torch.int32))):
        vals = torch.rand(upd_idx.shape[0], generator=gen, device="cuda")
        nodes = tree_path_nodes(upd_idx, CAP)
        # the plain version picks the winners of duplicate indices with a
        # boolean mask, which syncs with the host: no graph capture
        timings[label, "sumtree_update"] = measure(
            "sumtree_update", f"B={upd_idx.shape[0]} cap={CAP}", sum(nodes),
            nbytes(upd_idx, vals) + tree_update_bytes(upd_idx, CAP),
            lambda: tree_ops.sumtree_update_cuda(tree, upd_idx, vals),
            lambda: tree_ops.sumtree_update_ref(tree, upd_idx, vals), 50, 10,
            plain_graph=False)
    time_lm_kernels(timings, gen)
    entries = []
    for name in kernels.KERNELS:
        entries.append({
            "name": name, "route": "cuda", "source": SOURCES[name],
            "replaces": REPLACES[name],
            "launches": sum(c[name] for c in runs.values()),
            "max_abs_err": errs[name][1], "max_ulp": errs[name][0],
            **timings["main", name]})
    log(json.dumps({"kernels_at_vector_shapes": [
        {"name": name, **t} for (label, name), t in timings.items()
        if label == "vector"]}))
    log(json.dumps({"kernels_at_long_request": [
        {"name": name, **t} for (label, name), t in timings.items()
        if label == "long"]}))
    log(json.dumps({"lm_cuda_vs_ref": lm_report}))
    log(json.dumps({"kernels_at_add_shapes": [
        {"name": name, **t} for (label, name), t in timings.items()
        if label == "add"]}))
    log(json.dumps({"launches_by_run": runs}))
    print(json.dumps({"kernels": entries}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
