#!/usr/bin/env python3
"""Smoke test of the PyTorch port (``src/repro_torch``) on one CUDA card.

    python3 chip_smoke.py

Phases, each of which raises (and so exits non-zero) on failure:

1. device: the card's name and power limit from ``nvidia-smi``;
2. build: every CUDA kernel of the slice, compiled from ``src/repro_torch/
   kernels/csrc`` (one ``nvcc`` per source, all at once);
3. kernels: each kernel's wrapper on card tensors at the shapes the main
   path gives it (and a larger env batch with a third of the rows at their
   last step, so the reset select fires), held against its plain PyTorch
   version on the same inputs: ``t``/``done`` and GAE exactly, env float
   leaves within 4 ulp (or 4 ulp of the leaf's magnitude near zero);
4. main path, each run with the launch counts set to 0 just before it and
   read just after: PPO on cheetah through the train CLI with the paper's
   budget (10 samplers × 16 envs × 125 steps = 20,000 samples per
   iteration, 3 iterations), the vector path (one 4096-env batch, 128
   steps, 2 iterations), and the CLI's default env, pendulum (10 × 16 ×
   125, 2 iterations). Every log must be finite with the expected sample
   count, and each kernel's count must equal the steps and learns the run
   made;
5. reference: a small run with the kernels and the same run with the plain
   versions (``kernels="ref"``) must end with the same weights;
6. timings: each kernel's median time per call (CUDA events around
   back-to-back calls, host launch included) and its device time alone
   (calls captured in a CUDA graph and replayed), the same two for its
   plain version, and the least time the card could take (bytes at
   3.35 TB/s or float32 operations at 67 TFLOP/s, H100 SXM data sheet;
   an env step's reset candidates count only for the rows whose episode
   ends, the only rows whose candidates the kernel reads), printed as one
   JSON line ``{"kernels": [...]}``.

The last line is ``{"ok": true, "device": {...}}``; it is printed only when
every phase passed. Without a CUDA device the script exits non-zero at once.
"""
from __future__ import annotations

import contextlib
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
ENV_ULPS = 4

# float operations per instance / element, counted from the kernel bodies
# (adds, multiplies, divides, transcendentals and clamps, one each)
OPS = {"pendulum_step": 30, "cheetah_step": 150, "gae": 7}
REPLACES = {
    "pendulum_step": "src/repro/kernels/env_step/env_step_pallas.py:102",
    "cheetah_step": "src/repro/kernels/env_step/env_step_pallas.py:254",
    "gae": "src/repro/kernels/gae/gae_pallas.py:117",
}
SOURCES = {
    "pendulum_step": "src/repro_torch/kernels/csrc/env_step.cu",
    "cheetah_step": "src/repro_torch/kernels/csrc/env_step.cu",
    "gae": "src/repro_torch/kernels/csrc/gae.cu",
}


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


def measure(kernel, shape, n, moved, fn, plain, reps, plain_reps):
    """Timings of one kernel and its plain version on the same inputs:
    ``ms``/``plain_ms`` per call as the main path makes it (host launch
    included), ``device_ms``/``plain_device_ms`` from graph replay."""
    b_ms, b_by = bound(kernel, n, moved)
    return {"ms": time_ms(fn, reps), "plain_ms": time_ms(plain, plain_reps),
            "device_ms": graph_ms(fn, reps),
            "plain_device_ms": graph_ms(plain, plain_reps),
            "bound_ms": b_ms, "bound_by": b_by, "shape": shape,
            "bytes": moved}


def nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


def bound(kernel, n, moved):
    """(bound_ms, bound_by) for ``n`` instances/elements moving ``moved``
    bytes."""
    t_bytes = moved / HBM_BYTES_PER_S * 1e3
    t_ops = OPS[kernel] * n / F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


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
    for T, B in ((125, 160), (128, 4096), (125, 160 + 3)):
        r, v, d, lv = gae_inputs(T, B, seed=T * B)
        got = gae_ops.gae_cuda(r, v, d, lv, gamma=0.99, lam=0.95)
        want = gae_ops.gae_ref(r, v, d, lv, 0.99, 0.95)
        torch.cuda.synchronize()
        u, e = compare(f"gae {T}x{B}", got, want, 0)
        errs["gae"] = (max(errs["gae"][0], u), max(errs["gae"][1], e))
        log(f"check gae T={T} B={B}: exact (max {u} ulp)")

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
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            train.main(argv)
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

    n, per, h = 10, 16, 125
    logs = counted("cheetah N=10", lambda: cli(
        ["--mode", "rl", "--env", "cheetah", "--algo", "ppo",
         "--num-samplers", str(n), "--global-batch", str(n * per),
         "--horizon", str(h), "--iterations", "3"]))
    check_logs("cheetah N=10", logs, 3, n * per * h)
    assert runs["cheetah N=10"] == {"pendulum_step": 0,
                                    "cheetah_step": 3 * n * h, "gae": 3}

    vec = counted("cheetah vector B=4096", lambda: run(ExperimentSpec(
        env="cheetah", algo="ppo", schedule=Schedule(
            env_batch=4096, horizon=128, iterations=2))))
    check_logs("cheetah vector", vec.logs, 2, 4096 * 128)
    assert runs["cheetah vector B=4096"] == {"pendulum_step": 0,
                                             "cheetah_step": 2 * 128,
                                             "gae": 2}

    pend = counted("pendulum N=10", lambda: run(ExperimentSpec(
        env="pendulum", algo="ppo", schedule=Schedule(
            num_samplers=n, global_batch=n * per, horizon=h,
            iterations=2))))
    check_logs("pendulum N=10", pend.logs, 2, n * per * h)
    assert runs["pendulum N=10"] == {"pendulum_step": 2 * n * h,
                                     "cheetah_step": 0, "gae": 2}
    for res in (vec, pend):
        for p in res.params.parameters():
            assert torch.isfinite(p).all(), "non-finite weights"

    # 5. reference: kernels vs plain versions end to end on a small run
    small = Schedule(num_samplers=2, global_batch=8, horizon=40,
                     iterations=2)
    finals = {}
    for mode in ("cuda", "ref"):
        res = run(ExperimentSpec(env="cheetah", algo="ppo", kernels=mode,
                                 env_kwargs={"max_episode_steps": 25},
                                 schedule=small))
        finals[mode] = [p.detach().clone() for p in res.params.parameters()]
        finals[mode + " return"] = [lg.mean_return for lg in res.logs]
    assert finals["cuda return"] == finals["ref return"], finals
    assert all(r != 0.0 for r in finals["cuda return"]), "no episode ended"
    diff = max(float((a - b).abs().max())
               for a, b in zip(finals["cuda"], finals["ref"]))
    log(f"reference: cuda vs ref kernels, mean returns "
        f"{finals['cuda return']}, final weights max abs diff {diff}")
    assert diff <= 1e-5, diff

    # 6. timings at the main path's shapes (10 samplers of 16 envs), and at
    # the vector path's
    timings = {}
    for label, B, T, gB in (("main", per, h, n * per),
                            ("vector", 4096, 128, 4096)):
        for name in ("pendulum", "cheetah"):
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
    entries = []
    for name in kernels.KERNELS:
        entries.append({
            "name": name, "route": "cuda", "source": SOURCES[name],
            "replaces": REPLACES[name],
            "launches": sum(c[name] for c in runs.values()),
            "max_abs_err": errs[name][1], "max_ulp": errs[name][0],
            **timings["main", name], "library_ms": None})
    log(json.dumps({"kernels_at_vector_shapes": [
        {"name": name, **t} for (label, name), t in timings.items()
        if label == "vector"]}))
    log(json.dumps({"launches_by_run": runs}))
    print(json.dumps({"kernels": entries}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
