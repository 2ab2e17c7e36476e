"""The port's policy serving plane on the CPU (``repro_torch.serve``): each
case of ``tests/test_serve_plane.py`` on the port's ``PolicyServer``, with
a standard-normal ``noise`` draw where the reference takes a PRNG key —
dynamic batching bit for bit, deadline dispatch, backpressure, draining,
live hot-swap from a spawned process, the checkpoint -> serve path — and
the ``serve_policy`` CLI."""
import concurrent.futures
import copy
import glob
import json
import multiprocessing
import os
import subprocess
import sys
import time
import uuid

import numpy as np
import pytest
import torch

import torch_serve_child
from repro_torch import checkpoint, convert, registry
from repro_torch.core.ipc import ChannelSpec, ParamsChannel, param_leaves
from repro_torch.experiment import ExperimentSpec, Schedule, run
from repro_torch.serve import (
    PolicyServer,
    ServerClosed,
    ServerOverloaded,
    ServingStats,
    load_policy,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _policy(env_name="pendulum", algo_name="ppo", seed=0):
    env = registry.make("env", env_name)
    algo = registry.make("algo", algo_name)
    params, _ = algo.init(torch.Generator().manual_seed(seed), env, "cpu")
    return env, algo, params


def _obs(env, n, seed=0):
    return np.random.RandomState(seed).randn(
        n, env.obs_dim).astype(np.float32)


def _default_noise(server, rid):
    return np.random.default_rng([server.seed, rid]).standard_normal(
        server.env.act_dim, dtype=np.float32)


# ===================================================== batching bitwise
def test_batched_act_bitwise_equals_single_request():
    """A request's action is identical whether it rides a full batch, a
    deadline-expired partial batch, or the single-request reference path:
    the same fixed-width path, rows independent."""
    env, algo, params = _policy()
    observations = _obs(env, 4)

    with PolicyServer(env, algo, params, slots=4,
                      deadline_ms=500.0) as server:
        pending = [server.submit(o) for o in observations]
        batched = [p.result(30.0) for p in pending]
        refs = [server.reference_act(observations[i],
                                     _default_noise(server, i))
                for i in range(4)]
        assert server.stats.dispatches == 1   # they really shared a batch
        assert all(np.array_equal(p.noise, _default_noise(server, i))
                   for i, p in enumerate(pending))

    # a fresh server (request ids restart at 0 -> the same draws), one at
    # a time, each its own partial-batch dispatch
    with PolicyServer(env, algo, params, slots=4,
                      deadline_ms=1.0) as server:
        singles = [server.act(o, timeout=30.0) for o in observations]
        assert server.stats.dispatches == 4

    for i in range(4):
        assert np.array_equal(batched[i], singles[i])      # bitwise
        assert np.array_equal(batched[i], refs[i])


@pytest.mark.parametrize("algo_name", ["ppo", "trpo", "ddpg", "sac"])
def test_explicit_noise_and_extras_algos(algo_name):
    """Any registered algo's act() serves; an explicit per-request draw
    gives the same action every time, and it is the algorithm's own act on
    that draw."""
    env, algo, params = _policy(algo_name=algo_name)
    obs = _obs(env, 1)[0]
    noise = np.random.RandomState(123).randn(env.act_dim).astype(np.float32)
    with PolicyServer(env, algo, params, slots=2,
                      deadline_ms=1.0) as server:
        action = server.act(obs, noise=noise, timeout=30.0)
        again = server.act(obs, noise=noise, timeout=30.0)
    assert np.array_equal(action, again)
    assert action.shape == (env.act_dim,) and action.dtype == np.float32
    with torch.no_grad():
        direct, _ = algo.act(params, torch.from_numpy(obs)[None],
                             torch.from_numpy(noise)[None])
    np.testing.assert_allclose(action, direct[0].numpy(), rtol=1e-6,
                               atol=1e-7)


def test_serves_a_half_precision_env_with_float32_requests():
    """An env with bfloat16 obs still takes float32 requests at submit, as
    the reference does (``np.asarray(obs, np.float32)``)."""
    env = registry.make("env", "cheetah", dtype="bfloat16")
    algo = registry.make("algo", "ppo")
    params, _ = algo.init(torch.Generator().manual_seed(0), env, "cpu")
    with PolicyServer(env, algo, params, slots=2,
                      deadline_ms=1.0) as server:
        obs = _obs(env, 1)[0].astype(np.float64)
        action = server.act(obs, timeout=30.0)
        assert np.array_equal(action, server.reference_act(
            obs, _default_noise(server, 0)))
    assert action.dtype == np.float32 and np.isfinite(action).all()


# ==================================================== deadline dispatch
def test_deadline_triggers_partial_batch():
    """Fewer requests than slots still dispatch once the oldest request's
    deadline expires — nothing waits for a batch that never fills."""
    env, algo, params = _policy()
    with PolicyServer(env, algo, params, slots=8,
                      deadline_ms=150.0) as server:
        t0 = time.perf_counter()
        pending = [server.submit(o) for o in _obs(env, 3)]
        actions = [p.result(30.0) for p in pending]
        elapsed = time.perf_counter() - t0
        snap = server.snapshot()
    assert len(actions) == 3
    assert snap["dispatches"] == 1            # one partial batch
    assert snap["batch_occupancy"] == pytest.approx(3 / 8)
    assert snap["wasted_slot_steps"] == 5
    assert elapsed >= 0.15


def test_full_batch_dispatches_before_deadline():
    env, algo, params = _policy()
    with PolicyServer(env, algo, params, slots=4,
                      deadline_ms=10_000.0) as server:
        pending = [server.submit(o) for o in _obs(env, 4)]
        for p in pending:
            p.result(30.0)                     # would hang if we waited
        assert server.stats.dispatches == 1


def test_backlog_past_deadline_dispatches_full_batches():
    """Past the oldest rider's deadline the dispatcher still takes what is
    already queued: a backlog older than the deadline goes out in full
    batches, not one request a dispatch (the reference's rule stops at the
    deadline and would dispatch this backlog 12 times)."""
    env, algo, params = _policy()
    server = PolicyServer(env, algo, params, slots=4, deadline_ms=5.0)
    pending = [server.submit(o) for o in _obs(env, 12)]
    time.sleep(0.05)                          # every rider is past due
    server.start()
    for p in pending:
        p.result(30.0)
    snap = server.snapshot()
    server.close()
    assert snap["dispatches"] == 3
    assert snap["batch_occupancy"] == 1


# ========================================================== backpressure
def test_overload_raises_and_inflight_requests_survive():
    """A full admission queue rejects new work with ServerOverloaded;
    everything already admitted still completes (admission is open before
    start(), so the queue fills deterministically)."""
    env, algo, params = _policy()
    server = PolicyServer(env, algo, params, slots=2, deadline_ms=5.0,
                          queue_cap=4)
    pending = []
    with pytest.raises(ServerOverloaded, match="backpressure"):
        for o in _obs(env, 16):
            pending.append(server.submit(o))
    assert len(pending) == 4                   # exactly queue_cap admitted
    server.start()
    for p in pending:
        assert p.result(30.0).shape == (env.act_dim,)
    server.close()


def test_submit_after_close_raises():
    env, algo, params = _policy()
    server = PolicyServer(env, algo, params, slots=2, deadline_ms=1.0)
    server.start()
    server.close()
    with pytest.raises(ServerClosed):
        server.submit(_obs(env, 1)[0])


@pytest.mark.parametrize("started", [True, False])
def test_close_drains_queued_requests(started):
    """close() completes every admitted request — nothing is dropped, also
    when start() was never called."""
    env, algo, params = _policy()
    server = PolicyServer(env, algo, params, slots=4, deadline_ms=50.0,
                          queue_cap=64)
    if started:
        server.start()
    pending = [server.submit(o) for o in _obs(env, 11)]
    server.close()
    for p in pending:
        assert p.done()
        assert p.action.shape == (env.act_dim,)
    assert server.stats.requests == 11


def test_serves_its_own_copy_of_the_params():
    """The server copies the params it is given: a later change to the
    caller's module does not reach it, and a hot-swap does not reach the
    caller's."""
    env, algo, params = _policy()
    obs, noise = _obs(env, 1)[0], np.ones(env.act_dim, np.float32)
    server = PolicyServer(env, algo, params, slots=2)
    before = server.reference_act(obs, noise)
    with torch.no_grad():
        for p in params.parameters():
            p.mul_(2.0)
    assert np.array_equal(server.reference_act(obs, noise), before)
    server.close()


# ============================================================== hot-swap
def _scaled(params, scale):
    out = copy.deepcopy(params)
    with torch.no_grad():
        for p in out.parameters():
            p.mul_(scale)
    return out


def test_hot_swap_mid_traffic_from_concurrent_process():
    """A ParamsChannel.publish from a separate process is picked up
    mid-traffic: no request is dropped, no action is torn (every action
    bit for bit matches the params version its completion reports), and
    the server ends on the published version."""
    env, algo, params = _policy()
    leaves = param_leaves(params)
    channel = ParamsChannel.create(
        leaves, f"walle-{os.getpid()}-test-{uuid.uuid4().hex[:6]}")
    channel.publish(leaves)                        # version 1: the ckpt
    scale = 1.5
    params_v2 = _scaled(params, scale)
    observations = _obs(env, 64)
    try:
        with PolicyServer(env, algo, params, slots=4, deadline_ms=2.0,
                          queue_cap=4096, params_channel=channel) as server:
            assert server.params_version == 1
            ctx = multiprocessing.get_context("spawn")
            proc = ctx.Process(target=torch_serve_child.publish_scaled,
                               args=(channel.spec.to_json(), scale))
            with concurrent.futures.ThreadPoolExecutor(8) as pool:
                pending = [f.result() for f in [
                    pool.submit(server.submit, o)
                    for o in observations[:16]]]
                proc.start()                       # publish concurrently
                # traffic flows until the publish lands, then 16 more
                deadline = time.monotonic() + 30.0
                while (server.params_version < 2
                       and time.monotonic() < deadline):
                    pending.append(server.submit(
                        observations[len(pending) % len(observations)]))
                    time.sleep(0.002)
                assert server.params_version == 2
                pending += [f.result() for f in [
                    pool.submit(server.submit, o)
                    for o in observations[16:32]]]
            results = [p.result(30.0) for p in pending]
            proc.join(30.0)
            assert proc.exitcode == 0
            assert {p.params_version for p in pending} == {1, 2}
            with PolicyServer(env, algo, params, slots=4) as ref_v1, \
                 PolicyServer(env, algo, params_v2, slots=4) as ref_v2:
                for p, action in zip(pending, results):
                    ref = ref_v1 if p.params_version == 1 else ref_v2
                    assert np.array_equal(action,
                                          ref.reference_act(p.obs, p.noise))
            assert all(p.done() for p in pending)  # nothing dropped
    finally:
        channel.close(unlink=True)


def test_channel_spec_json_roundtrip():
    leaves = [np.zeros((2, 3), np.float32), np.zeros((4,), np.float64)]
    chan = ParamsChannel.create(
        leaves, f"walle-{os.getpid()}-json-{uuid.uuid4().hex[:6]}")
    try:
        spec = ChannelSpec.from_json(chan.spec.to_json())
        assert spec == chan.spec
    finally:
        chan.close(unlink=True)


def test_leaf_count_mismatch_rejected():
    env, algo, params = _policy()
    chan = ParamsChannel.create(
        [np.zeros((1,), np.float32)],
        f"walle-{os.getpid()}-mism-{uuid.uuid4().hex[:6]}")
    try:
        with pytest.raises(ValueError, match="leaves"):
            PolicyServer(env, algo, params, params_channel=chan)
    finally:
        chan.close(unlink=True)


def test_reference_layout_channel_rejected():
    """A channel in the reference's leaf order and (in, out) layout (what
    a JAX learner publishes) has the policy's leaf count but not its
    shapes: refused by name, not served. Attached from its spec, the
    server closes it again."""
    env, algo, params = _policy()
    tree = convert.params_to_jax(params)
    jax_order = [a for _, a in checkpoint.io._leaves(tree)]
    assert len(jax_order) == len(param_leaves(params))
    chan = ParamsChannel.create(
        jax_order, f"walle-{os.getpid()}-jax-{uuid.uuid4().hex[:6]}")
    try:
        with pytest.raises(ValueError, match="module order"):
            PolicyServer(env, algo, params, params_channel=chan.spec)
    finally:
        chan.close(unlink=True)


# ============================================== checkpoint -> serve path
def _tiny_spec(algo="ppo"):
    return ExperimentSpec(
        env="pendulum", algo=algo,
        schedule=Schedule(num_samplers=1, global_batch=2, horizon=8,
                          iterations=2, seed=0))


def test_serve_from_checkpoint_end_to_end(tmp_path):
    """train (tiny) -> checkpoint -> load_policy -> serve: the restored
    params equal the trained ones bit for bit, and the served action
    equals the reference path's."""
    spec = _tiny_spec()
    result = run(spec, device="cpu")
    ckpt = str(tmp_path / "ckpt")
    checkpoint.save(ckpt, 2, convert.params_to_jax(result.params),
                    metadata={"mode": "rl", "spec": spec.to_dict()})

    handle = load_policy(ckpt, device="cpu")
    assert handle.spec == spec and handle.step == 2
    assert handle.name == "ppoxpendulum@2"
    for a, b in zip(result.params.parameters(), handle.params.parameters()):
        assert torch.equal(a, b)

    obs = _obs(handle.env, 1)[0]
    noise = np.random.RandomState(7).randn(
        handle.env.act_dim).astype(np.float32)
    with PolicyServer.from_checkpoint(ckpt, device="cpu", slots=2,
                                      deadline_ms=1.0) as server:
        served = server.act(obs, noise=noise, timeout=30.0)
        expect = server.reference_act(obs, noise)
    assert np.array_equal(served, expect)


def test_load_policy_absent_dir_clear_error(tmp_path):
    absent = str(tmp_path / "no-such-ckpt")
    with pytest.raises(FileNotFoundError) as exc:
        load_policy(absent, device="cpu")
    assert absent in str(exc.value) and "latest_step" in str(exc.value)


def test_load_policy_rejects_specless_checkpoint(tmp_path):
    ckpt = str(tmp_path / "lm")
    checkpoint.save(ckpt, 1, {"w": np.zeros((2,))}, metadata={"mode": "lm"})
    with pytest.raises(ValueError, match="ExperimentSpec"):
        load_policy(ckpt, device="cpu")


def test_load_policy_defaults_to_cuda(tmp_path):
    """Like every entry point of the port, load_policy runs on the CUDA
    device unless asked for the CPU."""
    ckpt = str(tmp_path / "ckpt")
    spec = _tiny_spec()
    params, _ = registry.make("algo", "ppo").init(
        torch.Generator().manual_seed(0), registry.make("env", "pendulum"),
        "cpu")
    checkpoint.save(ckpt, 1, convert.params_to_jax(params),
                    metadata={"mode": "rl", "spec": spec.to_dict()})
    if torch.cuda.is_available():
        assert load_policy(ckpt).params.log_std.is_cuda
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            load_policy(ckpt)


# ================================================== the stats helper
def test_serving_stats_schema_and_percentiles():
    stats = ServingStats(slots=4)
    for ms in (1, 2, 3, 4, 5, 6, 7, 8, 9, 100):
        stats.observe(latency_s=ms / 1e3, queue_wait_s=ms / 2e3)
    stats.observe_batch(4)
    stats.observe_batch(2)
    snap = stats.snapshot()
    assert snap["requests"] == 10 and snap["dispatches"] == 2
    assert snap["latency_ms"]["p50"] == pytest.approx(5.0)
    assert snap["latency_ms"]["p99"] == pytest.approx(100.0)
    assert snap["batch_occupancy"] == pytest.approx(6 / 8)
    assert snap["wasted_slot_steps"] == 2
    with pytest.raises(ValueError, match="occupied"):
        stats.observe_batch(5)


# ========================================================= the CLIs
def test_train_then_serve_policy_cli(tmp_path):
    """``launch.train --ckpt-dir`` then ``launch.serve_policy
    --swap-after``: every request completes, the version advances, the
    exit code is 0 and no shared-memory block is left behind."""
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    ckpt = str(tmp_path / "ckpt")

    def cli(*argv):
        proc = subprocess.Popen([sys.executable, "-m", *argv], cwd=REPO,
                                env=env, stdout=subprocess.PIPE,
                                stderr=subprocess.PIPE, text=True)
        out, err = proc.communicate(timeout=300)
        return proc.pid, proc.returncode, out, err

    _, rc, _, err = cli(
        "repro_torch.launch.train", "--env", "pendulum", "--algo", "ppo",
        "--num-samplers", "1", "--global-batch", "2", "--horizon", "8",
        "--iterations", "2", "--ckpt-dir", ckpt, "--device", "cpu")
    assert rc == 0, err
    assert checkpoint.latest_step(ckpt) == 2
    pid, rc, out, err = cli(
        "repro_torch.launch.serve_policy", "--ckpt", ckpt, "--device", "cpu",
        "--slots", "4", "--requests", "32", "--clients", "4",
        "--swap-after", "8")
    assert rc == 0, err
    assert "hot-swap observed: version 1 -> 2" in err
    snap = json.loads(out)
    assert snap["requests"] >= 32 and snap["params_version"] == 2
    # only this CLI's blocks: another process's leftovers are not its fault
    assert not glob.glob(f"/dev/shm/walle-{pid}-serve-*")
