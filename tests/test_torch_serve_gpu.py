"""The policy serving plane on the card: ``PolicyServer`` on a CUDA device.

Every test here needs a CUDA device and skips without one. The file
imports neither ``jax`` nor ``repro``, so it runs where only PyTorch is
installed:

    PYTHONPATH=src python -m pytest --noconftest -m gpu \
        tests/test_torch_serve_gpu.py

Bounds: all exact. Every dispatch runs the same shapes on the server's
stream (the batch zero-padded to ``slots`` rows), so a request's action is
the same bits whether it rode a full batch, a deadline-expired partial
batch or the single-request reference path; after a hot-swap, each action
is the bits of the version its completion reports.
"""
import concurrent.futures
import copy
import multiprocessing
import os
import time
import uuid

import numpy as np
import pytest
import torch

import torch_serve_child
from repro_torch import kernels, registry
from repro_torch.core.ipc import ParamsChannel, param_leaves
from repro_torch.launch import train
from repro_torch.serve import PolicyServer, load_policy


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _policy(algo_name, device, env_name="cheetah"):
    env = registry.make("env", env_name)
    algo = registry.make("algo", algo_name)
    params, _ = algo.init(torch.Generator().manual_seed(0), env, device)
    return env, algo, params


def _obs(env, n, seed=0):
    return np.random.RandomState(seed).randn(
        n, env.obs_dim).astype(np.float32)


@pytest.mark.gpu
@pytest.mark.parametrize("algo_name", ["ppo", "trpo", "sac", "ddpg"])
@pytest.mark.parametrize("slots", [8, 64])
def test_batched_partial_and_reference_actions_bit_for_bit(cuda, algo_name,
                                                           slots):
    env, algo, params = _policy(algo_name, cuda)
    observations = _obs(env, slots)
    with PolicyServer(env, algo, params, slots=slots,
                      deadline_ms=2_000.0) as server:
        assert server.device.type == "cuda"
        pending = [server.submit(o) for o in observations]
        full = [p.result(60.0) for p in pending]
        assert server.stats.dispatches == 1
        refs = [server.reference_act(p.obs, p.noise) for p in pending]
    # partial batches of 3 (deadline-expired) and batches of one
    with PolicyServer(env, algo, params, slots=slots,
                      deadline_ms=20.0) as server:
        partial = []
        for i in range(0, len(observations), 3):
            ps = [server.submit(o) for o in observations[i:i + 3]]
            partial += [p.result(60.0) for p in ps]
        assert server.stats.snapshot()["batch_occupancy"] < 1.0
    with PolicyServer(env, algo, params, slots=slots,
                      deadline_ms=0.5) as server:
        singles = [server.act(o, timeout=60.0) for o in observations]
    for i in range(slots):
        assert np.array_equal(full[i], refs[i]), i
        assert np.array_equal(full[i], partial[i]), i
        assert np.array_equal(full[i], singles[i]), i


@pytest.mark.gpu
def test_hot_swap_from_a_spawned_process(cuda):
    env, algo, params = _policy("ppo", cuda)
    leaves = param_leaves(params)
    channel = ParamsChannel.create(
        leaves, f"walle-{os.getpid()}-gpu-{uuid.uuid4().hex[:6]}")
    channel.publish(leaves)
    scale = 1.5
    params_v2 = copy.deepcopy(params)
    with torch.no_grad():
        for p in params_v2.parameters():
            p.mul_(scale)
    observations = _obs(env, 256)
    try:
        with PolicyServer(env, algo, params, slots=8, deadline_ms=2.0,
                          queue_cap=4096, params_channel=channel) as server:
            proc = multiprocessing.get_context("spawn").Process(
                target=torch_serve_child.publish_scaled,
                args=(channel.spec.to_json(), scale))
            with concurrent.futures.ThreadPoolExecutor(8) as pool:
                pending = [f.result() for f in [
                    pool.submit(server.submit, o)
                    for o in observations[:64]]]
                proc.start()
                deadline = time.monotonic() + 60.0
                while (server.params_version < 2
                       and time.monotonic() < deadline):
                    pending.append(server.submit(
                        observations[len(pending) % len(observations)]))
                    time.sleep(0.002)
                assert server.params_version == 2
                pending += [f.result() for f in [
                    pool.submit(server.submit, o)
                    for o in observations[64:]]]
            results = [p.result(60.0) for p in pending]
            proc.join(60.0)
            assert proc.exitcode == 0
            assert {p.params_version for p in pending} == {1, 2}
            with PolicyServer(env, algo, params, slots=8) as ref_v1, \
                 PolicyServer(env, algo, params_v2, slots=8) as ref_v2:
                for p, action in zip(pending, results):
                    ref = ref_v1 if p.params_version == 1 else ref_v2
                    assert np.array_equal(action,
                                          ref.reference_act(p.obs, p.noise))
            assert all(p.done() for p in pending)
    finally:
        channel.close(unlink=True)


@pytest.mark.gpu
@pytest.mark.parametrize("algo_name", ["ppo", "sac"])
def test_from_checkpoint_trained_on_the_card(cuda, tmp_path, algo_name):
    """Train on the card through the kernels with ``--ckpt-dir`` (SAC over
    a prioritized buffer): the restored params equal the run's bit for
    bit, and the served actions equal ``reference_act``'s."""
    d = str(tmp_path / "ckpt")
    argv = ["--env", "pendulum", "--algo", algo_name, "--num-samplers",
            "2", "--global-batch", "16", "--horizon", "32", "--iterations",
            "2", "--kernels", "cuda", "--ckpt-dir", d]
    if algo_name == "sac":
        argv += ["--buffer", "prioritized", "--replay-capacity", "4096",
                 "--replay-batch", "64"]
    kernels.reset_launch_counts()
    result = train.main(argv)
    torch.cuda.synchronize()
    assert kernels.launch_counts()["pendulum_step"] == 2 * 2 * 32
    handle = load_policy(d)
    for a, b in zip(result.params.parameters(), handle.params.parameters()):
        assert b.is_cuda and torch.equal(a, b)
    observations = _obs(handle.env, 20)
    with PolicyServer.from_checkpoint(d, slots=8, deadline_ms=5.0) as server:
        pending = [server.submit(o) for o in observations]
        for p in pending:
            assert np.array_equal(p.result(60.0),
                                  server.reference_act(p.obs, p.noise))
    kernels.set_kernel_mode("auto")
