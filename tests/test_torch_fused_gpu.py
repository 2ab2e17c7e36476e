"""The fused engine and the device-start ring insert on the card.

Every test here needs a CUDA device and skips without one. The file
imports neither ``jax`` nor ``repro``, so it runs where only PyTorch is
installed:

    PYTHONPATH=src python -m pytest --noconftest -m gpu \
        tests/test_torch_fused_gpu.py

Bounds: all exact. The insert kernel moves bytes; a CUDA-graph replay of
an iteration launches the same kernels on the same inputs as the eager
iteration, so a fused run equals the stepped one from the same carry bit
for bit, with the kernels and with the plain versions.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch import kernels
from repro_torch.core.fused import FusedRunner, state_tensors
from repro_torch.experiment import ExperimentSpec, Schedule, run
from repro_torch.kernels.replay_ring import ops as ring_ops


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


# 56-byte rows, 4-, 3-, 10-byte rows and a leaf of zero-width rows
LEAVES = [((14,), torch.float32), ((), torch.float32), ((3,), torch.bool),
          ((5,), torch.bfloat16), ((0,), torch.float32)]


def _ring(rng, rows, device):
    out = {}
    for i, (shape, dtype) in enumerate(LEAVES):
        x = rng.standard_normal((rows,) + shape).astype(np.float32)
        out[f"l{i}"] = (torch.from_numpy(x > 0) if dtype == torch.bool
                        else torch.from_numpy(x * 9).to(dtype)).to(device)
    return out


@pytest.mark.gpu
@pytest.mark.parametrize("cap,n,start", [
    (17, 5, 15), (12, 12, 7), (8, 11, 3), (1, 3, 0),
    (1 << 20, 20000, (1 << 20) - 7001), (4099, 3000, 1001)])
def test_ring_insert_kernel_reads_its_start_on_the_device(cuda, cap, n,
                                                          start):
    """The head given as a 0-dim int32 tensor on the card: one launch, the
    plain version's bytes."""
    rng = np.random.default_rng(cap + n)
    storage, batch = _ring(rng, cap, cuda), _ring(rng, n, cuda)
    head = torch.tensor(start, dtype=torch.int32, device=cuda)
    want = ring_ops.ring_insert_ref({k: v.clone() for k, v in storage.items()},
                                    batch, start)
    before = ring_ops.ring_insert_cuda.launches
    got = ring_ops.ring_insert(storage, batch, head, impl="cuda")
    torch.cuda.synchronize()
    assert got is storage
    assert ring_ops.ring_insert_cuda.launches == before + 1
    for k in want:
        assert torch.equal(got[k], want[k]), k


@pytest.mark.gpu
def test_ring_insert_with_a_moving_device_head_replays_from_a_graph(cuda):
    """An insert at a head kept on the device, and the head's advance,
    captured in one CUDA graph: each replay writes where the last one
    stopped, as the plain version at the host's heads does."""
    rng = np.random.default_rng(5)
    cap, n = 4099, 3000
    storage, batch = _ring(rng, cap, cuda), _ring(rng, n, cuda)
    head = torch.full((), 2001, dtype=torch.int32, device=cuda)
    want = {k: v.clone() for k, v in storage.items()}

    def insert():
        ring_ops.ring_insert(storage, batch, head, impl="cuda")
        head.copy_(torch.remainder(head + n, cap))

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):                # build, load, check once
        insert()
    torch.cuda.current_stream().wait_stream(side)
    ring_ops.ring_insert_ref(want, batch, 2001)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        insert()
    at = (2001 + n) % cap
    for _ in range(3):
        for k, v in _ring(rng, n, cuda).items():
            batch[k].copy_(v)
        ring_ops.ring_insert_ref(want, batch, at)
        at = (at + n) % cap
        graph.replay()
        torch.cuda.synchronize()
        assert int(head) == at
        for k in want:
            assert torch.equal(storage[k], want[k]), k


SPECS = {
    "ppo pendulum": ExperimentSpec(env="pendulum", algo="ppo"),
    "trpo cartpole": ExperimentSpec(env="cartpole", algo="trpo"),
    "ddpg pendulum uniform": ExperimentSpec(
        env="pendulum", algo="ddpg", buffer="uniform",
        buffer_kwargs={"capacity": 512, "batch_size": 32}),
    "sac cheetah prioritized": ExperimentSpec(
        env="cheetah", algo="sac", buffer="prioritized",
        buffer_kwargs={"capacity": 512, "batch_size": 32}),
}


def _spec(label, **change):
    return dataclasses.replace(
        SPECS[label], env_kwargs={"max_episode_steps": 10},
        schedule=Schedule(num_samplers=1, global_batch=16, horizon=24,
                          iterations=5, chunk=2), **change)


def _finals(result):
    runner = result.runner
    plane = (state_tensors(runner.plane_state[0]) if runner.plane_state
             else [])
    return ([p.detach().clone() for p in result.params.parameters()]
            + [x.clone() for x in state_tensors(runner.opt_state)]
            + [x.clone() for x in plane],
            [lg.mean_return for lg in result.logs])


@pytest.mark.gpu
@pytest.mark.parametrize("label", list(SPECS))
def test_fused_replays_equal_the_stepped_run(cuda, label):
    """5 iterations fused (2 eager, a capture, 3 replays over chunks of 2)
    against the sync runtime from the same carry: weights, optimizer and
    plane state and every mean return bit for bit; the replays launched
    the path's kernels, and the counts are 5 iterations' launches (the
    capture's calls launch nothing, each replay adds its launches)."""
    want, want_ret = _finals(run(_spec(label), device=cuda))
    kernels.reset_launch_counts()
    fused = run(_spec(label, runtime="fused"), device=cuda)
    counts = kernels.launch_counts()
    got, got_ret = _finals(fused)
    assert isinstance(fused.runner, FusedRunner)
    assert fused.runner.engine.graph is not None
    per_replay = fused.runner.graph_stats["launches_per_replay"]
    env_kernel = f"{fused.spec.env}_step"
    assert per_replay[env_kernel] == 24, per_replay
    assert counts == {k: 5 * per_replay.get(k, 0) for k in counts}, counts
    assert got_ret == want_ret and any(r != 0.0 for r in want_ret)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


@pytest.mark.gpu
@pytest.mark.parametrize("label", ["ppo pendulum", "sac cheetah prioritized"])
def test_fused_with_the_kernels_equals_fused_with_the_plain_versions(
        cuda, label):
    """The plain versions are captured too (no host read on their path):
    a fused run with ``kernels="ref"`` equals one with the kernels."""
    want, want_ret = _finals(run(_spec(label, runtime="fused",
                                       kernels="ref"), device=cuda))
    got, got_ret = _finals(run(_spec(label, runtime="fused"), device=cuda))
    assert got_ret == want_ret
    for a, b in zip(got, want):
        assert torch.equal(a, b)
