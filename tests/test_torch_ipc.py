"""The port's shared-memory transport (``repro_torch.core.ipc``): ring
write/read/ack, the read deadline that names a dead writer, ``reclaim`` of
torn and orphaned slots, a writer SIGKILLed mid-write, ``ParamsChannel``
versioning, heartbeat ages across attach, and the copy-before-ack rule: a
trajectory read from the ring, and turned into tensors, survives the
worker's next write to the same slot."""
import multiprocessing as mp
import os
import signal

import numpy as np
import pytest
import torch

from repro_torch.core.backends import to_device
from repro_torch.core.ipc import (
    Heartbeat,
    ParamsChannel,
    RingSlotStuck,
    ShmRing,
    WorkerCrashed,
    param_leaves,
)
from repro_torch.models import mlp_policy


def _example():
    return {"obs": np.zeros((4, 3), np.float32),
            "dones": np.zeros((4,), bool)}


def _ring(tag, slots=2):
    return ShmRing.create(_example(), slots=slots,
                          prefix=f"walle-test-{os.getpid()}-{tag}")


def _traj(fill):
    return {"obs": np.full((4, 3), fill, np.float32),
            "dones": np.array([0, 1, 0, 1], bool)}


def test_shm_ring_write_read_ack():
    ring = _ring("a")
    try:
        traj = {"obs": np.arange(12, dtype=np.float32).reshape(4, 3),
                "dones": np.array([0, 1, 0, 1], bool)}
        assert ring.is_free(1)
        ring.write(1, traj, worker_id=3, policy_version=9,
                   collect_seconds=0.5, loop_seconds=1.0)
        assert not ring.is_free(1)
        out, meta = ring.read(1)
        np.testing.assert_array_equal(out["obs"], traj["obs"])
        np.testing.assert_array_equal(out["dones"], traj["dones"])
        assert (meta["worker_id"], meta["policy_version"]) == (3, 9)
        assert meta["collect_seconds"] == 0.5
        assert meta["loop_seconds"] == 1.0
        ring.ack(1)
        assert ring.is_free(1) and ring.is_free(0)
    finally:
        ring.close(unlink=True)


def test_ring_read_survives_the_next_write_to_its_slot():
    """The consumer copies out of shared memory before ``ack``; after the
    ack the worker overwrites the slot, and what the learner holds (on the
    CPU, where ``.to('cpu')`` does not copy) must not change."""
    ring = _ring("b", slots=1)
    try:
        ring.write(0, _traj(1.0), worker_id=0, policy_version=1,
                   collect_seconds=0.0, loop_seconds=0.0)
        out, _ = ring.read(0)
        ring.ack(0)
        held = to_device(out, "cpu")
        assert ring.is_free(0)
        ring.write(0, _traj(2.0), worker_id=0, policy_version=2,
                   collect_seconds=0.0, loop_seconds=0.0)
        assert torch.equal(held["obs"], torch.full((4, 3), 1.0))
        assert held["dones"].dtype == torch.bool
        again, meta = ring.read(0)
        assert meta["policy_version"] == 2
        np.testing.assert_array_equal(again["obs"], np.full((4, 3), 2.0))
    finally:
        ring.close(unlink=True)


def test_ring_read_timeout_names_slot_writer_and_state():
    ring = _ring("c")
    try:
        ring.begin_torn_write(1, worker_id=3)        # seq odd, never ends
        with pytest.raises(RingSlotStuck,
                           match=r"slot 1.*write in progress") as ei:
            ring.read(1, timeout=0.2)
        err = ei.value
        assert (err.slot, err.worker_id) == (1, 3)
        assert err.writer_pid == os.getpid() and err.seq % 2 == 1
        assert str(err.writer_pid) in str(err)
        assert isinstance(err, WorkerCrashed)
    finally:
        ring.close(unlink=True)


def test_ring_reclaim_torn_unread_and_free():
    ring = _ring("d", slots=3)
    try:
        ring.begin_torn_write(0, worker_id=1)
        assert ring.reclaim(0) == "torn"
        assert ring.is_free(0)                       # writable again
        ring.write(1, _traj(1.0), worker_id=1, policy_version=1,
                   collect_seconds=0.0, loop_seconds=0.0)
        assert ring.reclaim(1) == "unread"           # orphaned stable write
        assert ring.is_free(1)
        assert ring.reclaim(2) is None               # untouched slot
        seq = ring.write(0, _traj(3.0), worker_id=2, policy_version=5,
                         collect_seconds=0.0, loop_seconds=0.0)
        out, meta = ring.read(0)
        np.testing.assert_array_equal(out["obs"], np.full((4, 3), 3.0))
        assert meta["worker_id"] == 2 and ring.seq(0) == seq
    finally:
        ring.close(unlink=True)


def _torn_writer_child(ring_spec, slot, wid):
    """Attach, start a write, and die mid-write."""
    from repro_torch.core.ipc import ShmRing
    ring = ShmRing.attach(ring_spec)
    ring.begin_torn_write(slot, wid)
    os.kill(os.getpid(), signal.SIGKILL)


def test_sigkilled_writer_mid_write():
    """A producer SIGKILLed mid-write: ``read`` raises ``RingSlotStuck``
    naming the dead writer, and ``reclaim`` repairs the slot."""
    ring = _ring("e", slots=1)
    try:
        p = mp.get_context("spawn").Process(
            target=_torn_writer_child, args=(ring.spec, 0, 9))
        p.start()
        p.join(timeout=120)
        assert p.exitcode == -signal.SIGKILL
        with pytest.raises(RingSlotStuck) as ei:
            ring.read(0, timeout=0.3)
        assert ei.value.writer_pid == p.pid and ei.value.worker_id == 9
        assert ring.reclaim(0) == "torn"
        assert ring.is_free(0)
    finally:
        ring.close(unlink=True)


def test_params_channel_versioning():
    policy = mlp_policy.init_policy(torch.Generator().manual_seed(0), 3, 1,
                                    hidden=8)
    leaves = param_leaves(policy)
    assert len(leaves) == len(list(policy.parameters()))
    chan = ParamsChannel.create(leaves,
                                prefix=f"walle-test-{os.getpid()}-c")
    try:
        assert chan.version == 0
        v1 = chan.publish(leaves)
        assert v1 == 1 and chan.version == 1
        out, v = chan.read(min_version=1)
        assert v == 1
        for a, p in zip(out, policy.parameters()):
            np.testing.assert_array_equal(a, p.detach().numpy())
        none, v = chan.read(last_version=1)          # nothing new: no copy
        assert none is None and v == 1
        assert chan.publish(leaves) == 2
        with pytest.raises(ValueError, match="leaves"):
            chan.publish(leaves[:1])
        # an attached reader sees the same version and values
        other = ParamsChannel.attach(chan.spec)
        got, v = other.read(min_version=2)
        assert v == 2 and len(got) == len(leaves)
        other.close()
    finally:
        chan.close(unlink=True)


def test_heartbeat_ages_cross_attach():
    hb = Heartbeat(f"walle-test-{os.getpid()}-hb", slots=3, create=True)
    try:
        assert hb.age(0) == float("inf")             # never beaten
        hb.beat(0)
        assert hb.age(0) < 5.0
        other = Heartbeat(hb.name)                   # attach side
        assert other.age(0) < 5.0 and other.age(1) == float("inf")
        other.beat(2)
        assert hb.age(2) < 5.0
        other.close()
    finally:
        hb.close(unlink=True)
