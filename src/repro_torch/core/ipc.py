"""Shared-memory IPC for the actor plane (port of ``repro/core/ipc.py``).

WALL-E's sampler parallelism is process-level: N rollout workers, each with
its own Python interpreter (and, on the card, its own CUDA context), feed
one learner. The transport moves trajectories and policy parameters across
the process boundary through ``/dev/shm`` without pickling tensors per
iteration. Layout, messages and start method are the reference's:

* ``ShmRing`` — a slotted trajectory ring: one
  ``multiprocessing.shared_memory`` block per trajectory leaf (numpy views)
  plus seqlock slot headers (``seq`` odd = write in progress, even =
  stable; an ``ack`` counter lets the producer wait until its previous slot
  was consumed). Writers stamp their pid into the header before touching
  the payload, so a slot left mid-write by a dead worker names its writer;
  ``read`` is deadline-bounded (``RingSlotStuck``) and ``reclaim`` repairs
  such slots instead of deadlocking the consumer. ``read`` copies the slot
  out before returning: a consumer that keeps a view past ``ack`` would
  see the worker's next write.
* ``ParamsChannel`` — a versioned params cell, ``core.queues.PolicyStore``
  across processes: the learner publishes its parameters (module order)
  into fixed shared blocks; workers poll a version word and copy only when
  it changed.
* ``Heartbeat`` — one monotonic-clock timestamp per worker slot. Workers
  stamp it every loop; the supervisor reads ``age`` to tell a wedged but
  alive worker from a slow one (CLOCK_MONOTONIC is system-wide on Linux).
* ``ProcessWorkerPool`` — spawns workers (``spawn`` start method: a child
  forked after the parent touched CUDA cannot use the card), each rebuilt
  from a ``core.sampler.WorkerSpec`` through the registry; drives them in
  lock-step (``collect``) or free-running mode
  (``start_freerun``/``next_experience``); surfaces worker crashes as
  ``WorkerCrashed``; reaps everything on ``close``. It is provisioned for
  ``max_workers`` specs and slots up front and runs the ``active`` subset;
  ``grow``/``shrink``/``respawn`` reuse the sized ring and channel.
  ``core.supervisor.WorkerSupervisor`` layers failure detection and
  respawn policy on the primitives here.

Trajectories cross as bytes: a worker copies its rollout to the host once
(``.cpu()``) and into the ring; the learner copies it out and onto its
device. Every trajectory report also carries the worker's device, its
allocator's peak reserve and its kernel launch counts so far
(``worker_launches``), which the parent cannot see otherwise; a worker
sends them once more as it stops, and before an injected death.

Memory ordering: the seqlock headers are consistency checks; the ordering
producers rely on is the command/result queue handshake (a pipe write and
read is a full barrier).
"""
from __future__ import annotations

import atexit
import collections
import dataclasses
import os
import queue as _queue
import signal
import sys
import time
import traceback
import uuid
from multiprocessing import shared_memory
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

# slot header layout: int64 words per slot ...
_H_SEQ, _H_ACK, _H_VERSION, _H_WORKER, _H_PID = 0, 1, 2, 3, 4
_HDR_I = 5
# ... plus float64 words per slot
_H_COLLECT_S, _H_LOOP_S = 0, 1
_HDR_F = 2

# seconds the pool waits for its workers to report ready (their first CUDA
# context and kernel load included), and for one lock-step sweep
START_TIMEOUT = 300.0
COLLECT_TIMEOUT = 600.0


class WorkerCrashed(RuntimeError):
    """A rollout worker process died or raised; the message says which."""


class RingSlotStuck(WorkerCrashed):
    """A ring slot's seqlock never stabilized within the read deadline: its
    writer almost certainly died mid-write. Carries ``slot``,
    ``writer_pid``, ``worker_id`` and the stuck ``seq`` so a supervisor can
    reclaim exactly what is stuck."""

    def __init__(self, msg: str, *, slot: int, writer_pid: int,
                 worker_id: int, seq: int):
        super().__init__(msg)
        self.slot = slot
        self.writer_pid = writer_pid
        self.worker_id = worker_id
        self.seq = seq


class StaleSlotMessage(RuntimeError):
    """A queued trajectory message names a slot whose seqlock moved past
    the message's ``seq``: the slot was reclaimed and rewritten after its
    writer died. The message is discarded, never read."""


# Python 3.12 registers every ``SharedMemory`` with the resource tracker,
# also on attach. Spawned workers share the parent's tracker, whose cache
# is a set of names: a child's registration is a no-op and the parent's
# ``unlink`` unregisters each name once.


@dataclasses.dataclass(frozen=True)
class LeafSpec:
    """Shape and numpy dtype of one leaf inside a shared block."""
    key: str
    shape: Tuple[int, ...]
    dtype: str


@dataclasses.dataclass(frozen=True)
class RingSpec:
    """Everything a fresh process needs to attach to a ``ShmRing``."""
    prefix: str
    slots: int
    leaves: Tuple[LeafSpec, ...]


def _leaf_specs(example: Dict[str, Any]) -> Tuple[LeafSpec, ...]:
    """Sorted-key leaf specs from a dict of numpy arrays."""
    return tuple(
        LeafSpec(key=k, shape=tuple(example[k].shape),
                 dtype=np.dtype(example[k].dtype).str)
        for k in sorted(example))


class ShmRing:
    """Slotted trajectory ring over one shared block per trajectory leaf.

    Slot ``s`` of leaf ``k`` is the numpy view ``self.views[k][s]``; the
    header block carries per-slot ``(seq, ack, policy_version, worker_id,
    writer_pid)`` int64 words and ``(collect_seconds, loop_seconds)``
    float64 words. Writers bump ``seq`` to odd and stamp their identity
    before touching the payload, and bump it to even after; readers copy,
    then check ``seq`` again. ``ack`` is written by the consumer so a
    producer can wait until its previous write was drained (``is_free``):
    the ring's only backpressure.
    """

    def __init__(self, spec: RingSpec, create: bool):
        self.spec = spec
        self._shms: List[shared_memory.SharedMemory] = []
        self.views: Dict[str, np.ndarray] = {}
        for i, leaf in enumerate(spec.leaves):
            nbytes = (spec.slots * int(np.prod(leaf.shape, dtype=np.int64))
                      * np.dtype(leaf.dtype).itemsize)
            shm = self._open(f"{spec.prefix}-l{i}", create, max(nbytes, 8))
            self.views[leaf.key] = np.ndarray(
                (spec.slots, *leaf.shape), dtype=leaf.dtype, buffer=shm.buf)
        hdr_bytes = spec.slots * (_HDR_I * 8 + _HDR_F * 8)
        shm = self._open(f"{spec.prefix}-hdr", create, hdr_bytes)
        self._hdr_i = np.ndarray((spec.slots, _HDR_I), dtype=np.int64,
                                 buffer=shm.buf, offset=0)
        self._hdr_f = np.ndarray((spec.slots, _HDR_F), dtype=np.float64,
                                 buffer=shm.buf,
                                 offset=spec.slots * _HDR_I * 8)
        if create:
            self._hdr_i.fill(0)
            self._hdr_f.fill(0.0)

    def _open(self, name: str, create: bool,
              size: int) -> shared_memory.SharedMemory:
        shm = shared_memory.SharedMemory(
            name=name, create=create, size=size if create else 0)
        self._shms.append(shm)
        return shm

    @classmethod
    def create(cls, example: Dict[str, Any], slots: int,
               prefix: str) -> "ShmRing":
        return cls(RingSpec(prefix=prefix, slots=slots,
                            leaves=_leaf_specs(example)), create=True)

    @classmethod
    def attach(cls, spec: RingSpec) -> "ShmRing":
        return cls(spec, create=False)

    # ------------------------------------------------------------- producer
    def write(self, slot: int, traj: Dict[str, np.ndarray], *,
              worker_id: int, policy_version: int,
              collect_seconds: float, loop_seconds: float) -> int:
        """Seqlocked write of one trajectory; returns the slot's new (even)
        ``seq``, which the writer reports with the slot index so the
        consumer can check the slot still holds this write."""
        seq = int(self._hdr_i[slot, _H_SEQ])
        self._hdr_i[slot, _H_SEQ] = seq + 1          # odd: write in progress
        # identity first: a writer that dies mid-payload is still named
        self._hdr_i[slot, _H_WORKER] = worker_id
        self._hdr_i[slot, _H_PID] = os.getpid()
        for leaf in self.spec.leaves:
            self.views[leaf.key][slot][...] = traj[leaf.key]
        self._hdr_i[slot, _H_VERSION] = policy_version
        self._hdr_f[slot, _H_COLLECT_S] = collect_seconds
        self._hdr_f[slot, _H_LOOP_S] = loop_seconds
        self._hdr_i[slot, _H_SEQ] = seq + 2          # even: stable
        return seq + 2

    def begin_torn_write(self, slot: int, worker_id: int) -> None:
        """Start a write (seq to odd, identity stamped) and never finish
        it: the ``torn`` fault's hook. The worker calls this, then SIGKILLs
        itself, leaving the header a real mid-write death leaves."""
        seq = int(self._hdr_i[slot, _H_SEQ])
        self._hdr_i[slot, _H_SEQ] = seq + 1
        self._hdr_i[slot, _H_WORKER] = worker_id
        self._hdr_i[slot, _H_PID] = os.getpid()

    def is_free(self, slot: int) -> bool:
        """True when the consumer acked everything written to ``slot``."""
        return int(self._hdr_i[slot, _H_ACK]) == int(
            self._hdr_i[slot, _H_SEQ])

    def seq(self, slot: int) -> int:
        return int(self._hdr_i[slot, _H_SEQ])

    # ------------------------------------------------------------- consumer
    def read(self, slot: int, timeout: float = 5.0
             ) -> Tuple[Dict[str, np.ndarray], Dict[str, Any]]:
        """Copy one slot out (``np.array``: the result never aliases the
        ring); retries on a torn seqlock read but gives up after
        ``timeout`` seconds with ``RingSlotStuck``."""
        deadline = time.monotonic() + timeout
        while True:
            s1 = int(self._hdr_i[slot, _H_SEQ])
            if s1 % 2 == 0:                           # stable: copy out
                traj = {leaf.key: np.array(self.views[leaf.key][slot])
                        for leaf in self.spec.leaves}
                meta = {
                    "policy_version": int(self._hdr_i[slot, _H_VERSION]),
                    "worker_id": int(self._hdr_i[slot, _H_WORKER]),
                    "collect_seconds": float(
                        self._hdr_f[slot, _H_COLLECT_S]),
                    "loop_seconds": float(self._hdr_f[slot, _H_LOOP_S]),
                }
                if int(self._hdr_i[slot, _H_SEQ]) == s1:
                    return traj, meta
            if time.monotonic() > deadline:
                pid = int(self._hdr_i[slot, _H_PID])
                wid = int(self._hdr_i[slot, _H_WORKER])
                state = ("odd = write in progress" if s1 % 2
                         else "kept moving")
                raise RingSlotStuck(
                    f"trajectory ring slot {slot} stuck mid-write for "
                    f"{timeout:.1f}s: seqlock seq={s1} ({state}), writer "
                    f"pid {pid} (worker #{wid}); the writer likely died "
                    f"mid-write: the slot must be reclaimed, not read",
                    slot=slot, writer_pid=pid, worker_id=wid, seq=s1)
            time.sleep(1e-4)

    def ack(self, slot: int) -> None:
        self._hdr_i[slot, _H_ACK] = self._hdr_i[slot, _H_SEQ]

    def reclaim(self, slot: int) -> Optional[str]:
        """Make a dead worker's slot writable again. Returns what was
        found: ``"torn"`` (seqlock odd: the writer died mid-write; the
        payload is garbage and is not surfaced), ``"unread"`` (a stable
        write nobody will consume: its result message died with the
        producer), or ``None`` (slot already free). Call only for slots
        whose writer is dead and whose pending result messages were
        drained: reclaiming a live writer's slot races its write."""
        seq = int(self._hdr_i[slot, _H_SEQ])
        ack = int(self._hdr_i[slot, _H_ACK])
        if seq % 2:                       # died mid-write: finish the seq
            self._hdr_i[slot, _H_SEQ] = seq + 1
            self._hdr_i[slot, _H_ACK] = seq + 1
            return "torn"
        if ack != seq:                    # stable but orphaned
            self._hdr_i[slot, _H_ACK] = seq
            return "unread"
        return None

    # ------------------------------------------------------------ lifecycle
    def close(self, unlink: bool = False) -> None:
        # drop the numpy views before closing the maps they point into
        self.views = {}
        self._hdr_i = self._hdr_f = None
        for shm in self._shms:
            try:
                shm.close()
                if unlink:
                    shm.unlink()
            except FileNotFoundError:
                pass
        self._shms = []


class Heartbeat:
    """One shared monotonic-clock timestamp per worker slot.

    Workers ``beat(i)`` every service-loop pass (also inside backpressure
    waits); ``age(i)`` is the seconds since worker ``i`` last beat, ``inf``
    before the first beat. The parent beats for a worker at spawn, so
    import and warm-up never read as a hang. A rollout cannot beat
    mid-flight, so hang timeouts must exceed the longest rollout.
    """

    def __init__(self, name: str, slots: int = 0, create: bool = False):
        self.name = name
        self._shm = shared_memory.SharedMemory(
            name=name, create=create, size=slots * 8 if create else 0)
        # the attach side takes its capacity from the (page-rounded) block
        self._view = np.ndarray((self._shm.size // 8,), dtype=np.float64,
                                buffer=self._shm.buf)
        if create:
            self._view.fill(0.0)

    def beat(self, i: int) -> None:
        self._view[i] = time.monotonic()

    def age(self, i: int) -> float:
        t = float(self._view[i])
        return float("inf") if t == 0.0 else time.monotonic() - t

    def close(self, unlink: bool = False) -> None:
        self._view = None
        try:
            self._shm.close()
            if unlink:
                self._shm.unlink()
        except FileNotFoundError:
            pass


@dataclasses.dataclass(frozen=True)
class ChannelSpec:
    """Attach info for a ``ParamsChannel`` (picklable)."""
    prefix: str
    leaves: Tuple[LeafSpec, ...]


class ParamsChannel:
    """Versioned cross-process params cell: ``PolicyStore`` over shm.

    One shared block per parameter plus one seqlock word: ``publish``
    bumps it to odd, overwrites every leaf, bumps it to even; ``version ==
    seq // 2`` counts publishes. ``read`` waits until the version reaches
    ``min_version``, copies, and checks the word again, so workers act with
    the freshest published policy (maybe stale, never torn) and copy only
    when it changed.
    """

    def __init__(self, spec: ChannelSpec, create: bool):
        self.spec = spec
        self._shms: List[shared_memory.SharedMemory] = []
        self._views: List[np.ndarray] = []
        for i, leaf in enumerate(spec.leaves):
            nbytes = (int(np.prod(leaf.shape, dtype=np.int64))
                      * np.dtype(leaf.dtype).itemsize)
            shm = self._open(f"{spec.prefix}-l{i}", create, max(nbytes, 8))
            self._views.append(np.ndarray(leaf.shape, dtype=leaf.dtype,
                                          buffer=shm.buf))
        shm = self._open(f"{spec.prefix}-hdr", create, 8)
        self._hdr = np.ndarray((1,), dtype=np.int64, buffer=shm.buf)
        if create:
            self._hdr[0] = 0

    def _open(self, name: str, create: bool,
              size: int) -> shared_memory.SharedMemory:
        shm = shared_memory.SharedMemory(
            name=name, create=create, size=size if create else 0)
        self._shms.append(shm)
        return shm

    @classmethod
    def create(cls, leaves: Sequence[np.ndarray],
               prefix: str) -> "ParamsChannel":
        spec = ChannelSpec(prefix=prefix, leaves=tuple(
            LeafSpec(key=str(i), shape=tuple(x.shape),
                     dtype=np.dtype(x.dtype).str)
            for i, x in enumerate(leaves)))
        return cls(spec, create=True)

    @classmethod
    def attach(cls, spec: ChannelSpec) -> "ParamsChannel":
        return cls(spec, create=False)

    @property
    def version(self) -> int:
        return int(self._hdr[0]) // 2

    def publish(self, leaves: Sequence[np.ndarray]) -> int:
        if len(leaves) != len(self._views):
            raise ValueError(
                f"params channel holds {len(self._views)} leaves, "
                f"publish got {len(leaves)}")
        seq = int(self._hdr[0])
        self._hdr[0] = seq + 1
        for view, leaf in zip(self._views, leaves):
            view[...] = leaf
        self._hdr[0] = seq + 2
        return (seq + 2) // 2

    def read(self, min_version: int = 0, last_version: int = -1,
             should_stop: Optional[Callable[[], bool]] = None,
             poll: float = 1e-4
             ) -> Tuple[Optional[List[np.ndarray]], int]:
        """Wait until ``version >= min_version``; return ``(leaf_copies,
        version)``. The leaves are ``None`` when the version equals
        ``last_version`` (nothing new to copy) or when ``should_stop()``
        fired (version reported as -1)."""
        while True:
            s1 = int(self._hdr[0])
            if s1 % 2 == 0 and s1 // 2 >= min_version:
                version = s1 // 2
                if version == last_version:
                    return None, version
                out = [np.array(v) for v in self._views]
                if int(self._hdr[0]) == s1:
                    return out, version
                continue                              # torn read: retry
            if should_stop is not None and should_stop():
                return None, -1
            time.sleep(poll)

    def close(self, unlink: bool = False) -> None:
        self._views = []
        self._hdr = None
        for shm in self._shms:
            try:
                shm.close()
                if unlink:
                    shm.unlink()
            except FileNotFoundError:
                pass
        self._shms = []


def param_leaves(params) -> List[np.ndarray]:
    """A params module's parameters, in module order, as host arrays: what
    the ``ParamsChannel`` carries."""
    return [p.detach().cpu().numpy() for p in params.parameters()]


def _check_leaves(params, chan_spec: ChannelSpec, worker_id: int) -> None:
    """Raise unless the channel carries exactly ``params``' parameters
    (count and shapes)."""
    shapes = [tuple(p.shape) for p in params.parameters()]
    carried = [tuple(leaf.shape) for leaf in chan_spec.leaves]
    if shapes != carried:
        raise RuntimeError(
            f"worker {worker_id}: rebuilt params have {len(shapes)} "
            f"tensors of shapes {shapes}, the channel carries "
            f"{len(carried)} of shapes {carried}: the WorkerSpec and the "
            f"learner's params disagree")


def _load_leaves(params, leaves: Sequence[np.ndarray]) -> None:
    """Copy channel leaves into ``params``' parameters in place."""
    import torch
    with torch.no_grad():
        for p, x in zip(params.parameters(), leaves):
            p.copy_(torch.from_numpy(x))


# ======================================================= the worker process
def _worker_main(spec_dict: Dict[str, Any], ring_spec: RingSpec,
                 chan_spec: ChannelSpec, hb_name: str, worker_id: int,
                 incarnation: int, slot_base: int, num_slots: int,
                 fault_plan_dict: Optional[Dict[str, Any]], cmd_q,
                 res_q) -> None:
    """Entry point of one rollout worker process.

    Sets what ``experiment.build`` sets in the learner (TF32 off; on the
    CPU one intra-op thread, so N workers do not oversubscribe the host),
    rebuilds env, algorithm, rollout and carry from the ``WorkerSpec``
    through the registry, then serves:

      ("collect", v) — one rollout under params version >= v, write the
                       slot, report; the lock-step mode ``ProcessBackend``
                       uses
      ("freerun",)   — roll continuously with the freshest published
                       params, blocking only while the ring slot is
                       unconsumed; the ``AsyncOrchestrator`` mode
      ("stop",)      — exit cleanly

    Reports: ("ready", id, monotonic time) once built, then per rollout
    ("traj", id, slot, seq, version, collect_s, loop_s, info) with ``seq``
    the slot's post-write seqlock value (the consumer matches it against
    the live header, so a message of a dead incarnation never aliases a
    respawned worker's write) and ``info`` the worker's incarnation,
    device, allocator peak reserve (MiB; 0 on the CPU) and kernel launch
    counts so far. ("counts", id, info) repeats ``info`` as the worker
    stops (a rollout it finished but never wrote still launched its
    kernels) and before an injected death, which flushes the result queue
    first.

    ``incarnation`` counts this worker id's spawns; it keys the fault
    plan's stream and is otherwise inert. Any exception is reported as
    ("error", id, traceback) and surfaces in the parent as
    ``WorkerCrashed``.
    """
    try:
        # spread workers round-robin over the host's cores: a worker never
        # fights more than ceil(N / cores) peers for its core
        if hasattr(os, "sched_setaffinity"):
            try:
                cores = sorted(os.sched_getaffinity(0))
                os.sched_setaffinity(0, {cores[worker_id % len(cores)]})
            except OSError:
                pass
        import torch

        from repro_torch import kernels
        from repro_torch.core.faults import FaultPlan, decide
        from repro_torch.core.sampler import WorkerSpec
        from repro_torch.core.timing import synchronize

        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        spec = WorkerSpec.from_dict(spec_dict)
        if torch.device(spec.device).type == "cpu":
            torch.set_num_threads(1)
        plan = FaultPlan.from_dict(fault_plan_dict)
        rollout, carry, params = spec.build()
        device = carry[1].device
        ring = ShmRing.attach(ring_spec)
        chan = ParamsChannel.attach(chan_spec)
        hb = Heartbeat(hb_name)
        _check_leaves(params, chan_spec, worker_id)
        hb.beat(worker_id)
        res_q.put(("ready", worker_id, time.monotonic()))

        def info():
            reserved = (torch.cuda.max_memory_reserved(device)
                        if device.type == "cuda" else 0)
            return {"incarnation": incarnation, "device": str(device),
                    "memory_reserved_mib": reserved / 2 ** 20,
                    "launches": kernels.launch_counts()}

        def die():
            # what this incarnation launched reaches the parent first
            res_q.put(("counts", worker_id, info()))
            res_q.close()
            res_q.join_thread()
            os.kill(os.getpid(), signal.SIGKILL)

        last_version = -1
        freerunning, counter, stop = False, 0, False
        while not stop:
            hb.beat(worker_id)
            if freerunning:
                try:
                    cmd = cmd_q.get_nowait()
                except _queue.Empty:
                    cmd = ("step", 0)
            else:
                try:                     # bounded waits keep the beat alive
                    cmd = cmd_q.get(timeout=0.25)
                except _queue.Empty:
                    continue
            op = cmd[0]
            if op == "stop":
                break
            if op == "freerun":
                freerunning = True
                continue
            # op is "collect" (lock-step) or "step" (free-running)
            fault = decide(plan, worker_id, incarnation, counter)
            if fault == "kill":          # clean death: nothing in flight
                die()
            elif fault == "hang":        # wedged: alive, beats never again
                while True:
                    time.sleep(0.05)
            elif fault == "delay":       # straggler, not a failure
                time.sleep(plan.delay_ms / 1e3)
            min_version = cmd[1] if len(cmd) > 1 else 0
            t_loop0 = time.perf_counter()
            np_leaves, version = chan.read(min_version=min_version,
                                           last_version=last_version)
            if np_leaves is not None:
                _load_leaves(params, np_leaves)
                last_version = version
            t0 = time.perf_counter()
            carry, traj = rollout(params, carry)
            synchronize(device)
            dt = time.perf_counter() - t0
            traj_np = {k: v.cpu().numpy() for k, v in traj.items()}
            slot = slot_base + (counter % num_slots)
            while not ring.is_free(slot):      # learner behind: back off
                hb.beat(worker_id)
                try:
                    nxt = cmd_q.get(timeout=0.002)
                    if nxt[0] == "stop":
                        stop = True
                        break
                except _queue.Empty:
                    pass
            if stop:
                break
            loop_dt = time.perf_counter() - t_loop0
            if fault == "torn":          # die mid-write: seqlock left odd
                ring.begin_torn_write(slot, worker_id)
                die()
            seq = ring.write(slot, traj_np, worker_id=worker_id,
                             policy_version=last_version,
                             collect_seconds=dt, loop_seconds=loop_dt)
            res_q.put(("traj", worker_id, slot, seq, last_version, dt,
                       time.perf_counter() - t_loop0, info()))
            counter += 1
        res_q.put(("counts", worker_id, info()))
        ring.close()
        chan.close()
        hb.close()
    except Exception:
        try:
            res_q.put(("error", worker_id, traceback.format_exc()))
        except Exception:
            pass


# ============================================================ the worker pool
class ProcessWorkerPool:
    """Rollout worker processes plus the shared-memory transport between
    them and this (learner) process.

    The pool is provisioned for ``max_workers = len(worker_specs)`` workers
    up front (ring slots, heartbeat slots, per-worker specs) but runs only
    the ``active`` subset (``active_workers``, default: all).
    Construction publishes the initial params (version 1), spawns the
    active workers and waits until each reports ready; a worker that dies
    while importing or building surfaces at once as ``WorkerCrashed``.

    Two driving modes:

    * ``collect()`` — lock-step: broadcast one ("collect", version)
      command, await N results, return the trajectories in worker-index
      order (which makes ``process == inline`` exact for matched
      per-worker seeds).
    * ``start_freerun()`` + ``next_experience()`` — async: workers roll
      continuously against the freshest published params; the learner
      drains finished slots as ``core.queues.Experience`` records. The ring
      is the backpressure (``slots_per_worker`` unconsumed rollouts, then
      the worker waits), so nothing is dropped.

    Fleet primitives (``respawn``/``grow``/``shrink``/``kill_worker``,
    ``poll_msg``/``drain_pending``/``dead_workers``/``heartbeat_age``,
    ``reclaim_worker_slots``/``read_slot_checked``) are mechanism only;
    when to respawn, back off or resize is ``WorkerSupervisor`` policy.

    Measured as it runs: ``startup_seconds`` (construction to all ready),
    ``worker_start_seconds`` (spawn to ready, per worker id) and
    ``worker_launches`` (the latest report of each worker incarnation,
    keyed ``(worker id, incarnation)``: its device, allocator peak reserve
    and cumulative kernel launch counts, so the counts of all keys add up
    to what the workers launched; ``close`` reads the reports nobody
    consumed too).

    Workers are daemonic and also reaped by an ``atexit`` hook. ``close``
    tells workers it stopped from workers that crashed during shutdown:
    the latter raise ``WorkerCrashed`` (chained onto a crash already
    surfaced) unless an exception is already propagating.
    """

    def __init__(self, worker_specs: Sequence[Any], params: Any,
                 traj_example: Dict[str, Any], slots_per_worker: int = 1,
                 active_workers: Optional[Sequence[int]] = None,
                 fault_plan: Optional[Any] = None):
        import multiprocessing as mp

        t_start = time.monotonic()
        self.max_workers = len(worker_specs)
        self._specs = list(worker_specs)
        self.slots_per_worker = int(slots_per_worker)
        self.fault_plan = fault_plan
        self._closed = False
        self._freerunning = False
        self._stash: collections.deque = collections.deque()
        self._terminated: set = set()       # wids we stopped on purpose
        self._crash_surfaced: set = set()   # crashes already raised
        self._last_crash: Optional[WorkerCrashed] = None
        self._spawned_at: Dict[int, float] = {}
        self.worker_start_seconds: Dict[int, float] = {}
        self.worker_launches: Dict[Tuple[int, int], Dict[str, Any]] = {}
        self._ctx = mp.get_context("spawn")
        prefix = f"walle-{os.getpid()}-{uuid.uuid4().hex[:6]}"
        leaves = param_leaves(params)
        self.channel = ParamsChannel.create(leaves, prefix + "-p")
        self.version = self.channel.publish(leaves)
        self.ring = ShmRing.create(
            traj_example, self.max_workers * self.slots_per_worker,
            prefix + "-t")
        self.heartbeat = Heartbeat(prefix + "-hb", self.max_workers,
                                   create=True)
        self._res = self._ctx.Queue()
        self._cmd: List[Optional[Any]] = [None] * self.max_workers
        self._procs: List[Optional[Any]] = [None] * self.max_workers
        self._retired: List[Any] = []       # cmd queues of dead incarnations
        self._incarnation = [0] * self.max_workers
        self.active: List[int] = sorted(
            active_workers if active_workers is not None
            else range(self.max_workers))
        if not self.active:
            raise ValueError("worker pool needs at least one active worker")
        if self.active[0] < 0 or self.active[-1] >= self.max_workers:
            raise ValueError(
                f"active_workers {self.active} out of range for "
                f"{self.max_workers} specs")
        self._atexit = lambda: self.close(raise_on_crash=False)
        atexit.register(self._atexit)
        try:
            for i in self.active:
                self._spawn(i)
            while len(self.worker_start_seconds) < len(self.active):
                self._get(timeout=START_TIMEOUT)
        except BaseException:
            self.close(raise_on_crash=False)
            raise
        self.startup_seconds = time.monotonic() - t_start

    # ---------------------------------------------------------------- sizing
    @property
    def num_workers(self) -> int:
        return len(self.active)

    # ------------------------------------------------------------- plumbing
    def _spawn(self, i: int) -> None:
        """(Re)start worker ``i`` under a fresh incarnation: a new command
        queue (the old one may hold commands the dead incarnation took but
        never ran), its heartbeat beaten by the parent so start-up never
        reads as a hang."""
        if self._cmd[i] is not None:
            self._retired.append(self._cmd[i])
        self._incarnation[i] += 1
        q = self._ctx.Queue()
        self._cmd[i] = q
        self.heartbeat.beat(i)
        plan_dict = (self.fault_plan.to_dict()
                     if self.fault_plan is not None else None)
        p = self._ctx.Process(
            target=_worker_main, name=f"walle-worker-{i}", daemon=True,
            args=(self._specs[i].to_dict(), self.ring.spec,
                  self.channel.spec, self.heartbeat.name, i,
                  self._incarnation[i], i * self.slots_per_worker,
                  self.slots_per_worker, plan_dict, q, self._res))
        self._procs[i] = p
        self._spawned_at[i] = time.monotonic()
        p.start()

    def _note(self, msg):
        """Record what a result message measured: a worker's start seconds
        (``ready``) and its incarnation's latest report (``traj``,
        ``counts``)."""
        if msg[0] == "ready" and msg[1] in self._spawned_at:
            self.worker_start_seconds[msg[1]] = (
                msg[2] - self._spawned_at[msg[1]])
        elif msg[0] in ("traj", "counts"):
            info = msg[-1]
            self.worker_launches[msg[1], info["incarnation"]] = info
        return msg

    def _check_alive(self) -> None:
        dead = [(i, self._procs[i].exitcode) for i in self.active
                if self._procs[i] is not None
                and not self._procs[i].is_alive()]
        if dead:
            for i, _ in dead:
                self._crash_surfaced.add(i)
            err = WorkerCrashed(
                "rollout worker(s) died: " + ", ".join(
                    f"#{i} (exitcode={code})" for i, code in dead))
            self._last_crash = err
            raise err

    def _get(self, timeout: float):
        """Next result message (stashed ones first); raises
        ``WorkerCrashed`` on a worker's error or death and
        ``TimeoutError`` past ``timeout``."""
        deadline = time.monotonic() + timeout
        while True:
            if self._stash:
                msg = self._stash.popleft()
            else:
                try:
                    msg = self._res.get(timeout=0.25)
                except _queue.Empty:
                    self._check_alive()
                    if time.monotonic() > deadline:
                        raise TimeoutError(
                            f"no worker result within {timeout:.0f}s")
                    continue
            if msg[0] == "error":
                err = WorkerCrashed(
                    f"rollout worker #{msg[1]} raised:\n{msg[2]}")
                self._crash_surfaced.add(msg[1])
                self._last_crash = err
                raise err
            return self._note(msg)

    def _read_slot(self, slot: int):
        traj, meta = self.ring.read(slot)
        self.ring.ack(slot)
        return traj, meta

    # ----------------------------------------------- supervisor primitives
    def poll_msg(self, timeout: float = 0.25):
        """One raw result message (stash first) or ``None`` on timeout.
        No liveness check, no error translation: the supervisor's job."""
        if self._stash:
            return self._note(self._stash.popleft())
        try:
            return self._note(self._res.get(timeout=timeout))
        except _queue.Empty:
            return None

    def drain_pending(self) -> None:
        """Move every queued result message into the stash. A producer
        SIGKILLed mid-``put`` can leave a partly pickled message; an error
        while unpickling ends the drain (the next drain retries)."""
        while True:
            try:
                self._stash.append(self._res.get_nowait())
            except _queue.Empty:
                return
            except Exception:
                return

    def dead_workers(self) -> List[Tuple[int, Optional[int]]]:
        """Active workers whose process has exited: [(wid, exitcode)]."""
        return [(i, self._procs[i].exitcode) for i in self.active
                if self._procs[i] is not None
                and not self._procs[i].is_alive()]

    def heartbeat_age(self, i: int) -> float:
        return self.heartbeat.age(i)

    def kill_worker(self, i: int) -> None:
        """SIGKILL worker ``i`` (wedged workers ignore gentler signals)."""
        p = self._procs[i]
        if p is not None and p.is_alive():
            p.kill()
        if p is not None:
            p.join(timeout=5.0)

    def respawn(self, i: int) -> None:
        """Replace worker ``i`` with a fresh incarnation of the same
        ``WorkerSpec`` (same seed: only the fault stream differs). Re-enters
        freerun if the pool is free-running. The caller reclaims the slots
        first (``reclaim_worker_slots``)."""
        self.kill_worker(i)
        self._spawn(i)
        if self._freerunning:
            self._cmd[i].put(("freerun",))

    def reclaim_worker_slots(self, i: int) -> List[Tuple[int, str]]:
        """Repair dead worker ``i``'s ring slots, except slots with a
        pending ("traj", ...) message: those hold finished rollouts the
        supervisor will still consume (seq-checked). Returns [(slot, kind)]
        for what was reclaimed."""
        self.drain_pending()
        pending = {m[2] for m in self._stash
                   if m[0] == "traj" and m[1] == i}
        out = []
        base = i * self.slots_per_worker
        for slot in range(base, base + self.slots_per_worker):
            if slot in pending:
                continue
            kind = self.ring.reclaim(slot)
            if kind is not None:
                out.append((slot, kind))
        return out

    def read_slot_checked(self, slot: int, seq: int):
        """Read and ack ``slot`` only if its seqlock still equals ``seq``
        (the value its message recorded at write time); else the slot was
        reclaimed and rewritten since and ``StaleSlotMessage`` is
        raised."""
        cur = self.ring.seq(slot)
        if cur != seq:
            raise StaleSlotMessage(
                f"ring slot {slot}: message recorded seq {seq} but the "
                f"slot is now at seq {cur}: reclaimed and rewritten "
                f"since; discarding the stale message")
        return self._read_slot(slot)

    def send(self, wid: int, cmd: Tuple) -> None:
        self._cmd[wid].put(cmd)

    # --------------------------------------------------------------- sizing
    def grow(self) -> Optional[int]:
        """Activate the lowest inactive worker id (its spec, slots and
        heartbeat exist since construction). Returns the id, or ``None`` at
        capacity. The joiner reads the current params on its first
        rollout."""
        inactive = [i for i in range(self.max_workers)
                    if i not in self.active]
        if not inactive:
            return None
        i = inactive[0]
        self._terminated.discard(i)
        self._crash_surfaced.discard(i)
        for slot in range(i * self.slots_per_worker,
                          (i + 1) * self.slots_per_worker):
            self.ring.reclaim(slot)
        self._spawn(i)
        self.active = sorted(self.active + [i])
        if self._freerunning:
            self._cmd[i].put(("freerun",))
        return i

    def shrink(self) -> Optional[int]:
        """Deactivate the highest active worker id (stop, join, terminate
        a straggler). Returns the id, or ``None`` at the floor of one."""
        if len(self.active) <= 1:
            return None
        i = self.active[-1]
        self.active = self.active[:-1]
        self._terminated.add(i)
        try:
            self._cmd[i].put_nowait(("stop",))
        except Exception:
            pass
        p = self._procs[i]
        if p is not None:
            p.join(timeout=5.0)
            if p.is_alive():
                p.terminate()
                p.join(timeout=3.0)
        # release what it left unconsumed, so a later grow() starts clean
        for slot in range(i * self.slots_per_worker,
                          (i + 1) * self.slots_per_worker):
            self.ring.reclaim(slot)
        return i

    # ------------------------------------------------------------ lock-step
    def publish(self, params: Any) -> int:
        self.version = self.channel.publish(param_leaves(params))
        return self.version

    def collect(self) -> Tuple[List[Dict[str, np.ndarray]], List[float],
                               List[float]]:
        """One lock-step sweep: every active worker rolls once under the
        current params version; trajectories come back in worker-index
        order."""
        if self._closed:
            raise RuntimeError("worker pool is closed")
        if self._freerunning:
            raise RuntimeError(
                "pool is free-running (async mode); lock-step collect() "
                "would interleave with unsolicited rollouts")
        version = self.channel.version
        got: Dict[int, Tuple[int, int, float, float]] = {}
        for i in self.active:
            self._cmd[i].put(("collect", version))
        deadline = time.monotonic() + COLLECT_TIMEOUT
        while len(got) < len(self.active):
            wid, entry = self._next_traj(deadline)
            got[wid] = entry
        trajs, times, loops = [], [], []
        for i in self.active:                    # deterministic merge order
            slot, seq, dt, loop_dt = got[i]
            traj, _meta = self.read_slot_checked(slot, seq)
            trajs.append(traj)
            times.append(dt)
            loops.append(loop_dt)
        return trajs, times, loops

    def _next_traj(self, deadline: float):
        """Next ("traj", ...) message before the monotonic ``deadline`` as
        (wid, (slot, seq, dt, loop_dt)); skips the other reports."""
        while True:
            msg = self._get(max(1e-3, deadline - time.monotonic()))
            if msg[0] != "traj":
                continue
            _, wid, slot, seq, _v, dt, loop_dt, _info = msg
            return wid, (slot, seq, dt, loop_dt)

    # ------------------------------------------------------------- freerun
    def start_freerun(self) -> None:
        if self._freerunning:
            return
        self._freerunning = True
        for i in self.active:
            self._cmd[i].put(("freerun",))

    def next_experience(self, timeout: float = 1.0):
        """Drain one finished rollout as ``(Experience, loop_seconds)``;
        ``None`` if nothing finished within ``timeout``."""
        from repro_torch.core.queues import Experience
        deadline = time.monotonic() + timeout
        while True:
            try:
                msg = self._get(max(1e-3, deadline - time.monotonic()))
            except TimeoutError:
                return None
            if msg[0] != "traj":
                if time.monotonic() > deadline:
                    return None
                continue
            _, wid, slot, seq, version, dt, _loop, _info = msg
            traj, meta = self.read_slot_checked(slot, seq)
            return (Experience(traj=traj, policy_version=version,
                               sampler_id=wid, collect_seconds=dt),
                    meta["loop_seconds"])

    # ------------------------------------------------------------ lifecycle
    def close(self, raise_on_crash: bool = True) -> None:
        """Stop, join (terminate stragglers) and unlink all shared state.
        Idempotent; also runs from ``atexit``.

        A worker found dead with a nonzero exit code, that was not stopped
        here and whose crash was not already surfaced, crashed during
        shutdown. With nothing else propagating that raises
        ``WorkerCrashed`` (chained onto the earlier crash, if any); with an
        exception in flight, close stays silent so it never masks it."""
        if self._closed:
            return
        self._closed = True
        for i in self.active:
            if self._cmd[i] is not None:
                try:
                    self._cmd[i].put_nowait(("stop",))
                except Exception:
                    pass
        procs = [(i, p) for i, p in enumerate(self._procs) if p is not None]
        for _, p in procs:
            p.join(timeout=3.0)
        for i, p in procs:
            if p.is_alive():
                self._terminated.add(i)
                p.terminate()
        for _, p in procs:
            p.join(timeout=3.0)
        for i, p in procs:
            if p.is_alive():            # ignored SIGTERM: wedged
                p.kill()
                p.join(timeout=3.0)
        # the reports nobody consumed still say what the workers launched
        self.drain_pending()
        for msg in self._stash:
            self._note(msg)
        shutdown_crashes = [
            (i, p.exitcode) for i, p in procs
            if p.exitcode not in (0, None)
            and i not in self._terminated
            and i not in self._crash_surfaced]
        for q in [q for q in self._cmd if q is not None] + self._retired + [
                self._res]:
            try:
                q.close()
                q.cancel_join_thread()
            except Exception:
                pass
        self.ring.close(unlink=True)
        self.channel.close(unlink=True)
        self.heartbeat.close(unlink=True)
        try:
            atexit.unregister(self._atexit)
        except Exception:
            pass
        if (shutdown_crashes and raise_on_crash
                and sys.exc_info()[1] is None):
            err = WorkerCrashed(
                "rollout worker(s) crashed during shutdown: " + ", ".join(
                    f"#{i} (exitcode={code})"
                    for i, code in shutdown_crashes))
            if self._last_crash is not None:
                raise err from self._last_crash
            raise err

    def __enter__(self) -> "ProcessWorkerPool":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
