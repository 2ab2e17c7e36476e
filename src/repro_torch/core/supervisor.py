"""Actor-fleet supervision: failure detection, respawn, elastic sizing
(port of ``repro/core/supervisor.py``; host code, line for line).

``ProcessWorkerPool`` exposes fleet *mechanism* (spawn/kill/respawn,
heartbeat ages, slot reclamation, seq-checked slot reads);
``WorkerSupervisor`` is the *policy* layered on top: a restartable
actor component, scoped to one host:

* **Detection** — three independent signals, all bounded in time: the
  process exited (``dead_workers``), the worker reported a Python
  exception (an ``("error", ...)`` message), or the worker is alive but
  its heartbeat stopped (``heartbeat_age > hang_timeout`` — a wedged
  worker, which is then SIGKILLed into the dead case). The supervisor
  never blocks forever on the result queue: every wait is a bounded
  poll interleaved with these checks.
* **Recovery** — the dead worker's ring slots are reclaimed (torn
  seqlocks repaired, orphaned writes released; completed rollouts whose
  result message already arrived are kept and consumed normally), then
  the worker is respawned from its serializable ``WorkerSpec`` under
  exponential backoff. A per-worker *consecutive*-failure counter (reset
  by any successful rollout) enforces the crash-loop budget: more than
  ``max_respawns`` failures in a row raises ``WorkerCrashed`` — a worker
  that dies every time it runs is a bug, not an outage.
* **Exactly-once consumption** — trajectory messages carry the slot's
  post-write seqlock value; ``read_slot_checked`` refuses a message
  whose slot has since been reclaimed and rewritten
  (``StaleSlotMessage`` -> counted discard). No trajectory is consumed
  twice, and none that was *reported* is lost.
* **Elastic sizing** — ``autoscale`` nudges the active set toward a
  ``worker_utilization`` band between iterations: utilization above
  ``util_high`` means samplers are the bottleneck -> ``grow``; below
  ``util_low`` they idle on backpressure -> ``shrink``. One step per
  call, ``resize_cooldown`` iterations apart, clamped to
  [``min_workers``, ``max_workers``]. Joiners read the current params
  from the already-provisioned ``ParamsChannel`` on their first rollout.

The supervisor mirrors the pool's two driving modes (``collect`` for
lock-step, ``next_experience`` for free-run) so backends and the async
orchestrator swap it in without restructuring.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, List, Optional, Tuple

from repro_torch.core.ipc import (
    COLLECT_TIMEOUT,
    ProcessWorkerPool,
    RingSlotStuck,
    StaleSlotMessage,
    WorkerCrashed,
)


@dataclasses.dataclass(frozen=True)
class SupervisorConfig:
    """Respawn, hang-detection and elastic-resize policy knobs."""

    max_respawns: int = 3        # consecutive failures per worker before
                                 # the crash-loop budget raises
    backoff_base: float = 0.25   # backoff = min(base * 2^(n-1), max)
    backoff_max: float = 5.0
    hang_timeout: float = 120.0  # heartbeat age that declares a hang; must
                                 # exceed the longest legitimate rollout
    min_workers: Optional[int] = None   # autoscale floor (None: no shrink
                                        # below 1 / elastic off)
    max_workers: Optional[int] = None   # autoscale ceiling (None: pool
                                        # provisioning is the ceiling)
    util_low: float = 0.5        # shrink below this utilization ...
    util_high: float = 0.9       # ... grow above this
    resize_cooldown: int = 2     # iterations between resize steps

    @property
    def elastic(self) -> bool:
        return self.min_workers is not None or self.max_workers is not None


@dataclasses.dataclass(frozen=True)
class SupervisorEvent:
    """One supervision decision, for logs/tests: kind is ``respawn`` /
    ``grow`` / ``shrink``."""
    kind: str
    worker_id: int
    time: float
    detail: str


class WorkerSupervisor:
    """Failure-detection + respawn + elastic-resize policy over a
    ``ProcessWorkerPool`` (see module docstring for the protocol)."""

    def __init__(self, pool: ProcessWorkerPool,
                 cfg: Optional[SupervisorConfig] = None):
        self.pool = pool
        self.cfg = cfg or SupervisorConfig()
        self.events: List[SupervisorEvent] = []
        self.respawns = 0            # lifetime respawn count
        self.slots_reclaimed = 0
        self.stale_discards = 0      # messages dropped by the seq check
        self.recovery_s: List[float] = []   # death-detected -> respawned
        self._consec: dict = {}      # wid -> consecutive failures
        self._cooldown = 0

    # ----------------------------------------------------------- recovery
    def _respawn(self, wid: int, reason: str) -> None:
        """Reclaim + respawn worker ``wid``, enforcing backoff and the
        crash-loop budget. Raises ``WorkerCrashed`` when the budget is
        exhausted."""
        t0 = time.monotonic()
        n = self._consec.get(wid, 0) + 1
        self._consec[wid] = n
        if n > self.cfg.max_respawns:
            self.pool._crash_surfaced.add(wid)   # close() must not re-raise
            err = WorkerCrashed(
                f"rollout worker #{wid} is crash-looping: {n} consecutive "
                f"failures (crash-loop budget max_respawns="
                f"{self.cfg.max_respawns}); last failure: {reason}")
            self.pool._last_crash = err
            raise err
        backoff = min(self.cfg.backoff_base * (2.0 ** (n - 1)),
                      self.cfg.backoff_max)
        time.sleep(backoff)
        reclaimed = self.pool.reclaim_worker_slots(wid)
        self.slots_reclaimed += len(reclaimed)
        self.pool.respawn(wid)
        self.respawns += 1
        self.recovery_s.append(time.monotonic() - t0)
        self.events.append(SupervisorEvent(
            "respawn", wid, time.monotonic(),
            f"{reason}; backoff {backoff:.2f}s; incarnation "
            f"{self.pool._incarnation[wid]}; reclaimed slots {reclaimed}"))

    def _sweep_failures(self, on_dead) -> None:
        """Check every bounded-time failure signal once; route each dead
        worker through ``on_dead(wid, reason)``."""
        for wid, code in self.pool.dead_workers():
            on_dead(wid, f"process exited (exitcode={code})")
        for wid in list(self.pool.active):
            age = self.pool.heartbeat_age(wid)
            if age > self.cfg.hang_timeout:
                self.pool.kill_worker(wid)
                on_dead(wid, f"hung: no heartbeat for {age:.1f}s "
                             f"(hang_timeout={self.cfg.hang_timeout:.0f}s)")

    def _has_pending_traj(self, wid: int) -> bool:
        self.pool.drain_pending()
        return any(m[0] == "traj" and m[1] == wid
                   for m in self.pool._stash)

    # ---------------------------------------------------------- lock-step
    def collect(self) -> Tuple[List[Any], List[float], List[float]]:
        """Supervised lock-step sweep: same contract as
        ``ProcessWorkerPool.collect`` (one trajectory per active worker,
        worker-index merge order), but a worker that dies mid-sweep is
        respawned and its command re-issued — unless its completed
        rollout already reached the result queue, in which case that
        result is consumed and nothing is re-run (exactly-once)."""
        pool = self.pool
        if pool._freerunning:
            raise RuntimeError(
                "pool is free-running (async mode); lock-step collect() "
                "would interleave with unsolicited rollouts")
        version = pool.channel.version
        got = {}

        def on_dead(wid: int, reason: str) -> None:
            self._respawn(wid, reason)
            if wid not in got and not self._has_pending_traj(wid):
                pool.send(wid, ("collect", version))

        def gather_one(deadline: float) -> None:
            while True:
                if time.monotonic() > deadline:
                    raise TimeoutError(
                        f"no worker result within "
                        f"{COLLECT_TIMEOUT:.0f}s (supervised collect)")
                msg = pool.poll_msg(timeout=0.25)
                if msg is None:
                    self._sweep_failures(on_dead)
                    continue
                if msg[0] == "error":
                    on_dead(msg[1], f"raised:\n{msg[2]}")
                    continue
                if msg[0] != "traj":
                    continue
                _, wid, slot, seq, _v, dt, loop_dt, _info = msg
                self._consec[wid] = 0
                if wid in got:           # duplicate: free the slot, drop
                    try:
                        pool.read_slot_checked(slot, seq)
                    except (StaleSlotMessage, RingSlotStuck):
                        pass
                    self.stale_discards += 1
                    continue
                got[wid] = (slot, seq, dt, loop_dt)
                return

        targets = list(pool.active)
        for i in targets:
            pool.send(i, ("collect", version))
        deadline = time.monotonic() + COLLECT_TIMEOUT
        while len(got) < len(targets):
            gather_one(deadline)
        trajs, times, loops = [], [], []
        for i in targets:                    # deterministic merge order
            slot, seq, dt, loop_dt = got[i]
            traj, _meta = pool.read_slot_checked(slot, seq)
            trajs.append(traj)
            times.append(dt)
            loops.append(loop_dt)
        return trajs, times, loops

    # ------------------------------------------------------------ freerun
    def next_experience(self, timeout: float = 1.0):
        """Supervised drain of one free-run rollout: same contract as
        ``ProcessWorkerPool.next_experience`` (``(Experience,
        loop_seconds)`` or ``None`` on timeout), with death/hang sweeps
        between polls, stale-message discards, and stuck-slot
        reclamation instead of a consumer hang."""
        from repro_torch.core.queues import Experience
        pool = self.pool

        def on_dead(wid: int, reason: str) -> None:
            # respawn re-enters freerun by itself (pool._freerunning)
            self._respawn(wid, reason)

        deadline = time.monotonic() + timeout
        while True:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                return None
            msg = pool.poll_msg(timeout=min(0.25, remaining))
            if msg is None:
                self._sweep_failures(on_dead)
                continue
            if msg[0] == "error":
                on_dead(msg[1], f"raised:\n{msg[2]}")
                continue
            if msg[0] != "traj":
                continue
            _, wid, slot, seq, version, dt, _loop, _info = msg
            self._consec[wid] = 0
            try:
                traj, meta = pool.read_slot_checked(slot, seq)
            except StaleSlotMessage:
                self.stale_discards += 1
                continue
            except RingSlotStuck as e:
                # a fresh torn write landed on this exact slot between the
                # seq check and the read; repair it and move on — the
                # writer's death will surface on the next sweep
                if pool.ring.reclaim(e.slot) is not None:
                    self.slots_reclaimed += 1
                continue
            return (Experience(traj=traj, policy_version=version,
                               sampler_id=wid, collect_seconds=dt),
                    meta["loop_seconds"])

    # ---------------------------------------------------------- elasticity
    def autoscale(self, utilization: float) -> Optional[Tuple[str, int]]:
        """One bounded resize step toward the utilization band; returns
        ``("grow"|"shrink", wid)`` or ``None``. Call between iterations
        with the latest ``IterationLog.worker_utilization``."""
        cfg = self.cfg
        if not cfg.elastic:
            return None
        if self._cooldown > 0:
            self._cooldown -= 1
            return None
        lo = max(1, cfg.min_workers or 1)
        hi = min(self.pool.max_workers,
                 cfg.max_workers or self.pool.max_workers)
        active = len(self.pool.active)
        if utilization > cfg.util_high and active < hi:
            wid = self.pool.grow()
            if wid is not None:
                self._cooldown = cfg.resize_cooldown
                self.events.append(SupervisorEvent(
                    "grow", wid, time.monotonic(),
                    f"utilization {utilization:.2f} > {cfg.util_high} "
                    f"({active} -> {active + 1} workers)"))
                return ("grow", wid)
        elif utilization < cfg.util_low and active > lo:
            wid = self.pool.shrink()
            if wid is not None:
                self._cooldown = cfg.resize_cooldown
                self.events.append(SupervisorEvent(
                    "shrink", wid, time.monotonic(),
                    f"utilization {utilization:.2f} < {cfg.util_low} "
                    f"({active} -> {active - 1} workers)"))
                return ("shrink", wid)
        return None
