"""WALL-E's agent processor (port of ``repro/core/orchestrator.py``; the
overlap schedule is in ROADMAP.md).

* ``SyncRunner`` — collect (via a backend) -> learn -> repeat.
* ``AsyncOrchestrator`` — the paper's architecture: N samplers generate
  experience with the freshest published policy (maybe stale) while a
  learner consumes it and publishes new parameters. The samplers are
  threads (``PolicyStore`` + ``ExperienceQueue``) or free-running worker
  processes (``ipc.ProcessWorkerPool``).

Both assemble their ``IterationLog`` through ``assemble_log`` and
``record_log``, so the collect/learn accounting has one definition. Every
timed phase ends in a device barrier, so ``collect_time``/``learn_time``
measure the work and not its launches.
"""
from __future__ import annotations

import dataclasses
import queue as _queue
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Sequence

import torch

from repro_torch.algos.staleness import GAP_KEY
from repro_torch.core.backends import (
    BackendCloseMixin,
    merge_trajs,
    timed_rollout,
    to_device,
)
from repro_torch.core.queues import Experience, ExperienceQueue, PolicyStore
from repro_torch.core.timing import PhaseTimer, synchronize
from repro_torch.data import trajectory


@dataclasses.dataclass
class IterationLog:
    """One iteration's accounting; the same fields as the reference's, so
    the JSON lines of both packages compare key for key."""
    iteration: int
    collect_time: float          # critical-path (parallel) collection time
    collect_time_serial: float   # sum over samplers (1-process equivalent)
    learn_time: float
    mean_return: float
    samples: int
    staleness: float = 0.0       # mean (learner version - version acted
    #                              with) over this iteration's experience
    queue_drops: int = 0         # async threads: experiences dropped on a
    #                              full queue, cumulative
    worker_utilization: float = 1.0   # async processes: rollout time over
    #                                   worker loop time, this iteration
    respawns: int = 0            # supervised worker respawns, cumulative
    active_workers: int = 0      # process pool size this iteration
    overlap_saved_s: float = 0.0

    def as_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)


def timed_train_step(train_step: Callable, params, opt_state, plane_state,
                     merged):
    """One observe -> sample -> learn step, finished on the device and
    timed."""
    t0 = time.perf_counter()
    params, opt_state, plane_state, metrics = train_step(
        params, opt_state, plane_state, merged)
    synchronize(merged["rewards"].device)
    return params, opt_state, plane_state, metrics, time.perf_counter() - t0


def assemble_log(iteration: int, per_sampler_seconds: Sequence[float],
                 learn_time: float, merged,
                 samples: Optional[int] = None,
                 staleness: float = 0.0,
                 queue_drops: int = 0,
                 worker_utilization: float = 1.0,
                 respawns: int = 0,
                 active_workers: int = 0) -> IterationLog:
    """The single definition of per-iteration accounting (sync and
    async)."""
    return IterationLog(
        iteration=iteration,
        collect_time=max(per_sampler_seconds),
        collect_time_serial=sum(per_sampler_seconds),
        learn_time=learn_time,
        mean_return=float(trajectory.episode_returns(merged)),
        samples=(samples if samples is not None
                 else trajectory.num_samples(merged)),
        staleness=staleness,
        queue_drops=queue_drops,
        worker_utilization=worker_utilization,
        respawns=respawns,
        active_workers=active_workers,
    )


def record_log(logs: List[IterationLog], timer: PhaseTimer,
               log: IterationLog) -> None:
    logs.append(log)
    timer.add("collect", log.collect_time)
    timer.add("learn", log.learn_time)


class SyncRunner(BackendCloseMixin):
    """collect (backend) -> train step -> repeat, owning the plane state
    ``(buffer_state, generator)`` explicitly."""

    def __init__(self, backend, train_step: Callable, params: Any,
                 opt_state: Any, plane_state: Any = None):
        self.backend = backend
        self._train_step = train_step
        self.params = params
        self.opt_state = opt_state
        self.plane_state = plane_state
        self.num_samplers = backend.num_samplers
        self.timer = PhaseTimer()
        self.logs: List[IterationLog] = []

    def run(self, iterations: int) -> List[IterationLog]:
        for it in range(iterations):
            merged, stats = self.backend.collect(self.params)
            (self.params, self.opt_state, self.plane_state, _,
             learn_time) = timed_train_step(
                 self._train_step, self.params, self.opt_state,
                 self.plane_state, merged)
            record_log(self.logs, self.timer,
                       assemble_log(it, stats.per_sampler_seconds,
                                    learn_time, merged, stats.samples,
                                    respawns=stats.respawns,
                                    active_workers=stats.active_workers))
        return self.logs

    def close(self) -> None:
        self.backend.close()


class AsyncOrchestrator(BackendCloseMixin):
    """The paper's architecture (Fig 2): N samplers + a learner.

    Sampler i loop:  params <- PolicyStore (latest, maybe stale)
                     traj   <- rollout
                     ExperienceQueue.put(traj, version)
    Learner loop:    drain >= min_batches experiences
                     params <- train step (in place)
                     PolicyStore.publish(params)

    Two sampler substrates: threads in this process (``rollout`` and
    ``carries``), or, with ``pool=`` (an ``ipc.ProcessWorkerPool``), worker
    processes collecting continuously into the shared-memory ring while
    this process's learner drains it. In pool mode the policy queue is the
    ``ParamsChannel`` (one publish per update), the ring is the
    backpressure (nothing is dropped), and ``IterationLog`` also reports
    ``worker_utilization`` (rollout time over worker loop time, windowed
    per iteration); trajectories are moved onto ``device``.

    The learner owns the live params (``self.params``) and updates them in
    place; samplers only ever see the snapshots ``PolicyStore`` holds.
    Every thread launches on the default stream, so a snapshot is ordered
    before any rollout that reads it.

    ``supervisor=`` (a ``core.supervisor.WorkerSupervisor`` over the same
    pool): worker deaths and hangs are respawned mid-run, and
    ``autoscale`` nudges the fleet size between updates. ``staleness=``
    (an enabled ``algos.staleness.StalenessConfig``): every consumed
    trajectory is stamped with its params-version gap for the learner's
    correction; disabled (the default), nothing is attached.
    """

    def __init__(self, train_step: Callable, params: Any, opt_state: Any,
                 plane_state: Any = None, *,
                 rollout: Optional[Callable] = None,
                 carries: Optional[List[Any]] = None,
                 pool=None, device=None, supervisor=None, staleness=None,
                 min_batches_per_update: int = 1):
        if pool is None:
            if rollout is None or carries is None:
                raise ValueError("sampler threads need a rollout and one "
                                 "carry per sampler (or pass pool=)")
            self.num_samplers = len(carries)
        else:
            if device is None:
                raise ValueError("pool mode needs the learner's device, "
                                 "where trajectories are moved")
            self.num_samplers = pool.num_workers
        self.pool = pool
        self.device = None if device is None else torch.device(device)
        self.supervisor = supervisor
        self.staleness = staleness
        self.rollout = rollout
        self.carries = carries
        self._train_step = train_step
        self.params = params
        self.opt_state = opt_state
        self.plane_state = plane_state
        self.store = PolicyStore(params)
        self.expq = ExperienceQueue()
        self.min_batches = min_batches_per_update
        self.timer = PhaseTimer()
        self.logs: List[IterationLog] = []
        self._stop = threading.Event()
        self._errors: List[BaseException] = []

    def _attach_gap(self, traj, gap: float):
        """Stamp the params-version gap onto every step of one trajectory
        (a (T, B) float32 ``staleness_gap`` leaf), for the learner's
        correction after merging. Called only when staleness correction is
        enabled."""
        ref = traj["rewards"]
        traj = dict(traj)
        traj[GAP_KEY] = torch.full(tuple(ref.shape[:2]),
                                   float(max(0.0, gap)),
                                   dtype=torch.float32, device=ref.device)
        return traj

    def _learn(self, it: int, trajs, per_sampler_seconds, **accounting):
        """One update on the merged ``trajs``; publishes the new params
        and records the iteration's log. Returns the log."""
        merged = merge_trajs(trajs)
        (self.params, self.opt_state, self.plane_state, _,
         learn_time) = timed_train_step(
             self._train_step, self.params, self.opt_state,
             self.plane_state, merged)
        self.store.publish(self.params)
        if self.pool is not None:
            self.pool.publish(self.params)
        log = assemble_log(it, per_sampler_seconds, learn_time, merged,
                           **accounting)
        record_log(self.logs, self.timer, log)
        return log

    # ------------------------------------------------------------ threads
    def _guarded(self, fn, *args) -> None:
        """Run a thread's loop; an exception stops the run and is raised
        again from ``run``."""
        try:
            fn(*args)
        except BaseException as e:
            self._errors.append(e)
            self._stop.set()

    def _sampler_loop(self, i: int) -> None:
        while not self._stop.is_set():
            params, version = self.store.read()
            self.carries[i], traj, dt = timed_rollout(
                self.rollout, params, self.carries[i])
            # on overflow the experience is dropped and counted
            # (ExperienceQueue.drop_count -> IterationLog.queue_drops)
            if (not self.expq.put(Experience(traj, version, i, dt),
                                  timeout=5.0)
                    and self._stop.is_set()):
                return

    def _learner_loop(self, updates: int) -> None:
        for it in range(updates):
            exps: List[Experience] = []
            t_wait0 = time.perf_counter()
            while len(exps) < self.min_batches and not self._stop.is_set():
                try:
                    exps.append(self.expq.get(self.store.version,
                                              timeout=1.0))
                except _queue.Empty:
                    continue
            if self._stop.is_set() and not exps:
                return
            wait = time.perf_counter() - t_wait0
            trajs = [e.traj for e in exps]
            if self.staleness is not None and self.staleness.enabled:
                trajs = [self._attach_gap(
                    t, self.store.version - e.policy_version)
                    for t, e in zip(trajs, exps)]
            self._learn(it, trajs, [e.collect_seconds for e in exps],
                        staleness=self.expq.mean_staleness(),
                        queue_drops=self.expq.drop_count)
            self.timer.add("collect_wait", wait)

    # ------------------------------------------------- process-pool learner
    def _learner_loop_pool(self, updates: int, deadline: float) -> None:
        """Drain the shared-memory ring while worker processes free-run.
        Returns early (like the thread path's learner join) once
        ``deadline`` passes with workers alive but unproductive.

        The accounting is windowed per iteration: ``staleness`` and
        ``worker_utilization`` cover only the experiences this update
        consumed, so a worker dying and being respawned shows in that
        iteration's numbers. With a supervisor, draining, failure handling
        and (between iterations) resizing all go through it."""
        it0 = len(self.logs)
        source = self.supervisor if self.supervisor is not None else self.pool
        stale_on = self.staleness is not None and self.staleness.enabled
        for it in range(updates):
            exps, gaps = [], []
            collect_s = loop_s = 0.0         # this iteration's window only
            t_wait0 = time.perf_counter()
            while len(exps) < self.min_batches and not self._stop.is_set():
                if time.monotonic() > deadline:
                    return
                got = source.next_experience(timeout=1.0)
                if got is None:
                    continue
                exp, loop_dt = got
                exps.append(exp)
                collect_s += exp.collect_seconds
                loop_s += loop_dt
                gaps.append(max(0, self.pool.version - exp.policy_version))
            if self._stop.is_set() and not exps:
                return
            wait = time.perf_counter() - t_wait0
            trajs = [to_device(e.traj, self.device) for e in exps]
            if stale_on:
                trajs = [self._attach_gap(t, g) for t, g in zip(trajs, gaps)]
            util = collect_s / loop_s if loop_s > 0 else 1.0
            self._learn(it0 + it, trajs, [e.collect_seconds for e in exps],
                        staleness=float(sum(gaps) / len(gaps)),
                        worker_utilization=util,
                        respawns=(self.supervisor.respawns
                                  if self.supervisor else 0),
                        active_workers=self.pool.num_workers)
            self.timer.add("collect_wait", wait)
            if self.supervisor is not None:
                self.supervisor.autoscale(util)

    # ---------------------------------------------------------------- run
    def run(self, updates: int, timeout: float = 600.0) -> List[IterationLog]:
        """``updates`` learner steps; returns early, with fewer logs, if
        ``timeout`` seconds pass first."""
        if self.pool is not None:
            # the worker processes are the sampler concurrency; the learner
            # runs right here, and the timeout bounds a wedged but alive
            # worker as the thread path's learner join does
            self.pool.start_freerun()
            self._learner_loop_pool(updates, time.monotonic() + timeout)
            return self.logs
        samplers = [threading.Thread(target=self._guarded,
                                     args=(self._sampler_loop, i),
                                     daemon=True)
                    for i in range(self.num_samplers)]
        learner = threading.Thread(target=self._guarded,
                                   args=(self._learner_loop, updates),
                                   daemon=True)
        for t in samplers:
            t.start()
        learner.start()
        learner.join(timeout=timeout)
        self._stop.set()
        for t in samplers:
            t.join(timeout=30.0)
        if self._errors:
            raise self._errors[0]
        return self.logs

    def close(self) -> None:
        """Stop sampler threads or reap worker processes (idempotent).
        With a supervisor, a worker death is a tolerated event: one landing
        between the last drained experience and shutdown must not
        resurface as ``WorkerCrashed`` from ``close``."""
        self._stop.set()
        if self.pool is not None:
            self.pool.close(raise_on_crash=self.supervisor is None)
