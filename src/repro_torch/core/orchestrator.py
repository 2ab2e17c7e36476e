"""WALL-E's agent processor (port of ``repro/core/orchestrator.py``).

* ``SyncRunner`` — collect (via a backend) -> learn -> repeat; with
  ``overlap=True`` the collect of iteration k+1 runs while the learn of
  iteration k does (``tree_ready``, ``OverlapClock``).
* ``AsyncOrchestrator`` — the paper's architecture: N samplers generate
  experience with the freshest published policy (maybe stale) while a
  learner consumes it and publishes new parameters. The samplers are
  threads (``PolicyStore`` + ``ExperienceQueue``) or free-running worker
  processes (``ipc.ProcessWorkerPool``).

Both assemble their ``IterationLog`` through ``assemble_log`` and
``record_log``, so the collect/learn accounting has one definition. Every
timed phase ends in a barrier on its own stream
(``timing.stream_synchronize``), so ``collect_time``/``learn_time``
measure the work and not its launches, and under overlap neither phase
waits for the other.

The overlap schedule on the card is two CUDA streams: the learn is issued
on a learner stream from a learner thread (its host launches run while the
main thread drives the collect), the collect on a collect stream from the
main thread, and an event recorded at the end of the learn tells
``tree_ready`` whether it had finished when the collect did. The learners
update their params in place, so the collect acts with a static copy of
the params taken before the learn is issued (``queues.refresh``), never
with the tensors the learn writes.
"""
from __future__ import annotations

import dataclasses
import queue as _queue
import threading
import time
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Any, Callable, Dict, List, Optional, Sequence

import torch

from repro_torch.algos.staleness import GAP_KEY
from repro_torch.core.backends import (
    BackendCloseMixin,
    merge_trajs,
    timed_rollout,
    to_device,
)
from repro_torch.core.queues import (
    Experience,
    ExperienceQueue,
    PolicyStore,
    refresh,
    snapshot,
    state_tensors,
)
from repro_torch.core.timing import PhaseTimer, on_stream, stream_synchronize
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
    overlap_saved_s: float = 0.0  # overlap: learn seconds hidden under the
    #                               next collect (0 on serial iterations);
    #                               learn_time is then the exposed learn, so
    #                               collect + learn + saved ~ the serial wall

    def as_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)


def timed_train_step(train_step: Callable, params, opt_state, plane_state,
                     merged):
    """One observe -> sample -> learn step, finished on the current stream
    and timed."""
    t0 = time.perf_counter()
    params, opt_state, plane_state, metrics = train_step(
        params, opt_state, plane_state, merged)
    stream_synchronize(merged["rewards"].device)
    return params, opt_state, plane_state, metrics, time.perf_counter() - t0


def assemble_log(iteration: int, per_sampler_seconds: Sequence[float],
                 learn_time: float, merged,
                 samples: Optional[int] = None,
                 staleness: float = 0.0,
                 queue_drops: int = 0,
                 worker_utilization: float = 1.0,
                 respawns: int = 0,
                 active_workers: int = 0,
                 overlap_saved_s: float = 0.0) -> IterationLog:
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
        overlap_saved_s=overlap_saved_s,
    )


def tree_ready(tree) -> bool:
    """True iff everything in ``tree`` has finished: a non-blocking probe
    the overlap schedule uses to tell whether the learn in flight was still
    running when the concurrent collect finished (the reference's
    ``jax.Array.is_ready`` over the learn's outputs).

    A ``torch.cuda.Event`` is ready once the work recorded before it has
    run (``query``), a ``Future`` once its thread has returned (``done``);
    tensors on the CPU, host values and ``None`` are ready. A CUDA tensor
    cannot tell: probe the event recorded after the work that writes it
    (a ``TypeError`` otherwise)."""
    if tree is None:
        return True
    if isinstance(tree, (list, tuple)):
        return all(tree_ready(x) for x in tree)
    if isinstance(tree, dict):
        return all(tree_ready(x) for x in tree.values())
    if isinstance(tree, Future):
        return tree.done()
    if isinstance(tree, torch.cuda.Event):
        return bool(tree.query())
    if isinstance(tree, torch.Tensor) and tree.device.type != "cpu":
        raise TypeError("tree_ready cannot probe a device tensor; pass the "
                        "torch.cuda.Event recorded after the work that "
                        "writes it")
    return True


class OverlapClock:
    """Accounting for the pipelined schedule (the reference's).

    ``overlap_saved_s`` is the learn wall-clock hidden under the concurrent
    collect, i.e. serial schedule minus pipelined schedule for this
    iteration. Two cases at the moment the collect returns:

    * the learn is **not** finished -> it ran under the entire collect,
      so the hidden portion is the whole collect duration;
    * the learn **is** finished -> the hidden portion is the learn's own
      duration, estimated by ``learn_ref`` — the fastest *serial* learn
      observed during warmup (after the first iteration, which builds
      what it needs, so it is a clean reference), capped by the collect
      duration.
    """

    def __init__(self):
        self.learn_ref: Optional[float] = None

    def note_serial(self, learn_s: float) -> None:
        self.learn_ref = (learn_s if self.learn_ref is None
                          else min(self.learn_ref, learn_s))

    def saved(self, collect_s: float, learn_ready: bool) -> float:
        if not learn_ready:
            return collect_s
        ref = self.learn_ref if self.learn_ref is not None else collect_s
        return min(ref, collect_s)


# serial iterations before the overlap schedule pipelines: the first builds
# what it needs, the second gives the clock its serial learn reference
OVERLAP_WARMUP = 2


def record_log(logs: List[IterationLog], timer: PhaseTimer,
               log: IterationLog) -> None:
    logs.append(log)
    timer.add("collect", log.collect_time)
    timer.add("learn", log.learn_time)


class SyncRunner(BackendCloseMixin):
    """collect (backend) -> train step -> repeat, owning the plane state
    ``(buffer_state, generator)`` explicitly.

    Overlap (``overlap=True``, needs the train step): after two serial
    warm-up iterations (the first builds what it needs, the second gives
    the clock its serial learn reference), learn k is issued without
    waiting for it and collect k+1 runs while it executes, acting with the
    params learn k starts from: one version stale, stamped
    ``staleness=1.0`` on the iteration that consumes it.
    ``IterationLog.overlap_saved_s`` is the learn time hidden under the
    collect (``OverlapClock``) and ``learn_time`` the exposed rest of the
    window. Runs of at most two iterations equal the serial schedule bit
    for bit.

    Issuing without waiting: the learn runs in a learner thread, on a
    learner stream on the card, while the main thread drives the collect
    on a collect stream. The learn reads the trajectory the collect stream
    made after that stream's work so far (``wait_stream``), and each leaf
    is marked used by the learner stream (``record_stream``), so the
    allocator never hands its memory back to the collect while the learn
    reads it. The collect acts with ``_collect_params``, a static copy of
    the params refreshed on the collect stream before the learn is issued:
    never the tensors the learn updates in place. The process backend
    publishes that copy to its workers.
    """

    def __init__(self, backend, train_step: Callable, params: Any,
                 opt_state: Any, plane_state: Any = None,
                 overlap: bool = False):
        if overlap and train_step is None:
            raise ValueError(
                "overlap=True requires the experience-plane train_step "
                "(the raw learn path has no buffer to double-buffer)")
        self.backend = backend
        self._train_step = train_step
        self.params = params
        self.opt_state = opt_state
        self.plane_state = plane_state
        self.num_samplers = backend.num_samplers
        self.timer = PhaseTimer()
        self.logs: List[IterationLog] = []
        self.overlap = overlap
        self._overlap_clock = OverlapClock()
        # iterations of the pipeline's lifetime: the warm-up is paid once
        # per runner, not once per run() call
        self._overlap_done = 0
        self._collect_params = None
        self._learner: Optional[ThreadPoolExecutor] = None
        self._streams = None        # (collect, learn) on the card

    def run(self, iterations: int) -> List[IterationLog]:
        if self.overlap:
            return self._run_overlapped(iterations)
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

    # ----------------------------------------------------------- overlap
    def _learn(self, merged, stream, done):
        """The learner thread's body: the train step issued on ``stream``,
        then ``done`` recorded there."""
        with on_stream(stream):
            out = self._train_step(self.params, self.opt_state,
                                   self.plane_state, merged)
            if done is not None:
                done.record(stream)
        return out

    def _issue_learn(self, merged):
        """Issue the learn on ``merged`` without waiting for it: ``(future,
        event)``, ready (``tree_ready``) once the learner thread has issued
        all of it and the card has run it."""
        stream = self._streams[1] if self._streams else None
        done = None
        if stream is not None:
            stream.wait_stream(torch.cuda.current_stream(stream.device))
            for leaf in merged.values():
                leaf.record_stream(stream)
            done = torch.cuda.Event()
        return (self._learner.submit(self._learn, merged, stream, done),
                done)

    def _join_learn(self, pending) -> None:
        future, done = pending
        (self.params, self.opt_state, self.plane_state,
         _) = future.result()
        if done is not None:
            done.synchronize()

    def _stale_params(self):
        """The params the next learn starts from, copied into the static
        ``_collect_params`` on the current (collect) stream."""
        if self._collect_params is None:
            self._collect_params = snapshot(self.params)
        else:
            refresh(self._collect_params, self.params)
        return self._collect_params

    def _run_overlapped(self, iterations: int) -> List[IterationLog]:
        """The pipeline: issue learn k, run collect k+1 while it executes,
        then wait for it. The first ``OVERLAP_WARMUP`` iterations stay
        serial."""
        clock = self._overlap_clock
        if self._learner is None:
            self._learner = ThreadPoolExecutor(
                max_workers=1, thread_name_prefix="learner")
            device = state_tensors(self.params)[0].device
            if device.type == "cuda":
                self._streams = (torch.cuda.Stream(device),
                                 torch.cuda.Stream(device))
        caller = None
        if self._streams:
            caller = torch.cuda.current_stream(self._streams[0].device)
            for stream in self._streams:
                stream.wait_stream(caller)
        pending = None          # (merged, stats, staleness) pre-collected
        with on_stream(self._streams[0] if self._streams else None):
            for it in range(iterations):
                if pending is None:
                    merged, stats = self.backend.collect(self.params)
                    stale = 0.0
                else:
                    merged, stats, stale = pending
                    pending = None
                warm, self._overlap_done = (self._overlap_done,
                                            self._overlap_done + 1)
                saved = 0.0
                if warm < OVERLAP_WARMUP:
                    t0 = time.perf_counter()
                    self._join_learn(self._issue_learn(merged))
                    learn_time = time.perf_counter() - t0
                    if warm > 0:    # iteration 0 builds what it needs
                        clock.note_serial(learn_time)
                else:
                    # the collect acts with p_k, copied before learn k is
                    # issued: the one-version-stale policy by construction
                    params_k = (self._stale_params()
                                if it + 1 < iterations else None)
                    t0 = time.perf_counter()
                    learning = self._issue_learn(merged)
                    if params_k is not None:
                        nxt, nstats = self.backend.collect(params_k)
                        saved = clock.saved(max(nstats.per_sampler_seconds),
                                            tree_ready(learning))
                        pending = (nxt, nstats, 1.0)
                    self._join_learn(learning)
                    # the window spans the overlapped collect; less the
                    # hidden part it leaves the exposed learn, so per
                    # iteration collect + learn + saved ~ the serial wall
                    learn_time = max(0.0, time.perf_counter() - t0 - saved)
                record_log(self.logs, self.timer,
                           assemble_log(it, stats.per_sampler_seconds,
                                        learn_time, merged, stats.samples,
                                        staleness=stale,
                                        respawns=stats.respawns,
                                        active_workers=stats.active_workers,
                                        overlap_saved_s=saved))
        if caller is not None:
            for stream in self._streams:
                caller.wait_stream(stream)
        return self.logs

    def close(self) -> None:
        if self._learner is not None:
            self._learner.shutdown(wait=True)
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
