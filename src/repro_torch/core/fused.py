"""The fused engine: collect -> GAE or replay -> learn, one CUDA-graph
replay per iteration, or, under the overlap schedule, a collect graph and a
learn graph replayed at once on two streams (port of
``repro/core/fused.py``).

The stepped runners pay the host for every launch of an iteration: a
PyTorch call per op, a ``ctypes`` call per kernel, and a barrier or two
per phase. The reference rolls the whole iteration into one donated
``lax.scan`` dispatch per chunk. Its Hopper analogue here is a
``torch.cuda.CUDAGraph`` that captures one iteration over static buffers
and is replayed once per iteration, ``chunk`` replays between host syncs:

* The carried state (``TrainState``: params, optimizer state, env carry and
  the experience plane's ``(buffer_state, generator)``) is static. The
  iteration computes a new state and copies each new leaf into the static
  one it replaces, in the graph; params and replay storage are updated in
  place and copy nothing. The ring's head and size and Adam's step are
  0-dim device tensors, so nothing on the iteration's path reads the
  device from the host.
* Every ``torch.Generator`` in the state (each env carry's and the
  plane's) is registered with the graph, so each replay draws fresh noise
  from where the last one stopped, as the eager loop would.
* Capture follows two eager iterations on a side stream (``WARMUP``):
  they are real iterations, with their metrics, and they build the
  kernels and settle lazily built state. An eager iteration and a replay
  compute the same thing bit for bit, so a fused run equals the stepped
  one from the same carry.
* Metrics (``loss``, ``mean_return``, ...) stay on the device and are read
  once a chunk, stacked ``(chunk,)`` as in the reference.
* Kernel launch counts (``kernels.launch_counts``) count launches where
  they happen: a wrapper counts its eager calls; the calls it makes during
  the capture launch nothing and are taken back out, and each replay adds
  the calls the graph recorded (``graph_stats["launches_per_replay"]``).

On the CPU (only when the caller put the state there) the same iteration
runs eagerly. On CUDA, a capture or replay that fails raises: there is no
eager fallback.

One iteration is ``rollout`` then ``train_step(params, opt_state,
plane_state, traj)`` (``algos.api.make_train_step``); a learner of the
trajectory alone (``learn(params, opt_state, traj)``, the reference's other
form) runs as the train step of a fifo plane (``learner_step``).
``make_fused_train_loop`` builds ``train_chunk(state) -> (state,
metrics)``; ``FusedRunner`` wraps the engine in the runner interface
(``run`` -> ``IterationLog`` list).

``FusedRunner(overlap=True)`` runs the reference's pipelined schedule over
two engines, one for each half of the iteration: the collect (the env
carry's generator registered with its graph) and the learn (the plane's),
each graph with a memory pool of its own. Both graphs are captured
before the second of the two serial iterations, so the serial learn that
gives the clock its reference is a replay, as every pipelined learn is.
After the serial iterations, learn k is replayed on a learner stream while
collect k+1 is replayed on a collect stream with the params learn k starts
from; the trajectory is copied into the learn's own buffer, and the params
into the collect's static copy, on the collect stream between iterations.
``chunk`` is ignored under overlap.
"""
from __future__ import annotations

import time
from typing import Any, Callable, Dict, List, NamedTuple, Optional

import torch

from repro_torch import kernels
from repro_torch.core import sampler as sampler_mod
from repro_torch.core.backends import BackendCloseMixin
from repro_torch.core.orchestrator import (
    OVERLAP_WARMUP,
    IterationLog,
    OverlapClock,
    record_log,
    tree_ready,
)
from repro_torch.core.queues import (
    refresh,
    snapshot,
    state_generators,
    state_tensors,
)
from repro_torch.core.timing import (
    PhaseTimer,
    on_stream,
    stream_synchronize,
    synchronize,
)
from repro_torch.data import trajectory


class TrainState(NamedTuple):
    """Everything the fused loop carries across iterations. ``plane_state``
    is the experience plane's ``(buffer_state, generator)``: replay rings
    and sum trees live in the carry and are updated in place."""
    params: Any
    opt_state: Any
    env_carry: Any
    plane_state: Any = None


def learner_step(learn: Callable) -> Callable:
    """``learn(params, opt_state, traj) -> (params, opt_state, metrics)`` as
    a train step over a fifo plane, which hands the trajectory straight to
    the learner (``make_train_step`` with the fifo buffer, as PPO runs)."""

    def step(params, opt_state, plane_state, traj):
        params, opt_state, metrics = learn(params, opt_state, traj)
        return params, opt_state, plane_state, metrics

    return step


def make_iteration(rollout: Callable, train_step: Callable) -> Callable:
    """``one_iteration(state) -> (state', metrics)``: collect with
    ``rollout(params, env_carry)``, then ``train_step(params, opt_state,
    plane_state, traj)``, with the collected ``mean_return`` beside the
    train step's metrics."""

    def one_iteration(state: TrainState):
        env_carry, traj = rollout(state.params, state.env_carry)
        params, opt_state, plane_state, metrics = train_step(
            state.params, state.opt_state, state.plane_state, traj)
        metrics = dict(metrics)
        metrics["mean_return"] = trajectory.episode_returns(traj)
        return TrainState(params, opt_state, env_carry, plane_state), metrics

    return one_iteration


class FusedEngine:
    """Runs ``one_iteration`` over a state it keeps static: the state the
    first iteration returns, whose tensors every later iteration
    overwrites in place. On CUDA the first ``warmup`` iterations
    (``WARMUP`` unless the caller gives fewer) run eagerly on a side
    stream, then one iteration is captured in a CUDA graph (in a memory
    pool of its own, ``pool``) and each later one is a replay. On the CPU
    every iteration runs eagerly.

    ``run(state, n)`` runs ``n`` iterations and returns ``(state,
    metrics)``, each metric a float32 ``(n,)`` CPU tensor, read with one
    host sync; every later ``run`` takes the state it returned. The overlap
    schedule drives two engines step by step instead (``eager``,
    ``capture``, ``replay``). ``graph_stats`` holds the warm-up and capture
    seconds, the graph pool's MiB and the kernel launches a replay
    makes."""

    # eager iterations before the capture: the first builds what a
    # capture cannot, the second runs on the state made static
    WARMUP = 2

    def __init__(self, one_iteration: Callable, warmup: int = WARMUP):
        self.one_iteration = one_iteration
        self.warmup = warmup            # eager iterations before a capture
        self.state = None
        self._tensors: List[torch.Tensor] = []     # the static state's
        self.keys: Optional[List[str]] = None
        self.graph = None
        self.pool = None
        self._graph_out: Optional[torch.Tensor] = None
        self.eager_iterations = 0       # iterations run eagerly, and
        self.replays = 0                # replayed from the graph
        self.graph_stats: Dict[str, Any] = {}

    # ------------------------------------------------------------ eager
    def _stack(self, metrics) -> Optional[torch.Tensor]:
        """The metrics as one float32 vector (``keys``' order), or ``None``
        for an iteration that reports none."""
        if self.keys is None:
            self.keys = list(metrics)
        if not self.keys:
            return None
        return torch.stack([metrics[k].detach().reshape(()).to(torch.float32)
                            for k in self.keys])

    def _first(self, state) -> Optional[torch.Tensor]:
        """The first iteration, from the caller's state: its result becomes
        the static state. No two of its leaves may share storage (a copy
        into one would overwrite the other)."""
        new, metrics = self.one_iteration(state)
        seen = set()
        tensors = state_tensors(new)
        for t in tensors:
            ptr = t.untyped_storage().data_ptr()
            if ptr in seen and t.numel():
                raise ValueError("the fused engine's state has two leaves "
                                 "that share storage")
            seen.add(ptr)
        self.state = new
        self._tensors = tensors
        return self._stack(metrics)

    def _step(self) -> Optional[torch.Tensor]:
        """One iteration into the static state: every new leaf is copied
        into the static leaf it replaces."""
        new, metrics = self.one_iteration(self.state)
        fresh = state_tensors(new)
        if len(fresh) != len(self._tensors):
            raise ValueError(f"an iteration changed the state's structure "
                             f"({len(self._tensors)} tensors, then "
                             f"{len(fresh)})")
        with torch.no_grad():
            for s, n in zip(self._tensors, fresh):
                if n is not s:
                    s.copy_(n)
        return self._stack(metrics)

    def eager(self, state=None) -> Optional[torch.Tensor]:
        """One eager iteration on the current stream: from the caller's
        ``state`` the first time, into the static state after that."""
        row = self._first(state) if self.state is None else self._step()
        self.eager_iterations += 1
        return row

    # ----------------------------------------------------------- graph
    def capture(self, device: torch.device,
                stream: Optional["torch.cuda.Stream"] = None) -> None:
        """Capture one ``_step`` in a CUDA graph, in a memory pool of its
        own, with every generator of the state registered, and record what
        it cost. The wrappers' calls during the capture launch nothing:
        their counts are taken back out, and each replay adds them
        (``launches_per_replay``). The graph is kept (``raw_cuda_graph``),
        so its kernel nodes can be read.

        ``stream`` is the capture stream (default: PyTorch's). Two graphs
        that are replayed at once must be captured on two streams: cuBLAS
        keeps one workspace per (handle, stream), and a capture bakes in
        the workspace of its stream, so two graphs captured on one stream
        would run their matmuls in one workspace at once."""
        if self.eager_iterations < self.warmup:
            raise RuntimeError(f"capture after {self.warmup} eager "
                               f"iterations (ran {self.eager_iterations})")
        before = kernels.launch_counts()
        # the capture empties the allocator's cache first; so does this,
        # so that the growth of the reserve is the graph's pool
        synchronize(device)
        torch.cuda.empty_cache()
        reserved = torch.cuda.memory_reserved(device)
        t0 = time.perf_counter()
        graph = torch.cuda.CUDAGraph(keep_graph=True)
        for g in state_generators(self.state):
            if g.device.type == "cuda":
                graph.register_generator_state(g)
        self.pool = torch.cuda.graph_pool_handle()
        with torch.cuda.graph(graph, pool=self.pool, stream=stream):
            out = self._step()
        after = kernels.launch_counts()
        per_replay = {k: after[k] - before[k] for k in after
                      if after[k] != before[k]}
        kernels.add_launches({k: -v for k, v in per_replay.items()})
        graph.instantiate()
        synchronize(device)
        self.graph, self._graph_out = graph, out
        self.graph_stats.update(
            capture_s=time.perf_counter() - t0,
            pool_mib=(torch.cuda.memory_reserved(device) - reserved)
            / 2 ** 20,
            launches_per_replay=per_replay)

    def replay(self) -> Optional[torch.Tensor]:
        """One iteration: the graph replayed on the current stream. Returns
        the graph's metrics vector, which the next replay overwrites."""
        self.graph.replay()
        self.replays += 1
        kernels.add_launches(self.graph_stats["launches_per_replay"])
        return self._graph_out

    def run(self, state, n: int):
        """``n`` iterations from ``state``: ``(static state, metrics)``."""
        if n < 1:
            raise ValueError(f"n={n} must be >= 1")
        rows: List[torch.Tensor] = []
        if self.state is not None and state is not self.state:
            raise ValueError("run() takes the state it returned: the "
                             "engine updates that one in place")
        device = state_tensors(state)[0].device
        if device.type != "cuda":
            while len(rows) < n:
                rows.append(self.eager(state))
            return self.state, self._metrics(rows)
        if self.graph is None:
            t0 = time.perf_counter()
            side = torch.cuda.Stream(device)
            side.wait_stream(torch.cuda.current_stream(device))
            with torch.cuda.stream(side):
                while self.eager_iterations < self.warmup and len(rows) < n:
                    rows.append(self.eager(state))
            torch.cuda.current_stream(device).wait_stream(side)
            synchronize(device)
            self.graph_stats["warmup_s"] = (
                self.graph_stats.get("warmup_s", 0.0)
                + time.perf_counter() - t0)
            if self.eager_iterations < self.warmup:
                return self.state, self._metrics(rows)
            self.capture(device)
        while len(rows) < n:
            rows.append(self.replay().clone())
        return self.state, self._metrics(rows)

    def _metrics(self, rows: List[torch.Tensor]) -> Dict[str, torch.Tensor]:
        stacked = torch.stack(rows, dim=1).cpu()
        return {k: stacked[i] for i, k in enumerate(self.keys)}


def make_fused_train_loop(env, learn: Optional[Callable], horizon: int,
                          chunk: int, rollout: Optional[Callable] = None,
                          train_step: Optional[Callable] = None
                          ) -> Callable:
    """Build ``train_chunk(state) -> (state', metrics)``: ``chunk``
    collect -> learn iterations, metrics stacked ``(chunk,)`` with the
    per-iteration ``mean_return``. The state is updated in place; pass the
    returned one to the next call.

    ``train_step`` (``algos.api.make_train_step``) fuses the whole
    experience plane, with ``state.plane_state`` threaded through; without
    one, ``learn`` (``(params, opt_state, traj) -> (params, opt_state,
    metrics)``, e.g. ``make_mlp_learner``) is the train step of a fifo
    plane (``learner_step``). ``rollout`` defaults to
    ``make_env_rollout``."""
    if train_step is None:
        if learn is None:
            raise ValueError("the fused loop needs learn or train_step")
        train_step = learner_step(learn)
    if rollout is None:
        rollout = sampler_mod.make_env_rollout(env, horizon)
    engine = FusedEngine(make_iteration(rollout, train_step))

    def train_chunk(state: TrainState):
        return engine.run(state, chunk)

    train_chunk.engine = engine
    return train_chunk


class FusedRunner(BackendCloseMixin):
    """Runner-shaped driver over the fused engine.

    The fused engine has no host-visible collect/learn boundary (that is
    the point), so ``IterationLog.collect_time``/``collect_time_serial``
    are 0.0 and ``learn_time`` carries the whole fused iteration's share
    of the chunk's wall time. ``chunk`` (default: all of a ``run``'s
    iterations) is the number of iterations between host syncs. The runner
    takes over the state it is given and updates it in place.

    ``overlap=True`` trades the one graph for a pipeline of two, as the
    reference trades its one dispatch for two: a collect engine
    (``rollout``) and a learn engine (the train step, with ``mean_return``
    computed from the trajectory it consumes), each captured in a graph
    with a memory pool of its own and the generators of its half (the env
    carry's, the plane's) registered. The collect's two eager iterations
    (the first collect and serial iteration 0's) and the learn's one
    (serial iteration 0's) come first; both are captured before serial
    iteration 1, so its learn, which gives the clock its serial reference,
    is a replay like every pipelined learn. The schedule and the bits are
    those of eager halves. Per pipelined iteration, learn k is replayed on a
    learner stream and collect k+1 on a collect stream, acting with the
    params learn k starts from (``staleness`` 1.0 on the iteration that
    consumes it). Between iterations, on the collect stream, the new
    trajectory is copied into the learn's own buffer and the params into
    the collect's static copy, so neither graph reads what the other
    writes; the learner stream waits for those copies. ``chunk`` is
    ignored: the host must see the collect/learn boundary to pipeline
    across it. The logs follow the reference's formulas: ``collect_time``
    the collect's own seconds, ``learn_time`` the window less
    ``overlap_saved_s`` (``orchestrator.OverlapClock``)."""

    def __init__(self, env, learn: Optional[Callable], params: Any,
                 opt_state: Any, env_carry: Any, horizon: int,
                 chunk: Optional[int] = None,
                 rollout: Optional[Callable] = None,
                 train_step: Optional[Callable] = None,
                 plane_state: Any = None,
                 overlap: bool = False):
        if chunk is not None and chunk < 1:
            raise ValueError(f"chunk={chunk} must be >= 1")
        self.env = env
        self.horizon = horizon
        self.chunk = chunk
        self.overlap = overlap
        self.engine = None if overlap else make_fused_train_loop(
            env, learn, horizon, chunk or 1, rollout, train_step).engine
        self.state = TrainState(params, opt_state, env_carry, plane_state)
        self.num_samplers = 1
        self.logs: List = []
        self.last_metrics: Dict[str, torch.Tensor] = {}
        self._samples_per_iter = env_carry[1].shape[0] * horizon
        self.timer = PhaseTimer()
        if overlap:
            if train_step is None and learn is None:
                raise ValueError("the fused runner needs learn or "
                                 "train_step")
            # the learn's own trajectory buffer, made at the first handoff
            self._traj: List[Optional[Dict[str, torch.Tensor]]] = [None]
            self.halves = _overlap_engines(
                rollout or sampler_mod.make_env_rollout(env, horizon),
                train_step or learner_step(learn), self._traj)
            self._overlap_clock = OverlapClock()
            self._overlap_done = 0
            # per logged iteration: whether its learn had finished when the
            # concurrent collect did (None without a concurrent collect)
            self.learn_done_first: List[Optional[bool]] = []
            self._streams = None        # (collect, learn) on the card

    @property
    def params(self):
        return self.state.params

    @property
    def opt_state(self):
        return self.state.opt_state

    @property
    def plane_state(self):
        return self.state.plane_state

    @property
    def buffer_state(self):
        return (None if self.state.plane_state is None
                else self.state.plane_state[0])

    @property
    def graph_stats(self) -> Dict[str, Any]:
        """The engine's ``graph_stats``; under overlap, each half's, by
        ``"collect"`` and ``"learn"``."""
        if self.overlap:
            return {"collect": self.halves[0].graph_stats,
                    "learn": self.halves[1].graph_stats}
        return self.engine.graph_stats

    def run(self, iterations: int) -> List[IterationLog]:
        if self.overlap:
            return self._run_overlapped(iterations)
        done = 0
        while done < iterations:
            c = min(self.chunk or iterations, iterations - done)
            t0 = time.perf_counter()
            self.state, metrics = self.engine.run(self.state, c)
            per_iter = (time.perf_counter() - t0) / c
            self.last_metrics = metrics
            for j, ret in enumerate(metrics["mean_return"].tolist()):
                record_log(self.logs, self.timer, IterationLog(
                    iteration=done + j,
                    collect_time=0.0,
                    collect_time_serial=0.0,
                    learn_time=per_iter,
                    mean_return=ret,
                    samples=self._samples_per_iter,
                ))
            done += c
        return self.logs

    # ----------------------------------------------------------- overlap
    def _collect(self) -> float:
        """One collect on the current (collect) stream with the collect's
        params copy, timed to that stream's barrier: eager before the
        collect graph exists, else a replay."""
        collect = self.halves[0]
        t0 = time.perf_counter()
        if collect.graph is not None:
            collect.replay()
        else:
            collect.eager()
        stream_synchronize(self._device)
        return time.perf_counter() - t0

    def _copy_params(self) -> None:
        """The params as they are into the collect's copy, on the current
        stream: before the learn that will update them is issued."""
        learn = self.halves[1]
        refresh(self.halves[0].state[0],
                learn.state[0] if learn.state is not None
                else self.state.params)

    def _handoff(self) -> None:
        """The collected trajectory into the learn's own buffer (the first
        time, a copy of it), on the current stream."""
        traj = self.halves[0].state[2]
        if self._traj[0] is None:
            self._traj[0] = snapshot(traj)
        else:
            refresh(self._traj[0], traj)

    def _learn(self):
        """Issue one learn on the learner stream (eager, or a replay), after
        the collect stream's work so far; returns its metrics row (a copy,
        on the learner stream) and the event recorded after it."""
        learn = self.halves[1]
        stream = self._streams[1] if self._streams else None
        if stream is not None:
            stream.wait_stream(torch.cuda.current_stream(self._device))
        with on_stream(stream):
            if learn.graph is not None:
                row = learn.replay().clone()
            elif learn.state is None:
                row = learn.eager((self.state.params, self.state.opt_state,
                                   self.state.plane_state))
            else:
                row = learn.eager()
            done = None
            if stream is not None:
                done = torch.cuda.Event()
                done.record(stream)
        return row, done

    def _capture_halves(self) -> None:
        """Capture each half that has no graph yet, on the stream that
        replays it (so each bakes in its own cuBLAS workspace, which its
        eager iterations on that stream made); the two register disjoint
        sets of generators (each generator with one graph)."""
        gens = [set(map(id, state_generators(e.state))) for e in self.halves]
        if gens[0] & gens[1]:
            raise ValueError("the collect and the learn share a generator: "
                             "each may be registered with one graph only")
        for engine, stream in zip(self.halves, self._streams):
            if engine.graph is None:
                engine.capture(self._device, stream)

    def _run_overlapped(self, iterations: int) -> List[IterationLog]:
        """The reference's schedule: a collect, then per iteration the learn
        on the last collect and (but in the last iteration) the next
        collect: after it in the ``OVERLAP_WARMUP`` serial iterations,
        while it runs in the pipelined ones."""
        if iterations < 1:
            return self.logs
        collect, learn = self.halves
        clock = self._overlap_clock
        self._device = state_tensors(self.state)[0].device
        if self._device.type == "cuda" and self._streams is None:
            self._streams = (torch.cuda.Stream(self._device),
                             torch.cuda.Stream(self._device))
        caller = None
        if self._streams:
            caller = torch.cuda.current_stream(self._device)
            for stream in self._streams:
                stream.wait_stream(caller)
        done0 = len(self.logs)
        rows, timing = [], []
        with on_stream(self._streams[0] if self._streams else None):
            if collect.state is None:
                t0 = time.perf_counter()
                collect.eager((snapshot(self.state.params),
                               self.state.env_carry, None))
                stream_synchronize(self._device)
                collect_dur = time.perf_counter() - t0
            else:
                self._copy_params()
                collect_dur = self._collect()
            stale = 0.0
            for it in range(iterations):
                data_dur, data_stale = collect_dur, stale
                warm, self._overlap_done = (self._overlap_done,
                                            self._overlap_done + 1)
                more = it + 1 < iterations
                saved, ready = 0.0, None
                if warm == 1 and self._streams:
                    # the learn after its one eager iteration, the collect
                    # after its two: the learn noted below is a replay
                    self._capture_halves()
                if warm < OVERLAP_WARMUP:
                    t0 = time.perf_counter()
                    self._handoff()
                    row, done = self._learn()
                    if done is not None:
                        done.synchronize()
                    window = time.perf_counter() - t0
                    if warm > 0:    # iteration 0 builds what it needs
                        clock.note_serial(window)
                    if more:
                        self._copy_params()
                        collect_dur, stale = self._collect(), 0.0
                else:
                    t0 = time.perf_counter()
                    self._handoff()
                    if more:        # p_k, before learn k writes it
                        self._copy_params()
                    row, done = self._learn()
                    if more:
                        next_dur = self._collect()
                        ready = tree_ready(done)
                        saved = clock.saved(next_dur, ready)
                        collect_dur, stale = next_dur, 1.0
                    if done is not None:
                        done.synchronize()
                    window = time.perf_counter() - t0
                rows.append(row)
                timing.append((data_dur, max(0.0, window - saved),
                               data_stale, saved))
                self.learn_done_first.append(ready)
        if caller is not None:
            for stream in self._streams:
                caller.wait_stream(stream)
        self.state = TrainState(learn.state[0], learn.state[1],
                                collect.state[1], learn.state[2])
        self.last_metrics = learn._metrics(rows)
        for j, (ret, (collect_s, learn_s, stale, saved)) in enumerate(zip(
                self.last_metrics["mean_return"].tolist(), timing)):
            record_log(self.logs, self.timer, IterationLog(
                iteration=done0 + j,
                collect_time=collect_s,
                collect_time_serial=collect_s,
                learn_time=learn_s,
                mean_return=ret,
                samples=self._samples_per_iter,
                staleness=stale,
                overlap_saved_s=saved,
            ))
        return self.logs


def _overlap_engines(rollout: Callable, train_step: Callable, traj_box):
    """``(collect, learn)`` engines for the overlap schedule. The collect's
    state is ``(params copy, env carry, trajectory)``; the learn's is
    ``(params, opt_state, plane_state)``, and it consumes the trajectory
    buffer in ``traj_box[0]``, which stays out of its state: the fifo
    buffer's state is the trajectory it was given, so the two would share
    storage. The learn reports the train step's metrics and the
    ``mean_return`` of the trajectory it consumed (the reference's
    ``learn_body``). The learn is captured after one eager iteration: it
    runs on the learner stream that captures it, so that iteration has
    built its kernels, its stream's cuBLAS workspace and the state it
    leaves static, and serial iteration 1's learn can be a replay."""

    def collect_half(state):
        params, env_carry, _ = state
        env_carry, traj = rollout(params, env_carry)
        return (params, env_carry, traj), {}

    def learn_half(state):
        params, opt_state, plane_state = state
        traj = traj_box[0]
        params, opt_state, plane_state, metrics = train_step(
            params, opt_state, plane_state, traj)
        metrics = dict(metrics)
        metrics["mean_return"] = trajectory.episode_returns(traj)
        return (params, opt_state, plane_state), metrics

    return FusedEngine(collect_half), FusedEngine(learn_half, warmup=1)
