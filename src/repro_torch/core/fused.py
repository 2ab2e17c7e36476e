"""The fused engine: collect -> GAE or replay -> learn, one CUDA-graph
replay per iteration (port of ``repro/core/fused.py``; the ``overlap``
schedule is ROADMAP.md queue 1 item 6b).

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
"""
from __future__ import annotations

import time
from typing import Any, Callable, Dict, List, NamedTuple, Optional

import torch
from torch import nn

from repro_torch import kernels
from repro_torch.core import sampler as sampler_mod
from repro_torch.core.backends import BackendCloseMixin
from repro_torch.core.orchestrator import IterationLog, record_log
from repro_torch.core.timing import PhaseTimer, synchronize
from repro_torch.data import trajectory


class TrainState(NamedTuple):
    """Everything the fused loop carries across iterations. ``plane_state``
    is the experience plane's ``(buffer_state, generator)``: replay rings
    and sum trees live in the carry and are updated in place."""
    params: Any
    opt_state: Any
    env_carry: Any
    plane_state: Any = None


def _walk(x, tensors: List[torch.Tensor], generators: List[torch.Generator]):
    """Collect the tensors of a state in a fixed order (a module's
    parameters and buffers, a sequence's or a dict's entries in order) and
    its generators."""
    if isinstance(x, torch.Tensor):
        tensors.append(x)
    elif isinstance(x, torch.Generator):
        generators.append(x)
    elif isinstance(x, nn.Module):
        tensors.extend(x.parameters())
        tensors.extend(x.buffers())
    elif isinstance(x, dict):
        for v in x.values():
            _walk(v, tensors, generators)
    elif isinstance(x, (tuple, list)):
        for v in x:
            _walk(v, tensors, generators)
    elif isinstance(x, bool):
        pass    # host state (a ring's ``filled``): the first iteration's stays
    elif x is not None:
        raise TypeError(f"the fused engine carries tensors, modules, "
                        f"generators and containers of them; got "
                        f"{type(x).__name__}")


def state_tensors(state) -> List[torch.Tensor]:
    tensors: List[torch.Tensor] = []
    _walk(state, tensors, [])
    return tensors


def state_generators(state) -> List[torch.Generator]:
    generators: List[torch.Generator] = []
    _walk(state, [], generators)
    return generators


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
    overwrites in place. On CUDA the first ``WARMUP`` iterations run
    eagerly on a side stream, then one iteration is captured in a CUDA
    graph and each later one is a replay. On the CPU every iteration runs
    eagerly.

    ``run(state, n)`` runs ``n`` iterations and returns ``(state,
    metrics)``, each metric a float32 ``(n,)`` CPU tensor, read with one
    host sync; every later ``run`` takes the state it returned.
    ``graph_stats`` holds the warm-up and capture seconds, the graph
    pool's MiB and the kernel launches a replay makes."""

    # eager iterations before the capture: the first builds what a
    # capture cannot, the second runs on the state made static
    WARMUP = 2

    def __init__(self, one_iteration: Callable):
        self.one_iteration = one_iteration
        self.state = None
        self._tensors: List[torch.Tensor] = []     # the static state's
        self.keys: Optional[List[str]] = None
        self.graph = None
        self._graph_out: Optional[torch.Tensor] = None
        self._done_eager = 0
        self.graph_stats: Dict[str, Any] = {}

    # ------------------------------------------------------------ eager
    def _stack(self, metrics) -> torch.Tensor:
        if self.keys is None:
            self.keys = list(metrics)
        return torch.stack([metrics[k].detach().reshape(()).to(torch.float32)
                            for k in self.keys])

    def _first(self, state) -> torch.Tensor:
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

    def _step(self) -> torch.Tensor:
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

    # ----------------------------------------------------------- graph
    def _capture(self, device: torch.device) -> None:
        """Capture one ``_step`` in a CUDA graph with every generator of
        the state registered, and record what it cost. The wrappers' calls
        during the capture launch nothing: their counts are taken back out,
        and each replay adds them (``launches_per_replay``). The graph is
        kept (``raw_cuda_graph``), so its kernel nodes can be read."""
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
        with torch.cuda.graph(graph):
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
            if self.state is None:
                rows.append(self._first(state))
            while len(rows) < n:
                rows.append(self._step())
            return self.state, self._metrics(rows)
        if self.graph is None:
            t0 = time.perf_counter()
            side = torch.cuda.Stream(device)
            side.wait_stream(torch.cuda.current_stream(device))
            with torch.cuda.stream(side):
                if self.state is None:
                    rows.append(self._first(state))
                    self._done_eager = 1
                while self._done_eager < self.WARMUP and len(rows) < n:
                    rows.append(self._step())
                    self._done_eager += 1
            torch.cuda.current_stream(device).wait_stream(side)
            synchronize(device)
            self.graph_stats["warmup_s"] = (
                self.graph_stats.get("warmup_s", 0.0)
                + time.perf_counter() - t0)
            if self._done_eager < self.WARMUP:
                return self.state, self._metrics(rows)
            self._capture(device)
        per_replay = self.graph_stats["launches_per_replay"]
        while len(rows) < n:
            self.graph.replay()
            kernels.add_launches(per_replay)
            rows.append(self._graph_out.clone())
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
    ``overlap=True`` is ROADMAP.md queue 1 item 6b and is rejected."""

    def __init__(self, env, learn: Optional[Callable], params: Any,
                 opt_state: Any, env_carry: Any, horizon: int,
                 chunk: Optional[int] = None,
                 rollout: Optional[Callable] = None,
                 train_step: Optional[Callable] = None,
                 plane_state: Any = None,
                 overlap: bool = False):
        if overlap:
            raise NotImplementedError(
                "the overlap schedule of the fused runner is not ported to "
                "repro_torch yet; see ROADMAP.md (queue 1 item 6b)")
        if chunk is not None and chunk < 1:
            raise ValueError(f"chunk={chunk} must be >= 1")
        self.env = env
        self.horizon = horizon
        self.chunk = chunk
        self.engine = make_fused_train_loop(
            env, learn, horizon, chunk or 1, rollout, train_step).engine
        self.state = TrainState(params, opt_state, env_carry, plane_state)
        self.num_samplers = 1
        self.logs: List = []
        self.last_metrics: Dict[str, torch.Tensor] = {}
        self._samples_per_iter = env_carry[1].shape[0] * horizon
        self.timer = PhaseTimer()

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
        return self.engine.graph_stats

    def run(self, iterations: int) -> List[IterationLog]:
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
