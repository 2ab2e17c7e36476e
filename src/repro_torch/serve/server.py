"""The policy serving plane: a dynamic-batching inference server with live
params hot-swap (port of ``repro/serve/server.py``).

Concurrent ``act(obs)`` requests are admitted onto one bounded queue and
micro-batched into single device dispatches by a dispatcher thread under a
latency deadline: a batch launches when it fills (``slots`` requests) or
when the oldest queued request has waited ``deadline_ms``. Every batch is
zero-padded to exactly ``slots`` rows, so every dispatch runs the same
shapes: one host -> device copy of the padded ``obs`` and ``noise`` from
pinned staging, one ``algo.act`` under ``torch.inference_mode()``, one
device -> host copy of the actions, all on the server's own device and CUDA
stream.

Determinism: a request's action depends only on its own row of the padded
batch (row-parallel ops at fixed shapes) and on its standard-normal
``noise`` draw, which stands in for the reference's per-request PRNG key.
So an action is bit for bit the same whether it rides a full batch, a
deadline-expired partial batch or the single-request ``reference_act``
path. A request's draw, unless the caller gives one, is a function of
``(seed, request_id)`` alone, made on the host at submit time, so a replay
of the same request ids reproduces the same actions.

Hot-swap: a server attached to a ``core.ipc.ParamsChannel`` polls the
channel's version word between dispatches, never during one, and copies
new leaves into its own parameters in place, on its stream, ordered before
the next dispatch. Every completion records the version that served it.
The channel must carry the port's parameters in module order (count and
shapes are checked): a channel of the reference's learner, whose leaves
are in its own order and ``(in, out)`` layout, is refused.

Backpressure: the admission queue is bounded (``queue_cap``); a full queue
rejects new work with ``ServerOverloaded`` at submit time. Admitted
requests are never dropped: ``close()`` drains the queue before the
dispatcher exits, also when ``start()`` was never called.
"""
from __future__ import annotations

import contextlib
import copy
import itertools
import queue as _queue
import threading
import time
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.core.ipc import (
    ChannelSpec,
    ParamsChannel,
    _check_leaves,
    _load_leaves,
)
from repro_torch.serve.stats import ServingStats


class ServerClosed(RuntimeError):
    """Submit after ``close()``."""


class ServerOverloaded(RuntimeError):
    """Admission queue full — backpressure; retry or raise capacity."""


class PendingAct:
    """A submitted request's completion handle (thread-safe future)."""

    __slots__ = ("request_id", "obs", "noise", "enqueue_s", "_event",
                 "action", "params_version", "latency_s", "queue_wait_s",
                 "_error")

    def __init__(self, request_id: int, obs: np.ndarray, noise: np.ndarray):
        self.request_id = request_id
        self.obs = obs
        self.noise = noise
        self.enqueue_s = time.perf_counter()
        self._event = threading.Event()
        self.action: Optional[np.ndarray] = None
        self.params_version: Optional[int] = None
        self.latency_s: Optional[float] = None
        self.queue_wait_s: Optional[float] = None
        self._error: Optional[BaseException] = None

    def done(self) -> bool:
        return self._event.is_set()

    def result(self, timeout: Optional[float] = None) -> np.ndarray:
        """The action; raises what the dispatch raised, if it failed."""
        if not self._event.wait(timeout):
            raise TimeoutError(
                f"request {self.request_id} not served within {timeout}s")
        if self._error is not None:
            raise RuntimeError(
                f"request {self.request_id}: its dispatch failed"
            ) from self._error
        return self.action

    def _complete(self, action: np.ndarray, version: int,
                  dispatch_s: float, done_s: float) -> None:
        self.action = action
        self.params_version = version
        self.queue_wait_s = dispatch_s - self.enqueue_s
        self.latency_s = done_s - self.enqueue_s
        self._event.set()

    def _fail(self, error: BaseException) -> None:
        self._error = error
        self._event.set()


class PolicyServer:
    """Dynamic-batching ``act()`` server over any registered env × algo.

    One difference from the reference's server: past the oldest rider's
    deadline the dispatcher still takes every request already queued, up
    to ``slots``. The reference stops at the deadline, so a backlog older
    than the deadline dispatches one request at a time and never catches
    up; here it goes out in full batches.

    Parameters
    ----------
    env, algo, params : the policy — ``algo.act(params, obs, noise)`` is the
        head being served. The server serves a copy of ``params``, on
        their device, into which hot-swapped leaves are copied.
    slots : fixed device batch width (requests per dispatch).
    deadline_ms : max time the oldest queued request waits before a partial
        batch dispatches anyway — the latency/throughput knob.
    queue_cap : admission bound (default ``16 * slots``); a full queue
        raises ``ServerOverloaded``.
    seed : base of each request's default noise draw, ``(seed,
        request_id)``.
    params_channel : a ``ParamsChannel`` (or its ``ChannelSpec`` to attach
        to) that a live learner publishes to; the server follows its
        version between dispatches. A spec-attached channel is closed with
        the server.
    """

    def __init__(self, env: Any, algo: Any, params: Any, *,
                 slots: int = 8, deadline_ms: float = 5.0,
                 queue_cap: Optional[int] = None, seed: int = 0,
                 params_channel: Optional[Any] = None):
        if slots < 1:
            raise ValueError(f"slots={slots} must be >= 1")
        if deadline_ms <= 0:
            raise ValueError(f"deadline_ms={deadline_ms} must be > 0")
        self.env = env
        self.algo = algo
        self.slots = int(slots)
        self.deadline_s = float(deadline_ms) / 1e3
        self.queue_cap = int(queue_cap) if queue_cap else 16 * self.slots
        self.seed = int(seed)
        self.stats = ServingStats(slots=self.slots)
        self.device = next(params.parameters()).device
        self._params = copy.deepcopy(params)
        self._params.requires_grad_(False)

        cuda = self.device.type == "cuda"

        def staging(width):
            return torch.zeros((self.slots, width), dtype=torch.float32,
                               pin_memory=cuda)

        self._obs_host = staging(env.obs_dim)
        self._noise_host = staging(env.act_dim)
        self._act_host = staging(env.act_dim)
        self._obs_dev = self._obs_host.to(self.device)
        self._noise_dev = self._noise_host.to(self.device)
        self._stream = None
        if cuda:
            self._stream = torch.cuda.Stream(self.device)
            # the copies above ran on the current stream
            self._stream.wait_stream(torch.cuda.current_stream(self.device))
        # one dispatch or one params swap at a time: the dispatcher thread
        # and reference_act share the staging buffers and the params
        self._lock = threading.Lock()

        self._channel: Optional[ParamsChannel] = None
        self._own_channel = False
        self.params_version = 0
        if params_channel is not None:
            if isinstance(params_channel, ChannelSpec):
                self._channel = ParamsChannel.attach(params_channel)
                self._own_channel = True
            else:
                self._channel = params_channel
            try:
                _check_leaves(self._params, self._channel.spec,
                              "the served policy", exc=ValueError)
            except ValueError:
                if self._own_channel:
                    self._channel.close()
                raise

        self._queue: "_queue.Queue[PendingAct]" = _queue.Queue(
            maxsize=self.queue_cap)
        self._ids = itertools.count()
        self._stop = threading.Event()
        self._started = False
        self._closed = False
        self._thread: Optional[threading.Thread] = None

    @classmethod
    def from_checkpoint(cls, ckpt_dir: str, step: Optional[int] = None, *,
                        device=None, **kwargs) -> "PolicyServer":
        """A server for a training checkpoint directory (the
        ``launch/train.py --ckpt-dir`` output of either package), on
        ``device`` (default: cuda); see ``serve.loader``."""
        from repro_torch.serve.loader import load_policy
        handle = load_policy(ckpt_dir, step, device=device)
        return cls(handle.env, handle.algo, handle.params, **kwargs)

    # ------------------------------------------------------------ lifecycle
    def start(self, warmup: bool = True) -> "PolicyServer":
        """Spawn the dispatcher thread; ``warmup`` runs one padded batch
        first, so the first live request does not pay the device's
        first-use costs against its deadline."""
        if self._closed:
            raise ServerClosed("server was closed; build a new one")
        if self._started:
            return self
        if self._channel is not None:
            self._poll_channel()          # serve the freshest published v
        if warmup:
            self._run_batch(np.zeros((1, self.env.obs_dim), np.float32),
                            np.zeros((1, self.env.act_dim), np.float32))
        self._started = True
        self._thread = threading.Thread(
            target=self._serve_loop, name="policy-server", daemon=True)
        self._thread.start()
        return self

    def close(self) -> None:
        """Stop admission, drain every queued request, join, release."""
        if self._closed:
            return
        self._closed = True
        self._stop.set()
        if self._thread is not None:
            self._thread.join()
        elif not self._queue.empty():
            self._serve_loop()      # never started: drain here, so no
            #                         admitted request is dropped
        if self._own_channel and self._channel is not None:
            self._channel.close()
        self._channel = None

    def __enter__(self) -> "PolicyServer":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.close()

    # ------------------------------------------------------------ admission
    def submit(self, obs: Any, *, noise: Optional[Any] = None) -> PendingAct:
        """Enqueue one observation; returns its completion handle.

        ``noise`` is the request's ``(act_dim,)`` standard-normal draw;
        without one, it is drawn from ``(seed, request_id)``. Admission is
        open from construction: requests submitted before ``start()``
        queue up. Raises ``ServerOverloaded`` when the admission queue is
        full and ``ServerClosed`` after ``close()``.
        """
        if self._closed:
            raise ServerClosed("server is closed")
        obs = np.asarray(obs, dtype=np.float32)
        if obs.shape != (self.env.obs_dim,):
            raise ValueError(
                f"obs shape {obs.shape} != ({self.env.obs_dim},) for env "
                f"{self.env.name!r}")
        rid = next(self._ids)
        if noise is None:
            noise = np.random.default_rng([self.seed, rid]).standard_normal(
                self.env.act_dim, dtype=np.float32)
        else:
            noise = np.asarray(noise, dtype=np.float32).reshape(
                self.env.act_dim)
        pending = PendingAct(rid, obs, noise)
        try:
            self._queue.put_nowait(pending)
        except _queue.Full:
            raise ServerOverloaded(
                f"admission queue full ({self.queue_cap} requests "
                f"in-flight at slots={self.slots}) — backpressure; retry "
                f"later or raise queue_cap/slots") from None
        return pending

    def act(self, obs: Any, *, noise: Optional[Any] = None,
            timeout: Optional[float] = 30.0) -> np.ndarray:
        """Blocking convenience: ``submit`` + ``result``."""
        return self.submit(obs, noise=noise).result(timeout)

    def reference_act(self, obs: Any, noise: Any) -> np.ndarray:
        """The single-request oracle: one observation through the same
        padded fixed-width path, occupancy 1. The serve path is bit for bit
        identical to this for every batching pattern."""
        obs = np.asarray(obs, dtype=np.float32).reshape(1, self.env.obs_dim)
        noise = np.asarray(noise, dtype=np.float32).reshape(
            1, self.env.act_dim)
        return self._run_batch(obs, noise)[0]

    # ------------------------------------------------------------ the loop
    def _on_device(self):
        if self._stream is None:
            return contextlib.nullcontext()
        stack = contextlib.ExitStack()
        stack.enter_context(torch.cuda.device(self.device))
        stack.enter_context(torch.cuda.stream(self._stream))
        return stack

    def _run_batch(self, obs: np.ndarray, noise: np.ndarray) -> np.ndarray:
        """Act on ``n`` rows, zero-padded to ``slots``; the ``n`` actions."""
        n = len(obs)
        with self._lock:
            self._obs_host.zero_()
            self._noise_host.zero_()
            self._obs_host[:n] = torch.from_numpy(obs)
            self._noise_host[:n] = torch.from_numpy(noise)
            with self._on_device(), torch.inference_mode():
                if self._stream is not None:
                    self._obs_dev.copy_(self._obs_host, non_blocking=True)
                    self._noise_dev.copy_(self._noise_host,
                                          non_blocking=True)
                actions, _ = self.algo.act(self._params, self._obs_dev,
                                           self._noise_dev)
                self._act_host.copy_(actions, non_blocking=True)
            if self._stream is not None:
                self._stream.synchronize()
            return self._act_host[:n].numpy().copy()

    def _poll_channel(self) -> None:
        """Pick up a newly published params version, if any (one shared
        version-word read when nothing changed)."""
        leaves, version = self._channel.read(
            min_version=0, last_version=self.params_version)
        if leaves is not None:
            with self._lock, self._on_device():
                _load_leaves(self._params, leaves)
                self.params_version = version

    def _serve_loop(self) -> None:
        while True:
            batch = []
            while not batch:                      # wait for the first rider
                if self._stop.is_set() and self._queue.empty():
                    return                        # drained — nothing dropped
                if self._channel is not None:     # track publishes while idle
                    self._poll_channel()
                try:
                    batch.append(self._queue.get(timeout=0.005))
                except _queue.Empty:
                    continue
            # fill until full or the oldest rider's deadline; past it, still
            # take what is already queued (the reference stops there, so a
            # backlog older than the deadline dispatches one request at a
            # time and never catches up)
            deadline = batch[0].enqueue_s + self.deadline_s
            while len(batch) < self.slots:
                remaining = deadline - time.perf_counter()
                try:
                    batch.append(self._queue.get(timeout=remaining)
                                 if remaining > 0
                                 else self._queue.get_nowait())
                except _queue.Empty:
                    break
            if self._channel is not None:         # hot-swap between batches
                self._poll_channel()
            self._dispatch(batch)

    def _dispatch(self, batch) -> None:
        t_dispatch = time.perf_counter()
        try:
            actions = self._run_batch(np.stack([r.obs for r in batch]),
                                      np.stack([r.noise for r in batch]))
        except Exception as exc:        # fail this batch, keep serving
            for req in batch:
                req._fail(exc)
            return
        t_done = time.perf_counter()
        version = self.params_version
        for i, req in enumerate(batch):
            req._complete(actions[i].copy(), version, t_dispatch, t_done)
            self.stats.observe(latency_s=t_done - req.enqueue_s,
                               queue_wait_s=t_dispatch - req.enqueue_s)
        self.stats.observe_batch(len(batch))

    # ------------------------------------------------------------- reading
    def snapshot(self) -> dict:
        """The shared serving-stats schema (``serve.stats``), plus the live
        params version."""
        snap = self.stats.snapshot()
        snap["params_version"] = self.params_version
        return snap
