"""WALL-E's two queues, host-side (port of ``repro/core/queues.py``).

* ``PolicyStore`` — the policy queue: a versioned latest-wins cell.
  Samplers read the freshest params and may act with a stale policy; the
  version says how stale.
* ``ExperienceQueue`` — a bounded FIFO of ``Experience`` records (the
  trajectory, the policy version that made it, timing) from the samplers
  to the learner.

The reference's params are immutable arrays, so its store can hold the
learner's own. The port's learners update their parameters in place
(``optim.apply_updates``, the SAC and DDPG target updates), so ``publish``
stores a snapshot (``snapshot``): sampler threads never act with weights
that the learner is changing mid-rollout. ``refresh`` copies the params
into a snapshot made earlier, so a collect can act with a static copy
(the overlap schedule's, ``orchestrator.SyncRunner`` and
``fused.FusedRunner``); ``state_tensors`` and ``state_generators`` walk
such a state (params, optimizer state, carries) in a fixed order.
"""
from __future__ import annotations

import copy
import dataclasses
import queue
import threading
import time
from typing import Any, List, Optional, Tuple

import torch


def snapshot(params: Any) -> Any:
    """A detached clone of every tensor in ``params`` (a module, a tensor,
    or a dict, list or tuple of them); any other value is returned as
    is."""
    if isinstance(params, torch.nn.Module):
        with torch.no_grad():
            clone = copy.deepcopy(params)
        for p in clone.parameters():
            p.requires_grad_(False)
        return clone
    if isinstance(params, torch.Tensor):
        return params.detach().clone()
    if isinstance(params, dict):
        return {k: snapshot(v) for k, v in params.items()}
    if isinstance(params, (list, tuple)):
        return type(params)(snapshot(v) for v in params)
    return params


def _walk(x, tensors: List[torch.Tensor], generators: List[torch.Generator]):
    """Collect the tensors of a state in a fixed order (a module's
    parameters and buffers, a sequence's or a dict's entries in order) and
    its generators."""
    if isinstance(x, torch.Tensor):
        tensors.append(x)
    elif isinstance(x, torch.Generator):
        generators.append(x)
    elif isinstance(x, torch.nn.Module):
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
        raise TypeError(f"a state holds only tensors, modules, "
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


def refresh(dst: Any, src: Any) -> Any:
    """Copy every tensor of ``src`` into the matching tensor of ``dst`` (a
    ``snapshot`` of something shaped like ``src``), in place, on the
    current stream; returns ``dst``."""
    to, frm = state_tensors(dst), state_tensors(src)
    if len(to) != len(frm):
        raise ValueError(f"refresh: the snapshot holds {len(to)} tensors, "
                         f"the params {len(frm)}")
    with torch.no_grad():
        for d, s in zip(to, frm):
            d.copy_(s)
    return dst


class PolicyStore:
    """Versioned latest-wins parameter cell (the 'primed' policy queue).
    It holds a snapshot of what was published, never the caller's
    object."""

    def __init__(self, params: Any, version: int = 0):
        self._lock = threading.Lock()
        self._params = snapshot(params)
        self._version = version
        self.publish_count = 0

    def publish(self, params: Any) -> int:
        params = snapshot(params)       # outside the lock: readers go on
        with self._lock:
            self._params = params
            self._version += 1
            self.publish_count += 1
            return self._version

    def read(self) -> Tuple[Any, int]:
        with self._lock:
            return self._params, self._version

    @property
    def version(self) -> int:
        with self._lock:
            return self._version


@dataclasses.dataclass
class Experience:
    traj: Any                 # dict of (T, B, ...) tensors or arrays
    policy_version: int       # version the sampler acted with
    sampler_id: int
    collect_seconds: float    # sampler-side wall time for this rollout
    enqueue_time: float = dataclasses.field(default_factory=time.perf_counter)


class ExperienceQueue:
    """Bounded FIFO with staleness and overflow-drop accounting.

    ``drop_count`` counts experiences lost because the queue stayed full
    past the producer's timeout: the async runtime's backpressure signal
    (samplers outrunning the learner), reported per iteration as
    ``IterationLog.queue_drops``.
    """

    def __init__(self, maxsize: int = 64):
        self._q: "queue.Queue[Experience]" = queue.Queue(maxsize=maxsize)
        self.put_count = 0
        self.drop_count = 0
        self.staleness: List[int] = []
        self.queue_wait: List[float] = []

    def put(self, exp: Experience, timeout: Optional[float] = None) -> bool:
        """Enqueue; on overflow (still full after ``timeout``) drop the
        experience, count it, and return False."""
        try:
            self._q.put(exp, timeout=timeout)
        except queue.Full:
            self.drop_count += 1
            return False
        self.put_count += 1
        return True

    def get(self, learner_version: int, timeout: Optional[float] = None
            ) -> Experience:
        exp = self._q.get(timeout=timeout)
        self.staleness.append(learner_version - exp.policy_version)
        self.queue_wait.append(time.perf_counter() - exp.enqueue_time)
        return exp

    def drain(self, learner_version: int, max_items: int) -> List[Experience]:
        """Non-blocking drain of up to ``max_items`` queued experiences."""
        items = []
        while len(items) < max_items:
            try:
                items.append(self.get(learner_version, timeout=0.0))
            except queue.Empty:
                break
        return items

    def qsize(self) -> int:
        return self._q.qsize()

    def mean_staleness(self) -> float:
        return (sum(self.staleness) / len(self.staleness)
                if self.staleness else 0.0)
