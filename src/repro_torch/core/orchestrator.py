"""The agent processor's synchronous runner (port of ``IterationLog``,
``assemble_log`` and the serial ``SyncRunner.run`` of
``repro/core/orchestrator.py``; the overlap schedule and the async
orchestrator are in ROADMAP.md).

``SyncRunner``: collect (via a backend) -> learn -> repeat. Every timed
phase ends in a device barrier, so ``collect_time``/``learn_time`` measure
the work and not its launches.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, List, Optional, Sequence

from repro_torch.core.backends import BackendCloseMixin
from repro_torch.core.timing import synchronize
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
    staleness: float = 0.0
    queue_drops: int = 0
    worker_utilization: float = 1.0
    respawns: int = 0
    active_workers: int = 0
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
                 samples: Optional[int] = None) -> IterationLog:
    """The single definition of per-iteration accounting."""
    return IterationLog(
        iteration=iteration,
        collect_time=max(per_sampler_seconds),
        collect_time_serial=sum(per_sampler_seconds),
        learn_time=learn_time,
        mean_return=float(trajectory.episode_returns(merged)),
        samples=(samples if samples is not None
                 else trajectory.num_samples(merged)),
    )


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
        self.logs: List[IterationLog] = []

    def run(self, iterations: int) -> List[IterationLog]:
        for it in range(iterations):
            merged, stats = self.backend.collect(self.params)
            (self.params, self.opt_state, self.plane_state, _,
             learn_time) = timed_train_step(
                 self._train_step, self.params, self.opt_state,
                 self.plane_state, merged)
            log = assemble_log(it, stats.per_sampler_seconds, learn_time,
                               merged, stats.samples)
            self.logs.append(log)
        return self.logs

    def close(self) -> None:
        self.backend.close()
