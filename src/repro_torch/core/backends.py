"""Sampler backends (port of the inline backend of
``repro/core/backends.py``; threaded, sharded and process backends are in
ROADMAP.md).

A backend owns the sampler carries and produces, per iteration, one merged
trajectory plus per-sampler timing.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, List, Sequence

from repro_torch import registry
from repro_torch.core.timing import synchronize
from repro_torch.data import trajectory


@dataclasses.dataclass
class CollectStats:
    """Per-iteration collection accounting."""
    per_sampler_seconds: List[float]
    samples: int


class BackendCloseMixin:
    """Context manager + no-op ``close`` shared by backends and runners."""

    def close(self) -> None:
        pass

    def __enter__(self):
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def timed_rollout(rollout: Callable, params: Any, carry: Any):
    """Run one rollout to completion on the device: ``(carry', traj, dt)``."""
    t0 = time.perf_counter()
    carry, traj = rollout(params, carry)
    synchronize(traj["rewards"].device)
    return carry, traj, time.perf_counter() - t0


def merge_trajs(trajs: Sequence[Any]) -> Any:
    return trajectory.merge(list(trajs)) if len(trajs) > 1 else trajs[0]


class InlineBackend(BackendCloseMixin):
    """The serial sweep: N logical samplers run back to back, each timed,
    so the critical path of a parallel deployment (the max over samplers)
    can be reported from one process."""

    def __init__(self, rollout: Callable, carries: List[Any]):
        self.rollout = rollout
        self.carries = carries
        self.num_samplers = len(carries)

    def collect(self, params):
        trajs, times = [], []
        for i in range(self.num_samplers):
            self.carries[i], traj, dt = timed_rollout(
                self.rollout, params, self.carries[i])
            trajs.append(traj)
            times.append(dt)
        merged = merge_trajs(trajs)
        return merged, CollectStats(times, trajectory.num_samples(merged))


def _build_inline(*, rollout: Callable, carries: List[Any], **_ignored):
    return InlineBackend(rollout, carries)


registry.register("backend", "inline", _build_inline)
