"""Serving statistics — one schema for every batch server (a copy of
``repro/serve/stats.py``: host code, nothing to port but the import path).

Both serving surfaces in the repo — the RL policy server
(``serve.server.PolicyServer``) and the LM token server
(``core.serving.SlotServer``) — admit requests into fixed-width slot
batches, so they share one accounting vocabulary: per-request latency and
queue wait, per-dispatch batch occupancy, and the slot-steps a fixed
batch width wastes on padding / finished slots. ``ServingStats`` is that
vocabulary as a class; ``snapshot()`` is the schema benchmarks and CI
read, identical for both servers:

    {"requests", "dispatches", "slots",
     "latency_ms":    {"p50", "p99", "mean", "max"},
     "queue_wait_ms": {"p50", "p99", "mean", "max"},
     "batch_occupancy": mean fraction of slots doing real work,
     "wasted_slot_steps": padded/finished slot-dispatches,
     "requests_per_sec": completion throughput over the observed span}

Percentiles use the nearest-rank method over every recorded sample —
serving benches record hundreds to thousands of requests, so the exact
empirical distribution is affordable and reproducible (no histogram
binning error in the recorded p99).
"""
from __future__ import annotations

import time
from typing import Dict, List, Optional


def percentile(samples: List[float], q: float) -> float:
    """Nearest-rank percentile (``q`` in [0, 100]) of ``samples``."""
    if not samples:
        return 0.0
    xs = sorted(samples)
    rank = max(1, int(-(-q * len(xs) // 100)))       # ceil, clamped to >= 1
    return xs[min(rank, len(xs)) - 1]


def _dist_ms(samples_s: List[float]) -> Dict[str, float]:
    if not samples_s:
        return {"p50": 0.0, "p99": 0.0, "mean": 0.0, "max": 0.0}
    return {
        "p50": percentile(samples_s, 50) * 1e3,
        "p99": percentile(samples_s, 99) * 1e3,
        "mean": sum(samples_s) / len(samples_s) * 1e3,
        "max": max(samples_s) * 1e3,
    }


class ServingStats:
    """Accumulates per-request and per-dispatch serving metrics.

    ``observe(latency_s, queue_wait_s)`` once per completed request;
    ``observe_batch(occupied)`` once per device dispatch (``occupied`` =
    slots carrying real work — the remaining ``slots - occupied`` are
    wasted on padding or already-finished requests and accumulate into
    ``wasted_slot_steps``). Not thread-safe by itself; servers call it
    from their single dispatcher thread and take a snapshot after (or
    guard externally).
    """

    def __init__(self, slots: int):
        self.slots = int(slots)
        self.latencies_s: List[float] = []
        self.queue_waits_s: List[float] = []
        self.dispatches = 0
        self.occupied_slot_steps = 0
        self.wasted_slot_steps = 0
        self._first_s: Optional[float] = None
        self._last_s: Optional[float] = None

    # ------------------------------------------------------------ recording
    def observe(self, latency_s: float, queue_wait_s: float) -> None:
        now = time.perf_counter()
        if self._first_s is None:
            self._first_s = now - latency_s      # back-date to the enqueue
        self._last_s = now
        self.latencies_s.append(float(latency_s))
        self.queue_waits_s.append(float(queue_wait_s))

    def observe_batch(self, occupied: int) -> None:
        occupied = int(occupied)
        if not 0 <= occupied <= self.slots:
            raise ValueError(
                f"occupied={occupied} out of range for slots={self.slots}")
        self.dispatches += 1
        self.occupied_slot_steps += occupied
        self.wasted_slot_steps += self.slots - occupied

    # ------------------------------------------------------------- reading
    @property
    def requests(self) -> int:
        return len(self.latencies_s)

    def snapshot(self) -> Dict:
        span = ((self._last_s - self._first_s)
                if self._first_s is not None and self._last_s is not None
                else 0.0)
        total_slot_steps = self.occupied_slot_steps + self.wasted_slot_steps
        return {
            "requests": self.requests,
            "dispatches": self.dispatches,
            "slots": self.slots,
            "latency_ms": _dist_ms(self.latencies_s),
            "queue_wait_ms": _dist_ms(self.queue_waits_s),
            "batch_occupancy": (self.occupied_slot_steps / total_slot_steps
                                if total_slot_steps else 0.0),
            "wasted_slot_steps": self.wasted_slot_steps,
            "requests_per_sec": (self.requests / span if span > 0 else 0.0),
        }
