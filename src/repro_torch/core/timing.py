"""Phase timers for the collection-vs-learning split (port of
``repro/core/timing.py``), and the device barriers a phase timer needs.

A timed phase ends in ``stream_synchronize``: it waits for the work of its
own stream only. Under the overlap schedule the collect and the learn run
at once on two streams, and a barrier over the whole device
(``synchronize``) would make each phase wait for the other.
"""
from __future__ import annotations

import contextlib
import dataclasses
import time
from collections import defaultdict
from typing import Dict, List, Optional

import torch


def synchronize(device: torch.device) -> None:
    """Wait for all the device's queued work, on every stream. PyTorch
    returns from a CUDA call before the card has finished, so a host clock
    read without a barrier measures only the launches (the reference's
    ``block_until_ready``)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def stream_synchronize(device: torch.device) -> None:
    """Wait for the work queued on this thread's current stream of
    ``device``, and for nothing else."""
    if device.type == "cuda":
        torch.cuda.current_stream(device).synchronize()


def on_stream(stream: Optional["torch.cuda.Stream"]):
    """``torch.cuda.stream(stream)``, or nothing for ``None`` (the CPU)."""
    return (contextlib.nullcontext() if stream is None
            else torch.cuda.stream(stream))


@dataclasses.dataclass
class PhaseTimer:
    """Accumulates wall-clock seconds per named phase, per iteration."""
    records: Dict[str, List[float]] = dataclasses.field(
        default_factory=lambda: defaultdict(list))

    def time(self, phase: str):
        timer = self

        class _Ctx:
            def __enter__(self):
                self.t0 = time.perf_counter()
                return self

            def __exit__(self, *exc):
                timer.records[phase].append(time.perf_counter() - self.t0)

        return _Ctx()

    def add(self, phase: str, seconds: float) -> None:
        self.records[phase].append(seconds)

    def total(self, phase: str) -> float:
        return sum(self.records.get(phase, []))

    def mean(self, phase: str) -> float:
        r = self.records.get(phase, [])
        return sum(r) / len(r) if r else 0.0

    def fractions(self) -> Dict[str, float]:
        totals = {k: self.total(k) for k in self.records}
        denom = sum(totals.values()) or 1.0
        return {k: v / denom for k, v in totals.items()}

    def summary(self) -> Dict[str, Dict[str, float]]:
        return {k: {"total": self.total(k), "mean": self.mean(k),
                    "count": len(v)} for k, v in self.records.items()}
