"""Deterministic fault injection for the actor plane (port of
``repro/core/faults.py``; numpy only, so the schedule is the reference's
draw for draw).

A ``FaultPlan`` is a seeded schedule of worker failures: every rollout a
worker performs draws one uniform from a PRNG stream keyed by ``(plan
seed, worker_id, incarnation, rollout counter)`` and maps it to at most
one fault. The key holds the worker's incarnation (how many times it has
been spawned), so a respawned worker replays a fresh but still
deterministic schedule instead of dying at the same step forever.

Fault kinds (probabilities per rollout, evaluated in this order):

* ``kill``  — SIGKILL self before writing the trajectory: a clean death
  with no in-flight ring state.
* ``torn``  — die mid-write: bump the slot's seqlock to odd (write in
  progress), then SIGKILL. The supervisor must detect the stuck header
  and reclaim the slot.
* ``hang``  — stop heartbeating and spin forever: a wedged but alive
  worker, detectable only through its heartbeat age.
* ``delay`` — sleep ``delay_ms`` before the rollout: a straggler, not a
  failure.

The plan rides ``ExperimentSpec.faults`` (the CLI's ``--inject-faults``
string, e.g. ``"kill:0.2,torn:0.05"``) into every worker process.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

KINDS = ("kill", "torn", "hang", "delay")


@dataclasses.dataclass(frozen=True)
class FaultPlan:
    """Seeded per-rollout fault schedule (plain data; pickles to workers)."""

    seed: int = 0
    kill: float = 0.0           # P(SIGKILL self before writing)
    torn: float = 0.0           # P(die mid-write: seqlock left odd)
    hang: float = 0.0           # P(wedge: alive but never heartbeats again)
    delay: float = 0.0          # P(sleep delay_ms before the rollout)
    delay_ms: float = 50.0

    def __post_init__(self):
        total = self.kill + self.torn + self.hang + self.delay
        if total > 1.0:
            raise ValueError(
                f"fault probabilities sum to {total:.3f} > 1 "
                f"(kill={self.kill}, torn={self.torn}, hang={self.hang}, "
                f"delay={self.delay})")
        for kind in KINDS:
            if getattr(self, kind) < 0.0:
                raise ValueError(f"fault probability {kind} must be >= 0")

    @property
    def any(self) -> bool:
        return (self.kill + self.torn + self.hang + self.delay) > 0.0

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: Optional[dict]) -> Optional["FaultPlan"]:
        return None if d is None else cls(**d)

    @classmethod
    def parse(cls, text: Optional[str],
              seed: int = 0) -> Optional["FaultPlan"]:
        """Parse the CLI spec string: ``kind:prob`` pairs joined by commas
        — ``"kill:0.2,torn:0.05,delay:0.1:80,seed:7"`` (``delay`` takes an
        optional ``:ms`` suffix; ``seed`` overrides the default)."""
        if not text:
            return None
        kwargs: dict = {"seed": seed}
        for part in text.split(","):
            part = part.strip()
            if not part:
                continue
            name, _, rest = part.partition(":")
            if name == "seed":
                kwargs["seed"] = int(rest)
            elif name == "delay":
                prob, _, ms = rest.partition(":")
                kwargs["delay"] = float(prob)
                if ms:
                    kwargs["delay_ms"] = float(ms)
            elif name in ("kill", "torn", "hang"):
                kwargs[name] = float(rest)
            else:
                raise ValueError(
                    f"unknown fault kind {name!r} in --inject-faults "
                    f"spec {text!r}; choose from {KINDS} (+ 'seed')")
        return cls(**kwargs)


def decide(plan: Optional[FaultPlan], worker_id: int, incarnation: int,
           step: int) -> Optional[str]:
    """The fault (or None) worker ``worker_id`` suffers at rollout
    ``step`` of its ``incarnation``-th life. Pure: the same arguments
    always give the same decision, on any host."""
    if plan is None or not plan.any:
        return None
    rng = np.random.default_rng(
        [int(plan.seed), int(worker_id), int(incarnation), int(step)])
    u = float(rng.random())
    for kind in KINDS:
        p = getattr(plan, kind)
        if u < p:
            return kind
        u -= p
    return None
