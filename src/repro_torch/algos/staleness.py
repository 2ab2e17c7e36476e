"""Importance-weighted staleness correction (port of
``repro/algos/staleness.py``, on tensors).

Free-running samplers act with whatever params version was last
published, so by the time the learner consumes a trajectory it may be
``gap = learner_version - acted_with_version`` updates stale. Two modes on
top of ``off`` (the default: a no-op that keeps every bit-for-bit
guarantee):

* ``decay``  — ``w = decay ** gap``. For replay the weight is computed at
  ingest (``OffPolicyAlgorithm.observe``) and multiplies the buffer's
  importance weights at sample time.
* ``vtrace`` — for PPO's advantage path: the decay weight times the
  truncated importance ratio ``min(rho_clip, pi_now(a|s) /
  pi_behavior(a|s))`` without gradient (Espeholt et al., 2018). Replay
  has no behaviour logp, so there ``vtrace`` acts as ``decay``.

With ``mode="off"``, or in lock-step runs, which attach no gap, no
trajectory key is added and no loss term changes.

Plumbing: ``AsyncOrchestrator`` attaches the per-trajectory gap as a
``(T, B)`` float32 ``staleness_gap`` leaf before merging; ``algos.api``
routes it into the PPO loss (``make_mlp_learner``) or into replay ingest
(``staleness_w``, then ``batch["weights"]``). Algorithms opt in through
``supports_staleness`` / ``enable_staleness`` (PPO, DDPG, SAC; TRPO's line
search has no weighting seam).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Union

import torch

MODES = ("off", "decay", "vtrace")


@dataclasses.dataclass(frozen=True)
class StalenessConfig:
    """How stale experience is down-weighted (plain data, spec-friendly)."""

    mode: str = "off"
    decay: float = 0.9          # geometric weight per version of staleness
    rho_clip: float = 1.0       # vtrace: truncation of the importance ratio

    def __post_init__(self):
        if self.mode not in MODES:
            raise ValueError(
                f"unknown staleness mode {self.mode!r}; choose from {MODES}")
        if not 0.0 < self.decay <= 1.0:
            raise ValueError(f"staleness decay={self.decay} must be in "
                             f"(0, 1]")
        if self.rho_clip <= 0.0:
            raise ValueError(f"rho_clip={self.rho_clip} must be > 0")

    @property
    def enabled(self) -> bool:
        return self.mode != "off"

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)

    @classmethod
    def parse(cls, value: Union[None, str, Dict[str, Any],
                                "StalenessConfig"]) -> "StalenessConfig":
        """None, a mode string, a kwargs dict or a config: one
        ``StalenessConfig``."""
        if value is None:
            return cls()
        if isinstance(value, cls):
            return value
        if isinstance(value, str):
            return cls(mode=value)
        return cls(**dict(value))


STALENESS_OFF = StalenessConfig()

GAP_KEY = "staleness_gap"       # (T, B) f32 versions behind, runner-attached
WEIGHT_KEY = "staleness_w"      # per-transition weight stored in replay


def decay_weights(cfg: StalenessConfig, gap: torch.Tensor) -> torch.Tensor:
    """``decay ** gap`` in float32; ``gap`` holds versions behind."""
    base = torch.tensor(cfg.decay, dtype=torch.float32, device=gap.device)
    return base ** gap.to(torch.float32)


def vtrace_rho(cfg: StalenessConfig, logp_now: torch.Tensor,
               behavior_logp: torch.Tensor) -> torch.Tensor:
    """The truncated importance ratio ``min(rho_clip, exp(logp_now -
    mu))``, with no gradient through ``logp_now``."""
    ratio = torch.exp(logp_now.detach() - behavior_logp)
    return torch.minimum(torch.tensor(cfg.rho_clip, dtype=torch.float32,
                                      device=ratio.device), ratio)
