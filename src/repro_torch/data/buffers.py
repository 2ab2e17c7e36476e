"""Experience buffers (port of the ``fifo`` kind of
``repro/data/buffers.py``; ``uniform`` and ``prioritized`` replay are not
ported yet, see ROADMAP.md)."""
from __future__ import annotations

from repro_torch import registry


class FifoBuffer:
    """On-policy pass-through: the buffer *is* the latest trajectory.
    ``add`` replaces it and ``sample`` returns it untouched."""

    name = "fifo"
    kind = "trajectory"
    passthrough = True

    def init(self, example=None):
        """Nothing is held until the first ``add``."""
        return example

    def add(self, state, traj):
        return traj

    def sample(self, state, generator=None):
        return state


registry.register("buffer", "fifo", FifoBuffer)
