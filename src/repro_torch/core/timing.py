"""The device barrier every phase timer needs (the part of
``repro/core/timing.py`` the port uses: ``IterationLog`` carries the
collection-vs-learning split itself)."""
from __future__ import annotations

import torch


def synchronize(device: torch.device) -> None:
    """Wait for the device's queued work. PyTorch returns from a CUDA call
    before the card has finished, so a host clock read without this
    measures only the launches (the reference's ``block_until_ready``)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
