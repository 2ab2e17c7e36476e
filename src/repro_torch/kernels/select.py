"""Kernel selection: ``ref`` | ``cuda`` (port of
``repro/kernels/select.py``).

Every kernel family ships a plain PyTorch version and a CUDA kernel behind
one ``ops.py`` wrapper. Which one runs is decided by the mode and by the
device of the tensors the wrapper is given:

    mode     CPU tensor   CUDA tensor
    ref      plain        plain
    cuda     plain        kernel

A CPU tensor always takes the plain version (there is no kernel for it). A
CUDA tensor under ``cuda`` launches the kernel or raises; nothing falls
back. The names ``auto`` (the reference's default) and ``pallas`` (its
kernel mode) are read as ``cuda``, so a JAX ``ExperimentSpec`` JSON loads
unchanged.

The mode is process-global, as in the reference: ``experiment.build`` sets
it from ``ExperimentSpec.kernels``; wrappers take ``impl=`` to override it
per call.
"""
from __future__ import annotations

from typing import Optional

import torch

MODES = ("ref", "cuda")
ALIASES = {"auto": "cuda", "pallas": "cuda"}

_mode = "cuda"


def canonical(mode: str) -> str:
    """Validate a mode name, mapping ``auto`` and ``pallas`` to ``cuda``."""
    mode = ALIASES.get(mode, mode)
    if mode not in MODES:
        raise ValueError(f"unknown kernel mode {mode!r}; choose from "
                         f"{MODES + tuple(ALIASES)}")
    return mode


def set_kernel_mode(mode: str) -> str:
    """Set the process-global selection mode; returns the previous one."""
    global _mode
    prev, _mode = _mode, canonical(mode)
    return prev


def kernel_mode() -> str:
    return _mode


def use_kernel(impl: Optional[str], tensor: torch.Tensor) -> bool:
    """True when the wrapper must launch its CUDA kernel on ``tensor``."""
    mode = canonical(impl if impl is not None else _mode)
    kind = tensor.device.type
    if kind == "cpu":
        return False
    if kind != "cuda":
        raise ValueError(f"no kernel or plain version for device {kind!r}")
    return mode != "ref"
