"""The learner plane's mesh (port of ``repro/launch/mesh.py``
``make_learner_mesh``).

The port's mesh is a list of ``torch.device``s, one per learner shard; the
shards run in threads of one process (``distributed/learner.py``). On
``cuda`` the visible devices are ``torch.cuda.device_count()``. On the CPU
every shard is ``cpu``, and how many may be asked for is read from the
environment variable ``HOST_DEVICES_ENV`` when the mesh is built (never on
import): the counterpart of the reference's
``XLA_FLAGS=--xla_force_host_platform_device_count``. A function, not a
module constant, so importing this module touches no device.
"""
from __future__ import annotations

import os
from typing import List

import torch

# the CPU's learner-device count (default 1), read by make_learner_mesh
HOST_DEVICES_ENV = "REPRO_TORCH_HOST_DEVICES"


def visible_devices(device_type: str) -> int:
    """How many learner devices of ``device_type`` the mesh may use."""
    if device_type == "cuda":
        return torch.cuda.device_count()
    if device_type == "cpu":
        return max(1, int(os.environ.get(HOST_DEVICES_ENV, "1")))
    raise ValueError(f"no learner mesh on device type {device_type!r}")


def make_learner_mesh(num_devices: int, pods: int = 1, offset: int = 0,
                      device="cuda") -> List[torch.device]:
    """``num_devices`` devices of ``device``'s type starting at
    ``offset`` (moved down where too few devices follow it, as the
    reference does). Raises the reference's ``ValueError`` when
    ``num_devices`` exceeds the visible devices. ``pods > 1`` (the
    reference's ``(pod, data, model)`` mesh) is not ported (ROADMAP.md
    item 10d)."""
    if pods > 1:
        raise NotImplementedError(
            "learner_pods > 1 is not ported to repro_torch yet; see "
            "ROADMAP.md item 10d (the JAX package repro runs it)")
    kind = torch.device(device).type
    visible = visible_devices(kind)
    if offset + num_devices > visible:
        offset = max(0, visible - num_devices)
    if num_devices > visible:
        hint = (f"on the CPU set {HOST_DEVICES_ENV}={num_devices}"
                if kind == "cpu" else "a CUDA host with that many devices "
                "is needed")
        raise ValueError(
            f"learner_devices={num_devices} but only {visible} {kind} "
            f"device(s) are visible; {hint}")
    if kind == "cpu":
        return [torch.device("cpu")] * num_devices
    return [torch.device(kind, offset + i) for i in range(num_devices)]
