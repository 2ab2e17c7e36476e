"""The learner plane's mesh (port of ``repro/launch/mesh.py``
``make_learner_mesh``).

The port's mesh is a list of ``torch.device``s, one per learner shard; the
shards run in threads of one process (``distributed/learner.py``). It is a
``LearnerMesh``: a list that also carries the reference's axis names and
sizes, ``("data", "model")`` of ``(D, 1)``, or ``("pod", "data",
"model")`` of ``(pods, D / pods, 1)``; shard ``s`` is mesh position ``s``
in row-major order, as the reference's ``arr.reshape(...)`` lays it out.
The sharding rules (``distributed/sharding.py``) read only those names
and sizes.

On ``cuda`` the visible devices are ``torch.cuda.device_count()``. On the
CPU every shard is ``cpu``, and how many may be asked for is read from the
environment variable ``HOST_DEVICES_ENV`` when the mesh is built (never on
import): the counterpart of the reference's
``XLA_FLAGS=--xla_force_host_platform_device_count``. A function, not a
module constant, so importing this module touches no device.
"""
from __future__ import annotations

import os
from typing import Dict, Sequence, Tuple

import torch

# the CPU's learner-device count (default 1), read by make_learner_mesh
HOST_DEVICES_ENV = "REPRO_TORCH_HOST_DEVICES"


class LearnerMesh(list):
    """The learner's devices in shard order, with the reference mesh's
    ``axis_names`` and ``shape`` (axis name -> size, in axis order)."""

    def __init__(self, devices: Sequence, axis_names: Tuple[str, ...],
                 sizes: Tuple[int, ...]):
        super().__init__(torch.device(d) for d in devices)
        if len(axis_names) != len(sizes):
            raise ValueError(f"{len(axis_names)} axis names for "
                             f"{len(sizes)} sizes")
        n = 1
        for s in sizes:
            n *= int(s)
        if n != len(self):
            raise ValueError(f"a mesh of shape {tuple(sizes)} over "
                             f"{len(self)} devices")
        self.axis_names = tuple(axis_names)
        self.shape: Dict[str, int] = dict(zip(self.axis_names,
                                              (int(s) for s in sizes)))

    @classmethod
    def of(cls, devices: Sequence, pods: int = 1) -> "LearnerMesh":
        """``devices`` as the reference lays them out: ``(data, model)`` of
        ``(D, 1)``, or ``(pod, data, model)`` of ``(pods, D / pods, 1)``."""
        d = len(devices)
        if pods > 1:
            if d % pods:
                raise ValueError(f"learner_pods={pods} must divide "
                                 f"learner_devices={d}")
            return cls(devices, ("pod", "data", "model"),
                       (pods, d // pods, 1))
        return cls(devices, ("data", "model"), (d, 1))


def visible_devices(device_type: str) -> int:
    """How many learner devices of ``device_type`` the mesh may use."""
    if device_type == "cuda":
        return torch.cuda.device_count()
    if device_type == "cpu":
        return max(1, int(os.environ.get(HOST_DEVICES_ENV, "1")))
    raise ValueError(f"no learner mesh on device type {device_type!r}")


def make_learner_mesh(num_devices: int, pods: int = 1, offset: int = 0,
                      device="cuda") -> LearnerMesh:
    """``num_devices`` devices of ``device``'s type starting at
    ``offset`` (moved down where too few devices follow it, as the
    reference does), laid out ``(data, model)``, or ``(pod, data, model)``
    when ``pods > 1``. Raises the reference's ``ValueError`` when
    ``num_devices`` exceeds the visible devices, or when ``pods`` does not
    divide it."""
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
        devices = [torch.device("cpu")] * num_devices
    else:
        devices = [torch.device(kind, offset + i) for i in range(num_devices)]
    return LearnerMesh.of(devices, pods)
