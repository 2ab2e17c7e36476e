"""The learner stand-in that the port's hot-swap tests spawn: it attaches to
a ``ParamsChannel`` from its JSON handoff and publishes every leaf scaled.
It imports only numpy and ``repro_torch.core.ipc`` (no torch), so the
spawned process starts in well under a second."""
import numpy as np

from repro_torch.core.ipc import ChannelSpec, ParamsChannel


def publish_scaled(spec_json: str, scale: float) -> None:
    chan = ParamsChannel.attach(ChannelSpec.from_json(spec_json))
    leaves, _version = chan.read()
    chan.publish([x * np.float32(scale) for x in leaves])
    chan.close()
