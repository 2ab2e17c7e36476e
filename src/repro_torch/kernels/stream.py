"""The launch stream every ``ctypes`` wrapper passes to its kernel."""
from __future__ import annotations

import torch


def current(device: torch.device) -> int:
    """The ``cudaStream_t`` of ``device``'s current stream, as the int a
    ``ctypes`` launch takes. It is read without building a
    ``torch.cuda.Stream`` object, which costs more host time per call than
    the attention kernels take on the device at the serve shapes."""
    return torch._C._cuda_getCurrentRawStream(device.index)
