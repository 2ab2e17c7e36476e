from repro_torch.kernels.gae.ops import gae  # noqa: F401
