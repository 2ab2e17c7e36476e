from repro_torch.kernels.gae.ops import discounted_returns, gae  # noqa: F401
