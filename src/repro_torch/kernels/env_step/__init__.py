from repro_torch.kernels.env_step.ops import ENV_NAMES, env_step  # noqa: F401
