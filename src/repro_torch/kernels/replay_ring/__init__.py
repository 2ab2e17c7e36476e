from repro_torch.kernels.replay_ring.ops import ring_gather, ring_insert  # noqa: F401
