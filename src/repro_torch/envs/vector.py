"""Vector collection (port of ``repro/envs/vector.py``).

``VectorEnv`` presents B instances of an ``Env`` as one batch with one
carry, in place of the ``num_samplers × global_batch`` split. In the
reference it is the only path that reaches the batched env-step kernel; in
the port every env is batched, so both collection modes step through the
same ``sampler.batched_step`` and differ only in how many carries the
backend holds and how large each is: ``build`` makes one carry of
``batch`` instances for a ``VectorEnv``.
"""
from __future__ import annotations

from repro_torch.envs.base import Env


class VectorEnv:
    """B instances of ``env`` as one batch (duck-types ``Env``)."""

    def __init__(self, env: Env, batch: int):
        batch = int(batch)
        if batch < 1:
            raise ValueError(f"VectorEnv batch={batch} must be >= 1")
        self.env = env
        self.batch = batch
        self.name = env.name
        self.obs_dim = env.obs_dim
        self.act_dim = env.act_dim
        self.max_episode_steps = env.max_episode_steps
        self.reset = env.reset
        self.batch_step = env.batch_step

    def __repr__(self):
        return f"VectorEnv({self.name}, batch={self.batch})"
