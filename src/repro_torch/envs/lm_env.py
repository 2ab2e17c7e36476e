"""Token-generation environment (port of ``repro/envs/lm_env.py``).

The policy emits tokens autoregressively and a fixed synthetic reward
model scores them: a random-but-fixed per-token preference table plus a
repetition penalty. The table is drawn from a ``torch.Generator``; its
values differ from the reference's ``jax.random`` table, which
``convert.lm_env_from_jax`` carries across.
"""
from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class LMEnv:
    vocab_size: int
    episode_len: int
    reward_table: torch.Tensor       # (V,) fixed per-token reward
    repeat_penalty: float = 0.5

    def token_rewards(self, tokens: torch.Tensor) -> torch.Tensor:
        """tokens (B, T) -> per-token rewards (B, T)."""
        base = self.reward_table[tokens]
        rep = torch.cat([torch.zeros_like(tokens[:, :1], dtype=torch.bool),
                         tokens[:, 1:] == tokens[:, :-1]], dim=1)
        return base - self.repeat_penalty * rep.float()


def make(vocab_size: int, episode_len: int = 32, seed: int = 0,
         device="cpu") -> LMEnv:
    gen = torch.Generator(device=device).manual_seed(seed)
    table = 0.5 * torch.randn(vocab_size, generator=gen, device=device)
    return LMEnv(vocab_size=vocab_size, episode_len=episode_len,
                 reward_table=table)
