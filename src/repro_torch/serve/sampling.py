"""Token sampling for the LM servers: Gumbel-max.

``jax.random.categorical(key, logits)`` is ``argmax(logits +
gumbel(key))``; the port draws the Gumbel noise from a ``torch.Generator``
(other numbers than ``jax.random``'s from the same seed) or takes it from a
caller's noise source, a callable ``shape -> tensor``, which is how the
tests inject the reference's noise and expect its tokens.
"""
from __future__ import annotations

from typing import Callable, Tuple

import torch

NoiseSource = Callable[[Tuple[int, ...]], torch.Tensor]


def gumbel_source(generator: torch.Generator) -> NoiseSource:
    """Standard Gumbel noise ``-log(-log(u))``, u uniform in [tiny, 1),
    drawn from ``generator`` on its device."""
    tiny = torch.finfo(torch.float32).tiny

    def draw(shape: Tuple[int, ...]) -> torch.Tensor:
        u = torch.rand(shape, generator=generator, device=generator.device)
        return -torch.log(-torch.log(u.clamp_min_(tiny)))

    return draw


def sample(logits: torch.Tensor, noise: NoiseSource,
           temperature: float = 1.0) -> torch.Tensor:
    """One token per row: ``argmax(logits / temperature + g)``."""
    g = noise(tuple(logits.shape)).to(logits.device)
    return torch.argmax(logits / temperature + g, dim=-1)
