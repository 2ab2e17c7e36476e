"""Gaussian-MLP policy + value network, the paper's model (port of
``repro/models/mlp_policy.py``).

Tanh hidden layers, a state-independent ``log_std``, and a separate value
MLP. The reference's params pytree ``{"pi": [{"w","b"}...], "log_std",
"vf": [...]}`` becomes an ``nn.Module`` with ``nn.Linear`` layers, whose
weight is the transpose of the reference's ``w`` (``convert.py`` maps one
onto the other).
"""
from __future__ import annotations

import math
from typing import Tuple

import torch
from torch import nn

from repro_torch.models import layers

LOG_STD_INIT = -0.5


def _mlp(sizes) -> nn.ModuleList:
    return nn.ModuleList(nn.utils.skip_init(nn.Linear, i, o)
                         for i, o in zip(sizes[:-1], sizes[1:]))


def _init_layers(generator: torch.Generator, linears) -> None:
    """Fan-in truncated-normal weights and zero biases, drawn from
    ``generator`` layer by layer."""
    with torch.no_grad():
        for lyr in linears:
            w = layers.dense_init(generator,
                                  (lyr.in_features, lyr.out_features))
            lyr.weight.copy_(w.T)
            lyr.bias.zero_()


def init_mlp_net(generator: torch.Generator, sizes) -> nn.ModuleList:
    """An MLP with layer widths ``sizes`` (port of ``init_mlp_net``):
    ``nn.Linear`` layers initialised by ``_init_layers``; ``mlp_apply``
    puts tanh between them."""
    net = _mlp(sizes)
    _init_layers(generator, net)
    return net


def mlp_apply(net: nn.ModuleList, x: torch.Tensor) -> torch.Tensor:
    for i, lyr in enumerate(net):
        x = lyr(x)
        if i < len(net) - 1:
            x = torch.tanh(x)
    return x


def gaussian_logp(mean, std, action) -> torch.Tensor:
    z = (action - mean) / std
    return torch.sum(-0.5 * z ** 2 - torch.log(std)
                     - 0.5 * math.log(2 * math.pi), dim=-1)


class MLPPolicy(nn.Module):
    """Policy MLP ``obs -> mean``, ``log_std``, and value MLP ``obs -> v``.
    ``parameters()`` yields log_std, then the pi layers, then the vf
    layers (each weight, bias); the Adam moments follow that order."""

    def __init__(self, obs_dim: int, act_dim: int, hidden: int = 64,
                 depth: int = 2):
        super().__init__()
        sizes = [obs_dim] + [hidden] * depth
        self.pi = _mlp(sizes + [act_dim])
        self.log_std = nn.Parameter(torch.full((act_dim,), LOG_STD_INIT))
        self.vf = _mlp(sizes + [1])

    def dist(self, obs: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        mean = mlp_apply(self.pi, obs)
        return mean, torch.exp(self.log_std).expand_as(mean)

    def sample_action(self, obs: torch.Tensor, noise: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
        """``mean + std * noise`` and its log-probability; ``noise`` is a
        standard normal draw of the action's shape."""
        mean, std = self.dist(obs)
        action = mean + std * noise
        return action, gaussian_logp(mean, std, action)

    def logp(self, obs: torch.Tensor, action: torch.Tensor) -> torch.Tensor:
        mean, std = self.dist(obs)
        return gaussian_logp(mean, std, action)

    def entropy(self) -> torch.Tensor:
        return torch.sum(self.log_std + 0.5 * math.log(2 * math.pi * math.e))

    def value(self, obs: torch.Tensor) -> torch.Tensor:
        return mlp_apply(self.vf, obs)[..., 0]


def init_policy(generator: torch.Generator, obs_dim: int, act_dim: int,
                hidden: int = 64, depth: int = 2) -> MLPPolicy:
    """Fan-in truncated-normal weights, zero biases, ``log_std`` -0.5;
    drawn from ``generator`` (pi layers first, then vf layers)."""
    policy = MLPPolicy(obs_dim, act_dim, hidden, depth)
    _init_layers(generator, list(policy.pi) + list(policy.vf))
    return policy
