"""Carry weights and optimizer state across from the JAX package.

The reference's params pytree is ``{"pi": [{"w", "b"}, ...], "log_std",
"vf": [...]}`` with ``w`` of shape ``(in, out)`` for ``x @ w``; the port's
``MLPPolicy`` holds ``nn.Linear`` layers whose weight is ``(out, in)``, so
``w`` is transposed on the way in and out. Inputs and outputs are numpy
arrays (any array type ``np.asarray`` accepts), so nothing here imports JAX.
"""
from __future__ import annotations

from typing import Any, Dict, List

import numpy as np
import torch

from repro_torch.models.mlp_policy import MLPPolicy
from repro_torch.optim.adam import AdamState


def _flat(tree) -> List[np.ndarray]:
    """The tree's arrays in ``MLPPolicy.parameters()`` order, weights
    transposed to ``nn.Linear``'s layout."""
    out = [np.asarray(tree["log_std"])]
    for name in ("pi", "vf"):
        for lyr in tree[name]:
            out += [np.asarray(lyr["w"]).T, np.asarray(lyr["b"])]
    return out


def params_from_jax(tree: Dict[str, Any], device="cpu") -> MLPPolicy:
    """A reference params pytree (numpy leaves) -> ``MLPPolicy``."""
    pi, vf = tree["pi"], tree["vf"]
    obs_dim = np.asarray(pi[0]["w"]).shape[0]
    act_dim = np.asarray(pi[-1]["w"]).shape[1]
    hidden = np.asarray(pi[0]["w"]).shape[1]
    if len(pi) != len(vf):
        raise ValueError("pi and vf MLPs must have the same depth")
    policy = MLPPolicy(obs_dim, act_dim, hidden=hidden, depth=len(pi) - 1)
    with torch.no_grad():
        for p, x in zip(policy.parameters(), _flat(tree)):
            if tuple(p.shape) != x.shape:
                raise ValueError(f"shape mismatch: {x.shape} for a "
                                 f"{tuple(p.shape)} parameter")
            p.copy_(torch.from_numpy(np.array(x, np.float32)))
    return policy.to(device)


def params_to_jax(policy: MLPPolicy) -> Dict[str, Any]:
    """``MLPPolicy`` -> the reference's params pytree of numpy arrays."""
    def net(layers):
        return [{"w": lyr.weight.detach().cpu().numpy().T.copy(),
                 "b": lyr.bias.detach().cpu().numpy().copy()}
                for lyr in layers]
    return {"pi": net(policy.pi),
            "log_std": policy.log_std.detach().cpu().numpy().copy(),
            "vf": net(policy.vf)}


def adam_state_from_jax(state, device="cpu") -> AdamState:
    """A reference ``AdamState(step, mu, nu)`` (numpy leaves, mu/nu shaped
    like the params pytree) -> the port's ``AdamState``."""
    step, mu, nu = state

    def moments(tree):
        return [torch.from_numpy(np.array(x, np.float32)).to(device)
                for x in _flat(tree)]

    return AdamState(int(np.asarray(step)), moments(mu), moments(nu))
