"""DDPG on the replay buffers of the experience plane (port of
``repro/algos/ddpg.py``).

A deterministic tanh actor, a Q critic, and Polyak-averaged target copies
of both. The reference draws its exploration noise from a PRNG key; here it
is injected, as in the rest of the port: ``explore_action(params, obs,
noise, cfg)`` takes the standard-normal draw. Each loss takes its gradient
with respect to its own parameters only, through
``distributed.grad_sync.value_and_grad``, and the updates are applied in
place.
"""
from __future__ import annotations

import copy
import dataclasses
from typing import Dict, Tuple

import torch
from torch import nn

from repro_torch.distributed import grad_sync
from repro_torch.models.mlp_policy import init_mlp_net, mlp_apply
from repro_torch.optim import apply_updates


@dataclasses.dataclass(frozen=True)
class DDPGConfig:
    actor_lr: float = 1e-3
    critic_lr: float = 1e-3
    gamma: float = 0.99
    tau: float = 0.005              # polyak target update
    noise_std: float = 0.1


class DDPGParams(nn.Module):
    """The reference's params pytree as a module: ``actor``, ``critic``
    and their targets, which take no gradient."""

    def __init__(self, actor: nn.ModuleList, critic: nn.ModuleList,
                 target_actor: nn.ModuleList, target_critic: nn.ModuleList):
        super().__init__()
        self.actor = actor
        self.critic = critic
        self.target_actor = target_actor.requires_grad_(False)
        self.target_critic = target_critic.requires_grad_(False)


def init_ddpg(generator: torch.Generator, obs_dim: int, act_dim: int,
              hidden: int = 64) -> DDPGParams:
    """Draws from ``generator``: the actor, then the critic; the targets
    start as copies."""
    actor = init_mlp_net(generator, [obs_dim, hidden, hidden, act_dim])
    critic = init_mlp_net(generator, [obs_dim + act_dim, hidden, hidden, 1])
    return DDPGParams(actor, critic, copy.deepcopy(actor),
                      copy.deepcopy(critic))


def actor_apply(net: nn.ModuleList, obs: torch.Tensor) -> torch.Tensor:
    return torch.tanh(mlp_apply(net, obs))


def critic_apply(net: nn.ModuleList, obs: torch.Tensor, act: torch.Tensor
                 ) -> torch.Tensor:
    return mlp_apply(net, torch.cat([obs, act], dim=-1))[..., 0]


def explore_action(params: DDPGParams, obs: torch.Tensor,
                   noise: torch.Tensor, cfg: DDPGConfig) -> torch.Tensor:
    """The actor's action plus ``noise_std`` times the standard-normal
    ``noise``, clipped to [-1, 1]."""
    a = actor_apply(params.actor, obs)
    return torch.clamp(a + cfg.noise_std * noise, -1.0, 1.0)


def ddpg_update(params: DDPGParams, opt_states, batch: Dict[str, torch.Tensor],
                cfg: DDPGConfig, actor_opt, critic_opt
                ) -> Tuple[DDPGParams, Tuple, Dict[str, torch.Tensor]]:
    """One DDPG step on a replay minibatch, in place on ``params``.

    batch: obs, actions, rewards, next_obs, and either ``discounts`` (the
    buffer's n-step bootstrap factor) or ``dones`` (the discount is then
    ``gamma * (1 - dones)``); optional ``weights`` (prioritized replay's
    importance weights) on the critic regression. The target uses the old
    target nets; the critic steps first, and the actor's loss is taken
    against the updated critic. Returns per-sample ``priorities``
    ``|q - target|`` (q before the critic step) in the metrics."""
    a_state, c_state = opt_states

    # the target built inside the loss, so that a microbatch slices it too
    def critic_loss(cnet, b):
        with torch.no_grad():
            if "discounts" in b:
                discounts = b["discounts"]
            else:
                discounts = cfg.gamma * (1.0 - b["dones"].to(torch.float32))
            a_next = actor_apply(params.target_actor, b["next_obs"])
            q_next = critic_apply(params.target_critic, b["next_obs"],
                                  a_next)
            target = b["rewards"] + discounts * q_next
        w = b.get("weights")
        if w is None:
            w = torch.ones_like(b["rewards"])
        q = critic_apply(cnet, b["obs"], b["actions"])
        return torch.mean(w * (q - target) ** 2), (q.detach(), target)

    (c_loss, (q, target)), c_grads = grad_sync.value_and_grad(
        critic_loss, params.critic, batch, has_aux=True)
    c_params = list(params.critic.parameters())
    c_upd, c_state = critic_opt.update(c_grads, c_state, c_params)
    priorities = torch.abs(q - target)
    apply_updates(c_params, c_upd)

    def actor_loss(anet, b):
        return -torch.mean(critic_apply(params.critic, b["obs"],
                                        actor_apply(anet, b["obs"])))

    a_loss, a_grads = grad_sync.value_and_grad(actor_loss, params.actor,
                                               batch)
    a_params = list(params.actor.parameters())
    a_upd, a_state = actor_opt.update(a_grads, a_state, a_params)
    apply_updates(a_params, a_upd)

    with torch.no_grad():
        for target_net, net in ((params.target_actor, params.actor),
                                (params.target_critic, params.critic)):
            for t, s in zip(target_net.parameters(), net.parameters()):
                t.copy_((1 - cfg.tau) * t + cfg.tau * s)
    metrics = {"critic_loss": c_loss, "actor_loss": a_loss,
               "q_mean": torch.mean(target), "priorities": priorities}
    return params, (a_state, c_state), {
        k: m.detach() for k, m in metrics.items()}
