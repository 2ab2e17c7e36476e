"""Soft Actor-Critic (port of ``repro/algos/sac.py``): twin Q critics, a
tanh-squashed Gaussian actor and a learned entropy temperature, on the
replay buffers of the experience plane (uniform or prioritized, any
``n_step``).

The reference draws its noise from a PRNG key inside the update; here it
is injected, as in the rest of the port: ``act(params, obs, noise)`` takes
the standard-normal draw, and ``learn`` reads ``batch["noise_next"]`` and
``batch["noise_new"]`` (both ``(B, act_dim)``) where the reference splits
``batch["rng"]``. Each loss takes ``torch.autograd.grad`` with respect to
its own parameters only; the target and ``logp_new`` are detached where
the reference stops their gradient. Updates are applied in place.
"""
from __future__ import annotations

import copy
import dataclasses
import math
from typing import Dict, Tuple

import torch
from torch import nn

from repro_torch.algos.api import OffPolicyAlgorithm
from repro_torch.models.mlp_policy import gaussian_logp, init_mlp_net, mlp_apply
from repro_torch.optim import adam, apply_updates

LOG_STD_MIN, LOG_STD_MAX = -5.0, 2.0


@dataclasses.dataclass(frozen=True)
class SACConfig:
    actor_lr: float = 3e-4
    critic_lr: float = 3e-4
    alpha_lr: float = 3e-4
    gamma: float = 0.99
    tau: float = 0.005              # polyak target update
    init_alpha: float = 0.1         # initial entropy temperature


class SACParams(nn.Module):
    """The reference's params pytree as a module: ``actor`` (one head,
    ``[mean, log_std]`` halves), ``critic`` and ``target_critic``
    (``q1``, ``q2``), and the scalar ``log_alpha``. The target critic
    takes no gradient."""

    def __init__(self, actor: nn.ModuleList, critic: nn.ModuleDict,
                 target_critic: nn.ModuleDict, log_alpha: float):
        super().__init__()
        self.actor = actor
        self.critic = critic
        self.target_critic = target_critic.requires_grad_(False)
        self.log_alpha = nn.Parameter(torch.tensor(log_alpha,
                                                   dtype=torch.float32))


def init_sac(generator: torch.Generator, obs_dim: int, act_dim: int,
             hidden: int = 64, init_alpha: float = 0.1) -> SACParams:
    """Draws from ``generator``: the actor, then q1, then q2; the target
    critic starts as a copy of the critic."""
    actor = init_mlp_net(generator, [obs_dim, hidden, hidden, 2 * act_dim])
    critic = nn.ModuleDict({
        q: init_mlp_net(generator, [obs_dim + act_dim, hidden, hidden, 1])
        for q in ("q1", "q2")})
    return SACParams(actor, critic, copy.deepcopy(critic),
                     math.log(init_alpha))


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: ``logaddexp(x, 0)``, without the linear
    threshold of ``F.softplus``."""
    return torch.logaddexp(x, torch.zeros_like(x))


def actor_dist(net: nn.ModuleList, obs: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    mean, log_std = torch.chunk(mlp_apply(net, obs), 2, dim=-1)
    return mean, torch.exp(torch.clamp(log_std, LOG_STD_MIN, LOG_STD_MAX))


def sample_action(net: nn.ModuleList, obs: torch.Tensor,
                  noise: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """tanh-squashed reparameterised sample ``tanh(mean + std * noise)``
    and its log-prob, ``log N(u) - sum log(1 - tanh(u)^2)`` with the
    squash correction in the stable softplus form."""
    mean, std = actor_dist(net, obs)
    u = mean + std * noise
    action = torch.tanh(u)
    squash = 2.0 * (math.log(2.0) - u - softplus(-2.0 * u))
    logp = gaussian_logp(mean, std, u) - torch.sum(squash, dim=-1)
    return action, logp


def q_apply(qnet: nn.ModuleList, obs: torch.Tensor, act: torch.Tensor
            ) -> torch.Tensor:
    return mlp_apply(qnet, torch.cat([obs, act], dim=-1))[..., 0]


def sac_update(params: SACParams, opt_states, batch: Dict[str, torch.Tensor],
               cfg: SACConfig, actor_opt, critic_opt, alpha_opt
               ) -> Tuple[SACParams, Tuple, Dict[str, torch.Tensor]]:
    """One SAC step on a replay minibatch, in place on ``params``.

    batch: obs, actions, rewards, next_obs, discounts (the buffer's
    gamma^n bootstrap factor), optional ``weights`` (prioritized replay's
    importance weights, applied to the critic regression), and the noise
    ``noise_next``/``noise_new``. Returns per-sample ``priorities`` in the
    metrics."""
    a_state, c_state, al_state = opt_states
    target_entropy = -float(batch["actions"].shape[-1])
    alpha = torch.exp(params.log_alpha.detach())
    critic, target_critic = params.critic, params.target_critic

    # twin-critic regression against the entropy-regularised target
    with torch.no_grad():
        a_next, logp_next = sample_action(params.actor, batch["next_obs"],
                                          batch["noise_next"])
        q_next = torch.minimum(
            q_apply(target_critic["q1"], batch["next_obs"], a_next),
            q_apply(target_critic["q2"], batch["next_obs"], a_next))
        target = batch["rewards"] + batch["discounts"] * (
            q_next - alpha * logp_next)
    w = batch.get("weights")
    if w is None:
        w = torch.ones_like(batch["rewards"])
    q1 = q_apply(critic["q1"], batch["obs"], batch["actions"])
    q2 = q_apply(critic["q2"], batch["obs"], batch["actions"])
    c_loss = 0.5 * torch.mean(w * ((q1 - target) ** 2 + (q2 - target) ** 2))
    c_params = list(critic.parameters())
    c_upd, c_state = critic_opt.update(torch.autograd.grad(c_loss, c_params),
                                       c_state, c_params)
    apply_updates(c_params, c_upd)

    # reparameterised actor step against the fresh critic
    a_params = list(params.actor.parameters())
    a_new, logp_new = sample_action(params.actor, batch["obs"],
                                    batch["noise_new"])
    q_min = torch.minimum(q_apply(critic["q1"], batch["obs"], a_new),
                          q_apply(critic["q2"], batch["obs"], a_new))
    a_loss = torch.mean(alpha * logp_new - q_min)
    a_upd, a_state = actor_opt.update(torch.autograd.grad(a_loss, a_params),
                                      a_state, a_params)
    apply_updates(a_params, a_upd)

    # temperature: pull the entropy toward -act_dim
    log_alpha = params.log_alpha
    al_loss = -torch.mean(log_alpha * (logp_new.detach() + target_entropy))
    al_upd, al_state = alpha_opt.update(
        torch.autograd.grad(al_loss, [log_alpha]), al_state, [log_alpha])
    apply_updates([log_alpha], al_upd)

    with torch.no_grad():
        for t, s in zip(target_critic.parameters(), critic.parameters()):
            t.copy_((1 - cfg.tau) * t + cfg.tau * s)
        td = 0.5 * (torch.abs(q1 - target) + torch.abs(q2 - target))
    metrics = {"critic_loss": c_loss, "actor_loss": a_loss, "alpha": alpha,
               "alpha_loss": al_loss, "entropy": -torch.mean(logp_new),
               "q_mean": torch.mean(target), "priorities": td}
    return params, (a_state, c_state, al_state), {
        k: m.detach() for k, m in metrics.items()}


class SACAlgorithm(OffPolicyAlgorithm):
    """SAC through the ``Algorithm`` hooks; the buffer wiring comes from
    ``OffPolicyAlgorithm``."""

    name = "sac"
    learner_noise = ("noise_next", "noise_new")

    def __init__(self, lr: float = None, hidden: int = 64,
                 updates_per_collect: int = 4, **cfg_kwargs):
        if lr is not None:
            cfg_kwargs.setdefault("actor_lr", lr)
            cfg_kwargs.setdefault("critic_lr", lr)
        self.cfg = SACConfig(**cfg_kwargs)
        self.hidden = hidden
        self.updates_per_collect = updates_per_collect
        self._a_opt = adam(self.cfg.actor_lr)
        self._c_opt = adam(self.cfg.critic_lr)
        self._al_opt = adam(self.cfg.alpha_lr)

    def init(self, generator, env, device):
        """Params drawn from ``generator`` (a CPU generator, so a seed gives
        the same weights on every device), then moved to ``device``."""
        params = init_sac(generator, env.obs_dim, env.act_dim,
                          hidden=self.hidden,
                          init_alpha=self.cfg.init_alpha).to(device)
        return params, (self._a_opt.init(list(params.actor.parameters())),
                        self._c_opt.init(list(params.critic.parameters())),
                        self._al_opt.init([params.log_alpha]))

    def learn(self, params, opt_state, batch):
        return sac_update(params, opt_state, batch, self.cfg, self._a_opt,
                          self._c_opt, self._al_opt)

    def act(self, params, obs, noise):
        action, _ = sample_action(params.actor, obs, noise)
        return action, {}
