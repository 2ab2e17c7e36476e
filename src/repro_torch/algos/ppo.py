"""Proximal Policy Optimization on the Gaussian-MLP policy (port of the MLP
half of ``repro/algos/ppo.py``).

The learner runs GAE, normalises advantages, then ``epochs`` passes of
``minibatches`` clipped-surrogate steps over contiguous slices of the
flattened batch (no permutation, as in the reference), so it is
deterministic given the trajectory. Gradients come from autograd; clipping
and Adam are the hand-written ports in ``optim``.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List

import torch

from repro_torch.algos import gae as gae_mod
from repro_torch.algos import staleness as staleness_mod
from repro_torch.optim import apply_updates, clip_by_global_norm


@dataclasses.dataclass(frozen=True)
class PPOConfig:
    lr: float = 3e-4
    clip_eps: float = 0.2
    value_coef: float = 0.5
    entropy_coef: float = 0.01
    gamma: float = 0.99
    lam: float = 0.95
    epochs: int = 4
    minibatches: int = 4
    max_grad_norm: float = 0.5


def clipped_surrogate(logp, behavior_logp, adv, clip_eps) -> torch.Tensor:
    ratio = torch.exp(logp - behavior_logp)
    return -torch.minimum(
        ratio * adv, torch.clamp(ratio, 1 - clip_eps, 1 + clip_eps) * adv)


def mlp_ppo_loss(policy, batch: Dict[str, torch.Tensor], cfg: PPOConfig):
    """Clipped-surrogate loss + value error - entropy bonus; returns
    ``(loss, metrics)`` with detached metrics. An optional per-sample
    ``weights`` key (staleness correction) scales both the surrogate and
    the value error; without it the computation is the unweighted one,
    op for op."""
    logp = policy.logp(batch["obs"], batch["actions"])
    surrogate = clipped_surrogate(logp, batch["behavior_logp"],
                                  batch["advantages"], cfg.clip_eps)
    v = policy.value(batch["obs"])
    w = batch.get("weights")
    if w is None:
        pg = torch.mean(surrogate)
        v_loss = 0.5 * torch.mean((v - batch["returns"]) ** 2)
    else:
        pg = torch.mean(w * surrogate)
        v_loss = 0.5 * torch.mean(w * (v - batch["returns"]) ** 2)
    ent = policy.entropy()
    loss = pg + cfg.value_coef * v_loss - cfg.entropy_coef * ent
    metrics = {"loss": loss, "pg_loss": pg, "v_loss": v_loss, "entropy": ent,
               "approx_kl": torch.mean(batch["behavior_logp"] - logp)}
    return loss, {k: m.detach() for k, m in metrics.items()}


def mean_metrics(ms: List[Dict[str, torch.Tensor]]
                 ) -> Dict[str, torch.Tensor]:
    """Each metric's mean over a list of metric dicts."""
    return {k: torch.stack([m[k] for m in ms]).mean() for k in ms[0]}


def mlp_ppo_update(policy, opt_state, batch, cfg: PPOConfig, optimizer):
    """One epoch of minibatched PPO on a flat (N, ...) batch; updates
    ``policy`` in place."""
    mb = batch["obs"].shape[0] // cfg.minibatches
    params = list(policy.parameters())
    metrics = []
    for i in range(cfg.minibatches):
        sl = {k: x[i * mb:(i + 1) * mb] for k, x in batch.items()}
        loss, m = mlp_ppo_loss(policy, sl, cfg)
        grads = torch.autograd.grad(loss, params)
        grads, gnorm = clip_by_global_norm(grads, cfg.max_grad_norm)
        updates, opt_state = optimizer.update(grads, opt_state, params)
        apply_updates(params, updates)
        m["grad_norm"] = gnorm
        metrics.append(m)
    return policy, opt_state, mean_metrics(metrics)


def make_mlp_learner(optimizer, cfg: PPOConfig, staleness=None):
    """``learn(policy, opt_state, traj) -> (policy, opt_state, metrics)``:
    GAE, normalised advantages, then ``cfg.epochs`` minibatched epochs.

    ``staleness`` (an enabled ``algos.staleness.StalenessConfig``) weights
    each sample by ``decay ** staleness_gap`` (the params-version gap the
    async runtime stamps onto the trajectory) and, in ``vtrace`` mode, by
    the truncated importance ratio ``min(rho_clip, pi_now / pi_behavior)``
    too, without gradient. Disabled, or on a trajectory with no gap (every
    lock-step path), no ``weights`` key is built."""

    def learn(policy, opt_state, traj: Dict[str, torch.Tensor]):
        # traj tensors: (T, B, ...) time-major from the sampler
        adv, ret = gae_mod.gae(traj["rewards"], traj["values"],
                               traj["dones"], traj["last_value"],
                               cfg.gamma, cfg.lam)
        batch = {
            "obs": traj["obs"],
            "actions": traj["actions"],
            "behavior_logp": traj["logp"],
            "advantages": gae_mod.normalize(adv),
            "returns": ret,
        }
        if (staleness is not None and staleness.enabled
                and staleness_mod.GAP_KEY in traj):
            w = staleness_mod.decay_weights(staleness,
                                            traj[staleness_mod.GAP_KEY])
            if staleness.mode == "vtrace":
                with torch.no_grad():
                    logp_now = policy.logp(traj["obs"], traj["actions"])
                w = w * staleness_mod.vtrace_rho(staleness, logp_now,
                                                 traj["logp"])
            batch["weights"] = w.detach()
        flat = {k: x.reshape((-1,) + tuple(x.shape[2:]))
                for k, x in batch.items()}
        metrics = []
        for _ in range(cfg.epochs):
            policy, opt_state, m = mlp_ppo_update(policy, opt_state, flat,
                                                  cfg, optimizer)
            metrics.append(m)
        return policy, opt_state, mean_metrics(metrics)

    return learn
