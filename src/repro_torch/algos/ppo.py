"""Proximal Policy Optimization (port of ``repro/algos/ppo.py``): on the
Gaussian-MLP policy, and token-level on a sequence-model policy.

The MLP learner runs GAE, normalises advantages, then ``epochs`` passes of
``minibatches`` clipped-surrogate steps over contiguous slices of the
flattened batch (no permutation, as in the reference), so it is
deterministic given the trajectory. Its gradients go through
``distributed.grad_sync.value_and_grad``: plain autograd outside a sharded
learner step, microbatched and averaged across shards inside one. The LM
learner (``lm_ppo_loss``, ``make_lm_train_step``) takes one step on a
batch of token positions, through ``models.transformer.forward`` on its
plain paths, with ``torch.autograd.grad``, as the reference's LM path
takes ``jax.value_and_grad``. Clipping and Adam are the hand-written ports
in ``optim``.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List

import torch

from repro_torch.algos import gae as gae_mod
from repro_torch.algos import staleness as staleness_mod
from repro_torch.distributed import grad_sync
from repro_torch.models import transformer
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
    aux_coef: float = 0.01          # MoE router load-balance weight


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
        (loss, m), grads = grad_sync.value_and_grad(
            lambda p, b: mlp_ppo_loss(p, b, cfg), policy, sl, has_aux=True)
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


# ======================================================== LM (token) PPO
def lm_ppo_loss(model_cfg, params, batch: Dict[str, torch.Tensor],
                cfg: PPOConfig, *, impl: str = "reference",
                remat: str = "full"):
    """Token-level PPO loss for a sequence-model policy (``transformer.LM``
    params); returns ``(loss, metrics)`` with detached metrics.

    batch: tokens (B,S) int — the input context; targets (B,S) — the
    actions (next tokens); behavior_logp, advantages, returns, mask (B,S)
    f32; optional extra_embeds and positions. The hidden states of the
    prefix positions (meta tokens, frontend embeds) are dropped."""
    h, aux = transformer.forward(
        model_cfg, params, batch["tokens"],
        extra_embeds=batch.get("extra_embeds"),
        positions=batch.get("positions"), impl=impl, remat=remat)
    S = batch["targets"].shape[1]
    h = h[:, -S:]                                   # drop prefix positions
    logp, ent = transformer.token_logp_entropy(model_cfg, params, h,
                                               batch["targets"])
    v = transformer.value(model_cfg, params, h)
    mask = batch["mask"]
    denom = torch.clamp(torch.sum(mask), min=1.0)
    pg = torch.sum(clipped_surrogate(logp, batch["behavior_logp"],
                                     batch["advantages"], cfg.clip_eps)
                   * mask) / denom
    v_loss = 0.5 * torch.sum((v - batch["returns"]) ** 2 * mask) / denom
    ent_mean = torch.sum(ent * mask) / denom
    loss = (pg + cfg.value_coef * v_loss - cfg.entropy_coef * ent_mean
            + cfg.aux_coef * aux)
    metrics = {"loss": loss, "pg_loss": pg, "v_loss": v_loss,
               "entropy": ent_mean, "aux": aux}
    return loss, {k: m.detach() for k, m in metrics.items()}


def make_lm_train_step(model_cfg, optimizer, cfg: PPOConfig,
                       impl: str = "reference", remat: str = "full"):
    """``(params, opt_state, batch) -> (params, opt_state, metrics)``: the
    loss, its gradients, global-norm clipping, then ``optimizer``; the
    params are updated in place. ``metrics["grad_norm"]`` is the
    pre-clip norm."""

    def train_step(params, opt_state, batch):
        plist = list(params.parameters())
        loss, metrics = lm_ppo_loss(model_cfg, params, batch, cfg,
                                    impl=impl, remat=remat)
        grads = torch.autograd.grad(loss, plist)
        grads, gnorm = clip_by_global_norm(grads, cfg.max_grad_norm)
        updates, opt_state = optimizer.update(grads, opt_state, plist)
        apply_updates(plist, updates)
        metrics["grad_norm"] = gnorm
        return params, opt_state, metrics

    return train_step
