"""Trust-Region Policy Optimization (port of ``repro/algos/trpo.py``).

Natural gradient by conjugate gradient on Fisher-vector products (the
Hessian of the mean KL times a vector, a jvp of a grad), then a
backtracking line search that enforces the KL trust region, then 25 plain
gradient steps of value-function regression. All of it stays on the
device: the line search picks its coefficient with ``torch.where``, so
``trpo_update`` reads no device value on the host.

The update works on the reference's params tree, ``{"pi": [{"w", "b"},
...], "log_std"}`` with ``w`` of shape ``(in, out)``, taken from the
``MLPPolicy`` (``policy_tree``) and written back into it at the end
(``write_policy``). Its flat vector follows ``jax.tree_util``'s order,
dict keys sorted: ``log_std``, then each layer's ``b`` before its ``w``, so
flat vectors compare element by element with the reference's. Gradients
are ``torch.func`` transforms of functions of that tree; ``fisher_vp`` is
forward over reverse (``jvp`` of ``grad``), as the reference's.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, Tuple

import torch
from torch.func import grad, jvp

from repro_torch.algos import gae as gae_mod
from repro_torch.models.mlp_policy import MLPPolicy, gaussian_logp


@dataclasses.dataclass(frozen=True)
class TRPOConfig:
    max_kl: float = 0.01
    cg_iters: int = 10
    cg_damping: float = 0.1
    backtrack_coef: float = 0.8
    backtrack_iters: int = 10
    gamma: float = 0.99
    lam: float = 0.95
    vf_lr: float = 1e-3
    vf_steps: int = 25


# ------------------------------------------------------------ params tree
def _net_tree(net) -> List[Dict[str, torch.Tensor]]:
    return [{"w": lyr.weight.detach().T, "b": lyr.bias.detach()}
            for lyr in net]


def policy_tree(policy: MLPPolicy) -> Dict[str, Any]:
    """The policy's ``{"pi", "log_std"}`` and value ``vf`` as the
    reference's tree of detached tensors (``w`` a transposed view)."""
    return {"pi": _net_tree(policy.pi), "log_std": policy.log_std.detach(),
            "vf": _net_tree(policy.vf)}


def write_policy(policy: MLPPolicy, tree: Dict[str, Any]) -> None:
    """Copy a reference-layout tree into the policy's parameters."""
    with torch.no_grad():
        policy.log_std.copy_(tree["log_std"])
        for key in ("pi", "vf"):
            for lyr, p in zip(getattr(policy, key), tree[key]):
                lyr.weight.copy_(p["w"].T)
                lyr.bias.copy_(p["b"])


def mlp_apply(layers, x: torch.Tensor) -> torch.Tensor:
    """The reference's ``mlp_apply``: ``x @ w + b``, tanh between."""
    for i, lyr in enumerate(layers):
        x = x @ lyr["w"] + lyr["b"]
        if i < len(layers) - 1:
            x = torch.tanh(x)
    return x


# ----------------------------------------------------------- flat helpers
def _leaves(pi_params) -> List[torch.Tensor]:
    """``jax.tree_util``'s order, dict keys sorted: ``log_std``, then each
    layer's ``b`` before its ``w``."""
    return [pi_params["log_std"]] + [x for lyr in pi_params["pi"]
                                     for x in (lyr["b"], lyr["w"])]


def _flatten(pi_params) -> Tuple[torch.Tensor, List[Tuple[int, ...]]]:
    leaves = _leaves(pi_params)
    return (torch.cat([x.reshape(-1) for x in leaves]),
            [tuple(x.shape) for x in leaves])


def _unflatten(flat: torch.Tensor, shapes) -> Dict[str, Any]:
    out, i = [], 0
    for shape in shapes:
        size = math.prod(shape)
        out.append(flat[i:i + size].reshape(shape))
        i += size
    return {"log_std": out[0],
            "pi": [{"b": b, "w": w} for b, w in zip(out[1::2], out[2::2])]}


# -------------------------------------------------------------- objective
def _dist(pi_params, obs) -> Tuple[torch.Tensor, torch.Tensor]:
    mean = mlp_apply(pi_params["pi"], obs)
    std = torch.exp(pi_params["log_std"])
    return mean, std.expand_as(mean)


def surrogate(pi_params, batch) -> torch.Tensor:
    logp = gaussian_logp(*_dist(pi_params, batch["obs"]), batch["actions"])
    ratio = torch.exp(logp - batch["behavior_logp"])
    return torch.mean(ratio * batch["advantages"])


def mean_kl(pi_params, old_mean, old_std, obs) -> torch.Tensor:
    """KL(old || new) for diagonal Gaussians, averaged over the batch."""
    mean, std = _dist(pi_params, obs)
    kl = (torch.log(std / old_std)
          + (old_std ** 2 + (old_mean - mean) ** 2) / (2 * std ** 2) - 0.5)
    return torch.mean(torch.sum(kl, dim=-1))


def fisher_vp(pi_params, obs, old_mean, old_std, vec, meta, damping):
    """``(H_KL + damping I) @ vec`` as a jvp of the grad (Pearlmutter)."""

    def kl_flat(flat):
        return mean_kl(_unflatten(flat, meta), old_mean, old_std, obs)

    flat0, _ = _flatten(pi_params)
    _, hvp = jvp(grad(kl_flat), (flat0,), (vec,))
    return hvp + damping * vec


def conjugate_gradient(avp, b: torch.Tensor, iters: int) -> torch.Tensor:
    x = torch.zeros_like(b)
    r, p = b, b
    rs = torch.dot(r, r)
    for _ in range(iters):
        ap = avp(p)
        alpha = rs / (torch.dot(p, ap) + 1e-10)
        x = x + alpha * p
        r = r - alpha * ap
        rs_new = torch.dot(r, r)
        p = r + (rs_new / (rs + 1e-10)) * p
        rs = rs_new
    return x


# ----------------------------------------------------------------- update
def _vf_loss(vf, batch) -> torch.Tensor:
    return torch.mean((mlp_apply(vf, batch["obs"])[..., 0]
                       - batch["returns"]) ** 2)


def trpo_update(policy: MLPPolicy, batch: Dict[str, torch.Tensor],
                cfg: TRPOConfig) -> Tuple[MLPPolicy, Dict]:
    """One TRPO policy step (+ vf regression), in place on ``policy``.
    batch: flat (N, ...) tensors obs/actions/behavior_logp/advantages/
    returns."""
    tree = policy_tree(policy)
    pi_params = {"pi": tree["pi"], "log_std": tree["log_std"]}
    obs = batch["obs"]
    old_mean, old_std = _dist(pi_params, obs)

    flat0, meta = _flatten(pi_params)
    g, _ = _flatten(grad(surrogate)(pi_params, batch))

    def avp(v):
        return fisher_vp(pi_params, obs, old_mean, old_std, v, meta,
                         cfg.cg_damping)

    step_dir = conjugate_gradient(avp, g, cfg.cg_iters)
    shs = torch.dot(step_dir, avp(step_dir))
    # the numerator is a tensor: a Python scalar over a tensor would be a
    # reciprocal multiply in torch, a true division in the reference
    step_scale = torch.sqrt(torch.full_like(shs, 2 * cfg.max_kl)
                            / torch.clamp(shs, min=1e-10))
    full_step = step_scale * step_dir
    base_surr = surrogate(pi_params, batch)

    def try_step(coef):
        cand = _unflatten(flat0 + coef * full_step, meta)
        return (surrogate(cand, batch),
                mean_kl(cand, old_mean, old_std, obs))

    # backtracking line search on the device: evaluate the backtracked
    # coefficients in order and keep the first that improves the surrogate
    # within the trust region
    coef = torch.ones((), device=flat0.device)
    accepted = torch.zeros((), device=flat0.device)
    found = torch.zeros((), dtype=torch.bool, device=flat0.device)
    for _ in range(cfg.backtrack_iters):
        surr, kl = try_step(coef)
        ok = (surr > base_surr) & (kl <= 1.5 * cfg.max_kl)
        accepted = torch.where(ok & ~found, coef, accepted)
        found = found | ok
        coef = coef * cfg.backtrack_coef
    new_pi = _unflatten(flat0 + accepted * full_step, meta)

    # value-function regression: plain gradient descent, as the reference
    vf = tree["vf"]
    vf_grad = grad(_vf_loss)
    for _ in range(cfg.vf_steps):
        vg = vf_grad(vf, batch)
        vf = [{k: p[k] - cfg.vf_lr * g[k] for k in p}
              for p, g in zip(vf, vg)]

    write_policy(policy, {"pi": new_pi["pi"],
                          "log_std": new_pi["log_std"], "vf": vf})
    surr, kl = try_step(accepted)
    metrics = {"surrogate_gain": surr - base_surr, "kl": kl,
               "step_coef": accepted}
    return policy, metrics


def make_trpo_learner(cfg: TRPOConfig):
    """``learn(policy, opt_state, traj) -> (policy, opt_state, metrics)``
    on ``(T, B, ...)`` trajectories, as PPO's learner: GAE through the
    kernel plane, normalised advantages, one ``trpo_update``."""

    def learn(policy, opt_state, traj: Dict[str, torch.Tensor]):
        adv, ret = gae_mod.gae(traj["rewards"], traj["values"],
                               traj["dones"], traj["last_value"],
                               cfg.gamma, cfg.lam)
        obs, actions = traj["obs"], traj["actions"]
        batch = {
            "obs": obs.reshape((-1,) + tuple(obs.shape[2:])),
            "actions": actions.reshape((-1,) + tuple(actions.shape[2:])),
            "behavior_logp": traj["logp"].reshape(-1),
            "advantages": gae_mod.normalize(adv).reshape(-1),
            "returns": ret.reshape(-1),
        }
        policy, metrics = trpo_update(policy, batch, cfg)
        return policy, opt_state, metrics

    return learn
