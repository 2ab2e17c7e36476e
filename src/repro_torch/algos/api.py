"""The ``Algorithm`` seam between learners and the runtime (port of
``repro/algos/api.py``; PPO only, the other algorithms are in ROADMAP.md).

An algorithm provides ``init(generator, env, device) -> (params,
opt_state)``, ``learn(params, opt_state, batch) -> (params, opt_state,
metrics)`` and ``act(params, obs, noise) -> (action, extras)``, where
``noise`` is the standard-normal draw that stands in for the reference's
PRNG key. ``make_train_step`` composes it with a buffer into the step the
runner drives.
"""
from __future__ import annotations

from typing import Callable, Dict

import torch

from repro_torch import registry
from repro_torch.algos.ppo import PPOConfig, make_mlp_learner
from repro_torch.core import sampler as sampler_mod
from repro_torch.models import mlp_policy
from repro_torch.optim import adam


class AlgorithmBase:
    """Default runtime + experience-plane hooks shared by the adapters."""

    name = "base"
    default_buffer = "fifo"
    updates_per_collect = 1

    def make_rollout(self, env, horizon: int):
        return sampler_mod.make_algo_rollout(self, env, horizon)

    def rollout_tail(self, params, final_obs) -> Dict[str, torch.Tensor]:
        return {}

    def observe(self, buffer, state, traj):
        """Push one collected trajectory into the buffer."""
        return buffer.add(state, traj)

    def sample(self, buffer, state, generator):
        """Draw one learner batch from the buffer."""
        return buffer.sample(state, generator)


def make_train_step(algo, buffer) -> Callable:
    """``step(params, opt_state, plane, traj) -> (params, opt_state, plane,
    metrics)`` with ``plane = (buffer_state, generator)`` owned by the
    runner: observe the trajectory, sample, learn. Only the pass-through
    form (``fifo``, one update per collect) is ported."""
    if not (getattr(buffer, "passthrough", False)
            and int(getattr(algo, "updates_per_collect", 1)) == 1):
        raise NotImplementedError(
            "replay buffers and several updates per collect are not ported "
            "to repro_torch yet; see ROADMAP.md")

    def step(params, opt_state, plane, traj):
        buf_state, generator = plane
        buf_state = algo.observe(buffer, buf_state, traj)
        batch = algo.sample(buffer, buf_state, generator)
        params, opt_state, metrics = algo.learn(params, opt_state, batch)
        return params, opt_state, (buf_state, generator), metrics

    return step


class GaussianMLPAlgorithm(AlgorithmBase):
    """Hooks shared by algorithms on the paper's Gaussian-MLP policy and
    value model: the params are one ``MLPPolicy`` module."""

    hidden: int = 64

    def _init_policy(self, generator, env, device):
        return mlp_policy.init_policy(generator, env.obs_dim, env.act_dim,
                                      hidden=self.hidden).to(device)

    def act(self, params, obs, noise):
        action, logp = params.sample_action(obs, noise)
        return action, {"logp": logp, "values": params.value(obs)}

    def rollout_tail(self, params, final_obs):
        return {"last_value": params.value(final_obs)}


class PPOAlgorithm(GaussianMLPAlgorithm):
    """Clipped-surrogate PPO with the paper's Gaussian-MLP policy."""

    name = "ppo"

    def __init__(self, lr: float = 3e-4, hidden: int = 64, **cfg_kwargs):
        if "aux_coef" in cfg_kwargs:
            raise NotImplementedError(
                "aux_coef (the MoE router load-balance weight of the LM "
                "policy's PPO loss) is not ported to repro_torch yet; see "
                "ROADMAP.md")
        self.cfg = PPOConfig(lr=lr, **cfg_kwargs)
        self.hidden = hidden
        self._opt = adam(self.cfg.lr)
        self._learn = make_mlp_learner(self._opt, self.cfg)

    def init(self, generator, env, device):
        """Params drawn from ``generator`` (a CPU generator, so a seed gives
        the same weights on every device), then moved to ``device``."""
        params = self._init_policy(generator, env, device)
        return params, self._opt.init(list(params.parameters()))

    def learn(self, params, opt_state, traj):
        return self._learn(params, opt_state, traj)


registry.register("algo", "ppo", PPOAlgorithm)
