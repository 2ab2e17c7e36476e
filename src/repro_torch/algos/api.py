"""The ``Algorithm`` seam between learners and the runtime (port of
``repro/algos/api.py``: PPO, TRPO, DDPG and SAC).

An algorithm provides ``init(generator, env, device) -> (params,
opt_state)``, ``learn(params, opt_state, batch) -> (params, opt_state,
metrics)`` and ``act(params, obs, noise) -> (action, extras)``, where
``noise`` is the standard-normal draw that stands in for the reference's
PRNG key. ``make_train_step`` composes it with a buffer into the step the
runner drives. Off-policy algorithms (``OffPolicyAlgorithm``) record
``next_obs``, learn from replay minibatches, and draw the learner noise
they name in ``learner_noise`` from the plane's generator.
"""
from __future__ import annotations

from typing import (Any, Callable, Dict, List, Protocol, Tuple,
                    runtime_checkable)

import torch

from repro_torch import registry
from repro_torch.algos.ddpg import (
    DDPGConfig,
    ddpg_update,
    explore_action,
    init_ddpg,
)
from repro_torch.algos.ppo import PPOConfig, make_mlp_learner, mean_metrics
from repro_torch.algos.staleness import (
    GAP_KEY,
    STALENESS_OFF,
    WEIGHT_KEY,
    StalenessConfig,
    decay_weights,
)
from repro_torch.algos.trpo import TRPOConfig, make_trpo_learner
from repro_torch.core import sampler as sampler_mod
from repro_torch.models import mlp_policy
from repro_torch.optim import adam


@runtime_checkable
class Algorithm(Protocol):
    """What a learner must provide to ride the unified runtime."""

    name: str

    def init(self, generator: torch.Generator, env, device
             ) -> Tuple[Any, Any]:
        """Build ``(params, opt_state)`` for ``env`` on ``device``."""
        ...

    def learn(self, params, opt_state, batch) -> Tuple[Any, Any, Dict]:
        """One update from a sampled batch."""
        ...

    def act(self, params, obs: torch.Tensor, noise: torch.Tensor
            ) -> Tuple[torch.Tensor, Dict]:
        """Actions (+ per-step extras) for a batch of observations."""
        ...


class AlgorithmBase:
    """Default runtime + experience-plane hooks shared by the adapters."""

    name = "base"
    on_policy = True
    needs_next_obs = False
    default_buffer = "fifo"
    updates_per_collect = 1
    # trajectory leaves that hold one row per env, not (T, B) ones
    tail_keys: Tuple[str, ...] = ()
    # safe in the data-parallel learner (distributed/learner.py): every
    # gradient of ``learn`` goes through ``grad_sync.value_and_grad`` (TRPO's
    # conjugate-gradient and line-search gradients do not, so it opts out)
    shardable = True
    # importance-weighted staleness correction (algos/staleness.py): off
    # unless the experiment enables it through ``enable_staleness``
    supports_staleness = False
    staleness: StalenessConfig = STALENESS_OFF

    def enable_staleness(self, cfg) -> None:
        """Install a staleness-correction config (mode string, dict or
        ``StalenessConfig``). A disabled config is always accepted; an
        enabled one needs ``supports_staleness``."""
        cfg = StalenessConfig.parse(cfg)
        if cfg.enabled and not self.supports_staleness:
            raise ValueError(
                f"algorithm {self.name!r} does not support staleness "
                f"correction (supports_staleness=False): its update has "
                f"no importance-weighting seam; use staleness mode 'off' "
                f"or a supporting algorithm (ppo, ddpg, sac)")
        self.staleness = cfg

    def make_rollout(self, env, horizon: int):
        return sampler_mod.make_algo_rollout(self, env, horizon)

    def opt_groups(self, params) -> List[Any]:
        """The parameter groups ``init``'s optimizer states follow, in the
        states' order (a module, or a list of the params' tensors): one
        state, over all of ``params``. The FSDP learner lays each state's
        moments out as its group's params."""
        return [params]

    def rollout_tail(self, params, final_obs) -> Dict[str, torch.Tensor]:
        return {}

    def observe(self, buffer, state, traj):
        """Push one collected trajectory into the buffer."""
        return buffer.add(state, traj)

    def sample(self, buffer, state, generator):
        """Draw one learner batch from the buffer."""
        return buffer.sample(state, generator)


class OffPolicyAlgorithm(AlgorithmBase):
    """Shared plane wiring for replay-based learners: full transitions
    (``next_obs``) recorded at collect time, the transition schema buffers
    allocate, and the learner noise drawn with each sampled batch (the
    keys in ``learner_noise``; none for DDPG).

    Staleness correction, when enabled: ``observe`` turns the
    trajectory's params-version gap into a per-transition weight
    (``staleness_w``), stored beside the transition, and ``sample``
    multiplies it into the buffer's importance weights, which the DDPG and
    SAC critic losses honour. Disabled, no such key exists."""

    on_policy = False
    needs_next_obs = True
    default_buffer = "uniform"
    updates_per_collect = 4
    learner_noise: Tuple[str, ...] = ()
    supports_staleness = True

    def transition_example(self, env, device) -> Dict[str, torch.Tensor]:
        """One zeroed transition on ``device``: the storage schema."""
        def zeros(*shape, dtype=torch.float32):
            return torch.zeros(shape, dtype=dtype, device=device)

        ex = {"obs": zeros(1, env.obs_dim),
              "actions": zeros(1, env.act_dim),
              "rewards": zeros(1),
              "next_obs": zeros(1, env.obs_dim),
              "dones": zeros(1, dtype=torch.bool)}
        if self.staleness.enabled:
            ex[WEIGHT_KEY] = zeros(1)
        return ex

    def observe(self, buffer, state, traj):
        if self.staleness.enabled:
            traj = dict(traj)
            gap = traj.pop(GAP_KEY, None)
            traj[WEIGHT_KEY] = (
                torch.ones_like(traj["rewards"], dtype=torch.float32)
                if gap is None           # lock-step paths record no gap
                else decay_weights(self.staleness, gap))
        return buffer.add(state, traj)

    def sample(self, buffer, state, generator):
        """The buffer's batch (its ``staleness_w`` folded into
        ``weights``), then one standard-normal (B, act_dim) draw per key of
        ``learner_noise``, from ``generator`` after the buffer's draws (the
        reference passes a key as ``batch["rng"]``)."""
        batch = buffer.sample(state, generator)
        if WEIGHT_KEY in batch:
            sw = batch.pop(WEIGHT_KEY)
            batch["weights"] = batch.get("weights", 1.0) * sw
        shape = tuple(batch["actions"].shape)
        for k in self.learner_noise:
            batch[k] = torch.randn(shape, generator=generator,
                                   device=generator.device)
        return batch


def make_train_step(algo, buffer) -> Callable:
    """``step(params, opt_state, plane, traj) -> (params, opt_state, plane,
    metrics)`` with ``plane = (buffer_state, generator)`` owned by the
    runner.

    Per call: observe the trajectory, then ``algo.updates_per_collect``
    sample -> learn steps; a learner that reports per-sample
    ``priorities`` gets them routed into ``buffer.update_priorities``.
    Metrics are averaged over the updates and stay on the device. PPO is
    the one-update case: the ``fifo`` buffer hands back the trajectory,
    so the step is ``learn(params, opt_state, traj)``."""
    updates = int(getattr(algo, "updates_per_collect", 1))

    def step(params, opt_state, plane, traj):
        buf_state, generator = plane
        buf_state = algo.observe(buffer, buf_state, traj)
        ms = []
        for _ in range(updates):
            batch = algo.sample(buffer, buf_state, generator)
            params, opt_state, metrics = algo.learn(params, opt_state,
                                                    batch)
            metrics = dict(metrics)
            priorities = metrics.pop("priorities", None)
            if priorities is not None:
                buf_state = buffer.update_priorities(
                    buf_state, batch["indices"], priorities)
            ms.append(metrics)
        return params, opt_state, (buf_state, generator), mean_metrics(ms)

    return step


class GaussianMLPAlgorithm(sampler_mod.MLPPolicyHooks, AlgorithmBase):
    """Hooks shared by algorithms on the paper's Gaussian-MLP policy and
    value model: the params are one ``MLPPolicy`` module, acted with as
    the reference's ``make_env_rollout`` does (``MLPPolicyHooks``)."""

    hidden: int = 64
    tail_keys = ("last_value",)

    def _init_policy(self, generator, env, device):
        return mlp_policy.init_policy(generator, env.obs_dim, env.act_dim,
                                      hidden=self.hidden).to(device)


class PPOAlgorithm(GaussianMLPAlgorithm):
    """Clipped-surrogate PPO with the paper's Gaussian-MLP policy."""

    name = "ppo"
    supports_staleness = True

    def __init__(self, lr: float = 3e-4, hidden: int = 64, **cfg_kwargs):
        self.cfg = PPOConfig(lr=lr, **cfg_kwargs)
        self.hidden = hidden
        self._opt = adam(self.cfg.lr)
        self._learn = make_mlp_learner(self._opt, self.cfg)

    def enable_staleness(self, cfg) -> None:
        super().enable_staleness(cfg)
        if self.staleness.enabled:      # the weighted advantage path
            self._learn = make_mlp_learner(self._opt, self.cfg,
                                           staleness=self.staleness)

    def init(self, generator, env, device):
        """Params drawn from ``generator`` (a CPU generator, so a seed gives
        the same weights on every device), then moved to ``device``."""
        params = self._init_policy(generator, env, device)
        return params, self._opt.init(list(params.parameters()))

    def learn(self, params, opt_state, traj):
        return self._learn(params, opt_state, traj)


class TRPOAlgorithm(GaussianMLPAlgorithm):
    """Natural-gradient TRPO on the same policy and value model and
    trajectory layout as PPO, so it shares PPO's rollout. It keeps no
    optimizer state."""

    name = "trpo"
    shardable = False               # CG/line-search grads bypass grad_sync

    def __init__(self, lr: float = None, hidden: int = 64, **cfg_kwargs):
        if lr is not None:
            cfg_kwargs.setdefault("vf_lr", lr)
        self.cfg = TRPOConfig(**cfg_kwargs)
        self.hidden = hidden
        self._learn = make_trpo_learner(self.cfg)

    def init(self, generator, env, device):
        """Params drawn from ``generator`` (a CPU generator, so a seed gives
        the same weights on every device), then moved to ``device``."""
        return self._init_policy(generator, env, device), None

    def learn(self, params, opt_state, traj):
        return self._learn(params, opt_state, traj)


class DDPGAlgorithm(OffPolicyAlgorithm):
    """DDPG on the experience plane: the collect path records full
    transitions and each ``learn`` consumes one replay minibatch (uniform
    or prioritized, any ``n_step``). ``opt_state`` is the two Adam states
    (actor, critic)."""

    name = "ddpg"

    def __init__(self, lr: float = None, hidden: int = 64,
                 updates_per_collect: int = 4, **cfg_kwargs):
        if lr is not None:
            cfg_kwargs.setdefault("actor_lr", lr)
            cfg_kwargs.setdefault("critic_lr", lr)
        self.cfg = DDPGConfig(**cfg_kwargs)
        self.hidden = hidden
        self.updates_per_collect = updates_per_collect
        self._a_opt = adam(self.cfg.actor_lr)
        self._c_opt = adam(self.cfg.critic_lr)

    def init(self, generator, env, device):
        """Params drawn from ``generator`` (a CPU generator, so a seed gives
        the same weights on every device), then moved to ``device``."""
        params = init_ddpg(generator, env.obs_dim, env.act_dim,
                           hidden=self.hidden).to(device)
        return params, (self._a_opt.init(list(params.actor.parameters())),
                        self._c_opt.init(list(params.critic.parameters())))

    def opt_groups(self, params):
        return [params.actor, params.critic]

    def learn(self, params, opt_state, batch):
        return ddpg_update(params, opt_state, batch, self.cfg, self._a_opt,
                           self._c_opt)

    def act(self, params, obs, noise):
        return explore_action(params, obs, noise, self.cfg), {}


def _make_sac(**kwargs):
    # lazy, so that api <-> sac imports never cycle (sac subclasses
    # OffPolicyAlgorithm from this module)
    from repro_torch.algos.sac import SACAlgorithm
    return SACAlgorithm(**kwargs)


registry.register("algo", "ppo", PPOAlgorithm)
registry.register("algo", "trpo", TRPOAlgorithm)
registry.register("algo", "ddpg", DDPGAlgorithm)
registry.register("algo", "sac", _make_sac)
