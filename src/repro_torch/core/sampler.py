"""Rollout samplers, WALL-E's N parallel sampler processors (port of the
env sampler and ``WorkerSpec`` of ``repro/core/sampler.py``).

``make_algo_rollout`` acts through an algorithm's hooks; ``make_env_rollout``
is the reference's PPO-family rollout, the same loop acting through
``MLPPolicyHooks`` (the Gaussian-MLP policy's sample and value).

One sampler sweeps a batched env ``horizon`` steps under the current policy.
The reference's ``lax.scan`` becomes a Python loop and its per-instance
``vmap`` a written-out batch dimension. Each sampler's carry holds its own
``torch.Generator`` (sampler i seeded ``seed + i``), from which the loop
draws the action noise and the reset candidates of every step; the step
body also runs on injected noise and candidates, which tests use.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict

import numpy as np
import torch

from repro_torch.envs.base import auto_reset_batch


def batched_step(env) -> Callable:
    """``step(state, actions, generator) -> (state', obs, rewards, dones)``:
    the batched step + auto-reset the rollout loop takes
    (``auto_reset_batch``). The reference looks up a ``VectorEnv``'s own
    step here; in the port every env is batched, so both collection modes
    take this one."""
    return auto_reset_batch(env)


def init_env_carry(env, seed: int, batch: int, device):
    """``(env_state, obs, generator)`` for ``batch`` fresh instances, with
    the sampler's generator seeded ``seed`` on ``device``."""
    generator = torch.Generator(device=device)
    generator.manual_seed(int(seed))
    state, obs = env.reset(generator, batch, device)
    return state, obs, generator


def make_rollout_step(algo, env_step: Callable) -> Callable:
    """The body of one rollout step:

        step(params, env_state, obs, action_noise, *env_args)
            -> (env_state', obs', out)

    ``algo.act`` turns the noise into actions (+ per-step extras such as
    the behaviour logp and values), then ``env_step(env_state, actions,
    *env_args)`` takes the fused env step; off-policy algorithms
    (``algo.needs_next_obs``) also get ``next_obs`` recorded (the
    post-reset obs where an episode ended, as in the reference). With
    ``env.batch_step`` the env args are the reset candidates
    ``(reset_state, reset_obs)`` and the step is pure, so tests inject
    both; the rollout loop passes
    ``batched_step(env)``, whose one arg is the generator the candidates
    are drawn from. ``out`` holds this step's trajectory row."""

    needs_next_obs = algo.needs_next_obs

    def step(params, env_state, obs, action_noise, *env_args):
        actions, extras = algo.act(params, obs, action_noise)
        env_state2, obs2, rewards, dones = env_step(env_state, actions,
                                                    *env_args)
        out = {"obs": obs, "actions": actions, "rewards": rewards,
               "dones": dones, **extras}
        if needs_next_obs:
            out["next_obs"] = obs2
        return env_state2, obs2, out

    return step


def make_algo_rollout(algo, env, horizon: int) -> Callable:
    """Build ``rollout(params, carry) -> (carry', traj)``.

    Per step the loop draws the action noise from the carry's generator,
    then ``batched_step`` draws one batch of reset candidates from it and
    steps the env. ``traj`` tensors are time-major ``(T, B, ...)``;
    ``algo.rollout_tail`` adds end-of-rollout values (the GAE bootstrap
    ``last_value``)."""
    step = make_rollout_step(algo, batched_step(env))

    def rollout(params, carry):
        env_state, obs, generator = carry
        B, device = obs.shape[0], obs.device
        rows = []
        with torch.no_grad():
            for _ in range(horizon):
                noise = torch.randn((B, env.act_dim), generator=generator,
                                    device=device)
                env_state, obs, out = step(params, env_state, obs, noise,
                                           generator)
                rows.append(out)
            traj = {k: torch.stack([r[k] for r in rows]) for k in rows[0]}
            traj.update(algo.rollout_tail(params, obs))
        return (env_state, obs, generator), traj

    return rollout


class MLPPolicyHooks:
    """The acting hooks of the paper's Gaussian-MLP policy (an
    ``MLPPolicy`` as params): the reference's ``make_env_rollout`` body
    samples ``mean + std * noise`` and records its logp and the value, then
    bootstraps ``last_value`` from the final obs. The PPO and TRPO
    algorithms act through these hooks too."""

    needs_next_obs = False

    @staticmethod
    def act(params, obs, noise):
        action, logp = params.sample_action(obs, noise)
        return action, {"logp": logp, "values": params.value(obs)}

    @staticmethod
    def rollout_tail(params, final_obs):
        return {"last_value": params.value(final_obs)}


def make_env_rollout(env, horizon: int) -> Callable:
    """``rollout(params, carry) -> (carry', traj)`` of the Gaussian-MLP
    policy ``params`` (the reference's ``make_env_rollout``): traj holds
    ``obs``, ``actions``, ``rewards``, ``dones``, ``logp`` and ``values``
    ``(T, B, ...)`` and ``last_value`` ``(B,)``. Its step body is
    ``make_rollout_step(MLPPolicyHooks, ...)``."""
    return make_algo_rollout(MLPPolicyHooks, env, horizon)


@dataclasses.dataclass(frozen=True)
class WorkerSpec:
    """Everything a fresh process needs to become one rollout worker.

    Plain data only (registry names, JSON-safe kwargs, a device string), so
    the spec pickles across a ``spawn`` boundary and the worker rebuilds its
    env, algorithm, rollout and carry through the registry (``build``); no
    closure, module or tensor crosses. ``seed`` is the per-worker seed (the
    parent passes ``schedule.seed + i``), so worker i's carry is the carry
    ``experiment.build`` makes for sampler i: the root of the ``process ==
    inline`` rule.

    ``device`` is the run's device. The reference pins its workers to the
    CPU, since a TPU cannot be shared across processes; a CUDA device can
    be, so the port's workers act on the card unless the run is on the
    CPU. A worker never moves to the CPU on its own: with ``cuda`` and no
    card, ``build`` raises.
    """
    env: str
    algo: str
    horizon: int
    batch: int                      # per-worker env batch
    seed: int                       # per-worker: schedule.seed + worker_id
    kernels: str = "auto"
    env_kwargs: Dict[str, Any] = dataclasses.field(default_factory=dict)
    algo_kwargs: Dict[str, Any] = dataclasses.field(default_factory=dict)
    device: str = "cuda"

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "WorkerSpec":
        return cls(**d)

    def _env_algo(self):
        from repro_torch import registry
        return (registry.make("env", self.env, **dict(self.env_kwargs)),
                registry.make("algo", self.algo, **dict(self.algo_kwargs)))

    def build(self):
        """``(rollout, carry, params_template)`` in this process, on
        ``device``, after setting the spec's kernel mode. The template is a
        freshly drawn params module whose structure (not values) takes the
        leaves a ``ParamsChannel`` carries."""
        from repro_torch import kernels
        kernels.set_kernel_mode(self.kernels)
        env, algo = self._env_algo()
        rollout = algo.make_rollout(env, self.horizon)
        carry = init_env_carry(env, self.seed, self.batch, self.device)
        params, _ = algo.init(torch.Generator().manual_seed(self.seed), env,
                              self.device)
        return rollout, carry, params

    def traj_example(self) -> Dict[str, np.ndarray]:
        """Zeroed numpy arrays shaped like one rollout's trajectory: each
        leaf's dtype and trailing shape come from a rollout of horizon 1
        over one env on the CPU, scaled to ``(horizon, batch)`` (``(batch,)``
        for the algorithm's ``tail_keys``). Sizes the shared-memory ring
        without a rollout on the device."""
        env, algo = self._env_algo()
        params, _ = algo.init(torch.Generator().manual_seed(self.seed), env,
                              "cpu")
        _, traj = algo.make_rollout(env, 1)(
            params, init_env_carry(env, self.seed, 1, "cpu"))
        out = {}
        for k, v in traj.items():
            lead = ((self.batch,) if k in algo.tail_keys
                    else (self.horizon, self.batch))
            out[k] = np.zeros(lead + tuple(v.shape[len(lead):]),
                              dtype=v.numpy().dtype)
        return out


def split_batch(global_batch: int, num_samplers: int) -> int:
    """Per-sampler env batch (the paper divides 20000 samples across N).
    Raises ``ValueError`` when the split is not exact."""
    if num_samplers < 1:
        raise ValueError(f"num_samplers={num_samplers} must be >= 1")
    if global_batch < 1:
        raise ValueError(f"global_batch={global_batch} must be >= 1")
    if global_batch % num_samplers != 0:
        lower = (global_batch // num_samplers) * num_samplers
        upper = lower + num_samplers
        raise ValueError(
            f"global_batch={global_batch} is not divisible by "
            f"num_samplers={num_samplers}; every sampler must get an "
            f"equal env batch — adjust global_batch (nearest multiples: "
            + (f"{lower} or {upper}" if lower >= num_samplers
               else f"{upper}") + ")")
    return global_batch // num_samplers
