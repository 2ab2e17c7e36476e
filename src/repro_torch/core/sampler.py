"""Rollout samplers, WALL-E's N parallel sampler processors (port of the
env sampler, the LM sampler and ``WorkerSpec`` of
``repro/core/sampler.py``).

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

import copy
import dataclasses
from typing import Any, Callable, Dict, List, NamedTuple, Optional, Sequence

import numpy as np
import torch

from repro_torch.envs.base import auto_reset_batch
from repro_torch.models import transformer
from repro_torch.serve import sampling


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


# ====================================================== sharded form
class ShardedCarry(NamedTuple):
    """The sharded backend's carry: the N samplers' generators and batch
    sizes (sampler order), and each shard's slice of the global env batch
    (``states[s]``, ``obs[s]``, on mesh device ``s``)."""
    generators: List[torch.Generator]
    batches: List[int]
    states: List[Any]
    obs: List[torch.Tensor]


def shard_carries(carries: Sequence[Any], mesh) -> ShardedCarry:
    """N samplers' carries ``(env_state, obs, generator)`` as one global
    env batch in sampler order, split into ``len(mesh)`` contiguous shard
    slices, each moved to its device."""
    d = len(mesh)
    batches = [c[1].shape[0] for c in carries]
    total = sum(batches)
    if total % d:
        raise ValueError(f"sharded backend: global env batch {total} not "
                         f"divisible by mesh data axis {d}")
    states = [torch.cat(leaves) for leaves in zip(*(c[0] for c in carries))]
    obs = torch.cat([c[1] for c in carries])
    per = total // d
    return ShardedCarry(
        [c[2] for c in carries], batches,
        [tuple(x[s * per:(s + 1) * per].to(mesh[s]) for x in states)
         for s in range(d)],
        [obs[s * per:(s + 1) * per].to(mesh[s]) for s in range(d)])


def _pieces(batches: Sequence[int], d: int) -> List[List[tuple]]:
    """Shard ``s``'s rows of the global batch as ``(sampler, lo, hi)``
    pieces, in order."""
    per = sum(batches) // d
    starts = np.cumsum([0] + list(batches))
    out = []
    for s in range(d):
        lo, hi = s * per, (s + 1) * per
        out.append([(i, max(lo, starts[i]) - starts[i],
                     min(hi, starts[i + 1]) - starts[i])
                    for i in range(len(batches))
                    if starts[i] < hi and starts[i + 1] > lo])
    return out


def make_sharded_rollout(env, horizon: int, mesh,
                         hooks: Any = MLPPolicyHooks) -> Callable:
    """One WALL-E sampler per mesh slice (the reference's ``shard_map``
    form): ``sharded(params, carry, draws=None) -> (carry', traj)`` over a
    ``ShardedCarry`` (``shard_carries``), one shard per entry of ``mesh``
    (a list of devices, which may repeat one). The reference's
    ``data_axes`` named the axis of its ``shard_map`` specs; the port has
    no specs, so it has no such argument.

    ``hooks`` are the acting hooks (an algorithm; default: the
    Gaussian-MLP policy's, ``make_env_rollout``'s). The reference's carry
    holds a key per env, so any split of the batch draws the same numbers;
    the port's holds one generator per sampler, so each step

    1. draws every sampler's action noise and reset candidates from that
       sampler's own generator, in sampler order, with exactly the shapes
       the inline rollout draws;
    2. gives each shard its contiguous slice of the global batch;
    3. runs the act and the env step (one kernel launch on the card) once
       per shard, on the shard's device and its current stream, all shards
       issued from the calling thread in lockstep (no collective runs, so
       no shard threads).

    ``draws`` replaces step 1 with ``horizon`` triples ``(action_noise,
    reset_state, reset_obs)`` over the global batch, as
    ``make_rollout_step`` takes them (tests feed the reference's draws).

    Where each shard holds whole samplers' batches the act sees the rows
    the inline rollout gives it, so the trajectory is the inline backend's
    bit for bit where each shard holds one sampler's batch; elsewhere a
    matmul over more rows may round otherwise. ``traj`` comes back
    concatenated on the batch axis on the first mesh device: dim 1 of the
    step rows, dim 0 of the leaves ``hooks.rollout_tail`` adds."""
    step = make_rollout_step(hooks, env.batch_step)
    devices = [torch.device(dv) for dv in mesh]
    d = len(devices)

    def cat(xs):
        return xs[0] if len(xs) == 1 else torch.cat(xs)

    def sharded(params, carry: ShardedCarry, draws=None):
        batches = carry.batches if draws is None else [sum(carry.batches)]
        pieces = _pieces(batches, d)
        device0 = carry.obs[0].device
        # the policy broadcast: a copy of the params on each other device
        home = next(params.parameters()).device
        copies = {dv: params if dv == home else copy.deepcopy(params).to(dv)
                  for dv in set(devices)}
        states, obs = list(carry.states), list(carry.obs)
        rows = [[] for _ in range(d)]
        with torch.no_grad():
            for t in range(horizon):
                if draws is None:
                    drawn = []
                    for g, b in zip(carry.generators, carry.batches):
                        noise = torch.randn((b, env.act_dim), generator=g,
                                            device=g.device)
                        drawn.append((noise,) + env.reset(g, b, g.device))
                else:
                    drawn = [draws[t]]
                for s, dv in enumerate(devices):
                    part = [(drawn[i][0][lo:hi], tuple(
                        x[lo:hi] for x in drawn[i][1]), drawn[i][2][lo:hi])
                        for i, lo, hi in pieces[s]]
                    noise = cat([p[0] for p in part]).to(dv)
                    rs = tuple(cat(list(xs)).to(dv)
                               for xs in zip(*(p[1] for p in part)))
                    ro = cat([p[2] for p in part]).to(dv)
                    states[s], obs[s], out = step(copies[dv], states[s],
                                                  obs[s], noise, rs, ro)
                    rows[s].append(out)
            tails = [hooks.rollout_tail(copies[dv], obs[s])
                     for s, dv in enumerate(devices)]
        traj = {k: torch.cat([torch.stack([r[k] for r in rows[s]]).to(device0)
                              for s in range(d)], dim=1)
                for k in rows[0][0]}
        traj.update({k: torch.cat([t[k].to(device0) for t in tails])
                     for k in tails[0]})
        return carry._replace(states=states, obs=obs), traj

    return sharded


# ============================================================== LM sampler
def make_lm_rollout(cfg, lmenv, gen_len: int) -> Callable:
    """Sequence-policy sampler: prefill the prompt, then decode ``gen_len``
    tokens (the experience-collection inner loop), scored by the token
    reward model (``lmenv.token_rewards``).

    ``rollout(params, prompt, *, generator=None, gumbel=None)`` returns
    ``tokens``, ``logp`` (each token's behaviour log-prob), ``rewards`` and
    ``prompt``, each ``(B, T)`` batch-major as the reference's. A token is
    ``argmax(logits + g)``, which is how ``jax.random.categorical`` draws:
    ``g`` is Gumbel noise from ``generator``, or step ``t``'s row
    ``gumbel[t]`` of an injected ``(gen_len, B, V)`` tensor (the tests
    inject the reference's). The loop runs under ``torch.inference_mode``
    with the decode state updated in place, and the kernels follow the
    process-global mode, as serving does; the outputs are cloned out of
    inference mode, so a train step can take them."""

    def rollout(params, prompt: torch.Tensor, *,
                generator: Optional[torch.Generator] = None,
                gumbel: Optional[torch.Tensor] = None
                ) -> Dict[str, torch.Tensor]:
        if gumbel is None and generator is None:
            raise ValueError("make_lm_rollout: pass a generator or the "
                             "gumbel noise")
        draw = sampling.gumbel_source(generator) if gumbel is None else None
        with torch.inference_mode():
            state, logits = transformer.prefill(cfg, params, prompt,
                                                gen_budget=gen_len)
            toks, logps = [], []
            for t in range(gen_len):
                g = (draw(tuple(logits.shape)) if draw is not None
                     else gumbel[t].to(logits.device))
                tok = torch.argmax(logits + g, dim=-1)
                logps.append(torch.gather(torch.log_softmax(logits, -1),
                                          -1, tok[:, None])[:, 0])
                toks.append(tok)
                state, logits = transformer.decode_step(cfg, params, state,
                                                        tok[:, None])
            tokens = torch.stack(toks, dim=1)               # (B, T)
            traj = {"tokens": tokens, "logp": torch.stack(logps, dim=1),
                    "rewards": lmenv.token_rewards(tokens),
                    "prompt": prompt}
        return {k: v.clone() for k, v in traj.items()}

    return rollout


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
