"""The fused engine on the CPU (``core/fused.py``), mirroring
``tests/test_fused.py``'s fused-parity cases, and the fused runtime of
``experiment`` and the train CLI.

On the CPU the engine runs each iteration eagerly over its static state
(the path a CUDA graph captures on the card), so every comparison with the
stepped loop is exact: the same ops on the same inputs. Against the JAX
package: ``make_env_rollout``'s step body with the reference's draws
injected (``rtol=1e-5, atol=2e-6``, the bound of the rollout-step parity
in ``test_torch_slice.py``: float32 sums in another order), and a spec
both packages reject.
"""
import dataclasses
import json
import math

import jax
import numpy as np
import pytest
import torch

from repro import envs as jax_envs
from repro import experiment as jax_experiment
from repro.core import sampler as jax_sampler
from repro.models import mlp_policy as jax_policy
from repro_torch import convert, envs, kernels
from repro_torch.algos.api import AlgorithmBase, make_train_step
from repro_torch.algos.ppo import PPOConfig, make_mlp_learner
from repro_torch.core import sampler
from repro_torch.core.fused import (
    FusedRunner,
    TrainState,
    make_fused_train_loop,
    state_tensors,
)
from repro_torch.data.buffers import FifoBuffer
from repro_torch.experiment import ExperimentSpec, Schedule, build, run
from repro_torch.launch import train
from repro_torch.models import mlp_policy
from repro_torch.optim import adam

HORIZON = 16
BATCH = 8


def _pieces(seed=0, hidden=32):
    env = envs.make("pendulum")
    params = mlp_policy.init_policy(torch.Generator().manual_seed(seed),
                                    env.obs_dim, env.act_dim, hidden)
    opt = adam(1e-3)
    learn = make_mlp_learner(opt, PPOConfig(epochs=2, minibatches=2))
    return env, params, opt, learn


def _carry(env, seed=1, batch=BATCH):
    return sampler.init_env_carry(env, seed, batch, "cpu")


def _fresh(seed=0):
    """A fused runner's inputs: pieces, their own params, Adam state and
    carry."""
    env, params, opt, learn = _pieces(seed)
    return env, learn, params, opt.init(list(params.parameters())), \
        _carry(env)


def _assert_equal(a, b):
    ta, tb = state_tensors(a), state_tensors(b)
    assert len(ta) == len(tb) > 0
    for x, y in zip(ta, tb):
        assert x.dtype == y.dtype and torch.equal(x, y)


# ============================================================ fused parity
def test_fused_matches_stepped_bitwise():
    """3 iterations on pendulum: the fused runner == the stepped loop
    (rollout, then learn), exact."""
    env, learn, params, opt_state, carry = _fresh()
    rollout = sampler.make_env_rollout(env, HORIZON)
    for _ in range(3):
        carry, traj = rollout(params, carry)
        params, opt_state, _ = learn(params, opt_state, traj)

    env, learn, f_params, f_opt, f_carry = _fresh()
    fused = FusedRunner(env, learn, f_params, f_opt, f_carry,
                        horizon=HORIZON)
    fused.run(3)
    _assert_equal(params, fused.params)
    _assert_equal(opt_state, fused.opt_state)
    _assert_equal(carry, fused.state.env_carry)
    assert int(fused.opt_state.step) == 3 * 2 * 2


def test_fused_chunking_invariant():
    """Running 4 iterations as 1 chunk or 2 + 2 gives identical params."""
    env, learn, *state = _fresh()
    one = FusedRunner(env, learn, *state, horizon=HORIZON, chunk=4)
    one.run(4)
    env, learn, *state = _fresh()
    two = FusedRunner(env, learn, *state, horizon=HORIZON, chunk=2)
    two.run(4)
    _assert_equal(one.params, two.params)
    _assert_equal(one.opt_state, two.opt_state)
    assert len(one.logs) == len(two.logs) == 4
    assert ([lg.mean_return for lg in one.logs]
            == [lg.mean_return for lg in two.logs])


def test_fused_loop_metrics_stacked():
    env, learn, params, opt_state, carry = _fresh()
    before = [p.detach().clone() for p in params.parameters()]
    loop = make_fused_train_loop(env, learn, HORIZON, chunk=3)
    state2, metrics = loop(TrainState(params, opt_state, carry))
    assert metrics["loss"].shape == (3,)
    assert metrics["mean_return"].shape == (3,)
    assert torch.isfinite(metrics["loss"]).all()
    # params actually changed, and the next chunk continues from them
    assert any(not torch.equal(a, b)
               for a, b in zip(before, state2.params.parameters()))
    state3, metrics = loop(state2)
    assert state3 is state2 and int(state3.opt_state.step) == 6 * 2 * 2
    assert metrics["loss"].shape == (3,)


def test_fused_runner_logs():
    env, learn, *state = _fresh()
    runner = FusedRunner(env, learn, *state, horizon=HORIZON)
    logs = runner.run(3)
    assert [lg.iteration for lg in logs] == [0, 1, 2]
    for lg in logs:
        assert lg.samples == BATCH * HORIZON
        assert lg.learn_time > 0
        assert lg.collect_time == lg.collect_time_serial == 0.0
    assert set(runner.last_metrics) >= {"loss", "mean_return"}
    assert runner.num_samplers == 1 and runner.graph_stats == {}


def test_learn_runs_as_the_train_step_of_a_fifo_plane():
    """The one iteration shape: a runner given ``learn`` equals one given
    ``make_train_step`` of an algorithm with that learner over the fifo
    buffer, exact."""
    env, learn, *state = _fresh()
    by_learn = FusedRunner(env, learn, *state, horizon=HORIZON, chunk=2)
    by_learn.run(3)
    algo = AlgorithmBase()
    algo.learn = learn
    env, _, *state = _fresh()
    by_step = FusedRunner(env, None, *state, horizon=HORIZON, chunk=2,
                          train_step=make_train_step(algo, FifoBuffer()),
                          plane_state=(None, None))
    by_step.run(3)
    _assert_equal(by_learn.params, by_step.params)
    _assert_equal(by_learn.opt_state, by_step.opt_state)
    assert ([lg.mean_return for lg in by_learn.logs]
            == [lg.mean_return for lg in by_step.logs])


def test_add_launches_adds_to_the_wrappers_counts():
    """What a CUDA-graph replay does to the counts (the capture's calls
    come back out as negative counts)."""
    kernels.reset_launch_counts()
    kernels.add_launches({"cheetah_step": 125, "gae": 1})
    kernels.add_launches({"cheetah_step": 125, "gae": 1})
    kernels.add_launches({"gae": -1})
    counts = kernels.launch_counts()
    assert counts["cheetah_step"] == 250 and counts["gae"] == 1
    assert sum(counts.values()) == 251
    kernels.reset_launch_counts()


def test_fused_runner_rejects_overlap_naming_the_roadmap():
    """The fused runtime over a learner mesh (here with overlap) waits
    for ROADMAP.md item 10f, D > 1 under the fused runtime: rejected by
    name."""
    spec = ExperimentSpec(env="pendulum", algo="ppo", runtime="fused",
                          schedule=Schedule(overlap=True, learner_devices=2))
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        build(spec, device="cpu")


# ===================================================== the fused runtime
def _plane_tensors(runner):
    return state_tensors(runner.plane_state[0]) if runner.plane_state \
        else []


SPECS = {
    "ppo pendulum": ExperimentSpec(env="pendulum", algo="ppo"),
    "ppo cheetah vector": ExperimentSpec(
        env="cheetah", algo="ppo",
        schedule=Schedule(env_batch=6, horizon=12, iterations=3)),
    "trpo cartpole": ExperimentSpec(env="cartpole", algo="trpo"),
    "ddpg pendulum uniform": ExperimentSpec(
        env="pendulum", algo="ddpg", buffer="uniform",
        buffer_kwargs={"capacity": 40, "batch_size": 8}),
    "sac cheetah prioritized": ExperimentSpec(
        env="cheetah", algo="sac", buffer="prioritized",
        buffer_kwargs={"capacity": 64, "batch_size": 8, "n_step": 2}),
}


def _spec(label, **change):
    spec = SPECS[label]
    if spec.schedule.env_batch is None:
        spec = dataclasses.replace(spec, schedule=Schedule(
            num_samplers=1, global_batch=6, horizon=12, iterations=3))
    spec = dataclasses.replace(spec, env_kwargs={"max_episode_steps": 5})
    return dataclasses.replace(spec, **change)


@pytest.mark.parametrize("label", list(SPECS))
def test_fused_runtime_matches_sync_runtime(label):
    """``runtime="fused"`` against ``runtime="sync"`` with one sampler of
    the whole batch (the carry the fused runtime builds): params, optimizer
    and plane state (ring storage, head, size, tree) and every iteration's
    mean return, exact."""
    stepped = run(_spec(label), device="cpu")
    fused = run(_spec(label, runtime="fused"), device="cpu")
    assert isinstance(fused.runner, FusedRunner)
    _assert_equal(stepped.params, fused.params)
    if stepped.runner.opt_state is not None:
        _assert_equal(stepped.runner.opt_state, fused.runner.opt_state)
    plane = _plane_tensors(stepped.runner)
    assert len(plane) == len(_plane_tensors(fused.runner))
    for a, b in zip(plane, _plane_tensors(fused.runner)):
        assert torch.equal(a, b)
    want = [lg.mean_return for lg in stepped.logs]
    assert [lg.mean_return for lg in fused.logs] == want
    assert any(r != 0.0 for r in want)
    assert all(lg.samples == stepped.logs[0].samples for lg in fused.logs)


def test_fused_sac_prioritized_chunks_and_stacked_metrics():
    """SAC on the prioritized buffer: 4 iterations as chunk 4 or 2 + 2
    give identical params and plane state; metrics come stacked (chunk,);
    the ring's head and size stay 0-dim tensors."""
    sched = dict(num_samplers=1, global_batch=6, horizon=12, iterations=4)
    one = run(_spec("sac cheetah prioritized", runtime="fused",
                    schedule=Schedule(chunk=4, **sched)), device="cpu")
    two = run(_spec("sac cheetah prioritized", runtime="fused",
                    schedule=Schedule(chunk=2, **sched)), device="cpu")
    _assert_equal(one.params, two.params)
    for a, b in zip(_plane_tensors(one.runner), _plane_tensors(two.runner)):
        assert torch.equal(a, b)
    assert one.runner.last_metrics["critic_loss"].shape == (4,)
    assert two.runner.last_metrics["critic_loss"].shape == (2,)
    ring = one.runner.buffer_state.ring
    added = 4 * 6 * 11             # 11 two-step windows of 12 steps, 6 envs
    assert ring.size.dim() == 0 and int(ring.size) == min(added, 64)
    assert int(ring.index) == added % 64
    assert [lg.iteration for lg in two.logs] == [0, 1, 2, 3]


def test_fused_with_a_backend_other_than_inline_raises_in_both():
    """A spec both packages reject: the fused runtime collects itself, so
    any backend but ``inline`` is a ``ValueError``."""
    spec = _spec("ppo pendulum", runtime="fused", backend="threaded")
    with pytest.raises(ValueError, match="inline"):
        build(spec, device="cpu")
    with pytest.raises(ValueError, match="inline"):
        jax_experiment.build(jax_experiment.ExperimentSpec.from_dict(
            spec.to_dict()))


def test_fused_runtime_needs_cpu_asked_for(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build(_spec("ppo pendulum", runtime="fused"))


def test_train_cli_backend_fused_chunk(capsys):
    result = train.main(["--env", "pendulum", "--algo", "ppo",
                         "--backend", "fused", "--chunk", "2",
                         "--global-batch", "4", "--horizon", "8",
                         "--iterations", "3", "--device", "cpu"])
    logs = [json.loads(line)
            for line in capsys.readouterr().out.strip().splitlines()]
    assert isinstance(result.runner, FusedRunner)
    assert result.spec.runtime == "fused" and result.spec.backend == "inline"
    assert result.runner.chunk == 2
    assert [lg["iteration"] for lg in logs] == [0, 1, 2]
    for lg in logs:
        assert lg["samples"] == 32 and lg["collect_time"] == 0.0
        assert math.isfinite(lg["mean_return"]) and lg["learn_time"] > 0
    assert set(logs[0]) == {
        f.name for f in dataclasses.fields(jax_experiment.IterationLog)}


# ================================================ make_env_rollout vs JAX
@pytest.mark.parametrize("name", ["pendulum", "cheetah"])
def test_env_rollout_step_body_matches_jax(name):
    """The reference's ``make_env_rollout`` over 3 steps, and the port's
    step body (``make_rollout_step(MLPPolicyHooks, env.batch_step)``) fed
    the same draws: each step's action noise and reset candidates are
    recomputed from the reference's keys. Every trajectory row, the final
    carry and ``last_value`` agree; the port's own ``make_env_rollout``
    gives a trajectory of the same keys and shapes."""
    B, T, horizon = 6, 3, 2
    jenv = jax_envs.make(name, max_episode_steps=horizon)
    params = jax_policy.init_policy(jax.random.PRNGKey(0), jenv.obs_dim,
                                    jenv.act_dim, hidden=32)
    carry = jax_sampler.init_env_carry(jenv, jax.random.PRNGKey(1), B)
    (jstate, jobs, _), jtraj = jax_sampler.make_env_rollout(jenv, T)(
        params, carry)

    def tt(x):
        return torch.from_numpy(np.array(x))

    env = envs.make(name, max_episode_steps=horizon)
    step = sampler.make_rollout_step(sampler.MLPPolicyHooks, env.batch_step)
    policy = convert.params_from_jax(jax.tree.map(np.asarray, params))
    state, obs, keys = tuple(map(tt, carry[0])), tt(carry[1]), carry[2]
    for t in range(T):
        splits = jax.vmap(lambda k: jax.random.split(k, 3))(keys)
        keys, ka, ke = splits[:, 0], splits[:, 1], splits[:, 2]
        noise = jax.vmap(lambda k: jax.random.normal(
            k, (jenv.act_dim,)))(ka)
        rstate, robs = jax.vmap(jenv.reset)(
            jax.vmap(lambda k: jax.random.split(k)[1])(ke))
        with torch.no_grad():
            state, obs, out = step(policy, state, obs, tt(noise),
                                   tuple(map(tt, rstate)), tt(robs))
        assert set(out) == set(jtraj) - {"last_value"}
        for k, v in out.items():
            w = np.asarray(jtraj[k][t])
            assert v.dtype == tt(w).dtype and v.shape == w.shape, k
            np.testing.assert_allclose(v.numpy(), w, rtol=1e-5, atol=2e-6,
                                       err_msg=f"{k} at step {t}")
    with torch.no_grad():
        tail = sampler.MLPPolicyHooks.rollout_tail(policy, obs)
    np.testing.assert_allclose(tail["last_value"].numpy(),
                               np.asarray(jtraj["last_value"]), rtol=1e-5,
                               atol=2e-6)
    for g, w in zip(list(state) + [obs], list(jstate) + [jobs]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=2e-6)
    _, traj = sampler.make_env_rollout(env, T)(
        policy, sampler.init_env_carry(env, 1, B, "cpu"))
    assert {k: tuple(v.shape) for k, v in traj.items()} == {
        k: tuple(np.shape(v)) for k, v in jtraj.items()}
