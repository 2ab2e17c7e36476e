"""The data-parallel learner (``repro_torch.distributed.learner``) and its
wiring, on the CPU, against ``tests/test_learner_plane.py``: one shard is
the plain path bit for bit; two microbatches stay within the reference's
bound of the plain run (sync, async, fused) and of JAX's
``ShardedLearner(num_devices=1, microbatches=2)``; D = 4 shards, threads of
this process on ``REPRO_TORCH_HOST_DEVICES=4`` CPU devices, reach D = 1's
final params within the reference's D = 4 bounds; the refusals and
errors; both train-CLI flags; a failing shard ends the step with its error.

Bounds (the reference's): M = 2 within rtol 1e-4, atol 1e-5; PPO D = 4
within 1e-5 (averaged gradients are the full batch's up to summation
order); SAC and DDPG D = 4 within 0.05 (per-shard rings hold another
physical layout of the replay, so the draws differ while following the
same law). No subprocess and no process group: the shards are threads.
"""
import dataclasses
import json
import threading

import jax
import numpy as np
import pytest
import torch

from repro import envs as jax_envs
from repro.algos import api as jax_api
from repro.core import sampler as jax_sampler
from repro.data import buffers as jax_buffers
from repro.distributed.learner import ShardedLearner as JaxShardedLearner
from repro_torch import convert, envs, experiment
from repro_torch.algos.api import DDPGAlgorithm, PPOAlgorithm, make_train_step
from repro_torch.data import buffers
from repro_torch.distributed import grad_sync
from repro_torch.distributed.learner import ShardedLearner, run_shards
from repro_torch.experiment import ExperimentSpec, Schedule
from repro_torch.launch import train
from repro_torch.launch.mesh import HOST_DEVICES_ENV, make_learner_mesh


@pytest.fixture(autouse=True)
def one_thread():
    """Four shard threads beside other test processes: one intra-op
    thread each keeps the file well inside its time."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture
def host_devices(monkeypatch):
    monkeypatch.setenv(HOST_DEVICES_ENV, "4")


TINY = dict(num_samplers=2, global_batch=4, horizon=8, iterations=2, seed=0)


def _tiny_spec(algo="ppo", buffer=None, **sched):
    return ExperimentSpec(
        env="pendulum", algo=algo, backend="inline", runtime="sync",
        model={"hidden": 16}, buffer=buffer,
        buffer_kwargs=({"capacity": 1024, "batch_size": 32}
                       if buffer else {}),
        schedule=Schedule(**{**TINY, **sched}))


def _tensors(params):
    return ([p.detach().clone() for p in params.parameters()]
            + [b.clone() for b in params.buffers()])


def _final(spec, iterations=2, mesh=None):
    runner = experiment.build(spec, device="cpu", mesh=mesh)
    try:
        logs = runner.run(iterations)
    finally:
        runner.close()
    return _tensors(runner.params), logs, runner


def _max_diff(a, b):
    return max(float((x - y).abs().max()) for x, y in zip(a, b))


def _assert_close(got, want, rtol=1e-4, atol=1e-5):
    for x, y in zip(got, want):
        np.testing.assert_allclose(x.numpy(), y.numpy(), rtol=rtol, atol=atol)


# ================================================= experiment.build wiring
@pytest.mark.parametrize("algo,buffer", [("ppo", None),
                                         ("sac", "prioritized"),
                                         ("ddpg", "uniform")])
def test_learner_devices_1_is_plain_bitwise(algo, buffer):
    base, _, plain = _final(_tiny_spec(algo, buffer))
    gated, _, runner = _final(_tiny_spec(algo, buffer, learner_devices=1))
    assert all(torch.equal(a, b) for a, b in zip(gated, base))
    assert runner._train_step.__qualname__ == \
        plain._train_step.__qualname__ == "make_train_step.<locals>.step"


@pytest.mark.parametrize("algo,buffer", [("ppo", None), ("trpo", None),
                                         ("sac", "prioritized"),
                                         ("ddpg", "uniform")])
def test_learner_microbatches_close_to_plain(algo, buffer):
    base, _, _ = _final(_tiny_spec(algo, buffer))
    micro, logs, runner = _final(_tiny_spec(algo, buffer,
                                            learner_microbatches=2))
    assert isinstance(runner._train_step.__self__, ShardedLearner)
    if algo == "trpo":          # not shardable: its plain step, exactly
        assert all(torch.equal(a, b) for a, b in zip(micro, base))
    _assert_close(micro, base)
    assert _max_diff(micro, base) < 1e-5 and len(logs) == 2


def test_unshardable_algo_rejected():
    with pytest.raises(ValueError, match="shard"):
        experiment.build(_tiny_spec("trpo", learner_devices=2),
                         device="cpu")


def test_learner_devices_exceeding_host_raises_with_hint(monkeypatch):
    monkeypatch.delenv(HOST_DEVICES_ENV, raising=False)
    with pytest.raises(ValueError, match=HOST_DEVICES_ENV):
        experiment.build(_tiny_spec(learner_devices=16, global_batch=16),
                         device="cpu")
    with pytest.raises(ValueError, match="learner_devices=2"):
        make_learner_mesh(2, device="cpu")


def test_learner_mesh_reads_the_host_device_count(host_devices):
    assert make_learner_mesh(4, device="cpu") == [torch.device("cpu")] * 4
    with pytest.raises(ValueError, match=f"{HOST_DEVICES_ENV}=8"):
        make_learner_mesh(8, device="cpu")
    pod = make_learner_mesh(4, pods=2, device="cpu")
    assert pod == [torch.device("cpu")] * 4
    assert pod.axis_names == ("pod", "data", "model")
    assert pod.shape == {"pod": 2, "data": 2, "model": 1}
    flat = make_learner_mesh(4, device="cpu")
    assert flat.axis_names == ("data", "model")
    assert flat.shape == {"data": 4, "model": 1}
    with pytest.raises(ValueError, match="learner_pods=3 must divide "
                                         "learner_devices=4"):
        make_learner_mesh(4, pods=3, device="cpu")


def test_learner_batch_must_divide_over_the_devices(host_devices):
    with pytest.raises(ValueError, match="divide evenly"):
        experiment.build(_tiny_spec(learner_devices=3, global_batch=4),
                         device="cpu")


@pytest.mark.parametrize("change", [
    dict(runtime="fused", schedule=Schedule(learner_devices=2)),
    # (fsdp, learner pods, overlap over a learner mesh and the sharded
    # backend run since item 10d: tests/test_torch_fsdp.py and
    # tests/test_torch_sharded_backend.py; these cases name D > 1 under the
    # fused runtime, item 10f, beside them)
    dict(runtime="fused", schedule=Schedule(learner_devices=2, fsdp=True)),
    dict(runtime="fused",
         schedule=Schedule(learner_devices=2, learner_pods=2)),
    dict(runtime="fused",
         schedule=Schedule(overlap=True, learner_devices=2)),
    dict(runtime="fused", schedule=Schedule(learner_devices=4, fsdp=True,
                                            learner_pods=2)),
])
def test_unported_learner_choices_name_the_roadmap(host_devices, change):
    """What waits for item 10f is refused by name, before the device
    count is read."""
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        experiment.build(ExperimentSpec(env="cheetah", **change),
                         device="cpu")


# ====================================== M = 2 against JAX's learner (D = 1)
def test_ppo_microbatched_step_matches_jax():
    """One PPO learn (4 epochs × 4 minibatches, each in 2 microbatches) on
    a JAX-collected cheetah trajectory through JAX's
    ``ShardedLearner(num_devices=1, microbatches=2)`` and the port's."""
    T, N = 32, 8
    jenv = jax_envs.make("cheetah", max_episode_steps=20)
    jalgo = jax_api.registry.make("algo", "ppo", hidden=64)
    params, opt_state = jalgo.init(jax.random.PRNGKey(1), jenv)
    carry = jax_sampler.init_env_carry(jenv, jax.random.PRNGKey(2), N)
    _, traj = jax.jit(jalgo.make_rollout(jenv, T))(params, carry)
    jbuf = jax_buffers.FifoBuffer()
    jlearner = JaxShardedLearner(jalgo, jbuf, num_devices=1, microbatches=2)
    p_j, _, _, m_j = jlearner.train_step(
        params, opt_state, (jbuf.init(traj), jax.random.PRNGKey(3)), traj)

    algo = PPOAlgorithm(hidden=64)
    policy = convert.params_from_jax(jax.tree.map(np.asarray, params))
    learner = ShardedLearner(algo, buffers.FifoBuffer(), num_devices=1,
                             microbatches=2)
    p_t, s_t, _, m_t = learner.train_step(
        policy, algo._opt.init(list(policy.parameters())), (None, None),
        {k: torch.from_numpy(np.array(v)) for k, v in traj.items()})
    assert int(s_t.step) == 16
    for g, w in zip(jax.tree.leaves(convert.params_to_jax(p_t)),
                    jax.tree.leaves(jax.tree.map(np.asarray, p_j))):
        np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-5)
    for k in ("loss", "pg_loss", "v_loss", "entropy"):
        np.testing.assert_allclose(float(m_t[k]), float(m_j[k]), rtol=1e-3,
                                   atol=1e-5)


class _InjectedDDPG(DDPGAlgorithm):
    """DDPG whose ``sample`` takes the next injected stratified draw."""

    def __init__(self, draws, **kwargs):
        super().__init__(**kwargs)
        self.draws = iter(draws)

    def sample(self, buffer, state, generator):
        return buffer.sample_with(state, next(self.draws))


def test_ddpg_prioritized_microbatched_step_matches_jax():
    """One composed DDPG × prioritized step (observe, then 4 sample ->
    learn -> priority updates, each loss in 2 microbatches) on a
    JAX-collected trajectory, the JAX draws injected: the ring exactly,
    params within rtol 1e-4, atol 1e-5, priorities' tree within rtol 1e-5
    plus 1e-5 of its largest mass (``tests/test_torch_slice.py``'s DDPG
    bound)."""
    T, N, CAP, BATCH, HIDDEN = 16, 4, 256, 32, 32
    jenv = jax_envs.make("cheetah", max_episode_steps=10)
    jalgo = jax_api.registry.make("algo", "ddpg", hidden=HIDDEN)
    jbuf = jax_buffers.PrioritizedBuffer(capacity=CAP, batch_size=BATCH)
    params, opt_state = jalgo.init(jax.random.PRNGKey(0), jenv)
    carry = jax_sampler.init_env_carry(jenv, jax.random.PRNGKey(1), N)
    _, traj = jax.jit(jax_sampler.make_algo_rollout(jalgo, jenv, T))(
        params, carry)
    key = jax.random.PRNGKey(2)
    jlearner = JaxShardedLearner(jalgo, jbuf, num_devices=1, microbatches=2)
    p_j, _, (b_j, _), _ = jlearner.train_step(
        params, opt_state, (jbuf.init(jalgo.transition_example(jenv)), key),
        traj)

    draws = [torch.from_numpy(np.array(jax.random.uniform(
        jax.random.split(k)[0], (BATCH,))))
        for k in jax.random.split(key, 5)[1:]]
    env = envs.make("cheetah", max_episode_steps=10)
    algo = _InjectedDDPG(draws, hidden=HIDDEN)
    tbuf = buffers.PrioritizedBuffer(capacity=CAP, batch_size=BATCH)
    learner = ShardedLearner(algo, tbuf, num_devices=1, microbatches=2)
    p_t, s_t, (b_t, _), _ = learner.train_step(
        convert.ddpg_params_from_jax(jax.tree.map(np.asarray, params)),
        convert.ddpg_adam_states_from_jax(jax.tree.map(np.asarray,
                                                       opt_state)),
        (tbuf.init(algo.transition_example(env, "cpu")), None),
        {k: torch.from_numpy(np.array(v)) for k, v in traj.items()})
    assert s_t[0].step == s_t[1].step == 4
    for k, v in b_t.ring.storage.items():
        np.testing.assert_array_equal(v.numpy(),
                                      np.asarray(b_j.ring.storage[k]))
    for g, w in zip(b_t.tree.levels, b_j.tree.levels):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-5,
                                   atol=1e-5 * float(w.max()))
    for g, w in zip(jax.tree.leaves(convert.ddpg_params_to_jax(p_t)),
                    jax.tree.leaves(jax.tree.map(np.asarray, p_j))):
        np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-5)


# ================================================ the async and fused runs
def _recording(runner):
    """Wrap the runner's train step to keep each trajectory it learns
    from; returns that list."""
    seen, step = [], runner._train_step

    def recorded(params, opt_state, plane, traj):
        seen.append({k: v.clone() for k, v in traj.items()})
        return step(params, opt_state, plane, traj)

    runner._train_step = recorded
    return seen


def _replay_plain(spec, trajs):
    """The plain learner (one device, one microbatch) over ``trajs`` from
    ``spec``'s initial params."""
    plain = dataclasses.replace(spec, runtime="sync", backend="inline",
                                schedule=dataclasses.replace(
                                    spec.schedule, learner_devices=None,
                                    learner_microbatches=1))
    runner = experiment.build(plain, device="cpu")
    try:
        params, opt, plane = runner.params, runner.opt_state, \
            runner.plane_state
        for traj in trajs:
            params, opt, plane, _ = runner._train_step(params, opt, plane,
                                                       traj)
    finally:
        runner.close()
    return _tensors(params)


@pytest.mark.parametrize("sched", [
    dict(learner_microbatches=2),
    dict(learner_devices=4, global_batch=8, min_batches_per_update=2)])
def test_async_learner_matches_the_plain_learner(host_devices, sched):
    """The async runtime's sampler threads free-run, so two of its runs
    learn from different trajectories: the microbatched (D = 4) learner's
    final params are held against the plain learner over the very
    trajectories it consumed."""
    spec = dataclasses.replace(
        _tiny_spec(**sched), runtime="async", backend="threaded")
    runner = experiment.build(spec, device="cpu")
    seen = _recording(runner)
    try:
        logs = runner.run(3)
    finally:
        runner.close()
    assert len(logs) == len(seen) == 3
    got, want = _tensors(runner.params), _replay_plain(spec, seen)
    _assert_close(got, want)
    assert _max_diff(got, want) < 1e-5


@pytest.mark.parametrize("algo,buffer", [("ppo", None),
                                         ("sac", "prioritized")])
def test_fused_microbatched_close_to_plain(algo, buffer):
    def spec(**sched):
        return dataclasses.replace(_tiny_spec(algo, buffer, **sched),
                                   runtime="fused")
    base, _, _ = _final(spec(), iterations=3)
    micro, logs, runner = _final(spec(learner_microbatches=2), iterations=3)
    assert len(logs) == 3 and all(lg.collect_time == 0.0 for lg in logs)
    _assert_close(micro, base)


def test_overlap_microbatched_close_to_plain():
    """Overlap at one learner device is accumulation only (the reference
    builds no mesh for it)."""
    base, _, _ = _final(_tiny_spec(overlap=True), iterations=4)
    micro, _, _ = _final(_tiny_spec(overlap=True, learner_microbatches=2),
                         iterations=4)
    _assert_close(micro, base)


# ======================================= D = 4 against D = 1 (in-process)
@pytest.mark.parametrize("algo,buffer,tol", [("ppo", None, 1e-5),
                                             ("sac", "prioritized", 0.05),
                                             ("ddpg", "uniform", 0.05)])
def test_learner_d4_matches_d1(host_devices, algo, buffer, tol):
    """The reference's ``test_learner_d4_matches_d1`` (8 × 8 samples, 3
    iterations), with four shard threads on four CPU devices."""
    def spec(devices):
        return _tiny_spec(algo, buffer, global_batch=8,
                          learner_devices=devices)
    p1, _, _ = _final(spec(None), iterations=3)
    p4, logs, runner = _final(spec(4), iterations=3)
    assert _max_diff(p1, p4) < tol
    assert all(np.isfinite(lg.mean_return) for lg in logs)
    learner = runner._train_step.__self__
    assert learner.num_shards == 4
    # the replicas stay equal: every shard's params are shard 0's
    for replica in learner._params[1:]:
        assert all(torch.equal(a, b) for a, b in zip(
            _tensors(replica), _tensors(learner._params[0])))


def test_explicit_mesh_may_repeat_a_device():
    """The reference's ``mesh=`` argument: two shards on one device, as
    ``chip_smoke.py`` runs them on the one card."""
    p1, _, _ = _final(_tiny_spec(global_batch=8), iterations=2)
    p2, _, runner = _final(_tiny_spec(global_batch=8, learner_devices=2),
                           iterations=2, mesh=["cpu", "cpu"])
    assert runner._train_step.__self__.num_shards == 2
    assert _max_diff(p1, p2) < 1e-5


def test_sharded_replay_plane_lives_per_shard(host_devices):
    _, _, runner = _final(_tiny_spec("sac", "prioritized", global_batch=8,
                                     learner_devices=4), iterations=2)
    states, _ = runner.plane_state
    assert len(states) == 4
    sizes = [int(s.ring.size) for s in states]
    # every shard holds its quarter of 2 iterations × 8 envs × 8 steps
    assert sizes == [2 * 8 * 8 // 4] * 4
    assert all(s.tree.capacity == 1024 // 4 for s in states)


# ================================================================ the CLI
def _cli(capsys, argv):
    train.main(argv + ["--device", "cpu"])
    return [json.loads(line)
            for line in capsys.readouterr().out.strip().splitlines()]


@pytest.mark.parametrize("flags", [
    ["--learner-microbatches", "2"],
    ["--learner-devices", "4"],
    ["--learner-devices", "2", "--learner-microbatches", "2",
     "--algo", "sac", "--buffer", "prioritized", "--replay-capacity", "256",
     "--replay-batch", "16"],
])
def test_train_cli_learner_flags(capsys, host_devices, flags):
    logs = _cli(capsys, ["--env", "cartpole", "--num-samplers", "2",
                         "--global-batch", "8", "--horizon", "8",
                         "--iterations", "2"] + flags)
    assert len(logs) == 2 and logs[0]["samples"] == 8 * 8
    assert all(np.isfinite(lg["mean_return"]) for lg in logs)


def test_train_cli_learner_devices_without_the_devices(monkeypatch):
    monkeypatch.delenv(HOST_DEVICES_ENV, raising=False)
    with pytest.raises(ValueError, match="learner_devices=2"):
        train.main(["--env", "cartpole", "--num-samplers", "2",
                    "--global-batch", "8", "--horizon", "8",
                    "--iterations", "1", "--learner-devices", "2",
                    "--device", "cpu"])


# ================================================== a shard that fails
class _FailingPPO(PPOAlgorithm):
    """PPO whose learn raises on shard 1."""

    def learn(self, params, opt_state, traj):
        if grad_sync.reduce_axes().rank == 1:
            raise ArithmeticError("shard 1 failed")
        return super().learn(params, opt_state, traj)


def _ppo_learner_inputs(algo, d):
    env = envs.make("pendulum")
    params, opt = algo.init(torch.Generator().manual_seed(0), env, "cpu")
    rng = np.random.default_rng(0)
    T, B = 8, 4
    traj = {k: torch.from_numpy(rng.standard_normal(shape).astype(
        np.float32)) for k, shape in (
        ("obs", (T, B, env.obs_dim)), ("actions", (T, B, env.act_dim)),
        ("rewards", (T, B)), ("values", (T, B)), ("logp", (T, B)),
        ("last_value", (B,)))}
    traj["dones"] = torch.zeros(T, B, dtype=torch.bool)
    learner = ShardedLearner(algo, buffers.FifoBuffer(), num_devices=d,
                             mesh=["cpu"] * d)
    return learner, params, opt, traj


def test_a_failing_shard_raises_its_error():
    learner, params, opt, traj = _ppo_learner_inputs(_FailingPPO(hidden=8),
                                                     2)
    with pytest.raises(ArithmeticError, match="shard 1 failed"):
        learner.train_step(params, opt, (None, torch.Generator()), traj)
    assert not [t for t in threading.enumerate()
                if t.name.startswith("learner-shard")]
    # the learner recovers: the next step replicates afresh
    learner.algo = PPOAlgorithm(hidden=8)
    learner._step = make_train_step(learner.algo, learner.buffer)
    out = learner.train_step(params, opt, (None, torch.Generator()), traj)
    assert all(torch.isfinite(p).all() for p in out[0].parameters())


def test_a_missing_collective_times_out():
    """Shard 1 skips the collectives shard 0 waits in: the barrier's
    timeout ends the step with an error naming it, not a hang."""
    def fn(s):
        if s == 0:
            grad_sync.pmean(torch.ones(()))
        return s

    with pytest.raises(RuntimeError, match="waited longer"):
        run_shards(["cpu", "cpu"], fn, [(0,), (1,)], timeout=0.5)
