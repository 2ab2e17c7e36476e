"""The sharded collection backend (``core/backends.py`` ``ShardedBackend``,
``core/sampler.py`` ``make_sharded_rollout``) on the CPU: the counterpart
of ``tests/test_drivers.py``'s sharded rollout, the merged trajectory
against the inline backend's for every algorithm, the backend through
``experiment`` and the train CLI, and the reference's refusals.

The port's sharded rollout is also held against the reference's, on the
reference's own draws: its carry holds a key per env, so its trajectory is
the same for any split of the batch, and the port's loop, fed those draws
through ``draws=``, must give it at D = 1, 2 and 4.

Where each shard holds one sampler's batch (D = N) the trajectory equals
inline's bit for bit. Elsewhere a shard's act runs over more rows than a
sampler's, and a matmul over more rows need not round as one over fewer
does, so the bound is 1e-5 (row-wise bits are not kept across batch sizes
on this CPU: ``F.linear`` over 2-row slices of a 160 × 64 input differs
from the whole call by up to 9.5e-6, while 16-row slices agree exactly).
"""
import contextlib
import io
import json

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from repro import envs as jax_envs
from repro.algos import api as jax_api
from repro.core import sampler as jax_sampler
from repro_torch import convert, envs, experiment, registry
from repro_torch.core import sampler
from repro_torch.core.backends import ShardedBackend, make_backend
from repro_torch.experiment import ExperimentSpec, Schedule
from repro_torch.launch import train
from repro_torch.launch.mesh import HOST_DEVICES_ENV
from repro_torch.models import mlp_policy

CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture
def host_devices(monkeypatch):
    monkeypatch.setenv(HOST_DEVICES_ENV, "4")


def test_sharded_rollout_eight_shards():
    """One sampler per mesh slice over 8 shards of 2 envs each: shapes,
    finite rewards, and shards that differ."""
    env = envs.make("pendulum")
    params = mlp_policy.init_policy(torch.Generator().manual_seed(0),
                                    env.obs_dim, env.act_dim, 16)
    mesh = [CPU] * 8
    rollout = sampler.make_sharded_rollout(env, horizon=8, mesh=mesh)
    carry = sampler.shard_carries([sampler.init_env_carry(env, 1, 16, "cpu")],
                                  mesh)
    assert [o.shape[0] for o in carry.obs] == [2] * 8
    carry2, traj = rollout(params, carry)
    assert traj["obs"].shape == (8, 16, env.obs_dim)
    assert traj["last_value"].shape == (16,)
    assert torch.isfinite(traj["rewards"]).all()
    flat = traj["obs"][:, :, 0]
    assert flat[:, 0].std() > 0 or flat[:, 1].std() > 0
    assert not torch.equal(traj["obs"][:, 0], traj["obs"][:, 2])
    assert len(carry2.states) == 8 and carry2.generators == carry.generators


PARAMS_FROM_JAX = {"ppo": convert.params_from_jax,
                   "trpo": convert.params_from_jax,
                   "sac": convert.sac_params_from_jax,
                   "ddpg": convert.ddpg_params_from_jax}


@pytest.mark.parametrize("env_name", ["pendulum", "cheetah"])
@pytest.mark.parametrize("algo_name", ["ppo", "trpo", "sac", "ddpg"])
def test_sharded_rollout_matches_the_reference(algo_name, env_name):
    """The reference's ``make_sharded_rollout`` of the algorithm's rollout
    (one sweep, 16 envs, horizon 16, episodes of 5 steps so resets fire)
    and the port's, fed the reference's draws, on the same params and env
    states, over 4 samplers of 4 envs at D = 1, 2 and 4: every trajectory
    leaf, the tail leaf included, and the final env states within 1e-5."""
    B, T, n = 16, 16, 4
    jenv = jax_envs.make(env_name, max_episode_steps=5)
    jalgo = jax_api.registry.make("algo", algo_name, hidden=32)
    jparams, _ = jalgo.init(jax.random.PRNGKey(0), jenv)
    carry = jax_sampler.init_env_carry(jenv, jax.random.PRNGKey(1), B)
    mesh = Mesh(np.asarray(jax.devices()[:1]).reshape(1, 1),
                ("data", "model"))
    ref = jax_sampler.make_sharded_rollout(
        jenv, T, mesh, rollout=jalgo.make_rollout(jenv, T),
        step_keys=jalgo.step_keys, tail_keys=jalgo.tail_keys)
    with mesh:
        (jstate, jobs, _), want = ref(jparams, carry)

    @jax.jit
    def draw(keys):
        # auto_reset's split: each env key -> (next, action, env step),
        # the env step's key -> (physics, reset candidate)
        splits = jax.vmap(lambda k: jax.random.split(k, 3))(keys)
        noise = jax.vmap(lambda k: jax.random.normal(
            k, (jenv.act_dim,)))(splits[:, 1])
        rstate, robs = jax.vmap(jenv.reset)(
            jax.vmap(lambda k: jax.random.split(k)[1])(splits[:, 2]))
        return splits[:, 0], noise, rstate, robs

    def tt(x):
        return torch.from_numpy(np.array(x))

    keys, draws = carry[2], []
    for _ in range(T):
        keys, noise, rstate, robs = draw(keys)
        draws.append((tt(noise), tuple(map(tt, rstate)), tt(robs)))
    env = envs.make(env_name, max_episode_steps=5)
    algo = registry.make("algo", algo_name, hidden=32)
    params = PARAMS_FROM_JAX[algo_name](jax.tree.map(np.asarray, jparams))
    state, obs = tuple(map(tt, carry[0])), tt(carry[1])
    per = B // n
    carries = [(tuple(x[i * per:(i + 1) * per] for x in state),
                obs[i * per:(i + 1) * per], torch.Generator())
               for i in range(n)]
    for d in (1, 2, 4):
        rollout = sampler.make_sharded_rollout(env, T, [CPU] * d, algo)
        got_carry, got = rollout(params, sampler.shard_carries(carries,
                                                               [CPU] * d),
                                 draws=draws)
        assert set(got) == set(want), d
        for k, w in want.items():
            w = np.asarray(w)
            g = got[k].numpy()
            assert g.dtype == w.dtype and g.shape == w.shape, (d, k)
            np.testing.assert_allclose(g, w, rtol=0, atol=1e-5,
                                       err_msg=f"{k} at D = {d}")
        for g, w in zip(
                [torch.cat(xs) for xs in zip(*got_carry.states)]
                + [torch.cat(got_carry.obs)], list(jstate) + [jobs]):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                       atol=1e-5, err_msg=f"carry, D = {d}")


def _collects(algo_name, env_name, kind, mesh=None, n=4, per=4, T=16):
    env = envs.make(env_name)
    algo = registry.make("algo", algo_name, hidden=32)
    params, _ = algo.init(torch.Generator().manual_seed(0), env, "cpu")
    carries = [sampler.init_env_carry(env, 10 + i, per, "cpu")
               for i in range(n)]
    backend = make_backend(kind, algo.make_rollout(env, T), carries,
                           env=env, horizon=T, mesh=mesh, hooks=algo)
    with backend:
        out = [backend.collect(params) for _ in range(2)]
    return backend, out


@pytest.mark.parametrize("env_name", ["pendulum", "cheetah"])
@pytest.mark.parametrize("algo", ["ppo", "trpo", "sac", "ddpg"])
def test_sharded_trajectory_against_inline(algo, env_name):
    """N = 4 samplers of 4 envs, horizon 16, two collects: D = 4 (one
    sampler's batch a shard) bit for bit, D = 2 and D = 1 within 1e-5."""
    _, want = _collects(algo, env_name, "inline")
    for d in (4, 2, 1):
        backend, got = _collects(algo, env_name, "sharded", mesh=[CPU] * d)
        assert isinstance(backend, ShardedBackend)
        assert backend.num_samplers == d
        for (g, gs), (w, ws) in zip(got, want):
            assert set(g) == set(w) and gs.samples == ws.samples == 256
            assert len(gs.per_sampler_seconds) == 1
            for k in w:
                assert g[k].shape == w[k].shape and g[k].dtype == w[k].dtype
                if d == 4:
                    assert torch.equal(g[k], w[k]), (algo, d, k)
                else:
                    assert torch.allclose(g[k].float(), w[k].float(),
                                          rtol=0, atol=1e-5), (algo, d, k)


def test_sharded_backend_through_experiment(host_devices):
    """``backend="sharded"`` over the CPU's 4 host devices, one sampler's
    batch a shard: the run equals the inline run bit for bit (logs'
    returns and final params), and runs under the D = 2 learner too."""
    def spec(backend, **sched):
        return ExperimentSpec(env="cheetah", algo="ppo", backend=backend,
                              model={"hidden": 16},
                              schedule=Schedule(num_samplers=4,
                                                global_batch=16, horizon=8,
                                                iterations=2, **sched))
    a = experiment.run(spec("inline"), device="cpu")
    b = experiment.run(spec("sharded"), device="cpu")
    assert isinstance(b.runner.backend, ShardedBackend)
    assert b.runner.backend.num_samplers == 4
    assert [lg.mean_return for lg in a.logs] == [
        lg.mean_return for lg in b.logs]
    assert all(torch.equal(x, y) for x, y in zip(a.params.parameters(),
                                                 b.params.parameters()))
    c = experiment.run(spec("sharded", learner_devices=2), device="cpu")
    assert len(c.logs) == 2 and all(
        torch.isfinite(p).all() for p in c.params.parameters())


def test_cli_backend_sharded(host_devices):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        result = train.main(["--env", "pendulum", "--backend", "sharded",
                             "--num-samplers", "2", "--global-batch", "8",
                             "--horizon", "8", "--iterations", "2",
                             "--device", "cpu"])
    logs = [json.loads(line) for line in buf.getvalue().splitlines()]
    assert [lg["samples"] for lg in logs] == [64, 64]
    assert result.spec.backend == "sharded"


@pytest.mark.parametrize("change,match", [
    (dict(runtime="fused"), "backend must be 'inline'"),
    (dict(runtime="async"), "runtime 'async'"),
    (dict(schedule=Schedule(env_batch=8)), "env_batch"),
])
def test_reference_refusals(change, match):
    with pytest.raises(ValueError, match=match):
        experiment.build(ExperimentSpec(env="cheetah", backend="sharded",
                                        **change), device="cpu")


def test_batch_must_divide_over_the_mesh(host_devices):
    with pytest.raises(ValueError, match="not divisible by the 4"):
        experiment.build(ExperimentSpec(
            env="cheetah", backend="sharded",
            schedule=Schedule(num_samplers=3, global_batch=6, horizon=4)),
            device="cpu")
    env = envs.make("pendulum")
    carries = [sampler.init_env_carry(env, 0, 3, "cpu")]
    with pytest.raises(ValueError, match="mesh data axis 2"):
        make_backend("sharded", None, carries, env=env, horizon=4,
                     mesh=[CPU] * 2)
    with pytest.raises(ValueError, match="env= and horizon="):
        make_backend("sharded", None, carries, env=env)
