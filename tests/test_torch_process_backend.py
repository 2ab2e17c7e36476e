"""The port's actor plane on the CPU: ``WorkerSpec`` (JSON round trip, a
build from the registry alone, the ring's shape from a one-step CPU
rollout), ``process == inline`` and ``threaded == inline`` bit for bit
(PPO on cheetah, SAC with uniform replay on pendulum, N = 2: every merged
trajectory, the logs and the final weights), ``num_workers`` over
``num_samplers``, a worker's crash or exception surfacing as
``WorkerCrashed`` with its id, the lifecycle (``run`` reaps the workers,
``close`` is idempotent and reports a crash during shutdown, no
``/dev/shm/walle-*`` block is left), and the train CLI's ``--backend
process``, ``--async`` and ``--backend threaded`` on the CPU.

The torch backends are held against the torch ``InlineBackend``, never
against the JAX package's process backend (ROADMAP.md queue 3)."""
import dataclasses
import glob
import json
import math
import os

import pytest
import torch

from repro_torch import experiment, kernels, registry
from repro_torch.core import sampler
from repro_torch.core.backends import build_worker_pool
from repro_torch.core.ipc import WorkerCrashed
from repro_torch.envs import make as make_env
from repro_torch.experiment import ExperimentSpec, Schedule
from repro_torch.launch import train

TINY = dict(num_samplers=2, global_batch=8, horizon=12, iterations=2,
            seed=3)
PPO = ExperimentSpec(env="cheetah", algo="ppo", model={"hidden": 16},
                     env_kwargs={"max_episode_steps": 5},
                     schedule=Schedule(**TINY))
SAC = ExperimentSpec(env="pendulum", algo="sac", buffer="uniform",
                     model={"hidden": 16},
                     buffer_kwargs={"capacity": 256, "batch_size": 16},
                     env_kwargs={"max_episode_steps": 5},
                     schedule=Schedule(**TINY))


def _walle_blocks():
    """This process's pools' shared-memory blocks (other test processes
    may hold their own meanwhile)."""
    return glob.glob(f"/dev/shm/walle-{os.getpid()}-*")


def _run_recorded(spec):
    """Run ``spec`` on the CPU, keeping a copy of every merged
    trajectory the backend collected."""
    runner = experiment.build(spec, device="cpu")
    trajs = []
    collect = runner.backend.collect

    def recorded(params):
        merged, stats = collect(params)
        trajs.append({k: v.clone() for k, v in merged.items()})
        return merged, stats

    runner.backend.collect = recorded
    try:
        logs = runner.run(spec.schedule.iterations)
    finally:
        runner.close()
    return runner, logs, trajs


@pytest.fixture(scope="module")
def runs():
    """Each spec on the inline, threaded and process backends (the
    process run names its worker count apart from num_samplers)."""
    out = {}
    for name, spec in (("ppo", PPO), ("sac", SAC)):
        out[name, "inline"] = _run_recorded(spec)
        out[name, "threaded"] = _run_recorded(
            dataclasses.replace(spec, backend="threaded"))
        out[name, "process"] = _run_recorded(dataclasses.replace(
            spec, backend="process", schedule=dataclasses.replace(
                spec.schedule, num_samplers=4, num_workers=2)))
    return out


def _assert_runs_equal(got, want):
    (r1, logs1, trajs1), (r2, logs2, trajs2) = got, want
    assert len(trajs1) == len(trajs2) == TINY["iterations"]
    for t1, t2 in zip(trajs1, trajs2):
        assert sorted(t1) == sorted(t2)
        for k in t1:
            assert t1[k].dtype == t2[k].dtype, k
            assert torch.equal(t1[k], t2[k]), k
    for a, b in zip(logs1, logs2):
        assert (a.samples, a.mean_return) == (b.samples, b.mean_return)
    p1, p2 = list(r1.params.parameters()), list(r2.params.parameters())
    assert len(p1) == len(p2)
    assert all(torch.equal(a, b) for a, b in zip(p1, p2))


@pytest.mark.parametrize("algo", ["ppo", "sac"])
@pytest.mark.parametrize("backend", ["process", "threaded"])
def test_backend_equals_inline_bit_for_bit(runs, algo, backend):
    _assert_runs_equal(runs[algo, backend], runs[algo, "inline"])
    # episodes ended inside the run, so reset candidates were drawn
    assert any(lg.mean_return != 0.0 for lg in runs[algo, "inline"][1])
    if algo == "sac":
        ring = runs[algo, backend][0].plane_state[0]
        want = runs[algo, "inline"][0].plane_state[0]
        assert (ring.index, ring.size) == (want.index, want.size)
        assert all(torch.equal(ring.storage[k], want.storage[k])
                   for k in want.storage)


def test_process_backend_under_the_sharded_learner(monkeypatch):
    """The process backend with the data-parallel learner (D = 2 shard
    threads on two CPU learner devices, M = 2 microbatches), once refused
    by name: equal to the inline run of the same learner, bit for bit."""
    monkeypatch.setenv("REPRO_TORCH_HOST_DEVICES", "2")
    spec = dataclasses.replace(PPO, schedule=dataclasses.replace(
        PPO.schedule, learner_devices=2, learner_microbatches=2))
    inline = _run_recorded(spec)
    process = _run_recorded(dataclasses.replace(
        spec, backend="process", schedule=dataclasses.replace(
            spec.schedule, num_samplers=4, num_workers=2)))
    _assert_runs_equal(process, inline)
    assert process[0]._train_step.__self__.num_shards == 2
    assert _walle_blocks() == []


def test_num_workers_overrides_num_samplers(runs):
    runner, logs, _ = runs["ppo", "process"]
    assert runner.backend.num_samplers == 2
    assert all(lg.samples == TINY["global_batch"] * TINY["horizon"]
               and lg.active_workers == 2 for lg in logs)
    # each worker's one incarnation reported its device, its allocator
    # reserve and its launch counts (none on the CPU: plain versions only)
    info = runner.backend.pool.worker_launches
    assert sorted(info) == [(0, 1), (1, 1)]
    assert all(i["device"] == "cpu" and i["memory_reserved_mib"] == 0
               and set(i["launches"]) == set(kernels.KERNELS)
               and not any(i["launches"].values()) for i in info.values())
    assert sorted(runner.backend.pool.worker_start_seconds) == [0, 1]


def test_run_reaps_workers_and_close_is_idempotent(runs):
    for algo in ("ppo", "sac"):
        runner, logs, _ = runs[algo, "process"]
        procs = runner.backend.pool._procs
        assert procs and all(not p.is_alive() for p in procs)
        runner.close()                               # double close is safe
        assert all(lg.samples == TINY["global_batch"] * TINY["horizon"]
                   for lg in logs)
    assert _walle_blocks() == []


def test_worker_spec_roundtrips_through_json():
    spec = sampler.WorkerSpec(
        env="pendulum", algo="ppo", horizon=8, batch=2, seed=7,
        kernels="ref", env_kwargs={"reward_scale": 0.5},
        algo_kwargs={"hidden": 16, "lr": 1e-3}, device="cpu")
    restored = sampler.WorkerSpec.from_dict(
        json.loads(json.dumps(spec.to_dict())))
    assert restored == spec


def test_worker_spec_build_is_registry_only():
    """A spec rebuilds rollout, carry and params template without any
    parent state; its carry is the one ``experiment.build`` makes for the
    same seed, and ``traj_example`` gives the shapes of a real rollout."""
    spec = sampler.WorkerSpec(env="cheetah", algo="ppo", horizon=4,
                              batch=3, seed=5, kernels="ref",
                              algo_kwargs={"hidden": 16}, device="cpu")
    prev = kernels.kernel_mode()
    try:
        rollout, carry, params = spec.build()
        assert kernels.kernel_mode() == "ref"
    finally:
        kernels.set_kernel_mode(prev)
    assert carry[1].shape == (3, 14)
    want = sampler.init_env_carry(make_env("cheetah"), 5, 3, "cpu")
    for a, b in zip(list(carry[0]) + [carry[1]], list(want[0]) + [want[1]]):
        assert torch.equal(a, b)
    assert torch.equal(carry[2].get_state(), want[2].get_state())
    _, traj = rollout(params, carry)
    example = spec.traj_example()
    assert sorted(example) == sorted(traj)
    for k, v in traj.items():
        assert example[k].shape == tuple(v.shape), k
        assert example[k].dtype == v.numpy().dtype, k
    assert example["last_value"].shape == (3,)


def test_worker_crash_surfaces_with_worker_id():
    """With supervision off (max_respawns=0) a dead worker surfaces as
    ``WorkerCrashed`` naming it."""
    spec = dataclasses.replace(PPO, backend="process",
                               schedule=dataclasses.replace(
                                   PPO.schedule, max_respawns=0))
    runner = experiment.build(spec, device="cpu")
    try:
        assert runner.backend.supervisor is None
        runner.backend.collect(runner.params)        # a healthy sweep
        runner.backend.pool._procs[1].terminate()
        runner.backend.pool._procs[1].join(timeout=30)
        with pytest.raises(WorkerCrashed, match=r"died: #1"):
            runner.backend.collect(runner.params)
    finally:
        runner.close()
    assert _walle_blocks() == []


def test_worker_exception_surfaces_with_worker_id():
    """A worker whose rebuilt params do not match the channel raises in
    its process; the pool surfaces it as ``WorkerCrashed`` naming the
    worker, with the worker's traceback."""
    env = make_env("pendulum")
    algo_kwargs = {"hidden": 16}
    params, _ = registry.make("algo", "ppo", hidden=8).init(
        torch.Generator().manual_seed(0), env, "cpu")
    specs = [sampler.WorkerSpec(env="pendulum", algo="ppo", horizon=4,
                                batch=2, seed=0, algo_kwargs=algo_kwargs,
                                device="cpu")]
    with pytest.raises(WorkerCrashed, match=r"#0 raised(.|\n)*disagree"):
        build_worker_pool(worker_specs=specs, params=params)
    assert _walle_blocks() == []


def test_close_surfaces_crash_during_shutdown():
    """No exception in flight: a worker found dead at ``close`` raises
    ``WorkerCrashed`` naming the shutdown; a second close is silent."""
    spec = dataclasses.replace(PPO, backend="process",
                               schedule=dataclasses.replace(
                                   PPO.schedule, max_respawns=0))
    runner = experiment.build(spec, device="cpu")
    pool = runner.backend.pool
    try:
        runner.backend.collect(runner.params)
        pool._procs[1].kill()
        pool._procs[1].join(timeout=30)
        with pytest.raises(WorkerCrashed, match="crashed during shutdown"):
            pool.close()
    finally:
        pool.close()                                 # idempotent


@pytest.mark.parametrize("flags", [
    ["--backend", "process"], ["--backend", "process", "--async"],
    ["--backend", "threaded"],
    ["--backend", "process", "--async", "--min-batches-per-update", "2"]])
def test_train_cli_actor_plane_cpu(capsys, flags):
    """The entry point a user calls, on the CPU: finite ``IterationLog``
    lines for the process, async process and threaded runs; an async
    update learns on ``--min-batches-per-update`` rollouts (default 1)."""
    train.main(["--env", "cheetah", *flags, "--num-workers", "2",
                "--global-batch", "8", "--horizon", "16", "--iterations",
                "2", "--device", "cpu"])
    logs = [json.loads(line)
            for line in capsys.readouterr().out.strip().splitlines()]
    assert [lg["iteration"] for lg in logs] == [0, 1]
    for lg in logs:
        assert all(math.isfinite(lg[k]) for k in
                   ("mean_return", "collect_time", "learn_time",
                    "staleness", "worker_utilization"))
        rollouts = (int(flags[-1]) if "--min-batches-per-update" in flags
                    else 1 if "--async" in flags else 2)
        assert lg["samples"] == rollouts * 64
    assert _walle_blocks() == []


@pytest.mark.parametrize("flags", [
    ["--backend", "process"], ["--backend", "process", "--async"],
    ["--backend", "threaded"]])
def test_train_cli_actor_plane_without_cuda_raises(monkeypatch, flags):
    """Without ``--device cpu`` the run wants the card; with none it
    raises before any worker starts, and no worker moves to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train.main(["--env", "cheetah", *flags, "--num-workers", "2",
                    "--global-batch", "8", "--horizon", "16"])
    assert _walle_blocks() == []
