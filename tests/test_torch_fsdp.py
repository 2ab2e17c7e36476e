"""FSDP and learner pods on the port's data-parallel learner, on the CPU,
against ``tests/test_fsdp_pipeline.py``: the FSDP collectives over a
4-shard group, one FSDP PPO learn at D = 4 against JAX's plain step, D = 4
and pods 2 × 2 reaching D = 1's final params, the replicated schedule
repeatable bit for bit, SAC and DDPG under FSDP, the storage at hidden
512, overlap over a 4-shard FSDP mesh, the CLI flags and the reference's
``ValueError``s.

The shards are threads of this process on ``REPRO_TORCH_HOST_DEVICES=4``
CPU devices (``monkeypatch.setenv``); no subprocess and no process group.
"""
import dataclasses
import io
import json
import contextlib

import jax
import numpy as np
import pytest
import torch

from repro import envs as jax_envs
from repro.algos import api as jax_api
from repro.core import sampler as jax_sampler
from repro.data import buffers as jax_buffers
from repro.distributed.learner import ShardedLearner as JaxShardedLearner
from repro_torch import convert, experiment
from repro_torch.algos.api import PPOAlgorithm
from repro_torch.data import buffers
from repro_torch.distributed import grad_sync
from repro_torch.distributed.learner import (
    ShardedLearner,
    ShardedOptState,
    run_shards,
)
from repro_torch.experiment import ExperimentSpec, Schedule
from repro_torch.launch import train
from repro_torch.launch.mesh import HOST_DEVICES_ENV, LearnerMesh

CPU4 = [torch.device("cpu")] * 4


@pytest.fixture(autouse=True)
def one_thread():
    """Four shard threads beside other test processes: one intra-op
    thread each keeps the file well inside its time."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def host_devices(monkeypatch):
    monkeypatch.setenv(HOST_DEVICES_ENV, "4")


def _spec(algo="ppo", buffer=None, model=None, **sched):
    base = dict(global_batch=16, horizon=16, iterations=3, seed=0,
                num_samplers=1)
    return ExperimentSpec(env="pendulum", algo=algo, buffer=buffer,
                          model=model or {"hidden": 32},
                          schedule=Schedule(**{**base, **sched}))


def _run(spec):
    return experiment.run(spec, device="cpu")


def _diff(a, b):
    return max(float((x.detach() - y.detach()).abs().max())
               for x, y in zip(a.parameters(), b.parameters()))


# ========================================================== collectives
class _Net(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.l0 = torch.nn.Linear(8, 12)       # weight (12, 8): sharded
        self.head = torch.nn.Linear(6, 4)      # in 6: replicated
        self.log_std = torch.nn.Parameter(torch.randn(4))


def test_fsdp_collectives_over_four_shards():
    torch.manual_seed(0)
    net = _Net()
    learner = ShardedLearner(PPOAlgorithm(hidden=8), buffers.FifoBuffer(),
                             mesh=CPU4, fsdp=True)
    info = learner._fsdp_tables(net)
    assert info.full_table == {("w", (12, 8)): 1}
    assert info.local_table == {("w", (12, 2)): 1}
    full = {n: p.detach().clone() for n, p in net.named_parameters()}
    grads = [torch.randn(p.shape) for p in net.parameters()]   # per shard
    shard_grads = [[g * (s + 1) for g in grads] for s in range(4)]

    def body(s):
        module = _Net()
        with torch.no_grad():
            for (n, p), x in zip(module.named_parameters(), full.values()):
                p.copy_(x)
        grad_sync.shard_params(module)
        local = dict(module.named_parameters())
        assert local["l0.weight"].shape == (12, 2)
        assert torch.equal(local["l0.weight"],
                           full["l0.weight"][:, 2 * s:2 * s + 2])
        assert torch.equal(local["head.weight"], full["head.weight"])
        w_slice = local["l0.weight"].detach().clone()
        grad_sync.gather_params(module)
        assert all(torch.equal(p, full[n])
                   for n, p in module.named_parameters())
        assert torch.equal(grad_sync.localize_like(full["l0.weight"],
                                                   w_slice), w_slice)
        assert grad_sync.localize_like(full["head.weight"],
                                       full["head.weight"]) is \
            full["head.weight"]
        expanded = grad_sync.expand_like([w_slice, full["l0.bias"]],
                                         [full["l0.weight"],
                                          full["l0.bias"]])
        assert torch.equal(expanded[0], full["l0.weight"])
        # value_and_grad's reduce: the sharded leaf's slice of the mean,
        # the replicated leaves whole, named
        names = [n for n, _ in module.named_parameters()]
        mean = grad_sync.active().shard.reduce_mean(
            shard_grads[s], [1 if n == "l0.weight" else None for n in names])
        named = grad_sync.NamedLeaves(mean, [n.split(".")[-1].replace(
            "weight", "w").replace("bias", "b") for n in names])
        sumsq = grad_sync.fsdp_sumsq(named)
        return mean, sumsq

    outs = run_shards(CPU4, body, [(s,) for s in range(4)], fsdp=info)
    want = [sum(g[i] for g in shard_grads) / 4 for i in range(len(grads))]
    k = [n for n, _ in net.named_parameters()].index("l0.weight")
    total = sum(float(torch.sum(w.float() ** 2)) for w in want)
    for s, (mean, sumsq) in enumerate(outs):
        for i, (got, w) in enumerate(zip(mean, want)):
            assert torch.equal(got, w[:, 2 * s:2 * s + 2] if i == k else w)
        assert abs(float(sumsq) - total) < 1e-5 * total
    # outside a step every reshaping function is the identity
    assert grad_sync.fsdp_active() is None
    assert grad_sync.expand_like(w := torch.ones(2), torch.ones(4)) is w


# ================================================ one learn against JAX
def test_fsdp_ppo_learn_matches_jax():
    """One PPO learn (4 epochs × 4 minibatches) on a JAX-collected cheetah
    trajectory, T 32 × B 8: FSDP over 4 shards against JAX's plain step
    (rtol 1e-4, atol 1e-5). T is a multiple of the minibatch count, so the
    shards' minibatch i together is the plain step's minibatch i."""
    T, N = 32, 8
    jenv = jax_envs.make("cheetah", max_episode_steps=20)
    jalgo = jax_api.registry.make("algo", "ppo", hidden=64)
    params, opt_state = jalgo.init(jax.random.PRNGKey(1), jenv)
    carry = jax_sampler.init_env_carry(jenv, jax.random.PRNGKey(2), N)
    _, traj = jax.jit(jalgo.make_rollout(jenv, T))(params, carry)
    jbuf = jax_buffers.FifoBuffer()
    p_j, _, _, _ = JaxShardedLearner(jalgo, jbuf).train_step(
        params, opt_state, (jbuf.init(traj), jax.random.PRNGKey(3)), traj)

    algo = PPOAlgorithm(hidden=64)
    policy = convert.params_from_jax(jax.tree.map(np.asarray, params))
    learner = ShardedLearner(algo, buffers.FifoBuffer(), mesh=CPU4,
                             fsdp=True)
    p_t, s_t, _, _ = learner.train_step(
        policy, algo._opt.init(list(policy.parameters())),
        (None, torch.Generator()),
        {k: torch.from_numpy(np.array(v)) for k, v in traj.items()})
    assert p_t is policy and isinstance(s_t, ShardedOptState)
    assert learner._fsdp_info.full_table        # the hidden layers
    assert int(s_t.full().step) == 16
    for g, w in zip(jax.tree.leaves(convert.params_to_jax(p_t)),
                    jax.tree.leaves(jax.tree.map(np.asarray, p_j))):
        np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-5)


def test_fsdp_step_against_the_replicated_learner():
    """The same inputs through the replicated D = 4 learner and the FSDP
    one: the reduce-scatter gives each shard the replicated mean's slice
    bit for bit, so only the clip's norm is added otherwise; the full
    optimizer state assembled on request equals the replicated one's.
    A state handed back is recognised; a fresh pair is sharded afresh."""
    from repro_torch import envs
    from repro_torch.core import sampler
    env = envs.make("cheetah")
    algo = PPOAlgorithm(hidden=64)
    params, opt = algo.init(torch.Generator().manual_seed(0), env, "cpu")
    _, traj = algo.make_rollout(env, 16)(
        params, sampler.init_env_carry(env, 1, 8, "cpu"))
    results = {}
    for fsdp in (False, True):
        learner = ShardedLearner(algo, buffers.FifoBuffer(), mesh=CPU4,
                                 fsdp=fsdp)
        p = experiment_copy(params)
        p, o, _, _ = learner.train_step(p, experiment_copy(opt),
                                        (None, torch.Generator()), traj)
        held = learner._params[1]
        p, o, _, _ = learner.train_step(p, o, (None, torch.Generator()), traj)
        assert learner._params[1] is held          # recognised, kept
        results[fsdp] = (p, o.full() if fsdp else o)
    (p0, o0), (p1, o1) = results[False], results[True]
    assert _diff(p0, p1) < 1e-6
    for a, b in zip(o0.mu + o0.nu, o1.mu + o1.nu):
        assert a.shape == b.shape and float((a - b).abs().max()) < 1e-6
    assert int(o1.step) == int(o0.step) == 32
    # a fresh pair: sharded afresh, the same first step as a new learner
    learner = ShardedLearner(algo, buffers.FifoBuffer(), mesh=CPU4,
                             fsdp=True)
    other = ShardedLearner(algo, buffers.FifoBuffer(), mesh=CPU4,
                           fsdp=True)
    learner.train_step(experiment_copy(params), experiment_copy(opt),
                       (None, torch.Generator()), traj)
    a, _, _, _ = learner.train_step(experiment_copy(params),
                                    experiment_copy(opt), (None, torch.Generator()), traj)
    b, _, _, _ = other.train_step(experiment_copy(params),
                                  experiment_copy(opt), (None, torch.Generator()), traj)
    assert _diff(a, b) == 0.0


def experiment_copy(x):
    import copy
    return copy.deepcopy(x)


# =================================================== runs against D = 1
@pytest.mark.parametrize("sched", [
    dict(learner_devices=4, fsdp=True),
    dict(learner_devices=4, learner_pods=2, fsdp=True),
], ids=["fsdp4", "pods2x2"])
def test_fsdp_reaches_one_device(sched):
    """PPO pendulum, hidden 32, 16 × 16, 3 iterations: within 1e-4 of
    D = 1's final params (``tests/test_fsdp_pipeline.py``'s bound)."""
    one = _run(_spec()).params
    res = _run(_spec(**sched))
    learner = res.runner._train_step.__self__
    assert learner.fsdp and learner.num_shards == 4
    assert learner.mesh.axis_names == (("pod", "data", "model")
                                       if "learner_pods" in sched
                                       else ("data", "model"))
    assert _diff(one, res.params) < 1e-4


def test_replicated_d4_is_repeatable_bit_for_bit():
    a = _run(_spec(learner_devices=4)).params
    b = _run(_spec(learner_devices=4)).params
    assert _diff(a, b) == 0.0


@pytest.mark.parametrize("algo", ["sac", "ddpg"])
def test_offpolicy_fsdp_close_to_one_device(algo):
    """SAC and DDPG prioritized under FSDP at D = 4 within 0.05 of D = 1
    (the reference's D = 4 bound: the per-shard rings draw otherwise)."""
    kw = dict(buffer="prioritized", model={"hidden": 32},
              buffer_kwargs=None)
    del kw["buffer_kwargs"]
    one = _run(_spec(algo, **kw)).params
    res = _run(_spec(algo, learner_devices=4, fsdp=True, **kw))
    assert res.runner._train_step.__self__.fsdp
    assert _diff(one, res.params) < 0.05
    assert all(torch.isfinite(p).all() for p in res.params.parameters())


# =============================================================== storage
def test_fsdp_stores_big_leaves_sharded_at_hidden_512():
    """Every leaf of at least 1 MiB is stored as a 1/4 slice on each
    shard, its Adam moments in its layout; the step counter whole."""
    res = _run(_spec(model={"hidden": 512}, global_batch=8, horizon=8,
                     iterations=1, learner_devices=4, fsdp=True))
    learner = res.runner._train_step.__self__
    full = dict(res.params.named_parameters())
    big = [n for n, p in full.items()
           if p.numel() * p.element_size() >= 1 << 20]
    assert big, "expected >= 1-MiB leaves at hidden=512"
    opt = res.runner.opt_state
    assert isinstance(opt, ShardedOptState) and len(opt) == 4
    for s, module in enumerate(learner._params):
        stored = dict(module.named_parameters())
        for n in big:
            assert stored[n].shape == (full[n].shape[0],
                                       full[n].shape[1] // 4), n
            assert torch.equal(stored[n], full[n][:, s * 128:(s + 1) * 128])
        moments = opt[s]
        for mu, nu, p in zip(moments.mu, moments.nu, stored.values()):
            assert mu.shape == nu.shape == p.shape
        assert moments.step.shape == () and int(moments.step) == 16
    bytes_full = sum(p.numel() * 4 for p in full.values()) * 3
    assert all(b < bytes_full / 2 for b in learner.shard_bytes())
    assembled = opt.full()
    assert [m.shape for m in assembled.mu] == [p.shape for p in
                                               full.values()]


# =============================================================== overlap
def test_overlap_over_a_fsdp_mesh_stays_close_to_serial():
    """6 iterations, D = 4 with FSDP and overlap against the serial run
    (``tests/test_fsdp_pipeline.py``: staleness 0 on the two warm-up logs,
    1 from the fourth, saved seconds >= 0 and > 0 on some pipelined
    iteration, final params within 0.05)."""
    serial = _run(_spec(iterations=6))
    over = _run(_spec(iterations=6, learner_devices=4, fsdp=True,
                      overlap=True))
    logs = [lg.as_dict() for lg in over.logs]
    for lg in logs[:2]:
        assert lg["staleness"] == 0.0 and lg["overlap_saved_s"] == 0.0
    for lg in logs[3:]:
        assert lg["staleness"] == 1.0
    assert all(lg["overlap_saved_s"] >= 0.0 for lg in logs)
    assert any(lg["overlap_saved_s"] > 0.0 for lg in logs[2:-1])
    assert _diff(serial.params, over.params) < 0.05


# ============================================================ CLI, errors
def _cli(argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        result = train.main(argv + ["--device", "cpu"])
    return result, [json.loads(line) for line in buf.getvalue().splitlines()]


def test_cli_fsdp_and_learner_pods():
    base = ["--env", "pendulum", "--algo", "ppo", "--num-samplers", "1",
            "--global-batch", "8", "--horizon", "8", "--iterations", "2"]
    result, logs = _cli(base + ["--learner-devices", "4", "--fsdp",
                                "--learner-pods", "2"])
    assert len(logs) == 2 and all(np.isfinite(lg["mean_return"])
                                  for lg in logs)
    spec = result.spec.schedule
    assert spec.fsdp and spec.learner_pods == 2
    learner = result.runner._train_step.__self__
    assert learner.fsdp and learner.mesh.shape == {"pod": 2, "data": 2,
                                                   "model": 1}
    with pytest.raises(ValueError, match="fsdp.*learner_devices > 1"):
        _cli(base + ["--fsdp"])
    with pytest.raises(ValueError, match="learner_pods.*learner_devices > 1"):
        _cli(base + ["--learner-pods", "2"])
    with pytest.raises(ValueError, match="learner_pods=3 must divide "
                                         "learner_devices=4"):
        _cli(base + ["--learner-devices", "4", "--learner-pods", "3"])


@pytest.mark.parametrize("sched", [
    dict(fsdp=True), dict(learner_pods=2),
    dict(learner_devices=4, learner_pods=3, fsdp=True)])
def test_reference_value_errors(sched):
    """What the parent refused by name now raises the reference's
    ``ValueError``s (``src/repro/experiment.py:211-230``)."""
    with pytest.raises(ValueError, match="learner_"):
        experiment.build(_spec(**sched), device="cpu")


def test_fused_with_learner_devices_names_item_10f():
    with pytest.raises(NotImplementedError, match="item 10f"):
        experiment.build(dataclasses.replace(
            _spec(learner_devices=2, fsdp=True), runtime="fused"),
            device="cpu")
    mesh = LearnerMesh.of(CPU4, pods=2)
    assert mesh == CPU4 and mesh.shape["pod"] == 2
