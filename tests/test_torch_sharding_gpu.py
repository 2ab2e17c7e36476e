"""FSDP, learner pods, the sharded backend and overlap over a learner mesh
on the card, every shard on ``cuda:0`` (two or four shard threads, or
shards of the sharded backend, on the one card), with the kernels'
per-shard calls held against their plain versions.

Every test here needs a CUDA device and skips without one. The file
imports neither ``jax`` nor ``repro``, so it runs where only PyTorch is
installed:

    PYTHONPATH=src python -m pytest --noconftest -m gpu \
        tests/test_torch_sharding_gpu.py

Bounds: FSDP within 1e-5 of the replicated learner over the same mesh (the
same partition of the samples; only the clip's norm is summed otherwise);
SAC and DDPG under FSDP within 0.05 of one device (the reference's D = 4
bound); the sharded backend bit for bit against inline where each shard
holds one sampler's batch, the first step's actions within 1e-5 where one
shard holds all of them; overlap within 0.05 of the serial run; the
per-shard kernel calls bit for bit against their plain versions.
"""
import dataclasses

import pytest
import torch

from repro_torch import envs, kernels, registry
from repro_torch.core import sampler
from repro_torch.core.backends import make_backend
from repro_torch.distributed.learner import ShardedOptState
from repro_torch.experiment import ExperimentSpec, Schedule, run
from repro_torch.kernels.gae import ops as gae_ops

SMALL = dict(num_samplers=2, global_batch=16, horizon=32, iterations=3)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _params(res):
    return [p.detach().clone() for p in res.params.parameters()]


def _diff(a, b):
    return max(float((x - y).abs().max()) for x, y in zip(a, b))


def _counted(fn):
    kernels.reset_launch_counts()
    out = fn()
    torch.cuda.synchronize()
    return out, kernels.launch_counts()


@pytest.mark.gpu
@pytest.mark.parametrize("d,pods", [(2, 1), (4, 2)])
def test_fsdp_on_one_card_matches_the_replicated_learner(cuda, d, pods):
    """PPO cheetah: FSDP (and pods 2 × 2 at D = 4) over ``d`` entries of
    ``cuda:0`` against the replicated learner over the same mesh; each
    shard stores half (a quarter) of every sharded leaf; GAE once per
    shard per learn."""
    mesh = [cuda] * d
    sched = Schedule(**SMALL, learner_devices=d)
    spec = ExperimentSpec(env="cheetah", algo="ppo", schedule=sched)
    repl = run(spec, device=cuda, mesh=mesh)
    fsdp, counts = _counted(lambda: run(dataclasses.replace(
        spec, schedule=dataclasses.replace(sched, fsdp=True,
                                           learner_pods=pods)),
        device=cuda, mesh=mesh))
    assert _diff(_params(repl), _params(fsdp)) < 1e-5
    learner = fsdp.runner._train_step.__self__
    assert learner.fsdp and len(learner.mesh) == d
    table = learner._fsdp_info.full_table
    assert table
    for module in learner._params:
        for n, p in module.named_parameters():
            full = dict(fsdp.params.named_parameters())[n]
            if p.shape != full.shape:
                assert p.shape[1] * d == full.shape[1] and p.is_cuda
    assert isinstance(fsdp.runner.opt_state, ShardedOptState)
    assert counts["gae"] == d * SMALL["iterations"]
    assert counts["cheetah_step"] == SMALL["iterations"] * 2 * 32


@pytest.mark.gpu
@pytest.mark.parametrize("algo", ["sac", "ddpg"])
def test_fsdp_offpolicy_on_one_card(cuda, algo):
    spec = ExperimentSpec(
        env="cheetah", algo=algo, buffer="prioritized",
        buffer_kwargs={"capacity": 4096, "batch_size": 64},
        schedule=Schedule(**SMALL))
    one = run(spec, device=cuda)
    two, counts = _counted(lambda: run(dataclasses.replace(
        spec, schedule=dataclasses.replace(spec.schedule, learner_devices=2,
                                           fsdp=True)),
        device=cuda, mesh=[cuda, cuda]))
    assert _diff(_params(one), _params(two)) < 0.05
    it = SMALL["iterations"]
    assert counts["ring_insert"] == 2 * it
    assert counts["sumtree_find"] == counts["ring_gather"] == 2 * it * 4
    assert counts["sumtree_update"] == 2 * it * 5


def _backend_collect(kind, mesh, cuda, n=2, per=16, T=32):
    env = envs.make("cheetah")
    algo = registry.make("algo", "ppo")
    params, _ = algo.init(torch.Generator().manual_seed(0), env, cuda)
    carries = [sampler.init_env_carry(env, 5 + i, per, cuda)
               for i in range(n)]
    backend = make_backend(kind, algo.make_rollout(env, T), carries,
                           env=env, horizon=T, mesh=mesh, hooks=algo)
    with backend:
        return _counted(lambda: backend.collect(params)[0])


@pytest.mark.gpu
def test_sharded_backend_on_one_card(cuda):
    """Two samplers of 16 envs: over ``[cuda:0, cuda:0]`` (one sampler's
    batch a shard) bit for bit the inline backend's, 32 × 2 cheetah-step
    launches a sweep; over one device (32 rows a launch) the first step's
    actions within 1e-5, 32 launches."""
    want, inline_counts = _backend_collect("inline", None, cuda)
    assert inline_counts["cheetah_step"] == 2 * 32
    got, counts = _backend_collect("sharded", [cuda, cuda], cuda)
    assert counts["cheetah_step"] == 2 * 32
    for k in want:
        assert torch.equal(got[k], want[k]), k
    got, counts = _backend_collect("sharded", [cuda], cuda)
    assert counts["cheetah_step"] == 32
    assert torch.allclose(got["actions"][0], want["actions"][0], rtol=0,
                          atol=1e-5)
    for k in want:
        assert got[k].shape == want[k].shape
        assert torch.isfinite(got[k].float()).all()


@pytest.mark.gpu
def test_per_shard_kernel_calls_equal_their_plain_versions(cuda):
    """The cheetah step at a shard's 80 rows (160 envs over two shards)
    and GAE at 125 × 80, each against its plain version, bit for bit."""
    env = envs.make("cheetah")
    gen = torch.Generator(device=cuda).manual_seed(3)
    state, obs = env.reset(gen, 80, cuda)
    actions = torch.randn(80, env.act_dim, generator=gen, device=cuda)
    rs, ro = env.reset(gen, 80, cuda)
    steps = torch.randint(0, env.max_episode_steps, (80,), generator=gen,
                          device=cuda, dtype=torch.int32)
    steps[::3] = env.max_episode_steps - 1      # a third of them end
    state = (*state[:4], steps)
    got = env.batch_step(state, actions, rs, ro)
    want = env.batch_step(state, actions, rs, ro, impl="ref")
    torch.cuda.synchronize()
    flat = [*got[0], *got[1:]]
    for x, y in zip(flat, [*want[0], *want[1:]]):
        assert x.dtype == y.dtype and torch.equal(x, y)
    assert bool(got[3].any()), "no episode ended"
    r = torch.randn(125, 80, generator=gen, device=cuda)
    v = torch.randn(125, 80, generator=gen, device=cuda)
    dn = torch.rand(125, 80, generator=gen, device=cuda) < 0.05
    lv = torch.randn(80, generator=gen, device=cuda)
    for x, y in zip(gae_ops.gae_cuda(r, v, dn, lv, gamma=0.99, lam=0.95),
                    gae_ops.gae_ref(r, v, dn, lv, 0.99, 0.95)):
        assert torch.equal(x, y)


@pytest.mark.gpu
def test_overlap_over_a_fsdp_mesh_on_one_card(cuda):
    """D = 2 with FSDP on ``[cuda:0, cuda:0]``, 6 iterations: the
    reference's staleness logs, saved seconds, and 0.05 of serial."""
    sched = Schedule(num_samplers=2, global_batch=16, horizon=32,
                     iterations=6)
    spec = ExperimentSpec(env="pendulum", algo="ppo", schedule=sched)
    serial = run(spec, device=cuda)
    over = run(dataclasses.replace(spec, schedule=dataclasses.replace(
        sched, learner_devices=2, fsdp=True, overlap=True)),
        device=cuda, mesh=[cuda, cuda])
    logs = [lg.as_dict() for lg in over.logs]
    assert [lg["staleness"] for lg in logs[:2]] == [0.0, 0.0]
    assert all(lg["staleness"] == 1.0 for lg in logs[3:])
    assert all(lg["overlap_saved_s"] >= 0.0 for lg in logs)
    assert _diff(_params(serial), _params(over)) < 0.05
