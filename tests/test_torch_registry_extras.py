"""The port's registry, configs, protocols and re-exports against the JAX
package's: the ``walle-mlp`` arch, ``ASSIGNED_ARCHS`` and ``all_configs``;
the registry kind ``kernel`` (the four RL families); the ``Algorithm``,
``SamplerBackend`` and ``ExperienceBuffer`` protocols; ``make_backend``;
the names ``repro.core`` and ``repro.optim`` export.
"""
import dataclasses

import pytest
import torch

import repro.configs as jax_configs
import repro.core as jax_core
import repro.optim as jax_optim
from repro import registry as jax_registry
from repro_torch import configs, registry
from repro_torch.algos.api import Algorithm
from repro_torch.core import sampler
from repro_torch.core.backends import SamplerBackend, make_backend
from repro_torch.data.buffers import ExperienceBuffer

# the reference's names that wait for an item of ROADMAP.md's queue 1
NOT_PORTED = set()


def test_walle_mlp_config_matches_the_reference():
    got, want = configs.get_config("walle-mlp"), jax_configs.get_config(
        "walle-mlp")
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.family == "mlp" and (got.n_layers, got.d_model) == (2, 64)
    assert dataclasses.asdict(configs.get_config("walle-mlp-reduced")) == \
        dataclasses.asdict(jax_configs.get_config("walle-mlp-reduced"))


def test_arch_lists_match_the_reference():
    assert "walle-mlp" in registry.choices("arch")
    assert registry.choices("arch") == jax_registry.choices("arch")
    assert configs.ASSIGNED_ARCHS == jax_configs.ASSIGNED_ARCHS
    assert "walle-mlp" not in configs.ASSIGNED_ARCHS
    assert configs.list_archs() == jax_configs.list_archs()
    got, want = configs.all_configs(), jax_configs.all_configs()
    assert list(got) == list(want)
    for name in want:
        assert dataclasses.asdict(got[name]) == dataclasses.asdict(
            want[name]), name


@pytest.mark.parametrize("family,ops", [
    ("gae", ("gae", "discounted_returns")),
    ("sum_tree", ("sumtree_find_batch", "sumtree_update", "SumTree",
                  "sumtree_build")),
    ("replay_ring", ("ring_insert", "ring_gather")),
    ("env_step", ("env_step", "ENV_NAMES")),
])
def test_kernel_kind_resolves_each_family_to_its_ops(family, ops):
    """``registry.make("kernel", family)`` is the family's package, which
    holds its ops, as in the reference."""
    assert registry.choices("kernel") == jax_registry.choices("kernel")
    got = registry.make("kernel", family)
    assert got.__name__ == f"repro_torch.kernels.{family}"
    want = jax_registry.make("kernel", family)
    for name in ops:
        assert callable(getattr(got, name)) or name == "ENV_NAMES", name
        assert hasattr(want, name), name
    if family == "env_step":
        assert got.ENV_NAMES == want.ENV_NAMES


def test_registry_kinds_cover_the_reference():
    for kind in ("env", "algo", "buffer", "arch", "kernel", "backend"):
        assert registry.choices(kind) == jax_registry.choices(kind), kind


@pytest.mark.parametrize("module,jax_module", [
    ("repro_torch.core", jax_core), ("repro_torch.optim", jax_optim)])
def test_reexports_cover_the_reference(module, jax_module):
    """Every public name ``repro.core`` and ``repro.optim`` hold is held by
    the port's package too, but for what waits for a later item."""
    import importlib
    port = importlib.import_module(module)
    names = {n for n in dir(jax_module)
             if not n.startswith("_") and n not in ("annotations",)}
    missing = {n for n in names if not hasattr(port, n)} - NOT_PORTED
    assert not missing, missing


def test_algorithms_and_buffers_satisfy_their_protocols():
    for name in registry.choices("algo"):
        assert isinstance(registry.make("algo", name), Algorithm), name
    for name in registry.choices("buffer"):
        buf = registry.make("buffer", name)
        assert isinstance(buf, ExperienceBuffer), name
        assert buf.kind in ("trajectory", "transitions")
    assert not isinstance(object(), Algorithm)
    assert not isinstance(object(), ExperienceBuffer)


@pytest.mark.parametrize("kind", ["inline", "threaded"])
def test_make_backend_builds_a_collecting_backend(kind):
    """``make_backend`` over the registry: the backend collects one merged
    trajectory per call from its samplers' carries, and has the
    ``SamplerBackend`` protocol's members."""
    from repro_torch import envs
    from repro_torch.algos.api import PPOAlgorithm
    env, algo = envs.make("pendulum"), PPOAlgorithm(hidden=8)
    params, _ = algo.init(torch.Generator().manual_seed(0), env, "cpu")
    carries = [sampler.init_env_carry(env, s, 3, "cpu") for s in (1, 2)]
    backend = make_backend(kind, algo.make_rollout(env, 4), carries,
                           env=env, horizon=4)
    with backend:
        traj, stats = backend.collect(params)
    assert "num_samplers" in SamplerBackend.__annotations__
    for member in ("num_samplers", "collect", "close"):
        assert hasattr(backend, member), member
    for method in ("collect", "close"):
        assert callable(getattr(SamplerBackend, method)), method
    assert backend.num_samplers == 2 and stats.samples == 2 * 3 * 4
    assert traj["obs"].shape == (4, 6, env.obs_dim)
    # the reference's check of a missing env or horizon
    with pytest.raises(ValueError, match="env= and horizon="):
        make_backend("sharded", None, [])
