"""The port's sharding rules (``repro_torch/distributed/sharding.py``)
against the reference's (``repro/distributed/sharding.py``): the same specs
on the reference's own trees over ``AbstractMesh`` meshes, and the port's
FSDP storage layout of each port leaf (``ShardedLearner.fsdp_layout``) as
the reference's layout of the same leaf through ``convert``'s ``(out, in)``
transposition."""
import functools
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh

from repro import registry as jax_registry
from repro.configs import ASSIGNED_ARCHS, INPUT_SHAPES, get_config, \
    supports_shape
from repro.distributed import sharding as jsh
from repro.distributed.learner import ShardedLearner as JaxShardedLearner
from repro.launch import specs as jax_specs
from repro_torch import convert, registry
from repro_torch.distributed import sharding as sh
from repro_torch.distributed.learner import ShardedLearner
from repro_torch.launch.mesh import LearnerMesh


def _abstract_mesh(sizes, names):
    try:
        return AbstractMesh(sizes, names)
    except TypeError:
        return AbstractMesh(tuple(zip(names, sizes)))


MESHES = {
    "16x16": _abstract_mesh((16, 16), ("data", "model")),
    "2x16x16": _abstract_mesh((2, 16, 16), ("pod", "data", "model")),
    "4x1": _abstract_mesh((4, 1), ("data", "model")),
    "2x2x1": _abstract_mesh((2, 2, 1), ("pod", "data", "model")),
}
CPU4 = [torch.device("cpu")] * 4
PORT_MESHES = {"4x1": LearnerMesh.of(CPU4),
               "2x2x1": LearnerMesh.of(CPU4, pods=2)}


def _spec(p):
    """A reference ``PartitionSpec`` as the port writes it."""
    return tuple(p)


def _flat(tree):
    return jax.tree_util.tree_flatten_with_path(tree)[0]


def _at(tree, path):
    for k in path:
        tree = tree[k.key if hasattr(k, "key") else k.idx]
    return tree


@functools.lru_cache(maxsize=None)
def _arch_shapes(arch):
    return jax_specs.params_shapes(get_config(arch))


def test_axes_and_shard_axes_match_the_reference():
    for name, mesh in MESHES.items():
        port_mesh = SimpleNamespace(axis_names=mesh.axis_names,
                                    shape=dict(mesh.shape))
        assert sh.fsdp_axes(port_mesh) == jsh.fsdp_axes(mesh), name
        assert sh.batch_axes(port_mesh) == jsh.batch_axes(mesh), name
        for axes in (("data",), ("model",), ("pod", "data"),
                     sh.fsdp_axes(port_mesh)):
            if not set(axes) <= set(mesh.axis_names):
                continue
            assert sh.axes_size(port_mesh, axes) == jsh.axes_size(mesh, axes)
            for size in range(1, 70):
                assert sh.shard_axes(size, axes, port_mesh) == \
                    jsh.shard_axes(size, axes, mesh), (name, axes, size)
    # the learner meshes carry the reference's names and sizes
    for name, port_mesh in PORT_MESHES.items():
        assert port_mesh.axis_names == MESHES[name].axis_names
        assert port_mesh.shape == dict(MESHES[name].shape)


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch", ASSIGNED_ARCHS)
def test_param_specs_and_fsdp_dims_match_the_reference(arch, mesh_name):
    """``param_specs`` in both modes, ``_param_spec`` and
    ``fsdp_leaf_dim`` leaf by leaf, on every assigned arch's init tree."""
    mesh = MESHES[mesh_name]
    cfg = get_config(arch)
    shapes = _arch_shapes(arch)
    for mode in ("train", "serve"):
        want = jsh.param_specs(cfg, shapes, mesh, mode)
        got = sh.param_specs(cfg, shapes, mesh, mode)
        n = 0
        for path, leaf in _flat(shapes):
            w = _spec(_at(want, path))
            assert _at(got, path) == w, (arch, mode, path)
            assert sh._param_spec(path, leaf, cfg, mesh, mode) == w
            n += 1
        assert n > 5
    for path, leaf in _flat(shapes):
        assert sh.fsdp_leaf_dim(path, leaf, mesh) == \
            jsh.fsdp_leaf_dim(path, leaf, mesh), (arch, path)


@pytest.mark.parametrize("mesh_name", ["16x16", "2x16x16"])
def test_batch_and_decode_specs_match_the_reference(mesh_name):
    mesh = MESHES[mesh_name]
    checked = 0
    for arch in ASSIGNED_ARCHS:
        cfg = get_config(arch)
        for shape in INPUT_SHAPES.values():
            if not supports_shape(cfg, shape)[0]:
                continue
            batch = jax_specs.train_batch_shapes(cfg, shape)
            want = jsh.train_batch_specs(cfg, batch, mesh)
            got = sh.train_batch_specs(cfg, batch, mesh)
            assert got == {k: _spec(v) for k, v in want.items()}, arch
            state = jax_specs.decode_state_shapes(cfg, shape)
            want = jsh.decode_state_specs(cfg, state, mesh)
            got = sh.decode_state_specs(cfg, state, mesh)
            assert got == {k: _spec(v) for k, v in want.items()}, arch
            for size in (1, 7, 32, shape.global_batch):
                assert sh.batch_spec(size, mesh) == _spec(
                    jsh.batch_spec(size, mesh))
            checked += 1
    assert checked >= len(ASSIGNED_ARCHS)


def test_the_reference_layout_trees():
    """``tests/test_fsdp_pipeline.py``'s layout trees: the divisible 2-D
    weight's contracting dim sharded, obs_dim 6 over 4 shards, a bias and
    log_std replicated on both meshes; a dim divisible by 2 but not 4
    replicated on the pod mesh (no partial axis)."""
    tree = {"l0": {"w": np.zeros((64, 64)), "b": np.zeros((64,))},
            "head": {"w": np.zeros((6, 64))},
            "log_std": np.zeros((1,))}
    partial = {"l0": {"w": np.zeros((6, 8))}}
    for name in ("4x1", "2x2x1"):
        for t in (tree, partial):
            for path, leaf in _flat(t):
                got = sh.fsdp_leaf_dim(path, leaf, PORT_MESHES[name])
                assert got == jsh.fsdp_leaf_dim(path, leaf, MESHES[name])
        assert sh.fsdp_leaf_dim(("l0", "w"), (64, 64),
                                PORT_MESHES[name]) == 0
        assert sh.fsdp_leaf_dim(("head", "w"), (6, 64),
                                PORT_MESHES[name]) is None
        # the port's nn.Linear leaves: weight (out, in), dim 1 sharded
        assert sh.port_leaf_dim("l0.weight", (64, 64),
                                PORT_MESHES[name]) == 1
        assert sh.port_leaf_dim("head.weight", (64, 6),
                                PORT_MESHES[name]) is None
        assert sh.port_leaf_dim("l0.bias", (64,), PORT_MESHES[name]) is None
    assert sh.fsdp_leaf_dim(("l0", "w"), (6, 8),
                            PORT_MESHES["2x2x1"]) is None
    assert sh.fsdp_leaf_dim(("l0", "w"), (6, 8),
                            PORT_MESHES["4x1"]) is None
    assert sh.reference_leaf("pi.0.weight", (64, 3)) == (
        ("pi", "0", "w"), (3, 64))


_TO_PORT = {"ppo": convert.params_from_jax,
            "sac": convert.sac_params_from_jax,
            "ddpg": convert.ddpg_params_from_jax}


@pytest.mark.parametrize("mesh_name", ["4x1", "2x2x1"])
@pytest.mark.parametrize("dims", [(6, 2), (3, 1), (14, 6)],
                         ids=["obs6", "pendulum", "cheetah"])
@pytest.mark.parametrize("algo", ["ppo", "sac", "ddpg"])
def test_port_layout_is_the_reference_transposed(algo, dims, mesh_name):
    """The port's FSDP table of each algorithm's params equals the
    reference learner's table of its own params tree, each ``w``'s shape
    and dim through ``convert``'s ``(out, in)`` transposition."""
    env = SimpleNamespace(obs_dim=dims[0], act_dim=dims[1])
    jalgo = jax_registry.make("algo", algo, hidden=64)
    tree = jax.tree.map(np.asarray, jalgo.init(jax.random.PRNGKey(0),
                                               env)[0])
    stub = SimpleNamespace(mesh=MESHES[mesh_name], num_shards=4)
    want = JaxShardedLearner.fsdp_layout(stub, tree)
    params = _TO_PORT[algo](tree)
    buffer = registry.make("buffer", "fifo" if algo == "ppo" else "uniform")
    learner = ShardedLearner(registry.make("algo", algo, hidden=64), buffer,
                             mesh=PORT_MESHES[mesh_name])
    got = learner.fsdp_layout(params)
    assert len(got) == len(want) > 0
    for pname, p in params.named_parameters():
        path, ref_shape = sh.reference_leaf(pname, p.shape)
        key, ref_key = (path[-1], tuple(p.shape)), (path[-1], ref_shape)
        assert (key in got) == (ref_key in want), pname
        if key in got:
            assert path[-1] == "w" and got[key] == 1 - want[ref_key], pname
    # every sharded leaf is a weight whose input dim divides the shards;
    # the first layer's input dim (obs_dim, obs_dim + act_dim) decides
    first = [p for n, p in params.named_parameters()
             if n.endswith("0.weight")]
    for p in first:
        assert (("w", tuple(p.shape)) in got) == (p.shape[1] % 4 == 0)
