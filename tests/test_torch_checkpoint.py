"""The port's checkpoints (``repro_torch.checkpoint``) against the JAX
package's: the save/restore round trip, keep-last-k and the clear errors of
``tests/test_optim_ckpt.py``, then the format shared across the packages —
equal ``arrays.npz`` key sets, shapes and dtypes for ppo, trpo, sac and
ddpg; a checkpoint trained in JAX served by the port and one trained by the
port's CLI restored by the reference, each with its params exact and its
served actions within the port's rollout parity bound; the spec in
``meta.json``; ``ChannelSpec``'s JSON read by both packages."""
import json
import os

import jax
import numpy as np
import pytest
import torch

from repro import checkpoint as jax_checkpoint
from repro import experiment as jax_experiment
from repro import serve as jax_serve
from repro.core import ipc as jax_ipc
from repro_torch import checkpoint, convert, serve
from repro_torch.core import ipc
from repro_torch.launch import train

ALGOS = ["ppo", "trpo", "sac", "ddpg"]
TINY = dict(num_samplers=1, global_batch=2, horizon=8, iterations=2)
SEED = 0
# the port's rollout parity bound (tests/test_torch_slice.py)
RTOL, ATOL = 1e-5, 2e-6


# ======================================================= the port alone
def test_checkpoint_roundtrip(tmp_path):
    """Nested dicts, lists and tuples of tensors and arrays restore into
    the template's structure, dtypes and devices."""
    gen = torch.Generator().manual_seed(0)
    tree = {"pi": [{"w": torch.randn(3, 4, generator=gen),
                    "b": torch.randn(4, generator=gen)}],
            "log_std": torch.zeros(2),
            "half": torch.randn(5, generator=gen).half(),
            "step": np.asarray(7, np.int32),
            "pair": (torch.arange(3), np.ones(2, np.float64))}
    path = str(tmp_path / "ckpt")
    checkpoint.save(path, 7, tree, metadata={"arch": "mlp"})
    with np.load(os.path.join(path, "ckpt_0000000007", "arrays.npz")) as d:
        assert sorted(d) == ["half", "log_std", "pair/0", "pair/1",
                             "pi/0/b", "pi/0/w", "step"]
    template = {"pi": [{"w": torch.zeros(3, 4), "b": torch.zeros(4)}],
                "log_std": torch.zeros(2), "half": torch.zeros(5).half(),
                "step": np.zeros((), np.int32),
                "pair": (torch.zeros(3, dtype=torch.int64), np.zeros(2))}
    restored = checkpoint.restore(path, template)
    assert isinstance(restored["pair"], tuple)
    assert isinstance(restored["pi"], list)
    for key, got in checkpoint.io._leaves(restored):
        want = dict(checkpoint.io._leaves(tree))[key]
        assert type(got) is type(want), key
        assert got.dtype == want.dtype, key
        assert np.array_equal(np.asarray(got), np.asarray(want)), key
    assert checkpoint.load_metadata(path) == {"step": 7, "arch": "mlp"}
    assert checkpoint.latest_step(path) == 7


def test_restore_empty_or_absent_dir_names_directory(tmp_path):
    template = {"w": torch.zeros(2)}
    absent = str(tmp_path / "nope")
    with pytest.raises(FileNotFoundError) as exc:
        checkpoint.restore(absent, template)
    assert absent in str(exc.value) and "latest_step" in str(exc.value)

    empty = str(tmp_path / "empty")
    os.makedirs(empty)
    with pytest.raises(FileNotFoundError) as exc:
        checkpoint.restore(empty, template)
    assert empty in str(exc.value) and "latest_step" in str(exc.value)

    checkpoint.save(empty, 3, template)
    with pytest.raises(FileNotFoundError) as exc:
        checkpoint.restore(empty, template, step=7)
    msg = str(exc.value)
    assert "7" in msg and "latest_step() -> 3" in msg

    with pytest.raises(FileNotFoundError):
        checkpoint.load_metadata(absent)


def test_checkpoint_keep_last_k(tmp_path):
    path = str(tmp_path / "ckpt")
    for step in range(5):
        checkpoint.save(path, step, {"w": torch.tensor(float(step))}, keep=2)
    assert checkpoint.latest_step(path) == 4
    assert sorted(os.listdir(path)) == ["ckpt_0000000003",
                                        "ckpt_0000000004"]
    assert float(checkpoint.restore(path, {"w": torch.zeros(())},
                                    step=3)["w"]) == 3.0


# ================================================== across the packages
def _jax_spec(algo):
    return jax_experiment.ExperimentSpec(
        env="pendulum", algo=algo,
        schedule=jax_experiment.Schedule(seed=SEED, **TINY))


@pytest.fixture(scope="module")
def jax_ckpts(tmp_path_factory):
    """One tiny JAX run per algo, checkpointed as the reference's train CLI
    does: ``{algo: (dir, params)}``."""
    out = {}
    for algo in ALGOS:
        spec = _jax_spec(algo)
        result = jax_experiment.run(spec)
        d = str(tmp_path_factory.mktemp(f"jax_{algo}"))
        jax_checkpoint.save(d, 2, result.params,
                            metadata={"mode": "rl", "spec": spec.to_dict()})
        out[algo] = (d, jax.tree.map(np.asarray, result.params))
    return out


@pytest.fixture(scope="module")
def port_ckpts(tmp_path_factory):
    """One tiny run per algo through the port's train CLI with
    ``--ckpt-dir``: ``{algo: (dir, params)}``."""
    out = {}
    for algo in ALGOS:
        d = str(tmp_path_factory.mktemp(f"port_{algo}"))
        result = train.main(
            ["--env", "pendulum", "--algo", algo, "--seed", str(SEED),
             "--ckpt-dir", d, "--device", "cpu"]
            + [x for k, v in TINY.items()
               for x in (f"--{k.replace('_', '-')}", str(v))])
        out[algo] = (d, result.params)
    return out


def _npz_layout(directory):
    with np.load(os.path.join(directory, "ckpt_0000000002",
                              "arrays.npz")) as d:
        return {k: (d[k].shape, d[k].dtype) for k in d}


@pytest.mark.parametrize("algo", ALGOS)
def test_arrays_npz_layout_is_shared(algo, jax_ckpts, tmp_path):
    """The reference's save of its params and the port's save of the same
    params write equal key sets, shapes and dtypes (and values)."""
    jdir, jparams = jax_ckpts[algo]
    to_tree, from_tree = convert.PARAM_TREES[algo]
    port_params = from_tree(jparams)
    pdir = str(tmp_path / "port")
    checkpoint.save(pdir, 2, to_tree(port_params))
    assert _npz_layout(pdir) == _npz_layout(jdir)
    with np.load(os.path.join(pdir, "ckpt_0000000002", "arrays.npz")) as p, \
            np.load(os.path.join(jdir, "ckpt_0000000002", "arrays.npz")) as j:
        for k in j:
            assert np.array_equal(p[k], j[k]), k


def _jax_noise(key, act_dim):
    return np.asarray(jax.random.normal(key, (act_dim,)))


def _served_pairs(directory, n=5):
    """The same observations through the reference's server (its default
    keys ``(seed, request_id)``) and the port's, given the reference's
    draw for each key as ``noise``: the two action lists."""
    jax_handle = jax_serve.load_policy(directory)
    obs = np.random.RandomState(1).randn(
        n, jax_handle.env.obs_dim).astype(np.float32)
    with jax_serve.PolicyServer(jax_handle.env, jax_handle.algo,
                                jax_handle.params, slots=4,
                                deadline_ms=1.0) as server:
        want = [server.act(o, timeout=60.0) for o in obs]
    keys = [np.array([SEED, rid], np.uint32) for rid in range(n)]
    with serve.PolicyServer.from_checkpoint(directory, device="cpu", slots=4,
                                            deadline_ms=1.0) as server:
        got = [server.act(o, noise=_jax_noise(k, jax_handle.env.act_dim),
                          timeout=60.0)
               for o, k in zip(obs, keys)]
    return got, want


def _assert_actions_close(got, want):
    for g, w in zip(got, want):
        assert g.dtype == np.float32 and g.shape == w.shape
        np.testing.assert_allclose(g, w, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("algo", ALGOS)
def test_jax_checkpoint_served_by_the_port(algo, jax_ckpts):
    """A checkpoint the JAX package trained and saved: the port's
    ``load_policy`` restores params equal to ``convert``'s mapping of JAX's
    params exactly, and its served actions, given JAX's draws, equal the
    JAX server's within the parity bound."""
    d, jparams = jax_ckpts[algo]
    handle = serve.load_policy(d, device="cpu")
    assert handle.spec.algo == algo and handle.step == 2
    _, from_tree = convert.PARAM_TREES[algo]
    want = from_tree(jparams)
    for a, b in zip(handle.params.parameters(), want.parameters()):
        assert torch.equal(a, b)
    _assert_actions_close(*_served_pairs(d))


@pytest.mark.parametrize("algo", ALGOS)
def test_port_checkpoint_restored_by_the_reference(algo, port_ckpts):
    """A checkpoint the port's train CLI wrote: the reference's
    ``load_policy`` restores exactly the port's params in the reference's
    layout, and the two servers agree within the parity bound."""
    d, params = port_ckpts[algo]
    handle = jax_serve.load_policy(d)
    assert handle.spec.algo == algo and handle.step == 2
    to_tree, _ = convert.PARAM_TREES[algo]
    want = dict(checkpoint.io._leaves(to_tree(params)))
    got = {jax.tree_util.keystr(p, simple=True, separator="/"): leaf
           for p, leaf in jax.tree_util.tree_flatten_with_path(
               handle.params)[0]}
    assert set(got) == set(want)
    for k, w in want.items():
        g = np.asarray(got[k])
        assert g.dtype == w.dtype and np.array_equal(g, w), k
    _assert_actions_close(*_served_pairs(d))


@pytest.mark.parametrize("algo", ALGOS)
def test_port_meta_spec_read_by_the_reference(algo, port_ckpts):
    """``meta.json`` holds the port's spec as the reference's train CLI
    writes its own: the reference's ``ExperimentSpec.from_dict`` reads it,
    and it round-trips to the same dict."""
    d, _ = port_ckpts[algo]
    meta = jax_checkpoint.load_metadata(d)
    assert meta["mode"] == "rl" and meta["step"] == 2
    jspec = jax_experiment.ExperimentSpec.from_dict(meta["spec"])
    assert jspec.algo == algo and jspec.env == "pendulum"
    assert jspec.schedule == jax_experiment.Schedule(seed=SEED, **TINY)
    assert json.loads(json.dumps(jspec.to_dict())) == meta["spec"]


def test_channel_spec_json_is_shared():
    """The reference's ``ChannelSpec.to_json`` text is read by the port and
    the port's by the reference, each equal field for field."""
    leaves = (("0", (2, 3), "<f4"), ("1", (), "<f8"), ("2", (5,), "|u1"))
    jspec = jax_ipc.ChannelSpec(prefix="walle-x", leaves=tuple(
        jax_ipc.LeafSpec(key=k, shape=s, dtype=t) for k, s, t in leaves))
    pspec = ipc.ChannelSpec(prefix="walle-x", leaves=tuple(
        ipc.LeafSpec(key=k, shape=s, dtype=t) for k, s, t in leaves))
    assert ipc.ChannelSpec.from_json(jspec.to_json()) == pspec
    assert jax_ipc.ChannelSpec.from_json(pspec.to_json()) == jspec
    assert json.loads(pspec.to_json()) == json.loads(jspec.to_json())
