"""Replay-buffer parity: the port's n-step transform and its uniform and
prioritized buffers against the JAX package's (``impl="ref"``).

Trajectories, priorities and draws are made with numpy or ``jax.random``
and handed to both sides: the uniform buffer gets the JAX slot indices,
the prioritized one the JAX stratified uniforms. Bounds: the n-step
transitions, the stored rings and the drawn indices exactly. Priorities
become leaf masses through ``p ** alpha``, and each side uses its own
float32 ``pow`` (XLA's and ATen's differ by one ulp on a few inputs), so
the tree's leaves are held within 1 ulp and its parents, sums of those
leaves, within ``rtol=1e-6``; the importance weights (another ``pow``)
within ``rtol=1e-6``. Given the same leaves, the tree ops themselves are
exact (``tests/test_torch_sum_tree.py``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data import buffers as jax_buffers
from repro.data import replay as jax_replay
from repro_torch.data import buffers

T, B, OBS, ACT = 6, 4, 3, 2


def _traj(seed, with_dones):
    rng = np.random.default_rng(seed)
    dones = (rng.random((T, B)) < 0.25) if with_dones else np.zeros((T, B),
                                                                    bool)
    return {"obs": rng.standard_normal((T, B, OBS)).astype(np.float32),
            "actions": rng.standard_normal((T, B, ACT)).astype(np.float32),
            "rewards": rng.standard_normal((T, B)).astype(np.float32),
            "dones": dones,
            "next_obs": rng.standard_normal((T, B, OBS)).astype(np.float32)}


def _j(d):
    return {k: jnp.asarray(v) for k, v in d.items()}


def _t(d):
    return {k: torch.from_numpy(np.array(v)) for k, v in d.items()}


def _example():
    return {"obs": np.zeros((1, OBS), np.float32),
            "actions": np.zeros((1, ACT), np.float32),
            "rewards": np.zeros(1, np.float32),
            "next_obs": np.zeros((1, OBS), np.float32),
            "dones": np.zeros(1, bool)}


def _assert_equal(got, want, keys=None):
    for k in keys or want:
        g, w = got[k].numpy(), np.asarray(want[k])
        assert g.dtype == w.dtype and g.shape == w.shape, k
        np.testing.assert_array_equal(g, w, err_msg=k)


@pytest.mark.parametrize("with_dones", [False, True])
@pytest.mark.parametrize("n_step", [1, 3])
def test_nstep_transitions_match_jax(n_step, with_dones):
    traj = _traj(n_step, with_dones)
    want = jax_buffers.nstep_transitions(_j(traj), n_step, 0.99)
    got = buffers.nstep_transitions(_t(traj), n_step, 0.99)
    assert set(got) == set(want)
    _assert_equal(got, want)
    assert got["rewards"].shape == ((T - n_step + 1) * B,)
    if with_dones:
        assert float(got["discounts"].min()) == 0.0


def test_nstep_rejects_a_window_longer_than_the_horizon():
    with pytest.raises(ValueError, match="n_step"):
        buffers.nstep_transitions(_t(_traj(0, False)), T + 1, 0.99)


@pytest.mark.parametrize("n_step", [1, 3])
def test_uniform_buffer_matches_jax(n_step):
    jb = jax_buffers.UniformBuffer(capacity=30, batch_size=16, n_step=n_step)
    tb = buffers.UniformBuffer(capacity=30, batch_size=16, n_step=n_step)
    js, ts = jb.init(_j(_example())), tb.init(_t(_example()))
    for i in range(3):                      # the third add wraps the ring
        traj = _traj(10 + i, True)
        js, ts = jb.add(js, _j(traj)), tb.add(ts, _t(traj))
        assert (ts.index, ts.size) == (int(js.index), int(js.size))
    _assert_equal(ts.storage, js.storage)
    key = jax.random.PRNGKey(4)
    want = jb.sample(js, key)
    got = tb.gather(ts, torch.from_numpy(np.array(
        jax_replay.sample_indices(js, key, 16))))
    _assert_equal(got, want)
    assert jb.update_priorities(js, None, None) is js
    assert tb.update_priorities(ts, None, None) is ts


@pytest.mark.parametrize("n_step", [1, 3])
def test_prioritized_buffer_matches_jax(n_step):
    """add -> add -> update_priorities (duplicate indices) -> sample."""
    jb = jax_buffers.PrioritizedBuffer(capacity=40, batch_size=16,
                                       n_step=n_step)
    tb = buffers.PrioritizedBuffer(capacity=40, batch_size=16, n_step=n_step)
    assert tb.capacity == jb.capacity == 64
    js, ts = jb.init(_j(_example())), tb.init(_t(_example()))
    for i in range(2):
        traj = _traj(20 + i, True)
        js, ts = jb.add(js, _j(traj)), tb.add(ts, _t(traj))
    rng = np.random.default_rng(n_step)
    idx = rng.integers(0, ts.ring.size, 12).astype(np.int32)
    idx[-3:] = idx[0]
    prio = (rng.standard_normal(12) * 2).astype(np.float32)
    js = jb.update_priorities(js, jnp.asarray(idx), jnp.asarray(prio))
    ts = tb.update_priorities(ts, torch.from_numpy(idx),
                              torch.from_numpy(prio))
    leaves, want_leaves = ts.tree.levels[0].numpy(), np.asarray(
        js.tree.levels[0])
    assert (np.abs(leaves.view(np.int32).astype(np.int64)
                   - want_leaves.view(np.int32)) <= 1).all()
    for g, w in zip(ts.tree.levels[1:], js.tree.levels[1:]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6,
                                   atol=0)
    assert float(ts.max_priority) == float(js.max_priority)
    _assert_equal(ts.ring.storage, js.ring.storage)

    key = jax.random.PRNGKey(5)
    want = jb.sample(js, key)
    got = tb.sample_with(ts, torch.from_numpy(np.array(
        jax.random.uniform(key, (16,)))))
    _assert_equal(got, want, [k for k in want if k != "weights"])
    np.testing.assert_allclose(got["weights"].numpy(),
                               np.asarray(want["weights"]), rtol=1e-6)
    assert float(got["weights"].max()) == 1.0


def test_prioritized_sample_draws_from_the_generator():
    tb = buffers.PrioritizedBuffer(capacity=16, batch_size=8)
    ts = tb.add(tb.init(_t(_example())), _t(_traj(1, False)))
    g = torch.Generator().manual_seed(3)
    u = torch.rand(8, generator=torch.Generator().manual_seed(3))
    got, want = tb.sample(ts, g), tb.sample_with(ts, u)
    for k in want:
        assert torch.equal(got[k], want[k]), k
    with pytest.raises(ValueError, match="empty replay buffer"):
        tb.sample(tb.init(_t(_example())), g)
