"""Replay-ring parity: the port's plain versions against the JAX refs
(``impl="ref"``) at the cases of ``tests/test_kernel_plane.py``, exact.
Inputs are made with numpy and handed to both sides. Also the port's
``data/replay.py`` ring state: head and size as 0-dim tensors on the
storage's device, the wrap, and the empty-ring guard.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data import replay as jax_replay
from repro.kernels.replay_ring import ops as jax_ring
from repro_torch import kernels
from repro_torch.data import replay
from repro_torch.kernels.replay_ring import ops as ring


def _torch(d):
    return {k: torch.from_numpy(np.array(v)) for k, v in d.items()}


def _assert_equal(got, want):
    assert set(got) == set(want)
    for k in want:
        w = np.asarray(want[k])
        g = got[k].numpy()
        assert g.dtype == w.dtype and g.shape == w.shape, k
        np.testing.assert_array_equal(g, w, err_msg=k)


@pytest.mark.parametrize("cap,n,start", [
    (17, 5, 0),        # capacity not a power of two
    (17, 5, 15),       # wraparound
    (12, 12, 7),       # exactly one full ring, offset start
    (8, 11, 3),        # n > capacity: self-overwrite, last write wins
    (1, 1, 0),         # degenerate ring
    (1, 3, 0),         # n > capacity = 1
])
def test_ring_insert_matches_jax(cap, n, start):
    rng = np.random.default_rng(cap * 100 + n)
    storage = {"obs": rng.standard_normal((cap, 3)).astype(np.float32),
               "rewards": np.zeros(cap, np.float32),
               "flags": rng.random(cap) < 0.5,
               "steps": rng.integers(0, 9, (cap, 2)).astype(np.int32)}
    batch = {"obs": rng.standard_normal((n, 3)).astype(np.float32),
             "rewards": np.arange(n, dtype=np.float32),
             "flags": rng.random(n) < 0.5,
             "steps": rng.integers(0, 9, (n, 2)).astype(np.int32)}
    want = jax_ring.ring_insert(
        {k: jnp.asarray(v) for k, v in storage.items()},
        {k: jnp.asarray(v) for k, v in batch.items()}, jnp.int32(start),
        impl="ref")
    got_storage = _torch(storage)
    got = ring.ring_insert(got_storage, _torch(batch), start)
    assert got is got_storage          # written in place
    _assert_equal(got, want)


def test_ring_insert_casts_to_the_storage_dtype():
    storage = {"x": torch.zeros(4, dtype=torch.float32)}
    ring.ring_insert(storage, {"x": torch.tensor([1, 2], dtype=torch.int64)},
                     3)
    assert storage["x"].tolist() == [2.0, 0.0, 0.0, 1.0]


@pytest.mark.parametrize("cap,B", [(17, 6), (1, 1), (64, 64)])
def test_ring_gather_matches_jax(cap, B):
    rng = np.random.default_rng(cap * 7 + B)
    storage = {"obs": rng.standard_normal((cap, 2, 2)).astype(np.float32),
               "rewards": rng.standard_normal(cap).astype(np.float32),
               "flags": rng.random(cap) < 0.5}
    idx = rng.integers(0, cap, B).astype(np.int32)
    want = jax_ring.ring_gather({k: jnp.asarray(v) for k, v in
                                 storage.items()}, jnp.asarray(idx),
                                impl="ref")
    got = ring.ring_gather(_torch(storage), torch.from_numpy(idx))
    assert got["obs"].shape == (B, 2, 2)
    _assert_equal(got, want)


def test_ring_gather_out_of_range_indices_as_jnp():
    """Negative indices count from the end, then everything is clamped
    into [0, cap), as jnp indexing does."""
    storage = np.arange(5, dtype=np.float32)
    idx = np.array([7, -1, -9, 2, 5], np.int32)
    want = jax_ring.ring_gather({"x": jnp.asarray(storage)},
                                jnp.asarray(idx), impl="ref")
    got = ring.ring_gather({"x": torch.from_numpy(storage)},
                           torch.from_numpy(idx))
    _assert_equal(got, want)


def test_cpu_tensors_take_the_plain_version_in_cuda_mode():
    kernels.reset_launch_counts()
    storage = {"x": torch.zeros(4, 2)}
    ring.ring_insert(storage, {"x": torch.ones(3, 2)}, 2, impl="cuda")
    ring.ring_gather(storage, torch.tensor([0, 1], dtype=torch.int32),
                     impl="cuda")
    assert kernels.launch_counts()["ring_insert"] == 0
    assert kernels.launch_counts()["ring_gather"] == 0


def test_add_batch_matches_jax_over_wraps():
    """Three adds into a ring of 7 (the last one wraps): storage, head and
    size as the reference's, with head and size as 0-dim int32 tensors on
    the storage's device, as the reference keeps them on its device."""
    rng = np.random.default_rng(3)
    example = {"obs": np.zeros((1, 3), np.float32),
               "rewards": np.zeros(1, np.float32)}
    js = jax_replay.init_replay(7, {k: jnp.asarray(v)
                                    for k, v in example.items()})
    ts = replay.init_replay(7, _torch(example))
    for n in (3, 2, 5):
        batch = {"obs": rng.standard_normal((n, 3)).astype(np.float32),
                 "rewards": rng.standard_normal(n).astype(np.float32)}
        js = jax_replay.add_batch(js, {k: jnp.asarray(v)
                                       for k, v in batch.items()})
        ts = replay.add_batch(ts, _torch(batch))
        assert (ts.index, ts.size) == (int(js.index), int(js.size))
        for x in (ts.index, ts.size):
            assert isinstance(x, torch.Tensor) and x.dim() == 0
            assert x.dtype == torch.int32 and x.device == ts.storage[
                "obs"].device
        _assert_equal(ts.storage, js.storage)


def test_sample_indices_stay_in_the_filled_prefix():
    ts = replay.init_replay(64, {"x": torch.zeros(1)})
    with pytest.raises(ValueError, match="empty replay buffer"):
        replay.sample_indices(ts, torch.Generator().manual_seed(0), 4)
    ts = replay.add_batch(ts, {"x": torch.arange(5.0)})
    idx = replay.sample_indices(ts, torch.Generator().manual_seed(0), 1000)
    assert idx.dtype == torch.int32
    assert int(idx.min()) == 0 and int(idx.max()) == 4


def test_empty_check_reads_the_host_flag_not_the_device():
    """``filled`` follows the shapes added (an add of no rows leaves it
    False), and the empty-ring check reads it alone: a size that cannot be
    read on the host (the meta device) does not get in its way."""
    ts = replay.init_replay(8, {"x": torch.zeros(1)})
    assert ts.filled is False
    ts = replay.add_batch(ts, {"x": torch.zeros(0)})
    assert ts.filled is False and int(ts.size) == 0
    with pytest.raises(ValueError, match="empty replay buffer"):
        replay.ensure_nonempty(ts)
    ts = replay.add_batch(ts, {"x": torch.ones(2)})
    assert ts.filled is True and int(ts.size) == 2
    replay.ensure_nonempty(ts._replace(
        size=torch.zeros((), dtype=torch.int32, device="meta")))


# ------------------------------------------------- the kernels' host plans
PLAN_LEAVES = {"f14": ((14,), torch.float32), "f": ((), torch.float32),
               "b3": ((3,), torch.bool), "i2": ((2,), torch.int32),
               "h5": ((5,), torch.bfloat16)}


def _plan_leaf(rng, rows, shape, dtype):
    x = rng.standard_normal((rows,) + shape).astype(np.float32)
    if dtype == torch.bool:
        return torch.from_numpy(x > 0)
    return torch.from_numpy(x * 9).to(dtype)


def _bytes(t):
    return t.reshape(-1).view(torch.uint8)


def _row_bytes(storage):
    return [v[0].numel() * v.element_size() for v in storage.values()]


@pytest.mark.parametrize("cap,n,start", [
    (17, 5, 0), (17, 5, 15), (12, 12, 7), (8, 11, 3), (1, 1, 0), (1, 3, 0),
    (4096, 20000, 100)])
def test_insert_segments_applied_as_byte_copies_match_plain(cap, n, start):
    """The kernel's plan: one source span per leaf (``insert_spans``), byte
    ``o`` of it copied to byte ``(head * rb + o) % (cap * rb)`` of its leaf
    with the head the kernel computes from the start it reads, gives
    exactly what ``ring_insert_ref`` writes, for a host start and for a
    start held in a 0-dim tensor."""
    rng = np.random.default_rng(cap * 31 + n)
    storage = {k: _plan_leaf(rng, cap, s, d)
               for k, (s, d) in PLAN_LEAVES.items()}
    batch = {k: _plan_leaf(rng, n, s, d) for k, (s, d) in PLAN_LEAVES.items()}
    want = ring.ring_insert_ref({k: v.clone() for k, v in storage.items()},
                                batch, start)
    from_tensor = ring.ring_insert_ref(
        {k: v.clone() for k, v in storage.items()}, batch,
        torch.tensor(start, dtype=torch.int32))
    row_bytes = _row_bytes(storage)
    spans = ring.insert_spans(row_bytes, cap, n)
    names = list(storage)
    assert [leaf for leaf, _, _ in spans] == list(range(len(names)))
    head = (start + max(0, n - cap)) % cap
    for leaf, src, nbytes in spans:
        k, rb = names[leaf], row_bytes[leaf]
        dst = (head * rb + torch.arange(nbytes)) % (cap * rb)
        _bytes(storage[k])[dst] = _bytes(batch[k])[src:src + nbytes]
    for k in want:
        assert torch.equal(storage[k], want[k]), k
        assert torch.equal(from_tensor[k], want[k]), k


def test_insert_segments_skip_empty_inserts_and_zero_width_rows():
    assert ring.insert_spans([4, 8], 16, 0) == []
    assert ring.insert_spans([0, 4], 16, 5) == [(1, 0, 20)]
    assert ring.insert_spans([4], 8, 11) == [(0, 12, 32)]


@pytest.mark.parametrize("rows", [0, 1, 3, 256])
def test_gather_layout_is_aligned_and_disjoint(rows):
    """Each leaf's block of the one output buffer starts at a multiple of
    16 bytes and no two overlap; the views cut from the buffer have the
    leaves' shapes and dtypes, and writing each leaf's rows through its
    view leaves the others' intact."""
    leaves = dict(PLAN_LEAVES, z=((0,), torch.float32))
    rng = np.random.default_rng(rows)
    storage = {k: _plan_leaf(rng, 4, s, d) for k, (s, d) in leaves.items()}
    row_bytes = _row_bytes(storage)
    offsets, total = ring.gather_layout(row_bytes, rows)
    spans = sorted((off, off + rows * rb)
                   for off, rb in zip(offsets, row_bytes))
    assert all(off % ring.ALIGN == 0 for off in offsets)
    assert all(a[1] <= b[0] for a, b in zip(spans, spans[1:]))
    assert spans[-1][1] <= total and total % ring.ALIGN == 0
    plan = ring.Leaves.of(list(storage.values()))
    total_p, views, table = ring.gather_plan(plan, rows)
    assert total_p == total
    assert list(table) == [x for v, off, rb in zip(
        storage.values(), offsets, row_bytes) if rb
        for x in (v.data_ptr(), off, rb)]
    buf = torch.zeros(total, dtype=torch.uint8)
    got = dict(zip(storage, ring.gather_views(buf, views)))
    idx = torch.from_numpy(rng.integers(0, 4, rows))
    for k, v in storage.items():
        assert got[k].shape == (rows,) + v.shape[1:]
        assert got[k].dtype == v.dtype and got[k].is_contiguous()
        got[k].copy_(v[idx])
    for k, v in storage.items():
        assert torch.equal(got[k], v[idx]), k


def test_replay_kernels_name_their_leaf_limit():
    storage = {f"l{i}": torch.zeros(4) for i in range(ring.MAX_LEAVES + 1)}
    with pytest.raises(ValueError, match=f"{ring.MAX_LEAVES} leaves"):
        ring.ring_insert_cuda(storage, storage, 0)
    with pytest.raises(ValueError, match=f"{ring.MAX_LEAVES} leaves"):
        ring.ring_gather_cuda(storage, torch.zeros(2, dtype=torch.int32))
