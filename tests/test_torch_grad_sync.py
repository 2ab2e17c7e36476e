"""The gradient-sync context (``repro_torch.distributed.grad_sync``)
against the reference's (``tests/test_learner_plane.py``'s unit tests):
plain outside a context, ``sync`` a no-op there, microbatch accumulation
against the full batch, the aux fold, the divisibility error; the port's
``value_and_grad`` at M = 2 against JAX's on the same numpy inputs; the
shard group's collectives, in threads of this process.

Bounds: outside a context, bit for bit; accumulation against the full
batch within the reference's rtol 1e-5, atol 1e-6 (a mean of two
half-batch means differs from the full mean in its last bits); against
JAX within rtol 1e-5, atol 1e-6 too (other summation orders).
"""
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.distributed import grad_sync as jax_grad_sync
from repro_torch.distributed import grad_sync
from repro_torch.distributed.learner import run_shards


def _loss(params, batch):
    w, b = params
    pred = batch["x"] @ w + b
    return torch.mean((pred - batch["y"]) ** 2)


def _jax_loss(params, batch):
    pred = batch["x"] @ params["w"] + params["b"]
    return jnp.mean((pred - batch["y"]) ** 2)


def _numpy_toy(n=8):
    rng = np.random.default_rng(0)
    return (rng.standard_normal(3).astype(np.float32), np.float32(0.25),
            rng.standard_normal((n, 3)).astype(np.float32),
            rng.standard_normal(n).astype(np.float32))


def _toy(n=8):
    w, b, x, y = _numpy_toy(n)
    params = [torch.tensor(w, requires_grad=True),
              torch.tensor(b, requires_grad=True)]
    # no leading batch dim: a generator and a scalar pass through whole
    batch = {"x": torch.from_numpy(x), "y": torch.from_numpy(y),
             "rng": torch.Generator().manual_seed(3),
             "scale": torch.tensor(2.0)}
    return params, batch


def test_value_and_grad_outside_context_is_plain():
    params, batch = _toy()
    want_loss = _loss(params, batch)
    want = torch.autograd.grad(want_loss, params)
    loss, got = grad_sync.value_and_grad(_loss, params, batch)
    assert torch.equal(loss, want_loss)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert grad_sync.active() is None
    assert grad_sync.reduce_axes() is None


def test_value_and_grad_takes_a_module():
    net = torch.nn.Linear(3, 1)
    x = torch.from_numpy(_numpy_toy()[2])
    loss_fn = lambda m, b: torch.mean(m(b["x"]) ** 2)     # noqa: E731
    want = torch.autograd.grad(loss_fn(net, {"x": x}), list(net.parameters()))
    _, got = grad_sync.value_and_grad(loss_fn, net, {"x": x})
    assert all(torch.equal(a, b) for a, b in zip(got, want))


def test_sync_is_noop_outside_context():
    tree = [torch.ones(3)]
    assert grad_sync.sync(tree) is tree
    with grad_sync.activate(None, 4):
        assert grad_sync.sync(tree) is tree
        assert grad_sync.reduce_axes() is None
    assert grad_sync.active() is None


def test_microbatch_accumulation_matches_full_batch():
    params, batch = _toy()
    full = _loss(params, batch)
    g_ref = torch.autograd.grad(full, params)
    with grad_sync.activate(None, 4):
        loss, g = grad_sync.value_and_grad(_loss, params, batch)
    for a, b in zip(g, g_ref):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5,
                                   atol=1e-6)
    np.testing.assert_allclose(float(loss), float(full.detach()), rtol=1e-6)
    assert not loss.requires_grad


def test_microbatch_aux_concatenates_per_sample_leaves():
    params, batch = _toy()

    def loss_aux(p, b):
        per = (b["x"] @ p[0] + p[1] - b["y"]) ** 2
        return torch.mean(per), {"per": per.detach(),
                                 "mean": torch.mean(per).detach()}

    (_, aux_ref), _ = grad_sync.value_and_grad(loss_aux, params, batch,
                                               has_aux=True)
    with grad_sync.activate(None, 2):
        (_, aux), _ = grad_sync.value_and_grad(loss_aux, params, batch,
                                               has_aux=True)
    assert aux["per"].shape == aux_ref["per"].shape == (8,)  # not (2, 4)
    np.testing.assert_allclose(aux["per"].numpy(), aux_ref["per"].numpy(),
                               rtol=1e-6)
    assert aux["mean"].shape == ()
    np.testing.assert_allclose(float(aux["mean"]), float(aux_ref["mean"]),
                               rtol=1e-6)


def test_microbatch_divisibility_error():
    params, batch = _toy()
    with grad_sync.activate(None, 3):
        with pytest.raises(ValueError, match="divisible"):
            grad_sync.value_and_grad(_loss, params, batch)


@pytest.mark.parametrize("m", [2, 4])
def test_microbatched_value_and_grad_matches_jax(m):
    """The port's and the reference's ``value_and_grad`` under
    ``activate(None, m)`` on the same numpy toy."""
    w, b, x, y = _numpy_toy()
    jparams = {"w": jnp.asarray(w), "b": jnp.asarray(b)}
    jbatch = {"x": jnp.asarray(x), "y": jnp.asarray(y),
              "rng": jax.random.PRNGKey(3)}
    with jax_grad_sync.activate(None, m):
        j_loss, j_grads = jax_grad_sync.value_and_grad(_jax_loss, jparams,
                                                       jbatch)
    params, batch = _toy()
    with grad_sync.activate(None, m):
        loss, grads = grad_sync.value_and_grad(_loss, params, batch)
    np.testing.assert_allclose(float(loss), float(j_loss), rtol=1e-5)
    for got, want in zip(grads, (j_grads["w"], j_grads["b"])):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                                   atol=1e-6)


def test_context_is_per_thread():
    seen = []
    with grad_sync.activate(None, 2):
        t = threading.Thread(target=lambda: seen.append(grad_sync.active()))
        t.start()
        t.join()
        assert grad_sync.active().microbatches == 2
    assert seen == [None]


@pytest.mark.parametrize("d", [2, 4])
def test_sharded_gradients_equal_the_full_batch(d):
    """D shards, each with its slice of the batch, in lockstep threads:
    every shard ends with the same averaged gradient (bit for bit across
    shards), the full batch's within rtol 1e-5; ``pmean`` of a scalar and
    ``psum`` in shard order likewise."""
    params, batch = _toy(8)
    g_ref = torch.autograd.grad(_loss(params, batch), params)
    n = 8 // d

    def shard_fn(s):
        sl = {"x": batch["x"][s * n:(s + 1) * n],
              "y": batch["y"][s * n:(s + 1) * n]}
        shard = grad_sync.reduce_axes()
        _, g = grad_sync.value_and_grad(_loss, params, sl)
        return (shard.rank, g, grad_sync.pmean(torch.tensor(float(s))),
                shard.psum(torch.tensor([float(s), 1.0])))

    outs = run_shards(["cpu"] * d, shard_fn, [(s,) for s in range(d)])
    assert [o[0] for o in outs] == list(range(d))
    for rank, g, mean, total in outs:
        for a, b, ref in zip(g, outs[0][1], g_ref):
            assert torch.equal(a, b)
            np.testing.assert_allclose(a.numpy(), ref.numpy(), rtol=1e-5,
                                       atol=1e-6)
        assert float(mean) == (d - 1) / 2
        assert total.tolist() == [d * (d - 1) / 2, float(d)]
    assert grad_sync.active() is None
