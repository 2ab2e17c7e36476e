"""SGD and the learning-rate schedules of the port against the JAX
package's, within one float32 ulp: the schedules at steps 0, 1, the warmup
and the total (and past it), and SGD's updates and velocity over a few
steps, with and without momentum, with a float rate and with a schedule.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim import schedules as jax_schedules
from repro.optim.sgd import sgd as jax_sgd
from repro_torch.optim import schedules as port_schedules
from repro_torch.optim import constant, cosine_decay, linear_warmup_cosine
from repro_torch.optim import sgd
from repro_torch.optim.sgd import SgdState

WARMUP, TOTAL = 10, 110
STEPS = [0, 1, WARMUP // 2, WARMUP, WARMUP + 1, TOTAL // 2, TOTAL - WARMUP,
         TOTAL, TOTAL + 7]


def schedules(module):
    return {"constant": module.constant(3e-4),
            "cosine_decay": module.cosine_decay(1e-3, TOTAL),
            "cosine_decay_frac": module.cosine_decay(2.5e-3, 37, 0.05),
            "linear_warmup_cosine": module.linear_warmup_cosine(
                1e-3, warmup=WARMUP, total_steps=TOTAL)}


@pytest.mark.parametrize("name", ["constant", "cosine_decay",
                                  "cosine_decay_frac",
                                  "linear_warmup_cosine"])
def test_schedule_matches_jax(name):
    """A 0-dim float32 tensor on the step's device, computed from the step
    tensor, within one ulp of the reference's value at every step."""
    got_fn = schedules(port_schedules)[name]
    want_fn = schedules(jax_schedules)[name]
    for step in STEPS:
        got = got_fn(torch.tensor(step, dtype=torch.int32))
        want = want_fn(jnp.asarray(step, jnp.int32))
        assert got.dtype == torch.float32 and got.shape == ()
        np.testing.assert_array_max_ulp(got.numpy(), np.asarray(want),
                                        maxulp=1)


def test_schedules_take_the_step_as_a_tensor():
    """The rate follows the step tensor it is given (nothing is read once
    and kept): the same schedule at two steps gives two rates, and a
    schedule's value at the reference test's points."""
    wc = linear_warmup_cosine(1.0, warmup=10, total_steps=110)
    assert float(wc(torch.tensor(5))) == pytest.approx(0.5)
    assert float(wc(torch.tensor(10))) == pytest.approx(1.0)
    cos = cosine_decay(1.0, 100)
    assert float(cos(torch.tensor(0))) == pytest.approx(1.0)
    assert float(cos(torch.tensor(100))) == pytest.approx(0.1, abs=1e-6)
    assert float(constant(0.25)(torch.tensor(3))) == 0.25


def _params(rng):
    return [rng.standard_normal(s).astype(np.float32)
            for s in ((4, 3), (3,), (7,))]


@pytest.mark.parametrize("momentum", [0.0, 0.9])
@pytest.mark.parametrize("lr", ["float", "schedule"])
def test_sgd_matches_jax(lr, momentum):
    rng = np.random.default_rng(0)
    params = _params(rng)
    rate_t = (0.05 if lr == "float"
              else linear_warmup_cosine(0.05, warmup=2, total_steps=6))
    rate_j = (0.05 if lr == "float"
              else jax_schedules.linear_warmup_cosine(0.05, warmup=2,
                                                      total_steps=6))
    opt_t, opt_j = sgd(rate_t, momentum), jax_sgd(rate_j, momentum)
    pt = [torch.from_numpy(p.copy()) for p in params]
    s_t, s_j = opt_t.init(pt), opt_j.init(params)
    assert isinstance(s_t, SgdState) and int(s_t.step) == 0
    assert (s_t.velocity is None) == (momentum == 0.0)
    # op by op, as the port runs: under jit XLA may contract
    # ``momentum * v + g`` and the schedule's products into FMAs
    update_j = opt_j.update
    for _ in range(5):
        grads = [rng.standard_normal(p.shape).astype(np.float32)
                 for p in params]
        u_t, s_t = opt_t.update([torch.from_numpy(g) for g in grads], s_t,
                                pt)
        u_j, s_j = update_j(grads, s_j, params)
        assert int(s_t.step) == int(s_j.step)
        for a, b in zip(u_t, u_j):
            np.testing.assert_array_max_ulp(a.numpy(), np.asarray(b),
                                            maxulp=1)
        if momentum:
            for a, b in zip(s_t.velocity, s_j.velocity):
                np.testing.assert_array_max_ulp(a.numpy(), np.asarray(b),
                                                maxulp=1)
