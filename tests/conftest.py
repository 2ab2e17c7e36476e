"""Shared pytest fixtures. NOTE: no XLA_FLAGS here on purpose — smoke tests
and benches must see the real single CPU device; only launch/dryrun.py (run
as its own process) materialises the 512 placeholder devices."""
import importlib.util

import jax
import numpy as np
import pytest

# Property-based modules need hypothesis; when it is absent (minimal
# environments), skip them at collection instead of erroring at import.
_HYPOTHESIS_MODULES = [
    "test_algos.py",
    "test_attention.py",
    "test_core_queues.py",
    "test_envs_data.py",
    "test_kernel_plane_prop.py",
    "test_optim_ckpt.py",
    "test_wrappers.py",
]
collect_ignore = (
    [] if importlib.util.find_spec("hypothesis") else _HYPOTHESIS_MODULES)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "slow: long-running end-to-end tests (excluded in CI)")
    config.addinivalue_line(
        "markers", "gpu: needs a CUDA device (skips without one)")


@pytest.fixture(scope="session")
def rng_key():
    return jax.random.PRNGKey(0)


@pytest.fixture(autouse=True, scope="session")
def _x64_off():
    jax.config.update("jax_enable_x64", False)
    yield


def assert_trees_close(a, b, atol=1e-5, rtol=1e-5):
    for xa, xb in zip(jax.tree.leaves(a), jax.tree.leaves(b)):
        np.testing.assert_allclose(np.asarray(xa, np.float32),
                                   np.asarray(xb, np.float32),
                                   atol=atol, rtol=rtol)
