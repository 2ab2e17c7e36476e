"""The gradients of the port's token-level PPO loss against the JAX
package's on the CPU, at reduced widths (float32): hymba-1.5b-reduced and
mixtral-8x7b-reduced. The model, batch, check and bounds are
``tests/test_torch_lm_common.py``'s;
``tests/test_torch_lm_grads_families.py`` holds the other reduced archs
(two files, so each stays short under load).
"""
import pytest

from test_torch_lm_common import check_lm_ppo_loss_and_grads
from test_torch_lm_common import one_torch_thread  # noqa: F401


@pytest.mark.parametrize("arch", ["hymba-1.5b-reduced",
                                  "mixtral-8x7b-reduced"])
def test_lm_ppo_loss_and_grads_match_jax(arch):
    check_lm_ppo_loss_and_grads(arch)

