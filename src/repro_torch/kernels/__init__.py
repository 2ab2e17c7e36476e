"""The kernel plane: CUDA kernels for the RL hot loop and the LM serving
path, each beside its plain PyTorch version, selected by
``kernels.select``.

``KERNELS`` maps each kernel to its wrapper; a wrapper's ``launches``
attribute counts the launches of its kernel, so a run can show that it went
through the kernels. The counts change only under ``kernels.counts``'s
lock, so launches from several threads are all counted.

The RL families are registered under the registry kind ``"kernel"``, as in
the reference: ``registry.make("kernel", "gae")`` returns the family's
package, which holds its ops (``gae``, ``sum_tree``, ``replay_ring``,
``env_step``).
"""
from repro_torch import registry
from repro_torch.kernels import counts
from repro_torch.kernels import env_step, gae, replay_ring, sum_tree
from repro_torch.kernels.decode_attention.ops import (  # noqa: F401
    decode_attention_cuda,
)
from repro_torch.kernels.env_step.ops import (  # noqa: F401
    cartpole_step_cuda,
    cheetah_step_cuda,
    pendulum_step_cuda,
)
from repro_torch.kernels.flash_attention.ops import (  # noqa: F401
    flash_attention_cuda,
)
from repro_torch.kernels.gae.ops import (  # noqa: F401
    discounted_returns_cuda,
    gae_cuda,
)
from repro_torch.kernels.replay_ring.ops import (  # noqa: F401
    ring_gather_cuda,
    ring_insert_cuda,
)
from repro_torch.kernels.select import (  # noqa: F401
    MODES,
    kernel_mode,
    set_kernel_mode,
)
from repro_torch.kernels.selective_scan.ops import (  # noqa: F401
    selective_scan_cuda,
)
from repro_torch.kernels.sum_tree.ops import (  # noqa: F401
    sumtree_find_cuda,
    sumtree_update_cuda,
)

KERNELS = {
    "pendulum_step": pendulum_step_cuda,
    "cartpole_step": cartpole_step_cuda,
    "cheetah_step": cheetah_step_cuda,
    "gae": gae_cuda,
    "discounted_returns": discounted_returns_cuda,
    "ring_insert": ring_insert_cuda,
    "ring_gather": ring_gather_cuda,
    "sumtree_find": sumtree_find_cuda,
    "sumtree_update": sumtree_update_cuda,
    "flash_attention": flash_attention_cuda,
    "decode_attention": decode_attention_cuda,
    "selective_scan": selective_scan_cuda,
}


registry.register("kernel", "gae", lambda: gae)
registry.register("kernel", "sum_tree", lambda: sum_tree)
registry.register("kernel", "replay_ring", lambda: replay_ring)
registry.register("kernel", "env_step", lambda: env_step)


def reset_launch_counts() -> None:
    counts.reset(KERNELS.values())


def launch_counts() -> dict:
    return counts.read(KERNELS)


def add_launches(added: dict) -> None:
    """Add ``added`` (kernel name -> launches) to the wrappers' counts: a
    CUDA-graph replay launches the kernels its capture recorded without
    calling a wrapper (``core/fused.py``)."""
    for name, n in added.items():
        counts.add(KERNELS[name], n)
