"""Architecture registry: ``get_config(arch_id)`` / ``list_archs()`` (port
of ``repro/configs/__init__.py``).

The configs are the port's own copies of the reference's. Arch names live
in the port's registry under the kind ``"arch"``; each entry is a lazy
loader, so importing this package does not import every config module. The
model of the port (``models.transformer``) runs every family of them.
``walle-mlp`` is the
paper's own Gaussian-MLP policy (``models/mlp_policy.py``); the LM archs are
``ASSIGNED_ARCHS``.
"""
from __future__ import annotations

import importlib
from typing import Dict, List

from repro_torch import registry
from repro_torch.configs.base import (  # noqa: F401
    INPUT_SHAPES,
    InputShape,
    ModelConfig,
    supports_shape,
)

_ARCH_MODULES = {
    "falcon-mamba-7b": "falcon_mamba_7b",
    "llama3-405b": "llama3_405b",
    "mixtral-8x7b": "mixtral_8x7b",
    "h2o-danube-3-4b": "h2o_danube_3_4b",
    "mixtral-8x22b": "mixtral_8x22b",
    "starcoder2-15b": "starcoder2_15b",
    "qwen1.5-32b": "qwen1_5_32b",
    "musicgen-medium": "musicgen_medium",
    "qwen2-vl-7b": "qwen2_vl_7b",
    "hymba-1.5b": "hymba_1_5b",
    "walle-mlp": "walle_mlp",
}

ASSIGNED_ARCHS = [a for a in _ARCH_MODULES if a != "walle-mlp"]


def _loader(module_name: str):
    def load() -> ModelConfig:
        return importlib.import_module(
            f"repro_torch.configs.{module_name}").CONFIG
    return load


for _arch_id, _mod in _ARCH_MODULES.items():
    registry.register("arch", _arch_id, _loader(_mod))


def get_config(arch_id: str) -> ModelConfig:
    """The config of ``arch_id``; a ``-reduced`` suffix gives its CPU-sized
    variant (``ModelConfig.reduced``)."""
    if arch_id.endswith("-reduced"):
        return get_config(arch_id[: -len("-reduced")]).reduced()
    return registry.make("arch", arch_id)


def list_archs() -> List[str]:
    return list(_ARCH_MODULES)


def all_configs() -> Dict[str, ModelConfig]:
    return {a: get_config(a) for a in _ARCH_MODULES}
