"""The registry: one ``register``/``make`` seam for pluggable components
(port of ``repro/registry.py``).

Only what is ported is registered: envs ``pendulum``, ``cartpole`` and
``cheetah``; algos ``ppo``, ``trpo``, ``ddpg`` and ``sac``; backends
``inline``, ``threaded`` and ``process``; buffers ``fifo``, ``uniform`` and
``prioritized``; the model archs of ``repro_torch.configs`` (kind
``arch``: the LM archs and ``walle-mlp``); the RL kernel families ``gae``,
``sum_tree``, ``replay_ring`` and ``env_step`` (kind ``kernel``, each
resolving to its package under ``repro_torch.kernels``). The built-in
entries of each kind live with their implementations and are imported on
first lookup.
Registering a duplicate name raises ``ValueError``; an unknown name raises
``KeyError`` listing the registered choices.
"""
from __future__ import annotations

import importlib
from typing import Any, Callable, Dict, Optional, Tuple

_BUILTIN_MODULES = {
    "env": "repro_torch.envs",
    "algo": "repro_torch.algos.api",
    "backend": "repro_torch.core.backends",
    "buffer": "repro_torch.data.buffers",
    "arch": "repro_torch.configs",
    "kernel": "repro_torch.kernels",
}

_REGISTRIES: Dict[str, Dict[str, Callable[..., Any]]] = {}


def _table(kind: str, autoload: bool = False) -> Dict[str, Callable]:
    if autoload and kind in _BUILTIN_MODULES:
        importlib.import_module(_BUILTIN_MODULES[kind])
    try:
        return _REGISTRIES[kind]
    except KeyError:
        raise KeyError(
            f"unknown registry kind {kind!r}; known kinds: "
            f"{sorted(set(_REGISTRIES) | set(_BUILTIN_MODULES))}")


def register(kind: str, name: str,
             factory: Optional[Callable[..., Any]] = None):
    """Register ``factory`` under ``(kind, name)``; usable as a decorator."""
    def _do(fn: Callable) -> Callable:
        table = _REGISTRIES.setdefault(kind, {})
        if name in table:
            raise ValueError(
                f"{kind} {name!r} is already registered (to {table[name]!r})")
        table[name] = fn
        return fn

    return _do(factory) if factory is not None else _do


def make(kind: str, name: str, **kwargs) -> Any:
    """Instantiate the component registered under ``(kind, name)``."""
    table = _table(kind, autoload=True)
    try:
        factory = table[name]
    except KeyError:
        raise KeyError(
            f"unknown {kind} {name!r}; choose from {sorted(table)}")
    return factory(**kwargs)


def choices(kind: str) -> Tuple[str, ...]:
    """Sorted names registered under ``kind`` (built-ins autoloaded)."""
    return tuple(sorted(_table(kind, autoload=True)))


def contains(kind: str, name: str) -> bool:
    return name in _table(kind, autoload=True)
