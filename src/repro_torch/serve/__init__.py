"""The policy serving plane: train -> checkpoint -> serve (port of
``repro/serve``).

``PolicyServer`` micro-batches concurrent ``act(obs)`` requests into
fixed-width dispatches on one device under a latency deadline, loads any
registered env × algo policy from a ``checkpoint/`` directory
(``load_policy``), and hot-swaps params live through the versioned
``core.ipc.ParamsChannel`` a training run publishes to. ``ServingStats`` is
the accounting shared with the LM ``SlotServer``.

The loader and the server load on first use, so that the LM serving path,
which imports ``serve.sampling`` and ``serve.stats``, does not import the
RL experiment through this package.
"""
import importlib

from repro_torch.serve.stats import ServingStats, percentile  # noqa: F401

_EXPORTS = {
    "PolicyHandle": "loader", "load_policy": "loader",
    "PendingAct": "server", "PolicyServer": "server",
    "ServerClosed": "server", "ServerOverloaded": "server",
}

__all__ = sorted((*_EXPORTS, "ServingStats", "percentile"))


def __getattr__(name):
    if name in _EXPORTS:
        module = importlib.import_module(f"{__name__}.{_EXPORTS[name]}")
        return getattr(module, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
