"""The wrappers' launch counts, kept under one lock.

A wrapper adds one to its ``launches`` where it launches its kernel. Under
the overlap schedule the learner's launches (GAE, the replay ring, the sum
tree) are issued from a learner thread while the main thread steps the
envs, and the threaded backend steps them from one thread per sampler; an
unguarded ``launches += 1`` from two threads can lose a count.
"""
from __future__ import annotations

import threading

_lock = threading.Lock()


def add(wrapper, n: int = 1) -> None:
    """``wrapper.launches += n``, atomically."""
    with _lock:
        wrapper.launches += n


def reset(wrappers) -> None:
    with _lock:
        for wrapper in wrappers:
            wrapper.launches = 0


def read(wrappers: dict) -> dict:
    """Name -> launches of every wrapper in ``wrappers``, read at once."""
    with _lock:
        return {name: w.launches for name, w in wrappers.items()}
