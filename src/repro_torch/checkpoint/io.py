"""Tree checkpointing: flattened-path .npz + json metadata, keep-last-k
(port of ``repro/checkpoint/io.py``, with its on-disk format).

``<dir>/ckpt_<step:010d>/arrays.npz`` holds one array per leaf and
``meta.json`` holds ``{"step": ..., **metadata}``; both are written into
``ckpt_<step>.tmp`` and renamed into place. A tree is nested dicts, lists
and tuples whose leaves are numpy arrays, tensors or numbers. A leaf's key
is its path joined by ``/``: dict keys in sorted order, list and tuple
positions as their index (``pi/0/w``, ``log_std``, ``critic/q1/1/b``), the
keys ``jax.tree_util.tree_flatten_with_path`` gives the reference, so a
checkpoint written by either package restores in the other. ``restore``
takes a template tree, whose structure and dtypes are authoritative.
"""
from __future__ import annotations

import json
import os
import re
import shutil
from typing import Any, Dict, Iterator, Optional, Tuple

import numpy as np
import torch

_SEP = "/"


def _leaves(tree, path: Tuple[str, ...] = ()
            ) -> Iterator[Tuple[str, Any]]:
    """``(key, leaf)`` pairs in the reference's flattening order."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], path + (str(k),))
    elif isinstance(tree, (list, tuple)):
        for i, x in enumerate(tree):
            yield from _leaves(x, path + (str(i),))
    else:
        yield _SEP.join(path), tree


def _numpy(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def _flatten(tree) -> Dict[str, np.ndarray]:
    return {key: _numpy(leaf) for key, leaf in _leaves(tree)}


def save(directory: str, step: int, tree: Any,
         metadata: Optional[Dict] = None, keep: int = 3) -> str:
    """Write ``<dir>/ckpt_<step>/arrays.npz`` (+meta.json); prune old."""
    path = os.path.join(directory, f"ckpt_{step:010d}")
    tmp = path + ".tmp"
    os.makedirs(tmp, exist_ok=True)
    np.savez(os.path.join(tmp, "arrays.npz"), **_flatten(tree))
    with open(os.path.join(tmp, "meta.json"), "w") as f:
        json.dump({"step": step, **(metadata or {})}, f)
    if os.path.exists(path):
        shutil.rmtree(path)
    os.rename(tmp, path)
    _prune(directory, keep)
    return path


def _ckpt_steps(directory: str):
    if not os.path.isdir(directory):
        return []
    steps = []
    for name in os.listdir(directory):
        m = re.fullmatch(r"ckpt_(\d+)", name)
        if m:
            steps.append(int(m.group(1)))
    return sorted(steps)


def _prune(directory: str, keep: int) -> None:
    steps = _ckpt_steps(directory)
    for s in steps[:-keep] if keep else []:
        shutil.rmtree(os.path.join(directory, f"ckpt_{s:010d}"),
                      ignore_errors=True)


def latest_step(directory: str) -> Optional[int]:
    steps = _ckpt_steps(directory)
    return steps[-1] if steps else None


def _resolve_step(directory: str, step: Optional[int]) -> int:
    """The step to load, or a ``FileNotFoundError`` that names the
    directory and what ``latest_step`` found: an absent or empty
    checkpoint directory fails here, not deep in ``np.load``."""
    latest = latest_step(directory)
    if step is None:
        if latest is None:
            raise FileNotFoundError(
                f"no checkpoints under {directory!r} (latest_step() -> "
                f"None: the directory "
                f"{'exists but holds' if os.path.isdir(directory) else 'does not exist, so it holds'}"
                f" no ckpt_<step> subdirectories) — check the path, or "
                f"train with --ckpt-dir first")
        return latest
    if not os.path.isdir(os.path.join(directory, f"ckpt_{step:010d}")):
        raise FileNotFoundError(
            f"checkpoint step {step} not found under {directory!r} "
            f"(latest_step() -> {latest})")
    return step


def _rebuild(template, data, path: Tuple[str, ...] = ()):
    """``template``'s structure with each leaf read from ``data`` by key,
    in the leaf's dtype (and, for a tensor, on its device)."""
    if isinstance(template, dict):
        return {k: _rebuild(v, data, path + (str(k),))
                for k, v in template.items()}
    if isinstance(template, (list, tuple)):
        out = [_rebuild(x, data, path + (str(i),))
               for i, x in enumerate(template)]
        return out if isinstance(template, list) else type(template)(out)
    arr = data[_SEP.join(path)]
    if isinstance(template, torch.Tensor):
        return torch.from_numpy(np.array(arr)).to(
            dtype=template.dtype, device=template.device)
    return np.asarray(arr, dtype=np.asarray(template).dtype)


def restore(directory: str, template: Any, step: Optional[int] = None
            ) -> Any:
    """Load arrays into the structure of ``template`` (dtypes preserved)."""
    step = _resolve_step(directory, step)
    path = os.path.join(directory, f"ckpt_{step:010d}", "arrays.npz")
    with np.load(path) as data:
        return _rebuild(template, data)


def load_metadata(directory: str, step: Optional[int] = None) -> Dict:
    step = _resolve_step(directory, step)
    with open(os.path.join(directory, f"ckpt_{step:010d}", "meta.json")) as f:
        return json.load(f)
