"""Checkpoint -> servable policy (port of ``repro/serve/loader.py``).

RL checkpoints record their resolved ``ExperimentSpec`` in ``meta.json``
(``launch/train.py --ckpt-dir``, in either package), so a checkpoint
directory alone names what a serving replica needs: the env (for
``obs_dim`` and the action contract), the algorithm (whose ``act()`` is the
policy head) and the params structure (``algo.init`` builds the template
the arrays restore into). ``load_policy`` resolves them through the port's
registry; any env × algo that trains can serve.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import torch

from repro_torch import checkpoint, convert, registry
from repro_torch.experiment import ExperimentSpec, resolve_device


@dataclasses.dataclass
class PolicyHandle:
    """A restored, servable policy: env + algo + params + provenance."""
    env: Any
    algo: Any
    params: Any
    spec: ExperimentSpec
    step: int
    directory: str

    @property
    def name(self) -> str:
        return f"{self.spec.algo}x{self.spec.env}@{self.step}"


def load_policy(ckpt_dir: str, step: Optional[int] = None,
                device=None) -> PolicyHandle:
    """Resolve ``ckpt_dir`` into a ``PolicyHandle`` with its params on
    ``device`` (default: cuda, which must exist).

    Raises ``FileNotFoundError`` (from ``checkpoint``) when the directory
    holds no checkpoints, and ``ValueError`` when the checkpoint records
    no spec (lm-mode checkpoints name no env or algorithm).
    """
    meta = checkpoint.load_metadata(ckpt_dir, step)
    spec_dict = meta.get("spec")
    if spec_dict is None:
        raise ValueError(
            f"checkpoint {ckpt_dir!r} (step {meta.get('step')}) records no "
            f"ExperimentSpec in its metadata (mode="
            f"{meta.get('mode', 'unknown')!r}) — only rl-mode checkpoints "
            f"written by launch/train.py are servable")
    spec = ExperimentSpec.from_dict(spec_dict)
    device = resolve_device(device)
    env = registry.make("env", spec.env, **dict(spec.env_kwargs))
    algo = registry.make("algo", spec.algo,
                         **{**dict(spec.model), **dict(spec.algo_kwargs)})
    # the template's structure and dtypes are authoritative; the restore
    # overwrites its values, so any seed builds it
    template, _ = algo.init(torch.Generator().manual_seed(0), env, "cpu")
    to_tree, from_tree = convert.PARAM_TREES[spec.algo]
    tree = checkpoint.restore(ckpt_dir, to_tree(template), step)
    return PolicyHandle(env=env, algo=algo, params=from_tree(tree, device),
                        spec=spec, step=int(meta["step"]),
                        directory=ckpt_dir)


def policy_metadata(handle: PolicyHandle) -> Dict[str, Any]:
    """JSON-safe provenance block servers attach to their stats."""
    return {
        "env": handle.spec.env,
        "algo": handle.spec.algo,
        "step": handle.step,
        "directory": handle.directory,
    }
