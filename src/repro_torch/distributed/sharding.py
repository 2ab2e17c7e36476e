"""Logical-axis sharding rules with divisibility fallback (port of
``repro/distributed/sharding.py``).

Placement policy, as in the reference (MaxText-style 2-D sharding):

* weight matrices: contracting/input dim -> FSDP axes (``pod`` + ``data``),
  output dim -> ``model`` (column-parallel); the reverse for output
  projections (row-parallel);
* batch dims of activations and trajectories -> ``pod`` + ``data`` (each
  data slice is one WALL-E sampler);
* decode KV caches: sequence dim -> ``model``; SSM states: d_inner ->
  ``model``.

Every placement goes through ``shard_axes``, which falls back to a smaller
axis set, or to replication (None), when the dim is not divisible.

The rules are pure: they read leaf names, shapes, and a mesh's
``axis_names`` and ``shape`` (axis name -> size; ``launch.mesh.LearnerMesh``
carries both). A reference ``PartitionSpec`` is written as a plain tuple
with one entry per dim: ``None``, an axis name, or a tuple of axis names
(``P()`` is ``()``). A tree is nested dicts, lists and tuples of leaves
with a ``.shape``; a path is its sequence of keys.

The rules key on the reference's leaf names and its ``(in, out)`` weight
layout. The port's ``nn.Linear`` weight is ``(out, in)``
(``convert.PARAM_TREES`` transposes every ``w``): ``reference_leaf``
names a port parameter as the reference does and ``port_leaf_dim`` maps
the rule's dim back, so the reference's dim 0 of a ``w`` is the port's
dim 1.

``shard_map_compat`` and ``to_shardings`` have no counterpart: the port's
learner runs its shards as threads of one process
(``distributed/learner.py``) and places each shard's slices itself.

The learner reads ``fsdp_leaf_dim`` (through ``port_leaf_dim``) alone.
``param_specs`` (both modes), ``batch_spec``, ``train_batch_specs`` and
``decode_state_specs`` are the plan the lowering tools read, as the
reference's ``launch/dryrun.py`` and ``launch/specs.py`` do: ROADMAP.md
item 12 derives its collective bytes from them. Until that item lands
only the tests call them, against the reference's specs.
"""
from __future__ import annotations

import math
from typing import Any, Callable, Optional, Sequence, Tuple

Spec = Tuple[Any, ...]


# ------------------------------------------------------------------ axes
def fsdp_axes(mesh) -> Tuple[str, ...]:
    return tuple(a for a in ("pod", "data") if a in mesh.axis_names)


def batch_axes(mesh) -> Tuple[str, ...]:
    return fsdp_axes(mesh)


def axes_size(mesh, axes: Sequence[str]) -> int:
    return math.prod(mesh.shape[a] for a in axes) if axes else 1


def shard_axes(size: int, axes: Sequence[str], mesh):
    """Largest prefix-reduced axis set that divides ``size`` (else None):
    a tuple of names, or one name where the set has one axis."""
    axes = tuple(axes)
    candidates = [axes]
    if len(axes) > 1:
        candidates += [axes[1:], axes[:1]]
    for cand in candidates:
        n = axes_size(mesh, cand)
        if n > 1 and size % n == 0:
            return cand if len(cand) > 1 else cand[0]
    return None


# ------------------------------------------------------------ param specs
_COLUMN = {"wq", "wk", "wv", "w1", "w3", "in_proj", "x_proj", "dt_proj",
           "router"}
_ROW = {"wo", "w2", "out_proj"}
_MODEL_VEC = {"bq", "bk", "bv", "conv_b", "dt_bias", "D"}


def _key(p) -> str:
    for attr in ("key", "name", "idx"):
        if hasattr(p, attr):
            return str(getattr(p, attr))
    return str(p)


def _shape(leaf) -> Tuple[int, ...]:
    return tuple(leaf.shape) if hasattr(leaf, "shape") else tuple(leaf)


def _param_spec(path, leaf, cfg, mesh, mode: str = "train") -> Spec:
    """mode="train": the FSDP x TP 2-D layout (optimizer state shards with
    it). mode="serve": the decode-fleet layout, contracting dim on
    ``model``."""
    names = [_key(p) for p in path]
    name = names[-1]
    shape = _shape(leaf)
    fs = fsdp_axes(mesh)
    in_layers = "layers" in names
    lead = (None,) if in_layers else ()
    dims = shape[1:] if in_layers else shape

    def fsdp(n):
        return shard_axes(n, fs, mesh)

    def model(n):
        return shard_axes(n, ("model",), mesh)

    col_in, col_out = (fsdp, model) if mode == "train" else (model, fsdp)
    row_in, row_out = (model, fsdp) if mode == "train" else (fsdp, model)

    if "embed" in names and name == "table":
        if mode == "serve":
            return (fsdp(shape[0]), model(shape[1]))
        return (model(shape[0]), fsdp(shape[1]))
    if "lm_head" in names and name == "w":
        if mode == "serve":
            return (model(shape[0]), fsdp(shape[1]))
        return (fsdp(shape[0]), model(shape[1]))
    if "value_head" in names or name == "scale" or name == "meta_tokens":
        return ()
    if name in _COLUMN and len(dims) == 2:
        return (*lead, col_in(dims[0]), col_out(dims[1]))
    if name in _ROW and len(dims) == 2:
        return (*lead, row_in(dims[0]), row_out(dims[1]))
    # MoE expert weights: D on fsdp, F on model (serve: contracting dim on
    # model)
    if name in ("w1", "w3") and len(dims) == 3:        # MoE (E, D, F)
        if mode == "serve":
            return (*lead, None, model(dims[1]), fsdp(dims[2]))
        return (*lead, None, fsdp(dims[1]), model(dims[2]))
    if name == "w2" and len(dims) == 3:                # MoE (E, F, D)
        if mode == "serve":
            return (*lead, None, fsdp(dims[1]), model(dims[2]))
        return (*lead, None, model(dims[1]), fsdp(dims[2]))
    if name == "conv_w":                               # (W, Di)
        return (*lead, None, model(dims[1]))
    if name == "A_log":                                # (Di, N)
        return (*lead, model(dims[0]), None)
    if name in _MODEL_VEC and len(dims) == 1:
        return (*lead, model(dims[0]))
    # RL MLP dense weights: the reference's ``w`` is (in, out), so the
    # contracting dim goes on the fsdp axes; biases and log_std stay
    # replicated
    if name == "w" and len(dims) == 2:
        return (*lead, col_in(dims[0]), col_out(dims[1]))
    return (*lead, *([None] * len(dims)))


def fsdp_leaf_dim(path, leaf, mesh) -> Optional[int]:
    """Which dim of this leaf the train-mode ``_param_spec`` layout puts on
    the full fsdp axis product, or None where the leaf stays replicated.

    The learner shards over all of ``("pod", "data")`` or not at all: where
    ``shard_axes`` falls back to a subset of the fsdp axes, the leaf is
    replicated, as in the plain non-divisible case."""
    fs = fsdp_axes(mesh)
    if axes_size(mesh, fs) <= 1:
        return None
    spec = _param_spec(path, leaf, None, mesh, "train")
    full = fs if len(fs) > 1 else fs[0]
    for d, entry in enumerate(spec):
        if entry == full:
            return d
    return None


def _map_with_path(fn: Callable, tree, path=()):
    if isinstance(tree, dict):
        return {k: _map_with_path(fn, v, path + (k,))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_with_path(fn, v, path + (i,))
                          for i, v in enumerate(tree))
    return fn(path, tree)


def param_specs(cfg, params_shape: Any, mesh, mode: str = "train"):
    """The spec tree matching a params tree (arrays or shape structs, as
    ``jax.eval_shape`` or ``convert``'s numpy trees give them)."""
    return _map_with_path(
        lambda path, leaf: _param_spec(path, leaf, cfg, mesh, mode),
        params_shape)


# ------------------------------------------------------------ batch specs
def batch_spec(size: int, mesh) -> Spec:
    return (shard_axes(size, batch_axes(mesh), mesh),)


def train_batch_specs(cfg, batch_shapes: dict, mesh) -> dict:
    """Specs for the PPO train batch dict (tokens/targets/... (B, S))."""
    out = {}
    for k, v in batch_shapes.items():
        shape = _shape(v)
        if k == "positions" and len(shape) == 3:       # (3, B, S) M-RoPE
            out[k] = (None, batch_spec(shape[1], mesh)[0], None)
        else:
            b = batch_spec(shape[0], mesh)[0]
            out[k] = (b, *([None] * (len(shape) - 1)))
    return out


def decode_state_specs(cfg, state_shapes: dict, mesh) -> dict:
    """Specs for the decode cache/state dict (flash-decoding layout)."""
    out = {}
    for k, v in state_shapes.items():
        shape = _shape(v)
        if k in ("k", "v"):            # (L, B, Sc, K, hd): seq -> model
            b = batch_spec(shape[1], mesh)[0]
            out[k] = (None, b, shard_axes(shape[2], ("model",), mesh),
                      None, None)
        elif k == "conv":              # (L, B, W, Di)
            b = batch_spec(shape[1], mesh)[0]
            out[k] = (None, b, None, shard_axes(shape[3], ("model",), mesh))
        elif k == "ssm":               # (L, B, Di, N)
            b = batch_spec(shape[1], mesh)[0]
            out[k] = (None, b, shard_axes(shape[2], ("model",), mesh), None)
        else:                          # pos scalar / cache_pos (Sc,)
            out[k] = (None,) * len(shape)
    return out


# ------------------------------------------------------- the port's leaves
# an nn.Linear's leaves under the reference's names: the port's ``weight``
# (out, in) is the reference's ``w`` (in, out) transposed, its ``bias``
# the reference's ``b``
PORT_LEAF_NAMES = {"weight": "w", "bias": "b"}
TRANSPOSED = frozenset({"w"})


def reference_leaf(port_name: str, shape) -> Tuple[Tuple[str, ...],
                                                   Tuple[int, ...]]:
    """A port parameter (its dotted ``named_parameters`` name and shape) as
    the reference's leaf: its path, ending in the reference's leaf name,
    and its shape in the reference's layout."""
    *head, last = port_name.split(".")
    name = PORT_LEAF_NAMES.get(last, last)
    shape = tuple(shape)
    if name in TRANSPOSED and len(shape) == 2:
        shape = shape[::-1]
    return tuple(head) + (name,), shape


def port_dim(name: str, ndim: int, ref_dim: Optional[int]
             ) -> Optional[int]:
    """The reference's dim ``ref_dim`` of a leaf named ``name`` as the
    port's dim (reversed for a transposed weight)."""
    if ref_dim is None or not (name in TRANSPOSED and ndim == 2):
        return ref_dim
    return ndim - 1 - ref_dim


def port_leaf_dim(port_name: str, shape, mesh) -> Optional[int]:
    """``fsdp_leaf_dim`` of a port parameter, applied under its reference
    name and shape, as a dim of the port's tensor."""
    path, ref_shape = reference_leaf(port_name, shape)
    return port_dim(path[-1], len(ref_shape),
                    fsdp_leaf_dim(path, ref_shape, mesh))
