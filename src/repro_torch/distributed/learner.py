"""The data-parallel learner: one controller over D lockstep shards (port
of ``repro/distributed/learner.py``: the replicated schedule, FSDP and
learner pods).

``ShardedLearner`` wraps any shardable ``Algorithm``'s composed train step
(``algos.api.make_train_step``). Its ``train_step`` has the
``(params, opt_state, plane, traj)`` signature every runner drives, so the
sync and async runtimes (and, at one shard, the fused one) take it
unchanged; ``experiment.build`` selects it when ``learner_devices > 1`` or
``learner_microbatches > 1``.

* At one shard the step is ``make_train_step``'s under
  ``grad_sync.activate(None, M)``: microbatch accumulation only, no
  threads.
* At D shards the reference's ``shard_map`` becomes D threads of this
  process, shard ``s`` on mesh device ``s`` (as ``torch.nn.DataParallel``'s
  ``parallel_apply`` runs its replicas). The trajectory is split along its
  batch axis (dim 1 for step keys, dim 0 for ``tail_keys``, the
  reference's ``_traj_spec``); each shard keeps a replica of the params
  and the optimizer state on its device and runs the algorithm's own step
  on its slice. Every gradient is averaged across shards in
  ``grad_sync.value_and_grad`` (and ``gae.normalize`` takes the global
  statistics), so the clip and the Adam update are recomputed identically
  per shard and the replicas stay equal. The metrics are averaged across
  shards, and the params handed back are the caller's, updated in place,
  on their own device (the reference's ``device_put(params,
  jax.devices()[0])``). PPO's minibatches are contiguous slices of each
  shard's flattened ``(T, B / D)`` batch, as in the reference, so the D
  shards' minibatch i together are the one-device minibatch i only where
  each slice holds whole time steps (T a multiple of the minibatch
  count); elsewhere they split the same samples otherwise.
* A transitions buffer is wrapped sharded (``replay_sharded``): per-shard
  rings and sum trees, allocated by ``self.buffer.init`` on the mesh. The
  plane's generator is replicated: each shard draws from a copy of its
  state, and the caller's generator takes shard 0's state after the step,
  as the reference replicates its sample key.

* ``fsdp=True`` stores params and optimizer moments sharded instead of
  replicated, as the reference's ``sharding.fsdp_leaf_dim`` lays them out
  (``fsdp_layout``: each port leaf under its reference name and shape,
  the dim mapped back through the ``(out, in)`` transposition). Between
  steps shard ``s``'s replica module holds only its slice of each sharded
  leaf and its moments only their slices; moments take their param's
  layout (``Algorithm.opt_groups`` pairs each optimizer state with its
  params) and the step counter stays whole. A step all-gathers the
  params at entry (``grad_sync.gather_params``), runs the algorithm's own
  step with reduce-scattered gradients and slice-wise moments, copies the
  full params into the caller's module (shard 0, the reference's device-0
  copy: the caller never sees a slice) and slices them back at exit
  (``grad_sync.shard_params``). The optimizer state handed back is a
  ``ShardedOptState``: the per-shard states, assembled into one full
  state only on request (``full()``).
* ``pods > 1`` lays the shards out as the reference's ``(pod, data,
  model)`` mesh (``launch.mesh.LearnerMesh``); shard ``s`` is mesh
  position ``s`` in row-major order, and FSDP shards over both axes.
* ``offset`` starts the mesh at that device, as the reference's overlap
  schedule asks (``offset=1``); with too few devices it moves down.

The shards meet at a ``threading.Barrier`` with a timeout; a shard that
raises aborts it, so the others stop at their next collective, and the
step raises that shard's error in the caller. Nothing waits forever and
nothing carries on with a shard missing. Where the shards are on other
devices than the caller's, the caller's current stream waits for theirs
before ``run_shards`` returns, so an event recorded there after a step
covers every shard's work; where every shard is on the caller's device
(``[cuda:0, cuda:0]``), they all issue on its one current stream.
"""
from __future__ import annotations

import copy
import threading
from typing import Any, Callable, List, Optional, Sequence

import torch

from repro_torch.algos.api import make_train_step
from repro_torch.distributed import grad_sync, sharding
from repro_torch.distributed.replay_sharded import ShardStates, shard_buffer
from repro_torch.launch.mesh import LearnerMesh, make_learner_mesh


def _device(d) -> torch.device:
    d = torch.device(d)
    if d.type == "cuda" and d.index is None:
        d = torch.device("cuda", torch.cuda.current_device())
    return d


def _module_device(module: torch.nn.Module) -> torch.device:
    return next(module.parameters()).device


def _replicate(x, device: torch.device):
    """A copy of ``x`` (a module, a tensor, or a container of them) on
    ``device`` that shares no storage with it."""
    if isinstance(x, torch.nn.Module):
        with torch.no_grad():
            return copy.deepcopy(x).to(device)
    if isinstance(x, torch.Tensor):
        return x.detach().to(device, copy=True)
    if isinstance(x, dict):
        return {k: _replicate(v, device) for k, v in x.items()}
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return type(x)(*(_replicate(v, device) for v in x))
    if isinstance(x, (list, tuple)):
        return type(x)(_replicate(v, device) for v in x)
    return x


def run_shards(devices: Sequence, fn: Callable, args: Sequence[tuple],
               microbatches: int = 1,
               timeout: float = grad_sync.DEFAULT_TIMEOUT_S,
               fsdp: Optional[grad_sync.FsdpInfo] = None) -> List[Any]:
    """``[fn(*args[s]) for s]``, shard ``s`` in a thread of its own on
    ``devices[s]`` inside ``grad_sync.activate(its Shard, microbatches,
    fsdp)``, all in lockstep at their collectives. The first shard error
    (in shard order, a failure before a broken wait) is raised here once
    every thread has ended. On the card the caller's current stream then
    waits for the shards' streams of other devices."""
    devices = [_device(d) for d in devices]
    group = grad_sync.ShardGroup(devices, timeout=timeout)
    results: List[Any] = [None] * group.size
    errors: List[Optional[BaseException]] = [None] * group.size
    grad_enabled = torch.is_grad_enabled()
    streams = [torch.cuda.current_stream(d) if d.type == "cuda" else None
               for d in devices]

    def body(s: int) -> None:
        try:
            torch.set_grad_enabled(grad_enabled)
            with grad_sync.activate(group.member(s), microbatches, fsdp):
                if streams[s] is None:
                    results[s] = fn(*args[s])
                else:
                    with torch.cuda.device(devices[s]), \
                            torch.cuda.stream(streams[s]):
                        results[s] = fn(*args[s])
        except BaseException as e:          # noqa: BLE001 - re-raised below
            errors[s] = e
            group.abort()

    threads = [threading.Thread(target=body, args=(s,), daemon=True,
                                name=f"learner-shard-{s}")
               for s in range(group.size)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    failed = [e for e in errors if e is not None]
    if failed:
        first = next((e for e in failed
                      if not isinstance(e, threading.BrokenBarrierError)),
                     None)
        if first is None:
            raise RuntimeError(
                f"a learner shard waited longer than {timeout} s at a "
                f"collective") from failed[0]
        raise first
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        here = torch.cuda.current_stream()
        for stream in {st for st in streams if st is not None}:
            if stream.device != here.device:
                here.wait_stream(stream)
    return results


class ShardedOptState(tuple):
    """An FSDP learner's optimizer state as the caller holds it: one state
    per shard, in shard order, each with its moments' slices. ``full()``
    assembles the one full state (for a checkpoint or a test), on shard
    0's device or ``device``; no step keeps it."""

    def __new__(cls, states, moment_dims):
        obj = super().__new__(cls, states)
        obj.moment_dims = moment_dims
        return obj

    def full(self, device=None):
        device = device if device is not None else _state_device(self[0])
        per_shard = [_opt_states(st) for st in self]

        def assemble(d, xs):
            if d is None:                     # whole on every shard
                return xs[0].to(device, copy=True)
            return torch.cat([x.to(device) for x in xs], d)

        out = [_zip_moments([states[k] for states in per_shard], dims,
                            assemble)
               for k, dims in enumerate(self.moment_dims)]
        return _rebuild_opt(self[0], out)


def _state_device(opt_state) -> torch.device:
    for st in _opt_states(opt_state):
        for v in st:
            if isinstance(v, torch.Tensor):
                return v.device
    return torch.device("cpu")


def _opt_states(opt_state) -> List[Any]:
    """An optimizer state as its list of per-group states (a tuple of
    them, or one)."""
    if opt_state is None:
        return []
    if isinstance(opt_state, tuple) and not hasattr(opt_state, "_fields"):
        return list(opt_state)
    return [opt_state]


def _rebuild_opt(like, states):
    if isinstance(like, tuple) and not hasattr(like, "_fields"):
        return tuple(states)
    return states[0]


def _zip_moments(states, dims, fn):
    """One state built from ``states`` (the same group's state on each
    shard, or one): each per-parameter list (a field as long as ``dims``)
    leaf by leaf as ``fn(dim, that leaf of every state)``, a tensor field
    (the step counter) as ``fn(None, ...)``, anything else as the first
    state's."""
    first = states[0]
    out = []
    for i, v in enumerate(first):
        vs = [st[i] for st in states]
        if isinstance(v, (list, tuple)) and len(v) == len(dims) and all(
                isinstance(x, torch.Tensor) for x in v):
            out.append(type(v)(fn(d, [u[j] for u in vs])
                               for j, d in enumerate(dims)))
        elif isinstance(v, torch.Tensor):
            out.append(fn(None, vs))
        else:
            out.append(v)
    return type(first)(*out)


def _slice(x: torch.Tensor, dim: Optional[int], rank: int, n: int):
    if dim is None:
        return x
    local = x.shape[dim] // n
    return x.narrow(dim, rank * local, local).clone()


def _local_shape(shape: tuple, dim: int, n: int) -> tuple:
    return shape[:dim] + (shape[dim] // n,) + shape[dim + 1:]


class ShardedLearner:
    """Builds and owns the sharded train step.

    ``train_step`` is a drop-in for ``make_train_step(algo, buffer)``;
    ``buffer`` (wrapped sharded at D > 1) must allocate the plane. ``mesh``
    (a list of devices, or a ``LearnerMesh``) overrides
    ``make_learner_mesh(num_devices, pods, offset)``, the first
    ``num_devices`` CUDA devices from ``offset``; two entries may name one
    device. ``fsdp`` and ``pods`` as the reference's (the module
    docstring)."""

    def __init__(self, algo, buffer, num_devices: int = 1,
                 microbatches: int = 1, mesh: Optional[Sequence] = None,
                 fsdp: bool = False, pods: int = 1, offset: int = 0):
        self.algo = algo
        self.microbatches = max(1, int(microbatches))
        if mesh is None and num_devices > 1:
            mesh = make_learner_mesh(num_devices, pods=pods, offset=offset)
        if mesh:
            devices = [_device(d) for d in mesh]
            mesh = (LearnerMesh(devices, mesh.axis_names,
                                tuple(mesh.shape.values()))
                    if isinstance(mesh, LearnerMesh)
                    else LearnerMesh.of(devices, pods))
        self.mesh = mesh or None
        self.num_shards = len(self.mesh) if self.mesh else 1
        self.fsdp = bool(fsdp) and self.num_shards > 1
        if self.num_shards > 1 and not getattr(algo, "shardable", False):
            raise ValueError(
                f"algorithm {getattr(algo, 'name', algo)!r} does not "
                f"support the sharded learner (shardable=False)")
        if self.num_shards > 1:
            self.buffer = shard_buffer(buffer, self.num_shards, self.mesh)
        else:
            self.buffer = buffer
        self._step = make_train_step(algo, self.buffer)
        # the caller's (params, opt_state) the replicas were last left
        # equal to; anything else handed in is replicated afresh
        self._held = None
        self._params: List[Any] = []
        self._opt: List[Any] = []
        self._generators: List[torch.Generator] = []
        self._fsdp_info: Optional[grad_sync.FsdpInfo] = None
        self._moment_dims: List[List[Optional[int]]] = []

    # -------------------------------------------------------------- split
    def _split_traj(self, traj):
        """Shard ``s``'s slice of each leaf, on its device: batch dim 1 for
        step keys, 0 for ``tail_keys``."""
        d = self.num_shards
        tail = set(getattr(self.algo, "tail_keys", ()) or ())
        parts = [{} for _ in range(d)]
        for k, x in traj.items():
            dim = 0 if k in tail else 1
            if x.dim() <= dim or x.shape[dim] % d:
                raise ValueError(
                    f"trajectory leaf {k!r} {tuple(x.shape)}: its batch dim "
                    f"{dim} must divide evenly over {d} learner shards")
            for s, part in enumerate(torch.chunk(x, d, dim=dim)):
                parts[s][k] = part.to(self.mesh[s]).contiguous()
        return parts

    # -------------------------------------------------------- FSDP layout
    def fsdp_layout(self, params) -> dict:
        """``(reference leaf name, full port shape) -> port storage dim``
        for every sharded leaf of ``params`` (a module): the reference's
        ``fsdp_leaf_dim`` of each leaf under its reference name and shape
        (``sharding.reference_leaf``), the dim mapped back to the port's
        layout, with the reference's two degradations:

        * two leaves sharing ``(name, shape)`` but resolving to different
          dims are both replicated;
        * a sharded leaf whose local key would collide with a replicated
          leaf's key is replicated instead."""
        entries = {}
        n = self.num_shards
        for pname, p in params.named_parameters():
            key = (sharding.reference_leaf(pname, p.shape)[0][-1],
                   tuple(p.shape))
            dim = sharding.port_leaf_dim(pname, p.shape, self.mesh)
            if key in entries and entries[key] != dim:
                dim = None      # conflicting rules: replicate
            entries[key] = dim
        changed = True
        while changed:
            changed = False
            repl = {k for k, d in entries.items() if d is None}
            for (name, shape), dim in list(entries.items()):
                if dim is not None and (
                        name, _local_shape(shape, dim, n)) in repl:
                    entries[(name, shape)] = None
                    changed = True
        return {k: d for k, d in entries.items() if d is not None}

    def _fsdp_tables(self, params) -> grad_sync.FsdpInfo:
        full = self.fsdp_layout(params)
        local = {(nm, _local_shape(shp, d, self.num_shards)): d
                 for (nm, shp), d in full.items()}
        return grad_sync.FsdpInfo(size=self.num_shards, full_table=full,
                                  local_table=local)

    def _moment_layout(self, params, opt_state) -> List[List[Optional[int]]]:
        """Each optimizer state's per-parameter storage dims: its group's
        params' (``algo.opt_groups``), by the params' reference names and
        shapes."""
        names = {id(p): n for n, p in params.named_parameters()}
        groups = self.algo.opt_groups(params)
        states = _opt_states(opt_state)
        if len(groups) != len(states):
            raise ValueError(f"{len(states)} optimizer states for "
                             f"{len(groups)} parameter groups")
        out = []
        for group in groups:
            tensors = (list(group.parameters())
                       if isinstance(group, torch.nn.Module) else list(group))
            out.append([self._fsdp_info.full_table.get(
                (sharding.reference_leaf(names[id(t)], t.shape)[0][-1],
                 tuple(t.shape))) for t in tensors])
        return out

    # ----------------------------------------------------------- replicas
    def _replicas(self, params, opt_state):
        held = self._held
        if held is not None and params is held[0] and opt_state is held[1]:
            return
        if isinstance(opt_state, ShardedOptState):
            opt_state = opt_state.full()
        if not self.fsdp:
            on0 = _module_device(params) == self.mesh[0]
            self._params = [params if s == 0 and on0
                            else _replicate(params, dev)
                            for s, dev in enumerate(self.mesh)]
            self._opt = [_replicate(opt_state, dev) for dev in self.mesh]
            return
        self._fsdp_info = self._fsdp_tables(params)
        self._moment_dims = self._moment_layout(params, opt_state)
        d, full_table = self.num_shards, self._fsdp_info.full_table
        self._params, self._opt = [], []
        for s, dev in enumerate(self.mesh):
            with torch.no_grad():
                module = copy.deepcopy(params)
                for pname, p in module.named_parameters():
                    dim = full_table.get((sharding.reference_leaf(
                        pname, p.shape)[0][-1], tuple(p.shape)))
                    p.data = _slice(p.data, dim, s, d)
            self._params.append(module.to(dev))
            states = [_zip_moments([st], dims, lambda dim, xs, s=s, dev=dev:
                                   _slice(xs[0], dim, s, d).to(
                                       dev, copy=dim is None))
                      for st, dims in zip(_opt_states(opt_state),
                                          self._moment_dims)]
            self._opt.append(_rebuild_opt(opt_state, states)
                             if states else opt_state)

    def _plane_generators(self, generator: torch.Generator):
        if not self._generators:
            self._generators = [torch.Generator(device=dev)
                                for dev in self.mesh]
        state = generator.get_state()
        for g in self._generators:
            g.set_state(state)
        return self._generators

    def shard_bytes(self) -> List[int]:
        """The bytes each shard stores between steps for its params and
        its optimizer state (moments and step counter)."""
        out = []
        for module, opt in zip(self._params, self._opt):
            n = sum(p.numel() * p.element_size() for p in module.parameters())
            for st in _opt_states(opt):
                for v in st:
                    for x in (v if isinstance(v, (list, tuple)) else [v]):
                        if isinstance(x, torch.Tensor):
                            n += x.numel() * x.element_size()
            out.append(n)
        return out

    # --------------------------------------------------------------- step
    def _shard_step(self, params, opt_state, buf_state, generator, traj,
                    caller=None):
        fsdp = grad_sync.fsdp_active() is not None
        if fsdp:
            # the entry all-gather: the algorithm sees full params (target
            # nets, polyak, forward passes); the moments stay slices
            grad_sync.gather_params(params)
        params, opt_state, (buf_state, _), metrics = self._step(
            params, opt_state, (buf_state, generator), traj)
        if fsdp:
            if caller is not None:
                _copy_params(caller, params)
            grad_sync.shard_params(params)
        # scalar diagnostics; per-sample priorities were consumed inside
        # the step by update_priorities
        keys = sorted(metrics)
        means = grad_sync.pmean([metrics[k] for k in keys])
        return params, opt_state, buf_state, dict(zip(keys, means))

    def train_step(self, params, opt_state, plane, traj):
        if self.num_shards <= 1:
            # microbatch accumulation only: no threads, no collectives
            with grad_sync.activate(None, self.microbatches):
                return self._step(params, opt_state, plane, traj)
        buf_state, generator = plane
        d = self.num_shards
        states = (buf_state if isinstance(buf_state, ShardStates)
                  else [buf_state] * d)      # fifo: the state is replaced
        self._replicas(params, opt_state)
        self._held = None                    # until the step has ended
        gens = self._plane_generators(generator)
        trajs = self._split_traj(traj)
        outs = run_shards(
            self.mesh, self._shard_step,
            [(self._params[s], self._opt[s], states[s], gens[s], trajs[s],
              params if self.fsdp and s == 0 else None)
             for s in range(d)],
            microbatches=self.microbatches,
            fsdp=self._fsdp_info if self.fsdp else None)
        self._params = [o[0] for o in outs]
        self._opt = [o[1] for o in outs]
        generator.set_state(gens[0].get_state())
        if not self.fsdp and self._params[0] is not params:
            _copy_params(params, self._params[0])
        opt_out = (ShardedOptState(self._opt, self._moment_dims)
                   if self.fsdp else self._opt[0])
        self._held = (params, opt_out)
        new_states = [o[2] for o in outs]
        new_buf = (ShardStates(new_states)
                   if isinstance(buf_state, ShardStates) else new_states[0])
        return params, opt_out, (new_buf, generator), outs[0][3]


def _copy_params(dst: torch.nn.Module, src: torch.nn.Module) -> None:
    """``dst``'s params and buffers take ``src``'s values, in place."""
    with torch.no_grad():
        for a, b in zip(dst.parameters(), src.parameters()):
            a.copy_(b)
        for a, b in zip(dst.buffers(), src.buffers()):
            a.copy_(b)
