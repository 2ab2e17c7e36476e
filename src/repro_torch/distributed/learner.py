"""The data-parallel learner: one controller over D lockstep shards (port
of ``repro/distributed/learner.py``, its replicated schedule).

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

The shards meet at a ``threading.Barrier`` with a timeout; a shard that
raises aborts it, so the others stop at their next collective, and the
step raises that shard's error in the caller. Nothing waits forever and
nothing carries on with a shard missing.
"""
from __future__ import annotations

import copy
import threading
from typing import Any, Callable, List, Optional, Sequence

import torch

from repro_torch.algos.api import make_train_step
from repro_torch.distributed import grad_sync
from repro_torch.distributed.replay_sharded import ShardStates, shard_buffer
from repro_torch.launch.mesh import make_learner_mesh


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
               timeout: float = grad_sync.DEFAULT_TIMEOUT_S) -> List[Any]:
    """``[fn(*args[s]) for s]``, shard ``s`` in a thread of its own on
    ``devices[s]`` inside ``grad_sync.activate(its Shard, microbatches)``,
    all in lockstep at their collectives. The first shard error (in shard
    order, a failure before a broken wait) is raised here once every
    thread has ended."""
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
            with grad_sync.activate(group.member(s), microbatches):
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
    return results


class ShardedLearner:
    """Builds and owns the sharded train step.

    ``train_step`` is a drop-in for ``make_train_step(algo, buffer)``;
    ``buffer`` (wrapped sharded at D > 1) must allocate the plane. ``mesh``
    (a list of devices) overrides ``make_learner_mesh(num_devices)``, the
    first ``num_devices`` CUDA devices; two entries may name one
    device."""

    def __init__(self, algo, buffer, num_devices: int = 1,
                 microbatches: int = 1, mesh: Optional[Sequence] = None):
        self.algo = algo
        self.microbatches = max(1, int(microbatches))
        if mesh is None and num_devices > 1:
            mesh = make_learner_mesh(num_devices)
        self.mesh = [_device(d) for d in mesh] if mesh else None
        self.num_shards = len(self.mesh) if self.mesh else 1
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

    def _replicas(self, params, opt_state):
        held = self._held
        if held is not None and params is held[0] and opt_state is held[1]:
            return
        on0 = _module_device(params) == self.mesh[0]
        self._params = [params if s == 0 and on0 else _replicate(params, dev)
                        for s, dev in enumerate(self.mesh)]
        self._opt = [_replicate(opt_state, dev) for dev in self.mesh]

    def _plane_generators(self, generator: torch.Generator):
        if not self._generators:
            self._generators = [torch.Generator(device=dev)
                                for dev in self.mesh]
        state = generator.get_state()
        for g in self._generators:
            g.set_state(state)
        return self._generators

    # --------------------------------------------------------------- step
    def _shard_step(self, params, opt_state, buf_state, generator, traj):
        params, opt_state, (buf_state, _), metrics = self._step(
            params, opt_state, (buf_state, generator), traj)
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
            [(self._params[s], self._opt[s], states[s], gens[s], trajs[s])
             for s in range(d)],
            microbatches=self.microbatches)
        self._params = [o[0] for o in outs]
        self._opt = [o[1] for o in outs]
        generator.set_state(gens[0].get_state())
        if self._params[0] is not params:
            with torch.no_grad():
                for dst, src in zip(params.parameters(),
                                    self._params[0].parameters()):
                    dst.copy_(src)
                for dst, src in zip(params.buffers(),
                                    self._params[0].buffers()):
                    dst.copy_(src)
        self._held = (params, self._opt[0])
        new_states = [o[2] for o in outs]
        new_buf = (ShardStates(new_states)
                   if isinstance(buf_state, ShardStates) else new_states[0])
        return params, self._opt[0], (new_buf, generator), outs[0][3]
