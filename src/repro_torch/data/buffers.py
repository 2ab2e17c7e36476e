"""Experience buffers (port of ``repro/data/buffers.py``).

Three kinds, registered under the registry kind ``"buffer"`` and chosen
per experiment by ``ExperimentSpec.buffer`` / ``buffer_kwargs``:

* ``fifo``: the on-policy pass-through; the latest trajectory *is* the
  buffer.
* ``uniform``: the replay ring (``data/replay.py``) with n-step returns:
  trajectories become transitions at ``add`` time, each with its own
  bootstrap factor ``discounts`` (gamma^n, or 0 past a terminal).
* ``prioritized``: proportional prioritized replay (Schaul et al., 2015)
  over a sum tree (``kernels/sum_tree``): stratified sampling by priority,
  importance weights, and per-sample priorities fed back through
  ``update_priorities``.

Buffer state lives on the device and is updated in place (ring storage,
tree); the ring's head and size are 0-dim device tensors, so ``add`` and
``sample`` read nothing on the host and a CUDA graph can capture them (the
fused engine, ``core/fused.py``). ``sample`` draws from a
``torch.Generator``; ``UniformBuffer.gather`` and
``PrioritizedBuffer.sample_with`` take the draws themselves, which tests
inject. Sampling an empty buffer raises (``replay.ensure_nonempty``).
"""
from __future__ import annotations

from typing import Any, Dict, NamedTuple, Protocol, runtime_checkable

import torch

from repro_torch import registry
from repro_torch.data import replay
from repro_torch.kernels.replay_ring import ring_gather
from repro_torch.kernels.sum_tree import (
    SumTree,
    sumtree_build,
    sumtree_find_batch,
    sumtree_update,
)


@runtime_checkable
class ExperienceBuffer(Protocol):
    """A buffer whose state the runner owns: state in, state out.

    ``kind`` is ``"trajectory"`` (the sampled batch is a whole trajectory,
    for on-policy learners) or ``"transitions"`` (flat replay minibatches,
    for off-policy learners); ``experiment.build`` checks the algorithm
    and the buffer against each other through it.
    """

    name: str
    kind: str

    def init(self, example: Any) -> Any:
        """Allocate zeroed device storage shaped like ``example``."""
        ...

    def add(self, state: Any, traj: Dict[str, torch.Tensor]) -> Any:
        """Absorb one collected trajectory batch."""
        ...

    def sample(self, state: Any, generator: torch.Generator
               ) -> Dict[str, torch.Tensor]:
        """Draw one learner batch."""
        ...

    def update_priorities(self, state: Any, indices, priorities) -> Any:
        """Feed per-sample TD errors back (no-op unless prioritized)."""
        ...


def nstep_transitions(traj: Dict[str, torch.Tensor], n_step: int,
                      gamma: float) -> Dict[str, torch.Tensor]:
    """Flatten a time-major trajectory into n-step transitions.

    Input tensors are ``(T, B, ...)`` with keys ``obs/actions/rewards/
    dones/next_obs`` (and ``staleness_w`` under staleness correction,
    which a transition takes from its first step). For each start
    ``t <= T - n`` the transition carries

        rewards    = sum_{k<n} gamma^k * r_{t+k}   (truncated at a done)
        next_obs   = next_obs_{t+n-1}
        discounts  = gamma^n if no done inside the window else 0

    The last ``n - 1`` steps have no full window and are dropped. Output
    tensors are flat ``((T-n+1)*B, ...)``."""
    T = traj["rewards"].shape[0]
    if n_step < 1 or n_step > T:
        raise ValueError(f"n_step={n_step} must be in [1, horizon={T}]")
    Tn = T - n_step + 1
    rewards = torch.zeros_like(traj["rewards"][:Tn], dtype=torch.float32)
    notdone = torch.ones_like(rewards)
    for k in range(n_step):
        rewards = rewards + (gamma ** k) * notdone * traj["rewards"][k:k + Tn]
        notdone = notdone * (1.0 - traj["dones"][k:k + Tn]
                             .to(torch.float32))
    out = {
        "obs": traj["obs"][:Tn],
        "actions": traj["actions"][:Tn],
        "rewards": rewards,
        "next_obs": traj["next_obs"][n_step - 1:n_step - 1 + Tn],
        "discounts": (gamma ** n_step) * notdone,
    }
    if "staleness_w" in traj:       # a transition's staleness weight is
        out["staleness_w"] = traj["staleness_w"][:Tn]   # its first step's
    return {k: v.reshape((-1,) + tuple(v.shape[2:])) for k, v in out.items()}


def transition_storage_example(example: Dict[str, torch.Tensor]
                               ) -> Dict[str, torch.Tensor]:
    """The stored schema of a per-transition example: ``dones`` becomes
    the per-transition ``discounts``."""
    out = {k: v for k, v in example.items() if k != "dones"}
    out.setdefault("discounts", torch.zeros(
        example["rewards"].shape, dtype=torch.float32,
        device=example["rewards"].device))
    return out


class FifoBuffer:
    """On-policy pass-through: the buffer *is* the latest trajectory.
    ``add`` replaces it and ``sample`` returns it untouched."""

    name = "fifo"
    kind = "trajectory"

    def init(self, example=None):
        """Nothing is held until the first ``add``."""
        return example

    def add(self, state, traj):
        return traj

    def sample(self, state, generator=None):
        return state

    def update_priorities(self, state, indices, priorities):
        return state


class UniformBuffer:
    """Uniform replay ring with n-step returns."""

    name = "uniform"
    kind = "transitions"

    def __init__(self, capacity: int = 50_000, batch_size: int = 128,
                 n_step: int = 1, gamma: float = 0.99):
        self.capacity = int(capacity)
        self.batch_size = int(batch_size)
        self.n_step = int(n_step)
        self.gamma = float(gamma)

    def init(self, example: Dict[str, torch.Tensor]) -> replay.ReplayState:
        return replay.init_replay(self.capacity,
                                  transition_storage_example(example))

    def add(self, state: replay.ReplayState, traj) -> replay.ReplayState:
        return replay.add_batch(state, nstep_transitions(traj, self.n_step,
                                                         self.gamma))

    def sample(self, state: replay.ReplayState, generator: torch.Generator
               ) -> Dict[str, torch.Tensor]:
        return self.gather(state, replay.sample_indices(state, generator,
                                                        self.batch_size))

    def gather(self, state: replay.ReplayState, idx: torch.Tensor
               ) -> Dict[str, torch.Tensor]:
        """The batch at slot indices ``idx``, with unit ``weights``."""
        batch = ring_gather(state.storage, idx)
        batch["indices"] = idx
        batch["weights"] = torch.ones(idx.shape[0], dtype=torch.float32,
                                      device=idx.device)
        return batch

    def update_priorities(self, state, indices, priorities):
        return state


class PrioritizedState(NamedTuple):
    ring: replay.ReplayState     # storage + write index + filled size
    tree: SumTree                # leaf i = priority_i ** alpha
    max_priority: torch.Tensor   # running max of raw priority, 0-dim


class PrioritizedBuffer:
    """Proportional prioritized replay with importance-weighted sampling.

    New transitions enter at the running max priority; ``sample`` draws
    stratified masses over the sum tree and returns ``weights``
    ``(N * P(i))^-beta / max`` plus ``indices``; learners return
    per-sample ``priorities`` (|TD error|) and the train step routes them
    into ``update_priorities``. ``capacity`` is rounded up to a power of
    two; unfilled slots carry zero mass and are never drawn."""

    name = "prioritized"
    kind = "transitions"

    def __init__(self, capacity: int = 50_000, batch_size: int = 128,
                 n_step: int = 1, gamma: float = 0.99,
                 alpha: float = 0.6, beta: float = 0.4, eps: float = 1e-6):
        self.capacity = 1 << (int(capacity) - 1).bit_length()
        self.batch_size = int(batch_size)
        self.n_step = int(n_step)
        self.gamma = float(gamma)
        self.alpha = float(alpha)
        self.beta = float(beta)
        self.eps = float(eps)

    def init(self, example: Dict[str, torch.Tensor]) -> PrioritizedState:
        ring = replay.init_replay(self.capacity,
                                  transition_storage_example(example))
        device = next(iter(example.values())).device
        tree = sumtree_build(torch.zeros(self.capacity, dtype=torch.float32,
                                         device=device))
        return PrioritizedState(ring, tree, torch.ones(
            (), dtype=torch.float32, device=device))

    def add(self, state: PrioritizedState, traj) -> PrioritizedState:
        flat = nstep_transitions(traj, self.n_step, self.gamma)
        n = flat["rewards"].shape[0]
        device = state.max_priority.device
        idx = ((torch.arange(n, device=device) + state.ring.index)
               % self.capacity).to(torch.int32)
        ring = replay.add_batch(state.ring, flat)
        tree = sumtree_update(state.tree, idx, (state.max_priority
                                                ** self.alpha).expand(n))
        return PrioritizedState(ring, tree, state.max_priority)

    def sample(self, state: PrioritizedState, generator: torch.Generator
               ) -> Dict[str, torch.Tensor]:
        return self.sample_with(state, torch.rand(
            self.batch_size, generator=generator, device=generator.device))

    def sample_with(self, state: PrioritizedState, uniforms: torch.Tensor
                    ) -> Dict[str, torch.Tensor]:
        """The batch for the stratified draw ``uniforms`` (B,) in [0, 1):
        sample i descends at mass ``(i + uniforms[i]) / B * total``."""
        replay.ensure_nonempty(state.ring)
        B = uniforms.shape[0]
        total = state.tree.total
        # divide by a tensor: ATen turns a division by a Python scalar into
        # a reciprocal multiply on the card, which rounds differently
        u = ((torch.arange(B, dtype=torch.float32, device=uniforms.device)
              + uniforms) / torch.full((), float(B),
                                       device=uniforms.device))
        idx = sumtree_find_batch(state.tree, u * total)
        # the ring's size stays on the device: no host read, so a CUDA
        # graph can capture the draw
        size = state.ring.size
        idx = torch.minimum(idx, size - 1)
        probs = state.tree.levels[0][idx] / torch.clamp(total, min=self.eps)
        weights = (size.to(torch.float32)
                   * torch.clamp(probs, min=self.eps)) ** (-self.beta)
        batch = ring_gather(state.ring.storage, idx)
        batch["indices"] = idx
        batch["weights"] = weights / torch.max(weights)
        return batch

    def update_priorities(self, state: PrioritizedState, indices,
                          priorities) -> PrioritizedState:
        p = torch.abs(priorities) + self.eps
        tree = sumtree_update(state.tree, indices, p ** self.alpha)
        return PrioritizedState(state.ring, tree,
                                torch.maximum(state.max_priority,
                                              torch.max(p)))


registry.register("buffer", "fifo", FifoBuffer)
registry.register("buffer", "uniform", UniformBuffer)
registry.register("buffer", "prioritized", PrioritizedBuffer)
