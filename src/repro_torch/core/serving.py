"""Batched token serving with a request queue (port of
``repro/core/serving.py``).

A bounded request queue feeds a fixed-width slot batch; one
``decode_step`` advances all slots together; a slot that hits EOS stops
emitting (its tail steps are wasted work, counted in the stats).
Scheduling is wave-based, as in the reference: a new wave is admitted when
the current one finishes, since the decode state keeps one shared position
counter. The padding, EOS and waste accounting and the ``snapshot()``
schema are the reference's.

Sampling is Gumbel-max with noise from the server's ``torch.Generator``
(seeded ``seed``) or from a caller's ``noise`` source
(``serve.sampling``).
"""
from __future__ import annotations

import dataclasses
import queue
import time
from typing import Any, List, Optional

import torch

from repro_torch.models import transformer
from repro_torch.serve import sampling
from repro_torch.serve.stats import ServingStats


@dataclasses.dataclass
class Request:
    request_id: int
    prompt: Any                     # (prompt_len,) integer tokens
    max_new_tokens: int
    enqueue_time: float = dataclasses.field(default_factory=time.perf_counter)


@dataclasses.dataclass
class Completion:
    request_id: int
    tokens: List[int]
    latency: float
    queue_wait: float


class SlotServer:
    """Fixed-width, wave-scheduled batch server over ``decode_step``, on
    the device of ``params``."""

    def __init__(self, cfg, params: transformer.LM, *, slots: int,
                 prompt_len: int, max_new_tokens: int,
                 eos_id: Optional[int] = None, seed: int = 0,
                 noise: Optional[sampling.NoiseSource] = None):
        self.cfg = cfg
        self.params = params
        self.slots = slots
        self.prompt_len = prompt_len
        self.budget = max_new_tokens
        self.eos_id = eos_id
        self.queue: "queue.Queue[Request]" = queue.Queue()
        self.completions: List[Completion] = []
        # the shared serving-stats schema (serve/stats.py);
        # wasted_slot_steps (EOS'd/padded slots riding out the wave) lives
        # here
        self.stats = ServingStats(slots=slots)
        self.decode_steps = 0
        self.device = params.embed.table.device
        self._noise = noise or sampling.gumbel_source(
            torch.Generator(device=self.device).manual_seed(seed))

    def submit(self, req: Request) -> None:
        if tuple(req.prompt.shape) != (self.prompt_len,):
            raise ValueError(f"prompt must be left-padded to "
                             f"{self.prompt_len}; got shape "
                             f"{tuple(req.prompt.shape)}")
        self.queue.put(req)

    # ------------------------------------------------------------- wave
    def _run_wave(self, wave: List[Request]) -> None:
        pad = self.slots - len(wave)
        prompts = torch.stack(
            [torch.as_tensor(r.prompt, dtype=torch.int64, device=self.device)
             for r in wave]
            + [torch.zeros(self.prompt_len, dtype=torch.int64,
                           device=self.device)] * pad)
        start = time.perf_counter()
        state, logits = transformer.prefill(self.cfg, self.params, prompts,
                                            gen_budget=self.budget)
        tokens = sampling.sample(logits, self._noise)[:, None]

        emitted: List[List[int]] = [[] for _ in wave]
        done = [False] * len(wave)
        budget = min(self.budget, max(r.max_new_tokens for r in wave))
        for _ in range(budget):
            # occupancy accounting: a slot emitting this step is occupied;
            # already-EOS'd slots riding out the wave and the padded tail
            # accrue wasted_slot_steps (a slot emitting its final token
            # this step still counts as occupied)
            self.stats.observe_batch(len(wave) - sum(done))
            host = tokens[:, 0].tolist()
            for i, req in enumerate(wave):
                if done[i]:
                    continue
                emitted[i].append(host[i])
                if (len(emitted[i]) >= req.max_new_tokens
                        or (self.eos_id is not None
                            and host[i] == self.eos_id)):
                    done[i] = True
            if all(done):
                break
            state, logits = transformer.decode_step(self.cfg, self.params,
                                                    state, tokens)
            tokens = sampling.sample(logits, self._noise)[:, None]
            self.decode_steps += 1
        now = time.perf_counter()
        for i, req in enumerate(wave):
            self.completions.append(Completion(
                request_id=req.request_id,
                tokens=emitted[i],
                latency=now - start,
                queue_wait=start - req.enqueue_time,
            ))
            # shared-schema latency is end-to-end (enqueue -> done);
            # Completion.latency stays wave-relative
            self.stats.observe(latency_s=now - req.enqueue_time,
                               queue_wait_s=start - req.enqueue_time)

    @property
    def wasted_slot_steps(self) -> int:
        """EOS'd/padded slot-steps, kept by the shared stats."""
        return self.stats.wasted_slot_steps

    def snapshot(self) -> dict:
        """The serving-stats schema (``serve/stats.py``): p50/p99 latency,
        queue wait, batch occupancy and ``wasted_slot_steps``."""
        return self.stats.snapshot()

    # -------------------------------------------------------------- run
    def run(self) -> List[Completion]:
        """Serve until the queue is drained."""
        while True:
            wave: List[Request] = []
            while len(wave) < self.slots:
                try:
                    wave.append(self.queue.get_nowait())
                except queue.Empty:
                    break
            if not wave:
                break
            self._run_wave(wave)
        return self.completions
