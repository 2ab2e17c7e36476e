"""Serving entry point: batched autoregressive generation (port of
``repro/launch/serve.py``).

Random weights from ``--seed`` (no checkpoint is loaded), random prompts,
``--requests`` rounds of prefill plus ``--gen-len`` decode steps, one line
per request and then one JSON line with the kernel launch counts. Runs on
the CUDA device unless ``--device cpu`` is given:

  PYTHONPATH=src python -m repro_torch.launch.serve --arch hymba-1.5b \\
      --batch 4 --prompt-len 16 --gen-len 32 --requests 3 \\
      [--kernels {ref,cuda,auto,pallas}] [--device cpu]

``--kernels cuda`` (the default, also spelt ``auto`` or ``pallas``) runs
the flash-attention, decode-attention and selective-scan kernels on the
card; ``ref`` the model's plain PyTorch paths. Matmuls run in full
float32 where the model is float32 (TF32 off).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import time
from typing import List, Optional, Tuple

import torch

from repro_torch import kernels
from repro_torch.configs import get_config
from repro_torch.core.timing import synchronize
from repro_torch.envs import lm_env
from repro_torch.experiment import resolve_device
from repro_torch.kernels import select
from repro_torch.models import transformer
from repro_torch.serve import sampling


@torch.no_grad()
def generate(cfg, params: transformer.LM, prompt: torch.Tensor, gen_len: int,
             generator: Optional[torch.Generator] = None,
             temperature: float = 1.0,
             noise: Optional[sampling.NoiseSource] = None
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Prefill ``prompt`` (B, P) and sample ``gen_len`` tokens, each from
    the logits before it, with Gumbel noise from ``noise`` or else from
    ``generator``. Returns (tokens (B, gen_len), the logits they were drawn
    from (B, gen_len, V) f32). As in the reference, the state takes
    ``gen_len`` decode steps: the last one's logits go unused."""
    if noise is None:
        if generator is None:
            raise ValueError("generate needs a generator or a noise source")
        noise = sampling.gumbel_source(generator)
    state, logits = transformer.prefill(cfg, params, prompt,
                                        gen_budget=gen_len)
    toks, seen = [], []
    for _ in range(gen_len):
        tok = sampling.sample(logits, noise, temperature)
        toks.append(tok)
        seen.append(logits)
        state, logits = transformer.decode_step(cfg, params, state,
                                                tok[:, None])
    return torch.stack(toks, 1), torch.stack(seen, 1)


@dataclasses.dataclass
class RequestRun:
    prompt: torch.Tensor            # (B, P)
    tokens: torch.Tensor            # (B, gen_len)
    logits: torch.Tensor            # (B, gen_len, V) f32
    seconds: float


@dataclasses.dataclass
class ServeRun:
    cfg: object
    params: transformer.LM
    requests: List[RequestRun]


def main(argv=None) -> ServeRun:
    """Parse ``argv``, serve, print; returns the run (weights, prompts,
    tokens and logits stay readable)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="hymba-1.5b-reduced")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--gen-len", type=int, default=32)
    ap.add_argument("--requests", type=int, default=3)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--kernels", default="auto",
                    choices=select.MODES + tuple(select.ALIASES),
                    help="'cuda' (or 'auto', 'pallas'): the CUDA kernels "
                         "on a CUDA device; 'ref': the plain PyTorch paths")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda, which must exist)")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = get_config(args.arch)
    previous = select.set_kernel_mode(args.kernels)
    try:
        gen = torch.Generator(device=device).manual_seed(args.seed)
        params = transformer.init_params(cfg, gen)
        env = lm_env.make(cfg.vocab_size, episode_len=args.gen_len,
                          device=device)
        runs = []
        for r in range(args.requests):
            prompt = torch.randint(0, cfg.vocab_size,
                                   (args.batch, args.prompt_len),
                                   generator=gen, device=device)
            t0 = time.perf_counter()
            toks, logits = generate(cfg, params, prompt, args.gen_len, gen)
            synchronize(device)
            dt = time.perf_counter() - t0
            rew = env.token_rewards(toks).sum(dim=1)
            tps = args.batch * args.gen_len / dt
            print(f"request {r}: {toks.shape[1]} tokens x {toks.shape[0]} "
                  f"seqs in {dt:.2f}s ({tps:.0f} tok/s), "
                  f"mean reward {float(rew.mean()):.2f}", flush=True)
            runs.append(RequestRun(prompt, toks, logits, dt))
        print(json.dumps({"kernel_launches": kernels.launch_counts()}),
              flush=True)
    finally:
        select.set_kernel_mode(previous)
    return ServeRun(cfg, params, runs)


if __name__ == "__main__":
    main()
