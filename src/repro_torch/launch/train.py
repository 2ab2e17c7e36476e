"""End-to-end training entry point (port of ``repro/launch/train.py``).

``--mode rl`` (the default) builds an ``ExperimentSpec`` from the flags and
runs it through ``repro_torch.experiment.run``, printing one JSON
``IterationLog`` per line. ``--mode lm`` trains a sequence-model policy
with token-level PPO on random batches (``run_lm``). Runs on the CUDA
device unless ``--device cpu`` is given; rollout workers (``--backend
process``) take the same device.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.train --mode rl --env cheetah \
      --algo ppo --num-samplers 10 --global-batch 160 --horizon 125 \
      --iterations 3 [--env-batch 4096] [--kernels {ref,cuda,auto}] \
      [--device cpu]
  PYTHONPATH=src python -m repro_torch.launch.train --env cheetah \
      --algo {sac,ddpg} --buffer prioritized --num-samplers 10 \
      --global-batch 160 --horizon 125 --replay-capacity 1000000 \
      --replay-batch 256 [--n-step 3] [--device cpu]
  PYTHONPATH=src python -m repro_torch.launch.train --env cheetah \
      --backend {threaded,process} [--num-workers 10] \
      [--async [--min-batches-per-update 10]] \
      [--staleness {off,decay,vtrace} [--staleness-decay 0.9]] \
      [--inject-faults kill:0.2,torn:0.05] [--max-respawns 3] \
      [--min-workers 2 --max-workers 8] [--device cpu]
  PYTHONPATH=src python -m repro_torch.launch.train --env cheetah \
      --algo {ppo,trpo,sac,ddpg} --backend fused --global-batch 160 \
      --horizon 125 --iterations 40 [--chunk 10] [--device cpu]
  PYTHONPATH=src python -m repro_torch.launch.train --env cheetah \
      --backend {inline,threaded,process,fused} --overlap [--device cpu]
  PYTHONPATH=src python -m repro_torch.launch.train --env pendulum \
      --algo ppo --iterations 5 --ckpt-dir /tmp/ckpt [--device cpu]
  PYTHONPATH=src python -m repro_torch.launch.train --env cheetah \
      --algo {ppo,sac,ddpg} [--learner-devices 2] \
      [--learner-microbatches 2] [--fsdp] [--learner-pods 2] [--device cpu]
  PYTHONPATH=src python -m repro_torch.launch.train --env cheetah \
      --backend sharded [--device cpu]

``--backend fused`` is the fused runtime: one carry of ``--global-batch``
envs (or ``--env-batch``), each collect -> learn iteration one CUDA-graph
replay on the card, ``--chunk`` iterations between host syncs (default:
all of them).

``--mode lm`` (the reference's ``run_lm``): ``init_params`` of ``--arch``
(default ``mixtral-8x7b-reduced``) from ``--seed``, Adam at ``--lr``
(default 3e-4) with moments in the config's dtype, then ``--steps`` PPO
steps, each on a fresh random ``--batch`` × ``--seq-len`` batch drawn on
the device (frontend archs get zero embeds); one ``step i: loss=... (s)``
line a step. The model trains on its plain paths (the CUDA kernels have
no backward):

  PYTHONPATH=src python -m repro_torch.launch.train --mode lm \
      --arch hymba-1.5b --batch 2 --seq-len 64 --steps 3 [--device cpu] \
      [--ckpt-dir /tmp/lm]

``--ckpt-dir D`` saves the run's params at step ``--iterations`` (only the
params, never the optimizer state) with ``{"mode": "rl", "spec": ...}`` as
metadata, in the format both packages read: ``python -m
repro_torch.launch.serve_policy --ckpt D`` serves it, and so does the
reference's ``repro.launch.serve_policy``.

``--learner-devices D`` trains data-parallel over D devices (the sync and
async runtimes; D lockstep shard threads of this process, gradients
averaged across them, a sharded replay for SAC and DDPG), and
``--learner-microbatches M`` accumulates each loss's gradient over M
slices of its batch (every runtime). ``--fsdp`` stores the params and
Adam moments sharded across the D shards (the reference's ``_param_spec``
layout), ``--learner-pods P`` lays the shards out as a ``(pod, data,
model)`` mesh; both need D > 1. On the CPU the environment variable
``REPRO_TORCH_HOST_DEVICES`` sets how many learner devices may be asked
for (default 1); on the card, ``torch.cuda.device_count()``.

``--backend sharded`` collects with one sampler per visible device (the
same variable on the CPU): the global env batch split over them, each
shard's act and env step launched once a step.

``--overlap`` (sync and fused runtimes): after two serial iterations,
iteration k+1's collect runs while iteration k's learn does, with the
params that learn starts from (``staleness`` 1.0 on the iteration that
consumes it; ``overlap_saved_s`` the learn seconds hidden). On the card the
two halves run on two CUDA streams; the fused runtime replays a collect
graph and a learn graph, and ignores ``--chunk``.

Algos: ``ppo`` and ``trpo`` (on-policy, the ``fifo`` buffer), ``sac`` and
``ddpg`` (replay, ``uniform`` or ``prioritized``). Envs: ``pendulum``,
``cartpole`` and ``cheetah``.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import time
from typing import Any, Dict, List

import torch

from repro_torch import checkpoint, convert, experiment
from repro_torch.algos.ppo import PPOConfig, make_lm_train_step
from repro_torch.algos.staleness import MODES as STALENESS_MODES
from repro_torch.configs import get_config
from repro_torch.core.timing import synchronize
from repro_torch.experiment import ExperimentSpec, Schedule
from repro_torch.kernels.select import ALIASES, MODES
from repro_torch.models import transformer
from repro_torch.optim import adam


def spec_from_args(args) -> ExperimentSpec:
    """Resolve the flags into an ``ExperimentSpec``, normalising backend
    and runtime as the reference does: ``--async`` selects the async
    runtime on sampler threads unless ``--backend process`` was asked for,
    and ``--backend fused`` names the fused runtime."""
    runtime = ("async" if args.async_mode
               else "fused" if args.backend == "fused" else "sync")
    backend = ("inline" if args.backend == "fused"
               else "threaded" if args.async_mode
               and args.backend != "process" else args.backend)
    staleness = None
    if args.staleness != "off":
        staleness = {"mode": args.staleness}
        if args.staleness_decay is not None:
            staleness["decay"] = args.staleness_decay
    # only the buffer settings the user set reach the spec, so each buffer
    # kind's own defaults apply
    buffer_kwargs = {k: v for k, v in [
        ("capacity", args.replay_capacity),
        ("batch_size", args.replay_batch),
        ("n_step", args.n_step),
    ] if v is not None}
    return ExperimentSpec(
        env=args.env,
        algo=args.algo,
        backend=backend,
        runtime=runtime,
        buffer=args.buffer,
        kernels=args.kernels,
        model={"hidden": args.hidden},
        algo_kwargs={} if args.lr is None else {"lr": args.lr},
        buffer_kwargs=buffer_kwargs,
        staleness=staleness,
        faults=args.inject_faults,
        schedule=Schedule(
            num_samplers=args.num_samplers,
            global_batch=args.global_batch,
            horizon=args.horizon,
            iterations=args.iterations,
            seed=args.seed,
            num_workers=args.num_workers,
            min_batches_per_update=args.min_batches_per_update,
            env_batch=args.env_batch,
            chunk=args.chunk,
            overlap=args.overlap,
            learner_devices=args.learner_devices,
            learner_microbatches=args.learner_microbatches,
            fsdp=args.fsdp,
            learner_pods=args.learner_pods,
            max_respawns=args.max_respawns,
            min_workers=args.min_workers,
            max_workers=args.max_workers,
        ),
    )


def run_rl(args) -> experiment.ExperimentResult:
    spec = spec_from_args(args)
    result = experiment.run(spec, device=args.device)
    for log in result.logs:
        print(json.dumps(log.as_dict()), flush=True)
    if args.ckpt_dir:
        to_tree, _ = convert.PARAM_TREES[spec.algo]
        checkpoint.save(args.ckpt_dir, args.iterations,
                        to_tree(result.params),
                        metadata={"mode": "rl", "spec": spec.to_dict()})
    return result


@dataclasses.dataclass
class LMTrainRun:
    """What ``--mode lm`` leaves readable: the model, the optimizer state,
    each step's metrics (floats) and seconds."""
    cfg: Any
    params: transformer.LM
    opt_state: Any
    metrics: List[Dict[str, float]]
    seconds: List[float]


def lm_batch(cfg, B: int, S: int, generator: torch.Generator
             ) -> Dict[str, torch.Tensor]:
    """One random training batch on the generator's device, as the
    reference's ``run_lm`` makes it: it draws tokens and targets from one
    key (so they are equal) and advantages and returns from one key (so
    are they); behaviour logp -5, mask 1, zero frontend embeds."""
    device = generator.device
    tokens = torch.randint(0, cfg.vocab_size, (B, S), generator=generator,
                           device=device)
    normal = torch.randn((B, S), generator=generator, device=device)
    batch = {"tokens": tokens, "targets": tokens,
             "behavior_logp": -torch.ones((B, S), device=device) * 5.0,
             "advantages": normal, "returns": normal,
             "mask": torch.ones((B, S), device=device)}
    if cfg.frontend_embeds:
        batch["extra_embeds"] = torch.zeros(
            (B, cfg.frontend_embeds, cfg.d_model),
            dtype=getattr(torch, cfg.dtype), device=device)
    return batch


def run_lm(args) -> LMTrainRun:
    device = experiment.resolve_device(args.device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = get_config(args.arch)
    lr = args.lr if args.lr is not None else 3e-4
    params = transformer.init_params(
        cfg, torch.Generator(device=device).manual_seed(args.seed))
    opt = adam(lr, moment_dtype=cfg.dtype)
    opt_state = opt.init(list(params.parameters()))
    step = make_lm_train_step(cfg, opt, PPOConfig(lr=lr))
    data = torch.Generator(device=device).manual_seed(args.seed + 1)
    run = LMTrainRun(cfg, params, opt_state, [], [])
    for i in range(args.steps):
        batch = lm_batch(cfg, args.batch, args.seq_len, data)
        t0 = time.perf_counter()
        params, run.opt_state, metrics = step(params, run.opt_state, batch)
        synchronize(device)
        dt = time.perf_counter() - t0
        run.metrics.append({k: float(v) for k, v in metrics.items()})
        run.seconds.append(dt)
        print(f"step {i}: loss={run.metrics[-1]['loss']:.4f} ({dt:.2f}s)",
              flush=True)
    if args.ckpt_dir:
        checkpoint.save(args.ckpt_dir, args.steps,
                        convert.lm_params_to_jax(params),
                        metadata={"mode": "lm", "arch": args.arch,
                                  "seed": args.seed, "lr": lr,
                                  "steps": args.steps, "batch": args.batch,
                                  "seq_len": args.seq_len})
    return run


def main(argv=None):
    """Parse ``argv``, run, print the logs; returns the run's result
    (``--mode rl``: an ``ExperimentResult``, whose params and plane state
    stay readable; ``--mode lm``: an ``LMTrainRun``)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--mode", choices=("rl", "lm"), default="rl")
    ap.add_argument("--arch", default="mixtral-8x7b-reduced",
                    help="lm mode: the architecture (a -reduced suffix "
                         "gives its CPU-sized variant)")
    ap.add_argument("--steps", type=int, default=5,
                    help="lm mode: train steps")
    ap.add_argument("--batch", type=int, default=2,
                    help="lm mode: sequences a step")
    ap.add_argument("--seq-len", type=int, default=64,
                    help="lm mode: tokens a sequence")
    ap.add_argument("--env", default="pendulum")
    ap.add_argument("--algo", default="ppo")
    ap.add_argument("--backend", default="inline")
    ap.add_argument("--buffer", default=None,
                    help="experience buffer kind (default: the algo's own, "
                         "fifo for ppo and trpo, uniform for sac and ddpg)")
    ap.add_argument("--replay-capacity", type=int, default=None,
                    help="off-policy buffers: ring capacity")
    ap.add_argument("--replay-batch", type=int, default=None,
                    help="off-policy buffers: learner minibatch size")
    ap.add_argument("--n-step", type=int, default=None,
                    help="off-policy buffers: n-step return horizon")
    ap.add_argument("--num-samplers", type=int, default=4)
    ap.add_argument("--num-workers", type=int, default=None,
                    help="process backend: rollout worker-process count "
                         "(default: --num-samplers; worker i takes sampler "
                         "i's seed, so process == inline exactly)")
    ap.add_argument("--global-batch", type=int, default=16)
    ap.add_argument("--env-batch", type=int, default=None,
                    help="collect with one B-instance VectorEnv batch "
                         "instead of the num-samplers × global-batch split")
    ap.add_argument("--horizon", type=int, default=128)
    ap.add_argument("--chunk", type=int, default=None,
                    help="fused runtime (--backend fused): iterations "
                         "between host syncs (default: all of them; "
                         "ignored under --overlap)")
    ap.add_argument("--iterations", type=int, default=10)
    ap.add_argument("--hidden", type=int, default=64)
    ap.add_argument("--lr", type=float, default=None,
                    help="learning rate (default: the algorithm's own; "
                         "lm mode: 3e-4)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--kernels", default="auto",
                    choices=MODES + tuple(ALIASES),
                    help="'cuda' (or 'auto', 'pallas'): the CUDA kernels "
                         "on a CUDA device; "
                         "'ref': the plain PyTorch versions")
    ap.add_argument("--learner-devices", type=int, default=None,
                    help="train data-parallel over D devices: D lockstep "
                         "shard threads, gradients averaged across them "
                         "(1/unset: the single-device path, bit for bit; "
                         "on the CPU, REPRO_TORCH_HOST_DEVICES sets how "
                         "many may be asked for)")
    ap.add_argument("--learner-microbatches", type=int, default=1,
                    help="gradient-accumulation slices per (per-shard) "
                         "learner batch")
    ap.add_argument("--fsdp", action="store_true",
                    help="shard params and Adam moments across the "
                         "learner mesh per the _param_spec layout rules "
                         "(per-layer all-gather + reduce-scattered grads; "
                         "requires --learner-devices > 1 — DESIGN.md §11)")
    ap.add_argument("--learner-pods", type=int, default=1,
                    help="split the learner shards over a (pod, data, "
                         "model) mesh — the multi-pod production axis "
                         "names, so the same step lowers across the DCN "
                         "boundary (must divide --learner-devices)")
    ap.add_argument("--overlap", action="store_true",
                    help="double-buffered pipeline: dispatch iteration "
                         "k's learn and run iteration k+1's collect "
                         "while it executes (sync/fused runtimes; "
                         "IterationLog.overlap_saved_s reports the "
                         "hidden learn time)")
    ap.add_argument("--async", dest="async_mode", action="store_true",
                    help="free-running samplers (threads, or worker "
                         "processes with --backend process) and a learner "
                         "that drains them")
    ap.add_argument("--min-batches-per-update", type=int, default=1,
                    help="async runtime: rollouts the learner drains for "
                         "one update (one sweep's worth: the sampler or "
                         "worker count)")
    ap.add_argument("--inject-faults", default=None, metavar="SPEC",
                    help="fault schedule for process workers, e.g. "
                         "'kill:0.2,torn:0.05,delay:0.1:80,seed:7': "
                         "per-rollout probabilities of SIGKILL, death "
                         "mid-write, hang and delay, deterministic per "
                         "(seed, worker, incarnation, step); needs "
                         "--backend process")
    ap.add_argument("--max-respawns", type=int, default=3,
                    help="process backend: consecutive failures per "
                         "worker before the run fails (0 turns supervised "
                         "respawn off)")
    ap.add_argument("--min-workers", type=int, default=None,
                    help="async process: elastic fleet floor (with "
                         "--max-workers: utilization-band autoscaling "
                         "between updates)")
    ap.add_argument("--max-workers", type=int, default=None,
                    help="async process: elastic fleet ceiling (ring "
                         "slots and worker specs are provisioned up to it)")
    ap.add_argument("--staleness", default="off", choices=STALENESS_MODES,
                    help="async staleness correction: 'decay' weights "
                         "samples by decay**version_gap, 'vtrace' also by "
                         "min(rho_clip, pi_now/pi_behavior); 'off' leaves "
                         "the learner as it is")
    ap.add_argument("--staleness-decay", type=float, default=None,
                    help="per-version decay factor (default 0.9)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda, which must exist)")
    ap.add_argument("--ckpt-dir", default=None,
                    help="after the run, save its params at step "
                         "--iterations (lm mode: --steps) in the "
                         "reference's checkpoint format, with the spec in "
                         "the metadata (what repro_torch.launch."
                         "serve_policy --ckpt serves)")
    args = ap.parse_args(argv)
    return run_lm(args) if args.mode == "lm" else run_rl(args)


if __name__ == "__main__":
    main()
