"""End-to-end training entry point (port of ``--mode rl`` of
``repro/launch/train.py``).

Builds an ``ExperimentSpec`` from the flags and runs it through
``repro_torch.experiment.run``, printing one JSON ``IterationLog`` per
line. Runs on the CUDA device unless ``--device cpu`` is given; rollout
workers (``--backend process``) take the same device.

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

``--backend fused`` is the fused runtime: one carry of ``--global-batch``
envs (or ``--env-batch``), each collect -> learn iteration one CUDA-graph
replay on the card, ``--chunk`` iterations between host syncs (default:
all of them).

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
import json

from repro_torch import experiment
from repro_torch.algos.staleness import MODES as STALENESS_MODES
from repro_torch.experiment import ExperimentSpec, Schedule
from repro_torch.kernels.select import ALIASES, MODES


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
            max_respawns=args.max_respawns,
            min_workers=args.min_workers,
            max_workers=args.max_workers,
        ),
    )


def run_rl(args) -> experiment.ExperimentResult:
    result = experiment.run(spec_from_args(args), device=args.device)
    for log in result.logs:
        print(json.dumps(log.as_dict()), flush=True)
    return result


def main(argv=None) -> experiment.ExperimentResult:
    """Parse ``argv``, run, print the logs; returns the run's result
    (params and plane state stay readable)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--mode", default="rl",
                    help="'rl' (the 'lm' mode is not ported yet: ROADMAP.md)")
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
    ap.add_argument("--lr", type=float, default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--kernels", default="auto",
                    choices=MODES + tuple(ALIASES),
                    help="'cuda' (or 'auto', 'pallas'): the CUDA kernels "
                         "on a CUDA device; "
                         "'ref': the plain PyTorch versions")
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
    args = ap.parse_args(argv)
    if args.mode != "rl":
        raise SystemExit(f"--mode {args.mode} is not ported to repro_torch "
                         f"yet; see ROADMAP.md")
    return run_rl(args)


if __name__ == "__main__":
    main()
