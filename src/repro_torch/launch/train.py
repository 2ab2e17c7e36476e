"""End-to-end training entry point (port of ``--mode rl`` of
``repro/launch/train.py``).

Builds an ``ExperimentSpec`` from the flags and runs it through
``repro_torch.experiment.run``, printing one JSON ``IterationLog`` per
line. Runs on the CUDA device unless ``--device cpu`` is given.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.train --mode rl --env cheetah \
      --algo ppo --num-samplers 10 --global-batch 160 --horizon 125 \
      --iterations 3 [--env-batch 4096] [--kernels {ref,cuda,auto}] \
      [--device cpu]
  PYTHONPATH=src python -m repro_torch.launch.train --env cheetah \
      --algo {sac,ddpg} --buffer prioritized --num-samplers 10 \
      --global-batch 160 --horizon 125 --replay-capacity 1000000 \
      --replay-batch 256 [--n-step 3] [--device cpu]

Algos: ``ppo`` and ``trpo`` (on-policy, the ``fifo`` buffer), ``sac`` and
``ddpg`` (replay, ``uniform`` or ``prioritized``). Envs: ``pendulum``,
``cartpole`` and ``cheetah``.
"""
from __future__ import annotations

import argparse
import json

from repro_torch import experiment
from repro_torch.experiment import ExperimentSpec, Schedule
from repro_torch.kernels.select import ALIASES, MODES


def spec_from_args(args) -> ExperimentSpec:
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
        backend=args.backend,
        buffer=args.buffer,
        kernels=args.kernels,
        model={"hidden": args.hidden},
        algo_kwargs={} if args.lr is None else {"lr": args.lr},
        buffer_kwargs=buffer_kwargs,
        schedule=Schedule(
            num_samplers=args.num_samplers,
            global_batch=args.global_batch,
            horizon=args.horizon,
            iterations=args.iterations,
            seed=args.seed,
            env_batch=args.env_batch,
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
    ap.add_argument("--global-batch", type=int, default=16)
    ap.add_argument("--env-batch", type=int, default=None,
                    help="collect with one B-instance VectorEnv batch "
                         "instead of the num-samplers × global-batch split")
    ap.add_argument("--horizon", type=int, default=128)
    ap.add_argument("--iterations", type=int, default=10)
    ap.add_argument("--hidden", type=int, default=64)
    ap.add_argument("--lr", type=float, default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--kernels", default="auto",
                    choices=MODES + tuple(ALIASES),
                    help="'cuda' (or 'auto', 'pallas'): the CUDA kernels "
                         "on a CUDA device; "
                         "'ref': the plain PyTorch versions")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda, which must exist)")
    args = ap.parse_args(argv)
    if args.mode != "rl":
        raise SystemExit(f"--mode {args.mode} is not ported to repro_torch "
                         f"yet; see ROADMAP.md")
    return run_rl(args)


if __name__ == "__main__":
    main()
