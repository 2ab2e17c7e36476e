"""DDPG + replay buffer fed by parallel samplers on the PyTorch port (the
counterpart of ``examples/offpolicy_ddpg.py``; paper §6, further work #1).

Samplers record full transitions (``next_obs``); the learner pushes them
through the replay ring (the CUDA ring kernels on the card) and draws
uniform minibatches. Through ``repro_torch.experiment`` this is just
``algo="ddpg"`` on the threaded backend; swap in ``buffer="prioritized"``
(the sum-tree kernels), ``algo="sac"``, another backend, or
``runtime="fused"`` and it still runs.

  PYTHONPATH=src python examples/offpolicy_ddpg_torch.py        # the card
  PYTHONPATH=src python examples/offpolicy_ddpg_torch.py --device cpu \\
      --updates 3 --horizon 16                                  # small
"""
import argparse

from repro_torch import experiment
from repro_torch.experiment import ExperimentSpec, Schedule


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--samplers", type=int, default=4)
    ap.add_argument("--env-batch", type=int, default=4,
                    help="envs per sampler")
    ap.add_argument("--horizon", type=int, default=64)
    ap.add_argument("--updates", type=int, default=40)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda, which must exist)")
    args = ap.parse_args(argv)
    n = args.samplers
    spec = ExperimentSpec(
        env="pendulum", algo="ddpg", backend="threaded",
        model={"hidden": 64},
        algo_kwargs={"noise_std": 0.2, "updates_per_collect": 1},
        buffer="uniform",
        buffer_kwargs={"capacity": 50_000, "batch_size": 256},
        schedule=Schedule(num_samplers=n, global_batch=args.env_batch * n,
                          horizon=args.horizon, iterations=args.updates,
                          seed=0),
    )
    result = experiment.run(spec, device=args.device)
    for log in result.logs[::5] + result.logs[-1:]:
        print(f"update {log.iteration}: collect={log.collect_time:.3f}s "
              f"(critical path over {n} samplers) "
              f"learn={log.learn_time:.3f}s samples={log.samples}")
    ring = result.runner.plane_state[0]
    print(f"\nreplay filled by {n} parallel samplers; {int(ring.size)} "
          f"transitions ({args.updates} learner updates drew uniform "
          f"minibatches at their own pace)")
    return result


if __name__ == "__main__":
    main()
