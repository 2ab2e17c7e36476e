"""Quickstart on the PyTorch port: WALL-E's experiment in miniature through
``repro_torch.experiment`` (the counterpart of ``examples/quickstart.py``).

One declarative ``ExperimentSpec`` names the whole experiment (env, algo,
backend, runtime, model, schedule) and ``repro_torch.experiment.run`` is
the single entry point. Here: PPO on pendulum with N=4 parallel samplers
against N=1, printing the per-iteration collection/learning split (the
paper's Figs 3/6 story), then the fused runtime: the same iterations as
one carry, each iteration one CUDA-graph replay on the card (after two
eager iterations and a capture; eagerly on the CPU).

  PYTHONPATH=src python examples/quickstart_torch.py            # the card
  PYTHONPATH=src python examples/quickstart_torch.py --device cpu \\
      --iterations 3 --batch 4 --horizon 32                    # small
"""
import argparse

from repro_torch import experiment
from repro_torch.experiment import ExperimentSpec, Schedule


def spec_for(num_samplers: int, iterations: int, batch: int, horizon: int,
             backend: str = "inline", runtime: str = "sync"
             ) -> ExperimentSpec:
    return ExperimentSpec(
        env="pendulum", algo="ppo", backend=backend, runtime=runtime,
        model={"hidden": 64},
        algo_kwargs={"lr": 1e-3, "epochs": 4, "minibatches": 4},
        schedule=Schedule(num_samplers=num_samplers,
                          global_batch=batch * num_samplers,
                          horizon=horizon, iterations=iterations, seed=0),
    )


def run(num_samplers: int, args):
    result = experiment.run(
        spec_for(num_samplers, args.iterations, args.batch, args.horizon),
        device=args.device)
    print(f"\n=== N={num_samplers} parallel samplers (inline) ===")
    for log in result.logs:
        print(f"iter {log.iteration}: return={log.mean_return:8.1f}  "
              f"collect={log.collect_time:.3f}s "
              f"(serial-equivalent {log.collect_time_serial:.3f}s)  "
              f"learn={log.learn_time:.3f}s  samples={log.samples}")
    return result.logs


def run_fused(args):
    n = args.iterations
    runner = experiment.build(
        spec_for(1, n, args.batch, args.horizon, runtime="fused"),
        device=args.device)
    try:
        runner.run(n)                  # warm-up: eager iterations, capture
        logs = runner.run(n)[n:]
    finally:
        runner.close()
    print(f"\n=== fused runtime ({n} iterations, one replay each) ===")
    for log in logs:
        print(f"iter {log.iteration}: return={log.mean_return:8.1f}  "
              f"iter_time={log.learn_time:.3f}s  samples={log.samples}")
    return logs


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--iterations", type=int, default=8)
    ap.add_argument("--batch", type=int, default=8,
                    help="envs per sampler")
    ap.add_argument("--horizon", type=int, default=200)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda, which must exist)")
    args = ap.parse_args(argv)
    one = run(1, args)
    four = run(4, args)
    t1 = sum(lg.collect_time for lg in one[1:])
    t4 = sum(lg.collect_time for lg in four[1:])
    print(f"\ncollection critical path per iteration: N=1 {t1:.3f}s vs "
          f"N=4 {t4:.3f}s (equal per-sampler work -> ~equal wall-clock)")
    print("N=4 collected", sum(lg.samples for lg in four),
          "samples vs", sum(lg.samples for lg in one), "for N=1 in that "
          "time — more experience per wall-clock iteration is the paper's "
          "Fig 3 claim")
    fused = run_fused(args)
    t_f = sum(lg.learn_time for lg in fused) / len(fused)
    t_s = (sum(lg.collect_time + lg.learn_time for lg in one[1:])
           / max(len(one) - 1, 1))
    print(f"\nfused whole-iteration time {t_f:.3f}s/iter vs stepped "
          f"{t_s:.3f}s/iter at this batch")
    return one, four, fused


if __name__ == "__main__":
    main()
