"""The paper's architecture (Fig 2) end to end on the PyTorch port:
asynchronous sampler threads + policy/experience queues against the
synchronous baseline, with staleness and queue accounting printed (the
counterpart of ``examples/async_vs_sync.py``).

Both sides are the same ``ExperimentSpec`` with only ``runtime`` flipped
(``sync`` over the threaded backend against ``async``).

  PYTHONPATH=src python examples/async_vs_sync_torch.py         # the card
  PYTHONPATH=src python examples/async_vs_sync_torch.py --device cpu \\
      --updates 2 --horizon 16                                  # small
"""
import argparse
import time

from repro_torch import experiment
from repro_torch.experiment import ExperimentSpec, Schedule


def spec_for(runtime: str, args) -> ExperimentSpec:
    n = args.samplers
    return ExperimentSpec(
        env="cartpole", algo="ppo",
        # the sync baseline collects with the threaded backend, so its
        # fan-out matches the async runtime's sampler threads 1:1
        backend="threaded", runtime=runtime,
        model={"hidden": 32},
        algo_kwargs={"lr": 1e-3, "epochs": 2, "minibatches": 2},
        schedule=Schedule(num_samplers=n, global_batch=8 * n,
                          horizon=args.horizon, iterations=args.updates,
                          seed=0, min_batches_per_update=2),
    )


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--samplers", type=int, default=3)
    ap.add_argument("--horizon", type=int, default=128)
    ap.add_argument("--updates", type=int, default=6)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda, which must exist)")
    args = ap.parse_args(argv)
    sync = experiment.build(spec_for("sync", args), device=args.device)
    try:
        t0 = time.perf_counter()
        sync_logs = sync.run(args.updates)
        t_sync = time.perf_counter() - t0
    finally:
        sync.close()
    orch = experiment.build(spec_for("async", args), device=args.device)
    try:
        t0 = time.perf_counter()
        async_logs = orch.run(args.updates, timeout=300)
        t_async = time.perf_counter() - t0
    finally:
        orch.close()
    waits = orch.expq.queue_wait
    print(f"\nsync:  {args.updates} updates in {t_sync:.1f}s, final return "
          f"{sync_logs[-1].mean_return:.1f}")
    print(f"async: {len(async_logs)} updates in {t_async:.1f}s, final "
          f"return {async_logs[-1].mean_return:.1f}")
    print(f"async policy staleness (mean versions behind): "
          f"{orch.expq.mean_staleness():.2f}")
    print(f"async queue waits: mean "
          f"{sum(waits) / max(len(waits), 1):.3f}s over "
          f"{orch.expq.put_count} experiences from {args.samplers} "
          f"samplers")
    print("\nthe async agent never blocks on a single slow sampler — the "
          "paper's Fig 2 architecture; staleness is the price, bounded by "
          "queue depth")
    return sync_logs, async_logs


if __name__ == "__main__":
    main()
