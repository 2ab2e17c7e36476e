"""The learning check of the port: PPO on pendulum must raise its return.

The port's counterpart of ``tests/test_system.py::test_ppo_improves_pendulum_return``
(the paper's core promise), with that test's setup and criterion: the
Gaussian-MLP policy with hidden width 32, Adam at 1e-3, PPO with 2 epochs
of 2 minibatches, 4 samplers × 16 envs × 200 steps, 20 iterations, seed 3,
on the sync runtime with the inline backend, on the CPU. The best 3 of the
last 6 nonzero mean returns must beat the mean of the first 4 by more than
30. The run goes through ``repro_torch.experiment.run``, the entry point a
user calls. torch draws other numbers from the seed than JAX does, so the
returns are the port's own; the bound is the reference's.
"""
import pytest
import torch

from repro_torch.experiment import ExperimentSpec, Schedule, run


@pytest.mark.slow
def test_ppo_improves_pendulum_return():
    """The port learns: about 10 s on one CPU thread."""
    threads = torch.get_num_threads()
    # one thread, so the run leaves the cores to the tests beside it
    torch.set_num_threads(1)
    try:
        logs = run(ExperimentSpec(
            env="pendulum", algo="ppo", backend="inline", runtime="sync",
            model={"hidden": 32},
            algo_kwargs={"lr": 1e-3, "epochs": 2, "minibatches": 2},
            schedule=Schedule(num_samplers=4, global_batch=4 * 16,
                              horizon=200, iterations=20, seed=3)),
            device="cpu").logs
    finally:
        torch.set_num_threads(threads)
    assert len(logs) == 20
    early = [lg.mean_return for lg in logs[:4] if lg.mean_return != 0.0]
    late = sorted(lg.mean_return for lg in logs[-6:]
                  if lg.mean_return != 0.0)[-3:]    # best of the last six
    assert late and early
    assert sum(late) / len(late) > sum(early) / len(early) + 30.0
