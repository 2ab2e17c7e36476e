"""The port's examples (``examples/*_torch.py``) at a tiny size on the CPU:
each runs its ``main`` through ``repro_torch.experiment`` and returns what
it printed from."""
import ast
import math
import runpy
from pathlib import Path

import pytest
import torch

EXAMPLES = Path(__file__).resolve().parents[1] / "examples"


def _main(name):
    return runpy.run_path(str(EXAMPLES / f"{name}.py"),
                          run_name=f"example_{name}")["main"]


def _finite(logs):
    return all(math.isfinite(lg.mean_return) and lg.samples > 0
               for lg in logs)


def test_quickstart_torch():
    one, four, fused = _main("quickstart_torch")(
        ["--device", "cpu", "--iterations", "3", "--batch", "2",
         "--horizon", "16"])
    assert [len(one), len(four), len(fused)] == [3, 3, 3]
    assert one[0].samples == 2 * 16 and four[0].samples == 4 * 2 * 16
    assert all(lg.collect_time == 0.0 for lg in fused)     # fused runtime
    assert _finite(one + four + fused)


def test_offpolicy_ddpg_torch():
    result = _main("offpolicy_ddpg_torch")(
        ["--device", "cpu", "--updates", "3", "--horizon", "8",
         "--samplers", "2", "--env-batch", "2"])
    assert len(result.logs) == 3 and _finite(result.logs)
    assert int(result.runner.plane_state[0].size) == 3 * 2 * 2 * 8


def test_async_vs_sync_torch():
    sync_logs, async_logs = _main("async_vs_sync_torch")(
        ["--device", "cpu", "--updates", "2", "--horizon", "16",
         "--samplers", "2"])
    assert len(sync_logs) == 2 and len(async_logs) == 2
    assert _finite(sync_logs + async_logs)


@pytest.mark.parametrize("name", ["quickstart_torch", "offpolicy_ddpg_torch",
                                  "async_vs_sync_torch"])
def test_examples_default_to_cuda(name):
    """Like the port's entry points, an example runs on the card unless
    given ``--device cpu``: without a CUDA device it raises."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        _main(name)(["--updates" if name != "quickstart_torch"
                     else "--iterations", "1"])


def test_examples_import_neither_jax_nor_repro():
    files = sorted(EXAMPLES.glob("*_torch.py"))
    assert [f.name for f in files] == [
        "async_vs_sync_torch.py", "llm_rollout_torch.py",
        "offpolicy_ddpg_torch.py", "quickstart_torch.py"]
    for f in files:
        for node in ast.walk(ast.parse(f.read_text(), filename=str(f))):
            names = ([a.name for a in node.names]
                     if isinstance(node, ast.Import) else
                     [node.module] if isinstance(node, ast.ImportFrom)
                     and node.module else [])
            for name in names:
                root = name.split(".")[0]
                assert root not in ("jax", "jaxlib", "repro"), (f, name)
