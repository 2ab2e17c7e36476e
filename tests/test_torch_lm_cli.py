"""``--mode lm`` of the port's train CLI, its lm-mode checkpoint against
the JAX package's, and ``examples/llm_rollout_torch.py``, on the CPU at
reduced widths (float32).

The CLI trains each family of the port two steps with finite losses; its
checkpoint restores in the reference's ``restore`` on the reference's
``init_params`` template, and the reference's in the port's, value for
value.
"""
import contextlib
import dataclasses
import io
import json
import math
import os
import runpy
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.checkpoint import io as jax_io
from repro.configs import get_config as jax_get_config
from repro.models import transformer as jax_transformer
from repro_torch import checkpoint, convert
from repro_torch.configs import get_config
from repro_torch.launch import train
from repro_torch.models import transformer
from test_torch_lm_common import one_torch_thread  # noqa: F401

FAMILIES = ["h2o-danube-3-4b-reduced", "falcon-mamba-7b-reduced",
            "mixtral-8x7b-reduced", "qwen2-vl-7b-reduced",
            "musicgen-medium-reduced"]


def _cli(argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        run = train.main(argv)
    return run, buf.getvalue().splitlines()


@pytest.mark.parametrize("arch", [None] + FAMILIES)
def test_train_mode_lm_on_the_cpu(arch):
    """``--mode lm --device cpu --steps 2`` (the default arch,
    mixtral-8x7b-reduced, when none is given) prints two finite losses;
    the params move and stay finite."""
    argv = ["--mode", "lm", "--device", "cpu", "--steps", "2",
            "--batch", "2", "--seq-len", "8"]
    run, lines = _cli(argv + (["--arch", arch] if arch else []))
    assert run.cfg.name == (arch or "mixtral-8x7b-reduced")
    assert [ln.split(":")[0] for ln in lines] == ["step 0", "step 1"]
    for ln, m in zip(lines, run.metrics):
        assert math.isfinite(float(ln.split("loss=")[1].split()[0]))
        assert all(math.isfinite(v) for v in m.values())
    assert (run.metrics[0]["aux"] > 0) == run.cfg.is_moe
    fresh = transformer.init_params(run.cfg,
                                    torch.Generator().manual_seed(0))
    moved = [not torch.equal(a, b) for a, b in
             zip(run.params.parameters(), fresh.parameters())]
    assert any(moved)
    assert all(torch.isfinite(p).all() for p in run.params.parameters())
    assert all(m.dtype == p.dtype for m, p in
               zip(run.opt_state.mu, run.params.parameters()))


def test_train_mode_lm_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train.main(["--mode", "lm", "--steps", "1"])


def test_lm_checkpoint_moves_both_ways(tmp_path):
    arch = "hymba-1.5b-reduced"
    run, _ = _cli(["--mode", "lm", "--device", "cpu", "--arch", arch,
                   "--steps", "2", "--batch", "2", "--seq-len", "8",
                   "--seed", "4", "--ckpt-dir", str(tmp_path / "port")])
    meta = checkpoint.load_metadata(str(tmp_path / "port"))
    assert meta == {"step": 2, "mode": "lm", "arch": arch, "seed": 4,
                    "lr": 3e-4, "steps": 2, "batch": 2, "seq_len": 8}
    jcfg = jax_get_config(arch)
    template = jax_transformer.init_params(jcfg, jax.random.PRNGKey(0))
    restored = jax_io.restore(str(tmp_path / "port"), template)
    want = convert.lm_params_to_jax(run.params)
    got = jax.tree_util.tree_flatten_with_path(restored)[0]
    assert [p for p, _ in got] == [
        p for p, _ in jax_tree_paths(want)]
    for (path, g), (_, w) in zip(got, jax_tree_paths(want)):
        np.testing.assert_array_equal(np.asarray(g), w, err_msg=str(path))

    # the reference's checkpoint, restored by the port
    tree = jax.tree.map(np.asarray, jax_transformer.init_params(
        jcfg, jax.random.PRNGKey(8)))
    jax_io.save(str(tmp_path / "ref"), 5, tree, metadata={"mode": "lm"})
    cfg = get_config(arch)
    model = convert.lm_params_from_jax(cfg, checkpoint.restore(
        str(tmp_path / "ref"), convert.lm_params_to_jax(
            transformer.init_params(cfg, torch.Generator()))))
    for (path, g), (_, w) in zip(jax_tree_paths(
            convert.lm_params_to_jax(model)), jax_tree_paths(tree)):
        np.testing.assert_array_equal(g, w, err_msg=str(path))
    assert sorted(os.listdir(tmp_path / "ref")) == ["ckpt_0000000005"]


def jax_tree_paths(tree):
    return jax.tree_util.tree_flatten_with_path(tree)[0]


def test_llm_rollout_example_runs_small():
    main = runpy.run_path(str(Path(__file__).resolve().parents[1] /
                              "examples" / "llm_rollout_torch.py"),
                          run_name="example_llm_rollout_torch")["main"]
    cfg, params, history = main(
        ["--device", "cpu", "--arch", "hymba-1.5b-reduced", "--updates",
         "2", "--samplers", "2", "--batch", "2", "--prompt-len", "4",
         "--gen-len", "5"])
    assert cfg.name == "hymba-1.5b-reduced" and len(history) == 2
    for h in history:
        assert all(math.isfinite(v) for v in h.values())
        assert h["collect_s"] > 0 and h["learn_s"] > 0
    assert all(torch.isfinite(p).all() for p in params.parameters())
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            main(["--updates", "1"])


def test_ppo_config_takes_aux_coef():
    """``aux_coef`` is the reference's ``PPOConfig`` field again (the RL
    algorithm accepts it and, as the reference's MLP loss, does not read
    it)."""
    from repro.algos.ppo import PPOConfig as JaxPPOConfig
    from repro_torch.algos.api import PPOAlgorithm
    from repro_torch.algos.ppo import PPOConfig
    assert dataclasses.asdict(PPOConfig()) == dataclasses.asdict(
        JaxPPOConfig())
    assert PPOAlgorithm(aux_coef=0.2).cfg.aux_coef == 0.2
    assert json.dumps(dataclasses.asdict(PPOConfig(aux_coef=0.2)))
