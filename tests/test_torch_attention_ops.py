"""The attention ops' host-side rules, on the CPU.

The flash op takes one sequence length for q and k/v on both of its paths
(the TPU kernel reads one ``S``); the decode op's chunk planner splits any
cache into chunks of a multiple of 32 slots that tile it exactly and, where
the cache is long enough, give every SM a block.
"""
import math

import numpy as np
import pytest
import torch

from repro_torch.kernels.decode_attention import ops as dec_ops
from repro_torch.kernels.flash_attention import ops as fa_ops


@pytest.mark.parametrize("op", [fa_ops.flash_attention,
                                fa_ops.flash_attention_cuda])
@pytest.mark.parametrize("Sq,Skv", [(8, 9), (9, 8)])
def test_flash_attention_takes_one_sequence_length(op, Sq, Skv):
    rng = np.random.default_rng(0)
    q = torch.from_numpy(rng.standard_normal((1, Sq, 2, 1, 32),
                                             dtype=np.float32))
    kv = torch.from_numpy(rng.standard_normal((1, Skv, 2, 32),
                                              dtype=np.float32))
    with pytest.raises(ValueError, match="one sequence length"):
        op(q, kv, kv)


@pytest.mark.parametrize("B,K,Sc,chunk", [
    (4, 5, 176, 32),          # run (a): 6 chunks, 120 blocks
    (1, 5, 2048, 64),         # the long request: 32 chunks, 160 blocks
    (1, 5, 1, 32),
    (1, 2, 70000, 1056),      # past the old shared-memory limit
    (2, 2, 300, 32),
    (8, 8, 4096, 1344),
])
def test_decode_chunk_plan_tiles_the_cache(B, K, Sc, chunk):
    got = dec_ops.plan_chunk(B, K, Sc)
    assert got == chunk and got % 32 == 0 and got > 0
    n = max(1, math.ceil(Sc / got))
    spans = [(c * got, min(Sc, (c + 1) * got)) for c in range(n)]
    covered = np.zeros(Sc, dtype=np.int64)
    for lo, hi in spans:
        assert lo < hi or Sc == 0
        covered[lo:hi] += 1
    assert (covered == 1).all()           # [0, Sc) once, no overlap
    per_head = math.ceil(dec_ops.SMS / (B * K))
    if Sc >= 32 * per_head:               # long enough to fill the SMs
        assert B * K * n >= dec_ops.SMS
        # the largest multiple of 32 with per_head full chunks
        assert got * per_head <= Sc < (got + 32) * per_head
    else:
        assert got == 32
