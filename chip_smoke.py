#!/usr/bin/env python3
"""Smoke test of the PyTorch port (``src/repro_torch``) on one CUDA card.

    python3 chip_smoke.py
    python3 chip_smoke.py --timing-only    # build, then phase 6 alone

Phases, each of which raises (and so exits non-zero) on failure:

1. device: the card's name and power limit from ``nvidia-smi``;
2. build: every CUDA kernel of the slices, compiled from ``src/repro_torch/
   kernels/csrc`` (one ``nvcc`` per source, all at once; the seconds of
   each and ``ptxas``'s registers and spills are printed);
3. kernels: each kernel's wrapper on card tensors at the shapes the main
   path gives it (and a larger env batch with a third of the rows at their
   last step, so the reset select fires), held against its plain PyTorch
   version on the same inputs: ``t``/``done``, GAE and the discounted
   returns (T × B = 1 × 1, 125 × 160, 128 × 4096, a ragged 125 × 163, 0 × 5)
   exactly, env float leaves within 4 ulp (or 4 ulp of the leaf's magnitude
   near zero; cart-pole at B = 1, 16, 700 and 4096 with poles falling and a
   reward scale of 0.5); GAE and the cheetah step also at their tile edges,
   bit for bit and one launch a call (GAE at T in 1, 31, 32, 33, 125, 128,
   129, 1000 × B in 1, 31, 33, 160, 4096, 4097, with dones at no step, every
   step, t = 0 only, t = T - 1 only and 10 % at random; cheetah at B in 1,
   16, 31, 33, 4096, 4097 with no, every and a third of the episodes
   ending; pendulum and cart-pole at B in 1 ... 16,384 around their
   warps and block sizes, alike, then with NaN in a few rows of every
   float input and a reset obs that is not 16-byte aligned, then over all
   2^32 float32 bit patterns as the angle: every leaf bit for bit, NaNs
   by their bits; the three env steps again storing float16 and bfloat16
   obs and rewards (the reset obs in that dtype): cheetah at its B sweep,
   pendulum and cart-pole at theirs, with no, every and a third of the
   episodes ending, NaN rows and an unaligned reset obs, bit for bit; the sum-tree find at capacities 1, 2, 32, 1,024 and 2^20
   × B 1, 8, 9, 31, 32, 33, 256, 257, 4,096, 4,097 (past it, a thread a
   mass) and 20,000, with masses that tie with a stored prefix sum at
   every chunk of levels, 0, the root and above it, a negative mass and
   NaN, over zero-mass leaves, a run of them and a zero-mass right
   subtree; the discounted returns at T 1, 63, 64, 65, 128, 129 × B 1,
   31, 32, 33, 160, 163, 4,096 with GAE's five patterns of dones,
   unaligned rewards and dones, T 0 and B 0); the replay ring (N > cap,
   wraparound, cap 1, float, bool, int, bfloat16 and zero-width rows, odd
   heads where source and destination differ mod 16 and mod 4) and the sum tree (capacities 1, 2, 1024 and
   2^20, zero-mass leaves, updates with duplicate indices) exactly; the LM
   kernels at the serve runs' shapes and ragged ones: the selective scan
   (hymba's prefill B 4 × S 144 × Di 3,200 × N 16, the long request's
   S 4,224, which splits time into chunks, falcon-mamba-7b's B 4 × S 16 ×
   Di 8,192, B 3 × S 37 × Di 100 × N 5, a nonzero h0, ragged chunks at N 1
   and 5, S 0) within 2e-4 relative to max(1, |value|), flash attention
   (hymba at S 144 and 4,224 with the window 2,048, hd 128 causal, hd 32
   non-causal, S 1,000, window edges inside the 64-key tiles, G 1;
   bfloat16 on the tensor-core kernel,
   float32 on the CUDA-core one) and decode attention (176 slots with a
   random validity mask, a full ring of 2,048, 2,048 slots with only 0 and
   2,047 valid so that whole chunks are empty, 1 slot, 70,000 slots, hd 32
   and 128) within 2e-5 in float32 and 3e-2 in bfloat16; decode with no
   valid slot gives 0, and a decode call captured in a CUDA graph and
   replayed equals the eager call;
4. main path, each run with the launch counts set to 0 just before it and
   read just after. First the learning check (the reference's
   ``tests/test_system.py`` check, ``tests/test_torch_learning.py`` on the
   CPU): PPO pendulum on the stepped sync runtime through the pendulum and
   GAE kernels, hidden 32, Adam 1e-3, 2 epochs of 2 minibatches, 4
   samplers × 16 envs × 200 steps, 20 iterations, seed 3; the best 3 of
   the last 6 mean returns must beat the first 4 by 30, printed as a
   ``{"learning": ...}`` line. Then PPO on cheetah through the train CLI with the paper's
   budget (10 samplers × 16 envs × 125 steps = 20,000 samples per
   iteration, 3 iterations), the vector path (one 4096-env batch, 128
   steps, 2 iterations), and the CLI's default env, pendulum (10 × 16 ×
   125, 2 iterations); then SAC on cheetah through the train CLI with
   prioritized replay (the same budget, 3 iterations; replay capacity
   1,000,000, i.e. 2^20 slots, and minibatch 256, the SAC paper's), and SAC
   on pendulum with uniform replay (2 iterations); then, through the train
   CLI, PPO on cart-pole (10 × 16 × 125, 3 iterations, and one 4096-env
   batch × 128 steps, 2 iterations), TRPO on cheetah (10 × 16 × 125, 3
   iterations) and DDPG on cheetah with prioritized replay (the SAC run's
   budget and replay, 3 iterations). Every log must be finite with the
   expected sample count, and each kernel's count must equal the steps,
   learns, inserts, draws and priority updates the run made (a ring
   insert or gather is one launch for all the leaves). Then the
   data-parallel learner (``learner``, ``learner_runs``): PPO cheetah
   through the train CLI with ``--learner-devices 1`` (bit for bit the
   plain run above) and ``--learner-microbatches 2`` (each learn within
   rtol 1e-4, atol 1e-5 of the plain learner on the same inputs); fused
   PPO cheetah at 160 × 125 with two microbatches (2 eager iterations, a
   capture, 3 replays) bit for bit the stepped microbatched run; the
   ``ShardedLearner`` over the mesh ``[cuda:0, cuda:0]`` (two shard threads
   on the one card): PPO within 1e-5 of the plain run, SAC and DDPG
   prioritized (2^20 slots, batch 256) within 0.05, the sharded find's
   global indices equal to the unsharded kernel's and the shard roots
   summing to the root, GAE and the four replay kernels at the per-shard
   shapes bit for bit; ``--learner-devices 2`` on one card raising the
   mesh's ``ValueError``; GAE and the replay kernels launched once per
   shard per call; a ``{"learner": ...}`` line. Then FSDP, learner pods,
   the sharded backend and overlap over a learner mesh (``sharding``,
   ``sharding_runs``) at the main path's width (PPO cheetah, 10 × 16 ×
   125, 3 iterations): FSDP over ``[cuda:0, cuda:0]``, each learn within
   rtol 1e-4, atol 1e-5 of the replicated D = 2 learner on the same
   inputs, the final weights within 1e-4 of replicated D = 2's (T 125) and
   of D = 1's (T 128), each shard's bytes equal to what ``fsdp_layout``
   predicts (also at hidden 512, every leaf of 1 MiB or more sharded);
   SAC prioritized (2^20 slots) under FSDP within 0.05 of the main path's
   run; pods 2 × 2 over four entries of ``cuda:0`` with FSDP within 1e-4
   of replicated D = 4 (T 125) and D = 1 (T 128); the sharded backend
   through the CLI on the one card and over ``[cuda:0, cuda:0]``, its
   trajectory over ten entries of ``cuda:0`` bit for bit the inline
   backend's, over one device the first step's actions within 1e-5 (the
   largest difference over the sweep printed with its leaf), 125 × D
   cheetah-step launches a sweep against inline's 1,250, its collect
   seconds beside inline's; overlap with D = 2 and FSDP (6 iterations:
   staleness 0, 0 then 1 from the fourth log, saved seconds >= 0 and > 0
   on a pipelined iteration, within 0.05 of the serial run); ``--fsdp``
   on one learner device and ``--backend fused --learner-devices 2``
   raising the reference's ``ValueError`` and the ``NotImplementedError``
   naming item 10f; every run's launches equal to those the code
   predicts; a ``{"sharding": ...}`` line. Then envs with
   half-precision obs and rewards (``env_kwargs={"dtype": ...}``): PPO
   cheetah in bfloat16 at 10 × 16 × 125 (3 iterations) and fused at one
   carry of 160 × 125 (5 iterations), SAC cheetah prioritized (2^20
   slots, batch 256) in float16 at 10 × 16 × 125 (3 iterations), each bit
   for bit equal to the same run with the plain versions
   (``kernels="ref"``), with its launch counts (an ``{"env_dtypes": ...}``
   line). Then LM
   serving at full width and depth with random weights: (a) the serve CLI
   with its defaults on hymba-1.5b (batch 4, prompt 16 + 128 meta tokens,
   32 tokens, 3 requests), (b) one prompt of 4,096 (P = 4,224, past the
   window of 2,048: the ring wraps), (c) the wave server (4 slots, 10
   requests in 3 waves, budgets 32 and 12, an EOS id), and falcon-mamba-7b
   cut to 8 of 64 layers (batch 4, prompt 16, 16 tokens, 2 requests);
   tokens in [0, vocab), logits finite, and per prefill one scan and one
   flash launch per layer, per decode step one decode launch per layer.
   Then LM training (``lm_train``), on the model's plain paths (the
   kernels have no backward): (a) ``--mode lm`` at hymba-1.5b's full
   width, bfloat16 with bfloat16 Adam moments, batch 2 × 64 tokens (+128
   meta tokens), 3 steps: losses and grad norms finite, the params moved,
   no kernel launched; seconds a step, peak MiB and the parameter count;
   (b) ``examples/llm_rollout_torch.py``'s loop at full width (2 samplers
   × 8 sequences × prompt 8 + 24 tokens, 2 updates): the rollout's
   prefill and decode launch the flash, decode and scan kernels (one a
   layer per prefill, one decode a layer per step) and its GAE the GAE
   kernel, counted exactly; a fresh rollout's behaviour logp against the
   plain decode path teacher-forced with its tokens and against the
   training forward over ``[prompt, tokens[:, :-1]]``, in bfloat16
   (reported) and on a float32 copy of the weights (within
   ``LM_LOGP_F32_TOL``); collect against learn seconds; (c) two ``--mode
   lm`` steps of the dense, ssm, MoE, M-RoPE + vision and audio reduced
   archs, each with ``--ckpt-dir`` read back by the port bit for bit; (d)
   at full width, the grads of remat ``none`` and ``full`` within
   ``LM_REMAT_REL_TOL``, and each of the five modes' peak MiB; (e) 30
   updates of the example at hymba-1.5b-reduced, the mean token reward of
   the first and last five logged (no threshold); an ``{"lm_train": ...}``
   line.
   Before the LM runs, the actor plane through the train CLI, each run
   with its workers on the card: PPO on cheetah over 10 worker processes
   in lock-step (``--backend process``, the paper's 10 × 16 × 125, 3
   iterations) and over 10 sampler threads (``--backend threaded``), each
   bit for bit equal to the inline run of the same seed above (every
   merged trajectory and the final weights); async PPO with staleness
   decay over the process pool and over threads (6 updates of 10
   rollouts each, three times what the pool's ring holds at start-up;
   logs finite; staleness, worker utilisation and fleet size printed);
   SAC on cheetah
   with prioritized replay over 10 processes, bit for bit equal to the
   inline SAC run (weights, ring and tree), the ring and tree kernels
   launching in the learner; PPO on pendulum over 4 processes under a
   seeded kill and torn-write schedule, completing with at least one
   respawn and a reclaimed slot (the supervisor's events printed). The
   workers report their launches, which join the run's counts (the
   cheetah step is counted in the workers; every worker incarnation's
   last report, so the fault run's workers hold at least 3 x 4 x 125
   pendulum steps); each pool's start seconds, each worker's start
   seconds, device memory (``nvidia-smi --query-compute-apps``, sampled
   during the run) and allocator peak reserve (its own report), the
   card's whole use (``torch.cuda.mem_get_info`` before and at its peak)
   and the wall seconds of every collect are printed; after each run no
   worker process is alive and no ``walle-<pid>-*`` block of the
   script's own pools is left in /dev/shm. Then the fused runtime
   (``runtime="fused"``: two eager iterations, a capture, then one
   CUDA-graph replay per iteration): PPO cheetah, SAC cheetah prioritized
   (2^20 slots, batch 256), DDPG pendulum uniform and TRPO cart-pole at
   one carry of 160 envs × 125 steps (5 iterations: 3 replays), and PPO
   cheetah at one 4,096-env batch × 128 steps (3 iterations), each bit for
   bit equal to the stepped run from the same carry (weights, optimizer
   state, env carry, replay ring and tree, mean returns), PPO and SAC also
   with the plain versions captured (``kernels="ref"``) against the
   kernels; each run's launches per replay are the wrapper calls its
   capture recorded and equal the port's kernel nodes of the graph, read
   back by name through the driver API, and its launch counts are its
   eager iterations and replays times those (a replay adds them to the
   counts; the capture's calls launch nothing and are not counted),
   printed with the warm-up and capture seconds and the graph pool's MiB;
   seconds per iteration replayed (chunks of 10) against
   the stepped run, the inline sweep and the 10 processes above; and a
   fused PPO pendulum run of 40 iterations (64 envs × 200 steps, the
   reference learning check's learner, seed 3) whose best 3 of the last 6
   mean returns must beat the first 4 by 30, printed as a ``{"fused":
   ...}`` line. Then the overlap schedule (``--overlap``: after two serial
   iterations, collect k+1 runs while learn k does, with the params learn
   k starts from): fused PPO cheetah at 160 envs × 125 steps, 10
   iterations (2 serial, 8 pipelined: a collect graph and a learn graph
   replayed on two streams; the learn captured after its one eager
   iteration, so the serial learn whose seconds the clock notes is a
   replay, and ``overlap_saved_s`` is below the collect's seconds on every
   pipelined iteration whose learn finished first), twice, with the
   plain versions (``kernels="ref"``), on the sync runtime with one sampler and as a
   serial loop written out with the stale params, all bit for bit, and 2
   overlapped iterations against the serial fused run; staleness 0, 0, 0,
   then 1, ``overlap_saved_s`` 0 on the serial iterations and the last;
   each graph's kernel nodes (read by name) equal to its launches per
   replay, the counts to each half's (eager iterations + replays) × those,
   the two graphs' pools apart; seconds per pipelined iteration against
   the serial fused replay on the same carry; fused SAC cheetah
   prioritized (2^20 slots, batch 256), 6 iterations, against the sync
   overlap; sync PPO cheetah N=10 through the train CLI with
   ``--overlap``, inline and over 10 worker processes, bit for bit, with
   collect wall and exposed learn against the serial runs above, printed
   as an ``{"overlap": ...}`` line. Then train -> checkpoint -> serve
   (``serving``): PPO pendulum through the train CLI (10 × 16 × 125, 2
   iterations) with ``--kernels cuda --ckpt-dir``, its pendulum-step and
   GAE launches counted; ``load_policy`` on the card (params bit for bit
   the run's); ``PolicyServer.from_checkpoint`` with 8 slots: a full batch,
   a deadline-expired partial batch and requests one at a time, every
   action bit for bit ``reference_act``'s; a hot-swap published from a
   spawned process through ``ChannelSpec.to_json`` mid-traffic, every
   action the bits of the version its completion reports, both versions
   serving, none dropped; SAC and DDPG cheetah prioritized checkpoints (2
   × 8 × 32, 2 iterations, their replay-kernel launches counted), each
   served and checked the same way; ``serve_policy`` with
   ``--swap-after``; then ``serve_policy`` traffic at 8 slots, a 5 ms
   deadline, 4 clients and 512 requests, and at 64 slots, 64 clients and
   4,096 requests: requests/s, p50 and p99 latency, dispatches and
   occupancy, printed with the card's name and power limit as a
   ``{"serving": ...}`` line; nothing left behind;
5. reference: small PPO, SAC prioritized, TRPO cart-pole and DDPG
   prioritized pendulum runs with the kernels, and the same runs with the
   plain versions (``kernels="ref"``), must end with the same weights bit
   for bit (with the SAC and DDPG replay rings and trees too); hymba-1.5b
   in float32 cut to 4 layers (TF32 off), batch 2, prompts of 16 and of
   2,100 (past the window), 8 decode steps, the plain paths teacher-forced
   with the kernels' tokens: prefill and every step's logits and the final
   k, v, conv and ssm state within ``LM_F32_TOL``; and in bfloat16 run
   (a)'s first request, whose max logit difference and top-1 agreement
   over the prefill and 8 steps are reported, not bounded;
6. timings: each kernel's median time per call (CUDA events around
   back-to-back calls, host launch included) and its device time alone
   (calls captured in a CUDA graph and replayed), the same two for its
   plain version, the least time the card could take (bytes at 3.35 TB/s
   or float32 operations at 67 TFLOP/s, H100 SXM data sheet; an env step's
   reset candidates count only for the rows whose episode ends, the only
   rows whose candidates the kernel reads; a tree op's nodes only where
   this call's paths touch them), and, where one PyTorch call per leaf
   computes the same function (``index_copy_`` for the ring insert,
   ``index_select`` for the gather), that call's time, printed as one JSON
   line ``{"kernels": [...]}``. A replay-ring time covers one call of the
   op over the 5 stored leaves (one launch). The discounted returns lie on
   no path (neither package calls them outside tests and benchmarks); they
   are timed at the GAE shapes, and both also at T 125 × B 163, a batch
   that is not a multiple of 4 (the kernels' scalar loads); the tree
   update at the priority update's B 256 and at an add's B 20,000, the
   find at B 256 and, past its warp a mass, at B 20,000. The LM
   kernels are timed in bfloat16 at run (a)'s shapes and at the long
   request's (the scan, float32, also at falcon-mamba-7b's, with a log
   line giving a second floor beside its
   bound: one MUFU.EX2 per (b, t, d, n) at 16 per SM per clock; and the
   find, not with ``--timing-only``, with a ``sumtree_find_floor`` line:
   the launch floor plus its dependent global trips per mass times one L2
   round trip, measured by a pointer chase that this script builds); their
   operations count the products of the (row, key) pairs the masks let
   through at the bf16 tensor-core rate (989 TFLOP/s), the scan's at the
   float32 rate, and their library yardstick is one
   ``scaled_dot_product_attention`` call (``enable_gqa``, the band or
   validity mask) on the same values in its own layout; the scan has none.
   Every entry also gives the kernels one call launches: the kernel nodes
   of a CUDA graph that captured it. Pendulum and cart-pole are also
   timed at B 16, 64, 160 and 4,096 with no, every and a third of the
   episodes ending (``kernels_at_env_shapes``); outside
   ``--timing-only``, the host time of each env-step wrapper's call at
   B 16 and of each of its steps (leaf check, allocations, pointers and
   argument block, ``ctypes`` call) is printed as an ``env_step_host_us``
   line. Before the kernels, a line of its own
   gives the per-launch floor: ``zero_()`` of 16 floats, a library kernel
   that does next to nothing, timed as the kernels are (``launch_floor``).
   With ``--timing-only`` the script builds the kernels and runs this phase
   alone, on the same inputs, logging the main shapes' entries as
   ``kernels_at_main_shapes`` (no checks, no launch counts): run from two
   checkouts in turn, it times two versions of the kernels on one card.

A ``{"phase_seconds": ...}`` line gives the wall seconds of each phase
from the kernel checks on. The last line is ``{"ok": true, "device":
{...}}``; it is printed only when every phase passed. Without a CUDA device the script exits non-zero at once.
"""
from __future__ import annotations

import argparse
import contextlib
import ctypes
import dataclasses
import glob
import io
import json
import math
import multiprocessing
import os
import statistics
import subprocess
import sys
import threading
import time
import types
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

HBM_BYTES_PER_S = 3.35e12      # H100 SXM, NVIDIA data sheet
F32_OPS_PER_S = 67e12          # H100 SXM float32 outside the tensor cores
BF16_OPS_PER_S = 989e12        # H100 SXM bf16 tensor cores, dense
# the scan's second floor: one MUFU.EX2 per (b, t, d, n); the SFUs give 16
# results per SM per clock: 132 SMs at the 1,980 MHz boost clock (H100 SXM)
EX2_PER_S = 16 * 132 * 1.98e9
ENV_ULPS = 4
# the LM kernels against their plain versions (tests/test_kernels.py's
# bounds for the Pallas kernels): attention in float32 / bfloat16, and the
# scan, relative where the state grows over a long sequence
ATTN_TOL = {torch.float32: 2e-5, torch.bfloat16: 3e-2}
# and a second bound that scales with the output: each row's max |error|
# over the RMS of that row of the float32 result on the same (upcast)
# inputs. Long rows average many keys, so |o| ~ 1/sqrt(keys) falls under
# ATTN_TOL's absolute 3e-2 and only this bound can fail there. In bf16 the
# output's rounding alone gives up to 2^-8 |o|, ~5 RMS at the largest of
# ~10^7 normal values, so 0.02, and the flash kernel's P in bf16 adds
# 2^-8 of each weight; a kernel that drops one 64-key tile of a 2,048-key
# window is off by ~0.4, one that writes zeros by 1
ATTN_REL_TOL = {torch.float32: 1e-4, torch.bfloat16: 5e-2}
SCAN_TOL = 2e-4
# cuda vs ref, float32 hymba-1.5b at 4 layers, on logits of magnitude ~5
# and on the final state: the kernels sum in another order than the plain
# paths (the flash kernel rescales per key, the decode kernel sums chunk by
# chunk and merges the chunks, the scan sums y over the state in another
# order),
# through 4 layers, the fused norms and a 32,001-wide head
LM_F32_TOL = 1e-4

# float operations per instance / element, counted from the kernel bodies
# (adds, multiplies, divides, transcendentals and clamps, one each)
# (ring ops: none; tree ops per node visited: a compare, a subtract and a
# select on the way down, one add per parent on the way up)
OPS = {"pendulum_step": 30, "cartpole_step": 40, "cheetah_step": 150,
       "gae": 7, "discounted_returns": 4, "ring_insert": 0, "ring_gather": 0,
       "sumtree_find": 3, "sumtree_update": 1}
REPLACES = {
    "pendulum_step": "src/repro/kernels/env_step/env_step_pallas.py:102",
    "cartpole_step": "src/repro/kernels/env_step/env_step_pallas.py:177",
    "cheetah_step": "src/repro/kernels/env_step/env_step_pallas.py:254",
    "gae": "src/repro/kernels/gae/gae_pallas.py:117",
    "discounted_returns": "src/repro/kernels/gae/gae_pallas.py:150",
    "ring_insert": "src/repro/kernels/replay_ring/replay_ring_pallas.py:56",
    "ring_gather": "src/repro/kernels/replay_ring/replay_ring_pallas.py:77",
    "sumtree_find": "src/repro/kernels/sum_tree/sum_tree_pallas.py:103",
    "sumtree_update": "src/repro/kernels/sum_tree/sum_tree_pallas.py:126",
    "flash_attention":
        "src/repro/kernels/flash_attention/flash_attention.py:112",
    "decode_attention":
        "src/repro/kernels/decode_attention/decode_attention.py:77",
    "selective_scan": "src/repro/kernels/selective_scan/selective_scan.py:73",
}
SOURCES = {
    "pendulum_step": "src/repro_torch/kernels/csrc/env_step.cu",
    "cartpole_step": "src/repro_torch/kernels/csrc/env_step.cu",
    "cheetah_step": "src/repro_torch/kernels/csrc/env_step.cu",
    "gae": "src/repro_torch/kernels/csrc/gae.cu",
    "discounted_returns": "src/repro_torch/kernels/csrc/gae.cu",
    "ring_insert": "src/repro_torch/kernels/csrc/replay_ring.cu",
    "ring_gather": "src/repro_torch/kernels/csrc/replay_ring.cu",
    "sumtree_find": "src/repro_torch/kernels/csrc/sum_tree.cu",
    "sumtree_update": "src/repro_torch/kernels/csrc/sum_tree.cu",
    "flash_attention": "src/repro_torch/kernels/csrc/flash_attention.cu",
    "decode_attention": "src/repro_torch/kernels/csrc/decode_attention.cu",
    "selective_scan": "src/repro_torch/kernels/csrc/selective_scan.cu",
}
CHEETAH_LEAVES = {"obs": (14,), "actions": (6,), "rewards": (),
                  "next_obs": (14,), "discounts": ()}
CAP = 1 << 20
MAIN_SAMPLERS = (10, 16, 125)   # the main path: samplers, envs each, horizon
# the timing lines besides the kernels line: shape label, JSON key
TIMING_LINES = (("env", "kernels_at_env_shapes"),
                ("vector", "kernels_at_vector_shapes"),
                ("ragged", "kernels_at_ragged_shapes"),
                ("long", "kernels_at_long_request"),
                ("falcon", "kernels_at_falcon_shapes"),
                ("add", "kernels_at_add_shapes"))


def log(msg: str) -> None:
    print(msg, flush=True)


# ----------------------------------------------------------- comparisons
def ulp_distance(a, b):
    """Per-element distance in float32 steps (0 == bitwise equal)."""
    ia = a.view(np.int32).astype(np.int64)
    ib = b.view(np.int32).astype(np.int64)
    ia = np.where(ia < 0, np.int64(-(2 ** 31)) - ia, ia)
    ib = np.where(ib < 0, np.int64(-(2 ** 31)) - ib, ib)
    return np.abs(ia - ib)


def compare(name, got, want, float_ulps):
    """Exact on int/bool leaves; float leaves within ``float_ulps`` steps,
    or ``float_ulps`` steps of the leaf's largest magnitude (cancellation
    near zero). Returns (max ulp, max abs error) over float leaves."""
    worst_ulp, worst_abs = 0, 0.0
    for i, (g, w) in enumerate(zip(got, want)):
        g, w = g.cpu().numpy(), w.cpu().numpy()
        assert g.dtype == w.dtype and g.shape == w.shape, (
            f"{name} leaf {i}: {g.dtype}{g.shape} vs {w.dtype}{w.shape}")
        if g.dtype.kind in "iub":
            assert np.array_equal(g, w), f"{name} leaf {i} differs"
            continue
        err = np.abs(g.astype(np.float64) - w.astype(np.float64))
        ulps = ulp_distance(g, w)
        scale = np.spacing(np.float32(max(np.abs(w).max(initial=0), 1e-30)))
        ok = (ulps <= float_ulps) | (err <= float_ulps * float(scale))
        assert ok.all(), (f"{name} leaf {i}: {int((~ok).sum())} elements "
                          f"past {float_ulps} ulp (max {int(ulps.max())})")
        worst_ulp = max(worst_ulp, int(ulps.max(initial=0)))
        worst_abs = max(worst_abs, float(err.max(initial=0)))
    return worst_ulp, worst_abs


def leaves(out):
    state, obs, rew, done = out
    return list(state) + [obs, rew, done]


# ---------------------------------------------------------------- inputs
def env_inputs(name, B, horizon, seed):
    """Random state/actions/reset candidates on the card; a third of the
    rows at their last step."""
    rng = np.random.default_rng(seed)
    dev = "cuda"

    def f(*shape, lo=-1.0, hi=1.0):
        return torch.from_numpy(
            rng.uniform(lo, hi, shape).astype(np.float32)).to(dev)

    t = rng.integers(0, horizon - 1, B).astype(np.int32)
    t[: B // 3] = horizon - 1
    rng.shuffle(t)
    t = torch.from_numpy(t).to(dev)
    rt = torch.zeros(B, dtype=torch.int32, device=dev)
    if name == "pendulum":
        state = (f(B, lo=-3 * math.pi, hi=3 * math.pi), f(B, lo=-8, hi=8), t)
        reset = (f(B, lo=-math.pi, hi=math.pi), f(B), rt)
        return (state, f(B, 1, lo=-3, hi=3), reset, f(B, 3),
                dict(max_torque=2.0))
    if name == "cartpole":
        # x and th around their limits (2.4, 12 degrees): poles fall and
        # carts leave the track; actions beyond the force clip
        state = (f(B, lo=-2.5, hi=2.5), f(B, lo=-2, hi=2),
                 f(B, lo=-0.25, hi=0.25), f(B, lo=-2, hi=2), t)
        reset = tuple(f(B, lo=-0.05, hi=0.05) for _ in range(4)) + (rt,)
        return state, f(B, 1, lo=-2, hi=2), reset, f(B, 4), dict(
            force_max=10.0)
    state = (f(B, 6), f(B, 6), f(B, lo=-2, hi=2), f(B), t)
    reset = (f(B, 6, lo=-0.1, hi=0.1), f(B, 6, lo=-0.1, hi=0.1),
             torch.zeros(B, device=dev), torch.zeros(B, device=dev), rt)
    return state, f(B, 6, lo=-2, hi=2), reset, f(B, 14), dict(ctrl_cost=0.1)


def gae_inputs(T, B, seed):
    rng = np.random.default_rng(seed)
    r = rng.standard_normal((T, B)).astype(np.float32)
    v = rng.standard_normal((T, B)).astype(np.float32)
    d = rng.random((T, B)) < 0.05
    lv = rng.standard_normal(B).astype(np.float32)
    return [torch.from_numpy(x).to("cuda") for x in (r, v, d, lv)]


# the redesigned kernels' tile edges: gae's 32-column blocks, 32-row
# vector loads and 64-step chunks, cheetah's 5 envs a warp and 20 a block,
# pendulum's and cart-pole's warps and 256-thread blocks
GAE_EDGE_T = (1, 31, 32, 33, 125, 128, 129, 1000)
GAE_EDGE_B = (1, 31, 33, 160, 4096, 4097)
GAE_DONES = ("none", "all", "t=0", "t=T-1", "10%")
CHEETAH_EDGE_B = (1, 16, 31, 33, 4096, 4097)
CHEETAH_ENDS = ("none", "all", "mixed")
ENV_EDGE_B = (1, 16, 31, 32, 33, 64, 160, 255, 256, 257, 4096, 4097,
              16384)
# the redesigned find's edges: no level to read (cap 1) up to 2^20 leaves,
# batches around a block (8 masses of a warp each, 256 of a thread each)
# and around the switch from a warp a mass to a thread a mass past 4,096;
# the returns' 64-step chunks and 32-column blocks
# (tests/test_torch_kernels_gpu.py holds the same)
FIND_EDGE_CAP = (1, 2, 32, 1024, 1 << 20)
FIND_EDGE_B = (1, 8, 9, 31, 32, 33, 256, 257, 4096, 4097, 20000)
RETURNS_EDGE_T = (1, 63, 64, 65, 128, 129)
RETURNS_EDGE_B = (1, 31, 32, 33, 160, 163, 4096)
# the env sweep of phase 6: pendulum and cart-pole at a sampler's 16 envs,
# the fused learning run's 64, the fused carry's 160 and the vector 4,096
ENV_TIMING_B = (16, 64, 160, 4096)
# the trig sweep: every float32 bit pattern, in chunks
SWEEP_CHUNK = 1 << 24
# the obs and reward dtypes of the env-step kernels beside float32
HALF_DTYPES = (torch.float16, torch.bfloat16)


def gae_edge_inputs(T, B, dones, seed):
    """``gae_inputs`` with the episode ends of ``dones``: none, all, only
    at t = 0, only at t = T - 1, or 10 % at random."""
    r, v, _, lv = gae_inputs(T, B, seed)
    rng = np.random.default_rng(seed + 1)
    d = torch.zeros((T, B), dtype=torch.bool, device="cuda")
    if dones == "all":
        d[:] = True
    elif dones == "t=0":
        d[0] = True
    elif dones == "t=T-1":
        d[-1] = True
    elif dones == "10%":
        d = torch.from_numpy(rng.random((T, B)) < 0.1).to("cuda")
    return r, v, d, lv


def find_edge_inputs(cap, B, seed):
    """A tree of integer masses on the card (every sum exact in float32, so
    a mass equal to a prefix sum ties with the stored nodes), with zero-mass
    leaves, a run of them and a zero-mass right subtree; and B masses: 0,
    the root, above the root, a negative one, NaN, the stored prefix sums
    at the leaves around every power of two (so at every chunk of levels
    some descent turns) and at random leaves, then stratified ones."""
    from repro_torch.kernels.sum_tree import sumtree_build
    rng = np.random.default_rng(seed)
    x = rng.integers(1, 8, cap).astype(np.float32)
    x[rng.random(cap) < 0.3] = 0.0
    x[cap // 8: cap // 8 + cap // 16] = 0.0
    x[3 * cap // 4:] = 0.0
    prefix = np.concatenate([[0.0], np.cumsum(x, dtype=np.float64)])
    total = prefix[-1]
    turns = sorted({i for j in range(cap.bit_length())
                    for i in (2 ** j - 1, 2 ** j, 2 ** j + 1) if i <= cap})
    special = np.array([0.0, total, total + 1.0, -1.0, np.nan]
                       + [prefix[i] for i in turns]
                       + list(prefix[rng.integers(0, cap + 1, 8)]))
    strat = (np.arange(B) + rng.random(B)) / max(B, 1) * total
    m = np.concatenate([np.roll(special, B), strat])[:B].astype(np.float32)
    return (sumtree_build(torch.from_numpy(x).to("cuda")),
            torch.from_numpy(m).to("cuda"))


def env_edge_inputs(name, B, ends, horizon, seed):
    """``env_inputs`` with no, every or a third of the rows at their last
    step; cart-pole's "none" also keeps every cart and pole inside the
    fall limits (|x| <= 2.3 and |th| <= 0.16 before a step of at most
    0.04 and 0.04)."""
    state, a, rs, ro, p = env_inputs(name, B, horizon, seed)
    if ends != "mixed":
        state[-1].fill_(horizon - 1 if ends == "all" else horizon - 2)
    if name == "cartpole" and ends == "none":
        state[0].mul_(2.3 / 2.5)
        state[2].mul_(0.16 / 0.25)
    return state, a, rs, ro, p


def bits(x):
    """A float tensor's bits as an integer tensor (NaNs compare by their
    bits)."""
    if x.dtype == torch.float32:
        return x.view(torch.int32)
    return x.view(torch.int16) if x.dtype in HALF_DTYPES else x


def same_bits(label, got, want):
    """Every leaf of two env-step results equal bit for bit."""
    for k, (g, w) in enumerate(zip(leaves(got), leaves(want))):
        assert g.dtype == w.dtype and g.shape == w.shape, (label, k)
        assert torch.equal(bits(g), bits(w)), (
            f"{label} leaf {k}: {int((bits(g) != bits(w)).sum())} "
            f"elements differ")


def sweep_inputs(name, lo, n, horizon):
    """Float bit patterns lo ... lo + n - 1 as pendulum's next angle or
    cart-pole's angle, no episode ending by time. Pendulum: th = x, u = -0
    and thdot = -y for y = (15 sin x + 3 u) 0.05, the kernel's and the
    plain version's own increment, so the stepped thdot is +0 and the next
    angle x exactly (y = -0 keeps thdot -0, so that -0 stays -0): the obs
    are cos x and sin x. Cart-pole: th = x, the rest 0; a pole past the
    fall limit takes its reset candidates, so there the trig shows only
    inside the limits."""
    x = (torch.arange(lo, lo + n, device="cuda", dtype=torch.int64)
         .to(torch.int32).view(torch.float32))
    z = torch.zeros(n, device="cuda")
    t = torch.zeros(n, dtype=torch.int32, device="cuda")
    if name == "pendulum":
        u = torch.full((n, 1), -0.0, device="cuda")
        y = (15.0 * torch.sin(x) + 3.0 * u[:, 0]) * 0.05
        state = (x, torch.where(y == 0, y, -y), t)
        return state, u, (z, z, t), torch.zeros(n, 3, device="cuda"), dict(
            max_torque=2.0)
    state = (z, z, x, z, t)
    return state, torch.zeros(n, 1, device="cuda"), (z, z, z, z, t), \
        torch.zeros(n, 4, device="cuda"), dict(force_max=10.0)


def check_trig_sweep():
    """Pendulum and cart-pole over every float32 bit pattern (``sweep_
    inputs``: subnormals, +-0, the trig's slow path past |x| = 105,615,
    +-inf and NaNs included), every leaf bit for bit against the plain
    version; pendulum's obs carry sincosf's cos and sin of every finite
    angle against ATen's cos and sin."""
    from repro_torch.kernels.env_step import ops as env_ops
    from repro_torch.kernels.env_step import ref as env_ref
    horizon, t0 = 50, time.perf_counter()
    for name in ("pendulum", "cartpole"):
        wrapper = env_ops.STEP_BATCH_CUDA[name]
        for lo in range(-(1 << 31), 1 << 31, SWEEP_CHUNK):
            state, a, rs, ro, p = sweep_inputs(name, lo, SWEEP_CHUNK,
                                               horizon)
            params = dict(max_episode_steps=horizon, reward_scale=1.0, **p)
            got = wrapper(state, a, rs, ro, **params)
            want = env_ref.STEP_BATCH_REF[name](state, a, rs, ro, **params)
            if name == "pendulum":      # the next angle is x itself
                fin = torch.isfinite(state[0])
                assert torch.equal(bits(want[0][0])[fin],
                                   bits(state[0])[fin])
            same_bits(f"{name} sweep from {lo}", got, want)
    log(f"check the trig sweep: pendulum and cart-pole over all 2^32 "
        f"float32 patterns, every leaf bit for bit "
        f"({time.perf_counter() - t0:.1f} s)")


def check_rl_edges():
    """Phase 3 for the redesigned RL kernels at their edges: every leaf bit
    for bit, one launch per call."""
    from repro_torch.kernels.env_step import ops as env_ops
    from repro_torch.kernels.env_step import ref as env_ref
    from repro_torch.kernels.gae import ops as gae_ops
    from repro_torch.kernels.sum_tree import ops as tree_ops
    n = 0
    for cap in FIND_EDGE_CAP:
        for B in FIND_EDGE_B:
            tree, masses = find_edge_inputs(cap, B, seed=cap + B)
            before = tree_ops.sumtree_find_cuda.launches
            got = tree_ops.sumtree_find_cuda(tree, masses)
            want = tree_ops.sumtree_find_batch_ref(tree, masses)
            torch.cuda.synchronize()
            assert tree_ops.sumtree_find_cuda.launches == before + 1
            assert got.dtype == torch.int32 and torch.equal(got, want), (
                f"sumtree_find cap={cap} B={B}: "
                f"{int((got != want).sum())} leaves differ")
            n += 1
    log(f"check sumtree_find at its edges: cap in {FIND_EDGE_CAP} x B in "
        f"{FIND_EDGE_B}, masses at ties, 0, the root and above, negative, "
        f"NaN: {n} calls, bit for bit")
    n = 0
    for T in RETURNS_EDGE_T:
        for B in RETURNS_EDGE_B:
            for dones in GAE_DONES:
                r, _, d, lv = gae_edge_inputs(T, B, dones, seed=T * B + 1)
                before = gae_ops.discounted_returns_cuda.launches
                got = gae_ops.discounted_returns_cuda(r, d, lv, gamma=0.99)
                want = gae_ops.discounted_returns_ref(r, d, lv, 0.99)
                torch.cuda.synchronize()
                assert gae_ops.discounted_returns_cuda.launches == before + 1
                assert torch.equal(got, want), (
                    f"discounted_returns T={T} B={B} dones {dones}: "
                    f"{int((got != want).sum())} elements differ")
                n += 1
    # inputs one element past an aligned start take the scalar loads
    for T, B in ((64, 32), (125, 160), (129, 4096)):
        r, _, d, lv = gae_edge_inputs(T, B, "10%", seed=T + B)
        ru = torch.cat([torch.zeros(1, device="cuda"), r.reshape(-1)])[1:]
        du = torch.cat([torch.zeros(1, dtype=torch.bool, device="cuda"),
                        d.reshape(-1)])[1:]
        for rr, dd in ((ru.view(T, B), d), (r, du.view(T, B))):
            got = gae_ops.discounted_returns_cuda(rr, dd, lv, gamma=0.99)
            want = gae_ops.discounted_returns_ref(rr, dd, lv, 0.99)
            torch.cuda.synchronize()
            assert torch.equal(got, want), (
                f"discounted_returns T={T} B={B} unaligned")
            n += 1
    for T, B in ((0, 160), (5, 0)):
        r, _, d, lv = gae_edge_inputs(T, B, "none", seed=1)
        before = gae_ops.discounted_returns_cuda.launches
        got = gae_ops.discounted_returns_cuda(r, d, lv, gamma=0.99)
        assert got.shape == (T, B)
        assert gae_ops.discounted_returns_cuda.launches == before
        n += 1
    log(f"check discounted_returns at the tile edges: T in "
        f"{RETURNS_EDGE_T} x B in {RETURNS_EDGE_B} x dones {GAE_DONES}, "
        f"unaligned rewards and dones, T 0 and B 0: {n} calls, bit for bit")
    n = 0
    for T in GAE_EDGE_T:
        for B in GAE_EDGE_B:
            for dones in GAE_DONES:
                r, v, d, lv = gae_edge_inputs(T, B, dones, seed=T * B)
                before = gae_ops.gae_cuda.launches
                got = gae_ops.gae_cuda(r, v, d, lv, gamma=0.99, lam=0.95)
                want = gae_ops.gae_ref(r, v, d, lv, 0.99, 0.95)
                torch.cuda.synchronize()
                assert gae_ops.gae_cuda.launches == before + 1
                for g, w in zip(got, want):
                    assert torch.equal(g, w), (
                        f"gae T={T} B={B} dones {dones}: "
                        f"{int((g != w).sum())} elements differ")
                n += 1
    log(f"check gae at the tile edges: T in {GAE_EDGE_T} x B in "
        f"{GAE_EDGE_B} x dones {GAE_DONES}: {n} calls, bit for bit")
    horizon, n = 50, 0
    for B in CHEETAH_EDGE_B:
        for ends in CHEETAH_ENDS:
            state, a, rs, ro, p = env_edge_inputs("cheetah", B, ends,
                                                  horizon, seed=B + 5)
            params = dict(max_episode_steps=horizon, reward_scale=0.5, **p)
            before = env_ops.cheetah_step_cuda.launches
            got = env_ops.cheetah_step_cuda(state, a, rs, ro, **params)
            want = env_ref.cheetah_step_batch_ref(state, a, rs, ro, **params)
            torch.cuda.synchronize()
            assert env_ops.cheetah_step_cuda.launches == before + 1
            compare(f"cheetah B={B} ends {ends}", leaves(got), leaves(want),
                    0)
            resets = int(got[3].sum())
            assert resets == {"none": 0, "all": B}.get(ends, resets) and (
                ends != "mixed" or resets >= B // 3), (B, ends, resets)
            n += 1
    log(f"check cheetah_step at the tile edges: B in {CHEETAH_EDGE_B} x "
        f"episode ends {CHEETAH_ENDS}: {n} calls, every leaf bit for bit")
    for name in ("pendulum", "cartpole"):
        wrapper, n = env_ops.STEP_BATCH_CUDA[name], 0
        for B in ENV_EDGE_B:
            for ends in CHEETAH_ENDS:
                state, a, rs, ro, p = env_edge_inputs(name, B, ends, horizon,
                                                      seed=B + 6)
                params = dict(max_episode_steps=horizon, reward_scale=0.5,
                              **p)
                before = wrapper.launches
                got = wrapper(state, a, rs, ro, **params)
                want = env_ref.STEP_BATCH_REF[name](state, a, rs, ro,
                                                    **params)
                torch.cuda.synchronize()
                assert wrapper.launches == before + 1
                same_bits(f"{name} B={B} ends {ends}", got, want)
                resets = int(got[3].sum())
                assert resets == {"none": 0, "all": B}.get(ends, resets) and (
                    ends != "mixed" or resets >= B // 3), (name, B, ends)
                n += 1
        # NaN in every input leaf of a few rows; a reset obs that is not
        # 16-byte aligned (cart-pole's rows then move a float at a time)
        state, a, rs, ro, p = env_edge_inputs(name, 4097, "mixed", horizon,
                                              seed=7)
        for leaf in (*state[:-1], a, *rs[:-1], ro):
            leaf.view(-1)[torch.randperm(leaf.numel(), device="cuda")[:40]] \
                = float("nan")
        ro = torch.cat([torch.zeros(1, device="cuda"), ro.view(-1)])[1:] \
            .view(ro.shape)
        params = dict(max_episode_steps=horizon, reward_scale=1.0, **p)
        got = wrapper(state, a, rs, ro, **params)
        want = env_ref.STEP_BATCH_REF[name](state, a, rs, ro, **params)
        same_bits(f"{name} NaN rows, unaligned reset obs", got, want)
        n += 1
        log(f"check {name}_step at the block edges: B in {ENV_EDGE_B} x "
            f"episode ends {CHEETAH_ENDS}, NaN rows and an unaligned reset "
            f"obs: {n} calls, every leaf bit for bit")
    check_trig_sweep()
    check_env_dtypes()


def check_env_dtypes():
    """The three env-step kernels storing float16 and bfloat16 obs and
    rewards (the reset obs in that dtype too), every leaf bit for bit
    against the plain version at the same dtype, one launch a call: cheetah
    at B in ``CHEETAH_EDGE_B``, pendulum and cart-pole at B in
    ``ENV_EDGE_B``, each with no, every and a third of the episodes ending;
    then each env with NaN in a few rows of every float input and a reset
    obs one element past an aligned start."""
    from repro_torch.kernels.env_step import ops as env_ops
    from repro_torch.kernels.env_step import ref as env_ref
    horizon, n = 50, 0
    sweep = {"pendulum": ENV_EDGE_B, "cartpole": ENV_EDGE_B,
             "cheetah": CHEETAH_EDGE_B}
    for dtype in HALF_DTYPES:
        for name, batches in sweep.items():
            wrapper = env_ops.STEP_BATCH_CUDA[name]

            def both(state, a, rs, ro, scale):
                params = dict(max_episode_steps=horizon, reward_scale=scale,
                              dtype=dtype, **p)
                before = wrapper.launches
                got = wrapper(state, a, rs, ro, **params)
                want = env_ref.STEP_BATCH_REF[name](state, a, rs, ro,
                                                    **params)
                torch.cuda.synchronize()
                assert wrapper.launches == before + 1, name
                assert got[1].dtype == got[2].dtype == dtype, name
                return got, want

            for B in batches:
                for ends in CHEETAH_ENDS:
                    state, a, rs, ro, p = env_edge_inputs(
                        name, B, ends, horizon, seed=B + 8)
                    got, want = both(state, a, rs, ro.to(dtype), 0.5)
                    same_bits(f"{name} {dtype} B={B} ends {ends}", got,
                              want)
                    resets = int(got[3].sum())
                    assert resets == {"none": 0, "all": B}.get(
                        ends, resets) and (
                        ends != "mixed" or resets >= B // 3), (
                        name, dtype, B, ends)
                    n += 1
            state, a, rs, ro, p = env_edge_inputs(name, 4097, "mixed",
                                                  horizon, seed=9)
            ro = ro.to(dtype)
            for leaf in (*state[:-1], a, *rs[:-1], ro):
                leaf.view(-1)[torch.randperm(leaf.numel(),
                                             device="cuda")[:40]] = float(
                    "nan")
            ro = torch.cat([torch.zeros(1, dtype=dtype, device="cuda"),
                            ro.view(-1)])[1:].view(ro.shape)
            got, want = both(state, a, rs, ro, 1.0)
            same_bits(f"{name} {dtype} NaN rows, unaligned reset obs", got,
                      want)
            n += 1
    log(f"check the env steps at float16 and bfloat16 obs and rewards: "
        f"cheetah at B in {CHEETAH_EDGE_B}, pendulum and cart-pole at B in "
        f"{ENV_EDGE_B}, x episode ends {CHEETAH_ENDS}, NaN rows and an "
        f"unaligned reset obs: {n} calls, every leaf bit for bit")


def ring_leaves(rows, gen, kinds=None):
    """Random leaves of ``rows`` rows on the card: the SAC cheetah
    transition schema by default, else ``{name: (trailing shape, dtype)}``."""
    kinds = kinds or {k: (s, torch.float32) for k, s in
                      CHEETAH_LEAVES.items()}
    out = {}
    for k, (shape, dtype) in kinds.items():
        size = (rows,) + tuple(shape)
        if dtype == torch.bool:
            out[k] = torch.rand(size, generator=gen, device="cuda") < 0.5
        elif dtype == torch.int32:
            out[k] = torch.randint(-9, 9, size, generator=gen,
                                   device="cuda", dtype=torch.int32)
        else:
            out[k] = torch.randn(size, generator=gen, device="cuda"
                                 ).to(dtype)
    return out


MIXED_LEAVES = {"f14": ((14,), torch.float32), "f": ((), torch.float32),
                "f4": ((4,), torch.float32), "b3": ((3,), torch.bool),
                "i2": ((2,), torch.int32), "h5": ((5,), torch.bfloat16),
                "z": ((0,), torch.float32)}


def random_tree(cap, filled, gen):
    """A sum tree on the card with ``filled`` leading leaves of positive
    mass (a third of them zero), the rest zero."""
    from repro_torch.kernels.sum_tree import sumtree_build
    leaves = torch.zeros(cap, device="cuda")
    x = torch.rand(filled, generator=gen, device="cuda")
    leaves[:filled] = torch.where(x < 0.33, torch.zeros_like(x), x)
    return sumtree_build(leaves)


def stratified_masses(tree, B, gen):
    u = torch.rand(B, generator=gen, device="cuda")
    return ((torch.arange(B, device="cuda") + u)
            / torch.tensor(float(B), device="cuda")) * tree.total


def tree_path_nodes(idx, cap):
    """Distinct parents on the root paths of leaf indices ``idx``, level by
    level above the leaves: the nodes a descent reads the left child of,
    and an update rewrites."""
    idx = idx.to(torch.int64)
    return [int(torch.unique(idx >> (k + 1)).numel())
            for k in range(cap.bit_length() - 1)]


def tree_update_bytes(idx, cap):
    """Bytes a batched leaf update must move beyond ``idx`` and the values:
    each distinct leaf written once, each touched parent written once, and
    each child of a touched parent read only where it is not itself on a
    touched path (a touched child's value was just written by the call)."""
    idx = idx.to(torch.int64)
    touched = [int(torch.unique(idx >> k).numel())
               for k in range(cap.bit_length())]
    return 4 * touched[0] + sum(4 * p + 4 * (2 * p - c)
                                for c, p in zip(touched, touched[1:]))


# ---------------------------------------------------------------- timing
def time_ms(fn, reps, rounds=5):
    """Median over ``rounds`` of the mean time of ``reps`` back-to-back
    calls, between CUDA events, after a warm-up."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    samples = []
    for _ in range(rounds):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        stop.record()
        torch.cuda.synchronize()
        samples.append(start.elapsed_time(stop) / reps)
    return statistics.median(samples)


def graph_ms(fn, reps):
    """Device time per call: ``reps`` calls captured in one CUDA graph,
    replayed between CUDA events, so the host's launch cost is left out."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    return time_ms(graph.replay, 1) / reps


def graph_kernel_nodes(graph):
    """The kernel nodes of a CUDA graph kept after its capture
    (``keep_graph=True``), read back through the driver API
    (``cuGraphGetNodes``; copies and memsets are other node types), with
    the driver library."""
    cu = ctypes.CDLL("libcuda.so.1")
    handle = ctypes.c_void_p(graph.raw_cuda_graph())
    n = ctypes.c_size_t(0)
    assert cu.cuGraphGetNodes(handle, None, ctypes.byref(n)) == 0
    nodes = (ctypes.c_void_p * n.value)()
    assert cu.cuGraphGetNodes(handle, nodes, ctypes.byref(n)) == 0
    kind, kernels = ctypes.c_int(), []
    for node in nodes:
        assert cu.cuGraphNodeGetType(ctypes.c_void_p(node),
                                     ctypes.byref(kind)) == 0
        if kind.value == 0:                 # CU_GRAPH_NODE_TYPE_KERNEL
            kernels.append(node)
    return cu, kernels


def kernels_per_call(fn):
    """The kernels one call of ``fn`` launches: the kernel nodes of a CUDA
    graph that captured the call."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(graph):
        fn()
    kernels = len(graph_kernel_nodes(graph)[1])
    assert kernels > 0, "the captured call launched no kernel"
    return kernels


class KernelNodeParams(ctypes.Structure):
    """``CUDA_KERNEL_NODE_PARAMS_v2`` of ``cuda.h``."""
    _fields_ = [("func", ctypes.c_void_p), ("grid", ctypes.c_uint * 3),
                ("block", ctypes.c_uint * 3), ("shared_mem", ctypes.c_uint),
                ("params", ctypes.c_void_p), ("extra", ctypes.c_void_p),
                ("kern", ctypes.c_void_p), ("ctx", ctypes.c_void_p)]


# the kernels that start a call of each wrapper: a call launches exactly
# one of them (a sum-tree update is the one-block walk, or a marking
# kernel and then the subtree kernel; a decode call is a split and a
# combine; a scan call may start with its chunk states)
CALL_KERNELS = {
    "pendulum_step": ("pendulum_step_kernel",),
    "cartpole_step": ("cartpole_step_kernel",),
    "cheetah_step": ("cheetah_step_kernel",),
    "gae": ("gae_kernel",),
    "discounted_returns": ("discounted_returns_kernel",),
    "ring_insert": ("insert_rows",),
    "ring_gather": ("gather_rows",),
    "sumtree_find": ("find_kernel",),
    "sumtree_update": ("walk_kernel", "mark_kernel"),
    "flash_attention": ("flash_attention_tc", "flash_attention_kernel"),
    "decode_attention": ("decode_split",),
    "selective_scan": ("scan_kernel",),
}


def graph_kernel_calls(graph):
    """The calls of each of the port's kernels that a kept CUDA graph
    holds: its kernel nodes, named by their function (``cuFuncGetName``,
    or ``cuKernelGetName`` for a node that holds a library kernel), matched
    to ``CALL_KERNELS`` by the length-prefixed identifier of the mangled
    name."""
    cu, nodes = graph_kernel_nodes(graph)
    calls = {}
    for node in nodes:
        p = KernelNodeParams()
        rc = cu.cuGraphKernelNodeGetParams_v2(ctypes.c_void_p(node),
                                              ctypes.byref(p))
        assert rc == 0, f"cuGraphKernelNodeGetParams_v2: CUresult {rc}"
        name = ctypes.c_char_p()
        if p.func:
            rc = cu.cuFuncGetName(ctypes.byref(name), ctypes.c_void_p(p.func))
        else:
            rc = cu.cuKernelGetName(ctypes.byref(name),
                                    ctypes.c_void_p(p.kern))
        assert rc == 0 and name.value, f"kernel node name: CUresult {rc}"
        fn = name.value.decode()
        for wrapper, starts in CALL_KERNELS.items():
            if any(f"{len(k)}{k}" in fn for k in starts):
                calls[wrapper] = calls.get(wrapper, 0) + 1
    return calls


def measure(kernel, shape, n, moved, fn, plain, reps, plain_reps,
            library=None, plain_graph=True, ops=None, rate=F32_OPS_PER_S):
    """Timings of one kernel and its plain version on the same inputs:
    ``ms``/``plain_ms`` per call as the main path makes it (host launch
    included), ``device_ms``/``plain_device_ms`` from graph replay (None
    where the plain version syncs with the host and so cannot be
    captured), and ``library_ms`` for one PyTorch call of the same
    function, where there is one; ``kernels_per_call``, the kernels one
    call launches. ``ops`` at ``rate`` replaces the
    per-instance count ``OPS[kernel] * n``."""
    b_ms, b_by = bound(kernel, n, moved, ops, rate)
    return {"kernels_per_call": kernels_per_call(fn),
            "ms": time_ms(fn, reps), "plain_ms": time_ms(plain, plain_reps),
            "device_ms": graph_ms(fn, reps),
            "plain_device_ms": (graph_ms(plain, plain_reps) if plain_graph
                                else None),
            "library_ms": None if library is None else time_ms(library, reps),
            "bound_ms": b_ms, "bound_by": b_by, "shape": shape,
            "bytes": moved}


def nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


def bound(kernel, n, moved, ops=None, rate=F32_OPS_PER_S):
    """(bound_ms, bound_by) for ``n`` instances/elements moving ``moved``
    bytes (or ``ops`` operations at ``rate``)."""
    t_bytes = moved / HBM_BYTES_PER_S * 1e3
    t_ops = (OPS[kernel] * n if ops is None else ops) / rate * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# -------------------------------------------------------------- LM slice
HYMBA = dict(B=4, P=16 + 128, gen=32)       # run (a): prompt 16 + 128 meta
LONG = dict(B=1, P=4096 + 128, gen=16)      # run (b): past the window 2048
FALCON = dict(B=4, P=16)                    # falcon-mamba-7b's serve run


def scan_inputs(B, S, Di, N, gen, h0_scale=0.0):
    """Random scan inputs on the card: dt = softplus(normal) / 10 and
    A = -exp(normal / 5), as tests/test_kernels.py draws them."""
    def rnd(*shape):
        return torch.randn(shape, generator=gen, device="cuda")
    dt = torch.nn.functional.softplus(rnd(B, S, Di)) * 0.1
    A = -torch.exp(rnd(Di, N) * 0.2)
    return dt, A, rnd(B, S, N), rnd(B, S, N), rnd(B, S, Di), rnd(
        B, Di, N) * h0_scale


def attn_inputs(B, S, K, G, hd, dtype, gen):
    def rnd(*shape):
        return torch.randn(shape, generator=gen, device="cuda").to(dtype)
    return rnd(B, S, K, G, hd), rnd(B, S, K, hd), rnd(B, S, K, hd)


def decode_inputs(B, K, G, Sc, hd, dtype, p_valid, gen):
    """Random q and caches on the card; slot 0 and a ``p_valid`` share of
    the others valid, or only the slots ``p_valid`` lists."""
    q = torch.randn((B, K, G, hd), generator=gen, device="cuda").to(dtype)
    kc, vc = (torch.randn((B, Sc, K, hd), generator=gen, device="cuda"
                          ).to(dtype) for _ in range(2))
    if isinstance(p_valid, tuple):
        valid = torch.zeros(Sc, dtype=torch.bool, device="cuda")
        valid[list(p_valid)] = True
    else:
        valid = torch.rand(Sc, generator=gen, device="cuda") < p_valid
        valid[0] = True
    return q, kc, vc, valid


def max_err(got, want, rel=False):
    """max |got - want|; with ``rel``, over max(1, |want|)."""
    err = (got.double() - want.double()).abs()
    if rel:
        err = err / want.double().abs().clamp_min(1.0)
    return float(err.max())


def row_rel_err(got, exact):
    """max over rows (all but the last axis) of max |got - exact| over the
    row's RMS of ``exact``."""
    w = exact.double()
    rms = w.square().mean(-1).sqrt()
    return float(((got.double() - w).abs().amax(-1) / rms).max())


def check_lm_kernels(errs, gen):
    """Phase 3 for the LM kernels: each wrapper against its plain version
    at the serve runs' shapes and at ragged ones."""
    from repro_torch.kernels.decode_attention import ops as dec_ops
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.selective_scan import ops as scan_ops

    def note(name, err):
        errs[name] = (None, max(errs[name][1], err))

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for B, S, Di, N, h0 in ((HYMBA["B"], HYMBA["P"], 3200, 16, 0.0),
                            (LONG["B"], LONG["P"], 3200, 16, 0.0),
                            (FALCON["B"], FALCON["P"], 8192, 16, 0.0),
                            (3, 37, 100, 5, 0.0), (2, 300, 256, 16, 1.0),
                            # chunked: ragged chunks, N 1 and 5, h0
                            (1, 1000, 40, 1, 1.0), (2, 700, 70, 5, 1.0),
                            (3, 0, 64, 16, 1.0)):
        args = scan_inputs(B, S, Di, N, gen, h0)
        got = scan_ops.selective_scan_cuda(*args)
        want = scan_ops.selective_scan_ref(*args)
        torch.cuda.synchronize()
        pairs = [(g, w) for g, w in zip(got, want) if w.numel()]
        err = max(max_err(g, w, rel=True) for g, w in pairs)
        assert err <= SCAN_TOL, f"selective_scan B={B} S={S}: {err}"
        note("selective_scan", max(max_err(g, w) for g, w in pairs))
        chunk = scan_ops.plan_chunk(B, S, Di, sms)
        log(f"check selective_scan B={B} S={S} Di={Di} N={N} h0*{h0} "
            f"({scan_ops.n_chunks(S, chunk)} chunks of {chunk}): max rel "
            f"err {err:.3g}")
    for B, S, K, G, hd, causal, window, dtypes in (
            (HYMBA["B"], HYMBA["P"], 5, 5, 64, True, 2048,
             (torch.bfloat16, torch.float32)),
            (LONG["B"], LONG["P"], 5, 5, 64, True, 2048,
             (torch.bfloat16, torch.float32)),
            (2, 300, 2, 4, 128, True, 0, (torch.bfloat16, torch.float32)),
            (2, 129, 2, 2, 32, False, 0, (torch.bfloat16, torch.float32)),
            (1, 77, 4, 1, 32, True, 20, (torch.bfloat16, torch.float32)),
            # S not a multiple of the tiles; window edges inside tiles; G 1
            (1, 1000, 2, 3, 64, True, 0, (torch.bfloat16, torch.float32)),
            (1, 1000, 1, 1, 128, True, 90, (torch.bfloat16, torch.float32)),
            (2, 1000, 2, 2, 32, True, 300, (torch.bfloat16,))):
        for dtype in dtypes:
            q, k, v = attn_inputs(B, S, K, G, hd, dtype, gen)
            got = fa_ops.flash_attention_cuda(q, k, v, causal=causal,
                                              window=window)
            want = fa_ops.flash_attention(q, k, v, causal=causal,
                                          window=window, impl="ref")
            exact = want if dtype == torch.float32 else fa_ops.flash_attention(
                q.float(), k.float(), v.float(), causal=causal,
                window=window, impl="ref")
            torch.cuda.synchronize()
            err, rel = max_err(got, want), row_rel_err(got, exact)
            log(f"check flash_attention B={B} S={S} K={K} G={G} hd={hd} "
                f"causal={causal} window={window} {dtype}: max abs err "
                f"{err:.3g}, max row err / row RMS {rel:.3g}")
            assert err <= ATTN_TOL[dtype] and rel <= ATTN_REL_TOL[dtype], (
                f"flash_attention S={S} hd={hd} {dtype}: {err}, {rel}")
            note("flash_attention", err)
    for B, K, G, Sc, hd, p_valid in ((HYMBA["B"], 5, 5, 176, 64, 0.6),
                                     (LONG["B"], 5, 5, 2048, 64, 1.0),
                                     (3, 2, 3, 300, 32, 0.5),
                                     (2, 2, 4, 500, 128, 0.8),
                                     (2, 5, 5, 1, 64, 1.0),
                                     # whole chunks empty: slots 0 and 2047
                                     (1, 5, 5, 2048, 64, (0, 2047)),
                                     # past the old shared-memory limit
                                     (1, 2, 5, 70000, 64, 0.9)):
        for dtype in (torch.bfloat16, torch.float32):
            q, kc, vc, valid = decode_inputs(B, K, G, Sc, hd, dtype, p_valid,
                                             gen)
            got = dec_ops.decode_attention_cuda(q, kc, vc, valid)
            want = dec_ops.decode_attention(q, kc, vc, valid, impl="ref")
            exact = want if dtype == torch.float32 else \
                dec_ops.decode_attention(q.float(), kc.float(), vc.float(),
                                         valid, impl="ref")
            torch.cuda.synchronize()
            err, rel = max_err(got, want), row_rel_err(got, exact)
            log(f"check decode_attention B={B} K={K} G={G} Sc={Sc} hd={hd} "
                f"valid {int(valid.sum())} {dtype} (chunk "
                f"{dec_ops.plan_chunk(B, K, Sc)}): max abs err {err:.3g}, "
                f"max row err / row RMS {rel:.3g}")
            assert err <= ATTN_TOL[dtype] and rel <= ATTN_REL_TOL[dtype], (
                f"decode_attention Sc={Sc} hd={hd} {dtype}: {err}, {rel}")
            note("decode_attention", err)
    # no valid slot at all gives 0; a call captured in a CUDA graph and
    # replayed gives what the eager call gave
    q, kc, vc, valid = decode_inputs(2, 2, 3, 300, 64, torch.bfloat16, 0.5,
                                     gen)
    none = dec_ops.decode_attention_cuda(q, kc, vc, torch.zeros_like(valid))
    assert torch.equal(none, torch.zeros_like(none)), "slot-less row"
    eager = dec_ops.decode_attention_cuda(q, kc, vc, valid)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        dec_ops.decode_attention_cuda(q, kc, vc, valid)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        replayed = dec_ops.decode_attention_cuda(q, kc, vc, valid)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(replayed, eager), "decode in a CUDA graph differs"
    log("check decode_attention: no valid slot gives 0; a graph replay "
        "equals the eager call")


def serve_cli(argv):
    """The serve CLI's request lines and launch counts (and its run, kept
    in ``serve_cli.result``)."""
    from repro_torch.launch import serve
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        serve_cli.result = serve.main(argv)
    lines = buf.getvalue().splitlines()
    for line in lines:
        log(f"  {line}")
    return lines


def check_generated(label, run_requests, vocab):
    for r in run_requests:
        assert bool(((r.tokens >= 0) & (r.tokens < vocab)).all()), label
        assert bool(torch.isfinite(r.logits).all()), f"{label}: logits"


def lm_serve_runs(counted, runs, zero_counts):
    """Phase 4 for the LM slice: hymba-1.5b at full width and depth through
    the serve CLI (run (a), the CLI's defaults, and run (b), a prompt past
    the window), the wave server, and falcon-mamba-7b cut to 8 layers.
    Returns run (a)'s result."""
    from repro_torch.configs import get_config
    from repro_torch.core.serving import Request, SlotServer
    from repro_torch.launch import serve
    from repro_torch.models import transformer

    hymba = get_config("hymba-1.5b")
    L = hymba.n_layers
    label = "serve hymba-1.5b (a) B=4 prompt 16 gen 32 x3"
    t0 = time.perf_counter()
    lines = counted(label, lambda: serve_cli(
        ["--arch", "hymba-1.5b", "--batch", "4", "--prompt-len", "16",
         "--gen-len", "32", "--requests", "3"]))
    run_a = serve_cli.result
    log(f"  {label}: {time.perf_counter() - t0:.2f} s with the init")
    assert len(lines) == 4 and json.loads(lines[-1])["kernel_launches"]
    check_generated(label, run_a.requests, hymba.vocab_size)
    assert runs[label] == zero_counts(selective_scan=3 * L,
                                      flash_attention=3 * L,
                                      decode_attention=3 * 32 * L), runs

    label = "serve hymba-1.5b (b) B=1 prompt 4096 gen 16"
    lines = counted(label, lambda: serve_cli(
        ["--arch", "hymba-1.5b", "--batch", "1", "--prompt-len", "4096",
         "--gen-len", "16", "--requests", "1"]))
    assert LONG["P"] > hymba.sliding_window       # the ring wraps
    check_generated(label, serve_cli.result.requests, hymba.vocab_size)
    assert runs[label] == zero_counts(selective_scan=L, flash_attention=L,
                                      decode_attention=16 * L), runs
    serve_cli.result = None

    label = "SlotServer hymba-1.5b 4 slots x 10 requests"
    server = SlotServer(hymba, run_a.params, slots=4, prompt_len=16,
                        max_new_tokens=32, eos_id=2, seed=1)
    gen = torch.Generator(device="cuda").manual_seed(5)
    for i in range(10):
        server.submit(Request(i, torch.randint(
            0, hymba.vocab_size, (16,), generator=gen, device="cuda"),
            max_new_tokens=32 if i % 3 else 12))
    done = counted(label, server.run)
    assert sorted(c.request_id for c in done) == list(range(10))
    for c in done:
        assert 1 <= len(c.tokens) <= 32
        assert all(0 <= t < hymba.vocab_size for t in c.tokens)
    snap = server.snapshot()
    log(f"  snapshot: {json.dumps(snap)}")
    assert snap["requests"] == 10 and snap["slots"] == 4
    assert runs[label] == zero_counts(
        selective_scan=3 * L, flash_attention=3 * L,
        decode_attention=server.decode_steps * L), runs

    label = "serve falcon-mamba-7b 8 of 64 layers B=4 prompt 16 gen 16 x2"
    falcon = dataclasses.replace(get_config("falcon-mamba-7b"), n_layers=8)
    gen = torch.Generator(device="cuda").manual_seed(0)

    def falcon_run():
        params = transformer.init_params(falcon, gen)
        out = []
        for _ in range(2):
            prompt = torch.randint(0, falcon.vocab_size, (4, 16),
                                   generator=gen, device="cuda")
            t0 = time.perf_counter()
            toks, logits = serve.generate(falcon, params, prompt, 16, gen)
            torch.cuda.synchronize()
            log(f"  falcon request: 16 tokens x 4 seqs in "
                f"{time.perf_counter() - t0:.2f}s")
            out.append(serve.RequestRun(prompt, toks, logits, 0.0))
        return out

    check_generated(label, counted(label, falcon_run), falcon.vocab_size)
    assert runs[label] == zero_counts(selective_scan=2 * 8), runs
    return run_a


def teacher_forced(cfg, params, prompt, gen_len, tokens=None, gen=None):
    """prefill and ``gen_len`` decode steps, fed ``tokens`` (B, gen_len)
    or tokens sampled from ``gen``; returns (tokens, logits before each
    step and after the last, final state)."""
    from repro_torch.models import transformer
    from repro_torch.serve import sampling
    state, logits = transformer.prefill(cfg, params, prompt,
                                        gen_budget=gen_len)
    seen, fed = [logits], []
    noise = None if tokens is not None else sampling.gumbel_source(gen)
    for t in range(gen_len):
        tok = (tokens[:, t] if tokens is not None
               else sampling.sample(logits, noise))
        fed.append(tok)
        state, logits = transformer.decode_step(cfg, params, state,
                                                tok[:, None])
        seen.append(logits)
    return torch.stack(fed, 1), seen, state


def lm_cuda_vs_ref(run_a):
    """Phase 5 for the LM slice: the kernels against the model's plain
    paths end to end, float32 (bounded) and bfloat16 (reported)."""
    from repro_torch import kernels
    from repro_torch.configs import get_config
    from repro_torch.models import transformer

    cfg = dataclasses.replace(get_config("hymba-1.5b"), n_layers=4,
                              dtype="float32")
    params = transformer.init_params(
        cfg, torch.Generator(device="cuda").manual_seed(3))
    report = {}
    for prompt_len in (16, 2100):
        gen = torch.Generator(device="cuda").manual_seed(prompt_len)
        prompt = torch.randint(0, cfg.vocab_size, (2, prompt_len),
                               generator=gen, device="cuda")
        out = {}
        for mode in ("cuda", "ref"):
            kernels.reset_launch_counts()
            prev = kernels.set_kernel_mode(mode)
            try:
                out[mode] = teacher_forced(
                    cfg, params, prompt, 8,
                    tokens=out["cuda"][0] if mode == "ref" else None,
                    gen=gen)
            finally:
                kernels.set_kernel_mode(prev)
            torch.cuda.synchronize()
            lm = {k: v for k, v in kernels.launch_counts().items()
                  if k in ("selective_scan", "flash_attention",
                           "decode_attention")}
            assert all((n > 0) == (mode == "cuda") for n in lm.values()), (
                mode, lm)
        (_, got_l, got_s), (_, want_l, want_s) = out["cuda"], out["ref"]
        logit_err = max(max_err(g, w) for g, w in zip(got_l, want_l))
        state_err = {k: max_err(got_s[k], want_s[k])
                     for k in ("k", "v", "conv", "ssm")}
        assert torch.equal(got_s["cache_pos"], want_s["cache_pos"])
        assert logit_err <= LM_F32_TOL and max(state_err.values()) <= \
            LM_F32_TOL, (prompt_len, logit_err, state_err)
        report[f"f32 prompt {prompt_len}"] = {
            "P": prompt_len + cfg.n_meta_tokens, "max_abs_logit_err":
            logit_err, "max_abs_state_err": state_err,
            "logit_magnitude": max(float(w.abs().max()) for w in want_l)}
        log(f"reference: hymba-1.5b f32 4 layers, prompt {prompt_len} "
            f"(P {prompt_len + cfg.n_meta_tokens}), cuda vs ref: max "
            f"|dlogit| {logit_err:.3g} over prefill + 8 steps, state "
            f"{json.dumps(state_err)} (bound {LM_F32_TOL})")
    del params

    # bfloat16: run (a)'s first request, teacher-forced through the plain
    # paths, against the logits the kernels gave
    req = run_a.requests[0]
    prev = kernels.set_kernel_mode("ref")
    try:
        _, want_l, _ = teacher_forced(run_a.cfg, run_a.params, req.prompt, 8,
                                      tokens=req.tokens[:, :8])
    finally:
        kernels.set_kernel_mode(prev)
    got_l = [req.logits[:, t] for t in range(9)]
    err = max(max_err(g, w) for g, w in zip(got_l, want_l))
    agree = float(torch.stack([g.argmax(-1) == w.argmax(-1) for g, w in
                               zip(got_l, want_l)]).float().mean())
    report["bf16 run (a) request 0"] = {"max_abs_logit_err": err,
                                        "top1_agreement": agree}
    log(f"reference: hymba-1.5b bf16 run (a) request 0, cuda vs ref over "
        f"prefill + 8 steps: max |dlogit| {err:.3g}, top-1 agreement "
        f"{agree:.4f} (reported, no bound)")
    return report


def time_lm_kernels(timings, gen):
    """Phase 6 for the LM kernels, at run (a)'s shapes ("main") and the long
    request's (the scan also at falcon-mamba-7b's): call and device ms,
    plain ms, the bound, and one scaled_dot_product_attention call with the
    same mask as the library yardstick for the attention kernels."""
    from repro_torch.kernels.decode_attention import ops as dec_ops
    from repro_torch.kernels.flash_attention import ops as fa_ops
    sdpa = torch.nn.functional.scaled_dot_product_attention
    K, G, hd, W = 5, 5, 64, 2048
    for label, shp in (("main", HYMBA), ("long", LONG)):
        B, S = shp["B"], shp["P"]
        long = label == "long"
        q, k, v = attn_inputs(B, S, K, G, hd, torch.bfloat16, gen)
        o = fa_ops.flash_attention_cuda(q, k, v, causal=True, window=W)
        rows = torch.arange(S, device="cuda")
        band = (rows[None, :] <= rows[:, None]) & (
            rows[:, None] - rows[None, :] < W)
        pairs = int(band.sum())                  # (row, key) pairs seen
        qh = q.reshape(B, S, K * G, hd).transpose(1, 2).contiguous()
        kh, vh = (t.transpose(1, 2).contiguous() for t in (k, v))
        timings[label, "flash_attention"] = measure(
            "flash_attention", f"B={B} S={S} H=25 K=5 hd=64 window {W} bf16",
            0, nbytes(q, k, v, o),
            lambda: fa_ops.flash_attention_cuda(q, k, v, causal=True,
                                                window=W),
            lambda: fa_ops.flash_attention(q, k, v, causal=True, window=W,
                                           impl="ref"),
            20 if long else 200, 3 if long else 20,
            library=lambda: sdpa(qh, kh, vh, attn_mask=band,
                                 enable_gqa=True),
            plain_graph=not long, ops=4 * hd * pairs * B * K * G,
            rate=BF16_OPS_PER_S)

        Sc = min(W, S + shp["gen"])
        qd, kc, vc, valid = decode_inputs(B, K, G, Sc, hd, torch.bfloat16,
                                          1.0, gen)
        od = dec_ops.decode_attention_cuda(qd, kc, vc, valid)
        n_valid = int(valid.sum())
        qdh = qd.reshape(B, K * G, 1, hd)
        kch, vch = (t.transpose(1, 2).contiguous() for t in (kc, vc))
        timings[label, "decode_attention"] = measure(
            "decode_attention", f"B={B} Sc={Sc} ({n_valid} valid) H=25 K=5 "
            f"hd=64 bf16", 0,
            nbytes(qd, od, valid) + 2 * B * K * n_valid * hd * 2,
            lambda: dec_ops.decode_attention_cuda(qd, kc, vc, valid),
            lambda: dec_ops.decode_attention(qd, kc, vc, valid, impl="ref"),
            200, 50,
            library=lambda: sdpa(qdh, kch, vch,
                                 attn_mask=valid.view(1, 1, 1, Sc),
                                 enable_gqa=True),
            ops=4 * hd * n_valid * B * K * G, rate=BF16_OPS_PER_S)

        time_scan(timings, label, B, S, 3200, gen)
    time_scan(timings, "falcon", FALCON["B"], FALCON["P"], 8192, gen)


def time_scan(timings, label, B, S, Di, gen):
    """The scan's timings at one shape, and a log line with its exp floor
    beside its bound (both computed, not measured): one MUFU.EX2 per (b, t,
    d, n) at ``EX2_PER_S``."""
    from repro_torch.kernels.selective_scan import ops as scan_ops
    N = 16
    args = scan_inputs(B, S, Di, N, gen)
    y, h = scan_ops.selective_scan_cuda(*args)
    long = S > 1000
    timings[label, "selective_scan"] = t = measure(
        "selective_scan", f"B={B} S={S} Di={Di} N={N}", 0,
        nbytes(*args, y, h),
        lambda: scan_ops.selective_scan_cuda(*args),
        lambda: scan_ops.selective_scan_ref(*args),
        100 if long else 200, 1 if long else 3, plain_graph=not long,
        # per (b, t, d, n): dt * A, exp, abar * h, dx * B, +, h * C, +
        ops=7 * B * S * Di * N)
    log(f"selective_scan {label} B={B} S={S} Di={Di}: bound "
        f"{t['bound_ms']:.4g} ms, exp floor "
        f"{B * S * Di * N / EX2_PER_S * 1e3:.4g} ms (computed)")


def time_kernels():
    """Phase 6: every kernel's timings at the main path's shapes (10
    samplers of 16 envs, ``main``), at the vector path's (``vector``), the
    tree update at an add's (``add``) and the LM kernels' further shapes,
    on inputs made from their own seed, so that a run of the whole script
    and one of ``--timing-only`` time the same data."""
    from repro_torch import kernels
    from repro_torch.kernels.env_step import ref as env_ref
    from repro_torch.kernels.gae import ops as gae_ops
    from repro_torch.kernels.replay_ring import ops as ring_ops
    from repro_torch.kernels.sum_tree import ops as tree_ops
    gen = torch.Generator(device="cuda").manual_seed(6)
    horizon, (n, per, h), n_leaves = 50, MAIN_SAMPLERS, len(CHEETAH_LEAVES)
    timings = {}
    for label, B, T, gB in (("main", per, h, n * per),
                            ("vector", 4096, 128, 4096)):
        for name in ("pendulum", "cartpole", "cheetah"):
            state, a, rs, ro, p = env_inputs(name, B, horizon, seed=7)
            params = dict(max_episode_steps=horizon, reward_scale=1.0, **p)
            wrapper = kernels.KERNELS[f"{name}_step"]
            out = wrapper(state, a, rs, ro, **params)
            # the kernel reads a row's reset candidates only where its
            # episode ends, so only those rows' candidates count
            resets = int(out[3].sum())
            timings[label, f"{name}_step"] = measure(
                f"{name}_step", f"B={B}", B,
                nbytes(*state, a, *leaves(out))
                + nbytes(*rs, ro) * resets // B,
                lambda: wrapper(state, a, rs, ro, **params),
                lambda: env_ref.STEP_BATCH_REF[name](state, a, rs, ro,
                                                     **params), 200, 50)
        r, v, d, lv = gae_inputs(T, gB, seed=3)
        adv, ret = gae_ops.gae_cuda(r, v, d, lv, gamma=0.99, lam=0.95)
        timings[label, "gae"] = measure(
            "gae", f"T={T} B={gB}", T * gB, nbytes(r, v, d, lv, adv, ret),
            lambda: gae_ops.gae_cuda(r, v, d, lv, gamma=0.99, lam=0.95),
            lambda: gae_ops.gae_ref(r, v, d, lv, 0.99, 0.95), 200, 5)
        ret = gae_ops.discounted_returns_cuda(r, d, lv, gamma=0.99)
        timings[label, "discounted_returns"] = measure(
            "discounted_returns", f"T={T} B={gB}", T * gB,
            nbytes(r, d, lv, ret),
            lambda: gae_ops.discounted_returns_cuda(r, d, lv, gamma=0.99),
            lambda: gae_ops.discounted_returns_ref(r, d, lv, 0.99), 200, 5)
    # pendulum and cart-pole at the batches of the stepped, fused and
    # vector runs, with no, a third and every episode ending
    for name in ("pendulum", "cartpole"):
        wrapper = kernels.KERNELS[f"{name}_step"]
        for B in ENV_TIMING_B:
            for ends in CHEETAH_ENDS:
                state, a, rs, ro, p = env_edge_inputs(name, B, ends, horizon,
                                                      seed=7)
                params = dict(max_episode_steps=horizon, reward_scale=1.0,
                              **p)
                out = wrapper(state, a, rs, ro, **params)
                resets = int(out[3].sum())
                shape = f"B={B} ends={ends}"
                timings["env", (f"{name}_step", shape)] = measure(
                    f"{name}_step", shape, B,
                    nbytes(*state, a, *leaves(out))
                    + nbytes(*rs, ro) * resets // B,
                    lambda: wrapper(state, a, rs, ro, **params),
                    lambda: env_ref.STEP_BATCH_REF[name](state, a, rs, ro,
                                                         **params), 200, 50)
    # GAE and the returns at a batch that is not a multiple of 4, where the
    # kernels load one float at a time
    T, gB = h, n * per + 3
    r, v, d, lv = gae_inputs(T, gB, seed=3)
    adv, ret = gae_ops.gae_cuda(r, v, d, lv, gamma=0.99, lam=0.95)
    timings["ragged", "gae"] = measure(
        "gae", f"T={T} B={gB}", T * gB, nbytes(r, v, d, lv, adv, ret),
        lambda: gae_ops.gae_cuda(r, v, d, lv, gamma=0.99, lam=0.95),
        lambda: gae_ops.gae_ref(r, v, d, lv, 0.99, 0.95), 200, 5)
    ret = gae_ops.discounted_returns_cuda(r, d, lv, gamma=0.99)
    timings["ragged", "discounted_returns"] = measure(
        "discounted_returns", f"T={T} B={gB}", T * gB, nbytes(r, d, lv, ret),
        lambda: gae_ops.discounted_returns_cuda(r, d, lv, gamma=0.99),
        lambda: gae_ops.discounted_returns_ref(r, d, lv, 0.99), 200, 5)
    # the replay path at the SAC cheetah run's shapes: 20,000 transitions
    # of 144 B inserted into 2^20 slots, 256 drawn from 60,000 filled ones
    n_rows, B = n * per * h, 256
    storage = ring_leaves(CAP, gen)
    batch = ring_leaves(n_rows, gen)
    start = CAP - 7000
    # the head as the ring keeps it: a 0-dim int32 on the card
    head = torch.full((), start, dtype=torch.int32, device="cuda")
    pos = (torch.arange(n_rows, device="cuda") + start) % CAP
    row_bytes = nbytes(*(v[:1] for v in storage.values()))
    timings["main", "ring_insert"] = measure(
        "ring_insert", f"N={n_rows} cap={CAP} leaves={n_leaves}", 0,
        2 * n_rows * row_bytes,
        lambda: ring_ops.ring_insert(storage, batch, head, impl="cuda"),
        lambda: ring_ops.ring_insert_ref(storage, batch, head), 50, 20,
        library=lambda: [storage[k].index_copy_(0, pos, batch[k])
                         for k in storage])
    idx = torch.randint(0, 3 * n_rows, (B,), generator=gen, device="cuda",
                        dtype=torch.int32)
    idx64 = idx.to(torch.int64)
    timings["main", "ring_gather"] = measure(
        "ring_gather", f"B={B} cap={CAP} leaves={n_leaves}", 0,
        # each distinct row read once, each sampled row written once
        (int(torch.unique(idx).numel()) + B) * row_bytes + nbytes(idx),
        lambda: ring_ops.ring_gather(storage, idx, impl="cuda"),
        lambda: ring_ops.ring_gather_ref(storage, idx), 200, 50,
        library=lambda: [torch.index_select(v, 0, idx64)
                         for v in storage.values()])
    del storage, batch
    tree = random_tree(CAP, 3 * n_rows, gen)
    masses = stratified_masses(tree, B, gen)
    found = tree_ops.sumtree_find_cuda(tree, masses)
    nodes = tree_path_nodes(found, CAP)
    timings["main", "sumtree_find"] = measure(
        "sumtree_find", f"B={B} cap={CAP}", B * (CAP.bit_length() - 1),
        4 * sum(nodes) + nbytes(masses, found),
        lambda: tree_ops.sumtree_find_cuda(tree, masses),
        lambda: tree_ops.sumtree_find_batch_ref(tree, masses), 200, 50)
    # and at an add's batch, past the warp a mass: a thread a mass
    many = stratified_masses(
        tree, n_rows, torch.Generator(device="cuda").manual_seed(7))
    found_many = tree_ops.sumtree_find_cuda(tree, many)
    timings["add", "sumtree_find"] = measure(
        "sumtree_find", f"B={n_rows} cap={CAP}",
        n_rows * (CAP.bit_length() - 1),
        4 * sum(tree_path_nodes(found_many, CAP))
        + nbytes(many, found_many),
        lambda: tree_ops.sumtree_find_cuda(tree, many),
        lambda: tree_ops.sumtree_find_batch_ref(tree, many), 50, 10)
    for label, upd_idx in (
            ("main", found),
            ("add", ((torch.arange(n_rows, device="cuda") + start) % CAP)
             .to(torch.int32))):
        vals = torch.rand(upd_idx.shape[0], generator=gen, device="cuda")
        nodes = tree_path_nodes(upd_idx, CAP)
        timings[label, "sumtree_update"] = measure(
            "sumtree_update", f"B={upd_idx.shape[0]} cap={CAP}", sum(nodes),
            nbytes(upd_idx, vals) + tree_update_bytes(upd_idx, CAP),
            lambda: tree_ops.sumtree_update_cuda(tree, upd_idx, vals),
            lambda: tree_ops.sumtree_update_ref(tree, upd_idx, vals), 50, 10)
    time_lm_kernels(timings, gen)
    return timings


# the steps of an env-step wrapper call, as ``log_host_parts`` names them
HOST_PARTS = {"check": "_check", "allocations": "_outputs",
              "pointers and argument block": "_pack", "ctypes call": "_call"}


def log_host_parts(n=2000, rounds=7):
    """One line, ``env_step_host_us``: the host microseconds of a wrapper
    call at B 16 for each env (``n`` calls back to back on the host's
    clock, median and least of ``rounds``), and of each of its steps
    (``HOST_PARTS``), timed where the wrapper calls them: each step is
    wrapped in a timer for a second run of ``n`` calls, which must call
    it once a call."""
    from repro_torch.kernels.env_step import ops as env_ops
    report = {}
    for name in ("pendulum", "cartpole", "cheetah"):
        state, a, rs, ro, p = env_edge_inputs(name, 16, "mixed", 50, seed=7)
        params = dict(max_episode_steps=50, reward_scale=1.0, **p)
        wrapper = env_ops.STEP_BATCH_CUDA[name]
        samples = {part: [] for part in ("whole call", *HOST_PARTS)}
        for _ in range(rounds):
            for _ in range(100):
                wrapper(state, a, rs, ro, **params)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(n):
                wrapper(state, a, rs, ro, **params)
            samples["whole call"].append(
                (time.perf_counter() - t0) / n * 1e6)
            torch.cuda.synchronize()
            spent = dict.fromkeys(HOST_PARTS, 0.0)
            calls = dict.fromkeys(HOST_PARTS, 0)
            steps = {part: getattr(env_ops, fn)
                     for part, fn in HOST_PARTS.items()}

            def timed(part, step):
                def run(*args):
                    t0 = time.perf_counter()
                    out = step(*args)
                    spent[part] += time.perf_counter() - t0
                    calls[part] += 1
                    return out
                return run
            try:
                for part, fn in HOST_PARTS.items():
                    setattr(env_ops, fn, timed(part, steps[part]))
                for _ in range(n):
                    wrapper(state, a, rs, ro, **params)
            finally:
                for part, fn in HOST_PARTS.items():
                    setattr(env_ops, fn, steps[part])
            torch.cuda.synchronize()
            assert all(c == n for c in calls.values()), (name, calls)
            for part, sec in spent.items():
                samples[part].append(sec / n * 1e6)
        report[f"{name}_step"] = {
            part: {"median": statistics.median(us), "least": min(us)}
            for part, us in samples.items()}
    log(json.dumps({"env_step_host_us": report}))


def launch_floor():
    """The per-launch floor: one library kernel that does next to nothing
    (``zero_()`` of 16 floats), its device time from graph replay as
    ``measure`` takes it, and its call time. Logged on a line of its own;
    returns the device ms."""
    z = torch.empty(16, device="cuda")
    floor = {"kernel": "Tensor.zero_ of 16 float32",
             "kernels_per_call": kernels_per_call(z.zero_),
             "ms": time_ms(z.zero_, 200), "device_ms": graph_ms(z.zero_, 200)}
    log(json.dumps({"launch_floor": floor}))
    return floor["device_ms"]


# A probe of one L2 round trip, built by this script (it is no kernel of
# the port): one thread chases a random cycle through the 128-byte lines of
# an 8 MB buffer (the size of the find's 2^20-leaf tree) with the find's
# kind of load (``const __restrict__``, through L1), so every hop is a
# dependent load that misses L1 and hits L2.
L2_PROBE_CU = r"""
#include <cuda_runtime.h>
__global__ void chase(const unsigned* __restrict__ next, int hops,
                      unsigned* out) {
  unsigned i = 0;
  for (int h = 0; h < hops; ++h) i = next[i];
  *out = i;
}
extern "C" int l2_chase(const void* next, int hops, void* out,
                        void* stream) {
  chase<<<1, 1, 0, (cudaStream_t)stream>>>((const unsigned*)next, hops,
                                           (unsigned*)out);
  return (int)cudaGetLastError();
}
"""


def l2_round_trip_us(hops=(2048, 10240)):
    """One L2 round trip in µs: the probe's time at two chain lengths,
    from CUDA events around one launch each (median of 7), the difference
    over the extra hops."""
    from repro_torch.kernels import build
    out = build.BUILD_ROOT / "l2_probe" / "libl2_probe.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    src = out.with_suffix(".cu")
    src.write_text(L2_PROBE_CU)
    subprocess.run([build.nvcc_path(), *build.FLAGS, "-o", str(out),
                    str(src)], check=True, capture_output=True, timeout=300)
    lib = ctypes.CDLL(str(out))
    lib.l2_chase.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                             ctypes.c_void_p]
    lines = (8 << 20) // 128
    order = np.random.default_rng(0).permutation(lines) * 32
    nxt = np.zeros(lines * 32, dtype=np.uint32)
    nxt[order] = np.roll(order, -1)
    nxt = torch.from_numpy(nxt.view(np.int32)).to("cuda")
    nxt.sum()                           # the buffer into L2
    res = torch.empty(1, dtype=torch.int32, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    times = []
    for n in hops:
        def chase():
            assert lib.l2_chase(nxt.data_ptr(), n, res.data_ptr(),
                                stream) == 0
        times.append(time_ms(chase, 1, rounds=7))
    return (times[1] - times[0]) / (hops[1] - hops[0]) * 1e3


def log_find_floor(floor_ms, find, batch):
    """The find's second floor beside its byte bound, at the main path's
    ``batch`` masses in a 2^20-leaf tree: the launch floor plus its
    dependent global trips per mass times one measured L2 round trip
    (``l2_round_trip_us``), logged on a line of its own."""
    from repro_torch.kernels.sum_tree import ops as tree_ops
    trip_us = l2_round_trip_us()
    trips = tree_ops.find_trips(CAP, batch)
    log(json.dumps({"sumtree_find_floor": {
        "shape": find["shape"], "levels": CAP.bit_length() - 1,
        "dependent_global_trips": trips, "l2_round_trip_us": trip_us,
        "launch_floor_us": floor_ms * 1e3,
        "trip_floor_us": floor_ms * 1e3 + trips * trip_us,
        "bound_us": find["bound_ms"] * 1e3,
        "device_us": find["device_ms"] * 1e3}}))


def log_timings(timings, labels):
    """One JSON line per shape label: the kernels timed there."""
    for label, key in labels:
        log(json.dumps({key: [
            {"name": name if isinstance(name, str) else name[0], **t}
            for (at, name), t in timings.items() if at == label]}))


# ------------------------------------------------------------------ main
@contextlib.contextmanager
def recording(backend_cls):
    """While the block runs, keep a copy of every merged trajectory
    ``backend_cls.collect`` returns (``trajs``) and the wall seconds of
    each call, publish, transport and the barrier of the collect's stream
    included (``walls``)."""
    rec = types.SimpleNamespace(trajs=[], walls=[])
    collect = backend_cls.collect

    def recorded(self, params):
        t0 = time.perf_counter()
        merged, stats = collect(self, params)
        # the collect's own stream: under overlap the learn runs on another
        torch.cuda.current_stream().synchronize()
        rec.walls.append(time.perf_counter() - t0)
        rec.trajs.append({k: v.clone() for k, v in merged.items()})
        return merged, stats

    backend_cls.collect = recorded
    try:
        yield rec
    finally:
        backend_cls.collect = collect


def replay_tensors(runner):
    """The replay ring's leaves, the tree and the max priority."""
    ring, tree, max_p = runner.plane_state[0]
    return [tree.flat, max_p, *ring.storage.values()]


def snapshot_run(label, result, rec, plane=False):
    """What a run must reproduce bit for bit: its merged trajectories, its
    final weights and (``plane``) its replay state. Logs the wall seconds
    of its collects."""
    log(f"  {label}: collect wall s {[round(w, 4) for w in rec.walls]}")
    tensors = [p.detach().clone() for p in result.params.parameters()]
    if plane:
        tensors += [x.clone() for x in replay_tensors(result.runner)]
    return {"trajs": rec.trajs, "tensors": tensors}


def same_run(label, got, want):
    assert len(got["trajs"]) == len(want["trajs"]) > 0, label
    for a, b in zip(got["trajs"], want["trajs"]):
        assert sorted(a) == sorted(b), label
        for k in b:
            assert a[k].dtype == b[k].dtype and torch.equal(a[k], b[k]), (
                f"{label}: trajectory leaf {k} differs from the inline run")
    assert len(got["tensors"]) == len(want["tensors"]), label
    assert all(torch.equal(a, b) for a, b in zip(got["tensors"],
                                                 want["tensors"])), (
        f"{label}: final weights or replay state differ from the inline run")
    log(f"  {label}: {len(got['trajs'])} merged trajectories and "
        f"{len(got['tensors'])} tensors bit for bit equal to the inline run")


class GpuMemory:
    """Samples device memory every ``period`` seconds while the block
    runs: each process's (``nvidia-smi
    --query-compute-apps=pid,used_memory``; ``peak`` maps pid to the most
    MiB seen, ``listing`` keeps the tool's last output) and the card's
    whole use (``torch.cuda.mem_get_info``: ``used_before`` at the start,
    ``used_peak`` the most seen, MiB)."""

    def __init__(self, period=0.5):
        self.period = period
        self.peak = {}
        self.listing = ""
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._poll, daemon=True)

    @staticmethod
    def used_mib():
        free, total = torch.cuda.mem_get_info()
        return (total - free) / 2 ** 20

    def _poll(self):
        while not self._stop.is_set():
            self.used_peak = max(self.used_peak, self.used_mib())
            try:
                out = subprocess.run(
                    ["nvidia-smi", "--query-compute-apps=pid,used_memory",
                     "--format=csv,noheader,nounits"], capture_output=True,
                    text=True, timeout=30).stdout
            except (OSError, subprocess.TimeoutExpired):
                out = ""
            self.listing = out.strip()
            for line in out.splitlines():
                parts = [x.strip() for x in line.split(",")]
                if len(parts) == 2 and parts[0].isdigit() \
                        and parts[1].isdigit():
                    pid, mib = int(parts[0]), int(parts[1])
                    self.peak[pid] = max(self.peak.get(pid, 0), mib)
            self._stop.wait(self.period)

    def __enter__(self):
        self.used_before = self.used_peak = self.used_mib()
        self._thread.start()
        return self

    def __exit__(self, *exc):
        self._stop.set()
        self._thread.join(timeout=60)


def check_no_leftovers(label, pool=None):
    """No worker process alive and no block of this process's pools
    (``walle-<pid>-*``, the pools' prefix) in /dev/shm."""
    alive = [p.pid for p in (pool._procs if pool is not None else [])
             if p is not None and p.is_alive()]
    children = [p.pid for p in multiprocessing.active_children()]
    blocks = glob.glob(f"/dev/shm/walle-{os.getpid()}-*")
    assert not alive and not children and not blocks, (
        f"{label}: left behind processes {alive + children}, "
        f"shared memory {blocks}")


def actor_plane_runs(cli, counted, runs, check_logs, zero_counts,
                     ppo_inline, sac_inline):
    """Slice 9, the actor plane, through the train CLI at the paper's
    size: PPO cheetah over 10 worker processes (lock-step) and 10 sampler
    threads, each bit for bit against the inline run of the same seed;
    async PPO with staleness decay over the process pool and over threads;
    SAC cheetah prioritized over 10 processes, bit for bit against inline;
    PPO pendulum over 4 processes under a seeded kill and torn-write
    schedule. The workers' own launch counts (every incarnation's last
    report, summed) join each run's counts; after each run nothing is
    left behind. Returns the pools' start-up seconds, device memory and
    per-worker launches."""
    from repro_torch.core.backends import ProcessBackend, ThreadedBackend
    from repro_torch.core.faults import FaultPlan, decide
    from repro_torch.kernels import KERNELS
    n, per, h = MAIN_SAMPLERS
    ppo = ["--env", "cheetah", "--algo", "ppo", "--num-samplers", str(n),
           "--global-batch", str(n * per), "--horizon", str(h),
           "--kernels", "cuda"]
    report = {}

    def pool_run(label, argv):
        with GpuMemory() as mem:
            logs = counted(label, lambda: cli(argv))
        runner = cli.result.runner
        pool = runner.pool if hasattr(runner, "pool") else runner.backend.pool
        reports = sorted(pool.worker_launches.items())
        workers = {k: 0 for k in KERNELS}
        for _key, info in reports:
            for k, v in info["launches"].items():
                workers[k] += v
        devices = sorted({info["device"] for _key, info in reports})
        runs[label] = {k: runs[label][k] + workers[k] for k in runs[label]}
        pids = {i: p.pid for i, p in enumerate(pool._procs) if p is not None}
        report[label] = {
            "workers": len(pool.active), "devices": devices,
            "incarnations": len(reports),
            "pool_start_s": pool.startup_seconds,
            "worker_start_s": dict(sorted(pool.worker_start_seconds.items())),
            # each process's whole use, its CUDA context included (reads
            # "not measured" where the tool cannot tell processes apart)
            "worker_mem_mib": {i: mem.peak.get(pid, "not measured")
                               for i, pid in pids.items()},
            # what each worker's caching allocator reserved at its peak
            # (its own report; the CUDA context is not in it)
            "worker_reserved_mib": {
                f"{w}.{inc}": info["memory_reserved_mib"]
                for (w, inc), info in reports},
            "learner_mem_mib": mem.peak.get(os.getpid(), "not measured"),
            "nvidia_smi_compute_apps": mem.listing,
            "device_used_mib": {"before": mem.used_before,
                                "peak": mem.used_peak},
            # the card's whole growth over the run over the worker count:
            # the learner's allocations are in it
            "card_growth_per_worker_mib": ((mem.used_peak - mem.used_before)
                                           / len(pool.active)),
            "worker_launches": {
                f"{w}.{inc}": {k: v for k, v in info["launches"].items()
                               if v}
                for (w, inc), info in reports}}
        log(f"  {label}: workers on {devices}, {len(reports)} worker "
            f"incarnations, launches in the workers "
            f"{ {k: v for k, v in workers.items() if v} }, pool start "
            f"{pool.startup_seconds:.2f} s, worker start s "
            f"{json.dumps(report[label]['worker_start_s'])}, process MiB "
            f"{json.dumps(report[label]['worker_mem_mib'])}, allocator "
            f"reserve MiB {json.dumps(report[label]['worker_reserved_mib'])}"
            f", card in use {mem.used_before:.0f} -> {mem.used_peak:.0f} "
            f"MiB")
        assert devices and all(d.startswith("cuda") for d in devices), (
            f"{label}: a worker left the card: {devices}")
        check_no_leftovers(label, pool)
        return logs, runner, workers

    def async_logs(label, logs):
        for lg in logs:
            for k in ("staleness", "worker_utilization"):
                assert math.isfinite(lg[k]), f"{label}: {k} {lg}"
        log(f"  {label}: staleness {[lg['staleness'] for lg in logs]}, "
            f"worker_utilization "
            f"{[round(lg['worker_utilization'], 4) for lg in logs]}, "
            f"active_workers {[lg['active_workers'] for lg in logs]}")

    # 1. lock-step over 10 worker processes, against the inline run
    label = "ppo cheetah N=10 process"
    with recording(ProcessBackend) as trajs:
        logs, runner, workers = pool_run(
            label, ppo + ["--backend", "process", "--iterations", "3"])
    check_logs(label, logs, 3, n * per * h)
    assert workers == zero_counts(cheetah_step=3 * n * h), workers
    assert runs[label] == zero_counts(cheetah_step=3 * n * h, gae=3), runs
    same_run(label, snapshot_run(label, cli.result, trajs), ppo_inline)
    report[label]["s_per_iteration"] = [
        w + lg["learn_time"] for w, lg in zip(trajs.walls, logs)][1:]

    # 2. 10 sampler threads, against the inline run
    label = "ppo cheetah N=10 threaded"
    with recording(ThreadedBackend) as trajs:
        logs = counted(label, lambda: cli(
            ppo + ["--backend", "threaded", "--iterations", "3"]))
    check_logs(label, logs, 3, n * per * h)
    assert runs[label] == zero_counts(cheetah_step=3 * n * h, gae=3), runs
    same_run(label, snapshot_run(label, cli.result, trajs), ppo_inline)
    check_no_leftovers(label)

    # 3. async with staleness decay: the process pool, then threads; each
    # update learns on one sweep's worth, n rollouts (the paper's 20,000
    # samples), so 6 updates consume 6 n rollouts, three times what the
    # pool's ring can hold from its start-up (n workers x 2 slots)
    per_update = ["--iterations", "6", "--staleness", "decay",
                  "--min-batches-per-update", str(n)]
    label = "ppo cheetah N=10 async process"
    logs, runner, workers = pool_run(
        label, ppo + ["--backend", "process", "--async"] + per_update)
    check_logs(label, logs, 6, n * per * h)
    async_logs(label, logs)
    queued = runner.pool.num_workers * runner.pool.slots_per_worker
    assert 6 * n > queued, (6 * n, queued)
    assert runs[label]["gae"] == 6 and workers["gae"] == 0, runs
    assert workers["cheetah_step"] >= 6 * n * h, workers
    assert workers["cheetah_step"] % h == 0, workers
    label = "ppo cheetah N=10 async threads"
    logs = counted(label, lambda: cli(ppo + ["--async"] + per_update))
    check_logs(label, logs, 6, n * per * h)
    async_logs(label, logs)
    counts = runs[label]
    assert counts["gae"] == 6 and counts["cheetah_step"] >= 6 * n * h, counts
    assert counts["cheetah_step"] % h == 0, counts
    check_no_leftovers(label)

    # 4. SAC prioritized over 10 worker processes, against the inline run
    label = "sac cheetah N=10 prioritized process"
    updates = 4
    with recording(ProcessBackend) as trajs:
        logs, runner, workers = pool_run(label, [
            "--env", "cheetah", "--algo", "sac", "--buffer", "prioritized",
            "--num-samplers", str(n), "--global-batch", str(n * per),
            "--horizon", str(h), "--iterations", "3", "--replay-capacity",
            "1000000", "--replay-batch", "256", "--backend", "process",
            "--kernels", "cuda"])
    check_logs(label, logs, 3, n * per * h)
    assert workers == zero_counts(cheetah_step=3 * n * h), workers
    assert runs[label] == zero_counts(
        cheetah_step=3 * n * h, ring_insert=3, ring_gather=3 * updates,
        sumtree_find=3 * updates, sumtree_update=3 * (1 + updates)), runs
    same_run(label, snapshot_run(label, cli.result, trajs, plane=True),
             sac_inline)

    # 5. faults: a seeded kill and torn-write schedule over 4 workers
    plan_text = "kill:0.1,torn:0.1,seed:13"
    plan = FaultPlan.parse(plan_text)
    fired = {decide(plan, w, 1, s) for w in range(4) for s in range(3)}
    assert {"kill", "torn"} <= fired, fired          # both fire in the run
    label = "ppo pendulum 4 workers faults"
    logs, runner, workers = pool_run(label, [
        "--env", "pendulum", "--algo", "ppo", "--backend", "process",
        "--num-samplers", "4", "--global-batch", str(4 * per), "--horizon",
        str(h), "--iterations", "3", "--inject-faults", plan_text,
        "--max-respawns", "8", "--kernels", "cuda"])
    check_logs(label, logs, 3, 4 * per * h)
    sup = runner.backend.supervisor
    assert sup.respawns >= 1 and logs[-1]["respawns"] == sup.respawns
    assert sup.slots_reclaimed >= 1, "no torn slot was reclaimed"
    # every sweep's 4 rollouts were launched by some incarnation, a torn
    # one's too: the reports of all incarnations hold at least 3 x 4 x h
    assert runs[label]["gae"] == 3, runs
    assert workers["pendulum_step"] >= 3 * 4 * h, workers
    assert workers["pendulum_step"] % h == 0, workers
    for e in sup.events:
        log(f"  supervisor: {e.kind} worker {e.worker_id}: {e.detail}")
    report[label]["respawns"] = sup.respawns
    report[label]["slots_reclaimed"] = sup.slots_reclaimed
    report[label]["recovery_s"] = sup.recovery_s
    return report



def carried(result):
    """The tensors a run carries from one iteration to the next: weights,
    optimizer state, the env carry and the experience plane's buffer
    state (a stepped run's single sampler carry, or the fused state)."""
    from repro_torch.core.fused import state_tensors
    runner = result.runner
    carry = (runner.state.env_carry if hasattr(runner, "state")
             else runner.backend.carries[0])
    plane = runner.plane_state[0] if runner.plane_state else None
    return [x.detach().clone() for x in state_tensors(
        (result.params, runner.opt_state, carry, plane))]


def same_carry(label, got, want):
    """Two runs' ``carried`` tensors and mean returns bit for bit equal."""
    (a, a_ret), (b, b_ret) = got, want
    assert a_ret == b_ret, (label, a_ret, b_ret)
    assert len(a) == len(b) > 0, label
    assert all(x.dtype == y.dtype and torch.equal(x, y)
               for x, y in zip(a, b)), f"{label}: carried tensors differ"
    log(f"  {label}: {len(a)} carried tensors and {len(a_ret)} mean "
        f"returns bit for bit equal")


def fused_runs(counted, runs, check_logs, zero_counts, device, walls,
               vector_run):
    """Slice 10, the fused runtime (``runtime="fused"``, one CUDA-graph
    replay per iteration after two eager iterations and a capture): PPO
    cheetah at 160 envs × 125 steps, SAC cheetah prioritized (2^20 slots,
    batch 256), DDPG pendulum uniform, TRPO cart-pole, each against the
    stepped run from the same carry (sync, one sampler of 160), and PPO
    cheetah at one 4,096-env batch against ``vector_run``: weights,
    optimizer, env carry and plane bit for bit; PPO and SAC also with the
    plain versions (``kernels="ref"``, captured too) against the kernels.
    The 160-env runs take 5 iterations: 2 eager, a capture and 3 replays.
    Each run's launches per replay are the calls the capture recorded and
    also the port's kernel nodes of the graph, read back by name; its
    kernel counts are (eager iterations + replays) × those. Then seconds per iteration replayed against the
    stepped run, the inline sweep of 10 samplers and 10 processes
    (``walls``: their iterations' collect wall + learn seconds), and a
    fused PPO pendulum run of 40 iterations whose return must rise (the
    best 3 of the last 6 above the first 4 by 30, the reference's
    ``tests/test_system.py`` check). Returns the report."""
    from repro_torch.experiment import ExperimentSpec, Schedule, build, run
    n, per, h = MAIN_SAMPLERS
    B = n * per
    report = {"device": device, "graphs": {}}
    big = {"capacity": 1_000_000, "batch_size": 256}
    specs = {
        "ppo cheetah": (ExperimentSpec(env="cheetah", algo="ppo"),
                        {"cheetah_step": h, "gae": 1}),
        "sac cheetah prioritized": (
            ExperimentSpec(env="cheetah", algo="sac", buffer="prioritized",
                           buffer_kwargs=big),
            {"cheetah_step": h, "ring_insert": 1, "ring_gather": 4,
             "sumtree_find": 4, "sumtree_update": 5}),
        "ddpg pendulum uniform": (
            ExperimentSpec(env="pendulum", algo="ddpg", buffer="uniform",
                           buffer_kwargs=big),
            {"pendulum_step": h, "ring_insert": 1, "ring_gather": 4}),
        "trpo cartpole": (ExperimentSpec(env="cartpole", algo="trpo"),
                          {"cartpole_step": h, "gae": 1}),
    }
    iters = 5
    sched = Schedule(num_samplers=1, global_batch=B, horizon=h,
                     iterations=iters)

    def returns(res):
        return [lg.mean_return for lg in res.logs]

    def fused(label, spec, per_replay, iters, samples):
        res = counted(label, lambda: run(spec))
        check_logs(label, res.logs, iters, samples)
        stats = res.runner.graph_stats
        if spec.kernels == "ref":
            per_replay = {}
        nodes = graph_kernel_calls(res.runner.engine.graph)
        assert stats["launches_per_replay"] == nodes == per_replay, (
            label, stats, nodes)
        assert runs[label] == zero_counts(
            **{k: iters * v for k, v in per_replay.items()}), runs
        log(f"main path [{label}]: launches per replay {per_replay} (the "
            f"graph's kernel nodes agree), 2 eager iterations and "
            f"{iters - 2} replays: "
            f"{ {k: v for k, v in runs[label].items() if v} }; warm-up "
            f"{stats['warmup_s']:.3f} s, capture {stats['capture_s']:.3f} "
            f"s, graph pool {stats['pool_mib']:.1f} MiB")
        report["graphs"][label] = {k: stats[k] for k in (
            "warmup_s", "capture_s", "pool_mib", "launches_per_replay")}
        return res

    for name, (spec, per_replay) in specs.items():
        spec = dataclasses.replace(spec, schedule=sched)
        label = f"{name} N=1 B={B}"
        stepped = counted(label, lambda: run(spec))
        check_logs(label, stepped.logs, iters, B * h)
        want = (carried(stepped), returns(stepped))
        if name == "ppo cheetah":
            report["stepped_s_per_iteration"] = [
                lg.collect_time + lg.learn_time for lg in stepped.logs[1:]]
        del stepped
        label = f"fused {name} B={B}"
        res = fused(label, dataclasses.replace(spec, runtime="fused"),
                    per_replay, iters, B * h)
        got = (carried(res), returns(res))
        same_carry(f"{label} vs stepped", got, want)
        del res
        if name in ("ppo cheetah", "sac cheetah prioritized"):
            label = f"fused {name} B={B} ref"
            res = fused(label, dataclasses.replace(
                spec, runtime="fused", kernels="ref"), per_replay, iters,
                B * h)
            same_carry(f"{label} vs cuda", (carried(res), returns(res)), got)
            del res
    label = "fused ppo cheetah vector B=4096"
    res = fused(label, dataclasses.replace(vector_run.spec, runtime="fused"),
                {"cheetah_step": 128, "gae": 1}, 3, 4096 * 128)
    same_carry(f"{label} vs stepped", (carried(res), returns(res)),
               (carried(vector_run), returns(vector_run)))
    del res

    # seconds per iteration: a chunk of 2 (the eager iterations and the
    # capture), then chunks of 10 replays, one host sync each
    label = f"fused ppo cheetah B={B} timing"
    spec, per_replay = specs["ppo cheetah"]
    runner = build(dataclasses.replace(spec, runtime="fused", schedule=sched))
    first = counted(label, lambda: runner.run(2))[-1].learn_time
    replayed = []
    for _ in range(3):
        runner.chunk = 10
        replayed.append(runner.run(10)[-1].learn_time)
    stats = runner.graph_stats
    del runner
    stepped_s = report.pop("stepped_s_per_iteration")
    report["ppo_cheetah_160x125"] = {
        "samples_per_iteration": B * h,
        "stepped_s_per_iteration": stepped_s,
        "fused_first_chunk_s_per_iteration": first,
        "fused_replay_s_per_iteration": replayed,
        "warmup_s": stats["warmup_s"], "capture_s": stats["capture_s"],
        "pool_mib": stats["pool_mib"], **walls}
    log(f"  fused vs stepped, PPO cheetah {B} x {h} ({B * h:,} samples), "
        f"{device}: s per iteration fused (replayed, chunks of 10) "
        f"{[round(x, 4) for x in replayed]}, first chunk of 2 (eager "
        f"iterations and capture) {first:.4f}; stepped at {B} envs "
        f"{[round(x, 4) for x in stepped_s]}; "
        f"collect wall + learn, inline N=10 "
        f"{[round(x, 4) for x in walls['inline_n10_s_per_iteration']]}, "
        f"10 processes "
        f"{[round(x, 4) for x in walls['process_n10_s_per_iteration']]}")

    # learning: PPO pendulum with the reference check's learner
    label = "fused ppo pendulum learning"
    iters = 40
    res = fused(label, ExperimentSpec(
        env="pendulum", algo="ppo", runtime="fused", model={"hidden": 32},
        algo_kwargs={"lr": 1e-3, "epochs": 2, "minibatches": 2},
        schedule=Schedule(global_batch=64, horizon=200, iterations=iters,
                          chunk=10, seed=3)),
        {"pendulum_step": 200, "gae": 1}, iters, 64 * 200)
    rets = returns(res)
    early = sum(rets[:4]) / 4
    late = sum(sorted(rets[-6:])[-3:]) / 3
    log(f"  {label}: mean return of the first 4 iterations {early:.2f}, "
        f"best 3 of the last 6 {late:.2f}, "
        f"{res.logs[-1].learn_time:.4f} s per iteration replayed")
    assert late > early + 30.0, (label, early, late)
    report["pendulum_learning"] = {
        "iterations": iters, "first_4_mean": early,
        "best_3_of_last_6": late, "returns": rets,
        "s_per_iteration_replayed": res.logs[-1].learn_time}
    return report


def overlap_runs(cli, counted, runs, check_logs, zero_counts, device,
                 serial_walls):
    """Slice 11, the overlap schedule (``--overlap``: after two serial
    iterations, collect k+1 runs while learn k does, with the params learn
    k starts from). (a) Fused PPO cheetah at 160 envs × 125 steps, 10
    iterations (2 serial, 8 pipelined: a learn graph on one stream, a
    collect graph on another): bit for bit against a second run, against
    the plain versions (``kernels="ref"``), against the sync runtime's
    overlap on the same carry and against a serial loop written out with
    the stale params; 2 overlapped iterations against the serial fused
    run; seconds per pipelined iteration and ``overlap_saved_s`` against
    the serial fused replay on the same carry; each graph's kernel nodes
    (read by name) equal to its launches per replay, the counts to each
    half's (eager iterations + replays) × those, and the two graphs' pools
    apart. (b) Fused SAC cheetah prioritized (2^20 slots, batch 256), 6
    iterations, against the sync overlap. (c) Sync PPO cheetah N=10
    through the train CLI, 5 iterations, inline and over 10 worker
    processes, the two bit for bit; collect wall and exposed learn against
    the serial runs of the actor-plane phase (``serial_walls``). Returns
    the report."""
    from repro_torch.core.backends import InlineBackend, ProcessBackend
    from repro_torch.core.queues import snapshot
    from repro_torch.data import trajectory
    from repro_torch.experiment import ExperimentSpec, Schedule, build, run
    n, per, h = MAIN_SAMPLERS
    B = n * per
    report = {"device": device}
    iters = 10
    one = Schedule(num_samplers=1, global_batch=B, horizon=h,
                   iterations=iters, overlap=True)
    ppo = ExperimentSpec(env="cheetah", algo="ppo", runtime="fused",
                         schedule=one)

    def returns(res):
        return [lg.mean_return for lg in res.logs]

    def schedule_of(label, logs, iters):
        logs = [lg if isinstance(lg, dict) else lg.as_dict() for lg in logs]
        stale = [lg["staleness"] for lg in logs]
        saved = [lg["overlap_saved_s"] for lg in logs]
        assert stale == [0.0] * 3 + [1.0] * (iters - 3), (label, stale)
        assert min(saved) >= 0.0 and saved[0] == saved[1] == saved[-1] == 0
        assert all(lg["learn_time"] >= 0.0 for lg in logs), label
        # a pipelined iteration with a collect: its window, the learn's
        # exposed part and the part hidden under the collect
        windows = [lg["learn_time"] + lg["overlap_saved_s"]
                   for lg in logs[2:-1]]
        log(f"  {label}: staleness {stale}, overlap_saved_s "
            f"{[round(x, 5) for x in saved]}, exposed learn "
            f"{[round(lg['learn_time'], 5) for lg in logs]}, collect "
            f"{[round(lg['collect_time'], 5) for lg in logs]}, s per "
            f"pipelined iteration {[round(x, 5) for x in windows]}")
        return {"staleness": stale, "overlap_saved_s": saved,
                "learn_time": [lg["learn_time"] for lg in logs],
                "collect_time": [lg["collect_time"] for lg in logs],
                "s_per_pipelined_iteration": windows}

    def fused(label, spec, iters, per_iteration):
        res = counted(label, lambda: run(spec))
        check_logs(label, res.logs, iters, B * h)
        out = schedule_of(label, res.logs, iters)
        # the clock's serial reference is a replayed learn, so where learn k
        # finished before collect k+1, the learn's seconds hidden under that
        # collect are the reference's, below the collect's own
        ref = res.runner._overlap_clock.learn_ref
        first = res.runner.learn_done_first
        hidden = [(k, res.logs[k].overlap_saved_s,
                   res.logs[k + 1].collect_time)
                  for k in range(iters - 1) if first[k]]
        for k, saved, collect_s in hidden:
            assert saved == min(ref, collect_s) and saved < collect_s, (
                label, k, saved, collect_s, ref)
        out["learn_ref_s"] = ref
        out["learn_finished_first"] = [k for k, _, _ in hidden]
        log(f"  {label}: learn reference {ref:.5f} s (a replay); on the "
            f"{len(hidden)} pipelined iterations whose learn finished "
            f"first, overlap_saved_s "
            f"{[round(x, 5) for _, x, _ in hidden]} < their collect "
            f"{[round(x, 5) for _, _, x in hidden]}")
        halves = dict(zip(("collect", "learn"), res.runner.halves))
        want, per_replay = {}, {}
        for half, engine in halves.items():
            stats = engine.graph_stats
            nodes = graph_kernel_calls(engine.graph)
            assert stats["launches_per_replay"] == nodes, (label, half)
            assert engine.eager_iterations + engine.replays == iters
            for k, v in nodes.items():
                per_replay[k] = per_replay.get(k, 0) + v
                want[k] = want.get(k, 0) + (
                    engine.eager_iterations + engine.replays) * v
            out[half] = {"pool_mib": stats["pool_mib"],
                         "capture_s": stats["capture_s"],
                         "kernel_nodes": nodes,
                         "eager": engine.eager_iterations,
                         "replays": engine.replays}
        assert per_replay == ({} if spec.kernels == "ref"
                              else per_iteration), (label, per_replay)
        # iteration 0's learn is the one eager learn: the noted one replays
        assert halves["learn"].eager_iterations == 1, label
        assert runs[label] == zero_counts(**want), (label, runs[label])
        assert (halves["collect"].graph.pool()
                != halves["learn"].graph.pool()), label
        log(f"main path [{label}]: kernel nodes collect "
            f"{out['collect']['kernel_nodes']}, learn "
            f"{out['learn']['kernel_nodes']} (launches per replay agree); "
            f"eager / replays collect {out['collect']['eager']} / "
            f"{out['collect']['replays']}, learn {out['learn']['eager']} / "
            f"{out['learn']['replays']}; graph pools "
            f"{out['collect']['pool_mib']:.1f} / "
            f"{out['learn']['pool_mib']:.1f} MiB")
        return res, out

    # (a) fused PPO cheetah
    label = f"overlap fused ppo cheetah B={B}"
    res, report["ppo_fused"] = fused(label, ppo, iters,
                                     {"cheetah_step": h, "gae": 1})
    want = (carried(res), returns(res))
    del res
    label = f"overlap fused ppo cheetah B={B} again"
    res, report["ppo_fused_again"] = fused(label, ppo, iters,
                                           {"cheetah_step": h, "gae": 1})
    same_carry(f"{label} vs the first run", (carried(res), returns(res)),
               want)
    del res
    label = f"overlap fused ppo cheetah B={B} ref"
    res, _ = fused(label, dataclasses.replace(ppo, kernels="ref"), iters,
                   {"cheetah_step": h, "gae": 1})
    same_carry(f"{label} vs cuda", (carried(res), returns(res)), want)
    del res
    label = f"overlap sync ppo cheetah N=1 B={B}"
    res = counted(label, lambda: run(dataclasses.replace(ppo,
                                                         runtime="sync")))
    check_logs(label, res.logs, iters, B * h)
    report["ppo_sync_n1"] = schedule_of(label, res.logs, iters)
    assert runs[label] == zero_counts(cheetah_step=iters * h, gae=iters)
    same_carry(f"overlap fused ppo cheetah B={B} vs {label}", want,
               (carried(res), returns(res)))
    del res
    # the stale schedule written out: collect k+1 with a snapshot of p_k
    label = f"stale schedule by hand, ppo cheetah B={B}"
    hand = build(dataclasses.replace(
        ppo, runtime="sync", schedule=dataclasses.replace(one,
                                                          overlap=False)))
    step, collect = hand._train_step, hand.backend.collect
    params, opt, plane = hand.params, hand.opt_state, hand.plane_state
    merged, _ = collect(params)
    rets = []
    for k in range(iters):
        acting = snapshot(params) if k >= 2 else params
        params, opt, plane, _ = step(params, opt, plane, merged)
        rets.append(float(trajectory.episode_returns(merged)))
        if k + 1 < iters:
            merged, _ = collect(acting)
    hand.params, hand.opt_state, hand.plane_state = params, opt, plane
    hand.close()
    same_carry(f"overlap fused ppo cheetah B={B} vs {label}", want,
               (carried(types.SimpleNamespace(params=params, runner=hand)),
                rets))
    del hand, params, opt, plane, merged
    # two iterations are the serial schedule
    short = dataclasses.replace(one, iterations=2)
    got = run(dataclasses.replace(ppo, schedule=short))
    serial = run(dataclasses.replace(ppo, schedule=dataclasses.replace(
        short, overlap=False)))
    same_carry("overlap fused ppo cheetah 2 iterations vs serial fused",
               (carried(got), returns(got)),
               (carried(serial), returns(serial)))
    del got, serial
    # the serial fused replay on the same carry, chunks of 10
    runner = build(dataclasses.replace(
        ppo, schedule=dataclasses.replace(one, overlap=False)))
    runner.run(2)
    runner.chunk = 10
    report["ppo_serial_fused_replay_s"] = [runner.run(10)[-1].learn_time
                                           for _ in range(2)]
    del runner
    pipelined = (report["ppo_fused"]["s_per_pipelined_iteration"]
                 + report["ppo_fused_again"]["s_per_pipelined_iteration"])
    log(f"  overlap vs serial, fused PPO cheetah {B} x {h}, {device}: s "
        f"per pipelined iteration {[round(x, 5) for x in pipelined]}, "
        f"serial replay (chunks of 10) "
        f"{[round(x, 5) for x in report['ppo_serial_fused_replay_s']]}")

    # (b) fused SAC cheetah prioritized at 2^20 slots, batch 256
    sac = ExperimentSpec(env="cheetah", algo="sac", buffer="prioritized",
                         runtime="fused",
                         buffer_kwargs={"capacity": 1_000_000,
                                        "batch_size": 256},
                         schedule=dataclasses.replace(one, iterations=6))
    label = f"overlap fused sac cheetah prioritized B={B}"
    res, report["sac_fused"] = fused(label, sac, 6, {
        "cheetah_step": h, "ring_insert": 1, "ring_gather": 4,
        "sumtree_find": 4, "sumtree_update": 5})
    want = (carried(res), returns(res))
    del res
    label = f"overlap sync sac cheetah prioritized N=1 B={B}"
    res = counted(label, lambda: run(dataclasses.replace(sac,
                                                         runtime="sync")))
    check_logs(label, res.logs, 6, B * h)
    report["sac_sync_n1"] = schedule_of(label, res.logs, 6)
    same_carry(f"overlap fused sac vs {label}", want,
               (carried(res), returns(res)))
    del res, want

    # (c) sync PPO cheetah N=10 through the CLI: inline, then 10 processes
    argv = ["--env", "cheetah", "--algo", "ppo", "--num-samplers", str(n),
            "--global-batch", str(B), "--horizon", str(h), "--iterations",
            "5", "--overlap", "--kernels", "cuda"]
    label = "overlap ppo cheetah N=10 inline"
    with recording(InlineBackend) as trajs:
        logs = counted(label, lambda: cli(argv))
    check_logs(label, logs, 5, B * h)
    report["inline_n10"] = schedule_of(label, logs, 5)
    report["inline_n10"]["collect_wall_s"] = trajs.walls
    assert runs[label] == zero_counts(cheetah_step=5 * n * h, gae=5), runs
    inline = snapshot_run(label, cli.result, trajs)
    label = "overlap ppo cheetah N=10 process"
    with recording(ProcessBackend) as trajs:
        logs = counted(label, lambda: cli(argv + ["--backend", "process"]))
    pool = cli.result.runner.backend.pool
    workers = zero_counts()
    for _key, info in pool.worker_launches.items():
        for k, v in info["launches"].items():
            workers[k] += v
    runs[label] = {k: runs[label][k] + workers[k] for k in runs[label]}
    check_no_leftovers(label, pool)
    check_logs(label, logs, 5, B * h)
    report["process_n10"] = schedule_of(label, logs, 5)
    report["process_n10"]["collect_wall_s"] = trajs.walls
    report["process_n10"]["pool_start_s"] = pool.startup_seconds
    assert workers == zero_counts(cheetah_step=5 * n * h), workers
    assert runs[label] == zero_counts(cheetah_step=5 * n * h, gae=5), runs
    same_run(label, snapshot_run(label, cli.result, trajs), inline)
    report["serial"] = serial_walls
    for key in ("inline_n10", "process_n10"):
        log(f"  {key} overlap, {device}: s per pipelined iteration "
            f"{[round(x, 4) for x in report[key]['s_per_pipelined_iteration']]}"
            f", collect wall "
            f"{[round(x, 4) for x in report[key]['collect_wall_s']]}, "
            f"exposed learn "
            f"{[round(x, 4) for x in report[key]['learn_time']]}; serial "
            f"collect wall + learn "
            f"{[round(x, 4) for x in serial_walls[key]]}")
    return report


def learning_run(counted, runs, zero_counts):
    """The learning check (``tests/test_torch_learning.py``, the
    reference's ``tests/test_system.py`` check) on the card, through the
    kernels: PPO pendulum on the stepped sync runtime with the inline
    backend, hidden 32, Adam 1e-3, 2 epochs of 2 minibatches, 4 samplers ×
    16 envs × 200 steps, 20 iterations, seed 3. Every step goes through the
    pendulum kernel and every learn through the GAE kernel; the best 3 of
    the last 6 nonzero mean returns must beat the mean of the first 4 by
    more than 30. Prints and returns the ``learning`` report."""
    from repro_torch.experiment import ExperimentSpec, Schedule, run
    samplers, envs, horizon, iters = 4, 16, 200, 20
    label = "learning ppo pendulum 4 x 16 x 200"
    t0 = time.perf_counter()
    res = counted(label, lambda: run(ExperimentSpec(
        env="pendulum", algo="ppo", backend="inline", runtime="sync",
        model={"hidden": 32},
        algo_kwargs={"lr": 1e-3, "epochs": 2, "minibatches": 2},
        schedule=Schedule(num_samplers=samplers,
                          global_batch=samplers * envs, horizon=horizon,
                          iterations=iters, seed=3))))
    seconds = time.perf_counter() - t0
    assert runs[label] == zero_counts(
        pendulum_step=iters * samplers * horizon, gae=iters), runs[label]
    rets = [lg.mean_return for lg in res.logs]
    early = [r for r in rets[:4] if r != 0.0]
    late = sorted(r for r in rets[-6:] if r != 0.0)[-3:]
    assert early and late, rets
    early_mean, late_mean = sum(early) / len(early), sum(late) / len(late)
    report = {"early_mean": early_mean, "late_mean": late_mean,
              "gain": late_mean - early_mean, "bound": 30.0,
              "seconds": seconds,
              "launches": {k: v for k, v in runs[label].items() if v},
              "returns": rets}
    log(json.dumps({"learning": report}))
    assert late_mean > early_mean + 30.0, (early_mean, late_mean)
    return report


def clone_state(x):
    """A copy of ``x`` (a module, a tensor, or a container of them) that
    shares no storage with it and keeps its ``requires_grad``."""
    import copy
    if isinstance(x, torch.nn.Module):
        with torch.no_grad():
            return copy.deepcopy(x)
    if isinstance(x, torch.Tensor):
        return x.detach().clone()
    if hasattr(x, "moment_dims"):        # an FSDP learner's sharded state
        return clone_state(x.full())
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return type(x)(*(clone_state(v) for v in x))
    if isinstance(x, (list, tuple)):
        return type(x)(clone_state(v) for v in x)
    if isinstance(x, dict):
        return {k: clone_state(v) for k, v in x.items()}
    return x


@contextlib.contextmanager
def learner_steps():
    """While the block runs, keep each ``ShardedLearner.train_step`` call:
    the learner, copies of its params, optimizer state and trajectory
    before the step, and the params after it."""
    from repro_torch.distributed.learner import ShardedLearner
    rec = []
    step = ShardedLearner.train_step

    def recorded(self, params, opt_state, plane, traj):
        before = (clone_state(params), clone_state(opt_state),
                  clone_state(traj))
        out = step(self, params, opt_state, plane, traj)
        rec.append((self, before,
                    [p.detach().clone() for p in out[0].parameters()]))
        return out

    ShardedLearner.train_step = recorded
    try:
        yield rec
    finally:
        ShardedLearner.train_step = step


def learner_step_diff(label, rec, rtol, atol):
    """The largest absolute difference between each recorded PPO learn and
    the plain learner (one device, one microbatch: ``make_train_step``
    with the fifo buffer) on copies of the same params, optimizer state
    and trajectory; asserted within ``rtol``/``atol`` unless ``atol`` is
    None (then only logged)."""
    from repro_torch.algos.api import make_train_step
    from repro_torch.data.buffers import FifoBuffer
    worst = 0.0
    for learner, (params, opt_state, traj), got in rec:
        plain = make_train_step(learner.algo, FifoBuffer())
        want, _, _, _ = plain(params, opt_state, (None, None), traj)
        for a, b in zip(got, want.parameters()):
            b = b.detach()
            worst = max(worst, float((a - b).abs().max()))
            assert atol is None or torch.allclose(a, b, rtol=rtol,
                                                  atol=atol), (
                f"{label}: a learn differs from the plain learner's on the "
                f"same inputs by {float((a - b).abs().max())}")
    bound = "" if atol is None else f" within rtol {rtol}, atol {atol}"
    log(f"  {label}: {len(rec)} learns{bound} against the plain learner "
        f"on the same inputs: max |diff| {worst:.3g}")
    return worst


def max_param_diff(params, tensors):
    return max(float((p.detach() - t).abs().max())
               for p, t in zip(params.parameters(), tensors))


def learner_runs(cli, counted, runs, check_logs, zero_counts, device,
                 ppo_inline, sac_inline, ddpg_params):
    """Slice 17, the data-parallel learner (``distributed/learner.py``),
    on the main path's shapes. ``ppo_inline``, ``sac_inline`` and
    ``ddpg_params`` are the main path's plain CLI runs of PPO, SAC
    prioritized and DDPG prioritized cheetah (10 × 16 × 125, 3
    iterations): the one-device references.

    (a) PPO cheetah through the train CLI with ``--learner-devices 1`` (bit
    for bit the plain run: trajectories and weights) and with
    ``--learner-microbatches 2``: each learn within rtol 1e-4, atol 1e-5
    of the plain learner on the same params and trajectory (the
    reference's bound, ``tests/test_learner_plane.py``), and the run's
    drift from the plain run's final weights logged. (b) fused PPO cheetah,
    one carry of 160 × 125 at M = 2: 2 eager iterations, a capture and 3
    replays, bit for bit the stepped M = 2 run from the same carry, the
    accumulation inside the graph (its kernel nodes read by name); the
    seconds of a replayed iteration at M = 2 and M = 1. (c) the
    ``ShardedLearner`` over the mesh ``[cuda:0, cuda:0]`` (two shard
    threads on the one card): PPO's final weights within 1e-5 of D = 1
    and each learn within 1e-5 of the plain learner on the same inputs;
    SAC and DDPG prioritized at 2^20 slots within 0.05 (the reference's
    D = 4 bounds); the sharded find's global indices equal to the
    unsharded kernel's for the same masses and uniforms, the shard roots
    summing to the root; GAE and the four replay kernels at the per-shard
    shapes bit for bit against their plain versions. (d) ``train
    --learner-devices 2`` on the one card raises the mesh's
    ``ValueError``. (e) every run's launches equal those the code
    predicts: GAE and each replay kernel once per shard per call. Prints
    and returns the ``learner`` report."""
    from repro_torch import kernels as kernels_mod
    from repro_torch.data import buffers, replay
    from repro_torch.distributed.learner import ShardedLearner, run_shards
    from repro_torch.distributed.replay_sharded import (
        ShardedPrioritizedBuffer, ShardStates)
    from repro_torch.experiment import ExperimentSpec, Schedule, run
    from repro_torch.kernels.gae import ops as gae_ops
    from repro_torch.kernels.replay_ring import ops as ring_ops
    from repro_torch.kernels.sum_tree import ops as tree_ops
    from repro_torch.kernels.sum_tree.ref import sumtree_build
    from repro_torch.core.backends import InlineBackend
    n, per, h = MAIN_SAMPLERS
    B, iters, updates = n * per, 3, 4
    report = {"device": device, "runs": {}}
    main_argv = ["--env", "cheetah", "--algo", "ppo", "--num-samplers",
                 str(n), "--global-batch", str(B), "--horizon", str(h),
                 "--iterations", str(iters)]

    def learn_seconds(label, logs):
        logs = [lg if isinstance(lg, dict) else lg.as_dict() for lg in logs]
        report["runs"][label] = {
            "learn_s": [lg["learn_time"] for lg in logs],
            "collect_s": [lg["collect_time"] for lg in logs],
            "launches": {k: v for k, v in runs[label].items() if v}}

    # (a) the CLI flags on one device
    label = "learner ppo cheetah N=10 --learner-devices 1"
    with recording(InlineBackend) as trajs:
        logs = counted(label, lambda: cli(main_argv
                                          + ["--learner-devices", "1"]))
    check_logs(label, logs, iters, B * h)
    same_run(label, snapshot_run(label, cli.result, trajs), ppo_inline)
    assert runs[label] == zero_counts(cheetah_step=iters * n * h,
                                      gae=iters), runs[label]
    learn_seconds(label, logs)

    label = "learner ppo cheetah N=10 --learner-microbatches 2"
    with learner_steps() as rec:
        logs = counted(label, lambda: cli(main_argv
                                          + ["--learner-microbatches", "2"]))
    check_logs(label, logs, iters, B * h)
    assert len(rec) == iters and all(r[0].microbatches == 2 for r in rec)
    report["m2_learn_max_diff"] = learner_step_diff(label, rec, 1e-4, 1e-5)
    report["m2_run_drift"] = max_param_diff(
        cli.result.params, ppo_inline["tensors"])
    log(f"  {label}: final weights {report['m2_run_drift']:.3g} from the "
        f"plain run's (the trajectories follow the weights)")
    assert runs[label] == zero_counts(cheetah_step=iters * n * h,
                                      gae=iters), runs[label]
    learn_seconds(label, logs)
    del rec

    # (b) fused at M = 2: the accumulation inside the graph; chunks of one
    # iteration, so iterations 3 and 4 are one replay each, timed alone
    sched = Schedule(num_samplers=1, global_batch=B, horizon=h,
                     iterations=5, chunk=1, learner_microbatches=2)
    spec = ExperimentSpec(env="cheetah", algo="ppo", schedule=sched)
    label = f"learner ppo cheetah N=1 B={B} M=2"
    stepped = counted(label, lambda: run(spec))
    check_logs(label, stepped.logs, 5, B * h)
    want = (carried(stepped), [lg.mean_return for lg in stepped.logs])
    del stepped
    per_replay = {"cheetah_step": h, "gae": 1}
    for m in (2, 1):
        label = f"learner fused ppo cheetah B={B} M={m}"
        res = counted(label, lambda: run(dataclasses.replace(
            spec, runtime="fused", schedule=dataclasses.replace(
                sched, learner_microbatches=m))))
        check_logs(label, res.logs, 5, B * h)
        stats = res.runner.graph_stats
        nodes = graph_kernel_calls(res.runner.engine.graph)
        assert stats["launches_per_replay"] == nodes == per_replay, (
            stats, nodes)
        assert runs[label] == zero_counts(
            **{k: 5 * v for k, v in per_replay.items()}), runs[label]
        if m == 2:
            same_carry(f"{label} vs stepped M=2", (carried(res), [
                lg.mean_return for lg in res.logs]), want)
        report[f"fused_m{m}"] = {k: stats[k] for k in (
            "warmup_s", "capture_s", "pool_mib", "launches_per_replay")}
        report[f"fused_m{m}"]["s_per_replay"] = [lg.learn_time
                                                 for lg in res.logs[3:]]
        log(f"  {label}: s per replayed iteration "
            f"{report[f'fused_m{m}']['s_per_replay']}, capture "
            f"{stats['capture_s']:.3f} s, pool {stats['pool_mib']:.1f} MiB")
        del res

    # (c) two shard threads on the one card, the reference's mesh= argument
    mesh = [torch.device("cuda", 0)] * 2
    d = len(mesh)

    def sharded(label, spec, iters):
        with learner_steps() as rec:
            res = counted(label, lambda: run(spec, mesh=mesh))
        check_logs(label, res.logs, iters, B * h)
        learner = res.runner._train_step.__self__
        assert isinstance(learner, ShardedLearner) and learner.num_shards == d
        learn_seconds(label, res.logs)
        return res, rec

    base = Schedule(num_samplers=n, global_batch=B, horizon=h,
                    iterations=iters, learner_devices=d)
    # at the main path's T 125 a shard's minibatch (a quarter of its
    # flattened T × B/2 rows) ends inside a time step, so the two shards'
    # minibatch i together are not the one-device minibatch i: another
    # partition of the same samples, as in the reference. Logged; the
    # bound is held at T 128, where the partitions agree
    label = "learner ppo cheetah N=10 D=2 [cuda:0, cuda:0]"
    res, rec = sharded(label, ExperimentSpec(env="cheetah", algo="ppo",
                                             schedule=base), iters)
    report["ppo_d2_t125_learn_max_diff"] = learner_step_diff(label, rec,
                                                             0.0, None)
    report["ppo_d2_t125_final_diff"] = max_param_diff(
        res.params, ppo_inline["tensors"])
    assert runs[label] == zero_counts(cheetah_step=iters * n * h,
                                      gae=d * iters), runs[label]
    del res, rec
    h2 = 128
    spec = ExperimentSpec(env="cheetah", algo="ppo",
                          schedule=dataclasses.replace(
                              base, horizon=h2, learner_devices=None))
    label = f"learner ppo cheetah N=10 T={h2}"
    one = counted(label, lambda: run(spec))
    check_logs(label, one.logs, iters, B * h2)
    ref128 = [p.detach().clone() for p in one.params.parameters()]
    del one
    label = f"learner ppo cheetah N=10 T={h2} D=2 [cuda:0, cuda:0]"
    with learner_steps() as rec:
        res = counted(label, lambda: run(dataclasses.replace(
            spec, schedule=dataclasses.replace(spec.schedule,
                                               learner_devices=d)),
            mesh=mesh))
    check_logs(label, res.logs, iters, B * h2)
    learn_seconds(label, res.logs)
    report["ppo_d2_learn_max_diff"] = learner_step_diff(label, rec, 0.0,
                                                        1e-5)
    report["ppo_d2_final_diff"] = max_param_diff(res.params, ref128)
    log(f"  {label}: final weights {report['ppo_d2_final_diff']:.3g} from "
        f"D = 1's (bound 1e-5)")
    assert report["ppo_d2_final_diff"] < 1e-5
    assert runs[label] == zero_counts(cheetah_step=iters * n * h2,
                                      gae=d * iters), runs[label]
    del res, rec

    big = {"capacity": 1_000_000, "batch_size": 256}
    for algo, ref in (("sac", sac_inline["tensors"]), ("ddpg", ddpg_params)):
        label = f"learner {algo} cheetah N=10 prioritized D=2"
        res, _ = sharded(label, ExperimentSpec(
            env="cheetah", algo=algo, buffer="prioritized",
            buffer_kwargs=big, schedule=base), iters)
        diff = max_param_diff(res.params, ref)
        report[f"{algo}_d2_final_diff"] = diff
        log(f"  {label}: final weights {diff:.3g} from D = 1's (bound "
            f"0.05)")
        assert diff < 0.05, (label, diff)
        assert runs[label] == zero_counts(
            cheetah_step=iters * n * h, ring_insert=d * iters,
            ring_gather=d * iters * updates, sumtree_find=d * iters * updates,
            sumtree_update=d * iters * (1 + updates)), runs[label]
        states, _ = res.runner.plane_state
        assert isinstance(states, ShardStates) and len(states) == d
        assert all(st.tree.capacity == CAP // d
                   and int(st.ring.size) == iters * (B // d) * h
                   for st in states)
        for p in res.params.parameters():
            assert torch.isfinite(p).all(), f"{label}: non-finite weights"
        del res

    # the sharded descent and the kernels at the per-shard shapes
    gen = torch.Generator(device="cuda").manual_seed(17)
    mass = torch.rand(CAP, generator=gen, device="cuda")
    mass[torch.rand(CAP, generator=gen, device="cuda") < 0.3] = 0.0
    storage = ring_leaves(CAP, gen)
    c = CAP // d

    def ring_state(lo, hi):
        return replay.ReplayState(
            {k: v[lo:hi].clone() for k, v in storage.items()},
            torch.zeros((), dtype=torch.int32, device="cuda"),
            torch.tensor(hi - lo, dtype=torch.int32, device="cuda"), True)

    one = torch.ones((), device="cuda")
    shards = ShardStates(buffers.PrioritizedState(
        ring_state(s * c, (s + 1) * c), sumtree_build(mass[s * c:(s + 1) * c]),
        one) for s in range(d))
    whole = buffers.PrioritizedState(ring_state(0, CAP), sumtree_build(mass),
                                     one)
    sbuf = ShardedPrioritizedBuffer(buffers.PrioritizedBuffer(CAP, 256), d)
    uniforms = torch.rand(256, generator=gen, device="cuda")
    kernels_mod.reset_launch_counts()
    outs = run_shards(mesh, lambda s: sbuf.sample_with(shards[s], uniforms),
                      [(s,) for s in range(d)])
    torch.cuda.synchronize()
    launched = kernels_mod.launch_counts()
    assert launched["sumtree_find"] == d and launched["ring_gather"] == d, (
        launched)
    got = {k: torch.cat([o[k] for o in outs]) for k in outs[0]}
    want = buffers.PrioritizedBuffer(CAP, 256).sample_with(whole, uniforms)
    for k in want:
        assert torch.equal(got[k], want[k]), f"sharded sample: {k} differs"
    roots = sum(float(st.tree.total) for st in shards)
    assert math.isclose(roots, float(whole.tree.total), rel_tol=1e-6)
    log(f"  sharded find at 2^20 slots over [cuda:0, cuda:0]: 256 global "
        f"indices, rows and weights equal to the unsharded kernel's; shard "
        f"roots sum {roots:.9g}, root {float(whole.tree.total):.9g}")
    pri = torch.rand(256, generator=gen, device="cuda") + 0.1
    idx, bl = want["indices"], 256 // d
    new = run_shards(mesh, lambda s: sbuf.update_priorities(
        shards[s], idx[s * bl:(s + 1) * bl], pri[s * bl:(s + 1) * bl]),
        [(s,) for s in range(d)])
    want_st = buffers.PrioritizedBuffer(CAP, 256).update_priorities(
        whole, idx, pri)
    torch.cuda.synchronize()
    assert torch.equal(torch.cat([st.tree.levels[0] for st in new]),
                       want_st.tree.levels[0])
    # the shard roots are the unsharded tree's nodes log2(D) levels down
    assert torch.equal(torch.stack([st.tree.total for st in new]),
                       want_st.tree.levels[-1 - int(math.log2(d))])

    def exact(name, got, want):
        got = list(got.values()) if isinstance(got, dict) else list(got)
        want = list(want.values()) if isinstance(want, dict) else list(want)
        assert len(got) == len(want) and all(
            a.dtype == b.dtype and torch.equal(a, b)
            for a, b in zip(got, want)), f"{name} at the per-shard shape"

    r, v, dn, lv = gae_inputs(h, B // d, seed=B // d)
    exact("gae", gae_ops.gae_cuda(r, v, dn, lv, gamma=0.99, lam=0.95),
          gae_ops.gae_ref(r, v, dn, lv, 0.99, 0.95))
    rows = ring_leaves(B // d * h, gen)
    start = c - 1000
    want_ring = ring_ops.ring_insert_ref(
        {k: x.clone() for k, x in shards[1].ring.storage.items()}, rows,
        start)
    exact("ring_insert", ring_ops.ring_insert(
        shards[1].ring.storage, rows, start, impl="cuda"), want_ring)
    loc = torch.randint(0, c, (256,), generator=gen, device="cuda",
                        dtype=torch.int32)
    exact("ring_gather", ring_ops.ring_gather(shards[1].ring.storage, loc,
                                              impl="cuda"),
          ring_ops.ring_gather_ref(shards[1].ring.storage, loc))
    tree = shards[1].tree
    masses = stratified_masses(tree, 256, gen)
    exact("sumtree_find", [tree_ops.sumtree_find_batch(tree, masses,
                                                       impl="cuda")],
          [tree_ops.sumtree_find_batch_ref(tree, masses)])
    # an update with other shards' rows dropped (index c), as the sharded
    # write-back sends it
    masked = torch.where(torch.rand(256, generator=gen, device="cuda") < 0.5,
                         loc, c)
    vals = torch.rand(256, generator=gen, device="cuda")
    want_tree = tree_ops.SumTree.of(tree.flat.clone())
    tree_ops.sumtree_update_ref(want_tree, masked, vals)
    tree_ops.sumtree_update(tree, masked, vals, impl="cuda")
    torch.cuda.synchronize()
    assert torch.equal(tree.flat, want_tree.flat), "masked update differs"
    log(f"  per-shard shapes: gae {h} x {B // d}, ring insert {B // d * h} "
        f"rows into {c} slots, gather 256, find 256 and a masked update of "
        f"256 in {c} leaves: bit for bit")

    # (d) two learner devices on one card
    try:
        cli(main_argv + ["--learner-devices", "2"])
    except ValueError as e:
        assert "learner_devices=2" in str(e), e
        log(f"  --learner-devices 2 on one card: ValueError: {e}")
    else:
        raise AssertionError("--learner-devices 2 ran on one card")
    report["launches_checked"] = sorted(
        k for k in runs if k.startswith("learner "))
    log(json.dumps({"learner": report}))
    return report


def sharding_runs(cli, counted, runs, check_logs, zero_counts, device,
                  sac_inline):
    """Slice 18: FSDP, learner pods, the sharded backend and overlap over
    a learner mesh, at the main path's width (PPO cheetah, walle-mlp 2 ×
    64, 10 samplers × 16 envs × 125 steps, 3 iterations), every mesh entry
    ``cuda:0``. ``sac_inline`` is the main path's SAC prioritized run.

    (a) FSDP over ``[cuda:0, cuda:0]``: each learn within rtol 1e-4, atol
    1e-5 of the replicated D = 2 learner on copies of the same params,
    optimizer state and trajectory (at T 125 a shard's minibatch ends
    inside a time step, so D = 2 partitions the samples otherwise than
    D = 1; the replicated D = 2 learner partitions them as FSDP does); the
    final weights within 1e-4 of replicated D = 2's, and at T 128 of
    D = 1's (``tests/test_fsdp_pipeline.py``'s bound); each shard's stored
    bytes (params, moments, step) equal to ``fsdp_layout``'s prediction,
    also at hidden 512, where every leaf of 1 MiB or more must be sharded;
    SAC prioritized (2^20 slots, batch 256) under FSDP within 0.05 of the
    main path's run. (b) ``learner_pods=2`` over four entries of
    ``cuda:0`` with FSDP: within 1e-4 of replicated D = 4's (T 125) and of
    D = 1's (T 128). (c) the sharded backend: ``--backend sharded``
    through the CLI (the card's one device), then ``make_backend`` over
    ``[cuda:0, cuda:0]``, ten entries of ``cuda:0`` (one sampler's 16 envs
    a shard: bit for bit the inline backend's) and one device (160 envs a
    launch: the first step's actions within 1e-5, the largest difference
    over the sweep logged with its leaf), each against the inline backend
    from the same carries; cheetah-step launches 125 × D a sweep against
    inline's 1,250; the collect seconds of each beside inline's. (d)
    overlap, D = 2 with FSDP on ``[cuda:0, cuda:0]``, 6 iterations:
    staleness 0 on the first two logs and 1 from the fourth, saved seconds
    >= 0 and > 0 on a pipelined iteration, final weights within 0.05 of
    the serial run's. (e) ``--fsdp`` on one learner device: the
    reference's ``ValueError``; ``--backend fused --learner-devices 2``:
    the ``NotImplementedError`` naming ROADMAP.md item 10f. (f) every
    run's launches equal those the code predicts: the env step T × N a
    collect (T × D through the sharded backend), GAE and each replay
    kernel once per shard per call. Prints and returns the ``sharding``
    report (``device``: the card's name and power limit, beside every
    time in it)."""
    from repro_torch import envs, registry
    from repro_torch.core import sampler
    from repro_torch.core.backends import InlineBackend, make_backend
    from repro_torch.data.buffers import FifoBuffer
    from repro_torch.distributed.learner import (ShardedLearner,
                                                 ShardedOptState)
    from repro_torch.experiment import ExperimentSpec, Schedule, run
    n, per, h = MAIN_SAMPLERS
    B, iters, updates = n * per, 3, 4
    cuda = torch.device("cuda", 0)
    report = {"device": device, "runs": {}}

    def seconds(label, logs):
        logs = [lg if isinstance(lg, dict) else lg.as_dict() for lg in logs]
        report["runs"][label] = {
            "learn_s": [lg["learn_time"] for lg in logs],
            "collect_s": [lg["collect_time"] for lg in logs],
            "launches": {k: v for k, v in runs[label].items() if v}}

    def spec(horizon=h, **sched):
        return ExperimentSpec(env="cheetah", algo="ppo", schedule=Schedule(
            num_samplers=n, global_batch=B, horizon=horizon,
            iterations=sched.pop("iterations", iters), **sched))

    def ppo_run(label, sp, mesh=None, record=False):
        d = int(sp.schedule.learner_devices or 1)
        with learner_steps() as rec:
            res = counted(label, lambda: run(sp, mesh=mesh))
        check_logs(label, res.logs, sp.schedule.iterations,
                   B * sp.schedule.horizon)
        assert runs[label] == zero_counts(
            cheetah_step=sp.schedule.iterations * n * sp.schedule.horizon,
            gae=d * sp.schedule.iterations), runs[label]
        seconds(label, res.logs)
        weights = [p.detach().clone() for p in res.params.parameters()]
        return res, weights, (rec if record else None)

    def predicted_bytes(learner, params):
        """Each shard's stored bytes as ``fsdp_layout`` lays them out: a
        sharded leaf and its two moments at 1/D, the rest whole, and the
        4-byte step counter."""
        table = learner.fsdp_layout(params)
        from repro_torch.distributed import sharding
        total = 4
        for name, p in params.named_parameters():
            key = (sharding.reference_leaf(name, p.shape)[0][-1],
                   tuple(p.shape))
            share = learner.num_shards if key in table else 1
            total += 3 * p.numel() * p.element_size() // share
        return total

    def storage(label, res, d):
        learner = res.runner._train_step.__self__
        assert learner.fsdp and isinstance(res.runner.opt_state,
                                           ShardedOptState)
        want = predicted_bytes(learner, res.params)
        got = learner.shard_bytes()
        full = sum(3 * p.numel() * p.element_size()
                   for p in res.params.parameters()) + 4
        assert got == [want] * d, (label, got, want)
        shapes = sorted(shape for _, shape in learner._fsdp_info.full_table)
        log(f"  {label}: each shard stores {want} bytes of params, moments "
            f"and step against {full} replicated (sharded: the leaves of "
            f"shape {shapes})")
        return {"shard_bytes": got, "replicated_bytes": full}

    def learns_against_replicated(label, rec, d):
        """Each recorded FSDP learn against a replicated learner over the
        same mesh, from copies of the same inputs."""
        worst = 0.0
        for learner, (params, opt_state, traj), got in rec:
            assert learner.fsdp
            rep = ShardedLearner(learner.algo, FifoBuffer(),
                                 mesh=[cuda] * d)
            want, _, _, _ = rep.train_step(
                params, opt_state,
                (None, torch.Generator(device=cuda)), traj)
            for a, b in zip(got, want.parameters()):
                b = b.detach()
                worst = max(worst, float((a - b).abs().max()))
                assert torch.allclose(a, b, rtol=1e-4, atol=1e-5), (
                    f"{label}: a learn differs from the replicated "
                    f"learner's by {float((a - b).abs().max())}")
        log(f"  {label}: {len(rec)} learns within rtol 1e-4, atol 1e-5 of "
            f"the replicated D = {d} learner on the same inputs: max "
            f"|diff| {worst:.3g}")
        return worst

    def diff(a, b):
        return max(float((x - y).abs().max()) for x, y in zip(a, b))

    # (a) FSDP over [cuda:0, cuda:0]
    two = [cuda] * 2
    _, repl2, _ = ppo_run("sharding ppo D=2 replicated", spec(
        learner_devices=2), mesh=two)
    label = "sharding ppo D=2 fsdp"
    res, fsdp2, rec = ppo_run(label, spec(learner_devices=2, fsdp=True),
                              mesh=two, record=True)
    report["fsdp_d2_learn_max_diff"] = learns_against_replicated(label, rec,
                                                                 2)
    del rec
    report["fsdp_d2_vs_replicated_d2"] = diff(fsdp2, repl2)
    assert report["fsdp_d2_vs_replicated_d2"] < 1e-4
    report["fsdp_d2_storage"] = storage(label, res, 2)
    del res
    h2 = 128
    _, one128, _ = ppo_run(f"sharding ppo T={h2} D=1", spec(horizon=h2))
    _, fsdp128, _ = ppo_run(f"sharding ppo T={h2} D=2 fsdp", spec(
        horizon=h2, learner_devices=2, fsdp=True), mesh=two)
    report["fsdp_d2_t128_vs_d1"] = diff(fsdp128, one128)
    assert report["fsdp_d2_t128_vs_d1"] < 1e-4
    log(f"  fsdp D=2: final weights {report['fsdp_d2_vs_replicated_d2']:.3g}"
        f" from replicated D=2 (T {h}), {report['fsdp_d2_t128_vs_d1']:.3g} "
        f"from D=1 (T {h2}); bound 1e-4")
    label = "sharding ppo hidden 512 D=2 fsdp"
    big = ExperimentSpec(env="cheetah", algo="ppo", model={"hidden": 512},
                         schedule=Schedule(num_samplers=n, global_batch=B,
                                           horizon=h, iterations=1,
                                           learner_devices=2, fsdp=True))
    res = counted(label, lambda: run(big, mesh=two))
    check_logs(label, res.logs, 1, B * h)
    assert runs[label] == zero_counts(cheetah_step=n * h, gae=2)
    seconds(label, res.logs)
    report["fsdp_hidden512_storage"] = storage(label, res, 2)
    learner = res.runner._train_step.__self__
    for name, p in res.params.named_parameters():
        if p.numel() * p.element_size() >= 1 << 20:
            assert any(q.shape != p.shape for nm, q in
                       learner._params[0].named_parameters()
                       if nm == name), f"{name} stored whole"
    del res, learner
    label = "sharding sac cheetah prioritized D=2 fsdp"
    sac = ExperimentSpec(env="cheetah", algo="sac", buffer="prioritized",
                         buffer_kwargs={"capacity": CAP, "batch_size": 256},
                         schedule=Schedule(num_samplers=n, global_batch=B,
                                           horizon=h, iterations=iters,
                                           learner_devices=2, fsdp=True))
    res = counted(label, lambda: run(sac, mesh=two))
    check_logs(label, res.logs, iters, B * h)
    assert runs[label] == zero_counts(
        cheetah_step=iters * n * h, ring_insert=2 * iters,
        ring_gather=2 * iters * updates, sumtree_find=2 * iters * updates,
        sumtree_update=2 * iters * (1 + updates)), runs[label]
    seconds(label, res.logs)
    report["fsdp_sac_d2_vs_d1"] = max_param_diff(res.params,
                                                 sac_inline["tensors"])
    assert report["fsdp_sac_d2_vs_d1"] < 0.05
    log(f"  {label}: final weights {report['fsdp_sac_d2_vs_d1']:.3g} from "
        f"the main path's D = 1 run (bound 0.05)")
    del res

    # (b) learner pods 2 x 2 over four entries of cuda:0
    four = [cuda] * 4
    _, repl4, _ = ppo_run("sharding ppo D=4 replicated", spec(
        learner_devices=4), mesh=four)
    label = "sharding ppo D=4 pods=2 fsdp"
    res, pods4, _ = ppo_run(label, spec(learner_devices=4, learner_pods=2,
                                        fsdp=True), mesh=four)
    mesh = res.runner._train_step.__self__.mesh
    assert mesh.axis_names == ("pod", "data", "model") and mesh.shape == {
        "pod": 2, "data": 2, "model": 1}
    report["pods_storage"] = storage(label, res, 4)
    del res
    _, pods128, _ = ppo_run(f"sharding ppo T={h2} D=4 pods=2 fsdp", spec(
        horizon=h2, learner_devices=4, learner_pods=2, fsdp=True),
        mesh=four)
    report["pods_vs_replicated_d4"] = diff(pods4, repl4)
    report["pods_t128_vs_d1"] = diff(pods128, one128)
    assert report["pods_vs_replicated_d4"] < 1e-4
    assert report["pods_t128_vs_d1"] < 1e-4
    log(f"  pods 2 x 2 fsdp: final weights "
        f"{report['pods_vs_replicated_d4']:.3g} from replicated D=4 (T {h}),"
        f" {report['pods_t128_vs_d1']:.3g} from D=1 (T {h2}); bound 1e-4")

    # (c) the sharded backend
    label = "sharding ppo --backend sharded (one device)"
    logs = counted(label, lambda: cli(
        ["--env", "cheetah", "--algo", "ppo", "--backend", "sharded",
         "--num-samplers", str(n), "--global-batch", str(B), "--horizon",
         str(h), "--iterations", str(iters)]))
    check_logs(label, logs, iters, B * h)
    assert runs[label] == zero_counts(cheetah_step=iters * h, gae=iters)
    assert cli.result.runner.backend.num_samplers == 1
    seconds(label, logs)
    env = envs.make("cheetah")
    algo = registry.make("algo", "ppo")
    params, _ = algo.init(torch.Generator().manual_seed(0), env, cuda)

    sweeps = 3

    def sweep(label, kind, mesh):
        """Three collects from fresh carries (sampler i seeded i), their
        trajectories and wall seconds; the launches of all three counted
        as one run."""
        carries = [sampler.init_env_carry(env, i, per, cuda)
                   for i in range(n)]
        backend = make_backend(kind, algo.make_rollout(env, h), carries,
                               env=env, horizon=h, mesh=mesh, hooks=algo)
        trajs, walls = [], []

        def collects():
            for _ in range(sweeps):
                t0 = time.perf_counter()
                traj, _ = backend.collect(params)
                torch.cuda.synchronize()
                walls.append(time.perf_counter() - t0)
                trajs.append({k: v.clone() for k, v in traj.items()})

        with backend:
            counted(label, collects)
        return trajs, walls, runs[label]

    backend_report = {}
    want, walls, counts = sweep("sharding inline backend sweeps", "inline",
                                None)
    assert counts == zero_counts(cheetah_step=sweeps * n * h), counts
    backend_report["inline"] = {"collect_s": walls,
                                "cheetah_step_per_sweep": n * h}
    for d in (n, 2, 1):
        got, walls, counts = sweep(f"sharding sharded backend D={d}",
                                   "sharded", [cuda] * d)
        assert counts == zero_counts(cheetah_step=sweeps * d * h), counts
        worst, leaf = 0.0, None
        for a, b in zip(got, want):
            assert sorted(a) == sorted(b)
            for k in b:
                assert a[k].shape == b[k].shape and a[k].dtype == b[k].dtype
                e = float((a[k].float() - b[k].float()).abs().max())
                if e > worst:
                    worst, leaf = e, k
        if d == n:
            assert worst == 0.0, (d, worst, leaf)
        first = float((got[0]["actions"][0] - want[0]["actions"][0]).abs()
                      .max())
        assert first <= 1e-5, (d, first)
        backend_report[f"D={d}"] = {
            "collect_s": walls, "cheetah_step_per_sweep": d * h,
            "first_step_actions_max_diff": first,
            "trajectory_max_diff": worst, "trajectory_max_diff_leaf": leaf}
        log(f"  sharded backend D={d}: {d * h} cheetah-step "
            f"launches a sweep (inline {n * h}); collect s "
            f"{[round(w, 4) for w in walls]} (inline "
            f"{[round(w, 4) for w in backend_report['inline']['collect_s']]}"
            f"); first step's actions {first:.3g} from inline's, largest "
            f"difference over {len(got)} sweeps {worst:.3g} ({leaf})")
    report["sharded_backend"] = backend_report

    # (d) overlap over a two-shard FSDP mesh
    _, serial, _ = ppo_run("sharding ppo 6 iterations serial",
                           spec(iterations=6))
    label = "sharding ppo D=2 fsdp --overlap"
    with recording(InlineBackend) as trajs:
        res, over, _ = ppo_run(label, spec(iterations=6, learner_devices=2,
                                           fsdp=True, overlap=True),
                               mesh=two)
    logs = [lg.as_dict() for lg in res.logs]
    assert [lg["staleness"] for lg in logs[:2]] == [0.0, 0.0], logs
    assert all(lg["staleness"] == 1.0 for lg in logs[3:]), logs
    assert all(lg["overlap_saved_s"] >= 0.0 for lg in logs)
    assert any(lg["overlap_saved_s"] > 0.0 for lg in logs[2:-1]), logs
    report["overlap"] = {
        "staleness": [lg["staleness"] for lg in logs],
        "overlap_saved_s": [lg["overlap_saved_s"] for lg in logs],
        "collect_wall_s": trajs.walls,
        "final_vs_serial": diff(over, serial)}
    assert report["overlap"]["final_vs_serial"] < 0.05
    log(f"  {label}: staleness {report['overlap']['staleness']}, saved s "
        f"{report['overlap']['overlap_saved_s']}, final weights "
        f"{report['overlap']['final_vs_serial']:.3g} from serial (bound "
        f"0.05)")
    del res

    # (e) the refusals
    main_argv = ["--env", "cheetah", "--algo", "ppo", "--num-samplers",
                 str(n), "--global-batch", str(B), "--horizon", str(h),
                 "--iterations", "1"]
    for argv, err, words in (
            (["--fsdp"], ValueError, "requires learner_devices > 1"),
            (["--backend", "fused", "--learner-devices", "2"],
             NotImplementedError, "item 10f")):
        try:
            cli(main_argv + argv)
        except err as e:
            assert words in str(e), e
            log(f"  {' '.join(argv)}: {type(e).__name__}: {e}")
        else:
            raise AssertionError(f"{argv} ran")
    report["launches_checked"] = sorted(k for k in runs
                                        if k.startswith("sharding "))
    log(json.dumps({"sharding": report}))
    return report


def dtype_runs(counted, runs, check_logs, zero_counts):
    """Envs with half-precision obs and rewards, each run with the kernels
    (counted) and again with the plain versions (``kernels="ref"``, no
    launch), the two bit for bit (carried tensors and mean returns): PPO
    cheetah with bfloat16 obs at the paper's 10 × 16 × 125 (3 iterations)
    and fused at one carry of 160 × 125 (5 iterations: 2 eager, a capture,
    3 replays), and SAC cheetah prioritized (2^20 slots, batch 256) with
    float16 obs at 10 × 16 × 125 (3 iterations). Returns the launches of
    each kernel run."""
    from repro_torch import kernels
    from repro_torch.experiment import ExperimentSpec, Schedule, run
    n, per, h = MAIN_SAMPLERS
    B = n * per
    stepped = Schedule(num_samplers=n, global_batch=B, horizon=h,
                       iterations=3)
    fused = Schedule(num_samplers=1, global_batch=B, horizon=h,
                     iterations=5)
    bf16, f16 = {"dtype": "bfloat16"}, {"dtype": "float16"}
    sac_counts = dict(cheetah_step=3 * n * h, ring_insert=3,
                      ring_gather=3 * 4, sumtree_find=3 * 4,
                      sumtree_update=3 * (1 + 4))
    cases = {
        "ppo cheetah bfloat16 N=10": (
            ExperimentSpec(env="cheetah", algo="ppo", env_kwargs=bf16,
                           schedule=stepped),
            dict(cheetah_step=3 * n * h, gae=3), B * h),
        f"fused ppo cheetah bfloat16 B={B}": (
            ExperimentSpec(env="cheetah", algo="ppo", runtime="fused",
                           env_kwargs=bf16, schedule=fused),
            dict(cheetah_step=5 * h, gae=5), B * h),
        "sac cheetah float16 N=10 prioritized": (
            ExperimentSpec(env="cheetah", algo="sac", buffer="prioritized",
                           buffer_kwargs={"capacity": 1_000_000,
                                          "batch_size": 256},
                           env_kwargs=f16, schedule=stepped),
            sac_counts, B * h),
    }
    out = {}
    for label, (spec, want_counts, samples) in cases.items():
        res = counted(label, lambda: run(spec))
        check_logs(label, res.logs, spec.schedule.iterations, samples)
        assert runs[label] == zero_counts(**want_counts), runs[label]
        carry = carried(res)
        assert any(x.dtype == torch.float16 or x.dtype == torch.bfloat16
                   for x in carry), f"{label}: no half-precision obs carried"
        got = (carry, [lg.mean_return for lg in res.logs])
        del res
        kernels.reset_launch_counts()
        ref = run(dataclasses.replace(spec, kernels="ref"))
        torch.cuda.synchronize()
        assert sum(kernels.launch_counts().values()) == 0, label
        same_carry(f"{label} vs kernels=ref", got,
                   (carried(ref), [lg.mean_return for lg in ref.logs]))
        del ref
        out[label] = {k: v for k, v in runs[label].items() if v}
    log(json.dumps({"env_dtypes": out}))
    return out


def publish_scaled(spec_json, scale):
    """The hot-swap's learner stand-in, in a spawned process: attach to the
    channel from its JSON handoff and publish every leaf scaled."""
    from repro_torch.core.ipc import ChannelSpec, ParamsChannel
    chan = ParamsChannel.attach(ChannelSpec.from_json(spec_json))
    leaves, _ = chan.read()
    chan.publish([x * np.float32(scale) for x in leaves])
    chan.close()


# the serving line's two traffic settings: slots, deadline ms, clients,
# requests
SERVE_SETTINGS = ((8, 5.0, 4, 512), (64, 5.0, 64, 4096))


def serving_runs(cli, counted, runs, zero_counts, device):
    """Train -> checkpoint -> serve on the card: PPO pendulum through the
    train CLI at 10 × 16 × 125 (2 iterations) with ``--kernels cuda
    --ckpt-dir``, then ``load_policy`` (params bit for bit the run's) and
    ``PolicyServer.from_checkpoint`` (8 slots): a full batch, deadline
    partial batches and one request at a time, each action bit for bit
    ``reference_act``'s; a hot-swap published from a spawned process
    through ``ChannelSpec.to_json`` mid-traffic (256 requests from 8
    threads, a request every 2 ms until the publish lands, 256 more), each
    action the bits of its version's reference, both versions serving,
    none dropped; SAC and DDPG cheetah prioritized checkpoints (2 × 8 × 32, 2
    iterations), each served and checked the same way; ``serve_policy``
    with ``--swap-after``; then ``serve_policy`` at each of
    ``SERVE_SETTINGS`` for requests/s, latency, dispatches and occupancy,
    and the median host time of one idle ``reference_act`` at that width,
    printed as a ``{"serving": ...}`` line. Nothing may be left behind."""
    import concurrent.futures
    import copy
    import tempfile
    import uuid
    from repro_torch.core.ipc import ParamsChannel, param_leaves
    from repro_torch.launch import serve_policy
    from repro_torch.serve import PolicyServer, load_policy

    def same(label, got, want):
        assert np.array_equal(got, want), f"{label}: {got} != {want}"

    def check_batching(label, ckpt):
        """Full, partial and single dispatches against reference_act."""
        with PolicyServer.from_checkpoint(ckpt, slots=8,
                                          deadline_ms=2000.0) as server:
            assert server.device.type == "cuda", server.device
            obs = np.random.RandomState(0).randn(
                24, server.env.obs_dim).astype(np.float32)
            full = [server.submit(o) for o in obs[:8]]
            for p in full:
                same(f"{label} full", p.result(60.0),
                     server.reference_act(p.obs, p.noise))
            assert server.stats.dispatches == 1, server.stats.dispatches
        with PolicyServer.from_checkpoint(ckpt, slots=8,
                                          deadline_ms=20.0) as server:
            partial = [server.submit(o) for o in obs[8:11]]
            for p in partial:
                same(f"{label} partial", p.result(60.0),
                     server.reference_act(p.obs, p.noise))
            snap = server.snapshot()
            assert snap["dispatches"] == 1 and snap["wasted_slot_steps"] == 5
            for o in obs[11:]:
                p = server.submit(o)
                same(f"{label} single", p.result(60.0),
                     server.reference_act(p.obs, p.noise))
            assert server.stats.dispatches == 1 + len(obs) - 11
        log(f"serving {label}: full, partial and single dispatches bit for "
            f"bit equal to reference_act")

    def quiet(fn, *args):
        with contextlib.redirect_stdout(io.StringIO()):
            return fn(*args)

    report = {"device": device}
    with tempfile.TemporaryDirectory() as tmp:
        n, per, h = MAIN_SAMPLERS
        ppo_dir = os.path.join(tmp, "ppo")
        label = "serving: ppo pendulum N=10 --ckpt-dir"
        counted(label, lambda: cli([
            "--env", "pendulum", "--algo", "ppo", "--num-samplers", str(n),
            "--global-batch", str(n * per), "--horizon", str(h),
            "--iterations", "2", "--kernels", "cuda", "--ckpt-dir",
            ppo_dir]))
        assert runs[label] == zero_counts(pendulum_step=2 * n * h,
                                          gae=2), runs[label]
        trained = cli.result.params
        handle = load_policy(ppo_dir)
        assert handle.step == 2 and handle.spec.algo == "ppo"
        for a, b in zip(trained.parameters(), handle.params.parameters()):
            assert b.is_cuda and torch.equal(a, b), "restored params differ"
        check_batching("ppo pendulum", ppo_dir)

        # the hot-swap: a spawned learner stand-in publishes mid-traffic
        leaves = param_leaves(handle.params)
        channel = ParamsChannel.create(
            leaves, f"walle-{os.getpid()}-serve-{uuid.uuid4().hex[:6]}")
        channel.publish(leaves)
        scale = 1.5
        v2 = copy.deepcopy(handle.params)
        with torch.no_grad():
            for p in v2.parameters():
                p.mul_(scale)
        obs = np.random.RandomState(1).randn(
            512, handle.env.obs_dim).astype(np.float32)
        try:
            with PolicyServer(handle.env, handle.algo, handle.params,
                              slots=8, deadline_ms=2.0, queue_cap=8192,
                              params_channel=channel) as server:
                proc = multiprocessing.get_context("spawn").Process(
                    target=publish_scaled,
                    args=(channel.spec.to_json(), scale))
                with concurrent.futures.ThreadPoolExecutor(8) as pool:
                    pending = [f.result() for f in [
                        pool.submit(server.submit, o) for o in obs[:256]]]
                    proc.start()
                    # traffic flows until the publish lands, then 256 more
                    deadline = time.monotonic() + 60.0
                    while (server.params_version < 2
                           and time.monotonic() < deadline):
                        pending.append(server.submit(
                            obs[len(pending) % len(obs)]))
                        time.sleep(0.002)
                    assert server.params_version == 2, server.params_version
                    pending += [f.result() for f in [
                        pool.submit(server.submit, o) for o in obs[256:]]]
                actions = [p.result(60.0) for p in pending]
                proc.join(60.0)
                assert proc.exitcode == 0, proc.exitcode
                versions = [p.params_version for p in pending]
                with PolicyServer(handle.env, handle.algo, handle.params,
                                  slots=8) as ref1, \
                        PolicyServer(handle.env, handle.algo, v2,
                                     slots=8) as ref2:
                    for p, a in zip(pending, actions):
                        ref = ref1 if p.params_version == 1 else ref2
                        same("hot-swap", a, ref.reference_act(p.obs, p.noise))
            assert all(p.done() for p in pending)
            assert versions.count(1) and versions.count(2), versions
        finally:
            channel.close(unlink=True)
        report["hot_swap"] = {"requests": len(actions),
                              "served_by_v1": versions.count(1),
                              "served_by_v2": versions.count(2)}
        log(f"serving hot-swap: {len(actions)} requests, "
            f"{versions.count(1)} on version 1 and {versions.count(2)} on "
            f"version 2, each bit for bit its version's reference")

        # off-policy checkpoints, trained through the replay kernels
        for algo in ("sac", "ddpg"):
            d = os.path.join(tmp, algo)
            label = f"serving: {algo} cheetah prioritized --ckpt-dir"
            counted(label, lambda: cli([
                "--env", "cheetah", "--algo", algo, "--buffer",
                "prioritized", "--num-samplers", "2", "--global-batch",
                "16", "--horizon", "32", "--iterations", "2",
                "--replay-capacity", "4096", "--replay-batch", "64",
                "--kernels", "cuda", "--ckpt-dir", d]))
            assert runs[label] == zero_counts(
                cheetah_step=2 * 2 * 32, ring_insert=2, ring_gather=2 * 4,
                sumtree_find=2 * 4, sumtree_update=2 * (1 + 4)), runs[label]
            trained = cli.result.params
            restored = load_policy(d).params
            for a, b in zip(trained.parameters(), restored.parameters()):
                assert torch.equal(a, b), f"{algo}: restored params differ"
            check_batching(f"{algo} cheetah", d)

        snap = quiet(serve_policy.main, [
            "--ckpt", ppo_dir, "--slots", "8", "--requests", "64",
            "--clients", "4", "--swap-after", "16"])
        assert snap["requests"] >= 64 and snap["params_version"] == 2, snap
        log(f"serving serve_policy --swap-after 16: exit 0, version "
            f"{snap['params_version']}")

        report["settings"] = []
        for slots, deadline_ms, clients, requests in SERVE_SETTINGS:
            snap = quiet(serve_policy.main, [
                "--ckpt", ppo_dir, "--slots", str(slots), "--deadline-ms",
                str(deadline_ms), "--clients", str(clients), "--requests",
                str(requests)])
            assert snap["requests"] == requests, snap
            # one dispatch at this width with no traffic: the host time of
            # reference_act on an idle server (dispatcher not started)
            server = PolicyServer.from_checkpoint(ppo_dir, slots=slots)
            try:
                obs0 = np.zeros(server.env.obs_dim, np.float32)
                noise0 = np.zeros(server.env.act_dim, np.float32)
                times = []
                for i in range(55):
                    t0 = time.perf_counter()
                    server.reference_act(obs0, noise0)
                    if i >= 5:
                        times.append(time.perf_counter() - t0)
            finally:
                server.close()
            entry = {"slots": slots, "deadline_ms": deadline_ms,
                     "clients": clients, "requests": requests,
                     "requests_per_sec": snap["requests_per_sec"],
                     "latency_ms_p50": snap["latency_ms"]["p50"],
                     "latency_ms_p99": snap["latency_ms"]["p99"],
                     "queue_wait_ms_p50": snap["queue_wait_ms"]["p50"],
                     "dispatches": snap["dispatches"],
                     "batch_occupancy": snap["batch_occupancy"],
                     "wall_seconds": snap["wall_seconds"],
                     "dispatch_ms": float(np.median(times)) * 1e3}
            report["settings"].append(entry)
            log(f"serving ppo pendulum {entry}")
    report["launches"] = {k: {n: c for n, c in v.items() if c}
                          for k, v in runs.items()
                          if k.startswith("serving:")}
    check_no_leftovers("serving")
    log(json.dumps({"serving": report}))
    return report


# slice 16: LM training
LM_TRAIN_ARCH = "hymba-1.5b"
LM_TRAIN_ARGS = ["--batch", "2", "--seq-len", "64"]
# the example's loop: samplers, sequences each, prompt, tokens
LM_LOOP = dict(samplers=2, batch=8, prompt_len=8, gen_len=24)
LM_FAMILIES = ("h2o-danube-3-4b-reduced", "falcon-mamba-7b-reduced",
               "mixtral-8x7b-reduced", "qwen2-vl-7b-reduced",
               "musicgen-medium-reduced")
LM_REMATS = ("none", "full", "scan2", "dots", "scan2_dots")
# the rollout's float32 behaviour logp against the plain paths at full
# depth: LM_F32_TOL bounds float32 logits through 4 layers; hymba-1.5b has
# 8 times the layers, and a logp is a logit less a log-sum-exp of them
LM_LOGP_F32_TOL = 2 * (32 // 4) * LM_F32_TOL
# remat "none" against "full", bfloat16 grads: both run the same ops, but
# the card's backward sums (the embedding's scatter-add, split-K matmuls)
# may run in another order, and each grad is rounded to bfloat16 (2^-8
# relative); so each leaf's max |difference| within 2^-5 of its max |grad|
LM_REMAT_REL_TOL = 2.0 ** -5


def lm_logps(logits, tokens):
    """Each step's log-prob of ``tokens[:, t]`` from ``logits[t]``."""
    return torch.stack([torch.log_softmax(z.float(), -1).gather(
        -1, tokens[:, t:t + 1])[:, 0] for t, z in
        enumerate(logits[:tokens.shape[1]])], 1)


def plain_rollout_logps(cfg, params, prompt, tokens):
    """``tokens``' behaviour logp by the plain paths: the decode path
    teacher-forced with them, and the training ``forward`` +
    ``token_logp_entropy`` over the whole context ``[prompt, tokens[:,
    :-1]]``."""
    from repro_torch import kernels
    from repro_torch.models import transformer
    T = tokens.shape[1]
    prev = kernels.set_kernel_mode("ref")
    try:
        _, logits, _ = teacher_forced(cfg, params, prompt, T, tokens=tokens)
        with torch.no_grad():
            context = torch.cat([prompt, tokens[:, :-1]], dim=1)
            h, _ = transformer.forward(cfg, params, context, remat="none")
            fwd, _ = transformer.token_logp_entropy(cfg, params, h[:, -T:],
                                                    tokens)
    finally:
        kernels.set_kernel_mode(prev)
    return lm_logps(logits, tokens), fwd


def lm_train_runs(counted, runs, zero_counts, smi):
    """Phase 4 for the LM training slice (``lm_train``): (a) ``--mode lm``
    at hymba-1.5b's full width, bfloat16 with bfloat16 moments; (b) the
    example's RL loop (``examples/llm_rollout_torch.py``) at full width,
    its rollout's logp against the plain paths; (c) two ``--mode lm``
    steps of each reduced family with a checkpoint written and read back;
    (d) remat "none" against "full" at full width, and each mode's peak
    memory; (e) 30 updates of the example at hymba-1.5b-reduced (the mean
    token reward logged, no threshold). Returns the ``lm_train`` report."""
    import copy
    import runpy
    import tempfile

    from repro_torch import checkpoint, convert, kernels
    from repro_torch.algos.ppo import PPOConfig, lm_ppo_loss
    from repro_torch.configs import get_config
    from repro_torch.core.sampler import make_lm_rollout
    from repro_torch.envs import lm_env
    from repro_torch.launch import train
    from repro_torch.models import transformer

    report = {"device": smi}
    cfg = get_config(LM_TRAIN_ARCH)
    L = cfg.n_layers

    def resident_mib():
        """MiB this process holds on the card before a measurement (what
        earlier phases keep alive counts in every peak after it)."""
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        return torch.cuda.memory_allocated() / 2 ** 20

    def quiet(fn, *args):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            out = fn(*args)
        for line in buf.getvalue().splitlines():
            log(f"  {line}")
        return out

    # (a) full width: three steps in bfloat16, bfloat16 moments
    label = f"lm train {LM_TRAIN_ARCH} B=2 S=64 x3"
    resident = resident_mib()
    run = counted(label, lambda: quiet(train.main, [
        "--mode", "lm", "--arch", LM_TRAIN_ARCH, "--steps", "3"]
        + LM_TRAIN_ARGS))
    peak = torch.cuda.max_memory_allocated() / 2 ** 20
    assert runs[label] == zero_counts(), runs[label]   # plain paths only
    assert all(math.isfinite(v) for m in run.metrics for v in m.values()), (
        run.metrics)
    # every weight in bfloat16 but the scan's A_log and D (float32 in every
    # dtype, as the reference's), every moment in bfloat16
    assert {n.rsplit(".", 1)[-1] for n, p in run.params.named_parameters()
            if p.dtype != torch.bfloat16} == {"A_log", "D"}
    assert all(m.dtype == torch.bfloat16
               for m in run.opt_state.mu + run.opt_state.nu)
    fresh = transformer.init_params(
        cfg, torch.Generator(device="cuda").manual_seed(0))
    changed = sum(not torch.equal(a, b) for a, b in
                  zip(run.params.parameters(), fresh.parameters()))
    n_params = sum(p.numel() for p in run.params.parameters())
    n_leaves = sum(1 for _ in run.params.parameters())
    # the config's analytic count leaves out the value head (d + 1)
    assert changed > 0 and n_params == cfg.param_count() + cfg.d_model + 1, (
        changed, n_params)
    report["a_full_width"] = {
        "arch": LM_TRAIN_ARCH, "batch": 2, "seq_len": 64,
        "tokens_per_row": 64 + cfg.n_meta_tokens, "params": n_params,
        "leaves_changed": changed, "leaves": n_leaves,
        "loss": [m["loss"] for m in run.metrics],
        "grad_norm": [m["grad_norm"] for m in run.metrics],
        "s_per_step": run.seconds, "s_per_step_2_3": run.seconds[1:],
        "peak_mib": peak, "resident_before_mib": resident,
        "peak_above_resident_mib": peak - resident}
    log(f"lm train (a): {json.dumps(report['a_full_width'])}")
    del run, fresh
    torch.cuda.empty_cache()

    # (b) the LM RL loop at full width, through the kernels
    example = runpy.run_path(str(ROOT / "examples" / "llm_rollout_torch.py"),
                             run_name="llm_rollout_torch")["main"]
    loop_args = [f"--{k.replace('_', '-')}={v}" for k, v in LM_LOOP.items()]
    label = f"lm rl loop {LM_TRAIN_ARCH} 2 x 8 x (8 + 24) x2"
    resident = resident_mib()
    _, params, history = counted(label, lambda: quiet(
        example, ["--arch", LM_TRAIN_ARCH, "--updates", "2"] + loop_args))
    n, b, gen = LM_LOOP["samplers"], LM_LOOP["batch"], LM_LOOP["gen_len"]
    assert runs[label] == zero_counts(
        selective_scan=2 * n * L, flash_attention=2 * n * L,
        decode_attention=2 * n * gen * L, gae=2), runs[label]
    assert all(math.isfinite(v) for h in history for v in h.values())
    gen_ = torch.Generator(device="cuda").manual_seed(21)
    env = lm_env.make(cfg.vocab_size, episode_len=gen, device="cuda")
    prompt = torch.randint(0, cfg.vocab_size, (b, LM_LOOP["prompt_len"]),
                           generator=gen_, device="cuda")
    # bfloat16, the loop's own weights: reported, not bounded
    traj = make_lm_rollout(cfg, env, gen)(params, prompt, generator=gen_)
    dec, fwd = plain_rollout_logps(cfg, params, prompt, traj["tokens"])
    bf16 = {"max_abs_dlogp_vs_decode": max_err(traj["logp"], dec),
            "max_abs_dlogp_vs_forward": max_err(traj["logp"], fwd)}
    # float32: the same weights widened, bounded
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    params32 = transformer.LM(cfg32, device="cuda")
    with torch.no_grad():
        for a, w in zip(params32.parameters(), params.parameters()):
            a.copy_(w)
    del params
    torch.cuda.empty_cache()
    traj = make_lm_rollout(cfg32, env, gen)(params32, prompt,
                                            generator=gen_)
    dec, fwd = plain_rollout_logps(cfg32, params32, prompt, traj["tokens"])
    f32 = {"max_abs_dlogp_vs_decode": max_err(traj["logp"], dec),
           "max_abs_dlogp_vs_forward": max_err(traj["logp"], fwd),
           "bound": LM_LOGP_F32_TOL}
    report["b_rl_loop"] = {
        "updates": history, "bf16": bf16, "f32": f32,
        "collect_s": [h["collect_s"] for h in history],
        "learn_s": [h["learn_s"] for h in history],
        "peak_mib": torch.cuda.max_memory_allocated() / 2 ** 20,
        "resident_before_mib": resident,
        "launches": {k: v for k, v in runs[label].items() if v}}
    log(f"lm train (b): {json.dumps(report['b_rl_loop'])}")
    assert max(f32["max_abs_dlogp_vs_decode"],
               f32["max_abs_dlogp_vs_forward"]) <= LM_LOGP_F32_TOL, f32
    del params32, traj
    torch.cuda.empty_cache()

    # (c) every family: two steps, a checkpoint written and read back
    fams = {}
    with tempfile.TemporaryDirectory() as tmp:
        for arch in LM_FAMILIES:
            label = f"lm train {arch} x2 --ckpt-dir"
            d = os.path.join(tmp, arch)
            run = counted(label, lambda: quiet(train.main, [
                "--mode", "lm", "--arch", arch, "--steps", "2",
                "--ckpt-dir", d]))
            assert runs[label] == zero_counts(), runs[label]
            assert all(math.isfinite(v) for m in run.metrics
                       for v in m.values()), (arch, run.metrics)
            back = convert.lm_params_from_jax(run.cfg, checkpoint.restore(
                d, convert.lm_params_to_jax(run.params)), device="cuda")
            assert all(torch.equal(a, w) for a, w in zip(
                back.parameters(), run.params.parameters())), arch
            meta = checkpoint.load_metadata(d)
            assert meta["mode"] == "lm" and meta["arch"] == arch, meta
            fams[arch] = {"loss": [m["loss"] for m in run.metrics],
                          "aux": [m["aux"] for m in run.metrics],
                          "s_per_step": run.seconds}
    report["c_families"] = fams
    log(f"lm train (c): {json.dumps(fams)}")

    # (d) remat at full width: grads of "none" and "full", peak per mode
    base = transformer.init_params(
        cfg, torch.Generator(device="cuda").manual_seed(5))
    batch = train.lm_batch(cfg, 2, 64,
                           torch.Generator(device="cuda").manual_seed(6))
    plist = list(base.parameters())
    grads, peaks, secs = {}, {}, {}
    for remat in LM_REMATS:
        # "none"'s grads stay alive through the later modes' runs
        resident = resident_mib()
        t0 = time.perf_counter()
        loss, _ = lm_ppo_loss(cfg, base, batch, PPOConfig(), remat=remat)
        g = torch.autograd.grad(loss, plist)
        torch.cuda.synchronize()
        secs[remat] = time.perf_counter() - t0
        peaks[remat] = {"peak": torch.cuda.max_memory_allocated() / 2 ** 20,
                        "resident_before": resident}
        if remat in ("none", "full"):
            grads[remat] = g
        del loss, g
    worst, identical = 0.0, 0
    for a, w in zip(grads["none"], grads["full"]):
        scale = float(a.float().abs().max())
        diff = float((a.float() - w.float()).abs().max())
        identical += torch.equal(a, w)
        worst = max(worst, diff / scale if scale else diff)
    report["d_remat"] = {"peak_mib": peaks, "s_fwd_bwd": secs,
                         "none_vs_full_max_rel_diff": worst,
                         "leaves_bit_identical": identical,
                         "leaves": len(plist), "bound": LM_REMAT_REL_TOL}
    log(f"lm train (d): {json.dumps(report['d_remat'])}")
    assert worst <= LM_REMAT_REL_TOL, worst
    del grads, base, plist, batch
    torch.cuda.empty_cache()

    # (e) a learning observation at hymba-1.5b-reduced: no threshold
    label = "lm rl loop hymba-1.5b-reduced x30"
    _, _, history = counted(label, lambda: quiet(
        example, ["--arch", "hymba-1.5b-reduced", "--updates", "30"]
        + loop_args))
    rew = [h["mean_token_reward"] for h in history]
    assert all(math.isfinite(r) for r in rew)
    report["e_learning"] = {
        "first5_mean": sum(rew[:5]) / 5, "last5_mean": sum(rew[-5:]) / 5,
        "rewards": rew,
        "launches": {k: v for k, v in runs[label].items() if v}}
    log(f"lm train (e): {json.dumps(report['e_learning'])}")
    return report


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument(
        "--timing-only", action="store_true",
        help="build the kernels and run only phase 6, logging every timing "
             "line (the main shapes as kernels_at_main_shapes) with no "
             "checks and no kernels line: for timing two checkouts in turn")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing to check", file=sys.stderr)
        return 1
    from repro_torch import kernels
    from repro_torch.core.backends import InlineBackend
    from repro_torch.experiment import ExperimentSpec, Schedule, run
    from repro_torch.kernels import build
    from repro_torch.kernels.env_step import ops as env_ops
    from repro_torch.kernels.env_step import ref as env_ref
    from repro_torch.kernels.gae import ops as gae_ops
    from repro_torch.kernels.replay_ring import ops as ring_ops
    from repro_torch.kernels.sum_tree import ops as tree_ops
    from repro_torch.kernels.sum_tree.ref import SumTree
    from repro_torch.launch import train

    # 1. device
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    log(f"device: {smi}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # 2. build
    t0 = time.perf_counter()
    secs = build.build_all()
    log(f"build: {time.perf_counter() - t0:.2f} s wall "
        f"({', '.join(f'{k} {v:.2f} s' for k, v in secs.items())})")
    for name in build.SOURCES:
        for line in build.build_log(name).splitlines():
            if "registers" in line or "spill" in line:
                log(f"  ptxas[{name}]: {line.strip()}")
    if args.timing_only:
        launch_floor()
        log_timings(time_kernels(),
                    (("main", "kernels_at_main_shapes"),) + TIMING_LINES)
        print_ok()
        return 0

    # the wall seconds of each phase from here on, printed at the end
    seconds, lap = {}, [time.perf_counter()]

    def phase_done(name):
        now = time.perf_counter()
        seconds[name] = now - lap[0]
        lap[0] = now

    # 3. kernels against their plain versions
    errs = {k: (0, 0.0) for k in kernels.KERNELS}
    horizon = 50
    for name, wrapper in (("pendulum", env_ops.pendulum_step_cuda),
                          ("cheetah", env_ops.cheetah_step_cuda)):
        for B in (16, 4096, 16384):
            state, a, rs, ro, p = env_inputs(name, B, horizon, seed=B)
            params = dict(max_episode_steps=horizon, reward_scale=1.0, **p)
            got = wrapper(state, a, rs, ro, **params)
            want = env_ref.STEP_BATCH_REF[name](state, a, rs, ro, **params)
            torch.cuda.synchronize()
            u, e = compare(f"{name} B={B}", leaves(got), leaves(want),
                           ENV_ULPS)
            key = f"{name}_step"
            errs[key] = (max(errs[key][0], u), max(errs[key][1], e))
            done = got[3]
            assert int(done.sum()) >= B // 3, "reset select did not fire"
            log(f"check {key} B={B}: max {u} ulp, max abs err {e:.3g}, "
                f"{int(done.sum())} resets")
    for B in (1, 16, 700, 4096):
        state, a, rs, ro, p = env_inputs("cartpole", B, horizon, seed=B + 1)
        params = dict(max_episode_steps=horizon, reward_scale=0.5, **p)
        got = env_ops.cartpole_step_cuda(state, a, rs, ro, **params)
        want = env_ref.cartpole_step_batch_ref(state, a, rs, ro, **params)
        torch.cuda.synchronize()
        u, e = compare(f"cartpole B={B}", leaves(got), leaves(want),
                       ENV_ULPS)
        key = "cartpole_step"
        errs[key] = (max(errs[key][0], u), max(errs[key][1], e))
        done = got[3]
        fell = int((done & (state[4] + 1 < horizon)).sum())
        assert int(done.sum()) >= B // 3 and (B < 16 or fell > 0), (
            "cart-pole: no reset or no fall")
        log(f"check {key} B={B}: max {u} ulp, max abs err {e:.3g}, "
            f"{int(done.sum())} resets ({fell} falls)")
    for T, B in ((125, 160), (128, 4096), (125, 160 + 3)):
        r, v, d, lv = gae_inputs(T, B, seed=T * B)
        got = gae_ops.gae_cuda(r, v, d, lv, gamma=0.99, lam=0.95)
        want = gae_ops.gae_ref(r, v, d, lv, 0.99, 0.95)
        torch.cuda.synchronize()
        u, e = compare(f"gae {T}x{B}", got, want, 0)
        errs["gae"] = (max(errs["gae"][0], u), max(errs["gae"][1], e))
        log(f"check gae T={T} B={B}: exact (max {u} ulp)")
    check_rl_edges()
    for T, B in ((1, 1), (125, 160), (128, 4096), (125, 160 + 3), (0, 5)):
        r, _, d, lv = gae_inputs(T, B, seed=T * B + 1)
        got = gae_ops.discounted_returns_cuda(r, d, lv, gamma=0.99)
        want = gae_ops.discounted_returns_ref(r, d, lv, 0.99)
        torch.cuda.synchronize()
        u, e = compare(f"discounted_returns {T}x{B}", [got], [want], 0)
        key = "discounted_returns"
        errs[key] = (max(errs[key][0], u), max(errs[key][1], e))
        log(f"check {key} T={T} B={B}: exact (max {u} ulp)")

    gen = torch.Generator(device="cuda").manual_seed(0)

    def exact(name, got, want):
        for k in want:
            assert got[k].dtype == want[k].dtype and torch.equal(
                got[k], want[k]), f"{name}: leaf {k} differs"

    # odd heads: the 56-byte rows' source and destination differ mod 16,
    # the 3-byte and 10-byte rows' mod 4
    for cap, n, start in ((17, 5, 15), (12, 12, 7), (8, 11, 3), (1, 1, 0),
                          (1, 3, 0), (CAP, 20000, CAP - 7000),
                          (CAP, 20000, CAP - 7001), (4099, 3000, 1001)):
        for kinds in (MIXED_LEAVES, None):
            storage = ring_leaves(cap, gen, kinds)
            batch = ring_leaves(n, gen, kinds)
            want = ring_ops.ring_insert_ref(
                {k: v.clone() for k, v in storage.items()}, batch, start)
            got = ring_ops.ring_insert(storage, batch, start, impl="cuda")
            torch.cuda.synchronize()
            exact(f"ring_insert cap={cap} n={n}", got, want)
        log(f"check ring_insert cap={cap} N={n} start={start}: exact")
    for cap, B in ((17, 6), (1, 1), (CAP, 256)):
        storage = ring_leaves(cap, gen, MIXED_LEAVES)
        idx = torch.randint(0, cap, (B,), generator=gen, device="cuda",
                            dtype=torch.int32)
        idx[0] = cap + 5 if B > 1 else idx[0]    # clamped into the ring
        if B > 1:
            idx[1] = -1                          # counts from the end
        got = ring_ops.ring_gather(storage, idx, impl="cuda")
        want = ring_ops.ring_gather_ref(storage, idx)
        torch.cuda.synchronize()
        exact(f"ring_gather cap={cap} B={B}", got, want)
        log(f"check ring_gather cap={cap} B={B}: exact")
    for cap in (1, 2, 1024, CAP):
        tree = random_tree(cap, min(cap, 60000), gen)
        masses = stratified_masses(tree, 256, gen)
        masses[:2] = torch.stack([torch.zeros((), device="cuda"),
                                  tree.total])
        got = tree_ops.sumtree_find_batch(tree, masses, impl="cuda")
        want = tree_ops.sumtree_find_batch_ref(tree, masses)
        torch.cuda.synchronize()
        assert torch.equal(got, want), f"sumtree_find cap={cap} differs"
        for B, consecutive in ((256, False), (20000, True)):
            if consecutive:
                idx = (torch.arange(B, device="cuda") + cap // 3) % cap
            else:
                idx = torch.randint(0, cap, (B,), generator=gen,
                                    device="cuda")
                idx[-B // 4:] = idx[0]           # duplicates: last one wins
                # one from the end, its twin, and two that are dropped
                idx[1:5] = torch.tensor([-1, cap - 1, cap, -cap - 1])
            idx = idx.to(torch.int32)
            vals = torch.rand(B, generator=gen, device="cuda")
            want = SumTree.of(tree.flat.clone())
            tree_ops.sumtree_update_ref(want, idx, vals)
            tree_ops.sumtree_update(tree, idx, vals, impl="cuda")
            torch.cuda.synchronize()
            assert torch.equal(tree.flat, want.flat), (
                f"sumtree_update cap={cap} B={B} differs")
            assert bool((tree.winner == -1).all()), "scratch not reset"
        log(f"check sumtree_find/sumtree_update cap={cap}: exact")
    check_lm_kernels(errs, gen)

    phase_done("kernels")

    # 4. main path
    runs = {}

    def counted(label, fn):
        kernels.reset_launch_counts()
        out = fn()
        torch.cuda.synchronize()
        runs[label] = kernels.launch_counts()
        log(f"main path [{label}]: launches {runs[label]}")
        return out

    def cli(argv):
        """The train CLI's printed logs (and its result, kept in
        ``cli.result``)."""
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            cli.result = train.main(argv)
        return [json.loads(line) for line in buf.getvalue().splitlines()]

    def check_logs(label, logs, iters, samples):
        assert len(logs) == iters, f"{label}: {len(logs)} logs"
        for lg in logs:
            lg = lg if isinstance(lg, dict) else lg.as_dict()
            assert lg["samples"] == samples, f"{label}: {lg}"
            for k in ("mean_return", "collect_time", "learn_time"):
                assert math.isfinite(lg[k]), f"{label}: {k} {lg}"
            log(f"  {label} it {lg['iteration']}: "
                f"mean_return {lg['mean_return']:.4f} "
                f"collect {lg['collect_time']:.3f} s "
                f"(serial {lg['collect_time_serial']:.3f} s) "
                f"learn {lg['learn_time']:.3f} s samples {lg['samples']}")

    def zero_counts(**nonzero):
        """Launch counts: ``nonzero`` as given, every other kernel 0."""
        return {**{k: 0 for k in kernels.KERNELS}, **nonzero}

    # the learning check first: PPO pendulum through the kernels
    learning_run(counted, runs, zero_counts)

    phase_done("learning")

    n, per, h = MAIN_SAMPLERS
    with recording(InlineBackend) as trajs:
        logs = counted("cheetah N=10", lambda: cli(
            ["--mode", "rl", "--env", "cheetah", "--algo", "ppo",
             "--num-samplers", str(n), "--global-batch", str(n * per),
             "--horizon", str(h), "--iterations", "3"]))
    ppo_inline = snapshot_run("cheetah N=10", cli.result, trajs)
    check_logs("cheetah N=10", logs, 3, n * per * h)
    inline_s = [w + lg["learn_time"] for w, lg in zip(trajs.walls, logs)][1:]
    assert runs["cheetah N=10"] == zero_counts(cheetah_step=3 * n * h,
                                               gae=3)

    vec = counted("cheetah vector B=4096", lambda: run(ExperimentSpec(
        env="cheetah", algo="ppo", schedule=Schedule(
            env_batch=4096, horizon=128, iterations=3))))
    check_logs("cheetah vector", vec.logs, 3, 4096 * 128)
    assert runs["cheetah vector B=4096"] == zero_counts(
        cheetah_step=3 * 128, gae=3)

    pend = counted("pendulum N=10", lambda: run(ExperimentSpec(
        env="pendulum", algo="ppo", schedule=Schedule(
            num_samplers=n, global_batch=n * per, horizon=h,
            iterations=2))))
    check_logs("pendulum N=10", pend.logs, 2, n * per * h)
    assert runs["pendulum N=10"] == zero_counts(pendulum_step=2 * n * h,
                                                gae=2)
    for res in (vec, pend):
        for p in res.params.parameters():
            assert torch.isfinite(p).all(), "non-finite weights"

    updates, n_leaves = 4, len(CHEETAH_LEAVES)
    with recording(InlineBackend) as trajs:
        logs = counted("sac cheetah N=10 prioritized", lambda: cli(
            ["--env", "cheetah", "--algo", "sac", "--buffer", "prioritized",
             "--num-samplers", str(n), "--global-batch", str(n * per),
             "--horizon", str(h), "--iterations", "3",
             "--replay-capacity", "1000000", "--replay-batch", "256"]))
    sac_inline = snapshot_run("sac cheetah N=10 prioritized", cli.result,
                              trajs, plane=True)
    check_logs("sac cheetah N=10 prioritized", logs, 3, n * per * h)
    assert runs["sac cheetah N=10 prioritized"] == zero_counts(
        cheetah_step=3 * n * h, ring_insert=3,
        ring_gather=3 * updates, sumtree_find=3 * updates,
        sumtree_update=3 * (1 + updates)), runs
    ring, tree, max_p = cli.result.runner.plane_state[0]
    assert tree.capacity == CAP and int(ring.size) == 3 * n * per * h
    assert int((tree.levels[0] > 0).sum()) == int(ring.size)
    total = float(tree.total)
    assert math.isclose(total, float(tree.levels[0].double().sum()),
                        rel_tol=1e-4), total
    assert math.isfinite(float(max_p)) and float(max_p) >= 1.0
    log(f"  sac prioritized: ring {int(ring.size)} of {CAP}, tree total "
        f"{total:.6g}, max priority {float(max_p):.6g}")
    sac_runs = [cli.result]

    sac_pend = counted("sac pendulum N=10 uniform", lambda: run(
        ExperimentSpec(env="pendulum", algo="sac", buffer="uniform",
                       buffer_kwargs={"capacity": 1_000_000,
                                      "batch_size": 256},
                       schedule=Schedule(num_samplers=n,
                                         global_batch=n * per, horizon=h,
                                         iterations=2))))
    check_logs("sac pendulum N=10 uniform", sac_pend.logs, 2, n * per * h)
    assert sac_pend.logs[-1].mean_return != 0.0, "no pendulum episode ended"
    assert runs["sac pendulum N=10 uniform"] == zero_counts(
        pendulum_step=2 * n * h, ring_insert=2,
        ring_gather=2 * updates), runs
    sac_runs.append(sac_pend)
    for res in sac_runs:
        for p in res.params.parameters():
            assert torch.isfinite(p).all(), "non-finite SAC weights"

    # slice 3: cart-pole, TRPO and DDPG through the train CLI
    def finite_params(label):
        for p in cli.result.params.parameters():
            assert torch.isfinite(p).all(), f"{label}: non-finite weights"

    label = "ppo cartpole N=10"
    logs = counted(label, lambda: cli(
        ["--env", "cartpole", "--algo", "ppo", "--num-samplers", str(n),
         "--global-batch", str(n * per), "--horizon", str(h),
         "--iterations", "3"]))
    check_logs(label, logs, 3, n * per * h)
    assert all(lg["mean_return"] > 0.0 for lg in logs), "no pole fell"
    assert runs[label] == zero_counts(cartpole_step=3 * n * h, gae=3), runs
    finite_params(label)

    label = "ppo cartpole vector B=4096"
    logs = counted(label, lambda: cli(
        ["--env", "cartpole", "--algo", "ppo", "--env-batch", "4096",
         "--horizon", "128", "--iterations", "2"]))
    check_logs(label, logs, 2, 4096 * 128)
    assert all(lg["mean_return"] > 0.0 for lg in logs), "no pole fell"
    assert runs[label] == zero_counts(cartpole_step=2 * 128, gae=2), runs
    finite_params(label)

    label = "trpo cheetah N=10"
    logs = counted(label, lambda: cli(
        ["--env", "cheetah", "--algo", "trpo", "--num-samplers", str(n),
         "--global-batch", str(n * per), "--horizon", str(h),
         "--iterations", "3"]))
    check_logs(label, logs, 3, n * per * h)
    assert runs[label] == zero_counts(cheetah_step=3 * n * h, gae=3), runs
    assert cli.result.runner.opt_state is None
    finite_params(label)

    label = "ddpg cheetah N=10 prioritized"
    logs = counted(label, lambda: cli(
        ["--env", "cheetah", "--algo", "ddpg", "--buffer", "prioritized",
         "--num-samplers", str(n), "--global-batch", str(n * per),
         "--horizon", str(h), "--iterations", "3",
         "--replay-capacity", "1000000", "--replay-batch", "256"]))
    check_logs(label, logs, 3, n * per * h)
    assert runs[label] == zero_counts(
        cheetah_step=3 * n * h, ring_insert=3,
        ring_gather=3 * updates, sumtree_find=3 * updates,
        sumtree_update=3 * (1 + updates)), runs
    ring, tree, max_p = cli.result.runner.plane_state[0]
    assert tree.capacity == CAP and int(ring.size) == 3 * n * per * h
    assert int((tree.levels[0] > 0).sum()) == int(ring.size)
    assert math.isclose(float(tree.total),
                        float(tree.levels[0].double().sum()), rel_tol=1e-4)
    assert math.isfinite(float(max_p)) and float(max_p) >= 1.0
    finite_params(label)
    ddpg_params = [p.detach().clone() for p in cli.result.params.parameters()]
    log(f"  ddpg prioritized: ring {int(ring.size)} of {CAP}, tree total "
        f"{float(tree.total):.6g}, max priority {float(max_p):.6g}")

    phase_done("main path: ppo, sac, cart-pole, trpo, ddpg")

    # slice 17: the data-parallel learner
    learner_report = learner_runs(cli, counted, runs, check_logs,
                                  zero_counts, smi, ppo_inline, sac_inline,
                                  ddpg_params)
    del ddpg_params

    phase_done("learner")

    # slice 18: FSDP, learner pods, the sharded backend, overlap on a mesh
    sharding_report = sharding_runs(cli, counted, runs, check_logs,
                                    zero_counts, smi, sac_inline)

    phase_done("sharding")

    # slice 14: half-precision obs and rewards through the env-step kernels
    dtype_runs(counted, runs, check_logs, zero_counts)

    phase_done("env dtypes")

    # slice 9: the actor plane
    actor_report = actor_plane_runs(cli, counted, runs, check_logs,
                                    zero_counts, ppo_inline, sac_inline)
    del ppo_inline, sac_inline

    phase_done("actor plane")

    # slice 10: the fused runtime
    fused_report = fused_runs(
        counted, runs, check_logs, zero_counts, smi,
        {"inline_n10_s_per_iteration": inline_s,
         "process_n10_s_per_iteration":
             actor_report["ppo cheetah N=10 process"]["s_per_iteration"]},
        vec)
    del vec

    phase_done("fused runtime")

    # slice 11: the overlap schedule
    overlap_report = overlap_runs(
        cli, counted, runs, check_logs, zero_counts, smi,
        {"inline_n10": inline_s,
         "process_n10":
             actor_report["ppo cheetah N=10 process"]["s_per_iteration"]})

    phase_done("overlap")

    # slice 15: train -> checkpoint -> serve
    serving_report = serving_runs(cli, counted, runs, zero_counts, smi)

    phase_done("serving")

    # slice 4: LM serving, hymba-1.5b and falcon-mamba-7b
    run_a = lm_serve_runs(counted, runs, zero_counts)

    phase_done("lm serving")

    # slice 16: LM training
    lm_train_report = lm_train_runs(counted, runs, zero_counts, smi)

    phase_done("lm train")

    # 5. reference: kernels vs plain versions end to end on small runs
    def cuda_vs_ref(label, spec, plane=lambda res: []):
        """Run ``spec`` with the kernels and with the plain versions; the
        kernels must have launched only in the first, episodes must have
        ended in every iteration, and the final weights (and
        ``plane(result)``'s tensors) must be bit for bit equal."""
        finals = {}
        for mode in ("cuda", "ref"):
            kernels.reset_launch_counts()
            res = run(dataclasses.replace(spec, kernels=mode))
            torch.cuda.synchronize()
            counts = kernels.launch_counts()
            assert (sum(counts.values()) > 0) == (mode == "cuda"), counts
            finals[mode] = ([p.detach().clone()
                             for p in res.params.parameters()]
                            + [x.clone() for x in plane(res)],
                            [lg.mean_return for lg in res.logs])
        (got, got_ret), (want, want_ret) = finals["cuda"], finals["ref"]
        assert got_ret == want_ret and all(r != 0.0 for r in got_ret), (
            label, got_ret, want_ret)
        assert all(torch.equal(a, b) for a, b in zip(got, want)), (
            f"{label}: cuda vs ref differ")
        log(f"reference: {label}, cuda vs ref kernels: {len(got)} tensors "
            f"bit for bit equal, mean returns {got_ret}")

    def replay_plane(res):
        return replay_tensors(res.runner)

    small = Schedule(num_samplers=2, global_batch=8, horizon=40,
                     iterations=2)
    cuda_vs_ref("PPO cheetah", ExperimentSpec(
        env="cheetah", algo="ppo", env_kwargs={"max_episode_steps": 25},
        schedule=small))
    cuda_vs_ref("SAC prioritized cheetah", ExperimentSpec(
        env="cheetah", algo="sac", buffer="prioritized",
        buffer_kwargs={"capacity": 4096, "batch_size": 64},
        env_kwargs={"max_episode_steps": 25}, schedule=small), replay_plane)
    cuda_vs_ref("TRPO cartpole", ExperimentSpec(
        env="cartpole", algo="trpo", schedule=Schedule(
            num_samplers=2, global_batch=16, horizon=60, iterations=2)))
    cuda_vs_ref("DDPG prioritized pendulum", ExperimentSpec(
        env="pendulum", algo="ddpg", buffer="prioritized",
        buffer_kwargs={"capacity": 4096, "batch_size": 64},
        env_kwargs={"max_episode_steps": 25}, schedule=small), replay_plane)
    lm_report = lm_cuda_vs_ref(run_a)
    del run_a

    phase_done("reference")
    floor_ms = launch_floor()
    timings = time_kernels()
    log_find_floor(floor_ms, timings["main", "sumtree_find"], 256)
    log_host_parts()
    entries = []
    for name in kernels.KERNELS:
        entries.append({
            "name": name, "route": "cuda", "source": SOURCES[name],
            "replaces": REPLACES[name],
            "launches": sum(c[name] for c in runs.values()),
            "max_abs_err": errs[name][1], "max_ulp": errs[name][0],
            **timings["main", name]})
    log_timings(timings, TIMING_LINES)
    log(json.dumps({"lm_cuda_vs_ref": lm_report}))
    log(json.dumps({"actor_plane": actor_report}))
    log(json.dumps({"fused": fused_report}))
    log(json.dumps({"overlap": overlap_report}))
    log(json.dumps({"serving": serving_report}))
    log(json.dumps({"lm_train": lm_train_report}))
    log(json.dumps({"learner": learner_report}))
    log(json.dumps({"sharding": sharding_report}))
    log(json.dumps({"launches_by_run": runs}))
    phase_done("timings")
    log(json.dumps({"phase_seconds": seconds}))
    print(json.dumps({"kernels": entries}), flush=True)
    print_ok()
    return 0


def print_ok() -> None:
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    sys.exit(main())
