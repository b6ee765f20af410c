#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one NVIDIA GPU and check it.

    python3 chip_smoke.py
    python3 chip_smoke.py --host-cost   # phase 12's launch-path times only
    python3 chip_smoke.py --ssm         # paths K and L1 and their profile
    python3 chip_smoke.py --busy C      # serving's busy shares, eager and
                                        # through CUDA graphs (C, K or L1)
    python3 chip_smoke.py --chunks      # chunked groups against one launch

Run from the root of a checkout, on a machine with one CUDA card and the
CUDA toolkit (nvcc). Every ``Server`` and ``ServingEngine`` serves
through CUDA graphs (``repro_torch/graphs.py``), and the launch counts
count what ran on the card, replays included. Every C step runs through
the group planner (``planner="on"``, ``repro_torch/analysis/cost.py``).
Phases, each of which fails the run:

1. header: the card's name and power limit (nvidia-smi), torch and CUDA;
2. build: compile every CUDA source of the main path (``build.SOURCES``
   in ``src/repro_torch/kernels/csrc``; one nvcc process each, all
   started together);
3. K1 and K2 (single passes) against their plain PyTorch versions on
   the card, at the main path's shapes, timed with CUDA events beside
   their bounds; then the fused Lloyd loop (K1's source) and the fused
   top-κ bisection (K2's source) at the main paths' shapes, each
   bit-identical to the loop of single K1/K2 launches plus the torch
   update and to its plain loop (codebooks within 1e-3, assignments,
   thresholds, counts and masks equal; the w_down bisection must
   compact), also with mixed K (+inf tails), more items than the loop's
   grid has blocks, and heavily tied magnitudes, timed beside the
   iterated loop, the plain loop, the bound and the design's floor;
4. main path A — the quickstart (``repro_torch.quickstart.main``):
   LeNet300, per-layer K=4 quantization, 20 LC steps × 40 SGD steps;
   LC ≤ DC and exactly 20 × 3 fused Lloyd loop launches; then one C step
   from the final state with the planner on and off (``planner_on_off``:
   Θ and Δ(Θ) bit for bit, the same launches);
5. main path B — ℓ0 pruning of all LeNet300 weights at κ = 5% (13,310):
   exactly κ nonzeros after every C step, the §7 monitor, 20 fused
   bisections and 20 K3 launches; planner on against off as in A;
6. the C step at LM width: phi3-mini-3.8b's FFN stacks (d_model 3072,
   d_ff 8192) with 4 of its 32 layers; K=16 quantization of w_gate|w_up
   (one group of 8 items × 25,165,824 weights) and ℓ0 pruning at 5% per
   item of w_down; init, then 2 × (C step + multiplier step), each C
   step beside one with the planner off; then the k-means group and the
   top-κ task each captured as a CUDA graph (``compile_group``) and held
   to the eager solve at two μ (``captured_against_eager``: Θ and Δ(Θ)
   bit for bit, one capture then cache hits, eager and replay seconds);
7. K4, K5 and K6 (the serving kernels) against their plain versions on
   the card at the serving paths' shapes (paths I, J, K and L1's too: K6 at
   MLA's qk 96 / v 64 and at mixtral's 4096 window over 4608 tokens),
   timed beside their bounds, the plain versions, and a PyTorch
   yardstick (SDPA for K6, the window as a mask; for K4/K5
   ``torch.matmul`` by the already-densified weight, what the
   uncompressed model pays);
8. main path C — compressed serving of phi3-mini-3.8b at full width
   (4 of 32 layers, float32, fused attention): random weights, 12
   per-layer LC tasks (4-bit k=16 on w_gate|w_up, 8-bit k=64 on
   wq|wk|wv|wo, ℓ0 at 2% on w_down), LC init and one C step (K1, K2),
   the bridge into serving forms, ``Server.generate`` of 32 tokens for
   2 prompts of 512; exact launch counts (one fused Lloyd loop a k-means
   group, one fused bisection); logits against the densified
   model (cuBLAS, TF32 off), fused attention (K6) against the plain loop;
   then ``Server.generate`` through CUDA graphs against the same
   programs run eagerly (``server_against_eager``: greedy tokens equal,
   the logits' max|Δ|, prefill and decode ms and tokens/s of each, in
   turns, the capture's seconds and graph-pool bytes);
9. main path D — ``ServingEngine`` (8 slots) on the same compressed
   model: 24 Poisson requests of mixed lengths; then the engine through
   CUDA graphs against the eager programs on a short trace
   (``engine_against_eager``: every request's tokens equal, each mode's
   tokens/s, p50/p99 latency and TTFT, in turns);
10. K3, K7, K8 and K9 (the threshold masks and the single-vector count
    and k-means kernels) against their plain versions on the card,
    timed beside their bounds;
11. main path E — mixed compression of LeNet300
    (``repro_torch.mixed_compression.main``): the paper's Table 2 last
    row (ℓ0 on l0, rank-10 low rank on l1, 1-bit quantization on l2) and
    row 5 (additive ℓ0 + quantization over all weights), 20 LC steps
    each; exact κ, rank-10 factors, the §7 monitor and exact launches
    after every C step (one fused Lloyd loop, one fused bisection, one
    K3); LC and DC test errors beside the JAX
    package's CPU result on its own problem (its data and reference
    weights come from JAX's generator; both packages on one problem are
    compared in ``tests/test_torch_mixed.py``);
12. main path G — the kernel API (``repro_torch.kernels.kmeans.kmeans``
    and ``repro_torch.kernels.prune.topk_mask``, the single-vector
    solvers: one fused loop each at I = 1, then K9) on path E's trained
    LeNet300, and the single passes K7, K1, K8 and K2 on their results;
    then the host time to queue 1,000 launches each of K1, K7, K2 and K8
    at those shapes without a sync (the launch path's cost);
13. main path F — low-rank serving of phi3-mini-3.8b at full width (4 of
    32 layers): 28 per-matrix tasks (LowRank on wq|wk|wv, w_gate, w_up;
    RankSelection with two α on wo; additive ℓ0 + quantization on
    w_down) in four groups, LC init, one C step, a multiplier step, the
    bridge (24 low-rank and 4 dense forms) and ``Server.generate``;
    selected ranks against the exact spectrum, distortion against the
    exact SVD, logits against the densified model, 4 K6 launches; then
    each group re-run alone with the planner off and on (bit for bit),
    and each low-rank group captured (``compile_group``, the Jacobi
    rounds in one CUDA graph) against its eager runs at two μ;
14. main path H — LC training of phi3-mini-3.8b at full width (4 of 32
    layers, float32, remat, plain attention) with ``LCTrainer``: AdamW L
    steps on the port's ``TokenStream`` (8 × 1024 tokens a step), the
    tasks and defaults of ``launch/train.py``. H1: per-layer K=16
    quantization of every matrix (28 items in two groups), 3 μ × 5 L
    steps, serial; H2: the same overlapped (C step on a second stream),
    its first boundary's Θ equal bit for bit to a serial C step on the
    same snapshot; H3: ℓ0 pruning of all matrices at κ = 5%, 2 × 2,
    exactly κ nonzeros after every C step; H4 (1 layer): a hard failure
    that outlasts the retries, restored from a checkpoint, ending equal
    bit for bit to an uninterrupted run, and a mid-run checkpoint
    restored onto the card. Each run checks its records (§7 monitor,
    finite losses, the reference's compression ratio, CE falling) and
    its exact launches (H1/H2 one fused Lloyd loop a group every C step,
    H3 one bisection and one K3 each), and prints the
    train step's median time (CUDA events), tokens/s, C-step ms (serial)
    or dispatch→ready ms (overlap), LC wall time and peak memory;
15. main paths I and J — MoE and MLA serving at the published widths
    (float32, fused attention, random weights, depth cut; each: LC init
    and one C step, the bridge, ``Server.generate`` of 32 tokens for 2
    prompts, logits against the densified model, greedy agreement 1.0,
    fused attention against the plain loop, exact launch counts, peak
    memory). I1: mixtral-8x7b, 2 of 32 layers, 4-bit on all 6 expert
    stacks (w_gate, w_up and w_down of both layers: one group of 6 items
    of 469,762,048, which the planner splits into chunks that fit a
    quarter of the card's memory, one fused Lloyd loop a chunk, each
    held against the iterated and plain loops in its group's partition;
    the plan and the peak memory printed), 8-bit attention, prompts of
    4608 past the 4096 window (K6 masks real keys, the ring buffer
    wraps). I2: deepseek-moe-16b, its dense lead layer
    and 3 MoE layers, ℓ0 at 5% on the 3 w_down expert stacks as one
    vector of 553,648,128 (the bisection and K3 held against their
    plain versions, exactly κ nonzeros, Θ the exact top-κ), 4-bit lead
    FFN and shared experts (K4), 8-bit attention (K5), prompts of 512,
    then a ``ServingEngine`` trace (8 slots, 16 requests) whose MoE
    decode routes at capacity 1. J: minicpm3-4b, 4 of 62 layers, 8-bit
    MLA projections, 4-bit FFN, K6 at qk 96 / v 64, prompts of 512,
    then a short ``ServingEngine`` trace over the latent cache;
16. main paths K, L1 and L2 — the recurrent mixers at the published
    widths (float32, random weights). K: jamba-v0.1-52b, layers 2–4 of
    its 8-layer super-block (Mamba + dense FFN, Mamba + MoE, attention +
    dense FFN; 3,960,418,304 params), 4-bit in_proj|out_proj and
    w_gate|w_up, 8-bit x_proj|dt_proj and attention, ℓ0 at 5% on both
    w_down as one vector; L1: xlstm-125m, all 12 blocks (10 mLSTM, 2
    sLSTM), 4-bit wq|wk|wv|up_proj|down_proj|w. Each: LC init and one C
    step, the bridge, ``Server.generate`` of 32 tokens for 2 prompts of
    1024, logits against the densified model, greedy agreement 1.0,
    exact launches, every Lloyd loop of the C step held against the
    iterated and plain loops (K: the bisection and K3 too, exactly κ
    nonzeros), the prefill's last logits against token-by-token decode
    from an empty cache on 2 prompts of two scan chunks (K 2 × 256 at
    the no-drop MoE capacity 8.0, L1 2 × 512), then a ``ServingEngine``
    trace (8 slots, 16 requests; L1 also prints each request's
    agreement with its own single-slot decode), and K and L1 compare
    graphs with the eager programs as C and D do. Every engine trace (D,
    I2, J, K, L1) holds each re-admitted slot's cache to
    ``init_cache``'s values right after its reset. K and L1 run last, in
    a process of their own (``--ssm``), with phase 17's profile of their
    served models. L2: LC training of xlstm-125m
    (``train_lm_compress.make_trainer``, 4 × 1024 tokens a step, 2 μ × 3
    L steps): finite losses, CE falling, the §7 monitor, the reference's
    compression ratio, one fused Lloyd loop a k-means group each C step,
    the groups derived from the widths, the last C step's loops held
    against the iterated and plain loops; the train step's ms,
    tokens/s, C-step ms, peak memory;
17. ``torch.profiler`` over one more LM C step, path C's prefill and 8
    decode steps: the device's busy share, the kernels that took the
    most time and the K4/K5 kernels' sum; last, for C, K and L1 each in
    a process of its own (``--busy``), the busy share of 8 steps of
    ``Server``'s decode program and of an engine's short trace, through
    CUDA graphs and eagerly (``serving_busy``); then (in the ``--ssm``
    process) one session over paths K and L1's prefills and 8 decode
    steps each, with the device time of the selective scan's chunks, the
    mLSTM chunks and the sLSTM steps; the device time of K9 and
    ``F.hardshrink`` at P = 266,200, and of K6 and SDPA at K6's main
    row, summed over 50 calls each, beside their event times from
    phases 7 and 10; and K4's
    and K5's device time at decode (M = 2, 8) and prefill over 50 calls
    with the weight rotated over copies past the 50 MB L2, beside the
    bytes bound and the event time; the same cold-L2 device time for
    K1, K2, K3, K7 and K8 and the two fused loops at their main paths'
    shapes; last, path H's trainer (one L step and boundary serial,
    two overlapped): the device's busy share, each stream's busy time
    and the time both streams ran at once;
18. in a process of its own (``--chunks``), after paths K and L1: I1's
    former 4 expert items (4 × 469,762,048) with ``CHUNK_BUDGET_BYTES``
    forced to 4 launches against one launch, Θ and Δ(Θ) bit for bit; the
    Lloyd loop over them timed in one launch, in 2 chunks in the group's
    partition (what the planner runs) and in 2 chunks in their own; a
    top-κ group chunked against one launch, and a low-rank group, which
    the planner keeps in one launch (its batched products' bits depend
    on the batch: the gap of 4 launches forced past the planner is
    printed);
19. one JSON line listing every ported kernel, then the result line.

Tolerances: assignments, masks and integer counts must be equal; K1/K7
cluster sums may differ from the plain version's by the summation order
(``rtol 1e-5, atol 1e-2``), and the fused Lloyd loop's codebooks from
the plain loop's by 1e-3 (``KMEANS_CB_ATOL`` of the CPU tests), its
assignment equal to the plain pass over its own codebooks, while the
fused loops equal the iterated single launches bit for bit; the §7
monitor allows the reference's float slack (``after ≤ before·(1 +
1e-5) + 1e-6``); K4/K5 ``rtol 1e-5, atol 1e-4`` and K6 ``rtol 2e-4,
atol 2e-4`` (as ``tests/test_kernels.py``);
served logits within ``1e-3·max|logit|`` of the densified model's;
low-rank Θ distortion within ``1e-4`` relative of the exact SVD's
(``tests/test_lowrank_dispatch.py``).

Bounds use the H100 SXM's published rates, which assume a 700 W power
limit: 3.35 TB/s of device memory; 67 TFLOP/s f32 outside the tensor
cores for K1–K3 and K7–K9 and the fused loops, each bound being the
function's, not a design's: K1, K7 and the Lloyd loop read w once and
write the assignment once (8 B an element) and need at least one
comparison to place an element and two adds for its moments a step (3
operations an element for a single pass, 3·iters + 1 for the loop); K2,
K8 and the bisection read w once (4 B an element) against one compare an
element. Beside each fused loop's bound, its design's floor (its passes
× bytes) is printed and labelled as the design's. For the products that
the tensor cores can run at f32 accuracy as TF32 with a 3-pass split,
495 TFLOP/s (TF32 dense) for three times the operations, the faster of
the two rates: 3 · 2·(D + Dv) per (query, key) pair kept for K6, 3 · 2·M·K·N
for K4/K5 at every M, whichever kernel (decode GEMV or tensor-core
prefill) runs.
"""
from __future__ import annotations

import contextlib
import gc
import importlib
import json
import math
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
TF32_OPS_PER_S = 495e12

QUICKSTART_SHAPES = [(1, 235_200, 4), (1, 30_000, 4), (1, 1_000, 4)]
LM_D_MODEL, LM_D_FF, LM_LAYERS = 3072, 8192, 4
LM_ITEM = LM_D_MODEL * LM_D_FF                       # 25,165,824
LM_K1_SHAPE = (2 * LM_LAYERS, LM_ITEM, 16)
MIXED_K = (3, 100_003, 16, [16, 5, 9])               # +inf codebook tails
# K2 on the main path: all LeNet300 weights as one item, w_down's 4
# items; checked and timed on K1's shapes too
K2_SHAPES = [(i, p) for i, p, _ in QUICKSTART_SHAPES] + [
    (1, 266_200), LM_K1_SHAPE[:2], MIXED_K[:2], (LM_LAYERS, LM_ITEM)]

# serving (main paths C and D): decode M = 2 (Server) and 8 (engine
# slots), the engine's prefill tick M = 8 slots × 32, prefill M = 2 × 512
SERVE_BATCH, SERVE_PROMPT, SERVE_GEN = 2, 512, 32
SERVE_MAX_LEN = SERVE_PROMPT + SERVE_GEN
SERVE_M = (2, 8, 8 * 32, SERVE_BATCH * SERVE_PROMPT)
W_DOWN_KAPPA = 503_316                     # 2% of 25,165,824
# (M, K, N, C); the JSON line reports the prefill row
K4_SHAPES = [(m, k, n, 16) for m in SERVE_M
             for k, n in ((3072, 8192), (8192, 3072))] + [
    (5, 33, 24, 4), (5, 33, 24, 16), (17, 300, 129, 4), (17, 300, 129, 16)]
K5_SHAPES = [(m, 3072, 3072, 64) for m in SERVE_M] + [(17, 300, 129, 8)]
# paths I and J's products: 4-bit deepseek lead FFN (2048 × 10944) and
# shared experts (2048 × 2816), minicpm3 FFN (2560 × 6400) at SERVE_M;
# 8-bit mixtral attention (4096 × 4096, 4096 × 1024) at prefill (M = 2 ×
# 4608) and decode (M = 2; path I1 runs no engine), deepseek attention
# (2048²) and minicpm3's MLA projections (wdq 2560 × 768, wuq 768 × 3840,
# wdkv 2560 × 288, wo 2560²) at SERVE_M
K4_SHAPES += [(m, k, n, 16) for m in SERVE_M
              for k, n in ((2048, 2816), (2816, 2048), (2560, 6400),
                           (6400, 2560), (2048, 10944), (10944, 2048))]
K5_SHAPES += [(9216, 4096, 4096, 64), (9216, 4096, 1024, 64),
              (2, 4096, 4096, 64), (2, 4096, 1024, 64)] + [
    (m, k, n, 64) for m in SERVE_M
    for k, n in ((2048, 2048), (2560, 768), (768, 3840), (2560, 288),
                 (2560, 2560))]
# paths K and L1's products at the M they run: prefill 2 × 1024, decode
# 2, the engine's 8 slots, and the 8 × 32 tick. 4-bit: jamba's Mamba
# in_proj (4096 × 16384) and out_proj (8192 × 4096) and dense FFN w_gate,
# w_up (4096 × 14336); xlstm's mLSTM up_proj (768 × 3072), wq|wk|wv
# (1536²), down_proj (1536 × 768) and sLSTM w (768 × 3072), up_proj
# (768 × 2048), down_proj (1024 × 768). 8-bit: jamba's x_proj (8192 ×
# 288), dt_proj (256 × 8192) and attention (4096², 4096 × 1024)
SSM_M = (2, 8, 8 * 32, 2 * 1024)
K4_SHAPES += [(m, k, n, 16) for m in SSM_M
              for k, n in ((4096, 16384), (8192, 4096), (4096, 14336),
                           (768, 3072), (1536, 1536), (1536, 768),
                           (768, 2048), (1024, 768))]
K5_SHAPES += [(m, k, n, 64) for m in SSM_M
              for k, n in ((8192, 288), (256, 8192), (4096, 4096),
                           (4096, 1024))]
K4_MAIN, K5_MAIN = (1024, 3072, 8192, 16), (1024, 3072, 3072, 64)
# (B, S, H, KV, D, Dv, window): phi3-mini's prefill first, then
# minicpm3-4b's MLA prefill (qk 96, v 64) and mixtral-8x7b's (S = 4608
# against a 4096 window)
K6_SHAPES = [(2, 512, 32, 32, 96, 96, 0), (1, 512, 32, 8, 96, 96, 0),
             (1, 512, 8, 2, 64, 64, 128), (2, 97, 6, 3, 16, 16, 7),
             (2, 512, 40, 40, 96, 64, 0), (2, 4608, 32, 8, 128, 128, 4096)]

# K3 on the main path: the top-κ solver's last pass over w_down's 4 items
# (LM phase, path C), kept at a top-1% threshold here; ragged rows too
K3_SHAPES = [(LM_LAYERS, LM_ITEM), (3, 100_003)]
LENET_WEIGHTS, LENET_KAPPA = 266_200, 13_310      # path B's ℓ0 task
# K7 on path G (LeNet300's l0, K=4) and at the LM item width
K7_SHAPES = [(235_200, 4), (LM_ITEM, 16)]
# K8/K9 on path G (all LeNet300 weights), and K8 at the LM item width
K8_CASES = [(LENET_WEIGHTS, LENET_KAPPA), (LM_ITEM, LM_ITEM // 100)]
# the fused loops at the main paths' shapes: the Lloyd loop (I, P, K,
# kvalid, iters) of the LM phase and path C (10 steps), of the quickstart
# (20), a mixed-K case with +inf tails, and 37 more items than the loop's
# grid for K (I None, from the wrapper; blocks take whole items in turn);
# the bisection (I, P, κ, strict, tied) of w_down (κ = 5%, LM phase), of
# path B (LeNet300), K8's rules on path G, ragged rows with mixed κ, and
# magnitudes on a grid of 1/64, so that whole classes of ties straddle
# every threshold
LLOYD_CASES = [(*LM_K1_SHAPE, None, 10), (*QUICKSTART_SHAPES[0], None, 20),
               (*MIXED_K, 10), (None, 1_000, 16, "mixed", 10)]
W_DOWN_KAPPA_LM = int(0.05 * LM_ITEM)                  # 1,258,291
TOPK_CASES = [(LM_LAYERS, LM_ITEM, [W_DOWN_KAPPA_LM] * LM_LAYERS, False,
               False),
              (1, LENET_WEIGHTS, [LENET_KAPPA], False, False),
              (1, LENET_WEIGHTS, [LENET_KAPPA], True, False),
              (3, 100_003, [1, 5_000, 100_003], False, False),
              (2, 65_536, [1_000, 30_000], False, True),
              (2, 65_536, [1_000, 30_000], True, True)]
KMEANS_CB_ATOL = 1e-3      # as tests/test_torch_kernels.py

# path E: the JAX package's CPU result of the same tasks on its own
# problem, whose data and reference weights come from JAX's generator
# and so differ from the port's (``python examples/mixed_compression.py``,
# recorded in PERF.md)
JAX_CPU_MIXED = {"ref": 0.0186, "runs": [(0.2324, 22.5), (0.0332, 21.2)]}

# path F: per-matrix low-rank targets; wo's stepped spectrum puts rank
# selection's optimum at one of its two steps, one per α
F_RANKS = {"wq": 128, "wk": 128, "wv": 128, "w_gate": 256, "w_up": 192}
F_WO_STEPS, F_WO_MAX_RANK = (24, 48), 128
F_DOWN_KAPPA = LM_ITEM // 100                     # 251,658
F_MU = 1e-4

# path H: LC training of phi3-mini-3.8b at full width, 4 of 32 layers
# (H4: 1), batches of 8 × 1024 tokens; the CLI defaults of
# ``launch/train.py`` (μ0 9e-5, a 1.2, lr 1e-3); the quantization tasks'
# two groups: wq|wk|wv|wo (16 items of 3072²) and w_gate|w_up|w_down (12
# of 3072 × 8192)
H_BATCH, H_SEQ = 8, 1024
H_MU0, H_MU_A, H_LR = 9e-5, 1.2, 1e-3
H_GROUPS = [(4 * LM_LAYERS, LM_D_MODEL * LM_D_MODEL), (3 * LM_LAYERS, LM_ITEM)]
H_WEIGHTS = sum(i * p for i, p in H_GROUPS)           # 452,984,832


# paths I and J: mixtral-8x7b (2 of 32 layers; 2 prompts of 4608 tokens,
# past its 4096 window; 4-bit on the w_gate and w_up expert stacks, one
# item of 8 × 4096 × 14336 each), deepseek-moe-16b (its dense lead layer
# and 3 of 27 MoE layers; ℓ0 at 5% on the 3 w_down expert stacks, 64 ×
# 1408 × 2048 each, as one vector) and minicpm3-4b (4 of 62 layers)
MIX_LAYERS, MIX_PROMPT = 2, 4608
MIX_ITEM = 8 * 4096 * 14336                          # 469,762,048
I1_MATRICES = ("w_gate", "w_up", "w_down")
DS_MOE_LAYERS = 3
DS_ITEM = 64 * 1408 * 2048                           # 184,549,376
DS_KAPPA = int(0.05 * DS_MOE_LAYERS * DS_ITEM)       # 27,682,406
CPM_LAYERS = 4

# paths K, L1 and L2: jamba-v0.1-52b (layers 2–4 of its 8-layer
# super-block: Mamba + dense FFN, Mamba + MoE, attention + dense FFN) and
# xlstm-125m (all 12 blocks), prompts of 1024 (8 Mamba chunks of 128, 4
# mLSTM chunks of 256, 1024 sLSTM steps); the prefill-against-decode
# check on 2 prompts of two chunks (K 2 × 256, L1 2 × 512); L2 trains
# xlstm-125m at 4 × 1024 tokens a step
SSM_PROMPT = 1024
SSM_LAUNCHES = "ssm_launches"          # the line ``--ssm`` reports on
JAMBA_PARAMS, XLSTM_PARAMS = 3_960_418_304, 155_651_408
JAMBA_FFN = 4096 * 14336                               # 58,720,256
JAMBA_KAPPA = int(0.05 * 2 * JAMBA_FFN)                # 5,872,025
L2_BATCH, L2_SEQ, L2_LC, L2_STEPS = 4, 1024, 2, 3
K_SEEDS, L1_SEEDS = (24, 24), (26, 26)


_T0 = time.time()


def stamp(what: str) -> None:
    """Print the seconds since this process started, before ``what``."""
    print(f"[t={time.time() - _T0:.1f}s] {what}", flush=True)


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def reset(kern: dict) -> None:
    """Set every kernel's launch count to 0."""
    for kk in kern.values():
        kk.launches = 0


def launches(kern: dict) -> dict:
    return {n: kk.launches for n, kk in kern.items()}


def only(kern: dict, **want) -> dict:
    """The exact launch counts a path must show: ``want``, 0 elsewhere."""
    return {n: want.get(n, 0) for n in kern}


def kernel_name(mangled: str) -> str:
    """``quant_gemv_kernel<4, 8>`` for the mangled name of that
    instance in a ``-Xptxas -v`` log; the name as given if it is not a
    ``*_kernel`` template of integer arguments."""
    m = re.search(r"\d+([a-z_]+_kernel)(?:I((?:L[ib]\d+E)+)E)?", mangled)
    if m is None:
        return mangled
    args = re.findall(r"L[ib](\d+)E", m.group(2) or "")
    return m.group(1) + (f"<{', '.join(args)}>" if args else "")


def bound(n_bytes: float, n_ops: float,
          ops_per_s: float = F32_OPS_PER_S) -> tuple[float, str]:
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / ops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def timed_turns(fns, reps: int) -> list[float]:
    """Median ms of each callable on the current stream, taken in turns
    (a, b, …, then reversed, …) after one warm-up each."""
    times: list[list[float]] = [[] for _ in fns]
    for fn in fns:
        fn()
    torch.cuda.synchronize()
    order = list(range(len(fns)))
    for r in range(reps):
        for which in (order if r % 2 == 0 else order[::-1]):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fns[which]()
            end.record()
            end.synchronize()
            times[which].append(start.elapsed_time(end))
    return [statistics.median(t) for t in times]


@contextlib.contextmanager
def profiled(activities):
    """``torch.profiler.profile`` over ``activities`` whose first device
    event is a fill that no check counts: a session can miss the first
    kernel it records (on the H100 the missing event of a session was its
    first launch each time it was traced), so no counted launch of the
    port's kernels comes first."""
    from torch.profiler import profile
    with profile(activities=activities) as prof:
        torch.empty(1, device="cuda").fill_(0.0)
        torch.cuda.synchronize()
        yield prof


def device_trace(run, n_port: int, label: str) -> list:
    """The device events (``key_averages``) of ``run``, which queues
    work on the card, under ``profiled([CUDA])``: traced again, up to 3
    sessions, until the trace holds exactly the ``n_port`` launches of
    the port's kernels that ``run`` made. A session can drop kernel
    events (on the H100: 49 of 50 K5 launches, 47 of 50 K9, 10 of 50
    K2), and a trace short of a launch makes every sum short."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity
    for _ in range(3):
        with profiled([ProfilerActivity.CUDA]) as prof:
            run()
            torch.cuda.synchronize()
        dev = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA]
        seen = sum(e.count for e in dev if port_kernel(e.key))
        if seen == n_port:
            return dev
        print(f"{label}: the profiler saw {seen} of {n_port} launches of "
              f"the port's kernels; tracing again", flush=True)
    fail(f"{label}: the profiler saw {seen} of {n_port} launches of the "
         f"port's kernels in each of 3 sessions")


def kernel_phase(k1, k2, power: str) -> dict:
    """K1 and K2 against their plain versions at the main path's shapes;
    ``power`` (the card's power limit) is printed beside every time."""
    g = torch.Generator(device="cuda").manual_seed(0)
    rec = {"K1": {"err": 0.0, "rows": []}, "K2": {"err": 0.0, "rows": []}}
    cases = [(i, p, k, None) for i, p, k in QUICKSTART_SHAPES]
    cases += [(*LM_K1_SHAPE, None), MIXED_K]
    for i, p, k, kvalid in cases:
        w = torch.randn((i, p), device="cuda", generator=g)
        w[:, ::97] = 0.5 * torch.sign(w[:, ::97])        # magnitude ties
        cb = torch.sort(torch.randn((i, k), device="cuda", generator=g),
                        dim=-1).values
        if kvalid is not None:
            live = torch.arange(k, device="cuda")[None] < torch.tensor(
                kvalid, device="cuda")[:, None]
            cb = torch.where(live, cb, torch.inf)
        got = k1.kmeans_assign_moments_batched(w, cb)
        torch.cuda.synchronize()
        want = k1.kmeans_assign_moments_batched_plain(w, cb)
        check(torch.equal(got[0], want[0]), f"K1 assignments {i}x{p}x{k}")
        check(torch.equal(got[2], want[2]), f"K1 counts {i}x{p}x{k}")
        torch.testing.assert_close(got[1], want[1], rtol=1e-5, atol=1e-2)
        err = float((got[1] - want[1]).abs().max())
        rel = float(((got[1] - want[1]).abs()
                     / want[1].abs().clamp_min(1.0)).max())
        reps = 5 if i * p > 10_000_000 else 20
        ms, plain_ms = timed_turns(
            (lambda: k1.kmeans_assign_moments_batched(w, cb),
             lambda: k1.kmeans_assign_moments_batched_plain(w, cb)), reps)
        b_ms, b_by = bound(8.0 * i * p + 12.0 * i * k, 3.0 * i * p)
        row = {"shape": [i, p, k], "ms": ms, "plain_ms": plain_ms,
               "bound_ms": b_ms, "bound_by": b_by, "max_abs_err": err}
        rec["K1"]["rows"].append(row)
        rec["K1"]["err"] = max(rec["K1"]["err"], err)
        print(f"K1 I={i} P={p} K={k}{' mixed-K' if kvalid else ''}: "
              f"ms={ms:.4f} plain_ms={plain_ms:.4f} bound_ms={b_ms:.3g} "
              f"({b_by}) max|Δsums|={err:.3g} "
              f"max|Δsums|/max(|sums|,1)={rel:.3g} [{power}]", flush=True)
        del w, cb, got, want

    for i, p in K2_SHAPES:
        w = torch.randn((i, p), device="cuda", generator=g)
        w[:, ::97] = 0.5 * torch.sign(w[:, ::97])        # magnitude ties
        t = w.abs().amax(dim=-1) * 0.3
        t[0] = 0.5                                       # exactly the ties
        for strict in (True, False):
            n = k2.count_above_batched(w, t, strict)
            torch.cuda.synchronize()
            check(torch.equal(n, k2.count_above_batched_plain(w, t, strict)),
                  f"K2 counts {i}x{p} strict={strict}")
        ms, plain_ms = timed_turns(
            (lambda: k2.count_above_batched(w, t, False),
             lambda: k2.count_above_batched_plain(w, t, False)),
            5 if i * p > 10_000_000 else 20)
        b_ms, b_by = bound(4.0 * i * p + 8.0 * i, 2.0 * i * p)
        rec["K2"]["rows"].append(
            {"shape": [i, p], "ms": ms, "plain_ms": plain_ms,
             "bound_ms": b_ms, "bound_by": b_by, "max_abs_err": 0.0})
        print(f"K2 I={i} P={p}: ms={ms:.4f} plain_ms={plain_ms:.4f} "
              f"bound_ms={b_ms:.3g} ({b_by}) counts equal [{power}]",
              flush=True)
        del w, t
    torch.cuda.empty_cache()
    return rec


def iterated_lloyd(k1, w, cb, iters):
    """The Lloyd loop as single K1 passes plus the torch update (the
    design before the fused loop)."""
    for _ in range(iters):
        _, sums, counts = k1.kmeans_assign_moments_batched(w, cb)
        cb = torch.sort(torch.where(counts > 0, sums / counts.clamp_min(1),
                                    cb), dim=-1).values
    return cb, k1.kmeans_assign_moments_batched(w, cb)[0]


def iterated_bisection(k2, w, kappa, iters, strict):
    """The bisection as single K2 counts plus the torch update."""
    a_max = w.abs().amax(dim=-1)
    hi = a_max if strict else a_max * 2.0 + 1.0
    lo = torch.zeros_like(hi)
    for _ in range(iters):
        mid = 0.5 * (lo + hi)
        n = k2.count_above_batched(w, mid, strict)
        move = n > kappa if strict else n >= kappa
        lo = torch.where(move, mid, lo)
        hi = torch.where(move, hi, mid)
    return lo, hi, k2.count_above_batched(w, hi, strict)


def check_lloyd(k1, w, cb, iters, got, label: str) -> tuple[float, int]:
    """Hold a fused Lloyd loop's result ``got`` (codebooks, assignments)
    on w (I, P) from codebooks cb: bit-identical to the loop of single K1
    launches with the torch update, and against the plain loop: the
    codebooks within KMEANS_CB_ATOL with the same +inf tails. They drift
    from the plain loop's by its summation order, so over 10^8 weights a
    few lie between the two loops' boundaries: the assignments are held
    against the plain pass over the fused loop's own codebooks. Returns
    the codebooks' max |Δ| and the count of assignments that differ from
    the plain loop's."""
    want = iterated_lloyd(k1, w, cb, iters)
    check(torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]),
          f"{label} differs from the iterated loop")
    plain = k1.kmeans_lloyd_batched_plain(w, cb, iters)
    check(torch.equal(got[1], k1.kmeans_assign_moments_batched_plain(
        w, got[0])[0]), f"{label}: assignments differ from the plain pass "
          f"over its codebooks")
    moved = int((got[1] != plain[1]).sum())
    err = float((got[0] - plain[0]).abs().nan_to_num(0.0).max())
    check(err <= KMEANS_CB_ATOL and bool(torch.equal(
        torch.isinf(got[0]), torch.isinf(plain[0]))),
          f"{label}: codebooks off by {err}")
    return err, moved


def check_bisection(k2, w, kap, iters, strict, got, label: str):
    """Hold a fused bisection's (lo, hi, n_hi) ``got`` on w (I, P) and κ
    (I,) equal to the loop of single K2 launches with the torch update
    and to the plain loop; returns the iterated loop's (lo, hi, n_hi)."""
    want = iterated_bisection(k2, w, kap, iters, strict)
    plain = k2.topk_threshold_batched_plain(w, kap, iters, strict)
    for a, b, c in zip(got, want, plain):
        check(torch.equal(a, b) and torch.equal(a, c),
              f"{label}: (lo, hi, n_hi) differ from the iterated or plain "
              f"loop")
    return want


def lloyd_bound(k1, w, k, iters) -> tuple[float, str, float]:
    """The Lloyd loop's bound and its design's floor for w (I, P). The
    bound is the function's: w read once and the assignment written
    once, 8 B an element, against the least operations it needs: a step
    places each element (one comparison at the least) and adds it to its
    cluster's sum and count, and the final pass places it once more,
    3·iters + 1 an element; at these counts the bytes bound it. The
    fused design reads w once a step and writes the assignment once,
    (4·iters + 8) B an element, but where the kernel keeps each block's
    slice in shared memory for the whole loop (8 B an element), as the
    library reports for this launch (``k1._slice_resident``)."""
    i, p = w.shape
    b_ms, b_by = bound(8.0 * i * p + 8.0 * i * k, i * p * (3 * iters + 1))
    per_elem = 8.0 if k1._slice_resident(w, k) else 4.0 * iters + 8.0
    return b_ms, b_by, per_elem * i * p / HBM_BYTES_PER_S * 1e3


def fused_phase(k1, k2, power: str) -> dict:
    """The fused Lloyd loop and the fused bisection at the main paths'
    shapes: bit-identical to the loop of single K1/K2 launches plus
    today's torch update (codebooks, assignments, lo, hi, n_hi and the
    final masks), and to their plain loops (codebooks within
    KMEANS_CB_ATOL, thresholds, counts and masks equal); timed beside
    the iterated loop, the plain loop, the bounds and the designs'
    floors."""
    from repro_torch.core.schemes.prune import topk_magnitude_mask
    from repro_torch.kernels.prune import ops as pops
    g = torch.Generator(device="cuda").manual_seed(9)
    rec = {"lloyd": [], "topk": []}
    for i, p, k, kvalid, iters in LLOYD_CASES:
        if i is None:
            i = k1._grid(0, k) + 37
            check(k1._blocks_per_item(i, p, k1._grid(0, k)) == 1,
                  "past the grid: whole items a block")
        if kvalid == "mixed":
            kvalid = [1 + r % k for r in range(i)]
        w = torch.randn((i, p), device="cuda", generator=g)
        w[:, ::97] = 0.5 * torch.sign(w[:, ::97])        # ties
        cb = torch.sort(torch.randn((i, k), device="cuda", generator=g),
                        dim=-1).values
        if kvalid is not None:
            live = torch.arange(k, device="cuda")[None] < torch.tensor(
                kvalid, device="cuda")[:, None]
            cb = torch.sort(torch.where(live, cb, torch.inf), dim=-1).values
        got = k1.kmeans_lloyd_batched(w, cb, iters)
        torch.cuda.synchronize()
        err, moved = check_lloyd(k1, w, cb, iters, got,
                                 f"fused Lloyd loop {i}x{p}x{k}")
        big = i * p > 10_000_000
        ms, it_ms, plain_ms = timed_turns(
            (lambda: k1.kmeans_lloyd_batched(w, cb, iters),
             lambda: iterated_lloyd(k1, w, cb, iters),
             lambda: k1.kmeans_lloyd_batched_plain(w, cb, iters)),
            3 if big else 20)
        b_ms, b_by, floor_ms = lloyd_bound(k1, w, k, iters)
        rec["lloyd"].append({"shape": [i, p, k, iters], "ms": ms,
                             "iterated_ms": it_ms, "plain_ms": plain_ms,
                             "bound_ms": b_ms, "bound_by": b_by,
                             "floor_ms": floor_ms, "max_abs_err": err})
        print(f"Lloyd loop I={i} P={p} K={k} iters={iters}"
              f"{' mixed-K' if kvalid else ''}: ms={ms:.4f} "
              f"iterated_ms={it_ms:.4f} plain_ms={plain_ms:.4f} "
              f"bound_ms={b_ms:.4g} ({b_by}) design_floor_ms={floor_ms:.4g} "
              f"bit-identical to the iterated loop, "
              f"max|Δcb| vs plain loop={err:.3g}, assignments differing "
              f"from the plain loop's={moved} [{power}]", flush=True)
        del w, cb, got
        torch.cuda.empty_cache()

    for i, p, kappa, strict, tied in TOPK_CASES:
        w = torch.randn((i, p), device="cuda", generator=g)
        if tied:
            w = torch.round(w * 64.0) / 64.0
        else:
            w[:, ::97] = 0.5 * torch.sign(w[:, ::97])    # magnitude ties
        if i == LM_LAYERS:
            w *= 0.02                                    # w_down's scale
        kap = torch.tensor(kappa, dtype=torch.int32, device="cuda")
        got = k2.topk_threshold_batched(w, kap, 30, strict,
                                        with_stats=True)
        torch.cuda.synchronize()
        want = check_bisection(k2, w, kap, 30, strict, got[:3],
                               f"fused bisection {i}x{p} strict={strict}")
        stats = got[3].tolist()
        if i == LM_LAYERS:
            check(all(c[0] > 0 for c in stats),
                  f"fused bisection at w_down: no compaction {stats}")
        # the final masks: the solver's on the fused bisection, on the
        # iterated one (K3 and the fill over its lo, hi, n_hi) and exact
        exact = torch.stack([torch.where(topk_magnitude_mask(
            w[r], kappa[r]), w[r], 0.0) for r in range(i)])
        if strict:
            theta = torch.stack([pops.topk_mask(w[r], kappa[r])
                                 for r in range(i)])
        else:
            theta = pops.topk_mask_batched(w, kap, impl="kernel")
        lo, hi, n_hi = want
        a_ = w.abs()
        if strict:
            boundary = (a_ > lo[:, None]) & (a_ <= hi[:, None])
            kept = torch.stack([k2.mask_apply(w[r], hi[r])
                                for r in range(i)])
        else:
            boundary = (a_ >= lo[:, None]) & (a_ < hi[:, None])
            kept = k2.mask_apply_batched(w, hi, strict=False)
        fill = (torch.cumsum(boundary, dim=-1, dtype=torch.int32)
                <= (kap - n_hi)[:, None])
        iterated_theta = torch.where(boundary & fill, w, kept)
        check(torch.equal(theta, iterated_theta) and torch.equal(theta, exact),
              f"fused bisection {i}x{p} strict={strict}: masks differ from "
              f"the iterated loop's or the exact top-κ")
        big = i * p > 10_000_000
        ms, it_ms, plain_ms = timed_turns(
            (lambda: k2.topk_threshold_batched(w, kap, 30, strict),
             lambda: iterated_bisection(k2, w, kap, 30, strict),
             lambda: k2.topk_threshold_batched_plain(w, kap, 30, strict)),
            5 if big else 50)
        b_ms, b_by = bound(4.0 * i * p + 16.0 * i, 2.0 * i * p)
        # the design's floor: its passes over all of w (the band's
        # passes after a compaction not counted)
        passes = max(c[2] for c in stats)
        floor_ms = passes * 4.0 * i * p / HBM_BYTES_PER_S * 1e3
        rec["topk"].append({"shape": [i, p], "strict": strict, "ms": ms,
                            "iterated_ms": it_ms, "plain_ms": plain_ms,
                            "bound_ms": b_ms, "bound_by": b_by,
                            "floor_ms": floor_ms, "max_abs_err": 0.0})
        print(f"bisection I={i} P={p} κ={kappa[:4]} strict={strict}"
              f"{' tied' if tied else ''}: ms={ms:.4f} "
              f"iterated_ms={it_ms:.4f} plain_ms={plain_ms:.4f} "
              f"bound_ms={b_ms:.4g} ({b_by}) full_passes={passes} "
              f"design_floor_ms={floor_ms:.4g} (compactions, first step, "
              f"passes over w, one-block finish from)={stats} (lo, hi, "
              f"n_hi, masks) equal to the iterated and plain loops "
              f"[{power}]", flush=True)
        del w, kap, got, want, theta, exact, iterated_theta
        torch.cuda.empty_cache()
    return rec


def monitor_ok(history) -> bool:
    return all(after <= before * (1 + 1e-5) + 1e-6
               for m in history
               for before, after in m.c_step_shifted_distortion.values())


def planner_on_off(label: str, lc, params, state, kern) -> dict:
    """One C step of ``lc`` from ``state`` with the group planner on and
    off (``c_step_async``: nothing of ``state`` is written): Θ and Δ(Θ)
    bit for bit, and the same launches. Returns the planner-on run's
    launches."""
    from repro_torch.tree import tree_leaves
    runs = {}
    for planner in ("off", "on"):
        lc.set_planner(planner)
        before = launches(kern)
        out = lc.c_step_async(params, state)
        torch.cuda.synchronize()
        runs[planner] = (out["tasks"], {
            k: v - before[k] for k, v in launches(kern).items()})
    planned = [g for g in lc.group_summary(params) if g["plan"]]
    for name in state["tasks"]:
        on, off = (tree_leaves(runs[p][0][name]) for p in ("on", "off"))
        check(len(on) == len(off) and all(
            torch.equal(a, b) for a, b in zip(on, off)),
            f"{label}: planner on and off differ on {name}")
    check(runs["on"][1] == runs["off"][1],
          f"{label}: launches with the planner on {runs['on'][1]}, off "
          f"{runs['off'][1]}")
    print(f"{label}: planner on against off: Θ and Δ(Θ) bit for bit over "
          f"{len(state['tasks'])} tasks, launches equal "
          f"{ {k: v for k, v in runs['on'][1].items() if v} }; planned "
          f"groups {[(g['items'], g['plan']['backend'], g['plan']['n_chunks']) for g in planned]}",
          flush=True)
    return runs["on"][1]


def _packed_like(group, counts, out, results) -> None:
    """Hold a group's packed (Θ, Δ items) ``out`` against the per-task
    ``results`` of ``grouped_compress``, bit for bit."""
    from repro_torch.core.schemes.base import (add_leading_axis,
                                               slice_theta_like)
    from repro_torch.tree import tree_leaves, tree_map
    theta, a = out
    off = 0
    for t, n in zip(group, counts):
        th, a_arr = results[t.name]
        if not t.view.stacked:
            th = add_leading_axis(th)
        mine = slice_theta_like(
            tree_map(lambda x, o=off, n=n: x[o:o + n], theta), th)
        same = all(torch.equal(x, y) for x, y in
                   zip(tree_leaves(mine), tree_leaves(th)))
        check(same and torch.equal(a[off:off + n], t.view.to_items(a_arr)),
              f"{t.name}: the captured solve differs from the eager one")
        off += n


def captured_against_eager(label: str, group, xs, thetas, mus,
                           power: str) -> dict:
    """``compile_group``'s solve of ``group`` (a CUDA graph, captured at
    its first call) against ``grouped_compress`` run eagerly, at each μ
    of ``mus`` (0-d tensors, as the LC driver passes them): Θ and Δ(Θ)
    bit for bit; one capture, then cache hits and replays only; eager
    and captured seconds."""
    from repro_torch.analysis import cost
    from repro_torch.core.grouping import compile_group, grouped_compress
    counts = [t.view.item_count(xs[t.name]) for t in group]
    eager, t_eager = [], []
    for mu in mus:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        eager.append(grouped_compress(group, xs, thetas, mu, backend="auto",
                                      device="cuda", planner="on"))
        torch.cuda.synchronize()
        t_eager.append(time.perf_counter() - t0)
    before = cost.cache_stats()
    exe, arrays = compile_group(group, xs, thetas, backend="auto",
                                device="cuda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    outs = [exe(mus[0], *arrays)]
    torch.cuda.synchronize()
    t_capture = time.perf_counter() - t0
    t_replay = []
    for mu in list(mus[1:]) + [mus[0]]:
        t0 = time.perf_counter()
        outs.append(exe(mu, *arrays))
        torch.cuda.synchronize()
        t_replay.append(time.perf_counter() - t0)
    again, _ = compile_group(group, xs, thetas, backend="auto",
                             device="cuda")
    after = cost.cache_stats()
    check(again is exe and after["exec_misses"] - before["exec_misses"] == 1
          and after["exec_hits"] - before["exec_hits"] == 1
          and exe.programs.captured == 1,
          f"{label}: {exe.programs.captured} captures, exec stats "
          f"{before} -> {after}")
    for out, res in zip(outs, eager + [eager[0]]):
        _packed_like(group, counts, out, res)
    pool_gib = exe.programs.pool_bytes() / 2**30
    # drop the executable, and its graph's memory pool, from the cache
    del exe, again
    cost.clear_caches()
    print(f"{label}: compile_group captured against eager at mu="
          f"{[float(m) for m in mus]}: Θ and Δ(Θ) bit for bit; 1 capture, "
          f"then cache hits; eager_s={[round(t, 4) for t in t_eager]} "
          f"capture_call_s={t_capture:.3f} (an eager run and the capture) "
          f"replay_s={[round(t, 4) for t in t_replay]} "
          f"graph_pool_gib={pool_gib:.3f} "
          f"[{power}]", flush=True)
    return {"eager_s": t_eager, "capture_s": t_capture,
            "replay_s": t_replay}


def main_path_a(kern) -> dict:
    from repro_torch import quickstart
    reset(kern)
    t0 = time.time()
    out = quickstart.main(device="cuda")        # raises if LC > DC
    torch.cuda.synchronize()
    wall = time.time() - t0
    n = launches(kern)
    lc, dc = out["lc"], out["dc"]
    check(lc["test_err"] <= dc["test_err"] + 1e-6, "quickstart LC > DC")
    # one fused Lloyd loop per layer and C step
    check(n == only(kern, K1loop=20 * 3), f"quickstart launches {n}")
    check(monitor_ok(lc["history"]), "quickstart §7 monitor")
    print(f"main path A (quickstart): ref_err={out['ref']:.4f} "
          f"dc_err={dc['test_err']:.4f} lc_err={lc['test_err']:.4f} "
          f"ratio={lc['ratio']:.1f}x lc_wall_s={lc['wall_s']:.2f} "
          f"total_wall_s={wall:.2f} Lloyd_loop_launches={n['K1loop']}",
          flush=True)
    planner_on_off("path A", lc["lc"], lc["state"].tree(), lc["lc_state"],
                   kern)
    return n


def main_path_b(kern) -> dict:
    from repro_torch.core import AsVector, CompressionTask
    from repro_torch.core.schemes import ConstraintL0Pruning
    from repro_torch.showcase import (
        DIMS, direct_compress, reference_problem, run_lc)
    total = sum(DIMS[i] * DIMS[i + 1] for i in range(len(DIMS) - 1))
    kappa = int(total * 0.05)
    check((total, kappa) == (LENET_WEIGHTS, LENET_KAPPA), f"κ {kappa}")

    def tasks():
        return [CompressionTask("p", r"l\d/w$", AsVector(),
                                ConstraintL0Pruning(kappa=kappa))]

    nnz = []

    def count_nnz(model, lc, m):
        nnz.append(int(torch.count_nonzero(
            lc["tasks"]["p"]["theta"]["theta"])))

    reset(kern)
    t0 = time.time()
    prob = reference_problem(device="cuda")
    dc = direct_compress(prob, tasks(), device="cuda")
    lc = run_lc(prob, tasks(), n_steps=20, iters_per_l=40,
                callbacks=[count_nnz], device="cuda")
    torch.cuda.synchronize()
    wall = time.time() - t0
    n = launches(kern)
    check(nnz == [kappa] * 20, f"ℓ0 nonzeros per C step {nnz}")
    check(monitor_ok(lc["history"]), "ℓ0 §7 monitor")
    # per C step: one fused bisection, one mask (K3)
    check(n == only(kern, K2loop=20, K3=20), f"ℓ0 launches {n}")
    print(f"main path B (ℓ0 κ={kappa}): dc_err={dc['test_err']:.4f} "
          f"lc_err={lc['test_err']:.4f} ratio={lc['ratio']:.1f}x "
          f"lc_wall_s={lc['wall_s']:.2f} total_wall_s={wall:.2f} "
          f"bisection_launches={n['K2loop']} K3_launches={n['K3']}",
          flush=True)
    planner_on_off("path B", lc["lc"], lc["state"].tree(), lc["lc_state"],
                   kern)
    return n


def lm_problem(g):
    """The LM phase's FFN stacks (random, from generator ``g``) and its
    LC algorithm: K=16 quantization of w_gate|w_up, ℓ0 at 5% of w_down."""
    from repro_torch.core import AsStacked, CompressionTask, LCAlgorithm
    from repro_torch.core.schemes import (
        AdaptiveQuantization, ConstraintL0Pruning)
    shapes = {"w_gate": (LM_LAYERS, LM_D_MODEL, LM_D_FF),
              "w_up": (LM_LAYERS, LM_D_MODEL, LM_D_FF),
              "w_down": (LM_LAYERS, LM_D_FF, LM_D_MODEL)}
    params = {"ffn": {n: 0.02 * torch.randn(s, device="cuda", generator=g)
                      for n, s in shapes.items()}}
    tasks = [
        CompressionTask("quant", r"ffn/(w_gate|w_up)$", AsStacked("vector"),
                        AdaptiveQuantization(k=16, iters=10)),
        CompressionTask("prune", r"ffn/w_down$", AsStacked("vector"),
                        ConstraintL0Pruning(kappa=int(0.05 * LM_ITEM))),
    ]
    return params, LCAlgorithm(tasks, [1e-4, 1.3e-4], device="cuda")


def lm_phase(kern, power: str) -> dict:
    g = torch.Generator(device="cuda").manual_seed(1)
    torch.cuda.reset_peak_memory_stats()
    params, lc = lm_problem(g)
    kappa = int(0.05 * LM_ITEM)
    mus = [1e-4, 1.3e-4]
    groups = lc.group_summary(params)
    print("LM groups:", [(g_["tasks"], g_["items"], g_["solver"],
                          g_["backend"]) for g_ in groups], flush=True)
    check(any(g_["items"] == 2 * LM_LAYERS and g_["backend"] == "cuda"
              for g_ in groups), "LM quantization group of 8 items")
    t0 = time.time()
    state = lc.init(params)
    torch.cuda.synchronize()
    print(f"LM init_s={time.time() - t0:.2f}", flush=True)
    total = only(kern)
    for step, mu in enumerate(mus):
        for w in params["ffn"].values():           # stand-in for an L step
            w.add_(1e-3 * torch.randn(w.shape, device="cuda", generator=g))
        state = lc.set_mu(state, mu, step)
        pre = {n: float(v) for n, v in lc.shifted_distortion(params,
                                                             state).items()}
        planner_on_off(f"LM C step {step}", lc, params, state, kern)
        reset(kern)
        torch.cuda.synchronize()
        t0 = time.time()
        state = lc.c_step(params, state)
        torch.cuda.synchronize()
        c_s = time.time() - t0
        step_n = launches(kern)
        check(step_n == only(kern, K1loop=1, K2loop=1, K3=1),
              f"LM C-step launches {step_n}")
        total = {k: total[k] + step_n[k] for k in total}
        post = lc.shifted_distortion(params, state)
        for n, before in pre.items():
            check(float(post[n]) <= before * (1 + 1e-5) + 1e-6,
                  f"LM §7 monitor {n}: {before} -> {float(post[n])}")
        th = state["tasks"]["prune"]["theta"]["theta"]
        nnz = torch.count_nonzero(th.reshape(LM_LAYERS, -1), dim=1)
        check(nnz.tolist() == [kappa] * LM_LAYERS, f"LM κ per item {nnz}")
        for name in ("quant[0]", "quant[1]"):
            cb = state["tasks"][name]["theta"].codebook
            check(bool(torch.isfinite(cb).all()) and cb.shape == (4, 16),
                  f"LM codebooks {name}")
        state = lc.multiplier_step(params, state)
        print(f"LM C step {step} (mu={mu:g}): c_step_s={c_s:.3f} "
              f"Lloyd_loop={step_n['K1loop']} bisection="
              f"{step_n['K2loop']} K3={step_n['K3']} "
              f"shifted_distortion="
              f"{ {n: (round(pre[n], 3), round(float(post[n]), 3)) for n in pre} }",
              flush=True)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() / 2**30
    print(f"LM peak_memory_gib={peak:.2f}", flush=True)
    # the k-means group and the top-κ task, each captured as a CUDA graph
    from repro_torch.core.grouping import build_groups
    xs = {t.name: t.shifted_compressible(params, state["tasks"][t.name],
                                         state["mu"]) for t in lc.tasks}
    thetas = {t.name: state["tasks"][t.name]["theta"] for t in lc.tasks}
    groups = build_groups(lc.tasks, xs, backend="auto", device="cuda")
    check(sorted(len(g) for g in groups) == [1, 2], "LM groups")
    for group in groups:
        captured_against_eager(
            f"LM {group[0].scheme.solver} group {[t.name for t in group]}",
            group, xs, thetas, (state["mu"], state["mu"] * 1.3), power)
    del params, state, xs, thetas
    torch.cuda.empty_cache()
    return total


def serve_kernel_phase(k45, k6, power: str) -> dict:
    """K4, K5 and K6 against their plain versions at the serving paths'
    shapes; ``power`` (the card's power limit) is printed beside every
    time."""
    from repro_torch.kernels.quant_matmul import ops as qops
    g = torch.Generator(device="cuda").manual_seed(3)
    rec = {"K4": [], "K5": [], "K6": []}

    def gemm_case(name, m, k, n, c):
        """One K4/K5 row: checked and timed beside the plain version and
        the densified ``torch.matmul``. The bound is the function's, not
        the kernel's: x, the indices, the codebook and y moved once, and
        2·M·K·N operations at the faster of the f32 CUDA cores and three
        TF32 passes on the tensor cores, for the decode GEMV and the
        prefill kernel alike."""
        x = torch.randn((m, k), device="cuda", generator=g)
        idx = torch.randint(0, c, (k, n), device="cuda", generator=g,
                            dtype=torch.uint8)
        # codebook at the scale of the model's weights (std 1/√fan_in)
        cb = torch.sort(torch.randn(c, device="cuda", generator=g)).values \
            / math.sqrt(k)
        if name == "K4":
            w = qops.pack4(idx)
            if k % 2:   # odd K: the zero column that meets the pad row
                x = torch.cat([x, x.new_zeros((m, 1))], dim=1)
            kern = lambda: k45.quant_matmul_packed(x, w, cb)  # noqa: E731
            plain = lambda: k45.quant_matmul_packed_plain(x, w, cb)  # noqa: E731,E501
            w_bytes = w.numel()
        else:
            w = idx
            kern = lambda: k45.quant_matmul(x, w, cb)  # noqa: E731
            plain = lambda: k45.quant_matmul_plain(x, w, cb)  # noqa: E731
            w_bytes = w.numel()
        got = kern()
        torch.cuda.synchronize()
        want = plain()
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-4)
        err = float((got - want).abs().max())
        dense = cb[idx.long()]
        if x.shape[1] != k:
            dense = torch.cat([dense, dense.new_zeros((1, n))], dim=0)
        reps = 10 if m * k * n > 1e9 else 30
        ms, plain_ms, dense_ms = timed_turns(
            (kern, plain, lambda: torch.matmul(x, dense)), reps)
        n_bytes = 4.0 * m * k + w_bytes + 4.0 * c + 4.0 * m * n
        ops = 2.0 * m * k * n
        b_ms, b_by = min(bound(n_bytes, ops),
                         bound(n_bytes, 3 * ops, TF32_OPS_PER_S))
        row = {"shape": [m, k, n, c], "ms": ms, "plain_ms": plain_ms,
               "bound_ms": b_ms, "bound_by": b_by, "max_abs_err": err,
               "densified_matmul_ms": dense_ms}
        rec[name].append(row)
        print(f"{name} M={m} K={k} N={n} C={c}: ms={ms:.4f} "
              f"plain_ms={plain_ms:.4f} bound_ms={b_ms:.3g} ({b_by}) "
              f"densified_torch_matmul_ms={dense_ms:.4f} "
              f"max|Δ|={err:.3g} [{power}]", flush=True)

    for m, k, n, c in K4_SHAPES:
        gemm_case("K4", m, k, n, c)
    for m, k, n, c in K5_SHAPES:
        gemm_case("K5", m, k, n, c)

    for b, s, h, kvh, d, dv, window in K6_SHAPES:
        grp = h // kvh
        q = torch.randn((b, kvh, grp, s, d), device="cuda", generator=g)
        k = torch.randn((b, kvh, s, d), device="cuda", generator=g)
        v = torch.randn((b, kvh, s, dv), device="cuda", generator=g)
        # MLA passes its scale; another than the default 1/√D, so that
        # the row shows the caller's scale reaches the kernel
        scale = 0.9 / math.sqrt(d) if dv != d else None
        got = k6.flash_attention(q, k, v, window=window, scale=scale)
        torch.cuda.synchronize()
        want = k6.flash_attention_plain(q, k, v, window=window, scale=scale)
        torch.testing.assert_close(got, want, rtol=2e-4, atol=2e-4)
        err = float((got - want).abs().max())
        del want
        qh = q.reshape(b, h, s, d)
        # SDPA: causal, or the causal window as a boolean mask
        mask = None
        if window:
            pos = torch.arange(s, device="cuda")
            mask = (pos[None, :] <= pos[:, None]) & \
                (pos[None, :] > pos[:, None] - window)
        fns = [lambda: k6.flash_attention(q, k, v, window=window,
                                          scale=scale),
               lambda: k6.flash_attention_plain(q, k, v, window=window,
                                                scale=scale),
               lambda: F.scaled_dot_product_attention(
                   qh, k, v, attn_mask=mask, is_causal=mask is None,
                   scale=scale, enable_gqa=True)]
        ms, plain_ms, lib_ms = timed_turns(fns, 50 if s <= 1024 else 10)
        pairs = sum(min(i + 1, window) if window else i + 1 for i in range(s))
        # three TF32 passes of 2·D (Q·Kᵀ) + 2·Dv (P·V) operations per
        # pair (the f32 split)
        b_ms, b_by = bound(
            4.0 * (b * h * s * (d + dv) + b * kvh * s * (d + dv)),
            3 * 2.0 * (d + dv) * b * h * pairs, TF32_OPS_PER_S)
        rec["K6"].append({"shape": [b, s, h, kvh, d, dv, window], "ms": ms,
                          "plain_ms": plain_ms, "bound_ms": b_ms,
                          "bound_by": b_by, "max_abs_err": err,
                          "library_ms": lib_ms})
        print(f"K6 B={b} S={s} H={h} KV={kvh} D={d} Dv={dv} "
              f"window={window}: ms={ms:.4f} plain_ms={plain_ms:.4f} "
              f"bound_ms={b_ms:.3g} ({b_by}) sdpa_ms={lib_ms:.4f} "
              f"max|Δ|={err:.3g} [{power}]", flush=True)
        del q, k, v, qh, got, mask
    torch.cuda.empty_cache()
    return rec


#: the trace names of the port's kernels (each source keeps its kernels
#: in an anonymous namespace), each with the counters of the wrappers
#: that launch it: K7–K9 and the fused loops share the K1–K3 sources, and
#: K4 and K5 are the ``quant_gemv``/``quant_mma`` kernels
DEVICE_KERNELS = {
    f"(anonymous namespace)::{name}": keys for name, keys in (
        ("lloyd_kernel", ("K1", "K7", "K1loop")),
        ("topk_kernel", ("K2", "K8", "K2loop")),
        ("mask_apply_kernel", ("K3", "K9")),
        ("quant_", ("K4", "K5")),
        ("flash_attention_kernel", ("K6",)))}


def port_kernel(name: str) -> bool:
    """Whether a trace name is one of the port's kernels."""
    return any(k in name for k in DEVICE_KERNELS)


def device_profile(fn, label: str, power: str, kern: dict,
                   tries: int = 1) -> tuple:
    """Run ``fn`` once under ``torch.profiler`` and print its wall time,
    each CUDA stream's busy time (kernels, copies and fills; not the
    spans of ``record_function`` ranges), their union (the device's busy
    time) and its share of the wall time (the
    device's busy share), the time two streams ran at once, and the
    kernels that took the most time; return the device events and the
    profiler's event tree (``prof.events()``). The
    launch counts are set to 0 before ``fn``: every launch of the port's
    kernels that the wrappers count must show in the trace, or the
    profile fails (a dropped event would make every number here short);
    with ``tries`` > 1, a session short of a launch is taken again, up
    to ``tries`` sessions, as ``device_trace`` does.
    The spans come from the profiler's events, with no trace file. The
    profiler adds host work, so the wall time here is above the untraced
    one."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity
    for attempt in range(tries):
        torch.cuda.synchronize()
        reset(kern)
        with profiled([ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        n = launches(kern)
        spans: dict = {}
        names = []
        ranges = set()       # record_function ranges' spans on the device
        for ev in prof.profiler.kineto_results.events():
            if ev.device_type() != DeviceType.CUDA:
                continue
            if ev.is_user_annotation():
                ranges.add(ev.name())
                continue
            spans.setdefault(ev.device_resource_id(), []).append(
                (ev.start_ns(), ev.start_ns() + ev.duration_ns()))
            names.append(ev.name())
        short = [(name, keys, sum(name in x for x in names),
                  sum(n[k] for k in keys))
                 for name, keys in DEVICE_KERNELS.items()]
        short = [x for x in short if x[2] != x[3]]
        if not short:
            break
        name, keys, seen, want = short[0]
        msg = (f"profile {label}: {seen} {name} events in the trace, "
               f"{want} launches counted ({keys})")
        check(attempt + 1 < tries, msg)
        print(f"{msg}; tracing again", flush=True)
    busy = {st: sum(e - b for b, e in v) / 1e6 for st, v in spans.items()}
    union, end = 0.0, -math.inf
    for b, e in sorted(x for v in spans.values() for x in v):
        if e > end:
            union += e - max(b, end)
            end = e
    union /= 1e6
    dev = [e for e in prof.key_averages()
           if e.device_type == DeviceType.CUDA and e.key not in ranges]
    top = sorted(dev, key=lambda e: -e.self_device_time_total)[:8]
    print(f"profile {label}: wall_ms={wall_ms:.2f} device_busy_ms="
          f"{union:.2f} device_busy={union / wall_ms:.3f} per_stream_ms="
          f"{ {st: round(v, 2) for st, v in sorted(busy.items())} } "
          f"two_streams_at_once_ms={sum(busy.values()) - union:.2f} "
          f"port_kernels={ {k: v for k, v in n.items() if v} } top: "
          + "; ".join(f"{e.key[:50]} x{e.count} "
                      f"{e.self_device_time_total / 1e3:.3f}ms"
                      for e in top) + f" [{power}]", flush=True)
    return dev, prof.events()


def serving_config():
    """phi3-mini-3.8b at full width, cut to 4 of its 32 layers (unrolled:
    the bridge needs per-layer 2-D leaves), float32, fused attention."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import LayerSpec
    cfg = get_config("phi3-mini-3.8b").with_(
        pattern=(LayerSpec("attn", "dense"),) * LM_LAYERS, pattern_reps=1,
        dtype="float32", fused_attention=True)
    check((cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim,
           cfg.d_ff, cfg.vocab_size) == (LM_D_MODEL, 32, 32, 96, LM_D_FF,
                                         32064), "phi3-mini widths")
    return cfg


@torch.inference_mode()
def teacher_logits(params, cfg, prompts_t, toks_t, max_len=SERVE_MAX_LEN):
    """Logits of ``params`` at every generation step, teacher-forced with
    the generated tokens ``toks_t``; with prefill ms and decode ms per
    step."""
    from repro_torch.models import transformer as tf
    from repro_torch.models.layers import unembed
    from repro_torch.runtime import server as srv
    torch.cuda.synchronize()
    t0 = time.time()
    hidden, _, caches = tf.forward_hidden(params, prompts_t, cfg,
                                          return_caches=True)
    out = [unembed(params["embed"], hidden[:, -1:], cfg)[:, 0]]
    torch.cuda.synchronize()
    t_pre = time.time() - t0
    s, n_gen = prompts_t.shape[1], toks_t.shape[1]
    caches = srv.pad_caches_to(caches, cfg, s, max_len)
    t0 = time.time()
    for i in range(n_gen - 1):
        logits, caches = tf.decode_step(params, caches, toks_t[:, i:i + 1],
                                        s + i, cfg)
        out.append(logits[:, 0])
    torch.cuda.synchronize()
    t_dec = (time.time() - t0) / (n_gen - 1)
    return torch.stack(out, dim=1), t_pre, t_dec


def against_densified(label, cfg, serving, dense, prompts_t, toks_t,
                      power: str, max_len=SERVE_MAX_LEN) -> float:
    """The served model's logits within 1e-3·max|logit| of the densified
    model's at every step (both teacher-forced with the served tokens),
    and every served token a maximum of both; returns the greedy token
    agreement."""
    lc_logits, pre_c, dec_c = teacher_logits(serving, cfg, prompts_t,
                                             toks_t, max_len)
    ld_logits, pre_d, dec_d = teacher_logits(dense, cfg, prompts_t, toks_t,
                                             max_len)
    tol = 1e-3 * float(ld_logits.abs().max())
    diff = (lc_logits - ld_logits).abs().amax(dim=(0, 2))     # per step
    check(bool((diff <= tol).all()),
          f"{label} compressed vs densified logits: max per step "
          f"{diff.tolist()} > {tol:.3g}")
    chosen_c = torch.gather(lc_logits, 2, toks_t.long()[..., None])[..., 0]
    chosen_d = torch.gather(ld_logits, 2, toks_t.long()[..., None])[..., 0]
    check(bool((chosen_c >= lc_logits.amax(-1) - tol).all()),
          f"{label}: generated tokens are not the compressed model's maxima")
    check(bool((chosen_d >= ld_logits.amax(-1) - tol).all()),
          f"{label}: a generated token is off the densified model's maximum")
    agree = float((ld_logits.argmax(-1) == toks_t.long()).float().mean())
    print(f"{label} vs densified: max|Δlogit|={float(diff.max()):.3g} "
          f"(tol {tol:.3g} = 1e-3·max|logit|) token_agreement={agree:.4f} "
          f"prefill_ms compressed={pre_c * 1e3:.1f} densified="
          f"{pre_d * 1e3:.1f} decode_ms_per_step compressed="
          f"{dec_c * 1e3:.2f} densified={dec_d * 1e3:.2f} [{power}]",
          flush=True)
    return agree


def c_tasks() -> list:
    """Path C's tasks: per layer, 4-bit k=16 on w_gate|w_up, 8-bit k=64
    on the attention, ℓ0 on w_down."""
    from repro_torch.core import AsVector, CompressionTask
    from repro_torch.core.schemes import (
        AdaptiveQuantization, ConstraintL0Pruning)
    tasks = []
    for i in range(LM_LAYERS):
        pre = rf"^stages/s0/pos{i}/"
        tasks += [
            CompressionTask(f"ffn{i}", pre + r"ffn/(w_gate|w_up)$",
                            AsVector(), AdaptiveQuantization(k=16, iters=10)),
            CompressionTask(f"attn{i}", pre + r"mixer/(wq|wk|wv|wo)$",
                            AsVector(), AdaptiveQuantization(k=64, iters=10)),
            CompressionTask(f"down{i}", pre + r"ffn/w_down$", AsVector(),
                            ConstraintL0Pruning(kappa=W_DOWN_KAPPA))]
    return tasks


def main_path_c(kern, power: str) -> dict:
    """phi3-mini at full width, 4 of 32 layers: 4-bit k=16 on each
    layer's w_gate/w_up, 8-bit k=64 on its attention and ℓ0 on its
    w_down (the fused bisection and K3), served by ``serve_path`` and
    checked by ``check_served``. Returns the path's launches and what
    path D and the profile phase need."""
    cfg = serving_config()
    run = serve_path(kern, "C", cfg, c_tasks(), SERVE_PROMPT, power,
                     seeds=(2, 4))
    check(run["kinds"] == {"quant4": 2 * LM_LAYERS, "quant8": 4 * LM_LAYERS,
                           "sparse": LM_LAYERS},
          f"C bridged forms {run['kinds']}")
    # LC init runs no kernel (in either package); the C step runs two
    # k-means groups (one fused Lloyd loop each) and one fused bisection;
    # generate runs every quantized matrix once per token (prefill + 31
    # decode steps) and K6 once per layer at prefill
    want = only(kern, K1loop=2, K2loop=1, K3=1,
                K4=LM_LAYERS * 2 * SERVE_GEN,
                K5=LM_LAYERS * 4 * SERVE_GEN, K6=LM_LAYERS)
    check(run["kmeans_groups"] == 2 and run["launches"] == want,
          f"path C launches {run['launches']} != {want}")
    del run["state"], run["lc"]
    check_served("path C", cfg, run, power)
    server_against_eager("path C", cfg, run["serving"], run["prompts"],
                         power)
    out = {k: run[k] for k in ("launches", "serving", "prompts", "tokens")}
    del run
    torch.cuda.empty_cache()
    return {"cfg": cfg, **out}


def mask_count_phase(k1, k2, power: str) -> dict:
    """K3, K7, K8 and K9 against their plain versions at the main paths'
    shapes; ``power`` (the card's power limit) is printed beside every
    time."""
    from repro_torch.core.schemes.prune import topk_magnitude_mask
    from repro_torch.kernels.prune import ops as pops
    g = torch.Generator(device="cuda").manual_seed(6)
    rec = {"K3": [], "K7": [], "K8": [], "K9": []}

    def row(name, shape, fns, n_bytes, n_ops, err=0.0):
        """``fns``: the kernel, its plain version and, where one PyTorch
        call computes the same function, that call."""
        # short launches: event times spread with the host, so more turns
        ms, plain_ms, *lib = timed_turns(
            fns, 5 if math.prod(shape) > 10_000_000 else 100)
        lib_ms = lib[0] if lib else None
        b_ms, b_by = bound(n_bytes, n_ops)
        rec[name].append({"shape": list(shape), "ms": ms,
                          "plain_ms": plain_ms, "bound_ms": b_ms,
                          "bound_by": b_by, "max_abs_err": err,
                          "library_ms": lib_ms})
        print(f"{name} shape={list(shape)}: ms={ms:.4f} plain_ms="
              f"{plain_ms:.4f} library_ms="
              f"{'none' if lib_ms is None else f'{lib_ms:.4f}'} "
              f"bound_ms={b_ms:.3g} ({b_by}) max|Δ|={err:.3g} [{power}]",
              flush=True)

    for i, p in K3_SHAPES:
        w = torch.randn((i, p), device="cuda", generator=g)
        w[:, ::97] = 0.5 * torch.sign(w[:, ::97])          # magnitude ties
        t = torch.topk(w.abs(), max(p // 100, 1),
                       dim=-1).values[:, -1].contiguous()
        for strict in (True, False):
            got = k2.mask_apply_batched(w, t, strict)
            torch.cuda.synchronize()
            check(torch.equal(got, k2.mask_apply_batched_plain(w, t, strict)),
                  f"K3 masks {i}x{p} strict={strict}")
        row("K3", (i, p), (lambda: k2.mask_apply_batched(w, t, False),
                           lambda: k2.mask_apply_batched_plain(w, t, False)),
            8.0 * i * p + 4.0 * i, 2.0 * i * p)
        del w, t, got

    for p, k in K7_SHAPES:
        w = torch.randn(p, device="cuda", generator=g)
        cb = torch.sort(torch.randn(k, device="cuda", generator=g)).values
        got = k1.kmeans_assign_moments(w, cb)
        torch.cuda.synchronize()
        want = k1.kmeans_assign_moments_plain(w, cb)
        check(torch.equal(got[0], want[0]), f"K7 assignments {p}x{k}")
        check(torch.equal(got[2], want[2]), f"K7 counts {p}x{k}")
        torch.testing.assert_close(got[1], want[1], rtol=1e-5, atol=1e-2)
        row("K7", (p, k), (lambda: k1.kmeans_assign_moments(w, cb),
                           lambda: k1.kmeans_assign_moments_plain(w, cb)),
            8.0 * p + 12.0 * k, 3.0 * p,
            err=float((got[1] - want[1]).abs().max()))
        del w, cb, got, want

    for p, kappa in K8_CASES:
        w = torch.randn(p, device="cuda", generator=g)
        w[::97] = 0.5 * torch.sign(w[::97])
        n8, n9, nb = (k2.COUNT_SINGLE.launches, k2.MASK_SINGLE.launches,
                      k2.TOPK.launches)
        theta = pops.topk_mask(w, kappa)
        torch.cuda.synchronize()
        check((k2.COUNT_SINGLE.launches - n8, k2.MASK_SINGLE.launches - n9,
               k2.TOPK.launches - nb) == (0, 1, 1),
              f"K8 top-κ at P={p}: one fused bisection and one K9 a call")
        check(torch.equal(theta, torch.where(topk_magnitude_mask(w, kappa),
                                             w, 0.0)),
              f"K8 top-κ at P={p}: mask differs from the exact top-κ")
        t = w.abs().kthvalue(p - kappa).values
        for tt in (t, torch.zeros_like(t), w.abs().amax()):
            check(torch.equal(k2.count_above(w, tt),
                              k2.count_above_plain(w, tt)),
                  f"K8 counts at P={p}")
        row("K8", (p,), (lambda: k2.count_above(w, t),
                         lambda: k2.count_above_plain(w, t)),
            4.0 * p + 8.0, 2.0 * p)
        if p == LENET_WEIGHTS:
            # the library yardstick: hardshrink(w, t) = w·1[|w| > t]
            t_f = float(t)
            got = k2.mask_apply(w, t)
            check(torch.equal(got, k2.mask_apply_plain(w, t)), "K9 mask")
            check(torch.equal(got, F.hardshrink(w, t_f)),
                  "K9 against hardshrink")
            row("K9", (p,), (lambda: k2.mask_apply(w, t),
                             lambda: k2.mask_apply_plain(w, t),
                             lambda: F.hardshrink(w, t_f)),
                8.0 * p + 4.0, 2.0 * p)
        del w, theta
    torch.cuda.empty_cache()
    return rec


def host_launch_cost(k1, k2, card: str, n: int = 1000,
                     rounds: int = 7) -> None:
    """The host's share of the single passes' launch path: the host time
    to queue ``n`` launches of K1, K7, K2 and K8 at path G's LeNet300
    shapes with no sync between them (wall time on the host), per
    launch, the median of ``rounds`` rounds taken in turns. Uses only
    the wrappers' public API, so that ``python3 chip_smoke.py
    --host-cost`` times another checkout's launch path with the same
    code."""
    g = torch.Generator(device="cuda").manual_seed(11)
    w0 = torch.randn(K7_SHAPES[0][0], device="cuda", generator=g)
    cb = torch.sort(torch.randn(4, device="cuda", generator=g)).values
    w_all = torch.randn(LENET_WEIGHTS, device="cuda", generator=g)
    t = w_all.abs().kthvalue(LENET_WEIGHTS - LENET_KAPPA).values
    w0b, cbb, w_allb, tb = w0[None], cb[None], w_all[None], t.reshape(1)
    calls = {
        "K1": ([1, K7_SHAPES[0][0], 4],
               lambda: k1.kmeans_assign_moments_batched(w0b, cbb)),
        "K7": ([K7_SHAPES[0][0], 4], lambda: k1.kmeans_assign_moments(w0, cb)),
        "K2": ([1, LENET_WEIGHTS],
               lambda: k2.count_above_batched(w_allb, tb, False)),
        "K8": ([LENET_WEIGHTS], lambda: k2.count_above(w_all, t))}
    wall = {name: [] for name in calls}
    for _, fn in calls.values():
        fn()
    torch.cuda.synchronize()
    for r in range(rounds):
        names = list(calls) if r % 2 == 0 else list(calls)[::-1]
        for name in names:
            fn = calls[name][1]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(n):
                fn()
            t1 = time.perf_counter()
            torch.cuda.synchronize()
            wall[name].append((t1 - t0) / n * 1e6)
    for name, (shape, _) in calls.items():
        print(f"host launch path {name} {shape}: wall_us="
              f"{statistics.median(wall[name]):.3f} a launch ({n} queued "
              f"without a sync, median of {rounds} rounds in turns; wall "
              f"over rounds {min(wall[name]):.3f}-{max(wall[name]):.3f}) "
              f"[{card}]", flush=True)


def main_path_e(kern, power: str) -> dict:
    """``repro_torch.mixed_compression.main`` on the card: both runs, 20
    LC steps each, checked after every C step."""
    from repro_torch import mixed_compression
    seen = []

    def after_c_step(model, lc, m):
        now = launches(kern)
        step = {n: now[n] - last[n] for n in now}
        last.update(now)
        tasks = lc["tasks"]
        if "p1" in tasks:             # Table 2 last row
            nnz = int(torch.count_nonzero(tasks["p1"]["theta"]["theta"]))
            th = tasks["lr2"]["theta"]
            rank = int(torch.linalg.matrix_rank(th["u"] @ th["v"].T))
            ok = (nnz == 5000 and rank == 10
                  and th["u"].shape == (300, 10)
                  and th["v"].shape == (100, 10)
                  # one fused bisection and K3; one fused Lloyd loop
                  and step == only(kern, K1loop=1, K2loop=1, K3=1))
            seen.append(("mixed", nnz, rank, step))
        else:                         # row 5: the additive combination
            nnz = int(torch.count_nonzero(
                tasks["pq"]["theta"]["parts"][0]["theta"]))
            ok = nnz == 2662 and step == only(kern)
            seen.append(("additive", nnz, None, step))
        check(ok, f"path E after C step {m.step}: {seen[-1]}")

    reset(kern)
    last = launches(kern)
    t0 = time.time()
    out = mixed_compression.main(device="cuda", callbacks=[after_c_step])
    torch.cuda.synchronize()
    wall = time.time() - t0
    check([s[0] for s in seen] == ["mixed"] * 20 + ["additive"] * 20,
          f"path E C steps {[s[0] for s in seen]}")
    total = launches(kern)
    check(total == only(kern, K1loop=20, K2loop=20, K3=20),
          f"path E launches {total}")
    for run, (j_err, j_ratio) in zip(out["runs"], JAX_CPU_MIXED["runs"]):
        lc, dc = run["lc"], run["dc"]
        check(monitor_ok(lc["history"]), f"path E §7 monitor {run['name']}")
        check(lc["test_err"] <= dc["test_err"] + 1e-6,
              f"path E LC > DC {run['name']}")
        check(abs(lc["ratio"] - j_ratio) < 0.05,
              f"path E ratio {lc['ratio']} against JAX's {j_ratio}")
        print(f"main path E {run['name']}: dc_err={dc['test_err']:.4f} "
              f"lc_err={lc['test_err']:.4f} ratio={lc['ratio']:.1f}x "
              f"lc_wall_s={lc['wall_s']:.2f} ref_err={out['ref']:.4f} "
              f"(JAX package on the CPU, on its own problem: ref_err="
              f"{JAX_CPU_MIXED['ref']:.4f} lc_err={j_err:.4f} "
              f"ratio={j_ratio}x) [{power}]", flush=True)
    print(f"main path E: ref_err={out['ref']:.4f} total_wall_s={wall:.2f} "
          f"launches={total} [{power}]", flush=True)
    return {"launches": total, "problem": out["problem"]}


def main_path_g(kern, k1, prob, power: str) -> dict:
    """The single-vector kernel API on the trained LeNet300: the Lloyd
    loop (one fused launch at I = 1) on l0 at K=4 and top-κ (one fused
    bisection with K8's rules, then K9) over all weights at κ = 5%; then
    the single passes of the API on their results: K7 and K1 recount the
    final clusters, K8 and K2 the kept weights."""
    from repro_torch.core.schemes.prune import topk_magnitude_mask
    from repro_torch.core.schemes.quantize import quantile_init
    from repro_torch.kernels.kmeans import kmeans
    from repro_torch.kernels.kmeans import ops as kops
    from repro_torch.kernels.prune import topk_mask
    from repro_torch.kernels.prune.prune import (
        count_above, count_above_batched)
    w0 = prob.params["l0"]["w"].reshape(-1)
    w_all = torch.cat([prob.params[f"l{i}"]["w"].reshape(-1)
                       for i in range(3)])
    check((w0.numel(), w_all.numel()) == (K7_SHAPES[0][0], LENET_WEIGHTS),
          "LeNet300 sizes")
    cb0 = quantile_init(w0, 4)
    reset(kern)
    torch.cuda.synchronize()
    t0 = time.time()
    cb, assign = kmeans(w0, cb0, iters=20)
    theta = topk_mask(w_all, LENET_KAPPA)
    torch.cuda.synchronize()
    wall = time.time() - t0
    a7, _, c7 = kops.assign_moments(w0, cb)
    a1, _, c1 = kops.assign_moments_batched(w0[None], cb[None])
    n8 = count_above(theta, 0.0)
    n2 = count_above_batched(theta[None], theta.new_zeros(1), strict=True)
    torch.cuda.synchronize()
    n = launches(kern)
    check(n == only(kern, K1loop=1, K2loop=1, K9=1, K1=1, K7=1, K2=1, K8=1),
          f"path G launches {n}")
    check(torch.equal(a7, assign) and torch.equal(a1[0], assign)
          and torch.equal(c1[0], c7) and int(c7.sum()) == w0.numel(),
          "path G: K7/K1 passes differ from the Lloyd loop's assignment")
    check(int(n8) == LENET_KAPPA and n2.tolist() == [LENET_KAPPA],
          f"path G: K8/K2 count {int(n8)}, {n2.tolist()} kept weights")
    # the batched solvers on the same inputs (K1, and the exact top-κ)
    cb_b, assign_b = kops.kmeans_batched(w0[None], cb0[None], iters=20,
                                         impl="kernel")
    check(torch.equal(cb, cb_b[0]) and torch.equal(assign, assign_b[0]),
          "path G: K7 Lloyd loop differs from K1's")
    check(int(torch.count_nonzero(theta)) == LENET_KAPPA
          and torch.equal(theta, torch.where(
              topk_magnitude_mask(w_all, LENET_KAPPA), w_all, 0.0)),
          "path G: top-κ differs from the exact top-κ")
    check(bool(torch.isfinite(cb).all()) and bool((cb[1:] > cb[:-1]).all()),
          f"path G codebook {cb.tolist()}")
    print(f"main path G (kernel API on LeNet300): kmeans K=4 on l0 "
          f"codebook={[round(x, 5) for x in cb.tolist()]}, top-κ "
          f"κ={LENET_KAPPA} of {LENET_WEIGHTS}: wall_s={wall:.3f} "
          f"(the two loops) "
          f"launches={n} [{power}]", flush=True)
    return n


def stepped_spectrum(k: int, steps, rho: float, drop: float):
    """σ_j = ρ^j up to the last step, times ``drop`` at every step, flat
    after the last: geometric decay with clean gaps at ``steps``."""
    j = torch.arange(k, dtype=torch.float32, device="cuda")
    s = rho ** torch.clamp(j, max=steps[-1])
    for st in steps:
        s = torch.where(j >= st, s * drop, s)
    return s


def lowrank_model(cfg, seed: int):
    """phi3-mini weights from ``seed`` whose low-rank targets have stepped
    geometric spectra (a random Gaussian matrix's spectrum is flat, and
    rank selection then picks 0 or its maximum): LowRank targets decay
    from 1 to 0.7 over their target rank and drop ×0.15 after it; wo
    decays as 0.994^j with ×0.3 drops at the two ranks its α values
    select. The drops separate the top-r subspace from the rest, and each
    spectrum spans a dynamic range of at most 15 over its sketch: beyond
    that the reference's Jacobi sweep counts (6 and 12) stop converging
    at sketch widths of 144–272 and the ≤ 1e-4 distortion budget fails
    in both packages. Scaled so that ‖W‖_F² = n, as for weights of std
    1/√fan_in. Returns ``(params, {path: σ})``."""
    from repro_torch.core import get_path
    from repro_torch.models import transformer as tf
    gen = torch.Generator(device="cuda").manual_seed(seed)
    params = tf.init_params(gen, cfg)
    spectra = {}
    with torch.no_grad():
        for i in range(LM_LAYERS):
            for name in ("mixer/wq", "mixer/wk", "mixer/wv", "mixer/wo",
                         "ffn/w_gate", "ffn/w_up"):
                path = f"stages/s0/pos{i}/{name}"
                w = get_path(params, path)
                m, n = w.shape
                k = min(m, n)
                leaf = name.split("/")[1]
                if leaf == "wo":
                    s = stepped_spectrum(k, F_WO_STEPS, 0.994, 0.3)
                else:
                    r = F_RANKS[leaf]
                    s = stepped_spectrum(k, (r,), 0.7 ** (1.0 / r), 0.15)
                s = s * (math.sqrt(n) / float(s.norm()))
                u = torch.linalg.qr(torch.randn((m, k), device="cuda",
                                                generator=gen))[0]
                v = torch.linalg.qr(torch.randn((n, k), device="cuda",
                                                generator=gen))[0]
                w.copy_((u * s) @ v.T)
                spectra[path] = s
    return params, spectra


def jacobi_kernels_per_round() -> float:
    """CUDA kernels one Jacobi round launches, from ``torch.profiler``
    over one and two sweeps at the sketch width 144 (run after the timed
    paths: the profiler slows every later launch of the process)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity
    from repro_torch.kernels.lowrank.lowrank import jacobi_eigh_batched
    a = torch.randn((12, 144, 144), device="cuda")
    a = a @ a.transpose(1, 2)
    counts = []
    for sweeps in (1, 2):
        torch.cuda.synchronize()
        with profiled([ProfilerActivity.CUDA]) as prof:
            jacobi_eigh_batched(a, sweeps=sweeps)
            torch.cuda.synchronize()
        counts.append(sum(e.count for e in prof.key_averages()
                          if e.device_type == DeviceType.CUDA))
    return (counts[1] - counts[0]) / 143


def main_path_f(kern, power: str) -> dict:
    """Low-rank serving of phi3-mini at full width: LC init, one C step
    and a multiplier step over 28 per-matrix tasks in four groups, the
    bridge, ``Server.generate``; then the checks against the exact SVD
    and the densified model."""
    from repro_torch.core import (
        AsIs, AsVector, CompressionTask, LCAlgorithm, flatten_params,
        get_path)
    from repro_torch.core.grouping import build_groups, grouped_compress
    from repro_torch.core.schemes import (
        AdaptiveQuantization, AdditiveCombination, ConstraintL0Pruning,
        LowRank, RankSelection)
    from repro_torch.kernels.lowrank.ops import OVERSAMPLE, POWER_ITERS
    from repro_torch.runtime import server as srv
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = serving_config()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    params, spectra = lowrank_model(cfg, seed=7)
    torch.cuda.synchronize()
    t_weights = time.time() - t0
    n_params = sum(t.numel() for t in flatten_params(params).values())

    # α per layer: rank selection's optimum at step F_WO_STEPS[i % 2],
    # α·(m+n) = μ/2·σ_{r-1}·σ_r between the two squared singular values
    alphas = []
    tasks = []
    for i in range(LM_LAYERS):
        pre = rf"^stages/s0/pos{i}/"
        s = spectra[f"stages/s0/pos{i}/mixer/wo"]
        r = F_WO_STEPS[i % 2]
        alphas.append(F_MU / 2 * float(s[r - 1] * s[r])
                      / (2 * LM_D_MODEL))
        tasks += [CompressionTask(f"{leaf}{i}", pre + f"mixer/{leaf}$",
                                  AsIs(), LowRank(F_RANKS[leaf]))
                  for leaf in ("wq", "wk", "wv")]
        tasks += [
            CompressionTask(f"wo{i}", pre + "mixer/wo$", AsIs(),
                            RankSelection(alpha=alphas[i],
                                          max_rank=F_WO_MAX_RANK)),
            CompressionTask(f"gate{i}", pre + "ffn/w_gate$", AsIs(),
                            LowRank(F_RANKS["w_gate"])),
            CompressionTask(f"up{i}", pre + "ffn/w_up$", AsIs(),
                            LowRank(F_RANKS["w_up"])),
            CompressionTask(f"down{i}", pre + "ffn/w_down$", AsVector(),
                            AdditiveCombination(
                                [ConstraintL0Pruning(F_DOWN_KAPPA),
                                 AdaptiveQuantization(k=16)], iters=2))]
    check(len(tasks) == 7 * LM_LAYERS, "path F tasks")
    rng = np.random.default_rng(8)
    prompts = rng.integers(0, cfg.vocab_size, (SERVE_BATCH, SERVE_PROMPT),
                           dtype=np.int64).astype(np.int32)

    lc = LCAlgorithm(tasks, [F_MU], device="cuda")
    groups = lc.group_summary(params)
    summary = [(g["solver"], g["items"], tuple(g["item_shape"]))
               for g in groups]
    want = [("lowrank_rsvd", 12, (LM_D_MODEL, LM_D_MODEL)),
            ("rank_select", 4, (LM_D_MODEL, LM_D_MODEL)),
            ("lowrank_rsvd", 8, (LM_D_MODEL, LM_D_FF)),
            (None, 4, (LM_D_FF * LM_D_MODEL,))]
    check(summary == want and all(g["grouped"] for g in groups),
          f"path F groups {summary}")
    print("path F groups:", [(g["scheme"], g["solver"], g["backend"],
                              g["items"], g["item_shape"]) for g in groups],
          flush=True)

    reset(kern)
    torch.cuda.synchronize()
    t0 = time.time()
    state = lc.init(params)
    torch.cuda.synchronize()
    t_init = time.time() - t0
    t0 = time.time()
    state = lc.c_step(params, state)
    torch.cuda.synchronize()
    t_cstep = time.time() - t0
    state = lc.multiplier_step(params, state)
    t0 = time.time()
    serving, report = srv.load_compressed_for_serving(params, state,
                                                      lc.tasks)
    torch.cuda.synchronize()
    t_bridge = time.time() - t0
    server = srv.Server(cfg, serving, max_len=SERVE_MAX_LEN, device="cuda")
    t0 = time.time()
    res = server.generate(prompts, SERVE_GEN)
    torch.cuda.synchronize()
    t_gen = time.time() - t0
    n = launches(kern)
    peak = torch.cuda.max_memory_allocated() / 2**30

    kinds = sorted(f.split("(")[0] for fs in report.values()
                   for f in fs.values())
    check(kinds == ["dense"] * LM_LAYERS + ["lowrank"] * 6 * LM_LAYERS,
          f"path F bridged forms {kinds}")
    # the prefill's 4 fused attention launches; the C step's solvers
    # are matmul programs, the additive parts run item by item
    check(n == only(kern, K6=LM_LAYERS), f"path F launches {n}")
    toks = res.tokens
    check(toks.shape == (SERVE_BATCH, SERVE_GEN) and toks.min() >= 0
          and toks.max() < cfg.vocab_size, f"path F tokens {toks.shape}")
    # per solver call (warm start): 1 + (POWER_ITERS − 1) range-finder
    # orthonormalizations of 6 sweeps and a finisher of 12, each sweep
    # k − 1 rounds at the sketch width k = r_max + OVERSAMPLE
    sweeps = POWER_ITERS * 6 + 12
    rounds = sum(sweeps * (min(r_max + OVERSAMPLE, LM_D_MODEL) - 1)
                 for r_max in (F_RANKS["wq"], F_WO_MAX_RANK,
                               F_RANKS["w_gate"]))
    print(f"main path F (phi3-mini-3.8b full width, {LM_LAYERS} layers, "
          f"{n_params:,} params, low rank): weights_s={t_weights:.2f} "
          f"init_s={t_init:.2f} c_step_s={t_cstep:.2f} "
          f"bridge_s={t_bridge:.3f} generate_s={t_gen:.3f} "
          f"({SERVE_BATCH}x{SERVE_PROMPT} prompt, {SERVE_GEN} new tokens) "
          f"peak_memory_gib={peak:.2f} launches={n} jacobi_rounds_per_c_step="
          f"{rounds} (warm start: {POWER_ITERS - 1} power iterations) "
          f"[{power}]", flush=True)

    # checks, outside the counted run: ranks and distortion against the
    # exact SVD (on the card, as a check only), logits against the
    # densified model
    worst, ranks = 0.0, []
    for t in lc.tasks:
        if t.name.startswith("down"):
            continue
        (path,) = t.paths
        w = get_path(params, path).float()     # λ = 0: the C step's input
        th = state["tasks"][t.name]["theta"]
        s = torch.linalg.svdvals(w)
        if t.name.startswith("wo"):
            r = int(th["rank"])
            m, nn = w.shape
            tail = torch.cat([torch.flip(torch.cumsum(torch.flip(
                s * s, (0,)), 0), (0,)), s.new_zeros(1)])[:F_WO_MAX_RANK + 1]
            obj = (t.scheme.alpha * (m + nn)
                   * torch.arange(F_WO_MAX_RANK + 1, device="cuda")
                   + 0.5 * F_MU * tail)
            r_exact = int(torch.argmin(obj))
            check(0 < r < F_WO_MAX_RANK and r == r_exact,
                  f"path F {t.name}: selected rank {r}, exact spectrum "
                  f"{r_exact}")
            ranks.append(r)
        else:
            r = t.scheme.rank
        d = float(torch.sum((w - th["u"] @ th["v"].T) ** 2))
        d_opt = float(torch.sum(s[r:] ** 2))
        excess = (d - d_opt) / d_opt
        check(excess <= 1e-4, f"path F {t.name}: distortion {d} against "
              f"the exact rank-{r} {d_opt} (excess {excess:.3g})")
        worst = max(worst, excess)
    check(ranks == [F_WO_STEPS[i % 2] for i in range(LM_LAYERS)],
          f"path F wo ranks {ranks}")
    print(f"path F vs exact SVD: wo ranks={ranks} (exact-spectrum optimum "
          f"each) worst distortion excess={worst:.3g} (tol 1e-4)",
          flush=True)

    dense = srv.densified_for_serving(params, state, lc.tasks)
    prompts_t = torch.as_tensor(prompts, device="cuda")
    toks_t = torch.as_tensor(toks, device="cuda")
    agree = against_densified("path F", cfg, serving, dense, prompts_t,
                              toks_t, power)
    check(agree == 1.0, f"path F token agreement {agree}")
    del dense, serving, server

    # per-group solver seconds, each group re-run alone from the same
    # state (its C-step input and warm start), with the planner off and
    # on (Θ bit for bit); then each low-rank group captured as a CUDA
    # graph (compile_group) against its eager runs at two μ
    from repro_torch.tree import tree_leaves
    xs = {t.name: t.shifted_compressible(params, state["tasks"][t.name],
                                         state["mu"]) for t in lc.tasks}
    thetas = {t.name: state["tasks"][t.name]["theta"] for t in lc.tasks}
    times, captured = [], []
    for group in build_groups(lc.tasks, xs, backend="auto", device="cuda"):
        res = {}
        for planner in (None, "on"):
            torch.cuda.synchronize()
            t0 = time.time()
            res[planner] = grouped_compress(group, xs, thetas, state["mu"],
                                            backend="auto", device="cuda",
                                            planner=planner)
            torch.cuda.synchronize()
        times.append((group[0].scheme.name, len(group),
                      round(time.time() - t0, 3)))
        check(all(torch.equal(a, b) for t in group for a, b in zip(
            tree_leaves(res[None][t.name]), tree_leaves(res["on"][t.name]))),
            f"path F {group[0].scheme.name}: planner on and off differ")
        del res
        if group[0].scheme.solver in ("lowrank_rsvd", "rank_select"):
            captured.append(captured_against_eager(
                f"path F {group[0].scheme.name} group of {len(group)}",
                group, xs, thetas, (state["mu"], state["mu"] * 2.0), power))
    print(f"path F solver seconds per group (re-run alone, planner on; "
          f"Θ bit for bit with the planner off): {times} [{power}]",
          flush=True)
    eager = sum(c["eager_s"][0] for c in captured)
    replay = sum(c["replay_s"][-1] for c in captured)
    print(f"path F low-rank groups, C-step seconds at mu={float(state['mu'])}:"
          f" eager {eager:.3f} against captured {replay:.3f} (capture "
          f"calls {sum(c['capture_s'] for c in captured):.3f}) [{power}]",
          flush=True)
    del params, state, xs, thetas
    torch.cuda.empty_cache()
    return n


def profile_phase(kern, path_c: dict, power: str) -> None:
    """Device busy share and top kernels of an LM C step (the LM phase's
    problem made again, after one warm C step), of path C's prefill and
    of 8 of its decode steps, under ``torch.profiler``; run after the
    timed paths so that the profiler's hooks touch none of their
    numbers."""
    params, lc = lm_problem(torch.Generator(device="cuda").manual_seed(1))
    state = lc.c_step(params, lc.init(params))
    device_profile(lambda: lc.c_step(params, state), "LM C step", power,
                   kern)
    del params, lc, state
    torch.cuda.empty_cache()
    from repro_torch.models import transformer as tf
    from repro_torch.models.layers import unembed
    from repro_torch.runtime import server as srv
    cfg, serving = path_c["cfg"], path_c["serving"]
    prompts, toks = path_c["prompts"], path_c["tokens"]

    @torch.inference_mode()
    def prefill():
        hidden, _, caches = tf.forward_hidden(serving, prompts, cfg,
                                              return_caches=True)
        unembed(serving["embed"], hidden[:, -1:], cfg)
        return srv.pad_caches_to(caches, cfg, SERVE_PROMPT, SERVE_MAX_LEN)

    @torch.inference_mode()
    def decode(caches, n_steps=8):
        for i in range(n_steps):
            tf.decode_step(serving, caches, toks[:, i:i + 1],
                           SERVE_PROMPT + i, cfg)

    def report(label, fn):
        dev, _ = device_profile(fn, f"path C {label}", power, kern)
        k45 = [e for e in dev if "quant_" in e.key]
        print(f"path C {label}: K4/K5 kernels x"
              f"{sum(e.count for e in k45)} device_ms="
              f"{sum(e.self_device_time_total for e in k45) / 1e3:.3f} "
              f"[{power}]", flush=True)

    report("prefill (B=2, S=512, compressed)", prefill)
    caches = prefill()
    report("8 decode steps (M=2, compressed)", lambda: decode(caches))


def device_times(k2, k6, k9_row: dict, k6_row: dict, card: str) -> None:
    """K9 and ``F.hardshrink`` at P = 266,200, and K6 and SDPA at K6's main
    row, under ``torch.profiler``: the summed device time of 50 calls
    each, beside their CUDA-event times from the timed phases (``k9_row``,
    ``k6_row``), which hold the host's share of a call too. Runs after the
    timed phases (a profiler session slows every later launch)."""
    g = torch.Generator(device="cuda").manual_seed(6)
    w = torch.randn(LENET_WEIGHTS, device="cuda", generator=g)
    t = w.abs().kthvalue(LENET_WEIGHTS - LENET_KAPPA).values
    t_f = float(t)
    check(torch.equal(k2.mask_apply(w, t), F.hardshrink(w, t_f)),
          "K9 against hardshrink (profiled)")
    b, s, h, kvh, d, _, _ = K6_SHAPES[0]
    q = torch.randn((b, kvh, h // kvh, s, d), device="cuda", generator=g)
    k = torch.randn((b, kvh, s, d), device="cuda", generator=g)
    v = torch.randn((b, kvh, s, d), device="cuda", generator=g)
    qh = q.reshape(b, h, s, d)
    dev_ms = {}
    for name, fn in (
            ("K9", lambda: k2.mask_apply(w, t)),
            ("hardshrink", lambda: F.hardshrink(w, t_f)),
            ("K6", lambda: k6.flash_attention(q, k, v)),
            ("SDPA", lambda: F.scaled_dot_product_attention(
                qh, k, v, is_causal=True, enable_gqa=True))):
        fn()
        torch.cuda.synchronize()
        dev = device_trace(lambda: [fn() for _ in range(50)],
                           50 if name in ("K9", "K6") else 0, name)
        check(bool(dev), f"{name}: the profiler saw no device time")
        dev_ms[name] = sum(e.self_device_time_total for e in dev) / 1e3 / 50
    print(f"K9 P={LENET_WEIGHTS} device_ms={dev_ms['K9']:.5f} "
          f"hardshrink device_ms={dev_ms['hardshrink']:.5f} (profiler, 50 "
          f"calls each); event ms K9={k9_row['ms']:.4f} "
          f"hardshrink={k9_row['library_ms']:.4f} [{card}]", flush=True)
    print(f"K6 {list(K6_SHAPES[0])} device_ms={dev_ms['K6']:.4f} SDPA "
          f"device_ms={dev_ms['SDPA']:.4f} (profiler, 50 calls each); "
          f"event ms K6={k6_row['ms']:.4f} SDPA={k6_row['library_ms']:.4f} "
          f"[{card}]", flush=True)


def quant_device_times(k45, srec: dict, card: str) -> None:
    """K4 and K5 at the serving paths' shapes (decode M = 2 and 8, the
    engine's prefill tick M = 256, prefill M = 1024) under ``torch.profiler``: the summed device time
    of 50 calls, the weight rotated over enough copies to exceed the
    50 MB L2 (as a decode step finds it), beside the bytes bound and the
    CUDA-event time of the row in phase 7. Runs after the timed phases
    (a profiler session slows every later launch)."""
    from repro_torch.kernels.quant_matmul import ops as qops
    g = torch.Generator(device="cuda").manual_seed(7)
    for name, k, n, c in (("K4", 3072, 8192, 16), ("K5", 3072, 3072, 64)):
        idx = torch.randint(0, c, (k, n), device="cuda", generator=g,
                            dtype=torch.uint8)
        cb = torch.sort(torch.randn(c, device="cuda", generator=g)).values \
            / math.sqrt(k)
        w0 = qops.pack4(idx) if name == "K4" else idx
        copies = max(6, math.ceil(60e6 / w0.numel()))
        ws = [w0.clone() for _ in range(copies)]
        fn, plain = ((k45.quant_matmul_packed, k45.quant_matmul_packed_plain)
                     if name == "K4" else
                     (k45.quant_matmul, k45.quant_matmul_plain))
        for m in SERVE_M:
            x = torch.randn((m, k), device="cuda", generator=g)
            torch.testing.assert_close(fn(x, ws[1], cb), plain(x, w0, cb),
                                       rtol=1e-5, atol=1e-4)
            torch.cuda.synchronize()
            dev = [e for e in device_trace(
                lambda: [fn(x, ws[i % copies], cb) for i in range(50)], 50,
                f"{name} M={m}") if "quant_" in e.key]
            check(sum(e.count for e in dev) == 50,
                  f"{name} M={m}: the profiler saw {dev}")
            dev_ms = sum(e.self_device_time_total for e in dev) / 1e3 / 50
            bytes_ms = (4.0 * m * k + w0.numel() + 4.0 * c
                        + 4.0 * m * n) / HBM_BYTES_PER_S * 1e3
            row = next(r for r in srec[name]
                       if r["shape"] == [m, k, n, c])
            print(f"{name} M={m} K={k} N={n} C={c} cold L2 ({copies} weight "
                  f"copies): device_ms={dev_ms:.5f} (profiler, 50 calls) "
                  f"bytes_bound_ms={bytes_ms:.5f} "
                  f"({bytes_ms / dev_ms:.0%} of it) bound_ms="
                  f"{row['bound_ms']:.5f} ({row['bound_by']}) "
                  f"event_ms={row['ms']:.4f} [{card}]", flush=True)
        del ws, w0, idx
    torch.cuda.empty_cache()


def cstep_device_times(k1, k2, rec: dict, mrec: dict, frec: dict,
                       card: str) -> None:
    """The C-step kernels' device time under ``torch.profiler``: all the
    device work of one call (its kernels and any fill it launches),
    summed over several calls and divided by them, with cold L2. At the
    LM widths the operands exceed the 50 MB L2; at LeNet300 widths each
    call takes the next of enough operand copies to exceed it (a fused
    loop then finds only its first pass cold, as on the main path). K1,
    K2, K3, K7 and K8 and the two fused loops at their main paths'
    shapes, beside their CUDA-event times and bounds from the timed
    phases (``rec``, ``mrec``, ``frec``). Runs after the timed phases (a
    profiler session slows every later launch)."""
    g = torch.Generator(device="cuda").manual_seed(10)

    def device_ms(call, n_calls: int) -> float:
        call(0)
        torch.cuda.synchronize()
        dev = device_trace(lambda: [call(j) for j in range(n_calls)],
                           n_calls, "C-step kernel device time")
        return sum(e.self_device_time_total for e in dev) / 1e3 / n_calls

    def operands(i, p, k=None):
        n = 1 if i * p * 4 > 60e6 else math.ceil(60e6 / (i * p * 4))
        ws = [torch.randn((i, p), device="cuda", generator=g)
              for _ in range(n)]
        cb = None if k is None else torch.sort(torch.randn(
            (i, k), device="cuda", generator=g), dim=-1).values
        return ws, cb

    def report(name, shape, rows, call, ws, n_calls=None, match=None):
        row = next(r for r in rows if r["shape"][:len(shape)] == shape
                   and (match is None or match(r)))
        n_calls = n_calls or (10 if len(ws) == 1 else 50)
        ms = device_ms(call, n_calls)
        floor = (f" design_floor_ms={row['floor_ms']:.4g}"
                 if "floor_ms" in row else "")
        print(f"{name} {shape} cold L2 ({len(ws)} operand copies): "
              f"device_ms={ms:.5f} (profiler, {n_calls} calls) "
              f"event_ms={row['ms']:.4f} plain_ms={row['plain_ms']:.4f} "
              f"bound_ms={row['bound_ms']:.4g} ({row['bound_by']}; "
              f"{row['bound_ms'] / ms:.0%} of it){floor} [{card}]",
              flush=True)

    for i, p, k, _, iters in LLOYD_CASES[:2]:
        ws, cb = operands(i, p, k)
        report("Lloyd loop", [i, p, k, iters], frec["lloyd"],
               lambda j: k1.kmeans_lloyd_batched(ws[j % len(ws)], cb,
                                                 iters), ws,
               n_calls=3 if len(ws) == 1 else 20)
        report("K1", [i, p, k], rec["K1"]["rows"],
               lambda j: k1.kmeans_assign_moments_batched(
                   ws[j % len(ws)], cb), ws)
        if i == 1:
            report("K7", [p, k], mrec["K7"],
                   lambda j: k1.kmeans_assign_moments(ws[j % len(ws)][0],
                                                      cb[0]), ws)
        del ws, cb
        torch.cuda.empty_cache()

    for i, p, kappa, strict, _ in TOPK_CASES[:3]:
        ws, _ = operands(i, p)
        if i == LM_LAYERS:
            ws = [w * 0.02 for w in ws]                  # w_down's scale
        kap = torch.tensor(kappa, dtype=torch.int32, device="cuda")
        report(f"bisection strict={strict}", [i, p], frec["topk"],
               lambda j: k2.topk_threshold_batched(ws[j % len(ws)], kap, 30,
                                                   strict), ws,
               n_calls=5 if len(ws) == 1 else 20,
               match=lambda r: r["strict"] == strict)
        t = ws[0].abs().amax(dim=-1) * 0.3
        if strict:
            report("K8", [p], mrec["K8"],
                   lambda j: k2.count_above(ws[j % len(ws)][0], t[0]), ws)
            continue
        report("K2", [i, p], rec["K2"]["rows"],
               lambda j: k2.count_above_batched(ws[j % len(ws)], t, False),
               ws)
        if i == LM_LAYERS:
            report("K3", [i, p], mrec["K3"],
                   lambda j: k2.mask_apply_batched(ws[j % len(ws)], t,
                                                   False), ws)
        del ws, t
        torch.cuda.empty_cache()


# ----------------------------------------------------------------------
# path H: the LC trainer at phi3-mini width
# ----------------------------------------------------------------------
def h_config(layers: int = LM_LAYERS):
    """phi3-mini-3.8b at full width, ``layers`` of its 32 layers, float32,
    remat on, plain attention (K6 has no backward, and refuses autograd)."""
    from repro_torch.configs import get_config
    cfg = get_config("phi3-mini-3.8b").with_(
        pattern_reps=layers, dtype="float32", remat=True,
        fused_attention=False)
    check((cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim,
           cfg.d_ff, cfg.vocab_size, cfg.tie_embeddings)
          == (LM_D_MODEL, 32, 32, 96, LM_D_FF, 32064, False),
          "phi3-mini widths")
    return cfg


def h_trainer(cfg, compression: str, n_lc: int, steps_per_l: int,
              faults=None, **tcfg):
    """``launch/train.py``'s tasks and defaults on the card: an LCTrainer
    over the port's TokenStream (batches of H_BATCH × H_SEQ)."""
    from repro_torch.core import LCAlgorithm, exponential_mu_schedule
    from repro_torch.data import TokenStream
    from repro_torch.launch.train import default_tasks
    from repro_torch.runtime import LCTrainer, TrainerConfig
    lc = LCAlgorithm(default_tasks(cfg, compression),
                     exponential_mu_schedule(H_MU0, H_MU_A, n_lc),
                     device="cuda")
    return LCTrainer(cfg, lc, TokenStream(cfg.vocab_size, H_BATCH, H_SEQ),
                     tcfg=TrainerConfig(steps_per_l=steps_per_l, lr=H_LR,
                                        **tcfg),
                     fault_injector=faults, device="cuda")


def h_run(kern, trainer, label: str, power: str) -> dict:
    """Run ``trainer`` from seed 0 with every launch count at 0, CUDA
    events on the main stream around each train step (no sync), and the
    peak memory reset; check its records (one per μ, no §7 violation,
    finite losses) and print its times."""
    events = []
    step = trainer._train_step
    init_s = []
    lc_init = trainer.lc.init

    def timed_init(params):
        torch.cuda.synchronize()
        t0 = time.time()
        out = lc_init(params)
        torch.cuda.synchronize()
        init_s.append(time.time() - t0)
        return out

    trainer.lc.init = timed_init

    def timed(state, batch):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = step(state, batch)
        end.record()
        events.append((start, end))
        return out

    trainer._train_step = timed
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset(kern)
    t0 = time.time()
    state, lc_state = trainer.run(0)
    torch.cuda.synchronize()
    wall = time.time() - t0
    n = launches(kern)
    peak = torch.cuda.max_memory_allocated() / 2**30
    step_ms = [a.elapsed_time(b) for a, b in events]
    hist = trainer.history
    check(len(hist) == len(trainer.lc.mu_schedule), f"{label} records")
    for h in hist:
        check(h["c_step_violations"] == [], f"{label} §7 monitor {h}")
        check(math.isfinite(h["loss"]) and math.isfinite(h["ce"]),
              f"{label} losses {h['loss']} {h['ce']}")
    med = statistics.median(step_ms[1:]) if len(step_ms) > 1 else math.nan
    print(f"path H {label}: lc_wall_s={wall:.3f} init_s={init_s[0]:.3f} "
          f"steps={len(step_ms)} "
          f"first_step_ms={step_ms[0]:.2f} median_step_ms={med:.2f} "
          f"tokens_per_s={H_BATCH * H_SEQ / med * 1e3:.1f} "
          f"c_step_ms={[round(h['c_step_ms'], 2) for h in hist]} "
          f"loss={[round(h['loss'], 4) for h in hist]} "
          f"ce={[round(h['ce'], 4) for h in hist]} "
          f"ratio={hist[-1]['compression_ratio']:.4f} "
          f"peak_memory_gib={peak:.2f} launches="
          f"{ {k: v for k, v in n.items() if v} } [{power}]", flush=True)
    return {"state": state, "lc_state": lc_state, "launches": n,
            "history": hist, "wall_s": wall, "step_ms": step_ms}


def quant_ratio() -> float:
    """The reference's compression_ratio for path H's quantization: 32
    bits a weight against 4-bit indices and a 16-entry f32 codebook an
    item."""
    return 32.0 * H_WEIGHTS / sum(i * (p * 4 + 16 * 32) for i, p in H_GROUPS)


class Calls(list):
    """Captured calls ``(args, kw, result)``, with the item count that
    partitioned each (``build.partition_items``: a chunk of a planned
    group launches with its group's partition) and the seconds spent
    copying them to the host."""

    def __init__(self):
        super().__init__()
        self.partitions: list[int] = []
        self.copy_s = 0.0


def _host(x):
    return x.cpu() if isinstance(x, torch.Tensor) else x


@contextlib.contextmanager
def calls_of(module, name: str, first: int, to_host: bool = False):
    """Route ``module.name`` through a wrapper that keeps the arguments
    and the result of its calls from the ``first``-th (0-based) on, as
    references: the C step writes none of its solvers' operands or
    results in place (only ``a``), so they hold what the kernel saw.
    ``to_host`` keeps host copies instead, so that the card does not
    hold every chunk's operands through the C step."""
    from repro_torch.kernels.build import partition_items
    fn = getattr(module, name)
    calls = Calls()
    seen = [0]

    def wrapped(*args, **kw):
        out = fn(*args, **kw)
        if seen[0] >= first:
            calls.partitions.append(partition_items(args[0].shape[0]))
            kept_args, kept = args, out
            if to_host:
                t0 = time.perf_counter()
                kept_args = tuple(_host(a) for a in args)
                kept = tuple(_host(o) for o in out)
                calls.copy_s += time.perf_counter() - t0
            calls.append((kept_args, kw, kept))
        seen[0] += 1
        return out

    setattr(module, name, wrapped)
    try:
        yield calls
    finally:
        setattr(module, name, fn)


def check_h_lloyd(k1, calls, label: str, power: str) -> None:
    """The last C step's fused Lloyd loops of a path-H run, one a group,
    against the iterated and the plain loops on the operands they were
    launched with (``check_lloyd``)."""
    shapes = sorted(tuple(args[0].shape) for args, _, _ in calls)
    check(shapes == sorted(H_GROUPS), f"{label} Lloyd loops {shapes}")
    for (w, cb, iters), _, got in calls:
        err, moved = check_lloyd(k1, w, cb, iters, got,
                                 f"{label} Lloyd loop {tuple(w.shape)}")
        print(f"path H {label}: Lloyd loop I={w.shape[0]} P={w.shape[1]} "
              f"K={cb.shape[1]} iters={iters} of the last C step "
              f"bit-identical to the iterated loop, max|Δcb| vs plain "
              f"loop={err:.3g}, assignments differing from the plain "
              f"loop's={moved} [{power}]", flush=True)


def h_prune_run(kern, trainer, label: str, power: str) -> dict:
    """``h_run`` of a pruning trainer with Θ's count of nonzeros after
    every C step (``nnz``), and the last C step's bisection, K3 and Θ
    kept (``last``) for ``check_h_prune``."""
    from repro_torch.kernels.prune import ops as pops
    first = len(trainer.lc.mu_schedule) - 1
    nnz, theta = [], []
    c_step = trainer.lc.c_step

    def counted(params, lc_in):
        out = c_step(params, lc_in)
        theta[:] = [out["tasks"]["prune-all"]["theta"]["theta"]]
        nnz.append(int(torch.count_nonzero(theta[0])))
        return out

    trainer.lc.c_step = counted
    with calls_of(pops, "topk_threshold_batched", first) as bis, \
            calls_of(pops, "mask_apply_batched", first) as masks:
        r = h_run(kern, trainer, label, power)
    del trainer.lc.c_step           # the wrapper's cycle would keep Θ
    r.update(nnz=nnz, last=(bis, masks, theta[0]))
    return r


def check_h_prune(k2, last, kappa: int, label: str, power: str) -> None:
    """The last C step of a path-H pruning run on the operands its kernels
    were launched with: the fused bisection's (lo, hi, n_hi) equal to the
    iterated and the plain loops (``check_bisection``), K3's output equal
    to its plain version, and Θ equal to the exact top-κ of its input (a
    stable sort by magnitude, lower index first on ties): so the band
    that the fill takes in index order holds only weights of the top κ."""
    from repro_torch.core.schemes.prune import topk_magnitude_mask
    bis, masks, theta = last
    check(len(bis) == 1 and len(masks) == 1,
          f"{label}: {len(bis)} bisections, {len(masks)} K3 launches in "
          f"the last C step")
    (w, kap, iters), kw, got = bis[0]
    check(tuple(kap.tolist()) == (kappa,), f"{label} κ {kap.tolist()}")
    check_bisection(k2, w, kap, iters, kw.get("strict", False), got,
                    f"{label} bisection {tuple(w.shape)}")
    (mw, t), mkw, kept = masks[0]
    check(torch.equal(kept, k2.mask_apply_batched_plain(mw, t, **mkw)),
          f"{label}: K3 differs from its plain version")
    exact = torch.where(topk_magnitude_mask(w, kappa), w, 0.0)
    check(torch.equal(theta.reshape(w.shape), exact),
          f"{label}: Θ differs from the exact top-κ of its input")
    print(f"path H {label}: bisection I={w.shape[0]} P={w.shape[1]} "
          f"κ={kappa} iters={iters} of the last C step: (lo, hi, n_hi) "
          f"equal to the iterated and plain loops, K3 equal to its plain "
          f"version, Θ equal to the exact top-κ [{power}]", flush=True)


def main_path_h(kern, k1, k2, power: str) -> dict:
    """H1–H4: the LC trainer (``repro_torch.runtime.LCTrainer``) with
    AdamW L steps on phi3-mini-3.8b at full width."""
    from repro_torch.kernels.kmeans import ops as kops
    from repro_torch.tree import tree_leaves, tree_map
    cfg = h_config()
    paths = {}
    # a first train step at these shapes pays cuBLAS's and the
    # allocator's warm-up (seconds): take it before the timed runs
    trainer = h_trainer(cfg, "quantize", 1, 1)
    state = trainer.init_state(0)
    trainer._train_step(state, trainer._batch(0))
    del trainer, state
    torch.cuda.synchronize()
    torch.cuda.empty_cache()

    # H1: quantization, serial; one fused Lloyd loop a group at every C
    # step (the direct compression at init runs the scheme's own init,
    # the plain loop, as the reference's grouped_init does)
    trainer = h_trainer(cfg, "quantize", 3, 5)
    with calls_of(kops, "kmeans_lloyd_batched",
                  len(H_GROUPS) * (len(trainer.lc.mu_schedule) - 1)) as lloyd:
        r1 = h_run(kern, trainer, "H1 quantize serial", power)
    groups = trainer.lc.group_summary(r1["state"]["params"])
    got = sorted((g["items"], math.prod(g["item_shape"]), g["backend"])
                 for g in groups)
    check(got == sorted((i, p, "cuda") for i, p in H_GROUPS),
          f"H1 groups {got}")
    hist = r1["history"]
    check(hist[-1]["ce"] < hist[0]["ce"], f"H1 ce {hist[0]['ce']} -> "
          f"{hist[-1]['ce']}")
    check(all(abs(h["compression_ratio"] / quant_ratio() - 1) < 1e-12
              for h in hist), f"H1 ratio {hist[-1]['compression_ratio']}")
    want = len(H_GROUPS) * len(hist)
    check(r1["launches"] == only(kern, K1loop=want),
          f"H1 launches {r1['launches']} (want {want} Lloyd loops)")
    print(f"path H H1: groups {got}; launches as derived from the code: "
          f"{want} fused Lloyd loops ({len(H_GROUPS)} groups × "
          f"{len(hist)} C steps; none at init)", flush=True)
    paths["H1"] = r1["launches"]
    del trainer, r1
    torch.cuda.empty_cache()
    check_h_lloyd(k1, lloyd, "H1", power)
    del lloyd
    torch.cuda.empty_cache()

    # H2: the same run, overlapped: the C step on the side stream; the
    # first boundary's inputs and Θ kept for the equality check
    trainer = h_trainer(cfg, "quantize", 3, 5, overlap="on")
    lc = trainer.lc
    captured = []
    c_step_async = lc.c_step_async

    def capture(params, lc_in):
        out = c_step_async(params, lc_in)
        if not captured:
            captured.append((params, lc_in, out))
        return out

    lc.c_step_async = capture
    r2 = h_run(kern, trainer, "H2 quantize overlapped", power)
    hist = r2["history"]
    check(hist[-1]["ce"] < hist[0]["ce"], "H2 ce")
    check(all(abs(h["compression_ratio"] / quant_ratio() - 1) < 1e-12
              for h in hist), "H2 ratio")
    check(r2["launches"] == only(kern, K1loop=len(H_GROUPS) * len(hist)),
          f"H2 launches {r2['launches']}")
    print(f"path H H2: swap_after_microbatches="
          f"{[h['swap_after_microbatches'] for h in hist]} "
          f"dispatch_to_ready_ms={[round(h['c_step_ms'], 2) for h in hist]}"
          f" [{power}]", flush=True)
    params, lc_in, side = captured[0]
    held = {x.data_ptr(): x.numel() * x.element_size()
            for x in tree_leaves((params, lc_in)) if x.is_cuda}
    print(f"path H H2: the check's hold on boundary 0's params and LC "
          f"state during the run: {sum(held.values()) / 2**30:.2f} GiB of "
          f"the peak", flush=True)
    serial = lc.c_step(params, tree_map(
        lambda x: x.clone() if isinstance(x, torch.Tensor) else x, lc_in))
    for name in side["tasks"]:
        got, want_ = (tree_leaves((st["tasks"][name]["theta"],
                                   st["tasks"][name]["a"]))
                      for st in (side, serial))
        check(all(torch.equal(a, b) for a, b in zip(got, want_)),
              f"H2 side-stream Θ of {name} differs from the serial C step")
    print(f"path H H2: the side stream's C step at boundary 0 equals the "
          f"serial C step on its snapshot bit for bit "
          f"({len(side['tasks'])} tasks)", flush=True)
    paths["H2"] = r2["launches"]
    del trainer, lc, r2, captured, params, lc_in, side, serial
    torch.cuda.empty_cache()

    # H3: pruning, serial: κ = 5% of the selected weights as one vector;
    # one fused bisection and one K3 a C step (none at init: the scheme's
    # own init, as for H1)
    trainer = h_trainer(cfg, "prune", 2, 2)
    kappa = trainer.lc.tasks[0].scheme.kappa
    check(kappa == int(0.05 * H_WEIGHTS), f"H3 κ {kappa}")
    r3 = h_prune_run(kern, trainer, "H3 prune serial", power)
    nnz = r3["nnz"]
    check(nnz == [kappa] * 2, f"H3 nonzeros per C step {nnz}")
    ratio = 32.0 * H_WEIGHTS / (kappa * (32 + math.ceil(math.log2(
        H_WEIGHTS))))
    check(abs(r3["history"][-1]["compression_ratio"] / ratio - 1) < 1e-12,
          "H3 ratio")
    check(r3["launches"] == only(kern, K2loop=2, K3=2),
          f"H3 launches {r3['launches']}")
    print(f"path H H3: kappa={kappa} nonzeros={nnz}", flush=True)
    paths["H3"] = r3["launches"]
    last = r3["last"]
    del trainer, r3
    torch.cuda.empty_cache()
    check_h_prune(k2, last, kappa, "H3", power)
    del last
    torch.cuda.empty_cache()

    paths["H4"] = path_h4(kern, k2, power)
    return paths


def path_h4(kern, k2, power: str) -> dict:
    """H4: checkpoints and faults at 1 layer (short disk I/O), pruning
    (the quantization tasks stack layers): a hard failure at step 4
    outlasts the retries, the trainer restores the step-2 checkpoint and
    replays from step 3; the run ends equal, bit for bit, to an
    uninterrupted one (deterministic algorithms on: the embedding's
    gradient otherwise sums by atomics), and its mid-run checkpoint
    restores onto the card."""
    import os
    import tempfile
    from repro_torch.runtime import FaultInjector
    from repro_torch.tree import tree_leaves
    cfg = h_config(1)
    os.environ["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"
    torch.use_deterministic_algorithms(True)
    try:
        (ROOT / "build").mkdir(exist_ok=True)
        with tempfile.TemporaryDirectory(dir=ROOT / "build") as d:
            trainer = h_trainer(cfg, "prune", 2, 3, ckpt_dir=d,
                                ckpt_every=2,
                                faults=FaultInjector({4: 5}))
            restores = []
            restore = trainer._restore_state

            def rec(state):
                out = restore(state)
                restores.append((int(state["step"]), out[1]))
                return out

            trainer._restore_state = rec
            r4 = h_run(kern, trainer, "H4 faults + checkpoints", power)
            state = r4["state"]
            check(trainer.faults.injected == 5, "H4 faults injected")
            check(restores == [(4, 3)], f"H4 restore (from, to) {restores}")
            check(int(state["step"]) == 6, "H4 final step")
            steps = trainer.ckpt.steps()
            check(steps == [2, 4, 6], f"H4 checkpoints {steps}")
            t0 = time.time()
            mid, label = trainer.ckpt.restore(state, step=4)
            torch.cuda.synchronize()
            check(all(x.is_cuda for x in tree_leaves(mid)), "H4 on card")
            check(int(mid["step"]) == 5, f"H4 mid step {int(mid['step'])}")
            restore_s = time.time() - t0
            n = r4["launches"]
        clean = h_trainer(cfg, "prune", 2, 3)
        kappa = clean.lc.tasks[0].scheme.kappa
        r_clean = h_prune_run(kern, clean, "H4 uninterrupted", power)
        same = all(torch.equal(a, b) for a, b in zip(
            tree_leaves(state["params"]),
            tree_leaves(r_clean["state"]["params"])))
        check(same, "H4 params differ from the uninterrupted run's")
        check(r_clean["nnz"] == [kappa] * 2,
              f"H4 nonzeros per C step {r_clean['nnz']}")
    finally:
        torch.use_deterministic_algorithms(False)
    last = r_clean["last"]
    del trainer, clean, r_clean, state, mid
    torch.cuda.empty_cache()
    check_h_prune(k2, last, kappa, "H4", power)
    print(f"path H H4: restore (from step, to step)={restores} "
          f"checkpoints={steps} mid-run restore onto the card "
          f"s={restore_s:.2f} params equal to the uninterrupted run's "
          f"bit for bit [{power}]", flush=True)
    return n


def profile_path_h(kern, power: str) -> None:
    """Path H's trainer under the profiler, after the timed paths: one L
    step (one microbatch) and one boundary, serial; two L steps and two
    boundaries overlapped (the second L step runs beside the first
    boundary's C step on the side stream). Each boundary launches one
    fused Lloyd loop a group, each seen in the trace."""
    cfg = h_config()
    for overlap, n_lc in (("off", 1), ("on", 2)):
        trainer = h_trainer(cfg, "quantize", n_lc, 1, overlap=overlap)
        state = trainer.init_state(0)
        trainer._train_step(state, trainer._batch(0))   # warm
        state = trainer.init_state(0)
        run = (trainer._run_serial if overlap == "off"
               else trainer._run_overlapped)
        device_profile(lambda: run(state, trainer.lc.mu_schedule, 0),
                       f"path H overlap={overlap} ({n_lc} L step(s) of one "
                       f"microbatch, {n_lc} boundary(ies))", power, kern)
        check(launches(kern) == only(kern, K1loop=len(H_GROUPS) * n_lc),
              f"path H profile overlap={overlap}: launches {launches(kern)}")
        del trainer, state, run
        torch.cuda.empty_cache()


def profile_after_overlap(k45, card: str) -> None:
    """One profiler session of 50 K4 launches after path H's overlapped
    profile: print how many launches its trace shows. Sessions after
    that one missed their first kernel event (PERF.md); every session
    now opens with an uncounted fill (``profiled``), and this one shows
    whether the launches themselves all reach the trace."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity
    from repro_torch.kernels.quant_matmul import ops as qops
    g = torch.Generator(device="cuda").manual_seed(11)
    idx = torch.randint(0, 16, (LM_D_MODEL, LM_D_FF), device="cuda",
                        generator=g, dtype=torch.uint8)
    w = qops.pack4(idx)
    cb = torch.sort(torch.randn(16, device="cuda", generator=g)).values
    x = torch.randn((2, LM_D_MODEL), device="cuda", generator=g)
    k45.quant_matmul_packed(x, w, cb)
    torch.cuda.synchronize()
    with profiled([ProfilerActivity.CUDA]) as prof:
        for _ in range(50):
            k45.quant_matmul_packed(x, w, cb)
        torch.cuda.synchronize()
    seen = sum(e.count for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA and port_kernel(e.key))
    print(f"profiler after the overlapped profile: {seen} of 50 K4 "
          f"launches in the trace [{card}]", flush=True)


# ----------------------------------------------------------------------
# paths I and J: MoE and MLA serving at the published widths
# ----------------------------------------------------------------------
def moe_mla_config(arch: str, layers: int):
    """``arch`` at its published widths, float32, fused attention, cut to
    ``layers`` repetitions of its pattern (unrolled: the bridge needs
    per-layer leaves) after its lead layers."""
    from repro_torch.configs import get_config
    cfg = get_config(arch)
    cfg = cfg.with_(pattern=cfg.pattern * layers, pattern_reps=1,
                    dtype="float32", fused_attention=True)
    widths = {"mixtral-8x7b": (4096, 32, 8, 128, 32000, 8, 2, 14336, 0),
              "deepseek-moe-16b": (2048, 16, 16, 128, 102400, 64, 6, 1408,
                                   2),
              "minicpm3-4b": (2560, 40, 40, 64, 73448, 768, 256, 64, 32,
                              64, 6400, True)}[arch]
    got = (cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim,
           cfg.vocab_size)
    check(cfg.pattern[0].window == (4096 if arch == "mixtral-8x7b" else 0),
          f"{arch} window")
    if cfg.moe is not None:
        got += (cfg.moe.n_experts, cfg.moe.top_k, cfg.moe.d_expert,
                cfg.moe.n_shared)
    if cfg.mla is not None:
        m = cfg.mla
        got += (m.q_lora_rank, m.kv_lora_rank, m.qk_nope_dim,
                m.qk_rope_dim, m.v_head_dim, cfg.d_ff, cfg.tie_embeddings)
    check(got == widths, f"{arch} widths {got}")
    return cfg


def serve_path(kern, label: str, cfg, tasks, prompt_len: int,
               power: str, seeds: tuple[int, int], capture=(),
               to_host: bool = False):
    """LC init + one C step → bridge → ``Server.generate`` (2 prompts of
    ``prompt_len``, SERVE_GEN new tokens) with every kernel launch
    counted from 0; returns the run's record. ``seeds`` seed the weights
    and the prompts; ``capture`` lists (module, name) of kernel wrappers
    whose calls in the C step are kept for the checks (on the host with
    ``to_host``)."""
    from repro_torch.core import LCAlgorithm, flatten_params
    from repro_torch.models import transformer as tf
    from repro_torch.runtime import server as srv
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # the peak is this path's own: nothing of an earlier path may linger
    # in a reference cycle
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated() / 2**30
    params = tf.init_params(
        torch.Generator(device="cuda").manual_seed(seeds[0]), cfg)
    n_params = sum(t.numel() for t in flatten_params(params).values())
    prompts = np.random.default_rng(seeds[1]).integers(
        0, cfg.vocab_size, (SERVE_BATCH, prompt_len),
        dtype=np.int64).astype(np.int32)
    max_len = prompt_len + SERVE_GEN
    reset(kern)
    torch.cuda.synchronize()
    t0 = time.time()
    lc = LCAlgorithm(tasks, [1e-4], device="cuda")
    state = lc.init(params)
    torch.cuda.synchronize()
    t_init = time.time() - t0
    init_peak = torch.cuda.max_memory_allocated() / 2**30
    with contextlib.ExitStack() as stack:
        calls = [stack.enter_context(calls_of(m, n, 0, to_host))
                 for m, n in capture]
        t0 = time.time()
        state = lc.c_step(params, state)
        torch.cuda.synchronize()
        t_cstep = time.time() - t0
    t0 = time.time()
    serving, report = srv.load_compressed_for_serving(params, state,
                                                      lc.tasks)
    torch.cuda.synchronize()
    t_bridge = time.time() - t0
    server = srv.Server(cfg, serving, max_len=max_len, device="cuda")
    t0 = time.time()
    res = server.generate(prompts, SERVE_GEN)
    torch.cuda.synchronize()
    t_gen = time.time() - t0
    n = launches(kern)
    peak = torch.cuda.max_memory_allocated() / 2**30
    progs = server.programs
    check(progs.graphs and progs.captured == 2,
          f"{label}: generate captured {progs.captured} graphs")
    captured = (f"captured {progs.captured} graphs in "
                f"{progs.capture_s:.3f} s, graph_pool_gib="
                f"{progs.pool_bytes() / 2**30:.3f}")
    # the graph pool keeps the prefill's temporaries: freed before the
    # checks' eager forwards
    del server, progs
    gc.collect()
    torch.cuda.empty_cache()
    toks = res.tokens
    check(toks.shape == (SERVE_BATCH, SERVE_GEN) and toks.min() >= 0
          and toks.max() < cfg.vocab_size, f"{label} tokens {toks.shape}")
    print(f"main path {label} ({cfg.name} full width, {cfg.n_layers} "
          f"layers, {n_params:,} params): init_s={t_init:.2f} "
          f"c_step_s={t_cstep:.3f} bridge_s={t_bridge:.3f} "
          f"generate_s={t_gen:.3f} ({SERVE_BATCH}x{prompt_len} prompt, "
          f"{SERVE_GEN} new tokens; CUDA graphs: {captured}) "
          f"init_peak_memory_gib={init_peak:.2f} "
          f"peak_memory_gib={peak:.2f} (held before the path: {held:.2f}) "
          f"launches={ {k: v for k, v in n.items() if v} } [{power}]",
          flush=True)
    kinds = {}
    for forms in report.values():
        for f in forms.values():
            kinds[f.split("(")[0]] = kinds.get(f.split("(")[0], 0) + 1
    dense = srv.densified_for_serving(params, state, lc.tasks)
    summary = lc.group_summary(params)
    groups = sum(g["solver"] == "kmeans_lloyd" for g in summary)
    del params
    prompts_t = torch.as_tensor(prompts, device="cuda")
    toks_t = torch.as_tensor(toks, device="cuda")
    return {"launches": n, "kinds": kinds, "state": state, "lc": lc,
            "serving": serving, "dense": dense, "prompts": prompts_t,
            "tokens": toks_t, "max_len": max_len, "calls": calls,
            "kmeans_groups": groups, "summary": summary, "peak_gib": peak,
            "c_step_s": t_cstep}


def check_served(label: str, cfg, run: dict, power: str) -> None:
    """The served logits against the densified model's, greedy tokens
    agreeing at 1.0, fused attention (K6) against the plain loop."""
    from repro_torch.models import transformer as tf
    agree = against_densified(label, cfg, run["serving"], run["dense"],
                              run["prompts"], run["tokens"], power,
                              max_len=run["max_len"])
    check(agree == 1.0, f"{label} token agreement {agree}")
    # the plain loop's chunks must divide the prompt (4608 = 9 × 512)
    chunk = math.gcd(run["prompts"].shape[1], cfg.attn_chunk_q)
    with torch.inference_mode():
        h_fused, _ = tf.forward_hidden(run["serving"], run["prompts"], cfg)
        h_plain, _ = tf.forward_hidden(
            run["serving"], run["prompts"], cfg.with_(
                fused_attention=False, attn_chunk_q=chunk,
                attn_chunk_kv=chunk))
    torch.testing.assert_close(h_fused, h_plain, rtol=2e-4, atol=2e-4)
    print(f"{label} fused vs plain attention: max|Δhidden|="
          f"{float((h_fused - h_plain).abs().max()):.3g}", flush=True)


def check_lloyd_at(k1, calls, label: str, power: str) -> dict:
    """The C step's fused Lloyd loops (``calls``) held against the
    iterated and plain loops on their own operands (``check_lloyd``),
    the fused loop timed (3 turns) beside the plain loop (one run) and
    its bound; returns the largest item stack's row. Each loop is
    checked and timed in the partition it was launched with (a chunk of
    a planned group: its group's, ``build.group_partition``)."""
    from repro_torch.kernels.build import group_partition
    rows = []
    for ((w, cb, iters), _, got), part in zip(calls, calls.partitions):
        w, cb = w.to("cuda"), cb.to("cuda")
        got = tuple(g.to("cuda") for g in got)
        with group_partition(part):
            err, moved = check_lloyd(k1, w, cb, iters, got,
                                     f"{label} Lloyd loop {tuple(w.shape)}")
            ms = timed_turns(
                [lambda: k1.kmeans_lloyd_batched(w, cb, iters)], 3)[0]
            k = cb.shape[1]
            b_ms, b_by, floor = lloyd_bound(k1, w, k, iters)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        k1.kmeans_lloyd_batched_plain(w, cb, iters)
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
        rows.append({"shape": list(w.shape), "k": k, "ms": ms,
                     "plain_ms": plain_ms, "bound_ms": b_ms,
                     "bound_by": b_by, "max_abs_err": err})
        del w, cb, got
        print(f"path {label}: Lloyd loop I={rows[-1]['shape'][0]} "
              f"P={rows[-1]['shape'][1]} (partitioned as {part} items) "
              f"K={k} iters={iters} of the C step bit-identical to the "
              f"iterated loop, max|Δcb| vs plain loop={err:.3g}, "
              f"assignments differing from the plain loop's={moved}; "
              f"ms={ms:.3f} plain_ms={plain_ms:.1f} bound_ms={b_ms:.3f} "
              f"({b_by}) design_floor_ms={floor:.3f} [{power}]", flush=True)
        rows[-1]["partition"] = part
    chunked = [r for r in rows if r["partition"] > r["shape"][0]]
    if chunked:
        print(f"path {label}: the chunked group's Lloyd loops: "
              f"{len(chunked)} launches over "
              f"{sum(r['shape'][0] for r in chunked)} items, ms sum="
              f"{sum(r['ms'] for r in chunked):.3f} bound_ms sum="
              f"{sum(r['bound_ms'] for r in chunked):.3f} plain_ms sum="
              f"{sum(r['plain_ms'] for r in chunked):.1f} [{power}]",
              flush=True)
    return max(rows, key=lambda r: r["shape"][0] * r["shape"][1])


def main_path_i1(kern, k1, power: str) -> dict:
    """mixtral-8x7b at full width, 2 of 32 layers: 4-bit k=16 on all 6
    expert stacks (I1_MATRICES of both layers, one AsVector task a matrix
    and layer: one group of 6 items of 469,762,048 weights, which the
    planner splits into launches that fit its budget, one fused Lloyd
    loop each), 8-bit k=64 on each layer's attention; ``Server.generate``
    on 2 prompts of 4608 > the 4096 window (K6 masks real keys, the ring
    buffer wraps in decode). The Lloyd loops' operands are kept on the
    host for the checks, which run each loop in its launch's
    partition."""
    from repro_torch.core import AsVector, CompressionTask
    from repro_torch.core.grouping import _chunk_bounds
    from repro_torch.core.schemes import AdaptiveQuantization
    from repro_torch.kernels.kmeans import ops as kops
    cfg = moe_mla_config("mixtral-8x7b", MIX_LAYERS)
    check(0 < cfg.pattern[0].window < MIX_PROMPT, "mixtral window")
    tasks = []
    for i in range(MIX_LAYERS):
        pre = rf"^stages/s0/pos{i}/"
        tasks += [CompressionTask(f"{m}{i}", pre + rf"ffn/{m}$", AsVector(),
                                  AdaptiveQuantization(k=16, iters=10))
                  for m in I1_MATRICES]
        tasks.append(CompressionTask(
            f"attn{i}", pre + r"mixer/(wq|wk|wv|wo)$", AsVector(),
            AdaptiveQuantization(k=64, iters=10)))
    from repro_torch.analysis import cost
    n_experts = len(I1_MATRICES) * MIX_LAYERS
    gib = 2**30
    budget = cost.chunk_budget(cost.detect_hardware("cuda"))
    print(f"path I1 plan budget: {budget / gib:.2f} GiB (a quarter of the "
          f"card's memory)", flush=True)
    run = serve_path(kern, "I1", cfg, tasks, MIX_PROMPT, power,
                     seeds=(21, 21),
                     capture=[(kops, "kmeans_lloyd_batched")], to_host=True)
    check(run["kinds"] == {"dense": n_experts, "quant8": 4 * MIX_LAYERS},
          f"I1 bridged forms {run['kinds']}")
    (experts,) = [g for g in run["summary"] if g["items"] == n_experts]
    plan = experts["plan"]
    check(plan is not None and plan["n_chunks"] > 1
          and plan["backend"] == "cuda", f"I1 expert plan {plan}")
    bounds = _chunk_bounds(n_experts, plan["n_chunks"])
    print(f"path I1 expert group plan: items={n_experts} x {MIX_ITEM:,} "
          f"n_chunks={plan['n_chunks']} chunks={bounds} working_set_gib="
          f"{plan['working_set_bytes'] / gib:.2f} budget_gib="
          f"{budget / gib:.2f} modeled_ms={plan['modeled_ms']:.3f} "
          f"bottleneck={plan['bottleneck']} fallbacks={plan['fallbacks']}",
          flush=True)
    # the C step: one Lloyd loop a chunk of the expert stacks, one for
    # the attention; generate: every attention matrix once a token, K6
    # once a layer at prefill (the expert stacks stay dense: batched GEMMs)
    want = only(kern, K1loop=plan["n_chunks"] + 1,
                K5=4 * MIX_LAYERS * SERVE_GEN, K6=MIX_LAYERS)
    check(run["kmeans_groups"] == 2 and run["launches"] == want,
          f"I1 launches {run['launches']} != {want}")
    (lloyd,) = run.pop("calls")
    shapes = sorted(tuple(a[0].shape) for a, _, _ in lloyd)
    attn = 2 * cfg.d_model * (cfg.q_dim + cfg.kv_dim)
    check(shapes == sorted([(hi - lo, MIX_ITEM) for lo, hi in bounds]
                           + [(MIX_LAYERS, attn)]),
          f"I1 Lloyd loops {shapes}")
    check(sorted(lloyd.partitions) == sorted(
        [n_experts] * len(bounds) + [MIX_LAYERS]),
        f"I1 Lloyd loops' partitions {lloyd.partitions}")
    print(f"path I1: C step {run['c_step_s']:.3f} s, of which "
          f"{lloyd.copy_s:.3f} s copy the checked loops' operands to the "
          f"host; peak_memory_gib={run['peak_gib']:.2f} [{power}]",
          flush=True)
    del run["state"], run["lc"]
    check_served("path I1", cfg, run, power)
    out = {"launches": run["launches"], "peak_gib": run["peak_gib"]}
    del run
    torch.cuda.empty_cache()
    out["lloyd"] = check_lloyd_at(k1, lloyd, "I1", power)
    del lloyd
    torch.cuda.empty_cache()
    return out


def watch_resets(eng, cfg, label: str) -> dict:
    """Route ``eng``'s reset program through a check: every slot admitted
    a second time holds exactly ``init_cache``'s values in every cache
    leaf (recurrent states and KV rows) right after its reset. The
    check's own time is taken off the engine's clock. Returns a record
    whose ``checked`` counts the slots checked."""
    from repro_torch.core import flatten_params
    from repro_torch.models import transformer as tf
    fresh = flatten_params(tf.init_cache(cfg, eng.slots, eng.max_len,
                                         device="cuda"))
    axes = flatten_params(tf.cache_axes(cfg))
    admitted = [0] * eng.slots
    rec = {"checked": 0}
    reset = eng._reset

    def watched(cache, mask):
        out = reset(cache, mask)
        t0 = time.perf_counter()
        flat = flatten_params(out)
        for slot in torch.nonzero(mask).flatten().tolist():
            admitted[slot] += 1
            if admitted[slot] < 2:
                continue
            for k, v in flat.items():
                ax = axes[k].index("batch")
                check(torch.equal(v.select(ax, slot),
                                  fresh[k].select(ax, slot)),
                      f"{label}: slot {slot} after its reset holds another "
                      f"{k} than init_cache's")
            rec["checked"] += 1
        eng._now -= time.perf_counter() - t0
        return out

    eng._reset = watched
    return rec


def poisson_requests(cfg, n_req: int, prompts, new, seed: int = 5,
                     start: float = 0.0, gap: float = 0.02) -> list:
    """``n_req`` requests arriving as a Poisson process (mean gap ``gap``
    s; 0: all at once) from ``start``, prompt lengths in ``prompts`` and
    new tokens in ``new`` (inclusive ranges), tokens from ``seed``."""
    from repro_torch.runtime import server as srv
    rng = np.random.default_rng(seed)
    t, reqs = start, []
    for i in range(n_req):
        t += float(rng.exponential(gap))
        reqs.append(srv.Request(
            id=i, prompt=rng.integers(1, cfg.vocab_size,
                                      size=int(rng.integers(prompts[0],
                                                            prompts[1] + 1)))
            .astype(np.int32), max_new=int(rng.integers(new[0], new[1] + 1)),
            arrival=t))
    return reqs


def engine_trace(kern, label: str, cfg, serving, n_req: int, prompts,
                 new, power: str, after=None,
                 kernels=("K4", "K5")) -> dict:
    """``ServingEngine`` (8 slots, prefill chunks of 32) on a Poisson
    trace of ``n_req`` requests, prompt lengths in ``prompts`` and new
    tokens in ``new`` (inclusive ranges); exactly the ``kernels`` launch,
    and every re-admitted slot's cache is held to ``init_cache``'s values
    (``watch_resets``). ``after(reqs, finished)`` runs once the launches
    are read."""
    from repro_torch.runtime import server as srv
    reqs = poisson_requests(cfg, n_req, prompts, new)
    max_len = prompts[1] + new[1]
    reset(kern)
    torch.cuda.synchronize()
    t0 = time.time()
    eng = srv.ServingEngine(cfg, serving, slots=8, max_len=max_len,
                            prefill_chunk=32, device="cuda")
    resets = watch_resets(eng, cfg, label)
    out = eng.run(reqs)
    torch.cuda.synchronize()
    wall = time.time() - t0
    n = launches(kern)
    fin = {f.id: f for f in out["finished"]}
    check(not out["rejected"] and sorted(fin) == list(range(n_req)),
          f"{label} finished {sorted(fin)}")
    check(all(len(fin[r.id].tokens) == r.max_new for r in reqs),
          f"{label}: a request got another number of tokens than max_new")
    check(all(n[k] > 0 for k in kernels)
          and n == only(kern, **{k: n[k] for k in kernels}),
          f"{label} launches {n}")
    check(eng.trace_counts == {"decode": 1, "prefill": 1, "reset": 1},
          f"{label} program signatures {eng.trace_counts}")
    check(eng.programs.graphs and eng.programs.captured == 3,
          f"{label}: the engine captured {eng.programs.captured} graphs")
    st = out["stats"]
    print(f"main path {label} (ServingEngine, 8 slots, {n_req} requests, "
          f"prompts {prompts[0]}-{prompts[1]}, max_new {new[0]}-{new[1]}; "
          f"CUDA graphs, capture included): "
          f"tokens={st['tokens']} tokens_per_s={st['tokens_per_sec']:.1f} "
          f"p50_latency_s={st['p50_latency_s']:.3f} "
          f"p99_latency_s={st['p99_latency_s']:.3f} "
          f"p50_ttft_s={st['p50_ttft_s']:.3f} "
          f"p99_ttft_s={st['p99_ttft_s']:.3f} wall_s={wall:.2f} "
          f"capture_s={eng.programs.capture_s:.3f} graph_pool_gib="
          f"{eng.programs.pool_bytes() / 2**30:.3f} "
          f"launches={ {k: v for k, v in n.items() if v} } [{power}]",
          flush=True)
    # every request past the first 8 enters a slot used before
    check(resets["checked"] == max(n_req - eng.slots, 0),
          f"{label}: {resets['checked']} re-admitted slots checked")
    print(f"{label}: {resets['checked']} re-admitted slots each held "
          f"init_cache's values in every cache leaf right after its "
          f"reset [{power}]", flush=True)
    if after is not None:
        after(reqs, fin)
    return n


MODES = ("eager", "graphs")
#: the engine comparison's short trace: requests, prompt and new-token
#: ranges (D's and the SSM paths' main traces take 16–24 requests); all
#: arrive at once, so that the schedule, and with it each MoE decode's
#: batch, does not depend on the ticks' times
SHORT_TRACE = (12, (32, 128), (8, 32))
#: the busy-share profiles' engine trace (``serving_busy``)
BUSY_TRACE = (4, (32, 64), (8, 16))


def graph_servers(cfg, serving, max_len: int) -> dict:
    """A ``Server`` of each mode on one model: its programs eager, or
    CUDA graphs."""
    from repro_torch.runtime import server as srv
    return {m: srv.Server(cfg, serving, max_len=max_len, device="cuda",
                          graphs=m == "graphs") for m in MODES}


def server_against_eager(label: str, cfg, serving, prompts,
                         power: str) -> dict:
    """``Server.generate`` through CUDA graphs against the same programs
    run eagerly, on path ``label``'s model and prompts: greedy tokens
    equal, the logits' max|Δ| printed beside two eager runs'; after a
    first call of each mode (the graphs' capture), in turns (eager,
    graphs, graphs, eager): the
    prefill ms (a generate of 1 token), the decode ms a step ((generate
    of SERVE_GEN − generate of 1) / (SERVE_GEN − 1), medians) and
    tokens/s; the capture's seconds and graph-pool bytes."""
    stamp(f"{label} generate against eager")
    max_len = prompts.shape[1] + SERVE_GEN
    servers = graph_servers(cfg, serving, max_len)
    first = {m: sv.generate(prompts, SERVE_GEN, return_logits=True)
             for m, sv in servers.items()}
    check(np.array_equal(first["graphs"].tokens, first["eager"].tokens),
          f"{label}: greedy tokens through CUDA graphs differ from the "
          f"eager programs'")
    dlogit = float((first["graphs"].logits - first["eager"].logits)
                   .abs().max())
    # the same for two eager runs: a product whose sums come in another
    # order on every run (the sparse form's index_add_, by atomics)
    # shows here too
    again = servers["eager"].generate(prompts, SERVE_GEN, return_logits=True)
    d_eager = float((again.logits - first["eager"].logits).abs().max())
    scale = float(first["eager"].logits.abs().max())
    del first, again
    times = {m: {1: [], SERVE_GEN: []} for m in MODES}
    for m in ("eager", "graphs", "graphs", "eager"):
        for n in (1, SERVE_GEN):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            servers[m].generate(prompts, n)
            torch.cuda.synchronize()
            times[m][n].append(time.perf_counter() - t0)
    progs = servers["graphs"].programs
    check(progs.captured == 2, f"{label}: {progs.captured} graphs")
    out = {}
    for m, t in times.items():
        pre, gen = statistics.median(t[1]), statistics.median(t[SERVE_GEN])
        out[m] = {"prefill_ms": pre * 1e3,
                  "decode_ms": (gen - pre) / (SERVE_GEN - 1) * 1e3,
                  "tokens_per_s": prompts.shape[0] * SERVE_GEN / gen}
    print(f"{label} generate, CUDA graphs against eager "
          f"({prompts.shape[0]}x{prompts.shape[1]} prompt, {SERVE_GEN} "
          f"tokens): greedy tokens equal, max|Δlogit|={dlogit:.3g} "
          f"(two eager runs: {d_eager:.3g}; max|logit| {scale:.3g}); "
          + " ".join(f"{m}: prefill_ms={r['prefill_ms']:.2f} "
                     f"decode_ms_per_step={r['decode_ms']:.3f} "
                     f"tokens_per_s={r['tokens_per_s']:.1f};"
                     for m, r in out.items())
          + f" capture_s={progs.capture_s:.3f} graph_pool_gib="
          f"{progs.pool_bytes() / 2**30:.3f} [{power}]", flush=True)
    return out


def warm_engines(cfg, serving):
    """A ``ServingEngine`` of each mode (8 slots, chunks of 32), each
    warmed on two short requests (the graphs' capture: the comparison's
    clock starts after it)."""
    from repro_torch.runtime import server as srv
    _, prompts, new = SHORT_TRACE
    engines = {}
    for m in MODES:
        eng = srv.ServingEngine(cfg, serving, slots=8,
                                max_len=prompts[1] + new[1],
                                prefill_chunk=32, device="cuda",
                                graphs=m == "graphs")
        eng.run(poisson_requests(cfg, 2, (4, 40), (2, 2), seed=7))
        engines[m] = eng
    return engines


def engine_against_eager(label: str, cfg, serving, power: str) -> dict:
    """The engine through CUDA graphs against the same programs run
    eagerly (``warm_engines``), on SHORT_TRACE in turns (eager, graphs,
    graphs, eager): every request's greedy tokens equal in every run;
    each run's tokens/s, p50/p99 latency and TTFT; the capture's seconds
    and graph-pool bytes. The trace's requests all arrive at once
    (SHORT_TRACE)."""
    stamp(f"{label} engine against eager")
    n_req, prompts, new = SHORT_TRACE
    engines = warm_engines(cfg, serving)
    stats, tokens = {m: [] for m in MODES}, []
    for m in ("eager", "graphs", "graphs", "eager"):
        eng = engines[m]
        out = eng.run(poisson_requests(cfg, n_req, prompts, new, seed=6,
                                       start=eng._now, gap=0.0))
        check(len(out["finished"]) == n_req, f"{label} engine {m}")
        tokens.append({f.id: f.tokens.tolist() for f in out["finished"]})
        stats[m].append(out["stats"])
    check(all(t == tokens[0] for t in tokens),
          f"{label} engine: tokens through CUDA graphs differ from the "
          f"eager programs'")
    progs = engines["graphs"].programs
    check(engines["graphs"].trace_counts
          == {"decode": 1, "prefill": 1, "reset": 1} and progs.captured == 3,
          f"{label} engine graphs {engines['graphs'].trace_counts}")

    def fmt(st):
        return (f"tokens_per_s={st['tokens_per_sec']:.1f} "
                f"p50_latency_s={st['p50_latency_s']:.3f} "
                f"p99_latency_s={st['p99_latency_s']:.3f} "
                f"p50_ttft_s={st['p50_ttft_s']:.3f} "
                f"p99_ttft_s={st['p99_ttft_s']:.3f}")

    print(f"{label} engine, CUDA graphs against eager (8 slots, {n_req} "
          f"requests, prompts {prompts[0]}-{prompts[1]}, max_new "
          f"{new[0]}-{new[1]}, after a warm-up; runs in turns eager, "
          f"graphs, graphs, eager): greedy tokens equal; "
          + " ".join(f"{m}: " + " | ".join(fmt(st) for st in sts) + ";"
                     for m, sts in stats.items())
          + f" capture_s={progs.capture_s:.3f} graph_pool_gib="
          f"{progs.pool_bytes() / 2**30:.3f} [{power}]", flush=True)
    return stats


def serving_busy(kern, label: str, cfg, serving, prompts, toks,
                 power: str) -> None:
    """The device's busy share under ``torch.profiler`` (``device_profile``)
    of ``Server``'s decode program, 8 steps after an eager prefill of
    ``prompts`` (fed ``toks``' first column), and of a warmed engine on
    BUSY_TRACE, each through CUDA graphs (captured before the session)
    and then eagerly, each profile taken up to 3 times until it holds
    every counted launch. ``main`` runs this for each model in a process
    of its own (``--busy``): a profiler session after an eager engine's
    (~50k kernel events) traced 43 of 50 K9 launches."""
    from repro_torch.models import transformer as tf
    from repro_torch.runtime import server as srv
    stamp(f"path {label} busy shares")
    b, s = prompts.shape
    with torch.inference_mode():
        _, _, caches = tf.forward_hidden(serving, prompts, cfg,
                                         return_caches=True)
        caches = srv.pad_caches_to(caches, cfg, s, s + SERVE_GEN)
    servers = graph_servers(cfg, serving, s + SERVE_GEN)
    for m in MODES[::-1]:
        server = servers[m]
        @torch.inference_mode()
        def steps(server=server):
            tok = toks[:, 0].clone()
            pos = torch.full((b,), s, dtype=torch.int64, device="cuda")
            for _ in range(8):
                tok, pos, _, _ = server._decode(caches, tok, pos, None,
                                                0.0)

        steps()                                  # the capture
        device_profile(steps, f"path {label} 8 decode steps ({m})", power,
                       kern, tries=3)
    del caches, server, servers
    n_req, p_range, new = BUSY_TRACE
    engines = warm_engines(cfg, serving)
    for m in MODES[::-1]:
        eng = engines[m]
        reqs = poisson_requests(cfg, n_req, p_range, new, seed=6,
                                start=eng._now, gap=0.0)

        def run(eng=eng, reqs=reqs):
            check(len(eng.run(reqs)["finished"]) == n_req,
                  f"{label} busy-share trace")

        device_profile(run, f"path {label} engine, {n_req} requests ({m})",
                       power, kern, tries=3)
        stamp(f"path {label} engine busy share ({m}) taken")


def topk_at(k2, calls, theta, kappa: int, label: str, power: str) -> dict:
    """An ℓ0 task's C step on the operands its kernels were launched with
    (``calls``: the fused bisection's and K3's calls of one C step): the
    bisection's (lo, hi, n_hi) equal to the iterated and plain loops, K3
    equal to its plain version, Θ the exact top-κ of its input with
    exactly κ nonzeros; both timed beside their plain versions and
    bounds. Returns the rows {"topk", "K3"}."""
    from repro_torch.core.schemes.prune import topk_magnitude_mask
    bis, masks = calls
    check(len(bis) == 1 and len(masks) == 1, f"{label} bisection / K3 calls")
    nnz = int(torch.count_nonzero(theta))
    check(nnz == kappa, f"{label} nonzeros {nnz} != κ {kappa}")
    (w, kap, iters), kw, got = bis[0]
    check(tuple(w.shape) == (1, theta.numel())
          and kap.tolist() == [kappa], f"{label} bisection {tuple(w.shape)}")
    strict = kw.get("strict", False)
    check_bisection(k2, w, kap, iters, strict, got, f"{label} bisection")
    (mw, t), mkw, kept = masks[0]
    check(torch.equal(kept, k2.mask_apply_batched_plain(mw, t, **mkw)),
          f"{label}: K3 differs from its plain version")
    exact = torch.where(topk_magnitude_mask(w, kappa), w, 0.0)
    check(torch.equal(theta.reshape(w.shape), exact),
          f"{label}: Θ differs from the exact top-κ of its input")
    del exact
    ms, k3_ms = timed_turns(
        [lambda: k2.topk_threshold_batched(w, kap, iters, strict),
         lambda: k2.mask_apply_batched(mw, t, **mkw)], 5)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    k2.topk_threshold_batched_plain(w, kap, iters, strict)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    k3_plain = timed_turns(
        [lambda: k2.mask_apply_batched_plain(mw, t, **mkw)], 3)[0]
    p_all = w.numel()
    b_ms, b_by = bound(4.0 * p_all, float(p_all))
    b3_ms, b3_by = bound(8.0 * p_all, float(p_all))
    print(f"path {label}: bisection I=1 P={p_all} κ={kappa} iters={iters}: "
          f"(lo, hi, n_hi) equal to the iterated and plain loops, K3 equal "
          f"to its plain version, Θ equal to the exact top-κ, "
          f"nonzeros={nnz}; bisection ms={ms:.3f} plain_ms={plain_ms:.1f} "
          f"bound_ms={b_ms:.3f} ({b_by}); K3 ms={k3_ms:.3f} plain_ms="
          f"{k3_plain:.3f} bound_ms={b3_ms:.3f} ({b3_by}) [{power}]",
          flush=True)
    return {"topk": {"shape": list(w.shape), "ms": ms, "plain_ms": plain_ms,
                     "bound_ms": b_ms, "bound_by": b_by, "max_abs_err": 0.0},
            "K3": {"shape": list(mw.shape), "ms": k3_ms,
                   "plain_ms": k3_plain, "bound_ms": b3_ms,
                   "bound_by": b3_by, "max_abs_err": 0.0}}


def main_path_i2(kern, k1, k2, power: str) -> dict:
    """deepseek-moe-16b at full width: its dense lead layer and 3 MoE
    layers; ℓ0 at 5% on all expert ``w_down`` stacks as one vector (the
    fused bisection and K3), 4-bit k=16 on the lead FFN and on each
    layer's shared experts (K4 in serving), 8-bit k=64 on each layer's
    attention (K5); ``Server.generate`` (2 × 512), then a ServingEngine
    trace whose per-slot MoE decode drops tokens at capacity."""
    from repro_torch.core import AsVector, CompressionTask
    from repro_torch.core.schemes import (
        AdaptiveQuantization, ConstraintL0Pruning)
    from repro_torch.kernels.kmeans import ops as kops
    from repro_torch.kernels.prune import ops as pops
    from repro_torch.models import moe
    cfg = moe_mla_config("deepseek-moe-16b", DS_MOE_LAYERS)
    check(moe.capacity_for(8, cfg) == 1,
          "I2: the engine's decode is not the capacity-drop case")
    q4 = dict(k=16, iters=10)
    tasks = [CompressionTask("experts_down", r"^stages/s1/pos\d/ffn/w_down$",
                             AsVector(), ConstraintL0Pruning(kappa=DS_KAPPA)),
             CompressionTask("lead_ffn",
                             r"^stages/s0/pos0/ffn/(w_gate|w_up|w_down)$",
                             AsVector(), AdaptiveQuantization(**q4))]
    tasks += [CompressionTask(
        f"shared{i}", rf"^stages/s1/pos{i}/ffn/(sw_gate|sw_up|sw_down)$",
        AsVector(), AdaptiveQuantization(**q4)) for i in range(DS_MOE_LAYERS)]
    tasks += [CompressionTask(f"attn{si}{i}",
                              rf"^stages/s{si}/pos{i}/mixer/(wq|wk|wv|wo)$",
                              AsVector(), AdaptiveQuantization(k=64, iters=10))
              for si, n in ((0, 1), (1, DS_MOE_LAYERS)) for i in range(n)]
    run = serve_path(kern, "I2", cfg, tasks, SERVE_PROMPT, power,
                     seeds=(22, 22),
                     capture=[(pops, "topk_threshold_batched"),
                              (pops, "mask_apply_batched"),
                              (kops, "kmeans_lloyd_batched")])
    n_layers = 1 + DS_MOE_LAYERS
    check(run["kinds"] == {"dense": DS_MOE_LAYERS,
                           "quant4": 3 * n_layers,
                           "quant8": 4 * n_layers},
          f"I2 bridged forms {run['kinds']}")
    want = only(kern, K1loop=run["kmeans_groups"], K2loop=1, K3=1,
                K4=3 * n_layers * SERVE_GEN, K5=4 * n_layers * SERVE_GEN,
                K6=n_layers)
    check(run["kmeans_groups"] == 3 and run["launches"] == want,
          f"I2 launches {run['launches']} != {want}")
    theta = run["state"]["tasks"]["experts_down"]["theta"]["theta"]
    bis, masks, lloyd = run.pop("calls")
    check(theta.numel() == DS_ITEM * DS_MOE_LAYERS,
          f"I2 pruned weights {theta.numel()}")
    # the Lloyd loops: the lead FFN (one item), the shared experts (one
    # item a layer), the attention (one item a layer)
    shapes = sorted(tuple(a[0].shape) for a, _, _ in lloyd)
    want_shapes = sorted([
        (1, 3 * cfg.d_model * cfg.d_ff),
        (DS_MOE_LAYERS, 3 * cfg.d_model * cfg.moe.n_shared
         * cfg.moe.d_expert),
        (n_layers, 2 * cfg.d_model * (cfg.q_dim + cfg.kv_dim))])
    check(shapes == want_shapes, f"I2 Lloyd loops {shapes}")
    del run["state"], run["lc"]
    check_served("path I2", cfg, run, power)
    out = {"launches": run["launches"], "peak_gib": run["peak_gib"]}
    serving = run.pop("serving")
    del run
    torch.cuda.empty_cache()
    out["engine"] = engine_trace(kern, "I2 engine", cfg, serving, 16,
                                 (32, 384), (16, 64), power)
    del serving
    torch.cuda.empty_cache()
    out["lloyd"] = check_lloyd_at(k1, lloyd, "I2", power)
    del lloyd
    torch.cuda.empty_cache()

    # the bisection and K3 at this shape, on their own operands
    out.update(topk_at(k2, (bis, masks), theta, DS_KAPPA, "I2", power))
    del bis, masks, theta
    torch.cuda.empty_cache()
    return out


def main_path_j(kern, k1, power: str) -> dict:
    """minicpm3-4b at full width, 4 of 62 layers, tied embeddings: 8-bit
    k=64 on each layer's MLA projections (wukv materialized in serving),
    4-bit k=16 on each layer's FFN; ``Server.generate`` (2 × 512; K6 at
    qk 96, v 64), then a short ServingEngine trace (the per-slot latent
    cache decode)."""
    from repro_torch.core import AsVector, CompressionTask
    from repro_torch.core.schemes import AdaptiveQuantization
    from repro_torch.kernels.kmeans import ops as kops
    cfg = moe_mla_config("minicpm3-4b", CPM_LAYERS)
    tasks = []
    for i in range(CPM_LAYERS):
        pre = rf"^stages/s0/pos{i}/"
        tasks += [CompressionTask(f"mla{i}",
                                  pre + r"mixer/(wdq|wuq|wdkv|wukv|wo)$",
                                  AsVector(),
                                  AdaptiveQuantization(k=64, iters=10)),
                  CompressionTask(f"ffn{i}",
                                  pre + r"ffn/(w_gate|w_up|w_down)$",
                                  AsVector(),
                                  AdaptiveQuantization(k=16, iters=10))]
    run = serve_path(kern, "J", cfg, tasks, SERVE_PROMPT, power,
                     seeds=(23, 23),
                     capture=[(kops, "kmeans_lloyd_batched")])
    check(run["kinds"] == {"quant8": 5 * CPM_LAYERS,
                           "quant4": 3 * CPM_LAYERS},
          f"J bridged forms {run['kinds']}")
    # wukv is materialized (wload), the other four projections run K5
    want = only(kern, K1loop=2, K4=3 * CPM_LAYERS * SERVE_GEN,
                K5=4 * CPM_LAYERS * SERVE_GEN, K6=CPM_LAYERS)
    check(run["kmeans_groups"] == 2 and run["launches"] == want,
          f"J launches {run['launches']} != {want}")
    (lloyd,) = run.pop("calls")
    m, h, d = cfg.mla, cfg.n_heads, cfg.d_model
    mla = (d * m.q_lora_rank
           + m.q_lora_rank * h * (m.qk_nope_dim + m.qk_rope_dim)
           + d * (m.kv_lora_rank + m.qk_rope_dim)
           + m.kv_lora_rank * h * (m.qk_nope_dim + m.v_head_dim)
           + h * m.v_head_dim * d)
    shapes = sorted(tuple(a[0].shape) for a, _, _ in lloyd)
    check(shapes == sorted([(CPM_LAYERS, mla),
                            (CPM_LAYERS, 3 * d * cfg.d_ff)]),
          f"J Lloyd loops {shapes}")
    del run["state"], run["lc"]
    check_served("path J", cfg, run, power)
    out = {"launches": run["launches"], "peak_gib": run["peak_gib"]}
    serving = run.pop("serving")
    del run
    torch.cuda.empty_cache()
    out["engine"] = engine_trace(kern, "J engine", cfg, serving, 8,
                                 (32, 128), (8, 32), power)
    del serving
    torch.cuda.empty_cache()
    out["lloyd"] = check_lloyd_at(k1, lloyd, "J", power)
    del lloyd
    torch.cuda.empty_cache()
    return out


# ----------------------------------------------------------------------
# paths K, L1 and L2: the recurrent mixers at the published widths
# ----------------------------------------------------------------------
def ssm_config(arch: str):
    """jamba-v0.1-52b cut to layers 2–4 of its super-block, or xlstm-125m
    whole, at the published widths, float32, fused attention, unrolled
    (the bridge needs per-layer leaves)."""
    from repro_torch.configs import get_config
    from repro_torch.models.ssm import mamba_dims, mlstm_dims, slstm_dims
    from repro_torch.models.transformer import count_params
    cfg = get_config(arch)
    if arch == "jamba-v0.1-52b":
        cfg = cfg.with_(pattern=cfg.pattern[2:5], pattern_reps=1,
                        dtype="float32", fused_attention=True)
        got = (cfg.d_model, *mamba_dims(cfg), cfg.mamba.d_state,
               cfg.moe.n_experts, cfg.moe.top_k, cfg.moe.d_expert,
               cfg.n_heads, cfg.n_kv_heads, cfg.vocab_size,
               [(x.mixer, x.ffn) for x in cfg.pattern], count_params(cfg))
        want = (4096, 8192, 256, 16, 16, 2, 14336, 32, 8, 65536,
                [("mamba", "dense"), ("mamba", "moe"), ("attn", "dense")],
                JAMBA_PARAMS)
    else:
        cfg = cfg.with_(pattern=cfg.pattern * cfg.pattern_reps,
                        pattern_reps=1, dtype="float32",
                        fused_attention=True)
        got = (cfg.d_model, cfg.n_heads, cfg.vocab_size, cfg.tie_embeddings,
               mlstm_dims(cfg), slstm_dims(cfg), cfg.xlstm.chunk,
               [x.mixer for x in cfg.pattern].count("mlstm"),
               [x.mixer for x in cfg.pattern].count("slstm"),
               count_params(cfg))
        want = (768, 4, 50304, True, (1536, 384), (768, 192, 1024), 256,
                10, 2, XLSTM_PARAMS)
    check(got == want, f"{arch} widths {got}")
    return cfg


class AloneDecoder:
    """Token-by-token decode from an empty cache through ``Server``'s
    decode program (a CUDA graph, captured once: the cache is one set of
    tensors, reset to ``init_cache``'s values before each sequence):
    ``run(prompt (B, S) int32, n_new)`` feeds the prompt one token a step,
    then ``n_new − 1`` greedy tokens, and returns (the logits after the
    prompt's last token, the ``n_new`` greedy tokens)."""

    def __init__(self, cfg, serving, batch: int, max_len: int):
        from repro_torch.models import transformer as tf
        from repro_torch.runtime import server as srv
        from repro_torch.tree import tree_leaves
        self.server = srv.Server(cfg, serving, max_len=max_len,
                                 device="cuda")
        self.cache = tf.init_cache(cfg, batch, max_len, device="cuda")
        self.pairs = list(zip(tree_leaves(self.cache), tree_leaves(
            tf.init_cache(cfg, batch, max_len, device="cuda"))))

    @torch.inference_mode()
    def run(self, prompt, n_new: int):
        for dst, src in self.pairs:
            dst.copy_(src)
        decode = self.server._decode
        pos = torch.zeros(prompt.shape[0], dtype=torch.int64, device="cuda")
        for t in range(prompt.shape[1]):
            tok, pos, _, logits = decode(self.cache, prompt[:, t], pos, None,
                                         0.0)
        first = logits.clone()
        toks = [tok.clone()]
        for _ in range(n_new - 1):
            tok, pos, _, _ = decode(self.cache, tok, pos, None, 0.0)
            toks.append(tok.clone())
        return first, torch.stack(toks, 1)


def prefill_against_decode(label: str, cfg, serving, power: str,
                           seed: int, chunk: int) -> None:
    """The prefill's last logits on 2 prompts of two scan chunks
    (``chunk`` tokens each) against decode token by token from an empty
    cache (``AloneDecoder``), within the reference's rtol 2e-3 / atol
    2e-3 (``tests/test_models.py``): the chunked scans, the state carried
    from one chunk to the next included, against their recurrences at
    full width."""
    from repro_torch.models import transformer as tf
    from repro_torch.models.layers import unembed
    n = 2 * chunk
    p = torch.as_tensor(np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (2, n)), dtype=torch.int32, device="cuda")
    with torch.inference_mode():
        hidden, _ = tf.forward_hidden(serving, p, cfg)
        want = unembed(serving["embed"], hidden[:, -1:], cfg)[:, 0]
    alone = AloneDecoder(cfg, serving, 2, n)
    alone.run(p[:, :1], 1)                  # the capture
    torch.cuda.synchronize()
    t0 = time.time()
    got, _ = alone.run(p, 1)
    torch.cuda.synchronize()
    step_ms = (time.time() - t0) / n * 1e3
    err = (got - want).abs()
    check(bool((err <= 2e-3 + 2e-3 * want.abs()).all()),
          f"{label} prefill vs token-by-token decode: max|Δ|="
          f"{float(err.max()):.3g}")
    print(f"{label} prefill (2 x {n}, {n // chunk} chunks of {chunk}) vs "
          f"token-by-token decode from an empty cache: "
          f"max|Δlogit|={float(err.max()):.3g} "
          f"max|logit|={float(want.abs().max()):.3g} (rtol 2e-3, atol 2e-3) "
          f"decode_ms_per_step={step_ms:.2f} (CUDA graph) [{power}]",
          flush=True)


def k_tasks() -> list:
    """Path K's tasks on jamba's layers 2–4 (s0/pos0–pos2): 4-bit k=16 on
    each Mamba layer's in_proj|out_proj and each dense FFN's w_gate|w_up,
    8-bit k=64 on each Mamba layer's x_proj|dt_proj and the attention,
    ℓ0 at 5% on both dense FFNs' w_down as one vector."""
    from repro_torch.core import AsVector, CompressionTask
    from repro_torch.core.schemes import (
        AdaptiveQuantization, ConstraintL0Pruning)
    q4, q8 = dict(k=16, iters=10), dict(k=64, iters=10)
    tasks = [CompressionTask("ffn_down", r"^stages/s0/pos(0|2)/ffn/w_down$",
                             AsVector(), ConstraintL0Pruning(
                                 kappa=JAMBA_KAPPA))]
    for i in (0, 1):
        pre = rf"^stages/s0/pos{i}/mixer/"
        tasks += [CompressionTask(f"mamba4_{i}", pre + "(in_proj|out_proj)$",
                                  AsVector(), AdaptiveQuantization(**q4)),
                  CompressionTask(f"mamba8_{i}", pre + "(x_proj|dt_proj)$",
                                  AsVector(), AdaptiveQuantization(**q8))]
    tasks += [CompressionTask(f"ffn{i}", rf"^stages/s0/pos{i}/ffn/"
                              r"(w_gate|w_up)$", AsVector(),
                              AdaptiveQuantization(**q4)) for i in (0, 2)]
    tasks.append(CompressionTask("attn", r"^stages/s0/pos2/mixer/"
                                 r"(wq|wk|wv|wo)$", AsVector(),
                                 AdaptiveQuantization(**q8)))
    return tasks


def l1_tasks(cfg) -> list:
    """Path L1's tasks: 4-bit k=16 per layer on the reference twin's set
    wq|wk|wv|up_proj|down_proj|w."""
    from repro_torch.core import AsVector, CompressionTask
    from repro_torch.core.schemes import AdaptiveQuantization
    return [CompressionTask(f"layer{i}", rf"^stages/s0/pos{i}/mixer/"
                            r"(wq|wk|wv|up_proj|down_proj|w)$", AsVector(),
                            AdaptiveQuantization(k=16, iters=10))
            for i in range(cfg.n_layers)]


def main_path_k(kern, k1, k2, power: str) -> dict:
    """jamba-v0.1-52b at full width, layers 2–4 of its super-block: 4-bit
    k=16 on each Mamba layer's in_proj|out_proj and each dense FFN's
    w_gate|w_up (K4), 8-bit k=64 on each Mamba layer's x_proj|dt_proj and
    the attention (K5), ℓ0 at 5% on both dense FFNs' w_down as one vector
    (the bisection and K3); the expert stacks stay dense. LC init, one C
    step, the bridge, ``Server.generate`` (2 × 1024), the served checks,
    prefill against decode (MoE at the no-drop capacity 8.0), then an
    engine trace whose re-admitted slots must hold ``init_cache``'s
    states. Returns the path's record, whose ``served`` holds the
    serving tree, the prompts and the generated tokens for
    ``profile_ssm``."""
    import dataclasses
    import inspect
    from repro_torch.kernels.kmeans import ops as kops
    from repro_torch.kernels.prune import ops as pops
    from repro_torch.models import ssm
    from repro_torch.models.ssm import mamba_dims
    cfg = ssm_config("jamba-v0.1-52b")
    run = serve_path(kern, "K", cfg, k_tasks(), SSM_PROMPT, power,
                     seeds=K_SEEDS,
                     capture=[(pops, "topk_threshold_batched"),
                              (pops, "mask_apply_batched"),
                              (kops, "kmeans_lloyd_batched")])
    check(run["kinds"] == {"quant4": 8, "quant8": 8, "sparse": 2},
          f"K bridged forms {run['kinds']}")
    # generate: each quantized matrix once a token, K6 once at prefill;
    # the C step: one fused Lloyd loop a k-means group, one bisection
    want = only(kern, K1loop=run["kmeans_groups"], K2loop=1, K3=1,
                K4=8 * SERVE_GEN, K5=8 * SERVE_GEN, K6=1)
    check(run["launches"] == want, f"K launches {run['launches']} != {want}")
    theta = run["state"]["tasks"]["ffn_down"]["theta"]["theta"]
    bis, masks, lloyd = run.pop("calls")
    check(theta.numel() == 2 * JAMBA_FFN, f"K pruned weights {theta.numel()}")
    di, dtr = mamba_dims(cfg)
    d, ds = cfg.d_model, cfg.mamba.d_state
    items = {(1, d * 2 * di + di * d), (1, di * (dtr + 2 * ds) + dtr * di),
             (1, 2 * d * cfg.d_ff),
             (1, 2 * d * (cfg.q_dim + cfg.kv_dim))}
    shapes = {tuple(a[0].shape[1:]) for a, _, _ in lloyd}
    check(shapes == {(p,) for _, p in items}
          and sum(a[0].shape[0] for a, _, _ in lloyd) == 7,
          f"K Lloyd loops {[tuple(a[0].shape) for a, _, _ in lloyd]}")
    del run["state"], run["lc"]
    check_served("path K", cfg, run, power)
    out = {"launches": run["launches"], "peak_gib": run["peak_gib"],
           "served": ("K", cfg, run["serving"], run["prompts"],
                      run["tokens"])}
    serving = run["serving"]
    del run
    torch.cuda.empty_cache()
    no_drop = cfg.with_(moe=dataclasses.replace(cfg.moe,
                                                capacity_factor=8.0))
    chunk = inspect.signature(ssm.mamba_forward).parameters["chunk"].default
    prefill_against_decode("path K", no_drop, serving, power, 25, chunk)
    out["engine"] = engine_trace(kern, "K engine", cfg, serving, 16,
                                 (32, 384), (16, 64), power)
    torch.cuda.empty_cache()
    server_against_eager("path K", cfg, serving, out["served"][3], power)
    gc.collect()
    torch.cuda.empty_cache()
    engine_against_eager("path K", cfg, serving, power)
    torch.cuda.empty_cache()
    out["lloyd"] = check_lloyd_at(k1, lloyd, "K", power)
    del lloyd
    torch.cuda.empty_cache()
    out.update(topk_at(k2, (bis, masks), theta, JAMBA_KAPPA, "K", power))
    del bis, masks, theta
    torch.cuda.empty_cache()
    return out


def single_slot_agreement(cfg, serving, power: str):
    """The ``after`` of path L1's engine trace: each request again alone,
    token by token from an empty one-slot cache (its prompt, then greedy
    decode; ``AloneDecoder``), and its greedy agreement with the engine's
    tokens; printed, not asserted (a batch of 8 against a batch of 1 may
    flip a near-tied argmax at full width; the CPU tests hold the engine
    to scalar decode token for token)."""

    def after(reqs, fin):
        alone = AloneDecoder(cfg, serving, 1, max(
            len(r.prompt) + r.max_new for r in reqs))
        agree = []
        for r in reqs:
            _, toks = alone.run(torch.as_tensor(r.prompt, dtype=torch.int32,
                                                device="cuda")[None],
                                r.max_new)
            agree.append(float(np.mean(toks[0].cpu().numpy()
                                       == fin[r.id].tokens)))
        print(f"path L1 engine against each request decoded alone (one "
              f"slot, token by token): greedy agreement per request "
              f"{[round(a, 4) for a in agree]} mean={np.mean(agree):.4f} "
              f"[{power}]", flush=True)
    return after


def main_path_l1(kern, k1, power: str) -> dict:
    """xlstm-125m at full width and depth (10 mLSTM, 2 sLSTM blocks,
    unrolled): 4-bit k=16 per layer on the reference twin's set
    wq|wk|wv|up_proj|down_proj|w (K1, then K4 in serving); LC init, one C
    step, the bridge, ``Server.generate`` (2 × 1024), the served checks,
    prefill against decode, then an engine trace whose re-admitted slots
    must hold ``init_cache``'s states (m at −30), each request's agreement
    with its own single-slot decode printed. Returns the path's record,
    with ``served`` as path K's."""
    from repro_torch.kernels.kmeans import ops as kops
    from repro_torch.models.ssm import mlstm_dims, slstm_dims
    cfg = ssm_config("xlstm-125m")
    run = serve_path(kern, "L1", cfg, l1_tasks(cfg), SSM_PROMPT, power,
                     seeds=L1_SEEDS,
                     capture=[(kops, "kmeans_lloyd_batched")])
    check(run["kinds"] == {"quant4": 10 * 5 + 2 * 3},
          f"L1 bridged forms {run['kinds']}")
    want = only(kern, K1loop=run["kmeans_groups"], K4=56 * SERVE_GEN)
    check(run["launches"] == want, f"L1 launches {run['launches']} != {want}")
    (lloyd,) = run.pop("calls")
    (di, _), (_, _, ff), d = mlstm_dims(cfg), slstm_dims(cfg), cfg.d_model
    items = sorted([(10, d * 2 * di + 3 * di * di + di * d),
                    (2, d * 4 * d + d * 2 * ff + ff * d)])
    got = sorted((1, a[0].shape[1]) for a, _, _ in lloyd
                 for _ in range(a[0].shape[0]))
    check(got == sorted(x for n, p in items for x in [(1, p)] * n),
          f"L1 Lloyd loops {[tuple(a[0].shape) for a, _, _ in lloyd]}")
    del run["state"], run["lc"]
    check_served("path L1", cfg, run, power)
    out = {"launches": run["launches"], "peak_gib": run["peak_gib"],
           "served": ("L1", cfg, run["serving"], run["prompts"],
                      run["tokens"])}
    serving = run["serving"]
    del run
    torch.cuda.empty_cache()
    prefill_against_decode("path L1", cfg, serving, power, 27,
                           cfg.xlstm.chunk)
    out["engine"] = engine_trace(
        kern, "L1 engine", cfg, serving, 16, (32, 384), (16, 64), power,
        after=single_slot_agreement(cfg, serving, power), kernels=("K4",))
    torch.cuda.empty_cache()
    server_against_eager("path L1", cfg, serving, out["served"][3], power)
    engine_against_eager("path L1", cfg, serving, power)
    torch.cuda.empty_cache()
    out["lloyd"] = check_lloyd_at(k1, lloyd, "L1", power)
    del lloyd
    torch.cuda.empty_cache()
    return out


def l2_groups(cfg) -> list:
    """L2's k-means groups as (items, weights an item), from the widths:
    ``AsStacked`` makes each layer of each matched stack an item, and
    items of one size share a group (one fused Lloyd loop)."""
    from repro_torch.models.ssm import mlstm_dims, slstm_dims
    (di, _), (_, _, ff), d = mlstm_dims(cfg), slstm_dims(cfg), cfg.d_model
    kinds = [x.mixer for x in cfg.pattern]
    sizes = ([di * di] * 3 + [d * 2 * di, di * d]) * kinds.count("mlstm") \
        + [d * 4 * d, d * 2 * ff, ff * d] * kinds.count("slstm")
    return sorted((sizes.count(p) * cfg.pattern_reps, p) for p in set(sizes))


def main_path_l2(kern, k1, power: str) -> dict:
    """LC training of xlstm-125m on the card: the twin of
    ``examples/train_lm_compress.py`` (``train_lm_compress.make_trainer``
    on the published config, float32, remat): AdamW on ``TokenStream``
    at 4 × 1024 tokens a step, 2 μ × 3 L steps, serial; per-layer K=16
    codebooks on wq|wk|wv|up_proj|down_proj|w. Checks the records (finite
    losses, CE falling, the §7 monitor, the reference's compression
    ratio) and exactly one fused Lloyd loop a k-means group each C step,
    the groups those of ``l2_groups`` and the last C step's loops held
    against the iterated and plain loops (``check_lloyd_at``); prints the
    train step's median ms, tokens/s, C-step ms and peak memory (the
    median over the steps after the first, which pays cuBLAS's and the
    allocator's warm-up; the LC wall time holds it). Returns the
    launches."""
    from repro_torch import train_lm_compress as twin
    from repro_torch.kernels.kmeans import ops as kops
    cfg = twin.model_config(True)
    check((cfg.name, cfg.d_model, cfg.n_layers, cfg.dtype, cfg.remat)
          == ("xlstm-125m", 768, 12, "float32", True), "L2 config")
    want_groups = l2_groups(cfg)
    trainer = twin.make_trainer(cfg, lc_steps=L2_LC, steps_per_l=L2_STEPS,
                                batch=L2_BATCH, seq=L2_SEQ, device="cuda")
    events = []
    step = trainer._train_step

    def timed(st, batch):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = step(st, batch)
        end.record()
        events.append((start, end))
        return out

    trainer._train_step = timed
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset(kern)
    t0 = time.time()
    with calls_of(kops, "kmeans_lloyd_batched",
                  len(want_groups) * (L2_LC - 1)) as lloyd:
        state, _ = trainer.run(0)
    torch.cuda.synchronize()
    wall = time.time() - t0
    n = launches(kern)
    peak = torch.cuda.max_memory_allocated() / 2**30
    step_ms = [a.elapsed_time(b) for a, b in events]
    hist = trainer.history
    check(len(hist) == L2_LC, "L2 records")
    for h in hist:
        check(h["c_step_violations"] == [], f"L2 §7 monitor {h}")
        check(math.isfinite(h["loss"]) and math.isfinite(h["ce"]),
              f"L2 losses {h['loss']} {h['ce']}")
    check(hist[-1]["ce"] < hist[0]["ce"],
          f"L2 ce {hist[0]['ce']} -> {hist[-1]['ce']}")
    groups = trainer.lc.group_summary(state["params"])
    n_groups = sum(g["solver"] == "kmeans_lloyd" for g in groups)
    got = sorted((g["items"], math.prod(g["item_shape"])) for g in groups)
    check(got == want_groups, f"L2 groups {got} != {want_groups}")
    loops = sorted(tuple(a[0].shape) for a, _, _ in lloyd)
    check(loops == want_groups, f"L2 Lloyd loops of the last C step "
          f"{loops} != {want_groups}")
    check(n == only(kern, K1loop=n_groups * L2_LC),
          f"L2 launches {n} (want {n_groups} Lloyd loops a C step)")
    # the reference's ratio: 32 bits a weight against 4-bit indices and a
    # 16-entry f32 codebook an item (one item a layer and matrix stack)
    sizes = [g["items"] * math.prod(g["item_shape"]) for g in groups]
    items = sum(g["items"] for g in groups)
    weights = sum(sizes)
    ratio = 32.0 * weights / (4 * weights + 16 * 32 * items)
    check(all(abs(h["compression_ratio"] / ratio - 1) < 1e-12 for h in hist),
          f"L2 ratio {hist[-1]['compression_ratio']} != {ratio}")
    med = statistics.median(step_ms[1:])
    print(f"path L2 (xlstm-125m LC training, {L2_BATCH}x{L2_SEQ} tokens a "
          f"step, {L2_LC} mu x {L2_STEPS} L steps, serial): "
          f"lc_wall_s={wall:.3f} steps={len(step_ms)} "
          f"first_step_ms={step_ms[0]:.2f} median_step_ms={med:.2f} "
          f"tokens_per_s={L2_BATCH * L2_SEQ / med * 1e3:.1f} "
          f"c_step_ms={[round(h['c_step_ms'], 2) for h in hist]} "
          f"loss={[round(h['loss'], 4) for h in hist]} "
          f"ce={[round(h['ce'], 4) for h in hist]} "
          f"ratio={hist[-1]['compression_ratio']:.4f} groups={n_groups} "
          f"({items} items, {weights:,} weights) peak_memory_gib={peak:.2f} "
          f"launches={ {k: v for k, v in n.items() if v} } [{power}]",
          flush=True)
    del trainer, state
    torch.cuda.empty_cache()
    check_lloyd_at(k1, lloyd, "L2", power)
    return n


@contextlib.contextmanager
def ranges_on(module, names: dict):
    """Run each function ``module.<attr>`` of ``names`` inside a
    ``torch.profiler.record_function`` range of the name given."""
    saved = {a: getattr(module, a) for a in names}

    def wrap(fn, label):
        def run(*args, **kw):
            with torch.profiler.record_function(label):
                return fn(*args, **kw)
        return run

    for a, label in names.items():
        setattr(module, a, wrap(saved[a], label))
    try:
        yield
    finally:
        for a, fn in saved.items():
            setattr(module, a, fn)


def profile_ssm(kern, served: list, power: str) -> None:
    """One ``torch.profiler`` session over path K's prefill (2 × 1024)
    and 8 decode steps, then path L1's, on the served models the paths
    built (``served``: (name, cfg, serving tree, prompts, generated
    tokens) each): the device's busy share and top kernels
    (``device_profile``), each phase's device time, and the share of it
    in the selective scan's chunks (Mamba), the mLSTM chunks and the
    sLSTM cell steps (plain PyTorch ops, no kernel of the port): the
    device time of each range's kernels, read from the profiler's event
    tree."""
    from torch.autograd import DeviceType
    from repro_torch.models import ssm
    from repro_torch.models import transformer as tf
    from repro_torch.models.layers import unembed
    from repro_torch.runtime import server as srv
    phases = []
    max_len = SSM_PROMPT + SERVE_GEN
    for name, cfg, serving, prompts, toks in served:
        @torch.inference_mode()
        def phase(cfg=cfg, serving=serving, prompts=prompts, toks=toks,
                  name=name, max_len=max_len):
            with torch.profiler.record_function(f"path {name} prefill"):
                hidden, _, caches = tf.forward_hidden(
                    serving, prompts, cfg, return_caches=True)
                unembed(serving["embed"], hidden[:, -1:], cfg)
                caches = srv.pad_caches_to(caches, cfg, SSM_PROMPT, max_len)
            with torch.profiler.record_function(f"path {name} decode"):
                for i in range(8):
                    tf.decode_step(serving, caches, toks[:, i:i + 1],
                                   SSM_PROMPT + i, cfg)
        phases.append(phase)
    scans = {"_mamba_chunk": "ssm::selective_scan_chunk",
             "_mlstm_chunk": "ssm::mlstm_chunk",
             "_slstm_cell": "ssm::slstm_cell"}

    def both():
        for fn in phases:
            fn()

    for fn in phases:                    # warm: the first call's set-up
        fn()

    with ranges_on(ssm, scans):
        _, events = device_profile(
            both, "paths K and L1 (prefill 2x1024 + 8 decode steps each)",
            power, kern)

    def inside(e, name):
        return sum(c.device_time_total if c.name == name else inside(c, name)
                   for c in e.cpu_children)

    for name, *_ in served:
        for phase in ("prefill", "decode"):
            outer = [e for e in events if e.name == f"path {name} {phase}"
                     and e.device_type == DeviceType.CPU]
            total = sum(e.device_time_total for e in outer)
            parts = {r: sum(inside(e, r) for e in outer)
                     for r in scans.values()}
            check(total > 0, f"profile: no device time in path {name} "
                  f"{phase}")
            print(f"profile path {name} {phase}: device_ms={total / 1e3:.3f} "
                  + " ".join(f"{r}_ms={v / 1e3:.3f} ({v / total:.1%})"
                             for r, v in parts.items() if v)
                  + f" [{power}]", flush=True)


def _chunked_against_one(label: str, tasks, xs, thetas, n_chunks: int,
                         kern) -> dict:
    """``grouped_compress`` of one group in one launch (planner off) and
    with the planner on, ``CHUNK_BUDGET_BYTES`` forced so that the plan
    has ``n_chunks`` launches: Θ and Δ(Θ) bit for bit. Returns each
    run's seconds and launches."""
    from repro_torch.analysis import cost
    from repro_torch.core.grouping import (
        _plan_multi_group, _task_solver, grouped_compress)
    from repro_torch.tree import tree_leaves
    mu = torch.tensor(1e-4, device="cuda")
    counts = [t.view.item_count(xs[t.name]) for t in tasks]
    solver_fn, _ = _task_solver(tasks[0].scheme, "auto", "cuda")
    plan = _plan_multi_group(tasks, xs, thetas, counts, solver_fn, "auto",
                             "cuda")
    cost.CHUNK_BUDGET_BYTES = plan.working_set_bytes // n_chunks + 1
    cost.clear_caches()
    forced = _plan_multi_group(tasks, xs, thetas, counts, solver_fn, "auto",
                               "cuda")
    cost.CHUNK_BUDGET_BYTES = None
    cost.clear_caches()
    if forced.n_chunks != n_chunks:
        return _not_chunked(label, tasks, xs, thetas, counts, solver_fn,
                            n_chunks, forced, mu)
    runs = {}
    for name, budget in (("one", None),
                         ("chunked", plan.working_set_bytes // n_chunks + 1)):
        cost.CHUNK_BUDGET_BYTES = budget
        cost.clear_caches()
        reset(kern)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = grouped_compress(tasks, xs, thetas, mu, backend="auto",
                               device="cuda",
                               planner="on" if budget else None)
        torch.cuda.synchronize()
        runs[name] = (out, time.perf_counter() - t0, {
            k: v for k, v in launches(kern).items() if v})
    cost.CHUNK_BUDGET_BYTES = None
    cost.clear_caches()
    for t in tasks:
        one, chunked = (tree_leaves(runs[r][0][t.name]) for r in
                        ("one", "chunked"))
        check(all(torch.equal(a, b) for a, b in zip(one, chunked)),
              f"{label}: {t.name} chunked differs from one launch")
    print(f"{label}: {len(tasks)} tasks, {sum(counts)} items; "
          f"{n_chunks} launches (CHUNK_BUDGET_BYTES forced) against one: "
          f"Θ and Δ(Θ) bit for bit; seconds {runs['chunked'][1]:.3f} "
          f"against {runs['one'][1]:.3f}; launches {runs['chunked'][2]} "
          f"against {runs['one'][2]}", flush=True)
    return {r: runs[r][1:] for r in runs}


def _not_chunked(label: str, tasks, xs, thetas, counts, solver_fn,
                 n_chunks: int, plan, mu) -> dict:
    """A group that the planner keeps in one launch over the budget (its
    solver's bits depend on the batch): the plan's fallback, and how far
    ``n_chunks`` launches forced past the planner are from one launch."""
    from repro_torch.core.grouping import (
        _group_solve, _item_packer, _pack_warm, _run_group_solve)
    check(plan.n_chunks == 1 and any(f.startswith("chunking-disabled:")
                                     for f in plan.fallbacks),
          f"{label}: plan {plan}")
    warm, _ = _pack_warm(tasks, thetas, counts, solver_fn, "cuda")
    solve = _group_solve(tasks[0].scheme, solver_fn, mu)
    a = [torch.cat([p[2][1] for p in _run_group_solve(
        solve, (_item_packer(tasks, xs, counts),) + warm, sum(counts), n)])
        for n in (1, n_chunks)]
    print(f"{label}: the planner keeps one launch over the budget "
          f"({[f for f in plan.fallbacks if 'chunking' in f]}); "
          f"{n_chunks} launches forced past it against one: Δ(Θ) "
          f"bit for bit={torch.equal(a[0], a[1])}, max|Δ|="
          f"{float((a[0] - a[1]).abs().max()):.3g}", flush=True)
    return {}


def chunks_path(kern, k1, power: str) -> None:
    """A chunked group against its one launch, in a process of its own
    (``--chunks``): I1's former 4 expert items (4 × 469,762,048, K=16,
    10 Lloyd steps) split into 4 launches by a forced chunk budget, Θ
    (codebooks, assignments) and Δ(Θ) bit for bit; the Lloyd loop over
    those 4 items timed in one launch, in 2 chunks with the group's
    partition (what the planner runs) and in 2 chunks with their own
    (not bit-identical; the time of the other design); then a top-κ
    group (4 × 25,165,824, κ = 5%) chunked against one launch, and a
    low-rank group (4 × 3072², rank 128), which the planner keeps in one
    launch because cuBLAS's batched products change bits with the batch:
    how far 4 forced launches land from one is printed."""
    from repro_torch.core import AsIs, AsVector, CompressionTask
    from repro_torch.core.grouping import _chunk_bounds
    from repro_torch.core.schemes import (
        AdaptiveQuantization, ConstraintL0Pruning, LowRank)
    from repro_torch.core.schemes.quantize import QuantTheta, quantile_init
    from repro_torch.kernels.build import group_partition
    g = torch.Generator(device="cuda").manual_seed(22)
    stamp("chunked against one launch: I1's 4 expert items")
    tasks = [CompressionTask(f"e{i}", ".", AsVector(),
                             AdaptiveQuantization(k=16, iters=10))
             for i in range(4)]
    xs = {t.name: 0.02 * torch.randn(MIX_ITEM, device="cuda", generator=g)
          for t in tasks}
    thetas = {t.name: QuantTheta(
        quantile_init(xs[t.name], 16),
        torch.zeros(MIX_ITEM, dtype=torch.int32, device="cuda"))
        for t in tasks}
    torch.cuda.reset_peak_memory_stats()
    _chunked_against_one("chunks I1 experts", tasks, xs, thetas, 4, kern)
    print(f"chunks I1 experts: peak_memory_gib="
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f}", flush=True)
    w = torch.stack([xs[t.name] for t in tasks])
    cb = torch.stack([torch.sort(thetas[t.name].codebook).values
                      for t in tasks])
    del xs, thetas
    halves = _chunk_bounds(4, 2)

    def chunks(partition):
        with group_partition(partition):
            for lo, hi in halves:
                k1.kmeans_lloyd_batched(w[lo:hi], cb[lo:hi], 10)

    one, group_part, own_part = timed_turns(
        [lambda: k1.kmeans_lloyd_batched(w, cb, 10),
         lambda: chunks(4), lambda: chunks(0)], 3)
    b_ms, b_by, _ = lloyd_bound(k1, w, 16, 10)
    print(f"chunks I1 Lloyd loop I=4 P={MIX_ITEM} K=16 iters=10: one launch "
          f"ms={one:.3f}; 2 chunks of 2 in the group's partition (the "
          f"planner's, bit for bit) ms={group_part:.3f}; 2 chunks in their "
          f"own partition ms={own_part:.3f}; bound_ms={b_ms:.3f} ({b_by}) "
          f"[{power}]", flush=True)
    del w, cb
    torch.cuda.empty_cache()

    stamp("chunked against one launch: low rank and top-κ")
    tasks = [CompressionTask(f"lr{i}", ".", AsIs(), LowRank(128))
             for i in range(4)]
    xs = {t.name: torch.randn((LM_D_MODEL, LM_D_MODEL), device="cuda",
                              generator=g) / LM_D_MODEL ** 0.5
          for t in tasks}
    thetas = {t.name: {"u": torch.zeros((LM_D_MODEL, 128), device="cuda"),
                       "v": torch.zeros((LM_D_MODEL, 128), device="cuda")}
              for t in tasks}
    _chunked_against_one("chunks low rank", tasks, xs, thetas, 4, kern)
    kappa = int(0.05 * LM_ITEM)
    tasks = [CompressionTask(f"p{i}", ".", AsVector(),
                             ConstraintL0Pruning(kappa=kappa))
             for i in range(4)]
    xs = {t.name: torch.randn(LM_ITEM, device="cuda", generator=g)
          for t in tasks}
    thetas = {t.name: {"theta": torch.zeros(LM_ITEM, device="cuda")}
              for t in tasks}
    _chunked_against_one("chunks top-κ", tasks, xs, thetas, 4, kern)
    del xs, thetas
    # the item-by-item path (path F's w_down scheme, at 1M weights an
    # item): does its solve take a capture?
    stamp("compile_group on the item-by-item path")
    from repro_torch.core.grouping import CaptureError
    from repro_torch.core.schemes import AdditiveCombination
    tasks = [CompressionTask(f"a{i}", ".", AsVector(), AdditiveCombination(
        [ConstraintL0Pruning(10_000), AdaptiveQuantization(k=16)], iters=2))
        for i in range(2)]
    xs = {t.name: torch.randn(1 << 20, device="cuda", generator=g)
          for t in tasks}
    thetas = {t.name: t.scheme_init(xs[t.name]) for t in tasks}
    mu = torch.tensor(1e-4, device="cuda")
    try:
        captured_against_eager("chunks additive group (item by item)", tasks,
                               xs, thetas, (mu, mu * 2.0), power)
    except CaptureError as e:
        print(f"chunks additive group (item by item): {e}", flush=True)
    stamp("done")


def busy_path(kern, label: str, power: str) -> None:
    """``python3 chip_smoke.py --busy C|K|L1``: path ``label``'s served
    model made again (``serve_path``), then ``serving_busy`` on it, in a
    process with no earlier profiler session."""
    if label == "C":
        cfg, tasks, prompt_len, seeds = (serving_config(), c_tasks(),
                                         SERVE_PROMPT, (2, 4))
    elif label == "K":
        cfg, tasks, prompt_len, seeds = (ssm_config("jamba-v0.1-52b"),
                                         k_tasks(), SSM_PROMPT, K_SEEDS)
    else:
        cfg = ssm_config("xlstm-125m")
        tasks, prompt_len, seeds = l1_tasks(cfg), SSM_PROMPT, L1_SEEDS
    run = serve_path(kern, f"{label} (busy shares)", cfg, tasks, prompt_len,
                     power, seeds)
    serving = run["serving"]
    prompts, toks = run["prompts"], run["tokens"]
    del run
    gc.collect()
    torch.cuda.empty_cache()
    serving_busy(kern, label, cfg, serving, prompts, toks, power)
    stamp("done")


def ssm_paths(kern, k1, k2, power: str) -> None:
    """``python3 chip_smoke.py --ssm``: paths L1 and K, then one profile
    over both served models (``profile_ssm``), each model built once; L1
    first, so that K's serving tree (~13 GiB) is not held through L1's
    peak. ``main`` runs this in a process of its own, last: a profiler
    session after the SSM profile saw 47 of 50 K9 launches, and the
    profiler slows every later launch of its process. The paths'
    launches end the output as the line ``ssm_launches {json}``."""
    stamp("path L1")
    path_l1 = main_path_l1(kern, k1, power)
    stamp("path K")
    path_k = main_path_k(kern, k1, k2, power)
    stamp("profile of paths K and L1")
    profile_ssm(kern, [path_k.pop("served"), path_l1.pop("served")], power)
    stamp("done")
    print(SSM_LAUNCHES, json.dumps({
        "K": path_k["launches"], "K engine": path_k["engine"],
        "L1": path_l1["launches"], "L1 engine": path_l1["engine"]}),
        flush=True)


def main() -> int:
    src = ROOT / "src"
    if not (src / "repro_torch" / "kernels" / "csrc").is_dir():
        print("chip_smoke: run from a checkout of the repository "
              "(src/repro_torch is missing)", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script needs an "
              "NVIDIA GPU", file=sys.stderr)
        return 1
    sys.path.insert(0, str(src))
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    card = smi.stdout.strip().splitlines()[0]
    print(card)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}", flush=True)

    from repro_torch.kernels import build
    from repro_torch.kernels.flash_attention import flash_attention as k6
    from repro_torch.kernels.prune import prune as k2
    from repro_torch.kernels.quant_matmul import quant_matmul as k45
    # the package exports the Lloyd loop ``kmeans``, which shadows the
    # kernel module of the same name
    k1 = importlib.import_module("repro_torch.kernels.kmeans.kmeans")
    if sys.argv[1:] == ["--host-cost"]:
        build.build(["kmeans_assign_moments.cu", "count_above.cu"])
        host_launch_cost(k1, k2, card)
        return 0
    t0 = time.time()
    logs = build.build(build.SOURCES)
    print(f"build_s={time.time() - t0:.2f} sources={sorted(logs)}")
    for src_name, log in logs.items():
        for line in log.splitlines():
            if "Function properties for" in line:
                print(f"  {src_name}: {kernel_name(line.split()[-1])}")
            elif "registers" in line or "spill" in line:
                print(f"  {src_name}:   {line.strip()}")

    # every kernel's launch counter (K7–K9 are the single-vector wrappers
    # of the K1–K3 sources; K1loop and K2loop the fused Lloyd loop and
    # bisection of the K1 and K2 sources, at any I)
    kern = {"K1": k1.KERNEL, "K2": k2.KERNEL, "K3": k2.MASK_KERNEL,
            "K4": k45.KERNEL_PACKED4, "K5": k45.KERNEL_U8, "K6": k6.KERNEL,
            "K7": k1.SINGLE, "K8": k2.COUNT_SINGLE,
            "K9": k2.MASK_SINGLE, "K1loop": k1.LLOYD, "K2loop": k2.TOPK}
    power = card.split(",")[-1].strip()
    if sys.argv[1:] == ["--ssm"]:
        ssm_paths(kern, k1, k2, power)
        return 0
    if sys.argv[1:2] == ["--busy"]:
        busy_path(kern, sys.argv[2], power)
        return 0
    if sys.argv[1:] == ["--chunks"]:
        chunks_path(kern, k1, power)
        return 0
    t_start = time.time()
    stamp('kernel phase')
    rec = kernel_phase(k1, k2, power)
    frec = fused_phase(k1, k2, power)
    paths = {"A": main_path_a(kern), "B": main_path_b(kern),
             "LM": lm_phase(kern, power)}
    stamp('serving kernels')
    srec = serve_kernel_phase(k45, k6, power)
    stamp('path C')
    path_c = main_path_c(kern, power)
    paths["C"] = path_c["launches"]
    # D: the engine on path C's model, 24 requests
    stamp('path D')
    paths["D"] = engine_trace(kern, "D", path_c["cfg"], path_c["serving"],
                              24, (32, 384), (16, 64), power)
    stamp('path D against eager')
    engine_against_eager("path D", path_c["cfg"], path_c["serving"], power)
    stamp('mask and count kernels')
    mrec = mask_count_phase(k1, k2, power)
    path_e = main_path_e(kern, power)
    paths["E"] = path_e["launches"]
    paths["G"] = main_path_g(kern, k1, path_e["problem"], power)
    host_launch_cost(k1, k2, card)
    stamp('path F')
    paths["F"] = main_path_f(kern, power)
    stamp('path H')
    paths.update(main_path_h(kern, k1, k2, power))
    stamp('path I1')
    i1 = main_path_i1(kern, k1, power)
    stamp('path I2')
    i2 = main_path_i2(kern, k1, k2, power)
    stamp('path J')
    path_j = main_path_j(kern, k1, power)
    paths.update({"I1": i1["launches"], "I2": i2["launches"],
                  "I2 engine": i2["engine"], "J": path_j["launches"],
                  "J engine": path_j["engine"]})
    stamp('path L2')
    paths["L2"] = main_path_l2(kern, k1, power)
    stamp('profiles')
    profile_phase(kern, path_c, power)
    device_times(k2, k6, mrec["K9"][0], srec["K6"][0], card)
    quant_device_times(k45, srec, card)
    cstep_device_times(k1, k2, rec, mrec, frec, card)
    print(f"jacobi kernels per round (profiler, sketch width 144): "
          f"{jacobi_kernels_per_round():.1f}", flush=True)
    # last: sessions after the overlapped one missed their first kernel
    # event before ``profiled`` opened each with an uncounted fill
    stamp('profile of path H')
    profile_path_h(kern, power)
    profile_after_overlap(k45, card)
    # paths K and L1 and their profile in a process of its own, which
    # sees no earlier profiler session (``ssm_paths``)
    del path_c
    gc.collect()
    torch.cuda.empty_cache()
    stamp("paths K and L1")
    child = subprocess.run([sys.executable, str(Path(__file__).resolve()),
                            "--ssm"], stdout=subprocess.PIPE, text=True,
                           timeout=900)
    print(child.stdout, end="", flush=True)
    check(child.returncode == 0,
          f"the process of paths K and L1 exited with {child.returncode}")
    mark = [x for x in child.stdout.splitlines()
            if x.startswith(SSM_LAUNCHES + " ")]
    check(len(mark) == 1, "paths K and L1 reported no launches")
    paths.update(json.loads(mark[0][len(SSM_LAUNCHES) + 1:]))
    # a chunked group against its one launch, in a fresh process
    stamp("chunked groups")
    child = subprocess.run([sys.executable, str(Path(__file__).resolve()),
                            "--chunks"], stdout=subprocess.PIPE, text=True,
                           timeout=600)
    print(child.stdout, end="", flush=True)
    check(child.returncode == 0,
          f"the process of the chunked groups exited with "
          f"{child.returncode}")
    # the busy shares of serving, eager and through CUDA graphs, each
    # model in a fresh process (``serving_busy``)
    for label in ("C", "K", "L1"):
        stamp(f"busy shares of path {label}")
        child = subprocess.run([sys.executable, str(Path(__file__).resolve()),
                                "--busy", label], stdout=subprocess.PIPE,
                               text=True, timeout=600)
        print(child.stdout, end="", flush=True)
        check(child.returncode == 0, f"the busy-share process of path "
              f"{label} exited with {child.returncode}")
    stamp("the kernels line")
    total = {n: sum(p[n] for p in paths.values()) for n in kern}
    print(f"launches per path: {paths}", flush=True)
    print(f"phases_s={time.time() - t_start:.1f}", flush=True)

    def entry(name, source, replaces, key, rows, main_shape):
        row = next(r for r in rows
                   if r["shape"][:len(main_shape)] == list(main_shape))
        return {"name": name, "route": "cuda", "source": source,
                "replaces": replaces, "launches": total[key],
                "max_abs_err": max(r["max_abs_err"] for r in rows),
                "ms": row["ms"], "plain_ms": row["plain_ms"],
                "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
                "library_ms": row.get("library_ms")}

    csrc = "src/repro_torch/kernels/csrc/"
    kernels = [
        entry("kmeans_assign_moments_batched",
              csrc + "kmeans_assign_moments.cu",
              "src/repro/kernels/kmeans/kmeans.py:127", "K1",
              rec["K1"]["rows"], LM_K1_SHAPE[:2]),
        entry("count_above_batched", csrc + "count_above.cu",
              "src/repro/kernels/prune/prune.py:138", "K2",
              rec["K2"]["rows"], K2_SHAPES[-1]),
        entry("mask_apply_batched", csrc + "mask_apply.cu",
              "src/repro/kernels/prune/prune.py:161", "K3", mrec["K3"],
              K3_SHAPES[0]),
        entry("quant_matmul_packed", csrc + "quant_matmul.cu",
              "src/repro/kernels/quant_matmul/quant_matmul.py:105", "K4",
              srec["K4"], K4_MAIN),
        entry("quant_matmul", csrc + "quant_matmul.cu",
              "src/repro/kernels/quant_matmul/quant_matmul.py:46", "K5",
              srec["K5"], K5_MAIN),
        entry("flash_attention", csrc + "flash_attention.cu",
              "src/repro/kernels/flash_attention/flash_attention.py:81",
              "K6", srec["K6"], K6_SHAPES[0]),
        entry("kmeans_assign_moments", csrc + "kmeans_assign_moments.cu",
              "src/repro/kernels/kmeans/kmeans.py:65", "K7", mrec["K7"],
              K7_SHAPES[0]),
        entry("count_above", csrc + "count_above.cu",
              "src/repro/kernels/prune/prune.py:54", "K8", mrec["K8"],
              (LENET_WEIGHTS,)),
        entry("mask_apply", csrc + "mask_apply.cu",
              "src/repro/kernels/prune/prune.py:76", "K9", mrec["K9"],
              (LENET_WEIGHTS,)),
        entry("kmeans_lloyd_batched", csrc + "kmeans_assign_moments.cu",
              "src/repro/kernels/kmeans/kmeans.py:127", "K1loop",
              frec["lloyd"], LM_K1_SHAPE[:2]),
        entry("topk_threshold_batched", csrc + "count_above.cu",
              "src/repro/kernels/prune/prune.py:138", "K2loop",
              frec["topk"], (LM_LAYERS, LM_ITEM)),
    ]
    check(all(k["launches"] > 0 for k in kernels), "a kernel never launched")
    check(all(math.isfinite(k["ms"]) for k in kernels), "timings")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
