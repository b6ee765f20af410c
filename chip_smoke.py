#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Run from the root of a checkout, on a machine with one CUDA card and the
CUDA toolkit (nvcc). Phases, each of which fails the run:

1. header: the card's name and power limit (nvidia-smi), torch and CUDA;
2. build: compile every CUDA source of ``src/repro_torch/kernels/csrc``
   (one nvcc process each, all started together);
3. K1 and K2 against their plain PyTorch versions on the card, at the
   main path's shapes, timed with CUDA events beside their bounds;
4. main path A — the quickstart (``repro_torch.quickstart.main``):
   LeNet300, per-layer K=4 quantization, 20 LC steps × 40 SGD steps;
   LC ≤ DC and exactly 20 × 3 × 21 K1 launches;
5. main path B — ℓ0 pruning of all LeNet300 weights at κ = 5% (13,310):
   exactly κ nonzeros after every C step, the §7 monitor, 20 × 31 K2
   launches;
6. the C step at LM width: phi3-mini-3.8b's FFN stacks (d_model 3072,
   d_ff 8192) with 4 of its 32 layers; K=16 quantization of w_gate|w_up
   (one group of 8 items × 25,165,824 weights) and ℓ0 pruning at 5% per
   item of w_down; init, then 2 × (C step + multiplier step);
7. K4, K5 and K6 (the serving kernels) against their plain versions on
   the card at the serving paths' shapes, timed beside their bounds,
   the plain versions, and a PyTorch yardstick (SDPA for K6; for K4/K5
   ``torch.matmul`` by the already-densified weight, what the
   uncompressed model pays);
8. main path C — compressed serving of phi3-mini-3.8b at full width
   (4 of 32 layers, float32, fused attention): random weights, 12
   per-layer LC tasks (4-bit k=16 on w_gate|w_up, 8-bit k=64 on
   wq|wk|wv|wo, ℓ0 at 2% on w_down), LC init and one C step (K1, K2),
   the bridge into serving forms, ``Server.generate`` of 32 tokens for
   2 prompts of 512; exact launch counts; logits against the densified
   model (cuBLAS, TF32 off), fused attention (K6) against the plain loop;
9. main path D — ``ServingEngine`` (8 slots) on the same compressed
   model: 24 Poisson requests of mixed lengths;
10. ``torch.profiler`` over path C's prefill and 8 decode steps: the
    device's busy share and the kernels that took the most time;
11. one JSON line listing every ported kernel, then the result line.

Tolerances: assignments and integer counts must be equal; K1's cluster
sums may differ from the plain version's by the summation order
(``rtol 1e-5, atol 1e-2``); the §7 monitor allows the reference's float
slack (``after ≤ before·(1 + 1e-5) + 1e-6``); K4/K5 ``rtol 1e-5, atol
1e-4`` and K6 ``rtol 2e-4, atol 2e-4`` (as ``tests/test_kernels.py``);
served logits within ``1e-3·max|logit|`` of the densified model's.

Bounds use the H100 SXM's published rates (3.35 TB/s, 67 TFLOP/s f32
outside the tensor cores), which assume a 700 W power limit.
"""
from __future__ import annotations

import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12

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
# slots), prefill M = 2 × 512
SERVE_BATCH, SERVE_PROMPT, SERVE_GEN = 2, 512, 32
SERVE_MAX_LEN = SERVE_PROMPT + SERVE_GEN
SERVE_M = (2, 8, SERVE_BATCH * SERVE_PROMPT)
W_DOWN_KAPPA = 503_316                     # 2% of 25,165,824
# (M, K, N, C); the JSON line reports the prefill row
K4_SHAPES = [(m, k, n, 16) for m in SERVE_M
             for k, n in ((3072, 8192), (8192, 3072))] + [
    (5, 33, 24, 4), (5, 33, 24, 16), (17, 300, 129, 4), (17, 300, 129, 16)]
K5_SHAPES = [(m, 3072, 3072, 64) for m in SERVE_M] + [(17, 300, 129, 8)]
K4_MAIN, K5_MAIN = (1024, 3072, 8192, 16), (1024, 3072, 3072, 64)
# (B, S, H, KV, D, window)
K6_SHAPES = [(2, 512, 32, 32, 96, 0), (1, 512, 32, 8, 96, 0),
             (1, 512, 8, 2, 64, 128), (2, 97, 6, 3, 16, 7)]


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def bound(n_bytes: float, n_ops: float) -> tuple[float, str]:
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / F32_OPS_PER_S * 1e3
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
        b_ms, b_by = bound(8.0 * i * p + 12.0 * i * k,
                           3.0 * i * p * k + 2.0 * i * p)
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


def monitor_ok(history) -> bool:
    return all(after <= before * (1 + 1e-5) + 1e-6
               for m in history
               for before, after in m.c_step_shifted_distortion.values())


def main_path_a(k1, k2) -> int:
    from repro_torch import quickstart
    k1.KERNEL.launches = k2.KERNEL.launches = 0
    t0 = time.time()
    out = quickstart.main(device="cuda")        # raises if LC > DC
    torch.cuda.synchronize()
    wall = time.time() - t0
    n1, n2 = k1.KERNEL.launches, k2.KERNEL.launches
    lc, dc = out["lc"], out["dc"]
    check(lc["test_err"] <= dc["test_err"] + 1e-6, "quickstart LC > DC")
    check(n1 == 20 * 3 * 21, f"quickstart K1 launches {n1} != 1260")
    check(n2 == 0, f"quickstart K2 launches {n2} != 0")
    check(monitor_ok(lc["history"]), "quickstart §7 monitor")
    print(f"main path A (quickstart): ref_err={out['ref']:.4f} "
          f"dc_err={dc['test_err']:.4f} lc_err={lc['test_err']:.4f} "
          f"ratio={lc['ratio']:.1f}x lc_wall_s={lc['wall_s']:.2f} "
          f"total_wall_s={wall:.2f} K1_launches={n1}", flush=True)
    return n1


def main_path_b(k1, k2) -> int:
    from repro_torch.core import AsVector, CompressionTask
    from repro_torch.core.schemes import ConstraintL0Pruning
    from repro_torch.showcase import (
        DIMS, direct_compress, reference_problem, run_lc)
    total = sum(DIMS[i] * DIMS[i + 1] for i in range(len(DIMS) - 1))
    kappa = int(total * 0.05)
    check(kappa == 13_310, f"κ {kappa}")

    def tasks():
        return [CompressionTask("p", r"l\d/w$", AsVector(),
                                ConstraintL0Pruning(kappa=kappa))]

    nnz = []

    def count_nnz(model, lc, m):
        nnz.append(int(torch.count_nonzero(
            lc["tasks"]["p"]["theta"]["theta"])))

    k1.KERNEL.launches = k2.KERNEL.launches = 0
    t0 = time.time()
    prob = reference_problem(device="cuda")
    dc = direct_compress(prob, tasks(), device="cuda")
    lc = run_lc(prob, tasks(), n_steps=20, iters_per_l=40,
                callbacks=[count_nnz], device="cuda")
    torch.cuda.synchronize()
    wall = time.time() - t0
    n1, n2 = k1.KERNEL.launches, k2.KERNEL.launches
    check(nnz == [kappa] * 20, f"ℓ0 nonzeros per C step {nnz}")
    check(monitor_ok(lc["history"]), "ℓ0 §7 monitor")
    check(n2 == 20 * 31, f"ℓ0 K2 launches {n2} != 620")
    check(n1 == 0, f"ℓ0 K1 launches {n1} != 0")
    print(f"main path B (ℓ0 κ={kappa}): dc_err={dc['test_err']:.4f} "
          f"lc_err={lc['test_err']:.4f} ratio={lc['ratio']:.1f}x "
          f"lc_wall_s={lc['wall_s']:.2f} total_wall_s={wall:.2f} "
          f"K2_launches={n2}", flush=True)
    return n2


def lm_phase(k1, k2) -> tuple[int, int]:
    from repro_torch.core import AsStacked, CompressionTask, LCAlgorithm
    from repro_torch.core.schemes import (
        AdaptiveQuantization, ConstraintL0Pruning)
    g = torch.Generator(device="cuda").manual_seed(1)
    shapes = {"w_gate": (LM_LAYERS, LM_D_MODEL, LM_D_FF),
              "w_up": (LM_LAYERS, LM_D_MODEL, LM_D_FF),
              "w_down": (LM_LAYERS, LM_D_FF, LM_D_MODEL)}
    torch.cuda.reset_peak_memory_stats()
    params = {"ffn": {n: 0.02 * torch.randn(s, device="cuda", generator=g)
                      for n, s in shapes.items()}}
    kappa = int(0.05 * LM_ITEM)
    tasks = [
        CompressionTask("quant", r"ffn/(w_gate|w_up)$", AsStacked("vector"),
                        AdaptiveQuantization(k=16, iters=10)),
        CompressionTask("prune", r"ffn/w_down$", AsStacked("vector"),
                        ConstraintL0Pruning(kappa=kappa)),
    ]
    mus = [1e-4, 1.3e-4]
    lc = LCAlgorithm(tasks, mus, device="cuda")
    groups = lc.group_summary(params)
    print("LM groups:", [(g_["tasks"], g_["items"], g_["solver"],
                          g_["backend"]) for g_ in groups], flush=True)
    check(any(g_["items"] == 2 * LM_LAYERS and g_["backend"] == "cuda"
              for g_ in groups), "LM quantization group of 8 items")
    t0 = time.time()
    state = lc.init(params)
    torch.cuda.synchronize()
    print(f"LM init_s={time.time() - t0:.2f}", flush=True)
    launches = [0, 0]
    for step, mu in enumerate(mus):
        for w in params["ffn"].values():           # stand-in for an L step
            w.add_(1e-3 * torch.randn(w.shape, device="cuda", generator=g))
        state = lc.set_mu(state, mu, step)
        pre = {n: float(v) for n, v in lc.shifted_distortion(params,
                                                             state).items()}
        k1.KERNEL.launches = k2.KERNEL.launches = 0
        torch.cuda.synchronize()
        t0 = time.time()
        state = lc.c_step(params, state)
        torch.cuda.synchronize()
        c_s = time.time() - t0
        n1, n2 = k1.KERNEL.launches, k2.KERNEL.launches
        check((n1, n2) == (11, 31), f"LM C-step launches K1={n1} K2={n2}")
        launches[0] += n1
        launches[1] += n2
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
              f"K1={n1} K2={n2} shifted_distortion="
              f"{ {n: (round(pre[n], 3), round(float(post[n]), 3)) for n in pre} }",
              flush=True)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() / 2**30
    print(f"LM peak_memory_gib={peak:.2f}", flush=True)
    del params, state
    torch.cuda.empty_cache()
    return launches[0], launches[1]


def serve_kernel_phase(k45, k6, power: str) -> dict:
    """K4, K5 and K6 against their plain versions at the serving paths'
    shapes; ``power`` (the card's power limit) is printed beside every
    time."""
    from repro_torch.kernels.quant_matmul import ops as qops
    g = torch.Generator(device="cuda").manual_seed(3)
    rec = {"K4": [], "K5": [], "K6": []}

    def gemm_case(name, m, k, n, c):
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
        b_ms, b_by = bound(4.0 * m * k + w_bytes + 4.0 * c + 4.0 * m * n,
                           2.0 * m * k * n)
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

    for b, s, h, kvh, d, window in K6_SHAPES:
        grp = h // kvh
        q = torch.randn((b, kvh, grp, s, d), device="cuda", generator=g)
        k = torch.randn((b, kvh, s, d), device="cuda", generator=g)
        v = torch.randn((b, kvh, s, d), device="cuda", generator=g)
        got = k6.flash_attention(q, k, v, window=window)
        torch.cuda.synchronize()
        want = k6.flash_attention_plain(q, k, v, window=window)
        torch.testing.assert_close(got, want, rtol=2e-4, atol=2e-4)
        err = float((got - want).abs().max())
        fns = [lambda: k6.flash_attention(q, k, v, window=window),
               lambda: k6.flash_attention_plain(q, k, v, window=window)]
        if window == 0:
            qh = q.reshape(b, h, s, d)
            fns.append(lambda: torch.nn.functional.scaled_dot_product_attention(
                qh, k, v, is_causal=True, enable_gqa=True))
        times = timed_turns(fns, 20)
        ms, plain_ms = times[:2]
        lib_ms = times[2] if window == 0 else None
        pairs = sum(min(i + 1, window) if window else i + 1 for i in range(s))
        b_ms, b_by = bound(4.0 * (2 * b * h * s * d + 2 * b * kvh * s * d),
                           4.0 * d * b * h * pairs)
        rec["K6"].append({"shape": [b, s, h, kvh, d, window], "ms": ms,
                          "plain_ms": plain_ms, "bound_ms": b_ms,
                          "bound_by": b_by, "max_abs_err": err,
                          "library_ms": lib_ms})
        print(f"K6 B={b} S={s} H={h} KV={kvh} D={d} window={window}: "
              f"ms={ms:.4f} plain_ms={plain_ms:.4f} bound_ms={b_ms:.3g} "
              f"({b_by}) sdpa_ms={lib_ms if lib_ms is None else round(lib_ms, 4)} "
              f"max|Δ|={err:.3g} [{power}]", flush=True)
        del q, k, v, got, want
    torch.cuda.empty_cache()
    return rec


def device_profile(fn, label: str, power: str) -> None:
    """Run ``fn`` once under ``torch.profiler`` and print its wall time,
    the summed time of its device kernels and copies, the device's busy
    share of the wall time, and the kernels that took the most time.
    The profiler adds host work, so the wall time here is above the
    untraced one."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    dev = [e for e in prof.key_averages()
           if e.device_type == DeviceType.CUDA]
    dev_ms = sum(e.self_device_time_total for e in dev) / 1e3
    top = sorted(dev, key=lambda e: -e.self_device_time_total)[:6]
    print(f"profile {label}: wall_ms={wall_ms:.2f} device_ms={dev_ms:.2f} "
          f"device_busy={dev_ms / wall_ms:.3f} top: " + "; ".join(
              f"{e.key[:60]} x{e.count} {e.self_device_time_total / 1e3:.3f}ms"
              for e in top) + f" [{power}]", flush=True)


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


def main_path_c(kern, power: str) -> dict:
    """LC init + one C step → bridge → ``Server.generate`` on phi3-mini at
    full width; ``kern`` maps K1, K2, K4, K5, K6 to their ``CudaKernel``s.
    Returns the path's launches and what path D needs."""
    from repro_torch.core import (
        AsVector, CompressionTask, LCAlgorithm, flatten_params)
    from repro_torch.core.schemes import (
        AdaptiveQuantization, ConstraintL0Pruning)
    from repro_torch.models import transformer as tf
    from repro_torch.models.layers import unembed
    from repro_torch.runtime import server as srv
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = serving_config()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    params = tf.init_params(torch.Generator(device="cuda").manual_seed(2),
                            cfg)
    n_params = sum(t.numel() for t in flatten_params(params).values())
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
    rng = np.random.default_rng(4)
    prompts = rng.integers(0, cfg.vocab_size, (SERVE_BATCH, SERVE_PROMPT),
                           dtype=np.int64).astype(np.int32)

    for kk in kern.values():
        kk.launches = 0
    torch.cuda.synchronize()
    t0 = time.time()
    lc = LCAlgorithm(tasks, [1e-4], device="cuda")
    state = lc.init(params)
    torch.cuda.synchronize()
    t_init = time.time() - t0
    t0 = time.time()
    state = lc.c_step(params, state)
    torch.cuda.synchronize()
    t_cstep = time.time() - t0
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
    launches = {n: kk.launches for n, kk in kern.items()}
    peak = torch.cuda.max_memory_allocated() / 2**30

    kinds = [f.split("(")[0] for fs in report.values() for f in fs.values()]
    check(sorted(kinds) == ["quant4"] * 8 + ["quant8"] * 16 + ["sparse"] * 4,
          f"bridged forms {sorted(kinds)}")
    # LC init runs no kernel (in either package); the C step runs two
    # k-means groups × (10 Lloyd steps + 1) and 30 bisection steps + 1;
    # generate runs every quantized matrix once per token (prefill + 31
    # decode steps) and K6 once per layer at prefill
    want = {"K1": 22, "K2": 31, "K4": LM_LAYERS * 2 * SERVE_GEN,
            "K5": LM_LAYERS * 4 * SERVE_GEN, "K6": LM_LAYERS}
    check(launches == want, f"path C launches {launches} != {want}")
    toks = res.tokens
    check(toks.shape == (SERVE_BATCH, SERVE_GEN) and toks.min() >= 0
          and toks.max() < cfg.vocab_size, f"generated tokens {toks.shape}")
    print(f"main path C (phi3-mini-3.8b full width, {LM_LAYERS} layers, "
          f"{n_params:,} params): init_s={t_init:.2f} c_step_s={t_cstep:.3f} "
          f"bridge_s={t_bridge:.3f} generate_s={t_gen:.3f} "
          f"({SERVE_BATCH}x{SERVE_PROMPT} prompt, {SERVE_GEN} new tokens) "
          f"peak_memory_gib={peak:.2f} launches={launches} [{power}]",
          flush=True)

    # checks, outside the counted run: the densified model (cuBLAS, TF32
    # off) teacher-forced with the compressed run's tokens
    dense = srv.densified_for_serving(params, state, lc.tasks)
    del state, lc
    prompts_t = torch.as_tensor(prompts, device="cuda")
    toks_t = torch.as_tensor(toks, device="cuda")

    @torch.inference_mode()
    def teacher(p):
        torch.cuda.synchronize()
        t0 = time.time()
        hidden, _, caches = tf.forward_hidden(p, prompts_t, cfg,
                                              return_caches=True)
        out = [unembed(p["embed"], hidden[:, -1:], cfg)[:, 0]]
        torch.cuda.synchronize()
        t_pre = time.time() - t0
        caches = srv.pad_caches_to(caches, cfg, SERVE_PROMPT, SERVE_MAX_LEN)
        t0 = time.time()
        for i in range(SERVE_GEN - 1):
            logits, caches = tf.decode_step(p, caches, toks_t[:, i:i + 1],
                                            SERVE_PROMPT + i, cfg)
            out.append(logits[:, 0])
        torch.cuda.synchronize()
        t_dec = (time.time() - t0) / (SERVE_GEN - 1)
        return torch.stack(out, dim=1), t_pre, t_dec

    lc_logits, pre_c, dec_c = teacher(serving)
    ld_logits, pre_d, dec_d = teacher(dense)
    tol = 1e-3 * float(ld_logits.abs().max())
    diff = (lc_logits - ld_logits).abs().amax(dim=(0, 2))     # per step
    check(bool((diff <= tol).all()),
          f"compressed vs densified logits: max per step {diff.tolist()} "
          f"> {tol:.3g}")
    chosen_c = torch.gather(lc_logits, 2, toks_t.long()[..., None])[..., 0]
    chosen_d = torch.gather(ld_logits, 2, toks_t.long()[..., None])[..., 0]
    check(bool((chosen_c >= lc_logits.amax(-1) - tol).all()),
          "generated tokens are not the compressed model's maxima")
    check(bool((chosen_d >= ld_logits.amax(-1) - tol).all()),
          "a generated token is off the densified model's maximum")
    agree = float((ld_logits.argmax(-1) == toks_t.long()).float().mean())
    print(f"path C vs densified: max|Δlogit|={float(diff.max()):.3g} "
          f"(tol {tol:.3g} = 1e-3·max|logit|) token_agreement={agree:.4f} "
          f"prefill_ms compressed={pre_c * 1e3:.1f} densified="
          f"{pre_d * 1e3:.1f} decode_ms_per_step compressed="
          f"{dec_c * 1e3:.2f} densified={dec_d * 1e3:.2f} [{power}]",
          flush=True)
    del dense, ld_logits, lc_logits

    # K6 inside the model: fused (the kernel) against the plain loop
    with torch.inference_mode():
        h_fused, _ = tf.forward_hidden(serving, prompts_t, cfg)
        h_plain, _ = tf.forward_hidden(
            serving, prompts_t, cfg.with_(fused_attention=False))
    torch.testing.assert_close(h_fused, h_plain, rtol=2e-4, atol=2e-4)
    print(f"path C fused vs plain attention: max|Δhidden|="
          f"{float((h_fused - h_plain).abs().max()):.3g}", flush=True)
    del h_fused, h_plain, params
    torch.cuda.empty_cache()
    return {"launches": launches, "cfg": cfg, "serving": serving,
            "prompts": prompts_t, "tokens": toks_t}


def main_path_d(kern, cfg, serving, power: str) -> dict:
    """``ServingEngine`` on the compressed model: 24 Poisson requests of
    mixed lengths through 8 slots."""
    from repro_torch.runtime import server as srv
    rng = np.random.default_rng(5)
    t, reqs = 0.0, []
    for i in range(24):
        t += float(rng.exponential(0.02))
        n = int(rng.integers(32, 385))
        reqs.append(srv.Request(
            id=i, prompt=rng.integers(1, cfg.vocab_size, size=n)
            .astype(np.int32), max_new=int(rng.integers(16, 65)),
            arrival=t))
    for kk in kern.values():
        kk.launches = 0
    torch.cuda.synchronize()
    t0 = time.time()
    eng = srv.ServingEngine(cfg, serving, slots=8, max_len=448,
                            prefill_chunk=32, device="cuda")
    out = eng.run(reqs)
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = {n: kk.launches for n, kk in kern.items()}
    fin = {f.id: f for f in out["finished"]}
    check(not out["rejected"], f"rejected {[r.id for r in out['rejected']]}")
    check(sorted(fin) == list(range(24)), "unfinished requests")
    check(all(len(fin[r.id].tokens) == r.max_new for r in reqs),
          "a request got another number of tokens than max_new")
    check(launches["K4"] > 0 and launches["K5"] > 0,
          f"path D launches {launches}")
    check(eng.trace_counts == {"decode": 1, "prefill": 1, "reset": 1},
          f"program signatures {eng.trace_counts}")
    s = out["stats"]
    print(f"main path D (ServingEngine, 8 slots, 24 requests, prompts "
          f"32-384, max_new 16-64): tokens={s['tokens']} "
          f"tokens_per_s={s['tokens_per_sec']:.1f} "
          f"p50_latency_s={s['p50_latency_s']:.3f} "
          f"p99_latency_s={s['p99_latency_s']:.3f} "
          f"p50_ttft_s={s['p50_ttft_s']:.3f} p99_ttft_s={s['p99_ttft_s']:.3f} "
          f"wall_s={wall:.2f} signatures={eng.trace_counts} "
          f"launches={launches} [{power}]", flush=True)
    return launches


def profile_phase(path_c: dict, power: str) -> None:
    """Device busy share and top kernels of path C's prefill and of 8 of
    its decode steps, under ``torch.profiler``; run after the timed paths
    so that the profiler's hooks touch none of their numbers."""
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

    device_profile(prefill, "path C prefill (B=2, S=512, compressed)",
                   power)
    caches = prefill()
    device_profile(lambda: decode(caches), "path C 8 decode steps (M=2, "
                   "compressed)", power)


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
    from repro_torch.kernels.kmeans import kmeans as k1
    from repro_torch.kernels.prune import prune as k2
    from repro_torch.kernels.quant_matmul import quant_matmul as k45
    t0 = time.time()
    logs = build.build(build.SOURCES)
    print(f"build_s={time.time() - t0:.2f} sources={sorted(logs)}")
    for src_name, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {src_name}: {line.strip()}")

    power = card.split(",")[-1].strip()
    rec = kernel_phase(k1, k2, power)
    n_a = main_path_a(k1, k2)
    n_b = main_path_b(k1, k2)
    n_lm1, n_lm2 = lm_phase(k1, k2)
    srec = serve_kernel_phase(k45, k6, power)
    kern = {"K1": k1.KERNEL, "K2": k2.KERNEL, "K4": k45.KERNEL_PACKED4,
            "K5": k45.KERNEL_U8, "K6": k6.KERNEL}
    path_c = main_path_c(kern, power)
    n_d = main_path_d(kern, path_c["cfg"], path_c["serving"], power)
    profile_phase(path_c, power)
    n_c = path_c["launches"]

    def entry(name, source, replaces, launches, rows, main_shape,
              library_ms=None):
        row = next(r for r in rows
                   if r["shape"][:len(main_shape)] == list(main_shape))
        return {"name": name, "route": "cuda", "source": source,
                "replaces": replaces, "launches": launches,
                "max_abs_err": max(r["max_abs_err"] for r in rows),
                "ms": row["ms"], "plain_ms": row["plain_ms"],
                "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
                "library_ms": row.get("library_ms")}

    csrc = "src/repro_torch/kernels/csrc/"
    kernels = [
        entry("kmeans_assign_moments_batched",
              csrc + "kmeans_assign_moments.cu",
              "src/repro/kernels/kmeans/kmeans.py:127",
              n_a + n_lm1 + n_c["K1"], rec["K1"]["rows"], LM_K1_SHAPE[:2]),
        entry("count_above_batched", csrc + "count_above.cu",
              "src/repro/kernels/prune/prune.py:138",
              n_b + n_lm2 + n_c["K2"], rec["K2"]["rows"], K2_SHAPES[-1]),
        entry("quant_matmul_packed", csrc + "quant_matmul.cu",
              "src/repro/kernels/quant_matmul/quant_matmul.py:105",
              n_c["K4"] + n_d["K4"], srec["K4"], K4_MAIN),
        entry("quant_matmul", csrc + "quant_matmul.cu",
              "src/repro/kernels/quant_matmul/quant_matmul.py:46",
              n_c["K5"] + n_d["K5"], srec["K5"], K5_MAIN),
        entry("flash_attention", csrc + "flash_attention.cu",
              "src/repro/kernels/flash_attention/flash_attention.py:81",
              n_c["K6"] + n_d["K6"], srec["K6"], K6_SHAPES[0]),
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
