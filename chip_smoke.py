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
7. one JSON line listing every ported kernel, then the result line.

Tolerances: assignments and integer counts must be equal; K1's cluster
sums may differ from the plain version's by the summation order
(``rtol 1e-5, atol 1e-2``); the §7 monitor allows the reference's float
slack (``after ≤ before·(1 + 1e-5) + 1e-6``).

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


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def bound(n_bytes: float, n_ops: float) -> tuple[float, str]:
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def timed_pair(fn_a, fn_b, reps: int) -> tuple[float, float]:
    """Median ms of two callables on the current stream, taken in turns
    (a, b, b, a, …) after one warm-up each."""
    times: dict[int, list[float]] = {0: [], 1: []}
    fns = (fn_a, fn_b)
    fn_a(), fn_b()
    torch.cuda.synchronize()
    for r in range(reps):
        for which in ((0, 1) if r % 2 == 0 else (1, 0)):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fns[which]()
            end.record()
            end.synchronize()
            times[which].append(start.elapsed_time(end))
    return statistics.median(times[0]), statistics.median(times[1])


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
        ms, plain_ms = timed_pair(
            lambda: k1.kmeans_assign_moments_batched(w, cb),
            lambda: k1.kmeans_assign_moments_batched_plain(w, cb), reps)
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
        ms, plain_ms = timed_pair(
            lambda: k2.count_above_batched(w, t, False),
            lambda: k2.count_above_batched_plain(w, t, False),
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
    from repro_torch.kernels.kmeans import kmeans as k1
    from repro_torch.kernels.prune import prune as k2
    t0 = time.time()
    logs = build.build(build.SOURCES)
    print(f"build_s={time.time() - t0:.2f} sources={sorted(logs)}")
    for src_name, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {src_name}: {line.strip()}")

    rec = kernel_phase(k1, k2, card.split(",")[-1].strip())
    n_a = main_path_a(k1, k2)
    n_b = main_path_b(k1, k2)
    n_lm1, n_lm2 = lm_phase(k1, k2)

    def entry(name, source, replaces, launches, rows, lm_shape):
        row = next(r for r in rows if r["shape"][:2] == list(lm_shape))
        return {"name": name, "route": "cuda", "source": source,
                "replaces": replaces, "launches": launches,
                "max_abs_err": max(r["max_abs_err"] for r in rows),
                "ms": row["ms"], "plain_ms": row["plain_ms"],
                "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
                "library_ms": None}

    kernels = [
        entry("kmeans_assign_moments_batched",
              "src/repro_torch/kernels/csrc/kmeans_assign_moments.cu",
              "src/repro/kernels/kmeans/kmeans.py:127", n_a + n_lm1,
              rec["K1"]["rows"], LM_K1_SHAPE[:2]),
        entry("count_above_batched",
              "src/repro_torch/kernels/csrc/count_above.cu",
              "src/repro/kernels/prune/prune.py:138", n_b + n_lm2,
              rec["K2"]["rows"], K2_SHAPES[-1]),
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
