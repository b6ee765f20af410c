"""Multi-pod dry run: trace every (arch × shape × mesh) cell's step on meta
tensors, per rank, and model it on the H100.

Port of ``src/repro/launch/dryrun.py``. Where the reference lowers and
compiles each cell's jitted step for 512 host devices and reads the
compiled HLO, the port runs its own step function eagerly, once, as rank
0 of the production mesh would (``launch/mesh.abstract_mesh``: (16, 16)
or (2, 16, 16), no process group), on meta tensors at that rank's shard
shapes (``launch/inputs.py``), under the op counter
(``analysis/op_stats.py``); the roofline terms (``analysis/roofline.py``)
use the H100 SXM's spec-sheet rates. Nothing is allocated and no kernel
runs, so this is the one entry point of the port that needs no card: it
models the H100 whatever host it runs on, as the reference's runs on the
CPU. Rank 0 stands for every rank (``sharding.shard_bounds`` asserts
even splits).

For each cell:

    inputs = inputs.train_state_specs / decode_specs / prefill_specs
    stats  = op_stats.analyze_step(step, *inputs)   # FLOPs, bytes,
                                                     # collectives, peak
    row    = roofline.analyze(stats, ...).row()

Variants: ``fused_attn`` models the flash kernel: prefill cells run K6
(its wrapper reports its own FLOPs, bytes and launch on meta tensors);
train cells keep the unfused attention (K6 is forward-only) and count it
with FLOPs but no bytes, adding ``roofline.fused_attention_bytes`` (the
reference's accounting); the port's decode attention reads the cache
without K6, so a decode cell is unchanged. ``quant_serve`` serves 8-bit
packs (``inputs.quantize_params_meta``) through K5, in decode and, unlike
the reference, in prefill too. The row keeps the reference's keys:
``t_lower_s`` is the time to build the meta inputs and ``t_compile_s``
the meta trace's (no compiler runs).

Results are cached incrementally to ``results/dryrun_torch/<cell>.json``
so the full matrix is restartable; a failing cell is ``status="error"``
with its traceback, and the command exits 1.

Usage:
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch mixtral-8x7b \\
        --shape train_4k [--multi-pod] [--all] [--out results/dryrun_torch]
"""
from __future__ import annotations

import argparse
import json
import os
import time
import traceback

from repro_torch.analysis import op_stats
from repro_torch.analysis import roofline as rl
from repro_torch.configs import ARCHS, SHAPES, get_config
from repro_torch.distributed.sharding import (
    DEFAULT_RULES, SERVE_RULES, use_mesh)
from repro_torch.launch import inputs as specs_mod
from repro_torch.launch.mesh import abstract_mesh
from repro_torch.launch.steps import (
    make_prefill_step, make_serve_step, make_train_step)
from repro_torch.models.attention import FLASH_SCOPE

PRODUCTION = {False: (16, 16), True: (2, 16, 16)}


def cell_applicable(cfg, shape_cfg) -> tuple[bool, str]:
    if shape_cfg.name == "long_500k" and not cfg.subquadratic:
        return False, ("skip: pure full-attention arch has no sub-quadratic "
                       "mechanism (DESIGN.md §Arch-applicability)")
    return True, ""


def trace_cell(cfg, shape_cfg, mesh=None, variant: str = ""):
    """``(stats, extra_bytes, model_flops, t_inputs_s, t_trace_s)`` of
    ``cfg``'s step on ``shape_cfg`` as one rank of ``mesh`` runs it
    (``None``: one rank) on meta tensors."""
    fused_attn = "fused_attn" in variant
    quant_serve = "quant_serve" in variant
    skip = (FLASH_SCOPE,) if fused_attn else ()
    chips = 1 if mesh is None else mesh.size()
    extra = 0.0
    t0 = time.time()
    if shape_cfg.kind == "train":
        rules = DEFAULT_RULES
        if fused_attn:
            extra = rl.fused_attention_bytes(cfg, shape_cfg, chips)
        step = make_train_step(cfg.with_(fused_attention=False))
        args = (specs_mod.train_state_specs(cfg, mesh),
                specs_mod.batch_specs(cfg, shape_cfg, mesh))
        mf = rl.model_flops_train(
            cfg, shape_cfg.global_batch * shape_cfg.seq_len)
    else:
        rules = SERVE_RULES
        run_cfg = cfg.with_(fused_attention=fused_attn)
        if shape_cfg.kind == "decode":
            step = make_serve_step(run_cfg)
            args = specs_mod.decode_specs(cfg, shape_cfg, mesh,
                                          quantized=quant_serve)
            mf = rl.model_flops_decode(
                cfg, shape_cfg.global_batch, shape_cfg.seq_len)
        else:
            step = make_prefill_step(run_cfg)
            args = specs_mod.prefill_specs(cfg, shape_cfg, mesh,
                                           quantized=quant_serve)
            mf = rl.model_flops_prefill(
                cfg, shape_cfg.global_batch * shape_cfg.seq_len)
    t_inputs = time.time() - t0
    with use_mesh(mesh, rules):
        stats = op_stats.analyze_step(step, *args, skip_scopes=skip)
    return stats, extra, mf, t_inputs, time.time() - t0 - t_inputs


def run_cell(arch: str, shape: str, multi_pod: bool,
             extra_cfg: dict | None = None,
             variant: str = "") -> dict:
    """``variant``: ""(paper-faithful baseline) | "fused_attn" |
    "quant_serve" | "fused_attn+quant_serve" — the beyond-paper
    optimizations, modeled as the module docstring says."""
    cfg = get_config(arch)
    if extra_cfg:
        cfg = cfg.with_(**extra_cfg)
    shape_cfg = SHAPES[shape]
    ok, why = cell_applicable(cfg, shape_cfg)
    mesh_name = "2x16x16" if multi_pod else "16x16"
    cell = {"arch": arch, "shape": shape, "mesh": mesh_name,
            "variant": variant}
    if not ok:
        return dict(cell, status="skipped", reason=why)
    try:
        mesh = abstract_mesh(PRODUCTION[multi_pod])
        stats, extra, mf, t_inputs, t_trace = trace_cell(
            cfg, shape_cfg, mesh, variant)
        terms = rl.analyze(stats, arch=arch, shape=shape,
                           mesh_name=mesh_name, chips=mesh.size(),
                           model_flops=mf, extra_bytes_per_chip=extra,
                           mesh=mesh)
        row = terms.row()
        row.update(status="ok", t_lower_s=t_inputs, t_compile_s=t_trace,
                   extra_bytes_per_chip=extra, n_ops=sum(stats.ops.values()),
                   kernel_bytes_per_chip=stats.kernel_bytes)
        return dict(cell, **row)
    except Exception as e:  # a failing cell is a bug in our sharding
        return dict(cell, status="error", error=f"{type(e).__name__}: {e}",
                    traceback=traceback.format_exc()[-4000:])


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None, choices=ARCHS + [None])
    ap.add_argument("--shape", default=None, choices=list(SHAPES) + [None])
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--all", action="store_true",
                    help="run the full arch × shape matrix")
    ap.add_argument("--out", default="results/dryrun_torch")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--variant", default="",
                    help="fused_attn | quant_serve | "
                         "fused_attn+quant_serve")
    args = ap.parse_args()

    os.makedirs(args.out, exist_ok=True)
    archs = ARCHS if (args.all or not args.arch) else [args.arch]
    shapes = list(SHAPES) if (args.all or not args.shape) else [args.shape]
    meshes = [False, True] if (args.both_meshes or args.all) \
        else [args.multi_pod]

    n_fail = 0
    for arch in archs:
        for shape in shapes:
            for mp in meshes:
                mesh_name = "2x16x16" if mp else "16x16"
                suffix = f"__{args.variant}" if args.variant else ""
                path = os.path.join(
                    args.out,
                    f"{arch}__{shape}__{mesh_name}{suffix}.json")
                if os.path.exists(path) and not args.force:
                    with open(path) as f:
                        prev = json.load(f)
                    if prev.get("status") in ("ok", "skipped"):
                        print(f"[cached] {arch} {shape} {mesh_name}: "
                              f"{prev['status']}")
                        continue
                t0 = time.time()
                res = run_cell(arch, shape, mp, variant=args.variant)
                res["wall_s"] = time.time() - t0
                with open(path, "w") as f:
                    json.dump(res, f, indent=2, default=str)
                status = res["status"]
                extra = ""
                if status == "ok":
                    extra = (f"bottleneck={res['bottleneck']} "
                             f"t=({res['t_compute_s']:.3e},"
                             f"{res['t_memory_s']:.3e},"
                             f"{res['t_collective_s']:.3e})s")
                elif status == "error":
                    extra = res["error"][:200]
                    n_fail += 1
                print(f"[{status}] {arch} {shape} {mesh_name} "
                      f"({res['wall_s']:.0f}s) {extra}", flush=True)
    raise SystemExit(1 if n_fail else 0)


if __name__ == "__main__":
    main()
