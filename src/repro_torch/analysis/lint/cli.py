"""``python -m repro_torch.analysis.lint``: run the four-layer linter.

Port of ``src/repro/analysis/lint/cli.py``, with its exit status: 0 when
every finding is covered by the committed baseline
(``lint_baseline_torch.json`` at the repo root), 1 when any *new*
finding exists, 2 when the linter itself cannot run (a bad argument, or
``ops``/``trace`` asked for the card where there is none).

Layers (``--layers``):

========  ============================================================
ast       plain-AST rules over the source tree (no imports)
contract  scheme/registry declaration checks (imports, no compute)
ops       every registered solver, scheme family's grouped C step
          (alone and planned) and serving program run once under the
          op counter on the device, with the op rules
trace     program keys across toy LC boundaries, the planner's cache
          across a release, and a toy engine's mixed-length trace
========  ============================================================

``ops`` and ``trace`` run on the card (``--device``, default ``cuda``);
``--device cpu`` runs them on the CPU, where the kernels' plain versions
stand in. Without a card and without ``--device cpu`` they refuse: the
linter never carries on on the CPU by itself.

Typical invocations::

    python -m repro_torch.analysis.lint                       # full run, card
    python -m repro_torch.analysis.lint --device cpu          # full run, CPU
    python -m repro_torch.analysis.lint --layers ast,contract # fast subset
    python -m repro_torch.analysis.lint --json report.json    # report file
    python -m repro_torch.analysis.lint --write-baseline      # accept current
"""
from __future__ import annotations

import argparse
import json
import os
import sys

from repro_torch.analysis.lint.findings import Baseline, Report

ALL_LAYERS = ("ast", "contract", "ops", "trace")
#: the layers that run programs on a device
DEVICE_LAYERS = ("ops", "trace")
BASELINE = "lint_baseline_torch.json"


def repo_root() -> str:
    """Repo root: the parent of the ``src`` directory holding
    ``repro_torch``."""
    import repro_torch
    src = os.path.dirname(os.path.dirname(os.path.abspath(
        repro_torch.__file__)))
    return os.path.dirname(src)


def _toy_params(device, names_scales):
    import torch
    return {n: (torch.linspace(a, b, 32).reshape(2, 16)).to(device)
            for n, (a, b) in names_scales.items()}


def _trace_findings(device):
    """The default recapture probe: boundaries of a toy 2-task LC setup
    past the capture (tiny tensors)."""
    from repro_torch.analysis.lint.trace_count import check_retraces
    from repro_torch.core.algorithm import LCAlgorithm
    from repro_torch.core.schemes.prune import ConstraintL0Pruning
    from repro_torch.core.schemes.quantize import AdaptiveQuantization
    from repro_torch.core.tasks import CompressionTask
    from repro_torch.core.views import AsStacked

    params = _toy_params(device, {"qa": (-1.0, 1.0), "pb": (1.0, -1.0)})
    tasks = [
        CompressionTask("lint/quant", "qa", AsStacked("vector"),
                        AdaptiveQuantization(k=2, iters=2)),
        CompressionTask("lint/prune", "pb", AsStacked("vector"),
                        ConstraintL0Pruning(kappa=8)),
    ]
    algo = LCAlgorithm(tasks, mu_schedule=[1e-3, 1e-2], device=device)
    lc = algo.init(params)
    try:
        return check_retraces(algo, params, lc, boundaries=2)
    finally:
        algo.release_graphs()


def _planner_findings(device):
    """Planner-cache probe: a 4-task LC with two multi-task groups (2×
    quantization, 2× pruning at mixed κ), planner on, 3 boundaries and a
    forced release: every plan lookup after it must hit the cache."""
    from repro_torch.analysis.lint.trace_count import check_planner_cache
    from repro_torch.core.algorithm import LCAlgorithm
    from repro_torch.core.schemes.prune import ConstraintL0Pruning
    from repro_torch.core.schemes.quantize import AdaptiveQuantization
    from repro_torch.core.tasks import CompressionTask
    from repro_torch.core.views import AsStacked

    params = _toy_params(device, {"qa": (-1.0, 1.0), "qb": (-3.0, 3.0),
                                  "pa": (1.0, -1.0), "pb": (2.0, -2.0)})
    tasks = [
        CompressionTask("lint/quant/a", "qa", AsStacked("vector"),
                        AdaptiveQuantization(k=2, iters=2)),
        CompressionTask("lint/quant/b", "qb", AsStacked("vector"),
                        AdaptiveQuantization(k=2, iters=2)),
        CompressionTask("lint/prune/a", "pa", AsStacked("vector"),
                        ConstraintL0Pruning(kappa=8)),
        CompressionTask("lint/prune/b", "pb", AsStacked("vector"),
                        ConstraintL0Pruning(kappa=4)),
    ]
    algo = LCAlgorithm(tasks, mu_schedule=[1e-3, 1e-2], planner="on",
                       device=device)
    lc = algo.init(params)
    try:
        return check_planner_cache(algo, params, lc, boundaries=3)
    finally:
        algo.release_graphs()


def _engine_trace_findings(device):
    """Recapture probe for the serving engine: a tiny one-attention-layer
    model over a mixed-length trace; every program must be keyed once."""
    import numpy as np
    import torch

    from repro_torch.analysis.lint.op_rules import serving_config
    from repro_torch.analysis.lint.trace_count import check_engine_retraces
    from repro_torch.models.transformer import init_params
    from repro_torch.runtime.server import Request, ServingEngine

    cfg = serving_config()
    params = init_params(torch.Generator(device=device).manual_seed(0), cfg)
    engine = ServingEngine(cfg, params, slots=2, max_len=16,
                           prefill_chunk=4, device=device)
    rng = np.random.default_rng(0)
    reqs = [Request(id=i, prompt=rng.integers(1, 64, size=s)
                    .astype(np.int32), max_new=m, arrival=0.0)
            for i, (s, m) in enumerate([(3, 2), (5, 3), (9, 2)])]
    return check_engine_retraces(engine, reqs)


def run_lint(paths=None, layers=ALL_LAYERS, root=None,
             device=None) -> Report:
    """Run the requested layers and return the report before the
    baseline. ``paths`` feeds the AST layer only (default:
    ``src/repro_torch``). ``device`` is where ``ops`` and ``trace`` run:
    ``None`` means the card, and raises where CUDA is absent."""
    root = root or repo_root()
    if any(layer in DEVICE_LAYERS for layer in layers):
        from repro_torch.interop import resolve_device
        device = resolve_device(device)
    report = Report()
    if "ast" in layers:
        from repro_torch.analysis.lint.ast_rules import lint_paths
        targets = paths or [os.path.join(root, "src", "repro_torch")]
        report.extend(lint_paths(targets, root), "ast")
    if "contract" in layers:
        from repro_torch.analysis.lint.contract import check_schemes
        report.extend(check_schemes(), "contract")
    if "ops" in layers:
        from repro_torch.analysis.lint.op_rules import (
            check_planner_counts, check_scheme_counts, check_serving_counts,
            check_solvers)
        report.extend(check_solvers(device=device), "ops")
        report.extend(check_scheme_counts(device=device), "ops")
        report.extend(check_planner_counts(device=device), "ops")
        report.extend(check_serving_counts(device=device), "ops")
    if "trace" in layers:
        report.extend(_trace_findings(device), "trace")
        report.extend(_planner_findings(device), "trace")
        report.extend(_engine_trace_findings(device), "trace")
    return report


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis.lint",
        description="Four-layer static analysis for the PyTorch port's "
                    "LC engine (AST / scheme-registry contract / counted "
                    "ops / program keys).")
    ap.add_argument("paths", nargs="*",
                    help="files or directories for the AST layer "
                         "(default: src/repro_torch)")
    ap.add_argument("--layers", default=",".join(ALL_LAYERS),
                    help="comma-separated subset of: "
                         + ", ".join(ALL_LAYERS))
    ap.add_argument("--json", nargs="?", const="-", default=None,
                    metavar="FILE",
                    help="emit the JSON report to FILE (or stdout)")
    ap.add_argument("--baseline", default=None, metavar="FILE",
                    help=f"suppression baseline (default: <repo>/{BASELINE})")
    ap.add_argument("--write-baseline", action="store_true",
                    help="accept all current findings into the "
                         "baseline and exit 0")
    ap.add_argument("--device", default=None,
                    help="where the ops and trace layers run (default: "
                         "the card; 'cpu' runs them on the CPU)")
    args = ap.parse_args(argv)

    layers = tuple(x.strip() for x in args.layers.split(",") if x.strip())
    bad = [x for x in layers if x not in ALL_LAYERS]
    if bad:
        ap.error(f"unknown layer(s) {bad}; choose from {ALL_LAYERS}")

    root = repo_root()
    baseline_path = args.baseline or os.path.join(root, BASELINE)
    try:
        report = run_lint(args.paths or None, layers, root, args.device)
    except RuntimeError as e:
        if "CUDA is not available" not in str(e):
            raise
        ap.error(f"{e} (the {'/'.join(DEVICE_LAYERS)} layers run there)")

    if args.write_baseline:
        Baseline.write(baseline_path, report.findings)
        print(f"wrote {len(report.findings)} suppression(s) to "
              f"{baseline_path}")
        return 0

    report.apply_baseline(Baseline.load(baseline_path))

    if args.json is not None:
        payload = json.dumps(report.to_json(), indent=2)
        if args.json == "-":
            print(payload)
        else:
            with open(args.json, "w", encoding="utf-8") as f:
                f.write(payload + "\n")

    for f in report.findings:
        print(f.format())
    n_new, n_sup = len(report.findings), len(report.suppressed)
    tail = f" ({n_sup} baseline-suppressed)" if n_sup else ""
    if n_new:
        print(f"lint: {n_new} new finding(s){tail} "
              f"[layers: {', '.join(layers)}]")
        return 1
    print(f"lint: clean{tail} [layers: {', '.join(layers)}]")
    return 0


if __name__ == "__main__":
    sys.exit(main())
