"""Continuous-batching serving of an LC-compressed model: the paper's
deployment story end to end.

    PYTHONPATH=src python -m repro_torch.serve_compressed [--device cpu]

Port of ``examples/serve_compressed.py``: define compression tasks (one
per scheme family: 4-bit quantization of ``w_gate``, rank-8 low rank of
``w_up``, ℓ0 pruning of ``w_down``), run the LC direct-compression init,
bridge Θ into compressed serving forms, serve a Poisson request trace
with the slot-based engine, and check that the greedy tokens equal those
of the densified model. Runs on the card unless ``--device`` says
otherwise.
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.configs import get_config, reduced_config
from repro_torch.core import AsIs, AsVector, CompressionTask, LCAlgorithm
from repro_torch.core.schemes import (
    AdaptiveQuantization, ConstraintL0Pruning, LowRank)
from repro_torch.interop import resolve_device
from repro_torch.models.transformer import init_params
from repro_torch.runtime import compressed as cforms
from repro_torch.runtime.server import (
    Request, ServingEngine, densified_for_serving,
    load_compressed_for_serving)


def main(device=None) -> dict:
    device = resolve_device(device)
    # float32 + unrolled layers: exact compressed-vs-densified token
    # parity, and per-layer (non-stacked) leaves for the bridge
    cfg = reduced_config(get_config("phi3-mini-3.8b")).with_(
        pattern_reps=1, dtype="float32")
    params = init_params(torch.Generator(device=device).manual_seed(0), cfg)

    # one task per LC scheme family, all live in the same served model
    tasks = [
        CompressionTask("quant", r"ffn/w_gate", AsVector(),
                        AdaptiveQuantization(k=16)),
        CompressionTask("lowrank", r"ffn/w_up", AsIs(), LowRank(8)),
        CompressionTask("prune", r"ffn/w_down", AsVector(),
                        ConstraintL0Pruning(kappa=1000)),
    ]
    algo = LCAlgorithm(tasks, [1e-4], device=device)
    state = algo.init(params)      # Θ ← Π(w̄): direct compression

    serving, report = load_compressed_for_serving(params, state, algo.tasks)
    print("bridged forms:")
    for task_name, forms in report.items():
        for path, form in forms.items():
            print(f"  {task_name:10s} {path:40s} -> {form}")
    dense_b = cforms.tree_weight_bytes(params)
    comp_b = cforms.tree_weight_bytes(serving)
    print(f"modeled decode weight bytes: {dense_b} B -> {comp_b} B "
          f"({dense_b / comp_b:.2f}x less per step)\n")

    # synthetic heavy traffic: Poisson arrivals, mixed lengths
    rng = np.random.default_rng(0)
    t, reqs = 0.0, []
    for i in range(12):
        t += float(rng.exponential(0.02))
        reqs.append(Request(
            id=i, prompt=rng.integers(1, cfg.vocab_size,
                                      size=int(rng.integers(8, 40)))
            .astype(np.int32),
            max_new=int(rng.integers(4, 16)), arrival=t))

    engine = ServingEngine(cfg, serving, slots=4, max_len=64,
                           prefill_chunk=8, device=device)
    out = engine.run(list(reqs))
    s = out["stats"]
    print(f"served {s['requests']} requests, {s['tokens']} tokens: "
          f"{s['tokens_per_sec']:.1f} tok/s, "
          f"p50={s['p50_latency_s'] * 1e3:.0f}ms "
          f"p99={s['p99_latency_s'] * 1e3:.0f}ms")
    if any(n != 1 for n in engine.trace_counts.values()):
        raise RuntimeError(f"an engine program saw more than one input "
                           f"signature: {engine.trace_counts}")
    print("one input signature per engine program across the trace")

    # parity: the compressed engine must reproduce the densified model
    reference = densified_for_serving(params, state, algo.tasks)
    ref_out = ServingEngine(cfg, reference, slots=4, max_len=64,
                            prefill_chunk=8, device=device).run(list(reqs))
    ref = {f.id: f.tokens for f in ref_out["finished"]}
    for f in out["finished"]:
        if not np.array_equal(f.tokens, ref[f.id]):
            raise RuntimeError(f"request {f.id}: compressed tokens differ "
                               f"from the densified model's")
    print("parity OK: all compressed forms greedy-decode identical tokens "
          "to the densified model")
    return {"report": report, "out": out, "reference": ref_out}


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    main(ap.parse_args().device)
