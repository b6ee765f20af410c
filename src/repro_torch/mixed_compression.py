"""Mix-and-match compression (paper Table 2, last row and row 5).

    PYTHONPATH=src python -m repro_torch.mixed_compression [--device cpu]

Port of ``examples/mixed_compression.py``: on the LeNet300 showcase,
prune the first layer, low-rank the second and quantize the third; then
a single shared codebook with additive pruning over all layers — the
paper's flexibility showcase. Prints the direct-compression and LC test
errors of both. Runs on the card unless ``--device`` says otherwise.
"""
from __future__ import annotations

import argparse

from repro_torch.core import AsIs, AsVector, CompressionTask
from repro_torch.core.schemes import (
    AdaptiveQuantization, AdditiveCombination, ConstraintL0Pruning, LowRank)
from repro_torch.showcase import (
    direct_compress, reference_problem, run_lc)


def mixed_tasks() -> list[CompressionTask]:
    """Paper Table 2 last row: prune l0, low-rank l1, quantize l2."""
    return [
        CompressionTask("p1", r"l0/w$", AsVector(),
                        ConstraintL0Pruning(kappa=5000)),
        CompressionTask("lr2", r"l1/w$", AsIs(), LowRank(target_rank=10)),
        CompressionTask("q3", r"l2/w$", AsVector(),
                        AdaptiveQuantization(k=2)),
    ]


def additive_tasks() -> list[CompressionTask]:
    """Paper Table 2 row 5: one codebook plus additive pruning of 1% of
    the weights, all layers."""
    return [CompressionTask(
        "pq", r"l\d/w$", AsVector(),
        AdditiveCombination([ConstraintL0Pruning(kappa=2662),
                             AdaptiveQuantization(k=2)], iters=2))]


RUNS = (("[prune | low-rank | quantize]", mixed_tasks),
        ("[1%-prune + quantize, additive]", additive_tasks))


def main(device=None, n_steps: int = 20, iters_per_l: int = 40,
         callbacks=()) -> dict:
    """Both runs; returns ``{"ref": error, "runs": [{"name", "dc",
    "lc"}, ...]}``. ``callbacks`` go to every LC run (``run_lc``)."""
    prob = reference_problem(device=device)
    print(f"reference test error: {prob.ref_test_err:.4f}")
    runs = []
    for name, tasks in RUNS:
        dc = direct_compress(prob, tasks(), device=device)
        lc = run_lc(prob, tasks(), n_steps=n_steps, iters_per_l=iters_per_l,
                    callbacks=callbacks, device=device)
        print(f"{name} test error: DC {dc['test_err']:.4f}, "
              f"LC {lc['test_err']:.4f}, ratio {lc['ratio']:.1f}x")
        runs.append({"name": name, "dc": dc, "lc": lc})
    return {"ref": prob.ref_test_err, "problem": prob, "runs": runs}


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    main(ap.parse_args().device)
