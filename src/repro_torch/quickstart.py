"""Quickstart: compress a model with the LC algorithm (paper Listing 1).

    PYTHONPATH=src python -m repro_torch.quickstart [--device cpu]

Port of ``examples/quickstart.py``: trains the LeNet300 MLP on synthetic
classification, then compresses it to 2-bit per-layer codebooks with the
LC algorithm. Runs on the card unless ``--device`` says otherwise.
"""
from __future__ import annotations

import argparse

from repro_torch.core import AsVector, CompressionTask
from repro_torch.core.schemes import AdaptiveQuantization
from repro_torch.showcase import (
    direct_compress, reference_problem, run_lc)


def quickstart_tasks() -> list[CompressionTask]:
    """Quantize every layer with its own codebook (K=4)."""
    return [CompressionTask(f"q{i}", rf"l{i}/w$", AsVector(),
                            AdaptiveQuantization(k=4, iters=20))
            for i in range(3)]


def main(device=None, n_steps: int = 20, iters_per_l: int = 40) -> dict:
    # 1. the reference (uncompressed) model — "w ← argmin L(w)"
    prob = reference_problem(device=device)
    print(f"reference test error: {prob.ref_test_err:.4f}")

    # 2. direct compression baseline (Θ^DC = Π(w̄), no retraining)
    dc = direct_compress(prob, quickstart_tasks(), device=device)
    print(f"direct-compression test error: {dc['test_err']:.4f} "
          f"(ratio {dc['ratio']:.1f}x)")

    # 3. the LC algorithm: alternate L steps (SGD + penalty) and C steps
    out = run_lc(prob, quickstart_tasks(), n_steps=n_steps,
                 iters_per_l=iters_per_l, device=device)
    print(f"LC-compressed test error: {out['test_err']:.4f} "
          f"(ratio {out['ratio']:.1f}x, {out['wall_s']:.1f}s)")
    if out["test_err"] > dc["test_err"] + 1e-6:
        raise RuntimeError("LC must not lose to direct compression: "
                           f"LC {out['test_err']} > DC {dc['test_err']}")
    return {"ref": prob.ref_test_err, "dc": dc, "lc": out}


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    main(ap.parse_args().device)
