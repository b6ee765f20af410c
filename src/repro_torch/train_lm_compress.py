"""End-to-end driver: train an LM for a few LC steps while LC-compressing
it (per-layer adaptive codebooks on every layer stack), with
checkpointing and fault-tolerant stepping.

    PYTHONPATH=src python -m repro_torch.train_lm_compress \
        [--steps-per-l 10] [--lc-steps 6] [--full --layers 4] [--device cpu]

Port of ``examples/train_lm_compress.py``, whose xLSTM model is not
ported yet (ROADMAP queue 1 item 4): the twin trains phi3-mini-3.8b,
its reduced config by default (CPU-sized), or with ``--full`` the
published widths at ``--layers`` of its 32 layers. Runs on the card
unless ``--device`` says otherwise.
"""
from __future__ import annotations

import argparse
import os
import tempfile

from repro_torch.configs import get_config, reduced_config
from repro_torch.core import (AsStacked, CompressionTask, LCAlgorithm,
                              exponential_mu_schedule)
from repro_torch.core.schemes import AdaptiveQuantization
from repro_torch.data import TokenStream
from repro_torch.runtime import LCTrainer, TrainerConfig


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--lc-steps", type=int, default=6)
    ap.add_argument("--steps-per-l", type=int, default=10)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--full", action="store_true")
    ap.add_argument("--layers", type=int, default=4)
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "lm_compress_ckpt"))
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)

    cfg = get_config("phi3-mini-3.8b")
    if args.full:
        cfg = cfg.with_(pattern_reps=args.layers, dtype="float32")
    else:
        cfg = reduced_config(cfg)
    print(f"model: {cfg.name}, {cfg.n_layers} layers")

    data = TokenStream(cfg.vocab_size, args.batch, args.seq)
    tasks = [CompressionTask(
        "quantize-stacks", r"stages/.*/(wq|wk|wv|w_gate|w_up|w_down)$",
        AsStacked("vector"), AdaptiveQuantization(k=16, iters=10))]
    lc = LCAlgorithm(tasks, exponential_mu_schedule(9e-5, 1.3,
                                                    args.lc_steps),
                     device=args.device)

    trainer = LCTrainer(
        cfg, lc, data,
        tcfg=TrainerConfig(steps_per_l=args.steps_per_l, lr=1e-3,
                           ckpt_dir=args.ckpt_dir, ckpt_every=20),
        device=args.device)
    trainer.run(0)

    print("\nLC trajectory (loss should fall, distortion shrink):")
    for rec in trainer.history:
        total_dist = sum(rec["distortion"].values())
        print(f"  lc_step={rec['lc_step']:2d} mu={rec['mu']:.2e} "
              f"loss={rec['loss']:.4f} ce={rec['ce']:.4f} "
              f"distortion={total_dist:.3f} "
              f"ratio={rec['compression_ratio']:.1f}x")
    print(f"\ncheckpoints in {args.ckpt_dir}: "
          f"{trainer.ckpt.steps() if trainer.ckpt else []}")
    return trainer


if __name__ == "__main__":
    main()
