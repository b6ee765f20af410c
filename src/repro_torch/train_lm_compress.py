"""End-to-end driver: train a ~100M-class LM for a few LC steps while
LC-compressing it (per-layer adaptive codebooks on every layer stack),
with checkpointing and fault-tolerant stepping.

    PYTHONPATH=src python -m repro_torch.train_lm_compress \
        [--steps-per-l 20] [--lc-steps 10] [--full-100m] [--device cpu]

Port of ``examples/train_lm_compress.py``: xlstm-125m, its reduced
config by default (CPU-sized), or with ``--full-100m`` the published
config in float32 (the port trains in float32; bf16 is open). Runs on
the card unless ``--device`` says otherwise.
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

#: the reference example's task: every mLSTM q/k/v, every block's up and
#: down projection and sLSTM's input weights, one codebook a layer
PATTERN = r"stages/.*/(wq|wk|wv|up_proj|down_proj|w)$"


def model_config(full_100m: bool):
    cfg = get_config("xlstm-125m")
    return cfg.with_(dtype="float32") if full_100m else reduced_config(cfg)


def make_trainer(cfg, *, lc_steps: int, steps_per_l: int, batch: int,
                 seq: int, ckpt_dir=None, device=None) -> LCTrainer:
    """The example's LCTrainer: the task above at k = 16, μ from 9e-5 by
    1.3 a step, AdamW at lr 1e-3 on a ``TokenStream`` of ``batch`` ×
    ``seq`` tokens, a checkpoint every 20 steps into ``ckpt_dir``."""
    tasks = [CompressionTask("quantize-stacks", PATTERN, AsStacked("vector"),
                             AdaptiveQuantization(k=16, iters=10))]
    lc = LCAlgorithm(tasks, exponential_mu_schedule(9e-5, 1.3, lc_steps),
                     device=device)
    return LCTrainer(
        cfg, lc, TokenStream(cfg.vocab_size, batch, seq),
        tcfg=TrainerConfig(steps_per_l=steps_per_l, lr=1e-3,
                           ckpt_dir=ckpt_dir, ckpt_every=20),
        device=device)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--lc-steps", type=int, default=6)
    ap.add_argument("--steps-per-l", type=int, default=10)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--full-100m", action="store_true")
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "lm_compress_ckpt"))
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)

    cfg = model_config(args.full_100m)
    print(f"model: {cfg.name}, {cfg.n_layers} layers")
    trainer = make_trainer(cfg, lc_steps=args.lc_steps,
                           steps_per_l=args.steps_per_l, batch=args.batch,
                           seq=args.seq, ckpt_dir=args.ckpt_dir,
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
