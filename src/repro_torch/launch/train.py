"""CLI training driver.

Port of ``src/repro/launch/train.py`` (no mesh). Runs on the card unless
``--device`` says otherwise:

    PYTHONPATH=src python -m repro_torch.launch.train --arch phi3-mini-3.8b \
        --reduced --lc-steps 2 --steps-per-l 3 --device cpu

LC-compressed training end to end: data stream → L steps (train step
with the LC penalty, AdamW) → C steps → multipliers, with checkpointing
and fault tolerance. ``--reduced`` uses the smoke config (CPU-sized).
Every architecture runs, the default xlstm-125m included.
"""
from __future__ import annotations

import argparse
import logging

from repro_torch.configs import ARCHS, get_config, reduced_config
from repro_torch.core import (
    AsStacked, AsVector, CompressionTask, LCAlgorithm,
    exponential_mu_schedule)
from repro_torch.core.schemes import AdaptiveQuantization, ConstraintL0Pruning
from repro_torch.data import TokenStream, embedding_stream
from repro_torch.models.ssm import mlstm_dims
from repro_torch.runtime import FaultInjector, LCTrainer, TrainerConfig


def pruned_weights(cfg) -> int:
    """How many weights the ``prune`` task selects: every layer's wq, wk,
    wv and wo (MLA: wo; mLSTM: wq, wk, wv; Mamba and sLSTM: none), and
    its dense FFN matrices or MoE expert stacks (not the shared
    experts)."""
    d = cfg.d_model
    total = 0
    for spec in cfg.all_layer_specs():
        if spec.mixer == "attn":
            total += 2 * d * cfg.q_dim + 2 * d * cfg.kv_dim
        elif spec.mixer == "mla":
            total += cfg.n_heads * cfg.mla.v_head_dim * d
        elif spec.mixer == "mlstm":
            total += 3 * mlstm_dims(cfg)[0] ** 2
        if spec.ffn == "dense":
            total += 3 * d * cfg.d_ff
        elif spec.ffn == "moe":
            total += cfg.moe.n_experts * 3 * d * cfg.moe.d_expert
    return total


def default_tasks(cfg, compression: str = "quantize", keep: float = 0.05):
    """The flagship per-arch compression tasks: per-layer adaptive
    codebooks on the layer stacks (AsStacked ⇒ one item per layer), or
    ℓ0 pruning of all the layers' matrices as one vector to κ = ``keep``
    of them (the reference leaves κ to the caller and builds the scheme
    with κ = 0, which its constructor refuses)."""
    if compression == "quantize":
        return [CompressionTask(
            "quantize-stacks", r"stages/.*/(w_gate|w_up|w_down|wq|wk|wv|wo|in_proj|out_proj|up_proj|down_proj|w)$",
            AsStacked("vector"), AdaptiveQuantization(k=16, iters=10))]
    if compression == "prune":
        kappa = max(1, int(keep * pruned_weights(cfg)))
        return [CompressionTask(
            "prune-all", r"stages/.*/(w_gate|w_up|w_down|wq|wk|wv|wo)$",
            AsVector(), ConstraintL0Pruning(kappa=kappa))]
    raise ValueError(compression)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="xlstm-125m", choices=ARCHS)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--lc-steps", type=int, default=3)
    ap.add_argument("--steps-per-l", type=int, default=5)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--mu0", type=float, default=9e-5)
    ap.add_argument("--mu-a", type=float, default=1.2)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)

    logging.basicConfig(level=logging.INFO)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduced_config(cfg)

    if cfg.input_mode == "tokens":
        data = TokenStream(cfg.vocab_size, args.batch, args.seq)
    else:
        fn = embedding_stream(args.batch, args.seq, cfg.d_input,
                              cfg.vocab_size)

        class _D:  # noqa: N801
            batch_at = staticmethod(fn)
        data = _D()

    lc = LCAlgorithm(
        default_tasks(cfg),
        exponential_mu_schedule(args.mu0, args.mu_a, args.lc_steps),
        device=args.device)
    trainer = LCTrainer(
        cfg, lc, data,
        tcfg=TrainerConfig(steps_per_l=args.steps_per_l, lr=args.lr,
                           ckpt_dir=args.ckpt_dir),
        fault_injector=FaultInjector(), device=args.device)
    state, lc_state = trainer.run(0)
    for rec in trainer.history:
        print(rec)
    print("final compression ratio:",
          trainer.history[-1]["compression_ratio"])
    return trainer


if __name__ == "__main__":
    main()
