"""CLI serving driver: batched or continuous-batching generation on
dense or LC-compressed weights.

Port of ``src/repro/launch/serve.py`` (no mesh). Runs on the card unless
``--device`` says otherwise:

    PYTHONPATH=src python -m repro_torch.launch.serve --arch phi3-mini-3.8b \
        --reduced --engine --form quant4 --slots 4 --requests 12 --device cpu

Every token model runs: e.g. ``--arch mixtral-8x7b``,
``deepseek-moe-16b`` (MoE), ``minicpm3-4b`` (MLA), ``jamba-v0.1-52b``
(Mamba) or ``xlstm-125m`` (mLSTM and sLSTM). A compressed ``--form``
bridges every 2-D matrix that the model applies as a product (MoE
expert stacks are 3-D and stay dense; see ``compress_for_form``).
"""
from __future__ import annotations

import argparse
import re
import time

import numpy as np
import torch

from repro_torch.configs import ARCHS, get_config, reduced_config
from repro_torch.core.tasks import get_path
from repro_torch.interop import resolve_device
from repro_torch.launch.steps import lc_param_paths
from repro_torch.models.transformer import init_params
from repro_torch.runtime import compressed as cforms
from repro_torch.runtime.server import (
    Request, Server, ServingEngine, load_compressed_for_serving)

FORMS = ("dense", "quant4", "quant8", "lowrank", "sparse")


#: 2-D leaves that the mixers read as they are, in no product (Mamba's
#: and mLSTM's depthwise conv taps, Mamba's state matrix): a weight form
#: there could not be applied
NOT_PRODUCTS = ("conv_w", "A_log")


def compress_for_form(cfg, params, form: str, device):
    """Bridge the model's matrices into one serving form through a real
    LC state (direct compression init).

    Every 2-D leaf is selected, as in the reference, but those named in
    ``NOT_PRODUCTS``: the reference selects them too, and then its own
    Mamba and mLSTM raise on the weight form they get (ROADMAP §3)."""
    from repro_torch.core import AsIs, AsVector, CompressionTask, LCAlgorithm
    from repro_torch.core.schemes import (
        AdaptiveQuantization, ConstraintL0Pruning, LowRank)

    paths = [p for p in lc_param_paths(params)
             if get_path(params, p).ndim == 2
             and p.rsplit("/", 1)[-1] not in NOT_PRODUCTS]
    if not paths:
        raise ValueError("no 2-D compressible matrices (use --reduced?)")
    pattern = "|".join(f"^{re.escape(p)}$" for p in paths)
    if form == "quant4":
        task = CompressionTask("q", pattern, AsVector(),
                               AdaptiveQuantization(k=16))
    elif form == "quant8":
        task = CompressionTask("q", pattern, AsVector(),
                               AdaptiveQuantization(k=64))
    elif form == "lowrank":
        task = CompressionTask("lr", pattern, AsIs(),
                               LowRank(max(cfg.d_model // 8, 2)))
    else:  # sparse
        total = sum(get_path(params, p).numel() for p in paths)
        task = CompressionTask("pr", pattern, AsVector(),
                               ConstraintL0Pruning(kappa=total // 10))
    algo = LCAlgorithm([task], [1e-4], device=device)
    state = algo.init(params)
    serving, report = load_compressed_for_serving(params, state, algo.tasks)
    n = sum(len(f) for f in report.values())
    kinds = sorted({v.split("(")[0] for f in report.values()
                    for v in f.values()})
    print(f"bridged {n} matrices to {form}: forms={kinds}")
    return serving


def run_engine(cfg, params, args, device):
    engine = ServingEngine(cfg, params, slots=args.slots,
                           max_len=args.prompt_len + args.gen,
                           prefill_chunk=8, device=device)
    rng = np.random.default_rng(0)
    t, reqs = 0.0, []
    for i in range(args.requests):
        t += float(rng.exponential(0.02))
        reqs.append(Request(
            id=i,
            prompt=rng.integers(1, cfg.vocab_size,
                                size=int(rng.integers(
                                    4, args.prompt_len + 1)))
            .astype(np.int32),
            max_new=int(rng.integers(2, args.gen + 1)), arrival=t))
    out = engine.run(reqs)
    s = out["stats"]
    print(f"served {s['requests']} requests, {s['tokens']} tokens: "
          f"{s['tokens_per_sec']:.1f} tok/s, "
          f"p50={s['p50_latency_s'] * 1e3:.0f}ms "
          f"p99={s['p99_latency_s'] * 1e3:.0f}ms, "
          f"signatures={engine.trace_counts} on {device}")
    print(f"modeled decode weight bytes/step: "
          f"{cforms.tree_weight_bytes(params)} B")
    return out


def run_batch(cfg, params, args, device):
    server = Server(cfg, params, max_len=args.prompt_len + args.gen,
                    device=device)
    prompts = np.random.default_rng(0).integers(
        0, cfg.vocab_size, (args.batch, args.prompt_len)).astype(np.int32)
    t0 = time.perf_counter()
    res = server.generate(prompts, args.gen)
    dt = time.perf_counter() - t0
    print(f"generated {res.tokens.shape} in {dt:.2f}s "
          f"({args.batch * args.gen / dt:.1f} tok/s) on {device}")
    print("sample:", res.tokens[0][:16])
    return res


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="phi3-mini-3.8b", choices=ARCHS)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--form", default="dense", choices=FORMS,
                    help="serve weights in this compressed form "
                         "(bridged from an LC direct-compression state)")
    ap.add_argument("--engine", action="store_true",
                    help="continuous batching over a synthetic Poisson "
                         "trace instead of one equal-length batch")
    ap.add_argument("--slots", type=int, default=4,
                    help="engine decode slots")
    ap.add_argument("--requests", type=int, default=12,
                    help="engine trace length")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduced_config(cfg)
    if cfg.input_mode != "tokens":
        raise ValueError("the serve CLI expects a token model")
    if args.form != "dense":
        # compressed forms need per-layer (non-stacked) 2-D leaves
        cfg = cfg.with_(pattern_reps=1)

    params = init_params(torch.Generator(device=device).manual_seed(0), cfg)
    if args.form != "dense":
        params = compress_for_form(cfg, params, args.form, device)

    if args.engine:
        return run_engine(cfg, params, args, device)
    return run_batch(cfg, params, args, device)


if __name__ == "__main__":
    main()
