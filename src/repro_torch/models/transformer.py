"""Decoder stack: pattern-repeated blocks + embeddings + head.

Port of ``src/repro/models/transformer.py``: every mixer (``attn``,
``mla``, and the recurrent ``mamba``, ``mlstm`` and ``slstm`` of
``models/ssm.py``) and every FFN (``dense``, ``moe``, ``none``). A model =
embedding → [stages] → final norm → unembed. A stage is either ``reps``
repetitions of a layer pattern (one set of block params per pattern
position, stacked over reps; the
reference's ``lax.scan`` becomes a Python loop over the stacked reps)
or an unrolled run of layers. Blocks are pre-norm residual: mixer then
FFN. With ``cfg.remat``, a forward that records gradients checkpoints
each repetition (or unrolled block) with
``torch.utils.checkpoint.checkpoint(..., use_reentrant=False)``, as the
reference wraps its scan body and blocks in ``jax.checkpoint``; the
training loss (``loss_fn``) takes the cross-entropy in sequence chunks
that are checkpointed too, so (B, S, vocab) logits are never held, and
over a vocabulary split on the "model" axis no rank holds a chunk's
whole vocabulary either (``layers.vocab_parallel_nll``). Every rank
recomputes its checkpoints in the same order, so the collectives in
them meet, and the recomputation sees the forward's mesh and batch
split (``sharding.recompute_context``: autograd recomputes CUDA
tensors' checkpoints on a thread of its own).
"""
from __future__ import annotations

import functools

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.distributed.sharding import (
    active_mesh, constrain, recompute_context)
from repro_torch.interop import resolve_device
from repro_torch.models import attention as attn
from repro_torch.models import moe as moe_mod
from repro_torch.models import ssm
from repro_torch.models.layers import (
    MetaGenerator, cdtype, dense_ffn, embed, init_dense_ffn, init_embed,
    local_logits, rms_norm, unembed, vocab_parallel_nll)


# mixer registry: init, forward, decode, cache-init
MIXERS = {
    "attn": (attn.init_attn, attn.attn_forward, attn.attn_decode,
             attn.init_attn_cache),
    "mla": (attn.init_mla, attn.mla_forward, attn.mla_decode,
            attn.init_mla_cache),
    "mamba": (ssm.init_mamba, ssm.mamba_forward, ssm.mamba_decode,
              ssm.init_mamba_cache),
    "mlstm": (ssm.init_mlstm, ssm.mlstm_forward, ssm.mlstm_decode,
              ssm.init_mlstm_cache),
    "slstm": (ssm.init_slstm, ssm.slstm_forward, ssm.slstm_decode,
              ssm.init_slstm_cache),
}


#: each mixer's logical axes (the reference's second MIXERS column)
MIXER_AXES = {"attn": attn.attn_axes, "mla": attn.mla_axes,
              "mamba": ssm.mamba_axes, "mlstm": ssm.mlstm_axes,
              "slstm": ssm.slstm_axes}


# ----------------------------------------------------------------------
# Stage planning
# ----------------------------------------------------------------------
def plan_stages(cfg) -> list[dict]:
    stages = []
    if cfg.lead:
        stages.append({"kind": "unroll", "specs": list(cfg.lead), "reps": 1})
    if cfg.pattern_reps > 1:
        stages.append({"kind": "scan", "specs": list(cfg.pattern),
                       "reps": cfg.pattern_reps})
    elif cfg.pattern_reps == 1:
        stages.append({"kind": "unroll", "specs": list(cfg.pattern),
                       "reps": 1})
    if cfg.tail:
        stages.append({"kind": "unroll", "specs": list(cfg.tail), "reps": 1})
    return stages


# ----------------------------------------------------------------------
# Init
# ----------------------------------------------------------------------
def init_block(gen: torch.Generator, spec, cfg) -> dict:
    p = {
        "mixer_norm": torch.zeros((cfg.d_model,), device=gen.device),
        "mixer": MIXERS[spec.mixer][0](gen, cfg),
    }
    if spec.ffn == "dense":
        p["ffn_norm"] = torch.zeros((cfg.d_model,), device=gen.device)
        p["ffn"] = init_dense_ffn(gen, cfg.d_model, cfg.d_ff)
    elif spec.ffn == "moe":
        p["ffn_norm"] = torch.zeros((cfg.d_model,), device=gen.device)
        p["ffn"] = moe_mod.init_moe(gen, cfg)
    return p


def block_axes(spec, cfg) -> dict:
    ax = {
        "mixer_norm": ("embed",),
        "mixer": MIXER_AXES[spec.mixer](cfg),
    }
    if spec.ffn == "dense":
        ax["ffn_norm"] = ("embed",)
        ax["ffn"] = {"w_gate": ("embed", "mlp"), "w_up": ("embed", "mlp"),
                     "w_down": ("mlp", "embed")}
    elif spec.ffn == "moe":
        ax["ffn_norm"] = ("embed",)
        ax["ffn"] = moe_mod.moe_axes(cfg)
    return ax


def param_axes(cfg) -> dict:
    """The logical axes of every parameter leaf (the tree of
    :func:`init_params`): each mixer's, FFN's and embedding's table, a
    stacked stage's leaves led by "layers"."""
    if cfg.input_mode == "tokens":
        emb = {"tokens": ("vocab", "embed")}
    else:
        emb = {"proj": ("embed", None)}
    if not cfg.tie_embeddings or cfg.input_mode != "tokens":
        emb["unembed"] = ("embed", "vocab")
    axes = {"embed": emb, "final_norm": ("embed",)}
    st_axes = {}
    for si, st in enumerate(plan_stages(cfg)):
        sp = {}
        for pi, spec in enumerate(st["specs"]):
            bx = block_axes(spec, cfg)
            if st["kind"] == "scan":
                bx = _prefix_layers(bx)
            sp[f"pos{pi}"] = bx
        st_axes[f"s{si}"] = sp
    axes["stages"] = st_axes
    return axes


def _prefix_layers(ax):
    if isinstance(ax, dict):
        return {k: _prefix_layers(v) for k, v in ax.items()}
    return ("layers", *ax)


def mixer_kinds(cfg) -> dict:
    """``{(stage, position): mixer}`` of the param tree's blocks, e.g.
    ``{("s0", "pos0"): "attn"}``."""
    return {(f"s{si}", f"pos{pi}"): spec.mixer
            for si, st in enumerate(plan_stages(cfg))
            for pi, spec in enumerate(st["specs"])}


def _stack(trees: list):
    if isinstance(trees[0], dict):
        return {k: _stack([t[k] for t in trees]) for k in trees[0]}
    return torch.stack(trees)


def init_params(gen: torch.Generator, cfg) -> dict:
    """Random params on the generator's device (float32 masters)."""
    params = {"embed": init_embed(gen, cfg),
              "final_norm": torch.zeros((cfg.d_model,), device=gen.device)}
    st_params = {}
    for si, st in enumerate(plan_stages(cfg)):
        sp = {}
        for pi, spec in enumerate(st["specs"]):
            if st["kind"] == "scan":
                sp[f"pos{pi}"] = _stack([init_block(gen, spec, cfg)
                                         for _ in range(st["reps"])])
            else:
                sp[f"pos{pi}"] = init_block(gen, spec, cfg)
        st_params[f"s{si}"] = sp
    params["stages"] = st_params
    return params


@functools.lru_cache(maxsize=None)
def param_shapes(cfg) -> dict:
    """The shape of every parameter leaf (the tree of
    :func:`init_params`) at ``cfg``'s widths, from an init on the meta
    device (no memory). The tree is shared: do not change it."""
    return _shapes_of(init_params(MetaGenerator(), cfg))


def _shapes_of(tree):
    if isinstance(tree, dict):
        return {k: _shapes_of(v) for k, v in tree.items()}
    return tuple(tree.shape)


def _rep(tree, i: int):
    """One repetition's params out of a stage's stacked params."""
    if isinstance(tree, dict):
        return {k: _rep(v, i) for k, v in tree.items()}
    return tree[i]


# ----------------------------------------------------------------------
# Forward (prefill)
# ----------------------------------------------------------------------
def _apply_ffn(spec, bp, x, cfg):
    """The block's FFN on the residual x → (x, the MoE router loss as a
    0-d f32 tensor, or None for the other FFNs)."""
    aux = None
    if spec.ffn == "dense":
        h = rms_norm(x, bp["ffn_norm"], cfg.norm_eps)
        x = x + dense_ffn(bp["ffn"], h, cfg)
    elif spec.ffn == "moe":
        h = rms_norm(x, bp["ffn_norm"], cfg.norm_eps)
        y, aux = moe_mod.moe_ffn(bp["ffn"], h, cfg, active_mesh())
        x = x + y
    return x, aux


def _apply_block_full(spec, bp, x, cfg, positions, want_cache=False):
    h = rms_norm(x, bp["mixer_norm"], cfg.norm_eps)
    cache = None
    if want_cache:
        h, cache = MIXERS[spec.mixer][1](bp["mixer"], h, cfg, spec,
                                         positions, return_cache=True)
    else:
        h = MIXERS[spec.mixer][1](bp["mixer"], h, cfg, spec, positions)
    x = constrain(x + h, ("batch", "seq", None))
    x, aux = _apply_ffn(spec, bp, x, cfg)
    return constrain(x, ("batch", "seq", None)), aux, cache


def _apply_blocks(specs, first, rp, x, cfg, positions):
    """Blocks ``first``, ``first + 1``, … of one repetition's params
    ``rp``, one per spec: the unit that remat recomputes. Returns (x, the
    blocks' summed router loss, None without MoE blocks)."""
    aux = None
    for pi, spec in enumerate(specs, start=first):
        x, a, _ = _apply_block_full(spec, rp[f"pos{pi}"], x, cfg, positions)
        if a is not None:
            aux = a if aux is None else aux + a
    return x, aux


def forward_hidden(params, inputs, cfg, return_caches: bool = False):
    """inputs: (B, S) int tokens or (B, S, d_input) embeddings.

    Returns (hidden (B, S, d_model), aux_loss 0-d f32 tensor) — and,
    with ``return_caches=True`` (prefill), a decode-ready cache tree whose
    layout matches ``init_cache`` (seq-sized; the server pads to
    max_len). The aux loss is the MoE router loss summed over every MoE
    block of every stage and repetition, as the reference's
    ``aux_total``; 0 for a model without MoE blocks."""
    x = constrain(embed(params["embed"], inputs, cfg), ("batch", "seq", None))
    s = x.shape[1]
    positions = torch.arange(s, dtype=torch.int64, device=x.device)
    # remat (training only): the reference checkpoints its scan body and
    # each unrolled block; here one checkpoint per repetition of a
    # stage's pattern, or per block of an unrolled stage
    remat = cfg.remat and torch.is_grad_enabled() and not return_caches
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    caches = {}
    for si, st in enumerate(plan_stages(cfg)):
        sp = params["stages"][f"s{si}"]
        stage_cache = {}
        reps = st["reps"] if st["kind"] == "scan" else 1
        per_rep = []
        for r in range(reps):
            rp = _rep(sp, r) if st["kind"] == "scan" else sp
            cc = {}
            if remat:
                groups = ([st["specs"]] if st["kind"] == "scan"
                          else [[sp_] for sp_ in st["specs"]])
                first = 0
                for specs in groups:
                    x, a = checkpoint(_apply_blocks, specs, first, rp, x,
                                      cfg, positions, use_reentrant=False,
                                      context_fn=recompute_context)
                    if a is not None:
                        aux_total = aux_total + a
                    first += len(specs)
                continue
            for pi, spec in enumerate(st["specs"]):
                x, a, cc[f"pos{pi}"] = _apply_block_full(
                    spec, rp[f"pos{pi}"], x, cfg, positions,
                    want_cache=return_caches)
                if a is not None:
                    aux_total = aux_total + a
            per_rep.append(cc)
        if return_caches:
            stage_cache = (_stack(per_rep) if st["kind"] == "scan"
                           else per_rep[0])
            caches[f"s{si}"] = stage_cache
    hidden = rms_norm(x, params["final_norm"], cfg.norm_eps)
    if return_caches:
        return hidden, aux_total, caches
    return hidden, aux_total


# ----------------------------------------------------------------------
# Decode
# ----------------------------------------------------------------------
def init_cache(cfg, batch: int, max_len: int, dtype=None,
               device=None) -> dict:
    """Empty caches for ``batch`` sequences of up to ``max_len`` tokens
    on ``device`` (``None`` means the card): each mixer's initial state,
    in every repetition of a stacked stage."""
    dtype = dtype or cdtype(cfg)
    device = resolve_device(device)
    cache = {}
    for si, st in enumerate(plan_stages(cfg)):
        sc = {}
        for pi, spec in enumerate(st["specs"]):
            c1 = MIXERS[spec.mixer][3](cfg, spec, batch, max_len, dtype,
                                       device)
            if st["kind"] == "scan":
                # every repetition starts from the mixer's own initial
                # state (mLSTM/sLSTM's m at −30): the reference stacks
                # zeros here (ROADMAP §3)
                c1 = {k: a.expand((st["reps"],) + tuple(a.shape)).clone()
                      for k, a in c1.items()}
            sc[f"pos{pi}"] = c1
        cache[f"s{si}"] = sc
    return cache


def cache_axes(cfg) -> dict:
    """Logical axes for cache leaves: where the batch (slot) axis is."""
    names = {
        "attn": {"k": ("batch", "kv_seq", "kv_heads", None),
                 "v": ("batch", "kv_seq", "kv_heads", None)},
        "mla": {"ckv": ("batch", "kv_seq", None),
                "k_rope": ("batch", "kv_seq", None)},
        "mamba": {"conv": ("batch", None, "inner"),
                  "ssm": ("batch", "inner", "state")},
        "mlstm": {"conv": ("batch", None, "inner"),
                  "C": ("batch", "heads", None, None),
                  "n": ("batch", "heads", None),
                  "m": ("batch", "heads")},
        "slstm": {"c": ("batch", "inner"), "n": ("batch", "inner"),
                  "h": ("batch", "inner"), "m": ("batch", "inner")},
    }
    axes = {}
    for si, st in enumerate(plan_stages(cfg)):
        sc = {}
        for pi, spec in enumerate(st["specs"]):
            ax = names[spec.mixer]
            if st["kind"] == "scan":
                ax = {k: ("layers", *t) for k, t in ax.items()}
            sc[f"pos{pi}"] = ax
        axes[f"s{si}"] = sc
    return axes


def _apply_block_decode(spec, bp, x, cache, pos, cfg, layer_idx=None,
                        active=None):
    h = rms_norm(x, bp["mixer_norm"], cfg.norm_eps)
    h, new_cache = MIXERS[spec.mixer][2](bp["mixer"], h, cache, pos, cfg,
                                         spec, layer_idx=layer_idx,
                                         active=active)
    x, _ = _apply_ffn(spec, bp, x + h, cfg)
    return x, new_cache


def decode_step(params, cache, inputs, pos, cfg, active=None):
    """One token for every sequence in the batch.

    inputs: (B, 1) tokens or (B, 1, d_input); pos: an int or a (B,)
    tensor of per-slot positions. The cache is updated in place (rows of
    slots outside ``active``, a (B,) bool mask, are left as they were).
    Returns (logits (B, 1, vocab), cache)."""
    x = embed(params["embed"], inputs, cfg)
    for si, st in enumerate(plan_stages(cfg)):
        sp = params["stages"][f"s{si}"]
        sc = cache[f"s{si}"]
        if st["kind"] == "scan":
            for li in range(st["reps"]):
                rp = _rep(sp, li)
                for pi, spec in enumerate(st["specs"]):
                    x, sc[f"pos{pi}"] = _apply_block_decode(
                        spec, rp[f"pos{pi}"], x, sc[f"pos{pi}"], pos, cfg,
                        layer_idx=li, active=active)
        else:
            for pi, spec in enumerate(st["specs"]):
                x, sc[f"pos{pi}"] = _apply_block_decode(
                    spec, sp[f"pos{pi}"], x, sc[f"pos{pi}"], pos, cfg,
                    active=active)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    return constrain(unembed(params["embed"], x, cfg),
                     ("batch", None, "vocab")), cache


def prefill(params, inputs, cfg, max_len: int | None = None):
    """The full-sequence path → last-token logits."""
    hidden, _ = forward_hidden(params, inputs, cfg)
    return unembed(params["embed"], hidden[:, -1:], cfg)


# ----------------------------------------------------------------------
# Training loss
# ----------------------------------------------------------------------
def _chunk_nll(embed_params, h, labels, mask, cfg):
    """(Σ masked NLL, Σ mask) of one sequence chunk, in float32. Where
    the vocabulary is split over "model" each rank keeps its own logits
    (``layers.vocab_parallel_nll``)."""
    logits, v0 = local_logits(embed_params, h, cfg)
    if v0 is not None:
        return (torch.sum(vocab_parallel_nll(logits, labels, v0) * mask),
                torch.sum(mask))
    logits = constrain(logits, ("batch", "seq", "vocab")).float()
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.take_along_dim(logits, labels.long()[..., None],
                                dim=-1)[..., 0]
    return torch.sum((lse - gold) * mask), torch.sum(mask)


def chunked_nll(params, hidden, labels, cfg, chunk: int = 512, mask=None):
    """(Σ masked NLL, Σ mask), sequence-chunked: never materializes (B,
    S, V). Chunks are summed in order, each recomputed in the backward
    pass when gradients are recorded (the reference's checkpointed
    scan); over a split vocabulary the recomputation issues the chunk's
    collectives again, in the same order on every rank."""
    b, s, d = hidden.shape
    c = min(chunk, s)
    assert s % c == 0
    if mask is None:
        mask = torch.ones((b, s), dtype=torch.float32, device=hidden.device)
    mask = mask.float()
    total = torch.zeros((), dtype=torch.float32, device=hidden.device)
    count = torch.zeros((), dtype=torch.float32, device=hidden.device)
    for i in range(0, s, c):
        args = (params["embed"], hidden[:, i:i + c], labels[:, i:i + c],
                mask[:, i:i + c], cfg)
        if torch.is_grad_enabled():
            nll, n = checkpoint(_chunk_nll, *args, use_reentrant=False,
                                context_fn=recompute_context)
        else:
            nll, n = _chunk_nll(*args)
        total = total + nll
        count = count + n
    return total, count


def chunked_ce_loss(params, hidden, labels, cfg, chunk: int = 512,
                    mask=None):
    """Sequence-chunked mean cross-entropy (:func:`chunked_nll`)."""
    total, count = chunked_nll(params, hidden, labels, cfg, chunk, mask)
    return total / torch.clamp_min(count, 1.0)


def loss_fn(params, batch, cfg):
    """batch: {"inputs": ..., "labels": (B, S)} → (loss, metrics)."""
    hidden, aux = forward_hidden(params, batch["inputs"], cfg)
    ce = chunked_ce_loss(params, hidden, batch["labels"], cfg,
                         mask=batch.get("mask"))
    loss = ce
    if cfg.moe is not None:
        loss = loss + cfg.moe.router_aux_weight * aux
    return loss, {"ce": ce, "aux": aux}


# ----------------------------------------------------------------------
# Analytic parameter counts
# ----------------------------------------------------------------------
def count_params(cfg, active_only: bool = False) -> int:
    d, ff, v = cfg.d_model, cfg.d_ff, cfg.vocab_size
    total = v * d if cfg.input_mode == "tokens" else cfg.d_input * d
    if not cfg.tie_embeddings or cfg.input_mode != "tokens":
        total += d * v

    def mixer_count(spec):
        if spec.mixer == "attn":
            return d * cfg.q_dim * 2 + d * cfg.kv_dim * 2
        if spec.mixer == "mla":
            m = cfg.mla
            qk = m.qk_nope_dim + m.qk_rope_dim
            return (d * m.q_lora_rank
                    + m.q_lora_rank * cfg.n_heads * qk
                    + d * (m.kv_lora_rank + m.qk_rope_dim)
                    + m.kv_lora_rank * cfg.n_heads
                    * (m.qk_nope_dim + m.v_head_dim)
                    + cfg.n_heads * m.v_head_dim * d)
        if spec.mixer == "mamba":
            di, dtr = ssm.mamba_dims(cfg)
            ds = cfg.mamba.d_state
            return (d * 2 * di + cfg.mamba.d_conv * di
                    + di * (dtr + 2 * ds) + dtr * di + di * ds
                    + 3 * di + di * d)  # conv_b, dt_bias, D
        if spec.mixer == "mlstm":
            di, _ = ssm.mlstm_dims(cfg)
            return (d * 2 * di + cfg.xlstm.conv_kernel * di + 3 * di * di
                    + 2 * di * cfg.n_heads + 2 * cfg.n_heads  # bi, bf
                    + 2 * di + di * d)
        if spec.mixer == "slstm":
            di, dh, ffs = ssm.slstm_dims(cfg)
            return (d * 4 * di + 4 * cfg.n_heads * dh * dh + 4 * di
                    + di  # out_norm
                    + di * 2 * ffs + ffs * d)
        raise ValueError(spec.mixer)

    def ffn_count(spec):
        if spec.ffn == "dense":
            return 3 * d * ff
        if spec.ffn == "moe":
            m = cfg.moe
            routed = m.n_experts * 3 * d * m.d_expert
            if active_only:
                routed = m.top_k * 3 * d * m.d_expert
            shared = m.n_shared * 3 * d * m.d_expert
            return d * m.n_experts + routed + shared
        return 0

    for spec in cfg.all_layer_specs():
        norms = d if spec.ffn == "none" else 2 * d
        total += mixer_count(spec) + ffn_count(spec) + norms
    total += d  # final norm
    return int(total)
