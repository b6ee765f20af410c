"""Shared layers: RMSNorm, RoPE, SwiGLU FFN, embeddings, inits.

Port of ``src/repro/models/layers.py``. Params are nested dicts of
tensors; every forward takes (params, x, cfg) and works over any batch
and sequence shape. Master params are float32; compute casts to
``cfg.dtype``. Inits draw from an explicit ``torch.Generator`` and
create their tensors on the generator's device.

Under the tensor-parallel ``"model"`` axis (``sharding.shard_params``)
a layer reads from its weights' shapes whether they were split: the
FFN's ``w_gate``/``w_up`` column-parallel on ``"mlp"`` (their input's
gradient summed over the ``"model"`` group, ``sharding.copy_to_model``)
and ``w_down`` row-parallel, its partial sums added over the group
(``sharding.model_all_reduce``); the embedding a lookup into the rank's
vocabulary rows (zero outside them), summed; the unembedding the rank's
logits, gathered in rank order for serving, and for the training loss
kept apart (:func:`local_logits`, :func:`vocab_parallel_nll`).
"""
from __future__ import annotations

import math

import torch

from repro_torch.distributed import sharding

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}


def cdtype(cfg) -> torch.dtype:
    return _DTYPES[cfg.dtype]


# Serving weight forms (runtime/compressed.py) register here on import:
# {leaf type: (apply_fn(x, leaf, dt) -> y, load_fn(leaf, dt) -> dense,
# slice_fn(leaf, dim, lo, hi) -> leaf, join_fn(parts, dim) -> leaf)}. The
# registry lives in layers, not runtime, so models never import runtime
# (which imports models back).
_WEIGHT_FORMS: dict[type, tuple] = {}


def register_weight_form(cls, apply_fn, load_fn, slice_fn=None,
                         join_fn=None) -> None:
    """Register a compressed weight-form leaf class. ``apply_fn`` runs
    x @ W in compressed form; ``load_fn`` materializes the dense matrix
    (embedding lookups, parity checks); ``slice_fn`` cuts rows (dim 0)
    or columns (dim 1) ``[lo, hi)`` of the matrix, in the same form, and
    ``join_fn`` puts consecutive blocks back together along ``dim``."""
    _WEIGHT_FORMS[cls] = (apply_fn, load_fn, slice_fn, join_fn)


def slice_weight(leaf, dim: int, lo: int, hi: int):
    """Indices ``[lo, hi)`` of a weight leaf along ``dim``, in its own
    form and held apart from the whole (a tensor's slice is copied)."""
    form = _WEIGHT_FORMS.get(type(leaf))
    if form is not None:
        if form[2] is None:
            raise TypeError(f"{type(leaf).__name__} cannot be sliced")
        return form[2](leaf, dim, lo, hi)
    return leaf.narrow(dim, lo, hi - lo).clone(
        memory_format=torch.contiguous_format)


def join_weight(parts: list, dim: int):
    """The inverse of :func:`slice_weight`: consecutive blocks of a
    weight along ``dim`` put together, in their form."""
    form = _WEIGHT_FORMS.get(type(parts[0]))
    if form is not None:
        if form[3] is None:
            raise TypeError(f"{type(parts[0]).__name__} cannot be joined")
        return form[3](parts, dim)
    return torch.cat(parts, dim=dim)


def wload(leaf, dt):
    """Load a weight for compute: a dense tensor, or a registered
    compressed weight form (materialized)."""
    form = _WEIGHT_FORMS.get(type(leaf))
    if form is not None:
        return form[1](leaf, dt)
    return leaf.to(dt)


def apply_w(x, leaf, dt):
    """x @ W for a param-tree weight leaf, dispatched by form: dense
    leaves take ``x @ wload(leaf, dt)``; registered compressed forms run
    their own product without materializing W."""
    form = _WEIGHT_FORMS.get(type(leaf))
    if form is not None:
        return form[0](x, leaf, dt)
    return x @ wload(leaf, dt)


class MetaGenerator:
    """A stand-in for a ``torch.Generator`` whose draws are meta tensors:
    the inits given one build a tree of the same shapes that holds no
    memory (``transformer.param_shapes``)."""
    device = torch.device("meta")


def randn(gen, shape) -> torch.Tensor:
    """Standard normal float32 draws from ``gen``, on its device."""
    g = None if isinstance(gen, MetaGenerator) else gen
    return torch.randn(shape, generator=g, device=gen.device,
                       dtype=torch.float32)


def dense_init(gen: torch.Generator, shape, in_axis: int = 0) -> torch.Tensor:
    """Scaled-normal init, std = 1/sqrt(fan_in)."""
    shape = tuple(shape)
    fan_in = shape[in_axis] if in_axis >= 0 else math.prod(shape[:-1])
    std = 1.0 / math.sqrt(max(fan_in, 1))
    return randn(gen, shape) * std


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float,
             n_full: int | None = None) -> torch.Tensor:
    """RMS norm over the last dim. With ``n_full``, ``x`` and ``scale``
    hold a rank's channels of ``n_full`` (a split mixer's): the sum of
    squares, and its gradient, summed over the "model" group."""
    dt = x.dtype
    xf = x.float()
    if n_full is None:
        var = torch.mean(xf * xf, dim=-1, keepdim=True)
    else:
        ss = sharding.copy_to_model(sharding.model_all_reduce(
            torch.sum(xf * xf, dim=-1, keepdim=True)))
        # a true division (a Python scalar divisor may become a multiply
        # by its rounded reciprocal)
        var = ss / torch.full((), float(n_full), dtype=ss.dtype,
                              device=ss.device)
    y = xf * torch.rsqrt(var + eps)
    return (y * (1.0 + scale.float())).to(dt)


# ----------------------------------------------------------------------
# Rotary position embeddings
# ----------------------------------------------------------------------
def rope_frequencies(dim: int, theta: float, device=None) -> torch.Tensor:
    # a Python-scalar base: no host-to-device copy (which would wait for
    # the device) on every call of the decode loop
    exps = torch.arange(0, dim, 2, dtype=torch.float32, device=device) / dim
    return 1.0 / torch.pow(theta, exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (..., S, H, D) with D even; positions: (..., S). The two halves
    of D rotate together (split halves, not interleaved pairs)."""
    d = x.shape[-1]
    freqs = rope_frequencies(d, theta, x.device)                # (D/2,)
    angles = positions[..., :, None].float() * freqs            # (...,S,D/2)
    cos = torch.cos(angles)[..., :, None, :]
    sin = torch.sin(angles)[..., :, None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ----------------------------------------------------------------------
# SwiGLU dense FFN
# ----------------------------------------------------------------------
def init_dense_ffn(gen: torch.Generator, d_model: int, d_ff: int) -> dict:
    return {
        "w_gate": dense_init(gen, (d_model, d_ff)),
        "w_up": dense_init(gen, (d_model, d_ff)),
        "w_down": dense_init(gen, (d_ff, d_model)),
    }


def dense_ffn(params: dict, x: torch.Tensor, cfg) -> torch.Tensor:
    dt = cdtype(cfg)
    split = sharding.model_split(params["w_down"].shape[0], cfg.d_ff,
                                 "dense_ffn")
    if split:
        x = sharding.copy_to_model(x)
    g = apply_w(x, params["w_gate"], dt)
    u = apply_w(x, params["w_up"], dt)
    y = apply_w(torch.nn.functional.silu(g) * u, params["w_down"], dt)
    if split:
        y = sharding.model_all_reduce(y)
    return y


# ----------------------------------------------------------------------
# Embedding / unembedding
# ----------------------------------------------------------------------
def init_embed(gen: torch.Generator, cfg) -> dict:
    if cfg.input_mode == "tokens":
        # std 1/√d so that (×√d at lookup) hidden inputs are unit-scale
        p = {"tokens": randn(gen, (cfg.vocab_size, cfg.d_model))
             / math.sqrt(cfg.d_model)}
    else:
        # stub modality frontend: a linear projection of precomputed
        # patch/frame embeddings
        p = {"proj": dense_init(gen, (cfg.d_input, cfg.d_model))}
    if not cfg.tie_embeddings:
        p["unembed"] = dense_init(gen, (cfg.d_model, cfg.vocab_size))
    return p


def embed(params: dict, inputs: torch.Tensor, cfg) -> torch.Tensor:
    dt = cdtype(cfg)
    if cfg.input_mode == "tokens":
        # the scale is rounded to the compute dtype first, as in the
        # reference (on the host: no copy to the device per call)
        scale = float(torch.tensor(math.sqrt(cfg.d_model), dtype=dt))
        table = wload(params["tokens"], dt)
        ids = inputs.long()
        n = table.shape[0]
        if not sharding.model_split(n, cfg.vocab_size, "embed"):
            return table[ids] * scale
        # the rank's vocabulary rows [v0, v0 + n): a token outside them
        # looks up zeros, and the ranks' lookups add up to the whole
        local = ids - sharding.model_rank(sharding.active_mesh()) * n
        inside = (local >= 0) & (local < n)
        x = table[torch.where(inside, local, 0)] * scale
        return sharding.model_all_reduce(
            torch.where(inside[..., None], x, 0.0))
    return apply_w(inputs.to(dt), params["proj"], dt)


def _logits(params: dict, x: torch.Tensor, cfg) -> torch.Tensor:
    dt = cdtype(cfg)
    if cfg.tie_embeddings and cfg.input_mode == "tokens":
        return x @ wload(params["tokens"], dt).T
    return apply_w(x, params["unembed"], dt)


def unembed(params: dict, x: torch.Tensor, cfg) -> torch.Tensor:
    """The logits over the whole vocabulary (the ranks' columns gathered
    where the vocabulary is split over "model")."""
    logits = _logits(params, x, cfg)
    if sharding.model_split(logits.shape[-1], cfg.vocab_size, "unembed"):
        logits = sharding.model_all_gather(logits, -1)
    return logits


def local_logits(params: dict, x: torch.Tensor, cfg):
    """``(logits, v0)``: the logits of the vocabulary rows this rank
    holds, ``[v0, v0 + V/m)``, where the vocabulary is split over
    "model" (``x``'s gradient summed over the group); ``v0`` is ``None``
    where it is whole."""
    n = (params["tokens"].shape[0]
         if cfg.tie_embeddings and cfg.input_mode == "tokens"
         else params["unembed"].shape[1])
    if not sharding.model_split(n, cfg.vocab_size, "unembed"):
        return _logits(params, x, cfg), None
    v0 = sharding.model_rank(sharding.active_mesh()) * n
    return _logits(params, sharding.copy_to_model(x), cfg), v0


class _VocabParallelNLL(torch.autograd.Function):
    """Per-token NLL from a rank's float32 logits of the vocabulary rows
    ``[v0, v0 + V/m)``: the max and Σexp summed over the group, the gold
    logit from the rank that holds the label; backward, softmax − onehot
    on the rank's own columns."""

    @staticmethod
    def forward(ctx, logits, labels, group, v0):
        n = logits.shape[-1]
        mx = sharding.model_reduce(logits.amax(dim=-1), group, "max")
        e = torch.exp(logits - mx[..., None])
        total = sharding.model_reduce(e.sum(dim=-1), group)
        local = labels.long() - v0
        inside = (local >= 0) & (local < n)
        local = torch.where(inside, local, 0)
        gold = torch.take_along_dim(logits, local[..., None], dim=-1)[..., 0]
        gold = sharding.model_reduce(torch.where(inside, gold, 0.0), group)
        ctx.save_for_backward(e, total, local, inside)
        return torch.log(total) + mx - gold

    @staticmethod
    def backward(ctx, g):
        e, total, local, inside = ctx.saved_tensors
        grad = e / total[..., None] * g[..., None]
        hit = torch.where(inside, g, 0.0)
        grad = grad.scatter_add(-1, local[..., None], -hit[..., None])
        return grad, None, None, None


def vocab_parallel_nll(logits: torch.Tensor, labels: torch.Tensor,
                       v0: int) -> torch.Tensor:
    """Per-token negative log-likelihood (float32) from this rank's
    ``logits`` (..., V/m) of the vocabulary rows ``[v0, v0 + V/m)`` over
    the active mesh's "model" group: no rank forms a tensor of the whole
    vocabulary's width."""
    group = sharding.entry_group(sharding.active_mesh(), "model")
    return _VocabParallelNLL.apply(logits.float(), labels, group, v0)


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  mask: torch.Tensor | None = None) -> torch.Tensor:
    """Mean token cross-entropy in float32."""
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.take_along_dim(logits, labels.long()[..., None],
                                dim=-1)[..., 0]
    nll = lse - gold
    if mask is not None:
        mask = mask.float()
        return torch.sum(nll * mask) / torch.clamp_min(torch.sum(mask), 1.0)
    return torch.mean(nll)
