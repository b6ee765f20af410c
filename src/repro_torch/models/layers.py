"""Shared layers: RMSNorm, RoPE, SwiGLU FFN, embeddings, inits.

Port of ``src/repro/models/layers.py``. Params are nested dicts of
tensors; every forward takes (params, x, cfg) and works over any batch
and sequence shape. Master params are float32; compute casts to
``cfg.dtype``. Inits draw from an explicit ``torch.Generator`` and
create their tensors on the generator's device.
"""
from __future__ import annotations

import math

import torch

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}


def cdtype(cfg) -> torch.dtype:
    return _DTYPES[cfg.dtype]


# Serving weight forms (runtime/compressed.py) register here on import:
# {leaf type: (apply_fn(x, leaf, dt) -> y, load_fn(leaf, dt) -> dense)}.
# The registry lives in layers, not runtime, so models never import
# runtime (which imports models back).
_WEIGHT_FORMS: dict[type, tuple] = {}


def register_weight_form(cls, apply_fn, load_fn) -> None:
    """Register a compressed weight-form leaf class. ``apply_fn`` runs
    x @ W in compressed form; ``load_fn`` materializes the dense matrix
    (embedding lookups, parity checks)."""
    _WEIGHT_FORMS[cls] = (apply_fn, load_fn)


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


def dense_init(gen: torch.Generator, shape, in_axis: int = 0) -> torch.Tensor:
    """Scaled-normal init, std = 1/sqrt(fan_in)."""
    shape = tuple(shape)
    fan_in = shape[in_axis] if in_axis >= 0 else math.prod(shape[:-1])
    std = 1.0 / math.sqrt(max(fan_in, 1))
    return torch.randn(shape, generator=gen, device=gen.device,
                       dtype=torch.float32) * std


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    dt = x.dtype
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
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
    g = apply_w(x, params["w_gate"], dt)
    u = apply_w(x, params["w_up"], dt)
    return apply_w(torch.nn.functional.silu(g) * u, params["w_down"], dt)


# ----------------------------------------------------------------------
# Embedding / unembedding
# ----------------------------------------------------------------------
def init_embed(gen: torch.Generator, cfg) -> dict:
    if cfg.input_mode == "tokens":
        # std 1/√d so that (×√d at lookup) hidden inputs are unit-scale
        p = {"tokens": torch.randn((cfg.vocab_size, cfg.d_model),
                                   generator=gen, device=gen.device)
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
        x = wload(params["tokens"], dt)[inputs.long()]
        # the scale is rounded to the compute dtype first, as in the
        # reference (on the host: no copy to the device per call)
        return x * float(torch.tensor(math.sqrt(cfg.d_model), dtype=dt))
    return apply_w(inputs.to(dt), params["proj"], dt)


def unembed(params: dict, x: torch.Tensor, cfg) -> torch.Tensor:
    dt = cdtype(cfg)
    if cfg.tie_embeddings and cfg.input_mode == "tokens":
        return x @ wload(params["tokens"], dt).T
    return apply_w(x, params["unembed"], dt)


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
