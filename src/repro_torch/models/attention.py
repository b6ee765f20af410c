"""Attention mixers: GQA (full / sliding window), with blockwise
(FlashAttention-style online-softmax) prefill and 1-token decode against
full or ring-buffer KV caches.

Port of the GQA half of ``src/repro/models/attention.py``; the MLA
functions come with a later slice (ROADMAP item 10). Where the reference
only tags ``blockwise_attention(fused=True)`` as the flash kernel's math,
the port runs the kernel: ``fused=True`` goes through
``kernels/flash_attention/ops.attention``, which launches K6 on CUDA
tensors (and runs its plain version on CPU tensors).

Decode writes the new token's K/V into the cache in place: a step
consumes the cache it is given and returns it. With ``active`` (a (B,)
bool mask), rows that are not active keep their cache bit for bit.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.models.layers import apply_rope, apply_w, dense_init

NEG_INF = -1e30


def init_attn(gen: torch.Generator, cfg) -> dict:
    d, q, kv = cfg.d_model, cfg.q_dim, cfg.kv_dim
    return {
        "wq": dense_init(gen, (d, q)),
        "wk": dense_init(gen, (d, kv)),
        "wv": dense_init(gen, (d, kv)),
        "wo": dense_init(gen, (q, d)),
    }


def _mask(q_pos, k_pos, window: int):
    """Causal (+ sliding-window) mask: True = attend."""
    ok = k_pos[None, :] <= q_pos[:, None]
    if window > 0:
        ok &= k_pos[None, :] > q_pos[:, None] - window
    return ok


def blockwise_attention(q, k, v, q_positions, k_positions, *,
                        window: int = 0, q_chunk: int = 1024,
                        kv_chunk: int = 1024, scale: float | None = None,
                        fused: bool = False):
    """Online-softmax attention.

    q: (B, Sq, H, D); k, v: (B, Sk, KV, D); positions: (Sq,), (Sk,).
    Returns (B, Sq, H, D). Causal by construction of the position mask.

    ``fused=True`` runs the flash-attention kernel (K6), which takes the
    full-sequence causal case of the model's prefill: Sq == Sk with
    positions 0..S-1, scale 1/√D and V's head dim equal to D. It is
    forward-only: under autograd (grad mode on and an input requiring
    grad) it raises, on every device, rather than cut the graph. Otherwise
    the loop below runs, scanning q chunks × kv chunks with running
    (m, l, acc) so the (Sq, Sk) logits are never formed.
    """
    b, sq, h, d = q.shape
    sk, kv = k.shape[1], k.shape[2]
    dv = v.shape[-1]                      # may differ from d (MLA)
    if fused:
        if torch.is_grad_enabled() and any(t.requires_grad
                                           for t in (q, k, v)):
            # the kernel has no backward: its output carries no grad_fn,
            # so a train step through it would leave attention untrained
            raise NotImplementedError(
                "the flash kernel (fused=True) is forward-only and cannot "
                "be differentiated (its backward kernel is open in "
                "ROADMAP.md); train with fused_attention=False, the plain "
                "online-softmax path")
        if sq != sk or scale is not None or dv != d:
            raise NotImplementedError(
                "the flash kernel takes the causal Sq == Sk prefill with "
                "scale 1/sqrt(D) and V of head dim D (the MLA variants "
                "come with ROADMAP item 10)")
        return flash_ops.attention(q, k, v, window=window)
    g = h // kv
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    qc = min(q_chunk, sq)
    kc = min(kv_chunk, sk)
    assert sq % qc == 0 and sk % kc == 0, (sq, qc, sk, kc)
    nq, nk = sq // qc, sk // kc

    qr = q.reshape(b, nq, qc, kv, g, d)
    kr = k.reshape(b, nk, kc, kv, d)
    vr = v.reshape(b, nk, kc, kv, dv)
    qp = q_positions.reshape(nq, qc)
    kp = k_positions.reshape(nk, kc)
    outs = []
    for i in range(nq):
        q_i = qr[:, i].float()                        # (B, qc, KV, G, D)
        m = torch.full((b, kv, g, qc), NEG_INF, dtype=torch.float32,
                       device=q.device)
        l = torch.zeros((b, kv, g, qc), dtype=torch.float32, device=q.device)
        acc = torch.zeros((b, kv, g, qc, dv), dtype=torch.float32,
                          device=q.device)
        for j in range(nk):
            s = torch.einsum("bqkgd,bckd->bkgqc", q_i,
                             kr[:, j].float()) * scale
            mask = _mask(qp[i], kp[j], window)        # (qc, kc)
            s = torch.where(mask, s, NEG_INF)
            m_new = torch.maximum(m, s.amax(dim=-1))
            p = torch.exp(s - m_new[..., None])
            alpha = torch.exp(m - m_new)
            l = l * alpha + p.sum(dim=-1)
            pv = torch.einsum("bkgqc,bckd->bkgqd", p.to(v.dtype).float(),
                              vr[:, j].float())
            acc = acc * alpha[..., None] + pv
            m = m_new
        out = acc / torch.clamp_min(l[..., None], 1e-30)   # (B,KV,G,qc,Dv)
        outs.append(out.to(q.dtype))
    out = torch.stack(outs, dim=1)                    # (B,nq,KV,G,qc,Dv)
    out = out.permute(0, 1, 4, 2, 3, 5)               # (B,nq,qc,KV,G,Dv)
    return out.reshape(b, sq, h, dv)


def attn_forward(params, x, cfg, spec, positions, return_cache=False):
    """Full-sequence attention (prefill). x: (B, S, d_model)."""
    b, s, _ = x.shape
    dt = x.dtype
    q = apply_w(x, params["wq"], dt).reshape(b, s, cfg.n_heads, cfg.head_dim)
    k = apply_w(x, params["wk"], dt).reshape(b, s, cfg.n_kv_heads,
                                             cfg.head_dim)
    v = apply_w(x, params["wv"], dt).reshape(b, s, cfg.n_kv_heads,
                                             cfg.head_dim)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    out = blockwise_attention(
        q, k, v, positions, positions, window=spec.window,
        q_chunk=cfg.attn_chunk_q, kv_chunk=cfg.attn_chunk_kv,
        fused=cfg.fused_attention)
    y = apply_w(out.reshape(b, s, cfg.q_dim), params["wo"], dt)
    if not return_cache:
        return y
    w = spec.window
    if w > 0 and s > w:  # ring-buffer layers keep the last window
        k, v = k[:, -w:], v[:, -w:]
    return y, {"k": k.contiguous(), "v": v.contiguous()}


# ----------------------------------------------------------------------
# Decode path (1 new token against a KV cache)
# ----------------------------------------------------------------------
def init_attn_cache(cfg, spec, batch: int, max_len: int, dtype,
                    device) -> dict:
    """Full cache for global layers; ring buffer for windowed layers."""
    length = min(spec.window, max_len) if spec.window > 0 else max_len
    shape = (batch, length, cfg.n_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def slot_positions(pos, batch: int, device) -> torch.Tensor:
    """The new token's position per row: a scalar (whole batch in
    lockstep) broadcasts, a (B,) tensor gives each slot its own."""
    if isinstance(pos, torch.Tensor) and pos.ndim == 1:
        return pos.to(device=device, dtype=torch.int64)
    return torch.full((batch,), int(pos), dtype=torch.int64, device=device)


def attn_decode(params, x, cache, pos, cfg, spec, layer_idx=None,
                active=None):
    """x: (B, 1, d_model); pos: 0-based index of the new token — an int
    (whole batch in lockstep) or a (B,) tensor (per-slot positions,
    continuous batching: every slot writes its own ring slot and masks
    its own validity range).

    ``layer_idx`` set ⇒ cache leaves are layer-stacked (L, B, len, KV, D)
    and this layer's rows are written in place. ``active`` ((B,) bool)
    leaves the cache rows of inactive slots untouched; their outputs are
    computed and meaningless."""
    b = x.shape[0]
    dt = x.dtype
    q = apply_w(x, params["wq"], dt).reshape(b, 1, cfg.n_heads, cfg.head_dim)
    k = apply_w(x, params["wk"], dt).reshape(b, 1, cfg.n_kv_heads,
                                             cfg.head_dim)
    v = apply_w(x, params["wv"], dt).reshape(b, 1, cfg.n_kv_heads,
                                             cfg.head_dim)
    pos_b = slot_positions(pos, b, x.device)                     # (B,)
    q = apply_rope(q, pos_b[:, None], cfg.rope_theta)
    k = apply_rope(k, pos_b[:, None], cfg.rope_theta)

    k_buf, v_buf = cache["k"], cache["v"]
    k_cache = k_buf if layer_idx is None else k_buf[layer_idx]  # (B,len,KV,D)
    v_cache = v_buf if layer_idx is None else v_buf[layer_idx]
    length = k_cache.shape[1]
    slot = pos_b % length if spec.window > 0 else \
        torch.clamp_max(pos_b, length - 1)
    rows = torch.arange(b, device=x.device)
    k_new, v_new = k[:, 0].to(k_cache.dtype), v[:, 0].to(v_cache.dtype)
    if active is not None:
        keep = ~active.to(x.device)[:, None, None]
        k_new = torch.where(keep, k_cache[rows, slot], k_new)
        v_new = torch.where(keep, v_cache[rows, slot], v_new)
    k_cache[rows, slot] = k_new
    v_cache[rows, slot] = v_new

    kvh, g = cfg.n_kv_heads, cfg.n_heads // cfg.n_kv_heads
    qh = q.reshape(b, kvh, g, cfg.head_dim)
    s = torch.einsum("bkgd,bskd->bkgs", qh.float(), k_cache.float())
    s = s / math.sqrt(cfg.head_dim)
    n_valid = torch.clamp_max(pos_b + 1, length)                 # (B,)
    valid = torch.arange(length, device=x.device)[None, :] < n_valid[:, None]
    s = torch.where(valid[:, None, None, :], s, NEG_INF)
    p = torch.softmax(s, dim=-1).to(dt)
    out = torch.einsum("bkgs,bskd->bkgd", p.float(),
                       v_cache.float()).to(dt)
    out = out.reshape(b, 1, cfg.q_dim)
    return apply_w(out, params["wo"], dt), {"k": k_buf, "v": v_buf}
