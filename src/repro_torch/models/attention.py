"""Attention mixers: GQA (full / sliding window) and Multi-head Latent
Attention (MLA), with blockwise (FlashAttention-style online-softmax)
prefill and 1-token decode against full or ring-buffer KV caches (GQA)
or the latent cache (MLA).

Port of ``src/repro/models/attention.py``. Where the reference only
tags ``blockwise_attention(fused=True)`` as the flash kernel's math, the
port runs the kernel: ``fused=True`` goes through
``kernels/flash_attention/ops.attention``, which launches K6 on CUDA
tensors (and runs its plain version on CPU tensors), at MLA's head dims
too (qk and v head dims apart, an explicit scale).

Decode writes the new token's cache entries in place: a step consumes
the cache it is given and returns it. With ``active`` (a (B,) bool
mask), the rows of inactive slots end the step with their cache bit for
bit as it was, while their outputs are those of the reference's step
(the new token written, then the old rows merged back), which matters
where rows meet again downstream (an MoE FFN's capacity).
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.models.layers import (
    apply_rope, apply_w, dense_init, rms_norm, wload)

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

    q: (B, Sq, H, D); k: (B, Sk, KV, D); v: (B, Sk, KV, Dv); positions:
    (Sq,), (Sk,). Returns (B, Sq, H, Dv). Causal by construction of the
    position mask; ``scale`` defaults to 1/√D.

    ``fused=True`` runs the flash-attention kernel (K6), which takes the
    full-sequence causal case of the model's prefill: Sq == Sk with
    positions 0..S-1, any scale, and the (D, Dv) pairs it is built for
    (Dv == D, and MLA's (96, 64)). It is forward-only: under autograd
    (grad mode on and an input requiring grad) it raises, on every
    device, rather than cut the graph. Otherwise
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
        if sq != sk:
            raise NotImplementedError(
                "the flash kernel takes the causal Sq == Sk prefill")
        return flash_ops.attention(q, k, v, window=window, scale=scale)
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


def _write_rows(pairs, rows, slot, active):
    """Write each (cache (B, len, ...), new (B, ...)) pair's new entries
    at (row, slot[row]) in place, for every row; returns the callable
    that, after the step's attention has read the caches, puts back the
    entries of the rows outside ``active`` (nothing when it is None)."""
    old = None
    if active is not None:
        keep = ~active.to(rows.device)
        old = [cache[rows, slot].clone() for cache, _ in pairs]
    for cache, new in pairs:
        cache[rows, slot] = new.to(cache.dtype)

    def restore():
        if old is None:
            return
        for (cache, _), prev in zip(pairs, old):
            mask = keep.reshape((-1,) + (1,) * (prev.ndim - 1))
            cache[rows, slot] = torch.where(mask, prev, cache[rows, slot])
    return restore


def attn_decode(params, x, cache, pos, cfg, spec, layer_idx=None,
                active=None):
    """x: (B, 1, d_model); pos: 0-based index of the new token — an int
    (whole batch in lockstep) or a (B,) tensor (per-slot positions,
    continuous batching: every slot writes its own ring slot and masks
    its own validity range).

    ``layer_idx`` set ⇒ cache leaves are layer-stacked (L, B, len, KV, D)
    and this layer's rows are written in place. ``active`` ((B,) bool)
    leaves the cache rows of inactive slots as they were; their outputs
    are the reference's (computed with the new token in the cache)."""
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
    restore = _write_rows(((k_cache, k[:, 0]), (v_cache, v[:, 0])), rows,
                          slot, active)

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
    restore()
    out = out.reshape(b, 1, cfg.q_dim)
    return apply_w(out, params["wo"], dt), {"k": k_buf, "v": v_buf}


# ======================================================================
# Multi-head Latent Attention (MiniCPM3 / DeepSeek-V2 style)
# ======================================================================
def init_mla(gen: torch.Generator, cfg) -> dict:
    m = cfg.mla
    h = cfg.n_heads
    qk_dim = m.qk_nope_dim + m.qk_rope_dim
    dev = gen.device
    return {
        "wdq": dense_init(gen, (cfg.d_model, m.q_lora_rank)),
        "q_norm": torch.zeros((m.q_lora_rank,), device=dev),
        "wuq": dense_init(gen, (m.q_lora_rank, h * qk_dim)),
        "wdkv": dense_init(gen, (cfg.d_model,
                                 m.kv_lora_rank + m.qk_rope_dim)),
        "kv_norm": torch.zeros((m.kv_lora_rank,), device=dev),
        "wukv": dense_init(gen, (m.kv_lora_rank,
                                 h * (m.qk_nope_dim + m.v_head_dim))),
        "wo": dense_init(gen, (h * m.v_head_dim, cfg.d_model)),
    }


def _mla_qkv(params, x, cfg, positions):
    """Shared q/k/v construction for the full-sequence MLA path →
    (q (B,S,H,nope+rope), k (B,S,H,nope+rope), v (B,S,H,v), the normed
    latent (B,S,kv_lora), k_rope (B,S,1,rope))."""
    m = cfg.mla
    b, s, _ = x.shape
    dt = x.dtype
    h = cfg.n_heads
    cq = rms_norm(apply_w(x, params["wdq"], dt), params["q_norm"],
                  cfg.norm_eps)
    q = apply_w(cq, params["wuq"], dt).reshape(
        b, s, h, m.qk_nope_dim + m.qk_rope_dim)
    q_nope, q_rope = torch.split(q, [m.qk_nope_dim, m.qk_rope_dim], dim=-1)
    q_rope = apply_rope(q_rope, positions, cfg.rope_theta)

    ckv_full = apply_w(x, params["wdkv"], dt)
    ckv, k_rope = torch.split(ckv_full, [m.kv_lora_rank, m.qk_rope_dim],
                              dim=-1)
    k_rope = apply_rope(k_rope[:, :, None, :], positions, cfg.rope_theta)
    ckv_n = rms_norm(ckv, params["kv_norm"], cfg.norm_eps)
    kv = (ckv_n @ wload(params["wukv"], dt)).reshape(
        b, s, h, m.qk_nope_dim + m.v_head_dim)
    k_nope, v = torch.split(kv, [m.qk_nope_dim, m.v_head_dim], dim=-1)
    k = torch.cat([k_nope, k_rope.expand(b, s, h, m.qk_rope_dim)], dim=-1)
    q = torch.cat([q_nope, q_rope], dim=-1)
    return q, k, v.contiguous(), ckv_n, k_rope


def mla_forward(params, x, cfg, spec, positions, return_cache=False):
    """Full-sequence MLA (prefill): attention over the up-projected heads
    at qk head dim nope+rope and v head dim ``v_head_dim``; the cache
    keeps the latents {"ckv" (B,S,kv_lora), "k_rope" (B,S,rope)}."""
    m = cfg.mla
    b, s, _ = x.shape
    dt = x.dtype
    q, k, v, ckv_n, k_rope = _mla_qkv(params, x, cfg, positions)
    scale = 1.0 / math.sqrt(m.qk_nope_dim + m.qk_rope_dim)
    out = blockwise_attention(
        q, k, v, positions, positions, window=spec.window,
        q_chunk=cfg.attn_chunk_q, kv_chunk=cfg.attn_chunk_kv, scale=scale,
        fused=cfg.fused_attention)
    out = out.reshape(b, s, cfg.n_heads * m.v_head_dim)
    y = apply_w(out, params["wo"], dt)
    if not return_cache:
        return y
    return y, {"ckv": ckv_n.contiguous(),
               "k_rope": k_rope[:, :, 0, :].contiguous()}


def init_mla_cache(cfg, spec, batch: int, max_len: int, dtype,
                   device) -> dict:
    m = cfg.mla
    return {
        "ckv": torch.zeros((batch, max_len, m.kv_lora_rank), dtype=dtype,
                           device=device),
        "k_rope": torch.zeros((batch, max_len, m.qk_rope_dim), dtype=dtype,
                              device=device),
    }


def mla_decode(params, x, cache, pos, cfg, spec, layer_idx=None,
               active=None):
    """Absorbed-matrix MLA decode: attention runs in the latent space, so
    per-step work is O(S·(kv_lora+rope)) instead of O(S·H·qk_dim).

    x: (B, 1, d_model); pos: an int (whole batch in lockstep) or a (B,)
    tensor (per-slot positions); ``layer_idx`` set ⇒ the cache leaves are
    layer-stacked (L, B, max_len, ·). The new latents are written at each
    row's position in place; ``active`` as in :func:`attn_decode`."""
    m = cfg.mla
    b = x.shape[0]
    dt = x.dtype
    h = cfg.n_heads
    pos_b = slot_positions(pos, b, x.device)                     # (B,)

    cq = rms_norm(apply_w(x, params["wdq"], dt), params["q_norm"],
                  cfg.norm_eps)
    q = apply_w(cq, params["wuq"], dt).reshape(
        b, h, m.qk_nope_dim + m.qk_rope_dim)
    q_nope, q_rope = torch.split(q, [m.qk_nope_dim, m.qk_rope_dim], dim=-1)
    q_rope = apply_rope(q_rope[:, None], pos_b[:, None],
                        cfg.rope_theta)[:, 0]                    # (B,H,rope)

    ckv_full = apply_w(x, params["wdkv"], dt)[:, 0]      # (B, lora+rope)
    ckv_new, k_rope_new = torch.split(
        ckv_full, [m.kv_lora_rank, m.qk_rope_dim], dim=-1)
    ckv_new = rms_norm(ckv_new, params["kv_norm"], cfg.norm_eps)
    k_rope_new = apply_rope(k_rope_new[:, None, None, :], pos_b[:, None],
                            cfg.rope_theta)[:, 0, 0]

    ckv_buf, kr_buf = cache["ckv"], cache["k_rope"]
    ckv = ckv_buf if layer_idx is None else ckv_buf[layer_idx]
    k_rope = kr_buf if layer_idx is None else kr_buf[layer_idx]
    rows = torch.arange(b, device=x.device)
    restore = _write_rows(((ckv, ckv_new), (k_rope, k_rope_new)), rows,
                          pos_b, active)

    # absorb W_uk into q: q_abs (B,H,lora)
    wukv = wload(params["wukv"], dt).reshape(
        m.kv_lora_rank, h, m.qk_nope_dim + m.v_head_dim)
    w_uk = wukv[..., :m.qk_nope_dim]                     # (lora,H,nope)
    w_uv = wukv[..., m.qk_nope_dim:]                     # (lora,H,v)
    q_abs = torch.einsum("bhn,lhn->bhl", q_nope, w_uk)
    s = (torch.einsum("bhl,bsl->bhs", q_abs.float(), ckv.float())
         + torch.einsum("bhr,bsr->bhs", q_rope.float(), k_rope.float()))
    s = s / math.sqrt(m.qk_nope_dim + m.qk_rope_dim)
    valid = (torch.arange(ckv.shape[1], device=x.device)[None, :]
             <= pos_b[:, None])
    s = torch.where(valid[:, None, :], s, NEG_INF)
    p = torch.softmax(s, dim=-1).to(dt)
    o_latent = torch.einsum("bhs,bsl->bhl", p, ckv.to(dt))   # (B,H,lora)
    restore()
    out = torch.einsum("bhl,lhv->bhv", o_latent, w_uv)       # (B,H,v)
    out = out.reshape(b, 1, h * m.v_head_dim)
    return apply_w(out, params["wo"], dt), {"ckv": ckv_buf,
                                            "k_rope": kr_buf}
