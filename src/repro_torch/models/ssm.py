"""Recurrent mixers: Mamba-1 (Jamba) and xLSTM (mLSTM + sLSTM).

Port of ``src/repro/models/ssm.py``. The full-sequence paths are chunked
so memory stays O(B·chunk·inner·state):

* Mamba: a loop over sequence chunks of 128 carrying the (B, d_inner,
  d_state) state; inside a chunk the linear recurrence h_t = a_t·h_{t-1}
  + b_t runs as the reference's associative scan, mirrored step for step
  (``_associative_scan``: the same odd/even recursion of log₂ c levels,
  so the products and sums round as the reference's do) rather than as
  a loop of c steps, which would be c rounds of small launches on the
  card. Its temporaries at c = 128 are a few (B, c, d_inner, d_state)
  f32 tensors (134 MB each at jamba's full width and B = 2).
* mLSTM: the chunkwise-parallel form: an intra-chunk (c × c) gate matrix
  plus the inter-chunk (C, n, m) running state with max-stabilization.
* sLSTM: a loop over time (the block-diagonal recurrence is sequential).

With ``cfg.remat``, a forward that records gradients checkpoints each
Mamba and mLSTM chunk (the reference wraps its chunk bodies in
``jax.checkpoint``), inside the stack's per-block checkpoints.

Decode paths are single-step recurrent updates whose state does not grow
with the context. Each ``*_decode`` takes ``(params, x, cache, pos, cfg,
spec, layer_idx=None, active=None)`` as the attention mixers do: the new
states are written into the cache in place (``cache[k][layer_idx]`` for
a layer-stacked stage); with ``active`` (a (B,) bool mask) the rows of
inactive slots keep their states bit for bit, and their outputs are the
reference's (computed from their states as they were).

Gates follow the reference's forms: softplus is ``logaddexp(x, 0)``
(``torch.nn.functional.softplus`` turns into the identity above 20) and
log-sigmoid is ``-softplus(-x)``. Weight leaves that the reference reads
directly (``conv_w``, ``A_log``, sLSTM's ``r``) are read with ``.to``:
a compressed weight form there has no product and raises.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.models.layers import apply_w, dense_init, rms_norm

M_FLOOR = -30.0      # the stabilizer's floor (keeps exp(-m) finite)


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: log(1 + eˣ) as ``logaddexp(x, 0)``."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype,
                                          device=x.device))


def _log_sigmoid(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.log_sigmoid``: ``-softplus(-x)``."""
    return -_softplus(-x)


def _div_scalar(x: torch.Tensor, v: float) -> torch.Tensor:
    """x / v as a true division (a Python scalar divisor may become a
    multiply by its rounded reciprocal)."""
    return x / torch.full((), v, dtype=x.dtype, device=x.device)


def _remat(cfg) -> bool:
    return bool(cfg.remat) and torch.is_grad_enabled()


def _write_states(cache: dict, new: dict, layer_idx, active) -> dict:
    """Write each new state into ``cache`` in place (row ``layer_idx`` of
    a layer-stacked leaf), keeping the rows of slots outside ``active``."""
    for k, v in new.items():
        dst = cache[k] if layer_idx is None else cache[k][layer_idx]
        v = v.to(dst.dtype)
        if active is not None:
            mask = active.to(dst.device).reshape((-1,) + (1,) * (v.ndim - 1))
            v = torch.where(mask, v, dst)
        dst.copy_(v)
    return cache


def _read_states(cache: dict, layer_idx) -> dict:
    return {k: (v if layer_idx is None else v[layer_idx])
            for k, v in cache.items()}


# ======================================================================
# Mamba-1
# ======================================================================
def mamba_dims(cfg) -> tuple[int, int]:
    """(d_inner, dt_rank)."""
    m = cfg.mamba
    d_inner = m.expand * cfg.d_model
    dt_rank = m.dt_rank or int(math.ceil(cfg.d_model / 16))
    return d_inner, dt_rank


def init_mamba(gen: torch.Generator, cfg) -> dict:
    m = cfg.mamba
    di, dtr = mamba_dims(cfg)
    dev = gen.device
    a = torch.arange(1, m.d_state + 1, dtype=torch.float32,
                     device=dev).repeat(di, 1)
    return {
        "in_proj": dense_init(gen, (cfg.d_model, 2 * di)),
        "conv_w": dense_init(gen, (m.d_conv, di)),
        "conv_b": torch.zeros((di,), device=dev),
        "x_proj": dense_init(gen, (di, dtr + 2 * m.d_state)),
        "dt_proj": dense_init(gen, (dtr, di)),
        # softplus⁻¹ of 0.01, the mean of U(1e-3, 1e-1)
        "dt_bias": torch.log(torch.expm1(torch.full((di,), 0.01,
                                                    device=dev))),
        "A_log": torch.log(a),
        "D": torch.ones((di,), device=dev),
        "out_proj": dense_init(gen, (di, cfg.d_model)),
    }


def _causal_conv(x, w, b, state=None):
    """Depthwise causal conv over the sequence. x: (B, S, C), w: (K, C).

    ``state``: (B, K-1, C) trailing inputs of the previous step (decode).
    Returns (y, the new state: the last K-1 inputs, a copy)."""
    k = w.shape[0]
    if state is None:
        pad = x.new_zeros((x.shape[0], k - 1, x.shape[2]))
    else:
        pad = state.to(x.dtype)
    xp = torch.cat([pad, x], dim=1)                   # (B, S+K-1, C)
    s = x.shape[1]
    # the taps summed in order, as the reference's sum() (0 + tap 0 is
    # tap 0)
    y = xp[:, :s, :] * w[0][None, None, :]
    for i in range(1, k):
        y = y + xp[:, i:i + s, :] * w[i][None, None, :]
    return y + b[None, None, :], xp[:, -(k - 1):, :].clone()


def _combine(a, b):
    """The affine maps' composition: (a1, b1) then (a2, b2)."""
    a1, b1 = a
    a2, b2 = b
    return a1 * a2, b1 * a2 + b2


def _interleave(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a[0], b[0], a[1], b[1], … along dim 1 (len(a) - len(b) ∈ {0, 1})."""
    n = b.shape[1]
    out = torch.stack([a[:, :n], b], dim=2).reshape(
        (a.shape[0], 2 * n) + tuple(a.shape[2:]))
    if a.shape[1] > n:
        out = torch.cat([out, a[:, n:]], dim=1)
    return out


def _associative_scan(elems: list) -> list:
    """``jax.lax.associative_scan(_combine, elems, axis=1)``: the same
    odd/even recursion, so each output is the same product and sum."""
    n = elems[0].shape[1]
    if n < 2:
        return elems
    reduced = _combine([e[:, 0:n - 1:2] for e in elems],
                       [e[:, 1::2] for e in elems])
    odd = _associative_scan(list(reduced))
    if n % 2 == 0:
        even = _combine([e[:, :-1] for e in odd], [e[:, 2::2] for e in elems])
    else:
        even = _combine(odd, [e[:, 2::2] for e in elems])
    even = [torch.cat([e[:, :1], r], dim=1) for e, r in zip(elems, even)]
    return [_interleave(a, b) for a, b in zip(even, odd)]


def _selective_scan_chunk(h0, da, dbx):
    """The scan within a chunk. da, dbx: (B, c, di, ds); h0: (B, di, ds).
    Returns (every step's state (B, c, di, ds), the last one)."""
    aa, bb = _associative_scan([da, dbx])
    h = aa * h0[:, None] + bb
    return h, h[:, -1].clone()


def _mamba_chunk(h, xi_j, dt_j, b_j, c_j, a):
    """One chunk of the selective scan → (the state after it, y (B, c,
    di) in float32)."""
    da = torch.exp(dt_j[..., None] * a[None, None])            # (B,c,di,ds)
    dbx = (dt_j * xi_j.float())[..., None] * b_j[..., None, :]
    hs, h_last = _selective_scan_chunk(h, da, dbx)
    y = torch.einsum("bcds,bcs->bcd", hs, c_j.float())
    return h_last, y


def mamba_forward(params, x, cfg, spec, positions, chunk: int = 128,
                  return_cache=False):
    """x: (B, S, d_model) → (B, S, d_model)."""
    m = cfg.mamba
    di, dtr = mamba_dims(cfg)
    b, s, _ = x.shape
    dt_ = x.dtype

    xz = apply_w(x, params["in_proj"], dt_)
    xi, z = torch.chunk(xz, 2, dim=-1)
    xi, conv_tail = _causal_conv(xi, params["conv_w"].to(dt_),
                                 params["conv_b"].to(dt_))
    xi = F.silu(xi)

    xdbl = apply_w(xi, params["x_proj"], dt_)
    dt_raw, b_ssm, c_ssm = torch.split(xdbl, [dtr, m.d_state, m.d_state],
                                       dim=-1)
    dt = _softplus(apply_w(dt_raw, params["dt_proj"], dt_)
                   + params["dt_bias"].to(dt_))                # (B,S,di)
    a = -torch.exp(params["A_log"].float())                    # (di, ds)

    c = min(chunk, s)
    if s % c:
        raise ValueError(f"sequence {s} is not a multiple of the Mamba "
                         f"chunk {c}")
    remat = _remat(cfg)
    h = torch.zeros((b, di, m.d_state), dtype=torch.float32,
                    device=x.device)
    ys = []
    for j in range(0, s, c):
        args = (h, xi[:, j:j + c], dt[:, j:j + c].float(),
                b_ssm[:, j:j + c].float(), c_ssm[:, j:j + c], a)
        if remat:
            h, y = checkpoint(_mamba_chunk, *args, use_reentrant=False)
        else:
            h, y = _mamba_chunk(*args)
        ys.append(y.to(dt_))
    y = torch.cat(ys, dim=1)
    y = y + xi * params["D"].to(dt_)[None, None]
    y = y * F.silu(z)
    out = apply_w(y, params["out_proj"], dt_)
    if not return_cache:
        return out
    return out, {"conv": conv_tail, "ssm": h}


def init_mamba_cache(cfg, spec, batch: int, max_len: int, dtype,
                     device) -> dict:
    m = cfg.mamba
    di, _ = mamba_dims(cfg)
    return {
        "conv": torch.zeros((batch, m.d_conv - 1, di), dtype=dtype,
                            device=device),
        "ssm": torch.zeros((batch, di, m.d_state), dtype=torch.float32,
                           device=device),
    }


def mamba_decode(params, x, cache, pos, cfg, spec, layer_idx=None,
                 active=None):
    """x: (B, 1, d_model): one step of the recurrence."""
    m = cfg.mamba
    di, dtr = mamba_dims(cfg)
    dt_ = x.dtype
    st = _read_states(cache, layer_idx)

    xz = apply_w(x, params["in_proj"], dt_)
    xi, z = torch.chunk(xz, 2, dim=-1)
    xi, conv_state = _causal_conv(
        xi, params["conv_w"].to(dt_), params["conv_b"].to(dt_),
        state=st["conv"])
    xi = F.silu(xi)[:, 0]                                      # (B, di)

    xdbl = apply_w(xi, params["x_proj"], dt_)
    dt_raw, b_ssm, c_ssm = torch.split(xdbl, [dtr, m.d_state, m.d_state],
                                       dim=-1)
    dt = _softplus(apply_w(dt_raw, params["dt_proj"], dt_)
                   + params["dt_bias"].to(dt_)).float()        # (B, di)
    a = -torch.exp(params["A_log"].float())
    da = torch.exp(dt[..., None] * a[None])                    # (B,di,ds)
    dbx = (dt * xi.float())[..., None] * b_ssm.float()[:, None, :]
    h = st["ssm"] * da + dbx
    y = torch.einsum("bds,bs->bd", h, c_ssm.float()).to(dt_)
    y = y + xi * params["D"].to(dt_)[None]
    y = y * F.silu(z[:, 0])
    out = apply_w(y, params["out_proj"], dt_)[:, None]
    return out, _write_states(cache, {"conv": conv_state, "ssm": h},
                              layer_idx, active)


# ======================================================================
# xLSTM — mLSTM (chunkwise-parallel) and sLSTM (sequential)
# ======================================================================
def mlstm_dims(cfg) -> tuple[int, int]:
    """(d_inner, the per-head width d_inner / n_heads)."""
    di = int(cfg.xlstm.proj_factor_m * cfg.d_model)
    return di, di // cfg.n_heads


def init_mlstm(gen: torch.Generator, cfg) -> dict:
    di, _ = mlstm_dims(cfg)
    hn = cfg.n_heads
    dev = gen.device
    return {
        "up_proj": dense_init(gen, (cfg.d_model, 2 * di)),
        "conv_w": dense_init(gen, (cfg.xlstm.conv_kernel, di)),
        "conv_b": torch.zeros((di,), device=dev),
        "wq": dense_init(gen, (di, di)),
        "wk": dense_init(gen, (di, di)),
        "wv": dense_init(gen, (di, di)),
        "wi": dense_init(gen, (di, hn)),
        "wf": dense_init(gen, (di, hn)),
        "bi": torch.zeros((hn,), device=dev),
        "bf": torch.full((hn,), 3.0, device=dev),      # f open at init
        "out_norm": torch.zeros((di,), device=dev),
        "down_proj": dense_init(gen, (di, cfg.d_model)),
    }


def _mlstm_gates(params, xc):
    """(log i, log f), each (…, H) in float32."""
    li = apply_w(xc, params["wi"], xc.dtype).float() + params["bi"]
    lf = _log_sigmoid(apply_w(xc, params["wf"], xc.dtype).float()
                      + params["bf"])
    return li, lf


def _mlstm_chunk(cbar, nbar, mbar, q_j, k_j, v_j, li_j, lf_j):
    """One chunk: its outputs (B, c, H, dh) in float32 and the (C, n, m)
    state at its end."""
    c = q_j.shape[1]
    q_j, k_j, v_j = q_j.float(), k_j.float(), v_j.float()
    f_cum = torch.cumsum(lf_j, dim=1)                          # (B,c,H)
    # intra-chunk scores a[t, s] = F_t − F_s + li_s (s ≤ t)
    a_mat = (f_cum[:, :, None, :] - f_cum[:, None, :, :]
             + li_j[:, None, :, :])                            # (B,c,c,H)
    tri = torch.ones((c, c), dtype=torch.bool, device=q_j.device).tril()
    a_mat = torch.where(tri[None, :, :, None], a_mat, -math.inf)
    m_intra = torch.amax(a_mat, dim=2)                         # (B,c,H)
    m_state = f_cum + mbar[:, None, :]
    m_tot = torch.maximum(m_intra, m_state)
    m_tot = torch.clamp_min(m_tot, M_FLOOR)
    d_mat = torch.exp(a_mat - m_tot[:, :, None, :])
    state_w = torch.exp(m_state - m_tot)

    s_mat = torch.einsum("bthd,bshd->btsh", q_j, k_j)
    cw = s_mat * d_mat
    num_intra = torch.einsum("btsh,bshd->bthd", cw, v_j)
    num_state = torch.einsum("bthd,bhde->bthe", q_j, cbar) \
        * state_w[..., None]
    den_intra = torch.sum(cw, dim=2)
    den_state = torch.einsum("bthd,bhd->bth", q_j, nbar) * state_w
    den = torch.maximum(torch.abs(den_intra + den_state),
                        torch.exp(-m_tot)) + 1e-6
    h_out = (num_intra + num_state) / den[..., None]

    # the state at the chunk's end
    f_tot = f_cum[:, -1, :]                                    # (B,H)
    bmat = f_tot[:, None, :] - f_cum + li_j                    # (B,c,H)
    m_new = torch.maximum(f_tot + mbar, torch.amax(bmat, dim=1))
    m_new = torch.clamp_min(m_new, M_FLOOR)
    w_s = torch.exp(bmat - m_new[:, None, :])
    carry = torch.exp(f_tot + mbar - m_new)
    kw = k_j * w_s[..., None]
    kv = torch.einsum("bshd,bshe->bhde", kw, v_j)
    c_new = cbar * carry[..., None, None] + kv
    n_new = nbar * carry[..., None] + torch.sum(kw, dim=1)
    return h_out, c_new, n_new, m_new


def mlstm_forward(params, x, cfg, spec, positions, return_cache=False):
    """Chunkwise-parallel mLSTM. x: (B, S, d) → (B, S, d)."""
    di, dh = mlstm_dims(cfg)
    hn = cfg.n_heads
    b, s, _ = x.shape
    dt_ = x.dtype
    c = min(cfg.xlstm.chunk, s)
    if s % c:
        raise ValueError(f"sequence {s} is not a multiple of the mLSTM "
                         f"chunk {c}")

    xz = apply_w(x, params["up_proj"], dt_)
    xm, z = torch.chunk(xz, 2, dim=-1)
    xc, conv_tail = _causal_conv(xm, params["conv_w"].to(dt_),
                                 params["conv_b"].to(dt_))
    xc = F.silu(xc)
    q = apply_w(xc, params["wq"], dt_).reshape(b, s, hn, dh)
    k = _div_scalar(apply_w(xc, params["wk"], dt_).reshape(b, s, hn, dh),
                    math.sqrt(dh))
    v = apply_w(xm, params["wv"], dt_).reshape(b, s, hn, dh)
    li, lf = _mlstm_gates(params, xc)

    remat = _remat(cfg)
    cbar = torch.zeros((b, hn, dh, dh), dtype=torch.float32,
                       device=x.device)
    nbar = torch.zeros((b, hn, dh), dtype=torch.float32, device=x.device)
    mbar = torch.full((b, hn), M_FLOOR, dtype=torch.float32,
                      device=x.device)
    hs = []
    for j in range(0, s, c):
        args = (cbar, nbar, mbar, q[:, j:j + c], k[:, j:j + c],
                v[:, j:j + c], li[:, j:j + c], lf[:, j:j + c])
        if remat:
            h_j, cbar, nbar, mbar = checkpoint(_mlstm_chunk, *args,
                                               use_reentrant=False)
        else:
            h_j, cbar, nbar, mbar = _mlstm_chunk(*args)
        hs.append(h_j.to(dt_))
    hseq = torch.cat(hs, dim=1).reshape(b, s, di)
    hseq = rms_norm(hseq, params["out_norm"], cfg.norm_eps)
    y = apply_w(hseq * F.silu(z), params["down_proj"], dt_)
    if not return_cache:
        return y
    return y, {"conv": conv_tail, "C": cbar, "n": nbar, "m": mbar}


def init_mlstm_cache(cfg, spec, batch: int, max_len: int, dtype,
                     device) -> dict:
    di, dh = mlstm_dims(cfg)
    hn = cfg.n_heads
    f32 = dict(dtype=torch.float32, device=device)
    return {
        "conv": torch.zeros((batch, cfg.xlstm.conv_kernel - 1, di),
                            dtype=dtype, device=device),
        "C": torch.zeros((batch, hn, dh, dh), **f32),
        "n": torch.zeros((batch, hn, dh), **f32),
        "m": torch.full((batch, hn), M_FLOOR, **f32),
    }


def mlstm_decode(params, x, cache, pos, cfg, spec, layer_idx=None,
                 active=None):
    """x: (B, 1, d_model): one step of the recurrence."""
    di, dh = mlstm_dims(cfg)
    hn = cfg.n_heads
    b = x.shape[0]
    dt_ = x.dtype
    st = _read_states(cache, layer_idx)

    xz = apply_w(x, params["up_proj"], dt_)
    xm, z = torch.chunk(xz, 2, dim=-1)
    xc, conv_state = _causal_conv(
        xm, params["conv_w"].to(dt_), params["conv_b"].to(dt_),
        state=st["conv"])
    xc = F.silu(xc)[:, 0]
    xm = xm[:, 0]
    q = apply_w(xc, params["wq"], dt_).reshape(b, hn, dh).float()
    k = _div_scalar(apply_w(xc, params["wk"], dt_).reshape(b, hn, dh),
                    math.sqrt(dh)).float()
    v = apply_w(xm, params["wv"], dt_).reshape(b, hn, dh).float()
    li, lf = _mlstm_gates(params, xc)

    m_new = torch.maximum(lf + st["m"], li)
    m_new = torch.clamp_min(m_new, M_FLOOR)
    fp = torch.exp(lf + st["m"] - m_new)[..., None]            # (B,H,1)
    ip = torch.exp(li - m_new)[..., None]
    c_new = st["C"] * fp[..., None] \
        + ip[..., None] * (k[..., :, None] * v[..., None, :])
    n_new = st["n"] * fp + ip * k
    num = torch.einsum("bhd,bhde->bhe", q, c_new)
    den = torch.maximum(torch.abs(torch.einsum("bhd,bhd->bh", q, n_new)),
                        torch.exp(-m_new)) + 1e-6
    hvec = (num / den[..., None]).reshape(b, di).to(dt_)
    hvec = rms_norm(hvec, params["out_norm"], cfg.norm_eps)
    out = apply_w(hvec * F.silu(z[:, 0]), params["down_proj"], dt_)
    return out[:, None], _write_states(
        cache, {"conv": conv_state, "C": c_new, "n": n_new, "m": m_new},
        layer_idx, active)


# ----------------------------------------------------------------------
# sLSTM
# ----------------------------------------------------------------------
def slstm_dims(cfg) -> tuple[int, int, int]:
    """(d_inner = d_model, the per-head width, the post-MLP width)."""
    di = cfg.d_model                      # no up-projection in the core
    ff = int(cfg.xlstm.proj_factor_s * cfg.d_model)
    ff = (ff + 63) // 64 * 64
    return di, di // cfg.n_heads, ff


def init_slstm(gen: torch.Generator, cfg) -> dict:
    di, dh, ff = slstm_dims(cfg)
    dev = gen.device
    w = dense_init(gen, (cfg.d_model, 4 * di))
    r = torch.randn((4, cfg.n_heads, dh, dh), generator=gen, device=dev,
                    dtype=torch.float32) / math.sqrt(dh)
    b = torch.zeros((4 * di,), device=dev)
    b[di:2 * di] = 3.0                    # forget-gate bias (order i,f,z,o)
    return {
        "w": w,
        "r": r,
        "b": b,
        "out_norm": torch.zeros((di,), device=dev),
        "up_proj": dense_init(gen, (di, 2 * ff)),
        "down_proj": dense_init(gen, (ff, cfg.d_model)),
    }


def _slstm_cell(params, wx_t, state, cfg):
    """One sLSTM step. wx_t: (B, 4·di), the input's precomputed share;
    state (c, n, h, m). Returns the new state and h."""
    di, dh, _ = slstm_dims(cfg)
    hn = cfg.n_heads
    c, n, hprev, m = state
    hh = hprev.reshape(-1, hn, dh)
    rec = torch.einsum("bhd,ghde->bghe", hh, params["r"])
    pre = (wx_t.reshape(-1, 4, di) + rec.reshape(-1, 4, di)
           + params["b"].reshape(4, di)[None])
    it, ft, zt, ot = pre.unbind(dim=1)
    lf = _log_sigmoid(ft)
    m_new = torch.maximum(lf + m, it)
    i_s = torch.exp(it - m_new)
    f_s = torch.exp(lf + m - m_new)
    c_new = f_s * c + i_s * torch.tanh(zt)
    n_new = f_s * n + i_s
    h_new = torch.sigmoid(ot) * c_new / torch.clamp_min(n_new, 1e-6)
    return (c_new, n_new, h_new, m_new), h_new


def _slstm_out(params, h, cfg, dt_):
    """The block's norm and gated post-MLP on h (…, di)."""
    h = rms_norm(h, params["out_norm"], cfg.norm_eps)
    u, g = torch.chunk(apply_w(h, params["up_proj"], dt_), 2, dim=-1)
    return apply_w(u * F.silu(g), params["down_proj"], dt_)


def slstm_forward(params, x, cfg, spec, positions, return_cache=False):
    di, _, _ = slstm_dims(cfg)
    b, s, _ = x.shape
    dt_ = x.dtype
    wx = apply_w(x, params["w"], dt_).float()                  # (B,S,4di)
    zero = torch.zeros((b, di), dtype=torch.float32, device=x.device)
    st = (zero, zero, zero, torch.full((b, di), M_FLOOR,
                                       dtype=torch.float32, device=x.device))
    hs = []
    for t in range(s):
        st, h_t = _slstm_cell(params, wx[:, t], st, cfg)
        hs.append(h_t)
    h = torch.stack(hs, dim=1).to(dt_)                         # (B,S,di)
    y = _slstm_out(params, h, cfg, dt_)
    if not return_cache:
        return y
    c, n, h_f, m = st
    return y, {"c": c, "n": n, "h": h_f, "m": m}


def init_slstm_cache(cfg, spec, batch: int, max_len: int, dtype,
                     device) -> dict:
    di, _, _ = slstm_dims(cfg)
    f32 = dict(dtype=torch.float32, device=device)
    return {"c": torch.zeros((batch, di), **f32),
            "n": torch.zeros((batch, di), **f32),
            "h": torch.zeros((batch, di), **f32),
            "m": torch.full((batch, di), M_FLOOR, **f32)}


def slstm_decode(params, x, cache, pos, cfg, spec, layer_idx=None,
                 active=None):
    dt_ = x.dtype
    st = _read_states(cache, layer_idx)
    wx = apply_w(x[:, 0], params["w"], dt_).float()
    (c, n, h, m), _ = _slstm_cell(params, wx,
                                  (st["c"], st["n"], st["h"], st["m"]), cfg)
    out = _slstm_out(params, h.to(dt_), cfg, dt_)[:, None]
    return out, _write_states(cache, {"c": c, "n": n, "h": h, "m": m},
                              layer_idx, active)
