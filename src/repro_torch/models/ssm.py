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

Under the tensor-parallel ``"model"`` axis of m ranks
(``sharding.shard_params``, :func:`inner_slices`) each mixer splits its
``"inner"`` channels, and reads from its weights' shapes whether it was
split (``sharding.model_split``):

* Mamba by channel: rank r holds channels ``[r·di/m, (r+1)·di/m)`` of
  ``in_proj``'s x and z columns, the conv taps, ``dt_bias``, ``D``,
  ``A_log``'s rows, ``dt_proj``'s columns and the row-parallel
  ``x_proj`` and ``out_proj``; the scan runs on its channels, and its
  cache holds them;
* mLSTM by whole heads (H % m = 0): ``up_proj``'s x and z columns, the
  conv, ``out_norm``, the column-parallel ``wq``/``wk``/``wv`` and
  gates of its heads, the row-parallel ``down_proj``; its chunks and
  cache hold its heads;
* sLSTM by whole heads: the four gates' columns of ``w`` and ``b``, its
  heads of ``r`` (the recurrence stays on the rank: no collective in
  the time loop), ``out_norm``, ``up_proj``'s u and g columns over
  ``"mlp"`` and the row-parallel ``down_proj``.

Where the heads do not divide (or Mamba's channels) the mixer runs whole
on every rank. Three results are held whole by every rank but read only
in part: Mamba's ``x_proj`` output (dt, B and C, summed from the ranks'
row-parallel parts), mLSTM's ``xc``/``xm`` and sLSTM's normed ``h``
(gathered for the column-parallel products), and the RMS of a split
``out_norm`` (its sum of squares summed). Each rank's gradient of such a
result is a part of the whole: the forward composes
``sharding.copy_to_model`` over ``sharding.model_all_reduce`` (the sums)
or ``sharding.model_all_gather`` (the gathers), so that the parts are
summed over the group before they flow back (:func:`_summed`,
:func:`_gathered`, ``layers.rms_norm(n_full=)``). The input of every mixer takes ``copy_to_model``.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.distributed import sharding
from repro_torch.distributed.sharding import constrain
from repro_torch.models.layers import apply_w, dense_init, randn, rms_norm

M_FLOOR = -30.0      # the stabilizer's floor (keeps exp(-m) finite)


# ----------------------------------------------------------------------
# the "inner" split over the "model" axis
# ----------------------------------------------------------------------
def inner_split(cfg, kind: str, m: int) -> bool:
    """Whether the mixer ``kind`` splits over a ``"model"`` axis of
    ``m``: Mamba where its channels divide, mLSTM where its heads do,
    sLSTM where its heads and its post-MLP width do."""
    if m == 1:
        return False
    if kind == "mamba":
        return mamba_dims(cfg)[0] % m == 0
    if kind == "mlstm":
        return cfg.n_heads % m == 0
    return cfg.n_heads % m == 0 and slstm_dims(cfg)[2] % m == 0


def inner_slices(cfg, kind: str, name: str, m: int, r: int):
    """Rank ``r``'s slice of the SSM mixer leaf ``name`` over a
    ``"model"`` axis of ``m``: ``(dim, segments)``, ``dim`` counted from
    the leaf's end and ``segments`` its ``(lo, hi)`` ranges along it in
    the order the rank holds them (one a part of a fused leaf), or
    ``None`` where the mixer runs whole."""
    if not inner_split(cfg, kind, m):
        return None
    if kind == "mamba":
        di = mamba_dims(cfg)[0]
    elif kind == "mlstm":
        di = mlstm_dims(cfg)[0]
    else:
        di, _, ff = slstm_dims(cfg)
    q = di // m
    ch = ((r * q, (r + 1) * q),)                  # the rank's channels
    hl = cfg.n_heads // m
    heads = ((r * hl, (r + 1) * hl),)
    xz = ((r * q, (r + 1) * q), (di + r * q, di + (r + 1) * q))
    cuts = {
        "mamba": {"in_proj": (-1, xz), "conv_w": (-1, ch),
                  "conv_b": (-1, ch), "x_proj": (-2, ch),
                  "dt_proj": (-1, ch), "dt_bias": (-1, ch),
                  "A_log": (-2, ch), "D": (-1, ch), "out_proj": (-2, ch)},
        "mlstm": {"up_proj": (-1, xz), "conv_w": (-1, ch),
                  "conv_b": (-1, ch), "wq": (-1, ch), "wk": (-1, ch),
                  "wv": (-1, ch), "wi": (-1, heads), "wf": (-1, heads),
                  "bi": (-1, heads), "bf": (-1, heads),
                  "out_norm": (-1, ch), "down_proj": (-2, ch)},
    }
    if kind == "slstm":
        gates = tuple((g * di + lo, g * di + hi) for g in range(4)
                      for lo, hi in ch)
        fq = ff // m
        mlp = ((r * fq, (r + 1) * fq), (ff + r * fq, ff + (r + 1) * fq))
        cuts["slstm"] = {"w": (-1, gates), "b": (-1, gates),
                         "r": (-3, heads), "out_norm": (-1, ch),
                         "up_proj": (-1, mlp),
                         "down_proj": (-2, ((r * fq, (r + 1) * fq),))}
    return cuts[kind][name]


def _summed(x: torch.Tensor) -> torch.Tensor:
    """The ranks' parts of ``x`` summed over the "model" group; its
    gradient, which each rank holds a part of, summed over the group."""
    return sharding.copy_to_model(sharding.model_all_reduce(x))


def _gathered(x: torch.Tensor) -> torch.Tensor:
    """The ranks' channels of ``x`` (last dim) put together in rank
    order; the gradient of the whole summed over the group before each
    rank takes its channels."""
    return sharding.copy_to_model(sharding.model_all_gather(x, -1))


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


def mamba_axes(cfg) -> dict:
    return {
        "in_proj": ("embed", "inner"),
        "conv_w": ("conv", "inner"),
        "conv_b": ("inner",),
        "x_proj": ("inner", "lora"),
        "dt_proj": ("lora", "inner"),
        "dt_bias": ("inner",),
        "A_log": ("inner", "state"),
        "D": ("inner",),
        "out_proj": ("inner", "embed"),
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
    di = params["D"].shape[0]                 # the rank's channels
    split = sharding.model_split(di, mamba_dims(cfg)[0], "mamba")
    dtr = mamba_dims(cfg)[1]
    b, s, _ = x.shape
    dt_ = x.dtype

    if split:
        x = sharding.copy_to_model(x)
    xz = apply_w(x, params["in_proj"], dt_)
    xi, z = torch.chunk(xz, 2, dim=-1)
    xi = constrain(xi, ("batch", "seq", "inner"))
    xi, conv_tail = _causal_conv(xi, params["conv_w"].to(dt_),
                                 params["conv_b"].to(dt_))
    xi = F.silu(xi)

    xdbl = apply_w(xi, params["x_proj"], dt_)
    if split:
        xdbl = _summed(xdbl)
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
    if split:
        out = sharding.model_all_reduce(out)
    if not return_cache:
        return out
    return out, {"conv": conv_tail, "ssm": h}


def _local_width(cfg, kind: str, di: int) -> int:
    """``di`` channels, or the rank's share where the mixer splits over
    the active mesh's "model" axis."""
    m = sharding.model_size(sharding.active_mesh())
    return di // m if inner_split(cfg, kind, m) else di


def init_mamba_cache(cfg, spec, batch: int, max_len: int, dtype,
                     device) -> dict:
    """The rank's channels under the active mesh's "model" axis."""
    m = cfg.mamba
    di = _local_width(cfg, "mamba", mamba_dims(cfg)[0])
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
    split = sharding.model_split(params["D"].shape[0], mamba_dims(cfg)[0],
                                 "mamba")
    dtr = mamba_dims(cfg)[1]
    dt_ = x.dtype
    st = _read_states(cache, layer_idx)

    xz = apply_w(x, params["in_proj"], dt_)
    xi, z = torch.chunk(xz, 2, dim=-1)
    xi, conv_state = _causal_conv(
        xi, params["conv_w"].to(dt_), params["conv_b"].to(dt_),
        state=st["conv"])
    xi = F.silu(xi)[:, 0]                                      # (B, di)

    xdbl = apply_w(xi, params["x_proj"], dt_)
    if split:
        xdbl = _summed(xdbl)
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
    if split:
        out = sharding.model_all_reduce(out)
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


def mlstm_axes(cfg) -> dict:
    return {
        "up_proj": ("embed", "inner"), "conv_w": ("conv", "inner"),
        "conv_b": ("inner",), "wq": ("inner", "inner"),
        "wk": ("inner", "inner"), "wv": ("inner", "inner"),
        "wi": ("inner", "gates"), "wf": ("inner", "gates"),
        "bi": ("gates",), "bf": ("gates",), "out_norm": ("inner",),
        "down_proj": ("inner", "embed"),
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
    di_full, dh = mlstm_dims(cfg)
    hn = params["bi"].shape[-1]               # the rank's heads
    split = sharding.model_split(hn, cfg.n_heads, "mLSTM")
    di = hn * dh
    b, s, _ = x.shape
    dt_ = x.dtype
    c = min(cfg.xlstm.chunk, s)
    if s % c:
        raise ValueError(f"sequence {s} is not a multiple of the mLSTM "
                         f"chunk {c}")

    if split:
        x = sharding.copy_to_model(x)
    xz = apply_w(x, params["up_proj"], dt_)
    xm, z = torch.chunk(xz, 2, dim=-1)
    xc, conv_tail = _causal_conv(xm, params["conv_w"].to(dt_),
                                 params["conv_b"].to(dt_))
    xc = F.silu(xc)
    # the heads' products read every channel
    xc_all, xm_all = (_gathered(xc), _gathered(xm)) if split else (xc, xm)
    q = apply_w(xc_all, params["wq"], dt_).reshape(b, s, hn, dh)
    k = _div_scalar(apply_w(xc_all, params["wk"], dt_).reshape(
        b, s, hn, dh), math.sqrt(dh))
    v = apply_w(xm_all, params["wv"], dt_).reshape(b, s, hn, dh)
    li, lf = _mlstm_gates(params, xc_all)

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
    hseq = rms_norm(hseq, params["out_norm"], cfg.norm_eps,
                    di_full if split else None)
    y = apply_w(hseq * F.silu(z), params["down_proj"], dt_)
    if split:
        y = sharding.model_all_reduce(y)
    if not return_cache:
        return y
    return y, {"conv": conv_tail, "C": cbar, "n": nbar, "m": mbar}


def init_mlstm_cache(cfg, spec, batch: int, max_len: int, dtype,
                     device) -> dict:
    """The rank's heads under the active mesh's "model" axis."""
    _, dh = mlstm_dims(cfg)
    hn = _local_width(cfg, "mlstm", cfg.n_heads)
    di = hn * dh
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
    di_full, dh = mlstm_dims(cfg)
    hn = params["bi"].shape[-1]
    split = sharding.model_split(hn, cfg.n_heads, "mLSTM")
    di = hn * dh
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
    if split:
        xc, xm = _gathered(xc), _gathered(xm)
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
    hvec = rms_norm(hvec, params["out_norm"], cfg.norm_eps,
                    di_full if split else None)
    out = apply_w(hvec * F.silu(z[:, 0]), params["down_proj"], dt_)
    if split:
        out = sharding.model_all_reduce(out)
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
    r = randn(gen, (4, cfg.n_heads, dh, dh)) / math.sqrt(dh)
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


def slstm_axes(cfg) -> dict:
    return {
        # the reference's table, which keeps r replicated (split over
        # "model" by its rows it would cost a sum over the group at every
        # time step); the port splits r by whole heads instead
        # (``inner_slices``), with no collective in the time loop
        "w": ("embed", "inner"), "r": ("stack", None, None, None),
        "b": ("inner",), "out_norm": ("inner",),
        "up_proj": ("inner", "mlp"), "down_proj": ("mlp", "embed"),
    }


def _slstm_cell(params, wx_t, state, cfg):
    """One sLSTM step. wx_t: (B, 4·di), the input's precomputed share;
    state (c, n, h, m). Returns the new state and h. The heads are those
    of ``r`` (the rank's, where the mixer is split)."""
    _, dh, _ = slstm_dims(cfg)
    hn = params["r"].shape[1]
    di = hn * dh
    c, n, hprev, m = state
    hh = hprev.reshape(-1, hn, dh)
    # the wider of the two dtypes, as the reference's einsum promotes
    # (bf16 serving weights against an f32 state)
    dt = torch.promote_types(hh.dtype, params["r"].dtype)
    rec = torch.einsum("bhd,ghde->bghe", hh.to(dt), params["r"].to(dt))
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


def _slstm_split(params, cfg) -> bool:
    return sharding.model_split(params["out_norm"].shape[-1],
                                slstm_dims(cfg)[0], "sLSTM")


def _slstm_out(params, h, cfg, dt_):
    """The block's norm and gated post-MLP on h (…, di): over a split
    mixer the normed channels are gathered for ``up_proj``'s columns and
    ``down_proj``'s row-parallel parts summed."""
    split = _slstm_split(params, cfg)
    h = rms_norm(h, params["out_norm"], cfg.norm_eps,
                 slstm_dims(cfg)[0] if split else None)
    if split:
        h = _gathered(h)
    u, g = torch.chunk(apply_w(h, params["up_proj"], dt_), 2, dim=-1)
    y = apply_w(u * F.silu(g), params["down_proj"], dt_)
    return sharding.model_all_reduce(y) if split else y


def slstm_forward(params, x, cfg, spec, positions, return_cache=False):
    di = params["out_norm"].shape[-1]         # the rank's channels
    if _slstm_split(params, cfg):
        x = sharding.copy_to_model(x)
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
    """The rank's channels under the active mesh's "model" axis."""
    di = _local_width(cfg, "slstm", slstm_dims(cfg)[0])
    f32 = dict(dtype=torch.float32, device=device)
    return {"c": torch.zeros((batch, di), **f32),
            "n": torch.zeros((batch, di), **f32),
            "h": torch.zeros((batch, di), **f32),
            "m": torch.full((batch, di), M_FLOOR, **f32)}


def slstm_decode(params, x, cache, pos, cfg, spec, layer_idx=None,
                 active=None):
    dt_ = x.dtype
    st = _read_states(cache, layer_idx)
    xt = x[:, 0]
    if _slstm_split(params, cfg):
        xt = sharding.copy_to_model(xt)
    wx = apply_w(xt, params["w"], dt_).float()
    (c, n, h, m), _ = _slstm_cell(params, wx,
                                  (st["c"], st["n"], st["h"], st["m"]), cfg)
    out = _slstm_out(params, h.to(dt_), cfg, dt_)[:, None]
    return out, _write_states(cache, {"c": c, "n": n, "h": h, "m": m},
                              layer_idx, active)
