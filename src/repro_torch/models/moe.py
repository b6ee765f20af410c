"""Mixture-of-Experts FFN: top-k routing, sort-free capacity packing,
batched expert GEMMs and a gated scatter-add back.

Port of the unsharded branch of ``src/repro/models/moe.py``. The router
runs in float32; each token's top-k experts (``torch.topk(sorted=True)``:
ties to the lower index, as ``jax.lax.top_k``) get renormalized gates.
Tokens are packed into a fixed-capacity (E, C, d) buffer by the
reference's rank trick: a stable argsort of the flattened (token-major)
expert ids, ``searchsorted`` for each assignment's position within its
expert, ``C = ceil(T·k/E·capacity_factor)``, and a trash slot at E·C for
the assignments past capacity (their tokens are dropped for that
expert). The three expert GEMMs are batched products; the gated results
are scatter-added back per token. The Switch load-balance loss
``E·Σ_e f_e·P_e`` is the aux output.

Gradients flow through the gather and the scatter-add; the routing
indices carry none. The expert stacks are dense tensors only:
:func:`_dispatch_compute` refuses a compressed weight form, so the
serving bridge keeps 3-D stacks dense. The shared experts and the router
go through ``layers.apply_w``, which for a dense leaf is the reference's
``x @ w``.

Over a mesh (the reference's ``shard_map`` branch): where the batch is
split over the mesh's batch axes (the model holds this rank's rows,
``sharding.local_batch``, as the data-parallel train step lays it out
when the batch divides them), the rank routes its own tokens at the
per-shard capacity ``ceil(t_loc·k/E·capacity_factor)`` and ``f_e`` and
``P_e`` are averaged over the group before the aux loss (the
reference's ``psum``/n, here a differentiable ``all_reduce``);
otherwise the tokens stay replicated and every rank routes them all.
Over a ``"model"`` axis of m ranks the expert stacks are split as
``sharding.shard_params`` lays them out, which the weights' shapes tell:

* ``"ep"`` (E divides by m): rank r holds experts ``[r·E/m,
  (r+1)·E/m)`` and packs only the assignments to them, at the capacity
  of the tokens it holds (the global E in the formula);
* ``"tp"`` (otherwise): every expert's ``w_gate``/``w_up`` split on
  ``"mlp"`` and ``w_down`` on its rows;

then the ranks' partial outputs are summed over the ``"model"`` group
(the reference's ``psum`` over "model"). The router is whole on every
rank, so each rank routes all of its tokens at one process's capacity
and drops what the reference drops; the shared experts split as a dense
FFN, and their partial sums join the routed experts' in one
``all_reduce``. In training the routed tokens, their gates and the
shared experts' input take ``sharding.copy_to_model``: their gradients
are summed over the group, and the router's and the load-balance loss's
stay whole on every rank.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.distributed import sharding
from repro_torch.models.layers import apply_w, dense_init


def init_moe(gen: torch.Generator, cfg) -> dict:
    """Router, stacked experts and (when ``n_shared > 0``) the shared
    experts, drawn from ``gen`` in the reference's key order (router,
    w_gate, w_up, w_down, sw_gate, sw_up, sw_down)."""
    m = cfg.moe
    e, d, fe = m.n_experts, cfg.d_model, m.d_expert
    p = {
        "router": dense_init(gen, (d, e)),
        "w_gate": torch.stack([dense_init(gen, (d, fe)) for _ in range(e)]),
        "w_up": torch.stack([dense_init(gen, (d, fe)) for _ in range(e)]),
        "w_down": torch.stack([dense_init(gen, (fe, d)) for _ in range(e)]),
    }
    if m.n_shared > 0:
        fs = m.n_shared * fe
        p["sw_gate"] = dense_init(gen, (d, fs))
        p["sw_up"] = dense_init(gen, (d, fs))
        p["sw_down"] = dense_init(gen, (fs, d))
    return p


def moe_axes(cfg) -> dict:
    ax = {
        "router": ("embed", None),
        "w_gate": ("experts", "embed", "mlp"),
        "w_up": ("experts", "embed", "mlp"),
        "w_down": ("experts", "mlp", "embed"),
    }
    if cfg.moe.n_shared > 0:
        ax["sw_gate"] = ("embed", "mlp")
        ax["sw_up"] = ("embed", "mlp")
        ax["sw_down"] = ("mlp", "embed")
    return ax


def route(x, router_w, cfg):
    """x (T, d) → (probs (T, E) f32, gates (T, k) in x's dtype, idx (T, k)
    int64): softmax over the f32 router logits, the top k (ties to the
    lower index), renormalized."""
    logits = apply_w(x, router_w, x.dtype).float()
    probs = torch.softmax(logits, dim=-1)
    gates, idx = torch.topk(probs, cfg.moe.top_k, dim=-1, sorted=True)
    gates = gates / torch.sum(gates, dim=-1, keepdim=True)
    return probs, gates.to(x.dtype), idx


def dispatch_plan(gates, idx, *, e0: int, e_local: int, capacity: int):
    """The packing of ``_dispatch_compute``: (buf_tok (E·C,) int32, the
    token of every buffer slot, 0 where empty; buf_gate (E·C,) its gate,
    0 where empty or dropped; slot (T·k,) int64, each sorted assignment's
    slot, E·C for the trash)."""
    t, k = idx.shape
    c = capacity
    rel = idx.reshape(-1) - e0                       # token-major
    valid = (rel >= 0) & (rel < e_local)
    rel_c = torch.where(valid, rel, e_local).to(torch.int32)
    order = torch.argsort(rel_c, stable=True)
    sorted_rel = rel_c[order]
    first = torch.searchsorted(sorted_rel, sorted_rel, side="left")
    pos = torch.arange(t * k, device=idx.device) - first
    tok = torch.div(order, k, rounding_mode="floor").to(torch.int32)
    gate_sorted = gates.reshape(-1)[order]
    keep = (sorted_rel < e_local) & (pos < c)
    slot = torch.where(keep, sorted_rel.long() * c + pos, e_local * c)
    buf_tok = torch.zeros((e_local * c + 1,), dtype=torch.int32,
                          device=idx.device)
    buf_gate = torch.zeros((e_local * c + 1,), dtype=gates.dtype,
                           device=idx.device)
    # the kept slots are distinct; only the trash slot repeats
    buf_tok[slot] = tok
    buf_gate[slot] = torch.where(keep, gate_sorted, 0.0)
    return buf_tok[:e_local * c], buf_gate[:e_local * c], slot


def _dispatch_compute(x, gates, idx, wg, wu, wd, *, e0: int, e_local: int,
                      capacity: int, dtype):
    """Pack → expert GEMMs → gated combine, for experts [e0, e0+e_local).

    x: (T, d); gates/idx: (T, k); wg/wu: (eL, d, fe); wd: (eL, fe, d),
    dense tensors."""
    for w in (wg, wu, wd):
        if not isinstance(w, torch.Tensor):
            raise TypeError(
                f"the expert stacks must be dense tensors, got "
                f"{type(w).__name__}: the serving bridge keeps 3-D stacks "
                f"dense")
    t, d = x.shape
    buf_tok, buf_gate, _ = dispatch_plan(gates, idx, e0=e0, e_local=e_local,
                                         capacity=capacity)
    xb = x[buf_tok.long()].reshape(e_local, capacity, d)
    g = torch.bmm(xb, wg.to(dtype))
    u = torch.bmm(xb, wu.to(dtype))
    y = torch.bmm(F.silu(g) * u, wd.to(dtype))
    y = y.reshape(e_local * capacity, d) * buf_gate[:, None].to(dtype)
    return torch.zeros((t, d), dtype=dtype, device=x.device).index_add(
        0, buf_tok.long(), y)


def _moe_local(x, router_w, wg, wu, wd, cfg, *, e0: int, e_local: int,
               capacity: int, batch_group=None, split: bool = False):
    """x: (T, d) tokens → (y (T, d), aux 0-d f32). ``batch_group``: the
    process group whose ranks hold the other tokens of the batch, over
    which ``f_e`` and ``P_e`` are averaged. ``split``: the expert stacks
    are this rank's share over "model", so the routed tokens and their
    gates take ``sharding.copy_to_model`` (their gradients summed over
    the group; the router and the load-balance loss stay whole)."""
    m = cfg.moe
    probs, gates, idx = route(x, router_w, cfg)
    xe, ge = x, gates
    if split:
        xe, ge = sharding.copy_to_model(x), sharding.copy_to_model(gates)
    y = _dispatch_compute(xe, ge, idx, wg, wu, wd, e0=e0, e_local=e_local,
                          capacity=capacity, dtype=x.dtype)
    # Switch-style load-balance loss: E · Σ_e f_e · P_e
    e = m.n_experts
    onehot = F.one_hot(idx, e).float()                          # (T,k,E)
    f_e = torch.mean(torch.sum(onehot, dim=1), dim=0)
    p_e = torch.mean(probs, dim=0)
    if batch_group is not None:
        n = sharding.group_size(batch_group)
        f_e = sharding.all_reduce_sum(f_e.clone(), batch_group) / n
        p_e = sharding.differentiable_sum(p_e, batch_group) / n
    aux = e * torch.sum(f_e * p_e)
    return y, aux


def capacity_for(tokens: int, cfg) -> int:
    """Slots per expert for ``tokens`` tokens: ceil(T·k/E·capacity_factor),
    in the reference's float arithmetic."""
    m = cfg.moe
    return int(math.ceil(tokens * m.top_k / m.n_experts * m.capacity_factor))


def moe_ffn(params, x, cfg, mesh=None):
    """x: (B, S, d_model), the tokens this rank holds → (y, aux_loss f32).
    Routed plus shared experts. Over a ``mesh`` whose batch axes split the
    batch (``sharding.local_batch``), ``x`` is this rank's rows: they are
    routed at the per-shard capacity and the load-balance terms averaged
    over the batch's ranks; otherwise every rank routes the whole batch.
    Expert stacks split over the ``"model"`` axis ("ep" or "tp", from
    their shapes) give partial outputs, summed over its group."""
    m = cfg.moe
    b, s, d = x.shape
    dtype = x.dtype
    group = None
    entry = sharding.batch_entry()
    if mesh is not None and entry is not None \
            and sharding.entry_size(mesh, entry) > 1:
        group = sharding.entry_group(mesh, entry)
    e_local, _, f_local = params["w_gate"].shape
    ep = sharding.model_split(e_local, m.n_experts, "moe_ffn experts")
    tp = sharding.model_split(f_local, m.d_expert, "moe_ffn d_expert")
    e0 = sharding.model_rank(mesh) * e_local if ep else 0
    y, aux = _moe_local(
        x.reshape(b * s, d), params["router"], params["w_gate"],
        params["w_up"], params["w_down"], cfg, e0=e0, e_local=e_local,
        capacity=capacity_for(b * s, cfg), batch_group=group,
        split=ep or tp)
    y = y.reshape(b, s, d)
    if m.n_shared == 0:
        return (sharding.model_all_reduce(y) if ep or tp else y), aux.float()
    shared = sharding.model_split(params["sw_down"].shape[0],
                                  m.n_shared * m.d_expert, "shared experts")
    xs = sharding.copy_to_model(x) if shared else x
    g = apply_w(xs, params["sw_gate"], dtype)
    u = apply_w(xs, params["sw_up"], dtype)
    ys = apply_w(F.silu(g) * u, params["sw_down"], dtype)
    if (ep or tp) and shared:     # one sum over "model" for both partials
        return sharding.model_all_reduce(y + ys), aux.float()
    if ep or tp:
        y = sharding.model_all_reduce(y)
    elif shared:
        ys = sharding.model_all_reduce(ys)
    return y + ys, aux.float()
