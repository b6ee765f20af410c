"""Step functions: the LC train step and the serve (decode/prefill) steps.

Port of ``src/repro/launch/steps.py``. ``make_train_step`` builds the
paper's L-step inner update: model loss + LC quadratic penalty
(μ/2‖w − a − λ/μ‖² over the compressed parameters) → gradients
(``torch.autograd.grad``) → clip → optimizer. ``a = Δ(Θ)`` and the
multipliers ``λ`` ride in the train state beside the params:

    {"params", "opt", "step" (0-d int32), "lc": {"a", "lam", "mu"}}

The step is functional, as the reference's jitted one: it returns a new
state and writes nothing of the state it is given.

Under an active mesh (``distributed.sharding.use_mesh``) whose batch
axes divide the global batch (the "batch" rule), the step is
data-parallel: every rank is handed the whole global batch and takes the
rows of its data coordinate; the loss is the global mean, each rank's
token sum over the global token count (the MoE load-balance terms
averaged over the ranks, ``models/moe.py``); the gradients are summed
over the batch's ranks with one ``all_reduce`` per dtype before clipping
and AdamW. Where no batch axis divides the batch, every rank runs the
whole step, as without a mesh.

Over a ``"model"`` axis above 1 the step takes this rank's tree of
``sharding.shard_params`` (and the LC refs ``a``, λ as slices of the same
split): every model rank computes the whole loss of its rows, the layers
sum their partial products and their inputs' gradients over the
``"model"`` group (the convention of ``distributed/sharding.py``), the
LC penalty is summed over the rank's slices, the global norm counts each
weight once (``sharding.param_layout``), and AdamW runs on the shards.
The reported ``loss``, ``ce``, ``lc_penalty`` and ``grad_norm`` are the
whole model's, the same on every rank. Parameters, optimizer state, λ,
``a`` and μ are not FSDP-sharded over "embed" as in the reference (the
same values, more memory).
"""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch.core.tasks import flatten_params, get_path
from repro_torch.distributed import sharding
from repro_torch.models.layers import unembed
from repro_torch.models.transformer import (
    chunked_nll, decode_step, forward_hidden, init_params, loss_fn)
from repro_torch.optim import AdamW, clip_by_global_norm
from repro_torch.tree import tree_leaves, tree_map


def lc_param_paths(params) -> list[str]:
    """The compressed set: every parameter with ndim ≥ 2 (matrices and
    stacked matrices; norms/biases stay uncompressed, per paper practice)."""
    flat = flatten_params(params)
    return [p for p, l in flat.items() if getattr(l, "ndim", 0) >= 2]


def _penalty_terms(params, a: dict, lam: dict, mu: torch.Tensor):
    """(path, μ/2‖w − a − λ/μ‖²) of each ref, differentiable in w."""
    for p, a_leaf in a.items():
        w = get_path(params, p).float()
        d = w - a_leaf - lam[p] / mu
        yield p, 0.5 * mu * torch.sum(d * d)


def _sum_terms(terms, device) -> torch.Tensor:
    total = torch.zeros((), dtype=torch.float32, device=device)
    for _, term in terms:
        total = total + term
    return total


def lc_penalty_from_refs(params, a: dict, lam: dict,
                         mu: torch.Tensor) -> torch.Tensor:
    """Σ μ/2‖w − a − λ/μ‖² over the refs' paths, differentiable in the
    params (unlike ``LCAlgorithm.penalty``, a monitor under no_grad)."""
    return _sum_terms(_penalty_terms(params, a, lam, mu), mu.device)


def init_lc_refs(params, paths: list[str]) -> dict:
    """Direct-compression placeholder: a = w (zero penalty at start),
    λ = 0. The LC driver overwrites ``a`` after each real C step."""
    a = {p: get_path(params, p).detach().float().clone() for p in paths}
    lam = {p: torch.zeros_like(v) for p, v in a.items()}
    dev = next(iter(a.values())).device
    return {"a": a, "lam": lam,
            "mu": torch.tensor(1e-4, dtype=torch.float32, device=dev)}


def stable_lc_refs(new_refs: dict, old_refs: dict) -> dict:
    """Fresh Δ(Θ)/λ refs laid onto the refs they replace
    (``sharding.match_shardings``: each new ref on its old ref's device
    and dtype; the refs are replicated). μ is the caller's business (it
    advances at the L-step start, not at the swap), so it is carried from
    ``old_refs`` untouched."""
    return {"a": sharding.match_shardings(
                new_refs["a"], {p: old_refs["a"][p] for p in new_refs["a"]}),
            "lam": sharding.match_shardings(
                new_refs["lam"],
                {p: old_refs["lam"][p] for p in new_refs["lam"]}),
            "mu": old_refs["mu"]}


def _shard_loss(params, batch, cfg, group, n: int):
    """A rank's part of the global loss over its rows: its token NLL sum
    over the global token count, plus 1/n of the MoE load-balance loss
    (averaged over the ranks inside ``moe_ffn``), so that the ranks'
    parts sum to the global loss and their gradients to its gradient.
    The metrics are the global values."""
    hidden, aux = forward_hidden(params, batch["inputs"], cfg)
    nll, count = chunked_nll(params, hidden, batch["labels"], cfg,
                             mask=batch.get("mask"))
    total = sharding.all_reduce_sum(count.detach().clone(), group)
    part = nll / torch.clamp_min(total, 1.0)
    ce = sharding.all_reduce_sum(part.detach().clone(), group)
    loss = part
    if cfg.moe is not None:
        loss = loss + cfg.moe.router_aux_weight * aux / n
    return loss, {"ce": ce, "aux": aux}


def _sum_grads(grads: list, group) -> list:
    """The gradients summed over ``group``: one ``all_reduce`` of a flat
    buffer per dtype."""
    out = list(grads)
    for dtype in dict.fromkeys(g.dtype for g in grads):
        idx = [i for i, g in enumerate(grads) if g.dtype == dtype]
        flat = torch.cat([grads[i].reshape(-1) for i in idx])
        sharding.all_reduce_sum(flat, group)
        for i, piece in zip(idx, torch.split(
                flat, [grads[i].numel() for i in idx])):
            out[i] = piece.view_as(grads[i])
    return out


class _ModelAxis:
    """The ``"model"`` group of a mesh whose ``"model"`` axis is above 1,
    and each leaf's layout on this rank (``sharding.param_layout``)."""

    def __init__(self, cfg, mesh, rules):
        self.group = sharding.entry_group(mesh, "model")
        self.layout = sharding.param_layout(cfg, mesh, rules)
        self.flat = flatten_params(self.layout)

    def penalty(self, terms, like: torch.Tensor) -> torch.Tensor:
        """The whole tree's penalty from this rank's terms: split leaves
        summed over the group, a leaf held by k ranks at 1/k on each,
        whole leaves once (a 0-d tensor like ``like``)."""
        whole = torch.zeros_like(like)
        shared = torch.zeros_like(whole)
        for p, t in terms:
            where = self.flat[p]
            if where == "whole":
                whole = whole + t
            else:
                shared = shared + (t if where == "split" else t / where)
        return sharding.model_reduce(shared, self.group) + whole


def make_value_and_grad(cfg, with_lc: bool = True):
    """``value_and_grad(state, batch) -> (loss, metrics, grads)``: the
    train step's loss (model loss plus the LC penalty) and its gradients
    with respect to ``state["params"]`` (this rank's shards under a
    ``"model"`` axis above 1, summed over the batch's ranks), before
    clipping. ``loss`` and the metrics are the global values, the same
    on every rank. Its ``model_axis(mesh)`` gives the ``"model"`` group
    and the leaves' layout for the clip (``None`` at ``"model"`` 1)."""
    axes: dict = {}

    def model_axis(mesh):
        if sharding.model_size(mesh) == 1:
            return None
        if axes.get("mesh") is not mesh:
            axes["mesh"], axes["axis"] = mesh, _ModelAxis(
                cfg, mesh, sharding.active_rules())
        return axes["axis"]

    def value_and_grad(state, batch):
        params = tree_map(lambda t: t.detach().requires_grad_(True),
                          state["params"])
        leaves = tree_leaves(params)
        mesh = sharding.active_mesh()
        tp = model_axis(mesh)
        split = (None if mesh is None else sharding.batch_shard(
            batch["labels"].shape[0], mesh, sharding.active_rules()))
        group, n, entry = None, 1, None
        if split is not None:
            entry, lo, hi = split
            batch = {k: v[lo:hi] for k, v in batch.items()}
            group = sharding.entry_group(mesh, entry)
            n = sharding.entry_size(mesh, entry)
        with torch.enable_grad(), sharding.local_batch(entry):
            if group is None:
                loss, metrics = loss_fn(params, batch, cfg)
            else:
                loss, metrics = _shard_loss(params, batch, cfg, group, n)
            base = loss
            if with_lc:
                lc = state["lc"]
                terms = list(_penalty_terms(params, lc["a"], lc["lam"],
                                            lc["mu"]))
                pen = _sum_terms(terms, lc["mu"].device)
                # under "model" each rank's penalty is its slices' (their
                # gradients); the metric is the whole tree's
                shown = pen if tp is None else tp.penalty(
                    [(p, t.detach()) for p, t in terms], pen.detach())
                metrics = dict(metrics, lc_penalty=shown)
                # every rank holds the penalty whole: its n parts sum
                # to it
                loss = loss + (pen if group is None else pen / n)
            grads = torch.autograd.grad(loss, leaves)
        if group is not None:
            grads = _sum_grads(grads, group)
            loss = sharding.all_reduce_sum(loss.detach().clone(), group)
        if tp is not None and with_lc:
            if group is not None:
                base = sharding.all_reduce_sum(base.detach().clone(), group)
            loss = base.detach() + metrics["lc_penalty"]
        grads = iter(grads)
        grads = tree_map(lambda _: next(grads), params)
        metrics = {k: v.detach() for k, v in metrics.items()}
        return loss.detach(), metrics, grads

    value_and_grad.model_axis = model_axis
    return value_and_grad


def make_train_step(cfg, optimizer: AdamW | None = None,
                    lr: float | Callable = 3e-4,
                    clip_norm: float = 1.0,
                    with_lc: bool = True):
    optimizer = optimizer or AdamW()
    lr_fn = lr if callable(lr) else (lambda step: lr)
    value_and_grad = make_value_and_grad(cfg, with_lc)

    def train_step(state, batch):
        loss, metrics, grads = value_and_grad(state, batch)
        tp = value_and_grad.model_axis(sharding.active_mesh())
        group, layout = (None, None) if tp is None else (tp.group,
                                                         tp.layout)
        grads, gnorm = clip_by_global_norm(grads, clip_norm, group, layout)
        new_params, opt_state = optimizer.update(
            grads, state["opt"], state["params"], lr_fn(state["step"]))
        new_state = dict(state, params=new_params, opt=opt_state,
                         step=state["step"] + 1)
        return new_state, dict(metrics, loss=loss, grad_norm=gnorm)

    return train_step


def init_train_state(gen: torch.Generator, cfg,
                     optimizer: AdamW | None = None,
                     with_lc: bool = True) -> dict:
    """Random params from ``gen`` (on its device), fresh optimizer state,
    step 0 and, ``with_lc``, placeholder LC refs."""
    optimizer = optimizer or AdamW()
    params = init_params(gen, cfg)
    state = {"params": params, "opt": optimizer.init(params),
             "step": torch.zeros((), dtype=torch.int32, device=gen.device)}
    if with_lc:
        state["lc"] = init_lc_refs(params, lc_param_paths(params))
    return state


def make_serve_step(cfg):
    def serve_step(params, cache, inputs, pos):
        return decode_step(params, cache, inputs, pos, cfg)
    return serve_step


def make_prefill_step(cfg):
    def prefill_step(params, inputs):
        hidden, _ = forward_hidden(params, inputs, cfg)
        return unembed(params["embed"], hidden[:, -1:], cfg)

    return prefill_step
