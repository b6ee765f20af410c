"""Step functions: the LC train step and the serve (decode/prefill) steps.

Port of ``src/repro/launch/steps.py``. ``make_train_step`` builds the
paper's L-step inner update: model loss + LC quadratic penalty
(μ/2‖w − a − λ/μ‖² over the compressed parameters) → gradients
(``torch.autograd.grad``) → clip → optimizer. ``a = Δ(Θ)`` and the
multipliers ``λ`` ride in the train state beside the params:

    {"params", "opt", "step" (0-d int32), "lc": {"a", "lam", "mu"}}

The step is functional, as the reference's jitted one: it returns a new
state and writes nothing of the state it is given.
"""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch.core.tasks import flatten_params, get_path
from repro_torch.models.layers import unembed
from repro_torch.models.transformer import (
    decode_step, forward_hidden, init_params, loss_fn)
from repro_torch.optim import AdamW, clip_by_global_norm
from repro_torch.tree import tree_leaves, tree_map


def lc_param_paths(params) -> list[str]:
    """The compressed set: every parameter with ndim ≥ 2 (matrices and
    stacked matrices; norms/biases stay uncompressed, per paper practice)."""
    flat = flatten_params(params)
    return [p for p, l in flat.items() if getattr(l, "ndim", 0) >= 2]


def lc_penalty_from_refs(params, a: dict, lam: dict,
                         mu: torch.Tensor) -> torch.Tensor:
    """Σ μ/2‖w − a − λ/μ‖² over the refs' paths, differentiable in the
    params (unlike ``LCAlgorithm.penalty``, a monitor under no_grad)."""
    total = torch.zeros((), dtype=torch.float32, device=mu.device)
    for p, a_leaf in a.items():
        w = get_path(params, p).float()
        d = w - a_leaf - lam[p] / mu
        total = total + 0.5 * mu * torch.sum(d * d)
    return total


def init_lc_refs(params, paths: list[str]) -> dict:
    """Direct-compression placeholder: a = w (zero penalty at start),
    λ = 0. The LC driver overwrites ``a`` after each real C step."""
    a = {p: get_path(params, p).detach().float().clone() for p in paths}
    lam = {p: torch.zeros_like(v) for p, v in a.items()}
    dev = next(iter(a.values())).device
    return {"a": a, "lam": lam,
            "mu": torch.tensor(1e-4, dtype=torch.float32, device=dev)}


def stable_lc_refs(new_refs: dict, old_refs: dict) -> dict:
    """Fresh Δ(Θ)/λ refs laid onto the refs they replace: each new ref on
    its old ref's device and dtype (there is no sharding to match). μ is
    the caller's business (it advances at the L-step start, not at the
    swap), so it is carried from ``old_refs`` untouched."""
    def like(new, old):
        return new.to(device=old.device, dtype=old.dtype)
    return {"a": {p: like(v, old_refs["a"][p])
                  for p, v in new_refs["a"].items()},
            "lam": {p: like(v, old_refs["lam"][p])
                    for p, v in new_refs["lam"].items()},
            "mu": old_refs["mu"]}


def make_train_step(cfg, optimizer: AdamW | None = None,
                    lr: float | Callable = 3e-4,
                    clip_norm: float = 1.0,
                    with_lc: bool = True):
    optimizer = optimizer or AdamW()
    lr_fn = lr if callable(lr) else (lambda step: lr)

    def train_step(state, batch):
        params = tree_map(lambda t: t.detach().requires_grad_(True),
                          state["params"])
        leaves = tree_leaves(params)
        with torch.enable_grad():
            loss, metrics = loss_fn(params, batch, cfg)
            if with_lc:
                lc = state["lc"]
                pen = lc_penalty_from_refs(params, lc["a"], lc["lam"],
                                           lc["mu"])
                metrics = dict(metrics, lc_penalty=pen)
                loss = loss + pen
            grads = iter(torch.autograd.grad(loss, leaves))
        grads = tree_map(lambda _: next(grads), params)
        grads, gnorm = clip_by_global_norm(grads, clip_norm)
        new_params, opt_state = optimizer.update(
            grads, state["opt"], state["params"], lr_fn(state["step"]))
        new_state = dict(state, params=new_params, opt=opt_state,
                         step=state["step"] + 1)
        metrics = {k: v.detach() for k, v in
                   dict(metrics, loss=loss, grad_norm=gnorm).items()}
        return new_state, metrics

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
