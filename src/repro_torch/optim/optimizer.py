"""Optimizers over trees of tensors.

Port of ``src/repro/optim/optimizer.py``: AdamW for LM pretraining, SGD
with (Nesterov) momentum for the paper's L steps. States are float32
trees with the structure of the params (``{"m", "v", "step"}`` and
``{"mom", "step"}``), the step a 0-d int32 tensor. ``update`` is
functional, as the reference's: it returns new params and a new state
and leaves its inputs as they were, so a state handed to a step that
fails can be stepped again.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from repro_torch.distributed import sharding
from repro_torch.tree import tree_leaves, tree_map


def _zeros(p: torch.Tensor) -> torch.Tensor:
    return torch.zeros(p.shape, dtype=torch.float32, device=p.device)


def _step0(params) -> torch.Tensor:
    dev = tree_leaves(params)[0].device
    return torch.zeros((), dtype=torch.int32, device=dev)


@dataclass(frozen=True)
class AdamW:
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.0

    def init(self, params):
        return {"m": tree_map(_zeros, params), "v": tree_map(_zeros, params),
                "step": _step0(params)}

    @torch.no_grad()
    def update(self, grads, state, params, lr):
        step = state["step"] + 1
        t = step.float()
        c1 = 1.0 - torch.pow(self.b1, t)
        c2 = 1.0 - torch.pow(self.b2, t)
        m = tree_map(lambda m_, g: self.b1 * m_ + (1 - self.b1) * g.float(),
                     state["m"], grads)
        v = tree_map(lambda v_, g: self.b2 * v_
                     + (1 - self.b2) * torch.square(g.float()),
                     state["v"], grads)
        new_params = tree_map(
            lambda p, m_, v_: (p.float()
                               - lr * ((m_ / c1)
                                       / (torch.sqrt(v_ / c2) + self.eps)
                                       + self.weight_decay * p.float())
                               ).to(p.dtype),
            params, m, v)
        return new_params, {"m": m, "v": v, "step": step}


@dataclass(frozen=True)
class SGDM:
    """SGD + (Nesterov) momentum — the paper's L-step optimizer."""
    momentum: float = 0.9
    nesterov: bool = True

    def init(self, params):
        return {"mom": tree_map(_zeros, params), "step": _step0(params)}

    @torch.no_grad()
    def update(self, grads, state, params, lr):
        mom = tree_map(lambda b, g: self.momentum * b + g.float(),
                       state["mom"], grads)
        if self.nesterov:
            upd = tree_map(lambda g, b: g.float() + self.momentum * b,
                           grads, mom)
        else:
            upd = mom
        new_params = tree_map(lambda p, u: (p.float() - lr * u).to(p.dtype),
                              params, upd)
        return new_params, {"mom": mom, "step": state["step"] + 1}


@torch.no_grad()
def global_norm(tree, group=None, layout=None) -> torch.Tensor:
    """√(Σ‖leaf‖²) in float32, summed leaf by leaf in tree order.

    Over a tensor-parallel ``"model"`` ``group`` (``None``: the tree is
    whole here), ``layout`` gives each leaf's place in the tree's
    structure (``sharding.param_layout``): ``"split"`` leaves' squares
    are summed over the group, a leaf held by ``k`` ranks counts ``1/k``
    on each, and ``"whole"`` leaves count once: the norm of the whole
    tree, the same on every rank."""
    leaves = tree_leaves(tree)
    total = torch.zeros((), dtype=torch.float32, device=leaves[0].device)
    if group is None:
        for leaf in leaves:
            total = total + torch.sum(torch.square(leaf.float()))
        return torch.sqrt(total)
    shared = torch.zeros_like(total)
    for leaf, where in zip(leaves, tree_leaves(tree_map(
            lambda _, f: f, tree, layout))):
        sq = torch.sum(torch.square(leaf.float()))
        if where == "whole":
            total = total + sq
        elif where == "split":
            shared = shared + sq
        else:
            shared = shared + sq / where
    return torch.sqrt(sharding.model_reduce(shared, group) + total)


@torch.no_grad()
def clip_by_global_norm(tree, max_norm: float, group=None, layout=None):
    """(tree scaled so its global norm is at most ``max_norm``, norm);
    ``group`` and ``layout`` as :func:`global_norm` takes them."""
    n = global_norm(tree, group, layout)
    # tensor / tensor: a Python number over a tensor would multiply by
    # a rounded reciprocal
    scale = torch.clamp_max(
        torch.full_like(n, max_norm) / torch.clamp_min(n, 1e-9), 1.0)
    return tree_map(lambda l: l * scale.to(l.dtype), tree), n
