"""Carry weights and LC state between numpy and the port, and pick devices.

The JAX package hands its arrays over as numpy
(``jax.tree_util.tree_map(np.asarray, tree)``); these functions put them
on a torch device and back, so both packages can compute from the same
inputs. Θ NamedTuples are matched by their field names (a JAX
``QuantTheta`` becomes the port's ``QuantTheta``), dicts stay dicts.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.tree import tree_map


def resolve_device(device=None) -> torch.device:
    """``None`` means the card. Raises when CUDA is asked for and absent:
    nothing falls back to the CPU unless the caller asks for it."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available: repro_torch runs on the GPU by "
                "default; pass device='cpu' to run on the CPU")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def _to_tensor(x, device) -> torch.Tensor:
    return torch.from_numpy(np.array(x, copy=True)).to(device)


def params_from_numpy(tree, device) -> dict:
    """Nested dict of numpy arrays → same tree of tensors on ``device``:
    any model's params (the MoE router, stacked experts and shared
    experts, MLA's projections and ``q_norm``/``kv_norm`` included) and
    any cache tree (MLA's ``{"ckv", "k_rope"}`` latents included), which
    are dicts of arrays in both packages."""
    return tree_map(lambda x: _to_tensor(x, device), tree)


def to_numpy(tree):
    """Tree of tensors → same tree of numpy arrays (NamedTuples keep their
    class; 0-d tensors become 0-d arrays)."""
    return tree_map(lambda t: t.detach().cpu().numpy()
                    if isinstance(t, torch.Tensor) else t, tree)


def _theta_from_numpy(theta, device):
    """A Θ tree as numpy → the port's Θ on ``device``: quantization
    ``QuantTheta`` (also nested, as in an additive ``{"parts": [...]}``),
    pruning ``{"theta"}``, low-rank ``{"u", "v"[, "rank"]}`` (the rank a
    0-d integer)."""
    from repro_torch.core.schemes.quantize import QuantTheta
    if isinstance(theta, tuple) and getattr(theta, "_fields", None) == \
            QuantTheta._fields:
        return QuantTheta(*(_to_tensor(x, device) for x in theta))
    if isinstance(theta, dict):
        return {k: _theta_from_numpy(v, device) for k, v in theta.items()}
    if isinstance(theta, (list, tuple)):
        return type(theta)(_theta_from_numpy(v, device) for v in theta)
    return _to_tensor(theta, device)


_FORM_FIELDS = {
    "QuantizedWeight": ("packed", "codebook"),
    "LowRankWeight": ("u", "vt"),
    "SparseWeight": ("values", "rows", "cols"),
}


def serving_params_from_numpy(tree, device):
    """A serving tree from the JAX package, its arrays turned to numpy
    (``jax.tree_util.tree_map(np.asarray, tree)``: the weight-form
    objects keep their class and hold numpy fields) → the same tree with
    the port's ``QuantizedWeight``/``LowRankWeight``/``SparseWeight`` on
    ``device``. Forms are matched by class name and field names, so
    nothing of the JAX package is imported."""
    from repro_torch.runtime import compressed as cforms
    if isinstance(tree, dict):
        return {k: serving_params_from_numpy(v, device)
                for k, v in tree.items()}
    name = type(tree).__name__
    if name in _FORM_FIELDS:
        arrays = [_to_tensor(getattr(tree, f), device)
                  for f in _FORM_FIELDS[name]]
        if name == "QuantizedWeight":
            return cforms.QuantizedWeight(*arrays, tree.shape, tree.bits)
        if name == "SparseWeight":
            return cforms.SparseWeight(*arrays, tree.shape)
        return cforms.LowRankWeight(*arrays)
    return _to_tensor(tree, device)


def lc_state_from_numpy(state: dict, device) -> dict:
    """An LC state as numpy (``{"tasks": {name: {"theta", "lam", "a"}},
    "mu", "k"}``) → the port's LC state on ``device``."""
    tasks = {
        name: {"theta": _theta_from_numpy(ts["theta"], device),
               "lam": params_from_numpy(ts["lam"], device),
               "a": params_from_numpy(ts["a"], device)}
        for name, ts in state["tasks"].items()}
    return {"tasks": tasks,
            "mu": torch.tensor(float(state["mu"]), dtype=torch.float32,
                               device=device),
            "k": torch.tensor(int(state["k"]), dtype=torch.int32,
                              device=device)}


def train_state_from_numpy(state: dict, device) -> dict:
    """A train state as numpy (``{"params", "opt": {"m", "v", "step"},
    "step", "lc": {"a", "lam", "mu"}}``, the JAX package's
    ``init_train_state`` through ``jax.tree_util.tree_map(np.asarray,
    ·)``) → the same tree of tensors on ``device``: params, AdamW
    moments and LC refs as they were, the step counters 0-d int32."""
    return params_from_numpy(state, device)


def train_state_to_numpy(state: dict) -> dict:
    """The inverse of :func:`train_state_from_numpy`."""
    return to_numpy(state)
