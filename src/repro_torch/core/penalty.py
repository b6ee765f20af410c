"""The LC quadratic penalty of the L step.

Port of ``src/repro/core/penalty.py``:

    P(w; a, λ, μ) = Σ_leaves  μ/2 · ‖w − a − λ/μ‖²,   a = Δ(Θ)

Its gradient with respect to w is μ(w − a) − λ; autograd takes it.
"""
from __future__ import annotations

import torch

from repro_torch.core.tasks import get_path


def lc_penalty(params, lc_state, tasks) -> torch.Tensor:
    """Total penalty over all compression tasks (f32 0-d tensor)."""
    mu = lc_state["mu"]
    total = torch.zeros((), dtype=torch.float32, device=mu.device)
    for t in tasks:
        ts = lc_state["tasks"][t.name]
        for p in t.paths:
            d = get_path(params, p).float() - ts["a"][p] - ts["lam"][p] / mu
            total = total + 0.5 * mu * torch.sum(d * d)
    return total


def lc_penalty_grad_refs(lc_state, tasks):
    """(a, λ) keyed by param path — for custom L steps."""
    refs = {}
    for t in tasks:
        ts = lc_state["tasks"][t.name]
        for p in t.paths:
            refs[p] = (ts["a"][p], ts["lam"][p])
    return refs
