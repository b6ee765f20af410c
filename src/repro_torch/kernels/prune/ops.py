"""Pruning solvers: the single-vector top-κ loop, and the batched
``topk_mask``, ``project_l1_ball`` and ``soft_threshold`` entries of the
dispatch registry.

Port of ``src/repro/kernels/prune/ops.py``. Only the top-κ solvers
launch kernels: each bisection is one launch of the count kernel
(``topk_threshold_batched``, with the batched or the single-vector
rules), then K3 (``mask_apply_batched``) or K9 (``mask_apply``) keeps the
``hi`` class. The ℓ1 solvers are plain tensor programs, as in the JAX
package.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.prune import ref
from repro_torch.kernels.prune.prune import (
    mask_apply, mask_apply_batched, topk_threshold_batched)


def topk_mask(w: torch.Tensor, kappa: int, iters: int = 30) -> torch.Tensor:
    """θ = w · 1[top-κ support] for one tensor of any shape, by threshold
    bisection (one launch of the count kernel with K8's rules, which also
    counts the ``> hi`` class) and the K9 mask.

    The single-vector loop of the JAX package, whose semantics differ
    from the batched one's: strict ``>`` counts; ``lo = 0``, ``hi =
    max|w|``, and a count above κ moves ``lo``; then the ``> hi`` class
    is kept whole and the remaining ``κ − n_hi`` slots are filled from the
    boundary class ``(lo, hi]`` in index order, so exactly min(κ, nnz)
    weights are kept, lower index first on ties. The thresholds are
    computed in float32 as the JAX loop computes them, so the mask is
    bit-identical to its kernel path (``use_pallas=True``). On a CUDA
    tensor the bisection and the mask are the kernels; on a CPU tensor
    their plain versions (``iters + 1`` single counts)."""
    flat = w.reshape(-1).float().contiguous()
    # a fill on the card: a host tensor copied in would sync the stream
    kap = torch.full((1,), kappa, dtype=torch.int32, device=flat.device)
    lo, hi, n_hi = (t[0] for t in topk_threshold_batched(
        flat[None], kap, iters, strict=True))
    a = flat.abs()
    boundary = (a > lo) & (a <= hi)
    fill = torch.cumsum(boundary, dim=0, dtype=torch.int32) <= (kappa - n_hi)
    out = torch.where(boundary & fill, flat, mask_apply(flat, hi))
    return out.reshape(w.shape)


def topk_mask_batched(w: torch.Tensor, kappa: torch.Tensor, iters: int = 30,
                      impl: str = "torch") -> torch.Tensor:
    """Per-item top-κ mask over a packed (I, P) stack; ``kappa`` (I,) is a
    per-item operand, so tasks differing only in κ share one launch.

    ``impl``: ``"torch"`` (stable argsort, :func:`ref.
    topk_mask_batched_ref`) or ``"kernel"``: per-item threshold bisection
    on the feasibility predicate ``count(|w| ≥ t) ≥ κ``, ``iters`` steps
    and the count of the ``|w| ≥ hi`` class in one launch of the count
    kernel, then K3 keeps that class and the boundary class ``[lo, hi)``
    is filled in index order. Both keep exactly
    min(κ_i, P) weights per item with the ``lax.top_k`` tie-break (lower
    index wins); near-ties inside the final unconverged interval are
    filled by index, not magnitude.

    The thresholds are computed in float32 exactly as the JAX driver
    computes them (``hi = 2·max|w| + 1``, ``mid = 0.5·(lo + hi)``), so the
    masks are bit-identical to its ``interpret`` path. ``lo``/``hi`` stay
    on the device: the loop never syncs with the host. Counts are int32,
    exact at any item size (the JAX kernel counts in float32, exact below
    2^24 elements per item).
    """
    w = w.float()
    kappa = kappa.to(torch.int32)
    if impl == "torch":
        return ref.topk_mask_batched_ref(w, kappa)
    if impl != "kernel":
        raise ValueError(f"impl must be 'torch' or 'kernel', got {impl!r}")
    w = w.contiguous()
    # invariant: lo feasible (count(|w| ≥ lo) ≥ κ, true at 0 since κ ≤ P),
    # hi infeasible (strictly above the max magnitude)
    lo, hi, n_hi = topk_threshold_batched(w, kappa, iters)
    # keep the |w| ≥ hi class whole (< κ weights), then fill the remaining
    # κ − n_hi slots from the [lo, hi) boundary class in index order
    a = w.abs()
    boundary = (a >= lo[:, None]) & (a < hi[:, None])
    fill = (torch.cumsum(boundary, dim=-1, dtype=torch.int32)
            <= (kappa - n_hi)[:, None])
    return torch.where(boundary & fill, w,
                       mask_apply_batched(w, hi, strict=False))


def project_l1_ball_batched(w: torch.Tensor,
                            radius: torch.Tensor) -> torch.Tensor:
    """Per-item Euclidean projection onto {θ : ‖θ‖₁ ≤ radius_i} (Duchi et
    al.) over a packed (I, P) stack; rows already inside their ball pass
    through unchanged."""
    w = w.float()
    radius = radius.float()[:, None]                           # (I, 1)
    a = w.abs()
    total = a.sum(dim=-1, keepdim=True)
    u = torch.sort(a, dim=-1, descending=True).values
    cs = torch.cumsum(u, dim=-1)
    r = torch.arange(1, w.shape[-1] + 1, dtype=torch.float32,
                     device=w.device)[None, :]
    cond = u * r > (cs - radius)
    rho = torch.where(cond, r, 0.0).amax(dim=-1, keepdim=True)
    cs_rho = torch.where(r <= rho, u, 0.0).sum(dim=-1, keepdim=True)
    tau = (cs_rho - radius) / torch.clamp_min(rho, 1.0)
    proj = torch.sign(w) * torch.clamp_min(a - tau, 0.0)
    return torch.where(total <= radius, w, proj)


def soft_threshold_batched(w: torch.Tensor, alpha: torch.Tensor,
                           mu) -> torch.Tensor:
    """Per-item ℓ1-penalty prox θ = sign(w)·max(|w| − α_i/μ, 0) over a
    packed (I, P) stack; α is an (I,) operand (mixed-α grouping)."""
    w = w.float()
    t = (alpha.float() / mu)[:, None]
    return torch.sign(w) * torch.clamp_min(w.abs() - t, 0.0)
