"""Plain PyTorch versions for the ℓ0-pruning kernels and solvers: the
threshold counts (K2, K8), the top-κ bisection in one launch, the
threshold masks (K3, K9) and the sort-based top-κ mask (the ``torch``
backend of the ``topk_mask`` solver)."""
from __future__ import annotations

import torch


def count_above_batched_plain(w: torch.Tensor, t: torch.Tensor,
                              strict: bool = True) -> torch.Tensor:
    """w (I, P) f32, t (I,) f32 → (I,) i32 count of |w| > t_i
    (``strict=False``: |w| ≥ t_i)."""
    a = w.abs()
    keep = a > t[:, None] if strict else a >= t[:, None]
    return keep.sum(-1, dtype=torch.int32)


def count_above_plain(w: torch.Tensor, t) -> torch.Tensor:
    """w (P,) f32, t 0-d → 0-d i32 count of |w| > t."""
    return (w.abs() > t).sum(dtype=torch.int32)


def topk_threshold_batched_plain(w: torch.Tensor, kappa: torch.Tensor,
                                 iters: int = 30, strict: bool = False):
    """w (I, P) f32, κ (I,) i32 → (lo (I,) f32, hi (I,) f32, n_hi (I,) i32):
    the loop of ``iters + 1`` single counts that the fused bisection runs.
    ``strict=False``: ``hi = 2·max|w| + 1``, ``lo = mid`` where
    ``count(|w| ≥ mid) ≥ κ``, ``n_hi = count(|w| ≥ hi)``; ``strict=True``
    (the single-vector rules): ``hi = max|w|``, counts of ``|w| > t``, and
    ``lo = mid`` where the count exceeds κ. Each count is a call of
    :func:`count_above_batched_plain`."""
    a_max = w.abs().amax(dim=-1)
    hi = a_max if strict else a_max * 2.0 + 1.0
    lo = torch.zeros_like(hi)
    for _ in range(iters):
        mid = 0.5 * (lo + hi)
        n = count_above_batched_plain(w, mid, strict)
        move = n > kappa if strict else n >= kappa
        lo = torch.where(move, mid, lo)
        hi = torch.where(move, hi, mid)
    return lo, hi, count_above_batched_plain(w, hi, strict)


def mask_apply_batched_plain(w: torch.Tensor, t: torch.Tensor,
                             strict: bool = True) -> torch.Tensor:
    """w (I, P) f32, t (I,) f32 → w·1[|w| > t_i] (``strict=False``:
    |w| ≥ t_i)."""
    a = w.abs()
    keep = a > t[:, None] if strict else a >= t[:, None]
    return torch.where(keep, w, 0.0)


def mask_apply_plain(w: torch.Tensor, t) -> torch.Tensor:
    """w (P,) f32, t 0-d → w·1[|w| > t]."""
    return torch.where(w.abs() > t, w, 0.0)


def topk_mask_batched_ref(w: torch.Tensor,
                          kappa: torch.Tensor) -> torch.Tensor:
    """Per-item top-κ mask with κ an (I,) operand.

    A stable argsort by descending magnitude ranks ties by ascending
    index — the ``lax.top_k`` order of the JAX package (``torch.topk``
    and a default ``argsort`` promise no order on ties). Keeps exactly
    min(κ_i, P) weights per item.
    """
    a = w.float().abs()
    order = torch.argsort(-a, dim=-1, stable=True)
    rank = torch.argsort(order, dim=-1)                # inverse permutation
    keep = rank < kappa.to(torch.int64)[:, None]
    return torch.where(keep, w, 0.0)
