"""Plain PyTorch versions for the ℓ0-pruning solvers: the threshold
count of kernel K2 and the sort-based top-κ mask (the ``torch`` backend
of the ``topk_mask`` solver)."""
from __future__ import annotations

import torch


def count_above_batched_plain(w: torch.Tensor, t: torch.Tensor,
                              strict: bool = True) -> torch.Tensor:
    """w (I, P) f32, t (I,) f32 → (I,) i32 count of |w| > t_i
    (``strict=False``: |w| ≥ t_i)."""
    a = w.abs()
    keep = a > t[:, None] if strict else a >= t[:, None]
    return keep.sum(-1, dtype=torch.int32)


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
