"""Serving op for low-rank-factored weights.

Port of ``src/repro/kernels/lowrank/serve.py``. A weight W (K, N) of
rank r is stored as factors U (K, r), Vᵀ (r, N); streaming the factors
costs r·(K+N) weight reads instead of K·N. Two thin chained matrix
products, with no kernel of their own: the contraction order is the
point, and W is never materialized.
"""
from __future__ import annotations

import torch


def lowrank_matmul(x: torch.Tensor, u: torch.Tensor,
                   vt: torch.Tensor) -> torch.Tensor:
    """y = x @ (u @ vt) computed as (x @ u) @ vt.
    x: (..., K); u: (K, r); vt: (r, N) → y: (..., N)."""
    h = x @ u.to(x.dtype)
    return h @ vt.to(x.dtype)


def materialize_lowrank(u: torch.Tensor, vt: torch.Tensor) -> torch.Tensor:
    """Dense W = u @ vt, for parity checks and non-matmul uses."""
    return u @ vt
