"""Serving op for pruned-sparse weights.

Port of ``src/repro/kernels/prune/serve.py``. A pruned weight W (K, N)
keeps its nnz survivors in COO form (values, rows, cols); the product
gathers the x columns the survivors read, scales them, and adds them
into their output columns (``index_add_``). The indices stay int32, as
the reference stores them: ``index_select`` and ``index_add_`` take
int32 indices. The gathered (..., nnz) product is transient; at prefill
(x with M rows) it holds M·nnz floats.
"""
from __future__ import annotations

import torch


def sparse_matmul(x: torch.Tensor, values: torch.Tensor, rows: torch.Tensor,
                  cols: torch.Tensor, n_cols: int) -> torch.Tensor:
    """y = x @ W for W given in COO form.

    x: (..., K); values: (nnz,); rows/cols: (nnz,) int32 with
    W[rows[i], cols[i]] = values[i]; n_cols = N → y: (..., N)."""
    contrib = torch.index_select(x, -1, rows)            # (..., nnz)
    contrib.mul_(values.to(x.dtype))
    out = x.new_zeros((*x.shape[:-1], n_cols))
    return out.index_add_(-1, cols, contrib)


def densify(values: torch.Tensor, rows: torch.Tensor, cols: torch.Tensor,
            shape: tuple[int, int]) -> torch.Tensor:
    """Dense W from COO triplets (parity checks and the dense fallback)."""
    w = values.new_zeros(tuple(shape))
    w[rows.long(), cols.long()] = values
    return w
