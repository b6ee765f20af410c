"""Exact-SVD oracles for the batched low-rank solvers.

Port of ``src/repro/kernels/lowrank/ref.py`` on ``torch.linalg.svd``
(LAPACK on the CPU, cuSOLVER on the card): for tests and checks only —
the dispatch path never calls these."""
from __future__ import annotations

import torch


def svd_topr_batched_ref(w: torch.Tensor, r: int):
    """Exact per-item SVD truncated to rank r: ``w`` (I, m, n) →
    (u (I, m, r), s (I, r), v (I, n, r))."""
    u, s, vh = torch.linalg.svd(w.float(), full_matrices=False)
    return u[:, :, :r], s[:, :r], vh[:, :r, :].transpose(1, 2)


def tail_distortion_ref(w: torch.Tensor, r) -> torch.Tensor:
    """Per-item optimal rank-r distortion Σ_{i>r} σ_i² (exact SVD):
    ``w`` (I, m, n), ``r`` (I,) int → (I,) f32 — the Eckart–Young bound
    any rank-r factorization's ‖w − UVᵀ‖² is compared to."""
    s = torch.linalg.svdvals(w.float())
    r = torch.as_tensor(r, device=s.device).reshape(-1, 1)
    mask = torch.arange(s.shape[-1], device=s.device)[None, :] >= r
    return torch.sum(torch.where(mask, s * s, 0.0), dim=-1)
