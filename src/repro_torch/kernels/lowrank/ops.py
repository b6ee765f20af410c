"""Batched low-rank C-step solvers: the ``lowrank_rsvd`` and
``rank_select`` entries of the dispatch registry.

Port of ``src/repro/kernels/lowrank/ops.py``. Both consume a packed
``(items, m, n)`` group in one call, with the per-task hyperparameters
(target rank, α) and the per-item sketch seeds as per-item operands, so
tasks that differ only in rank or α share one group and one solver
call. Factors come back padded to the group-level ``r_max`` (the widest
member's target) with columns at or past each item's own rank exactly
zero, so the packed decompress and the per-task slices are both right.
Matmul-only (``lowrank.py``): there is no kernel of their own, in either
package.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.lowrank.lowrank import rsvd_spectrum_batched

#: sketch oversampling beyond r_max: the C step's budget (distortion
#: within 1e-4 relative of the exact SVD) needs the sketch to separate
#: the top-R subspace from a possibly near-flat bulk
OVERSAMPLE = 16
#: power (subspace) iterations — sharpens flat spectra
POWER_ITERS = 3


def _scaled_masked_factors(u, s, v, rank, r_max):
    """(U·√s, V·√s) truncated to r_max with columns ≥ rank_i zeroed."""
    u, s, v = u[:, :, :r_max], s[:, :r_max], v[:, :, :r_max]
    mask = (torch.arange(r_max, device=s.device)[None, :]
            < rank.to(device=s.device, dtype=torch.int32)[:, None])
    rs = torch.sqrt(torch.clamp_min(s, 0.0) * mask)
    return u * rs[:, None, :], v * rs[:, None, :]


def _warm_iters(power_iters: int) -> int:
    """Warm-started sketches need one subspace refinement less: the seed
    basis already spans (most of) the previous top-R subspace. Only one
    less — a single warm iteration leaves steep spectra half-converged
    (the reference's measurement)."""
    return max(1, power_iters - 1)


def lowrank_rsvd_batched(w: torch.Tensor, rank: torch.Tensor,
                         keys: torch.Tensor, *, r_max: int,
                         oversample: int = OVERSAMPLE,
                         power_iters: int = POWER_ITERS,
                         orth: str = "jacobi",
                         u0: torch.Tensor | None = None):
    """Batched rank-R truncated SVD over a packed item stack.

    ``w``: (I, m, n) f32; ``rank``: (I,) i32 per-item target ranks;
    ``keys``: (I,) int64 per-item sketch seeds; ``r_max``: the group's
    factor width. Returns ``(u (I, m, r_max), v (I, n, r_max))`` scaled
    by √s and masked to each item's rank: Θ = (U√s, V√s) as
    ``LowRank.compress`` lays it out. ``u0`` (optional, (I, m, r))
    warm-starts the range finder with the previous Θ's U factor and
    drops one power iteration (:func:`_warm_iters`)."""
    n_items, m, n = w.shape
    k = min(r_max + oversample, m, n)
    iters = power_iters if u0 is None else _warm_iters(power_iters)
    u, s, v = rsvd_spectrum_batched(w.float(), keys, k, power_iters=iters,
                                    orth=orth, q0=u0)
    return _scaled_masked_factors(u, s, v, rank, r_max)


def rank_select_batched(w: torch.Tensor, alpha: torch.Tensor,
                        keys: torch.Tensor, mu, *, r_max: int,
                        cost: str = "storage",
                        oversample: int = OVERSAMPLE,
                        power_iters: int = POWER_ITERS,
                        orth: str = "jacobi",
                        u0: torch.Tensor | None = None):
    """Batched automatic rank selection (Idelbayev & Carreira-Perpiñán,
    CVPR'20).

    Minimizes ``α_i·C(r) + μ/2·E_i(r)`` over r ∈ {0..r_max} per item,
    with α an (I,) operand (mixed-α tasks share the call). The tail
    energy is taken sketch-side, ``E_i(r) = ‖w_i‖² − Σ_{j≤r} ŝ_ij²``:
    against the exact-spectrum objective this adds the constant
    ``Σ_{j>r_max} σ_j²`` to every candidate, so the argmin is the same.
    Returns ``(u (I, m, r_max), v (I, n, r_max), rank (I,) i32)``."""
    n_items, m, n = w.shape
    w = w.float()
    k = min(r_max + oversample, m, n)
    iters = power_iters if u0 is None else _warm_iters(power_iters)
    u, s, v = rsvd_spectrum_batched(w, keys, k, power_iters=iters,
                                    orth=orth, q0=u0)
    s2 = torch.clamp_min(s[:, :r_max], 0.0) ** 2             # (I, r_max)
    captured = torch.cat(
        [torch.zeros((n_items, 1), dtype=torch.float32, device=w.device),
         torch.cumsum(s2, dim=-1)], dim=-1)                  # (I, r_max+1)
    total = torch.sum(w * w, dim=(1, 2))[:, None]
    tail = torch.clamp_min(total - captured, 0.0)
    unit = float(m + n) if cost == "storage" else 2.0 * float(m + n)
    ranks = torch.arange(r_max + 1, dtype=torch.float32,
                         device=w.device)[None, :]
    obj = (alpha.to(device=w.device, dtype=torch.float32)[:, None] * unit
           * ranks + 0.5 * mu * tail)
    r_star = torch.argmin(obj, dim=-1).to(torch.int32)
    u, v = _scaled_masked_factors(u, s, v, r_star, r_max)
    return u, v, r_star
