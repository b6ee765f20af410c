"""k-means solvers: the single-vector Lloyd loop and the batched one —
the ``kmeans_lloyd`` entry of the dispatch registry — and the single
passes (K1, K7) of the kernel API.

Port of ``src/repro/kernels/kmeans/ops.py``. On a CUDA tensor each Lloyd
loop is one kernel launch (``kmeans.kmeans_lloyd_batched``: every step
and the final assignment on the card, no host sync), for the whole
packed group in the batched solver; on a CPU tensor the kernel's plain
version, the loop of single passes, runs instead.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.kmeans.kmeans import (
    kmeans_assign_moments, kmeans_assign_moments_batched,
    kmeans_lloyd_batched)


def assign_moments(w: torch.Tensor, codebook: torch.Tensor):
    """Nearest-centroid assignment + cluster moments of one vector (K7)
    → (assign (P,) i32, sums (K,) f32, counts (K,) i32). The JAX package
    pads the tail with ``codebook[0]`` and subtracts it afterwards; the
    kernel masks the tail, so nothing is padded here."""
    return kmeans_assign_moments(w.reshape(-1).float().contiguous(),
                                 codebook.float().contiguous())


def lloyd_step(w: torch.Tensor, codebook: torch.Tensor) -> torch.Tensor:
    """One Lloyd update of a sorted codebook; empty clusters keep their
    entry."""
    _, sums, counts = assign_moments(w, codebook)
    new = torch.where(counts > 0, sums / counts.clamp_min(1), codebook)
    return torch.sort(new).values


def kmeans(w: torch.Tensor, codebook0: torch.Tensor, iters: int = 25):
    """Full Lloyd loop on the kernel (the I = 1 launch of the fused loop)
    → (codebook (K,), assign (P,) i32)."""
    cb = torch.sort(codebook0.float()).values
    cb, assign = kmeans_lloyd_batched(
        w.reshape(1, -1).float().contiguous(), cb[None].contiguous(), iters)
    return cb[0], assign[0]


def assign_moments_batched(w: torch.Tensor, codebooks: torch.Tensor):
    """Assignment + moments over a packed (I, P) item stack → (assign
    (I, P) i32, sums (I, K) f32, counts (I, K) i32).

    The JAX driver pads each row to its tile with ``codebook[0]`` and
    subtracts the padding from the moments afterwards; the K1 kernel
    masks the ragged tail itself, so nothing is padded here and the sums
    differ from the JAX kernel path by the rounding of that correction."""
    return kmeans_assign_moments_batched(w.float().contiguous(),
                                         codebooks.float().contiguous())


def kmeans_batched(w: torch.Tensor, codebooks0: torch.Tensor,
                   kvalid: torch.Tensor | None = None,
                   iters: int = 25, impl: str = "torch"):
    """Per-item Lloyd loop over a packed (I, P) stack with per-item (I, K)
    warm-start codebooks → (codebooks (I, K) f32, assign (I, P) i32).

    ``kvalid`` ((I,) i32, optional) is the per-item count of live
    codebook entries (mixed-K grouping): codebooks arrive padded to the
    group K_max, and entries at or past ``kvalid_i`` are pinned to +inf,
    so no weight assigns to them, their moments stay empty, and the
    ascending sort keeps each item's live entries in its first
    ``kvalid_i`` slots.

    ``impl``: ``"torch"`` runs :func:`~repro_torch.core.schemes.quantize.
    kmeans_1d` on the stack (midpoint-count assignment, the per-task
    scheme's arithmetic); ``"kernel"`` runs the whole loop as one launch
    of the fused kernel on a CUDA tensor, the loop of plain K1 passes on a
    CPU one.
    """
    if kvalid is not None:
        k_max = codebooks0.shape[-1]
        live = (torch.arange(k_max, device=codebooks0.device)[None, :]
                < kvalid.to(torch.int32)[:, None])
        codebooks0 = torch.where(live, codebooks0.float(), torch.inf)
    if impl == "torch":
        # deferred import: core.grouping imports the dispatch layer
        from repro_torch.core.schemes.quantize import kmeans_1d
        return kmeans_1d(w, codebooks0, iters)
    if impl != "kernel":
        raise ValueError(f"impl must be 'torch' or 'kernel', got {impl!r}")
    cb = torch.sort(codebooks0.float(), dim=-1).values
    return kmeans_lloyd_batched(w.float().contiguous(), cb, iters)
