"""The batched k-means solver: the ``kmeans_lloyd`` entry of the dispatch
registry.

Port of ``src/repro/kernels/kmeans/ops.py`` (``assign_moments_batched``,
``kmeans_batched``). The kernel path runs one K1 launch per Lloyd step
for the whole packed group, plus one for the final assignment: ``iters
+ 1`` launches per group per C step.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.kmeans.kmeans import kmeans_assign_moments_batched


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
    scheme's arithmetic); ``"kernel"`` runs the K1 wrapper per Lloyd step
    (the CUDA kernel on a CUDA tensor, its plain version on a CPU one).
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
    w = w.float().contiguous()
    cb = torch.sort(codebooks0.float(), dim=-1).values
    for _ in range(iters):
        _, sums, counts = assign_moments_batched(w, cb)
        cb = torch.sort(torch.where(counts > 0,
                                    sums / counts.clamp_min(1), cb),
                        dim=-1).values
    assign, _, _ = assign_moments_batched(w, cb)
    return cb, assign
