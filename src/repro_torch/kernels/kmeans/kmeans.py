"""K1 and K7: k-means assignment + cluster moments, a CUDA kernel.

The ports of ``src/repro/kernels/kmeans/kmeans.py:
kmeans_assign_moments_batched`` (K1) and its single-vector form
``kmeans_assign_moments`` (K7, here the I = 1 launch of K1), Pallas
kernels for the TPU. The kernel source is
``../csrc/kmeans_assign_moments.cu``; its note gives the design and the
bound. Each wrapper launches the kernel for a CUDA tensor and runs its
plain version for a CPU tensor, and counts its own launches (``KERNEL``
for K1, ``SINGLE`` for K7).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels.build import (
    CudaKernel, LaunchCounter, on_card, raw_stream)
from repro_torch.kernels.kmeans.ref import (  # noqa: F401  (the plain versions)
    kmeans_assign_moments_batched_plain, kmeans_assign_moments_plain)

#: elements per block (kTile in the .cu source)
TILE = 4096
MAX_K = 256

_p = ctypes.c_void_p
_ARGS = [_p, _p, ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int,
         ctypes.c_longlong, _p, _p, _p, _p, _p, _p]
KERNEL = CudaKernel("kmeans_assign_moments.cu",
                    "kmeans_assign_moments_batched", _ARGS)
SINGLE = LaunchCounter()


def kmeans_assign_moments_batched(w: torch.Tensor, codebooks: torch.Tensor):
    """w (I, P) f32, codebooks (I, K) f32 with K ≤ 256 → (assign (I, P)
    i32, sums (I, K) f32, counts (I, K) i32).

    On a CUDA tensor this launches the kernel on the current stream
    without synchronising; on a CPU tensor it runs the plain version."""
    if w.device.type == "cpu":
        return kmeans_assign_moments_batched_plain(w, codebooks)
    return _launch(w, codebooks, KERNEL)


def kmeans_assign_moments(w: torch.Tensor, codebook: torch.Tensor):
    """K7: w (P,) f32, codebook (K,) f32 → (assign (P,) i32, sums (K,)
    f32, counts (K,) i32): the K1 kernel's I = 1 launch (the TPU kernel
    counts in f32 and pads the tail with ``codebook[0]``)."""
    if w.device.type == "cpu":
        return kmeans_assign_moments_plain(w, codebook)
    assign, sums, counts = _launch(w[None], codebook[None], SINGLE)
    return assign[0], sums[0], counts[0]


def _launch(w: torch.Tensor, codebooks: torch.Tensor,
            counter: LaunchCounter):
    if w.device.type != "cuda":
        raise ValueError(f"kmeans_assign_moments: no kernel for device "
                         f"{w.device}")
    if w.dtype != torch.float32 or codebooks.dtype != torch.float32:
        raise TypeError("kmeans_assign_moments_batched needs float32 "
                        f"operands, got {w.dtype} and {codebooks.dtype}")
    if (w.ndim != 2 or codebooks.ndim != 2
            or codebooks.shape[0] != w.shape[0]):
        raise ValueError(f"need w (I, P) and codebooks (I, K), got "
                         f"{tuple(w.shape)} and {tuple(codebooks.shape)}")
    n_items, p = w.shape
    k = codebooks.shape[1]
    if not (1 <= n_items <= 65535 and p >= 1 and 1 <= k <= MAX_K):
        raise ValueError(f"kmeans kernel takes 1 ≤ I ≤ 65535, P ≥ 1, "
                         f"1 ≤ K ≤ {MAX_K}; got I={n_items}, P={p}, K={k}")
    if codebooks.device != w.device:
        raise ValueError("w and codebooks must be on the same device")
    if not (w.is_contiguous() and codebooks.is_contiguous()):
        raise ValueError("kmeans kernel needs contiguous operands")
    n_tiles = -(-p // TILE)
    dev = w.device
    assign = torch.empty((n_items, p), dtype=torch.int32, device=dev)
    part_sums = torch.empty((n_items, n_tiles, k), dtype=torch.float32,
                            device=dev)
    part_counts = torch.empty((n_items, n_tiles, k), dtype=torch.int32,
                              device=dev)
    sums = torch.empty((n_items, k), dtype=torch.float32, device=dev)
    counts = torch.empty((n_items, k), dtype=torch.int32, device=dev)
    with on_card(dev.index):
        KERNEL(w.data_ptr(), codebooks.data_ptr(), n_items, p, k, n_tiles,
               assign.data_ptr(), part_sums.data_ptr(),
               part_counts.data_ptr(), sums.data_ptr(), counts.data_ptr(),
               raw_stream(dev.index), counter=counter)
    return assign, sums, counts
