"""Plain PyTorch versions of the k-means kernel: the assignment +
moments pass (K1, K7) and the Lloyd loop in one launch.

They compute what ``kmeans.kmeans_assign_moments_batched`` and
``kmeans.kmeans_lloyd_batched`` compute, with the same semantics as the
JAX package's kernel: assignment by explicit squared-distance argmin
(first index on ties, +inf entries never win), per-cluster Σw in f32 and
int32 counts. The CPU tests and the chip smoke test hold the kernel
against them.
"""
from __future__ import annotations

import torch

#: columns per pass: bounds the (I, K, chunk) intermediates, so the LM
#: group (I=8, P=25,165,824, K=16) needs ~1 GB instead of ~13 GB. Sums
#: over more than one chunk add the chunks' sums in order, which rounds
#: differently from one pass (rtol ~1e-6).
CHUNK = 1 << 20


def kmeans_assign_moments_batched_plain(w: torch.Tensor,
                                        codebooks: torch.Tensor):
    """w (I, P) f32, codebooks (I, K) f32 → (assign (I, P) i32,
    sums (I, K) f32, counts (I, K) i32)."""
    n_items, p = w.shape
    k = codebooks.shape[-1]
    ks = torch.arange(k, dtype=torch.int32, device=w.device)[None, :, None]
    assign = torch.empty((n_items, p), dtype=torch.int32, device=w.device)
    sums = torch.zeros((n_items, k), dtype=torch.float32, device=w.device)
    counts = torch.zeros((n_items, k), dtype=torch.int32, device=w.device)
    for lo in range(0, p, CHUNK):
        wc = w[:, lo:lo + CHUNK]
        d = wc[:, :, None] - codebooks[:, None, :]
        a = torch.argmin(d * d, dim=-1).to(torch.int32)
        assign[:, lo:lo + CHUNK] = a
        onehot = a[:, None, :] == ks                      # (I, K, chunk)
        sums += torch.where(onehot, wc[:, None, :], 0.0).sum(-1)
        counts += onehot.sum(-1, dtype=torch.int32)
    return assign, sums, counts


def kmeans_assign_moments_plain(w: torch.Tensor, codebook: torch.Tensor):
    """w (P,) f32, codebook (K,) f32 → (assign (P,) i32, sums (K,) f32,
    counts (K,) i32): the single-vector form."""
    assign, sums, counts = kmeans_assign_moments_batched_plain(
        w[None], codebook[None])
    return assign[0], sums[0], counts[0]


def kmeans_lloyd_batched_plain(w: torch.Tensor, codebooks: torch.Tensor,
                               iters: int):
    """w (I, P) f32, ascending codebooks (I, K) f32 → (codebooks (I, K)
    after ``iters`` Lloyd steps, assign (I, P) i32): the loop of single
    passes, each followed by ``sort(where(counts > 0, sums / counts,
    cb))`` (empty clusters keep their entry)."""
    cb = codebooks
    for _ in range(iters):
        _, sums, counts = kmeans_assign_moments_batched_plain(w, cb)
        cb = torch.sort(torch.where(counts > 0, sums / counts.clamp_min(1),
                                    cb), dim=-1).values
    assign, _, _ = kmeans_assign_moments_batched_plain(w, cb)
    return cb, assign
