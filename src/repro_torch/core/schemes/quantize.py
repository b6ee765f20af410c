"""Quantization C steps (paper §4.1).

Port of ``src/repro/core/schemes/quantize.py``.

* ``AdaptiveQuantization`` — scalar k-means (paper eq. 2) by Lloyd
  iterations, warm-started across C steps. The nearest-centroid
  assignment counts codebook midpoints below each weight, and the cluster
  moments are masked reductions, as in the JAX package. Both run over
  column chunks of :data:`CHUNK`, so the ``(…, K, chunk)`` intermediates
  stay bounded (a 25M-weight item would need ~1.6 GB per item in one
  pass); sums over several chunks add the chunks' sums in order, which
  rounds differently from one pass (relative error ~1e-6).
* ``optimal_codebook_dp`` — globally optimal 1-D quantizer by dynamic
  programming on a B-bin histogram.
* ``Binarize`` into {−1,1} or {−c,c}; ``Ternarize`` into {−c,0,c} with
  jointly optimal support and scale.

``kmeans_1d`` and ``quantile_init`` take any leading batch dims: the
``torch`` backend of the ``kmeans_lloyd`` solver runs them on a packed
(I, P) group directly.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from repro_torch.core.schemes.base import CompressionScheme

#: columns per pass of the assignment and moment reductions
CHUNK = 1 << 20


class QuantTheta(NamedTuple):
    codebook: torch.Tensor  # (K,) float32
    assign: torch.Tensor    # (P,) int32 — index into codebook


def _assign_nearest(w: torch.Tensor, codebook: torch.Tensor) -> torch.Tensor:
    """Nearest-centroid assignment for a *sorted* codebook: the number of
    midpoints below each weight (``searchsorted(midpoints, w,
    side='left')``, ties included). w (…, P), codebook (…, K)."""
    mid = (codebook[..., 1:] + codebook[..., :-1]) * 0.5
    return torch.cat(
        [(w[..., lo:lo + CHUNK, None] > mid[..., None, :])
         .sum(-1, dtype=torch.int32)
         for lo in range(0, w.shape[-1], CHUNK)], dim=-1)


def _cluster_moments(w: torch.Tensor, assign: torch.Tensor, k: int):
    """Per-cluster (Σw f32, count int32) by masked reductions over column
    chunks. w, assign (…, P) → (…, K), (…, K)."""
    ks = torch.arange(k, dtype=torch.int32, device=w.device)[:, None]
    sums = counts = None
    for lo in range(0, w.shape[-1], CHUNK):
        onehot = assign[..., None, lo:lo + CHUNK] == ks   # (…, K, chunk)
        s = torch.where(onehot, w[..., None, lo:lo + CHUNK], 0.0).sum(-1)
        c = onehot.sum(-1, dtype=torch.int32)
        sums = s if sums is None else sums + s
        counts = c if counts is None else counts + c
    return sums, counts


def _lloyd_update(w: torch.Tensor, codebook: torch.Tensor) -> torch.Tensor:
    """One Lloyd step: assign to the nearest centroid, recompute the means
    (an empty cluster keeps its centroid), sort."""
    assign = _assign_nearest(w, codebook)
    sums, counts = _cluster_moments(w, assign, codebook.shape[-1])
    new = torch.where(counts > 0, sums / counts.clamp_min(1), codebook)
    return torch.sort(new, dim=-1).values


def kmeans_1d(w: torch.Tensor, codebook0: torch.Tensor, iters: int = 25):
    """Scalar k-means with warm start → (codebook, assignments int32).
    w (…, P), codebook0 (…, K)."""
    w = w.float()
    codebook = torch.sort(codebook0.float(), dim=-1).values
    for _ in range(iters):
        codebook = _lloyd_update(w, codebook)
    return codebook, _assign_nearest(w, codebook)


def quantile_init(w: torch.Tensor, k: int) -> torch.Tensor:
    """K equally spaced quantiles of w (``jnp.quantile``'s ``linear``
    method, in the same float32 arithmetic), w (…, P) → (…, K).

    Computed from a sort: ``torch.quantile`` refuses inputs of more than
    2^24 elements, and LM items hold more."""
    a = torch.sort(w.float(), dim=-1).values
    n = torch.full((), float(a.shape[-1]), dtype=torch.float32,
                   device=a.device)
    q = (torch.arange(k, dtype=torch.float32, device=a.device) + 0.5) / k
    q = q * (n - 1)
    low, high = torch.floor(q), torch.ceil(q)
    high_w = q - low
    low_w = 1 - high_w
    low = torch.clamp(low, min=0).minimum(n - 1).long()
    high = torch.clamp(high, min=0).minimum(n - 1).long()
    return a[..., low] * low_w + a[..., high] * high_w


class AdaptiveQuantization(CompressionScheme):
    """Learned codebook of size K via scalar k-means (paper eq. 2)."""

    domain = "vector"
    # batched Lloyd solver in the dispatch registry: on the card the
    # grouped C step runs the K1 kernel once per Lloyd step per group
    solver = "kmeans_lloyd"
    solver_operands = ("kvalid",)

    @classmethod
    def contract_examples(cls):
        # few iterations: the lint counts this, it does not fit anything
        return (cls(k=2, iters=2),)

    def __init__(self, k: int = 2, iters: int = 25, use_dp_init: bool = False,
                 dp_bins: int = 2048):
        assert k >= 2
        self.k = int(k)
        self.iters = int(iters)
        self.use_dp_init = bool(use_dp_init)
        self.dp_bins = int(dp_bins)

    def group_key(self):
        return ("quant-kmeans", self.k, self.iters)

    def batch_key(self):
        # K rides as the per-item live-entry count (codebooks padded to
        # the group K_max): tasks differing only in K share one launch
        return ("quant-kmeans", self.iters)

    def batch_operands(self, n_items: int, device):
        return (torch.full((n_items,), self.k, dtype=torch.int32,
                           device=device),)

    def init_key(self):
        # the DP warm start changes init() only
        return (*self.group_key(), self.use_dp_init, self.dp_bins)

    def init(self, w, key=None):
        if self.use_dp_init:
            cb = optimal_codebook_dp(w, self.k, bins=self.dp_bins)
        else:
            cb = quantile_init(w, self.k)
        cb, assign = kmeans_1d(w, cb, self.iters)
        return QuantTheta(cb, assign)

    def compress(self, w, theta: QuantTheta, mu=None):
        cb, assign = kmeans_1d(w, theta.codebook, self.iters)
        return QuantTheta(cb, assign)

    def compress_batched(self, solve, w, theta: QuantTheta, operands,
                         mu=None):
        """One solver call warm-starts every item's codebook (w (I, P),
        codebooks (I, K_max) padded to the group max, operands = (per-item
        live-entry counts,)); padded entries are pinned to +inf inside
        the solver, so live entries stay in the leading slots."""
        (kvalid,) = operands
        cb, assign = solve(w, theta.codebook, kvalid, iters=self.iters)
        return QuantTheta(cb, assign)

    def decompress(self, theta: QuantTheta):
        # index_select takes the int32 assignment as it is: no int64 copy
        # of it (8 B a weight) beside the output
        return torch.index_select(theta.codebook, 0,
                                  theta.assign.reshape(-1)).reshape(
                                      theta.assign.shape)

    def warm_start(self, theta: QuantTheta) -> QuantTheta:
        # the Lloyd loop starts from the codebook; the assignment (as
        # large as the weights) is its output, so it is not packed
        return QuantTheta(theta.codebook, theta.assign[..., :0])

    def bits(self, theta: QuantTheta, float_bits: int = 32):
        p = theta.assign.numel()
        return p * math.ceil(math.log2(self.k)) + self.k * float_bits


class Binarize(CompressionScheme):
    """{−1,1} (``scaled=False``) or {−c,c} with optimal c = mean|w|."""

    domain = "vector"

    def __init__(self, scaled: bool = True):
        self.scaled = bool(scaled)

    def group_key(self):
        return ("quant-binarize", self.scaled)

    def init(self, w, key=None):
        return self.compress(w, None)

    def compress(self, w, theta, mu=None):
        w = w.float()
        sign = torch.where(w >= 0, 1, -1).to(torch.int8)
        scale = (w.abs().mean() if self.scaled
                 else torch.ones((), device=w.device))
        return {"sign": sign, "scale": scale}

    def decompress(self, theta):
        return theta["sign"].float() * theta["scale"]

    def bits(self, theta, float_bits: int = 32):
        return theta["sign"].numel() + (float_bits if self.scaled else 0)


class Ternarize(CompressionScheme):
    """{−c,0,c} with jointly optimal support and scale: for support over
    the s largest |w| the distortion falls by (Σ_top-s |w|)²/s, maximised
    over s in one sort + cumsum pass."""

    domain = "vector"

    def group_key(self):
        return ("quant-ternarize",)

    def init(self, w, key=None):
        return self.compress(w, None)

    def compress(self, w, theta, mu=None):
        w = w.float()
        a = w.abs()
        a_sorted = torch.sort(a.reshape(-1), descending=True).values
        csum = torch.cumsum(a_sorted, 0)
        s_range = torch.arange(1, a.numel() + 1, dtype=torch.float32,
                               device=w.device)
        gain = csum ** 2 / s_range
        s_star = torch.argmax(gain)
        # gathered on the device: indexing by a 0-d tensor reads it on
        # the host, which a CUDA graph cannot capture
        at = s_star.reshape(1)
        c = csum.index_select(0, at)[0] / (s_star.float() + 1.0)
        # keep |w| >= a_sorted[s*] (s*+1 items)
        thresh = a_sorted.index_select(0, at)[0]
        sign = torch.where(a >= thresh, torch.where(w >= 0, 1, -1), 0)
        return {"sign": sign.to(torch.int8), "scale": c}

    def decompress(self, theta):
        return theta["sign"].float() * theta["scale"]

    def bits(self, theta, float_bits: int = 32):
        return theta["sign"].numel() * 1.585 + float_bits


# ----------------------------------------------------------------------
# Globally optimal 1-D quantizer on a histogram (DP).
# ----------------------------------------------------------------------
def optimal_codebook_dp(w: torch.Tensor, k: int, bins: int = 2048):
    """Exact K-level scalar quantizer on a B-bin histogram of w.

    The cost of covering bins [i..j) with one level is the weighted SSE
    around the weighted mean; DP over levels on the full (B+1, B+1)
    interval-cost matrix. O(K·B²) time, O(B²) memory, independent of P.
    """
    w = w.float().reshape(-1)
    dev = w.device
    lo, hi = w.min(), w.max()
    width = torch.clamp_min(hi - lo, 1e-12)
    centers = lo + (torch.arange(bins, dtype=torch.float32, device=dev)
                    + 0.5) / bins * width
    idx = torch.clamp(((w - lo) / width * bins).to(torch.int64), 0, bins - 1)
    h0 = torch.bincount(idx, minlength=bins).float()
    h1 = h0 * centers
    h2 = h0 * centers ** 2

    # prefix sums with a leading zero: S[j] - S[i] = bins i..j-1
    z = torch.zeros((1,), dtype=torch.float32, device=dev)
    s0, s1, s2 = (torch.cat([z, torch.cumsum(h, 0)]) for h in (h0, h1, h2))

    ii = torch.arange(bins + 1, device=dev)
    i, j = ii[:, None], ii[None, :]
    n = s0[j] - s0[i]
    m1 = s1[j] - s1[i]
    m2 = s2[j] - s2[i]
    cost = torch.where(n > 0, m2 - m1 ** 2 / torch.clamp_min(n, 1.0), 0.0)
    cost = torch.where(i <= j, cost, torch.inf)               # (B+1, B+1)

    # E[j] = best cost of covering bins [0, j) with the current # of levels
    e = cost[0]
    args = []
    for _ in range(k - 1):
        tot = e[:, None] + cost
        e = tot.min(dim=0).values
        args.append(tot.argmin(dim=0))

    # backtrack the split points from j = B (tensor indices: no host sync)
    j = torch.full((), bins, dtype=torch.int64, device=dev)
    js = [j]
    for lvl in range(k - 2, -1, -1):
        j = args[lvl][j]
        js.append(j)
    js = torch.stack(js[::-1])      # (k,) right edges ascending, js[-1] = B
    lefts = torch.cat([torch.zeros((1,), dtype=js.dtype, device=dev),
                       js[:-1]])
    n = s0[js] - s0[lefts]
    m1 = s1[js] - s1[lefts]
    cb = torch.where(n > 0, m1 / torch.clamp_min(n, 1.0),
                     centers[torch.clamp(lefts, 0, bins - 1)])
    return torch.sort(cb).values
