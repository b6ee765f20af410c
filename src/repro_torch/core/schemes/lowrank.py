"""Low-rank C steps (paper §4.3).

Port of ``src/repro/core/schemes/lowrank.py``.

``LowRank(r)`` — truncated SVD to a fixed target rank.
``RankSelection(alpha, cost=...)`` — automatic per-matrix rank (Idelbayev &
Carreira-Perpiñán, CVPR'20): the C step minimizes
    α·C(r) + μ/2·Σ_{i>r} σ_i²   over r ∈ {0..R},
with C(r) = r·(m+n) (storage floats) or 2·r·(m+n) (FLOPs). Θ keeps fixed
shapes (U: (m,R), V: (n,R)) plus a 0-d integer rank; columns ≥ r are zero.

Under kernel dispatch both schemes go through the matmul-only batched
solvers of ``kernels/lowrank`` (``lowrank_rsvd`` / ``rank_select``):
Gaussian sketch per item, power iteration with Jacobi-based
orthogonalization, a small Gram finisher. Mixed-rank and mixed-α tasks
pack into one solver call (rank and α are per-item operands; factors pad
to the group R_max). ``LowRank(randomized=False)`` demands the exact SVD
and opts out of dispatch; ``RankSelection`` joins the batched path only
when ``max_rank`` bounds the sketch.

Off the dispatch path, large matrices use a randomized range finder
(Halko et al.) on ``torch.linalg.qr``/``svd``; its sketch seed comes per
item from the C-step engine (``wants_key`` / ``CompressionTask.
item_keys``).
"""
from __future__ import annotations

import math

import torch

from repro_torch.core.schemes.base import CompressionScheme


def randomized_svd(w: torch.Tensor, r: int, key, oversample: int = 8,
                   power_iters: int = 2):
    """Rank-r randomized SVD; ``key`` seeds the sketch's generator.
    Returns (U (m,r), s (r,), V (n,r))."""
    m, n = w.shape
    k = min(r + oversample, min(m, n))
    w = w.float()
    gen = torch.Generator(device=w.device).manual_seed(int(key))
    omega = torch.randn((n, k), generator=gen, dtype=torch.float32,
                        device=w.device)
    y = w @ omega
    for _ in range(power_iters):
        y, _ = torch.linalg.qr(y)
        y = w @ (w.T @ y)
    q, _ = torch.linalg.qr(y)                    # (m, k)
    ub, s, vt = torch.linalg.svd(q.T @ w, full_matrices=False)
    u = q @ ub
    return u[:, :r], s[:r], vt[:r, :].T


def exact_svd(w: torch.Tensor):
    u, s, vt = torch.linalg.svd(w.float(), full_matrices=False)
    return u, s, vt.T


#: sketch seed when a scheme is used outside the C-step engine (direct
#: compress() calls); inside it, per-item seeds arrive through key=
_SKETCH_SEED = 0x1C


class LowRank(CompressionScheme):
    """W ≈ U Vᵀ with fixed target rank (Θ = (U√s, V√s))."""

    domain = "matrix"
    # rank is NOT in batch_key(): it rides as a per-item operand, so tasks
    # differing only in target rank pack into one group, with factors
    # padded to the group R_max (pack_thetas_padded)
    solver = "lowrank_rsvd"
    solver_operands = ("rank",)
    wants_key = True       # per-item sketch seeds from the C-step engine
    gspmd_safe = True

    def __init__(self, target_rank: int, randomized: str | bool = "auto"):
        if target_rank < 1:
            raise ValueError(f"target_rank must be ≥ 1, got {target_rank}")
        self.rank = int(target_rank)
        self.randomized = randomized

    def group_key(self):
        return ("lowrank", self.rank, self.randomized)

    def batch_key(self):
        # randomized=False demands the exact SVD: out of the (always
        # randomized) batched solver
        if self.randomized is False:
            return None
        return ("lowrank-rsvd",)

    def batch_operands(self, n_items: int, device):
        return (torch.full((n_items,), self.rank, dtype=torch.int32,
                           device=device),)

    def compress_batched(self, solve, w, theta, operands, mu=None):
        """One solver call factorizes the packed group. ``theta`` arrives
        padded to the group R_max; ``operands`` is (per-item ranks,
        per-item seeds). The previous U factor warm-starts the range
        finder (``u0=``)."""
        rank, keys = operands
        r_max = theta["u"].shape[-1]
        u, v = solve(w, rank, keys, r_max=r_max, u0=theta["u"])
        return {"u": u, "v": v}

    def _use_rsvd(self, shape):
        # item-by-item policy only: "auto" keeps the exact SVD up to
        # 2048; under dispatch "auto" means the batched randomized solver
        if self.randomized == "auto":
            return min(shape) > 2048
        return bool(self.randomized)

    def _svd(self, w, key=None):
        if self._use_rsvd(w.shape):
            return randomized_svd(w, self.rank,
                                  _SKETCH_SEED if key is None else key)
        u, s, v = exact_svd(w)
        return u[:, :self.rank], s[:self.rank], v[:, :self.rank]

    def init(self, w, key=None):
        return self.compress(w, None, key=key)

    def compress(self, w, theta, mu=None, key=None):
        u, s, v = self._svd(w, key)
        rs = torch.sqrt(s)
        return {"u": u * rs[None, :], "v": v * rs[None, :]}

    def decompress(self, theta):
        return theta["u"] @ theta["v"].T

    def bits(self, theta, float_bits: int = 32):
        return (theta["u"].numel() + theta["v"].numel()) * float_bits

    def flops(self, theta, orig_shape):
        m, n = orig_shape[-2], orig_shape[-1]
        return 2.0 * self.rank * (m + n)


class RankSelection(CompressionScheme):
    """Automatic rank selection per matrix (α-weighted cost against
    distortion). ``alpha`` is the paper's λ·α_l for this matrix: the
    price, in distortion units scaled by 2/μ, of one unit of C(r)."""

    domain = "matrix"
    # α rides as a per-item operand so tasks differing only in α pack
    # into one group; engages only when max_rank bounds the sketch
    solver = "rank_select"
    solver_operands = ("alpha",)
    wants_key = True
    gspmd_safe = True

    def __init__(self, alpha: float, cost: str = "storage",
                 max_rank: int | None = None):
        if cost not in ("storage", "flops"):
            raise ValueError(f"cost must be 'storage' or 'flops', got "
                             f"{cost!r}")
        self.alpha = float(alpha)
        self.cost = cost
        self.max_rank = max_rank

    def group_key(self):
        return ("rank-selection", self.alpha, self.cost, self.max_rank)

    def batch_key(self):
        # unbounded selection needs the full spectrum (exact path); a
        # bounded max_rank gives the batched solver its sketch width
        if self.max_rank is None:
            return None
        return ("rank-select", self.cost, self.max_rank)

    def batch_operands(self, n_items: int, device):
        return (torch.full((n_items,), self.alpha, dtype=torch.float32,
                           device=device),)

    def compress_batched(self, solve, w, theta, operands, mu=None):
        if mu is None:
            raise ValueError("rank selection needs μ")
        alpha, keys = operands
        r_max = theta["u"].shape[-1]
        u, v, rank = solve(w, alpha, keys, mu, r_max=r_max,
                           cost=self.cost, u0=theta["u"])
        return {"u": u, "v": v, "rank": rank}

    def _rmax(self, shape):
        r = min(shape)
        return min(self.max_rank, r) if self.max_rank else r

    def _unit_cost(self, shape):
        m, n = shape
        if self.cost == "storage":
            return float(m + n)          # floats per unit rank
        return 2.0 * float(m + n)        # MACs per unit rank per example

    def init(self, w, key=None):
        return self.compress(w, None, mu=1e-6, key=key)

    def compress(self, w, theta, mu=None, key=None):
        if mu is None:
            raise ValueError("rank selection needs μ")
        m, n = w.shape
        rmax = self._rmax((m, n))
        u, s, v = exact_svd(w)
        u, s, v = u[:, :rmax], s[:rmax], v[:, :rmax]
        # tail energy: E(r) = Σ_{i>r} σ_i², r = 0..rmax
        s2 = s.float() ** 2
        tail = torch.cat([torch.flip(torch.cumsum(torch.flip(s2, (0,)), 0),
                                     (0,)),
                          torch.zeros((1,), dtype=torch.float32,
                                      device=w.device)])     # (rmax+1,)
        ranks = torch.arange(rmax + 1, dtype=torch.float32, device=w.device)
        total = self.alpha * self._unit_cost((m, n)) * ranks \
            + 0.5 * mu * tail
        r_star = torch.argmin(total).to(torch.int32)
        mask = (torch.arange(rmax, device=w.device) < r_star).float()
        rs = torch.sqrt(s * mask)
        return {"u": u * rs[None, :], "v": v * rs[None, :], "rank": r_star}

    def decompress(self, theta):
        return theta["u"] @ theta["v"].T

    def bits(self, theta, float_bits: int = 32):
        """Storage at the *selected* rank: r·(m+n) floats for the live
        columns of U/V, plus ⌈log2(R+1)⌉ bits saying which r ∈ {0..R} was
        selected (the masked columns are zero and never stored). No host
        pull here: a 0-d tensor rank gives a 0-d tensor."""
        m = theta["u"].shape[0]
        n = theta["v"].shape[0]
        r_max = theta["u"].shape[1]
        rank_index_bits = math.ceil(math.log2(r_max + 1))
        return theta["rank"] * float((m + n) * float_bits) \
            + rank_index_bits

    def flops(self, theta, orig_shape):
        """Inference FLOPs at the selected rank."""
        m, n = orig_shape[-2], orig_shape[-1]
        return theta["rank"] * (2.0 * (m + n))
