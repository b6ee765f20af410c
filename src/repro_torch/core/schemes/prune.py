"""Pruning C steps (paper §4.2).

Port of ``src/repro/core/schemes/prune.py``. Constraint forms (ℓ0: keep
the top-κ by magnitude; ℓ1: project onto the ℓ1 ball) and penalty forms
(ℓ0: hard threshold at √(2α/μ); ℓ1: soft threshold at α/μ). Θ is the
dense projected vector θ (zeros encode the pruned support).
"""
from __future__ import annotations

import math

import torch

from repro_torch.core.schemes.base import CompressionScheme


def topk_magnitude_mask(w: torch.Tensor, kappa: int) -> torch.Tensor:
    """Boolean mask keeping *exactly* min(κ, w.numel()) largest |w|.

    Ties at the κ-th magnitude go to the lower index (the ``lax.top_k``
    order of the JAX package): a stable argsort by descending magnitude.
    ``torch.topk`` promises no order on ties and a default ``argsort`` is
    unstable, so neither is used."""
    a = w.reshape(-1).float().abs()
    idx = torch.argsort(-a, stable=True)[:min(int(kappa), a.numel())]
    # index_fill_ takes its value as a scalar argument: no host tensor
    # is copied to the device (which a CUDA graph cannot capture)
    mask = torch.zeros(a.shape, dtype=torch.bool, device=w.device)
    return mask.index_fill_(0, idx, True).reshape(w.shape)


def project_l1_ball(w: torch.Tensor, radius: float) -> torch.Tensor:
    """Euclidean projection of w onto {θ : ‖θ‖₁ ≤ radius} (Duchi et al.).
    Both branches are computed and selected on the device (no sync)."""
    a = w.reshape(-1).float().abs()
    total = a.sum()
    u = torch.sort(a, descending=True).values
    cs = torch.cumsum(u, 0)
    r = torch.arange(1, a.numel() + 1, dtype=torch.float32, device=w.device)
    cond = u * r > (cs - radius)
    rho = torch.where(cond, r, 0.0).max()
    cs_rho = torch.where(r <= rho, u, 0.0).sum()
    tau = (cs_rho - radius) / torch.clamp_min(rho, 1.0)
    proj = torch.sign(w) * torch.clamp_min(w.abs() - tau, 0.0)
    return torch.where(total <= radius, w, proj)


def _threshold(num: float, mu) -> torch.Tensor | float:
    """num / μ in float32 when μ is a tensor (``float / tensor`` would
    multiply by a rounded reciprocal instead of dividing)."""
    if isinstance(mu, torch.Tensor):
        return torch.full_like(mu, num, dtype=torch.float32) / mu
    return num / mu


def _cut_warm_start(self, theta):
    """Pruning's solves read nothing of the previous Θ: the dense θ, as
    large as the weights, is not packed (cut to zero width)."""
    return {k: v[..., :0] for k, v in theta.items()}


class ConstraintL0Pruning(CompressionScheme):
    """s.t. ‖θ‖₀ ≤ κ — keep the κ largest-magnitude weights (eq. 4).

    κ is not in :meth:`batch_key`: it rides as a per-item operand, so
    tasks that differ only in κ pack into one launch (mixed-κ grouping).
    """

    domain = "vector"
    solver = "topk_mask"
    solver_operands = ("kappa",)

    @classmethod
    def contract_examples(cls):
        return (cls(kappa=4),)

    def __init__(self, kappa: int):
        assert kappa >= 1
        self.kappa = int(kappa)

    def group_key(self):
        return ("prune-l0", self.kappa)

    def batch_key(self):
        return ("prune-l0",)

    def batch_operands(self, n_items: int, device):
        return (torch.full((n_items,), self.kappa, dtype=torch.int32,
                           device=device),)

    def init(self, w, key=None):
        return self.compress(w, None)

    def compress(self, w, theta, mu=None):
        mask = topk_magnitude_mask(w, self.kappa)
        return {"theta": torch.where(mask, w, 0.0)}

    def compress_batched(self, solve, w, theta, operands, mu=None):
        (kappa,) = operands
        return {"theta": solve(w, kappa)}

    warm_start = _cut_warm_start

    def decompress(self, theta):
        return theta["theta"]

    def bits(self, theta, float_bits: int = 32):
        p = theta["theta"].numel()
        return self.kappa * (float_bits + math.ceil(math.log2(max(p, 2))))


class ConstraintL1Pruning(CompressionScheme):
    """s.t. ‖θ‖₁ ≤ κ — projection onto the ℓ1 ball; the radius rides as
    a per-item operand."""

    domain = "vector"
    solver = "project_l1_ball"
    solver_operands = ("radius",)

    @classmethod
    def contract_examples(cls):
        return (cls(kappa=1.0),)

    def __init__(self, kappa: float):
        self.kappa = float(kappa)

    def group_key(self):
        return ("prune-l1", self.kappa)

    def batch_key(self):
        return ("prune-l1",)

    def batch_operands(self, n_items: int, device):
        return (torch.full((n_items,), self.kappa, dtype=torch.float32,
                           device=device),)

    def init(self, w, key=None):
        return self.compress(w, None)

    def compress(self, w, theta, mu=None):
        return {"theta": project_l1_ball(w, self.kappa)}

    def compress_batched(self, solve, w, theta, operands, mu=None):
        (radius,) = operands
        return {"theta": solve(w, radius)}

    warm_start = _cut_warm_start

    def decompress(self, theta):
        return theta["theta"]

    def bits(self, theta, float_bits: int = 32):
        return theta["theta"].numel() * float_bits  # upper bound


class PenaltyL0Pruning(CompressionScheme):
    """min L(w) + α‖w‖₀ — C step hard-thresholds at √(2α/μ)."""

    domain = "vector"

    @classmethod
    def contract_examples(cls):
        return (cls(alpha=1e-3),)

    def __init__(self, alpha: float):
        self.alpha = float(alpha)

    def group_key(self):
        return ("prune-penalty-l0", self.alpha)

    def init(self, w, key=None):
        # μ→0⁺ would prune everything: start from w itself (a copy: w may
        # be a view of the parameters, which the L step updates in place)
        return {"theta": w.clone()}

    def compress(self, w, theta, mu=None):
        assert mu is not None, "penalty pruning needs μ"
        t = _threshold(2.0 * self.alpha, mu)
        t = torch.sqrt(t) if isinstance(t, torch.Tensor) else math.sqrt(t)
        return {"theta": torch.where(w.abs() > t, w, 0.0)}

    warm_start = _cut_warm_start

    def decompress(self, theta):
        return theta["theta"]

    def bits(self, theta, float_bits: int = 32):
        return theta["theta"].numel() * float_bits  # data-dependent nnz


class PenaltyL1Pruning(CompressionScheme):
    """min L(w) + α‖w‖₁ — C step soft-thresholds at α/μ; α rides as a
    per-item operand."""

    domain = "vector"
    solver = "soft_threshold"
    solver_operands = ("alpha",)

    @classmethod
    def contract_examples(cls):
        return (cls(alpha=1e-3),)

    def __init__(self, alpha: float):
        self.alpha = float(alpha)

    def group_key(self):
        return ("prune-penalty-l1", self.alpha)

    def batch_key(self):
        return ("prune-penalty-l1",)

    def batch_operands(self, n_items: int, device):
        return (torch.full((n_items,), self.alpha, dtype=torch.float32,
                           device=device),)

    def init(self, w, key=None):
        return {"theta": w.clone()}

    def compress(self, w, theta, mu=None):
        assert mu is not None, "penalty pruning needs μ"
        t = _threshold(self.alpha, mu)
        return {"theta": torch.sign(w) * torch.clamp_min(w.abs() - t, 0.0)}

    def compress_batched(self, solve, w, theta, operands, mu=None):
        assert mu is not None, "penalty pruning needs μ"
        (alpha,) = operands
        return {"theta": solve(w, alpha, mu)}

    warm_start = _cut_warm_start

    def decompress(self, theta):
        return theta["theta"]

    def bits(self, theta, float_bits: int = 32):
        return theta["theta"].numel() * float_bits
