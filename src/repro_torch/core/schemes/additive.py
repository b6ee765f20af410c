"""Additive combinations of compressions (paper §4, Table 1 bottom).

Port of ``src/repro/core/schemes/additive.py``.
Δ(Θ₁,…,Θ_S) = Σ_s Δ_s(Θ_s); the C step
    min ‖w − Σ_s Δ_s(Θ_s)‖²
is solved by alternating projections: each sub-scheme projects the
current residual, which never increases the joint distortion (each inner
step is an exact partial minimization).

Sub-schemes may live in different domains: vector-domain sub-schemes see
the flattened residual, matrix-domain ones see it in the view's shape.
The combination has no batched solver: grouped tasks run it item by
item, and its sub-schemes run their own ``compress`` (not the dispatch
registry), as in the JAX package.
"""
from __future__ import annotations

import torch

from repro_torch.core.schemes.base import CompressionScheme


class AdditiveCombination(CompressionScheme):
    def __init__(self, schemes: list[CompressionScheme], iters: int = 3):
        if len(schemes) < 2:
            raise ValueError("an additive combination needs ≥ 2 schemes")
        self.schemes = list(schemes)
        self.iters = int(iters)
        # "matrix" if any sub-scheme needs matrices, else "vector"
        self.domain = ("matrix" if any(s.domain == "matrix" for s in schemes)
                       else "vector")

    @classmethod
    def contract_examples(cls):
        # imports here, not at the top: the base machinery must not pull
        # the sibling scheme modules into an import cycle
        from repro_torch.core.schemes.prune import ConstraintL0Pruning
        from repro_torch.core.schemes.quantize import AdaptiveQuantization
        return (cls([AdaptiveQuantization(k=2, iters=2),
                     ConstraintL0Pruning(kappa=4)], iters=2),)

    def group_key(self):
        subs = tuple(s.group_key() for s in self.schemes)
        if any(k is None for k in subs):
            return None
        return ("additive", self.iters, subs)

    def init_key(self):
        # a sub-scheme whose init differs (DP warm start) must split the
        # additive init group too
        subs = tuple(s.init_key() for s in self.schemes)
        if any(k is None for k in subs):
            return None
        return ("additive-init", self.iters, subs)

    def _to_domain(self, x, scheme):
        if scheme.domain == "vector" and x.ndim != 1:
            return x.reshape(-1)
        return x

    def _from_domain(self, x, shape):
        return x.reshape(shape)

    def init(self, w, key=None):
        thetas = []
        resid = w
        for s in self.schemes:
            th = s.init(self._to_domain(resid, s), key=key)
            thetas.append(th)
            resid = resid - self._from_domain(s.decompress(th), w.shape)
        return {"parts": thetas}

    def compress(self, w, theta, mu=None):
        thetas = list(theta["parts"])
        for _ in range(self.iters):
            for i, s in enumerate(self.schemes):
                others = sum(
                    (self._from_domain(self.schemes[j].decompress(thetas[j]),
                                       w.shape)
                     for j in range(len(self.schemes)) if j != i),
                    torch.zeros_like(w))
                thetas[i] = s.compress(self._to_domain(w - others, s),
                                       thetas[i], mu=mu)
        return {"parts": thetas}

    def decompress(self, theta):
        parts = [s.decompress(th) for s, th in zip(self.schemes,
                                                   theta["parts"])]
        # in the matrix domain when a part has one, else as vectors
        shape = next((d.shape for d in parts if d.ndim > 1), None)
        out = None
        for d in parts:
            if shape is not None:
                d = d.reshape(shape)
            out = d if out is None else out + d
        return out

    def bits(self, theta, float_bits: int = 32):
        return sum(s.bits(th, float_bits)
                   for s, th in zip(self.schemes, theta["parts"]))
