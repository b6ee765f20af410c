"""Matmul-only batched spectral routines for the low-rank C step.

Port of ``src/repro/kernels/lowrank/lowrank.py``. Everything here is
built from batched matrix products and elementwise ops over a packed
``(items, m, n)`` stack, as in the JAX package (which has no Pallas
kernel for it), so on the card it runs as cuBLAS products and small
elementwise kernels:

* :func:`jacobi_eigh_batched` — symmetric eigendecomposition of small
  ``(items, k, k)`` Gram matrices by cyclic parallel-order Jacobi: one
  round applies ⌊k/2⌋ disjoint Givens rotations as one orthogonal matrix
  (two batched k×k products), following a round-robin schedule.
* :func:`orthonormal_columns_batched` — ``Q = Y·E·Λ^{-1/2}`` from the
  Jacobi eigendecomposition of ``G = YᵀY``.
* :func:`newton_schulz_orthonormalize` — the coupled Newton–Schulz
  alternative (``orth="newton_schulz"``).
* :func:`rsvd_spectrum_batched` — Gaussian sketch (one generator per
  item), power iteration, Rayleigh–Ritz and the Jacobi finisher; the
  exact Gram path when the sketch reaches ``min(m, n)``.

A CUDA graph can take all of it (``core/grouping.py:compile_group``):
the Jacobi schedule is made on the device once per size and device, and
within :func:`held_sketches` each sketch is drawn once, by its seeds, and
held, so a capture reads the sketch its eager run drew (a capture cannot
seed a generator).

The Jacobi loop keeps the reference's semantics: ``sign(0) = 0`` (equal
diagonals give no rotation), rotations guarded to the identity where the
off-diagonal is zero, symmetrisation after each round, and a stable
descending sort of the eigenvalues. JAX runs the rounds in one compiled
``fori_loop``; here each round is ~30 eager PyTorch ops, so a call costs
``sweeps × (k − 1)`` rounds of host-side launches. On meta tensors (the
planner's counts) one round runs, counted for every round
(``op_stats.repeated``), and the sketch is a meta tensor. All-zero items
give exact-zero factors, never NaN.
"""
from __future__ import annotations

import threading
from contextlib import contextmanager
from functools import lru_cache, partial

import numpy as np
import torch

from repro_torch.analysis import op_stats


def _round_robin_schedule(k: int) -> np.ndarray:
    """Tournament pairing: (k-1) rounds of k/2 disjoint (p, q) pairs
    covering every unordered pair exactly once. ``k`` must be even."""
    assert k % 2 == 0, k
    players = list(range(k))
    rounds = []
    for _ in range(k - 1):
        pairs = [(players[i], players[k - 1 - i]) for i in range(k // 2)]
        rounds.append(sorted((min(p, q), max(p, q)) for p, q in pairs))
        players = [players[0], players[-1]] + players[1:-1]
    return np.asarray(rounds, dtype=np.int64)       # (k-1, k/2, 2)


@lru_cache(maxsize=None)
def _schedule(k: int, device: torch.device) -> torch.Tensor:
    """:func:`_round_robin_schedule` on ``device``, made once (a host
    copy, which a CUDA graph capture cannot take)."""
    return torch.as_tensor(_round_robin_schedule(k), device=device)


def _gram(y: torch.Tensor) -> torch.Tensor:
    """YᵀY per item: (I, m, k) → (I, k, k)."""
    return torch.bmm(y.transpose(1, 2), y)


def jacobi_eigh_batched(a: torch.Tensor, sweeps: int = 10):
    """Symmetric eigendecomposition of a batch of small matrices.

    ``a``: (I, k, k) symmetric (meant for PSD Gram matrices) →
    ``(eigvals (I, k) descending, eigvecs (I, k, k))`` with eigenvectors
    in columns: ``a ≈ V · diag(λ) · Vᵀ``. Zero matrices pass through
    untouched (guarded rotations)."""
    k = a.shape[-1]
    a = a.float()
    if k == 1:
        return a[..., 0], torch.ones_like(a)
    kp = k + (k % 2)                     # pad to even for the schedule
    if kp != k:
        # the padded row/col stays exactly zero: its off-diagonals are
        # zero, so every rotation touching it is guarded to identity
        a = torch.nn.functional.pad(a, (0, 1, 0, 1))
    sched = _schedule(kp, a.device)
    n_rounds = kp - 1
    eye = torch.eye(kp, dtype=torch.float32, device=a.device)
    v = eye.expand(a.shape).clone()
    # per round: p, q, and the (row, col) positions of the rotation's four
    # entries in J — c at (p,p) and (q,q), s at (p,q), −s at (q,p)
    rounds = []
    for r in range(n_rounds):
        p, q = sched[r, :, 0], sched[r, :, 1]
        rounds.append((p, q, torch.cat([p, q, p, q]),
                       torch.cat([p, q, q, p])))

    def rotate(a, v, step):
        p, q, jr, jc = rounds[step % n_rounds]
        app = a[:, p, p]
        aqq = a[:, q, q]
        apq = a[:, p, q]
        # symmetric Schur rotation (Golub & Van Loan §8.4), guarded so an
        # already-zero off-diagonal yields the identity rotation
        live = apq.abs() > 0.0
        tau = (aqq - app) / (2.0 * torch.where(live, apq, 1.0))
        t = torch.sign(tau) / (tau.abs() + torch.sqrt(1.0 + tau * tau))
        t = torch.where(live, t, 0.0)
        c = 1.0 / torch.sqrt(1.0 + t * t)
        s = t * c
        j = eye.expand(a.shape).clone()
        j[:, jr, jc] = torch.cat([c, c, s, -s], dim=1)
        a = torch.bmm(torch.bmm(j.transpose(1, 2), a), j)
        a = 0.5 * (a + a.transpose(1, 2))           # kill drift
        return a, torch.bmm(v, j)

    steps = sweeps * n_rounds
    if a.is_meta:
        # shapes only (the planner's counts): every round runs the same
        # ops on the same shapes, so one round counts for all of them
        if steps:
            with op_stats.repeated(steps):
                a, v = rotate(a, v, 0)
    else:
        for step in range(steps):
            a, v = rotate(a, v, step)

    lam = torch.diagonal(a, dim1=-2, dim2=-1)       # (I, kp)
    order = torch.argsort(-lam, dim=-1, stable=True)
    lam = torch.gather(lam, -1, order)
    v = torch.gather(v, -1, order[:, None, :].expand(v.shape))
    return lam[:, :k], v[:, :k, :k]


def orthonormal_columns_batched(y: torch.Tensor, sweeps: int = 6):
    """Orthonormal basis of each item's column span, matmul-only.

    ``y``: (I, m, k) → ``q`` (I, m, k) with orthonormal columns spanning
    the same space, via ``G = YᵀY = EΛEᵀ`` and ``Q = Y·E·Λ^{-1/2}``.
    Directions with λ ≤ 1e-12·λ_max are zeroed (an all-zero item gives an
    all-zero Q)."""
    lam, e = jacobi_eigh_batched(_gram(y), sweeps=sweeps)
    lam_max = torch.clamp_min(lam[:, :1], 1e-30)
    keep = lam > 1e-12 * lam_max
    inv = torch.where(keep, torch.rsqrt(torch.where(keep, lam, 1.0)), 0.0)
    return torch.bmm(y, e) * inv[:, None, :]


def newton_schulz_orthonormalize(y: torch.Tensor, iters: int = 30):
    """Matmul-only orthonormalization by coupled Newton–Schulz.

    Iterates ``T = (3I − Z·Yk)/2; Yk ← Yk·T; Z ← T·Z`` on ``Yk =
    G/tr(G)`` (G = YᵀY), converging to ``Z → (G/tr(G))^{-1/2}``; then
    ``Q = Y·Z/√tr(G)``. All-zero items give all-zero Q."""
    y = y.float()
    g = _gram(y)
    k = g.shape[-1]
    eye = torch.eye(k, dtype=torch.float32, device=y.device)
    c = torch.diagonal(g, dim1=-2, dim2=-1).sum(-1)   # ≥ λ_max for PSD
    live = c > 1e-30
    c_ = torch.where(live, c, 1.0)[:, None, None]
    yk = g / c_
    zk = eye.expand(g.shape).clone()
    for _ in range(iters):
        t = 1.5 * eye - 0.5 * torch.bmm(zk, yk)
        yk, zk = torch.bmm(yk, t), torch.bmm(t, zk)
    q = torch.bmm(y, zk * torch.rsqrt(c_))
    return torch.where(live[:, None, None], q, 0.0)


def _safe_inv(s: torch.Tensor) -> torch.Tensor:
    """1/s where s is meaningfully nonzero (against the item's s_max), 0
    elsewhere — the division guard for back-solving singular vectors."""
    s_max = torch.clamp_min(s.amax(dim=-1, keepdim=True), 1e-30)
    keep = s > 1e-12 * s_max
    return torch.where(keep, 1.0 / torch.where(keep, s, 1.0), 0.0)


_HELD = threading.local()


@contextmanager
def held_sketches(store: dict):
    """Within this context :func:`gaussian_sketch` keeps each sketch it
    draws in ``store``, by its seeds, shape and device, and hands the
    held one back for the same seeds: the sketch that a captured solve
    reads at every replay (the seeds of an item are fixed across LC
    boundaries). Outside a capture it saves the draws."""
    old = getattr(_HELD, "store", None)
    _HELD.store = store
    try:
        yield
    finally:
        _HELD.store = old


def gaussian_sketch(keys: torch.Tensor, n: int, k: int,
                    device) -> torch.Tensor:
    """(I, n, k) standard normal sketch, item i drawn from its own
    ``torch.Generator`` seeded with ``keys[i]`` (an (I,) int64 tensor of
    seeds on the CPU, ``CompressionTask.item_keys``): no two items share
    a sketch and a rerun draws the same one. Within
    :func:`held_sketches` a sketch drawn before is handed back."""
    seeds = tuple(keys.tolist())
    if torch.device(device).type == "meta":
        return torch.empty((len(seeds), n, k), dtype=torch.float32,
                           device="meta")
    store = getattr(_HELD, "store", None)
    key = (seeds, n, k, torch.device(device))
    if store is not None and key in store:
        return store[key]
    out = torch.empty((len(seeds), n, k), dtype=torch.float32,
                      device=device)
    for i, seed in enumerate(seeds):
        gen = torch.Generator(device=device).manual_seed(int(seed))
        out[i] = torch.randn((n, k), generator=gen, dtype=torch.float32,
                             device=device)
    if store is not None:
        store[key] = out
    return out


def rsvd_spectrum_batched(w: torch.Tensor, keys: torch.Tensor,
                          k_sketch: int, power_iters: int = 2,
                          orth: str = "jacobi", orth_sweeps: int = 6,
                          finish_sweeps: int = 12,
                          q0: torch.Tensor | None = None):
    """Batched top-``k_sketch`` spectrum of a packed item stack.

    ``w``: (I, m, n) f32; ``keys``: (I,) int64 per-item sketch seeds.
    Returns ``(u (I, m, k), s (I, k), v (I, n, k))`` with ``w ≈ u ·
    diag(s) · vᵀ`` on the top-k subspace.

    ``q0`` (optional, (I, m, r0)) warm-starts the range finder: the
    previous C step's left factor seeds the sketch basis, topped up with
    fresh Gaussian directions. Zero columns of ``q0`` (masked ranks, a
    rank-0 previous Θ, all-zero items) are backfilled with the fresh
    directions they shadow, so the warm basis never has less width than
    the cold one. The exact Gram path ignores ``q0``.

    ``orth``: ``"jacobi"`` (default) or ``"newton_schulz"``.

    When ``k_sketch ≥ min(m, n)`` the exact Gram path runs instead:
    eigendecompose ``WWᵀ`` (or ``WᵀW``, whichever is smaller) and
    back-solve the other factor — deterministic, keys unused.
    """
    n_items, m, n = w.shape
    w = w.float()
    k = min(k_sketch, m, n)

    if k >= min(m, n):                       # exact Gram path
        if m <= n:
            lam, e = jacobi_eigh_batched(torch.bmm(w, w.transpose(1, 2)),
                                         sweeps=finish_sweeps)
            s = torch.sqrt(torch.clamp_min(lam, 0.0))
            u = e
            v = torch.bmm(w.transpose(1, 2), u) * _safe_inv(s)[:, None, :]
        else:
            lam, e = jacobi_eigh_batched(_gram(w), sweeps=finish_sweeps)
            s = torch.sqrt(torch.clamp_min(lam, 0.0))
            v = e
            u = torch.bmm(w, v) * _safe_inv(s)[:, None, :]
        return u[:, :, :k], s[:, :k], v[:, :, :k]

    # randomized range finder (Halko et al.), one sketch per item
    if orth not in ("jacobi", "newton_schulz"):
        raise ValueError(f"orth must be 'jacobi' or 'newton_schulz', "
                         f"got {orth!r}")
    orthonormalize = (partial(orthonormal_columns_batched,
                              sweeps=orth_sweeps)
                      if orth == "jacobi" else newton_schulz_orthonormalize)
    y_fresh = torch.bmm(w, gaussian_sketch(keys, n, k, w.device))
    if q0 is not None:
        r0 = min(q0.shape[-1], k)
        q0 = q0.float()[:, :, :r0]
        live = torch.sum(q0 * q0, dim=1, keepdim=True) > 0.0
        head = torch.where(live, q0, y_fresh[:, :, :r0])
        y0 = torch.cat([head, y_fresh[:, :, r0:]], dim=-1)
    else:
        y0 = y_fresh
    q = orthonormalize(y0)
    for _ in range(power_iters):
        q = orthonormalize(torch.bmm(w, torch.bmm(w.transpose(1, 2), q)))
    b = torch.bmm(q.transpose(1, 2), w)                   # (I, k, n)
    lam, e = jacobi_eigh_batched(torch.bmm(b, b.transpose(1, 2)),
                                 sweeps=finish_sweeps)
    s = torch.sqrt(torch.clamp_min(lam, 0.0))
    u = torch.bmm(q, e)
    v = torch.bmm(b.transpose(1, 2), e) * _safe_inv(s)[:, None, :]
    return u, s, v
