"""Kernel dispatch layer: named batched C-step solvers, per backend.

Port of ``src/repro/kernels/dispatch.py``. A scheme declares a solver
name (``CompressionScheme.solver``) and implements ``compress_batched``
against the solver's calling convention; the grouped C step resolves the
name to an implementation per backend:

  ============  =====================================================
  backend       implementation
  ============  =====================================================
  ``cuda``      the kernel-path driver: the CUDA kernels on CUDA
                tensors; on CPU tensors each kernel's plain version
                (the counterpart of JAX's ``interpret``)
  ``torch``     plain batched tensor programs (≙ JAX's ``jnp``)
  ============  =====================================================

Requests are ``auto``, ``torch``, ``cuda`` and ``off``. ``auto`` resolves
by where the tensors live: ``cuda`` for CUDA tensors, ``torch`` for CPU
tensors. ``off`` (or ``None``) disables dispatch: every scheme runs item
by item. A backend gap (solver known, backend missing) falls back to the
solver's ``torch`` implementation, so the result is still batched; an
unknown solver resolves to ``(None, None)``.

Solver calling conventions (packed leading item axis ``I``):

* ``kmeans_lloyd(w (I,P) f32, codebooks0 (I,K_max) f32, kvalid (I,) i32,
  *, iters) -> (codebooks (I,K_max) f32, assign (I,P) i32)``
* ``topk_mask(w (I,P) f32, kappa (I,) i32) -> theta (I,P) f32``
* ``project_l1_ball(w (I,P) f32, radius (I,) f32) -> theta (I,P) f32``
* ``soft_threshold(w (I,P) f32, alpha (I,) f32, mu) -> theta (I,P) f32``
* ``lowrank_rsvd(w (I,m,n) f32, rank (I,) i32, keys (I,) i64, *, r_max,
  u0=None) -> (u (I,m,r_max), v (I,n,r_max))``
* ``rank_select(w (I,m,n) f32, alpha (I,) f32, keys (I,) i64, mu, *,
  r_max, cost, u0=None) -> (u, v, rank (I,) i32)``

``keys`` are the per-item sketch seeds (``CompressionTask.item_keys``),
a CPU tensor whatever device the items are on.

An implementation is *chunk-exact* (:func:`chunk_exact`) when a call on
a slice of the items gives those items the bits of the call on all of
them, so that the planner may split its group into several launches
(``core/grouping.py:_run_group_solve``). Float reductions and cuBLAS's
batched products are not: their order depends on the batch (on the
H100, ``torch.bmm`` of the low-rank solvers' Gram products and
``torch.cumsum``/``sum`` over f32 rows change bits with the batch size,
PERF.md, PR 22); the planner keeps such groups in one launch.
"""
from __future__ import annotations

import inspect
from functools import partial
from typing import Callable

import torch

BACKENDS = ("torch", "cuda")
#: user-facing request values (LCAlgorithm.cstep_backend)
REQUESTS = ("auto", "torch", "cuda", "off")

_REGISTRY: dict[str, dict[str, Callable]] = {}
_CHUNK_EXACT: set[tuple[str, str]] = set()


def register(solver: str, backend: str, fn: Callable,
             chunk_exact: bool = False) -> None:
    """Register ``fn`` as the ``backend`` implementation of ``solver``;
    ``chunk_exact`` declares it per-item exact under any batch."""
    assert backend in BACKENDS, backend
    _REGISTRY.setdefault(solver, {})[backend] = fn
    if chunk_exact:
        _CHUNK_EXACT.add((solver, backend))
    else:
        _CHUNK_EXACT.discard((solver, backend))


def chunk_exact(solver: str | None, backend: str) -> bool:
    """Whether the ``backend`` implementation of ``solver`` gives each
    item the same bits whatever the other items of its call. The
    item-by-item path (``solver`` None) solves each item alone."""
    return solver is None or (solver, backend) in _CHUNK_EXACT


def resolve_backend(requested: str | None, device) -> str | None:
    """Requested backend → the backend that will run on tensors on
    ``device``. ``None``/``"off"`` disables dispatch; ``"auto"`` is
    ``cuda`` on a CUDA device and ``torch`` elsewhere."""
    if requested is None or requested == "off":
        return None
    if requested not in REQUESTS:
        raise ValueError(
            f"cstep backend must be one of {REQUESTS}, got {requested!r}")
    if requested == "auto":
        return "cuda" if torch.device(device).type == "cuda" else "torch"
    return requested


def lookup(solver: str | None, requested: str | None,
           device) -> tuple[Callable | None, str | None]:
    """(implementation, actual backend) for a solver name, or ``(None,
    None)`` when dispatch is off or the name is unregistered (the caller
    then runs the scheme item by item). A backend gap falls back to the
    registered ``torch`` solver."""
    backend = resolve_backend(requested, device)
    if backend is None or solver is None or solver not in _REGISTRY:
        return None, None
    impls = _REGISTRY[solver]
    if backend not in impls:
        if "torch" in impls:
            return impls["torch"], "torch"
        return None, None
    return impls[backend], backend


def solver_table() -> dict[str, tuple[str, ...]]:
    """{solver name: registered backends} — for docs and diagnostics."""
    return {name: tuple(sorted(impls)) for name, impls in
            sorted(_REGISTRY.items())}


def registry_entries() -> dict[str, dict[str, Callable]]:
    """Shallow copy of the raw registry: {solver: {backend: impl}}."""
    return {name: dict(impls) for name, impls in _REGISTRY.items()}


def solver_signature(solver: str,
                     backend: str = "torch") -> tuple[str, ...] | None:
    """Positional parameter names of a registered implementation
    (keyword-only config like ``iters`` excluded), unwrapping
    ``functools.partial``; ``None`` when the entry is missing."""
    fn = _REGISTRY.get(solver, {}).get(backend)
    if fn is None:
        return None
    while isinstance(fn, partial):
        fn = fn.func
    try:
        sig = inspect.signature(fn)
    except (TypeError, ValueError):
        return None
    return tuple(
        p.name for p in sig.parameters.values()
        if p.kind in (p.POSITIONAL_ONLY, p.POSITIONAL_OR_KEYWORD))


# ----------------------------------------------------------------------
# built-in solvers
# ----------------------------------------------------------------------
from repro_torch.kernels.kmeans import ops as _kops    # noqa: E402
from repro_torch.kernels.lowrank import ops as _lops   # noqa: E402
from repro_torch.kernels.prune import ops as _pops     # noqa: E402

# chunk-exact: K1 with its group's partition (build.group_partition; on
# CPU tensors the plain version, whose float sums are held to that only
# at the tests' sizes), K2's integer counts, K3 and elementwise maps, a
# stable argsort; not: float sums and scans over rows, batched matmuls
register("kmeans_lloyd", "torch", partial(_kops.kmeans_batched, impl="torch"))
register("kmeans_lloyd", "cuda", partial(_kops.kmeans_batched, impl="kernel"),
         chunk_exact=True)
register("topk_mask", "torch", partial(_pops.topk_mask_batched, impl="torch"),
         chunk_exact=True)
register("topk_mask", "cuda", partial(_pops.topk_mask_batched, impl="kernel"),
         chunk_exact=True)
# plain tensor programs only: the backend-gap rule serves `cuda` requests
register("project_l1_ball", "torch", _pops.project_l1_ball_batched)
register("soft_threshold", "torch", _pops.soft_threshold_batched,
         chunk_exact=True)
register("lowrank_rsvd", "torch", _lops.lowrank_rsvd_batched)
register("rank_select", "torch", _lops.rank_select_batched)
