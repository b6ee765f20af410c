"""Grouped C-step dispatch (the paper's "C steps can be run in parallel").

Port of ``src/repro/core/grouping.py`` without a mesh or planner. Grouped
dispatch:

1. partitions resolved tasks by ``CompressionTask.group_signature`` —
   (scheme key, view item shape, dtype);
2. concatenates each group's *items* (stacked views contribute their
   stack, single-array views one item) along a leading axis;
3. packs the warm-start Θ trees the same way (``pack_thetas``);
4. solves each group with ONE call: a named batched solver resolved
   through ``repro_torch.kernels.dispatch`` when the scheme opts in (one
   kernel launch per solver step for the whole group on the card), else
   ``scheme.compress`` item by item;
5. slices Θ and Δ(Θ) back out per task.

Under the batched signature, schemes that move a hyperparameter into a
per-item operand (ℓ0 pruning's κ, k-means' live-K count, low-rank's
target rank, rank selection's α) group across values of it: mixed-κ,
mixed-K, mixed-rank and mixed-α tasks share one launch. Θ leaves whose
shapes differ across members (mixed-K codebooks, mixed-rank factors)
pack with trailing-dim padding up to the group maximum and slice back to
each task's own shapes after the solve. Stochastic solvers
(``scheme.wants_key``) get per-item sketch seeds, by task name and
within-task index (``CompressionTask.item_keys``, the same on the grouped
and per-task paths), appended as the last operand, or passed as the
``key=`` argument on the item-by-item path.

The JAX package's mesh sharding and roofline planner (with the group
chunking it decides) are not ported; its planner is bit-neutral off the
TPU, so no numbers are lost.
"""
from __future__ import annotations

from typing import Sequence

import torch

from repro_torch.core.schemes.base import (
    add_leading_axis, drop_leading_axis, map_items, pack_thetas,
    pack_thetas_padded, slice_theta_like, unpack_thetas)
from repro_torch.core.tasks import CompressionTask


def _task_solver(scheme, backend, device):
    """(solver_fn, actual_backend) for a scheme under a requested
    backend, or (None, None) → the item-by-item path."""
    if backend in (None, "off") or not scheme.kernel_dispatch_ready():
        return None, None
    from repro_torch.kernels.dispatch import lookup
    return lookup(scheme.solver, backend, device)


def build_groups(tasks: Sequence[CompressionTask], xs: dict,
                 backend: str | None = None, device=None,
                 for_init: bool = False) -> list[list[CompressionTask]]:
    """Partition tasks into groups of equal group signature.

    ``xs`` maps task name → compressible tensor (only shape and dtype are
    read). Non-groupable tasks come back as singleton groups; group order
    follows first appearance. With a kernel ``backend`` active,
    dispatch-ready schemes group by their ``batch_key()``, but only when
    the solver resolves in the registry."""
    groups: dict = {}
    order: list = []
    solos: list[list[CompressionTask]] = []
    for t in tasks:
        batched = _task_solver(t.scheme, backend, device)[0] is not None
        sig = t.group_signature(xs[t.name], batched=batched)
        if for_init and sig is not None:
            # init-only hyperparameters (a DP warm start) are invisible
            # to group_key; the init grouping identity must include them
            ik = t.scheme.init_key()
            sig = None if ik is None else (sig, ik)
        if sig is None:
            solos.append([t])
            continue
        if sig not in groups:
            groups[sig] = []
            order.append(sig)
        groups[sig].append(t)
    return [groups[s] for s in order] + solos


def describe_groups(tasks: Sequence[CompressionTask], xs: dict,
                    backend: str | None = None, device=None) -> list[dict]:
    """The grouping a C step would use: per group its scheme, item shape,
    tasks, item count, whether it is solved as a group, and — honestly —
    the registry ``solver`` and resolved ``backend`` that will run
    (``None`` = item-by-item scheme program)."""
    out = []
    for group in build_groups(tasks, xs, backend=backend, device=device):
        t0 = group[0]
        sig = t0.group_signature(xs[t0.name])
        solver_fn, actual = _task_solver(t0.scheme, backend, device)
        out.append({
            "scheme": t0.scheme.name,
            "item_shape": t0.view.item_shape(xs[t0.name]),
            "tasks": [t.name for t in group],
            "items": sum(t.view.item_count(xs[t.name]) for t in group),
            # singleton groups run the per-task path even when groupable
            "grouped": sig is not None and len(group) > 1,
            "solver": t0.scheme.solver if solver_fn is not None else None,
            "backend": actual,
        })
    return out


def _packed_keys(group: Sequence[CompressionTask],
                 counts: list[int]) -> torch.Tensor:
    """One (Σ items,) int64 seed tensor (CPU) for a ``wants_key`` group:
    the single source of seed packing for every grouped path (solver
    operands, the item-by-item path, grouped init)."""
    return torch.cat([t.item_keys(n) for t, n in zip(group, counts)])


def _group_operands(group: Sequence[CompressionTask], counts: list[int],
                    device):
    """Concatenate each task's per-item solver operands into the packed
    form ``compress_batched`` consumes (mixed-κ: one (Σ items,) tensor).
    Schemes with ``wants_key`` get their packed seeds as the LAST
    operand."""
    per_task = [t.scheme.batch_operands(n, device)
                for t, n in zip(group, counts)]
    operands = tuple(torch.cat(parts, dim=0) for parts in zip(*per_task))
    if group[0].scheme.wants_key:
        operands = operands + (_packed_keys(group, counts),)
    return operands


def _group_solve(scheme, solver_fn, mu):
    """The packed-group solve: ``solve(items, packed_theta, *operands) →
    (new_theta, decompressed items)``."""
    def _solve(xi, ti, *ops):
        if solver_fn is not None:
            nt = scheme.compress_batched(solver_fn, xi, ti, ops, mu=mu)
        elif scheme.wants_key:
            (keys,) = ops
            nt = map_items(
                lambda x, th, k: scheme.compress(x, th, mu=mu, key=k),
                xi, ti, keys)
        else:
            nt = map_items(lambda x, th: scheme.compress(x, th, mu=mu),
                           xi, ti)
        return nt, map_items(scheme.decompress, nt)

    return _solve


def _pack_group(group: Sequence[CompressionTask], xs: dict, thetas: dict,
                counts: list[int], solver_fn, device):
    """``(arrays, thetas_lead)``: ``arrays`` is ``(items, packed_theta,
    *operands)``, ``thetas_lead`` the per-task Θs with a leading item
    axis (the slice-back templates)."""
    items = torch.cat([t.view.to_items(xs[t.name]) for t in group], dim=0)
    thetas_lead = [thetas[t.name] if t.view.stacked
                   else add_leading_axis(thetas[t.name])
                   for t in group]
    # only what the solves read of the previous Θ is packed (a codebook,
    # not an assignment as large as the weights)
    warm = [t.scheme.warm_start(th) for t, th in zip(group, thetas_lead)]
    if solver_fn is not None:
        # batched solvers take Θ leaves padded to the group max trailing
        # shape (mixed-K codebooks → K_max, mixed-rank factors → R_max)
        packed = pack_thetas_padded(warm)
        operands = _group_operands(group, counts, device)
    else:
        packed = pack_thetas(warm)
        operands = ((_packed_keys(group, counts),)
                    if group[0].scheme.wants_key else ())
    return (items, packed) + operands, thetas_lead


def solve_task(task: CompressionTask, x, theta, mu,
               backend: str | None = None, device=None):
    """One task's C solve, kernel-dispatched when the scheme opts in: the
    named solver runs on the task's own item stack (a single-array view
    is a 1-item stack). Falls back to ``scheme.compress``."""
    solver_fn, _ = _task_solver(task.scheme, backend, device)
    if solver_fn is None:
        return task.scheme_compress(x, theta, mu)
    items = task.view.to_items(x)
    ti = theta if task.view.stacked else add_leading_axis(theta)
    n_items = task.view.item_count(x)
    operands = task.scheme.batch_operands(n_items, items.device)
    if task.scheme.wants_key:
        operands = operands + (task.item_keys(n_items),)
    nt = task.scheme.compress_batched(solver_fn, items, ti, operands, mu=mu)
    return nt if task.view.stacked else drop_leading_axis(nt)


def grouped_compress(tasks: Sequence[CompressionTask], xs: dict,
                     thetas: dict, mu, backend: str | None = None,
                     device=None) -> dict:
    """One C step over all tasks with grouped dispatch → ``{task_name:
    (new_theta, a_arr)}``, ``a_arr`` the decompressed Δ(Θ) in the task's
    compressible shape."""
    out = {}
    for group in build_groups(tasks, xs, backend=backend, device=device):
        if len(group) == 1:
            # singleton: per-task path (also the non-groupable fallback),
            # kernel-dispatched when the scheme opts in
            t = group[0]
            theta = solve_task(t, xs[t.name], thetas[t.name], mu,
                               backend=backend, device=device)
            out[t.name] = (theta, t.scheme_decompress(theta))
            continue

        # equal batched signature ⇒ same class and batch_key; operand-
        # ized hyperparameters (κ, K) ride in packed per-item tensors
        scheme = group[0].scheme
        solver_fn, _ = _task_solver(scheme, backend, device)
        counts = [t.view.item_count(xs[t.name]) for t in group]
        arrays, thetas_lead = _pack_group(group, xs, thetas, counts,
                                          solver_fn, device)
        new_packed, a_packed = _group_solve(scheme, solver_fn, mu)(*arrays)

        theta_parts = unpack_thetas(new_packed, counts)
        if solver_fn is not None:
            # trailing-dim padding back off: every task's Θ lands in its
            # own LC-state shapes (live entries lead)
            theta_parts = [slice_theta_like(th, old) for th, old
                           in zip(theta_parts, thetas_lead)]
        off = 0
        for t, th, n in zip(group, theta_parts, counts):
            a_arr = t.view.from_items(a_packed[off:off + n])
            off += n
            if not t.view.stacked:
                th = drop_leading_axis(th)
            out[t.name] = (th, a_arr)
    return out


def grouped_init(tasks: Sequence[CompressionTask], xs: dict) -> dict:
    """Direct compression Θ^DC = Π(w̄) with grouped dispatch: tasks group
    by their (non-batched) signature extended with ``scheme.init_key()``,
    and each group runs ``scheme.init`` over its packed items. Returns
    ``{task_name: (theta, a_arr)}``."""
    out = {}
    for group in build_groups(tasks, xs, for_init=True):
        if len(group) == 1:
            t = group[0]
            theta = t.scheme_init(xs[t.name])
            out[t.name] = (theta, t.scheme_decompress(theta))
            continue

        scheme = group[0].scheme  # identical init_key ⇒ same static cfg
        items = torch.cat([t.view.to_items(xs[t.name]) for t in group],
                          dim=0)
        counts = [t.view.item_count(xs[t.name]) for t in group]
        if scheme.wants_key:
            theta_packed = map_items(
                lambda x, k: scheme.init(x, key=k), items,
                _packed_keys(group, counts))
        else:
            theta_packed = map_items(scheme.init, items)
        a_packed = map_items(scheme.decompress, theta_packed)

        off = 0
        for t, th, n in zip(group, unpack_thetas(theta_packed, counts),
                            counts):
            a_arr = t.view.from_items(a_packed[off:off + n])
            off += n
            out[t.name] = (th if t.view.stacked else drop_leading_axis(th),
                           a_arr)
    return out
