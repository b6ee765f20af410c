"""Grouped C-step dispatch (the paper's "C steps can be run in parallel").

Port of ``src/repro/core/grouping.py`` without a mesh. Grouped dispatch:

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

The planner (``planner="on"``, ``repro_torch.analysis.cost``) plans every
multi-task group from its packed shapes: it re-picks the backend among
the solver's registered implementations (on the card and on the CPU the
static rule's choice) and splits a group whose packed working set exceeds
the chunk budget (a quarter of the device's memory) into launches over
contiguous item slices, where the solver's launches over slices are
exact (``kernels/dispatch.py:chunk_exact``; a low-rank group, whose
batched products depend on the batch, stays in one launch). A chunked
group is packed, solved and sliced back one chunk at a time: only the
warm-start Θ and the per-item operands are packed group-wide (with the
group's trailing-dim padding), the items chunk by chunk, so the group's
transient working set is a chunk's. Each chunk launches with its group's
partition (``kernels/build.py:group_partition``), so a chunked solve
equals the one launch bit for bit. :func:`compile_group` captures a
group's packed solve as a CUDA graph, once per group signature
(``cost.get_executable``), μ fed as a 0-d device tensor. The JAX
package's mesh sharding is not ported.
"""
from __future__ import annotations

from typing import Sequence

import torch

from repro_torch.core.schemes.base import (
    add_leading_axis, drop_leading_axis, map_items, pack_thetas,
    pack_thetas_padded, slice_theta_like, unpack_thetas)
from repro_torch.core.tasks import CompressionTask
from repro_torch.tree import tree_leaves, tree_map


def _task_solver(scheme, backend, device):
    """(solver_fn, actual_backend) for a scheme under a requested
    backend, or (None, None) → the item-by-item path."""
    if backend in (None, "off") or not scheme.kernel_dispatch_ready():
        return None, None
    from repro_torch.kernels.dispatch import lookup
    return lookup(scheme.solver, backend, device)


def _meta(x: torch.Tensor) -> torch.Tensor:
    """A tensor's shape and dtype, on no device (the port's
    ``jax.ShapeDtypeStruct``)."""
    return torch.empty(x.shape, dtype=x.dtype, device="meta")


def _plan_multi_group(group, xs: dict, thetas: dict | None,
                      counts: list[int], solver_fn, backend, device):
    """Plan one multi-task group through the cost model, from shapes
    only: ``xs`` and ``thetas`` are read as meta tensors (``thetas``
    None: Θ's shapes unknown, the items alone are planned).

    The planner never changes *grouping*: ``solver_fn`` (resolved by the
    static rule) already fixed whether the group packs for a named
    batched solver; the plan re-picks the backend among the registered
    implementations of that solver and decides the chunking, for solvers
    whose launches over item slices are exact (``dispatch.chunk_exact``).
    The working set is the packed operands (items, warm-start Θ, per-item
    operands) and the outputs (Θ, Δ(Θ)). Plans are cached in
    ``repro_torch.analysis.cost`` on the group signature, so repeated LC
    boundaries replan nothing."""
    from repro_torch.analysis import cost
    from repro_torch.kernels.dispatch import chunk_exact, solver_table
    t0 = group[0]
    batched = solver_fn is not None
    sig = t0.group_signature(xs[t0.name], batched=batched)
    xs_m = {t.name: _meta(xs[t.name]) for t in group}
    fallbacks = () if batched else ("item-by-item-path",)
    if thetas is None:
        arrays = out = (_item_packer(group, xs_m, counts)(0, sum(counts)),)
        fallbacks += ("theta-shapes-unknown:planned-from-the-items",)
    else:
        th_m = {t.name: tree_map(_meta, thetas[t.name]) for t in group}
        arrays, thetas_lead = _pack_group(group, xs_m, th_m, counts,
                                          solver_fn, "meta")
        out = (pack_thetas_padded(thetas_lead), arrays[0])
    solver = t0.scheme.solver if batched else None
    registered = solver_table().get(solver, ())
    return cost.plan_group(
        sig, sum(counts), arrays, out,
        requested_backend=str(backend) if backend is not None else "off",
        solver=solver, registered=registered,
        chunk_exact=tuple(b for b in registered if chunk_exact(solver, b)),
        base_fallbacks=fallbacks, hw=cost.detect_hardware(device))


def _apply_plan(scheme, solver_fn, plan, device):
    """Re-resolve the group's solver under the planner's backend. Only
    swaps among registered implementations of the *same* solver; an
    item-by-item group (``solver_fn is None``) stays item by item."""
    if plan is None or solver_fn is None:
        return solver_fn
    from repro_torch.kernels.dispatch import lookup
    fn, _ = lookup(scheme.solver, plan.backend, device)
    return fn if fn is not None else solver_fn


def _device_of(xs: dict, tasks, device):
    return device if device is not None else xs[tasks[0].name].device


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
                    backend: str | None = None, device=None,
                    planner: str | None = None) -> list[dict]:
    """The grouping a C step would use: per group its scheme, item shape,
    tasks, item count, whether it is solved as a group, and — honestly —
    the registry ``solver`` and resolved ``backend`` that will run
    (``None`` = item-by-item scheme program).

    ``planner="on"`` attaches each multi-task group's
    :class:`repro_torch.analysis.cost.GroupPlan` as a ``plan`` dict (the
    modeled roofline terms, the chosen backend and chunks, the recorded
    fallbacks): the same cached plan the C step will use, with Θ's
    shapes from the scheme's init on meta tensors (nothing runs). When
    planned, ``backend`` reports the planner's choice."""
    out = []
    for group in build_groups(tasks, xs, backend=backend, device=device):
        t0 = group[0]
        sig = t0.group_signature(xs[t0.name])
        grouped = sig is not None and len(group) > 1
        solver_fn, actual = _task_solver(t0.scheme, backend, device)
        counts = [t.view.item_count(xs[t.name]) for t in group]
        plan_dict = None
        if planner == "on" and grouped:
            try:
                thetas = {t.name: t.scheme_init(_meta(xs[t.name]))
                          for t in group}
            except (RuntimeError, NotImplementedError):
                # an init that reads values (a DP warm start, ternary
                # thresholds) has no shapes-only run: planned without Θ
                thetas = None
            plan = _plan_multi_group(group, xs, thetas, counts, solver_fn,
                                     backend,
                                     _device_of(xs, group, device))
            plan_dict = plan.as_dict()
            if solver_fn is not None:
                actual = plan.backend
        out.append({
            "scheme": t0.scheme.name,
            "item_shape": t0.view.item_shape(xs[t0.name]),
            "tasks": [t.name for t in group],
            "items": sum(counts),
            # singleton groups run the per-task path even when groupable
            "grouped": grouped,
            "solver": t0.scheme.solver if solver_fn is not None else None,
            "backend": actual,
            "plan": plan_dict,
        })
    return out


def _chunk_bounds(n_items: int, n_chunks: int) -> list[tuple[int, int]]:
    """Contiguous item-axis slices splitting ``n_items`` into
    ``n_chunks`` near-equal launches (first chunks take the remainder)."""
    n_chunks = max(1, min(int(n_chunks), n_items))
    base, rem = divmod(n_items, n_chunks)
    bounds, lo = [], 0
    for i in range(n_chunks):
        hi = lo + base + (1 if i < rem else 0)
        bounds.append((lo, hi))
        lo = hi
    return bounds


def _run_group_solve(solve, arrays: tuple, n_items: int,
                     n_chunks: int = 1) -> list:
    """Run a packed-group solve in ``n_chunks`` launches over contiguous
    item slices; returns ``[(lo, hi, (theta, a)), ...]``, one entry a
    launch, ``theta`` and ``a`` holding items ``lo:hi``.

    ``arrays`` are trees whose every leaf carries the packed item axis,
    except that ``arrays[0]`` (the items) may be a function ``items(lo,
    hi)`` that packs a slice on demand: a chunk's items then exist only
    for its launch. ``solve`` is :func:`_group_solve`'s pair: ``compress(
    *arrays)`` → new Θ, then ``decompress(Θ)`` → the decompressed items,
    once the chunk's items are let go. Every launch runs with the whole
    group's partition (``build.group_partition``) and the batched solvers
    are per-item exact where the planner chunks them
    (``dispatch.chunk_exact``), so the chunks together equal one launch
    bit for bit.
    """
    from repro_torch.kernels.build import group_partition
    compress, decompress = solve
    items, rest = arrays[0], arrays[1:]
    parts = []
    with group_partition(n_items):
        for lo, hi in _chunk_bounds(n_items, n_chunks):
            xi = items(lo, hi) if callable(items) else items[lo:hi]
            chunk = tuple(tree_map(lambda x: x[lo:hi], a) for a in rest)
            theta = compress(xi, *chunk)
            del xi, chunk
            parts.append((lo, hi, (theta, decompress(theta))))
    return parts


def _task_results(parts: list, counts: list[int]) -> list:
    """Slice :func:`_run_group_solve`'s launches back per task: ``[(Θ
    with its leading item axis, Δ items), ...]`` in ``counts`` order. A
    task within one launch gets views of it; one spread over several
    gets its pieces concatenated."""
    out, off = [], 0
    for n in counts:
        pieces = []
        for lo, hi, (theta, a) in parts:
            a0, b0 = max(lo, off), min(hi, off + n)
            if a0 < b0:
                pieces.append((
                    tree_map(lambda x: x[a0 - lo:b0 - lo], theta),
                    a[a0 - lo:b0 - lo]))
        if len(pieces) == 1:
            out.append(pieces[0])
        else:
            out.append((pack_thetas([p[0] for p in pieces]),
                        torch.cat([p[1] for p in pieces], dim=0)))
        off += n
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
    """The packed-group solve as ``(compress, decompress)``:
    ``compress(items, packed_theta, *operands) → new_theta`` and
    ``decompress(new_theta) → decompressed items``."""
    def _compress(xi, ti, *ops):
        if solver_fn is not None:
            return scheme.compress_batched(solver_fn, xi, ti, ops, mu=mu)
        if scheme.wants_key:
            (keys,) = ops
            return map_items(
                lambda x, th, k: scheme.compress(x, th, mu=mu, key=k),
                xi, ti, keys)
        return map_items(lambda x, th: scheme.compress(x, th, mu=mu),
                         xi, ti)

    return _compress, lambda nt: map_items(scheme.decompress, nt)


def _item_packer(group: Sequence[CompressionTask], xs: dict,
                 counts: list[int]):
    """``items(lo, hi)``: the packed items ``lo:hi`` of the group, each
    task's input read from ``xs`` while its rows are copied in (a slice
    that lies in one task is that task's own items, not a copy)."""
    def items(lo, hi):
        out, off = None, 0
        for t, n in zip(group, counts):
            a, b = max(lo, off), min(hi, off + n)
            if a < b:
                x = t.view.to_items(xs[t.name])[a - off:b - off]
                if b - a == hi - lo:
                    return x
                if out is None:
                    out = x.new_empty((hi - lo, *x.shape[1:]))
                out[a - lo:b - lo].copy_(x)
            off += n
        return out

    return items


def _pack_warm(group: Sequence[CompressionTask], thetas: dict,
               counts: list[int], solver_fn, device):
    """``(packed, thetas_lead)``: ``packed`` is ``(packed_theta,
    *operands)`` for the whole group, ``thetas_lead`` the per-task Θs
    with a leading item axis (the slice-back templates)."""
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
    return (packed,) + operands, thetas_lead


def _pack_group(group: Sequence[CompressionTask], xs: dict, thetas: dict,
                counts: list[int], solver_fn, device):
    """``(arrays, thetas_lead)`` with ``arrays`` = ``(items,
    packed_theta, *operands)`` for the whole group."""
    warm, thetas_lead = _pack_warm(group, thetas, counts, solver_fn,
                                   device)
    items = _item_packer(group, xs, counts)(0, sum(counts))
    return (items,) + warm, thetas_lead


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
                     device=None, planner: str | None = None) -> dict:
    """One C step over all tasks with grouped dispatch → ``{task_name:
    (new_theta, a_arr)}``, ``a_arr`` the decompressed Δ(Θ) in the task's
    compressible shape.

    ``xs`` maps task name → input; it may make each input when read
    (``LCAlgorithm``'s C step does), and is read once for the shapes and
    again where the input's items are packed, so only the group or chunk
    being packed holds its inputs. ``planner="on"`` routes every
    multi-task group through the cost model (``repro_torch.analysis.
    cost``): the backend re-picked among the solver's registered
    implementations, oversized groups split into launches over item
    slices. Results are bit-identical to ``planner=None`` (the planner
    resolves the static rule's backend, and chunks equal the one
    launch); plans are cached, so repeated boundaries replan nothing."""
    shapes = {t.name: _meta(xs[t.name]) for t in tasks}
    out = {}
    for group in build_groups(tasks, shapes, backend=backend, device=device):
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
        counts = [t.view.item_count(shapes[t.name]) for t in group]
        dev = _device_of(xs, group, device)
        n_chunks = 1
        if planner == "on":
            plan = _plan_multi_group(group, shapes, thetas, counts,
                                     solver_fn, backend, dev)
            n_chunks = plan.n_chunks
            solver_fn = _apply_plan(scheme, solver_fn, plan, dev)
        warm, thetas_lead = _pack_warm(group, thetas, counts, solver_fn,
                                       dev)
        parts = _run_group_solve(
            _group_solve(scheme, solver_fn, mu),
            (_item_packer(group, xs, counts),) + warm, sum(counts),
            n_chunks)
        for t, (th, a), old in zip(group, _task_results(parts, counts),
                                   thetas_lead):
            if solver_fn is not None:
                # trailing-dim padding back off: every task's Θ lands in
                # its own LC-state shapes (live entries lead)
                th = slice_theta_like(th, old)
            a_arr = t.view.from_items(a)
            if not t.view.stacked:
                th = drop_leading_axis(th)
            out[t.name] = (th, a_arr)
    return out


class CaptureError(RuntimeError):
    """A group solve that a CUDA graph cannot take (a host sync, a
    generator seeded inside the solve, a host-to-device copy)."""


class GroupExecutable:
    """:func:`compile_group`'s executable: one group's packed solve as a
    program of ``repro_torch.graphs`` (a CUDA graph on the card, captured
    at the first call and replayed after; eager on the CPU).

    ``exe(mu, *arrays)`` → ``(packed Θ, packed Δ items)``, new tensors,
    equal bit for bit to :func:`grouped_compress` at the same μ (a 0-d
    float32 tensor, as ``LCAlgorithm`` passes it; a float is made one).
    μ and every packed tensor are fed: one graph serves every LC
    boundary. The per-item sketch seeds (the last operand of a
    ``wants_key`` group) key the graph by value; the sketches are drawn
    by the first (eager) run and held (``lowrank.held_sketches``), which
    the capture then reads. ``programs.captured`` counts the graphs.
    A solve that cannot be captured raises :class:`CaptureError`;
    nothing falls back to the eager path."""

    def __init__(self, scheme, solver_fn, n_items: int, n_chunks: int,
                 device):
        from repro_torch.graphs import Programs
        from repro_torch.kernels.lowrank.lowrank import held_sketches
        self.scheme = scheme
        self.device = torch.device(device)
        self.programs = Programs(self.device)
        self.sketches: dict = {}
        template = self._template = []
        sketches = self.sketches

        # a closure, not a bound method: the program must not hold the
        # executable, so that dropping it frees its graphs at once, never
        # in a garbage collection that could fall inside another capture
        def run(mu, seeds, *leaves):
            it = iter(leaves)
            arrays = tree_map(lambda _: next(it), template[0])
            if seeds is not None:
                arrays = arrays + (torch.tensor(seeds, dtype=torch.int64),)
            with held_sketches(sketches):
                parts = _run_group_solve(
                    _group_solve(scheme, solver_fn, mu), arrays, n_items,
                    n_chunks)
            if len(parts) == 1:
                return parts[0][2]
            return (pack_thetas([p[2][0] for p in parts]),
                    torch.cat([p[2][1] for p in parts], dim=0))

        self.program = self.programs.program(run, name="group solve")

    def __call__(self, mu, *arrays):
        seeds = None
        if self.scheme.wants_key:
            seeds, arrays = tuple(arrays[-1].tolist()), arrays[:-1]
        self._template[:] = [tree_map(lambda _: None, arrays)]
        mu = torch.as_tensor(mu, dtype=torch.float32, device=self.device)
        args = (mu, seeds, *tree_leaves(arrays))
        first = self.program._key(args) not in self.program._graphs
        try:
            out = self.program(*args)
        except RuntimeError as e:
            if self.programs.graphs and first:
                solver = self.scheme.solver or "item-by-item"
                raise CaptureError(
                    f"{self.scheme.name} ({solver}): its group solve cannot "
                    f"be captured as a CUDA graph: {e}") from e
            raise
        if self.programs.graphs:
            # a replay rewrites the graph's outputs in place
            out = tree_map(torch.clone, out)
        return out


def compile_group(group: Sequence[CompressionTask], xs: dict,
                  thetas: dict, backend: str | None = None, device=None,
                  plan=None):
    """Capture one group's packed C solve, cached across boundaries.

    The executable half of the planner cache: μ rides as a fed 0-d
    tensor (not baked into the program), so ONE capture serves every LC
    boundary; call the returned :class:`GroupExecutable` as
    ``exe(mu, *arrays)`` → ``(packed_theta, packed_items)``. Executables
    are cached in ``repro_torch.analysis.cost`` on the same key as plans
    (``cost.cache_stats()`` counts ``exec_hits`` / ``exec_misses``).
    ``plan`` (a ``GroupPlan``) runs the planner's choices: its backend
    and its chunks. A singleton group runs as a 1-task group.

    ``xs``/``thetas`` hold the group's tensors (packing runs eagerly).
    Returns ``(executable, arrays)``.
    """
    from repro_torch.analysis import cost
    t0 = group[0]
    scheme = t0.scheme
    dev = _device_of(xs, group, device)
    solver_fn, _ = _task_solver(scheme, backend, dev)
    n_chunks = 1
    if plan is not None:
        n_chunks = plan.n_chunks
        solver_fn = _apply_plan(scheme, solver_fn, plan, dev)
    sig = t0.group_signature(xs[t0.name], batched=solver_fn is not None)
    counts = [t.view.item_count(xs[t.name]) for t in group]
    n_items = sum(counts)
    arrays = _pack_group(group, xs, thetas, counts, solver_fn, dev)[0]
    key = ("exec",) + cost.plan_key(sig, n_items, arrays, str(backend),
                                    cost.detect_hardware(dev))
    exe = cost.get_executable(key, lambda: GroupExecutable(
        scheme, solver_fn, n_items, n_chunks, dev))
    return exe, arrays


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
