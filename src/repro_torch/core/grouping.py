"""Grouped C-step dispatch (the paper's "C steps can be run in parallel").

Port of ``src/repro/core/grouping.py``. Grouped dispatch:

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
group's packed solve as CUDA graphs, one a chunk size, once per group
signature (``cost.get_executable``), μ fed as a 0-d device tensor, each
chunk's items packed straight into its graph's buffer; the LC driver's
compiled C step (``LCAlgorithm(jit_c_step=True)``) runs its groups so,
and its singletons and per-task solves as programs of their own, through
:class:`CompiledSolves`.

With a ``mesh`` (a ``torch.distributed`` ``DeviceMesh``, one process a
rank, ``distributed/sharding.py``), the packed item axis of a multi-task
group follows the ``"items"`` rule (by default the mesh's ``"data"``
axis): the items are padded to a count the axis divides
(``items_partition``; the pad repeats the group's last item, its Θ and
its operands, a problem the solver is known to take), each rank solves
its block (``shard_bounds``) under the whole group's partition
(``build.group_partition(n_items)``, as a planner chunk does), and Θ and
the decompressed items are gathered (``gather_items``) and the pad sliced
off. Every rank then holds the ``mesh=None`` result bit for bit, for
solvers whose launches over item slices are exact
(``dispatch.chunk_exact``: K1 on the card, top-κ, soft-threshold, the
item-by-item path). The others (low rank, rank selection, the ℓ1 ball,
the torch k-means) change bits with the batch, so their groups run whole
on every rank (``shard_mode="replicated"``). A sharded group never
chunks. Under the compiled driver each rank's executable captures its
local solve only; the gather runs outside the graph. Singletons run
whole on every rank, as in the reference. On a ``(data, model)`` mesh
the items shard over ``"data"`` only (the ``"items"`` rule never names
``"model"``): the ranks of one data coordinate solve the same block, and
the gather runs over the data group.
"""
from __future__ import annotations

from typing import Sequence

import torch
from torch.utils._python_dispatch import _disable_current_modes

from repro_torch.core.schemes.base import (
    add_leading_axis, cat_items, drop_leading_axis, map_items, pack_thetas,
    pack_thetas_padded, slice_theta_like, unpack_thetas)
from repro_torch.core.tasks import CompressionTask
from repro_torch.distributed import sharding
from repro_torch.distributed.sharding import items_partition
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
                      counts: list[int], solver_fn, backend, device,
                      mesh=None, rules=None):
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
    th_m = None
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
    entry = (None if mesh is None
             else items_partition(sum(counts), mesh, rules)[0])

    def count_fn(chosen):
        # the solve the C step runs, on meta tensors: the plan's terms
        # from the counted ops (the reference lowers to HLO here). The
        # cached plan keeps this closure until a term is read, so it
        # holds only meta tensors, never the C step's xs or Θ
        if th_m is None:
            raise ValueError("theta-shapes-unknown")
        return count_group(group, xs_m, th_m, backend=chosen,
                           device="meta")

    return cost.plan_group(
        sig, sum(counts), arrays, out,
        requested_backend=str(backend) if backend is not None else "off",
        solver=solver, registered=registered,
        chunk_exact=tuple(b for b in registered if chunk_exact(solver, b)),
        base_fallbacks=fallbacks, hw=cost.detect_hardware(device),
        mesh=mesh, count_fn=count_fn, items_entry=entry)


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


def _shard_layout(mesh, rules, n_items: int, solver: str | None,
                  backend: str | None) -> tuple:
    """``(entry, pad, shard_mode, reason)`` of a multi-task group under
    ``mesh``: the ``"items"`` rule's entry and pad (the reference's), and
    whether the group shards (``"sharded"``), runs whole on every rank
    (``"replicated"``, ``reason`` says why) or has no mesh axis
    (``None``)."""
    if mesh is None:
        return None, 0, None, None
    entry, pad = items_partition(n_items, mesh, rules)
    if entry is None:
        return None, 0, None, None
    from repro_torch.kernels.dispatch import chunk_exact
    if chunk_exact(solver, backend):
        return entry, pad, "sharded", None
    return entry, pad, "replicated", (
        f"not chunk-exact: {solver} on {backend} changes bits with the "
        f"batch")


def describe_groups(tasks: Sequence[CompressionTask], xs: dict,
                    mesh=None, rules: dict | None = None,
                    backend: str | None = None, device=None,
                    planner: str | None = None) -> list[dict]:
    """The grouping a C step would use: per group its scheme, item shape,
    tasks, item count, whether it is solved as a group, and — honestly —
    the registry ``solver`` and resolved ``backend`` that will run
    (``None`` = item-by-item scheme program).

    With a ``mesh``, each multi-task group also reports the layout of its
    packed item axis, as the reference's: ``spec`` (a 1-tuple of the
    ``"items"`` rule's entry, ``None`` where the axis resolves none) and
    ``padding`` (the items appended so that the count divides the
    entry's ranks); ``shard_mode`` says whether the items shard
    (``"sharded"``) or every rank solves the whole group
    (``"replicated"``, with the reason in ``shard_reason``).

    ``planner="on"`` attaches each multi-task group's
    :class:`repro_torch.analysis.cost.GroupPlan` as ``plan`` (read by
    key as the reference's dict: the modeled roofline terms, the chosen
    backend and chunks, the recorded fallbacks): the same cached plan the
    C step will use, with Θ's shapes from the scheme's init on meta
    tensors (nothing runs until a term is read). When planned,
    ``backend`` reports the planner's choice."""
    out = []
    for group in build_groups(tasks, xs, backend=backend, device=device):
        t0 = group[0]
        sig = t0.group_signature(xs[t0.name])
        grouped = sig is not None and len(group) > 1
        solver_fn, actual = _task_solver(t0.scheme, backend, device)
        counts = [t.view.item_count(xs[t.name]) for t in group]
        solver = t0.scheme.solver if solver_fn is not None else None
        plan = None
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
                                     _device_of(xs, group, device),
                                     mesh, rules)
            if solver_fn is not None:
                actual = plan.backend
        entry, pad, mode, reason = (
            _shard_layout(mesh, rules, sum(counts), solver, actual)
            if grouped else (None, 0, None, None))
        out.append({
            "scheme": t0.scheme.name,
            "item_shape": t0.view.item_shape(xs[t0.name]),
            "tasks": [t.name for t in group],
            "items": sum(counts),
            # singleton groups run the per-task path even when groupable
            "grouped": grouped,
            "spec": (entry,) if entry is not None else None,
            "padding": pad,
            "shard_mode": mode,
            "shard_reason": reason,
            "solver": solver,
            "backend": actual,
            "plan": plan,
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
                     n_chunks: int = 1,
                     partition: int | None = None) -> list:
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
    bit for bit. ``partition``: the item count of the group whose
    partition the launches take, where ``arrays`` are a rank's block of
    it (:func:`_shard_of`).
    """
    from repro_torch.kernels.build import group_partition
    compress, decompress = solve
    items, rest = arrays[0], arrays[1:]
    parts = []
    with group_partition(partition or n_items):
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


def _shard_of(items, warm: tuple, n_items: int, lo: int, hi: int):
    """A rank's block ``[lo, hi)`` of a group of ``n_items`` padded to a
    count the mesh divides: ``(block_items, block_warm)``, ``block_items(a,
    b, out=None)`` packing rows ``a:b`` of the block (as
    :func:`_item_packer`'s function does for the group), ``block_warm``
    every packed warm-start and operand leaf's rows of the block. Rows at
    or past ``n_items`` repeat the group's last item."""
    def rows(x):
        if hi <= n_items:
            return x[lo:hi]
        idx = torch.arange(lo, hi).clamp_(max=n_items - 1)
        return x[idx.to(x.device)]

    def block(a, b, out=None):
        g0, g1 = lo + a, lo + b
        if g1 <= n_items:
            return items(g0, g1, out=out)
        real = max(0, n_items - g0)
        last = items(n_items - 1, n_items)
        if out is None:
            out = last.new_empty((b - a, *last.shape[1:]))
        if real:
            items(g0, n_items, out=out[:real])
        out[real:].copy_(last.expand(b - a - real, *last.shape[1:]))
        return out

    return block, tuple(tree_map(rows, a) for a in warm)


def _gathered(parts: list, mesh, entry, n_items: int) -> list:
    """A rank's launches over its block put together with every other
    rank's (``sharding.gather_items``) and the pad sliced off: the one
    launch ``[(0, n_items, (Θ, Δ items))]`` of the whole group, the same
    on every rank."""
    theta = pack_thetas([p[2][0] for p in parts]) if len(parts) > 1 \
        else parts[0][2][0]
    a = torch.cat([p[2][1] for p in parts], dim=0) if len(parts) > 1 \
        else parts[0][2][1]
    theta, a = sharding.gather_items((theta, a), mesh, entry)
    return [(0, n_items, (tree_map(lambda x: x[:n_items], theta),
                          a[:n_items]))]


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
    operands = tuple(cat_items(parts) for parts in zip(*per_task))
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
    """``items(lo, hi, out=None)``: the packed items ``lo:hi`` of the
    group, each task's input read from ``xs`` while its rows are copied
    in (into ``out`` when given; else a slice that lies in one task is
    that task's own items, not a copy)."""
    def items(lo, hi, out=None):
        off = 0
        for t, n in zip(group, counts):
            a, b = max(lo, off), min(hi, off + n)
            if a < b:
                x = t.view.to_items(xs[t.name])[a - off:b - off]
                if out is None and b - a == hi - lo:
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


def count_group(group: Sequence[CompressionTask], xs: dict, thetas: dict,
                mu=1.0, backend: str | None = None, device=None,
                plan=None):
    """Count one group's packed C solve under ``op_stats.OpCounter``
    (``repro_torch.analysis.op_stats``) and return its ``Stats``: the
    counterpart of the reference's ``lower_group``, and what the lint's
    op layer and the planner read.

    It runs exactly the solve :func:`grouped_compress` runs for
    ``group``: the same packing (:func:`_pack_group`, outside the count,
    as the reference packs outside its lowered program), the same solver
    resolution, the planner's backend and chunks when ``plan`` is given,
    and each launch in the group's partition. It takes the tensors it is
    given: meta tensors (the planner's shapes; the kernels' wrappers only
    allocate their outputs and report their launches), CPU tensors (the
    kernels' plain versions; the ops on the CPU count, the sketch seeds
    as host values) or CUDA tensors (the kernels launch). A singleton
    group counts the same packed program over its one task. μ is a 0-d
    float32 tensor on the items' device, as the LC driver passes it."""
    from repro_torch.analysis import op_stats
    scheme = group[0].scheme
    dev = torch.device(_device_of(xs, group, device))
    solver_fn, _ = _task_solver(scheme, backend, dev)
    n_chunks = 1
    if plan is not None:
        n_chunks = plan.n_chunks
        solver_fn = _apply_plan(scheme, solver_fn, plan, dev)
    counts = [t.view.item_count(xs[t.name]) for t in group]
    arrays, _ = _pack_group(group, xs, thetas, counts, solver_fn, dev)
    if not isinstance(mu, torch.Tensor):
        mu = torch.full((), float(mu), dtype=torch.float32, device=dev)
    host = (arrays[-1],) if scheme.wants_key else ()
    counter = op_stats.OpCounter(args=arrays, cpu=dev.type == "cpu",
                                 host=host)
    # counted alone: a counter around the caller (a dry run's step whose
    # C step plans a group) sees none of these ops
    with _disable_current_modes(), counter:
        _run_group_solve(_group_solve(scheme, solver_fn, mu), arrays,
                         sum(counts), n_chunks)
    return counter.stats


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
                     thetas: dict, mu, mesh=None, rules: dict | None = None,
                     backend: str | None = None, device=None,
                     planner: str | None = None,
                     compiled: "CompiledSolves | None" = None) -> dict:
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
    launch); plans are cached, so repeated boundaries replan nothing.
    ``compiled`` (the LC driver's :class:`CompiledSolves`) runs each
    solve as a program once it is due, with the same result. With a
    ``mesh``, each chunk-exact multi-task group is solved block by block
    over the mesh's ranks and gathered (the module's note): every rank
    gets the ``mesh=None`` result bit for bit."""
    shapes = {t.name: _meta(xs[t.name]) for t in tasks}
    out = {}
    for group in build_groups(tasks, shapes, backend=backend, device=device):
        if len(group) == 1:
            # singleton: per-task path (also the non-groupable fallback),
            # kernel-dispatched when the scheme opts in
            t = group[0]
            out[t.name] = solve_and_decompress(t, xs[t.name],
                                               thetas[t.name], mu, backend,
                                               device, compiled)
            continue

        # equal batched signature ⇒ same class and batch_key; operand-
        # ized hyperparameters (κ, K) ride in packed per-item tensors
        scheme = group[0].scheme
        solver_fn, actual = _task_solver(scheme, backend, device)
        counts = [t.view.item_count(shapes[t.name]) for t in group]
        dev = _device_of(xs, group, device)
        n_items = sum(counts)
        n_chunks = 1
        if planner == "on":
            plan = _plan_multi_group(group, shapes, thetas, counts,
                                     solver_fn, backend, dev, mesh, rules)
            n_chunks = plan.n_chunks
            solver_fn = _apply_plan(scheme, solver_fn, plan, dev)
            if solver_fn is not None:
                actual = plan.backend
        entry, pad, mode, _ = _shard_layout(
            mesh, rules, n_items,
            scheme.solver if solver_fn is not None else None, actual)
        warm, thetas_lead = _pack_warm(group, thetas, counts, solver_fn,
                                       dev)
        items = _item_packer(group, xs, counts)
        size, partition = n_items, None
        if mode == "sharded":
            # this rank's block of the padded items, in the group's
            # partition; never chunked
            lo, hi = sharding.shard_bounds(n_items + pad, mesh, entry)
            items, warm = _shard_of(items, warm, n_items, lo, hi)
            size, partition, n_chunks = hi - lo, n_items, 1
        exe = like = None
        if compiled is not None and compiled.due():
            one = _item_packer(group, shapes, counts)(0, 1)
            like = one.new_empty((size, *one.shape[1:]))
            exe = compiled.group(group, shapes, (like,) + warm, solver_fn,
                                 n_chunks, backend, dev, partition)
        if exe is not None:
            parts = exe.parts(mu, items, like, warm, lend=compiled.lend)
        else:
            parts = _run_group_solve(_group_solve(scheme, solver_fn, mu),
                                     (items,) + warm, size, n_chunks,
                                     partition)
        if mode == "sharded":
            parts = _gathered(parts, mesh, entry, n_items)
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
    """A solve that a CUDA graph cannot take (a host sync, a generator
    seeded inside the solve, a host-to-device copy)."""


#: the capture policy of :class:`CompiledSolves`: the driver's C step
#: from which its solves and steps run as programs (before it, eagerly)
CAPTURE_AT = 2


def _run_program(programs, program, args, what: str, lend: bool = False):
    """``program(*args)`` → ``(Θ, Δ)``, copied where they are a graph's
    outputs (a replay rewrites them in place): Θ always, Δ unless
    ``lend`` (the caller reads it before the program's next call); a
    failed capture raises :class:`CaptureError` naming ``what``."""
    first = program._key(args) not in program._graphs
    try:
        out = program(*args)
    except RuntimeError as e:
        if programs.graphs and first:
            raise CaptureError(f"{what}: its solve cannot be captured as a "
                               f"CUDA graph: {e}") from e
        raise
    if programs.graphs:
        # one copy a tensor (pruning's Θ is its Δ(Θ))
        copies: dict = {}
        theta, a = out
        theta = tree_map(lambda x: copies.setdefault(id(x), x.clone()),
                         theta)
        out = (theta, copies.get(id(a), a) if lend
               else copies.setdefault(id(a), a.clone()))
    return out


class GroupExecutable:
    """:func:`compile_group`'s executable: one group's packed solve as a
    program of ``repro_torch.graphs`` (CUDA graphs on the card, captured
    at the first call and replayed after; eager on the CPU), on
    ``programs`` (its own when None), run chunk by chunk as the planner
    split the group: one graph a chunk size, fed only its chunk's items
    and per-item operands, so the graph's buffers, outputs and pool hold
    a chunk's working set, not the group's. Under a mesh it is a rank's
    block of a group (``n_items`` the block's count, ``partition`` the
    group's, whose partition every launch takes).

    :meth:`parts` packs each chunk's items straight into the graph's fed
    buffer and returns the launches as :func:`_run_group_solve` does,
    equal bit for bit at the same μ (a 0-d float32 tensor, as
    ``LCAlgorithm`` passes it; a float is made one). μ and every packed
    tensor are fed: one graph serves every LC boundary. The per-item
    sketch seeds (the last operand of a ``wants_key`` group) key the
    graph by value; the sketches are drawn by the first (eager) run and
    held (``lowrank.held_sketches``), which the capture then reads.
    ``programs.captured`` counts the graphs. A solve that cannot be
    captured raises :class:`CaptureError`; nothing falls back to the
    eager path."""

    def __init__(self, scheme, solver_fn, n_items: int, n_chunks: int,
                 device, programs=None, partition: int | None = None):
        from repro_torch.graphs import Programs
        from repro_torch.kernels.build import group_partition
        from repro_torch.kernels.lowrank.lowrank import held_sketches
        self.scheme = scheme
        self.bounds = _chunk_bounds(n_items, n_chunks)
        self.device = torch.device(device)
        self.programs = (programs if programs is not None
                         else Programs(self.device))
        self.sketches: dict = {}
        template = self._template = []
        sketches = self.sketches
        partition = partition or n_items

        # a closure, not a bound method: the program must not hold the
        # executable, so that dropping it frees its graphs at once, never
        # in a garbage collection that could fall inside another capture
        def run(mu, seeds, xi, *leaves):
            it = iter(leaves)
            rest = tree_map(lambda _: next(it), template[0])
            if seeds is not None:
                rest = rest + (torch.tensor(seeds, dtype=torch.int64),)
            compress, decompress = _group_solve(scheme, solver_fn, mu)
            # every chunk launches with the whole group's partition
            with held_sketches(sketches), group_partition(partition):
                theta = compress(xi, *rest)
                return theta, decompress(theta)

        self.program = self.programs.program(
            run, name=f"group solve {scheme.name}")

    def parts(self, mu, items, like, warm: tuple,
              lend: bool = False) -> list:
        """``[(lo, hi, (Θ, Δ items)), ...]``, one entry a chunk:
        ``items(lo, hi, out=)`` packs a chunk's items (:func:`_item_packer`),
        ``like`` is the packed items' meta tensor and ``warm`` the packed
        ``(Θ, *operands)``. ``lend``: an unchunked group's Δ is the
        graph's own output (see :func:`_run_program`)."""
        mu = torch.as_tensor(mu, dtype=torch.float32, device=self.device)
        what = f"{self.scheme.name} ({self.scheme.solver or 'item-by-item'})"
        lend = lend and len(self.bounds) == 1
        parts = []
        for lo, hi in self.bounds:
            chunk = tuple(tree_map(lambda x: x[lo:hi], a) for a in warm)
            seeds = None
            if self.scheme.wants_key:
                seeds, chunk = tuple(chunk[-1].tolist()), chunk[:-1]
            self._template[:] = [tree_map(lambda _: None, chunk)]
            args = [mu, seeds, like[lo:hi], *tree_leaves(chunk)]
            args[2] = items(lo, hi, out=self.program.fed(args, 2))
            parts.append((lo, hi, _run_program(
                self.programs, self.program, tuple(args), what, lend)))
            del args, chunk
        return parts

    def __call__(self, mu, *arrays):
        """``exe(mu, items, packed Θ, *operands)`` → ``(packed Θ, packed
        Δ items)``, new tensors."""
        items, warm = arrays[0], arrays[1:]

        def packed(lo, hi, out=None):
            return items[lo:hi] if out is None else out.copy_(items[lo:hi])

        parts = self.parts(mu, packed, _meta(items), warm)
        if len(parts) == 1:
            return parts[0][2]
        return (pack_thetas([p[2][0] for p in parts]),
                torch.cat([p[2][1] for p in parts], dim=0))


class TaskExecutable:
    """One task's C solve as a program on ``programs``: ``exe(x, Θ, mu)``
    → ``(Θ, Δ(Θ))``, new tensors, equal bit for bit to
    :func:`solve_task` and ``scheme_decompress`` on the same inputs. The
    input, the part of Θ its solve reads (``scheme.warm_start``) and μ
    are fed; sketches are held as in :class:`GroupExecutable`."""

    def __init__(self, task: CompressionTask, backend, device, programs):
        from repro_torch.kernels.lowrank.lowrank import held_sketches
        self.task = task
        self.device = torch.device(device)
        self.programs = programs
        template = self._template = []
        sketches: dict = {}

        def run(mu, x, *leaves):
            it = iter(leaves)
            theta = tree_map(lambda _: next(it), template[0])
            with held_sketches(sketches):
                theta = solve_task(task, x, theta, mu, backend=backend,
                                   device=device)
                return theta, task.scheme_decompress(theta)

        self.program = programs.program(run, name=f"task solve {task.name}")

    def __call__(self, x, theta, mu, lend: bool = False):
        warm = self.task.scheme.warm_start(theta)
        self._template[:] = [tree_map(lambda _: None, warm)]
        mu = torch.as_tensor(mu, dtype=torch.float32, device=self.device)
        scheme = self.task.scheme
        what = (f"{self.task.name}: {scheme.name} "
                f"({scheme.solver or 'item-by-item'})")
        return _run_program(self.programs, self.program,
                            (mu, x, *tree_leaves(warm)), what, lend)


def _solver_id(solver_fn) -> str | None:
    if solver_fn is None:
        return None
    return getattr(solver_fn, "__qualname__", None) or repr(solver_fn)


def _exec_key(group, shapes: dict, arrays, solver_fn, n_chunks: int,
              backend, dev, partition: int | None = None) -> tuple:
    """An executable's cache key: its plan key (the packed shapes) with
    the solver implementation, the chunks it runs and the partition of
    its launches (a rank's block under a mesh: its group's)."""
    from repro_torch.analysis import cost
    t0 = group[0]
    sig = t0.group_signature(shapes[t0.name], batched=solver_fn is not None)
    return (("exec",) + cost.plan_key(sig, int(arrays[0].shape[0]), arrays,
                                      str(backend),
                                      cost.detect_hardware(dev))
            + (_solver_id(solver_fn), int(n_chunks), partition))


def compile_group(group: Sequence[CompressionTask], xs: dict,
                  thetas: dict, backend: str | None = None, device=None,
                  plan=None):
    """Capture one group's packed C solve, cached across boundaries.

    The executable half of the planner cache: μ rides as a fed 0-d
    tensor (not baked into the program), so ONE capture serves every LC
    boundary; call the returned :class:`GroupExecutable` as
    ``exe(mu, *arrays)`` → ``(packed_theta, packed_items)``. Executables
    are cached in ``repro_torch.analysis.cost`` on the plan key with the
    solver and its chunks (``cost.cache_stats()`` counts ``exec_hits`` /
    ``exec_misses``). ``plan`` (a ``GroupPlan``) runs the planner's
    choices: its backend and its chunks. A singleton group runs as a
    1-task group.

    ``xs``/``thetas`` hold the group's tensors (packing runs eagerly).
    Returns ``(executable, arrays)``.
    """
    from repro_torch.analysis import cost
    scheme = group[0].scheme
    dev = _device_of(xs, group, device)
    solver_fn, _ = _task_solver(scheme, backend, dev)
    n_chunks = 1
    if plan is not None:
        n_chunks = plan.n_chunks
        solver_fn = _apply_plan(scheme, solver_fn, plan, dev)
    counts = [t.view.item_count(xs[t.name]) for t in group]
    arrays = _pack_group(group, xs, thetas, counts, solver_fn, dev)[0]
    key = _exec_key(group, xs, arrays, solver_fn, n_chunks, backend, dev)
    exe = cost.get_executable(key, lambda: GroupExecutable(
        scheme, solver_fn, sum(counts), n_chunks, dev))
    return exe, arrays


class CompiledSolves:
    """The C-step solves of one LC driver as programs on its ``programs``
    (``LCAlgorithm(jit_c_step=True)``): a multi-task group's packed solve
    as a :class:`GroupExecutable` (one a group, cached on its
    :func:`compile_group` key in ``executables``), a singleton's or a
    per-task solve (``group_tasks=False``) as a
    :class:`TaskExecutable`.

    The capture policy: until the driver's C step number
    :data:`CAPTURE_AT` begins (``c_steps`` counts them), its solves and
    steps run eagerly, as ``jit_c_step=False`` runs them (nothing is
    packed whole, nothing captured); from then on each runs as its
    program, which on the card runs it eagerly and captures it at its
    first call (the call's result is the eager run's) and replays it
    after. A run with one C step captures nothing."""

    def __init__(self, programs):
        self.programs = programs
        self.c_steps = 0
        # the C step under way reads Δ(Θ) before the next one runs (the
        # sync ``c_step``): unchunked solves lend their graphs' Δ(Θ)
        self.lend = False
        self.executables: dict = {}
        self.tasks: dict = {}

    def due(self) -> bool:
        """Whether the solves and steps run as programs now."""
        return self.c_steps >= CAPTURE_AT

    def group(self, group, shapes: dict, arrays: tuple, solver_fn,
              n_chunks: int, backend, dev,
              partition: int | None = None) -> GroupExecutable:
        """The group's executable (``arrays``: its packed items, as a meta
        tensor, and its packed warm start and operands; under a mesh the
        rank's block of them, ``partition`` the group's item count)."""
        from repro_torch.analysis import cost
        key = _exec_key(group, shapes, arrays, solver_fn, n_chunks,
                        backend, dev, partition)
        return cost.get_executable(key, lambda: GroupExecutable(
            group[0].scheme, solver_fn, int(arrays[0].shape[0]), n_chunks,
            dev, programs=self.programs, partition=partition),
            cache=self.executables)

    def task(self, task: CompressionTask, backend, device):
        """The task's executable when its solve is due to run as a
        program, else None."""
        if not self.due():
            return None
        key = (task.name, str(backend))
        exe = self.tasks.get(key)
        if exe is None:
            exe = self.tasks[key] = TaskExecutable(task, backend, device,
                                                   self.programs)
        return exe


def solve_and_decompress(task: CompressionTask, x, theta, mu,
                         backend: str | None = None, device=None,
                         compiled: CompiledSolves | None = None):
    """``(Θ, Δ(Θ))`` of one task's C solve (:func:`solve_task`), through
    ``compiled``'s program once it is due."""
    exe = None if compiled is None else compiled.task(task, backend,
                                                      device)
    if exe is not None:
        return exe(x, theta, mu, lend=compiled.lend)
    theta = solve_task(task, x, theta, mu, backend=backend, device=device)
    return theta, task.scheme_decompress(theta)


def grouped_init(tasks: Sequence[CompressionTask], xs: dict, mesh=None,
                 rules: dict | None = None) -> dict:
    """Direct compression Θ^DC = Π(w̄) with grouped dispatch: tasks group
    by their (non-batched) signature extended with ``scheme.init_key()``,
    and each group runs ``scheme.init`` over its packed items. Returns
    ``{task_name: (theta, a_arr)}``. With a ``mesh`` the packed item axis
    shards as the C step's (each item's init runs alone, so every group
    shards): every rank gets the ``mesh=None`` result."""
    out = {}
    for group in build_groups(tasks, xs, for_init=True):
        if len(group) == 1:
            t = group[0]
            theta = t.scheme_init(xs[t.name])
            out[t.name] = (theta, t.scheme_decompress(theta))
            continue

        scheme = group[0].scheme  # identical init_key ⇒ same static cfg
        counts = [t.view.item_count(xs[t.name]) for t in group]
        n_items = sum(counts)
        items = _item_packer(group, xs, counts)
        keys = (_packed_keys(group, counts),) if scheme.wants_key else ()
        entry, pad = (None, 0) if mesh is None else items_partition(
            n_items, mesh, rules)
        lo, hi = 0, n_items
        if entry is not None:
            lo, hi = sharding.shard_bounds(n_items + pad, mesh, entry)
            items, keys = _shard_of(items, keys, n_items, lo, hi)
        xi = items(0, hi - lo)
        if scheme.wants_key:
            theta_packed = map_items(
                lambda x, k: scheme.init(x, key=k), xi, keys[0])
        else:
            theta_packed = map_items(scheme.init, xi)
        del xi
        a_packed = map_items(scheme.decompress, theta_packed)
        if entry is not None:
            ((_, _, (theta_packed, a_packed)),) = _gathered(
                [(0, hi - lo, (theta_packed, a_packed))], mesh, entry,
                n_items)

        off = 0
        for t, th, n in zip(group, unpack_thetas(theta_packed, counts),
                            counts):
            a_arr = t.view.from_items(a_packed[off:off + n])
            off += n
            out[t.name] = (th if t.view.stacked else drop_leading_axis(th),
                           a_arr)
    return out
