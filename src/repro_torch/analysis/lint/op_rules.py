"""Layer 3: rules over *counted ops*: what the device actually runs,
counted op by op under ``analysis/op_stats.py:OpCounter``.

Port of ``src/repro/analysis/lint/hlo_rules.py``. The reference lowers
each program to HLO and reads the text; PyTorch runs eagerly, so the
port runs each program once under the counter, on the device the lint
is asked for: the card (``cuda`` backend: K1's Lloyd loop, K2's
bisection and K3 launch, and a host read that only a kernel's wrapper
makes shows) or the CPU (``--device cpu``: the kernels' plain versions;
the counter then counts the CPU's ops, the sketch seeds being host
values there as on the card). ``device=None`` means the card, and
raises where there is none. Four sweeps feed one rule set:

* every registered ``(solver, backend)`` dispatch entry on
  representative packed inputs (:func:`check_solvers`);
* every scheme family's grouped C step through
  ``core/grouping.py:count_group``, the solve the C step runs
  (:func:`check_scheme_counts`);
* the same through the planner: the group planned, then the planned
  solve counted (:func:`check_planner_counts`);
* the serving engine's decode, prefill and reset programs
  (``runtime/server.py:engine_programs``) on a tiny model
  (:func:`check_serving_counts`).

Rules (the reference's id where the port's hazard is the same):

``f64-op``
    float64/complex128 results on the device (``op_stats.f64_ops``): a
    Python float or a numpy float64 upcasting the program.

``host-read`` (the reference's ``host-callback``)
    the program reads a device tensor on the host (``op_stats.
    host_reads``: ``.item()``, ``int(t)``, ``.cpu()``): a sync on the
    card, and an error inside a CUDA graph capture, which the C step's
    and the engine's programs are on the card.

``chunk-exact-linalg`` (the reference's ``gspmd-unsafe-custom-call``)
    a solver that ``kernels/dispatch.py:chunk_exact`` declares exact
    under any batch, but whose counted program reaches a library
    linear-algebra op or a batched product (``op_stats.call_targets``,
    ``aten.bmm``): their bits depend on the batch on the card, and the
    planner and the mesh split exactly such solvers' groups, so the
    claim would change bits.

``donation-unaliased``
    a serving program does not hand back the cache storages it was given
    (``op_stats.input_output_alias``): the port writes K/V and recurrent
    states in place, so a program that returns a fresh cache holds two
    caches live and breaks the graph's in-place contract. The C step is
    not held to this: the compiled driver copies Θ out of its graphs
    (ROADMAP §3, "Differences by design").

``count-failed`` (the reference's ``lower-failed``)
    the entry or scheme would not run on its representative inputs.

``planner-silent-fallback``
    a plan made without a mesh that is neither ``source="counted"`` nor
    records a ``count-refine-failed:*`` fallback: the refinement was
    skipped without a trace in the plan.
"""
from __future__ import annotations

import torch

from repro_torch.analysis import op_stats
from repro_torch.analysis.lint.findings import Finding
from repro_torch.interop import resolve_device

#: library ops whose bits depend on the batch on the card, besides the
#: linear-algebra solvers (``op_stats.linalg_ops``)
BATCH_DEPENDENT = ("aten.bmm.default", "aten.baddbmm.default")


def _gen(device, seed: int = 0) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(seed)


def solver_fixture(name: str, device):
    """Representative packed inputs ``(args, kwargs)`` for a registered
    solver name, made from a seed on ``device`` (the sketch seeds on the
    CPU, as the engine packs them), or None for a name this sweep does
    not know (a user's solver is covered by its scheme's
    ``contract_examples`` instead)."""
    g = _gen(device)
    n = 4

    def f32(*shape):
        return torch.randn(shape, generator=g, device=device)

    def full(value, dtype):
        return torch.full((n,), value, dtype=dtype, device=device)

    keys = torch.arange(n, dtype=torch.int64) + 11
    mu = torch.full((), 1e-2, dtype=torch.float32, device=device)
    codebooks = torch.sort(f32(n, 4), dim=-1).values
    table = {
        "kmeans_lloyd": ((f32(n, 64), codebooks, full(4, torch.int32)),
                         {"iters": 2}),
        "topk_mask": ((f32(n, 64), full(8, torch.int32)), {}),
        "project_l1_ball": ((f32(n, 64), full(1.0, torch.float32)), {}),
        "soft_threshold": ((f32(n, 64), full(1e-3, torch.float32), mu), {}),
        "lowrank_rsvd": ((f32(n, 12, 8), full(2, torch.int32), keys),
                         {"r_max": 3}),
        "rank_select": ((f32(n, 12, 8), full(1e-3, torch.float32), keys, mu),
                        {"r_max": 3}),
    }
    return table.get(name)


def _count(fn, args, device, host=()):
    """``(stats, out)`` of ``fn(*args)`` run once under a counter on
    ``device`` (``cpu=True`` there: the CPU is the device)."""
    counter = op_stats.OpCounter(args=args,
                                 cpu=torch.device(device).type == "cpu",
                                 host=host)
    with counter:
        out = fn(*args)
    return counter.stats, out


def _stats_findings(stats, file: str, context: str,
                    exact_claimed: bool = False) -> list[Finding]:
    """The shared rule set over one counted program."""
    findings = []
    targets = op_stats.call_targets(stats)
    batch_dep = sorted(set(op_stats.linalg_ops(stats))
                       | {op for op in BATCH_DEPENDENT if stats.ops.get(op)})
    if exact_claimed and batch_dep:
        findings.append(Finding(
            "chunk-exact-linalg", file, context,
            f"dispatch.chunk_exact declares this solver exact under any "
            f"batch, but its counted program reaches {batch_dep} "
            f"(targets {targets}), whose bits depend on the batch on the "
            "card: the planner's chunks and a mesh's blocks would change "
            "bits; drop the chunk_exact claim or make the solver "
            "elementwise/integer only", layer="ops"))
    reads = op_stats.host_reads(stats)
    if reads:
        findings.append(Finding(
            "host-read", file, context,
            f"the program reads {len(reads)} device tensor(s) on the "
            f"host ({sorted(set(reads))}): a sync on the card and an "
            "error inside a CUDA graph capture (grouping.CaptureError); "
            "keep the value on the device (torch.where, a 0-d tensor) "
            "or hoist the read out of the program", layer="ops"))
    f64 = op_stats.f64_ops(stats)
    if f64:
        findings.append(Finding(
            "f64-op", file, context,
            f"the program makes {len(f64)} float64/complex128 result(s) "
            f"on the device (e.g. {f64[:3]}): a Python float or a numpy "
            "float64 is upcasting it; make the scalar a float32 tensor "
            "at the boundary", layer="ops"))
    return findings


def check_solvers(registry=None, device=None) -> list[Finding]:
    """Run every registered (solver, backend) entry once on its
    representative inputs under the counter and apply the rules. The
    registry is the live dispatch table by default."""
    from repro_torch.kernels import dispatch

    device = resolve_device(device)

    if registry is None:
        registry = dispatch.registry_entries()
    findings = []
    for solver, impls in sorted(registry.items()):
        fixture = solver_fixture(solver, device)
        if fixture is None:
            continue
        args, kwargs = fixture
        host = tuple(a for a in args if a.dtype == torch.int64)
        for backend, fn in sorted(impls.items()):
            context = f"{solver}:{backend}"
            try:
                stats, _ = _count(lambda *a: fn(*a, **kwargs), args, device,
                                  host)
            except Exception as e:  # noqa: BLE001 — reported, not raised
                findings.append(Finding(
                    "count-failed", "registry", context,
                    f"registered solver failed on representative inputs: "
                    f"{type(e).__name__}: {e}", layer="ops"))
                continue
            findings += _stats_findings(
                stats, "registry", context,
                exact_claimed=dispatch.chunk_exact(solver, backend))
    return findings


# ----------------------------------------------------------------------
def representative_group(scheme, device, n_tasks: int = 2,
                         n_items: int = 2):
    """A toy multi-task group of one scheme instance on ``device``:
    ``(group, xs, thetas)`` for ``grouping.count_group``. Vector schemes
    get ``(n_items, 64)`` stacks, matrix schemes ``(n_items, 12, 8)``,
    from a seed; Θ is each task's direct compression."""
    from repro_torch.core.tasks import CompressionTask
    from repro_torch.core.views import AsStacked

    g = _gen(device)
    item = (12, 8) if scheme.domain == "matrix" else (64,)
    group, xs, thetas = [], {}, {}
    for i in range(n_tasks):
        name = f"lint/{type(scheme).__name__}/{i}"
        t = CompressionTask(name, pattern=".",
                            view=AsStacked(scheme.domain), scheme=scheme)
        x = torch.randn((n_items,) + item, generator=g, device=device)
        group.append(t)
        xs[name] = x
        thetas[name] = t.scheme_init(x)
    return group, xs, thetas


def _as_meta(tree):
    from repro_torch.tree import tree_map
    return tree_map(lambda x: x.to("meta"), tree)


def _claims_exact(scheme, backend, device) -> bool:
    """Whether the group's solve runs a named solver that
    ``dispatch.chunk_exact`` declares exact on the backend it resolves to
    (the item-by-item path solves each item alone: nothing to claim)."""
    from repro_torch.core.grouping import _task_solver
    from repro_torch.kernels.dispatch import chunk_exact
    fn, actual = _task_solver(scheme, backend, device)
    return fn is not None and chunk_exact(scheme.solver, actual)


def _examples(classes):
    from repro_torch.analysis.lint.contract import (_rel_file,
                                                     discover_scheme_classes)
    if classes is None:
        classes = discover_scheme_classes()
    for cls in classes:
        for i, ex in enumerate(cls.contract_examples()):
            yield _rel_file(cls), cls.__name__, i, ex


def check_scheme_counts(classes=None, backend: str | None = "auto",
                        device=None) -> list[Finding]:
    """Count each scheme family's grouped C step
    (``core.grouping.count_group``) and apply the rules."""
    from repro_torch.core.grouping import count_group

    device = resolve_device(device)

    findings = []
    with torch.no_grad():
        for rel, name, i, ex in _examples(classes):
            context = f"{name}[{i}]"
            try:
                group, xs, thetas = representative_group(ex, device)
                stats = count_group(group, xs, thetas, mu=1.0,
                                    backend=backend, device=device)
            except Exception as e:  # noqa: BLE001 — reported, not raised
                findings.append(Finding(
                    "count-failed", rel, context,
                    f"grouped C step failed on representative inputs: "
                    f"{type(e).__name__}: {e}", layer="ops"))
                continue
            findings += _stats_findings(
                stats, rel, context,
                exact_claimed=_claims_exact(ex, backend, device))
    return findings


def check_planner_counts(classes=None, backend: str | None = "auto",
                         device=None) -> list[Finding]:
    """Plan each scheme family's representative group with the cost
    model, count exactly the solve a planner-on C step runs
    (``count_group(..., plan=plan)``) and apply the rules, plus
    ``planner-silent-fallback``: with no mesh the planner refines its
    analytic terms from the group's counted solve (``plan.source ==
    "counted"``); a plan that stayed analytic without a
    ``count-refine-failed:*`` fallback skipped it silently."""
    from repro_torch.core.grouping import (_plan_multi_group, _task_solver,
                                           count_group)

    device = resolve_device(device)

    findings = []
    with torch.no_grad():
        for rel, name, i, ex in _examples(classes):
            context = f"planner:{name}[{i}]"
            try:
                group, xs, thetas = representative_group(ex, device)
                counts = [t.view.item_count(xs[t.name]) for t in group]
                solver_fn, _ = _task_solver(ex, backend, device)
                plan = _plan_multi_group(group, xs, thetas, counts,
                                         solver_fn, backend, device)
                stats = count_group(group, xs, thetas, mu=1.0,
                                    backend=backend, device=device,
                                    plan=plan)
            except Exception as e:  # noqa: BLE001 — reported, not raised
                findings.append(Finding(
                    "count-failed", rel, context,
                    f"planned grouped C step failed on representative "
                    f"inputs: {type(e).__name__}: {e}", layer="ops"))
                continue
            recorded = any(f.startswith("count-refine-failed:")
                           for f in plan.fallbacks)
            if recorded:
                # the planner's own count, on meta tensors, for its message
                try:
                    count_group(group, _as_meta(xs), _as_meta(thetas),
                                backend=plan.backend, device="meta")
                    why = "it passes when run again"
                except Exception as e:  # noqa: BLE001 — reported
                    why = f"{type(e).__name__}: {e}"
                findings.append(Finding(
                    "count-failed", rel, f"{context}:meta",
                    f"the planner could not count the group's solve on "
                    f"meta tensors ({why}), so its plan keeps the "
                    "analytic terms; give the solve's ops (and its "
                    "kernels' wrappers) a meta path", layer="ops"))
            if plan.source != "counted" and not recorded:
                findings.append(Finding(
                    "planner-silent-fallback", rel, context,
                    f"plan stayed {plan.source!r} with mesh=None and no "
                    "count-refine-failed fallback recorded: the counted "
                    "refinement was skipped without a trace in "
                    "plan.fallbacks, so the planner's terms silently "
                    "stay the coarse analytic model's", layer="ops"))
            findings += _stats_findings(
                stats, rel, context,
                exact_claimed=_claims_exact(ex, backend, device))
    return findings


# ----------------------------------------------------------------------
def serving_config():
    """The reference's tiny one-attention-layer serving model."""
    from repro_torch.configs.base import LayerSpec, ModelConfig
    return ModelConfig(
        name="lint-serve", d_model=16, n_heads=2, n_kv_heads=2,
        head_dim=8, d_ff=32, vocab_size=64,
        pattern=(LayerSpec("attn", "dense"),), pattern_reps=1,
        attn_chunk_q=8, attn_chunk_kv=8, dtype="float32")


def check_serving_counts(slots: int = 2, max_len: int = 16,
                         prefill_chunk: int = 4,
                         device=None) -> list[Finding]:
    """Run the serving engine's decode, prefill and reset programs (the
    functions the engine captures, ``runtime/server.py:engine_programs``)
    once each under the counter on a tiny model, and apply the rules plus
    ``donation-unaliased``: each program must hand back the very cache
    storages it was given."""
    from repro_torch.graphs import Programs
    from repro_torch.models.transformer import init_cache, init_params
    from repro_torch.runtime.server import engine_programs

    device = resolve_device(device)
    cfg = serving_config()
    params = init_params(_gen(device), cfg)
    progs = engine_programs(cfg, params, slots, max_len, 0.0,
                            {"decode": 0, "prefill": 0, "reset": 0},
                            Programs(device, graphs=False))
    i32 = torch.int32

    def ints(*shape, high=cfg.vocab_size):
        return torch.randint(1, high, shape, generator=_gen(device, 1),
                             dtype=i32, device=device)

    active = torch.ones((slots,), dtype=torch.bool, device=device)
    calls = {
        "decode": lambda c: (c, ints(slots), ints(slots, high=4), active,
                             None),
        "prefill": lambda c: (c, ints(slots, prefill_chunk),
                              torch.zeros((slots,), dtype=i32,
                                          device=device),
                              torch.full((slots,), prefill_chunk, dtype=i32,
                                         device=device), active, None),
        "reset": lambda c: (c, active),
    }
    findings = []
    with torch.inference_mode():
        for prog in progs:
            context = f"serving:{prog.name}"
            try:
                args = calls[prog.name](init_cache(cfg, slots, max_len,
                                                   device=device))
                stats, out = _count(prog.fn, args, device)
            except Exception as e:  # noqa: BLE001 — reported, not raised
                findings.append(Finding(
                    "count-failed", "runtime/server", context,
                    f"serving program failed on representative inputs: "
                    f"{type(e).__name__}: {e}", layer="ops"))
                continue
            if 0 not in op_stats.input_output_alias(args, out):
                findings.append(Finding(
                    "donation-unaliased", "runtime/server", context,
                    "the program does not hand back the cache storages "
                    "it was given: the engine's graphs write K/V and "
                    "states in place, so a fresh cache holds two caches "
                    "live and a replay's cache would not be the one the "
                    "next tick reads; update the given cache in place "
                    "(copy_, index_copy_) and return it", layer="ops"))
            findings += _stats_findings(stats, "runtime/server", context)
    return findings
