"""The port's linter linted: the op and trace layers of
``repro_torch.analysis.lint``, the op counter's lint helpers and the
planner's refinement from counted ops, on the CPU.

Each seeded fixture of the reference's ``tests/test_lint.py`` (layer 3)
and ``tests/test_lint_retrace.py`` has a twin that trips exactly the rule
the reference's fixture trips, or the rule mapped to it
(``gspmd-unsafe-custom-call`` → ``chunk-exact-linalg``; the reference's
Θ donation fixture → ``donation-unaliased`` of a serving program, the
only programs the port holds to it; the rejitting algo → a driver that
releases its graphs every boundary). The ops run on the CPU, where the
kernels' plain versions stand in (``--device cpu``); a plan made without
a mesh is refined from its group's solve counted on meta tensors, and
for the low-rank family the counted product FLOPs are held to the
reference's HLO-refined FLOPs by the closed form of ROADMAP §3.
"""

import gc
import weakref

import numpy as np
import pytest
import torch

from repro_torch.analysis import cost, op_stats
from repro_torch.analysis.lint import run_lint, trace_count
from repro_torch.analysis.lint.cli import main as lint_main
from repro_torch.analysis.lint.op_rules import (
    check_planner_counts, check_scheme_counts, check_serving_counts,
    check_solvers, representative_group)
from repro_torch.core import grouping
from repro_torch.core.algorithm import LCAlgorithm
from repro_torch.core.schemes import (
    AdaptiveQuantization, ConstraintL0Pruning, LowRank, RankSelection)
from repro_torch.core.tasks import CompressionTask
from repro_torch.core.views import AsStacked
from repro_torch.kernels import dispatch
from repro_torch.tree import tree_leaves, tree_map
from torch_threads import _one_torch_thread  # noqa: F401

CPU = torch.device("cpu")


def _rules(findings):
    return sorted({f.rule for f in findings})


@pytest.fixture(autouse=True)
def _fresh_plans():
    cost.clear_caches()
    yield
    cost.clear_caches()


# ----------------------------------------------------------------------
# Layer 3: counted-op fixtures
# ----------------------------------------------------------------------
class BadExactLowRank(LowRank):
    """Its solve calls the library SVD, while its solver is declared
    chunk-exact: the port's form of the reference's LAPACK call under a
    ``gspmd_safe`` claim."""

    def compress_batched(self, solve, w, theta, operands, mu=None):
        u, s, vt = torch.linalg.svd(w, full_matrices=False)
        r = theta["u"].shape[-1]
        rs = torch.sqrt(s[..., :r])
        return {"u": u[..., :, :r] * rs[..., None, :],
                "v": vt.transpose(-1, -2)[..., :, :r] * rs[..., None, :]}

    @classmethod
    def contract_examples(cls):
        return (cls(target_rank=2),)


def test_chunk_exact_claim_with_a_linalg_op(monkeypatch):
    monkeypatch.setattr(dispatch, "_CHUNK_EXACT",
                        dispatch._CHUNK_EXACT | {("lowrank_rsvd", "torch")})
    findings = check_scheme_counts(classes=[BadExactLowRank], device=CPU)
    assert _rules(findings) == ["chunk-exact-linalg"]
    (f,) = findings
    assert "linalg" in f.message
    assert "drop the chunk_exact claim" in f.message   # the remedy
    # the claim as registered: the same solve trips nothing
    monkeypatch.undo()
    assert check_scheme_counts(classes=[BadExactLowRank], device=CPU) == []


def test_donation_violation_detected(monkeypatch):
    """A serving program that returns a fresh cache instead of the one it
    was given (the reference's fixture returns a Θ that cannot alias)."""
    from repro_torch.runtime import server

    make = server.engine_programs

    def fresh_decode(*args):
        decode, prefill, reset = make(*args)
        inner = decode.fn
        decode.fn = lambda cache, *rest: (
            lambda out: (out[0], tree_map(torch.clone, out[1])))(
                inner(cache, *rest))
        return decode, prefill, reset

    monkeypatch.setattr(server, "engine_programs", fresh_decode)
    findings = check_serving_counts(device=CPU)
    assert _rules(findings) == ["donation-unaliased"]
    assert [f.context for f in findings] == ["serving:decode"]
    assert "in place" in findings[0].message


class HostReadPruning(ConstraintL0Pruning):
    """Reads κ on the host inside its batched solve."""

    def compress_batched(self, solve, w, theta, operands, mu=None):
        (kappa,) = operands
        k = int(kappa.max())
        return {"theta": solve(w, torch.clamp(kappa, max=k))}

    @classmethod
    def contract_examples(cls):
        return (cls(kappa=4),)


class F64Pruning(ConstraintL0Pruning):
    """Upcasts its result to float64 on the device."""

    def compress_batched(self, solve, w, theta, operands, mu=None):
        (kappa,) = operands
        return {"theta": (solve(w, kappa).double() * 2.0).float()}

    @classmethod
    def contract_examples(cls):
        return (cls(kappa=4),)


class BrokenPruning(ConstraintL0Pruning):
    def compress_batched(self, solve, w, theta, operands, mu=None):
        raise RuntimeError("broken on purpose")

    @classmethod
    def contract_examples(cls):
        return (cls(kappa=4),)


@pytest.mark.parametrize("cls,rule,planned", [
    (HostReadPruning, "host-read", ["count-failed", "host-read"]),
    (F64Pruning, "f64-op", ["f64-op"]),
    (BrokenPruning, "count-failed", ["count-failed"])])
def test_each_op_rule_trips_alone(cls, rule, planned):
    """Each rule alone on the family's C step; planned, a host read also
    stops the planner's count on meta tensors (it raises there)."""
    assert _rules(check_scheme_counts(classes=[cls], device=CPU)) == [rule]
    assert _rules(check_planner_counts(classes=[cls], device=CPU)) == planned


def test_planner_silent_fallback_detected(monkeypatch):
    # a plan whose terms stay analytic and record nothing
    monkeypatch.setattr(cost.GroupPlan, "source",
                        property(lambda self: "analytic"))
    monkeypatch.setattr(cost.GroupPlan, "fallbacks",
                        property(lambda self: ()))
    findings = check_planner_counts(classes=[ConstraintL0Pruning],
                                    device=CPU)
    assert _rules(findings) == ["planner-silent-fallback"]


@pytest.mark.parametrize("check", [check_solvers, check_scheme_counts,
                                   check_planner_counts,
                                   check_serving_counts])
def test_the_op_checks_ask_for_the_card_by_default(check, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        check()


def test_current_solver_registry_counts_clean():
    assert check_solvers(device=CPU) == []


def test_every_scheme_family_counts_clean():
    assert check_scheme_counts(device=CPU) == []
    assert check_planner_counts(device=CPU) == []
    assert check_serving_counts(device=CPU) == []


def test_run_lint_over_the_ports_tree_is_clean(capsys):
    report = run_lint(device="cpu")
    assert report.layers == ["ast", "contract", "ops", "ops", "ops", "ops",
                             "trace", "trace", "trace"]
    assert report.findings == []
    assert lint_main(["--device", "cpu"]) == 0
    assert "lint: clean" in capsys.readouterr().out


# ----------------------------------------------------------------------
# op_stats' lint helpers
# ----------------------------------------------------------------------
def test_host_reads_on_the_cpu_spare_the_host_values():
    x, seeds = torch.arange(4.0), torch.arange(3)
    counter = op_stats.OpCounter(cpu=True, host=(seeds,))
    with counter:
        float(x[1])
        int(seeds[2])
        seeds.tolist()
    assert op_stats.host_reads(counter.stats) == ["cpu"]
    # without cpu=True the CPU is the host: nothing counts
    counter = op_stats.OpCounter()
    with counter:
        float(x[1])
    assert op_stats.host_reads(counter.stats) == []


def test_a_meta_read_counts_and_raises():
    counter = op_stats.OpCounter()
    with pytest.raises(Exception):
        with counter:
            torch.empty(2, device="meta").sum().item()
    assert op_stats.host_reads(counter.stats) == ["meta"]


def test_input_output_alias():
    a, b = torch.zeros(3), {"k": torch.zeros(2), "v": torch.zeros(2)}
    c = torch.zeros(4)
    out = (a.add_(1.0), {"k": b["k"], "v": b["v"].clone()}, c[1:])
    assert op_stats.input_output_alias((a, b, c, 5), out) == {0, 2}


def test_call_targets_and_repeated_counts():
    stats = op_stats.Stats()
    stats.launches.update({"K1loop": 2})
    stats.wrapper_launches.update({"K1loop": 2, "K3": 1})
    stats.linalg += ["aten._linalg_svd.default"] * 2
    assert op_stats.call_targets(stats) == {
        "K1loop": 2, "K3": 1, "aten._linalg_svd.default": 2}
    x = torch.empty(4, 5, 6, device="meta")
    counter = op_stats.OpCounter()
    with counter:
        with op_stats.repeated(7):
            torch.bmm(x, x.transpose(1, 2))
    assert counter.stats.flops == 7 * 2 * 4 * 5 * 5 * 6
    assert counter.stats.ops["aten.bmm.default"] == 7


@pytest.mark.parametrize("scheme,targets", [
    (AdaptiveQuantization(k=2, iters=2), {"K1loop": 1}),
    (ConstraintL0Pruning(kappa=4), {"K2loop": 1, "K3": 1})])
def test_the_kernels_report_their_launches_on_meta(scheme, targets):
    group, xs, thetas = representative_group(scheme, CPU)
    meta = {k: v.to("meta") for k, v in xs.items()}
    th = {k: tree_map(lambda x: x.to("meta"), v) for k, v in thetas.items()}
    stats = grouping.count_group(group, meta, th, backend="cuda",
                                 device="meta")
    assert op_stats.call_targets(stats) == targets
    assert stats.flops > 0 and stats.kernel_bytes > 0
    # on CPU tensors the cuda backend runs the plain versions: no launch
    cpu = grouping.count_group(group, xs, thetas, backend="cuda")
    assert op_stats.call_targets(cpu) == {}


def test_the_jacobi_loop_counts_alike_on_meta_and_the_cpu():
    group, xs, thetas = representative_group(LowRank(target_rank=2), CPU)
    meta = {k: v.to("meta") for k, v in xs.items()}
    th = {k: tree_map(lambda x: x.to("meta"), v) for k, v in thetas.items()}
    on_meta = grouping.count_group(group, meta, th, backend="torch")
    on_cpu = grouping.count_group(group, xs, thetas, backend="torch")
    assert on_meta.flops == on_cpu.flops > 0
    assert on_meta.ops["aten.bmm.default"] == on_cpu.ops["aten.bmm.default"]


# ----------------------------------------------------------------------
# the planner's refinement from counted ops
# ----------------------------------------------------------------------
FAMILIES = {
    "quant": lambda: AdaptiveQuantization(k=2, iters=2),
    "l0": lambda: ConstraintL0Pruning(kappa=4),
    "lowrank": lambda: LowRank(target_rank=2),
    "rank-selection": lambda: RankSelection(alpha=1e-3, max_rank=3),
}


def _plan(scheme, backend="torch", count=True):
    group, xs, thetas = representative_group(scheme, CPU)
    counts = [t.view.item_count(xs[t.name]) for t in group]
    fn, _ = grouping._task_solver(scheme, backend, CPU)
    if count:
        return grouping._plan_multi_group(group, xs, thetas, counts, fn,
                                          backend, CPU)
    plan_group = cost.plan_group

    def no_count(backend):
        raise ValueError("analytic plan")

    def uncounted(*args, **kw):
        kw["count_fn"] = no_count
        return plan_group(*args, **kw)

    cost.plan_group = uncounted
    try:
        return grouping._plan_multi_group(group, xs, thetas, counts, fn,
                                          backend, CPU)
    finally:
        cost.plan_group = plan_group


@pytest.mark.parametrize("family", sorted(FAMILIES))
@pytest.mark.parametrize("backend", ["torch", "cuda"])
def test_refined_plan_is_counted_and_keeps_the_decisions(family, backend):
    scheme = FAMILIES[family]()
    plan = _plan(scheme, backend)
    cost.clear_caches()
    analytic = _plan(scheme, backend, count=False)
    assert plan.source == "counted" and analytic.source == "analytic"
    assert (plan.backend, plan.n_chunks, plan.shard_mode) == \
        (analytic.backend, analytic.n_chunks, analytic.shard_mode)
    assert not any("hlo-refine" in f or "count-refine" in f
                   for f in plan.fallbacks)
    assert plan.flops > 0 and plan.bytes > 0
    assert plan.working_set_bytes == analytic.working_set_bytes


def test_a_cached_plan_holds_none_of_the_c_steps_tensors():
    # the count waits in the plan cache until a term is read: it must not
    # keep the items or Θ of the C step that made the plan alive
    group, xs, thetas = representative_group(FAMILIES["l0"](), CPU)
    counts = [t.view.item_count(xs[t.name]) for t in group]
    fn, _ = grouping._task_solver(group[0].scheme, "torch", CPU)
    refs = [weakref.ref(x) for x in tree_leaves((xs, thetas))]
    plan = grouping._plan_multi_group(group, xs, thetas, counts, fn,
                                      "torch", CPU)
    del xs, thetas
    gc.collect()
    assert [r() for r in refs] == [None] * len(refs)
    assert plan.source == "counted"


def test_a_failed_count_is_recorded_and_plans_stay_cached():
    calls = []

    def failing(backend):
        calls.append(backend)
        raise ValueError("no count")

    arrays = (torch.empty(4, 8, device="meta"),)
    kw = dict(requested_backend="torch", solver="topk_mask",
              registered=("cuda", "torch"), hw=cost.CPU,
              count_fn=failing)
    plan = cost.plan_group(("sig",), 4, arrays, arrays, **kw)
    assert plan.n_chunks == 1 and calls == []    # counted when read
    assert plan.source == "analytic"
    assert "count-refine-failed:ValueError" in plan.fallbacks
    again = cost.plan_group(("sig",), 4, arrays, arrays, **kw)
    assert again is plan and calls == ["torch"]    # cached: counted once
    assert cost.cache_stats()["plan_hits"] == 1


def _lowrank_difference(n_items: int, m: int, n: int, r_max: int,
                        sweeps: int = 12) -> float:
    """The port's counted product FLOPs less the reference's
    HLO-refined ones for a low-rank group on the exact Gram path (m > n,
    sketch ≥ n): Σ 2·|out|·(K − 1) over the same products, since the
    reference's ``analyze_hlo`` counts each of them as 2·|out| (ROADMAP
    §3)."""
    kp = n + n % 2
    gram = 2.0 * n_items * n * n * (m - 1)
    jacobi = 3 * sweeps * (kp - 1) * 2.0 * n_items * kp * kp * (kp - 1)
    back = 2.0 * n_items * m * n * (n - 1)
    decompress = 2.0 * n_items * m * n * (r_max - 1)
    return gram + jacobi + back + decompress


@pytest.mark.parametrize("family", ["lowrank", "rank-selection"])
def test_lowrank_counted_flops_against_the_references_hlo(family):
    from repro.analysis import cost as jcost
    from repro.analysis.lint import hlo_rules as jh
    from repro.core import grouping as jgrouping, schemes as js
    jscheme = {"lowrank": lambda: js.LowRank(target_rank=2),
               "rank-selection": lambda: js.RankSelection(
                   alpha=1e-3, max_rank=3)}[family]()
    jcost.clear_caches()
    group, xs, thetas = jh.representative_group(jscheme)
    counts = [t.view.item_count(xs[t.name]) for t in group]
    fn, _ = jgrouping._task_solver(jscheme, "jnp")
    jplan = jgrouping._plan_multi_group(group, xs, thetas, counts, fn, None,
                                        None, "jnp")
    plan = _plan(FAMILIES[family]())
    assert jplan.source == "hlo" and plan.source == "counted"
    r_max = 2 if family == "lowrank" else 3
    assert plan.flops - jplan.flops == _lowrank_difference(4, 12, 8, r_max)


# ----------------------------------------------------------------------
# Trace layer (twins of tests/test_lint_retrace.py)
# ----------------------------------------------------------------------
def _toy(mus=(1e-3, 1e-2, 1e-1), cls=LCAlgorithm, planner="on"):
    params = {"qa": torch.linspace(-1.0, 1.0, 32).reshape(2, 16),
              "pb": torch.linspace(1.0, -1.0, 32).reshape(2, 16)}
    tasks = [
        CompressionTask("lint/quant", "qa", AsStacked("vector"),
                        AdaptiveQuantization(k=2, iters=2)),
        CompressionTask("lint/prune", "pb", AsStacked("vector"),
                        ConstraintL0Pruning(kappa=8)),
    ]
    algo = cls(tasks, mu_schedule=list(mus), device="cpu", planner=planner)
    return algo, params, algo.init(params)


def test_overlapped_trainer_keys_each_program_once_across_3_boundaries():
    from repro_torch.configs import get_config, reduced_config
    from repro_torch.core import AsVector, exponential_mu_schedule
    from repro_torch.data import TokenStream
    from repro_torch.runtime import LCTrainer, TrainerConfig
    cfg = reduced_config(get_config("phi3-mini-3.8b")).with_(
        pattern_reps=1, dtype="float32")
    lc = LCAlgorithm(
        [CompressionTask("qg", r"stages/.*/w_gate$", AsVector(),
                         AdaptiveQuantization(k=2, iters=5)),
         CompressionTask("qu", r"stages/.*/w_up$", AsVector(),
                         AdaptiveQuantization(k=2, iters=5))],
        exponential_mu_schedule(1e-4, 1.5, 3), device="cpu")
    trainer = LCTrainer(cfg, lc, TokenStream(cfg.vocab_size, 2, 16),
                        tcfg=TrainerConfig(steps_per_l=2, overlap="on",
                                           lr=3e-4), device="cpu")
    record = trace_count.instrument(trainer.lc)
    trainer.run(0)
    assert record.boundaries == 3
    assert record and all(n == 1 for n in record.values()), dict(record)
    assert record.step_keys("c_step") and record.step_keys("multiplier_step")
    assert trace_count.retraces(record) == []


def test_async_entry_points_share_the_sync_programs():
    algo, params, lc = _toy()
    record = trace_count.instrument(algo)
    mu = float(algo.mu_schedule[0])
    for k in range(4):
        lc = algo.set_mu(lc, mu, k)
        if k % 2 == 0:
            lc = algo.c_step_async(params, lc)
            lc = algo.multiplier_step_async(params, lc)
        else:
            lc = algo.c_step(params, lc)
            lc = algo.multiplier_step(params, lc)
    assert dict(record) == {"c_step:task solve lint/quant": 1,
                            "c_step:task solve lint/prune": 1,
                            "multiplier_step": 1}


def test_run_boundaries_overlap_keys_once_and_flags_nothing():
    algo, params, lc = _toy()
    record = trace_count.instrument(algo)
    trace_count.run_boundaries(algo, params, lc, boundaries=3, overlap=True)
    assert set(record.values()) == {1}
    algo, params, lc = _toy()
    assert trace_count.check_retraces(algo, params, lc, boundaries=3,
                                      overlap=True) == []


class _ReleasingAlgo(LCAlgorithm):
    """The bug class: drops its graphs at every μ change (a
    ``set_mesh``/``release_graphs`` per boundary), so its capture policy
    restarts and no boundary replays."""

    def set_mu(self, lc, mu, k):
        self.release_graphs()
        return super().set_mu(lc, mu, k)


def test_releasing_boundary_trips_boundary_retrace():
    algo, params, lc = _toy(cls=_ReleasingAlgo)
    findings = trace_count.check_retraces(algo, params, lc, boundaries=2)
    assert sorted(f.context for f in findings) == [
        "lc-boundaries:c_step", "lc-boundaries:multiplier_step"]
    for f in findings:
        assert f.rule == "boundary-retrace"
        assert "ran no program across 3" in f.message


class _WideningMu(LCAlgorithm):
    """Hands μ over as a float64 tensor from the third boundary on: the
    multiplier step's program key (its inputs' dtypes) changes between
    identical boundaries."""

    def set_mu(self, lc, mu, k):
        lc = super().set_mu(lc, mu, k)
        if k >= 2:
            lc["mu"] = lc["mu"].double()
        return lc


def test_a_program_keyed_at_two_boundaries_trips_boundary_retrace():
    algo, params, lc = _toy(cls=_WideningMu)
    findings = trace_count.check_retraces(algo, params, lc, boundaries=3)
    assert _rules(findings) == ["boundary-retrace"]
    assert [f.context for f in findings] == ["lc-boundaries:multiplier_step"]
    assert "keyed 2× at boundaries [2, 3]" in findings[0].message


def test_instrument_counts_keys_not_calls():
    # same shapes twice is one key
    algo, params, lc = _toy()
    record = trace_count.instrument(algo)
    lc = trace_count.run_boundaries(algo, params, lc, 2)
    lc = algo.set_mu(lc, 1e-3, 2)
    algo.c_step(params, lc)
    algo.c_step(params, lc)
    assert record.step_keys("c_step") == 2 and set(record.values()) == {1}


def _two_groups():
    """A quantization group and a pruning group of two tasks each."""
    params = {n: torch.linspace(a, b, 32).reshape(2, 16) for n, (a, b) in {
        "qa": (-1.0, 1.0), "qb": (-3.0, 3.0), "pa": (1.0, -1.0),
        "pb": (2.0, -2.0)}.items()}
    tasks = [CompressionTask(f"q{n}", f"q{n}", AsStacked("vector"),
                             AdaptiveQuantization(k=2, iters=2))
             for n in "ab"]
    tasks += [CompressionTask(f"p{n}", f"p{n}", AsStacked("vector"),
                              ConstraintL0Pruning(kappa=k))
              for n, k in (("a", 8), ("b", 4))]
    return params, tasks


def test_the_c_step_counts_no_plan_until_a_term_is_read(monkeypatch):
    params, tasks = _two_groups()
    counted = []
    count_group = grouping.count_group

    def spy(*args, **kw):
        counted.append(kw.get("device"))
        return count_group(*args, **kw)

    monkeypatch.setattr(grouping, "count_group", spy)
    algo = LCAlgorithm(tasks, [1e-3, 1e-2, 1e-1], device="cpu")
    assert algo.planner == "on"
    lc = algo.init(params)
    for k, mu in enumerate(algo.mu_schedule):
        lc = algo.c_step(params, algo.set_mu(lc, mu, k))
    plans = [r["plan"] for r in algo.group_summary(params) if r["plan"]]
    assert len(plans) == 2 and counted == []
    # the decisions read no count; the first term read counts once a plan
    assert [(p["backend"], p["n_chunks"]) for p in plans] == \
        [("torch", 1), ("torch", 1)] and counted == []
    assert [p["source"] for p in plans] == ["counted", "counted"]
    assert counted == ["meta", "meta"]
    assert all(p.modeled_ms > 0 for p in plans) and len(counted) == 2


def test_planner_cache_probe_clean_and_its_controls(monkeypatch):
    params, tasks = _two_groups()

    def algo(planner="on"):
        a = LCAlgorithm(tasks, [1e-3, 1e-2], planner=planner, device="cpu")
        return a, params, a.init(params)

    assert trace_count.check_planner_cache(*algo(), boundaries=3) == []
    off = trace_count.check_planner_cache(*algo(None))
    assert _rules(off) == ["planner-inactive"]
    # an identity-bound plan key re-plans after every release
    plan_key = cost.plan_key
    seen = iter(range(10**6))
    monkeypatch.setattr(cost, "plan_key",
                        lambda *a, **k: plan_key(*a, **k) + (next(seen),))
    cost.clear_caches()
    replan = trace_count.check_planner_cache(*algo(), boundaries=2)
    assert _rules(replan) == ["planner-replan"]


def _engine_requests():
    from repro_torch.runtime.server import Request
    rng = np.random.default_rng(0)
    return [Request(id=i, prompt=rng.integers(1, 64, size=s)
                    .astype(np.int32), max_new=m, arrival=0.0)
            for i, (s, m) in enumerate([(3, 2), (5, 3), (9, 2)])]


def _engine():
    from repro_torch.analysis.lint.op_rules import serving_config
    from repro_torch.models.transformer import init_params
    from repro_torch.runtime.server import ServingEngine
    cfg = serving_config()
    params = init_params(torch.Generator().manual_seed(0), cfg)
    return ServingEngine(cfg, params, slots=2, max_len=16, prefill_chunk=4,
                         device="cpu")


def test_engine_keys_each_program_once_over_mixed_traffic():
    eng = _engine()
    assert trace_count.check_engine_retraces(eng, _engine_requests()) == []
    assert eng.trace_counts == {"decode": 1, "prefill": 1, "reset": 1}
    # read back without a second run
    assert trace_count.check_engine_retraces(eng) == []


def test_a_data_dependent_dtype_trips_engine_retrace():
    eng = _engine()
    decode, ticks = eng._decode, [0]

    def decode_widening(cache, tok, *rest):
        ticks[0] += 1
        return decode(cache, tok.long() if ticks[0] % 2 else tok, *rest)

    eng._decode = decode_widening
    findings = trace_count.check_engine_retraces(eng, _engine_requests())
    assert _rules(findings) == ["engine-retrace"]
    assert [f.context for f in findings] == ["serving-traffic:decode"]


class NoMetaPruning(ConstraintL0Pruning):
    """Its batched solve reads the data (a host read raises on meta
    tensors), so the planner's count on meta tensors fails."""

    def compress_batched(self, solve, w, theta, operands, mu=None):
        (kappa,) = operands
        if w.is_meta:
            raise NotImplementedError("no meta path")
        return {"theta": solve(w, kappa)}

    @classmethod
    def contract_examples(cls):
        return (cls(kappa=4),)


def test_a_plan_that_could_not_be_counted_is_a_count_failure():
    findings = check_planner_counts(classes=[NoMetaPruning], device=CPU)
    assert _rules(findings) == ["count-failed"]
    (f,) = findings
    assert f.context == "planner:NoMetaPruning[0]:meta"
    assert "NotImplementedError: no meta path" in f.message
    assert check_scheme_counts(classes=[NoMetaPruning], device=CPU) == []
