"""The port's C-step planner against the JAX package's, on the CPU.

``repro_torch.analysis.cost`` and the planner half of
``repro_torch.core.grouping`` against ``repro.analysis.cost`` and
``repro.core.grouping``, from the same numpy inputs:

* ``grouped_compress(planner="on")`` against the reference's with the
  planner on, for every family (quantization, ℓ0, ℓ1 as a constraint and
  as a penalty, low rank, rank selection, additive), within ROADMAP
  queue 3's tolerances (masks and elementwise maps equal, codebooks
  atol 1e-3, low-rank factors from the exact path atol 1e-4);
* in the port, planner on against off and a chunked solve
  (``CHUNK_BUDGET_BYTES`` forced small) against one launch, bit for bit,
  on the ``torch`` and ``cuda`` (plain kernel versions) backends;
* ``_chunk_bounds``, ``choose_chunks`` and ``estimate_terms`` equal to
  the reference's for the same shapes and budget;
* the plan and executable caches: hits across boundaries, misses on a
  change of shape or backend; ``compile_group`` equal to
  ``grouped_compress`` at two values of μ;
* ``LCAlgorithm``'s planner argument, and a full LC loop with the
  planner on against the reference's.
"""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.analysis import cost as jcost
from repro.core import (
    AsStacked as JAsStacked, CompressionTask as JTask, LCAlgorithm as JLC)
from repro.core import grouping as jgrouping
from repro.core import schemes as js
from repro_torch import interop
from repro_torch.analysis import cost
from repro_torch.core import AsStacked, CompressionTask, LCAlgorithm
from repro_torch.core import grouping
from repro_torch.core import schemes as ts
from repro_torch.kernels import build
from repro_torch.kernels.lowrank import lowrank
from repro_torch.tree import tree_leaves

k1 = importlib.import_module("repro_torch.kernels.kmeans.kmeans")

KMEANS_CB_ATOL = 1e-3

FAMILIES = {
    # name: (scheme maker over a schemes module, domain)
    "quant": (lambda s: s.AdaptiveQuantization(k=4, iters=3), "vector"),
    "l0": (lambda s: s.ConstraintL0Pruning(kappa=20), "vector"),
    "l1": (lambda s: s.ConstraintL1Pruning(kappa=4.0), "vector"),
    "l1-penalty": (lambda s: s.PenaltyL1Pruning(alpha=2e-4), "vector"),
    "lowrank": (lambda s: s.LowRank(target_rank=2), "matrix"),
    "rank-selection": (lambda s: s.RankSelection(alpha=1e-3, max_rank=4),
                       "matrix"),
    "additive": (lambda s: s.AdditiveCombination(
        [s.ConstraintL0Pruning(kappa=8),
         s.AdaptiveQuantization(k=2, iters=2)]), "vector"),
}


@pytest.fixture(autouse=True)
def _fresh_caches():
    cost.clear_caches()
    jcost.clear_caches()
    yield
    cost.CHUNK_BUDGET_BYTES = None
    cost.clear_caches()


def _inputs(family, n_tasks=2, n_items=3, seed=0):
    """Numpy items for ``n_tasks`` stacked tasks of ``n_items`` each."""
    item = (12, 8) if FAMILIES[family][1] == "matrix" else (64,)
    rng = np.random.default_rng(seed)
    return {f"t{i}": rng.standard_normal((n_items, *item))
            .astype(np.float32) for i in range(n_tasks)}


def _port_group(family, xs_np, jax_thetas=None):
    """The port's tasks, inputs and Θ (the reference's Θ carried over
    when given, else the port's own init)."""
    make, domain = FAMILIES[family]
    group = [CompressionTask(n, ".", AsStacked(domain), make(ts))
             for n in xs_np]
    xs = {n: torch.from_numpy(x.copy()) for n, x in xs_np.items()}
    if jax_thetas is None:
        thetas = {t.name: t.scheme_init(xs[t.name]) for t in group}
    else:
        thetas = {n: interop._theta_from_numpy(
            jax.tree_util.tree_map(np.asarray, th), "cpu")
            for n, th in jax_thetas.items()}
    return group, xs, thetas


def _jax_group(family, xs_np):
    make, domain = FAMILIES[family]
    group = [JTask(n, ".", JAsStacked(domain), make(js)) for n in xs_np]
    xs = {n: jnp.asarray(x) for n, x in xs_np.items()}
    thetas = {t.name: t.scheme_init(xs[t.name]) for t in group}
    return group, xs, thetas


def _mu(mu):
    return torch.tensor(mu, dtype=torch.float32)


def _assert_same(a, b, msg=""):
    la, lb = tree_leaves(a), tree_leaves(b)
    assert len(la) == len(lb), msg
    for x, y in zip(la, lb):
        assert x.shape == y.shape and x.dtype == y.dtype, msg
        assert torch.equal(x, y), msg


# ----------------------------------------------------------------------
# the port against the reference, planner on
# ----------------------------------------------------------------------
@pytest.mark.parametrize("family", list(FAMILIES))
def test_planner_on_matches_the_reference(family):
    xs_np = _inputs(family)
    jgroup, jxs, jthetas = _jax_group(family, xs_np)
    group, xs, thetas = _port_group(family, xs_np, jthetas)
    mu = 1e-2
    jout = jax.jit(lambda x, th: jgrouping.grouped_compress(
        jgroup, x, th, jnp.float32(mu), backend="auto", planner="on"))(
            jxs, jthetas)
    out = grouping.grouped_compress(group, xs, thetas, _mu(mu),
                                    backend="auto", device="cpu",
                                    planner="on")
    # the static rule's backend (the reference's jnp), in one launch
    (row,) = [r for r in grouping.describe_groups(
        group, xs, backend="auto", device="cpu", planner="on") if r["plan"]]
    assert (row["plan"]["n_chunks"], row["plan"]["backend"]) == (1, "torch")
    for t in group:
        th, a = out[t.name]
        jth, ja = jout[t.name]
        if family in ("quant", "additive", "lowrank", "rank-selection"):
            # codebooks (KMEANS_CB_ATOL), factors from the exact Gram path
            tol = KMEANS_CB_ATOL if family in ("quant", "additive") else 1e-4
            np.testing.assert_allclose(a.numpy(), np.asarray(ja), atol=tol)
            if family == "rank-selection":
                np.testing.assert_array_equal(th["rank"].numpy(),
                                              np.asarray(jth["rank"]))
        elif family == "l1":
            # a sort + cumsum reduction
            np.testing.assert_allclose(a.numpy(), np.asarray(ja),
                                       rtol=1e-6, atol=1e-6)
        else:
            # masks and elementwise maps: bit for bit
            np.testing.assert_array_equal(a.numpy(), np.asarray(ja))


# ----------------------------------------------------------------------
# the port: planner on = off = chunked, bit for bit
# ----------------------------------------------------------------------
def _compress(family, backend, planner, mu=1e-2):
    group, xs, thetas = _port_group(family, _inputs(family, seed=1))
    return grouping.grouped_compress(group, xs, thetas, _mu(mu),
                                     backend=backend, device="cpu",
                                     planner=planner)


#: (family, backend): ``cuda`` only where the solver has a CUDA
#: implementation (elsewhere it resolves to the same ``torch`` solver)
CASES = [(f, b) for f in FAMILIES for b in ("torch", "cuda")
         if b == "torch" or f in ("quant", "l0")]


@pytest.mark.parametrize("family,backend", CASES)
def test_planner_on_equals_off_bit_for_bit(family, backend):
    _assert_same(_compress(family, backend, "on"),
                 _compress(family, backend, None), f"{family} {backend}")


#: the cases whose solver is chunk-exact (``dispatch.chunk_exact``): K1
#: in its group's partition, K2's integer counts, a stable argsort,
#: elementwise maps, the item-by-item path
EXACT = {("quant", "cuda"), ("l0", "torch"), ("l0", "cuda"),
         ("l1-penalty", "torch"), ("additive", "torch")}


@pytest.mark.parametrize("split", ["one item a launch", "spanning tasks"])
@pytest.mark.parametrize("family,backend", CASES)
def test_chunked_solve_equals_one_launch(family, backend, split):
    """6 items in 2 tasks: one item a launch, or 4 launches (2, 2, 1, 1
    items), the second across the tasks' boundary. A solver whose result
    depends on the batch (float sums and scans, batched matmuls) stays
    in one launch, and its plan says why."""
    baseline = _compress(family, backend, None)
    group, xs, thetas = _port_group(family, _inputs(family, seed=1))
    counts = [3, 3]
    solver_fn, _ = grouping._task_solver(group[0].scheme, backend, "cpu")
    plan = grouping._plan_multi_group(group, xs, thetas, counts, solver_fn,
                                      backend, "cpu")
    cost.CHUNK_BUDGET_BYTES = (1 if split == "one item a launch"
                               else plan.working_set_bytes // 4 + 1)
    cost.clear_caches()          # the budget is not in the plan key
    plan = grouping._plan_multi_group(group, xs, thetas, counts, solver_fn,
                                      backend, "cpu")
    if (family, backend) in EXACT:
        assert plan.n_chunks == (6 if split == "one item a launch" else 4)
    else:
        assert plan.n_chunks == 1 and any(
            f.startswith("chunking-disabled:") for f in plan.fallbacks)
    _assert_same(_compress(family, backend, "on"), baseline,
                 f"{family} {backend} {split}")


def test_chunks_take_the_groups_partition():
    """A chunk's K1 launch is partitioned as its group's one launch."""
    grid = 528
    assert k1._blocks_per_item(2, 1 << 26, grid) == grid // 2
    with build.group_partition(6):
        assert build.partition_items(2) == 6
        assert k1._blocks_per_item(2, 1 << 26, grid) == grid // 6
    assert build.partition_items(2) == 2


# ----------------------------------------------------------------------
# the cost model's arithmetic against the reference's
# ----------------------------------------------------------------------
def test_chunk_bounds_and_choose_chunks_match_the_reference():
    for n, k in [(1, 1), (6, 2), (6, 4), (7, 3), (5, 9), (64, 7)]:
        assert grouping._chunk_bounds(n, k) == jgrouping._chunk_bounds(n, k)
    assert tuple(getattr(cost.CPU, f) for f in (
        "peak_flops", "hbm_bw", "link_bw", "vmem_bytes", "hbm_bytes")) == \
        tuple(getattr(jcost.CPU, f) for f in (
            "peak_flops", "hbm_bw", "link_bw", "vmem_bytes", "hbm_bytes"))
    for budget in (None, 10, 1000):
        cost.CHUNK_BUDGET_BYTES = jcost.CHUNK_BUDGET_BYTES = budget
        try:
            for ws, n in [(100, 8), (35, 8), (1 << 30, 8), (1 << 40, 3),
                          (0, 1)]:
                assert cost.choose_chunks(ws, n, cost.CPU) == \
                    jcost.choose_chunks(ws, n, jcost.CPU)
        finally:
            jcost.CHUNK_BUDGET_BYTES = None
    # a quarter of the card's memory
    h100 = cost.H100.__class__(**{**cost.H100.__dict__,
                                  "hbm_bytes": 80 * 2**30})
    cost.CHUNK_BUDGET_BYTES = None
    assert cost.chunk_budget(h100) == 20 * 2**30


@pytest.mark.parametrize("solver,sig", [
    ("kmeans_lloyd", ("batched", "kmeans_lloyd", ("quant-kmeans", 10))),
    ("topk_mask", ("batched", "topk_mask", ("prune-l0",))),
    ("lowrank_rsvd", ("batched", "lowrank_rsvd", ("lowrank-rsvd",), 256)),
    ("rank_select", ("rank-select", "storage", 64)),
    ("soft_threshold", ("l1",)),
    (None, ("quant-kmeans", 16, 25))])
def test_estimate_terms_matches_the_reference(solver, sig):
    shapes = [((8, 4096), np.float32), ((8, 16), np.float32),
              ((8,), np.int32)]
    out = [((8, 4096), np.float32), ((8, 4096), np.int32)]
    arrays = tuple(torch.empty(s, dtype=torch.from_numpy(np.zeros(1, d))
                               .dtype, device="meta") for s, d in shapes)
    outs = tuple(torch.empty(s, dtype=torch.from_numpy(np.zeros(1, d))
                             .dtype, device="meta") for s, d in out)
    jarrays = tuple(jax.ShapeDtypeStruct(s, d) for s, d in shapes)
    jouts = tuple(jax.ShapeDtypeStruct(s, d) for s, d in out)
    got = cost.estimate_terms(sig, solver, arrays, outs, cost.CPU)
    want = jcost.estimate_terms(sig, solver, jarrays, jouts, jcost.CPU)
    for k in ("flops", "bytes", "coll_bytes", "t_compute", "t_memory",
              "t_collective", "working_set_bytes"):
        assert got[k] == want[k], k


def test_hardware_specs_and_backend_choice(monkeypatch):
    assert cost.detect_hardware("cpu") is cost.CPU
    assert cost.detect_hardware("meta") is cost.CPU
    cost._card_spec.cache_clear()
    props = type("P", (), {"total_memory": 85_000_000_000})
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda i: props)
    monkeypatch.setattr(torch.cuda, "get_device_name",
                        lambda i: "NVIDIA H100 80GB HBM3")
    hw = cost.detect_hardware("cuda:0")
    assert (hw.name, hw.hbm_bytes, hw.peak_flops, hw.hbm_bw) == \
        ("h100", 85_000_000_000, 67e12, 3.35e12)
    assert hw.vmem_bytes == 227 * 1024 and hw.link_bw == 450e9
    cost._card_spec.cache_clear()
    monkeypatch.setattr(torch.cuda, "get_device_name",
                        lambda i: "NVIDIA A100-SXM4-80GB")
    with pytest.raises(ValueError, match="A100"):
        cost.detect_hardware("cuda:0")
    cost._card_spec.cache_clear()
    terms = {"flops": 1.0, "bytes": 1.0, "working_set_bytes": 1}
    # explicit requests are honored; auto is the static rule
    assert cost.choose_backend("torch", "kmeans_lloyd", ("cuda", "torch"),
                               terms, hw) == ("torch", [])
    assert cost.choose_backend("auto", "kmeans_lloyd", ("cuda", "torch"),
                               terms, cost.CPU) == ("torch", [])
    assert cost.choose_backend("auto", "kmeans_lloyd", ("cuda", "torch"),
                               terms, hw) == ("cuda", [])
    b, fb = cost.choose_backend("auto", "lowrank_rsvd", ("torch",), terms,
                                hw)
    assert b == "torch" and fb == [
        "backend:cuda-unregistered-for-lowrank_rsvd->torch"]


# ----------------------------------------------------------------------
# caches and compile_group
# ----------------------------------------------------------------------
def _probe(pkg):
    params = {
        "qa": np.linspace(-1.0, 1.0, 64).reshape(4, 16),
        "qb": np.linspace(-3.0, 3.0, 64).reshape(4, 16),
        "pa": np.linspace(1.0, -1.0, 64).reshape(4, 16),
        "pb": np.linspace(2.0, -2.0, 64).reshape(4, 16),
    }
    params = {k: v.astype(np.float32) for k, v in params.items()}
    T, S, s = (CompressionTask, AsStacked, ts) if pkg == "torch" else \
        (JTask, JAsStacked, js)
    tasks = [T("qa", "qa", S("vector"), s.AdaptiveQuantization(k=2, iters=2)),
             T("qb", "qb", S("vector"), s.AdaptiveQuantization(k=2, iters=2)),
             T("pa", "pa", S("vector"), s.ConstraintL0Pruning(kappa=8)),
             T("pb", "pb", S("vector"), s.ConstraintL0Pruning(kappa=4))]
    if pkg == "torch":
        return (LCAlgorithm(tasks, [1e-3, 2e-3, 4e-3], device="cpu"),
                {k: torch.from_numpy(v) for k, v in params.items()})
    return (JLC(tasks, [1e-3, 2e-3, 4e-3]),
            {k: jnp.asarray(v) for k, v in params.items()})


def _loop(algo, params):
    lc = algo.init(params)
    for k, mu in enumerate(algo.mu_schedule):
        lc = algo.set_mu(lc, mu, k)
        lc = algo.c_step(params, lc)
        lc = algo.multiplier_step(params, lc)
    return lc


def test_plan_cache_hits_across_boundaries_and_misses_on_change():
    algo, params = _probe("torch")
    assert algo.planner == "on"
    _loop(algo, params)
    stats = cost.cache_stats()
    assert stats["plan_entries"] == stats["plan_misses"] == 2
    assert stats["plan_hits"] == 2 * (len(algo.mu_schedule) - 1)
    meta = torch.empty((4, 64), device="meta")
    base = cost.plan_key(("quant", 4), 4, (meta,), "auto", cost.CPU)
    assert base == cost.plan_key(("quant", 4), 4,
                                 (torch.empty((4, 64)),), "auto", cost.CPU)
    assert base != cost.plan_key(("quant", 8), 4, (meta,), "auto", cost.CPU)
    assert base != cost.plan_key(("quant", 4), 8, (meta,), "auto", cost.CPU)
    assert base != cost.plan_key(("quant", 4), 4, (meta,), "cuda", cost.CPU)
    assert base != cost.plan_key(("quant", 4), 4,
                                 (torch.empty((4, 32), device="meta"),),
                                 "auto", cost.CPU)
    assert base != cost.plan_key(("quant", 4), 4, ((meta,),), "auto",
                                 cost.CPU)


@pytest.mark.parametrize("family", ["quant", "l0", "l1-penalty",
                                    "rank-selection"])
def test_compile_group_hits_and_equals_grouped_compress(family):
    """One miss, then hits only; at two μ the executable's packed output
    equals ``grouped_compress``'s bit for bit."""
    group, xs, thetas = _port_group(family, _inputs(family, seed=2))
    exe, arrays = grouping.compile_group(group, xs, thetas, backend="auto",
                                         device="cpu")
    for _ in range(3):
        assert grouping.compile_group(group, xs, thetas, backend="auto",
                                      device="cpu")[0] is exe
    stats = cost.cache_stats()
    assert (stats["exec_misses"], stats["exec_hits"]) == (1, 3)
    for mu in (1e-3, 2e-2):
        theta_packed, a_packed = exe(_mu(mu), *arrays)
        ref = grouping.grouped_compress(group, xs, thetas, _mu(mu),
                                        backend="auto", device="cpu")
        assert torch.equal(a_packed, torch.cat(
            [t.view.to_items(ref[t.name][1]) for t in group]))
        for t, n in zip(group, (3, 3)):
            off = 3 * group.index(t)
            _assert_same(
                grouping.slice_theta_like(
                    type(theta_packed)(**{k: v[off:off + n] for k, v in
                                          theta_packed.items()})
                    if isinstance(theta_packed, dict) else
                    type(theta_packed)(*(v[off:off + n]
                                         for v in theta_packed)),
                    ref[t.name][0]), ref[t.name][0], family)
    # a new shape or another backend: another executable
    g3, x3, th3 = _port_group(family, _inputs(family, n_items=4, seed=2))
    grouping.compile_group(g3, x3, th3, backend="auto", device="cpu")
    grouping.compile_group(group, xs, thetas, backend="off", device="cpu")
    assert cost.cache_stats()["exec_misses"] == 3


def test_held_sketches_draw_each_sketch_once():
    keys = torch.tensor([5, 9], dtype=torch.int64)
    store = {}
    with lowrank.held_sketches(store):
        a = lowrank.gaussian_sketch(keys, 6, 3, "cpu")
        assert lowrank.gaussian_sketch(keys, 6, 3, "cpu") is a
        b = lowrank.gaussian_sketch(keys + 1, 6, 3, "cpu")
    assert len(store) == 2 and not torch.equal(a, b)
    assert torch.equal(lowrank.gaussian_sketch(keys, 6, 3, "cpu"), a)


# ----------------------------------------------------------------------
# LCAlgorithm
# ----------------------------------------------------------------------
def test_planner_argument_validation_and_group_summary():
    algo, params = _probe("torch")
    with pytest.raises(ValueError, match="planner"):
        LCAlgorithm(algo.tasks, [1e-3], planner="bogus", device="cpu")
    with pytest.raises(ValueError, match="planner"):
        algo.set_planner("maybe")
    assert algo.set_planner(None).planner is None
    assert all(r["plan"] is None for r in algo.group_summary(params))
    algo.set_planner("on")
    rows = [r for r in algo.group_summary(params) if r["plan"]]
    jalgo, jparams = _probe("jax")
    jrows = [r for r in jalgo.group_summary(jparams) if r["plan"]]
    assert [r["tasks"] for r in rows] == [r["tasks"] for r in jrows]
    for r, jr in zip(rows, jrows):
        plan = r["plan"]
        assert plan["backend"] == r["backend"] == "torch"
        assert plan["n_chunks"] == jr["plan"]["n_chunks"] == 1
        assert plan["source"] == "analytic" and plan["block_rows"] is None
        assert plan["shard_mode"] == "none" and plan["hardware"] == "cpu"
        assert plan["bottleneck"] in ("compute", "memory", "collective")
        assert plan["modeled_ms"] > 0.0 and plan["fallbacks"]
    # an init that reads values (ternary thresholds) has no shapes-only
    # run: its group is planned from the items, and the plan says so
    tern = [CompressionTask(n, n, AsStacked("vector"), ts.Ternarize())
            for n in ("qa", "qb")]
    (row,) = LCAlgorithm(tern, [1e-3], device="cpu").group_summary(params)
    assert any(f.startswith("theta-shapes-unknown")
               for f in row["plan"]["fallbacks"])


def test_full_lc_loop_with_the_planner_matches_the_reference():
    """Three boundaries (C step and multipliers at rising μ): the port's
    state with the planner on equals its planner-off state bit for bit,
    and the reference's planner-on state within the tolerances."""
    algo, params = _probe("torch")
    on = _loop(algo, params)
    off = _loop(_probe("torch")[0].set_planner("off"), params)
    for name in on["tasks"]:
        _assert_same(on["tasks"][name], off["tasks"][name], name)
    jalgo, jparams = _probe("jax")
    jon = _loop(jalgo, jparams)
    for name in ("pa", "pb"):
        # the support bit for bit; the kept values w − λ/μ carry the
        # multipliers' rounding over the boundaries (rtol 1e-6)
        th = on["tasks"][name]["theta"]["theta"].numpy()
        jth = np.asarray(jon["tasks"][name]["theta"]["theta"])
        np.testing.assert_array_equal(th != 0, jth != 0)
        np.testing.assert_allclose(th, jth, rtol=1e-6, atol=1e-7)
    for name in ("qa", "qb"):
        np.testing.assert_allclose(
            on["tasks"][name]["theta"].codebook.numpy(),
            np.asarray(jon["tasks"][name]["theta"].codebook),
            atol=KMEANS_CB_ATOL)
        np.testing.assert_array_equal(
            on["tasks"][name]["theta"].assign.numpy(),
            np.asarray(jon["tasks"][name]["theta"].assign))
    for name in jon["tasks"]:
        for path, lam in jon["tasks"][name]["lam"].items():
            np.testing.assert_allclose(
                on["tasks"][name]["lam"][path].numpy(), np.asarray(lam),
                rtol=1e-6, atol=1e-6)
