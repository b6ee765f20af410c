"""The port's compiled LC driver, ``LCAlgorithm(jit_c_step=True)``, on
the CPU: its programs run eagerly here (``graphs.Programs`` with
``graphs=False``), the same code that the card captures.

* Every scheme family in one LC problem (k-means, top-κ, ℓ1 ball,
  soft-threshold, low rank, rank selection, Binarize, Ternarize,
  ``PenaltyL0Pruning``, ``AdditiveCombination``, two singletons), with
  the planner's chunk budget forced small so that the chunk-exact
  groups split: three boundaries of the port's compiled driver against
  the JAX package's ``LCAlgorithm(jit_c_step=True)`` from the same numpy
  weights, within ROADMAP queue 3's tolerances (masks, signs and
  assignments bit for bit; the kept values and the multipliers, which
  carry λ's rounding over the boundaries, rtol 1e-6; codebooks atol
  1e-3; the low-rank factors from the exact Gram path atol 1e-4, ranks
  equal).
* ``jit_c_step=True`` against ``False``: Θ, ``a``, λ and the three
  monitors per boundary bit for bit, on the grouped and per-task paths,
  sync and async.
* With stand-ins for the CUDA calls (capture records nothing, replay
  runs nothing): no capture in a run with one C step; after the second
  boundary one graph a group (a chunk size where the planner splits
  it), a singleton and a step, and none after.
* ``LCTrainer``, serial and overlapped, with the compiled driver equal
  to the eager one record by record and state by state.
"""
import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro.core import (AsIs as JAsIs, AsStacked as JAsStacked,
                        CompressionTask as JTask, LCAlgorithm as JLC)
from repro.core import schemes as js
from repro_torch import graphs
from repro_torch.analysis import cost
from repro_torch.configs import get_config, reduced_config
from repro_torch.core import (AsIs, AsStacked, AsVector, CompressionTask,
                              LCAlgorithm, exponential_mu_schedule)
from repro_torch.core import schemes as ts
from repro_torch.data import TokenStream
from repro_torch.runtime import LCTrainer, TrainerConfig
from repro_torch.tree import tree_leaves
from torch_threads import _one_torch_thread  # noqa: F401

MUS = [1e-3, 2e-3, 4e-3]
KMEANS_CB_ATOL = 1e-3

#: family: (scheme maker over a schemes module, domain); two tasks each
FAMILIES = {
    "quant": (lambda s, i: s.AdaptiveQuantization(k=(4, 2)[i], iters=3),
              "vector"),
    "l0": (lambda s, i: s.ConstraintL0Pruning(kappa=(20, 8)[i]), "vector"),
    "l1": (lambda s, i: s.ConstraintL1Pruning(kappa=4.0), "vector"),
    "l1-penalty": (lambda s, i: s.PenaltyL1Pruning(alpha=2e-4), "vector"),
    "lowrank": (lambda s, i: s.LowRank(target_rank=2), "matrix"),
    "rank-selection": (lambda s, i: s.RankSelection(alpha=1e-3,
                                                    max_rank=4), "matrix"),
    "binarize": (lambda s, i: s.Binarize(), "vector"),
    "ternarize": (lambda s, i: s.Ternarize(), "vector"),
    "l0-penalty": (lambda s, i: s.PenaltyL0Pruning(alpha=1e-4), "vector"),
    "additive": (lambda s, i: s.AdditiveCombination(
        [s.ConstraintL0Pruning(kappa=8),
         s.AdaptiveQuantization(k=2, iters=2)]), "vector"),
}
#: singletons (an item shape no other task has): the per-task program
SOLOS = {"solo-quant": (lambda s: s.AdaptiveQuantization(k=4, iters=3),
                        (2, 32)),
         "solo-lowrank": (lambda s: s.LowRank(target_rank=3), (12, 10))}


def _params_np() -> dict:
    rng = np.random.default_rng(0)
    out = {}
    for f, (_, domain) in FAMILIES.items():
        shape = (3, 12, 8) if domain == "matrix" else (3, 64)
        for i in range(2):
            out[f"{f}{i}"] = rng.standard_normal(shape).astype(np.float32)
    for name, (_, shape) in SOLOS.items():
        out[name] = rng.standard_normal(shape).astype(np.float32)
    return out


def _tasks(pkg: str) -> list:
    s, T, S, I = ((ts, CompressionTask, AsStacked, AsIs) if pkg == "torch"
                  else (js, JTask, JAsStacked, JAsIs))
    tasks = [T(f"{f}{i}", f"^{f}{i}$", S(domain), make(s, i))
             for f, (make, domain) in FAMILIES.items() for i in range(2)]
    tasks.append(T("solo-quant", "^solo-quant$", S("vector"),
                   SOLOS["solo-quant"][0](s)))
    tasks.append(T("solo-lowrank", "^solo-lowrank$", I(),
                   SOLOS["solo-lowrank"][0](s)))
    return tasks


@pytest.fixture(autouse=True)
def _small_chunk_budget():
    """Every chunk-exact group splits into launches of one item."""
    cost.CHUNK_BUDGET_BYTES = 1
    cost.clear_caches()
    yield
    cost.CHUNK_BUDGET_BYTES = None
    cost.clear_caches()


def _loop(algo, params, asynchronous=False, n=len(MUS)):
    """``n`` boundaries at MUS: the §7 monitor around the C step, the
    multiplier step, the distortion. Returns the LC state and one record
    a boundary (the three monitors and the state's leaves, copied)."""
    c_step = algo.c_step_async if asynchronous else algo.c_step
    mult = (algo.multiplier_step_async if asynchronous
            else algo.multiplier_step)
    lc = algo.init(params)
    records = []
    for k in range(n):
        lc = algo.set_mu(lc, MUS[k % len(MUS)], k)
        pre = algo.shifted_distortion(params, lc)
        lc = c_step(params, lc)
        post = algo.shifted_distortion(params, lc)
        lc = mult(params, lc)
        dist = algo.distortion(params, lc)
        records.append(([pre, post, dist],
                        [x.clone() for x in tree_leaves(lc["tasks"])]))
    return lc, records


def _port(jit=True, group_tasks=True):
    return LCAlgorithm(_tasks("torch"), MUS, group_tasks=group_tasks,
                       device="cpu", jit_c_step=jit)


def _torch_params():
    return {k: torch.from_numpy(v) for k, v in _params_np().items()}


# ----------------------------------------------------------------------
# the port against the JAX package, both compiled
# ----------------------------------------------------------------------
@pytest.fixture(scope="module")
def both():
    cost.CHUNK_BUDGET_BYTES = 1
    cost.clear_caches()
    algo = _port()
    params = _torch_params()
    ours, _ = _loop(algo, params)
    jalgo = JLC(_tasks("jax"), MUS, jit_c_step=True)
    jparams = {k: jnp.asarray(v) for k, v in _params_np().items()}
    lc = jalgo.init(jparams)
    for k, mu in enumerate(MUS):
        lc = jalgo.set_mu(lc, mu, k)
        lc = jalgo.c_step(jparams, lc)
        lc = jalgo.multiplier_step(jparams, lc)
    theirs = jax.tree_util.tree_map(np.asarray, lc)
    chunked = [r for r in algo.group_summary(params)
               if r["plan"] and r["plan"]["n_chunks"] > 1]
    cost.CHUNK_BUDGET_BYTES = None
    return ours, theirs, chunked


def _names(family):
    if family in SOLOS:
        return [family]
    return [f"{family}{i}" for i in range(2)]


@pytest.mark.parametrize("family", list(FAMILIES) + list(SOLOS))
def test_compiled_driver_matches_the_reference_over_three_boundaries(
        both, family):
    ours, theirs, chunked = both
    if family in ("l0", "l1-penalty", "additive", "binarize"):
        # the chunk-exact groups ran in launches of one item each
        assert any(r["tasks"] == _names(family) and r["plan"]["n_chunks"]
                   == 6 for r in chunked), chunked
    for name in _names(family):
        o, t = ours["tasks"][name], theirs["tasks"][name]
        ((path, a),) = o["a"].items()
        a, ja = a.numpy(), t["a"][path]
        th, jth = o["theta"], t["theta"]
        if family in ("quant", "solo-quant"):
            np.testing.assert_allclose(th.codebook.numpy(), jth.codebook,
                                       atol=KMEANS_CB_ATOL)
            np.testing.assert_array_equal(th.assign.numpy(), jth.assign)
        elif family in ("l0", "l1-penalty", "l0-penalty"):
            np.testing.assert_array_equal(a != 0, ja != 0)
            np.testing.assert_allclose(a, ja, rtol=1e-6, atol=1e-7)
        elif family == "l1":
            # a sort + cumsum reduction (the planner tests' tolerance)
            np.testing.assert_array_equal(a != 0, ja != 0)
            np.testing.assert_allclose(a, ja, rtol=1e-6, atol=1e-6)
        elif family in ("binarize", "ternarize"):
            np.testing.assert_array_equal(th["sign"].numpy(), jth["sign"])
            np.testing.assert_allclose(th["scale"].numpy(), jth["scale"],
                                       rtol=1e-6)
        elif family == "additive":
            np.testing.assert_allclose(a, ja, atol=KMEANS_CB_ATOL)
        else:
            # low rank and rank selection: equal ranks, and each package's
            # last C step within 1e-4 of the exact SVD's distortion of its
            # own input (near-equal singular values leave the subspace
            # loose, and the multipliers then differ with it)
            ranks = th["rank"].numpy() if "rank" in th else 2 + (
                family == "solo-lowrank")
            if family == "rank-selection":
                np.testing.assert_array_equal(ranks, jth["rank"])
            for d, lam in ((a, o["lam"][path].numpy()),
                           (ja, t["lam"][path])):
                assert (_excess(d, lam, ranks) <= 1e-4).all(), family
            continue
        np.testing.assert_allclose(o["lam"][path].numpy(), t["lam"][path],
                                   rtol=1e-6, atol=1e-6)


def _excess(a, lam, ranks):
    """The relative excess of the last C step's distortion over the exact
    rank-r SVD's, item by item: its input was w − λ_before/μ = a − λ/μ
    (λ = λ_before − μ(w − a)), so its distortion is ‖λ/μ‖²."""
    x = (a.astype(np.float64) - lam / MUS[-1]).reshape(-1, *a.shape[-2:])
    s = np.linalg.svd(x, compute_uv=False)
    ranks = np.broadcast_to(ranks, (len(x),))
    tail = np.array([np.sum(si[r:] ** 2) for si, r in zip(s, ranks)])
    got = np.sum((x - a.reshape(x.shape)) ** 2, axis=(1, 2))
    return (got - tail) / tail


# ----------------------------------------------------------------------
# the port: compiled against eager, bit for bit
# ----------------------------------------------------------------------
@pytest.mark.parametrize("asynchronous", [False, True], ids=["sync", "async"])
@pytest.mark.parametrize("group_tasks", [True, False],
                         ids=["grouped", "per-task"])
def test_compiled_equals_eager_bit_for_bit(group_tasks, asynchronous):
    params = _torch_params()
    algo = _port(True, group_tasks)
    _, got = _loop(algo, params, asynchronous)
    _, want = _loop(_port(False, group_tasks), params, asynchronous)
    for k, ((gm, gs), (wm, ws)) in enumerate(zip(got, want)):
        for g, w in zip(gm, wm):
            assert g.keys() == w.keys()
            assert all(torch.equal(g[n], w[n]) for n in g), k
        assert len(gs) == len(ws)
        assert all(torch.equal(x, y) for x, y in zip(gs, ws)), k
    # the compiled driver ran its solves and steps through its programs
    # from their second call on
    assert set(algo._steps) == {"shifted distortion", "multipliers",
                                "distortion"}
    assert algo._compiled.tasks and (algo._compiled.executables
                                     or not group_tasks)


def test_async_steps_write_nothing_and_sync_steps_keep_their_tensors():
    algo = _port()
    params = _torch_params()
    lc = algo.init(params)
    for k, mu in enumerate(MUS):
        lc = algo.set_mu(lc, mu, k)
        before = [x.clone() for x in tree_leaves(lc["tasks"])]
        a_ptrs = [x.data_ptr() for t in lc["tasks"].values()
                  for x in t["a"].values()]
        new = algo.multiplier_step_async(params,
                                         algo.c_step_async(params, lc))
        assert all(torch.equal(x, y) for x, y in
                   zip(before, tree_leaves(lc["tasks"])))
        lc = algo.multiplier_step(params, algo.c_step(params, lc))
        # c_step writes ``a`` in place, and agrees with the async step
        assert a_ptrs == [x.data_ptr() for t in lc["tasks"].values()
                          for x in t["a"].values()]
        assert all(torch.equal(x, y) for x, y in
                   zip(tree_leaves(new["tasks"]), tree_leaves(lc["tasks"])))


def test_the_drivers_copies_follow_in_place_writes():
    """The compiled steps read the driver's copies of w, λ and ``a``,
    copied again only where a tensor is new or was written since: after
    in-place writes to a weight, to λ and to ``a`` (and with one weight
    replaced) the three steps still equal the eager driver's."""
    params = _torch_params()
    algo, eager = _port(), _port(False)
    lc, _ = _loop(algo, params, n=2)
    eager.resolve(params)
    params["quant0"].mul_(1.5)
    params["l00"] = params["l00"] + 0.25
    next(iter(lc["tasks"]["quant1"]["lam"].values())).add_(1e-3)
    next(iter(lc["tasks"]["l01"]["a"].values())).mul_(0.5)
    for name in ("distortion", "shifted_distortion"):
        got, want = (getattr(d, name)(params, lc) for d in (algo, eager))
        assert all(torch.equal(got[n], want[n]) for n in want), name
    got = algo.multiplier_step_async(params, lc)
    want = eager.multiplier_step_async(params, lc)
    assert all(torch.equal(x, y) for x, y in zip(
        tree_leaves(got["tasks"]), tree_leaves(want["tasks"])))
    # the driver's copy of λ now holds the async step's λ, not lc's
    got, want = (d.shifted_distortion(params, lc) for d in (algo, eager))
    assert all(torch.equal(got[n], want[n]) for n in want)


# ----------------------------------------------------------------------
# captures, with stand-ins for the CUDA calls
# ----------------------------------------------------------------------
class _StandInGraph:
    def replay(self):
        pass


@pytest.fixture
def stand_ins(monkeypatch):
    @contextlib.contextmanager
    def capture(graph, pool, stream):
        yield

    monkeypatch.setattr(graphs, "_new_graph", _StandInGraph)
    monkeypatch.setattr(graphs, "_capturing", capture)
    monkeypatch.setattr(graphs, "_on", lambda s: contextlib.nullcontext())
    monkeypatch.setattr(graphs, "_join", lambda waiter, stream: None)
    monkeypatch.setattr(graphs, "_current", lambda device: None)
    monkeypatch.setattr(graphs.Programs, "stream_buffers", lambda self: [])


def _captured_driver(group_tasks=True):
    algo = _port(True, group_tasks)
    algo.programs.graphs = True
    return algo


@pytest.mark.parametrize("group_tasks", [True, False],
                         ids=["grouped", "per-task"])
def test_one_graph_a_solve_and_a_step_then_replays_only(stand_ins,
                                                        group_tasks):
    params = _torch_params()
    algo = _captured_driver(group_tasks)
    # a run with one C step (init, C step, multipliers): nothing captured
    _loop(algo, params, n=1)
    assert algo.programs.captured == 0 and not algo._staged
    assert cost.cache_stats()["exec_misses"] == 0
    algo = _captured_driver(group_tasks)
    _loop(algo, params, n=2)
    groups = [r for r in algo.group_summary(params) if r["grouped"]]
    n_solves = (len(groups) + len(algo.tasks) - sum(len(r["tasks"])
                                                    for r in groups)
                if group_tasks else len(algo.tasks))
    assert algo.programs.captured == n_solves + 3
    stats = cost.cache_stats()
    assert stats["exec_misses"] == (len(groups) if group_tasks else 0)
    _loop(algo, params, n=2)    # init again: new LC state tensors
    assert algo.programs.captured == n_solves + 3
    assert cost.cache_stats()["exec_misses"] == stats["exec_misses"]
    counts = {p.name: p.counts[p.name] for p in algo._steps.values()}
    assert counts == {"shifted distortion": 1, "multipliers": 1,
                      "distortion": 1}


def test_a_chunked_group_captures_a_chunk_not_the_group(stand_ins):
    """Under the planner's chunks, each graph of a group solve is fed one
    chunk's items (a buffer handed out before the capture and kept by
    the graph, not a copy of it), and equal chunks share one graph."""
    params = _torch_params()
    algo = _captured_driver()
    _loop(algo, params, n=2)
    chunked = {tuple(r["tasks"]): r["plan"]["n_chunks"]
               for r in algo.group_summary(params)
               if r["plan"] and r["plan"]["n_chunks"] > 1}
    assert chunked
    seen = 0
    for exe in algo._compiled.executables.values():
        if len(exe.bounds) == 1:
            continue
        sizes = {hi - lo for lo, hi in exe.bounds}
        graphs_ = list(exe.program._graphs.values())
        assert len(graphs_) == len(sizes) and not exe.program._ready
        assert {g.fed[2].shape[0] for g in graphs_} == sizes
        seen += 1
    assert seen == len(chunked)


class _HostReads(TorchDispatchMode):
    """Records every op that reads a tensor's value on the host (what
    ``.item()``, ``int(t)`` or indexing by a 0-d tensor run), which a
    CUDA graph cannot capture."""

    def __init__(self):
        super().__init__()
        self.reads = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func is torch.ops.aten._local_scalar_dense.default:
            self.reads.append(self.program)
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("group_tasks", [True, False],
                         ids=["grouped", "per-task"])
def test_no_program_reads_the_device_from_the_host(monkeypatch,
                                                   group_tasks):
    """The CPU's view of what the card captures: no solve (every family,
    the item-by-item ones included) and no step reads a tensor on the
    host inside its program (the card raises ``CaptureError`` there)."""
    spy = _HostReads()
    call = graphs.Program.__call__

    def spied(self, *args):
        spy.program = self.name
        with spy:
            return call(self, *args)

    monkeypatch.setattr(graphs.Program, "__call__", spied)
    algo = _port(True, group_tasks)
    _loop(algo, _torch_params())
    names = {p.name for p in algo._steps.values()}
    assert names == {"shifted distortion", "multipliers", "distortion"}
    assert spy.reads == []


def test_release_graphs_and_validation():
    algo = _port()
    params = _torch_params()
    _loop(algo, params, n=2)
    assert algo._steps and algo._staged and algo._compiled.c_steps == 2
    progs = algo.programs
    algo.release_graphs()
    assert algo.programs is not progs and not algo._steps
    assert not algo._staged and algo._compiled.c_steps == 0
    eager = _port(False)
    assert eager.programs is None and eager._compiled is None


# ----------------------------------------------------------------------
# the trainer, serial and overlapped
# ----------------------------------------------------------------------
CFG = reduced_config(get_config("phi3-mini-3.8b")).with_(pattern_reps=1,
                                                          dtype="float32")


def _trainer(jit, overlap):
    lc = LCAlgorithm(
        [CompressionTask("qg", r"stages/.*/w_gate$", AsVector(),
                         ts.AdaptiveQuantization(k=2, iters=5)),
         CompressionTask("qu", r"stages/.*/w_up$", AsVector(),
                         ts.AdaptiveQuantization(k=2, iters=5)),
         CompressionTask("pd", r"stages/.*/w_down$", AsVector(),
                         ts.ConstraintL0Pruning(kappa=200))],
        exponential_mu_schedule(1e-4, 1.5, 3), device="cpu",
        jit_c_step=jit)
    return LCTrainer(CFG, lc, TokenStream(CFG.vocab_size, 2, 16),
                     tcfg=TrainerConfig(steps_per_l=2, overlap=overlap,
                                        lr=3e-4),
                     device="cpu")


@pytest.mark.parametrize("overlap", ["off", "on"])
def test_trainer_with_the_compiled_driver_equals_the_eager_one(overlap):
    runs, steps = {}, []
    for jit in (True, False):
        trainer = _trainer(jit, overlap)
        release = trainer.lc.release_graphs

        def released(lc=trainer.lc, release=release):
            steps.append(set(lc._steps))
            return release()

        trainer.lc.release_graphs = released
        runs[jit] = (trainer.run(0), trainer.history, trainer.lc)
    (state, lc_state), hist, algo = runs[True]
    (e_state, e_lc_state), e_hist, _ = runs[False]
    # the compiled driver ran its steps as programs, and the trainer let
    # them go when its run ended
    assert steps == [{"shifted distortion", "multipliers", "distortion"},
                     set()]
    assert not algo._steps and not algo._staged
    for x, y in zip(tree_leaves((state, lc_state)),
                    tree_leaves((e_state, e_lc_state))):
        assert torch.equal(x, y)
    assert len(hist) == len(e_hist) == 3
    for h, e in zip(hist, e_hist):
        h, e = dict(h), dict(e)
        h.pop("c_step_ms"), e.pop("c_step_ms")
        assert h == e and h["c_step_violations"] == []


def test_jit_c_step_is_the_default():
    algo = LCAlgorithm(_tasks("torch"), MUS, device="cpu")
    assert algo.jit_c_step and not algo.programs.graphs
