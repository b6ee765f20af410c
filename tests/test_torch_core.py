"""The port's core modules (views, tasks, state, penalty, schemes) against
the JAX package, on the same numpy inputs.

Tolerances (ROADMAP queue 3): bit-identical for masks, assignments,
integer outputs and elementwise maps; rtol 1e-6 for float reductions
summed in another order; k-means codebooks after a Lloyd loop to 1e-5
here (same algorithm, same arithmetic, only the sum order differs).
"""
import ast
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import (
    AsIs as JAsIs, AsMatrix as JAsMatrix, AsStacked as JAsStacked,
    AsVector as JAsVector, CompressionTask as JTask, lc_penalty as j_penalty)
from repro.core import schemes as js
from repro_torch import interop
from repro_torch.core import (
    AsIs, AsMatrix, AsStacked, AsVector, CompressionTask, LCAlgorithm,
    check_disjoint, flatten_params, get_path, lc_penalty, set_path)
from repro_torch.core import schemes as ts

ROOT = Path(__file__).resolve().parent.parent


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def _rand(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape) \
        .astype(np.float32)


# ----------------------------------------------------------------------
# package rules
# ----------------------------------------------------------------------
def _imported_modules(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_port_imports_neither_jax_nor_the_jax_package():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 15
    assert {ROOT / "src" / "repro_torch" / "models" / f
            for f in ("moe.py", "attention.py", "ssm.py")} <= set(files)
    for f in files:
        for mod in _imported_modules(f):
            top = mod.split(".")[0]
            assert top not in ("jax", "jaxlib", "repro", "flax", "optax"), \
                f"{f.relative_to(ROOT)} imports {mod}"


@pytest.mark.parametrize("entry", ["LCAlgorithm", "reference_problem",
                                   "run_lc", "direct_compress",
                                   "quickstart", "gaussian_blobs", "Server",
                                   "ServingEngine", "launch.serve.main",
                                   "init_mlp", "LCTrainer",
                                   "launch.train.main"])
def test_entry_points_default_to_the_card(entry):
    """Called without ``device``, every entry point asks for CUDA and
    raises with a clear message when there is none."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    from repro_torch import quickstart, showcase
    from repro_torch.configs import get_config, reduced_config
    from repro_torch.data import gaussian_blobs
    from repro_torch.launch import serve, train
    from repro_torch.runtime import LCTrainer
    from repro_torch.runtime import Server, ServingEngine
    params = {"l0": {"w": torch.zeros(4, 3), "b": torch.zeros(3)}}
    prob = showcase.Problem(params, torch.zeros(300, 4),
                            torch.zeros(300, dtype=torch.int64),
                            torch.zeros(8, 4),
                            torch.zeros(8, dtype=torch.int64), 0.0, 0.0)
    tasks = [CompressionTask("q", "w$", AsVector(),
                             ts.AdaptiveQuantization(k=2, iters=1))]
    lm = reduced_config(get_config("phi3-mini-3.8b"))
    calls = {
        "LCAlgorithm": lambda: LCAlgorithm(tasks, [1e-3]),
        "reference_problem": lambda: showcase.reference_problem(steps=1),
        "run_lc": lambda: showcase.run_lc(prob, tasks, n_steps=1,
                                          iters_per_l=1),
        "direct_compress": lambda: showcase.direct_compress(prob, tasks),
        "quickstart": lambda: quickstart.main(),
        "gaussian_blobs": lambda: gaussian_blobs(8, d=4),
        "Server": lambda: Server(lm, {}),
        "ServingEngine": lambda: ServingEngine(lm, {}),
        "launch.serve.main": lambda: serve.main(["--reduced"]),
        "init_mlp": lambda: showcase.init_mlp(torch.Generator()),
        "LCTrainer": lambda: LCTrainer(lm, LCAlgorithm(tasks, [1e-3],
                                                       device="cpu"), None),
        "launch.train.main": lambda: train.main(["--arch", "phi3-mini-3.8b",
                                                 "--reduced"]),
    }
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        calls[entry]()


def test_params_on_another_device_are_refused():
    lc = LCAlgorithm([CompressionTask("q", "w$", AsVector(),
                                      ts.AdaptiveQuantization(k=2))],
                     [1e-3], device="cpu")
    with pytest.raises(ValueError, match="runs on cpu"):
        lc.init({"w": torch.zeros(8, device="meta")})


# ----------------------------------------------------------------------
# views and tasks
# ----------------------------------------------------------------------
@pytest.mark.parametrize("views,shapes", [
    ((AsVector(), JAsVector()), [(6, 5), (7,), (2, 3, 4)]),
    ((AsIs(), JAsIs()), [(6, 5)]),
    ((AsMatrix(), JAsMatrix()), [(2, 3, 4)]),
    ((AsStacked("vector"), JAsStacked("vector")), [(3, 4, 5)]),
    ((AsStacked("matrix"), JAsStacked("matrix")), [(3, 4, 5)]),
    ((AsStacked("vector", stack_ndim=2),
      JAsStacked("vector", stack_ndim=2)), [(2, 3, 4, 5)]),
])
def test_views_match_jax(views, shapes):
    ours, theirs = views
    leaves = [_rand(i, *s) for i, s in enumerate(shapes)]
    x = ours.to_compressible([torch.from_numpy(l) for l in leaves])
    xj = theirs.to_compressible([jnp.asarray(l) for l in leaves])
    np.testing.assert_array_equal(_np(x), np.asarray(xj))
    assert ours.item_count(x) == theirs.item_count(xj)
    assert ours.item_shape(x) == theirs.item_shape(xj)
    items = ours.to_items(x)
    np.testing.assert_array_equal(_np(items), np.asarray(theirs.to_items(xj)))
    assert torch.equal(ours.from_items(items), x)
    back = ours.from_compressible(x, [torch.from_numpy(l) for l in leaves])
    for b, l in zip(back, leaves):
        np.testing.assert_array_equal(_np(b), l)


def test_flatten_params_holds_no_reference_cycle():
    """A flattened tree's leaves die with their last reference, not at the
    next cyclic GC (which device memory does not trigger): a recursive
    closure used to keep every leaf alive in a cycle."""
    import gc
    import weakref
    from repro_torch.core import flatten_params
    leaf = torch.zeros(3)
    ref = weakref.ref(leaf)
    gc.disable()
    try:
        flat = flatten_params({"a": {"b": leaf}, "c": torch.ones(1)})
        assert list(flat) == ["a/b", "c"]
        del flat, leaf
        assert ref() is None
    finally:
        gc.enable()


def test_tasks_paths_and_signatures():
    shapes = {"l0": {"w": (8, 6), "b": (6,)}, "l1": {"w": (8, 6)},
              "stack": {"w_up": (3, 8, 6), "w_gate": (3, 8, 6)}}
    tp = {k: {n: torch.zeros(s) for n, s in v.items()}
          for k, v in shapes.items()}
    jp = {k: {n: jnp.zeros(s) for n, s in v.items()}
          for k, v in shapes.items()}
    assert list(flatten_params(tp)) == list(
        __import__("repro.core", fromlist=["x"]).flatten_params(jp))
    assert get_path(tp, "stack/w_up").shape == (3, 8, 6)
    new = set_path(tp, "l1/w", torch.ones(2))
    assert new["l1"]["w"].shape == (2,) and tp["l1"]["w"].shape == (8, 6)

    def pair(name, pat, view, jview, scheme, jscheme):
        return (CompressionTask(name, pat, view, scheme).resolve(tp),
                JTask(name, pat, jview, jscheme).resolve(jp))

    cases = [
        pair("a", r"l0/w$", AsIs(), JAsIs(), ts.ConstraintL0Pruning(5),
             js.ConstraintL0Pruning(5)),
        pair("b", r"stack/w_up", AsStacked(), JAsStacked(),
             ts.ConstraintL0Pruning(9), js.ConstraintL0Pruning(9)),
        pair("c", r"stack/w_gate", AsStacked(), JAsStacked(),
             ts.AdaptiveQuantization(k=4), js.AdaptiveQuantization(k=4)),
    ]
    for t, j in cases:
        assert t.paths == j.paths
        x, xj = t.compressible(tp), j.compressible(jp)
        for batched in (False, True):
            s, sj = (t.group_signature(x, batched),
                     j.group_signature(xj, batched))
            # same identity; the dtype's spelling differs between packages
            assert s[:3] == sj[:3]
    # mixed κ groups only under the batched signature
    b = cases[1][0]
    xb = b.compressible(tp)
    assert b.group_signature(xb, True)[1] == ("batched", "topk_mask",
                                              ("prune-l0",))
    with pytest.raises(ValueError, match="claimed by"):
        check_disjoint([b, b])
    with pytest.raises(ValueError, match="matched no"):
        CompressionTask("z", "nope", AsVector(),
                        ts.Binarize()).resolve(tp)


def test_shifted_compressible_and_penalty_match_jax():
    w = {"l0": {"w": _rand(1, 12, 5)}, "l1": {"w": _rand(2, 5, 3)}}
    lam = {"l0/w": _rand(3, 12, 5), "l1/w": _rand(4, 5, 3)}
    a = {"l0/w": _rand(5, 12, 5), "l1/w": _rand(6, 5, 3)}
    state = {"tasks": {"t": {"theta": {"theta": np.zeros(75, np.float32)},
                             "lam": lam, "a": a}},
             "mu": np.float32(3e-3), "k": np.int32(0)}
    t = CompressionTask("t", r"w$", AsVector(),
                        ts.ConstraintL0Pruning(5)).resolve(w)
    j = JTask("t", r"w$", JAsVector(), js.ConstraintL0Pruning(5)).resolve(w)
    tst = interop.lc_state_from_numpy(state, "cpu")
    tw = interop.params_from_numpy(w, "cpu")
    jst = jax.tree_util.tree_map(jnp.asarray, state)
    x = t.shifted_compressible(tw, tst["tasks"]["t"], tst["mu"])
    xj = j.shifted_compressible(w, jst["tasks"]["t"], jst["mu"])
    np.testing.assert_array_equal(_np(x), np.asarray(xj))
    np.testing.assert_allclose(float(lc_penalty(tw, tst, [t])),
                               float(j_penalty(w, jst, [j])), rtol=1e-6)
    back = interop.to_numpy(tst)
    np.testing.assert_array_equal(back["tasks"]["t"]["lam"]["l0/w"],
                                  lam["l0/w"])
    assert back["mu"] == np.float32(3e-3) and back["k"] == 0


def test_theta_packing_matches_jax():
    a = {"cb": _rand(1, 1, 4), "assign": np.arange(6, dtype=np.int32)[None]}
    b = {"cb": _rand(2, 3, 7), "assign": np.zeros((3, 6), np.int32)}
    tt = [interop.params_from_numpy(x, "cpu") for x in (a, b)]
    jt = [jax.tree_util.tree_map(jnp.asarray, x) for x in (a, b)]
    packed = ts.pack_thetas_padded(tt)
    jpacked = js.pack_thetas_padded(jt)
    for k in ("cb", "assign"):
        np.testing.assert_array_equal(_np(packed[k]), np.asarray(jpacked[k]))
    parts = ts.unpack_thetas(packed, [1, 3])
    for part, orig in zip(parts, tt):
        back = ts.slice_theta_like(part, orig)
        for k in orig:
            assert torch.equal(back[k], orig[k])
    np.testing.assert_array_equal(
        _np(ts.pack_thetas([tt[1], tt[1]])["cb"]),
        np.asarray(js.pack_thetas([jt[1], jt[1]])["cb"]))
    one = ts.add_leading_axis({"x": torch.ones(3)})
    assert one["x"].shape == (1, 3)
    assert ts.drop_leading_axis(one)["x"].shape == (3,)


def test_kernel_dispatch_ready_guard():
    class Overrides(ts.ConstraintL0Pruning):
        def compress(self, w, theta, mu=None):
            return super().compress(w, theta, mu)

    class NoGroup(ts.ConstraintL0Pruning):
        def group_key(self):
            return None

    assert ts.ConstraintL0Pruning(3).kernel_dispatch_ready()
    assert ts.AdaptiveQuantization().kernel_dispatch_ready()
    assert not Overrides(3).kernel_dispatch_ready()
    assert not NoGroup(3).kernel_dispatch_ready()
    assert not ts.Binarize().kernel_dispatch_ready()
    assert not ts.PenaltyL0Pruning(1e-3).kernel_dispatch_ready()


# ----------------------------------------------------------------------
# schemes
# ----------------------------------------------------------------------
@pytest.mark.parametrize("p,k", [(1000, 4), (4097, 16), (7, 5)])
def test_quantile_init_bit_identical(p, k):
    w = _rand(p, p)
    np.testing.assert_array_equal(
        _np(ts.quantile_init(torch.from_numpy(w), k)),
        np.asarray(js.quantile_init(jnp.asarray(w), k)))


def test_quantile_init_above_torch_quantile_limit():
    """LM items (25,165,824 weights) exceed ``torch.quantile``'s 2^24
    input limit; the sort-based form matches ``jnp.quantile`` there."""
    p = (1 << 24) + 4099
    w = np.random.default_rng(0).standard_normal(p, dtype=np.float32)
    ours = _np(ts.quantile_init(torch.from_numpy(w), 16))
    theirs = np.asarray(js.quantile_init(jnp.asarray(w), 16))
    np.testing.assert_array_equal(ours, theirs)


@pytest.mark.parametrize("p,k,iters", [(2000, 4, 10), (6000, 16, 5)])
def test_adaptive_quantization_matches_jax(p, k, iters):
    w = _rand(k * p, p)
    s, j = ts.AdaptiveQuantization(k=k, iters=iters), \
        js.AdaptiveQuantization(k=k, iters=iters)
    th = s.init(torch.from_numpy(w))
    thj = j.init(jnp.asarray(w))
    np.testing.assert_allclose(_np(th.codebook), np.asarray(thj.codebook),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(_np(th.assign), np.asarray(thj.assign))
    w2 = w + 0.05 * _rand(7, p)
    th2 = s.compress(torch.from_numpy(w2), th)
    thj2 = j.compress(jnp.asarray(w2), thj)
    np.testing.assert_allclose(_np(th2.codebook), np.asarray(thj2.codebook),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(_np(th2.assign), np.asarray(thj2.assign))
    np.testing.assert_allclose(_np(s.decompress(th2)),
                               np.asarray(j.decompress(thj2)),
                               rtol=1e-5, atol=1e-6)
    assert s.bits(th2) == j.bits(thj2)
    # batched over a leading item axis == item by item
    stack = torch.from_numpy(np.stack([w, w2]))
    cb, assign = ts.kmeans_1d(stack, ts.quantile_init(stack, k), iters)
    for r in range(2):
        cbr, ar = ts.kmeans_1d(stack[r], ts.quantile_init(stack[r], k),
                               iters)
        torch.testing.assert_close(cb[r], cbr, rtol=1e-6, atol=1e-7)
        assert torch.equal(assign[r], ar)


def test_kmeans_chunked_passes_match(monkeypatch):
    from repro_torch.core.schemes import quantize
    w = torch.from_numpy(_rand(3, 5000))
    cb0 = quantize.quantile_init(w, 8)
    one = quantize.kmeans_1d(w, cb0, 5)
    monkeypatch.setattr(quantize, "CHUNK", 512)
    chunked = quantize.kmeans_1d(w, cb0, 5)
    torch.testing.assert_close(one[0], chunked[0], rtol=1e-6, atol=1e-7)
    assert torch.equal(one[1], chunked[1])


def test_optimal_codebook_dp_matches_jax():
    w = np.concatenate([_rand(1, 3000), 3 + 0.2 * _rand(2, 500)])
    ours = _np(ts.optimal_codebook_dp(torch.from_numpy(w), 4, bins=256))
    theirs = np.asarray(js.optimal_codebook_dp(jnp.asarray(w), 4, bins=256))
    np.testing.assert_allclose(ours, theirs, rtol=1e-4, atol=1e-4)
    s = ts.AdaptiveQuantization(k=4, iters=3, use_dp_init=True, dp_bins=256)
    j = js.AdaptiveQuantization(k=4, iters=3, use_dp_init=True, dp_bins=256)
    np.testing.assert_allclose(_np(s.init(torch.from_numpy(w)).codebook),
                               np.asarray(j.init(jnp.asarray(w)).codebook),
                               rtol=1e-4, atol=1e-4)
    assert s.init_key() != ts.AdaptiveQuantization(k=4, iters=3).init_key()


@pytest.mark.parametrize("name", ["binarize", "binarize-unscaled",
                                  "ternarize"])
def test_fixed_form_quantizers_match_jax(name):
    w = _rand(5, 999)
    w[::10] = 0.0
    s, j = {"binarize": (ts.Binarize(), js.Binarize()),
            "binarize-unscaled": (ts.Binarize(False), js.Binarize(False)),
            "ternarize": (ts.Ternarize(), js.Ternarize())}[name]
    th, thj = s.init(torch.from_numpy(w)), j.init(jnp.asarray(w))
    np.testing.assert_array_equal(_np(th["sign"]), np.asarray(thj["sign"]))
    np.testing.assert_allclose(_np(th["scale"]), np.asarray(thj["scale"]),
                               rtol=1e-6)
    assert s.bits(th) == pytest.approx(j.bits(thj))


def test_topk_magnitude_mask_ties_bit_identical():
    w = _rand(3, 4000)
    w[::3] = np.float32(0.25) * np.sign(w[::3])       # a big tied class
    for kappa in (1, 500, 1400, 3999, 5000):
        ours = ts.topk_magnitude_mask(torch.from_numpy(w), kappa)
        theirs = js.topk_magnitude_mask(jnp.asarray(w), kappa)
        np.testing.assert_array_equal(_np(ours), np.asarray(theirs))
        assert int(ours.sum()) == min(kappa, w.size)


@pytest.mark.parametrize("name", ["l0", "l1", "pen-l0", "pen-l1"])
def test_pruning_schemes_match_jax(name):
    w = _rand(8, 30, 20)
    mu = np.float32(2e-3)
    s, j = {"l0": (ts.ConstraintL0Pruning(77), js.ConstraintL0Pruning(77)),
            "l1": (ts.ConstraintL1Pruning(25.0), js.ConstraintL1Pruning(25.0)),
            "pen-l0": (ts.PenaltyL0Pruning(1e-3), js.PenaltyL0Pruning(1e-3)),
            "pen-l1": (ts.PenaltyL1Pruning(1e-3), js.PenaltyL1Pruning(1e-3)),
            }[name]
    th = s.compress(torch.from_numpy(w), s.init(torch.from_numpy(w)),
                    mu=torch.tensor(mu))
    thj = j.compress(jnp.asarray(w), j.init(jnp.asarray(w)),
                     mu=jnp.float32(mu))
    if name == "l1":                      # a sort + cumsum reduction
        np.testing.assert_allclose(_np(th["theta"]), np.asarray(thj["theta"]),
                                   rtol=1e-6, atol=1e-6)
    else:                                 # masks and elementwise maps
        np.testing.assert_array_equal(_np(th["theta"]),
                                      np.asarray(thj["theta"]))
    assert s.bits(th) == j.bits(thj)
    np.testing.assert_allclose(float(s.distortion(torch.from_numpy(w), th)),
                               float(j.distortion(jnp.asarray(w), thj)),
                               rtol=1e-6, atol=1e-9)


def test_compression_ratio_counts_every_stacked_item():
    """A (2, 3, 8, 6) leaf under AsStacked(stack_ndim=2) is 6 items, each
    with its own codebook: the ratio sums bits over all of them."""
    from repro.core import LCAlgorithm as JLC
    w = {"moe": {"w": _rand(4, 2, 3, 8, 6)}}
    tl = LCAlgorithm([CompressionTask(
        "q", "w$", AsStacked("vector", stack_ndim=2),
        ts.AdaptiveQuantization(k=4, iters=2))], [1e-3], device="cpu")
    jl = JLC([JTask("q", "w$", JAsStacked("vector", stack_ndim=2),
                    js.AdaptiveQuantization(k=4, iters=2))], [1e-3])
    tw = interop.params_from_numpy(w, "cpu")
    jw = jax.tree_util.tree_map(jnp.asarray, w)
    ratio = tl.compression_ratio(tw, tl.init(tw))
    assert ratio == pytest.approx(jl.compression_ratio(jw, jl.init(jw)))
    assert ratio == pytest.approx(6 * 48 * 32 / (6 * (48 * 2 + 4 * 32)))
