"""The port's grouped C step and LC loop against the JAX package.

* Grouped C step: ``LCAlgorithm.init``/``c_step``/``multiplier_step``
  from the same carried-over state (JAX → numpy → the port), with a
  mixed-K quantization group and a mixed-κ pruning group, on both
  backend pairs: the port's ``cuda`` kernel path (plain kernel versions
  on CPU tensors) against JAX's ``interpret`` Pallas path, and ``torch``
  against ``jnp``. Masks and the multiplier step bit-identical,
  codebooks atol 1e-3 (``KMEANS_CB_ATOL``), same ``group_summary``.
* LC loop: both packages run from the same weights and data at small
  width (64-32-16-10, 3 μ steps × 5 SGD iterations): params and
  codebooks agree to atol 1e-4, distortions to rtol 1e-3. At full
  LeNet300 width, a shortened run in each package keeps LC ≤ DC.
"""
import importlib
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_threads import _one_torch_thread  # noqa: F401


# benchmarks/ is a plain directory under the repo root: make `import
# benchmarks` work under a bare `pytest` too
ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

import benchmarks.common as jcommon  # noqa: E402
from repro.core import (
    AsStacked as JAsStacked, AsVector as JAsVector,
    CompressionTask as JTask, LCAlgorithm as JLC)
from repro.core import schemes as js
from repro_torch import interop, showcase
from repro_torch.core import (
    AsStacked, AsVector, CompressionTask, LCAlgorithm)
from repro_torch.core import schemes as ts
from repro_torch.kernels.prune import prune as k2

# the package exports the Lloyd loop ``kmeans`` (as the JAX package does),
# which shadows the kernel module of the same name
k1 = importlib.import_module("repro_torch.kernels.kmeans.kmeans")

KMEANS_CB_ATOL = 1e-3


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def _params_np(seed=0):
    rng = np.random.default_rng(seed)

    def r(*s):
        return rng.standard_normal(s).astype(np.float32)

    return {"qa": {"w": r(3, 40, 50)}, "qb": {"w": r(2, 40, 50)},
            "pa": {"w": r(2, 30, 60)}, "pb": {"w": r(30, 60)},
            "solo": {"w": r(17, 9)}}


def _tasks(pkg):
    """Mixed-K quantization (K=4 and K=8 over items of 2000), mixed-κ ℓ0
    (κ=100 and 333 over items of 1800), and a task no solver handles."""
    if pkg == "torch":
        T, V, S, s = CompressionTask, AsVector, AsStacked, ts
    else:
        T, V, S, s = JTask, JAsVector, JAsStacked, js
    return [
        T("qa", r"^qa/w$", S("vector"), s.AdaptiveQuantization(k=4, iters=4)),
        T("qb", r"^qb/w$", S("vector"), s.AdaptiveQuantization(k=8, iters=4)),
        T("pa", r"^pa/w$", S("vector"), s.ConstraintL0Pruning(kappa=100)),
        T("pb", r"^pb/w$", V(), s.ConstraintL0Pruning(kappa=333)),
        T("solo", r"^solo/w$", V(), s.Ternarize()),
    ]


@pytest.mark.parametrize("backend,jbackend", [("cuda", "interpret"),
                                              ("torch", "jnp")])
def test_grouped_c_step_matches_jax(backend, jbackend):
    params = _params_np()
    jparams = jax.tree_util.tree_map(jnp.asarray, params)
    tparams = interop.params_from_numpy(params, "cpu")
    jlc = JLC(_tasks("jax"), [1e-3, 1.3e-3], cstep_backend=jbackend)
    tlc = LCAlgorithm(_tasks("torch"), [1e-3, 1.3e-3],
                      cstep_backend=backend, device="cpu")

    # the same grouping: one mixed-K group, one mixed-κ group, a solo
    summ = tlc.group_summary(tparams)
    jsumm = jlc.group_summary(jparams)
    assert [g["tasks"] for g in summ] == [g["tasks"] for g in jsumm]
    assert [g["items"] for g in summ] == [g["items"] for g in jsumm]
    assert [g["solver"] for g in summ] == [g["solver"] for g in jsumm]
    assert [g["backend"] for g in summ] == [
        {"interpret": "cuda", "jnp": "torch", None: None}[g["backend"]]
        for g in jsumm]
    assert [g["tasks"] for g in summ][:2] == [["qa", "qb"], ["pa", "pb"]]

    # Θ^DC: direct compression runs the plain scheme programs
    jst = jlc.init(jparams)
    tst = tlc.init(tparams)
    for name in ("pa", "pb"):
        np.testing.assert_array_equal(
            _np(tst["tasks"][name]["theta"]["theta"]),
            np.asarray(jst["tasks"][name]["theta"]["theta"]))
    for name in ("qa", "qb"):
        np.testing.assert_allclose(
            _np(tst["tasks"][name]["theta"].codebook),
            np.asarray(jst["tasks"][name]["theta"].codebook),
            rtol=1e-5, atol=1e-6)

    # one C step from the same carried-over state and perturbed weights
    rng = np.random.default_rng(1)
    moved = jax.tree_util.tree_map(
        lambda x: x + np.float32(0.05) * rng.standard_normal(x.shape)
        .astype(np.float32), params)
    jmoved = jax.tree_util.tree_map(jnp.asarray, moved)
    tmoved = interop.params_from_numpy(moved, "cpu")
    jst = jlc.set_mu(jst, 1.3e-3, 1)
    state_np = jax.tree_util.tree_map(np.asarray, jst)
    tst = interop.lc_state_from_numpy(state_np, "cpu")

    pre = {n: float(v) for n, v in tlc.shifted_distortion(tmoved,
                                                          tst).items()}
    jst = jlc.c_step(jmoved, jst)
    tst = tlc.c_step(tmoved, tst)
    post = tlc.shifted_distortion(tmoved, tst)
    for n in pre:          # the §7 monitor at fixed (w, λ, μ)
        assert float(post[n]) <= pre[n] * (1 + 1e-5) + 1e-6, n
    for name, kappa in (("pa", 100), ("pb", 333)):
        th = _np(tst["tasks"][name]["theta"]["theta"])
        np.testing.assert_array_equal(
            th, np.asarray(jst["tasks"][name]["theta"]["theta"]))
        nnz = (th != 0).reshape(-1, th.shape[-1]).sum(-1) if th.ndim > 1 \
            else [(th != 0).sum()]
        assert all(int(n) == kappa for n in nnz)
    for name, k in (("qa", 4), ("qb", 8)):
        th, jth = tst["tasks"][name]["theta"], jst["tasks"][name]["theta"]
        assert th.codebook.shape[-1] == k          # padding sliced back off
        np.testing.assert_allclose(_np(th.codebook), np.asarray(jth.codebook),
                                   atol=KMEANS_CB_ATOL)
        np.testing.assert_array_equal(_np(th.assign), np.asarray(jth.assign))
    np.testing.assert_array_equal(
        _np(tst["tasks"]["solo"]["theta"]["sign"]),
        np.asarray(jst["tasks"]["solo"]["theta"]["sign"]))

    # the multiplier step, bit-identical from the same carried-over state
    tst = interop.lc_state_from_numpy(
        jax.tree_util.tree_map(np.asarray, jst), "cpu")
    jst = jlc.multiplier_step(jmoved, jst)
    tst = tlc.multiplier_step(tmoved, tst)
    for name in jst["tasks"]:
        for path, lam in jst["tasks"][name]["lam"].items():
            np.testing.assert_array_equal(
                _np(tst["tasks"][name]["lam"][path]), np.asarray(lam))


def test_grouped_and_per_task_paths_agree():
    """``group_tasks=False`` solves task by task through the same
    solvers."""
    params = interop.params_from_numpy(_params_np(3), "cpu")
    out = {}
    for grouped in (True, False):
        lc = LCAlgorithm(_tasks("torch"), [1e-3], group_tasks=grouped,
                         cstep_backend="cuda", device="cpu")
        st = lc.init(params)
        out[grouped] = lc.c_step(params, st)
    for name in out[True]["tasks"]:
        for a, b in zip(jax.tree_util.tree_leaves(
                            interop.to_numpy(out[True]["tasks"][name])),
                        jax.tree_util.tree_leaves(
                            interop.to_numpy(out[False]["tasks"][name]))):
            np.testing.assert_allclose(a, b, atol=KMEANS_CB_ATOL)


def _small_problem():
    """64-32-16-10 MLP and blob data, from numpy, for both packages."""
    rng = np.random.default_rng(0)
    dims = (64, 32, 16, 10)
    means = rng.standard_normal((10, 64)).astype(np.float32)
    y = rng.integers(0, 10, 640).astype(np.int32)
    x = (means[y] + 2.0 * rng.standard_normal((640, 64))).astype(np.float32)
    params = {f"l{i}": {
        "w": (rng.standard_normal((dims[i], dims[i + 1]))
              / np.sqrt(dims[i])).astype(np.float32),
        "b": np.zeros(dims[i + 1], np.float32)} for i in range(3)}
    return params, x[:512], y[:512], x[512:], y[512:]


def test_lc_loop_matches_jax_at_small_width():
    params, xtr, ytr, xte, yte = _small_problem()
    jprob = jcommon.Problem(jax.tree_util.tree_map(jnp.asarray, params),
                            jnp.asarray(xtr), jnp.asarray(ytr),
                            jnp.asarray(xte), jnp.asarray(yte), 0.0, 0.0)
    tprob = showcase.Problem(interop.params_from_numpy(params, "cpu"),
                             torch.from_numpy(xtr), torch.from_numpy(ytr),
                             torch.from_numpy(xte), torch.from_numpy(yte),
                             0.0, 0.0)
    jtasks = [JTask(f"q{i}", rf"l{i}/w$", JAsVector(),
                    js.AdaptiveQuantization(k=4, iters=5)) for i in range(3)]
    ttasks = [CompressionTask(f"q{i}", rf"l{i}/w$", AsVector(),
                              ts.AdaptiveQuantization(k=4, iters=5))
              for i in range(3)]
    kw = dict(mu0=1e-2, a=1.5, n_steps=3, iters_per_l=5)
    jout = jcommon.run_lc(jprob, jtasks, **kw)
    tout = showcase.run_lc(tprob, ttasks, device="cpu", **kw)
    jparams = jout["state"]
    tparams = interop.to_numpy(tout["state"].tree())
    for layer in tparams:
        for leaf in tparams[layer]:
            np.testing.assert_allclose(tparams[layer][leaf],
                                       np.asarray(jparams[layer][leaf]),
                                       atol=1e-4)
    for name in jout["lc_state"]["tasks"]:
        np.testing.assert_allclose(
            _np(tout["lc_state"]["tasks"][name]["theta"].codebook),
            np.asarray(jout["lc_state"]["tasks"][name]["theta"].codebook),
            atol=1e-4)
    jlc, tlc = jout["lc"], tout["lc"]
    jd = jlc.distortion(jparams, jout["lc_state"])
    td = tlc.distortion(tout["state"].tree(), tout["lc_state"])
    for name in jd:
        np.testing.assert_allclose(float(td[name]), float(jd[name]),
                                   rtol=1e-3)
    assert tout["ratio"] == pytest.approx(jout["ratio"])
    for m in tout["history"]:          # the §7 monitor, every C step
        for before, after in m.c_step_shifted_distortion.values():
            assert after <= before * (1 + 1e-5) + 1e-6


def test_lc_beats_direct_compression_at_full_width_in_both_packages():
    """LeNet300 at its published width, a shortened LC run per package
    (the last 6 μ steps of the quickstart's schedule): LC ≤ DC on the
    quickstart's per-layer K=4 quantization."""
    kw = dict(n_steps=6, iters_per_l=40, mu0=9e-5 * 1.3**14)
    jprob = jcommon.reference_problem()
    jtasks = [JTask(f"q{i}", rf"l{i}/w$", JAsVector(),
                    js.AdaptiveQuantization(k=4, iters=20)) for i in range(3)]
    jdc = jcommon.direct_compress(jprob, jtasks)
    jlc = jcommon.run_lc(jprob, jtasks, **kw)
    assert jlc["test_err"] <= jdc["test_err"] + 1e-6

    from repro_torch.quickstart import quickstart_tasks
    tprob = showcase.reference_problem(device="cpu")
    assert {k: v["w"].shape for k, v in tprob.params.items()} == {
        "l0": (784, 300), "l1": (300, 100), "l2": (100, 10)}
    n1 = (k1.KERNEL.launches, k1.LLOYD.launches)
    tdc = showcase.direct_compress(tprob, quickstart_tasks(), device="cpu")
    tlc = showcase.run_lc(tprob, quickstart_tasks(), device="cpu", **kw)
    assert tlc["test_err"] <= tdc["test_err"] + 1e-6
    assert tlc["ratio"] == pytest.approx(jlc["ratio"])
    # CPU tensors never reach a kernel
    assert (k1.KERNEL.launches, k1.LLOYD.launches) == n1


def test_ell0_lc_loop_keeps_exactly_kappa():
    """The bench_prune task (one ℓ0 task over every layer) on the kernel
    path: exactly κ nonzeros after every C step."""
    params, xtr, ytr, xte, yte = _small_problem()
    prob = showcase.Problem(interop.params_from_numpy(params, "cpu"),
                            torch.from_numpy(xtr), torch.from_numpy(ytr),
                            torch.from_numpy(xte), torch.from_numpy(yte),
                            0.0, 0.0)
    kappa = 150
    seen = []

    def check(model, lc, m):
        seen.append(int(torch.count_nonzero(
            lc["tasks"]["p"]["theta"]["theta"])))

    lc = LCAlgorithm([CompressionTask("p", r"l\d/w$", AsVector(),
                                      ts.ConstraintL0Pruning(kappa))],
                     [1e-2 * 1.3**k for k in range(3)],
                     l_step=showcase.sgd_l_step_factory(prob, iters=5),
                     cstep_backend="cuda", device="cpu")
    n2 = (k2.KERNEL.launches, k2.TOPK.launches)
    lc.run(showcase.LeNet300(prob.params), params_of=showcase.LeNet300.tree,
           callbacks=[check])
    assert seen == [kappa] * 3
    assert (k2.KERNEL.launches, k2.TOPK.launches) == n2
