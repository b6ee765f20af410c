"""The mixed-compression twin (``python -m repro_torch.mixed_compression``)
against ``examples/mixed_compression.py``'s tasks run through the JAX
package, at a reduced number of LC steps.

Both packages train on the JAX package's LeNet300 problem (weights and
data carried over as numpy), so the runs differ only where the packages
do: the sketches of the randomized low-rank solver (different
generators) and float summation order.

Checked after every C step: exactly κ nonzeros in the ℓ0 parts, rank-10
low-rank factors, and the §7 monitor (the shifted distortion never rises
across a C step, ``after ≤ before·(1 + 1e-5) + 1e-6``). Against JAX:
equal compression ratios, the same ℓ0 support sizes, trained weights to
atol 1e-3. The trained second layer has a nearly flat spectrum (σ_10 and
σ_11 within 2%), so its rank-10 subspace is ill-determined and the two
packages' randomized sketches pick different near-optimal factors: the
mixed run compares the low-rank distortions (to 1%) and not the test
error of the compressed model; the additive run, which draws no sketch,
compares test errors to 0.01 (ten of 1024 test points).
"""
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

import benchmarks.common as jcommon  # noqa: E402
from repro.core import (  # noqa: E402
    AsIs as JAsIs, AsVector as JAsVector, CompressionTask as JTask)
from repro.core import schemes as js  # noqa: E402
from repro_torch import interop, mixed_compression, showcase  # noqa: E402

KW = dict(n_steps=3, iters_per_l=5)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The solvers here run many tiny eager ops; with several test
    workers on the machine, torch's intra-op thread pool only adds
    contention, so the module runs them on one thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def _jax_tasks():
    """``examples/mixed_compression.py``'s two task lists."""
    mixed = [
        JTask("p1", r"l0/w$", JAsVector(), js.ConstraintL0Pruning(kappa=5000)),
        JTask("lr2", r"l1/w$", JAsIs(), js.LowRank(target_rank=10)),
        JTask("q3", r"l2/w$", JAsVector(), js.AdaptiveQuantization(k=2)),
    ]
    additive = [JTask("pq", r"l\d/w$", JAsVector(), js.AdditiveCombination(
        [js.ConstraintL0Pruning(kappa=2662), js.AdaptiveQuantization(k=2)],
        iters=2))]
    return {"mixed": mixed, "additive": additive}


def _feasibility_check(seen):
    def check(model, lc, m):
        tasks = lc["tasks"]
        if "p1" in tasks:
            seen.append(("p1", int(torch.count_nonzero(
                tasks["p1"]["theta"]["theta"]))))
            th = tasks["lr2"]["theta"]
            assert th["u"].shape == (300, 10) and th["v"].shape == (100, 10)
            seen.append(("lr2", int(torch.linalg.matrix_rank(
                th["u"] @ th["v"].T))))
        else:
            seen.append(("pq", int(torch.count_nonzero(
                tasks["pq"]["theta"]["parts"][0]["theta"]))))
    return check


def _monitor_ok(history):
    return all(after <= before * (1 + 1e-5) + 1e-6
               for m in history
               for before, after in m.c_step_shifted_distortion.values())


def test_mixed_twin_runs_feasible_at_every_c_step():
    seen = []
    out = mixed_compression.main(device="cpu", callbacks=[
        _feasibility_check(seen)], **KW)
    assert [r["name"] for r in out["runs"]] == [n for n, _ in
                                                mixed_compression.RUNS]
    n = KW["n_steps"]
    assert seen == [("p1", 5000), ("lr2", 10)] * n + [("pq", 2662)] * n
    for run in out["runs"]:
        assert _monitor_ok(run["lc"]["history"])
        assert 0.0 <= run["lc"]["test_err"] <= 1.0
        assert run["dc"]["test_err"] >= 0.0


@pytest.fixture(scope="module")
def jax_problem():
    return jcommon.reference_problem()


def _port_problem(jprob):
    """The JAX package's problem (weights and data) as the port's."""
    return showcase.Problem(
        interop.params_from_numpy(
            jax.tree_util.tree_map(np.asarray, jprob.params), "cpu"),
        *(torch.from_numpy(np.array(a)) for a in (
            jprob.x_train, jprob.y_train, jprob.x_test, jprob.y_test)),
        jprob.ref_test_err, jprob.ref_train_err)


@pytest.mark.parametrize("run", ["mixed", "additive"])
def test_mixed_tasks_match_jax_on_the_same_problem(jax_problem, run):
    jprob = jax_problem
    tprob = _port_problem(jprob)
    ttasks = {"mixed": mixed_compression.mixed_tasks,
              "additive": mixed_compression.additive_tasks}[run]()
    seen = []
    tout = showcase.run_lc(tprob, ttasks, device="cpu",
                           callbacks=[_feasibility_check(seen)], **KW)
    jout = jcommon.run_lc(jprob, _jax_tasks()[run], **KW)

    assert seen == ([("p1", 5000), ("lr2", 10)] if run == "mixed"
                    else [("pq", 2662)]) * KW["n_steps"]
    assert tout["ratio"] == pytest.approx(jout["ratio"], rel=1e-6)
    assert _monitor_ok(tout["history"])
    tparams = interop.to_numpy(tout["state"].tree())
    for layer, leaves in tparams.items():
        for leaf, value in leaves.items():
            np.testing.assert_allclose(
                value, np.asarray(jout["state"][layer][leaf]), atol=1e-3,
                err_msg=f"{layer}/{leaf}")
    jtasks = jout["lc_state"]["tasks"]
    if run == "mixed":
        assert int(jnp.sum(jtasks["p1"]["theta"]["theta"] != 0)) == 5000
        ju, jv = jtasks["lr2"]["theta"]["u"], jtasks["lr2"]["theta"]["v"]
        assert int(np.linalg.matrix_rank(np.asarray(ju @ jv.T))) == 10
        td = float(tout["lc"].distortion(tout["state"].tree(),
                                         tout["lc_state"])["lr2"])
        jd = float(jout["lc"].distortion(jout["state"],
                                         jout["lc_state"])["lr2"])
        assert abs(td - jd) <= 1e-2 * jd, (td, jd)
    else:
        assert abs(tout["test_err"] - jout["test_err"]) <= 0.01
        parts = jtasks["pq"]["theta"]["parts"]
        assert int(jnp.sum(parts[0]["theta"] != 0)) == 2662
        cb = tout["lc_state"]["tasks"]["pq"]["theta"]["parts"][1].codebook
        np.testing.assert_allclose(cb.numpy(), np.asarray(parts[1].codebook),
                                   atol=1e-3)


@pytest.mark.parametrize("run", ["mixed", "additive"])
def test_full_lc_runs_on_one_problem(jax_problem, run):
    """Both runs at their full length (20 LC steps of 40 SGD iterations,
    as ``mixed_compression.main`` and the example run them), both
    packages on the JAX package's problem; ``pytest -s`` prints the DC
    and LC test errors of both. The direct compressions agree to 0.01
    and LC beats DC in both packages. The additive run, which draws no
    sketch, ends at the same LC test error to 0.01; in the mixed run the
    packages' sketches pick different rank-10 factors of the nearly flat
    l1 spectrum, so it holds each package's last low-rank C step against
    the exact SVD of its own input. On this spectrum (σ_10/σ_11 ≈ 1.02–1.04)
    the warm-started sketch misses queue 3's 1e-4 budget in both
    packages (ROADMAP queue 3 logs the excesses), so the port's excess
    is held to within twice the reference's."""
    jprob = jax_problem
    tprob = _port_problem(jprob)
    make = {"mixed": mixed_compression.mixed_tasks,
            "additive": mixed_compression.additive_tasks}[run]
    tdc = showcase.direct_compress(tprob, make(), device="cpu")
    tout = showcase.run_lc(tprob, make(), device="cpu")
    jdc = jcommon.direct_compress(jprob, _jax_tasks()[run])
    jout = jcommon.run_lc(jprob, _jax_tasks()[run])
    print(f"\n{run} on the JAX problem (ref {jprob.ref_test_err:.4f}): "
          f"port DC {tdc['test_err']:.4f} LC {tout['test_err']:.4f}; "
          f"JAX DC {jdc['test_err']:.4f} LC {jout['test_err']:.4f}; "
          f"ratio {tout['ratio']:.1f}x")

    assert tout["ratio"] == pytest.approx(jout["ratio"], rel=1e-6)
    assert _monitor_ok(tout["history"])
    assert abs(tdc["test_err"] - jdc["test_err"]) <= 0.01
    assert tout["test_err"] <= tdc["test_err"]
    assert jout["test_err"] <= jdc["test_err"]
    if run == "mixed":
        # each package's last low-rank C step against the exact rank-10
        # SVD of its own input x = w − λ_old/μ = a − λ/μ (λ after the
        # multiplier step), whose distortion is ‖x − a‖² = ‖λ/μ‖²
        excess = {}
        for name, st in (("port", tout["lc_state"]),
                         ("JAX", jout["lc_state"])):
            ts = st["tasks"]["lr2"]
            a, lam = (np.array(_np(ts[k]["l1/w"]), np.float64)
                      for k in ("a", "lam"))
            x = a - lam / float(st["mu"])
            d = float(np.sum((x - a) ** 2))
            exact = float(np.sum(np.linalg.svd(x, compute_uv=False)[10:]
                                 ** 2))
            excess[name] = (d - exact) / exact
        print(f"last low-rank C step, distortion excess over the exact "
              f"SVD: port {excess['port']:.3g}, JAX {excess['JAX']:.3g}")
        assert excess["port"] <= max(1e-4, 2.0 * excess["JAX"]), excess
    else:
        assert abs(tout["test_err"] - jout["test_err"]) <= 0.01
