"""The port's low-rank C step, rank selection and additive combinations
against the JAX package.

Inputs come from numpy with fixed seeds and go to both packages. The JAX
low-rank solvers are matmul-only programs (no Pallas kernel), so both
sides run their plain tensor programs on the CPU.

Tolerances (ROADMAP queue 3):
* Jacobi eigendecomposition: eigenvalues to 1e-4 of the largest,
  reconstruction V·diag(λ)·Vᵀ to 1e-4·max|A| (the reference's own test);
* orthonormal bases: QᵀQ = I to 1e-4 on live columns;
* randomized low rank: no bit parity (the sketches come from different
  generators); distortion excess over the exact SVD ≤ 1e-4 relative, and
  selected ranks equal to JAX's;
* exact paths (the Gram path, dispatch off): products U·Vᵀ to rtol 1e-5
  with atol 1e-5 of their scale (two LAPACKs; factor signs may differ, so
  products are compared, never raw factors);
* k-means codebooks atol 1e-3 (``KMEANS_CB_ATOL``), masks and ranks equal.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import (
    AsIs as JAsIs, AsStacked as JAsStacked, AsVector as JAsVector,
    CompressionTask as JTask, LCAlgorithm as JLC)
from repro.core import schemes as js
from repro.kernels.lowrank import lowrank as jlk
from repro.kernels.lowrank import ops as jlops
from repro_torch import interop
from repro_torch.core import (
    AsIs, AsStacked, AsVector, CompressionTask, LCAlgorithm)
from repro_torch.core import schemes as ts
from repro_torch.core.grouping import solve_task
from repro_torch.kernels.lowrank import lowrank as lk
from repro_torch.kernels.lowrank import ops as lops
from repro_torch.kernels.lowrank import ref as lref

KMEANS_CB_ATOL = 1e-3


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The solvers here run many tiny eager ops; with several test
    workers on the machine, torch's intra-op thread pool only adds
    contention, so the module runs them on one thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(x):
    return torch.from_numpy(np.array(x, copy=True))


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def _decaying_stack(n_items, m, n, base=0.85, floor=3e-2, seed=7):
    """Matrices with a controlled decaying spectrum (the regime the
    randomized SVD is built for), as the reference's tests make them."""
    rng = np.random.default_rng(seed)
    u, _ = np.linalg.qr(rng.standard_normal((n_items, m, m)))
    v, _ = np.linalg.qr(rng.standard_normal((n_items, n, n)))
    k = min(m, n)
    sig = base ** np.arange(k) + floor
    return np.einsum("imk,k,ink->imn", u[:, :, :k], sig,
                     v[:, :, :k]).astype(np.float32)


def _jkeys(n, seed=3):
    base = jax.random.fold_in(jax.random.PRNGKey(0), seed)
    return jax.vmap(lambda j: jax.random.fold_in(base, j))(jnp.arange(n))


def _tkeys(n, seed=3):
    return torch.arange(n, dtype=torch.int64) + 1000 * seed


def _rel_excess(w, u, v, rank):
    """(‖w − UVᵀ‖² − optimal rank-r distortion) / optimal, per item."""
    d = torch.sum((_t(w) - u @ v.transpose(1, 2)) ** 2, dim=(1, 2))
    d_exact = lref.tail_distortion_ref(_t(w), rank)
    return _np((d - d_exact) / d_exact)


# ----------------------------------------------------------------------
# the Jacobi finisher
# ----------------------------------------------------------------------
def _psd(seed, i, k, n):
    a = np.random.default_rng(seed).standard_normal((i, k, n))
    return np.einsum("ikn,iln->ikl", a, a).astype(np.float32)


def _equal_diagonals(seed):
    g = _psd(seed, 2, 9, 20)
    g[:, 1, 1] = g[:, 0, 0]                  # a tied pair: no first rotation
    g[:, 4, 4] = g[:, 3, 3]
    return g


@pytest.mark.parametrize("name,g", [
    ("random", _psd(1, 3, 18, 30)),
    ("odd-k", _psd(2, 2, 7, 12)),
    ("zero-items", np.concatenate([np.zeros((1, 10, 10), np.float32),
                                   _psd(3, 1, 10, 15),
                                   np.zeros((1, 10, 10), np.float32)])),
    ("equal-diagonals", _equal_diagonals(4)),
])
def test_jacobi_eigh_matches_jax(name, g):
    lam, v = lk.jacobi_eigh_batched(_t(g), sweeps=10)
    jlam, jv = jlk.jacobi_eigh_batched(jnp.asarray(g), sweeps=10)
    scale = max(float(np.abs(np.asarray(jlam)).max()), 1e-30)
    np.testing.assert_allclose(_np(lam), np.asarray(jlam),
                               atol=1e-4 * scale)
    assert not np.isnan(_np(lam)).any() and not np.isnan(_np(v)).any()
    rec = torch.einsum("ikl,il,iml->ikm", v, lam, v)
    np.testing.assert_allclose(_np(rec), g, atol=1e-4 * scale)
    # descending eigenvalues; all-zero items stay exactly zero
    assert (np.diff(_np(lam), axis=-1) <= 1e-4 * scale).all()
    for i in range(g.shape[0]):
        if not g[i].any():
            assert not _np(lam[i]).any()


def test_jacobi_sign_zero_gives_no_rotation_as_in_jax():
    """``sign(0) = 0``: a pair with equal diagonals is not rotated, so a
    matrix whose diagonal is all equal stays as it is — in both
    packages."""
    g = np.asarray([[[1.0, 0.5], [0.5, 1.0]]], np.float32)
    lam, v = lk.jacobi_eigh_batched(_t(g), sweeps=3)
    jlam, jv = jlk.jacobi_eigh_batched(jnp.asarray(g), sweeps=3)
    np.testing.assert_array_equal(_np(lam), np.asarray(jlam))
    np.testing.assert_array_equal(_np(v), np.asarray(jv))
    np.testing.assert_array_equal(_np(lam), [[1.0, 1.0]])


def test_round_robin_schedule_covers_every_pair_once():
    sched = lk._round_robin_schedule(8)
    pairs = {tuple(p) for rnd in sched for p in rnd}
    assert len(pairs) == 8 * 7 // 2
    for rnd in sched:                                  # disjoint per round
        assert len({x for p in rnd for x in p}) == 8
    np.testing.assert_array_equal(sched, jlk._round_robin_schedule(8))


# ----------------------------------------------------------------------
# range-finder orthonormalization
# ----------------------------------------------------------------------
@pytest.mark.parametrize("orth", ["jacobi", "newton_schulz"])
def test_orthonormal_bases_on_live_columns(orth):
    rng = np.random.default_rng(5)
    y = rng.standard_normal((3, 120, 24)).astype(np.float32)
    y[1] = 0.0                                          # a dead item
    fn = {"jacobi": (lk.orthonormal_columns_batched,
                     jlk.orthonormal_columns_batched),
          "newton_schulz": (lk.newton_schulz_orthonormalize,
                            jlk.newton_schulz_orthonormalize)}[orth]
    q = fn[0](_t(y))
    jq = np.asarray(fn[1](jnp.asarray(y)))
    assert not torch.isnan(q).any()
    for i in (0, 2):
        g = _np(q[i].T @ q[i])
        np.testing.assert_allclose(g, np.eye(24), atol=1e-4)
        # the same subspace as JAX's basis: equal projectors
        np.testing.assert_allclose(_np(q[i] @ q[i].T), jq[i] @ jq[i].T,
                                   atol=1e-4)
    assert float(q[1].abs().sum()) == 0.0


def test_orthonormal_columns_zero_rank_deficient_directions():
    """Duplicate columns: the basis keeps the live directions orthonormal
    and zeroes the rest, never dividing by a vanishing eigenvalue."""
    rng = np.random.default_rng(6)
    y = rng.standard_normal((1, 50, 6)).astype(np.float32)
    y[0, :, 3:] = y[0, :, :3]
    q = _np(lk.orthonormal_columns_batched(_t(y))[0])
    norms = np.linalg.norm(q, axis=0)
    live = norms > 0.5
    assert live.sum() == 3 and np.all(norms[~live] < 1e-3)
    np.testing.assert_allclose(q[:, live].T @ q[:, live], np.eye(3),
                               atol=1e-4)


# ----------------------------------------------------------------------
# the spectrum solver: exact Gram path and the u0 warm start
# ----------------------------------------------------------------------
@pytest.mark.parametrize("m,n", [(12, 30), (30, 12)])
def test_rsvd_exact_gram_path_matches_jax(m, n):
    w = _decaying_stack(2, m, n, seed=9)
    u, s, v = lk.rsvd_spectrum_batched(_t(w), _tkeys(2), k_sketch=40)
    ju, jsv, jv = jlk.rsvd_spectrum_batched(jnp.asarray(w), _jkeys(2),
                                            k_sketch=40)
    assert u.shape == (2, m, min(m, n)) and v.shape == (2, n, min(m, n))
    rec = _np(u @ torch.diag_embed(s) @ v.transpose(1, 2))
    jrec = np.asarray(ju @ jax.vmap(jnp.diag)(jsv) @ jv.transpose(0, 2, 1))
    scale = np.abs(w).max()
    np.testing.assert_allclose(rec, jrec, rtol=1e-5, atol=1e-5 * scale)
    np.testing.assert_allclose(rec, w, atol=1e-4 * scale)
    np.testing.assert_allclose(_np(s), np.asarray(jsv), rtol=1e-4,
                               atol=1e-5 * float(np.asarray(jsv).max()))


def test_rsvd_warm_start_with_dead_columns():
    """A warm basis with zero columns (masked ranks, a rank-0 Θ, a zero
    item) is backfilled from the fresh sketch: full width, no NaN, and
    the same ≤ 1e-4 distortion budget as a cold start — in both
    packages."""
    w = _decaying_stack(3, 96, 72, seed=11)
    rank = np.asarray([4, 8, 16], np.int32)
    u0 = _decaying_stack(3, 96, 16, seed=12)
    u0[0, :, 4:] = 0.0                       # masked ranks
    u0[1] = 0.0                              # a rank-0 previous Θ
    u, v = lops.lowrank_rsvd_batched(_t(w), _t(rank), _tkeys(3), r_max=16,
                                     u0=_t(u0))
    ju, jv = jlops.lowrank_rsvd_batched(jnp.asarray(w), jnp.asarray(rank),
                                        _jkeys(3), r_max=16,
                                        u0=jnp.asarray(u0))
    assert not torch.isnan(u).any() and not torch.isnan(v).any()
    assert np.all(_rel_excess(w, u, v, rank) <= 1e-4)
    assert np.all(_rel_excess(w, _t(np.asarray(ju)), _t(np.asarray(jv)),
                              rank) <= 1e-4)


# ----------------------------------------------------------------------
# the batched solvers against the exact SVD and JAX
# ----------------------------------------------------------------------
@pytest.mark.parametrize("orth,budget", [("jacobi", 1e-4),
                                         ("newton_schulz", 1e-3)])
def test_lowrank_rsvd_batched_within_budget_of_exact(orth, budget):
    w = _decaying_stack(4, 96, 72)
    rank = np.asarray([4, 8, 12, 16], np.int32)
    u, v = lops.lowrank_rsvd_batched(_t(w), _t(rank), _tkeys(4), r_max=16,
                                     orth=orth)
    ju, jv = jlops.lowrank_rsvd_batched(jnp.asarray(w), jnp.asarray(rank),
                                        _jkeys(4), r_max=16, orth=orth)
    assert np.all(_rel_excess(w, u, v, rank) <= budget)
    assert np.all(_rel_excess(w, _t(np.asarray(ju)), _t(np.asarray(jv)),
                              rank) <= budget)
    # masked like the reference: columns at/after each item's rank are 0
    mask = np.arange(16)[None, :] >= rank[:, None]
    assert float((u.abs() * _t(mask)[:, None, :]).sum()) == 0.0
    # both packages land on the same top-r subspace
    scale = np.abs(w).max()
    np.testing.assert_allclose(_np(u @ v.transpose(1, 2)),
                               np.asarray(ju @ jv.transpose(0, 2, 1)),
                               atol=budget * 10 * scale)


def test_wide_spectrum_needs_more_jacobi_sweeps_in_both_packages():
    """A limit of the reference that the port keeps (ROADMAP queue 3):
    at the sketch width 144 (rank 128 + 16) a spectrum that falls 30×
    over the top 128 values and ×0.15 after them (a range of 200 over the
    sketch) leaves the Jacobi passes at their sweep counts (6 per
    orthonormalization, 12 for the finisher) unconverged, and both
    packages miss the 1e-4 budget; twice the sweeps meet it.
    ``pytest -s`` prints the three excesses."""
    m, n, r = 256, 192, 128
    rng = np.random.default_rng(11)
    u, _ = np.linalg.qr(rng.standard_normal((m, m)))
    v, _ = np.linalg.qr(rng.standard_normal((n, n)))
    j = np.arange(n)
    sig = 30.0 ** (-np.minimum(j, r - 1) / (r - 1)) * np.where(j >= r,
                                                               0.15, 1.0)
    w = ((u[:, :n] * sig) @ v.T)[None].astype(np.float32)
    rank = np.asarray([r], np.int32)
    tu, tv = lops.lowrank_rsvd_batched(_t(w), _t(rank), _tkeys(1), r_max=r)
    ju, jv = jlops.lowrank_rsvd_batched(jnp.asarray(w), jnp.asarray(rank),
                                        _jkeys(1), r_max=r)
    u2, s2, v2 = lk.rsvd_spectrum_batched(
        _t(w), _tkeys(1), r + lops.OVERSAMPLE,
        power_iters=lops.POWER_ITERS, orth_sweeps=12, finish_sweeps=24)
    u2, v2 = lops._scaled_masked_factors(u2, s2, v2, _t(rank), r)
    port, ref, more = (float(_rel_excess(w, a, b, rank)[0]) for a, b in (
        (tu, tv), (_t(np.asarray(ju)), _t(np.asarray(jv))), (u2, v2)))
    print(f"\nexcess over the exact SVD: port {port:.3g}, JAX {ref:.3g}, "
          f"port at twice the sweeps {more:.3g}")
    assert port > 1e-4 and ref > 1e-4
    assert more <= 1e-4


def test_lowrank_rsvd_zero_item_and_exact_lowrank():
    rng = np.random.default_rng(13)
    w = (rng.standard_normal((3, 64, 6)) @ rng.standard_normal((3, 6, 48))
         ).astype(np.float32)
    w[1] = 0.0
    u, v = lops.lowrank_rsvd_batched(_t(w), torch.tensor([6, 8, 12]),
                                     _tkeys(3), r_max=12)
    assert not torch.isnan(u).any() and not torch.isnan(v).any()
    assert float(u[1].abs().sum() + v[1].abs().sum()) == 0.0
    np.testing.assert_allclose(_np(u @ v.transpose(1, 2)), w, atol=2e-3)


def test_rank_select_batched_ranks_equal_jax():
    w = _decaying_stack(4, 80, 60, seed=13)
    alpha = np.asarray([1e-4, 3e-4, 1e-3, 3e-3], np.float32)
    for mu in (1.0, 0.3):
        u, v, r = lops.rank_select_batched(_t(w), _t(alpha), _tkeys(4), mu,
                                           r_max=24)
        ju, jv, jr = jlops.rank_select_batched(
            jnp.asarray(w), jnp.asarray(alpha), _jkeys(4), mu, r_max=24)
        np.testing.assert_array_equal(_np(r), np.asarray(jr))
        assert r.dtype == torch.int32 and int(r.max()) > 0
        assert np.all(_rel_excess(w, u, v, r) <= 1e-4)


def test_svd_oracles_match_jax():
    from repro.kernels.lowrank import ref as jlref
    w = _decaying_stack(2, 20, 14, seed=2)
    np.testing.assert_allclose(
        _np(lref.tail_distortion_ref(_t(w), torch.tensor([3, 5]))),
        np.asarray(jlref.tail_distortion_ref(jnp.asarray(w),
                                             jnp.asarray([3, 5]))),
        rtol=1e-4)
    u, s, v = lref.svd_topr_batched_ref(_t(w), 4)
    ju, jsv, jv = jlref.svd_topr_batched_ref(jnp.asarray(w), 4)
    np.testing.assert_allclose(_np(s), np.asarray(jsv), rtol=1e-5)
    np.testing.assert_allclose(
        _np(u @ torch.diag_embed(s) @ v.transpose(1, 2)),
        np.asarray(ju @ jax.vmap(jnp.diag)(jsv) @ jv.transpose(0, 2, 1)),
        rtol=1e-5, atol=1e-5 * np.abs(w).max())


# ----------------------------------------------------------------------
# sketch seeds and grouping
# ----------------------------------------------------------------------
def test_item_keys_deterministic_distinct_and_path_stable():
    t1 = CompressionTask("a", "^a$", AsIs(), ts.LowRank(4))
    t2 = CompressionTask("b", "^b$", AsIs(), ts.LowRank(4))
    k1, k2 = t1.item_keys(3), t2.item_keys(3)
    assert k1.dtype == torch.int64 and k1.device.type == "cpu"
    assert len(set(k1.tolist() + k2.tolist())) == 6
    assert torch.equal(k1, t1.item_keys(3))
    assert torch.equal(k1[:2], t1.item_keys(2))   # by index, not count


def _lowrank_setup(ranks=(4, 8, 12, 16), m=96, n=72):
    w = _decaying_stack(len(ranks), m, n, seed=11)
    params = {f"l{i}": _t(w[i]) for i in range(len(ranks))}
    return params, lambda: [CompressionTask(f"lr{i}", f"^l{i}$", AsIs(),
                                            ts.LowRank(r))
                            for i, r in enumerate(ranks)]


def test_grouped_lowrank_equals_per_task():
    """Uniform-rank tasks: the grouped call and the per-task path see the
    same R_max and the same per-item seeds, so they draw the same
    sketches and agree to float tolerance."""
    params, _ = _lowrank_setup(ranks=(8, 8, 8), m=64, n=48)
    tasks = lambda: [CompressionTask(f"lr{i}", f"^l{i}$", AsIs(),  # noqa
                                     ts.LowRank(8)) for i in range(3)]
    lcg = LCAlgorithm(tasks(), [1e-2], group_tasks=True, device="cpu")
    lcp = LCAlgorithm(tasks(), [1e-2], group_tasks=False, device="cpu")
    sg = lcg.c_step(params, lcg.init(params))
    sp = lcp.c_step(params, lcp.init(params))
    for i in range(3):
        np.testing.assert_allclose(
            _np(sg["tasks"][f"lr{i}"]["theta"]["u"]),
            _np(sp["tasks"][f"lr{i}"]["theta"]["u"]), atol=2e-5)
    # and a rerun draws the same sketch: bit for bit
    again = lcg.c_step(params, lcg.init(params))
    for i in range(3):
        assert torch.equal(again["tasks"][f"lr{i}"]["theta"]["u"],
                           sg["tasks"][f"lr{i}"]["theta"]["u"])


def test_mixed_rank_and_mixed_alpha_tasks_share_one_group():
    params, tasks = _lowrank_setup()
    lc_off = LCAlgorithm(tasks(), [1e-2], cstep_backend="off", device="cpu")
    lc_on = LCAlgorithm(tasks(), [1e-2], device="cpu")
    assert len(lc_off.group_summary(params)) == 4
    (g,) = lc_on.group_summary(params)
    assert g["grouped"] and g["solver"] == "lowrank_rsvd"
    assert g["backend"] == "torch" and g["items"] == 4
    st = lc_on.c_step(params, lc_on.init(params))
    for i, r in enumerate((4, 8, 12, 16)):
        th = st["tasks"][f"lr{i}"]["theta"]
        # Θ keeps each task's own shapes (padding sliced back off)
        assert th["u"].shape == (96, r) and th["v"].shape == (72, r)
        d = float(torch.sum((params[f"l{i}"] - th["u"] @ th["v"].T) ** 2))
        d_exact = float(lref.tail_distortion_ref(
            params[f"l{i}"][None], torch.tensor([r]))[0])
        assert d <= d_exact * (1 + 1e-4), (i, d, d_exact)

    alphas = (1e-4, 3e-4, 1e-3, 3e-3)
    rs_tasks = [CompressionTask(f"rs{i}", f"^l{i}$", AsIs(),
                                ts.RankSelection(alpha=a, max_rank=24))
                for i, a in enumerate(alphas)]
    (g,) = LCAlgorithm(rs_tasks, [1.0], device="cpu").group_summary(params)
    assert g["solver"] == "rank_select" and g["items"] == 4
    # randomized=False and unbounded selection opt out of the solvers
    exact = [CompressionTask("e0", "^l0$", AsIs(),
                             ts.LowRank(4, randomized=False)),
             CompressionTask("e1", "^l1$", AsIs(), ts.RankSelection(1e-3))]
    assert [g["solver"] for g in LCAlgorithm(exact, [1.0], device="cpu")
            .group_summary(params)] == [None, None]


def test_solve_task_threads_the_task_seeds():
    params, tasks = _lowrank_setup(ranks=(8,), m=40, n=30)
    (task,) = LCAlgorithm(tasks(), [1e-2], device="cpu").resolve(
        params).tasks
    x = task.compressible(params)
    theta = task.scheme_init(x)
    a = solve_task(task, x, theta, 1e-2, backend="auto", device="cpu")
    b = lops.lowrank_rsvd_batched(x[None], torch.tensor([8]),
                                  task.item_keys(1), r_max=8,
                                  u0=theta["u"][None])
    assert torch.equal(a["u"], b[0][0]) and torch.equal(a["v"], b[1][0])


# ----------------------------------------------------------------------
# the schemes through LCAlgorithm, against JAX
# ----------------------------------------------------------------------
def _port_state(jst):
    return interop.lc_state_from_numpy(
        jax.tree_util.tree_map(np.asarray, jst), "cpu")


def _moved(params, seed=1, scale=0.02):
    rng = np.random.default_rng(seed)
    return {k: (v + np.float32(scale) * rng.standard_normal(v.shape)
                ).astype(np.float32) for k, v in params.items()}


def _lc_pair(jtasks, ttasks, params, backend, jbackend, mu=1e-2,
             move=0.02):
    """Init in JAX, carry the state over, move the weights (by ``move``
    times a standard normal), and run one C step in both packages from
    the same state."""
    jlc = JLC(jtasks, [mu], cstep_backend=jbackend)
    tlc = LCAlgorithm(ttasks, [mu], cstep_backend=backend, device="cpu")
    jparams = {k: jnp.asarray(v) for k, v in params.items()}
    tparams = {k: _t(v) for k, v in params.items()}
    jst = jlc.init(jparams)
    tst0 = tlc.init(tparams)
    moved = _moved(params, scale=move)
    jmoved = {k: jnp.asarray(v) for k, v in moved.items()}
    tmoved = {k: _t(v) for k, v in moved.items()}
    tst = _port_state(jst)
    pre = {n: float(v) for n, v in tlc.shifted_distortion(tmoved,
                                                          tst).items()}
    jst = jlc.c_step(jmoved, jst)
    tst = tlc.c_step(tmoved, tst)
    post = tlc.shifted_distortion(tmoved, tst)
    for n in pre:                                   # the §7 monitor
        assert float(post[n]) <= pre[n] * (1 + 1e-5) + 1e-6, n
    return jlc, tlc, jst, tst, tst0, tmoved


def _close_products(a, b, scale):
    np.testing.assert_allclose(_np(a), np.asarray(b), rtol=1e-5,
                               atol=1e-5 * scale)


@pytest.mark.parametrize("backend,jbackend", [("off", "off"),
                                              ("auto", "auto")])
def test_lowrank_through_lc_matches_jax(backend, jbackend):
    w = _decaying_stack(2, 60, 40, seed=21)
    params = {"a": w[0], "b": w[1], "s": _decaying_stack(3, 30, 20, seed=22)}

    def tasks(pkg):
        T, I, S, s = ((CompressionTask, AsIs, AsStacked, ts) if pkg == "t"
                      else (JTask, JAsIs, JAsStacked, js))
        return [T("a", "^a$", I(), s.LowRank(6)),
                T("b", "^b$", I(), s.LowRank(3)),
                T("s", "^s$", S("matrix"), s.LowRank(4))]

    jlc, tlc, jst, tst, tst0, tmoved = _lc_pair(
        tasks("j"), tasks("t"), params, backend, jbackend)
    # Θ^DC: the exact SVD in both packages (these shapes are ≤ 2048)
    jdc = JLC(tasks("j"), [1e-2]).init({k: jnp.asarray(v)
                                        for k, v in params.items()})
    for name in ("a", "b", "s"):
        for p in tlc.tasks[[t.name for t in tlc.tasks].index(name)].paths:
            scale = float(np.abs(params[p]).max())
            _close_products(tst0["tasks"][name]["a"][p],
                            jdc["tasks"][name]["a"][p], scale)
            a, ja = tst["tasks"][name]["a"][p], jst["tasks"][name]["a"][p]
            if backend == "off":           # exact SVD: equal products
                _close_products(a, ja, scale)
            else:                           # randomized: within budget
                d = float(torch.sum((tmoved[p] - a) ** 2))
                jd = float(jnp.sum((jnp.asarray(_np(tmoved[p])) - ja) ** 2))
                assert abs(d - jd) <= 1e-4 * jd, (name, d, jd)
    assert tlc.compression_ratio(tmoved, tst) == pytest.approx(
        jlc.compression_ratio({k: jnp.asarray(_np(v))
                               for k, v in tmoved.items()}, jst), rel=1e-6)


@pytest.mark.parametrize("backend,jbackend", [("off", "off"),
                                              ("auto", "auto")])
def test_rank_selection_through_lc_matches_jax(backend, jbackend):
    w = _decaying_stack(4, 80, 60, seed=13)
    params = {f"l{i}": w[i] for i in range(4)}
    alphas = (1e-4, 3e-4, 1e-3, 3e-3)

    def tasks(pkg):
        T, I, s = ((CompressionTask, AsIs, ts) if pkg == "t"
                   else (JTask, JAsIs, js))
        return [T(f"rs{i}", f"^l{i}$", I(),
                  s.RankSelection(alpha=a, max_rank=24))
                for i, a in enumerate(alphas)]

    # a small move keeps the decaying spectrum (a large one adds a flat
    # noise bulk, where no sketch of width r_max + 16 meets the budget)
    jlc, tlc, jst, tst, _, tmoved = _lc_pair(tasks("j"), tasks("t"), params,
                                             backend, jbackend, mu=1.0,
                                             move=1e-3)
    for i in range(4):
        th, jth = tst["tasks"][f"rs{i}"]["theta"], \
            jst["tasks"][f"rs{i}"]["theta"]
        assert int(th["rank"]) == int(jth["rank"]) > 0
        assert th["rank"].ndim == 0
        p = f"l{i}"
        scale = float(np.abs(w).max())
        if backend == "off":
            _close_products(tst["tasks"][f"rs{i}"]["a"][p],
                            jst["tasks"][f"rs{i}"]["a"][p], scale)
        r = int(th["rank"])
        d = float(torch.sum((tmoved[p] - th["u"] @ th["v"].T) ** 2))
        d_exact = float(lref.tail_distortion_ref(tmoved[p][None],
                                                 torch.tensor([r]))[0])
        assert d <= d_exact * (1 + 1e-4), (i, d, d_exact)
        m, n = w.shape[1:]
        assert float(tlc.tasks[i].scheme.bits(th)) == pytest.approx(
            float(jlc.tasks[i].scheme.bits(jth)))
        assert float(tlc.tasks[i].scheme.flops(th, (m, n))) == \
            float(jlc.tasks[i].scheme.flops(jth, (m, n))) == r * 2.0 * (m + n)


def test_additive_combination_through_lc_matches_jax():
    rng = np.random.default_rng(31)
    params = {"l0": rng.standard_normal((40, 30)).astype(np.float32),
              "l1": rng.standard_normal((30, 20)).astype(np.float32)}

    def tasks(pkg):
        T, V, s = ((CompressionTask, AsVector, ts) if pkg == "t"
                   else (JTask, JAsVector, js))
        return [T("pq", r"^l\d$", V(), s.AdditiveCombination(
            [s.ConstraintL0Pruning(kappa=40), s.AdaptiveQuantization(k=2)],
            iters=2))]

    jlc, tlc, jst, tst, tst0, tmoved = _lc_pair(
        tasks("j"), tasks("t"), params, "auto", "auto")
    jdc = JLC(tasks("j"), [1e-2]).init({k: jnp.asarray(v)
                                        for k, v in params.items()})
    for st, jref in ((tst0, jdc), (tst, jst)):
        parts = st["tasks"]["pq"]["theta"]["parts"]
        jparts = jref["tasks"]["pq"]["theta"]["parts"]
        np.testing.assert_array_equal(_np(parts[0]["theta"]) != 0,
                                      np.asarray(jparts[0]["theta"]) != 0)
        assert int((parts[0]["theta"] != 0).sum()) == 40
        np.testing.assert_allclose(_np(parts[0]["theta"]),
                                   np.asarray(jparts[0]["theta"]),
                                   rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(_np(parts[1].codebook),
                                   np.asarray(jparts[1].codebook),
                                   atol=KMEANS_CB_ATOL)
        np.testing.assert_array_equal(_np(parts[1].assign),
                                      np.asarray(jparts[1].assign))
        for p in ("l0", "l1"):
            np.testing.assert_allclose(_np(st["tasks"]["pq"]["a"][p]),
                                       np.asarray(jref["tasks"]["pq"]["a"][p]),
                                       rtol=1e-5, atol=KMEANS_CB_ATOL)
    assert tlc.compression_ratio(tmoved, tst) == pytest.approx(
        jlc.compression_ratio({k: jnp.asarray(_np(v))
                               for k, v in tmoved.items()}, jst), rel=1e-6)
    scheme, jscheme = tlc.tasks[0].scheme, jlc.tasks[0].scheme
    assert scheme.domain == jscheme.domain == "vector"
    assert scheme.group_key() == jscheme.group_key()
    assert scheme.init_key() == jscheme.init_key()


def test_additive_decompress_in_the_matrix_domain():
    """A matrix-domain part (low rank) sets the shape the vector parts are
    reshaped to; the state carries over from JAX as nested Θs."""
    rng = np.random.default_rng(33)
    w = rng.standard_normal((24, 16)).astype(np.float32)
    scheme = ts.AdditiveCombination([ts.LowRank(3),
                                     ts.ConstraintL0Pruning(kappa=20)],
                                    iters=2)
    jscheme = js.AdditiveCombination([js.LowRank(3),
                                      js.ConstraintL0Pruning(kappa=20)],
                                     iters=2)
    assert scheme.domain == "matrix"
    th = scheme.compress(_t(w), scheme.init(_t(w)))
    jth = jscheme.compress(jnp.asarray(w), jscheme.init(jnp.asarray(w)))
    d, jd = scheme.decompress(th), jscheme.decompress(jth)
    assert d.shape == (24, 16)
    np.testing.assert_allclose(_np(d), np.asarray(jd), rtol=1e-5,
                               atol=1e-5 * np.abs(w).max())
    carried = interop._theta_from_numpy(
        jax.tree_util.tree_map(np.asarray, jth), "cpu")
    np.testing.assert_allclose(_np(scheme.decompress(carried)),
                               np.asarray(jd), rtol=1e-6, atol=1e-6)
    assert scheme.bits(th) == jscheme.bits(jth)
