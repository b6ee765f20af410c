"""The port's C-step kernels and solvers against the JAX package.

The JAX side runs its Pallas kernels in interpret mode, as its own tests
do; the port's wrappers run each kernel's plain PyTorch version on CPU
tensors (the CUDA kernels themselves are held against the same plain
versions on the card by ``chip_smoke.py`` and ``tests/test_torch_cuda.py``).
Inputs come from numpy with a fixed seed and go to both packages.

Tolerances (ROADMAP queue 3):
* bit-identical — assignments, integer counts, top-κ masks (the
  bisection driver against JAX's ``interpret`` driver included),
  ``soft_threshold``;
* K1 moments against the JAX kernel: the reference's own bound, sums
  rtol 3e-4 / atol 1e-2 (tests/test_kernel_dispatch.py), codebooks after
  a Lloyd loop atol 1e-3 (``KMEANS_CB_ATOL``);
* other float reductions: rtol 1e-6 (atol 1e-5 where sums cancel).
"""
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import dispatch as jdispatch
from repro.kernels.kmeans import ops as jkops
from repro.kernels.kmeans import ref as jkref
from repro.kernels.prune import ops as jpops
from repro.kernels.prune.prune import count_above_batched as j_count
from repro_torch.kernels import dispatch
from repro_torch.kernels.kmeans import ops as kops
from repro_torch.kernels.prune import ops as pops
from repro_torch.kernels.prune import prune as k2
from torch_threads import _one_torch_thread  # noqa: F401


# the package exports the Lloyd loop ``kmeans`` (as the JAX package does),
# which shadows the kernel module of the same name
k1 = importlib.import_module("repro_torch.kernels.kmeans.kmeans")

KMEANS_CB_ATOL = 1e-3


def _t(x):
    return torch.from_numpy(np.array(x, copy=True))


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def _weights(seed, i, p, tie_every=0):
    rng = np.random.default_rng(seed)
    w = rng.standard_normal((i, p)).astype(np.float32)
    if tie_every:
        # magnitude ties across signs and positions
        w[:, ::tie_every] = np.float32(0.5) * np.sign(w[:, ::tie_every])
    return w


def _codebooks(seed, i, k, kvalid=None):
    rng = np.random.default_rng(seed + 1)
    cb = np.sort(rng.standard_normal((i, k)).astype(np.float32), axis=-1)
    if kvalid is not None:
        cb = np.where(np.arange(k)[None, :] < np.asarray(kvalid)[:, None],
                      cb, np.inf).astype(np.float32)
    return cb


# ----------------------------------------------------------------------
# K1: assignment + moments
# ----------------------------------------------------------------------
@pytest.mark.parametrize("i,p,k,kvalid", [
    (1, 2048, 4, None), (3, 5000, 8, None), (2, 1023, 16, None),
    (4, 4096, 16, [16, 4, 9, 2]),           # mixed K: +inf entries
])
def test_k1_plain_matches_jax_kernel(i, p, k, kvalid):
    w, cb = _weights(i * p, i, p), _codebooks(k, i, k, kvalid)
    a1, s1, c1 = k1.kmeans_assign_moments_batched(_t(w), _t(cb))
    a2, s2, c2 = jkops.assign_moments_batched(jnp.asarray(w),
                                              jnp.asarray(cb),
                                              interpret=True)
    np.testing.assert_array_equal(_np(a1), np.asarray(a2))
    np.testing.assert_array_equal(_np(c1), np.asarray(c2).astype(np.int32))
    np.testing.assert_allclose(_np(s1), np.asarray(s2), rtol=3e-4, atol=1e-2)
    # against the segment-sum oracle: a float reduction in another order
    a3, s3, c3 = jkref.kmeans_assign_moments_batched_ref(jnp.asarray(w),
                                                         jnp.asarray(cb))
    np.testing.assert_array_equal(_np(a1), np.asarray(a3))
    np.testing.assert_allclose(_np(s1), np.asarray(s3), rtol=1e-6, atol=1e-5)


def test_k1_plain_chunked_matches_one_pass(monkeypatch):
    """Items longer than the plain version's column chunk add the chunk
    sums in order: same assignments and counts, sums to rtol 1e-6."""
    from repro_torch.kernels.kmeans import ref
    w, cb = _weights(3, 2, 10_000), _codebooks(3, 2, 8)
    one = ref.kmeans_assign_moments_batched_plain(_t(w), _t(cb))
    monkeypatch.setattr(ref, "CHUNK", 1024)
    chunked = ref.kmeans_assign_moments_batched_plain(_t(w), _t(cb))
    np.testing.assert_array_equal(_np(one[0]), _np(chunked[0]))
    np.testing.assert_array_equal(_np(one[2]), _np(chunked[2]))
    np.testing.assert_allclose(_np(one[1]), _np(chunked[1]), rtol=1e-6,
                               atol=1e-5)


@pytest.mark.parametrize("impl,jimpl", [("kernel", "interpret"),
                                        ("torch", "jnp")])
@pytest.mark.parametrize("kvalid", [None, [4, 8, 2]])
def test_kmeans_batched_matches_jax(impl, jimpl, kvalid):
    w = _weights(11, 3, 3000)
    cb0 = _codebooks(5, 3, 8)
    kv_t = None if kvalid is None else torch.tensor(kvalid, dtype=torch.int32)
    kv_j = None if kvalid is None else jnp.asarray(kvalid, jnp.int32)
    cb1, a1 = kops.kmeans_batched(_t(w), _t(cb0), kv_t, iters=6, impl=impl)
    cb2, a2 = jkops.kmeans_batched(jnp.asarray(w), jnp.asarray(cb0), kv_j,
                                   iters=6, impl=jimpl)
    np.testing.assert_allclose(_np(cb1), np.asarray(cb2),
                               atol=KMEANS_CB_ATOL)
    np.testing.assert_array_equal(_np(a1), np.asarray(a2))
    if kvalid is not None:
        for r, kv in enumerate(kvalid):   # padded slots pinned to +inf
            assert np.isinf(_np(cb1)[r, kv:]).all()
            assert np.isfinite(_np(cb1)[r, :kv]).all()


# ----------------------------------------------------------------------
# K2: threshold count, and the top-κ bisection driver
# ----------------------------------------------------------------------
@pytest.mark.parametrize("strict", [True, False])
@pytest.mark.parametrize("i,p", [(1, 1024), (3, 2500), (2, 4096)])
def test_k2_plain_matches_jax_kernel(strict, i, p):
    w = _weights(i + p, i, p, tie_every=7)
    t = np.abs(w).max(-1) * np.float32(0.3)
    t[0] = np.float32(0.5)                      # exactly the tied class
    c1 = k2.count_above_batched(_t(w), _t(t), strict=strict)
    pad = (-p) % 1024                           # zeros: below every t > 0
    wp = np.pad(w, ((0, 0), (0, pad)))
    c2 = j_count(jnp.asarray(wp), jnp.asarray(t), interpret=True,
                 strict=strict)
    assert c1.dtype == torch.int32
    np.testing.assert_array_equal(_np(c1), np.asarray(c2).astype(np.int32))


@pytest.mark.parametrize("impl,jimpl", [("kernel", "interpret"),
                                        ("torch", "jnp")])
@pytest.mark.parametrize("i,p,kappa,tie_every", [
    (1, 1000, [37], 0),
    (3, 2500, [1, 250, 2499], 5),              # ragged P, tied magnitudes
    (4, 777, [100, 100, 7, 777], 3),           # mixed κ, κ = P
])
def test_topk_mask_batched_bit_identical(impl, jimpl, i, p, kappa,
                                         tie_every):
    w = _weights(p, i, p, tie_every=tie_every)
    kap = np.asarray(kappa, np.int32)
    out = pops.topk_mask_batched(_t(w), _t(kap), impl=impl)
    ref = jpops.topk_mask_batched(jnp.asarray(w), jnp.asarray(kap),
                                  impl=jimpl)
    np.testing.assert_array_equal(_np(out), np.asarray(ref))
    np.testing.assert_array_equal((_np(out) != 0).sum(-1),
                                  np.minimum(kap, p))


def test_topk_kernel_driver_launch_count_and_no_sync_state(monkeypatch):
    """On CPU tensors the solver's bisection is the plain loop of the
    fused kernel: iters + 1 plain count calls, and neither the fused
    kernel's nor the single count's launch counter moves."""
    from repro_torch.kernels.prune import ref as pref
    calls = []
    real = pref.count_above_batched_plain

    def spy(w, t, strict=True):
        calls.append((tuple(w.shape), strict))
        return real(w, t, strict)

    w = _weights(1, 2, 500)
    before = (k2.TOPK.launches, k2.KERNEL.launches)
    monkeypatch.setattr(pref, "count_above_batched_plain", spy)
    pops.topk_mask_batched(_t(w), torch.tensor([10, 20]), iters=30,
                           impl="kernel")
    assert len(calls) == 31 and all(not s for _, s in calls)
    assert (k2.TOPK.launches, k2.KERNEL.launches) == before


def _np_bisection(w, kappa, iters, strict):
    """The bisection in numpy float32 over the JAX package's K2 kernel in
    interpret mode (rows padded with zeros, which no threshold > 0
    counts): (lo, hi, n_hi)."""
    pad = (-w.shape[1]) % 1024
    wp = jnp.asarray(np.pad(w, ((0, 0), (0, pad))))

    def count(t):
        return np.asarray(j_count(wp, jnp.asarray(t), interpret=True,
                                  strict=strict)).astype(np.int32)

    a_max = np.abs(w).max(-1)
    hi = a_max if strict else a_max * np.float32(2) + np.float32(1)
    lo = np.zeros_like(hi)
    for _ in range(iters):
        mid = np.float32(0.5) * (lo + hi)
        n = count(mid)
        move = n > kappa if strict else n >= kappa
        lo, hi = np.where(move, mid, lo), np.where(move, hi, mid)
    return lo, hi, count(hi)


@pytest.mark.parametrize("strict", [False, True])
@pytest.mark.parametrize("i,p,kappa,tie_every", [
    (3, 2500, [1, 250, 2499], 5),              # ragged P, tied magnitudes
    (4, 777, [100, 100, 7, 777], 3),           # mixed κ, κ = P
    (1, 4096, [409], 0),
])
def test_topk_threshold_plain_matches_jax_bisection(strict, i, p, kappa,
                                                    tie_every):
    """The fused bisection's plain version: (lo, hi, n_hi) bit for bit
    those of a numpy bisection over the JAX kernel, with the batched and
    the single-vector (strict) rules."""
    w = _weights(p + i, i, p, tie_every=tie_every)
    kap = np.asarray(kappa, np.int32)
    lo, hi, n_hi = k2.topk_threshold_batched_plain(_t(w), _t(kap), 30,
                                                   strict)
    jlo, jhi, jn = _np_bisection(w, kap, 30, strict)
    assert lo.dtype == hi.dtype == torch.float32 and n_hi.dtype == torch.int32
    np.testing.assert_array_equal(_np(lo).view(np.int32), jlo.view(np.int32))
    np.testing.assert_array_equal(_np(hi).view(np.int32), jhi.view(np.int32))
    np.testing.assert_array_equal(_np(n_hi), jn)
    # the wrapper on a CPU tensor is the plain version, and reports no
    # compaction and the plain loop's passes
    got = k2.topk_threshold_batched(_t(w), _t(kap), 30, strict,
                                    with_stats=True)
    for a, b in zip(got[:3], (lo, hi, n_hi)):
        assert torch.equal(a, b)
    assert got[3].tolist() == [[0, -1, 32, -1]] * i


@pytest.mark.parametrize("kvalid", [None, [4, 8, 2]])
def test_kmeans_lloyd_plain_matches_jax(kvalid):
    """The fused Lloyd loop's plain version against the JAX solver's
    interpret path: codebooks within KMEANS_CB_ATOL, assignments equal."""
    w = _weights(13, 3, 3000, tie_every=11)
    cb0 = _codebooks(7, 3, 8, kvalid)
    cb, a = k1.kmeans_lloyd_batched_plain(
        _t(w), torch.sort(_t(cb0), dim=-1).values, 6)
    kv_j = None if kvalid is None else jnp.asarray(kvalid, jnp.int32)
    jcb, ja = jkops.kmeans_batched(jnp.asarray(w), jnp.asarray(cb0), kv_j,
                                   iters=6, impl="interpret")
    np.testing.assert_allclose(_np(cb), np.asarray(jcb), atol=KMEANS_CB_ATOL)
    np.testing.assert_array_equal(_np(a), np.asarray(ja))
    assert a.dtype == torch.int32 and cb.shape == (3, 8)


def test_kmeans_lloyd_plain_rounds_counts_to_nearest():
    """A cluster of 2^24 + 3 weights: the update divides by the count
    rounded to nearest f32 (2^24 + 4, as torch's type promotion and the
    kernel's __int2float_rn round it), not truncated (2^24 + 2)."""
    n = 2**24 + 3
    w = torch.ones((1, n), dtype=torch.float32)
    cb, a = k1.kmeans_lloyd_batched_plain(w, torch.tensor([[1.0, 5.0]]), 1)
    _, sums, counts = k1.kmeans_assign_moments_batched_plain(
        w, torch.tensor([[1.0, 5.0]]))
    assert counts.tolist() == [[n, 0]]
    s = np.float32(_np(sums)[0, 0])
    assert np.float32(n) == np.float32(2**24 + 4)
    want = s / np.float32(n)
    assert want != s / np.float32(2**24 + 2)
    assert _np(cb).tolist() == [[float(want), 5.0]]
    assert int(a.sum()) == 0


def test_l1_solvers_match_jax():
    w = _weights(9, 3, 600)
    radius = np.asarray([5.0, 1e6, 40.0], np.float32)   # row 1 inside
    alpha = np.asarray([1e-4, 3e-4, 0.0], np.float32)
    mu = np.float32(1.3e-3)
    p1 = pops.project_l1_ball_batched(_t(w), _t(radius))
    p2 = jpops.project_l1_ball_batched(jnp.asarray(w), jnp.asarray(radius))
    np.testing.assert_allclose(_np(p1), np.asarray(p2), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_array_equal(_np(p1)[1], w[1])
    s1 = pops.soft_threshold_batched(_t(w), _t(alpha),
                                     torch.tensor(mu))
    s2 = jpops.soft_threshold_batched(jnp.asarray(w), jnp.asarray(alpha),
                                      jnp.float32(mu))
    np.testing.assert_array_equal(_np(s1), np.asarray(s2))


# ----------------------------------------------------------------------
# wrappers and dispatch rules on CPU tensors
# ----------------------------------------------------------------------
def test_wrappers_use_plain_version_only_on_cpu():
    w, cb = _t(_weights(2, 2, 300)), _t(_codebooks(2, 2, 4))
    t = torch.tensor([0.5, 1.0])
    n1, n2 = k1.KERNEL.launches, k2.KERNEL.launches
    for got, want in zip(k1.kmeans_assign_moments_batched(w, cb),
                         k1.kmeans_assign_moments_batched_plain(w, cb)):
        assert torch.equal(got, want)
    assert torch.equal(k2.count_above_batched(w, t, strict=False),
                       k2.count_above_batched_plain(w, t, strict=False))
    assert (k1.KERNEL.launches, k2.KERNEL.launches) == (n1, n2)
    # no kernel and no plain version for other devices: the wrappers raise
    with pytest.raises(ValueError):
        k1.kmeans_assign_moments_batched(w.to("meta"), cb.to("meta"))
    with pytest.raises(ValueError):
        k2.count_above_batched(w.to("meta"), t.to("meta"))


def test_dispatch_rules():
    cpu, cuda = torch.device("cpu"), torch.device("cuda")
    assert dispatch.resolve_backend("auto", cpu) == "torch"
    assert dispatch.resolve_backend("auto", cuda) == "cuda"
    assert dispatch.resolve_backend("cuda", cpu) == "cuda"
    assert dispatch.resolve_backend("torch", cuda) == "torch"
    assert dispatch.resolve_backend("off", cpu) is None
    assert dispatch.resolve_backend(None, cpu) is None
    with pytest.raises(ValueError):
        dispatch.resolve_backend("pallas", cpu)
    fn, backend = dispatch.lookup("topk_mask", "cuda", cpu)
    assert backend == "cuda" and fn.keywords["impl"] == "kernel"
    assert dispatch.lookup("kmeans_lloyd", "auto", cpu)[1] == "torch"
    # backend gap: plain-only solvers serve a cuda request
    assert dispatch.lookup("project_l1_ball", "cuda", cpu)[1] == "torch"
    assert dispatch.lookup("soft_threshold", "auto", cuda)[1] == "torch"
    # the matmul-only low-rank solvers: the torch program serves auto and
    # cuda requests on either device (backend-gap rule)
    for solver in ("lowrank_rsvd", "rank_select"):
        for req in ("auto", "cuda", "torch"):
            for dev in (cpu, cuda):
                fn, backend = dispatch.lookup(solver, req, dev)
                assert backend == "torch", (solver, req, dev)
                assert fn is dispatch.registry_entries()[solver]["torch"]
    assert dispatch.lookup("topk_mask", "off", cpu) == (None, None)
    assert dispatch.lookup("no_such_solver", "auto", cpu) == (None, None)
    assert dispatch.solver_table() == {
        "kmeans_lloyd": ("cuda", "torch"), "lowrank_rsvd": ("torch",),
        "project_l1_ball": ("torch",), "rank_select": ("torch",),
        "soft_threshold": ("torch",), "topk_mask": ("cuda", "torch")}
    # the scheme operands bind to the same solver parameters as in JAX
    for solver in ("kmeans_lloyd", "topk_mask", "project_l1_ball",
                   "soft_threshold", "lowrank_rsvd", "rank_select"):
        ours = dispatch.solver_signature(solver)
        theirs = jdispatch.solver_signature(solver)
        n = {"kmeans_lloyd": 3, "topk_mask": 2}.get(solver, len(theirs))
        assert ours[:n] == theirs[:n], solver
    assert set(dispatch.registry_entries()) == set(dispatch.solver_table())


# ----------------------------------------------------------------------
# K3/K9: threshold masks; K8: the single-vector count; K7: single-vector
# k-means — plain versions against the JAX kernels in interpret mode
# ----------------------------------------------------------------------
def _jax_normal(shape, seed=11):
    import jax
    return np.asarray(jax.random.normal(
        jax.random.fold_in(jax.random.PRNGKey(0), seed), shape))


@pytest.mark.parametrize("t_vals", [(0.1, 0.7), (0.0, 2.5), (1.0, 1.0)])
def test_batched_count_mask_kernels_vs_jax(t_vals):
    """The cases of the reference's test_batched_count_mask_kernels_vs_ref,
    plus the non-strict comparison."""
    from repro.kernels.prune.prune import mask_apply_batched as j_mask
    w = _jax_normal((2, 4 * 8 * 128))
    t = np.asarray(t_vals, np.float32)
    for strict in (True, False):
        c = k2.count_above_batched(_t(w), _t(t), strict=strict)
        jc = j_count(jnp.asarray(w), jnp.asarray(t), interpret=True,
                     strict=strict)
        np.testing.assert_array_equal(_np(c), np.asarray(jc).astype(np.int32))
        m = k2.mask_apply_batched(_t(w), _t(t), strict=strict)
        jm = j_mask(jnp.asarray(w), jnp.asarray(t), interpret=True,
                    strict=strict)
        np.testing.assert_array_equal(_np(m), np.asarray(jm))


@pytest.mark.parametrize("i,p", [(3, 100_003), (1, 1023), (2, 5)])
def test_mask_apply_batched_ragged_vs_jax(i, p):
    """Ragged rows: the port masks the tail, JAX pads with zeros."""
    from repro.kernels.prune.prune import mask_apply_batched as j_mask
    w = _weights(p, i, p, tie_every=3)
    t = np.abs(w).max(-1) * np.float32(0.4)
    t[0] = np.float32(0.5)                     # exactly the tied class
    pad = (-p) % 1024
    for strict in (True, False):
        m = k2.mask_apply_batched(_t(w), _t(t), strict=strict)
        jm = j_mask(jnp.asarray(np.pad(w, ((0, 0), (0, pad)))),
                    jnp.asarray(t), interpret=True, strict=strict)
        np.testing.assert_array_equal(_np(m), np.asarray(jm)[:, :p])


@pytest.mark.parametrize("t", [0.1, 0.7, 2.5])
def test_prune_count_mask_kernels_vs_jax(t):
    """The cases of the reference's test_prune_count_mask_kernels_vs_ref
    (K8 and K9, single vectors)."""
    from repro.kernels.prune.prune import count_above as j_count1
    from repro.kernels.prune.prune import mask_apply as j_mask1
    w = _jax_normal((4 * 8 * 128,))
    tj = jnp.float32(t)
    c = k2.count_above(_t(w), torch.tensor(t, dtype=torch.float32))
    assert c.dtype == torch.int32 and c.ndim == 0
    assert int(c) == int(j_count1(jnp.asarray(w), tj, interpret=True))
    np.testing.assert_array_equal(
        _np(k2.mask_apply(_t(w), torch.tensor(t, dtype=torch.float32))),
        np.asarray(j_mask1(jnp.asarray(w), tj, interpret=True)))


@pytest.mark.parametrize("p,kappa,tie_every,shape", [
    (8192, 100, 0, None), (3000, 1000, 5, None), (1023, 1, 3, None),
    (4096, 4096, 0, None), (2400, 77, 7, (40, 60)),
])
def test_topk_mask_single_vector_bit_identical(p, kappa, tie_every, shape):
    """K8's top-κ loop: strict counts, (lo, hi] boundary filled in index
    order — bit-identical to JAX's kernel path, 31 strict count calls (the
    plain loop of the fused bisection, on a CPU tensor) and one mask
    call."""
    from repro_torch.kernels.prune import ref as pref
    w = _weights(p + kappa, 1, p, tie_every=tie_every)[0]
    if shape is not None:
        w = w.reshape(shape)
    calls = {"count": 0, "mask": 0}
    real_count, real_mask = pref.count_above_batched_plain, pops.mask_apply

    def count_spy(w_, t_, strict=True):
        assert strict and w_.shape == (1, p)
        calls["count"] += 1
        return real_count(w_, t_, strict)

    def mask_spy(w_, t_):
        calls["mask"] += 1
        return real_mask(w_, t_)

    pref.count_above_batched_plain, pops.mask_apply = count_spy, mask_spy
    try:
        out = pops.topk_mask(_t(w), kappa)
    finally:
        pref.count_above_batched_plain, pops.mask_apply = (real_count,
                                                           real_mask)
    ref = jpops.topk_mask(jnp.asarray(w), kappa, use_pallas=True)
    assert out.shape == w.shape
    np.testing.assert_array_equal(_np(out), np.asarray(ref))
    assert int((out != 0).sum()) == min(kappa, int((w != 0).sum()))
    assert calls == {"count": 31, "mask": 1}


def test_topk_mask_batched_keeps_the_hi_class_with_k3():
    """The batched top-κ loop ends with one K3 call (non-strict, at hi)."""
    calls = []
    real = pops.mask_apply_batched

    def spy(w, t, strict=True):
        calls.append((tuple(w.shape), strict))
        return real(w, t, strict)

    w = _weights(2, 3, 700, tie_every=4)
    pops.mask_apply_batched = spy
    try:
        out = pops.topk_mask_batched(_t(w), torch.tensor([5, 70, 700]),
                                     impl="kernel")
    finally:
        pops.mask_apply_batched = real
    assert calls == [((3, 700), False)]
    np.testing.assert_array_equal((_np(out) != 0).sum(-1), [5, 70, 700])


@pytest.mark.parametrize("p,k", [(4096, 4), (3 * 1024, 16), (1000, 8)])
def test_k7_plain_matches_jax_kernel(p, k):
    """K7 (single-vector assignment + moments) against the JAX kernel
    path: equal assignments and counts, sums within the reference's own
    bound (tests/test_kernels.py)."""
    from repro.kernels.kmeans import ops as jk
    w = _jax_normal((p,), seed=p * k)
    cb = np.sort(_jax_normal((k,), seed=p * k + 1))
    a, s, c = kops.assign_moments(_t(w), _t(cb))
    ja, js_, jc = jk.assign_moments(jnp.asarray(w), jnp.asarray(cb),
                                    use_pallas=True)
    np.testing.assert_array_equal(_np(a), np.asarray(ja))
    np.testing.assert_array_equal(_np(c), np.asarray(jc).astype(np.int32))
    np.testing.assert_allclose(_np(s), np.asarray(js_), rtol=3e-4, atol=1e-2)
    assert a.dtype == c.dtype == torch.int32


def test_k7_lloyd_loop_matches_jax():
    from repro.kernels.kmeans import ops as jk
    w = _jax_normal((8192,), seed=2)
    cb0 = np.sort(_jax_normal((8,), seed=3))
    step = kops.lloyd_step(_t(w), _t(cb0))
    np.testing.assert_allclose(
        _np(step), np.asarray(jk.lloyd_step(jnp.asarray(w), jnp.asarray(cb0),
                                            use_pallas=True)),
        rtol=3e-4, atol=1e-5)
    cb, a = kops.kmeans(_t(w), _t(cb0), iters=20)
    jcb, ja = jk.kmeans(jnp.asarray(w), jnp.asarray(cb0), iters=20,
                        use_pallas=True)
    np.testing.assert_allclose(_np(cb), np.asarray(jcb), atol=KMEANS_CB_ATOL)
    np.testing.assert_array_equal(_np(a), np.asarray(ja))
    # the package exports the single-vector API as the JAX package does
    from repro_torch.kernels import kmeans as kpkg, prune as ppkg
    assert kpkg.kmeans is kops.kmeans and ppkg.topk_mask is pops.topk_mask


def test_single_vector_wrappers_use_plain_version_only_on_cpu():
    w, cb = _t(_weights(5, 1, 3000)[0]), _t(_codebooks(5, 1, 4)[0])
    t = torch.tensor(0.5)
    before = (k1.SINGLE.launches, k2.COUNT_SINGLE.launches,
              k2.MASK_KERNEL.launches, k2.MASK_SINGLE.launches)
    for got, want in zip(k1.kmeans_assign_moments(w, cb),
                         k1.kmeans_assign_moments_plain(w, cb)):
        assert torch.equal(got, want)
    assert torch.equal(k2.count_above(w, t), k2.count_above_plain(w, t))
    assert torch.equal(k2.mask_apply(w, t), k2.mask_apply_plain(w, t))
    assert torch.equal(k2.mask_apply_batched(w[None], t[None], False),
                       k2.mask_apply_batched_plain(w[None], t[None], False))
    assert before == (k1.SINGLE.launches, k2.COUNT_SINGLE.launches,
                      k2.MASK_KERNEL.launches, k2.MASK_SINGLE.launches)
    for call in (lambda: k1.kmeans_assign_moments(w.to("meta"),
                                                  cb.to("meta")),
                 lambda: k2.count_above(w.to("meta"), t.to("meta")),
                 lambda: k2.mask_apply(w.to("meta"), t.to("meta"))):
        with pytest.raises(ValueError):
            call()
    # K3 has a meta branch (the planner's counts): its output's shape,
    # no launch
    out = k2.mask_apply_batched(w[None].to("meta"), t[None].to("meta"))
    assert out.is_meta and out.shape == (1, w.numel())
    assert before == (k1.SINGLE.launches, k2.COUNT_SINGLE.launches,
                      k2.MASK_KERNEL.launches, k2.MASK_SINGLE.launches)
