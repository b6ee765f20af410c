"""The port's CUDA kernels against their plain versions, and serving
through CUDA graphs against the eager programs, on the card.

Every test here needs an NVIDIA GPU and nvcc and skips elsewhere. The
file imports only torch and the port, so it runs on a machine without
JAX (``tests/conftest.py`` imports JAX, hence ``--noconftest``):

    python -m pytest -q --noconftest -m cuda tests/test_torch_cuda.py

``chip_smoke.py`` runs the same checks at the main paths' shapes.
Tolerances: assignments, counts and masks equal; K1/K7 sums rtol 1e-5 /
atol 1e-3;
K4/K5 rtol 1e-5 / atol 1e-4; K6 rtol 2e-4 / atol 2e-4 (the reference's
own, ``tests/test_kernels.py``).
"""
import importlib
import math

import pytest
import torch
import torch.nn.functional as F

from repro_torch.kernels.flash_attention import flash_attention as k6
from repro_torch.kernels.kmeans import ops as kops
from repro_torch.kernels.prune import ops as pops
from repro_torch.kernels.prune import prune as k2
from repro_torch.kernels.quant_matmul import ops as qops
from repro_torch.kernels.quant_matmul import quant_matmul as k45

# the package exports the Lloyd loop ``kmeans`` (as the JAX package does),
# which shadows the kernel module of the same name
k1 = importlib.import_module("repro_torch.kernels.kmeans.kmeans")


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.Generator(device="cuda").manual_seed(0)


@pytest.mark.cuda
def test_kernels_match_plain_versions_on_card(gen):
    """K1 and K2 against their plain versions."""
    w = torch.randn((3, 50_001), device="cuda", generator=gen)
    cb = torch.sort(torch.randn((3, 16), device="cuda", generator=gen),
                    -1).values
    cb[1, 5:] = torch.inf
    got = k1.kmeans_assign_moments_batched(w, cb)
    want = k1.kmeans_assign_moments_batched_plain(w, cb)
    assert torch.equal(got[0], want[0]) and torch.equal(got[2], want[2])
    torch.testing.assert_close(got[1], want[1], rtol=1e-5, atol=1e-3)
    t = w.abs().amax(-1) * 0.3
    for strict in (True, False):
        assert torch.equal(k2.count_above_batched(w, t, strict),
                           k2.count_above_batched_plain(w, t, strict))


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n,c", [
    (2, 300, 129, 16), (8, 3072, 256, 16), (17, 64, 33, 8),
    (130, 96, 200, 4), (5, 33, 24, 16),
])
def test_quant_matmul_kernels_match_plain_on_card(gen, m, k, n, c):
    """K5 (uint8, here also with C = 64) and K4 (4-bit packed, odd K with
    the zero column)."""
    x = torch.randn((m, k), device="cuda", generator=gen)
    for cc in (c, 64):
        idx = torch.randint(0, cc, (k, n), device="cuda", generator=gen,
                            dtype=torch.uint8)
        cb = torch.sort(torch.randn(cc, device="cuda",
                                    generator=gen)).values / math.sqrt(k)
        torch.testing.assert_close(k45.quant_matmul(x, idx, cb),
                                   k45.quant_matmul_plain(x, idx, cb),
                                   rtol=1e-5, atol=1e-4)
    idx = torch.randint(0, c, (k, n), device="cuda", generator=gen,
                        dtype=torch.uint8)
    cb = torch.sort(torch.randn(c, device="cuda", generator=gen)).values
    packed = qops.pack4(idx)
    xp = torch.cat([x, x.new_zeros((m, 1))], 1) if k % 2 else x
    torch.testing.assert_close(k45.quant_matmul_packed(xp, packed, cb),
                               k45.quant_matmul_packed_plain(xp, packed, cb),
                               rtol=1e-5, atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("b,s,kvh,g,d,window", [
    (2, 97, 3, 2, 16, 7), (1, 130, 2, 4, 96, 0), (1, 64, 1, 1, 8, 0),
    (1, 200, 2, 3, 32, 50), (1, 65, 1, 2, 128, 0), (2, 128, 2, 1, 64, 0),
])
def test_flash_attention_kernel_matches_plain_on_card(gen, b, s, kvh, g, d,
                                                      window):
    q = torch.randn((b, kvh, g, s, d), device="cuda", generator=gen)
    k = torch.randn((b, kvh, s, d), device="cuda", generator=gen)
    v = torch.randn((b, kvh, s, d), device="cuda", generator=gen)
    torch.testing.assert_close(k6.flash_attention(q, k, v, window=window),
                               k6.flash_attention_plain(q, k, v,
                                                        window=window),
                               rtol=2e-4, atol=2e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("g", [1, 3, 4, 8, 64])
@pytest.mark.parametrize("d", k6.HEAD_DIMS)
def test_flash_attention_kernel_over_its_domain_on_card(gen, d, g):
    """Every head dim × group sizes that do and do not divide the 64 rows
    of a block × sequence lengths around the 64-key tile, with and
    without a window."""
    for s in (1, 63, 64, 65, 97, 513):
        q = torch.randn((1, 2, g, s, d), device="cuda", generator=gen)
        k = torch.randn((1, 2, s, d), device="cuda", generator=gen)
        v = torch.randn((1, 2, s, d), device="cuda", generator=gen)
        for window in (0, 37):
            torch.testing.assert_close(
                k6.flash_attention(q, k, v, window=window),
                k6.flash_attention_plain(q, k, v, window=window),
                rtol=2e-4, atol=2e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("g", [1, 3, 4])
def test_flash_attention_kernel_at_mla_head_dims_on_card(gen, g):
    """V's own head dim (qk 96, v 64: MLA's pair) with the default and an
    explicit scale, sequence lengths around the 64-key tile, with and
    without a window; a pair the kernel is not built for is refused."""
    for s in (1, 63, 65, 130, 513):
        q = torch.randn((1, 2, g, s, 96), device="cuda", generator=gen)
        k = torch.randn((1, 2, s, 96), device="cuda", generator=gen)
        v = torch.randn((1, 2, s, 64), device="cuda", generator=gen)
        for window in (0, 37):
            for scale in (None, 0.07):
                got = k6.flash_attention(q, k, v, window=window, scale=scale)
                assert got.shape == (1, 2, g, s, 64)
                torch.testing.assert_close(
                    got, k6.flash_attention_plain(q, k, v, window=window,
                                                  scale=scale),
                    rtol=2e-4, atol=2e-4)
    with pytest.raises(ValueError, match="Dv"):
        k6.flash_attention(q, k, v[..., :32].contiguous())


@pytest.mark.cuda
def test_flash_attention_kernel_at_minicpm3_and_mixtral_prefill_on_card(gen):
    """minicpm3-4b's MLA prefill (B=2, S=512, 40 heads, qk 96, v 64,
    scale 1/√96) and mixtral-8x7b's windowed GQA prefill cut to S=1100
    with a window of 1024 that masks real keys (32 heads on 8, D=128):
    against the plain version, bit-identical on a rerun."""
    q = torch.randn((2, 40, 1, 512, 96), device="cuda", generator=gen)
    k = torch.randn((2, 40, 512, 96), device="cuda", generator=gen)
    v = torch.randn((2, 40, 512, 64), device="cuda", generator=gen)
    got = k6.flash_attention(q, k, v, scale=1 / math.sqrt(96))
    torch.testing.assert_close(got, k6.flash_attention_plain(q, k, v),
                               rtol=2e-4, atol=2e-4)
    assert torch.equal(got, k6.flash_attention(q, k, v,
                                               scale=1 / math.sqrt(96)))
    q = torch.randn((1, 8, 4, 1100, 128), device="cuda", generator=gen)
    k = torch.randn((1, 8, 1100, 128), device="cuda", generator=gen)
    v = torch.randn((1, 8, 1100, 128), device="cuda", generator=gen)
    got = k6.flash_attention(q, k, v, window=1024)
    torch.testing.assert_close(
        got, k6.flash_attention_plain(q, k, v, window=1024), rtol=2e-4,
        atol=2e-4)
    assert torch.equal(got, k6.flash_attention(q, k, v, window=1024))


@pytest.mark.cuda
def test_flash_attention_kernel_at_phi3_prefill_on_card(gen):
    """phi3-mini's prefill (B=2, S=512, 32 heads of 96): against the plain
    version, bit-identical on a rerun, and on operands 4 bytes off a
    16-byte boundary (the wrapper copies them)."""
    q = torch.randn((2, 32, 1, 512, 96), device="cuda", generator=gen)
    k = torch.randn((2, 32, 512, 96), device="cuda", generator=gen)
    v = torch.randn((2, 32, 512, 96), device="cuda", generator=gen)
    got = k6.flash_attention(q, k, v)
    torch.testing.assert_close(got, k6.flash_attention_plain(q, k, v),
                               rtol=2e-4, atol=2e-4)
    assert torch.equal(got, k6.flash_attention(q, k, v))
    shifted = torch.empty(k.numel() + 1, device="cuda")[1:].view(k.shape)
    shifted.copy_(k)
    assert torch.equal(k6.flash_attention(q, shifted, v), got)


def _gemm_operands(gen, m, k, n, c, bits, offset=0):
    """x, the weight (uint8 indices, or 4-bit packed with x's zero column
    for odd K) starting ``offset`` bytes into its buffer, and a codebook
    at the model's weight scale."""
    x = torch.randn((m, k), device="cuda", generator=gen)
    idx = torch.randint(0, c, (k, n), device="cuda", generator=gen,
                        dtype=torch.uint8)
    cb = torch.sort(torch.randn(c, device="cuda",
                                generator=gen)).values / math.sqrt(k)
    w = qops.pack4(idx) if bits == 4 else idx
    if offset:
        buf = torch.empty(w.numel() + offset, dtype=torch.uint8,
                          device="cuda")
        w = buf[offset:].view(w.shape).copy_(w)
    if bits == 4 and k % 2:
        x = torch.cat([x, x.new_zeros((m, 1))], 1)
    return x, w, cb


def _k45(bits):
    if bits == 4:
        return k45.quant_matmul_packed, k45.quant_matmul_packed_plain
    return k45.quant_matmul, k45.quant_matmul_plain


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 24, 129, 3072])
@pytest.mark.parametrize("m", [1, 2, 7, 8, 9, 16, 33, 130, 1024])
def test_quant_matmul_over_its_domain_on_card(gen, m, n):
    """Both sides of the decode/prefill threshold (M = 8), ragged N, odd K
    (u8; the zero column for 4-bit), C ∈ {1, 2, 16} (4-bit) and
    {1, 64, 256} (u8), one launch a call."""
    for bits, cs in ((8, (1, 64, 256)), (4, (1, 2, 16))):
        kern, plain = _k45(bits)
        counter = k45.KERNEL_U8 if bits == 8 else k45.KERNEL_PACKED4
        for c in cs:
            x, w, cb = _gemm_operands(gen, m, 301, n, c, bits)
            before = counter.launches
            got = kern(x, w, cb)
            assert counter.launches == before + 1
            torch.testing.assert_close(got, plain(x, w, cb), rtol=1e-5,
                                       atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("m", [1, 2, 8, 9, 1024])
@pytest.mark.parametrize("bits", [8, 4])
def test_quant_matmul_on_offset_weights_on_card(gen, bits, m):
    """A weight view 1 byte off its buffer (the element-wise load path),
    at N = 3072 and, for N not a multiple of 16, on an aligned one."""
    kern, plain = _k45(bits)
    for n, offset in ((3072, 1), (200, 0), (200, 1)):
        x, w, cb = _gemm_operands(gen, m, 512, n, 16, bits, offset)
        torch.testing.assert_close(kern(x, w, cb), plain(x, w, cb),
                                   rtol=1e-5, atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("m", [1, 2, 8])
@pytest.mark.parametrize("bits,k,n,c", [
    (8, 3072, 3072, 64), (4, 3072, 8192, 16), (4, 8192, 3072, 16),
    (8, 8192, 24, 256), (4, 20_000, 64, 16),
])
def test_quant_gemv_split_k_on_card(gen, bits, k, n, c, m):
    """Decode shapes whose K is split over several blocks: the serving
    paths' weights and a long, narrow one, against the plain version."""
    assert k45.gemv_slices(k // 2 if bits == 4 else k, n) > 1
    kern, plain = _k45(bits)
    x, w, cb = _gemm_operands(gen, m, k, n, c, bits)
    torch.testing.assert_close(kern(x, w, cb), plain(x, w, cb), rtol=1e-5,
                               atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("bits", [8, 4])
def test_quant_gemv_on_two_streams_on_card(gen, bits):
    """Split-K decode GEMVs queued on two streams at once, each stream
    with its own ticket counters: every result equals the plain
    version's, and so does a later call on the default stream."""
    kern, plain = _k45(bits)
    operands = [_gemm_operands(gen, 2, 3072, 3072, 16, bits)
                for _ in range(2)]
    want = [plain(*o) for o in operands]
    streams = [torch.cuda.Stream() for _ in operands]
    torch.cuda.synchronize()
    got = [[], []]
    for _ in range(20):
        for s, o, out in zip(streams, operands, got):
            with torch.cuda.stream(s):
                out.append(kern(*o))
    torch.cuda.synchronize()
    for outs, w in zip(got, want):
        for y in outs:
            torch.testing.assert_close(y, w, rtol=1e-5, atol=1e-4)
    torch.testing.assert_close(kern(*operands[0]), want[0], rtol=1e-5,
                               atol=1e-4)


@pytest.mark.cuda
def test_kernel_reruns_are_bit_identical(gen):
    """No float atomics in K4/K5/K6: a rerun gives the same bits, at a
    small shape, at a split-K decode shape and at the tensor-core prefill
    shape."""
    x = torch.randn((1024, 512), device="cuda", generator=gen)
    idx = torch.randint(0, 16, (512, 300), device="cuda", generator=gen,
                        dtype=torch.uint8)
    cb = torch.randn(16, device="cuda", generator=gen)
    packed = qops.pack4(idx)
    assert torch.equal(k45.quant_matmul(x, idx, cb),
                       k45.quant_matmul(x, idx, cb))
    assert torch.equal(k45.quant_matmul_packed(x, packed, cb),
                       k45.quant_matmul_packed(x, packed, cb))
    for m in (2, 1024):
        for bits, n, c in ((8, 3072, 64), (4, 8192, 16)):
            kern, _ = _k45(bits)
            xx, w, cbb = _gemm_operands(gen, m, 3072, n, c, bits)
            assert torch.equal(kern(xx, w, cbb), kern(xx, w, cbb))
    q = torch.randn((1, 2, 2, 100, 64), device="cuda", generator=gen)
    kv = torch.randn((1, 2, 100, 64), device="cuda", generator=gen)
    assert torch.equal(k6.flash_attention(q, kv, kv),
                       k6.flash_attention(q, kv, kv))


@pytest.mark.cuda
@pytest.mark.parametrize("i,p", [(3, 100_003), (2, 4096), (1, 5), (1, 1)])
def test_mask_kernels_match_plain_on_card(gen, i, p):
    """K3 (strict and not) and K9, on aligned rows, rows that start off a
    16-byte boundary (P not a multiple of 4) and a misaligned view."""
    w = torch.randn((i, p), device="cuda", generator=gen)
    w[:, ::7] = 0.5 * torch.sign(w[:, ::7])             # magnitude ties
    t = w.abs().amax(-1) * 0.3
    t[0] = 0.5                                          # exactly the ties
    for strict in (True, False):
        assert torch.equal(k2.mask_apply_batched(w, t, strict),
                           k2.mask_apply_batched_plain(w, t, strict))
    shifted = torch.randn(i * p + 1, device="cuda", generator=gen)[1:]
    shifted = shifted.view(i, p)                        # 4 bytes off
    assert torch.equal(k2.mask_apply_batched(shifted, t, False),
                       k2.mask_apply_batched_plain(shifted, t, False))
    n = k2.MASK_SINGLE.launches
    assert torch.equal(k2.mask_apply(w[0], t[0]),
                       k2.mask_apply_plain(w[0], t[0]))
    assert k2.MASK_SINGLE.launches == n + 1


@pytest.mark.cuda
def test_single_vector_solvers_match_cpu_on_card(gen):
    """K8's top-κ (one fused bisection launch with K8's rules, one K9, no
    single count) is bit-identical to the same loop on CPU copies (the
    plain versions); K7's Lloyd loop (one fused launch at I = 1) lands on
    the same assignments."""
    w = torch.randn(50_001, device="cuda", generator=gen)
    w[::11] = 0.25 * torch.sign(w[::11])
    n8, n9, nb = (k2.COUNT_SINGLE.launches, k2.MASK_SINGLE.launches,
                  k2.TOPK.launches)
    got = pops.topk_mask(w, 2_500)
    assert (k2.COUNT_SINGLE.launches - n8, k2.MASK_SINGLE.launches - n9,
            k2.TOPK.launches - nb) == (0, 1, 1)
    assert torch.equal(got.cpu(), pops.topk_mask(w.cpu(), 2_500))
    assert int(torch.count_nonzero(got)) == 2_500
    assert torch.equal(k2.count_above(w, torch.tensor(0.5, device="cuda")),
                       k2.count_above_plain(w, 0.5).cuda())
    cb0 = torch.sort(torch.randn(8, device="cuda", generator=gen)).values
    a, s, c = kops.assign_moments(w, cb0)
    pa, ps, pc = k1.kmeans_assign_moments_plain(w, cb0)
    assert torch.equal(a, pa) and torch.equal(c, pc)
    torch.testing.assert_close(s, ps, rtol=1e-5, atol=1e-3)
    n7, nl = k1.SINGLE.launches, k1.LLOYD.launches
    cb, assign = kops.kmeans(w, cb0, iters=6)
    assert (k1.SINGLE.launches, k1.LLOYD.launches) == (n7, nl + 1)
    cb_cpu, _ = kops.kmeans(w.cpu(), cb0.cpu(), iters=6)
    torch.testing.assert_close(cb.cpu(), cb_cpu, rtol=1e-5, atol=1e-5)
    assert assign.shape == w.shape and assign.dtype == torch.int32


@pytest.mark.cuda
@pytest.mark.parametrize("p", [1, 5, 266_200])
def test_single_vector_mask_kernel_on_card(gen, p):
    """K9 on aligned vectors and a view 4 bytes off a 16-byte boundary,
    with the threshold as a Python float and as a 0-d CUDA tensor: equal
    to its plain version and to ``F.hardshrink``, one launch a call."""
    base = torch.randn(p + 1, device="cuda", generator=gen)
    base[::7] = 0.5 * torch.sign(base[::7])             # magnitude ties
    for w in (base[:p], base[1:]):
        t = torch.tensor(0.5, device="cuda")            # exactly the ties
        for tt in (t, 0.5, w.abs().median()):
            n = k2.MASK_SINGLE.launches
            got = k2.mask_apply(w, tt)
            assert k2.MASK_SINGLE.launches == n + 1
            assert torch.equal(got, k2.mask_apply_plain(w, tt))
            assert torch.equal(got, F.hardshrink(w, float(tt)))


def _iterated_lloyd(w, cb, iters):
    """The loop of single K1 passes with the update done by torch."""
    for _ in range(iters):
        _, sums, counts = k1.kmeans_assign_moments_batched(w, cb)
        cb = torch.sort(torch.where(counts > 0, sums / counts.clamp_min(1),
                                    cb), dim=-1).values
    return cb, k1.kmeans_assign_moments_batched(w, cb)[0]


def _iterated_bisection(w, kappa, iters, strict):
    """The loop of single K2 counts with the update done by torch."""
    a_max = w.abs().amax(dim=-1)
    hi = a_max if strict else a_max * 2.0 + 1.0
    lo = torch.zeros_like(hi)
    for _ in range(iters):
        mid = 0.5 * (lo + hi)
        n = k2.count_above_batched(w, mid, strict)
        move = n > kappa if strict else n >= kappa
        lo, hi = torch.where(move, mid, lo), torch.where(move, hi, mid)
    return lo, hi, k2.count_above_batched(w, hi, strict)


def _rows(gen, i, p, offset=False):
    """(I, P) weights with tied magnitudes; ``offset``: a view 4 bytes off
    a 16-byte boundary (the element loads)."""
    w = torch.randn(i * p + 1, device="cuda", generator=gen)
    w = w[1:] if offset else w[:-1]
    w = w.view(i, p)
    w[:, ::7] = 0.5 * torch.sign(w[:, ::7])
    return w


# (case, I, P, K, kvalid, iters); I None: past the loop's grid for K,
# taken from the wrapper's grid so it stays past it on any card
_LLOYD_CASES = [
    ("slices, ragged", 3, 10_001, 16, None, 6),
    ("slices, mixed K", 3, 40_000, 16, [16, 5, 9], 8),
    ("slices, resident", 2, 4096, 4, None, 20),
    ("slices, K 64, mixed K", 2, 30_000, 64, [64, 33], 4),
    ("slices, K 200", 1, 5_000, 200, None, 2),
    ("single block, resident, K 256", 1, 1_000, 256, None, 3),
    ("single block, ragged", 1, 77, 2, None, 3),
    ("single block, resident", 1, 2048, 4, None, 5),
    ("one block an item", 300, 1_000, 4, None, 3),
    ("past the grid", None, 1_000, 4, None, 3),
    ("past the grid, mixed K", None, 1_000, 16, "mixed", 3),
    ("past the grid, K 64, ragged", None, 701, 64, None, 2),
    ("offset row", 2, 8_192, 16, None, 4),
]


@pytest.mark.cuda
@pytest.mark.parametrize("case,i,p,k,kvalid,iters", _LLOYD_CASES,
                         ids=[c[0] for c in _LLOYD_CASES])
def test_lloyd_kernel_branches(gen, case, i, p, k, kvalid, iters):
    """Each branch of the Lloyd kernel: the single pass against its plain
    version (assignments and counts equal, sums within rtol 1e-5 / atol
    1e-3), and the fused loop, one launch, against the loop of single
    passes plus the torch update bit for bit, against the plain loop
    (codebooks within KMEANS_CB_ATOL = 1e-3, the assignment the plain
    pass over its codebooks), +inf tails kept, a rerun the same bits;
    and the library's report of a resident slice where the case fixes
    it (the design floor that chip_smoke.py prints reads it)."""
    grid = k1._grid(0, k)
    if i is None:
        i = grid + 37
    bpi = k1._blocks_per_item(i, p, grid)
    if case.startswith("past the grid"):
        assert i > grid and bpi == 1
    elif case.startswith("one block an item"):
        assert 1 < i <= grid and bpi == 1
    elif case.startswith("single block"):
        assert i == bpi == 1
    else:
        assert i * bpi <= grid and bpi > 1
    if kvalid == "mixed":
        kvalid = [1 + r % k for r in range(i)]
    w = _rows(gen, i, p, offset=case == "offset row")
    if "resident" in case:
        assert k1._slice_resident(w, k)
    if case.startswith("past the grid") or case.endswith(("ragged", "row")):
        assert not k1._slice_resident(w, k)
    cb = torch.sort(torch.randn((i, k), device="cuda", generator=gen),
                    -1).values
    if kvalid is not None:
        live = torch.arange(k, device="cuda")[None] < torch.tensor(
            kvalid, device="cuda")[:, None]
        cb = torch.sort(torch.where(live, cb, torch.inf), -1).values
    a, s, c = k1.kmeans_assign_moments_batched(w, cb)
    pa, ps, pc = k1.kmeans_assign_moments_batched_plain(w, cb)
    assert torch.equal(a, pa) and torch.equal(c, pc)
    torch.testing.assert_close(s, ps, rtol=1e-5, atol=1e-3)
    n = k1.LLOYD.launches
    got = k1.kmeans_lloyd_batched(w, cb, iters)
    assert k1.LLOYD.launches == n + 1
    want = _iterated_lloyd(w, cb, iters)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    plain = k1.kmeans_lloyd_batched_plain(w, cb, iters)
    torch.testing.assert_close(got[0], plain[0], rtol=0, atol=1e-3)
    assert torch.equal(got[1],
                       k1.kmeans_assign_moments_batched_plain(w, got[0])[0])
    if kvalid is not None:
        for r, kv in enumerate(kvalid):
            assert bool(torch.isinf(got[0][r, kv:]).all())
    again = k1.kmeans_lloyd_batched(w, cb, iters)
    assert torch.equal(got[0], again[0]) and torch.equal(got[1], again[1])


@pytest.mark.cuda
@pytest.mark.parametrize("i,p,k", [(3, 10_001, 16), (2, 50_000, 64),
                                   (700, 1_000, 4)])
def test_lloyd_kernel_unsorted_codebook(gen, i, p, k):
    """A codebook in no order takes the full scan: the single pass equals
    its plain version, and the fused loop from it (whose first step
    scans, the later ones search) equals the iterated loop."""
    w = _rows(gen, i, p)
    cb = torch.randn((i, k), device="cuda", generator=gen)
    assert not bool((cb[:, 1:] >= cb[:, :-1]).all())
    a, s, c = k1.kmeans_assign_moments_batched(w, cb)
    pa, ps, pc = k1.kmeans_assign_moments_batched_plain(w, cb)
    assert torch.equal(a, pa) and torch.equal(c, pc)
    torch.testing.assert_close(s, ps, rtol=1e-5, atol=1e-3)
    got = k1.kmeans_lloyd_batched(w, cb, 3)
    want = _iterated_lloyd(w, cb, 3)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.cuda
@pytest.mark.parametrize("gap", [None, 1e-6, 0.0])
def test_lloyd_table_path_is_exact(gen, gap):
    """Slices long enough for the kernel's lookup table (one item of 20M
    weights): assignments equal to the plain pass over the same codebook
    (single pass) and over the loop's codebooks, also with two entries
    1e-6 apart (bins that hold two boundaries) and a duplicate entry (no
    table), and the loop bit-identical to the iterated single passes."""
    w = torch.randn((1, 20_000_000), device="cuda", generator=gen)
    w[0, ::1000] = torch.randn(20_000, device="cuda", generator=gen) * 50
    cb = torch.sort(torch.randn((1, 16), device="cuda", generator=gen),
                    -1).values
    if gap is not None:
        cb[0, 8] = cb[0, 7] + gap
    a, _, c = k1.kmeans_assign_moments_batched(w, cb)
    pa, _, pc = k1.kmeans_assign_moments_batched_plain(w, cb)
    assert torch.equal(a, pa) and torch.equal(c, pc)
    got = k1.kmeans_lloyd_batched(w, cb, 3)
    assert torch.equal(got[1],
                       k1.kmeans_assign_moments_batched_plain(w, got[0])[0])
    want = _iterated_lloyd(w, cb, 3)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.cuda
def test_fused_lloyd_rounds_counts_to_nearest(gen):
    """A cluster of 2^24 + 3 weights on the card: the in-kernel update
    divides by the count rounded to nearest f32, as torch does."""
    w = torch.ones((1, 2**24 + 8), device="cuda")
    w[0, :5] = 7.0                       # equidistant: the first, 5.0
    cb = torch.tensor([[1.0, 5.0, 9.0]], device="cuda")
    got = k1.kmeans_lloyd_batched(w, cb, 2)
    assert torch.equal(got[0], _iterated_lloyd(w, cb, 2)[0])
    _, _, counts = k1.kmeans_assign_moments_batched(w, cb)
    assert counts.tolist() == [[2**24 + 3, 5, 0]]


# (case, I, P, κ, iters); I None: past the grid, from the wrapper's grid;
# κ None: drawn per item
_TOPK_CASES = [
    ("tracked, ragged", 3, 10_001, [1, 500, 10_001], 30),
    ("tracked, compacts", 4, 2_000_000, [100_000, 100_000, 7, 1_999_999],
     30),
    ("single block", 1, 5, [2], 30),
    ("LeNet300", 1, 266_200, [13_310], 30),
    ("own item", 20, 3_000, None, 30),
    ("past the grid", None, 3_000, None, 30),
    ("offset row", 2, 8_192, [100, 4_000], 30),
    ("no compaction", 3, 50_000, [10, 100, 1_000], 2),
]


@pytest.mark.cuda
@pytest.mark.parametrize("strict", [False, True])
@pytest.mark.parametrize("case,i,p,kappa,iters", _TOPK_CASES,
                         ids=[c[0] for c in _TOPK_CASES])
def test_bisection_kernel_branches(gen, case, i, p, kappa, iters, strict):
    """Each branch of the count kernel, with the batched and the
    single-vector (strict) rules on tied magnitudes: the single count
    against its plain version (at the ties' magnitude too); the fused
    bisection, one launch, against the loop of single counts plus the
    torch update and against its plain version, bit for bit; the masks
    of the batched solver against the exact top-κ."""
    grid = k2._grid(0)
    if i is None:
        i = grid + 37
    bpi = k2._blocks_per_item(i, p, grid)
    assert (i > grid) == case.startswith("past the grid")
    w = _rows(gen, i, p, offset=case == "offset row")
    kap = (torch.randint(1, p + 1, (i,), device="cuda", generator=gen,
                         dtype=torch.int32) if kappa is None else
           torch.tensor(kappa, dtype=torch.int32, device="cuda"))
    for t in (w.abs().amax(-1) * 0.3, torch.full((i,), 0.5, device="cuda")):
        assert torch.equal(k2.count_above_batched(w, t, strict),
                           k2.count_above_batched_plain(w, t, strict))
    n = k2.TOPK.launches
    lo, hi, n_hi, stats = k2.topk_threshold_batched(w, kap, iters, strict,
                                                    with_stats=True)
    assert k2.TOPK.launches == n + 1
    for got, want in zip((lo, hi, n_hi),
                         _iterated_bisection(w, kap, iters, strict)):
        assert torch.equal(got, want)
    for got, want in zip((lo, hi, n_hi), k2.topk_threshold_batched_plain(
            w, kap, iters, strict)):
        assert torch.equal(got, want)
    if case == "tracked, compacts":
        assert bool((stats[:, 0] > 0).all()) and bool(
            (stats[:, 3] >= 0).all()), stats
    if case == "no compaction":
        assert stats[:, 0].tolist() == [0] * i, stats
    if case == "single block":
        assert bpi == 1
    if not strict:
        theta = pops.topk_mask_batched(w, kap, iters=iters, impl="kernel")
        if iters == 30:
            assert torch.equal(theta, pops.topk_mask_batched(w, kap))
        assert torch.equal(torch.count_nonzero(theta, dim=1),
                           kap.long().clamp(max=p))


@pytest.mark.cuda
def test_fused_entries_refuse_what_they_do_not_take(gen):
    """A CUDA tensor that the fused entries do not take raises; nothing
    falls back to the plain loop."""
    w = torch.randn((2, 100), device="cuda", generator=gen)
    cb = torch.sort(torch.randn((2, 4), device="cuda", generator=gen),
                    -1).values
    kap = torch.tensor([5, 6], dtype=torch.int32, device="cuda")
    n = (k1.LLOYD.launches, k2.TOPK.launches)
    for call in (lambda: k1.kmeans_lloyd_batched(w.double(), cb, 3),
                 lambda: k1.kmeans_lloyd_batched(w, cb[:1], 3),
                 lambda: k1.kmeans_lloyd_batched(w[:, ::2], cb, 3),
                 lambda: k1.kmeans_lloyd_batched(
                     w, torch.zeros((2, 257), device="cuda"), 3),
                 lambda: k1.kmeans_lloyd_batched(w, cb, -1),
                 lambda: k2.topk_threshold_batched(w, kap.long()),
                 lambda: k2.topk_threshold_batched(w, kap[:1]),
                 lambda: k2.topk_threshold_batched(w.t(), kap),
                 lambda: k2.topk_threshold_batched(w, kap.cpu())):
        with pytest.raises((TypeError, ValueError)):
            call()
    assert (k1.LLOYD.launches, k2.TOPK.launches) == n


@pytest.mark.cuda
def test_c_step_kernels_on_two_streams_on_card(gen):
    """K1's and K2's single passes and fused loops queued on two streams
    at once, each stream with its own workspace, tickets and compaction
    counters: every result equals the one made alone on the default
    stream."""
    ops = []
    for _ in range(2):
        w = _rows(gen, 3, 40_000)
        cb = torch.sort(torch.randn((3, 16), device="cuda", generator=gen),
                        -1).values
        kap = torch.tensor([100, 2_000, 39_000], dtype=torch.int32,
                           device="cuda")
        ops.append((w, cb, kap, w.abs().amax(-1) * 0.3))

    def run(w, cb, kap, t):
        return (*k1.kmeans_assign_moments_batched(w, cb),
                *k1.kmeans_lloyd_batched(w, cb, 5),
                k2.count_above_batched(w, t, False),
                *k2.topk_threshold_batched(w, kap, 30))

    want = [run(*o) for o in ops]
    streams = [torch.cuda.Stream() for _ in ops]
    torch.cuda.synchronize()
    got = [[], []]
    for _ in range(10):
        for s, o, out in zip(streams, ops, got):
            with torch.cuda.stream(s):
                out.append(run(*o))
    torch.cuda.synchronize()
    for outs, ref in zip(got, want):
        for res in outs:
            assert all(torch.equal(a, b) for a, b in zip(res, ref))


# ----------------------------------------------------------------------
# the trainer on the card
# ----------------------------------------------------------------------
def _train_cfg():
    from repro_torch.configs import get_config, reduced_config
    return reduced_config(get_config("phi3-mini-3.8b")).with_(
        dtype="float32", pattern_reps=2)


@pytest.mark.cuda
def test_train_step_on_card_matches_cpu(gen):
    """One LC train step (loss + penalty, clip, AdamW) on the card against
    the same step on the CPU, leaf by leaf: metrics rtol 1e-4, params
    rtol 1e-5 / atol 1e-5 (as tests/test_torch_train_step.py holds the
    step), AdamW's moments m and v rtol 1e-4 / atol 1e-4 of each leaf's
    largest magnitude (the moments scale with the clipped gradient)."""
    from repro_torch import interop
    from repro_torch.core.tasks import flatten_params
    from repro_torch.data import TokenStream
    from repro_torch.launch import steps
    cfg = _train_cfg()
    state = steps.init_train_state(torch.Generator().manual_seed(0), cfg)
    state["lc"]["mu"] = torch.tensor(0.5)
    for p, a in state["lc"]["a"].items():
        state["lc"]["lam"][p] = 0.01 * torch.randn_like(a)
    batch = TokenStream(cfg.vocab_size, 2, 16).batch_at(0)
    step = steps.make_train_step(cfg, lr=1e-3, clip_norm=0.05)
    want, wm = step(state, batch)
    on_card = interop.train_state_from_numpy(interop.to_numpy(state), "cuda")
    got, gm = step(on_card, {k: v.cuda() for k, v in batch.items()})
    for k in ("loss", "ce", "lc_penalty", "grad_norm"):
        torch.testing.assert_close(gm[k].cpu(), wm[k], rtol=1e-4, atol=0)

    def leaves(tree):
        return {k: torch.from_numpy(v)
                for k, v in flatten_params(interop.to_numpy(tree)).items()}

    for part, rtol in (("params", 1e-5), ("m", 1e-4), ("v", 1e-4)):
        ours, theirs = (leaves(s[part] if part == "params" else s["opt"][part])
                        for s in (got, want))
        assert set(ours) == set(theirs) and len(ours) > 3
        for k, b in theirs.items():
            atol = 1e-5 if part == "params" else 1e-4 * float(b.abs().max())
            torch.testing.assert_close(ours[k], b, rtol=rtol, atol=atol,
                                       msg=lambda m: f"{part} {k}: {m}")
    assert int(got["step"]) == 1 and int(got["opt"]["step"]) == 1


@pytest.mark.cuda
def test_side_stream_c_step_equals_serial_on_card(gen):
    """The overlapped trainer's C and multiplier steps, queued on a second
    stream behind the main stream's work, give the serial steps' Θ, a
    and λ bit for bit; an overlapped run on the card keeps its monitors
    clean."""
    from repro_torch.core import AsStacked, CompressionTask, LCAlgorithm
    from repro_torch.core.schemes import (AdaptiveQuantization,
                                          ConstraintL0Pruning)
    from repro_torch.data import TokenStream
    from repro_torch.runtime import LCTrainer, TrainerConfig
    from repro_torch.tree import tree_leaves
    params = {"f": {"w_gate": torch.randn((4, 64, 300), device="cuda",
                                          generator=gen),
                    "w_down": torch.randn((4, 300, 64), device="cuda",
                                          generator=gen)}}
    tasks = [CompressionTask("q", "w_gate$", AsStacked("vector"),
                             AdaptiveQuantization(k=16, iters=10)),
             CompressionTask("p", "w_down$", AsStacked("vector"),
                             ConstraintL0Pruning(kappa=960))]
    lc = LCAlgorithm(tasks, [1e-3], device="cuda")
    st = lc.set_mu(lc.init(params), 1e-3, 0)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        got = lc.multiplier_step_async(params, lc.c_step_async(params, st))
    torch.cuda.synchronize()
    want = lc.multiplier_step(params, lc.c_step(params, st))
    for a, b in zip(tree_leaves(got), tree_leaves(want)):
        assert torch.equal(a, b)

    cfg = _train_cfg()
    tlc = LCAlgorithm([CompressionTask("q", r"stages/.*/w_(gate|up)$",
                                       AsStacked("vector"),
                                       AdaptiveQuantization(k=4, iters=5))],
                      [1e-3, 2e-3, 4e-3], device="cuda")
    trainer = LCTrainer(cfg, tlc, TokenStream(cfg.vocab_size, 2, 16),
                        tcfg=TrainerConfig(steps_per_l=3, overlap="on"),
                        device="cuda")
    state, _ = trainer.run(0)
    assert [h["lc_step"] for h in trainer.history] == [0, 1, 2]
    assert all(h["c_step_violations"] == [] for h in trainer.history)
    assert int(state["step"]) == 9


def _planner_group(family, gen):
    """A 2-task group of 3 items each on the card, its inputs and Θ."""
    from repro_torch.core import AsStacked, CompressionTask
    from repro_torch.core import schemes as ts
    make, shape = {
        "quant": (lambda: ts.AdaptiveQuantization(k=16, iters=10),
                  (3, 300_007)),
        "l0": (lambda: ts.ConstraintL0Pruning(kappa=5_000), (3, 300_007)),
        "lowrank": (lambda: ts.LowRank(24), (3, 384, 256)),
        "rank-selection": (lambda: ts.RankSelection(alpha=1e-4,
                                                    max_rank=32),
                           (3, 256, 192)),
    }[family]
    domain = "matrix" if len(shape) == 3 else "vector"
    group = [CompressionTask(f"{family}{i}", ".", AsStacked(domain), make())
             for i in range(2)]
    xs = {t.name: torch.randn(shape, device="cuda", generator=gen)
          for t in group}
    thetas = {t.name: t.scheme_init(xs[t.name]) for t in group}
    return group, xs, thetas


@pytest.mark.cuda
@pytest.mark.parametrize("family", ["quant", "l0", "lowrank",
                                    "rank-selection"])
def test_chunked_group_equals_one_launch_on_card(gen, family):
    """The planner's chunks (one item a launch; 4 launches across the
    tasks' boundary) equal the one launch bit for bit on the card: the
    K1 loop takes its group's partition and K2's counts are exact. The
    low-rank solvers' batched ``torch.bmm`` gives bits that depend on
    the batch on the card (cuBLAS picks its kernel by the batch): their
    groups stay in one launch, and the plan says why."""
    from repro_torch.analysis import cost
    from repro_torch.core.grouping import (
        _plan_multi_group, _task_solver, grouped_compress)
    from repro_torch.tree import tree_leaves
    group, xs, thetas = _planner_group(family, gen)
    mu = torch.tensor(1e-3, device="cuda")
    one = grouped_compress(group, xs, thetas, mu, backend="auto",
                           device="cuda")
    solver_fn, _ = _task_solver(group[0].scheme, "auto", "cuda")
    ws = _plan_multi_group(group, xs, thetas, [3, 3], solver_fn, "auto",
                           "cuda").working_set_bytes
    try:
        for budget, n_chunks in ((1, 6), (ws // 4 + 1, 4)):
            cost.CHUNK_BUDGET_BYTES = budget
            cost.clear_caches()
            plan = _plan_multi_group(group, xs, thetas, [3, 3], solver_fn,
                                     "auto", "cuda")
            if family in ("quant", "l0"):
                assert plan.n_chunks == n_chunks
            else:
                assert plan.n_chunks == 1 and any(
                    f.startswith("chunking-disabled:")
                    for f in plan.fallbacks)
            before = k1.LLOYD.launches
            chunked = grouped_compress(group, xs, thetas, mu,
                                       backend="auto", device="cuda",
                                       planner="on")
            if family == "quant":
                assert k1.LLOYD.launches - before == n_chunks
            for t in group:
                for a, b in zip(tree_leaves(one[t.name]),
                                tree_leaves(chunked[t.name])):
                    assert torch.equal(a, b), (family, n_chunks, t.name)
    finally:
        cost.CHUNK_BUDGET_BYTES = None
        cost.clear_caches()


@pytest.mark.cuda
@pytest.mark.parametrize("family", ["quant", "l0", "lowrank",
                                    "rank-selection"])
def test_compile_group_captured_equals_eager_on_card(gen, family):
    """``compile_group`` captures the group's solve as a CUDA graph (the
    K1 and K2 loops' cooperative launches, the Jacobi rounds, the held
    sketches); its replays at two μ equal the eager ``grouped_compress``
    bit for bit, and count their launches."""
    from repro_torch.analysis import cost
    from repro_torch.core.grouping import compile_group, grouped_compress
    from repro_torch.core.schemes.base import slice_theta_like
    from repro_torch.tree import tree_leaves, tree_map
    group, xs, thetas = _planner_group(family, gen)
    cost.clear_caches()
    exe, arrays = compile_group(group, xs, thetas, backend="auto",
                                device="cuda")
    assert exe.programs.graphs
    mus = [torch.tensor(m, device="cuda") for m in (1e-3, 3e-2, 1e-3)]
    for i, mu in enumerate(mus):
        counted = (k1.LLOYD.launches, k2.TOPK.launches)
        theta, a = exe(mu, *arrays)
        torch.cuda.synchronize()
        if family in ("quant", "l0"):
            got = (k1.LLOYD.launches - counted[0],
                   k2.TOPK.launches - counted[1])
            assert got == ((1, 0) if family == "quant" else (0, 1)), got
        want = grouped_compress(group, xs, thetas, mu, backend="auto",
                                device="cuda")
        for j, t in enumerate(group):
            th = slice_theta_like(
                tree_map(lambda x, j=j: x[3 * j:3 * j + 3], theta),
                want[t.name][0])
            for x, y in zip(tree_leaves(th), tree_leaves(want[t.name][0])):
                assert torch.equal(x, y), (family, i, t.name)
            assert torch.equal(a[3 * j:3 * j + 3], want[t.name][1])
    assert exe.programs.captured == 1
    assert compile_group(group, xs, thetas, backend="auto",
                         device="cuda")[0] is exe
    assert cost.cache_stats()["exec_misses"] == 1
    cost.clear_caches()


@pytest.mark.cuda
def test_flash_attention_refused_under_autograd_on_card(gen):
    """K6 has no backward: through autograd it raises on the card too."""
    from repro_torch.models.attention import blockwise_attention
    q = torch.randn((1, 64, 2, 16), device="cuda", generator=gen,
                    requires_grad=True)
    k = torch.randn((1, 64, 2, 16), device="cuda", generator=gen)
    pos = torch.arange(64, device="cuda")
    with pytest.raises(NotImplementedError, match="fused_attention=False"):
        blockwise_attention(q, k, k, pos, pos, fused=True)
    with torch.no_grad():
        out = blockwise_attention(q, k, k, pos, pos, fused=True)
    assert out.shape == q.shape and out.grad_fn is None


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["mixtral-8x7b", "deepseek-moe-16b",
                                  "minicpm3-4b", "jamba-v0.1-52b",
                                  "xlstm-125m"])
def test_moe_and_mla_models_on_card_match_cpu(gen, arch):
    """The reduced MoE, MLA, Mamba and xLSTM models on the card against
    the CPU on the same weights: routing indices equal (``torch.topk`` on
    CUDA against the CPU's, which the CPU tests hold to
    ``jax.lax.top_k``), hidden states and the aux loss rtol 1e-5 / atol
    2e-5, and 6 greedy tokens equal (plain attention: the reduced head
    dims are not K6's). xlstm's hidden states are held normwise (atol
    2e-5 · max|h|): its 12 blocks of gate exponentials carry the two
    devices' summation-order gaps to 6.5e-5 at max|h| = 3.66 on an H100
    (93 of 2048 entries above 2e-5 + 1e-5·|h|), as
    ``tests/test_torch_ssm.py`` holds its states against the JAX
    package."""
    from repro_torch.configs import get_config, reduced_config
    from repro_torch.interop import params_from_numpy, to_numpy
    from repro_torch.models import moe
    from repro_torch.models.transformer import forward_hidden, init_params
    from repro_torch.runtime.server import Server
    cfg = reduced_config(get_config(arch)).with_(dtype="float32")
    cpu = init_params(torch.Generator().manual_seed(0), cfg)
    card = params_from_numpy(to_numpy(cpu), "cuda")
    toks = torch.randint(0, cfg.vocab_size, (2, 16),
                         generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        h_cpu, aux_cpu = forward_hidden(cpu, toks, cfg)
        h_card, aux_card = forward_hidden(card, toks.cuda(), cfg)
    scale = float(h_cpu.abs().max()) if cfg.xlstm is not None else 1.0
    torch.testing.assert_close(h_card.cpu(), h_cpu, rtol=1e-5,
                               atol=2e-5 * max(1.0, scale))
    torch.testing.assert_close(aux_card.cpu(), aux_cpu, rtol=1e-5,
                               atol=1e-7)
    if cfg.moe is not None:
        x = torch.randn((64, cfg.d_model), generator=torch.Generator()
                        .manual_seed(2))
        from repro_torch.core import flatten_params
        router = next(v for p, v in flatten_params(cpu).items()
                      if p.endswith("ffn/router"))
        if router.ndim == 3:
            router = router[0]
        _, _, idx_cpu = moe.route(x, router, cfg)
        _, _, idx_card = moe.route(x.cuda(), router.cuda(), cfg)
        assert torch.equal(idx_card.cpu(), idx_cpu)
    want = Server(cfg, cpu, max_len=32, device="cpu").generate(toks, 6)
    got = Server(cfg, card, max_len=32, device="cuda").generate(toks, 6)
    assert (got.tokens == want.tokens).all()


# ----------------------------------------------------------------------
# serving through CUDA graphs, held to the eager programs
# ----------------------------------------------------------------------
SERVED = ["phi3-mini-3.8b", "mixtral-8x7b", "deepseek-moe-16b",
          "minicpm3-4b", "jamba-v0.1-52b", "xlstm-125m"]


def _served(arch):
    """A reduced model on the card, unrolled, every 2-D matrix it
    applies as a product in 4-bit form (K4), fused attention (K6) where
    its head dims are the kernel's."""
    from repro_torch.configs import get_config, reduced_config
    from repro_torch.launch.serve import compress_for_form
    from repro_torch.models.transformer import init_params
    cfg = reduced_config(get_config(arch)).with_(dtype="float32")
    cfg = cfg.with_(pattern=cfg.pattern * cfg.pattern_reps, pattern_reps=1)
    dims = ((cfg.mla.qk_nope_dim + cfg.mla.qk_rope_dim, cfg.mla.v_head_dim)
            if cfg.mla is not None else (cfg.head_dim, cfg.head_dim))
    cfg = cfg.with_(fused_attention=dims in k6.HEAD_DIM_PAIRS)
    params = init_params(torch.Generator(device="cuda").manual_seed(0), cfg)
    return cfg, compress_for_form(cfg, params, "quant4", "cuda")


def _counted(run):
    """(run's result, the launches of every kernel it made)."""
    kernels = (k45.KERNEL_PACKED4, k45.KERNEL_U8, k6.KERNEL)
    before = [k.launches for k in kernels]
    out = run()
    torch.cuda.synchronize()
    return out, [k.launches - b for k, b in zip(kernels, before)]


def _engine_run(cfg, params, graphs, temperature, seed=0):
    """A short mixed-length trace on a 3-slot engine; every slot admitted
    a second time holds ``init_cache``'s values right after its reset.
    Returns ({id: tokens}, trace_counts, slots checked)."""
    import numpy as np
    from repro_torch.core import flatten_params
    from repro_torch.models.transformer import cache_axes, init_cache
    from repro_torch.runtime import server as srv
    rng = np.random.default_rng(seed)
    reqs = [srv.Request(i, rng.integers(1, cfg.vocab_size, size=int(n))
                        .astype(np.int32), int(m), 0.0)
            for i, (n, m) in enumerate(rng.integers(2, 12, size=(7, 2)))]
    eng = srv.ServingEngine(cfg, params, slots=3, max_len=32,
                            prefill_chunk=4, temperature=temperature,
                            seed=seed, device="cuda", graphs=graphs)
    fresh = flatten_params(init_cache(cfg, 3, 32, device="cuda"))
    axes = flatten_params(cache_axes(cfg))
    admitted, checked = [0, 0, 0], []
    reset = eng._reset

    def watched(cache, mask):
        out = reset(cache, mask)
        for slot in torch.nonzero(mask).flatten().tolist():
            admitted[slot] += 1
            if admitted[slot] > 1:
                for k, v in flatten_params(out).items():
                    ax = axes[k].index("batch")
                    assert torch.equal(v.select(ax, slot),
                                       fresh[k].select(ax, slot)), k
                checked.append(slot)
        return out

    eng._reset = watched
    out = eng.run(reqs)
    assert len(out["finished"]) == len(reqs)
    return ({f.id: f.tokens.tolist() for f in out["finished"]},
            dict(eng.trace_counts), len(checked))


@pytest.mark.cuda
@pytest.mark.parametrize("arch", SERVED)
def test_graphs_match_the_eager_programs_on_card(gen, arch):
    """``Server.generate`` and a ``ServingEngine`` trace through CUDA
    graphs against the same programs run eagerly on the card: greedy
    tokens equal, and at temperature 0.8 with the same seed; the kernels'
    launch counts equal; the engine's programs one graph each after the
    first tick; re-admitted slots equal to ``init_cache``; a second
    ``generate`` at the same shape replays its prefill and captures
    nothing new."""
    import numpy as np
    from repro_torch.runtime.server import Server
    cfg, params = _served(arch)
    prompts = np.random.default_rng(1).integers(
        1, cfg.vocab_size, (2, 16)).astype(np.int32)
    servers = {g: Server(cfg, params, max_len=32, device="cuda", graphs=g)
               for g in (False, True)}
    for temperature in (0.0, 0.8):
        got = {g: _counted(lambda s=s: s.generate(
                   prompts, 8, temperature,
                   torch.Generator(device="cuda").manual_seed(5)))
               for g, s in servers.items()}
        assert (got[True][0].tokens == got[False][0].tokens).all()
        assert got[True][1] == got[False][1]
        assert sum(got[True][1]) > 0
    graphed = servers[True]
    captured = graphed.programs.captured
    again = graphed.generate(prompts, 8, 0.8, torch.Generator(
        device="cuda").manual_seed(5))
    assert graphed.programs.captured == captured
    assert (again.tokens == got[True][0].tokens).all()
    for temperature in (0.0, 0.8):
        runs = {g: _counted(lambda g=g: _engine_run(cfg, params, g,
                                                    temperature))
                for g in (False, True)}
        (eager, eager_n), (graph, graph_n) = runs[False], runs[True]
        assert graph[0] == eager[0] and graph_n == eager_n
        assert graph[1] == {"decode": 1, "prefill": 1, "reset": 1}
        assert graph[2] == eager[2] > 0


@pytest.mark.cuda
@pytest.mark.parametrize("bits", [4, 8])
def test_two_replays_equal_two_eager_calls_on_card(gen, bits):
    """A captured decode GEMV (split K, whose tickets each launch leaves
    zero) replayed twice in a row on two inputs equals two eager calls
    bit for bit, and counts one launch a replay."""
    from repro_torch.graphs import Programs
    m, k, n = 2, 3072, 1024
    assert k45.gemv_slices(k // (2 if bits == 4 else 1), n) > 1
    _, w, cb = _gemm_operands(gen, m, k, n, 16, bits)
    fn = _k45(bits)[0]
    xs = [torch.randn((m, k), device="cuda", generator=gen)
          for _ in range(3)]
    want = [fn(xi, w, cb) for xi in xs[1:]]
    prog = Programs(torch.device("cuda", 0)).program(
        lambda w, x: fn(x, w, cb), held=(0,), name="gemv")
    kern = k45.KERNEL_PACKED4 if bits == 4 else k45.KERNEL_U8
    prog(w, xs[0])
    n0 = kern.launches
    got = [prog(w, xi).clone() for xi in xs[1:]]
    torch.cuda.synchronize()
    assert kern.launches == n0 + 2
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    # the capture stream's tickets, which the graph's launches use (the
    # stream comes from PyTorch's stream pool, so other kernels' buffers,
    # such as a captured C step's, may sit beside them on it)
    from repro_torch.kernels import build
    tickets = build._BUFFERS[("gemv tickets", 0,
                              prog.owner.stream.cuda_stream)]
    assert any(b is tickets for b in prog.owner.stream_buffers())
    assert not tickets.any()


# ----------------------------------------------------------------------
# the compiled LC driver (LCAlgorithm(jit_c_step=True)) on the card
# ----------------------------------------------------------------------
def _all_families():
    """Two tasks of every scheme family (the item-by-item Binarize,
    Ternarize, PenaltyL0Pruning and AdditiveCombination included) and two
    singletons, with their weights: the CPU file
    ``tests/test_torch_lc_compiled.py`` holds the same families to the
    JAX package."""
    from repro_torch.core import AsIs, AsStacked, CompressionTask
    from repro_torch.core import schemes as ts
    families = {
        "quant": (lambda i: ts.AdaptiveQuantization(k=(16, 4)[i],
                                                    iters=10), "vector"),
        "l0": (lambda i: ts.ConstraintL0Pruning(kappa=(2_000, 500)[i]),
               "vector"),
        "l1": (lambda i: ts.ConstraintL1Pruning(kappa=40.0), "vector"),
        "l1-penalty": (lambda i: ts.PenaltyL1Pruning(alpha=2e-4),
                       "vector"),
        "lowrank": (lambda i: ts.LowRank(target_rank=8), "matrix"),
        "rank-selection": (lambda i: ts.RankSelection(alpha=1e-4,
                                                      max_rank=16),
                           "matrix"),
        "binarize": (lambda i: ts.Binarize(), "vector"),
        "ternarize": (lambda i: ts.Ternarize(), "vector"),
        "l0-penalty": (lambda i: ts.PenaltyL0Pruning(alpha=1e-4),
                       "vector"),
        "additive": (lambda i: ts.AdditiveCombination(
            [ts.ConstraintL0Pruning(kappa=1_000),
             ts.AdaptiveQuantization(k=4, iters=5)], iters=2), "vector"),
    }
    g = torch.Generator(device="cuda").manual_seed(3)
    tasks, params = [], {}
    for f, (make, domain) in families.items():
        shape = (3, 128, 96) if domain == "matrix" else (3, 20_000)
        for i in range(2):
            tasks.append(CompressionTask(f"{f}{i}", f"^{f}{i}$",
                                         AsStacked(domain), make(i)))
            params[f"{f}{i}"] = torch.randn(shape, device="cuda",
                                            generator=g)
    tasks.append(CompressionTask("solo-quant", "^solo-quant$",
                                 AsStacked("vector"),
                                 ts.AdaptiveQuantization(k=8, iters=10)))
    params["solo-quant"] = torch.randn((2, 7_000), device="cuda",
                                       generator=g)
    tasks.append(CompressionTask("solo-lowrank", "^solo-lowrank$", AsIs(),
                                 ts.LowRank(target_rank=12)))
    params["solo-lowrank"] = torch.randn((160, 96), device="cuda",
                                         generator=g)
    return tasks, params


@pytest.mark.cuda
@pytest.mark.parametrize("group_tasks", [True, False],
                         ids=["grouped", "per-task"])
def test_compiled_driver_captures_every_family_on_card(gen, group_tasks):
    """Four boundaries of every family's C step, multiplier step and
    distortions through the compiled driver against ``jit_c_step=False``
    bit for bit: the first eager, the second captured, the third and
    fourth (two μ) replayed; one graph a solve and a step, none after the
    second boundary; the same launches."""
    from repro_torch.analysis import cost
    from repro_torch.core import LCAlgorithm
    from repro_torch.tree import tree_leaves
    cost.clear_caches()
    tasks, params = _all_families()
    mus = [1e-3, 2e-3, 4e-3, 8e-3]
    runs = {}
    for jit in (True, False):
        algo = LCAlgorithm(tasks, mus, group_tasks=group_tasks,
                           device="cuda", jit_c_step=jit)
        lc = algo.init(params)
        rec, captured = [], []
        for k, mu in enumerate(mus):
            lc = algo.set_mu(lc, mu, k)
            before = (k1.LLOYD.launches, k2.TOPK.launches)
            pre = algo.shifted_distortion(params, lc)
            lc = algo.c_step(params, lc)
            post = algo.shifted_distortion(params, lc)
            lc = algo.multiplier_step(params, lc)
            dist = algo.distortion(params, lc)
            torch.cuda.synchronize()
            rec.append(([x.clone() for x in tree_leaves(
                (pre, post, dist, lc["tasks"]))],
                (k1.LLOYD.launches - before[0],
                 k2.TOPK.launches - before[1])))
            if jit:
                captured.append(algo.programs.captured)
        runs[jit] = (rec, captured, algo)
    (got, captured, algo), (want, _, _) = runs[True], runs[False]
    for k, ((g, gn), (w, wn)) in enumerate(zip(got, want)):
        assert gn == wn, (k, gn, wn)
        assert len(g) == len(w)
        for x, y in zip(g, w):
            assert torch.equal(x, y), k
    assert captured[0] == 0 and captured[1] > 3
    assert captured[1] == captured[2] == captured[3]
    assert algo.programs.graphs and algo.programs.pool_bytes() > 0
    cost.clear_caches()


@pytest.mark.cuda
def test_compiled_chunked_group_holds_a_chunk_not_the_group(gen):
    """Three C steps of one k-means group that the planner splits into 4
    chunks (a forced budget), compiled against ``jit_c_step=False``: Θ
    and ``a`` bit for bit at every μ, and the compiled C steps' memory
    above the eager ones' (live tensors at their peak, plus the graph
    pool) under two chunks' working sets (items, Θ and Δ(Θ)), where
    graphs of the whole group would hold it several times over."""
    from repro_torch.analysis import cost
    from repro_torch.core import AsVector, CompressionTask, LCAlgorithm
    from repro_torch.core import schemes as ts
    from repro_torch.tree import tree_leaves
    n, p = 4, 1 << 22
    params = {f"e{i}": 0.02 * torch.randn(p, device="cuda", generator=gen)
              for i in range(n)}
    tasks = [CompressionTask(f"e{i}", f"^e{i}$", AsVector(),
                             ts.AdaptiveQuantization(k=16, iters=10))
             for i in range(n)]
    mus = [1e-3, 2e-3, 4e-3]
    cost.CHUNK_BUDGET_BYTES = 1
    cost.clear_caches()
    try:
        runs = {}
        for jit in (False, True):
            algo = LCAlgorithm(tasks, mus, device="cuda", jit_c_step=jit)
            lc = algo.init(params)
            (plan,) = [g["plan"] for g in algo.group_summary(params)]
            assert plan["n_chunks"] == n
            states, over = [], []
            for k, mu in enumerate(mus):
                lc = algo.set_mu(lc, mu, k)
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                base = torch.cuda.memory_allocated()
                lc = algo.c_step(params, lc)
                torch.cuda.synchronize()
                pool = algo.programs.pool_bytes() if jit else 0
                over.append(torch.cuda.max_memory_allocated() - base + pool)
                states.append([x.clone() for x in tree_leaves(lc["tasks"])])
            runs[jit] = (states, over)
            theta = sum(x.numel() * x.element_size() for x in tree_leaves(
                [s["theta"] for s in lc["tasks"].values()]))
            if jit:
                # four chunks of one item: one graph
                assert algo.programs.captured == 1
            del algo, lc
    finally:
        cost.CHUNK_BUDGET_BYTES = None
        cost.clear_caches()
    (want, eager), (got, compiled) = runs[False], runs[True]
    for k, (g, w) in enumerate(zip(got, want)):
        assert len(g) == len(w)
        assert all(torch.equal(x, y) for x, y in zip(g, w)), k
    chunk = (n * p * 4 * 2 + theta) / n
    extra = [c - e for c, e in zip(compiled, eager)]
    print(f"chunked group C steps: eager {eager} B over their start, "
          f"compiled {compiled} (graph pool included), chunk working "
          f"set {chunk:.0f} B")
    assert max(extra) <= 2 * chunk, (extra, chunk)


@pytest.mark.cuda
def test_overlapped_trainer_replays_its_boundary_on_the_side_stream(
        gen, monkeypatch):
    """The overlapped trainer with the compiled driver: every graph
    replay of its boundaries runs on the trainer's side stream, and each
    boundary's C step and multipliers equal an eager driver's on the same
    inputs bit for bit."""
    from repro_torch.configs import get_config, reduced_config
    from repro_torch.core import (AsVector, CompressionTask, LCAlgorithm,
                                  exponential_mu_schedule)
    from repro_torch.core import schemes as ts
    from repro_torch.data import TokenStream
    from repro_torch.runtime import LCTrainer, TrainerConfig
    from repro_torch.tree import tree_leaves
    cfg = reduced_config(get_config("phi3-mini-3.8b")).with_(
        pattern_reps=1, dtype="float32", fused_attention=False)

    def tasks():
        return [CompressionTask("qg", r"stages/.*/w_gate$", AsVector(),
                                ts.AdaptiveQuantization(k=4, iters=5)),
                CompressionTask("pd", r"stages/.*/w_down$", AsVector(),
                                ts.ConstraintL0Pruning(kappa=200))]

    mus = exponential_mu_schedule(1e-4, 1.5, 4)
    lc = LCAlgorithm(tasks(), mus, device="cuda")
    eager = LCAlgorithm(tasks(), mus, device="cuda", jit_c_step=False)
    trainer = LCTrainer(cfg, lc, TokenStream(cfg.vocab_size, 2, 16),
                        tcfg=TrainerConfig(steps_per_l=2, overlap="on",
                                           lr=3e-4), device="cuda")
    streams = []
    replay = torch.cuda.CUDAGraph.replay

    def recorded(self):
        streams.append(torch.cuda.current_stream())
        return replay(self)

    monkeypatch.setattr(torch.cuda.CUDAGraph, "replay", recorded)
    captured = []
    release = lc.release_graphs
    lc.release_graphs = lambda: (captured.append(lc.programs.captured),
                                 release())[1]
    compared = []
    for name in ("c_step_async", "multiplier_step_async"):
        def both(params, lc_in, name=name, fn=getattr(lc, name)):
            eager.resolve(params)
            want = getattr(eager, name)(params, lc_in)
            got = fn(params, lc_in)
            compared.append(all(torch.equal(x, y) for x, y in zip(
                tree_leaves(got["tasks"]), tree_leaves(want["tasks"]))))
            return got
        setattr(lc, name, both)
    trainer.run(0)
    assert len(compared) == 8 and all(compared)
    assert streams and all(s == trainer._side for s in streams)
    # the run captured its graphs, and the trainer let them go at its end
    assert captured and captured[0] > 0 and lc.programs.captured == 0
    assert all(h["c_step_violations"] == [] for h in trainer.history)


@pytest.mark.cuda
def test_sharded_paths_on_card(gen):
    """Path S1 of ``chip_smoke.py`` at reduced width: the compiled LC
    driver over a one-rank NCCL mesh (``make_cstep_mesh``), a K-means
    group of 5 items and an ℓ0 group of 4, 3 C steps (the third on
    replays), against ``mesh=None``: Θ, ``a`` and λ bit for bit at every
    step, and the same launches a C step."""
    import torch.distributed as dist

    from repro_torch.core import (
        AsStacked, CompressionTask, LCAlgorithm, flatten_params)
    from repro_torch.core.schemes import (
        AdaptiveQuantization, ConstraintL0Pruning)
    from repro_torch.launch.mesh import make_cstep_mesh
    from repro_torch.tree import tree_leaves
    if not dist.is_initialized():
        dist.init_process_group("nccl", store=dist.HashStore(), rank=0,
                                world_size=1)
    mesh = make_cstep_mesh()
    shapes = {"qa": (3, 96, 256), "qb": (2, 96, 256), "pa": (2, 256, 96),
              "pb": (2, 256, 96)}
    params = {n: 0.02 * torch.randn(s, device="cuda", generator=gen)
              for n, s in shapes.items()}

    def driver(m):
        return LCAlgorithm(
            [CompressionTask(n, f"^{n}$", AsStacked("vector"),
                             AdaptiveQuantization(k=16, iters=10)
                             if n[0] == "q" else
                             ConstraintL0Pruning(kappa=1000 + 100 * i))
             for i, n in enumerate(shapes)],
            (1e-4, 1.3e-4, 1.69e-4), device="cuda", mesh=m)

    runs = []
    for m in (mesh, None):
        lc, w = driver(m), {n: x.clone() for n, x in params.items()}
        state, per_step = lc.init(w), []
        g = torch.Generator(device="cuda").manual_seed(1)
        for k, mu in enumerate(lc.mu_schedule):
            for x in w.values():
                x.add_(1e-3 * torch.randn(x.shape, device="cuda",
                                          generator=g))
            state = lc.set_mu(state, mu, k)
            before = (k1.LLOYD.launches, k2.TOPK.launches,
                      k2.MASK_KERNEL.launches)
            state = lc.c_step(w, state)
            state = lc.multiplier_step(w, state)
            torch.cuda.synchronize()
            after = (k1.LLOYD.launches, k2.TOPK.launches,
                     k2.MASK_KERNEL.launches)
            per_step.append(([a - b for a, b in zip(after, before)],
                             [x.clone() for x in tree_leaves(
                                 state["tasks"])]))
        groups = lc.group_summary(flatten_params(w))
        runs.append((per_step, groups))
    (sharded, groups), (plain, _) = runs
    assert sorted(g["shard_mode"] for g in groups if g["grouped"]) == [
        "sharded", "sharded"]
    for (n_s, leaves_s), (n_p, leaves_p) in zip(sharded, plain):
        assert n_s == n_p == [1, 1, 1]
        assert all(torch.equal(a, b) for a, b in zip(leaves_s, leaves_p))


@pytest.mark.cuda
def test_tp_server_on_card(gen):
    """Path T1 of ``chip_smoke.py`` at reduced width: ``Server(mesh=)``
    and ``ServingEngine(mesh=)`` over a one-rank NCCL mesh
    (``make_debug_mesh((1, 1))``), through CUDA graphs, against
    ``mesh=None``: the logits of every token and the tokens bit for bit,
    the same K4/K5/K6 launches; graphs=True on a "model" axis above 1
    raises."""
    import numpy as np
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.runtime.server import Server
    if not dist.is_initialized():
        dist.init_process_group("nccl", store=dist.HashStore(), rank=0,
                                world_size=1)
    mesh = make_debug_mesh((1, 1))
    cfg, params = _served("phi3-mini-3.8b")
    prompts = np.random.default_rng(1).integers(
        1, cfg.vocab_size, (2, 16)).astype(np.int32)
    (a, na), (b, nb) = (_counted(lambda m=m: Server(
        cfg, params, max_len=32, device="cuda", mesh=m).generate(
            prompts, 8, return_logits=True)) for m in (mesh, None))
    assert (a.tokens == b.tokens).all() and torch.equal(a.logits, b.logits)
    assert na == nb and sum(na) > 0
    runs = {m: _counted(lambda m=m: _engine_run_mesh(cfg, params, m))
            for m in (mesh, None)}
    assert runs[mesh] == runs[None]

    class _TwoRanks:
        mesh_dim_names, shape = ("data", "model"), (1, 2)
    with pytest.raises(ValueError, match="cannot be captured"):
        Server(cfg, {}, device="cuda", graphs=True, mesh=_TwoRanks())


def _engine_run_mesh(cfg, params, mesh):
    """A short trace on a 3-slot engine over ``mesh``: {id: tokens}."""
    import numpy as np
    from repro_torch.runtime import server as srv
    rng = np.random.default_rng(0)
    reqs = [srv.Request(i, rng.integers(1, cfg.vocab_size, size=int(n))
                        .astype(np.int32), int(m), 0.0)
            for i, (n, m) in enumerate(rng.integers(2, 12, size=(6, 2)))]
    out = srv.ServingEngine(cfg, params, slots=3, max_len=32,
                            prefill_chunk=4, mesh=mesh,
                            device="cuda").run(reqs)
    return {f.id: f.tokens.tolist() for f in out["finished"]}
