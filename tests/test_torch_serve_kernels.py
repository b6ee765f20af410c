"""The port's serving kernels (K4, K5, K6), their ``ops`` wrappers and the
packing helpers against the JAX package.

The JAX side runs its Pallas kernels in interpret mode and its plain
references, as its own tests do; the port's wrappers run each kernel's
plain PyTorch version on CPU tensors (the CUDA kernels are held against
the same plain versions on the card by ``chip_smoke.py`` and
``tests/test_torch_cuda.py``). Inputs come from numpy with a fixed seed.

Tolerances, those of ``tests/test_kernels.py``: the codebook GEMMs rtol
1e-5 / atol 1e-4; flash attention rtol 2e-4 / atol 2e-4; packing,
unpacking, index choice and COO densification bit-identical.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import ops as jfops
from repro.kernels.flash_attention import ref as jfref
from repro.kernels.flash_attention.flash_attention import (
    flash_attention as j_flash)
from repro.kernels.lowrank import serve as jlowrank
from repro.kernels.prune import serve as jprune
from repro.kernels.quant_matmul import ops as jqops
from repro.kernels.quant_matmul import ref as jqref
from repro_torch.kernels.flash_attention import flash_attention as k6
from repro_torch.kernels.flash_attention import ops as fops
from repro_torch.kernels.lowrank import serve as lowrank
from repro_torch.kernels.prune import serve as prune
from repro_torch.kernels.quant_matmul import ops as qops
from repro_torch.kernels.quant_matmul import quant_matmul as k45

GEMM = dict(rtol=1e-5, atol=1e-4)
ATTN = dict(rtol=2e-4, atol=2e-4)


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def _t(x):
    return torch.from_numpy(np.array(x, copy=True))


def _gemm_inputs(seed, m, k, n, c):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((m, k)).astype(np.float32)
    idx = rng.integers(0, c, (k, n)).astype(np.uint8)
    cb = np.sort(rng.standard_normal(c).astype(np.float32))
    return x, idx, cb


# ----------------------------------------------------------------------
# K5: uint8-index GEMM
# ----------------------------------------------------------------------
@pytest.mark.parametrize("m,k,n,c", [
    (8, 256, 128, 4), (64, 512, 256, 16), (17, 300, 129, 8),
    (1, 1024, 512, 2), (128, 128, 128, 16),
])
def test_k5_matches_jax_kernel(m, k, n, c):
    x, idx, cb = _gemm_inputs(m * n + k, m, k, n, c)
    want = np.asarray(jqops.matmul(jnp.asarray(x), jnp.asarray(idx),
                                   jnp.asarray(cb), use_pallas=True))
    np.testing.assert_allclose(
        _np(k45.quant_matmul(_t(x), _t(idx), _t(cb))), want, **GEMM)
    np.testing.assert_allclose(_np(qops.matmul(_t(x), _t(idx), _t(cb))),
                               want, **GEMM)
    np.testing.assert_allclose(
        want, np.asarray(jqref.quant_matmul_ref(x, idx, cb)), **GEMM)


@pytest.mark.parametrize("c", [64, 256])
def test_k5_takes_codebooks_past_16(c):
    """The Pallas K5 asserts C ≤ 16 (compare-select); the port's K5 reads
    the codebook through a lookup table and takes C ≤ 256."""
    x, idx, cb = _gemm_inputs(c, 9, 200, 70, c)
    np.testing.assert_allclose(
        _np(qops.matmul(_t(x), _t(idx), _t(cb))),
        np.asarray(jqref.quant_matmul_ref(jnp.asarray(x), jnp.asarray(idx),
                                          jnp.asarray(cb))), **GEMM)


# ----------------------------------------------------------------------
# K4: 4-bit packed GEMM
# ----------------------------------------------------------------------
@pytest.mark.parametrize("m,k,n,c", [
    (5, 32, 24, 16), (5, 33, 24, 16), (17, 300, 129, 4), (2, 257, 64, 16),
    (64, 512, 256, 16),
])
def test_k4_matches_jax_kernel(m, k, n, c):
    x, idx, cb = _gemm_inputs(m + k + n, m, k, n, c)
    if k % 2:            # the odd-K zero column meets the pad row
        x = np.concatenate([x, np.zeros((m, 1), np.float32)], axis=1)
    packed = np.asarray(jqops.pack4(jnp.asarray(idx)))
    want = np.asarray(jqops.matmul_packed(
        jnp.asarray(x), jnp.asarray(packed), jnp.asarray(cb),
        use_pallas=True))
    np.testing.assert_allclose(
        _np(k45.quant_matmul_packed(_t(x), _t(packed), _t(cb))), want,
        **GEMM)
    np.testing.assert_allclose(
        _np(qops.matmul_packed(_t(x), _t(packed), _t(cb))), want, **GEMM)
    gold = x[:, :k] @ cb[idx.astype(np.int64)]
    np.testing.assert_allclose(want, gold, **GEMM)


def test_matmul_packed_checks_x_width():
    with pytest.raises(ValueError, match="columns"):
        qops.matmul_packed(torch.zeros(2, 5), torch.zeros((3, 4),
                                                          dtype=torch.uint8),
                           torch.zeros(4))


@pytest.mark.parametrize("k", [16, 17])
def test_pack4_unpack4_bit_identical(k):
    idx = np.random.default_rng(k).integers(0, 16, (k, 24)).astype(np.uint8)
    ours = qops.pack4(_t(idx))
    theirs = np.asarray(jqops.pack4(jnp.asarray(idx)))
    assert ours.dtype == torch.uint8 and ours.shape == ((k + 1) // 2, 24)
    np.testing.assert_array_equal(_np(ours), theirs)
    np.testing.assert_array_equal(_np(qops.unpack4(ours)),
                                  np.asarray(jqops.unpack4(theirs)))
    np.testing.assert_array_equal(_np(qops.unpack4(ours))[:k], idx)


@pytest.mark.parametrize("k", [16, 17])
def test_pack_quantized_bit_identical(k):
    rng = np.random.default_rng(k)
    cb = np.sort(rng.standard_normal(k).astype(np.float32))
    w = rng.standard_normal((40, 33)).astype(np.float32)
    w[0, :k - 1] = (cb[1:] + cb[:-1]) * np.float32(0.5)   # midpoint ties
    ours = qops.pack_quantized(_t(w), _t(cb))
    assert ours.dtype == torch.uint8
    np.testing.assert_array_equal(
        _np(ours), np.asarray(jqops.pack_quantized(jnp.asarray(w),
                                                   jnp.asarray(cb))))


# ----------------------------------------------------------------------
# K6: flash attention
# ----------------------------------------------------------------------
@pytest.mark.parametrize("b,s,h,kvh,d,w,qc,kc", [
    (2, 64, 4, 2, 16, 0, 16, 16),
    (1, 128, 8, 8, 32, 24, 32, 16),
    (2, 96, 6, 3, 16, 7, 32, 32),
    (1, 32, 2, 1, 8, 0, 8, 8),
    (1, 64, 4, 2, 96, 0, 32, 32),        # phi3-mini's head_dim
])
def test_k6_matches_jax_kernel(b, s, h, kvh, d, w, qc, kc):
    rng = np.random.default_rng(s + h + d)
    q = rng.standard_normal((b, s, h, d)).astype(np.float32)
    k = rng.standard_normal((b, s, kvh, d)).astype(np.float32)
    v = rng.standard_normal((b, s, kvh, d)).astype(np.float32)
    want = np.asarray(jfops.attention(jnp.asarray(q), jnp.asarray(k),
                                      jnp.asarray(v), window=w, q_chunk=qc,
                                      kv_chunk=kc, use_pallas=True))
    np.testing.assert_allclose(
        _np(fops.attention(_t(q), _t(k), _t(v), window=w)), want, **ATTN)


@pytest.mark.parametrize("window", [0, 24])
def test_k6_kernel_layout_matches_jax_kernel(window):
    """The wrapper in the kernel's own (B, KV, G, S, D) layout against the
    Pallas kernel (interpret mode) and its jnp oracle."""
    rng = np.random.default_rng(77)
    q = rng.standard_normal((2, 2, 3, 64, 16)).astype(np.float32)
    k = rng.standard_normal((2, 2, 64, 16)).astype(np.float32)
    v = rng.standard_normal((2, 2, 64, 16)).astype(np.float32)
    want = np.asarray(j_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                              window=window, q_chunk=16, kv_chunk=16,
                              interpret=True))
    ours = k6.flash_attention(_t(q), _t(k), _t(v), window=window)
    assert ours.dtype == torch.float32 and ours.shape == q.shape
    np.testing.assert_allclose(_np(ours), want, **ATTN)
    np.testing.assert_allclose(
        _np(ours), np.asarray(jfref.flash_attention_ref(q, k, v,
                                                        window=window)),
        **ATTN)


def _tf32(x: torch.Tensor) -> torch.Tensor:
    """x rounded to TF32 as the K6 kernel rounds its operands: to nearest,
    ties away from zero (add half a TF32 ulp to the bits, drop 13)."""
    return ((x.view(torch.int32) + 0x1000) & -0x2000).view(torch.float32)


def _tf32_product(a: torch.Tensor, b: torch.Tensor, passes: int):
    """a @ b from TF32 operands: one pass (hi·hi) or the 3-pass split
    (lo·hi + hi·lo + hi·hi). TF32 products are exact in f32; the sums run
    in f64, so only the operand rounding differs from an f32 product."""
    ah, bh = _tf32(a), _tf32(b)
    out = ah.double() @ bh.double()
    if passes == 3:
        al, bl = _tf32(a - ah), _tf32(b - bh)
        out = al.double() @ bh.double() + ah.double() @ bl.double() + out
    return out.float()


@pytest.mark.parametrize("b,s,h,kvh,d,w", [
    (2, 128, 32, 32, 96, 0), (1, 128, 32, 8, 96, 0), (1, 192, 8, 2, 64, 128),
    (2, 97, 6, 3, 16, 7),
])
def test_k6_needs_the_three_pass_tf32_split(b, s, h, kvh, d, w):
    """Why the K6 kernel runs each product three times on the tensor
    cores: with its operand rounding emulated here, the 3-pass split's
    attention stays within K6's tolerance of the f32 plain version and a
    single TF32 pass does not (K6's chip_smoke.py shapes, S cut)."""
    rng = np.random.default_rng(s + h + d)
    q = _t(rng.standard_normal((b, kvh, h // kvh, s, d)).astype(np.float32))
    k = _t(rng.standard_normal((b, kvh, s, d)).astype(np.float32))
    v = _t(rng.standard_normal((b, kvh, s, d)).astype(np.float32))
    want = k6.flash_attention_plain(q, k, v, window=w)
    pos = torch.arange(s)
    keep = pos[None, :] <= pos[:, None]
    if w:
        keep &= pos[None, :] > pos[:, None] - w
    for passes, close in ((3, True), (1, False)):
        x = _tf32_product(q, k[:, :, None].transpose(-1, -2), passes)
        x = torch.where(keep, x / d ** 0.5, -1e30)
        p = torch.exp(x - x.amax(-1, keepdim=True))     # unnormalised, ≤ 1
        got = (_tf32_product(p, v[:, :, None], passes)
               / p.sum(-1, keepdim=True))
        assert torch.allclose(got, want, **ATTN) == close, passes


def _tf32_trunc(x: torch.Tensor) -> torch.Tensor:
    """x truncated to TF32 (the low 13 mantissa bits dropped): how the
    K4/K5 prefill kernel takes x's hi half, and how the tensor cores read
    the lo half it passes as it is."""
    return (x.view(torch.int32) & -0x2000).view(torch.float32)


@pytest.mark.parametrize("name,c", [("K4", 16), ("K5", 64)])
def test_k45_prefill_needs_the_three_pass_tf32_split(name, c):
    """Why the K4/K5 prefill kernel runs each product three times on the
    tensor cores, at its prefill width K = 3072 (M and N cut), codebook
    at 1/√K: with B's halves from the codebook tables (both rounded to
    nearest, K6's ``_tf32``) and x split as the kernel splits it (hi
    truncated, lo = x - hi read truncated), lo·hi + hi·lo + hi·hi stays
    within the K4/K5 tolerance of the f32 plain version; one TF32 pass
    does not, nor does rounding x alone (the weight in full f32)."""
    rng = np.random.default_rng(c)
    m, k, n = 8, 3072, 64
    x = _t(rng.standard_normal((m, k)).astype(np.float32))
    idx = _t(rng.integers(0, c, (k, n)).astype(np.uint8))
    cb = _t(np.sort(rng.standard_normal(c)).astype(np.float32)
            / np.float32(np.sqrt(k)))
    want = k45.quant_matmul_plain(x, idx, cb)
    cb_hi = _tf32(cb)
    b_hi, b_lo = cb_hi[idx.long()], _tf32(cb - cb_hi)[idx.long()]
    a_hi = _tf32_trunc(x)
    a_lo = _tf32_trunc(x - a_hi)
    three = (a_lo.double() @ b_hi.double() + a_hi.double() @ b_lo.double()
             + a_hi.double() @ b_hi.double()).float()
    one = (_tf32(x).double() @ cb_hi[idx.long()].double()).float()
    x_only = (_tf32(x).double() @ cb[idx.long()].double()).float()
    assert torch.allclose(three, want, **GEMM)
    assert not torch.allclose(one, want, **GEMM)
    assert not torch.allclose(x_only, want, **GEMM)
    # the kernel's x split loses no more than the rounded split
    r_hi = _tf32(x)
    rounded = (_tf32(x - r_hi).double() @ b_hi.double()
               + r_hi.double() @ b_lo.double()
               + r_hi.double() @ b_hi.double()).float()
    assert float((three - want).abs().max()) <= \
        2 * float((rounded - want).abs().max()) + 1e-6


# ----------------------------------------------------------------------
# the plain-torch serving ops (no kernel of their own)
# ----------------------------------------------------------------------
def test_sparse_and_lowrank_serve_match_jax():
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 3, 16)).astype(np.float32)
    w = rng.standard_normal((16, 12)).astype(np.float32)
    w[np.abs(w) < 0.8] = 0.0
    rows, cols = np.nonzero(w)
    vals = w[rows, cols]
    r32, c32 = rows.astype(np.int32), cols.astype(np.int32)
    ours = prune.sparse_matmul(_t(x), _t(vals), _t(r32), _t(c32), 12)
    theirs = jprune.sparse_matmul(jnp.asarray(x), jnp.asarray(vals),
                                  jnp.asarray(r32), jnp.asarray(c32), 12)
    np.testing.assert_allclose(_np(ours), np.asarray(theirs), **GEMM)
    np.testing.assert_array_equal(
        _np(prune.densify(_t(vals), _t(r32), _t(c32), w.shape)), w)
    u = rng.standard_normal((16, 4)).astype(np.float32)
    vt = rng.standard_normal((4, 12)).astype(np.float32)
    np.testing.assert_allclose(
        _np(lowrank.lowrank_matmul(_t(x), _t(u), _t(vt))),
        np.asarray(jlowrank.lowrank_matmul(jnp.asarray(x), jnp.asarray(u),
                                           jnp.asarray(vt))), **GEMM)
    np.testing.assert_allclose(
        _np(lowrank.materialize_lowrank(_t(u), _t(vt))), u @ vt, **GEMM)


# ----------------------------------------------------------------------
# wrapper rules
# ----------------------------------------------------------------------
def test_cpu_calls_run_the_plain_versions_and_count_no_launch():
    before = (k45.KERNEL_U8.launches, k45.KERNEL_PACKED4.launches,
              k6.KERNEL.launches)
    x, idx, cb = _gemm_inputs(0, 3, 8, 5, 4)
    k45.quant_matmul(_t(x), _t(idx), _t(cb))
    k45.quant_matmul_packed(_t(x), qops.pack4(_t(idx)), _t(cb))
    q = torch.zeros(1, 1, 1, 4, 8)
    k6.flash_attention(q, q[:, :, 0], q[:, :, 0])
    assert (k45.KERNEL_U8.launches, k45.KERNEL_PACKED4.launches,
            k6.KERNEL.launches) == before


def test_wrappers_refuse_devices_without_a_kernel():
    x = torch.zeros(2, 8, device="meta")
    idx = torch.zeros((8, 4), dtype=torch.uint8, device="meta")
    cb = torch.zeros(4, device="meta")
    with pytest.raises(ValueError, match="no kernel for device"):
        k45.quant_matmul(x, idx, cb)
    with pytest.raises(ValueError, match="no kernel for device"):
        k45.quant_matmul_packed(x, idx[:4], cb)
    q = torch.zeros(1, 1, 1, 4, 8, device="meta")
    with pytest.raises(ValueError, match="no kernel for device"):
        k6.flash_attention(q, q[:, :, 0], q[:, :, 0])
