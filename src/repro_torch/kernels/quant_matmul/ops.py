"""Public wrappers for the codebook-dequant GEMMs (uint8 and 4-bit packed)
and the helpers that put quantized weights into kernel layout.

Port of ``src/repro/kernels/quant_matmul/ops.py``. The kernels mask
ragged edges themselves, so nothing is padded here, and the 4-bit kernel
unpacks both nibbles itself, so x is not split into even and odd
columns. The device of the tensors picks the kernel (CUDA) or its plain
version (CPU); on the card the kernel picks its regime by M (a split-K
GEMV for decode, M ≤ ``quant_matmul.GEMV_MAX_M``; the tensor cores
above), see ``quant_matmul.py``. Operands are converted to float32 and
made contiguous only where they are not already.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.quant_matmul import ref
from repro_torch.kernels.quant_matmul.quant_matmul import (
    quant_matmul, quant_matmul_packed)


def _f32(t: torch.Tensor) -> torch.Tensor:
    if t.dtype != torch.float32:
        t = t.float()
    return t if t.is_contiguous() else t.contiguous()


def matmul(x: torch.Tensor, idx: torch.Tensor,
           codebook: torch.Tensor) -> torch.Tensor:
    """y = x @ codebook[idx] (K5). x: (M, K); idx: (K, N) uint8."""
    return quant_matmul(_f32(x), idx if idx.is_contiguous()
                        else idx.contiguous(), _f32(codebook))


def matmul_packed(x: torch.Tensor, packed: torch.Tensor,
                  codebook: torch.Tensor) -> torch.Tensor:
    """y = x @ codebook[unpack4(packed)] — the 4-bit serving GEMM (K4).

    ``packed``: (ceil(K/2), N) bytes from :func:`pack4`. x: (M, K) with
    K = 2·packed.shape[0] (for odd K, x carries a zero column that meets
    the pad row of index 0)."""
    m, k = x.shape
    if k != 2 * packed.shape[0]:
        raise ValueError(f"x {tuple(x.shape)} needs 2·{packed.shape[0]} "
                         f"columns for packed {tuple(packed.shape)}")
    return quant_matmul_packed(
        _f32(x), packed if packed.is_contiguous() else packed.contiguous(),
        _f32(codebook))


def pack_quantized(w: torch.Tensor, codebook: torch.Tensor) -> torch.Tensor:
    """Dense weight matrix → uint8 index matrix under a sorted
    ``codebook`` (nearest entry; a midpoint tie goes to the lower)."""
    mid = (codebook[1:] + codebook[:-1]) * 0.5
    return torch.searchsorted(mid.contiguous(),
                              w.contiguous()).to(torch.uint8)


def pack4(idx: torch.Tensor) -> torch.Tensor:
    """(K, N) uint8 indices (< 16) → (ceil(K/2), N) packed bytes.

    Row 2r lands in the low nibble, row 2r+1 in the high nibble. Odd K
    pads one index-0 row, harmless as long as the matching x column is
    zero."""
    k, n = idx.shape
    if k % 2:
        idx = torch.cat([idx, idx.new_zeros((1, n))], dim=0)
    lo = idx[0::2]
    hi = idx[1::2]
    return (lo | (hi << 4)).to(torch.uint8)


def unpack4(packed: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`pack4` (up to the odd-K pad row)."""
    return ref.unpack4_ref(packed)
