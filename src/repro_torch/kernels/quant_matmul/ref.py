"""Plain PyTorch versions of the codebook-dequant GEMMs (K5, K4): the
oracles, and what the kernel wrappers run on CPU tensors."""
from __future__ import annotations

import torch


def quant_matmul_ref(x: torch.Tensor, idx: torch.Tensor,
                     codebook: torch.Tensor) -> torch.Tensor:
    """x: (M, K); idx: (K, N) uint8 codebook indices; codebook: (C,) f32
    → y (M, N) f32 = x @ codebook[idx]."""
    w = codebook.float()[idx.long()]              # (K, N) f32
    return x.float() @ w


def unpack4_ref(packed: torch.Tensor) -> torch.Tensor:
    """(K/2, N) packed bytes → (K, N) uint8 indices (row 2r = low
    nibble, row 2r+1 = high nibble)."""
    lo = packed & 0x0F
    hi = packed >> 4
    k2, n = packed.shape
    return torch.stack([lo, hi], dim=1).reshape(2 * k2, n)


def quant_matmul_packed_ref(x: torch.Tensor, packed: torch.Tensor,
                            codebook: torch.Tensor) -> torch.Tensor:
    """The 4-bit path: unpack to full uint8 indices, then the dense
    dequant matmul. x: (M, 2·packed.shape[0])."""
    return quant_matmul_ref(x, unpack4_ref(packed), codebook)
