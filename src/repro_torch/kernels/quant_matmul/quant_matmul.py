"""K5 and K4: the codebook-dequant GEMMs of compressed serving, CUDA
kernels.

The port of ``src/repro/kernels/quant_matmul/quant_matmul.py:
quant_matmul`` (uint8 indices) and ``quant_matmul_packed`` (two 4-bit
indices per byte), Pallas TPU kernels. Both come from one CUDA source,
``../csrc/quant_matmul.cu``, whose note gives the design and the bound.
Each wrapper launches its kernel for a CUDA tensor and runs its plain
version for a CPU tensor. Unlike the Pallas K5 (compare-select dequant,
C ≤ 16), the CUDA K5 reads the codebook through a lookup table and takes
any C ≤ 256.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels.build import CudaKernel, on_card, raw_stream
from repro_torch.kernels.quant_matmul.ref import (
    quant_matmul_packed_ref as quant_matmul_packed_plain,
    quant_matmul_ref as quant_matmul_plain)

MAX_CODES_U8 = 256
MAX_CODES_4BIT = 16
_INT_MAX = 2**31 - 1

_p = ctypes.c_void_p
_ARGS = [_p, _p, _p, ctypes.c_int, _p, ctypes.c_longlong,
         ctypes.c_longlong, ctypes.c_longlong, _p]
KERNEL_U8 = CudaKernel("quant_matmul.cu", "quant_matmul_u8", _ARGS)
KERNEL_PACKED4 = CudaKernel("quant_matmul.cu", "quant_matmul_packed4", _ARGS)


def _launch(kernel: CudaKernel, name: str, x, w, codebook, k: int,
            max_codes: int) -> torch.Tensor:
    if x.device.type != "cuda":
        raise ValueError(f"{name}: no kernel for device {x.device}")
    if x.dtype != torch.float32 or codebook.dtype != torch.float32:
        raise TypeError(f"{name} needs float32 x and codebook, got "
                        f"{x.dtype} and {codebook.dtype}")
    if w.dtype != torch.uint8:
        raise TypeError(f"{name} needs uint8 indices, got {w.dtype}")
    if x.ndim != 2 or w.ndim != 2 or codebook.ndim != 1:
        raise ValueError(f"{name}: need x (M, K), indices 2-D and a 1-D "
                         f"codebook; got {tuple(x.shape)}, "
                         f"{tuple(w.shape)}, {tuple(codebook.shape)}")
    m, n, c = x.shape[0], w.shape[1], codebook.shape[0]
    if x.shape[1] != k:
        raise ValueError(f"{name}: x has {x.shape[1]} columns, the weight "
                         f"{k} rows")
    if not (1 <= m <= _INT_MAX and 1 <= n <= _INT_MAX and 1 <= k <= _INT_MAX
            and 1 <= c <= max_codes):
        raise ValueError(f"{name} takes M, N, K ≥ 1 and 1 ≤ C ≤ "
                         f"{max_codes}; got M={m}, N={n}, K={k}, C={c}")
    if w.device != x.device or codebook.device != x.device:
        raise ValueError(f"{name}: operands must be on one device")
    if not (x.is_contiguous() and w.is_contiguous()
            and codebook.is_contiguous()):
        raise ValueError(f"{name} needs contiguous operands")
    y = torch.empty((m, n), dtype=torch.float32, device=x.device)
    dev = x.get_device()
    with on_card(dev):
        kernel(x.data_ptr(), w.data_ptr(), codebook.data_ptr(), c,
               y.data_ptr(), m, n, k, raw_stream(dev))
    return y


def quant_matmul(x: torch.Tensor, idx: torch.Tensor,
                 codebook: torch.Tensor) -> torch.Tensor:
    """K5: y = x @ codebook[idx]; x (M, K) f32, idx (K, N) uint8,
    codebook (C ≤ 256,) f32 → (M, N) f32. On a CUDA tensor this launches
    the kernel on the current stream without synchronising; on a CPU
    tensor it runs the plain version."""
    if x.device.type == "cpu":
        return quant_matmul_plain(x, idx, codebook)
    return _launch(KERNEL_U8, "quant_matmul", x, idx, codebook,
                   idx.shape[0], MAX_CODES_U8)


def quant_matmul_packed(x: torch.Tensor, packed: torch.Tensor,
                        codebook: torch.Tensor) -> torch.Tensor:
    """K4: y = x @ codebook[unpack4(packed)]; x (M, K) f32 with K =
    2·packed.shape[0], packed (K/2, N) uint8, codebook (C ≤ 16,) f32 →
    (M, N) f32. Both nibbles of a byte are unpacked in the kernel. On a
    CUDA tensor this launches the kernel on the current stream without
    synchronising; on a CPU tensor it runs the plain version."""
    if x.device.type == "cpu":
        return quant_matmul_packed_plain(x, packed, codebook)
    return _launch(KERNEL_PACKED4, "quant_matmul_packed", x, packed,
                   codebook, 2 * packed.shape[0], MAX_CODES_4BIT)
