"""K6: fused flash-attention forward (causal + window, GQA-native), a
CUDA kernel.

The port of ``src/repro/kernels/flash_attention/flash_attention.py:
flash_attention`` (Pallas, TPU). The kernel source is
``../csrc/flash_attention.cu``; its note gives the design and the bound.
:func:`flash_attention` launches it for a CUDA tensor and runs
:func:`flash_attention_plain` for a CPU tensor.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels.build import CudaKernel, on_card, raw_stream
from repro_torch.kernels.flash_attention.ref import (
    flash_attention_ref as flash_attention_plain)

#: head dims the kernel is instantiated for with V's head dim equal
HEAD_DIMS = (8, 16, 32, 64, 96, 128)
#: the (qk head dim, v head dim) pairs it is built for: Dv == D for every
#: D above, and MLA's (nope + rope, v) of minicpm3-4b
HEAD_DIM_PAIRS = tuple((d, d) for d in HEAD_DIMS) + ((96, 64),)
#: query rows per block (all G grouped heads × the positions of a q tile)
ROWS = 64
MAX_GRID = 65535
_F32 = torch.float32

_p = ctypes.c_void_p
KERNEL = CudaKernel(
    "flash_attention.cu", "flash_attention_fwd",
    [_p, _p, _p, _p, ctypes.c_longlong, ctypes.c_longlong,
     ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
     ctypes.c_int, ctypes.c_float, _p])


def _refuse(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    """Raise the reason the kernel does not take these operands."""
    if any(t.dtype != torch.float32 for t in (q, k, v)):
        raise TypeError("flash_attention kernel needs float32 operands, got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
    if q.ndim != 5 or k.ndim != 4 or v.shape[:3] != k.shape[:3]:
        raise ValueError(f"need q (B, KV, G, S, D), k (B, KV, S, D) and v "
                         f"(B, KV, S, Dv); got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    b, kvh, g, s, d = q.shape
    if tuple(k.shape) != (b, kvh, s, d):
        raise ValueError(f"k/v {tuple(k.shape)} do not match q "
                         f"{tuple(q.shape)}")
    if (d, v.shape[-1]) not in HEAD_DIM_PAIRS:
        raise ValueError(f"flash_attention kernel takes (D, Dv) in "
                         f"{HEAD_DIM_PAIRS}, got {(d, v.shape[-1])}")
    if not (1 <= g <= ROWS and 1 <= b <= MAX_GRID and 1 <= kvh <= MAX_GRID
            and s >= 1):
        raise ValueError(f"flash_attention kernel takes 1 ≤ G ≤ {ROWS}, "
                         f"1 ≤ B, KV ≤ {MAX_GRID}, S ≥ 1; got B={b}, "
                         f"KV={kvh}, G={g}, S={s}")
    if k.device != q.device or v.device != q.device:
        raise ValueError("q, k and v must be on the same device")
    raise ValueError("flash_attention kernel needs contiguous operands")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    window: int = 0,
                    scale: float | None = None) -> torch.Tensor:
    """q: (B, KV, G, S, D); k: (B, KV, S, D); v: (B, KV, S, Dv) →
    (B, KV, G, S, Dv) f32.

    Causal over positions 0..S-1 (+ sliding window when ``window > 0``),
    scores scaled by ``scale`` (default 1/√D). On a CUDA tensor this
    launches the kernel on the current stream without synchronising; on
    a CPU tensor it runs the plain version. The checks take one pass
    (:func:`_refuse` explains a refusal) and the stream is taken as a
    raw handle, so that the host adds little to a call."""
    if not q.is_cuda:
        if q.is_cpu:
            return flash_attention_plain(q, k, v, window=window,
                                         scale=scale)
        raise ValueError(f"flash_attention: no kernel for device {q.device}")
    dev = q.get_device()
    if q.dim() != 5 or v.dim() != 4:
        _refuse(q, k, v)
    b, kvh, g, s, d = q.shape
    dv = v.shape[3]
    if not (q.dtype is _F32 and k.dtype is _F32 and v.dtype is _F32
            and k.shape == (b, kvh, s, d) and v.shape[:3] == (b, kvh, s)
            and (d, dv) in HEAD_DIM_PAIRS and 1 <= g <= ROWS
            and 1 <= b <= MAX_GRID
            and 1 <= kvh <= MAX_GRID and s >= 1
            and k.get_device() == dev and v.get_device() == dev
            and q.is_contiguous() and k.is_contiguous()
            and v.is_contiguous()):
        _refuse(q, k, v)
    # the kernel copies 16-byte chunks; a fresh allocation is aligned
    if (q.data_ptr() | k.data_ptr() | v.data_ptr()) % 16:
        q, k, v = (t if t.data_ptr() % 16 == 0 else t.clone()
                   for t in (q, k, v))
    out = q.new_empty((b, kvh, g, s, dv))
    with on_card(dev):
        KERNEL(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b,
               kvh, g, s, d, dv, int(window),
               1.0 / math.sqrt(d) if scale is None else float(scale),
               raw_stream(dev))
    return out
