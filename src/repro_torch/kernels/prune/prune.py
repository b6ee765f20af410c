"""K2: batched threshold count for the top-κ bisection, a CUDA kernel.

The port of ``src/repro/kernels/prune/prune.py:count_above_batched``
(Pallas, TPU). The kernel source is ``../csrc/count_above.cu``; its note
gives the design and the bound. :func:`count_above_batched` launches it
for a CUDA tensor and runs :func:`count_above_batched_plain` for a CPU
tensor.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels.build import CudaKernel
from repro_torch.kernels.prune.ref import (  # noqa: F401  (the plain version)
    count_above_batched_plain)

_p = ctypes.c_void_p
KERNEL = CudaKernel(
    "count_above.cu", "count_above_batched",
    [_p, _p, ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int, _p, _p])


def count_above_batched(w: torch.Tensor, t: torch.Tensor,
                        strict: bool = True) -> torch.Tensor:
    """w (I, P) f32, t (I,) f32 → counts (I,) i32 of |w| > t_i
    (``strict=False``: |w| ≥ t_i).

    On a CUDA tensor this launches the kernel on the current stream
    without synchronising; on a CPU tensor it runs the plain version."""
    if w.device.type == "cpu":
        return count_above_batched_plain(w, t, strict)
    if w.device.type != "cuda":
        raise ValueError(f"count_above_batched: no kernel for device "
                         f"{w.device}")
    if w.dtype != torch.float32 or t.dtype != torch.float32:
        raise TypeError("count_above_batched needs float32 operands, got "
                        f"{w.dtype} and {t.dtype}")
    if w.ndim != 2 or t.shape != (w.shape[0],):
        raise ValueError(f"need w (I, P) and t (I,), got {tuple(w.shape)} "
                         f"and {tuple(t.shape)}")
    n_items, p = w.shape
    if not (1 <= n_items <= 65535 and p >= 1):
        raise ValueError(f"count kernel takes 1 ≤ I ≤ 65535 and P ≥ 1; "
                         f"got I={n_items}, P={p}")
    if t.device != w.device:
        raise ValueError("w and t must be on the same device")
    if not (w.is_contiguous() and t.is_contiguous()):
        raise ValueError("count kernel needs contiguous operands")
    counts = torch.zeros((n_items,), dtype=torch.int32, device=w.device)
    with torch.cuda.device(w.device):
        KERNEL(w.data_ptr(), t.data_ptr(), n_items, p, int(bool(strict)),
               counts.data_ptr(),
               torch.cuda.current_stream(w.device).cuda_stream)
    return counts
