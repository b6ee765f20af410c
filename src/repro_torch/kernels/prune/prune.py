"""K2, K3, K8 and K9: the threshold count and the threshold mask of the
ℓ0 C step, as CUDA kernels.

The ports of ``src/repro/kernels/prune/prune.py`` (Pallas, TPU):

* K2 :func:`count_above_batched` and its single-vector form K8
  :func:`count_above` (the I = 1 strict launch), both on
  ``../csrc/count_above.cu``;
* K3 :func:`mask_apply_batched` and its single-vector form K9
  :func:`mask_apply` (the I = 1 strict launch), both on
  ``../csrc/mask_apply.cu``.

The sources' notes give the designs and the bounds. Each wrapper launches
its kernel for a CUDA tensor and runs its plain version (``ref.py``) for
a CPU tensor; each counts its own launches (``KERNEL`` for K2,
``COUNT_SINGLE`` for K8, ``MASK_KERNEL`` for K3, ``MASK_SINGLE`` for K9).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels.build import CudaKernel, LaunchCounter
from repro_torch.kernels.prune.ref import (  # noqa: F401  (the plain versions)
    count_above_batched_plain, count_above_plain, mask_apply_batched_plain,
    mask_apply_plain)

_p = ctypes.c_void_p
_ARGS = [_p, _p, ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int, _p, _p]
KERNEL = CudaKernel("count_above.cu", "count_above_batched", _ARGS)
MASK_KERNEL = CudaKernel("mask_apply.cu", "mask_apply_batched", _ARGS)
COUNT_SINGLE, MASK_SINGLE = LaunchCounter(), LaunchCounter()


def _checked(name: str, w: torch.Tensor, t: torch.Tensor) -> None:
    if w.device.type != "cuda":
        raise ValueError(f"{name}: no kernel for device {w.device}")
    if w.dtype != torch.float32 or t.dtype != torch.float32:
        raise TypeError(f"{name} needs float32 operands, got {w.dtype} "
                        f"and {t.dtype}")
    if w.ndim != 2 or t.shape != (w.shape[0],):
        raise ValueError(f"{name}: need w (I, P) and t (I,), got "
                         f"{tuple(w.shape)} and {tuple(t.shape)}")
    n_items, p = w.shape
    if not (1 <= n_items <= 65535 and p >= 1):
        raise ValueError(f"{name} takes 1 ≤ I ≤ 65535 and P ≥ 1; got "
                         f"I={n_items}, P={p}")
    if t.device != w.device:
        raise ValueError("w and t must be on the same device")
    if not (w.is_contiguous() and t.is_contiguous()):
        raise ValueError(f"{name} needs contiguous operands")


def _count(w, t, strict: bool, counter: LaunchCounter) -> torch.Tensor:
    counts = torch.zeros((w.shape[0],), dtype=torch.int32, device=w.device)
    with torch.cuda.device(w.device):
        KERNEL(w.data_ptr(), t.data_ptr(), w.shape[0], w.shape[1],
               int(bool(strict)), counts.data_ptr(),
               torch.cuda.current_stream(w.device).cuda_stream,
               counter=counter)
    return counts


def _mask(w, t, strict: bool, counter: LaunchCounter) -> torch.Tensor:
    out = torch.empty_like(w)
    if w.data_ptr() % 16 != out.data_ptr() % 16:
        w = w.clone()                    # a fresh allocation: 16-B aligned
    with torch.cuda.device(w.device):
        MASK_KERNEL(w.data_ptr(), t.data_ptr(), w.shape[0], w.shape[1],
                    int(bool(strict)), out.data_ptr(),
                    torch.cuda.current_stream(w.device).cuda_stream,
                    counter=counter)
    return out


def _scalar_threshold(t, w: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(t, dtype=torch.float32,
                           device=w.device).reshape(1)


def count_above_batched(w: torch.Tensor, t: torch.Tensor,
                        strict: bool = True) -> torch.Tensor:
    """K2: w (I, P) f32, t (I,) f32 → counts (I,) i32 of |w| > t_i
    (``strict=False``: |w| ≥ t_i).

    On a CUDA tensor this launches the kernel on the current stream
    without synchronising; on a CPU tensor it runs the plain version."""
    if w.device.type == "cpu":
        return count_above_batched_plain(w, t, strict)
    _checked("count_above_batched", w, t)
    return _count(w, t, strict, KERNEL)


def count_above(w: torch.Tensor, t) -> torch.Tensor:
    """K8: w (P,) f32, t a 0-d threshold → 0-d i32 count of |w| > t: the
    K2 kernel's I = 1 strict launch (the TPU kernel counts in f32)."""
    if w.device.type == "cpu":
        return count_above_plain(w, t)
    t = _scalar_threshold(t, w)
    _checked("count_above", w[None], t)
    return _count(w[None], t, True, COUNT_SINGLE)[0]


def mask_apply_batched(w: torch.Tensor, t: torch.Tensor,
                       strict: bool = True) -> torch.Tensor:
    """K3: w (I, P) f32, t (I,) f32 → (I, P) w·1[|w| > t_i]
    (``strict=False``: |w| ≥ t_i); kept weights pass bit for bit.

    On a CUDA tensor this launches the kernel on the current stream
    without synchronising; on a CPU tensor it runs the plain version."""
    if w.device.type == "cpu":
        return mask_apply_batched_plain(w, t, strict)
    _checked("mask_apply_batched", w, t)
    return _mask(w, t, strict, MASK_KERNEL)


def mask_apply(w: torch.Tensor, t) -> torch.Tensor:
    """K9: w (P,) f32, t a 0-d threshold → w·1[|w| > t]: the K3 kernel's
    I = 1 strict launch."""
    if w.device.type == "cpu":
        return mask_apply_plain(w, t)
    t = _scalar_threshold(t, w)
    _checked("mask_apply", w[None], t)
    return _mask(w[None], t, True, MASK_SINGLE)[0]
