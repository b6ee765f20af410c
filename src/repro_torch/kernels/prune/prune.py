"""K2, K3, K8 and K9: the threshold count and the threshold mask of the
ℓ0 C step, as CUDA kernels.

The ports of ``src/repro/kernels/prune/prune.py`` (Pallas, TPU):

* K2 :func:`count_above_batched` and its single-vector form K8
  :func:`count_above` (the I = 1 strict launch), both on
  ``../csrc/count_above.cu``;
* K3 :func:`mask_apply_batched` and its single-vector form K9
  :func:`mask_apply` (the source's single-vector strict entry point),
  both on ``../csrc/mask_apply.cu``.

The sources' notes give the designs and the bounds. Each wrapper launches
its kernel for a CUDA tensor and runs its plain version (``ref.py``) for
a CPU tensor; each counts its own launches (``KERNEL`` for K2,
``COUNT_SINGLE`` for K8, ``MASK_KERNEL`` for K3, ``MASK_SINGLE`` for K9).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels.build import (
    CudaKernel, LaunchCounter, on_card, raw_stream)
from repro_torch.kernels.prune.ref import (  # noqa: F401  (the plain versions)
    count_above_batched_plain, count_above_plain, mask_apply_batched_plain,
    mask_apply_plain)

_p = ctypes.c_void_p
_ARGS = [_p, _p, ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int, _p, _p]
KERNEL = CudaKernel("count_above.cu", "count_above_batched", _ARGS)
MASK_KERNEL = CudaKernel("mask_apply.cu", "mask_apply_batched", _ARGS)
MASK_SINGLE = CudaKernel(
    "mask_apply.cu", "mask_apply_single",
    [_p, _p, ctypes.c_float, ctypes.c_longlong, _p, _p])
COUNT_SINGLE = LaunchCounter()
_F32 = torch.float32


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
    dev = w.get_device()
    with on_card(dev):
        KERNEL(w.data_ptr(), t.data_ptr(), w.shape[0], w.shape[1],
               int(bool(strict)), counts.data_ptr(), raw_stream(dev),
               counter=counter)
    return counts


def _fresh_out(w: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(w, out) with out new and both at one address modulo 16 bytes."""
    out = torch.empty_like(w)
    if (w.data_ptr() - out.data_ptr()) % 16:
        w = w.clone()                    # a fresh allocation: 16-B aligned
    return w, out


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
    w, out = _fresh_out(w)
    dev = w.get_device()
    with on_card(dev):
        MASK_KERNEL(w.data_ptr(), t.data_ptr(), w.shape[0], w.shape[1],
                    int(bool(strict)), out.data_ptr(), raw_stream(dev))
    return out


def mask_apply(w: torch.Tensor, t) -> torch.Tensor:
    """K9: w (P,) f32, t a threshold (a Python number or a one-element
    tensor) → w·1[|w| > t].

    On a CUDA tensor this launches the kernel on the current stream
    without synchronising, reading a float32 CUDA threshold on w's card
    in place; on a CPU tensor it runs the plain version. The launch path
    is the kernel's cost at the sizes it runs (see the source's note), so
    the checks are one pass and the stream is taken as a raw handle."""
    if not w.is_cuda:
        if w.is_cpu:
            return mask_apply_plain(w, t)
        raise ValueError(f"mask_apply: no kernel for device {w.device}")
    if (w.dtype is not _F32 or w.dim() != 1 or not w.is_contiguous()
            or w.numel() == 0):
        if w.dtype is not _F32:
            raise TypeError(f"mask_apply needs float32 w, got {w.dtype}")
        raise ValueError("mask_apply needs a non-empty contiguous vector, "
                         f"got shape {tuple(w.shape)}")
    dev = w.get_device()
    t_ptr, t_value = None, 0.0
    if not isinstance(t, torch.Tensor):
        t_value = float(t)                   # rounded to float32 by ctypes
    elif (t.is_cuda and t.dtype is _F32 and t.numel() == 1
          and t.get_device() == dev):
        t_ptr = t.data_ptr()
    elif t.numel() != 1:
        raise ValueError(f"mask_apply: t must hold one threshold, got "
                         f"{tuple(t.shape)}")
    elif t.is_cpu:
        t_value = float(t)
    else:
        t = t.to(device=w.device, dtype=_F32)
        t_ptr = t.data_ptr()
    w, out = _fresh_out(w)
    with on_card(dev):
        MASK_SINGLE(w.data_ptr(), t_ptr, t_value, w.numel(), out.data_ptr(),
                    raw_stream(dev))
    return out
