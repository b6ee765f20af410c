"""K2, K3, K8 and K9: the threshold count, the whole top-κ bisection and
the threshold mask of the ℓ0 C step, as CUDA kernels.

The ports of ``src/repro/kernels/prune/prune.py`` (Pallas, TPU):

* K2 :func:`count_above_batched` and its single-vector form K8
  :func:`count_above` (the I = 1 strict launch), and the bisection that
  the JAX package's solvers run around them inside one jitted program,
  :func:`topk_threshold_batched` (one launch a bisection), all on one
  kernel in ``../csrc/count_above.cu``;
* K3 :func:`mask_apply_batched` and its single-vector form K9
  :func:`mask_apply` (the source's single-vector strict entry point),
  both on ``../csrc/mask_apply.cu``.

The sources' notes give the designs and the bounds. Each wrapper launches
its kernel for a CUDA tensor and runs its plain version (``ref.py``) for
a CPU tensor; each counts its own launches (``KERNEL`` for K2,
``COUNT_SINGLE`` for K8, ``TOPK`` for the bisection at any I,
``MASK_KERNEL`` for K3, ``MASK_SINGLE`` for K9).

The count kernel's partition comes from the card's grid, queried once
per card (:func:`_blocks_per_item`). The bisection's workspace and
compaction counters and the single count's tickets and counters (zeroed,
and left zero by every launch) are kept per card and stream, so a launch
allocates only its outputs.
"""
from __future__ import annotations

import ctypes
from functools import lru_cache

import torch

from repro_torch.kernels.build import (
    CudaKernel, LaunchCounter, blocks_per_item, on_card, raw_stream,
    stream_buffer)
from repro_torch.kernels.prune.ref import (  # noqa: F401  (the plain versions)
    count_above_batched_plain, count_above_plain, mask_apply_batched_plain,
    mask_apply_plain, topk_threshold_batched_plain)

#: elements a block takes at least: short items take fewer blocks
MIN_PER_BLOCK = 4096

_p = ctypes.c_void_p
_ll = ctypes.c_longlong
_i = ctypes.c_int
_ARGS = [_p, _p, _ll, _ll, _i, _p, _p]
KERNEL = CudaKernel("count_above.cu", "count_above_batched",
                    [_p, _p, _ll, _ll, _i, _i, _p, _p, _p])
TOPK = CudaKernel("count_above.cu", "topk_threshold_batched",
                  [_p, _p, _ll, _ll, _i, _i, _i, _i, _p, _p, _p, _ll, _p])
MASK_KERNEL = CudaKernel("mask_apply.cu", "mask_apply_batched", _ARGS)
MASK_SINGLE = CudaKernel(
    "mask_apply.cu", "mask_apply_single",
    [_p, _p, ctypes.c_float, ctypes.c_longlong, _p, _p])
COUNT_SINGLE = LaunchCounter()
_F32 = torch.float32
_I32 = torch.int32


def _checked(name: str, w: torch.Tensor, t: torch.Tensor,
             t_dtype=_F32) -> None:
    # one combined test on the launch path; the rules one by one below
    if (w.is_cuda and w.dtype is _F32 and t.dtype is t_dtype
            and w.dim() == 2 and w.shape[0] >= 1 and w.shape[1] >= 1
            and t.shape == (w.shape[0],) and t.device == w.device
            and w.is_contiguous() and t.is_contiguous()):
        return
    if w.device.type != "cuda":
        raise ValueError(f"{name}: no kernel for device {w.device}")
    if w.dtype != torch.float32 or t.dtype != t_dtype:
        raise TypeError(f"{name} needs float32 w and {t_dtype} per-item "
                        f"operands, got {w.dtype} and {t.dtype}")
    if w.ndim != 2 or t.shape != (w.shape[0],):
        raise ValueError(f"{name}: need w (I, P) and (I,) per-item "
                         f"operands, got {tuple(w.shape)} and "
                         f"{tuple(t.shape)}")
    if not (w.shape[0] >= 1 and w.shape[1] >= 1):
        raise ValueError(f"{name} takes I, P ≥ 1; got {tuple(w.shape)}")
    if t.device != w.device:
        raise ValueError(f"{name}: w and its per-item operand must be on "
                         f"one device")
    raise ValueError(f"{name} needs contiguous operands")


@lru_cache(maxsize=None)
def _grid(dev: int) -> int:
    """The bisection's largest grid on card ``dev``: the blocks of the
    count kernel that fit on the card at once."""
    with on_card(dev):
        g = KERNEL.query("topk_grid_blocks", [])()
    if g < 1:
        raise RuntimeError(f"topk_grid_blocks: no grid on card {dev}")
    return g


@lru_cache(maxsize=4096)
def _workspace_bytes(n_items: int, p: int, iters: int, bpi: int) -> int:
    return KERNEL.query("topk_workspace_bytes", [_ll, _ll, _i, _i],
                        ctypes.c_longlong)(n_items, p, iters, bpi)


def _blocks_per_item(n_items: int, p: int, grid: int) -> int:
    return blocks_per_item(n_items, p, grid, MIN_PER_BLOCK)


def _count(w, t, n_items: int, strict: bool,
           counter: LaunchCounter) -> torch.Tensor:
    """The single count over checked operands: (I,) counts for w (I, P),
    a 0-d count for w (P,)."""
    p = w.shape[-1]
    dev = w.get_device()
    bpi = _blocks_per_item(n_items, p, _grid(dev))
    stream = raw_stream(dev)
    tickets = stream_buffer("count tickets", dev, stream, 2 * n_items, _I32,
                            True)
    counts = torch.empty(w.shape[:-1], dtype=_I32, device=w.device)
    with on_card(dev):
        KERNEL(w.data_ptr(), t.data_ptr(), n_items, p, int(bool(strict)),
               bpi, counts.data_ptr(), tickets.data_ptr(), stream,
               counter=counter)
    return counts


def _fresh_out(w: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(w, out) with out new and both at one address modulo 16 bytes."""
    out = torch.empty_like(w)
    if (w.data_ptr() - out.data_ptr()) % 16:
        w = w.clone()                    # a fresh allocation: 16-B aligned
    return w, out


def count_above_batched(w: torch.Tensor, t: torch.Tensor,
                        strict: bool = True) -> torch.Tensor:
    """K2: w (I, P) f32, t (I,) f32 → counts (I,) i32 of |w| > t_i
    (``strict=False``: |w| ≥ t_i).

    On a CUDA tensor this launches the kernel on the current stream
    without synchronising; on a CPU tensor it runs the plain version."""
    if w.device.type == "cpu":
        return count_above_batched_plain(w, t, strict)
    _checked("count_above_batched", w, t)
    return _count(w, t, w.shape[0], strict, KERNEL)


def count_above(w: torch.Tensor, t) -> torch.Tensor:
    """K8: w (P,) f32, t a 0-d threshold → 0-d i32 count of |w| > t: the
    K2 kernel's I = 1 strict launch (the TPU kernel counts in f32)."""
    if w.device.type == "cpu":
        return count_above_plain(w, t)
    t = torch.as_tensor(t, dtype=_F32, device=w.device)
    if not (w.is_cuda and w.dtype is _F32 and w.dim() == 1
            and w.numel() > 0 and w.is_contiguous() and t.numel() == 1):
        _checked("count_above", w.reshape(1, -1) if w.dim() == 1 else w,
                 t.reshape(-1))
        raise ValueError(f"count_above needs a non-empty contiguous vector "
                         f"and one threshold, got {tuple(w.shape)} and "
                         f"{tuple(t.shape)}")
    return _count(w, t, 1, True, COUNT_SINGLE)


def topk_threshold_batched(w: torch.Tensor, kappa: torch.Tensor,
                           iters: int = 30, strict: bool = False,
                           with_stats: bool = False):
    """The top-κ bisection in one launch: w (I, P) f32, κ (I,) i32 →
    (lo (I,) f32, hi (I,) f32, n_hi (I,) i32), with ``strict=False`` the
    batched rules (``hi = 2·max|w| + 1``, ``lo = mid`` where
    ``count(|w| ≥ mid) ≥ κ``, ``n_hi = count(|w| ≥ hi)``) and with
    ``strict=True`` the single-vector ones (``hi = max|w|``, counts of
    ``|w| > t``, ``lo = mid`` where the count exceeds κ).

    On a CUDA tensor this is one launch on the current stream, with no
    host sync, equal bit for bit to ``iters + 1`` single counts with the
    update done by torch; ``with_stats`` adds (I, 4) i32: the
    compactions of each item's band, the step of the first (-1: none),
    the passes over all of w and the first step of the one-block finish
    (-1: none). A grid that the card cannot place raises. On a CPU tensor
    it runs the plain loop (no compaction: 0, -1, the loop's iters + 2
    passes, -1)."""
    if w.device.type == "cpu":
        lo, hi, n_hi = topk_threshold_batched_plain(w, kappa, iters, strict)
        if not with_stats:
            return lo, hi, n_hi
        stats = torch.tensor([0, -1, iters + 2, -1], dtype=torch.int32)
        return lo, hi, n_hi, stats.repeat(w.shape[0], 1)
    _checked("topk_threshold_batched", w, kappa, _I32)
    if not 0 <= iters < 2**31 or w.shape[1] >= 2**31:
        raise ValueError(f"topk_threshold_batched takes P < 2^31 and "
                         f"iters ≥ 0; got P={w.shape[1]}, iters={iters}")
    n_items, p = w.shape
    dev = w.get_device()
    grid = _grid(dev)
    bpi = _blocks_per_item(n_items, p, grid)
    stream = raw_stream(dev)
    ws = stream_buffer("topk workspace", dev, stream,
                       _workspace_bytes(n_items, p, iters, bpi),
                       torch.uint8, False)
    ctr = stream_buffer("topk counters", dev, stream,
                        n_items * max(iters, 1), _I32, True)
    out = torch.empty((7, n_items), dtype=_I32, device=w.device)
    with on_card(dev):
        TOPK(w.data_ptr(), kappa.data_ptr(), n_items, p, int(iters),
             int(bool(strict)), bpi, grid, out.data_ptr(), ctr.data_ptr(),
             ws.data_ptr(), ws.numel(), stream)
    bounds = out[:2].view(torch.float32)
    if with_stats:
        return bounds[0], bounds[1], out[2], out[3:].T
    return bounds[0], bounds[1], out[2]


def mask_apply_batched(w: torch.Tensor, t: torch.Tensor,
                       strict: bool = True) -> torch.Tensor:
    """K3: w (I, P) f32, t (I,) f32 → (I, P) w·1[|w| > t_i]
    (``strict=False``: |w| ≥ t_i); kept weights pass bit for bit.

    On a CUDA tensor this launches the kernel on the current stream
    without synchronising; on a CPU tensor it runs the plain version."""
    if w.device.type == "cpu":
        return mask_apply_batched_plain(w, t, strict)
    _checked("mask_apply_batched", w, t)
    if w.shape[0] > 65535:               # the mask kernel's grid y
        raise ValueError(f"mask_apply_batched takes I ≤ 65535; got "
                         f"I={w.shape[0]}")
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
