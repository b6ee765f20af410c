"""K5 and K4: the codebook-dequant GEMMs of compressed serving, CUDA
kernels.

The port of ``src/repro/kernels/quant_matmul/quant_matmul.py:
quant_matmul`` (uint8 indices) and ``quant_matmul_packed`` (two 4-bit
indices per byte), Pallas TPU kernels. Both come from one CUDA source,
``../csrc/quant_matmul.cu``, whose note gives the design and the bounds.
Two regimes, picked by M inside the launch:

* M ≤ ``GEMV_MAX_M`` (decode): a GEMV bound by the weight's bytes, its
  K range split over several blocks per column tile so that every SM
  has work (:func:`gemv_slices`). The wrapper allocates the slices'
  workspace and takes, per card and stream, the zeroed per-tile
  counters by which the last block of a tile sums the slices in order
  (one launch, no float atomics, same bits on a rerun; each launch
  leaves them zero). They are ``build.stream_buffer``'s, so GEMVs on
  concurrent streams never take each other's tickets;
* M > ``GEMV_MAX_M`` (prefill): the product on the tensor cores, TF32
  ``mma.sync`` with the 3-pass split for f32 accuracy.

Each wrapper launches its kernel for a CUDA tensor and runs its plain
version for a CPU tensor; on meta tensors (the dry run) it checks the
operands as for a launch and returns an empty output (the decode GEMV's
split-K workspace, freed as the launch is queued, is not allocated). On
meta as on the card it reports its launch to an active
``analysis/op_stats.py`` counter (:func:`cost`). Unlike the Pallas K5
(compare-select dequant, C ≤ 16), the CUDA K5 reads the codebook
through a lookup table and takes any C ≤ 256.
"""
from __future__ import annotations

import ctypes
from functools import lru_cache

import torch

from repro_torch.analysis import op_stats
from repro_torch.kernels.build import (
    CudaKernel, on_card, raw_stream, stream_buffer)
from repro_torch.kernels.quant_matmul.ref import (
    quant_matmul_packed_ref as quant_matmul_packed_plain,
    quant_matmul_ref as quant_matmul_plain)

MAX_CODES_U8 = 256
MAX_CODES_4BIT = 16
GEMV_MAX_M = 8            # kGemvMaxM in the source
GEMV_COLS = 64            # columns of a GEMV block (kGemvCols)
GEMV_MAX_SLICE = 512      # rows of a slice (8 chunks of 64 in the source)
_INT_MAX = 2**31 - 1

_p = ctypes.c_void_p
_ARGS = [_p, _p, _p, ctypes.c_int, _p, ctypes.c_longlong,
         ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int, _p, _p, _p]
KERNEL_U8 = CudaKernel("quant_matmul.cu", "quant_matmul_u8", _ARGS, "K5")
KERNEL_PACKED4 = CudaKernel("quant_matmul.cu", "quant_matmul_packed4", _ARGS,
                            "K4")
#: each kernel's label in ``op_stats`` counts

@lru_cache(maxsize=None)
def _sm_count(dev: int) -> int:
    return torch.cuda.get_device_properties(dev).multi_processor_count


@lru_cache(maxsize=1024)
def _slices(rows: int, n: int, sms: int) -> int:
    want = max(1, min(3 * sms // -(-n // GEMV_COLS), -(-rows // 64)))
    per = -(-rows // want)
    per = min((per + 63) // 64 * 64, GEMV_MAX_SLICE)
    return -(-rows // per)


def gemv_slices(rows: int, n: int, dev: int = 0) -> int:
    """K slices per column tile of the decode GEMV on card ``dev`` for a
    weight of ``rows`` index rows and ``n`` columns: at most three blocks
    an SM in all (resident at once but for the 4-bit M > 4 kernels, which
    take two blocks' registers; fewer, longer slices measured faster),
    each slice whole groups of 64 rows, at most ``GEMV_MAX_SLICE``."""
    return _slices(rows, n, _sm_count(dev))


def cost(m: int, k: int, n: int, w_bytes: int,
         codes: int) -> tuple[float, float, str]:
    """(FLOPs, boundary bytes, FLOP class) of one launch: 2·M·K·N, on
    the CUDA cores in f32 for the decode GEMV (M ≤ ``GEMV_MAX_M``) and
    as the 3-pass TF32 split above; x, the ``w_bytes`` of indices and the
    codebook read and y written once."""
    nbytes = 4.0 * (m * k + m * n + codes) + w_bytes
    return 2.0 * m * k * n, nbytes, "f32" if m <= GEMV_MAX_M else "tf32"


def _refuse(name: str, x, w, codebook, k: int, max_codes: int):
    """Raise the error that names what the kernel does not take."""
    if x.device.type not in ("cuda", "meta"):
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
    raise ValueError(f"{name} needs contiguous operands")


def _launch(kernel: CudaKernel, name: str, x, w, codebook, k: int,
            max_codes: int) -> torch.Tensor:
    # one combined check; _refuse names the first rule broken
    if not (x.device.type in ("cuda", "meta") and x.dtype == torch.float32
            and codebook.dtype == torch.float32 and w.dtype == torch.uint8
            and x.ndim == 2 and w.ndim == 2 and codebook.ndim == 1
            and x.shape[1] == k and w.device == x.device
            and codebook.device == x.device and x.is_contiguous()
            and w.is_contiguous() and codebook.is_contiguous()
            and 1 <= x.shape[0] <= _INT_MAX and 1 <= w.shape[1] <= _INT_MAX
            and 1 <= k <= _INT_MAX and 1 <= codebook.shape[0] <= max_codes):
        _refuse(name, x, w, codebook, k, max_codes)
    m, n = x.shape[0], w.shape[1]
    with op_stats.kernel(kernel.label, *cost(m, k, n, w.numel(),
                                                codebook.shape[0])):
        y = torch.empty((m, n), dtype=torch.float32, device=x.device)
        if x.is_meta:
            return y
        dev = x.get_device()
        stream = raw_stream(dev)
        slices, ws, counters = 1, None, None
        if m <= GEMV_MAX_M:
            slices = _slices(w.shape[0], n, _sm_count(dev))
            if slices > 1:
                counters = stream_buffer("gemv tickets", dev, stream,
                                         max(-(-n // GEMV_COLS), 1024),
                                         torch.int32, True)
                # held until the launch is queued, so that no allocation
                # in between takes its memory
                ws = torch.empty((slices, m, n), dtype=torch.float32,
                                 device=x.device)
        with on_card(dev):
            kernel(x.data_ptr(), w.data_ptr(), codebook.data_ptr(),
                   codebook.shape[0], y.data_ptr(), m, n, k, slices,
                   None if ws is None else ws.data_ptr(),
                   None if counters is None else counters.data_ptr(),
                   stream)
    return y


def quant_matmul(x: torch.Tensor, idx: torch.Tensor,
                 codebook: torch.Tensor) -> torch.Tensor:
    """K5: y = x @ codebook[idx]; x (M, K) f32, idx (K, N) uint8,
    codebook (C ≤ 256,) f32 → (M, N) f32. On a CUDA tensor this launches
    the kernel on the current stream without synchronising; on a CPU
    tensor it runs the plain version; on a meta tensor it returns the
    output's shape."""
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
    synchronising; on a CPU tensor it runs the plain version; on a meta
    tensor it returns the output's shape."""
    if x.device.type == "cpu":
        return quant_matmul_packed_plain(x, packed, codebook)
    return _launch(KERNEL_PACKED4, "quant_matmul_packed", x, packed,
                   codebook, 2 * packed.shape[0], MAX_CODES_4BIT)
