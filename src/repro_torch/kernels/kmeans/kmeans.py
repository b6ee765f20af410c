"""K1 and K7: k-means assignment + cluster moments, and the Lloyd loop in
one launch, as CUDA kernels.

The ports of ``src/repro/kernels/kmeans/kmeans.py:
kmeans_assign_moments_batched`` (K1) and its single-vector form
``kmeans_assign_moments`` (K7, here the I = 1 pass of K1), Pallas kernels
for the TPU, and of the Lloyd loop that the JAX package's solver runs
around K1 inside one jitted program (:func:`kmeans_lloyd_batched`). One
kernel in ``../csrc/kmeans_assign_moments.cu`` runs all three; its note
gives the design and the bound. Each wrapper launches it for a CUDA
tensor and runs its plain version (``ref.py``) for a CPU tensor, and
counts its own launches (``KERNEL`` for K1, ``SINGLE`` for K7, ``LLOYD``
for the loop at any I).

The wrapper fixes the partition that the single pass and the loop share
(:func:`_blocks_per_item`, from the card's grid, queried once per card
and kernel instance). Each item's slices are summed in slice order, so
the bits depend on the partition, and the partition on the item count:
a chunk of a planned group partitions its items as the group's one
launch would (``build.group_partition``). That keeps a chunked solve
equal to one launch bit for bit, without a change to the kernel, at the
price of a chunk using its share of the grid only (PERF.md, PR 22).
A partition that depends on P alone would keep chunks on the whole grid,
but would push small groups past the grid, off their resident slices
(:func:`_slice_resident`). The partials workspace and the single pass's
tickets (zeroed, left zero by every launch) are kept per card and
stream, so a launch allocates only its outputs. On meta tensors (the
planner's counts and the dry run) the Lloyd loop only allocates its
outputs; on meta as on the card it reports its launch to an active
``analysis/op_stats.py`` counter (:func:`lloyd_cost`).
"""
from __future__ import annotations

import ctypes
from functools import lru_cache

import torch

from repro_torch.analysis import op_stats
from repro_torch.kernels.build import (
    CudaKernel, LaunchCounter, blocks_per_item, on_card, partition_items,
    raw_stream, stream_buffer)
from repro_torch.kernels.kmeans.ref import (  # noqa: F401  (the plain versions)
    kmeans_assign_moments_batched_plain, kmeans_assign_moments_plain,
    kmeans_lloyd_batched_plain)

MAX_K = 256
#: elements a block takes at least: short items take fewer blocks
MIN_PER_BLOCK = 2048
_F32 = torch.float32

_p = ctypes.c_void_p
_ll = ctypes.c_longlong
_i = ctypes.c_int
KERNEL = CudaKernel(
    "kmeans_assign_moments.cu", "kmeans_assign_moments_batched",
    [_p, _p, _ll, _ll, _i, _i, _p, _p, _p, _p, _p, _ll, _p], "K1")
LLOYD = CudaKernel(
    "kmeans_assign_moments.cu", "kmeans_lloyd_batched",
    [_p, _p, _ll, _ll, _i, _i, _i, _i, _p, _p, _p, _ll, _p], "K1loop")
SINGLE = LaunchCounter("K7")

def _padded_k(k: int) -> int:
    """The kernel instance's cluster capacity (KP in the source)."""
    return 4 if k <= 4 else 16 if k <= 16 else 64 if k <= 64 else 256


@lru_cache(maxsize=None)
def _instance_grid(dev: int, kp: int) -> int:
    with on_card(dev):
        g = KERNEL.query("kmeans_grid_blocks", [_i])(kp)
    if g < 1:
        raise RuntimeError(f"kmeans_grid_blocks: no grid for K ≤ {kp} on "
                           f"card {dev}")
    return g


def _grid(dev: int, k: int) -> int:
    """The Lloyd loop's largest grid on card ``dev`` for ``k`` clusters:
    the blocks of the kernel instance that fit on the card at once."""
    return _instance_grid(dev, _padded_k(k))


def _blocks_per_item(n_items: int, p: int, grid: int) -> int:
    return blocks_per_item(partition_items(n_items), p, grid, MIN_PER_BLOCK)


def _slice_resident(w: torch.Tensor, k: int) -> bool:
    """Whether the Lloyd loop over the CUDA tensor w (I, P) with ``k``
    clusters keeps each block's slice in shared memory (w read once, not
    once a step), by the kernel's own rule."""
    n_items, p = w.shape
    dev = w.get_device()
    grid = _grid(dev, k)
    vec = p % 4 == 0 and w.data_ptr() % 16 == 0
    return bool(KERNEL.query("kmeans_slice_resident",
                             [_ll, _ll, _i, _i, _i, _i])(
        n_items, p, k, _blocks_per_item(n_items, p, grid), grid, int(vec)))


def _checked(name: str, w: torch.Tensor, codebooks: torch.Tensor,
             ndim: int, meta: bool = False) -> None:
    """w (I, P) and codebooks (I, K) (``ndim`` 2), or w (P,) and one
    codebook (K,) (``ndim`` 1); ``meta``: meta tensors are taken too, by
    a wrapper that has a meta branch."""
    devices = ("cuda", "meta") if meta else ("cuda",)
    # one combined test on the launch path; the rules one by one below
    if (w.device.type in devices and w.dtype is _F32
            and codebooks.dtype is _F32
            and w.dim() == ndim == codebooks.dim() and w.numel() > 0
            and 1 <= codebooks.shape[-1] <= MAX_K
            and (ndim == 1 or codebooks.shape[0] == w.shape[0])
            and codebooks.device == w.device and w.is_contiguous()
            and codebooks.is_contiguous()):
        return
    if w.device.type not in devices:
        raise ValueError(f"{name}: no kernel for device {w.device}")
    if w.dtype != torch.float32 or codebooks.dtype != torch.float32:
        raise TypeError(f"{name} needs float32 operands, got {w.dtype} "
                        f"and {codebooks.dtype}")
    if (w.ndim != ndim or codebooks.ndim != ndim
            or (ndim == 2 and codebooks.shape[0] != w.shape[0])):
        want = "w (I, P) and codebooks (I, K)" if ndim == 2 else \
            "w (P,) and codebook (K,)"
        raise ValueError(f"{name}: need {want}, got {tuple(w.shape)} and "
                         f"{tuple(codebooks.shape)}")
    if not (w.numel() > 0 and 1 <= codebooks.shape[-1] <= MAX_K):
        raise ValueError(f"{name} takes I, P ≥ 1 and 1 ≤ K ≤ {MAX_K}; got "
                         f"w {tuple(w.shape)}, K={codebooks.shape[-1]}")
    if codebooks.device != w.device:
        raise ValueError(f"{name}: w and codebooks must be on one device")
    raise ValueError(f"{name} needs contiguous operands")


def kmeans_assign_moments_batched(w: torch.Tensor, codebooks: torch.Tensor):
    """w (I, P) f32, codebooks (I, K) f32 with K ≤ 256 → (assign (I, P)
    i32, sums (I, K) f32, counts (I, K) i32).

    On a CUDA tensor this launches the kernel's single pass on the
    current stream without synchronising; on a CPU tensor it runs the
    plain version."""
    if w.device.type == "cpu":
        return kmeans_assign_moments_batched_plain(w, codebooks)
    _checked("kmeans_assign_moments_batched", w, codebooks, 2)
    return _moments(w, codebooks, w.shape[0], KERNEL)


def kmeans_assign_moments(w: torch.Tensor, codebook: torch.Tensor):
    """K7: w (P,) f32, codebook (K,) f32 → (assign (P,) i32, sums (K,)
    f32, counts (K,) i32): the K1 kernel's I = 1 pass (the TPU kernel
    counts in f32 and pads the tail with ``codebook[0]``)."""
    if w.device.type == "cpu":
        return kmeans_assign_moments_plain(w, codebook)
    _checked("kmeans_assign_moments", w, codebook, 1)
    return _moments(w, codebook, 1, SINGLE)


def lloyd_cost(n_items: int, p: int, k: int,
               iters: int) -> tuple[float, float, str]:
    """(operations, boundary bytes, class) of one Lloyd loop launch, the
    function's least: a step places each element (one comparison at the
    least) and adds it to its cluster's sum and count, and the final
    pass places it once more, 3·iters + 1 an element; w read and the
    assignment written once, the codebooks read and written."""
    return (float(n_items * p * (3 * iters + 1)),
            8.0 * n_items * p + 8.0 * n_items * k, "f32")


def kmeans_lloyd_batched(w: torch.Tensor, codebooks: torch.Tensor,
                         iters: int):
    """The Lloyd loop in one launch: w (I, P) f32, ascending codebooks
    (I, K) f32 (+inf tails allowed) → (codebooks (I, K) f32 after
    ``iters`` steps of ``sort(where(counts > 0, sums / counts, cb))``,
    assign (I, P) i32 to them).

    On a CUDA tensor this is one launch on the current stream, with no
    host sync; it equals a loop of :func:`kmeans_assign_moments_batched`
    with that update done by torch, bit for bit. A grid that the card
    cannot place raises. On a CPU tensor it runs the plain loop."""
    if w.device.type == "cpu":
        return kmeans_lloyd_batched_plain(w, codebooks, iters)
    _checked("kmeans_lloyd_batched", w, codebooks, 2, meta=True)
    if not 0 <= iters < 2**31:
        raise ValueError(f"kmeans_lloyd_batched: iters must be ≥ 0, got "
                         f"{iters}")
    n_items, p = w.shape
    k = codebooks.shape[1]
    with op_stats.kernel("K1loop", *lloyd_cost(n_items, p, k, iters)):
        cb = torch.empty((n_items, k), dtype=_F32, device=w.device)
        assign = torch.empty((n_items, p), dtype=torch.int32,
                             device=w.device)
        if w.is_meta:
            return cb, assign
        dev = w.get_device()
        grid = _grid(dev, k)
        bpi = _blocks_per_item(n_items, p, grid)
        stream = raw_stream(dev)
        ws = stream_buffer("kmeans workspace", dev, stream,
                           2 * n_items * bpi * _padded_k(k) * 8, torch.uint8,
                           False)
        with on_card(dev):
            LLOYD(w.data_ptr(), codebooks.data_ptr(), n_items, p, k,
                  int(iters), bpi, grid, cb.data_ptr(), assign.data_ptr(),
                  ws.data_ptr(), ws.numel(), stream)
        return cb, assign


def _moments(w: torch.Tensor, codebooks: torch.Tensor, n_items: int,
             counter: LaunchCounter):
    """The single pass over checked operands of any rank: the outputs take
    the shapes of w and of the codebooks."""
    p = w.shape[-1]
    k = codebooks.shape[-1]
    dev = w.get_device()
    bpi = _blocks_per_item(n_items, p, _grid(dev, k))
    stream = raw_stream(dev)
    ws = stream_buffer("kmeans workspace", dev, stream,
                       n_items * bpi * _padded_k(k) * 8, torch.uint8, False)
    tickets = stream_buffer("kmeans tickets", dev, stream, n_items,
                            torch.int32, True)
    assign = torch.empty(w.shape, dtype=torch.int32, device=w.device)
    sums = torch.empty(codebooks.shape, dtype=_F32, device=w.device)
    counts = torch.empty(codebooks.shape, dtype=torch.int32, device=w.device)
    with on_card(dev):
        KERNEL(w.data_ptr(), codebooks.data_ptr(), n_items, p, k, bpi,
               assign.data_ptr(), sums.data_ptr(), counts.data_ptr(),
               tickets.data_ptr(), ws.data_ptr(), ws.numel(), stream,
               counter=counter)
    return assign, sums, counts
