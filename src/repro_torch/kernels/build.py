"""Build and bind the port's CUDA C++ kernels.

Each source under ``csrc/`` has a plain C interface. At first use it is
compiled with ``nvcc`` for ``sm_90a`` into
``<checkout>/build/repro_torch/<stem>-<hash>.so`` (the hash covers the
source and the flags, so an edited source rebuilds) and loaded with
``ctypes``. :func:`build` compiles several sources at once, one ``nvcc``
process each. A failed build or a failed launch raises; nothing falls
back to another implementation.

:func:`on_card` and :func:`raw_stream` keep a launch's host work small:
the device switch only when the card is not the current one, and
PyTorch's current stream as a plain handle, without building a
``torch.cuda.Stream``. :func:`stream_buffer` keeps the workspaces and
counters that launches on one stream share; :func:`stream_buffers` lists
a stream's buffers for a CUDA graph captured on it (``graphs.py``).
Every :class:`LaunchCounter` is registered, so that a capture can take
its own counts back out (:func:`launch_counts`).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import weakref
from contextlib import nullcontext
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
SOURCES = ("kmeans_assign_moments.cu", "count_above.cu", "mask_apply.cu",
           "quant_matmul.cu", "flash_attention.cu")


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError(
            "nvcc not found: the CUDA kernels need the CUDA toolkit "
            "(nvcc on PATH or under /usr/local/cuda/bin)")
    return path


def library_path(source: str) -> Path:
    src = CSRC / source
    digest = hashlib.sha256(
        src.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"{src.stem}-{digest}.so"


def build(sources=SOURCES) -> dict[str, str]:
    """Compile every source of ``sources`` that is not built yet, all
    ``nvcc`` processes started together. Returns ``{source: nvcc log}``
    for the sources compiled by this call (``-Xptxas -v`` puts each
    kernel's registers and shared memory in the log)."""
    todo = [s for s in sources if not library_path(s).exists()]
    if not todo:
        return {}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    try:
        for s in todo:
            tmp = library_path(s).with_suffix(f".{os.getpid()}.tmp")
            procs[s] = (subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / s)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True), tmp)
        logs, failed = {}, []
        for s, (proc, tmp) in procs.items():
            logs[s], _ = proc.communicate()
            if proc.returncode:
                failed.append(f"nvcc failed on {s}:\n{logs[s]}")
            else:
                os.replace(tmp, library_path(s))
        if failed:
            raise RuntimeError("\n".join(failed))
        return logs
    finally:
        for proc, tmp in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            tmp.unlink(missing_ok=True)


def on_card(device_index: int):
    """A context in which card ``device_index`` is the current one: a
    no-op when it already is."""
    if device_index == torch._C._cuda_getDevice():
        return nullcontext()
    return torch.cuda.device(device_index)


def raw_stream(device_index: int) -> int:
    """The handle of PyTorch's current stream on card ``device_index``."""
    return torch._C._cuda_getCurrentRawStream(device_index)


_BUFFERS: dict[tuple[str, int, int], torch.Tensor] = {}


def stream_buffer(name: str, device_index: int, stream: int, n: int,
                  dtype: torch.dtype, zeroed: bool) -> torch.Tensor:
    """The buffer ``name`` of card ``device_index`` for stream ``stream``
    (a raw handle), grown to at least ``n`` elements (``zeroed``: filled
    with zeros when made). One stream's launches run in order, so they
    can share a workspace that each launch overwrites before it reads it,
    or counters that each launch leaves zero; two streams get two.

    A CUDA graph's kernels keep the buffers of the stream they were
    captured on, so a capture stream's buffers are made before its
    capture begins (``graphs.py`` runs each program once eagerly on that
    stream first): one made during the capture would come from the
    graph's pool while this dict held it, so that raises. A graph holds
    the buffers it was captured with (:func:`stream_buffers`), and a
    buffer grown later for the same stream is a new one."""
    key = (name, device_index, stream)
    buf = _BUFFERS.get(key)
    if buf is None or buf.numel() < n:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError(
                f"stream_buffer: {name} of stream {stream:#x} would be made "
                f"during a CUDA graph capture; run the program once on the "
                f"capture stream before capturing it")
        make = torch.zeros if zeroed else torch.empty
        buf = make(n, dtype=dtype, device=torch.device("cuda", device_index))
        _BUFFERS[key] = buf
    return buf


def stream_buffers(device_index: int, stream: int) -> list[torch.Tensor]:
    """Every buffer that :func:`stream_buffer` holds for card
    ``device_index``'s stream ``stream``."""
    return [b for (_, d, s), b in _BUFFERS.items()
            if (d, s) == (device_index, stream)]


def blocks_per_item(n_items: int, p: int, grid: int,
                    min_per_block: int) -> int:
    """Blocks (slices) of each of ``n_items`` items of ``p`` elements for
    a persistent grid of ``grid`` blocks: the grid shared out over the
    items, at least ``min_per_block`` elements a slice; one (whole items
    in turn) when there are more items than blocks."""
    if n_items > grid:
        return 1
    return max(1, min(grid // n_items, -(-p // min_per_block)))


_COUNTERS: weakref.WeakSet = weakref.WeakSet()


class LaunchCounter:
    """The launch count of one wrapper. A kernel is its own counter; a
    wrapper that shares another's kernel (K7 and K8 launch the K1 and K2
    entry points at I = 1) passes its own to :meth:`CudaKernel.__call__`.
    Every counter made is registered for :func:`launch_counts`."""

    def __init__(self):
        self.launches = 0
        _COUNTERS.add(self)


def launch_counts() -> dict[LaunchCounter, int]:
    """Every live counter's launches."""
    return {c: c.launches for c in list(_COUNTERS)}


class CudaKernel(LaunchCounter):
    """One C entry point of a ``csrc/`` source, built and loaded at its
    first launch (under a lock; later calls take none). The entry point
    returns a ``cudaError_t``; a nonzero one raises. Each successful
    launch adds one to ``counter`` (default: the kernel's own
    ``launches``)."""

    def __init__(self, source: str, symbol: str, argtypes: list):
        super().__init__()
        self.source = source
        self.symbol = symbol
        self.argtypes = argtypes
        self._fn = None
        self._lock = threading.Lock()

    def _load(self):
        with self._lock:
            if self._fn is None:
                build([self.source])
                lib = ctypes.CDLL(str(library_path(self.source)))
                fn = getattr(lib, self.symbol)
                fn.argtypes = self.argtypes
                fn.restype = ctypes.c_int
                self._lib, self._fn = lib, fn
        return self._fn

    def query(self, symbol: str, argtypes: list, restype=ctypes.c_int):
        """Another C function of the same source that launches nothing (a
        grid or workspace query), bound with ``restype``."""
        if self._fn is None:
            self._load()
        fn = getattr(self._lib, symbol)
        fn.argtypes = argtypes
        fn.restype = restype
        return fn

    def __call__(self, *args, counter: LaunchCounter | None = None) -> None:
        fn = self._fn
        err = (self._load() if fn is None else fn)(*args)
        if err:
            raise RuntimeError(
                f"{self.symbol} ({self.source}): CUDA launch failed with "
                f"cudaError_t {err}")
        (counter or self).launches += 1
