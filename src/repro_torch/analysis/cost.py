"""Roofline cost model and group planner of the C step.

Port of ``src/repro/analysis/cost.py`` (``core/grouping.py`` wires it in
when a C step runs with ``planner="on"``):

* :class:`HardwareSpec`: peak rates and memory of one device kind,
  detected from the device (:func:`detect_hardware`): the H100 and the
  CPU. No TPU spec is carried over.
* :class:`GroupPlan`: one group's decisions (dispatch backend, chunk
  count) and the modeled roofline terms behind them.
* :func:`plan_group`: the analytic planner (per-solver FLOP factors over
  the packed shapes), cached on :func:`plan_key`, and
  :func:`get_executable`, the cache of captured group solves
  (``grouping.compile_group``). ``cache_stats()`` counts hits and misses
  of both, so repeated LC boundaries can be shown to replan and
  recapture nothing.

Functions of the reference with no CUDA meaning, and not ported:

* ``choose_block_rows``: the Pallas items-grid tile. The CUDA kernels
  size their grids themselves (K1 and K2 from the card's occupancy,
  ``kernels/build.py:blocks_per_item``).
* ``gemm_tiles``: K4/K5 pick their regime by M inside the launch
  (``kernels/quant_matmul/quant_matmul.py``).
* ``refine_with_hlo``: it reads XLA HLO, which PyTorch does not make;
  every plan is ``source="analytic"`` and says so in its fallbacks.

The module does not import ``core.grouping`` (grouping imports it).
"""
from __future__ import annotations

import dataclasses
from functools import lru_cache
from typing import Any, Callable

import torch

from repro_torch.tree import tree_leaves


# ---------------------------------------------------------------------------
# Hardware specs
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class HardwareSpec:
    """Peak-rate constants for one device kind.

    ``match`` is a lowercase substring of the card's name
    (``torch.cuda.get_device_name``) for :func:`detect_hardware`.
    """

    name: str
    match: str
    peak_flops: float      # f32 FLOP/s per chip
    hbm_bw: float          # bytes/s per chip
    link_bw: float         # interconnect bytes/s per chip (one direction)
    vmem_bytes: int        # fast on-chip memory a block can take
    hbm_bytes: int         # device memory per chip

    @property
    def ridge_intensity(self) -> float:
        """FLOP/byte above which a kernel is compute-bound."""
        return self.peak_flops / self.hbm_bw


#: H100 SXM at its 700 W limit: 3.35 TB/s of HBM3, 67 TFLOP/s f32 on the
#: CUDA cores (what the C-step kernels use), NVLink 4 at 900 GB/s both
#: ways (450 GB/s a direction), 227 KiB of shared memory a block.
#: ``hbm_bytes`` is the card's own, read by :func:`detect_hardware`.
H100 = HardwareSpec("h100", "h100", 67e12, 3.35e12, 450e9,
                    227 * 1024, 0)
#: deliberately coarse (one server socket), as in the JAX package: it
#: only ranks alternatives
CPU = HardwareSpec("cpu", "cpu", 1e12, 100e9, 25e9,
                   32 * 2**20, 64 * 2**30)

_KNOWN = (H100,)


@lru_cache(maxsize=None)
def _card_spec(index: int) -> HardwareSpec:
    name = torch.cuda.get_device_name(index)
    for spec in _KNOWN:
        if spec.match in name.lower():
            return dataclasses.replace(
                spec, hbm_bytes=int(torch.cuda.get_device_properties(
                    index).total_memory))
    raise ValueError(f"detect_hardware: no HardwareSpec for the CUDA card "
                     f"{name!r} (known: {[s.name for s in _KNOWN]})")


def detect_hardware(device=None) -> HardwareSpec:
    """The spec of ``device``: :data:`CPU` for the CPU (and for meta
    tensors' shapes); for a CUDA card the spec its name matches, with its
    own memory size. An unknown card raises. ``None`` means the current
    CUDA card."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type != "cuda":
        return CPU
    return _card_spec(dev.index if dev.index is not None
                      else torch.cuda.current_device())


# ---------------------------------------------------------------------------
# The plan record
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class GroupPlan:
    """One group's planner decisions plus the cost terms behind them.

    ``block_rows`` is always ``None`` (the kernels size their grids),
    ``shard_mode`` ``"none"`` (no mesh yet) and ``source``
    ``"analytic"``; ``fallbacks`` records every decision the planner
    could not make or apply, with its reason.
    """

    backend: str                    # dispatch backend ("torch"/"cuda"/...)
    solver: str | None              # registry solver (None: item by item)
    block_rows: int | None
    n_chunks: int                   # launches the packed group splits into
    shard_mode: str
    flops: float                    # modeled FLOPs for the whole group
    bytes: float                    # modeled device-memory traffic
    coll_bytes: float
    t_compute: float                # seconds at peak_flops
    t_memory: float                 # seconds at hbm_bw
    t_collective: float
    working_set_bytes: int          # packed operands + outputs resident
    source: str
    fallbacks: tuple[str, ...]
    hardware: str                   # HardwareSpec.name used

    @property
    def modeled_ms(self) -> float:
        return 1e3 * max(self.t_compute, self.t_memory, self.t_collective)

    @property
    def bottleneck(self) -> str:
        t = {"compute": self.t_compute, "memory": self.t_memory,
             "collective": self.t_collective}
        return max(t, key=t.get)

    def as_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["modeled_ms"] = self.modeled_ms
        d["bottleneck"] = self.bottleneck
        return d


# ---------------------------------------------------------------------------
# Caches
# ---------------------------------------------------------------------------

_PLAN_CACHE: dict[tuple, GroupPlan] = {}
_EXEC_CACHE: dict[tuple, Any] = {}
_STATS = {"plan_hits": 0, "plan_misses": 0,
          "exec_hits": 0, "exec_misses": 0}


def cache_stats() -> dict:
    """Copy of the hit/miss counters and the entries of both caches."""
    return dict(_STATS, plan_entries=len(_PLAN_CACHE),
                exec_entries=len(_EXEC_CACHE))


def clear_caches() -> None:
    _PLAN_CACHE.clear()
    _EXEC_CACHE.clear()
    for k in _STATS:
        _STATS[k] = 0


def _leaf_sig(x) -> tuple:
    return (tuple(getattr(x, "shape", ())),
            str(getattr(x, "dtype", type(x).__name__)))


def _structure(tree) -> str:
    """The container structure of a tree (the port's treedef)."""
    if isinstance(tree, dict):
        return "{" + ",".join(f"{k}:{_structure(v)}"
                              for k, v in tree.items()) + "}"
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree).__name__ + "(" + ",".join(
            _structure(v) for v in tree) + ")"
    if isinstance(tree, (tuple, list)):
        return "(" + ",".join(_structure(v) for v in tree) + ")"
    return "*"


def plan_key(signature, n_items, arrays, backend,
             hw: HardwareSpec) -> tuple:
    """Cache key of a group's plan and executable: the group signature
    (scheme batch key, item shape and dtype), the item count, the packed
    operands' shapes, dtypes and structure (tensors of any device, meta
    included), the requested backend and the hardware. The port has no
    mesh, so no mesh fingerprint."""
    if signature is None:
        signature = ("ungrouped",)
    return (tuple(signature), int(n_items),
            tuple(_leaf_sig(x) for x in tree_leaves(arrays)),
            _structure(arrays), str(backend), hw.name)


# ---------------------------------------------------------------------------
# Analytic cost model
# ---------------------------------------------------------------------------

# Coarse FLOPs-per-input-element factors per registry solver (the
# reference's): the planner compares a few discrete alternatives.
def _solver_flop_factor(solver: str | None, signature) -> float:
    if solver == "kmeans_lloyd":
        # iters × (K distances + onehot moments) per element
        k = _sig_field(signature, "k", 4)
        iters = _sig_field(signature, "iters", 25)
        return 3.0 * float(k) * float(iters)
    if solver == "topk_mask":
        return 2.0 * 30.0            # bisection feasibility sweeps
    if solver in ("lowrank_rsvd", "rank_select"):
        # sketch + power iters + finisher ≈ (2·POWER+2)·k matmul passes
        k = _sig_field(signature, "max_rank", 16) + 16
        return 2.0 * 8.0 * float(k) / 8.0
    if solver in ("project_l1_ball", "soft_threshold"):
        return 10.0                  # sort-dominated / elementwise
    return 20.0                      # unknown solver / item-by-item


def _sig_field(signature, name: str, default):
    """Best-effort scalar pull from a group signature tuple (they carry
    scheme batch_key entries like ``("quant-kmeans", 4, 25)``)."""
    flat = []

    def walk(x):
        if isinstance(x, tuple):
            for y in x:
                walk(y)
        else:
            flat.append(x)

    walk(tuple(signature))
    ints = [x for x in flat if isinstance(x, int) and not
            isinstance(x, bool)]
    if name == "k" and ints:
        return ints[0]
    if name == "iters" and len(ints) > 1:
        return ints[1]
    if name == "max_rank" and ints:
        return ints[-1]
    return default


def _tree_bytes(tree) -> int:
    total = 0
    for leaf in tree_leaves(tree):
        if isinstance(leaf, torch.Tensor):
            total += leaf.numel() * leaf.element_size()
    return total


def estimate_terms(signature, solver: str | None, arrays, out_shapes,
                   hw: HardwareSpec) -> dict:
    """Closed-form roofline terms for one packed group, whole-group (no
    mesh). ``arrays`` / ``out_shapes`` are trees of tensors, meta tensors
    included: only shapes and dtypes are read."""
    in_bytes = _tree_bytes(arrays)
    out_bytes = _tree_bytes(out_shapes)
    n_elems = max(1, in_bytes // 4)
    flops = _solver_flop_factor(solver, signature) * float(n_elems)
    total_bytes = float(in_bytes + out_bytes)
    return {
        "flops": flops,
        "bytes": total_bytes,
        "coll_bytes": 0.0,
        "t_compute": flops / hw.peak_flops,
        "t_memory": total_bytes / hw.hbm_bw,
        "t_collective": 0.0,
        "working_set_bytes": int(in_bytes + out_bytes),
        "chips": 1,
    }


# ---------------------------------------------------------------------------
# Decision helpers
# ---------------------------------------------------------------------------

#: test hook — force the chunk budget down so small groups split.
#: ``None`` means "derive from the hardware spec".
CHUNK_BUDGET_BYTES: int | None = None


def chunk_budget(hw: HardwareSpec) -> int:
    if CHUNK_BUDGET_BYTES is not None:
        return int(CHUNK_BUDGET_BYTES)
    # a packed group should leave headroom next to the train state:
    # cap its working set at 1/4 of device memory
    return hw.hbm_bytes // 4


def choose_backend(requested: str, solver: str | None,
                   registered: tuple[str, ...], terms: dict,
                   hw: HardwareSpec) -> tuple[str, list[str]]:
    """Pick the dispatch backend for a group; returns (backend,
    fallbacks).

    Explicit requests (``torch``, ``cuda``, ``off``) are honored; the
    planner decides only for ``auto``, as the static rule does
    (``kernels/dispatch.py:resolve_backend``): ``torch`` on the CPU, and
    on the card ``cuda`` where the solver has a CUDA implementation. The
    JAX package keeps tiny or compute-bound groups off its Pallas kernels
    (a 1 MiB threshold set for the TPU's launch overhead); the port keeps
    no threshold: on an NVIDIA H100 80GB HBM3 at 700 W every CUDA kernel
    of the C step beats its plain version at every size measured, down to
    the quickstart's Lloyd loop (0.17 ms against 5.19) and K7 at 235,200
    weights (0.050 ms against 0.206) (PERF.md §6, chip_smoke.py).
    ``terms`` is unused for that reason."""
    fallbacks: list[str] = []
    if requested != "auto":
        return requested, fallbacks
    if hw.name == CPU.name or solver is None:
        return "torch", fallbacks
    if "cuda" in registered:
        return "cuda", fallbacks
    fallbacks.append(f"backend:cuda-unregistered-for-{solver}->torch")
    return "torch", fallbacks


def choose_chunks(working_set_bytes: int, n_items: int,
                  hw: HardwareSpec) -> int:
    """Launch count for a packed group: split when the working set
    exceeds the chunk budget, never beyond one item per launch."""
    budget = max(1, chunk_budget(hw))
    n = -(-working_set_bytes // budget)      # ceil div
    return max(1, min(int(n), max(1, int(n_items))))


# ---------------------------------------------------------------------------
# The planner entry point
# ---------------------------------------------------------------------------

#: what every port plan lacks against the reference's
_NO_HLO = "hlo-refine:not-ported(no XLA HLO)"


def plan_group(signature, n_items, arrays, out_shapes, *,
               requested_backend: str, solver: str | None,
               registered: tuple[str, ...] = (),
               chunk_exact: tuple[str, ...] = (),
               base_fallbacks: tuple = (),
               hw: HardwareSpec) -> GroupPlan:
    """Plan one packed group. Cached on :func:`plan_key` (the chunk
    budget is not in the key: :func:`clear_caches` after changing
    ``CHUNK_BUDGET_BYTES``). ``registered`` lists the dispatch backends
    carrying ``solver``, ``chunk_exact`` those whose launches over item
    slices equal one launch bit for bit (``kernels/dispatch.py:
    chunk_exact``; the item-by-item path, ``solver`` None, always is): a
    group over the budget on any other backend stays in one launch, and
    the plan says so. ``base_fallbacks`` pre-records caller-side
    decisions, so that an analytic plan is never silent about why."""
    key = plan_key(signature, n_items, arrays, requested_backend, hw)
    cached = _PLAN_CACHE.get(key)
    if cached is not None:
        _STATS["plan_hits"] += 1
        return cached
    _STATS["plan_misses"] += 1

    terms = estimate_terms(signature, solver, arrays, out_shapes, hw)
    backend, fallbacks = choose_backend(requested_backend, solver,
                                        registered, terms, hw)
    fallbacks = list(base_fallbacks) + fallbacks + [_NO_HLO]
    n_chunks = choose_chunks(terms["working_set_bytes"], n_items, hw)
    if n_chunks > 1 and solver is not None and backend not in chunk_exact:
        fallbacks.append(f"chunking-disabled:{solver}-on-{backend}-"
                         f"depends-on-the-batch")
        n_chunks = 1
    plan = GroupPlan(
        backend=backend, solver=solver, block_rows=None,
        n_chunks=n_chunks, shard_mode="none",
        flops=terms["flops"], bytes=terms["bytes"],
        coll_bytes=terms["coll_bytes"], t_compute=terms["t_compute"],
        t_memory=terms["t_memory"], t_collective=terms["t_collective"],
        working_set_bytes=terms["working_set_bytes"], source="analytic",
        fallbacks=tuple(fallbacks), hardware=hw.name)
    _PLAN_CACHE[key] = plan
    return plan


# ---------------------------------------------------------------------------
# Executable cache
# ---------------------------------------------------------------------------

def get_executable(key: tuple, build: Callable[[], Any]):
    """Fetch (or build and insert) the executable for ``key``: ``build``
    runs once per key (``grouping.compile_group``'s captured solve), so
    repeated LC boundaries hit the cache."""
    exe = _EXEC_CACHE.get(key)
    if exe is not None:
        _STATS["exec_hits"] += 1
        return exe
    _STATS["exec_misses"] += 1
    exe = build()
    _EXEC_CACHE[key] = exe
    return exe
