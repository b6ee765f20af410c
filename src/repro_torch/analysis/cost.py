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

``refine_with_hlo`` becomes :func:`refine_with_counts`: where the
reference lowers a group to HLO and counts it, the port runs the group's
solve on meta tensors under ``op_stats.OpCounter``
(``core/grouping.py:count_group``) and takes its terms from the counted
ops.

The module does not import ``core.grouping`` (grouping imports it).
"""
from __future__ import annotations

import dataclasses
import math
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
    tf32_flops: float = 0.0   # TF32 tensor-core FLOP/s (one pass)
    bf16_flops: float = 0.0   # bf16 tensor-core FLOP/s
    nic_bw: float = 0.0       # bytes/s per chip to other nodes (one way)
    node_size: int = 1        # chips joined by ``link_bw`` in one node

    @property
    def ridge_intensity(self) -> float:
        """FLOP/byte above which a kernel is compute-bound."""
        return self.peak_flops / self.hbm_bw


#: H100 SXM at its 700 W limit, dense rates of NVIDIA's spec sheet (not
#: measured): 3.35 TB/s of HBM3, 67 TFLOP/s f32 on the CUDA cores (what
#: the C-step kernels and cuBLAS's f32 products with TF32 off use), 494.7
#: TFLOP/s TF32 and 989.4 TFLOP/s bf16 on the tensor cores, NVLink 4 at
#: 900 GB/s both ways (450 GB/s a direction) among the 8 GPUs of an HGX
#: node, one 400 Gb/s NDR NIC a GPU (50 GB/s) between nodes, 227 KiB of
#: shared memory a block. ``hbm_bytes`` is the card's own, read by
#: :func:`detect_hardware`.
H100 = HardwareSpec("h100", "h100", 67e12, 3.35e12, 450e9,
                    227 * 1024, 0, tf32_flops=494.7e12,
                    bf16_flops=989.4e12, nic_bw=50e9, node_size=8)
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

#: what a plan counts at its first read (:meth:`GroupPlan.terms`)
_COUNTED = ("flops", "bytes", "coll_bytes", "t_compute", "t_memory",
            "t_collective", "source", "fallbacks")


def _counted(name: str) -> property:
    return property(lambda self: self.terms()[name])


@dataclasses.dataclass(frozen=True)
class GroupPlan:
    """One group's planner decisions plus the cost terms behind them.

    ``block_rows`` is always ``None`` (the kernels size their grids).
    ``source`` is ``"counted"`` where the terms come from the group's
    counted solve (:func:`refine_with_counts`), else ``"analytic"``, and
    then ``fallbacks`` says why. ``shard_mode`` is ``"none"`` without a mesh
    (or where the ``"items"`` rule resolves no axis), ``"sharded"`` where
    each rank of the mesh's data axis solves its block of the items and
    the blocks are gathered (``core/grouping.py``), ``"replicated"``
    where every rank solves the whole group (a solver whose bits depend
    on the batch). ``fallbacks`` records every decision the planner could
    not make or apply, with its reason.

    The decisions (the fields) are fixed when the plan is made. The
    terms, ``source`` and ``fallbacks`` are counted at their first read
    (:meth:`terms`) and kept: the C step reads only the decisions, so it
    counts nothing, while ``group_summary`` and the lint read the terms.
    ``plan[key]`` reads any of them by name, as the reference's plan
    dict.
    """

    backend: str                    # dispatch backend ("torch"/"cuda"/...)
    solver: str | None              # registry solver (None: item by item)
    block_rows: int | None
    n_chunks: int                   # launches the packed group splits into
    shard_mode: str                 # "none" | "sharded" | "replicated"
    working_set_bytes: int          # packed operands + outputs resident
    hardware: str                   # HardwareSpec.name used
    # the analytic terms, source and fallbacks, and "refine": the count
    # that replaces them at the first read (None once it ran)
    _terms: dict = dataclasses.field(repr=False, compare=False)

    def terms(self) -> dict:
        """The cost terms, ``source`` and ``fallbacks``, refined from the
        group's counted solve the first time they are read."""
        refine = self._terms["refine"]
        if refine is not None:
            self._terms.update(refine(), refine=None)
        return self._terms

    flops = _counted("flops")            # modeled FLOPs for the whole group
    bytes = _counted("bytes")            # modeled device-memory traffic
    coll_bytes = _counted("coll_bytes")
    t_compute = _counted("t_compute")    # seconds at peak_flops
    t_memory = _counted("t_memory")      # seconds at hbm_bw
    t_collective = _counted("t_collective")
    source = _counted("source")
    fallbacks = _counted("fallbacks")

    @property
    def modeled_ms(self) -> float:
        return 1e3 * max(self.t_compute, self.t_memory, self.t_collective)

    @property
    def bottleneck(self) -> str:
        t = {"compute": self.t_compute, "memory": self.t_memory,
             "collective": self.t_collective}
        return max(t, key=t.get)

    def __getitem__(self, key: str):
        if key not in _PLAN_KEYS:
            raise KeyError(key)
        return getattr(self, key)


_PLAN_KEYS = tuple(f.name for f in dataclasses.fields(GroupPlan)
                   if f.repr) + _COUNTED + ("modeled_ms", "bottleneck")


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


def _mesh_fingerprint(mesh) -> tuple:
    """A mesh's axis names and sizes (``None``: no mesh)."""
    if mesh is None:
        return ("no-mesh",)
    return (tuple(mesh.mesh_dim_names), tuple(int(n) for n in mesh.shape))


def plan_key(signature, n_items, arrays, backend,
             hw: HardwareSpec, mesh=None) -> tuple:
    """Cache key of a group's plan and executable: the group signature
    (scheme batch key, item shape and dtype), the item count, the packed
    operands' shapes, dtypes and structure (tensors of any device, meta
    included), the mesh's axis names and sizes, the requested backend and
    the hardware."""
    if signature is None:
        signature = ("ungrouped",)
    return (tuple(signature), int(n_items),
            tuple(_leaf_sig(x) for x in tree_leaves(arrays)),
            _structure(arrays), _mesh_fingerprint(mesh), str(backend),
            hw.name)


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
                   hw: HardwareSpec, mesh=None,
                   shard_items: bool = False) -> dict:
    """Closed-form roofline terms for one packed group, as the
    reference's: per rank when ``shard_items`` (the item axis split over
    the mesh), else whole-group, with a replicated solve's outputs
    counted as the collective term. ``arrays`` / ``out_shapes`` are trees
    of tensors, meta tensors included: only shapes and dtypes are
    read."""
    in_bytes = _tree_bytes(arrays)
    out_bytes = _tree_bytes(out_shapes)
    n_elems = max(1, in_bytes // 4)
    flops = _solver_flop_factor(solver, signature) * float(n_elems)
    total_bytes = float(in_bytes + out_bytes)
    chips = 1
    coll_bytes = 0.0
    if mesh is not None and math.prod(int(n) for n in mesh.shape) > 1:
        chips = math.prod(int(n) for n in mesh.shape)
        if shard_items:
            flops /= chips
            total_bytes /= chips
        else:
            coll_bytes = float(out_bytes)
    return {
        "flops": flops,
        "bytes": total_bytes,
        "coll_bytes": coll_bytes,
        "t_compute": flops / hw.peak_flops,
        "t_memory": total_bytes / hw.hbm_bw,
        "t_collective": coll_bytes / hw.link_bw if coll_bytes else 0.0,
        "working_set_bytes": int(in_bytes + out_bytes),
        "chips": chips,
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

def refine_with_counts(stats, terms: dict, hw: HardwareSpec) -> dict:
    """Replace the analytic FLOP and byte terms with the counted ones of
    ``stats`` (an ``op_stats.Stats`` of the group's solve), the
    counterpart of the reference's ``refine_with_hlo``; the collective
    bytes come from the same count. A term the count leaves at zero keeps
    the analytic value, as in the reference. FLOPs are rated at the
    card's f32 peak, as the analytic terms are."""
    refined = dict(terms)
    if stats.flops > 0:
        refined["flops"] = float(stats.flops)
        refined["t_compute"] = stats.flops / hw.peak_flops
    if stats.bytes > 0:
        refined["bytes"] = float(stats.bytes)
        refined["t_memory"] = stats.bytes / hw.hbm_bw
    coll = float(stats.coll_bytes)
    refined["coll_bytes"] = coll
    refined["t_collective"] = coll / hw.link_bw if coll else 0.0
    return refined


#: a plan under a mesh keeps its analytic terms, as the reference's
_UNDER_MESH = "count-refine-skipped:under-mesh"


def plan_group(signature, n_items, arrays, out_shapes, *,
               requested_backend: str, solver: str | None,
               registered: tuple[str, ...] = (),
               chunk_exact: tuple[str, ...] = (),
               base_fallbacks: tuple = (),
               hw: HardwareSpec, mesh=None,
               count_fn: Callable, items_entry=None) -> GroupPlan:
    """Plan one packed group. Cached on :func:`plan_key` (the chunk
    budget is not in the key: :func:`clear_caches` after changing
    ``CHUNK_BUDGET_BYTES``). ``registered`` lists the dispatch backends
    carrying ``solver``, ``chunk_exact`` those whose launches over item
    slices equal one launch bit for bit (``kernels/dispatch.py:
    chunk_exact``; the item-by-item path, ``solver`` None, always is): a
    group over the budget on any other backend stays in one launch, and
    the plan says so. ``base_fallbacks`` pre-records caller-side
    decisions, so that an analytic plan is never silent about why.

    Under a ``mesh`` whose ``"items"`` rule resolves ``items_entry`` (not
    None), a group whose solver is chunk-exact on the chosen backend is
    ``"sharded"`` (each rank solves its block of the items, as a chunk of
    the group) and never chunks: the plan records the reference's
    ``chunking-disabled-under-mesh`` where it would have; any other group
    is ``"replicated"``, with the reason in ``fallbacks``.

    Without a mesh, ``count_fn(backend)`` (the group's solve counted on
    meta tensors, ``grouping.count_group``) refines the terms
    (:func:`refine_with_counts`, ``source="counted"``) when they are
    first read (:meth:`GroupPlan.terms`); where it raises, the plan
    records ``count-refine-failed:<exception>`` and keeps the analytic
    terms. The refinement replaces only the terms: the backend, the
    chunks and the shard mode stay the analytic plan's, as in the
    reference."""
    key = plan_key(signature, n_items, arrays, requested_backend, hw, mesh)
    cached = _PLAN_CACHE.get(key)
    if cached is not None:
        _STATS["plan_hits"] += 1
        return cached
    _STATS["plan_misses"] += 1

    terms = estimate_terms(signature, solver, arrays, out_shapes, hw)
    backend, fallbacks = choose_backend(requested_backend, solver,
                                        registered, terms, hw)
    fallbacks = list(base_fallbacks) + fallbacks
    exact = solver is None or backend in chunk_exact
    shard_mode = "none"
    if mesh is not None and items_entry is not None:
        shard_mode = "sharded" if exact else "replicated"
        if not exact:
            fallbacks.append(f"replicated-under-mesh:{solver}-on-{backend}-"
                             f"not-chunk-exact")
        terms = estimate_terms(signature, solver, arrays, out_shapes, hw,
                               mesh=mesh, shard_items=exact)
    n_chunks = choose_chunks(terms["working_set_bytes"], n_items, hw)
    if n_chunks > 1 and shard_mode == "sharded":
        fallbacks.append("chunking-disabled-under-mesh")
        n_chunks = 1
    if n_chunks > 1 and not exact:
        fallbacks.append(f"chunking-disabled:{solver}-on-{backend}-"
                         f"depends-on-the-batch")
        n_chunks = 1
    fallbacks = tuple(fallbacks)
    refine = None
    if mesh is not None:
        fallbacks += (_UNDER_MESH,)
    else:
        def refine() -> dict:
            try:
                return dict(refine_with_counts(count_fn(backend), terms, hw),
                            source="counted")
            except Exception as e:  # noqa: BLE001 — recorded in the plan
                return {"fallbacks": fallbacks + (
                    f"count-refine-failed:{type(e).__name__}",)}
    plan = GroupPlan(
        backend=backend, solver=solver, block_rows=None,
        n_chunks=n_chunks, shard_mode=shard_mode,
        working_set_bytes=terms["working_set_bytes"], hardware=hw.name,
        _terms=dict(terms, source="analytic", fallbacks=fallbacks,
                    refine=refine))
    _PLAN_CACHE[key] = plan
    return plan


# ---------------------------------------------------------------------------
# Executable cache
# ---------------------------------------------------------------------------

def get_executable(key: tuple, build: Callable[[], Any],
                   cache: dict | None = None):
    """Fetch (or build and insert) the executable for ``key``: ``build``
    runs once per key (``grouping.compile_group``'s captured solve), so
    repeated LC boundaries hit the cache. ``cache`` is an owner's own
    (the LC driver's, whose graphs go with it); the module's by
    default. Hits and misses are counted either way."""
    cache = _EXEC_CACHE if cache is None else cache
    exe = cache.get(key)
    if exe is not None:
        _STATS["exec_hits"] += 1
        return exe
    _STATS["exec_misses"] += 1
    exe = build()
    cache[key] = exe
    return exe
