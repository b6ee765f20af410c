"""Op-level cost counter of one eager step: FLOPs, bytes, collectives,
kernel launches and live memory.

The counterpart of ``src/repro/analysis/hlo_stats.py``. The reference
parses the partitioned HLO of a compiled step; PyTorch runs the step
eagerly, so the port counts the program it runs, op by op, under a
``TorchDispatchMode`` (:class:`OpCounter`): on meta tensors (the dry run,
``launch/dryrun.py``, where nothing is allocated and no kernel runs) or
on the card (the same counts, which check the dry run against a real
step). No compiler is in the loop:

* FLOPs: the matmul-family aten ops (``mm``, ``addmm``, ``bmm``,
  ``baddbmm``) by ``torch.utils.flop_counter``'s formulas (2·M·N·K, the
  reference's dot FLOPs), by class: ``"f32"`` products run on the CUDA
  cores (cuBLAS with TF32 off), ``"bf16"`` (bf16 and f16) on the tensor
  cores. Python loops unroll, so there is no trip count to multiply.
  Each hand-written kernel records its own FLOPs and class (``"tf32"``:
  the 3-pass TF32 split of K4, K5 and K6; ``"f32"``: the decode GEMV),
  its boundary bytes and one launch (:func:`kernel`), from the same
  function on meta tensors, where its wrapper only allocates its output,
  as on the card; the aten ops inside a kernel's wrapper count in
  nothing but memory.
* ``bytes``: operands + outputs of every aten op that moves data (views,
  bare allocations and host reads move none). Eager PyTorch fuses
  nothing, so this is the reference's ``bytes`` at op granularity;
  ``bytes_major`` follows the reference's rule: products, reductions,
  gathers and scatters their operands + outputs, any other op 2× its
  output.
* :func:`scope` is the counterpart of ``jax.named_scope``: the ops of a
  scope that the counter skips (``skip_scopes``) count FLOPs but no
  bytes, in the backward pass too (the caller adds the fused kernel's
  analytic bytes, as the reference's ``skip_scopes`` and
  ``extra_bytes_per_chip``).
* collectives: ``distributed/sharding.py`` calls every
  ``torch.distributed`` collective of the port through one function,
  which reports each here (:func:`record_collective`: primitive, output
  bytes, group size, mesh axes) before it issues it, or instead of
  issuing it on a dry run's recording group.
* memory: the bytes of the device storages the step allocates, keyed by
  storage (views share one), each rounded up to the CUDA caching
  allocator's 512-byte blocks, from allocation to release;
  ``peak_bytes`` is their peak above what the step was given
  (``arg_bytes``), the counterpart of ``compiled.memory_analysis()``.

Ops whose tensors all lie on the CPU (host scalars, the RNG states a
checkpoint keeps) count in nothing: the counts are the device's. A
counter made with ``cpu=True`` counts them too, for a run whose device is
the CPU (the lint's ``--device cpu``); its ``host`` tensors (the sketch
seeds, a CPU tensor on every device) stay host values there.
:func:`repeated` counts a loop run once for its trip count, where the
trips differ only in values (the Jacobi rounds of the low-rank solvers on
meta tensors): the counterpart of the reference's trip counts.

The reference's lint helpers over a step's counts: :func:`linalg_ops`,
:func:`host_reads` (``aten._local_scalar_dense`` of a device tensor, or a
copy of one to the host: a sync on the card, an error on meta),
:func:`f64_ops`, :func:`call_targets` (the counterpart of
``custom_call_targets``: the hand-written kernels a counted call
launched, by each wrapper's report and launch counter, and the library
linear-algebra ops) and :func:`input_output_alias` (the counterpart of
``parse_input_output_alias``: the arguments whose storages a call's
outputs still hold).
"""
from __future__ import annotations

import contextlib
import weakref
from collections import Counter
from dataclasses import dataclass, field

import torch
from torch.utils._python_dispatch import (
    TorchDispatchMode, _get_current_dispatch_mode_stack)

aten = torch.ops.aten

#: the matmul family whose FLOPs count (the reference counts dots only)
MATMULS = (aten.mm, aten.addmm, aten.bmm, aten.baddbmm)
#: ops read and written whole in ``bytes_major`` (the reference's dot,
#: reduce, sort, gather and scatter)
_MAJOR = frozenset({
    "mm", "addmm", "bmm", "baddbmm", "convolution", "sum", "mean", "amax",
    "amin", "max", "min", "prod", "logsumexp", "_softmax", "_log_softmax",
    "linalg_vector_norm", "norm", "var", "std", "argmax", "argmin",
    "cumsum", "sort", "topk", "gather", "scatter", "scatter_add",
    "scatter_reduce", "index", "index_select", "index_add", "index_put",
    "_index_put_impl", "index_copy", "embedding", "embedding_dense_backward",
    "_softmax_backward_data", "_log_softmax_backward_data"})
#: ops that move no data: bare allocations, aliases, host reads
_NO_DATA = frozenset({
    "empty", "empty_like", "empty_strided", "new_empty",
    "new_empty_strided", "_unsafe_view", "detach", "alias", "lift_fresh",
    "_local_scalar_dense", "set_", "resize_", "sym_size", "sym_stride",
    "sym_numel", "sym_storage_offset"})
_LINALG = frozenset({"svd", "qr", "cholesky", "cholesky_inverse",
                     "triangular_solve", "geqrf", "orgqr", "ormqr", "lu",
                     "eig", "symeig"})
#: CUDA's caching allocator hands out blocks in multiples of 512 bytes
BLOCK = 512
_SCOPE_KEY = "op_stats_scope"


def _name(func) -> str:
    """The op's name without an in-place op's trailing underscore."""
    name = func.overloadpacket.__name__
    return name[:-1] if name.endswith("_") and not name.endswith("__") \
        else name


def _tensors(tree, out: list | None = None) -> list:
    """The tensors of nested lists, tuples and dicts, in order."""
    out = [] if out is None else out
    if isinstance(tree, torch.Tensor):
        out.append(tree)
    elif isinstance(tree, (list, tuple)):
        for x in tree:
            _tensors(x, out)
    elif isinstance(tree, dict):
        for x in tree.values():
            _tensors(x, out)
    return out


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def flop_class(dtype: torch.dtype) -> str:
    """The unit a product of ``dtype`` operands runs on: ``"bf16"`` (the
    tensor cores, bf16 and f16) or ``"f32"`` (the CUDA cores; the port
    leaves TF32 off)."""
    return "bf16" if dtype in (torch.bfloat16, torch.float16) else "f32"


@dataclass
class Collective:
    primitive: str          # "all-reduce" | "all-gather" | "barrier"
    bytes: float            # output bytes
    size: int               # ranks in the group
    axes: tuple | None      # mesh axes of a dry run's group (else None)


@dataclass
class Stats:
    """One step's counts, per rank. The first six fields are the
    reference's (``hlo_stats.Stats``)."""

    flops: float = 0.0
    bytes: float = 0.0        # operands + outputs of every data op
    bytes_major: float = 0.0  # products/reductions/gathers I/O + 2× out
    coll: dict = field(default_factory=dict)   # primitive -> bytes
    coll_count: float = 0.0
    flops_by_class: dict = field(default_factory=dict)  # f32/tf32/bf16
    ops: Counter = field(default_factory=Counter)       # aten op tally
    launches: Counter = field(default_factory=Counter)  # kernel launches
    kernel_bytes: float = 0.0     # kernels' boundary bytes (in ``bytes``)
    collectives: list = field(default_factory=list)     # Collective
    arg_bytes: float = 0.0        # storages the step was given
    peak_bytes: float = 0.0       # peak of the step's own live storages
    skipped_ops: int = 0          # ops of skipped scopes (no bytes)
    host_reads: list = field(default_factory=list)
    linalg: list = field(default_factory=list)
    f64: list = field(default_factory=list)
    #: launches by the kernels' launch counters (``kernels/build.py``),
    #: by label: what ran on the card while the counter was entered
    wrapper_launches: Counter = field(default_factory=Counter)

    def add(self, other: "Stats", mult: float = 1.0):
        self.flops += other.flops * mult
        self.bytes += other.bytes * mult
        self.bytes_major += other.bytes_major * mult
        for k, v in other.coll.items():
            self.coll[k] = self.coll.get(k, 0.0) + v * mult
        self.coll_count += other.coll_count * mult
        for k, v in other.flops_by_class.items():
            self.flops_by_class[k] = self.flops_by_class.get(k, 0.0) \
                + v * mult

    @property
    def coll_bytes(self) -> float:
        return sum(self.coll.values())

    def coll_by_axes(self) -> dict:
        """``{mesh axes: output bytes}`` of the collectives (``None``
        for a real group's)."""
        out: dict = {}
        for c in self.collectives:
            out[c.axes] = out.get(c.axes, 0.0) + c.bytes
        return out


class _TagGradFns(torch.overrides.TorchFunctionMode):
    """Inside a skipped scope: tags the autograd nodes made there, so
    that the backward pass's ops of the scope are skipped too."""

    def __init__(self, name: str):
        super().__init__()
        self.name = name

    def __torch_function__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in _tensors(out):
            if t.grad_fn is not None:
                t.grad_fn.metadata[_SCOPE_KEY] = self.name
        return out


def _backward_scope():
    node = getattr(torch._C, "_current_autograd_node", lambda: None)()
    return None if node is None else node.metadata.get(_SCOPE_KEY)


class OpCounter(TorchDispatchMode):
    """Counts every aten op run inside it (module docstring) into
    ``self.stats``. ``args``: what the step is given (their storages are
    ``arg_bytes`` and do not count in the step's peak). ``cpu``: count
    ops on CPU tensors too (a run whose device is the CPU); ``host``:
    tensors that are host values by design, whose reads are not host
    reads."""

    def __init__(self, skip_scopes: tuple = (), args=(), cpu: bool = False,
                 host=()):
        super().__init__()
        self.skip_scopes = tuple(skip_scopes)
        self.stats = Stats()
        self.cpu = bool(cpu)
        self._host = {t.untyped_storage()._cdata for t in _leaves(host)}
        self._mult = 1
        self._scopes: list = []
        self._kernel = 0
        self._live: dict = {}
        self._seen = set()
        self._cur = 0
        self._launch0: dict = {}
        for t in _leaves(args):
            key = _storage_key(t)
            if key is not None and key not in self._seen:
                self._seen.add(key)
                self.stats.arg_bytes += _rounded(t.untyped_storage().nbytes())

    def __enter__(self):
        from repro_torch.kernels.build import launch_counts
        self._launch0 = launch_counts()
        return super().__enter__()

    def __exit__(self, *exc):
        from repro_torch.kernels.build import launch_counts
        for c, n in launch_counts().items():
            d = n - self._launch0.get(c, 0)
            if d:
                self.stats.wrapper_launches[c.label] += d
        return super().__exit__(*exc)

    def _on_device(self, t: torch.Tensor) -> bool:
        """Whether ``t`` is the step's device data (not a host value)."""
        if not t.is_cpu:
            return True
        return self.cpu and t.untyped_storage()._cdata not in self._host

    def _skipping(self) -> bool:
        if any(s in self.skip_scopes for s in self._scopes):
            return True
        return bool(self.skip_scopes) and \
            _backward_scope() in self.skip_scopes

    # -- memory ---------------------------------------------------------
    def _track(self, t: torch.Tensor) -> None:
        key = _storage_key(t)
        if key is None or key in self._live or key in self._seen:
            return
        st = t.untyped_storage()
        n = _rounded(st.nbytes())
        self._live[key] = n
        self._cur += n
        self.stats.peak_bytes = max(self.stats.peak_bytes, self._cur)
        weakref.finalize(st, self._free, key)

    def _free(self, key) -> None:
        self._cur -= self._live.pop(key, 0)

    # -- every op ---------------------------------------------------------
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        name = _name(func)
        st = self.stats
        ins = _tensors((args, kwargs))
        if name == "_local_scalar_dense" and ins and self._on_device(ins[0]):
            st.host_reads.append(str(ins[0].device))
        out = func(*args, **kwargs)
        outs = _tensors(out)
        # a device tensor copied to the host (``.cpu()``, ``.tolist()``)
        src, dst = ((ins[1], ins[0]) if name == "copy" and len(ins) > 1
                    else (ins[0] if ins else None, outs[0] if outs else None))
        if name in ("_to_copy", "copy") and src is not None \
                and dst is not None and not src.is_cpu and dst.is_cpu:
            st.host_reads.append(str(src.device))
        for t in outs:
            self._track(t)
        if self._kernel or (not self.cpu
                            and all(t.is_cpu for t in ins + outs)):
            return out
        mult = self._mult
        st.ops[str(func)] += mult
        if name.startswith(("linalg_", "_linalg_")) or name in _LINALG:
            st.linalg.append(str(func))
        if name != "_to_copy" and any(
                t.dtype in (torch.float64, torch.complex128) for t in outs):
            st.f64.append(str(func))
        if func.overloadpacket in MATMULS:
            from torch.utils.flop_counter import flop_registry
            n = mult * float(flop_registry[func.overloadpacket](
                *args, **kwargs, out_val=out))
            st.flops += n
            cls = flop_class(ins[0].dtype)
            st.flops_by_class[cls] = st.flops_by_class.get(cls, 0.0) + n
        if func.is_view or name in _NO_DATA:
            return out
        if self._skipping():
            st.skipped_ops += mult
            return out
        out_b = mult * float(sum(_nbytes(t) for t in outs))
        in_b = mult * float(sum(_nbytes(t) for t in ins))
        st.bytes += in_b + out_b
        st.bytes_major += in_b + out_b if name in _MAJOR else 2.0 * out_b
        return out


def _storage_key(t: torch.Tensor):
    """The storage of a device tensor (``None`` for a CPU tensor or one
    without a storage)."""
    if t.is_cpu:
        return None
    try:
        return t.untyped_storage()._cdata
    except (RuntimeError, NotImplementedError):
        return None


def _rounded(n: int) -> int:
    return -(-n // BLOCK) * BLOCK


def _leaves(tree, out: list | None = None) -> list:
    """Every tensor of a tree of dicts, lists and tuples whose leaves may
    be weight forms (objects holding tensors)."""
    out = [] if out is None else out
    if isinstance(tree, torch.Tensor):
        out.append(tree)
    elif isinstance(tree, (list, tuple)):
        for x in tree:
            _leaves(x, out)
    elif isinstance(tree, dict):
        for x in tree.values():
            _leaves(x, out)
    elif hasattr(tree, "__dict__"):
        _leaves(list(vars(tree).values()), out)
    return out


def _counters() -> list:
    """The counters entered, innermost last: torch's stack of dispatch
    modes, which autograd's threads see too."""
    return [m for m in _get_current_dispatch_mode_stack()
            if isinstance(m, OpCounter)]


def active() -> OpCounter | None:
    """The innermost counter entered, or ``None``."""
    counters = _counters()
    return counters[-1] if counters else None


def analyze_step(fn, *args, skip_scopes: tuple = (), **kwargs) -> Stats:
    """Run ``fn(*args, **kwargs)`` once under an :class:`OpCounter` and
    return its :class:`Stats` (the counterpart of ``analyze_hlo``); the
    step's result is dropped after the count."""
    counter = OpCounter(skip_scopes, (args, kwargs))
    with counter:
        fn(*args, **kwargs)
    return counter.stats


# ----------------------------------------------------------------------
# what the port's code reports
# ----------------------------------------------------------------------
class _Scope:
    __slots__ = ("counter", "name", "tag")

    def __init__(self, counter, name):
        self.counter, self.name, self.tag = counter, name, None

    def __enter__(self):
        self.counter._scopes.append(self.name)
        if self.name in self.counter.skip_scopes:
            self.tag = _TagGradFns(self.name)
            self.tag.__enter__()

    def __exit__(self, *exc):
        if self.tag is not None:
            self.tag.__exit__(*exc)
        self.counter._scopes.pop()


_NULL = contextlib.nullcontext()


def scope(name: str):
    """The ops run inside count FLOPs but no bytes where the active
    counter skips ``name`` (its backward pass's too); a no-op outside a
    counter."""
    counter = active()
    return _NULL if counter is None else _Scope(counter, name)


class _Kernel:
    __slots__ = ("counter",)

    def __init__(self, counter):
        self.counter = counter

    def __enter__(self):
        self.counter._kernel += 1

    def __exit__(self, *exc):
        self.counter._kernel -= 1


def kernel(name: str, flops: float, nbytes: float, flop_cls: str):
    """A kernel's launch, entered by its wrapper around the launch (or,
    on meta tensors, around the allocation of its output): one launch of
    ``name``, its ``flops`` of class ``flop_cls`` and its boundary
    ``nbytes``; the aten ops inside count in nothing but memory. A no-op
    outside a counter."""
    counter = active()
    if counter is None:
        return _NULL
    st = counter.stats
    mult = counter._mult
    flops, nbytes = mult * flops, mult * nbytes
    st.launches[name] += mult
    st.flops += flops
    st.flops_by_class[flop_cls] = st.flops_by_class.get(flop_cls, 0.0) \
        + flops
    st.bytes += nbytes
    st.bytes_major += nbytes
    st.kernel_bytes += nbytes
    return _Kernel(counter)


class _Repeated:
    __slots__ = ("counter", "n", "old")

    def __init__(self, counter, n):
        self.counter, self.n, self.old = counter, int(n), None

    def __enter__(self):
        self.old = self.counter._mult
        self.counter._mult = self.old * self.n

    def __exit__(self, *exc):
        self.counter._mult = self.old


def repeated(n: int):
    """The ops run inside count ``n`` times over: a loop run once for
    its ``n`` trips, where the trips differ only in values (on meta
    tensors, which carry none). A no-op outside a counter."""
    counter = active()
    return _NULL if counter is None else _Repeated(counter, n)


def record_collective(primitive: str, out, size: int,
                      axes: tuple | None = None) -> None:
    """One collective of ``size`` ranks whose output is ``out`` (a
    tensor, or ``None``: no data), on ``axes`` of the mesh where a dry
    run's group knows them; every active counter records it."""
    nbytes = 0.0 if out is None else float(_nbytes(out))
    for counter in _counters():
        st = counter.stats
        st.coll[primitive] = st.coll.get(primitive, 0.0) + nbytes
        st.coll_count += 1
        st.collectives.append(Collective(primitive, nbytes, int(size),
                                         axes))


# ----------------------------------------------------------------------
# lint helpers (the reference's, over a step's Stats)
# ----------------------------------------------------------------------
def linalg_ops(stats: Stats) -> list[str]:
    """The linear-algebra solver ops the step ran (``linalg_*``, SVD,
    QR, Cholesky...): the counterpart of ``linalg_custom_calls``."""
    return sorted(set(stats.linalg))


def host_reads(stats: Stats) -> list[str]:
    """The devices of the tensors the step read on the host
    (``aten._local_scalar_dense``): the counterpart of
    ``host_callbacks``."""
    return list(stats.host_reads)


def f64_ops(stats: Stats) -> list[str]:
    """The ops that made float64/complex128 results on the device (a
    conversion excepted): the counterpart of ``f64_ops``."""
    return list(stats.f64)


def call_targets(stats: Stats) -> dict[str, int]:
    """{target: count} of what a counted call reached outside aten's
    plain ops: each hand-written kernel by its label (``"K1loop"``,
    ``"K3"``, ...; the larger of its wrapper's reports, :func:`kernel`,
    and its launch counter's launches, which agree on the card; meta
    tensors have reports only) and each library linear-algebra op. The
    counterpart of ``custom_call_targets``."""
    out: dict[str, int] = {}
    for label in set(stats.launches) | set(stats.wrapper_launches):
        out[label] = int(max(stats.launches.get(label, 0),
                             stats.wrapper_launches.get(label, 0)))
    for op in stats.linalg:
        out[op] = out.get(op, 0) + 1
    return out


def input_output_alias(args, out) -> set[int]:
    """The positions of ``args`` (a call's positional arguments) whose
    every tensor storage ``out`` (the call's result) still holds: the
    arguments the call updated in place and handed back, the counterpart
    of ``parse_input_output_alias``'s donated parameters that the
    compiler aliased into outputs. An argument without tensors is not
    listed."""
    held = {t.untyped_storage()._cdata for t in _leaves(out)}
    aliased = set()
    for i, a in enumerate(args):
        own = [t.untyped_storage()._cdata for t in _leaves(a)]
        if own and all(k in held for k in own):
            aliased.add(i)
    return aliased


def causal_pairs(s: int, window: int = 0) -> int:
    """The (query, key) pairs a causal attention over ``s`` positions
    keeps (within ``window`` keys when it is above 0)."""
    if window <= 0 or window >= s:
        return s * (s + 1) // 2
    return window * (window + 1) // 2 + (s - window) * window


__all__ = ["Stats", "Collective", "OpCounter", "analyze_step", "active",
           "scope", "kernel", "repeated", "record_collective",
           "linalg_ops", "host_reads", "f64_ops", "call_targets",
           "input_output_alias", "flop_class", "causal_pairs",
           "MATMULS", "BLOCK"]
