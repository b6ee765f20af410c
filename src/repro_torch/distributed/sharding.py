"""Logical-axis sharding rules over a ``torch.distributed`` device mesh.

Port of ``src/repro/distributed/sharding.py``: the mesh's data axis and
its tensor-parallel ``"model"`` axis, the SSM mixers' ``"inner"`` split
included.
Every tensor dim carries a *logical name* ("batch", "items", ...). A rule
maps a name to an ordered list of mesh-axis candidates; the resolver
picks, per tensor, the first candidate that (a) exists in the mesh, (b)
divides the dim size, (c) reuses no mesh axis already assigned to
another dim of the same tensor. Names are resolved in a global priority
order (:data:`PRIORITY`), not dim order.

A mesh is a ``torch.distributed.device_mesh.DeviceMesh`` with
``mesh_dim_names`` ``("data", "model")`` or ``("pod", "data", "model")``,
one process a rank. Its sizes are read once, from ``mesh_dim_names`` and
``mesh.shape``, so a stand-in with those two attributes serves wherever
only the layout is read (:func:`resolve_spec`, :func:`items_partition`,
:func:`batch_axes`). A spec is a tuple of entries, as a
``PartitionSpec``'s: a mesh-axis name, a tuple of them, or ``None``.

Where the JAX package lets GSPMD place data, the port moves it itself:

* :func:`shard_bounds` gives a rank's ``[lo, hi)`` of a leading axis
  split over a spec entry's axes, and :func:`gather_items` puts the
  ranks' blocks back together (``all_gather_into_tensor`` over the
  entry's process group). They take the place of ``stacked_sharding``
  and ``shard_map``.
* :func:`batch_shard` is the "batch" rule applied to a global batch:
  the rows a rank trains on, and :func:`local_batch` tells the model
  that it holds them (``models/moe.py`` averages its load-balance terms
  over the group then).
* :func:`constrain` is the identity: activations stay where the model
  code puts them. Under the tensor-parallel ``"model"`` axis the model
  code splits its products itself: :func:`shard_params` gives a rank its
  slices of the weights (the ``"model"`` entry of each dim,
  :func:`shard_spec`, of ``param_axes(cfg)``, by whole heads for
  attention and the xLSTM mixers and by channel for Mamba; a leaf fused
  along its split dim is cut in segments, one for each of its parts;
  :func:`gather_params` puts them back), and a layer reads from its
  weights' shapes whether they were split.

The ``"model"`` axis, in serving and in training, follows one
convention. Every model rank computes the whole loss of its data rows.
The layers join their partial results with three conjugate pairs, each
a ``torch.autograd.Function`` (none issues a collective on a group of
one rank, or records a graph where no gradient is asked for):

* :func:`copy_to_model`: the identity forward, the gradient summed over
  the ``"model"`` group backward (Megatron's "f"): the input of a
  column-parallel weight;
* :func:`reduce_from_model` (:func:`model_all_reduce`): the sum over the
  group forward, the identity backward ("g"): the partial products of a
  row-parallel weight;
* :func:`gather_from_model` (:func:`model_all_gather`): the ranks'
  blocks put together forward, this rank's block of the gradient
  backward: serving's full logits.

A sum or a gather whose result every rank holds whole but reads only in
part (the SSM mixers' ``x_proj`` output, the inputs of mLSTM's q/k/v,
the RMS of a split norm: ``models/ssm.py``) has a gradient that is a
part on each rank; there the layer composes ``copy_to_model`` over
``reduce_from_model`` or ``gather_from_model``, so that the parts are
summed before they flow back.

After the backward pass a leaf that is whole on every model rank has
the same gradient on each, a split leaf has its own shard's, and a kv
head held by several ranks (``attention.head_slices`` where m > KV) has
its copies' gradients summed over the ranks that hold it
(:func:`sum_kv_copies`). No other model-axis sum of gradients is made;
the training loss takes the vocabulary-parallel cross-entropy
(``layers.vocab_parallel_nll``). The data axis keeps its own
convention: each rank's loss is a part that the ranks' parts sum to
(:func:`differentiable_sum`), and the train step sums the gradients over
the batch's ranks once. :func:`param_layout` says of each leaf whether it
is split, whole or copied, which the global norm and the LC penalty
read to count each weight once.

Every ``torch.distributed`` collective of the port is called here, by
one function (:func:`_collective`), which reports it to an active
``analysis/op_stats.py`` counter (primitive, output bytes, group size)
before it issues it. On a dry run's mesh (``launch/mesh.py:
abstract_mesh``) the groups are recording groups
(:class:`RecordingGroup`): the collective is recorded and issues nothing
(a sum leaves its input as it is, a gather's output stays unwritten).
Nothing here imports a collective backend at import time; the
collectives run only where a mesh with a process group is given.
``gloo`` takes CUDA tensors in these collectives (it stages them through
the host itself), which is how two ranks share one card, where NCCL
refuses them.
"""
from __future__ import annotations

import contextlib
import math
import threading

import torch

from repro_torch.analysis import op_stats
from repro_torch.tree import tree_map

# candidates: tuples of mesh axis names (joint sharding) tried in order;
# () means replicate
DEFAULT_RULES: dict[str, list[tuple[str, ...]]] = {
    # data-parallel axes
    "batch":       [("pod", "data"), ("data",), ()],
    # tensor-parallel output dims
    "heads_flat":  [("model",), ()],
    "kv_flat":     [("model",), ()],
    "kv_heads":    [("model",), ()],
    "heads":       [("model",), ()],
    "mlp":         [("model",), ()],
    "vocab":       [("model",), ()],
    "experts":     [("model",), ()],
    "inner":       [("model",), ()],      # SSM/xLSTM expanded channels
    # FSDP: parameters' reduction dims shard over the data axis
    "embed":       [("data",), ()],
    "embed_pod":   [("pod", "data"), ("data",), ()],  # opt-in ZeRO over pods
    # sequence axes
    "kv_seq":      [("model",), ("data",), ()],
    "seq":         [()],
    # packed leading item axis of a grouped C step (core/grouping.py):
    # the stacked items are independent, so they data-shard
    "items":       [("data",), ()],
    # never sharded
    "layers":      [()],
    "state":       [()],
    "lora":        [()],
    "conv":        [()],
    "gates":       [()],
    "stack":       [()],
    None:          [()],
}

# greedy assignment priority (earlier names grab mesh axes first)
PRIORITY = [
    "experts", "items", "batch", "heads_flat", "kv_flat", "heads",
    "kv_heads", "mlp", "vocab", "inner", "embed", "embed_pod", "kv_seq",
    "seq",
]

# serving rules: weights are tensor-parallel only ("embed" replicates)
SERVE_RULES = dict(DEFAULT_RULES)
SERVE_RULES["embed"] = [()]
SERVE_RULES["embed_pod"] = [()]

def mesh_sizes(mesh) -> dict[str, int]:
    """``{axis name: size}`` of a mesh (or a stand-in with
    ``mesh_dim_names`` and ``shape``)."""
    return dict(zip(mesh.mesh_dim_names, (int(n) for n in mesh.shape)))


def _axes(entry) -> tuple[str, ...]:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def entry_size(mesh, entry) -> int:
    """The number of ranks a spec entry splits over."""
    sizes = mesh_sizes(mesh)
    n = 1
    for a in _axes(entry):
        n *= sizes[a]
    return n


def resolve_spec(names: tuple, shape: tuple, mesh,
                 rules: dict | None = None) -> tuple:
    """Logical dim names + concrete shape → spec (a tuple of entries)."""
    rules = rules or DEFAULT_RULES
    assert len(names) == len(shape), (names, shape)
    sizes = mesh_sizes(mesh)
    order = sorted(
        range(len(names)),
        key=lambda i: PRIORITY.index(names[i]) if names[i] in PRIORITY
        else len(PRIORITY))
    used: set[str] = set()
    entries: list = [None] * len(names)
    for i in order:
        for cand in rules.get(names[i], [()]):
            if not cand:
                entries[i] = None
                break
            if not all(a in sizes for a in cand):
                continue
            if any(a in used for a in cand):
                continue
            prod = 1
            for a in cand:
                prod *= sizes[a]
            if shape[i] % prod != 0:
                continue
            entries[i] = cand if len(cand) > 1 else cand[0]
            used.update(cand)
            break
    return tuple(entries)


def items_partition(n_items: int, mesh, rules: dict | None = None,
                    allow_pad: bool = True) -> tuple:
    """Resolve the ``"items"`` logical axis for a packed stack of
    ``n_items``: ``(entry, pad)``, ``entry`` the spec entry of the leading
    axis (``None``: replicated) and ``pad`` the items to append so that
    the padded count divides the entry's ranks. With ``allow_pad=False``
    only exact divisibility shards."""
    rules = rules or DEFAULT_RULES
    sizes = mesh_sizes(mesh)
    for cand in rules.get("items", [()]):
        if not cand:
            return None, 0
        if not all(a in sizes for a in cand):
            continue
        prod = 1
        for a in cand:
            prod *= sizes[a]
        pad = (-n_items) % prod
        if pad and not allow_pad:
            continue
        return (cand if len(cand) > 1 else cand[0]), pad
    return None, 0


def batch_axes(mesh) -> tuple[str, ...]:
    """Mesh axes that carry the batch (everything except ``"model"``)."""
    return tuple(n for n in mesh.mesh_dim_names if n != "model")


def tree_shardings(axes_tree, shapes_tree, mesh, rules: dict | None = None):
    """Tree of logical-name tuples + matching shapes → tree of specs."""
    def is_names(x):
        return isinstance(x, (tuple, list)) and all(
            isinstance(e, (str, type(None))) for e in x)

    def walk(names, shape):
        if is_names(names):
            return resolve_spec(tuple(names), tuple(shape), mesh, rules)
        if isinstance(names, dict):
            return {k: walk(names[k], shape[k]) for k in names}
        return type(names)(walk(n, s) for n, s in zip(names, shape))

    return walk(axes_tree, shapes_tree)


def match_shardings(tree, like):
    """``tree``'s leaves laid onto ``like``'s: each leaf on the device and
    dtype of the leaf it replaces (a leaf already there passes through).
    The overlapped trainer swaps fresh Δ(Θ)/λ refs in with it."""
    def put(x, y):
        if not isinstance(y, torch.Tensor):
            return x
        return x.to(device=y.device, dtype=y.dtype)

    return tree_map(put, tree, like)


# ----------------------------------------------------------------------
# the active mesh, so that model code reads it without threading it
# through every call
# ----------------------------------------------------------------------
_CTX = threading.local()


@contextlib.contextmanager
def use_mesh(mesh, rules: dict | None = None):
    prev = getattr(_CTX, "state", None)
    _CTX.state = (mesh, rules or DEFAULT_RULES) if mesh is not None else None
    try:
        yield
    finally:
        _CTX.state = prev


def active_mesh():
    st = getattr(_CTX, "state", None)
    return st[0] if st else None


def active_rules() -> dict:
    st = getattr(_CTX, "state", None)
    return st[1] if st else DEFAULT_RULES


def constrain(x, names: tuple):
    """The identity (the reference's ``with_sharding_constraint``): the
    port moves activations itself. The batch a rank holds is already its
    rows, and under the ``"model"`` axis each layer puts its partial
    results together (:func:`model_all_reduce`)."""
    return x


# ----------------------------------------------------------------------
# ranks, process groups and the collectives of the data axis
# ----------------------------------------------------------------------
class RecordingGroup:
    """The process group of a dry run's mesh (``launch/mesh.py:
    abstract_mesh``): the ``size`` ranks along mesh ``axes``. A
    collective on it is recorded and issues nothing."""

    def __init__(self, axes: tuple, size: int):
        self.axes, self.size = tuple(axes), int(size)

    def __repr__(self):
        return f"RecordingGroup(axes={self.axes}, size={self.size})"


def group_size(group) -> int:
    """The number of ranks in ``group`` (``None``: the default group)."""
    if isinstance(group, RecordingGroup):
        return group.size
    import torch.distributed as dist
    return dist.get_world_size(group)


def _collective(primitive: str, group, out=None, inp=None,
                op: str = "sum"):
    """The one call site of the port's ``torch.distributed``
    collectives: ``"all-reduce"`` of ``out`` in place (by ``op``, "sum"
    or "max"), ``"all-gather"`` of every rank's ``inp`` into ``out``
    (``all_gather_into_tensor``), or ``"barrier"``. It reports the
    collective to the active ``op_stats`` counters, then issues it,
    unless ``group`` is a dry run's :class:`RecordingGroup`. Returns
    ``out``."""
    op_stats.record_collective(primitive, out, group_size(group),
                               getattr(group, "axes", None))
    if isinstance(group, RecordingGroup):
        return out
    import torch.distributed as dist
    if primitive == "all-reduce":
        dist.all_reduce(out, op=dist.ReduceOp.MAX if op == "max"
                        else dist.ReduceOp.SUM, group=group)
    elif primitive == "all-gather":
        dist.all_gather_into_tensor(out, inp, group=group)
    elif primitive == "barrier":
        dist.barrier(group=group)
    else:
        raise ValueError(f"unknown collective {primitive!r}")
    return out


def barrier(group=None) -> None:
    """Every rank of ``group`` (``None``: the default group) waits for
    the others."""
    _collective("barrier", group)


def entry_rank(mesh, entry) -> int:
    """This rank's index among the ranks that ``entry``'s axes span
    (row-major over the entry's axes in order)."""
    idx = 0
    sizes = mesh_sizes(mesh)
    for a in _axes(entry):
        idx = idx * sizes[a] + int(mesh.get_local_rank(a))
    return idx


def entry_group(mesh, entry):
    """The process group of the ranks that ``entry``'s axes span."""
    axes = _axes(entry)
    if len(axes) == 1:
        return mesh.get_group(axes[0])
    return mesh[axes]._flatten().get_group()


def shard_bounds(n_padded: int, mesh, entry) -> tuple[int, int]:
    """This rank's ``[lo, hi)`` of a leading axis of ``n_padded`` split
    evenly over ``entry``'s ranks (``n_padded`` divides their count)."""
    n = entry_size(mesh, entry)
    assert n_padded % n == 0, (n_padded, n)
    per = n_padded // n
    r = entry_rank(mesh, entry)
    return r * per, (r + 1) * per


def gather_items(tree, mesh, entry):
    """Every rank's block of ``tree``'s leaves put together along axis 0
    (``all_gather_into_tensor`` over ``entry``'s process group, in rank
    order): a leaf of ``m`` rows on each of ``n`` ranks comes back with
    ``n·m`` rows, the same on every rank."""
    group = entry_group(mesh, entry)
    n = entry_size(mesh, entry)
    done: dict = {}

    def gather(x):
        # a tensor that stands twice in the tree (pruning's Θ is its Δ)
        # is gathered once, and stays one tensor
        if id(x) not in done:
            blk = x.contiguous()
            if n == 1:      # no collective on a group of one rank
                done[id(x)] = blk.clone()
                return done[id(x)]
            out = blk.new_empty((n * blk.shape[0], *blk.shape[1:]))
            done[id(x)] = _collective("all-gather", group, out, blk)
        return done[id(x)]

    return tree_map(gather, tree)


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` summed over ``group``, in place (returned)."""
    return _collective("all-reduce", group, x)


class _AllReduceSum(torch.autograd.Function):
    """Σ over a group with its gradient: the gradient of every rank's
    input is the sum of the ranks' output gradients."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_reduce_sum(x.clone(), group)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_sum(g.clone(), ctx.group), None


def differentiable_sum(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` summed over ``group``, differentiable."""
    return _AllReduceSum.apply(x, group)


# ----------------------------------------------------------------------
# the data-parallel batch
# ----------------------------------------------------------------------
def batch_shard(b: int, mesh, rules: dict | None = None):
    """The "batch" rule applied to a global batch of ``b`` rows: ``(entry,
    lo, hi)``, this rank's rows ``[lo, hi)`` and the entry they split
    over, or ``None`` where the batch stays replicated (no batch axis
    divides ``b``)."""
    (entry,) = resolve_spec(("batch",), (b,), mesh, rules)
    if entry is None:
        return None
    lo, hi = shard_bounds(b, mesh, entry)
    return entry, lo, hi


@contextlib.contextmanager
def local_batch(entry):
    """Within this context the model holds this rank's rows of a batch
    split over ``entry``'s ranks of the active mesh (``None``: the whole
    batch, replicated)."""
    prev = getattr(_CTX, "batch", None)
    _CTX.batch = entry
    try:
        yield
    finally:
        _CTX.batch = prev


def batch_entry():
    """The entry the batch held is split over (:func:`local_batch`), or
    ``None``."""
    return getattr(_CTX, "batch", None)


def recompute_context():
    """``context_fn`` of a non-reentrant ``torch.utils.checkpoint``: the
    recomputation, which autograd runs on a thread of its own for CUDA
    tensors, sees the active mesh, rules and batch entry of the forward
    (this thread's, read now)."""
    now = (getattr(_CTX, "state", None), getattr(_CTX, "batch", None))

    @contextlib.contextmanager
    def restore():
        prev = (getattr(_CTX, "state", None), getattr(_CTX, "batch", None))
        _CTX.state, _CTX.batch = now
        try:
            yield
        finally:
            _CTX.state, _CTX.batch = prev

    return contextlib.nullcontext(), restore()


# ----------------------------------------------------------------------
# the tensor-parallel "model" axis
# ----------------------------------------------------------------------
def model_size(mesh) -> int:
    """The size of ``mesh``'s ``"model"`` axis (1 without a mesh)."""
    return 1 if mesh is None else mesh_sizes(mesh).get("model", 1)


def model_rank(mesh) -> int:
    """This rank's index along ``mesh``'s ``"model"`` axis."""
    return entry_rank(mesh, "model") if model_size(mesh) > 1 else 0


def shard_spec(names: tuple, shape: tuple, mesh,
               rules: dict | None = None) -> tuple:
    """The ``"model"`` entry of each dim: :func:`resolve_spec` restricted
    to that axis (``"model"`` where the dim splits over it, else
    ``None``)."""
    return tuple("model" if "model" in _axes(e) else None
                 for e in resolve_spec(names, shape, mesh, rules))


def model_split(n_local: int, n_full: int, what: str) -> bool:
    """Whether a layer's weight holds ``n_local`` of ``n_full`` along a
    dim that :func:`shard_params` splits over the active mesh's
    ``"model"`` axis (``False``: it is whole)."""
    if n_local == n_full:
        return False
    m = model_size(active_mesh())
    if n_local * m != n_full:
        raise ValueError(
            f"{what}: a weight of {n_local} of {n_full} along a split dim "
            f"is no shard of the active mesh's \"model\" axis ({m}): "
            f"run the tree that shard_params gives for this mesh")
    return True


def model_reduce(x: torch.Tensor, group, op: str = "sum") -> torch.Tensor:
    """``x`` reduced over ``group`` in place (returned), by ``op`` ("sum"
    or "max"): every collective of the ``"model"`` axis but the gathers
    goes through here."""
    return _collective("all-reduce", group, x, op=op)


def model_gather(x: torch.Tensor, group, m: int) -> torch.Tensor:
    """The ``m`` ranks' blocks of ``x`` (one shape on every rank) stacked
    in rank order along a new leading axis: ``(m, *x.shape)``."""
    blk = x.contiguous().reshape(1, -1)
    out = blk.new_empty((m, blk.shape[1]))
    return _collective("all-gather", group, out, blk).reshape(m, *x.shape)


def _join_blocks(stacked: torch.Tensor, dim: int) -> torch.Tensor:
    """``(m, *shape)`` blocks put together along ``dim`` of ``shape``."""
    shape = stacked.shape[1:]
    return stacked.movedim(0, dim).reshape(*shape[:dim], -1,
                                           *shape[dim + 1:])


def _wants_grad(x) -> bool:
    """Whether autograd records ``x``'s use (never a weight form's)."""
    return (torch.is_grad_enabled() and isinstance(x, torch.Tensor)
            and x.requires_grad)


class _CopyToModel(torch.autograd.Function):
    """The identity; backward, the gradient summed over the group."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return model_reduce(g.clone(memory_format=torch.contiguous_format),
                            ctx.group), None


class _ReduceFromModel(torch.autograd.Function):
    """The sum over the group; backward, the identity."""

    @staticmethod
    def forward(ctx, x, group):
        return model_reduce(x.clone(memory_format=torch.contiguous_format),
                            group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherFromModel(torch.autograd.Function):
    """The ranks' blocks along ``dim`` put together; backward, this
    rank's block of the gradient."""

    @staticmethod
    def forward(ctx, x, group, m, r, dim):
        ctx.cut = (dim, r * x.shape[dim], x.shape[dim])
        return _join_blocks(model_gather(x, group, m), dim)

    @staticmethod
    def backward(ctx, g):
        return g.narrow(*ctx.cut), None, None, None, None


class _SumCopies(torch.autograd.Function):
    """The identity on a rank's columns ``[lo, hi)`` of ``width``;
    backward, the gradients of the ranks that hold the same columns
    summed (one sum over the group of a zero-padded full width)."""

    @staticmethod
    def forward(ctx, w, group, lo, hi, width):
        ctx.args = (group, lo, hi, width)
        return w.view_as(w)

    @staticmethod
    def backward(ctx, g):
        group, lo, hi, width = ctx.args
        full = g.new_zeros((*g.shape[:-1], width))
        full[..., lo:hi] = g
        return (model_reduce(full, group)[..., lo:hi].contiguous(),
                None, None, None, None)


def copy_to_model(x: torch.Tensor) -> torch.Tensor:
    """``x`` as it is, its gradient summed over the active mesh's
    ``"model"`` group (the input of a column-parallel weight)."""
    mesh = active_mesh()
    if model_size(mesh) == 1 or not _wants_grad(x):
        return x
    return _CopyToModel.apply(x, entry_group(mesh, "model"))


def reduce_from_model(x: torch.Tensor) -> torch.Tensor:
    """``x`` summed over the active mesh's ``"model"`` group (the partial
    products of a row-parallel weight), the gradient passed through.
    Where no gradient is recorded the sum is made in place on ``x``."""
    mesh = active_mesh()
    if model_size(mesh) == 1:
        return x
    group = entry_group(mesh, "model")
    if _wants_grad(x):
        return _ReduceFromModel.apply(x, group)
    return model_reduce(x.contiguous(), group)


def gather_from_model(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """The ranks' blocks of ``x`` along ``dim`` put together in rank
    order over the active mesh's ``"model"`` group; the gradient of each
    rank's block is its block of the output's."""
    mesh = active_mesh()
    m = model_size(mesh)
    if m == 1:
        return x
    group = entry_group(mesh, "model")
    if _wants_grad(x):
        return _GatherFromModel.apply(x, group, m, model_rank(mesh),
                                      dim % x.ndim)
    return _join_blocks(model_gather(x, group, m), dim % x.ndim)


def sum_kv_copies(w: torch.Tensor, lo: int, hi: int,
                  width: int) -> torch.Tensor:
    """``w``, a rank's columns ``[lo, hi)`` of a weight ``width`` wide
    that other model ranks hold too (a kv head where m > KV), as it is;
    its gradient summed over the ranks that hold the same columns."""
    mesh = active_mesh()
    if model_size(mesh) == 1 or not _wants_grad(w):
        return w
    return _SumCopies.apply(w, entry_group(mesh, "model"), lo, hi, width)


#: the names the layers call (serving and training run one code path)
model_all_reduce = reduce_from_model
model_all_gather = gather_from_model


# ----------------------------------------------------------------------
# a tree's slices over the "model" axis
# ----------------------------------------------------------------------
class _Cuts:
    """Every rank's slice of each leaf of ``cfg``'s tree over a
    ``"model"`` axis of ``m`` (``mesh``'s), by path."""

    def __init__(self, cfg, mesh, rules):
        from repro_torch.models import transformer
        self.cfg, self.mesh, self.m = cfg, mesh, model_size(mesh)
        self.rules = SERVE_RULES if rules is None else rules
        self.kinds = transformer.mixer_kinds(cfg)
        self.axes = transformer.param_axes(cfg)
        self.shapes = transformer.param_shapes(cfg)

    def _at(self, tree, path):
        for k in path:
            tree = tree[k]
        return tree

    def __call__(self, path: tuple, r: int):
        """``(dim, segments)`` of rank ``r``'s slice of the leaf at
        ``path`` (a tuple of keys), or ``None`` where the leaf stays
        whole: ``segments`` a tuple of ``(lo, hi)`` along ``dim``, which
        the rank holds put together in that order. Attention and MLA
        split by whole heads (``attention.head_slices``), the SSM mixers
        by channel and by whole heads (``ssm.inner_slices``), one segment
        for each part of a fused leaf; every other leaf is one even
        block."""
        from repro_torch.models import attention, ssm
        shape = self._at(self.shapes, path)
        if path[0] == "stages" and path[3] == "mixer":
            kind = self.kinds[path[1:3]]
            if kind in ("attn", "mla"):
                cut = attention.head_slices(self.cfg, kind, path[-1],
                                            self.m, r)
                if cut is None:
                    return None
                rows, lo, hi = cut
                return len(shape) - (2 if rows else 1), ((lo, hi),)
            cut = ssm.inner_slices(self.cfg, kind, path[-1], self.m, r)
            if cut is None:
                return None
            dim, segs = cut          # dim counted from the end
            return len(shape) + dim, segs
        spec = shard_spec(tuple(self._at(self.axes, path)), shape,
                          self.mesh, self.rules)
        if "model" not in spec:
            return None
        d = spec.index("model")
        per = shape[d] // self.m
        return d, ((r * per, (r + 1) * per),)

    def layout(self, path: tuple, r: int):
        """``"whole"``, ``"split"``, or the number of ranks that hold
        rank ``r``'s slice where it is held by more than one."""
        cut = self(path, r)
        if cut is None:
            return "whole"
        k = sum(self(path, q) == cut for q in range(self.m))
        return k if k > 1 else "split"


def slice_segments(leaf, dim: int, segs):
    """The ``segments`` (``(lo, hi)`` pairs) of a weight leaf along
    ``dim``, put together in their order, in the leaf's own form
    (``layers.slice_weight``, ``layers.join_weight``)."""
    from repro_torch.models import layers
    parts = [layers.slice_weight(leaf, dim, lo, hi) for lo, hi in segs]
    return parts[0] if len(parts) == 1 else layers.join_weight(parts, dim)


def _map_paths(tree, fn, path=()):
    """``fn(leaf, path)`` over a nested tree (``path`` a tuple of keys)."""
    if isinstance(tree, dict):
        return {k: _map_paths(v, fn, path + (k,)) for k, v in tree.items()}
    return fn(tree, path)


def _map_flat(flat: dict, fn):
    """``fn(leaf, path)`` over a dict keyed by ``"a/b/c"`` paths (the LC
    refs)."""
    return {p: fn(v, tuple(p.split("/"))) for p, v in flat.items()}


def shard_params(params, cfg, mesh, rules: dict | None = None,
                 flat: bool = False):
    """This rank's tree of ``params`` (the whole tree, dense tensors or
    weight forms) over ``mesh``'s ``"model"`` axis; ``flat``: a dict of
    leaves keyed by ``"a/b/c"`` paths (the LC refs).

    Each leaf of ``param_axes(cfg)`` is sliced on the dim that
    :func:`shard_spec` resolves to ``"model"`` under ``rules``
    (:data:`SERVE_RULES` by default; :data:`DEFAULT_RULES`, which
    training takes, gives the same ``"model"`` entries): the rank's even
    block, copied, so that the whole tree can be dropped. A leaf where
    no dim resolves stays whole (the same tensor). Attention and MLA
    split by whole heads (``attention.head_slices``) and run whole where
    the heads do not divide. The SSM mixers split their ``"inner"``
    channels (``ssm.inner_slices``): Mamba by channel, mLSTM and sLSTM by
    whole heads (whole where the heads do not divide); a leaf fused
    along its split dim (Mamba's and mLSTM's ``in_proj``/``up_proj``,
    sLSTM's ``w``, ``b`` and ``up_proj``) gives the rank its channels of
    each part, in the parts' order (:func:`slice_segments`). On a
    ``"model"`` axis of 1 the tree is returned as it is."""
    if model_size(mesh) == 1:
        return params
    cuts, r = _Cuts(cfg, mesh, rules), model_rank(mesh)

    def shard(leaf, path):
        cut = cuts(path, r)
        return leaf if cut is None else slice_segments(leaf, *cut)

    return (_map_flat if flat else _map_paths)(params, shard)


def _gather_parts(leaf, group, m: int) -> list:
    """Every rank's ``leaf`` (a tensor of one shape on every rank, or a
    weight form, whose tensors may differ in size), in rank order."""
    if isinstance(leaf, torch.Tensor):
        return list(model_gather(leaf, group, m).unbind(0))
    import copy
    parts = [copy.copy(leaf) for _ in range(m)]
    for name, val in vars(leaf).items():
        if not isinstance(val, torch.Tensor):
            continue
        sizes = model_gather(torch.tensor(val.shape, dtype=torch.int64,
                                          device=val.device), group, m)
        n = int(sizes.prod(dim=1).max())
        flat = val.reshape(-1)
        blocks = model_gather(torch.cat([flat, flat.new_zeros(
            n - flat.numel())]), group, m)
        for p, blk, size in zip(parts, blocks, sizes.tolist()):
            setattr(p, name, blk[:math.prod(size)].reshape(size).clone())
    return parts


def gather_params(params, cfg, mesh, rules: dict | None = None,
                  flat: bool = False):
    """The inverse of :func:`shard_params`: the whole tree from every
    model rank's slices, put back together in rank order (an all-gather
    over ``mesh``'s ``"model"`` group; the same tree on every rank). Each
    rank's slice is cut back into its segments, and the segments of every
    rank are put in place; a segment that several ranks hold (a kv head
    where m > KV) is taken once; a weight form is put back in its own
    layout (``layers.join_weight``)."""
    from repro_torch.models import layers
    m = model_size(mesh)
    if m == 1:
        return params
    cuts, group = _Cuts(cfg, mesh, rules), entry_group(mesh, "model")

    def gather(leaf, path):
        every = [cuts(path, r) for r in range(m)]
        if every[0] is None:
            return leaf
        dim = every[0][0]
        pieces = {}
        for (_, segs), part in zip(every, _gather_parts(leaf, group, m)):
            at = 0
            for lo, hi in segs:
                if (lo, hi) not in pieces:
                    pieces[(lo, hi)] = (part if len(segs) == 1 else
                                        layers.slice_weight(
                                            part, dim, at, at + hi - lo))
                at += hi - lo
        return layers.join_weight([pieces[s] for s in sorted(pieces)], dim)

    return (_map_flat if flat else _map_paths)(params, gather)


def param_layout(cfg, mesh, rules: dict | None = None) -> dict:
    """Each leaf of ``cfg``'s tree on this rank of ``mesh``'s ``"model"``
    axis, in the tree's structure: ``"split"`` (a slice no other model
    rank holds), ``"whole"`` (the same leaf on every model rank), or the
    number of model ranks that hold the same slice (a kv head where m >
    KV)."""
    from repro_torch.models import transformer
    cuts, r = _Cuts(cfg, mesh, rules), model_rank(mesh)
    return _map_paths(transformer.param_axes(cfg),
                      lambda _, path: cuts.layout(path, r))


def _map_state(state, cfg, mesh, rules, fn):
    """``fn(tree, cfg, mesh, rules, flat=...)`` over a train state's
    parameter-shaped parts: the params, every tree of the optimizer
    state, and the LC refs ``a`` and λ (keyed by path)."""
    out = dict(state)
    out["params"] = fn(state["params"], cfg, mesh, rules)
    if "opt" in state:
        out["opt"] = {k: fn(v, cfg, mesh, rules) if isinstance(v, dict)
                      else v for k, v in state["opt"].items()}
    if "lc" in state:
        out["lc"] = dict(state["lc"], **{
            k: fn(state["lc"][k], cfg, mesh, rules, flat=True)
            for k in ("a", "lam")})
    return out


def shard_train_state(state, cfg, mesh, rules: dict | None = None):
    """This rank's train state from the whole one (:func:`shard_params`
    of its params, optimizer trees and LC refs); step and μ as they
    are. On a ``"model"`` axis of 1 the state is returned as it is."""
    if model_size(mesh) == 1:
        return state
    return _map_state(state, cfg, mesh, rules, shard_params)


def gather_train_state(state, cfg, mesh, rules: dict | None = None):
    """The whole train state from every model rank's
    (:func:`gather_params`), the same on every rank."""
    if model_size(mesh) == 1:
        return state
    return _map_state(state, cfg, mesh, rules, gather_params)
