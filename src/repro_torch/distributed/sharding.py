"""Logical-axis sharding rules over a ``torch.distributed`` device mesh.

Port of ``src/repro/distributed/sharding.py``, for the mesh's data axis.
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
  code puts them. Under the tensor-parallel ``"model"`` axis (serving)
  the model code splits its products itself: :func:`shard_params` gives
  a rank its slices of the weights (the ``"model"`` entry of each dim,
  :func:`shard_spec`, of ``param_axes(cfg)`` under :data:`SERVE_RULES`),
  a layer reads from its weights' shapes whether they were split, and
  :func:`model_all_reduce` / :func:`model_all_gather` put the partial
  results together over the ``"model"`` process group (none is issued
  on a group of one rank). Training over ``"model"`` is the next slice
  of the port: those places raise :func:`check_model_axis`'s
  ``NotImplementedError``.

Nothing here imports a collective backend at import time; the collectives
run only where a mesh with a process group is given. ``gloo`` takes CUDA
tensors in these collectives (it stages them through the host itself),
which is how two ranks share one card, where NCCL refuses them.
"""
from __future__ import annotations

import contextlib
import threading

import torch

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

#: what the next slice of the port brings (the message of the refusals
#: of training over the "model" axis)
NEXT_SLICE = ("tensor-parallel training over the \"model\" axis is the next "
              "slice of the port (ROADMAP queue 1)")
#: the message of the SSM mixers' refusal
SSM_SLICE = ("the SSM mixers' \"inner\" split over the \"model\" axis is a "
             "later slice of the port (ROADMAP queue 1)")


def mesh_sizes(mesh) -> dict[str, int]:
    """``{axis name: size}`` of a mesh (or a stand-in with
    ``mesh_dim_names`` and ``shape``)."""
    return dict(zip(mesh.mesh_dim_names, (int(n) for n in mesh.shape)))


def check_model_axis(mesh, where: str, what: str = NEXT_SLICE) -> None:
    """Raise ``NotImplementedError`` naming the slice that brings it
    (``what``) when ``mesh`` has a ``"model"`` axis larger than 1
    (``where`` names the caller)."""
    if mesh is not None and mesh_sizes(mesh).get("model", 1) > 1:
        raise NotImplementedError(
            f"{where}: a mesh whose \"model\" axis is "
            f"{mesh_sizes(mesh)['model']} is not supported: {what}")


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
    import torch.distributed as dist
    group = entry_group(mesh, entry)
    n = entry_size(mesh, entry)
    done: dict = {}

    def gather(x):
        # a tensor that stands twice in the tree (pruning's Θ is its Δ)
        # is gathered once, and stays one tensor
        if id(x) not in done:
            blk = x.contiguous()
            out = blk.new_empty((n * blk.shape[0], *blk.shape[1:]))
            dist.all_gather_into_tensor(out, blk, group=group)
            done[id(x)] = out
        return done[id(x)]

    return tree_map(gather, tree)


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` summed over ``group``, in place (returned)."""
    import torch.distributed as dist
    dist.all_reduce(x, group=group)
    return x


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


# ----------------------------------------------------------------------
# the tensor-parallel "model" axis (serving)
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
            f"serve the tree that shard_params gives for this mesh")
    return True


def model_all_reduce(x: torch.Tensor) -> torch.Tensor:
    """``x`` summed over the active mesh's ``"model"`` group, in place
    (returned): the partial products of a row-parallel weight. No
    collective on a group of one rank."""
    mesh = active_mesh()
    if model_size(mesh) > 1:
        import torch.distributed as dist
        x = x.contiguous()
        dist.all_reduce(x, group=entry_group(mesh, "model"))
    return x


def model_all_gather(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """The ranks' blocks of ``x`` along ``dim`` put together in rank
    order over the active mesh's ``"model"`` group (the columns of a
    column-parallel product, the logits of a split vocabulary)."""
    mesh = active_mesh()
    m = model_size(mesh)
    if m == 1:
        return x
    import torch.distributed as dist
    blk = x.contiguous()
    out = blk.new_empty((m * blk.shape[0], *blk.shape[1:]))
    dist.all_gather_into_tensor(out, blk, group=entry_group(mesh, "model"))
    out = out.reshape(m, *blk.shape).movedim(0, dim % x.ndim)
    return out.reshape(*x.shape[:dim % x.ndim], -1,
                       *x.shape[dim % x.ndim + 1:])


def shard_params(params, cfg, mesh, rules: dict | None = None):
    """This rank's tree of ``params`` (the whole tree, dense tensors or
    weight forms) over ``mesh``'s ``"model"`` axis.

    Each leaf of ``param_axes(cfg)`` is sliced on the dim that
    :func:`shard_spec` resolves to ``"model"`` under ``rules``
    (:data:`SERVE_RULES` by default): the rank's even block, copied, so
    that the whole tree can be dropped. A leaf where no dim resolves
    stays whole (the same tensor). Attention and MLA split by whole heads
    (``attention.head_slices``) and run whole where the heads do not
    divide; the SSM mixers stay whole (their ``"inner"`` split is a
    later slice, and they refuse a ``"model"`` axis above 1). On a
    ``"model"`` axis of 1 the tree is returned as it is."""
    from repro_torch.models import attention, layers, transformer
    m = model_size(mesh)
    if m == 1:
        return params
    r = model_rank(mesh)
    rules = SERVE_RULES if rules is None else rules
    kinds = transformer.mixer_kinds(cfg)

    def shard(leaf, names, path):
        shape = tuple(leaf.shape)
        if path[0] == "stages" and path[3] == "mixer":
            kind = kinds[path[1:3]]
            if kind not in ("attn", "mla"):
                return leaf
            cut = attention.head_slices(cfg, kind, path[-1], m, r)
            if cut is None:
                return leaf
            rows, lo, hi = cut
            return layers.slice_weight(leaf, len(shape) - (2 if rows else 1),
                                       lo, hi)
        spec = shard_spec(tuple(names), shape, mesh, rules)
        if "model" not in spec:
            return leaf
        d = spec.index("model")
        per = shape[d] // m
        return layers.slice_weight(leaf, d, r * per, (r + 1) * per)

    def walk(tree, axes, path):
        if isinstance(tree, dict):
            return {k: walk(v, axes[k], path + (k,)) for k, v in tree.items()}
        return shard(tree, axes, path)

    return walk(params, transformer.param_axes(cfg), ())
