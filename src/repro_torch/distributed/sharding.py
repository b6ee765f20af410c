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
* :func:`constrain` is the identity on a mesh whose ``"model"`` axis is
  1; the tensor-parallel ``"model"`` axis is the next slice of the port
  (ROADMAP queue 1), and every place that would need it raises
  :func:`check_model_axis`'s ``NotImplementedError``.

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

#: what the next slice of the port brings (the message of every refusal)
NEXT_SLICE = ("the tensor-parallel \"model\" axis is the next slice of the "
              "port (ROADMAP queue 1 item 8)")


def mesh_sizes(mesh) -> dict[str, int]:
    """``{axis name: size}`` of a mesh (or a stand-in with
    ``mesh_dim_names`` and ``shape``)."""
    return dict(zip(mesh.mesh_dim_names, (int(n) for n in mesh.shape)))


def check_model_axis(mesh, where: str) -> None:
    """Raise ``NotImplementedError`` naming the next slice when ``mesh``
    has a ``"model"`` axis larger than 1 (``where`` names the caller)."""
    if mesh is not None and mesh_sizes(mesh).get("model", 1) > 1:
        raise NotImplementedError(
            f"{where}: a mesh whose \"model\" axis is "
            f"{mesh_sizes(mesh)['model']} is not supported: {NEXT_SLICE}")


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
    """The identity on the active mesh (the reference's
    ``with_sharding_constraint``): activations stay where they are on a
    mesh whose ``"model"`` axis is 1, where the batch is already the
    rank's rows. A larger ``"model"`` axis raises."""
    check_model_axis(active_mesh(), "constrain")
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
