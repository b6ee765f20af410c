"""Meta stand-ins for every model input and state tree, at one rank's
shard shapes: nothing is allocated. The dry run (``launch/dryrun.py``)
runs the port's steps on them.

Port of ``src/repro/launch/inputs.py``. The reference gives a
``ShapeDtypeStruct`` at each global shape, with a ``NamedSharding``, and
lets GSPMD cut them; the port's step runs on one rank, so every tree
here is what that rank holds: the weights sliced over the mesh's
``"model"`` axis by ``sharding.shard_params`` (under ``SERVE_RULES`` for
serving and the default rules for training, as the reference chooses;
the port does not FSDP-shard parameters over ``"embed"``), a serving
batch the rank's rows under the ``"batch"`` rule, and a cache of the
rank's rows and kv heads. A training batch stays global: the train step
takes its rows itself (``launch/steps.py``). ``mesh`` ``None`` is one
rank. The trees hold meta tensors (``layers.MetaGenerator`` draws the
weights), so shapes and dtypes are exact and no memory is taken.

Dtypes: token ids are int64 in training batches (the port's
``TokenStream``) and int32 in serving (``runtime/server.py``); a decode
step's position is a (B,) int64 vector of per-slot positions (the
reference's is a 0-d int32: the port's ``decode_step`` reads positions
per slot).
"""
from __future__ import annotations

import torch

from repro_torch.core.tasks import flatten_params, set_path
from repro_torch.distributed import sharding
from repro_torch.distributed.sharding import DEFAULT_RULES, SERVE_RULES
from repro_torch.launch.steps import init_train_state
from repro_torch.models.layers import MetaGenerator
from repro_torch.models.transformer import init_cache, init_params, param_axes
from repro_torch.runtime.compressed import QuantizedWeight
from repro_torch.tree import tree_leaves, tree_map

_FLOATS = (torch.float32, torch.bfloat16)
#: 2-D leaves that the mixers read as tensors, not as products
#: (``layers.apply_w``): they stay dense in a quantized tree
_READ_AS_TENSORS = ("conv_w", "A_log")


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(tuple(shape), dtype=dtype, device="meta")


def local_rows(b: int, mesh, rules: dict | None = None) -> int:
    """The rows of a batch of ``b`` that this rank of ``mesh`` holds
    under the ``"batch"`` rule (all of them where no batch axis divides
    ``b``, or without a mesh)."""
    if mesh is None:
        return b
    split = sharding.batch_shard(b, mesh, rules)
    return b if split is None else split[2] - split[1]


def _tokens(cfg, b: int, s: int, ids: torch.dtype) -> torch.Tensor:
    if cfg.input_mode == "tokens":
        return _meta((b, s), ids)
    return _meta((b, s, cfg.d_input), torch.bfloat16)


def batch_specs(cfg, shape_cfg, mesh=None) -> dict:
    """``{"inputs", "labels"}`` of a train step, at the global shape."""
    b, s = shape_cfg.global_batch, shape_cfg.seq_len
    return {"inputs": _tokens(cfg, b, s, torch.int64),
            "labels": _meta((b, s), torch.int64)}


def params_specs(cfg, mesh=None, dtype=None, rules: dict | None = None):
    """The rank's param tree (float leaves cast to ``dtype`` where it is
    given: serving runs on cast weights), sliced over ``"model"`` under
    ``rules`` (the default rules when ``None``)."""
    params = init_params(MetaGenerator(), cfg)
    if dtype is not None:
        params = tree_map(lambda t: t.to(dtype) if t.dtype == torch.float32
                          else t, params)
    if mesh is None:
        return params
    return sharding.shard_params(params, cfg, mesh, rules or DEFAULT_RULES)


def train_state_specs(cfg, mesh=None, with_lc: bool = True) -> dict:
    """The rank's train state (``steps.init_train_state``'s tree: params,
    AdamW moments, step and, ``with_lc``, the LC refs ``a``, λ and μ),
    sliced over ``"model"`` (``sharding.shard_train_state``)."""
    state = init_train_state(MetaGenerator(), cfg, with_lc=with_lc)
    if mesh is None:
        return state
    return sharding.shard_train_state(state, cfg, mesh, DEFAULT_RULES)


def _pack(shape, k: int, device, gen) -> QuantizedWeight:
    """An 8-bit pack of a (K, N) weight: uint8 indices and a k-entry f32
    codebook, empty on meta, else drawn from ``gen`` (indices below k, a
    sorted codebook of scale 1/√K)."""
    rows, cols = shape
    if gen is None:
        idx = torch.empty((rows, cols), dtype=torch.uint8, device=device)
        cb = torch.empty((k,), dtype=torch.float32, device=device)
    else:
        idx = torch.randint(0, k, (rows, cols), generator=gen,
                            device=device, dtype=torch.uint8)
        cb = torch.sort(torch.randn((k,), generator=gen, device=device)
                        / rows ** 0.5).values
    return QuantizedWeight(idx, cb, (rows, cols), 8)


def quantize_params_meta(params, mesh, cfg, k: int = 16, gen=None):
    """Every matrix leaf of ``params`` (this rank's tree) replaced by the
    LC-quantized serving pack, ``runtime/compressed.QuantizedWeight``
    with 8-bit indices of the leaf's shape and a ``k``-entry codebook
    (kept whole on every rank, as the reference's replicated ``cb``); a
    leaf of a stacked stage becomes a list of one pack a layer (the
    reference's leading stack dim). The routed experts and the router
    stay dense, as in the reference, and so do the 2-D leaves that the
    mixers read as tensors (``conv_w``, ``A_log``). The packs are meta
    tensors on meta leaves; with ``gen`` (a generator on the leaves'
    device) they are drawn from it, the card's twin of the same tree.
    ``mesh`` is not read: ``params`` is already the rank's."""
    axes_flat = flatten_params(param_axes(cfg))
    out = params
    for path, leaf in flatten_params(params).items():
        names = tuple(axes_flat[path])
        stacked = bool(names) and names[0] == "layers"
        if "experts" in names or path.endswith("/router") \
                or path.rsplit("/", 1)[-1] in _READ_AS_TENSORS:
            continue
        if leaf.ndim - stacked != 2 or leaf.dtype not in _FLOATS:
            continue
        shape = tuple(leaf.shape[-2:])
        packs = [_pack(shape, k, leaf.device, gen)
                 for _ in range(leaf.shape[0] if stacked else 1)]
        out = set_path(out, path, packs if stacked else packs[0])
    return out


def quantized_weight_bytes_per_chip(params) -> float:
    """This rank's device read of the quantized weights (uint8
    indices): the boundary I/O of the fused quant_matmul kernel."""
    total = 0.0
    for leaf in tree_leaves(params):
        if isinstance(leaf, QuantizedWeight):
            total += float(leaf.packed.numel())
    return total


def decode_specs(cfg, shape_cfg, mesh=None, quantized: bool = False,
                 dtype=torch.bfloat16):
    """(params, cache, inputs, pos) of a serve step: this rank's rows of
    the batch, each decoding one token at position ``seq_len - 1`` of a
    cache of ``seq_len`` (the context already processed). Weights and
    cache in ``dtype`` (bf16: the reference's serving cast)."""
    b, s = shape_cfg.global_batch, shape_cfg.seq_len
    # serving: tensor-parallel weights only (no re-gather per token)
    params = params_specs(cfg, mesh, dtype=dtype, rules=SERVE_RULES)
    if quantized:
        params = quantize_params_meta(params, mesh, cfg)
    rows = local_rows(b, mesh, SERVE_RULES)
    with sharding.use_mesh(mesh, SERVE_RULES):
        cache = init_cache(cfg, rows, s, dtype, device="meta")
    return (params, cache, _tokens(cfg, rows, 1, torch.int32),
            _meta((rows,), torch.int64))


def prefill_specs(cfg, shape_cfg, mesh=None, quantized: bool = False,
                  dtype=torch.bfloat16):
    """(params, inputs) of a prefill step over this rank's rows, weights
    in ``dtype``; with ``quantized`` the matrices are packs
    (:func:`quantize_params_meta`), which the port's prefill runs through
    K5 (the reference's prefill cell stays dense)."""
    b, s = shape_cfg.global_batch, shape_cfg.seq_len
    params = params_specs(cfg, mesh, dtype=dtype, rules=SERVE_RULES)
    if quantized:
        params = quantize_params_meta(params, mesh, cfg)
    return params, _tokens(cfg, local_rows(b, mesh, SERVE_RULES), s,
                           torch.int32)


__all__ = ["batch_specs", "params_specs", "train_state_specs",
           "quantize_params_meta", "quantized_weight_bytes_per_chip",
           "decode_specs", "prefill_specs", "local_rows"]
