"""Compressed weight forms for serving: param-tree leaves that execute
without materializing the dense matrix.

Port of ``src/repro/runtime/compressed.py``. For deployment each 2-D
weight leaf is replaced in the param tree by one of the classes below;
the model code runs its matmuls through ``layers.apply_w``, which routes
each form to its own product:

==============  =======================  ==========================
form            device bytes per decode  product
==============  =======================  ==========================
dense (bf16)    K·N·2 B                  plain matrix product
QuantizedWeight K·N/2 B (4-bit) + cb     kernels/quant_matmul K4
                or K·N B (8-bit)         (4-bit) or K5 (8-bit)
LowRankWeight   r·(K+N)·2 B              kernels/lowrank/serve (two
                                         thin matmuls, W never built)
SparseWeight    nnz·(2+4+4) B            kernels/prune/serve (COO
                                         gather + index_add)
==============  =======================  ==========================

The classes are plain Python classes holding tensors; they register with
``layers.register_weight_form`` on import. The reference's tile hint
(``cost.gemm_tiles``) is dropped: the kernels pick their own tiles.

Each form slices by rows (K) or columns (N) in its own form, for the
tensor-parallel ``"model"`` axis (``sharding.shard_params``): a
quantized weight keeps its whole codebook (as the reference's
``launch/inputs.py:quantize_params_sds``) and slices its indices (4-bit
rows in byte pairs; a row block that starts at an odd row or ends at an
odd row inside the matrix is unpacked and packed again once); a low-rank
weight slices ``vt`` (columns) or ``u`` (rows); a sparse weight keeps the
entries in the block, rebased, in their order. Each form puts its blocks
back together in its own layout too (``sharding.gather_params``).
"""
from __future__ import annotations

import torch

from repro_torch.kernels.lowrank import serve as lowrank_serve
from repro_torch.kernels.prune import serve as prune_serve
from repro_torch.kernels.quant_matmul import ops as quant_ops
from repro_torch.kernels.quant_matmul import ref as quant_ref
from repro_torch.models import layers


class QuantizedWeight:
    """Codebook-quantized weight. ``bits=4``: ``packed`` is
    (ceil(K/2), N) uint8, two indices per byte; ``bits=8``: (K, N)
    uint8 plain indices. ``shape`` = (K, N) of the dense weight."""

    def __init__(self, packed, codebook, shape, bits):
        self.packed = packed
        self.codebook = codebook
        self.shape = tuple(shape)
        self.bits = int(bits)

    def __repr__(self):
        return (f"QuantizedWeight(shape={self.shape}, bits={self.bits}, "
                f"codes={self.codebook.shape[0]})")


class LowRankWeight:
    """Factored weight W = u @ vt. u: (K, r); vt: (r, N)."""

    def __init__(self, u, vt):
        self.u = u
        self.vt = vt

    @property
    def shape(self):
        return (self.u.shape[0], self.vt.shape[1])

    def __repr__(self):
        return f"LowRankWeight(shape={self.shape}, rank={self.u.shape[1]})"


class SparseWeight:
    """Pruned weight in COO form: W[rows[i], cols[i]] = values[i], zeros
    elsewhere; rows and cols are int32. ``shape`` = (K, N)."""

    def __init__(self, values, rows, cols, shape):
        self.values = values
        self.rows = rows
        self.cols = cols
        self.shape = tuple(shape)

    def __repr__(self):
        return (f"SparseWeight(shape={self.shape}, "
                f"nnz={self.values.shape[0]})")


WEIGHT_FORMS = (QuantizedWeight, LowRankWeight, SparseWeight)


# ----------------------------------------------------------------------
# Execution (apply = x @ W without materializing W; load = dense W)
# ----------------------------------------------------------------------
def _quant_apply(x, w: QuantizedWeight, dt):
    k, n = w.shape
    lead = x.shape[:-1]
    x2 = x.reshape(-1, k)      # ops converts and copies only if needed
    if w.bits == 4:
        if k % 2:  # odd K: packed has a pad row of index 0; feed zero x
            x2 = torch.cat([x2, x2.new_zeros((x2.shape[0], 1))], dim=1)
        y = quant_ops.matmul_packed(x2, w.packed, w.codebook)
    else:
        y = quant_ops.matmul(x2, w.packed, w.codebook)
    return y.reshape(*lead, n).to(dt)


def _quant_load(w: QuantizedWeight, dt):
    k, _ = w.shape
    idx = quant_ref.unpack4_ref(w.packed)[:k] if w.bits == 4 else w.packed
    return w.codebook[idx.long()].to(dt)


def _lowrank_apply(x, w: LowRankWeight, dt):
    return lowrank_serve.lowrank_matmul(x, w.u, w.vt).to(dt)


def _lowrank_load(w: LowRankWeight, dt):
    return lowrank_serve.materialize_lowrank(w.u, w.vt).to(dt)


def _sparse_apply(x, w: SparseWeight, dt):
    return prune_serve.sparse_matmul(
        x, w.values, w.rows, w.cols, w.shape[1]).to(dt)


def _sparse_load(w: SparseWeight, dt):
    return prune_serve.densify(w.values, w.rows, w.cols, w.shape).to(dt)


def _quant_slice(w: QuantizedWeight, dim: int, lo: int, hi: int):
    k, n = w.shape
    if dim == 1:
        return QuantizedWeight(w.packed[:, lo:hi].contiguous(), w.codebook,
                               (k, hi - lo), w.bits)
    if w.bits == 8:
        packed = w.packed[lo:hi].contiguous()
    elif lo % 2 == 0 and (hi % 2 == 0 or hi == k):
        # whole byte pairs (the last block of an odd K keeps its pad row)
        packed = w.packed[lo // 2:(hi + 1) // 2].contiguous()
    else:
        packed = quant_ops.pack4(quant_ops.unpack4(w.packed)[lo:hi])
    return QuantizedWeight(packed, w.codebook, (hi - lo, n), w.bits)


def _lowrank_slice(w: LowRankWeight, dim: int, lo: int, hi: int):
    if dim == 1:
        return LowRankWeight(w.u, w.vt[:, lo:hi].contiguous())
    return LowRankWeight(w.u[lo:hi].contiguous(), w.vt)


def _sparse_slice(w: SparseWeight, dim: int, lo: int, hi: int):
    at = w.cols if dim == 1 else w.rows
    keep = (at >= lo) & (at < hi)
    rows, cols = w.rows[keep], w.cols[keep]
    if dim == 1:
        cols = cols - lo
    else:
        rows = rows - lo
    shape = (w.shape[0], hi - lo) if dim == 1 else (hi - lo, w.shape[1])
    return SparseWeight(w.values[keep], rows.to(torch.int32),
                        cols.to(torch.int32), shape)


def _quant_join(parts, dim: int):
    k, n = parts[0].shape
    bits, cb = parts[0].bits, parts[0].codebook
    if dim == 1:
        return QuantizedWeight(torch.cat([p.packed for p in parts], dim=1),
                               cb, (k, sum(p.shape[1] for p in parts)),
                               bits)
    rows = [p.shape[0] for p in parts]
    if bits == 8:
        packed = torch.cat([p.packed for p in parts])
    elif all(r % 2 == 0 for r in rows[:-1]):
        # whole byte pairs (the last block of an odd K keeps its pad row)
        packed = torch.cat([p.packed for p in parts])
    else:
        packed = quant_ops.pack4(torch.cat(
            [quant_ops.unpack4(p.packed)[:r] for p, r in zip(parts, rows)]))
    return QuantizedWeight(packed, cb, (sum(rows), n), bits)


def _lowrank_join(parts, dim: int):
    if dim == 1:
        return LowRankWeight(parts[0].u,
                             torch.cat([p.vt for p in parts], dim=1))
    return LowRankWeight(torch.cat([p.u for p in parts]), parts[0].vt)


def _sparse_join(parts, dim: int):
    """The blocks' entries rebased and put back in row-major order (the
    order in which the bridge and the interop build them)."""
    offsets, at = [], 0
    for p in parts:
        offsets.append(at)
        at += p.shape[dim]
    rows = torch.cat([p.rows.long() + (o if dim == 0 else 0)
                      for p, o in zip(parts, offsets)])
    cols = torch.cat([p.cols.long() + (o if dim == 1 else 0)
                      for p, o in zip(parts, offsets)])
    values = torch.cat([p.values for p in parts])
    shape = ((at, parts[0].shape[1]) if dim == 0
             else (parts[0].shape[0], at))
    order = torch.argsort(rows * shape[1] + cols, stable=True)
    return SparseWeight(values[order], rows[order].to(torch.int32),
                        cols[order].to(torch.int32), shape)


layers.register_weight_form(QuantizedWeight, _quant_apply, _quant_load,
                            _quant_slice, _quant_join)
layers.register_weight_form(LowRankWeight, _lowrank_apply, _lowrank_load,
                            _lowrank_slice, _lowrank_join)
layers.register_weight_form(SparseWeight, _sparse_apply, _sparse_load,
                            _sparse_slice, _sparse_join)


def materialize(leaf, dt=torch.float32):
    """Dense tensor for any weight-form leaf (parity checks, embedding
    lookups). Dense leaves pass through as ``leaf.to(dt)``."""
    return layers.wload(leaf, dt)


# ----------------------------------------------------------------------
# Device-memory accounting (modeled bf16 deployment)
# ----------------------------------------------------------------------
def is_weight_form(leaf) -> bool:
    return isinstance(leaf, WEIGHT_FORMS)


def weight_form_bytes(leaf) -> int:
    """Modeled device bytes to stream this leaf once at decode. Dense
    leaves count at 2 B/elem (bf16 deployment) whatever dtype they are
    held in; codebooks and coordinates at their true width."""
    if isinstance(leaf, QuantizedWeight):
        return int(leaf.packed.numel()) + 4 * int(leaf.codebook.numel())
    if isinstance(leaf, LowRankWeight):
        return 2 * (int(leaf.u.numel()) + int(leaf.vt.numel()))
    if isinstance(leaf, SparseWeight):
        return (2 * int(leaf.values.numel())
                + 4 * (int(leaf.rows.numel()) + int(leaf.cols.numel())))
    return 2 * int(leaf.numel())


def tree_weight_bytes(params) -> int:
    """Total modeled weight-stream bytes for one decode step over the
    whole param tree."""
    if isinstance(params, dict) and not is_weight_form(params):
        return sum(tree_weight_bytes(v) for v in params.values())
    return weight_form_bytes(params)


def decode_hbm_bytes_per_token(params, batch: int = 1) -> float:
    """Roofline model for batched decode: weights stream once per step
    and are amortized over the ``batch`` tokens produced."""
    return tree_weight_bytes(params) / max(batch, 1)
