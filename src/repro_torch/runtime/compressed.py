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


layers.register_weight_form(QuantizedWeight, _quant_apply, _quant_load)
layers.register_weight_form(LowRankWeight, _lowrank_apply, _lowrank_load)
layers.register_weight_form(SparseWeight, _sparse_apply, _sparse_load)


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
