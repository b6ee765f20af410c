"""Gradient compression for cross-pod data parallelism.

Port of ``src/repro/distributed/compression_comm.py``. The LC paper
compresses *weights*; the same machinery applies to the gradient
exchange. Error-feedback sign compression (the EF-signSGD family): each
participant sends sign(g+e)·mean|g+e|, and the quantization residual
feeds back into the next step (Karimireddy et al., 2019).

``psum_compressed`` is the port's counterpart of the reference's drop-in
for ``jax.lax.psum`` over the pod axis: an ``all_reduce`` over a mesh
axis's process group of ``sign.to(bfloat16) * scale``, summed in
bfloat16 (the reference's comment intends it; its JAX product promotes
to float32 because its scale is a float32 array, ROADMAP queue 3).
``ef_*`` are the pure-math pieces. No trainer uses it, in either
package.
"""
from __future__ import annotations

import torch

from repro_torch.distributed.sharding import active_mesh, all_reduce_sum
from repro_torch.tree import tree_leaves, tree_map


def ef_compress(g: torch.Tensor, e: torch.Tensor):
    """(sign int8, scale 0-d f32, new error) with error feedback:
    ĝ = Q(g + e) = sign(g + e)·mean|g + e|."""
    c = g.float() + e
    scale = torch.mean(torch.abs(c))
    sign = torch.sign(c).to(torch.int8)
    ghat = sign.float() * scale
    return sign, scale, c - ghat


def ef_decompress(sign: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return sign.float() * scale


def compress_tree(grads, ef):
    """Tree version: returns (signs, scales, new_ef), each a tree of the
    grads' structure."""
    flat_e = iter(tree_leaves(ef))
    parts = [ef_compress(g, next(flat_e)) for g in tree_leaves(grads)]

    def unflatten(leaves):
        it = iter(leaves)
        return tree_map(lambda _: next(it), grads)

    return tuple(unflatten(p[i] for p in parts) for i in range(3))


def psum_compressed(grads, ef, axis_name: str, mesh=None):
    """EF-sign-compressed sum over ``axis_name``'s ranks of ``mesh`` (the
    active mesh when None), divided by their count: the mean of the
    decompressed contributions, which approximates the mean gradient.
    Returns (averaged grads in bfloat16, new error-feedback buffers)."""
    mesh = mesh if mesh is not None else active_mesh()
    group = mesh.get_group(axis_name)
    n = int(dict(zip(mesh.mesh_dim_names, mesh.shape))[axis_name])
    signs, scales, new_ef = compress_tree(grads, ef)

    def combine(s, sc):
        # the int8 signs go out as bfloat16 (4× less than f32)
        summed = all_reduce_sum(s.to(torch.bfloat16) * sc, group)
        return summed / n

    return tree_map(combine, signs, scales), new_ef


def init_ef(params):
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                          device=p.device), params)


def compression_ratio(bits_per_elem: float = 8.0,
                      baseline_bits: float = 32.0) -> float:
    return baseline_bits / bits_per_elem
