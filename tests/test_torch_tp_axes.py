"""The port's tensor-parallel layout against the JAX package's, on the CPU.

* ``param_axes(cfg)`` (and the seven tables under it: ``attn_axes``,
  ``mla_axes``, ``moe_axes``, ``mamba_axes``, ``mlstm_axes``,
  ``slstm_axes``, ``block_axes``) equals the reference's for every
  architecture, as one parametrised test;
* each leaf's ``resolve_spec`` under ``SERVE_RULES`` at the published
  widths equals the reference's on (1, 2), (1, 4) and (16, 16) stand-in
  meshes (the layout without ranks), and ``shard_spec`` is its
  ``"model"`` entry;
* every weight form sliced by rows and by columns over m ranks
  (``layers.slice_weight``) puts back together into the whole bit for
  bit — a 4-bit weight whose blocks start or end at odd rows, a sparse
  weight with empty rows included — and the ranks' row-parallel
  products sum to ``apply_w`` on the whole within K4/K5's rtol 1e-5 /
  atol 1e-4;
* ``shard_params`` gives each rank its blocks of the split leaves, whole
  heads of attention (a kv head on two ranks where m > KV) and MLA, the
  SSM mixers' channels (Mamba) and whole heads (mLSTM, sLSTM), a fused
  leaf in one segment a part, and the same tensors where nothing
  splits.
"""
import dataclasses
import functools

import jax
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.distributed import sharding as jsh
from repro.models import attention as jattn
from repro.models import moe as jmoe
from repro.models import ssm as jssm
from repro.models import transformer as jtf
from repro_torch import configs as tconfigs
from repro_torch.distributed import sharding as sh
from repro_torch.kernels.quant_matmul import ops as qops
from repro_torch.models import attention as tattn
from repro_torch.models import layers
from repro_torch.models import moe as tmoe
from repro_torch.models import ssm as tssm
from repro_torch.models import transformer as ttf
from repro_torch.runtime import compressed as forms
from torch_threads import _one_torch_thread  # noqa: F401

MESHES = [{"data": 1, "model": 2}, {"data": 1, "model": 4},
          {"data": 16, "model": 16}]


class _JaxMesh:
    def __init__(self, sizes: dict):
        self.axis_names = tuple(sizes)
        self.devices = np.empty(tuple(sizes.values()))


class _TorchMesh:
    def __init__(self, sizes: dict, ranks: dict | None = None):
        self.mesh_dim_names = tuple(sizes)
        self.shape = tuple(sizes.values())
        self._ranks = ranks or {}

    def get_local_rank(self, axis):
        return self._ranks.get(axis, 0)


@pytest.mark.parametrize("arch", tconfigs.ARCHS)
def test_param_axes_equal_the_reference(arch):
    jcfg, tcfg = jconfigs.get_config(arch), tconfigs.get_config(arch)
    assert ttf.param_axes(tcfg) == jtf.param_axes(jcfg)
    assert ttf.param_axes(tconfigs.reduced_config(tcfg)) == \
        jtf.param_axes(jconfigs.reduced_config(jcfg))
    for spec in tcfg.all_layer_specs():
        assert ttf.block_axes(spec, tcfg) == jtf.block_axes(spec, jcfg)
    tables = [(tattn.attn_axes, jattn.attn_axes)]
    if tcfg.mla:
        tables.append((tattn.mla_axes, jattn.mla_axes))
    if tcfg.moe:
        tables.append((tmoe.moe_axes, jmoe.moe_axes))
    if tcfg.mamba:
        tables.append((tssm.mamba_axes, jssm.mamba_axes))
    if tcfg.xlstm:
        tables += [(tssm.mlstm_axes, jssm.mlstm_axes),
                   (tssm.slstm_axes, jssm.slstm_axes)]
    for ours, theirs in tables:
        assert ours(tcfg) == theirs(jcfg), ours.__name__


@functools.lru_cache(maxsize=None)
def _shapes(arch):
    """Every leaf's (path, logical names, shape) at the published widths,
    from the reference's abstract init."""
    cfg = jconfigs.get_config(arch)
    shapes = jax.eval_shape(lambda k: jtf.init_params(k, cfg),
                            jax.random.PRNGKey(0))
    axes = jtf.param_axes(cfg)

    def walk(s, a, path):
        if isinstance(s, dict):
            for k in s:
                yield from walk(s[k], a[k], f"{path}/{k}")
        else:
            yield path, tuple(a), tuple(s.shape)
    return list(walk(shapes, axes, ""))


@pytest.mark.parametrize("sizes", MESHES,
                         ids=lambda s: f"{s['data']}x{s['model']}")
@pytest.mark.parametrize("arch", tconfigs.ARCHS)
def test_leaf_specs_equal_the_reference(arch, sizes):
    for path, names, shape in _shapes(arch):
        want = tuple(jsh.resolve_spec(names, shape, _JaxMesh(sizes),
                                      jsh.SERVE_RULES))
        got = sh.resolve_spec(names, shape, _TorchMesh(sizes),
                              sh.SERVE_RULES)
        assert got == want, path
        model = sh.shard_spec(names, shape, _TorchMesh(sizes))
        assert model == tuple("model" if e == "model" else None
                              for e in want), path


# ----------------------------------------------------------------------
# the weight forms' slices
# ----------------------------------------------------------------------
def _quant(k, n, bits, seed=0):
    g = torch.Generator().manual_seed(seed)
    codes = 16 if bits == 4 else 64
    cb = torch.sort(torch.randn(codes, generator=g)).values
    idx = torch.randint(0, codes, (k, n), generator=g, dtype=torch.uint8)
    packed = qops.pack4(idx) if bits == 4 else idx
    return forms.QuantizedWeight(packed, cb, (k, n), bits)


def _lowrank(k, n, seed=0):
    g = torch.Generator().manual_seed(seed)
    return forms.LowRankWeight(torch.randn(k, 3, generator=g),
                               torch.randn(3, n, generator=g))


def _sparse(k, n, seed=0):
    """A sparse weight in row-major COO whose rows 0 and 3 are empty."""
    g = torch.Generator().manual_seed(seed)
    dense = torch.randn(k, n, generator=g)
    dense[torch.rand(k, n, generator=g) < 0.7] = 0.0
    dense[[0, 3]] = 0.0
    rows, cols = torch.nonzero(dense, as_tuple=True)
    return forms.SparseWeight(dense[rows, cols], rows.to(torch.int32),
                              cols.to(torch.int32), (k, n))


#: (form, K, N, m): K = 9 over 3 ranks cuts a 4-bit weight at rows 3 and
#: 6 (a block from an odd row, one ending at an odd row inside, and the
#: last block of an odd K, which keeps its pad row)
FORMS = [("dense", 12, 10, 2), ("quant4", 12, 10, 2), ("quant4", 9, 6, 3),
         ("quant4", 10, 6, 2), ("quant8", 12, 12, 4), ("lowrank", 12, 10, 2),
         ("sparse", 12, 12, 4)]


def _form(kind, k, n):
    if kind == "dense":
        return torch.randn(k, n, generator=torch.Generator().manual_seed(0))
    if kind.startswith("quant"):
        return _quant(k, n, int(kind[5:]))
    return _lowrank(k, n) if kind == "lowrank" else _sparse(k, n)


@pytest.mark.parametrize("dim", [0, 1], ids=["rows", "cols"])
@pytest.mark.parametrize("kind,k,n,m", FORMS,
                         ids=[f"{f[0]}-{f[1]}x{f[2]}-m{f[3]}" for f in FORMS])
def test_weight_form_slices_put_back_together(kind, k, n, m, dim):
    w = _form(kind, k, n)
    per = (k if dim == 0 else n) // m
    parts = [layers.slice_weight(w, dim, r * per, (r + 1) * per)
             for r in range(m)]
    for r, p in enumerate(parts):
        assert type(p) is type(w)
        want = (per, n) if dim == 0 else (k, per)
        assert tuple(p.shape) == want
        if isinstance(p, forms.SparseWeight):
            assert p.rows.dtype == p.cols.dtype == torch.int32
            keep = ((w.rows if dim == 0 else w.cols) // per) == r
            assert torch.equal(p.values, w.values[keep])  # in their order
    whole = forms.materialize(w)
    back = torch.cat([forms.materialize(p) for p in parts], dim=dim)
    if kind == "lowrank":    # u @ vt of a slice: the same sums, row by row
        np.testing.assert_allclose(back.numpy(), whole.numpy(), rtol=1e-6,
                                   atol=1e-6)
    else:
        assert torch.equal(back, whole)
    x = torch.randn(5, k, generator=torch.Generator().manual_seed(1))
    full = layers.apply_w(x, w, torch.float32)
    if dim == 0:    # row-parallel: the ranks' partial products sum up
        got = sum(layers.apply_w(x[:, r * per:(r + 1) * per], p,
                                 torch.float32) for r, p in enumerate(parts))
    else:           # column-parallel: the ranks' columns put together
        got = torch.cat([layers.apply_w(x, p, torch.float32)
                         for p in parts], dim=1)
    np.testing.assert_allclose(got.numpy(), full.numpy(), rtol=1e-5,
                               atol=1e-4)


def test_a_dense_slice_is_held_apart_from_the_whole():
    w = torch.randn(8, 6)
    part = layers.slice_weight(w, 0, 0, 4)
    assert part.is_contiguous() and part.untyped_storage().data_ptr() != \
        w.untyped_storage().data_ptr()


# ----------------------------------------------------------------------
# shard_params
# ----------------------------------------------------------------------
def _cfg(arch, **kw):
    c = tconfigs.reduced_config(tconfigs.get_config(arch))
    return dataclasses.replace(c, dtype="float32", **kw)


def _shards(cfg, params, m):
    return [sh.shard_params(params, cfg, _TorchMesh(
        {"data": 1, "model": m}, ranks={"model": r})) for r in range(m)]


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{prefix}/{k}")
    else:
        yield prefix, tree


@pytest.mark.parametrize("arch,kw,m", [
    ("phi3-mini-3.8b", {"n_heads": 4, "n_kv_heads": 4}, 2),
    ("phi3-mini-3.8b", {"n_heads": 4, "n_kv_heads": 2}, 4),
    ("deepseek-moe-16b", {"n_heads": 4, "n_kv_heads": 4}, 4),
    ("mixtral-8x7b", {"n_heads": 2, "n_kv_heads": 2}, 4),
    ("minicpm3-4b", {"n_heads": 4, "n_kv_heads": 4}, 2),
    ("jamba-v0.1-52b", {}, 2),
    ("xlstm-125m", {"n_heads": 4, "n_kv_heads": 4}, 4),
], ids=["phi3-m2", "phi3-kv2-m4", "deepseek-ep-m4", "mixtral-heads2-m4",
        "minicpm3-m2", "jamba-m2", "xlstm-m4"])
def test_shard_params_gives_each_rank_its_blocks(arch, kw, m):
    cfg = _cfg(arch, **kw)
    params = ttf.init_params(torch.Generator().manual_seed(0), cfg)
    ranks = [dict(_leaves(t)) for t in _shards(cfg, params, m)]
    kinds = ttf.mixer_kinds(cfg)
    split = 0
    for path, whole in _leaves(params):
        parts = [r[path] for r in ranks]
        if all(p is whole for p in parts):
            continue
        split += 1
        kind = kinds.get(tuple(path.split("/")[2:4])) \
            if "/mixer/" in path else None
        if kind in ("mamba", "mlstm", "slstm"):
            # the rank's segments of the whole, put together in order;
            # every index of the split dim held by exactly one rank
            seen = []
            for r, part in enumerate(parts):
                dim, segs = tssm.inner_slices(cfg, kind, path.split("/")[-1],
                                              m, r)
                d = whole.ndim + dim
                want = torch.cat([whole.narrow(d, lo, hi - lo)
                                  for lo, hi in segs], dim=d)
                assert torch.equal(part, want), (path, r)
                seen += [i for lo, hi in segs for i in range(lo, hi)]
            assert sorted(seen) == list(range(whole.shape[d])), path
            continue
        diff = [d for d in range(whole.ndim)
                if parts[0].shape[d] != whole.shape[d]]
        assert len(diff) == 1, path
        d = diff[0]
        if kind == "attn" and path.endswith(("/wk", "/wv")) \
                and cfg.n_kv_heads < m:
            # m > KV: each kv head on m / KV ranks, as their queries read
            reps = m // cfg.n_kv_heads
            back = torch.cat(parts[::reps], dim=d)
            for r in range(m):
                assert torch.equal(parts[r], parts[r - r % reps]), path
        else:
            back = torch.cat(parts, dim=d)
        assert torch.equal(back, whole), path
    assert split > 0
    if arch == "mixtral-8x7b":   # 2 heads over 4 ranks: attention whole
        for path, whole in _leaves(params):
            if "/mixer/" in path:
                assert all(r[path] is whole for r in ranks), path
    # the mesh's "model" axis of 1 gives the tree back
    assert sh.shard_params(params, cfg, _TorchMesh(
        {"data": 2, "model": 1})) is params


def test_graphs_are_off_on_a_model_axis_above_one():
    """Collectives are not captured: over a "model" axis above 1 a server
    runs its programs eagerly, and ``graphs=True`` raises saying why."""
    from repro_torch.runtime.server import Server, ServingEngine
    cfg = _cfg("phi3-mini-3.8b")
    params = ttf.init_params(torch.Generator().manual_seed(0), cfg)
    mesh = _TorchMesh({"data": 1, "model": 2}, ranks={"model": 1})
    for cls in (Server, ServingEngine):
        with pytest.raises(ValueError, match="cannot be captured"):
            cls(cfg, params, device="cpu", graphs=True, mesh=mesh)
        srv = cls(cfg, params, device="cpu", mesh=mesh)
        assert not srv.programs.graphs
        wq = srv.params["stages"]["s0"]["pos0"]["mixer"]["wq"]
        whole = params["stages"]["s0"]["pos0"]["mixer"]["wq"]
        assert torch.equal(wq, whole[..., cfg.head_dim:])
