"""The port's sharding layer against the JAX package's, on the CPU.

``repro_torch.distributed`` and ``repro_torch.launch.mesh`` against
``repro.distributed`` and ``repro.launch.mesh``, on stand-in meshes (the
layout without ranks: the reference's reads ``axis_names`` and
``devices.shape``, the port's ``mesh_dim_names`` and ``shape``):

* ``resolve_spec``, ``items_partition`` (padding allowed and not, custom
  rules) and ``batch_axes`` on the cases of ``tests/test_substrate.py``
  and ``tests/test_sharded_cstep.py``, as one parametrised test;
* ``tree_shardings`` and ``match_shardings``;
* ``ef_compress``, ``compress_tree`` and ``compression_ratio``: signs bit
  for bit, scale and error at rtol 1e-6;
* ``describe_groups`` under (2, 1) and (8, 1) meshes: the reference's
  partition and pad for every group, the low-rank group replicated;
* under a (2, 2) mesh: ``constrain`` the identity and the reference's
  C-step layout; training over ``"model"`` and the SSM mixers' split
  refused, naming the slice that brings them; the meshes of
  ``launch/mesh.py`` over a one-rank group.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_dist_workers as w
from repro import core as jcore
from repro.core import grouping as jgrouping
from repro.core import schemes as jschemes
from repro.distributed import compression_comm as jcc
from repro.distributed import sharding as jsh
from repro_torch import core
from repro_torch.core import grouping, schemes
from repro_torch.distributed import compression_comm as cc
from repro_torch.distributed import sharding as sh
from torch_threads import _one_torch_thread  # noqa: F401


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


TP = {"data": 16, "model": 16}
POD = {"pod": 2, "data": 16, "model": 16}
SMALL = {"data": 4, "model": 2}
POD2 = {"pod": 2, "data": 2, "model": 2}
POD_RULES = {"items": [("pod", "data"), ("data",), ()]}

#: (function, mesh sizes, arguments, keyword arguments)
CASES = [
    ("resolve_spec", TP, (("embed", "heads_flat"), (4096, 4096)), {}),
    ("resolve_spec", TP, (("vocab", "embed"), (151655, 896)), {}),
    ("resolve_spec", TP, (("batch", "kv_seq", "kv_heads", None),
                          (1, 32768, 16, 128)), {}),
    ("resolve_spec", TP, (("batch", "kv_seq", "kv_heads", None),
                          (128, 32768, 8, 128)), {}),
    ("resolve_spec", POD, (("batch", "seq"), (256, 4096)), {}),
    ("resolve_spec", POD, (("batch", "seq"), (1, 4096)), {}),
    ("resolve_spec", {"data": 2, "model": 1}, (("batch", "seq", None),
                                               (6, 512, 64)), {}),
    ("resolve_spec", SMALL, (("embed", "mlp"), (64, 6)), {"rules":
                                                          jsh.SERVE_RULES}),
    ("items_partition", SMALL, (8,), {}),
    ("items_partition", SMALL, (4,), {}),
    ("items_partition", SMALL, (5,), {}),
    ("items_partition", SMALL, (2,), {}),
    ("items_partition", SMALL, (12,), {}),
    ("items_partition", SMALL, (5,), {"allow_pad": False}),
    ("items_partition", SMALL, (8,), {"allow_pad": False}),
    ("items_partition", {"model": 4}, (8,), {}),
    ("items_partition", POD2, (8,), {"rules": POD_RULES}),
    ("items_partition", POD2, (3,), {"rules": POD_RULES}),
    ("batch_axes", POD, (), {}),
    ("batch_axes", TP, (), {}),
    ("batch_axes", {"data": 3, "model": 1}, (), {}),
]


@pytest.mark.parametrize("fn,sizes,args,kw", CASES,
                         ids=[f"{c[0]}-{i}" for i, c in enumerate(CASES)])
def test_layout_functions_equal_the_reference(fn, sizes, args, kw):
    want = getattr(jsh, fn)(*args, mesh=_JaxMesh(sizes), **kw) \
        if fn != "batch_axes" else jsh.batch_axes(_JaxMesh(sizes))
    kw = dict(kw)
    if kw.get("rules") is jsh.SERVE_RULES:
        kw["rules"] = sh.SERVE_RULES
    got = getattr(sh, fn)(*args, mesh=_TorchMesh(sizes), **kw) \
        if fn != "batch_axes" else sh.batch_axes(_TorchMesh(sizes))
    if fn == "resolve_spec":
        want = tuple(want)
    assert got == want


def test_rule_tables_equal_the_reference():
    assert sh.DEFAULT_RULES == jsh.DEFAULT_RULES
    assert sh.SERVE_RULES == jsh.SERVE_RULES
    assert sh.PRIORITY == jsh.PRIORITY


def test_tree_shardings_and_match_shardings():
    axes = {"a": ("batch", "seq"), "b": {"c": ("embed", "mlp")}}
    shapes = {"a": (8, 16), "b": {"c": (64, 32)}}
    got = sh.tree_shardings(axes, shapes, _TorchMesh(SMALL))
    # the reference's wraps each spec in a NamedSharding (a real mesh)
    assert got == {
        "a": tuple(jsh.resolve_spec(("batch", "seq"), (8, 16),
                                    _JaxMesh(SMALL))),
        "b": {"c": tuple(jsh.resolve_spec(("embed", "mlp"), (64, 32),
                                          _JaxMesh(SMALL)))}}
    like = {"x": torch.zeros(3, dtype=torch.float64)}
    out = sh.match_shardings({"x": torch.ones(3)}, like)
    assert out["x"].dtype == torch.float64 and out["x"].device == like[
        "x"].device


def test_shard_bounds_and_ranks():
    mesh = _TorchMesh(POD2, ranks={"pod": 1, "data": 0})
    assert sh.entry_size(mesh, ("pod", "data")) == 4
    assert sh.entry_rank(mesh, ("pod", "data")) == 2
    assert sh.shard_bounds(8, mesh, ("pod", "data")) == (4, 6)
    assert sh.shard_bounds(6, _TorchMesh({"data": 3, "model": 1},
                                         ranks={"data": 2}), "data") == (4, 6)


def test_error_feedback_equals_the_reference():
    rng = np.random.default_rng(3)
    grads = {"w": rng.standard_normal((32, 8)).astype(np.float32),
             "b": rng.standard_normal(8).astype(np.float32) * 1e-3}
    ef = {k: rng.standard_normal(v.shape).astype(np.float32) * 0.1
          for k, v in grads.items()}
    js, jsc, je = jcc.compress_tree(
        {k: jnp.asarray(v) for k, v in grads.items()},
        {k: jnp.asarray(v) for k, v in ef.items()})
    ts_, tsc, te = cc.compress_tree(
        {k: torch.from_numpy(v) for k, v in grads.items()},
        {k: torch.from_numpy(v) for k, v in ef.items()})
    for k in grads:
        assert ts_[k].dtype == torch.int8
        np.testing.assert_array_equal(ts_[k].numpy(), np.asarray(js[k]))
        np.testing.assert_allclose(float(tsc[k]), float(jsc[k]), rtol=1e-6)
        np.testing.assert_allclose(te[k].numpy(), np.asarray(je[k]),
                                   rtol=1e-6, atol=1e-7)
        np.testing.assert_allclose(
            cc.ef_decompress(ts_[k], tsc[k]).numpy(),
            np.asarray(jcc.ef_decompress(js[k], jsc[k])), rtol=1e-6)
    init = cc.init_ef({k: torch.from_numpy(v) for k, v in grads.items()})
    assert all(torch.equal(init[k], torch.zeros(v.shape))
               for k, v in grads.items())
    for bits in (1.0, 8.0, 16.0):
        assert cc.compression_ratio(bits) == jcc.compression_ratio(bits)


@pytest.mark.parametrize("world", [2, 8])
def test_describe_groups_reports_the_reference_layout(world):
    params = w.cstep_params()
    jp = {n: jnp.asarray(x) for n, x in params.items()}
    tp = {n: torch.from_numpy(x) for n, x in params.items()}
    jtasks = [t.resolve(jp) for t in w.cstep_tasks(jcore, jschemes)]
    ttasks = [t.resolve(tp) for t in w.cstep_tasks(core, schemes)]
    want = jgrouping.describe_groups(
        jtasks, {t.name: t.compressible(jp) for t in jtasks},
        mesh=_JaxMesh({"data": world, "model": 1}), backend="auto")
    got = grouping.describe_groups(
        ttasks, {t.name: t.compressible(tp) for t in ttasks},
        mesh=_TorchMesh({"data": world, "model": 1}), backend="cuda",
        device="cpu")
    assert [g["tasks"] for g in got] == [g["tasks"] for g in want]
    for g, j in zip(got, want):
        assert g["spec"] == (tuple(j["spec"]) if j["spec"] is not None
                             else None), g["tasks"]
        assert g["padding"] == j["padding"], g["tasks"]
        mode = {("la", "lb"): "replicated", ("s",): None}.get(
            tuple(g["tasks"]), "sharded")
        assert g["shard_mode"] == mode, g["tasks"]


def test_a_model_axis_leaves_constrain_and_the_c_step_layout():
    """Under a (2, 2) mesh ``constrain`` is the identity, the LC driver
    takes the mesh, and ``describe_groups`` reports the reference's
    partition and pad: the items shard over "data" only."""
    mesh = _TorchMesh({"data": 2, "model": 2})
    x = torch.zeros(2)
    with sh.use_mesh(mesh):
        assert sh.constrain(x, ("batch",)) is x
        assert sh.active_mesh() is mesh
    assert sh.active_mesh() is None
    lc = core.LCAlgorithm(w.cstep_tasks(core, schemes), [1e-3],
                          device="cpu", mesh=mesh)
    assert lc.mesh is mesh
    params = w.cstep_params()
    jp = {n: jnp.asarray(a) for n, a in params.items()}
    tp = {n: torch.from_numpy(a) for n, a in params.items()}
    jtasks = [t.resolve(jp) for t in w.cstep_tasks(jcore, jschemes)]
    ttasks = [t.resolve(tp) for t in w.cstep_tasks(core, schemes)]
    want = jgrouping.describe_groups(
        jtasks, {t.name: t.compressible(jp) for t in jtasks},
        mesh=_JaxMesh({"data": 2, "model": 2}), backend="auto")
    got = grouping.describe_groups(
        ttasks, {t.name: t.compressible(tp) for t in ttasks}, mesh=mesh,
        backend="cuda", device="cpu")
    assert [g["tasks"] for g in got] == [g["tasks"] for g in want]
    for g, j in zip(got, want):
        assert g["spec"] == (tuple(j["spec"]) if j["spec"] is not None
                             else None), g["tasks"]
        assert g["padding"] == j["padding"], g["tasks"]


def test_a_model_axis_is_refused():
    """Nothing is refused over a "model" axis above 1 any more. Tensor-
    parallel training: the trainer takes the mesh and hands it to the
    algorithm, and each leaf's layout over it is read
    (``tests/test_torch_tp_train.py`` holds both to the reference on
    ranks). The SSM mixers run under the mesh: given whole weights (a
    mixer that ``shard_params`` left whole) they read from the weights'
    shapes that they are not split, issue no collective, and give
    ``mesh=None``'s output and states bit for bit
    (``tests/test_torch_tp_ssm.py`` holds their split to the reference
    on ranks)."""
    import dataclasses

    from repro_torch import configs
    from repro_torch.data import TokenStream
    from repro_torch.models import ssm
    from repro_torch.runtime import LCTrainer
    mesh = _TorchMesh({"data": 2, "model": 2})
    cfg = dataclasses.replace(configs.reduced_config(
        configs.get_config("phi3-mini-3.8b")), dtype="float32")
    lc = core.LCAlgorithm([], [1e-3], device="cpu")
    trainer = LCTrainer(cfg, lc, TokenStream(cfg.vocab_size, 2, 8),
                        mesh=mesh, device="cpu")
    assert trainer.mesh is mesh and lc.mesh is mesh
    layout = core.flatten_params(sh.param_layout(cfg, mesh,
                                                 sh.DEFAULT_RULES))
    assert layout["stages/s0/pos0/ffn/w_down"] == "split"
    assert layout["embed/tokens"] == "split"
    assert layout["final_norm"] == "whole"
    for arch, name in (("jamba-v0.1-52b", "mamba"), ("xlstm-125m", "mlstm"),
                       ("xlstm-125m", "slstm")):
        scfg = dataclasses.replace(configs.reduced_config(
            configs.get_config(arch)), dtype="float32")
        gen = torch.Generator().manual_seed(0)
        params = getattr(ssm, f"init_{name}")(gen, scfg)
        x = torch.randn(2, 8, scfg.d_model, generator=gen)
        spec = next(s for s in scfg.all_layer_specs() if s.mixer == name)
        fwd = getattr(ssm, f"{name}_forward")
        dec = getattr(ssm, f"{name}_decode")
        init = getattr(ssm, f"init_{name}_cache")
        want, want_st = fwd(params, x, scfg, spec, None, return_cache=True)
        # the whole mixer's cache (under the mesh ``init_*_cache`` gives
        # a rank's share, which split weights read)
        caches = [init(scfg, spec, 2, 8, torch.float32, "cpu")
                  for _ in range(2)]
        want_dec = dec(params, x[:, :1], caches[0], 0, scfg, spec)
        with sh.use_mesh(mesh):
            got, got_st = fwd(params, x, scfg, spec, None,
                              return_cache=True)
            got_dec = dec(params, x[:, :1], caches[1], 0, scfg, spec)
        assert torch.equal(got, want), name
        for k in want_st:
            assert torch.equal(got_st[k], want_st[k]), (name, k)
        assert torch.equal(got_dec[0], want_dec[0]), name
        for k in want_dec[1]:
            assert torch.equal(got_dec[1][k], want_dec[1][k]), (name, k)


def test_meshes_over_a_one_rank_group():
    import torch.distributed as dist

    from repro_torch.launch import mesh as lmesh
    if not dist.is_initialized():
        with pytest.raises(RuntimeError, match="no process group"):
            lmesh.make_cstep_mesh(device_type="cpu")
    m = lmesh.make_debug_mesh(device_type="cpu")
    assert dist.is_initialized() and dist.get_world_size() == 1
    assert (m.mesh_dim_names, tuple(m.shape)) == (("data", "model"), (1, 1))
    c = lmesh.make_cstep_mesh(device_type="cpu")
    assert (c.mesh_dim_names, tuple(c.shape)) == (("data", "model"), (1, 1))
    with pytest.raises(ValueError, match="needs 256 ranks"):
        lmesh.make_production_mesh(device_type="cpu")
    with pytest.raises(ValueError, match="needs 512 ranks"):
        lmesh.make_production_mesh(multi_pod=True, device_type="cpu")
    # a one-rank gather and sum are the identity
    x = torch.arange(6.0).reshape(3, 2)
    assert torch.equal(sh.gather_items({"x": x}, c, "data")["x"], x)
    assert torch.equal(sh.all_reduce_sum(x.clone(), c.get_group("data")), x)
