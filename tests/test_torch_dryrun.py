"""The port's dry run and roofline (``repro_torch.launch.dryrun``,
``launch/inputs.py``, ``analysis/op_stats.py``, ``analysis/roofline.py``)
against the JAX package's, on the CPU.

* model FLOPs, ``fused_attention_bytes`` and ``cell_applicable`` equal
  the reference's exactly for every arch × shape;
* the op counter equals ``analyze_hlo`` on ``tests/test_substrate.py``'s
  toys: a matmul and 7 stacked layers exactly, a remat gradient within
  5% of 4× the forward;
* the meta input trees at a one-device mesh have the reference
  ``ShapeDtypeStruct``\\s' paths, global shapes and dtypes (token ids:
  the reference's int32 is int64 in a training batch, as the port's
  ``TokenStream`` yields, and int32 in serving; a decode position is a
  (B,) int64 vector against a 0-d int32); the quantized packs have the
  reference's paths, index and codebook shapes (a stacked leaf is a list
  of one pack a layer against a leading stack dim) and
  ``quantized_weight_bytes_per_chip``;
* reduced phi3-mini and xlstm cells count the reference's FLOPs within
  rtol 1e-6 in prefill; in training the two programs differ by products
  stated below in closed form (ROADMAP §3);
* the dry run's collectives on ``abstract_mesh`` (1, 2) and (2, 2)
  equal, in primitive, bytes, group size and count, those of a real
  2- and 4-rank gloo step;
* the live-memory tracker's exact peak on a hand-built sequence; the
  K4/K5/K6 wrappers' meta outputs against their plain versions; a whole
  cell through the CLI; and no module of the port outside
  ``distributed/sharding.py`` calling a ``torch.distributed`` collective.
"""
import ast
import json
import math
import pathlib
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_dist_workers as w
from repro.analysis import roofline as jrl
from repro.analysis.hlo_stats import analyze_hlo
from repro.configs import SHAPES as JSHAPES
from repro.configs import get_config as jget_config
from repro.configs import reduced_config as jreduced
from repro.configs.base import ShapeCfg as JShapeCfg
from repro.distributed.sharding import use_mesh as juse_mesh
from repro.launch import dryrun as jdryrun
from repro.launch import inputs as jinputs
from repro.launch import steps as jsteps
from repro.models import ssm as jssm
from repro_torch.analysis import op_stats
from repro_torch.analysis import roofline as rl
from repro_torch.configs import ARCHS, SHAPES, get_config, reduced_config
from repro_torch.configs.base import ShapeCfg
from repro_torch.launch import dryrun, inputs
from repro_torch.launch.mesh import abstract_mesh
from repro_torch.models import ssm
from repro_torch.runtime.compressed import QuantizedWeight
from torch_threads import _one_torch_thread  # noqa: F401

SRC = pathlib.Path(__file__).resolve().parents[1] / "src" / "repro_torch"
META = torch.device("meta")


def _jmesh():
    return jax.sharding.Mesh(np.array(jax.devices()[:1]).reshape(1, 1),
                             ("data", "model"))


def _meta(*shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device=META)


# ----------------------------------------------------------------------
# model FLOPs and applicability
# ----------------------------------------------------------------------
@pytest.mark.parametrize("arch", ARCHS)
def test_model_flops_and_applicability_match_reference(arch):
    cfg, jcfg = get_config(arch), jget_config(arch)
    for name, sh in SHAPES.items():
        jsh = JSHAPES[name]
        tokens = sh.global_batch * sh.seq_len
        assert rl.model_flops_train(cfg, tokens) == \
            jrl.model_flops_train(jcfg, tokens)
        assert rl.model_flops_prefill(cfg, tokens) == \
            jrl.model_flops_prefill(jcfg, tokens)
        assert rl.model_flops_decode(cfg, sh.global_batch, sh.seq_len) \
            == jrl.model_flops_decode(jcfg, sh.global_batch, sh.seq_len)
        for chips in (256, 512):
            assert rl.fused_attention_bytes(cfg, sh, chips) == \
                jrl.fused_attention_bytes(jcfg, jsh, chips)
        assert dryrun.cell_applicable(cfg, sh) == \
            jdryrun.cell_applicable(jcfg, jsh)


# ----------------------------------------------------------------------
# the counter on tests/test_substrate.py's toys
# ----------------------------------------------------------------------
def test_counter_matmul_equals_reference():
    m, k, n = 128, 64, 32
    ref = analyze_hlo(jax.jit(lambda a, b: a @ b).lower(
        jnp.zeros((m, k)), jnp.zeros((k, n))).compile().as_text()).flops
    st = op_stats.analyze_step(lambda a, b: a @ b, _meta(m, k), _meta(k, n))
    assert st.flops == ref == 2 * m * n * k
    assert st.flops_by_class == {"f32": ref}
    assert st.bytes == 4 * (m * k + k * n + m * n)


def test_counter_stacked_layers_equal_reference():
    def f(x, ws):
        return jax.lax.scan(lambda c, w_: (c @ w_, None), x, ws)[0]
    ref = analyze_hlo(jax.jit(f).lower(
        jnp.zeros((32, 16)), jnp.zeros((7, 16, 16))).compile().as_text())

    def g(x, ws):
        for i in range(ws.shape[0]):
            x = x @ ws[i]
        return x
    st = op_stats.analyze_step(g, _meta(32, 16), _meta(7, 16, 16))
    assert st.flops == ref.flops == 7 * 2 * 32 * 16 * 16


def test_counter_remat_gradient_is_four_forwards():
    def loss(ws, x):
        out, _ = jax.lax.scan(
            jax.checkpoint(lambda c, w_: (jnp.tanh(c @ w_), None)), x, ws)
        return jnp.sum(out ** 2)
    ref = analyze_hlo(jax.jit(jax.grad(loss)).lower(
        jnp.zeros((4, 64, 64)), jnp.zeros((8, 64))).compile().as_text())

    def grad(ws, x, wrt_x):
        ws = ws.detach().requires_grad_(True)
        x = x.detach().requires_grad_(wrt_x)
        c = x
        for i in range(ws.shape[0]):
            c = torch.utils.checkpoint.checkpoint(
                lambda c_, w_: torch.tanh(c_ @ w_), c, ws[i],
                use_reentrant=False)
        return torch.autograd.grad(torch.sum(c ** 2),
                                   (ws, x) if wrt_x else ws)
    fwd = 4 * 2 * 8 * 64 * 64
    assert abs(ref.flops - 4 * fwd) / (4 * fwd) < 0.05
    # the scan's transpose forms the first carry's gradient in every
    # trip; the unrolled loop does so only where x asks for it
    st = op_stats.analyze_step(grad, _meta(4, 64, 64), _meta(8, 64), True)
    assert abs(st.flops - 4 * fwd) / (4 * fwd) < 0.05
    st = op_stats.analyze_step(grad, _meta(4, 64, 64), _meta(8, 64), False)
    assert st.flops == 4 * fwd - 2 * 8 * 64 * 64


# ----------------------------------------------------------------------
# the meta input trees against the reference's ShapeDtypeStructs
# ----------------------------------------------------------------------
_DT = {"float32": torch.float32, "bfloat16": torch.bfloat16,
       "uint8": torch.uint8}


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}/{k}" if prefix else str(k)))
        return out
    return {prefix: tree}


def _same_tree(port, ref, ids=torch.int64):
    """Paths, shapes and dtypes equal, the reference's int32 standing for
    ``ids``."""
    fp, fr = _flat(port), _flat(ref)
    assert sorted(fp) == sorted(fr)
    for p, r in fr.items():
        t = fp[p]
        assert tuple(t.shape) == tuple(r.shape), p
        want = ids if str(r.dtype) == "int32" else _DT[str(r.dtype)]
        assert t.dtype == want, (p, t.dtype, r.dtype)
        assert t.device == META


INPUT_ARCHS = ["phi3-mini-3.8b", "mixtral-8x7b", "xlstm-125m",
               "jamba-v0.1-52b", "minicpm3-4b", "musicgen-large"]


@pytest.mark.parametrize("arch", INPUT_ARCHS)
def test_input_trees_match_reference(arch):
    cfg, jcfg = get_config(arch), jget_config(arch)
    jm, mesh = _jmesh(), abstract_mesh((1, 1))
    with juse_mesh(jm):
        for name in ("train_4k", "decode_32k", "prefill_32k"):
            sh, jsh = SHAPES[name], JSHAPES[name]
            if sh.kind == "train":
                _same_tree(inputs.batch_specs(cfg, sh, mesh),
                           jinputs.batch_specs(jcfg, jsh, jm))
                _same_tree(inputs.train_state_specs(cfg, mesh),
                           jinputs.train_state_specs(jcfg, jm),
                           ids=torch.int32)
            elif sh.kind == "decode":
                params, cache, toks, pos = inputs.decode_specs(cfg, sh, mesh)
                jp, jc, jt, jpos = jinputs.decode_specs(jcfg, jsh, jm)
                _same_tree(params, jp)
                _same_tree(cache, jc)
                _same_tree(toks, jt, ids=torch.int32)
                assert jpos.shape == () and str(jpos.dtype) == "int32"
                assert tuple(pos.shape) == (sh.global_batch,)
                assert pos.dtype == torch.int64
            else:
                params, toks = inputs.prefill_specs(cfg, sh, mesh)
                jp, jt = jinputs.prefill_specs(jcfg, jsh, jm)
                _same_tree(params, jp)
                _same_tree(toks, jt, ids=torch.int32)


@pytest.mark.parametrize("arch", ["phi3-mini-3.8b", "mixtral-8x7b"])
def test_quantized_packs_match_reference(arch):
    cfg, jcfg = get_config(arch), jget_config(arch)
    jm = _jmesh()
    sh, jsh = SHAPES["decode_32k"], JSHAPES["decode_32k"]
    with juse_mesh(jm):
        params = inputs.decode_specs(cfg, sh, abstract_mesh((1, 1)),
                                     quantized=True)[0]
        jp = jinputs.decode_specs(jcfg, jsh, jm, quantized=True)[0]
    fp = _flat(params)
    fr = _flat(jp)
    ref_packs = {p[:-len("/idx")] for p in fr if p.endswith("/idx")}
    port_packs = {p for p, v in fp.items()
                  if isinstance(v, (QuantizedWeight, list))}
    assert port_packs == ref_packs and ref_packs
    for p in ref_packs:
        idx, cb = fr[p + "/idx"], fr[p + "/cb"]
        packs = fp[p] if isinstance(fp[p], list) else [fp[p]]
        stacked = isinstance(fp[p], list)
        shape = ((len(packs),) if stacked else ()) + tuple(packs[0].shape)
        assert shape == tuple(idx.shape), p
        cb_shape = ((len(packs),) if stacked else ()) + tuple(
            packs[0].codebook.shape)
        assert cb_shape == tuple(cb.shape), p
        assert all(q.packed.dtype == torch.uint8 and q.bits == 8
                   and q.packed.device == META for q in packs)
    dense = {p for p in fr if not p.endswith(("/idx", "/cb"))}
    assert dense == {p for p in fp if p not in port_packs}
    assert inputs.quantized_weight_bytes_per_chip(params) == \
        jinputs.quantized_weight_bytes_per_chip(jp)


# ----------------------------------------------------------------------
# reduced cells: the port's FLOPs against the reference's analyze_hlo
# ----------------------------------------------------------------------
B, S = 2, 16        # one CE chunk (S ≤ 512) and two mLSTM chunks of 8


def _ref_flops(arch: str, kind: str) -> float:
    cfg = jreduced(jget_config(arch))
    sh = JShapeCfg("r", S, B, kind)
    jm = _jmesh()
    with juse_mesh(jm), jm:
        if kind == "train":
            low = jax.jit(jsteps.make_train_step(cfg)).lower(
                jinputs.train_state_specs(cfg, jm),
                jinputs.batch_specs(cfg, sh, jm))
        else:
            low = jax.jit(jsteps.make_prefill_step(cfg)).lower(
                *jinputs.prefill_specs(cfg, sh, jm))
    return analyze_hlo(low.compile().as_text()).flops


def _train_difference(cfg) -> float:
    """port − reference FLOPs of a train step of ``cfg`` at B × S:

    * the cross-entropy over one chunk (S ≤ 512): the reference's
      checkpointed scan has one trip, which XLA removes and whose
      recomputed logits it merges with the forward's, so it counts 3
      products of the logits where the port counts 4 (forward, the
      recomputation, and the two of the backward): + 2·B·S·d·V;
    * the unrolled loops skip the gradient of their first step's carry,
      a constant, which the reference's scan transposes in every trip: a
      mLSTM block's first chunk (L tokens, H heads of dh) − (5·2BH·dh²·L
      + 4·2BH·dh·L² + 2BH·dh·L), an sLSTM block's first step − 2·B·H·
      4dh·dh (its own dh);
    * under remat the port recomputes each checkpointed mLSTM chunk twice
      (the block's recomputation runs the chunk's checkpoint, whose own
      backward recomputes it again), XLA once: + (2·2BH·dh²·L +
      2·2BH·dh·L² + 2BH·dh·L) a chunk of each mLSTM block.
    """
    specs = cfg.all_layer_specs()
    diff = 2.0 * B * S * cfg.d_model * cfg.vocab_size
    n_m = sum(s.mixer == "mlstm" for s in specs)
    n_s = sum(s.mixer == "slstm" for s in specs)
    h = cfg.n_heads
    if n_m:
        _, dh = ssm.mlstm_dims(cfg)
        el = cfg.xlstm.chunk
        big, mid, small = (2 * B * h * dh * dh * el, 2 * B * h * dh * el * el,
                           2 * B * h * dh * el)
        diff -= n_m * (5 * big + 4 * mid + small)
        if cfg.remat:
            diff += n_m * (S // el) * (2 * big + 2 * mid + small)
    if n_s:
        _, dh, _ = ssm.slstm_dims(cfg)
        diff -= n_s * 2 * B * h * 4 * dh * dh
    return diff


@pytest.mark.parametrize("arch", ["phi3-mini-3.8b", "xlstm-125m"])
@pytest.mark.parametrize("kind", ["prefill", "train"])
def test_reduced_cell_flops_match_reference(arch, kind):
    cfg = reduced_config(get_config(arch))
    stats, *_ = dryrun.trace_cell(cfg, ShapeCfg("r", S, B, kind), None)
    ref = _ref_flops(arch, kind)
    want = ref + (_train_difference(cfg) if kind == "train" else 0.0)
    assert stats.flops == pytest.approx(want, rel=1e-6, abs=0)
    assert sum(stats.flops_by_class.values()) == stats.flops
    assert stats.bytes > 0 and stats.peak_bytes > 0


# ----------------------------------------------------------------------
# collectives: the recorder against a real gloo step
# ----------------------------------------------------------------------
@pytest.mark.parametrize("shape", [(1, 2), (2, 2)])
def test_dry_run_collectives_match_a_real_gloo_step(shape, tmp_path):
    world = math.prod(shape)
    w.spawn(w.dryrun_collectives, world, tmp_path, shape, str(tmp_path))
    real = [torch.load(tmp_path / f"rank{r}.pt") for r in range(world)]
    cfg = w.dryrun_config()
    for kind, (s, b) in w.DRYRUN_SHAPES.items():
        for rank in range(world):
            st, *_ = dryrun.trace_cell(
                cfg, ShapeCfg("r", s, b, kind),
                abstract_mesh(shape, rank=rank))
            got = [(c.primitive, c.bytes, c.size) for c in st.collectives]
            assert got == real[rank][kind], (kind, rank)
            assert len(got) == st.coll_count > 0


# ----------------------------------------------------------------------
# memory, wrappers, repairs
# ----------------------------------------------------------------------
def test_memory_tracker_exact_peak():
    given = _meta(100)                       # 400 B → one 512-B block
    with op_stats.OpCounter(args=(given,)) as c:
        a = torch.zeros(1000, device=META)   # 4000 B → 4096
        v = a.view(10, 100)                  # a view: no storage
        b = a + 1.0                          # 4096 more: 8192
        del a                                # v keeps the storage
        x = given * 2.0                      # 512 more: 8704 (peak)
        del v, x                             # 4096 left
        d = torch.zeros(200, device=META)    # 800 B → 1024
    assert c.stats.peak_bytes == 8704
    assert c.stats.arg_bytes == 512
    assert c.stats.bytes == 4000 + 2 * 4000 + 2 * 400 + 800
    del b, d


def test_skipped_scope_counts_flops_but_no_bytes_backward_too():
    """A skipped scope (the reference's ``skip_scopes``): its products
    count FLOPs and no bytes, in the backward pass too."""
    def step(x, w):
        w = w.detach().requires_grad_(True)
        with op_stats.scope("fused"):
            y = x @ w
        return torch.autograd.grad(torch.sum(y), w)
    x, w = _meta(4, 3), _meta(3, 5)
    full = op_stats.analyze_step(step, x, w)
    skip = op_stats.analyze_step(step, x, w, skip_scopes=("fused",))
    assert skip.flops == full.flops == 2 * 2 * 4 * 3 * 5
    assert skip.skipped_ops == 2           # the product and its gradient
    assert full.bytes - skip.bytes == 4 * (4 * 3 + 3 * 5 + 4 * 5) * 2


def test_kernel_wrappers_meta_outputs_match_plain():
    from repro_torch.kernels.flash_attention import flash_attention as k6
    from repro_torch.kernels.quant_matmul import quant_matmul as k45
    g = torch.Generator().manual_seed(0)
    q = torch.randn(2, 2, 3, 24, 16, generator=g)
    k = torch.randn(2, 2, 24, 16, generator=g)
    v = torch.randn(2, 2, 24, 16, generator=g)
    x = torch.randn(12, 32, generator=g)
    idx = torch.randint(0, 16, (32, 40), generator=g, dtype=torch.uint8)
    packed = torch.randint(0, 256, (16, 40), generator=g, dtype=torch.uint8)
    cb = torch.randn(16, generator=g)
    cases = [("K6", k6.flash_attention, (q, k, v), {"window": 8}),
             ("K5", k45.quant_matmul, (x, idx, cb), {}),
             ("K4", k45.quant_matmul_packed, (x, packed, cb), {})]
    for label, fn, args, kw in cases:
        plain = fn(*args, **kw)
        metas = [a.to(META) for a in args]
        with op_stats.OpCounter() as c:
            out = fn(*metas, **kw)
        assert out.device == META and out.shape == plain.shape
        assert out.dtype == plain.dtype
        assert dict(c.stats.launches) == {label: 1}
        assert c.stats.ops == {}       # the wrapper's own ops count not
    flops, nbytes = k6.cost(2, 2, 3, 24, 16, 16, 8)
    assert flops == 2 * 32 * (8 * 9 // 2 + 16 * 8) * 12
    assert k45.cost(12, 32, 40, 32 * 40, 16) == (
        2.0 * 12 * 32 * 40, 4.0 * (12 * 32 + 12 * 40 + 16) + 32 * 40,
        "tf32")
    assert k45.cost(2, 32, 40, 16 * 40, 16)[2] == "f32"


def test_slstm_cell_promotes_bf16_weights_as_the_reference():
    """Serving weights in bf16 against an f32 state: the port's recurrent
    product raised on the dtype mismatch; it now promotes to f32 as the
    reference's einsum does."""
    cfg = reduced_config(get_config("xlstm-125m"))
    di, dh, _ = ssm.slstm_dims(cfg)
    h = cfg.n_heads
    rng = np.random.default_rng(0)
    r = rng.standard_normal((4, h, dh, dh)).astype(np.float32)
    bias = rng.standard_normal(4 * di).astype(np.float32)
    wx = rng.standard_normal((3, 4 * di)).astype(np.float32)
    st = [rng.standard_normal((3, di)).astype(np.float32) for _ in range(4)]
    r16 = torch.tensor(r).bfloat16()
    got = ssm._slstm_cell({"r": r16, "b": torch.tensor(bias)},
                          torch.tensor(wx), [torch.tensor(x) for x in st],
                          cfg)
    ref = jssm._slstm_cell({"r": jnp.asarray(r16.float().numpy(),
                                             jnp.bfloat16),
                            "b": jnp.asarray(bias)}, jnp.asarray(wx),
                           [jnp.asarray(x) for x in st],
                           jreduced(jget_config("xlstm-125m")))
    (state, hidden), (jstate, jhidden) = got, ref
    for a, b in zip([*jstate, jhidden], [*state, hidden]):
        assert b.dtype == torch.float32
        np.testing.assert_allclose(np.asarray(a), b.numpy(), rtol=1e-5,
                                   atol=1e-5)


def test_sum_kv_copies_passes_a_weight_form():
    """A quantized kv weight under a "model" axis above its kv heads (as
    mixtral's 8 at 16): ``sum_kv_copies`` asked autograd of a weight form
    and raised; a form records no gradient and passes through."""
    from repro_torch.distributed import sharding
    pack = QuantizedWeight(_meta(64, 8, dtype=torch.uint8), _meta(16),
                           (64, 8), 8)
    with sharding.use_mesh(abstract_mesh((1, 4))), torch.enable_grad():
        assert sharding.sum_kv_copies(pack, 0, 8, 16) is pack


# ----------------------------------------------------------------------
# a whole cell, through the CLI, and the collectives' one call site
# ----------------------------------------------------------------------
def test_dryrun_cli_cell_ok_with_reference_row(tmp_path, monkeypatch):
    monkeypatch.setattr(sys, "argv", [
        "dryrun", "--arch", "xlstm-125m", "--shape", "decode_32k",
        "--multi-pod", "--out", str(tmp_path), "--force"])
    with pytest.raises(SystemExit) as e:
        dryrun.main()
    assert e.value.code == 0
    row = json.loads((tmp_path / "xlstm-125m__decode_32k__2x16x16.json")
                     .read_text())
    assert row["status"] == "ok", row
    jterms = jrl.RooflineTerms("a", "s", "m", 1, 1.0, 1.0, 1.0)
    want = set(jterms.row()) | {"arch", "shape", "mesh", "variant",
                                "status", "t_lower_s", "t_compile_s",
                                "extra_bytes_per_chip"}
    assert want <= set(row)
    assert row["chips"] == 512 and row["mesh"] == "2x16x16"
    for key in ("flops_per_chip", "bytes_per_chip", "t_compute_s",
                "t_memory_s", "t_collective_s", "peak_bytes_per_chip"):
        assert math.isfinite(row[key]) and row[key] > 0, key
    assert row["coll_links"] == {"model": "nic"}


_COLLECTIVES = {"all_reduce", "all_gather", "all_gather_into_tensor",
                "reduce_scatter", "reduce_scatter_tensor", "all_to_all",
                "all_to_all_single", "broadcast", "barrier", "send", "recv",
                "isend", "irecv", "reduce", "gather", "scatter",
                "batch_isend_irecv", "all_gather_object",
                "broadcast_object_list", "monitored_barrier"}


def _dist_calls(tree: ast.AST) -> list:
    """Calls of ``dist.<collective>`` / ``torch.distributed.<collective>``
    and collectives imported from ``torch.distributed``."""
    imported = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.ImportFrom) and \
                node.module == "torch.distributed":
            imported |= {a.asname or a.name for a in node.names
                         if a.name in _COLLECTIVES}
    out = []
    for node in ast.walk(tree):
        if not isinstance(node, ast.Call):
            continue
        f = node.func
        if isinstance(f, ast.Attribute) and f.attr in _COLLECTIVES:
            base = ast.unparse(f.value)
            if base in ("dist", "torch.distributed"):
                out.append(node.lineno)
        elif isinstance(f, ast.Name) and f.id in imported:
            out.append(node.lineno)
    return out


def test_only_sharding_calls_collectives():
    found = {}
    for path in sorted(SRC.rglob("*.py")):
        calls = _dist_calls(ast.parse(path.read_text()))
        if calls:
            found[str(path.relative_to(SRC))] = calls
    assert set(found) == {"distributed/sharding.py"}, found
