"""The SSM mixers split over the port's tensor-parallel "model" axis, on
``gloo`` ranks, against the JAX package, on the CPU.

At world size 2 (mesh (1, 2)) and 4 (meshes (1, 4) and (2, 2)) every
rank (``torch.multiprocessing`` ranks, a ``FileStore`` under
``tmp_path``; ``tests/torch_dist_workers.py``) takes its slices of the
whole tree: Mamba's channels, mLSTM's and sLSTM's whole heads, each
fused leaf (``in_proj``, ``up_proj``, sLSTM's ``w`` and ``b``) in one
segment a part. The cases are reduced float32 configs with 4 heads, so
that the heads split at m = 2 and 4:

* serving: jamba (layers 2–4 of its pattern: Mamba with a dense FFN,
  Mamba with MoE, attention), dense and with 4-bit ``in_proj``/
  ``out_proj`` and 8-bit ``x_proj``/``dt_proj`` bridged through the
  reference's LC state; xlstm stacked (2 repetitions of mLSTM + sLSTM),
  dense; xlstm unrolled (mLSTM, mLSTM, sLSTM) with 4-bit projections
  and 8-bit q/k/v. ``Server.generate``'s greedy tokens equal the
  reference's, its prefill logits within rtol 1e-5 / atol
  1e-5·max|logit|, and the engine's tokens of a 6-request trace equal
  the reference's ``ServingEngine``'s (the unrolled xlstm's against the
  port's one-process engine: the reference's engine cannot serve an
  unrolled xlstm, ROADMAP §3; ``tests/test_torch_ssm.py`` holds that
  engine to the reference's on the stacked layout);
* training: one train step of jamba (MoE at capacity factor 8, so that
  no token drops on a data shard) and of xlstm from the reference's
  state, against the reference's ``make_train_step`` and ``jax.grad``:
  the metrics within rtol 1e-5, every leaf's gradient before clipping,
  gathered, within rtol 1e-5 / atol 1e-5·max|g| (xlstm's normwise atol
  2e-5·max(1, max|leaf|), ROADMAP §3). A rank that did not sum the
  gradient of a result it reads only in part (``x_proj``'s output, the
  gathered q/k/v inputs, a split RMS) holds only its share there, which
  this catches;
* ``LCTrainer(mesh=(1, 2))`` of each, 2 LC steps of 2 L steps, the
  segmented leaves quantized (``torch_dist_workers.ssm_tasks``): each C
  step and multiplier step, on the gathered weights, equals
  ``LCAlgorithm(mesh=None)``'s bit for bit; the losses follow the
  one-process run; checkpoints move across model sizes 1, 2 and 4;
* ``shard_params`` ∘ ``gather_params`` is the identity on every SSM
  leaf in every weight form, the segmented leaves included.

The reference runs in this process only, on its single CPU device.
"""
import concurrent.futures
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_dist_workers as w
from repro import configs as jconfigs
from repro.core import AsVector as JAsVector
from repro.core import CompressionTask as JTask, LCAlgorithm as JLC
from repro.core import schemes as js
from repro.launch import steps as jsteps
from repro.models import transformer as jtf
from repro.runtime import server as jserver
from repro_torch import configs as tconfigs
from repro_torch import interop
from repro_torch.checkpoint import CheckpointManager
from repro_torch.core import LCAlgorithm, exponential_mu_schedule
from repro_torch.distributed import sharding as sh
from repro_torch.models import transformer as ttf
from repro_torch.runtime import server as tserver
from repro_torch.tree import tree_leaves
from torch_threads import _one_torch_thread  # noqa: F401

MESHES = {2: [(1, 2)], 4: [(1, 4), (2, 2)]}
ALL_MESHES = [s for shapes in MESHES.values() for s in shapes]
IDS = [f"{s[0]}x{s[1]}" for s in ALL_MESHES]

#: the layouts: (arch, pattern slice, repetitions)
LAYOUTS = {"jamba": ("jamba-v0.1-52b", slice(2, 5), 1),
           "xlstm-stacked": ("xlstm-125m", slice(4, 6), 2),
           "xlstm": ("xlstm-125m", slice(3, 6), 1)}
MAMBA_Q4, MAMBA_Q8 = r"mixer/(in_proj|out_proj)$", r"mixer/(x_proj|dt_proj)$"
XLSTM_Q4 = r"mixer/(up_proj|down_proj|w)$"
XLSTM_Q8 = r"mixer/(wq|wk|wv)$"
#: serving case → (layout, weight-form tasks or None)
SERVE = {"jamba": ("jamba", None),
         "jamba-quant": ("jamba", [("q4", MAMBA_Q4, 16), ("q8", MAMBA_Q8, 64)]),
         "xlstm-stacked": ("xlstm-stacked", None),
         "xlstm-quant": ("xlstm", [("q4", XLSTM_Q4, 16), ("q8", XLSTM_Q8, 64)])}
#: the reference's engine cannot serve an unrolled xlstm
ENGINE_AGAINST_PORT = ("xlstm-quant",)
TRAIN = ("jamba", "xlstm")


def _cfg(mod, layout):
    arch, cut, reps = LAYOUTS[layout]
    c = dataclasses.replace(mod.reduced_config(mod.get_config(arch)),
                            dtype="float32", n_heads=4, n_kv_heads=4)
    if c.moe is not None:
        c = c.with_(moe=dataclasses.replace(c.moe, capacity_factor=8.0))
    return c.with_(pattern=c.pattern[cut], pattern_reps=reps)


def _prompts():
    return np.random.default_rng(0).integers(1, 256, (2, 8)).astype(np.int32)


def _trace():
    rng = np.random.default_rng(1)
    return [(i, rng.integers(1, 256, size=int(rng.integers(2, 7)))
             .astype(np.int32), int(rng.integers(2, 5)), 0.001 * i)
            for i in range(6)]


def _np(tree):
    return jax.tree_util.tree_map(lambda x: np.array(x, copy=True), tree)


def _reference_serve(name):
    """The reference's config, serving tree and results of one case:
    the port's random params (as numpy), bridged to weight forms through
    the reference's LC state."""
    layout, tasks = SERVE[name]
    jcfg = _cfg(jconfigs, layout)
    jp = jax.tree_util.tree_map(jnp.asarray, interop.to_numpy(
        ttf.init_params(torch.Generator().manual_seed(0),
                        _cfg(tconfigs, layout))))
    if tasks is not None:
        algo = JLC([JTask(n, p, JAsVector(), js.AdaptiveQuantization(k=k))
                    for n, p, k in tasks], [1e-4])
        jp, _ = jserver.load_compressed_for_serving(jp, algo.init(jp),
                                                    algo.tasks)
    prompts = jnp.asarray(_prompts())
    logits = jax.jit(lambda p, x: jtf.prefill(p, x, jcfg))(jp, prompts)
    toks = jserver.Server(jcfg, jp, max_len=w.TP_MAX_LEN).generate(
        prompts, w.TP_NEW).tokens
    out = {"jp": jp, "tokens": np.asarray(toks),
           "logits": np.asarray(logits[:, 0])}
    if name not in ENGINE_AGAINST_PORT:
        run = jserver.ServingEngine(jcfg, jp, **w.TP_ENGINE).run(
            [jserver.Request(*r) for r in _trace()])
        out["engine"] = {f.id: np.asarray(f.tokens)
                         for f in run["finished"]}
    return out


def _reference_state(jcfg):
    """The reference's train state from seed 0, its LC refs moved off
    ``a = w`` so that the penalty takes part (as numpy)."""
    st = _np(jsteps.init_train_state(jax.random.PRNGKey(0), jcfg))
    rng = np.random.default_rng(1)
    for p in sorted(st["lc"]["a"]):
        a = st["lc"]["a"][p]
        st["lc"]["a"][p] = (a + 0.01 * rng.standard_normal(a.shape)
                            ).astype(np.float32)
        st["lc"]["lam"][p] = (0.01 * rng.standard_normal(a.shape)
                              ).astype(np.float32)
    st["lc"]["mu"] = np.float32(0.5)
    return st


def _batch(cfg, seed=3):
    rng = np.random.default_rng(seed)
    shape = (w.TPT_BATCH, w.TPT_SEQ)
    return {k: rng.integers(0, cfg.vocab_size, shape).astype(np.int32)
            for k in ("inputs", "labels")}


def _reference_step(jcfg, st, batch):
    """The reference's metrics and gradients before clipping."""
    js_ = jax.tree_util.tree_map(jnp.asarray, st)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}

    def lossf(p):
        loss, _ = jtf.loss_fn(p, jb, jcfg)
        lc = js_["lc"]
        return loss + jsteps.lc_penalty_from_refs(p, lc["a"], lc["lam"],
                                                  lc["mu"])

    grads = jax.jit(jax.grad(lossf))(js_["params"])
    _, metrics = jax.jit(jsteps.make_train_step(jcfg, lr=w.TPT_LR))(js_, jb)
    return {"metrics": {k: float(v) for k, v in metrics.items()},
            "grads": _np(grads)}


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """The ranks' results at world sizes 2 and 4 (spawned together, on
    threads of their own, while this process runs the reference), the
    references, and the port's one-process trainers and engines."""
    tmp = tmp_path_factory.mktemp("tp_ssm")
    serve = {n: {"cfg": _cfg(tconfigs, SERVE[n][0])} for n in SERVE}
    refs = {n: _reference_serve(n) for n in SERVE}
    for n, case in serve.items():
        case["params"] = interop.serving_params_from_numpy(
            jax.tree_util.tree_map(np.asarray, refs[n].pop("jp")), "cpu")
    train, states = {}, {}
    for n in TRAIN:
        jcfg, tcfg = _cfg(jconfigs, n), _cfg(tconfigs, n)
        states[n] = (jcfg, _reference_state(jcfg))
        train[n] = {"cfg": tcfg, "state": states[n][1],
                    "batch": _batch(tcfg)}
    one, trainer = {}, {}
    for n in TRAIN:
        ckpt = str(tmp / f"ckpt_one_{n}")
        one[n] = w.tpt_trainer(train[n]["cfg"], None, "quantize", "off",
                               ckpt, w.ssm_tasks)
        trainer[n] = {"cfg": train[n]["cfg"], "ckpt": ckpt,
                      "template": one[n][2]}
    torch.save({"serve": serve, "train": train, "trainer": trainer,
                "forms": {n: _cfg(tconfigs, n) for n in ("jamba", "xlstm")},
                "prompts": _prompts(), "trace": _trace(),
                "meshes": MESHES}, tmp / "inputs.pt")

    def spawn(world):
        (tmp / f"world{world}").mkdir()
        w.spawn(w.tp_ssm, world, tmp, str(tmp / "inputs.pt"),
                str(tmp / f"world{world}"))

    with concurrent.futures.ThreadPoolExecutor(len(MESHES)) as pool:
        spawned = [pool.submit(spawn, world) for world in MESHES]
        steps = {n: _reference_step(*states[n], train[n]["batch"])
                 for n in TRAIN}
        for n in ENGINE_AGAINST_PORT:
            run = tserver.ServingEngine(
                serve[n]["cfg"], serve[n]["params"], device="cpu",
                **w.TP_ENGINE).run([tserver.Request(*r) for r in _trace()])
            refs[n]["engine"] = {f.id: f.tokens for f in run["finished"]}
        for s in spawned:
            s.result()
    got = {world: [torch.load(tmp / f"world{world}" / f"rank{r}.pt",
                              weights_only=False) for r in range(world)]
           for world in MESHES}
    return {"ranks": got, "refs": refs, "steps": steps, "one": one,
            "tmp": tmp, "cfgs": {n: train[n]["cfg"] for n in TRAIN}}


def _at(ranks, shape):
    return ranks["ranks"][shape[0] * shape[1]]


@pytest.mark.parametrize("shape", ALL_MESHES, ids=IDS)
@pytest.mark.parametrize("name", list(SERVE))
def test_server_and_engine_over_the_model_axis_equal_the_reference(
        ranks, shape, name):
    ref = ranks["refs"][name]
    assert sorted(ref["engine"]) == list(range(len(_trace())))
    for r, got in enumerate(_at(ranks, shape)):
        g = got[(shape, "serve", name)]
        np.testing.assert_array_equal(g["tokens"], ref["tokens"],
                                      err_msg=f"rank {r}")
        np.testing.assert_allclose(
            g["logits"], ref["logits"], rtol=1e-5,
            atol=1e-5 * np.abs(ref["logits"]).max(), err_msg=f"rank {r}")
        assert sorted(g["engine"]) == sorted(ref["engine"]), f"rank {r}"
        for i, want in ref["engine"].items():
            np.testing.assert_array_equal(g["engine"][i], want,
                                          err_msg=f"rank {r} request {i}")


def _close_grads(got, want, normwise, what):
    """Gathered gradients within rtol 1e-5 / atol 1e-5·max|g| a leaf
    (``normwise``: atol ``normwise``·max(1, max|g|))."""
    gl = jax.tree_util.tree_leaves_with_path(interop.to_numpy(got))
    wl = dict((jax.tree_util.keystr(p), x) for p, x in
              jax.tree_util.tree_leaves_with_path(want))
    assert len(gl) == len(wl), what
    for p, x in gl:
        y = wl[jax.tree_util.keystr(p)]
        scale = float(np.abs(y).max())
        atol = normwise * max(1.0, scale) if normwise else 1e-5 * scale
        np.testing.assert_allclose(x, y, rtol=1e-5, atol=atol,
                                   err_msg=f"{what} {jax.tree_util.keystr(p)}")


@pytest.mark.parametrize("shape", ALL_MESHES, ids=IDS)
@pytest.mark.parametrize("name", TRAIN)
def test_gradients_over_the_model_axis_equal_the_reference(ranks, shape,
                                                           name):
    ref = ranks["steps"][name]
    normwise = 2e-5 if name == "xlstm" else 0.0
    for r, rank in enumerate(_at(ranks, shape)):
        got = rank[(shape, "train", name)]
        for k in ("loss", "ce", "lc_penalty", "grad_norm"):
            np.testing.assert_allclose(got["metrics"][k], ref["metrics"][k],
                                       rtol=1e-5, err_msg=f"rank {r} {k}")
        _close_grads(got["grads"], ref["grads"], normwise, f"rank {r}")


def _equal_trees(a, b, what):
    la, lb = tree_leaves(a), tree_leaves(b)
    assert len(la) == len(lb), what
    for x, y in zip(la, lb):
        if isinstance(x, torch.Tensor):
            assert x.dtype == y.dtype and torch.equal(x, y), what
        else:
            assert x == y, what


@pytest.mark.parametrize("name", TRAIN)
def test_trainer_c_steps_equal_one_process_on_gathered_weights(ranks, name):
    """Every C step and multiplier step a rank of (1, 2) ran, replayed by
    ``LCAlgorithm(mesh=None)`` on the same gathered weights and LC state,
    gives the same Θ, Δ(Θ) and λ bit for bit; both ranks ran the same
    steps and end with the same state; the losses are within rtol 1e-5
    of the one-process run's."""
    cfg = ranks["cfgs"][name]
    runs = [r[("trainer", name)] for r in _at(ranks, (1, 2))]
    steps = [run["steps"] for run in runs]
    assert [s[0] for s in steps[0]] == ["c_step", "multiplier_step"] * 2
    _equal_trees(steps[0], steps[1], "the ranks' C steps")
    _equal_trees((runs[0]["state"], runs[0]["lc_state"]),
                 (runs[1]["state"], runs[1]["lc_state"]), "the ranks")
    lc = LCAlgorithm(w.ssm_tasks(), exponential_mu_schedule(1e-3, 1.5, 2),
                     device="cpu")
    lc.init(steps[0][0][1])
    for k, (step, params, state, out) in enumerate(steps[0]):
        got = getattr(lc, step)(params, w._clone(state))
        _equal_trees(got["tasks"], out["tasks"], f"step {k} {step}")
    one = ranks["one"][name][0].history
    for run in runs:
        assert len(run["history"]) == len(one) == 2
        for rec, want in zip(run["history"], one):
            assert rec["c_step_violations"] == []
            np.testing.assert_allclose(rec["loss"], want["loss"], rtol=1e-5)


class _StandIn:
    """A mesh's layout and this rank's coordinates, without ranks."""

    def __init__(self, sizes, ranks_):
        self.mesh_dim_names, self.shape = tuple(sizes), tuple(sizes.values())
        self._ranks = ranks_

    def get_local_rank(self, axis):
        return self._ranks.get(axis, 0)


@pytest.mark.parametrize("name", TRAIN)
def test_checkpoints_restore_across_model_sizes(ranks, name):
    """Written by one process, a checkpoint restores under (1, 2) and
    (1, 4) to each rank's slices of the whole state; written under
    (1, 2), it restores without a mesh to the ranks' gathered state."""
    cfg, tmp = ranks["cfgs"][name], ranks["tmp"]
    one = ranks["one"][name][2]
    for m in (2, 4):
        for r, rank in enumerate(_at(ranks, (1, m))):
            want = sh.shard_train_state(one, cfg, _StandIn(
                {"data": 1, "model": m}, {"model": r}), sh.DEFAULT_RULES)
            _equal_trees(rank[((1, m), "restored", name)], want,
                         f"no mesh → (1, {m}) rank {r}")
    whole = _at(ranks, (1, 2))[0][("trainer", name)]["state"]
    restored, step = CheckpointManager(
        str(tmp / "world2" / f"ckpt_{name}")).restore(whole)
    assert step == int(whole["step"])
    _equal_trees(restored, whole, "(1, 2) → no mesh")


@pytest.mark.parametrize("m", [2, 4])
@pytest.mark.parametrize("form", w.SSM_FORMS)
@pytest.mark.parametrize("name", ["jamba", "xlstm"])
def test_shard_then_gather_is_the_identity_in_every_form(ranks, name, form,
                                                         m):
    """Every SSM leaf, in every weight form (the fused leaves in
    segments), split by ``shard_params`` over (1, m) and gathered by
    ``gather_params`` on every rank, equals the whole tree bit for
    bit."""
    cfg = _cfg(tconfigs, name)
    whole = w.ssm_forms_tree(cfg, form)
    segmented = 0
    for r, rank in enumerate(_at(ranks, (1, m))):
        got = rank[((1, m), "forms", name, form)]
        wl, gl = tree_leaves(whole), tree_leaves(got)
        assert len(wl) == len(gl)
        for a, b in zip(gl, wl):
            assert type(a) is type(b), f"rank {r}"
            if isinstance(b, torch.Tensor):
                assert torch.equal(a, b), f"rank {r}"
                continue
            assert tuple(a.shape) == tuple(b.shape), f"rank {r}"
            for field, val in vars(b).items():
                v = getattr(a, field)
                if isinstance(val, torch.Tensor):
                    assert v.dtype == val.dtype and torch.equal(v, val), \
                        f"rank {r} {type(b).__name__}.{field}"
                else:
                    assert v == val, f"rank {r} {field}"
    # the tree holds segmented leaves in the form
    mesh = _StandIn({"data": 1, "model": m}, {"model": 0})
    cuts = sh._Cuts(cfg, mesh, None)
    for (s, p), kind in ttf.mixer_kinds(cfg).items():
        for leaf in whole["stages"][s][p]["mixer"]:
            cut = cuts(("stages", s, p, "mixer", leaf), 0)
            segmented += cut is not None and len(cut[1]) > 1
    assert segmented > 0
