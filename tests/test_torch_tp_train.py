"""Training over the port's tensor-parallel "model" axis on ``gloo`` ranks,
against the JAX package, on the CPU.

At world size 2 (mesh (1, 2)) and 4 (meshes (1, 4) and (2, 2)), every
rank (``torch.multiprocessing`` ranks, a ``FileStore`` under
``tmp_path``; ``tests/torch_dist_workers.py``) takes its slices of the
whole train state (``sharding.shard_train_state``). The cases are reduced
float32 configs with 4 heads, so that the heads split at m = 2 and 4:

* one train step (loss + LC penalty, clip, AdamW) of phi3-mini, of
  phi3-mini with 2 kv heads (at m = 4 a kv head on two ranks) and with 2
  heads (at m = 4 attention runs whole on every model rank), of minicpm3
  (MLA, a tied vocabulary), of deepseek-moe ("ep") and of a 6-expert
  mixtral ("tp" at m = 4, "ep" at m = 2), at the reference's capacity
  factor, from the reference's state. Against the reference's
  ``make_train_step`` at ``mesh=None``: ``loss``, ``ce``, ``lc_penalty``
  and ``grad_norm`` within rtol 1e-5; every leaf's gradient before
  clipping, gathered, within rtol 1e-5 / atol 1e-5·max|g| of the leaf;
  the new parameters within ``2·lr`` (``tests/test_torch_dp_train.py``'s
  tolerance, for its reason: AdamW's first step moves a weight by
  ``lr·g/(|g| + eps)``, and a gradient within rounding of 0 can take the
  other sign). The MoE cases run on (1, m) meshes only: over a data axis
  above 1 each rank routes its rows at the per-shard capacity (the
  reference's ``shard_map``), which drops other tokens than one process;
* the vocabulary-parallel loss alone: ``chunked_nll`` in chunks of 8 at
  m = 2 and 4 (and minicpm3's tied vocabulary at m = 2) against the
  reference's ``chunked_ce_loss``: the value and its gradients with
  respect to the hidden state and to the unembedding within rtol 1e-5
  (atol 1e-5·max|g|), and no op on a rank makes a tensor of the whole
  vocabulary's width;
* ``LCTrainer(mesh=(1, 2))``, 2 LC steps of 2 L steps: quantization
  serial and overlapped, ℓ0 serial. Each C step and multiplier step, on
  the gathered weights, equals ``LCAlgorithm(mesh=None)``'s on the same
  weights and state bit for bit; every model rank ends with the same
  state; the losses are within rtol 1e-5 of the port's one-process run,
  the §7 monitor holds, and the overlapped run's first C step equals the
  serial run's; a checkpoint written under (1, 2) restores without a
  mesh to the same tree, and one written without a mesh restores under
  (1, 2) to each rank's slices.

The reference runs in this process only, on its single CPU device; its
GSPMD result does not depend on the mesh.
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
from repro.launch import steps as jsteps
from repro.models import transformer as jtf
from repro_torch import configs as tconfigs
from repro_torch import interop
from repro_torch.checkpoint import CheckpointManager
from repro_torch.core import LCAlgorithm, exponential_mu_schedule
from repro_torch.distributed import sharding as sh
from repro_torch.launch.train import default_tasks
from repro_torch.models import layers
from repro_torch.runtime import compressed as forms
from repro_torch.tree import tree_leaves
from torch_threads import _one_torch_thread  # noqa: F401

MESHES = {2: [(1, 2)], 4: [(1, 4), (2, 2)]}
DENSE = [(1, 2), (1, 4), (2, 2)]
#: case → (arch, config overrides, meshes)
CASES = {
    "dense": ("phi3-mini-3.8b", {}, DENSE),
    "kv2": ("phi3-mini-3.8b", {"n_kv_heads": 2}, DENSE),
    "heads2": ("phi3-mini-3.8b", {"n_heads": 2, "n_kv_heads": 2},
               [(1, 2), (1, 4)]),
    "mla": ("minicpm3-4b", {}, [(1, 2), (1, 4)]),
    "ep": ("deepseek-moe-16b", {}, [(1, 2), (1, 4)]),
    "tp": ("mixtral-8x7b", {"moe": {"n_experts": 6}}, [(1, 2), (1, 4)]),
}
STEPS = [(n, s) for n, c in CASES.items() for s in c[2]]
#: vocabulary-parallel loss: case → (arch, m)
NLL = {"untied-m2": ("phi3-mini-3.8b", 2), "untied-m4": ("phi3-mini-3.8b", 4),
       "tied-m2": ("minicpm3-4b", 2)}
CHUNK = 8
TRAINER_RUNS = [("quantize", "off"), ("quantize", "on"), ("prune", "off")]


def _cfg(mod, arch, over):
    c = mod.reduced_config(mod.get_config(arch))
    over = dict(over)
    moe = over.pop("moe", None)
    kw = {"dtype": "float32", "n_heads": 4, "n_kv_heads": 4}
    kw.update(over)
    c = dataclasses.replace(c, **kw)
    if moe is not None:
        c = c.with_(moe=dataclasses.replace(c.moe, **moe))
    return c


def _unrolled(cfg):
    return cfg.with_(pattern=cfg.pattern * 2, pattern_reps=1)


#: world size → the config of the weight-form gather (at m = 4 a kv head
#: on two ranks)
FORMS_CFG = {2: _unrolled(_cfg(tconfigs, "phi3-mini-3.8b", {})),
             4: _unrolled(_cfg(tconfigs, "phi3-mini-3.8b",
                               {"n_kv_heads": 2}))}


def _np(tree):
    return jax.tree_util.tree_map(lambda x: np.array(x, copy=True), tree)


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
    """The reference's metrics, gradients before clipping and new
    parameters."""
    js = jax.tree_util.tree_map(jnp.asarray, st)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}

    def lossf(p):
        loss, _ = jtf.loss_fn(p, jb, jcfg)
        lc = js["lc"]
        return loss + jsteps.lc_penalty_from_refs(p, lc["a"], lc["lam"],
                                                  lc["mu"])

    grads = jax.jit(jax.grad(lossf))(js["params"])
    new, metrics = jax.jit(jsteps.make_train_step(jcfg, lr=w.TPT_LR))(js,
                                                                      jb)
    return {"metrics": {k: float(v) for k, v in metrics.items()},
            "grads": _np(grads), "params": _np(new["params"])}


def _reference_nll(arch):
    """The reference's chunked CE of random hidden states through the
    (un)embedding: inputs, value, and gradients with respect to the
    hidden state and the table."""
    jcfg = _cfg(jconfigs, arch, {})
    params = _np(jtf.init_params(jax.random.PRNGKey(0), jcfg))
    name = "tokens" if jcfg.tie_embeddings else "unembed"
    embed = {name: params["embed"][name]}
    rng = np.random.default_rng(4)
    hidden = rng.standard_normal((2, w.TPT_SEQ, jcfg.d_model)
                                 ).astype(np.float32)
    labels = rng.integers(0, jcfg.vocab_size, (2, w.TPT_SEQ)
                          ).astype(np.int32)

    def f(h, e):
        return jtf.chunked_ce_loss({"embed": e}, h, jnp.asarray(labels),
                                   jcfg, chunk=CHUNK)

    val, (dh, de) = jax.value_and_grad(f, argnums=(0, 1))(
        jnp.asarray(hidden), jax.tree_util.tree_map(jnp.asarray, embed))
    return {"inputs": {"embed": embed, "hidden": hidden, "labels": labels},
            "loss": float(val), "d_hidden": np.asarray(dh),
            "d_embed": _np(de)}


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """The ranks' results at world sizes 2 and 4 (spawned together, on
    threads of their own, while this process runs the reference and the
    port's one-process trainer runs) and the references."""
    tmp = tmp_path_factory.mktemp("tp_train")
    cases, refs = {}, {}
    for name, (arch, over, meshes) in CASES.items():
        jcfg, tcfg = _cfg(jconfigs, arch, over), _cfg(tconfigs, arch, over)
        st = _reference_state(jcfg)
        cases[name] = {"cfg": tcfg, "state": st, "batch": _batch(tcfg),
                       "meshes": meshes}
        refs[name] = (jcfg, st)
    nll = {n: _reference_nll(arch) for n, (arch, _) in NLL.items()}
    tcfg = _cfg(tconfigs, "phi3-mini-3.8b", {})
    one_ckpt = str(tmp / "ckpt_one")
    torch.save({"cases": cases, "meshes": MESHES, "chunk": CHUNK,
                "nll": {n: dict(cfg=_cfg(tconfigs, NLL[n][0], {}),
                                **r["inputs"]) for n, r in nll.items()},
                "trainer_cfg": tcfg, "one_process_ckpt": one_ckpt,
                "forms_cfg": FORMS_CFG},
               tmp / "inputs.pt")
    one = {run: w.tpt_trainer(tcfg, None, *run,
                              one_ckpt if run == ("quantize", "off")
                              else None)
           for run in TRAINER_RUNS}

    def spawn(world):
        (tmp / f"world{world}").mkdir()
        w.spawn(w.tp_train, world, tmp, str(tmp / "inputs.pt"),
                str(tmp / f"world{world}"))

    with concurrent.futures.ThreadPoolExecutor(len(MESHES)) as pool:
        ranks = [pool.submit(spawn, world) for world in MESHES]
        steps = {n: _reference_step(refs[n][0], refs[n][1],
                                    cases[n]["batch"]) for n in CASES}
        for r in ranks:
            r.result()
    got = {world: [torch.load(tmp / f"world{world}" / f"rank{r}.pt",
                              weights_only=False) for r in range(world)]
           for world in MESHES}
    return {"ranks": got, "steps": steps, "nll": nll, "one": one,
            "cfg": tcfg, "tmp": tmp}


def _ranks(trained, shape):
    return trained["ranks"][shape[0] * shape[1]]


def _close_grads(got, want, what):
    """Gathered gradients within rtol 1e-5 / atol 1e-5·max|g| a leaf."""
    got, want = interop.to_numpy(got), want
    gl = jax.tree_util.tree_leaves_with_path(got)
    wl = dict((jax.tree_util.keystr(p), x) for p, x in
              jax.tree_util.tree_leaves_with_path(want))
    assert len(gl) == len(wl), what
    for p, x in gl:
        y = wl[jax.tree_util.keystr(p)]
        np.testing.assert_allclose(
            x, y, rtol=1e-5, atol=1e-5 * float(np.abs(y).max()),
            err_msg=f"{what} {jax.tree_util.keystr(p)}")


@pytest.mark.parametrize("name,shape", STEPS,
                         ids=[f"{n}-{s[0]}x{s[1]}" for n, s in STEPS])
def test_train_step_over_the_model_axis_equals_the_reference(trained, name,
                                                             shape):
    ref = trained["steps"][name]
    first = None
    for r, rank in enumerate(_ranks(trained, shape)):
        got = rank[(shape, name)]
        for k in ("loss", "ce", "lc_penalty", "grad_norm"):
            np.testing.assert_allclose(got["metrics"][k], ref["metrics"][k],
                                       rtol=1e-5, err_msg=f"rank {r} {k}")
        _close_grads(got["grads"], ref["grads"], f"rank {r}")
        params = interop.to_numpy(got["params"])
        for x, y in zip(jax.tree_util.tree_leaves(params),
                        jax.tree_util.tree_leaves(ref["params"])):
            assert float(np.abs(x - y).max()) <= 2 * w.TPT_LR * (1 + 1e-4)
        # every rank applies the same update to the whole model
        if first is None:
            first = got["params"]
        for x, y in zip(tree_leaves(got["params"]), tree_leaves(first)):
            assert torch.equal(x, y), f"rank {r}"


def test_the_hard_layouts_split_as_named(trained):
    """The cases exercise what they are named for: at m = 4 the 2-kv-head
    phi3-mini holds each kv head on two ranks and the 2-head one keeps
    attention whole; mixtral's 6 experts split "tp" at m = 4 and "ep" at
    m = 2."""
    def blk(tree, kind):
        return tree["stages"]["s0"]["pos0"][kind]

    kv2 = _ranks(trained, (1, 4))
    wk = [blk(r[((1, 4), "kv2")]["local"], "mixer")["wk"] for r in kv2]
    assert torch.equal(wk[0], wk[1]) and not torch.equal(wk[1], wk[2])
    heads2 = blk(kv2[0][((1, 4), "heads2")]["local"], "mixer")["wq"]
    assert heads2.shape[-1] == 2 * 16
    e4 = blk(kv2[0][((1, 4), "tp")]["local"], "ffn")["w_gate"]
    e2 = blk(_ranks(trained, (1, 2))[0][((1, 2), "tp")]["local"],
             "ffn")["w_gate"]
    assert e4.shape[-3:] == (6, 64, 8) and e2.shape[-3:] == (3, 64, 32)


@pytest.mark.parametrize("name", list(NLL))
def test_vocab_parallel_loss_equals_the_reference(trained, name):
    ref = trained["nll"][name]
    cfg = _cfg(tconfigs, NLL[name][0], {})
    m = NLL[name][1]
    for r, rank in enumerate(_ranks(trained, (1, m))):
        got = rank[((1, m), "nll", name)]
        np.testing.assert_allclose(got["loss"], ref["loss"], rtol=1e-5)
        np.testing.assert_allclose(
            got["d_hidden"].numpy(), ref["d_hidden"], rtol=1e-5,
            atol=1e-5 * np.abs(ref["d_hidden"]).max())
        _close_grads(got["d_embed"]["embed"], ref["d_embed"], f"rank {r}")
        # no op on a rank makes a tensor of the whole vocabulary's width
        assert got["widest"] <= cfg.vocab_size // m, got["widest"]


def _equal_trees(a, b, what):
    la, lb = tree_leaves(a), tree_leaves(b)
    assert len(la) == len(lb), what
    for x, y in zip(la, lb):
        if isinstance(x, torch.Tensor):
            assert x.dtype == y.dtype and torch.equal(x, y), what
        else:
            assert x == y, what


@pytest.mark.parametrize("run", TRAINER_RUNS,
                         ids=[f"{c}-overlap-{o}" for c, o in TRAINER_RUNS])
def test_trainer_c_steps_equal_one_process_on_gathered_weights(trained, run):
    """Every C step and multiplier step that a rank ran, replayed by
    ``LCAlgorithm(mesh=None)`` on the same gathered weights and LC state,
    gives the same Θ, Δ(Θ) and λ bit for bit; both ranks ran the same
    steps on the same weights."""
    cfg = trained["cfg"]
    ranks = _ranks(trained, (1, 2))
    steps = [r[("trainer", *run)]["steps"] for r in ranks]
    assert [s[0] for s in steps[0]] == ["c_step", "multiplier_step"] * 2
    _equal_trees(steps[0], steps[1], "the ranks' C steps")
    lc = LCAlgorithm(default_tasks(cfg, run[0]),
                     exponential_mu_schedule(1e-3, 1.5, 2), device="cpu")
    lc.init(steps[0][0][1])
    for k, (name, params, state, out) in enumerate(steps[0]):
        got = getattr(lc, name)(params, w._clone(state))
        _equal_trees(got["tasks"], out["tasks"], f"{run} step {k} {name}")


@pytest.mark.parametrize("run", TRAINER_RUNS,
                         ids=[f"{c}-overlap-{o}" for c, o in TRAINER_RUNS])
def test_trainer_over_the_model_axis_follows_one_process(trained, run):
    """Both ranks end with the same whole state and LC state; their losses
    are within rtol 1e-5 of the one-process run's and the §7 monitor
    holds; ``compressed_params`` is the whole tree with Δ(Θ) in."""
    ranks = [r[("trainer", *run)] for r in _ranks(trained, (1, 2))]
    _equal_trees((ranks[0]["state"], ranks[0]["lc_state"]),
                 (ranks[1]["state"], ranks[1]["lc_state"]), "the ranks")
    one = trained["one"][run][0].history
    for got in ranks:
        assert len(got["history"]) == len(one) == 2
        for rec, want in zip(got["history"], one):
            assert rec["c_step_violations"] == []
            np.testing.assert_allclose(rec["loss"], want["loss"], rtol=1e-5)
            assert rec["compression_ratio"] == want["compression_ratio"]
        for ts in got["lc_state"]["tasks"].values():
            for p, a in ts["a"].items():
                node = got["compressed"]
                for k in p.split("/"):
                    node = node[k]
                assert torch.equal(node, a)


def test_the_overlapped_run_starts_as_the_serial_one(trained):
    """The first LC boundary follows the same first L step in both modes:
    the overlapped run's first C step equals the serial run's."""
    rank = _ranks(trained, (1, 2))[0]
    serial = rank[("trainer", "quantize", "off")]["steps"][0]
    overlapped = rank[("trainer", "quantize", "on")]["steps"][0]
    _equal_trees(serial[1:], overlapped[1:], "first C step")


class _StandIn:
    """A mesh's layout and this rank's coordinates, without ranks."""

    def __init__(self, sizes, ranks):
        self.mesh_dim_names, self.shape = tuple(sizes), tuple(sizes.values())
        self._ranks = ranks

    def get_local_rank(self, axis):
        return self._ranks.get(axis, 0)


def test_checkpoints_restore_across_model_sizes(trained):
    """Written under (1, 2), a checkpoint restores without a mesh to the
    ranks' gathered state; written without a mesh, it restores under
    (1, 2) to each rank's slices of the one-process state."""
    cfg, tmp = trained["cfg"], trained["tmp"]
    ranks = _ranks(trained, (1, 2))
    whole = ranks[0][("trainer", "quantize", "off")]["state"]
    restored, step = CheckpointManager(
        str(tmp / "world2" / "ckpt_mesh")).restore(whole)
    assert step == int(whole["step"])
    _equal_trees(restored, whole, "(1, 2) → no mesh")
    one = trained["one"][("quantize", "off")][2]
    for r, rank in enumerate(ranks):
        want = sh.shard_train_state(one, cfg, _StandIn(
            {"data": 1, "model": 2}, {"model": r}), sh.DEFAULT_RULES)
        _equal_trees(rank["restored"], want, f"no mesh → (1, 2) rank {r}")


# ----------------------------------------------------------------------
# the layout without ranks
# ----------------------------------------------------------------------
FORMS = [("quant4", 12, 10, 2), ("quant4", 9, 6, 3), ("quant4", 10, 6, 2),
         ("quant8", 12, 12, 4), ("lowrank", 12, 10, 2), ("sparse", 12, 12, 4),
         ("dense", 12, 10, 2)]


def _form(kind, k, n):
    g = torch.Generator().manual_seed(0)
    if kind == "dense":
        return torch.randn(k, n, generator=g)
    if kind.startswith("quant"):
        from repro_torch.kernels.quant_matmul import ops as qops
        bits = int(kind[5:])
        codes = 16 if bits == 4 else 64
        idx = torch.randint(0, codes, (k, n), generator=g, dtype=torch.uint8)
        return forms.QuantizedWeight(
            qops.pack4(idx) if bits == 4 else idx,
            torch.sort(torch.randn(codes, generator=g)).values, (k, n), bits)
    if kind == "lowrank":
        return forms.LowRankWeight(torch.randn(k, 3, generator=g),
                                   torch.randn(3, n, generator=g))
    dense = torch.randn(k, n, generator=g)
    dense[torch.rand(k, n, generator=g) < 0.7] = 0.0
    dense[[0, 3]] = 0.0
    rows, cols = torch.nonzero(dense, as_tuple=True)
    return forms.SparseWeight(dense[rows, cols], rows.to(torch.int32),
                              cols.to(torch.int32), (k, n))


@pytest.mark.parametrize("dim", [0, 1], ids=["rows", "cols"])
@pytest.mark.parametrize("kind,k,n,m", FORMS,
                         ids=[f"{f[0]}-{f[1]}x{f[2]}-m{f[3]}" for f in FORMS])
def test_join_weight_inverts_slice_weight(kind, k, n, m, dim):
    """Every form's blocks (a 4-bit weight cut at odd rows, a sparse one
    with empty rows) put back together in their own layout, bit for
    bit."""
    whole = _form(kind, k, n)
    per = (k if dim == 0 else n) // m
    back = layers.join_weight([layers.slice_weight(whole, dim, r * per,
                                                   (r + 1) * per)
                               for r in range(m)], dim)
    assert type(back) is type(whole)
    if isinstance(whole, torch.Tensor):
        assert torch.equal(back, whole)
        return
    assert tuple(back.shape) == tuple(whole.shape)
    for name, val in vars(whole).items():
        got = getattr(back, name)
        if isinstance(val, torch.Tensor):
            assert got.dtype == val.dtype and torch.equal(got, val), name
        else:
            assert got == val, name


@pytest.mark.parametrize("world", list(MESHES))
def test_gather_params_puts_each_form_back_whole(trained, world):
    """A tree of weight forms split by ``shard_params`` over (1, m) and
    gathered by ``gather_params`` on every rank equals the whole tree,
    form by form, bit for bit (a kv head on two ranks taken once)."""
    whole = w.forms_tree(FORMS_CFG[world])
    for r, rank in enumerate(trained["ranks"][world]):
        got = rank[((1, world), "forms")]
        wl, gl = tree_leaves(whole), tree_leaves(got)
        assert len(wl) == len(gl)
        for a, b in zip(gl, wl):
            assert type(a) is type(b), f"rank {r}"
            if isinstance(b, torch.Tensor):
                assert torch.equal(a, b), f"rank {r}"
                continue
            assert tuple(a.shape) == tuple(b.shape), f"rank {r}"
            for name, val in vars(b).items():
                got_val = getattr(a, name)
                if isinstance(val, torch.Tensor):
                    assert got_val.dtype == val.dtype and torch.equal(
                        got_val, val), f"rank {r} {type(b).__name__}.{name}"
                else:
                    assert got_val == val, f"rank {r} {name}"


@pytest.mark.parametrize("arch,over,m", [
    ("phi3-mini-3.8b", {"n_kv_heads": 2}, 4),
    ("phi3-mini-3.8b", {"n_heads": 2, "n_kv_heads": 2}, 4),
    ("deepseek-moe-16b", {}, 2), ("minicpm3-4b", {}, 2),
    ("jamba-v0.1-52b", {}, 4), ("xlstm-125m", {}, 2),
    ("xlstm-125m", {"n_heads": 2, "n_kv_heads": 2}, 4)])
def test_param_layout_counts_every_weight_once(arch, over, m):
    """Over the model ranks, each leaf's elements counted as
    ``param_layout`` says (a split leaf on every rank, a leaf held by k
    ranks 1/k on each, a whole leaf on one rank) come to the whole
    tree's; the training rules give the serving rules' layout."""
    from repro_torch.core import flatten_params
    from repro_torch.models.transformer import init_params
    cfg = _cfg(tconfigs, arch, over)
    params = init_params(torch.Generator().manual_seed(0), cfg)
    total = 0.0
    for r in range(m):
        mesh = _StandIn({"data": 1, "model": m}, {"model": r})
        lay = sh.param_layout(cfg, mesh, sh.DEFAULT_RULES)
        assert lay == sh.param_layout(cfg, mesh, sh.SERVE_RULES)
        local = flatten_params(sh.shard_params(params, cfg, mesh,
                                               sh.DEFAULT_RULES))
        for p, f in flatten_params(lay).items():
            n = local[p].numel()
            total += (n if r == 0 else 0) if f == "whole" else \
                n if f == "split" else n / f
    assert total == sum(x.numel() for x in tree_leaves(params))


def test_recomputation_sees_the_forward_mesh_on_another_thread(monkeypatch):
    """Autograd recomputes a CUDA tensor's checkpoints on a thread of its
    own: the blocks' and the loss chunks' recomputation sees the mesh and
    the batch split of the forward (``sharding.recompute_context``) also
    where the backward runs on another thread than the forward."""
    import threading

    from repro_torch.models import transformer as ttf
    cfg = _cfg(tconfigs, "phi3-mini-3.8b", {}).with_(remat=True)
    params = ttf.init_params(torch.Generator().manual_seed(0), cfg)
    for x in tree_leaves(params):
        x.requires_grad_(True)
    seen = []
    for name in ("_apply_blocks", "_chunk_nll"):
        fn = getattr(ttf, name)

        def spy(*a, _fn=fn, _name=name, **kw):
            seen.append((_name, threading.get_ident(), sh.active_mesh(),
                         sh.batch_entry()))
            return _fn(*a, **kw)
        monkeypatch.setattr(ttf, name, spy)
    mesh = _StandIn({"data": 1, "model": 1}, {})
    batch = {k: torch.from_numpy(v) for k, v in _batch(cfg).items()}
    with sh.use_mesh(mesh), sh.local_batch("data"):
        loss, _ = ttf.loss_fn(params, batch, cfg)
    forward = len(seen)
    grads = []
    t = threading.Thread(target=lambda: grads.append(torch.autograd.grad(
        loss, tree_leaves(params))))
    t.start()
    t.join(timeout=120)
    assert not t.is_alive() and grads and forward > 0
    assert len(seen) > forward
    assert {n for n, *_ in seen[forward:]} == {"_apply_blocks", "_chunk_nll"}
    for name, thread, m, entry in seen:
        assert m is mesh and entry == "data", (name, thread)
    assert seen[-1][1] != seen[0][1]
