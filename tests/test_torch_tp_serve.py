"""Serving over the port's tensor-parallel "model" axis on ``gloo`` ranks,
against the JAX package, on the CPU.

At world size 2 (mesh (1, 2)) and 4 (meshes (1, 4) and (2, 2)), every
rank (``torch.multiprocessing`` ranks, a ``FileStore`` under
``tmp_path``; ``tests/torch_dist_workers.py``) serves each case with
``Server(mesh=)`` and ``ServingEngine(mesh=)`` from the whole tree, which
each keeps its slices of. The cases are reduced float32 configs with 4
heads, so that the heads split at m = 2 and 4:

* phi3-mini dense, and bridged to each weight form through the
  reference's LC state, as ``tests/test_torch_serving.py`` does: 4-bit
  FFN and 8-bit attention; sparse COO FFN (ℓ0) and rank-4 low-rank
  attention (every form split by rows and by columns);
* phi3-mini with 2 kv heads (m = 4 > KV: a kv head held by two ranks),
  and with 2 heads (at m = 4 the heads do not divide: attention runs
  whole on every model rank);
* minicpm3 (MLA, a tied vocabulary); deepseek-moe (4 experts, "ep" at
  m = 2 and 4); a 6-expert mixtral ("tp" at m = 4, "ep" at m = 2).

Checks, against the reference at ``mesh=None`` (its GSPMD result does not
depend on the mesh), in this process only, on its single CPU device:

* ``Server.generate``'s greedy tokens equal on every rank, its prefill
  logits within rtol 1e-5 / atol 1e-5·max|logit| (the row-parallel sums
  change the summation order);
* the engine's tokens for every request of a 6-request trace equal;
* each rank's partial routed-expert output before the sum over "model"
  equals the reference's ``_moe_local`` on that rank's experts ("ep") or
  expert columns ("tp") within ``tests/test_torch_moe.py``'s MM;
* ``LCAlgorithm(mesh=)`` over (2, 2) gives every rank Θ, Δ(Θ) and λ bit
  for bit equal to the one-process ``mesh=None`` run at every C step.
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
from repro.core import AsIs as JAsIs, AsVector as JAsVector
from repro.core import CompressionTask as JTask, LCAlgorithm as JLC
from repro.core import schemes as js
from repro.models import moe as jmoe
from repro.models import transformer as jtf
from repro.runtime import server as jserver
from repro_torch import configs as tconfigs
from repro_torch import interop
from repro_torch.models import transformer as ttf
from repro_torch.tree import tree_leaves
from torch_threads import _one_torch_thread  # noqa: F401

MESHES = {2: [(1, 2)], 4: [(1, 4), (2, 2)]}
ALL_MESHES = [s for shapes in MESHES.values() for s in shapes]
MM = dict(rtol=1e-5, atol=2e-5)

#: case → (arch, config overrides, weight-form tasks or None)
FFN, ATTN = r"ffn/(w_gate|w_up|w_down)$", r"mixer/(wq|wk|wv|wo)$"
CASES = {
    "dense": ("phi3-mini-3.8b", {}, None),
    "quant": ("phi3-mini-3.8b", {}, [("q4", FFN, "vector", ("quant", 16)),
                                     ("q8", ATTN, "vector", ("quant", 64))]),
    "sparse_lowrank": ("phi3-mini-3.8b", {}, [
        ("p", FFN, "vector", ("prune", 3000)),
        ("l", ATTN, "matrix", ("lowrank", 4))]),
    "kv2": ("phi3-mini-3.8b", {"n_kv_heads": 2}, None),
    "heads2": ("phi3-mini-3.8b", {"n_heads": 2, "n_kv_heads": 2}, None),
    "mla": ("minicpm3-4b", {}, None),
    "ep": ("deepseek-moe-16b", {}, None),
    "tp": ("mixtral-8x7b", {"moe": {"n_experts": 6}}, None),
}


def _cfg(mod, arch, over):
    c = mod.reduced_config(mod.get_config(arch))
    over = dict(over)
    moe = over.pop("moe", None)
    kw = {"dtype": "float32", "n_heads": 4, "n_kv_heads": 4}
    kw.update(over)
    c = dataclasses.replace(c, **kw)
    if moe is not None:
        c = c.with_(moe=dataclasses.replace(c.moe, **moe))
    # unrolled layers: the weight forms and the experts' slices are per
    # layer
    return c.with_(pattern=c.pattern * 2, pattern_reps=1)


def _jax_task(name, pattern, view, scheme):
    kind, arg = scheme
    view = JAsVector() if view == "vector" else JAsIs()
    scheme = {"quant": lambda: js.AdaptiveQuantization(k=arg),
              "prune": lambda: js.ConstraintL0Pruning(kappa=arg),
              "lowrank": lambda: js.LowRank(arg)}[kind]()
    return JTask(name, pattern, view, scheme)


def _reference_tree(name):
    """The reference's config and serving tree of one case: random
    params (the port's init, as numpy), bridged to weight forms through
    the reference's LC state."""
    arch, over, tasks = CASES[name]
    jcfg = _cfg(jconfigs, arch, over)
    jp = jax.tree_util.tree_map(jnp.asarray, interop.to_numpy(
        ttf.init_params(torch.Generator().manual_seed(0),
                        _cfg(tconfigs, arch, over))))
    if tasks is not None:
        algo = JLC([_jax_task(*t) for t in tasks], [1e-4])
        jp, _ = jserver.load_compressed_for_serving(jp, algo.init(jp),
                                                    algo.tasks)
    return jcfg, jp


def _reference_results(jcfg, jp):
    """The reference's greedy tokens, prefill logits and engine tokens."""
    prompts = jnp.asarray(_prompts())
    logits = jax.jit(lambda p, x: jtf.prefill(p, x, jcfg))(jp, prompts)
    toks = jserver.Server(jcfg, jp, max_len=w.TP_MAX_LEN).generate(
        prompts, w.TP_NEW).tokens
    out = jserver.ServingEngine(jcfg, jp, **w.TP_ENGINE).run(
        [jserver.Request(*r) for r in _trace()])
    return {"tokens": np.asarray(toks), "logits": np.asarray(logits[:, 0]),
            "engine": {f.id: np.asarray(f.tokens) for f in out["finished"]}}


def _prompts():
    return np.random.default_rng(0).integers(1, 256, (2, 8)).astype(np.int32)


def _trace():
    rng = np.random.default_rng(1)
    return [(i, rng.integers(1, 256, size=int(rng.integers(2, 7)))
             .astype(np.int32), int(rng.integers(2, 5)), 0.001 * i)
            for i in range(6)]


def _moe_x(d_model):
    rng = np.random.default_rng(2)
    return (rng.standard_normal((24, d_model))
            + 2.0 * rng.standard_normal(d_model)).astype(np.float32)


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """The ranks' results at world sizes 2 and 4 (spawned together, on
    threads of their own, while this process runs the reference) and the
    reference's results of every case."""
    tmp = tmp_path_factory.mktemp("tp_serve")
    refs = {}
    for name in CASES:
        jcfg, jp = _reference_tree(name)
        refs[name] = {"jcfg": jcfg, "jp": jp}
    torch.save({"cases": {n: {"cfg": _cfg(tconfigs, *CASES[n][:2]),
                              "params": interop.serving_params_from_numpy(
                                  jax.tree_util.tree_map(
                                      np.asarray, refs[n]["jp"]), "cpu")}
                          for n in CASES},
                "prompts": _prompts(), "trace": _trace(),
                "moe_x": _moe_x(64), "meshes": MESHES},
               tmp / "inputs.pt")

    def spawn(world):
        (tmp / f"world{world}").mkdir()
        w.spawn(w.tp_serve, world, tmp, str(tmp / "inputs.pt"),
                str(tmp / f"world{world}"))

    with concurrent.futures.ThreadPoolExecutor(len(MESHES) + 4) as pool:
        ranks = [pool.submit(spawn, world) for world in MESHES]
        done = {n: pool.submit(_reference_results, r["jcfg"], r["jp"])
                for n, r in refs.items()}
        for n, ref in refs.items():
            ref.update(done[n].result())
        for r in ranks:
            r.result()
    got = {world: [torch.load(tmp / f"world{world}" / f"rank{r}.pt",
                              weights_only=False) for r in range(world)]
           for world in MESHES}
    return {"ranks": got, "refs": refs}


def _results(served, shape):
    world = shape[0] * shape[1]
    return served["ranks"][world]


@pytest.mark.parametrize("shape", ALL_MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("name", list(CASES))
def test_server_over_the_model_axis_equals_the_reference(served, shape,
                                                         name):
    ref = served["refs"][name]
    for r, got in enumerate(_results(served, shape)):
        g = got[(shape, name)]
        np.testing.assert_array_equal(g["tokens"], ref["tokens"],
                                      err_msg=f"rank {r}")
        np.testing.assert_allclose(
            g["logits"], ref["logits"], rtol=1e-5,
            atol=1e-5 * np.abs(ref["logits"]).max(), err_msg=f"rank {r}")


@pytest.mark.parametrize("shape", ALL_MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("name", list(CASES))
def test_engine_over_the_model_axis_equals_the_reference(served, shape,
                                                         name):
    want = served["refs"][name]["engine"]
    assert sorted(want) == list(range(len(_trace())))
    for r, got in enumerate(_results(served, shape)):
        eng = got[(shape, name)]["engine"]
        assert sorted(eng) == sorted(want), f"rank {r}"
        for i in want:
            np.testing.assert_array_equal(eng[i], want[i],
                                          err_msg=f"rank {r} request {i}")


@pytest.mark.parametrize("shape", ALL_MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("name", ["ep", "tp"])
def test_moe_partials_equal_the_reference_local_dispatch(served, shape,
                                                         name):
    """Each rank's routed-expert output before the sum over "model"
    equals the reference's ``_moe_local`` on the same experts ("ep":
    ``e0 = r·E/m``, ``e_local = E/m``) or expert columns ("tp")."""
    ref = served["refs"][name]
    jcfg, m = ref["jcfg"], shape[1]
    e, f = jcfg.moe.n_experts, jcfg.moe.d_expert
    strategy = "ep" if e % m == 0 else "tp"
    assert strategy == ("tp" if (name, m) == ("tp", 4) else "ep")
    blk = next(b["ffn"] for st in ref["jp"]["stages"].values()
               for b in st.values() if "router" in b.get("ffn", {}))
    x = _moe_x(jcfg.d_model)
    cap = int(np.ceil(x.shape[0] * jcfg.moe.top_k / e
                      * jcfg.moe.capacity_factor))
    def local(wg, wu, wd, e0, el):
        return jax.jit(lambda *a: jmoe._moe_local(
            *a, jcfg, e0=e0, e_local=el, capacity=cap, model_axis=None)[0])(
                jnp.asarray(x), blk["router"], wg, wu, wd)

    sums = []
    for got in _results(served, shape):
        r, y = got[(shape, name, "moe")]
        if strategy == "ep":
            el = e // m
            sl = slice(r * el, (r + 1) * el)
            want = local(blk["w_gate"][sl], blk["w_up"][sl],
                         blk["w_down"][sl], r * el, el)
        else:
            cols = slice(r * f // m, (r + 1) * f // m)
            want = local(blk["w_gate"][:, :, cols], blk["w_up"][:, :, cols],
                         blk["w_down"][:, cols], 0, e)
        np.testing.assert_allclose(y.numpy(), np.asarray(want), **MM)
        sums.append((r, y))
    # the model ranks of one data coordinate hold every block once
    whole = local(blk["w_gate"], blk["w_up"], blk["w_down"], 0, e)
    total = sum(y for r, y in sums[:m])
    assert sorted(r for r, _ in sums[:m]) == list(range(m))
    np.testing.assert_allclose(total.numpy(), np.asarray(whole), **MM)


def test_lc_over_a_data_and_model_mesh_equals_one_process(served):
    """``LCAlgorithm(mesh=)`` over (2, 2): items shard over "data" only;
    every rank's Θ, Δ(Θ) and λ equal ``mesh=None``'s bit for bit."""
    want, _ = w.run_lc(None)
    for r, got in enumerate(served["ranks"][4]):
        steps = got["cstep"]
        assert len(steps) == len(want)
        for k, (a, b) in enumerate(zip(steps, want)):
            assert a.keys() == b.keys()
            for n in b:
                la, lb = tree_leaves(a[n]), tree_leaves(b[n])
                assert len(la) == len(lb)
                for x, y in zip(la, lb):
                    assert x.dtype == y.dtype and torch.equal(x, y), \
                        f"rank {r} step {k} task {n}"
