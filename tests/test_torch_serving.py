"""The port's serving runtime against the JAX package: the LC-state bridge
into compressed weight forms, ``Server.generate``, the continuous-batching
``ServingEngine``, cache padding and the CLI.

One JAX LC state, made by direct compression of a reduced float32
phi3-mini (2 unrolled layers) with four tasks — 4-bit quantization (k=16)
of ``w_gate``, 8-bit quantization (k=64) of the attention matrices, ℓ0
pruning of ``w_down`` and rank-4 low rank of ``w_up`` — is carried over
with ``interop.lc_state_from_numpy`` and bridged by both packages.

Tolerances: the bridged arrays (packed indices, codebooks, COO values and
coordinates, low-rank factors) are bit-identical; greedy tokens are equal
token for token; modeled weight bytes are equal.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.core import AsIs as JAsIs, AsVector as JAsVector
from repro.core import CompressionTask as JTask, LCAlgorithm as JLC
from repro.core import schemes as js
from repro.models import transformer as jtf
from repro.runtime import compressed as jforms
from repro.runtime import server as jserver
from repro_torch import configs as tconfigs
from repro_torch import interop
from repro_torch.core import AsIs, AsVector, CompressionTask, LCAlgorithm
from repro_torch.core import schemes as ts
from repro_torch.launch import serve as tlaunch
from repro_torch.models import transformer as ttf
from repro_torch.runtime import compressed as tforms
from repro_torch.runtime import server as tserver


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def _cfgs(**kw):
    base = dict(dtype="float32", **kw)
    j = dataclasses.replace(
        jconfigs.reduced_config(jconfigs.get_config("phi3-mini-3.8b")),
        **base)
    t = dataclasses.replace(
        tconfigs.reduced_config(tconfigs.get_config("phi3-mini-3.8b")),
        **base)
    return (j.with_(pattern=j.pattern * 2, pattern_reps=1),
            t.with_(pattern=t.pattern * 2, pattern_reps=1))


def _port_task(jt):
    view = {"AsVector": AsVector(), "AsIs": AsIs()}[type(jt.view).__name__]
    scheme = {"AdaptiveQuantization": lambda s: ts.AdaptiveQuantization(
                  k=s.k, iters=s.iters),
              "ConstraintL0Pruning": lambda s: ts.ConstraintL0Pruning(
                  s.kappa),
              "LowRank": lambda s: ts.LowRank(s.rank, s.randomized)}[
                  type(jt.scheme).__name__]
    return CompressionTask(jt.name, jt.pattern, view, scheme(jt.scheme),
                           list(jt.paths))


@pytest.fixture(scope="module")
def bridged():
    jcfg, tcfg = _cfgs()
    jp = jtf.init_params(jax.random.PRNGKey(0), jcfg)
    algo = JLC([
        JTask("q4", r"ffn/w_gate$", JAsVector(),
              js.AdaptiveQuantization(k=16)),
        JTask("q8", r"mixer/(wq|wk|wv|wo)$", JAsVector(),
              js.AdaptiveQuantization(k=64)),
        JTask("pr", r"ffn/w_down$", JAsVector(),
              js.ConstraintL0Pruning(kappa=2000)),
        JTask("lr", r"ffn/w_up$", JAsIs(), js.LowRank(4)),
    ], [1e-4])
    state = algo.init(jp)
    j_serving, j_report = jserver.load_compressed_for_serving(
        jp, state, algo.tasks)
    np_params = jax.tree_util.tree_map(np.asarray, jp)
    tp = interop.params_from_numpy(np_params, "cpu")
    tstate = interop.lc_state_from_numpy(
        jax.tree_util.tree_map(np.asarray, state), "cpu")
    ttasks = [_port_task(t) for t in algo.tasks]
    t_serving, t_report = tserver.load_compressed_for_serving(
        tp, tstate, ttasks)
    return dict(jcfg=jcfg, tcfg=tcfg, jp=jp, tp=tp, state=state,
                tstate=tstate, jtasks=algo.tasks, ttasks=ttasks,
                j_serving=j_serving, j_report=j_report,
                t_serving=t_serving, t_report=t_report)


def _walk(tree, prefix=""):
    if isinstance(tree, dict) and not tforms.is_weight_form(tree):
        for k, v in tree.items():
            yield from _walk(v, f"{prefix}/{k}" if prefix else k)
    else:
        yield prefix, tree


_FIELDS = {"QuantizedWeight": ("packed", "codebook", "shape", "bits"),
           "SparseWeight": ("values", "rows", "cols", "shape"),
           "LowRankWeight": ("u", "vt")}


def _assert_same_forms(ours, theirs):
    flat_o, flat_t = dict(_walk(ours)), dict(_walk(theirs))
    assert flat_o.keys() == flat_t.keys()
    for p, t in flat_t.items():
        o = flat_o[p]
        if type(t).__name__ not in _FIELDS:          # a dense leaf
            assert isinstance(o, torch.Tensor), p
            np.testing.assert_array_equal(_np(o), np.asarray(t), err_msg=p)
            continue
        assert type(o).__name__ == type(t).__name__, p
        for f in _FIELDS[type(t).__name__]:
            a, b = getattr(o, f), getattr(t, f)
            if isinstance(b, (tuple, int)):
                assert a == b, (p, f)
            else:
                assert _np(a).dtype == np.asarray(b).dtype, (p, f)
                np.testing.assert_array_equal(_np(a), np.asarray(b),
                                              err_msg=f"{p}.{f}")


# ----------------------------------------------------------------------
# the bridge
# ----------------------------------------------------------------------
def test_bridge_forms_and_arrays_bit_identical(bridged):
    assert bridged["t_report"] == bridged["j_report"]
    kinds = sorted(v.split("(")[0] for f in bridged["t_report"].values()
                   for v in f.values())
    assert kinds == ["lowrank"] * 2 + ["quant4"] * 2 + ["quant8"] * 8 + \
        ["sparse"] * 2
    _assert_same_forms(bridged["t_serving"], bridged["j_serving"])


def test_bridge_of_a_port_lowrank_theta_matches_jax(bridged):
    """The port's own LowRank Θ (direct compression of the same weights)
    bridges to low-rank forms whose products equal the JAX package's (the
    factors themselves may differ in sign)."""
    lr_tasks = [t for t in bridged["ttasks"] if t.name.startswith("lr")]
    lc = LCAlgorithm([CompressionTask("lr", r"ffn/w_up$", AsIs(),
                                      ts.LowRank(4))], [1e-4], device="cpu")
    state = lc.init(bridged["tp"])
    assert [t.name for t in lc.tasks] == [t.name for t in lr_tasks]
    serving, report = tserver.load_compressed_for_serving(
        bridged["tp"], state, lc.tasks)
    jflat = dict(_walk(bridged["j_serving"]))
    for t in lr_tasks:
        assert report[t.name] == bridged["j_report"][t.name]
        (p,) = t.paths
        ours = dict(_walk(serving))[p]
        assert isinstance(ours, tforms.LowRankWeight)
        theirs = np.asarray(jflat[p].u) @ np.asarray(jflat[p].vt)
        # two LAPACK SVDs: products agree to float rounding of the scale
        np.testing.assert_allclose(_np(ours.u @ ours.vt), theirs, rtol=1e-5,
                                   atol=1e-5 * np.abs(theirs).max(),
                                   err_msg=p)


def test_serving_params_from_numpy_carries_jax_forms(bridged):
    carried = interop.serving_params_from_numpy(
        jax.tree_util.tree_map(np.asarray, bridged["j_serving"]), "cpu")
    _assert_same_forms(carried, bridged["j_serving"])
    _assert_same_forms(bridged["t_serving"],
                       jax.tree_util.tree_map(np.asarray,
                                              bridged["j_serving"]))


def test_materialized_forms_match_the_densified_model(bridged):
    dense = tserver.densified_for_serving(bridged["tp"], bridged["tstate"],
                                          bridged["ttasks"])
    jdense = jserver.densified_for_serving(bridged["jp"], bridged["state"],
                                           bridged["jtasks"])
    flat_d, flat_jd = dict(_walk(dense)), dict(_walk(jdense))
    for p, leaf in _walk(bridged["t_serving"]):
        np.testing.assert_array_equal(_np(flat_d[p]), np.asarray(flat_jd[p]))
        got = _np(tforms.materialize(leaf))
        if isinstance(leaf, tforms.LowRankWeight):  # u @ vt, summed again
            np.testing.assert_allclose(got, _np(flat_d[p]), rtol=1e-5,
                                       atol=1e-6)
        else:
            np.testing.assert_array_equal(got, _np(flat_d[p]), err_msg=p)


def test_weight_bytes_match_jax(bridged):
    for ours, theirs in ((bridged["t_serving"], bridged["j_serving"]),
                         (bridged["tp"], bridged["jp"])):
        assert tforms.tree_weight_bytes(ours) == \
            jforms.tree_weight_bytes(theirs)
        assert tforms.decode_hbm_bytes_per_token(ours, 4) == \
            jforms.decode_hbm_bytes_per_token(theirs, 4)
    assert tforms.tree_weight_bytes(bridged["t_serving"]) < \
        tforms.tree_weight_bytes(bridged["tp"])


# ----------------------------------------------------------------------
# generation: greedy tokens, token for token
# ----------------------------------------------------------------------
def test_server_generate_matches_jax(bridged):
    prompts = np.random.default_rng(0).integers(
        1, bridged["jcfg"].vocab_size, (2, 16)).astype(np.int32)
    want = jserver.Server(bridged["jcfg"], bridged["j_serving"],
                          max_len=40).generate(jnp.asarray(prompts), 10)
    srv = tserver.Server(bridged["tcfg"], bridged["t_serving"], max_len=40,
                         device="cpu")
    got = srv.generate(prompts, 10)
    assert got.prefill_len == want.prefill_len == 16
    np.testing.assert_array_equal(got.tokens, want.tokens)


def _trace(vocab, n=6, seed=1):
    rng = np.random.default_rng(seed)
    t, reqs = 0.0, []
    for i in range(n):
        t += float(rng.exponential(0.002))
        reqs.append((i, rng.integers(1, vocab, size=int(rng.integers(3, 21)))
                     .astype(np.int32), int(rng.integers(3, 9)), t))
    return reqs


def test_engine_matches_jax_on_a_mixed_length_trace(bridged):
    reqs = _trace(bridged["jcfg"].vocab_size)
    kw = dict(slots=3, max_len=32, prefill_chunk=4)
    jout = jserver.ServingEngine(bridged["jcfg"], bridged["j_serving"],
                                 **kw).run([jserver.Request(*r)
                                            for r in reqs])
    eng = tserver.ServingEngine(bridged["tcfg"], bridged["t_serving"],
                                device="cpu", **kw)
    tout = eng.run([tserver.Request(*r) for r in reqs])
    want = {f.id: f.tokens for f in jout["finished"]}
    got = {f.id: f for f in tout["finished"]}
    assert sorted(got) == sorted(want) == list(range(len(reqs)))
    for i, (_, prompt, max_new, _) in enumerate(reqs):
        np.testing.assert_array_equal(got[i].tokens, want[i], err_msg=str(i))
        assert len(got[i].tokens) == max_new
        assert got[i].prompt_len == len(prompt)
        assert got[i].first_token_at <= got[i].finished_at
    # one input signature per program across the mixed-length trace
    assert eng.trace_counts == {"decode": 1, "prefill": 1, "reset": 1}
    s = tout["stats"]
    assert s["requests"] == len(reqs) and s["tokens"] == sum(
        r[2] for r in reqs)
    assert s["p50_latency_s"] <= s["p99_latency_s"]


def test_engine_matches_server_greedy_on_dense_weights():
    """Continuous batching (slots refilled mid-flight, chunked prefill)
    gives every request the tokens of a batch-of-one ``Server`` run."""
    _, tcfg = _cfgs(fused_attention=True)    # prefill of any length
    params = ttf.init_params(torch.Generator().manual_seed(3), tcfg)
    reqs = [tserver.Request(*r) for r in _trace(tcfg.vocab_size, n=5,
                                                seed=4)]
    out = tserver.ServingEngine(tcfg, params, slots=2, max_len=32,
                                prefill_chunk=4, device="cpu").run(reqs)
    srv = tserver.Server(tcfg, params, max_len=32, device="cpu")
    for f in out["finished"]:
        r = reqs[f.id]
        gold = srv.generate(r.prompt[None], r.max_new).tokens[0]
        np.testing.assert_array_equal(f.tokens, gold, err_msg=str(f.id))


def test_engine_rejects_oversized_and_empty():
    _, tcfg = _cfgs()
    params = ttf.init_params(torch.Generator().manual_seed(0), tcfg)
    eng = tserver.ServingEngine(tcfg, params, slots=2, max_len=16,
                                prefill_chunk=4, device="cpu")
    out = eng.run([
        tserver.Request(0, np.arange(1, 4, dtype=np.int32), 2),
        tserver.Request(1, np.arange(1, 30, dtype=np.int32), 10),
        tserver.Request(2, np.asarray([], np.int32), 2),
    ])
    assert sorted(r.id for r in out["rejected"]) == [1, 2]
    assert [f.id for f in out["finished"]] == [0]


def test_temperature_sampling_follows_the_generator():
    _, tcfg = _cfgs()
    params = ttf.init_params(torch.Generator().manual_seed(0), tcfg)
    srv = tserver.Server(tcfg, params, max_len=24, device="cpu")
    prompt = np.arange(1, 9, dtype=np.int32)[None]
    a, b, c = (srv.generate(prompt, 6, temperature=0.8,
                            generator=torch.Generator().manual_seed(s))
               for s in (7, 7, 8))
    np.testing.assert_array_equal(a.tokens, b.tokens)
    assert not np.array_equal(a.tokens, c.tokens)
    logits = torch.randn(4, 32)
    assert torch.equal(tserver.sample_tokens(logits, None, 0.0),
                       torch.argmax(logits, -1).to(torch.int32))


# ----------------------------------------------------------------------
# pad_caches_to (as tests/test_serving.py checks it)
# ----------------------------------------------------------------------
def _gold_decode(cfg, params, prompt, n_new, max_len):
    """Independent reference: scalar-position decode loop from scratch."""
    cache = ttf.init_cache(cfg, 1, max_len, device="cpu")
    for i, t in enumerate(prompt):
        logits, cache = ttf.decode_step(params, cache,
                                        torch.tensor([[int(t)]]), i, cfg)
    out = [int(torch.argmax(logits[0, 0]))]
    pos = len(prompt)
    while len(out) < n_new:
        logits, cache = ttf.decode_step(params, cache,
                                        torch.tensor([[out[-1]]]), pos, cfg)
        out.append(int(torch.argmax(logits[0, 0])))
        pos += 1
    return np.asarray(out, np.int32)


@pytest.mark.parametrize("window", [4, 0])
def test_pad_caches_prefill_then_decode_matches_gold(window):
    from repro_torch.configs.base import LayerSpec
    _, tcfg = _cfgs()
    tcfg = tcfg.with_(pattern=(LayerSpec("attn", "dense", window=window),),
                      pattern_reps=1, attn_chunk_q=4, attn_chunk_kv=4)
    params = ttf.init_params(torch.Generator().manual_seed(1), tcfg)
    s, max_len, n_new = 8, 16, 5
    prompt = np.random.default_rng(5).integers(1, tcfg.vocab_size, s)
    hidden, _, caches = ttf.forward_hidden(
        params, torch.from_numpy(prompt)[None], tcfg, return_caches=True)
    logits = ttf.unembed(params["embed"], hidden[:, -1:], tcfg)
    caches = tserver.pad_caches_to(caches, tcfg, s, max_len)
    assert caches["s0"]["pos0"]["k"].shape[1] == (window or max_len)
    out = [int(torch.argmax(logits[0, 0]))]
    for i in range(n_new - 1):
        logits, caches = ttf.decode_step(
            params, caches, torch.tensor([[out[-1]]]), s + i, tcfg)
        out.append(int(torch.argmax(logits[0, 0])))
    np.testing.assert_array_equal(
        np.asarray(out, np.int32),
        _gold_decode(tcfg, params, prompt, n_new, max_len))


# ----------------------------------------------------------------------
# legacy quantization, the CLI
# ----------------------------------------------------------------------
def test_quantize_params_for_serving_matches_jax():
    jcfg, tcfg = _cfgs()
    jp = jtf.init_params(jax.random.PRNGKey(1), jcfg)
    tp = interop.params_from_numpy(jax.tree_util.tree_map(np.asarray, jp),
                                   "cpu")
    paths = ["stages/s0/pos0/ffn/w_up", "stages/s0/pos1/mixer/wq"]
    jpacked, jdq = jserver.quantize_params_for_serving(jp, paths, k=8,
                                                       iters=5)
    tpacked, tdq = tserver.quantize_params_for_serving(tp, paths, k=8,
                                                       iters=5)
    for p in paths:
        np.testing.assert_array_equal(_np(tpacked[p][0]),
                                      np.asarray(jpacked[p][0]))
        np.testing.assert_allclose(_np(tpacked[p][1]),
                                   np.asarray(jpacked[p][1]), rtol=1e-5,
                                   atol=1e-6)
    assert tserver.serving_bits(tpacked) == jserver.serving_bits(jpacked)


@pytest.mark.parametrize("argv", [
    ["--form", "quant4", "--engine", "--requests", "4"],
    ["--form", "quant8", "--batch", "2", "--gen", "4"],
    ["--form", "sparse", "--engine", "--requests", "3", "--slots", "2"],
    ["--form", "dense", "--batch", "2", "--gen", "3"],
    ["--form", "lowrank", "--batch", "2", "--gen", "3"],
], ids=["quant4-engine", "quant8-batch", "sparse-engine", "dense-batch",
        "lowrank-batch"])
def test_cli_serves_on_the_cpu(argv):
    out = tlaunch.main(["--arch", "phi3-mini-3.8b", "--reduced",
                        "--prompt-len", "16", "--device", "cpu", *argv])
    if "--engine" in argv:
        assert out["stats"]["requests"] == int(argv[argv.index(
            "--requests") + 1])
        assert not out["rejected"]
    else:
        assert out.tokens.shape == (2, int(argv[argv.index("--gen") + 1]))


def test_serve_compressed_twin_runs_on_the_cpu():
    """``python -m repro_torch.serve_compressed`` at the reduced config:
    one form per scheme family, and the engine's greedy tokens equal the
    densified model's (the twin raises otherwise)."""
    from repro_torch import serve_compressed
    out = serve_compressed.main(device="cpu")
    kinds = {t: sorted(v.split("(")[0] for v in forms.values())
             for t, forms in out["report"].items()}
    assert kinds == {"quant": ["quant4"], "prune": ["sparse"],
                     "lowrank": ["lowrank"]}
    assert out["out"]["stats"]["requests"] == 12
    assert not out["out"]["rejected"]
