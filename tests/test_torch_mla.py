"""The port's Multi-head Latent Attention (``repro_torch/models/
attention.py``: ``init_mla``, ``mla_forward``, ``init_mla_cache``,
``mla_decode``) against the JAX package's, on reduced float32
minicpm3-4b (qk head dim 8 + 8, v head dim 8, latent 16), with the same
weights (the JAX init carried over as numpy) and the same inputs; then
the model served: greedy tokens of ``Server.generate`` and of the
``ServingEngine``, and the LC bridge's forms per path.

Tolerances: rtol 1e-5 / atol 2e-5 for everything that runs a matrix
product or a softmax (XLA and PyTorch sum in other orders); the flash
kernel's path (its plain version here) rtol 2e-4 / atol 2e-4; bridged
arrays bit-identical; greedy tokens equal.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import attention as jattn
from repro.models import transformer as jtf
from repro_torch import configs as tconfigs
from repro_torch import interop
from repro_torch.core import flatten_params
from repro_torch.models import attention as tattn
from torch_threads import _one_torch_thread  # noqa: F401


MM = dict(rtol=1e-5, atol=2e-5)
FUSED = dict(rtol=2e-4, atol=2e-4)
ARCH = "minicpm3-4b"


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def _rand(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape) \
        .astype(np.float32)


def _cfgs(**kw):
    return tuple(dataclasses.replace(
        mod.reduced_config(mod.get_config(ARCH)), dtype="float32", **kw)
        for mod in (jconfigs, tconfigs))


def _mixer(jcfg, seed=0):
    """One MLA mixer's params (numpy, port), norm scales non-zero."""
    jp = jax.tree_util.tree_map(
        lambda x: np.array(x, copy=True),
        jattn.init_mla(jax.random.PRNGKey(seed), jcfg))
    jp["q_norm"] = _rand(seed + 1, *jp["q_norm"].shape) * 0.1
    jp["kv_norm"] = _rand(seed + 2, *jp["kv_norm"].shape) * 0.1
    return jp, interop.params_from_numpy(jp, "cpu")


def _assert_tree(ours, theirs, **tol):
    if isinstance(theirs, dict):
        assert set(ours) == set(theirs)
        for k in theirs:
            _assert_tree(ours[k], theirs[k], **tol)
    else:
        np.testing.assert_allclose(_np(ours), np.asarray(theirs), **tol)


def test_init_mla_shapes_and_cache():
    jcfg, tcfg = _cfgs()
    want = jax.eval_shape(lambda: jattn.init_mla(jax.random.PRNGKey(0),
                                                 jcfg))
    got = tattn.init_mla(torch.Generator().manual_seed(0), tcfg)
    assert {k: tuple(v.shape) for k, v in got.items()} == \
        {k: tuple(v.shape) for k, v in want.items()}
    assert float(got["q_norm"].abs().max()) == 0.0
    spec = tcfg.pattern[0]
    _assert_tree(tattn.init_mla_cache(tcfg, spec, 2, 9, torch.float32,
                                      "cpu"),
                 jattn.init_mla_cache(jcfg, spec, 2, 9, jnp.float32),
                 rtol=0, atol=0)


@pytest.mark.parametrize("fused", [False, True])
def test_mla_forward_and_cache_match_jax(fused):
    jcfg, tcfg = _cfgs(fused_attention=fused)
    jp, tp = _mixer(jcfg)
    x = _rand(3, 2, 16, jcfg.d_model)
    pos = np.arange(16, dtype=np.int32)
    spec = jcfg.pattern[0]
    yj, cj = jattn.mla_forward(jp, jnp.asarray(x), jcfg, spec,
                               jnp.asarray(pos), return_cache=True)
    yt, ct = tattn.mla_forward(tp, torch.from_numpy(x), tcfg, spec,
                               torch.from_numpy(pos), return_cache=True)
    np.testing.assert_allclose(_np(yt), np.asarray(yj),
                               **(FUSED if fused else MM))
    _assert_tree(ct, jax.tree_util.tree_map(np.asarray, cj), **MM)
    assert ct["ckv"].shape == (2, 16, jcfg.mla.kv_lora_rank)
    np.testing.assert_allclose(
        _np(tattn.mla_forward(tp, torch.from_numpy(x), tcfg, spec,
                              torch.from_numpy(pos))), _np(yt), rtol=0,
        atol=0)


def test_blockwise_attention_with_its_own_v_head_dim_and_scale():
    """MLA's attention: qk head dim D, v head dim Dv ≠ D, scale given."""
    b, s, h, d, dv = 2, 16, 4, 16, 8
    q, k, v = _rand(1, b, s, h, d), _rand(2, b, s, h, d), \
        _rand(3, b, s, h, dv)
    pos = np.arange(s, dtype=np.int32)
    want = np.asarray(jattn.blockwise_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(pos),
        jnp.asarray(pos), q_chunk=8, kv_chunk=4, scale=0.3))
    tq, tk, tv, tpos = (torch.from_numpy(a) for a in (q, k, v, pos))
    for fused, tol in ((False, MM), (True, FUSED)):
        got = tattn.blockwise_attention(tq, tk, tv, tpos, tpos, q_chunk=8,
                                        kv_chunk=4, scale=0.3, fused=fused)
        assert got.shape == (b, s, h, dv)
        np.testing.assert_allclose(_np(got), want, **tol)


def _decode_args(jcfg, mode, b=3, max_len=12, layers=2):
    """(cache as numpy, pos, layer_idx) of one of the reference's three
    cache modes: per-slot (B,) positions, layer-stacked cache with a
    layer index, or a scalar position."""
    m = jcfg.mla
    lead = (layers,) if mode == "stacked" else ()
    cache = {"ckv": _rand(5, *lead, b, max_len, m.kv_lora_rank),
             "k_rope": _rand(6, *lead, b, max_len, m.qk_rope_dim)}
    if mode == "per_slot":
        return cache, np.array([4, 0, 11], np.int32), None
    return cache, np.int32(7), (1 if mode == "stacked" else None)


@pytest.mark.parametrize("mode", ["per_slot", "stacked", "scalar"])
def test_mla_decode_matches_jax(mode):
    jcfg, tcfg = _cfgs()
    jp, tp = _mixer(jcfg)
    cache, pos, layer_idx = _decode_args(jcfg, mode)
    x = _rand(4, 3, 1, jcfg.d_model)
    spec = jcfg.pattern[0]
    yj, cj = jattn.mla_decode(jp, jnp.asarray(x),
                              jax.tree_util.tree_map(jnp.asarray, cache),
                              jnp.asarray(pos), jcfg, spec,
                              layer_idx=layer_idx)
    t_pos = torch.from_numpy(pos) if pos.ndim else int(pos)
    yt, ct = tattn.mla_decode(tp, torch.from_numpy(x),
                              interop.params_from_numpy(cache, "cpu"),
                              t_pos, tcfg, spec, layer_idx=layer_idx)
    np.testing.assert_allclose(_np(yt), np.asarray(yj), **MM)
    _assert_tree(ct, jax.tree_util.tree_map(np.asarray, cj), **MM)


def test_mla_decode_active_mask_matches_the_reference_merge():
    """Inactive rows: the cache as it was, bit for bit; the outputs those
    of the reference's step (its cache merge comes after the step)."""
    jcfg, tcfg = _cfgs()
    jp, tp = _mixer(jcfg)
    cache, pos, _ = _decode_args(jcfg, "stacked")
    x = _rand(4, 3, 1, jcfg.d_model)
    spec = jcfg.pattern[0]
    yj, _ = jattn.mla_decode(jp, jnp.asarray(x),
                             jax.tree_util.tree_map(jnp.asarray, cache),
                             jnp.asarray(np.array([7, 2, 9], np.int32)),
                             jcfg, spec, layer_idx=1)
    tcache = interop.params_from_numpy(cache, "cpu")
    active = torch.tensor([True, False, True])
    yt, ct = tattn.mla_decode(tp, torch.from_numpy(x), tcache,
                              torch.tensor([7, 2, 9]), tcfg, spec,
                              layer_idx=1, active=active)
    np.testing.assert_allclose(_np(yt), np.asarray(yj), **MM)
    for k in cache:
        np.testing.assert_array_equal(_np(ct[k][:, 1]), cache[k][:, 1])
        assert not np.array_equal(_np(ct[k][1, 0]), cache[k][1, 0])


# ----------------------------------------------------------------------
# serving
# ----------------------------------------------------------------------
def test_generate_and_engine_match_jax():
    from repro.runtime import server as jserver
    from repro_torch.runtime import server as tserver
    jcfg, tcfg = _cfgs()
    jp = jtf.init_params(jax.random.PRNGKey(0), jcfg)
    tp = interop.params_from_numpy(jax.tree_util.tree_map(np.asarray, jp),
                                   "cpu")
    prompts = np.random.default_rng(0).integers(
        1, jcfg.vocab_size, (2, 16)).astype(np.int32)
    want = jserver.Server(jcfg, jp, max_len=40).generate(
        jnp.asarray(prompts), 10)
    got = tserver.Server(tcfg, tp, max_len=40, device="cpu").generate(
        prompts, 10)
    np.testing.assert_array_equal(got.tokens, want.tokens)

    rng = np.random.default_rng(1)
    t, reqs = 0.0, []
    for i in range(6):
        t += float(rng.exponential(0.002))
        reqs.append((i, rng.integers(1, jcfg.vocab_size,
                                     size=int(rng.integers(3, 21)))
                     .astype(np.int32), int(rng.integers(3, 9)), t))
    kw = dict(slots=3, max_len=32, prefill_chunk=4)
    jout = jserver.ServingEngine(jcfg, jp, **kw).run(
        [jserver.Request(*r) for r in reqs])
    eng = tserver.ServingEngine(tcfg, tp, device="cpu", **kw)
    tout = eng.run([tserver.Request(*r) for r in reqs])
    want = {f.id: f.tokens for f in jout["finished"]}
    got = {f.id: f.tokens for f in tout["finished"]}
    assert sorted(got) == sorted(want) == list(range(len(reqs)))
    for i in want:
        np.testing.assert_array_equal(got[i], want[i], err_msg=str(i))
    assert eng.trace_counts == {"decode": 1, "prefill": 1, "reset": 1}


def test_bridge_forms_per_path_and_served_tokens_match_jax():
    """A JAX LC state with 8-bit MLA projections and a 4-bit FFN, bridged
    by both packages: the same form for every path, the same arrays, and
    the same greedy tokens served (``wukv`` is materialized through
    ``wload``, the other projections run their compressed product)."""
    from repro.core import AsVector as JAsVector
    from repro.core import CompressionTask as JTask, LCAlgorithm as JLC
    from repro.core import schemes as js
    from repro.runtime import server as jserver
    from repro_torch.core import AsVector, CompressionTask
    from repro_torch.core import schemes as ts
    from repro_torch.runtime import compressed as tforms
    from repro_torch.runtime import server as tserver
    jcfg, tcfg = _cfgs(pattern_reps=1)
    jp = jtf.init_params(jax.random.PRNGKey(0), jcfg)
    specs = [("mla", r"mixer/(wdq|wuq|wdkv|wukv|wo)$", 64),
             ("ffn", r"ffn/(w_gate|w_up|w_down)$", 16)]
    algo = JLC([JTask(n, pat, JAsVector(), js.AdaptiveQuantization(k=k))
                for n, pat, k in specs], [1e-4])
    state = algo.init(jp)
    j_serving, j_report = jserver.load_compressed_for_serving(
        jp, state, algo.tasks)
    tp = interop.params_from_numpy(jax.tree_util.tree_map(np.asarray, jp),
                                   "cpu")
    tstate = interop.lc_state_from_numpy(
        jax.tree_util.tree_map(np.asarray, state), "cpu")
    ttasks = [CompressionTask(t.name, t.pattern, AsVector(),
                              ts.AdaptiveQuantization(k=t.scheme.k),
                              list(t.paths)) for t in algo.tasks]
    t_serving, t_report = tserver.load_compressed_for_serving(
        tp, tstate, ttasks)
    assert t_report == j_report
    assert set(t_report["mla"].values()) == {"quant8"}
    assert len(t_report["mla"]) == 5 * jcfg.n_layers
    assert set(t_report["ffn"].values()) == {"quant4"}
    jflat, tflat = flatten_params(j_serving), flatten_params(t_serving)
    for path in (*t_report["mla"], *t_report["ffn"]):
        ours, theirs = tflat[path], jflat[path]
        assert isinstance(ours, tforms.QuantizedWeight), path
        assert (ours.shape, ours.bits) == (theirs.shape, theirs.bits)
        np.testing.assert_array_equal(_np(ours.packed),
                                      np.asarray(theirs.packed))
        np.testing.assert_array_equal(_np(ours.codebook),
                                      np.asarray(theirs.codebook))
    prompts = np.random.default_rng(0).integers(
        1, jcfg.vocab_size, (2, 16)).astype(np.int32)
    want = jserver.Server(jcfg, j_serving, max_len=32).generate(
        jnp.asarray(prompts), 8)
    got = tserver.Server(tcfg, t_serving, max_len=32, device="cpu") \
        .generate(prompts, 8)
    np.testing.assert_array_equal(got.tokens, want.tokens)


def test_cli_serves_and_trains_on_the_cpu():
    from repro_torch.launch import serve as tserve
    from repro_torch.launch import train as ttrain
    out = tserve.main(["--arch", ARCH, "--reduced", "--prompt-len", "16",
                       "--form", "quant8", "--engine", "--requests", "3",
                       "--device", "cpu"])
    assert out["stats"]["requests"] == 3 and not out["rejected"]
    trainer = ttrain.main(["--arch", ARCH, "--reduced", "--lc-steps", "2",
                           "--steps-per-l", "2", "--batch", "2", "--seq",
                           "16", "--device", "cpu"])
    assert len(trainer.history) == 2
    assert all(np.isfinite(r["loss"]) for r in trainer.history)
