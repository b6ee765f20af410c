"""The port's configs, layers, attention and decoder stack against the
JAX package, on the same weights (the JAX ``init_params`` carried over
with ``interop.params_from_numpy``) and the same numpy inputs.

The stack's forward, decode and prefill-then-decode tests run every
reduced config whose mixers are ported: phi3-mini (scan and unrolled),
mistral-nemo-12b (q_dim ≠ d_model), gemma3-27b (5:1 window pattern, scan
plus tail, tied embeddings), musicgen-large and internvl2-1b (embedding
inputs), mixtral-8x7b and deepseek-moe-16b (MoE, at the reference's
capacity factor, so tokens are dropped; prefill-then-decode at the
no-drop 8.0, as ``tests/test_models.py`` does) and minicpm3-4b (MLA).

Tolerances: configs and parameter counts equal; elementwise layers
(RMSNorm, RoPE, embedding) rtol 1e-6 / atol 1e-6; anything that runs a
matrix product or a softmax — XLA and PyTorch sum in other orders —
rtol 1e-5 / atol 2e-5 in float32; the flash kernel's plain version
against the online-softmax loop rtol 2e-4 / atol 2e-4, as
``tests/test_kernels.py`` holds the Pallas kernel; the port's prefill
against its own token-by-token decode rtol 2e-3 / atol 2e-3, the
reference's own tolerance for that check.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.core import flatten_params as jflatten
from repro.models import attention as jattn
from repro.models import layers as jlayers
from repro.models import transformer as jtf
from repro_torch import configs as tconfigs
from repro_torch import interop
from repro_torch.core import flatten_params as tflatten
from repro_torch.models import attention as tattn
from repro_torch.models import layers as tlayers
from repro_torch.models import transformer as ttf

MM = dict(rtol=1e-5, atol=2e-5)       # matrix products / softmax
EW = dict(rtol=1e-6, atol=1e-6)       # elementwise maps


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def _rand(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape) \
        .astype(np.float32)


def _cfgs(arch="phi3-mini-3.8b", **kw):
    """The same reduced float32 config in both packages."""
    j = dataclasses.replace(jconfigs.reduced_config(jconfigs.get_config(arch)),
                            dtype="float32", **kw)
    t = dataclasses.replace(tconfigs.reduced_config(tconfigs.get_config(arch)),
                            dtype="float32", **kw)
    return j, t


#: the reduced configs, beside phi3-mini, that the stack tests run
ARCHS = ["mistral-nemo-12b", "gemma3-27b", "musicgen-large", "internvl2-1b",
         "mixtral-8x7b", "deepseek-moe-16b", "minicpm3-4b"]


def _arch_cfgs(arch, layout):
    return _unrolled() if layout == "unrolled" else _cfgs(arch)


def _cases(second):
    """phi3-mini at both layouts, with the ids those cases always had,
    then every other config in its own layout, for both values of the
    test's ``second`` parameter."""
    return ([pytest.param("phi3-mini-3.8b", layout, x, id=f"{x}-{layout}")
             for x in (False, True) for layout in ("scan", "unrolled")]
            + [pytest.param(a, "own", x, id=f"{a}-{x}")
               for a in ARCHS for x in (False, True)])


def _inputs(cfg, b, s, seed):
    """Tokens, or frontend embeddings for an ``input_mode="embeddings"``
    config, as numpy."""
    rng = np.random.default_rng(seed)
    if cfg.input_mode == "tokens":
        return rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)
    return rng.standard_normal((b, s, cfg.d_input)).astype(np.float32)


def _unrolled(**kw):
    j, t = _cfgs(**kw)
    return (j.with_(pattern=j.pattern * 2, pattern_reps=1),
            t.with_(pattern=t.pattern * 2, pattern_reps=1))


def _params(jcfg, seed=0):
    jp = jax.tree_util.tree_map(
        np.asarray, jtf.init_params(jax.random.PRNGKey(seed), jcfg))
    # non-zero norm scales so the (1 + scale) path is exercised
    jp["final_norm"] = _rand(seed + 1, *jp["final_norm"].shape) * 0.1
    return jp, interop.params_from_numpy(jp, "cpu")


def _assert_tree(ours, theirs, **tol):
    if isinstance(theirs, dict):
        assert set(ours) == set(theirs)
        for k in theirs:
            _assert_tree(ours[k], theirs[k], **tol)
    else:
        np.testing.assert_allclose(_np(ours), np.asarray(theirs), **tol)


# ----------------------------------------------------------------------
# configs
# ----------------------------------------------------------------------
@pytest.mark.parametrize("arch", jconfigs.ARCHS)
def test_configs_match_jax(arch):
    j, t = jconfigs.get_config(arch), tconfigs.get_config(arch)
    assert dataclasses.astuple(t) == dataclasses.astuple(j)
    assert dataclasses.astuple(tconfigs.reduced_config(t)) == \
        dataclasses.astuple(jconfigs.reduced_config(j))
    assert t.n_layers == j.n_layers and t.q_dim == j.q_dim


@pytest.mark.parametrize("arch", jconfigs.ARCHS)
def test_count_params_match_jax(arch):
    j, t = jconfigs.get_config(arch), tconfigs.get_config(arch)
    assert t.param_count() == j.param_count()
    assert t.active_param_count() == j.active_param_count()
    rj, rt = jconfigs.reduced_config(j), tconfigs.reduced_config(t)
    assert ttf.count_params(rt) == jtf.count_params(rj)


@pytest.mark.parametrize("layout", ["scan", "unrolled"])
def test_init_params_shapes_match_jax(layout):
    jcfg, tcfg = _cfgs() if layout == "scan" else _unrolled()
    jshapes = jax.eval_shape(
        lambda: jtf.init_params(jax.random.PRNGKey(0), jcfg))
    ours = ttf.init_params(torch.Generator().manual_seed(0), tcfg)
    assert {p: tuple(v.shape) for p, v in tflatten(ours).items()} == \
        {p: tuple(v.shape) for p, v in jflatten(jshapes).items()}
    w = ours["stages"]["s0"]["pos0"]["ffn"]["w_up"]
    # dense_init: std 1/sqrt(fan_in)
    assert abs(float(w.std()) * np.sqrt(w.shape[-2]) - 1.0) < 0.05


# ----------------------------------------------------------------------
# layers
# ----------------------------------------------------------------------
def test_layers_match_jax():
    jcfg, tcfg = _cfgs()
    jp, tp = _params(jcfg)
    x = _rand(3, 2, 5, jcfg.d_model)
    scale = _rand(4, jcfg.d_model) * 0.1
    np.testing.assert_allclose(
        _np(tlayers.rms_norm(torch.from_numpy(x), torch.from_numpy(scale),
                             1e-6)),
        np.asarray(jlayers.rms_norm(jnp.asarray(x), jnp.asarray(scale),
                                    1e-6)), **EW)
    q = _rand(5, 2, 5, 2, 16)
    pos = np.arange(3, 8, dtype=np.int32)
    np.testing.assert_allclose(
        _np(tlayers.apply_rope(torch.from_numpy(q), torch.from_numpy(pos),
                               1e4)),
        np.asarray(jlayers.apply_rope(jnp.asarray(q), jnp.asarray(pos),
                                      1e4)), **EW)
    toks = np.random.default_rng(6).integers(0, jcfg.vocab_size, (2, 5))
    emb = tlayers.embed(tp["embed"], torch.from_numpy(toks), tcfg)
    np.testing.assert_allclose(
        _np(emb), np.asarray(jlayers.embed(jp["embed"], jnp.asarray(toks),
                                           jcfg)), **EW)
    np.testing.assert_allclose(
        _np(tlayers.unembed(tp["embed"], torch.from_numpy(x), tcfg)),
        np.asarray(jlayers.unembed(jp["embed"], jnp.asarray(x), jcfg)), **MM)
    ffn_j = jp["stages"]["s0"]["pos0"]["ffn"]
    ffn_t = {k: v[0] for k, v in tp["stages"]["s0"]["pos0"]["ffn"].items()}
    np.testing.assert_allclose(
        _np(tlayers.dense_ffn(ffn_t, torch.from_numpy(x), tcfg)),
        np.asarray(jlayers.dense_ffn(
            {k: v[0] for k, v in ffn_j.items()}, jnp.asarray(x), jcfg)),
        **MM)
    logits = _rand(7, 2, 5, 11)
    labels = np.random.default_rng(8).integers(0, 11, (2, 5))
    mask = (np.arange(5)[None] < np.array([[3], [5]])).astype(np.float32)
    for m in (None, mask):
        np.testing.assert_allclose(
            float(tlayers.cross_entropy(
                torch.from_numpy(logits), torch.from_numpy(labels),
                None if m is None else torch.from_numpy(m))),
            float(jlayers.cross_entropy(
                jnp.asarray(logits), jnp.asarray(labels),
                None if m is None else jnp.asarray(m))), rtol=1e-6)


# ----------------------------------------------------------------------
# attention
# ----------------------------------------------------------------------
@pytest.mark.parametrize("b,s,h,kvh,d,window,chunk", [
    (2, 16, 4, 2, 8, 0, 4), (1, 24, 6, 3, 16, 5, 8), (2, 12, 2, 2, 8, 0, 12),
])
def test_blockwise_attention_matches_jax(b, s, h, kvh, d, window, chunk):
    q, k, v = _rand(1, b, s, h, d), _rand(2, b, s, kvh, d), \
        _rand(3, b, s, kvh, d)
    pos = np.arange(s, dtype=np.int32)
    want = np.asarray(jattn.blockwise_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(pos),
        jnp.asarray(pos), window=window, q_chunk=chunk, kv_chunk=chunk))
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    tpos = torch.from_numpy(pos)
    plain = tattn.blockwise_attention(tq, tk, tv, tpos, tpos, window=window,
                                      q_chunk=chunk, kv_chunk=chunk)
    np.testing.assert_allclose(_np(plain), want, **MM)
    # fused=True: the flash kernel's path (its plain version on the CPU)
    fused = tattn.blockwise_attention(tq, tk, tv, tpos, tpos, window=window,
                                      fused=True)
    np.testing.assert_allclose(_np(fused), want, rtol=2e-4, atol=2e-4)


def test_fused_attention_refuses_what_the_kernel_does_not_take():
    """The kernel takes the causal Sq == Sk prefill only; an explicit
    scale and V's own head dim (MLA) it takes."""
    q = torch.zeros(1, 8, 2, 8)
    pos = torch.arange(8)
    with pytest.raises(NotImplementedError, match="flash kernel"):
        tattn.blockwise_attention(q, q[:, :4], q[:, :4], pos, pos[:4],
                                  fused=True)
    q, k, v = (torch.from_numpy(_rand(i, 1, 8, 2, d))
               for i, d in ((1, 8), (2, 8), (3, 4)))
    np.testing.assert_allclose(
        _np(tattn.blockwise_attention(q, k, v, pos, pos, scale=0.5,
                                      fused=True)),
        _np(tattn.blockwise_attention(q, k, v, pos, pos, scale=0.5,
                                      q_chunk=4, kv_chunk=4)),
        rtol=2e-4, atol=2e-4)


# ----------------------------------------------------------------------
# the stack: prefill and decode
# ----------------------------------------------------------------------
@pytest.mark.parametrize("arch,layout,fused", _cases("fused"))
def test_forward_hidden_and_caches_match_jax(arch, layout, fused):
    jcfg, tcfg = _arch_cfgs(arch, layout)
    jcfg, tcfg = (c.with_(fused_attention=fused) for c in (jcfg, tcfg))
    if layout != "own":
        assert len(jtf.plan_stages(jcfg)) == 1
        assert jtf.plan_stages(jcfg)[0]["kind"] == layout.replace(
            "unrolled", "unroll")
    jp, tp = _params(jcfg)
    inputs = _inputs(jcfg, 2, 16, 1)
    h_j, aux_j, c_j = jtf.forward_hidden(jp, jnp.asarray(inputs), jcfg,
                                         return_caches=True)
    h_t, aux, c_t = ttf.forward_hidden(tp, torch.from_numpy(inputs), tcfg,
                                       return_caches=True)
    tol = MM if not fused else dict(rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(_np(h_t), np.asarray(h_j), **tol)
    _assert_tree(c_t, jax.tree_util.tree_map(np.asarray, c_j), **MM)
    if jcfg.moe is None:
        assert float(aux) == float(aux_j) == 0.0
    else:
        assert float(aux_j) > 0.0
        np.testing.assert_allclose(float(aux), float(aux_j), rtol=1e-5)
    np.testing.assert_allclose(
        _np(ttf.prefill(tp, torch.from_numpy(inputs), tcfg)),
        np.asarray(jtf.prefill(jp, jnp.asarray(inputs), jcfg)), **tol)


def _random_cache(jcfg, b, max_len):
    shapes = jax.tree_util.tree_map(
        lambda a: a.shape, jtf.init_cache(jcfg, b, max_len))
    leaves, treedef = jax.tree_util.tree_flatten(shapes,
                                                 is_leaf=lambda x: isinstance(
                                                     x, tuple))
    return jax.tree_util.tree_unflatten(
        treedef, [_rand(i, *s) for i, s in enumerate(leaves)])


@pytest.mark.parametrize("arch,layout,per_slot", _cases("per_slot"))
def test_decode_step_matches_jax(arch, layout, per_slot):
    jcfg, tcfg = _arch_cfgs(arch, layout)
    jp, tp = _params(jcfg)
    b, max_len = 3, 12
    cache = _random_cache(jcfg, b, max_len)
    toks = (np.array([[5], [17], [200]], np.int32)
            if jcfg.input_mode == "tokens" else _inputs(jcfg, b, 1, 9))
    pos = np.array([4, 0, 11], np.int32) if per_slot else np.int32(6)
    lj, cj = jtf.decode_step(jp, jax.tree_util.tree_map(jnp.asarray, cache),
                             jnp.asarray(toks), jnp.asarray(pos), jcfg)
    lt, ct = ttf.decode_step(
        tp, interop.params_from_numpy(cache, "cpu"), torch.from_numpy(toks),
        torch.from_numpy(pos) if per_slot else int(pos), tcfg)
    np.testing.assert_allclose(_np(lt), np.asarray(lj), **MM)
    _assert_tree(ct, jax.tree_util.tree_map(np.asarray, cj), **MM)


@pytest.mark.parametrize("arch", ["phi3-mini-3.8b", *ARCHS])
def test_prefill_then_decode_matches_jax(arch):
    """Prefill with cache capture, padding to decode capacity, then 4
    decode steps fed with the reference's greedy tokens: every step's
    logits and the final caches against the JAX package on the same
    path; and the port's prefill against its own token-by-token decode
    from an empty cache (the reference's own check). MoE configs use the
    no-drop capacity factor here: decode routes B tokens at a time, so
    at the reference's factor its drops differ from prefill's."""
    from repro.runtime.server import pad_caches_to as jpad
    from repro_torch.runtime.server import pad_caches_to as tpad
    jcfg, tcfg = _cfgs(arch)
    if jcfg.moe is not None:
        jcfg = jcfg.with_(moe=dataclasses.replace(jcfg.moe,
                                                  capacity_factor=8.0))
        tcfg = tcfg.with_(moe=dataclasses.replace(tcfg.moe,
                                                  capacity_factor=8.0))
    jp, tp = _params(jcfg)
    b, s, extra = 2, 24, 4
    inputs = _inputs(jcfg, b, s + extra, 2)
    prompt, cont = inputs[:, :s], inputs[:, s:]
    hj, _, cj = jtf.forward_hidden(jp, jnp.asarray(prompt), jcfg,
                                   return_caches=True)
    ht, _, ct = ttf.forward_hidden(tp, torch.from_numpy(prompt), tcfg,
                                   return_caches=True)
    cj, ct = jpad(cj, jcfg, s, s + extra), tpad(ct, tcfg, s, s + extra)
    _assert_tree(ct, jax.tree_util.tree_map(np.asarray, cj), **MM)
    lt_prefill = tlayers.unembed(tp["embed"], ht[:, -1:], tcfg)
    np.testing.assert_allclose(
        _np(lt_prefill),
        np.asarray(jlayers.unembed(jp["embed"], hj[:, -1:], jcfg)), **MM)
    for i in range(extra):
        x = cont[:, i:i + 1]
        lj, cj = jtf.decode_step(jp, cj, jnp.asarray(x), jnp.int32(s + i),
                                 jcfg)
        lt, ct = ttf.decode_step(tp, ct, torch.from_numpy(x), s + i, tcfg)
        np.testing.assert_allclose(_np(lt), np.asarray(lj), **MM)
    _assert_tree(ct, jax.tree_util.tree_map(np.asarray, cj), **MM)

    # the port's prefill equals its own all-decode path
    cache = ttf.init_cache(tcfg, b, s + extra, device="cpu")
    for i in range(s):
        logits, cache = ttf.decode_step(tp, cache,
                                        torch.from_numpy(prompt[:, i:i + 1]),
                                        i, tcfg)
    np.testing.assert_allclose(_np(logits), _np(lt_prefill), rtol=2e-3,
                               atol=2e-3)


def test_decode_active_mask_keeps_inactive_rows_bit_for_bit():
    jcfg, tcfg = _unrolled()
    _, tp = _params(jcfg)
    cache = ttf.init_cache(tcfg, 3, 8, device="cpu")
    for leaf in (cache["s0"][p][k] for p in cache["s0"] for k in ("k", "v")):
        leaf.copy_(torch.randn(leaf.shape))
    before = {p: {k: v.clone() for k, v in c.items()}
              for p, c in cache["s0"].items()}
    active = torch.tensor([True, False, True])
    ttf.decode_step(tp, cache, torch.tensor([[1], [2], [3]]),
                    torch.tensor([2, 5, 7]), tcfg, active=active)
    for p, c in cache["s0"].items():
        for k, v in c.items():
            assert torch.equal(v[1], before[p][k][1])
            assert not torch.equal(v[0], before[p][k][0])


def test_windowed_ring_buffer_matches_jax():
    """A windowed layer keeps a ring of ``window`` slots; decoding past
    the window overwrites slot pos % window. Prefill 8 tokens into a
    window-4 ring, then 6 decode steps, against the JAX package."""
    from repro.configs.base import LayerSpec as JSpec
    from repro_torch.configs.base import LayerSpec as TSpec
    jcfg, tcfg = _cfgs()
    jcfg = jcfg.with_(pattern=(JSpec("attn", "dense", window=4),
                               JSpec("attn", "dense")), pattern_reps=1)
    tcfg = tcfg.with_(pattern=(TSpec("attn", "dense", window=4),
                               TSpec("attn", "dense")), pattern_reps=1)
    jp, tp = _params(jcfg)
    toks = np.random.default_rng(2).integers(1, jcfg.vocab_size, (2, 8))
    _, _, cj = jtf.forward_hidden(jp, jnp.asarray(toks), jcfg,
                                  return_caches=True)
    _, _, ct = ttf.forward_hidden(tp, torch.from_numpy(toks), tcfg,
                                  return_caches=True)
    assert ct["s0"]["pos0"]["k"].shape[1] == 4          # the ring
    from repro.runtime.server import pad_caches_to as jpad
    from repro_torch.runtime.server import pad_caches_to as tpad
    cj, ct = jpad(cj, jcfg, 8, 16), tpad(ct, tcfg, 8, 16)
    _assert_tree(ct, jax.tree_util.tree_map(np.asarray, cj), **MM)
    tok = np.array([[3], [9]], np.int32)
    jstep = jax.jit(lambda p, c, t, pos: jtf.decode_step(p, c, t, pos, jcfg))
    for i in range(6):
        lj, cj = jstep(jp, cj, jnp.asarray(tok), jnp.int32(8 + i))
        lt, ct = ttf.decode_step(tp, ct, torch.from_numpy(tok), 8 + i, tcfg)
        np.testing.assert_allclose(_np(lt), np.asarray(lj), **MM)
        tok = np.asarray(jnp.argmax(lj[:, 0], -1))[:, None].astype(np.int32)
    _assert_tree(ct, jax.tree_util.tree_map(np.asarray, cj), **MM)


def test_cache_axes_and_init_cache_match_jax():
    for jcfg, tcfg in (_cfgs(), _unrolled()):
        assert ttf.cache_axes(tcfg) == jtf.cache_axes(jcfg)
        tc = ttf.init_cache(tcfg, 2, 9, device="cpu")
        jc = jtf.init_cache(jcfg, 2, 9)
        _assert_tree(tc, jax.tree_util.tree_map(np.asarray, jc), rtol=0,
                     atol=0)
