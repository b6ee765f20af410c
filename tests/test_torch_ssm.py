"""The port's recurrent mixers (``repro_torch/models/ssm.py``: Mamba-1,
mLSTM, sLSTM) and the models built on them (reduced float32
jamba-v0.1-52b and xlstm-125m) against the JAX package, with the same
weights (the JAX inits carried over as numpy) and the same numpy inputs:
the mixers' pieces, forward, decode and serving. Training, the CLIs and
the LM example are in ``tests/test_torch_ssm_train.py``.

Tolerances (those of ``tests/test_torch_models.py``): anything with a
product or a reduction rtol 1e-5 / atol 2e-5 in float32 (XLA and
PyTorch sum in other orders, and their exp/log1p differ in the last
bits); the selective scan, which the port runs as the reference's own
odd/even recursion, rtol 1e-6 / atol 1e-6; the port's prefill against
its own token-by-token decode rtol 2e-3 / atol 2e-3, the reference's
tolerance for that check (``tests/test_models.py``), MoE at its no-drop
capacity factor 8.0; greedy tokens equal.

End to end, recurrent states are held to their own scale: a state leaf
is compared at atol 2e-5 · max(1, max|leaf|). sLSTM's cell c is a signed
sum of gated tanh terms bounded by its normalizer n (|c| ≤ n, which
reaches ~8 in the 12-block xlstm), so after 11 blocks the ~1e-5 relative
gap that the two packages' sums leave in a block's input reaches c at
n's scale, not at c's own; the mixers alone (the tests above the model
tests) hold c at the plain rtol 1e-5 / atol 2e-5.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import ssm as jssm
from repro.models import transformer as jtf
from repro_torch import configs as tconfigs
from repro_torch import interop
from repro_torch.core import flatten_params
from repro_torch.models import layers as tlayers
from repro_torch.models import ssm as tssm
from repro_torch.models import transformer as ttf

MM = dict(rtol=1e-5, atol=2e-5)       # matrix products / reductions
SCAN = dict(rtol=1e-6, atol=1e-6)     # the mirrored associative scan
OWN = dict(rtol=2e-3, atol=2e-3)      # prefill against own decode
ARCHS = ["jamba-v0.1-52b", "xlstm-125m"]
MIXERS = ["mamba", "mlstm", "slstm"]
_ARCH_OF = {"mamba": "jamba-v0.1-52b", "mlstm": "xlstm-125m",
            "slstm": "xlstm-125m"}
_STATE_KEYS = {"ssm", "C", "n", "m", "c", "h"}


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def _rand(seed, *shape, scale=1.0):
    return (scale * np.random.default_rng(seed).standard_normal(shape)) \
        .astype(np.float32)


def _cfgs(arch, capacity_factor=None, **kw):
    """The same reduced float32 config in both packages (MoE at
    ``capacity_factor`` where given)."""
    out = []
    for mod in (jconfigs, tconfigs):
        c = dataclasses.replace(mod.reduced_config(mod.get_config(arch)),
                                dtype="float32", **kw)
        if capacity_factor is not None and c.moe is not None:
            c = c.with_(moe=dataclasses.replace(
                c.moe, capacity_factor=capacity_factor))
        out.append(c)
    return tuple(out)


def _spec(cfg, mixer):
    return next(s for s in cfg.all_layer_specs() if s.mixer == mixer)


def _mixer_params(mixer, jcfg, seed=0):
    """One mixer's params from the JAX init, its zero biases and norm
    scales made random so their paths are exercised."""
    init = {"mamba": jssm.init_mamba, "mlstm": jssm.init_mlstm,
            "slstm": jssm.init_slstm}[mixer]
    jp = {k: np.array(v, copy=True)
          for k, v in init(jax.random.PRNGKey(seed), jcfg).items()}
    for i, k in enumerate(("conv_b", "out_norm", "bi")):
        if k in jp:
            jp[k] = jp[k] + _rand(seed + 10 + i, *jp[k].shape, scale=0.1)
    return jp, interop.params_from_numpy(jp, "cpu")


def _forward(pkg, mixer):
    return getattr(jssm if pkg == "jax" else tssm, f"{mixer}_forward")


def _decode(pkg, mixer):
    return getattr(jssm if pkg == "jax" else tssm, f"{mixer}_decode")


def _assert_tree(ours, theirs, states_at_scale=False, normwise=0.0, **tol):
    """Leaf by leaf at ``tol``; with ``states_at_scale`` the recurrent
    states' atol times max(1, max|leaf|); with ``normwise`` every leaf's
    atol at least ``normwise`` · max|leaf| (the training tests)."""
    fo = flatten_params(interop.to_numpy(ours))
    ft = flatten_params(jax.tree_util.tree_map(np.asarray, theirs))
    assert set(fo) == set(ft)
    for k in ft:
        t = dict(tol)
        scale = float(np.abs(ft[k]).max()) if ft[k].size else 0.0
        if states_at_scale and k.rsplit("/", 1)[-1] in _STATE_KEYS:
            t["atol"] = t["atol"] * max(1.0, scale)
        t["atol"] = max(t["atol"], normwise * scale)
        np.testing.assert_allclose(fo[k], ft[k], err_msg=k, **t)


def _params(jcfg, seed=0):
    jp = jax.tree_util.tree_map(lambda x: np.array(x, copy=True),
                                jtf.init_params(jax.random.PRNGKey(seed),
                                                jcfg))
    rng = np.random.default_rng(seed + 1)
    for path, leaf in jax.tree_util.tree_flatten_with_path(jp)[0]:
        if "norm" in jax.tree_util.keystr(path):
            leaf[...] = 0.1 * rng.standard_normal(leaf.shape)
    return jp, interop.params_from_numpy(jp, "cpu")


def _tokens(cfg, b, s, seed):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (b, s)).astype(np.int32)


def _nest(flat):
    out = {}
    for path, v in flat.items():
        node = out
        *head, last = path.split("/")
        for k in head:
            node = node.setdefault(k, {})
        node[last] = v
    return out


# ----------------------------------------------------------------------
# the mixers' pieces
# ----------------------------------------------------------------------
@pytest.mark.parametrize("with_state", [False, True])
def test_causal_conv_matches_jax(with_state):
    x, w, b = _rand(1, 2, 5, 12), _rand(2, 4, 12), _rand(3, 12)
    state = _rand(4, 2, 3, 12) if with_state else None
    yj, sj = jssm._causal_conv(jnp.asarray(x), jnp.asarray(w),
                               jnp.asarray(b),
                               None if state is None else jnp.asarray(state))
    yt, st = tssm._causal_conv(
        torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(b),
        None if state is None else torch.from_numpy(state))
    np.testing.assert_allclose(_np(yt), np.asarray(yj), **MM)
    np.testing.assert_array_equal(_np(st), np.asarray(sj))


@pytest.mark.parametrize("c", [1, 2, 7, 16, 128])
def test_selective_scan_chunk_matches_jax(c):
    """One chunk of the scan at even, odd and power-of-two lengths, with
    decays in (0, 1) as exp(dt·A) gives them."""
    da = np.exp(-np.abs(_rand(1, 2, c, 6, 4))).astype(np.float32)
    dbx, h0 = _rand(2, 2, c, 6, 4), _rand(3, 2, 6, 4)
    hj, lj = jssm._selective_scan_chunk(jnp.asarray(h0), jnp.asarray(da),
                                        jnp.asarray(dbx))
    ht, lt = tssm._selective_scan_chunk(torch.from_numpy(h0),
                                        torch.from_numpy(da),
                                        torch.from_numpy(dbx))
    np.testing.assert_allclose(_np(ht), np.asarray(hj), **SCAN)
    np.testing.assert_allclose(_np(lt), np.asarray(lj), **SCAN)


def _mixer_case(mixer, chunk):
    """(jcfg, tcfg, spec, numpy params, port params, kwargs of the
    forward) with the mixer's chunk set to ``chunk``."""
    jcfg, tcfg = _cfgs(_ARCH_OF[mixer])
    kw = {}
    if mixer == "mlstm":
        x = dataclasses.replace(jcfg.xlstm, chunk=chunk)
        jcfg, tcfg = jcfg.with_(xlstm=x), tcfg.with_(
            xlstm=dataclasses.replace(tcfg.xlstm, chunk=chunk))
    elif mixer == "mamba":
        kw = {"chunk": chunk}
    jp, tp = _mixer_params(mixer, jcfg)
    return jcfg, tcfg, _spec(tcfg, mixer), jp, tp, kw


@pytest.mark.parametrize("mixer,chunk", [
    ("mamba", 128), ("mamba", 4), ("mlstm", 16), ("mlstm", 4),
    ("slstm", None)], ids=["mamba-one-chunk", "mamba-4-chunks",
                           "mlstm-one-chunk", "mlstm-4-chunks", "slstm"])
def test_mixer_forward_and_decode_match_jax(mixer, chunk):
    """The full-sequence path with its cache (one chunk and several),
    then 3 decode steps from that cache, outputs and states."""
    jcfg, tcfg, spec, jp, tp, kw = _mixer_case(mixer, chunk)
    x = _rand(5, 2, 16, jcfg.d_model)
    pos = np.arange(16, dtype=np.int32)
    yj, cj = _forward("jax", mixer)(jp, jnp.asarray(x), jcfg, spec,
                                    jnp.asarray(pos), return_cache=True,
                                    **kw)
    yt, ct = _forward("torch", mixer)(tp, torch.from_numpy(x), tcfg, spec,
                                      torch.from_numpy(pos),
                                      return_cache=True, **kw)
    np.testing.assert_allclose(_np(yt), np.asarray(yj), **MM)
    _assert_tree(ct, cj, **MM)
    np.testing.assert_allclose(
        _np(_forward("torch", mixer)(tp, torch.from_numpy(x), tcfg, spec,
                                     torch.from_numpy(pos), **kw)),
        np.asarray(yj), **MM)
    for i in range(3):
        xi = _rand(20 + i, 2, 1, jcfg.d_model)
        oj, cj = _decode("jax", mixer)(jp, jnp.asarray(xi), cj, 16 + i,
                                       jcfg, spec)
        ot, ct = _decode("torch", mixer)(tp, torch.from_numpy(xi), ct,
                                         16 + i, tcfg, spec)
        np.testing.assert_allclose(_np(ot), np.asarray(oj), **MM)
        _assert_tree(ct, cj, **MM)


def test_mlstm_scales_k_by_the_head_width_of_d_inner():
    """k is scaled by 1/√(d_inner / H) (dh = 64 here), not by the
    config's head_dim (16)."""
    _, tcfg = _cfgs("xlstm-125m")
    di, dh = tssm.mlstm_dims(tcfg)
    assert (di, dh) == (128, 64) and tcfg.head_dim == 16


@pytest.mark.parametrize("mixer", MIXERS)
def test_stacked_decode_with_active_matches_the_reference_merge(mixer):
    """Decode into row 1 of a 2-layer stacked cache with slot 1 of 3
    inactive: the written states are the reference's step merged per
    slot (``jnp.where(active, new, old)``, as its engine merges), every
    other row of the stack is untouched, the inactive slot's states are
    bit for bit as they were, and every slot's output is the
    reference's."""
    jcfg, tcfg, spec, jp, tp, _ = _mixer_case(mixer, 8)
    init = getattr(jssm, f"init_{mixer}_cache")
    one = jax.tree_util.tree_map(np.asarray,
                                 init(jcfg, spec, 3, 16, jnp.float32))
    stacked = {k: np.stack([_rand(30 + i, *v.shape, scale=0.5)
                            for i in range(2)]) for k, v in one.items()}
    if "m" in stacked:          # stabilizer states: around the floor
        stacked["m"] = stacked["m"] - 1.0
    x = _rand(6, 3, 1, jcfg.d_model)
    active = np.array([True, False, True])
    oj, new_j = _decode("jax", mixer)(
        jp, jnp.asarray(x), jax.tree_util.tree_map(jnp.asarray, stacked), 5,
        jcfg, spec, layer_idx=1)
    want = {k: np.array(v, copy=True) for k, v in stacked.items()}
    for k in want:
        mask = active.reshape((-1,) + (1,) * (want[k].ndim - 2))
        want[k][1] = np.where(mask, np.asarray(new_j[k])[1], stacked[k][1])
    ct = interop.params_from_numpy(stacked, "cpu")
    before = {k: v.clone() for k, v in ct.items()}
    ot, out_cache = _decode("torch", mixer)(
        tp, torch.from_numpy(x), ct, 5, tcfg, spec, layer_idx=1,
        active=torch.from_numpy(active))
    assert out_cache is ct                       # written in place
    np.testing.assert_allclose(_np(ot), np.asarray(oj), **MM)
    for k in want:
        np.testing.assert_allclose(_np(ct[k]), want[k], err_msg=k, **MM)
        assert torch.equal(ct[k][0], before[k][0]), k
        assert torch.equal(ct[k][1][1], before[k][1][1]), k
        assert not torch.equal(ct[k][1][0], before[k][1][0]), k


# ----------------------------------------------------------------------
# init and parameter counts
# ----------------------------------------------------------------------
@pytest.mark.parametrize("arch", ARCHS)
def test_init_params_shapes_and_scales_match_jax(arch):
    jcfg, tcfg = _cfgs(arch)
    jshapes = jax.eval_shape(
        lambda: jtf.init_params(jax.random.PRNGKey(0), jcfg))
    jp = flatten_params(jax.tree_util.tree_map(
        np.asarray, jtf.init_params(jax.random.PRNGKey(0), jcfg)))
    ours = flatten_params(ttf.init_params(torch.Generator().manual_seed(0),
                                          tcfg))
    assert {p: tuple(v.shape) for p, v in ours.items()} == \
        {p: tuple(v.shape) for p, v in flatten_params(jshapes).items()}
    for p, v in ours.items():
        leaf = p.rsplit("/", 1)[-1]
        if "/mixer/" not in p:
            continue
        if leaf in ("A_log", "dt_bias", "D", "conv_b", "bi", "bf", "b") \
                or "norm" in leaf:
            # the deterministic inits equal the reference's
            np.testing.assert_allclose(_np(v), jp[p], rtol=1e-6, err_msg=p)
        elif leaf == "r":
            # N(0, 1/dh) recurrent blocks
            dh = v.shape[-1]
            assert abs(float(v.std()) * np.sqrt(dh) - 1.0) < 0.1, p
        else:
            # dense_init: std 1/sqrt(fan_in)
            assert abs(float(v.std()) * np.sqrt(v.shape[-2]) - 1.0) < 0.15, p


@pytest.mark.parametrize("layout", ["scan", "unrolled"])
@pytest.mark.parametrize("arch", ARCHS)
def test_count_params_is_the_leaf_count(arch, layout):
    _, tcfg = _cfgs(arch)
    if layout == "unrolled":
        tcfg = tcfg.with_(pattern_reps=1)
    params = ttf.init_params(torch.Generator().manual_seed(0), tcfg)
    assert ttf.count_params(tcfg) == sum(
        v.numel() for v in flatten_params(params).values())


# ----------------------------------------------------------------------
# the models: forward, decode, prefill then decode
# ----------------------------------------------------------------------
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_hidden_and_caches_match_jax(arch):
    jcfg, tcfg = _cfgs(arch)
    jp, tp = _params(jcfg)
    toks = _tokens(jcfg, 2, 16, 1)
    hj, aj, cj = jtf.forward_hidden(jp, jnp.asarray(toks), jcfg,
                                    return_caches=True)
    ht, at, ct = ttf.forward_hidden(tp, torch.from_numpy(toks), tcfg,
                                    return_caches=True)
    np.testing.assert_allclose(_np(ht), np.asarray(hj), **MM)
    _assert_tree(ct, cj, states_at_scale=True, **MM)
    np.testing.assert_allclose(float(at), float(aj), rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(
        _np(ttf.prefill(tp, torch.from_numpy(toks), tcfg)),
        np.asarray(jtf.prefill(jp, jnp.asarray(toks), jcfg)), **MM)


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_step_matches_jax(arch):
    """One step from random states (m around the floor), per-slot
    positions."""
    jcfg, tcfg = _cfgs(arch)
    jp, tp = _params(jcfg)
    shapes = jax.tree_util.tree_map(lambda a: a.shape,
                                    jtf.init_cache(jcfg, 3, 12))
    leaves, treedef = jax.tree_util.tree_flatten(
        shapes, is_leaf=lambda x: isinstance(x, tuple))
    cache = jax.tree_util.tree_unflatten(
        treedef, [_rand(i, *s, scale=0.5) for i, s in enumerate(leaves)])
    toks = np.array([[5], [17], [200]], np.int32)
    pos = np.array([4, 0, 11], np.int32)
    lj, cj = jtf.decode_step(jp, jax.tree_util.tree_map(jnp.asarray, cache),
                             jnp.asarray(toks), jnp.asarray(pos), jcfg)
    lt, ct = ttf.decode_step(tp, interop.params_from_numpy(cache, "cpu"),
                             torch.from_numpy(toks), torch.from_numpy(pos),
                             tcfg)
    np.testing.assert_allclose(_np(lt), np.asarray(lj), **MM)
    _assert_tree(ct, cj, states_at_scale=True, **MM)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_then_decode_matches_jax(arch):
    """Prefill (24 tokens: 3 mLSTM chunks of 8, one Mamba chunk), the
    caches padded to decode capacity (recurrent ones pass through), 4
    decode steps against the reference; then the port's prefill against
    its own all-decode path from an empty cache (as
    ``tests/test_models.py`` checks jamba and xlstm), MoE at the no-drop
    capacity factor."""
    from repro.runtime.server import pad_caches_to as jpad
    from repro_torch.runtime.server import pad_caches_to as tpad
    jcfg, tcfg = _cfgs(arch, capacity_factor=8.0)
    jp, tp = _params(jcfg)
    b, s, extra = 2, 24, 4
    toks = _tokens(jcfg, b, s + extra, 2)
    prompt, cont = toks[:, :s], toks[:, s:]
    hj, _, cj = jtf.forward_hidden(jp, jnp.asarray(prompt), jcfg,
                                   return_caches=True)
    ht, _, ct = ttf.forward_hidden(tp, torch.from_numpy(prompt), tcfg,
                                   return_caches=True)
    cj, ct = jpad(cj, jcfg, s, s + extra), tpad(ct, tcfg, s, s + extra)
    _assert_tree(ct, cj, states_at_scale=True, **MM)
    lt_prefill = tlayers.unembed(tp["embed"], ht[:, -1:], tcfg)
    for i in range(extra):
        x = cont[:, i:i + 1]
        lj, cj = jtf.decode_step(jp, cj, jnp.asarray(x), jnp.int32(s + i),
                                 jcfg)
        lt, ct = ttf.decode_step(tp, ct, torch.from_numpy(x), s + i, tcfg)
        np.testing.assert_allclose(_np(lt), np.asarray(lj), **MM)
    _assert_tree(ct, cj, states_at_scale=True, **MM)

    cache = ttf.init_cache(tcfg, b, s + extra, device="cpu")
    for i in range(s):
        logits, cache = ttf.decode_step(
            tp, cache, torch.from_numpy(prompt[:, i:i + 1]), i, tcfg)
    np.testing.assert_allclose(_np(logits), _np(lt_prefill), **OWN)


@pytest.mark.parametrize("arch", ARCHS)
def test_pad_caches_to_passes_recurrent_caches_through(arch):
    """As the reference's ``tests/test_serving.py`` checks: recurrent
    states come out as they went in (the same tensors), attention caches
    grow to decode capacity."""
    from repro_torch.runtime.server import pad_caches_to
    _, tcfg = _cfgs(arch)
    _, tp = _params(_cfgs(arch)[0])
    _, _, caches = ttf.forward_hidden(
        tp, torch.from_numpy(_tokens(tcfg, 2, 8, 4)), tcfg,
        return_caches=True)
    out = pad_caches_to(caches, tcfg, 8, 20)
    for si, st in enumerate(ttf.plan_stages(tcfg)):
        for pi, spec in enumerate(st["specs"]):
            got = out[f"s{si}"][f"pos{pi}"]
            was = caches[f"s{si}"][f"pos{pi}"]
            for k, v in got.items():
                if spec.mixer == "attn":
                    assert v.shape[-3] == 20, k
                else:
                    assert v is was[k], k


# ----------------------------------------------------------------------
# serving: Server, ServingEngine, the engine's reset, the bridge
# ----------------------------------------------------------------------
def _trace(vocab, n=6, seed=1):
    rng = np.random.default_rng(seed)
    t, reqs = 0.0, []
    for i in range(n):
        t += float(rng.exponential(0.002))
        reqs.append((i, rng.integers(1, vocab, size=int(rng.integers(3, 21)))
                     .astype(np.int32), int(rng.integers(3, 9)), t))
    return reqs


def _unrolled(arch, **kw):
    """Both packages' reduced config with its repetitions unrolled."""
    return tuple(c.with_(pattern=c.pattern * c.pattern_reps, pattern_reps=1)
                 for c in _cfgs(arch, **kw))


def _restack_to_unrolled(params, cfg):
    """A stacked stage's params as the unrolled model's: block ``pos{i}``
    of repetition r becomes ``pos{r·len(pattern) + i}``."""
    (st,) = ttf.plan_stages(cfg)
    n = len(st["specs"])
    out = {k: v for k, v in params.items() if k != "stages"}
    out["stages"] = {"s0": {
        f"pos{r * n + i}": ttf._rep(params["stages"]["s0"][f"pos{i}"], r)
        for r in range(st["reps"]) for i in range(n)}}
    return out


@pytest.mark.parametrize("arch", ARCHS)
def test_generate_and_engine_match_jax(arch):
    """Greedy tokens of ``Server.generate`` (16-token prompts) and of a
    mixed-length ``ServingEngine`` trace (3 slots, 6 requests: slots are
    reused, so their recurrent states must be reset on admission)."""
    from repro.runtime import server as jserver
    from repro_torch.runtime import server as tserver
    jcfg, tcfg = _cfgs(arch)
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

    reqs = _trace(jcfg.vocab_size)
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


def test_stacked_empty_cache_holds_the_mixers_initial_states():
    """The reference's ``init_cache`` stacks zeros for a stacked stage, so
    xlstm's m starts (and its engine's reset puts it back) at 0 there,
    where its mixers' own cache-init and its prefill start at −30. The
    port stacks each mixer's initial state: its stacked empty cache is
    the unrolled one's, row for row, and a decode step from it equals the
    unrolled model's. The stabilized states are invariant to m's start
    in exact arithmetic, so the reference's step from its zeros agrees
    with the port's within rtol 1e-5 / atol 2e-5."""
    jcfg, tcfg = _cfgs("xlstm-125m")
    _, ucfg = _unrolled("xlstm-125m")
    jc = flatten_params(jax.tree_util.tree_map(
        np.asarray, jtf.init_cache(jcfg, 2, 8)))
    tc = flatten_params(ttf.init_cache(tcfg, 2, 8, device="cpu"))
    uc = flatten_params(ttf.init_cache(ucfg, 2, 8, device="cpu"))
    assert float(np.abs(jc["s0/pos0/m"]).max()) == 0.0
    for k, v in tc.items():
        _, pos, leaf = k.split("/")
        i = int(pos[3:])
        for r in range(2):
            assert torch.equal(v[r], uc[f"s0/pos{6 * r + i}/{leaf}"]), k
    assert float(tc["s0/pos0/m"].max()) == tssm.M_FLOOR

    jp, tp = _params(jcfg)
    up = _restack_to_unrolled(tp, tcfg)
    tok = np.array([[7], [100]], np.int32)
    lt, _ = ttf.decode_step(tp, ttf.init_cache(tcfg, 2, 8, device="cpu"),
                            torch.from_numpy(tok), 0, tcfg)
    lu, _ = ttf.decode_step(up, ttf.init_cache(ucfg, 2, 8, device="cpu"),
                            torch.from_numpy(tok), 0, ucfg)
    np.testing.assert_allclose(_np(lt), _np(lu), **MM)
    lj, _ = jtf.decode_step(jp, jtf.init_cache(jcfg, 2, 8),
                            jnp.asarray(tok), 0, jcfg)
    np.testing.assert_allclose(_np(lt), np.asarray(lj), **MM)


def test_unrolled_xlstm_engine_serves_where_the_reference_raises():
    """The reference's ``init_slstm_cache`` hands one zeros array out as
    c, n and h; in an unrolled stage those are three leaves of the cache
    that its engine's jitted programs donate, and XLA refuses to donate a
    buffer twice (a reference fault, ROADMAP §3). The port's engine
    serves the unrolled xlstm (as ``chip_smoke.py`` path L1 does) with the
    tokens of the stacked layout on the same weights."""
    from repro.runtime import server as jserver
    from repro_torch.runtime import server as tserver
    jcfg, tcfg = _cfgs("xlstm-125m")
    jucfg, ucfg = _unrolled("xlstm-125m")
    reqs = _trace(tcfg.vocab_size)
    jp = jtf.init_params(jax.random.PRNGKey(0), jucfg)
    with pytest.raises(Exception, match="donate the same buffer twice"):
        jserver.ServingEngine(jucfg, jp, slots=3, max_len=32,
                              prefill_chunk=4).run(
            [jserver.Request(*r) for r in reqs])
    _, tp = _params(jcfg)
    kw = dict(slots=3, max_len=32, prefill_chunk=4, device="cpu")
    got = tserver.ServingEngine(ucfg, _restack_to_unrolled(tp, tcfg),
                                **kw).run([tserver.Request(*r) for r in reqs])
    want = tserver.ServingEngine(tcfg, tp, **kw).run(
        [tserver.Request(*r) for r in reqs])
    assert len(got["finished"]) == len(reqs)
    assert ({f.id: f.tokens.tolist() for f in got["finished"]}
            == {f.id: f.tokens.tolist() for f in want["finished"]})


def test_engine_reset_restores_the_recurrent_states():
    """A slot that served a finished request, admitted again: right after
    its reset every recurrent leaf holds ``init_cache``'s values (m at
    −30; C, n, c, h and the conv taps zero) where it held the last
    request's (its m was off the floor), while the other slots keep
    theirs bit for bit."""
    from repro_torch.runtime import server as tserver
    _, tcfg = _cfgs("xlstm-125m")
    _, tp = _params(_cfgs("xlstm-125m")[0])
    slots = 3
    eng = tserver.ServingEngine(tcfg, tp, slots=slots, max_len=32,
                                prefill_chunk=4, device="cpu")
    fresh = flatten_params(ttf.init_cache(tcfg, slots, 32, device="cpu"))
    axes = flatten_params(ttf.cache_axes(tcfg))

    def row(leaf, k, slot):
        return leaf.select(axes[k].index("batch"), slot)

    admitted, checked = [0] * slots, []
    reset = eng._reset

    def watched(cache, mask):
        before = {k: v.clone() for k, v in flatten_params(cache).items()}
        out = reset(cache, mask)
        flat = flatten_params(out)
        for slot in range(slots):
            if not mask[slot]:
                for k, v in flat.items():
                    assert torch.equal(row(v, k, slot),
                                       row(before[k], k, slot)), k
                continue
            admitted[slot] += 1
            if admitted[slot] < 2:
                continue
            for k, v in flat.items():
                assert torch.equal(row(v, k, slot), row(fresh[k], k, slot)), k
                if k.endswith("/m"):
                    assert not torch.equal(row(before[k], k, slot),
                                           row(fresh[k], k, slot)), k
            checked.append(slot)
        return out

    eng._reset = watched
    reqs = [tserver.Request(0, np.arange(1, 9, dtype=np.int32), 3, 0.0),
            tserver.Request(1, np.arange(3, 23, dtype=np.int32), 8, 0.0),
            tserver.Request(2, np.arange(2, 30, dtype=np.int32), 3, 0.0),
            tserver.Request(3, np.arange(5, 11, dtype=np.int32), 4, 0.0)]
    out = eng.run(reqs)
    assert len(out["finished"]) == 4 and checked == [0]
    m = fresh["s0/pos0/m"]
    assert float(m.min()) == float(m.max()) == tssm.M_FLOOR


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_form_leaves_the_read_leaves_dense_and_serves(arch):
    """``launch/serve.py --form quant4``'s selection: every 2-D leaf but
    conv_w and A_log (which the mixers read as they are). The reference's
    ``compress_for_form`` selects them too, and its own model then raises
    on the weight form (ROADMAP §3). The port's bridged model serves with
    greedy tokens equal to the reference's on the densified tree of the
    same LC state."""
    from repro.launch import serve as jserve
    from repro.runtime import server as jserver
    from repro_torch.launch import serve as tserve
    from repro_torch.runtime import compressed as tforms
    from repro_torch.runtime import server as tserver
    jcfg, tcfg = _cfgs(arch, pattern_reps=1)
    jp = jtf.init_params(jax.random.PRNGKey(0), jcfg)
    prompts = np.random.default_rng(0).integers(
        1, jcfg.vocab_size, (2, 16)).astype(np.int32)
    j_serving = jserve.compress_for_form(jcfg, jp, "quant4")
    with pytest.raises(AttributeError, match="astype"):
        jserver.Server(jcfg, j_serving, max_len=32).generate(
            jnp.asarray(prompts), 4)

    tp = interop.params_from_numpy(jax.tree_util.tree_map(np.asarray, jp),
                                   "cpu")
    t_serving = tserve.compress_for_form(tcfg, tp, "quant4", "cpu")
    flat = flatten_params(t_serving)
    forms = {p for p, v in flat.items()
             if isinstance(v, tforms.QuantizedWeight)}
    two_d = {p for p, v in flatten_params(tp).items() if v.ndim == 2}
    assert forms == {p for p in two_d
                     if p.rsplit("/", 1)[-1] not in ("conv_w", "A_log")}
    assert all(isinstance(flat[p], torch.Tensor) for p in two_d - forms)
    # the densified tree of the bridged weights, in the reference
    dense = jax.tree_util.tree_map(np.asarray, jp)
    flat_dense = flatten_params(dense)
    for p in forms:
        flat_dense[p] = _np(tlayers.wload(flat[p], torch.float32))
    j_dense = jax.tree_util.tree_map(jnp.asarray, _nest(flat_dense))
    want = jserver.Server(jcfg, j_dense, max_len=32).generate(
        jnp.asarray(prompts), 8)
    got = tserver.Server(tcfg, t_serving, max_len=32, device="cpu") \
        .generate(prompts, 8)
    np.testing.assert_array_equal(got.tokens, want.tokens)
