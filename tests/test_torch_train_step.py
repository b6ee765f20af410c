"""The port's training loss, gradients and LC train step against the JAX
package, on reduced float32 phi3-mini (2 layers) with the same weights
(the JAX ``init_params`` carried over as numpy) and the same batches.

Tolerances: the loss (``chunked_ce_loss``, ``loss_fn``) rtol 1e-5 —
matrix products and a log-sum-exp summed in other orders; gradients
against ``jax.grad`` rtol 1e-4 / atol 1e-6 (a backward pass compounds
those orders); one ``make_train_step`` step (penalty, clip, AdamW): the
metrics rtol 1e-5, the first moments as the gradients, the new params
rtol 1e-5 / atol 1e-5 — AdamW's first step moves a weight by
lr·g/(|g| + eps), which for a gradient within a few eps of 0 turns the
gradient's absolute error into up to lr of step, so the atol is 1% of
lr = 1e-3. Remat on and off must give the same gradients bit for bit.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.launch import steps as jsteps
from repro.models import transformer as jtf
from repro.optim import AdamW as JAdamW
from repro_torch import configs as tconfigs
from repro_torch import interop
from repro_torch.core import flatten_params
from repro_torch.launch import steps as tsteps
from repro_torch.models import transformer as ttf
from repro_torch.optim import AdamW

LOSS = dict(rtol=1e-5, atol=0.0)
GRAD = dict(rtol=1e-4, atol=1e-6)
STEP = dict(rtol=1e-5, atol=1e-7)
PARAMS = dict(rtol=1e-5, atol=1e-5)
B, S = 2, 16


def _cfgs(**kw):
    """The same reduced float32 phi3-mini in both packages."""
    arch = "phi3-mini-3.8b"
    j = dataclasses.replace(jconfigs.reduced_config(jconfigs.get_config(arch)),
                            dtype="float32", **kw)
    t = dataclasses.replace(tconfigs.reduced_config(tconfigs.get_config(arch)),
                            dtype="float32", **kw)
    return j, t


def _np_tree(tree):
    return jax.tree_util.tree_map(lambda x: np.array(x, copy=True), tree)


def _params(jcfg, seed=0):
    jp = _np_tree(jtf.init_params(jax.random.PRNGKey(seed), jcfg))
    rng = np.random.default_rng(seed + 1)
    # non-zero norm scales so the (1 + scale) paths carry gradient
    flat = jax.tree_util.tree_flatten_with_path(jp)[0]
    for path, leaf in flat:
        if "norm" in jax.tree_util.keystr(path):
            leaf[...] = 0.1 * rng.standard_normal(leaf.shape)
    return jp, interop.params_from_numpy(jp, "cpu")


def _batch(cfg, seed=3, mask=False):
    rng = np.random.default_rng(seed)
    b = {"inputs": rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32),
         "labels": rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)}
    if mask:
        b["mask"] = (rng.random((B, S)) > 0.3).astype(np.float32)
    return b


def _tb(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _assert_tree(ours, theirs, **tol):
    fo = flatten_params(interop.to_numpy(ours))
    ft = flatten_params(_np_tree(theirs))
    assert set(fo) == set(ft)
    for k in ft:
        np.testing.assert_allclose(fo[k], ft[k], err_msg=k, **tol)


# ----------------------------------------------------------------------
# loss
# ----------------------------------------------------------------------
@pytest.mark.parametrize("chunk,mask", [(4, False), (8, True), (512, False)])
def test_chunked_ce_loss_matches_reference(chunk, mask):
    jcfg, tcfg = _cfgs()
    jp, tp = _params(jcfg)
    batch = _batch(jcfg, mask=mask)
    hidden = np.random.default_rng(5).standard_normal(
        (B, S, jcfg.d_model)).astype(np.float32)
    m = batch.get("mask")
    theirs = jtf.chunked_ce_loss(jp, jnp.asarray(hidden),
                                 jnp.asarray(batch["labels"]), jcfg,
                                 chunk=chunk,
                                 mask=None if m is None else jnp.asarray(m))
    with torch.no_grad():
        ours = ttf.chunked_ce_loss(tp, torch.from_numpy(hidden),
                                   torch.from_numpy(batch["labels"]), tcfg,
                                   chunk=chunk,
                                   mask=None if m is None
                                   else torch.from_numpy(m))
    np.testing.assert_allclose(float(ours), float(theirs), **LOSS)


def test_loss_fn_matches_reference():
    jcfg, tcfg = _cfgs()
    jp, tp = _params(jcfg)
    batch = _batch(jcfg)
    jl, jm = jtf.loss_fn(jp, jax.tree_util.tree_map(jnp.asarray, batch),
                         jcfg)
    with torch.no_grad():
        tl, tm = ttf.loss_fn(tp, _tb(batch), tcfg)
    np.testing.assert_allclose(float(tl), float(jl), **LOSS)
    np.testing.assert_allclose(float(tm["ce"]), float(jm["ce"]), **LOSS)
    assert float(tm["aux"]) == float(jm["aux"]) == 0.0


def _torch_grads(tp, batch, cfg):
    leaves = {k: v.detach().requires_grad_(True)
              for k, v in flatten_params(tp).items()}
    params = _nest(leaves)
    loss, _ = ttf.loss_fn(params, _tb(batch), cfg)
    grads = torch.autograd.grad(loss, list(leaves.values()))
    return _nest(dict(zip(leaves, grads)))


def _nest(flat):
    out = {}
    for path, v in flat.items():
        node = out
        *head, last = path.split("/")
        for k in head:
            node = node.setdefault(k, {})
        node[last] = v
    return out


@pytest.mark.parametrize("layout", ["scan", "unrolled"])
def test_gradients_match_jax_grad(layout):
    kw = {} if layout == "scan" else {"pattern_reps": 1}
    jcfg, tcfg = _cfgs(**kw)
    jp, tp = _params(jcfg)
    batch = _batch(jcfg)
    jb = jax.tree_util.tree_map(jnp.asarray, batch)
    jg = jax.grad(lambda p: jtf.loss_fn(p, jb, jcfg)[0])(
        jax.tree_util.tree_map(jnp.asarray, jp))
    _assert_tree(_torch_grads(tp, batch, tcfg), jg, **GRAD)


@pytest.mark.parametrize("layout", ["scan", "unrolled"])
def test_remat_on_and_off_give_identical_gradients(layout):
    kw = {} if layout == "scan" else {"pattern_reps": 1}
    _, t_on = _cfgs(remat=True, **kw)
    _, t_off = _cfgs(remat=False, **kw)
    jcfg, _ = _cfgs(**kw)
    _, tp = _params(jcfg)
    batch = _batch(jcfg)
    g_on = flatten_params(_torch_grads(tp, batch, t_on))
    g_off = flatten_params(_torch_grads(tp, batch, t_off))
    for k in g_on:
        assert torch.equal(g_on[k], g_off[k]), k


# ----------------------------------------------------------------------
# the LC train step
# ----------------------------------------------------------------------
def _lc_state(jcfg, seed=0):
    """The reference's train state with non-trivial LC refs: a = w +
    noise, λ random, μ = 0.5, so the penalty moves the step."""
    st = _np_tree(jsteps.init_train_state(jax.random.PRNGKey(seed), jcfg,
                                          JAdamW()))
    rng = np.random.default_rng(seed + 7)
    for p in st["lc"]["a"]:
        a = st["lc"]["a"][p]
        st["lc"]["a"][p] = (a + 0.01 * rng.standard_normal(a.shape)
                            ).astype(np.float32)
        st["lc"]["lam"][p] = (0.01 * rng.standard_normal(a.shape)
                              ).astype(np.float32)
    st["lc"]["mu"] = np.float32(0.5)
    return st


@pytest.mark.parametrize("clip_norm", [0.05, 1e3])
def test_train_step_matches_reference(clip_norm):
    jcfg, tcfg = _cfgs()
    st = _lc_state(jcfg)
    batch = _batch(jcfg)
    jstep = jax.jit(jsteps.make_train_step(jcfg, JAdamW(), lr=1e-3,
                                           clip_norm=clip_norm))
    j_new, j_met = jstep(jax.tree_util.tree_map(jnp.asarray, st),
                         jax.tree_util.tree_map(jnp.asarray, batch))
    tstep = tsteps.make_train_step(tcfg, AdamW(), lr=1e-3,
                                   clip_norm=clip_norm)
    t_state = interop.train_state_from_numpy(st, "cpu")
    before = interop.train_state_to_numpy(t_state)
    t_new, t_met = tstep(t_state, _tb(batch))
    for k in ("loss", "ce", "lc_penalty", "grad_norm"):
        np.testing.assert_allclose(float(t_met[k]), float(j_met[k]),
                                   err_msg=k, **STEP)
    assert float(t_met["lc_penalty"]) > 0.0
    _assert_tree(t_new["params"], j_new["params"], **PARAMS)
    _assert_tree(t_new["opt"]["m"], j_new["opt"]["m"], **GRAD)
    assert int(t_new["step"]) == int(j_new["step"]) == 1
    assert t_new["step"].dtype == torch.int32
    # functional: the state handed in is left as it was
    after = interop.train_state_to_numpy(t_state)
    for a, b in zip(jax.tree_util.tree_leaves(before),
                    jax.tree_util.tree_leaves(after)):
        np.testing.assert_array_equal(a, b)


def test_lc_penalty_from_refs_is_differentiable():
    jcfg, _ = _cfgs()
    st = interop.train_state_from_numpy(_lc_state(jcfg), "cpu")
    p = "stages/s0/pos0/ffn/w_up"
    w = st["params"]["stages"]["s0"]["pos0"]["ffn"]["w_up"] \
        .detach().requires_grad_(True)
    params = {"stages": {"s0": {"pos0": {"ffn": {"w_up": w}}}}}
    lc = st["lc"]
    pen = tsteps.lc_penalty_from_refs(params, {p: lc["a"][p]},
                                      {p: lc["lam"][p]}, lc["mu"])
    (g,) = torch.autograd.grad(pen, [w])
    # ∂/∂w μ/2‖w − a − λ/μ‖² = μ(w − a) − λ
    want = lc["mu"] * (w.detach() - lc["a"][p]) - lc["lam"][p]
    torch.testing.assert_close(g, want, rtol=1e-5, atol=1e-7)


def test_stable_lc_refs_keeps_layout_and_mu():
    old = {"a": {"x": torch.zeros(3)}, "lam": {"x": torch.zeros(3)},
           "mu": torch.tensor(0.25)}
    new = {"a": {"x": torch.ones(3, dtype=torch.float64)},
           "lam": {"x": torch.full((3,), 2.0)}, "mu": torch.tensor(9.0)}
    out = tsteps.stable_lc_refs(new, old)
    assert out["a"]["x"].dtype == torch.float32
    assert torch.equal(out["lam"]["x"], new["lam"]["x"])
    assert out["mu"] is old["mu"]


def test_fused_attention_under_autograd_raises():
    """The flash kernel has no backward: training through it is refused
    (on every device), and the plain path trains."""
    jcfg, tcfg = _cfgs(fused_attention=True)
    _, tp = _params(jcfg)
    with pytest.raises(NotImplementedError, match="fused_attention=False"):
        _torch_grads(tp, _batch(jcfg), tcfg)
    with torch.no_grad():   # forward-only use (serving) still runs it
        loss, _ = ttf.loss_fn(tp, _tb(_batch(jcfg)), tcfg)
    assert np.isfinite(float(loss))


def test_serve_and_prefill_steps_match_the_model():
    jcfg, tcfg = _cfgs()
    _, tp = _params(jcfg)
    toks = torch.from_numpy(_batch(jcfg)["inputs"])
    with torch.no_grad():
        logits = tsteps.make_prefill_step(tcfg)(tp, toks)
        want = ttf.prefill(tp, toks, tcfg)
        assert torch.equal(logits, want)
        cache = ttf.init_cache(tcfg, B, S, device="cpu")
        out, _ = tsteps.make_serve_step(tcfg)(tp, cache, toks[:, :1], 0)
        assert out.shape == (B, 1, tcfg.vocab_size)
