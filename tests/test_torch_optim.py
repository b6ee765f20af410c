"""The port's optimizers and schedules against the JAX package, on the same
numpy trees.

Tolerances: rtol 1e-6 (atol 1e-7) for the optimizer updates, the global
norm and the clip — the same elementwise formulas, with XLA and PyTorch
free to fuse and order a reduction differently; the schedules equal, the
cosine one (float32 transcendental) to rtol 1e-6.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim import (AdamW as JAdamW, SGDM as JSGDM,
                         clip_by_global_norm as jclip,
                         global_norm as jnorm, schedules as jsched)
from repro_torch import interop
from repro_torch.optim import (AdamW, SGDM, clip_by_global_norm,
                               global_norm, schedules)
from torch_threads import _one_torch_thread  # noqa: F401


TOL = dict(rtol=1e-6, atol=1e-7)


def _tree(seed, scale=1.0):
    rng = np.random.default_rng(seed)
    return {"a": {"w": (scale * rng.standard_normal((6, 5))).astype(
                      np.float32),
                  "b": (scale * rng.standard_normal((5,))).astype(
                      np.float32)},
            "s": (scale * rng.standard_normal((3, 4, 2))).astype(np.float32)}


def _t(tree):
    return interop.params_from_numpy(tree, "cpu")


def _j(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def _close(ours, theirs, **tol):
    lo = jax.tree_util.tree_leaves(interop.to_numpy(ours))
    lt = jax.tree_util.tree_leaves(jax.tree_util.tree_map(np.asarray,
                                                          theirs))
    assert len(lo) == len(lt)
    for a, b in zip(lo, lt):
        np.testing.assert_allclose(a, b, **(tol or TOL))


@pytest.mark.parametrize("kw", [{}, {"weight_decay": 0.1, "b2": 0.999}])
def test_adamw_matches_reference_over_steps(kw):
    params, opt_t, opt_j = _tree(0), AdamW(**kw), JAdamW(**kw)
    tp, jp = _t(params), _j(params)
    ts, js = opt_t.init(tp), opt_j.init(jp)
    _close(ts, js)
    for i in range(3):
        g = _tree(10 + i, scale=0.1)
        tp, ts = opt_t.update(_t(g), ts, tp, 1e-2)
        jp, js = opt_j.update(_j(g), js, jp, 1e-2)
        _close(tp, jp)
        _close({"m": ts["m"], "v": ts["v"]}, {"m": js["m"], "v": js["v"]})
        assert int(ts["step"]) == int(js["step"]) == i + 1
        assert ts["step"].dtype == torch.int32


@pytest.mark.parametrize("nesterov", [True, False])
def test_sgdm_matches_reference(nesterov):
    params = _tree(1)
    opt_t, opt_j = SGDM(nesterov=nesterov), JSGDM(nesterov=nesterov)
    tp, jp = _t(params), _j(params)
    ts, js = opt_t.init(tp), opt_j.init(jp)
    for i in range(3):
        g = _tree(20 + i, scale=0.1)
        tp, ts = opt_t.update(_t(g), ts, tp, 0.05)
        jp, js = opt_j.update(_j(g), js, jp, 0.05)
        _close(tp, jp)
        _close(ts["mom"], js["mom"])
    assert int(ts["step"]) == int(js["step"]) == 3


def test_update_leaves_its_inputs_as_they_were():
    params, grads = _t(_tree(2)), _t(_tree(3))
    opt = AdamW(weight_decay=0.1)
    state = opt.init(params)
    before = interop.to_numpy((params, state))
    opt.update(grads, state, params, 1e-2)
    after = interop.to_numpy((params, state))
    for a, b in zip(jax.tree_util.tree_leaves(before),
                    jax.tree_util.tree_leaves(after)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("max_norm", [0.5, 1e3])
def test_global_norm_and_clip_match_reference(max_norm):
    tree = _tree(4)
    np.testing.assert_allclose(float(global_norm(_t(tree))),
                               float(jnorm(_j(tree))), **TOL)
    tc, tn = clip_by_global_norm(_t(tree), max_norm)
    jc, jn = jclip(_j(tree), max_norm)
    np.testing.assert_allclose(float(tn), float(jn), **TOL)
    _close(tc, jc)


def test_schedules_equal_reference():
    assert schedules.constant(3e-4)(17) == jsched.constant(3e-4)(17)
    assert [schedules.lstep_decay(0.1)(k) for k in range(5)] == \
        [jsched.lstep_decay(0.1)(k) for k in range(5)]
    assert schedules.mu_exponential(9e-5, 1.2, 6) == \
        jsched.mu_exponential(9e-5, 1.2, 6)
    ours = schedules.cosine_warmup(1e-3, 10, 100, floor=0.1)
    theirs = jsched.cosine_warmup(1e-3, 10, 100, floor=0.1)
    for step in (0, 3, 10, 55, 100, 140):
        np.testing.assert_allclose(float(ours(step)), float(theirs(step)),
                                   rtol=1e-6)
    np.testing.assert_allclose(
        float(ours(torch.tensor(55, dtype=torch.int32))),
        float(theirs(jnp.int32(55))), rtol=1e-6)
