"""Training of the port's recurrent models (reduced float32
jamba-v0.1-52b and xlstm-125m) against the JAX package: the loss and
every leaf's gradient, remat, one train step; the CLIs and the xLSTM LM
example on the CPU; the default tasks' selection; ℓ0 on Mamba's tied
``A_log``. The mixers, forward, decode and serving are in
``tests/test_torch_ssm.py``.

Tolerances: the loss rtol 1e-5; gradients rtol 1e-4 / atol 1e-6 and one
train step as ``tests/test_torch_moe.py`` holds them, and gradients
and the AdamW moments made of them also normwise: a leaf's atol is at
least rtol · max|leaf| (2·rtol for v, the squared gradients). The
embedding's gradient sums every position's backward path through all
12 xlstm blocks, and its smallest entries (~4e-5, under the largest
0.06) carry the ~1e-5 normwise gap of that chain at a relative 1e-3;
the largest normwise gap of any leaf is 3.8e-5 (xlstm's bi) against the
1e-4 allowed.
"""
from pathlib import Path

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

GRAD = dict(rtol=1e-4, atol=1e-6)
PARAMS = dict(rtol=1e-5, atol=1e-5)
ARCHS = ["jamba-v0.1-52b", "xlstm-125m"]


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def _cfgs(arch, **kw):
    """The same reduced float32 config in both packages."""
    return tuple(mod.reduced_config(mod.get_config(arch)).with_(
        dtype="float32", **kw) for mod in (jconfigs, tconfigs))


def _params(jcfg, seed=0):
    jp = jax.tree_util.tree_map(lambda x: np.array(x, copy=True),
                                jtf.init_params(jax.random.PRNGKey(seed),
                                                jcfg))
    rng = np.random.default_rng(seed + 1)
    for path, leaf in jax.tree_util.tree_flatten_with_path(jp)[0]:
        if "norm" in jax.tree_util.keystr(path):
            leaf[...] = 0.1 * rng.standard_normal(leaf.shape)
    return jp, interop.params_from_numpy(jp, "cpu")


def _assert_tree(ours, theirs, normwise=0.0, **tol):
    """Leaf by leaf at ``tol``, every leaf's atol at least ``normwise`` ·
    max|leaf|."""
    fo = flatten_params(interop.to_numpy(ours))
    ft = flatten_params(jax.tree_util.tree_map(np.asarray, theirs))
    assert set(fo) == set(ft)
    for k in ft:
        t = dict(tol)
        scale = float(np.abs(ft[k]).max()) if ft[k].size else 0.0
        t["atol"] = max(t["atol"], normwise * scale)
        np.testing.assert_allclose(fo[k], ft[k], err_msg=k, **t)


def _batch(cfg, b=2, s=16, seed=3):
    rng = np.random.default_rng(seed)
    return {k: rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)
            for k in ("inputs", "labels")}


def _nest(flat):
    out = {}
    for path, v in flat.items():
        node = out
        *head, last = path.split("/")
        for k in head:
            node = node.setdefault(k, {})
        node[last] = v
    return out


def _grads(tp, batch, tcfg):
    leaves = {k: v.detach().requires_grad_(True)
              for k, v in flatten_params(tp).items()}
    loss, _ = ttf.loss_fn(_nest(leaves), {k: torch.from_numpy(v)
                                          for k, v in batch.items()}, tcfg)
    return loss, dict(zip(leaves, torch.autograd.grad(
        loss, list(leaves.values()))))


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_gradients_match_jax(arch):
    """Through the chunked scans and the sLSTM loop; the loss and every
    leaf's gradient (A_log, conv_w and the recurrent r included)."""
    jcfg, tcfg = _cfgs(arch)
    jp, tp = _params(jcfg)
    batch = _batch(jcfg)
    jb = jax.tree_util.tree_map(jnp.asarray, batch)
    jl, jm = jtf.loss_fn(jp, jb, jcfg)
    jg = jax.grad(lambda p: jtf.loss_fn(p, jb, jcfg)[0])(
        jax.tree_util.tree_map(jnp.asarray, jp))
    loss, grads = _grads(tp, batch, tcfg)
    np.testing.assert_allclose(float(loss.detach()), float(jl), rtol=1e-5)
    _assert_tree(_nest(grads), jg, normwise=GRAD["rtol"], **GRAD)
    for name in {"mamba": ("A_log", "conv_w", "x_proj"),
                 "xlstm": ("r", "wf", "conv_w")}[arch.split("-")[0]
                                                 .replace("jamba", "mamba")]:
        got = [g for p, g in grads.items() if p.endswith(f"mixer/{name}")]
        assert got and all(float(g.abs().max()) > 0 for g in got), name


@pytest.mark.parametrize("arch", ARCHS)
def test_remat_checkpoints_chunks_with_the_same_gradients(arch):
    """``cfg.remat`` (blocks and each Mamba / mLSTM chunk recomputed in
    the backward pass) gives the same loss and gradients bit for bit."""
    _, tcfg = _cfgs(arch)
    _, tp = _params(_cfgs(arch)[0])
    batch = _batch(tcfg)
    loss0, g0 = _grads(tp, batch, tcfg.with_(remat=False))
    loss1, g1 = _grads(tp, batch, tcfg.with_(remat=True))
    assert float(loss0.detach()) == float(loss1.detach())
    for k in g0:
        assert torch.equal(g0[k], g1[k]), k


@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_matches_jax(arch):
    """One ``make_train_step`` step (LC penalty on every ≥ 2-D leaf, A_log
    and conv_w included; clip; AdamW at eps 1e-6, where no weight's
    first step is steep in its gradient): metrics, params, moments."""
    jcfg, tcfg = _cfgs(arch)
    st = jax.tree_util.tree_map(
        lambda x: np.array(x, copy=True),
        jsteps.init_train_state(jax.random.PRNGKey(0), jcfg, JAdamW()))
    rng = np.random.default_rng(7)
    for p in st["lc"]["a"]:
        a = st["lc"]["a"][p]
        st["lc"]["a"][p] = (a + 0.01 * rng.standard_normal(a.shape)
                            ).astype(np.float32)
        st["lc"]["lam"][p] = (0.01 * rng.standard_normal(a.shape)
                              ).astype(np.float32)
    st["lc"]["mu"] = np.float32(0.5)
    assert any(p.endswith("A_log") or p.endswith("mixer/r")
               for p in st["lc"]["a"])
    batch = _batch(jcfg)
    eps, lr = 1e-6, 1e-3
    jstep = jax.jit(jsteps.make_train_step(jcfg, JAdamW(eps=eps), lr=lr))
    j_new, j_met = jstep(jax.tree_util.tree_map(jnp.asarray, st),
                         jax.tree_util.tree_map(jnp.asarray, batch))
    tstep = tsteps.make_train_step(tcfg, AdamW(eps=eps), lr=lr)
    t_new, t_met = tstep(interop.train_state_from_numpy(st, "cpu"),
                         {k: torch.from_numpy(v) for k, v in batch.items()})
    for k in ("loss", "ce", "lc_penalty", "grad_norm"):
        np.testing.assert_allclose(float(t_met[k]), float(j_met[k]),
                                   err_msg=k, rtol=1e-5, atol=1e-7)
    _assert_tree(t_new["opt"]["m"], j_new["opt"]["m"],
                 normwise=GRAD["rtol"], **GRAD)
    _assert_tree(t_new["opt"]["v"], j_new["opt"]["v"], rtol=1e-4,
                 atol=1e-10, normwise=2 * GRAD["rtol"])
    # a weight's first step is lr·g/(|g| + eps): below |g| = eps it is
    # lr·g/eps, which carries the gradients' gap (held normwise above) at
    # lr/eps. Those weights must be under 1% of each leaf, move by at
    # most lr, and move the reference's way wherever |g| is 10× their
    # gap; the rest are held at rtol 1e-5 / atol 1e-5
    pt = flatten_params(interop.to_numpy(t_new["params"]))
    pj = flatten_params(jax.tree_util.tree_map(np.asarray,
                                               j_new["params"]))
    p0 = flatten_params(st["params"])
    mj = flatten_params(jax.tree_util.tree_map(np.asarray,
                                               j_new["opt"]["m"]))
    mt = flatten_params(interop.to_numpy(t_new["opt"]["m"]))
    assert set(pt) == set(pj)
    for k in pj:
        g, g_t = mj[k] / 0.1, mt[k] / 0.1          # m = (1 − β1)·g
        steep = np.abs(g) < eps
        assert steep.mean() < 0.01, k
        np.testing.assert_allclose(pt[k][~steep], pj[k][~steep],
                                   err_msg=k, **PARAMS)
        step_t, step_j = (pt[k] - p0[k])[steep], (pj[k] - p0[k])[steep]
        assert np.all(np.abs(step_t) <= lr * (1 + 1e-5)), k
        signed = np.abs(g[steep]) > 10 * np.abs(g_t - g)[steep]
        assert np.all(np.sign(step_t[signed]) == np.sign(step_j[signed])), k


# ----------------------------------------------------------------------
# the CLIs and the training example
# ----------------------------------------------------------------------
@pytest.mark.parametrize("arch", ARCHS)
def test_serve_cli_runs_the_engine_on_the_cpu(arch):
    from repro_torch.launch import serve as tserve
    out = tserve.main(["--arch", arch, "--reduced", "--prompt-len", "16",
                       "--form", "quant4", "--engine", "--requests", "3",
                       "--device", "cpu"])
    assert out["stats"]["requests"] == 3 and not out["rejected"]
    res = tserve.main(["--arch", arch, "--reduced", "--prompt-len", "8",
                       "--batch", "2", "--gen", "3", "--device", "cpu"])
    assert res.tokens.shape == (2, 3)


def test_train_cli_runs_its_default_arch_on_the_cpu():
    """``launch/train.py`` with no ``--arch``: xlstm-125m (reduced)."""
    from repro_torch.launch import train as ttrain
    trainer = ttrain.main(["--reduced", "--lc-steps", "2", "--steps-per-l",
                           "2", "--batch", "2", "--seq", "16", "--device",
                           "cpu"])
    assert trainer.cfg.name == "xlstm-125m-reduced"
    hist = trainer.history
    assert len(hist) == 2 and all(np.isfinite(r["loss"]) for r in hist)
    assert all(r["c_step_violations"] == [] for r in hist)


def test_train_lm_compress_trains_the_reduced_xlstm(tmp_path):
    from repro_torch import train_lm_compress
    trainer = train_lm_compress.main(
        ["--lc-steps", "2", "--steps-per-l", "2", "--batch", "2", "--seq",
         "16", "--ckpt-dir", str(tmp_path), "--device", "cpu"])
    assert trainer.cfg.name == "xlstm-125m-reduced"
    example = Path(__file__).resolve().parents[1] / "examples" / \
        "train_lm_compress.py"
    assert f'r"{train_lm_compress.PATTERN}"' in example.read_text()
    # after init: one task an item of the AsStacked task, k = 16 each
    tasks = trainer.lc.tasks
    assert {t.name.split("[")[0] for t in tasks} == {"quantize-stacks"}
    assert {t.scheme.k for t in tasks} == {16} and len(tasks) == 28
    hist = trainer.history
    assert len(hist) == 2 and all(np.isfinite(r["loss"]) for r in hist)
    assert trainer.ckpt.steps()


@pytest.mark.parametrize("arch", ARCHS)
def test_default_tasks_select_as_the_reference(arch):
    from repro.launch import train as jtrain
    from repro_torch.launch import train as ttrain
    jcfg, tcfg = _cfgs(arch)
    jp = jtf.init_params(jax.random.PRNGKey(0), jcfg)
    tp = interop.params_from_numpy(jax.tree_util.tree_map(np.asarray, jp),
                                   "cpu")
    (jt,) = jtrain.default_tasks(jcfg)
    (tt,) = ttrain.default_tasks(tcfg)
    assert tt.pattern == jt.pattern
    paths = tt.resolve(tp).paths
    assert paths == jt.resolve(jp).paths
    assert any(p.endswith({"jamba-v0.1-52b": "mixer/in_proj",
                           "xlstm-125m": "mixer/w"}[arch]) for p in paths)
    (pr,) = ttrain.default_tasks(tcfg, "prune")
    selected = sum(int(np.prod(flatten_params(tp)[p].shape))
                   for p in pr.resolve(tp).paths)
    assert ttrain.pruned_weights(tcfg) == selected


def test_l0_on_a_log_keeps_exactly_kappa_under_its_tied_class():
    """Mamba's ``A_log`` repeats each value d_inner times at init, so the
    top-κ boundary falls inside a wide tied class (the reference's
    regression ``tests/test_schemes.py::
    test_l0_prune_exact_kappa_under_magnitude_ties``). An ℓ0 task over
    every A_log leaf of the reduced jamba, through both packages' LC
    init: exactly κ nonzeros, Θ bit-identical to the reference's (the
    lowest index wins a tie)."""
    from repro.core import AsVector as JAsVector
    from repro.core import CompressionTask as JTask, LCAlgorithm as JLC
    from repro.core.schemes import ConstraintL0Pruning as JL0
    from repro_torch.core import AsVector, CompressionTask, LCAlgorithm
    from repro_torch.core.schemes import ConstraintL0Pruning
    jcfg, _ = _cfgs("jamba-v0.1-52b", pattern_reps=1)
    jp = jax.tree_util.tree_map(
        np.asarray, jtf.init_params(jax.random.PRNGKey(0), jcfg))
    tp = interop.params_from_numpy(jp, "cpu")
    pattern = r"mixer/A_log$"
    leaves = [v for p, v in flatten_params(tp).items()
              if p.endswith("mixer/A_log")]
    total = sum(v.numel() for v in leaves)
    kappa = total // 3 + 1          # inside a tied class of d_inner values
    assert len(leaves) == 7 and kappa % leaves[0].shape[0] != 0
    jstate = JLC([JTask("a", pattern, JAsVector(), JL0(kappa=kappa))],
                 [1e-4]).init(jp)
    tstate = LCAlgorithm([CompressionTask("a", pattern, AsVector(),
                                          ConstraintL0Pruning(kappa=kappa))],
                         [1e-4], device="cpu").init(tp)
    want = np.asarray(jstate["tasks"]["a"]["theta"]["theta"])
    got = _np(tstate["tasks"]["a"]["theta"]["theta"])
    assert int(np.count_nonzero(got)) == kappa
    np.testing.assert_array_equal(got, want)
