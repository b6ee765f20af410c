"""The port's MoE FFN (``repro_torch/models/moe.py``) against the JAX
package's, on reduced float32 mixtral-8x7b (4 experts, top-2) and
deepseek-moe-16b (4 experts, top-2, one shared expert, a dense lead
layer), with the same weights (the JAX ``init_params`` carried over as
numpy) and the same inputs.

What the JAX package computes inside ``_dispatch_compute`` is read from
its own program: the routing (gates, expert ids, capacity) from the
arguments ``_moe_local`` hands it, and the packed buffers (each slot's
token and gate) from the two scatters of its jaxpr, evaluated equation
by equation.

Tolerances: routing indices, capacities, dispatch slots and the buffers'
tokens bit-identical, at the reference's capacity factor (tokens are
dropped) and at the no-drop 8.0; gates rtol 1e-6 (a softmax over the
router's f32 logits, summed in another order); ``moe_ffn``'s output and
aux loss rtol 1e-5 / atol 2e-5 (XLA and PyTorch sum the products and the
scatter-add in other orders); the loss rtol 1e-5; gradients rtol 1e-4 /
atol 1e-6; one train step's AdamW moments as the gradients (m) and rtol
1e-4 / atol 1e-10 (v, the squared gradients), its params rtol 1e-5 /
atol 1e-5 as ``tests/test_torch_train_step.py`` holds phi3-mini's. At
AdamW eps 1e-6 that holds for every weight. At the trainer's eps 1e-8
the first step (lr·g/(|g| + eps)) is steep in g where |g| < 100·eps:
those weights must be under 1% of each leaf, and each moves by at most
lr in the reference's direction wherever its |g| is 10× the gradients'
measured gap.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.launch import steps as jsteps
from repro.models import moe as jmoe
from repro.models import transformer as jtf
from repro.optim import AdamW as JAdamW
from repro_torch import configs as tconfigs
from repro_torch import interop
from repro_torch.core import flatten_params
from repro_torch.launch import steps as tsteps
from repro_torch.models import moe as tmoe
from repro_torch.models import transformer as ttf
from repro_torch.optim import AdamW
from torch_threads import _one_torch_thread  # noqa: F401


MM = dict(rtol=1e-5, atol=2e-5)
GRAD = dict(rtol=1e-4, atol=1e-6)
PARAMS = dict(rtol=1e-5, atol=1e-5)
ARCHS = ["mixtral-8x7b", "deepseek-moe-16b"]
REF_CF, NO_DROP_CF = None, 8.0
JAX_DISPATCH = jmoe._dispatch_compute


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def _cfgs(arch, capacity_factor=REF_CF, **kw):
    """The same reduced float32 config in both packages; ``None`` keeps
    the reference's capacity factor (1.25)."""
    out = []
    for mod in (jconfigs, tconfigs):
        c = dataclasses.replace(mod.reduced_config(mod.get_config(arch)),
                                dtype="float32", **kw)
        if capacity_factor is not None:
            c = c.with_(moe=dataclasses.replace(
                c.moe, capacity_factor=capacity_factor))
        out.append(c)
    return tuple(out)


def _moe_params(jcfg, seed=0):
    """One MoE block's FFN params (numpy, port) from the JAX init."""
    jp = jax.tree_util.tree_map(
        np.asarray, jmoe.init_moe(jax.random.PRNGKey(seed), jcfg))
    return jp, interop.params_from_numpy(jp, "cpu")


def _x(cfg, b=3, s=8, seed=1):
    """Hidden states with a component shared by every token, so that the
    router favours some experts and, at the reference's capacity
    factor, tokens past capacity are dropped."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, s, cfg.d_model)) \
        + 2.0 * rng.standard_normal(cfg.d_model)
    return x.astype(np.float32)


def _jax_routing(jp, x, jcfg, monkeypatch):
    """Run the reference's ``moe_ffn`` and keep what ``_moe_local`` hands
    ``_dispatch_compute``: (gates, idx, capacity)."""
    seen = {}

    def spy(xx, gates, idx, *a, capacity, **kw):
        seen.update(gates=np.array(gates), idx=np.array(idx),
                    capacity=capacity)
        return JAX_DISPATCH(xx, gates, idx, *a, capacity=capacity, **kw)

    monkeypatch.setattr(jmoe, "_dispatch_compute", spy)
    y, aux = jmoe.moe_ffn(jp, jnp.asarray(x), jcfg, None)
    return seen, np.asarray(y), float(aux)


def _jax_buffers(x2, gates, idx, jp, e, capacity):
    """The reference's packed buffers: evaluate ``_dispatch_compute``'s
    jaxpr equation by equation and take its two scatters into the
    (E·C + 1,) buffers, the int32 one (each slot's token) and the float
    one (each slot's gate)."""
    closed = jax.make_jaxpr(lambda *a: JAX_DISPATCH(
        *a, e0=0, e_local=e, capacity=capacity, dtype=jnp.float32))(
        x2, gates, idx, jp["w_gate"], jp["w_up"], jp["w_down"])
    env = dict(zip(closed.jaxpr.constvars, closed.consts))
    env.update(zip(closed.jaxpr.invars, (x2, gates, idx, jp["w_gate"],
                                         jp["w_up"], jp["w_down"])))
    bufs = {}
    for eqn in closed.jaxpr.eqns:
        args = [v.val if hasattr(v, "val") else env[v] for v in eqn.invars]
        out = eqn.primitive.bind(*args, **eqn.params)
        outs = out if eqn.primitive.multiple_results else [out]
        env.update(zip(eqn.outvars, outs))
        if eqn.primitive.name == "scatter" and \
                outs[0].shape == (e * capacity + 1,):
            bufs[str(outs[0].dtype)] = np.asarray(outs[0])[:e * capacity]
    return bufs["int32"], bufs["float32"]


# ----------------------------------------------------------------------
# routing and dispatch
# ----------------------------------------------------------------------
@pytest.mark.parametrize("cf", [REF_CF, NO_DROP_CF], ids=["ref-cf", "cf8"])
@pytest.mark.parametrize("arch", ARCHS)
def test_routing_and_dispatch_bit_identical(arch, cf, monkeypatch):
    jcfg, tcfg = _cfgs(arch, cf)
    jp, tp = _moe_params(jcfg)
    x = _x(jcfg)
    seen, _, _ = _jax_routing(jp, x, jcfg, monkeypatch)
    x2 = x.reshape(-1, jcfg.d_model)
    probs, gates, idx = tmoe.route(torch.from_numpy(x2), tp["router"], tcfg)
    np.testing.assert_array_equal(_np(idx), seen["idx"])
    np.testing.assert_allclose(_np(gates), seen["gates"], rtol=1e-6)
    t_tokens, e = x2.shape[0], tcfg.moe.n_experts
    cap = tmoe.capacity_for(t_tokens, tcfg)
    assert cap == seen["capacity"]

    # the buffers, both packages on the reference's routing
    want_tok, want_gate = _jax_buffers(jnp.asarray(x2),
                                       jnp.asarray(seen["gates"]),
                                       jnp.asarray(seen["idx"]), jp, e, cap)
    buf_tok, buf_gate, slot = tmoe.dispatch_plan(
        torch.from_numpy(seen["gates"]), torch.from_numpy(seen["idx"]),
        e0=0, e_local=e, capacity=cap)
    np.testing.assert_array_equal(_np(buf_tok), want_tok)
    np.testing.assert_array_equal(_np(buf_gate), want_gate)
    kept = int((_np(slot) < e * cap).sum())
    if cf is REF_CF:                    # tokens past capacity are dropped
        assert kept < t_tokens * tcfg.moe.top_k
    else:
        assert kept == t_tokens * tcfg.moe.top_k


def test_dropped_tokens_follow_the_token_major_order():
    """Each expert keeps its first C assignments in token order; the
    rest of its assignments go to the trash slot."""
    idx = torch.tensor([[0, 1], [0, 2], [0, 1], [3, 0]])
    gates = torch.full((4, 2), 0.5)
    buf_tok, buf_gate, slot = tmoe.dispatch_plan(gates, idx, e0=0,
                                                 e_local=4, capacity=2)
    # expert 0 keeps tokens 0 and 1 and drops 2 and 3; expert 2's and
    # expert 3's second slots stay empty (token 0, gate 0)
    assert buf_tok.tolist() == [0, 1, 0, 2, 1, 0, 3, 0]
    assert buf_gate.tolist() == [0.5] * 5 + [0.0, 0.5, 0.0]
    assert int((slot == 8).sum()) == 2


# ----------------------------------------------------------------------
# the FFN
# ----------------------------------------------------------------------
@pytest.mark.parametrize("cf", [REF_CF, NO_DROP_CF], ids=["ref-cf", "cf8"])
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_ffn_matches_jax(arch, cf, monkeypatch):
    jcfg, tcfg = _cfgs(arch, cf)
    jp, tp = _moe_params(jcfg)
    x = _x(jcfg)
    _, y_j, aux_j = _jax_routing(jp, x, jcfg, monkeypatch)
    y_t, aux_t = tmoe.moe_ffn(tp, torch.from_numpy(x), tcfg)
    np.testing.assert_allclose(_np(y_t), y_j, **MM)
    assert aux_t.dtype == torch.float32
    np.testing.assert_allclose(float(aux_t), aux_j, rtol=1e-5)


def test_shared_experts_match_jax():
    """deepseek's shared experts: the FFN with and without them differs
    by the shared SwiGLU alone, in both packages."""
    jcfg, tcfg = _cfgs("deepseek-moe-16b")
    assert tcfg.moe.n_shared == 1
    jp, tp = _moe_params(jcfg)
    x = _x(jcfg)
    jcfg0 = jcfg.with_(moe=dataclasses.replace(jcfg.moe, n_shared=0))
    tcfg0 = tcfg.with_(moe=dataclasses.replace(tcfg.moe, n_shared=0))
    y_j = np.asarray(jmoe.moe_ffn(jp, jnp.asarray(x), jcfg, None)[0])
    y_j0 = np.asarray(jmoe.moe_ffn(jp, jnp.asarray(x), jcfg0, None)[0])
    y_t = _np(tmoe.moe_ffn(tp, torch.from_numpy(x), tcfg)[0])
    y_t0 = _np(tmoe.moe_ffn(tp, torch.from_numpy(x), tcfg0)[0])
    assert np.abs(y_j - y_j0).max() > 1e-2
    np.testing.assert_allclose(y_t - y_t0, y_j - y_j0, **MM)


class _ModelAxisMesh:
    """A mesh's layout with a tensor-parallel "model" axis of ``m``, seen
    from model rank ``r``."""

    def __init__(self, m, r):
        self.mesh_dim_names, self.shape, self.r = ("data", "model"), (1, m), r

    def get_local_rank(self, axis):
        return self.r if axis == "model" else 0


def _model_axis_partials(arch, experts, m, monkeypatch):
    """Each model rank's ``moe_ffn`` from its slices of the expert stacks
    and shared experts over a "model" axis of ``m`` (stand-in meshes,
    the sum over "model" recorded instead of run), against the
    reference's ``moe_ffn`` at ``mesh=None``."""
    from repro_torch.distributed import sharding
    from repro_torch.models import layers
    jcfg, tcfg = _cfgs(arch)
    if experts is not None:
        jcfg = jcfg.with_(moe=dataclasses.replace(jcfg.moe,
                                                  n_experts=experts))
        tcfg = tcfg.with_(moe=dataclasses.replace(tcfg.moe,
                                                  n_experts=experts))
    jp, tp = _moe_params(jcfg)
    x = _x(jcfg)
    y_j, aux_j = jmoe.moe_ffn(jp, jnp.asarray(x), jcfg, None)
    partials = []
    monkeypatch.setattr(sharding, "model_all_reduce",
                        lambda y: partials.append(y) or y)
    axes = tmoe.moe_axes(tcfg)
    ep = tcfg.moe.n_experts % m == 0
    total = 0
    for r in range(m):
        mesh = _ModelAxisMesh(m, r)
        shard = {}
        for k, leaf in tp.items():
            spec = sharding.shard_spec(axes[k], tuple(leaf.shape), mesh,
                                       sharding.SERVE_RULES)
            if "model" in spec:
                d = spec.index("model")
                per = leaf.shape[d] // m
                leaf = layers.slice_weight(leaf, d, r * per, (r + 1) * per)
            shard[k] = leaf
        # "ep" splits the experts, "tp" every expert's columns
        assert (shard["w_gate"].shape[0] < tcfg.moe.n_experts) == ep
        assert (shard["w_gate"].shape[2] < tcfg.moe.d_expert) != ep
        with sharding.use_mesh(mesh):
            y, aux = tmoe.moe_ffn(shard, torch.from_numpy(x), tcfg, mesh)
        assert len(partials) == r + 1      # one sum over "model" a call
        np.testing.assert_allclose(_np(aux), np.asarray(aux_j), **MM)
        total = total + y
    np.testing.assert_allclose(_np(total), np.asarray(y_j), **MM)


def test_moe_ffn_with_a_mesh_raises(monkeypatch):
    """Over a "model" axis of m ("ep" where E divides by m, else "tp"),
    each rank's partial output (what ``moe_ffn`` hands the sum over
    "model") adds up to the reference's ``moe_ffn`` at ``mesh=None``,
    with its aux loss: mixtral "ep" at m = 2, deepseek (shared experts)
    "ep" at m = 4 and, with 6 experts, "tp" at m = 4. A data-only mesh of
    one rank, the batch split over it or not, equals ``mesh=None``."""
    from repro_torch.distributed import sharding
    from repro_torch.launch.mesh import make_debug_mesh
    for arch, experts, m in (("mixtral-8x7b", None, 2),
                             ("deepseek-moe-16b", None, 4),
                             ("deepseek-moe-16b", 6, 4)):
        with monkeypatch.context() as mp:
            _model_axis_partials(arch, experts, m, mp)
    jcfg, tcfg = _cfgs("mixtral-8x7b")
    _, tp = _moe_params(jcfg)
    x = torch.from_numpy(_x(jcfg))
    mesh = make_debug_mesh(device_type="cpu")
    y0, aux0 = tmoe.moe_ffn(tp, x, tcfg)
    for entry in (None, "data"):
        with sharding.use_mesh(mesh), sharding.local_batch(entry):
            y, aux = tmoe.moe_ffn(tp, x, tcfg, sharding.active_mesh())
        assert torch.equal(y, y0) and torch.equal(aux, aux0)


def test_dispatch_refuses_a_weight_form():
    """The expert stacks are dense: a compressed form never reaches the
    batched GEMMs (the bridge keeps 3-D stacks dense)."""
    from repro_torch.runtime import compressed as cforms
    _, tcfg = _cfgs("mixtral-8x7b")
    _, tp = _moe_params(_cfgs("mixtral-8x7b")[0])
    stack = tp["w_gate"]
    tp["w_gate"] = cforms.QuantizedWeight(
        torch.zeros(stack.shape, dtype=torch.uint8), torch.zeros(16),
        stack.shape, 8)
    with pytest.raises(TypeError, match="dense"):
        tmoe.moe_ffn(tp, torch.zeros(1, 2, tcfg.d_model), tcfg)


def test_init_moe_shapes_and_scale():
    jcfg, tcfg = _cfgs("deepseek-moe-16b")
    want = jax.eval_shape(lambda: jmoe.init_moe(jax.random.PRNGKey(0),
                                                jcfg))
    got = tmoe.init_moe(torch.Generator().manual_seed(0), tcfg)
    assert {k: tuple(v.shape) for k, v in got.items()} == \
        {k: tuple(v.shape) for k, v in want.items()}
    # dense_init per expert: std 1/sqrt(fan_in), experts drawn apart
    w = got["w_up"]
    assert abs(float(w.std()) * np.sqrt(w.shape[-2]) - 1.0) < 0.1
    assert not torch.equal(w[0], w[1])


# ----------------------------------------------------------------------
# the model: loss, gradients, one train step
# ----------------------------------------------------------------------
def _params(jcfg, seed=0):
    jp = jax.tree_util.tree_map(lambda x: np.array(x, copy=True),
                                jtf.init_params(jax.random.PRNGKey(seed),
                                                jcfg))
    rng = np.random.default_rng(seed + 1)
    for path, leaf in jax.tree_util.tree_flatten_with_path(jp)[0]:
        if "norm" in jax.tree_util.keystr(path):
            leaf[...] = 0.1 * rng.standard_normal(leaf.shape)
    return jp, interop.params_from_numpy(jp, "cpu")


def _batch(cfg, b=2, s=16, seed=3):
    rng = np.random.default_rng(seed)
    return {k: rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)
            for k in ("inputs", "labels")}


def _assert_tree(ours, theirs, **tol):
    fo = flatten_params(interop.to_numpy(ours))
    ft = flatten_params(jax.tree_util.tree_map(np.asarray, theirs))
    assert set(fo) == set(ft)
    for k in ft:
        np.testing.assert_allclose(fo[k], ft[k], err_msg=k, **tol)


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_fn_matches_jax(arch):
    jcfg, tcfg = _cfgs(arch)
    jp, tp = _params(jcfg)
    batch = _batch(jcfg)
    jl, jm = jtf.loss_fn(jp, jax.tree_util.tree_map(jnp.asarray, batch),
                         jcfg)
    with torch.no_grad():
        tl, tm = ttf.loss_fn(tp, {k: torch.from_numpy(v)
                                  for k, v in batch.items()}, tcfg)
    assert float(jm["aux"]) > 0.0
    for ours, theirs in ((tl, jl), (tm["ce"], jm["ce"]),
                         (tm["aux"], jm["aux"])):
        np.testing.assert_allclose(float(ours), float(theirs), rtol=1e-5)


@pytest.mark.parametrize("arch", ARCHS)
def test_gradients_match_jax_grad(arch):
    """Through the router (gates), the gather, the expert GEMMs and the
    scatter-add, and the aux loss; the routing indices carry none."""
    jcfg, tcfg = _cfgs(arch)
    jp, tp = _params(jcfg)
    batch = _batch(jcfg)
    jb = jax.tree_util.tree_map(jnp.asarray, batch)
    jg = jax.grad(lambda p: jtf.loss_fn(p, jb, jcfg)[0])(
        jax.tree_util.tree_map(jnp.asarray, jp))
    leaves = {k: v.detach().requires_grad_(True)
              for k, v in flatten_params(tp).items()}
    loss, _ = ttf.loss_fn(_nest(leaves), {k: torch.from_numpy(v)
                                   for k, v in batch.items()}, tcfg)
    grads = torch.autograd.grad(loss, list(leaves.values()))
    _assert_tree(_nest(dict(zip(leaves, grads))), jg, **GRAD)
    router = [g for p, g in zip(leaves, grads) if p.endswith("ffn/router")]
    assert router and all(float(g.abs().max()) > 0 for g in router)


def _nest(flat):
    out = {}
    for path, v in flat.items():
        node = out
        *head, last = path.split("/")
        for k in head:
            node = node.setdefault(k, {})
        node[last] = v
    return out


@pytest.mark.parametrize("eps", [AdamW.eps, 1e-6])
@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_matches_jax(arch, eps):
    """One ``make_train_step`` step (LC penalty, clip, AdamW): metrics,
    params and both AdamW moments leaf by leaf."""
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
    assert any("ffn/w_gate" in p for p in st["lc"]["a"])   # expert stacks
    batch = _batch(jcfg)
    lr = 1e-3
    jstep = jax.jit(jsteps.make_train_step(jcfg, JAdamW(eps=eps), lr=lr))
    j_new, j_met = jstep(jax.tree_util.tree_map(jnp.asarray, st),
                         jax.tree_util.tree_map(jnp.asarray, batch))
    tstep = tsteps.make_train_step(tcfg, AdamW(eps=eps), lr=lr)
    t_new, t_met = tstep(interop.train_state_from_numpy(st, "cpu"),
                         {k: torch.from_numpy(v) for k, v in batch.items()})
    for k in ("loss", "ce", "aux", "lc_penalty", "grad_norm"):
        np.testing.assert_allclose(float(t_met[k]), float(j_met[k]),
                                   err_msg=k, rtol=1e-5, atol=1e-7)
    _assert_tree(t_new["opt"]["m"], j_new["opt"]["m"], **GRAD)
    _assert_tree(t_new["opt"]["v"], j_new["opt"]["v"], rtol=1e-4,
                 atol=1e-10)
    # AdamW's first step moves a weight by lr·g/(|g| + eps): at the
    # trainer's eps, where the reference's |g| is below 100·eps, the step
    # turns the gradients' summation-order gap (held by m above) into up
    # to lr. Those steep weights must be few, move by at most lr, and
    # move the reference's way wherever |g| is 10× the leaf's measured
    # gap; at eps 1e-6 there are none
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
        steep = (np.abs(g) < 100 * eps if eps == AdamW.eps
                 else np.zeros(g.shape, bool))
        print(f"{k}: {int(steep.sum())} of {g.size} weights steep")
        assert steep.mean() < 0.01, k
        np.testing.assert_allclose(pt[k][~steep], pj[k][~steep],
                                   err_msg=k, **PARAMS)
        step_t, step_j = (pt[k] - p0[k])[steep], (pj[k] - p0[k])[steep]
        assert np.all(np.abs(step_t) <= lr * (1 + 1e-5)), k
        signed = np.abs(g[steep]) > 10 * float(np.abs(g_t - g).max())
        assert np.all(np.sign(step_t[signed]) == np.sign(step_j[signed])
                      ) and np.all(step_j[signed] != 0), k


# ----------------------------------------------------------------------
# serving: the bridge, Server and ServingEngine
# ----------------------------------------------------------------------
def _trace(vocab, n=6, seed=1):
    rng = np.random.default_rng(seed)
    t, reqs = 0.0, []
    for i in range(n):
        t += float(rng.exponential(0.002))
        reqs.append((i, rng.integers(1, vocab, size=int(rng.integers(3, 21)))
                     .astype(np.int32), int(rng.integers(3, 9)), t))
    return reqs


@pytest.mark.parametrize("arch", ARCHS)
def test_generate_and_engine_match_jax(arch):
    """Greedy tokens of ``Server.generate`` and of a mixed-length
    ``ServingEngine`` trace at the reference's capacity factor: the
    engine's decode routes all 3 slots' tokens together (capacity
    ceil(3·2/4·1.25) = 2 a step, inactive slots included), so its drops
    must be the reference's for the tokens to agree."""
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


def test_bridge_keeps_expert_stacks_dense_and_serves_the_rest():
    """deepseek (unrolled, so every leaf is per layer): a JAX LC state
    with 8-bit attention, 4-bit shared experts and lead FFN, and 4-bit
    expert stacks, bridged by both packages: the same forms and arrays
    (the 3-D stacks as their dense decompressed leaves). The port serves
    it with greedy tokens equal to the densified model's in the JAX
    package; the JAX package cannot serve its own bridged tree, because
    its ``moe_ffn`` applies the shared experts with ``.astype`` rather
    than through ``apply_w`` (a reference fault the port fixes)."""
    from repro.core import AsVector as JAsVector
    from repro.core import CompressionTask as JTask, LCAlgorithm as JLC
    from repro.core import schemes as js
    from repro.runtime import server as jserver
    from repro_torch.core import AsVector, CompressionTask
    from repro_torch.core import schemes as ts
    from repro_torch.runtime import server as tserver
    jcfg, tcfg = _cfgs("deepseek-moe-16b", pattern_reps=1)
    jp = jtf.init_params(jax.random.PRNGKey(0), jcfg)
    specs = [("attn", r"mixer/(wq|wk|wv|wo)$", 64),
             ("ffn4", r"ffn/(sw_gate|sw_up|sw_down)$|s0/pos0/ffn/w_", 16),
             ("experts", r"s1/pos0/ffn/(w_gate|w_up|w_down)$", 16)]
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
    assert set(t_report["experts"].values()) == {"dense"}
    assert set(t_report["ffn4"].values()) == {"quant4"}
    assert set(t_report["attn"].values()) == {"quant8"}
    t_flat = flatten_params(interop.to_numpy(t_serving))
    for path, form in t_report["experts"].items():
        np.testing.assert_array_equal(
            t_flat[path], np.asarray(flatten_params(j_serving)[path]))
    for path in t_report["ffn4"]:
        leaf = flatten_params(j_serving)[path]
        ours = flatten_params(t_serving)[path]
        np.testing.assert_array_equal(_np(ours.packed),
                                      np.asarray(leaf.packed))

    prompts = np.random.default_rng(0).integers(
        1, jcfg.vocab_size, (2, 16)).astype(np.int32)
    with pytest.raises(AttributeError, match="astype"):
        jserver.Server(jcfg, j_serving, max_len=32).generate(
            jnp.asarray(prompts), 4)
    j_dense = jserver.densified_for_serving(jp, state, algo.tasks)
    want = jserver.Server(jcfg, j_dense, max_len=32).generate(
        jnp.asarray(prompts), 8)
    got = tserver.Server(tcfg, t_serving, max_len=32, device="cpu") \
        .generate(prompts, 8)
    np.testing.assert_array_equal(got.tokens, want.tokens)


@pytest.mark.parametrize("arch", ARCHS)
def test_cli_serves_and_trains_on_the_cpu(arch):
    from repro_torch.launch import serve as tserve
    from repro_torch.launch import train as ttrain
    out = tserve.main(["--arch", arch, "--reduced", "--prompt-len", "16",
                       "--form", "quant4", "--engine", "--requests", "3",
                       "--device", "cpu"])
    assert out["stats"]["requests"] == 3 and not out["rejected"]
    res = tserve.main(["--arch", arch, "--reduced", "--prompt-len", "8",
                       "--batch", "2", "--gen", "3", "--device", "cpu"])
    assert res.tokens.shape == (2, 3)
    trainer = ttrain.main(["--arch", arch, "--reduced", "--lc-steps", "2",
                           "--steps-per-l", "2", "--batch", "2", "--seq",
                           "16", "--device", "cpu"])
    hist = trainer.history
    assert len(hist) == 2 and all(np.isfinite(r["loss"]) for r in hist)


@pytest.mark.parametrize("arch", ARCHS)
def test_default_tasks_select_the_expert_stacks_as_the_reference(arch):
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
    assert any(p.endswith("ffn/w_gate") for p in paths)
    (pr,) = ttrain.default_tasks(tcfg, "prune")
    selected = sum(int(np.prod(flatten_params(tp)[p].shape))
                   for p in pr.resolve(tp).paths)
    assert ttrain.pruned_weights(tcfg) == selected
