"""The port's data-parallel training on ``gloo`` ranks, on the CPU.

At world size 2 (``torch.multiprocessing`` ranks, a ``FileStore`` under
``tmp_path``; ``tests/torch_dist_workers.py``), the global batch split
over the mesh's "data" axis:

* one train step (loss + LC penalty, clip, AdamW) of reduced phi3-mini
  and of reduced jamba (MoE at capacity factor 8, so that no token
  drops) gives the one-process step's loss within rtol 1e-5, and its
  parameters within ``2·lr`` (below);
* at the reference's capacity factor (1.25, tokens dropped), the
  token-sharded ``moe_ffn`` equals the reference's ``_moe_local`` on
  each half of the tokens at the per-shard capacity, with ``f_e`` and
  ``P_e`` averaged over the halves, within rtol 1e-5;
* ``LCTrainer(mesh=)`` runs 2 LC steps with a checkpoint every step and
  a hard failure restored from one; the §7 monitor holds and every rank
  ends with the same state.

The parameter tolerance: the ranks' gradient is the sum of two halves,
the one-process gradient one sum over the batch, so they differ by
rounding (~1e-7 relative). AdamW's first step moves a weight by
``lr·g/(|g| + eps)``, which is ``±lr`` wherever ``|g| ≫ eps``: a
gradient within rounding of 0 can take the other sign, so a weight may
differ by up to ``2·lr``; all others agree to 1e-6.

The reference runs in this process only, on its single CPU device.
"""
import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_dist_workers as w
from repro import configs as jconfigs
from repro.models import moe as jmoe
from repro_torch.tree import tree_leaves
from torch_threads import _one_torch_thread  # noqa: F401

MOE_ARCH = "mixtral-8x7b"


def _moe_inputs():
    """MoE params from the reference's init and hidden states of 4 × 8
    tokens with a shared component (the router favours some experts, so
    that the capacity drops tokens), as numpy."""
    jcfg = dataclasses.replace(
        jconfigs.reduced_config(jconfigs.get_config(MOE_ARCH)),
        dtype="float32")
    params = jax.tree_util.tree_map(
        np.asarray, jmoe.init_moe(jax.random.PRNGKey(0), jcfg))
    rng = np.random.default_rng(1)
    x = (rng.standard_normal((4, 8, jcfg.d_model))
         + 2.0 * rng.standard_normal(jcfg.d_model)).astype(np.float32)
    return jcfg, {"arch": MOE_ARCH, "params": params, "x": x}


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dp_train")
    jcfg, inputs = _moe_inputs()
    torch.save(inputs, tmp / "inputs.pt")
    w.spawn(w.dp_train, 2, tmp, str(tmp / "inputs.pt"), str(tmp))
    got = [torch.load(tmp / f"rank{r}.pt", weights_only=False)
           for r in range(2)]
    return {"ranks": got, "jcfg": jcfg, "inputs": inputs}


@pytest.mark.parametrize("arch", ["phi3-mini-3.8b", "jamba-v0.1-52b"])
def test_data_parallel_step_equals_one_process(ranks, arch):
    want_m, want_p = w.dp_step(arch, None)
    for got in ranks["ranks"]:
        got_m, got_p = got["steps"][arch]
        for k in ("loss", "ce", "aux", "lc_penalty", "grad_norm"):
            np.testing.assert_allclose(got_m[k], want_m[k], rtol=1e-5,
                                       atol=1e-7, err_msg=k)
        for x, y in zip(tree_leaves(got_p), tree_leaves(want_p)):
            d = (x - y).abs()
            assert float(d.max()) <= 2 * w.DP_LR * (1 + 1e-4)
            # the rest within 1e-6: a sign flipped by rounding is rare
            assert float((d > 1e-6).float().mean()) < 1e-3
    # every rank applies the same update
    for x, y in zip(tree_leaves(ranks["ranks"][0]["steps"][arch][1]),
                    tree_leaves(ranks["ranks"][1]["steps"][arch][1])):
        assert torch.equal(x, y)


def _reference_half(jcfg, params, x_half):
    """The reference's ``_moe_local`` on one shard's tokens at the
    per-shard capacity, and the shard's ``f_e`` and ``P_e`` by the
    reference's formula."""
    m = jcfg.moe
    t = x_half.shape[0] * x_half.shape[1]
    xt = jnp.asarray(x_half.reshape(t, -1))
    cap = int(math.ceil(t * m.top_k / m.n_experts * m.capacity_factor))
    y, _ = jmoe._moe_local(xt, params["router"], params["w_gate"],
                           params["w_up"], params["w_down"], jcfg, e0=0,
                           e_local=m.n_experts, capacity=cap)
    probs = jax.nn.softmax((xt @ params["router"]).astype(jnp.float32),
                           axis=-1)
    _, idx = jax.lax.top_k(probs, m.top_k)
    f_e = jnp.mean(jnp.sum(jax.nn.one_hot(idx, m.n_experts), axis=1),
                   axis=0)
    return (np.asarray(y).reshape(x_half.shape), np.asarray(f_e),
            np.asarray(jnp.mean(probs, axis=0)))


def test_token_sharded_moe_equals_the_reference_per_shard(ranks):
    jcfg, inputs = ranks["jcfg"], ranks["inputs"]
    params = jax.tree_util.tree_map(jnp.asarray, inputs["params"])
    halves = np.split(inputs["x"], 2, axis=0)
    ref = [_reference_half(jcfg, params, h) for h in halves]
    f_e = (ref[0][1] + ref[1][1]) / 2
    p_e = (ref[0][2] + ref[1][2]) / 2
    aux = jcfg.moe.n_experts * np.sum(f_e * p_e)
    for r, got in enumerate(ranks["ranks"]):
        y, got_aux = got["moe"]
        # the matmul tolerance of tests/test_torch_moe.py (MM)
        np.testing.assert_allclose(y.numpy(), ref[r][0], rtol=1e-5,
                                   atol=2e-5)
        np.testing.assert_allclose(float(got_aux), aux, rtol=1e-5)


def test_lc_trainer_over_a_mesh_restores_and_holds_the_monitor(ranks):
    a, b = ranks["ranks"]
    for got in (a, b):
        assert got["lc_mesh"]
        assert got["injected"] == 5
        assert len(got["history"]) == 2
        for rec in got["history"]:
            assert rec["c_step_violations"] == []
            assert np.isfinite(rec["loss"])
    for x, y in zip(tree_leaves((a["params"], a["theta"])),
                    tree_leaves((b["params"], b["theta"]))):
        assert torch.equal(x, y)
    # the same losses as one process, to the rounding that AdamW's steps
    # carry on
    trainer, _, _ = w.dp_trainer(None, None, {})
    for got, want in zip(a["history"], trainer.history):
        np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-4)
