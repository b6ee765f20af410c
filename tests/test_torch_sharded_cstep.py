"""The port's sharded grouped C step on ``gloo`` ranks, on the CPU.

At world sizes 2 and 3 (``torch.multiprocessing`` ranks, a ``FileStore``
under ``tmp_path``; ``tests/torch_dist_workers.py``), on LeNet300-width
tasks: a K-means group of 5 items (so that a lane pads at both sizes),
an ℓ0 group, a low-rank group (replicated: its batched products change
bits with the batch) and a singleton, through ``grouped_compress(mesh=)``
and through ``LCAlgorithm(mesh=)`` for 3 C steps with the compiled
driver, on the ``cuda`` backend (the kernels' plain versions on CPU
tensors, chunk-exact as on the card):

* every rank's Θ, Δ(Θ) and λ equal the one-process ``mesh=None`` run bit
  for bit, at every step;
* they equal the reference's ``mesh=None`` result within ROADMAP queue
  3's tolerances (masks equal, codebooks atol 1e-3, low-rank factors
  from the exact path atol 1e-4);
* ``set_mesh`` drops the captured programs;
* ``psum_compressed`` at world size 2 equals the bfloat16 sum of each
  rank's ``ef_decompress`` computed in one process.

The reference runs in this process only, on its single CPU device.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_dist_workers as w
from repro import core as jcore
from repro.core import grouping as jgrouping
from repro.core import schemes as jschemes
from repro_torch.distributed import compression_comm as cc
from repro_torch.tree import tree_leaves
from torch_threads import _one_torch_thread  # noqa: F401

KMEANS_CB_ATOL = 1e-3


@pytest.fixture(scope="module")
def reference():
    """The problem's leaves and the reference's Θ^DC of every task, as
    numpy (the ranks and the reference start from the same Θ), and the
    reference's ``mesh=None`` grouped C step from them."""
    xs = w.cstep_params()
    params = {n: jnp.asarray(x) for n, x in xs.items()}
    tasks = [t.resolve(params) for t in w.cstep_tasks(jcore, jschemes)]
    xc = {t.name: t.compressible(params) for t in tasks}
    thetas = {n: th for n, (th, _) in jax.jit(
        lambda x: jgrouping.grouped_init(tasks, x))(xc).items()}
    jout = jax.jit(lambda x, th: jgrouping.grouped_compress(
        tasks, x, th, jnp.float32(1e-3), backend="auto", planner="on"))(
            xc, thetas)
    inputs = {"xs": xs, "thetas": {
        n: jax.tree_util.tree_map(np.asarray, th)
        for n, th in thetas.items()}}
    return inputs, jout


@pytest.fixture(scope="module", params=[2, 3], ids=["world2", "world3"])
def ranks(request, reference, tmp_path_factory):
    world = request.param
    tmp = tmp_path_factory.mktemp(f"sharded_cstep_{world}")
    torch.save(reference[0], tmp / "inputs.pt")
    w.spawn(w.sharded_cstep, world, tmp, str(tmp / "inputs.pt"), str(tmp))
    got = [torch.load(tmp / f"rank{r}.pt", weights_only=False)
           for r in range(world)]
    return {"world": world, "ranks": got, "inputs": reference[0],
            "jout": reference[1]}


def _assert_bits(a, b, what):
    la, lb = tree_leaves(a), tree_leaves(b)
    assert len(la) == len(lb), what
    for x, y in zip(la, lb):
        assert x.shape == y.shape and x.dtype == y.dtype, what
        assert torch.equal(x, y), what


def test_grouped_compress_on_every_rank_equals_one_process(ranks):
    want = w.grouped_once(None, ranks["inputs"])
    for r, got in enumerate(ranks["ranks"]):
        for name in want:
            _assert_bits(got["once"][name], want[name],
                         f"rank {r} of {ranks['world']}: {name}")


def test_lc_driver_on_every_rank_equals_one_process(ranks):
    """Θ^DC and 3 C steps of the compiled driver (the third on its
    programs), each with its multiplier step."""
    want, _ = w.run_lc(None)
    for r, got in enumerate(ranks["ranks"]):
        assert len(got["steps"]) == len(want) == 4
        for k, (g, e) in enumerate(zip(got["steps"], want)):
            for name in e:
                _assert_bits(g[name], e[name],
                             f"rank {r}, step {k}: {name}")


class _StandIn:
    """A mesh's layout without ranks (``mesh_dim_names`` and ``shape``)."""

    def __init__(self, world):
        self.mesh_dim_names, self.shape = ("data", "model"), (world, 1)


@pytest.mark.parametrize("world", [2, 3])
def test_group_layout_and_modes(world):
    """The driver's ``group_summary`` under the meshes of the runs: the
    "items" rule's partition and pad, sharded, replicated and singleton
    groups, and the plans' shard modes."""
    from repro_torch import core
    from repro_torch.core import schemes
    lc = core.LCAlgorithm(w.cstep_tasks(core, schemes), w.CSTEP_MUS,
                          cstep_backend="cuda", device="cpu",
                          mesh=_StandIn(world))
    summary = lc.group_summary({n: torch.from_numpy(x) for n, x in
                                w.cstep_params().items()})
    rows = {tuple(g["tasks"]): g for g in summary}
    q, p, l, s = (rows[("qa", "qb")], rows[("pa", "pb")],
                  rows[("la", "lb")], rows[("s",)])
    assert (q["spec"], q["padding"], q["shard_mode"]) == (
        ("data",), (-5) % world, "sharded")
    assert (p["spec"], p["padding"], p["shard_mode"]) == (
        ("data",), (-2) % world, "sharded")
    assert l["shard_mode"] == "replicated"
    assert "not chunk-exact" in l["shard_reason"]
    assert (s["spec"], s["padding"], s["shard_mode"]) == (None, 0, None)
    assert q["plan"]["shard_mode"] == p["plan"]["shard_mode"] == "sharded"
    assert l["plan"]["shard_mode"] == "replicated"
    assert any(f.startswith("replicated-under-mesh")
               for f in l["plan"]["fallbacks"])


def test_sharded_equals_the_reference(ranks):
    """Every rank's gathered C step against the reference's ``mesh=None``
    grouped C step from the same Θ."""
    jout = ranks["jout"]
    for got in ranks["ranks"]:
        for name in jout:
            th, a = got["once"][name]
            jth, ja = jout[name]
            a, ja = a.numpy(), np.asarray(ja)
            if name.startswith("p"):
                np.testing.assert_array_equal(a, ja)
            elif name.startswith("l"):
                np.testing.assert_allclose(a, ja, atol=1e-4)
            else:
                np.testing.assert_allclose(a, ja, atol=KMEANS_CB_ATOL)
                np.testing.assert_allclose(th.codebook.numpy(),
                                           np.asarray(jth.codebook),
                                           atol=KMEANS_CB_ATOL)


def test_set_mesh_drops_the_captured_programs(ranks):
    for got in ranks["ranks"]:
        d = got["dropped"]
        # groups and per-task solves ran as programs from C step 2 on
        assert d["executables_before"] == 3 and d["tasks_before"] == 1
        assert d["new_programs"]
        assert d["executables_after"] == d["tasks_after"] == 0


def test_psum_compressed_equals_the_bf16_sum(ranks):
    """At world size 2 bit for bit; at 3 (where the sum of three bfloat16
    terms depends on the backend's order) every rank the same, within one
    bfloat16 rounding of the exact mean."""
    world = ranks["world"]
    parts = []
    for got in ranks["ranks"]:
        signs, scales, _ = cc.compress_tree(got["grads"],
                                            cc.init_ef(got["grads"]))
        parts.append({k: cc.ef_decompress(signs[k], scales[k])
                      for k in signs})
    for k in parts[0]:
        psums = [got["psum"][k] for got in ranks["ranks"]]
        assert all(p.dtype == torch.bfloat16 for p in psums)
        assert all(torch.equal(p, psums[0]) for p in psums)
        if world == 2:
            want = (parts[0][k].to(torch.bfloat16)
                    + parts[1][k].to(torch.bfloat16)) / world
            assert torch.equal(psums[0], want), k
        else:
            exact = sum(p[k] for p in parts) / world
            np.testing.assert_allclose(psums[0].float().numpy(),
                                       exact.numpy(), rtol=2 ** -6,
                                       atol=1e-6)
