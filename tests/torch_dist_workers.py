"""Rank processes for the port's multi-rank tests on the CPU.

The tests spawn ``gloo`` ranks with ``torch.multiprocessing`` (the
``spawn`` start method) and a ``FileStore`` under the test's
``tmp_path``; each rank imports this module, which imports torch and the
port only (never JAX: the reference runs in the test's own process). A
rank writes what it computed with ``torch.save`` for the test to read.

    from torch_dist_workers import spawn
    spawn(worker_fn, world, tmp_path, *args)   # worker_fn(rank, world, *args)
"""
from __future__ import annotations

import datetime
import os

import numpy as np
import torch

# ----------------------------------------------------------------------
# spawning
# ----------------------------------------------------------------------


def _entry(rank, fn, world, store, args):
    import torch.distributed as dist
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=120))
    try:
        fn(rank, world, *args)
    finally:
        dist.destroy_process_group()


#: modules the fork server imports once, so that every rank forked from
#: it starts with them (torch's import alone takes seconds)
PRELOAD = ["torch", "torch_dist_workers", "repro_torch.core",
           "repro_torch.launch.mesh", "torch._dynamo"]


def spawn(fn, world: int, tmp_path, *args) -> None:
    """Run ``fn(rank, world, *args)`` on ``world`` gloo ranks, forked from
    a fork server that holds no JAX and no threads of the test process;
    raises if any rank fails."""
    import multiprocessing

    import torch.multiprocessing as mp
    multiprocessing.get_context("forkserver").set_forkserver_preload(
        PRELOAD)
    store = os.path.join(str(tmp_path), f"store_{fn.__name__}_{world}")
    mp.start_processes(_entry, args=(fn, world, store, args), nprocs=world,
                       start_method="forkserver")


# ----------------------------------------------------------------------
# the sharded C step: LeNet300-width tasks
# ----------------------------------------------------------------------
#: (name, shape, family): a K-means group of 5 items (stacks of 3 and 2
#: items of LeNet300's l1, 300 × 100), an ℓ0 group of LeNet300's l0 twice
#: (κ differs: one launch), a low-rank group of l2 (100 × 10) twice, and
#: a singleton
CSTEP_LEAVES = (("qa", (3, 300, 100), "quant"), ("qb", (2, 300, 100), "quant"),
                ("pa", (784, 300), "l0-2000"), ("pb", (784, 300), "l0-6000"),
                ("la", (100, 10), "lowrank"), ("lb", (100, 10), "lowrank"),
                ("s", (100, 10), "quant-single"))
CSTEP_MUS = (1e-3, 2e-3, 4e-3)


def cstep_params(seed: int = 0) -> dict:
    rng = np.random.default_rng(seed)
    return {n: rng.standard_normal(s).astype(np.float32)
            for n, s, _ in CSTEP_LEAVES}


def cstep_tasks(core, schemes):
    """The tasks, built from either package's ``core`` and ``schemes``."""
    out = []
    for name, shape, family in CSTEP_LEAVES:
        if family == "quant":
            view = core.AsStacked("vector")
            scheme = schemes.AdaptiveQuantization(k=4, iters=3)
        elif family.startswith("l0"):
            view = core.AsVector()
            scheme = schemes.ConstraintL0Pruning(kappa=int(family[3:]))
        elif family == "lowrank":
            view, scheme = core.AsIs(), schemes.LowRank(target_rank=2)
        else:
            view, scheme = core.AsVector(), schemes.AdaptiveQuantization(
                k=2, iters=3)
        out.append(core.CompressionTask(name, f"^{name}$", view, scheme))
    return out


def step_params(params: dict, k: int) -> dict:
    """A stand-in for an L step: the weights nudged before C step ``k``."""
    return {n: w + 0.01 * (k + 1) for n, w in params.items()}


def run_lc(mesh, backend: str = "cuda", jit: bool = True) -> tuple:
    """``LCAlgorithm`` over the C-step problem: init, then for each μ a
    C step and a multiplier step. Returns (per C step, {task: (Θ, a)};
    the driver)."""
    from repro_torch import core
    from repro_torch.core import schemes
    params = {n: torch.from_numpy(w) for n, w in cstep_params().items()}
    lc = core.LCAlgorithm(cstep_tasks(core, schemes), CSTEP_MUS,
                          cstep_backend=backend, device="cpu",
                          jit_c_step=jit, mesh=mesh)
    state = lc.init(params)
    out = [{n: (state["tasks"][n]["theta"], state["tasks"][n]["a"])
            for n in state["tasks"]}]
    for k, mu in enumerate(CSTEP_MUS):
        state = lc.set_mu(state, mu, k)
        params = step_params(params, k)
        state = lc.c_step(params, state)
        state = lc.multiplier_step(params, state)
        out.append({n: (state["tasks"][n]["theta"], state["tasks"][n]["a"],
                        state["tasks"][n]["lam"])
                    for n in state["tasks"]})
    return out, lc


def grouped_once(mesh, inputs: dict, backend: str = "cuda") -> dict:
    """One grouped C step at μ 1e-3 from ``inputs`` ({"xs": numpy, "thetas":
    numpy trees}, the reference's Θ^DC)."""
    from repro_torch import core, interop
    from repro_torch.core import schemes
    from repro_torch.core.grouping import grouped_compress
    params = {n: torch.from_numpy(w.copy()) for n, w in inputs["xs"].items()}
    tasks = [t.resolve(params) for t in cstep_tasks(core, schemes)]
    thetas = {t.name: interop._theta_from_numpy(inputs["thetas"][t.name],
                                                "cpu") for t in tasks}
    return grouped_compress(tasks, {t.name: t.compressible(params)
                                    for t in tasks}, thetas,
                            torch.tensor(1e-3), mesh=mesh, backend=backend,
                            device="cpu", planner="on")


def sharded_cstep(rank, world, inputs_path, out_dir):
    from repro_torch.distributed import compression_comm as cc
    from repro_torch.launch.mesh import make_cstep_mesh
    mesh = make_cstep_mesh(device_type="cpu")
    inputs = torch.load(inputs_path, weights_only=False)
    once = grouped_once(mesh, inputs)
    steps, lc = run_lc(mesh)
    # set_mesh drops the captured programs
    before = (lc.programs, len(lc._compiled.executables),
              len(lc._compiled.tasks))
    lc.set_mesh(mesh)
    dropped = {"executables_before": before[1], "tasks_before": before[2],
               "new_programs": lc.programs is not before[0],
               "executables_after": len(lc._compiled.executables),
               "tasks_after": len(lc._compiled.tasks)}
    # psum_compressed: rank-dependent gradients, zero error feedback
    g = torch.Generator().manual_seed(100 + rank)
    grads = {"w": torch.randn(64, 8, generator=g),
             "b": torch.randn(8, generator=g)}
    avg, new_ef = cc.psum_compressed(grads, cc.init_ef(grads), "data",
                                     mesh=mesh)
    torch.save({"once": once, "steps": steps,
                "dropped": dropped, "grads": grads, "psum": avg,
                "ef": new_ef},
               os.path.join(out_dir, f"rank{rank}.pt"))


# ----------------------------------------------------------------------
# data-parallel training
# ----------------------------------------------------------------------
#: the global batch: 4 sequences of 32 tokens (2 rows a rank at world 2)
DP_BATCH, DP_SEQ, DP_LR = 4, 32, 1e-3


def dp_config(arch: str):
    """A reduced float32 config; MoE at capacity factor 8, so that no
    token drops at the full batch's capacity or at a shard's."""
    import dataclasses

    from repro_torch import configs
    cfg = dataclasses.replace(
        configs.reduced_config(configs.get_config(arch)), dtype="float32")
    if cfg.moe is not None:
        cfg = cfg.with_(moe=dataclasses.replace(cfg.moe,
                                                capacity_factor=8.0))
    return cfg


def dp_state(cfg):
    """The train state from seed 0, with LC refs moved off ``a = w`` so
    that the penalty takes part."""
    from repro_torch.launch.steps import init_train_state
    state = init_train_state(torch.Generator().manual_seed(0), cfg)
    g = torch.Generator().manual_seed(1)
    lc = state["lc"]
    for p in lc["a"]:
        lc["a"][p] = lc["a"][p] + 0.01 * torch.randn(lc["a"][p].shape,
                                                     generator=g)
        lc["lam"][p] = 0.01 * torch.randn(lc["a"][p].shape, generator=g)
    lc["mu"] = torch.tensor(0.5)
    return state


def dp_batch(cfg) -> dict:
    from repro_torch.data import TokenStream
    return TokenStream(cfg.vocab_size, DP_BATCH, DP_SEQ).batch_at(3)


def dp_step(arch: str, mesh) -> tuple:
    """One ``make_train_step`` step on the global batch under ``mesh``:
    (metrics, new params)."""
    from repro_torch.distributed.sharding import use_mesh
    from repro_torch.launch.steps import make_train_step
    cfg = dp_config(arch)
    step = make_train_step(cfg, lr=DP_LR)
    with use_mesh(mesh):
        new, metrics = step(dp_state(cfg), dp_batch(cfg))
    return ({k: float(v) for k, v in metrics.items()}, new["params"])


def moe_shard(mesh, inputs: dict, rank: int, world: int):
    """The rank's rows of ``inputs["x"]`` through ``moe_ffn`` over
    ``mesh`` (the batch split over "data")."""
    from repro_torch import configs, interop
    from repro_torch.distributed import sharding
    from repro_torch.models.moe import moe_ffn
    cfg = configs.reduced_config(configs.get_config(inputs["arch"]))
    import dataclasses
    cfg = dataclasses.replace(cfg, dtype="float32")
    params = interop.params_from_numpy(inputs["params"], "cpu")
    x = torch.from_numpy(inputs["x"])
    rows = x.shape[0] // world
    with sharding.use_mesh(mesh), sharding.local_batch("data"):
        y, aux = moe_ffn(params, x[rank * rows:(rank + 1) * rows], cfg,
                         sharding.active_mesh())
    return y, aux


def dp_trainer(mesh, ckpt_dir: str, fail_at: dict):
    """``LCTrainer`` over ``mesh``: reduced phi3-mini, per-layer 4-bit
    quantization of the FFNs, 2 μ × 2 L steps, a checkpoint every step
    and a hard failure at step 3 that outlasts the retries (restored)."""
    from repro_torch.core import (
        AsVector, CompressionTask, LCAlgorithm, exponential_mu_schedule)
    from repro_torch.core.schemes import AdaptiveQuantization
    from repro_torch.data import TokenStream
    from repro_torch.runtime import FaultInjector, LCTrainer, TrainerConfig
    cfg = dp_config("phi3-mini-3.8b")
    lc = LCAlgorithm(
        [CompressionTask("qg", r"stages/.*/w_gate$", AsVector(),
                         AdaptiveQuantization(k=4, iters=5)),
         CompressionTask("qu", r"stages/.*/w_up$", AsVector(),
                         AdaptiveQuantization(k=4, iters=5))],
        exponential_mu_schedule(1e-3, 1.5, 2), device="cpu")
    trainer = LCTrainer(
        cfg, lc, TokenStream(cfg.vocab_size, DP_BATCH, DP_SEQ), mesh=mesh,
        tcfg=TrainerConfig(steps_per_l=2, ckpt_every=1, ckpt_dir=ckpt_dir,
                           lr=DP_LR),
        fault_injector=FaultInjector(fail_at), device="cpu")
    trainer.retry.backoff_s = 0.001
    state, lc_state = trainer.run(0)
    return trainer, state, lc_state


def dp_train(rank, world, inputs_path, out_dir):
    from repro_torch.launch.mesh import make_debug_mesh
    mesh = make_debug_mesh((world, 1), device_type="cpu")
    inputs = torch.load(inputs_path, weights_only=False)
    steps = {arch: dp_step(arch, mesh)
             for arch in ("phi3-mini-3.8b", "jamba-v0.1-52b")}
    y, aux = moe_shard(mesh, inputs, rank, world)
    trainer, state, lc_state = dp_trainer(
        mesh, os.path.join(out_dir, "ckpt"), {3: 5})
    torch.save({"steps": steps, "moe": (y, aux),
                "history": trainer.history,
                "injected": trainer.faults.injected,
                "lc_mesh": trainer.lc.mesh is mesh,
                "params": state["params"],
                "theta": {n: lc_state["tasks"][n]["theta"]
                          for n in lc_state["tasks"]}},
               os.path.join(out_dir, f"rank{rank}.pt"))


# ----------------------------------------------------------------------
# serving over the tensor-parallel "model" axis
# ----------------------------------------------------------------------
#: Server.generate's new tokens and length; the engine's settings
TP_NEW, TP_MAX_LEN = 5, 32
TP_ENGINE = {"slots": 3, "max_len": 32, "prefill_chunk": 4}


def tp_serve_case(cfg, params, prompts, trace, mesh) -> dict:
    """One model served over ``mesh`` (``None``: one process):
    ``Server.generate``'s greedy tokens and prefill logits, and the
    engine's tokens of every request of ``trace``."""
    from repro_torch.runtime.server import Request, Server, ServingEngine
    srv = Server(cfg, params, max_len=TP_MAX_LEN, device="cpu", mesh=mesh)
    res = srv.generate(prompts, TP_NEW, return_logits=True)
    eng = ServingEngine(cfg, params, mesh=mesh, device="cpu", **TP_ENGINE)
    out = eng.run([Request(*r) for r in trace])
    return {"tokens": res.tokens, "logits": res.logits[:, 0].numpy(),
            "engine": {f.id: f.tokens for f in out["finished"]}}


def tp_moe_partial(cfg, params, x, mesh):
    """This rank's partial routed-expert output of the first MoE block
    over ``mesh`` before the sum over "model" (``_moe_local`` on its
    slices of the expert stacks): ``(model rank, y)``."""
    from repro_torch.distributed import sharding
    from repro_torch.models import moe
    from repro_torch.models.transformer import mixer_kinds
    tree = sharding.shard_params(params, cfg, mesh)
    blk = next(tree["stages"][s][p]["ffn"] for s, p in mixer_kinds(cfg)
               if "router" in tree["stages"][s][p].get("ffn", {}))
    e_local = blk["w_gate"].shape[0]
    r = sharding.model_rank(mesh)
    y, _ = moe._moe_local(
        torch.from_numpy(x), blk["router"], blk["w_gate"], blk["w_up"],
        blk["w_down"], cfg, e0=r * e_local if e_local < cfg.moe.n_experts
        else 0, e_local=e_local, capacity=moe.capacity_for(x.shape[0], cfg))
    return r, y


def tp_serve(rank, world, inputs_path, out_dir):
    """Every case of ``inputs`` served over each mesh shape for this world
    size; the MoE cases' partial outputs; at world size 4, the C-step
    problem's ``LCAlgorithm`` over a (2, 2) mesh."""
    from repro_torch.launch.mesh import make_debug_mesh
    inputs = torch.load(inputs_path, weights_only=False)
    out = {}
    for shape in inputs["meshes"][world]:
        mesh = make_debug_mesh(shape, device_type="cpu")
        for name, case in inputs["cases"].items():
            out[(shape, name)] = tp_serve_case(
                case["cfg"], case["params"], inputs["prompts"],
                inputs["trace"], mesh)
            if case["cfg"].moe is not None:
                out[(shape, name, "moe")] = tp_moe_partial(
                    case["cfg"], case["params"], inputs["moe_x"], mesh)
    if world == 4:
        out["cstep"] = run_lc(make_debug_mesh((2, 2), device_type="cpu"))[0]
    torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))


# ----------------------------------------------------------------------
# training over the tensor-parallel "model" axis
# ----------------------------------------------------------------------
#: the global batch and the learning rate of a train step
TPT_BATCH, TPT_SEQ, TPT_LR = 4, 16, 1e-3


def tp_train_step(cfg, state_np: dict, batch_np: dict, mesh) -> dict:
    """One ``make_train_step`` step over ``mesh`` (``None``: one process)
    from the whole state ``state_np`` (numpy, carried over from the
    reference): the metrics, the gradients before clipping and the new
    parameters, each gathered whole."""
    from repro_torch import interop
    from repro_torch.distributed import sharding
    from repro_torch.launch.steps import make_train_step, make_value_and_grad
    state = interop.train_state_from_numpy(state_np, "cpu")
    batch = {k: torch.from_numpy(v) for k, v in batch_np.items()}
    with sharding.use_mesh(mesh):
        local = sharding.shard_train_state(state, cfg, mesh)
        _, _, grads = make_value_and_grad(cfg)(local, batch)
        new, metrics = make_train_step(cfg, lr=TPT_LR)(local, batch)
        return {"metrics": {k: float(v) for k, v in metrics.items()},
                "grads": sharding.gather_params(grads, cfg, mesh),
                "params": sharding.gather_params(new["params"], cfg, mesh),
                "local": new["params"]}


def _clone(tree):
    from repro_torch.tree import tree_map
    return tree_map(lambda x: x.clone() if isinstance(x, torch.Tensor)
                    else x, tree)


class CStepRecorder:
    """Every C step and multiplier step of an ``LCAlgorithm`` (its
    methods wrapped): the weights and the LC state it was given and what
    it returned, copied."""

    def __init__(self, lc):
        self.steps: list = []
        for name in ("c_step", "c_step_async", "multiplier_step",
                     "multiplier_step_async"):
            setattr(lc, name, self._wrap(name, getattr(lc, name)))

    def _wrap(self, name, fn):
        def run(params, state):
            before = _clone((params, state))
            out = fn(params, state)
            self.steps.append((name.replace("_async", ""), *before,
                               _clone(out)))
            return out
        return run


def tpt_trainer(cfg, mesh, compression: str, overlap: str,
                ckpt_dir: str | None = None, tasks=None):
    """``LCTrainer`` over ``mesh`` (``None``: one process): ``launch/
    train.py``'s ``compression`` tasks (or ``tasks()``'s), 2 μ × 2 L
    steps on the reduced config, overlapped or serial, checkpoints in
    ``ckpt_dir``. Returns the trainer, its recorder, the final train
    state gathered whole and the LC state."""
    from repro_torch.core import LCAlgorithm, exponential_mu_schedule
    from repro_torch.data import TokenStream
    from repro_torch.distributed import sharding
    from repro_torch.launch.train import default_tasks
    from repro_torch.runtime import LCTrainer, TrainerConfig
    lc = LCAlgorithm(default_tasks(cfg, compression) if tasks is None
                     else tasks(), exponential_mu_schedule(1e-3, 1.5, 2),
                     device="cpu")
    rec = CStepRecorder(lc)
    trainer = LCTrainer(
        cfg, lc, TokenStream(cfg.vocab_size, TPT_BATCH, TPT_SEQ), mesh=mesh,
        tcfg=TrainerConfig(steps_per_l=2, ckpt_every=100, ckpt_dir=ckpt_dir,
                           lr=TPT_LR, overlap=overlap), device="cpu")
    state, lc_state = trainer.run(0)
    whole = sharding.gather_train_state(state, cfg, mesh,
                                        sharding.DEFAULT_RULES)
    return trainer, rec, whole, lc_state


def tpt_nll(cfg, inputs: dict, mesh, chunk: int) -> dict:
    """``chunked_nll`` over ``mesh`` on this rank's slices of the
    unembedding: the mean NLL, its gradients with respect to the hidden
    state and to the unembedding (gathered whole), and the widest last
    dim of any tensor an op made in the forward and backward passes."""
    from torch.utils._python_dispatch import TorchDispatchMode

    from repro_torch import interop
    from repro_torch.distributed import sharding
    from repro_torch.models.transformer import chunked_nll
    from repro_torch.tree import tree_leaves

    class Widest(TorchDispatchMode):
        widest = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            for t in tree_leaves(out if isinstance(out, (tuple, list))
                                 else [out]):
                if isinstance(t, torch.Tensor) and t.ndim:
                    Widest.widest = max(Widest.widest, t.shape[-1])
            return out

    embed = interop.params_from_numpy({"embed": inputs["embed"]}, "cpu")
    hidden = torch.from_numpy(inputs["hidden"]).requires_grad_(True)
    labels = torch.from_numpy(inputs["labels"])
    with sharding.use_mesh(mesh):
        local = sharding.shard_params(embed, cfg, mesh,
                                      sharding.DEFAULT_RULES)
        leaves = tree_leaves(local)
        for x in leaves:
            x.requires_grad_(True)
        with Widest():
            total, count = chunked_nll(local, hidden, labels, cfg,
                                       chunk=chunk)
            loss = total / count
            grads = torch.autograd.grad(loss, [hidden] + leaves)
        it = iter(grads[1:])
        from repro_torch.tree import tree_map
        g_embed = tree_map(lambda _: next(it), local)
        whole = sharding.gather_params(g_embed, cfg, mesh,
                                       sharding.DEFAULT_RULES)
    return {"loss": float(loss.detach()), "d_hidden": grads[0],
            "d_embed": whole,
            "widest": Widest.widest}


def forms_tree(cfg) -> dict:
    """The reduced tree of ``cfg`` (unrolled) with weight forms for its
    matrices, from seeds: 4-bit ``w_gate`` and ``wo``, sparse ``w_up``
    and ``w_down`` (row-major COO), 8-bit ``wv`` and low-rank ``wq`` and
    ``wk``; split by ``shard_params`` by columns and by rows."""
    from repro_torch.kernels.quant_matmul import ops as qops
    from repro_torch.models.transformer import init_params
    from repro_torch.runtime import compressed as forms
    params = init_params(torch.Generator().manual_seed(0), cfg)
    g = torch.Generator().manual_seed(5)

    def quant(w, bits):
        codes = 16 if bits == 4 else 64
        idx = torch.randint(0, codes, tuple(w.shape), generator=g,
                            dtype=torch.uint8)
        return forms.QuantizedWeight(
            qops.pack4(idx) if bits == 4 else idx,
            torch.sort(torch.randn(codes, generator=g)).values,
            tuple(w.shape), bits)

    def sparse(w):
        dense = torch.where(torch.rand(w.shape, generator=g) < 0.3, w, 0.0)
        rows, cols = torch.nonzero(dense, as_tuple=True)
        return forms.SparseWeight(dense[rows, cols], rows.to(torch.int32),
                                  cols.to(torch.int32), tuple(w.shape))

    def lowrank(w):
        return forms.LowRankWeight(torch.randn(w.shape[0], 3, generator=g),
                                   torch.randn(3, w.shape[1], generator=g))

    for blk in params["stages"]["s0"].values():
        f, a = blk["ffn"], blk["mixer"]
        f["w_gate"], f["w_up"] = quant(f["w_gate"], 4), sparse(f["w_up"])
        f["w_down"] = sparse(f["w_down"])
        a["wq"], a["wk"] = lowrank(a["wq"]), lowrank(a["wk"])
        a["wv"], a["wo"] = quant(a["wv"], 8), quant(a["wo"], 4)
    return params


def tp_train(rank, world, inputs_path, out_dir):
    """One train step of every case over each mesh shape for this world
    size and the vocabulary-parallel loss; at world size 2 the trainer
    over (1, 2): quantization serial (checkpointed) and overlapped, ℓ0
    serial, and the one-process run's checkpoint restored."""
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.distributed import sharding
    from repro_torch.launch.mesh import make_debug_mesh
    inputs = torch.load(inputs_path, weights_only=False)
    out = {}
    for shape in inputs["meshes"][world]:
        mesh = make_debug_mesh(shape, device_type="cpu")
        for name, case in inputs["cases"].items():
            if shape in case["meshes"]:
                out[(shape, name)] = tp_train_step(
                    case["cfg"], case["state"], case["batch"], mesh)
        for name, case in inputs["nll"].items():
            if shape[0] == 1:
                out[(shape, "nll", name)] = tpt_nll(
                    case["cfg"], case, mesh, inputs["chunk"])
        if shape[0] == 1:
            from repro_torch.distributed import sharding
            cfg = inputs["forms_cfg"][world]
            out[(shape, "forms")] = sharding.gather_params(
                sharding.shard_params(forms_tree(cfg), cfg, mesh), cfg,
                mesh)
    if world == 2:
        cfg = inputs["trainer_cfg"]
        mesh = make_debug_mesh((1, 2), device_type="cpu")
        for compression, overlap in (("quantize", "off"),
                                     ("quantize", "on"),
                                     ("prune", "off")):
            ckpt = (os.path.join(out_dir, "ckpt_mesh")
                    if overlap == "off" and compression == "quantize"
                    else None)
            trainer, rec, whole, lc_state = tpt_trainer(
                cfg, mesh, compression, overlap, ckpt)
            out[("trainer", compression, overlap)] = {
                "history": trainer.history, "state": whole,
                "lc_state": lc_state, "steps": rec.steps,
                "compressed": trainer.compressed_params(
                    sharding.shard_train_state(whole, cfg, mesh),
                    lc_state)}
        template = sharding.shard_train_state(
            out[("trainer", "quantize", "off")]["state"], cfg, mesh)
        out["restored"] = CheckpointManager(
            inputs["one_process_ckpt"], cfg=cfg, mesh=mesh).restore(
                template)[0]
    torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))


# ----------------------------------------------------------------------
# the SSM mixers' "inner" split over the "model" axis
# ----------------------------------------------------------------------
#: the weight forms of the segmented round trip
SSM_FORMS = ("quant4", "quant8", "sparse", "lowrank", "dense")


def ssm_tasks():
    """The SSM trainers' task: per-layer 4-entry codebooks (3 Lloyd
    steps) on the leaves that split in segments (Mamba's ``in_proj``,
    mLSTM's ``up_proj``, sLSTM's ``w``)."""
    from repro_torch.core import AsStacked, CompressionTask
    from repro_torch.core.schemes import AdaptiveQuantization
    return [CompressionTask("quantize-segments",
                            r"mixer/(in_proj|up_proj|w)$",
                            AsStacked("vector"),
                            AdaptiveQuantization(k=4, iters=3))]


def ssm_forms_tree(cfg, form: str) -> dict:
    """The reduced tree of ``cfg`` (unrolled) with every 2-D leaf of its
    SSM mixers that the model applies as a product in ``form`` (from
    seeds; ``conv_w`` and ``A_log`` stay dense, as ``launch/serve.py``
    keeps them)."""
    from repro_torch.models.transformer import init_params, mixer_kinds
    params = init_params(torch.Generator().manual_seed(0), cfg)
    g = torch.Generator().manual_seed(6)
    for (s, p), kind in mixer_kinds(cfg).items():
        if kind not in ("mamba", "mlstm", "slstm"):
            continue
        mix = params["stages"][s][p]["mixer"]
        for name, leaf in mix.items():
            if leaf.ndim == 2 and name not in ("conv_w", "A_log"):
                mix[name] = _as_form(leaf, form, g)
    return params


def _as_form(w, form: str, g):
    from repro_torch.kernels.quant_matmul import ops as qops
    from repro_torch.runtime import compressed as forms
    if form.startswith("quant"):
        bits = int(form[5:])
        codes = 16 if bits == 4 else 64
        idx = torch.randint(0, codes, tuple(w.shape), generator=g,
                            dtype=torch.uint8)
        return forms.QuantizedWeight(
            qops.pack4(idx) if bits == 4 else idx,
            torch.sort(torch.randn(codes, generator=g)).values,
            tuple(w.shape), bits)
    if form == "sparse":
        dense = torch.where(torch.rand(w.shape, generator=g) < 0.3, w, 0.0)
        rows, cols = torch.nonzero(dense, as_tuple=True)
        return forms.SparseWeight(dense[rows, cols], rows.to(torch.int32),
                                  cols.to(torch.int32), tuple(w.shape))
    if form == "lowrank":
        return forms.LowRankWeight(torch.randn(w.shape[0], 3, generator=g),
                                   torch.randn(3, w.shape[1], generator=g))
    return w


def tp_ssm(rank, world, inputs_path, out_dir):
    """The SSM cases of ``inputs`` over each mesh shape for this world
    size: served (``tp_serve_case``), one train step
    (``tp_train_step``), every form's segmented tree split and gathered
    back, the one-process checkpoint restored; at world size 2 the
    trainer over (1, 2) (checkpointed), its C steps recorded."""
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.distributed import sharding
    from repro_torch.launch.mesh import make_debug_mesh
    inputs = torch.load(inputs_path, weights_only=False)
    out = {}
    for shape in inputs["meshes"][world]:
        mesh = make_debug_mesh(shape, device_type="cpu")
        for name, case in inputs["serve"].items():
            out[(shape, "serve", name)] = tp_serve_case(
                case["cfg"], case["params"], inputs["prompts"],
                inputs["trace"], mesh)
        for name, case in inputs["train"].items():
            out[(shape, "train", name)] = tp_train_step(
                case["cfg"], case["state"], case["batch"], mesh)
        if shape[0] == 1:
            for name, cfg in inputs["forms"].items():
                for form in SSM_FORMS:
                    whole = ssm_forms_tree(cfg, form)
                    out[(shape, "forms", name, form)] = \
                        sharding.gather_params(sharding.shard_params(
                            whole, cfg, mesh), cfg, mesh)
            for name, case in inputs["trainer"].items():
                template = sharding.shard_train_state(
                    case["template"], case["cfg"], mesh)
                out[(shape, "restored", name)] = CheckpointManager(
                    case["ckpt"], cfg=case["cfg"], mesh=mesh).restore(
                        template)[0]
    if world == 2:
        mesh = make_debug_mesh((1, 2), device_type="cpu")
        for name, case in inputs["trainer"].items():
            trainer, rec, whole, lc_state = tpt_trainer(
                case["cfg"], mesh, "quantize", "off",
                os.path.join(out_dir, f"ckpt_{name}"), ssm_tasks)
            out[("trainer", name)] = {"history": trainer.history,
                                      "state": whole, "lc_state": lc_state,
                                      "steps": rec.steps}
    torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))


# ----------------------------------------------------------------------
# the dry run's collectives against a real step's
# ----------------------------------------------------------------------
def dryrun_config():
    """Reduced phi3-mini in float32, for the dry run's collectives."""
    from repro_torch import configs
    return configs.reduced_config(
        configs.get_config("phi3-mini-3.8b")).with_(dtype="float32")


DRYRUN_SHAPES = {"prefill": (16, 4), "train": (16, 4)}   # (seq, batch)


def dryrun_collectives(rank, world, shape, out_dir):
    """A real prefill and train step of :func:`dryrun_config` on this
    rank of a gloo mesh of ``shape`` under the op counter; writes each
    step's collectives as (primitive, bytes, group size) lists."""
    from repro_torch.analysis import op_stats
    from repro_torch.distributed import sharding
    from repro_torch.launch import inputs
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.launch.steps import (
        init_train_state, make_prefill_step, make_train_step)
    from repro_torch.models.transformer import init_params
    cfg = dryrun_config()
    mesh = make_debug_mesh(shape, device_type="cpu")
    gen = torch.Generator().manual_seed(0)
    out = {}
    s, b = DRYRUN_SHAPES["prefill"]
    params = sharding.shard_params(init_params(gen, cfg), cfg, mesh,
                                   sharding.SERVE_RULES)
    rows = inputs.local_rows(b, mesh, sharding.SERVE_RULES)
    toks = torch.randint(0, cfg.vocab_size, (rows, s), generator=gen,
                         dtype=torch.int32)
    with sharding.use_mesh(mesh, sharding.SERVE_RULES):
        st = op_stats.analyze_step(make_prefill_step(cfg), params, toks)
    out["prefill"] = [(c.primitive, c.bytes, c.size)
                      for c in st.collectives]
    s, b = DRYRUN_SHAPES["train"]
    state = sharding.shard_train_state(init_train_state(gen, cfg), cfg,
                                       mesh, sharding.DEFAULT_RULES)
    batch = {k: torch.randint(0, cfg.vocab_size, (b, s), generator=gen)
             for k in ("inputs", "labels")}
    with sharding.use_mesh(mesh, sharding.DEFAULT_RULES):
        st = op_stats.analyze_step(make_train_step(cfg), state, batch)
    out["train"] = [(c.primitive, c.bytes, c.size) for c in st.collectives]
    torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
