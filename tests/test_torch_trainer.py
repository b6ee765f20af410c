"""The port's LCTrainer: record by record against the JAX package's serial
trainer, and mirrors of ``tests/test_trainer_overlap.py`` (the overlapped
pipeline, hard-failure restore, kill and resume) and of
``tests/test_substrate.py``'s fault-recovery run.

Both trainers start from the same numbers (the reference's train state
carried over with ``interop.train_state_from_numpy``) and read the same
batches (the JAX ``TokenStream``'s, handed over as numpy). Tolerances
per record: ``loss``/``ce``/``penalty_start`` rtol 1e-4 (six AdamW steps
of float32 training, summed in other orders), each task's distortion
rtol 1e-3 (a k-means C step on weights that differ by that much),
``compression_ratio`` equal; no §7 violation in either package.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.core import (AsVector as JAsVector,
                        CompressionTask as JCompressionTask,
                        LCAlgorithm as JLCAlgorithm,
                        exponential_mu_schedule as jmu)
from repro.core.schemes import ConstraintL0Pruning as JConstraintL0Pruning
from repro.data import TokenStream as JTokenStream
from repro.launch import steps as jsteps
from repro.launch import train as jtrain
from repro.optim import AdamW as JAdamW
from repro.runtime import (LCTrainer as JLCTrainer,
                           TrainerConfig as JTrainerConfig)
from repro_torch import interop
from repro_torch.configs import get_config, reduced_config
from repro_torch.core import (AsVector, CompressionTask, LCAlgorithm,
                              exponential_mu_schedule)
from repro_torch.core.schemes import AdaptiveQuantization
from repro_torch.data import TokenStream
from repro_torch.launch import train as ttrain
from repro_torch.runtime import FaultInjector, LCTrainer, TrainerConfig
from repro_torch.tree import tree_leaves

KEY = 0
ARCH = "phi3-mini-3.8b"
CFG = reduced_config(get_config(ARCH)).with_(pattern_reps=1,
                                              dtype="float32")


# ----------------------------------------------------------------------
# the serial trainer against the JAX package's
# ----------------------------------------------------------------------
class _Handed:
    """The JAX stream's batches, as numpy."""

    def __init__(self, stream):
        self.stream = stream

    def batch_at(self, step):
        return jax.tree_util.tree_map(lambda x: np.array(x, copy=True),
                                      self.stream.batch_at(step))


@pytest.mark.parametrize("compression", ["quantize", "prune"])
def test_serial_trainer_matches_reference_record_by_record(compression):
    jcfg = dataclasses.replace(
        jconfigs.reduced_config(jconfigs.get_config(ARCH)),
        dtype="float32", pattern_reps=2)
    tcfg = reduced_config(get_config(ARCH)).with_(dtype="float32",
                                                   pattern_reps=2)
    ttasks = ttrain.default_tasks(tcfg, compression)
    if compression == "quantize":
        jtasks = jtrain.default_tasks(jcfg, compression)
    else:
        # the reference's default_tasks(cfg, "prune") builds its scheme
        # with κ = 0, which the scheme refuses: the same task by hand
        t = ttasks[0]
        assert t.scheme.kappa == int(0.05 * 2 * (4 * 64 * 32 + 3 * 64 * 128))
        jtasks = [JCompressionTask(t.name, t.pattern, JAsVector(),
                                   JConstraintL0Pruning(t.scheme.kappa))]
    stream = JTokenStream(jcfg.vocab_size, 2, 16)
    mus = (9e-5, 1.2, 2)
    jt = JLCTrainer(jcfg, JLCAlgorithm(jtasks, jmu(*mus)), stream,
                    tcfg=JTrainerConfig(steps_per_l=3, lr=1e-3))
    jt.run(jax.random.PRNGKey(KEY))

    state = jax.tree_util.tree_map(
        np.asarray, jsteps.init_train_state(jax.random.PRNGKey(KEY), jcfg,
                                            JAdamW()))
    tt = LCTrainer(tcfg, LCAlgorithm(ttasks, exponential_mu_schedule(*mus),
                                     device="cpu"),
                   _Handed(stream), tcfg=TrainerConfig(steps_per_l=3,
                                                       lr=1e-3),
                   device="cpu")
    tt.run(KEY, state=interop.train_state_from_numpy(state, "cpu"))

    assert len(tt.history) == len(jt.history) == 2
    for ours, theirs in zip(tt.history, jt.history):
        assert set(ours) == set(theirs)
        assert ours["lc_step"] == theirs["lc_step"]
        assert ours["mu"] == theirs["mu"]
        for k in ("loss", "ce", "penalty_start"):
            np.testing.assert_allclose(ours[k], theirs[k], rtol=1e-4,
                                       err_msg=k)
        assert set(ours["distortion"]) == set(theirs["distortion"])
        for n, d in theirs["distortion"].items():
            np.testing.assert_allclose(ours["distortion"][n], d, rtol=1e-3,
                                       err_msg=n)
        assert ours["compression_ratio"] == theirs["compression_ratio"]
        assert ours["c_step_violations"] == theirs["c_step_violations"] == []


# ----------------------------------------------------------------------
# mirrors of tests/test_trainer_overlap.py
# ----------------------------------------------------------------------
def _make_trainer(tmp_path=None, overlap="off", n_mu=2, steps_per_l=3,
                  fault_injector=None, swap_after=None, ckpt_every=2,
                  mu0=1e-4, mu_a=1.5, lr=3e-4):
    data = TokenStream(CFG.vocab_size, 2, 16)
    lc = LCAlgorithm(
        [CompressionTask("qg", r"stages/.*/w_gate$", AsVector(),
                         AdaptiveQuantization(k=2, iters=5)),
         CompressionTask("qu", r"stages/.*/w_up$", AsVector(),
                         AdaptiveQuantization(k=2, iters=5))],
        exponential_mu_schedule(mu0, mu_a, n_mu), device="cpu")
    tcfg = TrainerConfig(steps_per_l=steps_per_l, ckpt_every=ckpt_every,
                         ckpt_dir=str(tmp_path) if tmp_path else None,
                         overlap=overlap, swap_after=swap_after, lr=lr)
    return LCTrainer(CFG, lc, data, tcfg=tcfg,
                     fault_injector=fault_injector, device="cpu")


def _assert_trees_equal(a, b, what):
    la, lb = tree_leaves(a), tree_leaves(b)
    assert len(la) == len(lb), what
    for x, y in zip(la, lb):
        assert torch.equal(x, y), what


def test_overlap_off_bit_identical_to_manual_serial_loop():
    trainer = _make_trainer(overlap="off")
    state, lc_state = trainer.run(KEY)

    ref = _make_trainer(overlap="off")
    st = ref.init_state(KEY)
    lc_st = ref._lc_state
    gs = 0
    for k, mu in enumerate(ref.lc.mu_schedule):
        lc_st = ref.lc.set_mu(lc_st, mu, k)
        st["lc"] = ref._refs_from_lc(st["params"], lc_st)
        for i in range(ref.tcfg.steps_per_l):
            st, _ = ref._train_step(st, ref.data.batch_at(gs + i))
        gs += ref.tcfg.steps_per_l
        lc_st = ref.lc.c_step(st["params"], lc_st)
        lc_st = ref.lc.multiplier_step(st["params"], lc_st)
        st["lc"] = ref._refs_from_lc(st["params"], lc_st)

    _assert_trees_equal(state["params"], st["params"], "params")
    _assert_trees_equal(state["opt"], st["opt"], "opt state")
    _assert_trees_equal(state["lc"], st["lc"], "penalty refs")
    _assert_trees_equal(lc_state, lc_st, "LC state")
    assert int(state["step"]) == gs


def test_async_steps_equal_the_serial_ones_and_write_nothing():
    """c_step_async / multiplier_step_async give the serial steps' Θ, a
    and λ bit for bit, in new tensors, leaving their input as it was."""
    trainer = _make_trainer()
    st = trainer.init_state(KEY)
    lc = trainer.lc
    lc0 = lc.set_mu(trainer._lc_state, 1e-3, 0)
    params = st["params"]
    before = [t.clone() for t in tree_leaves(lc0)]
    got = lc.multiplier_step_async(params, lc.c_step_async(params, lc0))
    assert all(torch.equal(x, y) for x, y in zip(before, tree_leaves(lc0)))
    want = lc.multiplier_step(params, lc.c_step(params, lc0))
    _assert_trees_equal(got, want, "async against serial")


def test_overlapped_run_converges_with_clean_monitors():
    trainer = _make_trainer(overlap="on", n_mu=4, steps_per_l=6,
                            mu0=0.5, mu_a=4.0, lr=0.05)
    state, lc_state = trainer.run(KEY)

    assert len(trainer.history) == 4
    assert [h["lc_step"] for h in trainer.history] == [0, 1, 2, 3]
    for h in trainer.history:
        assert h["c_step_violations"] == []
        assert np.isfinite(h["loss"])
        assert h["c_step_ms"] >= 0.0
    dist = [sum(h["distortion"].values()) for h in trainer.history]
    assert all(b < a for a, b in zip(dist, dist[1:])), dist
    assert int(state["step"]) == 24
    assert float(state["lc"]["mu"]) == pytest.approx(float(lc_state["mu"]))


def test_overlap_swap_after_forces_fixed_window():
    trainer = _make_trainer(overlap="on", n_mu=3, steps_per_l=3,
                            swap_after=2)
    trainer.run(KEY)
    swaps = [h["swap_after_microbatches"] for h in trainer.history]
    assert swaps[:-1] == [2, 2]
    assert swaps[-1] is None


def test_overlap_rejects_bad_mode():
    with pytest.raises(ValueError, match="overlap"):
        _make_trainer(overlap="sometimes")


def test_trainer_refuses_a_mesh_and_a_foreign_device():
    lc = LCAlgorithm([], [1e-3], device="cpu")
    data = TokenStream(CFG.vocab_size, 2, 16)
    with pytest.raises(NotImplementedError, match="item 14"):
        LCTrainer(CFG, lc, data, mesh=object(), device="cpu")
    with pytest.raises(ValueError, match="runs on cpu"):
        LCTrainer(CFG, lc, data, device="meta")


def test_hard_failure_restore_rewinds_and_resyncs(tmp_path):
    trainer = _make_trainer(tmp_path=tmp_path, n_mu=2, steps_per_l=4,
                            fault_injector=FaultInjector({3: 5}))
    trainer.retry.backoff_s = 0.001
    state, lc_state = trainer.run(KEY)

    assert trainer.faults.injected == 5
    assert len(trainer.history) == 2
    assert int(state["step"]) == 8
    assert all(isinstance(l, torch.Tensor) and l.device.type == "cpu"
               for l in tree_leaves(state["params"]))
    for t in trainer.lc.tasks:
        ts = lc_state["tasks"][t.name]
        for p in t.paths:
            assert torch.equal(state["lc"]["lam"][p], ts["lam"][p])
            assert torch.equal(state["lc"]["a"][p], ts["a"][p])
    assert np.isfinite(trainer.history[-1]["loss"])


def test_hard_failure_gives_up_after_max_restores(tmp_path):
    trainer = _make_trainer(tmp_path=tmp_path, n_mu=1, steps_per_l=4,
                            fault_injector=FaultInjector({3: 10_000}))
    trainer.retry.backoff_s = 0.001
    with pytest.raises(RuntimeError, match="injected fault"):
        trainer.run(KEY)
    assert trainer.faults.injected == 4 * (trainer.tcfg.max_restores + 1)


def test_kill_and_resume_restores_consistent_state(tmp_path):
    t1 = _make_trainer(tmp_path=tmp_path, n_mu=1, steps_per_l=4)
    s1, lc1 = t1.run(KEY)
    assert t1.ckpt.latest_step() == 4  # blocking final save

    t2 = _make_trainer(tmp_path=tmp_path, n_mu=2, steps_per_l=4)
    s2 = t2.init_state(KEY)
    mu1 = t2.lc.mu_schedule[1]
    t2._lc_state = t2.lc.set_mu(t2._lc_state, mu1, 1)
    s2["lc"] = t2._refs_from_lc(s2["params"], t2._lc_state)
    restored, next_step = t2._restore_state(s2)

    assert next_step == 4
    assert int(restored["step"]) == 4
    for new, old in zip(tree_leaves(restored["params"]),
                        tree_leaves(s2["params"])):
        assert new.device == old.device and new.dtype == old.dtype
    assert torch.equal(restored["params"]["final_norm"],
                       s1["params"]["final_norm"])
    assert float(restored["lc"]["mu"]) == pytest.approx(float(mu1))
    out, _, gs = t2._l_step(restored, 1, next_step)
    assert gs == next_step + 4
    assert int(out["step"]) == next_step + 4


def test_overlap_smoke_two_lc_steps_no_violations():
    trainer = _make_trainer(overlap="on", n_mu=2, steps_per_l=2)
    trainer.run(KEY)
    assert len(trainer.history) == 2
    assert all(h["c_step_violations"] == [] for h in trainer.history)


# ----------------------------------------------------------------------
# mirror of tests/test_substrate.py::test_trainer_recovers_from_injected_faults
# ----------------------------------------------------------------------
def test_trainer_recovers_from_injected_faults(tmp_path):
    data = TokenStream(CFG.vocab_size, 2, 16)
    lc = LCAlgorithm(
        [CompressionTask("q", r"stages/.*/w_gate$", AsVector(),
                         AdaptiveQuantization(k=2, iters=5))],
        exponential_mu_schedule(1e-4, 1.2, 2), device="cpu")
    trainer = LCTrainer(
        CFG, lc, data,
        tcfg=TrainerConfig(steps_per_l=3, ckpt_every=2,
                           ckpt_dir=str(tmp_path)),
        fault_injector=FaultInjector({1: 1, 4: 2}), device="cpu")
    trainer.retry.backoff_s = 0.001
    trainer.run(KEY)
    assert len(trainer.history) == 2
    assert trainer.faults.injected == 3
    assert np.isfinite(trainer.history[-1]["loss"])


def test_compressed_params_put_the_decompressed_weights_in():
    trainer = _make_trainer(n_mu=1, steps_per_l=1)
    state, lc_state = trainer.run(KEY)
    out = trainer.compressed_params(state, lc_state)
    w = out["stages"]["s0"]["pos0"]["ffn"]["w_gate"]
    assert len(torch.unique(w)) <= 2            # k = 2 codebook
    assert torch.equal(out["final_norm"], state["params"]["final_norm"])


def test_train_cli_runs_and_reports(capsys):
    trainer = ttrain.main(["--arch", ARCH, "--reduced", "--lc-steps", "2",
                           "--steps-per-l", "3", "--device", "cpu"])
    assert len(trainer.history) == 2
    assert all(h["c_step_violations"] == [] for h in trainer.history)
    assert "final compression ratio" in capsys.readouterr().out
