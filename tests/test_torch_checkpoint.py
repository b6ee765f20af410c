"""The port's checkpoints, fault-tolerance policies and data pipeline:
mirrors of ``tests/test_substrate.py``'s checkpoint, retry, straggler and
data tests, and checkpoints crossing between the two packages (one
on-disk layout: each reads what the other writes, bit for bit).
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import CheckpointManager as JCheckpointManager
from repro_torch import interop
from repro_torch.checkpoint import CheckpointManager
from repro_torch.data import (Prefetcher, TokenStream, embedding_stream,
                              teacher_classification)
from repro_torch.runtime import FaultInjector, RetryPolicy, StragglerMonitor
from torch_threads import _one_torch_thread  # noqa: F401


def _state(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {"params": {"w": torch.randn((8, 4), generator=g),
                       "b": torch.zeros((4,))},
            "lc": {"a": {"stages/s0/w": torch.randn((3, 2), generator=g)},
                   "mu": torch.tensor(1e-4)},
            "step": torch.tensor(7, dtype=torch.int32)}


def _assert_equal(a, b):
    la, lb = (jax.tree_util.tree_leaves(interop.to_numpy(x)) for x in (a, b))
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert x.dtype == y.dtype
        np.testing.assert_array_equal(x, y)


# ----------------------------------------------------------------------
# checkpoint (mirrors of tests/test_substrate.py)
# ----------------------------------------------------------------------
def test_checkpoint_roundtrip(tmp_path):
    mgr = CheckpointManager(str(tmp_path), async_save=False)
    st = _state()
    mgr.save(st, 10)
    restored, step = mgr.restore(st)
    assert step == 10
    _assert_equal(restored, st)
    assert isinstance(restored["params"]["w"], torch.Tensor)
    assert set(os.listdir(tmp_path / "step_00000010")) >= {
        "manifest.json", "_COMPLETE", "params::w.npy",
        "lc::a::stages::s0::w.npy"}


def test_checkpoint_incomplete_ignored(tmp_path):
    mgr = CheckpointManager(str(tmp_path), async_save=False)
    mgr.save(_state(), 10)
    os.makedirs(os.path.join(str(tmp_path), "step_00000020"))
    assert mgr.latest_step() == 10


def test_checkpoint_keep_last(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep_last=2, async_save=False)
    for s in (1, 2, 3, 4):
        mgr.save(_state(), s)
    assert mgr.steps() == [3, 4]


def test_checkpoint_async(tmp_path):
    mgr = CheckpointManager(str(tmp_path), async_save=True)
    mgr.save(_state(), 5)
    mgr.wait()
    assert mgr.latest_step() == 5


def test_checkpoint_restores_onto_the_template_devices(tmp_path):
    mgr = CheckpointManager(str(tmp_path), async_save=False)
    st = _state()
    mgr.save(st, 1)
    template = interop.train_state_from_numpy(interop.to_numpy(st), "meta")
    restored, _ = mgr.restore(template)
    assert all(t.device.type == "meta"
               for t in jax.tree_util.tree_leaves(restored))
    with pytest.raises(FileNotFoundError):
        CheckpointManager(str(tmp_path / "empty")).restore(st)


def test_checkpoint_background_save_error_surfaces(tmp_path):
    mgr = CheckpointManager(str(tmp_path), async_save=True)
    st = _state()
    mgr.save(st, 1)
    mgr.wait()
    squatter = os.path.join(str(tmp_path), "step_00000002.tmp")
    with open(squatter, "w") as f:
        f.write("not a directory")
    mgr.save(st, 2)
    with pytest.raises(RuntimeError, match="background checkpoint"):
        mgr.wait()
    os.remove(squatter)
    mgr.save(st, 3)
    mgr.wait()
    assert 3 in mgr.steps()


# ----------------------------------------------------------------------
# checkpoints across the two packages
# ----------------------------------------------------------------------
def test_jax_checkpoint_restored_by_the_port(tmp_path):
    jst = {"params": {"w": jax.random.normal(jax.random.PRNGKey(0), (8, 4)),
                      "b": jnp.zeros((4,))},
           "lc": {"a": {"stages/s0/w": jnp.ones((3, 2))},
                  "mu": jnp.float32(1e-4)},
           "step": jnp.int32(7)}
    JCheckpointManager(str(tmp_path), async_save=False).save(jst, 3)
    template = _state()
    restored, step = CheckpointManager(str(tmp_path)).restore(template)
    assert step == 3
    _assert_equal(restored, interop.train_state_from_numpy(
        jax.tree_util.tree_map(np.asarray, jst), "cpu"))
    assert restored["step"].dtype == torch.int32


def test_port_checkpoint_restored_by_jax(tmp_path):
    st = _state(1)
    CheckpointManager(str(tmp_path), async_save=False).save(st, 4)
    template = jax.tree_util.tree_map(jnp.asarray, interop.to_numpy(st))
    restored, step = JCheckpointManager(str(tmp_path)).restore(template)
    assert step == 4
    for x, y in zip(jax.tree_util.tree_leaves(restored),
                    jax.tree_util.tree_leaves(interop.to_numpy(st))):
        np.testing.assert_array_equal(np.asarray(x), y)


# ----------------------------------------------------------------------
# fault tolerance (a copy of the reference's module: same behaviour)
# ----------------------------------------------------------------------
def test_retry_policy_recovers():
    inj = FaultInjector({3: 2})
    calls = []

    def step():
        calls.append(1)
        inj.maybe_fail(3)
        return "ok"

    assert RetryPolicy(max_retries=3, backoff_s=0.001).run(step) == "ok"
    assert len(calls) == 3


def test_retry_policy_exhausts():
    inj = FaultInjector({0: 99})
    with pytest.raises(RuntimeError):
        RetryPolicy(max_retries=2, backoff_s=0.001).run(
            lambda: inj.maybe_fail(0))


def test_straggler_monitor():
    m = StragglerMonitor(factor=3.0)
    for _ in range(10):
        m.observe(0.1)
    assert m.observe(1.0) is True
    assert m.stragglers == 1
    assert m.observe(0.1) is False


def test_straggler_monitor_honors_window():
    m = StragglerMonitor(window=128)
    for _ in range(100):
        m.observe(0.1)
    assert m.times.maxlen == 128 and len(m.times) == 100
    m_small = StragglerMonitor(window=8)
    for _ in range(100):
        m_small.observe(0.1)
    assert len(m_small.times) == 8


# ----------------------------------------------------------------------
# data
# ----------------------------------------------------------------------
def test_tokenstream_seekable_deterministic():
    ds = TokenStream(vocab_size=512, batch=4, seq_len=32, seed=3)
    b1 = ds.batch_at(17)
    b2 = TokenStream(vocab_size=512, batch=4, seq_len=32, seed=3).batch_at(17)
    assert torch.equal(b1["inputs"], b2["inputs"])
    assert not torch.equal(b1["inputs"], ds.batch_at(18)["inputs"])
    assert not torch.equal(
        b1["inputs"],
        TokenStream(vocab_size=512, batch=4, seq_len=32, seed=4)
        .batch_at(17)["inputs"])
    # labels are next-token shifted inputs
    assert torch.equal(b1["inputs"][:, 1:], b1["labels"][:, :-1])
    assert b1["inputs"].shape == (4, 32)
    assert int(b1["inputs"].min()) >= 0 and int(b1["inputs"].max()) < 512


def test_tokenstream_has_the_markov_structure():
    """Tokens ≡ states mod n_states when vocab is a multiple of it, and
    the Zipf lift puts most of the mass on the lowest blocks."""
    ds = TokenStream(vocab_size=1024, batch=8, seq_len=256, n_states=64)
    toks = ds.batch_at(0)["inputs"]
    blocks = toks // 64
    assert float((blocks == 0).float().mean()) > 0.2
    # the bigram kernel is far from uniform: few successors per state
    pairs = set(zip((toks[:, :-1] % 64).flatten().tolist(),
                    (toks[:, 1:] % 64).flatten().tolist()))
    assert len(pairs) < 0.5 * 64 * 64


def test_prefetcher_batches_equal_direct_ones():
    ds = TokenStream(vocab_size=300, batch=2, seq_len=16, seed=1)
    pf = Prefetcher(ds)
    for s in (0, 1, 5):
        pf.prefetch(s)
    pf.prefetch(1)                  # idempotent
    for s in (5, 0, 1, 2):          # 2 was never prefetched: a miss
        got = pf.batch_at(s)
        want = ds.batch_at(s)
        assert torch.equal(got["inputs"], want["inputs"])
        assert torch.equal(got["labels"], want["labels"])
    for s in range(Prefetcher.MAX_SLOTS + 3):
        pf.prefetch(100 + s)
    assert len(pf._pending) <= Prefetcher.MAX_SLOTS
    # a callable source works too, and errors surface on consumption
    pf2 = Prefetcher(lambda step: 1 // step)
    pf2.prefetch(0)
    with pytest.raises(ZeroDivisionError):
        pf2.batch_at(0)


def test_teacher_classification_learnable():
    x, y = teacher_classification(512, d=32, classes=4, seed=1,
                                  device="cpu")
    assert x.shape == (512, 32) and y.shape == (512,)
    assert len(torch.unique(y)) == 4


def test_embedding_stream_seekable():
    fn = embedding_stream(2, 8, 16, 100, seed=2)
    a, b = fn(3), fn(3)
    assert a["inputs"].dtype == torch.bfloat16
    assert a["inputs"].shape == (2, 8, 16) and a["labels"].shape == (2, 8)
    assert torch.equal(a["inputs"], b["inputs"])
    assert not torch.equal(a["labels"], fn(4)["labels"])
