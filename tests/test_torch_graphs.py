"""The port's serving programs as they run on the card, checked on the CPU:
``Server.generate`` with its position a device tensor (the form its
decode graph needs) against the JAX package and against the loop with
an int position, every engine program returning the very cache tensors
it was given, the capture helper's launch accounting with stand-in
counters and graphs, and ``graphs=True`` refused on the CPU.

Models: reduced float32 phi3-mini-3.8b (2 unrolled layers) with every
2-D matrix in one serving form (quant4, quant8, sparse), and reduced
mixtral-8x7b, deepseek-moe-16b, minicpm3-4b, jamba-v0.1-52b and
xlstm-125m with dense weights.

Tolerances: greedy tokens are equal token for token; cache tensors are
the same tensors (``data_ptr``, leaf by leaf).
"""
import contextlib
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.runtime import compressed as jforms
from repro.runtime import server as jserver
from repro_torch import configs as tconfigs
from repro_torch import graphs
from repro_torch.kernels import build
from repro_torch.launch.serve import compress_for_form
from repro_torch.models import transformer as ttf
from repro_torch.models.layers import unembed
from repro_torch.runtime import compressed as tforms
from repro_torch.runtime import server as tserver
from repro_torch.tree import tree_leaves
from torch_threads import _one_torch_thread  # noqa: F401


FORMS = ("quant4", "quant8", "sparse")
CASES = [f"phi3-mini-3.8b/{f}" for f in FORMS] + [
    "mixtral-8x7b", "deepseek-moe-16b", "minicpm3-4b", "jamba-v0.1-52b",
    "xlstm-125m"]
MAX_LEN = 20


def _to_jax(tree):
    """The port's serving tree → the JAX package's (forms by class)."""
    if isinstance(tree, dict):
        return {k: _to_jax(v) for k, v in tree.items()}
    if isinstance(tree, tforms.QuantizedWeight):
        return jforms.QuantizedWeight(jnp.asarray(tree.packed.numpy()),
                                      jnp.asarray(tree.codebook.numpy()),
                                      tree.shape, tree.bits)
    if isinstance(tree, tforms.SparseWeight):
        return jforms.SparseWeight(*(jnp.asarray(t.numpy()) for t in (
            tree.values, tree.rows, tree.cols)), tree.shape)
    return jnp.asarray(tree.numpy())


def _model(case):
    """(JAX config, port config, JAX serving tree, port serving tree) on
    the same weights."""
    arch, _, form = case.partition("/")
    base = dict(dtype="float32")
    jcfg = dataclasses.replace(
        jconfigs.reduced_config(jconfigs.get_config(arch)), **base)
    tcfg = dataclasses.replace(
        tconfigs.reduced_config(tconfigs.get_config(arch)), **base)
    if form:            # the forms need per-layer 2-D leaves
        jcfg = jcfg.with_(pattern=jcfg.pattern * 2, pattern_reps=1)
        tcfg = tcfg.with_(pattern=tcfg.pattern * 2, pattern_reps=1)
    tp = ttf.init_params(torch.Generator().manual_seed(0), tcfg)
    if form:
        tp = compress_for_form(tcfg, tp, form, "cpu")
    return jcfg, tcfg, _to_jax(tp), tp


@pytest.fixture(scope="module", params=CASES)
def model(request):
    return _model(request.param)


def _int_position_tokens(cfg, params, prompts, n):
    """Greedy generation as the loop ran before its position became a
    tensor: decode at the Python int ``s + i``."""
    p = torch.as_tensor(prompts)
    s = p.shape[1]
    with torch.inference_mode():
        hidden, _, caches = ttf.forward_hidden(params, p, cfg,
                                               return_caches=True)
        logits = unembed(params["embed"], hidden[:, -1:], cfg)
        caches = tserver.pad_caches_to(caches, cfg, s, MAX_LEN)
        toks = [torch.argmax(logits[:, 0], -1)[:, None]]
        for i in range(n - 1):
            logits, caches = ttf.decode_step(params, caches, toks[-1],
                                             s + i, cfg)
            toks.append(torch.argmax(logits[:, 0], -1)[:, None])
    return torch.cat(toks, 1).numpy()


def test_generate_with_a_device_position_matches_jax(model):
    jcfg, tcfg, jp, tp = model
    prompts = np.random.default_rng(0).integers(
        1, jcfg.vocab_size, (2, 8)).astype(np.int32)
    want = jserver.Server(jcfg, jp, max_len=MAX_LEN).generate(
        jnp.asarray(prompts), 5)
    got = tserver.Server(tcfg, tp, max_len=MAX_LEN, device="cpu").generate(
        prompts, 5, return_logits=True)
    np.testing.assert_array_equal(got.tokens, want.tokens)
    np.testing.assert_array_equal(
        got.tokens, _int_position_tokens(tcfg, tp, prompts, 5))
    assert got.logits.shape == (2, 5, tcfg.vocab_size)
    assert (got.logits.argmax(-1).numpy() == got.tokens).all()


def _ptrs(tree):
    return [t.data_ptr() for t in tree_leaves(tree)]


def test_engine_programs_return_the_cache_they_were_given(model):
    """Every call of the decode, prefill and reset programs gets the
    engine's own cache tensors and returns them, leaf by leaf."""
    _, tcfg, _, tp = model
    eng = tserver.ServingEngine(tcfg, tp, slots=2, max_len=MAX_LEN,
                                prefill_chunk=4, device="cpu")
    own = _ptrs(eng._cache)
    calls = {}
    for name in ("_decode", "_prefill", "_reset"):
        prog = getattr(eng, name)

        def checked(*args, prog=prog, name=name):
            assert _ptrs(args[0]) == own
            out = prog(*args)
            assert _ptrs(out if name == "_reset" else out[1]) == own
            calls[name] = calls.get(name, 0) + 1
            return out
        setattr(eng, name, checked)
    rng = np.random.default_rng(2)
    reqs = [tserver.Request(i, rng.integers(1, tcfg.vocab_size, size=n)
                            .astype(np.int32), m)
            for i, (n, m) in enumerate([(5, 3), (9, 4), (3, 2)])]
    out = eng.run(reqs)
    assert sorted(f.id for f in out["finished"]) == [0, 1, 2]
    assert calls["_reset"] >= 2 and calls["_decode"] and calls["_prefill"]
    assert eng.trace_counts == {"decode": 1, "prefill": 1, "reset": 1}


# ----------------------------------------------------------------------
# the capture helper, with stand-ins for the CUDA calls
# ----------------------------------------------------------------------
class _StandInGraph:
    def __init__(self):
        self.replays = 0

    def replay(self):
        self.replays += 1


@pytest.fixture
def stand_in_graphs(monkeypatch):
    """``graphs.Programs`` on the CPU with capture and replay stood in
    for: capture runs the function's host side (its counters move as a
    real capture's do) with ``capturing[0]`` set, under which the
    stand-in programs change no tensor (a real capture executes
    nothing), and replay runs nothing."""
    made, capturing = [], [False]

    def new_graph():
        made.append(_StandInGraph())
        return made[-1]

    @contextlib.contextmanager
    def capture(graph, pool, stream):
        capturing[0] = True
        try:
            yield
        finally:
            capturing[0] = False

    monkeypatch.setattr(graphs, "_new_graph", new_graph)
    monkeypatch.setattr(graphs, "_capturing", capture)
    monkeypatch.setattr(graphs, "_on", lambda s: contextlib.nullcontext())
    monkeypatch.setattr(graphs, "_join", lambda waiter, stream: None)
    monkeypatch.setattr(graphs, "_current", lambda device: None)
    monkeypatch.setattr(graphs.Programs, "stream_buffers", lambda self: [])
    progs = graphs.Programs(torch.device("cpu"), graphs=False)
    progs.graphs = True
    return progs, made, capturing


def test_capture_takes_its_launches_back_and_replays_add_them(
        stand_in_graphs):
    progs, made, _ = stand_in_graphs
    k_a, k_b = build.LaunchCounter(), build.LaunchCounter()

    def fn(params, x, scale):
        k_a.launches += 2
        k_b.launches += 1
        return x * params["w"] * scale

    counts = {}
    prog = progs.program(fn, held=(0,), name="toy", counts=counts)
    params = {"w": torch.full((1,), 2.0)}
    x = torch.arange(3.0)
    first = prog(params, x, 3.0)
    # the eager run's launches stay; the capture's are taken back
    assert (k_a.launches, k_b.launches) == (2, 1)
    torch.testing.assert_close(first, x * 6.0)
    assert counts == {"toy": 1} and len(made) == 1
    for n in range(1, 4):
        assert prog(params, x + n, 3.0) is first      # the graph's output
    assert (k_a.launches, k_b.launches) == (2 + 3 * 2, 1 + 3)
    assert made[0].replays == 3
    # each replay copied its fed tensor into the graph's own buffer
    (buf,) = prog._graphs[next(iter(prog._graphs))].fed.values()
    torch.testing.assert_close(buf, x + 3)
    # a new shape, a new plain value or another held tensor: a new graph
    prog(params, torch.ones(4), 3.0)
    prog(params, x, 5.0)
    prog({"w": torch.full((1,), 2.0)}, x, 3.0)
    assert counts == {"toy": 4} and len(made) == 4
    assert (k_a.launches, k_b.launches) == (8 + 3 * 2, 4 + 3)


def test_a_program_gets_its_own_buffer_back_without_a_copy(
        stand_in_graphs):
    """A fed tensor that is the graph's buffer already is not copied:
    ``Server``'s decode advances its token and position in place and is
    handed them back."""
    progs, _, capturing = stand_in_graphs

    def step(params, pos):
        if not capturing[0]:
            pos.add_(1)
        return pos

    prog = progs.program(step, held=(0,), name="step")
    pos = torch.zeros(2, dtype=torch.int64)
    out = prog({}, pos)
    assert out.tolist() == [1, 1] and pos.tolist() == [0, 0]
    out.fill_(7)               # what a replay would have left there
    assert prog({}, out) is out and out.tolist() == [7, 7]


def test_an_argument_that_is_not_held_must_be_a_tensor(stand_in_graphs):
    progs, _, _ = stand_in_graphs
    prog = progs.program(lambda params, x: x, held=(0,), name="bad")
    with pytest.raises(TypeError, match="not held"):
        prog({}, [torch.ones(1)])


def test_graphs_on_the_cpu_raise():
    tcfg = dataclasses.replace(
        tconfigs.reduced_config(tconfigs.get_config("phi3-mini-3.8b")),
        dtype="float32")
    params = ttf.init_params(torch.Generator().manual_seed(0), tcfg)
    for make in (lambda: tserver.Server(tcfg, params, device="cpu",
                                        graphs=True),
                 lambda: tserver.ServingEngine(tcfg, params, device="cpu",
                                               graphs=True)):
        with pytest.raises(ValueError, match="graphs=False"):
            make()
    assert not tserver.Server(tcfg, params, device="cpu").programs.graphs


def test_stream_buffer_refuses_to_allocate_during_a_capture(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: True)
    with pytest.raises(RuntimeError, match="during a CUDA graph capture"):
        build.stream_buffer("test", 0, 1, 8, torch.int32, True)
