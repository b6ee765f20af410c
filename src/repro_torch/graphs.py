"""CUDA graphs around the port's device programs: its counterpart of the
``jax.jit`` that the JAX package puts around its serving programs.

:class:`Programs` holds the graphs of one owner (a ``Server`` or a
``ServingEngine``): one memory pool that all of them share, so that one
program's temporaries are not reserved beside another's, and one capture
stream. :meth:`Programs.program` turns a function into a
:class:`Program`, which keeps one graph per key:

* the key is the call's input signature (shapes, dtypes and devices of
  tensors, the structure around them, plain values by value: what a jit
  cache keys on) plus the addresses of the tensors of its *held*
  arguments (params, caches), which the graph reads and writes in place
  where it found them at capture. The program keeps a reference to them;
* every other argument is a tensor, ``None``, a plain value or a tuple of
  plain values (keyed by value, as a jit's static arguments). A tensor
  there is *fed*: each call copies it into a buffer of the graph's own
  (a host tensor with one host-to-device copy), unless it is that buffer
  already, so a program that advances an input in place and returns it
  (``Server.generate``'s token and position) gets it back for free.
  :meth:`Program.fed` hands that buffer out before the call, so that a
  caller can write a large input straight into it;
* the first call with a key runs the function eagerly on the capture
  stream, and its result is the call's result: that run loads the
  kernel libraries and makes cuBLAS's and the kernels' per-stream
  workspaces (``kernels/build.py:stream_buffer``) before the capture,
  and since capture executes nothing, no program's state moves twice.
  The function is then captured on the same stream, and the eager result
  copied into the graph's outputs, which the call returns. Every later
  call is a replay that rewrites those same output tensors in place:
  read or copy them before the next call.

The kernels of a graph keep using the capture stream's per-stream
buffers at replay (the K4/K5 split-K tickets, which each launch leaves
zero): replays of the graphs that share them, all of one owner's, run
in order on one stream, never on two at once. The program holds those
buffers, so a buffer grown later for the stream does not free them.

Launch accounting: the kernels' counters (``build.LaunchCounter``) count
what ran on the card. The capture call adds to them as the wrappers
queue their launches, but runs nothing; that delta is taken back out
and added once at each replay.

With ``graphs=False`` a program runs its function eagerly at every call
(fed host tensors moved to the device first): the path of the CPU and
of the comparisons on the card. A failed capture or replay raises;
nothing falls back to the eager path.
"""
from __future__ import annotations

import time

import torch

from repro_torch.kernels import build


_PLAIN = (int, float, str, bool, type(None))


def signature(x):
    """What a jit cache would key on: shapes, dtypes and devices of
    tensors, the structure around them, and plain values by value."""
    if isinstance(x, torch.Tensor):
        return ("tensor", tuple(x.shape), x.dtype, x.device)
    if isinstance(x, dict):
        return tuple((k, signature(v)) for k, v in x.items())
    if isinstance(x, (list, tuple)):
        return tuple(signature(v) for v in x)
    if isinstance(x, (int, float, str, bool, type(None))):
        return x
    if isinstance(x, torch.Generator):
        return ("generator", x.device)
    return (type(x).__name__, signature(vars(x)))


def _held(x, out: list) -> None:
    """The key of a held tree, appended to ``out``: its structure, plain
    values, and each tensor's address, shape and dtype (a held tree lies
    on the owner's device)."""
    if isinstance(x, torch.Tensor):
        out.append((x.data_ptr(), x.shape, x.dtype))
    elif isinstance(x, dict):
        out.extend(x)
        for v in x.values():
            _held(v, out)
    elif isinstance(x, (list, tuple)):
        out.append(len(x))
        for v in x:
            _held(v, out)
    elif x is None or isinstance(x, (int, float, str, bool)):
        out.append(x)
    else:
        out.append(type(x))
        _held(vars(x), out)


def _tensors(x):
    """The tensors of a tree, in order."""
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, dict):
        for v in x.values():
            yield from _tensors(v)
    elif isinstance(x, (list, tuple)):
        for v in x:
            yield from _tensors(v)


# the CUDA calls of a capture; the CPU tests replace them with stand-ins
def _new_graph():
    return torch.cuda.CUDAGraph()


def _capturing(graph, pool, stream):
    return torch.cuda.graph(graph, pool=pool, stream=stream)


def _on(stream):
    return torch.cuda.stream(stream)


def _join(waiter, stream) -> None:
    waiter.wait_stream(stream)


def _current(device):
    return torch.cuda.current_stream(device)


class _Graph:
    """One captured graph: its fed buffers, outputs, launch deltas and
    the tensors it must keep alive."""

    def __init__(self, graph, fed: dict, out, delta: dict, keep: list):
        self.graph = graph
        self.fed = fed
        self.out = out
        self.delta = delta
        self.keep = keep


class Program:
    """A function run as CUDA graphs, one per key (see the module's
    note). ``held`` names the positional arguments held by address.
    ``counts[name]`` is kept at the number of keys seen: graphs
    captured, or with ``graphs=False`` distinct signatures (the
    reference's count of jit cache misses)."""

    def __init__(self, owner: "Programs", fn, held: tuple, name: str,
                 counts: dict | None):
        self.owner = owner
        self.fn = fn
        self.held = frozenset(held)
        self.name = name
        self.counts = counts if counts is not None else {}
        self.counts[name] = 0
        self._graphs: dict = {}
        self._ready: dict = {}

    def _key(self, args) -> tuple:
        key = []
        for i, a in enumerate(args):
            if i in self.held:
                if self.owner.graphs:
                    _held(a, key)
                else:
                    key.append(signature(a))
            elif isinstance(a, torch.Tensor):
                key.append((tuple(a.shape), a.dtype))
            elif isinstance(a, _PLAIN) or (isinstance(a, tuple) and all(
                    isinstance(v, _PLAIN) for v in a)):
                key.append(a)
            else:
                raise TypeError(
                    f"{self.name}: argument {i} is a {type(a).__name__}; "
                    f"an argument that is not held must be a tensor, None, "
                    f"a plain value or a tuple of plain values")
        return tuple(key)

    def fed(self, args, i: int):
        """The buffer that a call with ``args`` copies its fed tensor
        ``i`` into (made now when that call will capture), or None with
        ``graphs=False``. A caller that writes the input there and passes
        the buffer as ``args[i]`` makes the call copy nothing. ``args[i]``
        may be a meta tensor of the input's shape and dtype."""
        if not self.owner.graphs:
            return None
        key = self._key(args)
        entry = self._graphs.get(key)
        if entry is not None:
            return entry.fed[i]
        buf = self._ready.get((key, i))
        if buf is None:
            buf = self._ready[(key, i)] = torch.empty(
                args[i].shape, dtype=args[i].dtype, device=self.owner.device)
        return buf

    def __call__(self, *args):
        key = self._key(args)
        entry = self._graphs.get(key)
        if entry is None:
            self.counts[self.name] = len(self._graphs) + 1
        if not self.owner.graphs:
            self._graphs[key] = True
            dev = self.owner.device
            return self.fn(*(a.to(dev) if i not in self.held
                             and isinstance(a, torch.Tensor) else a
                             for i, a in enumerate(args)))
        if entry is None:
            out, self._graphs[key] = self._capture(args, key)
            return out
        for i, buf in entry.fed.items():
            a = args[i]
            if a.data_ptr() != buf.data_ptr():
                buf.copy_(a, non_blocking=True)
        entry.graph.replay()
        for c, d in entry.delta.items():
            c.launches += d
        return entry.out

    def _capture(self, args, key):
        """The first call with a key: the eager run on the capture stream
        (the call's result), then the capture of the same call."""
        owner = self.owner
        dev = owner.device
        t0 = time.perf_counter()
        fed = {}
        args = list(args)
        for i, a in enumerate(args):
            if i not in self.held and isinstance(a, torch.Tensor):
                buf = self._ready.pop((key, i), None)
                if buf is None or buf.data_ptr() != a.data_ptr():
                    buf = torch.empty(a.shape, dtype=a.dtype, device=dev)
                    buf.copy_(a)
                fed[i] = args[i] = buf
        caller = _current(dev)
        _join(owner.stream, caller)
        with _on(owner.stream):
            eager = self.fn(*args)
            graph = _new_graph()
            before = build.launch_counts()
            with _capturing(graph, owner.pool, owner.stream):
                out = self.fn(*args)
            delta = {}
            for c, n in build.launch_counts().items():
                d = n - before.get(c, 0)
                if d:
                    c.launches -= d
                    delta[c] = d
            for dst, src in zip(_tensors(out), _tensors(eager)):
                if dst.data_ptr() != src.data_ptr():
                    dst.copy_(src)
        _join(caller, owner.stream)
        del eager
        keep = [args[i] for i in self.held]
        keep += owner.stream_buffers()
        owner.capture_s += time.perf_counter() - t0
        owner.captured += 1
        return out, _Graph(graph, fed, out, delta, keep)


def captured(fn):
    """Mark ``fn`` as a body that runs as a :class:`Program` (captured as
    a CUDA graph on the card), where it reaches :meth:`Programs.program`
    through a table rather than by name: the lint's AST layer
    (``repro_torch.analysis.lint.ast_rules``) then holds it to the rules
    of a captured body. Returns ``fn`` unchanged."""
    return fn


class Programs:
    """The programs of one owner on ``device``: with ``graphs`` (the
    default on a CUDA device; an error on any other) they run as CUDA
    graphs that share one memory pool and one capture stream, else
    eagerly. ``capture_s`` sums the seconds spent in first calls (the
    eager run and the capture), ``captured`` counts the graphs."""

    def __init__(self, device: torch.device, graphs: bool | None = None):
        self.device = device
        if graphs is None:
            graphs = device.type == "cuda"
        if graphs and device.type != "cuda":
            raise ValueError(f"CUDA graphs need a CUDA device, not {device}; "
                             f"pass graphs=False")
        self.graphs = bool(graphs)
        self.capture_s = 0.0
        self.captured = 0
        self.pool = self.stream = None
        if self.graphs:
            if device.index is None:
                self.device = torch.device("cuda",
                                           torch.cuda.current_device())
            self.pool = torch.cuda.graph_pool_handle()
            self.stream = torch.cuda.Stream(self.device)

    def program(self, fn, held: tuple = (), name: str = "program",
                counts: dict | None = None) -> Program:
        return Program(self, fn, held, name, counts)

    def stream_buffers(self) -> list[torch.Tensor]:
        """The per-stream kernel buffers of the capture stream."""
        return build.stream_buffers(self.device.index,
                                    self.stream.cuda_stream)

    def release_stream_buffers(self) -> None:
        """Let go of the kernels' buffers of the capture stream (the
        graphs keep theirs): an owner done with its graphs."""
        if self.graphs:
            build.drop_stream_buffers(self.device.index,
                                      self.stream.cuda_stream)

    def pool_bytes(self) -> int:
        """Bytes that the caching allocator holds in this owner's graph
        pool (``torch.cuda.memory_snapshot``'s segments of the pool)."""
        if not self.graphs:
            return 0
        pool = tuple(self.pool)
        return sum(seg["total_size"] for seg in torch.cuda.memory_snapshot()
                   if tuple(seg["segment_pool_id"]) == pool)
