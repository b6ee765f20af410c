"""Serving runtime: batch generation and continuous batching over
compressed-form weights.

Port of ``src/repro/runtime/server.py``. Two layers:

* :class:`Server` — one equal-length batch in: one prefill, then one
  decode step per new token, with sampling on the device (no logits go
  to the host).
* :class:`ServingEngine` — slot-based continuous batching for request
  traffic: a queue with admission and rejection, chunked prefill into
  free slots, per-slot positions and ring-cache bookkeeping, and exactly
  three device programs (decode tick, prefill tick, slot reset) whose
  input shapes never change across a mixed-length trace.
  ``trace_counts`` counts each program's graphs (distinct keys), the
  reference's count of jit cache misses, and stays at 1 per program
  after the first tick.

Where the reference jits its programs, the port runs them as CUDA graphs
on the card (``repro_torch/graphs.py``): the engine's three programs,
``Server``'s prefill per (B, S) and its decode step with its sampling.
``graphs=False`` runs the same programs eagerly, one launch at a time,
as they always run on the CPU; ``graphs=True`` on the CPU raises.

Everything runs under ``torch.inference_mode`` on ``device`` (``None``
means the card). Caches are updated in place: where the reference's
programs select per slot between the updated and the old cache, the
port's decode writes only the rows of active slots (``decode_step(...,
active=)``), which leaves inactive slots' caches bit for bit as they
were, and every program returns the very cache tensors it was given.
Temperature sampling is Gumbel-max over uniform noise that the caller's
or the engine's ``torch.Generator`` draws outside the programs, in the
same order with graphs or without, so only greedy decoding is comparable
with the reference token for token.

:func:`load_compressed_for_serving` maps an LC state's Θ (codebooks,
factors, masks) straight into the serving forms of
``runtime/compressed.py``.
"""
from __future__ import annotations

import functools
import time
from collections import deque
from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.graphs import Programs
from repro_torch.interop import resolve_device
from repro_torch.models.layers import unembed
from repro_torch.models.transformer import (
    cache_axes, decode_step, forward_hidden, init_cache, plan_stages)
from repro_torch.runtime import compressed as cforms


def _tensors(tree):
    """Every tensor in a tree of dicts, lists and weight-form objects."""
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tensors(v)
    elif hasattr(tree, "__dict__"):
        yield from _tensors(vars(tree))


def _check_device(params, device: torch.device) -> None:
    for t in _tensors(params):
        if t.device != device:
            raise ValueError(f"a parameter is on {t.device}, but this "
                             f"server runs on {device}")


def pad_caches_to(cache, cfg, cur_len: int, max_len: int):
    """Grow prefill caches (seq-sized) to decode capacity.

    Attention caches pad the seq axis; ring-buffer (windowed) caches are
    rolled so slot = pos % window stays consistent."""
    specs_by_stage = {f"s{si}": st["specs"]
                      for si, st in enumerate(plan_stages(cfg))}
    out = {}
    for sname, stage in cache.items():
        specs = specs_by_stage[sname]
        new_stage = {}
        for pname, c in sorted(stage.items()):
            spec = specs[int(pname[3:])]
            if spec.mixer in ("attn", "mla"):
                nc = {}
                for k, arr in c.items():
                    seq_axis = arr.ndim - 3 if spec.mixer == "attn" \
                        else arr.ndim - 2
                    cap = max_len
                    if spec.mixer == "attn" and spec.window > 0:
                        cap = min(spec.window, max_len)
                    pad = cap - arr.shape[seq_axis]
                    if pad > 0:
                        shape = list(arr.shape)
                        shape[seq_axis] = pad
                        arr = torch.cat([arr, arr.new_zeros(shape)],
                                        dim=seq_axis)
                    if spec.mixer == "attn" and spec.window > 0 \
                            and cur_len > spec.window:
                        # ring alignment: position p lives at slot p % w
                        arr = torch.roll(arr, cur_len % spec.window,
                                         dims=seq_axis)
                    nc[k] = arr.contiguous()
                new_stage[pname] = nc
            else:
                new_stage[pname] = c
        out[sname] = new_stage
    return out


def pick_tokens(logits, noise, temperature: float):
    """Greedy (temperature ≤ 0; ties to the lowest index; ``noise`` is
    not read) or temperature sampling over the vocab axis: Gumbel-max
    with ``noise``, uniform draws of the logits' shape. logits: (B, V) →
    (B,) int32."""
    if temperature <= 0.0:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    gumbel = -torch.log(-torch.log(noise.clamp_min(1e-20)))
    return torch.argmax(logits.float() / temperature + gumbel,
                        dim=-1).to(torch.int32)


def sample_tokens(logits, generator, temperature: float):
    """:func:`pick_tokens` with its noise drawn from ``generator`` on the
    logits' device (nothing is drawn when greedy)."""
    noise = None
    if temperature > 0.0:
        noise = torch.rand(logits.shape, generator=generator,
                           device=logits.device)
    return pick_tokens(logits, noise, temperature)


@dataclass
class GenerationResult:
    tokens: np.ndarray          # (B, n_generated)
    prefill_len: int
    #: (B, n_generated, V) logits each token was picked from, on the
    #: server's device; only with ``generate(..., return_logits=True)``
    logits: torch.Tensor | None = None


def _prefill_program(cfg, max_len, params, prompts, noise, temperature):
    """Server's prefill: the prompt's caches, grown to ``max_len``, and
    the first token, with the logits it was picked from."""
    hidden, _, caches = forward_hidden(params, prompts, cfg,
                                       return_caches=True)
    logits = unembed(params["embed"], hidden[:, -1:], cfg)[:, 0]
    caches = pad_caches_to(caches, cfg, prompts.shape[1], max_len)
    return pick_tokens(logits, noise, temperature), caches, logits


def _decode_program(cfg, params, caches, tok, pos, noise, temperature):
    """Server's decode step: feeds ``tok`` (B,) at positions ``pos`` (B,),
    then advances both in place (the next token, pos + 1) and returns
    them with ``noise`` and the logits."""
    logits, _ = decode_step(params, caches, tok[:, None], pos, cfg)
    logits = logits[:, 0]
    tok.copy_(pick_tokens(logits, noise, temperature))
    pos.add_(1)
    return tok, pos, noise, logits


class Server:
    """Equal-length batch serving: prefill once, then one decode step per
    token with sampling on the device (no per-token host sync).

    On the card both run as CUDA graphs (``graphs``, default True
    there): the prefill one per prompt shape (B, S), as the reference
    jits it per shape, and the decode step, replayed n − 1 times, one per
    prefill graph. ``programs`` has their capture seconds and pool bytes.
    """

    def __init__(self, cfg, params, max_len: int = 512, device=None,
                 graphs: bool | None = None):
        self.cfg = cfg
        self.max_len = max_len
        self.device = resolve_device(device)
        _check_device(params, self.device)
        self.params = params
        self.programs = Programs(self.device, graphs)
        # the programs read this server's params (bound here: a per-call
        # key need not walk them)
        self._prefill = self.programs.program(
            functools.partial(_prefill_program, cfg, max_len, params),
            name="prefill")
        self._decode = self.programs.program(
            functools.partial(_decode_program, cfg, params), held=(0,),
            name="decode")

    @torch.inference_mode()
    def generate(self, prompts, n_tokens: int, temperature: float = 0.0,
                 generator: torch.Generator | None = None,
                 return_logits: bool = False) -> GenerationResult:
        """prompts: (B, S) token batch (equal-length; for mixed-length
        traffic use :class:`ServingEngine`), on the host or the device.
        ``generator`` feeds temperature sampling (default: seeded 0 on
        the device): one (B, V) uniform draw per token, in order."""
        temperature = float(temperature)
        prompts = torch.as_tensor(prompts)
        b, s = prompts.shape
        if generator is None:
            generator = torch.Generator(device=self.device).manual_seed(0)
        noise = None
        if temperature > 0.0:
            noise = torch.empty((b, self.cfg.vocab_size),
                                device=self.device)

        def draw(noise):
            # in place: after the first decode step ``noise`` is the
            # decode graph's own buffer
            return None if noise is None else noise.uniform_(
                generator=generator)

        n = int(n_tokens)
        tok, caches, logits = self._prefill(prompts, draw(noise),
                                            temperature)
        toks = torch.empty((b, n), dtype=torch.int32, device=self.device)
        toks[:, 0] = tok
        kept = None
        if return_logits:
            kept = torch.empty((b, n, logits.shape[-1]), device=self.device)
            kept[:, 0] = logits
        pos = torch.full((b,), s, dtype=torch.int64, device=self.device)
        for i in range(1, n):
            tok, pos, noise, logits = self._decode(
                caches, tok, pos, draw(noise), temperature)
            toks[:, i] = tok
            if kept is not None:
                kept[:, i] = logits
        return GenerationResult(tokens=toks.cpu().numpy(), prefill_len=s,
                                logits=kept)


# ======================================================================
# Continuous batching
# ======================================================================
@dataclass
class Request:
    """One generation request on the synthetic-traffic timeline.
    ``arrival`` is in virtual seconds (the engine clock advances by the
    measured wall time of each device tick)."""

    id: int
    prompt: np.ndarray              # (S,) int32 tokens
    max_new: int
    arrival: float = 0.0


@dataclass
class FinishedRequest:
    id: int
    tokens: np.ndarray              # (n_generated,) int32
    prompt_len: int
    arrival: float
    first_token_at: float           # virtual time of first sampled token
    finished_at: float

    @property
    def latency(self) -> float:
        return self.finished_at - self.arrival

    @property
    def ttft(self) -> float:
        return self.first_token_at - self.arrival


_FREE, _PREFILL, _DECODE = "free", "prefill", "decode"


def engine_programs(cfg, params, slots: int, max_len: int,
                    temperature: float, trace_counts: dict,
                    programs: Programs):
    """The engine's three device programs on ``params``, made by
    ``programs`` (CUDA graphs on the card, or eager).

    Returns ``(decode, prefill, reset)``; see :class:`ServingEngine` for
    their signatures. ``trace_counts[name]`` holds the number of keys
    (graphs, or eager signatures) the program has seen: the reference's
    count of jit cache misses."""
    device = programs.device
    axes = cache_axes(cfg)

    def decode_impl(cache, tok, pos, active, noise):
        logits, cache = decode_step(params, cache, tok[:, None], pos, cfg,
                                    active=active)
        nxt = pick_tokens(logits[:, 0], noise, temperature)
        return torch.where(active, nxt, tok), cache

    def prefill_impl(cache, chunk, pos0, n_valid, active, noise):
        b, c = chunk.shape
        tok = torch.zeros((b,), dtype=torch.int32, device=device)
        for t in range(c):
            step_active = active & (t < n_valid)
            logits, cache = decode_step(params, cache, chunk[:, t:t + 1],
                                        pos0 + t, cfg, active=step_active)
            sampled = pick_tokens(logits[:, 0],
                                  None if noise is None else noise[t],
                                  temperature)
            tok = torch.where(step_active & (t == n_valid - 1), sampled, tok)
        return tok, cache

    def reset_impl(cache, mask):
        fresh = init_cache(cfg, slots, max_len, device=device)
        return _merge(axes, fresh, cache, mask)

    def program(name, fn, held):
        return programs.program(fn, held, name, trace_counts)

    return (program("decode", decode_impl, (0, 4)),
            program("prefill", prefill_impl, (0, 5)),
            program("reset", reset_impl, (0,)))


def _merge(axes, new, old, mask):
    """Per-slot select, in place: the leaves of ``old`` take ``new`` on
    the slots of ``mask`` along the batch axis that ``axes`` (from
    ``cache_axes``) names; stacked stages carry a leading "layers"
    axis."""
    if isinstance(old, dict):
        for k in old:
            old[k] = _merge(axes[k], new[k], old[k], mask)
        return old
    shape = [1] * old.ndim
    shape[axes.index("batch")] = mask.shape[0]
    old.copy_(torch.where(mask.reshape(shape), new, old))
    return old


class ServingEngine:
    """Slot-based continuous batching.

    ``slots`` sequences decode together; finished slots are refilled from
    the queue mid-flight. Prompts stream in through chunked prefill
    (``prefill_chunk`` tokens per tick), so a long prompt never stalls
    decoding slots for more than one tick. All device work runs through
    three programs with fixed input shapes:

    * ``_decode(cache, tok (B,), pos (B,), active (B,), noise)`` →
      (next_tok, cache): one token for every active slot,
      per-slot positions, sampling on the device; inactive slots' caches
      are left unchanged.
    * ``_prefill(cache, chunk (B, C), pos0, n_valid, active, noise)`` →
      (first_tok, cache): C decode sub-steps feeding
      prompt tokens; slot b consumes ``n_valid[b]`` of them; the token
      sampled where ``t == n_valid-1`` seeds decode when the prompt ends
      this tick.
    * ``_reset(cache, mask)``: admitted slots restored to ``init_cache``
      values.

    On the card they run as CUDA graphs (``graphs``, default True
    there; ``programs`` has their capture seconds and pool bytes). The
    per-tick inputs go from the host into the graphs' own buffers, one
    host-to-device copy each. ``noise`` is None when greedy, else the
    engine's (B, V) and (C, B, V) buffers of uniform draws, refilled from
    its generator before each tick (one draw per tick, in tick order).

    ``trace_counts`` holds, per program, the number of graphs captured
    (the distinct signatures seen, with ``graphs=False``): after the
    first tick every value stays at 1 across mixed-length traffic.
    """

    def __init__(self, cfg, params, *, slots: int = 4, max_len: int = 256,
                 prefill_chunk: int = 8, temperature: float = 0.0,
                 seed: int = 0, device=None, graphs: bool | None = None):
        self.cfg = cfg
        self.device = resolve_device(device)
        _check_device(params, self.device)
        self.params = params
        self.slots = int(slots)
        self.max_len = int(max_len)
        self.prefill_chunk = int(prefill_chunk)
        self.temperature = float(temperature)
        self.trace_counts = {"decode": 0, "prefill": 0, "reset": 0}
        self._gen = torch.Generator(device=self.device).manual_seed(seed)
        self.programs = Programs(self.device, graphs)
        self._decode, self._prefill, self._reset = engine_programs(
            cfg, params, self.slots, self.max_len, self.temperature,
            self.trace_counts, self.programs)

        # host-side slot state
        with torch.inference_mode():
            self._cache = init_cache(cfg, self.slots, self.max_len,
                                     device=self.device)
            self._noise = (None, None)
            if self.temperature > 0.0:
                v = cfg.vocab_size
                self._noise = (
                    torch.empty((self.slots, v), device=self.device),
                    torch.empty((self.prefill_chunk, self.slots, v),
                                device=self.device))
        self._phase = [_FREE] * self.slots
        self._req: list[Request | None] = [None] * self.slots
        self._fed = np.zeros(self.slots, np.int64)   # prompt tokens fed
        self._pos = np.zeros(self.slots, np.int32)   # next write position
        self._tok = np.zeros(self.slots, np.int32)   # decode feed token
        self._gen_toks: list[list[int]] = [[] for _ in range(self.slots)]
        self._meta: list[dict] = [{} for _ in range(self.slots)]
        self._now = 0.0

    # ------------------------------------------------------------------
    def _draw(self, noise):
        """``noise`` refilled from the engine's generator (None stays
        None)."""
        if noise is not None:
            with torch.inference_mode():
                noise.uniform_(generator=self._gen)
        return noise

    def _timed(self, fn, *args):
        t0 = time.perf_counter()
        with torch.inference_mode():
            out = fn(*args)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self._now += time.perf_counter() - t0
        return out

    def _admit(self, queue: deque, rejected):
        newly = np.zeros(self.slots, bool)
        for b in range(self.slots):
            if self._phase[b] != _FREE:
                continue
            # drop unservable requests (too long / empty) at the head
            while queue and queue[0].arrival <= self._now and (
                    len(queue[0].prompt) == 0
                    or len(queue[0].prompt) + queue[0].max_new
                    > self.max_len):
                rejected.append(queue.popleft())
            if not queue or queue[0].arrival > self._now:
                break
            req = queue.popleft()
            self._phase[b] = _PREFILL
            self._req[b] = req
            self._fed[b] = 0
            self._pos[b] = 0
            self._gen_toks[b] = []
            self._meta[b] = {"arrival": req.arrival}
            newly[b] = True
        if newly.any():
            self._cache = self._timed(self._reset, self._cache,
                                      torch.from_numpy(newly))

    def _prefill_tick(self):
        b = self.slots
        c = self.prefill_chunk
        chunk = np.zeros((b, c), np.int32)
        pos0 = np.zeros(b, np.int32)
        n_valid = np.zeros(b, np.int32)
        active = np.zeros(b, bool)
        for i in range(b):
            if self._phase[i] != _PREFILL:
                continue
            req = self._req[i]
            take = min(c, len(req.prompt) - int(self._fed[i]))
            chunk[i, :take] = req.prompt[self._fed[i]:self._fed[i] + take]
            pos0[i] = self._fed[i]
            n_valid[i] = take
            active[i] = True
        tok, self._cache = self._timed(
            self._prefill, self._cache, torch.from_numpy(chunk),
            torch.from_numpy(pos0), torch.from_numpy(n_valid),
            torch.from_numpy(active), self._draw(self._noise[1]))
        tok = tok.cpu().numpy()
        for i in range(b):
            if not active[i]:
                continue
            self._fed[i] += int(n_valid[i])
            if self._fed[i] == len(self._req[i].prompt):
                self._phase[i] = _DECODE
                self._pos[i] = self._fed[i]
                self._tok[i] = tok[i]
                self._gen_toks[i].append(int(tok[i]))
                self._meta[i]["first_token_at"] = self._now

    def _decode_tick(self, finished):
        active = np.array([p == _DECODE for p in self._phase])
        nxt, self._cache = self._timed(
            self._decode, self._cache,
            torch.from_numpy(self._tok), torch.from_numpy(self._pos),
            torch.from_numpy(active), self._draw(self._noise[0]))
        nxt = nxt.cpu().numpy()
        for i in range(self.slots):
            if not active[i]:
                continue
            self._pos[i] += 1
            req = self._req[i]
            if len(self._gen_toks[i]) < req.max_new:
                self._gen_toks[i].append(int(nxt[i]))
                self._tok[i] = nxt[i]
            if len(self._gen_toks[i]) >= req.max_new:
                finished.append(FinishedRequest(
                    id=req.id, tokens=np.asarray(self._gen_toks[i], np.int32),
                    prompt_len=len(req.prompt),
                    arrival=self._meta[i]["arrival"],
                    first_token_at=self._meta[i]["first_token_at"],
                    finished_at=self._now))
                self._phase[i] = _FREE
                self._req[i] = None

    # ------------------------------------------------------------------
    def run(self, requests: list[Request]) -> dict:
        """Serve a request trace to completion. Returns ``{"finished",
        "rejected", "stats"}`` — latencies on the virtual timeline
        (arrival offsets + measured device time per tick)."""
        queue = deque(sorted(requests, key=lambda r: (r.arrival, r.id)))
        finished: list[FinishedRequest] = []
        rejected: list[Request] = []
        decode_turn = False
        t_start = self._now
        while queue or any(p != _FREE for p in self._phase):
            if all(p == _FREE for p in self._phase) and queue:
                # idle: fast-forward the virtual clock to the next arrival
                self._now = max(self._now, queue[0].arrival)
            self._admit(queue, rejected)
            prefilling = any(p == _PREFILL for p in self._phase)
            decoding = any(p == _DECODE for p in self._phase)
            if prefilling and not (decoding and decode_turn):
                self._prefill_tick()
                decode_turn = True
            elif decoding:
                self._decode_tick(finished)
                decode_turn = False
            elif queue:
                # nothing runnable: queued arrivals are in the future
                self._now = max(self._now, queue[0].arrival)
        return {"finished": finished, "rejected": rejected,
                "stats": self.stats(finished, t_start)}

    def stats(self, finished: list[FinishedRequest],
              t_start: float = 0.0) -> dict:
        if not finished:
            return {"requests": 0, "tokens": 0, "tokens_per_sec": 0.0,
                    "p50_latency_s": 0.0, "p99_latency_s": 0.0,
                    "p50_ttft_s": 0.0, "p99_ttft_s": 0.0}
        toks = int(sum(len(f.tokens) for f in finished))
        span = max(self._now - t_start, 1e-9)
        lats = np.asarray([f.latency for f in finished])
        ttfts = np.asarray([f.ttft for f in finished])
        return {
            "requests": len(finished),
            "tokens": toks,
            "tokens_per_sec": toks / span,
            "p50_latency_s": float(np.percentile(lats, 50)),
            "p99_latency_s": float(np.percentile(lats, 99)),
            "p50_ttft_s": float(np.percentile(ttfts, 50)),
            "p99_ttft_s": float(np.percentile(ttfts, 99)),
        }


# ======================================================================
# Checkpoint bridge: LC Θ → serving weight forms
# ======================================================================
def load_compressed_for_serving(params, lc_state, tasks, *, bits: int = 4,
                                sparse_density_cutoff: float = 0.25):
    """Map an LC state's Θ straight into serving form.

    ``tasks`` must be resolved against ``params`` and match the names in
    ``lc_state["tasks"]`` (e.g. ``LCAlgorithm.tasks`` after ``init``).
    Per task, by Θ structure:

    * quantize (``QuantTheta``): assignments split per leaf (AsVector
      offsets); 2-D leaves become :class:`~repro_torch.runtime.compressed.
      QuantizedWeight` — 4-bit packed when the codebook has ≤ 16 entries
      and ``bits == 4``, else 8-bit indices (≤ 256 entries). Other leaves
      take the dense decompressed leaf.
    * lowrank (``{"u", "v"[, "rank"]}``): 2-D single-leaf views become
      :class:`LowRankWeight` with factors cut to the selected rank.
    * prune (``{"theta"}``): 2-D leaves at density ≤
      ``sparse_density_cutoff`` become :class:`SparseWeight` (COO, rows
      and cols int32 in row-major order, found on the device); denser
      ones stay dense-with-zeros.

    Every fallback is the exact decompressed leaf ``a[path]``, so the
    bridged model computes the compressed model's function. Returns
    ``(serving_params, report)``; report maps each path to its form.
    """
    from repro_torch.core.schemes.quantize import QuantTheta
    from repro_torch.core.tasks import set_path
    from repro_torch.kernels.quant_matmul import ops as quant_ops

    serving = params
    report = {}
    for task in tasks:
        t = task if task.paths else task.resolve(params)
        ts = lc_state["tasks"][t.name]
        theta = ts["theta"]
        leaves = t.leaves(params)
        forms = {}

        def fallback(p):
            return ts["a"][p].float()

        stacked = t.view.stacked
        if isinstance(theta, QuantTheta) and not stacked:
            cb = theta.codebook.float()
            assign = theta.assign.reshape(-1)
            n_codes = int(cb.shape[0])
            off = 0
            for p, w in zip(t.paths, leaves):
                size = w.numel()
                idx = assign[off:off + size].reshape(w.shape)
                off += size
                if w.ndim == 2 and bits == 4 and n_codes <= 16:
                    leaf = cforms.QuantizedWeight(
                        quant_ops.pack4(idx.to(torch.uint8)), cb,
                        w.shape, 4)
                    forms[p] = "quant4"
                elif w.ndim == 2 and n_codes <= 256:
                    leaf = cforms.QuantizedWeight(
                        idx.to(torch.uint8).contiguous(), cb, w.shape, 8)
                    forms[p] = "quant8"
                else:
                    leaf = fallback(p)
                    forms[p] = "dense"
                serving = set_path(serving, p, leaf)
        elif (isinstance(theta, dict) and "u" in theta and "v" in theta
              and not stacked and len(t.paths) == 1
              and leaves[0].ndim == 2):
            (p,), (w,) = t.paths, leaves
            r = int(theta.get("rank", theta["u"].shape[-1]))
            r = max(min(r, theta["u"].shape[-1]), 1)
            u = theta["u"][:, :r].float().contiguous()
            vt = theta["v"][:, :r].float().T.contiguous()
            if (u.shape[0], vt.shape[1]) == tuple(w.shape):
                serving = set_path(serving, p, cforms.LowRankWeight(u, vt))
                forms[p] = f"lowrank(r={r})"
            else:                        # AsMatrix over a non-2-D leaf
                serving = set_path(serving, p, fallback(p))
                forms[p] = "dense"
        elif isinstance(theta, dict) and set(theta) == {"theta"}:
            for p, w in zip(t.paths, leaves):
                dense = fallback(p)       # dense-with-zeros = Δ(Θ)
                density = (int(torch.count_nonzero(dense)) / dense.numel()
                           if dense.numel() else 1.0)
                if w.ndim == 2 and density <= sparse_density_cutoff:
                    rows, cols = torch.nonzero(dense, as_tuple=True)
                    leaf = cforms.SparseWeight(
                        dense[rows, cols], rows.to(torch.int32),
                        cols.to(torch.int32), dense.shape)
                    forms[p] = f"sparse(d={density:.2f})"
                else:
                    leaf = dense
                    forms[p] = f"dense(d={density:.2f})"
                serving = set_path(serving, p, leaf)
        else:
            for p in t.paths:
                serving = set_path(serving, p, fallback(p))
                forms[p] = "dense"
        report[t.name] = forms
    return serving, report


def densified_for_serving(params, lc_state, tasks):
    """The dequantized/densified counterpart: every compressed path
    replaced by its exact dense decompressed leaf Δ(Θ). Parity reference
    for :func:`load_compressed_for_serving`."""
    from repro_torch.core.tasks import set_path

    out = params
    for task in tasks:
        t = task if task.paths else task.resolve(params)
        ts = lc_state["tasks"][t.name]
        for p in t.paths:
            out = set_path(out, p, ts["a"][p].float())
    return out


# ----------------------------------------------------------------------
# Legacy compressed-weight serving (re-k-means at load time)
# ----------------------------------------------------------------------
def quantize_params_for_serving(params, paths: list[str], k: int = 16,
                                iters: int = 20):
    """Quantize selected matrices to (uint8 idx, codebook) for deployment.

    Returns (packed: {path: (idx, codebook)}, dequantized params). Prefer
    :func:`load_compressed_for_serving` when an LC state is available —
    this re-runs k-means from scratch on the dense weights."""
    from repro_torch.core.schemes.quantize import kmeans_1d, quantile_init
    from repro_torch.core.tasks import get_path, set_path
    packed = {}
    dq_params = params
    for p in paths:
        w = get_path(params, p)
        flat = w.float().reshape(-1)
        cb = quantile_init(flat, k)
        cb, assign = kmeans_1d(flat, cb, iters)
        idx = assign.reshape(w.shape).to(torch.uint8)
        packed[p] = (idx, cb)
        dq_params = set_path(dq_params, p, cb[assign.long()]
                             .reshape(w.shape).to(w.dtype))
    return packed, dq_params


def serving_bits(packed: dict, float_bits: int = 16) -> tuple[int, int]:
    """(compressed bits, dense bits) over the packed matrices."""
    comp = 0
    dense = 0
    for idx, cb in packed.values():
        k = cb.shape[0]
        comp += idx.numel() * max(1, int(np.ceil(np.log2(k)))) + k * 32
        dense += idx.numel() * float_bits
    return comp, dense
