"""Deterministic, seekable synthetic data.

Port of ``src/repro/data/pipeline.py``. The numbers are drawn from
seeded ``torch.Generator``s on the CPU (so they are the same whatever the
target device) and differ from the JAX package's ``jax.random`` draws:
tests that compare the two packages hand both the same numpy arrays.

* ``TokenStream`` — LM stream with learnable bigram structure (a fixed
  random Markov kernel over ``vocab % n_states`` + a Zipfian unigram
  lift). ``batch_at(step)`` draws from a generator seeded by
  ``(seed, step)`` alone, so it is a pure function of the step:
  restarts resume exactly with nothing to checkpoint beyond the step.
* ``Prefetcher`` — builds a seekable source's next batch on a
  background thread while the LC boundary is in flight.
* ``teacher_classification`` / ``gaussian_blobs`` — the LeNet300
  showcase tasks; ``embedding_stream`` — the stub modality frontend.
"""
from __future__ import annotations

import math
import threading
from concurrent.futures import Future
from dataclasses import dataclass

import torch

from repro_torch.interop import resolve_device


def _generator(seed: int, step: int | None = None) -> torch.Generator:
    """A CPU generator seeded by ``seed`` (and ``step``, for the draws of
    one batch): distinct (seed, step) pairs give distinct seeds."""
    s = int(seed) if step is None else (int(seed) << 32) | (int(step) + 1)
    return torch.Generator().manual_seed(s)


def _categorical(logits: torch.Tensor, gen: torch.Generator) -> torch.Tensor:
    """One draw per row of ``logits`` (..., n) by the Gumbel-max trick."""
    u = torch.rand(logits.shape, generator=gen)
    g = -torch.log(-torch.log(u.clamp_min(1e-20)))
    return torch.argmax(logits + g, dim=-1)


class Prefetcher:
    """Lookahead wrapper for seekable batch sources.

    ``prefetch(step)`` starts ``batch_at(step)`` on a background thread;
    ``batch_at(step)`` consumes the result (or computes directly on a
    miss — prefetching is purely an overlap optimization). ``batch_at``
    is a pure function of ``step``, so a prefetched batch equals the
    direct one, and entries for steps a restore rewound past age out.
    Only the trainer thread calls ``prefetch``/``batch_at``; a worker
    only runs the wrapped source and finishes its one batch.
    """

    #: prefetched steps kept around before the oldest is dropped
    MAX_SLOTS = 4

    def __init__(self, source):
        self._source = source
        self._fetch = (source.batch_at if hasattr(source, "batch_at")
                       else source)
        self._pending: dict[int, Future] = {}
        self._lock = threading.Lock()

    def prefetch(self, step: int) -> None:
        """Start computing ``batch_at(step)`` in the background
        (idempotent per step)."""
        step = int(step)
        with self._lock:
            if step in self._pending:
                return
            fut: Future = Future()
            self._pending[step] = fut
            while len(self._pending) > self.MAX_SLOTS:
                self._pending.pop(next(iter(self._pending)))

        def work():
            try:
                fut.set_result(self._fetch(step))
            except BaseException as e:  # surfaced on consumption
                fut.set_exception(e)

        threading.Thread(target=work, daemon=False).start()

    def batch_at(self, step: int):
        with self._lock:
            fut = self._pending.pop(int(step), None)
        if fut is not None:
            return fut.result()
        return self._fetch(int(step))


@dataclass
class TokenStream:
    """Batches of ``batch`` sequences of ``seq_len`` tokens as CPU int64
    tensors ``{"inputs", "labels"}`` (labels: inputs shifted by one)."""
    vocab_size: int
    batch: int
    seq_len: int
    seed: int = 0
    n_states: int = 256   # Markov structure lives on vocab % n_states
    temperature: float = 1.0

    def __post_init__(self):
        g = _generator(self.seed)
        n = min(self.n_states, self.vocab_size)
        self._n = n
        # sparse-ish Markov kernel over n states
        self._trans = torch.randn((n, n), generator=g) * 2.0
        # Zipfian unigram over the vocab, lifted in blocks of n ids
        ranks = torch.arange(1, self.vocab_size + 1, dtype=torch.float32)
        self._blocks = (-torch.log(ranks))[:self.vocab_size // n * n:n]

    def batch_at(self, step: int) -> dict:
        """Pure function of step — seekable/restartable."""
        g = _generator(self.seed, step)
        n, b, length = self._n, self.batch, self.seq_len + 1
        tok = torch.randint(0, self.vocab_size, (b,), generator=g)
        blocks = _categorical(self._blocks.expand(b, length, -1), g)
        noise = torch.rand((b, length, n), generator=g).clamp_min(1e-20)
        gumbel = -torch.log(-torch.log(noise))
        toks = torch.empty((b, length), dtype=torch.int64)
        for i in range(length):
            logits = self._trans[tok % n] / self.temperature
            state = torch.argmax(logits + gumbel[:, i], dim=-1)
            tok = (blocks[:, i] * n + state) % self.vocab_size
            toks[:, i] = tok
        return {"inputs": toks[:, :-1].contiguous(),
                "labels": toks[:, 1:].contiguous()}


def teacher_classification(n: int, d: int = 784, classes: int = 10,
                           hidden: int = 64, seed: int = 7, device=None):
    """(x (n, d) f32, y (n,) int64) from a fixed random teacher MLP, on
    ``device`` (``None``: the card)."""
    dev = resolve_device(device)
    g = _generator(seed)
    x = torch.randn((n, d), generator=g)
    w1 = torch.randn((d, hidden), generator=g) / math.sqrt(d)
    w2 = torch.randn((hidden, classes), generator=g) / math.sqrt(hidden)
    y = torch.argmax(torch.tanh(x @ w1) @ w2, dim=-1)
    return x.to(dev), y.to(dev)


def gaussian_blobs(n: int, d: int = 784, classes: int = 10,
                   sigma: float = 1.0, seed: int = 7, device=None):
    """Class-conditional Gaussians → (x (n, d) f32, y (n,) int64) on
    ``device`` (``None``: the card). Learnable to ~0 error: the MNIST
    stand-in of the LeNet300 showcase."""
    dev = resolve_device(device)
    g = torch.Generator().manual_seed(seed)
    means = torch.randn((classes, d), generator=g)
    y = torch.randint(0, classes, (n,), generator=g)
    x = means[y] + sigma * torch.randn((n, d), generator=g)
    return x.to(dev), y.to(dev)


def embedding_stream(batch: int, seq_len: int, d_input: int,
                     vocab_size: int, seed: int = 0):
    """Stub modality frontend stream (VLM patches / audio frames):
    precomputed bf16 embeddings + token labels, CPU tensors."""
    def batch_at(step: int) -> dict:
        g = _generator(seed, step)
        return {
            "inputs": torch.randn((batch, seq_len, d_input),
                                  generator=g).to(torch.bfloat16),
            "labels": torch.randint(0, vocab_size, (batch, seq_len),
                                    generator=g),
        }
    return batch_at
