"""Fault-tolerance policies for the training loop.

A copy of ``src/repro/runtime/fault_tolerance.py`` (pure Python).

Designed for 1000+-node behavior, exercised here via fault injection:

* ``RetryPolicy`` — transient step failures (preempted host, flaky ICI
  link surfacing as RuntimeError) retry with exponential backoff; after
  ``max_retries`` the trainer falls back to restore-from-checkpoint.
* ``StragglerMonitor`` — per-step wall times vs a rolling median; a step
  slower than ``factor``× median marks a straggler. The trainer's
  response is pluggable (log / re-shard via elastic reload / evict).
* ``FaultInjector`` — deterministic fault schedule for tests ("fail step
  17 twice, then succeed"), so recovery paths are unit-testable.
"""
from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass


@dataclass
class RetryPolicy:
    max_retries: int = 3
    backoff_s: float = 0.05
    backoff_mult: float = 2.0

    def run(self, fn, *args, on_retry=None, **kwargs):
        delay = self.backoff_s
        last = None
        for attempt in range(self.max_retries + 1):
            try:
                return fn(*args, **kwargs)
            except (RuntimeError, OSError) as e:  # transient class
                last = e
                if attempt == self.max_retries:
                    raise
                if on_retry:
                    on_retry(attempt, e)
                time.sleep(delay)
                delay *= self.backoff_mult
        raise last  # unreachable


@dataclass
class StragglerMonitor:
    factor: float = 3.0
    window: int = 32
    times: deque | None = None
    stragglers: int = 0

    def __post_init__(self):
        if self.times is None:
            self.times = deque(maxlen=self.window)
        elif self.times.maxlen != self.window:
            # caller handed in samples: keep the newest `window` of them
            self.times = deque(self.times, maxlen=self.window)

    def observe(self, dt: float) -> bool:
        """Record a step time; True if this step straggled."""
        is_straggler = False
        if len(self.times) >= 8:
            med = sorted(self.times)[len(self.times) // 2]
            is_straggler = dt > self.factor * med
        self.times.append(dt)
        if is_straggler:
            self.stragglers += 1
        return is_straggler


class FaultInjector:
    """fail_at: {step: n_failures} — raise RuntimeError n times at step."""

    def __init__(self, fail_at: dict[int, int] | None = None):
        self.fail_at = dict(fail_at or {})
        self.injected = 0

    def maybe_fail(self, step: int):
        n = self.fail_at.get(step, 0)
        if n > 0:
            self.fail_at[step] = n - 1
            self.injected += 1
            raise RuntimeError(f"injected fault at step {step}")
