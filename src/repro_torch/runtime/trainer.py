"""LCTrainer: the production training loop.

Port of ``src/repro/runtime/trainer.py``:

    for each LC step k (μ = μ0·aᵏ):
        L step  — ``steps_per_l`` train steps (loss + penalty, AdamW)
        C step  — Θ ← Π(w − λ/μ), grouped, on the kernels
        λ step  — multiplier update
        monitors — the C step's shifted distortion must not rise (§7)

    throughout: checkpoint every N steps (async), retry transient
    failures, restore-from-checkpoint on hard failure, straggler
    tracking, deterministic seekable data (exact resume).

Two execution modes (``TrainerConfig.overlap``):

* ``"off"`` — the serial loop above: every C step drains the card
  before the next L step starts; the C and multiplier steps update the
  LC state's ``a``/λ in place.
* ``"on"`` — the double-buffered pipeline. The C step of an LC boundary
  depends only on (w, λ, μ) at the boundary, so it is queued on a
  second CUDA stream (which first waits for the main stream's L step)
  and the next L step starts at once on the main stream against the
  previous Δ(Θ)/λ refs; the fresh refs are swapped in between
  microbatches once the C step's event has completed (or after a fixed
  ``swap_after`` microbatches). The train step is functional, so the
  boundary's parameter tensors are a snapshot that no later L step
  writes; every tensor that crosses the streams is marked with
  ``record_stream`` so the caching allocator reuses none of it while the
  other stream may still read it. On the CPU the same pipeline runs
  with the C step done at dispatch.

There is no mesh: a trainer given one raises (ROADMAP item 14, the
sharding layer).
"""
from __future__ import annotations

import logging
import time
from contextlib import nullcontext
from dataclasses import dataclass, replace
from typing import Callable

import numpy as np
import torch

from repro_torch.checkpoint import CheckpointManager
from repro_torch.core.algorithm import LCAlgorithm
from repro_torch.core.state import probe_is_ready, ready_probe
from repro_torch.core.tasks import get_path, set_path
from repro_torch.data.pipeline import Prefetcher
from repro_torch.interop import resolve_device
from repro_torch.launch.steps import (
    init_train_state, make_train_step, stable_lc_refs)
from repro_torch.optim import AdamW
from repro_torch.runtime.fault_tolerance import (
    FaultInjector, RetryPolicy, StragglerMonitor)
from repro_torch.tree import tree_leaves, tree_map

log = logging.getLogger("repro_torch.trainer")


@dataclass
class TrainerConfig:
    steps_per_l: int = 20
    ckpt_every: int = 50
    ckpt_dir: str | None = None
    keep_last: int = 3
    lr: float = 3e-4
    clip_norm: float = 1.0
    straggler_factor: float = 3.0
    # paper §7 monitor: the C step must not increase its own objective
    # ‖(w − λ/μ) − Δ(Θ)‖² at fixed (w, λ, μ)
    monitor_distortion: bool = True
    # give up (re-raise) after this many consecutive hard-failure
    # restores with no completed step in between
    max_restores: int = 3
    # "off" = serial loop, "on" = double-buffered pipeline
    overlap: str = "off"
    # with overlap on: force the ref swap after this many microbatches
    # of the next L step; None = as soon as the C step's event completes
    swap_after: int | None = None
    # kernel dispatch backend of the C step ("auto" | "torch" | "cuda" |
    # "off"), handed to LCAlgorithm.set_backend when set; None keeps the
    # algorithm's own
    cstep_backend: str | None = None
    # build the next L step's first batch on a thread while the LC
    # boundary is queued (batch_at is pure in step: bit-neutral)
    prefetch_data: bool = True


def _record(tree, stream) -> None:
    """Mark every CUDA tensor of ``tree`` as used on ``stream``."""
    for leaf in tree_leaves(tree):
        if isinstance(leaf, torch.Tensor) and leaf.is_cuda:
            leaf.record_stream(stream)


class LCTrainer:
    def __init__(self, cfg, lc: LCAlgorithm, data, mesh=None,
                 tcfg: TrainerConfig | None = None,
                 optimizer: AdamW | None = None,
                 fault_injector: FaultInjector | None = None,
                 overlap: str | None = None, device=None):
        if mesh is not None:
            raise NotImplementedError(
                "LCTrainer runs on one device: the sharding layer (mesh) "
                "is not ported yet (ROADMAP item 14)")
        self.device = resolve_device(device)
        if lc.device != self.device:
            raise ValueError(f"the LCAlgorithm runs on {lc.device}, the "
                             f"trainer on {self.device}")
        self.cfg = cfg
        self.lc = lc
        self.data = data
        self.tcfg = tcfg or TrainerConfig()
        if overlap is not None:
            self.tcfg = replace(self.tcfg, overlap=overlap)
        if self.tcfg.overlap not in ("off", "on"):
            raise ValueError(
                f"overlap must be 'off' or 'on', got {self.tcfg.overlap!r}")
        if self.tcfg.cstep_backend is not None \
                and self.tcfg.cstep_backend != lc.cstep_backend:
            lc.set_backend(self.tcfg.cstep_backend)
        self._prefetcher = (Prefetcher(data)
                            if self.tcfg.prefetch_data else None)
        self.optimizer = optimizer or AdamW()
        self.retry = RetryPolicy()
        self.straggler = StragglerMonitor(
            factor=self.tcfg.straggler_factor)
        self.faults = fault_injector or FaultInjector()
        self.ckpt = (CheckpointManager(self.tcfg.ckpt_dir,
                                       self.tcfg.keep_last)
                     if self.tcfg.ckpt_dir else None)
        self._train_step = make_train_step(
            cfg, self.optimizer, lr=self.tcfg.lr,
            clip_norm=self.tcfg.clip_norm, with_lc=True)
        # the overlapped pipeline's second stream (CUDA only)
        self._side = (torch.cuda.Stream(self.device)
                      if self.device.type == "cuda" else None)
        self.history: list[dict] = []
        # in-flight LC boundary of the overlapped pipeline
        self._pending: dict | None = None

    # ------------------------------------------------------------------
    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def init_state(self, key, state: dict | None = None):
        """A train state from seed ``key`` (params drawn by a generator on
        the trainer's device), or ``state`` as given (for instance the
        JAX package's, carried over by ``interop.train_state_from_numpy``),
        with its LC refs set from the algorithm's direct compression."""
        if state is None:
            gen = torch.Generator(device=self.device).manual_seed(int(key))
            state = init_train_state(gen, self.cfg, self.optimizer,
                                     with_lc=True)
        lc_state = self.lc.init(state["params"])
        state["lc"] = self._refs_from_lc(state["params"], lc_state)
        self._lc_state = lc_state
        return state

    def _refs_from_lc(self, params, lc_state):
        """Flatten LC (a, λ) into the train-state penalty refs."""
        a, lam = {}, {}
        for t in self.lc.tasks:
            ts = lc_state["tasks"][t.name]
            for p in t.paths:
                a[p] = ts["a"][p]
                lam[p] = ts["lam"][p]
        return {"a": a, "lam": lam, "mu": lc_state["mu"]}

    # ------------------------------------------------------------------
    def _batch(self, step: int) -> dict:
        if self._prefetcher is not None:
            batch = self._prefetcher.batch_at(step)
        else:
            batch = self.data.batch_at(step) \
                if hasattr(self.data, "batch_at") else self.data(step)
        return {k: torch.as_tensor(v).to(self.device)
                for k, v in batch.items()}

    def _one_step(self, state, step: int):
        self.faults.maybe_fail(step)
        return self._train_step(state, self._batch(step))

    def _restore_state(self, state):
        """Hard-failure restore with consistent LC bookkeeping: leaves
        back on the devices of those they replace; the step counter
        REWINDS to the checkpoint's (the data is seekable, training
        replays from the restored weights); the penalty refs re-synced
        from the algorithm's current LC state at the *current* μ.
        Returns ``(state, next_step)``."""
        restored, _ = self.ckpt.restore(state)
        next_step = int(restored["step"])
        # the LC state may be an in-flight boundary's (overlap on)
        self._pending_to_main()
        refs = self._refs_from_lc(restored["params"], self._lc_state)
        restored["lc"] = dict(refs, mu=state["lc"]["mu"])
        return restored, next_step

    def _l_step(self, state, lc_k: int, global_step: int,
                on_microbatch: Callable | None = None):
        """One full L step = steps_per_l optimizer steps. Returns
        ``(state, last_metrics, next_global_step)``; on a hard failure
        (retries exhausted) the latest checkpoint is restored and the
        step counter rewinds to it. ``on_microbatch(state, done) ->
        state`` runs after every completed microbatch (the overlapped
        pipeline's swap hook)."""
        metrics = {}
        step = global_step
        end_step = global_step + self.tcfg.steps_per_l
        done = 0
        restores = 0  # consecutive, reset by any completed step
        while step < end_step:
            t0 = time.time()
            try:
                state, metrics = self.retry.run(
                    self._one_step, state, step,
                    on_retry=lambda a, e: log.warning(
                        "step %d retry %d: %s", step, a, e))
            except RuntimeError:
                if self.ckpt:
                    self.ckpt.wait()
                if self.ckpt and self.ckpt.latest_step() is not None \
                        and restores < self.tcfg.max_restores:
                    restores += 1
                    log.error("step %d hard failure — restoring (%d/%d)",
                              step, restores, self.tcfg.max_restores)
                    state, step = self._restore_state(state)
                    continue
                raise
            restores = 0
            dt = time.time() - t0
            if self.straggler.observe(dt):
                log.warning("straggler: step %d took %.3fs", step, dt)
            if self.ckpt and step > 0 \
                    and step % self.tcfg.ckpt_every == 0:
                self.ckpt.save(state, step)
            step += 1
            done += 1
            if on_microbatch is not None:
                state = on_microbatch(state, done)
        return state, metrics, step

    # ------------------------------------------------------------------
    def run(self, key, n_lc_steps: int | None = None, *,
            state: dict | None = None):
        """The LC run from seed ``key`` (or from ``state``, see
        :meth:`init_state`). Returns ``(train state, LC state)``; one
        record per LC step in ``self.history``."""
        state = self.init_state(key, state)
        schedule = self.lc.mu_schedule[:n_lc_steps] \
            if n_lc_steps else self.lc.mu_schedule
        global_step = int(state["step"])

        for g in self.lc.group_summary(state["params"]):
            log.info("c-step group: %s over %s (%d items, tasks=%s, "
                     "backend=%s)", g["scheme"], g["item_shape"],
                     g["items"], g["tasks"], g["backend"])

        if self.tcfg.overlap == "on":
            return self._run_overlapped(state, schedule, global_step)
        return self._run_serial(state, schedule, global_step)

    # ------------------------------------------------------------------
    def _run_serial(self, state, schedule, global_step: int):
        """The reference loop: C step and monitors drain the device at
        every LC boundary."""
        lc_state = self._lc_state
        for k, mu in enumerate(schedule):
            lc_state = self.lc.set_mu(lc_state, mu, k)
            self._lc_state = lc_state
            state["lc"] = self._refs_from_lc(state["params"], lc_state)
            pen0 = float(self.lc.penalty(state["params"], lc_state))

            state, metrics, global_step = self._l_step(
                state, k, global_step)

            params = state["params"]
            d_pre = None
            if self.tcfg.monitor_distortion:
                d_pre = self.lc.shifted_distortion(params, lc_state)
            # drain the L step so c_step_ms times the C step alone
            self._sync()
            t0 = time.time()
            lc_state = self.lc.c_step(params, lc_state)
            self._sync()
            c_step_ms = (time.time() - t0) * 1e3
            c_violations = []
            if d_pre is not None:
                d_post = self.lc.shifted_distortion(params, lc_state)
                c_violations = self._check_violations(d_pre, d_post)
            lc_state = self.lc.multiplier_step(params, lc_state)
            self._lc_state = lc_state
            state["lc"] = self._refs_from_lc(params, lc_state)

            dist = {n: float(v) for n, v in
                    self.lc.distortion(params, lc_state).items()}
            rec = {
                "lc_step": k, "mu": float(mu),
                "loss": float(metrics.get("loss", np.nan)),
                "ce": float(metrics.get("ce", np.nan)),
                "penalty_start": pen0,
                "distortion": dist,
                "c_step_ms": c_step_ms,
                "c_step_violations": c_violations,
                "compression_ratio": float(
                    self.lc.compression_ratio(params, lc_state)),
                "stragglers": self.straggler.stragglers,
            }
            self.history.append(rec)
            log.info("LC step %d: %s", k, rec)

        self._lc_state = lc_state
        if self.ckpt:
            self.ckpt.save(state, global_step, blocking=True)
        return state, lc_state

    # ------------------------------------------------------------------
    def _run_overlapped(self, state, schedule, global_step: int):
        """Double-buffered pipeline: queue the C step of each LC boundary
        on the side stream, run the next L step against the previous
        Δ(Θ)/λ refs, swap the fresh refs in between microbatches.

        Only the boundary snapshot (w, λ, μ) feeds the C step, so its
        result is independent of the microbatches it overlaps with; the
        first microbatches of L step k+1 optimize against the previous
        Δ(Θ)/λ at the *new* μ. Monitors are queued with the C step and
        read only when the step's record is emitted; ``c_step_ms`` is the
        dispatch→ready wall time of the C+λ chain, measured by polling
        (granularity: one microbatch)."""
        lc_state = self._lc_state
        self._pending = None  # a prior aborted run must not leak in
        swap_after = self.tcfg.swap_after

        def on_microbatch(st, done):
            if self._pending is None:
                return st
            deadline = swap_after is not None and done >= swap_after
            if deadline or (swap_after is None
                            and probe_is_ready(self._pending["probe"])):
                st = self._apply_pending(st, block=deadline, done=done)
            return st

        for k, mu in enumerate(schedule):
            lc_state = self.lc.set_mu(lc_state, mu, k)
            self._lc_state = lc_state
            if self._pending is None:
                # cold boundary (first LC step): fresh refs, as serial
                state["lc"] = self._refs_from_lc(state["params"], lc_state)
            else:
                # stale-refs window: keep the previous Δ(Θ)/λ while the
                # C step runs; only μ advances now
                state["lc"] = dict(state["lc"], mu=lc_state["mu"])
            # the penalty at the L step's start reads the boundary's new
            # Δ(Θ)/λ: queued behind them, on the side stream
            with self._on_side():
                pen0 = self.lc.penalty(state["params"], lc_state)
            self._record_side(state["params"], lc_state)

            state, metrics, global_step = self._l_step(
                state, k, global_step, on_microbatch=on_microbatch)

            # boundary k consumes the post-multiplier λ of boundary k-1
            if self._pending is not None:
                state = self._apply_pending(
                    state, block=True, done=self.tcfg.steps_per_l)

            # ---- LC boundary k: queue everything, wait for nothing
            params = state["params"]
            t_dispatch = time.time()
            with self._on_side():
                d_pre = (self.lc.shifted_distortion(params, lc_state)
                         if self.tcfg.monitor_distortion else None)
                lc_after_c = self.lc.c_step_async(params, lc_state)
                d_post = (self.lc.shifted_distortion(params, lc_after_c)
                          if self.tcfg.monitor_distortion else None)
                new_lc = self.lc.multiplier_step_async(params, lc_after_c)
                dist = self.lc.distortion(params, new_lc)
                probe = ready_probe(new_lc)
            self._record_side(params, lc_state)
            lc_state = new_lc
            # compression_ratio reads only the parameters' shapes; the
            # boundary's parameters are freed here (the allocator keeps
            # their memory until the side stream's work is done)
            param_shapes = tree_map(lambda x: x.detach().to("meta"), params)
            del params
            self._pending = {
                "k": k, "mu": float(mu), "metrics": metrics,
                "pen0": pen0, "params": param_shapes, "lc_state": lc_state,
                "d_pre": d_pre, "d_post": d_post, "dist": dist,
                "t_dispatch": t_dispatch, "t_ready": None, "probe": probe,
            }
            # start building the next L step's first batch while the
            # boundary is in flight (none after the last boundary)
            if self._prefetcher is not None and k + 1 < len(schedule):
                self._prefetcher.prefetch(global_step)

        # drain the final boundary (no L step left to overlap with)
        if self._pending is not None:
            state = self._apply_pending(state, block=True, done=None)
        self._lc_state = lc_state
        if self.ckpt:
            self.ckpt.save(state, global_step, blocking=True)
        return state, lc_state

    def _on_side(self):
        """The side stream's context, after it waits for the work queued
        so far on the main stream (a no-op context on the CPU)."""
        if self._side is None:
            return nullcontext()
        self._side.wait_stream(torch.cuda.current_stream(self.device))
        return torch.cuda.stream(self._side)

    def _record_side(self, params, lc_state) -> None:
        """The compressed parameters and the LC state, made on the main
        stream, are read on the side stream: keep their memory from
        reuse until the side stream's work is done."""
        if self._side is not None:
            leaves = [get_path(params, p)
                      for t in self.lc.tasks for p in t.paths]
            _record((leaves, lc_state), self._side)

    def _pending_to_main(self) -> None:
        """Order the main stream's later work after the in-flight
        boundary, whose tensors it may now read."""
        p = self._pending
        if p is not None and p["probe"] is not None:
            main = torch.cuda.current_stream(self.device)
            main.wait_event(p["probe"])
            _record((p["lc_state"], p["pen0"]), main)

    def _apply_pending(self, state, block: bool, done: int | None):
        """Swap the in-flight boundary's fresh Δ(Θ)/λ into the penalty
        refs (see ``stable_lc_refs``) and emit the finished LC step's
        record. ``done`` is the microbatch count the stale window lasted
        (None = drained after the final L step)."""
        p = self._pending
        if block and p["probe"] is not None:
            p["probe"].synchronize()
        self._pending_to_main()
        if p["t_ready"] is None:
            p["t_ready"] = time.time()
        refs = self._refs_from_lc(state["params"], p["lc_state"])
        state["lc"] = stable_lc_refs(refs, state["lc"])
        self._pending = None

        c_violations = []
        if p["d_pre"] is not None:
            c_violations = self._check_violations(p["d_pre"], p["d_post"])
        dist = {n: float(v) for n, v in p["dist"].items()}
        rec = {
            "lc_step": p["k"], "mu": p["mu"],
            "loss": float(p["metrics"].get("loss", np.nan)),
            "ce": float(p["metrics"].get("ce", np.nan)),
            "penalty_start": float(p["pen0"]),
            "distortion": dist,
            "c_step_ms": (p["t_ready"] - p["t_dispatch"]) * 1e3,
            "c_step_violations": c_violations,
            "compression_ratio": float(
                self.lc.compression_ratio(p["params"], p["lc_state"])),
            "stragglers": self.straggler.stragglers,
            "swap_after_microbatches": done,
        }
        self.history.append(rec)
        log.info("LC step %d: %s", p["k"], rec)
        return state

    def _check_violations(self, d_pre, d_post) -> list[str]:
        out = []
        for n in d_pre:
            pre, post = float(d_pre[n]), float(d_post[n])
            if post > pre * (1 + 1e-5) + 1e-8:
                out.append(n)
                log.error(
                    "C step increased ‖(w−λ/μ)−Δ(Θ)‖² for task "
                    "%s: %.6g → %.6g (broken warm start?)",
                    n, pre, post)
        return out

    # ------------------------------------------------------------------
    def compressed_params(self, state, lc_state):
        """Final model: w ← Δ(Θ)."""
        params = state["params"]
        for t in self.lc.tasks:
            ts = lc_state["tasks"][t.name]
            for p in t.paths:
                leaf = get_path(params, p)
                params = set_path(params, p, ts["a"][p].to(leaf.dtype))
        return params
