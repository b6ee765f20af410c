"""The LC algorithm driver (paper Fig. 2).

Port of ``src/repro/core/algorithm.py``:

    w ← argmin_w L(w)                                  (pretrained model)
    Θ ← Π(w̄)                                           (direct compression)
    λ ← 0
    for μ = μ0 < μ1 < … :
        w ← argmin_w L(w) + μ/2‖w − Δ(Θ) − λ/μ‖²       (L step — user fn)
        Θ ← argmin_Θ ‖w − λ/μ − Δ(Θ)‖²                 (C step — schemes)
        λ ← λ − μ(w − Δ(Θ))                            (multipliers)

PyTorch runs eagerly: there is no ``jit`` counterpart and no
``torch.compile``. Where JAX donates the LC state to the C and multiplier
steps, the port updates the state's ``a`` and ``λ`` tensors in place:
a step consumes the state it is given and returns the new one. The
``*_async`` entry points, which the trainer's overlapped pipeline queues
on a second CUDA stream, write nothing in place (see ``core/state.py``).
The C step runs through the group planner by default (``planner="on"``,
``repro_torch.analysis.cost``), as the JAX driver's does; its inputs
w − λ/μ are made group by group (chunk by chunk where the planner splits
a group), never for every task at once. The mesh and sharding rules of
the JAX driver are not ported.

Everything runs on ``device``: ``None`` means the card, and the
constructor raises when CUDA is absent. Parameters handed in must live
on that device; nothing is moved or falls back.
"""
from __future__ import annotations

from collections.abc import Mapping
from dataclasses import dataclass, field
from typing import Callable, Sequence

import torch

from repro_torch.core import state as lcstate
from repro_torch.core.grouping import (
    describe_groups, grouped_compress, grouped_init, solve_task)
from repro_torch.core.penalty import lc_penalty
from repro_torch.core.tasks import (
    CompressionTask, check_disjoint, flatten_params, get_path, set_path)
from repro_torch.core.views import AsVector
from repro_torch.interop import resolve_device
from repro_torch.kernels.dispatch import REQUESTS
from repro_torch.tree import tree_leaves, tree_map


def exponential_mu_schedule(mu0: float, a: float, n_steps: int):
    """μ_k = μ0·a^k (paper §7: a ∈ [1.1, 1.4])."""
    return [mu0 * a**k for k in range(n_steps)]


@dataclass
class LCMetrics:
    step: int
    mu: float
    distortion: dict[str, float]      # per task: ‖w − Δ(Θ)‖²
    penalty: float
    compression_ratio: float
    # per task: the §7 monitor, shifted distortion (before, after) the C
    # step at the same (w, λ, μ); a C step must not raise it
    c_step_shifted_distortion: dict[str, tuple[float, float]] = \
        field(default_factory=dict)


class _ShiftedInputs(Mapping):
    """The C step's inputs w − λ/μ by task name, each made when it is
    read and not kept: the grouped C step reads a task's input for its
    shape and again where it packs the task's items, so only the group
    (or the planner's chunk) being packed holds its inputs, not every
    task at once (at mixtral's width, 1.75 GiB an expert stack)."""

    def __init__(self, tasks, params, lc):
        self._tasks = {t.name: t for t in tasks}
        self._params = params
        self._lc = lc

    def __getitem__(self, name):
        return self._tasks[name].shifted_compressible(
            self._params, self._lc["tasks"][name], self._lc["mu"])

    def __iter__(self):
        return iter(self._tasks)

    def __len__(self):
        return len(self._tasks)


class LCAlgorithm:
    """Orchestrates L/C/multiplier steps over a params tree."""

    def __init__(self, tasks: Sequence[CompressionTask],
                 mu_schedule: Sequence[float],
                 l_step: Callable | None = None,
                 group_tasks: bool = True,
                 cstep_backend: str | None = "auto",
                 planner: str | None = "on",
                 device=None):
        self.tasks = list(tasks)
        self.mu_schedule = list(mu_schedule)
        self.l_step = l_step
        self.group_tasks = bool(group_tasks)
        # kernel dispatch backend for opted-in scheme solvers
        # ("auto" | "torch" | "cuda" | "off"), resolved per group by
        # repro_torch.kernels.dispatch
        self.cstep_backend = self._check_backend(cstep_backend)
        # roofline group planner ("on" | "off" | None ≡ "off"): backend
        # and chunking per group, memoized (repro_torch.analysis.cost)
        self.planner = self._check_planner(planner)
        self.device = resolve_device(device)
        self._resolved = False
        self._last_lc = None

    @staticmethod
    def _check_backend(backend):
        if backend is not None and backend not in REQUESTS:
            raise ValueError(f"cstep_backend must be one of {REQUESTS}, "
                             f"got {backend!r}")
        return backend

    def set_backend(self, backend: str | None) -> "LCAlgorithm":
        """Select the kernel dispatch backend of the C step."""
        self.cstep_backend = self._check_backend(backend)
        return self

    @staticmethod
    def _check_planner(planner):
        valid = ("on", "off", None)
        if planner not in valid:
            raise ValueError(
                f"planner must be one of {valid}, got {planner!r}")
        return planner

    def set_planner(self, planner: str | None) -> "LCAlgorithm":
        """Turn the C step's group planner on or off. The result is the
        same bit for bit either way; the plan decides how it is run."""
        self.planner = self._check_planner(planner)
        return self

    def _check_device(self, params):
        for p, leaf in flatten_params(params).items():
            if leaf.device != self.device:
                raise ValueError(
                    f"parameter {p} is on {leaf.device}, but this "
                    f"LCAlgorithm runs on {self.device}")

    # ------------------------------------------------------------------
    def resolve(self, params):
        if not self._resolved:
            resolved = []
            for t in self.tasks:
                t = t.resolve(params)
                if len(t.paths) > 1 and not isinstance(t.view, AsVector):
                    # single-array views over a multi-leaf selector = one
                    # independent task per leaf (per-layer compression)
                    for i, p in enumerate(t.paths):
                        resolved.append(CompressionTask(
                            f"{t.name}[{i}]", t.pattern, t.view,
                            t.scheme, [p]))
                else:
                    resolved.append(t)
            self.tasks = resolved
            check_disjoint(self.tasks)
            self._resolved = True
        return self

    @torch.no_grad()
    def init(self, params) -> dict:
        """Θ ← Π(w̄), λ ← 0 (direct compression). With ``group_tasks``
        the Θ^DC solves run through :func:`grouped_init`; both paths give
        the same state."""
        self.resolve(params)
        self._check_device(params)
        tasks_state = {}
        if self.group_tasks:
            xs = {t.name: t.compressible(params) for t in self.tasks}
            results = grouped_init(self.tasks, xs)
        for t in self.tasks:
            if self.group_tasks:
                theta, a_arr = results[t.name]
            else:
                theta = t.scheme_init(t.compressible(params))
                a_arr = t.scheme_decompress(theta)
            a = t.scatter_decompressed(a_arr, params)
            lam = lcstate.zeros_like_leaves(t.paths, t.leaves(params))
            tasks_state[t.name] = lcstate.task_state(theta, lam, a)
        return lcstate.lc_state(tasks_state, self.mu_schedule[0], 0,
                                self.device)

    # ------------------------------------------------------------------
    def _solve(self, params, lc) -> dict:
        """{task name: (Θ, Δ(Θ) in the task's view)} of Π(w − λ/μ)."""
        mu = lc["mu"]
        xs = _ShiftedInputs(self.tasks, params, lc)
        if self.group_tasks:
            thetas = {t.name: lc["tasks"][t.name]["theta"]
                      for t in self.tasks}
            results = grouped_compress(self.tasks, xs, thetas, mu,
                                       backend=self.cstep_backend,
                                       device=self.device,
                                       planner=self.planner)
        else:
            results = {}
            for t in self.tasks:
                theta = solve_task(t, xs[t.name],
                                   lc["tasks"][t.name]["theta"], mu,
                                   backend=self.cstep_backend,
                                   device=self.device)
                results[t.name] = (theta, t.scheme_decompress(theta))
        return results

    @torch.no_grad()
    def c_step(self, params, lc) -> dict:
        """Θ ← Π(w − λ/μ) for every task; ``a`` is updated in place.

        With ``group_tasks`` the tasks are solved in groups (one kernel
        launch per solver step per group on the card); otherwise task by
        task. Kernel dispatch applies on both paths."""
        results = self._solve(params, lc)
        new_tasks = {}
        for t in self.tasks:
            ts = lc["tasks"][t.name]
            theta, a_arr = results.pop(t.name)
            for p, leaf in t.scatter_decompressed(a_arr, params).items():
                ts["a"][p].copy_(leaf)
            new_tasks[t.name] = lcstate.task_state(theta, ts["lam"],
                                                   ts["a"])
        return lcstate.with_tasks(lc, new_tasks)

    @torch.no_grad()
    def c_step_async(self, params, lc) -> dict:
        """:meth:`c_step` for the overlapped trainer: the same Θ and
        ``a``, bit for bit, in new tensors. Nothing of ``lc`` is written:
        the L step in flight beside it still reads the old ``a``."""
        results = self._solve(params, lc)
        new_tasks = {}
        for t in self.tasks:
            theta, a_arr = results.pop(t.name)
            new_tasks[t.name] = lcstate.task_state(
                theta, lc["tasks"][t.name]["lam"],
                t.scatter_decompressed(a_arr, params))
        return lcstate.with_tasks(lc, new_tasks)

    def group_summary(self, params) -> list[dict]:
        """The grouping the C step will use, from shapes only (the views
        run on meta tensors: no compute, no device memory), with each
        multi-task group's plan when the planner is on."""
        self.resolve(params)
        xs = {t.name: t.view.to_compressible(
                  [l.detach().to("meta") for l in t.leaves(params)])
              for t in self.tasks}
        return describe_groups(self.tasks, xs, backend=self.cstep_backend,
                               device=self.device, planner=self.planner)

    @torch.no_grad()
    def multiplier_step(self, params, lc) -> dict:
        """λ ← λ − μ(w − Δ(Θ)) (augmented Lagrangian), λ in place."""
        mu = lc["mu"]
        for t in self.tasks:
            ts = lc["tasks"][t.name]
            for p in t.paths:
                ts["lam"][p].sub_(
                    mu * (get_path(params, p).float() - ts["a"][p]))
        return lcstate.with_tasks(lc, lc["tasks"])

    @torch.no_grad()
    def multiplier_step_async(self, params, lc) -> dict:
        """:meth:`multiplier_step` into new λ tensors (the old λ is still
        read by the L step in flight), the same values bit for bit."""
        mu = lc["mu"]
        new_tasks = {}
        for t in self.tasks:
            ts = lc["tasks"][t.name]
            lam = {p: ts["lam"][p]
                   - mu * (get_path(params, p).float() - ts["a"][p])
                   for p in t.paths}
            new_tasks[t.name] = lcstate.task_state(ts["theta"], lam,
                                                   ts["a"])
        return lcstate.with_tasks(lc, new_tasks)

    def set_mu(self, lc, mu: float, k: int) -> dict:
        return {"tasks": lc["tasks"],
                "mu": torch.tensor(float(mu), dtype=torch.float32,
                                   device=self.device),
                "k": torch.tensor(int(k), dtype=torch.int32,
                                  device=self.device)}

    # ------------------------------------------------------------------
    @torch.no_grad()
    def penalty(self, params, lc) -> torch.Tensor:
        return lc_penalty(params, lc, self.tasks)

    @torch.no_grad()
    def distortion(self, params, lc) -> dict[str, torch.Tensor]:
        """‖w − Δ(Θ)‖² per task."""
        out = {}
        for t in self.tasks:
            ts = lc["tasks"][t.name]
            d = torch.zeros((), dtype=torch.float32, device=self.device)
            for p in t.paths:
                diff = get_path(params, p).float() - ts["a"][p]
                d = d + torch.sum(diff * diff)
            out[t.name] = d
        return out

    @torch.no_grad()
    def shifted_distortion(self, params, lc) -> dict[str, torch.Tensor]:
        """‖(w − λ/μ) − Δ(Θ)‖² per task — the exact C-step objective. A
        warm-started C step never increases it at fixed (w, λ, μ): the
        paper §7 monitor."""
        out = {}
        mu = lc["mu"]
        for t in self.tasks:
            ts = lc["tasks"][t.name]
            x = t.shifted_compressible(params, ts, mu).float()
            a = t.view.to_compressible([ts["a"][p] for p in t.paths])
            out[t.name] = torch.sum((x - a) ** 2)
        return out

    def constraint_violation(self, params, lc) -> torch.Tensor:
        """‖w − Δ(Θ)‖ over all tasks — the convergence monitor."""
        return torch.sqrt(sum(self.distortion(params, lc).values()))

    def compression_ratio(self, params, lc, float_bits: int = 32) -> float:
        """(uncompressed bits of compressed params) / (Θ bits)."""
        orig_bits = 0.0
        comp_bits = 0.0
        for t in self.tasks:
            theta = lc["tasks"][t.name]["theta"]
            for p in t.paths:
                orig_bits += get_path(params, p).numel() * float_bits
            if t.view.stacked:
                # bits() can be item-dependent, so sum per item
                for i in range(tree_leaves(theta)[0].shape[0]):
                    item = tree_map(lambda x, i=i: x[i], theta)
                    comp_bits += float(t.scheme.bits(item, float_bits))
            else:
                comp_bits += float(t.scheme.bits(theta, float_bits))
        return orig_bits / max(comp_bits, 1.0)

    def apply_compression(self, params):
        """w ← Δ(Θ) in the params tree — the final compressed model (from
        the latest C step); the input tree is left as it was."""
        lc = self._last_lc
        out = params
        for t in self.tasks:
            ts = lc["tasks"][t.name]
            for p in t.paths:
                leaf = get_path(params, p)
                out = set_path(out, p, ts["a"][p].to(leaf.dtype).clone())
        return out

    # ------------------------------------------------------------------
    def run(self, train_state, params_of: Callable, tol: float = 0.0,
            callbacks: Sequence[Callable] = ()):
        """Full LC loop (paper Fig. 2). ``self.l_step(train_state, lc, k)
        -> train_state`` runs one L step; ``params_of(train_state)`` gives
        the params tree. The metrics, with the §7 monitor around every C
        step, are read on the host every LC step (one sync per step, as
        in the JAX driver)."""
        assert self.l_step is not None, "provide l_step to run()"
        params = params_of(train_state)
        lc = self.init(params)
        self._last_lc = lc
        history = []
        for k, mu in enumerate(self.mu_schedule):
            lc = self.set_mu(lc, mu, k)
            train_state = self.l_step(train_state, lc, k)
            params = params_of(train_state)
            pre = self.shifted_distortion(params, lc)
            lc = self.c_step(params, lc)
            post = self.shifted_distortion(params, lc)
            lc = self.multiplier_step(params, lc)
            self._last_lc = lc
            m = LCMetrics(
                step=k, mu=float(mu),
                distortion={n: float(v) for n, v in
                            self.distortion(params, lc).items()},
                penalty=float(self.penalty(params, lc)),
                compression_ratio=float(
                    self.compression_ratio(params, lc)),
                c_step_shifted_distortion={
                    n: (float(pre[n]), float(post[n])) for n in pre},
            )
            history.append(m)
            for cb in callbacks:
                cb(train_state, lc, m)
            if tol > 0 and float(
                    self.constraint_violation(params, lc)) < tol:
                break
        return train_state, lc, history
