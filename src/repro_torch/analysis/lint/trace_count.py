"""Recapture detection at LC boundaries and in serving (the dynamic half
of layer 3).

Port of ``src/repro/analysis/lint/trace_count.py``. Where the reference
counts jit traces, the port counts *program keys*
(``repro_torch.graphs``): a CUDA graph captured on the card
(``Programs.captured``), a distinct signature on the CPU, where programs
run eagerly. Every LC boundary runs the compiled driver's programs
(``core/grouping.py:CompiledSolves``: one a group's or task's solve; the
multiplier step and the distortions, ``core/algorithm.py:_program``) on
identically shaped state, so from the driver's C step number
``grouping.CAPTURE_AT`` on each program is keyed at one boundary and
replayed at every later one. A new key at a later boundary means
something shape-unstable or identity-bound leaked into the key (a Python
float μ, a fresh Θ shape, a re-made tensor held by address), and every
boundary pays a capture (an eager run and the capture) instead of a
replay; a driver that releases its graphs at every boundary never gets
to replay at all.

:func:`instrument` hooks one driver *instance*: each program its
``Programs`` makes (and those of a ``Programs`` made anew by
``release_graphs``) records the boundary at which it sees each new key,
a boundary being a ``set_mu`` call. The checks read that record, so they
can run boundaries of their own (the CLI's probes) or read a run that
instrumented its driver beforehand (``chip_smoke.py``'s LM path).
"""
from __future__ import annotations

from repro_torch.analysis.lint.findings import Finding

#: the driver's program names (``core/algorithm.py:_STEPS``) and the
#: steps they count under; every other program is a C-step solve
_STEP_OF = {"multipliers": "multiplier_step", "distortion": "distortion",
            "shifted distortion": "shifted_distortion"}


class TraceRecord(dict):
    """``{program label: keys seen}``, live; ``at[label]`` lists the
    boundary of each key, ``boundaries`` counts the boundaries run and
    ``jit`` says whether the driver runs its steps as programs. Labels
    are ``"c_step:<solve>"`` (a group's or task's solve) and the steps'
    names (``"multiplier_step"``, ...)."""

    def __init__(self, jit: bool):
        super().__init__()
        self.at: dict[str, list[int]] = {}
        self.boundaries = 0
        self.jit = jit
        # programs made under each label since the driver's last release
        self.made: dict[str, int] = {}

    def step_keys(self, step: str) -> int:
        """Keys seen by the programs of ``step`` (``"c_step"`` or a
        step's name)."""
        return sum(n for label, n in self.items()
                   if label.split(":", 1)[0] == step)


class _Keys(dict):
    """A program's ``counts`` dict: each new key the program sees
    (``graphs.Program.__call__`` sets ``counts[name]`` to its key count)
    is logged in the record under ``label``."""

    def __init__(self, record: TraceRecord, label: str):
        super().__init__()
        self.record, self.label = record, label

    def __setitem__(self, name, n):
        if n > self.get(name, 0):
            rec = self.record
            rec[self.label] = rec.get(self.label, 0) + n - self.get(name, 0)
            rec.at.setdefault(self.label, []).append(rec.boundaries)
        super().__setitem__(name, n)


def _label(name: str) -> str:
    if name in _STEP_OF:
        return _STEP_OF[name]
    return f"c_step:{name}"


def _hook(programs, record: TraceRecord) -> None:
    if programs is None:
        return
    make = programs.program

    def program(fn, held=(), name="program", counts=None):
        label = _label(name)
        n = record.made.get(label, 0)
        record.made[label] = n + 1
        # two programs of one name (two groups of one scheme) count apart;
        # after a release the programs made again take the same labels
        return make(fn, held, name,
                    _Keys(record, label if not n else f"{label}#{n}"))

    programs.program = program


def instrument(algo) -> TraceRecord:
    """Attach key counters to a compiled LC driver (or any object with
    ``programs``, ``release_graphs`` and ``set_mu``) and return the live
    :class:`TraceRecord`. Call it before the driver's first C step."""
    record = TraceRecord(bool(getattr(algo, "jit_c_step", True)))
    _hook(getattr(algo, "programs", None), record)
    release, set_mu = algo.release_graphs, algo.set_mu

    def released(*args, **kw):
        out = release(*args, **kw)
        record.made.clear()
        _hook(algo.programs, record)
        return out

    def set_mu_counted(*args, **kw):
        record.boundaries += 1
        return set_mu(*args, **kw)

    algo.release_graphs = released
    algo.set_mu = set_mu_counted
    return record


def run_boundaries(algo, params, lc, boundaries: int = 2,
                   overlap: bool = False):
    """Run ``boundaries`` identical LC boundaries (C step and multiplier
    step at the schedule's first μ), returning the new LC state.
    ``overlap=True`` drives the async entry points the overlapped
    trainer uses."""
    mu = float(algo.mu_schedule[0])
    for k in range(boundaries):
        lc = algo.set_mu(lc, mu, k)
        if overlap:
            lc = algo.c_step_async(params, lc)
            lc = algo.multiplier_step_async(params, lc)
        else:
            lc = algo.c_step(params, lc)
            lc = algo.multiplier_step(params, lc)
    return lc


def retraces(record: TraceRecord, context: str = "lc-boundaries"
             ) -> list[Finding]:
    """``boundary-retrace`` findings of an instrumented run: a program
    keyed at more than one boundary, and a compiled driver whose C step
    or multiplier step ran no program at all across boundaries that
    reached ``grouping.CAPTURE_AT`` (its capture policy restarted: every
    boundary ran eagerly)."""
    from repro_torch.core.grouping import CAPTURE_AT
    findings = []
    for label in sorted(record):
        at = sorted(set(record.at.get(label, ())))
        if len(at) > 1:
            findings.append(Finding(
                "boundary-retrace", "algorithm", f"{context}:{label}",
                f"{label} was keyed {record[label]}× at boundaries {at} of "
                f"{record.boundaries} identical LC boundaries (expected "
                "at one: a capture, then replays): something shape-"
                "unstable or identity-bound is leaking into the program "
                "key; check that μ enters as the 0-d tensor of set_mu and "
                "that Θ/λ shapes and held tensors are boundary-stable",
                layer="trace"))
    if record.jit and record.boundaries >= CAPTURE_AT:
        for step in ("c_step", "multiplier_step"):
            if not record.step_keys(step):
                findings.append(Finding(
                    "boundary-retrace", "algorithm", f"{context}:{step}",
                    f"{step} ran no program across {record.boundaries} "
                    f"identical LC boundaries (expected a capture at the "
                    f"driver's C step {CAPTURE_AT} and replays after): "
                    "the driver's graphs are released between boundaries "
                    "(release_graphs, set_mesh), so its capture policy "
                    "restarts and every boundary runs eagerly",
                    layer="trace"))
    return findings


def check_retraces(algo, params, lc, boundaries: int = 2,
                   context: str = "lc-boundaries",
                   overlap: bool = False) -> list[Finding]:
    """``boundary-retrace`` findings over ``boundaries`` identical
    boundaries beyond ``grouping.CAPTURE_AT``: the driver first runs the
    eager boundaries before its capture."""
    from repro_torch.core.grouping import CAPTURE_AT
    record = instrument(algo)
    run_boundaries(algo, params, lc, CAPTURE_AT - 1 + boundaries, overlap)
    return retraces(record, context)


def check_planner_cache(algo, params, lc, boundaries: int = 3,
                        context: str = "planner-cache") -> list[Finding]:
    """``planner-replan`` / ``planner-inactive`` findings for the group
    planner's memoization contract.

    Runs ``boundaries`` identical LC boundaries on a planner-on driver
    (0: the caller ran them), then forces ``algo.release_graphs()`` (the
    port's form of the reference's jit rebuild: every program and
    executable of the driver dropped) and runs one more C step. That C
    step plans every multi-task group again, and every lookup must HIT
    the plan cache: a miss means the plan key is unstable across
    rebuilds (an identity-based component) and each rebuild re-plans,
    and re-counts, every group."""
    from repro_torch.analysis import cost

    if getattr(algo, "planner", None) != "on":
        return [Finding(
            "planner-inactive", "algorithm", context,
            "planner-cache probe was handed a planner-off driver: the "
            "check is vacuous; construct the probe LCAlgorithm with "
            "planner='on'", layer="trace")]
    lc = run_boundaries(algo, params, lc, boundaries)
    before = cost.cache_stats()
    if before["plan_entries"] == 0:
        return [Finding(
            "planner-inactive", "algorithm", context,
            "planner-on boundaries planned zero groups: the probe's "
            "tasks form no multi-task group, so the cache check is "
            "vacuous; give the probe ≥2 tasks per scheme family",
            layer="trace")]
    algo.release_graphs()
    lc = algo.set_mu(lc, float(algo.mu_schedule[0]), 0)
    algo.c_step(params, lc)
    after = cost.cache_stats()
    findings = []
    replans = after["plan_misses"] - before["plan_misses"]
    if replans > 0:
        findings.append(Finding(
            "planner-replan", "algorithm", context,
            f"{replans} group plan(s) re-planned after release_graphs() "
            "over identical shapes (expected 0: every lookup should hit "
            "the plan cache): the plan key is rebuild-unstable; check "
            "that repro_torch.analysis.cost.plan_key covers only "
            "hashable, identity-free components", layer="trace"))
    if after["plan_hits"] <= before["plan_hits"] and not replans:
        findings.append(Finding(
            "planner-replan", "algorithm", context,
            "the C step after release_graphs() made neither plan-cache "
            "hits nor misses: it no longer consults the planner "
            "(grouped_compress lost its planner wiring)", layer="trace"))
    return findings


def check_engine_retraces(engine, requests=None,
                          context: str = "serving-traffic"
                          ) -> list[Finding]:
    """``engine-retrace`` findings for a serving engine's programs: run a
    mixed-length request trace (``requests``; None: read the trace the
    caller ran) and flag any program keyed more than once
    (``ServingEngine.trace_counts``: graphs captured on the card,
    signatures on the CPU). Slot count, chunk size and cache shapes never
    vary with the traffic, so each of decode, prefill and reset must be
    keyed once however lengths and arrivals mix."""
    if requests is not None:
        engine.run(list(requests))
    findings = []
    for prog, n in sorted(engine.trace_counts.items()):
        if n > 1:
            findings.append(Finding(
                "engine-retrace", "runtime/server", f"{context}:{prog}",
                f"serving {prog} program was keyed {n}× across one "
                "mixed-length traffic trace (expected 1): a Python value "
                "or a data-dependent shape is leaking into its key; slot "
                "state must stay in fixed-shape tensors (tok/pos/active), "
                "never in plain Python values", layer="trace"))
    return findings
