"""Four-layer static analysis for the PyTorch port's LC engine.

Port of ``src/repro/analysis/lint/``. The scheme/dispatch contract that
makes compressions pluggable is easy to break silently (a ``.item()`` on
a device tensor inside a captured C step, a solver with no plain
``torch`` entry, a program captured again at every boundary). This
package machine-checks it:

* ``ast``: rules over the source tree (``ast_rules``);
* ``contract``: the schemes' declarations against the dispatch registry
  (``contract``);
* ``ops``: rules over the counted ops of each solver, scheme family's
  grouped C step, planned C step and serving program (``op_rules``, on
  ``analysis/op_stats.py``), the counterpart of the reference's ``hlo``;
* ``trace``: program keys (CUDA graph captures on the card) across
  identical LC boundaries, the planner's cache across a release, and the
  serving engine's programs across mixed traffic (``trace_count``).

``ast`` and ``contract`` read no device; ``ops`` and ``trace`` run on
the card unless ``--device cpu`` is passed (and raise where no card is).
CLI: ``python -m repro_torch.analysis.lint`` (``cli``); findings,
baseline (``lint_baseline_torch.json``) and the inline
``# lint: disable=<rule>``: ``findings``.

Each rule of the reference, the port's, and why it differs where it
does:

* ``traced-cast`` → ``traced-cast``: the same hazard; ``.item()`` and ``.tolist()`` too.
* ``np-in-jit`` → ``np-in-program``: no jit: a numpy call in a scheme method or captured program.
* ``shape-derived-key`` → ``shape-derived-key``: seeds of ``torch`` generators (``manual_seed``).
* ``mutable-default`` → ``mutable-default``: the same.
* ``guard-bypass`` → ``guard-bypass``: the same.
* ``unregistered-solver`` → ``unregistered-solver``: the ``torch`` entry is the anchor (the reference's ``jnp``).
* ``operand-mismatch`` → ``operand-mismatch``: the same.
* ``pallas-no-interpret`` → ``cuda-no-torch``: a CPU tensor runs a kernel's plain version; the backend gap falls back to ``torch``.
* ``solver-without-group-key`` → ``solver-without-group-key``: the same.
* ``solver-no-compress-batched`` → ``solver-no-compress-batched``: the same.
* ``init-key-missing`` → ``init-key-missing``: the same.
* ``no-contract-example`` → ``no-contract-example``: the same.
* ``gspmd-unsafe-custom-call`` → ``chunk-exact-linalg``: the port splits the groups of chunk-exact solvers, not of GSPMD-safe ones.
* ``donation-unaliased`` → ``donation-unaliased``: serving programs only; the C step copies Θ out of its graphs by design.
* ``f64-op`` → ``f64-op``: the same.
* ``host-callback`` → ``host-read``: a device tensor read on the host: a sync, and a capture error.
* ``lower-failed`` → ``count-failed``: programs run under a counter; nothing is lowered.
* ``planner-silent-fallback`` → ``planner-silent-fallback``: ``source="counted"`` or a ``count-refine-failed:*`` fallback.
* ``boundary-retrace`` → ``boundary-retrace``: program keys (CUDA graph captures), not jit traces.
* ``planner-replan`` → ``planner-replan``: after ``release_graphs()``, not a jit rebuild.
* ``planner-inactive`` → ``planner-inactive``: the same.
* ``engine-retrace`` → ``engine-retrace``: ``ServingEngine.trace_counts`` (graphs on the card).
"""
from repro_torch.analysis.lint.findings import Baseline, Finding, Report
from repro_torch.analysis.lint.cli import run_lint

__all__ = ["Baseline", "Finding", "Report", "run_lint"]
