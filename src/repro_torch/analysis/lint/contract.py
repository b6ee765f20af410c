"""Layer 2: the scheme/registry contract, machine-checked.

Port of ``src/repro/analysis/lint/contract.py``. The contract between
schemes and the kernel dispatch registry (``solver`` /
``solver_operands`` / ``batch_operands`` / ``wants_key`` / the backend
rules of ``repro_torch.kernels.dispatch``) is checked on the
*declarations*: this layer imports the registry and every
``CompressionScheme`` subclass of ``repro_torch.core.schemes`` and runs
no solve.

Rules:

``unregistered-solver``
    a scheme declares ``solver = "name"`` but the registry has no
    ``torch`` implementation for it: the group would run item by item
    forever (the backend-gap rule needs a ``torch`` anchor).

``operand-mismatch``
    ``solver_operands`` (+ the trailing ``"keys"`` when ``wants_key``)
    disagrees with the registered solver's positional signature, or its
    length with what ``batch_operands`` produces: the packed operand
    tensors would bind to the wrong solver parameters.

``cuda-no-torch`` (the reference's ``pallas-no-interpret``)
    a solver registers a ``cuda`` backend without a ``torch`` one. The
    port's rule is that a kernel's plain version runs for a CPU tensor
    and that a backend gap falls back to the ``torch`` entry; this
    solver has neither anchor, so a ``torch`` request (and ``auto`` on
    the CPU) silently drops the group to the item-by-item path.

``solver-without-group-key``
    a scheme declares a solver while ``group_key()`` is ``None``: the
    escape hatch opts out of kernel dispatch, so the declaration is dead.

``solver-no-compress-batched``
    a scheme declares a solver but never implements
    ``compress_batched``: ``kernel_dispatch_ready`` keeps it item by
    item, so again the declaration is dead.

``init-key-missing``
    a scheme's ``init`` reads hyperparameters that neither ``compress``
    nor ``group_key`` read, without overriding ``init_key()``:
    ``grouped_init`` would merge tasks whose Θ^DC differ and solve them
    with ``group[0]``'s settings.

``no-contract-example``
    a scheme class provides no :meth:`contract_examples` instance, so
    the contract and op layers cannot check it.
"""
from __future__ import annotations

import ast
import importlib
import inspect
import os
import pkgutil
import textwrap

from repro_torch.analysis.lint.findings import Finding

#: packages walked to discover CompressionScheme subclasses
SCHEME_PACKAGES = ("repro_torch.core.schemes",)


def _rel_file(cls) -> str:
    """Repo-relative source path of a class (a stable baseline identity)."""
    import repro_torch
    try:
        f = inspect.getsourcefile(cls)
    except TypeError:
        f = None
    if not f:
        return cls.__module__
    root = os.path.dirname(os.path.dirname(
        os.path.dirname(os.path.abspath(repro_torch.__file__))))
    try:
        rel = os.path.relpath(os.path.abspath(f), root)
    except ValueError:
        return f
    return f if rel.startswith("..") else rel


def discover_scheme_classes(packages=SCHEME_PACKAGES) -> list[type]:
    """Import every module under ``packages`` and return the
    ``CompressionScheme`` subclasses *defined there* (live
    ``__subclasses__`` also sees test fixtures), in a fixed order."""
    from repro_torch.core.schemes.base import CompressionScheme

    for pkg_name in packages:
        pkg = importlib.import_module(pkg_name)
        for info in pkgutil.iter_modules(pkg.__path__):
            importlib.import_module(f"{pkg_name}.{info.name}")

    prefixes = tuple(p + "." for p in packages) + tuple(packages)
    out, stack = [], [CompressionScheme]
    while stack:
        cls = stack.pop()
        for sub in cls.__subclasses__():
            if sub.__module__.startswith(prefixes):
                out.append(sub)
            stack.append(sub)
    return sorted(set(out), key=lambda c: (c.__module__, c.__name__))


def _self_attr_reads(fn, cls) -> set[str]:
    """Names of non-method ``self.X`` attribute loads in ``fn``'s body."""
    try:
        tree = ast.parse(textwrap.dedent(inspect.getsource(fn)))
    except (OSError, TypeError, SyntaxError):
        return set()
    reads = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Attribute) \
                and isinstance(node.value, ast.Name) \
                and node.value.id == "self" \
                and not callable(getattr(cls, node.attr, None)):
            reads.add(node.attr)
    return reads


def _provider(cls, name):
    for c in cls.__mro__:
        if name in c.__dict__:
            return c
    return None


def check_schemes(classes=None, registry=None) -> list[Finding]:
    """Run every contract rule. ``classes``/``registry`` default to the
    discovered scheme classes and the live dispatch registry (tests pass
    their own)."""
    from repro_torch.core.schemes.base import CompressionScheme
    from repro_torch.kernels import dispatch

    if classes is None:
        classes = discover_scheme_classes()
    if registry is None:
        registry = dispatch.registry_entries()

    findings: list[Finding] = []

    # --- registry-wide: the plain anchor of a cuda entry ----------------
    for solver, impls in sorted(registry.items()):
        if "cuda" in impls and "torch" not in impls:
            findings.append(Finding(
                "cuda-no-torch", "registry", solver,
                "solver registers a cuda backend without a torch one: a "
                "torch request (and auto on the CPU) finds no "
                "implementation and the group silently runs item by "
                "item; register the plain tensor program as its torch "
                "backend", layer="contract"))

    # --- per-class rules ----------------------------------------------
    for cls in classes:
        if cls is CompressionScheme:
            continue
        rel = _rel_file(cls)
        examples = cls.contract_examples()
        if not examples:
            findings.append(Finding(
                "no-contract-example", rel, cls.__name__,
                "contract_examples() returns no instance, so the "
                "contract and op layers cannot cover this scheme; "
                "override the classmethod with one cheap instance",
                layer="contract"))

        # inherited declarations are checked on the declaring class
        solver = cls.__dict__.get("solver", None)
        if solver is not None:
            impls = registry.get(solver, {})
            if "torch" not in impls:
                findings.append(Finding(
                    "unregistered-solver", rel, cls.__name__,
                    f"declared solver {solver!r} has no registered torch "
                    "backend: kernel dispatch silently runs every group "
                    "of this scheme item by item; register a torch "
                    "implementation or drop the declaration",
                    layer="contract"))
            if _provider(cls, "compress_batched") is CompressionScheme:
                findings.append(Finding(
                    "solver-no-compress-batched", rel, cls.__name__,
                    f"declares solver {solver!r} but never implements "
                    "compress_batched(); kernel_dispatch_ready() keeps "
                    "it item by item, so the declaration is dead",
                    layer="contract"))

            sig = dispatch.solver_signature(solver) \
                if "torch" in impls else None
            declared = tuple(cls.solver_operands)
            if cls.wants_key:
                declared = declared + ("keys",)
            if sig is not None:
                missing = [n for n in declared if n not in sig]
                if missing:
                    findings.append(Finding(
                        "operand-mismatch", rel, cls.__name__,
                        f"solver_operands names {missing} are not "
                        f"positional parameters of the registered "
                        f"{solver!r} torch solver (signature: "
                        f"{list(sig)}); the packed operand tensors "
                        "would bind to the wrong parameters",
                        layer="contract"))
            for ex in examples:
                try:
                    n_ops = len(ex.batch_operands(2, "cpu"))
                except Exception:
                    continue
                n_decl = n_ops if not cls.wants_key else n_ops + 1
                if ex.batch_key() is not None \
                        and len(declared) != n_decl:
                    findings.append(Finding(
                        "operand-mismatch", rel, cls.__name__,
                        f"solver_operands declares {len(declared)} "
                        f"name(s) {list(declared)} but batch_operands() "
                        f"produces {n_ops} tensor(s)"
                        + (" plus the engine-appended keys operand"
                           if cls.wants_key else "")
                        + "; declare one name per operand, in solver-"
                        "signature order", layer="contract"))
                    break

            for ex in examples:
                if ex.group_key() is None:
                    findings.append(Finding(
                        "solver-without-group-key", rel, cls.__name__,
                        f"declares solver {solver!r} but group_key() is "
                        "None (the fully custom escape hatch), which opts "
                        "out of kernel dispatch: the declaration is "
                        "dead; drop it or implement group_key",
                        layer="contract"))
                    break

        # --- init-only hyperparameters must extend init_key -----------
        init_fn = cls.__dict__.get("init")
        if init_fn is not None and _provider(cls, "init_key") is \
                CompressionScheme:
            init_reads = _self_attr_reads(init_fn, cls)
            other = set()
            for name in ("compress", "group_key", "batch_key",
                         "batch_operands"):
                fn = _provider(cls, name)
                if fn is not None and fn is not CompressionScheme:
                    other |= _self_attr_reads(fn.__dict__[name], cls)
            init_only = init_reads - other
            if init_only:
                findings.append(Finding(
                    "init-key-missing", rel, cls.__name__,
                    f"init() reads hyperparameters {sorted(init_only)} "
                    "that compress()/group_key() never read, but "
                    "init_key() is not overridden: grouped_init would "
                    "merge tasks whose direct compression differs and "
                    "solve them with group[0]'s settings; extend "
                    "init_key() with these hyperparameters",
                    layer="contract"))
    return findings
