"""Layer 1: AST rules over ``src/repro_torch`` (plain ``ast``, no imports).

Port of ``src/repro/analysis/lint/ast_rules.py``. The rules encode the
Python-side hazards of the port, scoped tightly enough to run with
**zero false positives** on its tree:

``traced-cast``
    ``float()``/``int()``/``bool()``, ``.item()`` or ``.tolist()`` on a
    value flowing from scheme state or a captured program's arguments.
    On a CUDA tensor that is a host sync (``aten._local_scalar_dense``),
    and inside a CUDA graph capture it raises (the reference's
    ``float(theta["rank"])`` bug class). Metadata
    accesses (``x.shape``, ``x.ndim``, ``x.size()``, ``x.numel()``,
    ``x.dim()``, ``x.dtype``, ``x.device``, ``len(x)``) are exempt: they
    read no data.

``np-in-program`` (the reference's ``np-in-jit``)
    a ``np.*``/``numpy.*`` call whose arguments reference a traced value
    inside a scheme method or captured body: numpy copies the tensor to
    the host (a sync, and a capture error on the card).
    ``np.prod(x.shape)``-style metadata uses are exempt.

``shape-derived-key``
    ``torch.manual_seed(seed)`` or ``Generator.manual_seed(seed)`` with
    a seed derived from tensor shapes: equal-shaped tensors then share a
    random stream (the reference's old LowRank ``PRNGKey(m·7919+n)``
    bug: every same-shape matrix got the same sketch). Seeds come from
    the engine (``CompressionTask.item_keys``) or an explicit constant.

``mutable-default``
    a mutable literal (``[]``/``{}``/``set()``) as a class-level default
    on a scheme class or dataclass: shared across instances, so one
    task's mutation leaks into every other task using the scheme.

``guard-bypass``
    a scheme subclass that overrides ``compress`` and
    ``kernel_dispatch_ready`` without ``compress_batched``: it disables
    the MRO guard that keeps compress-overriding subclasses off the
    batched path, so the parent's batched math runs for its tasks.

Scoping: the "traced scope" is

* the :data:`TRACED_METHODS` of ``CompressionScheme`` subclasses
  (recognised textually per file, as in the reference);
* the bodies the port captures as programs (``repro_torch.graphs``):
  a function or lambda handed to a ``program(...)`` call (a def of the
  same file by name, a lambda, or the function of a
  ``functools.partial``), e.g. ``core/grouping.py``'s group and task
  solves and ``runtime/server.py``'s serving programs; and a def
  decorated ``@captured`` (``graphs.captured``, ``@graphs.captured``),
  for bodies handed over through a table (the compiled driver's steps
  in ``core/algorithm.py``).

Parameters named in :data:`STATIC_PARAMS` are host values by the port's
conventions (configs, sizes, host-side seeds) and are not traced.
"""
from __future__ import annotations

import ast
import os

from repro_torch.analysis.lint.findings import Finding

#: scheme methods whose tensor parameters are device data in the C step
TRACED_METHODS = ("init", "compress", "compress_batched", "decompress",
                  "warm_start", "bits", "flops", "distortion")
#: parameters that are static or host-side by contract: scheme plumbing,
#: configs and sizes, and the sketch seeds, which are CPU tensors
#: whatever device the items are on (``CompressionTask.item_keys``)
STATIC_PARAMS = {"self", "cls", "solve", "float_bits", "orig_shape",
                 "n_items", "device", "key", "seeds", "cfg", "max_len",
                 "temperature", "tasks", "in_place"}
#: attribute accesses (and methods) that read metadata, not data
STATIC_ATTRS = {"shape", "ndim", "size", "dtype", "device", "numel", "dim",
                "is_meta", "is_cuda", "element_size"}
#: attribute accesses whose values derive from shapes (seed hazard)
SHAPE_ATTRS = ("shape", "size", "numel")
#: class names whose subclasses are treated as schemes
SCHEME_BASES = {"CompressionScheme"}
#: a call of this name captures the functions handed to it
PROGRAM_CALL = "program"
#: the decorator that marks a captured body (``graphs.captured``)
CAPTURED_DECORATOR = "captured"

SUPPRESS_TOKEN = "lint: disable"


def lint_paths(paths: list[str], repo_root: str) -> list[Finding]:
    """Run every AST rule over ``paths`` (files or directories)."""
    findings: list[Finding] = []
    for path in paths:
        if os.path.isdir(path):
            for dirpath, _, names in sorted(os.walk(path)):
                for name in sorted(names):
                    if name.endswith(".py"):
                        findings += lint_file(
                            os.path.join(dirpath, name), repo_root)
        elif path.endswith(".py"):
            findings += lint_file(path, repo_root)
    return findings


def lint_file(path: str, repo_root: str) -> list[Finding]:
    with open(path, encoding="utf-8") as f:
        source = f.read()
    rel = os.path.relpath(os.path.abspath(path), repo_root)
    try:
        tree = ast.parse(source, filename=path)
    except SyntaxError as e:
        return [Finding("syntax-error", rel, "<module>",
                        f"file does not parse: {e}", e.lineno or 0)]
    return _FileLinter(tree, source, rel).run()


# ----------------------------------------------------------------------
def _base_names(cls: ast.ClassDef) -> set[str]:
    out = set()
    for b in cls.bases:
        if isinstance(b, ast.Name):
            out.add(b.id)
        elif isinstance(b, ast.Attribute):
            out.add(b.attr)
    return out


def _callee(node: ast.expr) -> str | None:
    """The last dotted component of a call's function (``a.b.c`` → c)."""
    if isinstance(node, ast.Name):
        return node.id
    if isinstance(node, ast.Attribute):
        return node.attr
    return None


def _params(fn) -> list[str]:
    a = fn.args
    names = [x.arg for x in a.posonlyargs + a.args + a.kwonlyargs]
    names += [x.arg for x in (a.vararg, a.kwarg) if x is not None]
    return names


class _FileLinter:
    def __init__(self, tree: ast.Module, source: str, rel: str):
        self.tree = tree
        self.lines = source.splitlines()
        self.rel = rel
        self.findings: list[Finding] = []
        self.parents: dict[ast.AST, ast.AST] = {}
        for node in ast.walk(tree):
            for child in ast.iter_child_nodes(node):
                self.parents[child] = node
        # numpy import aliases in this module ("np", "numpy", ...)
        self.np_aliases = {
            a.asname or a.name
            for node in ast.walk(tree) if isinstance(node, ast.Import)
            for a in node.names if a.name == "numpy"}
        # scheme classes: transitive closure of known bases, per file
        self.scheme_classes: set[str] = set()
        known = set(SCHEME_BASES)
        classes = [n for n in ast.walk(tree)
                   if isinstance(n, ast.ClassDef)]
        changed = True
        while changed:
            changed = False
            for cls in classes:
                if cls.name not in known and _base_names(cls) & known:
                    known.add(cls.name)
                    self.scheme_classes.add(cls.name)
                    changed = True
        self.captured = self._captured_bodies()

    # ------------------------------------------------------------------
    def _captured_bodies(self) -> set[ast.AST]:
        """The defs and lambdas of this file handed to a ``program(...)``
        call (by name, inline, or through ``functools.partial``)."""
        defs: dict[str, list[ast.AST]] = {}
        for node in ast.walk(self.tree):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                defs.setdefault(node.name, []).append(node)
        out: set[ast.AST] = set()

        def resolve(arg: ast.expr) -> None:
            if isinstance(arg, ast.Lambda):
                out.add(arg)
            elif isinstance(arg, ast.Name):
                out.update(defs.get(arg.id, ()))
            elif isinstance(arg, ast.Call) \
                    and _callee(arg.func) == "partial" and arg.args:
                resolve(arg.args[0])

        for node in ast.walk(self.tree):
            if isinstance(node, ast.Call) \
                    and _callee(node.func) == PROGRAM_CALL:
                for arg in list(node.args) + [k.value for k in
                                              node.keywords]:
                    resolve(arg)
        return out

    # ------------------------------------------------------------------
    def run(self) -> list[Finding]:
        for node in ast.walk(self.tree):
            if isinstance(node, ast.ClassDef):
                if node.name in self.scheme_classes:
                    self._check_scheme_class(node)
                if node.name in self.scheme_classes or \
                        self._is_dataclass(node):
                    self._check_mutable_defaults(node)
            elif isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                self._check_function(node)
            elif isinstance(node, ast.Lambda) and node in self.captured:
                traced = {a for a in _params(node)
                          if a not in STATIC_PARAMS}
                self._check_traced_scope(node, traced,
                                         self._context_of(node, "<lambda>"))
        return self.findings

    def _context_of(self, node: ast.AST, name: str) -> str:
        parent = self.parents.get(node)
        while parent is not None and not isinstance(
                parent, (ast.FunctionDef, ast.AsyncFunctionDef,
                         ast.ClassDef)):
            parent = self.parents.get(parent)
        return name if parent is None else f"{parent.name}.{name}"

    def _emit(self, rule: str, node: ast.AST, context: str, message: str):
        line = getattr(node, "lineno", 0)
        if 0 < line <= len(self.lines):
            text = self.lines[line - 1]
            if SUPPRESS_TOKEN in text:
                tail = text.split(SUPPRESS_TOKEN, 1)[1]
                if "=" not in tail or rule in tail:
                    return
        self.findings.append(
            Finding(rule, self.rel, context, message, line))

    # ------------------------------------------------------------------
    @staticmethod
    def _is_dataclass(cls: ast.ClassDef) -> bool:
        for dec in cls.decorator_list:
            name = _callee(dec)
            if name is None and isinstance(dec, ast.Call):
                name = _callee(dec.func)
            if name == "dataclass":
                return True
        return False

    def _check_mutable_defaults(self, cls: ast.ClassDef):
        for stmt in cls.body:
            value = None
            if isinstance(stmt, ast.Assign):
                value = stmt.value
            elif isinstance(stmt, ast.AnnAssign) and stmt.value is not None:
                value = stmt.value
            if value is None:
                continue
            bad = isinstance(value, (ast.List, ast.Dict, ast.Set)) or (
                isinstance(value, ast.Call)
                and isinstance(value.func, ast.Name)
                and value.func.id in ("list", "dict", "set")
                and not value.args and not value.keywords)
            if bad:
                self._emit(
                    "mutable-default", stmt, cls.name,
                    "mutable class-level default is shared across every "
                    "instance (one task's mutation leaks into all tasks "
                    "using this scheme); use dataclasses.field("
                    "default_factory=...) or set it in __init__")

    # ------------------------------------------------------------------
    def _check_scheme_class(self, cls: ast.ClassDef):
        methods = {n.name: n for n in cls.body
                   if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))}
        if ("compress" in methods and "kernel_dispatch_ready" in methods
                and "compress_batched" not in methods):
            self._emit(
                "guard-bypass", methods["kernel_dispatch_ready"], cls.name,
                "overrides compress() and kernel_dispatch_ready() without "
                "compress_batched(): this disables the MRO guard and lets "
                "the parent's batched solver silently run the parent's "
                "math for this subclass's tasks; either implement "
                "compress_batched or drop the kernel_dispatch_ready "
                "override")
        for name, fn in methods.items():
            if name in TRACED_METHODS:
                traced = {a for a in _params(fn) if a not in STATIC_PARAMS}
                self._check_traced_scope(fn, traced,
                                         f"{cls.name}.{name}")

    def _check_function(self, fn):
        is_captured = fn in self.captured or any(
            _callee(dec) == CAPTURED_DECORATOR for dec in fn.decorator_list)
        context = fn.name
        parent = self.parents.get(fn)
        if isinstance(parent, ast.ClassDef):
            context = f"{parent.name}.{fn.name}"
            if parent.name in self.scheme_classes and not is_captured:
                if fn.name in TRACED_METHODS:
                    return  # handled by _check_scheme_class
                self._check_seeds(fn, context)
                return
        else:
            context = self._context_of(fn, fn.name)
        if is_captured:
            traced = {a for a in _params(fn) if a not in STATIC_PARAMS}
            self._check_traced_scope(fn, traced, context)
        else:
            self._check_seeds(fn, context)

    # ------------------------------------------------------------------
    def _local_flow(self, fn, traced: set[str]) -> tuple[set[str],
                                                         set[str]]:
        """One forward pass over assignments: propagate tracedness and
        collect shape-derived locals (``x = theta["u"]`` makes ``x``
        traced; ``m, n = w.shape`` makes ``m``/``n`` shape-derived)."""
        traced = set(traced)
        shape_derived: set[str] = set()
        for node in ast.walk(fn):
            if not isinstance(node, ast.Assign):
                continue
            value_traced = self._references_traced(node.value, traced)
            value_shapey = self._references_shape(node.value,
                                                  shape_derived)
            for tgt in node.targets:
                names = [n.id for n in ast.walk(tgt)
                         if isinstance(n, ast.Name)]
                for n in names:
                    if value_traced:
                        traced.add(n)
                    elif value_shapey:
                        shape_derived.add(n)
        return traced, shape_derived

    def _references_traced(self, node: ast.expr, traced: set[str]) -> bool:
        """Does ``node`` read a traced name *as data* (not through a
        metadata access)?"""
        for n in ast.walk(node):
            if isinstance(n, ast.Name) and n.id in traced:
                if not self._under_static_attr(n, stop=node):
                    return True
        return False

    @staticmethod
    def _references_shape(node: ast.expr, shape_derived: set[str]) -> bool:
        for n in ast.walk(node):
            if isinstance(n, ast.Attribute) and n.attr in SHAPE_ATTRS:
                return True
            if isinstance(n, ast.Name) and n.id in shape_derived:
                return True
        return False

    def _under_static_attr(self, name: ast.Name, stop: ast.expr) -> bool:
        """True when the path from ``name`` up to ``stop`` passes through
        ``<...>.shape``-style metadata or ``len(...)``: the value consumed
        is static, not the tensor's data."""
        node: ast.AST = name
        while node is not stop:
            parent = self.parents.get(node)
            if parent is None:
                break
            if isinstance(parent, ast.Attribute) \
                    and parent.value is node \
                    and parent.attr in STATIC_ATTRS:
                return True
            if isinstance(parent, ast.Call) and node in parent.args \
                    and _callee(parent.func) == "len":
                return True
            node = parent
        return False

    # ------------------------------------------------------------------
    def _check_traced_scope(self, fn, params: set[str], context: str):
        traced, shape_derived = self._local_flow(fn, params)
        for node in ast.walk(fn):
            if not isinstance(node, ast.Call):
                continue
            func = node.func
            # float()/int()/bool() on a traced value
            if isinstance(func, ast.Name) \
                    and func.id in ("float", "int", "bool") \
                    and node.args \
                    and self._references_traced(node.args[0], traced):
                self._cast(node, context, f"{func.id}()",
                           ast.unparse(node.args[0]))
            # .item()/.tolist() on a traced value
            if isinstance(func, ast.Attribute) \
                    and func.attr in ("item", "tolist") \
                    and self._references_traced(func.value, traced):
                self._cast(node, context, f".{func.attr}()",
                           ast.unparse(func.value))
            # np.* call consuming a traced value
            if isinstance(func, ast.Attribute) \
                    and isinstance(func.value, ast.Name) \
                    and func.value.id in (self.np_aliases or {"np"}):
                args = list(node.args) + [k.value for k in node.keywords]
                if any(self._references_traced(a, traced) for a in args):
                    self._emit(
                        "np-in-program", node, context,
                        f"numpy call np.{func.attr}(...) consumes a "
                        "traced tensor inside a scheme method or captured "
                        "program: numpy copies it to the host (a sync on "
                        "the card, an error inside a CUDA graph capture); "
                        "use the torch equivalent on the device")
        self._check_seeds(fn, context, shape_derived)

    def _cast(self, node, context: str, what: str, operand: str):
        self._emit(
            "traced-cast", node, context,
            f"{what} applied to a traced tensor ({operand}): on the card "
            "this is a host sync, and inside a CUDA graph capture it "
            "raises (grouping.CaptureError); keep it as a 0-d tensor — "
            "plain arithmetic works for tensors and host values alike "
            "(the reference's float(theta[\"rank\"]) bug class)")

    def _check_seeds(self, fn, context: str,
                     shape_derived: set[str] | None = None):
        if shape_derived is None:
            _, shape_derived = self._local_flow(fn, set())
        for node in ast.walk(fn):
            if not isinstance(node, ast.Call) or not node.args:
                continue
            if _callee(node.func) != "manual_seed":
                continue
            if self._references_shape(node.args[0], shape_derived):
                self._emit(
                    "shape-derived-key", node, context,
                    "random generator seeded from a tensor shape: every "
                    "equal-shaped tensor shares the stream (the "
                    "reference's old LowRank PRNGKey(m*7919+n) sketch "
                    "collision); take the seed from the engine's "
                    "per-item CompressionTask.item_keys, or an explicit "
                    "constant")
