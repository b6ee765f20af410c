"""The port's linter linted: the AST and contract layers and the CLI of
``repro_torch.analysis.lint`` against the JAX package's
``repro.analysis.lint``, on the CPU.

Every seeded fixture of the reference's ``tests/test_lint.py`` (layers 1
and 2, the CLI, the baseline) has a twin here that trips exactly the rule
the reference's fixture trips, or the rule mapped to it (``np-in-jit`` →
``np-in-program``, ``pallas-no-interpret`` → ``cuda-no-torch``), and
nothing else. Layer-1 fixtures are source strings written to
``tmp_path`` (the AST pass imports nothing); layer-2 fixtures are real
classes and registries passed in. The port's ``contract_examples()``
equal the reference's class by class, and the JSON report and the exit
codes equal the reference CLI's.
"""
import json
import re

import pytest
import torch

from repro.analysis.lint import cli as jcli
from repro.core import schemes as js
from repro_torch.analysis.lint import Baseline, Finding, Report
from repro_torch.analysis.lint.ast_rules import lint_file, lint_paths
from repro_torch.analysis.lint.cli import main as lint_main, repo_root
from repro_torch.analysis.lint.contract import (check_schemes,
                                                 discover_scheme_classes)
from repro_torch.core import schemes as ts
from repro_torch.core.schemes.base import CompressionScheme
from repro_torch.core.schemes.prune import ConstraintL0Pruning
from torch_threads import _one_torch_thread  # noqa: F401


# ----------------------------------------------------------------------
# Layer 1: AST fixtures
# ----------------------------------------------------------------------
def _lint_source(tmp_path, source: str):
    f = tmp_path / "fixture.py"
    f.write_text(source)
    return lint_file(str(f), str(tmp_path))


def _rules(findings):
    return sorted({f.rule for f in findings})


SCHEME_HEADER = """\
import functools

import numpy as np
import torch
from repro_torch.core.schemes.base import CompressionScheme
from repro_torch.graphs import captured
"""


@pytest.mark.parametrize("cast", [
    'float(theta["rank"])', 'int(theta["rank"])', 'bool(theta["rank"])',
    'theta["rank"].item()', 'theta["rank"].tolist()'])
def test_traced_cast_fixture_trips_exactly_that_rule(tmp_path, cast):
    findings = _lint_source(tmp_path, SCHEME_HEADER + f"""
class F(CompressionScheme):
    def compress(self, w, theta, mu=None):
        r = {cast}
        return {{"theta": w * r}}
""")
    assert _rules(findings) == ["traced-cast"]
    (f,) = findings
    assert f.context == "F.compress" and f.line == 10
    assert "host sync" in f.message and "CUDA graph capture" in f.message
    assert "0-d tensor" in f.message      # actionable: what to do instead


@pytest.mark.parametrize("body", ["captured", "program", "partial",
                                  "lambda"])
def test_np_in_program_fixture(tmp_path, body):
    """The reference's ``np-in-jit`` in each form of a captured body: a
    ``@captured`` def, a def handed to ``program(...)`` by name, through
    ``functools.partial``, and a lambda."""
    src = {
        "captured": """
@captured
def step(x):
    return np.mean(x) + 1.0
""",
        "program": """
def make(programs):
    def step(x):
        return np.mean(x) + 1.0
    return programs.program(step, name="step")
""",
        "partial": """
def _step(cfg, x):
    return np.mean(x) + cfg

def make(programs, cfg):
    return programs.program(functools.partial(_step, cfg), name="step")
""",
        "lambda": """
def make(programs):
    return programs.program(lambda x: np.mean(x) + 1.0, name="step")
""",
    }[body]
    findings = _lint_source(tmp_path, SCHEME_HEADER + src)
    assert _rules(findings) == ["np-in-program"]
    assert "torch equivalent" in findings[0].message


def test_shape_derived_key_fixture(tmp_path):
    findings = _lint_source(tmp_path, SCHEME_HEADER + """
class F(CompressionScheme):
    def compress(self, w, theta, mu=None):
        m, n = w.shape
        gen = torch.Generator().manual_seed(m * 7919 + n)
        return {"theta": w + torch.randn(w.shape, generator=gen)}
""")
    assert _rules(findings) == ["shape-derived-key"]
    assert "item_keys" in findings[0].message


def test_mutable_default_fixture(tmp_path):
    findings = _lint_source(tmp_path, SCHEME_HEADER + """
class F(CompressionScheme):
    cache = {}
""")
    assert _rules(findings) == ["mutable-default"]
    assert "default_factory" in findings[0].message


def test_guard_bypass_fixture(tmp_path):
    findings = _lint_source(tmp_path, SCHEME_HEADER + """
class F(CompressionScheme):
    solver = "topk_mask"

    def compress(self, w, theta, mu=None):
        return {"theta": w}

    def kernel_dispatch_ready(self):
        return True
""")
    assert _rules(findings) == ["guard-bypass"]
    assert "compress_batched" in findings[0].message


def test_static_shape_accesses_are_exempt(tmp_path):
    # the fix of the float(theta["rank"]) bug: float() over metadata is fine
    findings = _lint_source(tmp_path, SCHEME_HEADER + """
class F(CompressionScheme):
    def bits(self, theta, float_bits: int = 32):
        m = theta["u"].shape[0]
        n = theta["v"].size(0)
        return theta["rank"] * float((m + n) * float_bits)

    def compress_batched(self, solve, w, theta, operands, mu=None):
        (kappa,) = operands
        n = int(kappa.numel()) + len(w) + int(w.dim())
        return {"theta": solve(w, kappa) * n}

@captured
def g(x, key):
    return float(x.shape[0]) + int(x.ndim) + torch.sum(x) + int(key)
""")
    assert findings == []


def test_inline_suppression_comment(tmp_path):
    findings = _lint_source(tmp_path, SCHEME_HEADER + """
class F(CompressionScheme):
    def compress(self, w, theta, mu=None):
        r = float(theta["r"])  # lint: disable=traced-cast
        s = float(theta["s"])  # lint: disable=np-in-program (wrong rule)
        return {"theta": w * r * s}
""")
    # the matching disable silences its line; the wrong-rule one does not
    assert _rules(findings) == ["traced-cast"]
    assert len(findings) == 1


def test_lint_paths_walks_directories(tmp_path):
    (tmp_path / "pkg").mkdir()
    (tmp_path / "pkg" / "a.py").write_text(
        SCHEME_HEADER + "class A(CompressionScheme):\n    cache = []\n")
    (tmp_path / "pkg" / "b.py").write_text("x = 1\n")
    findings = lint_paths([str(tmp_path / "pkg")], str(tmp_path))
    assert [f.rule for f in findings] == ["mutable-default"]
    assert findings[0].file == "pkg/a.py"


def test_syntax_error_is_a_finding(tmp_path):
    findings = _lint_source(tmp_path, "def broken(:\n")
    assert _rules(findings) == ["syntax-error"]


def test_the_ports_tree_has_no_ast_finding():
    """Zero false positives on the port's own tree, with its captured
    bodies in scope (the serving programs, the group and task solves, the
    compiled driver's steps)."""
    root = repo_root()
    assert lint_paths([root + "/src/repro_torch"], root) == []


# ----------------------------------------------------------------------
# Layer 2: contract fixtures (explicit classes/registry)
# ----------------------------------------------------------------------
def test_cuda_without_torch_registration():
    registry = {"mysolver": {"cuda": lambda w, kappa: w}}
    findings = check_schemes(classes=[], registry=registry)
    assert _rules(findings) == ["cuda-no-torch"]
    assert findings[0].context == "mysolver"
    assert "torch backend" in findings[0].message


def test_unregistered_solver():
    class Ghost(ConstraintL0Pruning):
        solver = "no_such_solver"

        def compress_batched(self, solve, w, theta, operands, mu=None):
            return {"theta": w}

        @classmethod
        def contract_examples(cls):
            return (cls(kappa=2),)

    findings = check_schemes(classes=[Ghost], registry={})
    assert _rules(findings) == ["unregistered-solver"]
    assert "no_such_solver" in findings[0].message


def test_operand_name_mismatch():
    class WrongName(ConstraintL0Pruning):
        solver = "topk_mask"
        solver_operands = ("k_items",)  # the solver's param is "kappa"

        @classmethod
        def contract_examples(cls):
            return (cls(kappa=2),)

    findings = check_schemes(classes=[WrongName])
    assert _rules(findings) == ["operand-mismatch"]
    assert "k_items" in findings[0].message


def test_operand_count_mismatch():
    class TooMany(ConstraintL0Pruning):
        solver = "topk_mask"
        solver_operands = ("kappa", "iters")  # batch_operands yields 1

        @classmethod
        def contract_examples(cls):
            return (cls(kappa=2),)

    findings = check_schemes(classes=[TooMany])
    assert _rules(findings) == ["operand-mismatch"]


def test_solver_without_compress_batched():
    class Declared(CompressionScheme):
        solver = "topk_mask"

        def group_key(self):
            return ("declared",)

        @classmethod
        def contract_examples(cls):
            return (cls(),)

    findings = check_schemes(classes=[Declared])
    assert _rules(findings) == ["solver-no-compress-batched"]


def test_solver_with_group_key_none():
    class Exotic(CompressionScheme):
        solver = "topk_mask"

        def compress_batched(self, solve, w, theta, operands, mu=None):
            return theta

        @classmethod
        def contract_examples(cls):
            return (cls(),)

    findings = check_schemes(classes=[Exotic])
    assert _rules(findings) == ["solver-without-group-key"]


def test_init_only_hyperparam_without_init_key():
    class DPStart(ConstraintL0Pruning):
        def __init__(self, kappa, warm_bins=64):
            super().__init__(kappa)
            self.warm_bins = warm_bins

        def init(self, w, key=None):
            b = self.warm_bins  # init-only hyperparameter
            return {"theta": w * 0.0 + b * 0}

        @classmethod
        def contract_examples(cls):
            return (cls(kappa=2),)

    findings = check_schemes(classes=[DPStart])
    assert _rules(findings) == ["init-key-missing"]
    assert "warm_bins" in findings[0].message


def test_no_contract_example():
    class Bare(CompressionScheme):
        def __init__(self, needed):
            self.needed = needed

    findings = check_schemes(classes=[Bare])
    assert _rules(findings) == ["no-contract-example"]


def test_current_tree_contract_is_clean():
    assert check_schemes() == []


# ----------------------------------------------------------------------
# contract_examples against the reference's
# ----------------------------------------------------------------------
def _hyper(scheme) -> dict:
    """A scheme instance's hyperparameters: its attributes, sub-schemes
    by their own."""
    out = {}
    for k, v in vars(scheme).items():
        if isinstance(v, (list, tuple)) and v and all(
                hasattr(s, "group_key") for s in v):
            v = [(type(s).__name__, _hyper(s)) for s in v]
        out[k] = v
    return out


def _example_table(classes) -> dict:
    return {c.__name__: [(type(e).__name__, _hyper(e))
                         for e in c.contract_examples()] for c in classes}


def test_contract_examples_equal_the_references():
    from repro.analysis.lint.contract import (
        discover_scheme_classes as jdiscover)
    mine = _example_table(discover_scheme_classes())
    ref = _example_table(jdiscover())
    assert sorted(mine) == sorted(ref)
    for name in ref:
        assert mine[name] == ref[name], name
    # every class has at least one instance
    assert all(mine.values())
    assert ts.LowRank.contract_examples()[0].rank == \
        js.LowRank.contract_examples()[0].rank == 2


# ----------------------------------------------------------------------
# Seeded regressions through the CLI
# ----------------------------------------------------------------------
def test_seeded_float_rank_bug_fails_cli(tmp_path, capsys):
    src = repo_root() + "/src/repro_torch/core/schemes/lowrank.py"
    bugged = re.sub(r'return theta\["rank"\] \*',
                    'return float(theta["rank"]) *', open(src).read())
    assert 'float(theta["rank"])' in bugged  # the seed applied
    bad = tmp_path / "lowrank_bugged.py"
    bad.write_text(bugged)

    rc = lint_main([str(bad), "--layers", "ast",
                    "--baseline", str(tmp_path / "empty.json")])
    out = capsys.readouterr().out
    assert rc == 1
    assert "[traced-cast]" in out
    assert "lowrank_bugged.py" in out


def test_seeded_item_in_a_captured_solve_fails_cli(tmp_path, capsys):
    """The port's own hazard: a host read inside the group solve that
    ``compile_group`` captures."""
    src = repo_root() + "/src/repro_torch/core/grouping.py"
    text = open(src).read()
    seed = ("            compress, decompress = _group_solve(scheme, "
            "solver_fn, mu)\n")
    assert text.count(seed) == 1
    bad = tmp_path / "grouping_bugged.py"
    bad.write_text(text.replace(
        seed, seed + "            xi = xi * float(mu.item())\n"))
    rc = lint_main([str(bad), "--layers", "ast",
                    "--baseline", str(tmp_path / "empty.json")])
    out = capsys.readouterr().out
    assert rc == 1 and "[traced-cast]" in out and "run" in out


def test_clean_tree_passes_cli_ast_contract(capsys):
    rc = lint_main(["--layers", "ast,contract"])
    assert rc == 0
    assert "lint: clean" in capsys.readouterr().out


# ----------------------------------------------------------------------
# Baseline / report plumbing and the exit codes
# ----------------------------------------------------------------------
def test_baseline_suppresses_by_rule_file_context(tmp_path):
    f1 = Finding("traced-cast", "a.py", "F.compress", "msg", 10)
    f2 = Finding("np-in-program", "a.py", "F.compress", "msg", 11)
    Baseline.write(str(tmp_path / "b.json"), [f1])
    report = Report(findings=[f1, f2])
    report.apply_baseline(Baseline.load(str(tmp_path / "b.json")))
    # line-insensitive identity: same (rule, file, context) suppresses
    assert [f.rule for f in report.findings] == ["np-in-program"]
    assert [f.rule for f in report.suppressed] == ["traced-cast"]


def test_write_baseline_then_suppressed(tmp_path, capsys):
    bad = tmp_path / "bad.py"
    bad.write_text(SCHEME_HEADER + "class A(CompressionScheme):\n"
                   "    cache = []\n")
    base = str(tmp_path / "b.json")
    assert lint_main([str(bad), "--layers", "ast", "--baseline", base,
                      "--write-baseline"]) == 0
    assert lint_main([str(bad), "--layers", "ast", "--baseline", base]) == 0
    assert "1 baseline-suppressed" in capsys.readouterr().out


def test_json_report_shape_equals_the_references(tmp_path, capsys):
    out, jout = tmp_path / "report.json", tmp_path / "jreport.json"
    assert lint_main(["--layers", "ast", "--json", str(out)]) == 0
    assert jcli.main(["--layers", "ast", "--json", str(jout)]) == 0
    data, jdata = json.loads(out.read_text()), json.loads(jout.read_text())
    assert data["version"] == jdata["version"] == 1
    assert data["layers"] == jdata["layers"] == ["ast"]
    assert data["counts"] == jdata["counts"] == {"new": 0, "suppressed": 0}
    assert sorted(data) == sorted(jdata)
    # a finding's keys are the reference's
    f = Finding("traced-cast", "a.py", "F.compress", "msg", 3)
    report = Report()
    report.extend([f], "ast")
    from repro.analysis.lint import Finding as JFinding, Report as JReport
    jreport = JReport()
    jreport.extend([JFinding("traced-cast", "a.py", "F.compress", "msg", 3)],
                   "ast")
    assert report.to_json() == jreport.to_json()


@pytest.mark.parametrize("case", ["clean", "finding", "bad-layer"])
def test_exit_codes_equal_the_references(tmp_path, capsys, case):
    bad = tmp_path / "bad.py"
    bad.write_text("import numpy as np\nclass C:\n    x = []\n"
                   "from dataclasses import dataclass\n"
                   "@dataclass\nclass D:\n    y = {}\n")
    empty = str(tmp_path / "empty.json")

    def code(main):
        args = {"clean": ["--layers", "contract"],
                "finding": [str(bad), "--layers", "ast", "--baseline",
                            empty],
                "bad-layer": ["--layers", "nope"]}[case]
        try:
            return main(args)
        except SystemExit as e:
            return e.code

    want = {"clean": 0, "finding": 1, "bad-layer": 2}[case]
    assert code(lint_main) == code(jcli.main) == want


def test_committed_baseline_has_zero_suppressions():
    data = json.loads(open(repo_root() + "/lint_baseline_torch.json").read())
    assert data["version"] == 1 and data["suppressions"] == []


def test_unknown_layer_rejected():
    with pytest.raises(SystemExit):
        lint_main(["--layers", "nope"])


@pytest.mark.skipif(torch.cuda.is_available(), reason="needs no CUDA card")
def test_device_layers_refuse_without_a_card(capsys):
    """No fallback hides the card: ``ops`` and ``trace`` ask for CUDA
    unless ``--device cpu`` is passed."""
    from repro_torch.analysis.lint import run_lint
    for layers in (("ops",), ("trace",)):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            run_lint(layers=layers)
        with pytest.raises(SystemExit) as e:
            lint_main(["--layers", layers[0]])
        assert e.value.code == 2
    assert "--device" not in capsys.readouterr().out
