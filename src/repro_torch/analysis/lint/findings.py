"""Finding, report and baseline plumbing for ``repro_torch.analysis.lint``.

Port of ``src/repro/analysis/lint/findings.py``, with the same identity,
JSON shape and exit codes. A *finding* is one rule violation at one
location. Its identity for the baseline is ``(rule, file, context)``:
line-insensitive, so reformatting a file does not bring back a
suppressed finding, while moving the offending code into another
function does (the context is the enclosing ``Class.method``, function
or checked entity).

The *baseline* is a committed JSON file (``lint_baseline_torch.json`` at
the repo root; the JAX package keeps its own ``lint_baseline.json``)
listing the finding identities accepted on main. The CLI exits nonzero
only on findings **not** in the baseline. A clean tree keeps an empty
baseline.

Inline suppression: a ``# lint: disable=<rule>`` comment on the
offending line silences that rule there (AST rules only: the contract,
op and trace layers have no source line to carry a comment; use the
baseline for those).
"""
from __future__ import annotations

import json
import os
from dataclasses import asdict, dataclass, field


@dataclass(frozen=True)
class Finding:
    """One rule violation.

    ``rule``     stable rule id (e.g. ``"traced-cast"``)
    ``file``     repo-relative path (or a dotted entity for findings
                 that have no file, e.g. ``"registry"``)
    ``context``  enclosing function/class or checked entity name
    ``line``     1-based source line (0 when the rule has no line)
    ``message``  actionable description: what is wrong and what to do
    ``layer``    ``"ast" | "contract" | "ops" | "trace"``
    """

    rule: str
    file: str
    context: str
    message: str
    line: int = 0
    layer: str = "ast"

    @property
    def key(self) -> tuple[str, str, str]:
        return (self.rule, self.file, self.context)

    def format(self) -> str:
        loc = f"{self.file}:{self.line}" if self.line else self.file
        return f"{loc}: [{self.rule}] {self.context}: {self.message}"


@dataclass
class Report:
    findings: list[Finding] = field(default_factory=list)
    #: layers that ran (a layer left out by --layers is absent)
    layers: list[str] = field(default_factory=list)
    #: findings matched by the baseline (reported, never failing)
    suppressed: list[Finding] = field(default_factory=list)

    def extend(self, findings, layer: str):
        self.layers.append(layer)
        self.findings.extend(findings)

    def apply_baseline(self, baseline: "Baseline") -> None:
        live, dead = [], []
        for f in self.findings:
            (dead if baseline.covers(f) else live).append(f)
        self.findings = live
        self.suppressed.extend(dead)

    def to_json(self) -> dict:
        return {
            "version": 1,
            "layers": self.layers,
            "counts": {
                "new": len(self.findings),
                "suppressed": len(self.suppressed),
            },
            "findings": [asdict(f) for f in self.findings],
            "suppressed": [asdict(f) for f in self.suppressed],
        }


class Baseline:
    """Committed suppression list (see the module's note)."""

    def __init__(self, entries: list[dict] | None = None,
                 path: str | None = None):
        self.path = path
        self.entries = entries or []
        self._keys = {(e["rule"], e["file"], e["context"])
                      for e in self.entries}

    @classmethod
    def load(cls, path: str) -> "Baseline":
        if not os.path.exists(path):
            return cls([], path=path)
        with open(path, encoding="utf-8") as f:
            data = json.load(f)
        return cls(data.get("suppressions", []), path=path)

    def covers(self, finding: Finding) -> bool:
        return finding.key in self._keys

    @staticmethod
    def write(path: str, findings: list[Finding]) -> None:
        data = {
            "version": 1,
            "comment": "Accepted lint findings of the PyTorch port; new "
                       "findings fail. Regenerate with: python -m "
                       "repro_torch.analysis.lint --write-baseline",
            "suppressions": [
                {"rule": f.rule, "file": f.file, "context": f.context,
                 "message": f.message}
                for f in sorted(findings, key=lambda f: f.key)],
        }
        with open(path, "w", encoding="utf-8") as f:
            json.dump(data, f, indent=2, sort_keys=False)
            f.write("\n")
