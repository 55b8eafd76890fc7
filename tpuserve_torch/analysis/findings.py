"""Finding records and the checked-in baseline (burndown) workflow, copied
from ``tpuserve/analysis/findings.py``.

A finding's identity is ``(rule, file, symbol, message)`` — deliberately NOT
the line number, so unrelated edits above a known violation do not churn the
baseline. ``line`` rides along for display only.

Baseline semantics: findings present in
``tpuserve_torch/analysis/baseline.json`` are known debt and do not fail the
run; anything new fails; baseline entries that no longer reproduce are
reported as stale so the file is burned down explicitly with
``--update-baseline``, never silently.
"""

from __future__ import annotations

import json
from dataclasses import dataclass
from pathlib import Path


@dataclass(frozen=True)
class Finding:
    rule: str  # e.g. "TPS101"
    file: str  # repo-relative posix path
    symbol: str  # dotted symbol the finding anchors to
    message: str  # deterministic
    line: int = 0  # display only; not part of identity

    @property
    def key(self) -> str:
        return f"{self.rule} {self.file} {self.symbol} :: {self.message}"

    def render(self) -> str:
        return f"{self.file}:{self.line}: {self.rule} [{self.symbol}] {self.message}"


def load_baseline(path: Path) -> set[str]:
    if not path.exists():
        return set()
    data = json.loads(path.read_text())
    return {entry["key"] for entry in data.get("findings", [])}


def save_baseline(path: Path, findings: list[Finding]) -> None:
    data = {
        "comment": (
            "Known findings of the port, burned down explicitly. "
            "Regenerate with: python -m tpuserve_torch lint --update-baseline"
        ),
        "findings": [
            {"key": f.key, "rule": f.rule, "file": f.file, "symbol": f.symbol}
            for f in sorted(findings, key=lambda f: f.key)
        ],
    }
    path.write_text(json.dumps(data, indent=2) + "\n")


def compare(findings: list[Finding], baseline: set[str]) -> tuple[list[Finding], set[str]]:
    """(new findings not in baseline, stale baseline keys no longer seen)."""
    seen = {f.key for f in findings}
    new = [f for f in findings if f.key not in baseline]
    stale = baseline - seen
    return new, stale
