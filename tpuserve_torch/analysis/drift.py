"""Drift rules: keep config, docs, examples, and tests honest (TPS4xx),
copied from ``tpuserve/analysis/drift.py`` and rooted at the port's
``tpuserve_torch/config.py`` and ``tpuserve_torch/obs.py`` (``package``
names another root, as the parity tests do). The docs corpus, the example
and the tests are the repo's, shared with the reference.

These rules exist because the artifacts around the code rot silently: a knob
added to ``config.py`` that no example or doc mentions is a knob operators
cannot find; a metric emitted but undocumented is a dashboard nobody builds;
a chaos fault kind no test references is recovery machinery nobody proves.

- **TPS401** — every dataclass field in ``<package>/config.py`` appears (as a
  whole token) in ``examples/serve_all.toml`` AND in the docs corpus
  (README.md + docs/*.md). docs/REFERENCE.md is the canonical fix location.
- **TPS402** — every metric name emitted anywhere in ``<package>/`` (the
  ``counter(f"name{...}")`` / ``gauge`` / ``histogram`` / ``observe_phase``
  call sites) appears in the docs corpus.
- **TPS403** — every fault kind in ``config.FAULT_KINDS`` is referenced by
  at least one file under ``tests/``.
- **TPS404** — every shed/terminal reason string in the closed label
  vocabularies (``SCHED_SHED_REASONS``, ``TENANT_SHED_REASONS``,
  ``GEN_STREAM_REASONS``, ``ROUTER_STREAM_REASONS``, ``ROLLBACK_REASONS``
  in ``<package>/obs.py``) appears in docs/REFERENCE.md AND is referenced
  by at least one file under ``tests/`` — the same contract TPS403 gives
  fault kinds. A reason an operator can see on a dashboard must be a
  reason the docs explain and a test exercises.

Everything is pure text/AST scanning — no torch import — so the lint runs
on a bare Python install.
"""

from __future__ import annotations

import ast
import re
from pathlib import Path

from tpuserve_torch.analysis.findings import Finding


def _token_in(name: str, text: str) -> bool:
    return re.search(rf"(?<![A-Za-z0-9_]){re.escape(name)}(?![A-Za-z0-9_])", text) is not None


def _read_all(paths: list[Path]) -> str:
    return "\n".join(p.read_text() for p in paths if p.exists())


def config_fields(config_py: Path) -> list[tuple[str, str]]:
    """(dataclass name, field name) for every annotated field in config.py."""
    tree = ast.parse(config_py.read_text())
    out = []
    for stmt in tree.body:
        if not isinstance(stmt, ast.ClassDef):
            continue
        is_dataclass = any(
            (isinstance(d, ast.Name) and d.id == "dataclass")
            or (isinstance(d, ast.Attribute) and d.attr == "dataclass")
            for d in stmt.decorator_list
        )
        if not is_dataclass:
            continue
        for item in stmt.body:
            if isinstance(item, ast.AnnAssign) and isinstance(item.target, ast.Name):
                out.append((stmt.name, item.target.id))
    return out


def fault_kinds(config_py: Path) -> list[str]:
    tree = ast.parse(config_py.read_text())
    for stmt in tree.body:
        if isinstance(stmt, ast.Assign) and len(stmt.targets) == 1:
            t = stmt.targets[0]
            if isinstance(t, ast.Name) and t.id == "FAULT_KINDS":
                return [
                    el.value
                    for el in stmt.value.elts
                    if isinstance(el, ast.Constant) and isinstance(el.value, str)
                ]
    return []


# The closed reason vocabularies (module-level tuples in <package>/obs.py)
# TPS404 holds to the docs+tests contract.
REASON_VOCABULARIES = ("SCHED_SHED_REASONS", "TENANT_SHED_REASONS",
                       "GEN_STREAM_REASONS", "ROUTER_STREAM_REASONS",
                       "ROLLBACK_REASONS")


def reason_vocabularies(obs_py: Path) -> list[tuple[str, str]]:
    """(vocabulary tuple name, reason string) for every entry of the
    REASON_VOCABULARIES tuples in obs.py."""
    tree = ast.parse(obs_py.read_text())
    out: list[tuple[str, str]] = []
    for stmt in tree.body:
        if not isinstance(stmt, ast.Assign) or len(stmt.targets) != 1:
            continue
        t = stmt.targets[0]
        if not isinstance(t, ast.Name) or t.id not in REASON_VOCABULARIES:
            continue
        for el in getattr(stmt.value, "elts", ()):
            if isinstance(el, ast.Constant) and isinstance(el.value, str):
                out.append((t.id, el.value))
    return out


_METRIC_RE = re.compile(
    r"""\.(?:counter|gauge|histogram)\(\s*f?["']([a-z][a-z0-9_]*)"""
)


def metric_names(package_dir: Path) -> dict[str, Path]:
    """Metric base name -> first file that emits it."""
    out: dict[str, Path] = {}
    for path in sorted(package_dir.rglob("*.py")):
        text = path.read_text()
        for m in _METRIC_RE.finditer(text):
            out.setdefault(m.group(1), path)
        if "observe_phase(" in text:
            out.setdefault("latency_ms", path)
    return out


def run(root: Path, package: str = "tpuserve_torch") -> list[Finding]:
    findings: list[Finding] = []
    config_py = root / package / "config.py"
    if not config_py.exists():
        return findings
    docs = _read_all([root / "README.md", *sorted((root / "docs").glob("*.md"))])
    example = _read_all([root / "examples" / "serve_all.toml"])
    tests = _read_all(sorted((root / "tests").rglob("*.py")))

    for cls, name in config_fields(config_py):
        missing = []
        if not _token_in(name, example):
            missing.append("examples/serve_all.toml")
        if not _token_in(name, docs):
            missing.append("docs (README.md + docs/*.md)")
        if missing:
            findings.append(
                Finding(
                    rule="TPS401",
                    file=f"{package}/config.py",
                    symbol=f"{cls}.{name}",
                    message=f"config knob not mentioned in: {', '.join(missing)}",
                )
            )

    for name, path in sorted(metric_names(root / package).items()):
        if not _token_in(name, docs):
            findings.append(
                Finding(
                    rule="TPS402",
                    file=path.relative_to(root).as_posix(),
                    symbol=f"metric.{name}",
                    message="metric emitted but undocumented (README.md + docs/*.md)",
                )
            )

    for kind in fault_kinds(config_py):
        if not _token_in(kind, tests):
            findings.append(
                Finding(
                    rule="TPS403",
                    file=f"{package}/config.py",
                    symbol=f"fault.{kind}",
                    message="fault kind has no test referencing it under tests/",
                )
            )

    obs_py = root / package / "obs.py"
    reference = _read_all([root / "docs" / "REFERENCE.md"])
    if obs_py.exists():
        for vocab, reason in reason_vocabularies(obs_py):
            missing = []
            if not _token_in(reason, reference):
                missing.append("docs/REFERENCE.md")
            if not _token_in(reason, tests):
                missing.append("tests/")
            if missing:
                findings.append(
                    Finding(
                        rule="TPS404",
                        file=f"{package}/obs.py",
                        symbol=f"reason.{vocab}.{reason}",
                        message=("shed/terminal reason not covered by: "
                                 + ", ".join(missing)),
                    )
                )
    return findings
