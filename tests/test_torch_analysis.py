"""The port's static analysis (``tpuserve_torch/analysis/``) against the
reference's (``tpuserve/analysis/``).

- ``astlint`` (TPS101-301): the fixture snippets of ``tests/test_analysis.py``
  (``tests/fixtures/analysis/``) through both packages give identical
  findings — rule, file, symbol, message, line and baseline key — and so
  does the whole port tree, ``tpuserve_torch/``;
- ``drift`` (TPS401-404): the same synthetic mini-repo, its config, obs and
  example written under ``tpuserve/`` for the reference and
  ``tpuserve_torch/`` for the port, gives identical findings (the file's
  package directory aside), documented and not;
- ``findings``: the baseline round trip, line numbers outside identity, a
  fixed finding surfacing as stale; a baseline either package writes is
  read by the other;
- ``python -m tpuserve_torch lint``: 0 against the port's checked-in
  baseline, 1 on a new finding (the fixtures without a baseline), 2 on a
  bad path, as ``tests/test_analysis.py::test_lint_cli_exit_codes`` holds
  the reference; ``--update-baseline`` writes a baseline that then runs
  clean, and a stale entry warns without failing; it runs with JAX, the
  reference package, torch and numpy refused at import.

Exact: findings are compared with ``==``.
"""

import json
import subprocess
import sys
from pathlib import Path

import pytest

from tpuserve.analysis import astlint as jastlint
from tpuserve.analysis import drift as jdrift
from tpuserve.analysis import findings as jfindings
from tpuserve_torch.analysis import astlint as tastlint
from tpuserve_torch.analysis import drift as tdrift
from tpuserve_torch.analysis import findings as tfindings

FIXTURES = Path(__file__).parent / "fixtures" / "analysis"
ROOT = Path(__file__).resolve().parents[1]
BASELINE = ROOT / "tpuserve_torch" / "analysis" / "baseline.json"


def rows(findings) -> list[tuple]:
    return [(f.rule, f.file, f.symbol, f.message, f.line, f.key) for f in findings]


@pytest.mark.parametrize("fixture", ["async_blocking.py", "lock_order.py",
                                     "shared_state.py", "async_gen.py"])
def test_astlint_fixture_findings_equal_the_reference(fixture):
    ref = rows(jastlint.run_paths([FIXTURES / fixture], FIXTURES))
    port = rows(tastlint.run_paths([FIXTURES / fixture], FIXTURES))
    assert port == ref
    assert port, f"{fixture}: the fixture's positives found nothing"


def test_astlint_port_tree_findings_equal_the_reference():
    """Both packages' rules over the port's own tree find the same things."""
    files = tastlint.collect_files([ROOT / "tpuserve_torch"])
    assert rows(tastlint.run_paths(files, ROOT)) == rows(jastlint.run_paths(files, ROOT))


def _mini_repo(root: Path, package: str, document: bool) -> Path:
    for d in (package, "examples", "docs", "tests"):
        (root / d).mkdir(parents=True, exist_ok=True)
    (root / package / "config.py").write_text(
        "from dataclasses import dataclass\n"
        'FAULT_KINDS = ("boom",)\n'
        "@dataclass\n"
        "class ModelConfig:\n"
        "    knob_a: int = 1\n"
        "    knob_b: int = 2\n"
    )
    (root / package / "obs.py").write_text(
        'SCHED_SHED_REASONS = ("too_busy",)\n'
        'class M:\n    def f(self, m):\n        m.counter(f"widgets_total{x}").inc()\n'
    )
    (root / "examples" / "serve_all.toml").write_text(
        "knob_a = 1\n" + ("knob_b = 2\n" if document else ""))
    (root / "README.md").write_text(
        "knob_a knob_b\nwidgets_total\n" if document else "knob_a\n")
    (root / "docs" / "REFERENCE.md").write_text("too_busy\n" if document else "\n")
    (root / "tests" / "test_x.py").write_text(
        'KIND = "boom"\nREASON = "too_busy"\n' if document else "pass\n")
    return root


@pytest.mark.parametrize("document", [False, True], ids=["undocumented", "documented"])
def test_drift_findings_equal_the_reference(tmp_path, document):
    ref = jdrift.run(_mini_repo(tmp_path / "ref", "tpuserve", document))
    port = tdrift.run(_mini_repo(tmp_path / "port", "tpuserve_torch", document))
    as_ref = [(r, f.replace("tpuserve_torch/", "tpuserve/"), s, m, line, k.replace(
        " tpuserve_torch/", " tpuserve/")) for r, f, s, m, line, k in rows(port)]
    assert as_ref == rows(ref)
    found = {(f.rule, f.symbol) for f in port}
    if document:
        assert port == []
    else:
        assert found == {("TPS401", "ModelConfig.knob_b"), ("TPS402", "metric.widgets_total"),
                         ("TPS403", "fault.boom"), ("TPS404", "reason.SCHED_SHED_REASONS.too_busy")}


def test_baseline_roundtrip_and_compare_equal_the_reference(tmp_path):
    out = {}
    for name, mod in (("jax", jfindings), ("port", tfindings)):
        old = mod.Finding(rule="TPS101", file="a.py", symbol="f", message="m", line=3)
        new = mod.Finding(rule="TPS201", file="b.py", symbol="g", message="n", line=9)
        path = tmp_path / f"{name}.json"
        mod.save_baseline(path, [old])
        baseline = mod.load_baseline(path)
        fresh, stale = mod.compare([old, new], baseline)
        moved = mod.Finding(rule="TPS101", file="a.py", symbol="f", message="m", line=99)
        out[name] = ([f.key for f in fresh], stale, mod.compare([moved], baseline),
                     mod.compare([], baseline))
        # Either package reads the other's file.
        other = jfindings if mod is tfindings else tfindings
        assert other.load_baseline(path) == baseline
    assert out["port"] == out["jax"]
    fresh, stale, moved, fixed = out["port"]
    assert fresh == ["TPS201 b.py g :: n"] and not stale
    assert moved == ([], set())
    assert fixed == ([], {"TPS101 a.py f :: m"})


def test_port_baseline_file_is_valid_and_names_the_port():
    data = json.loads(BASELINE.read_text())
    assert isinstance(data["findings"], list)
    assert all(e["file"].startswith("tpuserve_torch/") for e in data["findings"])
    assert "python -m tpuserve_torch lint" in data["comment"]


def test_lint_cli_exit_codes(tmp_path, capsys):
    from tpuserve_torch.cli import main

    # --no-baseline over the fixtures must fail (they are all positives).
    assert main(["lint", "--no-baseline", "--no-drift", str(FIXTURES)]) == 1
    assert "TPS101" in capsys.readouterr().out
    assert main(["lint", str(tmp_path / "missing")]) == 2
    # A baseline written from the fixtures' findings runs them clean, and an
    # entry that no longer reproduces warns as stale without failing.
    path = tmp_path / "baseline.json"
    assert main(["lint", "--no-drift", "--baseline", str(path), "--update-baseline",
                 str(FIXTURES)]) == 0
    data = json.loads(path.read_text())
    data["findings"].append({"key": "TPS101 gone.py f :: fixed", "rule": "TPS101",
                             "file": "gone.py", "symbol": "f"})
    path.write_text(json.dumps(data))
    capsys.readouterr()
    assert main(["lint", "--no-drift", "--baseline", str(path), str(FIXTURES)]) == 0
    err = capsys.readouterr().err
    assert "stale baseline entry" in err and "0 new" in err


def test_repo_lint_clean_vs_port_baseline(capsys):
    """``python -m tpuserve_torch lint`` over the port (drift included)
    exits 0 against the checked-in baseline, as CI and the card run it."""
    from tpuserve_torch.cli import main

    assert main(["lint"]) == 0
    err = capsys.readouterr().err
    assert "0 new" in err and "0 stale" in err, err


def test_lint_runs_on_a_bare_python():
    """``python -m tpuserve_torch lint`` imports neither JAX, the reference
    package, torch nor numpy: with each import refused it still exits 0."""
    code = ("import sys\n"
            "for m in ('jax', 'tpuserve', 'torch', 'numpy', 'flax', 'aiohttp'):\n"
            "    sys.modules[m] = None\n"
            "from tpuserve_torch.cli import main\n"
            "sys.exit(main(['lint']))\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "0 new" in proc.stderr
