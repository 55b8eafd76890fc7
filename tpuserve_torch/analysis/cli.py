"""``python -m tpuserve_torch lint``: run the analysis passes over the port
against its baseline (``tpuserve/analysis/cli.py``'s arguments and exit
codes).

Exit codes: 0 = clean vs baseline (stale baseline entries are warnings),
1 = new findings, 2 = usage error. ``--update-baseline`` rewrites
``tpuserve_torch/analysis/baseline.json`` from the current findings — the
explicit burndown step.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

from tpuserve_torch.analysis import astlint, drift, ledgerlint, tracelint
from tpuserve_torch.analysis.findings import compare, load_baseline, save_baseline

DEFAULT_BASELINE = Path(__file__).resolve().parent / "baseline.json"


def repo_root() -> Path:
    return Path(__file__).resolve().parents[2]


def add_lint_args(p: argparse.ArgumentParser) -> None:
    p.add_argument("paths", nargs="*", help="files/dirs to lint (default: tpuserve_torch/)")
    p.add_argument("--baseline", default=str(DEFAULT_BASELINE), help="baseline JSON path")
    p.add_argument("--no-baseline", action="store_true", help="report every finding, ignore baseline")
    p.add_argument("--update-baseline", action="store_true", help="rewrite the baseline from current findings")
    p.add_argument("--no-drift", action="store_true", help="skip the TPS4xx docs/config/test drift rules")
    p.add_argument("--json", action="store_true", help="emit findings as JSON instead of text")


def run_lint(args: argparse.Namespace) -> int:
    root = repo_root()
    paths = [Path(p).resolve() for p in args.paths] if args.paths else [root / "tpuserve_torch"]
    for p in paths:
        if not p.exists():
            print(f"lint: no such path: {p}", file=sys.stderr)
            return 2
    files = astlint.collect_files(paths)
    findings = astlint.run_paths(files, root)
    findings += tracelint.run_paths(files, root)
    findings += ledgerlint.run_paths(files, root)
    if not args.no_drift:
        findings += drift.run(root)

    if args.update_baseline:
        save_baseline(Path(args.baseline), findings)
        print(f"lint: baseline rewritten with {len(findings)} finding(s) -> {args.baseline}")
        return 0

    baseline = set() if args.no_baseline else load_baseline(Path(args.baseline))
    new, stale = compare(findings, baseline)

    if args.json:
        print(
            json.dumps(
                {
                    "findings": [f.__dict__ for f in findings],
                    "new": [f.key for f in new],
                    "stale_baseline": sorted(stale),
                },
                indent=2,
            )
        )
    else:
        for f in new:
            print(f.render())
        for key in sorted(stale):
            print(f"stale baseline entry (fixed? run --update-baseline): {key}", file=sys.stderr)
        known = len(findings) - len(new)
        print(
            f"lint: {len(findings)} finding(s): {len(new)} new, "
            f"{known} baselined, {len(stale)} stale baseline entr(y/ies)",
            file=sys.stderr,
        )
    return 1 if new else 0


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(prog="tpuserve_torch lint")
    add_lint_args(parser)
    return run_lint(parser.parse_args(argv))


if __name__ == "__main__":
    sys.exit(main())
