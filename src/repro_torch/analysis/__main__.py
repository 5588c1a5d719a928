"""CLI: ``PYTHONPATH=src python -m repro_torch.analysis [--strict] [paths...]``.

Prints one block per finding (``path:line: rule: message`` + fix hint)
and a summary line; ``--strict`` exits 1 on any unsuppressed finding not
recorded in the baseline, and on stale baseline entries (the
no-new-findings ratchet; ``tests/test_torch_analysis.py`` and
``chip_smoke.py`` phase 18 run it over ``src/repro_torch``).
``--sarif`` writes a SARIF 2.1.0 log, ``--github`` prints GitHub Actions
workflow annotations.  Default path: ``src/repro_torch``; default baseline:
``analysis_baseline_torch.json`` under ``--root``.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

from . import available, names, scan_paths
from . import baseline as baseline_mod
from .baseline import DEFAULT_BASELINE
from .sarif import to_sarif


def _github_annotation(f) -> str:
    # newlines are %0A-escaped per the workflow-command grammar
    msg = (f.message + (f" [fix: {f.hint}]" if f.hint else "")).replace(
        "%", "%25").replace("\r", "%0D").replace("\n", "%0A")
    return (f"::error file={f.path},line={f.line},"
            f"title=repro-analysis {f.rule}::{msg}")


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="the port's static contract checker: syntactic "
                    "rules (rng-discipline, backend-dispatch, overflow-guard, "
                    "jit-purity, frozen-core-types, registry-consistency, "
                    "pragma-discipline) plus whole-program dataflow rules "
                    "(overflow-range, tracer-taint, cache-key)")
    ap.add_argument("paths", nargs="*",
                    help="files/directories to scan (default: "
                         "src/repro_torch)")
    ap.add_argument("--strict", action="store_true",
                    help="exit 1 on findings above the baseline or stale "
                         "baseline entries")
    ap.add_argument("--json", action="store_true",
                    help="emit findings as a JSON array")
    ap.add_argument("--sarif", metavar="FILE", default=None,
                    help="write a SARIF 2.1.0 log to FILE ('-' for stdout)")
    ap.add_argument("--github", action="store_true",
                    help="print GitHub Actions ::error annotations for "
                         "findings above the baseline")
    ap.add_argument("--baseline", metavar="FILE", default=None,
                    help=f"baseline file (default: {DEFAULT_BASELINE} "
                         "under --root when present)")
    ap.add_argument("--update-baseline", action="store_true",
                    help="rewrite the baseline from this run's findings "
                         "and exit 0")
    ap.add_argument("--list-rules", action="store_true",
                    help="print the rule registry and exit")
    ap.add_argument("--rule", action="append", default=None,
                    metavar="RULE",
                    help="run only this rule (repeatable; default: all)")
    ap.add_argument("--root", default=None,
                    help="repo root for relative paths / pragma lookup "
                         "(default: cwd)")
    ap.add_argument("--show-suppressed", action="store_true",
                    help="also print pragma-suppressed findings")
    args = ap.parse_args(argv)

    if args.list_rules:
        for name, doc in available().items():
            print(f"{name:22s} {doc}")
        return 0
    if args.rule:
        unknown = sorted(set(args.rule) - set(names()))
        if unknown:
            ap.error(f"unknown rule(s) {unknown}; see --list-rules")

    report = scan_paths(args.paths or ["src/repro_torch"],
                        root=args.root, rules=args.rule)

    root = Path(args.root or ".")
    baseline_path = Path(args.baseline) if args.baseline \
        else root / DEFAULT_BASELINE
    if args.update_baseline:
        baseline_mod.write(baseline_path, report)
        print(f"baseline {baseline_path} updated: "
              f"{len(report.unsuppressed)} finding(s) recorded")
        return 0
    try:
        entries = baseline_mod.load(baseline_path)
    except ValueError as exc:
        print(f"error: {exc}", file=sys.stderr)
        return 2
    bdiff = baseline_mod.diff(report, entries)

    if args.sarif:
        log = to_sarif(report, available())
        text = json.dumps(log, indent=2, sort_keys=True)
        if args.sarif == "-":
            print(text)
        else:
            Path(args.sarif).write_text(text + "\n")
    if args.github:
        for f in bdiff.new:
            print(_github_annotation(f))
        for e in bdiff.stale:
            print("::error title=repro-analysis stale-baseline::baseline "
                  f"entry no longer reproduces: {e.get('rule')} at "
                  f"{e.get('path')}; run --update-baseline")

    if args.json:
        print(json.dumps([f.to_dict() for f in report.findings], indent=2))
    else:
        shown = report.findings if args.show_suppressed \
            else report.unsuppressed
        for f in shown:
            print(f.render())
        for e in bdiff.stale:
            print(f"stale baseline entry (no longer reproduces): "
                  f"{e.get('rule')}: {e.get('path')}: {e.get('message')}")
        baselined = len(report.unsuppressed) - len(bdiff.new)
        extra = f", {baselined} baselined" if baselined else ""
        print(f"checked {report.n_files} files: "
              f"{len(report.unsuppressed)} finding(s){extra}, "
              f"{len(report.suppressed)} suppressed")

    return 1 if (args.strict and not bdiff.ok()) else 0


if __name__ == "__main__":
    sys.exit(main())
