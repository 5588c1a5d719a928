"""No-new-findings ratchet against a checked-in baseline.

The baseline file (``analysis_baseline_torch.json`` at the repo root;
the reference's ``analysis_baseline.json`` is never read or written) records
the accepted findings as ``(rule, path, message)`` triples — deliberately
*line-insensitive*, so unrelated edits that shift a known finding do not
trip CI, while any new finding (or a message change, which means the
analysis got more precise) does.

``diff`` is a two-sided ratchet:

* **new** — unsuppressed findings not in the baseline: what ``--strict``
  fails on.
* **stale** — baseline entries no longer reported: the finding was fixed
  (or the rule tightened) but the baseline was not refreshed.
  ``--strict`` fails on these too, so the baseline can only ever shrink
  to match reality,
  never accumulate dead entries that would mask a regression at the same
  location later.

Refresh with ``python -m repro_torch.analysis --update-baseline`` after fixing
findings (the normal direction) or after accepting a new finding with a
written rationale in review (the exceptional one).
"""
from __future__ import annotations

import json
from dataclasses import dataclass, field
from pathlib import Path
from typing import TYPE_CHECKING

if TYPE_CHECKING:  # pragma: no cover - typing only
    from . import Finding, Report

BASELINE_VERSION = 1
DEFAULT_BASELINE = "analysis_baseline_torch.json"

__all__ = ["BaselineDiff", "diff", "load", "write", "DEFAULT_BASELINE"]


def _key(entry: dict) -> tuple[str, str, str]:
    return (str(entry.get("rule", "")), str(entry.get("path", "")),
            str(entry.get("message", "")))


def _finding_key(f: "Finding") -> tuple[str, str, str]:
    return (f.rule, f.path, f.message)


def load(path: str | Path) -> list[dict]:
    """Baseline entries; [] for a missing file, error on a malformed one."""
    p = Path(path)
    if not p.exists():
        return []
    data = json.loads(p.read_text())
    if not isinstance(data, dict) or "findings" not in data:
        raise ValueError(f"malformed baseline {p}: expected an object with "
                         "a 'findings' list")
    if data.get("version") != BASELINE_VERSION:
        raise ValueError(f"baseline {p} has version {data.get('version')!r};"
                         f" this checker writes version {BASELINE_VERSION}")
    return list(data["findings"])


def write(path: str | Path, report: "Report") -> None:
    """Record the report's unsuppressed findings as the new baseline."""
    entries = sorted(
        ({"rule": f.rule, "path": f.path, "message": f.message}
         for f in report.unsuppressed),
        key=_key)
    Path(path).write_text(json.dumps(
        {"version": BASELINE_VERSION, "findings": entries},
        indent=2, sort_keys=True) + "\n")


@dataclass
class BaselineDiff:
    """Ratchet outcome: both lists must be empty for ``--strict`` to pass."""

    new: list = field(default_factory=list)      # Finding
    stale: list = field(default_factory=list)    # baseline entry dicts

    def ok(self) -> bool:
        return not self.new and not self.stale


def diff(report: "Report", entries: list[dict]) -> BaselineDiff:
    """Compare unsuppressed findings against baseline entries.

    Matching is multiset-aware: two identical findings in the report
    consume two identical baseline entries, so a duplicated regression
    at a second call site still surfaces as new.
    """
    budget: dict[tuple[str, str, str], int] = {}
    for e in entries:
        k = _key(e)
        budget[k] = budget.get(k, 0) + 1
    out = BaselineDiff()
    for f in report.unsuppressed:
        k = _finding_key(f)
        if budget.get(k, 0) > 0:
            budget[k] -= 1
        else:
            out.new.append(f)
    for e in entries:
        k = _key(e)
        if budget.get(k, 0) > 0:
            budget[k] -= 1
            out.stale.append(e)
    return out
