"""Inline suppression pragmas: ``# repro: allow(<rule>[, <rule>...]): why``.

A pragma on a code line suppresses those rules on that line; a pragma on a
comment-only line covers the next non-blank source line (so long imports
can carry the annotation above them).  The justification after the pragma
is mandatory — ``parse_allows`` still indexes unjustified pragmas so the
``pragma-discipline`` rule can point at them, but rule findings are only
suppressed through justified entries (see ``iter_pragmas``).
"""
from __future__ import annotations

import re
from typing import Iterator, NamedTuple

# group(1): comma list of rule ids; group(2): trailing text (justification)
PRAGMA_RE = re.compile(r"#\s*repro:\s*allow\(([a-zA-Z0-9_,\s-]*)\)(.*)$")


class Pragma(NamedTuple):
    line: int          # 1-based line the pragma is written on
    target: int        # 1-based line it applies to
    rules: tuple[str, ...]
    justification: str


def _is_comment_only(line: str, match_start: int) -> bool:
    return line[:match_start].strip() == ""


def iter_pragmas(source: str) -> Iterator[Pragma]:
    lines = source.splitlines()
    for i, line in enumerate(lines, start=1):
        m = PRAGMA_RE.search(line)
        if m is None:
            continue
        rules = tuple(r.strip() for r in m.group(1).split(",") if r.strip())
        just = m.group(2).strip().lstrip(":—–-").strip()
        target = i
        if _is_comment_only(line, m.start()):
            # standalone comment: applies to the next non-blank line
            for j in range(i, len(lines)):
                if lines[j].strip():
                    target = j + 1
                    break
        yield Pragma(i, target, rules, just)


def parse_allows(source: str) -> dict[int, set[str]]:
    """target line -> set of rule ids suppressed there (justified pragmas
    only — an unjustified pragma suppresses nothing)."""
    allows: dict[int, set[str]] = {}
    for p in iter_pragmas(source):
        if not p.justification:
            continue
        allows.setdefault(p.target, set()).update(p.rules)
    return allows
