"""SARIF 2.1.0 emitter for the contract checker.

One run, one tool ("repro-analysis"), one reportingDescriptor per
registered rule, one result per finding.  Pragma-suppressed findings are
emitted with an ``inSource`` suppression object so SARIF viewers (and
the GitHub code-scanning upload) show them as reviewed, not open.
"""
from __future__ import annotations

from typing import TYPE_CHECKING

if TYPE_CHECKING:  # pragma: no cover - typing only
    from . import Report

SARIF_VERSION = "2.1.0"
SARIF_SCHEMA = ("https://raw.githubusercontent.com/oasis-tcs/sarif-spec/"
                "master/Schemata/sarif-schema-2.1.0.json")

__all__ = ["to_sarif"]


def to_sarif(report: "Report", rule_docs: dict[str, str]) -> dict:
    """SARIF log dict for `report`; ``rule_docs`` maps rule id -> doc."""
    used = sorted({f.rule for f in report.findings} | set(rule_docs))
    rule_index = {rid: i for i, rid in enumerate(used)}
    descriptors = [{
        "id": rid,
        "shortDescription": {"text": rule_docs.get(rid, rid)},
        "defaultConfiguration": {"level": "error"},
    } for rid in used]
    results = []
    for f in report.findings:
        res = {
            "ruleId": f.rule,
            "ruleIndex": rule_index[f.rule],
            "level": "error",
            "message": {"text": f.message + (f"\nfix: {f.hint}"
                                             if f.hint else "")},
            "locations": [{
                "physicalLocation": {
                    "artifactLocation": {"uri": f.path,
                                         "uriBaseId": "SRCROOT"},
                    "region": {"startLine": max(int(f.line), 1)},
                },
            }],
        }
        if f.suppressed:
            res["suppressions"] = [{"kind": "inSource",
                                    "justification": "repro: allow pragma"}]
        results.append(res)
    return {
        "version": SARIF_VERSION,
        "$schema": SARIF_SCHEMA,
        "runs": [{
            "tool": {"driver": {
                "name": "repro-analysis",
                "informationUri":
                    "https://example.invalid/repro/analysis",
                "rules": descriptors,
            }},
            "originalUriBaseIds": {"SRCROOT": {"uri": "file:///"}},
            "results": results,
            "columnKind": "utf16CodeUnits",
        }],
    }
