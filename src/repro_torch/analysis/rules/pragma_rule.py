"""pragma-discipline: suppression pragmas are themselves checked — a
``# repro: allow(...)`` must name registered rules and carry a one-line
justification, or it suppresses nothing and is flagged.  This rule can
never be suppressed by a pragma (the engine refuses)."""
from __future__ import annotations

from .. import FileContext, register_rule
from ..pragmas import iter_pragmas

_MIN_JUSTIFICATION = 8  # characters — long enough to force an actual why


@register_rule("pragma-discipline",
               "every `# repro: allow(...)` pragma names registered rules "
               "and carries a one-line justification")
def _pragma_discipline(ctx: FileContext):
    from .. import _REGISTRY  # populated by the time checks run

    for p in iter_pragmas(ctx.source):
        if not p.rules:
            yield ctx.finding(
                "pragma-discipline", p.line,
                "pragma suppresses no rules (empty allow())",
                "write `# repro: allow(<rule-id>): <why>`")
            continue
        for r in p.rules:
            if r not in _REGISTRY:
                yield ctx.finding(
                    "pragma-discipline", p.line,
                    f"pragma names unknown rule {r!r}",
                    f"registered rules: {sorted(_REGISTRY)}")
        if len(p.justification) < _MIN_JUSTIFICATION:
            yield ctx.finding(
                "pragma-discipline", p.line,
                "pragma lacks a justification — unjustified pragmas "
                "suppress nothing",
                "append `: <one-line why this exception is intentional>`")
