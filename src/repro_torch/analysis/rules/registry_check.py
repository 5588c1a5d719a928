"""registry-consistency: inspect the port's *live* registries instead of
source text (``repro_torch.core.engine``'s schedulers and
``repro_torch.scenarios``' builders).  Every scheduler's declared
``options=`` must match the keyword parameters its factory chain actually
accepts (following ``**opts`` forwarding, which ``register_scheduler``'s
own registration-time check cannot see through; ``device`` and
``plan_backend`` are the registry's own keywords, not options), and every
scenario builder must accept the ``m`` / ``seed`` / ``scale`` convention
and declare metadata within the documented vocabulary (bounds keys, DAG
family, arrival model)."""
from __future__ import annotations

import ast
import inspect
import textwrap
from pathlib import Path

from .. import Finding, register_rule
from ._util import dotted

#: bounds keys ScenarioMeta documents as instance-checkable
_BOUND_KEYS = {"flow_min", "entry_max", "width_max", "mu_max", "n_jobs_max"}
#: keywords every scenario builder must accept (registry.py docstring)
_BUILDER_KW = ("m", "seed", "scale")
#: keywords every scheduler factory takes that are not options
_CONTRACT_KW = {"device", "plan_backend"}


def _anchor(fn) -> tuple[str, int]:
    """(repo-relative path, lineno) of a callable's definition."""
    code = getattr(fn, "__code__", None)
    if code is None:
        return "<builtin>", 1
    p = Path(code.co_filename)
    try:
        p = p.relative_to(Path.cwd())
    except ValueError:
        pass
    return p.as_posix(), code.co_firstlineno


def _accepted_keywords(fn, _seen=None) -> set[str]:
    """Keyword-only params of `fn`, unioned through ``**opts`` forwarding:
    if the factory forwards its VAR_KEYWORD dict to another function we
    can resolve in its globals, that callee's keywords count too."""
    _seen = _seen or set()
    if fn in _seen:
        return set()
    _seen.add(fn)
    try:
        params = list(inspect.signature(fn).parameters.values())
    except (TypeError, ValueError):
        return set()
    kw = {p.name for p in params if p.kind == p.KEYWORD_ONLY}
    var = next((p.name for p in params if p.kind == p.VAR_KEYWORD), None)
    if var is None:
        return kw
    try:
        tree = ast.parse(textwrap.dedent(inspect.getsource(fn)))
    except (OSError, TypeError, SyntaxError):
        return kw
    globs = getattr(fn, "__globals__", {})
    for node in ast.walk(tree):
        if not isinstance(node, ast.Call):
            continue
        if not any(k.arg is None and isinstance(k.value, ast.Name)
                   and k.value.id == var for k in node.keywords):
            continue
        parts = dotted(node.func)
        if parts and len(parts) == 1 and parts[0] in globs:
            kw |= _accepted_keywords(globs[parts[0]], _seen)
    return kw


def _check_schedulers():
    from repro_torch.core import engine

    for name in sorted(engine._REGISTRY):
        entry = engine._REGISTRY[name]
        path, line = _anchor(entry.factory)
        declared = set(entry.options)
        accepted = _accepted_keywords(entry.factory) - _CONTRACT_KW
        missing = sorted(accepted - declared)
        phantom = sorted(declared - accepted)
        if missing:
            yield Finding(
                "registry-consistency", path, line,
                f"scheduler {name!r}: factory chain accepts "
                f"{missing} but options= does not declare them",
                "add them to the options tuple so make_scheduler "
                "validation matches reality")
        if phantom:
            yield Finding(
                "registry-consistency", path, line,
                f"scheduler {name!r}: options= declares {phantom} "
                "not accepted anywhere in the factory chain",
                "drop the phantom options or add the parameters")


def _check_scenarios():
    from repro_torch.scenarios import registry as sreg
    from repro_torch.scenarios import zoo  # noqa: F401  (import registers)

    for name in sreg.names():
        scen = sreg.get(name)
        path, line = _anchor(scen.builder)
        try:
            params = inspect.signature(scen.builder).parameters
        except (TypeError, ValueError):
            continue
        has_var = any(p.kind == p.VAR_KEYWORD for p in params.values())
        for req in _BUILDER_KW:
            p = params.get(req)
            ok = has_var or (p is not None and p.kind in
                             (p.KEYWORD_ONLY, p.POSITIONAL_OR_KEYWORD))
            if not ok:
                yield Finding(
                    "registry-consistency", path, line,
                    f"scenario {name!r}: builder does not accept the "
                    f"registry-convention keyword {req!r}",
                    "every scenario builder takes m=None, seed=0, "
                    "scale=1.0 (scenarios/registry.py docstring)")
        try:
            built = scen.build(seed=0, scale=0.05)
        except Exception as exc:  # build failure IS the inconsistency
            yield Finding(
                "registry-consistency", path, line,
                f"scenario {name!r}: build(seed=0, scale=0.05) raised "
                f"{type(exc).__name__}: {exc}",
                "registered scenarios must build at small scales for "
                "tests and fast benchmarks")
            continue
        meta = built.meta
        bad = sorted(set(meta.bounds) - _BOUND_KEYS)
        if bad:
            yield Finding(
                "registry-consistency", path, line,
                f"scenario {name!r}: metadata bounds keys {bad} are not "
                f"instance-checkable (known: {sorted(_BOUND_KEYS)})",
                "check_bounds silently ignores unknown keys — fix the "
                "key name or extend ScenarioMeta's documented set")
        if meta.dag_family not in sreg.DAG_FAMILIES:
            yield Finding(
                "registry-consistency", path, line,
                f"scenario {name!r}: dag_family {meta.dag_family!r} not "
                f"in {sreg.DAG_FAMILIES}", "fix the metadata")
        if meta.arrival not in sreg.ARRIVALS:
            yield Finding(
                "registry-consistency", path, line,
                f"scenario {name!r}: arrival {meta.arrival!r} not in "
                f"{sreg.ARRIVALS}", "fix the metadata")


@register_rule("registry-consistency",
               "declared scheduler options= match the factory chain's "
               "real keywords (through **opts); scenario builders honor "
               "the m/seed/scale convention with valid metadata",
               scope="project")
def _registry_consistency():
    yield from _check_schedulers()
    yield from _check_scenarios()
