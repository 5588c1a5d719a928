"""The port's static contract checker (`python -m repro_torch.analysis`).

The port's guarantees (plans bit-identical to the reference's, a card's
result equal to the CPU's, gradients with the same bits on every run) rest
on conventions that nothing in the type system enforces: seeded RNG
streams, kernels reached only through ``core/backend.py`` dispatch, int32
arguments that a ctypes launch cannot wrap, staged bodies without side
effects, and core result types treated as immutable outside their
defining modules.  This package machine-checks those conventions for
``src/repro_torch``, with the same rule ids, registry and CLI as the
reference's checker (``src/repro/analysis``) but its rules keyed to the
port's idiom: relative kernel imports, ``load_kernel(...)`` entries
called through ctypes, torch's generators and staging calls.  It imports
nothing of ``repro`` and keeps its own copy of the machinery: a
string-keyed **rule registry** (`register_rule` / `get` / `names` /
`available`), an AST scan engine, and a CLI (``__main__.py``) that exits
non-zero under ``--strict`` on any unsuppressed finding.

Rules ship in ``rules/`` (one module per contract); adding one is one
decorator::

    from repro_torch.analysis import Finding, register_rule

    @register_rule("my-rule", "one-line contract description")
    def _my_rule(ctx):                  # ctx: FileContext
        for node in ast.walk(ctx.tree):
            ...
            yield ctx.finding("my-rule", node, "message", hint="fix hint")

Intentional exceptions are annotated inline with the reference's pragma
syntax and MUST carry a one-line justification (the ``pragma-discipline``
rule rejects bare pragmas); a pragma names one of the ten rule ids both
checkers know, since the reference's checker scans this tree too.

File-scope rules see one ``FileContext`` at a time.  Rules registered
with ``scope="program"`` receive a :class:`ProgramContext` (every scanned
file plus a lazily-built whole-program symbol index) and run on the
dataflow layer in :mod:`repro_torch.analysis.flow` (interval/shape
abstract interpretation, interprocedural taint, call-graph reachability).
``--strict`` gates against the checked-in ``analysis_baseline_torch.json``
ratchet (new findings fail, stale entries fail, the baseline only
shrinks); ``--sarif`` / ``--github`` emit machine-readable output.

See the README's "PyTorch / H100 port" section for the rule table.
"""
from __future__ import annotations

import ast
from dataclasses import dataclass, field
from pathlib import Path
from typing import Callable, Iterable, Iterator

from .pragmas import PRAGMA_RE, parse_allows

__all__ = [
    "Finding",
    "FileContext",
    "ProgramContext",
    "Rule",
    "Report",
    "register_rule",
    "get",
    "names",
    "available",
    "scan_paths",
    "iter_python_files",
]


@dataclass(frozen=True)
class Finding:
    """One contract violation: rule id, location, message, fix hint."""

    rule: str
    path: str        # scan-root-relative posix path
    line: int
    message: str
    hint: str = ""
    suppressed: bool = False

    def render(self) -> str:
        s = " [suppressed]" if self.suppressed else ""
        out = f"{self.path}:{self.line}: {self.rule}: {self.message}{s}"
        if self.hint:
            out += f"\n    fix: {self.hint}"
        return out

    def to_dict(self) -> dict:
        return {"rule": self.rule, "path": self.path, "line": self.line,
                "message": self.message, "hint": self.hint,
                "suppressed": self.suppressed}


@dataclass
class FileContext:
    """Everything a file-scope rule sees: source, AST, and the repo-relative
    path the rules key their applicability on (``tests/...``,
    ``src/repro_torch/kernels/<k>/ops.py``, ...)."""

    path: Path                 # absolute
    rel: str                   # scan-root-relative posix path
    source: str
    tree: ast.AST
    lines: list[str] = field(default_factory=list)

    # --- path classification (shared by the rules) -------------------------
    def in_testing(self) -> bool:
        """tests/ is test code."""
        return self.rel.startswith("tests/") or "/tests/" in self.rel

    def in_benchmarks(self) -> bool:
        return self.rel.startswith("benchmarks/") or "/benchmarks/" in self.rel

    def in_kernels(self) -> bool:
        return "repro_torch/kernels/" in self.rel

    def in_core(self) -> bool:
        return "repro_torch/core/" in self.rel

    def basename(self) -> str:
        return self.rel.rsplit("/", 1)[-1]

    def finding(self, rule: str, node: ast.AST | int, message: str,
                hint: str = "") -> Finding:
        line = node if isinstance(node, int) else getattr(node, "lineno", 1)
        return Finding(rule, self.rel, line, message, hint)


@dataclass
class ProgramContext:
    """Everything a program-scope (dataflow) rule sees: every scanned
    FileContext plus a lazily-built whole-program symbol index
    (:class:`repro_torch.analysis.flow.modules.ProjectIndex`).  See the
    :mod:`repro_torch.analysis.flow` docstring for the rule-writing guide."""

    files: list[FileContext]
    _index: object = None

    @property
    def index(self):
        if self._index is None:
            from .flow.modules import ProjectIndex
            self._index = ProjectIndex(self.files)
        return self._index


_CheckFn = Callable[..., "Iterable[Finding]"]


@dataclass(frozen=True)
class Rule:
    """A registry entry: named contract + its checker.

    scope="file" checkers receive a FileContext per scanned file;
    scope="project" checkers run once per scan (inspect-based rules that
    import the live registries) and receive no arguments;
    scope="program" checkers run once per scan over a ProgramContext
    (whole-program dataflow rules)."""

    name: str
    doc: str
    check: _CheckFn
    scope: str = "file"


_REGISTRY: dict[str, Rule] = {}


def register_rule(name: str, doc: str = "", scope: str = "file"):
    """Register ``check(ctx) -> Iterable[Finding]`` under ``name``
    (decorator) — the scheduler-registry idiom applied to lint rules."""
    if scope not in ("file", "project", "program"):
        raise ValueError(
            f"rule scope must be file|project|program, got {scope!r}")

    def deco(check: _CheckFn) -> _CheckFn:
        if name in _REGISTRY:
            raise ValueError(f"rule {name!r} already registered")
        _REGISTRY[name] = Rule(name, doc or (check.__doc__ or "").strip(),
                               check, scope)
        return check

    return deco


def get(name: str) -> Rule:
    _load_rules()
    if name not in _REGISTRY:
        raise KeyError(f"unknown rule {name!r}; registered: {sorted(_REGISTRY)}")
    return _REGISTRY[name]


def names() -> list[str]:
    _load_rules()
    return sorted(_REGISTRY)


def available() -> dict[str, str]:
    """name -> one-line description, for the CLI and reports."""
    _load_rules()
    return {name: r.doc for name, r in sorted(_REGISTRY.items())}


def _load_rules() -> None:
    from . import rules  # noqa: F401  (registers on import)


@dataclass
class Report:
    """A whole scan: every finding (suppressed ones flagged, not dropped)
    plus the file count, so callers can render totals."""

    findings: list[Finding]
    n_files: int

    @property
    def unsuppressed(self) -> list[Finding]:
        return [f for f in self.findings if not f.suppressed]

    @property
    def suppressed(self) -> list[Finding]:
        return [f for f in self.findings if f.suppressed]

    def ok(self) -> bool:
        return not self.unsuppressed


_SKIP_DIRS = {"__pycache__", ".git", ".venv", "node_modules"}


def iter_python_files(paths: Iterable[str | Path]) -> Iterator[Path]:
    """Every .py file under `paths` (files taken verbatim), deterministic
    order, hidden/cache dirs skipped."""
    seen: set[Path] = set()
    for p in paths:
        p = Path(p)
        if p.is_file():
            files: Iterable[Path] = [p]
        elif p.is_dir():
            files = sorted(q for q in p.rglob("*.py")
                           if not any(part in _SKIP_DIRS or
                                      part.startswith(".")
                                      for part in q.parts))
        else:
            raise FileNotFoundError(f"no such file or directory: {p}")
        for f in files:
            f = f.resolve()
            if f not in seen:
                seen.add(f)
                yield f


def _relativize(path: Path, root: Path) -> str:
    try:
        return path.relative_to(root).as_posix()
    except ValueError:
        return path.as_posix()


class _AllowIndex:
    """Lazy per-file pragma index; project-rule findings may land in files
    outside the scanned set (registration sites), so allows are loaded on
    demand from disk."""

    def __init__(self) -> None:
        self._by_path: dict[str, dict[int, set[str]]] = {}

    def seed(self, rel: str, source: str) -> None:
        self._by_path[rel] = parse_allows(source)

    def allows(self, root: Path, rel: str) -> dict[int, set[str]]:
        if rel not in self._by_path:
            p = root / rel
            try:
                self._by_path[rel] = parse_allows(
                    p.read_text(encoding="utf-8"))
            except OSError:
                self._by_path[rel] = {}
        return self._by_path[rel]


def scan_paths(paths: Iterable[str | Path], root: str | Path | None = None,
               rules: Iterable[str] | None = None,
               project: bool | None = None) -> Report:
    """Run the rule registry over `paths`.

    `root` anchors the repo-relative paths the rules classify on (default:
    the current working directory).  `rules` restricts to a subset of rule
    names.  `project` forces project-scope rules on/off; by default they run
    only when the scan covers the port's own source (its
    ``repro_torch/core/engine.py``), so scanning a fixture tree does not
    drag the live registries in.
    """
    _load_rules()
    root = Path(root).resolve() if root is not None else Path.cwd().resolve()
    if rules is None:
        active = list(_REGISTRY.values())
    else:
        active = [get(n) for n in rules]
    file_rules = [r for r in active if r.scope == "file"]
    project_rules = [r for r in active if r.scope == "project"]
    program_rules = [r for r in active if r.scope == "program"]

    allow_index = _AllowIndex()
    findings: list[Finding] = []
    contexts: list[FileContext] = []
    n_files = 0
    scanned_port = False
    for path in iter_python_files(paths):
        n_files += 1
        rel = _relativize(path, root)
        if "repro_torch/core/engine.py" in rel:
            scanned_port = True
        source = path.read_text(encoding="utf-8")
        allow_index.seed(rel, source)
        try:
            tree = ast.parse(source, filename=str(path))
        except SyntaxError as exc:
            findings.append(Finding(
                "parse-error", rel, exc.lineno or 1,
                f"file does not parse: {exc.msg}",
                "fix the syntax error; no rule can check an unparsable file"))
            continue
        ctx = FileContext(path, rel, source, tree, source.splitlines())
        contexts.append(ctx)
        for rule in file_rules:
            findings.extend(rule.check(ctx))

    if program_rules and contexts:
        prog = ProgramContext(contexts)
        for rule in program_rules:
            findings.extend(rule.check(prog))

    if project is None:
        project = scanned_port
    if project:
        for rule in project_rules:
            findings.extend(rule.check())

    out: list[Finding] = []
    for f in findings:
        allowed = allow_index.allows(root, f.path).get(f.line, set())
        if f.rule in allowed and f.rule != "pragma-discipline":
            f = Finding(f.rule, f.path, f.line, f.message, f.hint,
                        suppressed=True)
        out.append(f)
    return Report(out, n_files)
