"""The port checker's dataflow layer: the fixture corpus under
``tests/torch_analysis_fixtures/proj`` (positives the syntactic rules
cannot see, negatives the engine must prove), and the machinery held
equal to the reference's (``repro.analysis``) on the same inputs: pragma
parsing, interval arithmetic and canonical symbols, the baseline ratchet,
SARIF, and the module index and call graph over the reference's own
fixture project.  Equality throughout, no tolerance."""
from __future__ import annotations

import ast
import itertools
import json
from pathlib import Path

import pytest

from repro.analysis import Finding as RefFinding
from repro.analysis import FileContext as RefFileContext
from repro.analysis import Report as RefReport
from repro.analysis import baseline as ref_baseline
from repro.analysis import pragmas as ref_pragmas
from repro.analysis.flow import callgraph as ref_callgraph
from repro.analysis.flow import intervals as ref_iv
from repro.analysis.flow import modules as ref_modules
from repro.analysis.sarif import to_sarif as ref_to_sarif
from repro_torch.analysis import FileContext, Finding, Report, scan_paths
from repro_torch.analysis import baseline as baseline_mod
from repro_torch.analysis import pragmas
from repro_torch.analysis.__main__ import main
from repro_torch.analysis.flow import callgraph, modules
from repro_torch.analysis.flow import intervals as iv
from repro_torch.analysis.rules import overflow_range
from repro_torch.analysis.sarif import to_sarif

REPO = Path(__file__).resolve().parent.parent
FIXTURES = REPO / "tests" / "torch_analysis_fixtures" / "proj"
REF_FIXTURES = REPO / "tests" / "analysis_fixtures" / "proj"

DATAFLOW_RULES = ["overflow-range", "tracer-taint", "cache-key"]
SYNTACTIC_RULES = ["rng-discipline", "backend-dispatch", "overflow-guard",
                   "jit-purity", "frozen-core-types", "pragma-discipline"]
# the fixture kernels' rows: goodk indexes its first operand in 32 bits,
# badk none (its positive is the c_int argument)
FIXTURE_ROWS = {("goodk", "goodk_launch"): ((0,), "fixture goodk.cu:1"),
                ("badk", "badk_launch"): ((), "fixture badk.cu:1")}


@pytest.fixture
def fixture_rows(monkeypatch):
    for key, row in FIXTURE_ROWS.items():
        monkeypatch.setitem(overflow_range.INT32_INDEXED, key, row)


@pytest.fixture
def fixture_report(fixture_rows):
    return scan_paths([FIXTURES / "src"], root=FIXTURES,
                      rules=DATAFLOW_RULES)


def _by_rule(report, rule):
    return [f for f in report.unsuppressed if f.rule == rule]


# --------------------------------------------------------------------------
# fixture corpus: positives caught, negatives proven
# --------------------------------------------------------------------------

def test_overflow_range_positive(fixture_report):
    hits = _by_rule(fixture_report, "overflow-range")
    assert len(hits) == 1
    f = hits[0]
    assert f.path == "src/repro_torch/kernels/badk/ops.py"
    # the unguarded x.numel() at the c_int slot, through the forwarder
    assert "argument 2 of badk_launch() (ctypes.c_int)" in f.message
    assert "x.numel()" in f.message


def test_overflow_range_negative(fixture_report):
    assert not [f for f in _by_rule(fixture_report, "overflow-range")
                if "goodk" in f.path]


def test_overflow_range_resolves_fixture_launches(fixture_rows):
    sites = overflow_range.resolve_launches([FIXTURES / "src"], FIXTURES)
    got = {(s.kernel, s.entries, s.argtypes) for s in sites}
    assert got == {
        ("badk", ("badk_launch",),
         ("c_void_p", "c_int", "c_int", "c_void_p")),
        ("goodk", ("goodk_launch",),
         ("c_void_p",) * 2 + ("c_int",) * 3 + ("c_void_p",))}


def test_tracer_taint_positive_is_interprocedural(fixture_report):
    hits = _by_rule(fixture_report, "tracer-taint")
    assert len(hits) == 1
    f = hits[0]
    # flagged in the helper module the syntactic rule never inspects,
    # attributed back to the staging call it was reached from
    assert f.path == "src/repro_torch/core/helper.py"
    assert "if" in f.message and "staged into torch.func.vmap" in f.message


def test_tracer_taint_negative(fixture_report):
    # the staged body itself is clean: a shape branch, a passed-through n
    assert not [f for f in _by_rule(fixture_report, "tracer-taint")
                if f.path.endswith("staged.py")]


def test_cache_key_param_positive(fixture_report):
    msgs = [f.message for f in _by_rule(fixture_report, "cache-key")]
    assert any("cached_plan()" in m and "'scale'" in m for m in msgs)


def test_cache_key_knob_positive(fixture_report):
    """Any environment read is a hidden input (the port has no REPRO_*
    knobs), os.getenv included."""
    msgs = [f.message for f in _by_rule(fixture_report, "cache-key")]
    assert any("cached_env()" in m and "FAKE_MODE" in m for m in msgs)


@pytest.mark.parametrize("fn", ["cached_sound", "cached_on_device",
                                "cached_groups_sound"])
def test_cache_key_negative(fixture_report, fn):
    assert not [f for f in _by_rule(fixture_report, "cache-key")
                if f"{fn}()" in f.message]


def test_cache_key_grouping_gamma_positive(fixture_report):
    msgs = [f.message for f in _by_rule(fixture_report, "cache-key")]
    assert any("cached_groups()" in m and "'gamma'" in m for m in msgs)


def test_positives_invisible_to_syntactic_rules(fixture_rows):
    """The corpus' whole point: every dataflow positive passes the
    file-scope rules."""
    rep = scan_paths([FIXTURES / "src"], root=FIXTURES,
                     rules=SYNTACTIC_RULES)
    assert rep.unsuppressed == []


def test_cli_sarif_and_github(tmp_path, capsys, fixture_rows):
    out = tmp_path / "log.sarif"
    assert main(["--sarif", str(out), "--github",
                 str(FIXTURES / "src"), "--root", str(FIXTURES),
                 "--baseline", str(tmp_path / "none.json")]) == 0
    log = json.loads(out.read_text())
    results = log["runs"][0]["results"]
    assert {r["ruleId"] for r in results} >= {"overflow-range",
                                              "tracer-taint", "cache-key"}
    text = capsys.readouterr().out
    assert "::error file=src/repro_torch/kernels/badk/ops.py" in text
    assert "title=repro-analysis overflow-range" in text


def test_baseline_roundtrip_and_cli_update(tmp_path, capsys, fixture_rows):
    bl = tmp_path / "bl.json"
    bl.write_text(json.dumps({"version": 1, "findings": [
        {"rule": "ghost", "path": "src/x.py", "message": "gone"}]}))
    goodk = str(FIXTURES / "src" / "repro_torch" / "kernels" / "goodk")
    args = [goodk, "--root", str(FIXTURES), "--baseline", str(bl)]
    # stale entry fails strict even with zero findings
    assert main(["--strict", *args]) == 1
    assert "stale" in capsys.readouterr().out
    # --update-baseline rewrites it and strict passes again
    assert main(["--update-baseline", *args]) == 0
    capsys.readouterr()
    assert baseline_mod.load(bl) == []
    assert main(["--strict", *args]) == 0


def test_default_baseline_is_the_ports(tmp_path, capsys):
    """Without --baseline the CLI reads analysis_baseline_torch.json under
    --root, never the reference's analysis_baseline.json."""
    (tmp_path / "analysis_baseline.json").write_text("not json")
    (tmp_path / "analysis_baseline_torch.json").write_text(json.dumps(
        {"version": 1, "findings": [{"rule": "ghost", "path": "p",
                                     "message": "m"}]}))
    (tmp_path / "a.py").write_text("x = 1\n")
    assert main(["--strict", str(tmp_path / "a.py"),
                 "--root", str(tmp_path)]) == 1
    assert "stale baseline entry" in capsys.readouterr().out


# --------------------------------------------------------------------------
# parity with the reference's machinery, on the same inputs
# --------------------------------------------------------------------------

def _sources():
    """Every Python source of both packages and both fixture projects,
    plus pragma edge cases."""
    roots = [REPO / "src", REPO / "tests" / "analysis_fixtures",
             REPO / "tests" / "torch_analysis_fixtures"]
    out = [p.read_text() for r in roots for p in sorted(r.rglob("*.py"))]
    out.append("x = 1  # repro: allow(a, b): why not\n"
               "# repro: allow(c)\n\n\ny = 2\n"
               "# repro: allow(): empty\n"
               "z = 3  #repro:allow(rng-discipline)—em dash reason\n"
               "# repro: allow(d): trailing comment at the end\n")
    return out


def test_parity_pragmas():
    n = 0
    for src in _sources():
        assert list(pragmas.iter_pragmas(src)) == \
            list(ref_pragmas.iter_pragmas(src))
        assert pragmas.parse_allows(src) == ref_pragmas.parse_allows(src)
        n += 1
    assert n > 200


def test_parity_interval_arithmetic():
    vals = [-7.0, -1.0, 0.0, 1.0, 3.0, 128.0, float("inf"), -float("inf")]
    ivs = [(lo, hi) for lo, hi in itertools.product(vals, vals) if lo <= hi]
    for (a0, a1), (b0, b1) in itertools.product(ivs, ivs):
        a, b = iv.IV(a0, a1), iv.IV(b0, b1)
        ra, rb = ref_iv.IV(a0, a1), ref_iv.IV(b0, b1)
        for op in ("add", "sub", "mul", "join", "meet", "floordiv", "mod",
                   "lshift"):
            # repr: inf - inf gives nan on both sides, and nan != nan
            assert repr(tuple(getattr(a, op)(b))) == \
                repr(tuple(getattr(ra, op)(rb))), (op, a, b)
        assert tuple(a.neg()) == tuple(ra.neg())
        assert a.is_const() == ra.is_const()
    # the reference's own cases
    a, b = iv.IV(2, 3), iv.IV(-1, 4)
    assert a.add(b) == iv.IV(1, 7) == ref_iv.IV(2, 3).add(ref_iv.IV(-1, 4))
    assert a.mul(b) == iv.IV(-3, 12)
    assert a.join(b) == iv.IV(-1, 4) and a.meet(b) == iv.IV(2, 3)


def _exprs(mod):
    x, y, z = (mod.s_atom(f"param:{n}") for n in "xyz")
    c = mod.s_const
    return [x, y, c(0), c(1), c(-3), mod.s_add(x, c(1)), mod.s_mul(x, y),
            mod.s_mul(c(2), mod.s_add(x, y)), mod.s_sub(x, y),
            mod.s_mul(mod.s_mul(x, y), z), mod.s_neg(mod.s_add(x, z))]


def test_parity_canonical_symbols():
    mine, ref = _exprs(iv), _exprs(ref_iv)
    assert mine == ref
    for (a, ra), (b, rb) in itertools.product(zip(mine, ref), repeat=2):
        assert iv.s_add(a, b) == ref_iv.s_add(ra, rb)
        assert iv.s_sub(a, b) == ref_iv.s_sub(ra, rb)
        assert iv.s_mul(a, b) == ref_iv.s_mul(ra, rb)
        assert iv.s_factors(a) == ref_iv.s_factors(ra)
    # the reference's own cases: cancellation and commutation
    x, y = iv.s_atom("param:x"), iv.s_atom("param:y")
    assert iv.s_add(iv.s_add(x, iv.s_const(1)),
                    iv.s_mul(iv.s_const(-1), x)) == iv.s_const(1)
    assert iv.s_mul(x, y) == iv.s_mul(y, x)
    assert iv.s_add(x, y) == iv.s_add(y, x)


def _finding_sets():
    base = [("r", "src/a.py", 3, "boom"), ("r", "src/a.py", 99, "boom"),
            ("r", "src/a.py", 7, "boom"), ("q", "src/b.py", 1, "other"),
            ("overflow-range", "src/c.py", 12, "too big")]
    entries = [{"rule": "r", "path": "src/a.py", "message": "boom"},
               {"rule": "ghost", "path": "src/x.py", "message": "gone"},
               {"rule": "q", "path": "src/b.py", "message": "other"}]
    for k in range(len(base) + 1):
        for picked in itertools.combinations(base, k):
            for e in range(len(entries) + 1):
                yield list(picked), entries[:e]


def test_parity_baseline_diff():
    n = 0
    for picked, entries in _finding_sets():
        mine = baseline_mod.diff(Report([Finding(*f) for f in picked], 1),
                                 entries)
        ref = ref_baseline.diff(
            RefReport([RefFinding(*f) for f in picked], 1), entries)
        assert [f.to_dict() for f in mine.new] == \
            [f.to_dict() for f in ref.new]
        assert mine.stale == ref.stale and mine.ok() == ref.ok()
        n += 1
    assert n == 32 * 4


def test_parity_sarif():
    rows = [("overflow-range", "src/a.py", 12, "too big", "guard it", False),
            ("cache-key", "src/b.py", 3, "knob", "", True),
            ("rng-discipline", "src/c.py", 0, "seed", "thread a gen", False)]
    docs = {"overflow-range": "doc", "cache-key": "doc2", "extra": "d3"}
    mine = to_sarif(Report([Finding(*r) for r in rows], 3), docs)
    ref = ref_to_sarif(RefReport([RefFinding(*r) for r in rows], 3), docs)
    assert mine == ref


def _index(mod, ctx_cls, root: Path):
    files = []
    for p in sorted((root / "src").rglob("*.py")):
        src = p.read_text()
        files.append(ctx_cls(p, p.relative_to(root).as_posix(), src,
                             ast.parse(src), src.splitlines()))
    return mod.ProjectIndex(files)


def test_parity_module_index_and_call_graph():
    mine = _index(modules, FileContext, REF_FIXTURES)
    ref = _index(ref_modules, RefFileContext, REF_FIXTURES)
    assert sorted(mine.modules) == sorted(ref.modules)
    assert sorted(mine.by_rel) == sorted(ref.by_rel)
    fqns = []
    for name, mi in mine.modules.items():
        ri = ref.modules[name]
        assert (mi.name, mi.is_package, mi.package) == \
            (ri.name, ri.is_package, ri.package)
        assert mi.imports == ri.imports
        assert sorted(mi.functions) == sorted(ri.functions)
        assert sorted(mi.classes) == sorted(ri.classes)
        assert {k: ast.dump(v) for k, v in mi.constants.items()} == \
            {k: ast.dump(v) for k, v in ri.constants.items()}
        for local in [*mi.functions, *mi.imports, *mi.constants,
                      "np.zeros", "jax.jit", "nope"]:
            assert mine.resolve(mi, local) == ref.resolve(ri, local)
        fqns += [f"{name}.{f}" for f in mi.functions]
    assert fqns
    g, rg = callgraph.CallGraph(mine), ref_callgraph.CallGraph(ref)
    for fqn in fqns:
        assert g.callees(fqn) == rg.callees(fqn), fqn
        assert g.reachable([fqn]) == rg.reachable([fqn])
        assert g.reachable([fqn], max_depth=1, stop={fqns[0]}) == \
            rg.reachable([fqn], max_depth=1, stop={fqns[0]})
        lo, lf = mine.lookup_function(fqn)
        ro, rf = ref.lookup_function(fqn)
        assert (lo.name, ast.dump(lf)) == (ro.name, ast.dump(rf))


def test_parity_module_name_and_dotted():
    for rel in ("src/repro/core/backend.py", "src/repro_torch/__init__.py",
                "benchmarks/run.py", "pkg/__init__.py", "a.py", "src/x/y/z.py"):
        assert modules.module_name_for(rel) == ref_modules.module_name_for(rel)
    for text in ("np.random.seed", "a", "f(x).y", "a.b.c.d", "x[0].y"):
        node = ast.parse(text, mode="eval").body
        assert modules.dotted(node) == ref_modules.dotted(node)


def test_knob_reads_widened_to_any_environment_read():
    """The reference counts only REPRO_* keys; the port any read."""
    src = ("import os\n"
           "def f():\n"
           "    a = os.environ['REPRO_X']\n"
           "    b = os.environ.get('CUDA_HOME')\n"
           "    c = os.getenv('HOME')\n")
    root = Path("/fixture")
    for mod, ctx_cls, cg, want in (
            (modules, FileContext, callgraph, ["REPRO_X", "CUDA_HOME",
                                               "HOME"]),
            (ref_modules, RefFileContext, ref_callgraph, ["REPRO_X"])):
        ctx = ctx_cls(root / "src/m.py", "src/m.py", src, ast.parse(src),
                      src.splitlines())
        index = mod.ProjectIndex([ctx])
        mi = index.modules["m"]
        reads = cg.find_knob_reads(mi.functions["f"], mi, index)
        assert [r.name for r in reads] == want
