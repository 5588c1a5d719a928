"""The port's contract checker (``repro_torch.analysis``): a failing and a
passing fixture for each of its ten rules, keyed to the port's paths and
idiom (relative kernel imports, torch's global generator and staging
calls, raising int32 guards), pragma semantics, the live registries, the
CLI, and the self-scan contract that ``src/repro_torch`` is clean under
--strict with an empty ``analysis_baseline_torch.json``."""
from __future__ import annotations

import json
import textwrap
from pathlib import Path

import pytest

from repro_torch.analysis import names, scan_paths
from repro_torch.analysis.__main__ import main
from repro_torch.analysis.rules import overflow_range

REPO = Path(__file__).resolve().parents[1]
RULES = ("backend-dispatch", "cache-key", "frozen-core-types", "jit-purity",
         "overflow-guard", "overflow-range", "pragma-discipline",
         "registry-consistency", "rng-discipline", "tracer-taint")


def write(tmp_path: Path, rel: str, text: str) -> Path:
    p = tmp_path / rel
    p.parent.mkdir(parents=True, exist_ok=True)
    p.write_text(textwrap.dedent(text))
    return p


def rule_findings(tmp_path: Path, rule: str):
    rep = scan_paths([tmp_path], root=tmp_path, project=False)
    return [f for f in rep.findings if f.rule == rule and not f.suppressed]


def assert_cli_flags(tmp_path: Path, rule: str, capsys) -> None:
    """The CLI itself (not just the library) must flag the fixture."""
    rc = main([str(tmp_path), "--root", str(tmp_path), "--strict"])
    out = capsys.readouterr().out
    assert rc == 1
    assert rule in out


# ---------------------------------------------------------------------------
# rng-discipline
# ---------------------------------------------------------------------------

def test_rng_discipline_failing_fixture(tmp_path, capsys):
    write(tmp_path, "src/repro_torch/core/rngbad.py", """
        import numpy as np
        import random
        import torch

        np.random.seed(0)
        x = np.random.rand(3)
        rng = np.random.default_rng()
        y = random.choice([1, 2])
        torch.manual_seed(0)
        torch.cuda.manual_seed_all(0)
        w = torch.randn(3, 4)
        i = torch.randint(0, 5, (3,))
        p = torch.randperm(7)
        w.normal_(0.0, 1.0)
        w.uniform_()
    """)
    found = rule_findings(tmp_path, "rng-discipline")
    msgs = " | ".join(f.message for f in found)
    assert len(found) == 11
    assert "np.random.seed" in msgs and "without a seed" in msgs
    assert "stdlib" in msgs and "torch.manual_seed" in msgs
    assert "torch.cuda.manual_seed_all" in msgs
    for draw in ("torch.randn", "torch.randint", "torch.randperm",
                 ".normal_", ".uniform_"):
        assert draw in msgs, draw
    assert_cli_flags(tmp_path, "rng-discipline", capsys)


def test_rng_discipline_passing_fixture(tmp_path):
    write(tmp_path, "src/repro_torch/models/rngok.py", """
        import numpy as np
        import torch

        def build(seed=0, rng=None, device="cpu"):
            rng = np.random.default_rng(seed) if rng is None else rng
            gen = torch.Generator(device=device).manual_seed(seed)
            w = torch.randn((3, 4), generator=gen)
            w.normal_(0.0, 1.0, generator=gen)
            random = object()   # local name shadows nothing imported
            return rng.normal(), w, random
    """)
    # tests/ is exempt even with global draws
    write(tmp_path, "tests/test_x.py", """
        import torch
        torch.manual_seed(0)
        x = torch.randn(3)
    """)
    assert rule_findings(tmp_path, "rng-discipline") == []


# ---------------------------------------------------------------------------
# backend-dispatch
# ---------------------------------------------------------------------------

def test_backend_dispatch_failing_fixture(tmp_path, capsys):
    write(tmp_path, "src/repro_torch/models/bad.py", """
        from ..kernels.flash_attention import flash_attention
        from ..kernels.ssd_scan.ref import ssd_ref
        from ..kernels import load_kernel, resolve_device
        from .. import kernels
        import repro_torch.kernels.bna_step.ops
    """)
    found = rule_findings(tmp_path, "backend-dispatch")
    msgs = [f.message for f in found]
    assert len(found) == 5
    # relative imports resolved against the file's package
    assert "repro_torch.kernels.flash_attention" in msgs[0]
    assert "repro_torch.kernels.ssd_scan.ref" in msgs[1]
    # the build helper is flagged, resolve_device let through
    assert "load_kernel" in msgs[2] and "resolve_device" not in msgs[2]
    assert_cli_flags(tmp_path, "backend-dispatch", capsys)


def test_backend_dispatch_passing_fixture(tmp_path):
    write(tmp_path, "src/repro_torch/core/engine.py", """
        from ..kernels import resolve_device
    """)
    write(tmp_path, "src/repro_torch/core/backend.py", """
        from ..kernels.merge_fix.ops import merge_fix_step
    """)
    write(tmp_path, "src/repro_torch/core/pipeline.py", """
        from ..kernels.bna_decompose import bna_decompose
    """)
    write(tmp_path, "src/repro_torch/kernels/k/ops.py", """
        from .. import load_kernel
        from ..coflow_merge.ops import carry_words
    """)
    write(tmp_path, "tests/test_y.py", """
        from repro_torch.kernels.bna_step.ops import bna_step
    """)
    write(tmp_path, "src/repro_torch/models/ok.py", """
        # repro: allow(backend-dispatch): the NN stack's own kernel, dispatched by device
        from ..kernels.flash_attention import flash_attention
    """)
    assert rule_findings(tmp_path, "backend-dispatch") == []


# ---------------------------------------------------------------------------
# overflow-guard
# ---------------------------------------------------------------------------

def test_overflow_guard_failing_fixture(tmp_path, capsys):
    write(tmp_path, "src/repro_torch/kernels/k/ops.py", """
        def launch(x):
            return x
    """)
    found = rule_findings(tmp_path, "overflow-guard")
    assert len(found) == 1 and "no int32 overflow guard" in found[0].message
    assert_cli_flags(tmp_path, "overflow-guard", capsys)


def test_overflow_guard_rejects_plain_fallback(tmp_path):
    """The reference accepts an escape to its ref module; the port may not:
    a CUDA tensor past the int32 range must raise."""
    write(tmp_path, "src/repro_torch/kernels/k/ops.py", """
        from .ref import k_ref

        _I32_MAX = 2**31 - 1

        def launch(x):
            if x.numel() > _I32_MAX:
                return k_ref(x)
            return x
    """)
    found = rule_findings(tmp_path, "overflow-guard")
    msgs = " | ".join(f.message for f in found)
    assert len(found) == 2
    assert "falls back to the plain version" in msgs
    assert "no int32 overflow guard that raises" in msgs


def test_overflow_guard_passing_fixtures(tmp_path):
    write(tmp_path, "src/repro_torch/kernels/a/ops.py", """
        _I32_MAX = 2**31 - 1

        def launch(B, w):
            if max(B, w) > _I32_MAX:
                raise ValueError("extents past the int arguments")
            return B
    """)
    write(tmp_path, "src/repro_torch/kernels/b/ops.py", """
        import numpy as np
        from .ref import b_ref

        def launch(x, dev):
            if x.numel() >= np.iinfo(np.int32).max:
                raise ValueError("too big")
            if dev == "cpu":
                return b_ref(x)     # dispatch by device, not a guard
            return x
    """)
    # files that are not a kernel's ops.py are not held to it
    write(tmp_path, "src/repro_torch/kernels/c/ref.py", "def f(): pass\n")
    assert rule_findings(tmp_path, "overflow-guard") == []


# ---------------------------------------------------------------------------
# jit-purity
# ---------------------------------------------------------------------------

def test_jit_purity_failing_fixture(tmp_path, capsys):
    write(tmp_path, "src/repro_torch/models/staged_bad.py", """
        import numpy as np
        import torch

        counter = [0]

        @torch.compile
        def step(x, flag):
            y = np.asarray(x)
            print(x)
            counter[0] = 1
            if flag:
                return x
            return x + 1

        def body(x):
            global counter
            return x

        staged = torch.func.vmap(body)

        def capture(g, x):
            with torch.cuda.graph(g):
                y = x * np.float32(2)
            return y
    """)
    found = rule_findings(tmp_path, "jit-purity")
    msgs = " | ".join(f.message for f in found)
    assert "host numpy" in msgs and "print()" in msgs
    assert "closed-over state (counter)" in msgs
    assert "truthiness of traced argument 'flag'" in msgs
    assert "declares global counter" in msgs
    assert "<graph capture>() is staged into torch.cuda.graph" in msgs
    assert len(found) == 6
    assert_cli_flags(tmp_path, "jit-purity", capsys)


def test_jit_purity_passing_fixture(tmp_path):
    write(tmp_path, "src/repro_torch/models/staged_ok.py", """
        import numpy as np
        import torch

        @torch.compile(mode="max-autotune")
        def step(x, scale: float):
            big = np.iinfo(np.int32).max     # a trace-time constant
            y = torch.where(x > 0, x, -x)
            acc = []
            acc.append(y)
            return acc[0] * scale + big

        def unstaged(x):
            print(np.asarray(x))            # not staged: host code is fine
            return x
    """)
    assert rule_findings(tmp_path, "jit-purity") == []


# ---------------------------------------------------------------------------
# frozen-core-types
# ---------------------------------------------------------------------------

def test_frozen_core_types_failing_fixture(tmp_path, capsys):
    write(tmp_path, "src/repro_torch/serve/mutate.py", """
        from repro_torch.core.types import Instance
        from repro_torch.core.result import Transcript

        def f(inst: Instance, tr: Transcript):
            inst.jobs.append(None)
            inst.m = 3
            tr.entries.sort()
            del inst.jobs[0]
    """)
    found = rule_findings(tmp_path, "frozen-core-types")
    assert len(found) == 4
    assert {f.message.split()[-1] for f in found} == {"'inst'", "'tr'"}
    assert_cli_flags(tmp_path, "frozen-core-types", capsys)


def test_frozen_core_types_passing_fixture(tmp_path):
    # the defining module owns its in-place construction
    write(tmp_path, "src/repro_torch/core/timeline.py", """
        class FinalSchedule:
            pass

        def build(sched: FinalSchedule):
            sched.ledger.append(1)
            sched.device = "cpu"
    """)
    write(tmp_path, "src/repro_torch/serve/ok.py", """
        import dataclasses
        from repro_torch.core.types import Instance

        def f(inst: Instance):
            jobs = list(inst.jobs)
            jobs.append(None)
            return dataclasses.replace(inst, jobs=jobs)
    """)
    assert rule_findings(tmp_path, "frozen-core-types") == []


# ---------------------------------------------------------------------------
# pragma-discipline
# ---------------------------------------------------------------------------

def test_pragma_suppresses_with_justification(tmp_path):
    write(tmp_path, "src/repro_torch/serve/x.py", """
        # repro: allow(backend-dispatch): this IS the resolved dispatch site
        from ..kernels.bna_step.ops import bna_step
    """)
    rep = scan_paths([tmp_path], root=tmp_path, project=False)
    assert [f.rule for f in rep.unsuppressed] == []
    assert [f.rule for f in rep.suppressed] == ["backend-dispatch"]
    assert main([str(tmp_path), "--root", str(tmp_path), "--strict"]) == 0


def test_pragma_without_justification_suppresses_nothing(tmp_path, capsys):
    write(tmp_path, "src/repro_torch/serve/x.py", """
        from ..kernels.bna_step.ops import bna_step  # repro: allow(backend-dispatch)
    """)
    rep = scan_paths([tmp_path], root=tmp_path, project=False)
    rules = sorted(f.rule for f in rep.unsuppressed)
    assert rules == ["backend-dispatch", "pragma-discipline"]
    assert_cli_flags(tmp_path, "pragma-discipline", capsys)


def test_pragma_unknown_rule_flagged(tmp_path):
    write(tmp_path, "src/repro_torch/serve/x.py", """
        x = 1  # repro: allow(no-such-rule): because reasons are required
    """)
    rep = scan_paths([tmp_path], root=tmp_path, project=False)
    msgs = [f.message for f in rep.unsuppressed]
    assert len(msgs) == 1 and "unknown rule 'no-such-rule'" in msgs[0]


def test_port_pragmas_name_rules_both_checkers_know():
    """The reference's self-scan covers src/repro_torch, so every pragma of
    the port names one of the ten ids both registries hold."""
    from repro.analysis import names as ref_names
    from repro_torch.analysis.pragmas import iter_pragmas
    shared = set(ref_names()) & set(names())
    assert shared == set(RULES)
    seen = 0
    for path in sorted((REPO / "src" / "repro_torch").rglob("*.py")):
        for p in iter_pragmas(path.read_text()):
            seen += 1
            assert set(p.rules) <= shared, (path, p)
            assert len(p.justification) >= 8, (path, p)
    assert seen >= 4      # the kernel imports of layers, ssm and matching


# ---------------------------------------------------------------------------
# registry-consistency (live registries)
# ---------------------------------------------------------------------------

def _registry_findings(tmp_path):
    return scan_paths([tmp_path], root=tmp_path,
                      rules=["registry-consistency"], project=True).findings


def test_registry_consistency_clean_on_real_registries(tmp_path):
    write(tmp_path, "a.py", "x = 1\n")
    assert _registry_findings(tmp_path) == []


def test_registry_consistency_flags_scheduler_drift(tmp_path, monkeypatch):
    from repro_torch.core import engine

    def factory(instance, *, device, plan_backend, beta=2.0, **opts):
        return engine._REGISTRY["gdm"].factory(
            instance, device=device, plan_backend=plan_backend, **opts)

    monkeypatch.setitem(engine._REGISTRY, "drifty", engine._Entry(
        factory, "fixture", ("beta", "phantom_opt")))
    write(tmp_path, "a.py", "x = 1\n")
    msgs = [f.message for f in _registry_findings(tmp_path)]
    assert any("drifty" in m and "phantom_opt" in m for m in msgs)
    # device and plan_backend are the registry's own keywords
    assert not any("drifty" in m and "device" in m for m in msgs)


def test_registry_consistency_flags_scenario_drift(tmp_path, monkeypatch):
    from repro_torch.scenarios import registry as sreg

    def builder(m=None, seed=0):            # no `scale` keyword
        raise RuntimeError("never built")

    monkeypatch.setitem(sreg._REGISTRY, "drifty_scenario",
                        sreg.Scenario("drifty_scenario", "fixture", builder))
    write(tmp_path, "a.py", "x = 1\n")
    msgs = [f.message for f in _registry_findings(tmp_path)]
    assert any("drifty_scenario" in m and "'scale'" in m for m in msgs)
    assert any("drifty_scenario" in m and "raised" in m for m in msgs)


# ---------------------------------------------------------------------------
# overflow-range (tmp fixtures; the corpus is in test_torch_analysis_flow.py)
# ---------------------------------------------------------------------------

def _kernel_pkg(tmp_path, ops: str):
    write(tmp_path, "src/repro_torch/kernels/__init__.py", """
        def load_kernel(name):
            raise RuntimeError(name)
    """)
    write(tmp_path, "src/repro_torch/kernels/k/__init__.py", "")
    write(tmp_path, "src/repro_torch/kernels/k/ops.py", ops)


def test_overflow_range_unguarded_operand(tmp_path, monkeypatch):
    monkeypatch.setitem(overflow_range.INT32_INDEXED, ("k", "k_launch"),
                        ((0,), "fixture k.cu:1"))
    _kernel_pkg(tmp_path, """
        import ctypes
        from .. import load_kernel

        _I32_MAX = 2**31 - 1

        def launch(x, y):
            B, W = x.shape
            if max(B, W) > _I32_MAX:
                raise ValueError("extents")
            fn = load_kernel("k").k_launch
            fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int]
            return fn(x.data_ptr(), B, W)
    """)
    found = rule_findings(tmp_path, "overflow-range")
    assert len(found) == 1
    # each extent fits, their product (the operand's elements) does not
    assert "operand 0 of k_launch()" in found[0].message
    assert "x.shape[0] * x.shape[1]" in found[0].message
    assert "fixture k.cu:1" in found[0].message


def test_overflow_range_needs_a_row_and_argtypes(tmp_path):
    _kernel_pkg(tmp_path, """
        import ctypes
        from .. import load_kernel

        def launch(x):
            lib = load_kernel("k")
            lib.k_other(x.data_ptr())
            fn = lib.k_launch
            fn.argtypes = [ctypes.c_void_p, ctypes.c_int]
            return fn(x.data_ptr(), 1, 2)
    """)
    msgs = [f.message for f in rule_findings(tmp_path, "overflow-range")]
    assert any("no readable argtypes" in m and "k_other" in m for m in msgs)
    assert any("gets 3 arguments, its argtypes declare 2" in m
               for m in msgs)


def test_overflow_range_rows_cover_every_port_entry():
    """Every entry the port launches has a row citing its CUDA source, and
    each cited file exists and declares the entry at the cited line."""
    kernels = REPO / "src" / "repro_torch" / "kernels"
    for (kernel, entry), (_pos, cite) in overflow_range.INT32_INDEXED.items():
        rel, line = cite.split(";")[0].split(":")
        src = (kernels / rel).read_text().splitlines()
        assert rel.startswith(f"{kernel}/csrc/"), (entry, rel)
        assert f"{entry}(" in src[int(line) - 1], (entry, cite)


# ---------------------------------------------------------------------------
# CLI surface + self-scan
# ---------------------------------------------------------------------------

def test_cli_list_rules(capsys):
    assert main(["--list-rules"]) == 0
    out = capsys.readouterr().out
    listed = [line.split()[0] for line in out.splitlines() if line.strip()]
    assert tuple(sorted(listed)) == RULES
    assert tuple(names()) == RULES


def test_cli_non_strict_exits_zero_on_findings(tmp_path, capsys):
    write(tmp_path, "src/repro_torch/serve/bad.py",
          "from ..kernels.bna_step.ops import x\n")
    assert main([str(tmp_path), "--root", str(tmp_path)]) == 0
    assert "backend-dispatch" in capsys.readouterr().out


def test_port_baseline_is_empty():
    data = json.loads((REPO / "analysis_baseline_torch.json").read_text())
    assert data == {"version": 1, "findings": []}


def test_self_scan_port_is_clean_under_strict(capsys):
    rc = main([str(REPO / "src" / "repro_torch"), "--root", str(REPO),
               "--strict"])
    out = capsys.readouterr().out
    assert rc == 0, f"port not clean under --strict:\n{out}"
    assert "0 finding(s)" in out


@pytest.mark.parametrize("rule", RULES)
def test_self_scan_each_rule_has_no_finding(rule):
    rep = scan_paths([REPO / "src" / "repro_torch"], root=REPO,
                     rules=[rule])
    assert rep.unsuppressed == [], [f.render() for f in rep.unsuppressed]


def test_port_launch_argtypes_match_the_cuda_signatures():
    """Every launch site overflow-range resolves on the port declares, for
    each entry it may call, the ctypes types of the entry's ``extern "C"``
    parameters, in order — and every entry the tables name is launched."""
    kernels = REPO / "src" / "repro_torch" / "kernels"
    sites = overflow_range.resolve_launches([kernels], REPO)
    launched = set()
    for site in sites:
        for entry in site.entries:
            _pos, cite = overflow_range.INT32_INDEXED[(site.kernel, entry)]
            cu = (kernels / cite.split(":")[0]).read_text()
            assert list(site.argtypes) == \
                overflow_range.c_signature(cu, entry), (site, entry)
            launched.add(entry)
    # the bna_step library's empty kernel is launched by chip_smoke alone
    named = {e for _k, e in overflow_range.INT32_INDEXED}
    assert named - launched == {"bna_step_empty_launch"}
    assert len(sites) == 13
