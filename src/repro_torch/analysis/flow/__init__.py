"""repro_torch.analysis.flow — whole-program dataflow for the contract checker.

The syntactic rules in :mod:`repro_torch.analysis.rules` look at one file
at a time, pattern-matching for the *presence* of a guard or a pragma.
This package adds the semantic layer underneath them — module/symbol
resolution, a call graph, an integer-interval abstract interpreter with
symbolic shapes, and an interprocedural tracer-taint engine — so rules
can prove a guard *sufficient* rather than merely present.

Writing a dataflow rule
=======================

1. **Declare program scope.**  Register with ``scope="program"``; the
   check receives a :class:`repro_torch.analysis.ProgramContext` holding every
   scanned :class:`~repro_torch.analysis.FileContext` plus a lazily-built
   :class:`~repro_torch.analysis.flow.modules.ProjectIndex`::

       from . import register_rule

       def check(program):
           index = program.index          # ProjectIndex
           for ctx in program.files:      # all FileContexts
               ...
               yield ctx.finding("my-rule", node, "message", hint="...")

       register_rule("my-rule", "one-line doc", check, scope="program")

2. **Resolve symbols through the index.**  ``index.resolve(mi, "F.pad")``
   expands import aliases and chases re-exports to an absolute dotted
   name; ``index.lookup_function(fqn)`` returns the defining
   ``(ModuleInfo, ast.FunctionDef)`` so callee bodies can be analyzed
   under *their own* module's imports — the core of interprocedural
   precision.

3. **Pick an engine.**

   * *Value ranges / shapes*: :class:`~repro_torch.analysis.flow.intervals.FlowInterp`
     walks one function path-sensitively (forking at ``if``, no joins up
     to a path cap), tracking an :class:`~repro_torch.analysis.flow.intervals.IV`
     interval **and** a canonical symbolic expression per local, and
     symbolic dimension tuples per array.  Pass ``on_call`` to hook every
     call site — that is where the overflow rule discharges its
     "element count <= 2**31-1" obligation via
     :func:`~repro_torch.analysis.flow.intervals.prove_count` (pure interval
     bound, refined count expression, or factor-multiset cover of a
     guard-recorded product bound) and :func:`~repro_torch.analysis.flow.
     intervals.prove_int` its "value fits a C int" one.
   * *Taint*: :class:`~repro_torch.analysis.flow.taint.TaintAnalyzer` seeds a
     staged function's parameters as traced values, propagates through locals
     and into project callees (memoized, depth-limited), and reports
     Python control flow / materialization / host effects on tainted
     values at their source line.
   * *Reachability*: :class:`~repro_torch.analysis.flow.callgraph.CallGraph`
     gives resolved callee FQNs and a bounded-BFS ``reachable`` with a
     ``stop`` set for certified-neutral helpers;
     :func:`~repro_torch.analysis.flow.callgraph.find_knob_reads` scans a body
     for environment reads and ``config.<attr>`` reads — the
     cache-key rule's "hidden input" detector.

4. **Fail toward reporting.**  Anything outside the abstract domain must
   evaluate to an *unknown* that blocks proofs, never to a value that
   completes one.  A dataflow rule that cannot prove safety emits a
   finding with the unproven expression in the message and a concrete
   fix in ``hint=``.

5. **Pragma policy.**  False positives are suppressed at the line (or the
   line above) with a ``repro: allow(rule-name): justification`` comment
   (leading hash) — the
   justification is mandatory and should say *why the proof obligation is
   met by other means* (e.g. "key is derived from the same params that
   select the builder").  Never pragma a true finding; fix it.

6. **Baseline workflow.**  ``python -m repro_torch.analysis --strict`` fails on
   any unsuppressed finding not recorded in
   ``analysis_baseline_torch.json``
   (matched on rule + path + message, line-insensitive) *and* on baseline
   entries that no longer reproduce, so the baseline only ever shrinks.
   After fixing findings, refresh with ``--update-baseline``; the port's
   baseline is empty and its tests keep it so.
"""
from .callgraph import CallGraph, KnobRead, find_knob_reads
from .intervals import (AVal, Env, FlowInterp, I32_MAX, IV, SVal,
                        count_expr_str, prove_count, prove_int)
from .modules import ModuleInfo, ProjectIndex, module_name_for
from .taint import TaintAnalyzer, TaintFinding

__all__ = [
    "AVal", "CallGraph", "Env", "FlowInterp", "I32_MAX", "IV", "KnobRead",
    "ModuleInfo", "ProjectIndex", "SVal", "TaintAnalyzer", "TaintFinding",
    "count_expr_str", "find_knob_reads", "module_name_for", "prove_count",
    "prove_int",
]
