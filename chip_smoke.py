#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port (src/repro_torch) on one NVIDIA card.

    python3 chip_smoke.py

Phases; any failure exits non-zero and prints no result line:

1. Build the four kernels from the sources in the checkout (one ``nvcc``
   per source, started together) and print ``-Xptxas -v``'s registers and
   shared memory per kernel.
2. Hold ``bna_step`` against its plain PyTorch version on the card, for
   exact equality, on random states (B in {1, 37, 256}, w in {1, 8, 64,
   256}, drained matrices included); and ``bna_decompose`` on random
   buckets (w in {1, 2, 8, 64, 256}: all-zero lanes, sparse support,
   lanes of one step, stacks stored short so the wrapper relaunches).
3. Python plan path, checked: gdm at the main path's size with every
   ``bna_step`` launch held against the plain version on a clone of the
   same state and every ``coflow_merge`` call against the plain version on
   the same deltas; then ``coflow_merge`` on a synthetic K ~ 1e5.
4. Pipeline plan path, checked: gdm with every ``bna_decompose`` bucket
   (the workload's real buckets, w up to 256) and every ``merge_fix``
   merge held against the plain versions on the same inputs; then
   ``merge_fix`` on random edge sets and a synthetic K ~ 1.2e5.
5. The main path: ``paper_workload(m=150, mu_bar=5, seed=0, scale=0.25)``
   (67 coflows) planned with gdm and om_alg, and with gdm_rt on the
   ``rooted=True`` workload at scale 0.1 (27 coflows), each with the
   launch counters set to 0 just before and read just after:
   a. through the python path on the card (``bna_step``, host repair,
      ``coflow_merge``), equal bit for bit to the same plan on the CPU;
   b. through the pipeline on the card (``bna_decompose``, ``merge_fix``),
      equal bit for bit to the python-path plan of (a), with 0 host
      repairs and 0 int32-overflow buckets.
   Each plan must be feasible under the port's simulator and must have
   launched its path's kernels.  gdm is also planned through the python
   path with the caches off (no prefetch), where every coflow must still
   go through ``bna_step``; a few coflows are checked against the scalar
   BNA.
6. gdm and om_alg at ``scale=1.0`` (the paper's 267 coflows) through the
   pipeline on the card: feasible, 0 host repairs, 0 overflow buckets.
7. Time each kernel at the largest shapes the main path gave it (CUDA
   events for the asynchronous ones; host clock around the call for
   ``bna_decompose``, whose wrapper reads the step counts back), beside
   its plain version and its bound (bytes moved over the card's
   3.35 TB/s), and print the ``kernels`` line, the plan wall times and
   counts, and the card's name and power limit.  The last line is the
   result line.

The full record also goes to ``chiprun_out/chip_smoke.json``.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12           # H100 SXM device memory rate
# gdm_rt at 0.25 spends minutes in the host fix-up BNA (timeline._decompose
# on 150 x 150 merged matrices) on each of its runs, so the time limit cuts
# it to 0.1; gdm and om_alg keep 0.25
SCALES = {"gdm": 0.25, "gdm_rt": 0.1, "om_alg": 0.25}
FULL_SCALE = ("gdm", "om_alg")      # planned at scale 1.0 on the pipeline
KERNELS = ("bna_step", "coflow_merge", "bna_decompose", "merge_fix")


def _fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def _cuda_ms(fn, reps: int = 50, rounds: int = 7) -> float:
    """Median device time of one fn() in ms: a sleep kernel holds the
    stream while the host enqueues `reps` calls, so the events bracket
    back-to-back device work, not the host's launch overhead (a call that
    synchronises inside measures its wall time instead)."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(rounds):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(50_000_000)
        a.record()
        for _ in range(reps):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / reps)
    return statistics.median(times)


def _wall_ms(fn, rounds: int = 3) -> float:
    """Median host-clock time of fn() in ms, each ending in a sync (for a
    call that synchronises inside)."""
    import torch

    times = []
    for _ in range(rounds):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch import kernels
    from repro_torch.core import (backend, bna, bna_many, cache_stats,
                                  clear_caches, matching, no_caches,
                                  paper_workload, pipeline, plan,
                                  transcript_to_arrays, verify_schedule,
                                  verify_transcript)
    from repro_torch.kernels.bna_decompose import bna_decompose
    from repro_torch.kernels.bna_decompose.ref import bna_decompose_ref
    from repro_torch.kernels.bna_step import bna_step, stage_int32
    from repro_torch.kernels.bna_step.ref import bna_step_ref
    from repro_torch.kernels.coflow_merge import coflow_merge
    from repro_torch.kernels.coflow_merge.ref import alphas_ref, build_delta
    from repro_torch.kernels.merge_fix import merge_fix
    from repro_torch.kernels.merge_fix.ref import merge_fix_ref

    dev = torch.device("cuda")
    wrappers = {"bna_step": bna_step, "coflow_merge": coflow_merge,
                "bna_decompose": bna_decompose, "merge_fix": merge_fix}
    record: dict = {"device": torch.cuda.get_device_name(0)}
    t_start = time.perf_counter()

    def zero_counts() -> None:
        for fn in wrappers.values():
            fn.launches = 0

    def read_counts() -> dict:
        return {name: fn.launches for name, fn in wrappers.items()}

    # 1. build --------------------------------------------------------------
    t0 = time.perf_counter()
    reports = kernels.build_kernels(list(KERNELS))
    record["build_s"] = time.perf_counter() - t0
    print(f"build: {record['build_s']:.2f} s, sm_90a, into {kernels.BUILD_DIR}")
    for name, log in reports.items():
        for line in log.splitlines():
            if "registers" in line or "Compiling entry" in line \
                    or "spill" in line:
                print(f"  ptxas[{name}]: {line.strip()}")

    # largest |kernel - plain| over every comparison made in this run, the
    # kernels' outputs and the states they update in place included
    max_err = {name: 0 for name in KERNELS}
    checked = {name: 0 for name in KERNELS}

    def abs_err(pairs) -> int:
        return max((int((x.long() - y.long()).abs().max()) if x.numel()
                    else 0 for x, y in pairs), default=0)

    def note(name: str, err: int, what: str) -> None:
        max_err[name] = max(max_err[name], err)
        checked[name] += 1
        if err:
            _fail(f"{name} != plain version on {what} (max |diff| {err})")

    # 2. bna_step on random states, bna_decompose on random buckets ----------
    def random_state(rng, B, w):
        d = rng.integers(0, 40, size=(B, w, w))
        d[rng.random((B, w, w)) > 0.6] = 0
        d[0] = 0                                   # a drained matrix
        row, col = d.sum(axis=2), d.sum(axis=1)
        D = np.maximum(row.max(axis=1), col.max(axis=1))
        match = np.full((B, w), -1, dtype=np.int64)
        for i in range(B):
            perm = rng.permutation(w)
            keep = rng.random(w) < 0.8
            match[i, keep] = perm[keep]
        match[0] = -1
        return d, row, col, D, match

    def step_err(state_dev) -> int:
        ref_in = [x.clone() for x in state_dev]
        got = bna_step(*state_dev)
        want = bna_step_ref(*ref_in)
        return abs_err([(got, want), *zip(state_dev, ref_in)])

    rng = np.random.default_rng(0)
    for B in (1, 37, 256):
        for w in (1, 8, 64, 256):
            state = stage_int32(*random_state(rng, B, w), dev)
            note("bna_step", step_err(list(state)),
                 f"a random state (B={B}, w={w})")
    n_step_random = checked["bna_step"]
    torch.cuda.synchronize()
    print(f"bna_step: equal to the plain version on {n_step_random} random "
          f"states (B in 1/37/256, w in 1/8/64/256)")

    def random_bucket(rng, w, density):
        """Lanes: full width, random narrower widths, one lane of one step
        (a scaled permutation), and an all-zero lane."""
        B = 6 if w < 256 else 4
        d = np.zeros((B, w, w), np.int32)
        ks = np.zeros(B, np.int32)
        for b in range(B - 2):
            k = w if b == 0 else int(rng.integers(1, w + 1))
            x = rng.integers(0, 40, size=(k, k))
            x[rng.random((k, k)) > density] = 0
            d[b, :k, :k] = x
            ks[b] = k
        k = max(1, w // 2)
        d[B - 2, np.arange(k), rng.permutation(k)] = 7
        ks[B - 2] = k
        nnz = int((d > 0).sum(axis=(1, 2)).max())
        return (torch.from_numpy(d), torch.from_numpy(ks),
                1 << (nnz + 6 * w + 8 - 1).bit_length())

    def decompose_err(d, ks, T_cap, t_store=None) -> int:
        got = bna_decompose(d.to(dev), ks.to(dev), T_cap, t_store=t_store)
        want = bna_decompose_ref(d.to(dev), ks.to(dev), T_cap)
        if got[1].shape != want[1].shape:
            return 1 << 30
        return abs_err(zip(got, want))

    for w, density, t_store in ((1, 1.0, None), (2, 0.7, None),
                                (8, 0.5, 2), (64, 0.15, None),
                                (256, 0.01, 8)):
        d, ks, T_cap = random_bucket(rng, w, density)
        note("bna_decompose", decompose_err(d, ks, T_cap, t_store),
             f"a random bucket (w={w})")
    n_dec_random = checked["bna_decompose"]
    torch.cuda.synchronize()
    print(f"bna_decompose: equal to the plain version on {n_dec_random} "
          "random buckets (w in 1/2/8/64/256; zero, one-step and sparse "
          "lanes; short stores relaunched)")

    # 3. python path, both kernels checked at every call ---------------------
    largest = {name: None for name in KERNELS}
    orig_alphas = backend.edge_interval_alphas

    def checked_step(d, row, col, D, match):
        ref_in = [x.clone() for x in (d, row, col, D, match)]
        before = [x.clone() for x in (d, row, col, D, match)]
        out = bna_step(d, row, col, D, match)
        want = bna_step_ref(*ref_in)
        note("bna_step", abs_err([(out, want),
                                  *zip((d, row, col, D, match), ref_in)]),
             f"a main-path state (B={d.shape[0]}, w={d.shape[1]})")
        size = d.shape[0] * d.shape[1]
        if largest["bna_step"] is None or size > largest["bna_step"][0]:
            largest["bna_step"] = (size, before)
        return out

    def checked_alphas(events, t0, t1, s, r, m, *, device):
        got = orig_alphas(events, t0, t1, s, r, m, device=device)
        si = torch.as_tensor(np.searchsorted(events, t0), device=dev)
        ei = torch.as_tensor(np.searchsorted(events, t1), device=dev)
        delta = build_delta(si, ei, torch.as_tensor(s, device=dev),
                            torch.as_tensor(r, device=dev),
                            int(events.size) - 1, m)
        want = alphas_ref(delta).cpu().numpy()
        note("coflow_merge", int(np.abs(got - want).max(initial=0)),
             f"a main-path edge set (K={delta.shape[0]})")
        if largest["coflow_merge"] is None or \
                delta.numel() > largest["coflow_merge"].numel():
            largest["coflow_merge"] = delta
        return got

    inst = paper_workload(m=150, mu_bar=5, seed=0, scale=SCALES["gdm"])
    matching.bna_step, backend.edge_interval_alphas = \
        checked_step, checked_alphas
    try:
        clear_caches()
        t0 = time.perf_counter()
        plan(inst, "gdm", device="cuda", plan_backend="python", seed=0)
        torch.cuda.synchronize()
    finally:
        matching.bna_step, backend.edge_interval_alphas = \
            bna_step, orig_alphas
    if not (checked["bna_step"] > n_step_random and checked["coflow_merge"]):
        _fail(f"checked python-path run reached no kernel call: {checked}")
    print(f"checked python-path run (gdm): "
          f"{checked['bna_step'] - n_step_random} bna_step and "
          f"{checked['coflow_merge']} coflow_merge calls equal to the plain "
          f"versions ({time.perf_counter() - t0:.1f} s)")

    grng = np.random.default_rng(1)
    E, m_syn = 60_000, 150
    t0s = grng.integers(0, 10_000_000, E)
    t1s = t0s + grng.integers(1, 5_000, E)
    events = np.unique(np.concatenate([t0s, t1s]))
    s_syn, r_syn = grng.integers(0, m_syn, E), grng.integers(0, m_syn, E)
    si = torch.as_tensor(np.searchsorted(events, t0s), device=dev)
    ei = torch.as_tensor(np.searchsorted(events, t1s), device=dev)
    big = build_delta(si, ei, torch.as_tensor(s_syn, device=dev),
                      torch.as_tensor(r_syn, device=dev),
                      int(events.size) - 1, m_syn)
    note("coflow_merge", abs_err([(coflow_merge(big), alphas_ref(big))]),
         f"a synthetic edge set (K={big.shape[0]})")
    torch.cuda.synchronize()
    print(f"coflow_merge: equal to the plain version on a synthetic edge "
          f"set, K={big.shape[0]}, 2m={big.shape[1]}")

    # 4. pipeline path, both kernels checked at every call -------------------
    orig_decompose = pipeline.bna_decompose
    orig_merge_fix_step = backend.merge_fix_step

    def checked_decompose(d, ks, T_cap, t_store=None):
        got = orig_decompose(d, ks, T_cap, t_store=t_store)
        t1 = time.perf_counter()
        want = bna_decompose_ref(d, ks, T_cap)
        torch.cuda.synchronize()
        plain_s = time.perf_counter() - t1
        err = abs_err(zip(got, want)) if got[1].shape == want[1].shape \
            else 1 << 30
        note("bna_decompose", err,
             f"a main-path bucket (B={d.shape[0]}, w={d.shape[1]})")
        size = d.shape[0] * d.shape[1]
        if largest["bna_decompose"] is None or \
                size > largest["bna_decompose"][0]:
            largest["bna_decompose"] = (size, (d, ks, T_cap, t_store),
                                        plain_s * 1e3, got[3])
        return got

    def checked_merge_fix(events, t0, t1, s, r, m, *, device):
        got = orig_merge_fix_step(events, t0, t1, s, r, m, device=device)
        args = [torch.as_tensor(np.asarray(a, dtype=np.int64), device=dev)
                for a in (events, t0, t1, s, r)]
        want = merge_fix_ref(*args, m)
        note("merge_fix", abs_err([(torch.as_tensor(g), w.cpu())
                                   for g, w in zip(got, want)]),
             f"a main-path merge (K={args[0].numel() - 1})")
        if largest["merge_fix"] is None or \
                args[0].numel() > largest["merge_fix"][0][0].numel():
            largest["merge_fix"] = (args, m)
        return got

    pipeline.bna_decompose, backend.merge_fix_step = \
        checked_decompose, checked_merge_fix
    try:
        clear_caches()
        t0 = time.perf_counter()
        plan(inst, "gdm", device="cuda", plan_backend="pipeline", seed=0)
        torch.cuda.synchronize()
    finally:
        pipeline.bna_decompose, backend.merge_fix_step = \
            orig_decompose, orig_merge_fix_step
    if not (checked["bna_decompose"] > n_dec_random
            and checked["merge_fix"]):
        _fail(f"checked pipeline run reached no kernel call: {checked}")
    print(f"checked pipeline run (gdm): "
          f"{checked['bna_decompose'] - n_dec_random} bna_decompose buckets "
          f"(w up to {largest['bna_decompose'][1][0].shape[1]}) and "
          f"{checked['merge_fix']} merge_fix merges equal to the plain "
          f"versions ({time.perf_counter() - t0:.1f} s)")

    n_mf_path = checked["merge_fix"]
    for seed, (E_r, m_r) in enumerate(((1, 2), (400, 7), (20_000, 150))):
        rr = np.random.default_rng(10 + seed)
        t0r = rr.integers(0, 10**6, E_r)
        t1r = t0r + rr.integers(1, 5000, E_r)
        args = [torch.as_tensor(a, dtype=torch.int64, device=dev) for a in (
            np.unique(np.concatenate([t0r, t1r])), t0r, t1r,
            rr.integers(0, m_r, E_r), rr.integers(0, m_r, E_r))]
        note("merge_fix", abs_err(zip(merge_fix(*args, m_r),
                                      merge_fix_ref(*args, m_r))),
             f"a random edge set (E={E_r}, m={m_r})")
    syn_args = [torch.as_tensor(a, dtype=torch.int64, device=dev)
                for a in (events, t0s, t1s, s_syn, r_syn)]
    note("merge_fix", abs_err(zip(merge_fix(*syn_args, m_syn),
                                  merge_fix_ref(*syn_args, m_syn))),
         f"a synthetic edge set (K={events.size - 1})")
    torch.cuda.synchronize()
    print(f"merge_fix: equal to the plain version on "
          f"{checked['merge_fix'] - n_mf_path} random and synthetic edge "
          f"sets (K up to {events.size - 1}, 2m={2 * m_syn})")

    # 5. the main path: python path (card vs CPU), then the pipeline ---------
    def plans_equal(got, want) -> bool:
        a = transcript_to_arrays(got.transcript())
        b = transcript_to_arrays(want.transcript())
        return len(a) == len(b) and all(
            x[:4] == y[:4] and all(np.array_equal(u, v)
                                   for u, v in zip(x[4:], y[4:]))
            for x, y in zip(a, b)) and got.twct() == want.twct() \
            and got.job_completions() == want.job_completions()

    def timed_plan(inst, sched, plan_backend):
        clear_caches()
        zero_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = plan(inst, sched, device="cuda", plan_backend=plan_backend,
                   seed=0)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = read_counts()
        st = cache_stats()
        verify_schedule(inst, got.schedule)
        verify_transcript(inst, got.transcript())
        return got, wall, launches, st

    # host seconds inside the pipeline's stages, for the time breakdown
    stage_s: dict = {}

    def timed_stage(name, fn):
        def wrapped(*args, **kwargs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            torch.cuda.synchronize()
            stage_s[name] = stage_s.get(name, 0.0) + time.perf_counter() - t0
            return out
        return wrapped

    stages = {(pipeline, "bna_decompose"), (pipeline, "_steps_to_lists"),
              (pipeline, "_rle_batch"), (pipeline, "instance_load_vectors"),
              (backend, "merge_fix_step")}
    saved_stages = {(mod, name): getattr(mod, name) for mod, name in stages}

    def pipeline_plan(inst, sched):
        stage_s.clear()
        for (mod, name), fn in saved_stages.items():
            setattr(mod, name, timed_stage(name, fn))
        try:
            out = timed_plan(inst, sched, "pipeline")
        finally:
            for (mod, name), fn in saved_stages.items():
                setattr(mod, name, fn)
        got, wall, launches, st = out
        dec = st["plan"]["decompose"]
        if min(launches["bna_decompose"], launches["merge_fix"]) == 0:
            _fail(f"{sched} pipeline: a kernel of the path was not launched "
                  f"({launches})")
        if st["bna"]["repairs"] or dec["bucket_fallbacks"]:
            _fail(f"{sched} pipeline: {st['bna']['repairs']} host repairs, "
                  f"{dec['bucket_fallbacks']} int32-overflow buckets")
        return got, {"plan_s_cuda": wall, "launches": launches,
                     "host_repairs": st["bna"]["repairs"],
                     "bucket_fallbacks": dec["bucket_fallbacks"],
                     "buckets": dec["buckets"],
                     "stage_s": dict(stage_s)}

    runs, pipe_runs = {}, {}
    for sched, scale in SCALES.items():
        inst = paper_workload(m=150, mu_bar=5, seed=0, scale=scale,
                              rooted=(sched == "gdm_rt"))
        n_cf = sum(j.mu for j in inst.jobs)
        got, wall, launches, st = timed_plan(inst, sched, "python")
        if min(launches["bna_step"], launches["coflow_merge"]) == 0:
            _fail(f"{sched}: a kernel of the python path was not launched "
                  f"({launches})")
        st = st["bna"]
        clear_caches()
        t0 = time.perf_counter()
        want = plan(inst, sched, device="cpu", seed=0)
        wall_cpu = time.perf_counter() - t0
        st_cpu = cache_stats()["bna"]
        if not plans_equal(got, want):
            _fail(f"{sched}: the card's plan differs from the CPU plan "
                  f"(twct {got.twct()} vs {want.twct()})")
        runs[sched] = {"scale": scale, "coflows": n_cf, "twct": got.twct(),
                       "plan_s_cuda": wall, "plan_s_cpu": wall_cpu,
                       "launches": launches, "bna_steps": st["steps"],
                       "host_repairs": st["repairs"],
                       "step_s": st["step_s"], "repair_s": st["repair_s"],
                       "step_s_cpu": st_cpu["step_s"],
                       "repair_s_cpu": st_cpu["repair_s"],
                       "transcript_entries":
                           len(transcript_to_arrays(got.transcript()))}
        print(f"plan {sched} (python path): m=150, scale={scale}, {n_cf} "
              f"coflows, twct {got.twct()}, cuda {wall:.2f} s, cpu "
              f"{wall_cpu:.2f} s, launches {launches}, BNA steps "
              f"{st['steps']} ({st['step_s']:.2f} s), host repairs "
              f"{st['repairs']} ({st['repair_s']:.2f} s); feasible, "
              "bit-equal to the CPU plan")
        pgot, prun = pipeline_plan(inst, sched)
        if not plans_equal(pgot, got):
            _fail(f"{sched}: the pipeline plan differs from the python-path "
                  f"plan (twct {pgot.twct()} vs {got.twct()})")
        pipe_runs[sched] = {"scale": scale, "coflows": n_cf,
                            "twct": pgot.twct(), **prun}
        print(f"plan {sched} (pipeline): scale={scale}, cuda "
              f"{prun['plan_s_cuda']:.2f} s, launches {prun['launches']}, "
              f"host repairs {prun['host_repairs']}, bucket_fallbacks "
              f"{prun['bucket_fallbacks']}, stage s "
              f"{json.dumps(prun['stage_s'])}; feasible, bit-equal to the "
              "python-path plan")
    record["plans"] = runs
    record["pipeline_plans"] = pipe_runs

    # 6. the paper's full trace size through the pipeline --------------------
    full_runs = {}
    for sched in FULL_SCALE:
        inst = paper_workload(m=150, mu_bar=5, seed=0, scale=1.0)
        _, prun = pipeline_plan(inst, sched)
        full_runs[sched] = {"scale": 1.0,
                            "coflows": sum(j.mu for j in inst.jobs), **prun}
        print(f"plan {sched} (pipeline): scale=1.0, "
              f"{full_runs[sched]['coflows']} coflows, cuda "
              f"{prun['plan_s_cuda']:.2f} s, launches {prun['launches']}, "
              f"host repairs {prun['host_repairs']}, bucket_fallbacks "
              f"{prun['bucket_fallbacks']}, stage s "
              f"{json.dumps(prun['stage_s'])}; feasible")
    record["full_scale_plans"] = full_runs

    # with the caches off the engine cannot prefetch, and the walk's
    # per-coflow misses must still decompose through the kernel
    inst_nc = paper_workload(m=150, mu_bar=5, seed=0, scale=0.05)
    clear_caches()
    cached = plan(inst_nc, "gdm", device="cuda", plan_backend="python",
                  seed=0)
    batches = cache_stats()["bna"]["batch"]["batches"]
    bna_step.launches = 0
    with no_caches():
        uncached = plan(inst_nc, "gdm", device="cuda", plan_backend="python",
                        seed=0)
    torch.cuda.synchronize()
    if bna_step.launches == 0 or \
            cache_stats()["bna"]["batch"]["batches"] != batches:
        _fail(f"gdm without caches: {bna_step.launches} bna_step launches")
    if uncached.twct() != cached.twct() or \
            uncached.job_completions() != cached.job_completions():
        _fail("gdm without caches differs from the cached plan")
    record["no_caches_bna_step_launches"] = bna_step.launches
    print(f"plan gdm without caches (python path, scale 0.05): "
          f"{bna_step.launches} bna_step launches, equal to the cached plan")

    inst = paper_workload(m=150, mu_bar=5, seed=0, scale=SCALES["gdm"])
    small = sorted((c.demand for j in inst.jobs for c in j.coflows),
                   key=lambda d: int((d > 0).sum()))[:4]
    for d, pieces in zip(small, bna_many(small, device="cuda")):
        want = bna(d)
        if len(pieces) != len(want) or any(
                t1 != t2 or not np.array_equal(p1, p2)
                for (t1, p1), (t2, p2) in zip(pieces, want)):
            _fail("bna_many on the card != the scalar BNA")
    print(f"bna_many on the card equals the scalar BNA on {len(small)} "
          "coflows")

    # 7. timings ------------------------------------------------------------
    kernels_line = []
    _, state = largest["bna_step"]
    B, w = state[0].shape[0], state[0].shape[1]
    match = state[4]
    midx = match.clamp(min=0).long()
    dm = state[0].gather(2, midx[:, :, None])[:, :, 0]
    n_matched = int((match >= 0).sum())
    n_real = int(((match >= 0) & (dm > 0)).sum())
    # each input read once (row, col, match, D and the matched d entries),
    # each output written once (d, row, col at real edges, D, packed rows)
    k1_bytes = 4 * (3 * B * w + n_matched + B) \
        + 4 * (3 * n_real + B + B * (2 + 2 * w))
    work = [x.clone() for x in state]
    plain = [x.clone() for x in state]
    kernels_line.append({
        "name": "bna_step", "route": "cuda",
        "source": "src/repro_torch/kernels/bna_step/csrc/bna_step.cu",
        "replaces": "src/repro/kernels/bna_step/bna_step.py:79",
        "launches": runs["gdm"]["launches"]["bna_step"],
        "max_abs_err": max_err["bna_step"],
        "ms": _cuda_ms(lambda: bna_step(*work)),
        "plain_ms": _cuda_ms(lambda: bna_step_ref(*plain)),
        "bound_ms": k1_bytes / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes",
        "library_ms": None, "equal": max_err["bna_step"] == 0,
        "checked_calls": checked["bna_step"], "shape": [B, w, w]})
    delta = largest["coflow_merge"]
    K, P = delta.shape
    kernels_line.append({
        "name": "coflow_merge", "route": "cuda",
        "source": "src/repro_torch/kernels/coflow_merge/csrc/coflow_merge.cu",
        "replaces": "src/repro/kernels/coflow_merge/coflow_merge.py:43",
        "launches": runs["gdm"]["launches"]["coflow_merge"],
        "max_abs_err": max_err["coflow_merge"],
        "ms": _cuda_ms(lambda: coflow_merge(delta)),
        "plain_ms": _cuda_ms(lambda: alphas_ref(delta)),
        "bound_ms": 4 * (K * P + K) / HBM_BYTES_PER_S * 1e3,
        "bound_by": "bytes", "library_ms": None,
        "equal": max_err["coflow_merge"] == 0,
        "checked_calls": checked["coflow_merge"], "shape": [K, P]})
    Kb, Pb = big.shape
    record["coflow_merge_1e5"] = {
        "shape": [Kb, Pb], "ms": _cuda_ms(lambda: coflow_merge(big)),
        "plain_ms": _cuda_ms(lambda: alphas_ref(big)),
        "bound_ms": 4 * (Kb * Pb + Kb) / HBM_BYTES_PER_S * 1e3}
    print(f"coflow_merge at K={Kb}, 2m={Pb}: "
          f"{json.dumps(record['coflow_merge_1e5'])}")

    _, (d, ks, T_cap, t_store), dec_plain_ms, nsteps = \
        largest["bna_decompose"]
    Bd, wd = d.shape[0], d.shape[1]
    steps = int(nsteps.sum())
    # the stack read once; each lane's steps written once (t and its row
    # of w matched receivers), D_final and the step counts
    k_dec_bytes = 4 * (Bd * wd * wd + Bd) + 4 * (steps * (wd + 1) + 2 * Bd)
    kernels_line.append({
        "name": "bna_decompose", "route": "cuda",
        "source": "src/repro_torch/kernels/bna_decompose/csrc/"
                  "bna_decompose.cu",
        "replaces": "src/repro/core/pipeline.py:114",
        "launches": pipe_runs["gdm"]["launches"]["bna_decompose"],
        "max_abs_err": max_err["bna_decompose"],
        "ms": _wall_ms(lambda: bna_decompose(d, ks, T_cap, t_store=t_store)),
        "plain_ms": dec_plain_ms,
        "bound_ms": k_dec_bytes / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes",
        "library_ms": None, "equal": max_err["bna_decompose"] == 0,
        "checked_calls": checked["bna_decompose"], "shape": [Bd, wd, wd],
        "lane_steps": {"sum": steps, "max": int(nsteps.max())}})
    (mf_args, mf_m) = largest["merge_fix"]
    Km, Em = mf_args[0].numel() - 1, mf_args[1].numel()
    # events and the four edge arrays read once, alphas and deltas written
    k3_bytes = 8 * (Km + 1 + 4 * Em) + 8 * 2 * Km
    kernels_line.append({
        "name": "merge_fix", "route": "cuda",
        "source": "src/repro_torch/kernels/merge_fix/csrc/merge_fix.cu",
        "replaces": "src/repro/kernels/merge_fix/ops.py:28",
        "launches": pipe_runs["gdm"]["launches"]["merge_fix"],
        "max_abs_err": max_err["merge_fix"],
        "ms": _cuda_ms(lambda: merge_fix(*mf_args, mf_m)),
        "plain_ms": _cuda_ms(lambda: merge_fix_ref(*mf_args, mf_m)),
        "bound_ms": k3_bytes / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes",
        "library_ms": None, "equal": max_err["merge_fix"] == 0,
        "checked_calls": checked["merge_fix"], "shape": [Km, 2 * mf_m, Em]})
    Ks = events.size - 1
    record["merge_fix_1e5"] = {
        "shape": [Ks, 2 * m_syn, E],
        "ms": _cuda_ms(lambda: merge_fix(*syn_args, m_syn)),
        "plain_ms": _cuda_ms(lambda: merge_fix_ref(*syn_args, m_syn)),
        "bound_ms": 8 * (Ks + 1 + 4 * E + 2 * Ks) / HBM_BYTES_PER_S * 1e3}
    print(f"merge_fix at K={Ks}, 2m={2 * m_syn}, E={E}: "
          f"{json.dumps(record['merge_fix_1e5'])}")
    record["kernels"] = kernels_line

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    if smi.returncode != 0:
        _fail(f"nvidia-smi exited {smi.returncode}: {smi.stderr.strip()}")
    record["nvidia_smi"] = smi.stdout.strip()
    record["total_s"] = time.perf_counter() - t_start
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps(record, indent=1))

    print("plan wall times (s): " + json.dumps(
        {s: {"python_cuda": r["plan_s_cuda"], "python_cpu": r["plan_s_cpu"],
             "pipeline_cuda": pipe_runs[s]["plan_s_cuda"]}
         for s, r in runs.items()}))
    print("pipeline at scale 1.0 (s): " + json.dumps(
        {s: r["plan_s_cuda"] for s, r in full_runs.items()}))
    print("python path: BNA steps, host repairs, and their seconds (card "
          "run; CPU run): " + json.dumps(
              {s: [r["bna_steps"], r["host_repairs"],
                   [r["step_s"], r["repair_s"]],
                   [r["step_s_cpu"], r["repair_s_cpu"]]]
               for s, r in runs.items()}))
    print(f"total {record['total_s']:.1f} s")
    print(smi.stdout.strip())
    print(json.dumps({"kernels": kernels_line}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
