#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port (src/repro_torch) on one NVIDIA card.

    python3 chip_smoke.py

Phases; any failure exits non-zero and prints no result line:

1. Build both kernels from the sources in the checkout (one ``nvcc`` per
   source, started together) and print ``-Xptxas -v``'s registers and
   shared memory per kernel.
2. Hold the ``bna_step`` kernel against its plain PyTorch version on the
   card, for exact equality, on random states (B in {1, 37, 256}, w in
   {1, 8, 64, 256}, drained matrices included).
3. Run the main path once with both kernels checked at every call: each
   ``bna_step`` launch against the plain version on a clone of the same
   state, each ``coflow_merge`` call against the plain version on the
   same deltas.  Then hold ``coflow_merge`` to its plain version on a
   synthetic edge set at K ~ 1e5.
4. The main path: ``paper_workload(m=150, mu_bar=5, seed=0, scale=0.25)``
   (67 coflows) planned with gdm and om_alg, and with gdm_rt on the
   ``rooted=True`` workload at scale 0.1 (27 coflows), on the card, each
   with the launch counters set to 0 just before and read just after.
   Each plan must be feasible under the port's simulator, must have
   launched both kernels, and must give the twct, completions and
   transcript of the same plan on the CPU (the plain versions) bit for
   bit.  gdm is also planned with the caches off (no prefetch), where
   every coflow must still go through the kernel.  A few coflows are also
   checked against the scalar BNA.
5. Time each kernel (CUDA events) at the largest shapes the main path gave
   it, beside its plain version and its bound (bytes moved over the
   card's 3.35 TB/s), and print the ``kernels`` line, the plan wall
   times, the count of BNA steps and host repairs, and the card's name and
   power limit.  The last line is the result line.

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
# on 150 x 150 merged matrices) on each of its two runs, so the time limit
# cuts it to 0.1; gdm and om_alg keep 0.25
SCALES = {"gdm": 0.25, "gdm_rt": 0.1, "om_alg": 0.25}


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
                                  paper_workload, plan, transcript_to_arrays,
                                  verify_schedule, verify_transcript)
    from repro_torch.kernels.bna_step import bna_step, stage_int32
    from repro_torch.kernels.bna_step.ref import bna_step_ref
    from repro_torch.kernels.coflow_merge import coflow_merge
    from repro_torch.kernels.coflow_merge.ref import alphas_ref, build_delta

    dev = torch.device("cuda")
    record: dict = {"device": torch.cuda.get_device_name(0)}
    t_start = time.perf_counter()

    # 1. build --------------------------------------------------------------
    t0 = time.perf_counter()
    reports = kernels.build_kernels(["bna_step", "coflow_merge"])
    record["build_s"] = time.perf_counter() - t0
    print(f"build: {record['build_s']:.2f} s, sm_90a, into {kernels.BUILD_DIR}")
    for name, log in reports.items():
        for line in log.splitlines():
            if "registers" in line or "Compiling entry" in line \
                    or "spill" in line:
                print(f"  ptxas[{name}]: {line.strip()}")

    # 2. bna_step on random states ------------------------------------------
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

    # largest |kernel - plain| over every comparison made in this run, the
    # kernels' outputs and the states they update in place included
    max_err = {"bna_step": 0, "coflow_merge": 0}

    def abs_err(pairs) -> int:
        return max((int((x.long() - y.long()).abs().max()) if x.numel()
                    else 0 for x, y in pairs), default=0)

    def step_err(state_dev) -> int:
        ref_in = [x.clone() for x in state_dev]
        got = bna_step(*state_dev)
        want = bna_step_ref(*ref_in)
        return abs_err([(got, want), *zip(state_dev, ref_in)])

    rng = np.random.default_rng(0)
    n_random = 0
    for B in (1, 37, 256):
        for w in (1, 8, 64, 256):
            state = stage_int32(*random_state(rng, B, w), dev)
            err = step_err(list(state))
            max_err["bna_step"] = max(max_err["bna_step"], err)
            if err:
                _fail(f"bna_step != plain version on a random state "
                      f"(B={B}, w={w}, max |diff| {err})")
            n_random += 1
    torch.cuda.synchronize()
    print(f"bna_step: equal to the plain version on {n_random} random "
          f"states (B in 1/37/256, w in 1/8/64/256)")

    # 3. both kernels checked at every call of one main-path run -------------
    largest = {"bna_step": None, "coflow_merge": None}
    checked = {"bna_step": 0, "coflow_merge": 0}
    orig_alphas = backend.edge_interval_alphas

    def checked_step(d, row, col, D, match):
        ref_in = [x.clone() for x in (d, row, col, D, match)]
        before = [x.clone() for x in (d, row, col, D, match)]
        out = bna_step(d, row, col, D, match)
        want = bna_step_ref(*ref_in)
        err = abs_err([(out, want), *zip((d, row, col, D, match), ref_in)])
        max_err["bna_step"] = max(max_err["bna_step"], err)
        if err:
            _fail(f"bna_step != plain version on a main-path state "
                  f"(B={d.shape[0]}, w={d.shape[1]}, max |diff| {err})")
        checked["bna_step"] += 1
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
        err = int(np.abs(got - want).max(initial=0))
        max_err["coflow_merge"] = max(max_err["coflow_merge"], err)
        if err:
            _fail(f"coflow_merge != plain version on a main-path edge set "
                  f"(K={delta.shape[0]}, max |diff| {err})")
        checked["coflow_merge"] += 1
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
        plan(inst, "gdm", device="cuda", seed=0)
        torch.cuda.synchronize()
    finally:
        matching.bna_step, backend.edge_interval_alphas = \
            bna_step, orig_alphas
    if not all(checked.values()):
        _fail(f"checked run reached no kernel call: {checked}")
    print(f"checked main-path run (gdm): {checked['bna_step']} bna_step and "
          f"{checked['coflow_merge']} coflow_merge calls equal to the plain "
          f"versions ({time.perf_counter() - t0:.1f} s)")

    grng = np.random.default_rng(1)
    E, m_syn = 60_000, 150
    t0s = grng.integers(0, 10_000_000, E)
    t1s = t0s + grng.integers(1, 5_000, E)
    events = np.unique(np.concatenate([t0s, t1s]))
    si = torch.as_tensor(np.searchsorted(events, t0s), device=dev)
    ei = torch.as_tensor(np.searchsorted(events, t1s), device=dev)
    big = build_delta(si, ei, torch.as_tensor(grng.integers(0, m_syn, E),
                                              device=dev),
                      torch.as_tensor(grng.integers(0, m_syn, E), device=dev),
                      int(events.size) - 1, m_syn)
    err = abs_err([(coflow_merge(big), alphas_ref(big))])
    max_err["coflow_merge"] = max(max_err["coflow_merge"], err)
    if err:
        _fail(f"coflow_merge != plain version at K={big.shape[0]} "
              f"(max |diff| {err})")
    torch.cuda.synchronize()
    print(f"coflow_merge: equal to the plain version on a synthetic edge "
          f"set, K={big.shape[0]}, 2m={big.shape[1]}")

    # 4. the main path ------------------------------------------------------
    runs = {}
    for sched, scale in SCALES.items():
        inst = paper_workload(m=150, mu_bar=5, seed=0, scale=scale,
                              rooted=(sched == "gdm_rt"))
        n_cf = sum(j.mu for j in inst.jobs)
        clear_caches()
        bna_step.launches = coflow_merge.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = plan(inst, sched, device="cuda", seed=0)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {"bna_step": bna_step.launches,
                    "coflow_merge": coflow_merge.launches}
        st = cache_stats()["bna"]
        if min(launches.values()) == 0:
            _fail(f"{sched}: a kernel of the path was not launched "
                  f"({launches})")
        verify_schedule(inst, got.schedule)
        verify_transcript(inst, got.transcript())
        clear_caches()
        t0 = time.perf_counter()
        want = plan(inst, sched, device="cpu", seed=0)
        wall_cpu = time.perf_counter() - t0
        st_cpu = cache_stats()["bna"]
        a = transcript_to_arrays(got.transcript())
        b = transcript_to_arrays(want.transcript())
        same = len(a) == len(b) and all(
            x[:4] == y[:4] and all(np.array_equal(u, v)
                                   for u, v in zip(x[4:], y[4:]))
            for x, y in zip(a, b))
        if not (same and got.twct() == want.twct()
                and got.job_completions() == want.job_completions()):
            _fail(f"{sched}: the card's plan differs from the CPU plan "
                  f"(twct {got.twct()} vs {want.twct()})")
        runs[sched] = {"scale": scale, "coflows": n_cf, "twct": got.twct(),
                       "plan_s_cuda": wall, "plan_s_cpu": wall_cpu,
                       "launches": launches, "bna_steps": st["steps"],
                       "host_repairs": st["repairs"],
                       "step_s": st["step_s"], "repair_s": st["repair_s"],
                       "step_s_cpu": st_cpu["step_s"],
                       "repair_s_cpu": st_cpu["repair_s"],
                       "transcript_entries": len(a)}
        print(f"plan {sched}: m=150, scale={scale}, {n_cf} coflows, twct "
              f"{got.twct()}, cuda {wall:.2f} s, cpu {wall_cpu:.2f} s, "
              f"launches {launches}, BNA steps {st['steps']} "
              f"({st['step_s']:.2f} s), host repairs {st['repairs']} "
              f"({st['repair_s']:.2f} s); feasible, bit-equal to the CPU "
              "plan")
    record["plans"] = runs

    # with the caches off the engine cannot prefetch, and the walk's
    # per-coflow misses must still decompose through the kernel
    inst_nc = paper_workload(m=150, mu_bar=5, seed=0, scale=0.05)
    clear_caches()
    cached = plan(inst_nc, "gdm", device="cuda", seed=0)
    batches = cache_stats()["bna"]["batch"]["batches"]
    bna_step.launches = 0
    with no_caches():
        uncached = plan(inst_nc, "gdm", device="cuda", seed=0)
    torch.cuda.synchronize()
    if bna_step.launches == 0 or \
            cache_stats()["bna"]["batch"]["batches"] != batches:
        _fail(f"gdm without caches: {bna_step.launches} bna_step launches")
    if uncached.twct() != cached.twct() or \
            uncached.job_completions() != cached.job_completions():
        _fail("gdm without caches differs from the cached plan")
    record["no_caches_bna_step_launches"] = bna_step.launches
    print(f"plan gdm without caches (scale 0.05): {bna_step.launches} "
          "bna_step launches, equal to the cached plan")

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

    # 5. timings ------------------------------------------------------------
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
    k1_ms = _cuda_ms(lambda: bna_step(*work))
    k1_plain = _cuda_ms(lambda: bna_step_ref(*plain))
    kernels_line.append({
        "name": "bna_step", "route": "cuda",
        "source": "src/repro_torch/kernels/bna_step/csrc/bna_step.cu",
        "replaces": "src/repro/kernels/bna_step/bna_step.py:79",
        "launches": runs["gdm"]["launches"]["bna_step"],
        "max_abs_err": max_err["bna_step"], "ms": k1_ms, "plain_ms": k1_plain,
        "bound_ms": k1_bytes / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes",
        "library_ms": None, "equal": max_err["bna_step"] == 0,
        "checked_calls": checked["bna_step"], "random_states": n_random,
        "shape": [B, w, w]})
    delta = largest["coflow_merge"]
    K, P = delta.shape
    k2_ms = _cuda_ms(lambda: coflow_merge(delta))
    k2_plain = _cuda_ms(lambda: alphas_ref(delta))
    kernels_line.append({
        "name": "coflow_merge", "route": "cuda",
        "source": "src/repro_torch/kernels/coflow_merge/csrc/coflow_merge.cu",
        "replaces": "src/repro/kernels/coflow_merge/coflow_merge.py:43",
        "launches": runs["gdm"]["launches"]["coflow_merge"],
        "max_abs_err": max_err["coflow_merge"], "ms": k2_ms,
        "plain_ms": k2_plain,
        "bound_ms": 4 * (K * P + K) / HBM_BYTES_PER_S * 1e3,
        "bound_by": "bytes", "library_ms": None,
        "equal": max_err["coflow_merge"] == 0,
        "checked_calls": checked["coflow_merge"], "synthetic_sets": 1,
        "shape": [K, P]})
    Kb, Pb = big.shape
    record["coflow_merge_1e5"] = {
        "shape": [Kb, Pb], "ms": _cuda_ms(lambda: coflow_merge(big)),
        "plain_ms": _cuda_ms(lambda: alphas_ref(big)),
        "bound_ms": 4 * (Kb * Pb + Kb) / HBM_BYTES_PER_S * 1e3}
    record["kernels"] = kernels_line
    print(f"coflow_merge at K={Kb}, 2m={Pb}: "
          f"{json.dumps(record['coflow_merge_1e5'])}")

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
        {s: {"cuda": r["plan_s_cuda"], "cpu": r["plan_s_cpu"]}
         for s, r in runs.items()}))
    print("BNA steps, host repairs, and their seconds (card run; CPU run): "
          + json.dumps({s: [r["bna_steps"], r["host_repairs"],
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
