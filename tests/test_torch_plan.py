"""The port's planning path as a whole: ``repro_torch.core.plan(...,
device="cpu")`` for gdm, gdm_rt and om_alg against ``repro.core.plan`` on
the scenario registry's TINY instances (tests/test_scenarios.py), converted
through ``repro_torch.core.convert``.  Transcripts, completions and twct
must be equal; every quantity is an integer or a float64 built in the same
order, so equality is exact."""
import functools
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import repro.core as ref
from repro import scenarios
from repro.core import backend as ref_backend
from repro_torch.core import (backend, bna, cache_stats, clear_caches,
                              instance_from_arrays, instance_to_arrays,
                              no_caches, plan, transcript_to_arrays,
                              verify_schedule, verify_transcript)
from repro_torch.core.timeline import (unit_from_coflow_edges,
                                       unit_from_coflow_plan)

REPO = Path(__file__).resolve().parents[1]
GOLDEN_PATH = REPO / "tests" / "goldens" / "scenario_goldens.json"
SCHEDULERS = ("gdm", "gdm_rt", "om_alg")
# tiny per-scenario sizes, as tests/test_scenarios.py
TINY = {
    "fb_like": dict(m=6, scale=0.03),
    "fb_like_rt": dict(m=6, scale=0.03),
    "alibaba_sparse": dict(m=6, scale=0.15),
    "incast": dict(m=6, scale=0.1),
    "shuffle_heavy": dict(m=6, scale=0.2),
    "wide_shallow": dict(m=6, scale=0.2),
    "deep_chain": dict(m=6, scale=0.25),
    "online_poisson": dict(m=6, scale=0.03),
    "dist_collectives": dict(m=8, scale=0.5),
}


@functools.lru_cache(maxsize=None)
def _tiny(name):
    return scenarios.build(name, seed=0, **TINY[name])


def _port_instance(ref_inst):
    return instance_from_arrays(*instance_to_arrays(ref_inst))


def _assert_transcripts_equal(got, want, ctx):
    a = transcript_to_arrays(got)
    b = transcript_to_arrays(want)
    assert len(a) == len(b), f"{ctx}: {len(a)} entries != {len(b)}"
    for i, (x, y) in enumerate(zip(a, b)):
        assert x[:4] == y[:4], f"{ctx}: entry {i} {x[:4]} != {y[:4]}"
        for name, u, v in zip(("srcs", "dsts", "units"), x[4:], y[4:]):
            assert u.dtype == v.dtype and np.array_equal(u, v), \
                f"{ctx}: entry {i} {name} differs"


def _assert_plans_equal(got, want, ctx):
    _assert_transcripts_equal(got.transcript(), want.transcript(), ctx)
    assert got.job_completions() == want.job_completions(), \
        f"{ctx}: completions differ"
    assert got.twct() == want.twct(), f"{ctx}: twct differs"
    assert got.makespan == want.makespan, f"{ctx}: makespan differs"


@pytest.mark.parametrize("sched", SCHEDULERS)
@pytest.mark.parametrize("scen", sorted(TINY))
def test_plan_equals_reference(scen, sched):
    built = _tiny(scen)
    opts = scenarios.scheduler_opts(sched, built.meta)
    want = ref.plan(built.instance, sched, seed=0, **opts)
    inst = _port_instance(built.instance)
    clear_caches()
    got = plan(inst, sched, device="cpu", seed=0, **opts)
    _assert_plans_equal(got, want, f"{scen}/{sched}")
    verify_transcript(inst, got.transcript())


@pytest.mark.parametrize("sched,opts", [
    ("gdm", dict(decompose=True)),
    ("gdm", dict(delays="spread")),
    ("gdm", dict(beta=3.0, seed=7)),
    ("gdm_rt", dict(delays="spread", decompose=True)),
    ("gdm_rt", dict(nested=False)),
    ("om_alg", dict(decompose=True)),
])
def test_plan_options_equal_reference(sched, opts):
    built = _tiny("fb_like_rt")
    want = ref.plan(built.instance, sched, **opts)
    inst = _port_instance(built.instance)
    clear_caches()
    got = plan(inst, sched, device="cpu", **opts)
    _assert_plans_equal(got, want, f"{sched}/{opts}")
    verify_schedule(inst, got.schedule)


def test_plan_equals_reference_pallas_interpret():
    """The reference forced onto its Pallas kernels (interpret mode)."""
    built = _tiny("fb_like")
    with ref_backend.use_alpha_backend("pallas"), \
            ref_backend.use_bna_backend("pallas"):
        ref_backend.clear_caches()
        want = ref.plan(built.instance, "gdm", seed=0)
    ref_backend.clear_caches()
    clear_caches()
    got = plan(_port_instance(built.instance), "gdm", device="cpu", seed=0)
    _assert_plans_equal(got, want, "fb_like/gdm/pallas")


def test_plan_matches_scenario_goldens():
    want = json.loads(GOLDEN_PATH.read_text())
    inst = _port_instance(_tiny("fb_like").instance)
    opts_of = lambda s: scenarios.scheduler_opts(s, _tiny("fb_like").meta)
    for sched in SCHEDULERS:
        clear_caches()
        got = plan(inst, sched, device="cpu", seed=0, **opts_of(sched))
        assert got.twct() == want[sched], f"{sched}: golden twct"


def test_plan_caches_are_results_identical():
    inst = _port_instance(_tiny("incast").instance)
    clear_caches()
    cold = plan(inst, "gdm", device="cpu", seed=0)
    warm = plan(inst, "gdm", device="cpu", seed=0)
    _assert_plans_equal(warm, cold, "warm vs cold")
    assert cache_stats()["order"]["hits"] >= 1


def test_plan_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    inst = _port_instance(_tiny("incast").instance)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        plan(inst, "gdm", seed=0)


def test_unknown_scheduler_and_option_rejected():
    inst = _port_instance(_tiny("incast").instance)
    with pytest.raises(KeyError):
        plan(inst, "sincronia", device="cpu")
    with pytest.raises(TypeError, match="unknown option"):
        plan(inst, "gdm", device="cpu", betta=2.0)


def test_convert_round_trip_and_workload_equal_reference():
    import repro_torch.core as port

    ri = ref.paper_workload(m=12, mu_bar=3, seed=4, scale=0.05, rooted=True)
    pi = port.paper_workload(m=12, mu_bar=3, seed=4, scale=0.05, rooted=True)
    a_m, a_jobs = instance_to_arrays(ri)
    b_m, b_jobs = instance_to_arrays(pi)
    assert a_m == b_m and len(a_jobs) == len(b_jobs)
    for x, y in zip(a_jobs, b_jobs):
        assert {k: x[k] for k in ("jid", "weight", "release", "edges")} == \
            {k: y[k] for k in ("jid", "weight", "release", "edges")}
        assert all(np.array_equal(u, v)
                   for u, v in zip(x["demands"], y["demands"]))
    again = instance_to_arrays(instance_from_arrays(b_m, b_jobs))[1]
    assert all(np.array_equal(u, v) for x, y in zip(again, b_jobs)
               for u, v in zip(x["demands"], y["demands"]))


def test_unit_from_coflow_edges_equals_plan():
    d = np.random.default_rng(1).integers(0, 6, size=(5, 5))
    pieces = bna(d)
    u = unit_from_coflow_plan(3, 1, d, pieces, start=10)
    rel = (u.edges.t0 - 10, u.edges.t1 - 10, u.edges.s, u.edges.r)
    v = unit_from_coflow_edges(3, 1, d, rel, start=10)
    for name in ("t0", "t1", "s", "r", "owner", "jid", "cid"):
        assert np.array_equal(getattr(u.edges, name), getattr(v.edges, name))


def test_port_imports_neither_jax_nor_repro():
    code = (
        "import sys\n"
        "import repro_torch\n"
        "from repro_torch.core import paper_workload, plan\n"
        "inst = paper_workload(m=8, mu_bar=3, seed=0, scale=0.04)\n"
        "for pb in ('python', 'pipeline'):\n"
        "    for s in ('gdm', 'om_alg'):\n"
        "        plan(inst, s, device='cpu', plan_backend=pb, seed=0)\n"
        "    plan(inst, 'gdm_rt', device='cpu', plan_backend=pb, seed=0,\n"
        "         require_tree=False)\n"
        "    for s in ('gdm_bf', 'om_alg_bf'):\n"
        "        for ex in ('packet', 'ledger'):\n"
        "            plan(inst, s, device='cpu', plan_backend=pb, seed=0,\n"
        "                 exec=ex)\n"
        "import importlib\n"
        "for mod in ('backfill', 'session', 'online', 'stream'):\n"
        "    importlib.import_module('repro_torch.core.' + mod)\n"
        "from repro_torch.core import (plan_online, poisson_releases,\n"
        "                              run_stream, stream_jobs, theta0)\n"
        "on = poisson_releases(inst, theta=3 * theta0(inst), seed=0)\n"
        "for pb in ('python', 'pipeline'):\n"
        "    plan_online(on, 'gdm', device='cpu', plan_backend=pb, seed=0)\n"
        "    run_stream(stream_jobs(8, 6, 0), 8, 'gdm', gamma='pinned',\n"
        "               delays='spread', device='cpu', plan_backend=pb)\n"
        "from repro_torch import scenarios\n"
        "from repro_torch.core import (fsp_to_coflow_job, gap_instance,\n"
        "                              workload_stats)\n"
        "from repro_torch.dist import planner\n"
        "import repro_torch.core.fsp_reduction, repro_torch.core.gap_instance\n"
        "for name in scenarios.names():\n"
        "    b = scenarios.build(name, seed=0, scale=0.05,\n"
        "                        m=8 if name == 'dist_collectives' else 6)\n"
        "    scenarios.check_bounds(b)\n"
        "    workload_stats(b.instance)\n"
        "plan(gap_instance(2), 'gdm', device='cpu', seed=0)\n"
        "plan(fsp_to_coflow_job([[3, 1], [2, 4]]), 'gdm_rt', device='cpu',\n"
        "     seed=0)\n"
        "planner.plan(planner.coflows_from_step(\n"
        "    planner.synthetic_collective_ops(8, seed=0), 2, 2, 4),\n"
        "    device='cpu')\n"
        "import repro_torch.models, repro_torch.serve, repro_torch.configs\n"
        "from repro_torch.launch import serve\n"
        "serve.main(['--requests', '3', '--max-new', '3', '--device', 'cpu'])\n"
        "import torch\n"
        "from repro_torch.configs import get_config\n"
        "from repro_torch.models import init_lm, lm_forward\n"
        "cfg = get_config('mamba2-2.7b').smoke()\n"
        "p = init_lm(cfg, torch.Generator().manual_seed(0))\n"
        "lg, _ = lm_forward(cfg, p, torch.ones((1, 20), dtype=torch.long))\n"
        "assert bool(torch.isfinite(lg).all()), 'mamba2 forward'\n"
        "import repro_torch.models.moe, repro_torch.models.encdec\n"
        "import repro_torch.models.vlm\n"
        "from repro_torch.models import (encdec_loss, init_encdec, init_vlm,\n"
        "                                lm_loss, vlm_loss)\n"
        "cfg = get_config('granite-moe-3b').smoke()\n"
        "p = init_lm(cfg, torch.Generator().manual_seed(0))\n"
        "t = torch.ones((1, 20), dtype=torch.long)\n"
        "assert bool(torch.isfinite(lm_loss(cfg, p, t, t))), 'moe loss'\n"
        "cfg = get_config('whisper-large-v3').smoke()\n"
        "p = init_encdec(cfg, torch.Generator().manual_seed(0))\n"
        "fr = torch.zeros((1, cfg.encoder_seq, cfg.d_model))\n"
        "assert bool(torch.isfinite(encdec_loss(cfg, p, fr, t, t))), 'encdec'\n"
        "cfg = get_config('llava-next-mistral-7b').smoke()\n"
        "p = init_vlm(cfg, torch.Generator().manual_seed(0))\n"
        "pa = torch.zeros((1, cfg.n_image_tokens, cfg.d_model))\n"
        "assert bool(torch.isfinite(vlm_loss(cfg, p, pa, t, t))), 'vlm'\n"
        "serve.main(['--arch', 'granite-moe-3b', '--requests', '2',\n"
        "            '--max-new', '2', '--device', 'cpu'])\n"
        "import tempfile\n"
        "import repro_torch.train, repro_torch.data, repro_torch.ckpt\n"
        "import repro_torch.ft, repro_torch.dist.compression\n"
        "from repro_torch.launch import specs, train\n"
        "from repro_torch.kernels.flash_attention import flash_attention\n"
        "specs.abstract_params(get_config('qwen3-1.7b'))\n"
        "q = torch.ones((1, 2, 4, 8), requires_grad=True)\n"
        "flash_attention(q, q, q).sum().backward()\n"
        "with tempfile.TemporaryDirectory() as d:\n"
        "    train.main(['--arch', 'tinyllama-1.1b', '--smoke', '--steps',\n"
        "                '2', '--seq-len', '16', '--global-batch', '2',\n"
        "                '--plan-buckets', '2', '--ckpt-every', '1',\n"
        "                '--ckpt-dir', d, '--device', 'cpu'])\n"
        "import repro_torch.kernels.ssd_scan.ref\n"
        "from repro_torch.kernels.ssd_scan import (\n"
        "    ssd_bwd_chunk, ssd_bwd_state, ssd_scan_bwd)\n"
        "cfg = get_config('mamba2-2.7b').smoke()\n"
        "p = init_lm(cfg, torch.Generator().manual_seed(0))\n"
        "for leaf in p['stack']['l0']['mamba'].values():\n"
        "    if isinstance(leaf, torch.Tensor):\n"
        "        leaf.requires_grad_()\n"
        "lm_loss(cfg, p, t, t).backward()\n"
        "assert p['stack']['l0']['mamba']['a_log'].grad is not None\n"
        "with tempfile.TemporaryDirectory() as d:\n"
        "    train.main(['--arch', 'mamba2-2.7b', '--smoke', '--steps', '1',\n"
        "                '--seq-len', '20', '--global-batch', '2',\n"
        "                '--ckpt-dir', d, '--device', 'cpu'])\n"
        "from repro_torch.dist import partition\n"
        "from repro_torch.launch import dryrun, mesh as lmesh\n"
        "from repro_torch.models import sharding\n"
        "dryrun.init_fake_group(8)\n"
        "m8 = lmesh.make_production_mesh(shape=(2, 4), device_type='cpu')\n"
        "for sh in ('train_4k', 'decode_32k'):\n"
        "    r = dryrun.run_cell('tinyllama-1.1b', sh, mesh=m8, verbose=False,\n"
        "                        cfg=get_config('tinyllama-1.1b').smoke())\n"
        "    assert r['status'] == 'ok' and r['collectives']['n_ops'], sh\n"
        "assert planner.extract_collectives(\n"
        "    '%a = f32[4]{0} all-reduce(f32[4]{0} %x)')[0].bytes == 16\n"
        "specs.input_specs(get_config('qwen3-1.7b'), 'decode_32k')\n"
        "sharding.shard(t, ('dp', None))\n"
        "import importlib, pkgutil\n"
        "import repro_torch.analysis\n"
        "for sub in pkgutil.walk_packages(repro_torch.analysis.__path__,\n"
        "                                 'repro_torch.analysis.'):\n"
        "    importlib.import_module(sub.name)\n"
        "from repro_torch.analysis import scan_paths\n"
        "assert scan_paths(['src/repro_torch/kernels'],\n"
        "                  rules=['overflow-range']).ok(), 'analysis'\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or\n"
        "             m.startswith('jax.') or m == 'repro' or\n"
        "             m.startswith('repro.'))\n"
        "print('LEAKED', bad)\n")
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "LEAKED []" in out.stdout, out.stdout
    assert '"completed": 3' in out.stdout, out.stdout


@pytest.mark.parametrize("bound", ["no_caches", "bna_cache_1"])
def test_plan_without_prefetch_decomposes_through_batched_step(bound):
    """With the caches off, or a BNA cache too small for the instance's
    prefetch, every coflow still goes through the batched step and the
    plan equals the reference's."""
    built = _tiny("fb_like")
    want = ref.plan(built.instance, "gdm", seed=0)
    inst = _port_instance(built.instance)
    clear_caches()
    prev = backend.bna_cache.maxsize
    try:
        if bound == "no_caches":
            with no_caches():
                got = plan(inst, "gdm", device="cpu", seed=0)
        else:
            backend.bna_cache.maxsize = 1
            got = plan(inst, "gdm", device="cpu", seed=0)
        stats = cache_stats()["bna"]
        assert stats["batch"]["batches"] == 0
        assert stats["steps"] > 0
    finally:
        backend.bna_cache.maxsize = prev
        clear_caches()
    _assert_plans_equal(got, want, f"fb_like/gdm/{bound}")
