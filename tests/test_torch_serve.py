"""The port's serving engine (src/repro_torch/serve) and launcher against
the reference's on the CPU: the same requests through fifo and through
coflow admission (the scheduling session's frontier), with the reference's
parameters carried across by ``lm_params_from_numpy``, must give identical
admission orders, token streams and serve statistics (greedy argmax of
logits that agree to 1e-4 in float32)."""
import json

import jax
import numpy as np
import pytest
import torch

import repro.configs as ref_configs
from repro.launch import serve as ref_launch
from repro.models import lm as ref_lm
from repro.serve import Request as RefRequest
from repro.serve import ServeConfig as RefServeConfig
from repro.serve import ServingEngine as RefServingEngine
import repro_torch.configs as configs
from repro_torch.launch import serve as launch
from repro_torch.models import init_lm, lm_forward, lm_params_from_numpy
from repro_torch.serve import Request, ServeConfig, ServingEngine

DENSE = ["qwen3_1_7b", "tinyllama_1_1b", "qwen2_5_32b"]
MODELS = DENSE + ["mamba2_2_7b"]


def _requests(cls, cfg, seed=0):
    """As repro.launch.serve builds them: staggered arrivals, random
    prompt lengths and weights."""
    rng = np.random.default_rng(seed)
    return [cls(rid=i, tokens=rng.integers(1, cfg.vocab,
                                           size=rng.integers(4, 17)),
                max_new=6, weight=float(rng.uniform(0.5, 2.0)),
                arrival=float(i // 2))
            for i in range(7)]


@pytest.mark.parametrize("arch", MODELS)
def test_fifo_serve_equals_reference(arch):
    rcfg = ref_configs.get_config(arch).smoke()
    pcfg = configs.get_config(arch).smoke()
    rp = ref_lm.init_lm(rcfg, jax.random.PRNGKey(0))
    pp = lm_params_from_numpy(pcfg, jax.tree.map(np.asarray, rp),
                              device="cpu")
    want_reqs = _requests(RefRequest, rcfg)
    want = RefServingEngine(rcfg, rp, RefServeConfig(
        slots=3, capacity=32, admission="fifo")).run(want_reqs)
    got_reqs = _requests(Request, pcfg)
    eng = ServingEngine(pcfg, pp, ServeConfig(slots=3, capacity=32,
                                              admission="fifo"))
    got = eng.run(got_reqs)
    assert got == want and got["completed"] == 7
    for g, w in zip(got_reqs, want_reqs):
        assert g.out == w.out, g.rid
        assert (g.done, g.finish_step) == (w.done, w.finish_step)
    # the engine is reusable: a second batch with restarted rids
    again = _requests(Request, pcfg)
    assert eng.run(again) == got
    assert [r.out for r in again] == [r.out for r in got_reqs]


def test_serve_config_validation_as_reference():
    """tests/test_partition_planner_serve.py::
    test_serve_config_ports_validation_and_threading, the parts without the
    scheduling session."""
    with pytest.raises(ValueError, match="ports"):
        ServeConfig(ports=1)
    with pytest.raises(ValueError, match="ports"):
        ServeConfig(ports="8")
    with pytest.raises(ValueError, match="ports"):
        ServeConfig(ports=True)
    with pytest.raises(ValueError, match="slots"):
        ServeConfig(slots=0)
    with pytest.raises(ValueError, match="capacity"):
        ServeConfig(capacity=-3)
    with pytest.raises(ValueError, match="admission"):
        ServeConfig(admission="lifo")
    cfg = configs.get_config("qwen3_1_7b").smoke()
    params = init_lm(cfg, torch.Generator().manual_seed(0))
    eng = ServingEngine(cfg, params, ServeConfig(slots=2, capacity=32,
                                                 ports=5, admission="fifo"))
    r = Request(rid=0, tokens=np.arange(4), max_new=2, weight=2.0)
    assert [x.rid for x in eng._admission_order([r], step=0)] == [0]
    late = Request(rid=1, tokens=np.arange(3), max_new=2, arrival=3.0)
    early = Request(rid=7, tokens=np.arange(3), max_new=2, arrival=1.0)
    assert [x.rid for x in eng._admission_order([late, r, early])] == \
        [0, 7, 1]


def _ref_and_port_params(arch):
    rcfg = ref_configs.get_config(arch).smoke()
    pcfg = configs.get_config(arch).smoke()
    rp = ref_lm.init_lm(rcfg, jax.random.PRNGKey(0))
    pp = lm_params_from_numpy(pcfg, jax.tree.map(np.asarray, rp),
                              device="cpu")
    return rcfg, rp, pcfg, pp


def test_serving_engine_fifo_vs_coflow():
    """tests/test_partition_planner_serve.py::
    test_serving_engine_fifo_vs_coflow on the port: the light, high-weight
    request is admitted first, duplicate rids share one session job, and
    engines are reusable (a fresh session per run)."""
    cfg = configs.get_config("qwen3_1_7b").smoke()
    params = init_lm(cfg, torch.Generator().manual_seed(0))
    rng = np.random.default_rng(0)

    def reqs():
        return [Request(rid=i, tokens=rng.integers(1, cfg.vocab, size=6),
                        max_new=4, weight=float(1 + (i % 3)), arrival=0.0)
                for i in range(6)]

    eng = ServingEngine(cfg, params, ServeConfig(slots=2, capacity=32))
    assert eng.sc.admission == "coflow"             # the default
    heavy = Request(rid=1, tokens=rng.integers(1, cfg.vocab, size=18),
                    max_new=12, weight=0.1, arrival=1.0)
    light = Request(rid=2, tokens=rng.integers(1, cfg.vocab, size=3),
                    max_new=2, weight=100.0, arrival=1.0)
    order = eng._admission_order([heavy, light], step=1)
    assert [r.rid for r in order] == [2, 1]
    assert len(eng.admission_plan_s) == 1
    dup = Request(rid=2, tokens=rng.integers(1, cfg.vocab, size=3),
                  max_new=2, weight=100.0, arrival=1.0)
    assert len(eng._admission_order([light, dup], step=2)) == 2

    out = {}
    for mode in ("coflow", "fifo"):
        eng = ServingEngine(cfg, params, ServeConfig(slots=2, capacity=32,
                                                     admission=mode))
        out[mode] = eng.run(reqs())
        assert out[mode]["completed"] == 6
        assert eng.run(reqs())["completed"] == 6
    assert out["coflow"]["steps"] > 0
    assert str(eng._session.device) == "cpu"


def test_coflow_serve_equals_reference():
    """The same requests through the reference's engine and the port's,
    both with coflow admission: the admission order at every tick, the
    token streams and the serve statistics are equal."""
    rcfg, rp, pcfg, pp = _ref_and_port_params("qwen3_1_7b")
    want_reqs = _requests(RefRequest, rcfg)
    ref_eng = RefServingEngine(rcfg, rp, RefServeConfig(slots=3,
                                                        capacity=32))
    got_reqs = _requests(Request, pcfg)
    eng = ServingEngine(pcfg, pp, ServeConfig(slots=3, capacity=32))
    for step in range(5):
        a = ref_eng._admission_order(list(want_reqs), step)
        b = eng._admission_order(list(got_reqs), step)
        assert [r.rid for r in b] == [r.rid for r in a], step
    want = ref_eng.run(want_reqs)
    got = eng.run(got_reqs)
    assert got == want and got["completed"] == 7
    for g, w in zip(got_reqs, want_reqs):
        assert g.out == w.out, g.rid
        assert (g.done, g.finish_step) == (w.done, w.finish_step)
    assert len(eng.admission_plan_s) == len({r.arrival for r in got_reqs})
    fifo = _requests(Request, pcfg)
    ServingEngine(pcfg, pp, ServeConfig(slots=3, capacity=32,
                                        admission="fifo")).run(fifo)
    assert [r.finish_step for r in fifo] != [r.finish_step for r in got_reqs]


def test_backpressure_validation_and_deferral_as_reference():
    """ServeConfig validates ``backpressure`` as the reference does; with a
    policy whose budget the first full replan exceeds, due requests are
    held (counted in the session's ``admission_deferred``) exactly where
    the reference's engine holds them, and every request still serves."""
    from repro.core import AdmissionPolicy as RefAdmissionPolicy
    from repro_torch.core import AdmissionPolicy

    with pytest.raises(TypeError, match="backpressure"):
        ServeConfig(backpressure=0.5)
    with pytest.raises(TypeError, match="backpressure"):
        ServeConfig(backpressure=RefAdmissionPolicy())
    rcfg, rp, pcfg, pp = _ref_and_port_params("qwen3_1_7b")
    kw = dict(max_pending=4, replan_budget=0.0, window=2)
    ref_eng = RefServingEngine(rcfg, rp, RefServeConfig(
        slots=2, capacity=32, backpressure=RefAdmissionPolicy(**kw)))
    eng = ServingEngine(pcfg, pp, ServeConfig(
        slots=2, capacity=32, backpressure=AdmissionPolicy(**kw)))
    want_reqs, got_reqs = _requests(RefRequest, rcfg), _requests(Request, pcfg)
    want, got = ref_eng.run(want_reqs), eng.run(got_reqs)
    assert got == want and got["completed"] == 7
    deferred = eng._session.stats.admission_deferred
    assert deferred == ref_eng._session.stats.admission_deferred > 0
    assert [r.out for r in got_reqs] == [r.out for r in want_reqs]


def test_pad_cache_pads_to_capacity():
    cfg = configs.get_config("qwen3_1_7b").smoke()
    params = init_lm(cfg, torch.Generator().manual_seed(0))
    eng = ServingEngine(cfg, params, ServeConfig(capacity=20,
                                                 admission="fifo"))
    k = torch.ones((2, 1, 6, 2, 16))
    out = eng._pad_cache({"layers": {"l0": {"k": k, "v": k}}, "length": 6},
                         6)
    assert out["layers"]["l0"]["k"].shape == (2, 1, 20, 2, 16)
    assert torch.equal(out["layers"]["l0"]["k"][:, :, :6], k)
    assert out["layers"]["l0"]["k"][:, :, 6:].abs().sum() == 0
    assert out["length"] == 6


def test_pad_cache_keeps_a_mamba_state_whose_heads_equal_the_prompt():
    """A mamba layer's h (nP, B, H, N, P) has H on axis 2; a prompt of H
    tokens must not pad it (the reference's shape test does)."""
    cfg = configs.get_config("mamba2_2_7b").smoke()
    params = init_lm(cfg, torch.Generator().manual_seed(0))
    eng = ServingEngine(cfg, params, ServeConfig(capacity=64,
                                                 admission="fifo"))
    h = torch.ones((2, 1, 16, 16, 8))
    conv = torch.ones((2, 1, 3, 160))
    out = eng._pad_cache({"layers": {"l0": {"h": h, "conv": conv}},
                          "length": 16}, 16)
    assert out["layers"]["l0"]["h"] is h
    assert out["layers"]["l0"]["conv"] is conv


def test_prompt_of_exactly_h_tokens_serves_as_teacher_forcing():
    """mamba2 smoke has H = 16 SSD heads.  A 16-token prompt serves on the
    port, and its token stream is greedy decoding from lm_forward's
    teacher-forced logits.  The reference engine fails on the same request:
    its _pad_cache pads h along its heads."""
    arch = "mamba2_2_7b"
    rcfg = ref_configs.get_config(arch).smoke()
    pcfg = configs.get_config(arch).smoke()
    H = pcfg.ssm.expand * pcfg.d_model // pcfg.ssm.d_head
    assert H == 16
    rp = ref_lm.init_lm(rcfg, jax.random.PRNGKey(0))
    pp = lm_params_from_numpy(pcfg, jax.tree.map(np.asarray, rp),
                              device="cpu")
    prompt = np.random.default_rng(4).integers(1, pcfg.vocab, size=H)
    r = Request(rid=0, tokens=prompt, max_new=8)
    stats = ServingEngine(pcfg, pp, ServeConfig(
        slots=2, capacity=32, admission="fifo")).run([r])
    assert stats["completed"] == 1 and len(r.out) == 8
    seq = torch.as_tensor(np.concatenate([prompt, r.out[:-1]]))[None]
    logits, _ = lm_forward(pcfg, pp, seq)
    greedy = logits[0, H - 1:, :pcfg.vocab].argmax(dim=-1).tolist()
    assert greedy == r.out
    with pytest.raises((TypeError, ValueError)):
        RefServingEngine(rcfg, rp, RefServeConfig(
            slots=2, capacity=32, admission="fifo")).run(
                [RefRequest(rid=0, tokens=prompt, max_new=8)])


def test_launcher_equals_reference_launcher(monkeypatch, capsys):
    """The same CLI on the CPU: fifo statistics equal the reference
    launcher's (they depend on the requests, not on the weights)."""
    launch.main(["--requests", "5", "--max-new", "4", "--device", "cpu",
                 "--admission", "fifo"])
    got = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    monkeypatch.setattr("sys.argv", ["serve", "--requests", "5",
                                     "--max-new", "4", "--admission", "fifo"])
    ref_launch.main()
    want = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert got.pop("device") == "cpu"
    assert got == want and got["completed"] == 5


def test_launcher_serves_mamba2_as_reference_launcher(monkeypatch, capsys):
    """--arch mamba2-2.7b on the CPU: the reference launcher printed
    {"steps": 23, "completed": 8, "weighted_finish": 173.7017402627161}."""
    launch.main(["--arch", "mamba2-2.7b", "--device", "cpu",
                 "--admission", "fifo"])
    got = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    monkeypatch.setattr("sys.argv", ["serve", "--arch", "mamba2-2.7b",
                                     "--admission", "fifo"])
    ref_launch.main()
    want = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert got.pop("device") == "cpu"
    assert got == want
    assert (got["steps"], got["completed"]) == (23, 8)


@pytest.mark.parametrize("argv", [
    [], ["--admission", "coflow"], ["--requests", "5", "--max-new", "4"]])
def test_launcher_coflow_equals_reference_launcher(monkeypatch, capsys, argv):
    """``--admission`` defaults to ``coflow`` on both launchers, and the
    port's coflow statistics on the CPU equal the reference's."""
    launch.main(argv + ["--device", "cpu"])
    got = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    monkeypatch.setattr("sys.argv", ["serve"] + argv)
    ref_launch.main()
    want = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert got.pop("device") == "cpu"
    assert got == want and got["admission"] == "coflow"


def test_launcher_refuses_a_missing_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        launch.main(["--requests", "1"])
    with pytest.raises(SystemExit):
        launch.main(["--admission", "lifo", "--device", "cpu"])
