"""The port's serving engine (src/repro_torch/serve) and launcher against
the reference's on the CPU: the same requests through fifo admission, with
the reference's parameters carried across by ``lm_params_from_numpy``, must
give identical token streams and identical serve statistics (greedy argmax
of logits that agree to 1e-4 in float32)."""
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


def test_coflow_admission_and_backpressure_wait_for_the_session():
    cfg = configs.get_config("qwen3_1_7b").smoke()
    params = init_lm(cfg, torch.Generator().manual_seed(0))
    with pytest.raises(NotImplementedError, match="item 6"):
        ServingEngine(cfg, params, ServeConfig())       # "coflow" default
    with pytest.raises(NotImplementedError, match="item 6"):
        ServingEngine(cfg, params, ServeConfig(admission="fifo",
                                               backpressure=object()))


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
    launch.main(["--requests", "5", "--max-new", "4", "--device", "cpu"])
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
    launch.main(["--arch", "mamba2-2.7b", "--device", "cpu"])
    got = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    monkeypatch.setattr("sys.argv", ["serve", "--arch", "mamba2-2.7b",
                                     "--admission", "fifo"])
    ref_launch.main()
    want = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert got.pop("device") == "cpu"
    assert got == want
    assert (got["steps"], got["completed"]) == (23, 8)


def test_launcher_refuses_coflow_and_missing_card(monkeypatch):
    with pytest.raises(SystemExit):
        launch.main(["--admission", "coflow", "--device", "cpu"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        launch.main(["--requests", "1"])
