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
from repro_torch.models import init_lm, lm_params_from_numpy
from repro_torch.serve import Request, ServeConfig, ServingEngine

DENSE = ["qwen3_1_7b", "tinyllama_1_1b", "qwen2_5_32b"]


def _requests(cls, cfg, seed=0):
    """As repro.launch.serve builds them: staggered arrivals, random
    prompt lengths and weights."""
    rng = np.random.default_rng(seed)
    return [cls(rid=i, tokens=rng.integers(1, cfg.vocab,
                                           size=rng.integers(4, 17)),
                max_new=6, weight=float(rng.uniform(0.5, 2.0)),
                arrival=float(i // 2))
            for i in range(7)]


@pytest.mark.parametrize("arch", DENSE)
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


def test_launcher_refuses_coflow_and_missing_card(monkeypatch):
    with pytest.raises(SystemExit):
        launch.main(["--admission", "coflow", "--device", "cpu"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        launch.main(["--requests", "1"])
