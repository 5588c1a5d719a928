"""The port's checkpoints, fault-tolerant runner and training launcher
(src/repro_torch/ckpt/, ft/, launch/train.py) on the CPU: the reference's
checks of tests/test_train_ckpt_ft.py on the port, and the port against the
reference where they meet: checkpoints written by one and read by the other
(the same files, bfloat16 leaves included), the planned bucket order, and
the launcher's summary."""
import json
import re
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as ref_configs
from repro.ckpt import restore as ref_restore
from repro.ckpt import save as ref_save
from repro.launch import train as ref_launch
from repro.train import step as ref_step
import repro_torch.configs as configs
from repro_torch.ckpt import CheckpointManager, latest_step, restore, save
from repro_torch.ckpt.checkpoint import named_leaves
from repro_torch.data.pipeline import DataConfig
from repro_torch.ft import FTConfig, StragglerMonitor, TrainRunner
from repro_torch.launch.train import planned_bucket_order
from repro_torch.models.convert import train_state_from_numpy
from repro_torch.models.lm import tree_leaves
from repro_torch.train.optim import OptConfig
from repro_torch.train.step import init_train_state, leaf_paths

ROOT = Path(__file__).resolve().parents[1]
CFG = configs.get_config("tinyllama-1.1b").smoke()
OPT = OptConfig(lr=1e-3, warmup_steps=2, total_steps=50)


def _state(cfg=CFG):
    return init_train_state(cfg, torch.Generator().manual_seed(0))


def _leaves(state) -> list:
    return [leaf for _, leaf in named_leaves(state)]


def _runner(tmp_path, d, hook=None, order=None, every=3):
    return TrainRunner(CFG, OPT, DataConfig(seq_len=32, global_batch=4,
                                            seed=0),
                       FTConfig(ckpt_dir=str(tmp_path / d),
                                ckpt_every=every),
                       fault_hook=hook, bucket_order=order, device="cpu")


def test_save_restore_roundtrip(tmp_path):
    state = _state()
    save(state, tmp_path, 7, extra={"note": "x"})
    assert latest_step(tmp_path) == 7
    like = init_train_state(CFG, None, device="meta")
    restored, manifest = restore(like, tmp_path)
    assert manifest["step"] == 7 and manifest["extra"] == {"note": "x"}
    for a, b in zip(_leaves(restored), _leaves(state)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    names = [n for n, _ in named_leaves(state)]
    assert names[0] == "0.embed" and names[-1] == "2"
    assert "1.step" in names and "1.m.embed" in names


def test_checkpoint_retention_and_async(tmp_path):
    """Retention keeps the newest two; an async write holds the state as it
    was at maybe_save, though the next step writes into its tensors at
    once."""
    mgr = CheckpointManager(tmp_path, every=1, keep=2, async_write=True)
    state = _state()
    before = [x.clone() for x in _leaves(state)]
    for s in (1, 2, 3, 4):
        mgr.maybe_save(state, s)
    for x in _leaves(state):
        x.add_(1)                      # what the next step does in place
    mgr.wait()
    assert latest_step(tmp_path) == 4
    steps = sorted(p.name for p in tmp_path.iterdir()
                   if re.fullmatch(r"step_\d+", p.name))
    assert len(steps) == 2
    restored, _ = restore(init_train_state(CFG, None, device="meta"),
                          tmp_path)
    for a, b in zip(_leaves(restored), before):
        assert torch.equal(a, b)


def test_crash_resume_bit_exact(tmp_path):
    class Boom(Exception):
        pass

    def hook(step):
        if step == 7:
            raise Boom()

    with pytest.raises(Boom):
        _runner(tmp_path, "a", hook).run(12)
    r2 = _runner(tmp_path, "a")
    resumed = r2.run(12)
    assert r2.metrics_log[0]["step"] == 6   # resumed from step-6 checkpoint
    clean = _runner(tmp_path, "b").run(12)
    for a, b in zip(_leaves(resumed), _leaves(clean)):
        assert torch.equal(a, b)


def test_straggler_monitor():
    mon = StragglerMonitor(factor=3.0)
    for s in range(10):
        assert not mon.observe(s, 0.1)
    assert mon.observe(10, 1.0)       # 10x the EWMA -> flagged
    assert mon.flagged == [(10, 1.0)]
    assert not mon.observe(11, 0.1)   # baseline not poisoned


def _bf16_pair():
    """One bfloat16 smoke state in both packages: the reference's init,
    carried to the port."""
    rcfg = ref_configs.get_config("tinyllama-1.1b").smoke().replace(
        param_dtype="bfloat16")
    pcfg = CFG.replace(param_dtype="bfloat16")
    rs = ref_step.init_train_state(rcfg, jax.random.PRNGKey(0))
    rs.opt["m"] = jax.tree.map(lambda p: jnp.full(p.shape, 0.25, jnp.float32),
                               rs.params)
    rs.opt["step"] = jnp.asarray(5, jnp.int32)
    rs.step = jnp.asarray(5, jnp.int32)
    host = jax.tree.map(np.asarray, (rs.params, rs.opt))
    ps = train_state_from_numpy(pcfg, host[0], host[1], 5, "cpu")
    return rcfg, pcfg, rs, ps


def test_reference_checkpoint_restores_bit_equal_in_the_port(tmp_path):
    """A bfloat16 state written by the reference and read by the port:
    every leaf's bits and type."""
    rcfg, pcfg, rs, _ = _bf16_pair()
    ref_save(rs, tmp_path, 5)
    like = init_train_state(pcfg, None, device="meta")
    restored, manifest = restore(like, tmp_path)
    assert manifest["step"] == 5
    want = [np.asarray(x) for x in jax.tree.leaves(rs)]
    got = _leaves(restored)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        if str(w.dtype) == "bfloat16":
            assert g.dtype == torch.bfloat16
            assert np.array_equal(g.view(torch.int16).numpy(),
                                  w.view(np.int16))
        else:
            assert np.array_equal(g.numpy(), w)


def test_port_checkpoint_is_the_reference_checkpoint(tmp_path):
    """The port writes the reference's files: the same manifest and the
    same npy bytes for a bfloat16 state (descr '<V2', dtype "bfloat16").
    The reference's own restore cannot read a bfloat16 leaf back (numpy
    has no cast from '<V2'), from either package's files; a float32 state
    written by the port restores in the reference bit for bit."""
    rcfg, pcfg, rs, ps = _bf16_pair()
    ref_save(rs, tmp_path / "ref", 5)
    save(ps, tmp_path / "port", 5)
    a, b = tmp_path / "ref" / "step_00000005", tmp_path / "port" / \
        "step_00000005"
    assert sorted(p.name for p in a.iterdir()) == \
        sorted(p.name for p in b.iterdir())
    for p in a.iterdir():
        assert p.read_bytes() == (b / p.name).read_bytes(), p.name
    like = jax.eval_shape(lambda: ref_step.init_train_state(
        rcfg, jax.random.PRNGKey(0)))
    with pytest.raises(ValueError, match="cast"):
        ref_restore(like, tmp_path / "port")
    # float32: the reference reads the port's checkpoint
    rcfg32 = ref_configs.get_config("tinyllama-1.1b").smoke()
    state = _state()
    save(state, tmp_path / "f32", 3)
    like = jax.eval_shape(lambda: ref_step.init_train_state(
        rcfg32, jax.random.PRNGKey(0)))
    restored, manifest = ref_restore(like, tmp_path / "f32")
    assert manifest["step"] == 3
    for g, w in zip(jax.tree.leaves(restored), _leaves(state)):
        assert np.array_equal(np.asarray(g), w.numpy())


def test_planned_bucket_order_equals_reference_and_is_neutral(tmp_path):
    """The planner's bucket lists equal the reference's for the smoke
    config (the same leaves in the same order, planned alike), cover every
    gradient leaf once, and a planned runner trains bit for bit as an
    unplanned one."""
    order, outcome = planned_bucket_order(CFG, 4, seed=0, device="cpu")
    rorder, routcome = ref_launch.planned_bucket_order(
        ref_configs.get_config("tinyllama-1.1b").smoke(), 4, seed=0)
    assert order == rorder and outcome.order == routcome.order
    assert outcome.makespan_gain == routcome.makespan_gain
    assert outcome.session is not None and outcome.session.done
    flat = [p for bucket in order for p in bucket]
    assert sorted(flat) == sorted(leaf_paths(_state().params))
    planned = _runner(tmp_path, "planned", order=order, every=10).run(2)
    plain = _runner(tmp_path, "plain", every=10).run(2)
    for a, b in zip(tree_leaves(planned.params), tree_leaves(plain.params)):
        assert torch.equal(a, b)


def test_launcher_prints_the_reference_summary(tmp_path, capsys):
    """``python -m repro_torch.launch.train`` trains the smoke config and
    prints a JSON summary with the reference launcher's keys."""
    argv = ["--arch", "tinyllama-1.1b", "--smoke", "--steps", "3",
            "--seq-len", "16", "--global-batch", "2", "--plan-buckets", "4"]
    env = {"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin"}
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", *argv,
         "--device", "cpu", "--ckpt-dir", str(tmp_path / "port")],
        capture_output=True, text=True, env=env, timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stderr
    got = json.loads(out.stdout.strip().splitlines()[-1])
    sys_argv = sys.argv
    sys.argv = ["train", *argv, "--ckpt-dir", str(tmp_path / "ref")]
    try:
        ref_launch.main()
    finally:
        sys.argv = sys_argv
    want = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert list(got) == list(want)
    assert got["arch"] == want["arch"] and got["steps"] == 3
    assert got["bucket_order"] == want["bucket_order"]
    assert np.isfinite(got["first_loss"]) and np.isfinite(got["last_loss"])
