"""The port's training substrate (src/repro_torch/train/, dist/compression.py,
models/lm.py's remat) against the reference's (src/repro/train/,
dist/compression.py) on the CPU.  States are the reference's carried across
as numpy (``train_state_from_numpy``); batches are made with numpy from a
seed and handed to both.

Tolerances: the learning rate and AdamW's update within 1e-6 relative
(float32, one update); compression equal (float32, ties included); a
family's loss within 1e-5 relative and each gradient leaf within 5e-5 of
that leaf's largest |gradient| (float32 smoke configs; the two frameworks
sum in other orders, the MoE and hybrid stacks furthest: 6e-6 measured).
Training over 3 steps: loss and grad norm within 1e-5 relative per step,
and the parameters within 3 x 2 lr of the reference's (AdamW's first steps
move an element by about lr sign(g), so an element whose gradient is near
0 and takes the other sign moves 2 lr the other way), nearly all of them
within 1e-5."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as ref_configs
from repro.data.pipeline import make_batch_specs as ref_batch_specs
from repro.dist.compression import compress_decompress as ref_compress
from repro.train import optim as ref_optim
from repro.train import step as ref_step
import repro_torch.configs as configs
from repro_torch.data.pipeline import DataConfig, SyntheticTokens
from repro_torch.dist.compression import compress_decompress
from repro_torch.models.convert import (train_state_from_numpy,
                                        train_state_to_numpy)
from repro_torch.models.lm import tree_leaves, tree_map
from repro_torch.train.optim import OptConfig, adamw_update, lr_at
from repro_torch.train.step import (_apply_bucket_order, _value_and_grad,
                                    build_train_step, init_train_state,
                                    leaf_paths, loss_for)

ARCHS = ["tinyllama-1.1b", "qwen3-1.7b", "granite-moe-3b", "mamba2-2.7b",
         "jamba-1.5-large", "whisper-large-v3", "llava-next-mistral-7b"]
OPT = dict(lr=1e-3, warmup_steps=2, total_steps=50)
CFG = configs.get_config("tinyllama-1.1b").smoke()


def _ref_state(rcfg):
    """The reference's initial state as numpy: (params, {"m", "v"})."""
    rs = ref_step.init_train_state(rcfg, jax.random.PRNGKey(0))
    params = jax.tree.map(np.asarray, rs.params)
    zeros = jax.tree.map(lambda a: np.zeros(a.shape, np.float32), params)
    return params, {"m": zeros, "v": zeros}


def _np_batch(rcfg, S, B, seed):
    """A batch in the family's layout (the reference's specs), numpy."""
    rng = np.random.default_rng(seed)
    batch = {}
    for key, spec in ref_batch_specs(rcfg, S, B).items():
        if key == "tokens":
            batch[key] = rng.integers(1, rcfg.vocab, size=spec.shape,
                                      dtype=np.int32)
        elif key != "labels":
            batch[key] = (rng.normal(size=spec.shape) * 0.02).astype(
                np.float32)
    t = batch["tokens"]
    batch["labels"] = np.concatenate(
        [t[:, 1:], np.full((t.shape[0], 1), -1, np.int32)], axis=1)
    return batch


def _jax(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _torch(batch):
    return {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}


def _rel(a, b) -> float:
    return abs(float(a) - float(b)) / max(abs(float(b)), 1e-30)


# --- optimizer ---------------------------------------------------------------

@pytest.mark.parametrize("step", [0, 1, 2, 26, 50, 60])
def test_lr_at_equals_reference(step):
    """Step 0 (0.0), the first warmup step, the end of warmup, mid-cosine,
    total_steps and past it."""
    want = float(ref_optim.lr_at(ref_optim.OptConfig(**OPT),
                                 jnp.asarray(step)))
    for s in (step, torch.tensor(step)):
        got = lr_at(OptConfig(**OPT), s)
        assert got.dtype == torch.float32
        assert abs(float(got) - want) <= 1e-6 * abs(want)
    if step == 0:
        assert float(lr_at(OptConfig(**OPT), 0)) == 0.0


@pytest.mark.parametrize("grad_scale", [1e-3, 100.0])
def test_adamw_update_equals_reference(grad_scale):
    """One update from step 3 on identical numpy trees, the clip not
    engaged (small gradients) and engaged: parameters, moments, grad norm
    and lr within 1e-6 relative."""
    rng = np.random.default_rng(1)
    shapes = {"a": (7, 5), "b": {"c": (11,), "d": (3, 4, 2)}}

    def tree(f):
        def walk(s):
            return {k: walk(v) for k, v in s.items()} \
                if isinstance(s, dict) else f(s)
        return walk(shapes)

    params = tree(lambda s: rng.normal(size=s).astype(np.float32))
    grads = tree(lambda s: (rng.normal(size=s) * grad_scale)
                 .astype(np.float32))
    m = tree(lambda s: (rng.normal(size=s) * 0.01).astype(np.float32))
    v = tree(lambda s: rng.random(size=s).astype(np.float32) * 1e-3)
    cfg = dict(lr=1e-3, warmup_steps=2, total_steps=50)
    rp, ro, rstats = ref_optim.adamw_update(
        jax.tree.map(jnp.asarray, params), jax.tree.map(jnp.asarray, grads),
        {"m": jax.tree.map(jnp.asarray, m), "v": jax.tree.map(jnp.asarray, v),
         "step": jnp.asarray(3, jnp.int32)}, ref_optim.OptConfig(**cfg))
    t = lambda tr: tree_map(lambda a: torch.from_numpy(a.copy()), tr)  # noqa
    pp, po, pstats = adamw_update(
        t(params), t(grads), {"m": t(m), "v": t(v),
                              "step": torch.tensor(3, dtype=torch.int32)},
        OptConfig(**cfg))
    assert (float(rstats["grad_norm"]) > 1.0) == (grad_scale > 1)
    assert _rel(pstats["grad_norm"], rstats["grad_norm"]) <= 1e-6
    assert _rel(pstats["lr"], rstats["lr"]) <= 1e-6
    assert int(po["step"]) == int(ro["step"]) == 4
    for got, want in ((pp, rp), (po["m"], ro["m"]), (po["v"], ro["v"])):
        for g, w in zip(tree_leaves(got), jax.tree.leaves(want)):
            w = np.asarray(w)
            assert np.abs(g.numpy() - w).max() <= 1e-6 * np.abs(w).max()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_adamw_slices_change_no_bit(dtype, monkeypatch):
    """AdamW updates a leaf in slices of its leading dim (SLICE elements at
    most, so a stacked leaf's float32 temporaries stay small); the update
    is elementwise, so any slicing gives the same bits as one slice: a
    3-d leaf, a 0-d leaf and a vector, bf16 and float32 parameters."""
    from repro_torch.train import optim
    from repro_torch.train.optim import adamw_init

    rng = np.random.default_rng(4)
    shapes = {"a": (70, 3, 5), "b": (), "c": (9,)}
    base = {k: torch.from_numpy(rng.normal(size=s).astype(np.float32))
            .to(dtype) for k, s in shapes.items()}
    grads = {k: torch.from_numpy(rng.normal(size=s).astype(np.float32))
             .to(dtype) for k, s in shapes.items()}
    cfg = OptConfig(lr=1e-2, warmup_steps=1, total_steps=10)
    runs = []
    for slice_elems in (optim.SLICE, 7, 1):
        monkeypatch.setattr(optim, "SLICE", slice_elems)
        params = {k: v.clone() for k, v in base.items()}
        opt = adamw_init(params)
        for _ in range(2):
            params, opt, _ = adamw_update(params, grads, opt, cfg)
        runs.append((params, opt))
    for params, opt in runs[1:]:
        for key in shapes:
            assert torch.equal(params[key], runs[0][0][key])
            assert torch.equal(opt["m"][key], runs[0][1]["m"][key])
            assert torch.equal(opt["v"][key], runs[0][1]["v"][key])
    assert not torch.equal(runs[0][0]["a"], base["a"])


def test_compress_decompress_equals_reference():
    """Per-tensor int8 quantise-dequantise, equal to the reference's on
    float32 leaves, the ties x.5 (round half to even) included; an int
    leaf passes through."""
    rng = np.random.default_rng(2)
    ties = np.array([127.0, 2.5, -3.5, 0.5, -0.5, 1.5, 64.5, -126.5],
                    np.float32)
    grads = {"ties": ties, "w": rng.normal(size=(9, 13)).astype(np.float32),
             "zero": np.zeros((4,), np.float32),
             "ids": np.arange(5, dtype=np.int32)}
    want = ref_compress(jax.tree.map(jnp.asarray, grads))
    got = compress_decompress(tree_map(torch.from_numpy, grads))
    for key in grads:
        assert np.array_equal(got[key].numpy(), np.asarray(want[key])), key
    assert got["ids"].dtype == torch.int32
    assert got["ties"].tolist()[1:5] == [2.0, -4.0, 0.0, -0.0]


# --- losses and gradients per family ----------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_equal_reference(arch):
    """loss_for(cfg) and its gradient, against jax.value_and_grad of the
    reference's, from the reference's parameters on one numpy batch."""
    rcfg = ref_configs.get_config(arch).smoke()
    pcfg = configs.get_config(arch).smoke()
    params, opt = _ref_state(rcfg)
    state = train_state_from_numpy(pcfg, params, opt, 0, "cpu")
    batch = _np_batch(rcfg, 24, 2, seed=3)
    rloss, rgrads = jax.jit(jax.value_and_grad(ref_step.loss_for(rcfg)))(
        jax.tree.map(jnp.asarray, params), _jax(batch))
    ploss, pgrads = _value_and_grad(loss_for(pcfg), state.params,
                                    _torch(batch))
    assert _rel(ploss, rloss) <= 1e-5
    paths = leaf_paths(pgrads)
    rleaves = jax.tree.leaves(rgrads)
    assert len(paths) == len(rleaves)
    for path, g, w in zip(paths, tree_leaves(pgrads), rleaves):
        w = np.asarray(w)
        assert g.shape == w.shape and g.dtype == torch.float32, path
        assert np.abs(g.numpy() - w).max() <= 5e-5 * np.abs(w).max(), path


def test_train_step_equals_reference_over_three_steps():
    """build_train_step over 3 steps from one state carried across, the
    same batches: loss and grad norm per step, then the parameters."""
    rcfg = ref_configs.get_config("tinyllama-1.1b").smoke()
    params, opt = _ref_state(rcfg)
    state = train_state_from_numpy(CFG, params, opt, 0, "cpu")
    rstate = ref_step.TrainState(
        params=jax.tree.map(jnp.asarray, params),
        opt={"m": jax.tree.map(jnp.asarray, opt["m"]),
             "v": jax.tree.map(jnp.asarray, opt["v"]),
             "step": jnp.asarray(0, jnp.int32)},
        step=jnp.asarray(0, jnp.int32))
    rstep = jax.jit(ref_step.build_train_step(rcfg,
                                              ref_optim.OptConfig(**OPT)))
    pstep = build_train_step(CFG, OptConfig(**OPT))
    for i in range(3):
        batch = _np_batch(rcfg, 32, 4, seed=10 + i)
        rstate, rm = rstep(rstate, _jax(batch))
        state, pm = pstep(state, _torch(batch))
        assert _rel(pm["loss"], rm["loss"]) <= 1e-5
        assert _rel(pm["grad_norm"], rm["grad_norm"]) <= 1e-5
        assert _rel(pm["lr"], rm["lr"]) <= 1e-6
        assert int(pm["step"]) == int(rm["step"]) == i + 1
    got = np.concatenate([x.ravel() for x in jax.tree.leaves(
        train_state_to_numpy(state)[0])])
    want = np.concatenate([np.asarray(x).ravel()
                           for x in jax.tree.leaves(rstate.params)])
    diff = np.abs(got - want)
    assert diff.max() <= 3 * 2 * OPT["lr"] + 1e-5
    assert (diff <= 1e-5).mean() >= 0.999


# --- the reference's own checks, on the port ---------------------------------

def _data(S=32, B=4):
    return SyntheticTokens(CFG, DataConfig(seq_len=S, global_batch=B, seed=0))


def _fresh():
    return init_train_state(CFG, torch.Generator().manual_seed(0))


def test_loss_decreases_over_training():
    step = build_train_step(CFG, OptConfig(**OPT))
    state, data = _fresh(), _data()
    losses = []
    for i in range(25):
        state, metrics = step(state, data.batch_at(i))
        losses.append(float(metrics["loss"]))
    assert np.mean(losses[-5:]) < np.mean(losses[:5]) - 0.05


def test_microbatching_matches_full_batch():
    b = _data(B=8).batch_at(0)
    s1, m1 = build_train_step(CFG, OptConfig(**OPT))(_fresh(), b)
    s2, m2 = build_train_step(CFG, OptConfig(**OPT), micro_steps=4)(
        _fresh(), b)
    assert abs(float(m1["loss"]) - float(m2["loss"])) < 1e-3
    diff = max(float((a - c).abs().max()) for a, c in
               zip(tree_leaves(s1.params), tree_leaves(s2.params)))
    assert diff < 5e-3


def test_bucket_order_is_numerically_neutral():
    """Reversed buckets walk in their order and change no bit; unknown
    paths are skipped, as the reference skips them."""
    b = _data().batch_at(0)
    paths = leaf_paths(_fresh().params)
    order = [paths[len(paths) // 2:] + ["no/such/leaf"],
             paths[: len(paths) // 2]]
    s1, m1 = build_train_step(CFG, OptConfig(**OPT))(_fresh(), b)
    s2, m2 = build_train_step(CFG, OptConfig(**OPT), bucket_order=order)(
        _fresh(), b)
    assert float(m1["loss"]) == float(m2["loss"])
    for a, c in zip(tree_leaves(s1.params), tree_leaves(s2.params)):
        assert torch.equal(a, c)
    grads = {p: torch.zeros(1) for p in ("x", "y", "z")}
    assert _apply_bucket_order(grads, [["z", "w"], ["x", "y"]]) is grads


def test_grad_compression_trains():
    step = build_train_step(CFG, OptConfig(**OPT), grad_compression=True)
    state, data = _fresh(), _data()
    for i in range(8):
        state, metrics = step(state, data.batch_at(i))
    assert np.isfinite(float(metrics["loss"]))


def test_remat_policies_give_equal_gradients():
    """remat "none", "full" and "dots" keep different things for the
    backward pass and give the same gradients."""
    b = _data().batch_at(0)
    params = _fresh().params
    grads = {}
    for remat in ("none", "full", "dots"):
        cfg = CFG.replace(remat=remat)
        grads[remat] = tree_leaves(_value_and_grad(loss_for(cfg), params,
                                                   b)[1])
    for remat in ("full", "dots"):
        for a, c in zip(grads["none"], grads[remat]):
            assert torch.allclose(a, c, rtol=0, atol=1e-7), remat
