"""The port's encoder-decoder (src/repro_torch/models/encdec.py) against
the reference's (src/repro/models/encdec.py) on the CPU, whisper-large-v3's
smoke config.  Parameters are the reference's ``init_encdec`` pytree
carried across by ``encdec_params_from_numpy``; frames and tokens are made
with numpy from a seed.  Tolerances as in tests/test_torch_models.py
(float32): 1e-5 for a single function, 1e-4 for whole-model logits and
caches, the reference's 2e-3 for decode against the forward."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as ref_configs
from repro.models import encdec as ref_encdec
import repro_torch.configs as configs
from repro_torch.models import (encdec_decode_step, encdec_forward,
                                encdec_loss, encdec_params_from_numpy,
                                encdec_prefill, init_encdec,
                                init_encdec_cache, lm_params_to_numpy)
from repro_torch.models import encdec
from repro_torch.models.lm import tree_leaves

ARCH = "whisper_large_v3"


def _np(x) -> np.ndarray:
    return np.asarray(x, dtype=np.float32)


def _t(x) -> torch.Tensor:
    return torch.as_tensor(np.array(x))


def _both(dtype="float32", seed=0):
    rcfg = ref_configs.get_config(ARCH).smoke().replace(param_dtype=dtype)
    pcfg = configs.get_config(ARCH).smoke().replace(param_dtype=dtype)
    rp = jax.tree.map(np.asarray, ref_encdec.init_encdec(
        rcfg, jax.random.PRNGKey(seed)))
    return rcfg, pcfg, rp, encdec_params_from_numpy(pcfg, rp, device="cpu")


def _inputs(cfg, B=2, S=12, seed=0):
    rng = np.random.default_rng(seed)
    frames = rng.normal(size=(B, cfg.encoder_seq, cfg.d_model)) \
        .astype(np.float32)
    return frames, rng.integers(0, cfg.vocab, size=(B, S))


@pytest.mark.parametrize("d,n", [(64, 16), (1280, 1500), (7, 5)])
def test_sinusoidal_equals_reference(d, n):
    """At whisper's width and 1500 frames too: the angles reach 1499, so
    the last bits of exp show as 1e-4 in sin and cos there."""
    pos = np.broadcast_to(np.arange(n), (2, n))
    got = encdec.sinusoidal(_t(pos), d, torch.float32)
    want = ref_encdec.sinusoidal(jnp.asarray(pos), d, jnp.float32)
    assert got.shape == want.shape == (2, n, 2 * (d // 2))
    tol = 1e-5 if n < 100 else 1e-3
    assert np.abs(got.numpy() - _np(want)).max() < tol


def test_init_encdec_matches_reference_shapes_and_scales():
    rcfg = ref_configs.get_config(ARCH).smoke()
    pcfg = configs.get_config(ARCH).smoke()
    want = jax.tree.map(np.asarray, ref_encdec.init_encdec(
        rcfg, jax.random.PRNGKey(0)))
    got = lm_params_to_numpy(init_encdec(pcfg,
                                         torch.Generator().manual_seed(3)))
    flat_w = jax.tree_util.tree_flatten_with_path(want)[0]
    flat_g = jax.tree_util.tree_flatten_with_path(got)[0]
    assert [p for p, _ in flat_w] == [p for p, _ in flat_g]
    for (path, w), (_, g) in zip(flat_w, flat_g):
        assert g.shape == w.shape and g.dtype == w.dtype, path
        if w.std() == 0:
            assert np.array_equal(g, w), path
        else:
            assert abs(g.std() / w.std() - 1) < 0.1, path


def test_full_width_shapes_equal_reference():
    """whisper-large-v3 at full width, shapes only (``meta``)."""
    rcfg = ref_configs.get_config(ARCH)
    pcfg = configs.get_config(ARCH)
    want = jax.eval_shape(lambda: ref_encdec.init_encdec(
        rcfg, jax.random.PRNGKey(0)))
    got = init_encdec(pcfg, None, device="meta")
    assert [tuple(t.shape) for t in tree_leaves(got)] == \
        [tuple(x.shape) for x in jax.tree.leaves(want)]
    assert sum(t.numel() for t in tree_leaves(got)) == \
        sum(int(np.prod(x.shape)) for x in jax.tree.leaves(want))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_encdec_params_roundtrip_and_checks(dtype):
    rcfg, pcfg, rp, pp = _both(dtype)
    assert sorted(pp) == ["dec_stack", "embed", "enc_norm", "enc_stack",
                          "final_norm", "unembed"]
    assert sorted(pp["dec_stack"]) == ["attn", "cross", "mlp"]
    assert pp["embed"].dtype == (torch.float32 if dtype == "float32"
                                 else torch.bfloat16)
    back = lm_params_to_numpy(pp)
    for a, b in zip(jax.tree.leaves(rp), jax.tree.leaves(back)):
        assert np.array_equal(a.astype(np.float32), b)
    bad = dict(rp, enc_stack={"attn": rp["enc_stack"]["attn"]})
    with pytest.raises(ValueError, match="keys"):
        encdec_params_from_numpy(pcfg, bad, device="cpu")


def test_encode_equals_reference():
    rcfg, pcfg, rp, pp = _both()
    frames, _ = _inputs(pcfg)
    got = encdec.encode(pcfg, pp, _t(frames))
    want = ref_encdec.encode(rcfg, rp, jnp.asarray(frames))
    assert np.abs(got.numpy() - _np(want)).max() < 1e-4


def test_encdec_forward_equals_reference():
    rcfg, pcfg, rp, pp = _both()
    frames, toks = _inputs(pcfg)
    got = encdec_forward(pcfg, pp, _t(frames), _t(toks))
    want = ref_encdec.encdec_forward(rcfg, rp, jnp.asarray(frames),
                                     jnp.asarray(toks))
    assert got.shape == want.shape == (2, 12, pcfg.padded_vocab)
    assert np.abs(got.numpy() - _np(want)).max() < 1e-4


@pytest.mark.parametrize("masked", [0.0, 0.4, 1.0])
def test_encdec_loss_equals_reference(masked):
    """Labels of -1 ignored: none, two in five, all (the loss is then 0)."""
    rcfg, pcfg, rp, pp = _both()
    frames, toks = _inputs(pcfg, seed=1)
    labels = np.random.default_rng(2).integers(0, pcfg.vocab, toks.shape)
    labels[np.random.default_rng(3).random(labels.shape) < masked] = -1
    got = encdec_loss(pcfg, pp, _t(frames), _t(toks), _t(labels))
    want = ref_encdec.encdec_loss(rcfg, rp, jnp.asarray(frames),
                                  jnp.asarray(toks), jnp.asarray(labels))
    assert got.dtype == torch.float32
    assert abs(float(got) - float(want)) < 1e-5
    if masked == 1.0:
        assert float(got) == 0.0


def test_prefill_and_decode_equal_reference():
    rcfg, pcfg, rp, pp = _both()
    frames, toks = _inputs(pcfg, S=14)
    P, cap = 9, 16
    lg, cache = encdec_prefill(pcfg, pp, _t(frames), _t(toks[:, :P]),
                               capacity=cap)
    rlg, rcache = ref_encdec.encdec_prefill(rcfg, rp, jnp.asarray(frames),
                                            jnp.asarray(toks[:, :P]),
                                            capacity=cap)
    assert lg.shape == (2, pcfg.vocab)
    assert np.abs(lg.numpy() - _np(rlg)).max() < 1e-4

    def close(c, rc):
        assert sorted(c) == sorted(rc)
        assert c["length"] == int(rc["length"])
        for key in ("self_k", "self_v", "cross_k", "cross_v"):
            assert c[key].shape == rc[key].shape, key
            assert np.abs(c[key].numpy() - _np(rc[key])).max() < 1e-4, key

    close(cache, rcache)
    for t in range(P, toks.shape[1]):
        lg, cache = encdec_decode_step(pcfg, pp, cache,
                                       _t(toks[:, t:t + 1]))
        rlg, rcache = ref_encdec.encdec_decode_step(
            rcfg, rp, rcache, jnp.asarray(toks[:, t:t + 1]))
        assert np.abs(lg.numpy() - _np(rlg)).max() < 1e-4, t
    close(cache, rcache)


def test_encdec_decode_consistency():
    """tests/test_models.py::test_encdec_decode_consistency on the port:
    prefill then decode reproduce encdec_forward's logits (2e-3)."""
    cfg = configs.get_config(ARCH).smoke()
    params = init_encdec(cfg, torch.Generator().manual_seed(0))
    frames, toks = _inputs(cfg, S=12, seed=4)
    frames, toks = _t(frames), _t(toks)
    S = 12
    full = encdec_forward(cfg, params, frames, toks)
    lg, cache = encdec_prefill(cfg, params, frames, toks[:, :S - 3],
                               capacity=S)
    errs = [float((lg - full[:, S - 4, :cfg.vocab]).abs().max())]
    for t in range(S - 3, S):
        lg, cache = encdec_decode_step(cfg, params, cache, toks[:, t:t + 1])
        errs.append(float((lg - full[:, t, :cfg.vocab]).abs().max()))
    assert max(errs) < 2e-3, errs


def test_init_encdec_cache_equals_reference():
    pcfg = configs.get_config(ARCH).smoke()
    rcfg = ref_configs.get_config(ARCH).smoke()
    got = init_encdec_cache(pcfg, 3, 7, device="cpu")
    want = ref_encdec.init_encdec_cache(rcfg, 3, 7)
    assert sorted(got) == sorted(want)
    assert got["length"] == int(want["length"]) == 0
    for key in ("self_k", "self_v", "cross_k", "cross_v"):
        assert tuple(got[key].shape) == tuple(want[key].shape), key
        assert got[key].dtype == getattr(torch, str(want[key].dtype)), key


def test_decode_writes_the_self_cache_in_place():
    cfg = configs.get_config(ARCH).smoke()
    params = init_encdec(cfg, torch.Generator().manual_seed(0))
    frames, toks = _inputs(cfg, B=1, S=4)
    _, cache = encdec_prefill(cfg, params, _t(frames), _t(toks), capacity=8)
    k0 = cache["self_k"]
    assert k0[:, :, 4:].abs().sum() == 0
    _, new = encdec_decode_step(cfg, params, cache, torch.tensor([[3]]))
    assert new["self_k"] is k0 and new["length"] == 5
    assert k0[:, :, 4].abs().sum() > 0 and k0[:, :, 5:].abs().sum() == 0
    assert new["cross_k"] is cache["cross_k"]
