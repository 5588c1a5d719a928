"""The port's model stack (src/repro_torch/models, configs) against the
reference's (src/repro/models, configs) on the CPU.  Inputs are made with
numpy from a seed; parameters are the reference's ``init_lm`` pytree carried
across by ``lm_params_from_numpy``.  Tolerances: float32 configs, so the two
frameworks differ only in summation order and in the last bits of exp, pow
and rsqrt; 1e-5 for single layers and 1e-4 for whole-model logits and
caches, as the port's contract states; the teacher-forcing check keeps the
reference's own 2e-3 (tests/test_models.py)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as ref_configs
from repro.models import common as ref_common
from repro.models import layers as ref_layers
from repro.models import lm as ref_lm
import repro_torch.configs as configs
from repro_torch.models import (decode_step, init_decode_cache, init_lm,
                                lm_forward, lm_params_from_numpy,
                                lm_params_to_numpy, prefill)
from repro_torch.models import layers
from repro_torch.models.lm import tree_leaves, tree_map

DENSE = ["qwen3_1_7b", "tinyllama_1_1b", "qwen2_5_32b"]
# dense attention and mamba2 (attention-free SSD); the MoE stacks are in
# tests/test_torch_moe.py
MODELS = DENSE + ["mamba2_2_7b"]
KEY = jax.random.PRNGKey(0)


def _np(x) -> np.ndarray:
    return np.asarray(x, dtype=np.float32)


def _t(x) -> torch.Tensor:
    return torch.as_tensor(np.array(x))


def _ref_params(cfg, seed=0):
    return jax.tree.map(np.asarray, ref_lm.init_lm(cfg, jax.random.PRNGKey(seed)))


def _both(arch):
    """(reference cfg, port cfg, reference params, port params)."""
    rcfg = ref_configs.get_config(arch).smoke()
    pcfg = configs.get_config(arch).smoke()
    rp = _ref_params(rcfg)
    return rcfg, pcfg, rp, lm_params_from_numpy(pcfg, rp, device="cpu")


# --------------------------------------------------------------------------
# configs
# --------------------------------------------------------------------------

def test_registry_equals_reference():
    assert configs.ARCH_IDS == ref_configs.ARCH_IDS
    assert configs.ALIASES == ref_configs.ALIASES
    assert configs.list_configs() == ref_configs.list_configs()
    assert {k: dataclasses.asdict(v) for k, v in configs.SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in ref_configs.SHAPES.items()}


@pytest.mark.parametrize("arch", ref_configs.ARCH_IDS)
def test_config_equals_reference_field_for_field(arch):
    ref, got = ref_configs.get_config(arch), configs.get_config(arch)
    assert [f.name for f in dataclasses.fields(got)] == \
        [f.name for f in dataclasses.fields(ref)]
    assert dataclasses.asdict(got) == dataclasses.asdict(ref)
    assert dataclasses.asdict(got.smoke()) == dataclasses.asdict(ref.smoke())
    for prop in ("n_layers", "sub_quadratic", "padded_vocab"):
        assert getattr(got, prop) == getattr(ref, prop), prop
    assert configs.cells(arch) == ref_configs.cells(arch)
    for shape in configs.SHAPES:
        assert configs.shape_applicable(got, shape) == \
            ref_configs.shape_applicable(ref, shape)


def test_config_aliases_resolve_as_reference():
    for alias in configs.ALIASES:
        assert dataclasses.asdict(configs.get_config(alias)) == \
            dataclasses.asdict(ref_configs.get_config(alias))
    with pytest.raises(KeyError, match="unknown arch"):
        configs.get_config("gpt-5")


def test_dtypes_map_to_torch():
    assert set(ref_common.DTYPES) == set(layers.DTYPES)
    assert layers.DTYPES["float32"] is torch.float32
    assert layers.DTYPES["bfloat16"] is torch.bfloat16


@pytest.mark.parametrize("arch", MODELS + ["qwen3_4b"])
def test_param_count_equals_reference(arch):
    assert configs.get_config(arch).param_count() == \
        ref_configs.get_config(arch).param_count()


def test_qwen3_full_width_size():
    cfg = configs.get_config("qwen3_1_7b")
    assert cfg.param_count() == 2_031_732_736
    # KV cache bytes per token per slot: k and v, bf16, every layer
    assert 2 * cfg.n_layers * cfg.n_kv_heads * cfg.d_head * 2 == 114_688


# --------------------------------------------------------------------------
# parameters
# --------------------------------------------------------------------------

@pytest.mark.parametrize("arch", MODELS)
def test_init_lm_matches_reference_shapes_and_scales(arch):
    rcfg = ref_configs.get_config(arch).smoke()
    pcfg = configs.get_config(arch).smoke()
    want = _ref_params(rcfg)
    got = lm_params_to_numpy(init_lm(pcfg, torch.Generator().manual_seed(3)))
    flat_w = jax.tree_util.tree_flatten_with_path(want)[0]
    flat_g = jax.tree_util.tree_flatten_with_path(got)[0]
    assert [p for p, _ in flat_w] == [p for p, _ in flat_g]
    for (path, w), (_, g) in zip(flat_w, flat_g):
        assert g.shape == w.shape and g.dtype == w.dtype, path
        if w.std() == 0:                    # norms, biases, a_log, dt_bias
            assert np.array_equal(g, w), path
        else:                               # same scale, other bits
            assert abs(g.std() / w.std() - 1) < 0.1, path
            assert not np.array_equal(g, w), path


def test_params_roundtrip_and_checks():
    rcfg, pcfg, rp, pp = _both("qwen2_5_32b")
    back = lm_params_to_numpy(pp)
    for a, b in zip(jax.tree.leaves(rp), jax.tree.leaves(back)):
        assert np.array_equal(a, b)
    bad = dict(rp, embed=rp["embed"][:-1])
    with pytest.raises(ValueError, match="embed"):
        lm_params_from_numpy(pcfg, bad, device="cpu")
    with pytest.raises(ValueError, match="keys"):
        lm_params_from_numpy(pcfg, {"embed": rp["embed"]}, device="cpu")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mamba_params_roundtrip_keeps_float32_leaves(dtype):
    """mamba2's leaves cross both ways; a_log, dt_bias and d_skip stay
    float32 under a bfloat16 parameter type, as in the reference."""
    rcfg = ref_configs.get_config("mamba2_2_7b").smoke().replace(
        param_dtype=dtype)
    pcfg = configs.get_config("mamba2_2_7b").smoke().replace(
        param_dtype=dtype)
    rp = jax.tree.map(np.asarray, ref_lm.init_lm(rcfg, KEY))
    pp = lm_params_from_numpy(pcfg, rp, device="cpu")
    m = pp["stack"]["l0"]["mamba"]
    assert m["in_proj"].dtype == layers.DTYPES[dtype]
    for key in ("a_log", "dt_bias", "d_skip"):
        assert m[key].dtype == torch.float32, key
        assert rp["stack"]["l0"]["mamba"][key].dtype == np.float32, key
    back = lm_params_to_numpy(pp)
    for a, b in zip(jax.tree.leaves(rp), jax.tree.leaves(back)):
        assert b.dtype == np.float32
        assert np.array_equal(a.astype(np.float32), b)


def test_params_from_numpy_reads_bfloat16():
    cfg = configs.get_config("qwen3_1_7b").smoke().replace(
        param_dtype="bfloat16")
    rp = jax.tree.map(np.asarray, ref_lm.init_lm(
        ref_configs.get_config("qwen3_1_7b").smoke().replace(
            param_dtype="bfloat16"), KEY))
    pp = lm_params_from_numpy(cfg, rp, device="cpu")
    assert pp["embed"].dtype == torch.bfloat16
    assert np.array_equal(pp["embed"].float().numpy(),
                          rp["embed"].astype(np.float32))


# --------------------------------------------------------------------------
# layers
# --------------------------------------------------------------------------

def test_rms_norm_and_head_rms_equal_reference():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 5, 64)).astype(np.float32)
    scale = rng.normal(size=64).astype(np.float32)
    got = layers.rms_norm(_t(x), {"scale": _t(scale)}, 1e-6)
    want = ref_layers.rms_norm(jnp.asarray(x), {"scale": jnp.asarray(scale)},
                               1e-6)
    assert np.abs(got.numpy() - _np(want)).max() < 1e-5
    xh = rng.normal(size=(2, 5, 4, 16)).astype(np.float32)
    assert np.abs(layers._head_rms(_t(xh), 1e-6).numpy()
                  - _np(ref_layers._head_rms(jnp.asarray(xh), 1e-6))).max() \
        < 1e-5


@pytest.mark.parametrize("theta,start", [(1e6, 0), (1e4, 37)])
def test_rope_equals_reference(theta, start):
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 9, 4, 16)).astype(np.float32)
    pos = np.broadcast_to(np.arange(start, start + 9), (2, 9))
    got = layers.rope(_t(x), _t(pos), theta)
    want = ref_layers.rope(jnp.asarray(x), jnp.asarray(pos), theta)
    assert np.abs(got.numpy() - _np(want)).max() < 1e-5


@pytest.mark.parametrize("arch", DENSE)
def test_attn_and_mlp_blocks_equal_reference(arch):
    rcfg, pcfg, rp, pp = _both(arch)
    rng = np.random.default_rng(2)
    x = rng.normal(size=(2, 11, pcfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(11), (2, 11))
    ra = jax.tree.map(lambda a: a[0], rp["stack"]["l0"])
    pa = tree_map(lambda t: t[0], pp["stack"]["l0"])
    for causal in (True, False):
        got = layers.attn_block(pcfg, pa["attn"], _t(x), _t(pos), causal)
        want = ref_layers.attn_block(rcfg, ra["attn"], jnp.asarray(x),
                                     jnp.asarray(pos), causal)
        assert np.abs(got.numpy() - _np(want)).max() < 1e-5
    got = layers.mlp_block(pcfg, pa["mlp"], _t(x))
    want = ref_layers.mlp_block(rcfg, ra["mlp"], jnp.asarray(x))
    assert np.abs(got.numpy() - _np(want)).max() < 1e-5


@pytest.mark.parametrize("Sq,Sk,causal", [(7, 7, True), (5, 12, True),
                                          (9, 9, False), (2100, 2100, True)])
def test_attention_cpu_paths_equal_reference(Sq, Sk, causal):
    """The CPU path of layers.attention (_attn_ref, or _attn_chunked past
    2^22 score entries) against the reference's same functions."""
    cfg = configs.get_config("qwen3_1_7b").smoke()
    rng = np.random.default_rng(Sq)
    q = rng.normal(size=(1, Sq, 4, 16)).astype(np.float32)
    k = rng.normal(size=(1, Sk, 2, 16)).astype(np.float32)
    v = rng.normal(size=(1, Sk, 2, 16)).astype(np.float32)
    scale = 16 ** -0.5
    got = layers.attention(cfg, _t(q), _t(k), _t(v), causal)
    args = (jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal, scale)
    want = ref_layers._attn_ref(*args)
    assert np.abs(got.numpy() - _np(want)).max() < 1e-5
    got_c = layers._attn_chunked(_t(q), _t(k), _t(v), causal, scale, 64)
    want_c = ref_layers._attn_chunked(*args, 64)
    assert np.abs(got_c.numpy() - _np(want_c)).max() < 1e-5


@pytest.mark.parametrize("layout", ["heads", "dh", "seq"])
def test_decode_attention_equals_reference(layout):
    rng = np.random.default_rng(4)
    q = rng.normal(size=(2, 1, 4, 16)).astype(np.float32)
    kc = rng.normal(size=(2, 20, 2, 16)).astype(np.float32)
    vc = rng.normal(size=(2, 20, 2, 16)).astype(np.float32)
    got = layers.decode_attention(_t(q), _t(kc), _t(vc), 13, 0.25, layout)
    want = ref_layers.decode_attention(jnp.asarray(q), jnp.asarray(kc),
                                       jnp.asarray(vc), jnp.asarray(13),
                                       0.25, layout="heads")
    assert np.abs(got.numpy() - _np(want)).max() < 1e-5


# --------------------------------------------------------------------------
# the whole model: lm_forward, prefill, decode_step
# --------------------------------------------------------------------------

def _tokens(cfg, B, S, seed=1):
    return np.random.default_rng(seed).integers(0, cfg.vocab, size=(B, S))


@pytest.mark.parametrize("arch", MODELS)
def test_lm_forward_equals_reference(arch):
    rcfg, pcfg, rp, pp = _both(arch)
    toks = _tokens(pcfg, 2, 12)
    got, aux = lm_forward(pcfg, pp, _t(toks))
    want, raux = ref_lm.lm_forward(rcfg, rp, jnp.asarray(toks))
    assert got.shape == want.shape == (2, 12, pcfg.padded_vocab)
    assert np.abs(got.numpy() - _np(want)).max() < 1e-4
    assert float(aux) == float(raux) == 0.0


def _assert_caches_close(cache, rcache):
    """Every leaf of the port's cache (k and v, or a mamba layer's h and
    conv) within 1e-4 of the reference's."""
    assert sorted(cache["layers"]) == sorted(rcache["layers"])
    for name, leaves in rcache["layers"].items():
        assert sorted(cache["layers"][name]) == sorted(leaves), name
        for key, want in leaves.items():
            got = cache["layers"][name][key]
            assert got.shape == want.shape, (name, key)
            assert np.abs(got.numpy() - _np(want)).max() < 1e-4, (name, key)


@pytest.mark.parametrize("arch", MODELS)
def test_prefill_and_decode_equal_reference(arch):
    rcfg, pcfg, rp, pp = _both(arch)
    B, S, P = 2, 16, 10
    toks = _tokens(pcfg, B, S)
    lg, cache = prefill(pcfg, pp, _t(toks[:, :P]))
    rlg, rcache = ref_lm.prefill(rcfg, rp, jnp.asarray(toks[:, :P]))
    assert lg.shape == (B, pcfg.vocab)
    assert np.abs(lg.numpy() - _np(rlg)).max() < 1e-4
    assert cache["length"] == int(rcache["length"]) == P
    _assert_caches_close(cache, rcache)

    # k and v padded to S along the sequence; a mamba state kept as it is
    def rpad(key, x):
        if key not in ("k", "v"):
            return x
        return jnp.pad(x, ((0, 0), (0, 0), (0, S - P), (0, 0), (0, 0)))

    def pad(key, t):
        if key not in ("k", "v"):
            return t
        return torch.nn.functional.pad(t, (0, 0, 0, 0, 0, S - P))

    rcache = {"layers": {n: {w: rpad(w, x) for w, x in kv.items()}
                         for n, kv in rcache["layers"].items()},
              "length": rcache["length"]}
    cache = {"layers": {n: {w: pad(w, t) for w, t in kv.items()}
                        for n, kv in cache["layers"].items()},
             "length": cache["length"]}
    for t in range(P, S):
        lg, cache = decode_step(pcfg, pp, cache, _t(toks[:, t:t + 1]))
        rlg, rcache = ref_lm.decode_step(rcfg, rp, rcache,
                                         jnp.asarray(toks[:, t:t + 1]))
        assert np.abs(lg.numpy() - _np(rlg)).max() < 1e-4, t
        assert cache["length"] == int(rcache["length"]) == t + 1
    _assert_caches_close(cache, rcache)


@pytest.mark.parametrize("arch", MODELS)
def test_decode_matches_teacher_forcing(arch):
    """The port's own consistency: prefill then decode reproduce
    lm_forward's logits at every position (2e-3, the reference's test).
    For mamba2 this ties the chunked form (prefill) and the recurrence
    (decode) to lm_forward's scan."""
    cfg = configs.get_config(arch).smoke()
    params = init_lm(cfg, torch.Generator().manual_seed(0))
    B, S, P = 2, 24, 20
    toks = _t(_tokens(cfg, B, S))
    full, _ = lm_forward(cfg, params, toks)
    lg, cache = prefill(cfg, params, toks[:, :P])
    empty = init_decode_cache(cfg, B, S, device="cpu")
    for name, leaves in cache["layers"].items():
        for key, t in leaves.items():
            if key in ("k", "v"):
                empty["layers"][name][key][:, :, :P] = t
            else:
                empty["layers"][name][key].copy_(t)
    cache = {"layers": empty["layers"], "length": cache["length"]}
    errs = [float((lg - full[:, P - 1, :cfg.vocab]).abs().max())]
    for t in range(P, S):
        lg, cache = decode_step(cfg, params, cache, toks[:, t:t + 1])
        errs.append(float((lg - full[:, t, :cfg.vocab]).abs().max()))
    assert max(errs) < 2e-3, (arch, errs)


def test_decode_step_updates_the_cache_in_place():
    cfg = configs.get_config("qwen3_1_7b").smoke()
    params = init_lm(cfg, torch.Generator().manual_seed(0))
    cache = init_decode_cache(cfg, 1, 8, device="cpu")
    k0 = cache["layers"]["l0"]["k"]
    _, new = decode_step(cfg, params, cache, torch.tensor([[3]]))
    assert new["layers"]["l0"]["k"] is k0 and new["length"] == 1
    assert k0[:, :, 0].abs().sum() > 0 and k0[:, :, 1:].abs().sum() == 0


def test_init_decode_cache_shapes_equal_reference():
    for arch in MODELS:
        pcfg = configs.get_config(arch).smoke()
        rcfg = ref_configs.get_config(arch).smoke()
        got = init_decode_cache(pcfg, 3, 7, device="cpu")
        want = ref_lm.init_decode_cache(rcfg, 3, 7)
        assert [tuple(t.shape) for t in tree_leaves(got["layers"])] == \
            [tuple(x.shape) for x in jax.tree.leaves(want["layers"])]
        assert [t.dtype for t in tree_leaves(got["layers"])] == \
            [getattr(torch, str(x.dtype))
             for x in jax.tree.leaves(want["layers"])]


def test_mamba_decode_step_updates_the_state_in_place():
    cfg = configs.get_config("mamba2_2_7b").smoke()
    params = init_lm(cfg, torch.Generator().manual_seed(0))
    cache = init_decode_cache(cfg, 1, 8, device="cpu")
    h0, conv0 = cache["layers"]["l0"]["h"], cache["layers"]["l0"]["conv"]
    assert h0.dtype == torch.float32 and h0.abs().sum() == 0
    _, new = decode_step(cfg, params, cache, torch.tensor([[3]]))
    assert new["layers"]["l0"]["h"] is h0 and new["length"] == 1
    assert new["layers"]["l0"]["conv"] is conv0
    assert h0.abs().sum() > 0 and conv0[:, :, -1].abs().sum() > 0
    assert conv0[:, :, :-1].abs().sum() == 0
