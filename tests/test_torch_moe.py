"""The port's MoE layer and the MoE stacks (src/repro_torch/models/moe.py,
lm.py) against the reference's (src/repro/models/moe.py, lm.py) on the
CPU.  Parameters are the reference's pytrees carried across by
``lm_params_from_numpy``; inputs are made with numpy from a seed.

Routing is held to equality: the experts each token picks, the keep mask
of every token-expert pair (in the stable sort by expert) and the number
of pairs dropped, with capacity factors that drop.  Float tolerances, as
in tests/test_torch_models.py (float32 configs): 1e-5 for a layer's
output, 1e-6 for its auxiliary loss, 1e-4 for whole-model logits and
caches, the reference's 2e-3 for decode against teacher forcing."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as ref_configs
from repro.models import lm as ref_lm
from repro.models import moe as ref_moe
from repro.serve import Request as RefRequest
from repro.serve import ServeConfig as RefServeConfig
from repro.serve import ServingEngine as RefServingEngine
import repro_torch.configs as configs
from repro_torch.models import (lm_forward, lm_loss, lm_params_from_numpy,
                                lm_params_to_numpy)
from repro_torch.models import layers, moe
from repro_torch.models.lm import tree_map
from repro_torch.serve import Request, ServeConfig, ServingEngine
# the dense and mamba2 stacks' checks, run here on the MoE stacks
from test_torch_models import _tokens
from test_torch_models import (
    test_decode_matches_teacher_forcing as check_teacher_forcing,
    test_init_lm_matches_reference_shapes_and_scales as check_init,
    test_param_count_equals_reference as check_param_count,
    test_prefill_and_decode_equal_reference as check_prefill_and_decode)

MOE = ["granite_moe_3b", "qwen3_moe_235b", "jamba_1_5_large"]


def _np(x) -> np.ndarray:
    return np.asarray(x, dtype=np.float32)


def _t(x) -> torch.Tensor:
    return torch.as_tensor(np.array(x))


def _both(arch, **moe_kw):
    """(reference cfg, port cfg, reference params, port params) of an
    arch's smoke config, its MoESpec replaced by `moe_kw`."""
    rcfg = ref_configs.get_config(arch).smoke()
    pcfg = configs.get_config(arch).smoke()
    if moe_kw:
        rcfg = rcfg.replace(moe=dataclasses.replace(rcfg.moe, **moe_kw))
        pcfg = pcfg.replace(moe=dataclasses.replace(pcfg.moe, **moe_kw))
    rp = jax.tree.map(np.asarray, ref_lm.init_lm(rcfg, jax.random.PRNGKey(0)))
    return rcfg, pcfg, rp, lm_params_from_numpy(pcfg, rp, device="cpu")


def _ref_routing(cfg, router, xt):
    """The reference's routing, its lines of moe_ffn (src/repro/models/
    moe.py:48-75): experts per token, the keep mask in the stable sort by
    expert, and the capacity."""
    spec = cfg.moe
    T = xt.shape[0]
    E, k = spec.n_experts, spec.top_k
    probs = jax.nn.softmax(xt.astype(jnp.float32) @ router, axis=-1)
    _, idx = jax.lax.top_k(probs, k)
    C = int(min(T, max(1, round(-(-T * k // E) * spec.capacity_factor))))
    flat_e = idx.reshape(-1)
    order = jnp.argsort(flat_e, stable=True)
    se = flat_e[order]
    cum = jnp.arange(se.size, dtype=se.dtype)
    seg_start = jnp.full((E,), T * k, cum.dtype).at[se].min(cum)
    keep = (cum - seg_start[se]) < C
    return np.asarray(idx), np.asarray(keep), C


def _layer0(rp, pp):
    return (jax.tree.map(lambda a: a[0], rp["stack"]["l0"]["moe"]),
            tree_map(lambda t: t[0], pp["stack"]["l0"]["moe"]))


# --------------------------------------------------------------------------
# the layer
# --------------------------------------------------------------------------

@pytest.mark.parametrize("capacity_factor", [8.0, 1.0, 0.5])
@pytest.mark.parametrize("norm_topk", [True, False])
@pytest.mark.parametrize("top_k", [1, 2])
@pytest.mark.parametrize("n_experts", [4, 8])
def test_moe_ffn_routing_and_output_equal_reference(n_experts, top_k,
                                                    norm_topk,
                                                    capacity_factor):
    rcfg, pcfg, rp, pp = _both(
        "granite_moe_3b", n_experts=n_experts, top_k=top_k,
        router_norm_topk=norm_topk, capacity_factor=capacity_factor)
    rl, pl = _layer0(rp, pp)
    x = np.random.default_rng(n_experts * 10 + top_k).normal(
        size=(3, 7, pcfg.d_model)).astype(np.float32)        # T = 21, odd
    got, aux = moe.moe_ffn(pcfg, pl, _t(x))
    want, raux = ref_moe.moe_ffn(rcfg, rl, jnp.asarray(x))
    assert np.abs(got.numpy() - _np(want)).max() < 1e-5
    assert abs(float(aux) - float(raux)) < 1e-6

    xt = x.reshape(-1, pcfg.d_model)
    idx, keep, C = _ref_routing(rcfg, rl["router"], jnp.asarray(xt))
    r = moe.moe_route(pcfg, pl["router"], _t(xt))
    assert r["C"] == C
    assert np.array_equal(r["idx"].numpy(), idx)
    assert np.array_equal(r["keep"].numpy(), keep)
    dropped = int((r["pair_slot"] == n_experts * C).sum())
    assert dropped == int((~keep).sum())
    if capacity_factor == 8.0:
        assert dropped == 0
    if capacity_factor == 0.5:
        assert dropped > 0


@pytest.mark.parametrize("T,k,E,cf", [
    (3072, 8, 40, 1.25), (2048, 8, 128, 1.25), (1, 8, 40, 1.25),
    (21, 2, 8, 0.5), (5, 1, 4, 0.5), (4, 2, 4, 1.25), (7, 1, 1, 0.5),
    (12, 2, 8, 1.25), (6, 1, 4, 1.0), (3, 1, 4, 0.5)])
def test_capacity_is_the_reference_formula(T, k, E, cf):
    """Python's round takes a half to the even neighbour: (4, 2, 4, 1.25)
    rounds 2.5 to 2 and (7, 1, 1, 0.5) rounds 3.5 to 4."""
    want = int(min(T, max(1, round(-(-T * k // E) * cf))))
    assert moe.capacity(T, k, E, cf) == want
    if (T, k, E, cf) == (4, 2, 4, 1.25):
        assert want == 2
    if (T, k, E, cf) == (7, 1, 1, 0.5):
        assert want == 4


def test_full_width_prefill_capacity_drops_tokens():
    """granite-moe-3b's factor 1.25 at a 3072-token prompt: C = 769 slots an
    expert for 24576 pairs over 40 experts; decode (T = 1) has C = 1."""
    spec = configs.get_config("granite_moe_3b").moe
    assert moe.capacity(3072, spec.top_k, spec.n_experts,
                        spec.capacity_factor) == 769
    assert moe.capacity(1, spec.top_k, spec.n_experts,
                        spec.capacity_factor) == 1


def test_top_k_ties_take_the_lower_index():
    """jax.lax.top_k's rule on exact ties: a zero router makes every
    probability equal, so every token picks experts 0 .. k-1."""
    _, pcfg, rp, pp = _both("granite_moe_3b")
    rl, pl = _layer0(rp, pp)
    xt = np.random.default_rng(0).normal(size=(5, pcfg.d_model)) \
        .astype(np.float32)
    zero = np.zeros_like(rl["router"])
    r = moe.moe_route(pcfg, _t(zero), _t(xt))
    idx, keep, _ = _ref_routing(pcfg, jnp.asarray(zero), jnp.asarray(xt))
    assert np.array_equal(r["idx"].numpy(), idx)
    assert np.array_equal(idx, np.broadcast_to(np.arange(pcfg.moe.top_k),
                                               idx.shape))
    assert np.array_equal(r["keep"].numpy(), keep)


@pytest.mark.parametrize("impl", ["scatter", "shard_map"])
def test_moe_block_equals_reference(impl):
    rcfg, pcfg, rp, pp = _both("qwen3_moe_235b", impl=impl)
    rl, pl = _layer0(rp, pp)
    x = np.random.default_rng(5).normal(size=(2, 9, pcfg.d_model)) \
        .astype(np.float32)
    got, aux = moe.moe_block(pcfg, pl, _t(x))
    want, raux = ref_moe.moe_block(rcfg, rl, jnp.asarray(x))
    assert np.abs(got.numpy() - _np(want)).max() < 1e-5
    assert abs(float(aux) - float(raux)) < 1e-6
    y, a = moe.moe_ffn_shard_map(pcfg, pl, _t(x))
    y2, a2 = moe.moe_ffn(pcfg, pl, _t(x))
    assert torch.equal(y, y2) and float(a) == float(a2)


def test_decode_sized_routing_drops_nothing():
    """One token a slot (T = 1): C = 1 and every pair is kept."""
    rcfg, pcfg, rp, pp = _both("granite_moe_3b", capacity_factor=1.25)
    rl, pl = _layer0(rp, pp)
    x = np.random.default_rng(3).normal(size=(1, 1, pcfg.d_model)) \
        .astype(np.float32)
    r = moe.moe_route(pcfg, pl["router"], _t(x[0]))
    assert r["C"] == 1 and bool(r["keep"].all())
    got, _ = moe.moe_ffn(pcfg, pl, _t(x))
    want, _ = ref_moe.moe_ffn(rcfg, rl, jnp.asarray(x))
    assert np.abs(got.numpy() - _np(want)).max() < 1e-5


# --------------------------------------------------------------------------
# parameters
# --------------------------------------------------------------------------

@pytest.mark.parametrize("arch", MOE)
def test_init_lm_matches_reference_shapes_and_scales(arch):
    check_init(arch)


@pytest.mark.parametrize("arch", MOE)
def test_param_count_equals_reference(arch):
    check_param_count(arch)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_moe_params_roundtrip_keeps_the_router_float32(dtype):
    rcfg = ref_configs.get_config("granite_moe_3b").smoke().replace(
        param_dtype=dtype)
    pcfg = configs.get_config("granite_moe_3b").smoke().replace(
        param_dtype=dtype)
    rp = jax.tree.map(np.asarray, ref_lm.init_lm(rcfg, jax.random.PRNGKey(1)))
    pp = lm_params_from_numpy(pcfg, rp, device="cpu")
    m = pp["stack"]["l0"]["moe"]
    assert sorted(m) == ["norm", "router", "w_down", "w_gate", "w_up"]
    assert m["router"].dtype == torch.float32
    assert rp["stack"]["l0"]["moe"]["router"].dtype == np.float32
    for key in ("w_gate", "w_up", "w_down"):
        assert m[key].dtype == layers.DTYPES[dtype], key
        assert m[key].shape[:2] == (pcfg.n_periods, pcfg.moe.n_experts)
    back = lm_params_to_numpy(pp)
    for a, b in zip(jax.tree.leaves(rp), jax.tree.leaves(back)):
        assert np.array_equal(a.astype(np.float32), b)
    bad = jax.tree.map(lambda a: a, rp)
    bad["stack"]["l0"]["moe"]["router"] = rp["stack"]["l0"]["moe"][
        "router"][:, :-1]
    with pytest.raises(ValueError, match="router"):
        lm_params_from_numpy(pcfg, bad, device="cpu")


# --------------------------------------------------------------------------
# the stacks: lm_forward, prefill, decode_step
# --------------------------------------------------------------------------

@pytest.mark.parametrize("arch", MOE)
def test_lm_forward_with_aux_equals_reference(arch):
    rcfg, pcfg, rp, pp = _both(arch)
    toks = _tokens(pcfg, 2, 12)
    got, aux = lm_forward(pcfg, pp, _t(toks))
    want, raux = ref_lm.lm_forward(rcfg, rp, jnp.asarray(toks))
    assert got.shape == want.shape == (2, 12, pcfg.padded_vocab)
    assert np.abs(got.numpy() - _np(want)).max() < 1e-4
    assert float(raux) > 0 and abs(float(aux) - float(raux)) < 1e-5


@pytest.mark.parametrize("arch", MOE)
def test_prefill_and_decode_equal_reference(arch):
    """Logits and caches within 1e-4 of the reference's, prefill then six
    decode steps."""
    check_prefill_and_decode(arch)


@pytest.mark.parametrize("arch", MOE)
def test_decode_matches_teacher_forcing(arch):
    """tests/test_models.py::test_decode_matches_teacher_forcing on the
    port (the smoke configs' factor 8.0 drops nothing, so prefill and
    decode route every token as lm_forward does)."""
    check_teacher_forcing(arch)


# --------------------------------------------------------------------------
# lm_loss
# --------------------------------------------------------------------------

LOSS_ARCHS = ["qwen3_1_7b", "mamba2_2_7b", "granite_moe_3b",
              "jamba_1_5_large"]


@pytest.mark.parametrize("loss_chunk", [0, 8, 5, None])
@pytest.mark.parametrize("arch", LOSS_ARCHS)
def test_lm_loss_equals_reference(arch, loss_chunk):
    """S = 12: chunks of 8 and of 5 leave a padded tail (4 and 3 labels
    of -1); 0 is the unchunked loss, None the config's 2048 (one chunk);
    a third of the labels are -1."""
    rcfg, pcfg, rp, pp = _both(arch)
    toks = _tokens(pcfg, 2, 12)
    labels = _tokens(pcfg, 2, 12, seed=2)
    labels[np.random.default_rng(3).random(labels.shape) < 1 / 3] = -1
    got = lm_loss(pcfg, pp, _t(toks), _t(labels), loss_chunk=loss_chunk)
    want = ref_lm.lm_loss(rcfg, rp, jnp.asarray(toks), jnp.asarray(labels),
                          loss_chunk=loss_chunk)
    assert got.dtype == torch.float32 and got.shape == ()
    assert abs(float(got) - float(want)) < 1e-5


@pytest.mark.parametrize("arch", ["qwen3_1_7b", "granite_moe_3b"])
def test_lm_loss_with_inputs_embeds_and_aux_weight(arch):
    rcfg, pcfg, rp, pp = _both(arch)
    rng = np.random.default_rng(4)
    x = rng.normal(size=(2, 10, pcfg.d_model)).astype(np.float32)
    labels = rng.integers(-1, pcfg.vocab, size=(2, 10))
    for aux_weight in (0.01, 0.5):
        got = lm_loss(pcfg, pp, None, _t(labels), aux_weight=aux_weight,
                      loss_chunk=4, inputs_embeds=_t(x))
        want = ref_lm.lm_loss(rcfg, rp, None, jnp.asarray(labels),
                              aux_weight=aux_weight, loss_chunk=4,
                              inputs_embeds=jnp.asarray(x))
        assert abs(float(got) - float(want)) < 1e-5, aux_weight


def test_lm_loss_with_every_label_ignored_is_the_aux_term():
    rcfg, pcfg, rp, pp = _both("granite_moe_3b")
    toks = _tokens(pcfg, 1, 6)
    labels = np.full((1, 6), -1)
    got = lm_loss(pcfg, pp, _t(toks), _t(labels), aux_weight=1.0)
    want = ref_lm.lm_loss(rcfg, rp, jnp.asarray(toks), jnp.asarray(labels),
                          aux_weight=1.0)
    _, aux = lm_forward(pcfg, pp, _t(toks))
    assert abs(float(got) - float(want)) < 1e-5
    assert abs(float(got) - float(aux)) < 1e-6


# --------------------------------------------------------------------------
# serving granite's smoke config
# --------------------------------------------------------------------------

def _requests(cls, cfg, seed=0):
    rng = np.random.default_rng(seed)
    return [cls(rid=i, tokens=rng.integers(1, cfg.vocab,
                                           size=rng.integers(4, 17)),
                max_new=6, weight=float(rng.uniform(0.5, 2.0)),
                arrival=float(i // 2))
            for i in range(7)]


@pytest.mark.parametrize("admission", ["fifo", "coflow"])
def test_granite_serve_equals_reference(admission):
    """granite-moe-3b's smoke config through both engines: the token
    streams, finish steps and serve statistics are equal."""
    rcfg = ref_configs.get_config("granite_moe_3b").smoke()
    pcfg = configs.get_config("granite_moe_3b").smoke()
    rp = ref_lm.init_lm(rcfg, jax.random.PRNGKey(0))
    pp = lm_params_from_numpy(pcfg, jax.tree.map(np.asarray, rp),
                              device="cpu")
    want_reqs = _requests(RefRequest, rcfg)
    want = RefServingEngine(rcfg, rp, RefServeConfig(
        slots=3, capacity=32, admission=admission)).run(want_reqs)
    got_reqs = _requests(Request, pcfg)
    got = ServingEngine(pcfg, pp, ServeConfig(
        slots=3, capacity=32, admission=admission)).run(got_reqs)
    assert got == want and got["completed"] == 7
    for g, w in zip(got_reqs, want_reqs):
        assert g.out == w.out, g.rid
        assert (g.done, g.finish_step) == (w.done, w.finish_step)
