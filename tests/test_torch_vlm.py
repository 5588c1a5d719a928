"""The port's VLM backbone (src/repro_torch/models/vlm.py) against the
reference's (src/repro/models/vlm.py) on the CPU, llava-next-mistral-7b's
smoke config (8 image tokens).  Parameters are the reference's
``init_vlm`` pytree carried across by ``lm_params_from_numpy``; patches
and tokens are made with numpy from a seed.  Tolerances as in
tests/test_torch_models.py (float32): 1e-5 for a loss, 1e-4 for logits and
caches."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as ref_configs
from repro.models import lm as ref_lm
from repro.models import vlm as ref_vlm
import repro_torch.configs as configs
from repro_torch.models import (decode_step, init_lm, init_vlm,
                                lm_params_from_numpy, lm_params_to_numpy,
                                vlm_loss, vlm_prefill)

ARCH = "llava_next_mistral_7b"


def _np(x) -> np.ndarray:
    return np.asarray(x, dtype=np.float32)


def _t(x) -> torch.Tensor:
    return torch.as_tensor(np.array(x))


def _both():
    rcfg = ref_configs.get_config(ARCH).smoke()
    pcfg = configs.get_config(ARCH).smoke()
    rp = jax.tree.map(np.asarray, ref_vlm.init_vlm(rcfg,
                                                   jax.random.PRNGKey(0)))
    return rcfg, pcfg, rp, lm_params_from_numpy(pcfg, rp, device="cpu")


def _inputs(cfg, B=2, S=10, seed=0):
    rng = np.random.default_rng(seed)
    patches = rng.normal(size=(B, cfg.n_image_tokens, cfg.d_model)) \
        .astype(np.float32)
    return patches, rng.integers(0, cfg.vocab, size=(B, S))


def test_init_vlm_is_init_lm():
    cfg = configs.get_config(ARCH).smoke()
    a = lm_params_to_numpy(init_vlm(cfg, torch.Generator().manual_seed(5)))
    b = lm_params_to_numpy(init_lm(cfg, torch.Generator().manual_seed(5)))
    assert jax.tree.structure(a) == jax.tree.structure(b)
    for x, y in zip(jax.tree.leaves(a), jax.tree.leaves(b)):
        assert np.array_equal(x, y)
    assert cfg.n_image_tokens == 8


@pytest.mark.parametrize("masked", [0.0, 0.3])
def test_vlm_loss_equals_reference(masked):
    """The image positions carry label -1; some text labels are -1 too."""
    rcfg, pcfg, rp, pp = _both()
    patches, toks = _inputs(pcfg)
    labels = np.random.default_rng(1).integers(0, pcfg.vocab, toks.shape)
    labels[np.random.default_rng(2).random(labels.shape) < masked] = -1
    got = vlm_loss(pcfg, pp, _t(patches), _t(toks), _t(labels))
    want = ref_vlm.vlm_loss(rcfg, rp, jnp.asarray(patches),
                            jnp.asarray(toks), jnp.asarray(labels))
    assert got.dtype == torch.float32
    assert abs(float(got) - float(want)) < 1e-5


def test_vlm_loss_ignores_the_image_positions():
    """Changing a patch changes the text's loss only through attention;
    the loss counts the text labels alone: with every text label -1 it is
    the (zero) auxiliary term."""
    _, pcfg, _, pp = _both()
    patches, toks = _inputs(pcfg, B=1, S=6)
    labels = np.full(toks.shape, -1)
    assert float(vlm_loss(pcfg, pp, _t(patches), _t(toks),
                          _t(labels))) == 0.0


def test_vlm_prefill_and_decode_equal_reference():
    rcfg, pcfg, rp, pp = _both()
    patches, toks = _inputs(pcfg, S=9)
    n = pcfg.n_image_tokens + 6
    lg, cache = vlm_prefill(pcfg, pp, _t(patches), _t(toks[:, :6]))
    rlg, rcache = ref_vlm.vlm_prefill(rcfg, rp, jnp.asarray(patches),
                                      jnp.asarray(toks[:, :6]))
    assert lg.shape == (2, pcfg.vocab)
    assert np.abs(lg.numpy() - _np(rlg)).max() < 1e-4
    assert cache["length"] == int(rcache["length"]) == n
    for name, leaves in rcache["layers"].items():
        for key, want in leaves.items():
            got = cache["layers"][name][key]
            assert got.shape == want.shape == (pcfg.n_periods, 2, n,
                                               pcfg.n_kv_heads, pcfg.d_head)
            assert np.abs(got.numpy() - _np(want)).max() < 1e-4
    # three text tokens decoded on the cache, padded to n + 3
    pad = 3
    cache = {"layers": {nm: {w: torch.nn.functional.pad(
        t, (0, 0, 0, 0, 0, pad)) for w, t in kv.items()}
        for nm, kv in cache["layers"].items()}, "length": n}
    rcache = {"layers": jax.tree.map(lambda x: jnp.pad(
        x, ((0, 0), (0, 0), (0, pad), (0, 0), (0, 0))), rcache["layers"]),
        "length": rcache["length"]}
    for t in range(6, 9):
        lg, cache = decode_step(pcfg, pp, cache, _t(toks[:, t:t + 1]))
        rlg, rcache = ref_lm.decode_step(rcfg, rp, rcache,
                                         jnp.asarray(toks[:, t:t + 1]))
        assert np.abs(lg.numpy() - _np(rlg)).max() < 1e-4, t
