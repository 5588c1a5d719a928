"""The port's data pipeline (src/repro_torch/data/pipeline.py): the
determinism contract of tests/test_data_determinism.py:16-49 held on the
port, and ``make_batch_specs`` equal to the reference's shapes and types.

The port draws from its own counter-based generator (numpy Philox keyed by
(seed, step, row)), the reference from JAX's threefry, so their tokens
differ in bits; the contract is what both keep."""
import numpy as np
import pytest

import repro.configs as ref_configs
from repro.data.pipeline import make_batch_specs as ref_batch_specs
import repro_torch.configs as configs
from repro_torch.data.pipeline import (DataConfig, SyntheticTokens,
                                       make_batch_specs)

CFG = configs.get_config("tinyllama-1.1b").smoke()


def _np(batch) -> dict:
    return {k: v.numpy() for k, v in batch.items()}


def test_batches_are_pure_functions_of_step():
    a = SyntheticTokens(CFG, DataConfig(seq_len=64, global_batch=8, seed=3))
    b = SyntheticTokens(CFG, DataConfig(seq_len=64, global_batch=8, seed=3))
    for step in (0, 7, 123):
        ba, bb = _np(a.batch_at(step)), _np(b.batch_at(step))
        for k in ba:
            assert np.array_equal(ba[k], bb[k])
    assert not np.array_equal(_np(a.batch_at(0))["tokens"],
                              _np(a.batch_at(1))["tokens"])


def test_host_sharded_rows_match_global_batch():
    data = SyntheticTokens(CFG, DataConfig(seq_len=32, global_batch=8, seed=0))
    full = _np(data.batch_at(5))
    lo = _np(data.batch_at(5, lo=0, hi=4))
    hi = _np(data.batch_at(5, lo=4, hi=8))
    for key in full:
        assert np.array_equal(np.concatenate([lo[key], hi[key]]), full[key])


def test_labels_are_shifted_tokens():
    data = SyntheticTokens(CFG, DataConfig(seq_len=16, global_batch=2, seed=1))
    b = _np(data.batch_at(0))
    toks, labels = b["tokens"], b["labels"]
    assert toks.dtype == labels.dtype == np.int32
    assert np.array_equal(labels[:, :-1], toks[:, 1:])
    assert (labels[:, -1] == -1).all()


def test_data_has_learnable_structure():
    data = SyntheticTokens(CFG, DataConfig(seq_len=512, global_batch=4,
                                           seed=0))
    toks = _np(data.batch_at(0))["tokens"]
    v = CFG.vocab
    pred = (toks[:, :-1] * 31 + 7) % (v - 1) + 1
    frac = (pred == toks[:, 1:]).mean()
    assert frac > 0.3  # ~half the transitions follow the affine rule
    assert 0 < (toks == 0).mean() < 0.05          # EOS at ~1/64
    assert toks.min() >= 0 and toks.max() < v


@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "llava-next-mistral-7b",
                                  "whisper-large-v3"])
def test_batch_specs_equal_reference(arch):
    """Shapes and types per family (lm, vlm, encdec), at full width, and
    a smoke batch laid out as its specs say."""
    for seq_len, batch in ((4096, 256), (32, 4)):
        rcfg = ref_configs.get_config(arch)
        pcfg = configs.get_config(arch)
        if batch == 4:
            rcfg, pcfg = rcfg.smoke(), pcfg.smoke()
        want = ref_batch_specs(rcfg, seq_len, batch)
        got = make_batch_specs(pcfg, seq_len, batch)
        assert list(got) == list(want)
        for key in want:
            assert got[key].device.type == "meta"
            assert tuple(got[key].shape) == tuple(want[key].shape), key
            assert str(got[key].dtype).split(".")[-1] == str(want[key].dtype)
    text = seq_len - pcfg.n_image_tokens if pcfg.family == "vlm" else seq_len
    data = SyntheticTokens(pcfg, DataConfig(seq_len=text, global_batch=batch))
    b = data.batch_at(0)
    for key, spec in got.items():
        assert b[key].shape == spec.shape and b[key].dtype == spec.dtype
    if "patches" in b or "frames" in b:
        emb = _np(b)["patches" if "patches" in b else "frames"]
        assert 0.01 < emb.std() < 0.03
        again = _np(data.batch_at(0, lo=1, hi=3))
        key = "patches" if "patches" in b else "frames"
        assert np.array_equal(again[key], emb[1:3])
