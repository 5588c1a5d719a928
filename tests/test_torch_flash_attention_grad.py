"""flash_attention's gradient on the CPU (src/repro_torch/kernels/
flash_attention/: the autograd Function and ``ref.attention_bwd_ref``)
against ``jax.vjp`` of the reference's ``attention_ref`` on the same numpy
inputs, and the forward's row log-sum-exp against a float64 one.

Rows that see no key (causal with Sq > Sk) are left out: the reference's
oracle gives NaN there (and so NaN in every dk and dv), so its vjp is taken
on the rows that see a key; the port's dq is 0 on the others (asserted).
Tolerances, of the largest |gradient|: 2e-5 in float32 (both compute in
float32, the sums in other orders) and 2e-2 in bfloat16 (both round float32
results to bfloat16; an ulp at the top of the range is 2^-8).  lse: 1e-5
absolute against float64."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.ref import attention_ref as ref_attention
from repro_torch.kernels.flash_attention import (attn_bwd_dkdv, attn_bwd_dq,
                                                 attn_bwd_prep,
                                                 flash_attention,
                                                 flash_attention_bwd,
                                                 flash_attention_lse)
from repro_torch.kernels.flash_attention.ref import attention_bwd_ref

SHAPES = [(1, 2, 2, 16, 16, 32), (2, 4, 2, 33, 33, 24),
          (1, 8, 2, 20, 45, 16), (1, 4, 1, 1, 17, 8),
          (1, 6, 2, 19, 7, 16), (1, 16, 8, 40, 40, 128)]
TOL = {"float32": 2e-5, "bfloat16": 2e-2}
DTYPES = {"float32": (torch.float32, jnp.float32),
          "bfloat16": (torch.bfloat16, jnp.bfloat16)}


def _inputs(shape, dtype, seed):
    B, Hq, Hkv, Sq, Sk, d = shape
    rng = np.random.default_rng(seed)
    arrays = [rng.normal(size=s).astype(np.float32)
              for s in ((B, Hq, Sq, d), (B, Hkv, Sk, d), (B, Hkv, Sk, d),
                        (B, Hq, Sq, d))]
    tdt, jdt = DTYPES[dtype]
    return ([torch.from_numpy(a).to(tdt) for a in arrays],
            [jnp.asarray(a).astype(jdt) for a in arrays])


def _sees(Sq, Sk, causal):
    if not causal:
        return np.ones(Sq, bool)
    return np.arange(Sq) + (Sk - Sq) >= 0


def _ref_grads(jx, causal, sees):
    """jax.vjp of the reference's attention on the query rows that see a
    key (the last rows; the mask stays aligned to the end of the keys), dq
    scattered back into the full row range."""
    q, k, v, do = jx
    q, do = q[:, :, sees], do[:, :, sees]
    _, vjp = jax.vjp(lambda a, b, c: ref_attention(a, b, c, causal=causal),
                     q, k, v)
    dq, dk, dv = (np.asarray(g.astype(jnp.float32)) for g in vjp(do))
    full = np.zeros((*dq.shape[:2], sees.size, dq.shape[3]), np.float32)
    full[:, :, sees] = dq
    return [full, dk, dv]


def _close(got, want, sees, tol):
    scale = max(float(np.abs(w).max()) for w in want)
    dq, dk, dv = (g.float().numpy() for g in got)
    assert np.abs(dq[:, :, sees] - want[0][:, :, sees]).max() <= tol * scale
    assert np.abs(dk - want[1]).max() <= tol * scale
    assert np.abs(dv - want[2]).max() <= tol * scale
    assert not dq[:, :, ~sees].any()


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [True, False])
def test_autograd_and_bwd_ref_equal_reference_vjp(shape, dtype, causal):
    (q, k, v, do), jx = _inputs(shape, dtype, sum(shape))
    sees = _sees(shape[3], shape[4], causal)
    want = _ref_grads(jx, causal, sees)
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    out = flash_attention(*leaves, causal=causal)
    got = torch.autograd.grad(out, leaves, do)
    for g, x in zip(got, (q, k, v)):
        assert g.dtype == x.dtype and g.shape == x.shape
    _close(got, want, sees, TOL[dtype])
    _close(attention_bwd_ref(q, k, v, do, causal=causal), want, sees,
           TOL[dtype])


def test_bwd_wrapper_on_the_cpu_is_the_plain_version():
    (q, k, v, do), _ = _inputs((1, 4, 2, 9, 9, 16), "float32", 0)
    out, lse = flash_attention_lse(q, k, v)
    got = flash_attention_bwd(q, k, v, out, lse, do)
    for a, b in zip(got, attention_bwd_ref(q, k, v, do)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("causal", [True, False])
def test_lse_equals_float64_logsumexp(causal):
    B, Hq, Hkv, Sq, Sk, d = 2, 6, 2, 19, 7, 16
    (q, k, v, _), _ = _inputs((B, Hq, Hkv, Sq, Sk, d), "float32", 5)
    out, lse = flash_attention_lse(q, k, v, causal=causal)
    assert lse.shape == (B, Hq, Sq) and lse.dtype == torch.float32
    s = np.einsum("bhqd,bhkd->bhqk", q.double().numpy(),
                  np.repeat(k.double().numpy(), Hq // Hkv, axis=1)) \
        * d ** -0.5
    if causal:
        s = np.where(np.tril(np.ones((Sq, Sk), bool), k=Sk - Sq), s,
                     -np.inf)
    sees = _sees(Sq, Sk, causal)
    with np.errstate(divide="ignore"):
        m = s.max(axis=-1, keepdims=True)
        want = (np.log(np.exp(s - np.where(np.isfinite(m), m, 0))
                       .sum(axis=-1)) + np.where(np.isfinite(m), m, 0)[..., 0])
    assert np.abs(lse.numpy()[:, :, sees] - want[:, :, sees]).max() < 1e-5
    assert np.isneginf(lse.numpy()[:, :, ~sees]).all()


def test_no_gradient_no_autograd_node():
    """Without a gradient wanted the forward is the plain one and keeps no
    backward state; with one it is the autograd Function."""
    (q, k, v, _), _ = _inputs((1, 2, 2, 5, 5, 8), "float32", 1)
    assert flash_attention(q, k, v).grad_fn is None
    out = flash_attention(q.requires_grad_(), k, v)
    assert type(out.grad_fn).__name__ == "_FlashAttentionBackward"


@pytest.mark.parametrize("wrapper", [attn_bwd_dkdv, attn_bwd_dq])
def test_bwd_kernel_wrappers_take_cuda_tensors_only(wrapper):
    """dk/dv and dq have no plain version of their own: on the CPU the
    backward is ``flash_attention_bwd``'s plain branch."""
    (q, k, v, do), _ = _inputs((1, 4, 2, 9, 9, 16), "float32", 0)
    out, lse = flash_attention_lse(q, k, v)
    D = attn_bwd_prep(out, do)
    with pytest.raises(ValueError, match="CUDA"):
        wrapper(q, k, v, do, lse, D, causal=True, scale=0.25)
