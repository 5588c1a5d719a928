"""The port's Mamba2 stack (src/repro_torch/models/ssm.py, kernels/ssd_scan)
against the reference's (src/repro/models/ssm.py, kernels/ssd_scan) on the
CPU.  Inputs are made with numpy from a seed and fed to both; parameters
cross with ``lm_params_from_numpy``.  The reference's ``ssd_scan`` runs its
Pallas kernel in interpret mode here, as its own tests run it.

Tolerances: relative to the largest |y|, 1e-4 in float32 for the scan (the
reference's own test_ssd_scan_sweep); 1e-4 for the chunked form, the
decode step and the block (float32 configs: the two frameworks differ in
summation order and in the last bits of exp and log); 1e-4 for whole-model
logits and caches and the reference's 2e-3 for teacher forcing, as in
tests/test_torch_models.py."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

import repro.configs as ref_configs
from repro.kernels.ssd_scan import ssd_scan as ref_ssd_scan
from repro.kernels.ssd_scan.ref import ssd_decode_step as ref_decode_step
from repro.kernels.ssd_scan.ref import ssd_ref as ref_ssd_ref
from repro.models import lm as ref_lm
from repro.models import ssm as ref_ssm
import repro_torch.configs as configs
from repro_torch.kernels.ssd_scan import ssd_scan
from repro_torch.kernels.ssd_scan.ref import ssd_decode_step, ssd_ref
from repro_torch.models import lm_params_from_numpy, ssm
from repro_torch.models.lm import tree_map

ARCH = "mamba2_2_7b"

# the reference sweep's shapes (B, S, H, G, N, P) and chunks
# (tests/test_kernels.py::test_ssd_scan_sweep)
SWEEP = [((1, 16, 2, 1, 8, 16), 8),
         ((2, 33, 4, 2, 16, 32), 16),      # ragged + state groups
         ((1, 64, 2, 2, 32, 64), 32),
         ((1, 40, 8, 1, 16, 8), 64)]       # chunk > seq


def _t(x) -> torch.Tensor:
    return torch.as_tensor(np.array(x))


def _np(x) -> np.ndarray:
    return np.asarray(x, dtype=np.float32)


def _rel(got, want) -> float:
    got, want = _np(got), _np(want)
    return float(np.abs(got - want).max() / (np.abs(want).max() + 1e-9))


def _scan_inputs(shape, seed):
    """As test_ssd_scan_sweep draws them: a in (0.55, 1), b and c scaled
    by 0.3."""
    B, S, H, G, N, P = shape
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(B, S, H, P)).astype(np.float32)
    a = rng.uniform(0.55, 1.0, size=(B, S, H)).astype(np.float32)
    b = (rng.normal(size=(B, S, G, N)) * 0.3).astype(np.float32)
    c = (rng.normal(size=(B, S, G, N)) * 0.3).astype(np.float32)
    return x, a, b, c


def _both_params(arch=ARCH):
    rcfg = ref_configs.get_config(arch).smoke()
    pcfg = configs.get_config(arch).smoke()
    rp = jax.tree.map(np.asarray, ref_lm.init_lm(rcfg, jax.random.PRNGKey(0)))
    return rcfg, pcfg, rp, lm_params_from_numpy(pcfg, rp, device="cpu")


# --------------------------------------------------------------------------
# kernels/ssd_scan: the wrapper (CPU: ssd_ref) and the plain versions
# --------------------------------------------------------------------------

@pytest.mark.parametrize("shape,chunk", SWEEP)
def test_ssd_scan_equals_reference_kernel_and_oracle(shape, chunk):
    x, a, b, c = _scan_inputs(shape, seed=sum(shape))
    got = ssd_scan(_t(x), _t(a), _t(b), _t(c), chunk=chunk)
    jx = [jnp.asarray(v) for v in (x, a, b, c)]
    want_kernel = ref_ssd_scan(*jx, chunk=chunk)        # Pallas, interpret
    want_oracle = ref_ssd_ref(*jx)
    assert got.shape == x.shape and got.dtype == torch.float32
    assert _rel(got.numpy(), want_kernel) < 1e-4
    assert _rel(got.numpy(), want_oracle) < 1e-4
    assert _rel(ssd_ref(_t(x), _t(a), _t(b), _t(c)).numpy(), want_oracle) \
        < 1e-4


def test_ssd_scan_cpu_launches_no_kernel():
    x, a, b, c = _scan_inputs((1, 16, 2, 1, 8, 16), seed=0)
    before = ssd_scan.launches
    ssd_scan(_t(x), _t(a), _t(b), _t(c), chunk=8)
    assert ssd_scan.launches == before


@pytest.mark.parametrize("which", ["a", "c", "b_groups"])
def test_ssd_scan_shape_errors_as_reference(which):
    x, a, b, c = _scan_inputs((1, 16, 2, 1, 8, 16), seed=1)
    if which == "a":
        a = a[:, :-1]
    elif which == "c":
        c = c[..., :-1]
    else:
        b, c = b[:, :-1], c[:, :-1]
    with pytest.raises(ValueError, match="operand shapes disagree"):
        ssd_scan(_t(x), _t(a), _t(b), _t(c), chunk=8)
    with pytest.raises(ValueError, match="operand shapes disagree"):
        ref_ssd_scan(*(jnp.asarray(v) for v in (x, a, b, c)), chunk=8)


def test_ssd_scan_refuses_groups_that_do_not_divide_heads():
    x, a, b, c = _scan_inputs((1, 8, 3, 2, 8, 16), seed=2)
    with pytest.raises(ValueError, match="heads % groups"):
        ssd_scan(_t(x), _t(a), _t(b), _t(c), chunk=8)


def test_ssd_decode_step_equals_reference_and_scan_tail():
    """test_ssd_decode_step_matches_scan_tail's shapes: the port's step
    equals the reference's step, and stepping token by token reproduces
    ssd_ref's outputs (1e-4)."""
    B, S, H, G, N, P = 1, 12, 2, 1, 8, 16
    rng = np.random.default_rng(3)
    x = rng.normal(size=(B, S, H, P)).astype(np.float32)
    a = rng.uniform(0.6, 1.0, size=(B, S, H)).astype(np.float32)
    b = rng.normal(size=(B, S, G, N)).astype(np.float32)
    c = rng.normal(size=(B, S, G, N)).astype(np.float32)
    full = ssd_ref(_t(x), _t(a), _t(b), _t(c))
    h = torch.zeros((B, H, N, P))
    rh = jnp.zeros((B, H, N, P), jnp.float32)
    for t in range(S):
        h, y = ssd_decode_step(h, _t(x[:, t]), _t(a[:, t]), _t(b[:, t]),
                               _t(c[:, t]))
        rh, ry = ref_decode_step(rh, jnp.asarray(x[:, t]),
                                 jnp.asarray(a[:, t]), jnp.asarray(b[:, t]),
                                 jnp.asarray(c[:, t]))
        assert float((y - full[:, t]).abs().max()) < 1e-4, t
        assert np.abs(y.numpy() - _np(ry)).max() < 1e-4, t
        assert np.abs(h.numpy() - _np(rh)).max() < 1e-4, t


@pytest.mark.parametrize("shape,chunk", SWEEP + [((2, 20, 16, 1, 16, 8), 16)])
def test_ssd_chunked_equals_reference(shape, chunk):
    x, a, b, c = _scan_inputs(shape, seed=sum(shape) + 1)
    y, hf = ssm._ssd_chunked(_t(x), _t(a), _t(b), _t(c), chunk)
    ry, rh = ref_ssm._ssd_chunked_jnp(*(jnp.asarray(v) for v in (x, a, b, c)),
                                      chunk)
    assert y.shape == ry.shape and hf.shape == rh.shape
    assert hf.dtype == torch.float32
    assert _rel(y.numpy(), ry) < 1e-4
    assert _rel(hf.numpy(), rh) < 1e-4
    # and the chunked form computes the scan's function
    assert _rel(y.numpy(), ssd_ref(_t(x), _t(a), _t(b), _t(c)).numpy()) \
        < 1e-4


# --------------------------------------------------------------------------
# kernels/ssd_scan's chunk-parallel decomposition, in plain torch
# --------------------------------------------------------------------------

def _tf32(t: torch.Tensor) -> torch.Tensor:
    """float32 rounded to TF32 as ``cvt.rna.tf32.f32`` rounds (to nearest,
    ties away from zero): half a unit of the 13 dropped mantissa bits added
    to the magnitude, then the 13 bits cleared, on an int32 view."""
    i = t.float().contiguous().view(torch.int32)
    return ((i + 0x1000) & -0x2000).view(torch.float32)


def _ssd_three_pass(x, a, b, c, chunk, *, rounded=False):
    """The three kernels of kernels/ssd_scan in plain torch: (1) each
    chunk's state s_c = sum_j exp(cum_L - cum_j) b_j x_j^T, (2) the pass
    h_c = exp(cum_L of c - 1) h_(c-1) + s_(c-1) over the chunks, h_0 = 0,
    (3) each chunk's output, the masked intra-chunk term plus exp(cum_i)
    (c_i . h_c).  Padded as the wrapper pads.  With ``rounded`` the
    products round their operands as the bfloat16 path's tensor cores do:
    TF32 for the float32 operands a kernel computes (w_j b_j, h, the masked
    scores), x, b and c as they are (bf16 is exact in TF32), float32
    sums."""
    B, S, H, P = x.shape
    G, N = b.shape[2], b.shape[3]
    rep = H // G
    L = min(chunk, S)
    pad = (-S) % L
    loga = torch.log(torch.clamp(a.float(), min=1e-37))
    xf, bf, cf = x.float(), b.float(), c.float()
    if pad:
        xf, bf, cf = (F.pad(t, (0, 0, 0, 0, 0, pad)) for t in (xf, bf, cf))
        loga = F.pad(loga, (0, 0, 0, pad))
    nC = (S + pad) // L
    rnd = _tf32 if rounded else (lambda t: t)
    xc = xf.reshape(B, nC, L, H, P)
    bc = bf.repeat_interleave(rep, dim=2).reshape(B, nC, L, H, N)
    cc = cf.repeat_interleave(rep, dim=2).reshape(B, nC, L, H, N)
    cum = loga.reshape(B, nC, L, H).cumsum(dim=2)              # (B, nC, L, H)
    # 1. chunk states
    w = torch.exp(cum[:, :, -1:] - cum)
    states = torch.einsum("bcjhn,bcjhp->bchnp", rnd(w[..., None] * bc), xc)
    # 2. the pass over the chunks: the state entering each chunk
    h = torch.zeros_like(states)
    run = torch.zeros_like(states[:, 0])
    for ci in range(nC):
        h[:, ci] = run
        run = torch.exp(cum[:, ci, -1])[..., None, None] * run + states[:, ci]
    # 3. chunk outputs
    y = torch.einsum("bcihn,bchnp->bcihp", cc, rnd(h)) \
        * torch.exp(cum)[..., None]
    cum_h = cum.permute(0, 1, 3, 2)                              # (.., H, L)
    causal = torch.ones((L, L), dtype=torch.bool).tril()
    diff = torch.where(causal, cum_h[..., :, None] - cum_h[..., None, :], 0.0)
    scores = torch.einsum("bcihn,bcjhn->bchij", cc, bc) \
        * torch.where(causal, torch.exp(diff), 0.0)
    y = y + torch.einsum("bchij,bcjhp->bcihp", rnd(scores), xc)
    return y.reshape(B, nC * L, H, P)[:, :S].to(x.dtype)


def test_tf32_rounding_is_round_to_nearest_ties_away():
    v = torch.tensor([1 + 2**-11, 1 + 2**-12, -(1 + 2**-11), 1 + 3 * 2**-12,
                      3.0, 0.0], dtype=torch.float32)
    want = torch.tensor([1 + 2**-10, 1.0, -(1 + 2**-10), 1 + 2**-10, 3.0,
                         0.0], dtype=torch.float32)
    assert torch.equal(_tf32(v), want)
    r = torch.as_tensor(np.random.default_rng(0).normal(size=1000),
                        dtype=torch.float32)
    assert float(((_tf32(r) - r).abs() / r.abs()).max()) <= 2**-11


@pytest.mark.parametrize("shape,chunk", SWEEP)
def test_three_pass_decomposition_equals_reference(shape, chunk):
    """The kernels' decomposition, unrounded, computes the scan: within
    1e-4 of max |y| of ssd_ref and of the reference's ssd_scan (Pallas,
    interpret mode), S off the chunk included."""
    x, a, b, c = _scan_inputs(shape, seed=sum(shape) + 2)
    got = _ssd_three_pass(_t(x), _t(a), _t(b), _t(c), chunk)
    want_kernel = ref_ssd_scan(*(jnp.asarray(v) for v in (x, a, b, c)),
                               chunk=chunk)
    assert got.shape == x.shape
    assert _rel(got.numpy(), want_kernel) < 1e-4
    assert _rel(got.numpy(), ssd_ref(_t(x), _t(a), _t(b), _t(c)).numpy()) \
        < 1e-4


@pytest.mark.parametrize("H,S,seed", [(2, 512, 0), (4, 512, 1), (3, 450, 2)])
def test_three_pass_rounded_as_the_tensor_cores_within_ssd_tol(H, S, seed):
    """mamba2-2.7b's head shape (L = N = 128, P = 64, G = 1) in bfloat16:
    the decomposition with TF32 operands where the bf16 path rounds, and
    its output rounded to bf16, stays within the card check's 8e-3 of max
    |y| of ssd_ref on the same bf16 inputs (also rounded to bf16)."""
    x, a, b, c = _scan_inputs((1, S, H, 1, 128, 64), seed=seed)
    tx, tb, tc = (_t(v).bfloat16() for v in (x, b, c))
    want = ssd_ref(tx, _t(a), tb, tc)
    got = _ssd_three_pass(tx, _t(a), tb, tc, 128, rounded=True)
    assert got.dtype == torch.bfloat16
    rel = _rel(got.float().numpy(), want.float().numpy())
    assert rel < 8e-3
    # the rounding is there: the unrounded decomposition reads differently
    exact = _ssd_three_pass(tx, _t(a), tb, tc, 128)
    assert not torch.equal(exact, got)


# --------------------------------------------------------------------------
# models/ssm: the block, both branches, and its parameters
# --------------------------------------------------------------------------

def _layer(rp, pp):
    return (jax.tree.map(lambda v: v[0], rp["stack"]["l0"]["mamba"]),
            tree_map(lambda t: t[0], pp["stack"]["l0"]["mamba"]))


@pytest.mark.parametrize("S", [20, 16, 2])
def test_mamba_block_equals_reference_both_branches(S):
    rcfg, pcfg, rp, pp = _both_params()
    rl, pl = _layer(rp, pp)
    x = np.random.default_rng(S).normal(size=(2, S, pcfg.d_model)) \
        .astype(np.float32)
    # the kernel branch: lm_forward's; the reference through its ssd_scan
    # (Pallas, interpret mode) and through its CPU path (chunked jnp)
    got = ssm.mamba_block(pcfg, pl, _t(x))
    want_k = ref_ssm.mamba_block(rcfg.replace(attn_impl="pallas"), rl,
                                 jnp.asarray(x))
    want = ref_ssm.mamba_block(rcfg, rl, jnp.asarray(x))
    assert np.abs(got.numpy() - _np(want_k)).max() < 1e-4
    assert np.abs(got.numpy() - _np(want)).max() < 1e-4
    # the state branch: prefill's
    out, st = ssm.mamba_block(pcfg, pl, _t(x), return_state=True)
    rout, rst = ref_ssm.mamba_block(rcfg, rl, jnp.asarray(x),
                                    return_state=True)
    assert np.abs(out.numpy() - _np(rout)).max() < 1e-4
    for key in ("h", "conv"):
        assert st[key].shape == rst[key].shape, key
        assert np.abs(st[key].numpy() - _np(rst[key])).max() < 1e-4, key
    assert st["h"].dtype == torch.float32


def test_mamba_decode_step_equals_reference():
    rcfg, pcfg, rp, pp = _both_params()
    rl, pl = _layer(rp, pp)
    rng = np.random.default_rng(5)
    x = rng.normal(size=(2, 7, pcfg.d_model)).astype(np.float32)
    _, st = ssm.mamba_block(pcfg, pl, _t(x[:, :6]), return_state=True)
    _, rst = ref_ssm.mamba_block(rcfg, rl, jnp.asarray(x[:, :6]),
                                 return_state=True)
    new, y = ssm.mamba_decode_step(pcfg, pl, st, _t(x[:, 6:]))
    rnew, ry = ref_ssm.mamba_decode_step(rcfg, rl, rst, jnp.asarray(x[:, 6:]))
    assert np.abs(y.numpy() - _np(ry)).max() < 1e-4
    for key in ("h", "conv"):
        assert np.abs(new[key].numpy() - _np(rnew[key])).max() < 1e-4, key
    # the recurrence continues the prefix: equal to the block over 7 tokens
    full = ssm.mamba_block(pcfg, pl, _t(x))
    assert float((y[:, 0] - full[:, 6]).abs().max()) < 1e-4


def test_init_mamba_keeps_float32_leaves():
    """a_log, dt_bias and d_skip are float32 under a bfloat16 parameter
    type, on the meta device (the converter's shapes) too."""
    cfg = configs.get_config(ARCH)
    for dev in ("meta", "cpu"):
        gen = None if dev == "meta" else torch.Generator().manual_seed(0)
        p = ssm.init_mamba(cfg.smoke().replace(param_dtype="bfloat16"), gen,
                           (2,), device=dev)
        assert {k: v.dtype for k, v in p.items() if k in
                ("a_log", "dt_bias", "d_skip")} == \
            dict.fromkeys(("a_log", "dt_bias", "d_skip"), torch.float32)
        assert p["in_proj"].dtype == torch.bfloat16
        assert p["conv_w"].shape[0] == 2
    with pytest.raises(TypeError):
        ssm.init_mamba(cfg.smoke(), None, (2,))      # device is required


def test_softplus_is_jax_softplus():
    v = np.array([-50.0, -3.0, 0.0, 2.5, 19.0, 21.0, 40.0, 90.0], np.float32)
    got = ssm._softplus(_t(v)).numpy()
    assert np.abs(got - _np(jax.nn.softplus(jnp.asarray(v)))).max() < 1e-6


def test_mamba2_full_width_size():
    """The published width: 2,831,418,880 parameters (counted from the
    reference's init_lm shapes), 169.8 MB of decode state per slot."""
    cfg = configs.get_config(ARCH)
    assert cfg.param_count() == 2_831_418_880
    s = cfg.ssm
    H = s.expand * cfg.d_model // s.d_head
    assert (H, s.d_state, s.d_head, s.chunk) == (80, 128, 64, 128)
    state = cfg.n_layers * (4 * H * s.d_state * s.d_head
                            + 2 * (s.d_conv - 1)
                            * (s.expand * cfg.d_model + 2 * s.d_state))
    assert state == 169_836_544
