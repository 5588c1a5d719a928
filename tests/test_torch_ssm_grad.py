"""ssd_scan's gradient on the CPU (src/repro_torch/kernels/ssd_scan/: the
autograd Function and ``ref.ssd_bwd_ref``) against ``jax.vjp`` of the
reference's ``_ssd_chunked_jnp`` (src/repro/models/ssm.py), which its
training differentiates, on the same numpy inputs.

Tolerance: 1e-4 of the largest |gradient| in float32, the forward's own in
tests/test_torch_ssm.py (both compute in float32 and sum in other orders).
The four-term dla is held against autograd of the sequential recurrence
(``ssd_ref``) in float64, to 1e-10 of the largest |gradient|."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.ssm import _ssd_chunked_jnp
from repro_torch.kernels.ssd_scan import (ssd_bwd_chunk, ssd_bwd_state,
                                          ssd_scan, ssd_scan_bwd)
from repro_torch.kernels.ssd_scan.ref import (decay_grad, log_decay,
                                              ssd_bwd_chunk_ref, ssd_bwd_ref,
                                              ssd_bwd_state_ref, ssd_ref,
                                              ssd_states_ref)

TOL = 1e-4
# (B, S, H, G, N, P), chunk: the reference sweep's shapes, groups > 1, S not
# a multiple of L, S < L, S = 1
SHAPES = [((1, 16, 2, 1, 8, 16), 8),
          ((2, 33, 4, 2, 16, 32), 16),
          ((1, 64, 2, 2, 32, 64), 32),
          ((1, 40, 8, 1, 16, 8), 64),
          ((2, 50, 6, 3, 8, 4), 16),
          ((1, 1, 2, 1, 4, 4), 16),
          ((1, 7, 4, 4, 8, 8), 128)]
FLOOR = np.float32(1e-37)


def _inputs(shape, seed, floor=False):
    """a in (0.55, 1), b and c scaled by 0.3, as the reference's sweep;
    with `floor`, some decays at 0 and 1e-40 (under the 1e-37 floor)."""
    B, S, H, G, N, P = shape
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(B, S, H, P)).astype(np.float32)
    a = rng.uniform(0.55, 1.0, size=(B, S, H)).astype(np.float32)
    b = (rng.normal(size=(B, S, G, N)) * 0.3).astype(np.float32)
    c = (rng.normal(size=(B, S, G, N)) * 0.3).astype(np.float32)
    dy = rng.normal(size=(B, S, H, P)).astype(np.float32)
    if floor:
        a[rng.random(a.shape) < 0.1] = 0.0
        a[rng.random(a.shape) < 0.1] = 1e-40
    return x, a, b, c, dy


def _reference_vjp(x, a, b, c, dy, chunk):
    _, vjp = jax.vjp(lambda *t: _ssd_chunked_jnp(*t, chunk)[0],
                     *(jnp.asarray(v) for v in (x, a, b, c)))
    return [np.asarray(g) for g in vjp(jnp.asarray(dy))]


def _autograd(x, a, b, c, dy, chunk):
    leaves = [torch.from_numpy(v).requires_grad_() for v in (x, a, b, c)]
    y = ssd_scan(*leaves, chunk=chunk)
    assert y.grad_fn is not None
    y.backward(torch.from_numpy(dy))
    return [t.grad for t in leaves]


def _close(got, want, names=("dx", "da", "db", "dc")):
    for name, g, w in zip(names, got, want):
        g = g.detach().numpy() if isinstance(g, torch.Tensor) else g
        assert g.shape == w.shape and g.dtype == np.float32, name
        err = float(np.abs(g - w).max()) if w.size else 0.0
        assert err <= TOL * float(np.abs(w).max(initial=0.0)), (name, err)


@pytest.mark.parametrize("shape,chunk", SHAPES)
def test_autograd_and_bwd_ref_equal_reference_vjp(shape, chunk):
    x, a, b, c, dy = _inputs(shape, sum(shape))
    want = _reference_vjp(x, a, b, c, dy, chunk)
    _close(_autograd(x, a, b, c, dy, chunk), want)
    _close(ssd_bwd_ref(*(torch.from_numpy(v) for v in (x, a, b, c, dy)),
                       chunk=chunk), want)


@pytest.mark.parametrize("shape,chunk", SHAPES[:3])
def test_decays_at_or_under_the_floor_carry_no_gradient(shape, chunk):
    """Where a <= 1e-37, la = log(1e-37) whatever a is: da is 0 there, and
    every gradient equals float64 autograd of the recurrence run on
    a if a > 1e-37 else 1e-37.  The reference's vjp gives no usable number
    on such inputs: la = -85.2 makes exp(cum_i - cum_j) overflow above the
    diagonal and its where passes that inf a 0 cotangent (NaN); where it
    stays finite, its dla there is rounding noise over 1e-37."""
    x, a, b, c, dy = _inputs(shape, sum(shape), floor=True)
    a.flat[::7] = FLOOR
    assert not np.isfinite(_reference_vjp(x, a, b, c, dy, chunk)[1]).all()
    got = _autograd(x, a, b, c, dy, chunk)
    at_or_under = a <= FLOOR
    assert (a == FLOOR).any() and (a < FLOOR).any()
    assert not got[1].numpy()[at_or_under].any()
    leaves = [torch.from_numpy(v).double().requires_grad_()
              for v in (x, a, b, c)]
    floor = torch.tensor(float(FLOOR), dtype=torch.float64)
    kept = torch.where(leaves[1] > floor, leaves[1], floor)
    ssd_ref(leaves[0], kept, leaves[2], leaves[3]).backward(
        torch.from_numpy(dy).double())
    _close(got, [t.grad.float().numpy() for t in leaves])
    dla = torch.tensor([2.0, 2.0, 2.0, 2.0])
    av = torch.tensor([0.5, float(FLOOR), 1e-40, 0.0])
    assert decay_grad(dla, av).tolist() == [4.0, 0.0, 0.0, 0.0]


@pytest.mark.parametrize("shape,chunk", [((1, 16, 2, 1, 8, 16), 8),
                                         ((2, 33, 4, 2, 16, 32), 16),
                                         ((1, 21, 6, 3, 5, 7), 4),
                                         ((1, 40, 8, 1, 16, 8), 64)])
def test_four_term_dla_equals_float64_autograd(shape, chunk):
    """ssd_bwd_ref in float64 against autograd of the sequential recurrence
    in float64: every gradient, dla's four terms through da, to 1e-10 of
    its largest value."""
    x, a, b, c, dy = (torch.from_numpy(v).double()
                      for v in _inputs(shape, sum(shape)))
    leaves = [t.clone().requires_grad_() for t in (x, a, b, c)]
    ssd_ref(*leaves).backward(dy)
    got = ssd_bwd_ref(x, a, b, c, dy, chunk=chunk)
    for g, t in zip(got, leaves):
        assert g.dtype == torch.float64
        assert float((g - t.grad).abs().max()) <= \
            1e-10 * float(t.grad.abs().max())


def _tf32(t: torch.Tensor) -> torch.Tensor:
    """float32 rounded to TF32: to nearest on 10 mantissa bits, ties away
    from zero (the card's cvt.rna.tf32.f32); other types as they are."""
    if t.dtype != torch.float32:
        return t
    bits = t.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32).view(t.shape)


def test_tf32_operands_keep_the_bf16_backward_within_its_budget(
        monkeypatch):
    """The bf16 backward kernels (csrc/ssd_scan_bwd_mma.cu) take TF32 for
    every product but C B^T and dY X^T.  The plain versions with every
    float32 operand of their products rounded to TF32 (the decayed
    triangles, G, h, the e^cum-scaled c; the bf16-valued C, B, dY, X are
    exact in TF32) against the same versions unrounded, on bf16-valued
    inputs at one mamba2 chunk width: each of dx, da, db, dc and G within
    1e-3 of its own largest |value| (the bf16 budget is 1e-2), float32
    outputs so that no bf16 rounding of the outputs hides the effect, and
    every one of them moved."""
    shape, L = (1, 512, 16, 1, 128, 64), 128
    x, a, b, c, dy = (torch.from_numpy(v).bfloat16().float()
                      for v in _inputs(shape, 25))
    loga = log_decay(a)
    states, decay, _ = ssd_states_ref(x, loga, b, L)

    def backward():
        grads = ssd_bwd_state_ref(c, dy, loga, decay, L)
        return (*ssd_bwd_chunk_ref(x, a, loga, b, c, dy, states, grads, L),
                grads)

    plain = backward()
    einsum = torch.einsum
    monkeypatch.setattr(torch, "einsum", lambda eq, *ops: einsum(
        eq, *(_tf32(o) for o in ops)))
    rounded = backward()
    for name, got, want in zip(("dx", "da", "db", "dc", "G"), rounded,
                               plain):
        assert got.dtype == torch.float32, name
        err = float((got - want).abs().max())
        assert 0.0 < err <= 1e-3 * float(want.abs().max()), (name, err)


def test_no_gradient_no_autograd_node():
    """Without a gradient (no_grad, or no input that requires one) the scan
    makes no autograd node and keeps nothing."""
    x, a, b, c, _ = (torch.from_numpy(v)
                     for v in _inputs((1, 16, 2, 1, 8, 16), 0))
    assert ssd_scan(x, a, b, c, chunk=8).grad_fn is None
    xg = x.clone().requires_grad_()
    with torch.no_grad():
        assert ssd_scan(xg, a, b, c, chunk=8).grad_fn is None
    y = ssd_scan(xg, a, b, c, chunk=8)
    assert type(y.grad_fn).__name__ == "_SSDScanBackward"


def test_bwd_wrappers_take_cuda_tensors_only():
    """The backward's wrappers launch CUDA kernels: on CPU tensors they raise
    and launch nothing.  The CPU's backward, ssd_bwd_ref, chains their plain
    versions and is the Function's CPU gradient, bit for bit."""
    shape, L = (2, 32, 4, 2, 8, 16), 16
    x, a, b, c, dy = (torch.from_numpy(v) for v in _inputs(shape, 5))
    loga = log_decay(a)
    states, decay, _ = ssd_states_ref(x, loga, b, L)
    counts = (ssd_bwd_state.launches, ssd_bwd_chunk.launches)
    grads = ssd_bwd_state_ref(c, dy, loga, decay, L)
    with pytest.raises(ValueError, match="CUDA"):
        ssd_bwd_state(c, dy, loga, decay, chunk=L)
    with pytest.raises(ValueError, match="CUDA"):
        ssd_bwd_chunk(x, a, loga, b, c, dy, states, grads, chunk=L)
    with pytest.raises(ValueError, match="CUDA"):
        ssd_scan_bwd(x, a, b, c, dy, loga, states, decay, chunk=L)
    assert (ssd_bwd_state.launches, ssd_bwd_chunk.launches) == counts
    want = ssd_bwd_chunk_ref(x, a, loga, b, c, dy, states, grads, L)
    full = ssd_bwd_ref(x, a, b, c, dy, chunk=L)
    leaves = [t.clone().requires_grad_() for t in (x, a, b, c)]
    ssd_scan(*leaves, chunk=L).backward(dy)
    for w, f, t in zip(want, full, leaves):
        assert torch.equal(w, f) and torch.equal(t.grad, f)


def test_states_are_the_recurrence_at_each_chunk_start():
    """ssd_states_ref's h_c (the forward's kept scratch on a card) is the
    sequential recurrence's state after the chunks before c; G_c is the
    gradient of the loss <y, dy> in the state leaving chunk c (float64)."""
    shape, L = (1, 24, 2, 1, 4, 3), 8
    x, a, b, c, dy = (torch.from_numpy(v).double()
                      for v in _inputs(shape, 9))
    loga = log_decay(a)
    states, decay, _ = ssd_states_ref(x, loga, b, L)
    h = torch.zeros((1, 2, 4, 3), dtype=torch.float64)
    for t in range(24):
        if t % L == 0:
            assert torch.allclose(states[:, t // L], h, rtol=0, atol=1e-12)
        h = a[:, t, :, None, None] * h + b[:, t, :, :, None].expand(
            1, 2, 4, 1) * x[:, t, :, None, :]
    grads = ssd_bwd_state_ref(c, dy, loga, decay, L)
    assert not grads[:, -1].any()
    # the loss as a function of the state leaving chunk 0
    h1 = states[:, 1].clone().requires_grad_()
    run, out = h1, 0.0
    for t in range(L, 24):
        run = a[:, t, :, None, None] * run + b[:, t, :, :, None].expand(
            1, 2, 4, 1) * x[:, t, :, None, :]
        out = out + (torch.einsum("bhn,bhnp->bhp", c[:, t].expand(1, 2, 4),
                                  run) * dy[:, t]).sum()
    out.backward()
    assert torch.allclose(grads[:, 0], h1.grad, rtol=0, atol=1e-12)
