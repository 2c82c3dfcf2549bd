"""The fused LSTM cell against paddle_tpu's, on the CPU.

- ``cuda_kernels.fused_lstm_cell`` (on the CPU its plain version,
  ``lstm_cell_reference``) against the JAX package's Pallas kernel
  ``_lstm_cell_pallas`` in interpret mode and against its
  ``_lstm_cell_reference``: h and c to atol = rtol = 1e-5, f32 on both
  sides (the same f32 sums in another order).
- ``_FusedLSTMCell``, the autograd Function the cell runs under on
  either device, whose backward ``lstm_cell_backward`` is written out by
  hand: against ``jax.vjp`` of the JAX reference (what JAX's
  ``_lstm_cell_bwd`` computes) to 1e-5, and against ``gradcheck`` in f64.
- A control, the cell with its input and forget chunks swapped, differs
  from the JAX kernel by far more than the tolerance.
- The dtype contract of the wrapper: h in r_prev's dtype, c in c_prev's,
  the product at bf16 precision only when r_prev and w are both bf16.
- The arithmetic of the card's f32 product: operands split into two
  TF32 values (10 mantissa bits, to nearest, ties away; hi + lo within
  2^-22), whose three products keep the cell's f32 limit where one TF32
  product does not; and what the kernel consumes, r_prev and w as its
  tensor maps read them (``lstm_kernel_operands``: padded to a depth of
  a multiple of 8, read back against w).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from paddle_tpu.ops import pallas_kernels as pk
from paddle_tpu_torch.ops import cuda_kernels as ck

TOL = dict(atol=1e-5, rtol=1e-5)

# (B, H): the sequence path's width cut down; H not a multiple of the
# kernel's 32-unit tile; a single row
SHAPES = [(4, 8), (3, 37), (1, 16), (6, 32)]


def _operands(B, H, seed=0):
    rng = np.random.RandomState(seed + 7 * H + B)
    return (rng.randn(B, 4 * H).astype('float32'),
            (0.5 * rng.randn(B, H)).astype('float32'),
            rng.randn(B, H).astype('float32'),
            (rng.randn(H, 4 * H) / np.sqrt(H)).astype('float32'))


def _swapped_gates(xg, r_prev, c_prev, w):
    """A wrong cell: the input and forget chunks of xg and w swapped."""
    def swap(t):
        gc, gi, gf, go = t.chunk(4, dim=-1)
        return torch.cat([gc, gf, gi, go], dim=-1)
    return ck.lstm_cell_reference(swap(xg), r_prev, c_prev, swap(w))


@pytest.mark.parametrize('B,H', SHAPES)
def test_cell_matches_pallas_kernel_and_reference(B, H):
    ops = _operands(B, H)
    h, c = ck.fused_lstm_cell(*[torch.from_numpy(a) for a in ops])
    assert h.dtype == c.dtype == torch.float32 and h.shape == (B, H)
    jops = [jnp.asarray(a) for a in ops]
    jh, jc = pk._lstm_cell_pallas(*jops, interpret=True)
    rh, rc = pk._lstm_cell_reference(*jops)
    for got, want in ((h, jh), (c, jc), (h, rh), (c, rc)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize('B,H', SHAPES)
def test_cell_gradient_matches_jax_vjp(B, H):
    ops = _operands(B, H, seed=1)
    rng = np.random.RandomState(B + H)
    g_h = rng.randn(B, H).astype('float32')
    g_c = rng.randn(B, H).astype('float32')
    ts = [torch.from_numpy(a).requires_grad_() for a in ops]
    h, c = ck.fused_lstm_cell(*ts)
    assert h.grad_fn is not None and 'FusedLSTMCell' in type(
        h.grad_fn).__name__
    got = torch.autograd.grad((h, c), ts, (torch.from_numpy(g_h),
                                           torch.from_numpy(g_c)))
    _, vjp = jax.vjp(pk._lstm_cell_reference, *[jnp.asarray(a) for a in ops])
    want = vjp((jnp.asarray(g_h), jnp.asarray(g_c)))
    for name, a, b in zip(('xg', 'r_prev', 'c_prev', 'w'), got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), err_msg=name,
                                   **TOL)


def test_cell_gradient_gradcheck_f64():
    torch.manual_seed(0)
    B, H = 3, 5
    ts = [torch.randn(s, dtype=torch.float64, requires_grad=True)
          for s in ((B, 4 * H), (B, H), (B, H), (H, 4 * H))]
    assert torch.autograd.gradcheck(ck.fused_lstm_cell, ts)


def test_swapped_gates_control_fails():
    ops = _operands(6, 32, seed=2)
    h, c = _swapped_gates(*[torch.from_numpy(a) for a in ops])
    jh, jc = pk._lstm_cell_pallas(*[jnp.asarray(a) for a in ops],
                                  interpret=True)
    err = max(np.abs(h.numpy() - np.asarray(jh)).max(),
              np.abs(c.numpy() - np.asarray(jc)).max())
    assert err > 1e3 * TOL['atol'], err


def test_dtype_contract():
    xg, r, c, w = [torch.from_numpy(a) for a in _operands(4, 8)]
    h, c_out = ck.fused_lstm_cell(xg, r.bfloat16(), c, w.bfloat16())
    assert h.dtype == torch.bfloat16 and c_out.dtype == torch.float32
    # both bf16: products of bf16 values, exact in f32, summed in f32
    want_h, want_c = ck.lstm_cell_reference(
        xg, r.bfloat16().float(), c, w.bfloat16().float())
    np.testing.assert_allclose(c_out.numpy(), want_c.numpy(), **TOL)
    # mixed: the product in f32 (bf16 r promoted), h back in bf16
    h, c_out = ck.fused_lstm_cell(xg, r.bfloat16(), c.bfloat16(), w)
    assert h.dtype == torch.bfloat16 and c_out.dtype == torch.bfloat16
    want_h, want_c = ck.lstm_cell_reference(xg, r.bfloat16().float(), c
                                            .bfloat16().float(), w)
    np.testing.assert_allclose(c_out.float().numpy(),
                               want_c.bfloat16().float().numpy(), **TOL)


# ---- the card's f32 product scheme, and what its kernel consumes ------------
# csrc/lstm_cell.cu runs the f32 product on the tensor cores as three TF32
# products of operands split as x = hi + lo (cvt.rna.tf32.f32, in the
# kernel); r_prev and w reach its tensor maps through
# cuda_kernels.lstm_kernel_operands.


def _tf32_split(x):
    """(hi, lo) of f32 ``x``: hi is x rounded to 10 mantissa bits, to
    nearest with ties away from zero (cvt.rna.tf32.f32), and lo is x - hi
    rounded the same way. Finite inputs."""
    def rna(v):
        bits = v.contiguous().view(torch.int32)
        return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)
    hi = rna(x.float())
    return hi, rna(x.float() - hi)


def _low13(t):
    return t.contiguous().view(torch.int32) & 0x1FFF


@pytest.mark.parametrize('scale', [1e-3, 1.0, 3e4])
def test_tf32_split_keeps_ten_mantissa_bits(scale):
    x = torch.from_numpy(np.random.RandomState(5).randn(4096)
                         .astype('float32') * scale)
    hi, lo = _tf32_split(x)
    assert not _low13(hi).any() and not _low13(lo).any()
    assert torch.all(lo.abs() <= 2.0 ** -11 * hi.abs())
    err = (x.double() - hi.double() - lo.double()).abs()
    assert torch.all(err <= 2.0 ** -22 * x.double().abs())


def test_tf32_split_rounds_to_nearest_ties_away():
    one, half_ulp = 1.0, 2.0 ** -11
    x = torch.tensor([one + half_ulp, -(one + half_ulp), one + half_ulp / 2,
                      one + 3 * half_ulp / 2], dtype=torch.float32)
    hi, _ = _tf32_split(x)
    want = [one + 2 * half_ulp, -(one + 2 * half_ulp), one,
            one + 2 * half_ulp]
    assert hi.tolist() == want


@pytest.mark.parametrize('B,H', [(4, 8), (3, 37), (16, 512)])
def test_three_tf32_products_keep_f32_accuracy(B, H):
    """w_lo r_hi + w_hi r_lo + w_hi r_hi (summed exactly, in f64) against
    the f64 product, per element within the cell's f32 limit (1e-5 of the
    value plus 1e-5 of the rms); the one-product TF32 control fails it at
    H 512."""
    xg, r, c, w = [torch.from_numpy(a) for a in _operands(B, H, seed=3)]
    r_hi, r_lo = _tf32_split(r)
    w_hi, w_lo = _tf32_split(w)
    d = torch.float64
    three = (r_hi.to(d) @ w_lo.to(d) + r_lo.to(d) @ w_hi.to(d) +
             r_hi.to(d) @ w_hi.to(d))
    exact = r.to(d) @ w.to(d)
    limit = 1e-5 * exact.abs() + 1e-5 * exact.pow(2).mean().sqrt()
    assert torch.all((three - exact).abs() <= limit)
    if H >= 512:
        one = r_hi.to(d) @ w_hi.to(d)
        assert torch.any((one - exact).abs() > limit)


@pytest.mark.parametrize('H', [8, 37, 512])
@pytest.mark.parametrize('dot', [torch.float32, torch.bfloat16])
def test_kernel_operands_read_back(H, dot):
    """r_prev [B, Hp] and w [Hp, 4Hp] as the kernel's maps read them: Hp
    is H rounded up to 8; gate q of w at columns q * Hp; the padding is 0
    (it adds nothing to the product); 16-byte aligned."""
    _, r, _, w = [torch.from_numpy(a) for a in _operands(3, H, seed=4)]
    rk, wk = ck.lstm_kernel_operands(r, w, dot)
    Hp = ck.lstm_padded_depth(H)
    assert Hp % 8 == 0 and H <= Hp < H + 8
    assert rk.shape == (3, Hp) and wk.shape == (Hp, 4 * Hp)
    assert rk.dtype == wk.dtype == dot
    assert rk.is_contiguous() and wk.is_contiguous()
    assert rk.data_ptr() % 16 == 0 and wk.data_ptr() % 16 == 0
    gates = wk.view(Hp, 4, Hp)
    assert torch.equal(gates[:H, :, :H], w.to(dot).view(H, 4, H))
    assert not gates[H:].any() and not gates[:, :, H:].any()
    assert torch.equal(rk[:, :H], r.to(dot)) and not rk[:, H:].any()
    np.testing.assert_allclose((rk.float() @ wk.float()).view(3, 4, Hp)[
        :, :, :H].reshape(3, 4 * H).numpy(),
        (r.to(dot).float() @ w.to(dot).float()).numpy(), rtol=1e-6,
        atol=1e-6)


# ---- chip_smoke.py's product witness --------------------------------------
# On the card, phase 13 reads the kernel's recurrent product alone through
# saturated gates (chip_smoke._product_probe) and holds its error against
# the f64 product to twice the plain version's. Here: those inputs make
# the plain cell return its own f32 product bit for bit, on every gate's
# slice, so the probe adds no rounding of its own.


def _chip_smoke():
    import importlib.util
    import os
    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), 'chip_smoke.py')
    spec = importlib.util.spec_from_file_location('chip_smoke', path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize('B,H', [(3, 37), (7, 1000), (16, 512)])
def test_saturated_gates_read_the_product(B, H):
    _, r, _, w = [torch.from_numpy(a) for a in _operands(B, H, seed=6)]
    xg, c0, ws, exact = _chip_smoke()._product_probe(r, w)
    assert len(ws) == 4
    for q, (wq, want) in enumerate(zip(ws, exact)):
        torch.testing.assert_close(
            wq[:, :H], w[:, q * H:(q + 1) * H] * 2.0 ** -16, rtol=0, atol=0)
        _, g = ck.lstm_cell_reference(xg, r, c0, wq)
        assert torch.equal(g, torch.matmul(r, wq)[:, :H])
        # the f32 product, a few of its own roundings from the f64 one
        assert ((g.double() - want).abs() <=
                1e-6 * want.abs().max()).all()
