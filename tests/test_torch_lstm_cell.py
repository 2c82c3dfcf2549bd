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
