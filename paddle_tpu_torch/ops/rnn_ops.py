"""Recurrent op kernels: dynamic_lstm(p), dynamic_gru, gru_unit, lstm_unit
(the first three also under the reference's op types lstm, lstmp, gru).

Counterpart of paddle_tpu/ops/rnn_ops.py. Each RNN is a Python loop over
the padded time axis, time-major, with a carried mask: the JAX package's
``lax.scan`` run eagerly. Peephole-free, unprojected LSTMs with the
default activations run each step on the fused cell
(``cuda_kernels.fused_lstm_cell``: ``csrc/lstm_cell.cu`` on the card);
every other cell is plain PyTorch, as it is plain XLA in the JAX package.

Gate layouts follow the reference exactly (and are not ``torch.nn.LSTM``'s
(i, f, g, o)):
  lstm   Weight [H, 4H] = {W_ch, W_ih, W_fh, W_oh}: gate chunks are
         (candidate, input, forget, output). Peephole bias [1, 7H] =
         [b_c b_i b_f b_o | W_ic W_fc W_oc].
  gru    Weight [H, 3H] = {W_uh W_rh | W_ch}; h = (1-u)*h_prev + u*c.
  lstm_unit  X chunks are (i, f, o, g).

The mask blend ``m*r + (1-m)*r_prev`` of the JAX scan is written as a
select, ``where(m, r, r_prev)``: the same values for a 0/1 mask (and the
same gradients), in one launch instead of three on a loop that the host
holds.
"""
import contextlib

import torch

from ..core.registry import register_kernel
from ..lod import SequenceTensor
from . import cuda_kernels
from .common import step_mask, unwrap
from .sequence_ops import masked_reverse

_IDENTITY = lambda x: x  # noqa: E731

_ACT = {
    'sigmoid': torch.sigmoid,
    'tanh': torch.tanh,
    'relu': torch.relu,
    'identity': _IDENTITY,
    None: _IDENTITY,
}

# the fused cell the scan calls; swapped only by lstm_cell_for_testing
_LSTM_CELL = [cuda_kernels.fused_lstm_cell]


@contextlib.contextmanager
def lstm_cell_for_testing(fn=cuda_kernels.lstm_cell_reference):
    """Test-only: make the fused branch of the LSTM scan call ``fn(xg,
    r_prev, c_prev, w) -> (h, c)`` instead of the kernel's wrapper, on
    every device. The default, the plain version (differentiable by
    autograd), compares a whole program with and without the kernel on
    the same inputs; a deliberately wrong ``fn`` is a control that the
    comparison must catch."""
    prev = _LSTM_CELL[0]
    _LSTM_CELL[0] = fn
    try:
        yield
    finally:
        _LSTM_CELL[0] = prev


def _step_masks(lengths, T):
    """T boolean [B, 1] masks, True where step t is below the length."""
    return step_mask(lengths, T, torch.bool).t()[..., None].unbind(0)


def _lstm_scan(x, lengths, w, b, h0, c0, use_peep, gact, cact, candact,
               proj=None, pact=None):
    """The shared lstm/lstmp scan. x: [B, T, 4H] pre-projected inputs.
    Returns (recurrent_out [B, T, R], cell [B, T, H])."""
    H = w.shape[1] // 4
    gate_b = b[:, :4 * H]
    if use_peep:
        w_ic, w_fc, w_oc = (b[0, 4 * H:5 * H], b[0, 5 * H:6 * H],
                            b[0, 6 * H:7 * H])
    T = x.shape[1]
    # time-major steps as views: xg of step t is [B, 4H] with a row
    # stride, which the kernel takes; unbind's backward stacks the steps'
    # gradients in one pass
    xts = (x.transpose(0, 1) + gate_b).unbind(0)
    # default-activation, peephole-free, unprojected cells take the fused
    # cell: the recurrent product and all gates in one launch a step
    fused_ok = (not use_peep and proj is None and gact is torch.sigmoid
                and cact is torch.tanh and candact is torch.tanh)
    cell = _LSTM_CELL[0]
    r_prev, c_prev = h0, c0
    rs, cs = [], []
    for xg, m in zip(xts, _step_masks(lengths, T)):
        if fused_ok:
            r, c = cell(xg, r_prev, c_prev, w)
        else:
            g = xg + torch.matmul(r_prev, w)
            gc, gi, gf, go = g.chunk(4, dim=-1)
            if use_peep:
                gi = gi + c_prev * w_ic
                gf = gf + c_prev * w_fc
            i = gact(gi)
            f = gact(gf)
            c = candact(gc) * i + c_prev * f
            if use_peep:
                go = go + c * w_oc
            h = gact(go) * cact(c)
            r = pact(torch.matmul(h, proj)) if proj is not None else h
        r_prev = torch.where(m, r, r_prev)
        c_prev = torch.where(m, c, c_prev)
        rs.append(r_prev)
        cs.append(c_prev)
    return torch.stack(rs, 1), torch.stack(cs, 1)


def _seq_input(ctx):
    st = ctx.input('Input')
    if not isinstance(st, SequenceTensor):
        raise TypeError("%s needs a SequenceTensor input" % ctx.op.type)
    return st


def _state0(ctx, slot, B, size, like):
    if ctx.has_input(slot):
        return unwrap(ctx.input(slot))
    return torch.zeros((B, size), dtype=like.dtype, device=like.device)


def _lstm_acts(ctx):
    return (_ACT[ctx.attr('gate_activation', 'sigmoid')],
            _ACT[ctx.attr('cell_activation', 'tanh')],
            _ACT[ctx.attr('candidate_activation', 'tanh')])


@register_kernel('dynamic_lstm')
@register_kernel('lstm')
def _dynamic_lstm(ctx):
    st = _seq_input(ctx)
    x = st.data                                   # [B, T, 4H]
    w = unwrap(ctx.input('Weight'))               # [H, 4H]
    b = unwrap(ctx.input('Bias'))                 # [1, 4H] or [1, 7H]
    H = w.shape[0]
    use_peep = bool(ctx.attr('use_peepholes', True)) and b.shape[-1] == 7 * H
    is_rev = bool(ctx.attr('is_reverse', False))
    if is_rev:
        x = masked_reverse(x, st.lengths)
    B = x.shape[0]
    hs, cs = _lstm_scan(x, st.lengths, w, b, _state0(ctx, 'H0', B, H, x),
                        _state0(ctx, 'C0', B, H, x), use_peep,
                        *_lstm_acts(ctx))
    if is_rev:
        hs = masked_reverse(hs, st.lengths)
        cs = masked_reverse(cs, st.lengths)
    ctx.set_output('Hidden', SequenceTensor(hs, st.lengths))
    ctx.set_output('Cell', SequenceTensor(cs, st.lengths))
    for slot in ('BatchGate', 'BatchCellPreAct'):
        # the reference's reordered-batch buffers; nothing reads them here
        if ctx.output_names(slot):
            ctx.set_output(slot, torch.zeros((1,), dtype=x.dtype,
                                             device=x.device))


@register_kernel('dynamic_lstmp')
@register_kernel('lstmp')
def _dynamic_lstmp(ctx):
    st = _seq_input(ctx)
    x = st.data                                   # [B, T, 4H]
    w = unwrap(ctx.input('Weight'))               # [P, 4H]
    wp = unwrap(ctx.input('ProjWeight'))          # [H, P]
    b = unwrap(ctx.input('Bias'))
    H, P = wp.shape
    use_peep = bool(ctx.attr('use_peepholes', True)) and b.shape[-1] == 7 * H
    is_rev = bool(ctx.attr('is_reverse', False))
    if is_rev:
        x = masked_reverse(x, st.lengths)
    B = x.shape[0]
    rs, cs = _lstm_scan(x, st.lengths, w, b, _state0(ctx, 'H0', B, P, x),
                        _state0(ctx, 'C0', B, H, x), use_peep,
                        *_lstm_acts(ctx), proj=wp,
                        pact=_ACT[ctx.attr('proj_activation', 'tanh')])
    if is_rev:
        rs = masked_reverse(rs, st.lengths)
        cs = masked_reverse(cs, st.lengths)
    ctx.set_output('Projection', SequenceTensor(rs, st.lengths))
    ctx.set_output('Cell', SequenceTensor(cs, st.lengths))


def _gru_weight_chunks(w, H):
    """The reference's gru weight layout (gru_op.h, gru_unit_op.h): the
    [H, 3H] parameter is a contiguous [H, 2H] update/reset block followed
    by an [H, H] candidate block, not column slices."""
    flat = w.reshape(-1)
    return (flat[:2 * H * H].reshape(H, 2 * H),
            flat[2 * H * H:].reshape(H, H))


@register_kernel('dynamic_gru')
@register_kernel('gru')
def _dynamic_gru(ctx):
    st = _seq_input(ctx)
    x = st.data                                   # [B, T, 3H]
    w = unwrap(ctx.input('Weight'))               # [H, 3H]
    H = w.shape[0]
    gact = _ACT[ctx.attr('gate_activation', 'sigmoid')]
    cact = _ACT[ctx.attr('activation', 'tanh')]
    w_g, w_c = _gru_weight_chunks(w, H)
    is_rev = bool(ctx.attr('is_reverse', False))
    if is_rev:
        x = masked_reverse(x, st.lengths)
    xt = x.transpose(0, 1)
    if ctx.has_input('Bias'):
        xt = xt + unwrap(ctx.input('Bias'))
    h_prev = _state0(ctx, 'H0', x.shape[0], H, x)
    hs = []
    for xg, m in zip(xt.unbind(0), _step_masks(st.lengths, x.shape[1])):
        g = gact(xg[:, :2 * H] + torch.matmul(h_prev, w_g))
        u, r = g[:, :H], g[:, H:]
        c = cact(xg[:, 2 * H:] + torch.matmul(r * h_prev, w_c))
        h = (1 - u) * h_prev + u * c   # ref gru_kernel.h:62
        h_prev = torch.where(m, h, h_prev)
        hs.append(h_prev)
    hs = torch.stack(hs, 1)
    if is_rev:
        hs = masked_reverse(hs, st.lengths)
    ctx.set_output('Hidden', SequenceTensor(hs, st.lengths))


@register_kernel('gru_unit')
def _gru_unit(ctx):
    x = unwrap(ctx.input('Input'))                # [B, 3H]
    h_prev = unwrap(ctx.input('HiddenPrev'))
    w = unwrap(ctx.input('Weight'))               # [H, 3H]
    H = w.shape[0]
    gact = _ACT[ctx.attr('gate_activation', 'sigmoid')]
    cact = _ACT[ctx.attr('activation', 'tanh')]
    w_ur, w_cand = _gru_weight_chunks(w, H)
    xg = x + unwrap(ctx.input('Bias')) if ctx.has_input('Bias') else x
    g = gact(xg[:, :2 * H] + torch.matmul(h_prev, w_ur))
    u, r = g[:, :H], g[:, H:]
    rhp = r * h_prev
    c = cact(xg[:, 2 * H:] + torch.matmul(rhp, w_cand))
    h = (1 - u) * h_prev + u * c   # ref gru_unit_op.h: u*(c-h_p)+h_p
    ctx.set_output('Gate', torch.cat([u, r, c], dim=-1))
    ctx.set_output('ResetHiddenPrev', rhp)
    ctx.set_output('Hidden', h)


@register_kernel('lstm_unit')
def _lstm_unit(ctx):
    """A single LSTM step. X = fc([x_t, h_prev]) [B, 4H]; gate chunks (i,
    f, o, g) per the reference's lstm_unit_op.h:63-67; forget_bias added
    to f."""
    x = unwrap(ctx.input('X'))
    c_prev = unwrap(ctx.input('C_prev'))
    fb = float(ctx.attr('forget_bias', 0.0))
    gi, gf, go, gg = x.chunk(4, dim=-1)
    c = torch.sigmoid(gf + fb) * c_prev + torch.sigmoid(gi) * torch.tanh(gg)
    h = torch.sigmoid(go) * torch.tanh(c)
    ctx.set_output('C', c)
    ctx.set_output('H', h)
