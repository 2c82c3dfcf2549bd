"""Sequence op kernels on SequenceTensor (padded [B, T, ...] + lengths).

Counterpart of paddle_tpu/ops/sequence_ops.py (its lines 19-174):
``sequence_pool`` with every pool type at LoD levels 1 and 2,
``sequence_softmax`` and ``sequence_expand`` (padded layout), and the
helpers ``masked_reverse`` and ``_pool_core``. Every kernel is a masked
dense computation on the device, differentiable by autograd, as the JAX
package's are.

Left for a later slice (ROADMAP Queue A): sequence_reshape, lod_reset,
sequence_concat, sequence_erase, sequence_slice, sequence_conv, row_conv,
im2sequence, and the packed-rows branch of sequence_expand.
"""
import torch

from ..core.registry import register_kernel
from ..lod import SequenceTensor
from .common import step_mask, unwrap

# the MAX pool's fill for padded steps, as the JAX kernel's
_MAX_FILL = -3.4e38


def _seq(v, what='input'):
    if not isinstance(v, SequenceTensor):
        raise TypeError("%s must be a SequenceTensor, got %r" %
                        (what, type(v)))
    return v


def masked_reverse(data, lengths):
    """Reverse each sequence's valid prefix in place (padding stays put).
    data [B, T, ...], lengths [B]."""
    t = data.shape[1]
    ar = torch.arange(t, device=data.device)[None, :]
    L = lengths.to(device=data.device, dtype=torch.int64)[:, None]
    idx = torch.where(ar < L, L - 1 - ar, ar)
    idx = idx.reshape(tuple(idx.shape) + (1,) * (data.dim() - 2))
    return torch.gather(data, 1, idx.expand(data.shape))


# ---- pooling --------------------------------------------------------------------
def _pool_core(x, lengths, pool):
    """Level-1 pooling over axis 1 of [N, T, feat...]; empty sequences
    (length 0) pool to 0, the reference's pad_value default. Returns
    (out [N, feat...], max_index or None)."""
    extra = x.dim() - 2
    m = step_mask(lengths, x.shape[1], x.dtype, extra)
    Lb = torch.clamp(lengths, min=1).to(x.dtype).reshape((-1,) + (1,) * extra)
    max_index = None
    if pool == 'SUM':
        out = (x * m).sum(1)
    elif pool == 'AVERAGE':
        out = (x * m).sum(1) / Lb
    elif pool == 'SQRT':
        out = (x * m).sum(1) / torch.sqrt(Lb)
    elif pool == 'MAX':
        masked = torch.where(m > 0, x, torch.full_like(x, _MAX_FILL))
        # amax shares the gradient among ties as jnp.max does; argmax
        # gives the first maximal step as jnp.argmax does
        out = masked.amax(1)
        max_index = masked.argmax(1).to(torch.int32)
    elif pool == 'FIRST':
        out = x[:, 0]
    elif pool == 'LAST':
        idx = torch.clamp(lengths - 1, min=0).to(torch.int64)
        idx = idx.reshape((-1, 1) + (1,) * extra).expand(
            (x.shape[0], 1) + tuple(x.shape[2:]))
        out = torch.gather(x, 1, idx)[:, 0]
    else:
        raise ValueError("unknown pooltype %r" % pool)
    # empty sequences pool to 0, MAX's fill included
    empty = lengths <= 0
    keep = (~empty).to(x.dtype).reshape((-1,) + (1,) * (out.dim() - 1))
    out = out * keep
    if max_index is not None:
        max_index = max_index * (~empty).to(torch.int32).reshape(
            (-1,) + (1,) * (max_index.dim() - 1))
    return out, max_index


@register_kernel('sequence_pool')
def _sequence_pool(ctx):
    st = _seq(ctx.input('X'))
    pool = (ctx.attr('pooltype', 'AVERAGE') or 'AVERAGE').upper()
    x = st.data
    if st.sub_lengths is not None:
        # level 2: the reference pools the innermost sequences and drops
        # that level (sequence_pooling.cc pools over lod[-1]): [B, O, I,
        # feat] -> level-1 [B, O, feat]; outer padding rows have
        # sub_lengths 0 and pool to 0
        B, O = x.shape[0], x.shape[1]
        out, max_index = _pool_core(
            x.reshape((B * O,) + tuple(x.shape[2:])),
            st.sub_lengths.reshape(-1), pool)
        out = out.reshape((B, O) + tuple(out.shape[1:]))
        if ctx.output_names('MaxIndex'):
            if max_index is None:
                max_index = torch.zeros(out.shape, dtype=torch.int32,
                                        device=out.device)
            else:
                max_index = max_index.reshape((B, O) +
                                              tuple(max_index.shape[1:]))
            ctx.set_output('MaxIndex', SequenceTensor(max_index, st.lengths))
        ctx.set_output('Out', SequenceTensor(out, st.lengths))
        return
    out, max_index = _pool_core(x, st.lengths, pool)
    if ctx.output_names('MaxIndex'):
        if max_index is None:
            max_index = torch.zeros(out.shape, dtype=torch.int32,
                                    device=out.device)
        ctx.set_output('MaxIndex', max_index)
    ctx.set_output('Out', out)


@register_kernel('sequence_softmax')
def _sequence_softmax(ctx):
    st = _seq(ctx.input('X'))
    x = st.data
    # the canonical use: scores [B, T, 1] (or [B, T]); softmax over the
    # valid steps, 0 on the padding
    squeeze = x.dim() > 2 and x.shape[-1] == 1
    v = x[..., 0] if squeeze else x
    m = step_mask(st.lengths, x.shape[1], torch.bool)
    v = torch.where(m, v.float(), torch.full_like(v, float('-inf'),
                                                  dtype=torch.float32))
    out = torch.where(m, torch.softmax(v, dim=1), torch.zeros_like(v))
    if squeeze:
        out = out[..., None]
    ctx.set_output('Out', SequenceTensor(out.to(x.dtype), st.lengths,
                                         st.sub_lengths))


# ---- expand ---------------------------------------------------------------------
@register_kernel('sequence_expand')
def _sequence_expand(ctx):
    """Expand x's rows to y's sequences. The canonical NMT use: x [B, D]
    dense, each row broadcast over y's steps; x a SequenceTensor is
    re-lengthed to y's (its time axis cut or zero-padded to y's)."""
    x_in = ctx.input('X')
    y = _seq(ctx.input('Y'), 'Y')
    T = y.data.shape[1]
    if isinstance(x_in, SequenceTensor):
        xd = x_in.data
        if xd.shape[1] >= T:
            out = xd[:, :T]
        else:
            pad = torch.zeros((xd.shape[0], T - xd.shape[1]) +
                              tuple(xd.shape[2:]), dtype=xd.dtype,
                              device=xd.device)
            out = torch.cat([xd, pad], 1)
    else:
        xd = unwrap(x_in)
        out = xd[:, None].expand((xd.shape[0], T) + tuple(xd.shape[1:]))
    ctx.set_output('Out', SequenceTensor(out, y.lengths, y.sub_lengths))
