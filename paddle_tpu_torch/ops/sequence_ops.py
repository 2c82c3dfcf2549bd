"""Sequence op kernels on SequenceTensor (padded [B, T, ...] + lengths).

Counterpart of paddle_tpu/ops/sequence_ops.py: ``sequence_pool`` with
every pool type at LoD levels 1 and 2, ``sequence_softmax``,
``sequence_expand`` (its packed-rows branch too), ``sequence_reshape``,
``lod_reset`` (its packed branch too), ``sequence_concat``,
``sequence_erase``, ``sequence_slice``, ``sequence_conv``, ``row_conv``
and ``im2sequence``, and the helpers ``masked_reverse`` and
``_pool_core``. Every padded kernel is a masked dense computation on the
device, differentiable by autograd, as the JAX package's are; the
packed branches (the dynamic beam decode) keep the reference's rows and
offset LoD.

``im2sequence`` is the body the JAX package's registry keeps: its
``ops/__init__.py`` imports ``sequence_ops`` after ``nn_ops``, so the
kernel of ``sequence_ops.py`` replaces the one of ``nn_ops.py``.
"""
import numpy as np
import torch
import torch.nn.functional as F

from ..core.registry import register_kernel
from ..lod import SequenceTensor, bucket_length
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
    re-lengthed to y's (its time axis cut or zero-padded to y's). A
    packed y (operators/sequence_expand_op.h): x's row i is repeated by
    the i-th size of y's ``ref_level`` (by default its last level)."""
    x_in = ctx.input('X')
    y_in = ctx.input('Y')
    if isinstance(y_in, SequenceTensor) and y_in.packed_mode:
        offs = y_in.offsets()
        ref_level = int(ctx.attr('ref_level', -1))
        ref = offs[ref_level if ref_level >= 0 else len(offs) - 1]
        repeats = [int(b - a) for a, b in zip(ref[:-1], ref[1:])]
        xd = unwrap(x_in)
        out = torch.repeat_interleave(
            xd, torch.tensor(repeats, device=xd.device), dim=0,
            output_size=sum(repeats))
        ctx.set_output('Out', SequenceTensor.from_packed(out, offs))
        return
    y = _seq(y_in, 'Y')
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


@register_kernel('sequence_reshape')
def _sequence_reshape(ctx):
    st = _seq(ctx.input('X'))
    new_dim = int(ctx.attr('new_dim'))
    B, T, D = st.data.shape[0], st.data.shape[1], st.data.shape[-1]
    if (T * D) % new_dim != 0:
        raise ValueError("sequence_reshape: T*D=%d not divisible by %d" %
                         (T * D, new_dim))
    out = st.data.reshape(B, T * D // new_dim, new_dim)
    ctx.set_output('Out', SequenceTensor(
        out, torch.div(st.lengths * D, new_dim, rounding_mode='floor')))


def _to_packed(x_in):
    """x's rows in the reference's packed [total, *feat] order (the
    padded steps after them)."""
    if not isinstance(x_in, SequenceTensor):
        return unwrap(x_in)
    d = x_in.data
    B, T = d.shape[0], d.shape[1]
    flat = d.reshape((B * T,) + tuple(d.shape[2:]))
    ar = torch.arange(B * T, device=d.device)
    valid = step_mask(x_in.lengths, T, torch.bool).reshape(-1)
    return flat.index_select(0, torch.argsort(
        torch.where(valid, ar, B * T + ar)))


@register_kernel('lod_reset')
def _lod_reset(ctx):
    """Re-segment x's packed rows into new sequence lengths. Parity:
    operators/lod_reset_op.*, where only the offset table changes; in
    the padded layout the rows are regrouped. A packed y keeps the rows
    as they are under y's offsets, exactly the reference."""
    x_in = ctx.input('X')
    y = ctx.input('Y') if ctx.has_input('Y') else None
    if isinstance(y, SequenceTensor) and y.packed_mode:
        ctx.set_output('Out', SequenceTensor.from_packed(unwrap(x_in),
                                                         y.offsets()))
        return
    packed = _to_packed(x_in)
    dev = packed.device
    T_out = None
    if isinstance(y, SequenceTensor):
        lens = y.lengths
        T_out = int(y.data.shape[1])
    elif y is not None:
        # an offset-style target lod [0, o1, o2, ...]
        yv = unwrap(y).reshape(-1).long()
        lens = yv[1:] - yv[:-1]
    else:
        tl = np.asarray(ctx.attr('target_lod'), 'int64').reshape(-1)
        ls = tl[1:] - tl[:-1] if tl.size and tl[0] == 0 else tl
        T_out = bucket_length(int(ls.max())) if ls.size else 1
        lens = torch.tensor(ls, dtype=torch.int64, device=dev)
    if T_out is None:
        T_out = int(packed.shape[0])
    offs = torch.cumsum(lens, 0) - lens
    idx = offs[:, None] + torch.arange(T_out, device=dev)[None, :]
    out = packed.index_select(0, idx.clamp(0, packed.shape[0] - 1)
                              .reshape(-1))
    out = out.reshape((int(lens.shape[0]), T_out) + tuple(packed.shape[1:]))
    out = out * step_mask(lens, T_out, out.dtype, packed.dim() - 1)
    ctx.set_output('Out', SequenceTensor(out, lens))


def _take_steps(d, idx):
    """d[b, idx[b, t]] along the time axis, idx [B, T']."""
    idx = idx.reshape(tuple(idx.shape) + (1,) * (d.dim() - 2))
    return torch.gather(d, 1, idx.expand(tuple(idx.shape[:2]) +
                                         tuple(d.shape[2:])))


@register_kernel('sequence_concat')
def _sequence_concat(ctx):
    """Concatenate corresponding sequences along time (their valid
    prefixes, one after the other)."""
    xs = [_seq(v) for v in ctx.inputs('X')]
    if len(xs) == 1:
        ctx.set_output('Out', xs[0])
        return
    total_T = sum(int(s.data.shape[1]) for s in xs)
    d0 = xs[0].data
    dev = d0.device
    res = torch.zeros((d0.shape[0], total_T) + tuple(d0.shape[2:]),
                      dtype=d0.dtype, device=dev)
    start = torch.zeros(d0.shape[0], dtype=torch.int64, device=dev)
    t_out = torch.arange(total_T, device=dev)
    for s in xs:
        d, ln = s.data, s.lengths
        src = t_out[None, :] - start[:, None]                  # [B, T]
        valid = (src >= 0) & (src < ln[:, None])
        d = F.pad(d, (0, 0) * (d.dim() - 2) + (0, total_T - d.shape[1]))
        shifted = _take_steps(d, src.clamp(0, total_T - 1))
        res = torch.where(valid.reshape(tuple(valid.shape) +
                                        (1,) * (d.dim() - 2)), shifted, res)
        start = start + ln
    ctx.set_output('Out', SequenceTensor(res, start))


@register_kernel('sequence_erase')
def _sequence_erase(ctx):
    """Drop the listed tokens, the rest moved to the front in order."""
    st = _seq(ctx.input('X'))
    tokens = [int(t) for t in ctx.attr('tokens') or []]
    x = st.data
    ids = x[..., 0] if x.dim() == 3 else x                     # [B, T]
    T = ids.shape[1]
    keep = step_mask(st.lengths, T, torch.bool)
    if tokens:
        keep = keep & ~torch.isin(ids, torch.tensor(
            tokens, dtype=ids.dtype, device=ids.device))
    ar = torch.arange(T, device=ids.device)[None, :]
    perm = torch.argsort(torch.where(keep, ar, T + ar), dim=1)
    compacted = torch.gather(ids, 1, perm)
    new_len = keep.sum(1)
    compacted = torch.where(ar < new_len[:, None], compacted,
                            torch.zeros_like(compacted))
    if x.dim() == 3:
        compacted = compacted[..., None]
    ctx.set_output('Out', SequenceTensor(compacted, new_len))


@register_kernel('sequence_slice')
def _sequence_slice(ctx):
    """Each sequence's steps [offset, offset + length)."""
    st = _seq(ctx.input('X'))
    off = unwrap(ctx.input('Offset')).reshape(-1).long()
    ln = unwrap(ctx.input('Length')).reshape(-1).long()
    x = st.data
    T = x.shape[1]
    idx = off[:, None] + torch.arange(T, device=x.device)[None, :]
    out = _take_steps(x, idx.clamp(0, T - 1))
    out = out * step_mask(ln, T, x.dtype, x.dim() - 2)
    ctx.set_output('Out', SequenceTensor(out, ln))


# ---- convolution over time ------------------------------------------------------
def _valid_shift(T, shift, lengths):
    """[B, T, 1] 1 where the step shifted by ``shift`` lies in [0, len)."""
    src = torch.arange(T, device=lengths.device)[None, :] + shift
    ok = (src >= 0) & (src < lengths[:, None])
    return ok[..., None].to(torch.float32)


@register_kernel('sequence_conv')
def _sequence_conv(ctx):
    """out[b, t] = concat_j x[b, t + start + j] @ W, 0 outside the
    lengths. Parity: operators/sequence_conv_op.* (context projection
    and a product), in f32 as the JAX kernel's einsum."""
    st = _seq(ctx.input('X'))
    w = unwrap(ctx.input('Filter'))
    start = int(ctx.attr('contextStart', -1))
    length = int(ctx.attr('contextLength', 3))
    x = st.data
    T = x.shape[1]
    m = step_mask(st.lengths, T, torch.float32, 1)
    xm = x * m
    cols = [torch.roll(xm, -(start + j), 1) *
            _valid_shift(T, start + j, st.lengths) for j in range(length)]
    out = torch.matmul(torch.cat(cols, -1).float(), w.float())
    ctx.set_output('Out', SequenceTensor((out * m).to(x.dtype), st.lengths))


@register_kernel('row_conv')
def _row_conv(ctx):
    """Lookahead convolution: out[b, t] = sum_j x[b, t + j] * W[j],
    per channel. Parity: operators/row_conv_op.*"""
    st = ctx.input('X')
    x = unwrap(st)
    w = unwrap(ctx.input('Filter'))                           # [k + 1, D]
    B, T = x.shape[0], x.shape[1]
    L = st.lengths[:, None] if isinstance(st, SequenceTensor) else \
        torch.full((B, 1), T, device=x.device)
    src = torch.arange(T, device=x.device)[None, :]
    out = torch.zeros_like(x)
    for j in range(w.shape[0]):
        ok = (src + j < L)[..., None].to(x.dtype)
        out = out + torch.roll(x, -j, 1) * ok * w[j]
    ctx.set_output('Out', SequenceTensor(out, st.lengths)
                   if isinstance(st, SequenceTensor) else out)


@register_kernel('im2sequence')
def _im2sequence(ctx):
    """[B, C, H, W] -> a sequence of flattened patches (c, kh, kw
    order), oh * ow steps each. Parity: operators/im2sequence_op.*"""
    x = unwrap(ctx.input('X'))
    kh, kw = ctx.attr('kernels', [1, 1])
    strides = ctx.attr('strides', [1, 1])
    pads = ctx.attr('paddings', [0, 0, 0, 0])
    B = x.shape[0]
    x = F.pad(x, (pads[1], pads[3], pads[0], pads[2]))
    oh = (x.shape[2] - kh) // strides[0] + 1
    ow = (x.shape[3] - kw) // strides[1] + 1
    seq = F.unfold(x, (kh, kw), stride=tuple(strides)).transpose(1, 2)
    ctx.set_output('Out', SequenceTensor(seq, torch.full(
        (B,), oh * ow, dtype=torch.int64, device=x.device)))
