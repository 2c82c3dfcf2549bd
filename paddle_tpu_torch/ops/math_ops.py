"""Math kernels.

Counterpart of paddle_tpu/ops/math_ops.py, trimmed to the serving and
training slices and the fused conv's epilogue vocabulary: the binary
elementwise ops with fluid's ``axis`` broadcast and every activation of
``activations.py`` (whose functions the plain fused conv applies too),
``mul`` (the fc matmul) with ``x_num_col_dims``, ``mean``, ``scale``, and
the ops that regularizers and gradient clips append: ``sum``, ``sign``,
``clip_by_norm``, ``reduce_sum``. The elementwise ops, activations,
``mul``, ``sum``, ``scale`` and ``mean`` take SequenceTensors as the JAX
kernels do.
"""
import torch

from ..core.registry import register_kernel
from ..core.amp import matmul_compute
from ..lod import SequenceTensor
from .common import (bcast_y, f32, prod, rewrap, seq_of, step_mask,
                     unwrap)
from .activations import ACTS, ACTS_P, BINS, PARAM_ATTRS


def _elementwise(name, fn):
    @register_kernel(name)
    def _k(ctx, fn=fn):
        x, y = ctx.input('X'), ctx.input('Y')
        tmpl = seq_of(x, y)
        xd, yd = unwrap(x), unwrap(y)
        axis = ctx.attr('axis', -1)
        if isinstance(x, SequenceTensor) and \
                not isinstance(y, SequenceTensor):
            if axis not in (None, -1) and axis >= 1:
                # the IR's shapes follow the reference's packed [total,
                # ...] layout; the data is padded [B, T, ...], so dims
                # >= 1 shift by one
                axis += 1
            elif axis == 0 and yd.dim() >= 1 and xd.dim() >= 2 and \
                    prod(yd.shape) == xd.shape[0] * xd.shape[1]:
                # one value per packed row ([total]): the padded rows
                # [B, T] are row-major in the same order
                yd = yd.reshape(tuple(xd.shape[:2]) +
                                (1,) * (xd.dim() - 2))
                axis = -1
        out = fn(xd, bcast_y(xd, yd, axis))
        if ctx.attr('scale', None) not in (None, 1.0):
            out = out * ctx.attr('scale')
        ctx.set_output('Out', rewrap(tmpl, out))


def _activation(name, fn):
    @register_kernel(name)
    def _k(ctx, fn=fn):
        x = ctx.input('X')
        ctx.set_output('Out', rewrap(x, fn(unwrap(x))))


def _param_activation(name, fn):
    @register_kernel(name)
    def _k(ctx, fn=fn, attrs=PARAM_ATTRS[name]):
        x = ctx.input('X')
        ctx.set_output('Out', rewrap(x, fn(
            unwrap(x), *[ctx.attr(a, d) for a, d in attrs])))


for _name, _fn in BINS.items():
    _elementwise(_name, _fn)
for _name, _fn in ACTS.items():
    _activation(_name, _fn)
for _name, _fn in ACTS_P.items():
    _param_activation(_name, _fn)


@register_kernel('mul')
def _mul(ctx):
    """fc matmul. X flattened by x_num_col_dims, Y by y_num_col_dims.
    Parity: operators/mul_op.cc. A plain matrix product: under AMP its
    operands go to the tensor cores in bf16.

    Sequence inputs: the reference packs time into dim 0 ([total, D]);
    the data here is padded [B, T, D], so the time dim joins the row
    dims and the result stays a SequenceTensor."""
    x_in, y = ctx.input('X'), unwrap(ctx.input('Y'))
    x = unwrap(x_in)
    xd = ctx.attr('x_num_col_dims', 1)
    yd = ctx.attr('y_num_col_dims', 1)
    if isinstance(x_in, SequenceTensor):
        xd += 1
    xs, ys = x.shape, y.shape
    x2 = x.reshape(prod(xs[:xd]), prod(xs[xd:]))
    y2 = y.reshape(prod(ys[:yd]), prod(ys[yd:]))
    out = matmul_compute(torch.matmul, x2, y2)
    ctx.set_output('Out', rewrap(x_in, out.reshape(tuple(xs[:xd]) +
                                                   tuple(ys[yd:]))))


@register_kernel('mean')
def _mean(ctx):
    x_in = ctx.input('X')
    x = f32(unwrap(x_in))
    if isinstance(x_in, SequenceTensor):
        # the average over real tokens only: the reference means over
        # its packed [total, ...] rows, which hold no padding
        m = step_mask(x_in.lengths, x.shape[1], x.dtype, x.dim() - 2)
        denom = torch.clamp(m.sum(), min=1.0) * prod(x.shape[2:])
        ctx.set_output('Out', ((x * m).sum() / denom).reshape(1))
        return
    ctx.set_output('Out', x.mean().reshape(1))


@register_kernel('scale')
def _scale(ctx):
    x_in = ctx.input('X')
    x = unwrap(x_in)
    s = ctx.attr('scale', 1.0)
    bias = ctx.attr('bias', 0.0)
    if ctx.attr('bias_after_scale', True):
        out = x * s + bias
    else:
        out = (x + bias) * s
    ctx.set_output('Out', rewrap(x_in, out))


@register_kernel('sum')
def _sum(ctx):
    xs = ctx.inputs('X')
    out = unwrap(xs[0])
    for v in xs[1:]:
        out = out + unwrap(v)
    ctx.set_output('Out', rewrap(seq_of(*xs), out))


@register_kernel('sign')
def _sign(ctx):
    ctx.set_output('Out', torch.sign(ctx.input('X')))


@register_kernel('clip_by_norm')
def _clip_by_norm(ctx):
    x = ctx.input('X')
    norm = torch.sqrt(torch.sum(torch.square(x)))
    scale = torch.clamp(ctx.attr('max_norm') / torch.clamp(norm, min=1e-12),
                        max=1.0)
    ctx.set_output('Out', x * scale)


@register_kernel('reduce_sum')
def _reduce_sum(ctx):
    x = ctx.input('X')
    dim = ctx.attr('dim', None)
    if ctx.attr('reduce_all', False) or dim is None:
        # the JAX kernel's jnp.sum(axis=None): a 0-d result, or all axes
        # kept as 1 under keep_dim
        out = x.sum()
        if ctx.attr('keep_dim', False):
            out = out.reshape([1] * x.dim())
    else:
        dims = tuple(dim) if isinstance(dim, (list, tuple)) else (dim,)
        out = x.sum(dim=dims, keepdim=ctx.attr('keep_dim', False))
    ctx.set_output('Out', out)
