"""Math kernels.

Counterpart of paddle_tpu/ops/math_ops.py, trimmed to the serving and
training slices: elementwise add/sub/mul/div/max with fluid's ``axis``
broadcast, ``mul`` (the fc matmul) with ``x_num_col_dims``, ``mean``,
``scale``, ``relu``, and the ops that regularizers and gradient clips
append: ``sum``, ``sign``, ``clip``, ``clip_by_norm``, ``reduce_sum``,
``pow``, ``sqrt``.
"""
import torch

from ..core.registry import register_kernel
from ..core.amp import matmul_compute
from .common import bcast_y, f32, prod


def _elementwise(name, fn):
    @register_kernel(name)
    def _k(ctx, fn=fn):
        x, y = ctx.input('X'), ctx.input('Y')
        out = fn(x, bcast_y(x, y, ctx.attr('axis', -1)))
        if ctx.attr('scale', None) not in (None, 1.0):
            out = out * ctx.attr('scale')
        ctx.set_output('Out', out)


_elementwise('elementwise_add', torch.add)
_elementwise('elementwise_sub', torch.sub)
_elementwise('elementwise_mul', torch.mul)
_elementwise('elementwise_div', torch.div)
_elementwise('elementwise_max', torch.maximum)


@register_kernel('relu')
def _relu(ctx):
    ctx.set_output('Out', torch.relu(ctx.input('X')))


@register_kernel('mul')
def _mul(ctx):
    """fc matmul. X flattened by x_num_col_dims, Y by y_num_col_dims.
    Parity: operators/mul_op.cc. A plain matrix product: under AMP its
    operands go to the tensor cores in bf16."""
    x, y = ctx.input('X'), ctx.input('Y')
    xd = ctx.attr('x_num_col_dims', 1)
    yd = ctx.attr('y_num_col_dims', 1)
    xs, ys = x.shape, y.shape
    x2 = x.reshape(prod(xs[:xd]), prod(xs[xd:]))
    y2 = y.reshape(prod(ys[:yd]), prod(ys[yd:]))
    out = matmul_compute(torch.matmul, x2, y2)
    ctx.set_output('Out', out.reshape(tuple(xs[:xd]) + tuple(ys[yd:])))


@register_kernel('mean')
def _mean(ctx):
    ctx.set_output('Out', f32(ctx.input('X')).mean().reshape(1))


@register_kernel('scale')
def _scale(ctx):
    x = ctx.input('X')
    s = ctx.attr('scale', 1.0)
    bias = ctx.attr('bias', 0.0)
    if ctx.attr('bias_after_scale', True):
        out = x * s + bias
    else:
        out = (x + bias) * s
    ctx.set_output('Out', out)


@register_kernel('sum')
def _sum(ctx):
    xs = ctx.inputs('X')
    out = xs[0]
    for v in xs[1:]:
        out = out + v
    ctx.set_output('Out', out)


@register_kernel('sign')
def _sign(ctx):
    ctx.set_output('Out', torch.sign(ctx.input('X')))


@register_kernel('sqrt')
def _sqrt(ctx):
    ctx.set_output('Out', torch.sqrt(ctx.input('X')))


@register_kernel('pow')
def _pow(ctx):
    ctx.set_output('Out', torch.pow(ctx.input('X'), ctx.attr('factor', 1.0)))


@register_kernel('clip')
def _clip(ctx):
    ctx.set_output('Out', torch.clamp(ctx.input('X'), ctx.attr('min'),
                                      ctx.attr('max')))


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
