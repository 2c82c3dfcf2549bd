"""Math kernels.

Counterpart of paddle_tpu/ops/math_ops.py, trimmed to the serving and
training slices and the fused conv's epilogue vocabulary: the binary
elementwise ops with fluid's ``axis`` broadcast and every activation of
``activations.py`` (whose functions the plain fused conv applies too),
``mul`` (the fc matmul) with ``x_num_col_dims``, ``mean``, ``scale``, and
the ops that regularizers and gradient clips append: ``sum``, ``sign``,
``clip_by_norm``, ``reduce_sum``; and the math of the books and the
decode path: ``matmul``, the compare and logical ops, ``reduce_mean`` /
``max`` / ``min`` / ``prod``, ``square_error_cost``, ``smooth_l1``,
``cos``, ``sin`` and ``cos_sim``. The elementwise ops, activations, ``mul``, ``sum``,
``scale`` and ``mean`` take SequenceTensors as the JAX kernels do.
And the rest of the JAX module's math: ``compare``, ``cumsum``
(``exclusive``, ``reverse``), ``l2_normalize`` / ``norm``,
``bilinear_tensor_product``, ``conv_shift`` and the reference's
``smooth_l1_loss`` name for ``smooth_l1``.
"""
import torch

from ..core.registry import register_kernel
from ..core.amp import matmul_compute
from ..lod import SequenceTensor
from .common import (bcast_y, f32, padded, prod, rewrap, seq_of,
                     step_mask, unwrap)
from .collective_ops import batch_group, global_sums
from .activations import ACTS, ACTS_P, BINS, PARAM_ATTRS


def _elementwise(name, fn):
    @register_kernel(name)
    def _k(ctx, fn=fn):
        x, y = ctx.input('X'), ctx.input('Y')
        tmpl = seq_of(x, y)
        xd, yd = unwrap(x), unwrap(y)
        axis = ctx.attr('axis', -1)
        # packed rows are the reference's own layout: no shift
        if padded(x) and not isinstance(y, SequenceTensor):
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
    dims and the result stays a SequenceTensor. Packed rows are the
    reference's [total, D] as they are."""
    x_in, y = ctx.input('X'), unwrap(ctx.input('Y'))
    x = unwrap(x_in)
    xd = ctx.attr('x_num_col_dims', 1)
    yd = ctx.attr('y_num_col_dims', 1)
    if padded(x_in):
        xd += 1
    xs, ys = x.shape, y.shape
    x2 = x.reshape(prod(xs[:xd]), prod(xs[xd:]))
    y2 = y.reshape(prod(ys[:yd]), prod(ys[yd:]))
    out = matmul_compute(torch.matmul, x2, y2)
    ctx.set_output('Out', rewrap(x_in, out.reshape(tuple(xs[:xd]) +
                                                   tuple(ys[yd:]))))


@register_kernel('mean')
def _mean(ctx):
    """Under data parallelism over rows cut across ranks
    (``collective_ops.batch_group``) the mean is the global one: the
    ranks' sums and counts summed in one collective."""
    x_in = ctx.input('X')
    x = f32(unwrap(x_in))
    group = batch_group(ctx)
    if padded(x_in):
        # the average over real tokens only: the reference means over
        # its packed [total, ...] rows, which hold no padding
        m = step_mask(x_in.lengths, x.shape[1], x.dtype, x.dim() - 2)
        denom = torch.clamp(m.sum(), min=1.0) * prod(x.shape[2:])
        if group is not None:
            total, denom = global_sums(group, (x * m).sum(),
                                       m.sum() * prod(x.shape[2:]))
            denom = torch.clamp(denom, min=1.0)
            ctx.set_output('Out', (total / denom).reshape(1))
            return
        ctx.set_output('Out', ((x * m).sum() / denom).reshape(1))
        return
    if group is not None:
        total, = global_sums(group, x.sum())
        ctx.set_output('Out', (total / (x.numel() * group.size)).reshape(1))
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


def _reduce(name, fn):
    """reduce_* over ``dim`` (an int or a list), or over every axis with
    ``reduce_all`` or no ``dim`` (a 0-d result, or all axes kept as 1
    under ``keep_dim``), as the JAX kernels' ``fn(x, axis, keepdims)``."""
    @register_kernel(name)
    def _k(ctx, fn=fn):
        x = unwrap(ctx.input('X'))
        dim = ctx.attr('dim', None)
        if ctx.attr('reduce_all', False) or dim is None:
            dims = tuple(range(x.dim()))
        else:
            dims = tuple(sorted({d % x.dim() for d in (
                dim if isinstance(dim, (list, tuple)) else (dim,))}))
        out = fn(x, dims, ctx.attr('keep_dim', False))
        group = batch_group(ctx)
        if group is not None:
            # reduce_sum / reduce_mean over the rows cut across the ranks
            # (equal on every rank): the sum over ranks, / size for mean
            out, = global_sums(group, out)
            if name == 'reduce_mean':
                out = out / group.size
        ctx.set_output('Out', out)


def _reduce_prod(x, dims, keep):
    # torch.prod reduces one dim at a time; its backward is exact with
    # zeros in the row, as jnp.prod's
    for d in reversed(dims):
        x = torch.prod(x, d, keepdim=keep)
    return x


_reduce('reduce_sum', lambda x, dims, keep: torch.sum(x, dims, keep)
        if dims else x)
# jnp.mean of integers is a float32 mean
_reduce('reduce_mean', lambda x, dims, keep: torch.mean(
    x if x.is_floating_point() else x.float(), dims, keep) if dims else x)
# amax / amin split a tie's cotangent equally among the tied elements,
# as JAX's max and min do (torch.max(dim) gives it to one)
_reduce('reduce_max', lambda x, dims, keep: torch.amax(x, dims, keep)
        if dims else x)
_reduce('reduce_min', lambda x, dims, keep: torch.amin(x, dims, keep)
        if dims else x)
_reduce('reduce_prod', _reduce_prod)


@register_kernel('matmul')
def _matmul(ctx):
    """Parity: paddle_tpu/ops/math_ops.py::_matmul. A 1-D X is a row
    [1, K] and a 1-D Y a column [K, 1] (kept 2-D in the result, as
    there); ``transpose_X`` / ``transpose_Y`` swap the last two dims,
    batch dims broadcast, ``alpha`` scales the product. Under AMP its
    operands go to the tensor cores in bf16, as ``mul``'s."""
    x, y = unwrap(ctx.input('X')), unwrap(ctx.input('Y'))
    if x.dim() == 1:
        x = x.unsqueeze(0)
    if y.dim() == 1:
        y = y.unsqueeze(1)
    if ctx.attr('transpose_X', False):
        x = x.transpose(-1, -2)
    if ctx.attr('transpose_Y', False):
        y = y.transpose(-1, -2)
    out = matmul_compute(torch.matmul, x, y)
    alpha = ctx.attr('alpha', 1.0)
    if alpha != 1.0:
        out = out * alpha
    ctx.set_output('Out', out)


def _logical(name, fn, unary=False):
    """A logical or compare op: Out = fn(X) or fn(X, Y)."""
    @register_kernel(name)
    def _k(ctx, fn=fn, unary=unary):
        x = unwrap(ctx.input('X'))
        ctx.set_output('Out', fn(x) if unary else
                       fn(x, unwrap(ctx.input('Y'))))


_logical('logical_and', torch.logical_and)
_logical('logical_or', torch.logical_or)
_logical('logical_xor', torch.logical_xor)
_logical('logical_not', torch.logical_not, unary=True)
_COMPARE = {'less_than': torch.lt, 'less_equal': torch.le,
            'greater_than': torch.gt, 'greater_equal': torch.ge,
            'equal': torch.eq, 'not_equal': torch.ne}
for _name, _fn in _COMPARE.items():
    _logical(_name, _fn)


@register_kernel('compare')
def _compare(ctx):
    """The six comparisons under one op type, the comparison named by
    the attr ``type`` (``less_than`` ... ``not_equal``). paddle_tpu
    registers this type on its comparison kernel, which looks the
    comparison up by the op's own type and so raises for it; no layer
    of either package appends it."""
    kind = ctx.attr('type')
    if kind not in _COMPARE:
        raise ValueError("compare: attr 'type' must be one of %s, got %r"
                         % (sorted(_COMPARE), kind))
    ctx.set_output('Out', _COMPARE[kind](unwrap(ctx.input('X')),
                                         unwrap(ctx.input('Y'))))

# not in ACTS: the fused conv's epilogue does not take them
_activation('cos', torch.cos)
_activation('sin', torch.sin)


@register_kernel('cos_sim')
def _cos_sim(ctx):
    """Row-wise cosine similarity over the last axis, the product of
    the norms floored at 1e-12, with the norms as XNorm and YNorm."""
    x, y = unwrap(ctx.input('X')), unwrap(ctx.input('Y'))
    xn = torch.sqrt(torch.sum(torch.square(x), -1, keepdim=True))
    yn = torch.sqrt(torch.sum(torch.square(y), -1, keepdim=True))
    xy = torch.sum(x * y, -1, keepdim=True)
    ctx.set_output('Out', xy / torch.clamp(xn * yn, min=1e-12))
    ctx.set_output('XNorm', xn)
    ctx.set_output('YNorm', yn)


@register_kernel('square_error_cost')
def _square_error_cost(ctx):
    x, y = unwrap(ctx.input('X')), unwrap(ctx.input('Label'))
    ctx.set_output('Out', torch.square(x - y))


@register_kernel('smooth_l1')
def _smooth_l1(ctx):
    """Per row, the sum of 0.5 (sigma d)^2 where |d| < 1 / sigma^2, else
    |d| - 0.5 / sigma^2, d = (X - Y) * InsideWeight, each term times
    OutsideWeight. Parity: operators/smooth_l1_loss_op.h."""
    x, y = unwrap(ctx.input('X')), unwrap(ctx.input('Y'))
    s2 = ctx.attr('sigma', 1.0) ** 2
    diff = x - y
    if ctx.has_input('InsideWeight'):
        diff = diff * unwrap(ctx.input('InsideWeight'))
    ad = torch.abs(diff)
    loss = torch.where(ad < 1.0 / s2, 0.5 * s2 * diff * diff,
                       ad - 0.5 / s2)
    if ctx.has_input('OutsideWeight'):
        loss = loss * unwrap(ctx.input('OutsideWeight'))
    ctx.set_output('Out', loss.reshape(loss.shape[0], -1).sum(
        -1, keepdim=True))
    if ctx.output_names('Diff'):
        ctx.set_output('Diff', diff)


register_kernel('smooth_l1_loss')(_smooth_l1)


@register_kernel('cumsum')
def _cumsum(ctx):
    """Running sum along ``axis`` (default -1); ``reverse`` sums from
    the end, ``exclusive`` leaves out each element's own value, as the
    JAX kernel: the inclusive sum minus the element."""
    x = unwrap(ctx.input('X'))
    axis = ctx.attr('axis', -1)
    if ctx.attr('reverse', False):
        out = torch.flip(torch.cumsum(torch.flip(x, [axis]), axis), [axis])
    else:
        out = torch.cumsum(x, axis)
    if ctx.attr('exclusive', False):
        out = out - x
    ctx.set_output('Out', out)


@register_kernel('l2_normalize')
@register_kernel('norm')
def _l2_normalize(ctx):
    """X over its L2 norm along ``axis``, the norm floored at
    ``epsilon``; ``Norm`` is the unfloored norm. With a ``Scale`` input
    (norm_op.cc, SSD's cross-channel norm) Out = Scale[c] * X /
    sqrt(sum_c X^2 + epsilon) at each position of an NCHW X."""
    x = unwrap(ctx.input('X'))
    eps = ctx.attr('epsilon', 1e-10)
    if ctx.has_input('Scale'):
        scale = unwrap(ctx.input('Scale')).reshape(1, -1, 1, 1)
        denom = torch.sqrt(torch.sum(x * x, 1, keepdim=True) + eps)
        ctx.set_output('Out', scale * x / denom)
        return
    norm = torch.sqrt(torch.sum(x * x, ctx.attr('axis', -1), keepdim=True))
    ctx.set_output('Out', x / torch.clamp(norm, min=eps))
    if ctx.output_names('Norm'):
        ctx.set_output('Norm', norm)


@register_kernel('bilinear_tensor_product')
def _bilinear_tensor_product(ctx):
    """Out[b, o] = X[b] . Weight[o] . Y[b] (+ Bias[o])."""
    x, y, w = (unwrap(ctx.input('X')), unwrap(ctx.input('Y')),
               unwrap(ctx.input('Weight')))
    out = torch.einsum('bi,oij,bj->bo', x, w, y)
    if ctx.has_input('Bias'):
        out = out + unwrap(ctx.input('Bias'))
    ctx.set_output('Out', out)


@register_kernel('conv_shift')
def _conv_shift(ctx):
    """Circular convolution of each row of X [B, M] with the row of Y
    [B, N] (N odd, centred): Out[b, m] = sum_n X[b, (m + n - N//2) % M]
    * Y[b, n]."""
    x, y = unwrap(ctx.input('X')), unwrap(ctx.input('Y'))
    m, n = x.shape[1], y.shape[1]
    half = (n - 1) // 2
    idx = (torch.arange(m, device=x.device)[:, None] +
           torch.arange(-half, n - half, device=x.device)[None, :]) % m
    ctx.set_output('Out', torch.einsum('bmn,bn->bm', x[:, idx], y))
