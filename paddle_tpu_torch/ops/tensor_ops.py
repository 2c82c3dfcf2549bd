"""Tensor creation / manipulation kernels.

Counterpart of paddle_tpu/ops/tensor_ops.py, trimmed to the ops of the
serving slice and its startup program: fill_constant, assign,
assign_value (the constants the compiler's constant_fold bakes),
uniform_random, gaussian_random, lookup_table, concat, split, reshape.
"""
import numpy as np
import torch

from ..core.registry import register_kernel
from ..core.lowering import torch_dtype
from .common import rewrap, unwrap


@register_kernel('fill_constant')
def _fill_constant(ctx):
    shape = [int(s) for s in ctx.attr('shape', [1])]
    ctx.set_output('Out', torch.full(
        shape, ctx.attr('value', 0.0),
        dtype=torch_dtype(ctx.attr('dtype', 'float32')), device=ctx.device))


@register_kernel('assign')
def _assign(ctx):
    ctx.set_output('Out', ctx.input('X'))


@register_kernel('assign_value')
def _assign_value(ctx):
    """The payload rides in the ``values`` attr (a numpy array, as
    constant_fold bakes it), or, as the reference's assign_value_op
    carries it, in ``fp32_values`` / ``int32_values`` by dtype. The
    device tensor is made once per op and device and kept on the op, as
    JAX bakes the constant into the compiled program once: a request
    reuses it (no kernel writes its inputs in place)."""
    dtype = torch_dtype(ctx.attr('dtype', 'float32'))
    consts = ctx.op.__dict__.setdefault('_const', {})
    out = consts.get(ctx.device)
    if out is None:
        values = ctx.attr('values')
        if values is None:
            key = ('fp32_values' if dtype.is_floating_point
                   else 'int32_values')
            values = ctx.attr(key)
        out = consts[ctx.device] = torch.as_tensor(np.array(values)).to(
            device=ctx.device, dtype=dtype).reshape(
                list(ctx.attr('shape')))
    ctx.set_output('Out', out)


def _op_generator(ctx):
    """The op's own generator when it carries a non-zero seed, else the
    scope's generator (program.random_seed)."""
    seed = ctx.attr('seed', 0)
    if not seed:
        return ctx.generator()
    gen = torch.Generator(device=ctx.device)
    gen.manual_seed(int(seed))
    return gen


@register_kernel('uniform_random')
def _uniform_random(ctx):
    shape = [int(s) for s in ctx.attr('shape')]
    lo, hi = ctx.attr('min', -1.0), ctx.attr('max', 1.0)
    out = torch.rand(shape, generator=_op_generator(ctx),
                     dtype=torch_dtype(ctx.attr('dtype', 'float32')),
                     device=ctx.device)
    ctx.set_output('Out', out * (hi - lo) + lo)


@register_kernel('gaussian_random')
def _gaussian_random(ctx):
    shape = [int(s) for s in ctx.attr('shape')]
    mean, std = ctx.attr('mean', 0.0), ctx.attr('std', 1.0)
    out = torch.randn(shape, generator=_op_generator(ctx),
                      dtype=torch_dtype(ctx.attr('dtype', 'float32')),
                      device=ctx.device)
    ctx.set_output('Out', out * std + mean)


@register_kernel('lookup_table')
def _lookup_table(ctx):
    """Embedding. Parity: operators/lookup_table_op.* and the JAX
    kernel: ids are clipped into [0, vocab) (``F.embedding`` would raise
    on an out-of-range id) and rows whose id equals ``padding_idx``
    return zeros. A trailing id axis of 1 is squeezed. Sequence ids
    ([B, T_pad, 1]) give a sequence of rows with their lengths."""
    w = ctx.input('W')
    ids_in = ctx.input('Ids')
    ids = unwrap(ids_in).long()
    if ids.dim() and ids.shape[-1] == 1:
        ids = ids.reshape(ids.shape[:-1])
    out = torch.nn.functional.embedding(ids.clamp(0, w.shape[0] - 1), w)
    padding_idx = ctx.attr('padding_idx', None)
    if padding_idx is not None and padding_idx >= 0:
        out = out.masked_fill((ids == padding_idx).unsqueeze(-1), 0)
    ctx.set_output('Out', rewrap(ids_in, out))


@register_kernel('concat')
def _concat(ctx):
    ctx.set_output('Out', torch.cat(ctx.inputs('X'),
                                    dim=ctx.attr('axis', 0)))


@register_kernel('split')
def _split(ctx):
    x = ctx.input('X')
    axis = ctx.attr('axis', 0)
    sections = ctx.attr('sections', None)
    if sections:
        parts = torch.split(x, list(sections), dim=axis)
    else:
        num = ctx.attr('num', 0) or len(ctx.output_names('Out'))
        if x.shape[axis] % num:
            raise ValueError("split: dim %d of size %d is not divisible "
                             "into %d parts" % (axis, x.shape[axis], num))
        parts = torch.split(x, x.shape[axis] // num, dim=axis)
    # each part is a dense tensor of its own, as in the JAX op, so the
    # kernels downstream (flash attention after the fused q/k/v) never
    # see a strided view
    for i, p in enumerate(parts):
        ctx.set_output('Out', p.contiguous(), idx=i)


@register_kernel('reshape')
def _reshape(ctx):
    x = ctx.input('X')
    if ctx.has_input('Shape'):
        raise NotImplementedError(
            "reshape with a runtime Shape input is not ported yet")
    # fluid semantics: 0 copies the input dim; -1 is inferred
    shape = [x.shape[i] if s == 0 else int(s)
             for i, s in enumerate(ctx.attr('shape'))]
    ctx.set_output('Out', x.reshape(shape))
