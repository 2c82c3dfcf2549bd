"""Tensor creation / manipulation kernels.

Counterpart of paddle_tpu/ops/tensor_ops.py, trimmed to the ops of the
serving slice and its startup program: fill_constant, assign,
assign_value (the constants the compiler's constant_fold bakes),
uniform_random, gaussian_random, lookup_table, concat, split, reshape;
and the tensor ops of the books and the decode path: cast, squeeze,
unsqueeze, transpose, one_hot, gather, top_k, increment, expand,
fill_constant_batch_size_like.

Integer widths: the JAX package runs without x64, so its int64 values
are int32 and its ``top_k`` writes int32 indices. torch indexes with
int64, so the port keeps int64 where the IR says int64; the two agree
in value, and the static analysis compares dtypes under the JAX
package's names (``analysis.infer._canon``).
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


@register_kernel('fill_constant_batch_size_like')
def _fill_constant_bsl(ctx):
    """The batch dim comes from the runtime tensor, as in the JAX
    kernel: a SequenceTensor's padded data [B, T_pad, ...] gives its
    number of sequences at index 0."""
    ref = unwrap(ctx.input('Input'))
    shape = [int(s) for s in ctx.attr('shape')]
    shape[ctx.attr('output_dim_idx', 0)] = \
        ref.shape[ctx.attr('input_dim_idx', 0)]
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


@register_kernel('cast')
def _cast(ctx):
    x = ctx.input('X')
    ctx.set_output('Out', rewrap(x, unwrap(x).to(
        torch_dtype(ctx.attr('out_dtype')))))


@register_kernel('squeeze')
def _squeeze(ctx):
    """``axes`` empty squeezes every unit dim; a named axis that is not
    of size 1 raises, as ``jnp.squeeze`` does (``torch.squeeze`` would
    keep it silently)."""
    x = unwrap(ctx.input('X'))
    axes = ctx.attr('axes', None)
    if not axes:
        ctx.set_output('Out', x.reshape([d for d in x.shape if d != 1]))
        return
    dims = sorted({a % x.dim() for a in axes})
    for a in dims:
        if x.shape[a] != 1:
            raise ValueError("squeeze: axis %d of shape %s is not 1"
                             % (a, tuple(x.shape)))
    ctx.set_output('Out', x.reshape([d for i, d in enumerate(x.shape)
                                     if i not in dims]))


@register_kernel('unsqueeze')
def _unsqueeze(ctx):
    out = unwrap(ctx.input('X'))
    for a in sorted(ctx.attr('axes')):
        out = out.unsqueeze(a)
    ctx.set_output('Out', out)


@register_kernel('transpose')
def _transpose(ctx):
    # a dense result, as the JAX op's, so no kernel downstream sees a
    # strided view
    ctx.set_output('Out', unwrap(ctx.input('X')).permute(
        *ctx.attr('axis')).contiguous())


@register_kernel('one_hot')
def _one_hot(ctx):
    """From a comparison with ``arange``, as ``jax.nn.one_hot`` builds
    it: a label outside [0, depth) gives a row of zeros, where
    ``F.one_hot`` would raise (on the card, a device-side assert)."""
    x = unwrap(ctx.input('X'))
    depth = int(ctx.attr('depth'))
    idx = x.reshape(x.shape[:-1]) if x.dim() and x.shape[-1] == 1 else x
    ctx.set_output('Out', (idx.unsqueeze(-1) == torch.arange(
        depth, device=idx.device, dtype=idx.dtype)).to(torch.float32))


@register_kernel('gather')
def _gather(ctx):
    """Rows of X at the flattened Index, as ``jnp.take(x, idx, 0)``: a
    negative index counts from the end, and an index out of range gives
    a filled row (NaN for floats, the dtype's least value for integers)
    where ``index_select`` would raise. Its backward adds rows with
    ``index_add_``, which on the card uses atomics: not bit-reproducible
    where an index repeats."""
    x = unwrap(ctx.input('X'))
    idx = unwrap(ctx.input('Index')).reshape(-1).long()
    n = x.shape[0]
    idx = torch.where(idx < 0, idx + n, idx)
    valid = (idx >= 0) & (idx < n)
    out = torch.index_select(x, 0, idx.clamp(0, max(n - 1, 0)))
    # masked on the device, whatever the indices: no host sync
    fill = float('nan') if x.is_floating_point() else \
        torch.iinfo(x.dtype).min
    ctx.set_output('Out', out.masked_fill(
        ~valid.reshape((-1,) + (1,) * (x.dim() - 1)), fill))


@register_kernel('top_k')
def _top_k(ctx):
    """The k largest along the last axis, largest first. Among equal
    values the lower index comes first, as in ``jax.lax.top_k``: a
    stable descending sort keeps that order, where ``torch.topk``
    promises none on the card. Indices are int64 (the IR's dtype)."""
    x = unwrap(ctx.input('X'))
    k = int(ctx.attr('k', 1))
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    ctx.set_output('Out', vals[..., :k])
    ctx.set_output('Indices', idx[..., :k])


@register_kernel('increment')
def _increment(ctx):
    x = unwrap(ctx.input('X'))
    ctx.set_output('Out', x + torch.as_tensor(
        ctx.attr('step', 1.0)).to(device=x.device, dtype=x.dtype))


@register_kernel('expand')
def _expand(ctx):
    """Tile per dim, as ``jnp.tile``: fewer times than dims repeat the
    trailing dims. Parity: paddle/fluid/operators/expand_op.h."""
    x = ctx.input('X')
    xd = unwrap(x)
    times = [int(t) for t in ctx.attr('expand_times')]
    times = [1] * (xd.dim() - len(times)) + times
    ctx.set_output('Out', rewrap(x, xd.repeat(times)))
