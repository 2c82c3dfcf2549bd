"""Tensor creation / manipulation kernels.

Counterpart of paddle_tpu/ops/tensor_ops.py, trimmed to the ops of the
serving slice and its startup program: fill_constant, assign,
assign_value (the constants the compiler's constant_fold bakes),
uniform_random, gaussian_random, lookup_table, concat, split, reshape;
the random ops of the initializers and layers (truncated_gaussian_random
and the two ``*_batch_size_like`` draws);
and the tensor ops of the books and the decode path: cast, squeeze,
unsqueeze, transpose, one_hot, gather, top_k, increment, expand,
fill_constant_batch_size_like; and of control flow: is_empty and print.
And the rest of the JAX module: fill_zeros_like, pad, crop, scatter,
multiplex, reverse, shape, arg_max, arg_min and the reference's feed and
fetch op types.

Integer widths: the JAX package runs without x64, so its int64 values
are int32 and its ``top_k`` writes int32 indices. torch indexes with
int64, so the port keeps int64 where the IR says int64; the two agree
in value, and the static analysis compares dtypes under the JAX
package's names (``analysis.infer._canon``).
"""
import numpy as np
import torch

from ..core.registry import register_kernel
from ..core.lowering import torch_dtype, RNG_CPU_KEY
from ..lod import SequenceTensor
from .common import host_read, rewrap, unwrap


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


def _op_generator(ctx, host):
    """The op's own generator when it carries a non-zero seed (on the
    host for a ``host`` draw, else on the op's device), else the
    scope's: its host generator for a host draw, on every device, and
    its device generator otherwise (both seeded from
    program.random_seed)."""
    seed = ctx.attr('seed', 0)
    if not seed:
        return ctx.env[RNG_CPU_KEY] if host else ctx.generator()
    gen = torch.Generator(device='cpu' if host else ctx.device)
    gen.manual_seed(int(seed))
    return gen


def _draw(ctx, draw):
    """``draw(shape, dtype, device, generator)``, at the op's shape (a
    ``*_batch_size_like`` op takes its batch from its Input). With
    ``force_cpu`` (``initializer.init_on_cpu``) the draw and its
    arithmetic run on the host, from a host generator, and the values
    are copied to the device: the same bits on the CPU and on the card."""
    shape = [int(s) for s in ctx.attr('shape')]
    if ctx.op.type.endswith('batch_size_like'):
        ref = unwrap(ctx.input('Input'))
        shape[ctx.attr('output_dim_idx', 0)] = \
            ref.shape[ctx.attr('input_dim_idx', 0)]
    host = bool(ctx.attr('force_cpu', False))
    out = draw(shape, torch_dtype(ctx.attr('dtype', 'float32')),
               torch.device('cpu') if host else ctx.device,
               _op_generator(ctx, host))
    ctx.set_output('Out', out.to(ctx.device))


@register_kernel('uniform_random')
@register_kernel('uniform_random_batch_size_like')
def _uniform_random(ctx):
    lo, hi = ctx.attr('min', -1.0), ctx.attr('max', 1.0)
    _draw(ctx, lambda shape, dtype, device, gen: torch.rand(
        shape, generator=gen, dtype=dtype, device=device) * (hi - lo) + lo)


@register_kernel('gaussian_random')
@register_kernel('gaussian_random_batch_size_like')
def _gaussian_random(ctx):
    mean, std = ctx.attr('mean', 0.0), ctx.attr('std', 1.0)
    _draw(ctx, lambda shape, dtype, device, gen: torch.randn(
        shape, generator=gen, dtype=dtype, device=device) * std + mean)


# the standard normal's CDF at -2 and 2: a truncated draw maps a uniform
# draw on [PHI_LO, PHI_HI] through the inverse CDF
_PHI_LO, _PHI_HI = 0.022750131948179195, 0.9772498680518208


@register_kernel('truncated_gaussian_random')
def _truncated_gaussian_random(ctx):
    """A normal draw truncated to two standard deviations about the
    mean (the JAX kernel's ``truncated_normal(-2, 2)``), by the inverse
    CDF of a uniform draw, clamped so that rounding never leaves the
    interval."""
    mean, std = ctx.attr('mean', 0.0), ctx.attr('std', 1.0)

    def draw(shape, dtype, device, gen):
        u = torch.rand(shape, generator=gen, dtype=torch.float32,
                       device=device) * (_PHI_HI - _PHI_LO) + _PHI_LO
        z = torch.special.ndtri(u).clamp_(-2.0, 2.0)
        return (z * std + mean).to(dtype)
    _draw(ctx, draw)


@register_kernel('lookup_table')
def _lookup_table(ctx):
    """Embedding. Parity: operators/lookup_table_op.* and the JAX
    kernel: ids are clipped into [0, vocab) (``F.embedding`` would raise
    on an out-of-range id) and rows whose id equals ``padding_idx``
    return zeros. A trailing id axis of 1 is squeezed. Sequence ids
    ([B, T_pad, 1]) give a sequence of rows with their lengths.

    A sparse table in training (core/lowering.py): the gathered rows
    are detached and the lookup's zero carrier is added to them, so the
    carrier's gradient is the rows' cotangent and no [vocab, D]
    gradient is made. The carrier joins before the padding mask, so a
    padding row's cotangent is zero, as on the dense path."""
    w = ctx.input('W')
    ids_in = ctx.input('Ids')
    ids = unwrap(ids_in).long()
    if ids.dim() and ids.shape[-1] == 1:
        ids = ids.reshape(ids.shape[:-1])
    out = torch.nn.functional.embedding(ids.clamp(0, w.shape[0] - 1), w)
    carrier = ctx.attr('sparse_carrier')
    if carrier and carrier in ctx.env:
        out = out.detach() + ctx.env[carrier]
    padding_idx = ctx.attr('padding_idx', None)
    if padding_idx is not None and padding_idx >= 0:
        out = out.masked_fill((ids == padding_idx).unsqueeze(-1), 0)
    ctx.set_output('Out', rewrap(ids_in, out))


@register_kernel('concat')
def _concat(ctx):
    """As the JAX kernel: with sequences, fluid's axes address the
    packed [total, D] rows and the runtime holds padded [B, T, D], so a
    feature axis (>= 1) moves one to the right; axis 0 over sequences
    only stacks the batches and their lengths, padded to one T."""
    ins = ctx.inputs('X')
    xs = [unwrap(v) for v in ins]
    axis = ctx.attr('axis', 0)
    seq = next((v for v in ins if isinstance(v, SequenceTensor)), None)
    if seq is None:
        ctx.set_output('Out', torch.cat(xs, dim=axis))
        return
    if axis == 0 and all(isinstance(v, SequenceTensor) for v in ins):
        max_t = max(int(x.shape[1]) for x in xs)
        xs = [torch.nn.functional.pad(
            x, [0, 0] * (x.dim() - 2) + [0, max_t - x.shape[1]])
            for x in xs]
        subs = None
        if all(v.sub_lengths is not None for v in ins):
            max_o = max(int(v.sub_lengths.shape[1]) for v in ins)
            subs = torch.cat([torch.nn.functional.pad(
                v.sub_lengths, [0, max_o - v.sub_lengths.shape[1]])
                for v in ins])
        ctx.set_output('Out', SequenceTensor(
            torch.cat(xs), torch.cat([v.lengths for v in ins]), subs))
        return
    out = torch.cat(xs, dim=axis + 1 if axis >= 1 else axis)
    ctx.set_output('Out', SequenceTensor(out, seq.lengths, seq.sub_lengths))


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
    """A ``Shape`` input wins over the attr (reshape_op.cc). Fed, it
    arrives as the host value the Executor bound statically (its memo
    keyed on it); computed on the device, it costs one host read."""
    x = ctx.input('X')
    if ctx.has_input('Shape'):
        sval = unwrap(ctx.input('Shape'))
        if isinstance(sval, torch.Tensor):
            sval = host_read(sval)[0]
        shape = [int(s) for s in np.asarray(sval).ravel()]
    else:
        shape = ctx.attr('shape')
    # fluid semantics: 0 copies the input dim; -1 is inferred
    shape = [x.shape[i] if s == 0 else int(s) for i, s in enumerate(shape)]
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


@register_kernel('is_empty')
def _is_empty(ctx):
    """A 0-d bool, from the shape alone: no read of the device."""
    x = unwrap(ctx.input('X'))
    ctx.set_output('Out', torch.tensor(x.numel() == 0, device=ctx.device))


@register_kernel('print', side_effect=True)
def _print(ctx):
    """Parity: operators/print_op.cc TensorPrint. The value passes
    through; in the forward phase it is printed to stderr, the first
    ``first_n`` runs of this op when ``first_n`` is positive. As in the
    JAX package, print_phase 'backward' prints nothing (the fused
    backward has no per-op gradient stream; fetch the gradient)."""
    x = ctx.input('X')
    phase = str(ctx.attr('print_phase', 'both') or 'both').lower()
    if phase in ('forward', 'both'):
        first_n = int(ctx.attr('first_n', -1) or -1)
        # the count lives on the op, as the reference op's times_
        count = ctx.op.__dict__.setdefault('_print_count', [0])
        if first_n <= 0 or count[0] < first_n:
            count[0] += 1
            _print_tensor(ctx, x)
    ctx.set_output('Out', x)


def _print_tensor(ctx, x):
    import sys
    arr = host_read(unwrap(x))[0]
    msg = ctx.attr('message', '') or ''
    parts = [msg] if msg else []
    if ctx.attr('print_tensor_name', True):
        parts.append("Tensor[%s]" % (ctx.op.inputs.get('X') or ['?'])[0])
    if ctx.attr('print_tensor_shape', True):
        parts.append("shape: %s" % (tuple(arr.shape),))
    if ctx.attr('print_tensor_type', True):
        parts.append("dtype: %s" % arr.dtype)
    lengths = getattr(x, 'lengths', None)
    if ctx.attr('print_tensor_lod', True) and lengths is not None:
        parts.append("lod: %s" % (host_read(lengths)[0].tolist(),))
    flat = arr.ravel()
    summarize = int(ctx.attr('summarize', -1) or -1)
    if summarize >= 0:
        flat = flat[:summarize]
    parts.append("data: %s" % np.array2string(flat, threshold=20))
    print("  ".join(parts), file=sys.stderr)


@register_kernel('fill_zeros_like')
def _fill_zeros_like(ctx):
    x = ctx.input('X')
    ctx.set_output('Out', rewrap(x, torch.zeros_like(unwrap(x))))


@register_kernel('pad')
def _pad(ctx):
    """``paddings`` holds (before, after) for each dim, first dim
    first; the border is ``pad_value``."""
    x = unwrap(ctx.input('X'))
    p = [int(v) for v in ctx.attr('paddings')]
    spec = []
    for i in reversed(range(x.dim())):
        spec += [p[2 * i], p[2 * i + 1]]
    ctx.set_output('Out', torch.nn.functional.pad(
        x, spec, value=float(ctx.attr('pad_value', 0.0))))


@register_kernel('crop')
def _crop(ctx):
    """The window of ``shape`` at ``offsets``."""
    x = unwrap(ctx.input('X'))
    ctx.set_output('Out', x[tuple(
        slice(int(o), int(o) + int(n))
        for o, n in zip(ctx.attr('offsets'), ctx.attr('shape')))])


@register_kernel('scatter')
def _scatter(ctx):
    """X with the rows at ``Ids`` replaced by the rows of ``Updates``;
    where an id repeats, its last row wins, as numpy's ``out[ids] = u``
    and paddle_tpu's ``.at[].set`` on the CPU give. The winner of each
    row is chosen by a max over positions and the rows are gathered, so
    the result does not depend on the order in which the card writes
    (``index_copy_`` with repeated ids promises none)."""
    x = unwrap(ctx.input('X'))
    ids = unwrap(ctx.input('Ids')).reshape(-1).long()
    upd = unwrap(ctx.input('Updates'))
    last = torch.full((x.shape[0],), -1, dtype=torch.long, device=x.device)
    last = last.scatter_reduce(0, ids, torch.arange(
        ids.shape[0], device=x.device), 'amax')
    hit = (last >= 0).reshape((-1,) + (1,) * (x.dim() - 1))
    ctx.set_output('Out', torch.where(hit, upd[last.clamp(min=0)], x))


@register_kernel('multiplex')
def _multiplex(ctx):
    """Row i of Out is row i of ``X[Ids[i]]``."""
    ids = unwrap(ctx.input('Ids')).reshape(-1).long()
    xs = torch.stack([unwrap(v) for v in ctx.inputs('X')], 0)
    ctx.set_output('Out', xs[ids, torch.arange(ids.shape[0],
                                               device=ids.device)])


@register_kernel('reverse')
def _reverse(ctx):
    """X flipped along ``axis`` (an int or a list of them)."""
    x = unwrap(ctx.input('X'))
    axis = ctx.attr('axis')
    axes = list(axis) if isinstance(axis, (list, tuple)) else [axis]
    ctx.set_output('Out', torch.flip(x, axes))


@register_kernel('shape')
def _shape(ctx):
    """The input's shape as int32, made from the shape the host already
    knows: no read of the device."""
    x = unwrap(ctx.input('Input'))
    ctx.set_output('Out', torch.tensor(list(x.shape), dtype=torch.int32,
                                       device=ctx.device))


def _arg(name, fn):
    @register_kernel(name)
    def _k(ctx, fn=fn):
        """The index of the extreme along ``axis``, the first on ties
        (as ``jnp.argmax``); int64, where paddle_tpu gives int32."""
        ctx.set_output('Out', fn(unwrap(ctx.input('X')),
                                 dim=ctx.attr('axis', -1)))


_arg('arg_max', torch.argmax)
_arg('arg_min', torch.argmin)


@register_kernel('feed')
@register_kernel('fetch')
def _feed_fetch(ctx):
    """The reference's feed and fetch op types: the identity."""
    ctx.set_output('Out', ctx.input('X'))
