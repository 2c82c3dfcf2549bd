"""Forward shape/dtype inference over the Program IR (ANALYSIS.md
"Inference registry").

Counterpart of paddle_tpu/analysis/infer.py, with every rule it
registers. A per-op-type rule registry (``register_shape``) seeded for
the op families the JAX package has kernels for — mul / conv2d /
elementwise_* / batch_norm / softmax / reduce_* / reshape / concat /
lookup_table — plus the ops the compiler itself emits
(``fused_elementwise``, ``fused_conv``, ``assign_value``,
``zero_reduce_scatter``). A rule for an op the port has no kernel for
yet stays registered, so both packages count the same ``covered`` ops
and file the same diagnostics. Rules propagate :class:`VarInfo`
(per-dim sizes with ``None`` for dynamic dims, canonical dtype string)
forward through the program.

Severity policy (the golden sweep pins zero errors, so this is
load-bearing):

- intra-op input incompatibility that the lowering could only surface
  as a kernel error (mul inner-dim mismatch, broadcast conflict,
  concat off-axis mismatch, conv channel/groups mismatch, float ids
  into lookup_table) -> **error**;
- inferred-vs-declared disagreement -> **warning**, and the DECLARED
  shape wins for further propagation (a wrong rule must never cascade
  into false errors downstream);
- ops without a rule propagate their declared metadata untouched;
- inside control-flow sub-blocks every finding is demoted to warning
  (loop-carried shapes legitimately vary across iterations).
"""
import numpy as np

from ..compiler.passes import _ELEMENTWISE
from ..framework import Block, Operator, convert_np_dtype
from .diagnostics import Diagnostic, ERROR, WARNING

__all__ = ['VarInfo', 'register_shape', 'registered_shape_ops',
           'infer_program', 'declared_info']


class VarInfo(object):
    """Static metadata for one value: ``shape`` is a tuple with ``None``
    for unknown dims (or None when even the rank is unknown); ``dtype``
    a canonical numpy dtype string or None."""

    __slots__ = ('shape', 'dtype')

    def __init__(self, shape=None, dtype=None):
        self.shape = tuple(shape) if shape is not None else None
        self.dtype = dtype

    @property
    def rank(self):
        return None if self.shape is None else len(self.shape)

    def numel(self):
        if self.shape is None or any(d is None for d in self.shape):
            return None
        return int(np.prod([int(d) for d in self.shape])) \
            if self.shape else 1

    def __repr__(self):
        return 'VarInfo(shape=%s, dtype=%s)' % (self.shape, self.dtype)


def declared_info(var):
    """VarInfo from a declared Variable: -1 / 0-negative dims are
    dynamic (the batch dim ``layers.data`` prepends)."""
    shape = getattr(var, 'shape', None)
    if shape is None:
        return VarInfo(None, getattr(var, 'dtype', None))
    return VarInfo(tuple(None if int(d) < 0 else int(d) for d in shape),
                   getattr(var, 'dtype', None))


# the JAX package's runtime dtype names (it runs without x64): dtypes
# are compared under them, so both packages find the same mismatches
# although the port keeps int64 ids at run time
_CANON = {'int64': 'int32', 'float64': 'float32', 'uint64': 'uint32'}


def _canon(dtype):
    if dtype is None:
        return None
    try:
        d = convert_np_dtype(dtype)
    except TypeError:
        return str(dtype)
    return _CANON.get(d, d)


def _dims_agree(a, b):
    return a is None or b is None or int(a) == int(b)


def _merge_shapes(declared, inferred):
    """Meet of declared and inferred: known beats unknown; on a known
    conflict the DECLARED dim wins. Returns (shape, conflict?)."""
    if inferred is None:
        return declared, False
    if declared is None:
        return inferred, False
    if len(declared) != len(inferred):
        return declared, True
    out, conflict = [], False
    for d, i in zip(declared, inferred):
        if d is None:
            out.append(i)
        elif i is None or int(d) == int(i):
            out.append(d)
        else:
            out.append(d)
            conflict = True
    return tuple(out), conflict


# ---- rule registry ---------------------------------------------------------

_RULES = {}


def register_shape(*op_types):
    """Decorator: ``fn(op, env, emit) -> {out_name: VarInfo}`` where
    ``env(name)`` resolves current VarInfo and ``emit(code, severity,
    message, vars)`` files a diagnostic against the op. COMPILER.md's
    pass-authoring note: register a rule for any op type your pass
    emits, or the sanitizer's shape diff goes blind there."""
    def deco(fn):
        for t in op_types:
            _RULES[t] = fn
        return fn
    return deco


def registered_shape_ops():
    return sorted(_RULES)


def _first(op, slot):
    names = op.inputs.get(slot) or []
    return names[0] if names else None


def _out(op, slot='Out'):
    names = op.outputs.get(slot) or []
    return names[0] if names else None


# identity-shaped ops: first (X) input -> every output in the named slot
_IDENTITY_SLOTS = {
    'softmax': ('X', ('Out',)),
    'dropout': ('X', ('Out', 'Mask')),
    'batch_norm': ('X', ('Y',)),
    'layer_norm': ('X', ('Y',)),
    'assign': ('X', ('Out',)),
    'relu_grad': ('X', ('Out',)),
    'softmax_with_cross_entropy': ('Logits', ('Softmax',)),
    'zero_reduce_scatter': ('X', ('Out',)),
}


def _register_identity_ops():
    @register_shape(*sorted(_ELEMENTWISE - {
        'elementwise_add', 'elementwise_sub', 'elementwise_mul',
        'elementwise_div', 'elementwise_max', 'elementwise_min',
        'elementwise_pow'}))
    def _unary_elementwise(op, env, emit):
        x = env(_first(op, 'X'))
        out = _out(op)
        if out is None or x is None:
            return {}
        return {out: VarInfo(x.shape, x.dtype)}


@register_shape('cast')
def _cast(op, env, emit):
    x = env(_first(op, 'X'))
    out = _out(op)
    if out is None or x is None:
        return {}
    return {out: VarInfo(x.shape, op.attrs.get('out_dtype')
                         or op.attrs.get('dtype') or x.dtype)}


@register_shape('softmax', 'dropout', 'batch_norm', 'layer_norm',
                'assign', 'zero_reduce_scatter',
                'softmax_with_cross_entropy')
def _identity(op, env, emit):
    in_slot, out_slots = _IDENTITY_SLOTS[op.type]
    updates = {}
    if op.type == 'zero_reduce_scatter':
        # bucketed: Out[i] mirrors X[i], name for name
        for nm_in, nm_out in zip(op.inputs.get('X', ()),
                                 op.outputs.get('Out', ())):
            x = env(nm_in)
            if x is not None:
                updates[nm_out] = VarInfo(x.shape, x.dtype)
        return updates
    x = env(_first(op, in_slot))
    if x is None:
        return {}
    for slot in out_slots:
        nm = _out(op, slot)
        if nm is not None:
            updates[nm] = VarInfo(x.shape, x.dtype)
    if op.type == 'softmax_with_cross_entropy':
        loss = _out(op, 'Loss')
        if loss is not None and x.shape is not None and len(x.shape):
            updates[loss] = VarInfo(tuple(x.shape[:-1]) + (1,), x.dtype)
    return updates


def _broadcast_check(op, x, y, emit):
    """Paddle elementwise semantics: Y aligns to X's dims starting at
    ``axis`` (default: trailing). A known-unequal pair with neither side
    1 can only die in the op's kernel — error here instead."""
    if x.shape is None or y.shape is None:
        return
    if len(y.shape) > len(x.shape):
        return  # grad/unusual orientation: leave to the trace
    axis = op.attrs.get('axis', -1)
    if axis is None or int(axis) < 0:
        axis = len(x.shape) - len(y.shape)
    axis = int(axis)
    for j, yd in enumerate(y.shape):
        i = axis + j
        if i >= len(x.shape):
            break
        xd = x.shape[i]
        if xd is None or yd is None or int(yd) == 1 or int(xd) == 1:
            continue
        if int(xd) != int(yd):
            emit('broadcast-mismatch', ERROR,
                 "elementwise inputs cannot broadcast: X dim %d is %s "
                 "but Y dim %d is %s (axis=%s)"
                 % (i, xd, j, yd, op.attrs.get('axis', -1)),
                 [_first(op, 'X'), _first(op, 'Y')])
            return


@register_shape('elementwise_add', 'elementwise_sub', 'elementwise_mul',
                'elementwise_div', 'elementwise_max', 'elementwise_min',
                'elementwise_pow')
def _elementwise(op, env, emit):
    x, y = env(_first(op, 'X')), env(_first(op, 'Y'))
    out = _out(op)
    if out is None or x is None:
        return {}
    if y is not None:
        _broadcast_check(op, x, y, emit)
        if x.dtype and y.dtype and _canon(x.dtype) != _canon(y.dtype):
            emit('dtype-mismatch', WARNING,
                 "elementwise inputs disagree on dtype: %s vs %s"
                 % (x.dtype, y.dtype),
                 [_first(op, 'X'), _first(op, 'Y')])
    return {out: VarInfo(x.shape, x.dtype)}


def _flat2(shape, ncol):
    """Collapse to 2-D around ``ncol`` like mul does; dims with unknown
    members collapse to None."""
    a, b = shape[:ncol], shape[ncol:]

    def prod(dims):
        if any(d is None for d in dims):
            return None
        return int(np.prod([int(d) for d in dims])) if dims else 1
    return prod(a), prod(b)


@register_shape('mul')
def _mul(op, env, emit):
    x, y = env(_first(op, 'X')), env(_first(op, 'Y'))
    out = _out(op)
    if out is None or x is None or y is None \
            or x.shape is None or y.shape is None:
        return {}
    xn = int(op.attrs.get('x_num_col_dims', 1))
    yn = int(op.attrs.get('y_num_col_dims', 1))
    if len(x.shape) < xn + 1 or len(y.shape) < yn + 1:
        emit('rank-mismatch', ERROR,
             "mul needs X rank > x_num_col_dims (%d) and Y rank > "
             "y_num_col_dims (%d); got X%s Y%s"
             % (xn, yn, x.shape, y.shape),
             [_first(op, 'X'), _first(op, 'Y')])
        return {}
    _, xk = _flat2(x.shape, xn)
    yk, _ = _flat2(y.shape, yn)
    if xk is not None and yk is not None and xk != yk:
        emit('rank-mismatch', ERROR,
             "mul inner dims mismatch: X%s flattens to [*, %d] but Y%s "
             "flattens to [%d, *]" % (x.shape, xk, y.shape, yk),
             [_first(op, 'X'), _first(op, 'Y')])
        return {}
    return {out: VarInfo(tuple(x.shape[:xn]) + tuple(y.shape[yn:]),
                         x.dtype)}


@register_shape('matmul')
def _matmul(op, env, emit):
    x, y = env(_first(op, 'X')), env(_first(op, 'Y'))
    out = _out(op)
    if out is None or x is None or y is None \
            or x.shape is None or y.shape is None \
            or len(x.shape) < 2 or len(y.shape) < 2:
        return {}
    tx = bool(op.attrs.get('transpose_X', False))
    ty = bool(op.attrs.get('transpose_Y', False))
    xk = x.shape[-2] if tx else x.shape[-1]
    yk = y.shape[-1] if ty else y.shape[-2]
    if xk is not None and yk is not None and int(xk) != int(yk):
        emit('rank-mismatch', ERROR,
             "matmul contraction dims mismatch: %s vs %s "
             "(transpose_X=%s transpose_Y=%s)" % (xk, yk, tx, ty),
             [_first(op, 'X'), _first(op, 'Y')])
        return {}
    m = x.shape[-1] if tx else x.shape[-2]
    n = y.shape[-2] if ty else y.shape[-1]
    batch = x.shape[:-2] if len(x.shape) >= len(y.shape) else y.shape[:-2]
    return {out: VarInfo(tuple(batch) + (m, n), x.dtype)}


def _conv_out(size, k, pad, stride, dilation):
    if size is None or k is None:
        return None
    eff = dilation * (int(k) - 1) + 1
    return (int(size) + 2 * pad - eff) // stride + 1


@register_shape('conv2d', 'depthwise_conv2d')
def _conv2d(op, env, emit):
    x = env(_first(op, 'Input'))
    f = env(_first(op, 'Filter'))
    out = _out(op, 'Output')
    if out is None or x is None or f is None \
            or x.shape is None or f.shape is None \
            or len(x.shape) != 4 or len(f.shape) != 4:
        return {}
    groups = int(op.attrs.get('groups', 1) or 1)
    cin, fc = x.shape[1], f.shape[1]
    if cin is not None and fc is not None \
            and int(cin) != int(fc) * groups:
        emit('conv-channel-mismatch', ERROR,
             "conv2d input channels (%s) != filter channels (%s) * "
             "groups (%d)" % (cin, fc, groups),
             [_first(op, 'Input'), _first(op, 'Filter')])
        return {}
    strides = list(op.attrs.get('strides', [1, 1]) or [1, 1])
    pads = list(op.attrs.get('paddings', [0, 0]) or [0, 0])
    dil = list(op.attrs.get('dilations', [1, 1]) or [1, 1])
    ho = _conv_out(x.shape[2], f.shape[2], int(pads[0]),
                   int(strides[0]), int(dil[0]))
    wo = _conv_out(x.shape[3], f.shape[3], int(pads[1]),
                   int(strides[1]), int(dil[1]))
    return {out: VarInfo((x.shape[0], f.shape[0], ho, wo), x.dtype)}


@register_shape('pool2d')
def _pool2d(op, env, emit):
    x = env(_first(op, 'X'))
    out = _out(op)
    if out is None or x is None or x.shape is None \
            or len(x.shape) != 4:
        return {}
    if op.attrs.get('global_pooling', False):
        return {out: VarInfo((x.shape[0], x.shape[1], 1, 1), x.dtype)}
    ksize = list(op.attrs.get('ksize', [2, 2]) or [2, 2])
    strides = list(op.attrs.get('strides', [1, 1]) or [1, 1])
    pads = list(op.attrs.get('paddings', [0, 0]) or [0, 0])
    ceil = bool(op.attrs.get('ceil_mode', False))

    def _o(size, k, p, s):
        if size is None:
            return None
        num = int(size) + 2 * int(p) - int(k)
        return (num + int(s) - 1) // int(s) + 1 if ceil \
            else num // int(s) + 1
    return {out: VarInfo((x.shape[0], x.shape[1],
                          _o(x.shape[2], ksize[0], pads[0], strides[0]),
                          _o(x.shape[3], ksize[1], pads[1], strides[1])),
                         x.dtype)}


@register_shape('reduce_sum', 'reduce_mean', 'reduce_max', 'reduce_min',
                'reduce_prod')
def _reduce(op, env, emit):
    x = env(_first(op, 'X'))
    out = _out(op)
    if out is None or x is None or x.shape is None:
        return {}
    keep = bool(op.attrs.get('keep_dim', False))
    dims = op.attrs.get('dim', None)
    if op.attrs.get('reduce_all', False) or dims is None:
        shape = (1,) * len(x.shape) if keep else (1,)
        return {out: VarInfo(shape, x.dtype)}
    if not isinstance(dims, (list, tuple)):
        dims = [dims]
    dims = {int(d) % len(x.shape) for d in dims} if x.shape else set()
    shape = tuple(1 if i in dims else d
                  for i, d in enumerate(x.shape)) if keep else \
        tuple(d for i, d in enumerate(x.shape) if i not in dims)
    return {out: VarInfo(shape or (1,), x.dtype)}


@register_shape('mean')
def _mean(op, env, emit):
    out = _out(op)
    x = env(_first(op, 'X'))
    if out is None:
        return {}
    return {out: VarInfo((1,), x.dtype if x else None)}


@register_shape('reshape')
def _reshape(op, env, emit):
    x = env(_first(op, 'X'))
    out = _out(op)
    if out is None or x is None:
        return {}
    if op.inputs.get('Shape'):
        return {out: VarInfo(None, x.dtype)}   # runtime shape feed
    target = op.attrs.get('shape')
    if not target:
        return {out: VarInfo(None, x.dtype)}
    shape, infer_at = [], None
    for i, d in enumerate(target):
        d = int(d)
        if d == -1:
            infer_at = i
            shape.append(None)
        elif d == 0:
            shape.append(x.shape[i] if x.shape is not None
                         and i < len(x.shape) else None)
        else:
            shape.append(d)
    if infer_at is not None:
        total = x.numel()
        rest = [d for i, d in enumerate(shape) if i != infer_at]
        if total is not None and all(d is not None for d in rest):
            denom = int(np.prod([int(d) for d in rest])) if rest else 1
            if denom and total % denom == 0:
                shape[infer_at] = total // denom
            else:
                emit('reshape-numel', ERROR,
                     "reshape cannot infer -1: %d elements do not "
                     "divide by %s (target %s)" % (total, denom, target),
                     [_first(op, 'X')])
                return {}
    return {out: VarInfo(tuple(shape), x.dtype)}


@register_shape('concat')
def _concat(op, env, emit):
    names = op.inputs.get('X') or []
    out = _out(op)
    infos = [env(n) for n in names]
    if out is None or not infos or any(i is None for i in infos):
        return {}
    known = [i for i in infos if i.shape is not None]
    if not known:
        return {}
    rank = len(known[0].shape)
    axis = int(op.attrs.get('axis', 0))
    axis = axis % rank if rank else 0
    base = list(known[0].shape)
    axis_total, any_unknown = 0, False
    for idx, info in enumerate(infos):
        if info.shape is None:
            any_unknown = True
            continue
        if len(info.shape) != rank:
            emit('concat-rank', ERROR,
                 "concat inputs disagree on rank: %s vs %s"
                 % (known[0].shape, info.shape), names)
            return {}
        for d in range(rank):
            if d == axis:
                continue
            if not _dims_agree(base[d], info.shape[d]):
                emit('concat-mismatch', ERROR,
                     "concat off-axis dim %d mismatch: %s vs %s "
                     "(axis=%d)" % (d, base[d], info.shape[d], axis),
                     names)
                return {}
            if base[d] is None:
                base[d] = info.shape[d]
        if info.shape[axis] is None:
            any_unknown = True
        else:
            axis_total += int(info.shape[axis])
    dtypes = {_canon(i.dtype) for i in infos if i.dtype}
    if len(dtypes) > 1:
        emit('dtype-mismatch', WARNING,
             "concat inputs disagree on dtype: %s"
             % sorted(dtypes), names)
    base[axis] = None if any_unknown else axis_total
    return {out: VarInfo(tuple(base), known[0].dtype)}


@register_shape('lookup_table')
def _lookup_table(op, env, emit):
    w = env(_first(op, 'W'))
    ids = env(_first(op, 'Ids'))
    out = _out(op)
    if out is None or w is None or w.shape is None \
            or len(w.shape) != 2:
        return {}
    if ids is not None and ids.dtype is not None:
        kind = np.dtype(_canon(ids.dtype)).kind
        if kind not in ('i', 'u'):
            emit('dtype-mismatch', ERROR,
                 "lookup_table ids must be an integer dtype, got %s"
                 % ids.dtype, [_first(op, 'Ids')])
    if ids is None or ids.shape is None:
        return {out: VarInfo(None, w.dtype)}
    base = ids.shape[:-1] if (len(ids.shape) and
                              ids.shape[-1] == 1) else ids.shape
    return {out: VarInfo(tuple(base) + (w.shape[1],), w.dtype)}


@register_shape('cross_entropy')
def _cross_entropy(op, env, emit):
    x = env(_first(op, 'X'))
    out = _out(op, 'Y') or _out(op)
    if out is None or x is None or x.shape is None \
            or len(x.shape) < 1:
        return {}
    return {out: VarInfo(tuple(x.shape[:-1]) + (1,), x.dtype)}


@register_shape('sum')
def _sum(op, env, emit):
    names = op.inputs.get('X') or []
    out = _out(op)
    infos = [env(n) for n in names if env(n) is not None]
    known = [i for i in infos if i.shape is not None]
    if out is None or not known:
        return {}
    base = known[0].shape
    for i in known[1:]:
        if len(i.shape) != len(base) or not all(
                _dims_agree(a, b) for a, b in zip(base, i.shape)):
            emit('sum-mismatch', ERROR,
                 "sum inputs disagree on shape: %s vs %s"
                 % (base, i.shape), names)
            return {}
    return {out: VarInfo(base, known[0].dtype)}


@register_shape('transpose')
def _transpose(op, env, emit):
    x = env(_first(op, 'X'))
    out = _out(op)
    perm = op.attrs.get('axis')
    if out is None or x is None or x.shape is None or not perm:
        return {}
    if len(perm) != len(x.shape):
        emit('rank-mismatch', ERROR,
             "transpose perm %s does not match input rank %d"
             % (perm, len(x.shape)), [_first(op, 'X')])
        return {}
    return {out: VarInfo(tuple(x.shape[int(p)] for p in perm), x.dtype)}


@register_shape('top_k')
def _top_k(op, env, emit):
    x = env(_first(op, 'X'))
    k = op.attrs.get('k', 1)
    updates = {}
    if x is None or x.shape is None or not len(x.shape):
        return updates
    shape = tuple(x.shape[:-1]) + (int(k),)
    nm = _out(op)
    if nm is not None:
        updates[nm] = VarInfo(shape, x.dtype)
    ind = _out(op, 'Indices')
    if ind is not None:
        updates[ind] = VarInfo(shape, 'int64')
    return updates


@register_shape('fill_constant', 'uniform_random', 'gaussian_random',
                'assign_value')
def _filled(op, env, emit):
    out = _out(op)
    shape = op.attrs.get('shape')
    if out is None or shape is None:
        return {}
    return {out: VarInfo(tuple(None if int(d) < 0 else int(d)
                               for d in shape),
                         op.attrs.get('dtype') or 'float32')}


@register_shape('fill_constant_batch_size_like',
                'uniform_random_batch_size_like',
                'gaussian_random_batch_size_like')
def _filled_like(op, env, emit):
    out = _out(op)
    shape = op.attrs.get('shape')
    if out is None or shape is None:
        return {}
    shape = [None if int(d) < 0 else int(d) for d in shape]
    out_idx = int(op.attrs.get('output_dim_idx', 0))
    ref = env(_first(op, 'Input'))
    in_idx = int(op.attrs.get('input_dim_idx', 0))
    if 0 <= out_idx < len(shape):
        shape[out_idx] = (ref.shape[in_idx]
                          if ref is not None and ref.shape is not None
                          and in_idx < len(ref.shape) else None)
    return {out: VarInfo(tuple(shape),
                         op.attrs.get('dtype') or 'float32')}


@register_shape('fused_elementwise', 'fused_conv')
def _fused(op, env, emit):
    """Replay the captured sub-ops through their own rules so the fused
    kernel stays as transparent to inference as to execution."""
    local = {}

    def _env(name):
        return local.get(name) or env(name)
    updates = {}
    for t, ins, outs, attrs in op.attrs.get('sub_ops', ()):
        rule = _RULES.get(t)
        if rule is None:
            continue
        sub = Operator.__new__(Operator)
        sub.block, sub.type = op.block, t
        sub.inputs = {s: list(v) for s, v in ins.items()}
        sub.outputs = {s: list(v) for s, v in outs.items()}
        sub.attrs = dict(attrs)
        try:
            got = rule(sub, _env, emit) or {}
        except Exception:
            got = {}
        local.update(got)
    for nm in op.output_arg_names:
        if nm in local:
            updates[nm] = local[nm]
    return updates


@register_shape('cos_sim')
def _cos_sim(op, env, emit):
    x = env(_first(op, 'X'))
    out = _out(op)
    if out is None or x is None or x.shape is None or not len(x.shape):
        return {}
    return {out: VarInfo((x.shape[0], 1), x.dtype)}


_register_identity_ops()


# ---- the forward walk ------------------------------------------------------

def infer_program(program, feeds=None):
    """Propagate VarInfo forward through ``program``.

    Returns ``(env, diagnostics, stats)`` — ``env`` maps every var name
    to its final VarInfo, ``stats`` carries rule-coverage counters for
    the CLI report.
    """
    env = {}
    diags = []
    stats = {'ops': 0, 'covered': 0}
    for b in program.blocks:
        for v in b.vars.values():
            env[v.name] = declared_info(v)

    def lookup(name):
        if name is None:
            return None
        info = env.get(name)
        if info is None:
            info = env[name] = VarInfo(None, None)
        return info

    def _walk(block, bidx, demote):
        for i, op in enumerate(block.ops):
            stats['ops'] += 1

            def emit(code, severity, message, var_names=()):
                if demote and severity == ERROR:
                    severity = WARNING
                diags.append(Diagnostic(
                    code, severity, message, block_idx=bidx,
                    op_index=i, op_type=op.type,
                    var_names=[n for n in var_names if n]))
            rule = _RULES.get(op.type)
            if rule is not None:
                stats['covered'] += 1
                try:
                    updates = rule(op, lookup, emit) or {}
                except Exception:
                    updates = {}   # a rule bug must never fail a run
                for nm, info in updates.items():
                    cur = env.get(nm)
                    declared = cur.shape if cur is not None else None
                    merged, conflict = _merge_shapes(declared, info.shape)
                    if conflict:
                        emit('shape-mismatch-declared', WARNING,
                             "inferred shape %s conflicts with declared "
                             "%s for %r; declared wins"
                             % (info.shape, declared, nm), [nm])
                    env[nm] = VarInfo(
                        merged, info.dtype or
                        (cur.dtype if cur is not None else None))
            for v in op.attrs.values():
                if isinstance(v, Block):
                    _walk(v, v.idx, True)

    _walk(program.global_block(), 0, False)
    return env, diags, stats
