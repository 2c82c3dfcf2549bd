"""The conv-epilogue fusion pass and its ``fused_conv`` op.

Counterpart of paddle_tpu/compiler/passes.py, trimmed to
``conv_epilogue_fuse`` (``ConvEpilogueFusion``), the helpers it shares
with the other passes, and the ``fused_conv`` op kernel. The pass forms
the same regions as the JAX package's: a ``conv2d`` or
``depthwise_conv2d`` head, then the single-reader chain of batch_norm,
activation, scale and binary elementwise ops behind it.

The ``fused_conv`` op runs its region as ONE call of
``ops/cuda_kernels.py::fused_conv``: on the card the hand-written kernel
(``csrc/fused_conv.cu``, conv plus the whole epilogue on chip, one
store), on the CPU its plain version. A region the kernel cannot take
replays its captured ops exactly, and the reason is counted in
``FALLBACKS``. A kernel that fails to build or launch raises: no failure
turns into a replay.
"""
import contextlib
import weakref

import torch

from ..framework import Block, Operator
from ..core.amp import amp_enabled
from ..core.registry import register_kernel
from ..ops import cuda_kernels as ck
from ..ops.activations import ACTS, ACTS_P, BINS, PARAM_ATTRS

__all__ = ['ConvEpilogueFusion', 'FUSED_CONV_OP', 'FALLBACKS',
           'reset_fallback_counts', 'conv_for_testing']

FUSED_CONV_OP = 'fused_conv'

# replay reason -> count since the last reset; a plain dict, bumped only
# where a fused_conv region replays its captured ops
FALLBACKS = {}


def reset_fallback_counts():
    FALLBACKS.clear()


# ---- helpers shared with paddle_tpu's passes -----------------------------------
def _op_reads(op):
    """All names an op (with nested sub-blocks) may read from the
    enclosing environment."""
    reads = list(op.input_arg_names)
    sub = op.attrs.get('sub_block')
    if sub is not None:
        produced = set()
        for sop in sub.ops:
            reads.extend(n for n in _op_reads(sop) if n not in produced)
            produced.update(sop.output_arg_names)
    return reads


def _op_writes(op):
    writes = list(op.output_arg_names)
    sub = op.attrs.get('sub_block')
    if sub is not None:
        for sop in sub.ops:
            writes.extend(_op_writes(sop))
    return writes


def _has_sub_block(op):
    return any(isinstance(v, Block) for v in op.attrs.values())


def _hidden_reads(op):
    """Names consumed through attrs, invisible to ``_op_reads``: the
    backward marker's sparse-lookup ids."""
    if op.type == 'backward_marker':
        return [p[0] for pairs in (op.attrs.get('sparse') or {}).values()
                for p in pairs]
    return []


# Pure elementwise/activation op types: a chain of these replayed in
# order is the exact computation of the original ops.
_ELEMENTWISE = frozenset({
    'elementwise_add', 'elementwise_sub', 'elementwise_mul',
    'elementwise_div', 'elementwise_max', 'elementwise_min',
    'elementwise_pow', 'scale', 'clip', 'relu', 'sigmoid', 'tanh',
    'exp', 'log', 'sqrt', 'abs', 'square', 'softplus', 'softsign',
    'ceil', 'floor', 'round', 'reciprocal', 'logsigmoid',
    'tanh_shrink', 'brelu', 'leaky_relu', 'soft_relu', 'elu', 'relu6',
    'pow', 'stanh', 'hard_shrink', 'softshrink', 'thresholded_relu',
    'hard_sigmoid', 'swish',
})

# Epilogue op types conv_epilogue_fuse may absorb behind a conv
_EPILOGUE_OPS = _ELEMENTWISE | {'batch_norm'}
_HEADS = ('conv2d', 'depthwise_conv2d')


def _attrs_fusable(attrs):
    for v in attrs.values():
        if not isinstance(v, (int, float, bool, str, bytes, type(None),
                              list, tuple)):
            return False
        if isinstance(v, (list, tuple)) and not all(
                isinstance(e, (int, float, bool, str)) for e in v):
            return False
    return True


def _capture_region(members):
    """(external inputs, sub_ops attr tuples) for an op region about to
    collapse into one fused op. An input is external when no earlier
    member produced it."""
    produced = set()
    ext_inputs = []
    for m in members:
        for nm in m.input_arg_names:
            if nm not in produced and nm not in ext_inputs:
                ext_inputs.append(nm)
        produced.update(m.output_arg_names)
    sub_ops = [(m.type, {s: list(v) for s, v in m.inputs.items()},
                {s: list(v) for s, v in m.outputs.items()},
                {k: (list(v) if isinstance(v, tuple) else v)
                 for k, v in m.attrs.items()})
               for m in members]
    return ext_inputs, sub_ops


def _materialized_sub_ops(ctx):
    """The fused op's captured region as live Operators, memoized on the
    op instance."""
    ops = ctx.op.__dict__.get('_materialized')
    if ops is None:
        ops = [Operator(ctx.runner.block, t, inputs=dict(i),
                        outputs=dict(o), attrs=dict(a))
               for t, i, o, a in ctx.attr('sub_ops')]
        ctx.op.__dict__['_materialized'] = ops
    return ops


# ---- the fused_conv op -------------------------------------------------------
def _pair2(v):
    if isinstance(v, (list, tuple)):
        return (int(v[0]), int(v[1]))
    return (int(v), int(v))


def _classify_aux(x_shape, y, axis):
    """Map a binary elementwise operand against the NCHW conv output
    (shape ``x_shape``) onto an epilogue aux kind, as ops/common.py's
    ``bcast_y`` broadcasts it: 'c' per channel [1, C], 'nc' per sample
    and channel [N, C], 't' the whole tensor (as NHWC), 's' a scalar.
    Returns (kind, value) or None when the broadcast has no epilogue
    form."""
    n, c, h, w = x_shape
    if y.dim() == 0:
        return 's', y.reshape(1, 1)
    if tuple(int(d) for d in y.shape) == tuple(x_shape):
        return 't', y.permute(0, 2, 3, 1)
    ys = [int(d) for d in y.shape]
    if axis is None or axis == -1:
        axis = 4 - len(ys)
    while ys and axis + len(ys) > 4 and ys[-1] == 1:
        ys.pop()
    if axis < 0 or axis + len(ys) > 4 or \
            list(x_shape[axis:axis + len(ys)]) != ys:
        return None
    b = [1] * axis + ys + [1] * (4 - axis - len(ys))
    if b == [1, c, 1, 1]:
        return 'c', y.reshape(1, c)
    if b == [n, c, 1, 1]:
        return 'nc', y.reshape(n, c)
    if b == [1, 1, 1, 1]:
        return 's', y.reshape(1, 1)
    return None


def _memo(ctx, name, tensors, make):
    """``make()``, kept on the fused op while ``tensors`` (scope
    parameters) stay the same objects at the same versions, so serving
    requests reuse the re-laid-out weight and the folded batch norm.
    The entry holds its sources only weakly and goes with the first of
    them to be freed, so a dropped scope frees its tensors and what was
    made from them. Under autograd the parameters are fresh leaves each
    step and nothing is kept."""
    if torch.is_grad_enabled():
        return make()
    memo = ctx.op.__dict__.setdefault('_memo', {})
    hit = memo.get(name)
    if hit is not None and len(hit[0]) == len(tensors) and all(
            r() is t and t._version == v for t, (r, v) in zip(tensors,
                                                               hit[0])):
        return hit[1]
    entry = [None, make()]

    def forget(_):
        if memo.get(name) is entry:
            del memo[name]
    entry[0] = [(weakref.ref(t, forget), t._version) for t in tensors]
    memo[name] = entry
    return entry[1]


def _folded_bn(ctx, op, cout):
    """The inference batch_norm as the affine stage's (alpha, beta), from
    the live scope values: alpha = scale / sqrt(var + eps), beta = bias -
    mean * alpha, in f32."""
    params = [ctx.env[op.inputs[s][0]] for s in
              ('Scale', 'Bias', 'Mean', 'Variance')]

    def fold():
        scale, bias, mean, var = (t.float() for t in params)
        alpha = scale * torch.rsqrt(var + float(op.attrs.get('epsilon',
                                                             1e-5)))
        return alpha.reshape(1, cout), bias.reshape(1, cout) - \
            mean.reshape(1, cout) * alpha.reshape(1, cout)
    return _memo(ctx, ('bn', op.outputs['Y'][0]), params, fold)


def _lower_fused_conv(ctx, ops):
    """Run a fused_conv region as one fused conv call; returns None on
    success or the reason it cannot, before anything is written to the
    environment."""
    conv = ops[0]
    if conv.type not in _HEADS:
        return 'head:%s' % conv.type
    if _pair2(conv.attrs.get('dilations', (1, 1))) != (1, 1):
        return 'dilation'
    x = ctx.env[conv.inputs['Input'][0]]
    w = ctx.env[conv.inputs['Filter'][0]]
    if x.dim() != 4 or w.dim() != 4:
        return 'rank'
    floats = (torch.float32, torch.bfloat16)
    if x.dtype not in floats or w.dtype not in floats:
        return 'dtype'
    # under AMP the operands go to the card in bf16, as the unfused
    # conv2d op's; otherwise the region runs at x's dtype, as in JAX
    amp = amp_enabled(x.device)
    if not amp and w.dtype != x.dtype:
        return 'dtype'
    cdt = torch.bfloat16 if amp else x.dtype
    n, cin, h, w_in = (int(d) for d in x.shape)
    groups = int(conv.attrs.get('groups', 1) or 1)
    # conv2d with groups == channels and a [C, 1, KH, KW] filter is a
    # depthwise conv (what layers.conv2d(groups=C) builds)
    depthwise = conv.type == 'depthwise_conv2d' or (
        groups == cin and int(w.shape[0]) == cin and int(w.shape[1]) == 1)
    if depthwise:
        if int(w.shape[0]) != cin or int(w.shape[1]) != 1:
            return 'depthwise-multiplier'
        cout = cin
    else:
        if groups != 1:
            return 'groups'
        if int(w.shape[1]) != cin:
            return 'filter-shape'
        cout = int(w.shape[0])
    strides = _pair2(conv.attrs.get('strides', (1, 1)))
    pads = _pair2(conv.attrs.get('paddings', (0, 0)))
    kh, kw = int(w.shape[2]), int(w.shape[3])
    ho = (h + 2 * pads[0] - kh) // strides[0] + 1
    wo = (w_in + 2 * pads[1] - kw) // strides[1] + 1
    if ho <= 0 or wo <= 0:
        return 'degenerate'
    out_shape = (n, cout, ho, wo)

    # map the epilogue members onto kernel stages + aux operands
    stages, aux, kinds = [], [], []
    cur = conv.outputs['Output'][0]
    for op in ops[1:]:
        if op.type not in BINS and op.inputs.get('X', [None])[0] != cur:
            return 'chain-slot'
        if op.type == 'batch_norm':
            if op.attrs.get('data_layout', 'NCHW') != 'NCHW':
                return 'bn-layout'
            if not op.attrs.get('is_test', False):
                # batch moments need the whole conv output: the kernel's
                # moment partials (emit_stats) come with training
                return 'train-bn'
            aux += list(_folded_bn(ctx, op, cout))
            kinds += ['c', 'c']
            stages.append(('affine', len(aux) - 2, len(aux) - 1))
            cur = op.outputs['Y'][0]
            continue
        if op.type in BINS:
            xin = op.inputs.get('X', [None])[0]
            yin = op.inputs.get('Y', [None])[0]
            if xin == cur:
                swap, other_nm = False, yin
            elif yin == cur:
                swap, other_nm = True, xin
            else:
                return 'chain-slot'
            other = ctx.env.get(other_nm)
            if not isinstance(other, torch.Tensor):
                return 'aux-missing'
            if not other.is_floating_point():
                return 'aux-dtype'
            if swap:
                # the chain value is the Y operand (the ResNet residual,
                # elementwise_add(x=short, y=conv_out)); bcast_y leaves Y
                # untouched only for equal shapes
                if tuple(int(d) for d in other.shape) != out_shape:
                    return 'aux-shape'
                got = ('t', other.permute(0, 2, 3, 1))
            else:
                got = _classify_aux(out_shape, other,
                                    op.attrs.get('axis', -1))
                if got is None:
                    return 'aux-shape'
            kinds.append(got[0])
            aux.append(got[1])
            stages.append(('bin', op.type, len(aux) - 1, swap))
            s = op.attrs.get('scale', None)
            if s not in (None, 1.0):
                stages.append(('postmul', float(s)))
        elif op.type == 'scale':
            stages.append(('scale', float(op.attrs.get('scale', 1.0)),
                           float(op.attrs.get('bias', 0.0)),
                           bool(op.attrs.get('bias_after_scale', True))))
        elif op.type in ACTS_P:
            params = []
            for attr, dflt in PARAM_ATTRS[op.type]:
                v = op.attrs.get(attr, dflt)
                if v is None:
                    return 'act-attr:%s' % op.type
                params.append(float(v))
            stages.append(('act_p', op.type, tuple(params)))
        elif op.type in ACTS:
            stages.append(('act', op.type))
        else:
            return 'stage:%s' % op.type
        cur = op.outputs['Out'][0]
    if len(stages) > ck.FUSED_CONV_MAX_STAGES or \
            len(aux) > ck.FUSED_CONV_MAX_AUX:
        return 'stages'

    # NHWC operands; a channels-last NCHW tensor (what this op returns)
    # is NHWC already, so its permute costs no copy
    x_nhwc = x.to(cdt).permute(0, 2, 3, 1).contiguous()
    w_k = _memo(ctx, ('w', cdt), [w], lambda: (
        w[:, 0].to(cdt).permute(1, 2, 0).contiguous() if depthwise  # KH KW C
        else w.to(cdt).permute(0, 2, 3, 1).contiguous()))        # O KH KW I
    y = _FUSED_CONV[0](x_nhwc, w_k, tuple(aux), tuple(kinds), tuple(stages),
                       strides, pads, depthwise)
    ctx.set_output('Out', y.permute(0, 3, 1, 2))
    return None


# the fused conv function the op calls; swapped only by conv_for_testing
_FUSED_CONV = [ck.fused_conv]


@contextlib.contextmanager
def conv_for_testing(fn=ck.fused_conv_reference):
    """Test-only: make the ``fused_conv`` op call ``fn`` (same signature
    as ``cuda_kernels.fused_conv``) instead of the kernel's wrapper, on
    every device. The default, the plain version, compares a whole
    program with and without the kernel on the same inputs; a
    deliberately wrong ``fn`` is a control that the comparison must
    catch."""
    prev = _FUSED_CONV[0]
    _FUSED_CONV[0] = fn
    try:
        yield
    finally:
        _FUSED_CONV[0] = prev


@register_kernel(FUSED_CONV_OP)
def _fused_conv_kernel(ctx):
    """Run a fused conv region as one fused conv call, or replay its
    captured ops exactly for a structural reason, counted in
    ``FALLBACKS``."""
    ops = _materialized_sub_ops(ctx)
    why = _lower_fused_conv(ctx, ops)
    if why is None:
        return
    FALLBACKS[why] = FALLBACKS.get(why, 0) + 1
    ctx.runner.run_ops(ops, ctx.env)


class ConvEpilogueFusion(object):
    """The ``conv_epilogue_fuse`` pass: merge conv2d/depthwise_conv2d ->
    batch_norm -> activation / residual-add chains into single
    ``fused_conv`` ops.

    Each link's output has exactly one reader anywhere in the program,
    that reader is a later epilogue-absorbable op in the global block,
    intermediates are neither protected nor persistable, and no
    interloper writes a name the region touches. A train-mode
    batch_norm rides along once, directly behind the conv, its
    moving-average and saved-stats outputs re-declared on the fused op
    ('Stats' slot); a test-mode batch_norm's extra outputs must be dead
    or persistable, since they vanish with the op. The fused op sits at
    the LAST member's position.

    Not bit-exact: the fused conv accumulates in f32 and applies the
    whole epilogue before one final cast (within 1e-5 of the unfused
    ops in f32, pinned by tests/test_torch_fused_conv.py)."""

    @staticmethod
    def _hazard(ops, cur, j, hazard):
        for k in range(cur + 1, j):
            if set(_op_writes(ops[k])) & hazard:
                return True
        return False

    def run(self, program, protected=frozenset()):
        """Rewrite ``program`` in place; ``protected`` names (the
        fetches) must stay producible."""
        block = program.global_block()
        ops = block.ops
        read_count = {}
        for b in program.blocks:
            for op in b.ops:
                for nm in list(op.input_arg_names) + _hidden_reads(op):
                    read_count[nm] = read_count.get(nm, 0) + 1
        global_reader = {}
        for j, op in enumerate(ops):
            for nm in op.input_arg_names:
                global_reader.setdefault(nm, []).append(j)

        def _dead_or_param(names):
            for nm in names:
                var = block._find_var_recursive(nm)
                if var is not None and var.persistable:
                    continue
                if read_count.get(nm, 0) or nm in protected:
                    return False
            return True

        used = set()
        regions = []          # (chain indices, stats names, final out)
        for i, op in enumerate(ops):
            if op.type not in _HEADS or i in used \
                    or _has_sub_block(op) \
                    or not _attrs_fusable(op.attrs) \
                    or len(op.outputs.get('Output', ())) != 1:
                continue
            chain = [i]
            hazard = set(_op_reads(op)) | set(_op_writes(op))
            cur = i
            cur_out = op.outputs['Output'][0]
            stats = None
            while True:
                if read_count.get(cur_out, 0) != 1 \
                        or cur_out in protected:
                    break
                var = block._find_var_recursive(cur_out)
                if var is not None and var.persistable:
                    break
                readers = global_reader.get(cur_out, [])
                if len(readers) != 1 or readers[0] <= cur:
                    break
                j = readers[0]
                nxt = ops[j]
                if nxt.type not in _EPILOGUE_OPS or j in used \
                        or _has_sub_block(nxt) \
                        or not _attrs_fusable(nxt.attrs):
                    break
                if nxt.type == 'batch_norm':
                    if nxt.inputs.get('X', [None])[0] != cur_out \
                            or len(nxt.outputs.get('Y', ())) != 1:
                        break
                    extra = [nxt.outputs[s][0]
                             for s in ('MeanOut', 'VarianceOut',
                                       'SavedMean', 'SavedVariance')
                             if nxt.outputs.get(s)]
                    if nxt.attrs.get('is_test', False):
                        if not _dead_or_param(extra):
                            break
                    else:
                        if stats is not None or len(extra) != 4:
                            break
                        stats = extra
                    nxt_out = nxt.outputs['Y'][0]
                else:
                    if list(nxt.outputs) != ['Out'] \
                            or len(nxt.outputs['Out']) != 1:
                        break
                    if cur_out not in (
                            nxt.inputs.get('X', [None])[0],
                            nxt.inputs.get('Y', [None])[0]):
                        break
                    nxt_out = nxt.outputs['Out'][0]
                if self._hazard(ops, cur, j, hazard):
                    break
                hazard |= set(_op_reads(nxt)) | set(_op_writes(nxt))
                chain.append(j)
                cur = j
                cur_out = nxt_out
            if len(chain) >= 2:
                used.update(chain)
                regions.append((chain, stats, cur_out))

        if not regions:
            return
        drop, insert_at = set(), {}
        for chain, stats, final_out in regions:
            members = [ops[k] for k in chain]
            ext_inputs, sub_ops = _capture_region(members)
            outputs = {'Out': [final_out]}
            if stats:
                outputs['Stats'] = stats
            fused = Operator(
                block, FUSED_CONV_OP, inputs={'X': ext_inputs},
                outputs=outputs,
                attrs={'sub_ops': sub_ops,
                       'fused_types': [m.type for m in members],
                       'fused_count': len(members)})
            insert_at[chain[-1]] = fused
            drop.update(chain)
        new_ops = []
        for k, op in enumerate(ops):
            if k in insert_at:
                new_ops.append(insert_at[k])
            elif k not in drop:
                new_ops.append(op)
        block.ops = new_ops
        program._bump_version()
