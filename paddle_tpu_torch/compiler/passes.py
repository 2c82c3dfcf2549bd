"""The canonical program-level passes.

Counterpart of paddle_tpu/compiler/passes.py. Pipeline order
(``default_pipeline``)::

    constant_fold -> dead_op_elim -> conv_epilogue_fuse ->
    elementwise_fuse -> buffer_reuse

plus ``bn_fold`` at the head for inference programs
(``inference_pipeline``). The passes rewrite the program as the JAX
package's do, op for op; what differs is how the port runs what they
make:

- ``constant_fold`` evaluates with the port's own kernels on the CPU and
  bakes the result into an ``assign_value`` op;
- ``fused_elementwise`` replays its captured ops in order through the
  block's runner (JAX replays them inside one named scope, which XLA
  fuses into one loop; here each op stays its own PyTorch call) and
  then drops the chain's interior values from the environment, as XLA's
  fusion never materialises them;
- ``fused_conv`` runs its region as ONE call of
  ``ops/cuda_kernels.py::fused_conv``: on the card the hand-written
  kernel (``csrc/fused_conv.cu``, conv plus the whole epilogue on chip,
  one store), on the CPU its plain version. A region with a train-mode
  batch norm calls the kernel's stats form (the conv and its per-channel
  moments) and normalises, updates the moving statistics and applies
  the later stages outside it, as the JAX package does. A region the
  kernel cannot take replays its captured ops exactly, and the reason is
  counted in ``FALLBACKS``. A kernel that fails to build or launch
  raises: no failure turns into a replay;
- ``buffer_reuse``'s ``__release__`` annotations drop each value from
  the eager environment after its last reader (``BlockRunner.run_ops``),
  so its memory is free for the rest of the run.

The exact passes give bit-identical outputs. ``bn_fold`` re-associates
the batch norm's affine into the conv/fc weights (<= 1e-5 drift), and
the fused conv accumulates in f32 and applies the whole epilogue before
one cast (within 1e-5 of the unfused ops in f32).
"""
import contextlib
import weakref

import numpy as np
import torch

from ..framework import (Block, Operator, _has_sub_block,  # noqa: F401
                         _hidden_reads, _op_reads, _op_writes)
from ..core.amp import amp_enabled, out_dtype
from ..core.lowering import BlockRunner, OpCtx, RNG_KEY
from ..core.registry import SIDE_EFFECT_OPS, get_kernel, register_kernel
from ..ops.collective_ops import batch_group, global_sums
from ..ops import cuda_kernels as ck
from ..ops.activations import ACTS, ACTS_P, BINS, PARAM_ATTRS
from ..ops.common import f32
from .pass_base import Pass, PassResult, register_pass

__all__ = ['DeadOpElimination', 'ConstantFolding', 'ElementwiseFusion',
           'ConvEpilogueFusion', 'BufferReuse', 'BatchNormFolding',
           'DEFAULT_PASSES', 'INFERENCE_PASSES', 'RNG_OPS',
           'FUSED_ELEMENTWISE_OP', 'FUSED_CONV_OP', 'FALLBACKS',
           'reset_fallback_counts', 'conv_for_testing']

FUSED_CONV_OP = 'fused_conv'
FUSED_ELEMENTWISE_OP = 'fused_elementwise'

# replay reason -> count since the last reset; a plain dict, bumped only
# where a fused_conv region replays its captured ops
FALLBACKS = {}


def reset_fallback_counts():
    FALLBACKS.clear()


# Ops that consume the scope's generator: removing one would shift the
# random stream of every later stochastic op, so dead-op elimination
# keeps them even when their outputs are dead.
RNG_OPS = frozenset({
    'dropout', 'gaussian_random', 'gaussian_random_batch_size_like',
    'truncated_gaussian_random', 'uniform_random',
    'uniform_random_batch_size_like', 'nce', 'sampling_id',
})

# Ops the dead-op pass must never drop regardless of liveness.
# feed/fetch, and the collectives: every rank of a data-parallel group
# must issue the same collectives in the same order, so no pass removes
# one
_ALWAYS_KEEP = frozenset({'feed', 'fetch', 'allreduce', 'broadcast',
                          'all_gather', 'reduce_scatter', 'ppermute',
                          'zero_reduce_scatter'})


# ---- helpers ---------------------------------------------------------------------
def _program_has_sub_blocks(program):
    return len(program.blocks) > 1 or any(
        _has_sub_block(op) for op in program.global_block().ops)


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
    member produced it; sub_ops is the replayable capture format shared
    by fused_elementwise and fused_conv."""
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


def _replay(ctx, ops):
    """Run a fused op's captured ops in order, then drop the values only
    the region read: by the fusion rules each interior value has exactly
    one reader, inside the region, and is neither protected nor
    persistable. A name the runner must keep stays."""
    ctx.runner.run_ops(ops, ctx.env)
    outs = set(ctx.op.output_arg_names)
    block = ctx.runner.block
    for op in ops:
        for nm in op.output_arg_names:
            if nm in outs or nm in ctx.runner.keep:
                continue
            var = block._find_var_recursive(nm)
            if var is None or not var.persistable:
                ctx.env.pop(nm, None)


# ---- dead ops ---------------------------------------------------------------------
@register_pass
class DeadOpElimination(Pass):
    """Remove global-block ops whose outputs reach neither a protected
    (fetch) name, a persistable var, nor a side-effecting/kept op.

    The executor's prune-before-run, generalized: it also runs on
    training programs, where it drops fetch-dead metric branches.
    Conservative keeps: side effects, sub-block carriers, random ops
    (stream stability), feed/fetch ops, persistable writers."""

    name = 'dead_op_elim'

    def _forced_keep(self, block, op):
        """Liveness aside, must this op survive? Side effects, feed/
        fetch, random-stream consumers, sub-block carriers, attr-only
        definers, persistable writers."""
        if (op.type in SIDE_EFFECT_OPS or op.type in _ALWAYS_KEEP
                or op.type in RNG_OPS or _has_sub_block(op)
                or not op.output_arg_names):
            return True
        for nm in op.output_arg_names:
            var = block._find_var_recursive(nm)
            if var is not None and var.persistable:
                return True
        return False

    def run(self, program, ctx):
        res = PassResult(self.name)
        if not ctx.protected:
            # no fetch information: every leaf could be the caller's
            # target, so there is nothing provably dead
            res.note = 'no protected names; skipped'
            return res
        block = program.global_block()
        ops = block.ops
        live = set(ctx.protected)
        keep = [False] * len(ops)
        for i in reversed(range(len(ops))):
            op = ops[i]
            forced = self._forced_keep(block, op)
            if forced or any(nm in live for nm in op.output_arg_names):
                keep[i] = True
                live.update(_op_reads(op))
                live.update(_hidden_reads(op))
        removed = keep.count(False)
        if removed:
            block.ops = [op for i, op in enumerate(ops) if keep[i]]
            program._bump_version()
        res.changed = bool(removed)
        res.ops_removed = removed
        return res


# ---- constants --------------------------------------------------------------------
# Pure, deterministic, dense-safe op types constant folding may evaluate
# at pass time. Random ops are excluded by construction (and would fail
# the evaluation anyway: the fold environment has no generator). An op
# without a kernel in the port fails its evaluation and stays.
_FOLDABLE = frozenset({
    'elementwise_add', 'elementwise_sub', 'elementwise_mul',
    'elementwise_div', 'elementwise_max', 'elementwise_min',
    'elementwise_pow', 'scale', 'cast', 'concat', 'sum', 'minus',
    'square', 'sqrt', 'exp', 'log', 'abs', 'relu', 'tanh', 'sigmoid',
    'softmax', 'transpose', 'reverse', 'clip', 'pow', 'mean',
    'fill_zeros_like', 'assign', 'one_hot', 'ceil', 'floor', 'round',
    'reciprocal', 'softplus', 'softsign', 'reshape', 'split',
})

_CONST_PRODUCERS = frozenset({'fill_constant', 'assign_value'})

# Don't bake arrays bigger than this into the program.
_MAX_FOLD_ELEMS = 1 << 16

_CPU = torch.device('cpu')


@register_pass
class ConstantFolding(Pass):
    """Evaluate compile-time-constant subgraphs once, at pass time.

    Op outputs reachable only from ``fill_constant``/``assign_value``
    producers are computed by running the port's kernels on the CPU;
    consumers outside the constant region read a baked ``assign_value``
    instead. Interior ops of the folded region are dropped here; the
    orphaned producers fall to the following dead-op pass."""

    name = 'constant_fold'

    def run(self, program, ctx):
        res = PassResult(self.name)
        block = program.global_block()
        ops = block.ops
        const_env = {}     # name -> (np value, producer idx, foldable?)
        folded = set()     # indices of evaluated FOLDABLE ops
        need_mat = {}      # producer idx -> set(names to materialize)

        def _note_reads(op):
            for nm in list(_op_reads(op)) + _hidden_reads(op):
                hit = const_env.get(nm)
                if hit is not None and hit[2]:
                    need_mat.setdefault(hit[1], set()).add(nm)

        for i, op in enumerate(ops):
            if op.type in _CONST_PRODUCERS and not _has_sub_block(op):
                vals = self._eval(block, op, const_env)
                if vals is not None:
                    for nm, v in vals.items():
                        const_env[nm] = (v, i, False)
                    continue
            writes_persistable = False
            for nm in op.output_arg_names:
                var = block._find_var_recursive(nm)
                if var is not None and var.persistable:
                    writes_persistable = True
            if (op.type in _FOLDABLE and not _has_sub_block(op)
                    and not writes_persistable and op.input_arg_names
                    and all(n in const_env
                            for n in op.input_arg_names)):
                vals = self._eval(block, op, const_env)
                if vals is not None:
                    for nm, v in vals.items():
                        const_env[nm] = (v, i, True)
                    folded.add(i)
                    continue
            # not folded: its reads of constants must materialize, and
            # its writes (incl. nested) shadow any same-named constant
            _note_reads(op)
            for nm in _op_writes(op):
                const_env.pop(nm, None)
        for nm in ctx.protected:
            hit = const_env.get(nm)
            if hit is not None and hit[2]:
                need_mat.setdefault(hit[1], set()).add(nm)

        if not folded:
            return res
        new_ops = []
        for i, op in enumerate(ops):
            if i not in folded:
                new_ops.append(op)
                continue
            for nm in sorted(need_mat.get(i, ())):
                val = const_env[nm][0]
                new_ops.append(Operator(
                    block, 'assign_value', inputs={},
                    outputs={'Out': [nm]},
                    attrs={'shape': list(val.shape),
                           'dtype': str(val.dtype),
                           'values': val}))
        res.ops_folded = len(folded)
        res.ops_removed = len(ops) - len(new_ops)
        res.changed = True
        block.ops = new_ops
        program._bump_version()
        return res

    @staticmethod
    def _eval(block, op, const_env):
        """Run ``op``'s kernel on concrete values on the CPU; None on any
        failure (no kernel, unexpected structure, too big)."""
        try:
            env = {n: torch.as_tensor(np.asarray(const_env[n][0]))
                   for n in op.input_arg_names}
            with torch.no_grad():
                get_kernel(op.type)(OpCtx(op, env, BlockRunner(block,
                                                               _CPU)))
            out = {}
            for nm in op.output_arg_names:
                if nm not in env:
                    return None
                v = env[nm].numpy()
                if v.size > _MAX_FOLD_ELEMS:
                    return None
                out[nm] = v
            return out
        except Exception:
            return None


# ---- elementwise chains -----------------------------------------------------------
# Pure elementwise/activation op types: no randomness, no reductions over
# the batch, no sequence re-shaping: a chain of these replayed in order
# is the exact computation of the original ops.
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


@register_kernel(FUSED_ELEMENTWISE_OP)
def _fused_elementwise_kernel(ctx):
    """Run one fused region: its captured ops in order, then its interior
    values dropped. Gradients flow through the replay exactly as through
    the original ops. One kernel for the region is ROADMAP Queue B's
    second part, item 3 (the eager passes around the kernels)."""
    _replay(ctx, _materialized_sub_ops(ctx))


@register_pass
class ElementwiseFusion(Pass):
    """Merge single-consumer chains of pure elementwise/activation ops
    into one ``fused_elementwise`` op.

    Chain link rule: op_i's ``Out`` is read by exactly ONE op anywhere
    in the program, that reader is a later elementwise op in the global
    block, and the intermediate is neither protected, persistable, nor
    hazarded (no op between the members writes a name the members read
    or write). The fused op sits at the LAST member's position: every
    external input is already produced there, and no dropped
    intermediate had any other reader.

    A chain whose head reads the sole-read output of an earlier
    ``fused_conv`` is absorbed into that conv's region instead, where
    the fused conv applies it as more epilogue stages."""

    name = 'elementwise_fuse'

    def _extension_hazard(self, ops, cur, j, hazard):
        """WAR/WAW hazard: an interloper between chain tail ``cur`` and
        candidate ``j`` writing anything the chain touches would
        see/change the wrong value once the members move to j's
        position."""
        for k in range(cur + 1, j):
            if set(_op_writes(ops[k])) & hazard:
                return True
        return False

    def run(self, program, ctx):
        res = PassResult(self.name)
        block = program.global_block()
        ops = block.ops
        # readers across ALL blocks (a sub-block read makes an
        # intermediate external, breaking the chain)
        read_count = {}
        for b in program.blocks:
            for op in b.ops:
                for nm in list(op.input_arg_names) + _hidden_reads(op):
                    read_count[nm] = read_count.get(nm, 0) + 1
        global_reader = {}
        for j, op in enumerate(ops):
            for nm in op.input_arg_names:
                global_reader.setdefault(nm, []).append(j)
        # fused_conv producers (conv_epilogue_fuse runs just before this
        # pass): Out name -> index, for absorbing elementwise chains
        # across the conv boundary into the epilogue
        fc_out = {}
        for j, op in enumerate(ops):
            if op.type == FUSED_CONV_OP and 'Out' in op.outputs:
                fc_out[op.outputs['Out'][0]] = j

        def _sole_out(op):
            outs = op.output_arg_names
            if len(outs) != 1 or list(op.outputs) != ['Out']:
                return None
            return outs[0]

        used = set()
        chains = []
        for i, op in enumerate(ops):
            if i in used or op.type not in _ELEMENTWISE \
                    or not _attrs_fusable(op.attrs):
                continue
            chain = [i]
            hazard = set(_op_reads(op)) | set(_op_writes(op))
            cur = i
            while True:
                out = _sole_out(ops[cur])
                if out is None or read_count.get(out, 0) != 1:
                    break
                readers = global_reader.get(out, [])
                if len(readers) != 1 or readers[0] <= cur:
                    break
                j = readers[0]
                nxt = ops[j]
                if nxt.type not in _ELEMENTWISE or j in used \
                        or not _attrs_fusable(nxt.attrs):
                    break
                if out in ctx.protected:
                    break
                var = block._find_var_recursive(out)
                if var is not None and var.persistable:
                    break
                if self._extension_hazard(ops, cur, j, hazard):
                    break
                hazard |= set(_op_reads(nxt)) | set(_op_writes(nxt))
                chain.append(j)
                cur = j
            if len(chain) >= 2:
                chains.append(chain)
                used.update(chain)
            elif any(nm in fc_out for nm in op.input_arg_names):
                # a lone elementwise op behind a fused_conv is still
                # worth absorbing into that conv's epilogue
                chains.append(chain)

        if not chains:
            return res
        drop, insert_at = set(), {}

        def _absorb_into_conv(chain, members):
            """Cross-conv-boundary absorption: when the chain's head
            consumes the sole-read output of an earlier ``fused_conv``,
            fold the whole chain into that conv's epilogue region
            instead of emitting a separate fused_elementwise. Returns
            True when absorbed."""
            head = members[0]
            for nm in head.input_arg_names:
                p = fc_out.get(nm)
                if p is None or p >= chain[0] or p in drop:
                    continue
                fc = ops[p]
                if read_count.get(nm, 0) != 1 or nm in ctx.protected:
                    continue
                var = block._find_var_recursive(nm)
                if var is not None and var.persistable:
                    continue
                # the conv op MOVES to the chain tail: its other
                # outputs (train-BN stats) must have no reader at or
                # before the new position, and no hidden/sub-block
                # reads we cannot place
                ok = True
                for out_nm in fc.output_arg_names:
                    if out_nm == nm:
                        continue
                    own = sum(1 for nm2 in fc.input_arg_names
                              if nm2 == out_nm)
                    gl = [j for j in global_reader.get(out_nm, ())
                          if j != p]
                    if read_count.get(out_nm, 0) - own != len(gl) or \
                            any(j <= chain[-1] for j in gl):
                        ok = False
                        break
                if not ok:
                    continue
                # interlopers between the conv and the chain tail must
                # not write anything the moved region reads or writes
                hz = set(_op_reads(fc)) | set(_op_writes(fc))
                for m in members:
                    hz |= set(_op_reads(m)) | set(_op_writes(m))
                in_chain = set(chain)
                for k in range(p + 1, chain[-1]):
                    if k in in_chain:
                        continue
                    if set(_op_writes(ops[k])) & hz:
                        ok = False
                        break
                if not ok:
                    continue
                chain_ext, chain_sub = _capture_region(members)
                produced = set(fc.output_arg_names)
                new_ext = list(fc.inputs.get('X', ()))
                for enm in chain_ext:
                    if enm not in produced and enm not in new_ext:
                        new_ext.append(enm)
                outputs = {'Out': [members[-1].outputs['Out'][0]]}
                if 'Stats' in fc.outputs:
                    outputs['Stats'] = list(fc.outputs['Stats'])
                merged = Operator(
                    block, FUSED_CONV_OP,
                    inputs={'X': new_ext}, outputs=outputs,
                    attrs={'sub_ops': list(fc.attrs['sub_ops'])
                           + chain_sub,
                           'fused_types': list(fc.attrs['fused_types'])
                           + [m.type for m in members],
                           'fused_count': fc.attrs['fused_count']
                           + len(members)})
                insert_at[chain[-1]] = merged
                drop.update(chain)
                drop.add(p)
                res.ops_fused += len(members)
                return True
            return False

        for chain in chains:
            members = [ops[k] for k in chain]
            if _absorb_into_conv(chain, members):
                continue
            if len(chain) < 2:
                continue
            ext_inputs, sub_ops = _capture_region(members)
            final_out = members[-1].outputs['Out'][0]
            fused = Operator(
                block, FUSED_ELEMENTWISE_OP,
                inputs={'X': ext_inputs},
                outputs={'Out': [final_out]},
                attrs={'sub_ops': sub_ops,
                       'fused_types': [m.type for m in members],
                       'fused_count': len(members)})
            insert_at[chain[-1]] = fused
            drop.update(chain)
            res.ops_fused += len(members)
        if not insert_at:
            return res
        new_ops = []
        for k, op in enumerate(ops):
            if k in insert_at:
                new_ops.append(insert_at[k])
            elif k not in drop:
                new_ops.append(op)
        block.ops = new_ops
        program._bump_version()
        res.changed = True
        res.ops_removed = len(ops) - len(new_ops)
        return res


# ---- fused conv + epilogue ---------------------------------------------------------
# Epilogue op types conv_epilogue_fuse may absorb behind a conv: batch
# norm plus every pure elementwise/activation op
_EPILOGUE_OPS = _ELEMENTWISE | {'batch_norm'}
_HEADS = ('conv2d', 'depthwise_conv2d')


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
    train_bn = pre_bias = None
    cur = conv.outputs['Output'][0]
    for op in ops[1:]:
        if op.type not in BINS and op.inputs.get('X', [None])[0] != cur:
            return 'chain-slot'
        if op.type == 'batch_norm':
            if op.attrs.get('data_layout', 'NCHW') != 'NCHW':
                return 'bn-layout'
            if not op.attrs.get('is_test', False):
                # batch moments need the whole conv output, so the batch
                # norm sits directly on the conv, or behind the conv's
                # per-channel bias (layers.conv2d's bias add, VGG's
                # regions), which shifts the batch mean and nothing
                # else: the kernel's stats form gives the conv's
                # moments, and the normalisation and every later stage
                # run on its output here
                behind_bias = stages == [('bin', 'elementwise_add', 0,
                                          False)] and kinds == ['c']
                if train_bn is not None or not (op is ops[1] or
                                                behind_bias):
                    return 'train-bn-order'
                if not amp and x.dtype != torch.float32:
                    return 'train-bn-dtype'
                train_bn = op
                if behind_bias:
                    pre_bias = aux[0].reshape(-1)
                    stages, aux, kinds = [], [], []
                cur = op.outputs['Y'][0]
                continue
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
    if train_bn is None:
        y = _FUSED_CONV[0](x_nhwc, w_k, tuple(aux), tuple(kinds),
                           tuple(stages), strides, pads, depthwise)
        # under AMP with f32 activations the bf16 result is cast back
        # after the kernel, as the unfused conv2d op's
        ctx.set_output('Out', y.to(out_dtype(y.device, y.dtype))
                       .permute(0, 3, 1, 2))
        return None
    _train_bn_region(ctx, train_bn, x_nhwc, w_k, aux, kinds, stages,
                     strides, pads, depthwise, cdt, pre_bias)
    return None


def _train_bn_region(ctx, bn, x_nhwc, w_k, aux, kinds, stages, strides,
                     pads, depthwise, cdt, pre_bias=None):
    """A region whose batch norm is in train mode (JAX passes.py:748-793):
    the stats form gives the conv output and its per-channel sum and sum
    of squares; the batch moments are E[y] and max(E[y^2] - E[y]^2, 0) in
    f32 over N * Ho * Wo pixels; y is normalised with them and the
    batch norm's Scale and Bias in f32, the later stages follow, and one
    cast to the region's dtype. The moving averages (MeanOut,
    VarianceOut, no gradient) and the batch moments (SavedMean,
    SavedVariance) go to the op's Stats outputs. ``pre_bias`` [C], the
    conv's bias where it sits between the conv and the batch norm, moves
    the batch mean by itself and leaves the variance and the normalised
    output as they are, so it enters the mean's outputs only (and its
    gradient through the normalisation is zero). Under data parallelism
    (the op marked ``dp_global``) the sums and the count are the global
    batch's."""
    y, psum, psumsq = _FUSED_CONV[0](x_nhwc, w_k, (), (), (), strides, pads,
                                     depthwise, emit_stats=True)
    count = float(y.shape[0] * y.shape[1] * y.shape[2])
    group = batch_group(ctx)
    if group is not None:
        # data parallelism: the moments of the global batch, from the
        # ranks' per-channel sums summed in one collective whose backward
        # sums the ranks' g_sum / g_sumsq for the stats form's backward
        psum, psumsq = global_sums(group, psum, psumsq)
        count *= group.size
    bmean = psum / count
    bvar = torch.clamp(psumsq / count - bmean * bmean, min=0.0)
    scale, bias, mean, var = (ctx.env[bn.inputs[s][0]] for s in
                              ('Scale', 'Bias', 'Mean', 'Variance'))
    momentum = float(bn.attrs.get('momentum', 0.9))
    eps = float(bn.attrs.get('epsilon', 1e-5))
    inv = torch.rsqrt(bvar + eps)
    yn = (f32(y) - bmean) * inv * scale + bias     # NHWC: C is last
    fetch_aux = ck.aux_fetcher(aux, kinds)
    for st in stages:
        yn = ck.apply_stage(yn, st, fetch_aux)
    ctx.set_output('Out', yn.to(out_dtype(yn.device, cdt))
                   .permute(0, 3, 1, 2))
    if pre_bias is not None:
        bmean = bmean + pre_bias
    ctx.set_output('Stats', (mean * momentum + bmean * (1.0 - momentum))
                   .detach(), 0)
    ctx.set_output('Stats', (var * momentum + bvar * (1.0 - momentum))
                   .detach(), 1)
    ctx.set_output('Stats', bmean, 2)
    ctx.set_output('Stats', bvar, 3)


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
    _replay(ctx, ops)


@register_pass
class ConvEpilogueFusion(Pass):
    """Merge conv2d/depthwise_conv2d -> batch_norm -> activation /
    residual-add chains into single ``fused_conv`` ops.

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

    name = 'conv_epilogue_fuse'
    preserves_semantics = False

    @staticmethod
    def _hazard(ops, cur, j, hazard):
        for k in range(cur + 1, j):
            if set(_op_writes(ops[k])) & hazard:
                return True
        return False

    def run(self, program, ctx):
        res = PassResult(self.name)
        protected = ctx.protected
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
            return res
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
            res.ops_fused += len(members)
        new_ops = []
        for k, op in enumerate(ops):
            if k in insert_at:
                new_ops.append(insert_at[k])
            elif k not in drop:
                new_ops.append(op)
        block.ops = new_ops
        program._bump_version()
        res.changed = True
        res.ops_removed = len(ops) - len(new_ops)
        return res


# ---- buffer release ---------------------------------------------------------------
@register_pass
class BufferReuse(Pass):
    """Liveness-based buffer-release annotations the lowering honours.

    For every non-persistable name, find its LAST reader in the global
    block and annotate that op with ``__release__``, so
    ``BlockRunner.run_ops`` drops the environment's reference once the
    op completes: the value's memory is free for the rest of the run
    instead of living to the end of the block (the eager counterpart of
    the reference ``memory_optimization_transpiler``'s reuse). Fetch,
    persistable-state and loss names are also guarded at run time
    (``BlockRunner.keep``), so an annotation never starves a fetch the
    pass did not know about."""

    name = 'buffer_reuse'

    def run(self, program, ctx):
        res = PassResult(self.name)
        if _program_has_sub_blocks(program):
            # control-flow bodies re-read parent names per iteration;
            # a static last-read index over the flat op list would lie
            res.note = 'sub-blocks present; skipped'
            return res
        if any(op.type == 'gradient_marker'
               for op in program.global_block().ops):
            # calc_gradient's marker replays earlier ops from the
            # environment: names a static liveness would call dead are
            # still read by the replay
            res.note = 'gradient_marker present; skipped'
            return res
        block = program.global_block()
        ops = block.ops
        last_read = {}
        for i, op in enumerate(ops):
            for nm in list(_op_reads(op)) + _hidden_reads(op):
                last_read[nm] = i
        skip = set(ctx.protected) | {RNG_KEY}
        releases = {}
        for nm, i in last_read.items():
            if nm in skip or nm in _op_writes(ops[i]):
                continue
            var = block._find_var_recursive(nm)
            if var is not None and var.persistable:
                continue
            releases.setdefault(i, []).append(nm)
        changed = 0
        for i, op in enumerate(ops):
            want = tuple(sorted(releases.get(i, ())))
            have = tuple(op.attrs.get('__release__', ()))
            if want != have:
                if want:
                    op.attrs['__release__'] = want
                else:
                    op.attrs.pop('__release__', None)
                changed += 1
            res.vars_released += len(want)
        if changed:
            program._bump_version()
        res.changed = bool(changed)
        return res


# ---- batch-norm folding -----------------------------------------------------------
@register_pass
class BatchNormFolding(Pass):
    """Inference BN folding into the preceding conv/fc weights.

    Parity: inference_transpiler.py::_fuse_conv_bn / _fuse_param. For
    every ``conv2d``/``depthwise_conv2d``/``mul`` whose single consumer
    is a ``batch_norm`` and whose weights are resident in the scope::

        w' = w * scale / sqrt(var + eps)          (per output channel)
        b' = bias - mean * scale / sqrt(var + eps)

    the BN op is REMOVED and an ``elementwise_add(axis=1)`` with the
    folded bias takes over BN's output name. Remaining BN/dropout ops
    flip to test mode. The folded weights replace the old ones in the
    scope, on their device and in their dtype, computed in f32. Not
    bit-exact: the re-associated affine drifts <= 1e-5."""

    name = 'bn_fold'
    preserves_semantics = False
    writes_scope = True

    def run(self, program, ctx):
        res = PassResult(self.name)
        scope = ctx.scope
        if scope is None:
            from ..executor import global_scope
            scope = global_scope()
        res.ops_folded = self._fuse_bn(program, scope)
        res.changed = bool(res.ops_folded)
        if self._mark_test_mode(program):
            res.changed = True
        return res

    @staticmethod
    def _consumers(program, name):
        return [op for b in program.blocks for op in b.ops
                if name in op.input_arg_names]

    def _fuse_bn(self, program, scope):
        block = program.global_block()
        # a weight with ANY other consumer cannot be rewritten in
        # place: each use would need its own scaled copy
        weight_uses = {}
        for b in program.blocks:
            for op in b.ops:
                for name in op.input_arg_names:
                    weight_uses[name] = weight_uses.get(name, 0) + 1
        folded = 0
        i = 0
        while i < len(block.ops):
            op = block.ops[i]
            if op.type in ('conv2d', 'depthwise_conv2d'):
                out_slot, w_slot = 'Output', 'Filter'
            elif op.type == 'mul':
                out_slot, w_slot = 'Out', 'Y'
            else:
                i += 1
                continue
            out_name = op.outputs[out_slot][0]
            consumers = self._consumers(program, out_name)
            if len(consumers) != 1 or consumers[0].type != 'batch_norm':
                i += 1
                continue
            bn = consumers[0]
            w_name = op.inputs[w_slot][0]
            w_var = block._find_var_recursive(w_name)
            if weight_uses.get(w_name, 0) > 1 or w_var is None \
                    or not getattr(w_var, 'persistable', False):
                i += 1
                continue
            vals, ok = {}, True
            for slot in ('Scale', 'Bias', 'Mean', 'Variance'):
                v = scope.raw(bn.inputs[slot][0])
                if v is None:
                    ok = False
                    break
                vals[slot] = torch.as_tensor(v).detach().float()
            w_val = scope.raw(w_name)
            if not ok or w_val is None:
                i += 1
                continue
            w_val = torch.as_tensor(w_val).detach()
            w32 = w_val.float()
            eps = float(bn.attrs.get('epsilon', 1e-5))
            alpha = vals['Scale'] / torch.sqrt(vals['Variance'] + eps)
            if op.type == 'mul':
                if w32.dim() != 2 or w32.shape[1] != alpha.shape[0]:
                    i += 1
                    continue
                new_w = w32 * alpha[None, :]
            else:
                new_w = w32 * alpha[:, None, None, None]
            new_b = vals['Bias'] - vals['Mean'] * alpha

            bias_var = block.create_var(
                name=w_name + '.bn_fold_bias', shape=list(new_b.shape),
                dtype='float32', persistable=True)
            scope.set_var(w_name, new_w.to(w_val.dtype))
            scope.set_var(bias_var.name, new_b)

            bn_idx = block.ops.index(bn)
            bn_out = bn.outputs['Y'][0]
            block.remove_op(bn_idx)
            block.insert_op(bn_idx, type='elementwise_add',
                            inputs={'X': [out_name],
                                    'Y': [bias_var.name]},
                            outputs={'Out': [bn_out]},
                            attrs={'axis': 1})
            folded += 1
            i += 1
        if folded:
            program._bump_version()
        return folded

    @staticmethod
    def _mark_test_mode(program):
        changed = False
        for block in program.blocks:
            for op in block.ops:
                if op.type in ('batch_norm', 'dropout') and \
                        op.attrs.get('is_test') is not True:
                    op.attrs['is_test'] = True
                    changed = True
        if changed:
            program._bump_version()
        return changed


# The canonical pipelines, as paddle_tpu/compiler/passes.py:1181-1183
# (see __init__.py for the config surface). conv_epilogue_fuse runs
# right before elementwise_fuse so the latter can absorb leftover
# elementwise chains into the conv epilogues.
DEFAULT_PASSES = ('constant_fold', 'dead_op_elim', 'conv_epilogue_fuse',
                  'elementwise_fuse', 'buffer_reuse')
INFERENCE_PASSES = ('bn_fold',) + DEFAULT_PASSES
