"""Lowering: run a Program block op by op on torch tensors.

Counterpart of paddle_tpu/core/lowering.py (``OpCtx``,
``BlockRunner.run_ops``, ``runtime_dtype``, ``_merge_shared_muls`` and
``lower_block`` with its training branch). The JAX package traces the
whole block into one jitted XLA computation; PyTorch runs eagerly, so
here the "lowered" function simply executes each op's kernel in program
order on the Executor's device.

Sub-blocks (the bodies of While, the conditional blocks of IfElse and
Switch, StaticRNN and DynamicRNN) run through ``BlockRunner.sub_runner``
inside their op's kernel (ops/control_flow_ops.py), with the same
device, gradient mode and ``dynamic`` flag; the scope's generator is one
object that every random op in every body advances in program order.

A training program holds one ``backward_marker``: the ops before it run
under ``torch.autograd`` with each parameter as a fresh leaf, the summed
loss is differentiated with ``torch.autograd.grad`` (the counterpart of
``jax.value_and_grad``), the gradients are bound to ``<param>@GRAD``, and
the ops after it (clips, regularizers, optimizer updates) run without
autograd. A program without a marker runs entirely under
``torch.no_grad()``. A sparse table (``embedding(is_sparse=True)``)
is not a leaf: each of its lookups adds a zero carrier leaf to its
gathered rows, and the table's gradient is the carriers' gradients with
their ids, a ``SparseRows``.

``A program marked by ``memory_optimize`` (``remat``) runs its training
forward as about sqrt(N) segments, each under
``torch.utils.checkpoint.checkpoint(use_reentrant=False)``: autograd
keeps only each segment's inputs and recomputes the rest in the
backward (``_run_remat_segments``, the counterpart of the JAX package's
``_run_remat_segments``).

With the debug-mode NaN/Inf guard on (``debugging.check_nan_inf``),
``run_ops`` tests every float output of every op with ``isfinite`` and
raises ``FloatingPointError`` naming the op, the output and the inputs.

``calc_gradient`` plants a ``gradient_marker``: its kernel replays the
ops between its inputs and its targets with the inputs as fresh nodes,
under autograd wherever it runs (a training forward, an update, a
served program), and its gradients stay differentiable, so a later
marker or the backward marker differentiates through them.

While the profiler is on (``profiler.start_profiler``), a block's
top-level runner times each op with a device sync after it into the
profiler's op table, and a training region (the forward under autograd
and its gradient) is one ``fwd_bwd(value_and_grad)`` event, as in the
JAX lowering: no op inside it, and no op of a sub-block, adds an event.
"""
import contextlib
import math
import time

import torch
import torch.utils.checkpoint

from .registry import get_kernel, register_kernel
from .. import profiler as _prof
from ..observability import perf as _perf
from ..debugging import NanInfError, nan_checks_enabled
from ..framework import (Operator, _hidden_reads, _op_reads, _op_writes,
                         convert_np_dtype)
from ..lod import SequenceTensor
from ..ops.common import rewrap

RNG_KEY = '__rng__'


class SparseRows(object):
    """A row-sparse gradient, the counterpart of the JAX package's
    ``SparseRows`` (the reference's SelectedRows as a gradient carrier).
    ``items``: one (rows [.., D], ids [..]) pair per lookup of the
    table; duplicate ids are not merged here (SGD's ``index_add_``
    sums them; Adagrad and Adam merge them across all lookups,
    ops/optim_ops.py::_merge_rows)."""

    __slots__ = ('items', 'vocab')

    def __init__(self, items, vocab):
        self.items = items
        self.vocab = vocab

    def __repr__(self):
        return 'SparseRows(%d lookups, vocab=%d)' % (len(self.items),
                                                     self.vocab)
# the scope's host generator, drawn from by force_cpu random ops on every
# device, so their values do not depend on the device
RNG_CPU_KEY = '__rng_cpu__'

# The port's runtime dtype map. JAX runs without x64 and maps int64 to
# int32; torch indexes with int64, so the port keeps int64 ids as they
# are and only narrows float64, which the card has no fast path for.
_RUNTIME_DTYPE = {'float64': 'float32'}

_TORCH_DTYPE = {
    'float16': torch.float16, 'bfloat16': torch.bfloat16,
    'float32': torch.float32, 'int8': torch.int8, 'int16': torch.int16,
    'int32': torch.int32, 'int64': torch.int64, 'uint8': torch.uint8,
    'bool': torch.bool,
}


def runtime_dtype(dtype):
    d = convert_np_dtype(dtype)
    return _RUNTIME_DTYPE.get(d, d)


def torch_dtype(dtype):
    """The torch dtype a value declared ``dtype`` is held in at run time."""
    d = runtime_dtype(dtype)
    try:
        return _TORCH_DTYPE[d]
    except KeyError:
        raise TypeError("paddle_tpu_torch has no runtime dtype for %r"
                        % (dtype,)) from None


class OpCtx(object):
    """Kernel-facing view of one op while its block runs."""

    __slots__ = ('op', 'env', 'runner')

    def __init__(self, op, env, runner):
        self.op = op
        self.env = env
        self.runner = runner

    # ---- inputs -----------------------------------------------------------------
    def input(self, slot, idx=0):
        names = self.op.inputs.get(slot) or []
        if not names:
            return None
        return self.env[names[idx]]

    def inputs(self, slot):
        return [self.env[n] for n in self.op.inputs.get(slot, [])]

    def has_input(self, slot):
        return bool(self.op.inputs.get(slot))

    # ---- outputs ----------------------------------------------------------------
    def set_output(self, slot, val, idx=0):
        self.env[self.op.outputs[slot][idx]] = val

    def output_names(self, slot):
        return self.op.outputs.get(slot, [])

    # ---- attrs / misc -----------------------------------------------------------
    def attr(self, name, default=None):
        return self.op.attrs.get(name, default)

    @property
    def device(self):
        return self.runner.device

    def generator(self):
        """The scope's ``torch.Generator`` (counterpart of the JAX
        package's ``next_rng``): each random op advances it in program
        order."""
        return self.env[RNG_KEY]


class _ClipCotangent(torch.autograd.Function):
    """Identity whose cotangent is clipped to [lo, hi]: the counterpart
    of the JAX package's ``_clip_cotangent``, i.e. the reference's error
    clip on ``<var>@GRAD`` (``clip.ErrorClipByValue``)."""

    @staticmethod
    def forward(ctx, x, lo, hi):
        ctx.lo, ctx.hi = lo, hi
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return torch.clamp(g, ctx.lo, ctx.hi), None, None


class BlockRunner(object):
    """Executes a Block's op list into an environment of torch tensors
    on ``device``. With ``grad_mode`` (the ops before a backward marker)
    it applies the variables' gradient attributes as each output is
    produced: ``stop_gradient`` detaches it, and an ``error_clip`` clips
    the cotangent that flows back through it.

    ``keep`` guards the compiler's liveness annotations: the
    buffer_reuse pass marks each op with the names whose LAST reader it
    is (``__release__`` attr), and run_ops drops those environment
    references once the op completes, so their memory is free for the
    rest of the run, unless the name is in ``keep`` (fetches,
    persistable state, the generator, the loss), which the pass could
    not know statically.

    ``dynamic`` marks a dynamic program (``executor._is_dynamic_program``:
    a beam-search While fed 2-level LoD): kernels keep packed rows and
    tensor arrays of SequenceTensors as they are, as the JAX package's
    eager dynamic mode does."""

    def __init__(self, block, device, grad_mode=False, keep=None,
                 dynamic=False, profile=False):
        self.block = block
        self.device = device
        self.grad_mode = grad_mode
        self.keep = keep if keep is not None else frozenset()
        self.dynamic = dynamic
        # a top-level runner outside a training region: its ops go into
        # the profiler's table while profiling is on
        self.profile = profile

    def sub_runner(self, block):
        """The runner of a sub-block of this one's ops."""
        return BlockRunner(block, self.device, grad_mode=self.grad_mode,
                           keep=self.keep, dynamic=self.dynamic)

    def run_ops(self, ops, env):
        guard = nan_checks_enabled()
        profiling = self.profile and _prof.op_profiling_enabled()
        count = _perf.OP_HOOK[0]     # a perf capture's op counter
        if profiling:
            _device_sync(self.device)
        for op in ops:
            kernel = get_kernel(op.type)
            t0 = time.perf_counter() if profiling else 0.0
            try:
                kernel(OpCtx(op, env, self))
            except NanInfError:
                raise
            except Exception as e:
                raise type(e)(
                    "while running op %r (%s -> %s): %s" %
                    (op.type, op.inputs, op.outputs, e)) from e
            if profiling:
                _device_sync(self.device)
                _prof.record_op_event(op.type, time.perf_counter() - t0,
                                      start=t0)
            if guard:
                _check_outputs(op, env)
            if count is not None:
                count(op, env, self.grad_mode)
            if self.grad_mode:
                self._apply_grad_attrs(op, env)
            for name in op.attrs.get('__release__', ()):
                if name not in self.keep:
                    env.pop(name, None)
        return env

    def _apply_grad_attrs(self, op, env):
        for name in op.output_arg_names:
            var = self.block._find_var_recursive(name)
            val = env.get(name)
            seq = val if isinstance(val, SequenceTensor) else None
            if seq is not None:
                val = seq.data
            if var is None or not isinstance(val, torch.Tensor) or \
                    not val.is_floating_point():
                continue
            if var.stop_gradient:
                val = val.detach()
            eclip = getattr(var, 'error_clip', None)
            if eclip is not None and val.requires_grad:
                val = _ClipCotangent.apply(val, float(eclip.min),
                                           float(eclip.max))
            env[name] = val if seq is None else rewrap(seq, val)


def _device_sync(device):
    if device.type == 'cuda':
        torch.cuda.synchronize(device)


def _float_leaves(val):
    if isinstance(val, SequenceTensor):
        val = val.data
    if isinstance(val, torch.Tensor):
        return [val] if val.is_floating_point() else []
    if isinstance(val, (list, tuple)):
        return [t for v in val for t in _float_leaves(v)]
    return []


def _check_outputs(op, env):
    """The debug-mode NaN/Inf guard after one op: each float output is
    tested on its device and read once by the host. The message is the
    JAX package's checkify message."""
    for name in op.output_arg_names:
        if name not in env:
            continue
        for t in _float_leaves(env[name]):
            if not bool(torch.isfinite(t.detach()).all()):
                raise NanInfError(
                    "NaN/Inf detected in output '%s' of op '%s' "
                    "(inputs: %s)" % (name, op.type,
                                      sorted(op.input_arg_names)))


# Graph rewrite: merge same-input mul (fc) ops into one wide matmul.
# Off by default, as in the JAX package; the flag and the rewrite are
# kept identical so both packages fuse the q/k/v projections alike.
MERGE_SHARED_MULS = [False]


def _merge_shared_muls(block, ops):
    """Rewrite groups of ``mul`` ops sharing the same X (the q/k/v
    projections of an attention layer) into concat(weights) -> one mul
    -> split.

    Conservative scope: 2-D persistable weights, y_num_col_dims == 1,
    matching x_num_col_dims — anything else stays untouched.
    """
    groups = {}
    for i, op in enumerate(ops):
        if op.type != 'mul' or op.attrs.get('y_num_col_dims', 1) != 1:
            continue
        var = block._find_var_recursive(op.inputs['Y'][0])
        if var is None or not getattr(var, 'persistable', False):
            continue
        shape = getattr(var, 'shape', None)
        if not shape or len(shape) != 2 or any(int(d) <= 0
                                               for d in shape):
            continue
        x_var = block._find_var_recursive(op.inputs['X'][0])
        if x_var is None or getattr(x_var, 'lod_level', 0):
            continue
        key = (op.inputs['X'][0], op.attrs.get('x_num_col_dims', 1))
        groups.setdefault(key, []).append(i)

    merged_at, drop = {}, set()
    for (x_name, xd), idxs in groups.items():
        if len(idxs) < 2:
            continue
        # def-use safety: hoisting later members to the first position
        # is only sound while no intervening op rewrites X, a group
        # weight or a member's Out, and none reads a member's Out.
        w_names = {ops[i].inputs['Y'][0] for i in idxs}
        out_names = {ops[i].outputs['Out'][0] for i in idxs}
        hazard = {x_name} | w_names | out_names
        safe = [idxs[0]]
        member = set(idxs)
        for j in range(idxs[0] + 1, idxs[-1] + 1):
            if j in member:
                safe.append(j)
                continue
            if hazard & set(ops[j].output_arg_names):
                break
            if out_names & set(ops[j].input_arg_names):
                break
        idxs = safe
        if len(idxs) < 2:
            continue
        widths = [int(block._find_var_recursive(
            ops[i].inputs['Y'][0]).shape[1]) for i in idxs]
        first = idxs[0]
        base = '%s@mulfuse%d' % (x_name, first)
        cat_w, cat_out = base + '@w', base + '@out'
        merged_at[first] = [
            Operator(block, 'concat',
                     inputs={'X': [ops[i].inputs['Y'][0] for i in idxs]},
                     outputs={'Out': [cat_w]}, attrs={'axis': 1}),
            Operator(block, 'mul', inputs={'X': [x_name], 'Y': [cat_w]},
                     outputs={'Out': [cat_out]},
                     attrs=dict(ops[first].attrs)),
            Operator(block, 'split', inputs={'X': [cat_out]},
                     outputs={'Out': [ops[i].outputs['Out'][0]
                                      for i in idxs]},
                     attrs={'axis': -1, 'sections': widths}),
        ]
        drop.update(idxs[1:])

    if not merged_at:
        return ops
    out = []
    for i, op in enumerate(ops):
        if i in merged_at:
            out.extend(merged_at[i])
        elif i not in drop:
            out.append(op)
    return out


# (op type, input slot) pairs whose input defines a shape: a feed read
# only through them is bound statically (``static_env``)
SHAPE_INPUT_SLOTS = frozenset({('reshape', 'Shape')})


def lower_block(program, block, feed_names, fetch_names, state_in_names,
                state_out_names, device, dynamic=False, remat=False,
                static_env=None):
    """Build ``fn(feeds, state) -> (fetches, new_state)``. ``dynamic``
    runs the block in the dynamic program mode (see ``BlockRunner``);
    ``remat`` runs a training forward in checkpointed segments;
    ``static_env`` binds names to host numpy values, baked into this
    lowering (the shape feeds of ``SHAPE_INPUT_SLOTS``).

    ``feeds``/``state`` are dicts name -> tensor on ``device``; ``state``
    holds the scope's ``torch.Generator`` under ``RNG_KEY``. Fetches and
    new state come back detached: no autograd graph outlives a run.
    """
    ops = list(block.ops)
    markers = [i for i, op in enumerate(ops)
               if op.type == 'backward_marker'][:1]
    if MERGE_SHARED_MULS[0] and not dynamic:
        if markers:
            pre = _merge_shared_muls(block, ops[:markers[0]])
            ops = pre + ops[markers[0]:]
            markers = [len(pre)]
        else:
            ops = _merge_shared_muls(block, ops)

    # names the compiler's release annotations must never drop from the
    # environment: the epilogue below still reads them
    keep = (frozenset(fetch_names) | frozenset(state_out_names)
            | {RNG_KEY, RNG_CPU_KEY})

    static_env = dict(static_env or {})

    # data parallelism: a program the partitioner planned for a group of
    # more than one rank (Partitioner.plan_program) runs with the group
    # bound, and a training block under its ZeRO/replicated gradient plan
    group = getattr(program, '_dp_group', None)
    group = group if group is not None and group.size > 1 else None
    plan = None
    if group is not None and markers:
        from ..compiler import zero as _zero
        plan = _zero.training_plan(block, ops, markers[0], group,
                                   getattr(program, '_dp_cut', ()))

    def fn(feeds, state):
        env = dict(state)
        env.update(feeds)
        env.update(static_env)
        with _dp_bound(group):
            if markers:
                _run_training(block, device, ops, markers[0], env, keep,
                              dynamic, remat and not dynamic, plan)
            else:
                with torch.no_grad():
                    BlockRunner(block, device, keep=keep, dynamic=dynamic,
                                profile=True).run_ops(ops, env)
        fetches = [_detach(env[n]) for n in fetch_names]
        new_state = {}
        for n in state_out_names:
            if n in env:
                new_state[n] = _detach(env[n])
            elif n in state:
                new_state[n] = state[n]
        return fetches, new_state

    return fn


def _dp_bound(group):
    """The group bound for the collective ops while a run lasts, or
    nothing."""
    if group is None:
        return contextlib.nullcontext()
    from ..parallel.mesh import dp_scope
    return dp_scope(group)


def _detach(val):
    """Cut ``val`` from autograd. A tensor that needs no gradient stays
    the same object, so a parameter that a run leaves alone is the same
    tensor in the Scope from one run to the next (the fused conv keeps
    its re-laid-out weight while it is). A SequenceTensor keeps its
    lengths."""
    if isinstance(val, SequenceTensor):
        return rewrap(val, _detach(val.data))
    if isinstance(val, torch.Tensor) and val.requires_grad:
        return val.detach()
    return val


def _rows_of(ids_val):
    """A lookup's ids as the carrier sees them: the (padded) id tensor
    with a trailing axis of 1 dropped, and its shape."""
    data = ids_val.data if isinstance(ids_val, SequenceTensor) else ids_val
    shp = tuple(data.shape)
    if shp and shp[-1] == 1:
        shp = shp[:-1]
    return data.reshape(shp), shp


def _run_training(block, device, ops, marker_idx, env, keep, dynamic,
                  remat=False, plan=None):
    """Forward under autograd, gradients of the summed loss into
    ``<param>@GRAD``, then the update ops without autograd. Counterpart
    of the marker branch of the JAX ``lower_block`` (lowering.py:674-766);
    ``remat`` runs the forward through ``_run_remat_segments``. The
    forward also keeps the loss, the parameters and the sparse lookups'
    ids, which the marker reads.

    A sparse table whose lookups' ids are all live before the forward
    (feeds) is no leaf: each lookup gets a zero carrier leaf shaped like
    its ids plus (D,), which ``lookup_table`` adds to its detached
    gathered rows, and the table's gradient is a ``SparseRows`` of the
    carriers' gradients (the loss scale applied) and the ids. A table
    whose ids are made by the program takes the dense gradient.

    Under data parallelism (``plan``, a ``compiler.zero.TrainingPlan``)
    each rank differentiates its share of the global loss: a replicated
    loss (the global mean) is seeded with 1 / dp, so the gradient each
    rank holds of every replicated value sums over the ranks to the
    global gradient, and every collective in the forward sums the ranks'
    gradients in its backward (``collective.sum_over_ranks``). The
    parameters' partial gradients are then summed over the ranks: by the
    replicated reduce-scatter and all-gather (``zero.reduce_gradients``)
    or by the ZeRO-2 ``zero_reduce_scatter`` ops, after which the update
    ops of sliced parameters run on this rank's slice
    (``zero.run_sliced_update``)."""
    marker = ops[marker_idx]
    param_names = list(marker.attrs['params'])
    grad_names = list(marker.attrs['grads'])
    loss_name = marker.inputs['Loss'][0]
    sparse = marker.attrs.get('sparse') or {}
    sparse_map = {w: pairs for w, pairs in sparse.items()
                  if w in env and all(p[0] in env for p in pairs)}
    diff_names = [p for p in param_names if p not in sparse_map]
    gkeep = keep | {loss_name} | set(param_names) | {
        p[0] for pairs in sparse.values() for p in pairs}
    profiling = _prof.op_profiling_enabled()
    if profiling:
        _device_sync(device)
        t0 = time.perf_counter()
    if not param_names:
        # nothing to differentiate (only data reaches the loss): the
        # forward and the update ops run, as under jax.value_and_grad
        # over an empty parameter set
        with torch.no_grad():
            BlockRunner(block, device, keep=gkeep, dynamic=dynamic).run_ops(
                ops[:marker_idx], env)
            if profiling:
                _fwd_bwd_event(device, t0)
            BlockRunner(block, device, keep=keep, dynamic=dynamic,
                        profile=True).run_ops(ops[marker_idx + 1:], env)
        return
    # each parameter is a fresh leaf over the Scope's storage; the
    # Scope's own tensor never has requires_grad flipped
    leaves = {p: env[p].detach().requires_grad_() for p in diff_names}
    for w, pairs in sparse_map.items():
        d = env[w].shape[1]
        for ids_name, carrier in pairs:
            _, shp = _rows_of(env[ids_name])
            leaves[carrier] = torch.zeros(shp + (d,), dtype=env[w].dtype,
                                          device=env[w].device,
                                          requires_grad=True)
    with torch.enable_grad():
        env.update(leaves)
        if remat:
            _run_remat_segments(block, device, ops, marker_idx, env, gkeep)
        else:
            BlockRunner(block, device, grad_mode=True, keep=gkeep,
                        dynamic=dynamic).run_ops(ops[:marker_idx], env)
        loss = env[loss_name].sum()
        if plan is not None and not plan.loss_cut:
            loss = loss / plan.group.size
        grads = dict(zip(leaves, torch.autograd.grad(
            loss, list(leaves.values()), allow_unused=True)))
    if profiling:
        _fwd_bwd_event(device, t0)
    scale = marker.attrs.get('loss_scale', None)
    scaled = scale is not None and scale != 1.0
    for p in diff_names:
        env[p] = leaves[p].detach()
    for p, gname in zip(param_names, grad_names):
        if p in sparse_map:
            items = []
            for ids_name, carrier in sparse_map[p]:
                env.pop(carrier, None)
                rows = grads[carrier]
                rows = torch.zeros_like(leaves[carrier]) if rows is None \
                    else rows
                if scaled:
                    rows = rows * scale
                items.append((rows, _rows_of(env[ids_name])[0]))
            env[gname] = SparseRows(items, int(env[p].shape[0]))
            continue
        # a parameter the loss does not reach gets zeros, as under
        # jax.value_and_grad
        g = grads[p]
        g = torch.zeros_like(env[p]) if g is None else g
        if scaled:
            g = g * scale
        env[gname] = g
    with torch.no_grad():
        runner = BlockRunner(block, device, keep=keep, dynamic=dynamic,
                             profile=True)
        if plan is None:
            runner.run_ops(ops[marker_idx + 1:], env)
            return
        from ..compiler import zero as _zero
        _zero.reduce_gradients(env, plan)
        for op in ops[marker_idx + 1:]:
            if op.type == 'zero_reduce_scatter' and plan.early:
                _zero.owner_slices(op, env, plan.group)
            elif id(op) in plan.sliced:
                _zero.run_sliced_update(op, env, runner, plan.sliced[id(op)],
                                        plan.group)
            else:
                runner.run_ops([op], env)


def _fwd_bwd_event(device, t0):
    """The training region as one profiler event, under the JAX
    lowering's name for its fused forward and backward."""
    _device_sync(device)
    _prof.record_op_event('fwd_bwd(value_and_grad)',
                          time.perf_counter() - t0, start=t0)


def _hidden_env_reads(op):
    """Names an op reads from the environment through its attributes:
    the markers' (``_hidden_reads``) and a sparse lookup's carrier."""
    carrier = op.attrs.get('sparse_carrier')
    return _hidden_reads(op) + ([carrier] if carrier else [])


def _remat_segments(fwd):
    """[start, end) bounds of about sqrt(N) segments over the forward op
    list ``fwd`` (at least 2, as in the JAX package); a
    ``gradient_marker`` is a segment of its own, which runs without a
    checkpoint (its replay reads the forward's names from the
    environment)."""
    n_seg = max(2, int(math.sqrt(len(fwd))))
    cuts = {len(fwd) * i // n_seg for i in range(n_seg + 1)}
    for i, op in enumerate(fwd):
        if op.type == 'gradient_marker':
            cuts.update((i, i + 1))
    cuts = sorted(cuts)
    return [(a, b) for a, b in zip(cuts, cuts[1:]) if a < b]


def _run_remat_segments(block, device, ops, marker_idx, env, keep):
    """The training forward ``ops[:marker_idx]`` as checkpointed
    segments (memory_optimize): each segment runs under
    ``torch.utils.checkpoint.checkpoint(use_reentrant=False)``, so
    autograd keeps the segment's inputs only and the backward runs the
    segment again to rebuild what it needs. After a segment the
    environment keeps only the names a later op (the marker and the
    update ops included) reads, or ``keep`` holds: the boundaries.

    The recompute must repeat the first run exactly and change nothing
    outside itself:

    - the scope's generators (``RNG_KEY``, ``RNG_CPU_KEY``) are not the
      global ones that ``preserve_rng_state`` saves, so each segment
      snapshots their states at its start and the recompute draws from
      copies set to those states (the same dropout masks) while the
      scope's generators advance once;
    - the recompute writes into an environment of its own, which is
      dropped: moving statistics, counters and the sparse carriers are
      written once, by the first run;
    - ``HOST_SYNCS`` counts the first run's host reads only.

    A segment with a dropout or a flash attention therefore launches its
    kernels twice a step: once in the forward, once in the recompute."""
    from ..ops.common import HOST_SYNCS
    fwd = ops[:marker_idx]
    bounds = _remat_segments(fwd)
    # the names each position's remaining ops read (forward rest, the
    # marker, the update ops)
    later = [set() for _ in range(len(ops) + 1)]
    for i in range(len(ops) - 1, -1, -1):
        later[i] = later[i + 1] | set(_op_reads(ops[i])) | set(
            _hidden_env_reads(ops[i]))
    # a gradient marker replays earlier ops from the environment: every
    # name before the last one stays
    last_gm = max([i for i, op in enumerate(fwd)
                   if op.type == 'gradient_marker'] + [-1])
    rng_keys = [k for k in (RNG_KEY, RNG_CPU_KEY) if k in env]
    for a, b in bounds:
        seg = fwd[a:b]
        if len(seg) == 1 and seg[0].type == 'gradient_marker':
            BlockRunner(block, device, grad_mode=True,
                        keep=keep).run_ops(seg, env)
            continue
        reads, produced, writes = [], set(), []
        for op in seg:
            for n in list(_op_reads(op)) + _hidden_env_reads(op):
                if n not in produced and n in env and n not in reads:
                    reads.append(n)
            for n in _op_writes(op):
                produced.add(n)
                if n not in writes:
                    writes.append(n)
        for k in rng_keys:
            if k not in reads:
                reads.append(k)
        needed = later[b] | keep
        outs = tuple(n for n in writes if n in needed or b <= last_gm)
        state = {}

        def run(inputs, _seg=tuple(seg), _outs=outs, _state=state):
            senv = dict(inputs)
            replay = 'rng' in _state
            if replay:
                syncs = HOST_SYNCS[0]
                for k, st in _state['rng'].items():
                    gen = torch.Generator(device=senv[k].device)
                    gen.set_state(st)
                    senv[k] = gen
            else:
                _state['rng'] = {k: senv[k].get_state() for k in rng_keys}
            try:
                BlockRunner(block, device, grad_mode=True,
                            keep=keep).run_ops(list(_seg), senv)
            finally:
                if replay:
                    HOST_SYNCS[0] = syncs
            return [senv.get(n) for n in _outs]

        vals = torch.utils.checkpoint.checkpoint(
            run, {n: env[n] for n in reads}, use_reentrant=False)
        for n in writes:
            env.pop(n, None)
        for n, v in zip(outs, vals):
            if v is not None:
                env[n] = v
        if b > last_gm:
            for n in [n for n in env if n not in needed]:
                del env[n]


# ---- calc_gradient's runtime ----------------------------------------------------
def find_op_path(ops, input_names, target_names, no_grad):
    """Ops both forward-reachable from ``input_names`` and
    backward-reachable from ``target_names``; reachability cut at
    ``no_grad``. Counterpart of the JAX package's ``find_op_path``
    (parity: the reference's _find_op_path_,
    python/paddle/fluid/backward.py:564). Returns (path_ops,
    forward-reachable name set)."""
    reachable = set(input_names)
    fwd = [False] * len(ops)
    for i, op in enumerate(ops):
        if not input_names or any(n in reachable for n in _op_reads(op)):
            fwd[i] = True
            for n in _op_writes(op):
                if n not in no_grad:
                    reachable.add(n)
    needed = set(target_names)
    keep = [False] * len(ops)
    for i in reversed(range(len(ops))):
        if fwd[i] and any(n in needed for n in _op_writes(ops[i])):
            keep[i] = True
            for n in _op_reads(ops[i]):
                if n not in no_grad:
                    needed.add(n)
    return [ops[i] for i in range(len(ops)) if keep[i]], reachable


def _grad_node(val):
    """A float tensor to differentiate against that stays joined to
    ``val``'s own graph: a view when ``val`` needs a gradient already
    (so a later differentiation reaches through it), else a fresh
    leaf."""
    if val.requires_grad:
        return val.view_as(val)
    return val.detach().requires_grad_()


@register_kernel('gradient_marker')
def _gradient_marker(ctx):
    """calc_gradient's runtime (the JAX kernel, lowering.py:358-431).

    The ops between the inputs and the targets (earlier gradient markers
    included, the backward marker excluded) run again with each float
    input as a fresh node; ``torch.autograd.grad`` with
    ``create_graph=True`` gives the inputs' gradients for the targets'
    cotangents (the given target_grads, ones where None). ``no_grad``
    names are detached as they are produced. An integer input's
    "gradient" is its own value and an input no target reaches gets
    zeros, as JAX's float0 handling gives them. Autograd is opened here,
    so the marker works in a served (no_grad) program too."""
    op, env = ctx.op, ctx.env
    block = ctx.runner.block
    ops = list(block.ops)
    idx = next(i for i, o in enumerate(ops) if o is op)
    pre = [o for o in ops[:idx] if o.type != 'backward_marker']
    input_names = list(op.inputs['Inputs'])
    target_names = list(op.inputs['Targets'])
    tgrad_names = list(op.attrs['target_grads'])
    out_grads = list(op.outputs['OutGrads'])
    no_grad = set(op.attrs.get('no_grad') or ())
    path, _ = find_op_path(pre, set(input_names), set(target_names),
                           no_grad)
    with torch.enable_grad():
        genv = dict(env)
        nodes = {}
        for n in input_names:
            val = env[n]
            data = val.data if isinstance(val, SequenceTensor) else val
            if isinstance(data, torch.Tensor) and data.is_floating_point():
                nodes[n] = _grad_node(data)
                genv[n] = rewrap(val, nodes[n])
        runner = BlockRunner(block, ctx.device, grad_mode=True,
                             keep=frozenset(target_names),
                             dynamic=ctx.runner.dynamic)
        for o in path:
            runner.run_ops([o], genv)
            for n in o.output_arg_names:
                if n in no_grad and n in genv:
                    genv[n] = _detach_float(genv[n])
        outs, cots = [], []
        for t, tg in zip(target_names, tgrad_names):
            out = genv[t].data if isinstance(genv[t], SequenceTensor) \
                else genv[t]
            if not (isinstance(out, torch.Tensor) and out.requires_grad):
                continue    # no input reaches it: it adds nothing
            outs.append(out)
            if tg is None:
                cots.append(torch.ones_like(out))
            else:
                cot = env[tg]
                cots.append((cot.data if isinstance(cot, SequenceTensor)
                             else cot).to(out.dtype))
        wanted = list(nodes.values())
        grads = torch.autograd.grad(outs, wanted, cots, create_graph=True,
                                    allow_unused=True) \
            if outs and wanted else [None] * len(wanted)
    got = dict(zip(nodes, grads))
    for n, gname in zip(input_names, out_grads):
        val = env[n]
        if n not in nodes:
            env[gname] = val        # an integer input: carried as it is
            continue
        g = got[n]
        if g is None:
            g = torch.zeros_like(nodes[n])
        env[gname] = rewrap(val, g)


def _detach_float(val):
    data = val.data if isinstance(val, SequenceTensor) else val
    if isinstance(data, torch.Tensor) and data.is_floating_point():
        return rewrap(val, data.detach())
    return val
