"""ZeRO-2 data-parallel execution mode on ``torch.distributed``.

Counterpart of paddle_tpu/compiler/zero.py (PAPERS.md 2004.13336,
2112.01075). The program rewrite is the JAX package's, op for op:

1. **Sharded optimizer state** (stage 1, :func:`shard_optimizer_state`):
   every optimizer accumulator is annotated ``dp``-sharded on its first
   dim the group's size divides (``partition.first_divisible_dim``), per
   tensor; a tensor no dim of which divides stays whole. Each rank's
   Scope then holds only its slice of a sliced accumulator
   (:func:`slice_state`).
2. **Reduce-scattered gradients** (stage 2, :class:`ZeroShardGradients`):
   one ``zero_reduce_scatter`` op per size-capped bucket
   (``bucket_bytes``, default 4 MB), planted before the update tail;
   its kernel (ops/zero_ops.py) runs :func:`bucket_reduce_scatter`, one
   real ``reduce_scatter`` of the bucket, and leaves each rank its owner
   slice of each gradient's global sum.
3. **Sliced update**: each update op of a sliced parameter runs on this
   rank's slice of the parameter, gradient and accumulators
   (:func:`run_sliced_update`, called by the data-parallel lowering) and
   the updated parameter slices are all-gathered back to replicated.

Where the JAX package lets XLA's SPMD partitioner insert the gradient
all-reduce of the replicated path, the port issues it itself
(:func:`reduce_gradients`): each eligible gradient is reduce-scattered
in the same buckets as ZeRO-2's, then its summed slices are
all-gathered. Both paths therefore add the ranks' partial gradients in
the same order, and an elementwise update computes a slice exactly as
it computes the whole, so ZeRO-2's losses, parameters and moments are
bit-identical to the replicated path's.

Ops that read gradients between the backward marker and the update tail
(gradient clips, regularizers) must see the global gradient, as in the
JAX package: where the program has one, every gradient is reduced right
after the backward (:func:`reduce_gradients`), and the
``zero_reduce_scatter`` ops then take each rank's owner slice of the
reduced value (:func:`owner_slices`) instead of a second collective.
"""
import os

import numpy as np

from .. import observability as _obs
from .pass_base import Pass, PassResult, register_pass

__all__ = ['DEFAULT_BUCKET_BYTES', 'default_stage', 'plan_buckets',
           'bucket_reduce_scatter', 'shard_optimizer_state',
           'ZeroShardGradients', 'apply_zero', 'zero_stage_of',
           'grad_shard_bytes', 'OPTIMIZER_UPDATE_OPS', 'grad_entries',
           'training_plan', 'reduce_gradients', 'owner_slices',
           'run_sliced_update', 'slice_state', 'sliced_state_dims']

DEFAULT_BUCKET_BYTES = 4 << 20

# Optimizer update op -> accumulator-state input slots (the vars ZeRO
# stage >= 1 slices)
OPTIMIZER_STATE_SLOTS = {
    'momentum': ('Velocity',),
    'adam': ('Moment1', 'Moment2'),
    'adamax': ('Moment', 'InfNorm'),
    'adagrad': ('Moment',),
    'decayed_adagrad': ('Moment',),
    'adadelta': ('AvgSquaredGrad', 'AvgSquaredUpdate'),
    'rmsprop': ('MeanSquare', 'Moment'),
    'ftrl': ('SquaredAccumulator', 'LinearAccumulator'),
}

# Every update op whose Grad input stage 2 reduce-scatters (SGD carries
# no accumulator state but its gradient still buckets/shards).
OPTIMIZER_UPDATE_OPS = frozenset(OPTIMIZER_STATE_SLOTS) | {'sgd'}

_DTYPE_BYTES = {'float64': 8, 'int64': 8, 'uint64': 8, 'float32': 4,
                'int32': 4, 'uint32': 4, 'float16': 2, 'bfloat16': 2,
                'int16': 2, 'uint16': 2, 'int8': 1, 'uint8': 1,
                'bool': 1}


def default_stage():
    """The ZeRO stage data-parallel paths apply when none is given:
    ``PADDLE_TPU_ZERO_STAGE`` (default 2), as in the JAX package. 0
    disables."""
    try:
        return int(os.environ.get('PADDLE_TPU_ZERO_STAGE', '2'))
    except ValueError:
        return 2


def zero_stage_of(program):
    """The stage :func:`apply_zero` last applied to ``program`` (0 when
    untouched)."""
    return int(getattr(program, '_zero_stage', 0) or 0)


def _dtype_bytes(dtype):
    return _DTYPE_BYTES.get(str(dtype), 4)


def plan_buckets(payload_bytes, cap=DEFAULT_BUCKET_BYTES):
    """Greedy size-capped coalescing, the JAX package's: group
    consecutive tensors until adding the next would push the bucket past
    ``cap``; a tensor larger than ``cap`` gets a bucket of its own; an
    exact cap multiple closes the bucket at the boundary. Returns index
    lists covering ``range(len(payload_bytes))`` in order."""
    cap = int(cap) if cap and int(cap) > 0 else DEFAULT_BUCKET_BYTES
    buckets, cur, cur_bytes = [], [], 0
    for i, b in enumerate(payload_bytes):
        b = int(b)
        if cur and cur_bytes + b > cap:
            buckets.append(cur)
            cur, cur_bytes = [], 0
        cur.append(i)
        cur_bytes += b
        if cur_bytes >= cap:
            buckets.append(cur)
            cur, cur_bytes = [], 0
    if cur:
        buckets.append(cur)
    return buckets


def bucket_reduce_scatter(grads, shard_dims, dp, axis='dp', group=None):
    """One coalesced gradient collective over the group.

    Each rank passes its PARTIAL gradients. Each gradient's shard dim is
    moved to the front and its ``(dp, numel/dp)`` view joins ONE bucket,
    which goes through a single ``reduce_scatter``; the pieces are cut
    back out and returned as this rank's OWNER slices, shaped
    ``[s[d]/dp, ...]`` in the parameter's axis order: the literal ZeRO-2
    reduce-scatter (the JAX package's ``manual=True`` branch)."""
    import torch
    from ..parallel.collective import reduce_scatter
    grads = list(grads)
    if not grads:
        return []
    moved_shapes, pieces = [], []
    for g, d in zip(grads, shard_dims):
        x = torch.movedim(g, int(d), 0)
        moved_shapes.append(tuple(x.shape))
        pieces.append(x.reshape(dp, -1))
    bucket = pieces[0] if len(pieces) == 1 else torch.cat(pieces, dim=1)
    bucket = reduce_scatter(bucket, axis, axis=0, group=group)
    outs, off = [], 0
    for d, mshape, piece in zip(shard_dims, moved_shapes, pieces):
        k = piece.shape[1]
        chunk = bucket[:, off:off + k]
        off += k
        local = (int(mshape[0]) // int(dp),) + tuple(mshape[1:])
        outs.append(torch.movedim(chunk.reshape(local), 0, int(d)))
    return outs


def _grad_tail(program):
    """(block, marker, update_ops) of a training program's global
    block, or (block, None, []) when it has no optimizer tail."""
    block = program.global_block()
    marker = None
    updates = []
    for op in block.ops:
        if op.type == 'backward_marker':
            marker = op
        elif op.type in OPTIMIZER_UPDATE_OPS and op.inputs.get('Grad'):
            updates.append(op)
    return block, marker, updates


def shard_optimizer_state(program, dp):
    """ZeRO stage 1: annotate every optimizer accumulator Variable
    sharded over ``dp`` on its first divisible dim, per TENSOR, with a
    replicated fallback for tensors no dim of which divides. Returns
    ``(sliced_names, replicated_names)``. Explicit shardings are kept."""
    from ..partition import first_divisible_dim
    sliced, replicated = [], []
    if dp <= 1:
        return sliced, replicated
    block = program.global_block()
    for op in block.ops:
        slots = OPTIMIZER_STATE_SLOTS.get(op.type)
        if not slots:
            continue
        for slot in slots:
            for name in op.inputs.get(slot, []):
                var = block._find_var_recursive(name)
                if var is None:
                    continue
                if var.sharding is not None:
                    continue  # keep explicit shardings
                d = first_divisible_dim(var.shape, dp)
                if d is None:
                    replicated.append(name)
                    continue
                var.sharding = (None,) * d + ('dp',)
                sliced.append(name)
    if sliced:
        program._bump_version()
    return sliced, replicated


def grad_shard_bytes(program, dp):
    """Per-rank bytes of the local gradient shards a ZeRO-2 program
    holds through its update tail (the ``zero_grad_shard_bytes``
    gauge)."""
    total = 0
    block = program.global_block()
    for op in block.ops:
        if op.type != 'zero_reduce_scatter':
            continue
        for name in op.inputs.get('X', []):
            var = block._find_var_recursive(name)
            if var is None or not var.shape:
                continue
            numel = int(np.prod([max(int(s), 1) for s in var.shape]))
            total += numel * _dtype_bytes(var.dtype) // max(dp, 1)
    return total


def grad_entries(block, marker, updates, dp):
    """The gradients ZeRO-2 reduce-scatters, as (grad name, shard dim,
    payload bytes), in REVERSE update order (backward completion order):
    dense, of a parameter with no explicit sharding, with a dim ``dp``
    divides. The pass plants its buckets from these."""
    from ..partition import first_divisible_dim
    sparse = set((marker.attrs.get('sparse') or {}))
    entries, seen = [], set()
    for op in reversed(updates):
        gname = op.inputs['Grad'][0]
        pname = op.inputs.get('Param', [None])[0]
        if pname in sparse or gname in seen:
            continue
        pvar = block._find_var_recursive(pname)
        if pvar is not None and pvar.sharding is not None:
            continue
        var = block._find_var_recursive(gname) or pvar
        shape = tuple(getattr(var, 'shape', None) or ())
        if not shape or any(int(s) <= 0 for s in shape):
            continue
        d = first_divisible_dim(shape, dp)
        if d is None:
            continue
        seen.add(gname)
        numel = int(np.prod([int(s) for s in shape]))
        entries.append((gname, d, numel * _dtype_bytes(
            getattr(var, 'dtype', 'float32'))))
    return entries


@register_pass
class ZeroShardGradients(Pass):
    """Rewrite the grad-op tail for ZeRO-2: one ``zero_reduce_scatter``
    op per size-capped bucket immediately before the optimizer update
    tail, with the gradient vars annotated dp-sharded. Buckets are
    planned in reverse update order; ineligible tensors (sparse, no
    divisible dim, explicitly sharded parameter) keep the replicated
    reduction, per tensor. The same ops, attrs and annotations as the
    JAX package's pass."""

    name = 'zero_shard_grads'
    preserves_semantics = True
    idempotent = True

    def __init__(self, dp=None, bucket_bytes=None, axis='dp'):
        self.dp = dp
        self.bucket_bytes = int(bucket_bytes or DEFAULT_BUCKET_BYTES)
        self.axis = axis

    def run(self, program, ctx):
        res = PassResult(self.name)
        dp = int(self.dp or 0)
        if dp <= 1:
            return res
        block, marker, updates = _grad_tail(program)
        if marker is None or not updates:
            return res
        if any(op.type == 'zero_reduce_scatter' for op in block.ops):
            return res        # idempotent: tail already rewritten
        entries = grad_entries(block, marker, updates, dp)
        if not entries:
            return res
        buckets = plan_buckets([e[2] for e in entries],
                               self.bucket_bytes)
        first_update = min(i for i, op in enumerate(block.ops)
                           if op in updates)
        for b_id, idxs in enumerate(buckets):
            names = [entries[i][0] for i in idxs]
            dims = [entries[i][1] for i in idxs]
            block.insert_op(
                first_update, type='zero_reduce_scatter',
                inputs={'X': names}, outputs={'Out': names},
                attrs={'shard_dims': dims, 'dp': dp,
                       'axis_name': self.axis, 'bucket_id': b_id,
                       'bucket_bytes': sum(entries[i][2]
                                           for i in idxs)})
            first_update += 1
            for gname, d in zip(names, dims):
                gvar = block._find_var_recursive(gname)
                if gvar is not None and gvar.sharding is None:
                    gvar.sharding = (None,) * d + (self.axis,)
        program._bump_version()
        res.changed = True
        res.ops_fused = len(entries)
        res.note = '%d grads -> %d bucket(s)' % (len(entries),
                                                 len(buckets))
        return res


def apply_zero(program, dp, stage=None, bucket_bytes=None):
    """Apply ZeRO to a training program: stage >= 1 slices the optimizer
    state per tensor over ``dp``, stage >= 2 also rewrites the gradient
    tail with bucketed reduce-scatters. Idempotent per (program, dp,
    stage); a group of one is a structural no-op. Returns a summary dict
    (journaled as a ``zero`` event)."""
    stage = default_stage() if stage is None else int(stage)
    dp = int(dp or 1)
    summary = {'stage': stage, 'dp': dp, 'sliced': 0, 'replicated': 0,
               'buckets': 0, 'grads': 0, 'shard_bytes': 0}
    if stage <= 0 or dp <= 1:
        return summary
    if zero_stage_of(program) >= stage and \
            getattr(program, '_zero_dp', None) == dp:
        return summary        # already applied at this (stage, dp)
    sliced, replicated = shard_optimizer_state(program, dp)
    summary['sliced'], summary['replicated'] = len(sliced), \
        len(replicated)
    summary['sliced_names'] = sliced
    summary['replicated_names'] = replicated
    if stage >= 2:
        res = ZeroShardGradients(dp=dp, bucket_bytes=bucket_bytes).run(
            program, None)
        if res.changed:
            block = program.global_block()
            summary['buckets'] = sum(
                1 for op in block.ops
                if op.type == 'zero_reduce_scatter')
            summary['grads'] = res.ops_fused
            summary['shard_bytes'] = grad_shard_bytes(program, dp)
    program._zero_stage = stage
    program._zero_dp = dp
    reg = _obs.default_registry()
    reg.gauge('zero_grad_shard_bytes',
              'per-device bytes of ZeRO-2 local gradient shards'
              ).set(summary['shard_bytes'])
    if _obs.journal_active():
        _obs.emit('zero', action='apply', **{
            k: v for k, v in summary.items()
            if not k.endswith('_names')})
    return summary


# ---- the data-parallel runtime ----------------------------------------------------

def sliced_state_dims(program, dp, persistable=True):
    """{name: shard dim} of the accumulators ZeRO stage 1 sliced (their
    ``dp`` annotation), for a group of ``dp`` ranks; with
    ``persistable=False`` also the reduce-scattered gradients."""
    if dp <= 1:
        return {}
    memo = program.__dict__.setdefault('_zero_state_memo', {})
    key = (program._version, dp, persistable)
    if key in memo:
        return memo[key]
    out = memo[key] = {}
    for b in program.blocks:
        for v in b.vars.values():
            spec = getattr(v, 'sharding', None)
            if (v.persistable or not persistable) and spec and \
                    spec[-1] == 'dp' and all(e is None for e in spec[:-1]):
                out[v.name] = len(spec) - 1
    return out


def _piece(t, d, group):
    k = int(t.shape[d]) // group.size
    return t.narrow(d, group.rank * k, k)


def slice_state(scope, program, group):
    """Cut each sliced accumulator that ``scope`` holds whole down to
    this rank's slice (a copy, so the whole tensor is freed). Returns
    the names cut."""
    import torch
    cut = []
    block = program.global_block()
    for name, d in sliced_state_dims(program, group.size).items():
        val = scope.raw(name)
        var = block._find_var_recursive(name)
        if not isinstance(val, torch.Tensor) or var is None:
            continue
        if tuple(val.shape) == tuple(int(s) for s in var.shape):
            scope.holder(name).set_var(
                name, _piece(val, d, group).contiguous().clone())
            cut.append(name)
    return cut


class TrainingPlan(object):
    """What the data-parallel lowering does to one training block:

    - ``buckets``: the gradient buckets the lowering reduces itself, each
      a list of (grad name, shard dim), reduce-scattered then
      all-gathered; ``whole``: gradients with no divisible dim,
      all-reduced;
    - ``early``: an op between the marker and the tail reads a
      gradient, so every gradient is reduced after the backward and the
      ``zero_reduce_scatter`` ops only take owner slices;
    - ``sliced``: {id(update op): shard dim} of the updates that run on
      slices;
    - ``loss_cut``: the loss is per row (not the replicated global mean),
      so each rank's loss is seeded with 1, not 1 / dp."""

    def __init__(self, group, buckets, whole, early, sliced, loss_cut):
        self.group = group
        self.loss_cut = loss_cut
        self.buckets = buckets
        self.whole = whole
        self.early = early
        self.sliced = sliced


def training_plan(block, ops, marker_idx, group, cut=()):
    """The :class:`TrainingPlan` of ``ops`` (a training block's op list)
    for ``group``; ``cut``: the names cut to this rank's rows. The
    backward's own gradients (the marker's) are what the lowering
    reduces: where an op between the marker and the tail reads one
    (``early``), all of them, bucketed by their parameters' first
    divisible dim; else those the ZeRO-2 ops do not take."""
    from ..partition import first_divisible_dim
    dp = group.size
    marker = ops[marker_idx]
    if marker.attrs.get('sparse'):
        raise NotImplementedError(
            'sparse gradients (a table with is_sparse=True) under data '
            'parallelism are not ported yet (ROADMAP Queue A item 6)')
    tail = ops[marker_idx + 1:]
    updates = [op for op in tail if op.type in OPTIMIZER_UPDATE_OPS
               and op.inputs.get('Grad')]
    zero_ops = [op for op in tail if op.type == 'zero_reduce_scatter']
    zero_names = {n for op in zero_ops for n in op.inputs['X']}
    grad_names = list(marker.attrs['grads'])
    first_tail = min([i for i, op in enumerate(tail)
                      if op in updates or op in zero_ops] or [len(tail)])
    read = {n for op in tail[:first_tail] for n in op.input_arg_names}
    early = bool(read & set(grad_names))
    # the backward's gradients, last parameter first (backward order)
    entries = []
    for pname, gname in reversed(list(zip(marker.attrs['params'],
                                          grad_names))):
        pvar = block._find_var_recursive(pname)
        shape = tuple(int(x) for x in (getattr(pvar, 'shape', None) or ()))
        d = None if pvar is None or pvar.sharding is not None or \
            not shape or min(shape) <= 0 else first_divisible_dim(shape, dp)
        nbytes = int(np.prod(shape)) * _dtype_bytes(pvar.dtype) \
            if pvar is not None and shape else 0
        entries.append((gname, d, nbytes))
    reduce_here = [e for e in entries if e[1] is not None and
                   (early or e[0] not in zero_names)]
    buckets = [[(reduce_here[i][0], reduce_here[i][1]) for i in idx]
               for idx in plan_buckets([e[2] for e in reduce_here])
               ] if reduce_here else []
    whole = [g for g, d, _ in entries if d is None]
    state_dims = sliced_state_dims(block.program, dp)
    sliced = {}
    for op in updates:
        gname = op.inputs['Grad'][0]
        accs = [n for s in OPTIMIZER_STATE_SLOTS.get(op.type, ())
                for n in op.inputs.get(s, [])]
        if gname in zero_names or any(n in state_dims for n in accs):
            pvar = block._find_var_recursive(op.inputs['Param'][0])
            d = first_divisible_dim(pvar.shape, dp)
            if d is not None:
                sliced[id(op)] = d
    return TrainingPlan(group, buckets, whole, early, sliced,
                        marker.inputs['Loss'][0] in cut)


def reduce_gradients(env, plan):
    """The replicated path's gradient collective, in place on ``env``:
    each bucket reduce-scattered exactly as ZeRO-2's and its summed
    slices all-gathered; gradients no dim of which divides all-reduced.
    Sparse gradients are left to the update (not reduced here)."""
    from ..parallel.collective import all_gather, all_reduce
    g = plan.group
    for bucket in plan.buckets:
        names = [n for n, _ in bucket]
        dims = [d for _, d in bucket]
        outs = bucket_reduce_scatter([env[n] for n in names], dims, g.size,
                                     group=g)
        for n, d, piece in zip(names, dims, outs):
            env[n] = all_gather(piece, axis=d, group=g)
    for n in plan.whole:
        val = env.get(n)
        if val is not None and hasattr(val, 'is_floating_point'):
            env[n] = all_reduce(val, group=g)


def owner_slices(op, env, group):
    """A ``zero_reduce_scatter`` op over gradients already reduced: each
    rank keeps its owner slice of each."""
    for name, d in zip(op.inputs['X'], op.attrs.get('shard_dims') or []):
        env[name] = _piece(env[name], int(d), group).contiguous()


def run_sliced_update(op, env, runner, dim, group):
    """Run update ``op`` on this rank's slice: the parameter, a whole
    gradient and whole accumulators are cut to the slice along ``dim``,
    the kernel runs on them, the parameter slices are all-gathered back
    to replicated and the accumulators stay sliced."""
    import torch
    from ..core.lowering import OpCtx
    from ..core.registry import get_kernel
    from ..parallel.collective import all_gather
    pvar = runner.block._find_var_recursive(op.inputs['Param'][0])
    full = tuple(int(s) for s in pvar.shape)
    k = full[dim] // group.size
    sub = {}
    for n in op.input_arg_names:
        v = env.get(n)
        if isinstance(v, torch.Tensor) and tuple(v.shape) == full:
            v = _piece(v, dim, group)
        sub[n] = v
    get_kernel(op.type)(OpCtx(op, sub, runner))
    kept = sliced_state_dims(runner.block.program, group.size)
    for names in op.outputs.values():
        for n in names:
            v = sub[n]
            if isinstance(v, torch.Tensor) and v.dim() > dim and \
                    tuple(v.shape) != full and int(v.shape[dim]) == k:
                # a slice: the parameter (and any state that is not
                # kept sliced) goes back to replicated
                v = v.contiguous() if n in kept else \
                    all_gather(v.contiguous(), axis=dim, group=group)
            env[n] = v
