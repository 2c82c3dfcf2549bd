"""Partitioner: the one owner of data-parallel placement.

Counterpart of the dp half of paddle_tpu/partition/partitioner.py. The
JAX Partitioner owns a device mesh and hands XLA's SPMD partitioner one
program over the global batch. Here a rank is a process: the
Partitioner owns this rank's view of the dp group
(``parallel.mesh.DPGroup``) and makes the port's placement decisions:

- :meth:`feed_sharding` / :meth:`shard_feed`: each rank is given the
  GLOBAL feed and keeps rows ``[r*B/dp, (r+1)*B/dp)`` of dim 0; a feed
  whose dim 0 the group's size does not divide stays whole on every
  rank (the JAX package's rule, partitioner.py:320-346). A
  SequenceTensor's data and lengths are cut alike;
- :meth:`plan_program`: which values of a program are cut to this
  rank's rows (from the cut feeds, op by op) and which ops reduce over
  the cut batch dim. Those ops are marked ``dp_global`` and compute the
  global value (``mean``, ``reduce_mean``/``reduce_sum`` over dim 0,
  ``accuracy``, train-mode ``batch_norm``, the fused conv's train-mode
  batch norm); any other op that reads a cut value in a way not known to
  keep rows apart raises, naming ROADMAP Queue A item 6, so a per-rank
  answer is never given silently;
- :meth:`cache_token`: the (mesh, sharding) component of the Executor's
  memo key, so a dp program never hits a single-device entry.

Only the ``dp`` axis exists: a spec naming ``mp``/``tp`` (tensor
parallelism) or another model axis raises, naming the ROADMAP item.
"""
import functools

import numpy as np

from .. import observability as _obs
from .rules import resolve_entry, standard_logical_axis_rules

__all__ = ['Partitioner', 'first_divisible_dim', 'mesh_axis_extent']

_ITEM_6 = ('is not ported yet (ROADMAP Queue A item 6: the port runs '
           'data parallelism only)')


def first_divisible_dim(shape, extent):
    """Index of the first dim an ``extent``-way shard divides evenly,
    or None. The ONE divisibility rule shared by the ZeRO transpiler's
    accumulator slicing and the partitioner's degradation: both must
    agree or a transpile-time annotation could silently degrade at
    partition time."""
    for d, e in enumerate(shape):
        if extent and int(e) % extent == 0 and int(e) >= extent:
            return d
    return None


def mesh_axis_extent(mesh, axis):
    """Extent of a named axis on ``mesh`` (1 when absent/None)."""
    if mesh is None:
        return 1
    return int(dict(zip(mesh.axis_names, mesh.shape)).get(axis, 1))


def _mesh_desc(mesh):
    return 'x'.join('%s=%d' % (a, e) for a, e in
                    zip(mesh.axis_names, mesh.shape))


class Partitioner(object):
    """Owns this rank's view of the dp group and resolves the placement
    decisions the executors make.

    Parameters
    ----------
    mesh : parallel.mesh.DPGroup, optional
        Defaults to :func:`parallel.mesh.get_mesh`.
    num_devices : int, optional
        The group's size, checked against the running processes.
    rules : sequence of (logical, mesh-axis) pairs, optional
    batch_axis : str
        The axis feeds cut their batch dim over.
    """

    def __init__(self, mesh=None, num_devices=None, rules=None,
                 batch_axis='batch'):
        if mesh is None:
            from ..parallel.mesh import get_mesh
            mesh = get_mesh(num_devices)
        self.mesh = mesh
        self.rules = tuple(rules if rules is not None
                           else standard_logical_axis_rules())
        self._axes = tuple(mesh.axis_names)
        self._extents = dict(zip(self._axes, mesh.shape))
        self.batch_axis = resolve_entry(batch_axis, self._axes,
                                        self.rules)
        _obs.default_registry().gauge(
            'partition_mesh_devices', 'devices in a live Partitioner mesh',
            mesh=_mesh_desc(mesh)).set(self.device_count)
        if _obs.journal_active():
            _obs.emit('partition', action='create',
                      mesh=_mesh_desc(mesh), devices=self.device_count)

    @classmethod
    def for_place(cls, place):
        """A group of one over ``place``'s device: the single-device
        partitioner."""
        from ..parallel.mesh import DPGroup
        dev = place.torch_device() if hasattr(place, 'torch_device') \
            else place
        return cls(mesh=DPGroup(1, 0, dev))

    # ---- introspection ---------------------------------------------------
    @property
    def device_count(self):
        return int(self.mesh.size)

    @property
    def active(self):
        """True when runs are data-parallel (a group of more than one
        rank)."""
        return self.device_count > 1

    @property
    def device(self):
        return self.mesh.device

    @property
    def rank(self):
        return self.mesh.rank

    def axis_extent(self, axis):
        return int(self._extents.get(axis, 1))

    def describe(self):
        return {'mesh': _mesh_desc(self.mesh),
                'devices': self.device_count,
                'axes': dict(self._extents),
                'batch_axis': self.batch_axis,
                'active': self.active,
                'rank': self.mesh.rank,
                'device': str(self.mesh.device),
                'backend': self.mesh.backend}

    def mesh_meta(self):
        """JSON-ready mesh identity (axes, shape, device count), as the
        JAX package's checkpoint manifests record it."""
        return {'axes': list(self._axes),
                'shape': [int(s) for s in self.mesh.shape],
                'devices': self.device_count}

    # ---- spec resolution -------------------------------------------------
    def resolve_spec(self, spec, ndim=None, shape=None):
        """Variable.sharding tuple -> per-dim mesh axes, with logical-rule
        resolution, ndim truncation and divisibility degradation (as the
        JAX package's). An entry that resolves to a model axis (``mp``,
        ``sp``, ``pp``) raises: only dp is ported."""
        model = set(a for _, a in self.rules if a not in (None, 'dp'))
        model |= {'tp'}
        for e in spec:
            names = e if isinstance(e, (tuple, list)) else (e,)
            for n in names:
                if n is None:
                    continue
                resolved = dict(self.rules).get(n, n)
                if n in model or resolved in model:
                    raise NotImplementedError(
                        'sharding spec %r names %r: tensor, pipeline and '
                        'sequence parallelism %s' % (tuple(spec), n,
                                                     _ITEM_6))
        out = [resolve_entry(e, self._axes, self.rules) for e in spec]
        if ndim is not None:
            out = out[:ndim]
        if shape is not None:
            for d, entry in enumerate(out):
                if entry is None or d >= len(shape):
                    continue
                names = entry if isinstance(entry, (tuple, list)) \
                    else (entry,)
                e = int(np.prod([self.axis_extent(a) for a in names]))
                if e and int(shape[d]) % e != 0:
                    out[d] = None
        return out

    def grad_shard_spec(self, shape, axis='dp'):
        """The ZeRO-2 spec a gradient (or accumulator) of ``shape``
        shards under: ``axis`` on the first divisible dim, or None. The
        same ``first_divisible_dim`` rule the ZeRO pass uses."""
        extent = self.axis_extent(axis)
        if extent <= 1:
            return None
        d = first_divisible_dim(shape, extent)
        if d is None:
            return None
        return (None,) * d + (axis,)

    # ---- feeds -----------------------------------------------------------
    def feed_sharding(self, value):
        """The spec of one feed: ``(batch axis,)`` where dim 0 is cut
        over the group, ``()`` (whole on every rank) otherwise. A
        SequenceTensor gets a SequenceTensor of specs, data and lengths
        alike."""
        from ..lod import SequenceTensor
        ax = self.batch_axis
        extent = self.axis_extent(ax) if ax is not None else 1

        def leaf(v):
            shape = np.shape(v) if not hasattr(v, 'shape') else \
                tuple(v.shape)
            if extent <= 1 or not shape or int(shape[0]) % extent != 0:
                return ()
            return (ax,)

        if isinstance(value, SequenceTensor):
            # data and lengths cut alike: by the batch (the lengths' rows)
            spec = leaf(value.lengths) if value.lengths is not None \
                else leaf(value.data)
            return SequenceTensor(spec, spec, None if
                                  value.sub_lengths is None else spec)
        return leaf(value)

    def shard_feed(self, feed):
        """``(local feed, cut names)``: each feed cut to this rank's rows
        where :meth:`feed_sharding` cuts it."""
        from ..lod import SequenceTensor
        if not self.active:
            return feed, frozenset()
        n, r = self.device_count, self.mesh.rank
        out, cut = {}, set()
        for k, v in feed.items():
            spec = self.feed_sharding(v)
            if isinstance(v, SequenceTensor):
                if v.packed_mode or not spec.data:
                    if v.packed_mode and spec.data:
                        raise NotImplementedError(
                            'feed %r: a packed LoD feed under data '
                            'parallelism %s' % (k, _ITEM_6))
                    out[k] = v
                    continue
                b = int(v.lengths.shape[0]) // n
                out[k] = SequenceTensor(
                    _rows(v.data, r * b, b), _rows(v.lengths, r * b, b),
                    None if v.sub_lengths is None
                    else _rows(v.sub_lengths, r * b, b))
                cut.add(k)
                continue
            if not spec:
                out[k] = v
                continue
            b = int(np.shape(v)[0] if not hasattr(v, 'shape')
                    else v.shape[0]) // n
            out[k] = _rows(v, r * b, b)
            cut.add(k)
        return out, frozenset(cut)

    # ---- programs --------------------------------------------------------
    def plan_program(self, program, cut_feeds, clone):
        """The program annotated for this group: a clone (when ``clone``)
        with ``dp_global`` on each op that reduces over the cut batch
        dim, ``_dp_cut`` the names of the values cut to this rank's rows
        and ``_dp_group`` the group. Raises where an op would give a
        per-rank answer."""
        if clone:
            program = program.clone()
        cut = set(cut_feeds)
        for op in program.global_block().ops:
            _plan_op(op, cut)
        program._dp_cut = frozenset(cut)
        program._dp_group = self.mesh
        return program

    # ---- cache key -------------------------------------------------------
    def mesh_token(self):
        """Hashable identity of the group (axes, extent, rank, device,
        backend)."""
        return self.mesh.token()

    def cache_token(self, program):
        """The (mesh, sharding spec) component of the Executor's memo
        key: the group's token, the rules and the program's resolved
        sharding signature, memoized per program fingerprint."""
        memo = program.__dict__.setdefault('_partition_memo', {})
        key = (program.fingerprint(), self.mesh_token(), self.rules)
        hit = memo.get(key)
        if hit is not None:
            return hit
        sig = []
        for b in program.blocks:
            for v in b.vars.values():
                spec = getattr(v, 'sharding', None)
                if spec:
                    shape = getattr(v, 'shape', None) or ()
                    sig.append((v.name, tuple(
                        self.resolve_spec(spec, shape=shape))))
        token = ('partition', self.mesh_token(), self.rules,
                 tuple(sorted(sig)))
        memo[key] = token
        return token

    def __repr__(self):
        return 'Partitioner(%s%s)' % (
            _mesh_desc(self.mesh),
            ', rank %d' % self.mesh.rank if self.active
            else ', single device')


def _rows(v, start, n):
    if hasattr(v, 'narrow'):
        return v.narrow(0, start, n)
    return np.asarray(v)[start:start + n]


# ---- which values a program cuts to this rank's rows -----------------------------

@functools.lru_cache(maxsize=None)
def _row_ops():
    """The ops that keep rows apart: each output row is made from the
    same row of each cut input."""
    from ..ops.activations import ACTS, ACTS_P
    return frozenset(ACTS) | frozenset(ACTS_P) | {
        'dropout', 'softmax', 'cross_entropy', 'softmax_with_cross_entropy',
        'sigmoid_cross_entropy_with_logits', 'square_error_cost', 'scale',
        'cast', 'conv2d', 'depthwise_conv2d', 'conv2d_transpose', 'pool2d',
        'top_k', 'one_hot', 'lookup_table', 'assign', 'sum', 'sign',
        'label_smooth', 'fill_constant_batch_size_like', 'relu'}


_BINARY = ('elementwise_add', 'elementwise_sub', 'elementwise_mul',
           'elementwise_div', 'elementwise_max', 'elementwise_min',
           'elementwise_pow')


def _refuse(op, why):
    raise NotImplementedError(
        'op %r reads values cut to this rank\'s rows (%s): its global '
        'value under data parallelism %s' % (op.type, why, _ITEM_6))


def _reduces_dim0(op, rank):
    dim = op.attrs.get('dim', None)
    if op.attrs.get('reduce_all', False) or dim is None:
        return True
    dims = dim if isinstance(dim, (list, tuple)) else (dim,)
    return any(int(d) % max(rank, 1) == 0 for d in dims)


def _plan_op(op, cut):
    """Propagate cut-ness through ``op`` (adding its cut outputs to
    ``cut``), mark it ``dp_global`` where it reduces over the batch, and
    refuse what the slice does not make global."""
    from ..compiler.passes import RNG_OPS
    ins = [n for n in op.input_arg_names if n in cut]
    t = op.type
    if t == 'backward_marker':
        return
    if not ins:
        if t in RNG_OPS:
            _refuse(op, 'a random value every rank would draw apart')
        if t in ('fused_elementwise', 'fused_conv'):
            # a region of replicated values: still walk its members
            for sub in _sub_ops(op):
                _plan_op(sub, cut)
        return
    outs = list(op.output_arg_names)
    if op.attrs.get('sub_block') is not None:
        _refuse(op, 'a control-flow body')
    if t in ('fused_elementwise', 'fused_conv'):
        need = False
        for sub in _sub_ops(op):
            _plan_op(sub, cut)
            need = need or bool(sub.attrs.get('dp_global'))
        if need:
            op.attrs['dp_global'] = True
        return
    if t in _row_ops():
        cut.update(outs)
        return
    if t in _BINARY:
        x, y = op.inputs['X'][0], op.inputs['Y'][0]
        if x not in cut:
            _refuse(op, 'Y is cut but X is not')
        if y in cut and op.attrs.get('axis', -1) not in (-1, 0):
            _refuse(op, 'a cut Y broadcast from axis %r'
                    % op.attrs.get('axis'))
        cut.update(outs)
        return
    if t in ('mul', 'matmul'):
        if op.inputs['Y'][0] in cut or op.inputs['X'][0] not in cut or \
                op.attrs.get('transpose_X', False):
            _refuse(op, 'a product over the cut rows')
        cut.update(outs)
        return
    if t in ('reshape', 'reshape2'):
        shape = list(op.attrs.get('shape') or [])
        if op.inputs.get('Shape') or op.inputs.get('ShapeTensor') or \
                not shape or shape[0] not in (-1, 0):
            _refuse(op, 'a reshape that moves the batch dim')
        cut.update(outs)
        return
    if t in ('transpose', 'transpose2'):
        if list(op.attrs.get('axis') or [0])[0] != 0:
            _refuse(op, 'a transpose that moves the batch dim')
        cut.update(outs)
        return
    if t in ('concat', 'split'):
        if int(op.attrs.get('axis', 0)) == 0 or \
                (t == 'concat' and len(ins) != len(op.inputs['X'])):
            _refuse(op, 'a %s along the batch dim' % t)
        cut.update(outs)
        return
    if t in ('flatten', 'flatten2'):
        if int(op.attrs.get('axis', 1)) < 1:
            _refuse(op, 'a flatten across the batch dim')
        cut.update(outs)
        return
    if t in ('squeeze', 'squeeze2', 'unsqueeze', 'unsqueeze2'):
        if 0 in [int(a) for a in (op.attrs.get('axes') or [])]:
            _refuse(op, 'a %s of the batch dim' % t)
        cut.update(outs)
        return
    if t == 'layer_norm':
        if int(op.attrs.get('begin_norm_axis', 1)) < 1:
            _refuse(op, 'a layer norm over the batch dim')
        cut.update(outs)
        return
    if t == 'mean':
        op.attrs['dp_global'] = True
        return
    if t in ('reduce_sum', 'reduce_mean'):
        x = op.inputs['X'][0]
        if x in cut and _reduces_dim0(op, len(_shape_of(op, x))):
            op.attrs['dp_global'] = True
        else:
            cut.update(outs)
        return
    if t == 'accuracy':
        op.attrs['dp_global'] = True
        return
    if t == 'batch_norm':
        if op.inputs['X'][0] not in cut:
            _refuse(op, 'a cut statistic')
        if not op.attrs.get('is_test', False):
            op.attrs['dp_global'] = True
        cut.update(op.outputs.get('Y', []))
        return
    _refuse(op, 'no rule for it keeps the rows apart')


def _shape_of(op, name):
    var = op.block._find_var_recursive(name) if op.block is not None \
        else None
    return tuple(getattr(var, 'shape', None) or (-1,))


class _SubOp(object):
    """A fused op's captured member, as ``_plan_op`` reads it."""

    def __init__(self, parent, spec):
        self.type, self.inputs, self.outputs, self.attrs = (
            spec[0], spec[1], spec[2], dict(spec[3]))
        self.block = parent.block

    @property
    def input_arg_names(self):
        return [n for v in self.inputs.values() for n in v]

    @property
    def output_arg_names(self):
        return [n for v in self.outputs.values() for n in v]


def _sub_ops(op):
    return [_SubOp(op, spec) for spec in op.attrs.get('sub_ops') or ()]
