"""Executor / Scope.

Counterpart of paddle_tpu/executor.py (``Scope``, ``global_scope``,
``scope_guard``, ``Executor.run``). The JAX Executor compiles a whole
block into one XLA program and caches it; this one prunes the program to
its fetches once per program version and then runs the block eagerly, op
by op, on the place's device. Persistable state (parameters) stays on
that device in the Scope between runs.

After the prune, the program goes through the port's compiler pipeline
(``compiler.optimize``: the default passes), once per memo key, as the
JAX Executor's ``_optimized_program`` does; the key folds in
``compiler.cache_token``: the pipeline and the tuning cache's entry for
the program at these feed shapes on this device, so a change of either
misses once and never serves a stale program. A lowered program runs
under its tuning entry's knobs (``compiler.tuning.apply_entry``). The
memo is guarded by a lock (the serving runtime's worker threads share
one Executor) and counted (``cache_info``).

The static analysis runs as in the JAX Executor: every run checks the
RAW feed against the declared variables
(``analysis.check_feeds_for_executor``: a rank or dtype-kind mismatch
raises ``FeedInvalid`` naming the slot, before the feed is cast), and a
memo miss verifies the program (``analysis.verify_for_executor``: a
mis-wired program raises ``ProgramInvalid`` naming the op) before the
prune, the passes and the lowering. Both are memoized per program
fingerprint, so a steady-state hit pays one lookup of the feed's
signature; ``PTPU_VERIFY=0`` or ``analysis.set_enabled(False)`` turns
them off.

A dynamic program (``_is_dynamic_program``: a While whose body runs
beam search, reached by a 2-level LoD feed, the reference's dynamic beam
decode) runs as the JAX Executor runs it eagerly: its 2-level feeds
given as packed rows with an offset LoD (``LoDTensor.set`` /
``set_lod``) stay packed on the device, its level-1 feeds stay padded,
and it skips the verify and the passes (which assume the whole block's
shapes). A packed fetch comes back a packed SequenceTensor with its LoD.

A program that binds a reader (``layers.open_files`` ... ``read_file``)
gets its slots filled by the Executor, as the JAX Executor's
``_pull_program_readers`` does: a batch is pulled only for a reader whose
slots this run consumes after the prune to the fetches; the stream state
lives per Scope, keyed by the reader object, and ``reader.reset()``
restarts it; the end of the stream raises ``core.EOFException`` and stays
so until a reset; a feed of some of a reader's slots but not all raises
``ValueError``. A batch that ``double_buffer(place=CUDAPlace(0))``
staged on the card is taken as it is (the stream waits on its staging
event); ``FEED_COPIES`` counts the values the Executor itself copies from
the host to the card.

``run(async_fetch=True)`` returns the fetches as tensors on the device,
with no copy to the host and no wait (``as_numpy`` materializes them);
a fetch of a persistable is a copy, so it keeps its step's value
whatever a later step writes into the Scope's tensor. ``run_chained``
runs K steps in one call and returns K fetch lists, bit-equal to K
``run`` calls: the port has no scan, so a chain is always the K runs
in order (the JAX Executor's sequential fallback). An installed
``resilience.AnomalyGuard`` (``executor_guard``) sees every run's
fetches. A program marked by the ``Float16Transpiler`` takes f32 feeds
cast to its half dtype and gives its fetches back in f32; one marked by
``memory_optimize`` trains through checkpointed segments.

Telemetry, with the JAX Executor's names: the registry series
``executor_cache_{hits,misses}_total``, ``executor_cache_hit_rate``,
``executor_run_seconds`` and ``executor_compile_seconds`` (here the
verify, prune, passes and lowering of a memo miss); the journal events
``compile_begin`` / ``compile_end`` and ``exe_run``; and, under an
active parent span (a serving batch), the spans ``exe/run`` with its
children ``exe/verify`` and ``exe/compile`` (a miss), ``exe/dispatch``
and ``exe/fetch``. Spans measure host time: on the card
``exe/dispatch`` ends when the kernels are enqueued, and the wait for
the device falls in ``exe/fetch`` (the copy to the host).

An Executor given a data-parallel ``partition.Partitioner`` (as
``ParallelExecutor`` makes one) over a group of more than one rank: each run
takes the GLOBAL feed and keeps this rank's rows
(``Partitioner.shard_feed``); the memo key and the cold-start store's
key fold in the partitioner's ``cache_token`` and the cut feeds, so a dp
program never hits a single-device entry; the lowered program is the
one the partitioner planned (``plan_program``: its batch reductions
global, any op that would give a per-rank answer refused); and fetches
come back global: a value cut to this rank's rows and a ZeRO-sliced
accumulator are all-gathered, a batch reduction is already the global
one.
"""
import collections
import contextlib
import threading
import time

import numpy as np
import torch

from . import analysis as _analysis
from . import compiler as _compiler
from . import observability as _obs
from .observability import perf as _perf
from .framework import (Program, Variable, _op_reads, _op_writes,
                        default_main_program)
from .lod import SequenceTensor
from .core import places as _places
from .core.lowering import (lower_block, torch_dtype, RNG_KEY, RNG_CPU_KEY,
                            SHAPE_INPUT_SLOTS)
from .core.registry import SIDE_EFFECT_OPS
from .ops.common import rewrap
from .resilience import anomaly as _anomaly

__all__ = ['Executor', 'Scope', 'VarBinding', 'global_scope', 'scope_guard',
           'switch_scope', 'as_numpy', 'fetch_var', 'CacheInfo']

# values the Executor copied from the host to a CUDA device: feeds (a
# numpy array or a CPU tensor, a sequence's lengths included) and Scope
# values set from the host; process-wide
FEED_COPIES = {'host_to_device': 0}


def _coldstart_store():
    """The active cold-start store, or None with the ``PTPU_AOT_CACHE``
    gate closed, or where a pass of the pipeline writes into the Scope
    (BN folding): a stored program of such a pipeline would run on
    weights the fresh replica never folded. The fleet package imports
    serving, which imports this module, so the reach into
    fleet.coldstart is made at run time; with the gate closed and the
    module never imported (no ``cache_scope`` can be open), one
    environment read answers."""
    import os
    import sys
    mod = sys.modules.get('paddle_tpu_torch.fleet.coldstart')
    if mod is None:
        if not os.environ.get('PTPU_AOT_CACHE'):
            return None
        from .fleet import coldstart as mod
    if _compiler.pipeline_writes_scope():
        return None
    return mod.default_store()


# memo counters of one Executor: hits, misses (each one a prune, the
# passes and a lowering), entries it made
CacheInfo = collections.namedtuple('CacheInfo', ['hits', 'misses', 'size'])


class VarBinding(object):
    """Live handle to a Scope slot, the counterpart of
    ``paddle_tpu.executor.VarBinding`` (the runtime ``Variable`` that
    ``Scope::FindVar`` returns): reference scripts write pretrained
    parameters through ``find_var(name).get_tensor().set(np, place)``
    (book/test_label_semantic_roles.py:204-208). Reads delegate to the
    slot's current value (``shape``, ``dtype``, ``device`` ...).

    ``set`` puts a NEW tensor in the slot, on ``place``'s device (the
    current value's device, or the host, without one) and in the stored
    value's dtype (the array's own without one, float64 as float32 as in
    the JAX package): the next ``Executor.run`` reads the Scope, and
    caches keyed on a tensor's identity (the fused conv's re-laid-out
    weight) miss on the new one."""

    __slots__ = ('_scope', '_name')

    def __init__(self, scope, name):
        object.__setattr__(self, '_scope', scope)
        object.__setattr__(self, '_name', name)

    def value(self):
        return self._scope.raw(self._name)

    def get_tensor(self):
        return self

    def set(self, array, place=None):
        val = self.value()
        if isinstance(val, SequenceTensor):
            val.set(array, place)
            return
        if isinstance(array, torch.Tensor):
            t = array.detach()
        else:
            arr = np.asarray(array)
            if arr.dtype == np.float64:
                arr = arr.astype(np.float32)
            t = torch.from_numpy(np.ascontiguousarray(arr))
        if place is not None:
            device = place.torch_device()
        elif isinstance(val, torch.Tensor):
            device = val.device
        else:
            device = t.device
        dtype = val.dtype if isinstance(val, torch.Tensor) else t.dtype
        if device.type == 'cuda' and not t.is_cuda:
            FEED_COPIES['host_to_device'] += 1
        # a copy, never a view of the caller's array
        t = t.to(device=device, dtype=dtype, copy=True)
        (self._scope.holder(self._name) or self._scope).set_var(
            self._name, t)

    def lod(self):
        val = self.value()
        return val.lod() if isinstance(val, SequenceTensor) else []

    def __array__(self, dtype=None, copy=None):
        arr = np.asarray(as_numpy(self.value()))
        return arr.astype(dtype) if dtype is not None else arr

    def __getattr__(self, attr):
        return getattr(self.value(), attr)

    def __repr__(self):
        return "VarBinding(%r -> %r)" % (self._name, self.value())


class Scope(object):
    """name -> runtime value (a torch tensor, or the scope's
    ``torch.Generator`` under ``RNG_KEY`` and its host generator under
    ``RNG_CPU_KEY``). ``find_var`` and ``var`` hand out live
    ``VarBinding`` handles; internal fast paths read ``raw``."""

    def __init__(self, parent=None):
        self.vars = {}
        self.parent = parent

    def holder(self, name):
        """The Scope on this one's parent chain that holds ``name``."""
        s = self
        while s is not None:
            if name in s.vars:
                return s
            s = s.parent
        return None

    def raw(self, name):
        s = self.holder(name)
        return None if s is None else s.vars[name]

    def find_var(self, name):
        """A live ``VarBinding`` of ``name``, or None where no Scope on
        the chain has the slot or the slot holds None: callers test
        ``find_var(...) is not None``."""
        return None if self.raw(name) is None else VarBinding(self, name)

    def var(self, name):
        """Declare the slot in this Scope (as ``Scope::Var`` does) and
        hand out its binding, before any value lands in it: the
        reference's ``scope.var(n)`` then ``...get_tensor().set(...)``."""
        self.vars.setdefault(name, None)
        return VarBinding(self, name)

    def set_var(self, name, value):
        self.vars[name] = value

    def new_scope(self):
        return Scope(parent=self)

    def drop_kids(self):
        """The reference frees its child scopes here; a child holds no
        reference from its parent, so there is nothing to drop."""

    def keys(self):
        return self.vars.keys()


_global_scope = Scope()


def global_scope():
    return _global_scope


def switch_scope(scope):
    global _global_scope
    prev = _global_scope
    _global_scope = scope
    return prev


@contextlib.contextmanager
def scope_guard(scope):
    prev = switch_scope(scope)
    try:
        yield
    finally:
        switch_scope(prev)


def _to_f32_fetch(t):
    """Half-precision fetches come back float32, the JAX Executor's
    ``_to_f32_fetch`` boundary; numpy has no bfloat16 either. A
    SequenceTensor keeps its lengths."""
    if isinstance(t, SequenceTensor):
        return rewrap(t, _to_f32_fetch(t.data))
    if t.dtype in (torch.bfloat16, torch.float16):
        return t.float()
    return t


def _host(t):
    if t is None or isinstance(t, np.ndarray):
        return t
    return t.detach().cpu().numpy()


def _spec(value):
    """(shape, dtype) of a prepared feed, a SequenceTensor's by its
    padded data."""
    if isinstance(value, SequenceTensor):
        if value.packed_mode:
            return _spec(value.data) + ('packed', len(value._offsets))
        return _spec(value.data) + ('lod',)
    return (tuple(value.shape), str(value.dtype).replace('torch.', ''))


def feed_signature(feed):
    """The sorted ``(name, (shape, dtype))`` pairs of a prepared feed:
    what the tuning cache keys a program's shapes by."""
    return tuple(sorted((n, _spec(v)) for n, v in feed.items()))


def as_numpy(value):
    """A fetched tensor as a host numpy array (half floats as f32). A
    fetched sequence keeps its structure, as in the JAX package: a
    SequenceTensor of host arrays, its ``data`` the padded [B, T_pad,
    ...] array (``np.asarray`` of it gives the packed rows); a packed
    one keeps its rows and offset LoD. A ``VarBinding`` gives its
    slot's value."""
    if isinstance(value, VarBinding):
        value = value.value()
    if isinstance(value, SequenceTensor):
        data = as_numpy(value.data)
        if value.packed_mode:
            return rewrap(value, data)
        return SequenceTensor(data, _host(value.lengths),
                              _host(value.sub_lengths))
    return _host(_to_f32_fetch(value))


def fetch_var(name, scope=None, return_numpy=True):
    """The value of ``name`` in ``scope`` (the global scope by default):
    a host numpy array (half floats as f32) that is a copy, never a
    view of the Scope's tensor, or with ``return_numpy=False`` the
    stored value itself. None when the name holds nothing."""
    val = (scope or global_scope()).raw(name)
    if val is None or not return_numpy:
        return val
    if isinstance(val, torch.Tensor) and val.device.type == 'cpu':
        val = val.detach().clone()
    elif isinstance(val, np.ndarray):
        val = val.copy()
    return as_numpy(val)


def _block_has(block, types):
    for op in block.ops:
        if op.type in types:
            return True
        sub = op.attrs.get('sub_block')
        if sub is not None and _block_has(sub, types):
            return True
    return False


def _is_dynamic_program(program):
    """True when a While's body runs beam search AND a 2-level LoD feed
    reaches that While (the reference decode's init_ids / init_scores):
    the beams' row counts then change step by step, so the program runs
    in the dynamic mode, packed rows and host LoD lists, as the JAX
    Executor runs it eagerly. A static-beam decode ([B*K] dense rows, no
    2-level feed) is not dynamic. Only the variables that reach a beam
    While count: a nested-sequence feed elsewhere does not."""
    beam_whiles = [op for b in program.blocks for op in b.ops
                   if op.type == 'while' and op.attrs.get('sub_block')
                   is not None and _block_has(op.attrs['sub_block'],
                                              ('beam_search',))]
    if not beam_whiles:
        return False
    producers = {}
    for b in program.blocks:
        for op in b.ops:
            for n in op.output_arg_names:
                producers.setdefault(n, []).append(op)
    gb = program.global_block()
    for w_op in beam_whiles:
        seen, frontier = set(), list(_op_reads(w_op))
        while frontier:
            n = frontier.pop()
            if n in seen:
                continue
            seen.add(n)
            var = gb._find_var_recursive(n)
            if var is not None and getattr(var, 'is_data', False) and \
                    getattr(var, 'lod_level', 0) >= 2:
                return True
            for p in producers.get(n, ()):
                if p is not w_op:
                    # a producing control-flow op may read the feed
                    # only inside its sub-block
                    frontier.extend(_op_reads(p))
    return False


def is_dynamic(program):
    """``_is_dynamic_program``, memoized per program fingerprint."""
    memo = program.__dict__.setdefault('_dynamic_memo', {})
    fp = program.fingerprint()
    if fp not in memo:
        memo[fp] = _is_dynamic_program(program)
    return memo[fp]


class Executor(object):
    """Runs Programs on one device: forward programs without autograd,
    training programs (with a backward marker) through the lowering's
    training branch, which updates parameters and accumulators in the
    Scope on the device.

    ``place`` defaults to ``CUDAPlace(0)``, or with a ``partitioner`` to
    the card of its device's index; on a host without CUDA that raises
    here, at construction. Pass ``CPUPlace()`` to run on the CPU.
    """

    def __init__(self, place=None, partitioner=None):
        if place is None:
            index = partitioner.device.index if partitioner is not None \
                else None
            place = _places.CUDAPlace(index or 0)
        self.place = place
        self.device = self.place.torch_device()
        self._partitioner = partitioner
        # serving worker threads share one Executor: the lock makes the
        # memo's lookup and insert atomic
        self._cache_lock = threading.RLock()
        self._cache_hits = 0
        self._cache_misses = 0
        self._cache_size = 0
        # process-wide telemetry: every Executor publishes into the same
        # registry series; the per-instance ints above stay the
        # per-Executor cache_info() the serving runtime reads
        reg = _obs.default_registry()
        self._m_hits = reg.counter(
            'executor_cache_hits_total',
            'program memo hits across all Executors')
        self._m_misses = reg.counter(
            'executor_cache_misses_total',
            'program memo misses (each one a prune, the passes and a '
            'lowering)')
        self._m_hit_rate = reg.gauge(
            'executor_cache_hit_rate',
            'process-wide cache hits / lookups')
        self._m_run = reg.histogram(
            'executor_run_seconds',
            'Executor.run wall of the lowered program (host; the card '
            'may still be running)')
        self._m_compile = reg.histogram(
            'executor_compile_seconds',
            'prune + passes + lowering wall per memo miss')

    def cache_info(self):
        """Memo counters: a serving-layer SLI. A miss means a fresh
        prune, pass pipeline and lowering; warmup exists to keep this at
        one miss per (program, feeds, fetches)."""
        with self._cache_lock:
            return CacheInfo(self._cache_hits, self._cache_misses,
                             self._cache_size)

    def reset_cache_info(self):
        """Zero the hit/miss counters without dropping memo entries, so
        phases can be measured independently."""
        with self._cache_lock:
            self._cache_hits = 0
            self._cache_misses = 0

    # -------------------------------------------------------------------------
    def _to_device(self, val, var, half=None):
        """``val`` on this device in ``var``'s runtime dtype; with
        ``half`` (a Float16Transpiler's dtype) an f32 value goes in
        half."""
        if self.device.type == 'cuda' and not (
                isinstance(val, torch.Tensor) and val.is_cuda):
            FEED_COPIES['host_to_device'] += 1
        if isinstance(val, torch.Tensor):
            dt = torch_dtype(var.dtype) if var is not None else val.dtype
        else:
            val = np.asarray(val)
            dt = torch_dtype(var.dtype if var is not None else val.dtype)
        if half and dt == torch.float32:
            dt = torch_dtype(half)
            if isinstance(val, np.ndarray) and val.dtype == np.float32:
                # copied as f32 and cast on the device: the host's cast of
                # an image batch costs milliseconds
                val = torch.tensor(val, device=self.device)
        if isinstance(val, torch.Tensor):
            return val.to(device=self.device, dtype=dt)
        return torch.tensor(val, dtype=dt, device=self.device)

    def _state_value(self, scope, name, var):
        """A Scope value as the lowered block takes it: a tensor on this
        Executor's device. A value set from the host (a numpy array, as
        the reference's scripts set parameters) becomes one in its
        variable's runtime dtype, and a tensor another Executor left on
        another device moves here, so one Scope serves a CPU and a CUDA
        Executor. What was made goes back into the Scope that held the
        value, so the next run on this device moves nothing."""
        val = scope.raw(name)
        if isinstance(val, torch.Tensor):
            if val.device == self.device:
                return val
            moved = val.to(self.device)
        elif val is None or isinstance(val, SequenceTensor) or \
                isinstance(val, (dict, list)):
            return val
        else:
            moved = self._to_device(val, var)
        scope.holder(name).set_var(name, moved)
        return moved

    def _lengths(self, lengths):
        if lengths is None:
            return None
        if self.device.type == 'cuda' and not (
                isinstance(lengths, torch.Tensor) and lengths.is_cuda):
            FEED_COPIES['host_to_device'] += 1
        if isinstance(lengths, torch.Tensor):
            return lengths.to(device=self.device, dtype=torch.int64)
        return torch.tensor(np.asarray(lengths), dtype=torch.int64,
                            device=self.device)

    def _prepare_feed(self, program, feed, dynamic=False):
        """Each feed on the place's device in its variable's runtime
        dtype. A SequenceTensor (``create_lod_tensor`` output, or one
        already on the device) keeps its structure: its data and its
        lengths (int64) move to the device. As in the JAX Executor, a
        LoDTensor with rows but no LoD, or one fed to a variable declared
        dense (``lod_level`` 0), is fed as its plain rows. In a dynamic
        program a 2-level feed with packed rows (``set`` / ``set_lod``)
        stays packed, its rows on the device and its LoD on the host."""
        block = program.global_block()
        half = getattr(program, '_half_inference', None)
        out = {}
        for name, val in feed.items():
            var = block._find_var_recursive(name)
            if dynamic and isinstance(val, SequenceTensor) and \
                    val._rows is not None and val._offsets and \
                    len(val._offsets) >= 2:
                out[name] = SequenceTensor.from_packed(
                    self._to_device(val._rows, var, half), val._offsets)
                continue
            if isinstance(val, SequenceTensor) and (
                    val.lengths is None or (
                        val._rows is not None and var is not None and
                        not getattr(var, 'lod_level', 0))):
                val = val.data if val.lengths is None else val._rows
            if isinstance(val, SequenceTensor):
                out[name] = SequenceTensor(
                    self._to_device(val.data, var, half), self._lengths(
                        val.lengths), self._lengths(val.sub_lengths))
            else:
                out[name] = self._to_device(val, var, half)
        return out

    @staticmethod
    def _state_names(program, scope):
        names_in, names_out = set(), set()
        for b in program.blocks:
            for v in b.vars.values():
                if v.persistable and scope.raw(v.name) is not None:
                    names_in.add(v.name)
            for op in b.ops:
                for n in op.output_arg_names:
                    var = b._find_var_recursive(n)
                    if var is not None and var.persistable:
                        names_out.add(n)
        return sorted(names_in), sorted(names_out | names_in)

    @staticmethod
    def _maybe_prune(program, fetch_names):
        """Inference-style programs run only the ancestors of the fetches
        and of persistable-state writes, those in loop and branch bodies
        included (``Program.prune`` follows sub-blocks)."""
        if not fetch_names:
            return program
        block = program.global_block()
        persist_outs = []
        for op in block.ops:
            sub = op.attrs.get('sub_block')
            if op.type in SIDE_EFFECT_OPS or (
                    sub is not None and _block_has(sub, SIDE_EFFECT_OPS)):
                # a training step or a host side effect: the whole block
                # runs
                return program
            for n in _op_writes(op):
                var = block._find_var_recursive(n)
                if var is not None and var.persistable:
                    persist_outs.append(n)
        return program.prune(list(fetch_names) + persist_outs)

    def _pull_program_readers(self, program, feed, scope, consume=True,
                              fetch_names=None):
        """The feed with each bound program reader's next batch in its
        slots: the counterpart of the reference's ``read`` op pulling
        from its ReaderHolder (paddle/fluid/operators/read_op.cc) and of
        the JAX Executor's method of this name.

        Only a reader whose slot variables this run consumes is pulled:
        an input of an op that survives the prune to the fetches, or a
        fetch itself (memoized per fingerprint and fetch set). A reader
        bound in the same program but not consumed (a test reader built
        beside the train one) is never drained. Stream state (iterator,
        peeked batch, sticky EOF) lives per Scope, keyed by the reader
        object; ``reader.reset()`` bumps its generation, so every scope
        restarts. ``consume=False`` peeks: the batch is stashed and
        handed to the next consuming run. Raises ``core.EOFException`` at
        the end of the stream and again until ``reset()``."""
        from .layers.io import ReaderVar
        readers = [v for v in program.global_block().vars.values()
                   if isinstance(v, ReaderVar)
                   and getattr(v, 'source', None) is not None]
        if not readers:
            return feed
        consumed = program.__dict__.setdefault('_consumed_memo', {})
        key = (program.fingerprint(),
               tuple(sorted(fetch_names)) if fetch_names else None)
        used = consumed.get(key)
        if used is None:
            src_prog = self._maybe_prune(program, list(fetch_names or []))
            used = set(fetch_names or [])
            for blk in src_prog.blocks:
                for op in blk.ops:
                    used.update(op.input_arg_names)
            consumed[key] = used
        readers = [rv for rv in readers
                   if any(fv.name in used for fv in rv.feed_vars)]
        if not readers:
            return feed
        # keyed by the reader OBJECT (generated names can repeat across
        # programs that share a scope); the entry pins rv, so its id
        # stays unique for the scope's lifetime
        states = scope.__dict__.setdefault('_reader_states', {})
        feed = dict(feed)
        for rv in readers:
            names = [fv.name for fv in rv.feed_vars]
            fed = [n for n in names if n in feed]
            if len(fed) == len(names):
                continue
            if fed:
                raise ValueError(
                    'program reader %s: slots %s were fed but %s were '
                    'not; feed all of a reader\'s slots or none (a '
                    'partial feed would pair your data with an '
                    'unrelated pulled batch)' % (
                        rv.name, fed, [n for n in names if n not in feed]))
            from .core import EOFException
            gen = rv.__dict__.get('_generation', 0)
            st = states.get(id(rv))
            if st is None or st['gen'] != gen:
                from .reader_io import iterate_reader
                st = states[id(rv)] = {
                    'rv': rv, 'gen': gen, 'iter': iterate_reader(rv),
                    'pending': None, 'eof': False}
            if st['eof']:
                raise EOFException(
                    'program reader %s is exhausted; call '
                    'reader.reset() to restart it' % rv.name)
            if st['pending'] is not None:
                batch = st['pending']
                if consume:
                    st['pending'] = None
            else:
                try:
                    batch = next(st['iter'])
                except StopIteration:
                    st['eof'] = True      # sticky, like ReaderHolder
                    raise EOFException(
                        'program reader %s is exhausted; call '
                        'reader.reset() to restart it' % rv.name) from None
                if not consume:
                    st['pending'] = batch
            for n, val in zip(names, batch):
                feed[n] = val
        return feed

    @staticmethod
    def _extract_static_feeds(program, feed):
        """``(feed, static_env)``: the feeds read only through
        shape-defining input slots (``SHAPE_INPUT_SLOTS``: reshape's
        ``Shape``) leave the feed as host numpy values (one read of a
        device tensor), which the lowering bakes in and the memo keys
        on, as paddle_tpu's ``_extract_static_feeds`` does. The names
        are memoized per program fingerprint."""
        memo = program.__dict__.setdefault('_shape_feed_memo', {})
        fp = program.fingerprint()
        names = memo.get(fp)
        if names is None:
            shape_only, data_used = set(), set()
            for blk in program.blocks:
                for op in blk.ops:
                    for slot, vals in (op.inputs or {}).items():
                        vals = vals if isinstance(vals, (list, tuple)) \
                            else [vals]
                        for v in vals:
                            n = getattr(v, 'name', v)
                            if (op.type, slot) in SHAPE_INPUT_SLOTS:
                                shape_only.add(n)
                            else:
                                data_used.add(n)
            names = memo[fp] = frozenset(shape_only - data_used)
        hits = names & set(feed)
        if not hits:
            return feed, {}
        feed = dict(feed)
        return feed, {n: np.asarray(as_numpy(feed.pop(n))) for n in hits}

    def _lowered(self, program, fp, feed, fetch_names, scope, tspan,
                 dynamic=False, static_env=None, cut=frozenset()):
        """``(fn, state_in, gathers, missed)``: the runnable block for (program
        version, feeds, fetches, state names, device, the compiler's
        token), memoized on the program so steady-state requests skip
        the verify, the prune, the passes and the graph rewrite. On a
        miss the program is verified first (``ProgramInvalid`` before
        any lowering), then the tuning entry for (program, feed shapes,
        device) is looked up and the lowered function runs under its
        knobs. A dynamic program skips the verify and the passes, as in
        the JAX Executor: both assume the whole block's shapes, which
        change from step to step there."""
        state_in, state_out = self._state_names(program, scope)
        feed_names = sorted(feed)
        feed_sig = feed_signature(feed)
        token = _compiler.cache_token(fp, feed_sig, self.device)
        static_env = static_env or {}
        part = self._partitioner
        part = part if part is not None and part.active else None
        if part is not None and dynamic:
            raise NotImplementedError(
                'a dynamic (beam-search) program under data parallelism '
                'is not ported yet (ROADMAP Queue A item 6)')
        key = (program._version, tuple(feed_names), tuple(fetch_names),
               tuple(state_in), tuple(state_out), self.device, token,
               tuple(sorted((n, v.dtype.str, v.shape, v.tobytes())
                            for n, v in static_env.items())),
               None if part is None else (part.cache_token(program),
                                          tuple(sorted(cut))))
        with self._cache_lock:
            memo = program.__dict__.setdefault('_torch_lowered', {})
            hit = memo.get(key)
            if hit is not None:
                self._cache_hits += 1
                return hit + (False,)
            self._cache_misses += 1
        # the verify, the prune, the passes and the lowering run outside
        # the lock, so one program's cold lowering never stalls another's
        # hits; two threads that miss on one key both lower, the first
        # insert wins
        store = None if dynamic else _coldstart_store()
        pruned = None
        if store is not None:
            # the cold-start store (fleet/coldstart.py): the memo key's
            # content, the program's fingerprint for its version
            pkey = (fp,) + key[1:]
            entry = store.load(pkey, self.device)
            if entry is not None:
                from .io import program_from_json
                try:
                    pruned = program_from_json(entry['program'])
                except (KeyError, TypeError, ValueError):
                    store.m_failures.inc()
        if pruned is None:
            if not dynamic:
                t_verify = time.perf_counter()
                _analysis.verify_for_executor(
                    program, feed_names=feed_names + sorted(static_env),
                    fetch_names=fetch_names)
                if tspan is not None:
                    _obs.emit_span('exe/verify',
                                   time.perf_counter() - t_verify,
                                   parent=tspan)
            _obs.emit('compile_begin', fp=fp)
            pruned = self._maybe_prune(program, fetch_names)
            if token != ('off',) and not dynamic:
                pruned, _ = _compiler.optimize(
                    pruned, fetch_names=fetch_names, scope=scope,
                    clone=pruned is program)
                if _compiler.pipeline_writes_scope():
                    # the passes wrote state into the Scope (bn_fold's
                    # folded weights and fold bias): the prepared
                    # program's state names
                    state_in, state_out = self._state_names(pruned, scope)
            if store is not None:
                from .io import program_to_json
                store.save(pkey, {'program': program_to_json(pruned)},
                           self.device)
        gathers = {}
        if part is not None:
            pruned = part.plan_program(pruned, cut, clone=pruned is program)
            from .compiler import zero as _zero
            sliced = _zero.sliced_state_dims(pruned, part.device_count,
                                             persistable=False)
            gblock = pruned.global_block()
            for i, n in enumerate(fetch_names):
                if n in pruned._dp_cut:
                    gathers[i] = (0, None)
                elif n in sliced:
                    gathers[i] = (sliced[n], int(
                        gblock._find_var_recursive(n).shape[sliced[n]]))
        fn = lower_block(pruned, pruned.global_block(), feed_names,
                         fetch_names, state_in, state_out, self.device,
                         dynamic, bool(getattr(program, '_remat', False)),
                         static_env)
        if token != ('off',):
            tuning = _compiler.tuning
            fn = tuning.wrap_lowered(fn, tuning.default_cache().lookup(
                fp, tuning.shape_signature(feed_sig),
                tuning.backend(self.device)))
        with self._cache_lock:
            if key not in memo:
                self._cache_size += 1
            return memo.setdefault(key, (fn, state_in, gathers)) + (True,)

    def run(self, program=None, feed=None, fetch_list=None,
            feed_var_name='feed', fetch_var_name='fetch', scope=None,
            return_numpy=True, use_program_cache=True, async_fetch=False):
        """One run of ``program``. ``async_fetch=True`` returns the
        fetches as device tensors (half floats as f32) without a copy to
        the host or a wait, whatever ``return_numpy`` says; an installed
        AnomalyGuard still reads every fetch."""
        if program is None:
            program = default_main_program()
        if not isinstance(program, Program):
            raise TypeError("Executor requires Program as its Parameter. But "
                            "you passed in %s" % type(program))
        # the RAW feed: _prepare_feed casts to the declared dtype, which
        # would hide the mismatches the check names
        _analysis.check_feeds_for_executor(program, feed)
        fetch_names = [f.name if isinstance(f, Variable) else f
                       for f in (fetch_list or [])]
        scope = scope or global_scope()
        # a bound reader's batch joins the feed before the verify, the
        # prune and the lowering see it
        feed = self._pull_program_readers(program, feed or {}, scope,
                                          fetch_names=fetch_names)
        dynamic = is_dynamic(program)
        feed, static_env = self._extract_static_feeds(program, feed)
        cut = frozenset()
        part = self._partitioner
        if part is not None and part.active:
            # the global feed: this rank keeps its rows
            feed, cut = part.shard_feed(feed)
        feed = self._prepare_feed(program, feed, dynamic=dynamic)
        for key, device in ((RNG_KEY, self.device),
                            (RNG_CPU_KEY, torch.device('cpu'))):
            if scope.raw(key) is None:
                gen = torch.Generator(device=device)
                gen.manual_seed(program.random_seed or 0)
                scope.set_var(key, gen)
        fp = program.fingerprint()
        # traced only under an active parent span (a serving batch):
        # bare runs stay span-free, and the untraced cost is one
        # thread-local read
        pctx = _obs.current_context()
        if pctx is None:
            return self._run(program, fp, feed, fetch_names, scope,
                             return_numpy, None, dynamic, async_fetch,
                             static_env, cut)
        tspan = _obs.start_span('exe/run', parent=pctx, activate=False,
                                fp=fp)
        try:
            out = self._run(program, fp, feed, fetch_names, scope,
                            return_numpy, tspan, dynamic, async_fetch,
                            static_env, cut)
        except BaseException as e:
            tspan.end(error=type(e).__name__)
            raise
        tspan.end()
        return out

    def run_chained(self, program=None, feed_list=None, fetch_list=None,
                    scope=None, return_numpy=True, async_fetch=False):
        """K steps in one call, one per feed of ``feed_list``; returns K
        fetch lists, bit-equal to K ``run`` calls (they are K runs in
        order: the port has no scan to chain them into one dispatch). A
        program with a bound reader pulls one batch a step, as K runs
        would (the JAX Executor falls back to its sequential path
        there)."""
        return [self.run(program, feed=f, fetch_list=fetch_list,
                         scope=scope, return_numpy=return_numpy,
                         async_fetch=async_fetch)
                for f in (feed_list or [])]

    def _run(self, program, fp, feed, fetch_names, scope, return_numpy,
             tspan, dynamic=False, async_fetch=False, static_env=None,
             cut=frozenset()):
        t_lookup = time.perf_counter()
        fn, state_in, gathers, missed = self._lowered(
            program, fp, feed, fetch_names, scope, tspan, dynamic,
            static_env, cut)
        (self._m_misses if missed else self._m_hits).inc()
        if missed:
            compile_wall = time.perf_counter() - t_lookup
            self._m_compile.observe(compile_wall)
            _obs.emit('compile_end', fp=fp, dur_s=round(compile_wall, 6))
            if tspan is not None:
                _obs.emit_span('exe/compile', compile_wall, parent=tspan,
                               fp=fp)
        block = program.global_block()
        state = {n: self._state_value(scope, n,
                                      block._find_var_recursive(n))
                 for n in state_in}
        state[RNG_KEY] = scope.raw(RNG_KEY)
        state[RNG_CPU_KEY] = scope.raw(RNG_CPU_KEY)
        t_run = time.perf_counter()
        ledger = None
        if missed and not dynamic and _perf.capture_enabled():
            # the performance observatory: the miss's own run, its ops
            # counted and its memory read (observability/perf.py)
            fetches, new_state, ledger = _perf.capture_run(
                fn, feed, state, fp, self.device)
        else:
            fetches, new_state = fn(feed, state)
        run_wall = time.perf_counter() - t_run
        if ledger is not None:
            _perf.seal(ledger, compile_wall, trace=tspan.context
                       if tspan is not None else _obs.current_context())
        self._m_run.observe(run_wall)
        h, m = self._m_hits.value, self._m_misses.value
        self._m_hit_rate.set(h / (h + m) if h + m else 0.0)
        cache = 'miss' if missed else 'hit'
        if tspan is not None:
            _obs.emit_span('exe/dispatch', run_wall, parent=tspan,
                           cache=cache)
        if _obs.journal_active():
            _obs.emit('exe_run', cache=cache, fp=fp,
                      dur_s=round(run_wall, 6))
        for n, v in new_state.items():
            scope.set_var(n, v)
        if gathers:
            # global fetches: this rank's rows, or its ZeRO slice, joined
            # with the other ranks' in rank order
            from .parallel.collective import all_gather
            fetches = list(fetches)
            for i, (d, whole) in gathers.items():
                f = fetches[i]
                if whole is not None and (not isinstance(
                        f, torch.Tensor) or int(f.shape[d]) == whole):
                    continue
                if isinstance(f, SequenceTensor):
                    fetches[i] = SequenceTensor(
                        all_gather(f.data, axis=d),
                        all_gather(f.lengths, axis=d), None
                        if f.sub_lengths is None
                        else all_gather(f.sub_lengths, axis=d))
                elif isinstance(f, torch.Tensor):
                    fetches[i] = all_gather(f, axis=d)
        if _anomaly.any_active():
            _anomaly.observe_fetches(fetch_names, fetches)
        if async_fetch:
            # a persistable fetch is the Scope's own tensor: a copy keeps
            # this step's value
            return [_to_f32_fetch(f.clone() if n in new_state and
                                  isinstance(f, torch.Tensor) else f)
                    for n, f in zip(fetch_names, fetches)]
        if not return_numpy:
            return [_to_f32_fetch(f) for f in fetches]
        t_fetch = time.perf_counter()
        fetches = [as_numpy(f) for f in fetches]
        if tspan is not None:
            _obs.emit_span('exe/fetch', time.perf_counter() - t_fetch,
                           parent=tspan)
        return fetches
