"""The program verifier: dataflow + shape/dtype inference + sharding
consistency, with telemetry (ANALYSIS.md).

Counterpart of paddle_tpu/analysis/verifier.py, with the same switches
(``PTPU_VERIFY``, ``PTPU_VERIFY_PASSES``) and the same metric and
journal names.

``verify_program`` returns typed diagnostics; ``assert_valid`` turns
error severity into :class:`ProgramInvalid`. The executor-facing hooks
(``verify_for_executor`` / ``check_feeds_for_executor``) memoize per
program fingerprint so steady-state steps pay one dict lookup, and an
internal analyzer bug degrades to "no diagnostics" rather than taking a
training step down (only deliberate ``ProgramInvalid`` escapes).

Sharding checks reuse the partition layer as an ABSTRACT domain — the
same ``resolve_entry`` rules and ``first_divisible_dim`` divisibility
test the JAX package's Partitioner applies at run time, evaluated with
no mesh: an annotation that would silently degrade (or disagree with
``Partitioner.grad_shard_spec``) is flagged before any device exists.
The port reads a variable's ``sharding`` annotation where one was set
(the ZeRO pass's ``dp`` specs); its Partitioner
(``partition.Partitioner``) is data-parallel only.
"""
import os
import time

import numpy as np

from .. import observability as _obs
from ..framework import convert_np_dtype
from ..partition import first_divisible_dim
from ..partition.rules import standard_logical_axis_rules, resolve_entry
from .diagnostics import (Diagnostic, ProgramInvalid, FeedInvalid,
                          ERROR, WARNING, errors_of)
from .dataflow import analyze_dataflow
from .infer import infer_program, declared_info

__all__ = ['verify_program', 'assert_valid', 'check_sharding',
           'check_feeds', 'verify_for_executor',
           'check_feeds_for_executor', 'enabled', 'set_enabled',
           'verify_passes_enabled', 'observe']

_STATE = {'enabled': None}


def enabled():
    """Executor-path verification switch: default on; env
    ``PTPU_VERIFY=0`` or ``set_enabled(False)`` disables."""
    if _STATE['enabled'] is not None:
        return _STATE['enabled']
    return os.environ.get('PTPU_VERIFY', '1') not in ('0', 'off', '')


def set_enabled(on):
    """True/False force; None -> consult the PTPU_VERIFY env var."""
    _STATE['enabled'] = None if on is None else bool(on)


def verify_passes_enabled():
    """Default for ``PassPipeline(verify=None)``: the
    ``PTPU_VERIFY_PASSES=1`` sanitizer env switch (COMPILER.md)."""
    return os.environ.get('PTPU_VERIFY_PASSES', '') not in ('', '0')


def observe(phase, diagnostics, dur_s, **fields):
    """Publish one analysis application: per-severity
    ``analysis_diagnostics_total`` counters, the
    ``analysis_verify_seconds`` histogram, and an ``analysis`` journal
    event (OBSERVABILITY.md)."""
    reg = _obs.default_registry()
    reg.histogram('analysis_verify_seconds',
                  'wall seconds per static verifier application'
                  ).observe(dur_s)
    counts = {}
    for d in diagnostics:
        counts[d.severity] = counts.get(d.severity, 0) + 1
    for sev, n in counts.items():
        reg.counter('analysis_diagnostics_total',
                    'diagnostics produced by the static program '
                    'verifier', severity=sev).inc(n)
    _obs.emit('analysis', phase=phase, dur_s=round(dur_s, 6),
              errors=counts.get(ERROR, 0),
              warnings=counts.get(WARNING, 0), **fields)


# ---- sharding consistency (partition rules as abstract domain) -------------

def _abstract_axes():
    """Every mesh axis the standard rules may ever target plus the
    conventional names — the most permissive mesh, so the only way an
    entry resolves to None is a genuinely unknown axis."""
    axes = {'dp', 'mp', 'pp', 'sp'}
    for _logical, mesh_axis in standard_logical_axis_rules():
        if mesh_axis:
            axes.add(mesh_axis)
    return axes


def check_sharding(program):
    """Static sharding-spec validation with no mesh.

    - malformed spec entries (non-string, non-None) -> error;
    - specs longer than the var's known rank -> warning (resolve_spec
      truncates silently);
    - every ``zero_reduce_scatter`` bucket entry must agree with
      ``partition.first_divisible_dim`` — the ONE divisibility rule
      ``Partitioner.resolve_spec`` degrades by and
      ``grad_shard_spec`` chooses by; a mismatched dim or a
      non-dividing extent is an error (the annotation would silently
      degrade, or shard a different dim than the optimizer-state
      slicing assumes).
    """
    diags = []
    axes = _abstract_axes()
    rules = standard_logical_axis_rules()
    for b in program.blocks:
        for v in b.vars.values():
            spec = getattr(v, 'sharding', None)
            if spec is None:
                continue
            bad = [e for e in spec
                   if e is not None and not isinstance(e, str)
                   and not (isinstance(e, (tuple, list)) and all(
                       isinstance(a, str) for a in e))]
            if bad:
                diags.append(Diagnostic(
                    'shard-spec', ERROR,
                    "malformed sharding spec %r on %r: entries must be "
                    "axis names or None" % (spec, v.name),
                    block_idx=b.idx, var_names=[v.name]))
                continue
            info = declared_info(v)
            if info.shape is not None and len(spec) > len(info.shape):
                diags.append(Diagnostic(
                    'shard-rank', WARNING,
                    "sharding spec %r has %d entries but %r has rank "
                    "%d; resolve_spec will truncate"
                    % (spec, len(spec), v.name, len(info.shape)),
                    block_idx=b.idx, var_names=[v.name]))
            for e in spec:
                if e is not None and \
                        resolve_entry(e, axes, rules) is None:
                    diags.append(Diagnostic(
                        'shard-axis', WARNING,
                        "spec entry %r on %r names no mesh or logical "
                        "axis the partition rules know; it degrades to "
                        "replicated" % (e, v.name),
                        block_idx=b.idx, var_names=[v.name]))
    block = program.global_block()
    for i, op in enumerate(block.ops):
        if op.type != 'zero_reduce_scatter':
            continue
        dp = int(op.attrs.get('dp', 0) or 0)
        axis = op.attrs.get('axis_name', 'dp')
        names = op.inputs.get('X') or []
        dims = list(op.attrs.get('shard_dims') or [])
        for nm, d in zip(names, dims):
            var = block._find_var_recursive(nm)
            shape = declared_info(var).shape if var is not None else None
            if shape is None or any(s is None for s in shape):
                continue
            d = int(d)
            want = first_divisible_dim(shape, dp)
            if d >= len(shape) or dp <= 0 \
                    or int(shape[d]) % dp != 0:
                diags.append(Diagnostic(
                    'shard-spec', ERROR,
                    "grad shard for %r puts axis %r on dim %d of %s, "
                    "which %d-way sharding does not divide — "
                    "Partitioner.resolve_spec would silently degrade "
                    "it to replicated while the optimizer-state "
                    "slicing stays sharded" % (nm, axis, d, shape, dp),
                    op_index=i, op_type=op.type, var_names=[nm]))
            elif want != d:
                diags.append(Diagnostic(
                    'shard-spec', ERROR,
                    "grad shard for %r uses dim %d of %s but "
                    "Partitioner.grad_shard_spec (first_divisible_dim) "
                    "resolves the same tensor to dim %s — the "
                    "annotation conflicts with the partition rules"
                    % (nm, d, shape, want),
                    op_index=i, op_type=op.type, var_names=[nm]))
            spec = getattr(var, 'sharding', None)
            if spec is not None:
                canon = (None,) * d + (axis,)
                if tuple(spec) != canon:
                    diags.append(Diagnostic(
                        'shard-spec', ERROR,
                        "var %r is annotated %r but its "
                        "zero_reduce_scatter bucket shards dim %d "
                        "(expected %r)" % (nm, spec, d, canon),
                        op_index=i, op_type=op.type, var_names=[nm]))
    return diags


# ---- the combined verify ---------------------------------------------------

def verify_program(program, feeds=(), fetch_names=(), observe_as=None):
    """Run every static check; return the full diagnostic list (never
    raises). ``feeds`` are run-time-available names beyond data vars
    and persistable state; ``fetch_names`` gate reachability."""
    t0 = time.perf_counter()
    flow, diags = analyze_dataflow(program, feeds=feeds,
                                   protected=fetch_names)
    for nm in fetch_names or ():
        if nm not in flow.defs and nm not in flow.available:
            diags.append(Diagnostic(
                'fetch-unreachable', ERROR,
                "fetch target %r is produced by no op and is neither "
                "persistable state nor a data/feed var" % nm,
                var_names=[nm]))
    _env, infer_diags, stats = infer_program(program, feeds=feeds)
    diags.extend(infer_diags)
    diags.extend(check_sharding(program))
    dur = time.perf_counter() - t0
    if observe_as:
        observe(observe_as, diags, dur, ops=flow.num_ops,
                covered=stats['covered'])
    return diags


def assert_valid(program, feeds=(), fetch_names=(), observe_as='verify'):
    """``verify_program`` + raise :class:`ProgramInvalid` on any
    error-severity diagnostic."""
    diags = verify_program(program, feeds=feeds, fetch_names=fetch_names,
                           observe_as=observe_as)
    if errors_of(diags):
        raise ProgramInvalid(diags)
    return diags


# ---- feed validation -------------------------------------------------------

def _is_sequence_feed(val):
    return getattr(val, 'lengths', None) is not None \
        or getattr(val, '_rows', None) is not None


def check_feeds(program, feed):
    """Typed early feed validation: shape rank / known dims / dtype
    kind against declared var metadata, per feed slot. Sequence feeds
    (ragged) and scalar feeds are skipped; unknown (-1) dims match
    anything — exactly what the lowering can absorb."""
    diags = []
    block = program.global_block()
    for name, val in (feed or {}).items():
        var = block._find_var_recursive(name)
        if var is None or _is_sequence_feed(val) \
                or getattr(var, 'lod_level', 0):
            continue
        declared = declared_info(var)
        if not declared.shape:
            continue
        try:
            got = tuple(int(d) for d in np.shape(val))
        except Exception:
            continue
        if not got:
            continue  # scalar feeds broadcast
        # Paddle idiom: a (N,) feed into a (None, 1) label var (and the
        # reverse) is routine — trailing size-1 dims are layout, not
        # content, so strip them only as far as needed to reconcile rank.
        decl = list(declared.shape)
        fed = list(got)
        while len(decl) > len(fed) and decl and decl[-1] == 1:
            decl.pop()
        while len(fed) > len(decl) and fed and fed[-1] == 1:
            fed.pop()
        if len(fed) != len(decl):
            diags.append(Diagnostic(
                'feed-rank', ERROR,
                "feed slot %r: fed rank-%d value of shape %s but the "
                "var declares rank %d (%s)"
                % (name, len(got), got, len(declared.shape),
                   declared.shape), var_names=[name]))
            continue
        for i, (fd, dd) in enumerate(zip(fed, decl)):
            # WARNING, not error: lowering traces with the FED shape,
            # and data-dependent kernels (detection) legitimately feed
            # a different extent than the declared hint.
            if dd is not None and int(fd) != int(dd):
                diags.append(Diagnostic(
                    'feed-shape', WARNING,
                    "feed slot %r: dim %d is %d but the var declares "
                    "%d (declared %s, fed %s) — ops whose parameter "
                    "shapes were sized from the declaration will fail"
                    % (name, i, fd, dd, declared.shape, got),
                    var_names=[name]))
                break
        fed_dt = getattr(val, 'dtype', None)
        if fed_dt is not None and declared.dtype:
            try:
                fk = np.dtype(convert_np_dtype(fed_dt)).kind
                dk = np.dtype(convert_np_dtype(declared.dtype)).kind
            except TypeError:
                continue
            if fk == 'f' and dk in ('i', 'u'):
                diags.append(Diagnostic(
                    'feed-dtype', ERROR,
                    "feed slot %r: float data fed into %s var — the "
                    "boundary cast would silently truncate"
                    % (name, declared.dtype), var_names=[name]))
    return diags


# ---- executor hooks --------------------------------------------------------

def verify_for_executor(program, feed_names=(), fetch_names=()):
    """Cache-miss-path verify (Executor.run, before lowering): memoized
    per (fingerprint, feed names, fetch names); raises
    :class:`ProgramInvalid` on error diagnostics so the user sees a
    named op instead of a kernel's traceback."""
    if not enabled():
        return
    memo = program.__dict__.setdefault('_analysis_memo', {})
    key = (program.fingerprint(), tuple(sorted(feed_names or ())),
           tuple(sorted(fetch_names or ())))
    diags = memo.get(key)
    if diags is None:
        try:
            diags = verify_program(program, feeds=feed_names,
                                   fetch_names=fetch_names,
                                   observe_as='verify')
        except Exception:
            diags = []   # analyzer bug: never block the step
        memo[key] = diags
    if errors_of(diags):
        raise ProgramInvalid(diags)


def check_feeds_for_executor(program, feed):
    """Raise :class:`FeedInvalid` on a statically bad feed; memoized on
    the raw feed signature so steady-state steps skip the walk."""
    if not feed or not enabled():
        return
    memo = program.__dict__.setdefault('_feed_check_memo', set())
    try:
        sig = (program.fingerprint(), tuple(sorted(
            (n, tuple(np.shape(v)) if not _is_sequence_feed(v) else 'seq',
             str(getattr(v, 'dtype', '')))
            for n, v in feed.items())))
    except Exception:
        return
    if sig in memo:
        return
    try:
        diags = check_feeds(program, feed)
    except Exception:
        diags = []
    if errors_of(diags):
        observe('feed', diags, 0.0)
        raise FeedInvalid(diags)
    memo.add(sig)
