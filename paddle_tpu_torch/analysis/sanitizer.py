"""Pass-pipeline sanitizer: diff the verifier's facts across one
compiler pass and turn any regression into a named invariant violation
(ANALYSIS.md "Sanitizer invariants", COMPILER.md).

Counterpart of paddle_tpu/analysis/sanitizer.py, with the same
invariant names.

``snapshot`` captures a program's static facts; ``check_pass`` compares
them against the rewritten program and returns diagnostics whose
``pass_name``/``invariant`` fields name exactly what broke:

- ``def-use``: the rewrite introduced a use-before-def the original
  program did not have.
- ``protected-live``: a protected (fetch) name that was producible
  before the pass no longer is.
- ``side-effect-preserved``: the multiset of side-effecting / RNG /
  feed-fetch ops shrank (dead-op elim dropping a ``print``, or any
  pass eating an RNG consumer and shifting the stream).
- ``release-liveness``: a ``__release__`` annotation names a value a
  LATER op still reads, a protected fetch, persistable state, or the
  PRNG key (buffer_reuse starving a reader).
- ``read-order-hazard``: a surviving read now observes a different
  writer than before the pass (elementwise_fuse moving a member past
  an interloper write — the WAR/WAW hazard). Reads are attributed by
  (name, reader op type), with fused ops expanded through their
  ``sub_ops``; writers whose op type the pass itself introduced are
  exempt (a pass wiring its OWN ops in is the point of the pass).
- ``shape-stable``: a var fully shape-known on both sides changed
  shape.
- ``shard-spec``: a new sharding-consistency error appeared
  (zero_shard_grads emitting a spec that conflicts with
  ``Partitioner.resolve_spec`` / ``grad_shard_spec``).
"""
import time
from collections import Counter

from ..compiler.passes import (FUSED_ELEMENTWISE_OP, RNG_OPS,
                               _ALWAYS_KEEP)
from ..core.lowering import RNG_KEY
from ..core.registry import SIDE_EFFECT_OPS
from .diagnostics import Diagnostic, ERROR, PassVerificationError
from .dataflow import analyze_dataflow, op_reads, op_writes, last_reads
from .infer import infer_program
from .verifier import check_sharding, observe

__all__ = ['Snapshot', 'snapshot', 'check_pass', 'run_checked',
           'PassVerificationError']

_IN = '<live-in>'


def _effect_types():
    return frozenset(SIDE_EFFECT_OPS) | RNG_OPS | _ALWAYS_KEEP


def _events(program):
    """Per-name ordered access events over the global block, fused ops
    expanded to their members: (op_counts, read_map) where read_map is
    {(name, reader_type): Counter({reaching_writer_type: n})}."""
    block = program.global_block()
    per_name = {}
    op_counts = Counter()
    for op in block.ops:
        op_counts[op.type] += 1
        if op.type == FUSED_ELEMENTWISE_OP:
            members = []
            for t, ins, outs, _attrs in op.attrs.get('sub_ops', ()):
                members.append(
                    (t, [n for ns in ins.values() for n in ns],
                     [n for ns in outs.values() for n in ns]))
        else:
            members = [(op.type, op_reads(op), op_writes(op))]
        for t, reads, writes in members:
            for nm in reads:
                per_name.setdefault(nm, []).append(('R', t))
            for nm in writes:
                per_name.setdefault(nm, []).append(('W', t))
    read_map = {}
    for nm, events in per_name.items():
        writer = _IN
        for kind, t in events:
            if kind == 'W':
                writer = t
            else:
                read_map.setdefault((nm, t), Counter())[writer] += 1
    return op_counts, read_map


class Snapshot(object):
    """Static facts about one program, cheap to diff."""

    __slots__ = ('op_counts', 'read_map', 'effects', 'producible',
                 'undef_keys', 'shapes', 'shard_keys', 'protected')

    def __init__(self, program, protected=()):
        self.protected = frozenset(protected or ())
        self.op_counts, self.read_map = _events(program)
        eff = _effect_types()
        self.effects = Counter({t: n for t, n in self.op_counts.items()
                                if t in eff})
        flow, flow_diags = analyze_dataflow(program,
                                            protected=self.protected)
        self.producible = frozenset(flow.defs) | flow.available
        self.undef_keys = frozenset(
            (d.op_type, d.var_names) for d in flow_diags
            if d.code == 'use-before-def')
        env, _diags, _stats = infer_program(program)
        self.shapes = {nm: info.shape for nm, info in env.items()
                       if info.shape is not None
                       and all(d is not None for d in info.shape)}
        self.shard_keys = frozenset(
            (d.code, d.var_names, d.message)
            for d in check_sharding(program) if d.is_error)


def snapshot(program, protected=()):
    return Snapshot(program, protected)


def _violation(pass_name, invariant, message, **kw):
    return Diagnostic('pass-invariant', ERROR, message,
                      pass_name=pass_name, invariant=invariant, **kw)


def check_pass(pass_name, pre, program, protected=None):
    """Diff ``program`` (post-pass) against the ``pre`` Snapshot;
    return violation diagnostics (empty when the pass held every
    invariant)."""
    protected = frozenset(protected if protected is not None
                          else pre.protected)
    diags = []
    post = Snapshot(program, protected)
    block = program.global_block()

    for t, n in pre.effects.items():
        have = post.effects.get(t, 0)
        if have < n:
            diags.append(_violation(
                pass_name, 'side-effect-preserved',
                "pass removed %d %r op(s) (%d -> %d): side-effecting/"
                "RNG/feed-fetch ops must survive every rewrite"
                % (n - have, t, n, have), op_type=t))

    for nm in protected:
        if nm in pre.producible and nm not in post.producible:
            diags.append(_violation(
                pass_name, 'protected-live',
                "protected fetch %r was producible before the pass "
                "and no longer is" % nm, var_names=[nm]))

    for key in post.undef_keys - pre.undef_keys:
        op_type, names = key
        diags.append(_violation(
            pass_name, 'def-use',
            "pass introduced a use-before-def: %s now reads %s with "
            "no earlier definition" % (op_type, ', '.join(names)),
            op_type=op_type, var_names=names))

    last = last_reads(block)
    for i, op in enumerate(block.ops):
        for nm in op.attrs.get('__release__', ()):
            why = None
            if last.get(nm, -1) > i:
                why = ("a later op (op #%d) still reads it"
                       % last[nm])
            elif nm in protected:
                why = "it is a protected fetch"
            elif nm == RNG_KEY:
                why = "it is the threaded PRNG key"
            else:
                var = block._find_var_recursive(nm)
                if var is not None and var.persistable:
                    why = "it is persistable state"
            if why:
                diags.append(_violation(
                    pass_name, 'release-liveness',
                    "op #%d (%s) releases %r but %s — the buffer "
                    "would be dropped while still needed"
                    % (i, op.type, nm, why),
                    op_index=i, op_type=op.type, var_names=[nm]))

    introduced = {t for t, n in post.op_counts.items()
                  if n > pre.op_counts.get(t, 0)}
    for key, writers in post.read_map.items():
        nm, reader = key
        if reader in introduced:
            continue
        pre_writers = pre.read_map.get(key)
        residue = Counter({w: n for w, n in writers.items()
                           if w not in introduced})
        if not residue:
            continue
        if pre_writers is None:
            continue   # renamed input of a surviving op type: benign
        extra = residue - pre_writers
        if extra:
            w = next(iter(extra))
            diags.append(_violation(
                pass_name, 'read-order-hazard',
                "%s now reads %r produced by %s, but before the pass "
                "the same read observed %s — the rewrite moved a read "
                "across a write (WAR/WAW hazard)"
                % (reader, nm, w,
                   '/'.join(sorted(pre_writers)) or _IN),
                op_type=reader, var_names=[nm]))

    for nm, shape in post.shapes.items():
        before = pre.shapes.get(nm)
        if before is not None and tuple(before) != tuple(shape):
            diags.append(_violation(
                pass_name, 'shape-stable',
                "var %r changed inferred shape across the pass: "
                "%s -> %s" % (nm, before, shape), var_names=[nm]))

    for key in post.shard_keys - pre.shard_keys:
        _code, names, message = key
        diags.append(_violation(
            pass_name, 'shard-spec', message, var_names=names))
    return diags


def run_checked(pass_obj, program, ctx):
    """Apply one pass under the sanitizer: snapshot, run, check, raise
    :class:`PassVerificationError` on violations. The building block
    ``PassPipeline(verify=True)`` loops over; exposed for tools and
    tests that drive a single pass."""
    pre = snapshot(program, ctx.protected)
    res = pass_obj.run(program, ctx)
    t0 = time.perf_counter()
    diags = check_pass(pass_obj.name, pre, program, ctx.protected)
    observe('sanitize', diags, time.perf_counter() - t0,
            **{'pass': pass_obj.name})
    if any(d.is_error for d in diags):
        raise PassVerificationError(diags)
    return res
