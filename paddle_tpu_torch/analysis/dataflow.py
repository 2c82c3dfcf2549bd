"""Dataflow over the Program IR: def-use chains, use-before-def,
liveness, reachability (ANALYSIS.md "Dataflow model").

Counterpart of paddle_tpu/analysis/dataflow.py. The read/write model is
shared with the compiler passes: ``framework._op_reads`` /
``_op_writes`` (sub-block recursive; the JAX package keeps them in its
lowering) plus the compiler's hidden reads (the gradient markers'
cotangent sources and the sparse-lookup ids) and one
hidden WRITE set of our own —
``backward_marker`` defines every ``<param>@GRAD`` name through its
``grads`` attr, with no textual output slot. Any liveness-style
analysis that forgets either half calls live code dead.

Availability semantics mirror the executor environment: a name may be
read if it was written by an earlier op, is persistable (scope state),
is a data var / explicit feed (run-time feed dict), or is the threaded
PRNG key. Sub-blocks (While/IfElse/StaticRNN/DynamicRNN step blocks)
re-run against the enclosing environment, so a name written ANYWHERE in
the sub-block may be read before its textual write (loop-carried state);
the analysis is conservative there and only flags names with no writer
at all.
"""

from ..compiler.passes import _hidden_reads
from ..core.lowering import RNG_KEY
from ..framework import Block, _has_sub_block, _op_reads, _op_writes
from .diagnostics import Diagnostic, ERROR

__all__ = ['op_reads', 'op_writes', 'hidden_reads', 'hidden_writes',
           'carrier_defs', 'DataflowResult', 'analyze_dataflow',
           'reachable_ops', 'last_reads']


def op_reads(op):
    return list(_op_reads(op)) + hidden_reads(op)


def op_writes(op):
    return list(_op_writes(op)) + hidden_writes(op)


def hidden_reads(op):
    return _hidden_reads(op)


def hidden_writes(op):
    """Names an op defines through ATTRS, invisible to ``_op_writes``:
    ``backward_marker`` plants every ``<param>@GRAD`` via its ``grads``
    attr (backward.py) — downstream clip/regularizer/update ops read
    them with no textual producer."""
    if op.type == 'backward_marker':
        return [n for n in (op.attrs.get('grads') or ()) if n]
    return []


def carrier_defs(op):
    """Sub-block-local names a control-flow CARRIER op materializes at
    block entry, declared only through attrs (layers/control_flow.py):
    StaticRNN provides per-step input slices and pre-memories;
    DynamicRNN additionally threads static inputs. Ops inside the
    sub-block read these with no textual producer."""
    names = []
    if op.type in ('static_rnn', 'dynamic_rnn'):
        names.extend(op.attrs.get('step_inputs') or ())
    if op.type == 'static_rnn':
        names.extend(op.attrs.get('pre_mems') or ())
    elif op.type == 'dynamic_rnn':
        names.extend(op.attrs.get('static_inside') or ())
        names.extend(mi.get('pre') for mi in
                     (op.attrs.get('mem_info') or ()) if mi.get('pre'))
    return names


class DataflowResult(object):
    """Def-use facts for one Program (global block resolution).

    ``defs``/``uses``: name -> ordered list of (block_idx, op_index,
    op_type) sites. ``undefined_reads``: (name, site) pairs that no
    availability source covers. ``unused_defs``: names written but
    never read nor fetched (informational).
    """

    __slots__ = ('defs', 'uses', 'undefined_reads', 'unused_defs',
                 'num_ops', 'available')

    def __init__(self):
        self.defs = {}
        self.uses = {}
        self.undefined_reads = []
        self.unused_defs = []
        self.num_ops = 0
        self.available = frozenset()


def _initial_available(program, feeds=()):
    avail = {RNG_KEY}
    avail.update(feeds or ())
    for b in program.blocks:
        for v in b.vars.values():
            if v.persistable or v.is_data:
                avail.add(v.name)
    return avail


def analyze_dataflow(program, feeds=(), protected=()):
    """Walk the program once; return ``(DataflowResult, [Diagnostic])``.

    Use-before-def in the GLOBAL block is an error (the lowering would
    KeyError or trace garbage); inside sub-blocks the conservative
    loop-carried rule applies and any residue is still an error — a
    name with no writer anywhere cannot come from a previous
    iteration either.
    """
    res = DataflowResult()
    diags = []
    avail = set(_initial_available(program, feeds))
    res.available = frozenset(avail)
    block = program.global_block()
    read_ever = set(protected or ())

    def _site(bidx, i, op):
        return (bidx, i, op.type)

    def _record(table, name, site):
        table.setdefault(name, []).append(site)

    def _walk(blk, bidx, avail, depth):
        for i, op in enumerate(blk.ops):
            res.num_ops += 1
            direct_reads = list(op.input_arg_names) + hidden_reads(op)
            for nm in direct_reads:
                _record(res.uses, nm, _site(bidx, i, op))
                read_ever.add(nm)
            missing = [nm for nm in dict.fromkeys(direct_reads)
                       if nm not in avail]
            if missing:
                diags.append(Diagnostic(
                    'use-before-def', ERROR,
                    "op reads %s before any definition (no earlier "
                    "writer, not persistable state, not a data/feed "
                    "var)" % ', '.join(repr(n) for n in missing),
                    block_idx=bidx, op_index=i, op_type=op.type,
                    var_names=missing))
                res.undefined_reads.extend((nm, _site(bidx, i, op))
                                           for nm in missing)
            if _has_sub_block(op):
                for sub in op.attrs.values():
                    if not isinstance(sub, Block):
                        continue
                    # loop-carried conservative availability: anything
                    # the sub-block (or this one, for nested) writes is
                    # available from iteration 2 onward — plus what the
                    # op itself will have read in (its inputs)
                    sub_avail = set(avail)
                    sub_avail.update(op_writes(op))
                    sub_avail.update(carrier_defs(op))
                    _walk(sub, sub.idx, sub_avail, depth + 1)
                    for sop in sub.ops:
                        for nm in sop.input_arg_names + hidden_reads(sop):
                            read_ever.add(nm)
            writes = list(op.output_arg_names) + hidden_writes(op)
            if _has_sub_block(op):
                writes = op_writes(op)
            for nm in writes:
                _record(res.defs, nm, _site(bidx, i, op))
            avail.update(writes)

    _walk(block, 0, avail, 0)

    for nm, sites in res.defs.items():
        if nm in read_ever or nm == RNG_KEY:
            continue
        var = block._find_var_recursive(nm)
        if var is not None and var.persistable:
            continue  # state writes are externally observable
        res.unused_defs.append(nm)
    return res, diags


def reachable_ops(block, targets):
    """Indices of global-block ops whose outputs (transitively) feed any
    of ``targets`` — backward reachability over names, the static twin
    of ``Program.prune``."""
    need = set(targets)
    keep = set()
    for i in reversed(range(len(block.ops))):
        op = block.ops[i]
        if any(nm in need for nm in op_writes(op)):
            keep.add(i)
            need.update(op_reads(op))
    return keep


def last_reads(block):
    """name -> index of its LAST reader in the block (hidden reads
    included) — the fact ``buffer_reuse`` annotations must agree with."""
    last = {}
    for i, op in enumerate(block.ops):
        for nm in list(op.input_arg_names) + hidden_reads(op):
            last[nm] = i
        if _has_sub_block(op):
            for nm in op_reads(op):
                last[nm] = i
    return last
