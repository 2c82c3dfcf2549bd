"""Program / Block / Variable / Operator IR.

Counterpart of paddle_tpu/framework.py, copied and trimmed to what the
port's slices use. A Variable carries the JAX package's sharding slot
(``Variable.sharding``, a tuple of mesh axis names per dim), which the
port's ZeRO pass writes (``dp`` on a sliced accumulator or gradient). A
Program's ``fingerprint()`` is the JAX package's: the same digest of the
same description, sharding slot included, so both packages give one
fingerprint for one program. The tuning cache is keyed on it across
processes.

The IR is a plain Python graph. ``Operator`` is a pure description
(type, input/output var names per slot, attrs); its kernel lives in
``paddle_tpu_torch.ops`` keyed by ``type`` and is looked up when the
Executor runs the block.
"""
import collections
import contextlib
import copy
import hashlib
import json

import numpy as np

from . import unique_name

__all__ = [
    'Program', 'Block', 'Variable', 'Operator', 'Parameter',
    'default_startup_program', 'default_main_program', 'program_guard',
    'switch_startup_program', 'switch_main_program', 'get_var',
    'convert_np_dtype', 'grad_var_name',
]

GRAD_VAR_SUFFIX = '@GRAD'

_NP_DTYPE = {
    'float16': np.float16, 'float32': np.float32, 'float64': np.float64,
    'bfloat16': 'bfloat16', 'int8': np.int8, 'int16': np.int16,
    'int32': np.int32, 'int64': np.int64, 'uint8': np.uint8, 'bool': np.bool_,
}


def grad_var_name(name):
    return name + GRAD_VAR_SUFFIX


def convert_np_dtype(dtype):
    """Normalize a dtype spec (str, np.dtype, torch dtype) to its
    canonical string."""
    if dtype is None:
        return 'float32'
    if isinstance(dtype, str):
        if dtype in _NP_DTYPE:
            return dtype
        return np.dtype(dtype).name
    if 'bfloat16' in str(dtype):
        return 'bfloat16'
    try:
        return np.dtype(dtype).name
    except TypeError:
        # torch dtypes print as 'torch.float32'
        return str(dtype).replace('torch.', '')


class Variable(object):
    """A symbolic tensor in a Block. Parity: fluid.framework.Variable."""

    def __init__(self, block, name=None, shape=None, dtype='float32',
                 lod_level=0, persistable=False, stop_gradient=False,
                 is_data=False, type=None, **kwargs):
        self.block = block
        if name is None:
            name = unique_name.generate('_generated_var')
        self.name = name
        self.shape = tuple(shape) if shape is not None else ()
        self.dtype = convert_np_dtype(dtype)
        self.lod_level = lod_level
        self.persistable = persistable
        self.stop_gradient = stop_gradient
        self.is_data = is_data
        self.type = type or 'lod_tensor'
        self.op = None           # defining op (set by append_op)
        self._sharding = None
        self.sharding = kwargs.get('sharding', None)
        self.error_clip = kwargs.get('error_clip', None)

    @property
    def sharding(self):
        return self._sharding

    @sharding.setter
    def sharding(self, spec):
        """A bare string is a dim-0 spec; a change bumps the program's
        version (shardings are part of the fingerprint)."""
        if isinstance(spec, str):
            spec = (spec,)
        spec = tuple(spec) if spec is not None else None
        changed = spec != self._sharding
        self._sharding = spec
        if changed and self.block is not None:
            self.block.program._bump_version()

    def set_sharding(self, spec):
        self.sharding = spec
        return self

    def set_error_clip(self, error_clip):
        """Clip this variable's gradient as the backward passes through
        it (read by the lowering as a cotangent-clip barrier)."""
        self.error_clip = error_clip
        if self.block is not None:
            self.block.program._bump_version()

    def to_string(self, throw_on_error=False):
        return "Variable(name=%s, shape=%s, dtype=%s, lod=%d%s)" % (
            self.name, self.shape, self.dtype, self.lod_level,
            ', persistable' if self.persistable else '')

    __repr__ = __str__ = to_string

    def _desc(self):
        return (self.name, self.shape, self.dtype, self.lod_level,
                self.persistable, self.stop_gradient, self.sharding)


class Parameter(Variable):
    """A trainable persistable Variable. Parity: fluid.framework.Parameter."""

    def __init__(self, block, shape, dtype, **kwargs):
        if shape is None or len(shape) == 0:
            raise ValueError("Parameter shape cannot be empty")
        for d in shape:
            if d < 0:
                raise ValueError("Parameter shape must be static, got %s"
                                 % (shape,))
        kwargs.setdefault('persistable', True)
        super(Parameter, self).__init__(block, shape=shape, dtype=dtype,
                                        **kwargs)
        self.trainable = kwargs.get('trainable', True)
        self.optimize_attr = kwargs.get('optimize_attr', {'learning_rate': 1.0})
        self.regularizer = kwargs.get('regularizer', None)
        self.gradient_clip_attr = kwargs.get('gradient_clip_attr', None)
        self.do_model_average = kwargs.get('do_model_average', None)


class Operator(object):
    """Pure op description: type, slot->var-names maps, attrs."""

    def __init__(self, block, type, inputs=None, outputs=None, attrs=None):
        self.block = block
        self.type = type
        self.inputs = {}   # slot -> [var name]
        self.outputs = {}
        self.attrs = dict(attrs or {})

        def _names(v):
            if v is None:
                return []
            if not isinstance(v, (list, tuple)):
                v = [v]
            return [item.name if isinstance(item, Variable) else item
                    for item in v]

        for slot, v in (inputs or {}).items():
            self.inputs[slot] = _names(v)
        for slot, v in (outputs or {}).items():
            self.outputs[slot] = _names(v)
            for item in (v if isinstance(v, (list, tuple)) else [v]):
                if isinstance(item, Variable):
                    item.op = self

    def input(self, slot):
        return self.inputs.get(slot, [])

    def output(self, slot):
        return self.outputs.get(slot, [])

    @property
    def input_arg_names(self):
        return [n for ns in self.inputs.values() for n in ns]

    @property
    def output_arg_names(self):
        return [n for ns in self.outputs.values() for n in ns]

    def attr(self, name, default=None):
        return self.attrs.get(name, default)

    def _desc(self):
        def _clean(a):
            out = {}
            for k, v in sorted(a.items()):
                if isinstance(v, np.ndarray):
                    out[k] = ('ndarray', v.shape, str(v.dtype),
                              hashlib.md5(v.tobytes()).hexdigest())
                elif isinstance(v, Block):
                    out[k] = ('block', v.idx)
                elif callable(v):
                    out[k] = ('callable', getattr(v, '__name__', 'fn'))
                else:
                    out[k] = v
            return out
        return (self.type, sorted(self.inputs.items()),
                sorted(self.outputs.items()), _clean(self.attrs))

    def __repr__(self):
        return "{%s: %s -> %s}" % (self.type, self.inputs, self.outputs)


class Block(object):
    """An ordered list of Operators plus a symbol table of Variables."""

    def __init__(self, program, idx, parent_idx=-1):
        self.program = program
        self.idx = idx
        self.parent_idx = parent_idx
        self.vars = collections.OrderedDict()
        self.ops = []

    @property
    def parent_block(self):
        if self.parent_idx < 0:
            return None
        return self.program.block(self.parent_idx)

    # ---- variables --------------------------------------------------------------
    def create_var(self, **kwargs):
        name = kwargs.get('name')
        if name is not None and name in self.vars:
            existing = self.vars[name]
            # re-declaring a var with a conflicting shape/dtype is an
            # error, not a silent aliasing
            new_shape = kwargs.get('shape')
            if new_shape is not None and tuple(existing.shape or ()) and \
                    tuple(new_shape) != tuple(existing.shape):
                raise ValueError(
                    "Variable %r has been created before. The previous "
                    "shape is %s, the new shape is %s. They are not "
                    "matched." % (name, tuple(existing.shape),
                                  tuple(new_shape)))
            new_dtype = kwargs.get('dtype')
            if new_dtype is not None and \
                    getattr(existing, '_dtype_explicit', False) and \
                    convert_np_dtype(new_dtype) != existing.dtype:
                raise ValueError(
                    "Variable %r has been created before. The previous "
                    "data type is %s, the new dtype is %s. They are not "
                    "matched." % (name, existing.dtype, new_dtype))
            return existing
        var = Variable(self, **kwargs)
        var._dtype_explicit = kwargs.get('dtype') is not None
        self.vars[var.name] = var
        self.program._bump_version()
        return var

    def create_parameter(self, **kwargs):
        global_block = self.program.global_block()
        initializer = kwargs.pop('initializer', None)
        param = Parameter(global_block, **kwargs)
        global_block.vars[param.name] = param
        if initializer is not None:
            initializer(param, global_block)
        self.program._bump_version()
        return param

    def var(self, name):
        v = self._find_var_recursive(name)
        if v is None:
            raise ValueError("Variable %r not found in block %d" %
                             (name, self.idx))
        return v

    def has_var(self, name):
        return self._find_var_recursive(name) is not None

    def _find_var_recursive(self, name):
        blk = self
        while blk is not None:
            if name in blk.vars:
                return blk.vars[name]
            blk = blk.parent_block
        return None

    def all_parameters(self):
        return [v for v in self.vars.values() if isinstance(v, Parameter)]

    # ---- ops --------------------------------------------------------------------
    def append_op(self, type=None, inputs=None, outputs=None, attrs=None):
        op = Operator(self, type=type, inputs=inputs, outputs=outputs,
                      attrs=attrs)
        self.ops.append(op)
        self.program._bump_version()
        return op

    def prepend_op(self, type=None, inputs=None, outputs=None, attrs=None):
        return self.insert_op(0, type=type, inputs=inputs, outputs=outputs,
                              attrs=attrs)

    def insert_op(self, index, type=None, inputs=None, outputs=None,
                  attrs=None):
        op = Operator(self, type=type, inputs=inputs, outputs=outputs,
                      attrs=attrs)
        self.ops.insert(index, op)
        self.program._bump_version()
        return op

    def remove_op(self, index):
        op = self.ops.pop(index)
        self.program._bump_version()
        return op

    def _desc(self):
        return (self.idx, self.parent_idx,
                [v._desc() for v in self.vars.values()],
                [op._desc() for op in self.ops])

    def __repr__(self):
        return "Block(%d) vars=%d ops=[%s]" % (
            self.idx, len(self.vars), ", ".join(op.type for op in self.ops))


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
    """All names an op (with nested sub-blocks) writes."""
    writes = list(op.output_arg_names)
    sub = op.attrs.get('sub_block')
    if sub is not None:
        for sop in sub.ops:
            writes.extend(_op_writes(sop))
    return writes


def _hidden_reads(op):
    """Names consumed through attrs, invisible to ``_op_reads``: the
    gradient markers' cotangent sources and the backward marker's
    sparse-lookup ids. Every liveness-style analysis treats them as
    reads."""
    if op.type == 'gradient_marker':
        return [n for n in (op.attrs.get('target_grads') or ()) if n]
    if op.type == 'backward_marker':
        return [p[0] for pairs in (op.attrs.get('sparse') or {}).values()
                for p in pairs]
    return []


def _has_sub_block(op):
    return any(isinstance(v, Block) for v in op.attrs.values())


class Program(object):
    """A list of Blocks; block 0 is the global block.

    ``clone(for_test=True)`` freezes train-only behavior by flipping
    ``is_test`` attrs, as the reference's ``inference_optimize`` does.
    ``_version`` counts mutations; the Executor keys its per-program
    memo (the pruned, rewritten op list) on it.
    """

    def __init__(self):
        self.blocks = [Block(self, 0)]
        self.current_block_idx = 0
        self.random_seed = 0
        # memory_optimize's rematerialisation mark
        self._remat = False
        self._version = 0
        self._fingerprint_cache = None

    def global_block(self):
        return self.blocks[0]

    def block(self, idx):
        return self.blocks[idx]

    def current_block(self):
        return self.blocks[self.current_block_idx]

    def create_block(self, parent_idx=None):
        """Open a sub-block (a loop or branch body) under the current
        block, or under ``parent_idx``, and make it current."""
        new_idx = len(self.blocks)
        parent = self.current_block_idx if parent_idx is None else parent_idx
        self.blocks.append(Block(self, new_idx, parent_idx=parent))
        self.current_block_idx = new_idx
        self._bump_version()
        return self.current_block()

    def rollback(self):
        """Close the current sub-block: its parent is current again."""
        self.current_block_idx = self.current_block().parent_idx
        self._bump_version()

    def _bump_version(self):
        self._version += 1

    def fingerprint(self):
        """A stable digest of the program's description: blocks, their
        variables in declaration order and their ops with attributes.
        The same in every process and across a save and load of the same
        model (it depends on no ``id()`` and on no unordered container),
        and the JAX package's for the same unsharded program. Cached per
        ``_version``."""
        cached = self._fingerprint_cache
        if cached is None or cached[0] != self._version:
            # the first slot is the rematerialisation mark
            # (memory_optimize), as in the JAX package
            desc = json.dumps([bool(getattr(self, '_remat', False))] +
                              [b._desc() for b in self.blocks],
                              default=str, sort_keys=True)
            cached = self._fingerprint_cache = (
                self._version, hashlib.sha1(desc.encode()).hexdigest())
        return cached[1]

    # ---- clone / prune ----------------------------------------------------------
    def clone(self, for_test=False):
        p = Program()
        p.random_seed = self.random_seed
        p._remat = getattr(self, '_remat', False)
        p.blocks = []
        for b in self.blocks:
            nb = Block(p, b.idx, b.parent_idx)
            for name, v in b.vars.items():
                nv = copy.copy(v)
                nv.block = nb
                nb.vars[name] = nv
            p.blocks.append(nb)
        for b, nb in zip(self.blocks, p.blocks):
            for op in b.ops:
                nop = Operator(nb, op.type)
                nop.inputs = {k: list(v) for k, v in op.inputs.items()}
                nop.outputs = {k: list(v) for k, v in op.outputs.items()}
                # a sub-block attribute points at the clone's own block
                nop.attrs = {k: p.blocks[v.idx] if isinstance(v, Block)
                             else v for k, v in op.attrs.items()}
                nb.ops.append(nop)
        if for_test:
            p._inference_optimize()
        p._bump_version()
        return p

    def _inference_optimize(self):
        for b in self.blocks:
            for op in b.ops:
                if 'is_test' in op.attrs or op.type == 'dropout':
                    op.attrs['is_test'] = True

    def prune(self, targets):
        """Keep only ops that (transitively) produce ``targets``. An op
        with a sub-block (a While) produces what its body writes and
        needs what its body reads, so a saved decode keeps its loop."""
        if not isinstance(targets, (list, tuple)):
            targets = [targets]
        needed = set(t.name if isinstance(t, Variable) else t
                     for t in targets)
        keep = set()
        ops = self.global_block().ops
        for i in reversed(range(len(ops))):
            op = ops[i]
            if op.type == 'backward_marker':
                continue
            if set(_op_writes(op)) & needed:
                keep.add(i)
                needed |= set(_op_reads(op))
        p = self.clone()
        nb = p.global_block()
        nb.ops = [op for i, op in enumerate(nb.ops) if i in keep]
        p._bump_version()
        return p

    def list_vars(self):
        for b in self.blocks:
            for v in b.vars.values():
                yield v

    def __repr__(self):
        return "Program(blocks=%d, ops=%s)" % (
            len(self.blocks), [len(b.ops) for b in self.blocks])

    def to_string(self, throw_on_error=False):
        lines = []
        for b in self.blocks:
            lines.append("-- block %d (parent %d) --" % (b.idx, b.parent_idx))
            for v in b.vars.values():
                lines.append("  " + str(v))
            for op in b.ops:
                lines.append("  " + repr(op))
        return "\n".join(lines)


# ---- default programs -----------------------------------------------------------
_main_program_ = Program()
_startup_program_ = Program()


def default_startup_program():
    return _startup_program_


def default_main_program():
    return _main_program_


def switch_main_program(program):
    global _main_program_
    prev = _main_program_
    _main_program_ = program
    return prev


def switch_startup_program(program):
    global _startup_program_
    prev = _startup_program_
    _startup_program_ = program
    return prev


@contextlib.contextmanager
def program_guard(main_program, startup_program=None):
    if not isinstance(main_program, Program):
        raise TypeError("main_program must be a Program")
    prev_main = switch_main_program(main_program)
    prev_start = None
    if startup_program is not None:
        prev_start = switch_startup_program(startup_program)
    try:
        yield
    finally:
        switch_main_program(prev_main)
        if prev_start is not None:
            switch_startup_program(prev_start)


def get_var(name, program=None):
    if program is None:
        program = default_main_program()
    return program.global_block().var(name)
