"""Program / Block / Variable / Operator IR.

Counterpart of paddle_tpu/framework.py, copied and trimmed to what the
serving and training slices use (no sharding annotations, no
fingerprinting: the port's Executor runs a block eagerly, op by op, and
has no compiled-program cache to key).

The IR is a plain Python graph. ``Operator`` is a pure description
(type, input/output var names per slot, attrs); its kernel lives in
``paddle_tpu_torch.ops`` keyed by ``type`` and is looked up when the
Executor runs the block.
"""
import collections
import contextlib
import copy

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
        self.error_clip = kwargs.get('error_clip', None)

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

    def __repr__(self):
        return "Block(%d) vars=%d ops=[%s]" % (
            self.idx, len(self.vars), ", ".join(op.type for op in self.ops))


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
        self._version = 0

    def global_block(self):
        return self.blocks[0]

    def block(self, idx):
        return self.blocks[idx]

    def current_block(self):
        return self.blocks[self.current_block_idx]

    def _bump_version(self):
        self._version += 1

    # ---- clone / prune ----------------------------------------------------------
    def clone(self, for_test=False):
        p = Program()
        p.random_seed = self.random_seed
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
                nop.attrs = dict(op.attrs)
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
        """Keep only ops that (transitively) produce ``targets``."""
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
            if set(op.output_arg_names) & needed:
                keep.add(i)
                needed |= set(op.input_arg_names)
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
