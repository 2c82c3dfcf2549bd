"""Control-flow layers. Counterpart of paddle_tpu/layers/control_flow.py
(parity: python/paddle/fluid/layers/control_flow.py): ``increment`` and
the compare layers (``less_than`` and ``equal`` as there, and
``less_equal``, ``greater_than``, ``greater_equal`` and ``not_equal``
built the same way; paddle_tpu reaches those op types through
Variable's operators), the tensor arrays and the LoD rank-table
machinery, ``While``, ``ConditionalBlock``, ``Switch``, ``IfElse``,
``StaticRNN``, ``DynamicRNN``, ``Print``, ``is_empty`` and the
``ParallelDo`` stub. Each builds the same ops as paddle_tpu's; the
kernels are in ops/control_flow_ops.py: a While runs its body on the
device once an iteration, IfElse and Switch run both sides and select,
StaticRNN and DynamicRNN loop over time.
"""
import contextlib

from ..layer_helper import LayerHelper
from ..framework import Variable
from .. import unique_name
from .tensor import assign, fill_constant, cast
from . import ops as _ops

__all__ = [
    'split_lod_tensor', 'merge_lod_tensor', 'BlockGuard',
    'BlockGuardWithCompletion', 'StaticRNNMemoryLink', 'WhileGuard',
    'While', 'Switch', 'lod_rank_table', 'max_sequence_len',
    'lod_tensor_to_array', 'array_to_lod_tensor', 'increment',
    'array_write', 'create_array', 'less_than', 'less_equal',
    'greater_than', 'greater_equal', 'equal', 'not_equal', 'array_read',
    'shrink_memory', 'array_length', 'IfElse', 'DynamicRNN', 'StaticRNN',
    'ConditionalBlock', 'reorder_lod_tensor_by_rank', 'ParallelDo',
    'Print', 'is_empty',
]


class BlockGuard(object):
    """Push a sub-block onto the program for the ``with`` body."""

    def __init__(self, main_program):
        if not hasattr(main_program, 'create_block'):
            raise TypeError("BlockGuard takes a program")
        self.main_program = main_program

    def __enter__(self):
        self.main_program.create_block()

    def __exit__(self, exc_type, exc_val, exc_tb):
        self.main_program.rollback()
        if exc_type is not None:
            return False
        return True


def increment(x, value=1.0, in_place=True):
    helper = LayerHelper("increment", **{})
    if not in_place:
        out = helper.create_tmp_variable(dtype=x.dtype, shape=x.shape)
    else:
        out = x
    helper.append_op(type='increment', inputs={'X': [x]},
                     outputs={'Out': [out]}, attrs={'step': float(value)})
    return out


def _compare_layer(op_type):
    def layer(x, y, cond=None, **ignored):
        helper = LayerHelper(op_type, **{})
        if cond is None:
            cond = helper.create_tmp_variable(dtype='bool', shape=x.shape)
            cond.stop_gradient = True
        helper.append_op(type=op_type, inputs={'X': [x], 'Y': [y]},
                         outputs={'Out': [cond]})
        return cond
    layer.__name__ = op_type
    return layer


less_than = _compare_layer('less_than')
less_equal = _compare_layer('less_equal')
greater_than = _compare_layer('greater_than')
greater_equal = _compare_layer('greater_equal')
equal = _compare_layer('equal')
not_equal = _compare_layer('not_equal')


def is_empty(x, cond=None, **ignored):
    helper = LayerHelper("is_empty", **{})
    if cond is None:
        cond = helper.create_tmp_variable(dtype='bool', shape=(1,))
        cond.stop_gradient = True
    helper.append_op(type='is_empty', inputs={'X': [x]},
                     outputs={'Out': [cond]})
    return cond


def Print(input, first_n=-1, message=None, summarize=-1, print_tensor_name=True,
          print_tensor_type=True, print_tensor_shape=True,
          print_tensor_lod=True, print_phase='both'):
    helper = LayerHelper('print', **{})
    out = helper.create_tmp_variable(dtype=input.dtype, shape=input.shape,
                                     lod_level=input.lod_level)
    helper.append_op(type='print', inputs={'X': input},
                     outputs={'Out': out},
                     attrs={'first_n': first_n, 'summarize': summarize,
                            'message': message or "",
                            'print_tensor_name': print_tensor_name,
                            'print_tensor_type': print_tensor_type,
                            'print_tensor_shape': print_tensor_shape,
                            'print_tensor_lod': print_tensor_lod,
                            'print_phase': print_phase})
    return out


# ---- tensor arrays --------------------------------------------------------------
def create_array(dtype):
    """LOD_TENSOR_ARRAY equivalent. At run time an array is a list of
    tensors on the device (ops/control_flow_ops.py)."""
    helper = LayerHelper("array", **{})
    arr = helper.create_variable(
        name=unique_name.generate("array"), dtype=dtype, shape=())
    arr.type = 'tensor_array'
    return arr


def array_write(x, i, array=None):
    helper = LayerHelper('array_write', **{})
    if array is None:
        array = create_array(x.dtype)
    # the element shape, so reads keep the build-time shape
    if not getattr(array, 'shape', None):
        array.shape = tuple(x.shape)
    helper.append_op(type='write_to_array',
                     inputs={'X': [x], 'I': [i]},
                     outputs={'Out': [array]})
    return array


def array_read(array, i):
    helper = LayerHelper('array_read', **{})
    out = helper.create_tmp_variable(dtype=array.dtype,
                                     shape=getattr(array, 'shape', ()))
    helper.append_op(type='read_from_array',
                     inputs={'X': [array], 'I': [i]},
                     outputs={'Out': [out]})
    return out


def shrink_memory(x, i, table):
    """Parity: control_flow.py::shrink_memory (shrink_rnn_memory op).
    The reference trims the memory batch to the sequences still alive at
    step ``i`` of the length-sorted rank table; the masked-scan design
    keeps the full batch alive, so the op is the identity contract
    (kernel: ops/control_flow_ops.py::_shrink_rnn_memory)."""
    helper = LayerHelper('shrink_memory', **{})
    out = helper.create_tmp_variable(dtype=x.dtype, shape=x.shape,
                                     lod_level=x.lod_level)
    helper.append_op(type='shrink_rnn_memory',
                     inputs={'X': [x], 'I': [i], 'RankTable': [table]},
                     outputs={'Out': [out]}, attrs={})
    return out


def array_length(array):
    helper = LayerHelper('array_length', **{})
    tmp = helper.create_tmp_variable(dtype='int64', shape=(1,))
    tmp.stop_gradient = True
    helper.append_op(type='lod_array_length', inputs={'X': [array]},
                     outputs={'Out': [tmp]})
    return tmp


# ---- LoD rank-table machinery ---------------------------------------------------
def lod_rank_table(x, level=0):
    """Parity: control_flow.py::lod_rank_table. With SequenceTensor the
    table is just the lengths vector (already sorted handling is done by
    the consuming ops)."""
    helper = LayerHelper("lod_rank_table", **{})
    table = helper.create_variable(
        name=unique_name.generate("lod_rank_table"), dtype='int32',
        shape=())
    table.type = 'lod_rank_table'
    helper.append_op(type='lod_rank_table', inputs={'X': x},
                     outputs={'Out': table}, attrs={'level': level})
    return table


def max_sequence_len(rank_table):
    helper = LayerHelper("max_seqence_len", **{})
    res = helper.create_tmp_variable(dtype="int64", shape=(1,))
    helper.append_op(type="max_sequence_len",
                     inputs={"RankTable": rank_table},
                     outputs={"Out": res})
    return res


def lod_tensor_to_array(x, table):
    helper = LayerHelper("lod_tensor_to_array", **{})
    array = helper.create_variable(
        name=unique_name.generate("lod_tensor_to_array"), dtype=x.dtype,
        shape=())
    array.type = 'tensor_array'
    helper.append_op(type='lod_tensor_to_array',
                     inputs={'X': x, 'RankTable': table},
                     outputs={'Out': array})
    return array


def array_to_lod_tensor(x, table):
    helper = LayerHelper("array_to_lod_tensor", **{})
    tmp = helper.create_tmp_variable(dtype=x.dtype, lod_level=1)
    helper.append_op(type="array_to_lod_tensor",
                     inputs={'X': x, 'RankTable': table},
                     outputs={'Out': tmp})
    return tmp


def reorder_lod_tensor_by_rank(x, rank_table):
    helper = LayerHelper('reorder_lod_tensor_by_rank', **{})
    out = helper.create_tmp_variable(dtype=x.dtype, shape=x.shape,
                                     lod_level=x.lod_level)
    helper.append_op(type='reorder_lod_tensor_by_rank',
                     inputs={'X': [x], 'RankTable': [rank_table]},
                     outputs={'Out': [out]})
    return out


def split_lod_tensor(input, mask, level=0):
    helper = LayerHelper('split_lod_tensor', **{})
    # branch views keep the input's feature shape (rows are masked, not
    # dropped, so downstream fc/conv can size their params)
    out_true = helper.create_tmp_variable(dtype=input.dtype,
                                          lod_level=input.lod_level,
                                          shape=input.shape)
    out_false = helper.create_tmp_variable(dtype=input.dtype,
                                           lod_level=input.lod_level,
                                           shape=input.shape)
    helper.append_op(type='split_lod_tensor',
                     inputs={'X': input, 'Mask': mask},
                     outputs={'OutTrue': out_true, 'OutFalse': out_false},
                     attrs={'level': level})
    return out_true, out_false


def merge_lod_tensor(in_true, in_false, x, mask, level=0):
    helper = LayerHelper('merge_lod_tensor', **{})
    out = helper.create_tmp_variable(dtype=in_true.dtype,
                                     lod_level=x.lod_level)
    helper.append_op(type='merge_lod_tensor',
                     inputs={'X': x, 'Mask': mask, 'InTrue': in_true,
                             'InFalse': in_false},
                     outputs={'Out': out}, attrs={'level': level})
    return out


# ---- While ----------------------------------------------------------------------
class WhileGuard(BlockGuard):
    def __init__(self, while_op):
        if not isinstance(while_op, While):
            raise TypeError("WhileGuard takes a while op")
        super(WhileGuard, self).__init__(while_op.helper.main_program)
        self.while_op = while_op

    def __enter__(self):
        self.while_op.status = While.IN_WHILE_BLOCK
        return super(WhileGuard, self).__enter__()

    def __exit__(self, exc_type, exc_val, exc_tb):
        if exc_type is not None:
            return False
        self.while_op.status = While.AFTER_WHILE_BLOCK
        self.while_op.complete()
        return super(WhileGuard, self).__exit__(exc_type, exc_val, exc_tb)


class While(object):
    """A loop whose body runs while ``cond`` holds; the condition is
    read on the host each iteration. The names the body assigns that
    exist before the loop carry over (parity: WhileOp's var analysis)."""
    BEFORE_WHILE_BLOCK = 0
    IN_WHILE_BLOCK = 1
    AFTER_WHILE_BLOCK = 2

    def __init__(self, cond, name=None):
        self.helper = LayerHelper("while", name=name)
        self.status = While.BEFORE_WHILE_BLOCK
        if not isinstance(cond, Variable):
            raise TypeError("condition should be a variable")
        self.cond_var = cond

    def block(self):
        return WhileGuard(self)

    def complete(self):
        main_program = self.helper.main_program
        while_block = main_program.current_block()
        parent_block = main_program.block(while_block.parent_idx)
        parent_block.append_op(
            type='while',
            inputs={'Condition': [self.cond_var]},
            outputs={},
            attrs={'sub_block': while_block})


# ---- Switch / IfElse ------------------------------------------------------------
class ConditionalBlockGuard(BlockGuard):
    def __init__(self, block):
        super(ConditionalBlockGuard, self).__init__(
            block.helper.main_program)
        self.block = block

    def __enter__(self):
        return super(ConditionalBlockGuard, self).__enter__()

    def __exit__(self, exc_type, exc_val, exc_tb):
        self.block.complete()
        return super(ConditionalBlockGuard, self).__exit__(
            exc_type, exc_val, exc_tb)


class ConditionalBlock(object):
    def __init__(self, inputs, is_scalar_condition=False, name=None):
        for each_input in inputs:
            if not isinstance(each_input, Variable):
                raise TypeError("Each input should be a variable")
        self.inputs = inputs
        self.is_scalar_condition = is_scalar_condition
        self.helper = LayerHelper('conditional_block', name=name)

    def block(self):
        return ConditionalBlockGuard(self)

    def complete(self):
        main_program = self.helper.main_program
        cond_block = main_program.current_block()
        parent_block = main_program.block(cond_block.parent_idx)
        parent_block.append_op(
            type='conditional_block',
            inputs={'Cond': self.inputs},
            outputs={},
            attrs={'sub_block': cond_block,
                   'is_scalar_condition': self.is_scalar_condition})


class Switch(object):
    """Parity: control_flow.py::Switch. Each case body runs under a
    conditional_block guarded by its predicate AND not any previous one."""

    def __init__(self, name=None):
        self.helper = LayerHelper('switch', name=name)
        self.inside_scope = False
        self.pre_not_conditions = []

    @contextlib.contextmanager
    def case(self, condition):
        if not self.inside_scope:
            raise ValueError("case should be called inside with")
        if len(self.pre_not_conditions) == 0:
            cond_block = ConditionalBlock([condition],
                                          is_scalar_condition=True)
            not_cond = _ops.elementwise_sub(
                fill_constant(shape=[1], dtype='float32', value=1.0),
                cast(condition, 'float32'))
            self.pre_not_conditions.append(not_cond)
        else:
            pre_not = self.pre_not_conditions[-1]
            new_not_cond = _ops.elementwise_mul(
                pre_not,
                _ops.elementwise_sub(
                    fill_constant(shape=[1], dtype='float32', value=1.0),
                    cast(condition, 'float32')))
            self.pre_not_conditions.append(new_not_cond)
            cond_block = ConditionalBlock(
                [_ops.elementwise_mul(pre_not, cast(condition, 'float32'))],
                is_scalar_condition=True)
        with cond_block.block():
            yield

    @contextlib.contextmanager
    def default(self):
        pre_cond_num = len(self.pre_not_conditions)
        if pre_cond_num == 0:
            raise ValueError("there should be at least one condition")
        cond_block = ConditionalBlock([self.pre_not_conditions[-1]],
                                      is_scalar_condition=True)
        with cond_block.block():
            yield

    def __enter__(self):
        self.inside_scope = True
        return self

    def __exit__(self, exc_type, exc_val, exc_tb):
        self.inside_scope = False
        if exc_type is not None:
            return False
        return True


class IfElseBlockGuard(object):
    def __init__(self, is_true, ifelse):
        if not isinstance(ifelse, IfElse):
            raise TypeError("ifelse must be an instance of IfElse class")
        if ifelse.status != IfElse.OUT_IF_ELSE_BLOCKS:
            raise ValueError("You cannot invoke IfElse.block() inside a "
                             "block")
        self.is_true = is_true
        self.ie = ifelse
        self.cond_block = ConditionalBlock(
            [ifelse.cond if is_true else ifelse.not_cond],
            is_scalar_condition=False)
        self.cond_block_guard = None

    def __enter__(self):
        self.ie.status = IfElse.IN_IF_ELSE_TRUE_BLOCKS if self.is_true \
            else IfElse.IN_IF_ELSE_FALSE_BLOCKS
        self.cond_block_guard = self.cond_block.block()
        return self.cond_block_guard.__enter__()

    def __exit__(self, exc_type, exc_val, exc_tb):
        self.cond_block_guard.__exit__(exc_type, exc_val, exc_tb)
        self.ie.status = IfElse.OUT_IF_ELSE_BLOCKS
        return exc_type is None


class IfElse(object):
    """Parity: control_flow.py::IfElse. Both branches run on the whole
    batch and the results are selected row by row with the mask, as in
    the JAX package: the data-dependent split of the batch becomes a
    mask, with no read of the device."""
    OUT_IF_ELSE_BLOCKS = 0
    IN_IF_ELSE_TRUE_BLOCKS = 1
    IN_IF_ELSE_FALSE_BLOCKS = 2

    def __init__(self, cond, name=None):
        if not isinstance(cond, Variable):
            raise TypeError("cond must be a Variable")
        self.helper = LayerHelper('ifelse', name=name)
        self.cond = cond
        self.not_cond = _ops.elementwise_sub(
            fill_constant(shape=[1], dtype='float32', value=1.0),
            cast(cond, 'float32'))
        self.not_cond = cast(self.not_cond, 'bool')
        self.input_table = {}
        self.status = IfElse.OUT_IF_ELSE_BLOCKS
        self.output_table = [[], []]  # [true_out, false_out]

    def input(self, x):
        if self.status == IfElse.OUT_IF_ELSE_BLOCKS:
            raise ValueError("input must in true/false blocks")
        # masked view of x for this branch (mask applied at merge time)
        return x

    def true_block(self):
        return IfElseBlockGuard(True, self)

    def false_block(self):
        return IfElseBlockGuard(False, self)

    def output(self, *outs):
        if self.status == self.OUT_IF_ELSE_BLOCKS:
            raise ValueError("output can only be invoked in the sub-block")
        out_table = self.output_table[
            1 if self.status == self.IN_IF_ELSE_TRUE_BLOCKS else 0]
        for each_out in outs:
            if not isinstance(each_out, Variable):
                raise TypeError("Each output should be a variable")
            # record a copy made inside the conditional block
            outside = self.helper.main_program.current_block().create_var(
                name=unique_name.generate('ifelse_out'),
                dtype=each_out.dtype, shape=each_out.shape,
                lod_level=each_out.lod_level)
            assign(each_out, outside)
            out_table.append(outside)

    def __call__(self):
        if self.status != self.OUT_IF_ELSE_BLOCKS:
            raise ValueError("IfElse::__call__ must be out of sub-blocks")
        false_len, true_len = list(map(len, self.output_table))
        if false_len == 0 and true_len == 0:
            raise ValueError("Must invoke true_block/false_block before "
                             "__call__")
        elif false_len != true_len and false_len != 0 and true_len != 0:
            raise ValueError("The output side must be same")
        elif false_len == 0 or true_len == 0:
            return self.output_table[0 if false_len != 0 else 1]

        rlist = []
        for false_var, true_var in zip(*self.output_table):
            rlist.append(merge_lod_tensor(
                in_true=true_var, in_false=false_var, mask=self.cond,
                x=self.cond, level=0))
        return rlist


# ---- StaticRNN ------------------------------------------------------------------
class StaticRNNMemoryLink(object):
    def __init__(self, init, pre_mem, mem=None):
        self.init = init
        self.pre_mem = pre_mem
        self.mem = mem


class BlockGuardWithCompletion(BlockGuard):
    def __init__(self, rnn):
        if not isinstance(rnn, StaticRNN):
            raise TypeError("BlockGuardWithCompletion takes a StaticRNN")
        super(BlockGuardWithCompletion, self).__init__(
            rnn.helper.main_program)
        self.rnn = rnn

    def __enter__(self):
        self.rnn.status = StaticRNN.IN_RNN_BLOCK
        return super(BlockGuardWithCompletion, self).__enter__()

    def __exit__(self, exc_type, exc_val, exc_tb):
        if exc_type is not None:
            return False
        self.rnn.status = StaticRNN.AFTER_RNN_BLOCK
        self.rnn._complete_op()
        return super(BlockGuardWithCompletion, self).__exit__(
            exc_type, exc_val, exc_tb)


class StaticRNN(object):
    """Unrolled-over-time RNN on [T x batch x ...] inputs, a loop over
    time in the kernel. Parity: control_flow.py::StaticRNN."""
    BEFORE_RNN_BLOCK = 0
    IN_RNN_BLOCK = 1
    AFTER_RNN_BLOCK = 2

    def __init__(self, name=None):
        self.helper = LayerHelper("static_rnn", name=name)
        self.memories = {}   # mem var name -> StaticRNNMemoryLink
        self.inputs = []     # step-input vars (outside)
        self.step_inputs = []  # corresponding in-block vars
        self.outputs = []    # in-block output vars
        self.outside_outputs = []
        self.status = StaticRNN.BEFORE_RNN_BLOCK
        self.seq_len = None

    def step(self):
        return BlockGuardWithCompletion(self)

    def _assert_in_rnn_block_(self, method):
        if self.status != StaticRNN.IN_RNN_BLOCK:
            raise ValueError("You must invoke {0} in rnn block".format(
                method))

    def memory(self, init=None, shape=None, batch_ref=None,
               init_value=0.0, init_batch_dim_idx=0, ref_batch_dim_idx=1):
        self._assert_in_rnn_block_('memory')
        if init is None:
            if shape is None or batch_ref is None:
                raise ValueError(
                    "if init is None, memory at least need shape and "
                    "batch_ref")
            parent_block = self._parent_block()
            var_name = unique_name.generate("@".join(
                [self.helper.name, "memory_boot"]))
            boot_var = parent_block.create_var(
                name=var_name, shape=shape, dtype=batch_ref.dtype,
                persistable=False)
            parent_block.append_op(
                type="fill_constant_batch_size_like",
                inputs={'Input': [batch_ref]},
                outputs={'Out': [boot_var]},
                attrs={'value': init_value,
                       'shape': [-1] + list(boot_var.shape[1:]),
                       'dtype': boot_var.dtype,
                       'input_dim_idx': ref_batch_dim_idx,
                       'output_dim_idx': init_batch_dim_idx})
            return self.memory(init=boot_var)
        else:
            pre_mem = self.helper.create_variable(
                name=unique_name.generate("@".join(
                    [self.helper.name, "mem"])),
                dtype=init.dtype, shape=init.shape)
            self.memories[pre_mem.name] = StaticRNNMemoryLink(
                init=init, pre_mem=pre_mem)
            return pre_mem

    def step_input(self, x):
        self._assert_in_rnn_block_('step_input')
        if self.seq_len is None:
            self.seq_len = x.shape[0]
        ipt = self.helper.create_variable(
            name=unique_name.generate("@".join(
                [self.helper.name, "step_in"])),
            dtype=x.dtype, shape=tuple(x.shape[1:]))
        self.inputs.append(x)
        self.step_inputs.append(ipt)
        return ipt

    def step_output(self, o):
        self._assert_in_rnn_block_('step_output')
        self.outputs.append(o)

    def output(self, *outputs):
        for each in outputs:
            self.step_output(each)

    def update_memory(self, mem, var):
        if not isinstance(mem, Variable) or not isinstance(var, Variable):
            raise TypeError("update memory should take variables")
        self.memories[mem.name].mem = var

    def _parent_block(self):
        prog = self.helper.main_program
        parent_idx = prog.current_block().parent_idx
        return prog.block(parent_idx)

    def __call__(self, *args, **kwargs):
        if self.status != StaticRNN.AFTER_RNN_BLOCK:
            raise ValueError("RNN output can only be retrieved after rnn "
                             "block")
        if len(self.outside_outputs) == 0:
            raise ValueError("RNN has no output")
        elif len(self.outside_outputs) == 1:
            return self.outside_outputs[0]
        else:
            return self.outside_outputs

    def _complete_op(self):
        main_program = self.helper.main_program
        rnn_block = main_program.current_block()
        parent_block = self._parent_block()
        self.outside_outputs = []
        for o in self.outputs:
            out = parent_block.create_var(
                name=unique_name.generate('static_rnn_out'),
                dtype=o.dtype,
                shape=(self.seq_len,) + tuple(o.shape))
            self.outside_outputs.append(out)
        parent_block.append_op(
            type='static_rnn',
            inputs={'Inputs': self.inputs,
                    'Boots': [m.init for m in self.memories.values()]},
            outputs={'Outputs': self.outside_outputs},
            attrs={'sub_block': rnn_block,
                   'step_inputs': [v.name for v in self.step_inputs],
                   'pre_mems': [m.pre_mem.name
                                for m in self.memories.values()],
                   'mems': [m.mem.name for m in self.memories.values()],
                   'step_outputs': [o.name for o in self.outputs]})


# ---- DynamicRNN -----------------------------------------------------------------
class DynamicRNN(object):
    """Variable-length RNN over SequenceTensor inputs, a masked loop
    over the padded steps (parity: control_flow.py::DynamicRNN, which
    shrinks the batch each step through lod_rank_table; the mask gives
    the same results, as in the JAX package)."""
    BEFORE_RNN = 0
    IN_RNN = 1
    AFTER_RNN = 2

    def __init__(self, name=None):
        self.helper = LayerHelper('dynamic_rnn', name=name)
        self.status = DynamicRNN.BEFORE_RNN
        self.inputs = []          # outside SequenceTensor vars
        self.step_inputs = []     # in-block per-step vars
        self.static_inputs = []   # (outside, inside) non-sequence vars
        self.memories = []        # (init_or_None, shape, value, pre, new)
        self.outputs = []
        self.outside_outputs = []
        self.max_seq_len_var = None

    @contextlib.contextmanager
    def block(self):
        if self.status != DynamicRNN.BEFORE_RNN:
            raise ValueError("rnn.block() can only be invoked once")
        self.status = DynamicRNN.IN_RNN
        with BlockGuard(self.helper.main_program):
            yield
            self.status = DynamicRNN.AFTER_RNN
            self._complete()

    def step_input(self, x):
        if self.status != DynamicRNN.IN_RNN:
            raise ValueError("step_input must be invoked inside rnn.block()")
        if x.lod_level < 1:
            raise ValueError("dynamic rnn input must be a sequence "
                             "(lod_level >= 1)")
        # build-time LoD shapes are packed [total, D]; the per-step view
        # keeps the feature dims with a free batch dim
        ipt = self.helper.create_variable(
            name=unique_name.generate('dyn_rnn_step_in'), dtype=x.dtype,
            shape=(-1,) + tuple(x.shape[1:]))
        self.inputs.append(x)
        self.step_inputs.append(ipt)
        return ipt

    def static_input(self, x):
        if self.status != DynamicRNN.IN_RNN:
            raise ValueError("static_input must be invoked inside "
                             "rnn.block()")
        inside = self.helper.create_variable(
            name=unique_name.generate('dyn_rnn_static_in'), dtype=x.dtype,
            shape=x.shape, lod_level=x.lod_level)
        self.static_inputs.append((x, inside))
        return inside

    def memory(self, init=None, shape=None, value=0.0, dtype='float32',
               need_reorder=False):
        """``need_reorder`` is a design no-op here: the reference sorts
        sequences by length (lod_rank_table) so an external ``init``
        must be re-ordered to match (control_flow.py:1442-1456); this
        DynamicRNN scans mask-padded batches in ORIGINAL batch order,
        so ``init`` rows already align with their sequences for either
        flag value."""
        if self.status != DynamicRNN.IN_RNN:
            raise ValueError("memory must be invoked inside rnn.block()")
        pre = self.helper.create_variable(
            name=unique_name.generate('dyn_rnn_mem'),
            dtype=init.dtype if init is not None else dtype,
            shape=init.shape if init is not None else
            (-1,) + tuple(shape or ()))
        self.memories.append({'init': init, 'shape': shape, 'value': value,
                              'pre': pre, 'new': None})
        return pre

    def update_memory(self, ex_mem, new_mem):
        for m in self.memories:
            if m['pre'] is ex_mem or m['pre'].name == ex_mem.name:
                m['new'] = new_mem
                return
        raise ValueError("unknown memory %s" % ex_mem.name)

    def output(self, *outputs):
        if self.status != DynamicRNN.IN_RNN:
            raise ValueError("output must be invoked inside rnn.block()")
        for o in outputs:
            self.outputs.append(o)

    def _complete(self):
        main_program = self.helper.main_program
        rnn_block = main_program.current_block()
        parent_block = main_program.block(rnn_block.parent_idx)
        self.outside_outputs = []
        for o in self.outputs:
            out = parent_block.create_var(
                name=unique_name.generate('dyn_rnn_out'),
                dtype=o.dtype,
                shape=(-1, -1) + tuple(o.shape[1:]), lod_level=1)
            self.outside_outputs.append(out)
        parent_block.append_op(
            type='dynamic_rnn',
            inputs={'Inputs': self.inputs,
                    'Statics': [s for s, _ in self.static_inputs],
                    'Boots': [m['init'] for m in self.memories
                              if m['init'] is not None]},
            outputs={'Outputs': self.outside_outputs},
            attrs={'sub_block': rnn_block,
                   'step_inputs': [v.name for v in self.step_inputs],
                   'static_inside': [i.name
                                     for _, i in self.static_inputs],
                   'mem_info': [
                       {'has_init': m['init'] is not None,
                        'pre': m['pre'].name,
                        'new': m['new'].name if m['new'] is not None
                        else m['pre'].name,
                        'shape': list(m['shape'] or ()),
                        'value': m['value']}
                       for m in self.memories],
                   'step_outputs': [o.name for o in self.outputs]})

    def __call__(self, *args, **kwargs):
        if self.status != DynamicRNN.AFTER_RNN:
            raise ValueError("Output of the dynamic RNN can only be visited "
                             "outside the rnn block.")
        if len(self.outside_outputs) == 1:
            return self.outside_outputs[0]
        return self.outside_outputs


class ParallelDo(object):
    """An API stub, as in the JAX package: the body runs once, on the
    whole batch (data parallelism is the Executor's business)."""

    def __init__(self, places, use_nccl=False, name=None):
        self.helper = LayerHelper("parallel_do", name=name)
        self._inputs = []
        self._outputs = []

    def do(self):
        @contextlib.contextmanager
        def _ctx():
            yield
        return _ctx()

    def read_input(self, var):
        self._inputs.append(var)
        return var

    def write_output(self, var):
        self._outputs.append(var)

    def __call__(self, *args, **kwargs):
        return self._outputs
