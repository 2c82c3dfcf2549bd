"""LayerHelper — shared machinery for the layers API.

Counterpart of paddle_tpu/layer_helper.py (no weight normalisation in
this slice). Creates parameters in the main program's global block and
their init ops in the startup program, temp vars, bias/activation
epilogues. Names come from ``unique_name`` with the same keys as
paddle_tpu's helper, so both packages name a model's variables alike.
"""
import copy

from .framework import default_main_program, default_startup_program, \
    Variable, convert_np_dtype
from . import unique_name
from .param_attr import ParamAttr
from .initializer import Xavier

__all__ = ['LayerHelper']


class LayerHelper(object):
    def __init__(self, layer_type, **kwargs):
        self.kwargs = kwargs
        self.layer_type = layer_type
        name = self.kwargs.get('name', None)
        if name is None:
            self.kwargs['name'] = unique_name.generate(self.layer_type)

    @property
    def name(self):
        return self.kwargs['name']

    @property
    def main_program(self):
        return default_main_program()

    @property
    def startup_program(self):
        return default_startup_program()

    def append_op(self, *args, **kwargs):
        return self.main_program.current_block().append_op(*args, **kwargs)

    def multiple_input(self, input_param_name='input'):
        inputs = self.kwargs.get(input_param_name, [])
        if isinstance(inputs, Variable):
            inputs = [inputs]
        return list(inputs)

    @property
    def param_attr(self):
        return ParamAttr.to_attr(self.kwargs.get('param_attr', None))

    @property
    def bias_attr(self):
        return ParamAttr.to_attr(self.kwargs.get('bias_attr', None))

    def multiple_param_attr(self, length):
        param_attr = self.param_attr
        if isinstance(param_attr, ParamAttr):
            param_attr = [param_attr]
        if len(param_attr) != 1 and len(param_attr) != length:
            raise ValueError("parameter number mismatch")
        elif len(param_attr) == 1 and length != 1:
            param_attr = [copy.deepcopy(param_attr[0])
                          for _ in range(length)]
        return param_attr

    def iter_inputs_and_params(self, input_param_name='input'):
        inputs = self.multiple_input(input_param_name)
        param_attrs = self.multiple_param_attr(len(inputs))
        for ipt, param_attr in zip(inputs, param_attrs):
            yield ipt, param_attr

    def input_dtype(self, input_param_name='input'):
        inputs = self.multiple_input(input_param_name)
        dtype = None
        for each in inputs:
            if dtype is None:
                dtype = each.dtype
            elif dtype != each.dtype:
                raise ValueError("Data Type mismatch: %s to %s" %
                                 (dtype, each.dtype))
        return dtype

    def create_parameter(self, attr, shape, dtype, is_bias=False,
                         default_initializer=None):
        if not isinstance(attr, ParamAttr):
            raise TypeError("attr must be a ParamAttr, got %r" % (attr,))
        if default_initializer is None:
            if is_bias:
                attr.set_default_bias_initializer()
            else:
                attr.set_default_initializer(Xavier())
        else:
            attr.set_default_initializer(default_initializer)
        if attr.name is None:
            attr.name = unique_name.generate(".".join([self.name, 'w']))

        startup_block = self.startup_program.global_block()
        sv = startup_block.create_var(
            name=attr.name, shape=[int(s) for s in shape],
            dtype=convert_np_dtype(dtype), persistable=True)
        attr.initializer(sv, startup_block)

        main_block = self.main_program.global_block()
        return main_block.create_parameter(
            shape=[int(s) for s in shape], dtype=convert_np_dtype(dtype),
            **attr.to_kwargs())

    def create_tmp_variable(self, dtype, stop_gradient=False, lod_level=None,
                            shape=None):
        return self.main_program.current_block().create_var(
            name=unique_name.generate(".".join([self.name, 'tmp'])),
            dtype=dtype, shape=shape or (),
            lod_level=lod_level if lod_level is not None else 0,
            stop_gradient=stop_gradient)

    def create_variable(self, *args, **kwargs):
        return self.main_program.current_block().create_var(*args, **kwargs)

    def create_global_variable(self, persistable=False, *args, **kwargs):
        return self.main_program.global_block().create_var(
            *args, persistable=persistable, **kwargs)

    def set_variable_initializer(self, var, initializer):
        startup_block = self.startup_program.global_block()
        sv = startup_block.create_var(
            name=var.name, shape=var.shape, dtype=var.dtype,
            persistable=True)
        initializer(sv, startup_block)
        return var

    def append_bias_op(self, input_var, dim_start=1, dim_end=None):
        size = list(input_var.shape[dim_start:dim_end])
        bias_attr = self.bias_attr
        if not bias_attr:
            return input_var
        if size and size[0] == -1:
            size = size[1:]
        b = self.create_parameter(attr=bias_attr, shape=size,
                                  dtype=input_var.dtype, is_bias=True)
        tmp = self.create_tmp_variable(dtype=input_var.dtype,
                                       shape=input_var.shape,
                                       lod_level=input_var.lod_level)
        self.append_op(
            type='elementwise_add', inputs={'X': [input_var], 'Y': [b]},
            outputs={'Out': [tmp]}, attrs={'axis': dim_start})
        return tmp

    def append_activation(self, input_var):
        act = self.kwargs.get('act', None)
        if act is None:
            return input_var
        if isinstance(act, str):
            act = {'type': act}
        act = copy.deepcopy(act)
        act_type = act.pop('type')
        tmp = self.create_tmp_variable(dtype=input_var.dtype,
                                       shape=input_var.shape,
                                       lod_level=input_var.lod_level)
        self.append_op(type=act_type, inputs={'X': [input_var]},
                       outputs={'Out': [tmp]}, attrs=act)
        return tmp
