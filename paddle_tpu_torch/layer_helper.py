"""LayerHelper — shared machinery for the layers API.

Counterpart of paddle_tpu/layer_helper.py. Creates parameters in the
main program's global block and their init ops in the startup program
(a ``WeightNormParamAttr`` makes its g and v pair and the recomposed
weight), temp vars, bias/activation epilogues. Names come from ``unique_name`` with the same keys as
paddle_tpu's helper, so both packages name a model's variables alike.
"""
import copy

from .framework import default_main_program, default_startup_program, \
    Variable, convert_np_dtype
from . import unique_name
from .param_attr import ParamAttr, WeightNormParamAttr
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

        if isinstance(attr, WeightNormParamAttr):
            param = self._create_weight_normalize(attr, shape, dtype)
            WeightNormParamAttr.params_with_weight_norm.append(param)
            return param

        startup_block = self.startup_program.global_block()
        sv = startup_block.create_var(
            name=attr.name, shape=[int(s) for s in shape],
            dtype=convert_np_dtype(dtype), persistable=True)
        attr.initializer(sv, startup_block)

        main_block = self.main_program.global_block()
        return main_block.create_parameter(
            shape=[int(s) for s in shape], dtype=convert_np_dtype(dtype),
            **attr.to_kwargs())

    def _weight_norm_tmp(self, block, tag, shape, dtype):
        return block.create_var(
            name=unique_name.generate(
                ".".join([self.name, 'weight_norm_' + tag])),
            dtype=dtype, shape=shape)

    def _append_norm_except_dim(self, block, x, x_shape, dim, out, dtype):
        """Append square -> reduce_sum (keep_dim) -> sqrt: the L2 norm of
        ``x`` over every axis but ``dim`` (all axes when None), shaped
        [1, .., x_shape[dim], .., 1], as paddle_tpu builds it."""
        ndim = len(x_shape)
        g_shape = [1] * ndim
        if dim is not None:
            g_shape[dim] = int(x_shape[dim])
        sq = self._weight_norm_tmp(block, 'sq', list(x_shape), dtype)
        block.append_op(type='square', inputs={'X': [x]},
                        outputs={'Out': [sq]})
        ssum = self._weight_norm_tmp(block, 'sum', g_shape, dtype)
        reduce_dims = None if dim is None else \
            [i for i in range(ndim) if i != dim]
        block.append_op(
            type='reduce_sum', inputs={'X': [sq]}, outputs={'Out': [ssum]},
            attrs={'dim': reduce_dims, 'keep_dim': True,
                   'reduce_all': dim is None})
        if out is None:
            out = self._weight_norm_tmp(block, 'norm', g_shape, dtype)
        block.append_op(type='sqrt', inputs={'X': [ssum]},
                        outputs={'Out': [out]})
        return out

    def _create_weight_normalize(self, attr, shape, dtype):
        """w = g * v / ||v||: the startup program initialises v with the
        attr's initializer and then g = ||v||, so w starts as that
        initializer's draw; the main program makes g and v parameters
        and recomposes w from them, so both get gradients."""
        dtype = convert_np_dtype(dtype)
        shape = [int(s) for s in shape]
        ndim = len(shape)
        dim = attr.dim
        if dim is not None:
            if not (-ndim <= dim < ndim):
                raise ValueError(
                    "WeightNormParamAttr.dim=%s out of range for a %d-D "
                    "parameter" % (dim, ndim))
            if dim < 0:
                dim += ndim
        g_shape = [1] * ndim
        if dim is not None:
            g_shape[dim] = shape[dim]

        g_attr = copy.deepcopy(attr)
        g_attr.name = attr.name + '_g'
        v_attr = copy.deepcopy(attr)
        v_attr.name = attr.name + '_v'

        startup_block = self.startup_program.global_block()
        sv = startup_block.create_var(
            name=v_attr.name, shape=shape, dtype=dtype, persistable=True)
        attr.initializer(sv, startup_block)
        sg = startup_block.create_var(
            name=g_attr.name, shape=g_shape, dtype=dtype, persistable=True)
        self._append_norm_except_dim(startup_block, sv, shape, dim, sg,
                                     dtype)

        main_block = self.main_program.global_block()
        g_param = main_block.create_parameter(
            shape=g_shape, dtype=dtype, **g_attr.to_kwargs())
        v_param = main_block.create_parameter(
            shape=shape, dtype=dtype, **v_attr.to_kwargs())

        block = self.main_program.current_block()
        norm = self._append_norm_except_dim(block, v_param, shape, dim,
                                            None, dtype)
        # the norm keeps v's rank (singleton axes), so a same-rank
        # broadcast recomposes w
        scale = self._weight_norm_tmp(block, 'scale', g_shape, dtype)
        block.append_op(
            type='elementwise_div', inputs={'X': [g_param], 'Y': [norm]},
            outputs={'Out': [scale]}, attrs={'axis': -1})
        w_param = self._weight_norm_tmp(block, 'w', shape, dtype)
        block.append_op(
            type='elementwise_mul', inputs={'X': [v_param], 'Y': [scale]},
            outputs={'Out': [w_param]}, attrs={'axis': -1})
        return w_param

    def get_parameter(self, name):
        return self.main_program.global_block().var(name)

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
