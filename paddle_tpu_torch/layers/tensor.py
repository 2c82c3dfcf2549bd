"""Tensor layers. Counterpart of paddle_tpu/layers/tensor.py, trimmed to
``create_tensor``, ``create_parameter``, ``create_global_var``,
``cast``, ``concat``, ``sums``, ``assign``, ``fill_constant``,
``fill_constant_batch_size_like``, ``ones``, ``zeros``, ``reverse``,
``argmax`` and ``argmin``."""
import numpy as np

from ..framework import Variable, convert_np_dtype
from ..initializer import Constant
from ..layer_helper import LayerHelper
from ..param_attr import ParamAttr

__all__ = ['create_tensor', 'create_parameter', 'create_global_var',
           'cast', 'concat', 'sums', 'assign', 'fill_constant',
           'fill_constant_batch_size_like', 'ones', 'zeros', 'reverse',
           'argmax', 'argmin']


def create_tensor(dtype, name=None, persistable=False):
    helper = LayerHelper("create_tensor", name=name)
    return helper.create_variable(name=helper.name, dtype=dtype,
                                  persistable=persistable)


def create_parameter(shape, dtype, name=None, attr=None, is_bias=False,
                     default_initializer=None):
    helper = LayerHelper("create_parameter", name=name)
    if attr is None:
        attr = ParamAttr(name=name)
    return helper.create_parameter(attr, shape, dtype, is_bias,
                                   default_initializer)


def create_global_var(shape, value, dtype, persistable=False,
                      force_cpu=False, name=None):
    helper = LayerHelper("global_var", name=name)
    var = helper.create_global_variable(dtype=dtype, shape=tuple(shape),
                                        persistable=persistable,
                                        name=name)
    helper.set_variable_initializer(var,
                                    initializer=Constant(value=float(value)))
    return var


def cast(x, dtype):
    helper = LayerHelper('cast', **{})
    dtype = convert_np_dtype(dtype)
    out = helper.create_tmp_variable(dtype=dtype, shape=x.shape,
                                     lod_level=x.lod_level)
    helper.append_op(type='cast', inputs={'X': [x]}, outputs={'Out': [out]},
                     attrs={'in_dtype': x.dtype, 'out_dtype': dtype})
    return out


def concat(input, axis=0, name=None):
    helper = LayerHelper('concat', name=name)
    shape = list(input[0].shape)
    if shape:
        total = 0
        for v in input:
            vs = list(v.shape or ())
            s = vs[axis] if -len(vs) <= axis < len(vs) else -1
            if s < 0:
                total = -1
                break
            total += s
        shape[axis] = total
    out = helper.create_tmp_variable(dtype=input[0].dtype,
                                     shape=tuple(shape))
    helper.append_op(type='concat', inputs={'X': list(input)},
                     outputs={'Out': [out]}, attrs={'axis': axis})
    return out


def sums(input, out=None):
    helper = LayerHelper('sum', **{})
    xs = input if isinstance(input, (list, tuple)) else [input]
    if out is None:
        out = helper.create_tmp_variable(dtype=xs[0].dtype,
                                         shape=xs[0].shape)
    helper.append_op(type='sum', inputs={'X': list(xs)},
                     outputs={'Out': out})
    return out


def assign(input, output=None):
    helper = LayerHelper('assign', **{})
    if isinstance(input, Variable):
        if output is None:
            output = helper.create_tmp_variable(dtype=input.dtype,
                                                shape=input.shape,
                                                lod_level=input.lod_level)
        helper.append_op(type='assign', inputs={'X': [input]},
                         outputs={'Out': [output]})
    elif isinstance(input, np.ndarray):
        if output is None:
            output = helper.create_tmp_variable(dtype=str(input.dtype),
                                                shape=input.shape)
        helper.append_op(type='assign_value', outputs={'Out': [output]},
                         attrs={'shape': list(input.shape),
                                'dtype': str(input.dtype),
                                'values': input.flatten().tolist()})
    else:
        raise ValueError("Wrong type for assign input: %s" % type(input))
    return output


def fill_constant(shape, dtype, value, force_cpu=False, out=None):
    helper = LayerHelper("fill_constant", **{})
    if out is None:
        out = helper.create_tmp_variable(dtype=dtype, shape=tuple(shape))
    helper.append_op(type='fill_constant', outputs={'Out': [out]},
                     attrs={'shape': list(shape), 'dtype': dtype,
                            'value': float(value)})
    out.stop_gradient = True
    return out


def fill_constant_batch_size_like(input, shape, dtype, value,
                                  input_dim_idx=0, output_dim_idx=0):
    helper = LayerHelper("fill_constant_batch_size_like", **{})
    s = list(shape)
    s[output_dim_idx] = -1
    out = helper.create_tmp_variable(dtype=dtype, shape=tuple(s))
    helper.append_op(type='fill_constant_batch_size_like',
                     inputs={'Input': input}, outputs={'Out': [out]},
                     attrs={'shape': list(shape), 'dtype': dtype,
                            'value': float(value),
                            'input_dim_idx': input_dim_idx,
                            'output_dim_idx': output_dim_idx})
    out.stop_gradient = True
    return out


def ones(shape, dtype, force_cpu=False):
    return fill_constant(value=1.0, shape=shape, dtype=dtype)


def zeros(shape, dtype, force_cpu=False):
    return fill_constant(value=0.0, shape=shape, dtype=dtype)


def reverse(x, axis):
    """``x`` flipped along ``axis`` (an int or a list)."""
    helper = LayerHelper("reverse", **{})
    out = helper.create_tmp_variable(dtype=x.dtype, shape=x.shape)
    helper.append_op(type='reverse', inputs={'X': x},
                     outputs={'Out': [out]}, attrs={'axis': axis})
    return out


def argmax(x, axis=0):
    """The index of the largest element along ``axis`` (int64; the
    first on ties)."""
    helper = LayerHelper("arg_max", **{})
    out = helper.create_tmp_variable('int64')
    helper.append_op(type='arg_max', inputs={'X': x},
                     outputs={'Out': [out]}, attrs={'axis': axis})
    return out


def argmin(x, axis=0):
    """The index of the smallest element along ``axis`` (int64; the
    first on ties)."""
    helper = LayerHelper("arg_min", **{})
    out = helper.create_tmp_variable('int64')
    helper.append_op(type='arg_min', inputs={'X': x},
                     outputs={'Out': [out]}, attrs={'axis': axis})
    return out
