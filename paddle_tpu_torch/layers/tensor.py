"""Tensor layers. Counterpart of paddle_tpu/layers/tensor.py, trimmed to
``create_parameter``, ``cast``, ``concat``, ``sums``, ``fill_constant``
and ``fill_constant_batch_size_like``."""
from ..framework import convert_np_dtype
from ..layer_helper import LayerHelper
from ..param_attr import ParamAttr

__all__ = ['create_parameter', 'cast', 'concat', 'sums', 'fill_constant',
           'fill_constant_batch_size_like']


def create_parameter(shape, dtype, name=None, attr=None, is_bias=False,
                     default_initializer=None):
    helper = LayerHelper("create_parameter", name=name)
    if attr is None:
        attr = ParamAttr(name=name)
    return helper.create_parameter(attr, shape, dtype, is_bias,
                                   default_initializer)


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
