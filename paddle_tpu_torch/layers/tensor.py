"""Tensor layers. Counterpart of paddle_tpu/layers/tensor.py, trimmed to
``concat``, ``sums`` and ``fill_constant``."""
from ..layer_helper import LayerHelper

__all__ = ['concat', 'sums', 'fill_constant']


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
