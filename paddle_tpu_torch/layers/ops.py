"""Single-op layers.

Counterpart of paddle_tpu/layers/ops.py, trimmed to the op types the
port runs: each name is a thin layer function
appending one op of the same type. The random layers draw from the
scope's generator unless given a non-zero ``seed``; the
``*_batch_size_like`` ones take their batch from ``input=``.
"""
from ..layer_helper import LayerHelper
from ..framework import Variable

# the activations of ops/activations.py, as paddle_tpu names them
__activations__ = [
    'sigmoid', 'logsigmoid', 'exp', 'relu', 'tanh', 'tanh_shrink',
    'softshrink', 'sqrt', 'abs', 'ceil', 'floor', 'round', 'reciprocal',
    'log', 'square', 'softplus', 'softsign', 'brelu', 'leaky_relu',
    'soft_relu', 'elu', 'relu6', 'pow', 'stanh', 'hard_shrink',
    'thresholded_relu', 'hard_sigmoid', 'swish', 'cos', 'sin',
]

__all__ = ['mean', 'mul', 'scale', 'sigmoid_cross_entropy_with_logits',
           'elementwise_add', 'elementwise_sub',
           'elementwise_mul', 'elementwise_div', 'elementwise_max',
           'elementwise_min', 'elementwise_pow', 'clip', 'clip_by_norm',
           'logical_and', 'logical_or', 'logical_xor', 'logical_not',
           'sign', 'uniform_random', 'uniform_random_batch_size_like',
           'gaussian_random', 'gaussian_random_batch_size_like',
           'cumsum', 'scatter', 'sum'] + __activations__

_BINARY = {'elementwise_add', 'elementwise_div', 'elementwise_sub',
           'elementwise_mul', 'elementwise_max', 'elementwise_min',
           'elementwise_pow', 'logical_and', 'logical_or', 'logical_xor',
           'mul'}

_SLOT_MAP = {
    'scatter': ('X', 'Ids', 'Updates'),
    'sigmoid_cross_entropy_with_logits': ('X', 'Label'),
}


def _gen_layer(op_type):
    def layer(*args, **kwargs):
        helper = LayerHelper(op_type, **kwargs)
        inputs = {}
        attrs = {}
        arg_vals = list(args)
        slots = _SLOT_MAP.get(
            op_type, ('X', 'Y') if op_type in _BINARY else ('X',))
        for slot in slots:
            lk = slot.lower()
            if lk in kwargs:
                inputs[slot] = kwargs.pop(lk)
            elif arg_vals:
                inputs[slot] = arg_vals.pop(0)
        for k, v in kwargs.items():
            if k in ('name', 'act', 'param_attr', 'bias_attr'):
                continue
            if isinstance(v, Variable):
                inputs[k.capitalize() if k != 'ids' else 'Ids'] = v
            else:
                attrs[k] = v
        src = next((v for v in inputs.values() if isinstance(v, Variable)),
                   None)
        dtype = src.dtype if src is not None else attrs.get('dtype',
                                                            'float32')
        out = helper.create_tmp_variable(
            dtype=dtype, lod_level=src.lod_level if src is not None else 0,
            shape=src.shape if src is not None else ())
        helper.append_op(type=op_type, inputs=inputs,
                         outputs={'Out': out}, attrs=attrs)
        return helper.append_activation(out)
    layer.__name__ = op_type
    layer.__doc__ = "Layer wrapper for op %r (see paddle_tpu_torch.ops)." \
        % op_type
    return layer


for _op in set(__all__) - {'mean', 'sum', 'uniform_random',
                           'gaussian_random'}:
    globals()[_op] = _gen_layer(_op)


def mean(x=None, **kwargs):
    helper = LayerHelper('mean', **kwargs)
    x = x if x is not None else kwargs.get('input')
    out = helper.create_tmp_variable(dtype=x.dtype, shape=(1,))
    helper.append_op(type='mean', inputs={'X': x}, outputs={'Out': out})
    return out



def sum(input, **kwargs):
    """The elementwise sum of a list of Variables (or of one), a
    ``sum`` op."""
    helper = LayerHelper('sum', **kwargs)
    xs = input if isinstance(input, (list, tuple)) else [input]
    out = helper.create_tmp_variable(dtype=xs[0].dtype, shape=xs[0].shape,
                                     lod_level=xs[0].lod_level)
    helper.append_op(type='sum', inputs={'X': list(xs)},
                     outputs={'Out': out})
    return out


def uniform_random(shape, dtype='float32', min=-1.0, max=1.0, seed=0,
                   **kwargs):
    helper = LayerHelper('uniform_random', **kwargs)
    out = helper.create_tmp_variable(dtype=dtype, shape=tuple(shape))
    helper.append_op(type='uniform_random', outputs={'Out': out},
                     attrs={'shape': list(shape), 'dtype': dtype,
                            'min': min, 'max': max, 'seed': seed})
    return out


def gaussian_random(shape, dtype='float32', mean=0.0, std=1.0, seed=0,
                    **kwargs):
    helper = LayerHelper('gaussian_random', **kwargs)
    out = helper.create_tmp_variable(dtype=dtype, shape=tuple(shape))
    helper.append_op(type='gaussian_random', outputs={'Out': out},
                     attrs={'shape': list(shape), 'dtype': dtype,
                            'mean': mean, 'std': std, 'seed': seed})
    return out
