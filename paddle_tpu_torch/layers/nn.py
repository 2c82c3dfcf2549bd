"""Neural-network layers.

Counterpart of paddle_tpu/layers/nn.py, trimmed to the layers the
flagship transformer and ResNet use. Same signatures and
the same op types, attrs and variable names as paddle_tpu's layers, so
a program built here matches one built there op for op.
"""
from .. import unique_name
from ..layer_helper import LayerHelper
from ..initializer import Constant, Normal
from ..param_attr import ParamAttr

__all__ = ['fc', 'embedding', 'conv2d', 'pool2d', 'batch_norm', 'layer_norm',
           'softmax', 'softmax_with_cross_entropy', 'split', 'reshape',
           'flash_attention', 'reduce_sum']


def _prod(dims):
    r = 1
    for d in dims:
        r *= int(d)
    return abs(r)


def _conv_out(size, k, p, s, d=1):
    if size < 0:
        return -1
    ke = d * (k - 1) + 1
    return (size + 2 * p - ke) // s + 1


def _pair(v):
    return list(v) if isinstance(v, (list, tuple)) else [v, v]


def fc(input, size, num_flatten_dims=1, param_attr=None, bias_attr=None,
       use_mkldnn=False, act=None, is_test=False, name=None):
    """Fully connected: each input gets a weight; results are summed;
    one shared bias; then activation."""
    helper = LayerHelper("fc", input=input, param_attr=param_attr,
                         bias_attr=bias_attr, act=act, name=name)
    dtype = helper.input_dtype()
    mul_results = []
    for input_var, p_attr in helper.iter_inputs_and_params():
        input_shape = input_var.shape
        param_shape = [_prod(input_shape[num_flatten_dims:])] + [size]
        w = helper.create_parameter(attr=p_attr, shape=param_shape,
                                    dtype=dtype, is_bias=False)
        out_shape = tuple(input_shape[:num_flatten_dims]) + (size,)
        tmp = helper.create_tmp_variable(dtype, shape=out_shape,
                                         lod_level=input_var.lod_level)
        helper.append_op(
            type="mul", inputs={"X": input_var, "Y": w},
            outputs={"Out": tmp},
            attrs={"x_num_col_dims": num_flatten_dims,
                   "y_num_col_dims": 1})
        mul_results.append(tmp)
    if len(mul_results) == 1:
        pre_bias = mul_results[0]
    else:
        pre_bias = helper.create_tmp_variable(
            dtype, shape=mul_results[0].shape,
            lod_level=mul_results[0].lod_level)
        helper.append_op(type="sum", inputs={"X": mul_results},
                         outputs={"Out": pre_bias})
    pre_activation = helper.append_bias_op(pre_bias,
                                           dim_start=num_flatten_dims)
    return helper.append_activation(pre_activation)


# Tables below this many elements take the dense gradient even with
# is_sparse=True, as in the JAX package (same threshold), so both build
# the same program.
_SPARSE_MIN_TABLE_ELEMS = [32 * 1024 * 1024]


def embedding(input, size, is_sparse=False, is_distributed=False,
              padding_idx=None, param_attr=None, dtype='float32'):
    """lookup_table op. ``is_sparse`` is recorded as the JAX package
    records it (the table is marked ``sparse_grad`` and the op gets a
    ``sparse_carrier``); training such a table raises in the lowering,
    since sparse row gradients are not ported."""
    helper = LayerHelper('embedding', param_attr=param_attr)
    w = helper.create_parameter(attr=helper.param_attr, shape=size,
                                dtype=dtype, is_bias=False)
    in_shape = tuple(input.shape)
    if in_shape and in_shape[-1] == 1:
        out_shape = in_shape[:-1] + (size[1],)
    else:
        out_shape = in_shape + (size[1],)
    tmp = helper.create_tmp_variable(dtype, shape=out_shape,
                                     lod_level=input.lod_level)
    padding_idx = -1 if padding_idx is None else (
        padding_idx if padding_idx >= 0 else size[0] + padding_idx)
    if is_sparse and _prod(size) < _SPARSE_MIN_TABLE_ELEMS[0]:
        is_sparse = False
    attrs = {'is_sparse': is_sparse, 'padding_idx': padding_idx}
    if is_sparse:
        w.sparse_grad = True
        attrs['sparse_carrier'] = unique_name.generate(w.name + '@SCARRIER')
    helper.append_op(type='lookup_table',
                     inputs={'Ids': input, 'W': w},
                     outputs={'Out': tmp},
                     attrs=attrs)
    return tmp


def conv2d(input, num_filters, filter_size, stride=1, padding=0, dilation=1,
           groups=None, param_attr=None, bias_attr=None, use_cudnn=True,
           use_mkldnn=False, act=None, name=None):
    """NCHW conv2d op, then the bias and activation ops."""
    num_channels = input.shape[1]
    helper = LayerHelper('conv2d', param_attr=param_attr,
                         bias_attr=bias_attr, act=act, name=name)
    dtype = helper.input_dtype()
    groups = groups or 1
    if num_channels % groups != 0:
        raise ValueError("num_channels must be divisible by groups")
    num_filter_channels = num_channels // groups
    filter_size = _pair(filter_size)
    stride = _pair(stride)
    padding = _pair(padding)
    dilation = _pair(dilation)
    filter_shape = [num_filters, int(num_filter_channels)] + \
        list(filter_size)
    std = (2.0 / (filter_size[0] ** 2 * num_channels)) ** 0.5
    filter_param = helper.create_parameter(
        attr=helper.param_attr, shape=filter_shape, dtype=dtype,
        default_initializer=Normal(0.0, std, 0))
    out_shape = (input.shape[0], num_filters,
                 _conv_out(input.shape[2], filter_size[0], padding[0],
                           stride[0], dilation[0]),
                 _conv_out(input.shape[3], filter_size[1], padding[1],
                           stride[1], dilation[1]))
    pre_bias = helper.create_tmp_variable(dtype, shape=out_shape)
    helper.append_op(
        type='conv2d',
        inputs={'Input': input, 'Filter': filter_param},
        outputs={'Output': pre_bias},
        attrs={'strides': list(stride), 'paddings': list(padding),
               'dilations': list(dilation), 'groups': groups,
               'use_cudnn': use_cudnn})
    pre_act = helper.append_bias_op(pre_bias, dim_start=1, dim_end=2)
    return helper.append_activation(pre_act)


def pool2d(input, pool_size=-1, pool_type="max", pool_stride=1,
           pool_padding=0, global_pooling=False, use_cudnn=True,
           ceil_mode=False, use_mkldnn=False, name=None,
           exclusive=True):
    if pool_type not in ["max", "avg"]:
        raise ValueError("pool_type must be 'max' or 'avg'")
    if global_pooling is False and pool_size == -1:
        raise ValueError("pool_size must be set when not global pooling")
    pool_size = _pair(pool_size)
    pool_padding = _pair(pool_padding)
    pool_stride = _pair(pool_stride)
    helper = LayerHelper('pool2d', name=name)
    if global_pooling:
        out_shape = (input.shape[0], input.shape[1], 1, 1)
    else:
        out_shape = (input.shape[0], input.shape[1],
                     _conv_out(input.shape[2], pool_size[0], pool_padding[0],
                               pool_stride[0]),
                     _conv_out(input.shape[3], pool_size[1], pool_padding[1],
                               pool_stride[1]))
    out = helper.create_tmp_variable(input.dtype, shape=out_shape)
    helper.append_op(type='pool2d', inputs={'X': input},
                     outputs={'Out': out},
                     attrs={'pooling_type': pool_type,
                            'exclusive': exclusive,
                            'ksize': pool_size,
                            'global_pooling': global_pooling,
                            'strides': pool_stride,
                            'paddings': pool_padding,
                            'ceil_mode': ceil_mode})
    return out


def batch_norm(input, act=None, is_test=False, momentum=0.9, epsilon=1e-05,
               param_attr=None, bias_attr=None, data_layout='NCHW',
               in_place=False, use_mkldnn=False, name=None,
               moving_mean_name=None, moving_variance_name=None,
               do_model_average_for_mean_and_var=False):
    """batch_norm op, then the activation op. The moving mean and
    variance are non-trainable parameters that the op's MeanOut and
    VarianceOut write back in train mode."""
    helper = LayerHelper('batch_norm', param_attr=param_attr,
                         bias_attr=bias_attr, act=act, name=name)
    dtype = input.dtype
    input_shape = input.shape
    if data_layout == 'NCHW':
        channel_num = input_shape[1] if len(input_shape) > 2 else \
            input_shape[-1]
    elif data_layout == 'NHWC':
        channel_num = input_shape[-1]
    else:
        raise ValueError("unsupported data layout: %s" % data_layout)
    param_shape = [int(channel_num)]
    scale = helper.create_parameter(attr=helper.param_attr,
                                    shape=param_shape, dtype=dtype,
                                    default_initializer=Constant(1.0))
    bias = helper.create_parameter(attr=helper.bias_attr, shape=param_shape,
                                   dtype=dtype, is_bias=True)
    mean = helper.create_parameter(
        attr=ParamAttr(name=moving_mean_name, initializer=Constant(0.0),
                       trainable=False),
        shape=param_shape, dtype=dtype)
    variance = helper.create_parameter(
        attr=ParamAttr(name=moving_variance_name, initializer=Constant(1.0),
                       trainable=False),
        shape=param_shape, dtype=dtype)
    mean.stop_gradient = True
    variance.stop_gradient = True
    saved_mean = helper.create_tmp_variable(dtype=dtype, stop_gradient=True)
    saved_variance = helper.create_tmp_variable(dtype=dtype,
                                                stop_gradient=True)
    batch_norm_out = input if in_place else \
        helper.create_tmp_variable(dtype, shape=input_shape)
    helper.append_op(
        type="batch_norm",
        inputs={"X": input, "Scale": scale, "Bias": bias, "Mean": mean,
                "Variance": variance},
        outputs={"Y": batch_norm_out, "MeanOut": mean,
                 "VarianceOut": variance, "SavedMean": saved_mean,
                 "SavedVariance": saved_variance},
        attrs={"momentum": momentum, "epsilon": epsilon,
               "is_test": is_test, "data_layout": data_layout})
    return helper.append_activation(batch_norm_out)


def layer_norm(input, scale=True, shift=True, begin_norm_axis=1,
               epsilon=1e-05, param_attr=None, bias_attr=None, act=None,
               name=None):
    helper = LayerHelper('layer_norm', param_attr=param_attr,
                         bias_attr=bias_attr, act=act, name=name)
    dtype = input.dtype
    input_shape = input.shape
    param_shape = [_prod(input_shape[begin_norm_axis:])]
    inputs = {'X': input}
    if scale:
        scale_p = helper.create_parameter(
            attr=helper.param_attr, shape=param_shape, dtype=dtype,
            default_initializer=Constant(1.0))
        inputs['Scale'] = scale_p
    if shift:
        bias_p = helper.create_parameter(attr=helper.bias_attr,
                                         shape=param_shape, dtype=dtype,
                                         is_bias=True)
        inputs['Bias'] = bias_p
    mean_out = helper.create_tmp_variable(dtype=dtype, stop_gradient=True)
    variance_out = helper.create_tmp_variable(dtype=dtype,
                                              stop_gradient=True)
    layer_norm_out = helper.create_tmp_variable(dtype, shape=input_shape)
    helper.append_op(type="layer_norm", inputs=inputs,
                     outputs={"Y": layer_norm_out, "Mean": mean_out,
                              "Variance": variance_out},
                     attrs={"epsilon": epsilon,
                            "begin_norm_axis": begin_norm_axis})
    return helper.append_activation(layer_norm_out)


def softmax(input, param_attr=None, bias_attr=None, use_cudnn=True,
            name=None):
    helper = LayerHelper('softmax', name=name)
    out = helper.create_tmp_variable(dtype=input.dtype, shape=input.shape,
                                     lod_level=input.lod_level)
    helper.append_op(type='softmax', inputs={'X': [input]},
                     outputs={'Out': [out]})
    return out


def softmax_with_cross_entropy(logits, label, soft_label=False):
    helper = LayerHelper('softmax_with_cross_entropy', **{})
    softmax_v = helper.create_tmp_variable(dtype=logits.dtype,
                                           shape=logits.shape)
    loss = helper.create_tmp_variable(
        dtype=logits.dtype, shape=tuple(logits.shape[:-1]) + (1,))
    helper.append_op(type='softmax_with_cross_entropy',
                     inputs={'Logits': logits, 'Label': label},
                     outputs={'Softmax': softmax_v, 'Loss': loss},
                     attrs={'soft_label': soft_label})
    return loss


def reshape(x, shape, actual_shape=None, act=None, inplace=True, name=None):
    """Static ``shape`` only in this slice (0 copies the input dim, -1
    is inferred); a list ``actual_shape`` overrides it."""
    helper = LayerHelper("reshape", name=name, act=act)
    if actual_shape is not None:
        if hasattr(actual_shape, 'name'):
            raise NotImplementedError(
                "reshape(actual_shape=<Variable>) is not ported yet")
        shape = [int(s) for s in actual_shape]
    new_shape = [x.shape[i] if s == 0 else s for i, s in enumerate(shape)]
    if -1 in new_shape:
        known = _prod([s for s in new_shape if s > 0])
        idx = new_shape.index(-1)
        if all(d >= 0 for d in x.shape) and known:
            new_shape[idx] = _prod(x.shape) // known
    out = helper.create_tmp_variable(dtype=x.dtype, shape=tuple(new_shape))
    helper.append_op(type="reshape", inputs={"X": x},
                     attrs={"shape": list(shape)}, outputs={"Out": out})
    return helper.append_activation(out)


def split(input, num_or_sections, dim=-1, name=None):
    helper = LayerHelper('split', name=name)
    input_shape = input.shape
    dim_ = dim if dim >= 0 else len(input_shape) + dim
    if isinstance(num_or_sections, int):
        num = num_or_sections
        sections = []
        seg = input_shape[dim_] // num if input_shape[dim_] > 0 else -1
        out_shapes = [tuple(s if i != dim_ else seg
                            for i, s in enumerate(input_shape))] * num
    else:
        sections = list(num_or_sections)
        num = len(sections)
        out_shapes = [tuple(s if i != dim_ else sec
                            for i, s in enumerate(input_shape))
                      for sec in sections]
    outs = [helper.create_tmp_variable(dtype=input.dtype, shape=sh)
            for sh in out_shapes]
    helper.append_op(type='split', inputs={'X': input},
                     outputs={'Out': outs},
                     attrs={'num': num if not sections else 0,
                            'sections': sections, 'axis': dim_})
    return outs


def flash_attention(q, k, v, num_heads=1, causal=True, name=None):
    """Multi-head scaled-dot-product attention. q/k/v: [B, T, D]
    variables; D is split into ``num_heads``. On the card the op runs
    the hand-written flash-attention kernel
    (ops/cuda_kernels.py::flash_attention)."""
    helper = LayerHelper('flash_attention', **locals())
    out = helper.create_tmp_variable(dtype=q.dtype, shape=q.shape)
    helper.append_op(
        type='flash_attention',
        inputs={'Q': q, 'K': k, 'V': v},
        outputs={'Out': out},
        attrs={'num_heads': num_heads, 'causal': causal})
    return out


def reduce_sum(input, dim=None, keep_dim=False, name=None):
    """reduce_sum op; ``dim=None`` reduces every axis to shape (1,)."""
    helper = LayerHelper('reduce_sum', name=name)
    if dim is None:
        shape = (1,)
    else:
        dims = [dim] if isinstance(dim, int) else list(dim)
        dims = [d if d >= 0 else d + len(input.shape) for d in dims]
        if keep_dim:
            shape = tuple(1 if i in dims else s
                          for i, s in enumerate(input.shape))
        else:
            shape = tuple(s for i, s in enumerate(input.shape)
                          if i not in dims) or (1,)
    out = helper.create_tmp_variable(dtype=input.dtype, shape=shape)
    helper.append_op(
        type='reduce_sum', inputs={'X': input}, outputs={'Out': out},
        attrs={'dim': dim if dim is not None else 0, 'keep_dim': keep_dim,
               'reduce_all': dim is None})
    return out
