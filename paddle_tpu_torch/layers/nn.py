"""Neural-network layers.

Counterpart of paddle_tpu/layers/nn.py, trimmed to the layers the
flagship transformer, ResNet, the sequence path (the sequence layers
and the recurrent layers) and the books use, with the tensor, math and
loss layers of the op library. Same signatures and
the same op types, attrs and variable names as paddle_tpu's layers, so
a program built here matches one built there op for op.
"""
from .. import unique_name
from ..layer_helper import LayerHelper
from ..initializer import Constant, Normal
from ..param_attr import ParamAttr

__all__ = ['fc', 'embedding', 'conv2d', 'pool2d', 'batch_norm', 'layer_norm',
           'dropout', 'softmax', 'cross_entropy', 'softmax_with_cross_entropy', 'split',
           'reshape',
           'flash_attention', 'reduce_sum', 'sequence_pool',
           'sequence_first_step', 'sequence_last_step', 'sequence_softmax',
           'sequence_expand', 'dynamic_lstm', 'dynamic_lstmp', 'dynamic_gru',
           'gru_unit', 'lstm_unit', 'square_error_cost', 'smooth_l1',
           'one_hot', 'squeeze', 'unsqueeze', 'transpose', 'matmul', 'topk',
           'reduce_mean', 'reduce_max', 'reduce_min', 'reduce_prod',
           'expand', 'gather', 'hinge_loss', 'huber_loss', 'log_loss',
           'rank_loss', 'margin_rank_loss', 'modified_huber_loss',
           'squared_l2_distance', 'squared_l2_norm', 'l1_norm', 'prelu',
           'maxout']


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


def dropout(x, dropout_prob, is_test=False, seed=None, name=None):
    """dropout op: x * mask in training (no rescale), x * (1 - p) at
    test; its ``Mask`` output is a tmp variable that nothing reads."""
    helper = LayerHelper('dropout', name=name)
    out = helper.create_tmp_variable(dtype=x.dtype, shape=x.shape,
                                     lod_level=x.lod_level)
    mask = helper.create_tmp_variable(dtype=x.dtype, stop_gradient=True)
    helper.append_op(type='dropout', inputs={'X': [x]},
                     outputs={'Out': [out], 'Mask': [mask]},
                     attrs={'dropout_prob': dropout_prob,
                            'is_test': is_test,
                            'seed': seed if seed is not None else 0})
    return out


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


def cross_entropy(input, label, soft_label=False):
    """cross_entropy op on probabilities: Y [..., 1]."""
    helper = LayerHelper('cross_entropy', **{})
    out = helper.create_tmp_variable(dtype=input.dtype,
                                     shape=tuple(input.shape[:-1]) + (1,),
                                     lod_level=input.lod_level)
    helper.append_op(type='cross_entropy',
                     inputs={'X': [input], 'Label': [label]},
                     outputs={'Y': [out]},
                     attrs={'soft_label': soft_label})
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


def _reduce_layer(op_type):
    """reduce_* layers; ``dim=None`` reduces every axis to shape (1,)."""
    def layer(input, dim=None, keep_dim=False, name=None):
        helper = LayerHelper(op_type, name=name)
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
            type=op_type, inputs={'X': input}, outputs={'Out': out},
            attrs={'dim': dim if dim is not None else 0,
                   'keep_dim': keep_dim, 'reduce_all': dim is None})
        return out
    layer.__name__ = op_type
    return layer


reduce_sum = _reduce_layer('reduce_sum')
reduce_mean = _reduce_layer('reduce_mean')
reduce_max = _reduce_layer('reduce_max')
reduce_min = _reduce_layer('reduce_min')
reduce_prod = _reduce_layer('reduce_prod')


# ---- tensor and math layers (kernels in ops/tensor_ops.py, math_ops.py) -------
def square_error_cost(input, label):
    helper = LayerHelper('square_error_cost', **{})
    out = helper.create_tmp_variable(dtype=input.dtype, shape=input.shape)
    helper.append_op(type='square_error_cost',
                     inputs={'X': [input], 'Label': [label]},
                     outputs={'Out': [out]})
    return out


def smooth_l1(x, y, inside_weight=None, outside_weight=None, sigma=None):
    helper = LayerHelper('smooth_l1_loss', **{})
    diff = helper.create_tmp_variable(dtype=x.dtype)
    loss = helper.create_tmp_variable(dtype=x.dtype,
                                      shape=(x.shape[0], 1))
    helper.append_op(type='smooth_l1',
                     inputs={'X': x, 'Y': y, 'InsideWeight': inside_weight,
                             'OutsideWeight': outside_weight},
                     outputs={'Diff': diff, 'Out': loss},
                     attrs={'sigma': sigma if sigma is not None else 1.0})
    return loss


def one_hot(input, depth):
    helper = LayerHelper("one_hot", **{})
    shape = tuple(input.shape[:-1]) + (depth,) if (
        input.shape and input.shape[-1] == 1) else \
        tuple(input.shape) + (depth,)
    one_hot_out = helper.create_tmp_variable(dtype='float32', shape=shape)
    helper.append_op(type="one_hot", inputs={'X': input},
                     attrs={'depth': depth},
                     outputs={'Out': one_hot_out})
    return one_hot_out


def squeeze(input, axes=None, name=None):
    helper = LayerHelper("squeeze", name=name)
    shape = [s for i, s in enumerate(input.shape)
             if not (s == 1 and (axes is None or i in axes))]
    out = helper.create_tmp_variable(dtype=input.dtype, shape=tuple(shape))
    helper.append_op(type="squeeze", inputs={"X": input},
                     attrs={"axes": axes or []}, outputs={"Out": out})
    return out


def unsqueeze(input, axes, name=None):
    helper = LayerHelper("unsqueeze", name=name)
    shape = list(input.shape)
    for a in sorted(axes):
        shape.insert(a, 1)
    out = helper.create_tmp_variable(dtype=input.dtype, shape=tuple(shape))
    helper.append_op(type="unsqueeze", inputs={"X": input},
                     attrs={"axes": list(axes)}, outputs={"Out": out})
    return out


def transpose(x, perm, name=None):
    if len(perm) != len(x.shape):
        raise ValueError("perm length must match input rank")
    helper = LayerHelper('transpose', name=name)
    out = helper.create_tmp_variable(
        x.dtype, shape=tuple(x.shape[p] for p in perm))
    helper.append_op(type='transpose', inputs={'X': [x]},
                     outputs={'Out': [out]}, attrs={'axis': list(perm)})
    return out


def matmul(x, y, transpose_x=False, transpose_y=False, alpha=1.0, name=None):
    helper = LayerHelper('matmul', name=name)
    xs = list(x.shape)
    ys = list(y.shape)
    if transpose_x and len(xs) >= 2:
        xs[-1], xs[-2] = xs[-2], xs[-1]
    if transpose_y and len(ys) >= 2:
        ys[-1], ys[-2] = ys[-2], ys[-1]
    batch = xs[:-2] if len(xs) > 2 else (ys[:-2] if len(ys) > 2 else [])
    m = xs[-2] if len(xs) >= 2 else 1
    n = ys[-1] if len(ys) >= 2 else 1
    out_shape = tuple(batch) + ((m, n) if (len(xs) >= 2 and len(ys) >= 2)
                                else (m,) if len(xs) >= 2 else (n,))
    out = helper.create_tmp_variable(dtype=x.dtype, shape=out_shape)
    helper.append_op(type='matmul', inputs={'X': x, 'Y': y},
                     outputs={'Out': out},
                     attrs={'transpose_X': transpose_x,
                            'transpose_Y': transpose_y, 'alpha': alpha})
    return out


def topk(input, k, name=None):
    helper = LayerHelper("top_k", name=name)
    shape = tuple(input.shape[:-1]) + (k,)
    values = helper.create_tmp_variable(dtype=input.dtype, shape=shape)
    indices = helper.create_tmp_variable(dtype="int64", shape=shape)
    helper.append_op(type="top_k", inputs={"X": [input]},
                     outputs={"Out": [values], "Indices": [indices]},
                     attrs={"k": k})
    values.stop_gradient = True
    indices.stop_gradient = True
    return values, indices


def expand(x, expand_times, name=None):
    """Tile x along each dim. Parity: paddle/fluid/operators/expand_op.cc."""
    helper = LayerHelper('expand', **{})
    shape = tuple(-1 if s < 0 else s * t
                  for s, t in zip(x.shape, expand_times))
    out = helper.create_tmp_variable(dtype=x.dtype, shape=shape)
    helper.append_op(type='expand', inputs={'X': [x]},
                     outputs={'Out': [out]},
                     attrs={'expand_times': list(expand_times)})
    return out


def gather(input, index):
    helper = LayerHelper('gather', **{})
    out = helper.create_tmp_variable(
        dtype=input.dtype,
        shape=(index.shape[0],) + tuple(input.shape[1:]))
    helper.append_op(type="gather",
                     inputs={"X": input, "Index": index},
                     outputs={"Out": out})
    return out


# ---- losses, norms, prelu, maxout (kernels in ops/misc_ops.py) ----------------
def _simple_loss(op_type, inputs, dtype, shape=None, attrs=None,
                 extra_outs=()):
    helper = LayerHelper(op_type, **{})
    out = helper.create_tmp_variable(dtype=dtype, shape=shape)
    outputs = {'Out': [out]}
    for slot in extra_outs:
        outputs[slot] = [helper.create_tmp_variable(dtype=dtype)]
    helper.append_op(type=op_type, inputs=inputs, outputs=outputs,
                     attrs=attrs or {})
    return out


def hinge_loss(input, label):
    """L = max(0, 1 - input * (2 * label - 1))."""
    helper = LayerHelper('hinge_loss', **{})
    out = helper.create_tmp_variable(dtype=input.dtype, shape=input.shape)
    helper.append_op(type='hinge_loss',
                     inputs={'Logits': [input], 'Labels': [label]},
                     outputs={'Loss': [out]})
    return out


def huber_loss(input, label, delta=1.0):
    return _simple_loss('huber_loss', {'X': [input], 'Y': [label]},
                        input.dtype, input.shape, {'delta': float(delta)},
                        extra_outs=('Residual',))


def log_loss(input, label, epsilon=1e-4, name=None):
    helper = LayerHelper('log_loss', name=name)
    out = helper.create_tmp_variable(dtype=input.dtype, shape=input.shape)
    helper.append_op(type='log_loss',
                     inputs={'Predicted': [input], 'Labels': [label]},
                     outputs={'Loss': [out]},
                     attrs={'epsilon': float(epsilon)})
    return out


def rank_loss(label, left, right, name=None):
    """The RankNet pairwise loss."""
    helper = LayerHelper('rank_loss', name=name)
    out = helper.create_tmp_variable(dtype=left.dtype, shape=left.shape)
    helper.append_op(type='rank_loss',
                     inputs={'Label': [label], 'Left': [left],
                             'Right': [right]},
                     outputs={'Out': [out]})
    return out


def margin_rank_loss(label, left, right, margin=0.1, name=None):
    """relu(-label * (left - right) + margin)."""
    helper = LayerHelper('margin_rank_loss', name=name)
    out = helper.create_tmp_variable(dtype=left.dtype, shape=left.shape)
    act = helper.create_tmp_variable(dtype=left.dtype)
    helper.append_op(type='margin_rank_loss',
                     inputs={'Label': [label], 'X1': [left], 'X2': [right]},
                     outputs={'Out': [out], 'Activated': [act]},
                     attrs={'margin': float(margin)})
    return out


def modified_huber_loss(input, label):
    return _simple_loss('modified_huber_loss',
                        {'X': [input], 'Y': [label]},
                        input.dtype, input.shape,
                        extra_outs=('IntermediateVal',))


def squared_l2_distance(x, y):
    """Rowwise ||x - y||^2, shape [N, 1]."""
    return _simple_loss('squared_l2_distance', {'X': [x], 'Y': [y]},
                        x.dtype, (x.shape[0], 1),
                        extra_outs=('sub_result',))


def squared_l2_norm(x):
    return _simple_loss('squared_l2_norm', {'X': [x]}, x.dtype, (1,))


def l1_norm(x):
    return _simple_loss('l1_norm', {'X': [x]}, x.dtype, (1,))


def prelu(x, mode='all', param_attr=None, name=None):
    """mode 'all': one alpha; 'channel': one a channel (NCHW dim 1). The
    alpha parameter has the JAX package's layout, [1] or [C]."""
    helper = LayerHelper('prelu', param_attr=param_attr, name=name)
    alpha_shape = [x.shape[1]] if mode == 'channel' and len(x.shape) > 1 \
        else [1]
    alpha = helper.create_parameter(attr=helper.param_attr,
                                    shape=alpha_shape, dtype=x.dtype,
                                    is_bias=False,
                                    default_initializer=Constant(0.25))
    out = helper.create_tmp_variable(dtype=x.dtype, shape=x.shape)
    helper.append_op(type='prelu',
                     inputs={'X': [x], 'Alpha': [alpha]},
                     outputs={'Out': [out]})
    return out


def maxout(x, groups, name=None):
    """NCHW, C_out = C // groups."""
    helper = LayerHelper('maxout', name=name)
    n, c, h, w = x.shape
    out = helper.create_tmp_variable(dtype=x.dtype,
                                     shape=(n, c // groups, h, w))
    helper.append_op(type='maxout', inputs={'X': [x]},
                     outputs={'Out': [out]}, attrs={'groups': groups})
    return out


# ---- sequence layers (kernels in ops/sequence_ops.py) ---------------------------
def sequence_pool(input, pool_type):
    helper = LayerHelper('sequence_pool', **{})
    dtype = input.dtype
    if getattr(input, 'lod_level', 1) >= 2:
        # pooling drops the innermost LoD level: still a sequence (now
        # level-1) of rows with the same feature dims — the declared
        # [-1, feat...] shape is unchanged, only the lod level drops
        pool_out = helper.create_tmp_variable(dtype, shape=input.shape,
                                              lod_level=1)
    else:
        out_shape = (input.shape[0],) + tuple(input.shape[2:]) \
            if len(input.shape) > 2 else input.shape
        pool_out = helper.create_tmp_variable(dtype, shape=out_shape)
    max_index = helper.create_tmp_variable(dtype='int32',
                                           stop_gradient=True)
    helper.append_op(type="sequence_pool",
                     inputs={"X": input},
                     outputs={"Out": pool_out, "MaxIndex": max_index},
                     attrs={"pooltype": pool_type.upper()})
    return pool_out


def sequence_first_step(input):
    return sequence_pool(input=input, pool_type="first")


def sequence_last_step(input):
    return sequence_pool(input=input, pool_type="last")


def sequence_softmax(input, param_attr=None, bias_attr=None,
                     use_cudnn=True):
    helper = LayerHelper('sequence_softmax', **{})
    out = helper.create_tmp_variable(dtype=input.dtype, shape=input.shape,
                                     lod_level=input.lod_level)
    helper.append_op(type="sequence_softmax", inputs={"X": input},
                     outputs={"Out": out})
    return out


def sequence_expand(x, y, name=None):
    helper = LayerHelper('sequence_expand', name=name)
    out = helper.create_tmp_variable(dtype=x.dtype, shape=x.shape,
                                     lod_level=max(1, y.lod_level))
    helper.append_op(type='sequence_expand', inputs={'X': x, 'Y': y},
                     outputs={'Out': out})
    return out


# ---- RNN layers (kernels in ops/rnn_ops.py) -------------------------------------
def dynamic_lstm(input, size, param_attr=None, bias_attr=None,
                 use_peepholes=True, is_reverse=False,
                 gate_activation='sigmoid', cell_activation='tanh',
                 candidate_activation='tanh', dtype='float32', name=None):
    helper = LayerHelper('lstm', param_attr=param_attr,
                         bias_attr=bias_attr, name=name)
    size = size // 4
    weight = helper.create_parameter(attr=helper.param_attr,
                                     shape=[size, 4 * size], dtype=dtype)
    bias_size = [1, 7 * size] if use_peepholes else [1, 4 * size]
    bias = helper.create_parameter(attr=helper.bias_attr, shape=bias_size,
                                   dtype=dtype, is_bias=True)
    hidden = helper.create_tmp_variable(
        dtype, shape=tuple(input.shape[:-1]) + (size,), lod_level=1)
    cell = helper.create_tmp_variable(
        dtype, shape=tuple(input.shape[:-1]) + (size,), lod_level=1)
    batch_gate = helper.create_tmp_variable(dtype, stop_gradient=True)
    batch_cell_pre_act = helper.create_tmp_variable(dtype,
                                                    stop_gradient=True)
    helper.append_op(
        type='dynamic_lstm',
        inputs={'Input': input, 'Weight': weight, 'Bias': bias},
        outputs={'Hidden': hidden, 'Cell': cell, 'BatchGate': batch_gate,
                 'BatchCellPreAct': batch_cell_pre_act},
        attrs={'use_peepholes': use_peepholes, 'is_reverse': is_reverse,
               'gate_activation': gate_activation,
               'cell_activation': cell_activation,
               'candidate_activation': candidate_activation})
    return hidden, cell


def dynamic_lstmp(input, size, proj_size, param_attr=None, bias_attr=None,
                  use_peepholes=True, is_reverse=False,
                  gate_activation='sigmoid', cell_activation='tanh',
                  candidate_activation='tanh', proj_activation='tanh',
                  dtype='float32', name=None):
    helper = LayerHelper('lstmp', param_attr=param_attr,
                         bias_attr=bias_attr, name=name)
    size = size // 4
    weight = helper.create_parameter(attr=helper.param_attr,
                                     shape=[proj_size, 4 * size],
                                     dtype=dtype)
    proj_weight = helper.create_parameter(attr=helper.param_attr,
                                          shape=[size, proj_size],
                                          dtype=dtype)
    bias_size = [1, 7 * size] if use_peepholes else [1, 4 * size]
    bias = helper.create_parameter(attr=helper.bias_attr, shape=bias_size,
                                   dtype=dtype, is_bias=True)
    projection = helper.create_tmp_variable(
        dtype, shape=tuple(input.shape[:-1]) + (proj_size,), lod_level=1)
    cell = helper.create_tmp_variable(
        dtype, shape=tuple(input.shape[:-1]) + (size,), lod_level=1)
    helper.append_op(
        type='dynamic_lstmp',
        inputs={'Input': input, 'Weight': weight,
                'ProjWeight': proj_weight, 'Bias': bias},
        outputs={'Projection': projection, 'Cell': cell},
        attrs={'use_peepholes': use_peepholes, 'is_reverse': is_reverse,
               'gate_activation': gate_activation,
               'cell_activation': cell_activation,
               'candidate_activation': candidate_activation,
               'proj_activation': proj_activation})
    return projection, cell


def dynamic_gru(input, size, param_attr=None, bias_attr=None,
                is_reverse=False, gate_activation='sigmoid',
                candidate_activation='tanh', h_0=None):
    helper = LayerHelper('gru', param_attr=param_attr,
                         bias_attr=None if bias_attr is False
                         else bias_attr)
    dtype = input.dtype
    weight = helper.create_parameter(attr=helper.param_attr,
                                     shape=[size, 3 * size], dtype=dtype)
    inputs = {'Input': input, 'Weight': weight}
    if bias_attr is not False:
        inputs['Bias'] = helper.create_parameter(
            attr=helper.bias_attr, shape=[1, 3 * size], dtype=dtype,
            is_bias=True)
    if h_0 is not None:
        inputs['H0'] = h_0
    hidden = helper.create_tmp_variable(
        dtype, shape=tuple(input.shape[:-1]) + (size,), lod_level=1)
    helper.append_op(type='dynamic_gru', inputs=inputs,
                     outputs={'Hidden': hidden},
                     attrs={'is_reverse': is_reverse,
                            'gate_activation': gate_activation,
                            'activation': candidate_activation})
    return hidden


def gru_unit(input, hidden, size, param_attr=None, bias_attr=None,
             activation='tanh', gate_activation='sigmoid'):
    helper = LayerHelper('gru_unit', param_attr=param_attr,
                         bias_attr=bias_attr)
    dtype = input.dtype
    size = size // 3
    weight = helper.create_parameter(attr=helper.param_attr,
                                     shape=[size, 3 * size], dtype=dtype)
    gate = helper.create_tmp_variable(dtype, shape=(input.shape[0],
                                                    3 * size))
    reset_hidden_pre = helper.create_tmp_variable(dtype)
    updated_hidden = helper.create_tmp_variable(dtype,
                                                shape=(input.shape[0],
                                                       size))
    inputs = {'Input': input, 'HiddenPrev': hidden, 'Weight': weight}
    if bias_attr is not False:
        bias_size = [1, 3 * size]
        bias = helper.create_parameter(attr=helper.bias_attr,
                                       shape=bias_size, dtype=dtype,
                                       is_bias=True)
        inputs['Bias'] = bias
    helper.append_op(type='gru_unit', inputs=inputs,
                     outputs={'Gate': gate,
                              'ResetHiddenPrev': reset_hidden_pre,
                              'Hidden': updated_hidden},
                     attrs={'activation': activation,
                            'gate_activation': gate_activation})
    return updated_hidden, reset_hidden_pre, gate


def lstm_unit(x_t, hidden_t_prev, cell_t_prev, forget_bias=0.0,
              param_attr=None, bias_attr=None, name=None):
    helper = LayerHelper('lstm_unit', name=name)
    if len(x_t.shape) != 2:
        raise ValueError("Rank of x_t must be 2.")
    size = cell_t_prev.shape[1]
    concat_out = concat_ = fc(input=[x_t, hidden_t_prev], size=4 * size,
                              param_attr=param_attr, bias_attr=bias_attr)
    cell_t = helper.create_tmp_variable(x_t.dtype,
                                        shape=(x_t.shape[0], size))
    hidden_t = helper.create_tmp_variable(x_t.dtype,
                                          shape=(x_t.shape[0], size))
    helper.append_op(type='lstm_unit',
                     inputs={"X": concat_out, "C_prev": cell_t_prev},
                     outputs={"C": cell_t, "H": hidden_t},
                     attrs={"forget_bias": forget_bias})
    return hidden_t, cell_t
