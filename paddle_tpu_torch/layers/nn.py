"""Neural-network layers.

Counterpart of paddle_tpu/layers/nn.py, trimmed to the layers the
flagship transformer, ResNet, the sequence path (the sequence layers
and the recurrent layers) and the books use, with the tensor, math and
loss layers of the op library. Same signatures and
the same op types, attrs and variable names as paddle_tpu's layers, so
a program built here matches one built there op for op.
"""
import warnings

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
           'maxout', 'im2sequence', 'row_conv', 'sequence_conv',
           'sequence_reshape', 'lod_reset', 'beam_search',
           'beam_search_decode', 'sequence_concat',
           'autoincreased_step_counter', 'cos_sim', 'linear_chain_crf',
           'crf_decoding', 'chunk_eval', 'conv2d_transpose', 'l2_normalize',
           'multiplex', 'lrn', 'pad', 'label_smooth', 'dice_loss',
           'bilinear_interp', 'nce', 'max_pool2d_with_index', 'unpool',
           'spp', 'roi_pool', 'warpctc', 'ctc_greedy_decoder',
           'edit_distance']


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
# is_sparse=True, as in the JAX package (the same threshold and setter),
# so both build the same program. The two paths give the same values up
# to the order of sums, but that lazy Adam leaves the rows a step did not
# touch where they were.
_SPARSE_MIN_TABLE_ELEMS = [32 * 1024 * 1024]
_SPARSE_FALLBACK_WARNED = [False]


def set_sparse_fallback_threshold(n_elems):
    """Set the table size (elements of [vocab, dim]) below which
    is_sparse=True takes the dense gradient; returns the previous one.
    0 always honors is_sparse=True."""
    prev = _SPARSE_MIN_TABLE_ELEMS[0]
    _SPARSE_MIN_TABLE_ELEMS[0] = int(n_elems)
    return prev


def embedding(input, size, is_sparse=False, is_distributed=False,
              padding_idx=None, param_attr=None, dtype='float32'):
    """lookup_table op. With ``is_sparse`` (a table of at least
    ``_SPARSE_MIN_TABLE_ELEMS`` elements) the table is marked
    ``sparse_grad`` and the op gets a ``sparse_carrier``: the lowering
    differentiates the gathered rows instead of the table, and SGD,
    Adagrad and Adam update only the rows a step touched
    (core/lowering.py, ``SparseRows``). A smaller table takes the dense
    gradient, once-a-process warned, as in the JAX package."""
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
        if not _SPARSE_FALLBACK_WARNED[0]:
            _SPARSE_FALLBACK_WARNED[0] = True
            warnings.warn(
                "embedding(is_sparse=True) on a %s table (< %d elements) "
                "takes the dense gradient path, as paddle_tpu's does. "
                "The values are the same; override with "
                "set_sparse_fallback_threshold(0)."
                % ('x'.join(str(s) for s in size),
                   _SPARSE_MIN_TABLE_ELEMS[0]))
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
    """``shape``: 0 copies the input dim, -1 is inferred. A list
    ``actual_shape`` overrides it when the program is built; a Variable
    ``actual_shape`` becomes the op's ``Shape`` input and wins at run
    time (reference nn.py:3441-3529). Fed, its value is bound as a
    static value: the Executor reads it on the host once a run and keys
    its memo on it, so a new value lowers anew and an old one hits, as
    paddle_tpu's static feed does; computed in the graph, the kernel
    reads it from the device."""
    helper = LayerHelper("reshape", name=name, act=act)
    if actual_shape is not None and not hasattr(actual_shape, 'name'):
        shape = [int(s) for s in actual_shape]
    new_shape = [x.shape[i] if s == 0 else s for i, s in enumerate(shape)]
    if -1 in new_shape:
        known = _prod([s for s in new_shape if s > 0])
        idx = new_shape.index(-1)
        if all(d >= 0 for d in x.shape) and known:
            new_shape[idx] = _prod(x.shape) // known
    out = helper.create_tmp_variable(dtype=x.dtype, shape=tuple(new_shape))
    inputs = {"X": x}
    if actual_shape is not None and hasattr(actual_shape, 'name'):
        inputs["Shape"] = actual_shape
    helper.append_op(type="reshape", inputs=inputs,
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


def cos_sim(X, Y):
    """Row-wise cosine similarity [N, 1] (the cos_sim op, with its
    XNorm and YNorm outputs)."""
    helper = LayerHelper('cos_sim', **{})
    out = helper.create_tmp_variable(dtype=X.dtype,
                                     shape=(X.shape[0], 1))
    xnorm = helper.create_tmp_variable(dtype=X.dtype)
    ynorm = helper.create_tmp_variable(dtype=X.dtype)
    helper.append_op(type='cos_sim', inputs={'X': [X], 'Y': [Y]},
                     outputs={'Out': [out], 'XNorm': [xnorm],
                              'YNorm': [ynorm]})
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


def autoincreased_step_counter(counter_name=None, begin=1, step=1):
    """A persistable int64 counter that the main program increments
    once a run, before anything else reads it: the startup program sets
    it to ``begin - 1``, and an ``increment`` by ``step`` is prepended
    to the global block once per program (later calls with the same
    name return the same counter). As paddle_tpu's."""
    helper = LayerHelper('global_step_counter')
    if counter_name is None:
        counter_name = '@STEP_COUNTER@'
    program = helper.main_program
    counter = program.global_block().create_var(
        name=counter_name, dtype='int64', shape=(1,), persistable=True)
    startup = helper.startup_program.global_block()
    sv = startup.create_var(name=counter_name, dtype='int64', shape=(1,),
                            persistable=True)
    Constant(value=float(begin - 1))(sv, startup)
    if not getattr(counter, '_step_op_added', False):
        program.global_block().prepend_op(
            type='increment', inputs={'X': [counter]},
            outputs={'Out': [counter]}, attrs={'step': float(step)})
        counter._step_op_added = True
    counter.stop_gradient = True
    return counter


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


# ---- the sequence, beam-search and patch layers of the control-flow slice


def im2sequence(input, filter_size=1, stride=1, padding=0, name=None):
    helper = LayerHelper('im2sequence', name=name)
    filter_size = _pair(filter_size)
    stride = _pair(stride)
    if isinstance(padding, int):
        padding = [padding, padding]
    if len(padding) == 2:
        padding.append(padding[0])
        padding.append(padding[1])
    # a row per patch: [-1, C * kh * kw] (im2sequence_op.cc InferShape)
    shape = None
    if len(input.shape) == 4 and int(input.shape[1]) > 0:
        shape = (-1, int(input.shape[1]) * filter_size[0] * filter_size[1])
    out = helper.create_tmp_variable(dtype=input.dtype, shape=shape,
                                     lod_level=1)
    helper.append_op(type='im2sequence', inputs={'X': input},
                     outputs={'Out': out},
                     attrs={'kernels': filter_size, 'strides': stride,
                            'paddings': padding})
    return out


def row_conv(input, future_context_size, param_attr=None, act=None):
    helper = LayerHelper('row_conv', param_attr=param_attr, act=act)
    dtype = input.dtype
    filter_shape = [future_context_size + 1, input.shape[-1]]
    filter_param = helper.create_parameter(attr=helper.param_attr,
                                           shape=filter_shape, dtype=dtype)
    out = helper.create_tmp_variable(dtype, shape=input.shape,
                                     lod_level=input.lod_level)
    helper.append_op(type='row_conv',
                     inputs={'X': [input], 'Filter': [filter_param]},
                     outputs={'Out': [out]})
    return helper.append_activation(out)


def sequence_conv(input, num_filters, filter_size=3, filter_stride=1,
                  padding=None, bias_attr=None, param_attr=None, act=None):
    helper = LayerHelper('sequence_conv', param_attr=param_attr,
                         bias_attr=bias_attr, act=act)
    dtype = input.dtype
    filter_shape = [filter_size * input.shape[-1], num_filters]
    filter_param = helper.create_parameter(attr=helper.param_attr,
                                           shape=filter_shape, dtype=dtype)
    pre_bias = helper.create_tmp_variable(
        dtype, shape=tuple(input.shape[:-1]) + (num_filters,), lod_level=1)
    helper.append_op(type='sequence_conv',
                     inputs={'X': [input], 'Filter': [filter_param]},
                     outputs={'Out': pre_bias},
                     attrs={'contextStride': filter_stride,
                            'contextStart': -int(filter_size // 2),
                            'contextLength': filter_size})
    pre_act = helper.append_bias_op(pre_bias, dim_start=len(
        pre_bias.shape) - 1)
    return helper.append_activation(pre_act)


def sequence_reshape(input, new_dim):
    helper = LayerHelper('sequence_reshape', **{})
    out = helper.create_tmp_variable(
        dtype=input.dtype,
        shape=tuple(input.shape[:-1]) + (new_dim,), lod_level=1)
    helper.append_op(type='sequence_reshape', inputs={'X': [input]},
                     outputs={'Out': [out]},
                     attrs={'new_dim': new_dim})
    return out


def lod_reset(x, y=None, target_lod=None):
    helper = LayerHelper('lod_reset', **{})
    out = helper.create_tmp_variable(dtype=x.dtype, shape=x.shape,
                                     lod_level=1)
    if y is not None:
        helper.append_op(type="lod_reset", inputs={'X': x, 'Y': y},
                         outputs={'Out': out})
    elif target_lod is not None:
        helper.append_op(type="lod_reset", inputs={'X': x},
                         attrs={'target_lod': list(target_lod)},
                         outputs={'Out': out})
    else:
        raise ValueError("y and target_lod should not be both None.")
    return out


def beam_search(pre_ids, ids, scores, beam_size, end_id, level=0):
    helper = LayerHelper('beam_search', **{})
    score_type = scores.dtype
    id_type = ids.dtype
    selected_scores = helper.create_tmp_variable(dtype=score_type,
                                                 lod_level=2)
    selected_ids = helper.create_tmp_variable(dtype=id_type, lod_level=2)
    # the parent beam rows are an explicit output, as in the JAX package
    # (the reference recovers them from LoD offsets); the static
    # beam_search_decode consumes them
    parent_idx = helper.create_tmp_variable(dtype='int32')
    helper.append_op(type='beam_search',
                     inputs={'pre_ids': pre_ids, 'ids': ids,
                             'scores': scores},
                     outputs={'selected_ids': selected_ids,
                              'selected_scores': selected_scores,
                              'parent_idx': parent_idx},
                     attrs={'level': level, 'beam_size': beam_size,
                            'end_id': end_id})
    selected_ids.parent_idx = parent_idx
    return selected_ids, selected_scores


def beam_search_decode(ids, scores, parents=None, name=None):
    """ids/scores: tensor arrays (array_write once per step). parents:
    the matching array of parent_idx outputs from beam_search (required
    by the static [B*K] backtrack)."""
    helper = LayerHelper('beam_search_decode', name=name)
    sentence_ids = helper.create_tmp_variable(dtype=ids.dtype, lod_level=2)
    sentence_scores = helper.create_tmp_variable(dtype=scores.dtype,
                                                 lod_level=2)
    inputs = {"Ids": ids, "Scores": scores}
    if parents is not None:
        inputs["Parents"] = parents
    helper.append_op(type="beam_search_decode",
                     inputs=inputs,
                     outputs={"SentenceIds": sentence_ids,
                              "SentenceScores": sentence_scores})
    return sentence_ids, sentence_scores


def sequence_concat(input, name=None):
    """Concatenate corresponding sequences along time. Parity:
    operators/sequence_concat_op.cc (axis-0, level-0 concat of LoD
    tensors)."""
    helper = LayerHelper('sequence_concat', **locals())
    out = helper.create_tmp_variable(
        dtype=helper.input_dtype(input_param_name='input'),
        shape=input[0].shape, lod_level=input[0].lod_level)
    helper.append_op(type='sequence_concat', inputs={'X': input},
                     outputs={'Out': out})
    return out


# ---- the CRF family (kernels in ops/crf_ops.py) ---------------------------------
def linear_chain_crf(input, label, param_attr=None):
    """The negative log-likelihood of ``label`` under a linear-chain CRF
    over the emissions ``input`` ([B, 1] per sequence); the transition
    parameter is [size + 2, size]: start row, end row, then the
    tag-to-tag weights."""
    helper = LayerHelper('linear_chain_crf', param_attr=param_attr)
    size = input.shape[-1]
    transition = helper.create_parameter(attr=helper.param_attr,
                                         shape=[size + 2, size],
                                         dtype=helper.input_dtype())
    alpha = helper.create_tmp_variable(dtype=helper.input_dtype())
    emission_exps = helper.create_tmp_variable(dtype=helper.input_dtype())
    transition_exps = helper.create_tmp_variable(dtype=helper.input_dtype())
    log_likelihood = helper.create_tmp_variable(dtype=helper.input_dtype())
    helper.append_op(type='linear_chain_crf',
                     inputs={"Emission": [input], "Transition": transition,
                             "Label": label},
                     outputs={"Alpha": [alpha],
                              "EmissionExps": [emission_exps],
                              "TransitionExps": transition_exps,
                              "LogLikelihood": log_likelihood})
    return log_likelihood


def crf_decoding(input, param_attr, label=None):
    """The Viterbi path under the transition parameter
    ``param_attr.name``; with ``label``, 1 where the path agrees with
    it, else 0."""
    helper = LayerHelper('crf_decoding', **{})
    transition = helper.get_parameter(param_attr.name)
    viterbi_path = helper.create_tmp_variable(dtype='int64', lod_level=1)
    inputs = {"Emission": [input], "Transition": transition}
    if label is not None:
        inputs["Label"] = label
    helper.append_op(type='crf_decoding', inputs=inputs,
                     outputs={"ViterbiPath": [viterbi_path]})
    return viterbi_path


def roi_pool(input, rois, pooled_height=1, pooled_width=1,
             spatial_scale=1.0):
    helper = LayerHelper('roi_pool', **{})
    pool_out = helper.create_tmp_variable(
        input.dtype, shape=(-1, input.shape[1], pooled_height, pooled_width))
    argmaxes = helper.create_tmp_variable(dtype='int32', stop_gradient=True)
    helper.append_op(type="roi_pool",
                     inputs={"X": input, "ROIs": rois},
                     outputs={"Out": pool_out, "Argmax": argmaxes},
                     attrs={"pooled_height": pooled_height,
                            "pooled_width": pooled_width,
                            "spatial_scale": spatial_scale})
    return pool_out


def warpctc(input, label, blank=0, norm_by_times=False):
    """CTC loss [B, 1] of LoD logits (before the softmax) against LoD
    labels (ops/ctc_ops.py)."""
    helper = LayerHelper('warpctc', **{})
    loss_out = helper.create_tmp_variable(dtype=input.dtype, shape=(-1, 1))
    grad_out = helper.create_tmp_variable(dtype=input.dtype,
                                          stop_gradient=True)
    helper.append_op(type='warpctc',
                     inputs={'Logits': [input], 'Label': [label]},
                     outputs={'WarpCTCGrad': [grad_out], 'Loss': [loss_out]},
                     attrs={'blank': blank, 'norm_by_times': norm_by_times})
    return loss_out


def ctc_greedy_decoder(input, blank, name=None):
    helper = LayerHelper("ctc_greedy_decoder", name=name)
    ctc_out = helper.create_tmp_variable(dtype='int64', lod_level=1)
    helper.append_op(type="ctc_align", inputs={"Input": [input]},
                     outputs={"Output": [ctc_out]},
                     attrs={"merge_repeated": True, "blank": blank})
    return ctc_out


def edit_distance(input, label, normalized=True, ignored_tokens=None,
                  name=None):
    helper = LayerHelper("edit_distance", name=name)
    out = helper.create_tmp_variable(dtype='float32', shape=(-1, 1))
    sequence_num = helper.create_tmp_variable(dtype='int64', shape=(1,))
    helper.append_op(type="edit_distance",
                     inputs={"Hyps": [input], "Refs": [label]},
                     outputs={"Out": [out], "SequenceNum": [sequence_num]},
                     attrs={"normalized": normalized,
                            "tokens": ignored_tokens or []})
    return out, sequence_num


def chunk_eval(input, label, chunk_scheme, num_chunk_types,
               excluded_chunk_types=None):
    """Precision, recall, F1 and the three chunk counts of one batch."""
    helper = LayerHelper("chunk_eval", **{})
    precision = helper.create_tmp_variable(dtype="float32", shape=(1,))
    recall = helper.create_tmp_variable(dtype="float32", shape=(1,))
    f1_score = helper.create_tmp_variable(dtype="float32", shape=(1,))
    num_infer_chunks = helper.create_tmp_variable(dtype="int64", shape=(1,))
    num_label_chunks = helper.create_tmp_variable(dtype="int64", shape=(1,))
    num_correct_chunks = helper.create_tmp_variable(dtype="int64",
                                                    shape=(1,))
    helper.append_op(type="chunk_eval",
                     inputs={"Inference": [input], "Label": [label]},
                     outputs={"Precision": [precision], "Recall": [recall],
                              "F1-Score": [f1_score],
                              "NumInferChunks": [num_infer_chunks],
                              "NumLabelChunks": [num_label_chunks],
                              "NumCorrectChunks": [num_correct_chunks]},
                     attrs={"num_chunk_types": num_chunk_types,
                            "chunk_scheme": chunk_scheme,
                            "excluded_chunk_types":
                                excluded_chunk_types or []})
    return (precision, recall, f1_score, num_infer_chunks,
            num_label_chunks, num_correct_chunks)


# ---- the layers of the rest of the nn, tensor and misc kernels ----------------
def conv2d_transpose(input, num_filters, output_size=None, filter_size=None,
                     padding=0, stride=1, dilation=1, param_attr=None,
                     bias_attr=None, use_cudnn=True, act=None, name=None):
    """Transposed conv, Filter [in_c, num_filters, kh, kw]; without
    ``filter_size`` the filter is sized to give ``output_size``."""
    helper = LayerHelper("conv2d_transpose", param_attr=param_attr,
                         bias_attr=bias_attr, act=act, name=name)
    padding, stride, dilation = _pair(padding), _pair(stride), \
        _pair(dilation)
    if filter_size is None:
        if output_size is None:
            raise ValueError(
                "output_size must be set when filter_size is None")
        output_size = _pair(output_size)
        filter_size = [
            (output_size[i] - (input.shape[2 + i] - 1) * stride[i] +
             2 * padding[i] - 1) // dilation[i] + 1 for i in range(2)]
    else:
        filter_size = list(_pair(filter_size))
    img_filter = helper.create_parameter(
        dtype=input.dtype, shape=[int(input.shape[1]), num_filters] +
        filter_size, attr=helper.param_attr)

    def _out(size, k, p, s, d):
        return -1 if size < 0 else (size - 1) * s - 2 * p + d * (k - 1) + 1
    out_shape = (input.shape[0], num_filters) + tuple(
        _out(input.shape[2 + i], filter_size[i], padding[i], stride[i],
             dilation[i]) for i in range(2))
    pre_bias = helper.create_tmp_variable(dtype=input.dtype,
                                          shape=out_shape)
    helper.append_op(type='conv2d_transpose',
                     inputs={'Input': [input], 'Filter': [img_filter]},
                     outputs={'Output': pre_bias},
                     attrs={'strides': stride, 'paddings': padding,
                            'dilations': dilation})
    pre_act = helper.append_bias_op(pre_bias, dim_start=1, dim_end=2)
    return helper.append_activation(pre_act)


def l2_normalize(x, axis, epsilon=1e-12, name=None):
    """``x`` over its L2 norm along ``axis`` (a ``norm`` op)."""
    if len(x.shape) == 1:
        axis = 0
    helper = LayerHelper("l2_normalize", name=name)
    out = helper.create_tmp_variable(dtype=x.dtype, shape=x.shape)
    norm = helper.create_tmp_variable(dtype=x.dtype)
    helper.append_op(type="norm", inputs={"X": x},
                     outputs={"Out": out, "Norm": norm},
                     attrs={"axis": 1 if axis is None else axis,
                            "epsilon": epsilon})
    return out


def multiplex(inputs, index):
    """Row i from ``inputs[index[i]]``."""
    helper = LayerHelper('multiplex', **{})
    if not isinstance(inputs, list) and len(inputs) < 2:
        raise ValueError("inputs should be a list object and contains at "
                         "least 2 elements.")
    out = helper.create_tmp_variable(dtype=inputs[0].dtype,
                                     shape=inputs[0].shape)
    helper.append_op(type='multiplex', inputs={'X': inputs, 'Ids': index},
                     outputs={'Out': [out]})
    return out


def lrn(input, n=5, k=1.0, alpha=1e-4, beta=0.75, name=None):
    """Fluid's local response norm across channels of an NCHW input."""
    helper = LayerHelper('lrn', name=name)
    if len(input.shape) != 4:
        raise ValueError("Input's dimension size of Op(lrn) must be 4, but "
                         "received %d." % (len(input.shape)))
    mid_out = helper.create_tmp_variable(dtype=input.dtype,
                                         stop_gradient=True)
    lrn_out = helper.create_tmp_variable(input.dtype, shape=input.shape)
    helper.append_op(type="lrn", inputs={"X": input},
                     outputs={"Out": lrn_out, "MidOut": mid_out},
                     attrs={"n": n, "k": k, "alpha": alpha, "beta": beta})
    return lrn_out


def pad(x, paddings, pad_value=0., name=None):
    """``x`` with (before, after) ``paddings`` on each dim."""
    helper = LayerHelper('pad', name=name)
    shape = tuple((d + paddings[2 * i] + paddings[2 * i + 1]) if d >= 0
                  else -1 for i, d in enumerate(x.shape))
    out = helper.create_tmp_variable(x.dtype, shape=shape)
    helper.append_op(type='pad', inputs={'X': x}, outputs={'Out': out},
                     attrs={'paddings': list(paddings),
                            'pad_value': float(pad_value)})
    return out


def label_smooth(label, prior_dist=None, epsilon=0.1, dtype="float32",
                 name=None):
    """(1 - epsilon) label + epsilon prior (uniform without one)."""
    if epsilon > 1. or epsilon < 0.:
        raise ValueError("The value of epsilon must be between 0 and 1.")
    helper = LayerHelper("label_smooth", name=name)
    label.stop_gradient = True
    smooth_label = helper.create_tmp_variable(dtype, shape=label.shape)
    helper.append_op(type="label_smooth",
                     inputs={"X": label, "PriorDist": prior_dist}
                     if prior_dist else {"X": label},
                     outputs={"Out": smooth_label},
                     attrs={"epsilon": float(epsilon)})
    return smooth_label


def dice_loss(input, label, epsilon=0.00001):
    helper = LayerHelper('dice_loss', **{})
    out = helper.create_tmp_variable(dtype=input.dtype, shape=(1,))
    helper.append_op(type="dice_loss", inputs={"X": input, "Label": label},
                     outputs={"Out": out}, attrs={"epsilon": epsilon})
    return out


def bilinear_interp(input, out_h, out_w, name=None):
    """Corner-aligned bilinear resize of an NCHW input."""
    helper = LayerHelper('bilinear_interp', name=name)
    out = helper.create_tmp_variable(
        input.dtype, shape=(input.shape[0], input.shape[1], out_h, out_w))
    helper.append_op(type="bilinear_interp", inputs={"X": input},
                     outputs={"Out": out},
                     attrs={"out_h": out_h, "out_w": out_w})
    return out


def nce(input, label, num_total_classes, sample_weight=None,
        param_attr=None, bias_attr=None, num_neg_samples=None):
    """Fluid's NCE cost [B, 1], with a weight [num_total_classes, D] and
    a bias; ``num_neg_samples`` (10) shared negatives a batch."""
    helper = LayerHelper('nce', param_attr=param_attr, bias_attr=bias_attr)
    dim = input.shape[1]
    w = helper.create_parameter(attr=helper.param_attr,
                                shape=[num_total_classes, dim],
                                dtype=input.dtype, is_bias=False)
    b = helper.create_parameter(attr=helper.bias_attr,
                                shape=[num_total_classes],
                                dtype=input.dtype, is_bias=True)
    cost = helper.create_tmp_variable(dtype=input.dtype,
                                      shape=(input.shape[0], 1))
    sample_logits = helper.create_tmp_variable(dtype=input.dtype)
    sample_labels = helper.create_tmp_variable(dtype='int64',
                                               stop_gradient=True)
    num_neg_samples = 10 if num_neg_samples is None else int(num_neg_samples)
    inputs = {'Input': input, 'Label': label, 'Weight': w, 'Bias': b}
    if sample_weight is not None:
        inputs['SampleWeight'] = sample_weight
    helper.append_op(type='nce', inputs=inputs,
                     outputs={'Cost': cost, 'SampleLogits': sample_logits,
                              'SampleLabels': sample_labels},
                     attrs={'num_total_classes': int(num_total_classes),
                            'num_neg_samples': num_neg_samples})
    return cost


def _ints2(v):
    return [v, v] if isinstance(v, int) else list(v)


def max_pool2d_with_index(x, pool_size, pool_stride=1, pool_padding=0,
                          global_pooling=False, name=None):
    """(out, mask): the max pool and the int32 index h * W + w of each
    window's first maximum."""
    helper = LayerHelper('max_pool2d_with_index', name=name)
    ksize, strides = _ints2(pool_size), _ints2(pool_stride)
    paddings = _ints2(pool_padding)
    n, c, h, w = x.shape
    if global_pooling:
        ho = wo = 1
    else:
        ho = _conv_out(h, ksize[0], paddings[0], strides[0])
        wo = _conv_out(w, ksize[1], paddings[1], strides[1])
    out = helper.create_tmp_variable(dtype=x.dtype, shape=(n, c, ho, wo))
    mask = helper.create_tmp_variable(dtype='int32', shape=(n, c, ho, wo),
                                      stop_gradient=True)
    helper.append_op(type='max_pool2d_with_index', inputs={'X': [x]},
                     outputs={'Out': [out], 'Mask': [mask]},
                     attrs={'ksize': ksize, 'strides': strides,
                            'paddings': paddings,
                            'global_pooling': global_pooling})
    return out, mask


def unpool(x, indices, pool_size, pool_stride=1, pool_padding=0, name=None):
    """Max-unpooling by the indices ``max_pool2d_with_index`` gave."""
    helper = LayerHelper('unpool', name=name)
    ksize, strides = _ints2(pool_size), _ints2(pool_stride)
    paddings = _ints2(pool_padding)
    n, c, ho, wo = x.shape
    out_h = (ho - 1) * strides[0] - 2 * paddings[0] + ksize[0]
    out_w = (wo - 1) * strides[1] - 2 * paddings[1] + ksize[1]
    out = helper.create_tmp_variable(dtype=x.dtype,
                                     shape=(n, c, out_h, out_w))
    helper.append_op(type='unpool', inputs={'X': [x], 'Indices': [indices]},
                     outputs={'Out': [out]},
                     attrs={'ksize': ksize, 'strides': strides,
                            'paddings': paddings, 'unpooling_type': 'max'})
    return out


def spp(x, pyramid_height, pool_type='max', name=None):
    """Spatial pyramid pooling to [N, C * sum(4^level)]."""
    helper = LayerHelper('spp', name=name)
    width = x.shape[1] * sum(4 ** lv for lv in range(pyramid_height))
    out = helper.create_tmp_variable(dtype=x.dtype, shape=(x.shape[0], width))
    helper.append_op(type='spp', inputs={'X': [x]}, outputs={'Out': [out]},
                     attrs={'pyramid_height': pyramid_height,
                            'pooling_type': pool_type})
    return out
