"""Composite networks. Counterpart of paddle_tpu/nets.py (parity:
python/paddle/fluid/nets.py): the image blocks (``simple_img_conv_pool``,
``img_conv_group``), ``sequence_conv_pool``, ``glu``,
``scaled_dot_product_attention`` and the JAX package's
``static_beam_decoder``."""
from . import layers

__all__ = ['simple_img_conv_pool', 'img_conv_group', 'sequence_conv_pool',
           'glu', 'scaled_dot_product_attention', 'static_beam_decoder']


def simple_img_conv_pool(input, num_filters, filter_size, pool_size,
                         pool_stride, act, param_attr=None,
                         pool_type='max', use_cudnn=True, use_mkldnn=False):
    conv_out = layers.conv2d(input=input, num_filters=num_filters,
                             filter_size=filter_size, param_attr=param_attr,
                             act=act, use_cudnn=use_cudnn)
    pool_out = layers.pool2d(input=conv_out, pool_size=pool_size,
                             pool_type=pool_type, pool_stride=pool_stride,
                             use_cudnn=use_cudnn)
    return pool_out


def img_conv_group(input, conv_num_filter, pool_size, conv_padding=1,
                   conv_filter_size=3, conv_act=None, param_attr=None,
                   conv_with_batchnorm=False, conv_batchnorm_drop_rate=0.0,
                   pool_stride=1, pool_type='max', use_cudnn=True,
                   use_mkldnn=False, is_test=False):
    tmp = input
    assert isinstance(conv_num_filter, (list, tuple))

    def __extend_list__(obj):
        if not hasattr(obj, '__len__'):
            return [obj] * len(conv_num_filter)
        else:
            return list(obj)

    conv_padding = __extend_list__(conv_padding)
    conv_filter_size = __extend_list__(conv_filter_size)
    param_attr = __extend_list__(param_attr)
    conv_with_batchnorm = __extend_list__(conv_with_batchnorm)
    conv_batchnorm_drop_rate = __extend_list__(conv_batchnorm_drop_rate)

    for i in range(len(conv_num_filter)):
        local_conv_act = conv_act
        if conv_with_batchnorm[i]:
            local_conv_act = None
        tmp = layers.conv2d(input=tmp, num_filters=conv_num_filter[i],
                            filter_size=conv_filter_size[i],
                            padding=conv_padding[i],
                            param_attr=param_attr[i], act=local_conv_act,
                            use_cudnn=use_cudnn)
        if conv_with_batchnorm[i]:
            tmp = layers.batch_norm(input=tmp, act=conv_act, is_test=is_test)
            drop_rate = conv_batchnorm_drop_rate[i]
            if abs(drop_rate) > 1e-5:
                tmp = layers.dropout(x=tmp, dropout_prob=drop_rate,
                                     is_test=is_test)
    pool_out = layers.pool2d(input=tmp, pool_size=pool_size,
                             pool_type=pool_type, pool_stride=pool_stride,
                             use_cudnn=use_cudnn)
    return pool_out


def sequence_conv_pool(input, num_filters, filter_size, param_attr=None,
                       act="sigmoid", pool_type="max"):
    conv_out = layers.sequence_conv(input=input, num_filters=num_filters,
                                    filter_size=filter_size,
                                    param_attr=param_attr, act=act)
    pool_out = layers.sequence_pool(input=conv_out, pool_type=pool_type)
    return pool_out


def glu(input, dim=-1):
    a, b = layers.split(input, num_or_sections=2, dim=dim)
    act_b = layers.sigmoid(x=b)
    out = layers.elementwise_mul(x=a, y=act_b)
    return out


def scaled_dot_product_attention(queries, keys, values, num_heads=1,
                                 dropout_rate=0.):
    """Multi-head attention (parity: nets.py), built from plain ops: the
    flash-attention kernel is the ``flash_attention`` layer's."""
    if not (len(queries.shape) == len(keys.shape) == len(values.shape) == 3):
        raise ValueError("Inputs quries, keys and values should all be "
                         "3-D tensors.")

    def __compute_qkv(queries, keys, values, num_heads):
        if num_heads == 1:
            return queries, keys, values
        q = layers.fc(input=queries, size=queries.shape[-1],
                      num_flatten_dims=2)
        k = layers.fc(input=keys, size=keys.shape[-1], num_flatten_dims=2)
        v = layers.fc(input=values, size=values.shape[-1],
                      num_flatten_dims=2)
        return q, k, v

    def __split_heads(x, num_heads):
        if num_heads == 1:
            return x
        hidden_size = x.shape[-1]
        reshaped = layers.reshape(
            x=x, shape=[x.shape[0], x.shape[1], num_heads,
                        hidden_size // num_heads])
        return layers.transpose(x=reshaped, perm=[0, 2, 1, 3])

    def __combine_heads(x):
        if len(x.shape) == 3:
            return x
        trans_x = layers.transpose(x, perm=[0, 2, 1, 3])
        return layers.reshape(
            x=trans_x,
            shape=[trans_x.shape[0], trans_x.shape[1],
                   trans_x.shape[2] * trans_x.shape[3]])

    q, k, v = __compute_qkv(queries, keys, values, num_heads)
    q = __split_heads(q, num_heads)
    k = __split_heads(k, num_heads)
    v = __split_heads(v, num_heads)

    key_dim_per_head = keys.shape[-1] // num_heads
    scaled_q = layers.scale(x=q, scale=key_dim_per_head ** -0.5)
    product = layers.matmul(x=scaled_q, y=k, transpose_y=True)
    weights = layers.reshape(
        x=layers.reshape(x=product, shape=[-1, product.shape[-1]],
                         act="softmax"),
        shape=product.shape)
    if dropout_rate:
        weights = layers.dropout(weights, dropout_prob=dropout_rate,
                                 is_test=False)
    ctx_multiheads = layers.matmul(weights, v)
    return __combine_heads(ctx_multiheads)


def static_beam_decoder(step_fn, init_state, beam_size, max_len, end_id,
                        init_id=1, topk_size=None, early_finish=True):
    """A static-width beam-search decode.

    Builds a While whose body runs ``step_fn`` and a static [B*K]
    beam_search, then backtracks with beam_search_decode. Every shape is
    fixed (a finished beam stays a frozen row re-emitting ``end_id``
    with its score, ops/search_ops.py), so no step changes the row
    count: the reference's beam semantics without its shrinking LoD.

    Args:
        step_fn: ``step_fn(pre_ids, pre_state) -> (probs, new_state)``;
            builds fluid ops for one step. ``pre_ids``: [B*K, 1] int64;
            ``probs``: [B*K, V] next-token probabilities;
            ``new_state``: same shape as ``init_state``.
        init_state: [B*K, H] Variable — each sentence's initial decoder
            state tiled ``beam_size`` times.
        beam_size, max_len, end_id: the reference beam_search params.
        init_id: start-token id seeded into every beam.
        topk_size: candidates per beam before beam pruning (the book
            script uses 50); defaults to max(2*beam_size, 10).
        early_finish: stop as soon as every beam has emitted ``end_id``
            (the reference's is_empty termination).

    Returns:
        (translation_ids, translation_scores): SequenceTensor outputs of
        beam_search_decode — row b*K+k is the k-th beam of sentence b;
        sequences start with the seed ``init_id`` followed by the
        selected tokens (the reference decode arrays carry the seed
        too).
    """
    topk_size = topk_size or max(2 * beam_size, 10)
    i = layers.fill_constant(shape=[1], dtype='int32', value=0)
    limit = layers.fill_constant(shape=[1], dtype='int32', value=max_len)
    ids0 = layers.fill_constant_batch_size_like(
        init_state, shape=[-1, 1], dtype='int64', value=init_id)
    sc0 = layers.fill_constant_batch_size_like(
        init_state, shape=[-1, 1], dtype='float32', value=0.0)
    # carry arrays double as the decode record (slot 0 = seed, slot
    # t+1 = step-t selection — the reference's decode arrays include
    # the seed token too). Slot-0 parents are never followed by the
    # backtrack (it stops at t=0), so zeros suffice.
    par0 = layers.fill_constant_batch_size_like(
        init_state, shape=[-1, 1], dtype='int32', value=0)
    ids_arr = layers.array_write(ids0, i)
    sc_arr = layers.array_write(sc0, i)
    st_arr = layers.array_write(init_state, i)
    par_arr = layers.array_write(par0, i)

    cond = layers.less_than(x=i, y=limit)
    w = layers.While(cond=cond)
    with w.block():
        pre_ids = layers.array_read(ids_arr, i)
        pre_sc = layers.array_read(sc_arr, i)
        pre_st = layers.array_read(st_arr, i)
        probs, new_state = step_fn(pre_ids, pre_st)
        topk_sc, topk_idx = layers.topk(probs, k=topk_size)
        accu = layers.elementwise_add(layers.log(topk_sc), pre_sc)
        sel_ids, sel_sc = layers.beam_search(
            pre_ids, topk_idx, accu, beam_size=beam_size, end_id=end_id)
        # beam state follows the selected parent rows
        nxt = layers.gather(new_state, layers.reshape(
            sel_ids.parent_idx, shape=[-1]))
        layers.increment(x=i, value=1, in_place=True)
        layers.array_write(sel_ids, i, array=ids_arr)
        layers.array_write(sel_sc, i, array=sc_arr)
        layers.array_write(nxt, i, array=st_arr)
        layers.array_write(sel_ids.parent_idx, i, array=par_arr)
        lt = layers.less_than(x=i, y=limit)
        if early_finish:
            end_const = layers.fill_constant_batch_size_like(
                sel_ids, shape=[-1, 1], dtype='int64', value=end_id)
            fin = layers.reduce_min(layers.cast(
                layers.equal(sel_ids, end_const), 'int32'))
            alive = layers.logical_not(layers.cast(
                layers.reshape(fin, shape=[1]), 'bool'))
            layers.assign(layers.logical_and(lt, alive), output=cond)
        else:
            layers.assign(lt, output=cond)
    return layers.beam_search_decode(ids_arr, sc_arr, parents=par_arr)
