"""The port's last 38 tensor, math, nn and misc op kernels against
paddle_tpu's.

Each case builds one small Program with both packages' layers (or, for
an op no layer appends, one raw op through the package's LayerHelper)
and runs both Executors on the CPU in f32, compiler off, on the same
numpy feeds and parameters (``run_both`` of
``test_torch_tensor_math_ops``): float fetches to atol = rtol = 1e-5,
integer fetches equal in value (paddle_tpu runs int64 as int32). The
backward cases take the mean of the op's first output as the loss and
compare it and every parameter's ``@GRAD``.

The edges: ties for arg_max / arg_min and in max_pool2d_with_index's
windows (the first index; a tie's cotangent split), a repeated scatter
id (the last row wins), conv2d_transpose with stride, dilation and
padding, the avg window that spp clips to the image, nce with its
negatives pinned by ``custom_neg_classes`` (the two packages' random
draws never agree), lrn's ``MidOut``, and cumsum's ``exclusive`` and
``reverse``. spp's max form has no backward case: paddle_tpu's
``reduce_window`` from ``finfo.min`` does not differentiate.
"""
import numpy as np
import pytest

import paddle_tpu.fluid as fluid
import paddle_tpu.compiler as jax_compiler
import paddle_tpu_torch as pt

from test_torch_tensor_math_ops import (TOL, _data, _param, _randn,
                                        assert_same, run_both)


def _raw(L, op_type, inputs, outs, attrs=None):
    """One ``op_type`` op appended through the package's LayerHelper;
    ``outs``: slot -> dtype. Returns the output Variables in order."""
    helper = L.nn.LayerHelper(op_type)
    made = [(slot, helper.create_tmp_variable(dtype=dt))
            for slot, dt in outs.items()]
    helper.append_op(type=op_type, inputs=inputs,
                     outputs={s: [v] for s, v in made}, attrs=attrs or {})
    return [v for _, v in made]


def _out(var, slot):
    """The output ``slot`` of the op that wrote ``var``."""
    op = var.block.ops[-1]
    return var.block.var(op.output(slot)[0])


# ---- forward cases ----------------------------------------------------------------
_TIES = np.array([[1.0, 3.0, 3.0, -2.0], [2.0, 2.0, 0.5, 0.0],
                  [0.0, -1.0, 4.0, 4.0]], 'float32')


def _argminmax(L):
    x = _data(L, 'x', [3, 4])
    return [L.argmax(x, axis=2), L.argmin(x, axis=2), L.argmax(x, axis=1),
            L.argmin(x, axis=0)]


def _tensor_ops(L):
    x = _data(L, 'x', [3, 4])
    return [L.pad(x, paddings=[0, 1, 2, 0, 1, 3], pad_value=-1.5),
            L.reverse(x, axis=1), L.reverse(x, axis=[0, 2]),
            _raw(L, 'fill_zeros_like', {'X': x}, {'Out': 'float32'})[0],
            _raw(L, 'crop', {'X': x}, {'Out': 'float32'},
                 {'offsets': [1, 0, 1], 'shape': [1, 2, 3]})[0],
            _raw(L, 'shape', {'Input': x}, {'Out': 'int32'})[0],
            _raw(L, 'feed', {'X': x}, {'Out': 'float32'})[0],
            _raw(L, 'fetch', {'X': x}, {'Out': 'float32'})[0]]


def _multiplex(L):
    xs = [_data(L, 'x%d' % i, [3]) for i in range(3)]
    return L.multiplex(inputs=xs, index=_data(L, 'ids', [1], 'int32'))


def _scatter(L):
    x = _data(L, 'x', [5, 3], append_batch_size=False)
    ids = _data(L, 'ids', [3], 'int32', append_batch_size=False)
    upd = _data(L, 'upd', [3, 3], append_batch_size=False)
    return L.scatter(x, ids, upd)


def _cumsum(L):
    x = _data(L, 'x', [3, 5])
    return [L.cumsum(x, axis=2), L.cumsum(x, axis=-1, reverse=True),
            L.cumsum(x, axis=1, exclusive=True),
            L.cumsum(x, axis=2, exclusive=True, reverse=True)]


def _norms(L):
    x = _data(L, 'x', [3, 4])
    out = L.l2_normalize(x, axis=1)
    scale = _data(L, 'scale', [3], append_batch_size=False)
    return [out, _out(out, 'Norm'), L.l2_normalize(x, axis=-1,
                                                   epsilon=1e-4),
            _raw(L, 'norm', {'X': _data(L, 'x4', [3, 2, 2]), 'Scale': scale},
                 {'Out': 'float32'}, {'epsilon': 1e-10})[0]]


def _products(L):
    x = _data(L, 'x', [4])
    y = _data(L, 'y', [3])
    w = _data(L, 'wt', [2, 4, 3], append_batch_size=False)
    b = _data(L, 'b', [1, 2], append_batch_size=False)
    cx = _data(L, 'cx', [7])
    cy = _data(L, 'cy', [3])
    return [_raw(L, 'bilinear_tensor_product',
                 {'X': x, 'Y': y, 'Weight': w, 'Bias': b},
                 {'Out': 'float32'})[0],
            _raw(L, 'bilinear_tensor_product', {'X': x, 'Y': y, 'Weight': w},
                 {'Out': 'float32'})[0],
            _raw(L, 'conv_shift', {'X': cx, 'Y': cy}, {'Out': 'float32'})[0],
            _raw(L, 'smooth_l1_loss', {'X': x, 'Y': x * 0.5},
                 {'Out': 'float32', 'Diff': 'float32'}, {'sigma': 2.0})[0]]


def _conv_t(L):
    x = _data(L, 'x', [3, 5, 4])
    return [L.conv2d_transpose(x, num_filters=2, filter_size=3, stride=2,
                               padding=1, dilation=2, bias_attr=False),
            L.conv2d_transpose(x, num_filters=4, output_size=[9, 7],
                               stride=2, bias_attr=False),
            L.conv2d_transpose(x, num_filters=2, filter_size=[2, 3],
                               padding=[1, 0], stride=[1, 2])]


def _conv3d(L):
    x = _data(L, 'x', [4, 5, 6, 5])
    w = _data(L, 'f', [6, 2, 3, 3, 3], append_batch_size=False)
    wt = _data(L, 'ft', [4, 3, 2, 3, 2], append_batch_size=False)
    o = {'Output': 'float32'}
    return [_raw(L, 'conv3d', {'Input': x, 'Filter': w}, o,
                 {'strides': [1, 2, 1], 'paddings': [1, 0, 1],
                  'dilations': [1, 1, 2], 'groups': 2})[0],
            _raw(L, 'conv3d_transpose', {'Input': x, 'Filter': wt}, o,
                 {'strides': [2, 1, 2], 'paddings': [1, 0, 0],
                  'dilations': [1, 2, 1], 'groups': 2})[0],
            _raw(L, 'conv3d_transpose', {'Input': x, 'Filter': wt}, o,
                 {'strides': [1, 1, 1], 'paddings': [0, 0, 0],
                  'groups': 1})[0]]


def _pool3d(L):
    x = _data(L, 'x', [2, 5, 6, 7])
    o = {'Out': 'float32'}
    attrs = [dict(pooling_type='max', ksize=[2, 3, 2], strides=[2, 2, 1],
                  paddings=[1, 0, 1]),
             dict(pooling_type='avg', ksize=[3, 3, 3], strides=[2, 2, 2],
                  paddings=[1, 1, 1]),
             dict(pooling_type='avg', ksize=[2, 2, 2], strides=[2, 2, 2],
                  paddings=[1, 1, 1], exclusive=False),
             dict(pooling_type='max', ksize=[2, 2, 2], strides=[2, 2, 2],
                  paddings=[0, 0, 0], ceil_mode=True),
             dict(pooling_type='avg', ksize=[1, 1, 1], global_pooling=True)]
    return [_raw(L, 'pool3d', {'X': x}, o, a)[0] for a in attrs]


def _lrn(L):
    x = _data(L, 'x', [6, 3, 3])
    out = L.lrn(x, n=3, k=2.0, alpha=1e-2, beta=0.75)
    return [out, _out(out, 'MidOut'), L.lrn(x)]


def _auc(L):
    return L.auc(_data(L, 'p', [2]), _data(L, 'lab', [1], 'int64'),
                 num_thresholds=200)


def _resize_smooth_dice(L):
    x = _data(L, 'x', [2, 3, 4])
    lab = _data(L, 'lab', [5])
    prior = _data(L, 'prior', [5], append_batch_size=False)
    return [L.bilinear_interp(x, out_h=5, out_w=7),
            L.bilinear_interp(x, out_h=1, out_w=3),
            L.label_smooth(lab, epsilon=0.2),
            L.label_smooth(lab, prior_dist=prior, epsilon=0.1),
            L.dice_loss(L.sigmoid(x), _data(L, 'm', [2, 3, 4]))]


def _pinned_nce(L, neg=(3, 0, 7, 7, 11), weight=False):
    x = _data(L, 'x', [6])
    lab = _data(L, 'lab', [2], 'int64')
    sw = _data(L, 'sw', [1]) if weight else None
    cost = L.nce(x, lab, num_total_classes=13, sample_weight=sw,
                 num_neg_samples=len(neg))
    cost.block.ops[-1].attrs['custom_neg_classes'] = list(neg)
    return [cost, _out(cost, 'SampleLogits'), _out(cost, 'SampleLabels')]


def _misc(L):
    x = _data(L, 'x', [3])
    y = _data(L, 'y', [3])
    return [_raw(L, 'minus', {'X': x, 'Y': y}, {'Out': 'float32'})[0],
            _raw(L, 'fill', {}, {'Out': 'float32'},
                 {'shape': [2, 3], 'dtype': 'float32',
                  'value': [0.5, 1.0, -2.0, 3.0, 4.0, 5.5]})[0],
            _raw(L, 'fill', {}, {'Out': 'int64'},
                 {'shape': [3], 'dtype': 'int64', 'value': [4, -1, 2]})[0]]


_POOL_X = np.round(_randn(2, 3, 5, 6) * 2).astype('float32')   # ties


def _pool_index(L):
    x = _data(L, 'x', [3, 5, 6])
    out, mask = L.max_pool2d_with_index(x, pool_size=2, pool_stride=2)
    out2, mask2 = L.max_pool2d_with_index(x, pool_size=3, pool_stride=2,
                                          pool_padding=1)
    out3, mask3 = L.max_pool2d_with_index(x, pool_size=2,
                                          global_pooling=True)
    return [out, mask, out2, mask2, out3, mask3,
            L.unpool(out, mask, pool_size=2, pool_stride=2)]


def _spp(L):
    x = _data(L, 'x', [3, 5, 7])
    return [L.spp(x, pyramid_height=3, pool_type='max'),
            L.spp(x, pyramid_height=3, pool_type='avg')]


def _metrics(L):
    idx = _data(L, 'idx', [1], 'int64')
    lab = _data(L, 'lab', [1], 'int64')
    w = _data(L, 'w8', [1])
    st = _data(L, 'st', [4, 4], append_batch_size=False)
    pr = {'BatchMetrics': 'float32', 'AccumMetrics': 'float32',
          'AccumStatesInfo': 'float32'}
    score = _data(L, 'score', [2])
    qid = _data(L, 'qid', [1], 'int64')
    acc = _data(L, 'acc', [1], append_batch_size=False)
    pn = {'PositivePair': 'float32', 'NegativePair': 'float32',
          'NeutralPair': 'float32'}
    return (_raw(L, 'precision_recall',
                 {'Indices': idx, 'Labels': lab, 'Weights': w,
                  'StatesInfo': st}, pr, {'class_number': 4}) +
            _raw(L, 'precision_recall', {'Indices': idx, 'Labels': lab}, pr,
                 {'class_number': 4}) +
            _raw(L, 'positive_negative_pair',
                 {'Score': score, 'Label': lab, 'QueryID': qid, 'Weight': w,
                  'AccumulatePositivePair': acc,
                  'AccumulateNegativePair': acc,
                  'AccumulateNeutralPair': acc}, pn, {'column': 1}) +
            _raw(L, 'positive_negative_pair',
                 {'Score': score, 'Label': lab, 'QueryID': qid}, pn,
                 {'column': -1}))


def _aliased(op_type):
    """The recurrent layer, its op renamed to the reference's type."""
    def build(L):
        x = _data(L, 'seq', [6 if op_type == 'gru' else 8], lod_level=1)
        if op_type == 'gru':
            out = L.dynamic_gru(x, size=2)
        elif op_type == 'lstm':
            out, _ = L.dynamic_lstm(x, size=8)
        else:
            out, _ = L.dynamic_lstmp(x, size=8, proj_size=3)
        out.block.ops[-1].type = op_type
        return out
    return build


def _seq(width):
    def feeds(pkg):
        rows = _randn(9, width, seed=3) * 0.5
        return {'seq': pkg.create_lod_tensor(rows, [[2, 4, 3]],
                                             pkg.CPUPlace())}
    return feeds


CASES = {
    'arg_max_arg_min_ties': (_argminmax, {'x': np.stack([_TIES, -_TIES])}),
    'tensor_ops': (_tensor_ops, {'x': _randn(2, 3, 4)}),
    'multiplex': (_multiplex, dict(
        [('x%d' % i, _randn(4, 3, seed=i)) for i in range(3)] +
        [('ids', np.array([[2], [0], [2], [1]], 'int32'))])),
    # id 1 repeats: its last row wins
    'scatter_repeated_id': (_scatter, {
        'x': _randn(5, 3), 'ids': np.array([1, 3, 1], 'int32'),
        'upd': _randn(3, 3, seed=1)}),
    'cumsum': (_cumsum, {'x': _randn(2, 3, 5)}),
    'norms': (_norms, {'x': _randn(2, 3, 4), 'scale': _randn(3, seed=1),
                       'x4': _randn(2, 3, 2, 2, seed=2)}),
    'products': (_products, {
        'x': _randn(3, 4), 'y': _randn(3, 3, seed=1),
        'wt': _randn(2, 4, 3, seed=2), 'b': _randn(1, 2, seed=3),
        'cx': _randn(3, 7, seed=4), 'cy': _randn(3, 3, seed=5)}),
    'conv2d_transpose': (_conv_t, {'x': _randn(2, 3, 5, 4)}),
    'conv3d': (_conv3d, {'x': _randn(2, 4, 5, 6, 5),
                         'f': _randn(6, 2, 3, 3, 3, seed=1),
                         'ft': _randn(4, 3, 2, 3, 2, seed=2)}),
    'pool3d': (_pool3d, {'x': _randn(2, 2, 5, 6, 7)}),
    'lrn_mid_out': (_lrn, {'x': _randn(2, 6, 3, 3)}),
    'auc': (_auc, {'p': np.stack([1 - np.linspace(0.01, 0.99, 12),
                                  np.linspace(0.01, 0.99, 12)], 1)
                   .astype('float32'),
                   'lab': np.array([[0], [1], [0], [0], [1], [0], [1], [1],
                                    [0], [1], [1], [1]], 'int64')}),
    'resize_smooth_dice': (_resize_smooth_dice, {
        'x': _randn(2, 2, 3, 4), 'lab': np.eye(5, dtype='float32')[[1, 3]],
        'prior': np.full((5,), 0.2, 'float32'),
        'm': (_randn(2, 2, 3, 4, seed=1) > 0).astype('float32')}),
    'nce_pinned': (_pinned_nce, {'x': _randn(4, 6),
                                 'lab': np.array([[1, 5], [0, 12], [7, 7],
                                                  [3, 2]], 'int64')}),
    'misc': (_misc, {'x': _randn(2, 3), 'y': _randn(2, 3, seed=1)}),
    'max_pool2d_with_index_unpool': (_pool_index, {'x': _POOL_X}),
    'spp_clipped_avg': (_spp, {'x': _randn(2, 3, 5, 7)}),
    'metrics': (_metrics, {
        'idx': np.array([[0], [1], [2], [1], [3], [3]], 'int64'),
        'lab': np.array([[0], [1], [1], [0], [3], [2]], 'int64'),
        'w8': np.array([[1.0], [0.5], [2.0], [1.0], [1.5], [1.0]],
                       'float32'),
        'st': np.arange(16, dtype='float32').reshape(4, 4),
        'score': np.array([[0.1, 3.0], [0.2, 2.0], [0.3, 2.0], [0.4, 1.0],
                           [0.5, 2.0], [0.6, 0.5]], 'float32'),
        'qid': np.array([[0], [0], [0], [1], [1], [1]], 'int64'),
        'acc': np.array([1.5], 'float32')}),
    'lstm': (_aliased('lstm'), _seq(8)),
    'lstmp': (_aliased('lstmp'), _seq(8)),
    'gru': (_aliased('gru'), _seq(6)),
}


@pytest.mark.parametrize('case', sorted(CASES))
def test_op_matches_jax(case):
    build, feeds = CASES[case]
    j_res, t_res = run_both(build, feeds)
    for i, (j, t) in enumerate(zip(j_res, t_res)):
        assert_same(j, t, '%s output %d' % (case, i))


def test_edges_read_as_documented():
    """What the cases above hold both packages to."""
    _, t = run_both(*CASES['arg_max_arg_min_ties'])
    assert t[0][0].tolist() == [1, 0, 2] and t[1][0].tolist() == [3, 3, 1]
    _, t = run_both(*CASES['scatter_repeated_id'])
    np.testing.assert_array_equal(t[0][1], _randn(3, 3, seed=1)[2])
    _, t = run_both(*CASES['max_pool2d_with_index_unpool'])
    x = _POOL_X
    for n, c, i, j in np.ndindex(2, 3, 2, 3):
        win = x[n, c, 2 * i:2 * i + 2, 2 * j:2 * j + 2].reshape(-1)
        first = int(np.argmax(win))
        assert t[1][n, c, i, j] == (2 * i + first // 2) * 6 + 2 * j + \
            first % 2
    # lrn's MidOut is k + alpha * the window's sum of squares
    _, t = run_both(*CASES['lrn_mid_out'])
    xs = _randn(2, 6, 3, 3)
    sq = np.pad(xs * xs, [(0, 0), (1, 1), (0, 0), (0, 0)])
    mid = 2.0 + 1e-2 * (sq[:, :-2] + sq[:, 1:-1] + sq[:, 2:])
    np.testing.assert_allclose(t[1], mid, **TOL)
    np.testing.assert_allclose(t[0], xs / mid ** 0.75, **TOL)


def test_compare_names_its_comparison():
    """``compare`` takes its comparison from the attr ``type``; the
    values equal those of paddle_tpu's op of that type."""
    x, y = _randn(3, 4), _randn(3, 4, seed=1)
    y[0, :2] = x[0, :2]
    for kind in ('less_than', 'less_equal', 'greater_than',
                 'greater_equal', 'equal', 'not_equal'):
        def build(L, t=kind):
            a, b = _data(L, 'a', [4]), _data(L, 'b', [4])
            if L is pt.layers:
                return _raw(L, 'compare', {'X': a, 'Y': b}, {'Out': 'bool'},
                            {'type': t})
            return _raw(L, t, {'X': a, 'Y': b}, {'Out': 'bool'})
        res = []
        for pkg in (fluid, pt):
            main, startup = pkg.Program(), pkg.Program()
            with pkg.unique_name.guard(), pkg.program_guard(main, startup):
                out, = build(pkg.layers)
            comp = jax_compiler if pkg is fluid else pt.compiler
            with comp.disabled():
                res.append(np.asarray(pkg.Executor(pkg.CPUPlace()).run(
                    main, feed={'a': x, 'b': y}, fetch_list=[out],
                    scope=pkg.Scope())[0]))
        np.testing.assert_array_equal(res[1], res[0], err_msg=kind)
    with pytest.raises(ValueError, match="attr 'type'"):
        main = pt.Program()
        with pt.program_guard(main, pt.Program()):
            a = _data(pt.layers, 'a', [4])
            out, = _raw(pt.layers, 'compare', {'X': a, 'Y': a},
                        {'Out': 'bool'})
        pt.Executor(pt.CPUPlace()).run(main, feed={'a': x},
                                       fetch_list=[out], scope=pt.Scope())


# ---- backward cases: the mean of the first output; every parameter's grad --------
def _g_tensor(kind):
    def build(L):
        w = _param(L, (3, 4))
        if kind == 'pad':
            return L.pad(w, paddings=[1, 0, 2, 1], pad_value=0.5)
        if kind == 'reverse':
            return L.reverse(w, axis=[0, 1]) * _data(
                L, 'c', [3, 4], append_batch_size=False)
        if kind == 'crop':
            return _raw(L, 'crop', {'X': w}, {'Out': 'float32'},
                        {'offsets': [1, 1], 'shape': [2, 2]})[0]
        if kind == 'multiplex':
            u = _param(L, (3, 4), 'u')
            return L.multiplex([w, u], _data(L, 'ids', [1], 'int32',
                                             append_batch_size=False))
        if kind == 'scatter':
            u = _param(L, (3, 4), 'u')
            return L.scatter(w, _data(L, 'ids', [3], 'int32',
                                      append_batch_size=False), u) * \
                _data(L, 'c', [3, 4], append_batch_size=False)
        if kind == 'cumsum':
            return L.cumsum(w, axis=1, exclusive=True, reverse=True) * _data(
                L, 'c', [3, 4], append_batch_size=False)
        if kind == 'l2_normalize':
            return L.l2_normalize(w, axis=1) * _data(
                L, 'c', [3, 4], append_batch_size=False)
        if kind == 'minus':
            return _raw(L, 'minus', {'X': w, 'Y': w * w},
                        {'Out': 'float32'})[0]
        if kind == 'smooth_l1_loss':
            return _raw(L, 'smooth_l1_loss',
                        {'X': w, 'Y': _data(L, 'c', [3, 4],
                                            append_batch_size=False)},
                        {'Out': 'float32', 'Diff': 'float32'})[0]
        raise KeyError(kind)
    return build


def _g_products(kind):
    def build(L):
        if kind == 'bilinear_tensor_product':
            w = _param(L, (2, 4, 3))
            b = _param(L, (1, 2), 'b')
            return _raw(L, 'bilinear_tensor_product',
                        {'X': _data(L, 'x', [4]), 'Y': _data(L, 'y', [3]),
                         'Weight': w, 'Bias': b}, {'Out': 'float32'})[0]
        w = _param(L, (2, 3))
        return _raw(L, 'conv_shift', {'X': _data(L, 'cx', [7]), 'Y': w},
                    {'Out': 'float32'})[0] * _data(L, 'c7', [7])
    return build


def _g_conv(kind):
    def build(L):
        if kind == 'conv2d_transpose':
            x = _data(L, 'x', [3, 5, 4])
            return L.conv2d_transpose(x, num_filters=2, filter_size=3,
                                      stride=2, padding=1, dilation=2) * \
                _data(L, 'c', [2, 11, 9])
        x = _data(L, 'x', [4, 5, 6, 5])
        if kind == 'conv3d':
            w = _param(L, (6, 2, 3, 3, 3))
            return _raw(L, 'conv3d', {'Input': x, 'Filter': w},
                        {'Output': 'float32'},
                        {'strides': [1, 2, 1], 'paddings': [1, 0, 1],
                         'groups': 2})[0]
        w = _param(L, (4, 3, 2, 3, 2))
        return _raw(L, 'conv3d_transpose', {'Input': x, 'Filter': w},
                    {'Output': 'float32'},
                    {'strides': [2, 1, 2], 'paddings': [1, 0, 0],
                     'dilations': [1, 2, 1], 'groups': 2})[0]
    return build


def _g_pool(kind):
    def build(L):
        w = _param(L, (2, 2, 5, 6, 7) if kind.startswith('pool3d')
                   else (2, 3, 5, 7))
        if kind == 'pool3d_max':
            return _raw(L, 'pool3d', {'X': w}, {'Out': 'float32'},
                        {'pooling_type': 'max', 'ksize': [2, 3, 2],
                         'strides': [2, 2, 1], 'paddings': [1, 0, 1]})[0]
        if kind == 'pool3d_avg':
            return _raw(L, 'pool3d', {'X': w}, {'Out': 'float32'},
                        {'pooling_type': 'avg', 'ksize': [3, 3, 3],
                         'strides': [2, 2, 2], 'paddings': [1, 1, 1]})[0]
        if kind == 'spp_avg':
            return L.spp(w, pyramid_height=3, pool_type='avg') * _data(
                L, 'c', [63], append_batch_size=True)
        out, mask = L.max_pool2d_with_index(w, pool_size=3, pool_stride=2,
                                            pool_padding=1)
        if kind == 'max_pool2d_with_index':
            return out
        return L.unpool(out, mask, pool_size=3, pool_stride=2,
                        pool_padding=1) * _data(L, 'cu', [3, 5, 7])
    return build


def _g_nn(kind):
    def build(L):
        if kind == 'lrn':
            return L.lrn(_param(L, (2, 6, 3, 3)), n=3, k=2.0, alpha=1e-2) * \
                _data(L, 'c', [6, 3, 3])
        if kind == 'bilinear_interp':
            return L.bilinear_interp(_param(L, (2, 2, 3, 4)), out_h=5,
                                     out_w=7) * _data(L, 'c', [2, 5, 7])
        if kind == 'label_smooth':
            prior = _param(L, (5,))
            return L.label_smooth(_data(L, 'lab', [5]), prior_dist=prior,
                                  epsilon=0.3) * _data(L, 'c5', [5])
        if kind == 'dice_loss':
            return L.dice_loss(L.sigmoid(_param(L, (2, 3, 4))),
                               _data(L, 'm', [3, 4]))
        return _pinned_nce(L, weight=True)[0]
    return build


_POOL_W = np.round(np.random.RandomState(5).uniform(
    0, 4, (2, 3, 5, 7))).astype('float32')      # ties in the windows
GRAD_CASES = {
    'pad': (_g_tensor('pad'), {}, None),
    'reverse': (_g_tensor('reverse'), {'c': _randn(3, 4)}, None),
    'crop': (_g_tensor('crop'), {}, None),
    'multiplex': (_g_tensor('multiplex'),
                  {'ids': np.array([1, 0, 1], 'int32')}, None),
    'scatter_repeated_id': (_g_tensor('scatter'),
                            {'ids': np.array([2, 0, 2], 'int32'),
                             'c': _randn(3, 4)}, None),
    'cumsum': (_g_tensor('cumsum'), {'c': _randn(3, 4)}, None),
    'l2_normalize': (_g_tensor('l2_normalize'), {'c': _randn(3, 4)}, None),
    'minus': (_g_tensor('minus'), {}, None),
    'smooth_l1_loss': (_g_tensor('smooth_l1_loss'), {'c': _randn(3, 4)},
                       None),
    'bilinear_tensor_product': (_g_products('bilinear_tensor_product'),
                                {'x': _randn(3, 4), 'y': _randn(3, 3, seed=1)},
                                None),
    'conv_shift': (_g_products('conv_shift'),
                   {'cx': _randn(2, 7), 'c7': _randn(2, 7, seed=1)}, None),
    'conv2d_transpose': (_g_conv('conv2d_transpose'),
                         {'x': _randn(2, 3, 5, 4), 'c': _randn(2, 2, 11, 9)},
                         None),
    'conv3d': (_g_conv('conv3d'), {'x': _randn(2, 4, 5, 6, 5)}, None),
    'conv3d_transpose': (_g_conv('conv3d_transpose'),
                         {'x': _randn(2, 4, 5, 6, 5)}, None),
    'pool3d_max': (_g_pool('pool3d_max'), {}, None),
    'pool3d_avg': (_g_pool('pool3d_avg'), {}, None),
    'spp_avg': (_g_pool('spp_avg'), {'c': _randn(2, 63)}, None),
    'max_pool2d_with_index_ties': (_g_pool('max_pool2d_with_index'), {},
                                   _POOL_W),
    'unpool': (_g_pool('unpool'), {'cu': _randn(2, 3, 5, 7)}, _POOL_W),
    'lrn': (_g_nn('lrn'), {'c': _randn(2, 6, 3, 3)}, None),
    'bilinear_interp': (_g_nn('bilinear_interp'), {'c': _randn(2, 2, 5, 7)},
                        None),
    'label_smooth': (_g_nn('label_smooth'),
                     {'lab': np.eye(5, dtype='float32')[[1, 3]],
                      'c5': _randn(2, 5)}, None),
    'dice_loss': (_g_nn('dice_loss'),
                  {'m': (_randn(2, 3, 4) > 0).astype('float32')}, None),
    'nce_pinned': (_g_nn('nce'), {
        'x': _randn(4, 6), 'lab': np.array([[1, 5], [0, 12], [7, 7], [3, 2]],
                                           'int64'),
        'sw': np.array([[1.0], [0.5], [2.0], [1.5]], 'float32')}, None),
    'lstm': (_aliased('lstm'), _seq(8), None),
    'gru': (_aliased('gru'), _seq(6), None),
}


@pytest.mark.parametrize('case', sorted(GRAD_CASES))
def test_grad_matches_jax(case):
    build, feeds, w = GRAD_CASES[case]
    j_res, t_res = run_both(build, feeds, grads=True,
                            params=None if w is None else {'w': w})
    assert len(t_res) > 1, 'no parameter'
    for i, (j, t) in enumerate(zip(j_res, t_res)):
        assert_same(j, t, '%s fetch %d' % (case, i))
    assert max(np.abs(t).max() for t in t_res[1:]) > 0, 'no gradient'


def test_nce_draws_from_the_scope_generator():
    """Without pinned negatives the port draws them from the Scope's
    generator: two runs of one seeded program agree, and the sampled
    labels lie in the class range."""
    main, startup = pt.Program(), pt.Program()
    main.random_seed = startup.random_seed = 7
    with pt.unique_name.guard(), pt.program_guard(main, startup):
        x = _data(pt.layers, 'x', [6])
        cost = pt.layers.nce(x, _data(pt.layers, 'lab', [1], 'int64'),
                             num_total_classes=50, num_neg_samples=8)
        labels = _out(cost, 'SampleLabels')
    feed = {'x': _randn(3, 6), 'lab': np.array([[1], [2], [3]], 'int64')}
    got = []
    for _ in range(2):
        scope = pt.Scope()
        exe = pt.Executor(pt.CPUPlace())
        exe.run(startup, scope=scope)
        got.append(exe.run(main, feed=feed, fetch_list=[cost, labels],
                           scope=scope))
    np.testing.assert_array_equal(got[0][1], got[1][1])
    np.testing.assert_array_equal(got[0][0], got[1][0])
    assert got[0][1].shape == (3, 9)
    assert (got[0][1] >= 0).all() and (got[0][1] < 50).all()


def test_conv_layout_nhwc_matches_nchw():
    """``amp.set_conv_layout('NHWC')`` runs the plain conv2d and conv3d
    channels-last; their outputs and gradients equal the NCHW ones, and
    paddle_tpu's under its own NHWC switch."""
    from paddle_tpu.core import amp as jamp
    from paddle_tpu_torch.core import amp as tamp

    def build(L):
        x = _data(L, 'x', [3, 6, 5])
        x3 = _data(L, 'x3', [4, 5, 6, 5])
        return [L.conv2d(x, num_filters=4, filter_size=3, stride=2,
                         padding=1, bias_attr=False),
                _raw(L, 'conv3d', {'Input': x3, 'Filter': _param(
                    L, (6, 2, 3, 3, 3), 'f3')}, {'Output': 'float32'},
                    {'strides': [1, 2, 1], 'paddings': [1, 0, 1],
                     'groups': 2})[0]]
    feeds = {'x': _randn(2, 3, 6, 5), 'x3': _randn(2, 4, 5, 6, 5, seed=1)}
    base = run_both(build, feeds, grads=True)
    for amp in (jamp, tamp):
        amp.set_conv_layout('NHWC')
    try:
        assert tamp.conv_layout() == 'NHWC'
        nhwc = run_both(build, feeds, grads=True)
    finally:
        for amp in (jamp, tamp):
            amp.set_conv_layout(None)
    assert tamp.conv_layout() == 'NCHW'
    for j, t, tb in zip(nhwc[0], nhwc[1], base[1]):
        assert_same(j, t, 'nhwc')
        np.testing.assert_allclose(t, tb, **TOL)
    with pytest.raises(ValueError):
        tamp.set_conv_layout('HWCN')


# ---- the card's f32 route of the transposed and 3-D convs -----------------------
_F32_CONVS = {
    'conv2d_transpose': ((2, 3, 5, 4), (3, 2, 3, 3), [2, 2], [1, 1], [2, 2],
                         True, 1),
    'conv3d': ((2, 4, 5, 6, 5), (6, 2, 3, 3, 3), [1, 2, 1], [1, 0, 1],
               [1, 1, 1], False, 2),
    'conv3d_transpose': ((2, 4, 3, 4, 3), (4, 3, 2, 3, 2), [2, 1, 2],
                         [1, 0, 0], [1, 1, 1], True, 2),
}


@pytest.mark.parametrize('case', sorted(_F32_CONVS))
def test_f32_conv_route_matches_autograd(case):
    """``_F32Conv``, the route of an f32 transposed or 3-D conv on the
    card, driven here on CPU tensors: its output and both input gradients
    (from ``aten.convolution_backward``) equal ``aten.convolution``'s
    under autograd, and cuDNN's TF32 flag reads as it did before."""
    import torch
    from paddle_tpu_torch.ops import nn_ops
    xs, ws, stride, pad, dil, transposed, groups = _F32_CONVS[case]
    rng = np.random.RandomState(0)
    xv, wv = rng.randn(*xs).astype('float32'), rng.randn(*ws).astype('float32')
    flag = torch.backends.cudnn.allow_tf32

    def run(route):
        x = torch.tensor(xv, requires_grad=True)
        w = torch.tensor(wv, requires_grad=True)
        out = route(x, w, stride, pad, dil, transposed, groups)
        (out ** 2).mean().backward()
        return [t.detach().numpy() for t in (out, x.grad, w.grad)]
    for g, w in zip(run(nn_ops._F32Conv.apply), run(nn_ops._convolution)):
        np.testing.assert_allclose(g, w, **TOL)
    assert torch.backends.cudnn.allow_tf32 == flag


@pytest.mark.parametrize('start', [True, False])
def test_tf32_scope_holds_across_threads(start):
    """Eight threads entering ``_cudnn_tf32_off`` at once: each reads the
    flag off inside its block, and the flag is back where it started
    after all have left (the lock keeps one thread from restoring
    another's setting)."""
    import threading
    import torch
    from paddle_tpu_torch.ops import nn_ops
    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = start
    seen, barrier = [], threading.Barrier(8)

    def work():
        barrier.wait()
        for _ in range(200):
            with nn_ops._cudnn_tf32_off():
                seen.append(torch.backends.cudnn.allow_tf32)
    try:
        threads = [threading.Thread(target=work) for _ in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        assert len(seen) == 1600 and not any(seen)
        assert torch.backends.cudnn.allow_tf32 == start
    finally:
        torch.backends.cudnn.allow_tf32 = prev
