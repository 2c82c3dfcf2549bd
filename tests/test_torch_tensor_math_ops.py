"""The port's tensor, math and loss ops against paddle_tpu's.

Each case builds one small Program with both packages' layers under
fresh unique-name generators, so both name their variables alike; the
two programs must hold the same ops with the same attrs. Both run on
the CPU in f32 (AMP off) on the same numpy feeds and parameters, with
the compiler off, so the ops themselves are compared:

- forward: float fetches to atol = rtol = 1e-5; integer and bool
  fetches equal in value (the JAX package runs int64 as int32, the port
  keeps int64: values are compared, not widths), NaN where NaN;
- backward: ``append_backward`` of the mean of the op's output, with the
  differentiated input a parameter ``w``; the loss and ``w@GRAD`` (and
  any other parameter's gradient) to 1e-5.

The edges: ties in reduce_max / reduce_min and maxout (the cotangent
split among the tied elements), a zero in reduce_prod's rows, labels
outside one_hot's depth, ties in top_k and accuracy (the lower index
first), every matmul form, squeeze with and without axes, gather with
negative, repeated and out-of-range indices, and
fill_constant_batch_size_like on a SequenceTensor.
"""
import numpy as np
import pytest

import paddle_tpu.fluid as fluid
import paddle_tpu.compiler as jax_compiler
import paddle_tpu_torch as pt
from paddle_tpu_torch import io as pt_io

TOL = dict(atol=1e-5, rtol=1e-5)


def _build(pkg, build):
    main, startup = pkg.Program(), pkg.Program()
    with pkg.unique_name.guard(), pkg.program_guard(main, startup):
        outs = build(pkg.layers)
    return main, outs if isinstance(outs, (list, tuple)) else [outs]


def _ops(program):
    return [(op.type, sorted(op.inputs.items()), sorted(op.outputs.items()),
             sorted(op.attrs.items())) for op in program.global_block().ops]


def _feeds(feeds, pkg):
    return feeds(pkg) if callable(feeds) else feeds


def run_both(build, feeds, params=None, grads=False):
    """Build with both packages and run both raw on the same feeds and
    parameters (``params``: name -> array; by default every parameter
    drawn from U[0.5, 1.5]). With ``grads`` the mean of the first output
    is the loss: returns its value and every parameter's gradient.
    Returns (jax fetches as numpy, the port's fetches)."""
    def prog(pkg):
        def b(L):
            outs = build(L)
            outs = list(outs) if isinstance(outs, (list, tuple)) else [outs]
            if not grads:
                return outs
            loss = L.mean(outs[0])
            pkg.backward.append_backward(loss)
            return [loss]
        return _build(pkg, b)

    j_main, j_outs = prog(fluid)
    t_main, t_outs = prog(pt)
    assert _ops(t_main) == _ops(j_main)
    rng = np.random.RandomState(0)
    names = sorted(p.name for p in j_main.global_block().all_parameters())
    params = dict(params or {})
    for n in names:
        if n not in params:
            shape = j_main.global_block().var(n).shape
            params[n] = rng.uniform(0.5, 1.5, shape).astype('float32')
    fetch = [v.name for v in j_outs] + ([n + '@GRAD' for n in names]
                                        if grads else [])

    j_scope = fluid.Scope()
    for n in names:
        j_scope.set_var(n, params[n])
    with jax_compiler.disabled():
        j_res = fluid.Executor(fluid.CPUPlace()).run(
            j_main, feed=_feeds(feeds, fluid), fetch_list=fetch,
            scope=j_scope)
    t_scope = pt.Scope()
    pt_io.params_from_numpy(t_scope, {n: params[n] for n in names},
                            pt.CPUPlace())
    with pt.compiler.disabled():
        t_res = pt.Executor(pt.CPUPlace()).run(
            t_main, feed=_feeds(feeds, pt), fetch_list=fetch,
            scope=t_scope)
    assert len(j_res) == len(t_res) == len(fetch)
    return [np.asarray(r) for r in j_res], [np.asarray(r) for r in t_res]


def assert_same(j, t, name=''):
    assert t.shape == j.shape, (name, t.shape, j.shape)
    if j.dtype.kind in 'biu' or t.dtype.kind in 'biu':
        assert t.dtype.kind == j.dtype.kind, (name, t.dtype, j.dtype)
        np.testing.assert_array_equal(t, j, err_msg=name)
    else:
        np.testing.assert_allclose(t, j, err_msg=name, equal_nan=True,
                                   **TOL)


def _randn(*shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype('float32')


def _data(L, name, shape, dtype='float32', **kw):
    return L.data(name=name, shape=shape, dtype=dtype, **kw)


def _param(L, shape, name='w'):
    return L.create_parameter(shape=list(shape), dtype='float32', name=name)


# ---- forward cases: name -> (build(L), feeds) ------------------------------------
def _cast(L):
    x = _data(L, 'x', [5])
    i = _data(L, 'i', [3], 'int64')
    return [L.cast(x, 'int32'), L.cast(x, 'int64'), L.cast(x, 'bool'),
            L.cast(x, 'float64'), L.cast(i, 'float32')]


def _squeeze(L):
    x = _data(L, 'x', [1, 3, 1])
    return [L.squeeze(x, axes=[1]), L.squeeze(x, axes=[3]),
            L.squeeze(x, axes=[1, 3]), L.squeeze(x)]


def _unsqueeze(L):
    x = _data(L, 'x', [3, 4])
    return [L.unsqueeze(x, axes=[0]), L.unsqueeze(x, axes=[1, 3])]


def _transpose(L):
    x = _data(L, 'x', [3, 4])
    return [L.transpose(x, perm=[0, 2, 1]), L.transpose(x, perm=[2, 0, 1])]


def _one_hot(L):
    return L.one_hot(_data(L, 'label', [1], 'int64'), depth=4)


def _gather(L):
    x = _data(L, 'x', [5, 3], append_batch_size=False)
    idx = _data(L, 'idx', [6], 'int64', append_batch_size=False)
    return L.gather(x, idx)


def _top_k(L):
    x = _data(L, 'x', [6])
    return list(L.topk(x, k=3))


def _accuracy(L):
    x = _data(L, 'x', [5])
    label = _data(L, 'label', [1], 'int64')
    out = []
    for k in (1, 2):
        acc = L.accuracy(input=x, label=label, k=k)
        op = acc.block.ops[-1]
        out += [acc] + [acc.block.var(op.output(s)[0])
                        for s in ('Correct', 'Total')]
    return out


def _increment(L):
    x = _data(L, 'x', [3])
    i = _data(L, 'i', [1], 'int64')
    return [L.increment(x, value=2.5, in_place=False),
            L.increment(i, value=3.0, in_place=False)]


def _expand(L):
    x = _data(L, 'x', [2, 3])
    return [L.expand(x, expand_times=[1, 2, 3]),
            L.expand(x, expand_times=[2, 1, 1])]


def _fill_bsl(L):
    x = _data(L, 'x', [4])
    s = _data(L, 's', [3], lod_level=1)
    return [L.fill_constant_batch_size_like(x, shape=[-1, 5],
                                            dtype='float32', value=1.5),
            L.fill_constant_batch_size_like(s, shape=[-1, 2],
                                            dtype='int64', value=7),
            L.fill_constant_batch_size_like(x, shape=[2, -1], dtype='float32',
                                            value=-1.0, input_dim_idx=0,
                                            output_dim_idx=1)]


def _seq_feed(pkg):
    rows = _randn(9, 3, seed=3)
    return {'x': _randn(4, 4),
            's': pkg.create_lod_tensor(rows, [[2, 4, 3]], pkg.CPUPlace())}


def _compare_layer(L, op_type):
    """The port's compare layer; paddle_tpu has layers for less_than and
    equal only (Variable's operators reach the rest), so on its side the
    same op is appended through its LayerHelper."""
    if hasattr(L, op_type):
        return getattr(L, op_type)

    def layer(x, y):
        helper = L.control_flow.LayerHelper(op_type)
        cond = helper.create_tmp_variable(dtype='bool', shape=x.shape)
        cond.stop_gradient = True
        helper.append_op(type=op_type, inputs={'X': [x], 'Y': [y]},
                         outputs={'Out': [cond]})
        return cond
    return layer


def _compare(L):
    x = _data(L, 'x', [5])
    y = _data(L, 'y', [5])
    i = _data(L, 'i', [3], 'int64')
    j = _data(L, 'j', [3], 'int64')
    outs = [_compare_layer(L, n)(x, y) for n in (
        'less_than', 'less_equal', 'greater_than', 'greater_equal',
        'equal', 'not_equal')]
    outs += [L.less_than(i, j), L.equal(i, j)]
    a, b = L.less_than(x, y), L.equal(x, y)
    outs += [L.logical_and(a, b), L.logical_or(a, b), L.logical_xor(a, b),
             L.logical_not(a), L.logical_and(x, y), L.logical_not(x)]
    return outs


def _cmp_feed():
    x = np.array([[1, 2, 3, 4, 0], [0, -1, 2, 2, 5]], 'float32')
    y = np.array([[1, 3, 2, 4, 0], [1, -1, 0, 2, 5]], 'float32')
    return {'x': x, 'y': y,
            'i': np.array([[1, 2, 3], [3, 2, 1]], 'int64'),
            'j': np.array([[1, 3, 2], [3, 0, 1]], 'int64')}


def _reduces(L):
    x = _data(L, 'x', [3, 4])
    outs = []
    for name in ('reduce_sum', 'reduce_mean', 'reduce_max', 'reduce_min',
                 'reduce_prod'):
        f = getattr(L, name)
        outs += [f(x), f(x, dim=1), f(x, dim=[0, 2]), f(x, dim=-1,
                                                        keep_dim=True),
                 f(x, dim=[1, 2], keep_dim=True)]
    return outs


def _matmul(L):
    a = _data(L, 'a', [3, 4], append_batch_size=False)
    b = _data(L, 'b', [4, 5], append_batch_size=False)
    at = _data(L, 'at', [4, 3], append_batch_size=False)
    bt = _data(L, 'bt', [5, 4], append_batch_size=False)
    v = _data(L, 'v', [4], append_batch_size=False)
    x3 = _data(L, 'x3', [2, 3, 4], append_batch_size=False)
    y3 = _data(L, 'y3', [2, 4, 5], append_batch_size=False)
    return [L.matmul(a, b), L.matmul(at, b, transpose_x=True),
            L.matmul(a, bt, transpose_y=True),
            L.matmul(at, bt, transpose_x=True, transpose_y=True),
            L.matmul(a, b, alpha=0.5), L.matmul(v, b), L.matmul(a, v),
            L.matmul(x3, b), L.matmul(x3, y3),
            L.matmul(x3, y3, transpose_x=False, alpha=2.0)]


def _matmul_feed():
    names = {'a': (3, 4), 'b': (4, 5), 'at': (4, 3), 'bt': (5, 4),
             'v': (4,), 'x3': (2, 3, 4), 'y3': (2, 4, 5)}
    return {n: _randn(*s, seed=i) for i, (n, s) in enumerate(names.items())}


def _costs(L):
    x = _data(L, 'x', [4])
    y = _data(L, 'y', [4])
    iw = _data(L, 'iw', [4])
    ow = _data(L, 'ow', [4])
    return [L.square_error_cost(input=x, label=y), L.smooth_l1(x, y),
            L.smooth_l1(x, y, inside_weight=iw, outside_weight=ow,
                        sigma=2.0),
            L.cos(x), L.sin(x),
            L.sigmoid_cross_entropy_with_logits(x=x, label=iw)]


def _losses(L):
    x = _data(L, 'x', [4])
    y = _data(L, 'y', [4])
    p = _data(L, 'p', [4])
    lab = _data(L, 'lab', [4])
    sign = _data(L, 'sign', [4])
    row = _data(L, 'row', [4], append_batch_size=False)
    return [L.hinge_loss(input=x, label=lab), L.huber_loss(x, y, delta=0.7),
            L.log_loss(p, lab), L.rank_loss(lab, x, y),
            L.margin_rank_loss(sign, x, y, margin=0.2),
            L.modified_huber_loss(x, lab), L.squared_l2_distance(x, y),
            L.squared_l2_distance(x, L.reshape(row, [1, 4])),
            L.squared_l2_norm(x), L.l1_norm(x)]


def _loss_feed():
    r = np.random.RandomState(5)
    return {'x': (r.randn(3, 4) * 1.5).astype('float32'),
            'y': r.randn(3, 4).astype('float32'),
            'p': r.uniform(0.05, 0.95, (3, 4)).astype('float32'),
            'lab': r.randint(0, 2, (3, 4)).astype('float32'),
            'sign': np.where(r.rand(3, 4) > 0.5, 1.0, -1.0).astype(
                'float32'),
            'row': r.randn(4).astype('float32')}


def _prelu_maxout(L):
    x = _data(L, 'x', [4, 3, 3])
    return [L.prelu(x, mode='all'), L.prelu(x, mode='channel'),
            L.maxout(x, groups=2)]


_X3 = np.array([[0.5, 2.0, 2.0, -1.0], [3.0, -2.0, 0.0, 1.0],
                [1.0, 1.0, 1.0, 1.0]], 'float32')

CASES = {
    'cast': (_cast, {'x': np.array([[-2.7, -0.2, 0.0, 0.6, 3.9]] * 2,
                                   'float32'),
                     'i': np.array([[-3, 0, 7]], 'int64')}),
    'squeeze': (_squeeze, {'x': _randn(1, 1, 3, 1)}),
    'unsqueeze': (_unsqueeze, {'x': _randn(2, 3, 4)}),
    'transpose': (_transpose, {'x': _randn(2, 3, 4)}),
    # 4 and -1 are outside depth 4: rows of zeros
    'one_hot': (_one_hot, {'label': np.array([[0], [3], [4], [-1], [2]],
                                             'int64')}),
    # -1 counts from the end, 3 repeats, 7 and -6 are out of range (NaN)
    'gather': (_gather, {'x': _randn(5, 3),
                         'idx': np.array([3, -1, 0, 3, 7, -6], 'int64')}),
    'top_k': (_top_k, {'x': np.array([[0.1, 0.9, 0.3, 0.7, -0.2, 0.5],
                                      [0.4, 0.4, 0.8, 0.4, 0.8, 0.1]],
                                     'float32')}),
    'accuracy': (_accuracy, {
        'x': np.array([[0.1, 0.5, 0.2, 0.5, 0.0], [0.3, 0.1, 0.9, 0.2, 0.9],
                       [0.7, 0.1, 0.1, 0.05, 0.05],
                       [0.2, 0.2, 0.2, 0.2, 0.2]], 'float32'),
        'label': np.array([[3], [2], [1], [0]], 'int64')}),
    'increment': (_increment, {'x': _randn(2, 3),
                               'i': np.array([[4], [-2]], 'int64')}),
    'expand': (_expand, {'x': _randn(2, 2, 3)}),
    'fill_constant_batch_size_like': (_fill_bsl, _seq_feed),
    'compare_logical': (_compare, _cmp_feed()),
    'reduce': (_reduces, {'x': np.stack([_X3, _X3 * -1.5])}),
    'matmul': (_matmul, _matmul_feed()),
    'costs': (_costs, {'x': _randn(3, 4, seed=1) * 1.5,
                       'y': _randn(3, 4, seed=2),
                       'iw': np.random.RandomState(3).rand(3, 4).astype(
                           'float32'),
                       'ow': np.random.RandomState(4).rand(3, 4).astype(
                           'float32')}),
    'losses': (_losses, _loss_feed()),
    'prelu_maxout': (_prelu_maxout, {'x': _randn(2, 4, 3, 3)}),
}


@pytest.mark.parametrize('case', sorted(CASES))
def test_op_matches_jax(case):
    build, feeds = CASES[case]
    j_res, t_res = run_both(build, feeds)
    for i, (j, t) in enumerate(zip(j_res, t_res)):
        assert_same(j, t, '%s output %d' % (case, i))


def test_one_hot_and_top_k_edges_read_as_documented():
    """What the cases above hold both packages to: an out-of-range label
    is a zero row, and among equal values top_k takes the lower index."""
    _, t = run_both(*CASES['one_hot'])
    assert t[0].sum(1).tolist() == [1, 1, 0, 0, 1]
    _, t = run_both(*CASES['top_k'])
    assert t[1].tolist() == [[1, 3, 5], [2, 4, 0]]


# ---- backward cases: name -> (build(L), feeds, the parameter w) -------------------
_TIES = np.array([[1.0, 3.0, 3.0, -2.0], [2.0, 2.0, 0.5, 0.0],
                  [0.0, -1.0, 4.0, 1.5]], 'float32')
_ZEROS = np.array([[2.0, 0.0, 3.0, -1.0], [0.0, 0.0, 1.5, 2.0],
                   [1.0, -2.0, 0.5, 3.0]], 'float32')


def _reduce_grad(name, **kw):
    return lambda L: getattr(L, name)(_param(L, (3, 4)), **kw)


def _grad_matmul(form):
    def build(L):
        w = _param(L, (3, 4))
        if form == 'plain':
            return L.matmul(w, _data(L, 'b', [4, 5], append_batch_size=False))
        if form == 'transpose_x':
            return L.matmul(w, _data(L, 'b', [3, 5], append_batch_size=False),
                            transpose_x=True, alpha=0.5)
        if form == 'transpose_y':
            return L.matmul(_data(L, 'a', [2, 4], append_batch_size=False),
                            w, transpose_y=True)
        if form == 'vector':
            return L.matmul(_data(L, 'v', [3], append_batch_size=False), w)
        return L.matmul(_data(L, 'x3', [2, 5, 3], append_batch_size=False),
                        w)
    return build


def _grad_loss(name):
    def build(L):
        w = _param(L, (3, 4))
        x = _data(L, 'x', [4])
        lab = _data(L, 'lab', [4])
        if name == 'hinge':
            return L.hinge_loss(input=w, label=lab)
        if name == 'huber':
            return L.huber_loss(w, x, delta=0.7)
        if name == 'log':
            return L.log_loss(L.sigmoid(w), lab)
        if name == 'rank':
            return L.rank_loss(lab, w, x)
        if name == 'margin_rank':
            return L.margin_rank_loss(lab, w, x, margin=0.2)
        if name == 'modified_huber':
            return L.modified_huber_loss(w, lab)
        if name == 'squared_l2_distance':
            return L.squared_l2_distance(w, x)
        if name == 'squared_l2_norm':
            return L.squared_l2_norm(w)
        if name == 'l1_norm':
            return L.l1_norm(w)
        if name == 'square_error_cost':
            return L.square_error_cost(input=w, label=x)
        if name == 'smooth_l1':
            return L.smooth_l1(w, x, inside_weight=lab, sigma=1.5)
        if name == 'sigmoid_xent':
            return L.sigmoid_cross_entropy_with_logits(x=w, label=lab)
        if name in ('cos', 'sin'):
            return getattr(L, name)(w)
        raise KeyError(name)
    return build


def _grad_shape(name):
    def build(L):
        w = _param(L, (3, 1, 4))
        if name == 'squeeze':
            return L.scale(L.squeeze(w, axes=[1]), scale=2.0)
        if name == 'unsqueeze':
            return L.cos(L.unsqueeze(w, axes=[0, 3]))
        if name == 'transpose':
            return L.elementwise_mul(L.transpose(w, perm=[2, 0, 1]),
                                     _data(L, 'c', [4, 3, 1],
                                           append_batch_size=False))
        if name == 'expand':
            return L.sin(L.expand(w, expand_times=[2, 3, 1]))
        if name == 'gather':
            return L.cos(L.gather(L.reshape(w, [3, 4]),
                                  _data(L, 'idx', [5], 'int64',
                                        append_batch_size=False)))
        raise KeyError(name)
    return build


def _grad_prelu_maxout(name):
    def build(L):
        w = _param(L, (2, 4, 3, 3))
        if name == 'prelu_all':
            return L.prelu(w, mode='all')
        if name == 'prelu_channel':
            return L.prelu(w, mode='channel')
        return L.maxout(w, groups=2)
    return build


_R = np.random.RandomState(11)
_LOSS_FEED = {'x': _R.randn(3, 4).astype('float32'),
              'lab': _R.randint(0, 2, (3, 4)).astype('float32')}
_W34 = (_R.randn(3, 4) * 1.5).astype('float32')
_W_MAXOUT = _R.randn(2, 4, 3, 3).astype('float32')
_W_MAXOUT[:, 2] = _W_MAXOUT[:, 3]          # ties between grouped maps
_W_PRELU = _R.randn(2, 4, 3, 3).astype('float32')

GRAD_CASES = {
    'reduce_max_ties': (_reduce_grad('reduce_max', dim=1), {}, _TIES),
    'reduce_max_all_ties': (_reduce_grad('reduce_max'), {}, _TIES),
    'reduce_min_ties': (_reduce_grad('reduce_min', dim=[0, 1]), {}, _TIES),
    'reduce_min_keep': (_reduce_grad('reduce_min', dim=0, keep_dim=True), {},
                        _TIES),
    'reduce_prod_zero': (_reduce_grad('reduce_prod', dim=1), {}, _ZEROS),
    'reduce_prod_all': (_reduce_grad('reduce_prod'), {}, _ZEROS[2:] + 0.5),
    'reduce_prod_dims': (_reduce_grad('reduce_prod', dim=[0, 1]), {},
                         _ZEROS * 0.5 + 1.0),
    'reduce_mean': (_reduce_grad('reduce_mean', dim=-1), {}, _W34),
    'reduce_sum': (_reduce_grad('reduce_sum', dim=0), {}, _W34),
    'matmul_plain': (_grad_matmul('plain'), {'b': _randn(4, 5, seed=2)},
                     _W34),
    'matmul_transpose_x': (_grad_matmul('transpose_x'),
                           {'b': _randn(3, 5, seed=3)}, _W34),
    'matmul_transpose_y': (_grad_matmul('transpose_y'),
                           {'a': _randn(2, 4, seed=4)}, _W34),
    'matmul_vector': (_grad_matmul('vector'), {'v': _randn(3, seed=5)}, _W34),
    'matmul_batch': (_grad_matmul('batch'), {'x3': _randn(2, 5, 3, seed=6)},
                     _W34),
    'squeeze': (_grad_shape('squeeze'), {}, None),
    'unsqueeze': (_grad_shape('unsqueeze'), {}, None),
    'transpose': (_grad_shape('transpose'), {'c': _randn(4, 3, 1, seed=7)},
                  None),
    'expand': (_grad_shape('expand'), {}, None),
    # a repeated index adds two rows' cotangents into one
    'gather': (_grad_shape('gather'),
               {'idx': np.array([2, 0, 2, -1, 1], 'int64')}, None),
    'prelu_all': (_grad_prelu_maxout('prelu_all'), {}, _W_PRELU),
    'prelu_channel': (_grad_prelu_maxout('prelu_channel'), {}, _W_PRELU),
    'maxout_ties': (_grad_prelu_maxout('maxout'), {}, _W_MAXOUT),
}
for _name in ('hinge', 'huber', 'log', 'rank', 'margin_rank',
              'modified_huber', 'squared_l2_distance', 'squared_l2_norm',
              'l1_norm', 'square_error_cost', 'smooth_l1', 'sigmoid_xent',
              'cos', 'sin'):
    GRAD_CASES[_name] = (_grad_loss(_name), _LOSS_FEED, _W34)


@pytest.mark.parametrize('case', sorted(GRAD_CASES))
def test_grad_matches_jax(case):
    build, feeds, w = GRAD_CASES[case]
    j_res, t_res = run_both(build, feeds, grads=True,
                            params=None if w is None else {'w': w})
    for i, (j, t) in enumerate(zip(j_res, t_res)):
        assert_same(j, t, '%s fetch %d' % (case, i))
    assert np.abs(t_res[1]).max() > 0, 'no gradient reached w'


def test_tied_max_splits_its_cotangent():
    """The tie edge itself: row 0 of _TIES has its max twice, so each
    copy gets half the row's cotangent (1/3 of the mean's, over 3
    rows), in both packages."""
    _, (loss, g) = run_both(*GRAD_CASES['reduce_max_ties'][:2], grads=True,
                            params={'w': _TIES})
    np.testing.assert_allclose(g[0], [0, 1 / 6., 1 / 6., 0], **TOL)
    # a zero in a row: reduce_prod's gradient there is the product of
    # the others, not 0 / 0
    _, (_, g) = run_both(*GRAD_CASES['reduce_prod_zero'][:2], grads=True,
                         params={'w': _ZEROS})
    np.testing.assert_allclose(g[0], [0, -6 / 3., 0, 0], **TOL)
    assert np.all(g[1] == 0)
