"""The port's conv2d, pool2d and batch_norm ops, and its activation ops,
against paddle_tpu's.

Each case builds a small Program with both packages' layers under fresh
unique-name generators, so both name their variables alike. The JAX
package's startup program draws the parameters; batch-norm statistics
and affine are then randomized, and both scopes get the same numpy
values. Both run on the CPU in f32 (AMP off) with the compiler
disabled, so the unfused ops themselves are compared, to atol = rtol =
1e-5.
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
    startup.random_seed = 5
    with pkg.unique_name.guard(), pkg.program_guard(main, startup):
        outs = build(pkg.layers)
    return main, startup, outs if isinstance(outs, (list, tuple)) else [outs]


def _ops(program):
    return [(op.type, sorted(op.inputs.items()), sorted(op.outputs.items()),
             sorted(op.attrs.items())) for op in program.global_block().ops]


def _persistables(program):
    return sorted(v.name for v in program.list_vars() if v.persistable)


def randomized_params(j_main, j_startup, seed=7):
    """The JAX startup's parameters, with every batch norm's moving
    statistics and affine randomized, so no fold hides behind identity
    values."""
    j_scope = fluid.Scope()
    fluid.Executor(fluid.CPUPlace()).run(j_startup, scope=j_scope)
    params = {n: np.asarray(j_scope.raw(n)) for n in _persistables(j_main)
              if j_scope.raw(n) is not None}
    return randomize_batch_norms(j_main, params, seed)


def randomize_batch_norms(main, params, seed=7):
    """``params`` with every batch norm's moving statistics and affine
    (as ``main`` names them) drawn anew from ``seed``."""
    rng = np.random.RandomState(seed)
    for op in main.global_block().ops:
        if op.type != 'batch_norm':
            continue
        c = params[op.input('Scale')[0]].shape[0]
        params[op.input('Mean')[0]] = rng.randn(c).astype('float32') * 0.3
        params[op.input('Variance')[0]] = (rng.rand(c) + 0.5).astype(
            'float32')
        params[op.input('Scale')[0]] = (rng.rand(c) + 0.5).astype('float32')
        params[op.input('Bias')[0]] = rng.randn(c).astype('float32') * 0.1
    return params


def run_both(build, feeds, more=None):
    """Build with both packages, run both raw on the same parameters and
    feeds; returns the JAX and the port's fetches. ``more(main)`` may
    name (extra fetches, persistables to read from the scope after the
    run), both appended to the results."""
    j_main, j_startup, j_outs = _build(fluid, build)
    t_main, _, t_outs = _build(pt, build)
    assert _ops(t_main) == _ops(j_main)
    extra, state = more(j_main) if more else ([], [])
    params = randomized_params(j_main, j_startup)
    j_scope = fluid.Scope()
    for n, a in params.items():
        j_scope.set_var(n, a)
    with jax_compiler.disabled():
        j_res = fluid.Executor(fluid.CPUPlace()).run(
            j_main, feed=feeds, fetch_list=j_outs + extra, scope=j_scope)
    t_scope = pt.Scope()
    pt_io.params_from_numpy(t_scope, params, pt.CPUPlace())
    with pt.compiler.disabled():
        t_res = pt.Executor(pt.CPUPlace()).run(
            t_main, feed=feeds, fetch_list=t_outs + extra, scope=t_scope)
    j_state = [np.asarray(j_scope.raw(n)) for n in state]
    t_state = [pt.executor.as_numpy(t_scope.raw(n)) for n in state]
    return ([np.asarray(r) for r in j_res] + j_state, list(t_res) + t_state)


def _assert_close(j_res, t_res):
    assert len(j_res) == len(t_res)
    for j, t in zip(j_res, t_res):
        assert t.shape == j.shape
        np.testing.assert_allclose(t, j, **TOL)


def _randn(*shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype('float32')


# ---- conv2d -------------------------------------------------------------------
# (num_filters, filter_size, stride, padding, groups, dilation, bias)
CONVS = {
    'k3_s1_p1': (6, 3, 1, 1, None, 1, True),
    'k3_s2_p1': (6, 3, 2, 1, None, 1, False),
    'k1_s2': (8, 1, 2, 0, None, 1, False),
    'k7_s2_p3_stem': (8, 7, 2, 3, None, 1, False),
    'k3_groups2': (6, 3, 1, 1, 2, 1, True),
    'k3_depthwise': (4, 3, 1, 1, 4, 1, False),
    'k3_dilation2': (6, 3, 1, 2, None, 2, False),
    'k2x3_s2x1_p1x0': (5, [2, 3], [2, 1], [1, 0], None, 1, True),
}


@pytest.mark.parametrize('case', sorted(CONVS))
def test_conv2d_matches_jax(case):
    nf, k, s, p, g, d, bias = CONVS[case]

    def build(L):
        x = L.data(name='x', shape=[4, 11, 10], dtype='float32')
        return L.conv2d(x, num_filters=nf, filter_size=k, stride=s,
                        padding=p, groups=g, dilation=d,
                        bias_attr=None if bias else False)

    _assert_close(*run_both(build, {'x': _randn(2, 4, 11, 10)}))


# ---- pool2d -------------------------------------------------------------------
# pool2d kwargs
POOLS = {
    'max_k3_s2_p1': dict(pool_size=3, pool_type='max', pool_stride=2,
                         pool_padding=1),
    'avg_global': dict(pool_type='avg', global_pooling=True),
    'max_global': dict(pool_type='max', global_pooling=True),
    'avg_k3_s2_p1_exclusive': dict(pool_size=3, pool_type='avg',
                                   pool_stride=2, pool_padding=1),
    'avg_k3_s2_p1_inclusive': dict(pool_size=3, pool_type='avg',
                                   pool_stride=2, pool_padding=1,
                                   exclusive=False),
    'max_k3_s2_ceil': dict(pool_size=3, pool_type='max', pool_stride=2,
                           ceil_mode=True),
    'avg_k2_s2_ceil_exclusive': dict(pool_size=2, pool_type='avg',
                                     pool_stride=2, ceil_mode=True),
}


@pytest.mark.parametrize('case', sorted(POOLS) + ['adaptive_avg_3x2',
                                                  'adaptive_max_3x2'])
def test_pool2d_matches_jax(case):
    def build(L):
        x = L.data(name='x', shape=[3, 9, 8], dtype='float32')
        if not case.startswith('adaptive'):
            return L.pool2d(x, **POOLS[case])
        # no layer sets ``adaptive``: programs carry it from the
        # reference's adaptive_pool2d; ksize is then the output grid
        out = L.pool2d(x, pool_size=[3, 2], pool_type=case.split('_')[1])
        out.block.ops[-1].attrs['adaptive'] = True
        return out

    _assert_close(*run_both(build, {'x': _randn(2, 3, 9, 8)}))


# ---- batch_norm ---------------------------------------------------------------
@pytest.mark.parametrize('is_test', [True, False])
@pytest.mark.parametrize('act', [None, 'relu'])
def test_batch_norm_matches_jax(is_test, act):
    """Test mode normalises with the moving statistics; train mode with
    the batch moments, fetched as SavedMean/SavedVariance, and its
    MeanOut/VarianceOut update the moving statistics in the scope
    (compared after the run)."""
    def build(L):
        x = L.data(name='x', shape=[4, 5, 6], dtype='float32')
        return L.batch_norm(x, act=act, is_test=is_test, momentum=0.8)

    def more(main):
        bn, = [op for op in main.global_block().ops
               if op.type == 'batch_norm']
        saved = [] if is_test else [bn.output('SavedMean')[0],
                                    bn.output('SavedVariance')[0]]
        return saved, [bn.output('MeanOut')[0], bn.output('VarianceOut')[0]]

    x = 2 * _randn(3, 4, 5, 6) + 0.5
    j_res, t_res = run_both(build, {'x': x}, more)
    _assert_close(j_res, t_res)
    j_main, j_startup, _ = _build(fluid, build)
    mean_before = randomized_params(j_main, j_startup)[more(j_main)[1][0]]
    # train mode moves the moving mean toward the batch mean; test mode
    # leaves it
    assert np.allclose(t_res[-2], mean_before) == is_test


# ---- activations and binary ops (the fused conv's epilogue vocabulary) ------
# non-default attrs for the parametric ones; domain-limited ones get
# positive inputs
ACT_ATTRS = {
    'brelu': {'t_min': -0.5, 't_max': 0.7}, 'leaky_relu': {'alpha': 0.1},
    'elu': {'alpha': 0.5}, 'relu6': {'threshold': 1.0},
    'soft_relu': {'threshold': 1.5}, 'hard_shrink': {'threshold': 0.3},
    'softshrink': {'lambda': 0.3}, 'pow': {'factor': 2.5},
    'stanh': {'scale_a': 0.5, 'scale_b': 1.5},
    'thresholded_relu': {'threshold': 0.2},
    'hard_sigmoid': {'slope': 0.3, 'offset': 0.4}, 'swish': {'beta': 1.5},
}
POSITIVE = {'sqrt', 'log', 'reciprocal', 'pow'}


@pytest.mark.parametrize('name', sorted(pt.layers.ops.__activations__))
def test_activation_op_matches_jax(name):
    def build(L):
        x = L.data(name='x', shape=[4, 5], dtype='float32')
        return getattr(L, name)(x, **ACT_ATTRS.get(name, {}))

    x = 1.5 * _randn(2, 4, 5)
    if name in POSITIVE:
        x = np.abs(x) + 0.25
    _assert_close(*run_both(build, {'x': x}))


@pytest.mark.parametrize('name', ['elementwise_min', 'elementwise_pow'])
def test_binary_op_matches_jax(name):
    def build(L):
        x = L.data(name='x', shape=[3, 4], dtype='float32')
        y = L.data(name='y', shape=[4], dtype='float32',
                   append_batch_size=False)
        return getattr(L, name)(x, y)

    _assert_close(*run_both(build, {'x': np.abs(_randn(2, 3, 4)) + 0.5,
                                    'y': _randn(4, seed=1)}))
