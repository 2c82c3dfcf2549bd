"""The port's initializers, random layers and weight normalisation
against paddle_tpu.

JAX's and torch's generators never agree, so random values are held by
their law, not bit for bit:

- each initializer's startup op (type and attrs) equals paddle_tpu's;
- Constant and Bilinear give paddle_tpu's values exactly;
- Uniform, Normal, Xavier, MSRA, truncated_gaussian_random and the
  random layers by bounds and moments (tolerances a few standard errors
  wide at these sizes);
- one program seed gives the same values twice, another seed or an op
  seed other values;
- ``init_on_cpu()`` marks the random ops ``force_cpu``: they draw from a
  host generator, so their values do not move with the device
  generator's state (here: reseeded) and equal a plain CPU draw; that is
  what makes a seeded init the same on the card;
- ``WeightNormParamAttr``: g = ||v|| after the startup program, for
  dim None, 0 and 1, and 3 SGD steps of an fc built on it against
  paddle_tpu from one set of numpy values (loss, g, v to 1e-5).
"""
import math

import numpy as np
import pytest
import torch

import paddle_tpu.fluid as fluid
import paddle_tpu_torch as pt
from paddle_tpu_torch import io as pt_io
from paddle_tpu_torch.core.lowering import RNG_KEY

TOL = dict(atol=1e-5, rtol=1e-5)


def _init(pkg, init, shape, seed=7, name='p', scope=None):
    main, startup = pkg.Program(), pkg.Program()
    startup.random_seed = seed
    with pkg.unique_name.guard(), pkg.program_guard(main, startup):
        pkg.layers.create_parameter(shape=list(shape), dtype='float32',
                                    name=name, default_initializer=init)
    scope = scope or pkg.Scope()
    pkg.Executor(pkg.CPUPlace()).run(startup, scope=scope)
    return np.asarray(pkg.fetch_var(name, scope)), startup.global_block().ops


def _op_desc(op):
    return op.type, sorted(op.attrs.items())


INITS = {
    'constant': (lambda m: m.Constant(2.5), (6, 5)),
    'uniform': (lambda m: m.Uniform(-0.3, 0.7), (200, 100)),
    'normal': (lambda m: m.Normal(0.5, 2.0), (200, 100)),
    'xavier': (lambda m: m.Xavier(), (120, 80)),
    'xavier_normal': (lambda m: m.Xavier(uniform=False), (120, 80)),
    'msra': (lambda m: m.MSRA(), (64, 32, 3, 3)),
    'msra_normal': (lambda m: m.MSRA(uniform=False), (64, 32, 3, 3)),
    'bilinear': (lambda m: m.Bilinear(), (3, 3, 4, 4)),
}


@pytest.mark.parametrize('name', sorted(INITS))
def test_initializer_op_matches_jax(name):
    make, shape = INITS[name]
    j_val, j_ops = _init(fluid, make(fluid.initializer), shape)
    t_val, t_ops = _init(pt, make(pt.initializer), shape)
    assert [_op_desc(op) for op in t_ops] == [_op_desc(op) for op in j_ops]
    assert t_val.shape == j_val.shape == shape
    op = t_ops[-1]
    if op.type in ('fill_constant', 'assign_value'):
        np.testing.assert_array_equal(t_val, j_val)
    elif op.type == 'uniform_random':
        lo, hi = op.attrs['min'], op.attrs['max']
        assert t_val.min() >= lo and t_val.max() < hi
        assert abs(t_val.mean() - (lo + hi) / 2) < 0.02 * (hi - lo)
        np.testing.assert_allclose(t_val.std(), (hi - lo) / math.sqrt(12),
                                   rtol=0.03)
    else:
        mean, std = op.attrs['mean'], op.attrs['std']
        assert abs(t_val.mean() - mean) < 0.05 * std
        np.testing.assert_allclose(t_val.std(), std, rtol=0.03)


def test_msra_std_is_sqrt_two_over_fan_in():
    for uniform in (True, False):
        v, _ = _init(pt, pt.initializer.MSRA(uniform=uniform),
                     (128, 64, 3, 3))
        np.testing.assert_allclose(v.std(), math.sqrt(2.0 / (64 * 9)),
                                   rtol=0.03)


def test_bilinear_kernel_and_shape_check():
    v, _ = _init(pt, pt.initializer.Bilinear(), (2, 2, 4, 4))
    profile = np.array([0.25, 0.75, 0.75, 0.25], 'float32')
    np.testing.assert_allclose(v[1, 0], np.outer(profile, profile),
                               rtol=1e-6)
    with pytest.raises(ValueError):
        _init(pt, pt.initializer.Bilinear(), (3, 3))


def test_seeded_inits_are_deterministic():
    a, _ = _init(pt, pt.initializer.Uniform(), (30, 30), seed=3)
    b, _ = _init(pt, pt.initializer.Uniform(), (30, 30), seed=3)
    np.testing.assert_array_equal(a, b)
    c, _ = _init(pt, pt.initializer.Uniform(), (30, 30), seed=4)
    d, _ = _init(pt, pt.initializer.Uniform(seed=11), (30, 30), seed=3)
    e, _ = _init(pt, pt.initializer.Uniform(seed=11), (30, 30), seed=4)
    assert not np.array_equal(a, c) and not np.array_equal(a, d)
    np.testing.assert_array_equal(d, e)     # the op's seed wins


def test_init_on_cpu_draws_from_a_host_generator():
    """force_cpu ops draw from the scope's host generator (or their own
    seed's): reseeding the device generator moves every other random op
    but not them, and their values equal a plain CPU draw."""
    assert not pt.initializer.force_init_on_cpu()

    def build():
        main, startup = pt.Program(), pt.Program()
        startup.random_seed = 5
        with pt.unique_name.guard(), pt.program_guard(main, startup):
            with pt.initializer.init_on_cpu():
                assert pt.initializer.force_init_on_cpu()
                pt.layers.create_parameter(
                    shape=[50, 40], dtype='float32', name='u',
                    default_initializer=pt.initializer.Uniform(-2.0, 1.0))
                pt.layers.create_parameter(
                    shape=[50, 40], dtype='float32', name='n',
                    default_initializer=pt.initializer.Normal(1.0, 3.0,
                                                              seed=9))
            pt.layers.create_parameter(
                shape=[50, 40], dtype='float32', name='d',
                default_initializer=pt.initializer.Uniform())
        return startup
    assert not pt.initializer.force_init_on_cpu()
    startup = build()
    flags = {op.outputs['Out'][0]: op.attrs.get('force_cpu', False)
             for op in startup.global_block().ops}
    assert flags == {'u': True, 'n': True, 'd': False}
    vals = []
    for device_seed in (5, 123):
        scope = pt.Scope()
        gen = torch.Generator()
        gen.manual_seed(device_seed)
        scope.set_var(RNG_KEY, gen)
        pt.Executor(pt.CPUPlace()).run(startup, scope=scope)
        vals.append({n: pt.fetch_var(n, scope) for n in 'und'})
    np.testing.assert_array_equal(vals[0]['u'], vals[1]['u'])
    np.testing.assert_array_equal(vals[0]['n'], vals[1]['n'])
    assert not np.array_equal(vals[0]['d'], vals[1]['d'])
    host = torch.Generator()
    host.manual_seed(5)
    want_u = torch.rand([50, 40], generator=host) * 3.0 - 2.0
    np.testing.assert_array_equal(vals[0]['u'], want_u.numpy())
    host.manual_seed(9)
    want_n = torch.randn([50, 40], generator=host) * 3.0 + 1.0
    np.testing.assert_array_equal(vals[0]['n'], want_n.numpy())


def _random_layers(pkg):
    main, startup = pkg.Program(), pkg.Program()
    main.random_seed = 3
    with pkg.unique_name.guard(), pkg.program_guard(main, startup):
        L = pkg.layers
        x = L.data(name='x', shape=[7], dtype='float32')
        outs = [L.uniform_random([300, 200], min=-2.0, max=3.0),
                L.gaussian_random([300, 200], mean=1.0, std=0.5),
                L.uniform_random_batch_size_like(
                    input=x, shape=[-1, 5000], min=0.0, max=1.0),
                L.gaussian_random_batch_size_like(
                    input=x, shape=[-1, 5000], mean=-1.0, std=2.0)]
        trunc = main.global_block().create_var(name='trunc', shape=[400, 400],
                                               dtype='float32')
        main.global_block().append_op(
            type='truncated_gaussian_random', outputs={'Out': trunc},
            attrs={'shape': [400, 400], 'dtype': 'float32', 'mean': 2.0,
                   'std': 0.5, 'seed': 0})
    return main, outs + [trunc]


def test_random_layers_match_jax_in_law():
    j_main, j_outs = _random_layers(fluid)
    t_main, t_outs = _random_layers(pt)
    assert [_op_desc(op) for op in t_main.global_block().ops] == \
        [_op_desc(op) for op in j_main.global_block().ops]
    feed = {'x': np.zeros((30, 7), 'float32')}
    got = pt.Executor(pt.CPUPlace()).run(
        t_main, feed=feed, fetch_list=t_outs, scope=pt.Scope())
    want = fluid.Executor(fluid.CPUPlace()).run(
        j_main, feed=feed, fetch_list=j_outs, scope=fluid.Scope())
    for t, j in zip(got, want):
        assert t.shape == np.asarray(j).shape
    u, g, ub, gb, tr = got
    assert u.shape == (300, 200) and ub.shape == gb.shape == (30, 5000)
    assert u.min() >= -2.0 and u.max() < 3.0 and ub.min() >= 0.0
    for v, mean, std in ((u, 0.5, 5 / math.sqrt(12)), (g, 1.0, 0.5),
                         (ub, 0.5, 1 / math.sqrt(12)), (gb, -1.0, 2.0)):
        assert abs(v.mean() - mean) < 0.02 * std
        np.testing.assert_allclose(v.std(), std, rtol=0.02)
    # truncated at two standard deviations: the std of N(0, 1) truncated
    # to [-2, 2] is 0.8796; JAX's draw by the same law
    for v in (tr, np.asarray(want[-1])):
        assert v.min() >= 2.0 - 2 * 0.5 and v.max() <= 2.0 + 2 * 0.5
        assert abs(v.mean() - 2.0) < 0.01
        np.testing.assert_allclose(v.std(), 0.5 * 0.8796, rtol=0.02)


def _weight_norm_fc(pkg, dim, opt=True):
    main, startup = pkg.Program(), pkg.Program()
    startup.random_seed = 42
    with pkg.unique_name.guard(), pkg.program_guard(main, startup):
        x = pkg.layers.data(name='x', shape=[10], dtype='float32')
        out = pkg.layers.fc(
            input=x, size=5, bias_attr=False,
            param_attr=pkg.WeightNormParamAttr(
                dim=dim, name='wn',
                initializer=pkg.initializer.Uniform(-1.0, 1.0)))
        loss = pkg.layers.mean(pkg.layers.square(out))
        if opt:
            pkg.optimizer.SGD(learning_rate=0.5).minimize(loss)
    return main, startup, loss


def _norm_except(v, dim):
    axes = tuple(i for i in range(v.ndim) if i != dim) if dim is not None \
        else None
    return np.sqrt(np.sum(v * v, axis=axes, keepdims=True))


@pytest.mark.parametrize('dim', [None, 0, 1])
def test_weight_norm_g_is_the_norm_of_v(dim):
    main, startup, _ = _weight_norm_fc(pt, dim, opt=False)
    scope = pt.Scope()
    pt.Executor(pt.CPUPlace()).run(startup, scope=scope)
    g, v = pt.fetch_var('wn_g', scope), pt.fetch_var('wn_v', scope)
    assert v.shape == (10, 5)
    np.testing.assert_allclose(g, _norm_except(v, dim).reshape(g.shape),
                               rtol=1e-6)
    assert g.shape == ((1, 1) if dim is None else
                       (10, 1) if dim == 0 else (1, 5))
    names = [p.name for p in main.global_block().all_parameters()]
    assert sorted(names) == ['wn_g', 'wn_v']


@pytest.mark.parametrize('dim', [None, 1])
def test_weight_norm_training_matches_jax(dim):
    rng = np.random.RandomState(1)
    v = rng.uniform(-1, 1, (10, 5)).astype('float32')
    state = {'wn_v': v,
             'wn_g': (_norm_except(v, dim) * 1.3).astype('float32')}
    feeds = [{'x': rng.randn(4, 10).astype('float32')} for _ in range(3)]
    res = {}
    for pkg in (fluid, pt):
        main, startup, loss = _weight_norm_fc(pkg, dim)
        scope = pkg.Scope()
        exe = pkg.Executor(pkg.CPUPlace())
        exe.run(startup, scope=scope)
        if pkg is pt:
            pt_io.params_from_numpy(scope, state, pt.CPUPlace())
        else:
            for n, a in state.items():
                scope.set_var(n, a)
        losses = [np.asarray(exe.run(main, feed=f, fetch_list=[loss],
                                     scope=scope)[0]) for f in feeds]
        res[pkg] = losses + [np.asarray(pkg.fetch_var(n, scope))
                             for n in ('wn_g', 'wn_v')]
    for j, t in zip(res[fluid], res[pt]):
        np.testing.assert_allclose(t, j, **TOL)
    assert not np.allclose(res[pt][-1], v)          # v trained
