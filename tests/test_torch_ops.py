"""Each op type of the port against paddle_tpu, one op at a time.

For every case a small Program is built twice, with paddle_tpu's layers
and with paddle_tpu_torch's, under fresh unique-name generators, so both
programs name their variables alike. Both scopes get the same numpy
parameters and both Executors the same numpy feeds; the fetches must
agree to atol = rtol = 1e-5 (f32 on the CPU, AMP off on both sides), and
the two programs must hold the same ops with the same attrs.
"""
import numpy as np
import pytest

import jax.numpy as jnp

import paddle_tpu.fluid as fluid
from paddle_tpu.core import lowering as jax_lowering
import paddle_tpu_torch as pt
from paddle_tpu_torch import io as pt_io
from paddle_tpu_torch.core import lowering as pt_lowering

TOL = dict(atol=1e-5, rtol=1e-5)


def _build(pkg, build):
    main, startup = pkg.Program(), pkg.Program()
    with pkg.unique_name.guard(), pkg.program_guard(main, startup):
        outs = build(pkg.layers)
    return main, outs if isinstance(outs, (list, tuple)) else [outs]


def _ops(program):
    return [(op.type, sorted(op.inputs.items()), sorted(op.outputs.items()),
             sorted(op.attrs.items())) for op in program.global_block().ops]


def run_both(build, feeds, seed=0):
    """Build with both packages, run both, return (jax, torch) fetches."""
    j_main, j_outs = _build(fluid, build)
    t_main, t_outs = _build(pt, build)
    assert _ops(t_main) == _ops(j_main)
    rng = np.random.RandomState(seed)
    params = {p.name: rng.uniform(0.5, 1.5, p.shape).astype('float32')
              for p in j_main.global_block().all_parameters()}

    j_scope = fluid.Scope()
    for n, a in params.items():
        j_scope.set_var(n, jnp.asarray(a))
    j_res = fluid.Executor(fluid.CPUPlace()).run(
        j_main, feed=feeds, fetch_list=j_outs, scope=j_scope)

    t_scope = pt.Scope()
    pt_io.params_from_numpy(t_scope, params, pt.CPUPlace())
    t_res = pt.Executor(pt.CPUPlace()).run(
        t_main, feed=feeds, fetch_list=t_outs, scope=t_scope)
    assert len(j_res) == len(t_res)
    return [np.asarray(r) for r in j_res], t_res


def _randn(*shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype('float32')


def _mul(L):
    x = L.data(name='x', shape=[4, 5], dtype='float32')
    y = L.data(name='y', shape=[5, 6], dtype='float32',
               append_batch_size=False)
    return L.mul(x=x, y=y, x_num_col_dims=2, y_num_col_dims=1)


def _fc_relu(L):
    x = L.data(name='x', shape=[4, 5], dtype='float32')
    return L.fc(input=x, size=6, num_flatten_dims=2, act='relu')


def _add_axis(L):
    x = L.data(name='x', shape=[3, 4, 5], dtype='float32')
    y = L.data(name='y', shape=[3, 4], dtype='float32',
               append_batch_size=False)
    return L.elementwise_add(x, y, axis=1)


def _layer_norm(L):
    x = L.data(name='x', shape=[6, 8], dtype='float32')
    return L.layer_norm(x, begin_norm_axis=2)


def _lookup(L):
    ids = L.data(name='ids', shape=[7], dtype='int64')
    return L.embedding(input=ids, size=[10, 4], padding_idx=3)


def _relu(L):
    return L.relu(L.data(name='x', shape=[4, 5], dtype='float32'))


def _concat_split(L):
    a = L.data(name='a', shape=[2, 3], dtype='float32')
    b = L.data(name='b', shape=[5, 3], dtype='float32')
    cat = L.concat([a, b], axis=1)
    return [cat] + L.split(cat, [4, 3], dim=1)


def _xent_mean(L):
    logits = L.data(name='x', shape=[6, 9], dtype='float32')
    label = L.data(name='label', shape=[6, 1], dtype='int64')
    loss = L.softmax_with_cross_entropy(logits=logits, label=label)
    return [loss, L.mean(x=loss)]


def _softmax(L):
    return L.softmax(L.data(name='x', shape=[6, 9], dtype='float32'))


def _reshape_scale(L):
    x = L.data(name='x', shape=[4, 5], dtype='float32')
    r = L.reshape(x, [0, -1])
    return [r, L.scale(r, scale=2.0, bias=0.5)]


def _flash(L):
    q, k, v = (L.data(name=n, shape=[32, 16], dtype='float32')
               for n in ('q', 'k', 'v'))
    return L.flash_attention(q, k, v, num_heads=2, causal=True)


def _fill(L):
    return L.fill_constant(shape=[2, 3], dtype='float32', value=1.5)


def _sum_sign_sqrt_pow(L):
    a = L.data(name='a', shape=[3, 4], dtype='float32')
    b = L.data(name='b', shape=[3, 4], dtype='float32')
    return [L.sums([a, b]), L.sums([a, b, a]), L.sign(a),
            L.sqrt(L.pow(a, factor=2.0)), L.pow(b, factor=3.0)]


def _clips(L):
    x = L.data(name='x', shape=[4, 5], dtype='float32')
    return [L.clip(x, min=-0.3, max=0.5), L.clip_by_norm(x, max_norm=1.0),
            L.clip_by_norm(x, max_norm=100.0)]


def _reduce_sum(L):
    x = L.data(name='x', shape=[3, 4], dtype='float32')
    return [L.reduce_sum(x), L.reduce_sum(x, dim=1),
            L.reduce_sum(x, dim=[0, 2], keep_dim=True)]


def _elementwise_max(L):
    x = L.data(name='x', shape=[3, 4], dtype='float32')
    y = L.data(name='y', shape=[4], dtype='float32',
               append_batch_size=False)
    return [L.elementwise_max(x, y), L.elementwise_max(x=y, y=y)]


_IDS = np.array([[0, 3, 9, -2, 15, 3, 5], [1, 2, 3, 4, 10, -1, 8]],
                dtype='int64')
CASES = {
    'mul_num_flatten_dims_2': (_mul, {'x': _randn(2, 4, 5),
                                      'y': _randn(5, 6, seed=1)}),
    'fc_bias_axis_relu': (_fc_relu, {'x': _randn(2, 4, 5)}),
    'elementwise_add_axis_1': (_add_axis, {'x': _randn(2, 3, 4, 5),
                                           'y': _randn(3, 4, seed=1)}),
    'layer_norm_begin_axis_2': (_layer_norm, {'x': 3 * _randn(2, 6, 8) + 1}),
    'lookup_table_clip_and_padding': (_lookup, {'ids': _IDS}),
    'relu': (_relu, {'x': _randn(2, 4, 5)}),
    'concat_split': (_concat_split, {'a': _randn(2, 2, 3),
                                     'b': _randn(2, 5, 3, seed=1)}),
    'softmax_with_cross_entropy_mean': (_xent_mean, {
        'x': _randn(2, 6, 9),
        'label': np.random.RandomState(2).randint(0, 9, (2, 6, 1))}),
    'softmax': (_softmax, {'x': 4 * _randn(2, 6, 9)}),
    'reshape_scale': (_reshape_scale, {'x': _randn(2, 4, 5)}),
    'flash_attention_op': (_flash, {n: _randn(2, 32, 16, seed=i)
                                    for i, n in enumerate('qkv')}),
    'fill_constant': (_fill, {}),
    'sum_sign_sqrt_pow': (_sum_sign_sqrt_pow, {'a': _randn(2, 3, 4),
                                               'b': _randn(2, 3, 4, seed=1)}),
    'clip_and_clip_by_norm': (_clips, {'x': _randn(2, 4, 5)}),
    'reduce_sum': (_reduce_sum, {'x': _randn(2, 3, 4)}),
    'elementwise_max': (_elementwise_max, {'x': _randn(2, 3, 4),
                                           'y': _randn(4, seed=1)}),
}


@pytest.mark.parametrize('case', sorted(CASES))
def test_op_matches_jax(case):
    build, feeds = CASES[case]
    j_res, t_res = run_both(build, feeds)
    for j, t in zip(j_res, t_res):
        assert t.shape == j.shape
        np.testing.assert_allclose(t, j, **TOL)


def test_lookup_table_padding_rows_are_zero():
    _, t_res = run_both(_lookup, {'ids': _IDS})
    assert np.all(t_res[0][_IDS == 3] == 0)


def _qkv_fc(L):
    x = L.data(name='x', shape=[4, 8], dtype='float32')
    return [L.fc(input=x, size=8, num_flatten_dims=2, bias_attr=False)
            for _ in range(3)]


def test_merge_shared_muls_matches_jax():
    """The q/k/v fusion rewrite (off by default in both packages) gives
    the same op sequence and the same values in both."""
    t_main, _ = _build(pt, _qkv_fc)
    j_main, _ = _build(fluid, _qkv_fc)
    t_ops = pt_lowering._merge_shared_muls(t_main.global_block(),
                                           t_main.global_block().ops)
    j_ops = jax_lowering._merge_shared_muls(j_main.global_block(),
                                            j_main.global_block().ops)
    assert [o.type for o in t_ops] == ['concat', 'mul', 'split']
    assert [(o.type, o.inputs, o.outputs, o.attrs) for o in t_ops] == \
        [(o.type, o.inputs, o.outputs, o.attrs) for o in j_ops]
    prev = (jax_lowering.MERGE_SHARED_MULS[0],
            pt_lowering.MERGE_SHARED_MULS[0])
    jax_lowering.MERGE_SHARED_MULS[0] = pt_lowering.MERGE_SHARED_MULS[0] = \
        True
    try:
        j_res, t_res = run_both(_qkv_fc, {'x': _randn(2, 4, 8)})
    finally:
        jax_lowering.MERGE_SHARED_MULS[0], \
            pt_lowering.MERGE_SHARED_MULS[0] = prev
    for j, t in zip(j_res, t_res):
        np.testing.assert_allclose(t, j, **TOL)


def _random_init(L):
    x = L.data(name='x', shape=[64], dtype='float32')
    normal = pt.ParamAttr(initializer=pt.initializer.Xavier(uniform=False))
    return [L.fc(input=x, size=256, bias_attr=False),
            L.fc(input=x, size=512, bias_attr=False, param_attr=normal)]


def test_startup_initializers_are_seeded_and_in_range():
    """Random init ops (uniform_random, gaussian_random) draw from a
    torch.Generator seeded with program.random_seed: the same seed gives
    the same parameters, another seed others; Xavier-uniform values stay
    within their limit and Xavier-normal ones have their std."""
    def init(seed):
        main, startup = pt.Program(), pt.Program()
        startup.random_seed = seed
        with pt.unique_name.guard(), pt.program_guard(main, startup):
            _random_init(pt.layers)
        scope = pt.Scope()
        pt.Executor(pt.CPUPlace()).run(startup, scope=scope)
        return scope.raw('fc_0.w_0').numpy(), scope.raw('fc_1.w_0').numpy()

    (a, na), (b, nb), (c, nc) = init(7), init(7), init(8)
    limit = np.sqrt(6.0 / (64 + 256))
    assert a.shape == (64, 256) and na.shape == (64, 512)
    np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(na, nb)
    assert not np.array_equal(a, c) and not np.array_equal(na, nc)
    assert np.abs(a).max() <= limit and np.abs(a).max() > 0.9 * limit
    std = np.sqrt(2.0 / (64 + 512))
    assert abs(na.std() / std - 1) < 0.02 and abs(na.mean()) < 0.05 * std


@pytest.mark.parametrize('soft_label', [False, True])
def test_cross_entropy_matches_jax(soft_label):
    """cross_entropy on softmax probabilities: hard int64 labels [N, 1],
    or soft labels (rows summing to 1); -log(p + 1e-8) in f32. Some
    probabilities are tiny, so the 1e-8 floor shows."""
    def build(L):
        x = L.data(name='x', shape=[6], dtype='float32')
        label = L.data(name='label', shape=[6] if soft_label else [1],
                       dtype='float32' if soft_label else 'int64')
        return L.cross_entropy(L.softmax(x), label, soft_label=soft_label)

    rng = np.random.RandomState(3)
    x = (rng.randn(5, 6) * 8).astype('float32')
    if soft_label:
        label = rng.rand(5, 6).astype('float32')
        label /= label.sum(1, keepdims=True)
    else:
        label = rng.randint(0, 6, (5, 1)).astype('int64')
    (j,), (t,) = run_both(build, {'x': x, 'label': label})
    assert t.shape == (5, 1) and np.isfinite(t).all()
    np.testing.assert_allclose(t, j, rtol=1e-6, atol=1e-6)


def test_set_amp_forces_bf16_products_like_jax():
    """``set_amp(True)`` turns AMP on for CPU tensors too, as the JAX
    package's ``set_amp`` does off the TPU: a mul takes bf16 operands in
    both packages (so it departs from the f32 product by bf16 rounding),
    and ``set_amp(None)`` goes back to the device's policy."""
    from paddle_tpu.core import amp as jax_amp
    from paddle_tpu_torch.core import amp as pt_amp
    feeds = {'x': _randn(3, 4, 5), 'y': _randn(5, 6, seed=1)}
    exact = np.einsum('bij,jk->bik', feeds['x'], feeds['y'])
    jax_amp.set_amp(True)
    pt_amp.set_amp(True)
    try:
        assert pt_amp.amp_enabled('cpu')
        (j,), (t,) = run_both(_mul, feeds)
    finally:
        jax_amp.set_amp(None)
        pt_amp.set_amp(None)
    assert not pt_amp.amp_enabled('cpu') and pt_amp.amp_enabled('cuda')
    np.testing.assert_allclose(t, j, rtol=1e-2, atol=1e-2)
    assert np.abs(t - exact).max() > 1e-4
