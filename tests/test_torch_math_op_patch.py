"""The port's operators on Variable against paddle_tpu's.

Every operator (``+ - * / **``, reflected too, ``__div__`` /
``__rdiv__`` called by name, the six comparisons, unary minus and
``astype``) with a Variable, an int and a float operand, on a Variable
with a batch dimension (the scalar becomes a
``fill_constant_batch_size_like``) and on one without (a
``fill_constant`` of shape [1]). Both packages build the same program
under fresh unique-name generators (the same ops, attrs and names) and
run it on the CPU on one seeded feed: floats to 1e-6 relative, the
comparisons and casts equal in value. Variables hash by identity and
``==`` between them builds an op instead of comparing.
"""
import operator

import numpy as np
import pytest

import paddle_tpu.fluid as fluid
import paddle_tpu_torch as pt

BINARY = {
    'add': operator.add, 'sub': operator.sub, 'mul': operator.mul,
    'truediv': operator.truediv, 'pow': operator.pow,
    'div': lambda a, b: a.__div__(b),
    'eq': operator.eq, 'ne': operator.ne, 'lt': operator.lt,
    'le': operator.le, 'gt': operator.gt, 'ge': operator.ge,
}
REFLECTED = {
    'radd': lambda a, s: s + a, 'rsub': lambda a, s: s - a,
    'rmul': lambda a, s: s * a, 'rtruediv': lambda a, s: s / a,
    'rpow': lambda a, s: s ** a, 'rdiv': lambda a, s: a.__rdiv__(s),
}


def _feeds(batch):
    rng = np.random.RandomState(0)
    shape = (4, 3) if batch else (3,)
    a = rng.uniform(0.5, 2.0, shape).astype('float32')
    b = rng.uniform(0.5, 2.0, shape).astype('float32')
    b.flat[::2] = a.flat[::2]                  # ties for the comparisons
    return {'a': a, 'b': b}


def _build(pkg, batch, make):
    main, startup = pkg.Program(), pkg.Program()
    with pkg.unique_name.guard(), pkg.program_guard(main, startup):
        kw = {} if batch else {'append_batch_size': False}
        a = pkg.layers.data(name='a', shape=[3], dtype='float32', **kw)
        b = pkg.layers.data(name='b', shape=[3], dtype='float32', **kw)
        outs = make(a, b)
    return main, outs


def _run_both(batch, make):
    got = {}
    for pkg in (fluid, pt):
        main, outs = _build(pkg, batch, make)
        got[pkg] = (main, [np.asarray(v) for v in pkg.Executor(
            pkg.CPUPlace()).run(main, feed=_feeds(batch), fetch_list=outs,
                                scope=pkg.Scope())])
    (j_main, want), (t_main, res) = got[fluid], got[pt]

    def ops(p):
        return [(op.type, sorted(op.inputs.items()),
                 sorted(op.outputs.items()), sorted(op.attrs.items()))
                for op in p.global_block().ops]
    assert ops(t_main) == ops(j_main)
    return want, res


def _same(want, got, label):
    assert got.shape == want.shape, label
    if want.dtype.kind == 'f' and got.dtype.kind == 'f':
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7,
                                   err_msg=label)
    else:
        np.testing.assert_array_equal(got.astype(want.dtype), want,
                                      err_msg=label)


@pytest.mark.parametrize('batch', [True, False], ids=['batch', 'no_batch'])
@pytest.mark.parametrize('name', sorted(BINARY))
def test_binary_operator_matches_jax(name, batch):
    fn = BINARY[name]
    want, got = _run_both(batch, lambda a, b: [fn(a, b), fn(a, 2), fn(a, 1.5)])
    for i, (j, t) in enumerate(zip(want, got)):
        _same(j, t, '%s operand %d' % (name, i))


@pytest.mark.parametrize('batch', [True, False], ids=['batch', 'no_batch'])
@pytest.mark.parametrize('name', sorted(REFLECTED))
def test_reflected_operator_matches_jax(name, batch):
    fn = REFLECTED[name]
    want, got = _run_both(batch, lambda a, b: [fn(a, 3), fn(a, 0.5)])
    for i, (j, t) in enumerate(zip(want, got)):
        _same(j, t, '%s operand %d' % (name, i))


def test_values_against_numpy():
    feeds = _feeds(True)
    a_np, b_np = feeds['a'], feeds['b']
    _, got = _run_both(True, lambda a, b: [
        a + 10, 10 - a, a / b, 2.0 ** a, a ** 2, -a, a < b, a >= b,
        a == b, a != b, (a * 3).astype('int64'), a.astype('float64')])
    want = [a_np + 10, 10 - a_np, a_np / b_np, 2.0 ** a_np, a_np ** 2,
            -a_np, a_np < b_np, a_np >= b_np, a_np == b_np, a_np != b_np,
            (a_np * 3).astype('int64'), a_np]
    for i, (w, g) in enumerate(zip(want, got)):
        if w.dtype == bool:
            np.testing.assert_array_equal(g.astype(bool), w, err_msg=str(i))
        elif w.dtype.kind == 'i':
            assert g.dtype == np.int64
            np.testing.assert_array_equal(g, w, err_msg=str(i))
        else:
            np.testing.assert_allclose(g, w, rtol=1e-6, err_msg=str(i))


def test_neg_and_astype_match_jax():
    want, got = _run_both(False, lambda a, b: [
        -a, -(a - b), a.astype('int32'), (a > b).astype('float32')])
    for i, (j, t) in enumerate(zip(want, got)):
        _same(j, t, str(i))


def test_scalar_operands_make_constants_without_gradient():
    main, _ = _build(pt, True, lambda a, b: [a + 1])
    const = [op for op in main.global_block().ops
             if op.type == 'fill_constant_batch_size_like']
    assert len(const) == 1
    assert main.global_block().var(const[0].outputs['Out'][0]).stop_gradient
    main, _ = _build(pt, False, lambda a, b: [a * 2])
    assert [op.type for op in main.global_block().ops] == \
        ['fill_constant', 'elementwise_mul']


def test_variables_hash_by_identity():
    main, startup = pt.Program(), pt.Program()
    with pt.program_guard(main, startup):
        a = pt.layers.data(name='a', shape=[1])
        b = pt.layers.data(name='b', shape=[1])
        n_ops = len(main.global_block().ops)
        assert len({a, b}) == 2 and {a: 1, b: 2}[b] == 2
        assert len(main.global_block().ops) == n_ops
        eq = a == b
        assert isinstance(eq, pt.Variable)
        assert main.global_block().ops[-1].type == 'equal'
        assert (a == 'a') is False and (a != None) is True  # noqa: E711
