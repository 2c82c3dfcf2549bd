"""The port's control flow and tensor arrays against paddle_tpu's.

The cases of tests/test_control_flow.py, tests/test_lod_tensor_array_ops.py,
tests/test_dynrnn_gradient_check.py and tests/test_mnist_if_else_op.py,
each program built by both packages' layers under fresh unique-name
generators, with the same numpy parameters and feeds, on the CPU with
the compilers off (the ops themselves are compared):

- forward fetches within 1e-5 of their scale per op, integers and
  bools equal in value (the JAX package runs int64 as int32);
- training cases: the loss and every ``<param>@GRAD`` within 1e-5 per
  op and 1e-4 for a model (IfElse and the raw conditional-block net of
  the mnist book, three Momentum steps);
- a While carries the names its body rewrites and keeps the body's
  fresh names inside; a gradient through a While is refused by both
  packages with a ValueError; a random op in a loop body advances the
  scope's generator once an iteration, in program order.
"""
import numpy as np
import pytest
import torch

import paddle_tpu.fluid as fluid
import paddle_tpu.compiler as jax_compiler
import paddle_tpu_torch as pt
from paddle_tpu_torch import io as pt_io
from paddle_tpu_torch.ops import common as t_common

OP_TOL = 1e-5
MODEL_TOL = 1e-4


def _close(name, got, want, tol=OP_TOL):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (name, got.shape, want.shape)
    if want.dtype.kind in 'biu' or got.dtype.kind in 'biu':
        np.testing.assert_array_equal(got, want, err_msg=name)
        return
    scale = max(float(np.abs(want).max()), 1e-4) if want.size else 1.0
    err = float(np.abs(got.astype(np.float64) - want).max()) / scale \
        if want.size else 0.0
    assert err <= tol, '%s: %.3g of max |ref| %.3g' % (name, err, scale)


def _compare(name, got, want, tol=OP_TOL):
    """A fetched sequence within its lengths (the JAX package's buffers
    may be padded further), a dense value whole."""
    if isinstance(want, fluid.LoDTensor) and want.lengths is not None:
        assert isinstance(got, pt.SequenceTensor), name
        assert got.recursive_sequence_lengths() == \
            want.recursive_sequence_lengths(), name
        _close(name, got.to_dense_rows(), want.to_dense_rows(), tol)
    else:
        _close(name, got, want, tol)


def run_pair(build, feed=None, train=None, steps=1, seed=3, tol=OP_TOL,
             init=None):
    """Build ``build(pkg) -> (fetches, loss or None)`` with both
    packages; ``train(pkg)`` returns the optimizer minimizing the loss.
    The JAX package's startup runs, then every parameter is redrawn from
    ``seed`` (or taken from ``init``) into both scopes. Runs ``steps``
    steps and compares every fetch, the loss and every gradient at each.
    Returns both packages' last results."""
    feed = feed or (lambda pkg: {})
    res, names, params = [], None, None
    for pkg in (fluid, pt):
        main, startup = pkg.Program(), pkg.Program()
        with pkg.unique_name.guard(), pkg.program_guard(main, startup):
            fetch, loss = build(pkg)
            if train is not None:
                train(pkg).minimize(loss)
        grads = sorted(v.name for v in main.list_vars()
                       if v.name.endswith('@GRAD'))
        fetch_list = list(fetch) + ([loss] + grads if train else [])
        if pkg is fluid:
            scope = fluid.Scope()
            exe = fluid.Executor(fluid.CPUPlace())
            exe.run(startup, scope=scope)
            rng = np.random.RandomState(seed)
            params = {}
            for v in startup.list_vars():
                val = scope.raw(v.name)
                if val is None:
                    continue
                shape = np.asarray(val).shape
                if init is not None and v.name in init:
                    params[v.name] = init[v.name]
                elif main.global_block().vars.get(v.name) is not None and \
                        type(main.global_block().vars[v.name]).__name__ \
                        == 'Parameter':
                    params[v.name] = (0.5 * rng.randn(*shape)) \
                        .astype('float32')
                else:
                    params[v.name] = np.asarray(val)
                scope.set_var(v.name, params[v.name])
            names = [v.name if hasattr(v, 'name') else v for v in fetch_list]
        else:
            scope = pt.Scope()
            exe = pt.Executor(pt.CPUPlace())
            pt_io.params_from_numpy(scope, params, pt.CPUPlace())
        out = []
        for _ in range(steps):
            if pkg is fluid:
                with jax_compiler.disabled():
                    out.append(exe.run(main, feed=feed(pkg),
                                       fetch_list=fetch_list, scope=scope,
                                       return_numpy=False))
            else:
                with pt.compiler.disabled():
                    out.append(exe.run(main, feed=feed(pkg),
                                       fetch_list=fetch_list, scope=scope,
                                       return_numpy=False))
        res.append(out)
    for step, (want_s, got_s) in enumerate(zip(*res)):
        for name, want, got in zip(names, want_s, got_s):
            _compare('step %d %s' % (step, name), pt.executor.as_numpy(got)
                     if not isinstance(got, np.ndarray) else got,
                     _np(want), tol)
    return res[0][-1], res[1][-1]


def _np(v):
    if isinstance(v, fluid.LoDTensor):
        return v
    return np.asarray(v)


def _lod(pkg, rows, lens):
    return pkg.create_lod_tensor(rows, lens if isinstance(lens[0], list)
                                 else [lens])


# ---- While and tensor arrays ----------------------------------------------------
def _while_sum_of_squares(pkg):
    L = pkg.layers
    i = L.fill_constant(shape=[1], dtype='float32', value=0)
    limit = L.fill_constant(shape=[1], dtype='float32', value=10)
    acc = L.fill_constant(shape=[1], dtype='float32', value=0)
    cond = L.less_than(x=i, y=limit)
    w = L.While(cond=cond)
    with w.block():
        sq = L.elementwise_mul(i, i)
        L.assign(L.elementwise_add(acc, sq), acc)
        L.increment(x=i, value=1.0, in_place=True)
        L.less_than(x=i, y=limit, cond=cond)
    return [acc, i], None


def test_while_sum_of_squares():
    j, t = run_pair(_while_sum_of_squares)
    assert float(np.asarray(pt.executor.as_numpy(t[0]))[0]) == 285.0


def _while_array(pkg):
    L = pkg.layers
    i = L.fill_constant(shape=[1], dtype='int32', value=0)
    limit = L.fill_constant(shape=[1], dtype='int32', value=5)
    x = L.fill_constant(shape=[3], dtype='float32', value=1)
    arr = L.array_write(x, i)
    cond = L.less_than(x=i, y=limit)
    w = L.While(cond=cond)
    with w.block():
        prev = L.array_read(arr, i)
        nxt = L.scale(prev, scale=2.0)
        L.increment(x=i, value=1.0, in_place=True)
        L.array_write(nxt, i, array=arr)
        L.less_than(x=i, y=limit, cond=cond)
    return [L.array_read(arr, i), L.array_length(arr)], None


def test_while_with_array_write_read():
    j, t = run_pair(_while_array)
    _close('last', pt.executor.as_numpy(t[0]), np.full(3, 32.0))
    assert int(pt.executor.as_numpy(t[1])[0]) == 6


def _while_feed_array(pkg):
    L = pkg.layers
    x = L.data(name='x', shape=[4], dtype='float32')
    i = L.zeros(shape=[1], dtype='int64')
    n = L.fill_constant(shape=[1], dtype='int64', value=3)
    arr = L.create_array('float32')
    L.array_write(x, array=arr, i=i)
    cond = L.less_than(x=i, y=n)
    w = L.While(cond=cond)
    with w.block():
        v = L.array_read(array=arr, i=i)
        L.increment(x=i, value=1, in_place=True)
        L.array_write(L.scale(v, scale=2.0), array=arr, i=i)
        L.less_than(x=i, y=n, cond=cond)
    # past the last write: the fixed buffer's zeros in both packages
    past = L.fill_constant(shape=[1], dtype='int64', value=7)
    return [L.array_read(array=arr, i=n), L.array_read(array=arr, i=past)], \
        None


def test_while_reads_a_feed_through_an_array():
    xs = np.random.RandomState(0).randn(2, 4).astype('float32')
    j, t = run_pair(_while_feed_array, feed=lambda pkg: {'x': xs})
    _close('x8', pt.executor.as_numpy(t[0]), xs * 8.0)
    _close('past', pt.executor.as_numpy(t[1]), np.zeros_like(xs))


def _array_ops(pkg):
    L = pkg.layers
    x0 = L.fill_constant(shape=[2], dtype='float32', value=3)
    x1 = L.fill_constant(shape=[2], dtype='float32', value=7)
    i0 = L.fill_constant(shape=[1], dtype='int32', value=0)
    i1 = L.fill_constant(shape=[1], dtype='int32', value=1)
    arr = L.array_write(x0, i0)
    L.array_write(x1, i1, array=arr)
    return [L.array_read(arr, i0), L.array_read(arr, i1),
            L.array_length(arr)], None


def test_array_ops_outside_loop():
    j, t = run_pair(_array_ops)
    assert int(pt.executor.as_numpy(t[2])[0]) == 2


def test_while_keeps_fresh_names_inside_and_carries_the_rest():
    main, startup = pt.Program(), pt.Program()
    with pt.program_guard(main, startup):
        L = pt.layers
        i = L.fill_constant(shape=[1], dtype='int64', value=0)
        n = L.fill_constant(shape=[1], dtype='int64', value=2)
        acc = L.fill_constant(shape=[1], dtype='float32', value=1)
        cond = L.less_than(x=i, y=n)
        w = L.While(cond=cond)
        with w.block():
            fresh = L.scale(acc, scale=3.0)
            L.assign(fresh, acc)
            L.increment(x=i, value=1, in_place=True)
            L.less_than(x=i, y=n, cond=cond)
    exe = pt.Executor(pt.CPUPlace())
    out, = exe.run(main, fetch_list=[acc], scope=pt.Scope())
    assert float(out[0]) == 9.0
    with pytest.raises(KeyError):
        exe.run(main, fetch_list=[fresh], scope=pt.Scope())


def test_while_reads_the_device_only_for_a_condition_it_did_not_make():
    """The host makes no condition and no index: every test of a
    While's condition and every tensor-array index is one read of the
    device (``host_read``), whatever the counter's dtype."""
    main, startup = pt.Program(), pt.Program()
    with pt.program_guard(main, startup):
        out = _while_sum_of_squares(pt)[0][0]
    t_common.HOST_SYNCS[0] = 0
    pt.Executor(pt.CPUPlace()).run(main, fetch_list=[out], scope=pt.Scope())
    # the condition read 11 times: 10 iterations and the last test
    assert t_common.HOST_SYNCS[0] == 11
    main, startup = pt.Program(), pt.Program()
    with pt.program_guard(main, startup):
        outs = _while_array(pt)[0]
    t_common.HOST_SYNCS[0] = 0
    got = pt.Executor(pt.CPUPlace()).run(main, fetch_list=outs,
                                         scope=pt.Scope())
    # 5 iterations: 6 tests of the condition; 6 writes (one before the
    # loop) and 6 reads (one after it) of the array, one index each
    assert t_common.HOST_SYNCS[0] == 18
    np.testing.assert_array_equal(got[0], np.full(3, 32.0))


def test_while_iteration_guard(monkeypatch):
    from paddle_tpu_torch.ops import control_flow_ops as cf
    monkeypatch.setattr(cf, 'MAX_WHILE_ITERS', 5)
    main, startup = pt.Program(), pt.Program()
    with pt.program_guard(main, startup):
        L = pt.layers
        i = L.fill_constant(shape=[1], dtype='int64', value=0)
        n = L.fill_constant(shape=[1], dtype='int64', value=100)
        cond = L.less_than(x=i, y=n)
        with L.While(cond=cond).block():
            L.increment(x=i, value=1, in_place=True)
            L.less_than(x=i, y=n, cond=cond)
    with pytest.raises(RuntimeError, match='more than 5 iterations'):
        pt.Executor(pt.CPUPlace()).run(main, fetch_list=[i],
                                       scope=pt.Scope())


def _while_grad(pkg):
    L = pkg.layers
    x = L.data(name='x', shape=[4], dtype='float32')
    h = L.fc(input=x, size=4)
    i = L.fill_constant(shape=[1], dtype='int64', value=0)
    n = L.fill_constant(shape=[1], dtype='int64', value=3)
    cond = L.less_than(x=i, y=n)
    with L.While(cond=cond).block():
        L.assign(L.scale(h, scale=2.0), h)
        L.increment(x=i, value=1, in_place=True)
        L.less_than(x=i, y=n, cond=cond)
    loss = L.mean(h)
    pkg.optimizer.SGD(0.1).minimize(loss)
    return loss


def test_gradient_through_a_while_is_refused_by_both():
    """lax.while_loop has no reverse-mode derivative; the port refuses
    the same programs, with the same exception class."""
    xs = np.ones((2, 4), 'float32')
    for pkg in (fluid, pt):
        main, startup = pkg.Program(), pkg.Program()
        with pkg.unique_name.guard(), pkg.program_guard(main, startup):
            loss = _while_grad(pkg)
        exe = pkg.Executor(pkg.CPUPlace())
        scope = pkg.Scope()
        exe.run(startup, scope=scope)
        with pytest.raises(ValueError, match='[Rr]everse-mode'):
            exe.run(main, feed={'x': xs}, fetch_list=[loss], scope=scope)


def test_random_op_in_a_loop_advances_the_generator_in_order():
    main, startup = pt.Program(), pt.Program()
    with pt.program_guard(main, startup):
        L = pt.layers
        i = L.fill_constant(shape=[1], dtype='int64', value=0)
        n = L.fill_constant(shape=[1], dtype='int64', value=3)
        # written before the loop, so the loop carries it out
        arr = L.array_write(L.fill_constant(shape=[4], dtype='float32',
                                            value=0.0), i)
        cond = L.less_than(x=i, y=n)
        with L.While(cond=cond).block():
            blk = main.current_block()
            u = blk.create_var(name='u', shape=[4], dtype='float32')
            blk.append_op(type='uniform_random', outputs={'Out': [u]},
                          attrs={'shape': [4], 'min': 0.0, 'max': 1.0,
                                 'dtype': 'float32', 'seed': 0})
            L.array_write(u, i, array=arr)
            L.increment(x=i, value=1, in_place=True)
            L.less_than(x=i, y=n, cond=cond)
        reads = [L.array_read(arr, L.fill_constant(
            shape=[1], dtype='int64', value=k)) for k in range(3)]
    main.random_seed = 11
    got = pt.Executor(pt.CPUPlace()).run(main, fetch_list=reads,
                                         scope=pt.Scope())
    g = torch.Generator().manual_seed(11)
    want = [torch.rand(4, generator=g).numpy() for _ in range(3)]
    for k in range(3):
        np.testing.assert_array_equal(got[k], want[k])


# ---- Switch and IfElse ------------------------------------------------------------
@pytest.mark.parametrize('step_val,want', [(0.0, 0.1), (1.0, 0.01),
                                           (5.0, 0.001)])
def test_switch_piecewise(step_val, want):
    def build(pkg):
        L = pkg.layers
        step = L.fill_constant(shape=[1], dtype='float32', value=step_val)
        one = L.fill_constant(shape=[1], dtype='float32', value=1.0)
        two = L.fill_constant(shape=[1], dtype='float32', value=2.0)
        lr = L.create_global_var(shape=[1], value=0.0, dtype='float32',
                                 persistable=True, name='lr')
        with L.Switch() as switch:
            with switch.case(L.less_than(step, one)):
                L.assign(L.fill_constant(shape=[1], dtype='float32',
                                         value=0.1), lr)
            with switch.case(L.less_than(step, two)):
                L.assign(L.fill_constant(shape=[1], dtype='float32',
                                         value=0.01), lr)
            with switch.default():
                L.assign(L.fill_constant(shape=[1], dtype='float32',
                                         value=0.001), lr)
        return [lr], None
    j, t = run_pair(build)
    assert abs(float(pt.executor.as_numpy(t[0])[0]) - want) < 1e-7


def _ifelse(pkg, grad):
    L = pkg.layers
    x = L.data(name='x', shape=[3], dtype='float32')
    h = L.fc(input=x, size=3, bias_attr=False) if grad else x
    zero = L.fill_constant(shape=[1], dtype='float32', value=0.0)
    cond = L.less_than(x=zero, y=L.reduce_sum(h, dim=1, keep_dim=True))
    ie = L.IfElse(cond)
    with ie.true_block():
        # log of a negative row is NaN there: the select must keep it
        # out of the value and of the gradient
        ie.output(L.log(L.scale(ie.input(h), scale=2.0)))
    with ie.false_block():
        ie.output(L.scale(ie.input(h), scale=-1.0))
    out = ie()[0]
    return [out, cond], (L.mean(out) if grad else None)


@pytest.mark.parametrize('grad', [False, True], ids=['forward', 'grad'])
def test_ifelse_masked_merge(grad):
    xs = np.array([[1.0, 0.5, 2.0], [-2.0, 0.1, -1.0], [3.0, 1.0, 0.2],
                   [-4.0, -1.0, 0.3]], np.float32)
    init = {'fc_0.w_0': np.eye(3, dtype='float32')} if grad else None
    j, t = run_pair(lambda pkg: _ifelse(pkg, grad),
                    feed=lambda pkg: {'x': xs}, init=init,
                    train=(lambda pkg: pkg.optimizer.SGD(0.1)) if grad
                    else None)
    got = pt.executor.as_numpy(t[0])
    assert np.isfinite(got).all()
    if not grad:
        s = xs.sum(1, keepdims=True)
        _close('ifelse', got, np.where(s > 0, np.log(2 * xs), -xs))


def _cond_block_raw(pkg, conds):
    L = pkg.layers
    x = L.data(name='x', shape=[4], dtype='float32')
    out = L.fill_constant(shape=[1], dtype='float32', value=-1.0)
    c = L.less_than(L.fill_constant(shape=[1], dtype='float32', value=0.0),
                    L.reduce_sum(x))
    blk = L.ConditionalBlock([c] * conds, is_scalar_condition=True)
    with blk.block():
        L.assign(L.reduce_sum(L.square(x)), out)
        fresh = L.scale(x, scale=3.0)
    return [out, fresh], None


@pytest.mark.parametrize('sign', [1.0, -1.0], ids=['taken', 'not_taken'])
def test_conditional_block_blends_and_exports(sign):
    xs = sign * np.arange(1, 9, dtype=np.float32).reshape(2, 4)
    j, t = run_pair(lambda pkg: _cond_block_raw(pkg, 2),
                    feed=lambda pkg: {'x': xs})
    want = float((xs ** 2).sum()) if sign > 0 else -1.0
    assert float(pt.executor.as_numpy(t[0])[0]) == want


# ---- StaticRNN and DynamicRNN ----------------------------------------------------
def _static_rnn(pkg, grad):
    L = pkg.layers
    T, B, D = 4, 3, 2
    x = L.data(name='x', shape=[B, D], dtype='float32')
    rnn = L.StaticRNN()
    with rnn.step():
        x_t = rnn.step_input(x)
        mem = rnn.memory(shape=[-1, D], batch_ref=x, init_value=0.0)
        if grad:
            h = L.fc(input=[x_t, mem], size=D, act='tanh')
        else:
            h = L.elementwise_add(mem, x_t)
        rnn.update_memory(mem, h)
        rnn.step_output(h)
    out = rnn()
    return [out], (L.mean(out) if grad else None)


@pytest.mark.parametrize('grad', [False, True], ids=['cumsum', 'fc_grad'])
def test_static_rnn(grad):
    xs = np.random.RandomState(0).randn(4, 3, 2).astype('float32')
    j, t = run_pair(lambda pkg: _static_rnn(pkg, grad),
                    feed=lambda pkg: {'x': xs},
                    train=(lambda pkg: pkg.optimizer.SGD(0.1)) if grad
                    else None)
    if not grad:
        _close('cumsum', pt.executor.as_numpy(t[0]), np.cumsum(xs, 0))


def _dyn_rnn_cumsum(pkg):
    L = pkg.layers
    x = L.data(name='x', shape=[2], dtype='float32', lod_level=1)
    drnn = L.DynamicRNN()
    with drnn.block():
        x_t = drnn.step_input(x)
        mem = drnn.memory(shape=[2], value=0.0)
        acc = L.elementwise_add(mem, x_t)
        drnn.update_memory(mem, acc)
        drnn.output(acc)
    out = drnn()
    return [out, L.sequence_pool(out, pool_type='last')], None


def test_dynamic_rnn_masked_cumsum():
    lens = [3, 1, 4]
    data = np.random.RandomState(1).randn(sum(lens), 2).astype('float32')
    j, t = run_pair(_dyn_rnn_cumsum,
                    feed=lambda pkg: {'x': _lod(pkg, data, lens)})
    off = np.concatenate([[0], np.cumsum(lens)])
    want = np.stack([data[off[i]:off[i + 1]].sum(0) for i in range(3)])
    _close('last', pt.executor.as_numpy(t[1]), want)


DATA_W, HID_W = 8, 5


def _dynrnn_grad(pkg, with_memory, static):
    L = pkg.layers
    dat = L.data(name='X', shape=[DATA_W], dtype='float32', lod_level=1)
    bias = L.data(name='b', shape=[HID_W], dtype='float32')
    rnn = L.DynamicRNN()
    with rnn.block():
        d = rnn.step_input(dat)
        o = L.fc(input=d, size=HID_W, param_attr='W', bias_attr=False)
        if static:
            o = L.elementwise_add(o, rnn.static_input(bias))
        if with_memory:
            mem = rnn.memory(shape=[HID_W], value=0.0)
            o = L.elementwise_add(x=o, y=mem)
            rnn.update_memory(mem, o)
        rnn.output(o)
    last = L.sequence_pool(input=rnn(), pool_type='last')
    return [last], L.mean(last)


def _np_dynrnn(rows, lens, W, with_memory):
    lasts, off = [], 0
    for n in lens:
        mem = np.zeros(HID_W)
        for t in range(n):
            o = rows[off + t].astype('float64').dot(W.astype('float64'))
            if with_memory:
                o = o + mem
                mem = o
        lasts.append(o)
        off += n
    return float(np.mean(np.stack(lasts)))


@pytest.mark.parametrize('with_memory,static', [(False, False),
                                                (True, False),
                                                (True, True)],
                         ids=['simple_mul', 'mul_with_memory',
                              'static_input'])
def test_dynrnn_gradient_check(with_memory, static):
    rng = np.random.RandomState(5 if with_memory else 4)
    lens = [int(rng.randint(1, 5)) for _ in range(3)]
    rows = rng.uniform(-0.5, 0.5, (sum(lens), DATA_W)).astype('float32')
    W = rng.uniform(-0.5, 0.5, (DATA_W, HID_W)).astype('float32')
    b = np.zeros((3, HID_W), 'float32')
    j, t = run_pair(lambda pkg: _dynrnn_grad(pkg, with_memory, static),
                    feed=lambda pkg: {'X': _lod(pkg, rows, lens), 'b': b},
                    init={'W': W},
                    train=lambda pkg: pkg.optimizer.SGD(0.0))
    loss = float(pt.executor.as_numpy(t[1])[0])
    assert abs(loss - _np_dynrnn(rows, lens, W, with_memory)) < 1e-5


# ---- the LoD rank table ----------------------------------------------------------
def _rank_table(pkg, level2):
    L = pkg.layers
    x = L.data(name='x', shape=[1], dtype='float32',
               lod_level=2 if level2 else 1)
    table = L.lod_rank_table(x, level=0)
    arr = L.lod_tensor_to_array(x, table)
    back = L.array_to_lod_tensor(arr, table)
    reordered = L.reorder_lod_tensor_by_rank(x, table)
    shrunk = L.shrink_memory(x, L.fill_constant(shape=[1], dtype='int64',
                                                value=0), table)
    return [back, L.max_sequence_len(table), L.array_length(arr),
            reordered, shrunk], None


@pytest.mark.parametrize('lens', [[[3, 6, 1]], [[2, 4, 1]],
                                  [[2, 3], [3, 6, 2, 6, 3]]],
                         ids=['level1', 'level1_b', 'level2'])
def test_lod_rank_table_round_trip(lens):
    rows = np.arange(sum(lens[-1]), dtype='float32').reshape(-1, 1)
    j, t = run_pair(lambda pkg: _rank_table(pkg, len(lens) == 2),
                    feed=lambda pkg: {'x': _lod(pkg, rows, lens)})
    back = pt.executor.as_numpy(t[0])
    np.testing.assert_array_equal(back.to_dense_rows(), rows)
    assert back.recursive_sequence_lengths() == lens
    assert int(pt.executor.as_numpy(t[1])[0]) == max(lens[0])


def _array_grad(pkg):
    L = pkg.layers
    x = L.data(name='x', shape=[4], dtype='float32', lod_level=1)
    h = L.fc(input=x, size=4, bias_attr=False)
    table = L.lod_rank_table(h)
    back = L.array_to_lod_tensor(L.lod_tensor_to_array(h, table), table)
    w = L.data(name='wt', shape=[4], dtype='float32', lod_level=1)
    loss = L.reduce_sum(L.elementwise_mul(back, w))
    return [back], loss


def test_gradient_flows_through_array_round_trip():
    rng = np.random.RandomState(1)
    lens = [3, 6, 1]
    rows = rng.random_sample((10, 4)).astype('float32')
    wt = rng.random_sample((10, 4)).astype('float32')
    run_pair(_array_grad, feed=lambda pkg: {
        'x': _lod(pkg, rows, lens), 'wt': _lod(pkg, wt, lens)},
        train=lambda pkg: pkg.optimizer.SGD(0.0))


def _split_merge(pkg):
    L = pkg.layers
    x = L.data(name='x', shape=[3], dtype='float32')
    mask = L.data(name='m', shape=[1], dtype='bool')
    t, f = L.split_lod_tensor(input=x, mask=mask)
    out = L.merge_lod_tensor(in_true=L.scale(t, scale=2.0),
                             in_false=L.scale(f, scale=-3.0), x=x,
                             mask=mask)
    return [out, L.is_empty(x)], None


def test_split_merge_and_is_empty():
    xs = np.random.RandomState(2).randn(4, 3).astype('float32')
    m = np.array([[True], [False], [False], [True]])
    j, t = run_pair(_split_merge, feed=lambda pkg: {'x': xs, 'm': m})
    _close('merge', pt.executor.as_numpy(t[0]),
           np.where(m, 2 * xs, -3 * xs))
    assert not bool(pt.executor.as_numpy(t[1]))


def test_print_passes_the_value_through(capfd):
    def build(pkg):
        L = pkg.layers
        x = L.data(name='x', shape=[3], dtype='float32')
        h = L.fc(input=x, size=3, bias_attr=False)
        y = L.Print(h, message='print_op_test', first_n=1)
        return [y], L.mean(L.square(y))
    xs = np.array([[1., -2., 3.]], dtype='float32')
    run_pair(build, feed=lambda pkg: {'x': xs}, steps=2,
             train=lambda pkg: pkg.optimizer.SGD(0.0))
    err = capfd.readouterr().err
    # first_n=1: once in each package's two runs
    assert err.count('print_op_test') == 2, err


def test_parallel_do_runs_the_body_once():
    main, startup = pt.Program(), pt.Program()
    with pt.program_guard(main, startup):
        L = pt.layers
        x = L.data(name='x', shape=[3], dtype='float32')
        pd = L.ParallelDo(places=None)
        with pd.do():
            pd.write_output(L.scale(pd.read_input(x), scale=2.0))
        out, = pd()
    xs = np.ones((2, 3), 'float32')
    got, = pt.Executor(pt.CPUPlace()).run(main, feed={'x': xs},
                                          fetch_list=[out],
                                          scope=pt.Scope())
    np.testing.assert_array_equal(got, 2 * xs)


# ---- the mnist if-else book ------------------------------------------------------
def _digits(seed, n=16):
    rng = np.random.RandomState(seed)
    centers = rng.randn(10, 64).astype('float32')
    y = rng.randint(0, 10, (n, 1)).astype('int64')
    x = centers[y[:, 0]] + 0.3 * rng.randn(n, 64).astype('float32')
    return x, y


def _mnist_if_else(pkg, raw):
    L = pkg.layers
    image = L.data(name='x', shape=[64], dtype='float32')
    label = L.data(name='y', shape=[1], dtype='int64')
    limit = L.fill_constant_batch_size_like(
        input=label, dtype='int64', shape=[1, 1], value=5.0)
    cond = L.less_than(x=label, y=limit)
    if raw:
        true_image, false_image = L.split_lod_tensor(input=image, mask=cond)
        outs = []
        for img, size in ((true_image, 12), (false_image, 16)):
            out = L.create_tensor(dtype='float32')
            blk = L.ConditionalBlock([img])
            with blk.block():
                hidden = L.fc(input=img, size=size, act='tanh')
                L.assign(input=L.fc(input=hidden, size=10, act='softmax'),
                         output=out)
            outs.append(out)
        prob = L.merge_lod_tensor(in_true=outs[0], in_false=outs[1],
                                  mask=cond, x=image)
    else:
        ie = L.IfElse(cond)
        for blk, size in ((ie.true_block(), 12), (ie.false_block(), 16)):
            with blk:
                hidden = L.fc(input=ie.input(image), size=size, act='tanh')
                ie.output(L.fc(input=hidden, size=10, act='softmax'))
        prob = ie()[0]
    loss = L.mean(L.cross_entropy(input=prob, label=label))
    return [prob], loss


@pytest.mark.parametrize('raw', [True, False], ids=['raw_api', 'ifelse'])
def test_mnist_if_else_three_momentum_steps(raw):
    x, y = _digits(1)
    run_pair(lambda pkg: _mnist_if_else(pkg, raw),
             feed=lambda pkg: {'x': x, 'y': y}, steps=3, tol=MODEL_TOL,
             train=lambda pkg: pkg.optimizer.Momentum(learning_rate=0.05,
                                                      momentum=0.9))


# ---- the sparse record walks sub-blocks -------------------------------------------
def _sparse_table_in_a_while(pkg):
    """A table looked up with is_sparse=True for the loss, and read
    again by a dense lookup inside a While body (as book 08's decode
    reads its table in the loop)."""
    L = pkg.layers
    ids = L.data(name='ids', shape=[1], dtype='int64')
    i = L.fill_constant(shape=[1], dtype='int64', value=0)
    n = L.fill_constant(shape=[1], dtype='int64', value=2)
    seen = L.fill_constant(shape=[3, 4], dtype='float32', value=0.0)
    cond = L.less_than(x=i, y=n)
    with L.While(cond=cond).block():
        again = L.embedding(input=ids, size=[10, 4], param_attr='table')
        L.assign(L.elementwise_add(seen, again), seen)
        L.increment(x=i, value=1, in_place=True)
        L.less_than(x=i, y=n, cond=cond)
    # built last, so the table's parameter is the sparse one
    emb = L.embedding(input=ids, size=[10, 4], is_sparse=True,
                      param_attr='table')
    loss = L.mean(L.fc(input=emb, size=2))
    return [seen], loss


def test_sparse_table_read_in_a_while_takes_the_dense_gradient(
        monkeypatch):
    """Both packages drop the table from the sparse record (the port
    kept it before: its pruning read the global block only, and its
    lowering then refused the program), and both give the table the
    same dense gradient. The sparse threshold is lowered in both, so
    the small table is built sparse."""
    import paddle_tpu.layers.nn as j_nn
    import paddle_tpu_torch.layers.nn as t_nn
    for mod in (j_nn, t_nn):
        monkeypatch.setattr(mod, '_SPARSE_MIN_TABLE_ELEMS', [0])
    ids = np.array([[1], [3], [1]], 'int64')
    markers = []
    for pkg in (fluid, pt):
        main, startup = pkg.Program(), pkg.Program()
        with pkg.unique_name.guard(), pkg.program_guard(main, startup):
            _, loss = _sparse_table_in_a_while(pkg)
            pkg.optimizer.SGD(0.1).minimize(loss)
        markers.append([op.attrs['sparse'] for op in main.global_block().ops
                        if op.type == 'backward_marker'])
    assert markers == [[{}], [{}]]
    # the fetched loop output, the loss and table@GRAD (dense, [10, 4])
    run_pair(_sparse_table_in_a_while, feed=lambda pkg: {'ids': ids},
             train=lambda pkg: pkg.optimizer.SGD(0.1))
