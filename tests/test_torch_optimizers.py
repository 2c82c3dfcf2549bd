"""The port's optimizers against paddle_tpu's.

Each case builds one small regression net (fc 4 -> 8 relu -> fc 3,
square error, mean) with both packages' layers under fresh unique-name
generators, appends the same optimizer, initialises both from their
startup programs and then overwrites every parameter with one seeded
numpy draw, so both start from the same state (JAX's and torch's RNGs
never agree). Three steps run on the same feeds on the CPU; then every
parameter and every accumulator (each persistable the optimizer made:
moments, norms, beta powers, the learning rate), read with
``fetch_var``, must agree to 1e-5, and the losses too.

Also: the proximal kernels (``proximal_gd``, ``proximal_adagrad``, which
no optimizer class appends) on one hand-built update program each;
``ModelAverage``'s averaged parameters against paddle_tpu's, and its
``apply`` / ``restore`` giving back the trained tensors bit for bit;
Adamax's beta1 power advancing once a step; ``fetch_var`` returning a
copy; the two Queue C repairs (a backward with no parameters; a numpy
value in a Scope, inference and training).
"""
import numpy as np
import pytest
import torch

import paddle_tpu.fluid as fluid
import paddle_tpu_torch as pt
from paddle_tpu_torch import fluid as pt_fluid
from paddle_tpu_torch import io as pt_io

TOL = dict(atol=1e-5, rtol=1e-5)
STEPS = 3

OPTIMIZERS = {
    'sgd': lambda o: o.SGD(learning_rate=0.1),
    'momentum': lambda o: o.Momentum(learning_rate=0.05, momentum=0.9),
    'nesterov': lambda o: o.Momentum(learning_rate=0.05, momentum=0.9,
                                     use_nesterov=True),
    'adagrad': lambda o: o.Adagrad(learning_rate=0.1),
    'adam': lambda o: o.Adam(learning_rate=0.05),
    'adamax': lambda o: o.Adamax(learning_rate=0.05, beta1=0.8,
                                 beta2=0.9, epsilon=1e-4),
    'decayed_adagrad': lambda o: o.DecayedAdagrad(learning_rate=0.1,
                                                  decay=0.9),
    'adadelta': lambda o: o.Adadelta(learning_rate=1.0, epsilon=1e-2,
                                     rho=0.9),
    'rmsprop': lambda o: o.RMSProp(learning_rate=0.05, rho=0.9,
                                   epsilon=1e-4, momentum=0.5),
    'ftrl': lambda o: o.Ftrl(learning_rate=0.1, l1=0.01, l2=0.02),
}


def _net(pkg, opt_factory):
    main, startup = pkg.Program(), pkg.Program()
    with pkg.unique_name.guard(), pkg.program_guard(main, startup):
        L = pkg.layers
        x = L.data(name='x', shape=[4], dtype='float32')
        t = L.data(name='t', shape=[3], dtype='float32')
        h = L.fc(input=x, size=8, act='relu')
        y = L.fc(input=h, size=3)
        loss = L.mean(L.square_error_cost(input=y, label=t))
        opt = opt_factory(pkg.optimizer)
        opt.minimize(loss)
    return main, startup, loss, opt


def _feeds(step):
    rng = np.random.RandomState(100 + step)
    return {'x': rng.randn(6, 4).astype('float32'),
            't': rng.randn(6, 3).astype('float32')}


def _params(main):
    rng = np.random.RandomState(0)
    return {p.name: rng.uniform(-0.5, 0.5, p.shape).astype('float32')
            for p in main.global_block().all_parameters()}


def _persistables(main):
    return sorted(v.name for v in main.list_vars() if v.persistable)


def _train_jax(factory, after_step=None):
    main, startup, loss, opt = _net(fluid, factory)
    params = _params(main)
    scope = fluid.Scope()
    exe = fluid.Executor(fluid.CPUPlace())
    losses = []
    with fluid.scope_guard(scope), fluid.program_guard(main, startup):
        exe.run(startup)
        for n, a in params.items():
            scope.set_var(n, a)
        for s in range(STEPS):
            losses.append(np.asarray(exe.run(
                main, feed=_feeds(s), fetch_list=[loss])[0]))
            if after_step is not None:
                after_step(opt, scope)
        state = {n: np.asarray(fluid.fetch_var(n, scope))
                 for n in _persistables(main)}
    return main, losses, state, opt, scope


def _train_port(factory, after_step=None):
    main, startup, loss, opt = _net(pt, factory)
    params = _params(main)
    scope = pt.Scope()
    exe = pt.Executor(pt.CPUPlace())
    losses = []
    with pt.scope_guard(scope), pt.program_guard(main, startup):
        exe.run(startup)
        pt_io.params_from_numpy(scope, params, pt.CPUPlace())
        for s in range(STEPS):
            losses.append(exe.run(main, feed=_feeds(s),
                                  fetch_list=[loss])[0])
            if after_step is not None:
                after_step(opt, scope)
        state = {n: pt.fetch_var(n, scope) for n in _persistables(main)}
    return main, losses, state, opt, scope


@pytest.mark.parametrize('name', sorted(OPTIMIZERS))
def test_optimizer_state_matches_jax_after_three_steps(name):
    j_main, j_losses, j_state, _, _ = _train_jax(OPTIMIZERS[name])
    t_main, t_losses, t_state, _, _ = _train_port(OPTIMIZERS[name])
    assert _persistables(t_main) == _persistables(j_main)
    assert sorted(t_state) == sorted(j_state)
    # the accumulators the optimizer made, beside the parameters and LR
    n_params = len(t_main.global_block().all_parameters())
    assert len(t_state) == n_params + 1 if name == 'sgd' else \
        len(t_state) > 2 * n_params
    for s, (j, t) in enumerate(zip(j_losses, t_losses)):
        np.testing.assert_allclose(t, j, err_msg='loss %d' % s, **TOL)
    for n in sorted(j_state):
        np.testing.assert_allclose(t_state[n], j_state[n], err_msg=n, **TOL)


def test_optimizer_ops_and_accumulators_match_jax():
    for name, factory in sorted(OPTIMIZERS.items()):
        j_main, _, _, j_opt = _net(fluid, factory)
        t_main, _, _, t_opt = _net(pt, factory)
        j_ops = [(op.type, sorted(op.inputs.items()),
                  sorted(op.outputs.items()), sorted(op.attrs.items()))
                 for op in j_main.global_block().ops
                 if op.type != 'backward_marker']
        t_ops = [(op.type, sorted(op.inputs.items()),
                  sorted(op.outputs.items()), sorted(op.attrs.items()))
                 for op in t_main.global_block().ops
                 if op.type != 'backward_marker']
        assert t_ops == j_ops, name
        assert {k: sorted(v) for k, v in t_opt._accumulators.items()} == \
            {k: sorted(v) for k, v in j_opt._accumulators.items()}, name


def test_adamax_beta1_power_advances_once_a_step():
    _, _, state, opt, _ = _train_port(OPTIMIZERS['adamax'])
    np.testing.assert_allclose(state[opt._beta1_pow_acc.name],
                               [0.8 ** (STEPS + 1)], rtol=1e-6)


def _prox_program(pkg, op_type):
    main, startup = pkg.Program(), pkg.Program()
    with pkg.unique_name.guard(), pkg.program_guard(main, startup):
        L = pkg.layers
        p = L.create_parameter(shape=[5, 3], dtype='float32', name='p')
        g = L.data(name='g', shape=[5, 3], dtype='float32',
                   append_batch_size=False)
        lr = L.fill_constant(shape=[1], dtype='float32', value=0.3)
        inputs = {'Param': p, 'Grad': g, 'LearningRate': lr}
        outputs = {'ParamOut': p}
        if op_type == 'proximal_adagrad':
            m = L.create_parameter(shape=[5, 3], dtype='float32', name='m')
            inputs['Moment'] = m
            outputs['MomentOut'] = m
        main.global_block().append_op(type=op_type, inputs=inputs,
                                      outputs=outputs,
                                      attrs={'l1': 0.2, 'l2': 0.5})
    return main


@pytest.mark.parametrize('op_type', ['proximal_gd', 'proximal_adagrad'])
def test_proximal_kernels_match_jax(op_type):
    rng = np.random.RandomState(3)
    state = {'p': rng.randn(5, 3).astype('float32'),
             'm': rng.uniform(0.1, 1.0, (5, 3)).astype('float32')}
    feeds = [{'g': rng.randn(5, 3).astype('float32')}
             for _ in range(STEPS)]
    j_main, t_main = _prox_program(fluid, op_type), _prox_program(pt, op_type)
    names = [n for n in ('p', 'm') if j_main.global_block().vars.get(n)]
    j_scope, t_scope = fluid.Scope(), pt.Scope()
    for n in names:
        j_scope.set_var(n, state[n])
    pt_io.params_from_numpy(t_scope, {n: state[n] for n in names},
                            pt.CPUPlace())
    j_exe, t_exe = fluid.Executor(fluid.CPUPlace()), pt.Executor(
        pt.CPUPlace())
    for f in feeds:
        j_exe.run(j_main, feed=f, scope=j_scope)
        t_exe.run(t_main, feed=f, scope=t_scope)
    for n in names:
        want = np.asarray(fluid.fetch_var(n, j_scope))
        np.testing.assert_allclose(pt.fetch_var(n, t_scope), want,
                                   err_msg=n, **TOL)
        assert not np.allclose(want, state[n]), n     # it moved


def test_model_average_matches_jax_and_restores_bits():
    factory = OPTIMIZERS['momentum']
    avgs = {}

    def track(pkg, key):
        def after(opt, scope):
            avg = avgs.setdefault(key, pkg.optimizer.ModelAverage(
                0.15, min_average_window=2, max_average_window=10))
            avg.update(scope)
        return after

    j_main, _, _, _, j_scope = _train_jax(factory, track(fluid, 'jax'))
    t_main, _, _, _, t_scope = _train_port(factory, track(pt, 'port'))
    names = [p.name for p in t_main.global_block().all_parameters()]
    trained = {n: t_scope.raw(n) for n in names}
    before = {n: pt.fetch_var(n, t_scope) for n in names}
    with fluid.scope_guard(j_scope), fluid.program_guard(j_main):
        with avgs['jax'].apply():
            j_avg = {n: np.asarray(j_scope.raw(n)).copy() for n in names}
    with pt.scope_guard(t_scope), pt.program_guard(t_main):
        with avgs['port'].apply():
            t_avg = {n: pt.fetch_var(n, t_scope) for n in names}
    for n in names:
        np.testing.assert_allclose(t_avg[n], j_avg[n], err_msg=n, **TOL)
        assert not np.array_equal(t_avg[n], before[n]), n
        # restore puts the trained tensor itself back
        assert t_scope.raw(n) is trained[n]
        np.testing.assert_array_equal(pt.fetch_var(n, t_scope), before[n])
    # apply without restore, then restore by hand
    with pt.scope_guard(t_scope):
        with avgs['port'].apply(need_restore=False):
            pass
        assert t_scope.raw(names[0]) is not trained[names[0]]
        avgs['port'].restore()
    assert all(t_scope.raw(n) is trained[n] for n in names)


def test_weighted_average_matches_jax():
    j, t = fluid.average.WeightedAverage(), pt.average.WeightedAverage()
    for v, w in ((1.0, 2), (np.array([3.0]), 1), (5.0, 3)):
        j.add(v, w)
        t.add(v, w)
    np.testing.assert_allclose(t.eval(), j.eval())
    with pytest.raises(ValueError):
        t.add('x', 1)


def test_fetch_var_returns_a_copy():
    scope = pt.Scope()
    pt_io.params_from_numpy(scope, {'w': np.ones((2, 2), 'float32')},
                            pt.CPUPlace())
    got = pt.fetch_var('w', scope)
    got[:] = 7
    np.testing.assert_array_equal(pt.fetch_var('w', scope), np.ones((2, 2)))
    assert pt.fetch_var('absent', scope) is None
    assert pt.fetch_var('w', scope, return_numpy=False) is scope.raw('w')
    assert pt_fluid.fetch_var is pt.executor.fetch_var


def _backward_without_parameters(pkg):
    main, startup = pkg.Program(), pkg.Program()
    with pkg.program_guard(main, startup):
        x = pkg.layers.data(name='x', shape=[3], dtype='float32',
                            append_batch_size=False)
        x.stop_gradient = False
        y = pkg.layers.scale(x, scale=2.0)
        s = pkg.layers.reduce_sum(y)
        assert pkg.backward.append_backward(s) == []
    return main, startup, s, y


def test_backward_without_parameters_runs_like_jax():
    """Queue C: a backward marker with no parameters raised in
    torch.autograd.grad; the forward and the update ops now run."""
    out = {}
    for pkg in (fluid, pt):
        main, startup, s, y = _backward_without_parameters(pkg)
        exe = pkg.Executor(pkg.CPUPlace())
        with pkg.scope_guard(pkg.Scope()):
            exe.run(startup)
            out[pkg] = [np.asarray(v) for v in exe.run(
                main, feed={'x': np.full(3, 2.0, 'float32')},
                fetch_list=[s, y])]
    assert float(out[fluid][0]) == 12.0
    for j, t in zip(out[fluid], out[pt]):
        np.testing.assert_array_equal(t, j)


def test_single_head_attention_without_parameters_matches_numpy():
    """The reference's test_single_head_matches_numpy_oracle program: one
    head has no projection parameters, and data with stop_gradient=False
    takes the backward."""
    rng = np.random.RandomState(2)
    queries = rng.random_sample((2, 5, 8)).astype('float32')
    keys = rng.random_sample((2, 5, 8)).astype('float32')
    main, startup = pt.Program(), pt.Program()
    with pt.program_guard(main, startup):
        q = pt.layers.data(name='queries', shape=[2, 5, 8], dtype='float32',
                           append_batch_size=False)
        q.stop_gradient = False
        k = pt.layers.data(name='keys', shape=[2, 5, 8], dtype='float32',
                           append_batch_size=False)
        k.stop_gradient = False
        contexts = pt.nets.scaled_dot_product_attention(
            queries=q, keys=k, values=k, num_heads=1, dropout_rate=0.)
        out = pt.layers.reduce_sum(contexts, dim=None)
        pt.backward.append_backward(loss=out)
    exe = pt.Executor(pt.CPUPlace())
    with pt.scope_guard(pt.Scope()):
        exe.run(startup)
        got, = exe.run(main, feed={'queries': queries, 'keys': keys},
                       fetch_list=[contexts])
    scores = np.matmul(queries, keys.transpose(0, 2, 1)) / np.sqrt(8.0)
    e = np.exp(scores - scores.max(-1, keepdims=True))
    want = np.matmul(e / e.sum(-1, keepdims=True), keys)
    np.testing.assert_allclose(got, want, atol=1e-4)


def _fc_with_numpy_weight(pkg):
    main, startup = pkg.Program(), pkg.Program()
    with pkg.unique_name.guard(), pkg.program_guard(main, startup):
        x = pkg.layers.data(name='x', shape=[3], dtype='float32')
        y = pkg.layers.fc(x, size=2, bias_attr=False, param_attr='W')
        loss = pkg.layers.mean(y)
        test = main.clone(for_test=True)
        pkg.optimizer.SGD(learning_rate=0.1).minimize(loss)
    scope = pkg.Scope()
    exe = pkg.Executor(pkg.CPUPlace())
    exe.run(startup, scope=scope)
    scope.set_var('W', np.ones((3, 2), 'float32'))
    feed = {'x': np.ones((1, 3), 'float32')}
    return [float(np.asarray(exe.run(p, feed=feed, fetch_list=[loss],
                                     scope=scope)[0]).ravel()[0])
            for p in (test, main, test)]


def test_numpy_value_in_scope_serves_and_trains_like_jax():
    """Queue C: a parameter set as a numpy array broke both modes; the
    Executor now makes it a tensor on its device where it gathers the
    state. Serve 3.0, one SGD step from 3.0, then 2.85."""
    want = _fc_with_numpy_weight(fluid)
    assert want == pytest.approx([3.0, 3.0, 2.85], abs=1e-6)
    np.testing.assert_allclose(_fc_with_numpy_weight(pt), want, atol=1e-6)


def test_numpy_value_in_scope_becomes_a_tensor_once():
    """The tensor made from a numpy value goes back into the Scope that
    held it (a parent of the run's scope here), not only into the run's
    own scope with the rest of the state, so a second run through
    either scope takes the same tensor and converts nothing."""
    main, startup = pt.Program(), pt.Program()
    with pt.unique_name.guard(), pt.program_guard(main, startup):
        x = pt.layers.data(name='x', shape=[3], dtype='float32')
        y = pt.layers.fc(x, size=2, bias_attr=False, param_attr='W')
    outer = pt.Scope()
    exe = pt.Executor(pt.CPUPlace())
    exe.run(startup, scope=outer)
    outer.set_var('W', np.full((3, 2), 2.0))
    inner = outer.new_scope()
    feed = {'x': np.ones((1, 3), 'float32')}
    out = exe.run(main, feed=feed, fetch_list=[y], scope=inner)[0]
    np.testing.assert_array_equal(out, np.full((1, 2), 6.0, 'float32'))
    held = outer.raw('W')
    assert isinstance(held, torch.Tensor) and held.dtype == torch.float32
    exe.run(main, feed=feed, fetch_list=[y], scope=inner)
    exe.run(main, feed=feed, fetch_list=[y], scope=outer)
    assert outer.raw('W') is held and inner.raw('W') is held
