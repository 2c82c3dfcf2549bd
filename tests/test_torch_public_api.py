"""The port's public names against paddle_tpu's: the live Scope
binding (``Scope.var``, ``find_var(...).get_tensor().set(...)``,
``drop_kids``), ``io.get_parameter_value*``, the ``resilience.retry``
decorator, the package exports, and ``reshape(actual_shape=<Variable>)``.

Each case does the same thing through both packages on the CPU and
compares what they give: presence tests as booleans, values to 1e-5, the
retry's sleeps under a fake clock exactly. A value written through
``set`` must be what the next ``Executor.run`` reads, also where a cache
keyed on a tensor holds the old one (the fused conv's re-laid-out
weight), through ``run_chained`` and in ``ModelAverage``.
"""
import contextlib

import numpy as np
import pytest
import torch

import paddle_tpu
import paddle_tpu.fluid as fluid
import paddle_tpu.compiler as jax_compiler
import paddle_tpu_torch as pt

TOL = dict(atol=1e-5, rtol=1e-5)


# ---- Scope.var, find_var's presence rule, drop_kids --------------------------------
def _presence(pkg):
    """The same Scope operations, the presence tests they give."""
    seen = []
    scope = pkg.Scope()
    seen.append(scope.find_var('a') is None)
    binding = scope.var('a')
    seen.append(binding is not None)
    seen.append(scope.find_var('a') is None)          # declared, unset
    binding.get_tensor().set(np.arange(4, dtype='float32'), None)
    seen.append(scope.find_var('a') is not None)
    child = scope.new_scope()
    seen.append(child.find_var('a') is not None)     # the parent's slot
    child.var('a')                                   # a local declaration
    seen.append(child.find_var('a') is None)         # shadows the parent
    child.set_var('only_child', np.float32(1.5))
    seen.append(scope.find_var('only_child') is None)
    scope.drop_kids()
    seen.append(scope.new_scope().find_var('only_child') is None)
    seen.append(scope.find_var('a').get_tensor() is not None)
    seen.append(np.asarray(scope.find_var('a')).tolist())
    seen.append(list(scope.find_var('a').shape))
    seen.append(scope.find_var('a').lod())
    return seen


def test_scope_var_and_presence_rule_match_jax():
    assert _presence(pt) == _presence(fluid)


def test_set_keeps_dtype_device_and_sequence():
    scope = pt.Scope()
    scope.set_var('i', torch.zeros(3, dtype=torch.int64))
    b = scope.find_var('i').get_tensor()
    b.set(np.array([1.7, 2.2, -3.0]), pt.CPUPlace())
    v = scope.raw('i')
    assert str(v.dtype) == 'torch.int64' and v.tolist() == [1, 2, -3]
    # a new slot takes the array's dtype, float64 as float32 (as JAX's)
    scope.var('f').get_tensor().set(np.ones((2, 2)), pt.CPUPlace())
    assert str(scope.raw('f').dtype) == 'torch.float32'
    # a copy: the caller's array can change afterwards
    src = np.zeros(3, 'float32')
    scope.var('c').get_tensor().set(src, None)
    src[:] = 5
    assert scope.raw('c').tolist() == [0, 0, 0]
    # a SequenceTensor slot is set through its own set
    seq = pt.create_lod_tensor(np.zeros((3, 2), 'float32'), [[1, 2]],
                               pt.CPUPlace())
    scope.set_var('s', seq)
    assert scope.find_var('s').lod() == [[0, 1, 3]]
    scope.find_var('s').get_tensor().set(np.ones((3, 2), 'float32'),
                                         pt.CPUPlace())
    assert scope.raw('s') is seq
    np.testing.assert_array_equal(np.asarray(seq), np.ones((3, 2)))
    # the CUDA place raises on a host without CUDA: no silent CPU copy
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match='CUDA is not available'):
            scope.find_var('f').get_tensor().set(np.ones(2), pt.CUDAPlace(0))
    # fetch_var, as_numpy and evaluator-style reads take the binding
    np.testing.assert_array_equal(pt.executor.as_numpy(scope.find_var('f')),
                                  np.ones((2, 2)))


def _conv_net(pkg):
    main, startup = pkg.Program(), pkg.Program()
    with pkg.unique_name.guard(), pkg.program_guard(main, startup):
        img = pkg.layers.data(name='img', shape=[3, 8, 8], dtype='float32')
        conv = pkg.layers.conv2d(img, num_filters=4, filter_size=3,
                                 padding=1, act='relu')
        out = pkg.layers.fc(pkg.layers.pool2d(conv, pool_size=2,
                                              pool_stride=2), size=3)
    return main, startup, out


@pytest.mark.parametrize('compiled', [False, True])
def test_set_into_parent_slot_is_seen_by_the_next_run(compiled):
    """Startup in a parent Scope; the new parameters written through a
    child's binding land in the parent's slot, and the next run (memo
    hit, and with the compiler on, a fused conv that keeps its
    re-laid-out weight) computes with them, as paddle_tpu does."""
    rng = np.random.RandomState(0)
    img = rng.randn(2, 3, 8, 8).astype('float32')
    res, draws = {}, None
    for pkg, comp in ((fluid, jax_compiler), (pt, pt.compiler)):
        main, startup, out = _conv_net(pkg)
        names = sorted(p.name for p in main.global_block().all_parameters())
        if draws is None:
            draws = [{n: rng.uniform(-1, 1, main.global_block().var(n).shape)
                      .astype('float32') for n in names} for _ in range(2)]
        first, second = draws
        parent = pkg.Scope()
        exe = pkg.Executor(pkg.CPUPlace())
        child = parent.new_scope()
        got = []
        with (contextlib.nullcontext() if compiled else comp.disabled()):
            exe.run(startup, scope=parent)
            for params in (first, second):
                for n in names:
                    child.find_var(n).get_tensor().set(params[n],
                                                       pkg.CPUPlace())
                    # the run writes its state into ``child``; before
                    # it, the parent owns the slot
                    assert (n in child.vars) == (params is second)
                got.append(np.asarray(exe.run(main, feed={'img': img},
                                              fetch_list=[out],
                                              scope=child)[0]))
        res[pkg] = got
    for j, t in zip(res[fluid], res[pt]):
        np.testing.assert_allclose(t, j, atol=1e-4, rtol=1e-4)
    assert np.abs(res[pt][0] - res[pt][1]).max() > 1e-3


def test_set_is_read_by_run_chained_and_model_average():
    main, startup, out = _conv_net(pt)
    w = [p for p in main.global_block().all_parameters()
         if p.shape[0] == 4 and len(p.shape) == 4][0]
    scope = pt.Scope()
    exe = pt.Executor(pt.CPUPlace())
    exe.run(startup, scope=scope)
    img = np.random.RandomState(1).randn(2, 3, 8, 8).astype('float32')
    before = exe.run_chained(main, [{'img': img}], fetch_list=[out],
                             scope=scope)[0][0]
    scope.find_var(w.name).get_tensor().set(
        np.zeros(w.shape, 'float32'), pt.CPUPlace())
    after = exe.run_chained(main, [{'img': img}], fetch_list=[out],
                            scope=scope)[0][0]
    assert np.abs(before - after).max() > 1e-4
    # the conv's output is now relu(bias) everywhere: every image alike
    np.testing.assert_allclose(after[0], after[1], **TOL)
    avg = pt.optimizer.ModelAverage(0.15, min_average_window=1,
                                    max_average_window=10)
    with pt.program_guard(main, startup), pt.scope_guard(scope):
        avg.update(scope)
        scope.find_var(w.name).get_tensor().set(
            np.full(w.shape, 2.0, 'float32'), pt.CPUPlace())
        avg.update(scope)
        with avg.apply(exe):
            np.testing.assert_allclose(pt.fetch_var(w.name, scope),
                                       np.full(w.shape, 1.0), **TOL)


# ---- io.get_parameter_value* ---------------------------------------------------------
def test_get_parameter_value_matches_jax():
    vals = {}
    for pkg in (fluid, pt):
        main, startup = pkg.Program(), pkg.Program()
        with pkg.unique_name.guard(), pkg.program_guard(main, startup):
            x = pkg.layers.data(name='x', shape=[3], dtype='float32')
            pkg.layers.fc(x, size=2, param_attr=pkg.ParamAttr(name='fc_w'))
            exe = pkg.Executor(pkg.CPUPlace())
            with pkg.scope_guard(pkg.Scope()):
                with pytest.raises(RuntimeError, match='startup'):
                    pkg.io.get_parameter_value_by_name('fc_w', exe)
                exe.run(startup)
                w = np.arange(6, dtype='float32').reshape(3, 2)
                pkg.global_scope().find_var('fc_w').get_tensor().set(
                    w, pkg.CPUPlace())
                p = main.global_block().var('fc_w')
                vals[pkg] = (pkg.io.get_parameter_value(p, exe),
                             pkg.io.get_parameter_value_by_name(
                                 'fc_w', exe, main))
    for j, t in zip(vals[fluid], vals[pt]):
        assert isinstance(t, np.ndarray)
        np.testing.assert_array_equal(t, np.asarray(j))


# ---- resilience.retry ------------------------------------------------------------------
class _Clock(object):
    def __init__(self):
        self.now, self.sleeps = 100.0, []

    def sleep(self, s):
        self.sleeps.append(s)
        self.now += s

    def monotonic(self):
        return self.now


def _retry_trace(res_mod, monkeypatch, **kw):
    clock = _Clock()
    monkeypatch.setattr(res_mod.retry.__globals__['time'], 'monotonic',
                        clock.monotonic)
    calls, hooks = [], []

    @res_mod.retry(sleep=clock.sleep, on_retry=lambda a, e: hooks.append(a),
                   **kw)
    def flaky(n_fail):
        calls.append(n_fail)
        if len(calls) <= n_fail:
            raise OSError('transient %d' % len(calls))
        return 'ok'

    out = []
    for n_fail in (2, 10):
        calls.clear()
        try:
            out.append(flaky(n_fail))
        except res_mod.RetryError as e:
            out.append((e.attempts, e.deadline_exceeded,
                        type(e.last_error)))
    return out, calls, hooks, clock.sleeps, flaky.__name__


@pytest.mark.parametrize('kw', [
    dict(max_attempts=4, backoff=0.1, jitter=0.0),
    dict(max_attempts=3, backoff=0.5, jitter=0.0, deadline=100.7),
])
def test_retry_decorator_matches_jax(kw, monkeypatch):
    import paddle_tpu.resilience as jres
    got = _retry_trace(pt.resilience, monkeypatch, **kw)
    want = _retry_trace(jres, monkeypatch, **kw)
    assert got == want
    assert got[4] == 'flaky' and len(got[3]) > 0


def test_retry_backoff_and_jitter_bounds(monkeypatch):
    _, calls, hooks, sleeps, _ = _retry_trace(
        pt.resilience, monkeypatch, max_attempts=4, backoff=0.2, jitter=0.5)
    # 2 failures then success: 2 sleeps; then 4 failures: 3 sleeps
    assert len(sleeps) == 5 and hooks == [1, 2, 1, 2, 3]
    for s, k in zip(sleeps, [1, 2, 1, 2, 3]):
        assert 0.2 * 2 ** (k - 1) <= s <= 0.2 * 2 ** (k - 1) * 1.5
    with pytest.raises(ValueError):
        pt.resilience.retry(max_attempts=0)
    # a non-matching error propagates at once
    n = []

    @pt.resilience.retry(retry_on=(OSError,), sleep=lambda s: None)
    def bad():
        n.append(1)
        raise KeyError('x')
    with pytest.raises(KeyError):
        bad()
    assert n == [1]


# ---- exports ---------------------------------------------------------------------------
def test_exports_match_jax():
    import paddle_tpu.resilience as jres
    import paddle_tpu.reader as jreader
    import paddle_tpu_torch.fluid as ptf
    assert issubclass(ptf.CUDAPinnedPlace, pt.CPUPlace)
    assert ptf.CUDAPinnedPlace().torch_device().type == 'cpu'
    assert ptf.Tensor is pt.SequenceTensor is pt.Tensor
    assert paddle_tpu.Tensor is paddle_tpu.SequenceTensor
    for name in ('SITE_SERVING_RUN', 'SITE_SERVING_LOAD', 'SITE_SERVING_PAD',
                 'retry', 'retry_call', 'RetryError'):
        assert name in pt.resilience.__all__
        if name.startswith('SITE'):
            assert getattr(pt.resilience, name) == getattr(jres, name)
    for name in ('PrefetchPipeline', 'prefetch_feeds', 'stage_on_device'):
        assert name in pt.reader.__all__ and name in jreader.__all__
        assert getattr(pt.reader, name) is getattr(pt.reader.prefetch, name)
    with pytest.raises(AttributeError):
        pt.reader.no_such_name
    assert pt.layers.monkey_patch_variable is \
        pt.layers.math_op_patch.monkey_patch_variable
    jl = {n for n in dir(fluid.layers) if not n.startswith('_')}
    tl = {n for n in dir(pt.layers) if not n.startswith('_')}
    # what is left is item 6's multi-process half: the distributed names
    assert jl - tl == {'BlockGuardServ', 'ListenAndServ', 'Recv', 'Send'}


def test_op_kernel_counts():
    """219 of paddle_tpu's 222 op kernels; the 3 left are the
    DistributeTranspiler's send/recv markers (item 6's multihost
    half)."""
    import importlib
    import pkgutil
    import paddle_tpu.ops as jops
    import paddle_tpu_torch.ops as tops
    for pkg in (jops, tops):
        for m in pkgutil.iter_modules(pkg.__path__):
            importlib.import_module(pkg.__name__ + '.' + m.name)
    from paddle_tpu.core.registry import _KERNELS as J
    from paddle_tpu_torch.core.registry import _KERNELS as T
    assert set(T) <= set(J) and len(J) == 222 and len(T) == 219
    assert set(J) - set(T) == {
        'send_marker', 'recv_marker', 'listen_and_serv_marker'}


def test_layers_sum_matches_jax():
    res = {}
    xs = [np.random.RandomState(i).randn(2, 3).astype('float32')
          for i in range(3)]
    for pkg in (fluid, pt):
        main, startup = pkg.Program(), pkg.Program()
        with pkg.unique_name.guard(), pkg.program_guard(main, startup):
            vs = [pkg.layers.data(name='x%d' % i, shape=[3], dtype='float32')
                  for i in range(3)]
            outs = [pkg.layers.sum(vs), pkg.layers.sum(vs[0])]
        assert [op.type for op in main.global_block().ops] == ['sum', 'sum']
        res[pkg] = pkg.Executor(pkg.CPUPlace()).run(
            main, feed={'x%d' % i: x for i, x in enumerate(xs)},
            fetch_list=outs, scope=pkg.Scope())
    for j, t in zip(res[fluid], res[pt]):
        np.testing.assert_allclose(t, np.asarray(j), **TOL)


# ---- reshape(actual_shape=<Variable>) --------------------------------------------------
def test_reshape_actual_shape_variable_keys_the_memo():
    """A fed shape is bound statically: each new value is one memo miss,
    an old value a hit; the values equal paddle_tpu's."""
    x = np.arange(48, dtype='float32').reshape(4, 12)
    shapes = [[8, 6], [2, 24], [8, 6], [-1, 3, 4]]
    res = {}
    for pkg in (fluid, pt):
        main, startup = pkg.Program(), pkg.Program()
        with pkg.unique_name.guard(), pkg.program_guard(main, startup):
            xv = pkg.layers.data(name='x', shape=[12], dtype='float32')
            sv = pkg.layers.data(name='s', shape=[-1], dtype='int32',
                                 append_batch_size=False)
            y = pkg.layers.reshape(xv, shape=[-1, 12], actual_shape=sv)
            z = pkg.layers.scale(y, scale=2.0)
        op = [o for o in main.global_block().ops if o.type == 'reshape'][0]
        assert op.input('Shape') == ['s']
        exe = pkg.Executor(pkg.CPUPlace())
        scope = pkg.Scope()
        got = []
        for s in shapes:
            got.append(exe.run(main, feed={'x': x, 's': np.array(s, 'int32')},
                               fetch_list=[y, z], scope=scope))
            if pkg is pt:
                got[-1].append(exe.cache_info()[:2])
        res[pkg] = got
    for s, j, t in zip(shapes, res[fluid], res[pt]):
        for a, b in zip(j, t[:2]):
            assert np.asarray(b).shape == np.asarray(a).shape
            np.testing.assert_array_equal(np.asarray(b), np.asarray(a))
    assert [t[2] for t in res[pt]] == [(0, 1), (0, 2), (1, 2), (1, 3)]


def test_reshape_actual_shape_computed_in_the_graph():
    """A shape computed by an op is read from the device by the kernel
    (one host read), with no memo key of its own."""
    main, startup = pt.Program(), pt.Program()
    with pt.program_guard(main, startup):
        xv = pt.layers.data(name='x', shape=[12], dtype='float32')
        s = pt.layers.fill_constant(shape=[2], dtype='int32', value=6)
        y = pt.layers.reshape(xv, shape=[-1, 12], actual_shape=s)
    out, = pt.Executor(pt.CPUPlace()).run(
        main, feed={'x': np.zeros((3, 12), 'float32')}, fetch_list=[y],
        scope=pt.Scope())
    assert out.shape == (6, 6)
