"""The port's pipelined training loop on the CPU: ``Executor.run_chained``
and ``run(async_fetch=True)`` bit-equal to sequential runs, a lazy fetch
that keeps its step's value, ``Trainer.train(prefetch, steps_per_dispatch,
sync_interval)`` bit-equal to the plain loop (and to paddle_tpu's
pipelined Trainer within 1e-5 on the same persistables), and the
prefetch contract: order, bound, exceptions at the point of the break,
shutdown on abandon. The race on the card is tests/test_torch_prefetch_cuda.py.
"""
import collections
import threading
import time

import jax  # noqa: F401 (the JAX side runs on the CPU)
import numpy as np
import pytest
import torch

import paddle_tpu.fluid as jfluid
import paddle_tpu_torch as pt
import paddle_tpu_torch.fluid as tfluid
from paddle_tpu_torch.reader.prefetch import (DeviceStager,
                                              PrefetchPipeline,
                                              prefetch_feeds,
                                              stage_on_device)

pytestmark = pytest.mark.pipeline


def _build(dropout=True):
    main, start = pt.Program(), pt.Program()
    with pt.program_guard(main, start), pt.unique_name.guard():
        x = pt.layers.data(name='x', shape=[4], dtype='float32')
        y = pt.layers.data(name='y', shape=[1], dtype='float32')
        h = pt.layers.fc(input=x, size=8, act='relu')
        if dropout:
            h = pt.layers.dropout(h, dropout_prob=0.3)
        pred = pt.layers.fc(input=h, size=1)
        loss = pt.layers.mean(
            pt.layers.square_error_cost(input=pred, label=y))
        pt.optimizer.Adam(learning_rate=0.01).minimize(loss)
    return main, start, loss


def _feeds(n_steps=8, batch=16, seed=0):
    rng = np.random.RandomState(seed)
    feeds = [{'x': rng.randn(batch, 4).astype('float32'),
              'y': rng.randn(batch, 1).astype('float32')}
             for _ in range(n_steps - 1)]
    feeds.append({'x': rng.randn(5, 4).astype('float32'),     # ragged
                  'y': rng.randn(5, 1).astype('float32')})
    return feeds


def _state(scope, main):
    return {v.name: pt.fetch_var(v.name, scope) for v in main.list_vars()
            if v.persistable and scope.raw(v.name) is not None}


def _sequential(feeds):
    main, start, loss = _build()
    scope = pt.Scope()
    exe = pt.Executor(pt.CPUPlace())
    exe.run(start, scope=scope)
    losses = [exe.run(main, feed=f, fetch_list=[loss], scope=scope)[0]
              for f in feeds]
    return losses, _state(scope, main), scope


def test_run_chained_and_async_fetch_bit_equal_to_sequential():
    feeds = _feeds()
    seq_losses, seq_state, seq_scope = _sequential(feeds)
    for async_fetch in (False, True):
        main, start, loss = _build()
        scope = pt.Scope()
        exe = pt.Executor(pt.CPUPlace())
        exe.run(start, scope=scope)
        got = []
        for i in range(0, len(feeds), 3):          # chains of 3, 3, 2
            rows = exe.run_chained(main, feed_list=feeds[i:i + 3],
                                   fetch_list=[loss], scope=scope,
                                   async_fetch=async_fetch)
            assert len(rows) == len(feeds[i:i + 3])
            for row in rows:
                assert isinstance(row[0], torch.Tensor) == async_fetch
                got.append(pt.executor.as_numpy(row[0]))
        assert len(got) == len(seq_losses)
        for a, b in zip(seq_losses, got):
            assert np.array_equal(a, b)
        state = _state(scope, main)
        assert set(state) == set(seq_state)
        assert any('moment' in n for n in state)
        for n in state:
            assert np.array_equal(state[n], seq_state[n]), n
        for gen in (pt.core.lowering.RNG_KEY, pt.core.lowering.RNG_CPU_KEY):
            assert torch.equal(scope.raw(gen).get_state(),
                               seq_scope.raw(gen).get_state())


def test_lazy_fetch_keeps_its_steps_value():
    main, start, loss = _build(dropout=False)
    scope = pt.Scope()
    exe = pt.Executor(pt.CPUPlace())
    exe.run(start, scope=scope)
    w = main.global_block().all_parameters()[0].name
    feeds = _feeds(4)
    lazy = exe.run(main, feed=feeds[0], fetch_list=[loss, w],
                   scope=scope, async_fetch=True)
    want = [t.clone() for t in lazy]
    for f in feeds[1:3]:
        exe.run(main, feed=f, fetch_list=[loss], scope=scope)
    scope.raw(w).add_(1.0)     # a later write in place into the Scope
    for got, ref in zip(lazy, want):
        assert torch.equal(got, ref)
    assert not torch.equal(lazy[1], scope.raw(w))


def _trainer_reader(n=70, batch=16, seed=0):
    rng = np.random.RandomState(seed)
    xs = rng.randn(n, 4).astype('float32')
    ys = (xs @ np.array([1., -2., 3., .5], np.float32))[:, None] + 0.1

    def r():
        for i in range(0, n, batch):
            yield list(zip(xs[i:i + batch], ys[i:i + batch]))
    return r


def _trainer_func(fluid):
    x = fluid.layers.data(name='x', shape=[4], dtype='float32')
    y = fluid.layers.data(name='y', shape=[1], dtype='float32')
    h = fluid.layers.fc(input=x, size=8, act='relu',
                        param_attr=fluid.ParamAttr(name='pl_w1'))
    pred = fluid.layers.fc(input=h, size=1,
                           param_attr=fluid.ParamAttr(name='pl_w2'))
    return fluid.layers.mean(
        fluid.layers.square_error_cost(input=pred, label=y))


def _train_once(fluid, param_path=None, train_func=_trainer_func, **kw):
    losses, events = [], []

    def handler(ev):
        events.append(type(ev).__name__)
        if isinstance(ev, fluid.EndStepEvent) and ev.metrics:
            v = ev.metrics[0]
            losses.append(v.numpy().copy() if isinstance(v, torch.Tensor)
                          else np.asarray(v).copy())

    tr = fluid.Trainer(train_func=lambda: train_func(fluid),
                       optimizer=fluid.optimizer.Adam(learning_rate=0.01),
                       param_path=param_path, place=fluid.CPUPlace())
    tr.train(num_epochs=3, event_handler=handler,
             reader=_trainer_reader(), feed_order=['x', 'y'], **kw)
    state = {n: np.asarray(tr.scope.raw(n)) for n in ('pl_w1', 'pl_w2')}
    return losses, state, events


def _dropout_func(fluid):
    x = fluid.layers.data(name='x', shape=[4], dtype='float32')
    y = fluid.layers.data(name='y', shape=[1], dtype='float32')
    h = fluid.layers.fc(input=x, size=8, act='relu',
                        param_attr=fluid.ParamAttr(name='pl_w1'))
    h = fluid.layers.dropout(h, dropout_prob=0.2)
    pred = fluid.layers.fc(input=h, size=1,
                           param_attr=fluid.ParamAttr(name='pl_w2'))
    return fluid.layers.mean(
        fluid.layers.square_error_cost(input=pred, label=y))


def test_trainer_pipelined_bit_equal_to_plain_loop():
    base = _train_once(tfluid, train_func=_dropout_func)
    pipe = _train_once(tfluid, train_func=_dropout_func, prefetch=2,
                       steps_per_dispatch=3, sync_interval=2)
    # chunks of 3 interleave the events differently, not their counts
    assert collections.Counter(base[2]) == collections.Counter(pipe[2])
    assert len(base[0]) == len(pipe[0]) == 15
    for i, (a, b) in enumerate(zip(base[0], pipe[0])):
        assert np.array_equal(a, b), i
    for n in base[1]:
        assert np.array_equal(base[1][n], pipe[1][n]), n


def test_trainer_pipelined_matches_paddle_tpus(tmp_path):
    src = jfluid.Trainer(lambda: _trainer_func(jfluid),
                         jfluid.optimizer.Adam(learning_rate=0.01),
                         place=jfluid.CPUPlace())
    d = str(tmp_path / 'init')
    src.save_params(d)
    kw = dict(prefetch=2, steps_per_dispatch=3, sync_interval=2)
    j = _train_once(jfluid, d, **kw)
    t = _train_once(tfluid, d, **kw)
    assert collections.Counter(t[2]) == collections.Counter(j[2])
    np.testing.assert_allclose(np.concatenate(t[0]),
                               np.concatenate(j[0]), rtol=1e-5, atol=1e-5)
    for n in j[1]:
        np.testing.assert_allclose(t[1][n], j[1][n], rtol=1e-5, atol=1e-5)


def test_trainer_host_wait_metric_fills():
    reg = pt.observability.default_registry()
    waits = reg.histogram('trainer_host_wait_seconds')
    dispatch = reg.histogram('trainer_dispatch_seconds')
    w0, d0 = waits.count, dispatch.count
    _train_once(tfluid, prefetch=2, steps_per_dispatch=4, sync_interval=4)
    assert waits.count - w0 == 15 and dispatch.count - d0 == 6   # 4 4 ... 2


# ---- the prefetch pipeline -------------------------------------------------------
def test_prefetch_order_and_worker_thread():
    main = threading.current_thread()
    seen = set()

    def transform(x):
        seen.add(threading.current_thread())
        return x * 2

    assert list(PrefetchPipeline(iter(range(100)), transform=transform,
                                 depth=4)) == [2 * i for i in range(100)]
    assert main not in seen


def test_prefetch_is_bounded_by_depth():
    pulled = []

    def src():
        for i in range(50):
            pulled.append(i)
            yield i

    pipe = PrefetchPipeline(src, depth=3)
    it = iter(pipe)
    for k in range(5):
        assert next(it) == k
        time.sleep(0.05)        # a slow consumer
        # taken + queued (depth) + one in the worker's hands
        assert len(pulled) <= k + 1 + 3 + 1
    pipe.close()


def test_prefetch_exception_at_the_point_of_the_break():
    class Boom(RuntimeError):
        pass

    def src():
        yield 1
        yield 2
        raise Boom('reader died')

    it = iter(PrefetchPipeline(src, depth=2))
    assert next(it) == 1 and next(it) == 2
    with pytest.raises(Boom, match='reader died'):
        next(it)


def test_prefetch_shutdown_on_abandon():
    pulled = []

    def endless():
        i = 0
        while True:
            pulled.append(i)
            yield i
            i += 1

    pipe = PrefetchPipeline(endless, depth=2)
    it = iter(pipe)
    for _ in range(3):
        next(it)
    it.close()
    pipe.close()
    pipe._thread.join(5.0)
    assert not pipe._thread.is_alive()
    n = len(pulled)
    time.sleep(0.05)
    assert len(pulled) == n and n <= 3 + 2 + 2
    with pytest.raises(RuntimeError, match='single-use'):
        iter(pipe)


def test_prefetch_feeds_stage_as_tensors_on_the_place():
    with pt.program_guard(pt.Program(), pt.Program()):
        feeder = pt.DataFeeder(
            feed_list=[pt.layers.data(name='x', shape=[4]),
                       pt.layers.data(name='y', shape=[1], dtype='int64')],
            place=pt.CPUPlace())
    rng = np.random.RandomState(0)
    data = [[(rng.randn(4).astype('float32'), np.array([i], 'int64'))
             for i in range(8)] for _ in range(3)]
    out = list(prefetch_feeds(lambda: iter(data), feeder, depth=2,
                              place=pt.CPUPlace()))
    assert [n for n, _ in out] == [8, 8, 8]
    for (n, feed), batch in zip(out, data):
        assert all(isinstance(v, torch.Tensor) for v in feed.values())
        assert np.array_equal(feed['x'].numpy(),
                              np.stack([s[0] for s in batch]))
    staged = stage_on_device({'a': np.ones((2, 3), 'float32')},
                             pt.CPUPlace())
    assert torch.equal(staged['a'], torch.ones(2, 3))
    assert DeviceStager(pt.CPUPlace()).stage(
        (1, {'a': np.zeros(2)})).ready()[0] == 1
