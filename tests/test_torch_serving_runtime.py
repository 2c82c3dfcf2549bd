"""paddle_tpu_torch.serving: the serving runtime, on the CPU.

``ModelServer`` against the JAX package's ``ModelServer`` on the same
JAX-saved artifacts (a row-wise MLP and the small flagship transformer;
f32, 1e-4), then the semantics that paddle_tpu/serving documents and
tests/test_serving.py and tests/test_chaos.py time, made deterministic:
requests are ordered by pausing a model's queue and resuming it, a
wedged stage blocks on an event, the breaker runs on an injected clock
and the watchdog's scan on an explicit time; no sleep synchronises
anything, and no padded run's bits are compared with an unpadded run's.
"""
import importlib.util
import os
import threading
import time

import numpy as np
import pytest
import torch

import paddle_tpu.fluid as fluid
from paddle_tpu.serving import ModelServer as JaxModelServer
import paddle_tpu_torch as pt
from paddle_tpu_torch import io as pt_io
from paddle_tpu_torch.resilience import RetryError, retry_call
from paddle_tpu_torch.resilience import faultinject as fi
from paddle_tpu_torch.serving import (
    BucketPolicy, CircuitBreaker, CircuitOpen, DeadlineExceeded,
    InferenceRequest, MicroBatcher, ModelNotFound, ModelServer,
    ServerClosed, ServerOverloaded, WatchdogTimeout, next_pow2,
    run_bucketed)
from paddle_tpu_torch.serving.breaker import CLOSED, HALF_OPEN, OPEN

IN_DIM, OUT_DIM = 6, 3
DIMS = dict(vocab=64, d_model=32, n_heads=2, n_layers=2, d_ff=64, seq=32)
TOL = dict(atol=1e-4, rtol=1e-4)
_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# ---- artifacts --------------------------------------------------------------------
def _mlp(pkg, seed):
    main, startup = pkg.Program(), pkg.Program()
    startup.random_seed = seed
    with pkg.unique_name.guard(), pkg.program_guard(main, startup):
        x = pkg.layers.data(name='x', shape=[IN_DIM], dtype='float32')
        h = pkg.layers.fc(input=x, size=8, act='relu')
        y = pkg.layers.fc(input=h, size=OUT_DIM, act=None)
    return main, startup, y


def _save_jax_mlp(dirname, seed=7):
    main, startup, y = _mlp(fluid, seed)
    scope = fluid.Scope()
    exe = fluid.Executor(fluid.CPUPlace())
    exe.run(startup, scope=scope)
    with fluid.scope_guard(scope):
        fluid.io.save_inference_model(dirname, ['x'], [y], exe,
                                      main_program=main)
    return dirname


def _save_port_mlp(dirname, seed=7, scale=1.0):
    main, startup, y = _mlp(pt, seed)
    scope = pt.Scope()
    exe = pt.Executor(pt.CPUPlace())
    exe.run(startup, scope=scope)
    for v in main.global_block().all_parameters():
        scope.set_var(v.name, scope.raw(v.name) * scale)
    pt_io.save_inference_model(dirname, ['x'], [y], exe, main_program=main,
                               scope=scope)
    return dirname


@pytest.fixture(scope='module')
def mlp_dir(tmp_path_factory):
    return _save_jax_mlp(str(tmp_path_factory.mktemp('mlp')))


def _direct(dirname):
    """A serial reference over the same artifact: its own Executor and
    scope, unpadded."""
    scope = pt.Scope()
    exe = pt.Executor(pt.CPUPlace())
    prog, _, fetch_vars = pt_io.load_inference_model(dirname, exe,
                                                     scope=scope)
    lock = threading.Lock()

    def run(feed):
        with lock:
            return exe.run(prog, feed=feed, fetch_list=fetch_vars,
                           scope=scope)
    return run


def _x(n, seed=0):
    return {'x': np.random.RandomState(seed).randn(n, IN_DIM).astype(
        'float32')}


def _server(**kw):
    kw.setdefault('place', pt.CPUPlace())
    kw.setdefault('max_batch_size', 8)
    kw.setdefault('batch_timeout', 0.0)
    return ModelServer(**kw)


class _Clock(object):
    """A monotonic clock tests move by hand."""

    def __init__(self):
        self.t = 1000.0

    def __call__(self):
        return self.t


# ---- against the JAX package's ModelServer ----------------------------------------
def _jax_flagship_dir(tmp_path):
    spec = importlib.util.spec_from_file_location(
        '_bench_fluid_models',
        os.path.join(_ROOT, 'benchmark', 'fluid', 'models.py'))
    models = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(models)
    main, startup = fluid.Program(), fluid.Program()
    startup.random_seed = 11
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        models.transformer(None, **DIMS)
    xent, = [op for op in main.global_block().ops
             if op.type == 'softmax_with_cross_entropy']
    logits = main.global_block().var(xent.input('Logits')[0])
    scope = fluid.Scope()
    exe = fluid.Executor(fluid.CPUPlace())
    exe.run(startup, scope=scope)
    d = str(tmp_path / 'flagship')
    with fluid.scope_guard(scope):
        fluid.io.save_inference_model(d, ['data', 'pos'], [logits], exe,
                                      main_program=main)
    return d


def _tokens(n, seed):
    rng = np.random.RandomState(seed)
    return {'data': rng.randint(0, DIMS['vocab'],
                                (n, DIMS['seq'])).astype('int64'),
            'pos': np.tile(np.arange(DIMS['seq'], dtype='int64'), (n, 1))}


def test_server_matches_jax_server(mlp_dir, tmp_path):
    flagship = _jax_flagship_dir(tmp_path)
    requests = [('mlp', _x(n, seed=n)) for n in (1, 3, 5)] + \
        [('flagship', _tokens(n, seed=n)) for n in (1, 3)]
    answers = []
    for server in (JaxModelServer(place=fluid.CPUPlace(), max_batch_size=8),
                   _server()):
        with server:
            server.load_model('mlp', mlp_dir)
            server.load_model('flagship', flagship)
            answers.append([server.infer(name, feed)[0]
                            for name, feed in requests])
    for (name, feed), j, t in zip(requests, *answers):
        assert t.shape == np.asarray(j).shape
        np.testing.assert_allclose(t, np.asarray(j), err_msg=name, **TOL)


# ---- buckets ----------------------------------------------------------------------
def test_bucket_policy():
    assert [next_pow2(n) for n in (1, 2, 3, 4, 5, 8, 9, 17)] == \
        [1, 2, 4, 4, 8, 8, 16, 32]
    with pytest.raises(ValueError):
        next_pow2(0)
    p = BucketPolicy(min_bucket=2, max_bucket=16)
    assert [p.bucket_for(n) for n in (1, 2, 3, 9, 16)] == [2, 2, 4, 16, 16]
    assert p.buckets() == [2, 4, 8, 16] and p.buckets(upto=5) == [2, 4, 8]
    with pytest.raises(ValueError, match='max_bucket'):
        p.bucket_for(17)
    with pytest.raises(ValueError):
        BucketPolicy(pad_mode='reflect')


def test_run_bucketed_returns_the_bucket_runs_rows(mlp_dir):
    exe = pt.Executor(pt.CPUPlace())
    scope = pt.Scope()
    prog, _, fetch_vars = pt_io.load_inference_model(mlp_dir, exe,
                                                     scope=scope)
    feed = _x(5)
    got, = run_bucketed(exe, prog, feed, fetch_vars, scope=scope)
    for mode in ('edge', 'zero'):
        pad = feed['x'][-1:] if mode == 'edge' else np.zeros((1, IN_DIM),
                                                             'float32')
        bucket, = exe.run(prog, feed={'x': np.concatenate(
            [feed['x']] + [pad] * 3)}, fetch_list=fetch_vars, scope=scope)
        out, = run_bucketed(exe, prog, feed, fetch_vars, scope=scope,
                            policy=BucketPolicy(pad_mode=mode))
        np.testing.assert_array_equal(out, bucket[:5])
    assert got.shape == (5, OUT_DIM)
    np.testing.assert_allclose(got, _direct(mlp_dir)(feed)[0], atol=1e-6)


def test_run_bucketed_falls_back_for_fetches_reduced_over_the_batch():
    main, startup, y = _mlp(pt, 7)
    with pt.program_guard(main, startup):
        m = pt.layers.mean(y)
    exe = pt.Executor(pt.CPUPlace())
    scope = pt.Scope()
    exe.run(startup, scope=scope)
    shapes = []
    real_run = exe.run

    def run(program, feed=None, **kw):
        shapes.append(feed['x'].shape[0])
        return real_run(program, feed=feed, **kw)
    exe.run = run
    feed = _x(3)
    want, = real_run(main, feed=feed, fetch_list=[m], scope=scope)
    for _ in range(2):
        got, = run_bucketed(exe, main, feed, [m], scope=scope)
        np.testing.assert_array_equal(got, want)
    # padded once, found not row-aligned, re-run unpadded; then never
    # padded again
    assert shapes == [4, 3, 3]


# ---- the batcher ------------------------------------------------------------------
def _req(n, deadline=None, dim=IN_DIM):
    return InferenceRequest({'x': np.zeros((n, dim), 'float32')}, n,
                            deadline=deadline)


def test_batcher_fifo_with_expired_heads():
    b = MicroBatcher(max_queue_depth=8)
    past = 0.0                       # an absolute deadline long gone
    dead, live1, live2 = _req(1, past), _req(2), _req(3)
    for r in (dead, live1, live2):
        b.submit(r)
    batch, expired = b.next_batch(max_rows=8)
    assert batch == [live1, live2] and expired == [dead]
    # an incompatible head keeps FIFO order: no reordering around it
    a, odd, c = _req(1), _req(1, dim=IN_DIM + 1), _req(1)
    for r in (a, odd, c):
        b.submit(r)
    assert b.next_batch(8)[0] == [a]
    assert b.next_batch(8)[0] == [odd]
    assert b.next_batch(8)[0] == [c]
    # nothing runnable but an expired request: handed back at once
    gone = _req(1, past)
    b.submit(gone)
    assert b.next_batch(8) == ([], [gone])
    # the row cap splits batches in order
    reqs = [_req(3) for _ in range(3)]
    for r in reqs:
        b.submit(r)
    assert b.next_batch(max_rows=6)[0] == reqs[:2]
    assert b.next_batch(max_rows=6)[0] == reqs[2:]
    b.close()
    assert b.next_batch(8) == (None, [])
    with pytest.raises(ServerClosed):
        b.submit(_req(1))


def test_server_coalesces_a_paused_queue_in_order(mlp_dir):
    expected = _direct(mlp_dir)
    with _server() as server:
        server.load_model('m', mlp_dir)
        server.pause('m')
        feeds = [_x(n, seed=10 + i) for i, n in enumerate((1, 2, 3, 3))]
        reqs = [server.submit('m', f) for f in feeds]
        assert server.queue_depth('m') == 4
        server.resume('m')
        outs = [r.result(timeout=30)[0] for r in reqs]
        stats = server.stats_dict()
    for f, out in zip(feeds, outs):
        np.testing.assert_allclose(out, expected(f)[0], atol=1e-6)
    # 1+2+3 rows make one bucket-8 batch (3 more would pass 8 rows);
    # the last 3 rows a bucket of 4
    assert stats['batches']['count'] == 2
    assert stats['batches']['bucket_counts'] == {8: 1, 4: 1}
    assert stats['batches']['by_model'] == {'m': 2}
    assert stats['requests']['completed'] == 4


# ---- failures ---------------------------------------------------------------------
def test_mid_batch_failure_fails_exactly_that_batch(mlp_dir):
    expected = _direct(mlp_dir)
    with _server(max_batch_size=4, retry_attempts=1) as server, \
            fi.fault_plan() as plan:
        server.load_model('m', mlp_dir)
        plan.inject(fi.SITE_SERVING_RUN, at=[0])
        server.pause('m')
        first = [server.submit('m', _x(2, seed=s)) for s in (1, 2)]
        last = server.submit('m', _x(4, seed=3))
        server.resume('m')
        for r in first:
            with pytest.raises(RetryError) as err:
                r.result(timeout=30)
            assert isinstance(err.value.last_error, fi.FaultInjected)
        np.testing.assert_allclose(last.result(timeout=30)[0],
                                   expected(_x(4, seed=3))[0], atol=1e-6)
        assert server.stats.failed == 2 and server.stats.completed == 1
        assert server.breaker('m').state == CLOSED


def test_deadline_overload_and_retry(mlp_dir):
    with _server(max_queue_depth=2, retry_attempts=2,
                 retry_backoff=0.0) as server, fi.fault_plan() as plan:
        server.load_model('m', mlp_dir)
        server.pause('m')
        late = server.submit('m', _x(1), deadline=-1.0)
        ok = server.submit('m', _x(1))
        with pytest.raises(ServerOverloaded):
            server.submit('m', _x(1))
        plan.inject(fi.SITE_SERVING_RUN, times=1)   # one transient fault
        server.resume('m')
        with pytest.raises(DeadlineExceeded):
            late.result(timeout=30)
        assert ok.result(timeout=30)[0].shape == (1, OUT_DIM)
        s = server.stats
        assert (s.expired, s.shed, s.retries, s.completed, s.failed) == \
            (1, 1, 1, 1, 0)
        with pytest.raises(ValueError, match='max_batch_size'):
            server.submit('m', _x(9))
        with pytest.raises(ModelNotFound):
            server.submit('nope', _x(1))


def test_retry_gives_up_before_overshooting_a_deadline():
    calls, sleeps = [], []

    def flaky():
        calls.append(1)
        raise OSError('transient')
    with pytest.raises(RetryError) as err:
        retry_call(flaky, max_attempts=5, backoff=10.0, jitter=0.0,
                   sleep=sleeps.append, deadline=0.0)
    assert err.value.deadline_exceeded and len(calls) == 1 and not sleeps
    with pytest.raises(RetryError) as err:
        retry_call(flaky, max_attempts=3, backoff=0.5, jitter=0.0,
                   sleep=sleeps.append)
    assert err.value.attempts == 3 and sleeps == [0.5, 1.0]


def test_breaker_state_machine():
    clock = _Clock()
    seen = []
    b = CircuitBreaker('m', failure_threshold=2, window=4, failure_rate=0.5,
                       cooldown=5.0, probe_successes=2, max_probes=1,
                       clock=clock,
                       on_transition=lambda *a: seen.append(a[1:]))
    assert b.admit() is False
    b.record_failure()
    assert b.state == CLOSED
    b.record_failure()
    assert b.state == OPEN
    with pytest.raises(CircuitOpen) as err:
        b.admit()
    assert err.value.retry_after == 5.0
    clock.t += 4.999
    assert b.state == OPEN
    clock.t += 0.001
    assert b.state == HALF_OPEN
    assert b.admit() is True                 # the one probe slot
    with pytest.raises(CircuitOpen):
        b.admit()
    b.record_failure()                       # a failed probe re-opens
    assert b.state == OPEN
    clock.t += 5.0
    assert b.admit() is True
    b.record_success()
    assert b.admit() is True
    b.record_success()
    assert b.state == CLOSED
    assert [t for t, _ in b.transitions] == [OPEN, HALF_OPEN, OPEN,
                                             HALF_OPEN, CLOSED]
    assert [t for t, _ in seen] == [t for t, _ in b.transitions]
    # the windowed rate opens it without a consecutive run
    for ok in (True, False, True, False):
        (b.record_success if ok else b.record_failure)()
    assert b.state == OPEN and 'rate' in b.transitions[-1][1]


def test_server_breaker_sheds_at_admission(mlp_dir):
    clock = _Clock()
    with _server(retry_attempts=1, breaker_config=dict(
            failure_threshold=2, cooldown=1.0, probe_successes=1,
            clock=clock)) as server, fi.fault_plan() as plan:
        server.load_model('m', mlp_dir)
        plan.inject(fi.SITE_SERVING_RUN, times=2)
        for _ in range(2):
            with pytest.raises(RetryError):
                server.infer('m', _x(1))
        assert server.health()['models']['m']['state'] == 'open'
        assert server.load_score('m') == float('inf')
        with pytest.raises(CircuitOpen):
            server.submit('m', _x(1))
        assert server.stats.breaker_rejected == 1
        clock.t += 1.0
        assert server.infer('m', _x(1))[0].shape == (1, OUT_DIM)  # probe
        assert server.breaker('m').state == CLOSED
        assert server.health()['models']['m']['state'] == 'ready'


def _wedge(plan, site=fi.SITE_SERVING_RUN):
    """The next hit of ``site`` blocks until released: (entered,
    release) events."""
    entered, release = threading.Event(), threading.Event()

    def block():
        entered.set()
        assert release.wait(60)
    plan.inject(site, error=None, at=[0], action=block)
    return entered, release


def test_watchdog_fails_a_hung_batch(mlp_dir):
    """The scan is driven with an explicit time past the stage's
    deadline; the watchdog's own thread, on the real clock, never
    reaches that deadline during the test."""
    server = _server(stage_timeouts={fi.SITE_SERVING_RUN: 600.0})
    with fi.fault_plan() as plan:
        server.load_model('m', mlp_dir)
        entered, release = _wedge(plan)
        req = server.submit('m', _x(1))
        assert entered.wait(30)
        tripped = server.watchdog.check(now=time.monotonic() + 601.0)
        assert [e['stage'] for e in tripped] == [fi.SITE_SERVING_RUN]
        with pytest.raises(WatchdogTimeout):
            req.result(timeout=30)
        h = server.health()['models']['m']
        assert (h['state'], h['wedged'], h['watchdog_trips']) == \
            ('open', True, 1)
        assert server.stats.watchdog_trips == 1 and server.stats.failed == 1
        release.set()
    server.close(timeout=30)
    assert server.stats.completed == 0    # the late result was disclaimed


def test_close_escalates_against_a_wedged_worker(mlp_dir):
    server = _server()
    with fi.fault_plan() as plan:
        server.load_model('m', mlp_dir)
        entered, release = _wedge(plan)
        inflight = server.submit('m', _x(1))
        assert entered.wait(30)
        queued = server.submit('m', _x(2))
        server.close(timeout=0.0)
        for r in (inflight, queued):
            with pytest.raises(ServerClosed):
                r.result(timeout=30)
        assert server.stats.cancelled == 1
        assert server.health()['status'] == 'closed'
        with pytest.raises(ServerClosed):
            server.submit('m', _x(1))
        release.set()


# ---- lifecycle --------------------------------------------------------------------
def test_drain_completes_the_queue_then_unloads(mlp_dir):
    expected = _direct(mlp_dir)
    with _server() as server:
        server.load_model('m', mlp_dir)
        server.pause('m')
        feeds = [_x(n, seed=n) for n in (1, 2, 3)]
        reqs = [server.submit('m', f) for f in feeds]
        model = server.drain('m')
        assert model.name == 'm' and server.models() == []
        for f, r in zip(feeds, reqs):
            np.testing.assert_allclose(r.result(timeout=0)[0],
                                       expected(f)[0], atol=1e-6)
        with pytest.raises(ModelNotFound):
            server.submit('m', _x(1))


def test_swap_model_keeps_the_queue_and_rolls_back(tmp_path):
    v1 = _save_port_mlp(str(tmp_path / 'v1'))
    v2 = _save_port_mlp(str(tmp_path / 'v2'), scale=2.0)
    bad = _save_port_mlp(str(tmp_path / 'bad'))
    os.remove(os.path.join(bad, '__params__.npz'))
    want1, want2 = _direct(v1), _direct(v2)
    feed = _x(2)
    assert not np.allclose(want1(feed)[0], want2(feed)[0])
    with _server() as server, fi.fault_plan() as plan:
        server.load_model('m', v1)
        server.pause('m')
        queued = server.submit('m', feed)
        server.swap_model('m', v2)
        server.resume('m')
        np.testing.assert_allclose(queued.result(timeout=30)[0],
                                   want2(feed)[0], atol=1e-6)
        # a bad deploy raises and the model in service stays
        with pytest.raises(IOError):
            server.swap_model('m', bad)
        plan.inject(fi.SITE_SERVING_LOAD,
                    at=[plan.hits[fi.SITE_SERVING_LOAD]])   # the next hit
        with pytest.raises(fi.FaultInjected):
            server.swap_model('m', v1)
        np.testing.assert_allclose(server.infer('m', feed)[0],
                                   want2(feed)[0], atol=1e-6)


def test_registry_isolates_models(tmp_path):
    """Two artifacts whose parameters share every name serve side by
    side, each from its own scope."""
    a = _save_port_mlp(str(tmp_path / 'a'))
    b = _save_port_mlp(str(tmp_path / 'b'), seed=8)
    feed = _x(3)
    with _server() as server:
        server.load_model('a', a)
        server.load_model('b', b)
        ma, mb = server.registry.get('a'), server.registry.get('b')
        assert ma.scope is not mb.scope
        assert sorted(n for n in ma.scope.vars if n != '__rng__') == \
            sorted(n for n in mb.scope.vars if n != '__rng__')
        np.testing.assert_allclose(server.infer('a', feed)[0],
                                   _direct(a)(feed)[0], atol=1e-6)
        np.testing.assert_allclose(server.infer('b', feed)[0],
                                   _direct(b)(feed)[0], atol=1e-6)
        assert len(server.registry) == 2 and 'a' in server.registry


def test_warmup_runs_one_bucket_at_a_time(mlp_dir, tmp_path):
    """Each bucket's warmup request completes before the next bucket's
    is submitted, and with autotune=True before the next bucket's search
    starts (the reference's autotuned warmup submits ahead and races the
    worker on the model's scope)."""
    from paddle_tpu_torch.compiler import tuning
    prev = tuning.set_default_cache(
        tuning.TuningCache(str(tmp_path / 'tuning.json')))
    try:
        with _server() as server:
            server.load_model('m', mlp_dir)
            events, depths = [], []
            real = server._exe_run

            def run(model, feed):
                depths.append(server.queue_depth('m'))
                events.append(('run', feed['x'].shape[0]))
                return real(model, feed)
            server._exe_run = run
            assert server.warmup() == {'m': [1, 2, 4, 8]}
            assert events == [('run', n) for n in (1, 2, 4, 8)]
            assert depths == [0, 0, 0, 0]
            real_tune = tuning.Autotuner.tune

            def tune(tuner, program, feed, *args, **kwargs):
                # the previous bucket's request is done: nothing queued
                # and the worker is not inside a run
                depths.append(server.queue_depth('m'))
                events.append(('search', feed['x'].shape[0]))
                return real_tune(tuner, program, feed, *args, **kwargs)
            del events[:], depths[:]
            tuning.Autotuner.tune = tune
            try:
                assert server.warmup(autotune=True) == {'m': [1, 2, 4, 8]}
            finally:
                tuning.Autotuner.tune = real_tune
            assert events == [(kind, n) for n in (1, 2, 4, 8)
                              for kind in ('search', 'run')]
            assert depths == [0] * 8
            server.executor.reset_cache_info()
            for n in (1, 3, 5, 8):
                server.infer('m', _x(n))
            info = server.cache_info()
            assert info.misses == 0 and info.hits == 4
    finally:
        tuning.set_default_cache(prev)


def test_served_rows_equal_a_direct_run_padded_to_their_bucket(mlp_dir):
    """The server's rows are the rows of a direct run of the same feed
    padded to the bucket it ran (bit for bit): a served answer differs
    from an unpadded direct run only as the batch size does, as
    SERVING.md states for XLA's per-batch-size kernels."""
    from paddle_tpu_torch.serving.bucketing import pad_feed
    scope = pt.Scope()
    exe = pt.Executor(pt.CPUPlace())
    prog, _, fetch = pt_io.load_inference_model(mlp_dir, exe, scope=scope)
    with _server() as server:
        server.load_model('m', mlp_dir)
        server.pause('m')
        feeds = [_x(n, seed=40 + n) for n in (1, 2, 2)]   # one batch of 5
        reqs = [server.submit('m', f) for f in feeds]
        server.resume('m')
        outs = [r.result(timeout=30)[0] for r in reqs]
    assert server.stats.bucket_counts == {8: 1}
    merged = {'x': np.concatenate([f['x'] for f in feeds])}
    padded, = exe.run(prog, feed=pad_feed(merged, 5, 8, 'edge'),
                      fetch_list=fetch, scope=scope)
    alone = [exe.run(prog, feed=pad_feed(f, f['x'].shape[0], 8, 'edge'),
                     fetch_list=fetch, scope=scope)[0] for f in feeds]
    start = 0
    for f, out, own in zip(feeds, outs, alone):
        n = f['x'].shape[0]
        np.testing.assert_array_equal(out, padded[start:start + n])
        np.testing.assert_array_equal(out, own[:n])
        start += n


def test_concurrent_clients_get_their_own_rows(mlp_dir):
    expected = _direct(mlp_dir)
    errors, done = [], []
    with _server(batch_timeout=0.001) as server:
        server.load_model('m', mlp_dir)
        server.warmup()
        warm_rows = server.stats.batched_rows

        def client(k):
            try:
                for i, n in enumerate((1, 2, 3, 5)):
                    feed = _x(n, seed=10 * k + i)
                    out, = server.infer('m', feed)
                    np.testing.assert_allclose(out, expected(feed)[0],
                                               atol=1e-6)
                    done.append(n)
            except Exception as e:          # noqa: BLE001
                errors.append(e)
        threads = [threading.Thread(target=client, args=(k,))
                   for k in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
        s = server.stats_dict()
    assert not errors and len(done) == 16
    assert s['requests']['completed'] == 16 and s['requests']['failed'] == 0
    assert s['batches']['rows'] - warm_rows == 4 * 11


def test_server_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match='CUDA is not available'):
        ModelServer()
    with pytest.raises(NotImplementedError, match='Queue A item 1'):
        ModelServer(place=pt.CPUPlace(), partitioner=object())
