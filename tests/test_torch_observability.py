"""paddle_tpu_torch.observability: the metrics registry, the run journal
and tracing, on the CPU, and their wiring into the port's compiler,
Executor and serving runtime.

The unit tests are the port's counterparts of tests/test_observability.py
and tests/test_tracing.py (the parts about metrics, the journal and
tracing). The parity tests hold the wiring to the JAX package's: one
program through both packages' default pipelines gives the same
``compile_pass`` events, field for field but ``dur_s``; one seeded
request sequence through both packages' ModelServers gives the same
serving event types and counts, span kinds and registry series.
"""
import collections
import json
import os
import sys
import threading
import time

import numpy as np
import pytest

import paddle_tpu.fluid as fluid
from paddle_tpu import observability as jobs
from paddle_tpu.models.resnet import resnet_imagenet as jax_resnet
from paddle_tpu.serving import ModelServer as JaxModelServer
import paddle_tpu_torch as pt
from paddle_tpu_torch import observability as obs
from paddle_tpu_torch.compiler import tuning
from paddle_tpu_torch.models.resnet import resnet_imagenet as pt_resnet
from paddle_tpu_torch.observability import flight, perf, tracing
from paddle_tpu_torch.observability.metrics import MetricsRegistry
from paddle_tpu_torch.serving import ModelServer

sys.path.insert(0, os.path.join(os.path.dirname(__file__), '..', 'tools'))
import obs_report  # noqa: E402  (tools/ has no package __init__)
import trace_report  # noqa: E402

IN_DIM, OUT_DIM = 6, 3


@pytest.fixture(autouse=True)
def _isolated(monkeypatch, tmp_path):
    """No ambient tracing environment, and a throwaway tuning cache
    (never a file under ~/.cache)."""
    for env in (obs.TRACE_SAMPLE_ENV, obs.TRACE_PARENT_ENV,
                obs.JOURNAL_ENV, flight.FLIGHT_ENV):
        monkeypatch.delenv(env, raising=False)
    prev = tuning.set_default_cache(
        tuning.TuningCache(str(tmp_path / 'tuning.json')))
    yield
    tuning.set_default_cache(prev)


@pytest.fixture(scope='module')
def mlp_dir(tmp_path_factory):
    """A row-wise MLP saved by the JAX package; both servers load it."""
    main, startup = fluid.Program(), fluid.Program()
    startup.random_seed = 7
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        x = fluid.layers.data(name='x', shape=[IN_DIM], dtype='float32')
        h = fluid.layers.fc(input=x, size=8, act='relu')
        y = fluid.layers.fc(input=h, size=OUT_DIM, act=None)
    scope = fluid.Scope()
    exe = fluid.Executor(fluid.CPUPlace())
    exe.run(startup, scope=scope)
    d = str(tmp_path_factory.mktemp('mlp'))
    with fluid.scope_guard(scope):
        fluid.io.save_inference_model(d, ['x'], [y], exe,
                                      main_program=main)
    return d


def _x(n, seed=0):
    return {'x': np.random.RandomState(seed).randn(n, IN_DIM).astype(
        'float32')}


def _server(**kw):
    kw.setdefault('place', pt.CPUPlace())
    kw.setdefault('max_batch_size', 8)
    kw.setdefault('batch_timeout', 0.0)
    return ModelServer(**kw)


def _spans(path, ev='span_end'):
    recs, malformed = obs.read_journal(path)
    assert malformed == 0
    return [r for r in recs if r['ev'] == ev]


# ---- metrics registry -------------------------------------------------------------
def test_registry_counter_gauge_histogram():
    reg = MetricsRegistry()
    c = reg.counter('widgets_total', 'widgets made')
    c.inc()
    c.inc(4)
    assert c.value == 5
    with pytest.raises(ValueError):
        c.inc(-1)
    g = reg.gauge('queue_depth', 'current depth')
    g.set(3.5)
    assert g.value == 3.5
    h = reg.histogram('latency_seconds', 'op latency')
    for v in (0.0001, 0.001, 0.01, 2.0):
        h.observe(v, exemplar='trace-%g' % v)
    assert h.count == 4 and abs(h.sum - 2.0111) < 1e-9
    assert h.quantile(0.5) <= h.quantile(1.0)
    assert h.exemplar(1.0) == ('trace-2', 2.0)
    assert reg.counter('widgets_total') is c
    with pytest.raises(ValueError):
        reg.gauge('widgets_total')
    snap = reg.snapshot()
    assert snap['widgets_total']['series'][0]['value'] == 5
    hs = snap['latency_seconds']['series'][0]
    assert hs['count'] == 4 and hs['buckets']['+Inf'] == 4
    json.dumps(snap)
    text = reg.exposition()
    assert '# TYPE widgets_total counter' in text
    assert 'widgets_total 5' in text
    assert 'latency_seconds_bucket{le="+Inf"} 4' in text
    assert 'latency_seconds_count 4' in text


def test_registry_labels_reset_and_escaping():
    reg = MetricsRegistry()
    a = reg.counter('span_seconds_total', 'spans', span='pad')
    b = reg.counter('span_seconds_total', 'spans', span='run')
    assert a is not b
    a.inc(2)
    b.inc(3)
    reg.counter('odd_total', kind='a"b\\c\nd').inc()
    text = reg.exposition()
    assert 'span_seconds_total{span="pad"} 2' in text
    assert 'span_seconds_total{span="run"} 3' in text
    assert 'odd_total{kind="a\\"b\\\\c\\nd"} 1' in text
    reg.reset()
    assert a.value == 0 and b.value == 0
    assert reg.counter('span_seconds_total', span='pad') is a


def test_registry_thread_safety():
    reg = MetricsRegistry()
    c = reg.counter('hits_total')
    h = reg.histogram('obs_seconds')
    prev = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def worker():
            for _ in range(1000):
                c.inc()
                h.observe(0.001)
        threads = [threading.Thread(target=worker) for _ in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(prev)
    assert c.value == 16000 and h.count == 16000


def test_registry_remove_series():
    reg = MetricsRegistry()
    reg.gauge('replica_state', 'state', replica='0').set(1)
    reg.gauge('replica_state', 'state', replica='1').set(1)
    assert reg.remove('replica_state', replica='1')
    assert reg.get('replica_state', replica='1') is None
    assert reg.get('replica_state', replica='0').value == 1
    assert not reg.remove('replica_state', replica='9')
    assert reg.remove_matching('replica_state') == 1


# ---- run journal ------------------------------------------------------------------
def test_journal_roundtrip(tmp_path):
    path = str(tmp_path / 'run.jsonl')
    with obs.RunJournal(path, run_id='testrun') as j:
        j.record('serving_batch', rows=1, bucket=1, dur_s=0.01)
        with j.span('compile_end', fp='abc'):
            pass
        j.record('anomaly', value=np.float32(7.0))   # numpy coerces
    records, malformed = obs.read_journal(path)
    assert malformed == 0
    assert [r['ev'] for r in records] == \
        ['run_begin', 'serving_batch', 'compile_end', 'anomaly']
    assert all(r['run'] == 'testrun' for r in records)
    assert records[0]['schema'] == obs.SCHEMA_VERSION
    ts = [r['t'] for r in records]
    assert ts == sorted(ts)
    assert records[2]['dur_s'] >= 0.0 and records[3]['value'] == 7.0
    j.record('serving_batch', rows=2)        # after close: dropped
    assert len(obs.read_journal(path)[0]) == 4


def test_journal_install_emit_and_flight_ring(tmp_path):
    path = str(tmp_path / 'run.jsonl')
    flight.clear()
    assert not obs.journal_active()
    obs.emit('serving_admit', n=1)           # no journal: ring only
    with obs.journal(path) as j:
        assert obs.get_journal() is j
        obs.emit('serving_admit', n=2)
    assert not obs.journal_active()
    records, _ = obs.read_journal(path)
    assert [r['ev'] for r in records] == ['run_begin', 'serving_admit']
    assert records[1]['n'] == 2
    assert [r['n'] for r in flight.ring() if
            r['ev'] == 'serving_admit'][-2:] == [1, 2]


def test_rotation_preserves_wall_anchor(tmp_path):
    p = str(tmp_path / 'rot.jsonl')
    j = obs.RunJournal(p, max_bytes=4096, buffer_lines=8)
    wall0 = j._wall0
    i = 0
    while j.rotations == 0:
        j.record('serving_batch', step=i, dur_s=0.001)
        i += 1
        assert i < 10000, 'journal never rotated'
    for _ in range(5):
        j.record('serving_batch', step=i, dur_s=0.001)
        i += 1
    j.close()
    live, _ = obs.read_journal(p)
    rolled, _ = obs.read_journal(p + '.1')
    assert live[0]['ev'] == 'run_begin' and live[0]['wall'] == wall0
    assert live[0]['rotated'] == 1 and rolled[0]['wall'] == wall0
    steps = [r['step'] for r in rolled + live if r['ev'] == 'serving_batch']
    assert steps == list(range(i))


def test_flight_trip_dumps_a_bundle_only_when_configured(tmp_path):
    flight.clear()
    assert flight.trip('unit') is None       # no directory: no file
    prev = flight.configure(str(tmp_path))
    try:
        with obs.journal(str(tmp_path / 'j.jsonl')):
            sp = obs.start_span('open/work')
            path = flight.trip('unit_test', model='m')
            sp.end()
    finally:
        flight.configure(prev)
    bundle = flight.read_bundle(path)
    assert bundle['reason'] == 'unit_test'
    assert bundle['context'] == {'model': 'm'}
    assert [s['name'] for s in bundle['live_spans']] == ['open/work']
    # the health slot holds the live providers' merged document (the
    # telemetry plane's collect_health); the ledgers slot the
    # performance observatory's book
    assert set(bundle['health']) >= {'status', 'pid', 'providers'}
    assert bundle['ledgers'] == [l.as_dict() for l in sorted(
        perf.ledgers(), key=lambda l: l.bytes_accessed, reverse=True)][:16]
    assert 'tracing_spans_started_total' in bundle['metrics']


# ---- tracing ----------------------------------------------------------------------
def test_null_span_without_journal():
    assert not obs.journal_active()
    sp = obs.start_span('x')
    assert sp is obs.NULL_SPAN and sp.context is None
    sp.end(ok=True)
    with obs.span('y') as sp2:
        assert sp2 is obs.NULL_SPAN
    assert obs.current_context() is None
    assert obs.emit_span('z', 0.01) is None


def test_span_nesting_and_thread_local(tmp_path):
    p = str(tmp_path / 'j.jsonl')
    seen = []
    with obs.journal(p):
        with obs.span('outer') as outer:
            octx = outer.context
            t = threading.Thread(
                target=lambda: seen.append(obs.current_span()))
            t.start()
            t.join(timeout=30)
            with obs.span('inner') as inner:
                assert inner.context.trace_id == octx.trace_id
                assert inner.context.parent_id == octx.span_id
            assert obs.current_span() is outer
        assert obs.current_span() is None
    assert seen == [None]                    # spans are per thread
    ends = {r['name']: r for r in _spans(p)}
    assert ends['inner']['parent'] == ends['outer']['span']
    assert ends['outer']['parent'] is None


def test_span_end_idempotent_and_error_field(tmp_path):
    p = str(tmp_path / 'j.jsonl')
    with obs.journal(p):
        sp = obs.start_span('once')
        sp.end(ok=True)
        sp.end(ok=False)
        with pytest.raises(ValueError):
            with obs.span('boom'):
                raise ValueError('x')
    ends = _spans(p)
    once = [r for r in ends if r['name'] == 'once']
    assert len(once) == 1 and once[0]['ok'] is True
    assert [r['error'] for r in ends if r['name'] == 'boom'] == \
        ['ValueError']


def test_header_roundtrip():
    ctx = tracing.TraceContext('a' * 16, 'b' * 16, None, True)
    back = tracing.TraceContext.from_header(ctx.to_header())
    assert (back.trace_id, back.span_id, back.sampled) == \
        (ctx.trace_id, ctx.span_id, True)
    off = tracing.TraceContext('c' * 16, 'd' * 16, None, False)
    assert tracing.TraceContext.from_header(off.to_header()).sampled \
        is False
    for bad in (None, '', 'garbage', 'a-b', '--0', 'a-b-c-d'):
        assert tracing.TraceContext.from_header(bad) is None
    got = obs.parent_from_env({obs.TRACE_PARENT_ENV: ctx.to_header()})
    assert got.trace_id == ctx.trace_id
    assert obs.parent_from_env({}) is None


def test_sampling_deterministic_hash(monkeypatch):
    monkeypatch.setenv(obs.TRACE_SAMPLE_ENV, '0.5')
    ids = ['%016x' % (i * 0x9e3779b97f4a7c15 % (1 << 64))
           for i in range(64)]
    first = [tracing._sampled(t) for t in ids]
    assert [tracing._sampled(t) for t in ids] == first
    assert any(first) and not all(first)
    monkeypatch.setenv(obs.TRACE_SAMPLE_ENV, 'not-a-number')
    assert tracing.sample_rate() == 1.0


def test_sampling_zero_no_span_events_metrics_intact(tmp_path, monkeypatch,
                                                     mlp_dir):
    monkeypatch.setenv(obs.TRACE_SAMPLE_ENV, '0')
    p = str(tmp_path / 'j.jsonl')
    reg = obs.default_registry()
    with obs.journal(p):
        root = obs.start_span('root')
        assert root.context.sampled is False
        child = obs.start_span('child', parent=root)
        assert child.context is tracing._UNSAMPLED
        child.end()
        root.end()
        before = reg.counter('serving_requests_completed_total').value
        with _server(max_batch_size=4) as srv:
            srv.load_model('m', mlp_dir)
            out, = srv.infer('m', _x(2))
            assert out.shape == (2, OUT_DIM)
        after = reg.counter('serving_requests_completed_total').value
    by_ev = collections.Counter(r['ev'] for r in obs.read_journal(p)[0])
    assert not {'span_begin', 'span_end', 'span_link'} & set(by_ev)
    assert after == before + 1 and by_ev['serving_batch'] >= 1


def test_trace_report_quantiles_and_attribution(tmp_path):
    p = str(tmp_path / 'j.jsonl')
    with obs.journal(p):
        for i in range(20):
            with obs.span('serving/request', idx=i) as sp:
                obs.emit_span('serving/queue', 0.001 * (i + 1), parent=sp)
                time.sleep(0.002 if i == 19 else 0.0)
    store = trace_report.build_store([p])
    reqs = store.by_kind('serving/request')['serving/request']
    ordered = sorted(reqs, key=lambda s: s['dur_s'])
    assert trace_report._quantile(ordered, 0.99) is ordered[-1]
    summary = trace_report.summarize(store, kind='serving/request')
    assert summary['attribution']['count'] == 20


# ---- wiring: Executor -------------------------------------------------------------
def _infer_program():
    main, startup = pt.Program(), pt.Program()
    with pt.unique_name.guard(), pt.program_guard(main, startup):
        x = pt.layers.data(name='x', shape=[4], dtype='float32')
        y = pt.layers.fc(input=x, size=3, act='relu')
    return main, startup, y


def test_executor_metrics_journal_and_reset(tmp_path):
    main, startup, y = _infer_program()
    exe = pt.Executor(pt.CPUPlace())
    reg = obs.default_registry()
    hits0 = reg.counter('executor_cache_hits_total').value
    misses0 = reg.counter('executor_cache_misses_total').value
    runs0 = reg.histogram('executor_run_seconds').count
    path = str(tmp_path / 'run.jsonl')
    feed = {'x': np.ones((2, 4), 'float32')}
    scope = pt.Scope()
    with obs.journal(path):
        exe.run(startup, scope=scope)
        exe.run(main, feed=feed, fetch_list=[y], scope=scope)
        exe.run(main, feed=feed, fetch_list=[y], scope=scope)
    assert exe.cache_info() == (1, 2, 2)
    assert reg.counter('executor_cache_hits_total').value == hits0 + 1
    assert reg.counter('executor_cache_misses_total').value == misses0 + 2
    assert reg.histogram('executor_run_seconds').count == runs0 + 3
    assert 0.0 < reg.gauge('executor_cache_hit_rate').value < 1.0
    records, malformed = obs.read_journal(path)
    assert malformed == 0
    runs = [r for r in records if r['ev'] == 'exe_run']
    assert [r['cache'] for r in runs] == ['miss', 'miss', 'hit']
    compiles = [r for r in records if r['ev'] == 'compile_end']
    assert len(compiles) == 2 and all('fp' in r for r in compiles)
    assert [r['ev'] for r in records].count('compile_pass') == \
        2 * len(pt.compiler.DEFAULT_PASSES)
    # bare runs open no span; under a parent, the Executor's spans nest
    assert not [r for r in records if r['ev'] == 'span_end']
    exe.reset_cache_info()
    assert exe.cache_info() == (0, 0, 2)
    with obs.journal(path):
        with obs.span('caller'):
            exe.run(main, feed=feed, fetch_list=[y], scope=scope)
    ends = {r['name']: r for r in _spans(path)}
    assert set(ends) == {'caller', 'exe/run', 'exe/dispatch', 'exe/fetch'}
    assert ends['exe/run']['parent'] == ends['caller']['span']
    for child in ('exe/dispatch', 'exe/fetch'):
        assert ends[child]['parent'] == ends['exe/run']['span']


# ---- wiring: serving --------------------------------------------------------------
def test_serving_journal_registry_and_span_trees(tmp_path, mlp_dir):
    path = str(tmp_path / 'serve.jsonl')
    reg = obs.default_registry()
    sub0 = reg.counter('serving_requests_submitted_total').value
    with obs.journal(path):
        with _server() as srv:
            srv.load_model('m0', mlp_dir)
            srv.warmup()
            for n in (1, 3, 5, 8):
                out, = srv.infer('m0', _x(n, seed=n))
                assert out.shape == (n, OUT_DIM)
            # one coalesced batch of three requests
            srv.pause('m0')
            reqs = [srv.submit('m0', _x(1, seed=10 + i)) for i in range(3)]
            srv.resume('m0')
            for r in reqs:
                r.result(timeout=30)
    records, malformed = obs.read_journal(path)
    assert malformed == 0
    batches = [r for r in records if r['ev'] == 'serving_batch']
    assert batches and all(r['bucket'] >= r['rows'] for r in batches)
    # the warm-up's four requests are admitted too
    assert reg.counter('serving_requests_submitted_total').value == \
        sub0 + 4 + 7
    assert 'serving_request_seconds' in reg.exposition()
    assert [r['ev'] for r in records].count('serving_warmup') == 1
    assert obs_report.check_journal(path, require='serving') == []
    assert obs_report.check_journal(path, require='tracing') == []
    assert 'serving:' in obs_report.render(
        obs_report.summarize(records, malformed))
    # every served request has a closed tree: request -> queue, and the
    # batch (child or link) -> pad, run -> exe/run
    store = trace_report.build_store([path])
    requests = store.by_kind('serving/request')['serving/request']
    assert len(requests) == 7             # warm-up requests are untraced
    assert not store.unclosed()
    for req in requests:
        names = [store.spans[i]['name'] for i in
                 store.subtree_ids(req['span'], follow_links=True)]
        for kind in ('serving/queue', 'serving/batch', 'serving/pad',
                     'serving/run', 'exe/run', 'exe/dispatch'):
            assert kind in names, (kind, names)
    linked = {b for r in reqs for b in store.links.get(
        r.trace.span_id, [])}
    assert len(linked) == 1                # three requests, one batch


def test_submit_under_a_callers_trace(tmp_path, mlp_dir, monkeypatch):
    """A caller's TraceContext (here from the PTPU_TRACE_PARENT header a
    parent process sets) parents the serving/request span."""
    p = str(tmp_path / 'j.jsonl')
    parent = tracing.TraceContext('ab' * 8, 'cd' * 8, None, True)
    monkeypatch.setenv(obs.TRACE_PARENT_ENV, parent.to_header())
    with obs.journal(p):
        with _server() as srv:
            srv.load_model('m', mlp_dir)
            req = srv.submit('m', _x(2), trace=obs.parent_from_env())
            req.result(timeout=30)
    request, = [r for r in _spans(p) if r['name'] == 'serving/request']
    assert request['trace'] == parent.trace_id
    assert request['parent'] == parent.span_id
    assert req.trace.span_id == request['span']


def test_modelserver_close_flushes_journal(tmp_path, mlp_dir):
    p = str(tmp_path / 'j.jsonl')
    j = obs.RunJournal(p, buffer_lines=1 << 20, flush_interval=1e9)
    prev = obs.set_journal(j)
    try:
        srv = _server(max_batch_size=4)
        srv.load_model('m', mlp_dir)
        srv.infer('m', _x(1))
        assert _spans(p) == []
        srv.close()
        assert 'serving/request' in {r['name'] for r in _spans(p)}
    finally:
        obs.set_journal(prev)
        j.close()


# ---- parity with paddle_tpu -------------------------------------------------------
def _resnet(pkg, resnet):
    main, startup = pkg.Program(), pkg.Program()
    with pkg.unique_name.guard(), pkg.program_guard(main, startup):
        img = pkg.layers.data(name='img', shape=[3, 32, 32], dtype='float32')
        out = resnet(img, 10, depth=50, is_test=True)
    return main, out


def _chain(pkg):
    main, startup = pkg.Program(), pkg.Program()
    with pkg.unique_name.guard(), pkg.program_guard(main, startup):
        x = pkg.layers.data(name='x', shape=[16], dtype='float32')
        h = pkg.layers.fc(input=x, size=16, act=None)
        h = pkg.layers.relu(pkg.layers.scale(h, scale=2.0, bias=1.0))
        out = pkg.layers.elementwise_add(pkg.layers.sigmoid(h), x)
    return main, out


def _pass_events(path):
    return [{k: v for k, v in r.items() if k not in ('dur_s', 't', 'run')}
            for r in (jobs.read_journal(path)[0]) if r['ev'] == 'compile_pass']


@pytest.mark.parametrize('build', ['resnet50', 'chain'])
def test_compile_pass_events_match_paddle_tpu(tmp_path, build):
    progs = {'jax': _resnet(fluid, jax_resnet), 'port':
             _resnet(pt, pt_resnet)} if build == 'resnet50' else \
        {'jax': _chain(fluid), 'port': _chain(pt)}
    events = {}
    for side, (mod_obs, compiler) in (('jax', (jobs, fluid.compiler)),
                                      ('port', (obs, pt.compiler))):
        main, out = progs[side]
        path = str(tmp_path / ('%s.jsonl' % side))
        with mod_obs.journal(path):
            compiler.optimize(main, fetch_names=[out.name])
        events[side] = _pass_events(path)
    assert [e['pass'] for e in events['port']] == \
        list(pt.compiler.DEFAULT_PASSES)
    assert any(e['changed'] for e in events['port'])
    assert events['port'] == events['jax']


def _registry_delta(reg, before):
    """Series names whose value or count moved since ``before``."""
    moved = set()
    for name, entry in reg.snapshot().items():
        for series in entry['series']:
            key = (name, tuple(sorted(series['labels'].items())))
            now = series.get('count', series.get('value'))
            if now != before.get(key, 0):
                moved.add(name)
    return moved


def _registry_state(reg):
    return {(name, tuple(sorted(s['labels'].items()))):
            s.get('count', s.get('value'))
            for name, entry in reg.snapshot().items()
            for s in entry['series']}


def _drive(server, mlp_dir):
    """One seeded request sequence: five single requests, then three
    requests coalesced into one batch by pausing the queue."""
    server.load_model('m', mlp_dir)
    outs = [server.infer('m', _x(n, seed=n)) for n in (1, 3, 5, 8, 2)]
    server.pause('m')
    reqs = [server.submit('m', _x(1, seed=20 + i)) for i in range(3)]
    server.resume('m')
    return outs + [r.result(timeout=30) for r in reqs]


def test_serving_events_and_series_match_paddle_tpu(tmp_path, mlp_dir):
    seen = {}
    for side, mod_obs, make in (
            ('jax', jobs, lambda: JaxModelServer(
                place=fluid.CPUPlace(), max_batch_size=8,
                batch_timeout=0.0)),
            ('port', obs, lambda: _server())):
        reg = mod_obs.default_registry()
        before = _registry_state(reg)
        path = str(tmp_path / ('%s.jsonl' % side))
        with mod_obs.journal(path):
            with make() as server:
                outs = _drive(server, mlp_dir)
        records = mod_obs.read_journal(path)[0]
        seen[side] = dict(
            outs=outs,
            events=collections.Counter(
                r['ev'] for r in records if r['ev'].startswith('serving_')),
            spans=collections.Counter(
                r['name'] for r in records if r['ev'] == 'span_end' and
                r['name'].startswith(('serving/', 'exe/run', 'exe/fetch',
                                      'exe/dispatch'))),
            # one verify a memo miss (the port lowers once per program,
            # the JAX package once per shape)
            misses=collections.Counter(
                r['name'] for r in records if r['ev'] == 'span_end' and
                r['name'] in ('exe/verify', 'exe/compile')),
            links=sum(r['ev'] == 'span_link' for r in records),
            series={n for n in _registry_delta(reg, before)
                    if n.startswith(('serving_', 'executor_', 'tracing_',
                                     'compiler_', 'analysis_'))})
    jax_side, port = seen['jax'], seen['port']
    for a, b in zip(port['outs'], jax_side['outs']):
        np.testing.assert_allclose(a[0], np.asarray(b[0]), atol=1e-5)
    assert port['events'] == jax_side['events']
    assert port['events']['serving_batch'] == 6
    assert port['spans'] == jax_side['spans']
    for side in (port, jax_side):
        assert side['misses']['exe/verify'] == \
            side['misses']['exe/compile'] >= 1
    assert port['links'] == jax_side['links'] == 8
    # both servers time their stages into the profiler's serving spans
    # (serving_span_seconds)
    assert 'serving_span_seconds' in port['series']
    assert port['series'] == jax_side['series']


def _analysis_drive(pkg, A, pipeline_cls):
    """One seeded sequence of analysis applications: a verify with
    warnings, a sanitized pipeline of two passes, a rejected feed."""
    main, startup = pkg.Program(), pkg.Program()
    with pkg.unique_name.guard(), pkg.program_guard(main, startup):
        x = pkg.layers.data(name='x', shape=[6], dtype='float32')
        h = pkg.layers.relu(pkg.layers.scale(
            pkg.layers.fc(input=x, size=4), scale=2.0))
        out = pkg.layers.sigmoid(h)
    main.global_block().create_var(name='w', shape=(8, 4),
                                   dtype='float32').sharding = ('nope',)
    A.verify_program(main, feeds=('x',), fetch_names=(out.name,),
                     observe_as='verify')
    pipeline_cls(['dead_op_elim', 'elementwise_fuse'], verify=True).run(
        main, protected=(out.name,))
    with pytest.raises(A.FeedInvalid):
        A.check_feeds_for_executor(main, {'x': np.zeros((2, 6, 1, 3),
                                                        'float32')})


def test_analysis_events_and_series_match_paddle_tpu(tmp_path):
    """The analysis layer's telemetry, with paddle_tpu's names: one
    ``analysis`` journal event per application (verify, each sanitized
    pass, a rejected feed), field for field but its duration, and the
    same ``analysis_verify_seconds`` / ``analysis_diagnostics_total``
    series, moved by the same counts."""
    import paddle_tpu.analysis as JA
    from paddle_tpu.compiler.pass_base import PassPipeline as JPipeline
    import paddle_tpu_torch.analysis as A
    from paddle_tpu_torch.compiler.pass_base import PassPipeline
    seen = {}
    for side, mod_obs, pkg, M, pipe in (
            ('jax', jobs, fluid, JA, JPipeline),
            ('port', obs, pt, A, PassPipeline)):
        reg = mod_obs.default_registry()
        before = _registry_state(reg)
        path = str(tmp_path / ('%s.jsonl' % side))
        with mod_obs.journal(path):
            _analysis_drive(pkg, M, pipe)
        after = _registry_state(reg)
        seen[side] = dict(
            events=[{k: v for k, v in r.items()
                     if k not in ('dur_s', 't', 'run')}
                    for r in mod_obs.read_journal(path)[0]
                    if r['ev'] == 'analysis'],
            series={k: after[k] - before.get(k, 0) for k in after
                    if k[0].startswith('analysis_')
                    and after[k] != before.get(k, 0)})
    port, jax_side = seen['port'], seen['jax']
    assert [e['phase'] for e in port['events']] == \
        ['verify', 'sanitize', 'sanitize', 'feed']
    assert port['events'][0]['warnings'] >= 1
    assert port['events'][-1]['errors'] == 1
    assert port['events'] == jax_side['events']
    assert port['series'] == jax_side['series']
