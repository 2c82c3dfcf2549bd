"""paddle_tpu_torch.observability's telemetry plane on the CPU: the
per-process scrape endpoint, the strict exposition parser, aggregation
with retire-on-death, the SLO burn-rate engine, the crash flight
recorder and its health slot.

The cases of tests/test_telemetry.py, each run on the port, and beside
them: the exposition of one registry's contents byte for byte against
paddle_tpu's, the SLO reports under one fake clock against paddle_tpu's,
the ModelServer's health provider (registered at construction, gone
after close) and the flight bundle's ``health`` slot, the env contract
and the absent ``/ledgers`` route.
"""
import json
import os
import urllib.error
import urllib.request

import pytest

import paddle_tpu_torch as pt
from paddle_tpu_torch.observability import flight, telemetry
from paddle_tpu_torch.observability.metrics import MetricsRegistry
from paddle_tpu_torch.observability.slo import SLO, SLOEngine

pytestmark = pytest.mark.telemetry


# ---- exposition conformance ------------------------------------------------
def test_exposition_round_trips_through_strict_parser():
    reg = MetricsRegistry()
    reg.counter('reqs_total', 'requests', model='m"1"',
                path='a\\b\nc').inc(7)
    reg.gauge('depth', 'queue depth', lane='0').set(2.5)
    h = reg.histogram('lat_seconds', 'latency')
    for v in (0.001, 0.01, 4.0):
        h.observe(v)

    meta, samples = telemetry.parse_exposition(reg.exposition())
    assert meta['reqs_total'] == {'type': 'counter',
                                  'help': 'requests'}
    by = {(s.name, tuple(sorted(s.labels.items()))): s.value
          for s in samples}
    # escaped label values survive the round trip exactly
    assert by[('reqs_total', (('model', 'm"1"'),
                              ('path', 'a\\b\nc')))] == 7
    assert by[('depth', (('lane', '0'),))] == 2.5
    assert by[('lat_seconds_count', ())] == 3
    assert by[('lat_seconds_bucket', (('le', '+Inf'),))] == 3
    assert abs(by[('lat_seconds_sum', ())] - 4.011) < 1e-9


def test_parser_rejects_malformed_exposition():
    for bad in ('metric_without_value\n',
                'bad{unterminated="x\n',
                '# TYPE x sometype\nx 1\n',
                '9leading_digit 1\n'):
        with pytest.raises(ValueError):
            telemetry.parse_exposition(bad)


# ---- the scrape endpoint ---------------------------------------------------
def test_serve_scrape_health_and_port_file(tmp_path):
    reg = MetricsRegistry()
    reg.counter('widgets_total', 'widgets').inc(3)
    srv = telemetry.serve_telemetry(registry=reg,
                                    port_dir=str(tmp_path),
                                    name='cell-a')
    try:
        with urllib.request.urlopen(srv.url + '/metrics',
                                    timeout=5) as resp:
            assert resp.headers['Content-Type'] == \
                telemetry.CONTENT_TYPE
            _, samples = telemetry.parse_exposition(
                resp.read().decode('utf-8'))
        assert any(s.name == 'widgets_total' and s.value == 3
                   for s in samples)
        with urllib.request.urlopen(srv.url + '/health',
                                    timeout=5) as resp:
            doc = json.loads(resp.read().decode('utf-8'))
        assert doc['status'] in ('ok', 'degraded')
        # atomic port publication, discoverable by the scanner
        assert telemetry.scan_port_dir(str(tmp_path)) == \
            {'cell-a': srv.port}
        assert not os.path.exists(
            os.path.join(str(tmp_path), 'cell-a.port.tmp'))
    finally:
        srv.close()
    with pytest.raises(urllib.error.URLError):
        urllib.request.urlopen(srv.url + '/metrics', timeout=1)


# ---- aggregation + retire --------------------------------------------------
def test_aggregator_retired_replica_series_vanish(tmp_path):
    regs = {name: MetricsRegistry() for name in ('r0', 'r1')}
    for name, reg in regs.items():
        reg.counter('serving_requests_completed_total',
                    'done', model='m').inc(5)
    servers = {name: telemetry.serve_telemetry(registry=reg)
               for name, reg in regs.items()}
    agg = telemetry.TelemetryAggregator()
    try:
        agg.add_endpoint('r0', servers['r0'].port, replica='0')
        agg.add_endpoint('r1', servers['r1'].port, replica='1')
        agg.scrape_once(timeout=5.0)

        def replicas_seen():
            return {s['labels'].get('replica')
                    for entry in agg.registry.snapshot().values()
                    for s in entry['series']} - {None}

        assert replicas_seen() == {'0', '1'}
        assert agg.endpoints()['r0']['up'] == 1

        removed = agg.retire('r0')
        assert removed > 0
        assert replicas_seen() == {'1'}
        assert 'r0' not in agg.endpoints()
        # a fresh scrape must not resurrect the retired series
        agg.scrape_once(timeout=5.0)
        assert replicas_seen() == {'1'}
    finally:
        for srv in servers.values():
            srv.close()


def test_killed_replica_gauges_vanish_from_scraped_metrics():
    """A retired replica's ``fleet_replica_state`` /
    ``router_routed_total`` gauges must disappear from the process's
    *scraped* ``/metrics`` output: ``remove_matching`` exercised
    through the exposition path."""
    from paddle_tpu_torch import observability as obs
    from paddle_tpu_torch.fleet import Router
    from paddle_tpu_torch.serving import ModelServer

    # clear per-replica series other tests in this process left behind
    reg = obs.default_registry()
    reg.remove_matching('fleet_replica_state')
    reg.remove_matching('router_routed_total')

    def factory(rid):
        return ModelServer(place=pt.CPUPlace(), max_batch_size=4)

    srv = telemetry.serve_telemetry()
    try:
        with Router(factory, replicas=2, poll_interval=0.05) as router:
            def replica_states():
                with urllib.request.urlopen(srv.url + '/metrics',
                                            timeout=5) as resp:
                    _, samples = telemetry.parse_exposition(
                        resp.read().decode('utf-8'))
                return {s.labels['replica'] for s in samples
                        if s.name == 'fleet_replica_state'}

            assert replica_states() == {'0', '1'}
            router.retire_replica(1)
            assert replica_states() == {'0'}
    finally:
        srv.close()


def test_aggregator_marks_dead_endpoint_down(tmp_path):
    srv = telemetry.serve_telemetry(registry=MetricsRegistry())
    agg = telemetry.TelemetryAggregator()
    agg.add_endpoint('gone', srv.port, replica='9')
    srv.close()
    summary = agg.scrape_once(timeout=1.0)
    assert summary == {'endpoints': 1, 'scraped': 0, 'failures': 1,
                       'fleet_qps': 0.0, 'fleet_shed_rate': 0.0,
                       'worst_p99_s': 0.0, 'worst_endpoint': None}
    assert agg.endpoints()['gone']['up'] == 0


# ---- SLO burn-rate engine --------------------------------------------------
def test_slo_breach_and_recovery_with_fake_clock():
    reg = MetricsRegistry()
    bad = reg.counter('shed_total', 'shed')
    total = reg.counter('submitted_total', 'submitted')
    now = [0.0]
    engine = SLOEngine(
        [SLO.ratio('shed', bad='shed_total', total='submitted_total',
                   objective=0.98)],
        registry=reg, windows=(10.0, 60.0), clock=lambda: now[0])

    # clean traffic: burn stays zero
    for _ in range(3):
        now[0] += 5.0
        total.inc(100)
        r = engine.tick()['shed']
        assert r['burn_rate'] == 0.0 and not r['breached']
    assert engine.breached() == []

    # storm: half of everything sheds -> every window burns
    for _ in range(3):
        now[0] += 5.0
        total.inc(100)
        bad.inc(50)
        r = engine.tick()['shed']
    assert r['breached'] and r['burn_rate'] > 1.0
    assert engine.breached() == ['shed']

    # drain: the short window cools first and min-across-windows
    # recovers, even while the long window is still burning
    for _ in range(4):
        now[0] += 5.0
        total.inc(100)
        r = engine.tick()['shed']
    assert not r['breached'] and engine.breached() == []
    assert r['windows'][60.0] > 1.0    # long window still hot
    # the published gauge tracks the headline burn
    g = reg.get('slo_burn_rate', slo='shed')
    assert g is not None and g.value == r['burn_rate']


def test_slo_signal_is_worst_burn():
    reg = MetricsRegistry()
    reg.counter('a_bad', 'x').inc(50)
    reg.counter('a_total', 'x').inc(100)
    reg.counter('b_total', 'x').inc(100)
    now = [0.0]
    engine = SLOEngine(
        [SLO.ratio('hot', bad='a_bad', total='a_total',
                   objective=0.99),
         SLO.ratio('cold', bad='b_total', total='b_total',
                   objective=0.99)],
        registry=reg, windows=(10.0,), clock=lambda: now[0])
    engine.tick()
    now[0] += 5.0
    reg.counter('a_bad').inc(50)
    reg.counter('a_total').inc(100)
    reg.counter('b_total').inc(100)
    assert engine.signal() > 1.0


# ---- crash flight recorder -------------------------------------------------
def test_flight_trip_dumps_rate_limited_bundle(tmp_path):
    prev = flight.configure(str(tmp_path))
    flight.clear()
    try:
        flight.note('warmup', {'step': 1})
        path = flight.trip('unit_test_kill', replica=3)
        assert path is not None and os.path.exists(path)
        assert flight.last_bundle() == path
        bundle = flight.read_bundle(path)
        assert bundle['reason'] == 'unit_test_kill'
        assert bundle['context'] == {'replica': 3}
        assert bundle['pid'] == os.getpid()
        evs = [e['ev'] for e in bundle['ring']]
        assert 'warmup' in evs and 'flight_trip' in evs
        # same reason inside the rate-limit interval: no second bundle
        assert flight.trip('unit_test_kill', replica=4) is None
        # a different reason dumps immediately
        assert flight.trip('unit_test_other') is not None
        # strict reader rejects non-bundles
        stray = tmp_path / 'stray.json'
        stray.write_text('{"schema": 999}')
        with pytest.raises(ValueError):
            flight.read_bundle(str(stray))
    finally:
        flight.clear()
        flight.configure(prev)


def test_flight_without_dir_notes_but_never_dumps(tmp_path):
    prev = flight.configure(None)
    env_prev = os.environ.pop(flight.FLIGHT_ENV, None)
    flight.clear()
    try:
        assert flight.trip('nowhere_to_dump') is None
        assert any(e['ev'] == 'flight_trip' for e in flight.ring())
    finally:
        flight.clear()
        flight.configure(prev)
        if env_prev is not None:
            os.environ[flight.FLIGHT_ENV] = env_prev


# ---- against paddle_tpu ----------------------------------------------------
def _fill(reg):
    """One registry's contents, built the same way in either package."""
    reg.counter('reqs_total', 'requests', model='m"1"',
                path='a\\b\nc').inc(7)
    reg.counter('reqs_total', 'requests', model='m2', path='/').inc(2)
    reg.gauge('depth', 'queue depth', lane='0').set(2.5)
    reg.gauge('depth', 'queue depth', lane='1').set(-1e-7)
    h = reg.histogram('lat_seconds', 'latency', model='m')
    for v in (0.0004, 0.001, 0.01, 0.3, 4.0, 250.0):
        h.observe(v)
    reg.gauge('fleet_replica_state', 'replica routing state',
              replica='3').set(4)
    return reg


def test_exposition_byte_equal_to_paddle_tpu():
    from paddle_tpu.observability.metrics import MetricsRegistry as JReg
    from paddle_tpu.observability import telemetry as jtelemetry
    text = _fill(MetricsRegistry()).exposition()
    assert text == _fill(JReg()).exposition()
    assert telemetry.parse_exposition(text) == \
        jtelemetry.parse_exposition(text)
    assert telemetry.CONTENT_TYPE == jtelemetry.CONTENT_TYPE
    assert (telemetry.TELEMETRY_ENV, telemetry.TELEMETRY_DIR_ENV) == \
        (jtelemetry.TELEMETRY_ENV, jtelemetry.TELEMETRY_DIR_ENV) == \
        ('PTPU_TELEMETRY', 'PTPU_TELEMETRY_DIR')


def test_slo_signals_match_paddle_tpu():
    """Both engines over one traffic schedule and one fake clock: the
    same reports every tick (burn rates, budgets, windows, breaches)
    and the same signal."""
    from paddle_tpu.observability.metrics import MetricsRegistry as JReg
    from paddle_tpu.observability.slo import SLO as JSLO
    from paddle_tpu.observability.slo import SLOEngine as JEngine
    now = [0.0]
    engines = []
    for Reg, S, E in ((MetricsRegistry, SLO, SLOEngine),
                      (JReg, JSLO, JEngine)):
        reg = Reg()
        engines.append((reg, E(
            [S.ratio('shed', bad='shed_total', total='submitted_total',
                     objective=0.98),
             S.latency('p99', histogram='lat_seconds', threshold_s=0.25,
                       objective=0.99)],
            registry=reg, windows=(10.0, 60.0), clock=lambda: now[0])))
    lat = [0.01] * 90 + [0.5] * 10
    reports = ([], [])
    for step in range(14):
        now[0] += 5.0
        bad = 50 if 3 <= step < 6 else 0
        for k, (reg, engine) in enumerate(engines):
            reg.counter('submitted_total', 'submitted').inc(100)
            reg.counter('shed_total', 'shed').inc(bad)
            h = reg.histogram('lat_seconds', 'latency')
            for v in (lat if step % 4 == 1 else lat[:90]):
                h.observe(v)
            reports[k].append((engine.tick(), engine.breached()))
    assert reports[0] == reports[1]
    assert any(b for _, b in reports[0])
    assert engines[0][1].signal() == engines[1][1].signal()
    assert engines[0][1].describe() == engines[1][1].describe()


def test_server_health_provider_and_flight_health_slot(tmp_path):
    """A ModelServer is a health provider from construction until
    close(); a flight bundle carries the providers' documents in its
    ``health`` slot (``ledgers`` stays None until the port has
    ``perf.py``)."""
    srv = pt.serving.ModelServer(place=pt.CPUPlace(), max_batch_size=2)
    key = 'server-%x' % id(srv)
    prev = flight.configure(str(tmp_path))
    try:
        doc = telemetry.collect_health()
        assert doc['providers'][key] == srv.health()
        path = flight.dump('unit_test_health')
        bundle = flight.read_bundle(path)
        assert bundle['health']['providers'][key]['status'] == 'serving'
        assert bundle['ledgers'] is None
    finally:
        flight.configure(prev)
        srv.close()
    assert key not in telemetry.collect_health()['providers']


def test_env_contract_and_absent_ledgers_route(tmp_path, monkeypatch):
    monkeypatch.setattr(telemetry, '_ENV_SERVER', [None])
    monkeypatch.delenv(telemetry.TELEMETRY_ENV, raising=False)
    assert telemetry.install_env_telemetry() is None
    monkeypatch.setenv(telemetry.TELEMETRY_ENV, '1')
    monkeypatch.setenv(telemetry.TELEMETRY_DIR_ENV, str(tmp_path))
    srv = telemetry.install_env_telemetry(name='cell-env')
    try:
        assert srv is not None and telemetry.env_telemetry_server() is srv
        assert telemetry.install_env_telemetry() is None   # once only
        assert telemetry.scan_port_dir(str(tmp_path)) == \
            {'cell-env': srv.port}
        with pytest.raises(urllib.error.HTTPError) as ei:
            urllib.request.urlopen(srv.url + '/ledgers', timeout=5)
        assert ei.value.code == 404
    finally:
        srv.close()
    assert telemetry.scan_port_dir(str(tmp_path)) == {}
