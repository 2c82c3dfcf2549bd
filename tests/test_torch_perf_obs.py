"""The port's performance observatory (observability/perf.py) on the CPU:
the cases of tests/test_perf_obs.py, each against the port.

- A ledger is captured exactly once a memo miss of the Executor (one
  lowering serves every batch size in the port: serving warm-up's
  buckets make one), and never while capture is off (the default).
- MFU and roofline arithmetic against hand-computed products, and the
  peak table: the H100's (NVIDIA's data sheet), matched by the card's
  name, with the environment overrides.
- The counted operations of a captured fc equal 2 * M * K * N, and of a
  fused conv region (conv, bias, batch norm, ReLU) the conv's 2 * N * Ho
  * Wo * Cout * Cin * KH * KW plus one an output element a stage: the
  port counts its ops (its kernels run through ctypes, where torch's
  flop counter sees nothing), and this holds the count to a hand count.
- PerfBaseline round-trips on disk and its diff names the program on
  seeded flops, step-time and MFU regressions; the port's
  ``tools/perf_report.py --smoke`` sentinel end to end.
- ``perf_ledger`` journal events carry the trace id and pass
  ``tools/obs_report.py``'s perf gate; serving warm-up ledgers its
  lowering; the flight bundle's ``ledgers`` slot, the ``/ledgers`` route,
  the tuner's ``_ledger_bound`` and the Trainer's per-step gauges read
  the book.

Left out: the reference's dp2 case (a ParallelExecutor over two devices:
ROADMAP Queue A item 6) and its lint case (the rule fences XLA's
``cost_analysis()``, which the port does not call).
"""
import json
import os
import sys
import urllib.request

import numpy as np
import pytest

import paddle_tpu_torch as pt
from paddle_tpu_torch import observability as obs
from paddle_tpu_torch import unique_name
from paddle_tpu_torch.observability import perf
from paddle_tpu_torch.tools import perf_report

TOOLS = os.path.join(os.path.dirname(__file__), '..', 'tools')
if TOOLS not in sys.path:
    sys.path.insert(0, TOOLS)

import obs_report    # noqa: E402


@pytest.fixture(autouse=True)
def _perf_isolation(monkeypatch):
    monkeypatch.delenv(perf.PERF_ENV, raising=False)
    monkeypatch.delenv(perf.PEAK_FLOPS_ENV, raising=False)
    monkeypatch.delenv(perf.HBM_GBPS_ENV, raising=False)
    prev = perf.enable_capture(None)
    perf.clear()
    yield
    perf._CAPTURE[0] = prev
    perf.clear()


def _exe():
    return pt.Executor(pt.CPUPlace())


def _mlp(seed=7, batch=16):
    main, startup = pt.Program(), pt.Program()
    startup.random_seed = seed
    with pt.program_guard(main, startup), unique_name.guard():
        img = pt.layers.data(name='img', shape=[32], dtype='float32')
        label = pt.layers.data(name='label', shape=[1], dtype='int64')
        h = pt.layers.fc(input=img, size=24, act='relu')
        pred = pt.layers.fc(input=h, size=10, act='softmax')
        loss = pt.layers.mean(pt.layers.cross_entropy(input=pred,
                                                      label=label))
        pt.optimizer.Adam(learning_rate=1e-3).minimize(loss)
    rng = np.random.RandomState(seed)
    feed = {'img': rng.randn(batch, 32).astype('float32'),
            'label': rng.randint(0, 10, (batch, 1)).astype('int64')}
    return main, startup, loss, feed


def test_capture_off_by_default():
    assert not perf.capture_enabled()
    main, startup, loss, feed = _mlp()
    scope = pt.Scope()
    _exe().run(startup, scope=scope)
    _exe().run(main, feed=feed, fetch_list=[loss], scope=scope)
    assert len(perf.book()) == 0
    assert perf.get_ledger(main.fingerprint()) is None


def test_ledger_once_per_program_shape():
    """One ledger a memo miss. The port's lowering runs any batch (a new
    batch size is a memo hit, where JAX compiles again), so the second
    ledger comes from a miss (a new fetch list) at a new batch size."""
    main, startup, loss, feed = _mlp()
    exe = _exe()
    scope = pt.Scope()
    exe.run(startup, scope=scope)
    with perf.capture_scope(True):
        before = exe.cache_info()
        for _ in range(3):
            exe.run(main, feed=feed, fetch_list=[loss], scope=scope)
        mid = exe.cache_info()
        assert mid.misses - before.misses == 1
        assert len(perf.book()) == 1
        _, _, _, feed24 = _mlp(batch=24)
        exe.run(main, feed=feed24, fetch_list=[loss], scope=scope)
        assert exe.cache_info().misses - before.misses == 1
        assert len(perf.book()) == 1
        exe.run(main, feed=feed24, fetch_list=[loss, 'fc_0.tmp_2'],
                scope=scope)
        assert exe.cache_info().misses - before.misses == 2
        assert len(perf.book()) == 2
    ledger = perf.get_ledger(main.fingerprint())
    assert ledger.backend == 'cpu' and ledger.mesh == 'single'
    assert ledger.device_kind == 'cpu'
    assert ledger.flops > 0 and ledger.bytes_accessed > 0
    assert ledger.live_bytes > 0 and ledger.compile_wall_s > 0
    assert len(ledger.shape_sig) == 16
    assert len({perf.LedgerBook.key(l) for l in perf.ledgers()}) == 2


def test_mfu_math_pinned_vs_hand_matmul():
    M, K, N = 32, 128, 64
    flops = 2.0 * M * K * N
    bytes_moved = 4.0 * (M * K + K * N + M * N)
    led = perf.ProgramLedger('fp1', device_kind='', flops=flops,
                             bytes_accessed=bytes_moved)
    assert led.mfu(measured_ms=1.0, peak=1e9) == \
        pytest.approx(flops / 1e-3 / 1e9)
    assert led.compute_bound_s(peak=1e9) == pytest.approx(flops / 1e9)
    assert led.bandwidth_bound_s(hbm_gbps=1.0) == \
        pytest.approx(bytes_moved / 1e9)
    # the table: the H100 by the card's name, nothing of a TPU
    assert perf.peak_flops_for('NVIDIA H100 80GB HBM3') == 989e12
    assert perf.hbm_gbps_for('NVIDIA H100 80GB HBM3') == 3350.0
    assert perf.peak_flops_for('TPU v5e') == perf.DEFAULT_PEAK_FLOPS
    assert perf.peak_flops_for('mystery') == perf.DEFAULT_PEAK_FLOPS
    os.environ[perf.PEAK_FLOPS_ENV] = '1e9'
    os.environ[perf.HBM_GBPS_ENV] = '7'
    try:
        assert perf.peak_flops_for('NVIDIA H100 80GB HBM3') == 1e9
        assert perf.hbm_gbps_for('NVIDIA H100 80GB HBM3') == 7.0
    finally:
        del os.environ[perf.PEAK_FLOPS_ENV]
        del os.environ[perf.HBM_GBPS_ENV]


def test_captured_fc_flops_match_hand_count():
    M, K, N = 32, 128, 64
    main, startup = pt.Program(), pt.Program()
    startup.random_seed = 3
    with pt.program_guard(main, startup), unique_name.guard():
        x = pt.layers.data(name='x', shape=[K], dtype='float32')
        y = pt.layers.fc(input=x, size=N, bias_attr=False)
    xs = np.random.RandomState(0).randn(M, K).astype('float32')
    exe, scope = _exe(), pt.Scope()
    exe.run(startup, scope=scope)
    with perf.capture_scope(True):
        exe.run(main, feed={'x': xs}, fetch_list=[y], scope=scope)
    led = perf.get_ledger(main.fingerprint())
    assert led.flops == 2.0 * M * K * N
    assert led.flops_by_type == {'mul': 2 * M * K * N}
    # x, w and y once each
    assert led.bytes_accessed == 4.0 * (M * K + K * N + M * N)
    mfu = perf.publish_step(main.fingerprint(), 0.002)
    assert mfu == pytest.approx(led.flops / 0.002 / led.peak_flops)
    reg = obs.default_registry()
    g = reg.get('perf_mfu', program=main.fingerprint())
    assert g is not None and g.value == pytest.approx(mfu)
    rb = reg.get('perf_roofline_bound', program=main.fingerprint())
    assert rb is not None and rb.value in (0.0, 1.0)


@pytest.mark.parametrize('train', [False, True])
def test_captured_fused_conv_flops_match_hand_count(train):
    """The fused conv region's conv (ctypes on the card, its plain
    version here) and its three epilogue stages, counted from the op;
    a training step counts the forward three times (forward and the
    backward's two products)."""
    N, C, H, W, F, K = 4, 8, 16, 16, 16, 3
    main, startup = pt.Program(), pt.Program()
    startup.random_seed = 13
    with pt.program_guard(main, startup), unique_name.guard():
        im = pt.layers.data(name='im', shape=[C, H, W], dtype='float32')
        c = pt.layers.conv2d(input=im, num_filters=F, filter_size=K,
                             padding=1)
        r = pt.layers.relu(pt.layers.batch_norm(input=c, is_test=not train))
        fetch = [r]
        if train:
            loss = pt.layers.mean(r)
            pt.optimizer.SGD(0.1).minimize(loss)
            fetch = [loss]
    exe, scope = _exe(), pt.Scope()
    exe.run(startup, scope=scope)
    feed = {'im': np.random.RandomState(1).randn(N, C, H, W)
            .astype('float32')}
    with perf.capture_scope(True):
        exe.run(main, feed=feed, fetch_list=fetch, scope=scope)
    led = perf.get_ledger(main.fingerprint())
    out = N * H * W * F
    conv = 2 * out * C * K * K
    # conv2d, its bias add, batch_norm and relu in one region
    hand = (conv + 3 * out) * (3 if train else 1)
    assert led.flops_by_type['fused_conv'] == hand


def test_baseline_roundtrip_and_seeded_regressions(tmp_path):
    led = perf.ProgramLedger('fp0', shape_sig='abcd', backend='cuda',
                             device_kind='NVIDIA H100 80GB HBM3',
                             flops=1e9, bytes_accessed=5e8,
                             output_bytes=1000.0, temp_bytes=2048,
                             argument_bytes=4096, label='prog')
    led.measured_ms = 2.0
    base = perf.PerfBaseline(str(tmp_path / 'b.json'))
    key = perf.PerfBaseline.key('fp0', 'abcd', 'cuda', 'single')
    base.put(key, perf.PerfBaseline.entry_from_ledger(led,
                                                      with_timings=True))
    base.save()
    again = perf.PerfBaseline(base.path).load()
    assert again.entries == base.entries
    entry = dict(base.entries[key])
    assert entry['step_ms'] == 2.0 and entry['mfu'] > 0
    assert again.diff({key: dict(entry)}) == []
    probs = again.diff({key: dict(entry, flops=1.2e9)})
    assert any('prog' in p and 'flops' in p for p in probs)
    probs = again.diff({key: dict(entry, step_ms=entry['step_ms'] * 2)},
                       tol=0.10)
    assert any('step time regressed' in p for p in probs)
    probs = again.diff({key: dict(entry, mfu=entry['mfu'] * 0.5)}, tol=0.10)
    assert any('MFU regressed' in p for p in probs)
    assert any('missing from run' in p for p in again.diff({}))
    cur = {key: dict(entry), 'new|x|cuda|single': {'program': 'new',
                                                  'flops': 1.0}}
    assert again.diff(cur) == []


def test_perf_report_smoke_sentinel_end_to_end(tmp_path, capsys):
    base = str(tmp_path / 'base.json')
    args = ['--smoke', '--steps', '2', '--device', 'cpu']
    assert perf_report.main(args + ['--update-baseline', base]) == 0
    perf.clear()
    assert perf_report.main(args + ['--baseline', base]) == 0
    perf.clear()
    capsys.readouterr()
    with open(base) as f:
        data = json.load(f)
    key = sorted(data['entries'])[0]
    name = data['entries'][key]['program']
    data['entries'][key]['flops'] *= 2.0
    with open(base, 'w') as f:
        json.dump(data, f)
    assert perf_report.main(args + ['--baseline', base]) == 1
    err = capsys.readouterr().err
    assert 'PERF REGRESSION' in err
    assert name in err and 'flops drifted' in err


def test_journal_event_trace_exemplar_and_gate(tmp_path, capsys):
    p = str(tmp_path / 'run.jsonl')
    main, startup, loss, feed = _mlp(seed=13)
    with obs.journal(p), perf.capture_scope(True):
        exe, scope = _exe(), pt.Scope()
        exe.run(startup, scope=scope)
        with obs.span('perf/step') as root:
            exe.run(main, feed=feed, fetch_list=[loss], scope=scope)
        perf.publish_step(main.fingerprint(), 0.004)
    recs, malformed = obs.read_journal(p)
    assert malformed == 0
    evs = [r for r in recs if r['ev'] == 'perf_ledger']
    seal = next(r for r in evs if r.get('fp') == main.fingerprint()
                and r.get('phase') != 'measured')
    assert seal['flops'] > 0 and seal['mesh'] == 'single'
    assert seal['live_bytes'] > 0 and seal['compile_wall_s'] > 0
    assert seal['roofline'] in ('compute', 'bandwidth')
    assert seal['trace'] == root.context.trace_id
    measured = next(r for r in evs if r.get('phase') == 'measured')
    assert measured['fp'] == main.fingerprint()
    assert measured['measured_ms'] == pytest.approx(4.0)
    assert measured['mfu'] is not None
    assert obs_report.check_journal(p, require='perf') == []
    summary = obs_report.summarize(recs)
    assert summary['perf']['programs'] >= 1
    assert 'perf:' in obs_report.render(summary)
    # the port's report reads the same journal
    assert perf_report.main(['--journal', p]) == 0
    assert 'perf observatory: %d program(s)' % len(
        {r['fp'] for r in evs}) in capsys.readouterr().out
    bare = str(tmp_path / 'bare.jsonl')
    with obs.journal(bare):
        obs.emit('step_end', dur_s=0.1)
    problems = obs_report.check_journal(bare, require='perf')
    assert any('perf_ledger' in pr for pr in problems)


def test_serving_warmup_ledgers_buckets(tmp_path):
    from paddle_tpu_torch.serving import ModelServer
    main, startup = pt.Program(), pt.Program()
    startup.random_seed = 9
    with pt.program_guard(main, startup), unique_name.guard():
        x = pt.layers.data(name='x', shape=[6], dtype='float32')
        h = pt.layers.fc(input=x, size=8, act='relu')
        y = pt.layers.fc(input=h, size=3, act=None)
    d = str(tmp_path / 'm0')
    exe, scope = _exe(), pt.Scope()
    exe.run(startup, scope=scope)
    pt.io.save_inference_model(d, ['x'], [y], exe, main_program=main,
                               scope=scope)
    p = str(tmp_path / 'serve.jsonl')
    with obs.journal(p):
        with ModelServer(place=pt.CPUPlace(), max_batch_size=8) as srv:
            srv.load_model('m0', d)
            warmed = srv.warmup()
    assert len(warmed['m0']) == 4
    recs, _ = obs.read_journal(p)
    w = next(r for r in recs if r['ev'] == 'serving_warmup')
    # one lowering serves every bucket in the port: one ledger
    assert w['perf_ledgers'] == 1
    assert sum(1 for r in recs if r['ev'] == 'perf_ledger') == 1
    assert obs_report.check_journal(p, require='perf') == []


def test_readers_of_the_book(tmp_path):
    """The flight bundle's ``ledgers`` slot, the ``/ledgers`` route, the
    tuner's ``_ledger_bound`` and PlacementBudget's default book."""
    from paddle_tpu_torch.compiler.tuning import Autotuner
    from paddle_tpu_torch.fleet.router import PlacementBudget
    from paddle_tpu_torch.observability import flight
    main, startup, loss, feed = _mlp(seed=21)
    assert Autotuner._ledger_bound(main) is None
    exe, scope = _exe(), pt.Scope()
    exe.run(startup, scope=scope)
    with perf.capture_scope(True):
        exe.run(main, feed=feed, fetch_list=[loss], scope=scope)
    led = perf.get_ledger(main.fingerprint())
    assert Autotuner._ledger_bound(main) == led.roofline_bound
    assert PlacementBudget().demand(
        {'fingerprints': (main.fingerprint(),)}) == (float(led.live_bytes),
                                                     0.0)
    path = flight.dump('test', directory=str(tmp_path))
    with open(path) as f:
        bundle = json.load(f)
    assert [l['fp'] for l in bundle['ledgers']] == [main.fingerprint()]
    srv = obs.serve_telemetry(port=0)
    try:
        with urllib.request.urlopen('http://127.0.0.1:%d/ledgers'
                                    % srv.port, timeout=10) as r:
            docs = json.loads(r.read())
    finally:
        srv.close()
    assert [d['fp'] for d in docs] == [main.fingerprint()]
    assert docs[0]['flops'] == led.flops


def test_trainer_publishes_step_gauges(tmp_path):
    """Trainer.train under capture: the training program's ledger and its
    MFU and roofline gauges after the steps."""
    def train_func():
        x = pt.layers.data(name='x', shape=[8], dtype='float32')
        y = pt.layers.data(name='y', shape=[1], dtype='float32')
        pred = pt.layers.fc(input=x, size=1)
        return pt.layers.mean(pt.layers.square_error_cost(input=pred,
                                                          label=y))

    rng = np.random.RandomState(0)

    def reader():
        for _ in range(4):
            yield [(rng.randn(8).astype('float32'),
                    rng.randn(1).astype('float32')) for _ in range(4)]

    trainer = pt.Trainer(train_func, pt.optimizer.SGD(0.01),
                         place=pt.CPUPlace())
    with perf.capture_scope(True):
        trainer.train(num_epochs=1, event_handler=lambda e: None,
                      reader=reader, feed_order=['x', 'y'])
    fp = trainer.train_program.fingerprint()
    led = perf.get_ledger(fp)
    assert led is not None and led.measured_ms > 0
    reg = obs.default_registry()
    assert reg.get('perf_mfu', program=fp).value == pytest.approx(led.mfu())
    assert reg.get('perf_roofline_bound', program=fp).value in (0.0, 1.0)
