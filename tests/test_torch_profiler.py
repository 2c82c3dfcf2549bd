"""The profiler: paddle_tpu_torch against paddle_tpu, on the CPU.

The per-op table's keys and call counts for an inference program and a
training program (one ``fwd_bwd(value_and_grad)`` event a step, the
update ops one by one) equal paddle_tpu's; ``reset_profiler``; runs
outside a profiling window record nothing; ``save_profile`` ->
tools/timeline.py; the device trace file; the serving spans' names and
counts for one request sequence equal paddle_tpu's.
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest

import paddle_tpu.fluid as fluid
import paddle_tpu_torch as pt
from paddle_tpu import profiler as j_prof
from paddle_tpu_torch import profiler as t_prof

PROF = {fluid: j_prof, pt: t_prof}
_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _net(pkg, train):
    main, startup = pkg.Program(), pkg.Program()
    with pkg.unique_name.guard(), pkg.program_guard(main, startup):
        x = pkg.layers.data(name='x', shape=[8], dtype='float32')
        y = pkg.layers.data(name='y', shape=[1], dtype='float32')
        h = pkg.layers.fc(input=x, size=16, act='relu')
        pred = pkg.layers.fc(input=h, size=1)
        out = pkg.layers.softmax(h)
        if train:
            out = pkg.layers.mean(pkg.layers.square_error_cost(pred, y))
            pkg.optimizer.Momentum(learning_rate=0.01,
                                   momentum=0.9).minimize(out)
    return main, startup, out


def _feed(train):
    rng = np.random.RandomState(0)
    feed = {'x': rng.randn(4, 8).astype('float32')}
    if train:
        feed['y'] = rng.randn(4, 1).astype('float32')
    return feed


def _profiled_calls(pkg, train, tmp_path, runs=3):
    prof = PROF[pkg]
    main, startup, out = _net(pkg, train)
    exe, scope = pkg.Executor(pkg.CPUPlace()), pkg.Scope()
    exe.run(startup, scope=scope)
    exe.run(main, feed=_feed(train), fetch_list=[out], scope=scope)
    prof.reset_profiler()
    prof.start_profiler('All', trace_dir=str(tmp_path / pkg.__name__))
    for _ in range(runs):
        exe.run(main, feed=_feed(train), fetch_list=[out], scope=scope)
    prof.stop_profiler('total')
    calls = {name: ev[0] for name, ev in prof._op_events.items()}
    for calls_, total, mx, mn in prof._op_events.values():
        assert calls_ >= 1 and total >= 0 and mx >= mn
    return calls


@pytest.mark.parametrize('train', [False, True])
def test_op_table_equals_paddle_tpu(tmp_path, train, capsys):
    j = _profiled_calls(fluid, train, tmp_path)
    t = _profiled_calls(pt, train, tmp_path)
    assert t == j
    if train:
        assert t['fwd_bwd(value_and_grad)'] == 3
        assert t['momentum'] == 3 * 4        # 4 parameters
        assert 'mul' not in t                # inside the training region
    else:
        assert t['mul'] == 3 and t['softmax'] == 3 and t['relu'] == 3
    out = capsys.readouterr().out
    assert 'Profiling Report' in out and 'Ave(ms)' in out


def test_device_trace_is_written(tmp_path):
    t_prof.reset_profiler()
    with t_prof.profiler('All', 'calls', str(tmp_path / 'table.txt'),
                         trace_dir=str(tmp_path / 'trace')):
        main, startup, out = _net(pt, False)
        exe, scope = pt.Executor(pt.CPUPlace()), pt.Scope()
        exe.run(startup, scope=scope)
        exe.run(main, feed=_feed(False), fetch_list=[out], scope=scope)
    path = t_prof.trace_path()
    assert path == str(tmp_path / 'trace' / 'trace.json')
    with open(path) as f:
        assert json.load(f)['traceEvents']
    with open(str(tmp_path / 'table.txt')) as f:
        assert 'softmax' in f.read()
    with pytest.raises(ValueError, match='sorted_key'):
        t_prof._print_table('nope')


def test_reset_and_no_pollution_of_normal_runs(tmp_path):
    main, startup, out = _net(pt, True)
    exe, scope = pt.Executor(pt.CPUPlace()), pt.Scope()
    exe.run(startup, scope=scope)
    t_prof.reset_profiler()
    exe.run(main, feed=_feed(True), fetch_list=[out], scope=scope)
    assert not t_prof._op_events and not t_prof._timeline
    t_prof.start_profiler('All', trace_dir=str(tmp_path))
    exe.run(main, feed=_feed(True), fetch_list=[out], scope=scope)
    t_prof.stop_profiler()
    assert t_prof._op_events and t_prof._timeline
    n = dict(t_prof._op_events)
    exe.run(main, feed=_feed(True), fetch_list=[out], scope=scope)
    assert dict(t_prof._op_events) == n    # after stop: nothing more
    t_prof.reset_profiler()
    assert not t_prof._op_events and not t_prof._timeline
    assert not t_prof.op_profiling_enabled()


def test_save_profile_through_tools_timeline(tmp_path):
    main, startup, out = _net(pt, False)
    exe, scope = pt.Executor(pt.CPUPlace()), pt.Scope()
    exe.run(startup, scope=scope)
    t_prof.reset_profiler()
    t_prof.start_profiler('CPU', trace_dir=str(tmp_path))
    exe.run(main, feed=_feed(False), fetch_list=[out], scope=scope)
    t_prof.stop_profiler()
    prof = str(tmp_path / 'prof.json')
    assert t_prof.save_profile(prof) == prof
    saved = json.load(open(prof))
    assert saved['meta']['schema'] == 2 and 'started_at_wall' in \
        saved['meta']
    timeline = str(tmp_path / 'timeline.json')
    subprocess.run([sys.executable, os.path.join(_ROOT, 'tools',
                                                 'timeline.py'),
                    '--profile_path', prof, '--timeline_path', timeline],
                   check=True, capture_output=True)
    evs = [e for e in json.load(open(timeline))['traceEvents']
           if e['ph'] == 'X']
    assert sorted({e['name'] for e in evs}) == sorted(
        {n for n, _, _ in saved['events']})
    assert any(e['name'] == 'mul' for e in evs)


def _serve(pkg, tmp_path):
    """Warm a ModelServer, answer 5 requests one at a time, swap and
    drain the model; the serving span table's calls per name."""
    prof = PROF[pkg]
    main, startup, out = _net(pkg, False)
    exe, scope = pkg.Executor(pkg.CPUPlace()), pkg.Scope()
    exe.run(startup, scope=scope)
    model_dir = str(tmp_path / ('model_' + pkg.__name__))
    with pkg.scope_guard(scope):
        pkg.io.save_inference_model(model_dir, ['x'], [out], exe,
                                    main_program=main)
    prof.reset_profiler()
    with pkg.serving.ModelServer(pkg.CPUPlace(), max_batch_size=4) as srv:
        srv.load_model('m', model_dir)
        srv.warmup()
        rng = np.random.RandomState(1)
        answers = [srv.infer('m', {'x': rng.randn(n, 8).astype('float32')})
                   for n in (1, 3, 2, 4, 1)]
        srv.swap_model('m', model_dir)
        srv.drain('m')
    return {name: st['calls'] for name, st in prof.serving_stats().items()}, \
        answers


def test_serving_spans_equal_paddle_tpu(tmp_path):
    j, j_out = _serve(fluid, tmp_path)
    t, t_out = _serve(pt, tmp_path)
    assert t == j
    assert t['serving/request'] == 5
    assert {'serving/warmup', 'serving/pad', 'serving/batch_run',
            'serving/swap', 'serving/drain'} <= set(t)
    # each package's own random weights: the answers' shapes agree
    assert [np.asarray(a[0]).shape for a in t_out] == \
        [np.asarray(b[0]).shape for b in j_out]
