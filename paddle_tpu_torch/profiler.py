"""Profiler.

Counterpart of paddle_tpu/profiler.py (parity:
python/paddle/fluid/profiler.py + platform/profiler.cc: the per-op event
table with calls/total/max/min/ave, printed by stop_profiler sorted by a
key). Two layers:

- The device trace: ``start_profiler`` / ``stop_profiler`` run
  ``torch.profiler`` (CPU and, where there is a card, CUDA activities)
  and export it as a Chrome trace, ``trace.json`` under ``trace_dir``
  (``trace_path()``), where the JAX package runs
  ``jax.profiler.start_trace``.
- The per-op host table: while profiling is on, the lowering
  (``core/lowering.py``) times each op of a block it runs, with a device
  sync after it (the reference timing each operator's Run()). A training
  region, the forward under autograd and its gradient, is ONE event,
  ``fwd_bwd(value_and_grad)``, as in the JAX package, whose region is one
  XLA program: no op inside it adds an event, so both packages' tables
  have the same keys. Profiled steps run slower: each op waits for the
  card.

Runs outside a profiling window record nothing in the op table. The
serving span table (``record_serving_event``, ``serving_span``) is
always on and cheap: the serving runtime's host sections.
"""
import contextlib
import os
import tempfile
import threading
import time

__all__ = ['cuda_profiler', 'reset_profiler', 'profiler', 'start_profiler',
           'stop_profiler', 'save_profile', 'serving_span',
           'record_serving_event', 'serving_stats', 'trace_path']

_stats = {'runs': 0, 'wall': 0.0}
_trace = {'prof': None, 'dir': None, 'path': None}
_op_profiling = [False]
_op_events = {}   # op_type -> [calls, total_s, max_s, min_s]
_timeline = []    # raw (op_type, start_s, dur_s) while profiling
_TIMELINE_CAP = 200000
_serving_events = {}        # span name -> [calls, total_s, max_s, min_s]
_serving_lock = threading.Lock()
# trace metadata captured at start_profiler, so saved profiles describe
# themselves (run id and the wall-clock anchor of the perf_counter
# timestamps in _timeline)
_trace_meta = {}


def op_profiling_enabled():
    return _op_profiling[0]


def record_op_event(op_type, seconds, start=None):
    ev = _op_events.get(op_type)
    if ev is None:
        _op_events[op_type] = [1, seconds, seconds, seconds]
    else:
        ev[0] += 1
        ev[1] += seconds
        ev[2] = max(ev[2], seconds)
        ev[3] = min(ev[3], seconds)
    if start is not None and len(_timeline) < _TIMELINE_CAP:
        _timeline.append((op_type, start, seconds))


def op_stats():
    """Snapshot of the per-op table:
    op type -> {calls, total_ms, max_ms, min_ms, ave_ms}."""
    return {name: {'calls': ev[0], 'total_ms': ev[1] * 1e3,
                   'max_ms': ev[2] * 1e3, 'min_ms': ev[3] * 1e3,
                   'ave_ms': ev[1] * 1e3 / ev[0]}
            for name, ev in _op_events.items()}


def save_profile(path):
    """Write the raw per-op event stream as JSON for tools/timeline.py
    (parity: the reference saves a profiler proto that tools/timeline.py
    turns into a chrome://tracing file).

    Beside ``events`` the file carries the serving span table and a
    ``meta`` block (the run id, the installed journal's when one is
    active, the wall-clock anchor taken at start_profiler and the save
    time), so a timeline can be matched with its run journal."""
    import json
    import uuid
    from . import observability as _obs
    j = _obs.get_journal()
    meta = {'schema': 2,
            'run_id': j.run_id if j is not None
            else _trace_meta.get('run_id') or uuid.uuid4().hex[:12],
            'saved_at': time.time(),
            'clock': 'perf_counter'}
    meta.update(_trace_meta)
    with open(path, 'w') as f:
        json.dump({'events': [[n, s, d] for n, s, d in _timeline],
                   'serving': serving_stats(),
                   'meta': meta}, f)
    return path


_span_hists = {}   # span name -> observability Histogram (interned)


def record_serving_event(name, seconds):
    """Record one serving-layer span (``serving/pad``,
    ``serving/batch_run``, ``serving/warmup``, ``serving/exact_fallback``,
    ``serving/request``, and the guardrail operations ``serving/drain`` /
    ``serving/swap``). Always on: the spans are host-side and cheap, and
    the serving stats must work without the per-op profiler.
    Thread-safe: spans land from N serving workers at once. Each span
    also goes into the process registry as
    ``serving_span_seconds{span=...}``."""
    with _serving_lock:
        ev = _serving_events.get(name)
        if ev is None:
            _serving_events[name] = [1, seconds, seconds, seconds]
        else:
            ev[0] += 1
            ev[1] += seconds
            ev[2] = max(ev[2], seconds)
            ev[3] = min(ev[3], seconds)
        hist = _span_hists.get(name)
    if hist is None:
        from . import observability as _obs
        hist = _obs.default_registry().histogram(
            'serving_span_seconds', 'host-side serving span wall times',
            span=name)
        with _serving_lock:
            _span_hists[name] = hist
    hist.observe(seconds)


@contextlib.contextmanager
def serving_span(name):
    """Time a serving-runtime section into the serving event table."""
    t0 = time.perf_counter()
    try:
        yield
    finally:
        record_serving_event(name, time.perf_counter() - t0)


def serving_stats():
    """Snapshot of the serving span table:
    name -> {calls, total_ms, max_ms, min_ms, ave_ms}."""
    with _serving_lock:
        return {
            name: {'calls': ev[0], 'total_ms': ev[1] * 1e3,
                   'max_ms': ev[2] * 1e3, 'min_ms': ev[3] * 1e3,
                   'ave_ms': ev[1] * 1e3 / ev[0]}
            for name, ev in _serving_events.items()}


@contextlib.contextmanager
def cuda_profiler(output_file, output_mode=None, config=None):
    """Kept for script parity: the profiler below, its table written to
    ``output_file``."""
    with profiler('All', 'total', output_file):
        yield


def reset_profiler():
    """Zero every host-side table (per-op events, the raw timeline, the
    serving span table, the run and trace metadata), so a phase starts
    clean instead of accumulating over the process's life
    (``Executor.reset_cache_info()`` is the matching knob for the memo
    counters)."""
    _stats['runs'] = 0
    _stats['wall'] = 0.0
    _op_events.clear()
    del _timeline[:]
    _trace_meta.clear()
    with _serving_lock:
        _serving_events.clear()


def _default_trace_dir():
    return os.path.join(tempfile.gettempdir(), 'paddle_tpu_torch_trace')


def trace_path():
    """The Chrome trace the last stop_profiler exported (None if none)."""
    return _trace['path']


def start_profiler(state='All', tracer_option=None, trace_dir=None):
    """Turn the per-op table on and start the device trace into
    ``trace_dir`` (a directory under the temporary directory by
    default)."""
    import torch
    trace_dir = trace_dir or _default_trace_dir()
    _op_profiling[0] = True
    # wall-clock <-> perf_counter anchor for save_profile's readers
    _trace_meta['started_at_wall'] = time.time()
    _trace_meta['started_at_perf'] = time.perf_counter()
    os.makedirs(trace_dir, exist_ok=True)
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    try:
        prof = torch.profiler.profile(activities=acts)
        prof.__enter__()
        _trace.update(prof=prof, dir=trace_dir)
    except Exception:
        _trace.update(prof=None, dir=None)


def _print_table(sorted_key, out=None):
    """Reference-style event table (platform/profiler.cc PrintProfiler)."""
    if not _op_events:
        return
    rows = [(name, ev[0], ev[1], ev[2], ev[3], ev[1] / ev[0])
            for name, ev in _op_events.items()]
    # the reference sorts every key descending (profiler.cc
    # SetSortedFunc); no sorted_key keeps insertion order (kDefault)
    keys = {'calls': 1, 'total': 2, 'max': 3, 'min': 4, 'ave': 5}
    if sorted_key is not None and sorted_key not in keys:
        raise ValueError(
            "The sorted_key must be None or in %s, got %r"
            % (sorted(keys), sorted_key))
    if sorted_key is not None:
        rows.sort(key=lambda r: -r[keys[sorted_key]])
    lines = ["", "------------------------->     Profiling Report     "
             "<-------------------------", ""]
    lines.append("%-28s %8s %12s %12s %12s %12s" %
                 ("Event", "Calls", "Total(ms)", "Max(ms)", "Min(ms)",
                  "Ave(ms)"))
    for name, calls, total, mx, mn, ave in rows:
        lines.append("%-28s %8d %12.4f %12.4f %12.4f %12.4f" %
                     (name, calls, total * 1e3, mx * 1e3, mn * 1e3,
                      ave * 1e3))
    text = "\n".join(lines)
    if out is not None:
        with open(out, 'w') as f:
            f.write(text + "\n")
    print(text)


def stop_profiler(sorted_key=None, profile_path=None):
    """Turn the per-op table off, export the device trace, print the
    table (and write it to ``profile_path``)."""
    _op_profiling[0] = False
    prof, trace_dir = _trace['prof'], _trace['dir']
    _trace.update(prof=None, dir=None)
    if prof is not None:
        try:
            prof.__exit__(None, None, None)
            path = os.path.join(trace_dir, 'trace.json')
            prof.export_chrome_trace(path)
            _trace['path'] = path
            print("[paddle_tpu_torch.profiler] trace written to %s" % path)
        except Exception:
            _trace['path'] = None
    _print_table(sorted_key, profile_path)
    if _stats['runs']:
        print("[paddle_tpu_torch.profiler] %d runs, %.3f s total, "
              "%.3f ms/run" % (_stats['runs'], _stats['wall'],
                               1000.0 * _stats['wall'] / _stats['runs']))


@contextlib.contextmanager
def profiler(state='All', sorted_key=None, profile_path=None,
             tracer_option=None, trace_dir=None):
    start_profiler(state, trace_dir=trace_dir)
    t0 = time.time()
    try:
        yield
    finally:
        # an exception in the body must still stop the trace and clear
        # the op-profiling flag, or every later run stays profiled
        _stats['runs'] += 1
        _stats['wall'] += time.time() - t0
        stop_profiler(sorted_key, profile_path)
