"""Structured JSONL run journal.

Counterpart of paddle_tpu/observability/journal.py. One
:class:`RunJournal` == one run artifact: an append-only file of
newline-delimited JSON records, each carrying the run id, a monotonic
timestamp (seconds since the journal opened), and typed fields. The
first line is always a ``run_begin`` header anchoring the monotonic
clock to wall-clock time, so the file is self-describing.

Events the port writes (the JAX package's names and fields):

=====================  =================================================
``run_begin``          header: wall-clock anchor, pid, schema version
``compile_begin`` / ``compile_end``  a memo miss's prune, passes and
                       lowering: program fingerprint, dur_s
``compile_pass``       one pass application: pass, changed, removed,
                       fused, released, dur_s
``exe_run``            one Executor.run: cache='hit'|'miss', dur_s
``tuning_preload`` / ``tuning_lookup`` / ``tuning_put`` /
``tuning_search`` / ``autotune``  the tuning cache and the search
``serving_admit`` / ``serving_shed`` / ``serving_expired`` /
``serving_failed`` / ``serving_retry``  request outcomes
``serving_batch``      rows, bucket, dur_s
``serving_breaker``    model, to (closed|half_open|open), reason
``serving_breaker_rejected`` / ``serving_cancelled``  guardrail sheds
``serving_watchdog_trip``  model, stage, failed, overrun_s
``serving_warmup``     models, buckets, tuning entries, searches, dur_s
``serving_drain`` / ``serving_swap`` / ``serving_abandoned_worker``
``span_begin`` / ``span_end`` / ``span_link``  distributed tracing
                       (tracing.py): name, trace/span/parent ids, dur_s
``flight_trip``        (ring only) a flight-recorder trip
=====================  =================================================

Records with a ``dur_s`` field are SPANS: ``tools/obs_report.py`` ranks
the slowest ones and ``tools/trace_report.py`` rebuilds span trees.

Overhead contract: journalling is OFF by default — every wiring point
goes through :func:`emit`, which is a module-global ``None`` check
(after the flight recorder's ring append) when no journal is installed.
With a journal installed, records buffer in memory as dicts and flush
every ``buffer_lines`` records (or ``flush_interval`` seconds), so the
hot path pays one dict build and a list append — JSON serialization is
batched into the flush, and there is never a syscall per event.
"""
import contextlib
import json
import os
import threading
import time
import uuid

from . import flight as _flight

__all__ = ['SCHEMA_VERSION', 'JOURNAL_ENV', 'RunJournal', 'set_journal',
           'get_journal', 'journal', 'journal_active', 'emit',
           'read_journal', 'install_env_journal']

SCHEMA_VERSION = 1

# env contract: a process that finds this set installs a RunJournal at
# the named path for its whole lifetime — every process writes its OWN
# file
JOURNAL_ENV = 'PTPU_JOURNAL'


def _jsonable(obj):
    """json.dumps fallback: numpy scalars -> python numbers, everything
    else -> repr (a journal write must never throw on a field type)."""
    try:
        return float(obj)
    except (TypeError, ValueError):
        return repr(obj)


# json.dumps with a ``default=`` argument builds a fresh JSONEncoder on
# every call — measurable on the per-record hot path. One shared
# encoder (stateless, thread-safe) halves the serialization cost.
_ENCODER = json.JSONEncoder(separators=(',', ':'), default=_jsonable)


class RunJournal(object):
    """Buffered, thread-safe JSONL event writer with a stable run id."""

    def __init__(self, path, run_id=None, buffer_lines=128,
                 flush_interval=2.0, max_bytes=None, max_rotations=1):
        self.path = path
        self.run_id = run_id or uuid.uuid4().hex[:12]
        self._lock = threading.Lock()
        self._buf = []
        self._closed = False
        self._buffer_lines = int(buffer_lines)
        self._flush_interval = float(flush_interval)
        self._max_bytes = int(max_bytes) if max_bytes else 0
        self._max_rotations = max(1, int(max_rotations))
        self._bytes = 0
        self.rotations = 0
        self._t0 = time.monotonic()
        self._wall0 = time.time()
        self._last_flush = self._t0
        self._f = open(path, 'w')
        self.counts = {}   # event type -> records written (introspection)
        self.record('run_begin', wall=self._wall0, pid=os.getpid(),
                    schema=SCHEMA_VERSION)

    # ---- writing ---------------------------------------------------------
    def record(self, ev, **fields):
        """Append one typed event. Never raises on field types; silently
        drops records after close (late worker threads)."""
        now = time.monotonic()
        rec = {'ev': ev, 'run': self.run_id,
               't': round(now - self._t0, 6)}
        rec.update(fields)
        with self._lock:
            if self._closed:
                return
            self._buf.append(rec)
            self.counts[ev] = self.counts.get(ev, 0) + 1
            if len(self._buf) >= self._buffer_lines or \
                    now - self._last_flush >= self._flush_interval:
                self._flush_locked(now)

    @contextlib.contextmanager
    def span(self, ev, **fields):
        """Time a block into one record with ``dur_s``."""
        t0 = time.monotonic()
        try:
            yield
        finally:
            self.record(ev, dur_s=round(time.monotonic() - t0, 6),
                        **fields)

    def _flush_locked(self, now):
        if self._buf:
            # records buffer as dicts; serialization is batched here,
            # off the per-event hot path (fields are never mutated
            # after record(), so deferred encoding sees the same data)
            enc = _ENCODER.encode
            chunk = '\n'.join(enc(r) for r in self._buf) + '\n'
            self._f.write(chunk)
            self._f.flush()
            self._bytes += len(chunk)
            del self._buf[:]
            if self._max_bytes and self._bytes >= self._max_bytes:
                self._rotate_locked()
        self._last_flush = now

    def _rotate_locked(self):
        """Roll the current file into a ``<path>.1`` .. ``<path>.N``
        shift chain (``max_rotations`` generations kept; the default of
        one preserves the historic single-``.1`` behavior, a postmortem
        that needs to reach further back raises it) and restart the
        live file with a fresh ``run_begin`` carrying the ORIGINAL wall
        anchor — ``t`` offsets keep counting from the run's ``_t0``, so
        clock alignment in timeline/trace_report is unchanged across a
        rotation."""
        self._f.close()
        for i in range(self._max_rotations - 1, 0, -1):
            src = '%s.%d' % (self.path, i)
            if os.path.exists(src):
                os.replace(src, '%s.%d' % (self.path, i + 1))
        os.replace(self.path, self.path + '.1')
        self._f = open(self.path, 'w')
        self._bytes = 0
        self.rotations += 1
        rec = {'ev': 'run_begin', 'run': self.run_id,
               't': round(time.monotonic() - self._t0, 6),
               'wall': self._wall0, 'pid': os.getpid(),
               'schema': SCHEMA_VERSION, 'rotated': self.rotations}
        line = json.dumps(rec, separators=(',', ':'), default=_jsonable)
        self._f.write(line + '\n')
        self._f.flush()
        self._bytes += len(line) + 1
        self.counts['run_begin'] = self.counts.get('run_begin', 0) + 1

    def flush(self):
        with self._lock:
            if not self._closed:
                self._flush_locked(time.monotonic())

    def close(self):
        with self._lock:
            if self._closed:
                return
            self._flush_locked(time.monotonic())
            self._closed = True
            self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False


# ---- global install ------------------------------------------------------
_JOURNAL = None


def set_journal(j):
    """Install ``j`` (or None) as the process journal every built-in
    wiring point emits to. Returns the previous journal."""
    global _JOURNAL
    prev = _JOURNAL
    _JOURNAL = j
    return prev


def get_journal():
    return _JOURNAL


def journal_active():
    return _JOURNAL is not None


@contextlib.contextmanager
def journal(path, run_id=None, **kwargs):
    """Open a RunJournal at ``path`` and install it for the block::

        with observability.journal('run.jsonl') as j:
            trainer.train(...)
    """
    j = RunJournal(path, run_id=run_id, **kwargs)
    prev = set_journal(j)
    try:
        yield j
    finally:
        set_journal(prev)
        j.close()


def install_env_journal(**kwargs):
    """Honor the ``PTPU_JOURNAL`` env contract: install a RunJournal at
    the named path for the process lifetime. A worker process calls
    this once at startup; returns the journal, or None when the env var
    is unset or a journal is already installed."""
    path = os.environ.get(JOURNAL_ENV)
    if not path or _JOURNAL is not None:
        return None
    j = RunJournal(path, **kwargs)
    set_journal(j)
    return j


def emit(ev, **fields):
    """Record into the installed journal — a module-global None check
    when none is installed, safe on any hot path — AND mirror the event
    into the flight recorder's bounded ring (flight.py), which stays on
    even without a journal so a postmortem bundle always has the last
    ~N events leading up to a trip."""
    _flight.note(ev, fields)
    j = _JOURNAL
    if j is not None:
        j.record(ev, **fields)


# ---- reading -------------------------------------------------------------
def read_journal(path):
    """Parse a journal file -> (records, malformed_line_count). Blank
    lines are ignored; any other unparsable line counts as malformed
    (the obs_report smoke gate turns that into a failure)."""
    records, malformed = [], 0
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
            except ValueError:
                malformed += 1
                continue
            if not isinstance(rec, dict) or 'ev' not in rec:
                malformed += 1
                continue
            records.append(rec)
    return records, malformed
