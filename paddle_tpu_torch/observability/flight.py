"""Crash flight recorder: an always-on bounded ring of recent
journal-grade events plus atomic postmortem bundles.

Counterpart of paddle_tpu/observability/flight.py. The journal answers
"what happened over the run", but only when a journal is installed and
only after it flushes. The flight recorder answers "what was happening
*right before* this process died": every
:func:`paddle_tpu_torch.observability.journal.emit` call also lands in a
bounded in-memory ring (a ``collections.deque`` append: no lock, no
serialization, no syscall), whether or not a journal is installed or
trace sampling is on. When something trips (the serving watchdog, a
breaker opening, a replica kill, SIGTERM once a telemetry endpoint
installed the hook), :func:`trip` freezes the ring plus the live
metrics snapshot, the unclosed spans and the health providers'
documents (``telemetry.collect_health``) into one atomic JSON bundle
that ``tools/postmortem.py`` renders after the fact.

The bundle's ``ledgers`` slot stays ``None`` in the port: it reads the
performance observatory's program ledgers (``perf.py``), ROADMAP Queue
A item 6.

Overhead contract: the ring append is a deque append of an
already-built tuple. The JAX package's switch for the ring has no caller
in the port and is left out.

Dump gating: bundles are only written when a directory is configured —
``PTPU_FLIGHT_DIR`` in the environment or :func:`configure` — so unit
tests and library users never find surprise files. :func:`trip` is
fire-and-forget and must never raise: it is called from watchdog and
breaker failure paths where a second failure would mask the first.

Stdlib-only, no package imports at module scope: ``journal.py`` imports
this module, so the dependency arrow points one way (the metrics
snapshot and the health providers are imported lazily at dump time).
"""
import collections
import json
import os
import re
import signal
import threading
import time

__all__ = [
    'FLIGHT_ENV', 'RING_CAPACITY', 'BUNDLE_SCHEMA',
    'note', 'ring', 'clear', 'configure', 'flight_dir', 'trip', 'dump', 'last_bundle',
    'note_span_begin', 'note_span_end', 'live_spans',
    'install_signal_dump', 'read_bundle',
]

# env contract: a process that finds this set dumps postmortem bundles
# into the named directory
FLIGHT_ENV = 'PTPU_FLIGHT_DIR'

RING_CAPACITY = 512
BUNDLE_SCHEMA = 1

# Repeated trips of the same reason (a breaker flapping, a watchdog
# re-tripping every poll) collapse into one bundle per interval.
DUMP_MIN_INTERVAL_S = 1.0

_RING = collections.deque(maxlen=RING_CAPACITY)
_DIR = [None]              # configure() override; None -> env decides
_LOCK = threading.Lock()   # guards dump bookkeeping, not the ring
_LIVE_SPANS = {}           # span_id -> {'name','trace','since_wall'}
_LAST_DUMP = {}            # reason -> monotonic t of last bundle
_SEQ = [0]
_LAST_BUNDLE = [None]
_SIGNAL_INSTALLED = [False]


# ---- the ring -------------------------------------------------------------
def note(ev, fields):
    """Append one journal-grade event to the ring. ``fields`` is the
    already-built dict the journal wiring point holds — it is stored by
    reference and never mutated afterwards (same deferred-encoding
    contract as ``RunJournal.record``)."""
    _RING.append((time.time(), ev, fields))


def ring(last=None):
    """A JSON-ready copy of the ring (oldest first), optionally only
    the ``last`` N events."""
    items = list(_RING)
    if last is not None:
        items = items[-int(last):]
    return [dict(fields, ev=ev, wall=round(wall, 6))
            for wall, ev, fields in items]


def clear():
    """Empty the ring and the live-span table (test/bench isolation)."""
    _RING.clear()
    with _LOCK:
        _LIVE_SPANS.clear()
        _LAST_DUMP.clear()


# ---- live spans -----------------------------------------------------------
# tracing.py calls these from the sampled span create/end paths, so a
# postmortem can name the spans that were still open when the process
# died — the "what was it doing" a closed-span journal cannot answer.
def note_span_begin(name, context):
    with _LOCK:
        _LIVE_SPANS[context.span_id] = {
            'name': name, 'span': context.span_id,
            'trace': context.trace_id, 'since_wall': time.time()}


def note_span_end(context):
    with _LOCK:
        _LIVE_SPANS.pop(context.span_id, None)


def live_spans():
    """Currently-open sampled spans, oldest first."""
    with _LOCK:
        spans = list(_LIVE_SPANS.values())
    return sorted(spans, key=lambda s: s['since_wall'])


# ---- dump gating ----------------------------------------------------------
def configure(directory):
    """Set (or with ``None`` restore env control of) the bundle
    directory. Returns the previous override."""
    prev = _DIR[0]
    _DIR[0] = directory
    return prev


def flight_dir():
    d = _DIR[0]
    if d is not None:
        return d
    return os.environ.get(FLIGHT_ENV) or None


def last_bundle():
    """Path of the most recent bundle this process wrote, or None."""
    return _LAST_BUNDLE[0]


# ---- bundles --------------------------------------------------------------
def _best_effort(fn):
    try:
        return fn()
    except Exception:
        return None


def _health_doc():
    from . import telemetry
    return telemetry.collect_health()


def _ledger_summary():
    """The largest program ledgers: none until the port has the
    performance observatory (``perf.py``)."""
    return None


def _metrics_doc():
    from . import metrics
    return metrics.default_registry().snapshot()


def dump(reason, context=None, directory=None):
    """Write one atomic postmortem bundle; returns its path, or None
    when no directory is configured or the write failed. Never raises."""
    d = directory or flight_dir()
    if not d:
        return None
    try:
        os.makedirs(d)
    except OSError:
        pass
    with _LOCK:
        _SEQ[0] += 1
        seq = _SEQ[0]
    slug = re.sub(r'[^A-Za-z0-9_.-]+', '_', str(reason))[:48] or 'trip'
    bundle = {
        'schema': BUNDLE_SCHEMA,
        'reason': str(reason),
        'wall': time.time(),
        'pid': os.getpid(),
        'context': dict(context or {}),
        'ring': _best_effort(ring) or [],
        'live_spans': _best_effort(live_spans) or [],
        'metrics': _best_effort(_metrics_doc),
        'health': _best_effort(_health_doc),
        'ledgers': _best_effort(_ledger_summary),
    }
    path = os.path.join(d, 'postmortem-%d-%03d-%s.json'
                        % (os.getpid(), seq, slug))
    tmp = path + '.tmp'
    try:
        with open(tmp, 'w') as f:
            json.dump(bundle, f, separators=(',', ':'),
                      default=lambda o: repr(o))
            f.write('\n')
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    except OSError:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        return None
    _LAST_BUNDLE[0] = path
    return path


def trip(reason, /, **context):
    """The one entry point every crash-adjacent wiring point calls:
    ring-record the trip, then (when a bundle directory is configured
    and this reason hasn't dumped within ``DUMP_MIN_INTERVAL_S``) dump
    a bundle. Returns the bundle path or None. Never raises.

    ``reason`` is positional-only so callers may carry their own
    ``reason=`` key in the bundle context (e.g. the breaker's
    open-reason) without colliding with the trip reason."""
    try:
        note('flight_trip', dict(context, reason=str(reason)))
        d = flight_dir()
        if not d:
            return None
        now = time.monotonic()
        with _LOCK:
            last = _LAST_DUMP.get(reason)
            if last is not None and now - last < DUMP_MIN_INTERVAL_S:
                return None
            _LAST_DUMP[reason] = now
        return dump(reason, context=context, directory=d)
    except Exception:
        return None


def read_bundle(path):
    """Parse a bundle file; raises ValueError on schema mismatch (the
    postmortem renderer's strict entry point)."""
    with open(path) as f:
        bundle = json.load(f)
    if not isinstance(bundle, dict) or \
            bundle.get('schema') != BUNDLE_SCHEMA:
        raise ValueError('%s is not a schema-%d postmortem bundle'
                         % (path, BUNDLE_SCHEMA))
    return bundle


# ---- SIGTERM --------------------------------------------------------------
def install_signal_dump(signum=signal.SIGTERM):
    """Chain a bundle dump in front of the existing SIGTERM handler.
    Main-thread only: callers on other threads get False back."""
    if _SIGNAL_INSTALLED[0]:
        return True
    try:
        prev = signal.getsignal(signum)

        def _handler(sig, frame):
            trip('sigterm')
            if callable(prev):
                prev(sig, frame)
            elif prev == signal.SIG_DFL:
                signal.signal(sig, signal.SIG_DFL)
                os.kill(os.getpid(), sig)

        signal.signal(signum, _handler)
    except ValueError:      # not the main thread
        return False
    _SIGNAL_INSTALLED[0] = True
    return True
