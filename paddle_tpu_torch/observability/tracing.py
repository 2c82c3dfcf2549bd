"""Distributed tracing: propagated span trees over the run journal.

Counterpart of paddle_tpu/observability/tracing.py, copied whole. A
:class:`TraceContext` is the portable identity of one unit of work —
``trace_id`` (the whole request/step tree), ``span_id`` (this node),
``parent_id`` (its parent) and the sampling decision made once at the
root. Contexts ride request objects across threads, and cross a process
boundary as a ``PTPU_TRACE_PARENT`` env header — every process appends
spans into its *own* journal and ``tools/trace_report.py`` reassembles
the tree by trace id afterwards.

Span records are plain journal events:

=============  =========================================================
``span_begin``  name, trace, span, parent (+ caller fields)
``span_end``    same ids + ``dur_s`` (+ end fields); the only record
                trace_report needs to rebuild a tree — a ``span_begin``
                with no matching ``span_end`` marks work that died
                in flight
``span_link``   trace/span of the *linking* span + ``linked_trace`` /
                ``linked_span``: a coalesced batch span links the N
                request spans it serves (N↔1, not parent-child)
=============  =========================================================

Spans measure host time. On the card, a span around work that only
enqueues kernels (``exe/dispatch``) ends when the host returns, not
when the card does; the span that waits for the device (``exe/fetch``,
the copy to the host) holds that wait.

Overhead contract: with no journal installed every API here returns the
shared :data:`NULL_SPAN` after one module-global ``None`` check — no
allocation, no ids, no clock read. With a journal installed, sampling
is decided once per root from ``PTPU_TRACE_SAMPLE`` (default 1.0) by
hashing the trace id, so a rate of 0.25 keeps whole trees, never
orphan fragments; unsampled trees still propagate one shared inert
context so child processes agree with the root's decision.
"""
import os
import random
import threading
import time
import uuid

from . import flight as _flight
from .journal import emit as _emit, journal_active as _journal_active
from .metrics import default_registry

__all__ = ['TraceContext', 'Span', 'NULL_SPAN', 'start_span', 'span',
           'current_span', 'current_context', 'link', 'emit_span',
           'sample_rate', 'parent_from_env', 'TRACE_PARENT_ENV',
           'TRACE_SAMPLE_ENV']

TRACE_SAMPLE_ENV = 'PTPU_TRACE_SAMPLE'
TRACE_PARENT_ENV = 'PTPU_TRACE_PARENT'

_local = threading.local()


# Id generation is on the per-span hot path (uuid4 costs ~5us; this is
# ~0.5us): 64 random bits XORed with a per-process uuid4-derived salt,
# so even a process that re-seeds the random module cannot collide with
# another process, and the leading 8 hex chars stay uniformly
# distributed (the sampling hash keys on them).
_ID_SALT = uuid.uuid4().int & 0xffffffffffffffff
_randbits = random.getrandbits


def _new_id():
    return '%016x' % (_randbits(64) ^ _ID_SALT)


class TraceContext(object):
    """Immutable-by-convention span identity; pickles (protocol 2+
    handles ``__slots__`` classes)."""

    __slots__ = ('trace_id', 'span_id', 'parent_id', 'sampled')

    def __init__(self, trace_id, span_id, parent_id=None, sampled=True):
        self.trace_id = trace_id
        self.span_id = span_id
        self.parent_id = parent_id
        self.sampled = sampled

    def child(self):
        """A fresh context one level below this one."""
        if not self.sampled:
            return _UNSAMPLED
        return TraceContext(self.trace_id, _new_id(), self.span_id, True)

    def to_header(self):
        """Env-safe wire form for the ``PTPU_TRACE_PARENT`` header."""
        return '%s-%s-%d' % (self.trace_id, self.span_id,
                             1 if self.sampled else 0)

    @classmethod
    def from_header(cls, header):
        """Parse :meth:`to_header` output; None on any malformation
        (a bad env var must never break a worker)."""
        parts = (header or '').strip().split('-')
        if len(parts) != 3 or not parts[0] or not parts[1]:
            return None
        return cls(parts[0], parts[1], None, parts[2] != '0')

    def __repr__(self):
        return 'TraceContext(trace=%s, span=%s, parent=%s, sampled=%s)' \
            % (self.trace_id, self.span_id, self.parent_id, self.sampled)


# One shared inert context for every unsampled tree: propagating it (at
# zero id-generation cost) is what lets a child process inherit the
# root's negative sampling decision instead of re-rolling its own.
_UNSAMPLED = TraceContext('', '', None, False)


class _NullSpan(object):
    """Shared no-op span returned when no journal is installed."""

    __slots__ = ()
    name = None
    context = None

    def end(self, **fields):
        pass

    def activate(self):
        return self

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


NULL_SPAN = _NullSpan()


class Span(object):
    """One live span. End exactly once — via ``with``, or ``end()``
    from whichever thread finishes the work (cross-thread spans are
    created with ``activate=False`` and carried on request objects)."""

    __slots__ = ('name', 'context', '_t0', '_ended', '_prev', '_active',
                 '_tid')

    def __init__(self, name, context):
        self.name = name
        self.context = context
        self._t0 = time.monotonic()
        self._ended = False
        self._prev = None
        self._active = False
        self._tid = 0

    def activate(self):
        """Make this the thread's current span (children nest under
        it). Deactivation happens in ``end()`` on the same thread."""
        self._prev = getattr(_local, 'span', None)
        self._active = True
        self._tid = threading.get_ident()
        _local.span = self
        return self

    def end(self, **fields):
        """Close the span (idempotent) and journal ``span_end`` with
        the measured ``dur_s``. Returns the duration in seconds."""
        dur = time.monotonic() - self._t0
        if self._ended:
            return dur
        self._ended = True
        if self._active and threading.get_ident() == self._tid:
            _local.span = self._prev
            self._active = False
        c = self.context
        if c.sampled:
            _flight.note_span_end(c)
            _emit('span_end', name=self.name, trace=c.trace_id,
                  span=c.span_id, parent=c.parent_id,
                  dur_s=round(dur, 6), **fields)
        return dur

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        if exc_type is not None and not self._ended:
            self.end(error=exc_type.__name__)
        else:
            self.end()
        return False


def sample_rate():
    """The current ``PTPU_TRACE_SAMPLE`` rate, clamped to [0, 1]."""
    try:
        r = float(os.environ.get(TRACE_SAMPLE_ENV, '1'))
    except ValueError:
        return 1.0
    return min(max(r, 0.0), 1.0)


def _sampled(trace_id):
    r = sample_rate()
    if r >= 1.0:
        return True
    if r <= 0.0:
        return False
    # hash of the trace id, not a coin flip: the decision is a pure
    # function of the id, so re-rolls anywhere agree with the root
    return int(trace_id[:8], 16) / float(0xffffffff) < r


_SPANS = None
_LINKS = None


def _spans_counter():
    # registry.reset() zeroes but never replaces metric objects, so a
    # one-time intern is safe to cache on the span hot path
    global _SPANS
    if _SPANS is None:
        _SPANS = default_registry().counter(
            'tracing_spans_started_total', 'sampled spans begun')
    return _SPANS


def _links_counter():
    global _LINKS
    if _LINKS is None:
        _LINKS = default_registry().counter(
            'tracing_links_total', 'batch->request span links')
    return _LINKS


def start_span(name, parent=None, activate=True, **fields):
    """Begin a span and journal ``span_begin``.

    ``parent`` may be a :class:`TraceContext`, a :class:`Span`, or None
    (inherit the thread's current span; a new sampled-or-not root when
    there is none). ``activate=False`` creates a span to carry across
    threads on a request object — the finishing thread calls ``end()``.
    Returns :data:`NULL_SPAN` when no journal is installed.
    """
    if not _journal_active():
        return NULL_SPAN
    if isinstance(parent, Span):
        parent = parent.context
    if parent is None:
        cur = getattr(_local, 'span', None)
        if cur is not None:
            parent = cur.context
    if parent is None:
        tid = _new_id()
        ctx = TraceContext(tid, _new_id(), None, True) \
            if _sampled(tid) else _UNSAMPLED
    else:
        ctx = parent.child()
    sp = Span(name, ctx)
    if ctx.sampled:
        _spans_counter().inc()
        # the flight recorder's live-span table is what lets a
        # postmortem bundle name the work still open at death
        _flight.note_span_begin(name, ctx)
        _emit('span_begin', name=name, trace=ctx.trace_id,
              span=ctx.span_id, parent=ctx.parent_id, **fields)
    if activate:
        sp.activate()
    return sp


def span(name, parent=None, **fields):
    """``with tracing.span('exe/run'): ...`` — an activated span."""
    return start_span(name, parent=parent, activate=True, **fields)


def current_span():
    """The thread's active :class:`Span`, or None."""
    return getattr(_local, 'span', None)


def current_context():
    """The active span's :class:`TraceContext`, or None — what request
    objects capture at creation time."""
    sp = getattr(_local, 'span', None)
    return sp.context if sp is not None else None


def link(from_span, linked_ctx):
    """Journal a ``span_link``: ``from_span`` (a coalesced batch span)
    serves the work identified by ``linked_ctx`` without being its
    parent. trace_report grafts the linked subtree under every request
    it serves when rebuilding per-request trees."""
    if from_span is None or linked_ctx is None:
        return
    ctx = from_span.context if isinstance(from_span, Span) else from_span
    if ctx is None or not ctx.sampled or not linked_ctx.sampled:
        return
    _links_counter().inc()
    _emit('span_link', trace=ctx.trace_id, span=ctx.span_id,
          linked_trace=linked_ctx.trace_id,
          linked_span=linked_ctx.span_id)


def emit_span(name, dur_s, parent=None, **fields):
    """Journal one already-measured span (``span_end`` only, no begin)
    — for retrofitting existing timings (queue waits, step durations)
    without a second clock read. Returns the child context written, or
    None when untraced."""
    if not _journal_active():
        return None
    if isinstance(parent, Span):
        parent = parent.context
    if parent is None:
        parent = current_context()
    if parent is None:
        tid = _new_id()
        ctx = TraceContext(tid, _new_id(), None, True) \
            if _sampled(tid) else _UNSAMPLED
    else:
        ctx = parent.child()
    if not ctx.sampled:
        return None
    _spans_counter().inc()
    _emit('span_end', name=name, trace=ctx.trace_id,
          span=ctx.span_id, parent=ctx.parent_id,
          dur_s=round(dur_s, 6), **fields)
    return ctx


def parent_from_env(environ=None):
    """The :class:`TraceContext` published by a parent process through
    ``PTPU_TRACE_PARENT``, or None."""
    env = os.environ if environ is None else environ
    header = env.get(TRACE_PARENT_ENV)
    if not header:
        return None
    return TraceContext.from_header(header)
