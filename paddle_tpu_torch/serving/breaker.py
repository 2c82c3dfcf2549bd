"""Per-model circuit breaker: stop burning device time on a model
whose batches keep failing.

Counterpart of paddle_tpu/serving/breaker.py. State machine::

            consecutive failures >= failure_threshold
            OR windowed failure rate >= failure_rate
    CLOSED ------------------------------------------> OPEN
      ^                                                 |
      | probe_successes consecutive                     | cooldown
      | probe successes                                 v
      +----------------------------- HALF_OPEN <--------+
                                        |
                                        | any probe failure
                                        +--------------> OPEN

- CLOSED: everything is admitted; outcomes are tallied (a consecutive
  counter plus a sliding window of the last ``window`` outcomes).
- OPEN: :meth:`admit` raises :class:`CircuitOpen` — the request is
  shed at the server's admission door before it touches a queue. After
  ``cooldown`` seconds the next ``state`` read transitions to
  HALF_OPEN.
- HALF_OPEN: at most ``max_probes`` requests are admitted at a time as
  probes. ``probe_successes`` consecutive successes re-close the
  breaker; a single failure re-opens it (restarting the cooldown).

Determinism: no hidden wall-clock reads — the clock is injectable, and
every transition lands in :attr:`transitions` so tests and the chaos
harness can assert the exact open → half-open → closed schedule.
Thread-safety: one lock; ``admit``/``record_*`` are called from client
and worker threads concurrently.
"""
import collections
import threading
import time

from .errors import CircuitOpen

__all__ = ['CircuitBreaker', 'CLOSED', 'HALF_OPEN', 'OPEN', 'STATE_CODES']

CLOSED, HALF_OPEN, OPEN = 'closed', 'half_open', 'open'

# gauge encoding for serving_breaker_state{model=...}
STATE_CODES = {CLOSED: 0, HALF_OPEN: 1, OPEN: 2}


class CircuitBreaker(object):
    """One breaker per served model.

    Parameters
    ----------
    name : str
        The model name (labels metrics/journal events).
    failure_threshold : int
        Consecutive hard failures that open the breaker.
    window / failure_rate :
        Sliding window of the last ``window`` outcomes; once full, a
        failure pushing the fraction of failures to >= ``failure_rate``
        also opens the breaker (catches steady partial failure that
        never runs ``failure_threshold`` in a row).
    cooldown : float
        Seconds to stay OPEN before probing (HALF_OPEN).
    probe_successes : int
        Consecutive successful probes that re-close the breaker.
    max_probes : int
        Probes admitted concurrently while HALF_OPEN.
    clock : callable
        Monotonic time source (injectable for deterministic tests).
    on_transition : callable, optional
        ``on_transition(name, to_state, reason)``; the server wires
        this into its stats, the metrics and the run journal.
    """

    def __init__(self, name='', failure_threshold=5, window=20,
                 failure_rate=0.5, cooldown=1.0, probe_successes=2,
                 max_probes=1, clock=time.monotonic, on_transition=None):
        if failure_threshold < 1:
            raise ValueError('failure_threshold must be >= 1')
        if not 0.0 < failure_rate:
            raise ValueError('failure_rate must be > 0')
        self.name = name
        self.failure_threshold = failure_threshold
        self.failure_rate = failure_rate
        self.cooldown = cooldown
        self.probe_successes = probe_successes
        self.max_probes = max_probes
        self._clock = clock
        self._on_transition = on_transition
        self._lock = threading.Lock()
        self._state = CLOSED
        self._consecutive = 0
        self._window = collections.deque(maxlen=max(1, int(window)))
        self._opened_at = None
        self._probes_inflight = 0
        self._probe_streak = 0
        self.transitions = []     # [(to_state, reason), ...] in order

    # ---- state -----------------------------------------------------------
    @property
    def state(self):
        """Current state; reading it performs the time-based
        OPEN -> HALF_OPEN transition once ``cooldown`` has elapsed."""
        with self._lock:
            self._maybe_half_open()
            return self._state

    def _maybe_half_open(self):
        # caller holds the lock
        if self._state == OPEN and \
                self._clock() - self._opened_at >= self.cooldown:
            self._transition(HALF_OPEN, 'cooldown elapsed')

    def _transition(self, to, reason):
        # caller holds the lock
        self._state = to
        self.transitions.append((to, reason))
        if to == OPEN:
            self._opened_at = self._clock()
        if to in (HALF_OPEN, CLOSED):
            self._probes_inflight = 0
            self._probe_streak = 0
        if to == CLOSED:
            self._consecutive = 0
            self._window.clear()
        cb = self._on_transition
        if cb is not None:
            cb(self.name, to, reason)

    # ---- admission (client threads) --------------------------------------
    def admit(self):
        """Gate one request. Raises :class:`CircuitOpen` when the
        breaker is OPEN, or HALF_OPEN with all probe slots taken.
        Returns True when the admission took a half-open probe slot
        (the caller marks the request so an expiry can release it)."""
        with self._lock:
            self._maybe_half_open()
            if self._state == CLOSED:
                return False
            if self._state == HALF_OPEN:
                if self._probes_inflight < self.max_probes:
                    self._probes_inflight += 1
                    return True
                raise CircuitOpen(
                    'model %r: breaker half-open, %d probe(s) already '
                    'in flight' % (self.name, self._probes_inflight),
                    retry_after=0.0)
            remaining = self.cooldown - (self._clock() - self._opened_at)
            raise CircuitOpen(
                'model %r: breaker open (%d consecutive failures); '
                'probing in %.3fs' % (self.name, self._consecutive,
                                      max(0.0, remaining)),
                retry_after=max(0.0, remaining))

    def release_probe(self):
        """Undo one :meth:`admit` that never reached a worker (the
        enqueue itself failed): frees the half-open probe slot."""
        with self._lock:
            if self._state == HALF_OPEN and self._probes_inflight > 0:
                self._probes_inflight -= 1

    # ---- outcomes (worker threads) ---------------------------------------
    def record_success(self):
        with self._lock:
            self._maybe_half_open()
            if self._state == CLOSED:
                self._consecutive = 0
                self._window.append(False)
            elif self._state == HALF_OPEN:
                if self._probes_inflight > 0:
                    self._probes_inflight -= 1
                self._probe_streak += 1
                if self._probe_streak >= self.probe_successes:
                    self._transition(
                        CLOSED, '%d probe successes' % self._probe_streak)
            # OPEN: a straggler from before the trip — ignore

    def record_failure(self):
        with self._lock:
            self._maybe_half_open()
            if self._state == CLOSED:
                self._consecutive += 1
                self._window.append(True)
                if self._consecutive >= self.failure_threshold:
                    self._transition(
                        OPEN, '%d consecutive failures'
                        % self._consecutive)
                elif len(self._window) == self._window.maxlen:
                    rate = sum(self._window) / float(len(self._window))
                    if rate >= self.failure_rate:
                        self._transition(
                            OPEN, 'windowed failure rate %.2f' % rate)
            elif self._state == HALF_OPEN:
                self._transition(OPEN, 'probe failed')
            # OPEN: already tripped — ignore

    def trip(self, reason='tripped'):
        """Force OPEN regardless of counters (watchdog path)."""
        with self._lock:
            if self._state != OPEN:
                self._transition(OPEN, reason)
            else:
                self._opened_at = self._clock()   # restart the cooldown

    def reset(self, reason='reset'):
        """Force CLOSED with clean counters (hot model swap installs a
        fresh replacement that earned a clean slate)."""
        with self._lock:
            if self._state != CLOSED:
                self._transition(CLOSED, reason)
            self._consecutive = 0
            self._window.clear()

    # ---- introspection ---------------------------------------------------
    def snapshot(self):
        with self._lock:
            self._maybe_half_open()
            return {
                'state': self._state,
                'consecutive_failures': self._consecutive,
                'window': list(self._window),
                'probes_inflight': self._probes_inflight,
                'probe_streak': self._probe_streak,
                'transitions': list(self.transitions),
            }

    def __repr__(self):
        return 'CircuitBreaker(%r, state=%r)' % (self.name, self.state)
