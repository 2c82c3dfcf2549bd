"""Hung-batch watchdog: per-stage deadlines over the serving worker's
in-flight work.

Counterpart of paddle_tpu/serving/watchdog.py, copied.

A wedged ``Executor.run`` (device lockup, a pathological compile, an
NFS mount gone away mid-read) used to be invisible: the worker thread
blocks forever, every queued client waits forever, and ``close()``
hangs on ``w.join()``. The watchdog makes that failure mode bounded:

- Workers bracket each stage (pad, batch run) with
  :meth:`Watchdog.enter` / :meth:`Watchdog.exit`, declaring a deadline.
- One daemon thread scans the in-flight table every ``poll_interval``
  seconds. A stage past its deadline is *tripped*: popped from the
  table and handed to ``on_trip`` (the server fails the batch's
  futures with :class:`~paddle_tpu_torch.serving.errors.WatchdogTimeout`,
  opens the model's breaker, and marks the worker wedged).
- A tripped stage's :meth:`exit` returns None, telling the (possibly
  much later) worker its results were already disclaimed.
- :meth:`trip_all` force-trips entries regardless of deadline — the
  ``close(timeout=)`` / drain escalation path uses it to fail in-flight
  futures before abandoning a wedged worker.

The scan is deliberately pull-based (no timers armed per batch): one
thread, one lock, O(in-flight) per tick — in-flight is bounded by the
model count. :meth:`check` is public so tests can drive scans
deterministically without sleeping on the poll interval.
"""
import threading
import time

__all__ = ['Watchdog']


class Watchdog(object):
    """In-flight stage table + the scanning thread.

    ``on_trip(entry)`` receives the popped entry dict: ``model``,
    ``stage``, ``batch``, ``timeout``, ``start``, ``deadline``,
    ``error`` (None for a genuine deadline trip; the forced error for
    :meth:`trip_all`), ``overrun`` (seconds past the deadline).
    """

    def __init__(self, poll_interval=0.05, on_trip=None,
                 clock=time.monotonic):
        self.poll_interval = poll_interval
        self.on_trip = on_trip
        self._clock = clock
        self._lock = threading.Lock()
        self._inflight = {}       # token -> entry dict
        self._seq = 0
        self._stop = threading.Event()
        self._thread = None
        self.trips = 0            # total stages tripped (all models)

    # ---- worker bracket --------------------------------------------------
    def enter(self, model, stage, timeout, batch):
        """Register an in-flight stage; returns an opaque token. Starts
        the scanning thread lazily on first use. ``timeout=None``
        disables the deadline (the entry is still force-trippable)."""
        now = self._clock()
        with self._lock:
            token = self._seq
            self._seq += 1
            self._inflight[token] = {
                'model': model, 'stage': stage, 'batch': batch,
                'timeout': timeout, 'start': now,
                'deadline': None if timeout is None else now + timeout,
                'error': None,
            }
            started = self._thread is not None
        if not started:
            self._ensure_thread()
        return token

    def exit(self, token):
        """Unregister a stage. Returns the entry, or None if the
        watchdog already tripped it (futures failed on the worker's
        behalf — do not complete them)."""
        with self._lock:
            return self._inflight.pop(token, None)

    # ---- scanning --------------------------------------------------------
    def check(self, now=None):
        """One scan: pop every entry past its deadline and fire
        ``on_trip`` for each. Returns the tripped entries. Public so
        tests drive the clock instead of sleeping."""
        now = self._clock() if now is None else now
        tripped = []
        with self._lock:
            for token, entry in list(self._inflight.items()):
                if entry['deadline'] is not None and \
                        now > entry['deadline']:
                    tripped.append(self._inflight.pop(token))
        for entry in tripped:
            entry['overrun'] = now - entry['deadline']
            self._fire(entry)
        return tripped

    def trip_all(self, model=None, error=None):
        """Force-trip every in-flight entry (optionally one model's),
        deadline or not — the shutdown/abandon escalation. ``error``
        rides on the entry for ``on_trip`` to raise instead of the
        default WatchdogTimeout."""
        now = self._clock()
        with self._lock:
            victims = [self._inflight.pop(token)
                       for token, entry in list(self._inflight.items())
                       if model is None or entry['model'] == model]
        for entry in victims:
            entry['error'] = error
            entry['overrun'] = 0.0 if entry['deadline'] is None \
                else max(0.0, now - entry['deadline'])
            self._fire(entry)
        return victims

    def _fire(self, entry):
        self.trips += 1
        cb = self.on_trip
        if cb is not None:
            cb(entry)

    # ---- lifecycle -------------------------------------------------------
    def _ensure_thread(self):
        with self._lock:
            if self._thread is not None or self._stop.is_set():
                return
            self._thread = threading.Thread(
                target=self._loop, name='serve-watchdog', daemon=True)
            self._thread.start()

    def _loop(self):
        while not self._stop.wait(self.poll_interval):
            self.check()

    def stop(self, timeout=1.0):
        """Stop the scanning thread (server close). Idempotent."""
        self._stop.set()
        t = self._thread
        if t is not None and t.is_alive():
            t.join(timeout)

    def inflight(self):
        with self._lock:
            return len(self._inflight)
