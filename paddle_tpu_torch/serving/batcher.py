"""Dynamic micro-batching: a thread-safe bounded request queue plus the
coalescing logic that packs compatible requests into one padded batch.

Counterpart of paddle_tpu/serving/batcher.py. The batcher is where
serving throughput comes from: N concurrent clients each sending a
handful of rows become one bucket-shaped Executor.run. Requests
coalesce only when *compatible*: same feed names, per-row shapes, and
dtypes, so the merged tensor concatenates cleanly along the batch dim
(a level-1 sequence feed counts a sequence a row, its padded length
part of the row's shape).
"""
import collections
import threading
import time

import numpy as np

from ..lod import SequenceTensor
from .errors import ServerOverloaded, ServerClosed

__all__ = ['InferenceRequest', 'MicroBatcher', 'merge_requests',
           'split_fetches']


def _now():
    return time.monotonic()


class InferenceRequest(object):
    """One client call: dense feeds + an optional absolute deadline.
    Completed exactly once (result or error); ``result()`` blocks the
    calling client thread on an Event, never a busy-wait."""

    __slots__ = ('feeds', 'n', 'signature', 'deadline', 'submit_time',
                 '_event', '_result', '_error', 'warmup', 'probe',
                 'trace', '_qspan')

    def __init__(self, feeds, n, deadline=None, warmup=False,
                 trace=None):
        self.feeds = feeds
        self.n = n
        self.signature = tuple(sorted(
            (name,) + _row_spec(arr) for name, arr in feeds.items()))
        self.deadline = deadline          # absolute time.monotonic()
        self.submit_time = _now()
        self.warmup = warmup
        self.probe = False    # admitted as a half-open breaker probe
        self._event = threading.Event()
        self._result = None
        self._error = None
        self.trace = trace    # TraceContext propagated from the caller
        self._qspan = None    # serving/request span, ended at completion

    def expired(self, now=None):
        return self.deadline is not None and \
            (now if now is not None else _now()) > self.deadline

    def set_result(self, fetches):
        if self._qspan is not None:
            self._qspan.end(ok=True)
        self._result = fetches
        self._event.set()

    def set_error(self, error):
        self._error = error
        # an errored completion still closes the serving/request span
        # (with the error name), so only work that died with its whole
        # process shows up as an UNCLOSED span in trace_report
        if self._qspan is not None:
            self._qspan.end(error=type(error).__name__)
        self._error = error
        self._event.set()

    def done(self):
        return self._event.is_set()

    def result(self, timeout=None):
        """Block until completed; raises the server-side error if the
        request failed, TimeoutError if ``timeout`` elapses first."""
        if not self._event.wait(timeout):
            raise TimeoutError(
                'inference result not ready within %.3fs' % timeout)
        if self._error is not None:
            raise self._error
        return self._result

    def latency(self):
        return _now() - self.submit_time


class MicroBatcher(object):
    """Bounded per-model queue + batch assembly, drained by one worker.

    Admission (``submit``) is the load-shedding point: a full queue
    raises :class:`ServerOverloaded` without enqueueing, so an
    overloaded server's cost per rejected request is one lock
    acquisition. ``next_batch`` blocks until work arrives, drops
    requests whose deadline already passed (completing them with
    :class:`DeadlineExceeded`), then greedily coalesces compatible
    requests up to ``max_rows`` — waiting at most ``batch_timeout`` for
    stragglers once it holds at least one request.
    """

    def __init__(self, max_queue_depth=128):
        self.max_queue_depth = max_queue_depth
        self._queue = collections.deque()
        self._cond = threading.Condition()
        self._closed = False
        self._paused = False

    # ---- producer side ---------------------------------------------------
    def submit(self, request):
        with self._cond:
            if self._closed:
                raise ServerClosed('server is shut down')
            if len(self._queue) >= self.max_queue_depth:
                raise ServerOverloaded(
                    'queue depth %d at limit; request shed'
                    % len(self._queue))
            self._queue.append(request)
            self._cond.notify()
        return request

    def depth(self):
        with self._cond:
            return len(self._queue)

    # ---- control ---------------------------------------------------------
    def pause(self):
        """Stop draining (maintenance / drain-control). Queued and new
        requests wait; admission control and deadlines still apply."""
        with self._cond:
            self._paused = True

    def resume(self):
        with self._cond:
            self._paused = False
            self._cond.notify_all()

    def close(self, abort=False):
        """Begin graceful shutdown: no new submissions; the worker keeps
        draining until the queue is empty, then ``next_batch`` returns
        None. With ``abort`` (a crash) the queue is emptied in the same
        step and its requests returned, so the worker never takes one:
        the caller fails them. Returns the requests taken (none without
        ``abort``)."""
        with self._cond:
            self._closed = True
            self._paused = False
            pending = list(self._queue) if abort else []
            if abort:
                self._queue.clear()
            self._cond.notify_all()
        return pending

    def drain_pending(self):
        """Pop and return every still-queued request — the shutdown
        escalation path: when the worker is wedged and can't drain the
        queue, the caller fails these futures itself (typed
        ServerClosed) instead of leaving clients blocked forever."""
        with self._cond:
            pending = list(self._queue)
            self._queue.clear()
        return pending

    # ---- consumer side (the model's worker thread) -----------------------
    def _pop_ready(self, expired_out):
        """Pop the next non-expired request; expired ones go to
        ``expired_out``. Caller holds the lock."""
        now = _now()
        while self._queue:
            req = self._queue.popleft()
            if req.expired(now):
                expired_out.append(req)
            else:
                return req
        return None

    def next_batch(self, max_rows, batch_timeout=0.0):
        """Block for the next ``(batch, expired)`` pair. ``batch`` is a
        non-empty list of compatible requests, or None once the queue is
        closed and fully drained. ``expired`` holds requests whose
        deadline passed in the queue — the caller completes them with
        :class:`DeadlineExceeded` and counts them."""
        expired = []
        with self._cond:
            while True:
                if not self._paused:
                    first = self._pop_ready(expired)
                    if first is not None:
                        break
                    if self._closed:
                        return None, expired
                    if expired:
                        # nothing runnable but requests died in queue:
                        # hand them back NOW (batch empty) so the worker
                        # completes them with DeadlineExceeded instead
                        # of sitting on them until the next live request
                        return [], expired
                elif self._closed and not self._queue:
                    return None, expired
                self._cond.wait(timeout=0.05)
            batch, rows = [first], first.n
            if first.warmup:
                # warmup requests are shape probes: each must run alone
                # at exactly its bucket size, never merged into a
                # bigger (different-bucket) batch
                return batch, expired
            # greedy coalesce; brief straggler wait while under-full
            wait_until = _now() + max(0.0, batch_timeout)
            while rows < max_rows:
                nxt = None
                if self._queue and not self._paused:
                    if self._queue[0].expired():
                        expired.append(self._queue.popleft())
                        continue
                    if not self._queue[0].warmup and \
                            self._queue[0].signature == first.signature \
                            and rows + self._queue[0].n <= max_rows:
                        nxt = self._queue.popleft()
                    else:
                        break          # head incompatible: keep FIFO order
                if nxt is not None:
                    batch.append(nxt)
                    rows += nxt.n
                    continue
                remaining = wait_until - _now()
                if remaining <= 0 or self._closed:
                    break
                self._cond.wait(timeout=remaining)
        return batch, expired


def _row_spec(arr):
    """What two requests' feeds must share to coalesce: the per-row
    shape and dtype (a sequence feed's padded [T, ...] rows, so merged
    sequences need no re-padding)."""
    if isinstance(arr, SequenceTensor):
        return (arr.data.shape[1:], str(arr.data.dtype), 'lod')
    return (arr.shape[1:], str(arr.dtype))


def merge_requests(batch):
    """Concatenate the batch's feeds along the leading dim (a sequence
    feed's sequences one after another). Returns (feed dict, total rows,
    row slices per request)."""
    total = sum(r.n for r in batch)
    slices, offset = [], 0
    for r in batch:
        slices.append((offset, offset + r.n))
        offset += r.n
    if len(batch) == 1:
        return dict(batch[0].feeds), total, slices
    feed = {}
    for name in batch[0].feeds:
        vals = [r.feeds[name] for r in batch]
        if isinstance(vals[0], SequenceTensor):
            feed[name] = SequenceTensor(
                np.concatenate([v.data for v in vals], axis=0),
                np.concatenate([v.lengths for v in vals], axis=0))
        else:
            feed[name] = np.concatenate(vals, axis=0)
    return feed, total, slices


def split_fetches(fetches, slices, total_rows, bucket):
    """Split a bucket-shaped run's fetches back into per-request lists.
    Returns None when any fetch is not row-aligned (its leading dim is
    not the bucket size) — the caller must fall back to per-request
    exact runs. A level-1 sequence fetch (a sequence a row) splits with
    its lengths."""
    for f in fetches:
        if not (hasattr(f, 'shape') and tuple(f.shape[:1]) == (bucket,)):
            return None
    return [[_rows(f, a, b) for f in fetches] for a, b in slices]


def _rows(f, a, b):
    if isinstance(f, SequenceTensor):
        return SequenceTensor(f.data[a:b], f.lengths[a:b],
                              None if f.sub_lengths is None
                              else f.sub_lengths[a:b])
    return f[a:b]
