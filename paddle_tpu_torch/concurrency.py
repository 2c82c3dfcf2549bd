"""Go-style channels and select.

Counterpart of paddle_tpu/concurrency.py (parity:
python/paddle/fluid/concurrency.py: Go, make_channel,
channel_send/recv/close, Select). The reference schedules goroutine
sub-blocks on its threaded executor; here, as in the JAX package,
channels are host-side primitives for pipelining readers and trainers
around the device step, under one condition variable a channel, and
``Go`` runs its bodies on daemon threads.
"""
import collections
import contextlib
import time
import threading

__all__ = ['Go', 'make_channel', 'channel_send', 'channel_recv',
           'channel_close', 'Select']


class Channel(object):
    """Typed Go-style channel under one condition variable.

    capacity=0 is a TRUE rendezvous: send() returns only after a
    receiver has taken the value. close() is race-free with send — both
    take the same lock, so a send can never enqueue after close (the
    check-then-put race of a queue.Queue-based channel).
    Values queued before close() still drain through recv() (Go
    semantics); senders still blocked at close() withdraw their
    undelivered item and return False.
    """

    def __init__(self, dtype, capacity=0):
        self.dtype = dtype
        self.capacity = capacity
        self._cond = threading.Condition()
        self._items = collections.deque()   # (value, done_event | None)
        self._recv_waiting = 0
        self._is_closed = False

    def send(self, value):
        with self._cond:
            if self._is_closed:
                return False
            if self.capacity > 0:
                while len(self._items) >= self.capacity:
                    self._cond.wait()
                    if self._is_closed:
                        return False
                self._items.append((value, None))
                self._cond.notify_all()
                return True
            done = threading.Event()
            entry = (value, done)
            self._items.append(entry)
            self._cond.notify_all()
            while not done.is_set():
                if self._is_closed:
                    # withdraw if nobody took it; consumed wins otherwise.
                    # Identity scan, not deque.remove(): == on queued
                    # numpy payloads raises/ambiguates.
                    for idx, queued in enumerate(self._items):
                        if queued is entry:
                            del self._items[idx]
                            return False
                    # not queued -> a receiver popped it; done is being set
                self._cond.wait()
            return True

    def recv(self):
        with self._cond:
            self._recv_waiting += 1
            try:
                while not self._items:
                    if self._is_closed:
                        return False, None
                    self._cond.wait()
                value, done = self._items.popleft()
                if done is not None:
                    done.set()
                self._cond.notify_all()
                return True, value
            finally:
                self._recv_waiting -= 1

    def close(self):
        with self._cond:
            self._is_closed = True
            self._cond.notify_all()

    # ---- Select hooks ------------------------------------------------------
    def try_send(self, value):
        """Atomic non-blocking send: enqueue iff it can complete without
        waiting (room in a buffered channel, or a receiver already
        waiting on a rendezvous channel). Select's send cases use this —
        a separate can_send()-then-send() pair would race another
        selector into a blocked send."""
        with self._cond:
            if self._is_closed:
                return False
            if self.capacity > 0:
                if len(self._items) >= self.capacity:
                    return False
                self._items.append((value, None))
                self._cond.notify_all()
                return True
            if self._recv_waiting <= len(self._items):
                return False
            # a waiting receiver is guaranteed to take it; no need to
            # block for the rendezvous to finish
            self._items.append((value, None))
            self._cond.notify_all()
            return True

    def try_recv(self):
        """Atomic non-blocking recv for Select: (ready, ok, value).
        ready=False means nothing to take and the channel is open — a
        separate can_recv()-then-recv() pair would race another consumer
        into a blocked recv."""
        with self._cond:
            if self._items:
                value, done = self._items.popleft()
                if done is not None:
                    done.set()
                self._cond.notify_all()
                return True, True, value
            if self._is_closed:
                return True, False, None
            return False, False, None

    @property
    def closed(self):
        with self._cond:
            return self._is_closed and not self._items


def make_channel(dtype, capacity=0):
    return Channel(dtype, capacity)


def channel_send(channel, value, is_copy=False):
    if not isinstance(channel, Channel):
        raise TypeError("channel_send needs a Channel")
    return channel.send(value)


def channel_recv(channel, return_value=None):
    if not isinstance(channel, Channel):
        raise TypeError("channel_recv needs a Channel")
    ok, value = channel.recv()
    return value, ok


def channel_close(channel):
    channel.close()


class Go(object):
    """`with Go(): body()` — the body closure runs on a daemon thread
    (the host-side analogue of the reference's go_op sub-block)."""

    def __init__(self, name=None):
        self.name = name
        self._fns = []
        self._threads = []

    def __enter__(self):
        return self

    def run(self, fn, *args, **kwargs):
        self._fns.append((fn, args, kwargs))

    def __exit__(self, exc_type, exc_val, exc_tb):
        if exc_type is not None:
            return False
        for fn, args, kwargs in self._fns:
            t = threading.Thread(target=fn, args=args, kwargs=kwargs,
                                 daemon=True)
            t.start()
            self._threads.append(t)
        return True


class Select(object):
    """Poll several channel actions; run the first ready case.
    Parity (host-side): concurrency.py::Select."""

    def __init__(self, name=None):
        self._cases = []
        self._default = None

    @contextlib.contextmanager
    def case(self, channel_action_fn, channel, value=None, is_copy=False):
        body = []
        yield body.append
        self._cases.append((channel_action_fn, channel, value, body))

    @contextlib.contextmanager
    def default(self):
        body = []
        yield body.append
        self._default = body

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc_val, exc_tb):
        if exc_type is not None:
            return False
        return True

    def run(self):
        while True:
            for action, ch, value, body in self._cases:
                if action is channel_send:
                    if ch.try_send(value):
                        for fn in body:
                            fn()
                        return True
                else:
                    ready, ok, _val = ch.try_recv()
                    if ready:
                        for fn in body:
                            fn()
                        return ok
            if self._default is not None:
                for fn in self._default:
                    fn()
                return True
            # nothing ready and no default: back off instead of busy-spin
            time.sleep(0.001)
