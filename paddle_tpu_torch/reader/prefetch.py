"""Bounded async host-prefetch pipeline.

Counterpart of paddle_tpu/reader/prefetch.py. A training step's host
work (pulling the next reader batch, ``DataFeeder`` conversion, the copy
to the card) runs serially with the card's work unless something pulls
it ahead. :class:`PrefetchPipeline` is that something: a daemon worker
thread drains the source through an optional ``transform`` (batch ->
feed dict) and optional staging onto a device into a bounded queue.

Contract (as the JAX package's):

- **order-preserving**: one worker, one FIFO queue;
- **bounded**: at most ``depth`` converted batches are ever ahead, and a
  slow consumer holds the source back;
- **exceptions at the point of the break**: a source or transform error
  reaches the consumer where the stream broke, as the original
  exception object, not an end of data;
- **clean shutdown**: ``close()`` (or abandoning the iterator) stops the
  worker promptly; a worker that dies without a word is found instead of
  hanging the consumer.

Staging onto the card (:class:`DeviceStager`, the counterpart of
``jax.device_put`` on the worker) copies each host array into a pinned
buffer and from there to the card on a side CUDA stream, so the copy
overlaps the step the card is running. Three orderings keep it right:
the consumer's stream waits on an event recorded after the copies
before it reads them; each staged tensor is marked as used by the
consumer's stream (``record_stream``), so its memory is not handed to
another allocation while that stream may still read it; and a pinned
buffer is refilled only after the event of its last copy has completed.
"""
import collections
import queue
import threading

import numpy as np
import torch

from ..lod import SequenceTensor

__all__ = ['PrefetchPipeline', 'DeviceStager', 'stage_on_device',
           'prefetch_feeds']

_END = object()


class _Err(object):
    __slots__ = ('exc',)

    def __init__(self, exc):
        self.exc = exc


class _Staged(object):
    """A staged value and the event its copies end with (None when they
    ran on the consumer's own stream)."""
    __slots__ = ('value', 'event', 'tensors')

    def __init__(self, value, event, tensors):
        self.value = value
        self.event = event
        self.tensors = tensors

    def ready(self):
        """Order the consumer's current stream after the copies, and mark
        each staged tensor as used by it; returns the value."""
        if self.event is not None:
            stream = torch.cuda.current_stream(self.event.device)
            stream.wait_event(self.event)
            for t in self.tensors:
                t.record_stream(stream)
        return self.value


def _device_of(place):
    if place is None:
        return None
    if isinstance(place, torch.device):
        return place
    return place.torch_device()


class DeviceStager(object):
    """Host arrays onto one device (a padded SequenceTensor's data and
    lengths each as an array). On the card: a side stream, and pinned
    host buffers reused per (shape, dtype), ``slots`` of each in turn; on
    the CPU: a copy into a tensor. Used from one thread."""

    def __init__(self, place, slots=4):
        self.device = _device_of(place)
        self._cuda = self.device.type == 'cuda'
        self._slots = max(int(slots), 1)
        self._stream = torch.cuda.Stream(self.device) if self._cuda \
            else None
        # (shape, dtype) -> deque of [pinned buffer, event of its last
        # copy or None]
        self._pool = collections.defaultdict(collections.deque)
        self.pinned_allocs = 0

    def _pinned(self, arr):
        """The next pinned buffer for ``arr``'s shape and dtype: the
        oldest of its ring once the ring is full and that buffer's last
        copy has completed (the host waits for it), else a new one (a
        buffer of the batch being staged has no event yet)."""
        ring = self._pool[(arr.shape, arr.dtype.str)]
        if len(ring) >= self._slots and ring[0][1] is not None:
            slot = ring.popleft()
            slot[1].synchronize()
        else:
            buf = torch.empty(arr.shape, dtype=torch.from_numpy(
                np.empty(0, arr.dtype)).dtype, pin_memory=True)
            self.pinned_allocs += 1
            slot = [buf, None]
        ring.append(slot)
        return slot

    def _leaf(self, arr, staged, slots):
        arr = np.ascontiguousarray(arr)
        if not self._cuda:
            return torch.tensor(arr)
        slot = self._pinned(arr)
        slot[0].numpy()[...] = arr
        with torch.cuda.stream(self._stream):
            dev = torch.empty(arr.shape, dtype=slot[0].dtype,
                              device=self.device)
            dev.copy_(slot[0], non_blocking=True)
        staged.append(dev)
        slots.append(slot)
        return dev

    def _map(self, value, staged, slots):
        if isinstance(value, SequenceTensor) and not value.packed_mode and \
                value.lengths is not None:
            # padded data and its lengths, each staged like an array
            return SequenceTensor(*(self._map(v, staged, slots) for v in (
                value.data, value.lengths, value.sub_lengths)))
        if isinstance(value, dict):
            return {k: self._map(v, staged, slots)
                    for k, v in value.items()}
        if isinstance(value, (list, tuple)):
            return type(value)(self._map(v, staged, slots) for v in value)
        if isinstance(value, np.ndarray):
            return self._leaf(value, staged, slots)
        return value     # a packed sequence, a tensor, a number: as it is

    def stage(self, value):
        """A ``_Staged`` of ``value`` with every numpy array replaced by a
        tensor on the device."""
        staged, slots = [], []
        out = self._map(value, staged, slots)
        event = None
        if self._cuda and staged:
            event = torch.cuda.Event()
            event.record(self._stream)
            for slot in slots:
                slot[1] = event
        return _Staged(out, event, staged)


def stage_on_device(value, place):
    """``value`` (a feed dict, a tuple, a list) with each numpy array as
    a tensor on ``place``'s device, ready for the caller's stream; None
    leaves it as it is."""
    if place is None:
        return value
    return DeviceStager(place, slots=1).stage(value).ready()


class PrefetchPipeline(object):
    """Iterate a reader ahead of its consumer through a bounded queue.

    ``source``: a reader callable (``source()`` yields batches) or an
    iterable. ``transform``: a per-batch host conversion (e.g.
    ``feeder.feed``) run on the worker thread. ``place``: stage each
    transformed batch on that device, on the worker, through a
    :class:`DeviceStager`.
    """

    def __init__(self, source, transform=None, depth=2, place=None):
        if depth < 1:
            raise ValueError('prefetch depth must be >= 1, got %r'
                             % (depth,))
        self._source = source
        self._transform = transform
        self._place = place
        self._depth = int(depth)
        self._queue = queue.Queue(maxsize=self._depth)
        self._stop = threading.Event()
        self._thread = None
        self._consumed = False
        self.stager = None

    # ---- worker side -------------------------------------------------------------
    def _offer(self, item):
        # never block for good on a full queue: an abandoned consumer
        # sets _stop
        while not self._stop.is_set():
            try:
                self._queue.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def _worker(self):
        try:
            if self._place is not None:
                # a batch in the queue, one the consumer holds, one being
                # filled, and one whose copy may still run
                self.stager = DeviceStager(self._place,
                                           slots=self._depth + 3)
            it = self._source() if callable(self._source) \
                else iter(self._source)
            for batch in it:
                if self._stop.is_set():
                    return
                if self._transform is not None:
                    batch = self._transform(batch)
                if self.stager is not None:
                    batch = self.stager.stage(batch)
                if not self._offer(batch):
                    return
        except BaseException as e:  # reaches the consumer, not as EOF
            self._offer(_Err(e))
            return
        self._offer(_END)

    # ---- consumer side -----------------------------------------------------------
    def _start(self):
        if self._thread is None:
            self._thread = threading.Thread(
                target=self._worker, name='paddle_tpu_torch-prefetch',
                daemon=True)
            self._thread.start()

    def __iter__(self):
        # a plain method, so the single-use check and the worker's start
        # happen at iter(), not at the first next()
        if self._consumed:
            raise RuntimeError(
                'PrefetchPipeline is single-use: build a fresh one per '
                'pass (Trainer does, once per epoch)')
        self._consumed = True
        self._start()
        return self._drain()

    def _drain(self):
        try:
            while True:
                try:
                    item = self._queue.get(timeout=5.0)
                except queue.Empty:
                    if not self._thread.is_alive():
                        raise RuntimeError(
                            'prefetch worker thread died without '
                            'signalling end-of-data')
                    continue
                if item is _END:
                    return
                if isinstance(item, _Err):
                    raise item.exc
                if isinstance(item, _Staged):
                    item = item.ready()
                yield item
        finally:
            self.close()

    def close(self, timeout=5.0):
        """Stop the worker and free the queue's slots. Idempotent; safe
        from any thread."""
        self._stop.set()
        t = self._thread
        if t is not None and t.is_alive() and \
                t is not threading.current_thread():
            while True:
                try:
                    self._queue.get_nowait()
                except queue.Empty:
                    break
            t.join(timeout)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False

    def __del__(self):  # pragma: no cover - GC timing dependent
        try:
            self._stop.set()
        except Exception:
            pass


def prefetch_feeds(reader, feeder, depth=2, place=None):
    """``reader()``'s batches as ``(batch_size, feed_dict)`` pairs, the
    conversion (and the staging on ``place``) running ``depth`` batches
    ahead on a worker thread."""

    def _convert(data):
        try:
            n = len(data)
        except TypeError:
            n = 0
        return n, feeder.feed(data)

    return iter(PrefetchPipeline(reader, transform=_convert, depth=depth,
                                 place=place))
