"""Reader decorators.

Counterpart of paddle_tpu/reader/__init__.py (parity:
python/paddle/reader/decorator.py and python/paddle/batch.py): pure
host-side composable iterators feeding DataFeeder. paddle_tpu's
``prefetch`` (staging batches on the device) is not ported yet.
"""
import itertools
import random
import threading
import queue as Queue

__all__ = ['map_readers', 'buffered', 'compose', 'chain', 'shuffle',
           'ComposeNotAligned', 'firstn', 'xmap_readers', 'batch',
           'retry_reader']


def retry_reader(reader, max_attempts=3, backoff=0.05, jitter=0.1,
                 retry_on=(IOError, OSError), sleep=None):
    """Absorb transient source errors: when the underlying reader
    raises a ``retry_on`` error mid-iteration, re-open it and fast
    forward past the items already delivered, so the consumer sees an
    uninterrupted stream (no duplicates, no holes). The attempt budget
    resets whenever progress is made since the last failure; a source
    that fails ``max_attempts`` times without yielding anything new
    propagates the error wrapped in
    :class:`~paddle_tpu_torch.resilience.retry.RetryError`.

    The trade-off is that of any re-openable stream: the source must be
    restartable and deterministic up to the failure point (recordio
    files, dataset generators are; an already-shuffled stream should be
    wrapped BEFORE ``shuffle``).
    """
    import time as _time
    from ..resilience.retry import RetryError, _jitter_rng, logger
    sleep = sleep or _time.sleep

    def robust_reader():
        delivered = 0
        failures_since_progress = 0
        while True:
            it = reader()
            to_skip = delivered  # fast-forward past items already out
            skipped = 0
            progressed = False
            try:
                for item in it:
                    if skipped < to_skip:
                        skipped += 1
                        continue
                    yield item
                    delivered += 1
                    progressed = True
                return
            except retry_on as e:  # noqa: B902 — tuple from caller
                if progressed:
                    failures_since_progress = 1
                else:
                    failures_since_progress += 1
                if failures_since_progress >= max_attempts:
                    raise RetryError('retry_reader',
                                     failures_since_progress, e) from e
                delay = backoff * (2 ** (failures_since_progress - 1))
                if jitter:
                    delay *= 1.0 + _jitter_rng.uniform(0.0, jitter)
                logger.warning(
                    'retry_reader: source failed at item %d (%r); '
                    'reopening (attempt %d/%d, sleeping %.3fs)',
                    delivered, e, failures_since_progress, max_attempts,
                    delay)
                if delay > 0:
                    sleep(delay)

    return robust_reader


def batch(reader, batch_size, drop_last=False):
    """Parity: python/paddle/batch.py: the ragged tail batch IS yielded
    (reference batch.py:34), so a dataset smaller than one batch still
    trains; pass drop_last=True to keep every batch's shape."""

    def batch_reader():
        r = reader()
        b = []
        for instance in r:
            b.append(instance)
            if len(b) == batch_size:
                yield b
                b = []
        if b and not drop_last:
            yield b

    return batch_reader


def map_readers(func, *readers):
    def reader():
        rs = []
        for r in readers:
            rs.append(r())
        for e in map(func, *rs):
            yield e

    return reader


def shuffle(reader, buf_size):
    def data_reader():
        buf = []
        for e in reader():
            buf.append(e)
            if len(buf) >= buf_size:
                random.shuffle(buf)
                for b in buf:
                    yield b
                buf = []
        if len(buf) > 0:
            random.shuffle(buf)
            for b in buf:
                yield b

    return data_reader


def chain(*readers):
    def reader():
        rs = []
        for r in readers:
            rs.append(r())
        for e in itertools.chain(*rs):
            yield e

    return reader


class ComposeNotAligned(ValueError):
    pass


def compose(*readers, **kwargs):
    check_alignment = kwargs.pop('check_alignment', True)

    def make_tuple(x):
        if isinstance(x, tuple):
            return x
        else:
            return (x, )

    def reader():
        rs = []
        for r in readers:
            rs.append(r())
        if not check_alignment:
            for outputs in zip(*rs):
                yield sum(list(map(make_tuple, outputs)), ())
        else:
            for outputs in zip(*rs):
                for o in outputs:
                    if o is None:
                        raise ComposeNotAligned(
                            "outputs of readers are not aligned.")
                yield sum(list(map(make_tuple, outputs)), ())

    return reader


def buffered(reader, size):
    """Background-thread prefetch buffer (parity: decorator.py::buffered)."""

    class EndSignal():
        pass

    end = EndSignal()

    def read_worker(r, q):
        for d in r:
            q.put(d)
        q.put(end)

    def data_reader():
        r = reader()
        q = Queue.Queue(maxsize=size)
        t = threading.Thread(target=read_worker, args=(r, q))
        t.daemon = True
        t.start()
        e = q.get()
        while e != end:
            yield e
            e = q.get()

    return data_reader


def firstn(reader, n):
    def firstn_reader():
        for i, item in enumerate(reader()):
            if i == n:
                break
            yield item

    return firstn_reader


class XmapEndSignal():
    pass


def xmap_readers(mapper, reader, process_num, buffer_size, order=False):
    """Parallel map over a reader with worker threads.
    Parity: decorator.py::xmap_readers."""
    end = XmapEndSignal()

    def read_worker(reader, in_queue):
        for i in reader():
            in_queue.put(i)
        in_queue.put(end)

    def order_read_worker(reader, in_queue):
        in_order = 0
        for i in reader():
            in_queue.put((in_order, i))
            in_order += 1
        in_queue.put(end)

    def handle_worker(in_queue, out_queue, mapper):
        sample = in_queue.get()
        while not isinstance(sample, XmapEndSignal):
            r = mapper(sample)
            out_queue.put(r)
            sample = in_queue.get()
        in_queue.put(end)
        out_queue.put(end)

    def order_handle_worker(in_queue, out_queue, mapper, out_order):
        ins = in_queue.get()
        while not isinstance(ins, XmapEndSignal):
            order, sample = ins
            r = mapper(sample)
            while order != out_order[0]:
                pass
            out_queue.put(r)
            out_order[0] += 1
            ins = in_queue.get()
        in_queue.put(end)
        out_queue.put(end)

    def xreader():
        in_queue = Queue.Queue(buffer_size)
        out_queue = Queue.Queue(buffer_size)
        out_order = [0]
        target = order_read_worker if order else read_worker
        t = threading.Thread(target=target, args=(reader, in_queue))
        t.daemon = True
        t.start()
        target = order_handle_worker if order else handle_worker
        args = (in_queue, out_queue, mapper, out_order) if order else (
            in_queue, out_queue, mapper)
        workers = []
        for i in range(process_num):
            worker = threading.Thread(target=target, args=args)
            worker.daemon = True
            workers.append(worker)
        for w in workers:
            w.start()

        finish = 0
        while finish < process_num:
            sample = out_queue.get()
            if isinstance(sample, XmapEndSignal):
                finish += 1
            else:
                yield sample

    return xreader
