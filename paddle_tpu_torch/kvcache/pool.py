"""Paged KV-cache storage: a fixed pool of pages + per-sequence block
tables.

Counterpart of paddle_tpu/kvcache/pool.py. The slotted
:class:`~paddle_tpu_torch.fleet.decode.DecodeEngine` gives every slot a
dense ``[max_len, ...]`` KV region: device memory is committed for the
WORST CASE length of every resident sequence, so short sequences
strand memory and the number of sequences resident is welded to the
slot count. The :class:`PagePool` breaks that weld:

- KV state lives in ONE pool tensor per spec, shaped
  ``[num_pages, page_size, ...]``, a fixed operand of the step program
  (its shape never changes as sequences come and go, so the Executor's
  memo hits every step);
- a sequence owns an ordered list of page ids (its
  :class:`BlockTable`); admission is "allocate
  ``ceil(len / page_size)`` pages from the free list", retirement
  returns them — so resident KV bytes track ACTUAL lengths, not
  ``slots * max_len``;
- exhaustion is a typed :class:`PoolExhausted` the admission path
  turns into backpressure (the request waits for pages, it is never
  dropped untyped).

The pool is host-side numpy, as in the JAX package: the step program
feeds the pool tensors to the card and fetches them back every step,
like any other decode state. Pages are zeroed on ``alloc`` so the paged
attention cell's additive writes see the same all-zeros initial state a
freshly admitted dense slot does; that is what makes paged decode
bit-identical to the slotted cell at the same slot count
(``tests/test_torch_kvcache.py``).

Telemetry, with the JAX package's names: ``kvcache_pool_used_pages`` /
``kvcache_pool_free_pages`` gauges and ``kvcache`` journal events for
every alloc/free/backpressure transition.
"""
import threading

import numpy as np

from .. import observability as _obs
from ..serving.errors import ServingError

__all__ = ['PagePool', 'BlockTable', 'PoolExhausted']


class PoolExhausted(ServingError):
    """The free list cannot satisfy an allocation. ``needed`` /
    ``free`` / ``num_pages`` let the admission path distinguish
    transient pressure (backpressure: wait for retirements) from a
    request that can NEVER fit (``needed > num_pages``: reject)."""

    def __init__(self, message, needed=None, free=None, num_pages=None):
        super(PoolExhausted, self).__init__(message)
        self.needed = needed
        self.free = free
        self.num_pages = num_pages


class BlockTable(object):
    """One sequence's ordered page list: logical position ``p`` lives
    in pool page ``pages[p // page_size]`` at offset
    ``p % page_size``."""

    __slots__ = ('pages', 'page_size')

    def __init__(self, pages, page_size):
        self.pages = list(pages)
        self.page_size = int(page_size)

    def __len__(self):
        return len(self.pages)

    def capacity(self):
        return len(self.pages) * self.page_size

    def page_for(self, pos):
        return self.pages[pos // self.page_size]

    def offset(self, pos):
        return pos % self.page_size

    def row(self, max_pages, pad=0):
        """The int64 feed row for the step program's gather: page ids
        padded to the program's ``max_pages`` extent. Padding entries
        are gathered too, but the position mask zeroes their attention
        weight exactly (-1e9 before the softmax underflows to 0.0 in
        f32), so any valid page id works as padding."""
        if len(self.pages) > max_pages:
            raise ValueError('block table holds %d pages, program '
                             'built for %d' % (len(self.pages),
                                                  max_pages))
        out = np.full((max_pages,), pad, dtype=np.int64)
        out[:len(self.pages)] = self.pages
        return out


class PagePool(object):
    """Fixed pool of KV pages behind a free-list allocator.

    Parameters
    ----------
    specs : sequence of (name, feature_shape[, dtype]) tuples
        One pool tensor per spec, shaped
        ``[num_pages, page_size] + feature_shape`` — e.g.
        ``[('kv', [word_dim])]`` for an attention cell whose per-token
        KV entry is a ``word_dim`` vector.
    num_pages : int
        Pool extent, the program's page axis. Total KV capacity is
        ``num_pages * page_size`` token positions.
    page_size : int
        Token positions per page (the allocation granule).
    """

    def __init__(self, specs, num_pages, page_size):
        if num_pages < 1 or page_size < 1:
            raise ValueError('num_pages and page_size must be >= 1')
        self.num_pages = int(num_pages)
        self.page_size = int(page_size)
        self.specs = []
        for spec in specs:
            name, shape = spec[0], tuple(int(d) for d in spec[1])
            dtype = spec[2] if len(spec) > 2 else 'float32'
            self.specs.append((name, shape, dtype))
        if not self.specs:
            raise ValueError('a PagePool needs at least one spec')
        self.data = {
            name: np.zeros((self.num_pages, self.page_size) + shape,
                           dtype=dtype)
            for name, shape, dtype in self.specs}
        self._lock = threading.Lock()
        self._free = list(range(self.num_pages))   # FIFO: pop(0)
        self._allocs = 0
        self._frees = 0
        self._peak_used = 0
        reg = _obs.default_registry()
        self._g_used = reg.gauge(
            'kvcache_pool_used_pages',
            'KV pages currently allocated to resident sequences')
        self._g_free = reg.gauge(
            'kvcache_pool_free_pages',
            'KV pages on the pool free list')
        self._publish_locked()

    # ---- geometry --------------------------------------------------------
    @property
    def page_bytes(self):
        """Bytes one page occupies across every spec tensor."""
        return sum(self.data[name][0].nbytes
                   for name, _, _ in self.specs)

    @property
    def nbytes(self):
        """Total pool bytes: what a placement declares as ``kv_bytes``,
        which :class:`~paddle_tpu_torch.fleet.router.PlacementBudget`
        folds into the replica's ``hbm_bytes`` axis."""
        return sum(arr.nbytes for arr in self.data.values())

    def pages_for(self, length):
        """Pages a sequence of ``length`` token positions needs."""
        return -(-int(length) // self.page_size)

    # ---- allocator -------------------------------------------------------
    def alloc(self, n, zero=True):
        """Take ``n`` pages off the free list (FIFO — the oldest freed
        page is reused first, pinned by tests) and zero them; raises
        typed :class:`PoolExhausted` without taking any on shortfall
        (all-or-nothing, so backpressure never strands a partial
        grab)."""
        n = int(n)
        if n < 1:
            raise ValueError('alloc needs n >= 1')
        with self._lock:
            if n > len(self._free):
                free = len(self._free)
                raise PoolExhausted(
                    'pool exhausted: need %d page(s), %d free of %d'
                    % (n, free, self.num_pages), needed=n, free=free,
                    num_pages=self.num_pages)
            pages, self._free = self._free[:n], self._free[n:]
            self._allocs += 1
            used = self.num_pages - len(self._free)
            self._peak_used = max(self._peak_used, used)
            self._publish_locked()
        if zero:
            for name, _, _ in self.specs:
                self.data[name][pages] = 0
        _obs.emit('kvcache', action='alloc', pages=len(pages),
                  used=used, free=self.num_pages - used)
        return pages

    def free(self, pages):
        """Return pages to the free list (their contents are garbage
        until the next ``alloc`` zeroes them)."""
        pages = list(pages)
        if not pages:
            return
        with self._lock:
            live = set(self._free)
            for p in pages:
                if not 0 <= p < self.num_pages:
                    raise ValueError('page id %r outside pool [0, %d)'
                                     % (p, self.num_pages))
                if p in live:
                    raise ValueError('double free of page %d' % p)
            self._free.extend(pages)
            self._frees += 1
            used = self.num_pages - len(self._free)
            self._publish_locked()
        _obs.emit('kvcache', action='free', pages=len(pages),
                  used=used, free=self.num_pages - used)

    def reset(self):
        """Reclaim every page (the prefill engine recycles its private
        pool between prompts)."""
        with self._lock:
            self._free = list(range(self.num_pages))
            self._publish_locked()

    # ---- introspection ---------------------------------------------------
    def _publish_locked(self):
        used = self.num_pages - len(self._free)
        self._g_used.set(used)
        self._g_free.set(len(self._free))

    @property
    def free_pages(self):
        with self._lock:
            return len(self._free)

    @property
    def used_pages(self):
        with self._lock:
            return self.num_pages - len(self._free)

    def stats(self):
        with self._lock:
            used = self.num_pages - len(self._free)
            return {'num_pages': self.num_pages,
                    'page_size': self.page_size,
                    'used_pages': used,
                    'free_pages': len(self._free),
                    'peak_used_pages': self._peak_used,
                    'allocs': self._allocs,
                    'frees': self._frees,
                    'nbytes': self.nbytes}
