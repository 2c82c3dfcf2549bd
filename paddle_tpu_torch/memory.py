"""Memory introspection and the pinned host arena.

Counterpart of paddle_tpu/memory.py (parity: paddle/fluid/memory/memory.h,
memory::Used and the buddy allocator's stats, and platform/gpu_info).
The device allocator is PyTorch's caching allocator: ``memory_stats``
reads ``torch.cuda.memory_stats`` and ``torch.cuda.mem_get_info`` under
the JAX package's keys. What the framework allocates itself is HOST
staging memory, :class:`HostArena` (the mlock'ed bump arena of
``native/arena.cc``).
"""
import ctypes
import weakref

import numpy as np

__all__ = ['memory_stats', 'memory_allocated', 'max_memory_allocated',
           'HostArena']


def _cuda_device(place=None):
    """The CUDA device of ``place`` (default: the current one), or None
    for a CPU place or a host without CUDA."""
    import torch
    if place is not None:
        dev = place if isinstance(place, torch.device) else \
            place.torch_device()
        return dev if dev.type == 'cuda' else None
    if not torch.cuda.is_available():
        return None
    return torch.device('cuda', torch.cuda.current_device())


def memory_stats(place=None):
    """Device memory statistics as a dict (bytes).

    On a CUDA device: ``bytes_in_use`` and ``peak_bytes_in_use`` (the
    caching allocator's allocated bytes, now and at their peak),
    ``bytes_reserved`` (what it holds from the device), ``num_allocs``
    (its allocations so far), ``bytes_limit`` (the card's memory),
    ``bytes_free`` (``cudaMemGetInfo``'s free bytes) and
    ``supported: True``. On the CPU: ``{'bytes_in_use': 0,
    'supported': False}``, as the JAX package says for a backend without
    allocator stats."""
    import torch
    dev = _cuda_device(place)
    if dev is None:
        return {'bytes_in_use': 0, 'supported': False}
    st = torch.cuda.memory_stats(dev)
    free, total = torch.cuda.mem_get_info(dev)
    return {'bytes_in_use': int(st.get('allocated_bytes.all.current', 0)),
            'peak_bytes_in_use': int(st.get('allocated_bytes.all.peak', 0)),
            'bytes_reserved': int(st.get('reserved_bytes.all.current', 0)),
            'num_allocs': int(st.get('allocation.all.allocated', 0)),
            'bytes_limit': int(total), 'bytes_free': int(free),
            'supported': True}


def memory_allocated(place=None):
    """Bytes currently allocated on the device (0 if unsupported)."""
    return int(memory_stats(place).get('bytes_in_use', 0))


def max_memory_allocated(place=None):
    """Peak bytes allocated on the device (0 if unsupported)."""
    return int(memory_stats(place).get('peak_bytes_in_use', 0))


class _ArenaArray(np.ndarray):
    """ndarray view over arena memory; keeps the owning arena alive so
    its pages cannot be unmapped while the view is outstanding."""
    _arena_ref = None


class HostArena(object):
    """Pinned host-memory bump arena (native/arena.cc).

    Allocation returns numpy arrays backed by mlock'ed pages; ``reset()``
    recycles every buffer at once (one reset per training step, between
    staging batches). Falls back to plain numpy when the native library
    is unavailable (``native`` is then False).
    """

    def __init__(self, chunk_bytes=8 << 20):
        from .native.loader import _load
        self._lib = _load()
        self._handle = None
        self._views = {}   # id(view) -> weakref (ndarray isn't hashable)
        if self._lib is not None:
            self._handle = self._lib.arena_create(chunk_bytes) or None

    @property
    def native(self):
        return self._handle is not None

    def alloc(self, shape, dtype='float32', align=64):
        """A numpy array over arena memory (invalidated by reset())."""
        dtype = np.dtype(dtype)
        size = int(np.prod(shape)) * dtype.itemsize
        if self._handle is None:
            return np.empty(shape, dtype)
        ptr = self._lib.arena_alloc(self._handle, size, align)
        if not ptr:
            return np.empty(shape, dtype)
        buf = (ctypes.c_uint8 * size).from_address(ptr)
        arr = np.frombuffer(buf, dtype=dtype).reshape(shape)
        arr = arr.view(_ArenaArray)
        arr._arena_ref = self   # views pin the arena's pages alive
        key = id(arr)
        self._views[key] = weakref.ref(
            arr, lambda _r, k=key, v=self._views: v.pop(k, None))
        return arr

    def reset(self):
        if self._handle is not None:
            self._lib.arena_reset(self._handle)

    def stats(self):
        """dict: allocated/peak/capacity bytes, chunks, pinned, native."""
        if self._handle is None:
            return {'allocated': 0, 'peak': 0, 'capacity': 0,
                    'chunks': 0, 'pinned': False, 'native': False}
        alloc = ctypes.c_uint64()
        peak = ctypes.c_uint64()
        cap = ctypes.c_uint64()
        pinned = ctypes.c_int()
        chunks = self._lib.arena_stats(
            self._handle, ctypes.byref(alloc), ctypes.byref(peak),
            ctypes.byref(cap), ctypes.byref(pinned))
        return {'allocated': alloc.value, 'peak': peak.value,
                'capacity': cap.value, 'chunks': chunks,
                'pinned': bool(pinned.value), 'native': True}

    def close(self):
        """Unmap the arena. Refuses while alloc()'d views are alive: an
        unmap under an outstanding view would be a segfault, not an
        exception."""
        if self._handle is None:
            return
        if len(self._views):
            raise RuntimeError(
                "HostArena.close(): %d allocated view(s) still alive; "
                "drop them (or let them be garbage-collected) first"
                % len(self._views))
        self._lib.arena_destroy(self._handle)
        self._handle = None

    def __del__(self):
        # GC runs this only when no view holds _arena_ref, so the
        # outstanding-views check cannot fire spuriously here
        try:
            self.close()
        except Exception:
            pass
