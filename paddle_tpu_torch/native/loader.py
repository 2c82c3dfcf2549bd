"""ctypes binding of the native recordio reader/writer and prefetch
loader (recordio.cc) and of the host arena (arena.cc).

Counterpart of paddle_tpu/native/loader.py. The library is built with
``g++`` at first use (never at import) into ``build/native/`` at the
root of the checkout (listed in ``.gitignore``), named by a hash of its
sources and flags, so an edited source is rebuilt and a stale library is
never loaded. Where no toolchain is found, or the build fails, every
entry point degrades to the pure-Python reader of ``reader_io`` as in
the JAX package, with a warning; ``build_error()`` then says why, and
the counts below say which path each read took, so a caller that needs
the native path (the card smoke) can require it.
"""
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import warnings

_HERE = os.path.dirname(os.path.abspath(__file__))
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(_HERE)), 'build',
                         'native')
SOURCES = ('recordio.cc', 'arena.cc')
CXX_FLAGS = ['-O2', '-fPIC', '-std=c++17', '-Wall', '-shared']
LD_FLAGS = ['-lpthread']

_LIB = None
_BUILD_LOCK = threading.Lock()
_BUILD_TRIED = False
_BUILD_ERROR = [None]

# files read through the native library / through the Python fallback
READS = {'native': 0, 'python': 0}


def library_path():
    digest = hashlib.sha1()
    for fname in SOURCES:
        with open(os.path.join(_HERE, fname), 'rb') as f:
            digest.update(f.read())
    digest.update(' '.join(CXX_FLAGS + LD_FLAGS).encode())
    return os.path.join(BUILD_DIR, 'librecordio-%s.so'
                        % digest.hexdigest()[:12])


def _build(out):
    cxx = os.environ.get('CXX') or shutil.which('g++') or shutil.which('c++')
    if cxx is None:
        raise RuntimeError('no C++ compiler (g++) on PATH')
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = '%s.%d.tmp' % (out, os.getpid())
    proc = subprocess.run(
        [cxx] + CXX_FLAGS + ['-o', tmp] +
        [os.path.join(_HERE, s) for s in SOURCES] + LD_FLAGS,
        capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError('g++ failed: %s' % proc.stderr[-2000:])
    os.replace(tmp, out)


def _bind(lib):
    P, U64 = ctypes.c_void_p, ctypes.c_uint64
    lib.rio_open.restype = P
    lib.rio_open.argtypes = [ctypes.c_char_p]
    lib.rio_next.restype = ctypes.POINTER(ctypes.c_uint8)
    lib.rio_next.argtypes = [P, ctypes.POINTER(U64)]
    lib.rio_error.restype = ctypes.c_char_p
    lib.rio_error.argtypes = [P]
    lib.rio_close.argtypes = [P]
    lib.rio_writer_open.restype = P
    lib.rio_writer_open.argtypes = [ctypes.c_char_p]
    lib.rio_write.restype = ctypes.c_int
    lib.rio_write.argtypes = [P, ctypes.POINTER(ctypes.c_uint8), U64]
    lib.rio_writer_close.restype = U64
    lib.rio_writer_close.argtypes = [P]
    lib.loader_create.restype = P
    lib.loader_create.argtypes = [ctypes.POINTER(ctypes.c_char_p),
                                  ctypes.c_int, ctypes.c_int, ctypes.c_int,
                                  ctypes.c_int]
    lib.loader_next.restype = ctypes.POINTER(ctypes.c_uint8)
    lib.loader_next.argtypes = [P, ctypes.POINTER(U64)]
    lib.loader_error.restype = ctypes.c_int
    lib.loader_error.argtypes = [P, ctypes.c_char_p, ctypes.c_int]
    lib.loader_destroy.argtypes = [P]
    lib.arena_create.restype = P
    lib.arena_create.argtypes = [U64]
    lib.arena_alloc.restype = P
    lib.arena_alloc.argtypes = [P, U64, U64]
    lib.arena_reset.argtypes = [P]
    lib.arena_stats.restype = ctypes.c_int
    lib.arena_stats.argtypes = [P] + [ctypes.POINTER(U64)] * 3 + [
        ctypes.POINTER(ctypes.c_int)]
    lib.arena_destroy.argtypes = [P]
    return lib


def _load():
    """The bound library, built first if need be; None when it cannot be
    built or loaded (``build_error()`` says why)."""
    global _LIB, _BUILD_TRIED
    if _LIB is not None:
        return _LIB
    with _BUILD_LOCK:
        if _LIB is not None or _BUILD_TRIED:
            return _LIB
        _BUILD_TRIED = True
        try:
            out = library_path()
            if not os.path.exists(out):
                _build(out)
            _LIB = _bind(ctypes.CDLL(out))
        except Exception as e:
            _BUILD_ERROR[0] = '%s: %s' % (type(e).__name__, e)
            warnings.warn('the native recordio library is unavailable (%s): '
                          'records are read through Python, and HostArena '
                          'is plain numpy' % _BUILD_ERROR[0])
            return None
    return _LIB


def available():
    return _load() is not None


def build_error():
    """Why the library is unavailable (None when it loaded or was not
    tried yet)."""
    return _BUILD_ERROR[0]


def read_records(path):
    """Generator over raw record payload bytes (native crc32 checked)."""
    lib = _load()
    if lib is None:
        raise RuntimeError('native loader not built: %s' % build_error())
    h = lib.rio_open(path.encode())
    if not h:
        raise IOError('%s is not a paddle_tpu recordio file' % path)
    READS['native'] += 1
    try:
        n = ctypes.c_uint64()
        while True:
            ptr = lib.rio_next(h, ctypes.byref(n))
            if not ptr:
                err = lib.rio_error(h).decode()
                if err:
                    raise IOError('recordio %s in %s' % (err, path))
                return
            yield ctypes.string_at(ptr, n.value)
    finally:
        lib.rio_close(h)


def write_records(path, payloads):
    """Write payload byte strings; returns the record count."""
    lib = _load()
    if lib is None:
        raise RuntimeError('native loader not built: %s' % build_error())
    h = lib.rio_writer_open(path.encode())
    if not h:
        raise IOError('cannot open %s for writing' % path)
    for p in payloads:
        buf = (ctypes.c_uint8 * len(p)).from_buffer_copy(p)
        if lib.rio_write(h, buf, len(p)) != 0:
            lib.rio_writer_close(h)
            raise IOError('short write to %s' % path)
    return int(lib.rio_writer_close(h))


class PrefetchLoader(object):
    """Background-thread record prefetcher over one or more files.

    Parity: the reference's double_buffer reader + recordio scanner:
    disk IO and checksum overlap with device compute. Iterate to get
    payload bytes.
    """

    def __init__(self, filenames, n_threads=2, capacity=64, passes=1):
        if isinstance(filenames, str):
            filenames = [filenames]
        self._filenames = filenames
        self._n_threads = n_threads
        self._capacity = capacity
        self._passes = passes

    def __iter__(self):
        lib = _load()
        if lib is None:
            # degraded mode: plain sequential Python reads
            from ..reader_io import read_records as py_read
            for _ in range(self._passes):
                for fn in self._filenames:
                    READS['python'] += 1
                    for payload in py_read(fn):
                        yield payload
            return
        arr = (ctypes.c_char_p * len(self._filenames))(
            *[f.encode() for f in self._filenames])
        h = lib.loader_create(arr, len(self._filenames), self._n_threads,
                              self._capacity, self._passes)
        READS['native'] += len(self._filenames) * self._passes
        try:
            n = ctypes.c_uint64()
            while True:
                ptr = lib.loader_next(h, ctypes.byref(n))
                if not ptr:
                    break
                yield ctypes.string_at(ptr, n.value)
            msg = ctypes.create_string_buffer(512)
            if lib.loader_error(h, msg, len(msg)) > 0:
                raise IOError('prefetch loader: %s'
                              % msg.value.decode(errors='replace'))
        finally:
            lib.loader_destroy(h)
