"""The cold-start store: what a memo miss prepares, kept on disk for the
next replica.

Counterpart of paddle_tpu/fleet/coldstart.py. The JAX module persists
serialised XLA executables; the port has no compiled artifact (its
kernels' libraries are already cached on disk by a hash of their
sources, ``ops/_build.py``). What a fresh replica redoes on each memo
miss is the verify, the prune and the pass pipeline, then the lowering's
planning. Behind the ``PTPU_AOT_CACHE`` gate the Executor keeps the
result of those steps, the prepared program (``io.program_to_json``),
one JSON file a memo key, the key holding the lowering's static plan
(the feeds, fetches and state in and out), and a miss that finds its
entry lowers it directly: a fresh replica's ``ModelServer.warmup``
loads instead of preparing again, with bit-identical outputs.

What it saves is small: on an NVIDIA H100 (``chip_smoke.py`` phase
24d, PERF.md) a MobileNet-SSD replica's miss spends 16 ms in the verify,
the prune and the passes of a 1.7 s warm-up, and a hit spends 14 ms
reading its entry, so the store shows no gain there. It stays a gate
with that measured zero gain; the hit path is not to grow until a
program shows one.

The key is the memo key's content: the program's fingerprint (not its
in-process version), the feed, fetch and state names, the device type,
the compiler's token (pass pipeline and tuning entry) and the static
feeds. Every entry carries an invalidation token (the schema, torch's
and CUDA's versions, the device's name, a hash of the kernel libraries'
sources, a hash of the port's own sources that prepare and read the
program (the passes, the program's classes and its JSON form) and the
pass pipeline's names): an entry from another toolchain, card or port
version is a miss, never a wrong program. A pipeline with a pass that
writes into the Scope (``bn_fold``) is never stored: its program is
only right beside the weights it folded, which a fresh replica lacks. Writes are atomic (a temporary
file and ``os.replace``), so replicas can share a directory; every
failure (a torn or foreign file, a token skew) is a counted miss, and
the run path never breaks because the store did.

Telemetry: ``coldstart_hits_total`` / ``coldstart_misses_total`` /
``coldstart_saves_total`` / ``coldstart_failures_total`` /
``coldstart_invalidated_total`` counters, ``coldstart_load_seconds`` /
``coldstart_save_seconds`` histograms, and a ``coldstart`` journal
event per hit, save and invalidation, under the JAX package's names.
"""
import contextlib
import hashlib
import json
import logging
import os
import tempfile
import threading
import time

from .. import observability as _obs

__all__ = ['AOT_CACHE_ENV', 'AotStore', 'cache_dir', 'cache_scope',
           'enabled', 'default_store', 'key_hash', 'token']

logger = logging.getLogger('paddle_tpu_torch.fleet')

AOT_CACHE_ENV = 'PTPU_AOT_CACHE'
_SCHEMA = 1
_SUFFIX = '.aotj'

_lock = threading.Lock()
_override_dir = None          # process override (cache_scope)
_stores = {}                  # realpath -> AotStore


def cache_dir():
    """The active store's directory, or None (gate closed). A
    :func:`cache_scope` override wins over ``PTPU_AOT_CACHE``."""
    if _override_dir is not None:
        return _override_dir
    return os.environ.get(AOT_CACHE_ENV) or None


def enabled():
    return cache_dir() is not None


@contextlib.contextmanager
def cache_scope(dirname):
    """The store under ``dirname`` for the duration, whatever the
    environment says."""
    global _override_dir
    with _lock:
        prev, _override_dir = _override_dir, str(dirname)
    try:
        yield
    finally:
        with _lock:
            _override_dir = prev


def default_store():
    """The store of the active directory (one object a directory), or
    None with the gate closed."""
    d = cache_dir()
    if d is None:
        return None
    key = os.path.realpath(d)
    with _lock:
        store = _stores.get(key)
        if store is None:
            store = _stores[key] = AotStore(d)
        return store


def key_hash(cache_key):
    """The file name of a memo key: sha256 of its ``repr``. Every part of
    the key is content (names, fingerprints, tokens, shapes), so the
    hash is the same in every process."""
    return hashlib.sha256(repr(cache_key).encode('utf-8')).hexdigest()


def _kernels_hash():
    """A hash of every kernel library's name, which holds the hash of
    its sources, headers and flags (``_build.library_path``)."""
    from ..ops import _build
    names = sorted(os.path.basename(_build.library_path(n))
                   for n in _build.KERNELS)
    return hashlib.sha1(' '.join(names).encode()).hexdigest()[:16]


# the port's modules whose code decides the prepared program or its
# JSON form, relative to the package
_PREPARING_SOURCES = ('compiler/__init__.py', 'compiler/pass_base.py',
                      'compiler/passes.py', 'framework.py', 'io.py')
_sources_digest = []


def _sources_hash():
    """A hash of the port's sources in _PREPARING_SOURCES: a changed pass
    or a changed program_to_json makes every stored entry a miss."""
    if not _sources_digest:
        root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        h = hashlib.sha1()
        for rel in _PREPARING_SOURCES:
            with open(os.path.join(root, rel), 'rb') as f:
                h.update(rel.encode() + b'\0' + f.read())
        _sources_digest.append(h.hexdigest()[:16])
    return _sources_digest[0]


def token(device='cpu'):
    """The invalidation token of an entry prepared for ``device``."""
    import torch
    from .. import compiler
    from ..observability import perf
    dev = torch.device(device)
    return {'schema': _SCHEMA, 'torch': torch.__version__,
            'cuda': str(torch.version.cuda), 'device': dev.type,
            'device_kind': perf.device_kind(dev), 'kernels': _kernels_hash(),
            'sources': _sources_hash(),
            'passes': [str(p) for p in compiler.pipeline_signature()]}


class AotStore(object):
    """Atomic on-disk store of prepared programs: one file a memo key,
    ``<dir>/<sha256(key)>.aotj``, a JSON record ``{'token', 'entry'}``
    whose entry holds the prepared program and the lowering's plan. The
    directory is the operator's, as the tuning cache's is."""

    def __init__(self, dirname):
        self.dirname = str(dirname)
        reg = _obs.default_registry()
        self.m_hits = reg.counter(
            'coldstart_hits_total',
            'memo misses warmed from the cold-start store')
        self.m_misses = reg.counter(
            'coldstart_misses_total',
            'memo misses with no usable cold-start entry')
        self.m_saves = reg.counter(
            'coldstart_saves_total',
            'prepared programs persisted to the cold-start store')
        self.m_failures = reg.counter(
            'coldstart_failures_total',
            'cold-start store operations that failed and degraded to '
            'preparing the program')
        self.m_invalid = reg.counter(
            'coldstart_invalidated_total',
            'cold-start entries rejected by the invalidation token '
            '(toolchain or card skew)')
        self.m_load = reg.histogram(
            'coldstart_load_seconds',
            'wall seconds to read a cold-start entry')
        self.m_save = reg.histogram(
            'coldstart_save_seconds',
            'wall seconds to write a cold-start entry')

    def path(self, cache_key):
        return os.path.join(self.dirname, key_hash(cache_key) + _SUFFIX)

    def load(self, cache_key, device='cpu'):
        """The entry of this memo key, or None (a miss). Never raises: a
        torn file, a foreign record or a token skew is a counted miss."""
        path = self.path(cache_key)
        t0 = time.perf_counter()
        try:
            with open(path) as f:
                rec = json.load(f)
            have, entry = rec['token'], rec['entry']
        except FileNotFoundError:
            self.m_misses.inc()
            return None
        except (OSError, ValueError, KeyError, TypeError) as e:
            self.m_failures.inc()
            self.m_misses.inc()
            logger.warning('coldstart: unreadable entry %s: %r', path, e)
            return None
        want = token(device)
        if have != want:
            self.m_invalid.inc()
            self.m_misses.inc()
            _obs.emit('coldstart', action='invalid',
                      key=key_hash(cache_key)[:12], have=have, want=want)
            return None
        dur = time.perf_counter() - t0
        self.m_hits.inc()
        self.m_load.observe(dur)
        _obs.emit('coldstart', action='hit', key=key_hash(cache_key)[:12],
                  bytes=os.path.getsize(path), dur_s=round(dur, 6))
        return entry

    def save(self, cache_key, entry, device='cpu'):
        """Persist ``entry`` (JSON) atomically. Returns True on success; a
        failure is counted and the entry stays in the process."""
        t0 = time.perf_counter()
        try:
            blob = json.dumps({'token': token(device), 'entry': entry})
            os.makedirs(self.dirname, exist_ok=True)
            fd, tmp = tempfile.mkstemp(dir=self.dirname,
                                       suffix=_SUFFIX + '.tmp')
            try:
                with os.fdopen(fd, 'w') as f:
                    f.write(blob)
                os.replace(tmp, self.path(cache_key))
            except BaseException:
                try:
                    os.unlink(tmp)
                except OSError:
                    pass
                raise
        except (OSError, TypeError, ValueError) as e:
            self.m_failures.inc()
            logger.warning('coldstart: save failed: %r', e)
            return False
        dur = time.perf_counter() - t0
        self.m_saves.inc()
        self.m_save.observe(dur)
        _obs.emit('coldstart', action='save', key=key_hash(cache_key)[:12],
                  bytes=len(blob), dur_s=round(dur, 6))
        return True

    def entries(self):
        """The hash names of the entries on disk."""
        try:
            names = os.listdir(self.dirname)
        except OSError:
            return []
        return sorted(n[:-len(_SUFFIX)] for n in names
                      if n.endswith(_SUFFIX))
