"""Per-shape autotuning with an on-disk cache.

Counterpart of paddle_tpu/compiler/tuning.py. Three choices of the
Hopper kernels follow a rule fitted once: the flash backward's route,
the fused conv's tiling and the LSTM cell's batch rows a block. The
:class:`Autotuner` times candidate settings of those knobs through the
real Executor path and persists the winner in a :class:`TuningCache`
keyed by ``(program fingerprint, shape signature, backend)``:

- the ``Executor`` looks the entry up when it lowers a program (a memo
  miss) and runs the lowered function under the entry's knobs
  (:func:`apply_entry`); the entry's token joins the memo key, so a new
  tuning result can never serve a program lowered under another entry;
- ``ModelServer.warmup()`` preloads the cache from disk before it warms
  the buckets, so a fresh serving process starts with the tuned
  settings instead of searching again.

The knobs are the port's own (the JAX package's name Pallas tiles and
TPU layouts) and their defaults live here, not in the kernels
(:data:`KNOB_DEFAULTS`); the kernel wrappers read the live values at
every launch (:func:`knobs`). JAX bakes its knobs into a program when
it traces it; the port runs eagerly, while the serving runtime's worker
threads run different models at once, so the live values are kept per
thread: one model's entry never steers another model's kernels. A
decision that a kernel's backward needs is taken in its forward, where
the entry is live: autograd runs a CUDA backward on a thread of its own.

Cache file: ``$PADDLE_TPU_TORCH_TUNING_CACHE`` or
``~/.cache/paddle_tpu_torch/tuning_cache.json`` (atomic tmp->rename
writes). Tests and ``chip_smoke.py`` point the default cache at a
temporary path (:func:`set_default_cache`).
"""
import contextlib
import functools
import hashlib
import json
import os
import threading
import time

import numpy as np
import torch

from .. import observability as _obs
from ..lod import SequenceTensor

__all__ = ['TuningCache', 'Autotuner', 'default_cache',
           'set_default_cache', 'shape_signature', 'entry_token',
           'backend', 'apply_entry', 'wrap_lowered', 'knobs',
           'KNOB_DEFAULTS', 'KNOB_CHOICES']

SCHEMA = 1

# The knobs an entry may carry, each with its default (the rule the
# kernels follow untuned) and the values it takes:
# - flash_bwd_route: the flash backward's kernels. 'merged' is the
#   one-pass kernel while what it allocates for dq stays under the
#   wrapper's cap (512 MiB, a hard limit: past it the two-pass kernels
#   run whatever the knob says), 'two_pass' the dq pass and the dk/dv
#   pass;
# - conv_max_bn, conv_max_splits: the widest output tile and the most K
#   splits that the fused conv's plan (cuda_kernels.fused_conv_plan) may
#   choose; its rule is otherwise unchanged, so one entry steers every
#   region of a program;
# - lstm_batch_tile: the LSTM cell's batch rows a block; 0 keeps the C
#   launcher's rule (csrc/lstm_cell.cu batch_tile).
KNOB_DEFAULTS = {'flash_bwd_route': 'merged', 'conv_max_bn': 256,
                 'conv_max_splits': 4, 'lstm_batch_tile': 0}
KNOB_CHOICES = {'flash_bwd_route': ('merged', 'two_pass'),
                'conv_max_bn': (256, 128, 64),
                'conv_max_splits': (4, 2, 1),
                'lstm_batch_tile': (0, 8, 16, 32, 64)}

# this thread's live knobs ('knobs'), and whether a measurement pinned
# them ('pinned': a lowered program's own entry then leaves them be)
_local = threading.local()


def knobs():
    """The live knobs on this thread: :data:`KNOB_DEFAULTS`, or the
    defaults overlaid with the entry :func:`apply_entry` installed."""
    return getattr(_local, 'knobs', KNOB_DEFAULTS)


def _check_entry(entry):
    for k, v in entry.items():
        if k not in KNOB_CHOICES:
            raise ValueError('tuning entry has an unknown knob %r; known: '
                             '%s' % (k, sorted(KNOB_CHOICES)))
        if v not in KNOB_CHOICES[k]:
            raise ValueError('tuning knob %s=%r is not one of %s'
                             % (k, v, list(KNOB_CHOICES[k])))


@contextlib.contextmanager
def _installed(entry, pin):
    _check_entry(entry)
    prev = getattr(_local, 'knobs', None)
    prev_pin = getattr(_local, 'pinned', False)
    live = dict(KNOB_DEFAULTS)
    live.update(entry)
    _local.knobs, _local.pinned = live, pin
    try:
        yield
    finally:
        _local.pinned = prev_pin
        if prev is None:
            del _local.knobs
        else:
            _local.knobs = prev


@contextlib.contextmanager
def apply_entry(entry):
    """Install a tuning entry's knobs on this thread for the block: the
    defaults overlaid with the entry. An empty entry, or a block inside
    the tuner's measurement of a candidate, leaves the live knobs as
    they are. An unknown knob or value raises ValueError."""
    if not entry or getattr(_local, 'pinned', False):
        yield
        return
    with _installed(entry, False):
        yield


def wrap_lowered(fn, entry):
    """Wrap a lowered program's function so every call runs under the
    entry's knobs (the Executor stores this in its memo)."""
    if not entry:
        return fn
    _check_entry(entry)

    def wrapped(*args, **kwargs):
        with apply_entry(entry):
            return fn(*args, **kwargs)

    return wrapped


@functools.lru_cache(maxsize=None)
def _device_name(index):
    return torch.cuda.get_device_name(index)


def backend(device):
    """The backend token of cache keys for the device the Executor runs
    on: ``'cuda:<device name, lower-case, dashed>'`` (winners are per
    device kind, not per family: an H100's plan is not another card's)
    or ``'cpu'``."""
    device = torch.device(device)
    if device.type != 'cuda':
        return 'cpu'
    index = device.index if device.index is not None \
        else torch.cuda.current_device()
    return 'cuda:' + _device_name(index).strip().lower().replace(' ', '-')


def shape_signature(feed_sig):
    """Stable short token for a prepared-feed spec tuple (the sorted
    ``(name, spec)`` pairs of ``executor.feed_signature``)."""
    return hashlib.sha1(repr(feed_sig).encode()).hexdigest()[:16]


def entry_token(entry):
    if not entry:
        return '-'
    return hashlib.sha1(json.dumps(entry, sort_keys=True,
                                   default=str).encode()).hexdigest()[:12]


def _default_path():
    return os.environ.get('PADDLE_TPU_TORCH_TUNING_CACHE') or os.path.join(
        os.path.expanduser('~'), '.cache', 'paddle_tpu_torch',
        'tuning_cache.json')


class TuningCache(object):
    """Thread-safe (program fp, shape sig, backend) -> entry store with
    on-disk persistence and hit/miss telemetry
    (``tuning_cache_{hits,misses}_total``)."""

    def __init__(self, path=None):
        self.path = path or _default_path()
        self._entries = {}
        self._lock = threading.RLock()
        self._loaded = False
        reg = _obs.default_registry()
        self._m_hits = reg.counter(
            'tuning_cache_hits_total',
            'compile-time tuning-cache lookups that found an entry')
        self._m_misses = reg.counter(
            'tuning_cache_misses_total',
            'compile-time tuning-cache lookups that found nothing')

    @staticmethod
    def key(program_fp, shape_sig, back):
        return '%s|%s|%s' % (program_fp, shape_sig, back)

    # ---- persistence -----------------------------------------------------
    def preload(self):
        """Load the on-disk cache (idempotent; merges over in-memory
        entries without clobbering newer puts). A torn file, or one of
        another schema, is ignored. Returns the number of entries now
        resident. Serving warmup calls this so the warm-up's lowerings
        run under the tuned knobs."""
        with self._lock:
            n_before = len(self._entries)
            try:
                with open(self.path) as f:
                    data = json.load(f)
                if isinstance(data, dict) and data.get('schema') == SCHEMA:
                    for k, v in data.get('entries', {}).items():
                        self._entries.setdefault(k, v)
            except (OSError, ValueError):
                pass
            self._loaded = True
            n = len(self._entries)
        _obs.emit('tuning_preload', path=self.path, entries=n,
                  loaded=n - n_before)
        return n

    def save(self):
        with self._lock:
            payload = {'schema': SCHEMA, 'entries': dict(self._entries)}
        d = os.path.dirname(os.path.abspath(self.path))
        os.makedirs(d, exist_ok=True)
        tmp = self.path + '.tmp.%d' % os.getpid()
        with open(tmp, 'w') as f:
            json.dump(payload, f, indent=1, sort_keys=True)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, self.path)

    # ---- lookup / store --------------------------------------------------
    def _ensure_loaded(self):
        if not self._loaded:
            self.preload()

    def lookup(self, program_fp, shape_sig, back, count=True):
        """The tuned entry dict, or None. ``count=False`` is the quiet
        form (metrics count lowerings, not every run)."""
        self._ensure_loaded()
        with self._lock:
            hit = self._entries.get(self.key(program_fp, shape_sig,
                                             back))
        if count:
            (self._m_hits if hit else self._m_misses).inc()
            _obs.emit('tuning_lookup', fp=program_fp, hit=bool(hit))
        return dict(hit['entry']) if hit else None

    def token(self, program_fp, shape_sig, back):
        """Short stable token of the entry (or '-') for memo keys: a
        tuning-cache update changes the token, so exactly the affected
        (program, shape) is lowered again."""
        self._ensure_loaded()
        with self._lock:
            hit = self._entries.get(self.key(program_fp, shape_sig,
                                             back))
        return entry_token(hit['entry']) if hit else '-'

    def put(self, program_fp, shape_sig, back, entry, measured_ms=None,
            persist=True):
        rec = {'entry': dict(entry), 'measured_ms': measured_ms,
               'backend': back, 'stored_at': time.time()}
        with self._lock:
            self._entries[self.key(program_fp, shape_sig, back)] = rec
        if persist:
            try:
                self.save()
            except OSError:
                pass
        _obs.emit('tuning_put', fp=program_fp, backend=back,
                  entry=dict(entry), measured_ms=measured_ms)

    def clear(self):
        with self._lock:
            self._entries.clear()
            self._loaded = True

    def __len__(self):
        with self._lock:
            return len(self._entries)


_DEFAULT = [None]


def default_cache():
    if _DEFAULT[0] is None:
        _DEFAULT[0] = TuningCache()
    return _DEFAULT[0]


def set_default_cache(cache):
    """Install (or with None, reset) the process default — tests and
    smoke runs point it at a temporary path."""
    prev = _DEFAULT[0]
    _DEFAULT[0] = cache
    return prev


def _block_ops(program):
    return [op for b in program.blocks for op in b.ops]


# The conv schedule space of the measured search, each point the plan's
# widest tile and most K splits (the default, 256 and 4, is the baseline
# {}). The ledger would prune it (compute-bound programs skip it,
# bandwidth-bound ones get all of it); without a ledger the search takes
# the first two points, the JAX package's "modest" cut.
_CONV_SCHEDULE_SPACE = (
    {'conv_max_bn': 128, 'conv_max_splits': 4},
    {'conv_max_bn': 256, 'conv_max_splits': 1},
    {'conv_max_bn': 64, 'conv_max_splits': 4},
    {'conv_max_bn': 128, 'conv_max_splits': 1},
    {'conv_max_bn': 256, 'conv_max_splits': 2},
    {'conv_max_bn': 64, 'conv_max_splits': 1},
)
_CONV_OPS = {'conv2d', 'depthwise_conv2d', 'fused_conv'}
_LSTM_TILES = (8, 16, 32, 64)


def _feed_batch(program, feed):
    """The batch of the feeds whose variables declare a -1 leading dim,
    or None."""
    block = program.global_block()
    for name, value in feed.items():
        var = block._find_var_recursive(name)
        if var is not None and var.shape and var.shape[0] == -1:
            if isinstance(value, SequenceTensor):
                value = value.data
            return int(np.shape(value)[0])
    return None


class Autotuner(object):
    """Measured-cost search (time the candidates, keep the winner) over
    the port's knobs: the flash backward's route for programs with a
    flash backward, the fused conv's widest tile and K splits for
    programs with convs, the LSTM cell's batch rows a block for programs
    whose LSTMs take the fused cell. Each candidate is timed through a
    private Executor; a candidate that raises (an invalid launch, out of
    memory, an injected fault) is poisoned in the report and the sweep
    goes on: it can never win or land in the cache, and it never runs on
    the plain version. The winner lands in the :class:`TuningCache` for
    every later lowering of the same (program, shape, device kind)."""

    def __init__(self, place=None, cache=None, warmup=1, steps=3,
                 max_candidates=12):
        self.place = place
        # `cache or ...` would drop an EMPTY injected cache: TuningCache
        # defines __len__, so a fresh one is falsy.
        self.cache = cache if cache is not None else default_cache()
        self.warmup = warmup
        self.steps = steps
        self.max_candidates = max_candidates
        self.last_pruned = 0
        reg = _obs.default_registry()
        self._m_candidates = reg.counter(
            'autotune_candidates_total',
            'schedule-search candidates measured (incl. poisoned)')

    @staticmethod
    def _ledger_bound(program):
        """The program's roofline leg from the performance observatory's
        ledger ('compute' or 'bandwidth'), or None where it was never
        ledgered."""
        from ..observability import perf as _perf
        led = _perf.book().get(program.fingerprint())
        return led.roofline_bound if led is not None else None

    def _device(self):
        from ..core import places as _places
        place = self.place if self.place is not None \
            else _places.CUDAPlace(0)
        return place.torch_device()

    def _merged_fits(self, program, feed):
        """Whether the merged flash backward stays under its cap at every
        flash attention of the program at this feed's batch: what it
        would allocate for dq (cuda_kernels.merged_bwd_bytes, from meta
        tensors of the op's [B, T, H, D/H] in the dtype AMP gives it)."""
        from ..core.amp import amp_enabled
        from ..ops import cuda_kernels as ck
        batch = _feed_batch(program, feed)
        dtype = torch.bfloat16 if amp_enabled(self._device()) \
            else torch.float32
        for op in _block_ops(program):
            if op.type != 'flash_attention':
                continue
            shape = list(op.block._find_var_recursive(op.input('Q')[0])
                         .shape)
            if shape[0] == -1:
                shape[0] = batch if batch is not None else 1
            heads = int(op.attr('num_heads', 1))
            q = torch.empty(shape[0], shape[1], heads, shape[2] // heads,
                            dtype=dtype, device='meta')
            # a head dim without a kernel (CPU-sized programs) counts
            # its f32 dq unpadded
            nbytes = ck.merged_bwd_bytes(q) if q.shape[-1] in \
                ck.FLASH_HEAD_DIMS else 4 * q.numel()
            if nbytes > ck._MERGED_BWD_MAX_SLAB_BYTES:
                return False
        return True

    def candidates(self, program, feed):
        """Ordered candidate entries for the program at this feed (the
        feed sizes the flash backward's cap check). Also sets
        ``self.last_pruned`` (schedule points dropped by the ledger cut
        or the cap) for the search-end journal event."""
        ops = _block_ops(program)
        types = {op.type for op in ops}
        cands = [{}]
        pruned = 0
        if 'flash_attention' in types and 'backward_marker' in types:
            if self._merged_fits(program, feed):
                cands.append({'flash_bwd_route': 'merged'})
            else:
                pruned += 1
            cands.append({'flash_bwd_route': 'two_pass'})
        if types & _CONV_OPS:
            bound = self._ledger_bound(program)
            if bound == 'compute':
                pruned += len(_CONV_SCHEDULE_SPACE)
            else:
                space = _CONV_SCHEDULE_SPACE if bound == 'bandwidth' \
                    else _CONV_SCHEDULE_SPACE[:2]   # no ledger: modest
                pruned += len(_CONV_SCHEDULE_SPACE) - len(space)
                cands.extend(dict(c) for c in space)
        if any(op.type == 'dynamic_lstm' and
               not op.attr('use_peepholes', True) and
               op.attr('gate_activation', 'sigmoid') == 'sigmoid' and
               op.attr('cell_activation', 'tanh') == 'tanh' and
               op.attr('candidate_activation', 'tanh') == 'tanh'
               for op in ops):
            cands.extend({'lstm_batch_tile': t} for t in _LSTM_TILES)
        # dedupe, keep order
        seen, out = set(), []
        for c in cands:
            t = entry_token(c)
            if t not in seen:
                seen.add(t)
                out.append(c)
        if len(out) > self.max_candidates:
            pruned += len(out) - self.max_candidates
            out = out[:self.max_candidates]
        self.last_pruned = pruned
        return out

    def _signature(self, exe, program, feed):
        from ..executor import feed_signature
        return shape_signature(feed_signature(
            exe._prepare_feed(program, dict(feed))))

    def tune(self, program, feed, fetch_list, scope=None, persist=True,
             name=None):
        """Measure every candidate; persist and return
        ``(best_entry, report)``. ``report`` maps entry tokens
        ('baseline' for {}) to mean milliseconds a run — or to a
        ``'poisoned: ...'`` marker for candidates that raised (the sweep
        never aborts, and a poisoned candidate can never win or land in
        the cache)."""
        from ..executor import Executor, Scope
        from ..resilience import faultinject as _fi
        fp = program.fingerprint()
        label = name or fp[:10]
        t_begin = time.perf_counter()
        cands = self.candidates(program, feed)
        pruned = self.last_pruned
        _obs.emit('autotune', phase='begin', program=label, fp=fp,
                  candidates=len(cands), pruned=pruned)
        report = {}
        best, best_ms = None, None
        poisoned = 0
        sig = None
        # one Executor: the memo lives on the program, and each
        # candidate's knobs are read at launch, not at lowering
        exe = Executor(self.place)
        for cand in cands:
            tok = entry_token(cand) if cand else 'baseline'
            cscope = scope if scope is not None else Scope()
            self._m_candidates.inc()
            try:
                # pinned: the lowered program's own entry (if the cache
                # has one) must not replace the candidate's knobs
                with _installed(cand, True):
                    _fi.maybe_fault(_fi.SITE_TUNING_MEASURE)
                    if sig is None:
                        sig = self._signature(exe, program, feed)
                    for _ in range(self.warmup):
                        exe.run(program, feed=dict(feed),
                                fetch_list=fetch_list, scope=cscope)
                    t0 = time.perf_counter()
                    for _ in range(self.steps):
                        exe.run(program, feed=dict(feed),
                                fetch_list=fetch_list, scope=cscope)
                    ms = (time.perf_counter() - t0) / self.steps * 1e3
            except Exception as err:  # noqa: BLE001 — a candidate that
                # fails on this device is poisoned; the sweep goes on
                poisoned += 1
                report[tok] = 'poisoned: %s' % type(err).__name__
                _obs.emit('autotune', phase='candidate_poisoned',
                          program=label, candidate=dict(cand),
                          error=type(err).__name__)
                continue
            report[tok] = round(ms, 3)
            if best_ms is None or ms < best_ms:
                best, best_ms = cand, ms
        if best_ms is not None and sig is not None:
            # cache the baseline {} winner too: "defaults win" is a
            # measured answer, and tune_if_missing must hit on it
            self.cache.put(fp, sig, backend(self._device()), best or {},
                           measured_ms=round(best_ms, 3), persist=persist)
        dur_s = time.perf_counter() - t_begin
        _obs.default_registry().histogram(
            'autotune_seconds', 'wall seconds per schedule search',
            program=label).observe(dur_s)
        _obs.emit('autotune', phase='end', program=label, fp=fp,
                  candidates=len(report), poisoned=poisoned, pruned=pruned,
                  winner=dict(best or {}),
                  best_ms=round(best_ms, 3) if best_ms else None,
                  seconds=round(dur_s, 3), report=dict(report))
        _obs.emit('tuning_search', fp=fp, candidates=len(report),
                  best=dict(best or {}),
                  best_ms=round(best_ms, 3) if best_ms else None)
        return best or {}, report

    def tune_if_missing(self, program, feed, fetch_list, scope=None,
                        persist=True, name=None):
        """Search only when the cache has no entry for this (program,
        shape, device kind). Returns ``(entry, searched)``: the serving
        ``warmup(autotune=True)`` building block, so the second warm-up
        of a process (or any process that preloaded the on-disk cache)
        does zero searches."""
        from ..executor import Executor
        exe = Executor(self.place)
        hit = self.cache.lookup(program.fingerprint(),
                                self._signature(exe, program, feed),
                                backend(exe.device), count=False)
        if hit is not None:
            return hit, False
        best, _report = self.tune(program, feed, fetch_list, scope=scope,
                                  persist=persist, name=name)
        return best, True
