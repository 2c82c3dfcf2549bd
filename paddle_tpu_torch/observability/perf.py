"""Performance observatory: per-program cost and memory ledgers, live MFU
and roofline gauges, and the on-disk perf-regression baseline.

Counterpart of paddle_tpu/observability/perf.py. The JAX module reads
XLA's ``cost_analysis()`` of a compiled program; the port has no
compiled program, and its kernels are called through ``ctypes``, where
``torch.utils.flop_counter`` never sees them. So a program's ledger is
counted from its ops, on the memo miss's own run (no extra run):

- :func:`op_cost` gives each op's operations and bytes by the port's own
  formula per op type: 2 per multiply-add of a product (``mul``,
  ``matmul``, the convs, the fused conv region's conv, the flash
  attention's two products, the LSTM and GRU recurrences), 1 per output
  element of every other float op (the fused conv's epilogue stages
  too); bytes are each distinct input and output tensor once. An op
  before the backward marker counts three times (its forward and the
  backward's two products); the backward itself runs in autograd, where
  no op is seen.
- :class:`ProgramLedger` holds the sums, ``flops_by_type``, and the
  memory of the miss's run: the feeds and state (``argument_bytes``),
  the fetches and new state (``output_bytes``) and, on the card, the
  peak allocation above the start (``temp_bytes``, from
  ``torch.cuda.max_memory_allocated``).
- :class:`LedgerBook` is the process-wide store and feeds the
  ``perf_hbm_live_bytes`` / ``perf_hbm_watermark_bytes`` gauges;
  :func:`publish_step` joins a ledger with a measured step into
  ``perf_mfu{program=}`` and ``perf_roofline_bound{program=}``;
  ``perf_ledger`` journal events carry the tracing trace id;
  :class:`PerfBaseline` is the on-disk baseline that
  ``paddle_tpu_torch/tools/perf_report.py`` diffs a run against.

Peaks: NVIDIA's data sheet for the H100 SXM (dense, without sparsity,
at its 700 W limit): 989e12 bf16 operations/s and 3,350 GB/s of HBM. A
device kind is matched by its name as ``torch.cuda.get_device_name``
gives it; ``PTPU_PERF_PEAK_FLOPS`` and ``PTPU_PERF_HBM_GBPS`` override.

Overhead: capture is off by default (``capture_enabled()`` is one list
read, and an environment probe on a memo miss); on, it adds a Python
call per op to the miss's run only. Enable it with
:func:`enable_capture`, :func:`capture_scope` or ``PTPU_PERF=1``.
"""
import contextlib
import hashlib
import json
import os
import threading

from .journal import emit as _emit
from . import metrics as _metrics

__all__ = [
    'PERF_ENV', 'PEAK_FLOPS_ENV', 'HBM_GBPS_ENV',
    'DEFAULT_PEAK_FLOPS', 'DEFAULT_HBM_GBPS',
    'ProgramLedger', 'LedgerBook', 'PerfBaseline',
    'capture_enabled', 'enable_capture', 'capture_scope',
    'capture_run', 'op_cost', 'seal', 'publish_step',
    'book', 'get_ledger', 'ledgers', 'clear',
    'peak_flops_for', 'hbm_gbps_for', 'shape_signature',
]

PERF_ENV = 'PTPU_PERF'                    # '1': capture on for the process
PEAK_FLOPS_ENV = 'PTPU_PERF_PEAK_FLOPS'   # override the bf16 peak (op/s)
HBM_GBPS_ENV = 'PTPU_PERF_HBM_GBPS'       # override the HBM rate (GB/s)

# bf16 dense peak operations/s and HBM GB/s by a device name's substring
# (first match wins): NVIDIA's H100 SXM data sheet
PEAK_BF16 = (('h100', 989e12),)
HBM_GBPS = (('h100', 3350.0),)

DEFAULT_PEAK_FLOPS = 989e12
DEFAULT_HBM_GBPS = 3350.0

BASELINE_SCHEMA = 1

# relative drift allowed on the counted fields (flops, bytes) before the
# baseline diff calls it a mismatch
DETERMINISTIC_RTOL = 0.02

_TRUTHY = ('1', 'true', 'on', 'yes')


def _env_float(name):
    ov = os.environ.get(name)
    if ov:
        try:
            return float(ov)
        except ValueError:
            pass
    return None


def peak_flops_for(device_kind, default=DEFAULT_PEAK_FLOPS):
    """bf16 peak operations/s for a device name (``PTPU_PERF_PEAK_FLOPS``
    wins; an unknown name gives ``default``)."""
    ov = _env_float(PEAK_FLOPS_ENV)
    if ov is not None:
        return ov
    kind = (device_kind or '').lower()
    return next((p for s, p in PEAK_BF16 if s in kind), default)


def hbm_gbps_for(device_kind, default=DEFAULT_HBM_GBPS):
    """HBM GB/s for a device name (``PTPU_PERF_HBM_GBPS`` wins)."""
    ov = _env_float(HBM_GBPS_ENV)
    if ov is not None:
        return ov
    kind = (device_kind or '').lower()
    return next((b for s, b in HBM_GBPS if s in kind), default)


def device_kind(device):
    """The name of a torch device: the card's for CUDA, 'cpu' else."""
    if getattr(device, 'type', device) == 'cuda':
        import torch
        return torch.cuda.get_device_name(device)
    return 'cpu'


# ---- capture gate ---------------------------------------------------------
# tri-state: None -> the environment decides
_CAPTURE = [None]


def capture_enabled():
    v = _CAPTURE[0]
    if v is not None:
        return v
    return os.environ.get(PERF_ENV, '').lower() in _TRUTHY


def enable_capture(on=True):
    """Force capture on or off for the process (over ``PTPU_PERF``);
    ``None`` gives control back to the environment. Returns the previous
    override."""
    prev = _CAPTURE[0]
    _CAPTURE[0] = None if on is None else bool(on)
    return prev


@contextlib.contextmanager
def capture_scope(on=True):
    """Scoped :func:`enable_capture`; serving ``warmup()`` wraps its
    buckets in it while a journal is active, so each bucket ledgers."""
    prev = enable_capture(on)
    try:
        yield
    finally:
        _CAPTURE[0] = prev


# ---- signatures -----------------------------------------------------------
def _tensors(val):
    """The tensors of a run-time value: a tensor, a SequenceTensor's data
    and lengths, a list's items (a tensor array), nothing else."""
    import torch
    if isinstance(val, torch.Tensor):
        return [val]
    if hasattr(val, 'data') and hasattr(val, 'lengths'):
        return _tensors(val.data) + _tensors(val.lengths)
    if isinstance(val, dict) and 'list' in val:
        val = val['list']
    if isinstance(val, (list, tuple)):
        return [t for v in val for t in _tensors(v)]
    return []


def _nbytes(tensors):
    seen, total = set(), 0
    for t in tensors:
        if id(t) not in seen:
            seen.add(id(t))
            total += t.numel() * t.element_size()
    return total


def shape_signature(feed, state):
    """A short stable token of the feed's and state's shapes and dtypes:
    the shape axis of the baseline key."""
    items = []
    for d in (feed, state):
        for n in sorted(d):
            items.append((n, [(tuple(t.shape), str(t.dtype))
                              for t in _tensors(d[n])]))
    return hashlib.sha1(repr(items).encode()).hexdigest()[:16]


# ---- the count per op -----------------------------------------------------
def _prod(shape):
    r = 1
    for d in shape:
        r *= int(d)
    return r


def _first(op, env, slot, names=None):
    names = names if names is not None else op.inputs.get(slot) or []
    if not names:
        return None
    ts = _tensors(env.get(names[0]))
    return ts[0] if ts else None


def _out_elems(op, env):
    import torch
    return sum(t.numel() for n in op.output_arg_names
               for t in _tensors(env.get(n))
               if isinstance(t, torch.Tensor) and t.is_floating_point())


def _conv_flops(out, w, transposed=False, x=None):
    """2 a multiply-add: each output element (each input element for a
    transposed conv) takes filter.numel() / filter.shape[0] of them."""
    per = w.numel() // max(int(w.shape[0]), 1)
    return 2 * (x if transposed else out).numel() * per


def _product_flops(op, env):
    """The product operations of ``op``, or None for an op without one."""
    t = op.type
    if t == 'mul':
        x, y = _first(op, env, 'X'), _first(op, env, 'Y')
        ync = int(op.attrs.get('y_num_col_dims', 1))
        k = _prod(y.shape[:ync])
        return 2 * (x.numel() // max(k, 1)) * k * _prod(y.shape[ync:])
    if t == 'matmul':
        x = _first(op, env, 'X')
        k = int(x.shape[-2] if op.attrs.get('transpose_X') else x.shape[-1])
        out = _first(op, env, None, op.outputs.get('Out'))
        return 2 * out.numel() * k
    if t in ('conv2d', 'depthwise_conv2d', 'conv3d'):
        out = _first(op, env, None, op.outputs.get('Output'))
        return _conv_flops(out, _first(op, env, 'Filter'))
    if t in ('conv2d_transpose', 'conv3d_transpose'):
        return _conv_flops(None, _first(op, env, 'Filter'), True,
                           _first(op, env, 'Input'))
    if t == 'fused_conv':
        # the region's conv, then one operation an element a stage
        _, ins, _, _ = op.attrs['sub_ops'][0]
        out = _first(op, env, None, op.outputs['Out'])
        w = _first(op, env, None, ins['Filter'])
        return _conv_flops(out, w) + \
            (len(op.attrs['sub_ops']) - 1) * out.numel()
    if t == 'flash_attention':
        q, k = _first(op, env, 'Q'), _first(op, env, 'K')
        f = 4 * q.numel() * int(k.shape[1])
        return f // 2 if op.attrs.get('causal', True) else f
    if t in ('lstm', 'dynamic_lstm', 'gru', 'dynamic_gru'):
        x, w = _first(op, env, 'Input'), _first(op, env, 'Weight')
        return 2 * x.numel() * int(w.shape[0])
    return None


def op_cost(op, env, grad=False):
    """(operations, bytes) of one run of ``op`` on the values in ``env``
    (after it ran); ``grad`` (an op before the backward marker) counts
    its backward too, as twice its forward."""
    flops = _product_flops(op, env)
    if flops is None:
        flops = _out_elems(op, env)
    nbytes = _nbytes([t for n in op.input_arg_names + op.output_arg_names
                      for t in _tensors(env.get(n))])
    k = 3 if grad else 1
    return k * flops, k * nbytes


class _Counter(object):
    """Sums :func:`op_cost` over the ops a run sees."""

    def __init__(self):
        self.flops = 0
        self.bytes = 0
        self.by_type = {}

    def __call__(self, op, env, grad):
        try:
            f, b = op_cost(op, env, grad)
        except Exception:               # noqa: BLE001 -- diagnostic only
            _capture_failures().inc()
            return
        self.flops += f
        self.bytes += b
        self.by_type[op.type] = self.by_type.get(op.type, 0) + f


# the op hook BlockRunner.run_ops calls after each op while a capture runs
OP_HOOK = [None]


# ---- the ledger -----------------------------------------------------------
class ProgramLedger(object):
    """One lowered program's counted cost and measured memory."""

    __slots__ = ('fingerprint', 'shape_sig', 'backend', 'device_kind',
                 'mesh', 'devices', 'chain', 'flops', 'bytes_accessed',
                 'output_bytes', 'temp_bytes', 'argument_bytes',
                 'compile_wall_s', 'measured_ms', 'trace', 'label',
                 'flops_by_type')

    def __init__(self, fingerprint, shape_sig='', backend='',
                 device_kind='', mesh='single', devices=1, chain=0,
                 flops=0.0, bytes_accessed=0.0, output_bytes=0.0,
                 temp_bytes=0, argument_bytes=0, label='',
                 flops_by_type=None):
        self.fingerprint = fingerprint
        self.shape_sig = shape_sig
        self.backend = backend
        self.device_kind = device_kind
        self.mesh = mesh
        self.devices = int(devices)
        self.chain = int(chain)
        self.flops = float(flops)
        self.bytes_accessed = float(bytes_accessed)
        self.output_bytes = float(output_bytes)
        self.temp_bytes = int(temp_bytes)
        self.argument_bytes = int(argument_bytes)
        self.compile_wall_s = None
        self.measured_ms = None
        self.trace = None
        self.label = label
        self.flops_by_type = dict(flops_by_type or {})

    @property
    def live_bytes(self):
        """Bytes the program holds while it runs: arguments, outputs and
        the peak of its intermediates."""
        return int(self.argument_bytes + self.output_bytes +
                   self.temp_bytes)

    @property
    def peak_flops(self):
        return peak_flops_for(self.device_kind)

    @property
    def hbm_gbps(self):
        return hbm_gbps_for(self.device_kind)

    def bandwidth_bound_s(self, hbm_gbps=None):
        bw = self.hbm_gbps if hbm_gbps is None else hbm_gbps
        return self.bytes_accessed / (bw * 1e9)

    def compute_bound_s(self, peak=None):
        pk = self.peak_flops if peak is None else peak
        return self.flops / pk

    @property
    def roofline_bound(self):
        """The roofline leg that binds: the larger of the two bounds."""
        return ('compute' if self.compute_bound_s()
                >= self.bandwidth_bound_s() else 'bandwidth')

    def mfu(self, measured_ms=None, peak=None):
        """Counted operations over the measured step against the bf16
        peak; None until a step time is known."""
        ms = self.measured_ms if measured_ms is None else measured_ms
        if not ms:
            return None
        pk = self.peak_flops if peak is None else peak
        return self.flops / (ms / 1e3) / pk

    def as_dict(self):
        d = {
            'fp': self.fingerprint, 'shape_sig': self.shape_sig,
            'backend': self.backend, 'device_kind': self.device_kind,
            'mesh': self.mesh, 'devices': self.devices,
            'chain': self.chain, 'flops': self.flops,
            'bytes_accessed': self.bytes_accessed,
            'output_bytes': self.output_bytes,
            'temp_bytes': self.temp_bytes,
            'argument_bytes': self.argument_bytes,
            'live_bytes': self.live_bytes,
            'bandwidth_bound_ms': round(self.bandwidth_bound_s() * 1e3, 3),
            'compute_bound_ms': round(self.compute_bound_s() * 1e3, 3),
            'roofline': self.roofline_bound,
            'flops_by_type': dict(self.flops_by_type),
        }
        if self.label:
            d['program'] = self.label
        if self.compile_wall_s is not None:
            d['compile_wall_s'] = round(self.compile_wall_s, 6)
        if self.measured_ms is not None:
            d['measured_ms'] = round(self.measured_ms, 3)
            m = self.mfu()
            if m is not None:
                d['mfu'] = round(m, 4)
        return d


class LedgerBook(object):
    """Thread-safe (fp, shape_sig, backend, mesh) -> ledger store; owns
    the process's live and watermark byte gauges."""

    def __init__(self):
        self._lock = threading.Lock()
        self._entries = {}
        self._by_fp = {}
        self._watermark = 0

    @staticmethod
    def key(ledger):
        return '%s|%s|%s|%s' % (ledger.fingerprint, ledger.shape_sig,
                                ledger.backend, ledger.mesh)

    def record(self, ledger):
        with self._lock:
            self._entries[self.key(ledger)] = ledger
            self._by_fp[ledger.fingerprint] = ledger
            live = sum(l.live_bytes for l in self._entries.values())
            self._watermark = max(self._watermark, live)
            wm = self._watermark
        reg = _metrics.default_registry()
        reg.gauge('perf_hbm_live_bytes',
                  'sum of live bytes (args+outputs+temps) over all '
                  'ledgered programs, per device').set(live)
        reg.gauge('perf_hbm_watermark_bytes',
                  'high-water mark of perf_hbm_live_bytes over the '
                  'process lifetime').set(wm)
        return ledger

    def get(self, fingerprint):
        with self._lock:
            return self._by_fp.get(fingerprint)

    def ledgers(self):
        with self._lock:
            return list(self._entries.values())

    def __len__(self):
        with self._lock:
            return len(self._entries)

    def clear(self):
        with self._lock:
            self._entries.clear()
            self._by_fp.clear()
            self._watermark = 0


_BOOK = LedgerBook()
_PUBLISHED = set()    # fingerprints whose measured journal update went out
_GAUGES = {}          # fingerprint -> (mfu gauge, roofline gauge)


def book():
    return _BOOK


def get_ledger(fingerprint):
    return _BOOK.get(fingerprint)


def ledgers():
    return _BOOK.ledgers()


def clear():
    """Drop every ledger and the measured-once markers (test and phase
    isolation)."""
    _BOOK.clear()
    _PUBLISHED.clear()
    _GAUGES.clear()


# ---- capture / seal / publish ---------------------------------------------
def _capture_failures():
    return _metrics.default_registry().counter(
        'perf_capture_failures_total',
        'ledger captures that raised and were dropped (capture is '
        'diagnostic; it never fails the run)')


def capture_run(fn, feed, state, fingerprint, device):
    """Run ``fn(feed, state)`` (a lowered program's memo-miss run) with
    every op counted, and its memory read around it on the card.
    Returns (fetches, new_state, ledger). The run's own errors propagate;
    a failure of the count itself drops the ledger (None) and counts in
    ``perf_capture_failures_total``."""
    import torch
    cuda = getattr(device, 'type', device) == 'cuda'
    counter = _Counter()
    if cuda:
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
        start = torch.cuda.memory_allocated(device)
    prev, OP_HOOK[0] = OP_HOOK[0], counter
    try:
        fetches, new_state = fn(feed, state)
    finally:
        OP_HOOK[0] = prev
    try:
        temp = 0
        if cuda:
            torch.cuda.synchronize(device)
            temp = max(torch.cuda.max_memory_allocated(device) - start, 0)
        args = [t for d in (feed, state) for v in d.values()
                for t in _tensors(v)]
        outs = [t for v in list(fetches) + list(new_state.values())
                for t in _tensors(v)]
        ledger = ProgramLedger(
            fingerprint=fingerprint, shape_sig=shape_signature(feed, state),
            backend=getattr(device, 'type', str(device)),
            device_kind=device_kind(device), flops=counter.flops,
            bytes_accessed=counter.bytes, output_bytes=_nbytes(outs),
            temp_bytes=temp, argument_bytes=_nbytes(args),
            flops_by_type=counter.by_type)
    except Exception:                   # noqa: BLE001 -- diagnostic only
        _capture_failures().inc()
        ledger = None
    return fetches, new_state, ledger


def seal(ledger, compile_wall_s, trace=None):
    """Finish a captured ledger: the memo miss's wall, the trace context,
    record it in the book and journal a ``perf_ledger`` event (with the
    trace id where the miss ran under a sampled trace)."""
    if ledger is None:
        return None
    ledger.compile_wall_s = float(compile_wall_s)
    if trace is not None and getattr(trace, 'sampled', False):
        ledger.trace = trace.trace_id
    _BOOK.record(ledger)
    fields = ledger.as_dict()
    if ledger.trace:
        fields['trace'] = ledger.trace
    _emit('perf_ledger', **fields)
    return ledger


def publish_step(fingerprint, seconds_per_step):
    """Join a measured step with the program's ledger into the live
    gauges. One dict probe when nothing is ledgered; two gauge stores
    when a ledger exists. The first measurement of a program also
    journals a ``perf_ledger`` update with ``measured_ms`` and ``mfu``.
    Returns the MFU, or None."""
    if not _BOOK._by_fp:
        return None
    ledger = _BOOK.get(fingerprint)
    if ledger is None or not seconds_per_step:
        return None
    ms = seconds_per_step * 1e3
    ledger.measured_ms = ms
    mfu = ledger.mfu()
    pair = _GAUGES.get(fingerprint)
    if pair is None:
        reg = _metrics.default_registry()
        pair = (
            reg.gauge('perf_mfu',
                      'counted operations / measured step / bf16 peak, '
                      'per program', program=fingerprint),
            reg.gauge('perf_roofline_bound',
                      'roofline classification per program: 1.0 = '
                      'compute-bound, 0.0 = bandwidth-bound',
                      program=fingerprint))
        _GAUGES[fingerprint] = pair
    pair[0].set(mfu or 0.0)
    pair[1].set(1.0 if ledger.roofline_bound == 'compute' else 0.0)
    if fingerprint not in _PUBLISHED:
        _PUBLISHED.add(fingerprint)
        _emit('perf_ledger', fp=fingerprint, phase='measured',
              measured_ms=round(ms, 3),
              mfu=round(mfu, 4) if mfu is not None else None,
              roofline=ledger.roofline_bound)
    return mfu


# ---- regression baseline --------------------------------------------------
class PerfBaseline(object):
    """On-disk perf baseline: schema'd JSON of entries keyed
    ``fingerprint|shape-sig|backend|mesh``. Counted fields (flops, bytes)
    must match within ``DETERMINISTIC_RTOL``; timing fields (``step_ms``,
    ``mfu``), where both sides have them, gate at the caller's
    tolerance."""

    def __init__(self, path):
        self.path = path
        self.entries = {}

    @staticmethod
    def key(fingerprint, shape_sig, backend, mesh):
        return '%s|%s|%s|%s' % (fingerprint, shape_sig, backend, mesh)

    @classmethod
    def entry_from_ledger(cls, ledger, with_timings=False):
        e = {'program': ledger.label or ledger.fingerprint[:12],
             'device_kind': ledger.device_kind,
             'flops': ledger.flops,
             'bytes_accessed': ledger.bytes_accessed,
             'temp_bytes': ledger.temp_bytes,
             'argument_bytes': ledger.argument_bytes,
             'output_bytes': ledger.output_bytes}
        if with_timings and ledger.measured_ms:
            e['step_ms'] = round(ledger.measured_ms, 3)
            m = ledger.mfu()
            if m is not None:
                e['mfu'] = round(m, 4)
        return e

    def load(self):
        try:
            with open(self.path) as f:
                data = json.load(f)
        except (OSError, ValueError):
            return self
        if data.get('schema') == BASELINE_SCHEMA:
            self.entries = dict(data.get('entries', {}))
        return self

    def save(self):
        payload = {'schema': BASELINE_SCHEMA, 'entries': dict(self.entries)}
        os.makedirs(os.path.dirname(os.path.abspath(self.path)),
                    exist_ok=True)
        tmp = self.path + '.tmp.%d' % os.getpid()
        with open(tmp, 'w') as f:
            json.dump(payload, f, indent=1, sort_keys=True)
            f.write('\n')
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, self.path)

    def put(self, key, entry):
        self.entries[key] = dict(entry)

    def diff(self, current, tol=0.10, det_rtol=DETERMINISTIC_RTOL):
        """Problems of ``current`` ({key: entry}) against the baseline,
        each naming the program; empty means clean. A baseline key
        missing from the run is a problem; a new key is not."""
        problems = []
        for key, base in sorted(self.entries.items()):
            name = base.get('program') or key.split('|')[0][:12]
            cur = current.get(key)
            if cur is None:
                problems.append('%s: program missing from run (baseline '
                                'key %s)' % (name, key))
                continue
            for f in ('flops', 'bytes_accessed'):
                b, c = base.get(f), cur.get(f)
                if b is None or c is None:
                    continue
                if abs(c - b) > det_rtol * max(abs(b), 1.0):
                    problems.append('%s: %s drifted %.4g -> %.4g (> %.0f%% '
                                    'rtol)' % (name, f, b, c, det_rtol * 100))
            b_ms, c_ms = base.get('step_ms'), cur.get('step_ms')
            if b_ms and c_ms and c_ms > b_ms * (1.0 + tol):
                problems.append('%s: step time regressed %.3f ms -> %.3f ms '
                                '(> %.0f%% tolerance)' % (name, b_ms, c_ms,
                                                          tol * 100))
            b_m, c_m = base.get('mfu'), cur.get('mfu')
            if b_m and c_m and c_m < b_m * (1.0 - tol):
                problems.append('%s: MFU regressed %.4f -> %.4f (> %.0f%% '
                                'tolerance)' % (name, b_m, c_m, tol * 100))
        return problems
