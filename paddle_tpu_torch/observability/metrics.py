"""Thread-safe metrics registry: counters, gauges, log2-bucket histograms.

Counterpart of paddle_tpu/observability/metrics.py, copied whole. The
registry is the host-side numbers surface of the port: the Executor
publishes memo and run-wall series, the compiler its pass times and op
counts, the tuner its cache hits and searches, and the serving runtime
its request and batch counters and latency histograms. Two read
surfaces, both consistent snapshots:

- ``exposition()`` — Prometheus text format (``# TYPE``/``# HELP``
  comments, cumulative ``_bucket{le=...}`` histogram series), ready to
  drop behind any HTTP handler or node-exporter textfile collector.
- ``snapshot()`` — a plain-JSON dict for programmatic consumers
  (``tools/obs_report.py``, tests).

Overhead budget: a counter ``inc()`` is one uncontended lock + an int
add (sub-microsecond); a histogram ``observe()`` adds a linear scan of
~24 bucket edges. Metric objects are interned by (name, labels) so hot
paths hold direct references and never touch the registry dict per
event. Stdlib only, no package imports, so any module can depend on it
without cycles.
"""
import threading

__all__ = ['Counter', 'Gauge', 'Histogram', 'MetricsRegistry',
           'default_registry', 'DEFAULT_SECONDS_EDGES']

# log2 bucket upper bounds in SECONDS: ~7.6us .. 64s (+inf overflow) —
# the same constant-relative-resolution philosophy as serving's shape
# buckets and latency histograms, wide enough for both a sub-ms memo
# hit dispatch and a multi-second schedule search.
DEFAULT_SECONDS_EDGES = tuple(2.0 ** i for i in range(-17, 7))


def _escape_label_value(v):
    """Prometheus text-format label escaping: backslash, double quote
    and line feed in a label value (program fingerprints, host names,
    error strings) would otherwise render an unparsable series line."""
    s = v if isinstance(v, str) else str(v)
    if '\\' in s:
        s = s.replace('\\', '\\\\')
    if '"' in s:
        s = s.replace('"', '\\"')
    if '\n' in s:
        s = s.replace('\n', '\\n')
    return s


def _fmt_labels(labels, extra=None):
    items = list(labels)
    if extra:
        items += list(extra)
    if not items:
        return ''
    return '{%s}' % ','.join('%s="%s"' % (k, _escape_label_value(v))
                             for k, v in items)


def _fmt_value(v):
    # Prometheus renders integers bare; avoid '5.0' noise for counters
    if float(v) == int(v):
        return '%d' % int(v)
    return repr(float(v))


class Counter(object):
    """Monotonically increasing value. ``inc`` is the only mutator."""

    __slots__ = ('name', 'labels', '_lock', '_value')

    def __init__(self, name, labels=()):
        self.name = name
        self.labels = labels
        self._lock = threading.Lock()
        self._value = 0

    def inc(self, n=1):
        if n < 0:
            raise ValueError('counters only go up; use a Gauge')
        with self._lock:
            self._value += n

    @property
    def value(self):
        with self._lock:
            return self._value

    def _reset(self):
        with self._lock:
            self._value = 0

    def _series(self):
        return {'labels': dict(self.labels), 'value': self.value}

    def _expose(self):
        return ['%s%s %s' % (self.name, _fmt_labels(self.labels),
                             _fmt_value(self.value))]


class Gauge(object):
    """A value that can go up and down (last-write-wins)."""

    __slots__ = ('name', 'labels', '_lock', '_value')

    def __init__(self, name, labels=()):
        self.name = name
        self.labels = labels
        self._lock = threading.Lock()
        self._value = 0.0

    def set(self, v):
        with self._lock:
            self._value = float(v)

    def inc(self, n=1):
        with self._lock:
            self._value += n

    @property
    def value(self):
        with self._lock:
            return self._value

    def _reset(self):
        with self._lock:
            self._value = 0.0

    def _series(self):
        return {'labels': dict(self.labels), 'value': self.value}

    def _expose(self):
        return ['%s%s %s' % (self.name, _fmt_labels(self.labels),
                             _fmt_value(self.value))]


class Histogram(object):
    """Log2-bucket histogram. ``observe`` records one sample; buckets
    are cumulative in the exposition (Prometheus ``le`` semantics)."""

    __slots__ = ('name', 'labels', 'edges', '_lock', '_counts', '_sum',
                 '_count', '_max', '_exemplars')

    def __init__(self, name, labels=(), edges=None):
        self.name = name
        self.labels = labels
        self.edges = tuple(edges) if edges is not None \
            else DEFAULT_SECONDS_EDGES
        self._lock = threading.Lock()
        self._counts = [0] * (len(self.edges) + 1)
        self._sum = 0.0
        self._count = 0
        self._max = 0.0
        self._exemplars = {}   # bucket index -> (exemplar, value)

    def observe(self, v, exemplar=None):
        """Record one sample; ``exemplar`` (a trace id) is kept
        last-write-wins for the bucket the sample lands in, so "p99 is
        bad" resolves to a concrete trace (OBSERVABILITY.md)."""
        v = float(v)
        idx = len(self.edges)
        for i, edge in enumerate(self.edges):
            if v <= edge:
                idx = i
                break
        with self._lock:
            self._counts[idx] += 1
            self._sum += v
            self._count += 1
            if v > self._max:
                self._max = v
            if exemplar is not None:
                self._exemplars[idx] = (exemplar, v)

    @property
    def count(self):
        with self._lock:
            return self._count

    @property
    def sum(self):
        with self._lock:
            return self._sum

    def quantile(self, q):
        """Approximate quantile: upper edge of the bucket holding the
        q-th sample (the observed max for the overflow bucket)."""
        with self._lock:
            counts, total, mx = list(self._counts), self._count, self._max
        if not total:
            return 0.0
        target, seen = q * total, 0
        for i, c in enumerate(counts):
            seen += c
            if seen >= target and c:
                return self.edges[i] if i < len(self.edges) else mx
        return mx

    def exemplar(self, q):
        """The exemplar attached to the bucket holding the q-th sample
        — ``(exemplar, observed_value)`` or None. Falls back to the
        nearest populated lower bucket with an exemplar, so a p99 probe
        still resolves when the exact bucket never got one."""
        with self._lock:
            counts, total = list(self._counts), self._count
            exemplars = dict(self._exemplars)
        if not total:
            return None
        target, seen, idx = q * total, 0, len(counts) - 1
        for i, c in enumerate(counts):
            seen += c
            if seen >= target and c:
                idx = i
                break
        for i in range(idx, -1, -1):
            if i in exemplars:
                return exemplars[i]
        return None

    def _reset(self):
        with self._lock:
            self._counts = [0] * (len(self.edges) + 1)
            self._sum = 0.0
            self._count = 0
            self._max = 0.0
            self._exemplars = {}

    def _series(self):
        with self._lock:
            counts = list(self._counts)
            s, n, mx = self._sum, self._count, self._max
            exemplars = dict(self._exemplars)
        buckets, cum = {}, 0
        for edge, c in zip(self.edges, counts):
            cum += c
            buckets[repr(edge)] = cum
        buckets['+Inf'] = n
        out = {'labels': dict(self.labels), 'count': n, 'sum': s,
               'max': mx, 'mean': (s / n if n else 0.0),
               'buckets': buckets}
        if exemplars:
            out['exemplars'] = {
                (repr(self.edges[i]) if i < len(self.edges) else '+Inf'):
                {'exemplar': ex, 'value': v}
                for i, (ex, v) in sorted(exemplars.items())}
        return out

    def _expose(self):
        with self._lock:
            counts = list(self._counts)
            s, n = self._sum, self._count
        lines, cum = [], 0
        for edge, c in zip(self.edges, counts):
            cum += c
            lines.append('%s_bucket%s %d' % (
                self.name,
                _fmt_labels(self.labels, [('le', repr(edge))]), cum))
        lines.append('%s_bucket%s %d' % (
            self.name, _fmt_labels(self.labels, [('le', '+Inf')]), n))
        lines.append('%s_sum%s %s' % (self.name,
                                      _fmt_labels(self.labels),
                                      _fmt_value(s)))
        lines.append('%s_count%s %d' % (self.name,
                                        _fmt_labels(self.labels), n))
        return lines


_TYPES = {'counter': Counter, 'gauge': Gauge, 'histogram': Histogram}


class MetricsRegistry(object):
    """Interns metrics by (name, labels); same name must keep one type
    and one help string. All accessors are thread-safe; hot paths keep
    the returned metric object and mutate it directly."""

    def __init__(self):
        self._lock = threading.Lock()
        self._metrics = {}     # (name, labels_tuple) -> metric
        self._meta = {}        # name -> (kind, help)

    def _get_or_create(self, kind, name, help, labels, **kwargs):
        key = (name, tuple(sorted(labels.items())))
        with self._lock:
            meta = self._meta.get(name)
            if meta is not None and meta[0] != kind:
                raise ValueError(
                    'metric %r already registered as a %s, requested %s'
                    % (name, meta[0], kind))
            m = self._metrics.get(key)
            if m is None:
                m = _TYPES[kind](name, labels=key[1], **kwargs)
                self._metrics[key] = m
                if meta is None:
                    self._meta[name] = (kind, help)
            return m

    def counter(self, name, help='', **labels):
        return self._get_or_create('counter', name, help, labels)

    def gauge(self, name, help='', **labels):
        return self._get_or_create('gauge', name, help, labels)

    def histogram(self, name, help='', edges=None, **labels):
        return self._get_or_create('histogram', name, help, labels,
                                   edges=edges)

    def get(self, name, **labels):
        """The existing metric, or None."""
        with self._lock:
            return self._metrics.get(
                (name, tuple(sorted(labels.items()))))

    def remove(self, name, **labels):
        """Retire one interned series so dashboards stop showing a
        replica/host that no longer exists (fleet retire, host loss).
        Returns True when a series was removed. The name's type/help
        registration survives — a future series under the same name
        re-registers cheaply — and callers holding the old metric
        object just mutate an orphan, which is safe."""
        with self._lock:
            return self._metrics.pop(
                (name, tuple(sorted(labels.items()))), None) is not None

    def remove_matching(self, name, **labels):
        """Retire every series of ``name`` whose labels include the
        given label values (all series of the name when no labels are
        passed). Returns the number of series removed."""
        want = set(labels.items())
        with self._lock:
            doomed = [k for k in self._metrics
                      if k[0] == name and want.issubset(set(k[1]))]
            for k in doomed:
                del self._metrics[k]
        return len(doomed)

    def reset(self):
        """Zero every registered series (registrations survive) — for
        separating benchmark phases without tearing down hot-path
        metric references."""
        with self._lock:
            metrics = list(self._metrics.values())
        for m in metrics:
            m._reset()

    def snapshot(self):
        """JSON-ready consistent view:
        ``{name: {type, help, series: [...]}}``."""
        with self._lock:
            items = sorted(self._metrics.items())
            meta = dict(self._meta)
        out = {}
        for (name, _labels), m in items:
            entry = out.setdefault(name, {
                'type': meta[name][0], 'help': meta[name][1],
                'series': []})
            entry['series'].append(m._series())
        return out

    def exposition(self):
        """Prometheus text exposition format (version 0.0.4)."""
        with self._lock:
            items = sorted(self._metrics.items())
            meta = dict(self._meta)
        lines, seen = [], set()
        for (name, _labels), m in items:
            if name not in seen:
                seen.add(name)
                kind, help = meta[name]
                if help:
                    lines.append('# HELP %s %s' % (name, help))
                lines.append('# TYPE %s %s' % (name, kind))
            lines.extend(m._expose())
        return '\n'.join(lines) + ('\n' if lines else '')


_DEFAULT = MetricsRegistry()


def default_registry():
    """The process-wide registry every built-in wiring point uses."""
    return _DEFAULT
