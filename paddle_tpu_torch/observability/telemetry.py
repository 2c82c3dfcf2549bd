"""Live telemetry plane: a per-process scrape endpoint, the health
providers and the cross-process aggregator.

Counterpart of paddle_tpu/observability/telemetry.py, with its names
and its wire format:

- :func:`serve_telemetry`: a stdlib-only threaded HTTP endpoint
  (``ThreadingHTTPServer`` on 127.0.0.1, ephemeral port by default)
  serving

  ``/metrics``   Prometheus text exposition 0.0.4 of the process
                 registry, and
  ``/health``    a JSON document merging every registered health
                 provider (Router, ModelServer, DecodeEngine,
                 PrefillServer).

  The JAX package's ``/ledgers`` route reads the performance
  observatory (``perf.py``), which the port does not have yet (ROADMAP
  Queue A item 6): here it answers 404.

- the env contract, under the JAX package's names: ``PTPU_TELEMETRY=1``
  makes :func:`install_env_telemetry` start an endpoint;
  ``PTPU_TELEMETRY_DIR`` names a directory where each process
  atomically publishes ``<dir>/host-<pid>.port`` (or ``<name>.port``),
  so a process's endpoint is found without a registry service.

- :class:`TelemetryAggregator`: scrapes every registered endpoint,
  republishes each remote series into its own registry under added
  ``host=``/``replica=`` labels, and derives fleet-wide rollups:
  ``fleet_qps`` (completed-requests delta rate), ``fleet_shed_rate``
  (shed/submitted delta ratio) and ``fleet_worst_p99_seconds`` (the
  worst per-endpoint request-latency p99). Retiring an endpoint drops
  its series through the registry's ``remove_matching``, the same
  retirement path the router uses for dead replicas.

- :func:`parse_exposition`: a STRICT text-format parser (label
  unescaping, ``# HELP``/``# TYPE`` bookkeeping). The aggregator
  scrapes through it and the conformance test round-trips through it,
  so a formatting bug fails loudly in both places.

This file is the only module of paddle_tpu_torch that imports
``http.server`` (the JAX package's lint rule ``http-outside-telemetry``;
``tests/test_torch_isolation.py`` holds the port to it).
"""
import collections
import json
import os
import threading
import time
import weakref
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.request import urlopen

from . import flight as _flight
from . import metrics as _metrics
from .journal import emit as _emit

__all__ = [
    'TELEMETRY_ENV', 'TELEMETRY_DIR_ENV', 'CONTENT_TYPE', 'Sample',
    'TelemetryServer', 'serve_telemetry', 'install_env_telemetry',
    'env_telemetry_server', 'register_health_provider',
    'unregister_health_provider', 'collect_health', 'parse_exposition',
    'read_port_file', 'scan_port_dir', 'TelemetryAggregator',
]

# env contract (joins PTPU_JOURNAL / PTPU_TRACE_PARENT / PTPU_FLIGHT_DIR):
TELEMETRY_ENV = 'PTPU_TELEMETRY'          # truthy -> serve at startup
TELEMETRY_DIR_ENV = 'PTPU_TELEMETRY_DIR'  # port-file publication dir

CONTENT_TYPE = 'text/plain; version=0.0.4; charset=utf-8'

_TRUTHY = ('1', 'true', 'on', 'yes')


# ---- health providers -----------------------------------------------------
# name -> weakref to an object with a ``health()`` method. Weak so a
# Router/ModelServer that is simply garbage-collected (instead of
# close()d) never pins itself into every future /health response.
_HEALTH_LOCK = threading.Lock()
_HEALTH = {}


def register_health_provider(name, obj):
    """Expose ``obj.health()`` under ``name`` in every ``/health``
    response (and postmortem bundle) until unregistered or collected."""
    with _HEALTH_LOCK:
        _HEALTH[str(name)] = weakref.ref(obj)


def unregister_health_provider(name):
    with _HEALTH_LOCK:
        _HEALTH.pop(str(name), None)


def collect_health():
    """Merge every live provider into one JSON-ready doc. A provider
    whose ``health()`` raises reports the error instead of poisoning
    the whole document (a health endpoint that 500s during an incident
    is worse than useless)."""
    with _HEALTH_LOCK:
        refs = list(_HEALTH.items())
    providers, dead = {}, []
    for name, ref in refs:
        obj = ref()
        if obj is None:
            dead.append(name)
            continue
        try:
            providers[name] = obj.health()
        except Exception as e:
            providers[name] = {'status': 'error',
                               'error': '%s: %s' % (type(e).__name__, e)}
    if dead:
        with _HEALTH_LOCK:
            for name in dead:
                if name in _HEALTH and _HEALTH[name]() is None:
                    del _HEALTH[name]
    status = 'ok'
    for doc in providers.values():
        if isinstance(doc, dict) and \
                doc.get('status') not in ('ok', 'serving', 'active'):
            status = 'degraded'
    return {'status': status, 'pid': os.getpid(),
            'wall': round(time.time(), 6), 'providers': providers}


# ---- the endpoint ---------------------------------------------------------
class TelemetryServer(object):
    """One process's scrape endpoint; closes idempotently."""

    def __init__(self, httpd, thread, port_file=None):
        self._httpd = httpd
        self._thread = thread
        self.port_file = port_file
        self._closed = False

    @property
    def port(self):
        return self._httpd.server_address[1]

    @property
    def url(self):
        return 'http://127.0.0.1:%d' % self.port

    def close(self):
        if self._closed:
            return
        self._closed = True
        self._httpd.shutdown()
        self._httpd.server_close()
        self._thread.join(5.0)
        if self.port_file:
            try:
                os.unlink(self.port_file)
            except OSError:
                pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False


def _make_handler(registry):
    scrapes = registry.counter(
        'telemetry_scrapes_total',
        'HTTP requests served by this process telemetry endpoint')

    class Handler(BaseHTTPRequestHandler):
        # one scrape must never block the next: client sockets time out
        timeout = 10.0

        def _send(self, code, body, content_type):
            data = body.encode('utf-8')
            self.send_response(code)
            self.send_header('Content-Type', content_type)
            self.send_header('Content-Length', str(len(data)))
            self.end_headers()
            self.wfile.write(data)

        def do_GET(self):
            path = self.path.split('?', 1)[0]
            try:
                if path == '/metrics':
                    scrapes.inc()
                    self._send(200, registry.exposition(), CONTENT_TYPE)
                elif path == '/health':
                    scrapes.inc()
                    self._send(200, json.dumps(
                        collect_health(), sort_keys=True, default=repr),
                        'application/json')
                else:
                    self._send(404, 'not found\n', 'text/plain')
            except (BrokenPipeError, ConnectionResetError):
                pass   # scraper went away mid-response

        def log_message(self, fmt, *args):
            pass   # stdout is the workload's, not the scraper's

    return Handler


def _publish_port_file(directory, port, name=None):
    """Atomically publish this process's port under ``directory``
    (write a temporary file, then rename), so a scanner never reads a
    half-written file."""
    try:
        os.makedirs(directory)
    except OSError:
        pass
    stem = name or ('host-%d' % os.getpid())
    path = os.path.join(directory, '%s.port' % stem)
    tmp = path + '.tmp'
    with open(tmp, 'w') as f:
        f.write('%d\n' % port)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
    return path


def serve_telemetry(port=0, registry=None, port_dir=None, name=None):
    """Start this process's scrape endpoint on ``port`` (0 = ephemeral)
    and return a :class:`TelemetryServer`. With ``port_dir`` (or the
    ``PTPU_TELEMETRY_DIR`` env) the bound port is atomically published
    as ``<dir>/<name or host-pid>.port``. Also chains the flight
    recorder's SIGTERM bundle dump when called from the main thread."""
    registry = registry or _metrics.default_registry()
    httpd = ThreadingHTTPServer(('127.0.0.1', int(port)),
                                _make_handler(registry))
    httpd.daemon_threads = True
    thread = threading.Thread(target=httpd.serve_forever,
                              kwargs={'poll_interval': 0.1},
                              name='ptpu-telemetry', daemon=True)
    thread.start()
    directory = port_dir or os.environ.get(TELEMETRY_DIR_ENV)
    port_file = None
    if directory:
        port_file = _publish_port_file(
            directory, httpd.server_address[1], name=name)
    _flight.install_signal_dump()
    srv = TelemetryServer(httpd, thread, port_file=port_file)
    _emit('telemetry', action='serve', port=srv.port,
          port_file=port_file)
    return srv


_ENV_SERVER = [None]


def install_env_telemetry(name=None):
    """Honor the ``PTPU_TELEMETRY`` env contract: start (once) a
    process-lifetime endpoint when the var is truthy. Returns the
    server, or None when the contract is unset or already honored."""
    if _ENV_SERVER[0] is not None:
        return None
    if os.environ.get(TELEMETRY_ENV, '').lower() not in _TRUTHY:
        return None
    _ENV_SERVER[0] = serve_telemetry(name=name)
    return _ENV_SERVER[0]


def env_telemetry_server():
    """The endpoint installed by :func:`install_env_telemetry`."""
    return _ENV_SERVER[0]


# ---- strict exposition parser ---------------------------------------------
Sample = collections.namedtuple('Sample', ('name', 'labels', 'value'))

_NAME_START = set('abcdefghijklmnopqrstuvwxyz'
                  'ABCDEFGHIJKLMNOPQRSTUVWXYZ_:')
_NAME_CHARS = _NAME_START | set('0123456789')
_TYPES = ('counter', 'gauge', 'histogram', 'summary', 'untyped')


def _parse_value(s):
    if s == '+Inf':
        return float('inf')
    if s == '-Inf':
        return float('-inf')
    return float(s)


def _parse_labels(body, lineno):
    """``key="value",...`` with strict unescaping of ``\\\\``,
    ``\\\"`` and ``\\n`` — the inverse of the registry's
    ``_escape_label_value``."""
    labels, i, n = {}, 0, len(body)
    while i < n:
        j = i
        while j < n and body[j] in _NAME_CHARS:
            j += 1
        key = body[i:j]
        if not key or j >= n or body[j] != '=' or \
                body[j:j + 2] != '="':
            raise ValueError('line %d: malformed label at %r'
                             % (lineno, body[i:]))
        j += 2
        out = []
        while j < n and body[j] != '"':
            c = body[j]
            if c == '\\':
                if j + 1 >= n:
                    raise ValueError('line %d: dangling escape' % lineno)
                esc = body[j + 1]
                if esc == '\\':
                    out.append('\\')
                elif esc == '"':
                    out.append('"')
                elif esc == 'n':
                    out.append('\n')
                else:
                    raise ValueError('line %d: bad escape \\%s'
                                     % (lineno, esc))
                j += 2
            elif c == '\n':
                raise ValueError('line %d: raw newline in label value'
                                 % lineno)
            else:
                out.append(c)
                j += 1
        if j >= n:
            raise ValueError('line %d: unterminated label value'
                             % lineno)
        labels[key] = ''.join(out)
        j += 1   # closing quote
        if j < n:
            if body[j] != ',':
                raise ValueError('line %d: expected "," between '
                                 'labels, got %r' % (lineno, body[j]))
            j += 1
        i = j
    return labels


def parse_exposition(text):
    """Strictly parse Prometheus text format 0.0.4. Returns
    ``(meta, samples)`` where ``meta`` maps metric name to
    ``{'type':, 'help':}`` and ``samples`` is a list of
    :class:`Sample`. Raises ValueError on any malformed line — the
    conformance gate, not a forgiving scraper."""
    meta, samples = {}, []
    if text and not text.endswith('\n'):
        raise ValueError('exposition must end with a newline')
    for lineno, line in enumerate(text.split('\n')[:-1], 1):
        if not line:
            continue
        if line.startswith('#'):
            parts = line.split(' ', 3)
            if len(parts) >= 3 and parts[1] == 'TYPE':
                name, kind = parts[2], (parts[3] if len(parts) > 3
                                        else '')
                if kind not in _TYPES:
                    raise ValueError('line %d: unknown TYPE %r'
                                     % (lineno, kind))
                entry = meta.setdefault(name, {'type': None, 'help': ''})
                if entry['type'] is not None:
                    raise ValueError('line %d: duplicate TYPE for %s'
                                     % (lineno, name))
                entry['type'] = kind
            elif len(parts) >= 3 and parts[1] == 'HELP':
                name = parts[2]
                entry = meta.setdefault(name, {'type': None, 'help': ''})
                entry['help'] = parts[3] if len(parts) > 3 else ''
            # other comments are legal and ignored
            continue
        if line[0] not in _NAME_START:
            raise ValueError('line %d: bad metric name start: %r'
                             % (lineno, line))
        i = 1
        while i < len(line) and line[i] in _NAME_CHARS:
            i += 1
        name, rest = line[:i], line[i:]
        labels = {}
        if rest.startswith('{'):
            end = rest.rfind('}')
            if end < 0:
                raise ValueError('line %d: unterminated label set'
                                 % lineno)
            labels = _parse_labels(rest[1:end], lineno)
            rest = rest[end + 1:]
        rest = rest.strip()
        if not rest:
            raise ValueError('line %d: sample without a value' % lineno)
        try:
            value = _parse_value(rest.split(' ')[0])
        except ValueError:
            raise ValueError('line %d: bad sample value %r'
                             % (lineno, rest))
        samples.append(Sample(name, labels, value))
    return meta, samples


# ---- discovery ------------------------------------------------------------
def read_port_file(path):
    with open(path) as f:
        return int(f.read().strip())


def scan_port_dir(directory):
    """``{stem: port}`` for every published ``*.port`` file under the
    ``PTPU_TELEMETRY_DIR`` publication directory."""
    out = {}
    try:
        names = sorted(os.listdir(directory))
    except OSError:
        return out
    for fn in names:
        if not fn.endswith('.port'):
            continue
        try:
            out[fn[:-len('.port')]] = read_port_file(
                os.path.join(directory, fn))
        except (OSError, ValueError):
            continue
    return out


# ---- aggregation ----------------------------------------------------------
def _hist_quantile(buckets, q):
    """Quantile from cumulative ``(le_edge, cum_count)`` pairs — the
    same upper-edge estimate the in-process Histogram uses."""
    if not buckets:
        return 0.0
    buckets = sorted(buckets)
    total = buckets[-1][1]
    if not total:
        return 0.0
    target = q * total
    prev = 0
    for edge, cum in buckets:
        if cum >= target and cum > prev:
            return edge
        prev = cum
    return buckets[-1][0]


class TelemetryAggregator(object):
    """Scrapes registered endpoints into one fleet-wide registry.

    Every remote sample is republished as a gauge under its original
    name + labels **plus** the endpoint's identity labels (``host=``
    for launcher hosts, ``replica=`` for fleet replicas), so the merged
    exposition distinguishes the same series across processes. Rollups
    (``fleet_qps``, ``fleet_shed_rate``, ``fleet_worst_p99_seconds``)
    derive from scrape-to-scrape deltas. :meth:`retire` drops a dead
    endpoint's series via ``remove_matching`` — dashboards stop showing
    a replica the moment the fleet does."""

    def __init__(self, registry=None):
        self.registry = registry or _metrics.MetricsRegistry()
        self._lock = threading.Lock()
        self._endpoints = {}     # name -> {'url', 'labels', 'up'}
        self._names = {}         # endpoint name -> set of metric names
        self._prev = {}          # (endpoint, counter) -> (value, t)
        self.worst_endpoint = None

    # -- membership ---------------------------------------------------------
    def add_endpoint(self, name, url_or_port, **labels):
        """Register a scrape target. ``url_or_port`` is a base URL or a
        localhost port; ``labels`` (e.g. ``replica='1'``/``host='h0'``)
        are stamped onto every series scraped from it (defaulting to
        ``host=<name>``)."""
        if isinstance(url_or_port, int):
            url = 'http://127.0.0.1:%d' % url_or_port
        else:
            url = str(url_or_port).rstrip('/')
        if not labels:
            labels = {'host': str(name)}
        labels = {k: str(v) for k, v in labels.items()}
        with self._lock:
            self._endpoints[str(name)] = {
                'url': url, 'labels': labels, 'up': None}

    def add_dir(self, directory, **labels):
        """Register every port file published under ``directory`` (the
        ``PTPU_TELEMETRY_DIR`` contract). Returns the stems added."""
        found = scan_port_dir(directory)
        for stem, port in found.items():
            if labels:
                self.add_endpoint(stem, port,
                                  **{k: str(v) for k, v in
                                     labels.items()})
            else:
                self.add_endpoint(stem, port, host=stem)
        return sorted(found)

    def endpoints(self):
        with self._lock:
            return {n: dict(e) for n, e in self._endpoints.items()}

    def retire(self, name):
        """Drop an endpoint and every series scraped from it. Returns
        the number of series removed."""
        name = str(name)
        with self._lock:
            ep = self._endpoints.pop(name, None)
            series_names = self._names.pop(name, set())
            for key in [k for k in self._prev if k[0] == name]:
                del self._prev[key]
        if ep is None:
            return 0
        removed = 0
        for mname in series_names:
            removed += self.registry.remove_matching(mname,
                                                     **ep['labels'])
        _emit('telemetry', action='retire', endpoint=name,
              removed_series=removed)
        return removed

    # -- scraping -----------------------------------------------------------
    def _fetch(self, url, timeout):
        with urlopen(url + '/metrics', timeout=timeout) as resp:
            return resp.read().decode('utf-8')

    def scrape_once(self, timeout=5.0):
        """Scrape every endpoint, republish series, refresh rollups.
        Returns a summary dict (also journalled as a ``telemetry``
        event). A down endpoint marks ``up=0`` and keeps its last
        series — explicit :meth:`retire` is the only way series leave."""
        with self._lock:
            targets = [(n, dict(e)) for n, e in
                       sorted(self._endpoints.items())]
        now = time.monotonic()
        scraped, failures = 0, 0
        deltas = collections.defaultdict(float)
        worst_p99, worst_ep = 0.0, None
        for name, ep in targets:
            try:
                meta, samples = parse_exposition(
                    self._fetch(ep['url'], timeout))
            except Exception:
                failures += 1
                self._set_up(name, ep, 0)
                continue
            scraped += 1
            self._set_up(name, ep, 1)
            names_seen = set()
            buckets = collections.defaultdict(float)
            counters = collections.defaultdict(float)
            for s in samples:
                labels = dict(s.labels)
                labels.update(ep['labels'])
                self.registry.gauge(
                    s.name,
                    (meta.get(s.name) or {}).get('help', ''),
                    **labels).set(s.value)
                names_seen.add(s.name)
                if s.name == 'serving_request_seconds_bucket':
                    try:
                        buckets[_parse_value(
                            s.labels['le'])] += s.value
                    except (KeyError, ValueError):
                        pass
                elif s.name in ('serving_requests_completed_total',
                                'serving_requests_submitted_total',
                                'serving_requests_shed_total'):
                    counters[s.name] += s.value
            for cname, total in counters.items():
                key = (name, cname)
                with self._lock:
                    prev = self._prev.get(key)
                    self._prev[key] = (total, now)
                if prev is not None and now > prev[1]:
                    deltas[cname] += max(0.0, total - prev[0])
                    deltas[cname + '|dt'] = max(
                        deltas[cname + '|dt'], now - prev[1])
            if buckets:
                p99 = _hist_quantile(sorted(buckets.items()), 0.99)
                if p99 >= worst_p99:
                    worst_p99, worst_ep = p99, name
            with self._lock:
                self._names.setdefault(name, set()).update(names_seen)

        reg = self.registry
        dt = deltas.get('serving_requests_completed_total|dt', 0.0)
        qps = (deltas['serving_requests_completed_total'] / dt
               if dt else 0.0)
        submitted = deltas.get('serving_requests_submitted_total', 0.0)
        shed = deltas.get('serving_requests_shed_total', 0.0)
        shed_rate = shed / submitted if submitted > 0 else 0.0
        reg.gauge('fleet_qps', 'completed requests/s across every '
                  'scraped endpoint (scrape-to-scrape delta)').set(qps)
        reg.gauge('fleet_shed_rate', 'shed/submitted delta ratio '
                  'across every scraped endpoint').set(shed_rate)
        reg.gauge('fleet_worst_p99_seconds', 'worst per-endpoint '
                  'request-latency p99 this scrape').set(worst_p99)
        reg.gauge('fleet_endpoints_up', 'endpoints that answered the '
                  'last scrape').set(scraped)
        self.worst_endpoint = worst_ep
        summary = {'endpoints': len(targets), 'scraped': scraped,
                   'failures': failures, 'fleet_qps': round(qps, 3),
                   'fleet_shed_rate': round(shed_rate, 5),
                   'worst_p99_s': round(worst_p99, 6),
                   'worst_endpoint': worst_ep}
        _emit('telemetry', action='scrape', **summary)
        return summary

    def _set_up(self, name, ep, up):
        with self._lock:
            if name in self._endpoints:
                self._endpoints[name]['up'] = up
        self.registry.gauge(
            'telemetry_endpoint_up',
            '1 when the endpoint answered the last scrape',
            **ep['labels']).set(up)
        with self._lock:
            self._names.setdefault(name, set()).add(
                'telemetry_endpoint_up')

    # -- health fan-in ------------------------------------------------------
    def scrape_health(self, timeout=5.0):
        """``{endpoint: /health doc-or-None}`` across the fleet."""
        with self._lock:
            targets = [(n, e['url']) for n, e in
                       sorted(self._endpoints.items())]
        out = {}
        for name, url in targets:
            try:
                with urlopen(url + '/health', timeout=timeout) as resp:
                    out[name] = json.loads(resp.read().decode('utf-8'))
            except Exception:
                out[name] = None
        return out
