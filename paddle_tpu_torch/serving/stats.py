"""Per-server serving statistics: counters, latency histograms, batch
occupancy, bucket distribution — the numbers an operator tunes
``max_batch_size`` / ``batch_timeout`` / bucket bounds against.

Everything is guarded by one lock and recorded from worker threads;
``as_dict()`` / ``report()`` snapshot consistently. Latency histograms
use power-of-two millisecond buckets (0.25ms, 0.5ms, ... 32s) — the
same log-2 philosophy as shape bucketing: bounded cardinality, constant
relative resolution.

Counterpart of paddle_tpu/serving/stats.py, with its mirror into the
process-wide metric registry and the run journal (the same series and
event names); the batch counts are also kept per model.
"""
import threading

from .. import observability as _obs
from .breaker import STATE_CODES

__all__ = ['LatencyHistogram', 'ServingStats']

# histogram bucket upper bounds in milliseconds: 0.25ms .. 32768ms + inf
_HIST_EDGES_MS = [0.25 * (2 ** i) for i in range(18)]


class LatencyHistogram(object):
    """Log-2 latency histogram (milliseconds). Not self-locking — the
    owning ServingStats serializes access."""

    def __init__(self):
        self.counts = [0] * (len(_HIST_EDGES_MS) + 1)
        self.count = 0
        self.total_ms = 0.0
        self.max_ms = 0.0

    def record(self, seconds):
        ms = seconds * 1000.0
        self.count += 1
        self.total_ms += ms
        self.max_ms = max(self.max_ms, ms)
        for i, edge in enumerate(_HIST_EDGES_MS):
            if ms <= edge:
                self.counts[i] += 1
                return
        self.counts[-1] += 1

    def quantile(self, q):
        """Approximate quantile: the upper edge of the bucket holding
        the q-th sample (ms)."""
        if not self.count:
            return 0.0
        target, seen = q * self.count, 0
        for i, c in enumerate(self.counts):
            seen += c
            if seen >= target and c:
                return _HIST_EDGES_MS[i] if i < len(_HIST_EDGES_MS) \
                    else self.max_ms
        return self.max_ms

    def as_dict(self):
        return {
            'count': self.count,
            'mean_ms': self.total_ms / self.count if self.count else 0.0,
            'p50_ms': self.quantile(0.50),
            'p99_ms': self.quantile(0.99),
            'max_ms': self.max_ms,
        }


class ServingStats(object):
    """One instance per ModelServer; every mutation happens under
    ``_lock``, so client and worker threads never tear counters."""

    def __init__(self):
        self._lock = threading.Lock()
        self.submitted = 0
        self.completed = 0
        self.shed = 0          # rejected at admission (ServerOverloaded)
        self.expired = 0       # deadline passed before a worker ran it
        self.failed = 0        # run raised after retries
        self.retries = 0       # transient failures absorbed by retry
        self.breaker_rejected = 0  # shed by an open circuit breaker
        self.cancelled = 0         # failed by close()/abandon escalation
        self.watchdog_trips = 0    # stages tripped past their deadline
        self.breaker_transitions = {}   # to_state -> count
        self.batches = 0
        self.batched_rows = 0      # real rows carried by all batches
        self.padded_rows = 0       # pad rows added by bucketing
        self.bucket_counts = {}    # bucket size -> batches launched
        self.model_batches = {}    # model name -> batches launched
        self.request_latency = LatencyHistogram()  # submit -> result set
        self.batch_latency = LatencyHistogram()    # one executor run
        # process registry mirrors: the per-server counters above stay
        # the exact per-ModelServer surface; these
        # aggregate across every server in the process.
        reg = _obs.default_registry()
        self._m = {
            'submitted': reg.counter('serving_requests_submitted_total',
                                     'requests admitted to a queue'),
            'completed': reg.counter('serving_requests_completed_total',
                                     'requests answered'),
            'shed': reg.counter('serving_requests_shed_total',
                                'requests rejected at admission'),
            'expired': reg.counter('serving_requests_expired_total',
                                   'requests whose deadline passed'),
            'failed': reg.counter('serving_requests_failed_total',
                                  'requests failed after retries'),
            'retries': reg.counter('serving_retries_total',
                                   'transient batch-run retries'),
            'breaker_rejected': reg.counter(
                'serving_breaker_rejected_total',
                'requests shed by an open circuit breaker'),
            'cancelled': reg.counter(
                'serving_requests_cancelled_total',
                'requests failed by close()/abandon escalation'),
            'batches': reg.counter('serving_batches_total',
                                   'device batches launched'),
            'rows': reg.counter('serving_batch_rows_total',
                                'real rows carried by batches'),
            'padded': reg.counter('serving_padded_rows_total',
                                  'pad rows added by bucketing'),
            'request_lat': reg.histogram('serving_request_seconds',
                                         'submit -> result latency'),
            'batch_lat': reg.histogram('serving_batch_seconds',
                                       'one batched executor run'),
        }

    # ---- recording (worker/client threads) -------------------------------
    def record_submitted(self, n=1):
        with self._lock:
            self.submitted += n
        self._m['submitted'].inc(n)
        _obs.emit('serving_admit', n=n)

    def record_shed(self, n=1):
        with self._lock:
            self.shed += n
        self._m['shed'].inc(n)
        _obs.emit('serving_shed', n=n)

    def record_expired(self, n=1):
        with self._lock:
            self.expired += n
        self._m['expired'].inc(n)
        _obs.emit('serving_expired', n=n)

    def record_failed(self, n=1):
        with self._lock:
            self.failed += n
        self._m['failed'].inc(n)
        _obs.emit('serving_failed', n=n)

    def record_retry(self, n=1):
        with self._lock:
            self.retries += n
        self._m['retries'].inc(n)
        _obs.emit('serving_retry', n=n)

    def record_breaker_rejected(self, model, n=1):
        with self._lock:
            self.breaker_rejected += n
        self._m['breaker_rejected'].inc(n)
        _obs.emit('serving_breaker_rejected', model=model, n=n)

    def record_cancelled(self, n=1):
        with self._lock:
            self.cancelled += n
        self._m['cancelled'].inc(n)
        _obs.emit('serving_cancelled', n=n)

    def record_breaker_state(self, model, state):
        """Publish the per-model breaker gauge (0 closed / 1 half-open
        / 2 open) without counting a transition — the init path."""
        _obs.default_registry().gauge(
            'serving_breaker_state',
            'circuit state per model: 0 closed / 1 half-open / 2 open',
            model=model).set(STATE_CODES[state])

    def record_breaker_transition(self, model, to_state, reason=''):
        with self._lock:
            self.breaker_transitions[to_state] = \
                self.breaker_transitions.get(to_state, 0) + 1
        self.record_breaker_state(model, to_state)
        _obs.default_registry().counter(
            'serving_breaker_transitions_total',
            'circuit-breaker state transitions',
            model=model, to=to_state).inc()
        _obs.emit('serving_breaker', model=model, to=to_state,
                  reason=reason)

    def record_watchdog_trip(self, model, stage='', failed=0,
                             overrun=0.0):
        with self._lock:
            self.watchdog_trips += 1
        _obs.default_registry().counter(
            'serving_watchdog_trips_total',
            'in-flight stages failed past their deadline',
            model=model).inc()
        _obs.emit('serving_watchdog_trip', model=model, stage=stage,
                  failed=failed, overrun_s=round(overrun, 6))

    def record_batch(self, rows, bucket, seconds, model=None):
        with self._lock:
            self.batches += 1
            if model is not None:
                self.model_batches[model] = \
                    self.model_batches.get(model, 0) + 1
            self.batched_rows += rows
            self.padded_rows += bucket - rows
            self.bucket_counts[bucket] = \
                self.bucket_counts.get(bucket, 0) + 1
            self.batch_latency.record(seconds)
        self._m['batches'].inc()
        self._m['rows'].inc(rows)
        self._m['padded'].inc(bucket - rows)
        self._m['batch_lat'].observe(seconds)
        _obs.emit('serving_batch', rows=rows, bucket=bucket,
                  dur_s=round(seconds, 6))

    def record_completed(self, latency_seconds, n=1, trace=None):
        with self._lock:
            self.completed += n
            for _ in range(n):
                self.request_latency.record(latency_seconds)
        self._m['completed'].inc(n)
        # the trace id rides the latency bucket as an exemplar, so a
        # bad p99 resolves to a concrete trace
        self._m['request_lat'].observe(latency_seconds, exemplar=trace)

    # ---- snapshots -------------------------------------------------------
    def occupancy(self):
        """Mean fraction of each launched batch that was real rows."""
        total = self.batched_rows + self.padded_rows
        return self.batched_rows / total if total else 0.0

    def as_dict(self, cache_info=None):
        with self._lock:
            d = {
                'requests': {
                    'submitted': self.submitted,
                    'completed': self.completed,
                    'shed': self.shed,
                    'expired': self.expired,
                    'failed': self.failed,
                    'retries': self.retries,
                    'breaker_rejected': self.breaker_rejected,
                    'cancelled': self.cancelled,
                },
                'guardrails': {
                    'watchdog_trips': self.watchdog_trips,
                    'breaker_transitions': dict(
                        self.breaker_transitions),
                },
                'batches': {
                    'count': self.batches,
                    'rows': self.batched_rows,
                    'padded_rows': self.padded_rows,
                    'occupancy': self.occupancy(),
                    'bucket_counts': dict(self.bucket_counts),
                    'by_model': dict(self.model_batches),
                },
                'latency': {
                    'request': self.request_latency.as_dict(),
                    'batch': self.batch_latency.as_dict(),
                },
            }
        if cache_info is not None:
            lookups = cache_info.hits + cache_info.misses
            d['compile_cache'] = {
                'hits': cache_info.hits,
                'misses': cache_info.misses,
                'size': cache_info.size,
                'hit_rate': cache_info.hits / lookups if lookups else 0.0,
            }
        return d

    def report(self, cache_info=None):
        """Human-readable dashboard, profiler-report style."""
        d = self.as_dict(cache_info=cache_info)
        r, b, lat = d['requests'], d['batches'], d['latency']
        g = d['guardrails']
        lines = [
            '----------------->     Serving Report     <-----------------',
            'requests: %(submitted)d submitted, %(completed)d completed, '
            '%(shed)d shed, %(expired)d expired, %(failed)d failed, '
            '%(retries)d retries' % r,
            'guardrails: %d breaker-rejected, %d cancelled, '
            '%d watchdog trips, breaker transitions %s'
            % (r['breaker_rejected'], r['cancelled'],
               g['watchdog_trips'],
               ', '.join('%s->%d' % (k, v) for k, v in sorted(
                   g['breaker_transitions'].items())) or '-'),
            'batches:  %d launched, %d rows (+%d pad), occupancy %.1f%%'
            % (b['count'], b['rows'], b['padded_rows'],
               100.0 * b['occupancy']),
            'buckets:  %s' % (', '.join(
                '%d->%d' % (k, v)
                for k, v in sorted(b['bucket_counts'].items())) or '-'),
            'latency:  request p50 %.2fms p99 %.2fms max %.2fms | '
            'batch p50 %.2fms p99 %.2fms max %.2fms'
            % (lat['request']['p50_ms'], lat['request']['p99_ms'],
               lat['request']['max_ms'], lat['batch']['p50_ms'],
               lat['batch']['p99_ms'], lat['batch']['max_ms']),
        ]
        if 'compile_cache' in d:
            c = d['compile_cache']
            lines.append(
                'compile cache: %d hits / %d misses (%d programs), '
                'hit rate %.1f%%' % (c['hits'], c['misses'], c['size'],
                                     100.0 * c['hit_rate']))
        return '\n'.join(lines)
