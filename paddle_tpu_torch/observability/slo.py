"""Declared SLOs evaluated as multi-window burn rates.

Counterpart of paddle_tpu/observability/slo.py, copied whole. The
autoscaler reacted to raw queue depth and shed fractions; an
operator thinks in *objectives* — "99% of requests under 250ms", "shed
under 2%". This module closes that gap with the standard burn-rate
construction: an :class:`SLO` declares an objective over counter or
histogram series in the metrics registry, and the :class:`SLOEngine`
samples the cumulative good/bad totals on every :meth:`~SLOEngine.tick`
and evaluates the **bad fraction over each trailing window divided by
the error budget** (``1 - objective``):

- burn rate 1.0 = spending exactly the budget; >1 = on track to blow
  the objective; the published headline is the MINIMUM across the
  configured windows, so a single spike (short window burning, long
  window fine) doesn't page, while a sustained storm (every window
  burning) crosses immediately and *recovers* as soon as the shortest
  window cools — the classic multi-window alerting shape.
- published series: ``slo_burn_rate{slo=}`` and
  ``slo_budget_remaining{slo=}`` (budget left over the longest window,
  1.0 = untouched, 0.0 = spent), plus a journalled ``slo`` event on
  every breach/recovery transition.
- :meth:`SLOEngine.signal` exposes the worst current burn rate as a
  float probe the fleet ``Autoscaler`` consumes alongside queue depth
  (``slo_probe=``) — scale-out is an act of budget defense.

Objectives are declared over the *names* of registry series and summed
across their label sets, so one declaration covers every model on a
server and every replica in an aggregator registry.
"""
import threading
import time

from . import metrics as _metrics
from .journal import emit as _emit

__all__ = ['SLO', 'SLOEngine', 'DEFAULT_WINDOWS']

# trailing windows in seconds, shortest first. Production would use
# (300, 3600); the default here matches the timescale of this repo's
# smoke runs, and every constructor takes an override.
DEFAULT_WINDOWS = (5.0, 30.0)


class SLO(object):
    """One declared objective.

    Two shapes, both reducing to cumulative (bad, total) counts:

    - ``SLO.latency(name, histogram=, threshold_s=, objective=)`` —
      "``objective`` of requests complete within ``threshold_s``";
      bad = samples above the threshold, read from the histogram's
      cumulative buckets.
    - ``SLO.ratio(name, bad=, total=, objective=)`` — "at most
      ``1 - objective`` of ``total`` events are ``bad``" (shed rate,
      error rate), read from two counters.
    """

    def __init__(self, name, kind, objective, metric, threshold_s=None,
                 total_metric=None):
        if not 0.0 < objective < 1.0:
            raise ValueError('objective must be in (0, 1), got %r'
                             % (objective,))
        self.name = str(name)
        self.kind = kind
        self.objective = float(objective)
        self.metric = metric
        self.threshold_s = threshold_s
        self.total_metric = total_metric

    @property
    def budget(self):
        """The error budget: the fraction of events allowed to be bad."""
        return 1.0 - self.objective

    @classmethod
    def latency(cls, name, histogram, threshold_s, objective=0.99):
        return cls(name, 'latency', objective, histogram,
                   threshold_s=float(threshold_s))

    @classmethod
    def ratio(cls, name, bad, total, objective=0.98):
        return cls(name, 'ratio', objective, bad, total_metric=total)

    def describe(self):
        d = {'name': self.name, 'kind': self.kind,
             'objective': self.objective, 'metric': self.metric}
        if self.threshold_s is not None:
            d['threshold_s'] = self.threshold_s
        if self.total_metric is not None:
            d['total'] = self.total_metric
        return d

    # -- reading cumulative (bad, total) from a snapshot --------------------
    def counts(self, snapshot):
        """Cumulative ``(bad, total)`` event counts summed across every
        label set of the declared series in a registry ``snapshot()``."""
        if self.kind == 'latency':
            entry = snapshot.get(self.metric)
            bad = total = 0.0
            for series in (entry or {}).get('series', ()):
                n = float(series.get('count', 0))
                good = 0.0
                for edge_repr, cum in series.get('buckets',
                                                 {}).items():
                    if edge_repr == '+Inf':
                        continue
                    try:
                        edge = float(edge_repr)
                    except ValueError:
                        continue
                    if edge <= self.threshold_s and cum > good:
                        good = float(cum)
                total += n
                bad += max(0.0, n - good)
            return bad, total
        bad = self._sum_counter(snapshot, self.metric)
        total = self._sum_counter(snapshot, self.total_metric)
        return bad, total

    @staticmethod
    def _sum_counter(snapshot, name):
        entry = snapshot.get(name)
        return sum(float(s.get('value', 0.0))
                   for s in (entry or {}).get('series', ()))


class SLOEngine(object):
    """Samples declared SLOs against a registry and publishes burn
    rates. Drive it by calling :meth:`tick` periodically (the fleet
    autoscaler's ``slo_probe`` does)."""

    def __init__(self, slos, registry=None, windows=DEFAULT_WINDOWS,
                 breach_at=1.0, clock=time.monotonic):
        if not slos:
            raise ValueError('declare at least one SLO')
        self.slos = list(slos)
        names = [s.name for s in self.slos]
        if len(set(names)) != len(names):
            raise ValueError('duplicate SLO names: %r' % (names,))
        self.registry = registry or _metrics.default_registry()
        self.windows = tuple(sorted(float(w) for w in windows))
        if not self.windows:
            raise ValueError('need at least one window')
        self.breach_at = float(breach_at)
        self._clock = clock
        self._lock = threading.Lock()
        self._samples = {s.name: [] for s in self.slos}
        self._breached = {s.name: False for s in self.slos}
        self._gauges = {}
        for s in self.slos:
            self._gauges[s.name] = (
                self.registry.gauge(
                    'slo_burn_rate',
                    'error-budget burn rate (min across windows; '
                    '1.0 = spending exactly the budget)', slo=s.name),
                self.registry.gauge(
                    'slo_budget_remaining',
                    'error budget left over the longest window '
                    '(1.0 = untouched)', slo=s.name))

    # -- evaluation ---------------------------------------------------------
    def _window_fraction(self, samples, now, window):
        """Bad fraction of events inside the trailing window — delta
        bad over delta total between the oldest in-window sample and
        the newest."""
        newest = samples[-1]
        oldest = None
        for t, bad, total in samples:
            if now - t <= window:
                oldest = (t, bad, total)
                break
        if oldest is None or newest[0] <= oldest[0]:
            # one sample in window: burn is unknown, report clean
            return 0.0
        d_total = newest[2] - oldest[2]
        d_bad = newest[1] - oldest[1]
        if d_total <= 0:
            return 0.0
        return max(0.0, d_bad) / d_total

    def tick(self):
        """Sample every SLO once; returns ``{name: report}`` where each
        report carries ``burn_rate`` (min across windows),
        ``budget_remaining``, per-window burns, and ``breached``."""
        snapshot = self.registry.snapshot()
        now = self._clock()
        horizon = self.windows[-1] * 2.0
        out = {}
        for s in self.slos:
            bad, total = s.counts(snapshot)
            with self._lock:
                samples = self._samples[s.name]
                samples.append((now, bad, total))
                while samples and now - samples[0][0] > horizon and \
                        len(samples) > 2:
                    samples.pop(0)
                samples = list(samples)
            burns = {}
            for w in self.windows:
                frac = self._window_fraction(samples, now, w)
                burns[w] = frac / s.budget
            burn = min(burns.values())
            # budget over the longest window: fraction of the allowed
            # bad events already spent
            remaining = max(0.0, 1.0 - burns[self.windows[-1]])
            burning = burn > self.breach_at
            g_burn, g_rem = self._gauges[s.name]
            g_burn.set(burn)
            g_rem.set(remaining)
            with self._lock:
                was = self._breached[s.name]
                self._breached[s.name] = burning
            if burning != was:
                _emit('slo', slo=s.name,
                      state='breach' if burning else 'recovered',
                      burn_rate=round(burn, 4),
                      budget_remaining=round(remaining, 4),
                      objective=s.objective,
                      windows={repr(w): round(b, 4)
                               for w, b in burns.items()})
            out[s.name] = {
                'burn_rate': burn, 'budget_remaining': remaining,
                'windows': burns, 'breached': burning,
                'bad': bad, 'total': total,
                'objective': s.objective,
            }
        return out

    def signal(self):
        """Worst current burn rate across every declared SLO — the
        float probe ``Autoscaler(slo_probe=engine.signal)`` consumes.
        Ticks the engine (cheap: one snapshot + arithmetic)."""
        reports = self.tick()
        return max(r['burn_rate'] for r in reports.values())

    def breached(self):
        """Names of SLOs currently past ``breach_at``."""
        with self._lock:
            return sorted(n for n, b in self._breached.items() if b)

    def describe(self):
        return {'windows': list(self.windows),
                'breach_at': self.breach_at,
                'slos': [s.describe() for s in self.slos]}
