"""Signal-driven fleet autoscaler: the sense -> act loop.

Counterpart of paddle_tpu/fleet/autoscaler.py. One daemon thread (or a
test-driven :meth:`Autoscaler.tick`) reads live signals (queue depth
and shed counters per server, breaker/watchdog state in ``health()``,
the serving latency histogram, SLO burn rates) and resizes the fleet
through the Router's elastic actuators:

- **scale-out** when load is *sustained* above the high watermark
  (mean queued work per routable replica over ``high_queue``, shed
  rate over ``high_shed_rate``, p99 latency over ``p99_slo_s``, or an
  SLO burning its budget) via :meth:`Router.add_replica`, whose
  placement replay loads and warms every model on the newcomer;
- **scale-in** when load is sustained below the low watermark, via
  :meth:`Router.retire_replica`, but only after
  :meth:`Router.can_retire` proves the survivors can absorb every
  placement inside the :class:`~paddle_tpu_torch.fleet.router.
  PlacementBudget` (a fleet never shrinks into infeasibility);
- **never flaps**: watermarks must hold for ``sustain`` consecutive
  ticks (hysteresis), scale-ups and scale-downs have independent
  cooldowns, and ``min_replicas``/``max_replicas`` bound the fleet.

Ownership: the autoscaler *only* adds/retires replicas; repairing
broken ones stays with the :class:`~paddle_tpu_torch.fleet.supervisor.
ReplicaSupervisor`. The handoff is the router's replica table: a
retired id leaves it atomically, and both loops treat "not in the
table" as "not mine" (``ReplicaRetired`` is a drop, never a retry).

Telemetry, with the JAX package's names: ``autoscale_replicas`` /
``autoscale_queue_per_replica`` / ``autoscale_shed_rate`` gauges,
``autoscale_scale_ups_total`` / ``autoscale_scale_downs_total`` /
``autoscale_holds_total`` counters, and an ``autoscale`` journal
event for every decision (scale_up / scale_down / hold) carrying the
signals that drove it.
"""
import logging
import threading
import time

from .. import observability as _obs
from .router import ACTIVE

__all__ = ['Autoscaler', 'ReplicaBackend', 'Signals']

logger = logging.getLogger('paddle_tpu_torch.fleet')


class ReplicaBackend(object):
    """Scale-up provisioning policy: which backend the next replica
    comes from.

    The shape is fill-local-then-go-remote: in-process replicas while
    the fleet is below ``local_max``, ``remote`` beyond it (a backend
    name or a callable ``Router.add_replica`` takes; the port's
    ``'remote'`` raises until multihost, ROADMAP Queue A item 6).
    ``local_max=None`` never leaves the factory. Pass an instance as
    ``Autoscaler(replica_backend=...)``; any object with a
    ``choose(signals) -> backend`` method (or a bare callable) works
    in its place."""

    def __init__(self, local_max=None, remote='remote'):
        self.local_max = None if local_max is None else int(local_max)
        self.remote = remote

    def choose(self, signals):
        if self.local_max is not None and \
                signals.replicas >= self.local_max:
            return self.remote
        return None


class Signals(object):
    """One tick's consistent signal snapshot."""

    __slots__ = ('replicas', 'active', 'routable', 'queued',
                 'queue_per_replica', 'shed_rate', 'shed_delta',
                 'submitted_delta', 'p99_s', 'p99_stage', 'slo_burn',
                 'slo_breached')

    def as_dict(self):
        return {k: getattr(self, k) for k in self.__slots__}


class Autoscaler(object):
    """Hysteresis-and-cooldown control loop over a Router.

    Parameters
    ----------
    router : Router
        The fleet to control (its ``factory`` builds new replicas).
    min_replicas, max_replicas : int
        Hard fleet-size bounds. ``min_replicas`` is clamped up to the
        router's replication floor.
    high_queue, low_queue : float
        Watermarks on mean queued work per routable replica. Above
        high -> scale-out pressure; below low -> scale-in pressure;
        between them the controller holds (hysteresis band).
    high_shed_rate : float
        Scale-out pressure when sheds per submitted request over the
        last tick exceed this fraction.
    p99_slo_s : float, optional
        Scale-out pressure when the traced p99 exceeds this. Read
        from ``p99_probe`` when given (span store), else from the
        ``serving_request_seconds`` histogram.
    sustain : int
        Consecutive ticks a watermark must hold before acting.
    up_cooldown, down_cooldown : float
        Minimum seconds between scale-ups / scale-downs. A scale-up
        also pushes the next allowed scale-down out by
        ``down_cooldown`` so the pair can't oscillate.
    interval : float
        Daemon tick cadence (:meth:`start`); tests call
        :meth:`tick` directly.
    p99_probe : callable, optional
        ``() -> {'p99_s': float, 'stage': str}``, e.g. read from a span
        store, so decisions carry the traced critical-path stage, not
        just a number.
    slo_probe : callable, optional
        ``() -> max burn rate across declared SLOs``: wire
        :meth:`~paddle_tpu_torch.observability.slo.SLOEngine.signal` here
        and any objective burning its error budget at >= 1x becomes
        scale-out pressure, independent of the raw watermarks.
    """

    def __init__(self, router, min_replicas=1, max_replicas=4,
                 high_queue=4.0, low_queue=0.5, high_shed_rate=0.05,
                 p99_slo_s=None, sustain=3, up_cooldown=5.0,
                 down_cooldown=10.0, interval=0.5, p99_probe=None,
                 slo_probe=None, replica_backend=None,
                 clock=time.monotonic):
        floor = max(1, router.replication or 1)
        if not 1 <= min_replicas <= max_replicas:
            raise ValueError('need 1 <= min_replicas <= max_replicas')
        self.router = router
        self.min_replicas = max(min_replicas, floor)
        self.max_replicas = max(max_replicas, self.min_replicas)
        self.high_queue = high_queue
        self.low_queue = low_queue
        self.high_shed_rate = high_shed_rate
        self.p99_slo_s = p99_slo_s
        self.sustain = max(1, int(sustain))
        self.up_cooldown = up_cooldown
        self.down_cooldown = down_cooldown
        self.interval = interval
        self.p99_probe = p99_probe
        self.slo_probe = slo_probe
        # provisioning policy: choose(signals) -> backend for the next
        # scale-up (None = router factory); see :class:`ReplicaBackend`
        self.replica_backend = replica_backend
        self.clock = clock
        self._stop = threading.Event()
        self._thread = None
        self._over = 0            # consecutive over-watermark ticks
        self._under = 0           # consecutive under-watermark ticks
        self._next_up = 0.0       # cooldown gates (clock timestamps)
        self._next_down = 0.0
        self._last_counts = {}    # rid -> (generation, shed, submitted)
        self.scale_ups = 0
        self.scale_downs = 0
        reg = _obs.default_registry()
        self._g_replicas = reg.gauge(
            'autoscale_replicas', 'replicas under autoscaler control')
        self._g_queue = reg.gauge(
            'autoscale_queue_per_replica',
            'mean queued work per routable replica (last tick)')
        self._g_shed = reg.gauge(
            'autoscale_shed_rate',
            'sheds per submitted request over the last tick')
        self._m_ups = reg.counter(
            'autoscale_scale_ups_total', 'replicas added by the '
            'autoscaler')
        self._m_downs = reg.counter(
            'autoscale_scale_downs_total', 'replicas retired by the '
            'autoscaler')
        self._m_holds = reg.counter(
            'autoscale_holds_total',
            'sustained scale decisions vetoed by bounds, cooldown or '
            'the placement budget')

    # ---- daemon ----------------------------------------------------------
    def start(self):
        if self._thread is not None:
            return self
        self._stop.clear()
        self._thread = threading.Thread(target=self._loop,
                                        name='fleet-autoscaler',
                                        daemon=True)
        self._thread.start()
        _obs.emit('autoscale', action='start',
                  min=self.min_replicas, max=self.max_replicas,
                  high_queue=self.high_queue, low_queue=self.low_queue,
                  sustain=self.sustain)
        return self

    def stop(self, timeout=5.0):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout)
            self._thread = None
            _obs.emit('autoscale', action='stop',
                      scale_ups=self.scale_ups,
                      scale_downs=self.scale_downs)

    def _loop(self):
        while not self._stop.wait(self.interval):
            try:
                self.tick()
            except Exception:  # noqa: BLE001 — the control loop must
                # survive anything a mid-restart replica throws at it
                logger.exception('autoscaler tick failed')

    # ---- signals ---------------------------------------------------------
    def signals(self):
        """Read the fleet's live signals (one pass, never raises past
        a broken replica) and refresh the autoscale gauges."""
        router = self.router
        with router._lock:
            reps = list(router._replicas.values())
        sig = Signals()
        sig.replicas = len(reps)
        sig.active = sum(1 for r in reps if r.state == ACTIVE)
        routable, queued = 0, 0.0
        shed_d = sub_d = 0
        counts = {}
        for rep in reps:
            if rep.state == ACTIVE:
                try:
                    score = rep.server.load_score()
                except Exception:  # noqa: BLE001 — scoring must not
                    score = float('inf')   # take down the controller
                if score != float('inf'):
                    routable += 1
                    queued += score
            try:
                stats = rep.server.stats
                shed = int(stats.shed) + int(stats.breaker_rejected)
                submitted = int(stats.submitted)
            except Exception:  # noqa: BLE001
                continue
            counts[rep.id] = (rep.generation, shed, submitted)
            last = self._last_counts.get(rep.id)
            if last is not None and last[0] == rep.generation:
                shed_d += max(0, shed - last[1])
                sub_d += max(0, submitted - last[2])
            else:
                # new/restarted replica: counters started fresh
                shed_d += shed
                sub_d += submitted
        self._last_counts = counts
        sig.routable = routable
        sig.queued = queued
        sig.queue_per_replica = queued / routable if routable \
            else float('inf') if sig.replicas else 0.0
        sig.shed_delta = shed_d
        sig.submitted_delta = sub_d
        sig.shed_rate = shed_d / float(sub_d + shed_d) \
            if (sub_d + shed_d) else 0.0
        sig.p99_s, sig.p99_stage = self._probe_p99()
        sig.slo_burn = self._probe_slo()
        sig.slo_breached = sig.slo_burn >= 1.0
        self._g_replicas.set(sig.replicas)
        self._g_queue.set(0.0 if sig.queue_per_replica == float('inf')
                          else sig.queue_per_replica)
        self._g_shed.set(sig.shed_rate)
        return sig

    def _probe_p99(self):
        if self.p99_probe is not None:
            try:
                out = self.p99_probe() or {}
                return (float(out.get('p99_s') or 0.0),
                        out.get('stage') or '')
            except Exception:  # noqa: BLE001 — probe is advisory
                logger.exception('p99 probe failed')
                return 0.0, ''
        h = _obs.default_registry().get('serving_request_seconds')
        if h is None:
            return 0.0, ''
        try:
            return float(h.quantile(0.99)), ''
        except Exception:  # noqa: BLE001
            return 0.0, ''

    def _probe_slo(self):
        if self.slo_probe is None:
            return 0.0
        try:
            return float(self.slo_probe() or 0.0)
        except Exception:  # noqa: BLE001 — probe is advisory
            logger.exception('slo probe failed')
            return 0.0

    # ---- the control loop ------------------------------------------------
    def tick(self, now=None):
        """One sense -> decide -> act pass. Returns the action taken:
        ``'scale_up'``, ``'scale_down'``, ``'hold'`` (sustained
        pressure vetoed by bounds/cooldown/budget) or ``''`` (inside
        the hysteresis band / pressure not yet sustained)."""
        now = self.clock() if now is None else now
        sig = self.signals()
        reasons = []
        if sig.queue_per_replica > self.high_queue:
            reasons.append('queue_per_replica %.2f > %.2f'
                           % (sig.queue_per_replica, self.high_queue))
        if sig.shed_rate > self.high_shed_rate:
            reasons.append('shed_rate %.3f > %.3f'
                           % (sig.shed_rate, self.high_shed_rate))
        if self.p99_slo_s is not None and sig.p99_s > self.p99_slo_s:
            reasons.append('p99 %.3fs > SLO %.3fs%s'
                           % (sig.p99_s, self.p99_slo_s,
                              ' at stage %s' % sig.p99_stage
                              if sig.p99_stage else ''))
        if sig.slo_breached:
            reasons.append('slo burn rate %.2fx >= 1x' % sig.slo_burn)
        over = bool(reasons)
        under = (not over and sig.routable >= sig.replicas and
                 sig.queue_per_replica < self.low_queue and
                 sig.shed_delta == 0)
        self._over = self._over + 1 if over else 0
        self._under = self._under + 1 if under else 0
        if self._over >= self.sustain:
            return self._scale_up(now, sig, '; '.join(reasons))
        if self._under >= self.sustain:
            return self._scale_down(now, sig)
        return ''

    def _hold(self, sig, direction, why):
        self._m_holds.inc()
        _obs.emit('autoscale', action='hold', direction=direction,
                  reason=why, **sig.as_dict())
        return 'hold'

    def _scale_up(self, now, sig, why):
        if sig.replicas >= self.max_replicas:
            return self._hold(sig, 'up', 'at max_replicas=%d'
                              % self.max_replicas)
        if now < self._next_up:
            return self._hold(sig, 'up', 'up-cooldown %.1fs remaining'
                              % (self._next_up - now))
        backend = None
        if self.replica_backend is not None:
            backend = self.replica_backend.choose(sig) \
                if hasattr(self.replica_backend, 'choose') \
                else self.replica_backend(sig)
        rid = self.router.add_replica(backend=backend)
        self._over = self._under = 0
        self._next_up = now + self.up_cooldown
        # a fresh replica needs at least one cooldown of signal before
        # any scale-in can judge the fleet oversized
        self._next_down = max(self._next_down,
                              now + self.down_cooldown)
        self.scale_ups += 1
        self._m_ups.inc()
        self._g_replicas.set(sig.replicas + 1)
        label = backend if isinstance(backend, str) else (
            'inprocess' if backend is None
            else getattr(backend, '__name__', 'custom'))
        _obs.emit('autoscale', action='scale_up', replica=rid,
                  backend=label, reason=why, **sig.as_dict())
        logger.info('autoscaler: scale-up -> replica %d (%s)', rid,
                    why)
        return 'scale_up'

    def _scale_down(self, now, sig):
        if sig.replicas <= self.min_replicas:
            # idle at the floor is steady state, not a vetoed decision
            self._under = 0
            return ''
        if now < self._next_down:
            return self._hold(sig, 'down',
                              'down-cooldown %.1fs remaining'
                              % (self._next_down - now))
        victim = self._pick_victim()
        if victim is None:
            return self._hold(sig, 'down', 'no retirable replica')
        ok, veto = self.router.can_retire(victim)
        if not ok:
            return self._hold(sig, 'down', veto)
        self.router.retire_replica(victim)
        self._over = self._under = 0
        self._next_down = now + self.down_cooldown
        self.scale_downs += 1
        self._m_downs.inc()
        self._g_replicas.set(sig.replicas - 1)
        _obs.emit('autoscale', action='scale_down', replica=victim,
                  reason='queue_per_replica %.2f < %.2f'
                  % (sig.queue_per_replica, self.low_queue),
                  **sig.as_dict())
        logger.info('autoscaler: scale-down -> retired replica %d',
                    victim)
        return 'scale_down'

    def _pick_victim(self):
        """Least-loaded ACTIVE replica, newest id breaking ties — the
        cheapest to drain, and the one whose loss disturbs the fewest
        sticky rings."""
        router = self.router
        with router._lock:
            reps = [r for r in router._replicas.values()
                    if r.state == ACTIVE]
        best, best_key = None, None
        for rep in reps:
            try:
                score = rep.server.load_score()
            except Exception:  # noqa: BLE001
                continue
            if score == float('inf'):
                continue
            key = (score, -rep.id)
            if best_key is None or key < best_key:
                best, best_key = rep.id, key
        return best
