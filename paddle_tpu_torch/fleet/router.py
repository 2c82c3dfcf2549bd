"""Replica router: one front-end spreading requests over N ModelServer
replicas.

Counterpart of paddle_tpu/fleet/router.py. The ``ModelServer`` is the
*cell*: micro-batching, breakers, watchdog, drain/swap inside one
process. The :class:`Router` is the *fleet* layer over N such cells
(on one card they share the device, each with its own Executor, worker
threads and scopes):

- **load-aware routing**: every submit ranks the model's placed
  replicas by :meth:`ModelServer.load_score` (one-lock queue-depth +
  breaker snapshot) and picks the least loaded; an open breaker,
  wedged worker or closed server scores ``inf`` and is never picked;
- **quarantine**: replicas whose health degrades (open breaker, wedged
  worker) are pulled out of the routing set by the supervisor and
  restored once healthy; a half-open breaker keeps receiving
  (deprioritized) traffic so its probes can re-close it;
- **sticky placement**: each model is placed on a deterministic ring
  of ``replication`` replicas keyed by the model name (``_ring_hash``,
  the JAX package's crc32, so both packages place a name alike), and a
  request carrying ``sticky_key`` prefers the same replica every time
  (cache affinity) while still failing over when it is unhealthy;
- **requeue on replica failure**: a request whose replica dies under
  it (``ServerClosed``/``WatchdogTimeout``) is transparently requeued
  onto another replica inside :meth:`RoutedRequest.result`; the
  client future never resolves untyped and never silently drops;
- **rolling deploys**: :meth:`rolling_swap` walks the placed replicas
  one at a time (the rest keep serving), swapping each via the
  server's atomic ``swap_model`` and rolling already-swapped replicas
  back if a later one rejects the artifact;
- **supervised restarts**: the :class:`~paddle_tpu_torch.fleet.
  supervisor.ReplicaSupervisor` polls health and rebuilds dead replicas
  from the ``factory``, replaying every recorded model placement.

Telemetry, with the JAX package's names: ``fleet_replica_state{replica=}``
gauge (0 active / 1 quarantined / 2 deploying / 3 restarting / 4 dead),
``router_routed_total{replica=}`` / ``router_requeued_total``
counters, ``fleet`` journal events for every state transition,
requeue, swap, drain, kill and restart, and the router's ``health()``
registered as a provider of the live telemetry endpoint.

Left out until ROADMAP Queue A item 6: remote replicas
(``remote_backend=``, ``add_replica(backend='remote')`` and the
supervisor's heartbeat probe, which need multihost) and ledger-derived placement
demand (``observability.perf``): without a ``book=`` a
:class:`PlacementBudget` sees an empty ledger book.
"""
import logging
import threading
import time
import zlib

from .. import observability as _obs
from ..serving.errors import (DeadlineExceeded, ModelNotFound,
                              ServerClosed, ServerOverloaded,
                              ServingError, WatchdogTimeout)
from .errors import (NoHealthyReplica, PlacementInfeasible,
                     ReplicaRetired, RequeueExhausted)

__all__ = ['Router', 'RoutedRequest', 'PlacementBudget', 'ACTIVE',
           'QUARANTINED', 'DEPLOYING', 'RESTARTING', 'DEAD',
           'STATE_CODES']

logger = logging.getLogger('paddle_tpu_torch.fleet')

ACTIVE = 'active'
QUARANTINED = 'quarantined'
DEPLOYING = 'deploying'
RESTARTING = 'restarting'
DEAD = 'dead'
STATE_CODES = {ACTIVE: 0, QUARANTINED: 1, DEPLOYING: 2, RESTARTING: 3,
               DEAD: 4}

# replica-infrastructure failures: the replica (not the request) is at
# fault, so the router retries the SAME request elsewhere. Model-level
# errors (bad feed, deadline, model bug) propagate to the client.
REQUEUEABLE = (ServerClosed, WatchdogTimeout)


def _ring_hash(key):
    return zlib.crc32(str(key).encode('utf-8')) & 0xffffffff


class PlacementBudget(object):
    """Ledger-informed per-replica admission budget.

    ``hbm_bytes`` caps the summed live-byte demand (arguments +
    outputs + temps, a program ledger's ``live_bytes``) of the models
    placed on any one replica; ``mfu_capacity`` caps their summed
    measured MFU fractions (roofline headroom). A model's demand comes
    from explicit ``hbm_bytes=`` / ``mfu=`` hints on
    ``load_model``/``register_model``, else from the ledger ``book``
    entries of its declared program ``fingerprints`` (max over shape
    buckets). A model with no hints and no ledgers has zero demand: the
    budget only ever constrains what was measured or declared.

    ``book`` is any mapping-like object whose ``get(fingerprint)``
    returns a ledger (``live_bytes``, ``mfu()``) or None. The JAX
    package defaults to its performance observatory's book; the port
    has no observatory yet (ROADMAP Queue A item 6), so its default
    book is empty and only hints and a ``book=`` passed in count.
    """

    def __init__(self, hbm_bytes=None, mfu_capacity=None, book=None):
        self.hbm_bytes = hbm_bytes
        self.mfu_capacity = mfu_capacity
        self._book = book

    def _ledgers(self):
        return self._book if self._book is not None else {}

    def demand(self, rec):
        """``(hbm_bytes, mfu)`` demand of one placement record.
        ``kv_bytes`` — a paged engine's KV page-pool footprint
        (``PagePool.nbytes``) — rides on top of the model's own hbm
        demand: pool pages are committed for the replica's lifetime,
        not per request, so placement must budget them like weights."""
        hbm, mfu = rec.get('hbm_bytes'), rec.get('mfu')
        if hbm is None or mfu is None:
            book = self._ledgers()
            led_hbm = led_mfu = 0.0
            for fp in rec.get('fingerprints') or ():
                led = book.get(fp)
                if led is None:
                    continue
                led_hbm = max(led_hbm, float(led.live_bytes))
                m = led.mfu()
                if m:
                    led_mfu = max(led_mfu, float(m))
            if hbm is None:
                hbm = led_hbm
            if mfu is None:
                mfu = led_mfu
        return float(hbm or 0.0) + float(rec.get('kv_bytes') or 0.0), \
            float(mfu or 0.0)

    def check(self, name, rec, rid, usage_hbm, usage_mfu):
        """Raise :class:`PlacementInfeasible` (naming the exceeded
        budget) when adding ``name`` to a replica already using
        ``usage_*`` would blow a limit."""
        d_hbm, d_mfu = self.demand(rec)
        if self.hbm_bytes is not None and d_hbm and \
                usage_hbm + d_hbm > self.hbm_bytes:
            raise PlacementInfeasible(
                'placing model %r on replica %s exceeds the hbm_bytes '
                'budget: demand %d + in-use %d > budget %d bytes'
                % (name, rid, d_hbm, usage_hbm, self.hbm_bytes),
                budget='hbm_bytes', replica=rid, model=name,
                demand=d_hbm, limit=self.hbm_bytes, usage=usage_hbm)
        if self.mfu_capacity is not None and d_mfu and \
                usage_mfu + d_mfu > self.mfu_capacity:
            raise PlacementInfeasible(
                'placing model %r on replica %s exceeds the mfu '
                'budget: demand %.4f + in-use %.4f > capacity %.4f'
                % (name, rid, d_mfu, usage_mfu, self.mfu_capacity),
                budget='mfu', replica=rid, model=name, demand=d_mfu,
                limit=self.mfu_capacity, usage=usage_mfu)


class _Replica(object):
    __slots__ = ('id', 'server', 'state', 'generation', 'restarts',
                 'unhealthy_polls', 'role', 'backend')

    def __init__(self, rid, server, backend='inprocess'):
        self.id = rid
        self.server = server
        self.state = ACTIVE
        self.generation = 0
        self.restarts = 0
        self.unhealthy_polls = 0
        # placement role: 'serve' (ModelServer) or 'prefill'
        # (kvcache.PrefillServer): role-tagged placements only ring
        # over replicas whose cells match
        self.role = getattr(server, 'role', 'serve')
        # provisioning backend: 'inprocess' (router factory) or a
        # callable; restart rebuilds through the SAME backend
        self.backend = backend


class RoutedRequest(object):
    """A fleet-level future. ``result()`` waits on the replica-side
    future and transparently requeues onto another replica when the
    one it was routed to fails the request with a replica-infra error
    — bounded by ``router.max_requeues`` and the original deadline, so
    it always resolves (value or typed error), never hangs past its
    timeout, and never surfaces an untyped drop."""

    __slots__ = ('model', 'sticky_key', 'replicas_tried', 'requeues',
                 '_router', '_feeds', '_deadline_abs', '_req', '_span')

    def __init__(self, router, model, feeds, deadline_abs, req,
                 replica_id, sticky_key=None, span=None):
        self._router = router
        self.model = model
        self._feeds = feeds
        self._deadline_abs = deadline_abs
        self._req = req
        self.replicas_tried = [replica_id]
        self.requeues = 0
        self.sticky_key = sticky_key
        self._span = span   # fleet/request root span, ended by result()

    @property
    def replica_id(self):
        return self.replicas_tried[-1]

    def done(self):
        return self._req.done()

    def result(self, timeout=30.0):
        end = None if timeout is None else time.monotonic() + timeout
        while True:
            remaining = None if end is None \
                else max(0.0, end - time.monotonic())
            try:
                value = self._req.result(timeout=remaining)
            except REQUEUEABLE as e:
                self._router._note_replica_error(self.replica_id, e)
                if self.requeues >= self._router.max_requeues:
                    self._end_span(error='RequeueExhausted')
                    raise RequeueExhausted(
                        'request for model %r failed on %d replica(s) '
                        '(%s requeues exhausted): %r'
                        % (self.model, len(self.replicas_tried),
                           self.requeues, e), last_error=e)
                try:
                    self._requeue(e, end)
                except Exception as e2:
                    self._end_span(error=type(e2).__name__)
                    raise
            except Exception as e:
                self._end_span(error=type(e).__name__)
                raise
            else:
                self._end_span(ok=True)
                return value

    def _end_span(self, **fields):
        if self._span is not None:
            self._span.end(requeues=self.requeues,
                           replicas_tried=len(self.replicas_tried),
                           **fields)

    def _remaining_deadline(self):
        if self._deadline_abs is None:
            return None
        left = self._deadline_abs - time.monotonic()
        if left <= 0:
            raise DeadlineExceeded(
                'deadline passed while requeueing after a replica '
                'failure')
        return left

    def _requeue(self, cause, end):
        router = self._router
        router._m_requeued.inc()
        _obs.emit('fleet', action='requeue', model=self.model,
                  replica=self.replica_id)
        # the requeue hop is its own child span of the fleet/request
        # root: the failed-over attempt's serving/request span parents
        # under it, so the hop's cost is attributed in the tree
        rq = None
        if self._span is not None:
            rq = _obs.start_span('fleet/requeue', parent=self._span,
                                 activate=False, model=self.model,
                                 from_replica=self.replica_id,
                                 cause=type(cause).__name__)
        give_up = time.monotonic() + router.requeue_wait
        if end is not None:
            give_up = min(give_up, end)
        last = cause
        try:
            while True:
                try:
                    req, rid = router._submit_once(
                        self.model, self._feeds,
                        self._remaining_deadline(),
                        self.sticky_key, excluded={self.replica_id},
                        trace=rq.context if rq is not None else None)
                except (NoHealthyReplica, ServerOverloaded) as e:
                    last = e
                    if time.monotonic() >= give_up:
                        raise RequeueExhausted(
                            'no replica accepted the requeued request '
                            'for model %r: %r' % (self.model, last),
                            last_error=cause)
                    time.sleep(min(0.02, router.poll_interval))
                else:
                    self.requeues += 1
                    self.replicas_tried.append(rid)
                    self._req = req
                    if rq is not None:
                        rq.end(to_replica=rid)
                    return
        except Exception as e:
            if rq is not None:
                rq.end(error=type(e).__name__)
            raise


class Router(object):
    """Front-end over N ModelServer replicas.

    Parameters
    ----------
    factory : callable
        ``factory(replica_id) -> ModelServer``; also used by the
        supervisor to rebuild dead replicas.
    replicas : int
        Fleet size.
    replication : int, optional
        Replicas each model is placed on (default: all). Placement is
        a deterministic ring keyed by the model name — sticky across
        restarts and across processes.
    supervise : bool
        Start a :class:`ReplicaSupervisor` (health polling, restarts).
    poll_interval : float
        Supervisor scan cadence (seconds).
    max_requeues : int, optional
        Per-request cap on replica failovers (default:
        ``2 * replicas``).
    wedge_restart_after : int
        Consecutive unhealthy supervisor polls before a quarantined
        replica is force-restarted instead of waiting it out.
    placement_budget : PlacementBudget, optional
        Admission gate: model loads that would push a replica past its
        device-memory or MFU budget raise a typed
        :class:`~paddle_tpu_torch.fleet.errors.PlacementInfeasible`
        instead of running out of memory at serve time.
    remote_backend : None
        Remote replicas wait for multihost (ROADMAP Queue A item 6):
        anything but None raises NotImplementedError.
    """

    def __init__(self, factory, replicas=2, replication=None,
                 supervise=True, poll_interval=0.2, max_requeues=None,
                 requeue_wait=5.0, warmup_on_load=True,
                 wedge_restart_after=20, placement_budget=None,
                 remote_backend=None):
        if replicas < 1:
            raise ValueError('replicas must be >= 1')
        if replication is not None and \
                not 1 <= replication <= replicas:
            raise ValueError('replication must be in [1, replicas]')
        if remote_backend is not None:
            raise NotImplementedError(
                'Router(remote_backend=...): remote replicas are not '
                'ported yet (ROADMAP Queue A item 6, multihost)')
        self.factory = factory
        self.replication = replication
        self.poll_interval = poll_interval
        self.max_requeues = max_requeues if max_requeues is not None \
            else 2 * replicas
        self.requeue_wait = requeue_wait
        self.warmup_on_load = warmup_on_load
        self.wedge_restart_after = wedge_restart_after
        self.placement_budget = placement_budget
        self._lock = threading.RLock()
        self._placements = {}        # model -> placement record
        self._next_rid = replicas    # ids are never reused (scale-out)
        self._retired = set()        # ids retired by scale-in
        self._closed = False
        reg = _obs.default_registry()
        self._m_requeued = reg.counter(
            'router_requeued_total',
            'requests requeued onto another replica after a replica '
            'failure')
        self._m_routed = {}
        self._replicas = {}
        for rid in range(replicas):
            self._replicas[rid] = _Replica(rid, factory(rid))
            self._publish_state(rid, ACTIVE)
        _obs.emit('fleet', action='create', replicas=replicas)
        # live telemetry: /health carries the fleet-wide readiness doc
        _obs.telemetry.register_health_provider(
            'router-%x' % id(self), self)
        self.supervisor = None
        if supervise:
            from .supervisor import ReplicaSupervisor
            self.supervisor = ReplicaSupervisor(
                self, poll_interval=poll_interval)
            self.supervisor.start()

    # ---- state bookkeeping -----------------------------------------------
    def _publish_state(self, rid, state):
        _obs.default_registry().gauge(
            'fleet_replica_state',
            'replica routing state: 0 active / 1 quarantined / '
            '2 deploying / 3 restarting / 4 dead',
            replica=str(rid)).set(STATE_CODES[state])

    def _set_state(self, rep, state, reason=''):
        with self._lock:
            prev, rep.state = rep.state, state
        if prev != state:
            self._publish_state(rep.id, state)
            _obs.emit('fleet', action=state, replica=rep.id,
                      reason=reason)
            logger.info('replica %d: %s -> %s (%s)', rep.id, prev,
                        state, reason)

    def _routed_counter(self, rid):
        c = self._m_routed.get(rid)
        if c is None:
            c = _obs.default_registry().counter(
                'router_routed_total',
                'requests routed to a replica', replica=str(rid))
            self._m_routed[rid] = c
        return c

    # ---- placement -------------------------------------------------------
    def _place_ids(self, name, ids=None, role=None):
        """Deterministic ring placement: ``replication`` consecutive
        replica ids starting at hash(name) — the same model name lands
        on the same replicas every time (sticky placement) for a given
        replica set; scale-out/scale-in re-derives the ring over the
        new set (:meth:`_rebalance`). ``ids`` overrides the live set
        for what-if simulation (:meth:`can_retire`). ``role`` narrows
        the ring to replicas whose cell carries that role — how
        prefill placements land only on prefill replicas."""
        if ids is None:
            ids = sorted(self._replicas)
        if role is not None:
            ids = [rid for rid in ids
                   if rid in self._replicas
                   and self._replicas[rid].role == role]
        if not ids:
            return []
        k = min(self.replication or len(ids), len(ids))
        start = _ring_hash(name) % len(ids)
        return [ids[(start + i) % len(ids)] for i in range(k)]

    def _check_admission(self, name, rec, rids, assignment=None):
        """Budget gate (under the router lock): raise typed
        :class:`PlacementInfeasible` when placing ``name`` on any of
        ``rids`` would exceed the per-replica budget given the other
        models' demands. ``assignment`` (model -> ids) overrides the
        live placements for what-if simulation."""
        budget = self.placement_budget
        if budget is None:
            return
        if assignment is None:
            assignment = {n: r['ids'] for n, r in
                          self._placements.items()}
        for rid in rids:
            usage_hbm = usage_mfu = 0.0
            for other, orec in self._placements.items():
                if other == name or rid not in assignment.get(other, ()):
                    continue
                oh, om = budget.demand(orec)
                usage_hbm += oh
                usage_mfu += om
            budget.check(name, rec, rid, usage_hbm, usage_mfu)

    def load_model(self, name, dirname, model_filename=None,
                   params_filename=None, warmup=None, hbm_bytes=None,
                   mfu=None, fingerprints=(), kv_bytes=None):
        """Place + load a ``save_inference_model`` artifact on the
        model's replica ring. Dead/restarting replicas are skipped —
        the restart replay loads the recorded artifact into them.
        ``hbm_bytes``/``mfu`` declare the model's resource demand for
        the placement budget; ``fingerprints`` instead derives it from
        the budget's ledger book for those programs;
        ``kv_bytes`` adds a paged engine's page-pool footprint on top
        (committed for the replica's lifetime, budgeted like
        weights)."""
        rec = {'kind': 'artifact', 'dirname': dirname,
               'model_filename': model_filename,
               'params_filename': params_filename,
               'warmup': self.warmup_on_load if warmup is None
               else warmup, 'hbm_bytes': hbm_bytes, 'mfu': mfu,
               'fingerprints': tuple(fingerprints),
               'kv_bytes': kv_bytes}
        return self._place(name, rec)

    def register_model(self, name, builder, warmup=None,
                       hbm_bytes=None, mfu=None, fingerprints=(),
                       kv_bytes=None):
        """Place an in-memory model: ``builder()`` must return a fresh
        ``(program, feed_names, fetch_vars, scope)`` tuple per call —
        each replica (and each restart) gets its own scope, because
        server workers donate their scope's buffers."""
        rec = {'kind': 'builder', 'builder': builder,
               'warmup': self.warmup_on_load if warmup is None
               else warmup, 'hbm_bytes': hbm_bytes, 'mfu': mfu,
               'fingerprints': tuple(fingerprints),
               'kv_bytes': kv_bytes}
        return self._place(name, rec)

    def register_prefill(self, name, spec, warmup=None, hbm_bytes=None,
                         mfu=None, kv_bytes=None):
        """Place a prompt-ingestion model on the fleet's
        ``role='prefill'`` replicas. ``spec`` is the declarative cell
        dict (:func:`paddle_tpu_torch.kvcache.stock_spec`): plain data,
        so the placement record replays onto restarted replicas
        unchanged. Routing,
        requeue-on-failure, budget admission and the restart replay
        all work exactly as for serve placements; only the ring is
        narrowed to prefill replicas."""
        rec = {'kind': 'prefill', 'spec': dict(spec),
               'role': 'prefill',
               'warmup': self.warmup_on_load if warmup is None
               else warmup, 'hbm_bytes': hbm_bytes, 'mfu': mfu,
               'fingerprints': (), 'kv_bytes': kv_bytes}
        return self._place(name, rec)

    def _place(self, name, rec):
        """Shared placement commit: ring + budget check under the
        lock, then the (slow) model loads outside it."""
        with self._lock:
            if self._closed:
                raise ServerClosed('router is shut down')
            ids = self._place_ids(name, role=rec.get('role'))
            if not ids:
                raise NoHealthyReplica(
                    'model %r needs a replica with role %r — the '
                    'fleet has none' % (name, rec.get('role')))
            # budget admission BEFORE committing the record: an
            # infeasible model must leave no trace (typed error, no
            # partial placement, no OOM at serve time)
            try:
                self._check_admission(name, rec, ids)
            except PlacementInfeasible as e:
                _obs.emit('fleet', action='placement_infeasible',
                          model=name, budget=e.budget,
                          replica=e.replica, demand=e.demand,
                          limit=e.limit, usage=e.usage)
                raise
            rec['ids'] = ids
            self._placements[name] = rec
            reps = [self._replicas[rid] for rid in ids]
        for rep in reps:
            if rep.state in (DEAD, RESTARTING):
                continue
            self._load_into(rep.server, name, rec)
        _obs.emit('fleet', action='load', model=name, replicas=ids)
        return ids

    def _load_into(self, server, name, rec):
        if rec['kind'] == 'artifact':
            server.load_model(name, rec['dirname'],
                              model_filename=rec['model_filename'],
                              params_filename=rec['params_filename'])
        elif rec['kind'] == 'prefill':
            server.register_prefill(name, rec['spec'])
        else:
            program, feed_names, fetch_vars, scope = rec['builder']()
            server.register_model(name, program, feed_names,
                                  fetch_vars, scope)
        if rec['warmup']:
            server.warmup(name)

    def models(self):
        with self._lock:
            return sorted(self._placements)

    def placement(self, name):
        with self._lock:
            rec = self._placements.get(name)
            if rec is None:
                raise ModelNotFound('no model placed as %r (have: %s)'
                                    % (name, sorted(self._placements)
                                       or '-'))
            return list(rec['ids'])

    def replica(self, rid):
        with self._lock:
            return self._replicas[rid]

    # ---- routing ---------------------------------------------------------
    def _candidates(self, name, excluded=()):
        """(load_score, replica) pairs for the model's routable
        replicas, cheapest first. Scores come from the server's
        one-lock :meth:`load_score` snapshot; ``inf`` (open breaker,
        wedged, closed) is dropped here so the router can never pick
        an unroutable replica even before the supervisor quarantines
        it."""
        with self._lock:
            rec = self._placements.get(name)
            if rec is None:
                raise ModelNotFound('no model placed as %r (have: %s)'
                                    % (name, sorted(self._placements)
                                       or '-'))
            reps = [rep for rep in
                    (self._replicas.get(rid) for rid in rec['ids']
                     if rid not in excluded)
                    if rep is not None and rep.state == ACTIVE]
        scored = []
        for rep in reps:
            try:
                score = rep.server.load_score(name)
            except Exception:  # noqa: BLE001 — scoring must not throw
                continue
            if score != float('inf'):
                scored.append((score, rep.id, rep))
        scored.sort(key=lambda t: (t[0], t[1]))
        return [(s, rep) for s, _, rep in scored]

    def _submit_once(self, name, feeds, deadline, sticky_key,
                     excluded=(), trace=None):
        """One routing decision + submit. Tries candidates cheapest
        first (sticky preference up front), stepping past replicas
        that refuse admission. Raises typed: the last ServerOverloaded
        when every candidate is merely full, NoHealthyReplica when
        there was nothing to try. ``trace`` parents the replica-side
        ``serving/request`` span."""
        cands = self._candidates(name, excluded=excluded)
        if sticky_key is not None and len(cands) > 1:
            with self._lock:
                ids = self._placements[name]['ids']
            preferred = ids[_ring_hash(sticky_key) % len(ids)]
            cands.sort(key=lambda t: (t[1].id != preferred,))
        overloaded = None
        for _score, rep in cands:
            try:
                req = rep.server.submit(name, feeds, deadline=deadline,
                                        trace=trace)
            except ServerOverloaded as e:
                overloaded = e
                continue
            except ServingError as e:
                # replica-level refusal (closed/draining/breaker):
                # note it and keep trying the next candidate
                self._note_replica_error(rep.id, e)
                continue
            self._routed_counter(rep.id).inc()
            return req, rep.id
        if overloaded is not None:
            raise overloaded
        raise NoHealthyReplica(
            'model %r: no routable replica (placed on %s)'
            % (name, self.placement(name)))

    def submit(self, name, feeds, deadline=None, sticky_key=None,
               trace=None):
        """Route one request; returns a :class:`RoutedRequest`.
        ``deadline`` is relative seconds covering the whole fleet-side
        lifetime (requeues included). ``sticky_key`` biases routing to
        a stable replica for that key (cache affinity) without
        sacrificing failover. ``trace`` parents the fleet-side span
        under a caller-held one (a DisaggregatedDecoder keeps the
        prefill hop and the decode leg in one tree this way)."""
        with self._lock:
            if self._closed:
                raise ServerClosed('router is shut down')
        deadline_abs = None if deadline is None \
            else time.monotonic() + deadline
        # the whole fleet-side lifetime (attempts + requeue hops) is
        # ONE root span; every replica attempt parents under it
        span = _obs.start_span('fleet/request', activate=False,
                               parent=trace, model=name)
        if span.context is None:
            span = None
        try:
            req, rid = self._submit_once(
                name, feeds, deadline, sticky_key,
                trace=span.context if span is not None else None)
        except Exception as e:
            if span is not None:
                span.end(error=type(e).__name__)
            raise
        return RoutedRequest(self, name, feeds, deadline_abs, req, rid,
                             sticky_key=sticky_key, span=span)

    def infer(self, name, feeds, deadline=None, sticky_key=None,
              timeout=30.0):
        """Synchronous convenience: submit + wait (+ requeue)."""
        return self.submit(name, feeds, deadline=deadline,
                           sticky_key=sticky_key).result(timeout=timeout)

    # ---- failure handling ------------------------------------------------
    def _note_replica_error(self, rid, error):
        """A client or the router observed a replica-level error:
        re-evaluate that replica's health NOW instead of waiting for
        the next supervisor poll."""
        with self._lock:
            rep = self._replicas.get(rid)
            if rep is None or rep.state in (DEAD, RESTARTING,
                                            DEPLOYING):
                return
        self.check_replica(rep)

    def check_replica(self, rep):
        """One health evaluation pass (also the supervisor's): marks
        the replica DEAD (closed server / dead worker), QUARANTINED
        (open breaker / wedged worker) or restores it to ACTIVE."""
        try:
            health = rep.server.health()
        except Exception as e:  # noqa: BLE001 — a throwing health()
            # check means the replica is gone for routing purposes
            self._set_state(rep, DEAD, reason='health() raised %r' % e)
            return DEAD
        if health['status'] == 'closed':
            self._set_state(rep, DEAD, reason='server closed')
            return DEAD
        models = health['models']
        if any(not m['worker_alive'] for m in models.values()
               if m['state'] != 'draining'):
            self._set_state(rep, DEAD, reason='worker thread dead')
            return DEAD
        unhealthy = [n for n, m in models.items()
                     if m['state'] == 'open' or m['wedged']]
        with self._lock:
            state = rep.state
        if unhealthy:
            rep.unhealthy_polls += 1
            if rep.unhealthy_polls >= self.wedge_restart_after and \
                    any(models[n]['wedged'] for n in unhealthy):
                self._set_state(
                    rep, DEAD,
                    reason='wedged for %d polls, forcing restart'
                    % rep.unhealthy_polls)
                return DEAD
            if state == ACTIVE:
                self._set_state(rep, QUARANTINED,
                                reason='unhealthy models: %s'
                                % sorted(unhealthy))
            return QUARANTINED
        rep.unhealthy_polls = 0
        if state == QUARANTINED:
            self._set_state(rep, ACTIVE, reason='healthy again')
        return ACTIVE

    def restart_replica(self, rid):
        """Rebuild a dead replica from the factory and replay every
        model placed on it (the supervisor's repair path; also a
        manual ops hook). The old server is closed with a short bound
        first so a wedged worker cannot hold the restart hostage."""
        with self._lock:
            if self._closed:
                raise ServerClosed('router is shut down')
            rep = self._replicas.get(rid)
            if rep is None:
                # single ownership handoff: a replica the autoscaler
                # retired no longer exists — the supervisor must drop
                # it, never resurrect it
                raise ReplicaRetired(
                    'replica %d was retired%s — refusing restart'
                    % (rid, '' if rid in self._retired
                       else ' or never existed'))
            if rep.state == RESTARTING:
                return rep
            old_server = rep.server
            placements = {name: dict(rec)
                          for name, rec in self._placements.items()
                          if rid in rec['ids']}
        self._set_state(rep, RESTARTING)
        t0 = time.monotonic()
        try:
            try:
                old_server.close(timeout=1.0)
            except Exception:  # noqa: BLE001 — already-broken server
                pass
            # rebuild through the SAME backend that provisioned the
            # replica
            server = self._build_server(rid, rep.backend)
            for name, rec in sorted(placements.items()):
                self._load_into(server, name, rec)
            with self._lock:
                rep.server = server
                rep.role = getattr(server, 'role', 'serve')
                rep.generation += 1
                rep.restarts += 1
            self._set_state(rep, ACTIVE, reason='restarted')
            _obs.emit('fleet', action='restart', replica=rid,
                      models=sorted(placements),
                      backend=rep.backend if
                      isinstance(rep.backend, str)
                      else getattr(rep.backend, '__name__', 'custom'),
                      dur_s=round(time.monotonic() - t0, 6))
            return rep
        except Exception as e:
            self._set_state(rep, DEAD, reason='restart failed: %r' % e)
            raise

    def kill_replica(self, rid, abrupt=True):
        """Ops/chaos hook: take a replica down. ``abrupt=True`` models
        a crash — in-flight and queued futures fail typed
        (ServerClosed) and clients requeue; the supervisor restarts
        it."""
        with self._lock:
            rep = self._replicas.get(rid)
            if rep is None:
                raise ReplicaRetired(
                    'replica %d was retired — nothing to kill' % rid)
        _obs.emit('fleet', action='kill', replica=rid, abrupt=abrupt)
        # freeze the postmortem BEFORE closing: the bundle must carry
        # the dying replica's still-open spans and queue state, which
        # the ServerClosed storm below is about to clear
        _obs.flight.trip('replica_kill', replica=rid, abrupt=abrupt)
        try:
            rep.server.close(timeout=0.0 if abrupt else 30.0)
        finally:
            self._set_state(rep, DEAD, reason='killed')
        return rep

    # ---- elastic fleet (autoscaler actuators) ----------------------------
    def _build_server(self, rid, backend):
        """Provision a replica cell through the named backend:
        ``None``/``'inprocess'`` is the router factory, a callable is
        used directly (tests). ``'remote'`` raises until ROADMAP Queue
        A item 6 (multihost)."""
        if backend in (None, 'inprocess'):
            return self.factory(rid)
        if backend == 'remote':
            raise NotImplementedError(
                "add_replica(backend='remote'): remote replicas are not "
                'ported yet (ROADMAP Queue A item 6, multihost)')
        if callable(backend):
            return backend(rid)
        raise ValueError('unknown replica backend %r' % (backend,))

    def add_replica(self, backend=None):
        """Scale-out: build a fresh replica (a never reused id),
        rebalance every placement ring over the grown fleet and replay
        model loads (and their warm-up) onto the newcomer. ``backend``
        is None (the factory) or a callable; ``'remote'`` raises until
        ROADMAP Queue A item 6. Returns the new replica id."""
        with self._lock:
            if self._closed:
                raise ServerClosed('router is shut down')
            rid = self._next_rid
            self._next_rid += 1
        t0 = time.monotonic()
        server = self._build_server(rid, backend)  # slow: no lock held
        # normalize: None means the factory; a callable is kept as-is
        # so restart_replica can rebuild through it
        stored = 'inprocess' if backend in (None, 'inprocess') \
            else backend
        kind = stored if isinstance(stored, str) \
            else getattr(stored, '__name__', 'custom')
        with self._lock:
            self._replicas[rid] = _Replica(rid, server, backend=stored)
        self._publish_state(rid, ACTIVE)
        self._rebalance(reason='scale-out replica %d' % rid)
        dur_s = round(time.monotonic() - t0, 6)
        _obs.emit('fleet', action='scale_up', replica=rid,
                  replicas=sorted(self._replicas), backend=kind,
                  dur_s=dur_s)
        return rid

    def retire_replica(self, rid, timeout=5.0):
        """Scale-in: permanently remove a replica — the single
        ownership handoff. Under one lock hold the id leaves the
        routing set, every placement ring and the supervisor's world;
        then the survivors' rings rebalance (model loads replayed so
        no sticky key strands on the retired id) and the old server
        closes with a bounded drain — its in-flight requests fail
        typed (ServerClosed) and requeue onto survivors. Per-replica
        telemetry series are retired so dashboards agree with
        ``health()``. Raises :class:`ReplicaRetired` for an id that
        is already gone."""
        with self._lock:
            if self._closed:
                raise ServerClosed('router is shut down')
            rep = self._replicas.get(rid)
            if rep is None:
                raise ReplicaRetired(
                    'replica %d is already retired' % rid)
            floor = max(1, self.replication or 1)
            if len(self._replicas) <= floor:
                raise ValueError(
                    'cannot retire replica %d: %d replica(s) is the '
                    'floor for replication=%s'
                    % (rid, floor, self.replication))
            del self._replicas[rid]
            self._retired.add(rid)
            # strip the id from every ring NOW (same lock hold):
            # routing between this point and the rebalance below must
            # never resolve to the retired replica
            for rec in self._placements.values():
                if rid in rec['ids']:
                    rec['ids'] = [i for i in rec['ids'] if i != rid]
        _obs.emit('fleet', action='retire', replica=rid,
                  replicas=sorted(self._replicas))
        self._rebalance(reason='scale-in replica %d' % rid)
        try:
            rep.server.close(timeout=timeout)
        except Exception:  # noqa: BLE001 — survivors keep serving
            logger.exception('closing retired replica %d failed', rid)
        reg = _obs.default_registry()
        reg.remove('fleet_replica_state', replica=str(rid))
        reg.remove('router_routed_total', replica=str(rid))
        with self._lock:
            self._m_routed.pop(rid, None)
        return rid

    def can_retire(self, rid):
        """``(ok, reason)``: would retiring ``rid`` keep every
        placement routable and inside the placement budget on the
        survivors? The autoscaler asks before every scale-in so a
        fleet that cannot absorb its models never shrinks into an
        infeasible state."""
        with self._lock:
            if rid not in self._replicas:
                return False, 'replica %d already retired' % rid
            floor = max(1, self.replication or 1)
            if len(self._replicas) <= floor:
                return False, ('%d replica(s) is the floor for '
                               'replication=%s'
                               % (floor, self.replication))
            survivors = sorted(i for i in self._replicas if i != rid)
            # role routability: a role-tagged placement must keep at
            # least one replica of its role among the survivors
            for name, rec in self._placements.items():
                role = rec.get('role')
                if role is not None and not self._place_ids(
                        name, ids=survivors, role=role):
                    return False, (
                        'model %r needs a replica with role %r and '
                        '%d is the last one' % (name, role, rid))
            if self.placement_budget is not None:
                sim = {n: self._place_ids(
                    n, ids=survivors,
                    role=self._placements[n].get('role'))
                       for n in self._placements}
                for name, rec in self._placements.items():
                    added = [i for i in sim[name]
                             if i not in rec['ids']]
                    try:
                        self._check_admission(name, rec, added,
                                              assignment=sim)
                    except PlacementInfeasible as e:
                        return False, str(e)
        return True, ''

    def _rebalance(self, reason=''):
        """Recompute every placement ring over the current replica set
        and converge the servers: newly ringed replicas get the model
        loaded (replayed + warmed), replicas leaving a ring drain it.
        A placement the budget refuses on its new ring keeps its
        surviving old replicas instead (journalled) — rebalance
        degrades, it never OOMs. Sticky keys hash over the ring, so
        they re-spread onto live replicas automatically."""
        plan = []
        with self._lock:
            if not self._replicas:
                return
            for name, rec in sorted(self._placements.items()):
                old_ids = list(rec['ids'])
                new_ids = self._place_ids(name, role=rec.get('role'))
                if not new_ids:
                    continue   # no replica of this role left: keep
                    # the old ring; routing fails typed meanwhile
                if new_ids == old_ids:
                    continue
                added = [i for i in new_ids if i not in old_ids]
                try:
                    self._check_admission(name, rec, added)
                except PlacementInfeasible as e:
                    _obs.emit('fleet', action='placement_infeasible',
                              model=name, budget=e.budget,
                              replica=e.replica, during='rebalance')
                    logger.warning('rebalance: %s', e)
                    continue
                rec['ids'] = new_ids
                removed = [i for i in old_ids if i not in new_ids]
                plan.append((name, dict(rec), added, removed))
        for name, rec, added, removed in plan:
            for rid in added:
                with self._lock:
                    rep = self._replicas.get(rid)
                if rep is None or rep.state in (DEAD, RESTARTING):
                    continue   # the restart replay uses the record
                try:
                    self._load_into(rep.server, name, rec)
                except Exception as e:  # noqa: BLE001 — a replica that
                    # cannot take the load is a replica-health problem,
                    # not a rebalance-stopping one
                    logger.exception(
                        'rebalance: loading %r onto replica %d failed',
                        name, rid)
                    self._note_replica_error(rid, e)
            for rid in removed:
                with self._lock:
                    rep = self._replicas.get(rid)
                if rep is None or rep.state in (DEAD, RESTARTING):
                    continue
                try:
                    rep.server.drain(name, timeout=self.requeue_wait)
                except ModelNotFound:
                    pass
                except Exception:  # noqa: BLE001 — best-effort unload
                    logger.exception(
                        'rebalance: draining %r off replica %d failed',
                        name, rid)
            _obs.emit('fleet', action='rebalance', model=name,
                      replicas=rec['ids'], added=added,
                      removed=removed, reason=reason)

    # ---- fleet-wide ops --------------------------------------------------
    def rolling_swap(self, name, dirname, model_filename=None,
                     params_filename=None, warmup=None):
        """Zero-downtime deploy: swap the model's replicas one at a
        time — each replica is pulled from routing only for its own
        swap while the rest keep serving, and the server-side
        ``swap_model`` keeps even that replica's queue intact. A
        rejected artifact (validation failure) rolls already-swapped
        replicas back to the previous artifact so the fleet converges
        on ONE version either way. The placement record is updated
        first, so a replica restarting mid-deploy comes back on the
        new artifact."""
        with self._lock:
            rec = self._placements.get(name)
            if rec is None:
                raise ModelNotFound('no model placed as %r' % name)
            if rec['kind'] != 'artifact':
                raise ValueError(
                    'rolling_swap needs a disk artifact; model %r was '
                    'registered in-memory' % name)
            old = dict(rec)
            rec.update(dirname=dirname, model_filename=model_filename,
                       params_filename=params_filename)
            ids = list(rec['ids'])
            do_warmup = rec['warmup'] if warmup is None else warmup
        swapped = []
        for rid in ids:
            with self._lock:
                rep = self._replicas[rid]
                prev_state = rep.state
            if prev_state in (DEAD, RESTARTING):
                continue      # restart replay already uses the record
            self._set_state(rep, DEPLOYING, reason='rolling swap')
            t0 = time.monotonic()
            try:
                rep.server.swap_model(
                    name, dirname, model_filename=model_filename,
                    params_filename=params_filename)
                if do_warmup:
                    rep.server.warmup(name)
            except Exception:
                self._set_state(rep, prev_state,
                                reason='swap failed, rolled back')
                with self._lock:
                    self._placements[name] = old
                for back in swapped:
                    try:
                        self._replicas[back].server.swap_model(
                            name, old['dirname'],
                            model_filename=old['model_filename'],
                            params_filename=old['params_filename'])
                    except Exception:  # noqa: BLE001 — best effort;
                        logger.exception(
                            'rollback of replica %d failed', back)
                raise
            self._set_state(rep, prev_state, reason='swap complete')
            swapped.append(rid)
            _obs.emit('fleet', action='swap', model=name, replica=rid,
                      dirname=dirname,
                      dur_s=round(time.monotonic() - t0, 6))
        return swapped

    def drain(self, name, timeout=None):
        """Rolling fleet-wide drain: complete each replica's queue for
        the model, unload it everywhere, forget the placement."""
        ids = self.placement(name)
        for rid in ids:
            with self._lock:
                rep = self._replicas[rid]
            if rep.state in (DEAD, RESTARTING):
                continue
            try:
                rep.server.drain(name, timeout=timeout)
            except ModelNotFound:
                pass
            _obs.emit('fleet', action='drain', model=name, replica=rid)
        with self._lock:
            self._placements.pop(name, None)
        return ids

    # ---- introspection ---------------------------------------------------
    def health(self):
        """Fleet-wide readiness: router status, per-replica state +
        the replica's own ``health()`` document, model placements."""
        with self._lock:
            closed = self._closed
            reps = dict(self._replicas)
            placements = {name: list(rec['ids'])
                          for name, rec in self._placements.items()}
        replicas = {}
        for rid, rep in sorted(reps.items()):
            entry = {'state': rep.state, 'generation': rep.generation,
                     'restarts': rep.restarts}
            if rep.state not in (DEAD, RESTARTING):
                try:
                    entry['server'] = rep.server.health()
                except Exception as e:  # noqa: BLE001 — report, not die
                    entry['server_error'] = repr(e)
            replicas[rid] = entry
        active = sum(1 for r in replicas.values()
                     if r['state'] == ACTIVE)
        return {'status': 'closed' if closed else
                ('serving' if active else 'unavailable'),
                'active_replicas': active,
                'replicas': replicas,
                'placements': placements}

    def stats(self):
        with self._lock:
            return {
                'replicas': {rid: {'state': rep.state,
                                   'generation': rep.generation,
                                   'restarts': rep.restarts}
                             for rid, rep in self._replicas.items()},
                'models': sorted(self._placements),
            }

    def close(self, timeout=30.0):
        with self._lock:
            if self._closed:
                return
            self._closed = True
            reps = list(self._replicas.values())
        _obs.telemetry.unregister_health_provider('router-%x' % id(self))
        if self.supervisor is not None:
            self.supervisor.stop()
        for rep in reps:
            try:
                rep.server.close(timeout=timeout)
            except Exception:  # noqa: BLE001 — close everything
                logger.exception('closing replica %d failed', rep.id)
        _obs.emit('fleet', action='close')

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False
