"""ModelServer: the batched, shape-bucketed inference serving runtime.

Counterpart of paddle_tpu/serving/server.py. Request path::

    client thread --submit()--> per-model MicroBatcher (bounded queue)
        --worker thread--> coalesce compatible requests
        --> pad to power-of-two bucket (BucketPolicy)
        --> shared Executor.run (one memo, locked)
        --> strip pad rows, split per request, set results

Design points:

- One worker thread per model serializes that model's scope, while
  different models run concurrently on the shared Executor and card.
- Admission control sheds load at the door: ``max_queue_depth`` bounds
  memory and tail latency, per-request deadlines bound time-in-queue,
  and both failure modes surface as typed errors.
- ``warmup()`` pushes one synthetic request per shape bucket through
  the *public* path before traffic, each completed before the next is
  submitted, so the first real user pays no lowering and no first-shape
  cost. It preloads the on-disk tuning cache first; with
  ``autotune=True`` it also searches each bucket that has no entry,
  before that bucket's request.
- Transient run failures (``retry_on``, default OSError) are absorbed by
  :func:`resilience.retry_call` with exponential backoff, capped by the
  batch's earliest request deadline.

SLO guardrails:

- A per-model :class:`~paddle_tpu_torch.serving.breaker.CircuitBreaker`
  wraps the batch run: a model whose every batch errors stops burning
  retries in the hot loop; new requests shed with typed
  :class:`CircuitOpen` at admission until half-open probes prove the
  model healthy again.
- A :class:`~paddle_tpu_torch.serving.watchdog.Watchdog` thread bounds
  every stage (pad, batch run) with a deadline: a wedged
  ``Executor.run`` gets its futures failed (:class:`WatchdogTimeout`),
  its breaker opened, and its worker marked wedged instead of hanging
  clients.
- ``health()`` reports per-model ready/degraded/open/draining state;
  ``drain()`` completes queued work then unloads; ``swap_model()`` flips
  a replacement in atomically without dropping the queue;
  ``close(timeout=)`` escalates graceful drain -> fail-pending ->
  abandon-worker so shutdown is bounded even against a wedged worker.
- The worker loop carries deterministic fault-injection sites
  (``serving/run_batch``, ``serving/load_model``, ``serving/pad``).

Telemetry, with the JAX package's names: the serving stats' registry
series and journal events (``serving.stats``), the ``serving_warmup``,
``serving_drain``, ``serving_swap`` and ``serving_abandoned_worker``
events, the trace spans ``serving/request`` (submit to result),
``serving/queue``, ``serving/batch`` (linked to every request it
serves), ``serving/pad``, ``serving/run``, ``serving/exact_run`` and
``serving/retry``, a flight-recorder trip when a breaker opens or the
watchdog trips, and a journal flush on ``close()``. Each server
registers itself as a health provider of the live telemetry endpoint
(``observability.telemetry``) from construction until ``close()``, so
``/health`` and a postmortem bundle carry its ``health()`` document.

Left out of the reference: the profiler's serving spans and the
partitioner (a sharded server, ROADMAP Queue A item 6).
"""
import logging
import threading
import time

import numpy as np

from .. import observability as _obs
from ..compiler import tuning as _tuning
from ..core import places as _places
from ..executor import Executor, Scope
from ..io import load_inference_model as _load_inference_model
from ..lod import SequenceTensor
from ..resilience import retry_call
from ..resilience import faultinject as _fi
from .batcher import (InferenceRequest, MicroBatcher, merge_requests,
                      split_fetches)
from .breaker import CLOSED, HALF_OPEN, OPEN, CircuitBreaker
from .bucketing import BucketPolicy, pad_feed
from .errors import (CircuitOpen, DeadlineExceeded, ServerClosed,
                     ServingError, WatchdogTimeout)
from .registry import LoadedModel, ModelRegistry
from .stats import ServingStats
from .watchdog import Watchdog

__all__ = ['ModelServer', 'DEFAULT_STAGE_TIMEOUTS']

logger = logging.getLogger('paddle_tpu_torch.serving')

# per-stage watchdog deadlines (seconds); keys double as the
# fault-injection site names. The run stage covers retries, so its
# budget bounds the whole retry storm, not one attempt.
DEFAULT_STAGE_TIMEOUTS = {
    _fi.SITE_SERVING_PAD: 10.0,
    _fi.SITE_SERVING_RUN: 120.0,
}


class ModelServer(object):
    """Serve N models from one process with dynamic micro-batching.

    Parameters
    ----------
    place : CUDAPlace/CPUPlace, optional
        Device the shared Executor runs on; ``None`` means
        ``CUDAPlace(0)``, which raises here on a host without CUDA.
    max_batch_size : int
        Largest bucket a single run may carry; also the coalescing cap.
    max_queue_depth : int
        Per-model admission limit; a full queue raises ServerOverloaded.
    batch_timeout : float
        Seconds a worker waits for stragglers once it holds at least one
        request and the batch is under-full. Latency/occupancy knob.
    policy : BucketPolicy, optional
        Shape-bucket ladder; defaults to pow2 buckets up to
        ``max_batch_size``.
    retry_attempts / retry_backoff / retry_on
        Transient-failure retry for each batch run
        (:mod:`paddle_tpu_torch.resilience`).
    breaker_config : dict, optional
        Per-model :class:`CircuitBreaker` kwargs (failure_threshold,
        window, failure_rate, cooldown, probe_successes, max_probes,
        clock).
    stage_timeouts : dict, optional
        Watchdog deadline per stage, merged over
        :data:`DEFAULT_STAGE_TIMEOUTS`; None disables a stage's
        deadline.
    watchdog_poll : float
        Watchdog scan interval (seconds).
    """

    def __init__(self, place=None, max_batch_size=64, max_queue_depth=128,
                 batch_timeout=0.002, policy=None, retry_attempts=2,
                 retry_backoff=0.05, retry_on=(OSError,),
                 breaker_config=None, stage_timeouts=None,
                 watchdog_poll=0.05, partitioner=None):
        if partitioner is not None:
            raise NotImplementedError(
                'ModelServer(partitioner=...): sharded serving is not '
                'ported yet (ROADMAP Queue A item 4)')
        self.place = place if place is not None else _places.CUDAPlace(0)
        self.executor = Executor(self.place)
        self.policy = policy or BucketPolicy(max_bucket=max_batch_size)
        if self.policy.max_bucket < max_batch_size:
            raise ValueError(
                'policy.max_bucket=%d < max_batch_size=%d: the largest '
                'batch could not be bucketed'
                % (self.policy.max_bucket, max_batch_size))
        self.max_batch_size = max_batch_size
        self.max_queue_depth = max_queue_depth
        self.batch_timeout = batch_timeout
        self.retry_attempts = retry_attempts
        self.retry_backoff = retry_backoff
        self.retry_on = tuple(retry_on)
        self.breaker_config = dict(breaker_config or {})
        self.stage_timeouts = dict(DEFAULT_STAGE_TIMEOUTS)
        self.stage_timeouts.update(stage_timeouts or {})
        self.registry = ModelRegistry()
        self.stats = ServingStats()
        self.watchdog = Watchdog(poll_interval=watchdog_poll,
                                 on_trip=self._on_watchdog_trip)
        self._batchers = {}            # model name -> MicroBatcher
        self._workers = {}             # model name -> Thread
        self._breakers = {}            # model name -> CircuitBreaker
        self._draining = set()         # models mid-drain
        self._wedged = set()           # models whose worker overran
        self._trip_counts = {}         # model name -> watchdog trips
        self._abandoned = []           # worker threads close() gave up on
        self._lock = threading.RLock()
        self._closed = False
        # live telemetry: /health merges this server's readiness doc
        # (weakly registered: a collected server drops out on its own)
        _obs.telemetry.register_health_provider(
            'server-%x' % id(self), self)

    # ---- model management ------------------------------------------------
    def load_model(self, name, dirname, model_filename=None,
                   params_filename=None):
        """Load a ``save_inference_model`` directory and start serving
        it under ``name``."""
        _fi.maybe_fault(_fi.SITE_SERVING_LOAD)
        model = self.registry.load(name, dirname, self.executor,
                                   model_filename=model_filename,
                                   params_filename=params_filename)
        self._start_worker(model)
        return model

    def register_model(self, name, program, feed_names, fetch_vars,
                       scope):
        """Serve an in-memory (program, scope) pair, no disk round
        trip. The scope must hold the program's parameters on the
        server's device."""
        model = self.registry.register(name, program, feed_names,
                                       fetch_vars, scope)
        self._start_worker(model)
        return model

    def unload_model(self, name, timeout=None):
        """Stop serving ``name``; its queued requests drain first (see
        :meth:`drain` for the timeout escalation)."""
        return self.drain(name, timeout=timeout)

    def drain(self, name, timeout=None):
        """Graceful per-model shutdown: stop admission, let the worker
        complete every queued request, then unload and return the
        model. With ``timeout`` (seconds), a worker still running past
        it is escalated: in-flight and queued futures fail with typed
        errors and the worker thread is abandoned, so ``drain`` returns
        instead of hanging on a wedged model."""
        self.registry.get(name)            # raises ModelNotFound
        with self._lock:
            self._draining.add(name)
            batcher = self._batchers.pop(name, None)
            worker = self._workers.pop(name, None)
        try:
            if batcher is not None:
                batcher.close()
            if worker is not None:
                worker.join(timeout)
                if worker.is_alive():
                    self._abandon_worker(name, batcher, worker)
            _obs.emit('serving_drain', model=name)
            return self.registry.unload(name)
        finally:
            with self._lock:
                self._draining.discard(name)
                self._breakers.pop(name, None)
                self._wedged.discard(name)

    def swap_model(self, name, dirname, model_filename=None,
                   params_filename=None, validate=True):
        """Hot model swap: load the replacement artifact into a fresh
        Scope, validate it off the serving path, then flip the registry
        entry atomically. The worker re-reads the registry per batch,
        so queued requests flow onto the replacement without a drop,
        and a bad deploy (unloadable or failing validation) raises here
        while the old model keeps serving untouched."""
        self.registry.get(name)            # raises ModelNotFound
        _fi.maybe_fault(_fi.SITE_SERVING_LOAD)
        scope = Scope()
        program, feed_names, fetch_vars = _load_inference_model(
            dirname, self.executor, model_filename=model_filename,
            params_filename=params_filename, scope=scope)
        candidate = LoadedModel(name, program, feed_names, fetch_vars,
                                scope)
        if validate:
            feed = candidate.synthetic_feed(1)
            if feed is not None:
                # a bad deploy raises HERE, before the flip
                self.executor.run(program, feed=feed,
                                  fetch_list=fetch_vars, scope=scope)
        new = self.registry.replace(name, candidate)
        breaker = self._breakers.get(name)
        if breaker is not None:
            breaker.reset('model swapped')
        with self._lock:
            self._wedged.discard(name)
        _obs.emit('serving_swap', model=name, dirname=dirname)
        return new

    def models(self):
        return self.registry.names()

    def breaker(self, name):
        """The model's :class:`CircuitBreaker` (introspection: tests
        assert on its transition log)."""
        return self._breakers[name]

    def _start_worker(self, model):
        with self._lock:
            if self._closed:
                raise ServerClosed('server is shut down')
            batcher = MicroBatcher(max_queue_depth=self.max_queue_depth)
            breaker = CircuitBreaker(
                name=model.name,
                on_transition=self._on_breaker_transition,
                **self.breaker_config)
            self._batchers[model.name] = batcher
            self._breakers[model.name] = breaker
            worker = threading.Thread(
                target=self._worker_loop, args=(model.name, batcher),
                name='serve-%s' % model.name, daemon=True)
            self._workers[model.name] = worker
            worker.start()
        self.stats.record_breaker_state(model.name, CLOSED)

    # ---- client surface --------------------------------------------------
    def submit(self, model_name, feeds, deadline=None, _warmup=False,
               trace=None):
        """Enqueue one request; returns an :class:`InferenceRequest`
        future. ``deadline`` is relative seconds: the request fails
        with DeadlineExceeded if no worker launches it in time.
        ``trace`` is an optional parent :class:`TraceContext` (a
        front end's request span): this submission becomes a
        ``serving/request`` child span.
        Raises ServerOverloaded / ServerClosed / ModelNotFound /
        CircuitOpen synchronously.
        """
        model = self.registry.get(model_name)
        with self._lock:
            if self._closed:
                raise ServerClosed('server is shut down')
            if model_name in self._draining:
                raise ServerClosed('model %r is draining' % model_name)
            batcher = self._batchers.get(model_name)
        if batcher is None:
            raise ServerClosed('model %r is unloaded' % model_name)
        feeds, n = self._normalize_feeds(model, feeds)
        abs_deadline = None if deadline is None \
            else time.monotonic() + deadline
        req = InferenceRequest(feeds, n, deadline=abs_deadline,
                               warmup=_warmup)
        if not _warmup:
            qspan = _obs.start_span('serving/request', parent=trace,
                                    activate=False, model=model_name,
                                    rows=n)
            if qspan.context is not None:
                req._qspan = qspan
                req.trace = qspan.context
        breaker = self._breakers.get(model_name)
        if breaker is not None and not _warmup:
            try:
                req.probe = breaker.admit()
            except CircuitOpen:
                self.stats.record_breaker_rejected(model_name)
                if req._qspan is not None:
                    req._qspan.end(error='CircuitOpen')
                raise
        try:
            batcher.submit(req)
        except ServingError:
            if req.probe:
                breaker.release_probe()
            self.stats.record_shed()
            if req._qspan is not None:
                req._qspan.end(error='shed')
            raise
        self.stats.record_submitted()
        return req

    def infer(self, model_name, feeds, deadline=None, timeout=30.0):
        """Synchronous convenience: submit + wait."""
        return self.submit(model_name, feeds, deadline=deadline).result(
            timeout=timeout)

    def _normalize_feeds(self, model, feeds):
        if not isinstance(feeds, dict):
            raise ValueError("feeds must be {'feed_name': array}")
        missing = [n for n in model.feed_names if n not in feeds]
        if missing:
            raise ValueError('model %r is missing feeds %s'
                             % (model.name, missing))
        out, n = {}, None
        for name in model.feed_names:
            val = feeds[name]
            if isinstance(val, SequenceTensor):
                raise ValueError(
                    'ModelServer serves dense batches; feed %r is a '
                    'LoD/sequence tensor: use Executor.run directly'
                    % name)
            arr = np.asarray(val)
            if arr.ndim < 1:
                raise ValueError('feed %r must have a batch dim' % name)
            if n is None:
                n = int(arr.shape[0])
            elif int(arr.shape[0]) != n:
                raise ValueError(
                    'feeds disagree on batch size: %d vs %d rows'
                    % (n, int(arr.shape[0])))
            out[name] = arr
        if n > self.max_batch_size:
            raise ValueError(
                'request of %d rows exceeds max_batch_size=%d: split '
                'it client-side' % (n, self.max_batch_size))
        return out, n

    # ---- warmup ----------------------------------------------------------
    def warmup(self, model_name=None, upto=None, timeout=300.0,
               autotune=False):
        """Run one synthetic request per shape bucket through the public
        path, so live traffic never pays a lowering or a first-shape
        cost. Returns ``{model: [bucket sizes warmed]}``; models whose
        feed shapes are dynamic (unsynthesizable) are skipped.

        Before the first bucket, the on-disk tuning cache is preloaded,
        so every warm-up lowering (and every later one) runs under the
        tuned knobs. ``autotune=True`` also runs the measured search
        (:meth:`~..compiler.tuning.Autotuner.tune_if_missing`) for each
        model and bucket before that bucket's request: only buckets with
        no entry for this device kind pay a search, so a second warm-up
        (or a process that preloaded a populated cache) searches
        nothing.

        One bucket at a time: each bucket's request completes before
        the next bucket's search or request starts. The search runs the
        model's program on its scope from this thread, which must not
        overlap the worker's run of the previous bucket (the JAX
        package's warm-up submits every bucket, then waits)."""
        t0 = time.monotonic()
        tuned = _tuning.default_cache().preload()
        tuner = _tuning.Autotuner(self.place) if autotune else None
        searches = 0
        names = [model_name] if model_name is not None else self.models()
        warmed = {}
        for name in names:
            model = self.registry.get(name)
            warmed[name] = []
            for bucket in self.policy.buckets(upto or self.max_batch_size):
                if bucket > self.max_batch_size:
                    break
                feed = model.synthetic_feed(bucket)
                if feed is None:
                    break
                if tuner is not None:
                    _, searched = tuner.tune_if_missing(
                        model.program, feed, model.fetch_vars,
                        scope=model.scope, name=name)
                    searches += int(searched)
                self.submit(name, feed, _warmup=True).result(
                    timeout=timeout)
                warmed[name].append(bucket)
        warmed = {k: v for k, v in warmed.items() if v}
        _obs.emit('serving_warmup',
                  models=len(warmed),
                  buckets=sum(len(v) for v in warmed.values()),
                  tuning_entries=tuned,
                  autotune_searches=searches,
                  dur_s=round(time.monotonic() - t0, 6))
        return warmed

    # ---- ops control -----------------------------------------------------
    def pause(self, model_name=None):
        """Stop draining (all models, or one): maintenance/drain
        control. Admission and deadlines keep applying."""
        for name in ([model_name] if model_name else list(self._batchers)):
            self._batchers[name].pause()

    def resume(self, model_name=None):
        for name in ([model_name] if model_name else list(self._batchers)):
            self._batchers[name].resume()

    def queue_depth(self, model_name):
        return self._batchers[model_name].depth()

    def cache_info(self):
        return self.executor.cache_info()

    def stats_dict(self):
        return self.stats.as_dict(cache_info=self.executor.cache_info())

    def report(self):
        return self.stats.report(cache_info=self.executor.cache_info())

    # ---- health / readiness ----------------------------------------------
    def health(self):
        """Readiness snapshot: ``{'status': ..., 'models': {name:
        {...}}}``. Per-model ``state`` is one of ``ready`` (breaker
        closed, worker live), ``degraded`` (breaker half-open, or the
        watchdog tripped a stage and the worker may be wedged),
        ``open`` (breaker open: admission sheds), ``draining`` (drain
        in progress). The whole per-model row is read under ONE
        server-lock pass (the breaker and batcher locks are leaves
        acquired inside it), so a router never routes on a torn read."""
        models = {}
        names = self.registry.names()
        with self._lock:
            closed = self._closed
            for name in names:
                breaker = self._breakers.get(name)
                bstate = breaker.state if breaker is not None else CLOSED
                if name in self._draining:
                    state = 'draining'
                elif bstate == OPEN:
                    state = 'open'
                elif bstate == HALF_OPEN or name in self._wedged:
                    state = 'degraded'
                else:
                    state = 'ready'
                batcher = self._batchers.get(name)
                worker = self._workers.get(name)
                models[name] = {
                    'state': state,
                    'breaker': bstate,
                    'queue_depth': batcher.depth() if batcher else 0,
                    'worker_alive': bool(worker and worker.is_alive()),
                    'wedged': name in self._wedged,
                    'watchdog_trips': self._trip_counts.get(name, 0),
                }
        return {'status': 'closed' if closed else 'serving',
                'models': models}

    def load_score(self, model_name=None):
        """Cheap routing signal for a fleet front-end: the queued work
        a new request would sit behind, or ``inf`` when this server
        should not be routed to at all (closed, model draining or
        unloaded, breaker open, worker wedged or dead). A half-open
        breaker adds ``max_queue_depth`` so probing replicas rank
        behind every healthy one without being unroutable. With
        ``model_name=None`` the scores of all served models are
        summed. One lock pass, as :meth:`health`."""
        with self._lock:
            if self._closed:
                return float('inf')
            names = [model_name] if model_name is not None \
                else list(self._batchers)
            score = 0.0
            for name in names:
                batcher = self._batchers.get(name)
                if batcher is None or name in self._draining:
                    return float('inf')
                worker = self._workers.get(name)
                if name in self._wedged or \
                        (worker is not None and not worker.is_alive()):
                    return float('inf')
                breaker = self._breakers.get(name)
                bstate = breaker.state if breaker is not None else CLOSED
                if bstate == OPEN:
                    return float('inf')
                score += batcher.depth()
                if bstate == HALF_OPEN:
                    score += self.max_queue_depth
            return score

    # ---- guardrail callbacks ---------------------------------------------
    def _on_breaker_transition(self, name, to_state, reason):
        self.stats.record_breaker_transition(name, to_state, reason)
        if to_state == OPEN:
            # breaker opening is crash-adjacent: freeze a postmortem
            # bundle (ring + metrics + unclosed spans) while the
            # evidence is still in memory
            _obs.flight.trip('breaker_open', model=name, reason=reason)

    def _on_watchdog_trip(self, entry):
        name = entry['model']
        forced = entry.get('error')
        err = forced if forced is not None else WatchdogTimeout(
            'model %r: %s exceeded its %.3fs deadline (%.3fs over); '
            'in-flight batch failed, breaker opened'
            % (name, entry['stage'], entry['timeout'],
               entry.get('overrun', 0.0)))
        # open the breaker and record the trip BEFORE failing the
        # futures: a client woken by the error must observe a breaker
        # that already tripped
        with self._lock:
            self._wedged.add(name)
            self._trip_counts[name] = self._trip_counts.get(name, 0) + 1
        if forced is None:
            breaker = self._breakers.get(name)
            if breaker is not None:
                breaker.trip('watchdog: %s overran' % entry['stage'])
        pending = [req for req in entry['batch'] if not req.done()]
        if pending:
            self.stats.record_failed(len(pending))
        self.stats.record_watchdog_trip(
            name, stage=entry['stage'], failed=len(pending),
            overrun=entry.get('overrun', 0.0))
        _obs.flight.trip('watchdog', model=name, stage=entry['stage'],
                         failed=len(pending),
                         overrun=entry.get('overrun', 0.0))
        for req in pending:
            req.set_error(err)
        logger.warning('watchdog tripped %s on model %r (%d futures '
                       'failed)', entry['stage'], name, len(pending))

    def _abandon_worker(self, name, batcher, worker):
        """Escalation: the worker outlived its join timeout. Fail its
        in-flight futures and everything still queued, then give the
        (daemon) thread up: shutdown must not hang on a wedged run."""
        self.watchdog.trip_all(
            model=name,
            error=ServerClosed(
                'server closed while the batch was in flight; worker '
                '%r abandoned' % name))
        pending = batcher.drain_pending() if batcher is not None else []
        cancelled = 0
        for req in pending:
            if not req.done():
                req.set_error(ServerClosed(
                    'server closed before the request ran; worker %r '
                    'abandoned' % name))
                cancelled += 1
        if cancelled:
            self.stats.record_cancelled(cancelled)
        with self._lock:
            self._abandoned.append(worker)
        _obs.emit('serving_abandoned_worker', model=name,
                  cancelled=cancelled)
        logger.error('abandoned wedged worker %r (%d queued futures '
                     'failed)', worker.name, cancelled)

    def close(self, timeout=30.0):
        """Shutdown with bounded escalation: reject new requests, drain
        every queue, join the workers, and if a worker is still alive
        once ``timeout`` seconds have elapsed (wedged in a run), fail
        its in-flight and queued futures with :class:`ServerClosed` and
        abandon the thread instead of hanging forever. ``timeout=None``
        waits forever."""
        with self._lock:
            if self._closed:
                return
            self._closed = True
            batchers = dict(self._batchers)
            workers = dict(self._workers)
        for b in batchers.values():
            b.close()
        deadline = None if timeout is None \
            else time.monotonic() + timeout
        for name, w in workers.items():
            w.join(None if deadline is None
                   else max(0.0, deadline - time.monotonic()))
            if w.is_alive():
                self._abandon_worker(name, batchers.get(name), w)
        self.watchdog.stop()
        _obs.telemetry.unregister_health_provider('server-%x' % id(self))
        # push the buffered journal tail to disk: a process that is
        # killed next must not lose the spans of its last batches
        j = _obs.get_journal()
        if j is not None:
            j.flush()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False

    # ---- worker ----------------------------------------------------------
    def _current_model(self, name):
        try:
            return self.registry.get(name)
        except ServingError:
            return None

    def _worker_loop(self, name, batcher):
        while True:
            model = self._current_model(name)
            max_rows = self.max_batch_size \
                if (model is None or model.batchable) else 1
            batch, expired = batcher.next_batch(
                max_rows, batch_timeout=self.batch_timeout)
            breaker = self._breakers.get(name)
            for req in expired:
                self.stats.record_expired()
                if req.probe and breaker is not None:
                    breaker.release_probe()   # the probe never ran
                req.set_error(DeadlineExceeded(
                    'deadline passed after %.3fs in queue'
                    % req.latency()))
            if batch is None:
                return
            if not batch:
                continue          # only expired requests this round
            # re-read the registry so a hot swap lands between batches
            model = self._current_model(name)
            if model is None:
                err = ServerClosed('model %r was unloaded' % name)
                for req in batch:
                    if not req.done():
                        req.set_error(err)
                continue
            try:
                self._run_batch(model, batch)
            except Exception as e:           # noqa: BLE001 — the worker
                # must never die: every queued client is waiting on it.
                # Record the breaker outcome BEFORE failing the futures
                # so a client woken by the error observes a breaker
                # that already counted it.
                if breaker is not None:
                    breaker.record_failure()
                self.stats.record_failed(len(batch))
                for req in batch:
                    if not req.done():
                        req.set_error(e)
            with self._lock:
                self._wedged.discard(name)

    def _exe_run(self, model, feed):
        _fi.maybe_fault(_fi.SITE_SERVING_RUN)
        return self.executor.run(model.program, feed=feed,
                                 fetch_list=model.fetch_vars,
                                 scope=model.scope)

    def _run_guarded(self, model, feed, deadline=None):
        """One Executor.run with transient-failure retry, backoff
        capped by the batch's earliest request deadline."""
        def _on_retry(attempt, error):
            self.stats.record_retry()
            # a zero-length marker span under the active serving/run
            # span: the retry storm is visible in the request's tree
            ctx = _obs.current_context()
            if ctx is not None:
                _obs.emit_span('serving/retry', 0.0, parent=ctx,
                               attempt=attempt,
                               error=type(error).__name__)
        return retry_call(self._exe_run, (model, feed),
                          max_attempts=self.retry_attempts,
                          backoff=self.retry_backoff,
                          retry_on=self.retry_on, on_retry=_on_retry,
                          deadline=deadline)

    @staticmethod
    def _earliest_deadline(batch):
        deadlines = [r.deadline for r in batch if r.deadline is not None]
        return min(deadlines) if deadlines else None

    def _run_batch(self, model, batch):
        """Run one coalesced batch. A stage the watchdog tripped
        mid-flight has already failed its futures: the batch then ends
        without completing (or counting) them again.

        Tracing: each traced request gets a ``serving/queue`` span for
        its time in the queue; the batch runs under ONE
        ``serving/batch`` span (parented to the first traced request)
        ``span_link``-ed to every request it serves (the N-to-1
        coalesce is a link, not a parent edge). The batch span is
        active on this worker thread, so pad/run and the Executor's
        spans nest under it."""
        now = time.monotonic()
        for r in batch:
            if r.trace is not None:
                _obs.emit_span('serving/queue', now - r.submit_time,
                               parent=r.trace, model=model.name)
        traced = [r.trace for r in batch if r.trace is not None]
        bspan = None
        if traced:
            bspan = _obs.start_span('serving/batch', parent=traced[0],
                                    model=model.name,
                                    requests=len(batch))
            for t in traced:
                _obs.link(bspan, t)
        try:
            self._run_batch_stages(model, batch, bspan)
        finally:
            if bspan is not None:
                bspan.end()

    def _run_batch_stages(self, model, batch, bspan):
        feed, rows, slices = merge_requests(batch)
        bucket = self.policy.bucket_for(rows) if model.batchable else rows
        deadline = self._earliest_deadline(batch)
        token = self.watchdog.enter(
            model.name, _fi.SITE_SERVING_PAD,
            self.stage_timeouts.get(_fi.SITE_SERVING_PAD), batch)
        pspan = _obs.start_span('serving/pad', rows=rows, bucket=bucket) \
            if bspan is not None else None
        try:
            _fi.maybe_fault(_fi.SITE_SERVING_PAD)
            padded = pad_feed(feed, rows, bucket, self.policy.pad_mode)
        finally:
            pad_entry = self.watchdog.exit(token)
            if pspan is not None:
                pspan.end()
        if pad_entry is None:
            return
        t0 = time.monotonic()
        token = self.watchdog.enter(
            model.name, _fi.SITE_SERVING_RUN,
            self.stage_timeouts.get(_fi.SITE_SERVING_RUN), batch)
        rspan = _obs.start_span('serving/run', rows=rows, bucket=bucket) \
            if bspan is not None else None
        try:
            fetches = self._run_guarded(model, padded, deadline=deadline)
        finally:
            run_entry = self.watchdog.exit(token)
            if rspan is not None:
                rspan.end()
        if run_entry is None:
            return
        breaker = self._breakers.get(model.name)
        if breaker is not None:
            # count the success BEFORE completing any future, so a
            # client woken by its result observes a consistent breaker
            breaker.record_success()
        self.stats.record_batch(rows, bucket, time.monotonic() - t0,
                                model=model.name)
        parts = split_fetches(fetches, slices, rows, bucket)
        if parts is None:
            # a fetch isn't row-aligned (reduced over the batch): the
            # padded/merged run polluted it. Serve each request alone,
            # unpadded (exactness over throughput) and remember.
            model.batchable = False
            for req in batch:
                token = self.watchdog.enter(
                    model.name, _fi.SITE_SERVING_RUN,
                    self.stage_timeouts.get(_fi.SITE_SERVING_RUN),
                    [req])
                espan = _obs.start_span('serving/exact_run',
                                        parent=req.trace, rows=req.n) \
                    if req.trace is not None else None
                try:
                    out = self._run_guarded(model, req.feeds,
                                            deadline=req.deadline)
                finally:
                    entry = self.watchdog.exit(token)
                    if espan is not None:
                        espan.end()
                if entry is None:
                    continue           # tripped: future already failed
                self._complete(req, out)
            return
        for req, part in zip(batch, parts):
            self._complete(req, part)

    def _complete(self, req, fetches):
        if not req.warmup:
            trace_id = req.trace.trace_id \
                if (req.trace is not None and req.trace.sampled) else None
            self.stats.record_completed(req.latency(), trace=trace_id)
        req.set_result(fetches)
