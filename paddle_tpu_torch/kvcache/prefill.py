"""Prefill: prompt ingestion producing KV pages, as a fleet replica
role.

Counterpart of paddle_tpu/kvcache/prefill.py. Long prompts are the
continuous-batching engine's enemy: ingesting a K-token prompt inline
would hold a decode slot for K steps producing nothing, stalling the
running batch. Disaggregation moves that work to DEDICATED replicas: a
:class:`PrefillEngine` teacher-forces the SAME paged step program over
the prompt tokens (writing KV pages exactly as the decode engine would
have) and hands back the pages, the carry state (mask/h), the prefix
length and the first generated token. A decode engine admits that
payload with ``DecodeEngine.submit(init_pages=..., pos0=...,
first_id=...)`` and continues mid-stream, as if it had ingested the
prompt itself (``tests/test_torch_kvcache.py``).

Cells are built from a **declarative spec dict** (``stock_spec``):
plain data, so the fleet Router can replay a ``register_prefill``
placement onto restarted replicas. Both sides of the hop build their
cell from the same spec, so the seeded parameter init is identical and
the handoff is exact. The port seeds a ``torch.Generator`` on the
Executor's device, so "identical" holds between two engines on the same
kind of device (two on the card, or two on the CPU); a prefill replica
and its decode engine therefore share a place kind.

:class:`PrefillServer` wraps the engine in the replica-cell surface
the Router already speaks (``submit``/``health``/``load_score``/
``drain``/``close``...), sets ``role='prefill'`` so role-aware
placement pins prompt ingestion to prefill replicas, and fails
in-flight work typed ``ServerClosed`` on death, the REQUEUEABLE
error fleet requeue fails over on.

Engines run on ``CUDAPlace(0)`` unless given a ``place``; without CUDA
and without a place they raise, as the Executor does.
"""
import collections
import threading
import time

import numpy as np

from .. import layers
from .. import observability as _obs
from .. import unique_name
from ..core import places as _places
from ..executor import Executor, Scope
from ..framework import Program, program_guard
from ..serving.errors import (DeadlineExceeded, ModelNotFound,
                              ServerClosed, ServingError)
from .paged import paged_attention_cell
from .pool import PagePool

__all__ = ['PrefillEngine', 'PrefillServer', 'build_cell',
           'make_paged_engine', 'stock_spec', 'CELLS']

# declarative cell registry: specs name a builder here instead of
# carrying a callable, so placements are plain data and replay
# identically on replica restart
CELLS = {'paged_attention': paged_attention_cell}

_CELL_KEYS = ('dict_size', 'word_dim', 'hidden', 'max_len',
              'page_size', 'num_pages')


def stock_spec(dict_size, word_dim=32, hidden=32, max_len=64,
               page_size=8, num_pages=32, seed=0):
    """The spec dict for the stock paged attention cell."""
    return {'cell': 'paged_attention', 'dict_size': int(dict_size),
            'word_dim': int(word_dim), 'hidden': int(hidden),
            'max_len': int(max_len), 'page_size': int(page_size),
            'num_pages': int(num_pages), 'seed': int(seed)}


def build_cell(spec, num_pages=None):
    """``(cell_fn, state_specs, pool_specs)`` from a spec dict.
    ``num_pages`` overrides the spec's pool extent (the prefill side
    sizes its private pool for one prompt; the decode side for the
    whole resident set — page CONTENT transfers, page ids are
    local)."""
    kind = spec.get('cell')
    if kind not in CELLS:
        raise ValueError('unknown cell %r (have: %s)'
                         % (kind, sorted(CELLS)))
    kwargs = {k: spec[k] for k in _CELL_KEYS if k in spec}
    if num_pages is not None:
        kwargs['num_pages'] = int(num_pages)
    return CELLS[kind](**kwargs)


def make_paged_engine(spec, slots=8, end_id=None, place=None,
                      partitioner=None, num_pages=None):
    """Build the decode side of the hop from the SAME spec the prefill
    replicas were registered with: ``(DecodeEngine, PagePool)``. Same
    spec + same seed -> identical parameters on both sides, which is
    what makes the prefill->decode handoff exact."""
    from ..fleet.decode import DecodeEngine
    if partitioner is not None:
        raise NotImplementedError(
            'make_paged_engine(partitioner=...): sharded decode is not '
            'ported yet (ROADMAP Queue A item 1)')
    n_pages = int(num_pages if num_pages is not None
                  else spec.get('num_pages', 32))
    cell, state_specs, pool_specs = build_cell(spec,
                                               num_pages=n_pages)
    pool = PagePool(pool_specs, num_pages=n_pages,
                    page_size=spec['page_size'])
    engine = DecodeEngine(cell, state_specs, slots=slots,
                          max_len=spec['max_len'], end_id=end_id,
                          place=place,
                          seed=spec.get('seed', 0), admission='paged',
                          page_pool=pool)
    return engine, pool


class PrefillEngine(object):
    """Single-lane teacher-forced runner of the paged step program.

    One prompt at a time: positions ``0..k-1`` are fed the prompt
    tokens (not the argmax), writing each token's KV into this
    engine's PRIVATE page pool (``max_len / page_size`` pages — one
    max-length prompt, recycled per call). The last step's argmax is
    the first generated token, returned so the decode side emits it
    without re-running the step.
    """

    def __init__(self, spec, place=None):
        self.spec = dict(spec)
        self.max_len = int(spec['max_len'])
        self.page_size = int(spec['page_size'])
        if self.max_len % self.page_size != 0:
            raise ValueError('max_len must be a multiple of page_size')
        self.max_pages = self.max_len // self.page_size
        cell, state_specs, pool_specs = build_cell(
            spec, num_pages=self.max_pages)
        self.pool = PagePool(pool_specs, num_pages=self.max_pages,
                             page_size=self.page_size)
        self.specs = []
        for s in state_specs:
            name, shape = s[0], tuple(int(d) for d in s[1])
            dtype = s[2] if len(s) > 2 else 'float32'
            self.specs.append((name, shape, dtype))
        self.place = place if place is not None else _places.CUDAPlace(0)
        self.executor = Executor(self.place)
        self.scope = Scope()
        self._build(cell, spec.get('seed', 0))

    def _build(self, cell_fn, seed):
        self._main, self._startup = Program(), Program()
        self._startup.random_seed = seed
        with program_guard(self._main, self._startup):
            with unique_name.guard():
                ids = layers.data(name='dec_ids', shape=[1],
                                  dtype='int64')
                pos = layers.data(name='dec_pos', shape=[1],
                                  dtype='int64')
                states = {name: layers.data(name='dec_state_%s' % name,
                                            shape=list(shape),
                                            dtype=dtype)
                          for name, shape, dtype in self.specs}
                pools = {name: layers.data(
                    name='kv_pool_%s' % name,
                    shape=[self.pool.num_pages,
                           self.pool.page_size] + list(shape),
                    dtype=dtype, append_batch_size=False)
                    for name, shape, dtype in self.pool.specs}
                table = layers.data(name='kv_table',
                                    shape=[self.max_pages],
                                    dtype='int64')
                page = layers.data(name='kv_page', shape=[1],
                                   dtype='int64')
                off = layers.data(name='kv_off', shape=[1],
                                  dtype='int64')
                probs, new_states, new_pools = cell_fn(
                    ids, states, pos, pools, table, page, off)
                _, next_ids = layers.topk(probs, k=1)
        self._fetch = [next_ids] + \
            [new_states[n] for n, _, _ in self.specs] + \
            [new_pools[n] for n, _, _ in self.pool.specs]
        self.executor.run(self._startup, scope=self.scope)

    def prefill(self, prompt_ids, trace=None):
        """Ingest one prompt; returns the handoff payload::

            {'pages':  {pool spec name: [page arrays]},
             'states': {state name: per-slot array},
             'pos0':   prompt length,
             'next_id': first generated token (last step's argmax),
             'prompt_len': prompt length}

        ``trace`` parents the ``kvcache/prefill`` span (the hop stays
        one tree)."""
        prompt = np.asarray(prompt_ids, dtype=np.int64).reshape(-1)
        k = len(prompt)
        if not 1 <= k <= self.max_len:
            raise ValueError('prompt length must be in [1, %d], got %d'
                             % (self.max_len, k))
        span = _obs.start_span('kvcache/prefill', parent=trace,
                               activate=False, prompt_len=k)
        t0 = time.monotonic()
        try:
            self.pool.reset()
            pages = self.pool.alloc(self.pool.pages_for(k))
            table = np.zeros((1, self.max_pages), dtype=np.int64)
            table[0, :len(pages)] = pages
            states = {name: np.zeros((1,) + shape, dtype=dtype)
                      for name, shape, dtype in self.specs}
            ids = np.zeros((1, 1), dtype=np.int64)
            pos = np.zeros((1, 1), dtype=np.int64)
            page = np.zeros((1, 1), dtype=np.int64)
            off = np.zeros((1, 1), dtype=np.int64)
            next_id = None
            for t in range(k):
                ids[0, 0] = prompt[t]
                pos[0, 0] = t
                page[0, 0] = pages[t // self.page_size]
                off[0, 0] = t % self.page_size
                feed = {'dec_ids': ids, 'dec_pos': pos,
                        'kv_table': table, 'kv_page': page,
                        'kv_off': off}
                for name, _, _ in self.specs:
                    feed['dec_state_%s' % name] = states[name]
                for name, _, _ in self.pool.specs:
                    feed['kv_pool_%s' % name] = self.pool.data[name]
                outs = self.executor.run(self._main, feed=feed,
                                         fetch_list=self._fetch,
                                         scope=self.scope)
                next_id = int(np.asarray(outs[0]).reshape(-1)[0])
                for (name, _, _), out in zip(
                        self.specs, outs[1:1 + len(self.specs)]):
                    states[name] = np.array(out)
                for (name, _, _), out in zip(
                        self.pool.specs, outs[1 + len(self.specs):]):
                    self.pool.data[name] = np.array(out)
            payload = {
                'pages': {name: [self.pool.data[name][p].copy()
                                 for p in pages]
                          for name, _, _ in self.pool.specs},
                'states': {name: states[name][0].copy()
                           for name, _, _ in self.specs},
                'pos0': k, 'next_id': next_id, 'prompt_len': k,
            }
        except Exception as e:
            span.end(error=type(e).__name__)
            raise
        span.end(ok=True, pages=len(pages))
        _obs.emit('kvcache', action='prefill', prompt_len=k,
                  pages=len(pages),
                  dur_s=round(time.monotonic() - t0, 6))
        return payload


class _PrefillRequest(object):
    __slots__ = ('model', 'prompt', 'trace', 'deadline_abs', '_event',
                 '_value', '_error')

    def __init__(self, model, prompt, trace, deadline_abs):
        self.model = model
        self.prompt = prompt
        self.trace = trace
        self.deadline_abs = deadline_abs
        self._event = threading.Event()
        self._value = None
        self._error = None

    def done(self):
        return self._event.is_set()

    def _complete(self, ok, value):
        if ok:
            self._value = value
        else:
            self._error = value
        self._event.set()

    def result(self, timeout=None):
        if not self._event.wait(timeout):
            raise DeadlineExceeded(
                'prefill result not ready within %ss' % timeout)
        if self._error is not None:
            raise self._error
        return self._value


class PrefillServer(object):
    """The replica-cell surface over :class:`PrefillEngine`\\ s.

    Looks to the :class:`~paddle_tpu_torch.fleet.router.Router` exactly like
    a ModelServer (same ``submit``/``health``/``load_score``/... and
    error taxonomy) but ``role='prefill'``, so role-aware placement
    pins prompt-ingestion models here. Feeds are
    ``{'prompt_ids': <1-D int array>}``; the future resolves to the
    :meth:`PrefillEngine.prefill` payload, which the decode side
    admits via ``DecodeEngine.submit(init_pages=...)``.
    """

    role = 'prefill'

    def __init__(self, place=None):
        self.place = place
        self._engines = {}
        self._queue = collections.deque()
        self._draining = set()
        self._cond = threading.Condition()
        self._closed = False
        self._worker = threading.Thread(target=self._loop,
                                        name='prefill-server',
                                        daemon=True)
        self._worker.start()

    # ---- placement surface ----------------------------------------------
    def register_prefill(self, name, spec):
        """Build the engine for ``name`` from a declarative spec dict
        (:func:`stock_spec`): data, not code, so the Router's restart
        replay carries it."""
        engine = PrefillEngine(spec, place=self.place)
        with self._cond:
            if self._closed:
                raise ServerClosed('prefill server is shut down')
            self._engines[name] = engine
            self._draining.discard(name)

    def models(self):
        with self._cond:
            return sorted(self._engines)

    def warmup(self, model_name=None, upto=None, timeout=300.0):
        """Lower the step program ahead of traffic (one throwaway
        single-token prefill per engine)."""
        with self._cond:
            names = [model_name] if model_name is not None \
                else sorted(self._engines)
            engines = [self._engines[n] for n in names
                       if n in self._engines]
        for engine in engines:
            engine.prefill([1])
        return len(engines)

    # ---- request surface -------------------------------------------------
    def submit(self, name, feeds, deadline=None, trace=None, **kwargs):
        with self._cond:
            if self._closed:
                raise ServerClosed('prefill server is shut down')
            if name not in self._engines or name in self._draining:
                raise ModelNotFound(
                    'no prefill model registered as %r (have: %s)'
                    % (name, sorted(self._engines) or '-'))
            prompt = feeds.get('prompt_ids') if isinstance(feeds, dict) \
                else None
            if prompt is None:
                raise ServingError(
                    "prefill feeds must carry 'prompt_ids'")
            req = _PrefillRequest(
                name, np.asarray(prompt, dtype=np.int64), trace,
                None if deadline is None
                else time.monotonic() + deadline)
            self._queue.append(req)
            self._cond.notify_all()
        return req

    def infer(self, name, feeds, deadline=None, timeout=30.0):
        return self.submit(name, feeds,
                           deadline=deadline).result(timeout=timeout)

    def _loop(self):
        while True:
            with self._cond:
                while not self._closed and not self._queue:
                    self._cond.wait(0.05)
                if self._closed and not self._queue:
                    return
                req = self._queue.popleft()
                engine = self._engines.get(req.model)
            if engine is None:
                req._complete(False, ModelNotFound(
                    'prefill model %r was drained' % req.model))
                continue
            if req.deadline_abs is not None and \
                    time.monotonic() > req.deadline_abs:
                req._complete(False, DeadlineExceeded(
                    'prefill deadline passed before the prompt ran'))
                continue
            try:
                req._complete(True, engine.prefill(req.prompt,
                                                   trace=req.trace))
            except Exception as e:  # noqa: BLE001 — forwarded typed
                err = e if isinstance(e, ServingError) else \
                    ServingError('prefill failed: %r' % (e,))
                req._complete(False, err)

    # ---- health surface the Router/supervisor polls ----------------------
    def queue_depth(self, model_name):
        with self._cond:
            if model_name not in self._engines:
                raise ModelNotFound('no prefill model %r' % model_name)
            return sum(1 for r in self._queue
                       if r.model == model_name)

    def load_score(self, model_name=None):
        with self._cond:
            if self._closed:
                return float('inf')
            if not self._worker.is_alive():
                return float('inf')
            if model_name is not None and (
                    model_name not in self._engines or
                    model_name in self._draining):
                return float('inf')
            return float(len(self._queue))

    def health(self):
        with self._cond:
            closed = self._closed
            alive = self._worker.is_alive()
            models = {}
            for name in self._engines:
                depth = sum(1 for r in self._queue
                            if r.model == name)
                models[name] = {
                    'state': 'draining' if name in self._draining
                    else 'ready',
                    'breaker': 'closed',
                    'queue_depth': depth,
                    'worker_alive': alive,
                    'wedged': False,
                    'watchdog_trips': 0,
                }
        return {'status': 'closed' if closed else 'serving',
                'models': models}

    def pause(self, model_name=None):
        return None

    def resume(self, model_name=None):
        return None

    def drain(self, name, timeout=None):
        """Complete the model's queued prompts, then unregister it."""
        with self._cond:
            if name not in self._engines:
                raise ModelNotFound('no prefill model %r' % name)
            self._draining.add(name)
        deadline = None if timeout is None \
            else time.monotonic() + timeout
        while True:
            with self._cond:
                left = sum(1 for r in self._queue if r.model == name)
                if left == 0:
                    self._engines.pop(name, None)
                    self._draining.discard(name)
                    return
            if deadline is not None and time.monotonic() > deadline:
                raise DeadlineExceeded(
                    'prefill drain of %r timed out with %d queued'
                    % (name, left))
            time.sleep(0.01)

    def unload_model(self, name, timeout=None):
        return self.drain(name, timeout=timeout)

    def close(self, timeout=30.0):
        with self._cond:
            if self._closed:
                return
            self._closed = True
            failed = list(self._queue)
            self._queue.clear()
            self._cond.notify_all()
        for req in failed:
            req._complete(False, ServerClosed(
                'prefill server closed before the prompt ran'))
        self._worker.join(timeout)
