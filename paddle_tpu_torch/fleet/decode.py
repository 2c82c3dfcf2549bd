"""Continuous (in-flight) batching for autoregressive decode.

Counterpart of paddle_tpu/fleet/decode.py. Stop-and-wait batching runs
a decode batch to the length of its SLOWEST sequence: once occupancy
drops (short sequences finish early), the remaining steps burn device
time on retired rows. The :class:`DecodeEngine` keeps occupancy high
under ragged sequence lengths by batching at the *slot* level instead of
the *batch* level:

- a fixed number of **slots** (the step program's batch dim: one
  program, lowered once and then a memo hit every step);
- per-slot **state tensors** (`state_specs`) holding whatever the cell
  carries between steps: an RNN hidden state, or a slotted KV-cache
  ``[max_len, ...]`` written at the slot's current position;
- per-slot **length masks**: the engine threads each slot's position
  (``pos``) through the step program so an attention cell can mask its
  KV prefix, and retires a slot the step its sequence finishes;
- **in-flight admission**: new sequences enter free slots at step
  boundaries; the running batch never waits for its slowest member.

Exactness contract: the step program must be *row-independent* (no
cross-slot ops: batch norm or batch-dim reductions would let a
neighbouring slot's garbage leak in). Every stock layer the serving
path uses (embedding, fc, activations, softmax over the feature axis,
matmul) is row-wise. At one slot count a sequence decoded in a busy
engine is then bit-identical to the same sequence decoded among other
neighbours (continuous against stop-and-wait, paged against slotted).
Across slot counts the JAX package's CPU backend holds bit for bit too;
in the port a matrix product's kernel (MKL's on the CPU, cuBLAS's on
the card) depends on its row count, so a row's probabilities may round
apart at another slot count, and a token may part where the top two
probabilities all but tie (``tests/test_torch_fleet.py`` on the CPU;
``chip_smoke.py`` phase 15b on the card).

``admission='stop_and_wait'`` runs the SAME program with batch-level
admission (only refill when every slot retired), the baseline the
continuous engine is measured against.

``admission='paged'`` moves the cell's KV state out of the per-slot
``state_specs`` into a shared :class:`~paddle_tpu_torch.kvcache.pool.
PagePool`: admission becomes "allocate ``ceil(len / page_size)``
pages", so resident KV bytes track actual sequence lengths instead of
``slots * max_len``, and the slot count can grow past what dense KV
allowed. The cell signature gains the pool plumbing,
``cell_fn(pre_ids, states, pos, pools, table, page, offset) ->
(probs, new_states, new_pools)`` (see
:func:`paddle_tpu_torch.kvcache.paged_attention_cell`), and ``submit``
accepts prefilled pages (``init_pages`` + ``pos0``) so a dedicated
prefill replica can hand a prompt's KV straight to this engine. A
request the free list cannot serve waits at the queue head
(backpressure, journalled) instead of failing; one that can NEVER fit
raises typed :class:`~paddle_tpu_torch.kvcache.pool.PoolExhausted` at
submit.

Slot states and the page pool live in host numpy, as in the JAX
package: every step feeds them to the card and fetches them back (at
phase 15b's widths that is 8 MiB of KV each way a step). Keeping them on
the card is ROADMAP Queue B second part's work.

The engine runs on ``CUDAPlace(0)`` unless given a ``place``; without
CUDA and without a place it raises, as the Executor does.
``partitioner=`` (a sharded engine) raises until ROADMAP Queue A item
1.
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
from ..serving.errors import ServerClosed, ServingError

__all__ = ['DecodeEngine', 'DecodeRequest', 'recurrent_fc_cell',
           'attention_history_cell']


class DecodeRequest(object):
    """One sequence's future: resolves to the emitted token ids
    (np.int64 array) once the slot retires."""

    __slots__ = ('init_states', 'first_id', 'max_new_tokens',
                 'submit_time', '_event', '_tokens', '_error',
                 'trace', '_qspan', 'pos0', 'init_pages')

    def __init__(self, init_states, first_id, max_new_tokens,
                 pos0=0, init_pages=None):
        self.init_states = init_states
        self.first_id = first_id
        self.max_new_tokens = max_new_tokens
        self.pos0 = pos0              # prefilled prefix length (paged)
        self.init_pages = init_pages  # name -> [page arrays] (paged)
        self.submit_time = time.monotonic()
        self._event = threading.Event()
        self._tokens = None
        self._error = None
        self.trace = None     # TraceContext of the decode/request span
        self._qspan = None    # decode/request span, ended at completion

    def set_result(self, tokens):
        if self._qspan is not None:
            self._qspan.end(ok=True, tokens=len(tokens))
        self._tokens = tokens
        self._event.set()

    def set_error(self, error):
        if self._qspan is not None:
            self._qspan.end(error=type(error).__name__)
        self._error = error
        self._event.set()

    def done(self):
        return self._event.is_set()

    def result(self, timeout=None):
        if not self._event.wait(timeout):
            raise TimeoutError(
                'decode result not ready within %.3fs' % timeout)
        if self._error is not None:
            raise self._error
        return self._tokens

    def latency(self):
        return time.monotonic() - self.submit_time


class _Slot(object):
    __slots__ = ('req', 'tokens', 'span', 'pages')

    def __init__(self, req):
        self.req = req
        self.tokens = []
        self.span = None      # decode/active span, admit -> retire
        self.pages = None     # pool page ids (paged admission only)


class DecodeEngine(object):
    """Slotted continuous-batching greedy decoder over one
    step program.

    Parameters
    ----------
    cell_fn : callable
        ``cell_fn(pre_ids, states, pos) -> (probs, new_states)``.
        Builds fluid ops for ONE decode step at batch dim ``slots``:
        ``pre_ids`` [S, 1] int64 (previous token per slot), ``states``
        a dict name -> Variable per ``state_specs``, ``pos`` [S, 1]
        int64 (tokens already emitted by the slot — the per-slot
        length a KV-cache cell masks with). ``probs`` [S, V] next-token
        scores (greedy argmax picks the token); ``new_states`` must
        cover every spec. Must be row-independent (see module doc).
    state_specs : sequence of (name, shape[, dtype]) tuples
        Per-slot state tensors. A shape like ``[max_len, d]`` is a
        slotted KV-cache; ``[d]`` an RNN hidden state.
    slots : int
        The step program's batch dim: the fixed slot count.
    max_len : int
        Hard per-sequence emission cap (and the KV-cache extent).
    end_id : int or None
        Token that retires a slot early; None decodes to the
        per-request ``max_new_tokens`` only.
    admission : 'continuous' | 'stop_and_wait' | 'paged'
        Continuous admits into free slots every step boundary;
        stop_and_wait only refills once EVERY slot retired (the
        baseline policy); paged is continuous admission gated on page
        allocation from ``page_pool`` (see module doc).
    page_pool : paddle_tpu_torch.kvcache.PagePool, required when paged
        The shared KV page pool the cell's pool tensors live in. The
        engine owns its pages for the lifetime of each sequence;
        ``page_pool.nbytes`` is what a fleet placement should declare
        as ``kv_bytes`` to the :class:`~paddle_tpu_torch.fleet.router.
        PlacementBudget`.
    place : CUDAPlace/CPUPlace, optional
        ``None`` means ``CUDAPlace(0)``, which raises on a host without
        CUDA.
    """

    def __init__(self, cell_fn, state_specs, slots=8, max_len=64,
                 end_id=None, init_id=1, place=None, partitioner=None,
                 seed=0, admission='continuous', page_pool=None):
        if admission not in ('continuous', 'stop_and_wait', 'paged'):
            raise ValueError("admission must be 'continuous', "
                             "'stop_and_wait' or 'paged', got %r"
                             % admission)
        if slots < 1:
            raise ValueError('slots must be >= 1')
        if partitioner is not None:
            raise NotImplementedError(
                'DecodeEngine(partitioner=...): sharded decode is not '
                'ported yet (ROADMAP Queue A item 1)')
        self.slots = int(slots)
        self.max_len = int(max_len)
        self.end_id = end_id
        self.init_id = int(init_id)
        self.admission = admission
        self.place = place if place is not None else _places.CUDAPlace(0)
        self.pool = page_pool
        self.max_pages = 0
        if admission == 'paged':
            if page_pool is None:
                raise ValueError("admission='paged' needs a page_pool")
            if self.max_len % page_pool.page_size != 0:
                raise ValueError(
                    'max_len (%d) must be a multiple of the pool page '
                    'size (%d)' % (self.max_len, page_pool.page_size))
            self.max_pages = self.max_len // page_pool.page_size
        elif page_pool is not None:
            raise ValueError("page_pool requires admission='paged'")
        self.specs = []
        for spec in state_specs:
            name, shape = spec[0], tuple(int(d) for d in spec[1])
            dtype = spec[2] if len(spec) > 2 else 'float32'
            self.specs.append((name, shape, dtype))
        self.executor = Executor(self.place)
        self.scope = Scope()
        self._build(cell_fn, seed)
        # host-side slot tensors (worker-thread owned after start)
        S = self.slots
        self._ids = np.full((S, 1), self.init_id, dtype=np.int64)
        self._pos = np.zeros((S, 1), dtype=np.int64)
        self._states = {
            name: np.zeros((S,) + shape, dtype=dtype)
            for name, shape, dtype in self.specs}
        if admission == 'paged':
            # per-slot block-table rows + this step's write coordinates
            # (a dead slot writes to page == num_pages: out of range,
            # so its one-hot row is all zeros and nothing lands)
            self._tables = np.zeros((S, self.max_pages), dtype=np.int64)
            self._page = np.full((S, 1), self.pool.num_pages,
                                 dtype=np.int64)
            self._off = np.zeros((S, 1), dtype=np.int64)
        self._table = [None] * S          # slot index -> _Slot | None
        self._pending = collections.deque()
        self._cond = threading.Condition()
        self._closed = False
        self._abort = False
        self._blocked = False             # paged backpressure latch
        # stats (worker-thread only; snapshot via stats())
        self._steps = 0
        self._slot_steps = 0              # sum of live slots over steps
        self._tokens_out = 0
        self._admitted = 0
        self._retired = 0
        reg = _obs.default_registry()
        self._g_occ = reg.gauge(
            'decode_slot_occupancy',
            'live fraction of the decode engine slot table')
        self._g_frag = None
        if admission == 'paged':
            self._g_frag = reg.gauge(
                'kvcache_pool_fragmentation',
                'internal fragmentation of allocated KV pages: '
                '1 - written_rows / (allocated_pages * page_size)')
        self._worker = threading.Thread(target=self._loop,
                                        name='decode-engine', daemon=True)
        self._worker.start()
        _obs.telemetry.register_health_provider(
            'decode-%x' % id(self), self)

    # ---- program construction --------------------------------------------
    def _build(self, cell_fn, seed):
        self._main, self._startup = Program(), Program()
        self._startup.random_seed = seed
        paged = self.admission == 'paged'
        with program_guard(self._main, self._startup):
            with unique_name.guard():
                ids = layers.data(name='dec_ids', shape=[1],
                                  dtype='int64')
                pos = layers.data(name='dec_pos', shape=[1],
                                  dtype='int64')
                states = {}
                for name, shape, dtype in self.specs:
                    states[name] = layers.data(
                        name='dec_state_%s' % name, shape=list(shape),
                        dtype=dtype)
                if paged:
                    # the pool tensors are whole-program operands (no
                    # batch dim): fed and fetched like decode state,
                    # but shared by every slot through the block table
                    pools = {}
                    for name, shape, dtype in self.pool.specs:
                        pools[name] = layers.data(
                            name='kv_pool_%s' % name,
                            shape=[self.pool.num_pages,
                                   self.pool.page_size] + list(shape),
                            dtype=dtype, append_batch_size=False)
                    table = layers.data(name='kv_table',
                                        shape=[self.max_pages],
                                        dtype='int64')
                    page = layers.data(name='kv_page', shape=[1],
                                       dtype='int64')
                    off = layers.data(name='kv_off', shape=[1],
                                      dtype='int64')
                    probs, new_states, new_pools = cell_fn(
                        ids, states, pos, pools, table, page, off)
                    missing = [n for n, _, _ in self.pool.specs
                               if n not in (new_pools or {})]
                    if missing:
                        raise ValueError(
                            'a paged cell_fn must return a new pool '
                            'tensor for every pool spec; missing %s'
                            % missing)
                else:
                    probs, new_states = cell_fn(ids, states, pos)
                missing = [n for n, _, _ in self.specs
                           if n not in (new_states or {})]
                if missing:
                    raise ValueError(
                        'cell_fn must return a new state for every '
                        'spec; missing %s' % missing)
                _, next_ids = layers.topk(probs, k=1)
        self._fetch = [next_ids] + [new_states[n]
                                    for n, _, _ in self.specs]
        if paged:
            self._fetch += [new_pools[n] for n, _, _ in self.pool.specs]
        self.executor.run(self._startup, scope=self.scope)

    # ---- client surface --------------------------------------------------
    def submit(self, init_states=None, max_new_tokens=None,
               first_id=None, pos0=0, init_pages=None, trace=None):
        """Enqueue one sequence; returns a :class:`DecodeRequest`.
        ``init_states`` maps state name -> per-slot-shaped array
        (missing states start as zeros); ``max_new_tokens`` caps this
        sequence's emission (default: the engine's ``max_len``).

        Paged engines additionally accept a prefilled prefix:
        ``pos0`` positions already written, with their page contents in
        ``init_pages`` (pool-spec name -> list of
        ``[page_size, ...]`` arrays covering positions
        ``[0, pos0)``) — how a prefill replica's KV pages enter this
        engine. ``trace`` parents the request's
        ``decode/request`` span under a caller-owned trace (the
        prefill->decode hop stays one tree)."""
        mnt = self.max_len if max_new_tokens is None \
            else int(max_new_tokens)
        pos0 = int(pos0)
        if pos0 and self.admission != 'paged':
            raise ValueError('pos0/init_pages need a paged engine')
        if not 1 <= mnt or pos0 + mnt > self.max_len:
            raise ValueError(
                'pos0 (%d) + max_new_tokens (%d) must fit in '
                '(0, %d]' % (pos0, mnt, self.max_len))
        if self.admission == 'paged':
            from ..kvcache.pool import PoolExhausted
            need = self.pool.pages_for(pos0 + mnt)
            if need > self.pool.num_pages:
                raise PoolExhausted(
                    'sequence needs %d page(s); the whole pool holds '
                    '%d — it can never be admitted'
                    % (need, self.pool.num_pages), needed=need,
                    free=self.pool.free_pages,
                    num_pages=self.pool.num_pages)
            want = self.pool.pages_for(pos0) if pos0 else 0
            for name, _, _ in self.pool.specs:
                got = len((init_pages or {}).get(name, ()))
                if got != want:
                    raise ValueError(
                        'init_pages[%r] holds %d page(s); pos0=%d '
                        'needs %d' % (name, got, pos0, want))
        elif init_pages:
            raise ValueError('init_pages need a paged engine')
        inits = {}
        for name, shape, dtype in self.specs:
            if init_states and name in init_states:
                arr = np.asarray(init_states[name]).astype(
                    dtype, copy=False)
                if arr.shape != shape:
                    raise ValueError(
                        'init state %r has shape %s, spec wants %s'
                        % (name, arr.shape, shape))
                inits[name] = arr
        unknown = set(init_states or ()) - {n for n, _, _ in self.specs}
        if unknown:
            raise ValueError('unknown init states %s' % sorted(unknown))
        req = DecodeRequest(inits,
                            self.init_id if first_id is None
                            else int(first_id), mnt,
                            pos0=pos0, init_pages=init_pages)
        qspan = _obs.start_span('decode/request', activate=False,
                                parent=trace, max_new_tokens=mnt)
        if qspan.context is not None:
            req._qspan = qspan
            req.trace = qspan.context
        with self._cond:
            if self._closed:
                if req._qspan is not None:
                    req._qspan.end(error='ServerClosed')
                raise ServerClosed('decode engine is shut down')
            self._pending.append(req)
            self._cond.notify()
        return req

    def decode(self, init_states=None, max_new_tokens=None,
               first_id=None, timeout=60.0):
        """Synchronous convenience: submit + wait."""
        return self.submit(init_states, max_new_tokens,
                           first_id).result(timeout=timeout)

    def stats(self):
        with self._cond:
            steps = self._steps
            return {
                'slots': self.slots,
                'steps': steps,
                'slot_steps': self._slot_steps,
                'tokens': self._tokens_out,
                'admitted': self._admitted,
                'retired': self._retired,
                'pending': len(self._pending),
                'live': sum(1 for s in self._table if s is not None),
                'mean_occupancy': (self._slot_steps /
                                   (steps * self.slots)) if steps
                else 0.0,
                'pool': self.pool.stats() if self.pool is not None
                else None,
            }

    def health(self):
        """Liveness doc for the telemetry plane's ``/health`` route:
        engine status plus the same counters :meth:`stats` reports."""
        doc = self.stats()
        with self._cond:
            closed, blocked = self._closed, self._blocked
        doc['status'] = ('closed' if closed else
                         'backpressured' if blocked else 'ok')
        doc['worker_alive'] = self._worker.is_alive()
        return doc

    def close(self, drain=True, timeout=60.0):
        """Shut down the engine. ``drain=True`` finishes every pending
        and in-flight sequence first; ``drain=False`` fails them with
        typed :class:`ServerClosed`.

        Either way no future is ever left unresolved: if the drain
        cannot finish inside ``timeout`` (a wedged step, or a paged
        request the pool can never serve before shutdown), the
        leftovers fail typed too and the count is journalled — fleet
        requeue sees a REQUEUEABLE error, never a hang."""
        with self._cond:
            if self._closed:
                return
            self._closed = True
            if not drain:
                self._fail_all_locked(ServerClosed(
                    'decode engine closed before the sequence '
                    'finished'))
            self._cond.notify_all()
        _obs.telemetry.unregister_health_provider('decode-%x' % id(self))
        self._worker.join(timeout)
        if self._worker.is_alive() or self._pending or \
                any(s is not None for s in self._table):
            # the drain did not converge: abort the worker and fail
            # whatever is still queued or in flight with the typed
            # error requeue understands, instead of returning with
            # unresolved futures behind us
            with self._cond:
                self._abort = True
                self._fail_all_locked(ServerClosed(
                    'decode engine closed before the sequence '
                    'was admitted or finished (drain timed out '
                    'after %.1fs)' % timeout))
                self._cond.notify_all()
        j = _obs.get_journal()
        if j is not None:
            j.flush()   # span_ends for drained sequences hit disk now

    def _fail_all_locked(self, error):
        """Fail every pending + in-flight request typed (caller holds
        the cond); journals how many futures were resolved this way."""
        failed = list(self._pending)
        self._pending.clear()
        for s in self._table:
            if s is not None:
                if s.span is not None:
                    s.span.end(error=type(error).__name__)
                if s.pages:
                    self.pool.free(s.pages)
                failed.append(s.req)
        self._table = [None] * self.slots
        if failed:
            _obs.emit('decode', action='close_failed_pending',
                      count=len(failed), error=type(error).__name__)
        for req in failed:
            req.set_error(error)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False

    # ---- engine loop (worker thread) -------------------------------------
    def _loop(self):
        while True:
            with self._cond:
                while not self._closed and not self._abort and \
                        not self._pending and \
                        all(s is None for s in self._table):
                    self._cond.wait(0.05)
                if self._abort:
                    return
                if self._closed and not self._pending and \
                        all(s is None for s in self._table):
                    return
            try:
                with self._cond:
                    admitted = self._admit_locked()
                self._step(admitted)
            except Exception as e:  # noqa: BLE001 — engine must not die
                # silently: fail every in-flight/pending future typed.
                err = e if isinstance(e, ServingError) else \
                    ServingError('decode step failed: %r' % (e,))
                with self._cond:
                    self._fail_all_locked(err)

    def _admit_locked(self):
        """Move pending requests into free slots (caller holds the
        cond). Continuous mode refills any free slot; stop_and_wait
        only refills a fully-retired table; paged additionally gates
        each admission on page allocation — a head-of-line request the
        free list cannot serve blocks admission (FIFO backpressure,
        journalled once per stall) until retirements free pages."""
        if self.admission == 'stop_and_wait' and \
                any(s is not None for s in self._table):
            return 0
        admitted = 0
        for i in range(self.slots):
            if not self._pending:
                break
            if self._table[i] is not None:
                continue
            req = self._pending[0]
            pages = None
            if self.admission == 'paged':
                from ..kvcache.pool import PoolExhausted
                need = self.pool.pages_for(req.pos0 +
                                           req.max_new_tokens)
                try:
                    pages = self.pool.alloc(need)
                except PoolExhausted as e:
                    if not self._blocked:
                        self._blocked = True
                        _obs.emit('kvcache', action='backpressure',
                                  needed=e.needed, free=e.free,
                                  pending=len(self._pending))
                    break
                self._blocked = False
            self._pending.popleft()
            slot = _Slot(req)
            slot.pages = pages
            if req.trace is not None:
                # queue wait is pre-measured (submit -> admit), so it
                # journals as a finished span; the slot's lifetime span
                # opens here and retires with the sequence
                _obs.emit_span('decode/queue',
                               time.monotonic() - req.submit_time,
                               parent=req.trace)
                aspan = _obs.start_span('decode/active',
                                        parent=req.trace,
                                        activate=False, slot=i)
                slot.span = aspan if aspan.context is not None else None
            self._table[i] = slot
            self._ids[i, 0] = req.first_id
            self._pos[i, 0] = req.pos0
            for name, shape, dtype in self.specs:
                init = req.init_states.get(name)
                self._states[name][i] = init if init is not None \
                    else np.zeros(shape, dtype=dtype)
            if pages is not None:
                self._tables[i] = 0
                self._tables[i, :len(pages)] = pages
                if req.init_pages:
                    # a prefilled prefix: the prompt's KV pages land
                    # in this engine's pool under the new page ids
                    for name, _, _ in self.pool.specs:
                        for k, arr in enumerate(req.init_pages[name]):
                            self.pool.data[name][pages[k]] = arr
            admitted += 1
        self._admitted += admitted
        return admitted

    def _step(self, admitted):
        live = [i for i, s in enumerate(self._table) if s is not None]
        if not live:
            return
        traced = [self._table[i] for i in live
                  if self._table[i].span is not None]
        sspan = None
        if traced:
            # one decode/step serves every live traced sequence: parent
            # under the first, link the rest (N<->1, like a coalesced
            # serving batch). Activated, so exe/run nests under it.
            sspan = _obs.start_span('decode/step',
                                    parent=traced[0].req.trace,
                                    live=len(live), admitted=admitted)
            for s in traced:
                _obs.link(sspan, s.req.trace)
        try:
            self._step_traced(live, admitted)
        finally:
            if sspan is not None:
                sspan.end()

    def _step_traced(self, live, admitted):
        paged = self.admission == 'paged'
        feed = {'dec_ids': self._ids, 'dec_pos': self._pos}
        for name, _, _ in self.specs:
            feed['dec_state_%s' % name] = self._states[name]
        if paged:
            P = self.pool.page_size
            for i in range(self.slots):
                slot = self._table[i]
                if slot is None:
                    self._page[i, 0] = self.pool.num_pages  # no write
                    self._off[i, 0] = 0
                else:
                    p = int(self._pos[i, 0])
                    self._page[i, 0] = self._tables[i, p // P]
                    self._off[i, 0] = p % P
            feed['kv_table'] = self._tables
            feed['kv_page'] = self._page
            feed['kv_off'] = self._off
            for name, _, _ in self.pool.specs:
                feed['kv_pool_%s' % name] = self.pool.data[name]
        outs = self.executor.run(self._main, feed=feed,
                                 fetch_list=self._fetch,
                                 scope=self.scope)
        next_ids = np.asarray(outs[0]).reshape(self.slots, -1)
        n_state = len(self.specs)
        for (name, _, _), out in zip(self.specs, outs[1:1 + n_state]):
            # copy: fetches can be read-only views of device buffers,
            # and admit() writes slot rows in place
            self._states[name] = np.array(out)
        if paged:
            for (name, _, _), out in zip(self.pool.specs,
                                         outs[1 + n_state:]):
                self.pool.data[name] = np.array(out)
        retired = 0
        for i in live:
            slot = self._table[i]
            if slot is None:
                continue        # close() aborted us mid-step
            tok = int(next_ids[i, 0])
            slot.tokens.append(tok)
            self._pos[i, 0] += 1
            self._tokens_out += 1
            done = len(slot.tokens) >= slot.req.max_new_tokens or \
                (self.end_id is not None and tok == self.end_id)
            if done:
                self._table[i] = None
                retired += 1
                if slot.span is not None:
                    slot.span.end(tokens=len(slot.tokens))
                if slot.pages:
                    self.pool.free(slot.pages)
                slot.req.set_result(
                    np.asarray(slot.tokens, dtype=np.int64))
            else:
                self._ids[i, 0] = tok
        self._steps += 1
        self._slot_steps += len(live)
        self._retired += retired
        occupancy = len(live) / float(self.slots)
        self._g_occ.set(occupancy)
        extra = {}
        if paged:
            rows = pages = 0
            for i, s in enumerate(self._table):
                if s is not None:
                    rows += int(self._pos[i, 0])
                    pages += len(s.pages)
            frag = 1.0 - rows / float(pages * self.pool.page_size) \
                if pages else 0.0
            self._g_frag.set(frag)
            extra = {'resident': len(live),
                     'pool_used': self.pool.used_pages,
                     'fragmentation': round(frag, 4)}
        _obs.emit('decode', step=self._steps, live=len(live),
                  admitted=admitted, retired=retired,
                  occupancy=round(occupancy, 4), **extra)


# ---- stock cells ---------------------------------------------------------
def recurrent_fc_cell(dict_size, word_dim=32, hidden=32):
    """A row-wise GRU-flavoured cell: embed the previous token, mix it
    with the hidden state through one fc, project to the vocabulary.
    State spec: ``[('h', [hidden])]``."""
    def cell(pre_ids, states, pos):
        emb = layers.embedding(input=pre_ids, size=[dict_size, word_dim])
        emb = layers.reshape(emb, shape=[-1, word_dim])
        h = layers.fc(input=layers.concat([states['h'], emb], axis=-1),
                      size=hidden, act='tanh')
        probs = layers.fc(input=h, size=dict_size, act='softmax')
        return probs, {'h': h}
    return cell, [('h', [hidden])]


def attention_history_cell(dict_size, word_dim=32, hidden=32,
                           max_len=64):
    """A slotted-KV-cache cell: every step writes the current token
    embedding into its slot's ``kv`` cache at position ``pos`` (one-hot
    outer product — pure row-wise ops) and attends over the valid
    prefix with a per-slot length ``mask`` that is itself engine state.
    State specs: ``[('kv', [max_len, word_dim]), ('mask', [max_len]),
    ('h', [hidden])]``."""
    def cell(pre_ids, states, pos):
        kv, mask, h = states['kv'], states['mask'], states['h']
        emb = layers.embedding(input=pre_ids, size=[dict_size, word_dim])
        emb = layers.reshape(emb, shape=[-1, word_dim])
        # write emb into kv[pos] : one_hot(pos) [S, L] (x) emb [S, D]
        onehot = layers.one_hot(pos, depth=max_len)           # [S, L]
        write = layers.matmul(
            layers.reshape(onehot, shape=[-1, max_len, 1]),
            layers.reshape(emb, shape=[-1, 1, word_dim]))     # [S, L, D]
        kv = layers.elementwise_add(kv, write)
        mask = layers.elementwise_add(mask, onehot)           # len mask
        # attend the updated prefix with a query from (h, emb)
        query = layers.fc(input=layers.concat([h, emb], axis=-1),
                          size=word_dim, act='tanh')          # [S, D]
        scores = layers.reshape(
            layers.matmul(kv, layers.reshape(
                query, shape=[-1, word_dim, 1])),
            shape=[-1, max_len])                              # [S, L]
        # invalid positions (mask==0) get -1e9 before the softmax
        scores = layers.elementwise_add(
            scores, layers.scale(mask, scale=1e9, bias=-1e9))
        attn = layers.softmax(scores)
        ctx = layers.reshape(
            layers.matmul(layers.reshape(attn, shape=[-1, 1, max_len]),
                          kv),
            shape=[-1, word_dim])                             # [S, D]
        h = layers.fc(input=layers.concat([h, ctx], axis=-1),
                      size=hidden, act='tanh')
        probs = layers.fc(input=h, size=dict_size, act='softmax')
        return probs, {'kv': kv, 'mask': mask, 'h': h}
    return cell, [('kv', [max_len, word_dim]), ('mask', [max_len]),
                  ('h', [hidden])]
