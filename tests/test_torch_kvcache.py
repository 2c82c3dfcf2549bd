"""paddle_tpu_torch.kvcache against paddle_tpu.kvcache on the CPU: the
paged KV pool, the paged attention cell, prefill and disaggregated
decode.

The cases of tests/test_kvcache.py (all but the partitioner's, which
waits for the port's Partitioner), each run on the port, with the pool
schedules, page ids and journal events, the decode tokens and the
prefill handoff held against paddle_tpu's. Engines that are compared
with paddle_tpu's take paddle_tpu's parameters (``io.params_from_numpy``
from its engine's scope); engines compared only with each other keep
the port's own seeded ones, which agree between two engines on the CPU
(the prefill -> decode hop rests on that).
"""
import numpy as np
import pytest
import torch

import paddle_tpu.kvcache as jkvc
from paddle_tpu import observability as jobs
from paddle_tpu.fleet import decode as jdecode

import paddle_tpu_torch as pt
import paddle_tpu_torch.kvcache as kvc
from paddle_tpu_torch import io as pt_io
from paddle_tpu_torch import observability as obs
from paddle_tpu_torch.fleet.decode import (DecodeEngine,
                                           attention_history_cell)
from paddle_tpu_torch.fleet.errors import (NoHealthyReplica,
                                           PlacementInfeasible)
from paddle_tpu_torch.fleet.router import PlacementBudget, Router
from paddle_tpu_torch.kvcache import BlockTable, PagePool, PoolExhausted
from paddle_tpu_torch.serving import ModelServer
from paddle_tpu_torch.serving.errors import ServerClosed

pytestmark = pytest.mark.kvcache

DICT, WORD, HID, L = 40, 16, 16, 16
PS, NP = 4, 16
SEED = 3
CPU = pt.CPUPlace()


def _spec(**kw):
    base = dict(word_dim=WORD, hidden=HID, max_len=L, page_size=PS,
                num_pages=NP, seed=SEED)
    base.update(kw)
    return kvc.stock_spec(DICT, **base)


def _slotted(slots):
    cell, specs = attention_history_cell(DICT, word_dim=WORD,
                                         hidden=HID, max_len=L)
    return DecodeEngine(cell, specs, slots=slots, max_len=L, seed=SEED,
                        place=CPU)


def _ragged(n, seed=SEED):
    rng = np.random.RandomState(seed)
    lengths = [int(rng.randint(1, 6)) for _ in range(n)]
    for i in range(0, n, 6):
        lengths[i] = L // 2
    firsts = [int(rng.randint(1, DICT)) for _ in range(n)]
    return lengths, firsts


def _run(eng, lengths, firsts):
    reqs = [eng.submit(first_id=f, max_new_tokens=m)
            for f, m in zip(firsts, lengths)]
    return [r.result(timeout=120.0) for r in reqs]


def _params(eng):
    """The engine's parameters as host arrays (either package)."""
    return {p.name: np.asarray(eng.scope.raw(p.name))
            for p in eng._main.global_block().all_parameters()}


def _carry(jeng, eng):
    """Give the port engine ``eng`` the paddle_tpu engine's parameters."""
    params = _params(jeng)
    assert sorted(params) == sorted(_params(eng))
    pt_io.params_from_numpy(eng.scope, params, CPU)


def _pool_schedule(P, path):
    """One seeded alloc/free schedule on package ``P``'s PagePool under
    a journal: (page ids of every alloc, exhaustions, stats, events)."""
    pool = P.PagePool([('kv', [WORD]), ('h', [HID])], num_pages=NP,
                      page_size=PS)
    rng = np.random.RandomState(0)
    held, log = [], []
    with P.journal(path):
        for _ in range(120):
            if held and (rng.rand() < 0.4 or pool.free_pages == 0):
                pages = held.pop(rng.randint(len(held)))
                pool.free(pages)
                log.append(('free', pages))
            else:
                n = int(rng.randint(1, 4))
                try:
                    held.append(pool.alloc(n))
                    log.append(('alloc', held[-1]))
                except P.PoolExhausted as e:
                    log.append(('exhausted', e.needed, e.free))
    records, _ = P.read_journal(path)
    events = [{k: r[k] for k in ('action', 'pages', 'used', 'free')}
              for r in records if r['ev'] == 'kvcache']
    stats = pool.stats()
    stats.pop('nbytes')
    return log, stats, events


class _Pkg(object):
    def __init__(self, kv, ob):
        self.PagePool, self.PoolExhausted = kv.PagePool, kv.PoolExhausted
        self.journal, self.read_journal = ob.journal, ob.read_journal


# ---- allocator -----------------------------------------------------------
def test_pool_alloc_is_fifo_and_reuses_oldest_free():
    got = {}
    for key, P in (('jax', jkvc), ('port', kvc)):
        pool = P.PagePool([('kv', [WORD])], num_pages=8, page_size=PS)
        seen = [pool.alloc(3), pool.alloc(2)]
        pool.free([2, 0])
        pool.free([1])
        # the remaining original tail first, then freed pages in free order
        seen.append(pool.alloc(6))
        seen.append(pool.free_pages)
        got[key] = seen
    assert got['port'] == [[0, 1, 2], [3, 4], [5, 6, 7, 2, 0, 1], 0]
    assert got['port'] == got['jax']


def test_pool_exhausted_is_typed_and_all_or_nothing():
    pool = PagePool([('kv', [WORD])], num_pages=4, page_size=PS)
    pool.alloc(3)
    with pytest.raises(PoolExhausted) as ei:
        pool.alloc(2)
    assert ei.value.needed == 2
    assert ei.value.free == 1
    assert ei.value.num_pages == 4
    # the failed grab took nothing: the last page is still allocatable
    assert pool.alloc(1) == [3]
    jpool = jkvc.PagePool([('kv', [WORD])], num_pages=4, page_size=PS)
    jpool.alloc(3)
    with pytest.raises(jkvc.PoolExhausted) as je:
        jpool.alloc(2)
    assert str(ei.value) == str(je.value)
    assert issubclass(PoolExhausted, pt.serving.errors.ServingError)


def test_pool_free_validates_range_and_double_free():
    pool = PagePool([('kv', [WORD])], num_pages=4, page_size=PS)
    pages = pool.alloc(2)
    with pytest.raises(ValueError):
        pool.free([7])
    pool.free(pages)
    with pytest.raises(ValueError):
        pool.free([pages[0]])


def test_pool_zeroes_pages_on_alloc():
    pool = PagePool([('kv', [WORD])], num_pages=4, page_size=PS)
    pages = pool.alloc(2)
    pool.data['kv'][pages] = 7.0
    pool.free(pages)
    again = pool.alloc(4)
    assert set(again) >= set(pages)
    assert not pool.data['kv'].any()
    assert pool.data['kv'].dtype == np.float32      # host numpy, as JAX's


def test_pool_invariants_under_ragged_schedule():
    pool = PagePool([('kv', [WORD]), ('h', [HID])], num_pages=NP,
                    page_size=PS)
    rng = np.random.RandomState(0)
    held = []
    for _ in range(200):
        if held and (rng.rand() < 0.4 or pool.free_pages == 0):
            pool.free(held.pop(rng.randint(len(held))))
        else:
            n = int(rng.randint(1, 4))
            try:
                held.append(pool.alloc(n))
            except PoolExhausted:
                assert pool.free_pages < n
        assert pool.used_pages + pool.free_pages == NP
    st = pool.stats()
    assert st['peak_used_pages'] <= NP
    assert st['allocs'] >= 1 and st['frees'] >= 1
    assert st['nbytes'] == pool.nbytes
    assert pool.nbytes == NP * pool.page_bytes
    assert pool.pages_for(1) == 1
    assert pool.pages_for(PS) == 1
    assert pool.pages_for(PS + 1) == 2
    jpool = jkvc.PagePool([('kv', [WORD]), ('h', [HID])], num_pages=NP,
                          page_size=PS)
    assert (pool.nbytes, pool.page_bytes) == (jpool.nbytes,
                                              jpool.page_bytes)


def test_pool_journal_events(tmp_path):
    path = str(tmp_path / 'run.jsonl')
    pool = PagePool([('kv', [WORD])], num_pages=4, page_size=PS)
    with obs.journal(path):
        pool.free(pool.alloc(2))
    records, _ = obs.read_journal(path)
    kv = [r for r in records if r['ev'] == 'kvcache']
    assert [r['action'] for r in kv] == ['alloc', 'free']
    assert kv[0]['pages'] == 2 and kv[0]['used'] == 2
    assert kv[1]['free'] == 4
    snap = obs.default_registry().snapshot()
    assert 'kvcache_pool_used_pages' in snap
    assert 'kvcache_pool_free_pages' in snap


def test_pool_schedule_and_journal_match_paddle_tpu(tmp_path):
    """One seeded schedule on both pools: the same page ids, the same
    exhaustions, the same stats and the same ``kvcache`` events."""
    port = _pool_schedule(_Pkg(kvc, obs), str(tmp_path / 'port.jsonl'))
    jax = _pool_schedule(_Pkg(jkvc, jobs), str(tmp_path / 'jax.jsonl'))
    assert any(entry[0] == 'exhausted' for entry in port[0])
    assert port == jax


def test_block_table_row_and_addressing():
    bt = BlockTable([5, 2, 9], page_size=PS)
    assert len(bt) == 3 and bt.capacity() == 3 * PS
    assert bt.page_for(0) == 5 and bt.page_for(PS) == 2
    assert bt.page_for(2 * PS + 1) == 9 and bt.offset(2 * PS + 1) == 1
    row = bt.row(5, pad=0)
    assert row.dtype == np.int64
    assert list(row) == [5, 2, 9, 0, 0]
    assert np.array_equal(row, jkvc.BlockTable([5, 2, 9], PS).row(5))
    with pytest.raises(ValueError):
        bt.row(2)


# ---- paged decode bit-identity ------------------------------------------
def test_paged_decode_bit_identical_to_slotted_and_per_sequence():
    """The port's paged, slotted and per-sequence engines on paddle_tpu's
    parameters: bit-identical to each other, and the tokens equal to
    paddle_tpu's paged engine."""
    lengths, firsts = _ragged(18)
    jeng, _ = jkvc.make_paged_engine(_spec(), slots=8)
    jpaged = _run(jeng, lengths, firsts)
    jeng.close()
    eng = _slotted(4)
    _carry(jeng, eng)
    slotted = _run(eng, lengths, firsts)
    eng.close()
    eng, _pool = kvc.make_paged_engine(_spec(), slots=8, place=CPU)
    _carry(jeng, eng)
    paged = _run(eng, lengths, firsts)
    assert eng.stats()['pool']['used_pages'] == 0   # all pages returned
    eng.close()
    for a, b in zip(paged, slotted):
        assert np.array_equal(a, b)
    eng = _slotted(1)
    _carry(jeng, eng)
    per_seq = _run(eng, lengths, firsts)
    eng.close()
    for a, b in zip(paged, per_seq):
        assert np.array_equal(a, b)
    for a, b in zip(paged, jpaged):
        assert np.array_equal(a, np.asarray(b))


def test_slotted_decode_tokens_match_paddle_tpu():
    """The slotted engine on paddle_tpu's parameters gives paddle_tpu's
    tokens, continuous and stop-and-wait."""
    lengths, firsts = _ragged(10, seed=SEED + 1)
    cell, specs = jdecode.attention_history_cell(DICT, word_dim=WORD,
                                                 hidden=HID, max_len=L)
    jeng = jdecode.DecodeEngine(cell, specs, slots=4, max_len=L,
                                seed=SEED)
    want = _run(jeng, lengths, firsts)
    jeng.close()
    for admission in ('continuous', 'stop_and_wait'):
        cell, specs = attention_history_cell(DICT, word_dim=WORD,
                                             hidden=HID, max_len=L)
        eng = DecodeEngine(cell, specs, slots=4, max_len=L, seed=SEED,
                           place=CPU, admission=admission)
        _carry(jeng, eng)
        got = _run(eng, lengths, firsts)
        eng.close()
        for a, b in zip(got, want):
            assert np.array_equal(a, np.asarray(b)), admission


def test_paged_admission_backpressures_and_completes(tmp_path):
    # 8 pages x 4 positions = 2 resident max-length sequences; 6
    # submitted: admission MUST wait for retirements (backpressure),
    # and every sequence still completes bit-identical to per-sequence
    path = str(tmp_path / 'run.jsonl')
    lengths = [L] * 6
    firsts = list(range(1, 7))
    with obs.journal(path):
        eng, _pool = kvc.make_paged_engine(_spec(num_pages=8), slots=4,
                                           place=CPU)
        paged = _run(eng, lengths, firsts)
        eng.close()
    records, _ = obs.read_journal(path)
    bp = [r for r in records if r['ev'] == 'kvcache' and
          r['action'] == 'backpressure']
    assert bp, 'exhausted pool admitted without a backpressure event'
    eng = _slotted(1)
    per_seq = _run(eng, lengths, firsts)
    eng.close()
    for a, b in zip(paged, per_seq):
        assert np.array_equal(a, b)


def test_submit_rejects_sequence_that_can_never_fit():
    eng, _pool = kvc.make_paged_engine(_spec(num_pages=2), slots=2,
                                       place=CPU)
    try:
        with pytest.raises(PoolExhausted) as ei:
            eng.submit(first_id=1, max_new_tokens=L)
        assert ei.value.needed == L // PS
        assert ei.value.num_pages == 2
    finally:
        eng.close()


def test_close_fails_unadmitted_requests_typed_and_journals(tmp_path):
    # the pool holds exactly one max-length sequence; the second
    # request is queued-but-unadmitted when close() lands
    path = str(tmp_path / 'run.jsonl')
    with obs.journal(path):
        eng, _pool = kvc.make_paged_engine(_spec(num_pages=4), slots=2,
                                           place=CPU)
        first = eng.submit(first_id=1, max_new_tokens=L)
        blocked = eng.submit(first_id=2, max_new_tokens=L)
        eng.close(drain=False)
        for req in (first, blocked):
            with pytest.raises(ServerClosed):
                req.result(timeout=30.0)
    records, _ = obs.read_journal(path)
    closed = [r for r in records if r['ev'] == 'decode' and
              r['action'] == 'close_failed_pending']
    assert closed and closed[0]['count'] == 2
    assert closed[0]['error'] == 'ServerClosed'


# ---- prefill handoff -----------------------------------------------------
def test_prefill_handoff_matches_slotted_oracle():
    eng = _slotted(2)
    oracle = {p: eng.decode(first_id=p, max_new_tokens=10,
                            timeout=120.0) for p in (1, 9)}
    eng.close()
    pe = kvc.PrefillEngine(_spec(), place=CPU)
    eng, _pool = kvc.make_paged_engine(_spec(), slots=4, place=CPU)
    try:
        for p, want in oracle.items():
            for k in (1, 3, 6):   # prompt = id + greedy prefix
                prompt = np.concatenate([[p], want[:k - 1]])
                r = pe.prefill(prompt)
                assert r['pos0'] == k
                assert r['next_id'] == int(want[k - 1])
                got = eng.submit(
                    init_states=r['states'], init_pages=r['pages'],
                    pos0=r['pos0'], first_id=r['next_id'],
                    max_new_tokens=10 - k).result(timeout=120.0)
                assert np.array_equal(
                    np.concatenate([[r['next_id']], got]), want[k - 1:])
    finally:
        eng.close()


def test_prefill_and_decode_build_identical_parameters():
    """Same spec + same seed on the same kind of device: the prefill
    engine, the paged engine and the slotted cell hold the same
    parameters, which is what makes the hop exact."""
    pe = kvc.PrefillEngine(_spec(), place=CPU)
    eng, _pool = kvc.make_paged_engine(_spec(), slots=4, place=CPU)
    slotted = _slotted(2)
    try:
        a, b, c = _params(pe), _params(eng), _params(slotted)
        assert sorted(a) == sorted(b) == sorted(c) and len(a) == 7
        for name in a:
            assert np.array_equal(a[name], b[name]), name
            assert np.array_equal(a[name], c[name]), name
        other = kvc.PrefillEngine(_spec(seed=SEED + 1), place=CPU)
        assert any(not np.array_equal(a[n], v)
                   for n, v in _params(other).items())
    finally:
        eng.close()
        slotted.close()


def test_prefill_handoff_matches_paddle_tpu():
    """paddle_tpu's prefill payload and continuation against the port's
    on paddle_tpu's parameters: same next token, same pages and states,
    same continued tokens."""
    jpe = jkvc.PrefillEngine(_spec())
    jeng, _ = jkvc.make_paged_engine(_spec(), slots=4)
    pe = kvc.PrefillEngine(_spec(), place=CPU)
    _carry(jpe, pe)
    eng, _pool = kvc.make_paged_engine(_spec(), slots=4, place=CPU)
    _carry(jeng, eng)
    try:
        for prompt in ([3, 17, 5], [9], [1, 2, 3, 4, 5, 6]):
            jr, r = jpe.prefill(prompt), pe.prefill(prompt)
            assert r['next_id'] == jr['next_id']
            assert r['pos0'] == jr['pos0'] == len(prompt)
            for name, pages in jr['pages'].items():
                assert len(r['pages'][name]) == len(pages)
                for x, y in zip(r['pages'][name], pages):
                    np.testing.assert_allclose(x, np.asarray(y),
                                               rtol=1e-5, atol=1e-6)
            for name, state in jr['states'].items():
                np.testing.assert_allclose(r['states'][name],
                                           np.asarray(state),
                                           rtol=1e-5, atol=1e-6)
            mnt = 8
            want = jeng.submit(init_states=jr['states'],
                               init_pages=jr['pages'], pos0=jr['pos0'],
                               first_id=jr['next_id'],
                               max_new_tokens=mnt).result(timeout=120.0)
            got = eng.submit(init_states=r['states'],
                             init_pages=r['pages'], pos0=r['pos0'],
                             first_id=r['next_id'],
                             max_new_tokens=mnt).result(timeout=120.0)
            assert np.array_equal(got, np.asarray(want))
    finally:
        jeng.close()
        eng.close()


def test_prefill_server_close_resolves_every_future_typed():
    srv = kvc.PrefillServer(place=CPU)
    spec = _spec()
    srv.register_prefill('pf', spec)
    assert srv.role == 'prefill'
    assert srv.health()['models']['pf']['state'] == 'ready'
    reqs = [srv.submit('pf', {'prompt_ids': [1, 5]}) for _ in range(4)]
    srv.close()
    done = failed = 0
    for r in reqs:
        try:
            out = r.result(timeout=30.0)
            assert out['pos0'] == 2
            done += 1
        except ServerClosed:
            failed += 1
    assert done + failed == 4
    with pytest.raises(ServerClosed):
        srv.submit('pf', {'prompt_ids': [1]})


# ---- disaggregated prefill through the Router ---------------------------
def _role_factory(spec):
    def factory(rid):
        if rid < 2:
            return kvc.PrefillServer(place=CPU)
        return ModelServer(place=CPU)
    return factory


def test_router_role_placement_and_disagg_decode_through_kill():
    spec = _spec()
    eng = _slotted(2)
    oracle = {p: eng.decode(first_id=p, max_new_tokens=8,
                            timeout=120.0) for p in (1, 7, 13)}
    eng.close()
    with Router(_role_factory(spec), replicas=3, replication=2,
                poll_interval=0.05) as router:
        ids = router.register_prefill('pf', spec, warmup=False)
        assert set(ids) <= {0, 1}   # only prefill-role replicas
        dec = kvc.DisaggregatedDecoder(router, 'pf', spec, slots=4,
                                       place=CPU)
        try:
            for p in (1, 7):
                got = dec.decode([p], 8, timeout=120.0)
                assert np.array_equal(got, oracle[p])
            router.kill_replica(ids[0])   # requeue or restart: opaque
            got = dec.decode([13], 8, timeout=120.0)
            assert np.array_equal(got, oracle[13])
        finally:
            dec.close()


def test_register_prefill_needs_a_prefill_replica():
    with Router(lambda rid: ModelServer(place=CPU), replicas=2,
                supervise=False) as router:
        with pytest.raises(NoHealthyReplica) as ei:
            router.register_prefill('pf', _spec(), warmup=False)
        assert 'prefill' in str(ei.value)


def test_can_retire_refuses_last_prefill_replica():
    spec = _spec()

    def factory(rid):
        return kvc.PrefillServer(place=CPU) if rid == 0 \
            else ModelServer(place=CPU)

    with Router(factory, replicas=3, replication=1,
                supervise=False) as router:
        router.register_prefill('pf', spec, warmup=False)
        rid = router.placement('pf')[0]
        ok, reason = router.can_retire(rid)
        assert not ok and 'prefill' in reason


# ---- placement budget ----------------------------------------------------
def test_placement_budget_folds_kv_bytes_into_hbm():
    from paddle_tpu.fleet.router import PlacementBudget as JBudget
    from paddle_tpu.fleet.errors import PlacementInfeasible as JInfeasible
    budget = PlacementBudget(hbm_bytes=1000)
    with pytest.raises(PlacementInfeasible) as ei:
        budget.check('m', {'hbm_bytes': 500, 'mfu': 0.0,
                           'kv_bytes': 600}, 0, 0, 0)
    assert ei.value.demand == 1100.0
    with pytest.raises(JInfeasible) as je:
        JBudget(hbm_bytes=1000).check('m', {'hbm_bytes': 500, 'mfu': 0.0,
                                            'kv_bytes': 600}, 0, 0, 0)
    assert str(ei.value) == str(je.value)
    # without the KV pool the same model fits
    budget.check('m', {'hbm_bytes': 500, 'mfu': 0.0}, 0, 0, 0)
    # a pool's nbytes is what a placement declares as kv_bytes
    pool = PagePool([('kv', [WORD])], num_pages=NP, page_size=PS)
    assert budget.demand({'kv_bytes': pool.nbytes}) == \
        (float(NP * PS * WORD * 4), 0.0)


# ---- the card by default ---------------------------------------------------
def test_engines_default_to_the_card():
    """No place means CUDAPlace(0): where CUDA is absent, the engines
    raise instead of falling back to the CPU."""
    cell, specs = attention_history_cell(DICT, word_dim=WORD, hidden=HID,
                                         max_len=L)
    if torch.cuda.is_available():
        eng = DecodeEngine(cell, specs, slots=2, max_len=L)
        assert eng.executor.device == torch.device('cuda', 0)
        eng.close()
        return
    with pytest.raises(RuntimeError, match='CUDA is not available'):
        DecodeEngine(cell, specs, slots=2, max_len=L)
    with pytest.raises(RuntimeError, match='CUDA is not available'):
        kvc.PrefillEngine(_spec())
    with pytest.raises(RuntimeError, match='CUDA is not available'):
        kvc.make_paged_engine(_spec())
    srv = kvc.PrefillServer()
    try:
        with pytest.raises(RuntimeError, match='CUDA is not available'):
            srv.register_prefill('pf', _spec())
    finally:
        srv.close()
    with pytest.raises(NotImplementedError, match='Queue A item 1'):
        DecodeEngine(cell, specs, slots=2, max_len=L, place=CPU,
                     partitioner=object())
    with pytest.raises(NotImplementedError, match='Queue A item 1'):
        kvc.make_paged_engine(_spec(), place=CPU, partitioner=object())
