"""paddle_tpu_torch.fleet against paddle_tpu.fleet on the CPU: the
replica router, the supervisor and continuous-batching decode.

The cases of tests/test_fleet.py (all but the sharded-replicas case,
which waits for the port's Partitioner), each run on the port. The
artifacts are saved by paddle_tpu and served by the port's replicas;
the port's answers are held bit for bit against a direct port run of
the same artifact and to 1e-5 against paddle_tpu's. The ring placement
is held against paddle_tpu's for the same names and fleet sizes, and
the decode engines against paddle_tpu's on paddle_tpu's parameters.
"""
import threading
import time

import numpy as np
import pytest

import paddle_tpu.fluid as jfluid
from paddle_tpu.fleet import decode as jdecode
from paddle_tpu.fleet import router as jrouter

import paddle_tpu_torch as pt
from paddle_tpu_torch import fleet
from paddle_tpu_torch import io as pt_io
from paddle_tpu_torch.fleet import (DecodeEngine, Router,
                                    attention_history_cell,
                                    recurrent_fc_cell)
from paddle_tpu_torch.fleet.router import _ring_hash
from paddle_tpu_torch.serving import ModelServer

pytestmark = pytest.mark.fleet

IN_DIM, OUT_DIM = 6, 3
CPU = pt.CPUPlace()


def _save_artifact(tmp_path, name='m0', seed=7):
    main, startup = jfluid.Program(), jfluid.Program()
    startup.random_seed = seed
    with jfluid.program_guard(main, startup):
        with jfluid.unique_name.guard():
            x = jfluid.layers.data(name='x', shape=[IN_DIM],
                                   dtype='float32')
            h = jfluid.layers.fc(input=x, size=8, act='relu')
            y = jfluid.layers.fc(input=h, size=OUT_DIM, act=None)
    scope = jfluid.Scope()
    exe = jfluid.Executor(jfluid.CPUPlace())
    d = str(tmp_path / name)
    with jfluid.scope_guard(scope):
        exe.run(startup)
        jfluid.io.save_inference_model(d, ['x'], [y], exe,
                                       main_program=main)
    return d


def _reference_fn(model_dir):
    """A direct port run of the artifact: the bit-exact reference."""
    scope = pt.Scope()
    exe = pt.Executor(CPU)
    prog, _, fetch_vars = pt_io.load_inference_model(model_dir, exe,
                                                     scope=scope)
    lock = threading.Lock()

    def run(x):
        with lock:
            out, = exe.run(prog, feed={'x': x}, fetch_list=fetch_vars,
                           scope=scope)
        return np.asarray(out)
    return run


def _jax_fn(model_dir):
    scope = jfluid.Scope()
    exe = jfluid.Executor(jfluid.CPUPlace())
    prog, _, fetch_vars = jfluid.io.load_inference_model(model_dir, exe,
                                                         scope=scope)

    def run(x):
        out, = exe.run(prog, feed={'x': x}, fetch_list=fetch_vars,
                       scope=scope)
        return np.asarray(out)
    return run


def _factory(**kw):
    kw.setdefault('place', CPU)
    kw.setdefault('max_batch_size', 4)
    kw.setdefault('watchdog_poll', 0.02)

    def factory(rid):
        return ModelServer(**kw)
    return factory


def _router(replicas=2, supervise=False, **kw):
    kw.setdefault('warmup_on_load', False)
    return Router(_factory(), replicas=replicas, supervise=supervise,
                  poll_interval=0.05, **kw)


def _wait_for(cond, timeout=30.0, msg='condition'):
    give_up = time.monotonic() + timeout
    while time.monotonic() < give_up:
        if cond():
            return
        time.sleep(0.02)
    raise AssertionError('timed out waiting for %s' % msg)


# ---- ModelServer.load_score (the routing signal) -------------------------
def test_load_score_one_lock_snapshot(tmp_path):
    d = _save_artifact(tmp_path)
    srv = ModelServer(place=CPU, max_batch_size=4)
    with srv:
        srv.load_model('m', d)
        assert srv.load_score('m') == 0.0
        assert srv.load_score() == 0.0
        # queued work counts
        srv.pause('m')
        reqs = [srv.submit('m', {'x': np.ones((1, IN_DIM), 'float32')})
                for _ in range(3)]
        assert srv.load_score('m') == 3.0
        # health reads the same consistent row
        h = srv.health()['models']['m']
        assert h['queue_depth'] == 3
        assert h['breaker'] == 'closed'
        assert h['state'] == 'ready'
        # an open breaker makes the server unroutable for the model
        srv.breaker('m').trip('test')
        assert srv.load_score('m') == float('inf')
        assert srv.load_score() == float('inf')
        srv.breaker('m').reset('test')
        assert srv.load_score('m') == 3.0
        srv.resume('m')
        for r in reqs:
            r.result(timeout=30.0)
    assert srv.load_score('m') == float('inf')     # closed server


def test_load_score_unknown_model_is_inf(tmp_path):
    d = _save_artifact(tmp_path)
    with ModelServer(place=CPU, max_batch_size=4) as srv:
        srv.load_model('m', d)
        assert srv.load_score('nope') == float('inf')


# ---- placement -------------------------------------------------------------
def test_ring_placement_matches_paddle_tpu():
    """The ring hash and the placement it gives: paddle_tpu's for every
    name, fleet size and replication (routers built without a factory
    call, as only ``_place_ids`` is asked)."""
    names = ['m', 'model0', 'model1', 'flagship', 'resnet', 'pf',
             'user-42', 'k'] + ['model%d' % i for i in range(2, 40)]
    for name in names:
        assert _ring_hash(name) == jrouter._ring_hash(name)
    for n in range(1, 7):
        for replication in [None] + list(range(1, n + 1)):
            port = Router.__new__(Router)
            jax = jrouter.Router.__new__(jrouter.Router)
            for r in (port, jax):
                r.replication = replication
                r._replicas = {rid: None for rid in range(n)}
            for name in names:
                assert port._place_ids(name) == jax._place_ids(name), \
                    (name, n, replication)


# ---- routing -------------------------------------------------------------
def test_router_picks_least_loaded(tmp_path):
    d = _save_artifact(tmp_path)
    with _router(replicas=2) as router:
        router.load_model('m', d)
        a, b = router.placement('m')
        # build queue depth on replica a (paused), leave b empty
        router.replica(a).server.pause('m')
        held = [router.replica(a).server.submit(
            'm', {'x': np.ones((1, IN_DIM), 'float32')})
            for _ in range(8)]
        x = np.ones((2, IN_DIM), 'float32')
        routed = [router.submit('m', {'x': x}) for _ in range(4)]
        assert all(r.replica_id == b for r in routed), \
            'router sent traffic to the deeper queue'
        router.replica(a).server.resume('m')
        for r in routed + held:
            r.result(timeout=30.0)


def test_sticky_key_prefers_stable_replica(tmp_path):
    d = _save_artifact(tmp_path)
    with _router(replicas=3) as router:
        router.load_model('m', d)
        x = np.ones((1, IN_DIM), 'float32')
        first = router.submit('m', {'x': x}, sticky_key='user-42')
        first.result(timeout=30.0)
        for _ in range(3):
            r = router.submit('m', {'x': x}, sticky_key='user-42')
            r.result(timeout=30.0)
            assert r.replica_id == first.replica_id


def test_quarantine_on_open_breaker_and_restore(tmp_path):
    d = _save_artifact(tmp_path)
    with _router(replicas=2) as router:
        router.load_model('m', d)
        a, b = router.placement('m')
        rep = router.replica(a)
        rep.server.breaker('m').trip('forced by test')
        assert router.check_replica(rep) == fleet.QUARANTINED
        assert rep.state == fleet.QUARANTINED
        # routing only ever reaches the healthy replica
        x = np.ones((1, IN_DIM), 'float32')
        routed = [router.submit('m', {'x': x}) for _ in range(3)]
        for r in routed:
            r.result(timeout=30.0)
            assert r.replica_id == b
        # breaker recovers -> replica restored to the routing set
        rep.server.breaker('m').reset('healthy again')
        assert router.check_replica(rep) == fleet.ACTIVE
        assert rep.state == fleet.ACTIVE


def test_replica_kill_requeues_typed_and_restart_bit_identical(
        tmp_path):
    d = _save_artifact(tmp_path)
    expected = _reference_fn(d)
    with _router(replicas=2) as router:
        router.load_model('m', d)
        victim, other = router.placement('m')
        x = np.ones((2, IN_DIM), 'float32') * 0.25
        ref = expected(x)
        np.testing.assert_allclose(ref, _jax_fn(d)(x), rtol=1e-5,
                                   atol=1e-6)
        # park a request on the victim (paused queue), then kill it
        router.replica(victim).server.pause('m')
        req = router.submit('m', {'x': x})
        assert req.replica_id == victim
        router.kill_replica(victim)
        out, = req.result(timeout=30.0)       # transparent requeue
        assert req.requeues == 1
        assert req.replica_id == other
        assert np.array_equal(np.asarray(out), ref)
        assert router.replica(victim).state == fleet.DEAD
        # supervisor path (driven directly): restart + replay
        router.restart_replica(victim)
        rep = router.replica(victim)
        assert rep.state == fleet.ACTIVE and rep.restarts == 1
        out2, = rep.server.infer('m', {'x': x}, timeout=30.0)
        assert np.array_equal(np.asarray(out2), ref), \
            'restarted replica is not bit-identical'


def test_abrupt_kill_fails_a_parked_request_before_the_worker_sees_it(
        tmp_path):
    """An abrupt kill (a crash) fails what is queued on the victim typed
    and the router requeues it: the parked request never runs there, in
    the worst interleaving the kill allows too, where the victim's worker
    is scheduled right after its queue closes and before the server
    joins it (held open here for the worker to take and run what it
    may)."""
    d = _save_artifact(tmp_path)
    ref = _reference_fn(d)(np.ones((2, IN_DIM), 'float32') * 0.25)
    with _router(replicas=2) as router:
        router.load_model('m', d)
        victim, other = router.placement('m')
        server = router.replica(victim).server
        server.pause('m')
        req = router.submit('m', {'x': np.ones((2, IN_DIM), 'float32') *
                                  0.25})
        assert req.replica_id == victim
        batcher = server._batchers['m']
        close = batcher.close

        def close_then_yield(*args, **kwargs):
            out = close(*args, **kwargs)
            deadline = time.monotonic() + 5.0
            while batcher.depth() and time.monotonic() < deadline:
                time.sleep(0.001)
            time.sleep(0.2)
            return out
        batcher.close = close_then_yield
        router.kill_replica(victim)
        out, = req.result(timeout=30.0)
        assert (req.requeues, req.replica_id) == (1, other)
        assert np.array_equal(np.asarray(out), ref)


def test_supervisor_restarts_dead_replica(tmp_path):
    d = _save_artifact(tmp_path)
    with _router(replicas=2, supervise=True) as router:
        router.load_model('m', d)
        victim = router.placement('m')[0]
        router.kill_replica(victim)
        _wait_for(lambda: router.replica(victim).state == fleet.ACTIVE,
                  msg='supervisor restart')
        assert router.replica(victim).restarts == 1
        x = np.ones((1, IN_DIM), 'float32')
        out, = router.replica(victim).server.infer('m', {'x': x},
                                                   timeout=30.0)
        assert np.array_equal(np.asarray(out),
                              _reference_fn(d)(x))


def test_rolling_swap_keeps_availability(tmp_path):
    d1 = _save_artifact(tmp_path, 'v1', seed=7)
    d2 = _save_artifact(tmp_path, 'v2', seed=11)
    ref1, ref2 = _reference_fn(d1), _reference_fn(d2)
    x = np.ones((2, IN_DIM), 'float32') * 0.5
    e1, e2 = ref1(x), ref2(x)
    assert not np.array_equal(e1, e2)
    with _router(replicas=2) as router:
        router.load_model('m', d1)
        stop = threading.Event()
        failures, outputs = [], []

        def client():
            while not stop.is_set():
                try:
                    out, = router.infer('m', {'x': x}, timeout=30.0)
                except Exception as e:  # noqa: BLE001 — judged below
                    failures.append(e)
                else:
                    outputs.append(np.asarray(out))

        t = threading.Thread(target=client, daemon=True)
        t.start()
        time.sleep(0.1)
        swapped = router.rolling_swap('m', d2)
        time.sleep(0.1)
        stop.set()
        t.join(30.0)
        assert swapped == router.placement('m')
        assert not failures, 'requests failed during the rolling ' \
            'swap: %r' % failures[:3]
        assert outputs, 'no traffic flowed during the swap'
        for out in outputs:
            assert np.array_equal(out, e1) or np.array_equal(out, e2), \
                'a mid-swap output matches neither version'
        # the fleet converged on v2
        out, = router.infer('m', {'x': x}, timeout=30.0)
        assert np.array_equal(np.asarray(out), e2)


def test_rolling_swap_bad_artifact_rolls_back(tmp_path):
    d1 = _save_artifact(tmp_path, 'v1', seed=7)
    ref1 = _reference_fn(d1)
    with _router(replicas=2) as router:
        router.load_model('m', d1)
        with pytest.raises(Exception):
            router.rolling_swap('m', str(tmp_path / 'nonexistent'))
        # every replica still serves v1, every replica still routable
        x = np.ones((1, IN_DIM), 'float32')
        for rid in router.placement('m'):
            rep = router.replica(rid)
            assert rep.state == fleet.ACTIVE
            out, = rep.server.infer('m', {'x': x}, timeout=30.0)
            assert np.array_equal(np.asarray(out), ref1(x))


# ---- continuous-batching decode ------------------------------------------
def _carry(jeng, eng):
    params = {p.name: np.asarray(jeng.scope.raw(p.name))
              for p in jeng._main.global_block().all_parameters()}
    assert sorted(params) == sorted(
        p.name for p in eng._main.global_block().all_parameters())
    pt_io.params_from_numpy(eng.scope, params, CPU)


def test_continuous_decode_exact_vs_per_sequence():
    cell, specs = recurrent_fc_cell(dict_size=40, word_dim=8, hidden=8)
    rng = np.random.RandomState(0)
    lens = [3, 9, 1, 6, 12, 2, 5, 8, 4]
    inits = [{'h': rng.randn(8).astype('float32')} for _ in lens]
    with DecodeEngine(cell, specs, slots=4, max_len=12, end_id=None,
                      seed=3, place=CPU) as eng:
        # per-sequence: each decoded alone (slot isolation reference)
        ref = [eng.decode(init_states=i, max_new_tokens=n)
               for i, n in zip(inits, lens)]
        # continuous: all in flight together, ragged retirements
        reqs = [eng.submit(init_states=i, max_new_tokens=n)
                for i, n in zip(inits, lens)]
        out = [r.result(timeout=60.0) for r in reqs]
        stats = eng.stats()
    for i, (a, b) in enumerate(zip(ref, out)):
        assert np.array_equal(a, b), \
            'sequence %d differs under continuous batching' % i
        assert len(a) == lens[i]
    assert stats['retired'] == 2 * len(lens)
    # the continuous phase genuinely overlapped ragged sequences
    assert stats['mean_occupancy'] > 0.0


def test_stop_and_wait_matches_continuous():
    cell, specs = recurrent_fc_cell(dict_size=40, word_dim=8, hidden=8)
    rng = np.random.RandomState(1)
    lens = [2, 7, 1, 5, 3, 6]
    inits = [{'h': rng.randn(8).astype('float32')} for _ in lens]

    def run(admission):
        c, s = recurrent_fc_cell(dict_size=40, word_dim=8, hidden=8)
        with DecodeEngine(c, s, slots=4, max_len=8, end_id=None,
                          seed=5, admission=admission, place=CPU) as eng:
            reqs = [eng.submit(init_states=i, max_new_tokens=n)
                    for i, n in zip(inits, lens)]
            outs = [r.result(timeout=60.0) for r in reqs]
            return outs, eng.stats()

    cont, cstats = run('continuous')
    sw, sstats = run('stop_and_wait')
    for a, b in zip(cont, sw):
        assert np.array_equal(a, b)
    # stop-and-wait pays the straggler: strictly more (or equal) steps
    assert sstats['steps'] >= cstats['steps']


def test_decode_modes_match_paddle_tpu():
    """Continuous, stop-and-wait and per-sequence decode on paddle_tpu's
    parameters: equal to each other and to paddle_tpu's tokens, for
    both stock cells."""
    rng = np.random.RandomState(2)
    lens = [3, 9, 1, 6, 12, 2, 5, 8, 4, 7]
    firsts = [int(f) for f in rng.randint(1, 40, len(lens))]
    cells = {'recurrent_fc': (recurrent_fc_cell, jdecode.recurrent_fc_cell,
                              dict(dict_size=40, word_dim=8, hidden=8)),
             'attention_history': (attention_history_cell,
                                   jdecode.attention_history_cell,
                                   dict(dict_size=40, word_dim=8, hidden=8,
                                        max_len=12))}
    for label, (make, jmake, kw) in sorted(cells.items()):
        cell, specs = jmake(**kw)
        jeng = jdecode.DecodeEngine(cell, specs, slots=4, max_len=12,
                                    seed=4)
        want = [np.asarray(r.result(timeout=60.0)) for r in
                [jeng.submit(first_id=f, max_new_tokens=n)
                 for f, n in zip(firsts, lens)]]
        jeng.close()
        got = {}
        for mode, slots, admission in (('continuous', 4, 'continuous'),
                                       ('stop_and_wait', 4,
                                        'stop_and_wait'),
                                       ('per_sequence', 1, 'continuous')):
            cell, specs = make(**kw)
            with DecodeEngine(cell, specs, slots=slots, max_len=12,
                              seed=4, admission=admission,
                              place=CPU) as eng:
                _carry(jeng, eng)
                got[mode] = [r.result(timeout=60.0) for r in
                             [eng.submit(first_id=f, max_new_tokens=n)
                              for f, n in zip(firsts, lens)]]
        for mode, outs in got.items():
            for i, (a, b) in enumerate(zip(outs, want)):
                assert np.array_equal(a, b), (label, mode, i)


def test_decode_slotted_kv_cache_cell():
    """The attention cell keeps a [max_len, d] KV cache + length mask
    per slot; exactness under continuous admission proves slot masks
    isolate co-resident sequences."""
    cell, specs = attention_history_cell(dict_size=40, word_dim=8,
                                         hidden=8, max_len=10)
    assert [s[0] for s in specs] == ['kv', 'mask', 'h']
    with DecodeEngine(cell, specs, slots=3, max_len=10, end_id=None,
                      seed=9, place=CPU) as eng:
        plan = [(2, 1), (7, 2), (10, 3), (4, 5), (1, 6)]
        ref = [eng.decode(max_new_tokens=n, first_id=f)
               for n, f in plan]
        reqs = [eng.submit(max_new_tokens=n, first_id=f)
                for n, f in plan]
        out = [r.result(timeout=60.0) for r in reqs]
    for a, b in zip(ref, out):
        assert np.array_equal(a, b)


def test_decode_end_id_retires_early():
    """A sequence emitting end_id retires at that step and frees the
    slot; the engine reports the admit/retire flow in its stats."""
    cell, specs = recurrent_fc_cell(dict_size=12, word_dim=4, hidden=4)
    with DecodeEngine(cell, specs, slots=2, max_len=16, end_id=None,
                      seed=2, place=CPU) as probe:
        toks = probe.decode(max_new_tokens=16)
    # pick an end_id the greedy stream actually emits mid-sequence
    end_id, cut = int(toks[1]), 2
    if int(toks[0]) == end_id:
        end_id, cut = int(toks[0]), 1
    cell, specs = recurrent_fc_cell(dict_size=12, word_dim=4, hidden=4)
    with DecodeEngine(cell, specs, slots=2, max_len=16, end_id=end_id,
                      seed=2, place=CPU) as eng:
        out = eng.decode(max_new_tokens=16)
        assert len(out) == cut
        assert out[-1] == end_id
        stats = eng.stats()
    assert stats['retired'] == 1 and stats['tokens'] == cut


def test_decode_engine_close_fails_pending_typed():
    from paddle_tpu_torch.serving import ServerClosed
    cell, specs = recurrent_fc_cell(dict_size=12, word_dim=4, hidden=4)
    eng = DecodeEngine(cell, specs, slots=1, max_len=64, end_id=None,
                       seed=2, place=CPU)
    reqs = [eng.submit(max_new_tokens=64) for _ in range(4)]
    eng.close(drain=False)
    errors = 0
    for r in reqs:
        try:
            r.result(timeout=10.0)
        except ServerClosed:
            errors += 1
    assert errors >= 3, 'pending sequences must fail typed on close'


def test_router_requeue_exhaustion_is_typed(tmp_path):
    """When every replica is gone the client still gets a typed fleet
    error, never a hang or an untyped drop."""
    d = _save_artifact(tmp_path)
    with _router(replicas=2, requeue_wait=0.3) as router:
        router.load_model('m', d)
        a, b = router.placement('m')
        router.replica(a).server.pause('m')
        req = router.submit('m',
                            {'x': np.ones((1, IN_DIM), 'float32')})
        victim = req.replica_id
        router.kill_replica(a)
        router.kill_replica(b)
        with pytest.raises(fleet.FleetError):
            req.result(timeout=30.0)
        assert victim in (a, b)


def test_scale_out_then_scale_in_rebalances_sticky(tmp_path):
    """The sticky-placement ring follows elastic membership. Scale-out
    pulls the new replica into rings and serves it live; scale-in
    re-derives rings over survivors, replays load, and retires the
    victim's gauges; sticky keys keep resolving (to a live replica)
    through both transitions."""
    from paddle_tpu_torch import observability as obs
    d = _save_artifact(tmp_path)
    x = np.random.RandomState(3).randn(2, IN_DIM).astype('float32')
    with _router(replicas=2, replication=2) as router:
        router.load_model('m', d)
        ref = np.asarray(router.infer('m', {'x': x}, sticky_key='k',
                                      timeout=30.0)[0])
        before = set(router.placement('m'))
        rid = router.add_replica()
        assert rid == 2
        # the ring was re-derived over 3 replicas and the model is
        # loaded wherever it now lives (load replay, not lazy faulting)
        after_out = set(router.placement('m'))
        for r in after_out:
            assert 'm' in router.replica(r).server.models()
        out = np.asarray(router.infer('m', {'x': x}, sticky_key='k',
                                      timeout=30.0)[0])
        np.testing.assert_array_equal(ref, out)
        # scale back in: retire the newest replica
        router.retire_replica(rid)
        assert set(router.placement('m')) == before
        assert rid not in router.stats()['replicas']
        out = np.asarray(router.infer('m', {'x': x}, sticky_key='k',
                                      timeout=30.0)[0])
        np.testing.assert_array_equal(ref, out)
        # no stale per-replica series survive
        reg = obs.default_registry()
        assert reg.get('fleet_replica_state', replica=str(rid)) is None
        assert reg.get('router_routed_total', replica=str(rid)) is None
        # double-retire and restart-of-retired are typed drops
        with pytest.raises(fleet.ReplicaRetired):
            router.retire_replica(rid)
        with pytest.raises(fleet.ReplicaRetired):
            router.restart_replica(rid)
        # remote replicas wait for multihost
        with pytest.raises(NotImplementedError, match='Queue A item 6'):
            router.add_replica(backend='remote')


def test_retire_below_replication_floor_refused(tmp_path):
    d = _save_artifact(tmp_path)
    with _router(replicas=2, replication=2) as router:
        router.load_model('m', d)
        ok, why = router.can_retire(0)
        assert not ok and 'replication' in why
        with pytest.raises(ValueError):
            router.retire_replica(0)
    with pytest.raises(NotImplementedError, match='Queue A item 6'):
        Router(_factory(), replicas=1, supervise=False,
               remote_backend=object())
