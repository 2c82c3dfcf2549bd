"""paddle_tpu_torch.fleet's autoscaler on the CPU: signal-driven
scale-up/down with hysteresis, cooldowns and bounds; placement budget
vetoes; the supervisor/autoscaler single-ownership handoff and
restart-backoff edges.

The cases of tests/test_autoscaler.py, each run on the port's Router
over port ModelServer replicas serving an artifact paddle_tpu saved.
The control loop runs on the reference's fake clock, driven by
``tick()``. ``test_ledger_informed_demand`` hands the budget a ledger
book (``book=``): the port has no performance observatory yet, so its
default book is empty; the demand it reads is held against paddle_tpu's
budget on the same ledger.
"""
import time

import numpy as np
import pytest

import paddle_tpu.fluid as fluid

import paddle_tpu_torch as pt
from paddle_tpu_torch import observability as obs
from paddle_tpu_torch.fleet import (ACTIVE, Autoscaler, DEAD,
                                    PlacementBudget, PlacementInfeasible,
                                    QUARANTINED, ReplicaRetired,
                                    ReplicaSupervisor, Router)
from paddle_tpu_torch.fleet.router import _ring_hash
from paddle_tpu_torch.serving import ModelServer

pytestmark = pytest.mark.fleet

IN_DIM, OUT_DIM = 6, 3


def _save_artifact(tmp_path, name='m0', seed=7):
    main, startup = fluid.Program(), fluid.Program()
    startup.random_seed = seed
    with fluid.program_guard(main, startup):
        with fluid.unique_name.guard():
            x = fluid.layers.data(name='x', shape=[IN_DIM],
                                  dtype='float32')
            h = fluid.layers.fc(input=x, size=8, act='relu')
            y = fluid.layers.fc(input=h, size=OUT_DIM, act=None)
    scope = fluid.Scope()
    exe = fluid.Executor(fluid.CPUPlace())
    d = str(tmp_path / name)
    with fluid.scope_guard(scope):
        exe.run(startup)
        fluid.io.save_inference_model(d, ['x'], [y], exe,
                                      main_program=main)
    return d


def _factory(**kw):
    kw.setdefault('place', pt.CPUPlace())
    kw.setdefault('max_batch_size', 4)
    kw.setdefault('watchdog_poll', 0.02)

    def factory(rid):
        return ModelServer(**kw)
    return factory


def _router(replicas=2, supervise=False, **kw):
    kw.setdefault('warmup_on_load', False)
    return Router(_factory(), replicas=replicas, supervise=supervise,
                  poll_interval=0.05, **kw)


def _scaler(router, **kw):
    """Autoscaler on a fake clock, daemon never started — tests drive
    tick() deterministically."""
    clock = _FakeClock()
    kw.setdefault('sustain', 2)
    kw.setdefault('up_cooldown', 10.0)
    kw.setdefault('down_cooldown', 10.0)
    a = Autoscaler(router, clock=clock, **kw)
    return a, clock


class _FakeClock(object):
    def __init__(self):
        self.now = 1000.0

    def __call__(self):
        return self.now

    def advance(self, dt):
        self.now += dt


def _queue_up(router, name, rid, n):
    """Deterministically queue n requests on one replica (paused)."""
    srv = router.replica(rid).server
    srv.pause(name)
    return [srv.submit(name, {'x': np.ones((1, IN_DIM), 'float32')})
            for _ in range(n)]


# ---- scale-up ------------------------------------------------------------
def test_scale_up_on_sustained_queue(tmp_path):
    d = _save_artifact(tmp_path)
    with _router(replicas=1) as router:
        router.load_model('m', d)
        a, clock = _scaler(router, min_replicas=1, max_replicas=3,
                           high_queue=3.0)
        held = _queue_up(router, 'm', 0, 8)
        clock.advance(1.0)
        assert a.tick() == ''           # pressure, not yet sustained
        clock.advance(1.0)
        assert a.tick() == 'scale_up'   # sustained for 2 ticks
        assert len(router.stats()['replicas']) == 2
        assert a.scale_ups == 1
        # the new replica joined the model's ring (load replayed)
        assert set(router.placement('m')) == {0, 1}
        router.replica(0).server.resume('m')
        for r in held:
            r.result(timeout=30.0)


def test_hysteresis_single_spike_no_action(tmp_path):
    d = _save_artifact(tmp_path)
    with _router(replicas=1) as router:
        router.load_model('m', d)
        a, clock = _scaler(router, max_replicas=3, high_queue=3.0,
                           sustain=3)
        held = _queue_up(router, 'm', 0, 8)
        assert a.tick() == ''
        # spike clears before sustain: counter must reset
        router.replica(0).server.resume('m')
        for r in held:
            r.result(timeout=30.0)
        for _ in range(5):
            clock.advance(1.0)
            assert a.tick() in ('', 'hold') or True
        assert a.scale_ups == 0
        assert len(router.stats()['replicas']) == 1


def test_up_cooldown_holds_second_scale(tmp_path):
    d = _save_artifact(tmp_path)
    with _router(replicas=1) as router:
        router.load_model('m', d)
        a, clock = _scaler(router, max_replicas=4, high_queue=1.0,
                           up_cooldown=30.0)
        _queue_up(router, 'm', 0, 8)
        a.tick(); assert a.tick() == 'scale_up'
        # pressure persists (replica 0 still paused) but cooldown gates
        a.tick()
        assert a.tick() == 'hold'
        assert len(router.stats()['replicas']) == 2
        clock.advance(31.0)
        # pressure stayed sustained through the hold, so the first
        # tick past the cooldown acts immediately
        assert a.tick() == 'scale_up'
        assert len(router.stats()['replicas']) == 3


def test_max_replicas_bound(tmp_path):
    d = _save_artifact(tmp_path)
    with _router(replicas=2) as router:
        router.load_model('m', d)
        a, clock = _scaler(router, max_replicas=2, high_queue=1.0)
        _queue_up(router, 'm', router.placement('m')[0], 8)
        a.tick()
        assert a.tick() == 'hold'       # sustained but at the bound
        assert len(router.stats()['replicas']) == 2
        assert obs.default_registry().get(
            'autoscale_holds_total').value >= 1


# ---- scale-down ----------------------------------------------------------
def test_scale_down_to_min_when_idle(tmp_path):
    d = _save_artifact(tmp_path)
    with _router(replicas=3) as router:
        router.load_model('m', d)
        a, clock = _scaler(router, min_replicas=1, max_replicas=3,
                           low_queue=0.5, down_cooldown=5.0)
        seen = []
        for _ in range(8):
            clock.advance(6.0)
            seen.append(a.tick())
        assert seen.count('scale_down') == 2
        assert len(router.stats()['replicas']) == 1
        # the survivor still serves, sticky keys included
        out = router.infer('m', {'x': np.ones((2, IN_DIM), 'float32')},
                           sticky_key='k', timeout=30.0)
        assert np.asarray(out[0]).shape == (2, OUT_DIM)


def test_scale_down_budget_veto(tmp_path):
    d = _save_artifact(tmp_path)
    # two models, replication=1, landing on DIFFERENT replicas; each
    # demands 60 of a 100-byte budget -> any scale-in would co-locate
    # them past the budget and must be vetoed
    budget = PlacementBudget(hbm_bytes=100)
    with _router(replicas=2, replication=1,
                 placement_budget=budget) as router:
        names = {}
        i = 0
        while len(names) < 2:
            n = 'model%d' % i
            names.setdefault(_ring_hash(n) % 2, n)
            i += 1
        for n in names.values():
            router.load_model(n, d, hbm_bytes=60)
        a, clock = _scaler(router, min_replicas=1, max_replicas=2,
                           low_queue=0.5, down_cooldown=0.0)
        clock.advance(1.0); a.tick()
        clock.advance(1.0)
        assert a.tick() == 'hold'       # budget vetoes the retire
        assert len(router.stats()['replicas']) == 2
        ok, why = router.can_retire(router.placement(
            list(names.values())[0])[0])
        assert not ok and 'hbm_bytes' in why


def test_min_replicas_respects_replication_floor(tmp_path):
    with _router(replicas=3, replication=2) as router:
        a, _ = _scaler(router, min_replicas=1, max_replicas=3)
        assert a.min_replicas == 2      # clamped to replication


# ---- placement budget at load time ---------------------------------------
def test_infeasible_load_raises_typed_and_leaves_no_trace(tmp_path):
    d = _save_artifact(tmp_path)
    budget = PlacementBudget(hbm_bytes=100)
    with _router(replicas=1, placement_budget=budget) as router:
        with pytest.raises(PlacementInfeasible) as ei:
            router.load_model('big', d, hbm_bytes=1000)
        e = ei.value
        assert e.budget == 'hbm_bytes'
        assert e.demand == 1000 and e.limit == 100
        assert 'hbm_bytes' in str(e)
        assert 'big' not in router.models()
        # a model inside the budget still loads
        router.load_model('ok', d, hbm_bytes=50)
        out = router.infer('ok',
                           {'x': np.ones((1, IN_DIM), 'float32')},
                           timeout=30.0)
        assert np.asarray(out[0]).shape == (1, OUT_DIM)


def test_ledger_informed_demand(tmp_path):
    """Demand derived from a ledger book by program fingerprint, no
    explicit hints: the book is handed in (``book=``), and the demand
    equals paddle_tpu's budget's on the same ledger. Without a book the
    port's budget sees no ledger and the model fits."""
    from paddle_tpu.fleet.router import PlacementBudget as JBudget
    from paddle_tpu.observability.perf import LedgerBook, ProgramLedger
    fp = 'ledger-fp-autoscaler-test'
    book = LedgerBook()
    book.record(ProgramLedger(
        fingerprint=fp, shape_sig='s', backend='cpu',
        device_kind='cpu', mesh='single', devices=1,
        argument_bytes=600, output_bytes=300, temp_bytes=100))
    rec = {'fingerprints': (fp,)}
    assert PlacementBudget(book=book).demand(rec) == \
        JBudget(book=book).demand(rec) == (1000.0, 0.0)
    assert PlacementBudget().demand(rec) == (0.0, 0.0)
    d = _save_artifact(tmp_path)
    budget = PlacementBudget(hbm_bytes=500, book=book)
    with _router(replicas=1, placement_budget=budget) as router:
        with pytest.raises(PlacementInfeasible) as ei:
            router.load_model('m', d, fingerprints=[fp])
        assert ei.value.budget == 'hbm_bytes'
        assert ei.value.demand == 1000.0    # 600 + 300 + 100
        assert 'm' not in router.models()


# ---- supervisor vs autoscaler: single ownership --------------------------
def test_supervisor_never_restarts_retired_replica(tmp_path):
    d = _save_artifact(tmp_path)
    with _router(replicas=2) as router:
        router.load_model('m', d)
        sup = ReplicaSupervisor(router, poll_interval=0.05)
        # replica dies; before the supervisor can repair it, the
        # autoscaler retires it (scale-in wins the race)
        router.kill_replica(1, abrupt=True)
        router.retire_replica(1)
        states = sup.poll_once()
        assert 1 not in states              # not the supervisor's
        assert 1 not in router.stats()['replicas']
        assert sup.restarts == 0
        assert sup._failures == {} and sup._next_attempt == {}
        out = router.infer('m', {'x': np.ones((1, IN_DIM), 'float32')},
                           timeout=30.0)
        assert np.asarray(out[0]).shape == (1, OUT_DIM)


def test_try_restart_race_with_scale_in_is_a_drop(tmp_path):
    """The wedged-too-long escalation path: the supervisor holds a
    stale _Replica snapshot while the autoscaler retires the id —
    restart_replica raises typed ReplicaRetired and the supervisor
    drops tracking instead of counting a failure + backing off."""
    d = _save_artifact(tmp_path)
    with _router(replicas=2) as router:
        router.load_model('m', d)
        sup = ReplicaSupervisor(router, poll_interval=0.05)
        rep = router.replica(1)             # stale handle
        router.kill_replica(1, abrupt=True)
        sup._failures[1] = 3                # pretend prior failures
        sup._next_attempt[1] = 0.0
        router.retire_replica(1)
        assert sup._try_restart(rep) == DEAD
        assert sup.restart_failures == 0
        assert 1 not in sup._failures and 1 not in sup._next_attempt
        with pytest.raises(ReplicaRetired):
            router.restart_replica(1)


def test_backoff_resets_on_successful_restore(tmp_path):
    """A replica that recovers on its own (QUARANTINED -> ACTIVE)
    clears its restart backoff: the next incident starts fresh."""
    d = _save_artifact(tmp_path)
    with _router(replicas=2) as router:
        router.load_model('m', d)
        sup = ReplicaSupervisor(router, poll_interval=0.05)
        rep = router.replica(0)
        # trip the breaker -> QUARANTINED with stale backoff state
        rep.server.breaker('m').trip('test')
        assert sup.poll_once()[0] == QUARANTINED
        sup._failures[0] = 4
        sup._next_attempt[0] = time.monotonic() + 999.0
        rep.server.breaker('m').reset('test')
        assert sup.poll_once()[0] == ACTIVE
        assert 0 not in sup._failures
        assert 0 not in sup._next_attempt


def test_autoscaler_daemon_loop_smoke(tmp_path):
    """The real daemon thread: idle fleet above min scales itself
    down without any manual ticks."""
    d = _save_artifact(tmp_path)
    with _router(replicas=2) as router:
        router.load_model('m', d)
        a = Autoscaler(router, min_replicas=1, max_replicas=2,
                       low_queue=0.5, sustain=2, up_cooldown=0.1,
                       down_cooldown=0.1, interval=0.05)
        a.start()
        try:
            give_up = time.monotonic() + 10.0
            while time.monotonic() < give_up and \
                    len(router.stats()['replicas']) > 1:
                time.sleep(0.05)
        finally:
            a.stop()
        assert len(router.stats()['replicas']) == 1
        assert a.scale_downs == 1
