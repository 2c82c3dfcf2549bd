"""The port's cold-start store (fleet/coldstart.py) on the CPU: the
single-process cases of tests/test_coldstart.py against the port.

The store keeps what a memo miss prepares (the verified, pruned and
optimized program), keyed by the memo key's content, under an
invalidation token. A fresh replica is a fresh program object (loaded
anew, the same fingerprint): its first run misses the memo, finds the
entry and lowers it without the verify, the prune or the passes, and
its outputs are bit-identical to the cold run's. Counters and journal
events carry the JAX package's names.

paddle_tpu's store serialises XLA executables, and 4 of its 11 cases
fail on this machine's CPU (ROADMAP Queue C): the round trip, the
executor's and the server's warm starts, and the sharded case. The
port's are held here; the sharded case is ROADMAP Queue A item 6's.
"""
import json
import os

import numpy as np
import pytest

import paddle_tpu_torch as pt
from paddle_tpu_torch import observability as obs
from paddle_tpu_torch.fleet import coldstart
from paddle_tpu_torch.serving import ModelServer

IN_DIM, OUT_DIM = 6, 3


def _build_program(seed=7):
    main, startup = pt.Program(), pt.Program()
    startup.random_seed = seed
    with pt.program_guard(main, startup), pt.unique_name.guard():
        x = pt.layers.data(name='x', shape=[IN_DIM], dtype='float32')
        h = pt.layers.fc(input=x, size=8, act='relu')
        y = pt.layers.fc(input=h, size=OUT_DIM)
    return main, startup, y


def _save_artifact(tmp_path, name='m0', seed=7):
    main, startup, y = _build_program(seed=seed)
    scope = pt.Scope()
    exe = pt.Executor(pt.CPUPlace())
    exe.run(startup, scope=scope)
    d = str(tmp_path / name)
    pt.io.save_inference_model(d, ['x'], [y], exe, main_program=main,
                               scope=scope)
    return d


def _counter(name):
    m = obs.default_registry().get(name)
    return m.value if m is not None else 0


def test_gate_closed_by_default(monkeypatch):
    monkeypatch.delenv(coldstart.AOT_CACHE_ENV, raising=False)
    assert not coldstart.enabled()
    assert coldstart.default_store() is None


def test_env_gate_opens_store(tmp_path, monkeypatch):
    monkeypatch.setenv(coldstart.AOT_CACHE_ENV, str(tmp_path))
    assert coldstart.enabled()
    store = coldstart.default_store()
    assert store is not None and store.dirname == str(tmp_path)


def test_key_hash_stable_and_distinct():
    k1 = ('fp', b'\x01\x02', True, 'token')
    assert coldstart.key_hash(k1) == coldstart.key_hash(k1)
    assert coldstart.key_hash(k1) != coldstart.key_hash(k1 + ('x',))


def test_store_roundtrip_and_invalidation(tmp_path):
    store = coldstart.AotStore(str(tmp_path))
    main, _, _ = _build_program()
    entry = {'program': pt.io.program_to_json(main)}
    key = ('fp0', 'sig')
    assert store.save(key, entry, 'cpu')
    assert coldstart.key_hash(key) in store.entries()
    loaded = store.load(key, 'cpu')
    assert loaded == json.loads(json.dumps(entry))
    again = pt.io.program_from_json(loaded['program'])
    assert again.fingerprint() == main.fingerprint()
    # another toolchain or card: a miss, never a wrong program
    with open(store.path(key)) as f:
        rec = json.load(f)
    rec['token']['torch'] = '0.0-other'
    with open(store.path(key), 'w') as f:
        json.dump(rec, f)
    inv0 = _counter('coldstart_invalidated_total')
    assert store.load(key, 'cpu') is None
    assert _counter('coldstart_invalidated_total') == inv0 + 1


def test_corrupt_entry_degrades_to_miss(tmp_path):
    store = coldstart.AotStore(str(tmp_path))
    key = ('fp-corrupt',)
    with open(store.path(key), 'wb') as f:
        f.write(b'\xff not json')
    fails0 = _counter('coldstart_failures_total')
    assert store.load(key, 'cpu') is None
    assert _counter('coldstart_failures_total') == fails0 + 1


def test_wrong_token_schema_is_invalid(tmp_path):
    store = coldstart.AotStore(str(tmp_path))
    key = ('fp-schema',)
    with open(store.path(key), 'w') as f:
        json.dump({'token': {'schema': -1}, 'entry': {}}, f)
    inv0 = _counter('coldstart_invalidated_total')
    assert store.load(key, 'cpu') is None
    assert _counter('coldstart_invalidated_total') == inv0 + 1


def _state(startup):
    scope = pt.Scope()
    pt.Executor(pt.CPUPlace()).run(startup, scope=scope)
    return scope


def test_executor_warm_start_bit_identical(tmp_path):
    main, startup, y = _build_program()
    scope = _state(startup)
    x = np.random.RandomState(0).randn(4, IN_DIM).astype('float32')
    exe = pt.Executor(pt.CPUPlace())
    with coldstart.cache_scope(str(tmp_path)):
        saves0 = _counter('coldstart_saves_total')
        cold, = exe.run(main, feed={'x': x}, fetch_list=[y], scope=scope)
        assert _counter('coldstart_saves_total') == saves0 + 1
        # steady state: a memo hit, no store traffic
        m0, h0 = _counter('coldstart_misses_total'), \
            _counter('coldstart_hits_total')
        again, = exe.run(main, feed={'x': x}, fetch_list=[y], scope=scope)
        assert (_counter('coldstart_misses_total'),
                _counter('coldstart_hits_total')) == (m0, h0)
        np.testing.assert_array_equal(cold, again)
        # a fresh replica: the same program built anew (a fresh memo),
        # a fresh Executor; its miss loads the entry
        main2, _, y2 = _build_program()
        assert main2.fingerprint() == main.fingerprint()
        p = str(tmp_path / 'j.jsonl')
        with obs.journal(p):
            warm, = pt.Executor(pt.CPUPlace()).run(
                main2, feed={'x': x}, fetch_list=[y2], scope=scope)
        assert _counter('coldstart_hits_total') == h0 + 1
        np.testing.assert_array_equal(cold, warm)
    recs, _ = obs.read_journal(p)
    evs = [r['ev'] for r in recs]
    assert [r['action'] for r in recs if r['ev'] == 'coldstart'] == ['hit']
    # the hit skips the preparation: no compile_begin
    assert 'compile_begin' not in evs


def test_executor_no_store_without_gate(tmp_path, monkeypatch):
    monkeypatch.delenv(coldstart.AOT_CACHE_ENV, raising=False)
    main, startup, y = _build_program()
    saves0 = _counter('coldstart_saves_total')
    pt.Executor(pt.CPUPlace()).run(
        main, feed={'x': np.ones((2, IN_DIM), 'float32')}, fetch_list=[y],
        scope=_state(startup))
    assert _counter('coldstart_saves_total') == saves0
    assert os.listdir(str(tmp_path)) == []


def test_warm_start_survives_corrupt_store(tmp_path):
    main, startup, y = _build_program()
    scope = _state(startup)
    x = np.ones((2, IN_DIM), 'float32')
    with coldstart.cache_scope(str(tmp_path)):
        ref, = pt.Executor(pt.CPUPlace()).run(main, feed={'x': x},
                                              fetch_list=[y], scope=scope)
        for name in os.listdir(str(tmp_path)):
            with open(os.path.join(str(tmp_path), name), 'wb') as f:
                f.write(b'garbage')
        fails0 = _counter('coldstart_failures_total')
        main2, _, y2 = _build_program()
        out, = pt.Executor(pt.CPUPlace()).run(main2, feed={'x': x},
                                              fetch_list=[y2], scope=scope)
        assert _counter('coldstart_failures_total') == fails0 + 1
        np.testing.assert_array_equal(ref, out)


def test_server_warmup_deserializes_on_fresh_replica(tmp_path):
    art = _save_artifact(tmp_path)
    x = np.random.RandomState(1).randn(2, IN_DIM).astype('float32')
    store_dir = str(tmp_path / 'aot')
    with coldstart.cache_scope(store_dir):
        with ModelServer(place=pt.CPUPlace(), max_batch_size=4) as srv:
            srv.load_model('m', art)
            srv.warmup('m')
            ref = np.asarray(srv.submit('m', {'x': x}).result(
                timeout=30.0)[0])
        assert _counter('coldstart_saves_total') > 0
        hits0 = _counter('coldstart_hits_total')
        # a fresh replica: a new server, its own program and Executor
        with ModelServer(place=pt.CPUPlace(), max_batch_size=4) as srv2:
            srv2.load_model('m', art)
            srv2.warmup('m')
            assert _counter('coldstart_hits_total') > hits0
            out = np.asarray(srv2.submit('m', {'x': x}).result(
                timeout=30.0)[0])
    np.testing.assert_array_equal(ref, out)


@pytest.mark.parametrize('fuse', [True, False], ids=['conv_region', 'raw'])
def test_warm_start_of_optimized_conv_program_bit_identical(tmp_path, fuse):
    """A program the passes rewrite (a conv region fused with its batch
    norm and ReLU, release annotations) round-trips through the store
    and runs bit-identically; with the compiler off the raw program
    does."""
    def build():
        main, startup = pt.Program(), pt.Program()
        startup.random_seed = 3
        with pt.program_guard(main, startup), pt.unique_name.guard():
            im = pt.layers.data(name='im', shape=[4, 8, 8], dtype='float32')
            c = pt.layers.conv2d(input=im, num_filters=6, filter_size=3,
                                 padding=1)
            r = pt.layers.relu(pt.layers.batch_norm(input=c, is_test=True))
            out = pt.layers.fc(input=r, size=5, act='softmax')
        return main, startup, out
    main, startup, out = build()
    scope = _state(startup)
    feed = {'im': np.random.RandomState(2).randn(3, 4, 8, 8)
            .astype('float32')}
    ctx = pt.compiler.disabled() if not fuse else None
    with coldstart.cache_scope(str(tmp_path)):
        if ctx:
            ctx.__enter__()
        try:
            cold, = pt.Executor(pt.CPUPlace()).run(
                main, feed=feed, fetch_list=[out], scope=scope)
            hits0 = _counter('coldstart_hits_total')
            main2, _, out2 = build()
            warm, = pt.Executor(pt.CPUPlace()).run(
                main2, feed=feed, fetch_list=[out2], scope=scope)
        finally:
            if ctx:
                ctx.__exit__(None, None, None)
    assert _counter('coldstart_hits_total') == hits0 + 1
    np.testing.assert_array_equal(cold, warm)


def _conv_bn_program():
    main, startup = pt.Program(), pt.Program()
    startup.random_seed = 5
    with pt.program_guard(main, startup), pt.unique_name.guard():
        im = pt.layers.data(name='im', shape=[3, 6, 6], dtype='float32')
        c = pt.layers.conv2d(input=im, num_filters=4, filter_size=3,
                             padding=1, bias_attr=False)
        r = pt.layers.relu(pt.layers.batch_norm(input=c, is_test=True))
        out = pt.layers.fc(input=r, size=3)
    return main, startup, out


def test_inference_passes_keep_the_store_out_bit_identical(tmp_path):
    """bn_fold rescales the weights in the Scope and adds the fold bias:
    a stored program of that pipeline would run on a fresh replica's
    unfolded weights, which lack the bias. Under INFERENCE_PASSES the
    store is left out (no entry, no hit), and a fresh replica on fresh
    weights gives the first replica's output bit for bit, as it does
    with the gate closed, and the unfolded program's within the fold's
    1e-5."""
    main, startup, out = _conv_bn_program()
    init = _state(startup)
    state = {n: init.raw(n).clone() for n in init.vars
             if hasattr(init.raw(n), 'clone')}
    feed = {'im': np.random.RandomState(4).randn(2, 3, 6, 6)
            .astype('float32')}

    def replica(store_dir):
        scope = pt.Scope()
        for n, v in state.items():
            scope.set_var(n, v.clone())
        prog, _, y = _conv_bn_program()
        ctx = coldstart.cache_scope(store_dir) if store_dir else None
        if ctx:
            ctx.__enter__()
        try:
            got = pt.Executor(pt.CPUPlace()).run(
                prog, feed=feed, fetch_list=[y], scope=scope)[0]
            # the fold ran and wrote its bias into this replica's Scope
            assert any(n.endswith('.bn_fold_bias') for n in scope.vars) \
                == pt.compiler.pipeline_writes_scope()
            return got
        finally:
            if ctx:
                ctx.__exit__(None, None, None)
    pt.compiler.set_default_passes(pt.compiler.INFERENCE_PASSES)
    try:
        assert pt.compiler.pipeline_writes_scope()
        counts0 = [_counter(n) for n in ('coldstart_hits_total',
                                         'coldstart_saves_total',
                                         'coldstart_misses_total')]
        store_dir = str(tmp_path / 'aot')
        first = replica(store_dir)
        second = replica(store_dir)
        closed = replica(None)
        assert [_counter(n) for n in ('coldstart_hits_total',
                                      'coldstart_saves_total',
                                      'coldstart_misses_total')] == counts0
        assert not os.path.exists(store_dir) or os.listdir(store_dir) == []
    finally:
        pt.compiler.set_default_passes(None)
    assert not pt.compiler.pipeline_writes_scope()
    np.testing.assert_array_equal(first, second)
    np.testing.assert_array_equal(first, closed)
    np.testing.assert_allclose(first, replica(None), rtol=0, atol=1e-5)


def test_token_holds_the_preparing_sources(tmp_path, monkeypatch):
    """An entry written by another version of the passes or of the
    program's JSON form is an invalidated miss."""
    tok = coldstart.token('cpu')
    assert tok['sources'] == coldstart._sources_hash() and \
        len(tok['sources']) == 16
    store = coldstart.AotStore(str(tmp_path))
    key = ('fp-sources',)
    assert store.save(key, {'program': {}}, 'cpu')
    assert store.load(key, 'cpu') == {'program': {}}
    monkeypatch.setattr(coldstart, '_sources_digest', ['0' * 16])
    inv0 = _counter('coldstart_invalidated_total')
    assert store.load(key, 'cpu') is None
    assert _counter('coldstart_invalidated_total') == inv0 + 1
