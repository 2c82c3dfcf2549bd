"""paddle_tpu_torch.compiler.tuning: the autotuner and its on-disk cache,
on the CPU.

Counterparts of tests/test_compiler.py's tuning tests and of the
poisoned-candidate test of tests/test_conv_fuse.py: the cache's disk
round trip (a torn or foreign-schema file is ignored), the Executor's
memo keyed on the entry, the candidates of the flagship training
program, ResNet-50 and stacked_dynamic_lstm (the port's own knobs: the
flash backward's route, the fused conv's widest tile and K splits, the
LSTM cell's batch rows a block; no merged-route candidate past its cap),
a fault injected into a candidate's measurement, and
``ModelServer.warmup(autotune=True)``. Then what only the port needs:
the knobs are per thread, the flash route is taken in the forward (a
CUDA backward runs on autograd's own thread), the conv knobs reach
``fused_conv_plan`` past the encoded launch's ``lru_cache`` (kernel
launches stubbed, ``_on_card`` patched, as tests/test_torch_flash_bwd.py
does), and ``Program.fingerprint()`` equals paddle_tpu's and is stable
across processes and a save and load.
"""
import collections
import json
import os
import subprocess
import sys
import threading

import numpy as np
import pytest
import torch

import paddle_tpu.fluid as fluid
from paddle_tpu.models.resnet import resnet_imagenet as jax_resnet
import paddle_tpu_torch as pt
from paddle_tpu_torch import io as pt_io
from paddle_tpu_torch import observability as obs
from paddle_tpu_torch.compiler import tuning
from paddle_tpu_torch.executor import feed_signature
from paddle_tpu_torch.models.fluid_transformer import transformer as \
    pt_transformer
from paddle_tpu_torch.models.resnet import resnet_imagenet as pt_resnet
from paddle_tpu_torch.ops import cuda_kernels as ck
from paddle_tpu_torch.resilience import faultinject as fi
from paddle_tpu_torch.serving import ModelServer

from test_torch_stacked_lstm import SMALL_LSTM, stacked_dynamic_lstm
from test_torch_training import _jax_models

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device('cpu')
CONV_SPACE = [{'conv_max_bn': 128, 'conv_max_splits': 4},
              {'conv_max_bn': 256, 'conv_max_splits': 1}]
TILES = [{'lstm_batch_tile': t} for t in (8, 16, 32, 64)]


@pytest.fixture(autouse=True)
def cache(tmp_path):
    """Every test runs on a throwaway default cache (never the file
    under ~/.cache)."""
    c = tuning.TuningCache(str(tmp_path / 'tuning.json'))
    prev = tuning.set_default_cache(c)
    yield c
    tuning.set_default_cache(prev)


def _build(pkg, fn, seed=3):
    main, startup = pkg.Program(), pkg.Program()
    startup.random_seed = seed
    with pkg.unique_name.guard(), pkg.program_guard(main, startup):
        out = fn(pkg)
    return main, startup, out


def _conv(pkg):
    x = pkg.layers.data(name='x', shape=[2, 4, 4], dtype='float32')
    c = pkg.layers.conv2d(input=x, num_filters=2, filter_size=3, padding=1,
                          bias_attr=False)
    return pkg.layers.relu(c)


def _conv_feed(seed=6, n=1):
    return {'x': np.random.RandomState(seed).randn(n, 2, 4, 4).astype(
        'float32')}


def _chain(pkg):
    x = pkg.layers.data(name='x', shape=[16], dtype='float32')
    return pkg.layers.relu(pkg.layers.fc(input=x, size=8))


def _started(main, startup):
    scope = pt.Scope()
    pt.Executor(pt.CPUPlace()).run(startup, scope=scope)
    return scope


# ---- the cache --------------------------------------------------------------------
def test_cache_disk_roundtrip(tmp_path):
    path = str(tmp_path / 'tuning.json')
    cache = tuning.TuningCache(path=path)
    entry = {'conv_max_bn': 128, 'conv_max_splits': 2}
    cache.put('fp1', 'sig1', 'cuda:nvidia-h100', entry, measured_ms=1.25)
    assert os.path.exists(path) and not [
        f for f in os.listdir(str(tmp_path)) if '.tmp' in f]
    fresh = tuning.TuningCache(path=path)
    assert fresh.preload() == 1
    assert fresh.lookup('fp1', 'sig1', 'cuda:nvidia-h100') == entry
    assert fresh.lookup('fp1', 'sig1', 'cpu') is None
    assert fresh.token('fp1', 'sig1', 'cuda:nvidia-h100') == \
        tuning.entry_token(entry) != '-'
    assert fresh.token('fpX', 'sig1', 'cuda:nvidia-h100') == '-'


@pytest.mark.parametrize('content', [
    '{"schema": 1, "entries": {"fp|sig|cpu": {"entr',       # torn write
    json.dumps({'schema': 2, 'entries': {'fp|sig|cpu': {
        'entry': {'conv_max_bn': 64}}}}),                   # foreign
    '[1, 2, 3]', ''])
def test_torn_or_foreign_cache_file_is_ignored(tmp_path, content):
    path = tmp_path / 'tuning.json'
    path.write_text(content)
    cache = tuning.TuningCache(path=str(path))
    assert cache.preload() == 0 and len(cache) == 0
    assert cache.lookup('fp', 'sig', 'cpu') is None
    cache.put('fp', 'sig', 'cpu', {'lstm_batch_tile': 8})
    fresh = tuning.TuningCache(path=str(path))
    assert fresh.preload() == 1


def test_default_path_and_backend(monkeypatch, tmp_path):
    monkeypatch.setenv('PADDLE_TPU_TORCH_TUNING_CACHE',
                       str(tmp_path / 'c.json'))
    assert tuning.TuningCache().path == str(tmp_path / 'c.json')
    monkeypatch.delenv('PADDLE_TPU_TORCH_TUNING_CACHE')
    assert tuning.TuningCache().path.endswith(os.path.join(
        '.cache', 'paddle_tpu_torch', 'tuning_cache.json'))
    assert tuning.backend(CPU) == 'cpu'
    monkeypatch.setattr(tuning, '_device_name',
                        lambda index: 'NVIDIA H100 80GB HBM3')
    assert tuning.backend(torch.device('cuda', 0)) == \
        'cuda:nvidia-h100-80gb-hbm3'


@pytest.mark.parametrize('entry, error', [
    ({'flash_block_q': 512}, 'unknown knob'),
    ({'flash_bwd_route': 'fast'}, 'not one of'),
    ({'conv_max_bn': 100}, 'not one of'),
    ({'lstm_batch_tile': 12}, 'not one of')])
def test_invalid_entries_raise(entry, error):
    with pytest.raises(ValueError, match=error):
        with tuning.apply_entry(entry):
            pass
    assert tuning.knobs() == tuning.KNOB_DEFAULTS


# ---- the Executor's memo ----------------------------------------------------------
def test_new_entry_misses_once_for_its_program_and_shape(cache):
    main, startup, out = _build(pt, _chain)
    scope = _started(main, startup)
    exe = pt.Executor(pt.CPUPlace())
    feeds = {n: {'x': np.random.RandomState(n).randn(n, 16).astype(
        'float32')} for n in (2, 4)}

    def run(n):
        return exe.run(main, feed=feeds[n], fetch_list=[out],
                       scope=scope)[0]
    base = {n: run(n) for n in (2, 4)}
    exe.reset_cache_info()
    run(2), run(4)
    assert exe.cache_info()[:2] == (2, 0)
    sig = tuning.shape_signature(feed_signature(
        exe._prepare_feed(main, feeds[2])))
    cache.put(main.fingerprint(), sig, tuning.backend(exe.device),
              {'conv_max_bn': 64}, persist=False)
    exe.reset_cache_info()
    np.testing.assert_array_equal(run(2), base[2])
    assert exe.cache_info()[:2] == (0, 1)          # exactly one miss
    np.testing.assert_array_equal(run(4), base[4])
    run(2)
    assert exe.cache_info()[:2] == (2, 1)          # none for another


def test_lowered_program_runs_under_its_entry(cache, monkeypatch):
    """The memo stores the lowered function wrapped in its entry: each
    run of it sees the entry's knobs, and the caller's knobs after."""
    main, startup, out = _build(pt, _chain)
    scope = _started(main, startup)
    exe = pt.Executor(pt.CPUPlace())
    feed = {'x': np.ones((2, 16), 'float32')}
    sig = tuning.shape_signature(feed_signature(
        exe._prepare_feed(main, feed)))
    cache.put(main.fingerprint(), sig, 'cpu', {'lstm_batch_tile': 32},
              persist=False)
    seen = []
    relu = pt.core.registry.get_kernel('relu')

    def spy(ctx):
        seen.append(tuning.knobs()['lstm_batch_tile'])
        return relu(ctx)
    monkeypatch.setitem(pt.core.registry._KERNELS, 'relu', spy)
    exe.run(main, feed=feed, fetch_list=[out], scope=scope)
    assert seen == [32] and tuning.knobs() == tuning.KNOB_DEFAULTS


# ---- candidates -------------------------------------------------------------------
def _flagship_train(seq):
    def build(pkg):
        loss, feed_fn, _, _ = pt_transformer(
            None, vocab=8192, d_model=1024, n_heads=8, n_layers=1,
            d_ff=4096, seq=seq)
        pt.optimizer.Adam(1e-4).minimize(loss)
        build.feed_fn = feed_fn
        return loss
    main, _, _ = _build(pt, build)
    return main, build.feed_fn


@pytest.mark.parametrize('batch, seq, routes', [
    (16, 2048, ['merged', 'two_pass']),     # the training shape
    (5, 32768, ['two_pass'])])              # past the 512 MiB cap
def test_candidates_of_the_flagship_training_program(batch, seq, routes):
    main, feed_fn = _flagship_train(seq)
    feed = {k: v[:, :1] for k, v in feed_fn(batch).items()}   # the batch
    tuner = tuning.Autotuner(pt.CPUPlace())
    assert tuner.candidates(main, feed) == \
        [{}] + [{'flash_bwd_route': r} for r in routes]
    assert tuner.last_pruned == 2 - len(routes)
    q = torch.empty(batch, seq, 8, 128, device='meta')
    assert (ck.merged_bwd_bytes(q) <= ck._MERGED_BWD_MAX_SLAB_BYTES) == \
        ('merged' in routes)


def test_candidates_of_serving_programs():
    tuner = tuning.Autotuner(pt.CPUPlace())
    # the flagship's inference program has no flash backward
    main, feed_fn = _flagship_train(256)
    logits = [op for op in main.global_block().ops
              if op.type == 'softmax_with_cross_entropy'][0].input(
                  'Logits')[0]
    serve = main.prune([logits])
    assert tuner.candidates(serve, feed_fn(1)) == [{}]
    # ResNet-50: the conv space's modest cut (no ledger yet)
    resnet, _, _ = _build(pt, lambda pkg: pt_resnet(
        pkg.layers.data(name='img', shape=[3, 32, 32], dtype='float32'),
        10, depth=50, is_test=True))
    assert tuner.candidates(resnet, {'img': np.zeros((1, 3, 32, 32))}) == \
        [{}] + CONV_SPACE
    assert tuner.last_pruned == len(tuning._CONV_SCHEDULE_SPACE) - 2
    # a compute-bound ledger would prune the conv space, a
    # bandwidth-bound one take all of it
    for bound, n in (('compute', 0), ('bandwidth', 6)):
        tuner._ledger_bound = lambda program, b=bound: b
        assert len(tuner.candidates(resnet, {})) == 1 + n
    assert tuning.Autotuner(pt.CPUPlace()).candidates(
        _build(pt, _chain)[0], {}) == [{}]


@pytest.mark.parametrize('peepholes, expect', [(False, [{}] + TILES),
                                               (True, [{}])])
def test_candidates_of_stacked_dynamic_lstm(peepholes, expect):
    main, _, _ = _build(pt, lambda pkg: stacked_dynamic_lstm(
        pkg, use_peepholes=peepholes, **SMALL_LSTM)[0])
    assert tuning.Autotuner(pt.CPUPlace()).candidates(main, {}) == expect


# ---- the search -------------------------------------------------------------------
def test_fault_in_a_candidate_is_poisoned_and_the_sweep_goes_on(tmp_path,
                                                               cache):
    main, startup, out = _build(pt, _conv)
    scope = _started(main, startup)
    tuner = tuning.Autotuner(pt.CPUPlace(), warmup=0, steps=1)
    journal = str(tmp_path / 'tune.jsonl')
    with obs.journal(journal):
        with fi.fault_plan() as plan:
            plan.inject(fi.SITE_TUNING_MEASURE, at=[1])
            best, report = tuner.tune(main, _conv_feed(), [out.name],
                                      scope=scope)
    poisoned = [t for t, v in report.items() if isinstance(v, str)]
    assert poisoned == [tuning.entry_token(CONV_SPACE[0])]
    assert 'FaultInjected' in report[poisoned[0]]
    assert sorted(t for t in report if t not in poisoned) == \
        sorted(['baseline', tuning.entry_token(CONV_SPACE[1])])
    assert all(isinstance(v, float) for t, v in report.items()
               if t not in poisoned)
    assert best in ({}, CONV_SPACE[1]) and len(cache) == 1
    records, _ = obs.read_journal(journal)
    phases = [r['phase'] for r in records if r['ev'] == 'autotune']
    assert phases == ['begin', 'candidate_poisoned', 'end']
    end = [r for r in records if r['ev'] == 'autotune'][-1]
    assert end['poisoned'] == 1 and end['candidates'] == 3
    assert end['report'] == report
    assert [r['ev'] for r in records].count('tuning_put') == 1


def test_tune_pins_the_candidate_over_a_cached_entry(cache, monkeypatch):
    """A search on a program that already has an entry measures each
    candidate's knobs, not the cached entry's."""
    main, startup, out = _build(pt, _conv)
    scope = _started(main, startup)
    feed = _conv_feed()
    exe = pt.Executor(pt.CPUPlace())
    sig = tuning.shape_signature(feed_signature(
        exe._prepare_feed(main, feed)))
    cache.put(main.fingerprint(), sig, 'cpu', {'conv_max_bn': 64},
              persist=False)
    seen = []
    conv = pt.core.registry.get_kernel('fused_conv')

    def spy(ctx):
        seen.append(tuning.knobs()['conv_max_bn'])
        return conv(ctx)
    monkeypatch.setitem(pt.core.registry._KERNELS, 'fused_conv', spy)
    tuning.Autotuner(pt.CPUPlace(), warmup=0, steps=1).tune(
        main, feed, [out.name], scope=scope, persist=False)
    assert seen == [256, 128, 256]


def _saved_conv(tmp_path):
    main, startup, out = _build(pt, _conv)
    scope = _started(main, startup)
    d = str(tmp_path / 'conv_model')
    pt_io.save_inference_model(d, ['x'], [out], pt.Executor(pt.CPUPlace()),
                               main_program=main, scope=scope)
    return d


def test_warmup_autotune_searches_each_bucket_once(tmp_path, cache):
    d = _saved_conv(tmp_path)
    journal = str(tmp_path / 'warm.jsonl')
    with obs.journal(journal):
        with ModelServer(place=pt.CPUPlace(), max_batch_size=8,
                         batch_timeout=0.0) as server:
            server.load_model('m', d)
            assert server.warmup(autotune=True) == {'m': [1, 2, 4, 8]}
            assert len(cache) == 4
            server.executor.reset_cache_info()
            assert server.warmup(autotune=True) == {'m': [1, 2, 4, 8]}
            assert server.cache_info().misses == 0
            out, = server.infer('m', _conv_feed(n=3))
            assert out.shape == (3, 2, 4, 4)
    records, _ = obs.read_journal(journal)
    evs = [r['ev'] for r in records]
    assert evs.index('tuning_preload') < evs.index('autotune')
    begins = [r for r in records if r['ev'] == 'autotune' and
              r['phase'] == 'begin']
    assert len(begins) == 4 and all(r['program'] == 'm' for r in begins)
    warm = [r for r in records if r['ev'] == 'serving_warmup']
    assert [r['autotune_searches'] for r in warm] == [4, 0]
    assert [r['buckets'] for r in warm] == [4, 4]
    # a fresh process's cache object on the same file: every entry
    # preloaded, no search
    fresh = tuning.TuningCache(cache.path)
    tuning.set_default_cache(fresh)
    with obs.journal(journal):
        with ModelServer(place=pt.CPUPlace(), max_batch_size=8,
                         batch_timeout=0.0) as server:
            server.load_model('m', d)
            server.warmup(autotune=True)
    records, _ = obs.read_journal(journal)
    preload, = [r for r in records if r['ev'] == 'tuning_preload']
    assert preload['entries'] == preload['loaded'] == 4
    assert 'autotune' not in [r['ev'] for r in records]


# ---- the knobs on the card's path -------------------------------------------------
def _stub_launches(monkeypatch, seen):
    """Every kernel launch recorded (no library is built), per thread:
    the flash backward's kernels by name, the LSTM cell's batch tile and
    the fused conv's (bn, splits) as the wrapper encoded them."""
    def who():
        return threading.current_thread().name

    def flash_stub(name, n_out):
        def fn(q, k, v, do, lse, delta, causal=True):
            seen[who()].append(name)
            outs = tuple(torch.empty_like(q) for _ in range(n_out))
            return outs[0] if n_out == 1 else outs
        return fn

    def launch(lib, fn_name, args, device, what):
        if fn_name == 'lstm_cell':
            seen[who()].append(('tile', args[-1]))
        else:
            a = ck._FusedConvArgs.from_address(args[0])
            seen[who()].append(('conv', a.bn, a.splits))
    monkeypatch.setattr(ck, '_on_card', lambda t, what: True)
    monkeypatch.setattr(ck, 'flash_bwd_dkvdq', flash_stub('dkvdq', 3))
    monkeypatch.setattr(ck, 'flash_bwd_dq', flash_stub('dq', 1))
    monkeypatch.setattr(ck, 'flash_bwd_dkv', flash_stub('dkv', 2))
    monkeypatch.setattr(ck, '_launch', launch)
    monkeypatch.setattr(ck, '_sm_count', lambda index: 132)
    monkeypatch.setattr(torch.cuda, 'current_device', lambda: 0)
    monkeypatch.setattr(ck, '_split_k_counters',
                        lambda device, n: torch.zeros(n, dtype=torch.int32))


def _conv_operands(N, H, C):
    x = torch.zeros(N, H, H, C, dtype=torch.bfloat16)
    w = torch.zeros(C, 3, 3, C, dtype=torch.bfloat16)
    return x, w


def _plan(x, w, entry):
    N, H, _, C = x.shape
    live = dict(tuning.KNOB_DEFAULTS, **entry)
    return ck.fused_conv_plan(torch.bfloat16, N, H, H, C, C, 3, 3, (1, 1),
                              (1, 1), False, 132, live['conv_max_bn'],
                              live['conv_max_splits'])


def test_two_threads_each_see_only_their_own_knobs(monkeypatch):
    seen = collections.defaultdict(list)
    _stub_launches(monkeypatch, seen)
    entries = {'a': {'flash_bwd_route': 'two_pass', 'conv_max_bn': 64,
                     'conv_max_splits': 1, 'lstm_batch_tile': 16},
               'b': {'conv_max_splits': 2, 'lstm_batch_tile': 64}}
    q = torch.empty(16, 2048, 8, 128, dtype=torch.bfloat16, device='meta')
    lse = torch.empty(16, 8, 2048, device='meta')
    B, H = 4, 16
    cell = (torch.zeros(B, 4 * H), torch.zeros(B, H), torch.zeros(B, H),
            torch.zeros(H, 4 * H))
    x, w = _conv_operands(1, 7, 512)
    barrier = threading.Barrier(2)
    errors = []

    def work(name):
        try:
            with tuning.apply_entry(entries[name]):
                barrier.wait(timeout=30)       # both entries are live
                for _ in range(3):
                    ck.flash_attention_bwd(q, q, q, q, lse, q)
                    ck._lstm_cell_kernel(*cell)
                    ck._fused_conv_launch(x, w, (), (), (), (1, 1),
                                          (1, 1), False)
                barrier.wait(timeout=30)
        except Exception as e:                  # noqa: BLE001
            errors.append(e)
    threads = [threading.Thread(target=work, args=(n,), name=n)
               for n in entries]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not errors and not any(t.is_alive() for t in threads)
    for name, entry in entries.items():
        plan = _plan(x, w, entry)
        route = ['dkv', 'dq'] if name == 'a' else ['dkvdq']
        assert seen[name] == 3 * (route + [
            ('tile', entry['lstm_batch_tile']),
            ('conv', plan.bn, plan.splits)])
    assert _plan(x, w, entries['a']) != _plan(x, w, entries['b'])
    assert tuning.knobs() == tuning.KNOB_DEFAULTS


def test_flash_route_is_taken_in_the_forward(monkeypatch):
    """Autograd runs a CUDA backward on a thread of its own, where no
    entry is live: the route comes from the forward's knobs."""
    routes = []

    def bwd(q, k, v, o, lse, do, causal=True, g_lse=None, route=None):
        routes.append(route)
        return torch.zeros_like(q), torch.zeros_like(k), torch.zeros_like(v)
    monkeypatch.setattr(ck, 'flash_attention_bwd', bwd)
    q = torch.randn(1, 8, 1, 32, requires_grad=True)
    with tuning.apply_entry({'flash_bwd_route': 'two_pass'}):
        out, _ = ck.flash_attention_with_lse(q, q, q)
    done = threading.Thread(target=lambda: out.sum().backward())
    done.start()
    done.join(timeout=30)
    out2, _ = ck.flash_attention_with_lse(q, q, q)
    out2.sum().backward()
    assert routes == ['two_pass', 'merged']


def test_conv_knobs_reach_the_plan_past_the_encoded_launch_cache(
        monkeypatch):
    seen = collections.defaultdict(list)
    _stub_launches(monkeypatch, seen)
    ck._encoded_launch.cache_clear()
    me = threading.current_thread().name
    # large M: the widest tile is the knob's; small M: the splits are
    for shape, entries in (((32, 28, 256), ({'conv_max_bn': 128},
                                            {'conv_max_bn': 64})),
                           ((1, 7, 512), ({'conv_max_splits': 1},
                                          {'conv_max_splits': 2}))):
        x, w = _conv_operands(*shape)
        plans = []
        for entry in ({},) + entries + ({},):
            del seen[me][:]
            with tuning.apply_entry(entry):
                ck._fused_conv_launch(x, w, (), (), (), (1, 1), (1, 1),
                                      False)
            plan = _plan(x, w, entry)
            assert seen[me] == [('conv', plan.bn, plan.splits)], entry
            plans.append((plan.bn, plan.splits))
        assert len(set(plans)) == 3, plans     # each entry its own plan
    ck.reset_launch_counts()


@pytest.mark.parametrize('knob', [('flash', 'sideways'), ('conv', 100)])
def test_an_invalid_forced_knob_raises_on_the_card(monkeypatch, knob):
    seen = collections.defaultdict(list)
    _stub_launches(monkeypatch, seen)
    if knob[0] == 'flash':
        q = torch.empty(1, 64, 1, 64, dtype=torch.bfloat16, device='meta')
        with pytest.raises(ValueError, match='route'):
            ck.flash_attention_bwd(q, q, q, q, torch.empty(
                1, 1, 64, device='meta'), q, route=knob[1])
    else:
        with pytest.raises(ValueError, match='max_bn'):
            ck.fused_conv_plan(torch.bfloat16, 1, 7, 7, 64, 64, 3, 3,
                               (1, 1), (1, 1), False, 132, max_bn=knob[1])


# ---- fingerprints -----------------------------------------------------------------
def _resnet(pkg):
    img = pkg.layers.data(name='img', shape=[3, 32, 32], dtype='float32')
    return (jax_resnet if pkg is fluid else pt_resnet)(img, 10, depth=50)


def _transformer(pkg):
    build = _jax_models().transformer if pkg is fluid else pt_transformer
    loss = build(None, vocab=64, d_model=32, n_heads=2, n_layers=2, d_ff=64,
                 seq=32)[0]
    pkg.optimizer.Adam(1e-3).minimize(loss)
    return loss


def _lstm(pkg):
    return stacked_dynamic_lstm(pkg, use_peepholes=False, **SMALL_LSTM)[0]


_BUILDERS = {'resnet50': _resnet, 'transformer_train': _transformer,
             'stacked_lstm': _lstm, 'conv': _conv}

_SUBPROCESS = r'''
import sys
sys.path.insert(0, %(tests)r)
import paddle_tpu_torch as pt
from paddle_tpu_torch import io as pt_io
import test_torch_tuning as t
for name in sorted(t._BUILDERS):
    main, startup, _ = t._build(pt, t._BUILDERS[name])
    print(name, main.fingerprint(), startup.fingerprint())
prog, _, _ = pt_io.load_inference_model(
    %(saved)r, pt.Executor(pt.CPUPlace()), scope=pt.Scope())
print('saved', prog.fingerprint(), '-')
'''


@pytest.mark.parametrize('name', sorted(_BUILDERS))
def test_fingerprint_matches_paddle_tpu(name):
    j_main, j_startup, _ = _build(fluid, _BUILDERS[name])
    t_main, t_startup, t_out = _build(pt, _BUILDERS[name])
    assert t_main.fingerprint() == j_main.fingerprint()
    assert t_startup.fingerprint() == j_startup.fingerprint()
    assert t_main.clone().fingerprint() == t_main.fingerprint()
    # cached per version: a mutation changes it
    before = t_main.fingerprint()
    t_main.global_block().append_op(type='scale', inputs={'X': [t_out]},
                                    outputs={'Out': [t_out]},
                                    attrs={'scale': 2.0})
    assert t_main.fingerprint() != before


def test_fingerprint_is_stable_across_processes_and_save_load(tmp_path):
    saved = _saved_conv(tmp_path)
    loaded = [pt_io.load_inference_model(
        saved, pt.Executor(pt.CPUPlace()), scope=pt.Scope())[0].fingerprint()
        for _ in range(2)]
    assert loaded[0] == loaded[1]
    here = {}
    for name, build in _BUILDERS.items():
        main, startup, _ = _build(pt, build)
        here[name] = [main.fingerprint(), startup.fingerprint()]
    here['saved'] = [loaded[0], '-']
    # another interpreter, another hash seed
    proc = subprocess.run(
        [sys.executable, '-c', _SUBPROCESS % dict(
            tests=os.path.join(_ROOT, 'tests'), saved=saved)],
        capture_output=True, text=True, timeout=300,
        env=dict(os.environ, PYTHONHASHSEED='123',
                 PYTHONPATH=_ROOT + os.pathsep + os.environ.get(
                     'PYTHONPATH', '')))
    assert proc.returncode == 0, proc.stderr
    there = {line.split()[0]: line.split()[1:]
             for line in proc.stdout.splitlines()}
    assert there == here
