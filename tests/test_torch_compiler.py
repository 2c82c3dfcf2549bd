"""The compiler's pass pipeline: paddle_tpu_torch against paddle_tpu, on
the CPU.

Five programs are built twice, with each package's own layers under
fresh unique-name generators: a fit-a-line MLP with an SGD step, an
elementwise chain with a constant subgraph and a dead branch, a
constant subgraph through transpose, cast and one_hot, a conv +
batch-norm net, and the flagship transformer (2 layers, d_model 32,
seq 32). Each pass alone, ``DEFAULT_PASSES`` and
``INFERENCE_PASSES`` run over each program in both packages; the
rewritten programs must match op for op (types, slots, argument names,
attrs, the fused regions' captured ops and the baked constants to 1e-6).
The exact passes change no output (bit for bit); the whole pipeline's
outputs match the JAX package's (its fused conv on the Pallas kernel in
interpret mode) to 1e-5 per op and 1e-4 for the flagship; ``bn_fold``
stays within 1e-5 of the unfolded program, as tests/test_compiler.py
holds the JAX package's.
"""
import importlib.util
import os
import threading

import numpy as np
import pytest
import torch

import paddle_tpu.fluid as fluid
import paddle_tpu.compiler as jax_compiler
from paddle_tpu.compiler import tuning as ctuning
from paddle_tpu.ops import pallas_kernels as pk
import paddle_tpu_torch as pt
from paddle_tpu_torch import executor as pt_executor
from paddle_tpu_torch import io as pt_io
from paddle_tpu_torch.analysis.infer import _canon
from paddle_tpu_torch.compiler import passes as pt_passes
from paddle_tpu_torch.core.lowering import BlockRunner
from paddle_tpu_torch.models.fluid_transformer import transformer as \
    pt_transformer

from test_torch_conv import randomize_batch_norms

TOL = dict(atol=1e-5, rtol=1e-5)
MODEL_TOL = dict(atol=1e-4, rtol=1e-4)
DIMS = dict(vocab=64, d_model=32, n_heads=2, n_layers=2, d_ff=64, seq=32)
_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PIPELINES = {name: (name,) for name in pt.compiler.registered_passes()}
PIPELINES.update(default=pt.compiler.DEFAULT_PASSES,
                 inference=pt.compiler.INFERENCE_PASSES)
EXACT = ('constant_fold', 'dead_op_elim', 'elementwise_fuse',
         'buffer_reuse')


@pytest.fixture(autouse=True)
def _defaults():
    """Both packages' pipelines at their defaults, a throwaway tuning
    cache on the JAX side, the port's fallback counts from zero."""
    prev = ctuning.set_default_cache(
        ctuning.TuningCache(path='/nonexistent/paddle-tpu-test-tuning'))
    pt_passes.reset_fallback_counts()
    yield
    for c in (jax_compiler, pt.compiler):
        c.set_enabled(True)
        c.set_default_passes(None)
    ctuning.set_default_cache(prev)


def _jax_models():
    spec = importlib.util.spec_from_file_location(
        '_bench_fluid_models',
        os.path.join(_ROOT, 'benchmark', 'fluid', 'models.py'))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# ---- the programs -----------------------------------------------------------------
def _mlp(pkg):
    L = pkg.layers
    x = L.data(name='x', shape=[13], dtype='float32')
    h = L.fc(input=x, size=16, act='relu')
    pred = L.fc(input=h, size=1, act=None)
    y = L.data(name='y', shape=[1], dtype='float32')
    loss = L.mean(L.square(L.elementwise_sub(pred, y)))
    pkg.optimizer.SGD(learning_rate=0.01).minimize(loss)
    return loss


def _chain(pkg):
    L = pkg.layers
    x = L.data(name='x', shape=[16], dtype='float32')
    c1 = L.fill_constant(shape=[16], dtype='float32', value=2.0)
    c2 = L.fill_constant(shape=[16], dtype='float32', value=3.0)
    c3 = L.elementwise_mul(c1, c2)
    t = L.relu(L.scale(x, scale=2.0))
    t = L.elementwise_add(t, c3)
    out = L.tanh(t)
    L.scale(x, scale=5.0)                      # dead: never fetched
    return out


def _fold_tensor_ops(pkg):
    """A constant subgraph through transpose, cast and one_hot, which
    constant_fold evaluates with the ops' kernels now that the port has
    them; the int64 ids it casts are read by a lookup_table, which does
    not fold, so they are baked (int64 in the port, int32 in the JAX
    package, which runs int64 as int32)."""
    L = pkg.layers
    x = L.data(name='x', shape=[4, 3], dtype='float32')
    c = L.transpose(L.fill_constant(shape=[3, 4], dtype='float32',
                                    value=1.5), perm=[1, 0])
    ids = L.cast(L.fill_constant(shape=[4, 1], dtype='float32', value=2.0),
                 'int64')
    k = L.elementwise_mul(c, L.one_hot(ids, depth=3))
    emb = L.embedding(input=ids, size=[5, 3])
    return L.elementwise_add(L.elementwise_add(x, k), emb)


def _conv_bn(pkg):
    L = pkg.layers
    t = L.data(name='x', shape=[3, 8, 8], dtype='float32')
    for _ in range(2):
        c = L.conv2d(input=t, num_filters=4, filter_size=3, padding=1,
                     bias_attr=False)
        t = L.relu(L.batch_norm(input=c, is_test=True))
    return L.mean(t)


def _flagship(pkg):
    """The flagship's logits (the loss's part is dead for them)."""
    if pkg is fluid:
        _jax_models().transformer(None, **DIMS)
    else:
        pt_transformer(None, **DIMS)
    block = pkg.default_main_program().global_block()
    xent, = [op for op in block.ops
             if op.type == 'softmax_with_cross_entropy']
    return block.var(xent.input('Logits')[0])


def _flagship_feed(seed=3, bs=2):
    rng = np.random.RandomState(seed)
    return {'data': rng.randint(0, DIMS['vocab'],
                                (bs, DIMS['seq'])).astype('int64'),
            'pos': np.tile(np.arange(DIMS['seq'], dtype='int64'), (bs, 1))}


def _dense_feed(shapes, seed=3):
    rng = np.random.RandomState(seed)
    return {n: rng.randn(*s).astype('float32') for n, s in shapes.items()}


# name -> (build, feed, training?)
PROGRAMS = {
    'mlp': (_mlp, lambda: _dense_feed({'x': (8, 13), 'y': (8, 1)}), True),
    'chain': (_chain, lambda: _dense_feed({'x': (4, 16)}), False),
    'conv_bn': (_conv_bn, lambda: _dense_feed({'x': (2, 3, 8, 8)}), False),
    'fold_tensor_ops': (_fold_tensor_ops,
                        lambda: _dense_feed({'x': (2, 4, 3)}), False),
    'flagship': (_flagship, _flagship_feed, False),
}


def _train_flagship(pkg):
    if pkg is fluid:
        loss = _jax_models().transformer(None, **DIMS)[0]
    else:
        loss = pt_transformer(None, **DIMS)[0]
    pkg.optimizer.Adam(learning_rate=1e-3).minimize(loss)
    return loss


def _train_flagship_feed():
    return dict(_flagship_feed(), label=np.random.RandomState(5).randint(
        0, DIMS['vocab'], (2, DIMS['seq'], 1)).astype('int64'))


# the training programs buffer_reuse is held on
TRAINING = {'mlp': PROGRAMS['mlp'],
            'flagship': (_train_flagship, _train_flagship_feed, True)}


class Pair(object):
    """One program in both packages, on the same numpy state (every
    batch norm's statistics and affine randomized)."""

    def __init__(self, name, programs=PROGRAMS):
        build, feed, self.training = programs[name]
        self.feed = feed()
        self.j_main, j_startup, self.j_out = self._build(fluid, build)
        self.t_main, _, self.t_out = self._build(pt, build)
        j_scope = fluid.Scope()
        fluid.Executor(fluid.CPUPlace()).run(j_startup, scope=j_scope)
        self.state = randomize_batch_norms(self.j_main, {
            v.name: np.asarray(j_scope.raw(v.name))
            for v in j_startup.list_vars()
            if j_scope.raw(v.name) is not None})

    @staticmethod
    def _build(pkg, build):
        main, startup = pkg.Program(), pkg.Program()
        main.random_seed = startup.random_seed = 7
        with pkg.unique_name.guard(), pkg.program_guard(main, startup):
            out = build(pkg)
        return main, startup, out

    def j_scope(self):
        scope = fluid.Scope()
        for n, a in self.state.items():
            scope.set_var(n, a.copy())
        return scope

    def t_scope(self):
        scope = pt.Scope()
        pt_io.params_from_numpy(scope, self.state, pt.CPUPlace())
        return scope

    def fetches(self):
        names = [self.t_out.name]
        if self.training:
            names += sorted(v.name for v in self.t_main.list_vars()
                            if v.name.endswith('@GRAD'))
        return names

    def run_port(self, main=None, scope=None, steps=1):
        scope = scope or self.t_scope()
        exe = pt.Executor(pt.CPUPlace())
        return [exe.run(main or self.t_main, feed=self.feed,
                        fetch_list=self.fetches(), scope=scope)
                for _ in range(steps)], scope


_PAIRS = {}


def _pair(name):
    """The shared Pair of a program, for tests that only read it: the
    pipelines clone, and each run takes fresh scopes."""
    if name not in _PAIRS:
        _PAIRS[name] = Pair(name)
    return _PAIRS[name]


def _norm(v):
    """An attr value in comparable form: arrays to (dtype, shape) plus
    the values, checked apart; tuples as lists."""
    if isinstance(v, np.ndarray) or hasattr(v, '__array__') and \
            not isinstance(v, (list, tuple, str)):
        return ('array',)
    if isinstance(v, tuple):
        return [_norm(e) for e in v]
    if isinstance(v, list):
        return [_norm(e) for e in v]
    if isinstance(v, dict):
        return {k: _norm(e) for k, e in v.items()}
    return v


def _descs(program):
    """Each op's type, slots and attrs; a baked constant's dtype under the
    analysis' names (the JAX package runs int64 as int32), its values
    checked apart."""
    return [(op.type, sorted(op.inputs.items()), sorted(op.outputs.items()),
             sorted((k, _canon(v) if op.type == 'assign_value' and
                     k == 'dtype' else _norm(v))
                    for k, v in op.attrs.items()))
            for op in program.global_block().ops]


def _baked(program):
    return [(op.attrs['dtype'], np.asarray(op.attrs['values']))
            for op in program.global_block().ops
            if op.type == 'assign_value']


def _run_both(pair, pipeline):
    """Each package's pipeline over its program; the JAX side's and the
    port's rewritten programs and scopes."""
    protected = [pair.t_out.name]
    j_scope, t_scope = pair.j_scope(), pair.t_scope()
    j_opt, j_res = jax_compiler.PassPipeline(list(pipeline)).run(
        pair.j_main, scope=j_scope, protected=protected)
    t_opt, t_res = pt.compiler.PassPipeline(list(pipeline)).run(
        pair.t_main, scope=t_scope, protected=protected)
    return j_opt, j_res, j_scope, t_opt, t_res, t_scope


@pytest.mark.parametrize('pipeline', sorted(PIPELINES))
@pytest.mark.parametrize('program', sorted(PROGRAMS))
def test_rewritten_program_matches_jax(program, pipeline):
    pair = _pair(program)
    j_opt, j_res, j_scope, t_opt, t_res, t_scope = _run_both(
        pair, PIPELINES[pipeline])
    assert _descs(t_opt) == _descs(j_opt)
    assert [(r.pass_name, bool(r.changed), r.ops_removed, r.ops_fused,
             r.ops_folded, r.vars_released) for r in t_res] == \
        [(r.pass_name, bool(r.changed), r.ops_removed, r.ops_fused,
          r.ops_folded, r.vars_released) for r in j_res]
    for (jd, jv), (td, tv) in zip(_baked(j_opt), _baked(t_opt)):
        # the JAX package runs int64 as int32: dtypes under the names the
        # analysis maps both to, as its verifier compares them
        assert _canon(td) == _canon(jd)
        np.testing.assert_allclose(tv, jv, atol=1e-6, rtol=1e-6)
    # bn_fold rewrites the scope: the folded weights and biases agree
    for v in t_opt.list_vars():
        if v.persistable and t_scope.raw(v.name) is not None:
            np.testing.assert_allclose(
                t_scope.raw(v.name).numpy(),
                np.asarray(j_scope.raw(v.name)), atol=1e-6, rtol=1e-6,
                err_msg=v.name)


def test_the_pipelines_are_jaxs():
    assert pt.compiler.DEFAULT_PASSES == jax_compiler.DEFAULT_PASSES
    assert pt.compiler.INFERENCE_PASSES == jax_compiler.INFERENCE_PASSES
    assert set(pt.compiler.registered_passes()) <= set(
        jax_compiler.registered_passes())


@pytest.mark.parametrize('name', EXACT)
@pytest.mark.parametrize('program', sorted(PROGRAMS))
def test_exact_pass_changes_no_output(program, name):
    """Outputs with the pass alone and raw, bit for bit (three steps of
    the MLP: losses, gradients and the parameters after them)."""
    pair = _pair(program)
    steps = 3 if pair.training else 1
    pt.compiler.set_default_passes([name])
    got, g_scope = pair.run_port(steps=steps)
    with pt.compiler.disabled():
        raw, r_scope = pair.run_port(steps=steps)
    for a, b in zip(got, raw):
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)
    for n in pair.state:
        np.testing.assert_array_equal(g_scope.raw(n).numpy(),
                                      r_scope.raw(n).numpy())


@pytest.mark.parametrize('program', sorted(PROGRAMS))
def test_default_pipeline_matches_jax(program):
    """The Executors' default pipelines (JAX's fused conv on its Pallas
    kernel in interpret mode) give the same outputs, and the port's
    whole pipeline stays within 1e-5 of its raw run."""
    pair = _pair(program)
    with pk.force_conv_epilogue('interpret'):
        j = fluid.Executor(fluid.CPUPlace()).run(
            pair.j_main, feed=pair.feed, fetch_list=pair.fetches(),
            scope=pair.j_scope())
    (t,), _ = pair.run_port()
    assert pt_passes.FALLBACKS == {}
    tol = MODEL_TOL if program == 'flagship' else TOL
    for name, a, b in zip(pair.fetches(), t, j):
        np.testing.assert_allclose(a, np.asarray(b), err_msg=name, **tol)
    with pt.compiler.disabled():
        (raw,), _ = pair.run_port()
    for name, a, b in zip(pair.fetches(), t, raw):
        np.testing.assert_allclose(a, b, err_msg=name, **tol)


@pytest.mark.parametrize('program', ['conv_bn', 'mlp', 'flagship'])
def test_bn_fold_within_tolerance(program):
    """optimize_inference in place, as the Inferencer runs it: no
    batch_norm op left, outputs within 1e-5 of the unfolded program and
    of the JAX package's folded program."""
    pair = _pair(program)
    if pair.training:
        main = pair.t_main.clone(for_test=True).prune([pair.t_out])
        j_main = pair.j_main.clone(for_test=True).prune([pair.j_out])
    else:
        main, j_main = pair.t_main.clone(), pair.j_main.clone()
    exe = pt.Executor(pt.CPUPlace())
    scope = pair.t_scope()
    ref, = exe.run(main, feed=pair.feed, fetch_list=[pair.t_out.name],
                   scope=scope)
    pt.compiler.optimize_inference(main, scope=scope,
                                   fetch_names=[pair.t_out.name])
    assert 'batch_norm' not in [op.type for op in main.global_block().ops]
    got, = exe.run(main, feed=pair.feed, fetch_list=[pair.t_out.name],
                   scope=scope)
    np.testing.assert_allclose(got, ref, **TOL)
    j_scope = pair.j_scope()
    jax_compiler.optimize_inference(j_main, scope=j_scope,
                                    fetch_names=[pair.t_out.name])
    with pk.force_conv_epilogue('interpret'):
        j, = fluid.Executor(fluid.CPUPlace()).run(
            j_main, feed=pair.feed, fetch_list=[pair.t_out.name],
            scope=j_scope)
    np.testing.assert_allclose(got, np.asarray(j), **TOL)


@pytest.mark.parametrize('name', sorted(PIPELINES['inference']))
@pytest.mark.parametrize('program', sorted(PROGRAMS))
def test_pass_is_idempotent(program, name):
    pair = _pair(program)
    pipe = pt.compiler.PassPipeline([name])
    once, _ = pipe.run(pair.t_main, scope=pair.t_scope(),
                       protected=[pair.t_out.name])
    version = once._version
    twice, (res,) = pipe.run(once, scope=pair.t_scope(),
                             protected=[pair.t_out.name], clone=False)
    assert not res.changed
    assert twice._version == version
    assert _descs(twice) == _descs(once)


def test_toggling_the_pipeline_misses_exactly_once():
    pair = Pair('conv_bn')
    exe = pt.Executor(pt.CPUPlace())
    scope = pair.t_scope()

    def run():
        return exe.run(pair.t_main, feed=pair.feed,
                       fetch_list=[pair.t_out], scope=scope)[0]

    base = run()
    assert exe.cache_info()[:2] == (0, 1)
    exe.reset_cache_info()
    run()
    assert exe.cache_info()[:2] == (1, 0)
    for toggle in (lambda: pt.compiler.set_enabled(False),
                   lambda: pt.compiler.set_enabled(True),
                   lambda: pt.compiler.set_default_passes(
                       ['conv_epilogue_fuse']),
                   lambda: pt.compiler.set_default_passes(None)):
        toggle()
        exe.reset_cache_info()
        out = run()
        run()
        np.testing.assert_allclose(out, base, **TOL)
        misses = 1 if pt.compiler.pipeline_signature() in (
            ('off',), ('conv_epilogue_fuse',)) else 0
        assert exe.cache_info()[:2] == (2 - misses, misses), toggle
    # the token is the pipeline plus the tuning entry's token ('-': none)
    assert pt.compiler.cache_token('no-such-program', (), exe.device) == \
        pt.compiler.pipeline_signature() + ('-',)
    assert exe.cache_info().size == 3


def test_a_cold_lowering_does_not_block_a_hit(monkeypatch):
    """The memo's lock covers the lookup and the insert, not the
    lowering: while one program's lowering is wedged, another program's
    warm request is served from the memo."""
    warm, cold = Pair('chain'), Pair('conv_bn')
    exe = pt.Executor(pt.CPUPlace())
    warm_scope = warm.t_scope()

    def run_warm():
        return exe.run(warm.t_main, feed=warm.feed,
                       fetch_list=[warm.t_out], scope=warm_scope)[0]

    base = run_warm()
    entered, release = threading.Event(), threading.Event()
    real = pt_executor.lower_block

    def wedged(program, *args):
        if any(op.type == 'fused_conv'
               for op in program.global_block().ops):
            entered.set()
            assert release.wait(30)
        return real(program, *args)

    monkeypatch.setattr(pt_executor, 'lower_block', wedged)
    cold_out = []
    cold_thread = threading.Thread(target=lambda: cold_out.append(
        exe.run(cold.t_main, feed=cold.feed, fetch_list=[cold.t_out],
                scope=cold.t_scope())[0]))
    cold_thread.start()
    try:
        assert entered.wait(30)
        exe.reset_cache_info()
        warm_out = []
        warm_thread = threading.Thread(
            target=lambda: warm_out.append(run_warm()))
        warm_thread.start()
        warm_thread.join(30)
        assert warm_out, 'a hit waited for another program\'s lowering'
        np.testing.assert_array_equal(warm_out[0], base)
        assert exe.cache_info()[:2] == (1, 0)
    finally:
        release.set()
        cold_thread.join(30)
    assert cold_out and exe.cache_info()[:3] == (1, 0, 2)


def test_constant_fold_folds_tensor_ops_like_jax():
    """transpose, cast and one_hot fold in the port as in paddle_tpu: the
    same ops folded and left, the same baked constants (the cast ids
    int64 in the port, int32 in paddle_tpu: equal under the analysis'
    dtype names), and the folded program's output equal to the raw
    one's."""
    pair = Pair('fold_tensor_ops')
    j_opt, j_res, _, t_opt, t_res, _ = _run_both(pair, ('constant_fold',))
    assert t_res[0].ops_folded == j_res[0].ops_folded == 4
    assert [op.type for op in t_opt.global_block().ops] == \
        [op.type for op in j_opt.global_block().ops]
    assert not {'transpose', 'cast', 'one_hot'} & {
        op.type for op in t_opt.global_block().ops}
    t_dtypes = [d for d, _ in _baked(t_opt)]
    assert [_canon(d) for d in t_dtypes] == \
        [_canon(d) for d, _ in _baked(j_opt)]
    assert 'int64' in t_dtypes
    pt.compiler.set_default_passes(['constant_fold'])
    (got,), _ = pair.run_port()
    with pt.compiler.disabled():
        (raw,), _ = pair.run_port()
    np.testing.assert_array_equal(got[0], raw[0])


def test_constant_fold_keeps_int64_values():
    """A folded constant keeps the port's own dtype and value: an int64
    sum past 2**31 is baked as int64 and comes out of the folded program
    as out of the raw one (the JAX package, which runs int64 as int32,
    would wrap it)."""
    main, startup = pt.Program(), pt.Program()
    with pt.unique_name.guard(), pt.program_guard(main, startup):
        L = pt.layers
        i = L.data(name='i', shape=[1], dtype='int64')
        big = L.elementwise_add(
            L.fill_constant(shape=[1], dtype='int64', value=2000000000),
            L.fill_constant(shape=[1], dtype='int64', value=1000000001))
        out = L.elementwise_add(i, big)
    feed = {'i': np.array([[5]], np.int64)}

    def run():
        got, = pt.Executor(pt.CPUPlace()).run(main, feed=feed,
                                              fetch_list=[out],
                                              scope=pt.Scope())
        return got
    pt.compiler.set_default_passes(['constant_fold'])
    folded = run()
    with pt.compiler.disabled():
        raw = run()
    opt, res = pt.compiler.PassPipeline(['constant_fold']).run(
        main, scope=pt.Scope(), protected=[out.name])
    assert res[0].ops_folded == 1
    (dtype, values), = _baked(opt)
    assert dtype == 'int64' and values.tolist() == [3000000001]
    assert folded.dtype == raw.dtype == np.int64
    np.testing.assert_array_equal(folded, raw)
    np.testing.assert_array_equal(folded, [[3000000006]])


def test_folded_constant_is_made_once():
    """constant_fold's baked assign_value makes its device tensor once
    per op and device; later runs reuse it."""
    pair = Pair('chain')
    opt, _ = pt.compiler.optimize(pair.t_main,
                                  fetch_names=[pair.t_out.name])
    const, = [op for op in opt.global_block().ops
              if op.type == 'assign_value']
    runner = BlockRunner(opt.global_block(), torch.device('cpu'),
                         keep=frozenset(const.output_arg_names))
    made = []
    for _ in range(2):
        env = {'x': torch.as_tensor(pair.feed['x'])}
        runner.run_ops(opt.global_block().ops, env)
        made.append(env[const.output('Out')[0]])
    assert made[0] is made[1]
    np.testing.assert_array_equal(made[0].numpy(), np.full(16, 6.0))


@pytest.mark.parametrize('program', sorted(TRAINING))
def test_buffer_reuse_leaves_training_bit_equal(program):
    """Training steps with the default pipeline and with it less
    buffer_reuse: the losses, every gradient and the parameters after
    them agree bit for bit."""
    pair = Pair(program, TRAINING)
    results = []
    for passes in (pt.compiler.DEFAULT_PASSES,
                   [p for p in pt.compiler.DEFAULT_PASSES
                    if p != 'buffer_reuse']):
        pt.compiler.set_default_passes(passes)
        results.append(pair.run_port(steps=2))
    pt.compiler.set_default_passes(None)
    _, res = pt.compiler.optimize(pair.t_main, fetch_names=pair.fetches())
    assert res[-1].vars_released > 0
    (a, a_scope), (b, b_scope) = results
    for x, y in zip(a, b):
        for u, v in zip(x, y):
            np.testing.assert_array_equal(u, v)
    for n in pair.state:
        np.testing.assert_array_equal(a_scope.raw(n).numpy(),
                                      b_scope.raw(n).numpy())


def test_release_annotations_drop_values_but_keep_guarded_names():
    pair = Pair('chain')
    opt, _ = pt.compiler.optimize(pair.t_main,
                                  fetch_names=[pair.t_out.name])
    released = {n for op in opt.global_block().ops
                for n in op.attrs.get('__release__', ())}
    assert 'x' in released
    env = {'x': torch.as_tensor(pair.feed['x'])}
    BlockRunner(opt.global_block(), torch.device('cpu')).run_ops(
        opt.global_block().ops, env)
    assert 'x' not in env and pair.t_out.name in env
    env = {'x': torch.as_tensor(pair.feed['x'])}
    BlockRunner(opt.global_block(), torch.device('cpu'),
                keep=frozenset(['x'])).run_ops(opt.global_block().ops, env)
    assert 'x' in env


# ---- elementwise chains absorbed into a fused conv ----------------------------------
def _absorb_net(train):
    def build(pkg):
        L = pkg.layers
        x = L.data(name='x', shape=[4, 8, 8], dtype='float32')
        c = L.conv2d(input=x, num_filters=6, filter_size=3, padding=1,
                     bias_attr=False)
        b = L.batch_norm(input=c, is_test=not train)
        out = L.scale(L.relu(L.scale(b, scale=1.5, bias=0.25)), scale=0.5)
        if train:
            out = L.mean(out)
            pkg.optimizer.SGD(learning_rate=0.1).minimize(out)
        return out
    return build


@pytest.mark.parametrize('train', [False, True])
def test_chain_absorbed_into_fused_conv_matches_jax(train):
    """conv_epilogue_fuse stops at a protected name (the batch norm's
    output); a second pipeline without that protection lets
    elementwise_fuse absorb the chain behind it into the fused conv's
    epilogue, in both packages alike. The port runs the absorbed region
    as one fused conv (no replay), the JAX package as one Pallas kernel
    in interpret mode; with a train-mode batch norm (the stats form) the
    loss and every gradient agree too."""
    build = _absorb_net(train)
    j_main, j_startup, j_out = Pair._build(fluid, build)
    t_main, _, t_out = Pair._build(pt, build)
    bn_y = [op for op in t_main.global_block().ops
            if op.type == 'batch_norm'][0].output('Y')[0]
    outs = []
    for comp, main in ((jax_compiler, j_main), (pt.compiler, t_main)):
        first, _ = comp.PassPipeline(['conv_epilogue_fuse']).run(
            main, protected=[t_out.name, bn_y])
        second, res = comp.PassPipeline(['elementwise_fuse']).run(
            first, protected=[t_out.name])
        assert res[0].ops_fused == 3
        outs.append(second)
    assert _descs(outs[1]) == _descs(outs[0])
    fused = [op for op in outs[1].global_block().ops
             if op.type == 'fused_conv']
    assert [op.attrs['fused_types'] for op in fused] == [
        ['conv2d', 'batch_norm', 'scale', 'relu', 'scale']]
    assert bool(fused[0].outputs.get('Stats')) == train

    j_scope = fluid.Scope()
    fluid.Executor(fluid.CPUPlace()).run(j_startup, scope=j_scope)
    state = randomize_batch_norms(j_main, {
        v.name: np.asarray(j_scope.raw(v.name))
        for v in j_startup.list_vars() if j_scope.raw(v.name) is not None})
    feed = _dense_feed({'x': (2, 4, 8, 8)})
    fetch = [t_out.name] + (sorted(v.name for v in t_main.list_vars()
                                   if v.name.endswith('@GRAD'))
                            if train else [])
    for n, a in state.items():
        j_scope.set_var(n, a)
    jax_compiler.set_enabled(False)      # the rewritten program as it is
    with pk.force_conv_epilogue('interpret'):
        j = fluid.Executor(fluid.CPUPlace()).run(
            outs[0], feed=feed, fetch_list=fetch, scope=j_scope)
    t_scope = pt.Scope()
    pt_io.params_from_numpy(t_scope, state, pt.CPUPlace())
    with pt.compiler.disabled():
        t = pt.Executor(pt.CPUPlace()).run(outs[1], feed=feed,
                                           fetch_list=fetch, scope=t_scope)
    assert pt_passes.FALLBACKS == {}
    for name, a, b in zip(fetch, t, j):
        np.testing.assert_allclose(a, np.asarray(b), err_msg=name, **TOL)
