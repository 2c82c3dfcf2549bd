"""The training slice: paddle_tpu_torch against paddle_tpu, on the CPU.

Each program is built twice, with each package's own layers and
optimizer under fresh unique-name generators, so both name their
variables alike. The JAX package runs its startup program; its whole
startup scope (parameters, learning rate, Adam's moments and beta
powers) is carried into the port with ``io.params_from_numpy``. Both
Executors then run the same numpy feeds, f32 with AMP off on both sides.

Tolerances: loss and every ``<param>@GRAD`` to 1e-4 relative (f32 sums
in another order through the whole model; measured ~2e-6), parameters
and scalar accumulators to 1e-5 absolute (an Adam step moves a parameter
by at most about lr = 1e-3, so this is 1% of a step; measured ~2e-6),
moments and velocities to 1e-4 relative, elementwise, with an absolute
floor of 1e-4 of the array's largest magnitude, at most 1e-5 (moment2 is
~1e-7 at this size, so 1e-5 absolute alone would hold nothing; measured
max error / max magnitude ~2e-6).
"""
import importlib.util
import os

import jax
import numpy as np
import pytest

import paddle_tpu.fluid as fluid
from paddle_tpu.ops import pallas_kernels as pk
import paddle_tpu_torch as pt
from paddle_tpu_torch import io as pt_io
from paddle_tpu_torch.models.fluid_transformer import transformer as \
    pt_transformer

DIMS = dict(vocab=128, d_model=64, n_heads=2, n_layers=2, d_ff=128, seq=256)
REL = 1e-4
ATOL_STATE = 1e-5
_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _jax_models():
    spec = importlib.util.spec_from_file_location(
        '_bench_fluid_models',
        os.path.join(_ROOT, 'benchmark', 'fluid', 'models.py'))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _ops(program):
    return [(op.type, sorted(op.inputs.items()), sorted(op.outputs.items()))
            for op in program.global_block().ops]


def _build(pkg, build, seed=11):
    main, startup = pkg.Program(), pkg.Program()
    startup.random_seed = seed
    with pkg.unique_name.guard(), pkg.program_guard(main, startup):
        loss = build(pkg)
    return main, startup, loss


def _rel_err(got, ref):
    ref = np.asarray(ref)
    return np.abs(np.asarray(got) - ref).max() / max(np.abs(ref).max(),
                                                     1e-30)


def _assert_state_close(name, j, t, rtol=0):
    atol = ATOL_STATE
    if '_moment' in name or '_velocity' in name:
        # accumulators can sit far below ATOL_STATE (moment2 ~1e-7 in the
        # flagship): hold them relative to their own size as well
        scale = np.abs(j).max()
        assert scale > 0, name
        atol, rtol = min(atol, REL * scale), REL
    np.testing.assert_allclose(t, j, atol=atol, rtol=rtol, err_msg=name)


class Pair(object):
    """One training program in both packages, the port's scope carried
    over from the JAX package's startup scope."""

    def __init__(self, build, seed=11):
        self.j_main, j_startup, self.j_loss = _build(fluid, build, seed)
        self.t_main, _, self.t_loss = _build(pt, build, seed)
        self.j_scope = fluid.Scope()
        self.j_exe = fluid.Executor(fluid.CPUPlace())
        self.j_exe.run(j_startup, scope=self.j_scope)
        self.state_names = [v.name for v in j_startup.list_vars()
                            if self.j_scope.raw(v.name) is not None]
        self.t_scope = pt.Scope()
        pt_io.params_from_numpy(
            self.t_scope, {n: np.asarray(self.j_scope.raw(n))
                           for n in self.state_names}, pt.CPUPlace())
        self.t_exe = pt.Executor(pt.CPUPlace())
        self.grad_names = sorted(v.name for v in self.t_main.list_vars()
                                 if v.name.endswith('@GRAD'))

    def step(self, feed, fetch_grads=False):
        names = self.grad_names if fetch_grads else []
        j = self.j_exe.run(self.j_main, feed=feed,
                           fetch_list=[self.j_loss] + names,
                           scope=self.j_scope)
        t = self.t_exe.run(self.t_main, feed=feed,
                           fetch_list=[self.t_loss] + names,
                           scope=self.t_scope)
        return [np.asarray(a) for a in j], t

    def state(self, name):
        return (np.asarray(self.j_scope.raw(name)),
                self.t_scope.raw(name).numpy())


# ---- the flagship transformer, small -----------------------------------------
def _flagship(pkg):
    if pkg is fluid:
        loss = _jax_models().transformer(None, **DIMS)[0]
    else:
        loss = pt_transformer(None, **DIMS)[0]
    pkg.optimizer.Adam(learning_rate=1e-3).minimize(loss)
    return loss


def _lm_feed(step):
    rng = np.random.RandomState(100 + step)
    return {'data': rng.randint(0, DIMS['vocab'],
                                (2, DIMS['seq'])).astype('int64'),
            'label': rng.randint(0, DIMS['vocab'],
                                 (2, DIMS['seq'], 1)).astype('int64'),
            'pos': np.tile(np.arange(DIMS['seq'], dtype='int64'), (2, 1))}


@pytest.fixture(scope='module')
def flagship():
    pair = Pair(_flagship)
    initial = {n: pair.state(n)[1].copy() for n in pair.state_names}
    losses, first_grads = [], None
    for step in range(3):
        j, t = pair.step(_lm_feed(step), fetch_grads=step == 0)
        losses.append((j[0], t[0]))
        if step == 0:
            first_grads = list(zip(pair.grad_names, j[1:], t[1:]))
    return dict(pair=pair, losses=losses, grads=first_grads,
                initial=initial)


def test_flagship_program_matches_jax(flagship):
    pair = flagship['pair']
    assert _ops(pair.t_main) == _ops(pair.j_main)
    types = [op.type for op in pair.t_main.global_block().ops]
    assert types.count('backward_marker') == 1
    assert types.count('adam') == len(pair.t_main.global_block()
                                      .all_parameters())
    # the carried state: every parameter, its two moments, lr, beta powers
    assert len(pair.state_names) == 3 * types.count('adam') + 3


@pytest.mark.parametrize('step', [0, 1, 2])
def test_flagship_loss_matches_jax(flagship, step):
    j, t = flagship['losses'][step]
    assert t.shape == (1,) and np.isfinite(t).all()
    assert _rel_err(t, j) <= REL


def test_flagship_grads_match_jax(flagship):
    grads = flagship['grads']
    assert len(grads) == len(flagship['pair'].t_main.global_block()
                             .all_parameters())
    for name, j, t in grads:
        assert t.shape == j.shape, name
        assert _rel_err(t, j) <= REL, name


@pytest.mark.parametrize('kind', ['param', 'moment1', 'moment2', 'scalar'])
def test_flagship_state_matches_jax_after_three_steps(flagship, kind):
    pair = flagship['pair']
    params = {p.name for p in pair.t_main.global_block().all_parameters()}
    names = {'param': sorted(params),
             'moment1': [n for n in pair.state_names if '_moment1_' in n],
             'moment2': [n for n in pair.state_names if '_moment2_' in n],
             'scalar': [n for n in pair.state_names
                        if 'pow_acc' in n or n.startswith('learning_rate')]
             }[kind]
    assert names
    for name in names:
        _assert_state_close(name, *pair.state(name))
    # and the three steps did move them
    assert all(not np.array_equal(pair.state(n)[1], flagship['initial'][n])
               for n in names if not n.startswith('learning_rate'))


def test_flagship_loss_falls_over_steps_on_one_batch():
    main, startup, loss = _build(pt, _flagship, seed=5)
    scope = pt.Scope()
    exe = pt.Executor(pt.CPUPlace())
    exe.run(startup, scope=scope)
    feed = _lm_feed(0)
    losses = [float(exe.run(main, feed=feed, fetch_list=[loss],
                            scope=scope)[0][0]) for _ in range(4)]
    assert all(np.isfinite(losses)) and losses[-1] < losses[0]


# the flagship at a long-ish sequence, where JAX's attention runs on its
# Pallas kernels (interpret mode): 1024 positions, 512-query and 1024-key
# blocks in f32
LONG_DIMS = dict(DIMS, n_layers=1, seq=1024)


def _long_flagship(pkg):
    if pkg is fluid:
        loss = _jax_models().transformer(None, **LONG_DIMS)[0]
    else:
        loss = pt_transformer(None, **LONG_DIMS)[0]
    pkg.optimizer.Adam(learning_rate=1e-3).minimize(loss)
    return loss


@pytest.mark.parametrize('merged', [True, False])
def test_flagship_long_seq_grads_match_pallas_backward(monkeypatch, merged):
    """One step of the flagship at seq 1024: the loss and every gradient
    against paddle_tpu with its attention forced onto the Pallas kernels
    in interpret mode, the backward on the merged route or on the
    two-pass route (``pk._MERGED_BWD``), which the port takes past its
    byte cap (long context). On the CPU the port runs the plain backward,
    the decomposition both of its routes compute."""
    orig, orig_merged = pk.flash_attention, pk._flash_bwd_merged
    traced = {'attention': 0, 'merged': 0}

    def forced(q, k, v, causal=True, block_q=None, block_k=None,
               interpret=None, force=None):
        traced['attention'] += 1
        return orig(q, k, v, causal, block_q, block_k, interpret=True)

    def merged_bwd(*args):
        traced['merged'] += 1
        return orig_merged(*args)

    monkeypatch.setattr(pk, 'flash_attention', forced)
    monkeypatch.setattr(pk, '_flash_bwd_merged', merged_bwd)
    monkeypatch.setattr(pk, '_MERGED_BWD', [merged])
    jax.clear_caches()   # the route is read while tracing
    pair = Pair(_long_flagship)
    rng = np.random.RandomState(31)
    S, V = LONG_DIMS['seq'], LONG_DIMS['vocab']
    feed = {'data': rng.randint(0, V, (2, S)).astype('int64'),
            'label': rng.randint(0, V, (2, S, 1)).astype('int64'),
            'pos': np.tile(np.arange(S, dtype='int64'), (2, 1))}
    j, t = pair.step(feed, fetch_grads=True)
    jax.clear_caches()
    assert traced['attention'] > 0 and (traced['merged'] > 0) == merged
    assert np.isfinite(t[0]).all() and _rel_err(t[0], j[0]) <= REL
    assert len(pair.grad_names) == len(
        pair.t_main.global_block().all_parameters())
    for name, jg, tg in zip(pair.grad_names, j[1:], t[1:]):
        assert tg.shape == jg.shape, name
        assert _rel_err(tg, jg) <= REL, name


# ---- a small fc model: other optimizers, regularizers, clips ------------------
def _fc_model(pkg, optimize):
    x = pkg.layers.data(name='x', shape=[8], dtype='float32')
    y = pkg.layers.data(name='y', shape=[1], dtype='float32')
    h = pkg.layers.fc(input=x, size=16, act='relu')
    pred = pkg.layers.fc(input=h, size=1)
    diff = pkg.layers.elementwise_sub(pred, y)
    loss = pkg.layers.mean(pkg.layers.elementwise_mul(diff, diff))
    optimize(pkg, loss)
    return loss


def _sgd(pkg, loss):
    pkg.optimizer.SGD(learning_rate=0.05).minimize(loss)


def _momentum(pkg, loss):
    pkg.optimizer.Momentum(learning_rate=0.05, momentum=0.9).minimize(loss)


def _nesterov_l1(pkg, loss):
    pkg.optimizer.Momentum(
        learning_rate=0.05, momentum=0.9, use_nesterov=True,
        regularization=pkg.regularizer.L1Decay(1e-3)).minimize(loss)


def _adam_l2(pkg, loss):
    pkg.optimizer.Adam(learning_rate=1e-2,
                       regularization=pkg.regularizer.L2Decay(1e-2)
                       ).minimize(loss)


def _global_norm_clip(pkg, loss):
    pkg.clip.set_gradient_clip(pkg.clip.GradientClipByGlobalNorm(0.5))
    pkg.optimizer.SGD(learning_rate=0.05).minimize(loss)


def _value_and_norm_clip(pkg, loss):
    params = pkg.default_main_program().global_block().all_parameters()
    pkg.clip.set_gradient_clip(pkg.clip.GradientClipByValue(0.05),
                               param_list=params[:2])
    pkg.clip.set_gradient_clip(pkg.clip.GradientClipByNorm(0.1),
                               param_list=params[2:])
    pkg.optimizer.Momentum(learning_rate=0.05, momentum=0.5).minimize(loss)


def _param_lr_and_error_clip(pkg, loss):
    block = pkg.default_main_program().global_block()
    block.all_parameters()[0].optimize_attr = {'learning_rate': 0.5}
    block.all_parameters()[1].error_clip = pkg.clip.ErrorClipByValue(1e-3)
    pkg.optimizer.SGD(learning_rate=0.05).minimize(loss)


def _activation_error_clip(pkg, loss):
    relu = [op for op in pkg.default_main_program().global_block().ops
            if op.type == 'relu'][0]
    pkg.default_main_program().global_block().var(
        relu.outputs['Out'][0]).set_error_clip(
            pkg.clip.ErrorClipByValue(1e-3))
    pkg.optimizer.SGD(learning_rate=0.05).minimize(loss)


FC_CASES = {'sgd': _sgd, 'momentum': _momentum,
            'nesterov_l1_decay': _nesterov_l1, 'adam_l2_decay': _adam_l2,
            'global_norm_clip': _global_norm_clip,
            'value_and_norm_clip': _value_and_norm_clip,
            'param_lr_and_error_clip': _param_lr_and_error_clip,
            'activation_error_clip': _activation_error_clip}


def _fc_feed(step):
    rng = np.random.RandomState(step)
    x = rng.randn(16, 8).astype('float32')
    return {'x': x, 'y': (x.sum(1, keepdims=True) * 2).astype('float32')}


@pytest.mark.parametrize('case', sorted(FC_CASES))
def test_fc_training_matches_jax(case):
    pair = Pair(lambda pkg: _fc_model(pkg, FC_CASES[case]), seed=3)
    assert _ops(pair.t_main) == _ops(pair.j_main)
    for step in range(3):
        j, t = pair.step(_fc_feed(step), fetch_grads=True)
        for name, a, b in zip(['loss'] + pair.grad_names, j, t):
            assert _rel_err(b, a) <= REL, (step, name)
    for name in pair.state_names:
        _assert_state_close(name, *pair.state(name), rtol=REL)


def test_unreached_parameter_gets_zero_gradient():
    def build(pkg):
        x = pkg.layers.data(name='x', shape=[8], dtype='float32')
        pkg.layers.fc(input=x, size=4)          # not on the loss's path
        loss = pkg.layers.mean(pkg.layers.fc(input=x, size=1))
        pkg.optimizer.SGD(learning_rate=0.1).minimize(loss)
        return loss

    pair = Pair(build)
    j, t = pair.step({'x': _fc_feed(0)['x']}, fetch_grads=True)
    for name, a, b in zip(['loss'] + pair.grad_names, j, t):
        np.testing.assert_allclose(b, a, rtol=REL, atol=1e-7)
    assert np.all(t[1 + pair.grad_names.index('fc_0.w_0@GRAD')] == 0)


def test_eval_clone_changes_no_parameter():
    main, startup = pt.Program(), pt.Program()
    with pt.unique_name.guard(), pt.program_guard(main, startup):
        loss = _fc_model(pt, lambda pkg, loss: None)
        test_prog = main.clone(for_test=True)
        pt.optimizer.Adam(learning_rate=0.1).minimize(loss)
    assert 'backward_marker' not in [op.type for op in
                                     test_prog.global_block().ops]
    scope = pt.Scope()
    exe = pt.Executor(pt.CPUPlace())
    exe.run(startup, scope=scope)
    before = {n: v.clone() for n, v in scope.vars.items()
              if hasattr(v, 'clone')}
    exe.run(test_prog, feed=_fc_feed(0), fetch_list=[loss], scope=scope)
    for n, v in before.items():
        assert scope.raw(n) is not None and (scope.raw(n) == v).all(), n
    exe.run(main, feed=_fc_feed(0), fetch_list=[loss], scope=scope)
    assert not (scope.raw('fc_0.w_0') == before['fc_0.w_0']).all()


def test_grads_and_accumulators_fetch_by_name():
    main, startup = pt.Program(), pt.Program()
    with pt.unique_name.guard(), pt.program_guard(main, startup):
        loss = _fc_model(pt, lambda pkg, loss: pkg.optimizer.Adam(
            learning_rate=0.1).minimize(loss))
    scope = pt.Scope()
    exe = pt.Executor(pt.CPUPlace())
    exe.run(startup, scope=scope)
    g, m1, b1 = exe.run(main, feed=_fc_feed(0),
                        fetch_list=['fc_0.w_0@GRAD', 'fc_0.w_0_moment1_0',
                                    'beta1_pow_acc_0'], scope=scope)
    assert g.shape == (8, 16) and np.abs(g).max() > 0
    np.testing.assert_allclose(m1, 0.1 * g, rtol=1e-6, atol=1e-8)
    np.testing.assert_allclose(b1, [0.9 * 0.9], rtol=1e-6)


def test_sparse_embedding_raises(monkeypatch):
    """The program that raised before sparse row gradients were ported
    now trains like paddle_tpu's: the table's SGD steps touch only the
    looked-up rows and equal the JAX package's to 1e-6."""
    import paddle_tpu.layers.nn as jnn
    monkeypatch.setattr(pt.layers.nn, '_SPARSE_MIN_TABLE_ELEMS', [0])
    monkeypatch.setattr(jnn, '_SPARSE_MIN_TABLE_ELEMS', [0])

    def build(pkg):
        ids = pkg.layers.data(name='ids', shape=[4], dtype='int64')
        emb = pkg.layers.embedding(input=ids, size=[10, 3], is_sparse=True)
        loss = pkg.layers.mean(emb)
        pkg.optimizer.SGD(learning_rate=0.1).minimize(loss)
        return loss
    j_main, j_startup, j_loss = _build(fluid, build)
    t_main, _, t_loss = _build(pt, build)
    assert _ops(t_main) == _ops(j_main)
    j_scope = fluid.Scope()
    j_exe = fluid.Executor(fluid.CPUPlace())
    j_exe.run(j_startup, scope=j_scope)
    table = np.asarray(j_scope.raw('embedding_0.w_0'))
    scope = pt.Scope()
    pt_io.params_from_numpy(scope, {'embedding_0.w_0': table,
                                    'learning_rate_0': np.array(
                                        [0.1], 'float32')}, pt.CPUPlace())
    exe = pt.Executor(pt.CPUPlace())
    for ids in (np.array([[1, 2, 2, 3], [3, 4, 5, 1]], 'int64'),
                np.array([[7, 7, 0, 1], [2, 2, 2, 2]], 'int64')):
        j, = j_exe.run(j_main, feed={'ids': ids}, fetch_list=[j_loss],
                       scope=j_scope)
        t, = exe.run(t_main, feed={'ids': ids}, fetch_list=[t_loss],
                     scope=scope)
        np.testing.assert_allclose(t, np.asarray(j), rtol=1e-6)
    got = pt.fetch_var('embedding_0.w_0', scope)
    np.testing.assert_allclose(got, np.asarray(
        j_scope.raw('embedding_0.w_0')), rtol=1e-6, atol=1e-7)
    np.testing.assert_array_equal(got[[6, 8, 9]], table[[6, 8, 9]])
    assert not np.array_equal(got[2], table[2])


def test_zero_stage_raises():
    """minimize(zero_stage=2) no longer raises: on a group of one it
    plants nothing, as in paddle_tpu; on a dp group of 2 it plants the
    ZeRO-2 tail (tests/test_torch_zero.py holds it field for field)."""
    from paddle_tpu_torch.parallel import mesh
    for group, planted in ((None, False), (mesh.DPGroup(2, 0), True)):
        mesh.set_mesh(group)
        try:
            main, startup = pt.Program(), pt.Program()
            with pt.unique_name.guard(), pt.program_guard(main, startup):
                loss = _fc_model(pt, lambda pkg, loss: None)
                pt.optimizer.Adam(learning_rate=0.1).minimize(
                    loss, zero_stage=2)
        finally:
            mesh.set_mesh(None)
        assert planted == any(op.type == 'zero_reduce_scatter'
                              for op in main.global_block().ops)
