"""``memory_optimize`` on the port, on the CPU: a training step whose
forward runs as checkpointed segments against the same step without
them, and against paddle_tpu's step under its own ``memory_optimize``.

Both packages build each program under fresh unique-name generators;
the JAX package's startup scope (every batch norm's affine and moving
statistics drawn anew from a seed) goes to the port as numpy arrays.
Against the port's own step without segments the loss, every
``<param>@GRAD`` and every moving statistic must be bit-equal (the same
kernels on the same inputs; the recompute is what autograd keeps, not a
second answer). Against paddle_tpu's, each tensor within 1e-5 of its
largest magnitude (f32 sums in another order; measured below 1e-6 on
these nets). A dropout net's masks and gradients equal the run without
segments, so the recompute drew the first run's masks; its generator
advanced once a step. Moving statistics are updated once a step.
"""
import jax  # noqa: F401 (the JAX side runs on the CPU)
import numpy as np
import pytest
import torch

import paddle_tpu.fluid as jfluid
from paddle_tpu import compiler as jax_compiler
from paddle_tpu.models import resnet as jax_resnet
from paddle_tpu.transpiler import memory_optimize as jax_memory_optimize
import paddle_tpu_torch as pt
from paddle_tpu_torch import io as pt_io
from paddle_tpu_torch.core import lowering
from paddle_tpu_torch.models import resnet as pt_resnet
from paddle_tpu_torch.models.fluid_transformer import transformer as \
    pt_transformer
from paddle_tpu_torch.transpiler import memory_optimize

from test_torch_training import _jax_models

TOL = 1e-5
TRANSFORMER = dict(vocab=64, d_model=32, n_heads=2, n_layers=2, d_ff=64,
                   seq=32)


def _transformer(pkg):
    if pkg is jfluid:
        loss = _jax_models().transformer(None, **TRANSFORMER)[0]
    else:
        loss = pt_transformer(None, **TRANSFORMER)[0]
    pkg.optimizer.Adam(learning_rate=1e-3).minimize(loss)
    return loss


def _transformer_feed():
    rng = np.random.RandomState(0)
    V, S = TRANSFORMER['vocab'], TRANSFORMER['seq']
    return {'data': rng.randint(0, V, (2, S)).astype('int64'),
            'label': rng.randint(0, V, (2, S, 1)).astype('int64'),
            'pos': np.tile(np.arange(S, dtype='int64'), (2, 1))}


def _resnet(pkg):
    mod = jax_resnet if pkg is jfluid else pt_resnet
    img = pkg.layers.data(name='data', shape=[3, 16, 16], dtype='float32')
    label = pkg.layers.data(name='label', shape=[1], dtype='int64')
    pred = mod.resnet_cifar10(img, 10, depth=8)
    loss = pkg.layers.mean(pkg.layers.cross_entropy(input=pred,
                                                    label=label))
    pkg.optimizer.Momentum(learning_rate=0.01, momentum=0.9).minimize(loss)
    return loss


def _resnet_feed():
    rng = np.random.RandomState(1)
    return {'data': rng.randn(4, 3, 16, 16).astype('float32'),
            'label': rng.randint(0, 10, (4, 1)).astype('int64')}


def _dropout_net(pkg):
    x = pkg.layers.data(name='x', shape=[16], dtype='float32')
    y = pkg.layers.data(name='y', shape=[1], dtype='float32')
    h = x
    for _ in range(4):
        h = pkg.layers.fc(input=h, size=16, act='relu')
        h = pkg.layers.dropout(h, dropout_prob=0.4)
    loss = pkg.layers.mean(pkg.layers.square_error_cost(
        input=pkg.layers.fc(input=h, size=1), label=y))
    pkg.optimizer.SGD(learning_rate=0.1).minimize(loss)
    return loss


def _dropout_feed():
    rng = np.random.RandomState(2)
    return {'x': rng.randn(8, 16).astype('float32'),
            'y': rng.randn(8, 1).astype('float32')}


def _build(pkg, build, remat):
    main, startup = pkg.Program(), pkg.Program()
    main.random_seed = startup.random_seed = 5
    with pkg.unique_name.guard(), pkg.program_guard(main, startup):
        loss = build(pkg)
    if remat:
        (jax_memory_optimize if pkg is jfluid else memory_optimize)(main)
    return main, startup, loss


def _init_state(build):
    main, startup, _ = _build(jfluid, build, False)
    scope = jfluid.Scope()
    jfluid.Executor(jfluid.CPUPlace()).run(startup, scope=scope)
    state = {v.name: np.asarray(scope.raw(v.name))
             for v in startup.list_vars() if scope.raw(v.name) is not None}
    rng = np.random.RandomState(7)
    for op in main.global_block().ops:
        if op.type == 'batch_norm':
            c = state[op.input('Scale')[0]].shape[0]
            state[op.input('Mean')[0]] = rng.randn(c).astype('float32') * .3
            state[op.input('Variance')[0]] = (rng.rand(c) + .5).astype(
                'float32')
            state[op.input('Scale')[0]] = (rng.rand(c) + .5).astype(
                'float32')
    return state


def _fetches(main):
    names = sorted(v.name for v in main.list_vars()
                   if v.name.endswith('@GRAD'))
    stats = sorted(op.input(s)[0] for op in main.global_block().ops
                   if op.type == 'batch_norm' for s in ('Mean', 'Variance'))
    return names, stats


def _port_step(build, feed, state, remat, steps=1):
    main, _, loss = _build(pt, build, remat)
    scope = pt.Scope()
    pt_io.params_from_numpy(scope, state, pt.CPUPlace())
    exe = pt.Executor(pt.CPUPlace())
    grads, stats = _fetches(main)
    for _ in range(steps):
        out = exe.run(main, feed=feed, fetch_list=[loss] + grads,
                      scope=scope)
    return dict(zip(['loss'] + grads, out)), {
        n: pt.fetch_var(n, scope) for n in stats}, scope


def _jax_step(build, feed, state):
    main, _, loss = _build(jfluid, build, True)
    scope = jfluid.Scope()
    for n, v in state.items():
        scope.set_var(n, v)
    grads, stats = _fetches(main)
    # paddle_tpu's segments read a fused conv region's inputs by the
    # region op's slots, which its CPU replay of the captured ops does
    # not match (a KeyError): its step runs without the passes
    with jax_compiler.disabled():
        out = jfluid.Executor(jfluid.CPUPlace()).run(
            main, feed=feed, fetch_list=[loss] + grads, scope=scope)
    return dict(zip(['loss'] + grads, [np.asarray(o) for o in out])), {
        n: np.asarray(scope.raw(n)) for n in stats}


def _segments(monkeypatch):
    calls = []
    real = torch.utils.checkpoint.checkpoint

    def counting(fn, *args, **kw):
        calls.append(kw.get('use_reentrant'))
        return real(fn, *args, **kw)
    monkeypatch.setattr(torch.utils.checkpoint, 'checkpoint', counting)
    return calls


@pytest.mark.parametrize('name', ['transformer', 'resnet'])
def test_remat_step_matches_plain_and_paddle_tpu(monkeypatch, name):
    build, feed = {'transformer': (_transformer, _transformer_feed),
                   'resnet': (_resnet, _resnet_feed)}[name]
    feed = feed()
    state = _init_state(build)
    plain, plain_stats, _ = _port_step(build, feed, state, False)
    calls = _segments(monkeypatch)
    remat, remat_stats, _ = _port_step(build, feed, state, True)
    assert len(calls) >= 2 and set(calls) == {False}
    assert set(remat) == set(plain) and len(remat) > 5
    for n in plain:
        assert np.array_equal(remat[n], plain[n]), n
    for n in plain_stats:
        assert np.array_equal(remat_stats[n], plain_stats[n]), n
    ref, ref_stats = _jax_step(build, feed, state)
    for got, want in ((remat, ref), (remat_stats, ref_stats)):
        assert set(got) == set(want)
        for n in want:
            scale = max(float(np.abs(want[n]).max()), 1e-30)
            assert np.abs(got[n] - want[n]).max() <= TOL * scale, n


def test_dropout_masks_and_gradients_equal_the_plain_run():
    feed = _dropout_feed()
    state = _init_state(_dropout_net)
    plain, _, pscope = _port_step(_dropout_net, feed, state, False, steps=2)
    remat, _, rscope = _port_step(_dropout_net, feed, state, True, steps=2)
    for n in plain:
        assert np.array_equal(remat[n], plain[n]), n
    # the generators advanced once a step: the same state after two
    for key in (lowering.RNG_KEY, lowering.RNG_CPU_KEY):
        assert torch.equal(rscope.raw(key).get_state(),
                           pscope.raw(key).get_state())


def test_moving_statistics_updated_once_a_step():
    feed = _resnet_feed()
    state = _init_state(_resnet)
    for steps in (1, 2):
        _, plain, _ = _port_step(_resnet, feed, state, False, steps=steps)
        _, remat, _ = _port_step(_resnet, feed, state, True, steps=steps)
        for n in plain:
            assert np.array_equal(remat[n], plain[n]), (steps, n)
            assert not np.array_equal(remat[n], state[n]), n


def test_memory_optimize_marks_and_survives_clone():
    main, _, _ = _build(pt, _dropout_net, False)
    assert not main._remat
    fp = main.fingerprint()
    out = memory_optimize(main)
    assert out is main and main._remat and main.fingerprint() != fp
    assert main.clone()._remat
    assert any(op.attrs.get('__release__') for op in
               main.global_block().ops)
    jmain, _, _ = _build(jfluid, _dropout_net, True)
    assert jmain._remat
    assert pt.release_memory(main) is main


def test_segments_and_hidden_reads():
    main, _, _ = _build(pt, _transformer, False)
    ops = main.global_block().ops
    marker = [i for i, op in enumerate(ops)
              if op.type == 'backward_marker'][0]
    bounds = lowering._remat_segments(ops[:marker])
    assert bounds[0][0] == 0 and bounds[-1][1] == marker
    assert all(a < b for a, b in bounds)
    assert len(bounds) == max(2, int(marker ** 0.5))
