"""Training ResNet-50 and SE-ResNeXt-50 against paddle_tpu, on the CPU.

Both packages build the benchmark's training program with their own
layers (``benchmark/fluid/models.py``: the model, ``cross_entropy``,
``mean``, then ``Momentum(0.01, 0.9).minimize``, as ``bench.py`` trains
it) at full width and depth, 3 x 64 x 64 images, batch 4. The port's
startup scope (parameters, velocities, learning rate), with every batch
norm's affine and moving statistics randomized, goes to both packages as
numpy arrays (``io.params_from_numpy`` on the port's side) and both
Executors run the same numpy batches, f32 with AMP off. JAX runs
off the TPU, so its fused_conv ops replay the unfused ops; the port runs
every train-mode region on the fused conv's stats form (its plain version
on the CPU, under the autograd Function the card runs).

Each residual branch starts with a small batch-norm gamma (see
``_residual_gammas_small``): with gammas near 1, f32 rounding alone moves
the random network's gradients by percents.

Limits, relative L2 error per tensor, ||port - jax|| / ||jax||, set from
the readings on the CPU (f32 sums in another order through 53 batch
norms): the loss 1e-5 (read 2.6e-7, 5.6e-7 at the second step); the
moving statistics 1e-5 (read 1.9e-6); parameters after two steps 2e-4
(read 2.5e-5); gradients, the largest tensor 5e-2 and the median 1e-3
(read ResNet-50 1.2e-3 / 1.5e-5, SE-ResNeXt-50 8.2e-3 / 5.9e-4);
velocities, which carry the second step's gradients, 5e-2 and 5e-3
(read 1.3e-2 / 3.2e-3). A control, the card's autograd Function with
the moments' cotangents dropped, must miss both gradient limits (read
8.2 / 1.2).

    python tests/test_torch_resnet_training.py

prints these readings and the port's own noise: its gradients' change
for a 1e-7 change of the images, with gammas as drawn and small.
"""
import numpy as np
import pytest

import paddle_tpu.fluid as fluid
from paddle_tpu.models import resnet as jax_resnet
import paddle_tpu_torch as pt
from paddle_tpu_torch import io as pt_io
from paddle_tpu_torch.compiler import passes as pt_passes
from paddle_tpu_torch.models import resnet as pt_resnet
from paddle_tpu_torch.ops import cuda_kernels as ck

from test_torch_conv import randomize_batch_norms
from test_torch_conv_stats import MomentsDropped

LOSS_TOL = STAT_TOL = 1e-5
PARAM_TOL = 2e-4
GRAD_MAX, GRAD_MEDIAN = 5e-2, 1e-3
VELOCITY_MEDIAN = 5e-3
BATCH, SIZE, CLASSES = 4, 64, 1000


def _build(pkg, model):
    main, startup = pkg.Program(), pkg.Program()
    startup.random_seed = 3
    mod = jax_resnet if pkg is fluid else pt_resnet
    with pkg.unique_name.guard(), pkg.program_guard(main, startup):
        img = pkg.layers.data(name='data', shape=[3, SIZE, SIZE],
                              dtype='float32')
        label = pkg.layers.data(name='label', shape=[1], dtype='int64')
        predict = getattr(mod, model)(img, class_dim=CLASSES, depth=50)
        loss = pkg.layers.mean(pkg.layers.cross_entropy(input=predict,
                                                        label=label))
        pkg.optimizer.Momentum(learning_rate=0.01, momentum=0.9).minimize(
            loss)
    return main, startup, loss


def _descs(program):
    return [(op.type, sorted(op.inputs.items()), sorted(op.outputs.items()),
             sorted(op.attrs.items())) for op in program.global_block().ops]


def _feed(step):
    rng = np.random.RandomState(10 + step)
    return {'data': rng.randn(BATCH, 3, SIZE, SIZE).astype('float32'),
            'label': rng.randint(0, CLASSES, (BATCH, 1)).astype('int64')}


def _rel_l2(got, ref):
    ref = np.asarray(ref, dtype='float64')
    return np.linalg.norm(np.asarray(got, dtype='float64') - ref) / max(
        np.linalg.norm(ref), 1e-30)


def _residual_gammas_small(main, params, factor=0.1):
    """Scale each residual branch's last batch-norm Scale (behind the Y
    operand of a block's elementwise_add, through SE-ResNeXt's
    excitation product) by ``factor``, the small-gamma start of ResNet
    training (Goyal et al., 2017). With every Scale near 1, train-mode
    batch norm makes the random network's gradients explode with depth,
    and rounding in the first layers moves them: the port's own ResNet-50
    gradients change by 2.4% (median relative L2) for a 1e-7 change of
    the images. With small gammas that drops to 2.7e-6, and the
    comparison below can hold the port to paddle_tpu."""
    producer = {n: op for op in main.global_block().ops
                for n in op.output_arg_names}
    for op in main.global_block().ops:
        bn = producer.get(op.input('Y')[0]) if op.type == 'elementwise_add' \
            else None
        if bn is not None and bn.type == 'elementwise_mul':     # SE
            bn = producer.get(bn.input('X')[0])
        if bn is not None and bn.type == 'batch_norm':
            name = bn.input('Scale')[0]
            params[name] = params[name] * np.float32(factor)
    return params


def _start_params(t_main, t_startup, gamma=0.1):
    """The port's startup scope as numpy arrays, batch norms randomized
    and residual gammas scaled by ``gamma``. (The JAX startup would take
    as long to compile as a training step.)"""
    scope = pt.Scope()
    pt.Executor(pt.CPUPlace()).run(t_startup, scope=scope)
    params = {v.name: pt.executor.as_numpy(scope.raw(v.name))
              for v in t_main.list_vars()
              if v.persistable and scope.raw(v.name) is not None}
    return _residual_gammas_small(
        t_main, randomize_batch_norms(t_main, params), gamma)


def _train(model, steps):
    """Both packages, ``steps`` Momentum steps on the same batches, each
    fetching the loss and every gradient."""
    j_main, _, j_loss = _build(fluid, model)
    t_main, t_startup, t_loss = _build(pt, model)
    params = _start_params(t_main, t_startup)
    grads = sorted(v.name for v in t_main.list_vars()
                   if v.name.endswith('@GRAD'))
    j_scope, t_scope = fluid.Scope(), pt.Scope()
    for n, a in params.items():
        j_scope.set_var(n, a)
    pt_io.params_from_numpy(t_scope, params, pt.CPUPlace())
    j_exe, t_exe = fluid.Executor(fluid.CPUPlace()), \
        pt.Executor(pt.CPUPlace())
    pt_passes.reset_fallback_counts()
    runs = []
    # the same fetches every step: the JAX Executor compiles once
    fetch = [j_loss.name] + grads
    for step in range(steps):
        j = j_exe.run(j_main, feed=_feed(step), fetch_list=fetch,
                      scope=j_scope)
        t = t_exe.run(t_main, feed=_feed(step), fetch_list=fetch,
                      scope=t_scope)
        runs.append((fetch, [np.asarray(a) for a in j], t))
    state = {n: (np.asarray(j_scope.raw(n)),
                 pt.executor.as_numpy(t_scope.raw(n))) for n in params}
    return dict(j_main=j_main, t_main=t_main, loss=t_loss, params=params,
                runs=runs, state=state, fallbacks=dict(pt_passes.FALLBACKS))


def _port_first_step(got, drop_moments):
    """The port's first step again, counting the calls of the stats form's
    autograd Function backward (``_FusedConvStats``, the one the card
    runs): (fetched values, calls). With ``drop_moments`` every
    train-mode region runs ``MomentsDropped``, whose backward ignores
    g_sum and g_sumsq."""
    calls = [0]
    right = ck.fused_conv_stats_backward

    def counted(*args, **kw):
        calls[0] += 1
        return right(*args, **kw)

    def conv(x, w, aux, kinds, stages, strides, pads, depthwise,
             emit_stats=False):
        if not (emit_stats and drop_moments):
            return ck.fused_conv(x, w, aux, kinds, stages, strides, pads,
                                 depthwise, emit_stats)
        return MomentsDropped.apply(
            (tuple(strides), tuple(pads), bool(depthwise)),
            ck._stats_reference, x, w)

    scope = pt.Scope()
    pt_io.params_from_numpy(scope, got['params'], pt.CPUPlace())
    fetch = got['runs'][0][0]
    ck.fused_conv_stats_backward = counted
    try:
        with pt_passes.conv_for_testing(conv):
            out = pt.Executor(pt.CPUPlace()).run(
                got['t_main'], feed=_feed(0), fetch_list=fetch, scope=scope)
    finally:
        ck.fused_conv_stats_backward = right
    return out, calls[0]


def _grad_errors(fetch, ref, got):
    """Relative L2 error of each gradient: (max, median)."""
    errs = [_rel_l2(t, j) for n, j, t in zip(fetch, ref, got)
            if n.endswith('@GRAD')]
    return max(errs), float(np.median(errs))


@pytest.fixture(scope='module')
def resnet50():
    got = _train('resnet_imagenet', 2)
    got['function'] = _port_first_step(got, drop_moments=False)
    got['control'] = _port_first_step(got, drop_moments=True)
    return got


def test_resnet50_training_program_matches_jax(resnet50):
    assert _descs(resnet50['t_main']) == _descs(resnet50['j_main'])
    opt, _ = pt.compiler.optimize(resnet50['t_main'],
                                  fetch_names=[resnet50['loss'].name])
    types = [op.type for op in opt.global_block().ops]
    assert types.count('fused_conv') == 53
    assert 'conv2d' not in types and 'batch_norm' not in types
    # every region's batch norm is in train mode and none replayed
    assert resnet50['fallbacks'] == {}


@pytest.mark.parametrize('step', [0, 1])
def test_resnet50_loss_matches_jax(resnet50, step):
    _, j, t = resnet50['runs'][step]
    assert np.isfinite(t[0]).all()
    assert _rel_l2(t[0], j[0]) <= LOSS_TOL


def test_resnet50_gradients_match_jax(resnet50):
    fetch, j, t = resnet50['runs'][0]
    assert len(fetch) == 1 + len([p for p in resnet50['t_main']
                                  .global_block().all_parameters()
                                  if p.trainable])
    worst, median = _grad_errors(fetch, j, t)
    assert worst <= GRAD_MAX and median <= GRAD_MEDIAN, (worst, median)


@pytest.mark.parametrize('drop_moments', [False, True])
def test_resnet50_gradients_through_the_card_function(resnet50,
                                                      drop_moments):
    """The first step with every train-mode region on the card's autograd
    Function (its forward the plain one) matches paddle_tpu; the control,
    its backward without the moments' cotangents, misses both limits by
    far."""
    fetch, j, _ = resnet50['runs'][0]
    got, calls = resnet50['control' if drop_moments else 'function']
    assert calls == 53
    worst, median = _grad_errors(fetch, j, got)
    if drop_moments:
        assert worst > 10 * GRAD_MAX and median > 100 * GRAD_MEDIAN, \
            (worst, median)
    else:
        assert _rel_l2(got[0], j[0]) <= LOSS_TOL
        assert worst <= GRAD_MAX and median <= GRAD_MEDIAN, (worst, median)


@pytest.mark.parametrize('kind', ['param', 'velocity', 'moving_stat'])
def test_resnet50_state_matches_jax_after_two_steps(resnet50, kind):
    """Every parameter and velocity after two Momentum steps, and every
    batch norm's moving mean and variance (MeanOut / VarianceOut, written
    by the fused op's Stats outputs), each of which the steps moved."""
    block = resnet50['t_main'].global_block()
    trainable = {p.name for p in block.all_parameters() if p.trainable}
    moving = {op.output(s)[0] for op in block.ops if op.type == 'batch_norm'
              for s in ('MeanOut', 'VarianceOut')}
    names = sorted({'param': trainable,
                    'velocity': {n for n in resnet50['state']
                                 if '_velocity' in n},
                    'moving_stat': moving}[kind])
    assert len(names) == {'param': 161, 'velocity': 161,
                          'moving_stat': 106}[kind]
    errs = []
    for n in names:
        j, t = resnet50['state'][n]
        errs.append(_rel_l2(t, j))
        assert not np.array_equal(t, resnet50['params'][n]), n
    worst, median = max(errs), float(np.median(errs))
    if kind == 'velocity':
        assert worst <= GRAD_MAX and median <= VELOCITY_MEDIAN, \
            (worst, median)
    else:
        assert worst <= (PARAM_TOL if kind == 'param' else STAT_TOL), worst


def _noise(model, gamma):
    """(max, median) gradient change of the port's own first step when
    the images change by 1e-7 (relative), its fused ops on the CPU."""
    t_main, t_startup, t_loss = _build(pt, model)
    params = _start_params(t_main, t_startup, gamma)
    grads = sorted(v.name for v in t_main.list_vars()
                   if v.name.endswith('@GRAD'))
    runs = []
    for scale in (1.0, 1.0 + 1e-7):
        scope = pt.Scope()
        pt_io.params_from_numpy(scope, params, pt.CPUPlace())
        feed = _feed(0)
        feed['data'] = feed['data'] * np.float32(scale)
        runs.append(pt.Executor(pt.CPUPlace()).run(
            t_main, feed=feed, fetch_list=grads, scope=scope))
    return _grad_errors(grads, *runs)


def main():
    """Print the readings the limits above come from."""
    for model, steps in (('resnet_imagenet', 2), ('se_resnext', 1)):
        got = _train(model, steps)
        for step, (fetch, j, t) in enumerate(got['runs']):
            print('%s step %d: loss %.3g, gradients max %.3g median %.3g'
                  % ((model, step, _rel_l2(t[0], j[0])) +
                     _grad_errors(fetch, j, t)))
        trainable = {p.name for p in got['t_main'].global_block()
                     .all_parameters() if p.trainable}
        for kind, pick in (('parameters', lambda n: n in trainable),
                           ('velocities', lambda n: '_velocity' in n)):
            errs = [_rel_l2(t, j) for n, (j, t) in got['state'].items()
                    if pick(n)]
            print('%s %s: max %.3g median %.3g' % (
                model, kind, max(errs), float(np.median(errs))))
        if model == 'resnet_imagenet':
            moving = [op.output(s)[0] for op in got['t_main'].global_block()
                      .ops if op.type == 'batch_norm'
                      for s in ('MeanOut', 'VarianceOut')]
            print('resnet_imagenet moving statistics: max %.3g' % max(
                _rel_l2(got['state'][n][1], got['state'][n][0])
                for n in moving))
            for drop in (False, True):
                print('card Function, moments dropped %s: gradients max '
                      '%.3g median %.3g' % ((drop,) + _grad_errors(
                          got['runs'][0][0], got['runs'][0][1],
                          _port_first_step(got, drop)[0])))
        for gamma in (1.0, 0.1):
            print('%s, residual gammas x%g: the port\'s gradients for '
                  '1e-7 of input noise: max %.3g median %.3g'
                  % ((model, gamma) + _noise(model, gamma)))


if __name__ == '__main__':
    main()
