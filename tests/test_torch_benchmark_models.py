"""The benchmark harness's image models in paddle_tpu_torch against
paddle_tpu, on the CPU: ``nets``, the ``dropout`` op, mnist and VGG-16.

mnist and VGG-16 are built as benchmark/fluid/models.py:24-48 builds
them, by the port's ``models.benchmark`` and by paddle_tpu's harness
module, op for op and name for name. The port's startup scope goes to
both packages as numpy arrays (``io.params_from_numpy``), batch-norm
moving statistics randomized, and both Executors run the same numpy
batches, f32 with AMP off (JAX's fused convs replay their ops off the
TPU; the port's run on the fused conv's plain version, under the
autograd Functions the card runs).

- Inference (``clone(for_test=True)``, dropout as x * (1 - p)) at batch
  2: the probabilities to 1e-4 of their largest magnitude.
- Two Momentum(0.01, 0.9) steps at the harness's batch 32, with every
  dropout's ``dropout_prob`` set to 0 (the two packages' random streams
  differ): the loss to 1e-4 and every ``@GRAD`` to 1e-4 of its own
  largest magnitude. A bias added right before a train-mode batch norm
  has a gradient of zero but for rounding; it is held to 1e-4 of the
  largest gradient.
- VGG-16's ReLUs and max pools decide by a sign or a comparison. Where
  the two packages' f32 sums put a value within rounding of the switch,
  they take different branches, and that one element's gradient moves
  every earlier layer's. At batch 8, 3 of 2215936 ReLU decisions and 2
  of 249856 max-pool decisions differ at the first step; the gradients
  then differ by up to 9.8e-3 of their scale, and by 0.61 at the second
  step, where 241 ReLU and 140 max-pool decisions differ. So
  paddle_tpu's program is held to the port's decisions
  (``_pin_switches``): each ``relu`` becomes ``x * mask`` and each max
  pool ``4 * avg_pool(x * onehot)``, the mask and the one-hot read from
  the port's run of the same step. Every other op is paddle_tpu's own,
  and the port runs its program as built. Pinned, the gradients read
  4.8e-5 and 6.8e-5 at batch 32; at batch 8 they read 1.1e-4 and
  2.3e-4, largest at the fc batch norm over 8 rows. Two wrong stats
  forms must miss the limit tenfold: one whose backward drops the
  moments' cotangents, and one channel's sum of squares 1e-3 off.

      JAX_PLATFORMS=cpu PYTHONPATH=. \
          python tests/test_torch_benchmark_models.py

  prints the readings at batch 8 and 32, with and without the pins.
- The saved VGG-16 served through ``ModelServer`` matches a direct run of
  the loaded program to 1e-5.
"""
import numpy as np
import pytest
import torch

import paddle_tpu.fluid as fluid
import paddle_tpu_torch as pt
from paddle_tpu_torch import io as pt_io
from paddle_tpu_torch import nets
from paddle_tpu_torch.layer_helper import LayerHelper
from paddle_tpu_torch.compiler import passes as pt_passes
from paddle_tpu_torch.models import benchmark as bm
from paddle_tpu_torch.ops import cuda_kernels as ck

from test_torch_analysis_golden import _bench_models
from test_torch_conv_stats import MomentsDropped

REL = 1e-4
DROPOUT_SIGMAS = 5
# benchmark/fluid/fluid_benchmark.py's default batch
TRAIN_BATCH = 32


def _build(pkg, name, train=True, pins=None):
    """The harness's program in ``pkg``; with a list ``pins``,
    paddle_tpu's ReLUs and max pools are pinned before the backward is
    built (``_pin_switches``) and the fed decisions appended to it."""
    main, startup = pkg.Program(), pkg.Program()
    startup.random_seed = 5
    with pkg.unique_name.guard(), pkg.program_guard(main, startup):
        if pkg is fluid:
            loss = getattr(_bench_models(), name)(None)[0]
        else:
            loss = getattr(bm, name)()[0]
        pred = [op for op in main.global_block().ops
                if op.type == 'softmax'][-1].output('Out')[0]
        if pins is not None:
            pins.extend(_pin_switches(main))
        if train:
            pkg.optimizer.Momentum(learning_rate=0.01,
                                   momentum=0.9).minimize(loss)
    return main, startup, loss.name, pred


def _pin_switches(main):
    """Make paddle_tpu's ``main`` take its ReLU and max-pool decisions
    from fed tensors: ``relu(x)`` becomes ``x * mask`` and a 2x2, stride-2
    max pool ``4 * avg_pool(x * onehot)``, each fed as ``<out>@pin``.
    Both have the gradient of the op they replace wherever the fed
    decision is its own. Returns [(kind, the var the port's decision is
    read from, the fed name)]."""
    block = main.global_block()
    pins, i = [], 0
    while i < len(block.ops):
        op = block.ops[i]
        kind = 'relu' if op.type == 'relu' else 'pool' if (
            op.type == 'pool2d' and op.attrs['pooling_type'] == 'max') \
            else None
        if kind is None:
            i += 1
            continue
        x, out = op.input('X')[0], op.output('Out')[0]
        fed = fluid.layers.data(name=out + '@pin', shape=list(
            block.var(x).shape[1:]), dtype='float32')
        block.remove_op(i)
        if kind == 'relu':
            block.insert_op(i, type='elementwise_mul', inputs={
                'X': [x], 'Y': [fed.name]}, outputs={'Out': [out]},
                attrs={'axis': -1})
            pins.append((kind, out, fed.name))
            i += 1
            continue
        assert [list(op.attrs[k]) for k in (
            'ksize', 'strides', 'paddings')] == [[2, 2], [2, 2], [0, 0]]
        picked = block.create_var(name=out + '@picked',
                                  shape=block.var(x).shape, dtype='float32')
        mean = block.create_var(name=out + '@mean',
                                shape=block.var(out).shape, dtype='float32')
        block.insert_op(i, type='elementwise_mul', inputs={
            'X': [x], 'Y': [fed.name]}, outputs={'Out': [picked.name]},
            attrs={'axis': -1})
        block.insert_op(i + 1, type='pool2d', inputs={'X': [picked.name]},
                        outputs={'Out': [mean.name]},
                        attrs=dict(op.attrs, pooling_type='avg'))
        block.insert_op(i + 2, type='scale', inputs={'X': [mean.name]},
                        outputs={'Out': [out]},
                        attrs={'scale': 4.0, 'bias': 0.0})
        pins.append((kind, x, fed.name))
        i += 3
    return pins


def _decision(kind, x):
    """A ReLU's mask (x > 0), or the one-hot of each 2x2 window's first
    largest element, from the port's ``x``."""
    x = np.asarray(x)
    if kind == 'relu':
        return (x > 0).astype('float32')
    n, c, h, w = x.shape
    win = x.reshape(n, c, h // 2, 2, w // 2, 2).transpose(
        0, 1, 2, 4, 3, 5).reshape(n, c, h // 2, w // 2, 4)
    onehot = np.zeros_like(win)
    np.put_along_axis(onehot, win.argmax(-1)[..., None], 1.0, -1)
    return onehot.reshape(n, c, h // 2, w // 2, 2, 2).transpose(
        0, 1, 2, 4, 3, 5).reshape(n, c, h, w)


def _descs(program):
    return [(op.type, sorted(op.inputs.items()), sorted(op.outputs.items()),
             sorted((k, v) for k, v in op.attrs.items()
                    if not k.startswith('op_')))
            for op in program.global_block().ops]


def _params(t_main, t_startup, seed=0):
    """The port's startup scope as numpy arrays, the batch norms' moving
    means and variances drawn from ``seed``."""
    scope = pt.Scope()
    pt.Executor(pt.CPUPlace()).run(t_startup, scope=scope)
    params = {v.name: pt.executor.as_numpy(scope.raw(v.name))
              for v in t_main.list_vars()
              if v.persistable and scope.raw(v.name) is not None}
    rng = np.random.RandomState(seed)
    for op in t_main.global_block().ops:
        if op.type == 'batch_norm':
            for slot, lo in (('Mean', -0.5), ('Variance', 0.5)):
                n = op.input(slot)[0]
                params[n] = (lo + rng.rand(*params[n].shape)).astype(
                    'float32')
    return params


def _scopes(params):
    j_scope, t_scope = fluid.Scope(), pt.Scope()
    for n, a in params.items():
        j_scope.set_var(n, a)
    pt_io.params_from_numpy(t_scope, params, pt.CPUPlace())
    return j_scope, t_scope


def _feed(name, batch, step):
    shape, classes = bm.IMAGE_SHAPES[name]
    rng = np.random.RandomState(10 + step)
    return {'data': rng.randn(batch, *shape).astype('float32'),
            'label': rng.randint(0, classes, (batch, 1)).astype('int64')}


def _rel(got, ref):
    ref = np.asarray(ref)
    return float(np.abs(np.asarray(got) - ref).max()) / max(
        float(np.abs(ref).max()), 1e-30)


@pytest.mark.parametrize('name', ['mnist', 'vgg'])
def test_models_build_paddle_tpus_program(name):
    j_main, _, j_loss, j_pred = _build(fluid, name)
    t_main, _, t_loss, t_pred = _build(pt, name)
    assert (t_loss, t_pred) == (j_loss, j_pred)
    assert _descs(t_main) == _descs(j_main)


@pytest.mark.parametrize('net', ['simple_img_conv_pool', 'img_conv_group'])
def test_nets_match_paddle_tpu(net):
    """Each composite, op for op, and its output at batch 2 to 1e-5."""
    def build(pkg):
        main, startup = pkg.Program(), pkg.Program()
        mod = fluid.nets if pkg is fluid else nets
        with pkg.unique_name.guard(), pkg.program_guard(main, startup):
            x = pkg.layers.data(name='x', shape=[3, 12, 12],
                                dtype='float32')
            if net == 'simple_img_conv_pool':
                out = mod.simple_img_conv_pool(
                    input=x, num_filters=5, filter_size=3, pool_size=2,
                    pool_stride=2, act='relu')
            else:
                out = mod.img_conv_group(
                    input=x, conv_num_filter=[4, 6], pool_size=2,
                    conv_act='relu', conv_with_batchnorm=[True, False],
                    conv_batchnorm_drop_rate=[0.5, 0.0], pool_stride=2,
                    is_test=True)
        return main, startup, out.name
    j_main, _, j_out = build(fluid)
    t_main, t_startup, t_out = build(pt)
    assert _descs(t_main) == _descs(j_main) and t_out == j_out
    j_scope, t_scope = _scopes(_params(t_main, t_startup))
    feed = {'x': np.random.RandomState(1).randn(2, 3, 12, 12).astype(
        'float32')}
    j_res, = fluid.Executor(fluid.CPUPlace()).run(
        j_main, feed=feed, fetch_list=[j_out], scope=j_scope)
    t_res, = pt.Executor(pt.CPUPlace()).run(
        t_main, feed=feed, fetch_list=[t_out], scope=t_scope)
    np.testing.assert_allclose(t_res, np.asarray(j_res), rtol=1e-5,
                               atol=1e-5)


# ---- dropout ----------------------------------------------------------------
def _dropout_program(shape, p, seed):
    """out = dropout(w) of a parameter w; loss = sum(out * c) of a fed
    c, so d loss / d out is c itself and the gradient of w is c * mask."""
    main, startup = pt.Program(), pt.Program()
    main.random_seed = startup.random_seed = seed
    with pt.unique_name.guard(), pt.program_guard(main, startup):
        c = pt.layers.data(name='c', shape=list(shape[1:]),
                           dtype='float32')
        w = LayerHelper('w').create_parameter(pt.ParamAttr(name='w'),
                                              shape, 'float32')
        out = pt.layers.dropout(w, dropout_prob=p)
        loss = pt.layers.reduce_sum(out * c)
    mask = [op for op in main.global_block().ops
            if op.type == 'dropout'][0].output('Mask')[0]
    return main, startup, out, mask, loss


def test_dropout_at_test_matches_paddle_tpu():
    x = np.random.RandomState(2).randn(4, 6, 5).astype('float32')
    res = {}
    for pkg in (fluid, pt):
        main, startup = pkg.Program(), pkg.Program()
        with pkg.unique_name.guard(), pkg.program_guard(main, startup):
            v = pkg.layers.data(name='x', shape=[6, 5], dtype='float32')
            out = pkg.layers.dropout(v, dropout_prob=0.35, is_test=True)
        res[pkg] = np.asarray(pkg.Executor(pkg.CPUPlace()).run(
            main, feed={'x': x}, fetch_list=[out])[0])
    np.testing.assert_allclose(res[pt], res[fluid], rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(res[pt], x * np.float32(0.65), rtol=1e-6)


def _train_dropout(shape, p, seed):
    main, startup, out, mask, loss = _dropout_program(shape, p, seed)
    pt.backward.append_backward(loss)
    scope = pt.Scope()
    exe = pt.Executor(pt.CPUPlace())
    exe.run(startup, scope=scope)
    w = pt.executor.as_numpy(scope.raw('w'))
    c = np.random.RandomState(3).randn(*shape).astype('float32')
    got = exe.run(main, feed={'c': c}, fetch_list=[out, mask, 'w@GRAD'],
                  scope=scope)
    return w, c, got


def test_dropout_trains_as_x_times_mask():
    """Training: out == w * mask exactly, no rescale; the gradient is
    dy * mask exactly; the mask holds 0 and 1 only."""
    w, c, (out, mask, grad) = _train_dropout((64, 33), 0.4, seed=7)
    assert set(np.unique(mask)) <= {0.0, 1.0}
    np.testing.assert_array_equal(out, w * mask)
    np.testing.assert_array_equal(grad, c * mask)


def test_dropout_kept_fraction_and_seed():
    """The kept fraction of a 256k-element mask lies within 5 sigma of
    1 - p; the program's seed fixes the mask; another seed changes it."""
    p, shape = 0.3, (512, 512)
    _, _, (_, mask, _) = _train_dropout(shape, p, seed=11)
    n = mask.size
    sigma = np.sqrt(p * (1 - p) / n)
    assert abs(mask.mean() - (1 - p)) <= DROPOUT_SIGMAS * sigma
    _, _, (_, again, _) = _train_dropout(shape, p, seed=11)
    np.testing.assert_array_equal(again, mask)
    _, _, (_, other, _) = _train_dropout(shape, p, seed=12)
    assert (other != mask).any()


# ---- mnist and VGG-16 -------------------------------------------------------
@pytest.mark.parametrize('name', ['mnist', 'vgg'])
def test_inference_matches_paddle_tpu(name):
    j_main, _, _, j_pred = _build(fluid, name, train=False)
    t_main, t_startup, _, t_pred = _build(pt, name, train=False)
    j_scope, t_scope = _scopes(_params(t_main, t_startup))
    feed = {'data': _feed(name, 2, 0)['data']}
    j_res, = fluid.Executor(fluid.CPUPlace()).run(
        j_main.clone(for_test=True), feed=feed, fetch_list=[j_pred],
        scope=j_scope)
    pt_passes.reset_fallback_counts()
    t_res, = pt.Executor(pt.CPUPlace()).run(
        t_main.clone(for_test=True), feed=feed, fetch_list=[t_pred],
        scope=t_scope)
    assert pt_passes.FALLBACKS == {}
    assert t_res.shape == (2, 10)
    assert _rel(t_res, j_res) <= REL


def _no_dropout(program):
    for op in program.global_block().ops:
        if op.type == 'dropout':
            op.attrs['dropout_prob'] = 0.0
    program._bump_version()
    return program


def _zero_in_math(program):
    """The gradients of biases added right before a train-mode batch
    norm: its batch mean takes the bias back out."""
    block = program.global_block()
    bn_inputs = {op.input('X')[0] for op in block.ops
                 if op.type == 'batch_norm' and not op.attrs.get('is_test')}
    return {op.input('Y')[0] + '@GRAD' for op in block.ops
            if op.type == 'elementwise_add' and
            op.output('Out')[0] in bn_inputs}


def _two_steps(name, batch, pinned, fetch=()):
    """Both packages from the same weights, two Momentum steps on the
    same batches: per step (paddle_tpu's, the port's) [loss, every
    gradient, each of ``fetch``]. With ``pinned`` paddle_tpu takes the
    port's ReLU and max-pool decisions of the same step."""
    pins = [] if pinned else None
    j_main, _, j_loss, _ = _build(fluid, name, pins=pins)
    t_main, t_startup, t_loss, _ = _build(pt, name)
    _no_dropout(j_main), _no_dropout(t_main)
    grads = sorted(v.name for v in t_main.list_vars()
                   if v.name.endswith('@GRAD'))
    j_scope, t_scope = _scopes(_params(t_main, t_startup))
    read = sorted({x for _, x, _ in pins or ()})
    j_exe, t_exe = fluid.Executor(fluid.CPUPlace()), pt.Executor(
        pt.CPUPlace())
    steps = []
    for step in range(2):
        feed = _feed(name, batch, step)
        t = t_exe.run(t_main, feed=feed, scope=t_scope,
                      fetch_list=[t_loss] + grads + read + list(fetch))
        port = dict(zip(read, t[1 + len(grads):]))
        j_feed = dict(feed, **{fed: _decision(kind, port[x])
                               for kind, x, fed in pins or ()})
        j = j_exe.run(j_main, feed=j_feed, scope=j_scope,
                      fetch_list=[j_loss] + grads + list(fetch))
        steps.append(([np.asarray(v) for v in j], [
            np.asarray(v) for v in t[:1 + len(grads)] + t[
                1 + len(grads) + len(read):]]))
    return grads, steps, t_main


def _gaps(grads, zero, j, t):
    """The loss's relative gap and each gradient's: max |port - jax| over
    its own largest magnitude, or over the largest gradient's for one of
    ``zero``."""
    scale = max(float(np.abs(g).max()) for g in j[1:1 + len(grads)])
    gaps = {}
    for n, a, b in zip(grads, t[1:], j[1:]):
        ref = scale if n in zero else max(float(np.abs(b).max()), 1e-30)
        gaps[n] = float(np.abs(a - b).max()) / ref
    return _rel(t[0], j[0]), gaps


@pytest.fixture(scope='module', params=['mnist', 'vgg'])
def two_steps(request):
    """Two Momentum steps at TRAIN_BATCH in both packages, VGG-16's
    paddle_tpu side pinned to the port's decisions; the fused-conv
    fallbacks counted over the port's steps."""
    name = request.param
    pt_passes.reset_fallback_counts()
    grads, steps, t_main = _two_steps(name, TRAIN_BATCH, name == 'vgg')
    return name, grads, steps, dict(pt_passes.FALLBACKS), t_main


@pytest.mark.parametrize('step', [0, 1])
def test_two_momentum_steps_match_paddle_tpu(two_steps, step):
    name, grads, steps, fallbacks, t_main = two_steps
    assert fallbacks == {}
    fused = [op for op in pt.compiler.optimize(t_main)[0].global_block().ops
             if op.type == 'fused_conv']
    assert len(fused) == {'mnist': 2, 'vgg': 13}[name]
    j, t = steps[step]
    assert np.isfinite(t[0]).all()
    loss_gap, gaps = _gaps(grads, _zero_in_math(t_main), j, t)
    assert loss_gap <= REL
    assert {n: g for n, g in gaps.items() if g > REL} == {}


def _stats_control(forward, function=None):
    """A fused conv for ``conv_for_testing`` whose train-mode regions run
    the stats form through ``function`` on ``forward``."""
    function = function or ck._FusedConvStats

    def conv(x, w, aux, kinds, stages, strides, pads, depthwise,
             emit_stats=False):
        if not emit_stats:
            return ck.fused_conv(x, w, aux, kinds, stages, strides, pads,
                                 depthwise)
        return function.apply((tuple(strides), tuple(pads), bool(depthwise)),
                              forward, x, w)
    return conv


def _first_sumsq_off(x, w, strides, pads, depthwise):
    """The stats form with channel 0's sum of squares 1e-3 too large."""
    y, ssum, ssq = ck._stats_reference(x, w, strides, pads, depthwise)
    return y, ssum, torch.cat([ssq[:1] * (1 + 1e-3), ssq[1:]])


@pytest.mark.parametrize('control', ['moments_dropped', 'first_sumsq_off'])
def test_vgg_steps_catch_a_wrong_stats_form(control):
    """The pinned comparison fails for a wrong stats form on the port's
    side: one whose backward ignores the moments' cotangents, and one
    channel's sum of squares 1e-3 off in each region."""
    conv = _stats_control(ck._stats_reference, MomentsDropped) \
        if control == 'moments_dropped' else _stats_control(_first_sumsq_off)
    with pt_passes.conv_for_testing(conv):
        grads, steps, t_main = _two_steps('vgg', TRAIN_BATCH, True)
    _, gaps = _gaps(grads, _zero_in_math(t_main), *steps[0])
    assert max(gaps.values()) > 10 * REL


def test_saved_vgg_served_matches_a_direct_run(tmp_path):
    main, startup, _, pred = _build(pt, 'vgg', train=False)
    scope = pt.Scope()
    exe = pt.Executor(pt.CPUPlace())
    exe.run(startup, scope=scope)
    for n, a in _params(main, startup).items():
        scope.set_var(n, torch.from_numpy(a))
    d = str(tmp_path / 'vgg')
    with pt.scope_guard(scope):
        pt.io.save_inference_model(d, ['data'], [main.global_block().var(
            pred)], exe, main_program=main)
    images = _feed('vgg', 3, 4)['data']
    load_scope = pt.Scope()
    with pt.scope_guard(load_scope):
        prog, feeds, fetches = pt.io.load_inference_model(d, exe)
    direct, = exe.run(prog, feed={feeds[0]: images}, fetch_list=fetches,
                      scope=load_scope)
    with pt.serving.ModelServer(pt.CPUPlace(), max_batch_size=4) as server:
        server.load_model('vgg', d)
        served, = server.infer('vgg', {'data': images})
    assert served.shape == (3, 10)
    np.testing.assert_allclose(served, direct, rtol=1e-5, atol=1e-5)


def _readings():
    """VGG-16's two steps at batch 8 and 32: without the pins, the loss
    and gradient gaps and the ReLU and max-pool decisions that differ
    between the packages, layer by layer; with them, the gaps."""
    for batch in (8, TRAIN_BATCH):
        for pinned in (False, True):
            block = _build(pt, 'vgg')[0].global_block()
            switches = [(op.type, op.input('X')[0]) for op in block.ops
                        if op.type == 'relu' or (op.type == 'pool2d' and
                        op.attrs['pooling_type'] == 'max')]
            outs = [n for _, n in switches]
            grads, steps, t_main = _two_steps('vgg', batch, pinned,
                                              fetch=outs)
            zero = _zero_in_math(t_main)
            for step, (j, t) in enumerate(steps):
                k = 1 + len(grads)
                loss, gaps = _gaps(grads, zero, j[:k], t[:k])
                live = [g for n, g in gaps.items() if n not in zero]
                worst = max(gaps, key=gaps.get)
                line = ('batch %d, %s, step %d: loss %.3g, gradients max '
                        '%.3g (%s), median %.3g' % (
                            batch, 'pinned' if pinned else 'not pinned',
                            step, loss, gaps[worst], worst,
                            np.median(live)))
                if not pinned:
                    differ = [int((_decision(
                        'relu' if kind == 'relu' else 'pool', a) !=
                        _decision('relu' if kind == 'relu' else 'pool',
                                  b)).sum())
                        for (kind, _), a, b in zip(switches, j[k:], t[k:])]
                    line += '; decisions that differ, ReLU %s of %d, ' \
                        'max pool %s of %d' % (
                            [d for (kind, _), d in zip(switches, differ)
                             if kind == 'relu'],
                            sum(a.size for (kind, _), a in zip(
                                switches, t[k:]) if kind == 'relu'),
                            [d for (kind, _), d in zip(switches, differ)
                             if kind != 'relu'],
                            sum(a.size // 4 for (kind, _), a in zip(
                                switches, t[k:]) if kind != 'relu'))
                print(line, flush=True)


if __name__ == '__main__':
    _readings()
