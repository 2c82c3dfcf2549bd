"""MobileNet-v1 through the port's Executor and passes against paddle_tpu's,
on the CPU.

Both packages build ``chip_smoke.mobilenet_v1`` (the network phase 22b
serves and trains on the card) with their own layers, at width
multiplier 0.25, 32 x 32 input, batch 2, all 13 depthwise-separable
blocks and 1000 classes. Both get the same numpy parameters (JAX's
startup draws them, every batch norm's statistics and affine randomized)
through ``io.params_from_numpy`` on the port's side.

- Served: each package saves an inference model (logits and
  probabilities) and loads it into a fresh scope; the port's logits
  equal paddle_tpu's to 1e-4 (f32 on both sides; 27 convs summed in
  another order). The port's pipeline makes 27 fused_conv regions, 13 of
  them depthwise (the depthwise kernel's plain version on the CPU).
- Trained: one Momentum(0.01, 0.9) step of each package's training
  program at batch 8; the port runs every conv region on the stats form,
  its 13 depthwise regions among them. The loss agrees to 1e-4 (read
  1.3e-6). The gradients, by relative L2 per tensor, are held to
  GRAD_MAX for the largest and GRAD_MEDIAN for the median (read 2.3e-4
  and 1.1e-4): f32 sums through 27 train-mode batch norms in another
  order, with no residual path, move a random network's gradients by
  more than 1e-4 (the port's own gradients move by 5.8e-4 at most, 2.3e-4
  in the median, for a 1e-6 relative change of the images). A control,
  the stats form's autograd Function with the moments' cotangents
  dropped, misses both limits. The step runs at batch 8, not 2: at batch
  2 the last two blocks' batch norms (1 x 1 pixels) normalise 2 values a
  channel, and there the gradients are rounding noise in both packages
  (they differ by 2.1e-2, and the port's own move by 13% in the median
  for that change of the images).
"""
import contextlib
import os
import sys

import numpy as np
import pytest

import paddle_tpu.fluid as fluid
import paddle_tpu_torch as pt
from paddle_tpu_torch import io as pt_io
from paddle_tpu_torch.compiler import passes as pt_passes
from paddle_tpu_torch.ops import cuda_kernels as ck

from test_torch_conv import randomized_params
from test_torch_conv_stats import MomentsDropped

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
import chip_smoke  # noqa: E402

SCALE, SIZE, BATCH, CLASSES = 0.25, 32, 2, 1000
TRAIN_BATCH = 8
TOL = 1e-4
GRAD_MAX, GRAD_MEDIAN = 1e-3, 3e-4
REGIONS, DEPTHWISE = 27, 13


def _build(pkg, train):
    main, startup = pkg.Program(), pkg.Program()
    startup.random_seed = 5
    with pkg.unique_name.guard(), pkg.program_guard(main, startup):
        img = pkg.layers.data(name='data', shape=[3, SIZE, SIZE],
                              dtype='float32')
        prob = chip_smoke.mobilenet_v1(pkg.layers, img, CLASSES, SCALE)
        loss = None
        if train:
            label = pkg.layers.data(name='label', shape=[1], dtype='int64')
            loss = pkg.layers.mean(pkg.layers.cross_entropy(input=prob,
                                                            label=label))
            pkg.optimizer.Momentum(learning_rate=0.01,
                                   momentum=0.9).minimize(loss)
    return main, startup, prob, loss


def _descs(program):
    return [(op.type, sorted(op.inputs.items()), sorted(op.outputs.items()),
             sorted(op.attrs.items())) for op in program.global_block().ops]


def _logits(main):
    softmax, = [op for op in main.global_block().ops
                if op.type == 'softmax']
    return main.global_block().var(softmax.input('X')[0])


def _regions(main, fetch_names):
    """The port's fused_conv regions after its pass pipeline: (count,
    depthwise count)."""
    opt, _ = pt.compiler.optimize(main, fetch_names=fetch_names)
    block = opt.global_block()
    total = dw = 0
    for op in block.ops:
        if op.type != 'fused_conv':
            continue
        total += 1
        _, ins, _, attrs = op.attrs['sub_ops'][0]
        cin = block.var(ins['Input'][0]).shape[1]
        dw += (attrs.get('groups', 1) or 1) == cin and \
            block.var(ins['Filter'][0]).shape[1] == 1
    return total, dw


def _feed(seed, batch=BATCH, label=False):
    rng = np.random.RandomState(seed)
    feed = {'data': rng.randn(batch, 3, SIZE, SIZE).astype('float32')}
    if label:
        feed['label'] = rng.randint(0, CLASSES, (batch, 1)).astype('int64')
    return feed


def _rel_l2(got, ref):
    ref = np.asarray(ref, dtype='float64')
    return np.linalg.norm(np.asarray(got, dtype='float64') - ref) / max(
        np.linalg.norm(ref), 1e-30)


@pytest.fixture(scope='module')
def served(tmp_path_factory):
    """paddle_tpu's logits from its saved model, and the port's from its
    own and from paddle_tpu's."""
    j_main, j_startup, j_prob, _ = _build(fluid, False)
    t_main, _, t_prob, _ = _build(pt, False)
    params = randomized_params(j_main, j_startup)
    feed = _feed(4)
    j_dir = str(tmp_path_factory.mktemp('jax_mobilenet'))
    j_exe = fluid.Executor(fluid.CPUPlace())
    scope = fluid.Scope()
    for n, a in params.items():
        scope.set_var(n, a)
    with fluid.scope_guard(scope):
        fluid.io.save_inference_model(j_dir, ['data'],
                                      [_logits(j_main), j_prob], j_exe,
                                      main_program=j_main)
    j_scope = fluid.Scope()
    prog, _, fetch = fluid.io.load_inference_model(j_dir, j_exe,
                                                   scope=j_scope)
    ref = j_exe.run(prog, feed=feed, fetch_list=fetch, scope=j_scope)

    t_dir = str(tmp_path_factory.mktemp('port_mobilenet'))
    t_exe = pt.Executor(pt.CPUPlace())
    scope = pt.Scope()
    pt_io.params_from_numpy(scope, params, pt.CPUPlace())
    pt_io.save_inference_model(t_dir, ['data'], [_logits(t_main), t_prob],
                               t_exe, main_program=t_main, scope=scope)
    got = {}
    for saved_by, d in (('port', t_dir), ('jax', j_dir)):
        t_scope = pt.Scope()
        prog, feed_names, fetch = pt_io.load_inference_model(d, t_exe,
                                                             scope=t_scope)
        assert feed_names == ['data']
        pt_passes.reset_fallback_counts()
        got[saved_by] = t_exe.run(prog, feed=feed, fetch_list=fetch,
                                  scope=t_scope)
        assert pt_passes.FALLBACKS == {}
        got[saved_by + '_regions'] = _regions(prog, [f.name for f in fetch])
    return dict(j_main=j_main, t_main=t_main,
                ref=[np.asarray(a) for a in ref], got=got)


def test_port_builds_jax_program(served):
    assert _descs(served['t_main']) == _descs(served['j_main'])
    assert [op.type for op in served['t_main'].global_block().ops].count(
        'conv2d') == REGIONS


@pytest.mark.parametrize('saved_by', ['port', 'jax'])
def test_served_mobilenet_matches_jax(served, saved_by):
    (logits, prob), (ref_logits, ref_prob) = served['got'][saved_by], \
        served['ref']
    assert served['got'][saved_by + '_regions'] == (REGIONS, DEPTHWISE)
    assert logits.shape == (BATCH, CLASSES)
    np.testing.assert_allclose(prob.sum(1), 1.0, rtol=1e-5)
    assert np.abs(ref_logits).max() > 0.1       # logits that tell apart
    np.testing.assert_allclose(logits, ref_logits, rtol=TOL,
                               atol=TOL * np.abs(ref_logits).max())
    np.testing.assert_allclose(prob, ref_prob, rtol=TOL, atol=1e-7)


def _moments_dropped(x, w, aux, kinds, stages, strides, pads, depthwise,
                     emit_stats=False):
    """The fused conv with the stats form's backward ignoring the
    moments' cotangents (a control)."""
    if not emit_stats:
        return ck.fused_conv(x, w, aux, kinds, stages, strides, pads,
                             depthwise)
    return MomentsDropped.apply((tuple(strides), tuple(pads),
                                 bool(depthwise)), ck._stats_reference, x, w)


@pytest.fixture(scope='module')
def trained():
    """One Momentum step of each package from the same parameters and
    batch, fetching the loss and every gradient; the port's step again
    with the control."""
    j_main, j_startup, _, j_loss = _build(fluid, True)
    t_main, _, _, t_loss = _build(pt, True)
    params = randomized_params(j_main, j_startup)
    grads = sorted(v.name for v in t_main.list_vars()
                   if v.name.endswith('@GRAD') and
                   v.name[:-len('@GRAD')] in params)
    fetch = [j_loss.name] + grads
    feed = _feed(6, TRAIN_BATCH, label=True)
    j_scope = fluid.Scope()
    for n, a in params.items():
        j_scope.set_var(n, a)
    ref = fluid.Executor(fluid.CPUPlace()).run(j_main, feed=feed,
                                               fetch_list=fetch,
                                               scope=j_scope)
    runs = {}
    for name, conv in (('port', None), ('control', _moments_dropped)):
        t_scope = pt.Scope()
        pt_io.params_from_numpy(t_scope, params, pt.CPUPlace())
        pt_passes.reset_fallback_counts()
        with pt_passes.conv_for_testing(conv) if conv else \
                contextlib.nullcontext():
            runs[name] = pt.Executor(pt.CPUPlace()).run(
                t_main, feed=feed, fetch_list=fetch, scope=t_scope)
        runs[name + '_fallbacks'] = dict(pt_passes.FALLBACKS)
    return dict(j_main=j_main, t_main=t_main, fetch=fetch, grads=grads,
                ref=[np.asarray(a) for a in ref], runs=runs,
                regions=_regions(t_main, [t_loss.name]))


def test_training_program_has_13_depthwise_stats_regions(trained):
    assert _descs(trained['t_main']) == _descs(trained['j_main'])
    assert trained['regions'] == (REGIONS, DEPTHWISE)
    assert trained['runs']['port_fallbacks'] == {}
    # every conv's filter, batch norm's affine and the fc's weight and bias
    assert len(trained['grads']) == 3 * REGIONS + 2


def _grad_errors(fetch, got, ref):
    """Relative L2 error of each gradient: (max, its name, median)."""
    errs = {n: _rel_l2(g, r) for n, g, r in zip(fetch[1:], got[1:],
                                                 ref[1:])}
    worst = max(errs, key=errs.get)
    return errs[worst], worst, float(np.median(list(errs.values())))


def test_momentum_step_matches_jax(trained):
    got, ref = trained['runs']['port'], trained['ref']
    np.testing.assert_allclose(got[0], ref[0], rtol=TOL)
    worst, name, median = _grad_errors(trained['fetch'], got, ref)
    assert worst <= GRAD_MAX and median <= GRAD_MEDIAN, (worst, name,
                                                         median)
    worst, _, median = _grad_errors(trained['fetch'],
                                    trained['runs']['control'], ref)
    assert worst > GRAD_MAX and median > GRAD_MEDIAN
