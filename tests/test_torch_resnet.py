"""The ResNet serving slice end to end: ResNet-50 (depth 50, 1000 classes)
at 32 x 32 input, batch 2, on the CPU.

Both packages build the model with their own layers; the JAX package's
startup draws the weights, every batch norm's statistics and affine are
randomized, and both scopes get the same numpy values. Each package
saves an inference model and loads it into a fresh scope; the port
serves through its conv-epilogue fusion (53 fused_conv ops, each on the
fused conv's plain version) and must give paddle_tpu's probabilities to
rtol = 1e-4 (f32 on both sides: 53 convs summed in another order).
"""
import numpy as np
import pytest

import paddle_tpu.fluid as fluid
from paddle_tpu.models.resnet import resnet_imagenet as jax_resnet
import paddle_tpu_torch as pt
from paddle_tpu_torch import io as pt_io
from paddle_tpu_torch.compiler import passes as pt_passes
from paddle_tpu_torch.models.resnet import resnet_imagenet as pt_resnet

from test_torch_conv import randomized_params

TOL = dict(rtol=1e-4, atol=1e-7)
CLASSES = 1000


def _build(pkg, resnet):
    main, startup = pkg.Program(), pkg.Program()
    startup.random_seed = 3
    with pkg.unique_name.guard(), pkg.program_guard(main, startup):
        img = pkg.layers.data(name='img', shape=[3, 32, 32], dtype='float32')
        out = resnet(img, CLASSES, depth=50)
    return main, startup, out


def _descs(program):
    return [(op.type, sorted(op.inputs.items()), sorted(op.outputs.items()),
             sorted(op.attrs.items())) for op in program.global_block().ops]


@pytest.fixture(scope='module')
def models(tmp_path_factory):
    """Both packages' programs, the shared parameters, each package's
    saved artifact, and paddle_tpu's probabilities on one batch."""
    j_main, j_startup, j_out = _build(fluid, jax_resnet)
    t_main, _, t_out = _build(pt, pt_resnet)
    params = randomized_params(j_main, j_startup)
    # random weights through 16 residual blocks give logits of std ~700:
    # scale the classifier so the probabilities are not one-hot and the
    # comparison below sees them
    fc_w, = [op.input('Y')[0] for op in j_main.global_block().ops
             if op.type == 'mul']
    params[fc_w] = params[fc_w] * 3e-3
    feed = {'img': np.random.RandomState(4).randn(2, 3, 32, 32)
            .astype('float32')}

    j_dir = str(tmp_path_factory.mktemp('jax_resnet'))
    j_exe = fluid.Executor(fluid.CPUPlace())
    scope = fluid.Scope()
    for n, a in params.items():
        scope.set_var(n, a)
    with fluid.scope_guard(scope):
        fluid.io.save_inference_model(j_dir, ['img'], [j_out], j_exe,
                                      main_program=j_main)
    j_scope = fluid.Scope()
    prog, _, fetch = fluid.io.load_inference_model(j_dir, j_exe,
                                                   scope=j_scope)
    ref, = j_exe.run(prog, feed=feed, fetch_list=fetch, scope=j_scope)

    t_dir = str(tmp_path_factory.mktemp('port_resnet'))
    t_exe = pt.Executor(pt.CPUPlace())
    scope = pt.Scope()
    pt_io.params_from_numpy(scope, params, pt.CPUPlace())
    pt_io.save_inference_model(t_dir, ['img'], [t_out], t_exe,
                               main_program=t_main, scope=scope)
    return dict(j_main=j_main, t_main=t_main, feed=feed,
                ref=np.asarray(ref), dirs={'jax': j_dir, 'port': t_dir})


def test_port_builds_jax_program(models):
    assert _descs(models['t_main']) == _descs(models['j_main'])


@pytest.mark.parametrize('saved_by', ['port', 'jax'])
def test_served_resnet50_matches_jax(models, saved_by):
    exe = pt.Executor(pt.CPUPlace())
    scope = pt.Scope()
    prog, feed_names, fetch = pt_io.load_inference_model(
        models['dirs'][saved_by], exe, scope=scope)
    assert feed_names == ['img']
    assert {op.attrs['is_test'] for op in prog.global_block().ops
            if op.type == 'batch_norm'} == {True}
    pt_passes.reset_fallback_counts()
    out, = exe.run(prog, feed=models['feed'], fetch_list=fetch, scope=scope)
    assert pt_passes.FALLBACKS == {}
    opt, _ = pt.compiler.optimize(prog,
                                  fetch_names=[f.name for f in fetch])
    assert [op.type for op in opt.global_block().ops].count(
        'fused_conv') == 53
    assert out.shape == (2, CLASSES)
    np.testing.assert_allclose(out.sum(1), 1.0, rtol=1e-5)
    assert models['ref'].max() < 0.5      # informative probabilities
    np.testing.assert_allclose(out, models['ref'], **TOL)
    assert (out.argmax(1) == models['ref'].argmax(1)).all()
