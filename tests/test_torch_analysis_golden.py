"""Golden verifier sweep of the port: the static analyzer over every
program the port trains or serves must report ZERO error diagnostics,
and the same diagnostics as paddle_tpu's analyzer on paddle_tpu's build
of the same program.

The port's counterpart of tests/test_analysis_golden.py, over the
programs the port runs: conv-mnist and VGG-16 as the benchmark harness
builds them (benchmark/fluid/models.py:24-48, Momentum(0.01, 0.9)), the
flagship transformer at 2 layers (small widths), ResNet-50 at 32x32,
stacked_dynamic_lstm and machine_translation (small widths), and book
08 (models/books.py at narrow widths): its DynamicRNN training program
and its two decode programs, the dynamic While and the static [B*K]. Each is
checked as the training program, as its ``clone(for_test=True)``
inference twin, through the default passes under
``PassPipeline(verify=True)`` and, on the inference twin pruned to its
target with the weights in a scope, through the inference pipeline (``bn_fold`` first)
under the sanitizer: no ``PassVerificationError``, and the rewritten
program verifies clean.
"""
import importlib.util
import os

import pytest

import paddle_tpu.fluid as fluid
import paddle_tpu.analysis as JA
from paddle_tpu.models import resnet as j_resnet
import paddle_tpu_torch as pt
import paddle_tpu_torch.analysis as A
from paddle_tpu_torch import compiler
from paddle_tpu_torch.compiler.pass_base import PassPipeline
from paddle_tpu_torch.models import benchmark as bm
from paddle_tpu_torch.models import resnet as t_resnet
from paddle_tpu_torch.models.fluid_transformer import transformer as \
    t_transformer

from paddle_tpu_torch.models import books
from test_torch_books import (MT_DECODE, MT_W, _jax_mt_decode_dynamic,
                              _jax_mt_decode_static, _jax_mt_train)
from test_torch_stacked_lstm import machine_translation, \
    stacked_dynamic_lstm

pytestmark = pytest.mark.analysis

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FLAGSHIP = dict(vocab=64, d_model=32, n_heads=2, n_layers=2, d_ff=64,
                seq=16)


def _bench_models():
    """benchmark/fluid/models.py, paddle_tpu's builders."""
    spec = importlib.util.spec_from_file_location(
        '_bench_fluid_models',
        os.path.join(_ROOT, 'benchmark', 'fluid', 'models.py'))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _momentum(pkg, loss):
    pkg.optimizer.Momentum(learning_rate=0.01, momentum=0.9).minimize(loss)


def _mnist(pkg):
    loss = _bench_models().mnist(None)[0] if pkg is fluid else bm.mnist()[0]
    _momentum(pkg, loss)
    return ('data', 'label'), loss


def _vgg(pkg):
    loss = _bench_models().vgg(None)[0] if pkg is fluid else bm.vgg()[0]
    _momentum(pkg, loss)
    return ('data', 'label'), loss


def _flagship(pkg):
    build = _bench_models().transformer if pkg is fluid else t_transformer
    loss = build(None, **FLAGSHIP)[0]
    pkg.optimizer.Adam(learning_rate=1e-3).minimize(loss)
    return ('data', 'label', 'pos'), loss


def _resnet50(pkg):
    mod = j_resnet if pkg is fluid else t_resnet
    img = pkg.layers.data(name='data', shape=[3, 32, 32], dtype='float32')
    label = pkg.layers.data(name='label', shape=[1], dtype='int64')
    pred = mod.resnet_imagenet(img, class_dim=10, depth=50)
    loss = pkg.layers.mean(pkg.layers.cross_entropy(input=pred,
                                                    label=label))
    _momentum(pkg, loss)
    return ('data', 'label'), loss


def _stacked_lstm(pkg):
    loss, _ = stacked_dynamic_lstm(pkg, dict_size=100, emb_dim=16,
                                   hid_dim=16, stacked_num=3)
    _momentum(pkg, loss)
    return ('data', 'label'), loss


def _machine_translation(pkg):
    loss = machine_translation(pkg, dict_size=50, emb_dim=8, hid_dim=8)
    _momentum(pkg, loss)
    return ('data', 'trg', 'label'), loss


def _book08_train(pkg):
    if pkg is fluid:
        _, _, loss = _jax_mt_train(**MT_W)
    else:
        book = books.machine_translation(**MT_W)
        books.train(book)
        loss = book.loss
    return ('src_word_id', 'target_language_word',
            'target_language_next_word'), loss


def _book08_decode(dynamic):
    def build(pkg):
        w = dict(MT_W, **MT_DECODE)
        if pkg is fluid:
            feeds, ids, _ = (_jax_mt_decode_dynamic if dynamic
                             else _jax_mt_decode_static)(**w)
        else:
            feeds, ids, _ = (books.decode_dynamic if dynamic
                             else books.decode_static)(**w)
        return tuple(v.name for v in feeds), ids
    return build


BUILDERS = {'conv_mnist': _mnist, 'vgg16': _vgg, 'flagship': _flagship,
            'resnet50': _resnet50, 'stacked_lstm': _stacked_lstm,
            'machine_translation': _machine_translation,
            'book08_train': _book08_train,
            'book08_decode_dynamic': _book08_decode(True),
            'book08_decode_static': _book08_decode(False)}


def _build(pkg, name):
    main, startup = pkg.Program(), pkg.Program()
    with pkg.unique_name.guard(), pkg.program_guard(main, startup):
        feeds, loss = BUILDERS[name](pkg)
    return main, startup, feeds, loss.name


def _key(d):
    return (d.code, d.severity, d.block_idx, d.op_index, d.op_type,
            d.var_names)


def _clean(diags):
    errs = [d for d in diags if d.is_error]
    assert not errs, A.format_diagnostics(errs)


@pytest.mark.parametrize('for_test', [False, True],
                         ids=['train', 'inference_clone'])
@pytest.mark.parametrize('name', sorted(BUILDERS))
def test_golden_program_verifies_clean_and_as_paddle_tpu(name, for_test):
    t_main, _, feeds, loss = _build(pt, name)
    j_main, _, j_feeds, j_loss = _build(fluid, name)
    assert (feeds, loss) == (j_feeds, j_loss)
    if for_test:
        t_main, j_main = t_main.clone(for_test=True), \
            j_main.clone(for_test=True)
    diags = A.verify_program(t_main, feeds=feeds, fetch_names=(loss,))
    _clean(diags)
    j_diags = JA.verify_program(j_main, feeds=feeds, fetch_names=(loss,))
    assert [_key(d) for d in diags] == [_key(d) for d in j_diags]
    assert [d.message for d in diags] == [d.message for d in j_diags]
    assert A.infer_program(t_main)[2] == JA.infer_program(j_main)[2]


@pytest.mark.parametrize('name', sorted(BUILDERS))
def test_golden_default_pipeline_sanitizes_clean(name):
    main, _, feeds, loss = _build(pt, name)
    pipe = PassPipeline(compiler.default_pipeline().passes, name='golden',
                        verify=True)
    out, results = pipe.run(main, protected=(loss,))
    assert [r.pass_name for r in results] == \
        list(compiler.pipeline_signature())
    # the sanitized pipeline still optimizes (it must not be inert)
    assert any(r.changed for r in results)
    _clean(A.verify_program(out, feeds=feeds, fetch_names=(loss,)))
    # and its diagnostics are paddle_tpu's on paddle_tpu's rewrite
    j_main, _, _, _ = _build(fluid, name)
    j_out, _ = fluid.compiler.optimize(j_main, fetch_names=[loss])
    assert [_key(d) for d in A.verify_program(
        out, feeds=feeds, fetch_names=(loss,))] == \
        [_key(d) for d in JA.verify_program(
            j_out, feeds=feeds, fetch_names=(loss,))]


@pytest.mark.parametrize('name', sorted(BUILDERS))
def test_golden_inference_pipeline_sanitizes_clean(name):
    main, startup, feeds, loss = _build(pt, name)
    # the served program: the inference twin pruned to its target, as
    # io.save_inference_model saves it
    infer = main.clone(for_test=True).prune([loss])
    scope = pt.Scope()
    pt.Executor(pt.CPUPlace()).run(startup, scope=scope)
    pipe = PassPipeline(compiler.inference_pipeline().passes,
                        name='golden-inference', verify=True)
    out, results = pipe.run(infer, scope=scope, protected=(loss,))
    assert [r.pass_name for r in results] == \
        list(compiler.INFERENCE_PASSES)
    if name == 'resnet50':       # every batch norm sits on its conv
        assert not any(op.type == 'batch_norm'
                       for op in out.global_block().ops)
    _clean(A.verify_program(out, feeds=feeds, fetch_names=(loss,)))


def test_golden_sweep_covers_conv_regions_and_dropout():
    """The sweep reaches the ops this slice adds to the port's paths:
    dropout (VGG) and fused_conv regions with a train-mode batch norm
    behind the conv's bias (VGG) and without a batch norm (mnist)."""
    main, _, _, loss = _build(pt, 'vgg16')
    assert sum(op.type == 'dropout' for op in main.global_block().ops) == 10
    for name, kinds in (('vgg16', {('conv2d', 'elementwise_add',
                                    'batch_norm', 'relu')}),
                        ('conv_mnist', {('conv2d', 'elementwise_add',
                                         'relu')})):
        main, _, _, loss = _build(pt, name)
        out, _ = compiler.optimize(main, fetch_names=[loss])
        regions = {tuple(op.attrs['fused_types'])
                   for op in out.global_block().ops
                   if op.type == 'fused_conv'}
        assert regions == kinds, regions
