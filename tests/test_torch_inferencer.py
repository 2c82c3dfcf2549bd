"""paddle_tpu_torch.Inferencer against paddle_tpu's, on the CPU.

A conv + batch-norm net (two conv/BN/relu blocks, a pool and an fc with
softmax) is built and initialised by the JAX package, its batch norms'
statistics and affine randomized, and its parameters saved with
``save_params``. Both packages' Inferencers build the net with their own
layers and read that directory; their answers must agree to 1e-5 (f32,
a few ops), through shape buckets (3 rows pad to 4) and with BN folding
(``optimize_for_inference``: the folded program keeps no batch_norm and
stays within 1e-5 of the unfolded one).
"""
import numpy as np
import pytest
import torch

import paddle_tpu.fluid as fluid
from paddle_tpu.compiler import tuning as ctuning
from paddle_tpu.inferencer import Inferencer as JaxInferencer
import paddle_tpu_torch as pt
from paddle_tpu_torch.compiler import passes as pt_passes

from test_torch_conv import randomize_batch_norms

TOL = dict(atol=1e-5, rtol=1e-5)


@pytest.fixture(autouse=True)
def _defaults():
    prev = ctuning.set_default_cache(
        ctuning.TuningCache(path='/nonexistent/paddle-tpu-test-tuning'))
    pt_passes.reset_fallback_counts()
    yield
    ctuning.set_default_cache(prev)


def _net(pkg):
    def infer_func():
        L = pkg.layers
        t = L.data(name='img', shape=[3, 8, 8], dtype='float32')
        for nf in (4, 8):
            c = L.conv2d(input=t, num_filters=nf, filter_size=3, padding=1,
                         bias_attr=False)
            t = L.batch_norm(input=c, act='relu', is_test=True)
        t = L.pool2d(input=t, pool_size=2, pool_type='max', pool_stride=2)
        return L.fc(input=t, size=5, act='softmax')
    return infer_func


@pytest.fixture(scope='module')
def param_dir(tmp_path_factory):
    """The JAX package's parameters for the net, BN statistics and
    affine randomized, saved with save_params."""
    main, startup = fluid.Program(), fluid.Program()
    startup.random_seed = 3
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        _net(fluid)()
    scope = fluid.Scope()
    exe = fluid.Executor(fluid.CPUPlace())
    exe.run(startup, scope=scope)
    params = randomize_batch_norms(main, {
        v.name: np.asarray(scope.raw(v.name))
        for v in main.global_block().all_parameters()})
    for n, a in params.items():
        scope.set_var(n, a)
    d = str(tmp_path_factory.mktemp('inferencer_params'))
    with fluid.scope_guard(scope):
        fluid.io.save_params(exe, d, main_program=main)
    return d


def _images(n, seed=5):
    return {'img': np.random.RandomState(seed).randn(n, 3, 8, 8).astype(
        'float32')}


@pytest.mark.parametrize('fold', [False, True])
@pytest.mark.parametrize('rows', [1, 3, 4])
def test_inferencer_matches_jax(param_dir, rows, fold):
    j = JaxInferencer(_net(fluid), param_dir, place=fluid.CPUPlace(),
                      optimize_for_inference=fold)
    t = pt.Inferencer(_net(pt), param_dir, place=pt.CPUPlace(),
                      optimize_for_inference=fold)
    feed = _images(rows)
    j_out, = j.infer(feed)
    t_out, = t.infer(feed)
    assert t_out.shape == (rows, 5)
    np.testing.assert_allclose(t_out, np.asarray(j_out), **TOL)
    assert pt_passes.FALLBACKS == {}


def test_folded_program_keeps_no_batch_norm(param_dir):
    raw = pt.Inferencer(_net(pt), param_dir, place=pt.CPUPlace())
    folded = pt.Inferencer(_net(pt), param_dir, place=pt.CPUPlace(),
                           optimize_for_inference=True)
    types = [op.type for op in folded.inference_program.global_block().ops]
    assert 'batch_norm' not in types and types.count('fused_conv') == 2
    assert 'batch_norm' in [op.type for op in
                            raw.inference_program.global_block().ops]
    feed = _images(6, seed=9)
    np.testing.assert_allclose(folded.infer(feed)[0], raw.infer(feed)[0],
                               **TOL)


def test_buckets_strip_pad_rows(param_dir):
    """3 rows pad to a bucket of 4 and come back as the bucket-sized
    run's first 3 rows; without buckets each batch runs as it comes."""
    inf = pt.Inferencer(_net(pt), param_dir, place=pt.CPUPlace())
    plain = pt.Inferencer(_net(pt), param_dir, place=pt.CPUPlace(),
                          bucket_batches=False)
    feed = _images(3)
    padded = {'img': np.concatenate([feed['img'], feed['img'][-1:]])}
    got, = inf.infer(feed)
    whole, = plain.infer(padded)
    np.testing.assert_array_equal(got, whole[:3])
    np.testing.assert_allclose(plain.infer(feed)[0], got, **TOL)
    with pytest.raises(ValueError, match='map'):
        inf.infer([feed['img']])


def test_inferencer_defaults_to_the_card(param_dir, monkeypatch):
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match='CUDA is not available'):
        pt.Inferencer(_net(pt), param_dir)


def test_parallel_is_not_ported(param_dir):
    with pytest.raises(NotImplementedError, match='Queue A item 1'):
        pt.Inferencer(_net(pt), param_dir, place=pt.CPUPlace(),
                      parallel=True)
