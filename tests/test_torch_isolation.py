"""paddle_tpu_torch stands alone: it imports neither JAX nor paddle_tpu
(not in its sources, and not while it serves the transformer or ResNet
through its compiler and its serving runtime, verifies, sanitizes
and trains mnist through its static analysis, or takes a fit_a_line
step through its fluid namespace, readers, dataset and DataFeeder), and
its entry points default to the card."""
import ast
import os
import subprocess
import sys

import pytest
import torch

import paddle_tpu_torch as pt

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_FORBIDDEN = ('jax', 'jaxlib', 'paddle_tpu')


def _forbidden(module):
    return any(module == f or module.startswith(f + '.') for f in _FORBIDDEN)


def _port_sources():
    paths = [os.path.join(_ROOT, 'chip_smoke.py')]
    for dirpath, _, files in os.walk(os.path.join(_ROOT, 'paddle_tpu_torch')):
        paths.extend(os.path.join(dirpath, f) for f in sorted(files)
                     if f.endswith('.py'))
    return paths


def test_no_source_imports_jax_or_paddle_tpu():
    bad = []
    for path in _port_sources():
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                mods = [node.module or '']
            elif isinstance(node, ast.Call) and getattr(
                    node.func, 'attr', getattr(node.func, 'id', '')) in (
                        'import_module', '__import__') and node.args and \
                    isinstance(node.args[0], ast.Constant):
                mods = [str(node.args[0].value)]
            else:
                continue
            bad.extend('%s:%d %s' % (os.path.relpath(path, _ROOT),
                                     node.lineno, m)
                       for m in mods if _forbidden(m))
    assert len(_port_sources()) > 20
    assert not bad, bad


_SUBPROCESS = r'''
import sys
sys.modules['jax'] = None          # any import of jax now raises
import numpy as np
import paddle_tpu_torch as pt
from paddle_tpu_torch.models.fluid_transformer import transformer
main, startup = pt.Program(), pt.Program()
with pt.unique_name.guard(), pt.program_guard(main, startup):
    loss, feed_fn, _, logits = transformer(vocab=64, d_model=32, n_heads=1,
                                           n_layers=1, d_ff=64, seq=32)
scope = pt.Scope()
exe = pt.Executor(pt.CPUPlace())
exe.run(startup, scope=scope)
out, = exe.run(main, feed=feed_fn(2), fetch_list=[logits], scope=scope)
assert out.shape == (2, 32, 64) and np.isfinite(out).all()
from paddle_tpu_torch.compiler import passes
from paddle_tpu_torch.models.resnet import resnet_imagenet
main, startup = pt.Program(), pt.Program()
with pt.unique_name.guard(), pt.program_guard(main, startup):
    img = pt.layers.data(name='img', shape=[3, 32, 32], dtype='float32')
    prob = resnet_imagenet(img, 10, depth=50, is_test=True)
opt, _ = pt.compiler.optimize(main, fetch_names=[prob.name])
assert [op.type for op in opt.global_block().ops].count('fused_conv') == 53
exe.run(startup, scope=scope)
out, = exe.run(main, feed={'img': np.ones((1, 3, 32, 32), 'float32')},
               fetch_list=[prob], scope=scope)
assert out.shape == (1, 10) and np.isfinite(out).all()
assert passes.FALLBACKS == {}
with pt.serving.ModelServer(pt.CPUPlace(), max_batch_size=4) as server:
    server.register_model('resnet', main, ['img'], [prob], scope)
    served, = server.infer('resnet', {'img': np.ones((3, 3, 32, 32),
                                                     'float32')})
assert served.shape == (3, 10) and np.allclose(served[0], out[0], atol=1e-5)
import paddle_tpu_torch.analysis as A
from paddle_tpu_torch.compiler.pass_base import PassPipeline
from paddle_tpu_torch.models import benchmark as bm
main, startup = pt.Program(), pt.Program()
with pt.unique_name.guard(), pt.program_guard(main, startup):
    loss, pred = bm.mnist()
    bm.train(loss)
diags = A.verify_program(main, feeds=('data', 'label'),
                         fetch_names=(loss.name,))
assert not [d for d in diags if d.is_error], diags
PassPipeline(pt.compiler.default_pipeline().passes, verify=True).run(
    main, protected=(loss.name,))
exe.run(startup, scope=scope)
feed = {'data': np.ones((2, 1, 28, 28), 'float32'),
        'label': np.ones((2, 1), 'int64')}
out, = exe.run(main, feed=feed, fetch_list=[loss], scope=scope)
assert np.isfinite(out).all()
try:
    exe.run(main, feed=dict(feed, label=feed['label'].astype('float32')),
            fetch_list=[loss], scope=scope)
    raise SystemExit('a float label was not refused')
except A.FeedInvalid:
    pass
import tempfile
import paddle_tpu_torch.fluid as fluid
import paddle_tpu_torch.dataset
import paddle_tpu_torch.reader
import paddle_tpu_torch.data_feeder
from paddle_tpu_torch.models import books
import os
data_home = tempfile.mkdtemp()
os.environ['PADDLE_TPU_TORCH_DATA_HOME'] = data_home
main, startup = fluid.Program(), fluid.Program()
with fluid.unique_name.guard(), fluid.program_guard(main, startup):
    book = books.fit_a_line()
    books.train(book)
feeder = paddle_tpu_torch.data_feeder.DataFeeder(
    feed_list=book.feeds, place=fluid.CPUPlace(), program=main)
batch = next(pt.batch(paddle_tpu_torch.reader.shuffle(
    paddle_tpu_torch.dataset.uci_housing.train(), buf_size=500), 20)())
exe.run(startup, scope=scope)
out, = exe.run(main, feed=feeder.feed(batch), fetch_list=[book.loss],
               scope=scope)
assert out.shape == (1,) and np.isfinite(out).all()
os.rmdir(data_home)                # the synthetic dataset read nothing
loaded = sorted(m for m in sys.modules
                if m in ('jax', 'jaxlib', 'paddle_tpu')
                or m.startswith(('jax.', 'jaxlib.', 'paddle_tpu.')))
assert sys.modules['jax'] is None
assert loaded == ['jax'], loaded
print('ISOLATED')
'''


def test_port_runs_with_jax_unimportable():
    env = dict(os.environ)
    env['PYTHONPATH'] = _ROOT + os.pathsep + env.get('PYTHONPATH', '')
    proc = subprocess.run([sys.executable, '-c', _SUBPROCESS], cwd=_ROOT,
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert 'ISOLATED' in proc.stdout


def test_executor_defaults_to_the_card():
    if torch.cuda.is_available():
        assert pt.Executor().device == torch.device('cuda', 0)
        return
    with pytest.raises(RuntimeError, match='CUDA is not available'):
        pt.Executor()
    with pytest.raises(RuntimeError, match='CUDA is not available'):
        pt.Executor(pt.CUDAPlace(0))
    assert pt.Executor(pt.CPUPlace()).device == torch.device('cpu')
