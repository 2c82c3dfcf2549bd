"""paddle_tpu_torch stands alone: it imports neither JAX nor paddle_tpu
(not in its sources, and not while it serves the transformer or ResNet
through its compiler and its serving runtime, verifies, sanitizes
and trains mnist through its static analysis, takes a fit_a_line
step through its fluid namespace, readers, dataset and DataFeeder,
runs a While and an Adagrad step through a DynamicRNN, serves through
a Router with its telemetry endpoint scraped, decodes through slotted,
paged and disaggregated engines, or runs the analyzer's command line),
its only ``http.server`` import is in ``observability/telemetry.py``,
and its entry points default to the card."""
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

L = pt.layers
main, startup = pt.Program(), pt.Program()
with pt.unique_name.guard(), pt.program_guard(main, startup):
    i = L.fill_constant(shape=[1], dtype='int64', value=0)
    n = L.fill_constant(shape=[1], dtype='int64', value=3)
    acc = L.fill_constant(shape=[1], dtype='float32', value=1.0)
    cond = L.less_than(x=i, y=n)
    with L.While(cond=cond).block():
        L.assign(L.scale(acc, scale=2.0), acc)
        L.increment(x=i, value=1, in_place=True)
        L.less_than(x=i, y=n, cond=cond)
out, = exe.run(main, fetch_list=[acc], scope=scope)
assert float(out[0]) == 8.0
main, startup = pt.Program(), pt.Program()
with pt.unique_name.guard(), pt.program_guard(main, startup):
    x = L.data(name='x', shape=[4], dtype='float32', lod_level=1)
    drnn = L.DynamicRNN()
    with drnn.block():
        x_t = drnn.step_input(x)
        mem = drnn.memory(shape=[4], value=0.0)
        h = L.fc(input=[x_t, mem], size=4, act='tanh')
        drnn.update_memory(mem, h)
        drnn.output(h)
    loss = L.mean(L.sequence_pool(drnn(), pool_type='last'))
    pt.optimizer.Adagrad(learning_rate=0.1).minimize(loss)
exe.run(startup, scope=scope)
rows = np.ones((5, 4), 'float32')
out, = exe.run(main, feed={'x': pt.create_lod_tensor(rows, [[2, 3]])},
               fetch_list=[loss], scope=scope)
assert out.shape == (1,) and np.isfinite(out).all()
import tempfile, urllib.request
from paddle_tpu_torch import fleet, kvcache, observability as obs
from paddle_tpu_torch.tools import analyze_program
model_dir = tempfile.mkdtemp()
main, startup = pt.Program(), pt.Program()
with pt.unique_name.guard(), pt.program_guard(main, startup):
    x = L.data(name='x', shape=[4], dtype='float32')
    y = L.fc(input=x, size=2)
exe.run(startup, scope=scope)
with pt.scope_guard(scope):
    pt.io.save_inference_model(model_dir, ['x'], [y], exe,
                               main_program=main)
assert analyze_program.main([model_dir]) == 0
srv = obs.serve_telemetry()
with fleet.Router(lambda rid: pt.serving.ModelServer(pt.CPUPlace()),
                  replicas=2, supervise=False) as router:
    router.load_model('m', model_dir)
    out, = router.infer('m', {'x': np.ones((2, 4), 'float32')})
    assert out.shape == (2, 2)
    with urllib.request.urlopen(srv.url + '/metrics', timeout=5) as r:
        _, samples = obs.parse_exposition(r.read().decode('utf-8'))
    assert any(s.name == 'fleet_replica_state' for s in samples)
srv.close()
cell, specs = fleet.attention_history_cell(20, 8, 8, max_len=8)
with fleet.DecodeEngine(cell, specs, slots=2, max_len=8,
                        place=pt.CPUPlace()) as eng:
    want = eng.decode(first_id=3, max_new_tokens=6)
spec = kvcache.stock_spec(20, 8, 8, max_len=8, page_size=4, num_pages=4)
paged, _ = kvcache.make_paged_engine(spec, slots=2, place=pt.CPUPlace())
assert (paged.decode(first_id=3, max_new_tokens=6) == want).all()
r = kvcache.PrefillEngine(spec, place=pt.CPUPlace()).prefill([3, want[0]])
got = paged.submit(init_states=r['states'], init_pages=r['pages'],
                   pos0=r['pos0'], first_id=r['next_id'],
                   max_new_tokens=4).result(timeout=60)
assert ([r['next_id']] + list(got) == list(want[1:])), (r, got, want)
paged.close()
loaded = sorted(m for m in sys.modules
                if m in ('jax', 'jaxlib', 'paddle_tpu')
                or m.startswith(('jax.', 'jaxlib.', 'paddle_tpu.')))
assert sys.modules['jax'] is None
assert loaded == ['jax'], loaded
print('ISOLATED')
'''


def test_only_telemetry_imports_http_server():
    """The JAX package's lint rule ``http-outside-telemetry`` held on the
    port: ``observability/telemetry.py`` is its only module that imports
    ``http.server``."""
    importers = []
    for path in _port_sources():
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                mods = [node.module or '']
            else:
                continue
            if any(m == 'http.server' or m.startswith('http.server.')
                   for m in mods):
                importers.append(os.path.relpath(path, _ROOT))
    assert importers == [os.path.join('paddle_tpu_torch', 'observability',
                                      'telemetry.py')], importers


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
