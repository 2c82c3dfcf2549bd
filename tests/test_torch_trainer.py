"""The port's high-level ``Trainer`` against paddle_tpu's, on the CPU.

Both packages' Trainers load one set of persistables through
``param_path`` (written by ``paddle_tpu.io.save_persistables`` from a
JAX Trainer's startup scope) and train the same numpy batches: the
event sequences must be equal, the per-step losses within 1e-5 and the
final parameters within 1e-4 (f32 on both sides, AMP off; sums in
another order, measured ~1e-7 and ~1e-6). Then ``test``,
``save_params`` and the ``Inferencer``; a kill by SIGTERM mid-epoch and
a resume in fresh processes, bit-equal to an uninterrupted run; and the
parts that wait for ROADMAP item 6 raising with that name.
"""
import os
import subprocess
import sys
import textwrap

import jax  # noqa: F401 (the JAX side runs on the CPU)
import numpy as np
import pytest

import paddle_tpu.fluid as jfluid
import paddle_tpu_torch as pt
import paddle_tpu_torch.fluid as tfluid

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LOSS_TOL = 1e-5
PARAM_TOL = 1e-4


def _fit_a_line(fluid):
    x = fluid.layers.data(name='x', shape=[13], dtype='float32')
    y = fluid.layers.data(name='y', shape=[1], dtype='float32')
    pred = fluid.layers.fc(input=x, size=1, act=None)
    return fluid.layers.mean(
        fluid.layers.square_error_cost(input=pred, label=y))


def _digits(fluid):
    img = fluid.layers.data(name='img', shape=[1, 28, 28], dtype='float32')
    label = fluid.layers.data(name='label', shape=[1], dtype='int64')
    c = fluid.nets.simple_img_conv_pool(input=img, filter_size=5,
                                        num_filters=4, pool_size=2,
                                        pool_stride=2, act='relu')
    c = fluid.nets.simple_img_conv_pool(input=c, filter_size=5,
                                        num_filters=8, pool_size=2,
                                        pool_stride=2, act='relu')
    pred = fluid.layers.fc(input=c, size=10, act='softmax')
    loss = fluid.layers.mean(fluid.layers.cross_entropy(input=pred,
                                                        label=label))
    return [loss, fluid.layers.accuracy(input=pred, label=label)]


CASES = {
    'fit_a_line': (_fit_a_line, lambda f: f.optimizer.SGD(0.01),
                   ['x', 'y']),
    'recognize_digits': (_digits, lambda f: f.optimizer.Adam(0.001),
                         ['img', 'label']),
}


def _reader(name, steps=3, batch=8, seed=0):
    rng = np.random.RandomState(seed)
    if name == 'fit_a_line':
        samples = [(rng.randn(13).astype('float32'),
                    rng.randn(1).astype('float32'))
                   for _ in range(steps * batch)]
    else:
        samples = [(rng.rand(1, 28, 28).astype('float32'),
                    np.array([rng.randint(10)], 'int64'))
                   for _ in range(steps * batch)]

    def r():
        for i in range(0, len(samples), batch):
            yield samples[i:i + batch]
    return r


def _train(fluid, name, param_path, reader):
    build, make_opt, feed_order = CASES[name]
    tr = fluid.Trainer(lambda: build(fluid), make_opt(fluid),
                       param_path=param_path, place=fluid.CPUPlace())
    events, losses = [], []

    def handler(ev):
        events.append((type(ev).__name__, ev.epoch,
                       getattr(ev, 'step', None)))
        if isinstance(ev, fluid.EndStepEvent):
            losses.append(float(np.asarray(ev.metrics[0]).ravel()[0]))

    tr.train(num_epochs=1, event_handler=handler, reader=reader,
             feed_order=feed_order)
    return tr, events, losses


@pytest.mark.parametrize('name', sorted(CASES))
def test_trainer_matches_paddle_tpu(tmp_path, name):
    build, make_opt, _ = CASES[name]
    src = jfluid.Trainer(lambda: build(jfluid), make_opt(jfluid),
                         place=jfluid.CPUPlace())
    param_dir = str(tmp_path / 'init')
    src.save_params(param_dir)        # paddle_tpu.io.save_persistables
    reader = _reader(name)
    jtr, jevents, jlosses = _train(jfluid, name, param_dir, reader)
    ttr, tevents, tlosses = _train(tfluid, name, param_dir, reader)
    assert tevents == jevents and len(tlosses) == 3
    np.testing.assert_allclose(tlosses, jlosses, rtol=LOSS_TOL,
                               atol=LOSS_TOL)
    params = [p.name for p in
              ttr.train_program.global_block().all_parameters()]
    assert params
    for n in params:
        np.testing.assert_allclose(
            pt.fetch_var(n, ttr.scope), np.asarray(jtr.scope.raw(n)),
            rtol=PARAM_TOL, atol=PARAM_TOL, err_msg=n)


def test_test_save_params_and_inferencer(tmp_path):
    build, make_opt, feed_order = CASES['fit_a_line']
    tr = tfluid.Trainer(lambda: build(tfluid), make_opt(tfluid),
                        place=tfluid.CPUPlace())
    tr.train(2, lambda e: None, reader=_reader('fit_a_line'),
             feed_order=feed_order)
    before = {p.name: pt.fetch_var(p.name, tr.scope) for p in
              tr.train_program.global_block().all_parameters()}
    loss, = tr.test(reader=_reader('fit_a_line', seed=1),
                    feed_order=feed_order)
    assert isinstance(loss, float) and np.isfinite(loss)
    for n, v in before.items():       # test() leaves the parameters
        assert np.array_equal(pt.fetch_var(n, tr.scope), v), n
    param_dir = str(tmp_path / 'params')
    tr.save_params(param_dir)

    def infer_func():
        x = tfluid.layers.data(name='x', shape=[13], dtype='float32')
        return tfluid.layers.fc(input=x, size=1, act=None)

    inf = tfluid.Inferencer(infer_func, param_path=param_dir,
                            place=tfluid.CPUPlace())
    xs = np.random.RandomState(2).randn(5, 13).astype('float32')
    out = np.asarray(inf.infer({'x': xs})[0])
    w, = (v for v in before.values() if v.shape == (13, 1))
    b, = (v for v in before.values() if v.shape == (1,))
    np.testing.assert_allclose(out, xs @ w + b, rtol=1e-5, atol=1e-6)


_SCRIPT = textwrap.dedent(r'''
    import os, signal, sys
    import numpy as np
    import paddle_tpu_torch as pt
    import paddle_tpu_torch.fluid as fluid
    from paddle_tpu_torch.resilience import faultinject as fi
    mode, ckdir, out = sys.argv[1:4]

    def train_func():
        x = fluid.layers.data(name='x', shape=[4], dtype='float32')
        y = fluid.layers.data(name='y', shape=[1], dtype='float32')
        h = fluid.layers.fc(input=x, size=8, act='relu')
        h = fluid.layers.dropout(h, dropout_prob=0.3)
        pred = fluid.layers.fc(input=h, size=1)
        return fluid.layers.mean(
            fluid.layers.square_error_cost(input=pred, label=y))

    rng = np.random.RandomState(0)
    data = [(rng.randn(4).astype('float32'), rng.randn(1).astype('float32'))
            for _ in range(40)]
    reader = pt.batch(lambda: iter(data), 8)          # 5 steps an epoch
    tr = fluid.Trainer(train_func, fluid.optimizer.Adam(0.01),
                       place=fluid.CPUPlace())
    losses = []
    handler = lambda e: losses.append(float(e.metrics[0][0])) \
        if isinstance(e, fluid.EndStepEvent) else None
    cfg = None if mode == 'plain' else fluid.CheckpointConfig(
        checkpoint_dir=ckdir, step_interval=2, backend='npz')
    with fi.fault_plan() as plan:
        if mode == 'kill':      # SIGTERM at the 7th step, mid-epoch 2
            plan.inject(fi.SITE_TRAINER_STEP, error=None, at=[6],
                        action=lambda: os.kill(os.getpid(),
                                               signal.SIGTERM))
        tr.train(3, handler, reader=reader, feed_order=['x', 'y'],
                 checkpoint_config=cfg)
    state = {p.name: pt.fetch_var(p.name, tr.scope) for p in
             tr.train_program.global_block().all_parameters()}
    np.savez(out, losses=np.asarray(losses, 'float32'), **state)
''')


def _child(tmp_path, mode, ckdir):
    out = str(tmp_path / ('%s.npz' % mode))
    env = dict(os.environ, PYTHONPATH=_ROOT)
    proc = subprocess.run([sys.executable, '-c', _SCRIPT, mode, ckdir, out],
                          cwd=_ROOT, env=env, capture_output=True,
                          text=True, timeout=240)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return dict(np.load(out))


def test_sigterm_then_resume_is_bit_equal(tmp_path):
    ckdir = str(tmp_path / 'ck')
    plain = _child(tmp_path, 'plain', ckdir)
    killed = _child(tmp_path, 'kill', ckdir)
    # the kill committed at the end of step 7 (a chunk of one step)
    assert len(killed['losses']) == 7
    assert pt.io.load_checkpoint_trainer_state(ckdir)['global_step'] == 7
    resumed = _child(tmp_path, 'resume', ckdir)
    assert len(plain['losses']) == 15
    assert np.array_equal(np.concatenate([killed['losses'],
                                          resumed['losses']]),
                          plain['losses'])
    names = [k for k in plain if k != 'losses']
    assert names
    for n in names:
        assert np.array_equal(resumed[n], plain[n]), n


def test_out_of_scope_parts_raise_naming_item_6(monkeypatch):
    build, make_opt, feed_order = CASES['fit_a_line']
    with pytest.raises(NotImplementedError, match='item 6'):
        tfluid.Trainer(lambda: build(tfluid), make_opt(tfluid),
                       place=tfluid.CPUPlace(), parallel=True)
    tr = tfluid.Trainer(lambda: build(tfluid), make_opt(tfluid),
                        place=tfluid.CPUPlace())
    with pytest.raises(NotImplementedError, match='item 6'):
        tr.train(1, lambda e: None, reader=_reader('fit_a_line'),
                 feed_order=feed_order, zero_stage=2)
    with pytest.raises(NotImplementedError, match='item 6'):
        tr.train(1, lambda e: None, reader=_reader('fit_a_line'),
                 feed_order=feed_order, zero_bucket_bytes=1 << 20)
    monkeypatch.setenv('PADDLE_TRAINING_ROLE', 'TRAINER')
    with pytest.raises(NotImplementedError, match='item 6'):
        tfluid.Trainer(lambda: build(tfluid), make_opt(tfluid),
                       place=tfluid.CPUPlace())


def test_trainer_defaults_to_the_card():
    import torch
    if torch.cuda.is_available():
        assert tfluid.trainer.check_and_get_place(None) == pt.CUDAPlace(0)
        return
    build, make_opt, _ = CASES['fit_a_line']
    with pytest.raises(RuntimeError, match='CUDA is not available'):
        tfluid.Trainer(lambda: build(tfluid), make_opt(tfluid))
