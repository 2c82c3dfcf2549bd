"""The sequence path end to end: stacked_dynamic_lstm and
machine_translation in paddle_tpu_torch against paddle_tpu, on the CPU.

The models are built by the functions below, which follow
benchmark/fluid/models.py:70-146 line for line at small widths and take
the package as an argument, so one function makes both programs. Both
scopes get the same random numpy parameters (biases and peephole weights
included); both Executors run the same feeds, f32 with AMP off.

- stacked_dynamic_lstm (dict 100, emb 16, hid 16, 3 layers) on lengths
  [7, 3, 5, 1], with ``use_peepholes`` False (the port's fused cell; JAX
  on its Pallas cell in interpret mode) and True (the plain scan in both):
  two Momentum(0.01, 0.9) steps, the loss, every ``@GRAD`` and every
  parameter after them to 1e-4 of the largest magnitude (a whole model's
  f32 sums in another order).
- The same model saved by the port with ``save_inference_model``, loaded
  and served by both packages (one file format): the probabilities to
  1e-4.
- machine_translation (dict 50, emb 8, hid 8) for one step: the loss and
  every gradient to 1e-4.
"""
import os

import numpy as np
import pytest

import jax.numpy as jnp

import paddle_tpu.fluid as fluid
from paddle_tpu.ops import pallas_kernels as pk
import paddle_tpu_torch as pt
from paddle_tpu_torch import io as pt_io
from paddle_tpu_torch.ops import cuda_kernels as ck

REL = 1e-4
SMALL_LSTM = dict(dict_size=100, emb_dim=16, hid_dim=16, stacked_num=3)
SMALL_MT = dict(dict_size=50, emb_dim=8, hid_dim=8)
LENS = [7, 3, 5, 1]


def stacked_dynamic_lstm(pkg, dict_size=10000, emb_dim=512, hid_dim=512,
                         stacked_num=3, use_peepholes=True):
    """benchmark/fluid/models.py:70-104, with the LSTMs' use_peepholes as
    an argument. Returns (loss, prediction)."""
    layers = pkg.layers
    data = layers.data(name='data', shape=[1], dtype='int64', lod_level=1)
    label = layers.data(name='label', shape=[1], dtype='int64')
    emb = layers.embedding(input=data, size=[dict_size, emb_dim])
    fc1 = layers.fc(input=emb, size=hid_dim * 4)
    lstm1, _ = layers.dynamic_lstm(input=fc1, size=hid_dim * 4,
                                   use_peepholes=use_peepholes)
    inputs = [fc1, lstm1]
    for _ in range(2, stacked_num + 1):
        fc = layers.fc(input=inputs, size=hid_dim * 4)
        lstm, _ = layers.dynamic_lstm(input=fc, size=hid_dim * 4,
                                      use_peepholes=use_peepholes)
        inputs = [fc, lstm]
    fc_last = layers.sequence_pool(input=inputs[0], pool_type='max')
    lstm_last = layers.sequence_pool(input=inputs[1], pool_type='max')
    prediction = layers.fc(input=[fc_last, lstm_last], size=2, act='softmax')
    cost = layers.cross_entropy(input=prediction, label=label)
    return layers.mean(x=cost), prediction


def machine_translation(pkg, dict_size=8000, emb_dim=256, hid_dim=512):
    """benchmark/fluid/models.py:106-146. Returns the loss."""
    layers = pkg.layers
    src = layers.data(name='data', shape=[1], dtype='int64', lod_level=1)
    trg = layers.data(name='trg', shape=[1], dtype='int64', lod_level=1)
    label = layers.data(name='label', shape=[1], dtype='int64', lod_level=1)
    src_emb = layers.embedding(input=src, size=[dict_size, emb_dim])
    enc_fc = layers.fc(input=src_emb, size=hid_dim * 4)
    enc, _ = layers.dynamic_lstm(input=enc_fc, size=hid_dim * 4)
    enc_last = layers.sequence_pool(input=enc, pool_type='last')
    trg_emb = layers.embedding(input=trg, size=[dict_size, emb_dim])
    dec_fc = layers.fc(input=trg_emb, size=hid_dim * 4)
    dec, _ = layers.dynamic_lstm(input=dec_fc, size=hid_dim * 4)
    ctx = layers.sequence_expand(x=enc_last, y=dec)
    merged = layers.fc(input=[dec, ctx], size=hid_dim, act='tanh')
    predict = layers.fc(input=merged, size=dict_size, act='softmax')
    cost = layers.cross_entropy(input=predict, label=label)
    return layers.mean(x=cost)


@pytest.fixture
def pallas_cell(monkeypatch):
    """JAX's fused LSTM cell on its Pallas kernel in interpret mode."""
    calls = []
    orig = pk.fused_lstm_cell

    def forced(xg, r, c, w, interpret=None):
        calls.append(True)
        return orig(xg, r, c, w, interpret=True)

    monkeypatch.setattr(pk, 'fused_lstm_cell', forced)
    return calls


def _rel(got, want):
    want = np.asarray(want)
    return float(np.abs(np.asarray(got) - want).max()) / max(
        float(np.abs(want).max()), 1e-4)


def _ops(program):
    return [op.type for op in program.global_block().ops]


class Pair(object):
    """One training program built in both packages, the same random
    parameters in both scopes."""

    def __init__(self, build, seed=5):
        progs = []
        for pkg in (fluid, pt):
            main, startup = pkg.Program(), pkg.Program()
            with pkg.unique_name.guard(), pkg.program_guard(main, startup):
                out = build(pkg)
                loss = out[0] if isinstance(out, tuple) else out
                pkg.optimizer.Momentum(learning_rate=0.01,
                                       momentum=0.9).minimize(loss)
            progs.append((main, startup, out))
        (self.j_main, j_startup, j_out), (self.t_main, _, t_out) = progs
        assert _ops(self.j_main) == _ops(self.t_main)
        self.j_out, self.t_out = j_out, t_out
        self.j_scope = fluid.Scope()
        self.j_exe = fluid.Executor(fluid.CPUPlace())
        self.j_exe.run(j_startup, scope=self.j_scope)
        rng = np.random.RandomState(seed)
        param_names = {v.name for v in self.j_main.global_block()
                       .all_parameters()}
        self.params = {}
        for v in j_startup.list_vars():
            val = self.j_scope.raw(v.name)
            if val is None:
                continue
            val = np.asarray(val)
            if v.name in param_names:
                val = (0.1 * rng.randn(*val.shape)).astype(val.dtype)
                self.j_scope.set_var(v.name, jnp.asarray(val))
            self.params[v.name] = val
        self.t_scope = pt.Scope()
        pt_io.params_from_numpy(self.t_scope, self.params, pt.CPUPlace())
        self.t_exe = pt.Executor(pt.CPUPlace())
        self.grads = sorted(v.name for v in self.t_main.list_vars()
                            if v.name.endswith('@GRAD'))
        self.loss_names = [j_out[0].name if isinstance(j_out, tuple)
                           else j_out.name]

    def step(self, j_feed, t_feed):
        names = self.loss_names + self.grads
        j = self.j_exe.run(self.j_main, feed=j_feed, fetch_list=names,
                           scope=self.j_scope)
        t = self.t_exe.run(self.t_main, feed=t_feed, fetch_list=names,
                           scope=self.t_scope)
        for name, a, b in zip(names, j, t):
            assert _rel(b, a) <= REL, (name, _rel(b, a))
        return float(np.asarray(j[0]).reshape(-1)[0])

    def check_params(self):
        for name in self.params:
            assert _rel(self.t_scope.raw(name).numpy(),
                        self.j_scope.raw(name)) <= REL, name


def _lstm_feeds(lens, seed=0):
    rng = np.random.RandomState(seed)
    rows = rng.randint(0, SMALL_LSTM['dict_size'],
                       (sum(lens), 1)).astype('int64')
    label = rng.randint(0, 2, (len(lens), 1)).astype('int64')
    return ({'data': fluid.create_lod_tensor(rows, [lens]), 'label': label},
            {'data': pt.create_lod_tensor(rows, [lens]), 'label': label})


@pytest.mark.parametrize('peep', [False, True], ids=['fused', 'peepholes'])
def test_stacked_lstm_two_momentum_steps(pallas_cell, peep):
    pair = Pair(lambda pkg: stacked_dynamic_lstm(
        pkg, use_peepholes=peep, **SMALL_LSTM))
    ck.reset_launch_counts()
    losses = [pair.step(*_lstm_feeds(LENS, seed=s)) for s in (0, 1)]
    pair.check_params()
    assert all(np.isfinite(losses))
    # JAX reached its Pallas cell exactly where the port reaches its own;
    # on the CPU the port's cell is the plain version, no kernel launch
    assert bool(pallas_cell) == (not peep)
    assert ck.LAUNCHES['lstm_cell'] == 0


def test_stacked_lstm_saved_loaded_served(tmp_path, pallas_cell):
    """Trained one step by the port, saved as an inference model, loaded
    and served by both packages: probabilities to 1e-4, on a full batch
    and a ragged one."""
    main, startup = pt.Program(), pt.Program()
    startup.random_seed = 7
    with pt.unique_name.guard(), pt.program_guard(main, startup):
        loss, prediction = stacked_dynamic_lstm(pt, use_peepholes=False,
                                                **SMALL_LSTM)
        pt.optimizer.Momentum(learning_rate=0.01, momentum=0.9).minimize(loss)
    exe = pt.Executor(pt.CPUPlace())
    scope = pt.Scope()
    exe.run(startup, scope=scope)
    exe.run(main, feed=_lstm_feeds(LENS)[1], fetch_list=[loss], scope=scope)
    path = str(tmp_path / 'lstm')
    pt_io.save_inference_model(path, ['data'], [prediction], exe,
                               main_program=main, scope=scope)
    assert os.path.exists(os.path.join(path, '__model__.json'))
    t_scope, j_scope = pt.Scope(), fluid.Scope()
    t_prog, t_feeds, t_fetch = pt_io.load_inference_model(path, exe,
                                                          scope=t_scope)
    j_exe = fluid.Executor(fluid.CPUPlace())
    j_prog, j_feeds, j_fetch = fluid.io.load_inference_model(
        path, j_exe, scope=j_scope)
    assert t_feeds == j_feeds == ['data']
    for lens in ([12, 12, 12, 12], [1, 9, 4, 12, 2]):
        j_feed, t_feed = _lstm_feeds(lens, seed=3)
        got, = exe.run(t_prog, feed={'data': t_feed['data']},
                       fetch_list=t_fetch, scope=t_scope)
        want, = j_exe.run(j_prog, feed={'data': j_feed['data']},
                          fetch_list=j_fetch, scope=j_scope)
        assert got.shape == (len(lens), 2)
        np.testing.assert_allclose(got, np.asarray(want), rtol=0,
                                   atol=REL)
        np.testing.assert_allclose(got.sum(-1), 1.0, atol=1e-5)
    assert pallas_cell


def test_machine_translation_one_step():
    pair = Pair(lambda pkg: machine_translation(pkg, **SMALL_MT))
    src_lens, trg_lens = [5, 2, 7], [3, 6, 1]
    feeds = []
    for pkg in (fluid, pt):
        r = np.random.RandomState(4)
        feeds.append({
            name: pkg.create_lod_tensor(r.randint(
                0, SMALL_MT['dict_size'], (sum(lens), 1)).astype('int64'),
                [lens])
            for name, lens in (('data', src_lens), ('trg', trg_lens),
                               ('label', trg_lens))})
    loss = pair.step(*feeds)
    pair.check_params()
    assert np.isfinite(loss)
