"""The port's CTC family against paddle_tpu's, on the CPU.

- ``warpctc``: the loss against paddle_tpu's to 1e-5 (blank first and
  last, ``norm_by_times`` on and off, repeated labels that need a blank
  between them, lengths from 1 to the bucket). Its input gradient is
  held to ``torch.nn.functional.ctc_loss`` in f64 (a witness outside the
  port, the logits widened) to 1e-5, and to paddle_tpu's with the JAX
  kernel's log-sum-exp made safe for the test: paddle_tpu's own gradient
  of this loss is NaN (its ``where`` takes log(0) where every path is at
  the floor; ROADMAP Queue C), which the first case shows.
- ``ctc_align`` (``ctc_greedy_decoder``) on probabilities and on ids:
  the decoded ids and lengths exactly; ``edit_distance`` normalized and
  not, exactly; ``evaluator.EditDistance`` over two batches.
- A narrow CRNN-CTC (``chip_smoke.crnn_program``, phase 24b's network:
  filters 4-8, 1 x 32 x 64 strips, GRUs of 8, 10 classes): one
  Momentum step's loss against paddle_tpu's to 1e-4, every parameter's
  gradient to GRAD_L2 by relative L2 (against paddle_tpu with the safe
  log-sum-exp; read 9.4e-6 at most), the convs' biases, which a
  train-mode batch norm follows, within BIAS_ABS of 0 in both, and the
  decode and its distances exactly.
"""
import os
import sys

import numpy as np
import pytest
import torch

import paddle_tpu.fluid as fluid
from paddle_tpu.ops import ctc_ops as jax_ctc
import paddle_tpu_torch as pt
from paddle_tpu_torch import io as pt_io

from test_torch_tensor_math_ops import TOL, _data, run_both

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
import chip_smoke  # noqa: E402

GRAD_L2 = 1e-4
BIAS_ABS = 1e-5


def _safe_jax_logsumexp2(a, b):
    """paddle_tpu's ``_logsumexp2`` with the log fed 1 where both terms
    are at the floor (the port's form): its gradient is finite."""
    import jax.numpy as jnp
    m = jnp.maximum(a, b)
    floor = m <= jax_ctc._NEG / 2
    m_safe = jnp.where(floor, 0.0, m)
    s = jnp.exp(a - m_safe) + jnp.exp(b - m_safe)
    out = m_safe + jnp.log(jnp.where(floor, 1.0, s))
    return jnp.where(floor, jax_ctc._NEG, out)


@pytest.fixture
def safe_jax_ctc(monkeypatch):
    monkeypatch.setattr(jax_ctc, '_logsumexp2', _safe_jax_logsumexp2)


B, C = 4, 6
IN_LENS = [7, 3, 8, 5]
LABELS = [[1, 1, 2], [3], [2, 5, 5, 1], [4, 4]]


def _ctc_feeds(blank):
    rng = np.random.RandomState(blank)
    labels = [[(v + blank) % C or (C - 1 if blank == 0 else 0)
               for v in row] for row in LABELS]
    labels = [[v if v != blank else (blank + 1) % C for v in row]
              for row in labels]
    x = rng.randn(sum(IN_LENS), C).astype('float32')

    def feeds(pkg):
        return {'x': pkg.create_lod_tensor(x, [IN_LENS], pkg.CPUPlace()),
                'y': pkg.create_lod_tensor(
                    np.concatenate(labels).reshape(-1, 1).astype('int32'),
                    [[len(r) for r in labels]], pkg.CPUPlace())}
    return feeds, x, labels


def _warpctc(blank, norm):
    def build(L):
        x = _data(L, 'x', [C], lod_level=1)
        y = _data(L, 'y', [1], 'int32', lod_level=1)
        attr = (pt if L is pt.layers else fluid).ParamAttr(name='w')
        h = L.fc(input=x, size=C, param_attr=attr, bias_attr=False)
        return L.warpctc(input=h, label=y, blank=blank, norm_by_times=norm)
    return build


EYE = {'w': np.eye(C, dtype='float32')}


def test_paddle_tpu_warpctc_gradient_is_nan():
    feeds, _, _ = _ctc_feeds(0)
    j_res, t_res = run_both(_warpctc(0, False), feeds, params=EYE,
                            grads=True)
    assert np.isnan(j_res[1]).all()
    assert np.isfinite(t_res[1]).all()


@pytest.mark.parametrize('blank,norm', [(0, False), (0, True),
                                        (C - 1, False), (C - 1, True)])
def test_warpctc_loss_and_gradient(blank, norm, safe_jax_ctc):
    feeds, x, labels = _ctc_feeds(blank)
    j_res, t_res = run_both(_warpctc(blank, norm), feeds, params=EYE)
    np.testing.assert_allclose(t_res[0], j_res[0], **TOL)
    # the input gradient (w is the identity: x's gradient is w's
    # through x^T) against paddle_tpu's, made safe, and against
    # F.ctc_loss in f64
    j_res, t_res = run_both(_warpctc(blank, norm), feeds, params=EYE,
                            grads=True)
    np.testing.assert_allclose(t_res[0], j_res[0], **TOL)
    np.testing.assert_allclose(t_res[1], j_res[1], **TOL)
    xs = torch.tensor(x, dtype=torch.float64, requires_grad=True)
    off = np.cumsum([0] + IN_LENS)
    T = max(IN_LENS)
    logp = torch.full((T, B, C), 0.0, dtype=torch.float64)
    rows = []
    for b in range(B):
        seq = torch.log_softmax(xs[off[b]:off[b + 1]], -1)
        rows.append(torch.cat([seq, torch.zeros(T - IN_LENS[b], C,
                                                dtype=torch.float64)]))
    logp = torch.stack(rows, 1)
    targets = torch.tensor([v for r in labels for v in r])
    loss = torch.nn.functional.ctc_loss(
        logp, targets, torch.tensor(IN_LENS), torch.tensor(
            [len(r) for r in labels]), blank=blank, reduction='none')
    if norm:
        loss = loss / torch.tensor(IN_LENS, dtype=torch.float64)
    np.testing.assert_allclose(t_res[0], loss.detach().numpy()
                               .astype('float32').mean(), **TOL)
    loss.mean().backward()
    # d mean / d w at w = I is x^T d(mean)/dh: the same contraction
    want = x.T.astype('float64') @ xs.grad.numpy()
    np.testing.assert_allclose(t_res[1], want, **TOL)


def _decode_feeds(pkg):
    rng = np.random.RandomState(5)
    lens = [6, 1, 9, 4]
    probs = rng.uniform(0, 1, (sum(lens), C)).astype('float32')
    probs[3:5] = probs[2]                      # repeats, merged
    probs[7, :] = probs[7, 0]                  # argmax ties: the first
    ids = rng.randint(0, 3, (sum(lens), 1)).astype('int32')
    return {'p': pkg.create_lod_tensor(probs, [lens], pkg.CPUPlace()),
            'i': pkg.create_lod_tensor(ids, [lens], pkg.CPUPlace())}


def _decode(L):
    p = _data(L, 'p', [C], lod_level=1)
    i = _data(L, 'i', [1], 'int32', lod_level=1)
    return [L.ctc_greedy_decoder(p, blank=0), L.ctc_greedy_decoder(i, blank=2)]


def test_ctc_greedy_decoder_matches_paddle_tpu():
    j_res, t_res = run_both(_decode, _decode_feeds)
    for j, t in zip(j_res, t_res):
        np.testing.assert_array_equal(t.reshape(-1), j.reshape(-1))


def _edit_feeds(pkg):
    hyp = [[1, 2, 3, 4], [5], [2, 2, 7, 1, 1], [3, 3]]
    ref = [[1, 3, 4], [5, 6, 7], [2, 7, 1], [3, 3]]

    def lod(rows):
        return pkg.create_lod_tensor(
            np.concatenate(rows).reshape(-1, 1).astype('int64'),
            [[len(r) for r in rows]], pkg.CPUPlace())
    return {'h': lod(hyp), 'r': lod(ref)}


@pytest.mark.parametrize('normalized', [True, False])
def test_edit_distance_matches_paddle_tpu(normalized):
    def build(L):
        h = _data(L, 'h', [1], 'int64', lod_level=1)
        r = _data(L, 'r', [1], 'int64', lod_level=1)
        return list(L.edit_distance(h, r, normalized=normalized))
    j_res, t_res = run_both(build, _edit_feeds)
    np.testing.assert_array_equal(t_res[0], j_res[0])
    np.testing.assert_array_equal(t_res[1], j_res[1])
    want = [1, 2, 2, 0]
    if normalized:
        want = [1 / 3., 2 / 3., 2 / 3., 0]
    np.testing.assert_allclose(t_res[0][:, 0], want, rtol=1e-6)


def test_edit_distance_evaluator_matches_paddle_tpu():
    res = {}
    for pkg in (fluid, pt):
        main, startup = pkg.Program(), pkg.Program()
        with pkg.unique_name.guard(), pkg.program_guard(main, startup):
            h = pkg.layers.data(name='h', shape=[1], dtype='int64',
                                lod_level=1)
            r = pkg.layers.data(name='r', shape=[1], dtype='int64',
                                lod_level=1)
            ev = pkg.evaluator.EditDistance(input=h, label=r)
        exe = pkg.Executor(pkg.CPUPlace())
        with pkg.scope_guard(pkg.Scope()):
            exe.run(startup)
            ev.reset(exe)
            out = []
            for _ in range(2):
                out.append(exe.run(main, feed=_edit_feeds(pkg),
                                   fetch_list=ev.metrics)[0])
            out.append(ev.eval(exe))
        res[pkg] = [np.asarray(o) for o in out]
    for j, t in zip(res[fluid], res[pt]):
        np.testing.assert_allclose(t, j, **TOL)


# ---- CRNN-CTC --------------------------------------------------------------------
NARROW = dict(height=32, width=64, classes=10, filters=(4, 8, 8, 8),
              hidden=8)


def test_crnn_ctc_step_matches_paddle_tpu(safe_jax_ctc):
    rng = np.random.RandomState(0)
    images, labels, lens = chip_smoke.crnn_batch(
        rng, 4, NARROW['height'], NARROW['width'], NARROW['classes'],
        lens=(1, 3))
    jm, js, _, jo, _ = chip_smoke.crnn_program(fluid, 4, **NARROW)
    jscope = fluid.Scope()
    fluid.Executor(fluid.CPUPlace()).run(js, scope=jscope)
    state = {v.name: np.asarray(jscope.find_var(v.name))
             for v in jm.global_block().vars.values()
             if v.persistable and jscope.find_var(v.name) is not None}
    grads = [p.name + '@GRAD' for p in jm.global_block().all_parameters()
             if p.trainable]
    res = {}
    for pkg, scope in ((fluid, jscope), (pt, pt.Scope())):
        main, _, _, outs, ev = chip_smoke.crnn_program(pkg, 4, **NARROW)
        if pkg is pt:
            pt_io.params_from_numpy(scope, state, pt.CPUPlace())
        feed = {'pixel': images, 'label': pkg.create_lod_tensor(
            labels, [lens], pkg.CPUPlace())}
        exe = pkg.Executor(pkg.CPUPlace())
        with pkg.scope_guard(scope):
            ev.reset(exe)
            res[pkg] = [np.asarray(v) for v in exe.run(
                main, feed=feed, fetch_list=[outs[0], outs[2], outs[3]] +
                grads)]
    j, t = res[fluid], res[pt]
    np.testing.assert_allclose(t[0], j[0], rtol=1e-4)
    np.testing.assert_array_equal(t[1].reshape(-1), j[1].reshape(-1))
    np.testing.assert_array_equal(t[2], j[2])
    for name, a, b in zip(grads, t[3:], j[3:]):
        assert np.isfinite(a).all(), name
        if name.startswith('conv2d_') and name.endswith('.w_1@GRAD'):
            # a conv's bias before a train-mode batch norm: 0 in exact
            # arithmetic (the port reads 0, paddle_tpu ~1e-6 of rounding)
            assert max(np.linalg.norm(a), np.linalg.norm(b)) <= BIAS_ABS
            continue
        err = np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)
        assert err <= GRAD_L2, (name, err)
