"""The port's ``AnomalyGuard`` against paddle_tpu's, on the CPU: the
three policies under each package's ``Trainer`` on one seeded poisoned
reader (both loading one set of persistables through ``param_path``),
spike detection, gradient-norm monitoring and the executor-level guard.
Counts of trips and skipped steps must be equal and the final
parameters within 1e-5 (f32 sums in another order; measured ~1e-7).
"""
import jax  # noqa: F401 (the JAX side runs on the CPU)
import numpy as np
import pytest

import paddle_tpu
import paddle_tpu.fluid as jfluid
from paddle_tpu import resilience as jres
import paddle_tpu_torch as pt
import paddle_tpu_torch.fluid as tfluid
from paddle_tpu_torch import resilience as tres

TOL = 1e-5
_RNG = np.random.RandomState(7)
_SAMPLES = [(_RNG.randn(4).astype('float32'),
             _RNG.randn(1).astype('float32')) for _ in range(16)]


def _batched():
    return paddle_tpu.batch(lambda: iter(_SAMPLES), 4)   # 4 steps


def _train_func(fluid):
    x = fluid.layers.data(name='x', shape=[4], dtype='float32')
    t = fluid.layers.data(name='t', shape=[1], dtype='float32')
    y = fluid.layers.fc(input=x, size=1,
                        param_attr=fluid.ParamAttr(name='w_tr'))
    return fluid.layers.reduce_mean(
        fluid.layers.square_error_cost(input=y, label=t))


def _run(fluid, res, param_dir, guard, ckdir=None):
    tr = fluid.Trainer(lambda: _train_func(fluid),
                       fluid.optimizer.SGD(learning_rate=0.05),
                       param_path=param_dir, place=fluid.CPUPlace())
    seen = []
    cfg = None if ckdir is None else res.CheckpointConfig(
        checkpoint_dir=ckdir, step_interval=1, backend='npz')
    poisoned = res.faultinject.nan_reader(_batched(), at_steps=[2])
    tr.train(1, lambda e: seen.append(e.metrics is None) if isinstance(
        e, fluid.EndStepEvent) else None, reader=poisoned,
        feed_order=['x', 't'], anomaly_guard=guard, checkpoint_config=cfg)
    return tr, seen


@pytest.fixture
def param_dir(tmp_path):
    src = jfluid.Trainer(lambda: _train_func(jfluid),
                         jfluid.optimizer.SGD(learning_rate=0.05),
                         place=jfluid.CPUPlace())
    d = str(tmp_path / 'init')
    src.save_params(d)
    return d


def _guard(res, policy, **kw):
    return res.AnomalyGuard(policy=policy, **kw)


@pytest.mark.parametrize('policy', ['skip_batch', 'rollback_to_checkpoint'])
def test_policies_match_paddle_tpu(tmp_path, param_dir, policy):
    out = {}
    for name, fluid, res in (('jax', jfluid, jres), ('port', tfluid, tres)):
        guard = _guard(res, policy)
        ckdir = str(tmp_path / name) if policy != 'skip_batch' else None
        tr, seen = _run(fluid, res, param_dir, guard, ckdir)
        w = tr.scope.raw('w_tr')
        out[name] = (seen, dict(guard.anomalies),
                     np.asarray(w) if name == 'jax' else w.numpy())
    assert out['port'][0] == out['jax'][0] == [False, False, True, False]
    assert out['port'][1] == out['jax'][1] == {'feed_nan': 1}
    assert np.isfinite(out['port'][2]).all()
    np.testing.assert_allclose(out['port'][2], out['jax'][2], atol=TOL,
                               rtol=TOL)


def test_policy_raise_matches_paddle_tpu(param_dir):
    for fluid, res in ((jfluid, jres), (tfluid, tres)):
        with pytest.raises(res.AnomalyError) as ei:
            _run(fluid, res, param_dir, _guard(res, 'raise'))
        assert (ei.value.kind, ei.value.where) == ('nan_inf', 'feed:x')


def test_gradient_norm_monitoring_matches_paddle_tpu(param_dir):
    got = {}
    for name, fluid, res in (('jax', jfluid, jres), ('port', tfluid, tres)):
        guard = _guard(res, 'skip_batch', check_feeds=False,
                       check_metrics=False, monitor_gradients=True)
        _run(fluid, res, param_dir, guard)
        got[name] = dict(guard.anomalies)
    # the poisoned step, and the next, whose parameters it poisoned
    assert got['port'] == got['jax'] and got['port']['grad_nan'] == 2


def test_spike_detection_and_global_norm_match_paddle_tpu():
    import torch
    for res in (jres, tres):
        g = res.AnomalyGuard(policy='raise', spike_window=10,
                             spike_factor=25.0, min_history=5)
        for _ in range(6):
            assert g.inspect_loss(1.0) is None
        err = g.inspect_loss(100.0)
        assert err.kind == 'spike' and g.anomalies['spike'] == 1
        off = res.AnomalyGuard(policy='raise', spike_window=0)
        for _ in range(6):
            assert off.inspect_loss(1.0) is None
        assert off.inspect_loss(1e9) is None
        with pytest.raises(ValueError):
            res.AnomalyGuard(policy='ignore')
    arrays = [np.random.RandomState(i).randn(5, 3).astype('float32')
              for i in range(3)]
    want = jres.global_norm(arrays)
    assert tres.global_norm(arrays) == pytest.approx(want, rel=1e-12)
    assert tres.global_norm([torch.from_numpy(a) for a in arrays]) == \
        pytest.approx(want, rel=1e-12)
    # a tensor loss is read where it lies
    assert tres.AnomalyGuard().inspect_loss(torch.tensor([np.nan])) \
        .kind == 'nan_inf'


def test_executor_level_guard_matches_paddle_tpu():
    bad = np.full((2, 4), np.nan, 'float32')
    good = np.ones((2, 4), 'float32')
    for pkg, res in ((jfluid, jres), (pt, tres)):
        main, startup = pkg.Program(), pkg.Program()
        with pkg.program_guard(main, startup):
            x = pkg.layers.data(name='x', shape=[4], dtype='float32')
            out = pkg.layers.reduce_mean(pkg.layers.scale(x, scale=2.0))
        exe = pkg.Executor(pkg.CPUPlace())
        with pkg.scope_guard(pkg.Scope()):
            exe.run(startup)
            guard = res.AnomalyGuard(policy='raise')
            with res.executor_guard(guard):
                exe.run(main, feed={'x': good}, fetch_list=[out])
                with pytest.raises(res.AnomalyError, match='fetch:'):
                    exe.run(main, feed={'x': bad}, fetch_list=[out])
                # async fetches are read by the guard too
                if pkg is pt:
                    with pytest.raises(res.AnomalyError):
                        exe.run(main, feed={'x': bad}, fetch_list=[out],
                                async_fetch=True)
            exe.run(main, feed={'x': bad}, fetch_list=[out])
            assert guard.anomalies['fetch_nan'] == (2 if pkg is pt else 1)
