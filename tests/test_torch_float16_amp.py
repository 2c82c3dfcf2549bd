"""Half precision on the port against paddle_tpu, on the CPU: the
``Float16Transpiler`` (the count of tensors cast, half weights in the
Scope, f32 feeds and fetches, a sequence fetch, the unknown-dtype
error, and a four-layer conv/batch-norm net's transpiled logits against
paddle_tpu's transpiled program within HALF_ULPS ulps of the half dtype
at the largest logit); the AMP activation setting and its environment
overrides against ``paddle_tpu.core.amp`` under a forced
``set_amp(True)`` (the dtype each activation flows in, and the output
within 2^-5 of its scale); and
the ``check_nan_inf`` guard's message against paddle_tpu's checkify
message on the same program.
"""
import jax  # noqa: F401 (the JAX side runs on the CPU)
import numpy as np
import pytest
import torch

import paddle_tpu as jfluid
from paddle_tpu import debugging as jdebugging
from paddle_tpu.core import amp as jamp
import paddle_tpu_torch as pt
import paddle_tpu_torch.fluid as tfluid
from paddle_tpu_torch import io as pt_io
from paddle_tpu_torch.core import amp as tamp
from paddle_tpu_torch.core.lowering import lower_block, RNG_KEY, RNG_CPU_KEY

HALF_TOL = 2 ** -5
# the transpiled program's logits against paddle_tpu's transpiled
# program, in units of the half dtype's ulp at the largest logit: the
# same half weights and feed, each op's result rounded to half on both
# sides, but products summed in another order before that rounding
# (read: at most 2.0 ulps over 10 seeds, bf16 and f16 alike)
HALF_ULPS = 4
MANTISSA_BITS = {'bfloat16': 7, 'float16': 10}


def _build_infer(pkg):
    """Four conv + batch-norm (inference) layers, two max pools, an fc
    to 10 logits and their softmax."""
    main, start = pkg.Program(), pkg.Program()
    with pkg.unique_name.guard(), pkg.program_guard(main, start):
        h = pkg.layers.data(name='img', shape=[3, 16, 16],
                            dtype='float32')
        for filters, pool in ((16, False), (16, True), (32, False),
                              (32, True)):
            h = pkg.layers.conv2d(h, num_filters=filters, filter_size=3,
                                  padding=1)
            h = pkg.layers.batch_norm(h, act='relu', is_test=True)
            if pool:
                h = pkg.layers.pool2d(h, pool_size=2, pool_stride=2)
        logits = pkg.layers.fc(h, size=10)
        out = pkg.layers.softmax(logits)
    return main, start, logits, out


def _pair(seed=0):
    """Both programs, the JAX package's startup scope carried into the
    port's, every batch norm's affine and moving statistics drawn from
    ``seed`` (not the startup's identity) in both."""
    jmain, jstart, jlogits, _ = _build_infer(jfluid)
    tmain, _, tlogits, tout = _build_infer(pt)
    jscope = jfluid.Scope()
    jfluid.Executor(jfluid.CPUPlace()).run(jstart, scope=jscope)
    state = {v.name: np.asarray(jscope.raw(v.name))
             for v in jstart.list_vars() if jscope.raw(v.name) is not None}
    rng = np.random.RandomState(seed)
    for op in jmain.global_block().ops:
        if op.type == 'batch_norm':
            for slot, draw in (('Scale', 'rand'), ('Bias', 'randn'),
                               ('Mean', 'randn'), ('Variance', 'rand')):
                n = op.input(slot)[0]
                v = getattr(rng, draw)(*state[n].shape)
                state[n] = (v + 0.5 if draw == 'rand' else 0.1 * v
                            ).astype('float32')
                jscope.set_var(n, jax.numpy.asarray(state[n]))
    tscope = pt.Scope()
    pt_io.params_from_numpy(tscope, state, pt.CPUPlace())
    return (jmain, jlogits, jscope), (tmain, tlogits, tout, tscope)


@pytest.mark.parametrize('seed', [0, 1, 2])
@pytest.mark.parametrize('dtype', ['bfloat16', 'float16'])
def test_float16_transpiler_matches_paddle_tpu(dtype, seed):
    (jmain, jlogits, jscope), (tmain, tlogits, tout, tscope) = _pair(seed)
    xv = np.random.RandomState(seed).rand(4, 3, 16, 16).astype('float32')
    jexe, texe = jfluid.Executor(jfluid.CPUPlace()), pt.Executor(
        pt.CPUPlace())
    f32, = texe.run(tmain, feed={'img': xv}, fetch_list=[tlogits],
                    scope=tscope)
    jn = jfluid.contrib.Float16Transpiler().transpile(
        jmain, jfluid.CPUPlace(), scope=jscope, dtype=dtype)
    tn = tfluid.contrib.Float16Transpiler().transpile(
        tmain, pt.CPUPlace(), scope=tscope, dtype=dtype)
    assert tn == jn and tn >= 4
    cast = [v.name for v in jmain.list_vars() if v.persistable and
            str(np.asarray(jscope.raw(v.name)).dtype) == dtype]
    assert len(cast) == jn
    for n in cast:                 # the moving statistics included
        assert tscope.raw(n).dtype == getattr(torch, dtype), n
        assert tmain.global_block().var(n).dtype == dtype, n
    half, prob = texe.run(tmain, feed={'img': xv},
                          fetch_list=[tlogits, tout], scope=tscope)
    ref, = jexe.run(jmain, feed={'img': xv}, fetch_list=[jlogits],
                    scope=jscope)
    ref = np.asarray(ref)
    assert half.dtype == prob.dtype == np.float32
    scale = np.abs(ref).max()
    ulp = 2.0 ** (np.floor(np.log2(scale)) - MANTISSA_BITS[dtype])
    assert np.abs(half - ref).max() <= HALF_ULPS * ulp
    assert not np.array_equal(half, f32)      # it ran in half
    assert np.abs(half - f32).max() <= HALF_TOL * np.abs(f32).max()


def test_float16_transpiler_rejects_unknown_dtype():
    main, _, _, _ = _build_infer(pt)
    for pkg in (jfluid, tfluid):
        with pytest.raises(ValueError, match='dtype must be one of'):
            pkg.contrib.Float16Transpiler().transpile(main, None,
                                                      dtype='int8')


def test_float16_transpiler_sequence_fetch():
    main, start = pt.Program(), pt.Program()
    with pt.program_guard(main, start):
        x = pt.layers.data(name='x', shape=[1], dtype='float32',
                           lod_level=1)
        s = pt.layers.sequence_softmax(pt.layers.scale(x, scale=2.0))
    exe = pt.Executor(pt.CPUPlace())
    scope = pt.Scope()
    exe.run(start, scope=scope)
    rows = np.random.RandomState(0).rand(5, 1).astype('float32')
    t = pt.create_lod_tensor(rows, [[2, 3]], pt.CPUPlace())
    tfluid.contrib.Float16Transpiler().transpile(main, pt.CPUPlace(),
                                                 scope=scope)
    r, = exe.run(main, feed={'x': t}, fetch_list=[s], scope=scope,
                 return_numpy=False)
    assert isinstance(r, pt.SequenceTensor)
    assert r.data.dtype == torch.float32
    assert torch.isfinite(r.data).all()


def _amp_program(pkg):
    main, start = pkg.Program(), pkg.Program()
    with pkg.unique_name.guard(), pkg.program_guard(main, start):
        img = pkg.layers.data(name='img', shape=[1, 12, 12],
                              dtype='float32')
        # no biases: an f32 bias added to a bf16 product promotes it to
        # f32 in both packages
        c = pkg.layers.conv2d(img, num_filters=4, filter_size=3,
                              act='relu', bias_attr=False)
        h = pkg.layers.fc(c, size=6, act='relu', bias_attr=False)
        out = pkg.layers.softmax(h)
    return main, start, [c, h, out]


@pytest.fixture
def forced_amp():
    jamp.set_amp(True)
    tamp.set_amp(True)
    yield
    for m in (jamp, tamp):
        m.set_amp(None)
        m.set_amp_act(None)


@pytest.mark.parametrize('act_bf16', [True, False])
def test_amp_act_setting_matches_paddle_tpu(forced_amp, act_bf16):
    jamp.set_amp_act(act_bf16)
    tamp.set_amp_act(act_bf16)
    assert tamp.act_bf16('cpu') == jamp.act_bf16() == act_bf16
    jmain, jstart, jfetch = _amp_program(jfluid)
    tmain, _, tfetch = _amp_program(pt)
    jscope = jfluid.Scope()
    jexe = jfluid.Executor(jfluid.CPUPlace())
    jexe.run(jstart, scope=jscope)
    state = {v.name: np.asarray(jscope.raw(v.name))
             for v in jstart.list_vars() if jscope.raw(v.name) is not None}
    xv = np.random.RandomState(3).rand(2, 1, 12, 12).astype('float32')
    ref = jexe.run(jmain, feed={'img': xv}, fetch_list=jfetch, scope=jscope)
    # the port's block as lowered, its fetches in the dtype they flow in:
    # as built (conv2d) and after the passes (the conv and its relu a
    # fused_conv region)
    names = [v.name for v in tfetch]
    fused, _ = pt.compiler.optimize(tmain, fetch_names=names)
    assert [op.type for op in fused.global_block().ops].count(
        'fused_conv') == 1
    want = torch.bfloat16 if act_bf16 else torch.float32
    for r in ref[:2]:
        assert str(np.asarray(r).dtype) == ('bfloat16' if act_bf16
                                            else 'float32')
    for prog in (tmain, fused):
        fn = lower_block(prog, prog.global_block(), ['img'], names,
                         sorted(state), [], torch.device('cpu'))
        env = {n: torch.tensor(v) for n, v in state.items()}
        env[RNG_KEY] = env[RNG_CPU_KEY] = torch.Generator()
        got, _ = fn({'img': torch.from_numpy(xv)}, env)
        for g in got[:2]:                     # the conv's and the fc's
            assert g.dtype == want
        for g, r in zip(got, ref):
            r = np.asarray(r).astype('float32')
            assert np.abs(g.float().numpy() - r).max() <= \
                HALF_TOL * np.abs(r).max()


def test_amp_environment_overrides(monkeypatch):
    """The overrides are read at import and by ``set_amp(None)`` /
    ``set_amp_act(None)``, not on every product."""
    def reread():
        tamp.set_amp(None)
        tamp.set_amp_act(None)
    reread()
    monkeypatch.setenv('PADDLE_TPU_TORCH_AMP', '1')
    assert not tamp.amp_enabled('cpu')       # not read yet
    reread()
    assert tamp.amp_enabled('cpu') and tamp.act_bf16('cpu')
    monkeypatch.setenv('PADDLE_TPU_TORCH_AMP_ACT', 'f32')
    reread()
    assert tamp.amp_enabled('cpu') and not tamp.act_bf16('cpu')
    x = torch.ones(2, 3)
    assert tamp.matmul_compute(torch.matmul, x, x.T).dtype == torch.float32
    monkeypatch.setenv('PADDLE_TPU_TORCH_AMP_ACT', 'bf16')
    reread()
    assert tamp.matmul_compute(torch.matmul, x, x.T).dtype == torch.bfloat16
    monkeypatch.setenv('PADDLE_TPU_TORCH_AMP', '0')
    reread()
    assert not tamp.amp_enabled('cpu') and not tamp.act_bf16('cpu')
    assert not tamp.amp_enabled('cuda')
    monkeypatch.delenv('PADDLE_TPU_TORCH_AMP')
    reread()
    assert not tamp.amp_enabled('cpu')       # by device: off on the CPU
    assert tamp.amp_enabled(torch.device('cuda'))
    tamp.set_amp(True)                        # forcing beats the env
    try:
        monkeypatch.setenv('PADDLE_TPU_TORCH_AMP', '0')
        assert tamp.amp_enabled('cpu')
    finally:
        monkeypatch.delenv('PADDLE_TPU_TORCH_AMP')
        reread()


def _nan_program(pkg):
    main, start = pkg.Program(), pkg.Program()
    with pkg.unique_name.guard(), pkg.program_guard(main, start):
        x = pkg.layers.data(name='x', shape=[4], dtype='float32')
        h = pkg.layers.log(x)
        out = pkg.layers.mean(pkg.layers.scale(h, scale=2.0))
    return main, out


def test_check_nan_inf_message_matches_paddle_tpu():
    bad = {'x': -np.ones((2, 4), 'float32')}
    jmain, jout = _nan_program(jfluid)
    with jdebugging.nan_guard():
        with pytest.raises(Exception) as jerr:
            jfluid.Executor(jfluid.CPUPlace()).run(
                jmain, feed=bad, fetch_list=[jout], scope=jfluid.Scope())
    tmain, tout = _nan_program(pt)
    exe = pt.Executor(pt.CPUPlace())
    assert not tfluid.nan_checks_enabled()
    out, = exe.run(tmain, feed=bad, fetch_list=[tout], scope=pt.Scope())
    assert np.isnan(out).all()               # off: no check, no raise
    with tfluid.nan_guard():
        assert tfluid.nan_checks_enabled()
        with pytest.raises(FloatingPointError) as terr:
            exe.run(tmain, feed=bad, fetch_list=[tout], scope=pt.Scope())
    assert not tfluid.nan_checks_enabled()
    want = ("NaN/Inf detected in output 'log_0.tmp_0' of op 'log' "
            "(inputs: ['x'])")
    assert str(terr.value) == want
    assert want in str(jerr.value)
    prev = tfluid.check_nan_inf(True)
    try:
        good, = exe.run(tmain, feed={'x': np.ones((2, 4), 'float32')},
                        fetch_list=[tout], scope=pt.Scope())
        assert np.isfinite(good).all()
    finally:
        tfluid.check_nan_inf(prev)
