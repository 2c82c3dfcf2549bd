"""The fused conv's stats form (train-mode batch norm) against paddle_tpu's.

- The stats form, ``cuda_kernels.fused_conv(..., emit_stats=True)`` (on
  the CPU its plain version), against the JAX package's Pallas kernel
  with ``emit_stats`` in interpret mode: y, and the per-channel sum and
  sum of squares of the f32 conv (JAX's per-block partials summed), to
  atol = rtol = 1e-5, f32 on both sides.
- ``_FusedConvStats``, the autograd Function the stats form runs under
  on either device (on the CPU with the plain forward): its backward
  against autograd of the plain composition to 1e-5; the same Function
  with the moments' cotangents dropped differs by far more.
- Whole train-mode regions in both packages, JAX on its Pallas kernel in
  interpret mode and the port on the stats form: the loss, every
  gradient and the moving statistics to 1e-5, with no replay.
"""
import contextlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import paddle_tpu.fluid as fluid
from paddle_tpu import observability as obs
from paddle_tpu.compiler import tuning as ctuning
from paddle_tpu.ops import pallas_kernels as pk
import paddle_tpu_torch as pt
from paddle_tpu_torch import io as pt_io
from paddle_tpu_torch.compiler import passes as pt_passes
from paddle_tpu_torch.ops import cuda_kernels as ck

from test_torch_conv import randomized_params

TOL = dict(atol=1e-5, rtol=1e-5)


@pytest.fixture(autouse=True)
def _defaults():
    prev = ctuning.set_default_cache(
        ctuning.TuningCache(path='/nonexistent/paddle-tpu-test-tuning'))
    pt_passes.reset_fallback_counts()
    yield
    ctuning.set_default_cache(prev)


# (N, H, W, Cin, Cout, K, stride, pad, depthwise); 'partial_tile' has M =
# N * Ho * Wo = 75 output rows: the kernel's last 64-row slot is partial
SHAPES = {
    '1x1': (2, 6, 6, 8, 12, 1, 1, 0, False),
    '3x3_pad1': (2, 6, 7, 5, 6, 3, 1, 1, False),
    '1x1_stride2': (2, 9, 9, 6, 10, 1, 2, 0, False),
    '3x3_stride2': (2, 9, 8, 4, 6, 3, 2, 1, False),
    'depthwise_3x3': (2, 7, 7, 6, 6, 3, 1, 1, True),
    'partial_tile': (3, 5, 5, 4, 7, 3, 1, 1, False),
}


def _operands(shape, seed=0):
    """x NHWC and the port's w ([Cout, KH, KW, Cin], depthwise [KH, KW,
    C]) as numpy, with the conv output away from zero mean."""
    N, H, W, cin, cout, k, s, p, dw = shape
    rng = np.random.RandomState(seed)
    x = (rng.randn(N, H, W, cin) + 0.3).astype('float32')
    w = (rng.randn(*((k, k, cin) if dw else (cout, k, k, cin))) /
         np.sqrt(k * k * (1 if dw else cin))).astype('float32')
    return x, w


@pytest.mark.parametrize('name', sorted(SHAPES))
def test_stats_form_matches_jax_pallas(name):
    shape = SHAPES[name]
    N, H, W, cin, cout, k, s, p, dw = shape
    x, w = _operands(shape)
    w_jax = w if dw else w.transpose(1, 2, 3, 0)          # HWIO
    with pk.force_conv_epilogue('interpret'):
        got, why = pk.fused_conv_epilogue(
            jnp.asarray(x), jnp.asarray(w_jax), (), (), (s, s), (p, p), dw,
            (), emit_stats=True, interpret=True)
    assert why is None
    j_y, j_psum, j_psumsq = (np.asarray(a) for a in got)
    y, ssum, ssq = ck.fused_conv(torch.tensor(x), torch.tensor(w), (), (),
                                 (), (s, s), (p, p), dw, emit_stats=True)
    assert y.dtype == torch.float32 and ssum.dtype == torch.float32
    assert ssum.shape == ssq.shape == (y.shape[3],)
    np.testing.assert_allclose(y.numpy(), j_y, **TOL)
    np.testing.assert_allclose(ssum.numpy(), j_psum.sum((0, 1)), **TOL)
    np.testing.assert_allclose(ssq.numpy(), j_psumsq.sum((0, 1)), **TOL)


def test_stats_form_refuses_epilogue_stages():
    x, w = (torch.tensor(a) for a in _operands(SHAPES['1x1']))
    with pytest.raises(ValueError):
        ck.fused_conv(x, w, (), (), (('act', 'relu'),), (1, 1), (0, 0),
                      False, emit_stats=True)



# ---- the depthwise kernel's slab -----------------------------------------------
# (N, H, W, C, K, stride, pad): C 24 and 40 (not a multiple of a block's
# slice), H and W 7, 9 and 11, 5x5 at stride 2; M = N * Ho * Wo is not a
# multiple of 64 in any of them
DEPTHWISE_SLAB_SHAPES = {
    'c24_9x9': (2, 9, 9, 24, 3, 1, 1),
    'c40_11x7': (3, 11, 7, 40, 3, 1, 1),
    'c40_7x7_s2': (3, 7, 7, 40, 3, 2, 1),
    'c24_11x11_5x5_s2': (2, 11, 11, 24, 5, 2, 2),
    'c40_9x11_5x5_s2': (2, 9, 11, 40, 5, 2, 2),
}


@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
@pytest.mark.parametrize('name', sorted(DEPTHWISE_SLAB_SHAPES))
def test_depthwise_slab_sums_to_jax_moments(name, dtype):
    """The depthwise kernel's slab as its plain version builds it
    (``depthwise_slab_reference``: a slot a block, each block's tiles) on
    the tile the card would take (132 SMs, the tile of ``dtype``): its
    slot count is the one the stats form allocates (fused_conv_slots),
    every slot holds outputs, and summed over its slots it gives the
    moments of the JAX Pallas kernel's stats form (interpret mode) to
    1e-5."""
    N, H, W, C, k, s, p = DEPTHWISE_SLAB_SHAPES[name]
    x, w = _operands((N, H, W, C, C, k, s, p, True))
    with pk.force_conv_epilogue('interpret'):
        got, why = pk.fused_conv_epilogue(
            jnp.asarray(x), jnp.asarray(w), (), (), (s, s), (p, p), True,
            (), emit_stats=True, interpret=True)
    assert why is None
    _, j_psum, j_psumsq = (np.asarray(a) for a in got)
    conv = ck.fused_conv_reference(torch.tensor(x), torch.tensor(w), (), (),
                                   (), (s, s), (p, p), True)
    M = conv.shape[0] * conv.shape[1] * conv.shape[2]
    assert M % ck.FUSED_CONV_STAT_ROWS
    tdtype = getattr(torch, dtype)
    plan = ck.fused_conv_plan(tdtype, N, H, W, C, C, k, k, (s, s), (p, p),
                              True, 132, emit_stats=True)
    tile = ck.depthwise_tile(tdtype, N, H, W, C, k, k, (s, s), (p, p), 132)
    slab = ck.depthwise_slab_reference(conv, tile)
    assert slab.shape == (2, ck.fused_conv_slots(plan, M, tile), C)
    counts = ck.depthwise_slab_reference(torch.ones_like(conv), tile)[0]
    assert (counts > 0).all() and counts.sum(0).eq(M).all()
    np.testing.assert_allclose(slab[0].sum(0).numpy(), j_psum.sum((0, 1)),
                               **TOL)
    np.testing.assert_allclose(slab[1].sum(0).numpy(),
                               j_psumsq.sum((0, 1)), **TOL)

# ---- the card's autograd Function, on the plain forward ------------------------
class MomentsDropped(ck._FusedConvStats):
    """A wrong stats form (a control): its backward ignores the moments'
    cotangents, as a Function that took sum and sumsq for constants
    would."""

    @staticmethod
    def backward(ctx, g_y, g_sum, g_sumsq):
        return ck._FusedConvStats.backward(ctx, g_y, None, None)


def _function_grads(shape, cotangents, function=None):
    """dx, dw of sum(y * gy) + gs . sum + gq . sumsq through the stats
    form's autograd Function (``function``, by default the one
    ``fused_conv`` applies) and through autograd of the plain
    composition."""
    N, H, W, cin, cout, k, s, p, dw = shape
    x, w = _operands(shape, seed=1)
    gy, gs, gq = cotangents
    out = []
    for via_function in (True, False):
        xt = torch.tensor(x, requires_grad=True)
        wt = torch.tensor(w, requires_grad=True)
        if not via_function:
            y, ssum, ssq = ck.fused_conv_reference(
                xt, wt, (), (), (), (s, s), (p, p), dw, emit_stats=True)
        elif function is None:
            y, ssum, ssq = ck.fused_conv(xt, wt, (), (), (), (s, s), (p, p),
                                         dw, emit_stats=True)
            assert type(y.grad_fn).__name__ == '_FusedConvStatsBackward'
        else:
            y, ssum, ssq = function.apply(((s, s), (p, p), dw),
                                          ck._stats_reference, xt, wt)
        f = (y * gy).sum() + (ssum * gs).sum() + (ssq * gq).sum()
        out.append(torch.autograd.grad(f, (xt, wt)))
    return out


def _cotangents(shape, seed=2):
    N, H, W, cin, cout, k, s, p, dw = shape
    ho, wo = (H + 2 * p - k) // s + 1, (W + 2 * p - k) // s + 1
    rng = np.random.RandomState(seed)
    return (torch.tensor(rng.randn(N, ho, wo, cout).astype('float32')),
            torch.tensor(rng.randn(cout).astype('float32')),
            torch.tensor(rng.randn(cout).astype('float32')))


@pytest.mark.parametrize('name', sorted(SHAPES))
def test_stats_function_backward_matches_plain_vjp(name):
    (fx, fw), (px, pw) = _function_grads(SHAPES[name],
                                         _cotangents(SHAPES[name]))
    np.testing.assert_allclose(fx.numpy(), px.numpy(), **TOL)
    np.testing.assert_allclose(fw.numpy(), pw.numpy(), **TOL)


def test_stats_function_control_without_moment_cotangents():
    """The control: the Function with g_sum and g_sumsq dropped in its
    backward passes any forward check, and misses the gradient by far
    more than the limit."""
    shape = SHAPES['3x3_pad1']
    (fx, fw), (px, pw) = _function_grads(shape, _cotangents(shape),
                                         MomentsDropped)
    for got, ref in ((fx, px), (fw, pw)):
        err = (got - ref).abs().max().item()
        assert err > 100 * (TOL['atol'] + TOL['rtol'] *
                            ref.abs().max().item())


# ---- whole train-mode regions against paddle_tpu -------------------------------
def _bn_relu(L, x):
    c = L.conv2d(input=x, num_filters=4, filter_size=3, padding=1,
                 bias_attr=False)
    return L.relu(L.batch_norm(input=c))          # train mode


def _bn_residual(L, x):
    c = L.conv2d(input=x, num_filters=3, filter_size=1, bias_attr=False)
    return L.elementwise_add(x=x, y=L.batch_norm(input=c, momentum=0.8),
                             act='relu')


def _bn_depthwise_stride2(L, x):
    c = L.conv2d(input=x, num_filters=3, filter_size=3, stride=2,
                 padding=1, groups=3, bias_attr=False)
    return L.sigmoid(L.batch_norm(input=c))


# build -> the region's fused_types
REGIONS = {
    'conv_bn_relu': (_bn_relu, ['conv2d', 'batch_norm', 'relu']),
    'residual_add': (_bn_residual, ['conv2d', 'batch_norm',
                                    'elementwise_add', 'relu']),
    'depthwise_stride2': (_bn_depthwise_stride2,
                          ['conv2d', 'batch_norm', 'sigmoid']),
}


def _train_program(pkg, region):
    main, startup = pkg.Program(), pkg.Program()
    main.random_seed = startup.random_seed = 17
    with pkg.unique_name.guard(), pkg.program_guard(main, startup):
        x = pkg.layers.data(name='x', shape=[3, 8, 8], dtype='float32')
        loss = pkg.layers.mean(REGIONS[region][0](pkg.layers, x))
        grads = pkg.backward.append_backward(loss)
    bn, = [op for op in main.global_block().ops if op.type == 'batch_norm']
    stats = [bn.output('MeanOut')[0], bn.output('VarianceOut')[0]]
    return main, startup, loss, [g.name for _, g in grads], stats


@pytest.mark.parametrize('region', sorted(REGIONS))
def test_train_region_loss_grads_and_stats_match_jax(region):
    """The JAX side runs its fused op on the Pallas kernel with
    emit_stats (interpret mode), the port's on the stats form's plain
    version: loss, every gradient, and the moving statistics after the
    run agree to 1e-5."""
    j_main, j_startup, j_loss, gnames, stats = _train_program(fluid, region)
    t_main, _, t_loss, t_gnames, t_stats = _train_program(pt, region)
    assert (t_gnames, t_stats) == (gnames, stats)
    params = randomized_params(j_main, j_startup)
    feed = {'x': np.random.RandomState(4).randn(2, 3, 8, 8)
            .astype('float32')}

    fallbacks = obs.default_registry().counter('conv_fuse_fallbacks_total')
    before = fallbacks.value
    j_scope = fluid.Scope()
    for n, a in params.items():
        j_scope.set_var(n, a)
    with pk.force_conv_epilogue('interpret'):
        j_res = fluid.Executor(fluid.CPUPlace()).run(
            j_main, feed=feed, fetch_list=[j_loss] + gnames, scope=j_scope)
    assert fallbacks.value == before, 'the JAX Pallas path did not engage'

    t_scope = pt.Scope()
    pt_io.params_from_numpy(t_scope, params, pt.CPUPlace())
    t_res = pt.Executor(pt.CPUPlace()).run(
        t_main, feed=feed, fetch_list=[t_loss] + gnames, scope=t_scope)
    assert pt_passes.FALLBACKS == {}
    opt, _ = pt.compiler.optimize(t_main, fetch_names=[t_loss.name])
    assert [op.attrs['fused_types'] for op in opt.global_block().ops
            if op.type == 'fused_conv'] == [REGIONS[region][1]]
    for name, j, t in zip(['loss'] + gnames, j_res, t_res):
        assert t.shape == np.asarray(j).shape, name
        np.testing.assert_allclose(t, np.asarray(j), err_msg=name, **TOL)
    for name in stats:
        moved = pt.executor.as_numpy(t_scope.raw(name))
        np.testing.assert_allclose(moved, np.asarray(j_scope.raw(name)),
                                   err_msg=name, **TOL)
        assert not np.allclose(moved, params[name]), name


def test_train_region_trains_like_the_unfused_ops():
    """The port against itself: the fused train-mode region and the same
    program with the compiler disabled give the same loss, gradients and
    moving statistics."""
    main, startup, loss, gnames, stats = _train_program(pt, 'residual_add')
    feed = {'x': np.random.RandomState(5).randn(2, 3, 8, 8)
            .astype('float32')}
    exe = pt.Executor(pt.CPUPlace())
    results = []
    for optimize in (True, False):
        scope = pt.Scope()
        exe.run(startup, scope=scope)
        with contextlib.nullcontext() if optimize else \
                pt.compiler.disabled():
            res = exe.run(main, feed=feed, fetch_list=[loss] + gnames,
                          scope=scope)
        results.append(res + [pt.executor.as_numpy(scope.raw(n))
                              for n in stats])
    assert pt_passes.FALLBACKS == {}
    for f, r in zip(*results):
        np.testing.assert_allclose(f, r, **TOL)
