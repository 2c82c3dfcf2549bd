"""The port's CUDA kernels on the card, held against their plain PyTorch
versions. Marked ``cuda``; each test skips where CUDA is absent (the
check runs inside the fixture, never at import). Run on the card with

    python -m pytest --noconftest -q tests/test_torch_cuda_kernels.py

(``--noconftest``: the suite's conftest configures JAX, which the card's
host need not have).
"""
import pytest
import torch

import paddle_tpu_torch as pt
from paddle_tpu_torch.ops import cuda_kernels as ck

pytestmark = pytest.mark.cuda

# out/lse tolerance against the plain version run in f32 on the same
# inputs: bf16 rounds the probabilities before P.V, f32 only reorders
TOL = {torch.bfloat16: (2e-2, 1e-3), torch.float32: (1e-4, 1e-4)}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False    # the plain convs in full f32
    return torch.device('cuda')


@pytest.mark.parametrize('dtype', [torch.bfloat16, torch.float32])
@pytest.mark.parametrize('D', [32, 64, 128])
@pytest.mark.parametrize('causal', [True, False])
@pytest.mark.parametrize('T', [1, 130, 1024])
def test_flash_kernel_matches_plain(cuda, dtype, D, causal, T):
    gen = torch.Generator(device=cuda)
    gen.manual_seed(T * 1000 + D)
    q, k, v = (torch.randn(2, T, 3, D, device=cuda, generator=gen)
               .to(dtype) for _ in range(3))
    before = ck.LAUNCHES['flash_attn_fwd']
    out, lse = ck.flash_attention_with_lse(q, k, v, causal)
    torch.cuda.synchronize()
    assert ck.LAUNCHES['flash_attn_fwd'] == before + 1
    ref_out, ref_lse = ck.flash_attention_reference_with_lse(
        q.float(), k.float(), v.float(), causal)
    assert out.dtype == dtype and lse.shape == (2, 3, T)
    atol_out, atol_lse = TOL[dtype]
    assert (out.float() - ref_out).abs().max().item() <= atol_out
    assert (lse - ref_lse).abs().max().item() <= atol_lse


# backward kernels vs the plain backward on the same inputs: max |err| <=
# tol * max(max |plain|, floor), per dtype (tol, floor). bf16 rounds p and
# ds before the products and writes bf16 gradients (2**-8 relative per
# rounding, over sums whose order differs); f32 only reorders f32 sums
# (and the merged kernel's atomics). The floor covers gradients that are
# exactly 0 (dq and dk at T = 1), where what is left is the cancellation
# in dp - delta: ~1e-6 in f32 at these widths.
BWD_TOL = {torch.bfloat16: (2e-2, 1e-3), torch.float32: (1e-4, 0.1)}


def _bwd_inputs(cuda, dtype, B, T, H, D, causal, seed):
    gen = torch.Generator(device=cuda)
    gen.manual_seed(seed)
    q, k, v, do = (torch.randn(B, T, H, D, device=cuda, generator=gen)
                   .to(dtype) for _ in range(4))
    out, lse = ck.flash_attention_with_lse(q, k, v, causal)
    return q, k, v, do, lse, ck.flash_bwd_delta(out, do)


def _tol_ratio(got, ref):
    tol, floor = BWD_TOL[ref.dtype]
    return ((got.float() - ref.float()).abs().max() /
            ref.float().abs().max().clamp_min(floor)).item() / tol


@pytest.mark.parametrize('dtype', [torch.bfloat16, torch.float32])
@pytest.mark.parametrize('D', [32, 64, 128])
@pytest.mark.parametrize('causal', [True, False])
@pytest.mark.parametrize('T', [1, 130, 1024])
def test_flash_bwd_kernels_match_plain(cuda, dtype, D, causal, T):
    q, k, v, do, lse, delta = _bwd_inputs(cuda, dtype, 2, T, 3, D, causal,
                                          seed=T * 1000 + D + causal)
    ref = ck.flash_bwd_reference(q, k, v, do, lse, delta, causal)
    before = dict(ck.LAUNCHES)
    merged = ck.flash_bwd_dkvdq(q, k, v, do, lse, delta, causal)
    two_pass = ((ck.flash_bwd_dq(q, k, v, do, lse, delta, causal),) +
                ck.flash_bwd_dkv(q, k, v, do, lse, delta, causal))
    torch.cuda.synchronize()
    for name in ('flash_attn_bwd_dkvdq', 'flash_attn_bwd_dq',
                 'flash_attn_bwd_dkv'):
        assert ck.LAUNCHES[name] == before[name] + 1
    for got in (merged, two_pass):
        for g, r in zip(got, ref):
            assert g.dtype == dtype and g.shape == q.shape
            assert _tol_ratio(g, r) <= 1


def test_flash_bwd_routes_like_pallas(cuda, monkeypatch):
    """Merged kernel by default; the two-pass kernels with the flag off or
    past the byte cap; every route through autograd gives the plain
    gradients."""
    q, k, v, do, _, _ = _bwd_inputs(cuda, torch.bfloat16, 1, 256, 2, 64,
                                    True, seed=1)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]

    def grads():
        out = ck.flash_attention(*leaves)
        return torch.autograd.grad(out, leaves, do)

    for flag, cap, kernels in (
            (True, ck._MERGED_BWD_MAX_SLAB_BYTES, ['flash_attn_bwd_dkvdq']),
            (False, ck._MERGED_BWD_MAX_SLAB_BYTES,
             ['flash_attn_bwd_dq', 'flash_attn_bwd_dkv']),
            (True, 1024, ['flash_attn_bwd_dq', 'flash_attn_bwd_dkv'])):
        monkeypatch.setattr(ck, '_MERGED_BWD', [flag])
        monkeypatch.setattr(ck, '_MERGED_BWD_MAX_SLAB_BYTES', cap)
        before = dict(ck.LAUNCHES)
        got = grads()
        torch.cuda.synchronize()
        assert [n for n in ck.LAUNCHES if ck.LAUNCHES[n] != before[n]] == \
            ['flash_attn_fwd'] + kernels
        out, lse = ck.flash_attention_reference_with_lse(q, k, v)
        ref = ck.flash_bwd_reference(q, k, v, do, lse,
                                     ck.flash_bwd_delta(out, do))
        for g, r in zip(got, ref):
            assert _tol_ratio(g, r) <= 1


def test_flash_kernel_refuses_what_it_does_not_take(cuda):
    q = torch.zeros(1, 64, 2, 48, device=cuda)
    with pytest.raises(ValueError):
        ck.flash_attention_with_lse(q, q, q)


def test_flash_op_launches_the_kernel_on_the_card(cuda):
    main, startup = pt.Program(), pt.Program()
    with pt.unique_name.guard(), pt.program_guard(main, startup):
        q, k, v = (pt.layers.data(name=n, shape=[256, 128], dtype='float32')
                   for n in 'qkv')
        out = pt.layers.flash_attention(q, k, v, num_heads=2)
    gen = torch.Generator(device=cuda)
    gen.manual_seed(0)
    feed = {n: torch.randn(2, 256, 128, device=cuda, generator=gen)
            for n in 'qkv'}
    exe = pt.Executor()
    before = ck.LAUNCHES['flash_attn_fwd']
    got, = exe.run(main, feed=feed, fetch_list=[out], scope=pt.Scope(),
                   return_numpy=False)
    assert ck.LAUNCHES['flash_attn_fwd'] == before + 1
    ref = ck.flash_attention_reference_with_lse(
        *(feed[n].reshape(2, 256, 2, 64) for n in 'qkv'))[0]
    assert (got - ref.reshape(2, 256, 128)).abs().max().item() <= 1e-4


def test_training_step_launches_the_kernels(cuda):
    """One Adam step of a small flagship on the card: one forward and one
    merged backward launch per layer; the loss is finite and every
    parameter moves."""
    from paddle_tpu_torch.models.fluid_transformer import transformer
    main, startup = pt.Program(), pt.Program()
    startup.random_seed = 1
    with pt.unique_name.guard(), pt.program_guard(main, startup):
        loss, feed_fn, _, _ = transformer(vocab=512, d_model=256, n_heads=2,
                                          n_layers=2, d_ff=512, seq=256)
        pt.optimizer.Adam(learning_rate=1e-3).minimize(loss)
    exe = pt.Executor()
    scope = pt.Scope()
    exe.run(startup, scope=scope)
    params = [p.name for p in main.global_block().all_parameters()]
    before = {n: scope.raw(n).clone() for n in params}
    ck.reset_launch_counts()
    out, = exe.run(main, feed=feed_fn(2), fetch_list=[loss], scope=scope)
    torch.cuda.synchronize()
    assert ck.LAUNCHES == {'flash_attn_fwd': 2, 'flash_attn_bwd_dkvdq': 2,
                           'flash_attn_bwd_dq': 0, 'flash_attn_bwd_dkv': 0,
                           'fused_conv': 0}
    assert out.shape == (1,) and abs(float(out[0]) - 6.24) < 1.0
    for n in params:
        assert not torch.equal(scope.raw(n), before[n]), n


# ---- fused conv -----------------------------------------------------------------
# kernel vs the plain version on the same inputs, per element: |err| <=
# rel * |plain| + abs * rms(plain), (rel, abs) per dtype. Both sides sum
# the same products in f32 in another order, then bf16 rounds once: the
# two roundings differ by at most one step, 2**-7 of |plain|; the abs
# term holds the reordered sums where the output is near 0
CONV_TOL = {torch.bfloat16: (2 ** -7, 2 ** -8), torch.float32: (1e-5, 1e-4)}


def _conv_case(cuda, dtype, N, H, W, cin, cout, k, s, p, depthwise, seed,
               stages=(('affine', 0, 1), ('act', 'relu')), extra_aux=()):
    gen = torch.Generator(device=cuda)
    gen.manual_seed(seed)

    def randn(*shape):
        return torch.randn(*shape, device=cuda, generator=gen)

    x = randn(N, H, W, cin).to(dtype)
    w_shape = (k, k, cin) if depthwise else (cout, k, k, cin)
    w = (randn(*w_shape) * (2.0 / (k * k * (1 if depthwise else cin)))
         ** 0.5).to(dtype)
    ho, wo = (H + 2 * p - k) // s + 1, (W + 2 * p - k) // s + 1
    # the folded batch norm, its shift at the scale of the conv's output
    aux = [randn(1, cout).abs() + 0.5, randn(1, cout)]
    shapes = {'c': (1, cout), 'nc': (N, cout), 't': (N, ho, wo, cout),
              's': (1, 1)}
    kinds = ['c', 'c']
    for kind in extra_aux:
        # a per-channel operand stays positive: it is the base of pow
        a = randn(*shapes[kind])
        aux.append(a.abs() + 0.5 if kind == 'c' else
                   a.to(dtype if kind == 't' else torch.float32))
        kinds.append(kind)
    return x, w, aux, kinds, list(stages), (s, s), (p, p), depthwise


def _err_ratio(got, ref):
    """max over elements of |got - ref| / (rel |ref| + abs rms(ref))."""
    rel, abs_ = CONV_TOL[ref.dtype]
    ref = ref.float()
    limit = rel * ref.abs() + abs_ * ref.square().mean().sqrt()
    return ((got.float() - ref).abs() / limit).max().item()


def _check_conv(case):
    """The kernel matches the plain version per element; where the
    epilogue has a batch-norm affine, the kernel with its shift dropped
    fails that check."""
    x, w, aux, kinds, stages, strides, pads, depthwise = case
    before = ck.LAUNCHES['fused_conv']
    got = ck.fused_conv(x, w, aux, kinds, stages, strides, pads, depthwise)
    torch.cuda.synchronize()
    assert ck.LAUNCHES['fused_conv'] == before + 1
    ref = ck.fused_conv_reference(x, w, aux, kinds, stages, strides, pads,
                                  depthwise)
    assert got.dtype == x.dtype and got.shape == ref.shape
    assert _err_ratio(got, ref) <= 1
    for st in stages:
        if st[0] == 'affine':
            bad = list(aux)
            bad[st[2]] = torch.zeros_like(aux[st[2]])
            assert _err_ratio(ck.fused_conv(x, w, bad, kinds, stages, strides,
                                            pads, depthwise), ref) > 1


# (N, H, W, Cin, Cout, K, stride, pad, depthwise): ResNet-50's region
# shapes at a small batch (64-row tiles), one large enough for 128-row
# tiles, plus ragged and odd sizes
CONV_SHAPES = {
    'stem_7x7_s2_cin3': (2, 32, 32, 3, 64, 7, 2, 3, False),
    '1x1_64_256': (2, 14, 14, 64, 256, 1, 1, 0, False),
    '1x1_s2_256_512': (2, 14, 14, 256, 512, 1, 2, 0, False),
    '3x3_64': (2, 14, 14, 64, 64, 3, 1, 1, False),
    '3x3_s2_ragged': (3, 9, 11, 40, 72, 3, 2, 1, False),
    '1x1_128_row_tiles': (16, 56, 56, 64, 136, 1, 1, 0, False),
    'cin5_cout7': (1, 6, 5, 5, 7, 3, 1, 1, False),
    'depthwise_3x3': (2, 10, 10, 32, 32, 3, 1, 1, True),
    'depthwise_5x5_s2': (2, 11, 9, 24, 24, 5, 2, 2, True),
}


@pytest.mark.parametrize('dtype', [torch.bfloat16, torch.float32])
@pytest.mark.parametrize('shape', sorted(CONV_SHAPES))
def test_fused_conv_kernel_matches_plain(cuda, dtype, shape):
    _check_conv(_conv_case(cuda, dtype, *CONV_SHAPES[shape],
                           seed=len(shape)))


# each aux kind, binary op order and stage kind on the kernel
EPILOGUES = {
    'residual_t': ((('affine', 0, 1), ('bin', 'elementwise_add', 2, True),
                    ('act', 'relu')), ('t',)),
    'se_nc': ((('affine', 0, 1), ('bin', 'elementwise_mul', 2, False),
               ('act', 'sigmoid')), ('nc',)),
    'scalar_s': ((('bin', 'elementwise_sub', 2, True),
                  ('scale', 1.5, -0.25, False), ('postmul', 0.5)), ('s',)),
    'params': ((('act_p', 'leaky_relu', (0.1,)),
                ('act_p', 'swish', (1.3,)),
                ('act_p', 'hard_sigmoid', (0.3, 0.4))), ()),
}


@pytest.mark.parametrize('dtype', [torch.bfloat16, torch.float32])
@pytest.mark.parametrize('epi', sorted(EPILOGUES))
def test_fused_conv_epilogue_kinds(cuda, dtype, epi):
    stages, extra = EPILOGUES[epi]
    _check_conv(_conv_case(cuda, dtype, 2, 8, 8, 16, 24, 3, 1, 1, False, 5,
                           stages=stages, extra_aux=extra))


def test_fused_conv_every_activation_and_binary_op(cuda):
    """Each entry of activations.ACTS / ACTS_P / BINS as a stage, on
    inputs kept positive where the function needs it."""
    from paddle_tpu_torch.ops.activations import (ACTS, ACTS_P, BINS,
                                                  PARAM_ATTRS)
    stages = ([[('act', 'abs'), ('scale', 1.0, 0.25, True), ('act', n)]
               for n in ACTS] +
              [[('act_p', n, (0.4, 1.2)[:len(PARAM_ATTRS[n])])]
               for n in ACTS_P if n != 'pow'] +
              [[('act', 'abs'), ('act_p', 'pow', (1.5,))]] +
              [[('act', 'abs'), ('scale', 1.0, 0.25, True),
                ('bin', n, 2, swap)] for n in BINS for swap in (0, 1)])
    for st in stages:
        _check_conv(_conv_case(cuda, torch.float32, 1, 6, 6, 8, 16, 3, 1, 1,
                               False, 9, stages=st, extra_aux=('c',)))


def test_resnet50_serves_on_the_fused_kernel(cuda):
    """ResNet-50 at 32 x 32: one request launches the fused conv 53
    times with no fallback, and agrees with the same program on the
    plain fused conv."""
    from paddle_tpu_torch.compiler import passes
    from paddle_tpu_torch.models.resnet import resnet_imagenet
    main, startup = pt.Program(), pt.Program()
    startup.random_seed = 1
    with pt.unique_name.guard(), pt.program_guard(main, startup):
        img = pt.layers.data(name='img', shape=[3, 32, 32], dtype='float32')
        prob = resnet_imagenet(img, 1000, depth=50, is_test=True)
    exe = pt.Executor()
    scope = pt.Scope()
    exe.run(startup, scope=scope)
    feed = {'img': torch.randn(4, 3, 32, 32, device=cuda)}
    passes.reset_fallback_counts()
    before = ck.LAUNCHES['fused_conv']
    got, = exe.run(main, feed=feed, fetch_list=[prob], scope=scope)
    torch.cuda.synchronize()
    assert ck.LAUNCHES['fused_conv'] == before + 53
    assert passes.FALLBACKS == {}
    with passes.conv_for_testing():
        ref, = exe.run(main, feed=feed, fetch_list=[prob], scope=scope)
    assert got.shape == (4, 1000)
    assert (got.argmax(1) == ref.argmax(1)).all()


def test_fused_region_trains_on_the_card(cuda):
    """A conv + bias + relu region in a training program on the card:
    the forward launches the kernel and the gradient, taken through the
    plain version, matches the same step with the compiler disabled."""
    from paddle_tpu_torch.compiler import passes
    main, startup = pt.Program(), pt.Program()
    startup.random_seed = 2
    with pt.unique_name.guard(), pt.program_guard(main, startup):
        x = pt.layers.data(name='x', shape=[16, 12, 12], dtype='float32')
        c = pt.layers.conv2d(x, num_filters=32, filter_size=3, padding=1,
                             act='relu')
        loss = pt.layers.mean(pt.layers.conv2d(c, num_filters=8,
                                               filter_size=1, act='tanh'))
        pt.optimizer.SGD(learning_rate=0.1).minimize(loss)
    grads = sorted(v.name for v in main.list_vars()
                   if v.name.endswith('@GRAD'))
    gen = torch.Generator(device=cuda)
    gen.manual_seed(3)
    feed = {'x': torch.randn(4, 16, 12, 12, device=cuda, generator=gen)}
    exe = pt.Executor()
    results = []
    passes.reset_fallback_counts()
    for optimize in (True, False):
        scope = pt.Scope()
        exe.run(startup, scope=scope)
        before = ck.LAUNCHES['fused_conv']
        if optimize:
            results.append(exe.run(main, feed=feed, fetch_list=[loss] + grads,
                                   scope=scope, return_numpy=False))
            assert ck.LAUNCHES['fused_conv'] == before + 2
        else:
            with pt.compiler.disabled():
                results.append(exe.run(main, feed=feed,
                                       fetch_list=[loss] + grads,
                                       scope=scope, return_numpy=False))
            assert ck.LAUNCHES['fused_conv'] == before
    torch.cuda.synchronize()
    assert passes.FALLBACKS == {}
    # both sides run their convs in bf16 under AMP; the fused side rounds
    # once per region, the unfused one after the conv and after each op
    for f, r in zip(*results):
        assert (f.float() - r.float()).norm() <= 2e-2 * r.float().norm()
