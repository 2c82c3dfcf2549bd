"""The port's CUDA kernels on the card, held against their plain PyTorch
versions. Marked ``cuda``; each test skips where CUDA is absent (the
check runs inside the fixture, never at import). Run on the card with

    python -m pytest --noconftest -q tests/test_torch_cuda_kernels.py

(``--noconftest``: the suite's conftest configures JAX, which the card's
host need not have).
"""
import contextlib

import numpy as np
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


# B*H 6, and 18 across the kernels' head groups of 16; T 130 is not a
# multiple of any tile (64 or 128)
@pytest.mark.parametrize('dtype', [torch.bfloat16, torch.float32])
@pytest.mark.parametrize('D', [32, 64, 128])
@pytest.mark.parametrize('causal', [True, False])
@pytest.mark.parametrize('T', [1, 130, 1024])
@pytest.mark.parametrize('B, H', [(2, 3), (2, 9)])
def test_flash_bwd_kernels_match_plain(cuda, dtype, D, causal, T, B, H):
    q, k, v, do, lse, delta = _bwd_inputs(cuda, dtype, B, T, H, D, causal,
                                          seed=T * 1000 + D + causal + H)
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


# (B, H, T, D, dtype, causal, merged route on): the flagship's head width
# at B*H 32, a ragged T, f32, a non-causal D 64, and the two-pass route
# (the flag off) at a ragged T across the head groups
DETERMINISM_CASES = [(4, 8, 2048, 128, torch.bfloat16, True, True),
                     (4, 8, 2000, 128, torch.bfloat16, True, True),
                     (4, 8, 2048, 128, torch.float32, True, True),
                     (2, 4, 1024, 64, torch.bfloat16, False, True),
                     (3, 8, 2000, 128, torch.bfloat16, True, False)]


@pytest.mark.parametrize('case', DETERMINISM_CASES,
                         ids=lambda c: '%d-%d-%d-%d-%s-%s-%s' % (
                             c[:4] + (str(c[4])[6:], c[5],
                                      'merged' if c[6] else 'two_pass')))
def test_flash_bwd_is_bit_reproducible(cuda, monkeypatch, case):
    """Two calls of the backward route on the same inputs give the same
    dq, dk and dv bit for bit: the merged kernel adds its dq partials in a
    fixed order, the two-pass kernels write each gradient once."""
    B, H, T, D, dtype, causal, merged = case
    monkeypatch.setattr(ck, '_MERGED_BWD', [merged])
    gen = torch.Generator(device=cuda)
    gen.manual_seed(T + D)
    q, k, v, do = (torch.randn(B, T, H, D, device=cuda, generator=gen)
                   .to(dtype) for _ in range(4))
    out, lse = ck.flash_attention_with_lse(q, k, v, causal)
    before = dict(ck.LAUNCHES)
    first = ck.flash_attention_bwd(q, k, v, out, lse, do, causal)
    second = ck.flash_attention_bwd(q, k, v, out, lse, do, causal)
    torch.cuda.synchronize()
    kernels = (['flash_attn_bwd_dkvdq'] if merged else
               ['flash_attn_bwd_dq', 'flash_attn_bwd_dkv'])
    assert {n: ck.LAUNCHES[n] - before[n] for n in ck.LAUNCHES
            if ck.LAUNCHES[n] != before[n]} == dict.fromkeys(kernels, 2)
    for name, a, b in zip(('dq', 'dk', 'dv'), first, second):
        assert torch.equal(a, b), name


def test_flash_bwd_counters_must_fit(cuda):
    """The merged kernel refuses a counter buffer that is not its own
    shape and dtype: its query tile decides where each counter lies."""
    q, k, v, do, lse, delta = _bwd_inputs(cuda, torch.bfloat16, 1, 256, 2,
                                          64, True, seed=2)
    good = ck.flash_bwd_counters(q)
    assert good.shape == (2, 4) and good.dtype == torch.int32
    for bad in (good[:, :3].contiguous(), good.long(),
                torch.zeros(2, 8, dtype=torch.int32, device=cuda)):
        with pytest.raises(ValueError):
            ck.flash_bwd_dkvdq(q, k, v, do, lse, delta, True, counters=bad)


@pytest.mark.parametrize('case', ['head_dim', 'dtype', 'strided',
                                  'misaligned', 'lse_dtype'])
def test_two_pass_kernels_refuse_what_they_do_not_take(cuda, case):
    """The dq and dk/dv wrappers raise, launching nothing, on what no
    kernel takes: a head dim other than 32, 64 or 128, half floats, a
    strided or misaligned input, an lse that is not f32."""
    D = 96 if case == 'head_dim' else 128
    dtype = torch.float16 if case == 'dtype' else torch.bfloat16
    q = torch.zeros(1, 256, 2, D, device=cuda, dtype=dtype)
    lse = torch.zeros(1, 2, 256, device=cuda)
    k = q
    if case == 'strided':
        k = torch.zeros(1, 256, 2, 2 * D, device=cuda, dtype=dtype)[..., :D]
    elif case == 'misaligned':
        k = torch.zeros(1 * 256 * 2 * D + 1, device=cuda,
                        dtype=dtype)[1:].view(1, 256, 2, D)
    elif case == 'lse_dtype':
        lse = lse.double()
    before = dict(ck.LAUNCHES)
    with pytest.raises((ValueError, TypeError)):
        ck.flash_bwd_dq(q, k, q, q, lse, lse)
    with pytest.raises((ValueError, TypeError)):
        ck.flash_bwd_dkv(q, k, q, q, lse, lse)
    assert ck.LAUNCHES == before


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
                           'fused_conv': 0, 'fused_conv_stats': 0,
                           'lstm_cell': 0}
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


# ---- the fused conv's stats form -------------------------------------------------
# y per element as CONV_TOL; each channel's sum within STATS_REL of the sum
# of |conv| over its pixels, its sum of squares within STATS_REL of itself:
# both sides sum the same products in f32 in another order, the bf16
# kernel on tensor cores (chip_smoke.py's STATS_REL)
STATS_REL = {torch.bfloat16: 3e-5, torch.float32: 2e-6}

# (N, H, W, Cin, Cout, K, stride, pad, depthwise): M = N * Ho * Wo rows; a
# partial last 64-row slot, Cout not a multiple of 64, 128-row tiles,
# depthwise
STATS_SHAPES = {
    'partial_tile_3x3': (3, 7, 7, 64, 64, 3, 1, 1, False),
    'cout_72_s2': (2, 15, 13, 32, 72, 1, 2, 0, False),
    'stem_7x7_cin3': (2, 32, 32, 3, 64, 7, 2, 3, False),
    '128_row_tiles': (16, 56, 56, 64, 136, 1, 1, 0, False),
    'depthwise_3x3_partial': (3, 7, 7, 40, 40, 3, 1, 1, True),
}


def _stats_ratios(x, w, strides, pads, depthwise, y, ssum, ssq):
    """(y err / CONV_TOL limit, sum err / limit, sumsq err / limit)."""
    conv, rs, rss = ck.fused_conv_reference(
        x.float(), w.float(), (), (), (), strides, pads, depthwise,
        emit_stats=True)
    abs_sum = conv.abs().sum((0, 1, 2))
    rel = STATS_REL[x.dtype]
    return (_err_ratio(y, conv.to(x.dtype)),
            ((ssum - rs).abs() / (rel * abs_sum)).max().item(),
            ((ssq - rss).abs() / (rel * rss)).max().item())


@pytest.mark.parametrize('dtype', [torch.bfloat16, torch.float32])
@pytest.mark.parametrize('shape', sorted(STATS_SHAPES))
def test_fused_conv_stats_form_matches_plain(cuda, dtype, shape):
    """The stats form against its plain version; the same slab without
    its last slot (a kernel that drops the last row tile's partial)
    fails the moments' limit where M is not a multiple of the slot (and
    always for the depthwise kernel, whose slot is a block)."""
    N, H, W, cin, cout, k, s, p, dw = STATS_SHAPES[shape]
    x, w, _, _, _, strides, pads, _ = _conv_case(
        cuda, dtype, N, H, W, cin, cout, k, s, p, dw, seed=len(shape))
    before = dict(ck.LAUNCHES)
    y, ssum, ssq = ck.fused_conv(x, w, (), (), (), strides, pads, dw,
                                 emit_stats=True)
    torch.cuda.synchronize()
    assert ck.LAUNCHES['fused_conv_stats'] == before['fused_conv_stats'] + 1
    assert ck.LAUNCHES['fused_conv'] == before['fused_conv']
    assert y.dtype == dtype and ssum.dtype == ssq.dtype == torch.float32
    assert max(_stats_ratios(x, w, strides, pads, dw, y, ssum, ssq)) <= 1
    _, slab = ck._fused_conv_launch(x, w, (), (), (), strides, pads, dw,
                                    emit_stats=True)
    M = y.shape[0] * y.shape[1] * y.shape[2]
    sms = ck._sm_count(x.device.index or 0)
    plan = ck.fused_conv_plan(dtype, N, H, W, cin, cout, k, k, strides,
                              pads, dw, sms, emit_stats=True)
    tile = ck.depthwise_tile(dtype, N, H, W, cin, k, k, strides, pads,
                             sms) if dw else None
    assert slab.shape == (2, ck.fused_conv_slots(plan, M, tile), y.shape[3])
    # the depthwise kernel's slot is a block, and every block has outputs
    if dw or M % ck.FUSED_CONV_STAT_ROWS:
        assert max(_stats_ratios(x, w, strides, pads, dw, y,
                                 slab[0, :-1].sum(0),
                                 slab[1, :-1].sum(0))[1:]) > 1


@pytest.mark.parametrize('dtype', [torch.bfloat16, torch.float32])
@pytest.mark.parametrize('shape', ['partial_tile_3x3',
                                   'depthwise_3x3_partial'])
def test_fused_conv_stats_function_backward_matches_plain_vjp(cuda, dtype,
                                                              shape):
    """The stats form under autograd (the kernel forward, the backward
    of fused_conv_stats_backward) against autograd of the plain version
    on the same inputs; the conv gradients run in x's dtype, so bf16 is
    held by relative L2, f32 per element."""
    N, H, W, cin, cout, k, s, p, dw = STATS_SHAPES[shape]
    x, w, _, _, _, strides, pads, _ = _conv_case(
        cuda, dtype, N, H, W, cin, cout, k, s, p, dw, seed=7)
    gen = torch.Generator(device=cuda)
    gen.manual_seed(8)
    grads = []
    for fn in (ck.fused_conv, ck.fused_conv_reference):
        xt, wt = x.clone().requires_grad_(), w.clone().requires_grad_()
        y, ssum, ssq = fn(xt, wt, (), (), (), strides, pads, dw,
                          emit_stats=True)
        if not grads:
            gy = torch.randn(y.shape, device=cuda, generator=gen).to(dtype)
            gs, gq = (torch.randn(y.shape[3], device=cuda, generator=gen)
                      for _ in range(2))
        f = (y.float() * gy.float()).sum() + (ssum * gs).sum() + \
            (ssq * gq).sum()
        grads.append(torch.autograd.grad(f, (xt, wt)))
    for got, ref in zip(*grads):
        got, ref = got.float(), ref.float()
        if dtype == torch.float32:
            assert (got - ref).abs().max().item() <= \
                1e-4 * ref.abs().max().item()
        else:
            assert (got - ref).norm().item() <= 2e-2 * ref.norm().item()


def test_resnet50_trains_on_the_stats_form(cuda):
    """One Momentum step of ResNet-50 at 32 x 32 on the card: 53
    stats-form launches, no other fused conv and no fallback; the loss is
    finite and every moving mean moves."""
    from paddle_tpu_torch.compiler import passes
    from paddle_tpu_torch.models.resnet import resnet_imagenet
    main, startup = pt.Program(), pt.Program()
    startup.random_seed = 1
    with pt.unique_name.guard(), pt.program_guard(main, startup):
        img = pt.layers.data(name='img', shape=[3, 32, 32], dtype='float32')
        label = pt.layers.data(name='label', shape=[1], dtype='int64')
        loss = pt.layers.mean(pt.layers.cross_entropy(
            resnet_imagenet(img, 10, depth=50), label))
        pt.optimizer.Momentum(learning_rate=0.01, momentum=0.9).minimize(
            loss)
    means = [op.output('MeanOut')[0] for op in main.global_block().ops
             if op.type == 'batch_norm']
    exe = pt.Executor()
    scope = pt.Scope()
    exe.run(startup, scope=scope)
    before = {n: scope.raw(n).clone() for n in means}
    gen = torch.Generator(device=cuda)
    gen.manual_seed(2)
    feed = {'img': torch.randn(4, 3, 32, 32, device=cuda, generator=gen),
            'label': torch.randint(0, 10, (4, 1), device=cuda,
                                   generator=gen)}
    passes.reset_fallback_counts()
    ck.reset_launch_counts()
    out, = exe.run(main, feed=feed, fetch_list=[loss], scope=scope)
    torch.cuda.synchronize()
    assert ck.LAUNCHES['fused_conv_stats'] == 53
    assert ck.LAUNCHES['fused_conv'] == 0
    assert passes.FALLBACKS == {}
    assert np.isfinite(out).all()
    for n in means:
        assert not torch.equal(scope.raw(n), before[n]), n



# ---- the depthwise kernel --------------------------------------------------------
# (N, H, W, C, K, stride, pad): C not a multiple of 8 channel quads or of
# a block's slice, H and W 7, 9 and 11, 5x5 at stride 2, M not a multiple
# of 64; C 6 (f32 and bf16) and 12 (bf16) stage the halo with scalar
# loads (a pixel's channels not a multiple of 16 bytes); C 1024 at 7x7
# widens a block's channels
DEPTHWISE_SHAPES = {
    'c24_9x9': (2, 9, 9, 24, 3, 1, 1),
    'c40_11x7': (3, 11, 7, 40, 3, 1, 1),
    'c40_7x7_s2': (3, 7, 7, 40, 3, 2, 1),
    'c24_11x11_5x5_s2': (2, 11, 11, 24, 5, 2, 2),
    'c40_9x11_5x5_s2': (2, 9, 11, 40, 5, 2, 2),
    'c6_9x11': (2, 9, 11, 6, 3, 1, 1),
    'c12_7x9_s2': (2, 7, 9, 12, 3, 2, 1),
    'c1024_7x7': (2, 7, 7, 1024, 3, 1, 1),
    'c64_30x30_pad0': (2, 30, 30, 64, 3, 1, 0),
}


def _depthwise_case(cuda, dtype, shape, seed=11):
    N, H, W, C, k, s, p = DEPTHWISE_SHAPES[shape]
    return _conv_case(cuda, dtype, N, H, W, C, C, k, s, p, True, seed)


@pytest.mark.parametrize('dtype', [torch.bfloat16, torch.float32])
@pytest.mark.parametrize('shape', sorted(DEPTHWISE_SHAPES))
def test_depthwise_kernel_matches_plain(cuda, dtype, shape):
    """The inference form (folded batch norm, relu) against its plain
    version, on the depthwise variant; two calls give the same bits."""
    case = _depthwise_case(cuda, dtype, shape)
    before = ck.FUSED_CONV_VARIANT_LAUNCHES['depthwise']
    _check_conv(case)
    x, w, aux, kinds, stages, strides, pads, dw = case
    again = ck.fused_conv(x, w, aux, kinds, stages, strides, pads, dw)
    torch.cuda.synchronize()
    assert ck.FUSED_CONV_VARIANT_LAUNCHES['depthwise'] == before + 3
    assert torch.equal(again, ck.fused_conv(x, w, aux, kinds, stages,
                                            strides, pads, dw))


@pytest.mark.parametrize('dtype', [torch.bfloat16, torch.float32])
@pytest.mark.parametrize('shape', sorted(DEPTHWISE_SHAPES))
def test_depthwise_kernel_stats_form_matches_plain(cuda, dtype, shape):
    """The stats form: y and the moments against the plain version; the
    slab has a slot a block and each slot holds its block's tiles' sums
    (depthwise_slab_reference), within the moments' limit of that slot;
    two calls give the same bits, slab included."""
    x, w, _, _, _, strides, pads, _ = _depthwise_case(cuda, dtype, shape)
    N, H, W, C = x.shape
    k = w.shape[0]
    y, slab = ck._fused_conv_launch(x, w, (), (), (), strides, pads, True,
                                    emit_stats=True)
    y2, slab2 = ck._fused_conv_launch(x, w, (), (), (), strides, pads, True,
                                      emit_stats=True)
    torch.cuda.synchronize()
    assert torch.equal(y, y2) and torch.equal(slab, slab2)
    assert max(_stats_ratios(x, w, strides, pads, True, y, slab[0].sum(0),
                             slab[1].sum(0))) <= 1
    tile = ck.depthwise_tile(dtype, N, H, W, C, k, k, strides, pads,
                             ck._sm_count(x.device.index or 0))
    assert slab.shape == (2, tile.blocks, C)
    conv = ck.fused_conv_reference(x.float(), w.float(), (), (), (),
                                   strides, pads, True)
    ref = ck.depthwise_slab_reference(conv, tile)
    size = ck.depthwise_slab_reference(conv.abs(), tile)
    rel = STATS_REL[dtype]
    assert ((slab[0] - ref[0]).abs() <= rel * size[0] + 1e-30).all()
    assert ((slab[1] - ref[1]).abs() <= rel * ref[1] + 1e-30).all()
    # a slab whose slots are summed one block off fails that check
    assert tile.blocks > 1
    assert not ((slab[0].roll(1, 0) - ref[0]).abs() <=
                rel * size[0] + 1e-30).all()


@pytest.mark.parametrize('dtype', [torch.bfloat16, torch.float32])
@pytest.mark.parametrize('epi', sorted(EPILOGUES))
@pytest.mark.parametrize('C', [6, 24])
def test_depthwise_kernel_epilogue_kinds(cuda, dtype, epi, C):
    """Each aux kind on the depthwise kernel, with C a multiple of 4
    channels (vector loads and stores) and not (one at a time)."""
    stages, extra = EPILOGUES[epi]
    _check_conv(_conv_case(cuda, dtype, 2, 9, 11, C, C, 3, 2, 1, True, 5,
                           stages=stages, extra_aux=extra))

# ---- the wgmma conv kernel at ResNet-50's shapes ---------------------------------
# ResNet-50's distinct region shapes (H, W, Cin, Cout, K, stride, pad)
# (tests/test_torch_conv_plan.py holds them against the program)
RESNET50_SHAPES = [
    (224, 224, 3, 64, 7, 2, 3), (56, 56, 64, 64, 1, 1, 0),
    (56, 56, 64, 64, 3, 1, 1), (56, 56, 64, 256, 1, 1, 0),
    (56, 56, 256, 64, 1, 1, 0), (56, 56, 256, 128, 1, 2, 0),
    (56, 56, 256, 512, 1, 2, 0), (28, 28, 128, 128, 3, 1, 1),
    (28, 28, 128, 512, 1, 1, 0), (28, 28, 512, 128, 1, 1, 0),
    (28, 28, 512, 256, 1, 2, 0), (28, 28, 512, 1024, 1, 2, 0),
    (14, 14, 256, 256, 3, 1, 1), (14, 14, 256, 1024, 1, 1, 0),
    (14, 14, 1024, 256, 1, 1, 0), (14, 14, 1024, 512, 1, 2, 0),
    (14, 14, 1024, 2048, 1, 2, 0), (7, 7, 512, 512, 3, 1, 1),
    (7, 7, 512, 2048, 1, 1, 0), (7, 7, 2048, 512, 1, 1, 0)]
# a block's last conv: the folded batch norm, the residual, relu
RESIDUAL = (('affine', 0, 1), ('bin', 'elementwise_add', 2, False),
            ('act', 'relu'))


def _planned(x, w, strides, pads, splits):
    """The plan the wrapper would pick, or it with ``splits`` forced."""
    N, H, W, cin = x.shape
    plan = ck.fused_conv_plan(x.dtype, N, H, W, cin, w.shape[0], w.shape[1],
                              w.shape[2], strides, pads, False,
                              ck._sm_count(x.device.index or 0))
    return plan if splits is None else plan._replace(splits=splits)


@pytest.mark.parametrize('splits', [None, 1], ids=['plan', 'splits1'])
@pytest.mark.parametrize('N', [1, 32])
@pytest.mark.parametrize('shape', RESNET50_SHAPES,
                         ids=['%dx%d_%d_%d_k%ds%d' % s[:6]
                              for s in RESNET50_SHAPES])
def test_fused_conv_at_resnet50_shapes(cuda, shape, N, splits):
    """Both forms at every region shape, through the plan's K splits and
    through one: the inference form with the residual epilogue per
    element (CONV_TOL), the stats form's y per element and its moments
    per channel (STATS_REL); each twice, bit for bit."""
    H, W, cin, cout, k, s, p = shape
    x, w, aux, kinds, _, strides, pads, _ = _conv_case(
        cuda, torch.bfloat16, N, H, W, cin, cout, k, s, p, False, seed=N + k,
        extra_aux=('t',))
    plan = _planned(x, w, strides, pads, splits)
    assert plan.variant == ('stem' if cin == 3 else 'wgmma')
    args = (x, w, aux, kinds, RESIDUAL, strides, pads, False)
    got = ck._fused_conv_launch(*args, plan=plan)
    again = ck._fused_conv_launch(*args, plan=plan)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    assert _err_ratio(got, ck.fused_conv_reference(*args)) <= 1
    y, slab = ck._fused_conv_launch(x, w, (), (), (), strides, pads, False,
                                    emit_stats=True, plan=plan)
    y2, slab2 = ck._fused_conv_launch(x, w, (), (), (), strides, pads, False,
                                      emit_stats=True, plan=plan)
    torch.cuda.synchronize()
    assert torch.equal(y, y2) and torch.equal(slab, slab2)
    assert max(_stats_ratios(x, w, strides, pads, False, y,
                             slab[0].sum(0), slab[1].sum(0))) <= 1


@pytest.mark.parametrize('case', [
    # (N, H, W, Cin, Cout, K, stride, pad): Cout 64 (one 64-wide tile);
    # M < 64 (one consumer's rows); M < 64 with K split; a ragged tile
    (4, 14, 14, 64, 64, 3, 1, 1), (1, 5, 7, 64, 64, 3, 1, 1),
    (1, 5, 7, 512, 64, 3, 1, 1), (3, 9, 11, 128, 72, 3, 2, 1)])
def test_fused_conv_small_tiles(cuda, case):
    N, H, W, cin, cout, k, s, p = case
    for splits in (None, 1, 2):
        x, w, aux, kinds, _, strides, pads, _ = _conv_case(
            cuda, torch.bfloat16, N, H, W, cin, cout, k, s, p, False, seed=3,
            extra_aux=('t',))
        plan = _planned(x, w, strides, pads, splits)
        assert plan.variant == 'wgmma'
        args = (x, w, aux, kinds, RESIDUAL, strides, pads, False)
        got = ck._fused_conv_launch(*args, plan=plan)
        torch.cuda.synchronize()
        assert _err_ratio(got, ck.fused_conv_reference(*args)) <= 1
        y, slab = ck._fused_conv_launch(x, w, (), (), (), strides, pads,
                                        False, emit_stats=True, plan=plan)
        torch.cuda.synchronize()
        assert max(_stats_ratios(x, w, strides, pads, False, y,
                                 slab[0].sum(0), slab[1].sum(0))) <= 1


def test_fused_conv_refuses_a_plan_it_cannot_take(cuda):
    """A wgmma plan for operands the kernel does not take raises; no
    fallback."""
    x, w, aux, kinds, stages, strides, pads, _ = _conv_case(
        cuda, torch.bfloat16, 2, 8, 8, 32, 64, 3, 1, 1, False, seed=1)
    bad = [ck.FusedConvPlan('wgmma', 64, 1),      # Cin 32
           ck.FusedConvPlan('depthwise', 0, 1),   # not depthwise
           ck.FusedConvPlan('tf32', 64, 1),       # bf16
           ck.FusedConvPlan('mma_sync', 96, 1),   # no such width
           ck.FusedConvPlan('mma_sync', 20, 1),   # not a multiple of 8
           ck.FusedConvPlan('mma_sync', 64, 3)]   # 3 warps cannot share K
    for plan in bad:
        with pytest.raises(RuntimeError, match='CUDA error'):
            ck._fused_conv_launch(x, w, aux, kinds, stages, strides, pads,
                                  False, plan=plan)
    x, w, aux, kinds, stages, strides, pads, _ = _conv_case(
        cuda, torch.float32, 2, 8, 8, 32, 64, 3, 1, 1, False, seed=1)
    for plan in (ck.FusedConvPlan('mma_sync', 64, 1),   # f32
                 ck.FusedConvPlan('depthwise', 0, 1),   # not depthwise
                 ck.FusedConvPlan('tf32', 24, 1)):      # no such f32 width
        with pytest.raises(RuntimeError, match='CUDA error'):
            ck._fused_conv_launch(x, w, aux, kinds, stages, strides, pads,
                                  False, plan=plan)
    # the stats form keeps whole 64-row slots: a 16-row tile is refused
    with pytest.raises(RuntimeError, match='CUDA error'):
        ck._fused_conv_launch(x, w, (), (), (), strides, pads, False,
                              emit_stats=True,
                              plan=ck.FusedConvPlan('tf32', 64, 4))
    x, w, aux, kinds, stages, strides, pads, _ = _conv_case(
        cuda, torch.bfloat16, 2, 8, 8, 64, 64, 3, 1, 1, False, seed=1)
    for plan in (ck.FusedConvPlan('wgmma', 96, 1),     # no such width
                 ck.FusedConvPlan('wgmma', 64, 0),      # no split
                 ck.FusedConvPlan('wgmma', 64, 10)):    # 9 chunks, 10 splits
        with pytest.raises(RuntimeError, match='CUDA error'):
            ck._fused_conv_launch(x, w, aux, kinds, stages, strides, pads,
                                  False, plan=plan)
    # 81 taps: more than the arguments carry
    x, w, aux, kinds, stages, strides, pads, _ = _conv_case(
        cuda, torch.bfloat16, 1, 12, 12, 64, 64, 9, 1, 4, False, seed=1)
    assert _planned(x, w, strides, pads, None).variant == 'mma_sync'
    with pytest.raises(RuntimeError, match='CUDA error'):
        ck._fused_conv_launch(x, w, aux, kinds, stages, strides, pads, False,
                              plan=ck.FusedConvPlan('wgmma', 64, 1))


# the tf32 and mma_sync kernels at the books' and benchmark models' region
# shapes (N, H, W, Cin, Cout, K, stride, pad), small batches: mnist's two
# convs (Cin 1 and 20: staged input rows), ResNet-32's (Cin 3 staged; 16,
# 32 and 64 through the cp.async ring; the 1x1 projection), VGG-16's first
# and last, and a ragged one; every tile width's instance is reached
MMA_SHAPES = {
    'mnist_conv1': (4, 28, 28, 1, 20, 5, 1, 0),
    'mnist_conv2': (8, 12, 12, 20, 50, 5, 1, 0),
    'resnet32_conv1': (2, 32, 32, 3, 16, 3, 1, 1),
    'resnet32_16': (2, 32, 32, 16, 16, 3, 1, 1),
    'resnet32_16_32_s2': (2, 32, 32, 16, 32, 3, 2, 1),
    'resnet32_proj_32_64': (2, 16, 16, 32, 64, 1, 2, 0),
    'resnet32_64': (4, 8, 8, 64, 64, 3, 1, 1),
    'vgg_conv1': (2, 32, 32, 3, 64, 3, 1, 1),
    'vgg_512': (4, 2, 2, 512, 512, 3, 1, 1),
    'ragged_cout_44': (3, 9, 11, 24, 44, 3, 2, 1),
    'cout_8_cin_5': (2, 9, 9, 5, 8, 3, 1, 1),
    'cout_40_cin_8': (2, 9, 9, 8, 40, 3, 1, 1),
}
# f32: the kernel's max |err| against the plain version in f64 at most
# this many times the plain f32 version's (chip_smoke.py's witness)
F64_WITNESS = 2.0


def _max_err_f64(got, x, w, aux, kinds, stages, strides, pads):
    """max |got - the conv and its stages in f64|."""
    ref = torch.nn.functional.conv2d(
        x.double().permute(0, 3, 1, 2), w.double().permute(0, 3, 1, 2),
        stride=strides, padding=pads).permute(0, 2, 3, 1)
    fetch = ck.aux_fetcher(aux, kinds)
    for st in stages:
        ref = ck.apply_stage(ref, st, lambda i: fetch(i).double())
    return (got.double() - ref).abs().max().item()


@pytest.mark.parametrize('splits', [1, 2, 4])
@pytest.mark.parametrize('dtype', [torch.bfloat16, torch.float32])
@pytest.mark.parametrize('shape', sorted(MMA_SHAPES))
def test_fused_conv_mma_routes(cuda, shape, dtype, splits):
    """The tf32 (f32) or mma_sync (bf16) kernel at its tile width for
    Cout, K shared by 1, 2 or 4 warps, forced where the plan would take
    the stem or wgmma: the residual epilogue per element (CONV_TOL) and
    twice bit for bit; f32 within F64_WITNESS times the plain f32
    version's error against f64; the stats form (whole 64-row slots, K
    shared by 1 or 2 sets of 4 warps: y, moments, twice bit for bit),
    refused at 4."""
    x, w, aux, kinds, _, strides, pads, _ = _conv_case(
        cuda, dtype, *MMA_SHAPES[shape], False, seed=len(shape) + splits,
        extra_aux=('t',))
    plan = ck.FusedConvPlan('tf32' if dtype == torch.float32 else
                            'mma_sync', ck.mma_tile_width(dtype, w.shape[0]),
                            splits)
    args = (x, w, aux, kinds, RESIDUAL, strides, pads, False)
    got = ck._fused_conv_launch(*args, plan=plan)
    again = ck._fused_conv_launch(*args, plan=plan)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    ref = ck.fused_conv_reference(*args)
    assert _err_ratio(got, ref) <= 1
    if dtype == torch.float32:
        assert _max_err_f64(got, *args[:7]) <= F64_WITNESS * \
            _max_err_f64(ref, *args[:7])
    stats = lambda: ck._fused_conv_launch(  # noqa: E731
        x, w, (), (), (), strides, pads, False, emit_stats=True, plan=plan)
    if splits > 2:
        with pytest.raises(RuntimeError, match='CUDA error'):
            stats()
        return
    (y, slab), (y2, slab2) = stats(), stats()
    torch.cuda.synchronize()
    assert torch.equal(y, y2) and torch.equal(slab, slab2)
    if dtype == torch.bfloat16:
        assert max(_stats_ratios(x, w, strides, pads, False, y,
                                 slab[0].sum(0), slab[1].sum(0))) <= 1
        return
    # f32: y within F64_WITNESS times the plain version's error against
    # f64, the moments within STATS_REL of the f64 ones (at 16 rows the
    # plain conv's own error can take its moments past that limit)
    plain = ck.fused_conv_reference(x, w, (), (), (), strides, pads, False)
    conv = torch.nn.functional.conv2d(
        x.double().permute(0, 3, 1, 2), w.double().permute(0, 3, 1, 2),
        stride=strides, padding=pads).permute(0, 2, 3, 1)
    assert (y.double() - conv).abs().max() <= F64_WITNESS * \
        (plain.double() - conv).abs().max()
    rel = STATS_REL[dtype]
    for got, want, scale in (
            (slab[0].sum(0), conv.sum((0, 1, 2)), conv.abs().sum((0, 1, 2))),
            (slab[1].sum(0), conv.square().sum((0, 1, 2)),
             conv.square().sum((0, 1, 2)))):
        assert ((got.double() - want).abs() / (rel * scale)).max() <= 1


def test_fused_conv_split_k_counters_return_to_zero(cuda):
    """Each output tile's last turn puts its counter back to 0, so the
    next launch on the stream finds them all at 0."""
    x, w, aux, kinds, _, strides, pads, _ = _conv_case(
        cuda, torch.bfloat16, 1, 7, 7, 512, 512, 3, 1, 1, False, seed=5)
    plan = _planned(x, w, strides, pads, None)
    assert plan.splits > 1
    stages = (('affine', 0, 1), ('act', 'relu'))
    first = ck._fused_conv_launch(x, w, aux, kinds, stages, strides, pads,
                                  False)
    for _ in range(3):
        assert torch.equal(ck._fused_conv_launch(
            x, w, aux, kinds, stages, strides, pads, False), first)
    torch.cuda.synchronize()
    counters = ck._SPLIT_COUNTERS[(x.device, torch.cuda.current_stream(
        x.device).cuda_stream)]
    assert not counters.any()


# ---- the fused LSTM cell ------------------------------------------------------------
# kernel vs the plain version on the same inputs, per element: |err| <= rel
# * |plain| + abs * rms(plain), (rel, abs) per dtype of h. f32: the same f32
# sums in another order, then the same gate math; bf16 (r_prev and w bf16,
# h written in bf16): exact products, f32 sums in another order, then one
# bf16 rounding of h, which may differ by one step (2**-8 relative).
LSTM_TOL = {torch.float32: (1e-5, 1e-5), torch.bfloat16: (2 ** -7, 2 ** -8)}
# (B, H): the sequence path's shape, a single row, H past the tile and not
# a multiple of it
LSTM_SHAPES = [(256, 512), (1, 512), (64, 256), (7, 1000), (3, 37)]


def _lstm_operands(cuda, B, H, dot_dtype, seed):
    gen = torch.Generator(device=cuda)
    gen.manual_seed(seed)
    xg = torch.randn(B, 4 * H, device=cuda, generator=gen)
    r = torch.tanh(torch.randn(B, H, device=cuda, generator=gen))
    c = torch.randn(B, H, device=cuda, generator=gen)
    w = torch.randn(H, 4 * H, device=cuda, generator=gen) / H ** 0.5
    return xg, r.to(dot_dtype), c, w.to(dot_dtype)


def _lstm_ratio(got, ref):
    rel, abs_ = LSTM_TOL[got.dtype]
    ref = ref.float()
    bound = rel * ref.abs() + abs_ * ref.pow(2).mean().sqrt()
    return ((got.float() - ref).abs() / bound).max().item()


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('shape', LSTM_SHAPES)
def test_lstm_cell_kernel_matches_plain(cuda, dtype, shape):
    B, H = shape
    ops = _lstm_operands(cuda, B, H, dtype, seed=B * 7 + H)
    before = ck.LAUNCHES['lstm_cell']
    h, c = ck.fused_lstm_cell(*ops)
    torch.cuda.synchronize()
    assert ck.LAUNCHES['lstm_cell'] == before + 1
    assert h.dtype == dtype and c.dtype == torch.float32
    ref_h, ref_c = ck.lstm_cell_reference(*ops)
    assert _lstm_ratio(h, ref_h) <= 1 and _lstm_ratio(c, ref_c) <= 1


# (B, H): every batch tile the launcher picks (8 to 64 rows a block, B
# past and short of it) at H 256, 512 and 1000 (not a multiple of the
# 16-unit tile)
LSTM_WIDTHS = [(B, H) for B in (1, 7, 32, 64, 256) for H in (256, 512, 1000)]


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('shape', LSTM_WIDTHS)
def test_lstm_cell_kernel_at_every_width(cuda, dtype, shape):
    """Both dtypes against the plain version; two calls give the same
    bits (no K split, no atomics)."""
    B, H = shape
    ops = _lstm_operands(cuda, B, H, dtype, seed=B + H)
    h, c = ck.fused_lstm_cell(*ops)
    h2, c2 = ck.fused_lstm_cell(*ops)
    torch.cuda.synchronize()
    ref_h, ref_c = ck.lstm_cell_reference(*ops)
    assert _lstm_ratio(h, ref_h) <= 1 and _lstm_ratio(c, ref_c) <= 1
    assert torch.equal(h, h2) and torch.equal(c, c2)


def _product_probe(r, w):
    """chip_smoke._product_probe: inputs under which the cell returns its
    recurrent product, per gate's slice of w, and that product in f64."""
    import importlib.util
    import os
    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), 'chip_smoke.py')
    spec = importlib.util.spec_from_file_location('chip_smoke', path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod._product_probe(r, w)


@pytest.mark.parametrize('seed', [0, 1])
@pytest.mark.parametrize('shape', [(256, 512), (1, 512), (32, 512),
                                   (64, 256), (7, 1000), (3, 37)])
def test_lstm_cell_f32_keeps_f32_accuracy(cuda, shape, seed):
    """The three TF32 products, as in chip_smoke.py phase 13: the
    kernel's max |err| against the plain cell in f64 is at most twice the
    plain f32 version's, and so is its product's alone against the
    product in f64 (read through saturated gates)."""
    B, H = shape
    ops = _lstm_operands(cuda, B, H, torch.float32, seed=11 * B + H + seed)
    witness = ck.lstm_cell_reference(*(t.double() for t in ops))

    def err(pair):
        return max((a.double() - b).abs().max().item()
                   for a, b in zip(pair, witness))
    assert err(ck.fused_lstm_cell(*ops)) <= 2 * err(
        ck.lstm_cell_reference(*ops))
    xg, c0, ws, exact = _product_probe(ops[1], ops[3])
    for wq, want in zip(ws, exact):
        k_err, p_err = [
            (cell(xg, ops[1], c0, wq)[1].double() - want).abs().max().item()
            for cell in (ck.fused_lstm_cell, ck.lstm_cell_reference)]
        assert k_err <= 2 * p_err


def test_lstm_cell_takes_a_time_step_of_a_sequence(cuda):
    """xg as the scan passes it: step t of [B, T, 4H], a row-strided
    view; the same result as from a contiguous copy."""
    B, T, H = 16, 5, 64
    gen = torch.Generator(device=cuda)
    gen.manual_seed(3)
    x = torch.randn(B, T, 4 * H, device=cuda, generator=gen)
    _, r, c, w = _lstm_operands(cuda, B, H, torch.float32, seed=4)
    step = x.transpose(0, 1)[2]
    assert not step.is_contiguous()
    for a, b in zip(ck.fused_lstm_cell(step, r, c, w),
                    ck.fused_lstm_cell(step.contiguous(), r, c, w)):
        assert torch.equal(a, b)


def test_lstm_cell_promotes_mixed_dtypes(cuda):
    """r_prev bf16 with an f32 weight: the product in f32, as the Pallas
    kernel's dot_general promotes; h in r_prev's dtype, c in c_prev's."""
    xg, r, c, w = _lstm_operands(cuda, 32, 96, torch.float32, seed=5)
    h, c_out = ck.fused_lstm_cell(xg, r.bfloat16(), c.bfloat16(), w)
    assert h.dtype == torch.bfloat16 and c_out.dtype == torch.bfloat16
    ref_h, ref_c = ck.lstm_cell_reference(xg, r.bfloat16(), c.bfloat16(), w)
    assert _lstm_ratio(h, ref_h) <= 1 and _lstm_ratio(c_out, ref_c) <= 1


def test_lstm_cell_refuses_what_it_does_not_take(cuda):
    xg, r, c, w = _lstm_operands(cuda, 4, 8, torch.float32, seed=6)
    before = ck.LAUNCHES['lstm_cell']
    with pytest.raises(TypeError):
        ck.fused_lstm_cell(xg.double(), r, c, w)
    with pytest.raises(ValueError):
        ck.fused_lstm_cell(xg[:, :-1], r, c, w)
    assert ck.LAUNCHES['lstm_cell'] == before


def test_lstm_cell_function_backward_on_the_card(cuda):
    """_FusedLSTMCell on the kernel: its gradients against autograd of the
    plain version on the same inputs (f32, sums in another order)."""
    ops = _lstm_operands(cuda, 64, 256, torch.float32, seed=7)
    gen = torch.Generator(device=cuda)
    gen.manual_seed(8)
    g_h, g_c = (torch.randn(64, 256, device=cuda, generator=gen)
                for _ in range(2))
    leaves = [t.clone().requires_grad_() for t in ops]
    got = torch.autograd.grad(ck.fused_lstm_cell(*leaves), leaves,
                              (g_h, g_c))
    plain = [t.clone().requires_grad_() for t in ops]
    want = torch.autograd.grad(ck.lstm_cell_reference(*plain), plain,
                               (g_h, g_c))
    for a, b in zip(got, want):
        assert ((a - b).abs().max() / b.abs().max()).item() < 1e-5


def _small_stacked_lstm():
    main, startup = pt.Program(), pt.Program()
    startup.random_seed = 1
    with pt.unique_name.guard(), pt.program_guard(main, startup):
        data = pt.layers.data(name='data', shape=[1], dtype='int64',
                              lod_level=1)
        label = pt.layers.data(name='label', shape=[1], dtype='int64')
        h = pt.layers.embedding(data, size=[50, 16])
        for _ in range(2):
            h, _ = pt.layers.dynamic_lstm(pt.layers.fc(h, size=4 * 32),
                                          size=4 * 32, use_peepholes=False)
        pred = pt.layers.fc(pt.layers.sequence_pool(h, 'max'), size=2,
                            act='softmax')
        loss = pt.layers.mean(pt.layers.cross_entropy(pred, label))
        pt.optimizer.Momentum(learning_rate=0.01, momentum=0.9).minimize(
            loss)
    return main, startup, loss


def _small_lstm_feed(lens, seed):
    rng = np.random.RandomState(seed)
    return {'data': pt.create_lod_tensor(
        rng.randint(0, 50, (sum(lens), 1)).astype('int64'), [lens]),
        'label': rng.randint(0, 2, (len(lens), 1)).astype('int64')}


def test_stacked_lstm_two_momentum_steps_on_the_kernel(cuda):
    """Two Momentum steps with AMP off: the kernel's losses and updated
    weights against the plain cell's, to the f32 limit of chip_smoke.py
    (1e-5); the second step runs on weights the first one changed."""
    from paddle_tpu_torch.core import amp
    from paddle_tpu_torch.ops import rnn_ops
    main, startup, loss = _small_stacked_lstm()
    runs = []
    amp.set_amp(False)
    try:
        for plain in (False, True):
            exe = pt.Executor()
            scope = pt.Scope()
            exe.run(startup, scope=scope)
            ck.reset_launch_counts()
            with rnn_ops.lstm_cell_for_testing() if plain else \
                    contextlib.nullcontext():
                losses = [float(exe.run(
                    main, feed=_small_lstm_feed([9, 1, 14, 3], s),
                    fetch_list=[loss], scope=scope)[0][0]) for s in (0, 1)]
            torch.cuda.synchronize()
            assert ck.LAUNCHES['lstm_cell'] == (0 if plain else 2 * 2 * 16)
            runs.append((losses, {n: scope.raw(n).detach().cpu().clone()
                                  for n in main.global_block().vars
                                  if n.startswith('lstm') and
                                  n.endswith('w_0')}))
    finally:
        amp.set_amp(None)
    (k_losses, k_w), (p_losses, p_w) = runs
    assert k_w and set(k_w) == set(p_w)
    for a, b in zip(k_losses, p_losses):
        assert abs(a - b) <= 1e-5 * abs(b), (k_losses, p_losses)
    for name in k_w:
        err = (k_w[name] - p_w[name]).norm() / p_w[name].norm()
        assert err.item() <= 1e-5, name


def test_stacked_lstm_trains_on_the_kernel(cuda):
    """A small stacked LSTM without peepholes on the card: one kernel
    launch per layer and padded step, and the loss of the plain cell."""
    from paddle_tpu_torch.ops import rnn_ops
    main, startup, loss = _small_stacked_lstm()
    lens = [9, 1, 14, 3]
    rng = np.random.RandomState(0)
    feed = {'data': pt.create_lod_tensor(
        rng.randint(0, 50, (sum(lens), 1)).astype('int64'), [lens]),
        'label': rng.randint(0, 2, (4, 1)).astype('int64')}
    losses = []
    for plain in (False, True):
        exe = pt.Executor()
        scope = pt.Scope()
        exe.run(startup, scope=scope)
        ck.reset_launch_counts()
        with rnn_ops.lstm_cell_for_testing() if plain else \
                contextlib.nullcontext():
            out, = exe.run(main, feed=feed, fetch_list=[loss], scope=scope)
        torch.cuda.synchronize()
        assert ck.LAUNCHES['lstm_cell'] == (0 if plain else 2 * 16)
        losses.append(float(out[0]))
    assert np.isfinite(losses).all()
    assert abs(losses[0] - losses[1]) < 1e-3, losses
