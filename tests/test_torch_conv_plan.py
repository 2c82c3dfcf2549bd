"""The fused conv kernel's host plan, on the CPU: the variant and tiling
``cuda_kernels.fused_conv_plan`` picks at every ResNet-50 region shape
and at the boundaries, the TMA im2col load's parameters as the kernel
receives them (``cuda_kernels.fused_conv_im2col`` in the encoded launch
arguments; the load emulated in torch by ``im2col_load_reference`` and
held against ``F.unfold``), and the split-K workspace. The kernel itself
runs only on the card (tests/test_torch_cuda_kernels.py)."""
import numpy as np
import pytest
import torch
import torch.nn.functional as F

import paddle_tpu_torch as pt
from paddle_tpu_torch.ops import cuda_kernels as ck

SMS = 132  # an H100's SMs

# ResNet-50's distinct region shapes (H, W, Cin, Cout, K, stride, pad),
# each with its count of regions, as conv_epilogue_fuse forms them from
# models.resnet.resnet_imagenet at 224 x 224 (checked against the
# program below)
RESNET50_REGIONS = {
    (224, 224, 3, 64, 7, 2, 3): 1,
    (56, 56, 64, 64, 1, 1, 0): 1,
    (56, 56, 64, 64, 3, 1, 1): 3,
    (56, 56, 64, 256, 1, 1, 0): 4,
    (56, 56, 256, 64, 1, 1, 0): 2,
    (56, 56, 256, 128, 1, 2, 0): 1,
    (56, 56, 256, 512, 1, 2, 0): 1,
    (28, 28, 128, 128, 3, 1, 1): 4,
    (28, 28, 128, 512, 1, 1, 0): 4,
    (28, 28, 512, 128, 1, 1, 0): 3,
    (28, 28, 512, 256, 1, 2, 0): 1,
    (28, 28, 512, 1024, 1, 2, 0): 1,
    (14, 14, 256, 256, 3, 1, 1): 6,
    (14, 14, 256, 1024, 1, 1, 0): 6,
    (14, 14, 1024, 256, 1, 1, 0): 5,
    (14, 14, 1024, 512, 1, 2, 0): 1,
    (14, 14, 1024, 2048, 1, 2, 0): 1,
    (7, 7, 512, 512, 3, 1, 1): 3,
    (7, 7, 512, 2048, 1, 1, 0): 3,
    (7, 7, 2048, 512, 1, 1, 0): 2,
}
# the plan's (bn, splits) at batch 1, 8, 32 and 128 at each region shape
# (the stem takes its own kernel). Stated values: the rule was fitted to
# `chip_smoke.py --sweep-conv` at these shapes on an H100 (PERF.md, PR 7)
PLAN_BATCHES = (1, 8, 32, 128)
RESNET50_PLANS = {
    (224, 224, 3, 64, 7, 2, 3): 'stem',
    (56, 56, 64, 64, 1, 1, 0): [(64, 1), (64, 1), (64, 1), (64, 1)],
    (56, 56, 64, 64, 3, 1, 1): [(64, 1), (64, 1), (64, 1), (64, 1)],
    (56, 56, 64, 256, 1, 1, 0): [(64, 1), (256, 1), (256, 1), (256, 1)],
    (56, 56, 256, 64, 1, 1, 0): [(64, 1), (64, 1), (64, 1), (64, 1)],
    (56, 56, 256, 128, 1, 2, 0): [(64, 1), (64, 1), (128, 1), (128, 1)],
    (56, 56, 256, 512, 1, 2, 0): [(64, 1), (256, 1), (256, 1), (256, 1)],
    (28, 28, 128, 128, 3, 1, 1): [(64, 1), (64, 1), (128, 1), (128, 1)],
    (28, 28, 128, 512, 1, 1, 0): [(64, 1), (256, 1), (256, 1), (256, 1)],
    (28, 28, 512, 128, 1, 1, 0): [(64, 1), (64, 1), (128, 1), (128, 1)],
    (28, 28, 512, 256, 1, 2, 0): [(64, 1), (64, 1), (128, 1), (256, 1)],
    (28, 28, 512, 1024, 1, 2, 0): [(64, 1), (128, 1), (256, 1), (256, 1)],
    (14, 14, 256, 256, 3, 1, 1): [(64, 3), (64, 2), (128, 1), (256, 1)],
    (14, 14, 256, 1024, 1, 1, 0): [(64, 1), (128, 1), (256, 1), (256, 1)],
    (14, 14, 1024, 256, 1, 1, 0): [(64, 1), (64, 1), (128, 1), (256, 1)],
    (14, 14, 1024, 512, 1, 2, 0): [(64, 1), (64, 1), (64, 1), (256, 1)],
    (14, 14, 1024, 2048, 1, 2, 0): [(64, 1), (64, 1), (256, 1), (256, 1)],
    (7, 7, 512, 512, 3, 1, 1): [(64, 4), (64, 4), (64, 1), (256, 1)],
    (7, 7, 512, 2048, 1, 1, 0): [(64, 1), (64, 1), (256, 1), (256, 1)],
    (7, 7, 2048, 512, 1, 1, 0): [(64, 2), (64, 2), (64, 1), (256, 1)],
}


def test_region_table_is_resnet50s():
    from paddle_tpu_torch.models.resnet import resnet_imagenet
    main, startup = pt.Program(), pt.Program()
    with pt.unique_name.guard(), pt.program_guard(main, startup):
        img = pt.layers.data(name='img', shape=[3, 224, 224],
                             dtype='float32')
        prob = resnet_imagenet(img, 1000, depth=50, is_test=True)
    opt, _ = pt.compiler.optimize(main.prune([prob]),
                                  fetch_names=[prob.name])
    block = opt.global_block()
    regions = {}
    for op in block.ops:
        if op.type != 'fused_conv':
            continue
        _, ins, _, attrs = op.attrs['sub_ops'][0]
        _, cin, h, w = block.var(ins['Input'][0]).shape
        cout, _, k, _ = block.var(ins['Filter'][0]).shape
        key = (h, w, cin, cout, k, attrs['strides'][0], attrs['paddings'][0])
        regions[key] = regions.get(key, 0) + 1
    assert regions == RESNET50_REGIONS
    assert sum(regions.values()) == 53


def _plan(N, key, dtype=torch.bfloat16, depthwise=False, sms=SMS):
    H, W, cin, cout, k, s, p = key
    return ck.fused_conv_plan(dtype, N, H, W, cin, cout, k, k, (s, s),
                              (p, p), depthwise, sms)


def _out_rows(N, key):
    H, W, _, _, k, s, p = key
    return N * ((H + 2 * p - k) // s + 1) * ((W + 2 * p - k) // s + 1)


def test_plan_table_covers_the_regions():
    assert sorted(RESNET50_PLANS) == sorted(RESNET50_REGIONS)


@pytest.mark.parametrize('N', PLAN_BATCHES)
@pytest.mark.parametrize('key', sorted(RESNET50_REGIONS))
def test_plan_at_every_resnet50_region(N, key):
    """Every region but the stem takes the wgmma kernel at the stated
    (bn, splits); split K never takes more blocks than a wave, and at the
    training batch one tile covers Cout up to 256."""
    H, W, cin, cout, k, s, p = key
    plan = _plan(N, key)
    want = RESNET50_PLANS[key]
    if want == 'stem':
        assert plan == ck.FusedConvPlan('stem', 0, 1)
        return
    assert plan == ck.FusedConvPlan('wgmma',
                                    *want[PLAN_BATCHES.index(N)])
    tiles = -(-_out_rows(N, key) // 128) * -(-cout // plan.bn)
    assert plan.splits == 1 or plan.splits * tiles <= SMS
    if N == 128:
        assert plan.bn == min(256, cout)


def test_plan_splits_the_small_m_convs():
    # batch 32, 7x7 stage: 13 row tiles of 128; Cout 512 in 64-wide tiles
    # gives 104 (128-wide: 52, short of half a wave); no split
    assert _plan(32, (7, 7, 512, 512, 3, 1, 1)) == ck.FusedConvPlan(
        'wgmma', 64, 1)
    # 1x1 to 2048: 13 x 8 tiles of 256 is most of a wave
    assert _plan(32, (7, 7, 512, 2048, 1, 1, 0)) == ck.FusedConvPlan(
        'wgmma', 256, 1)
    # batch 1: one row tile, 8 of Cout; K = 4608 in 72 chunks, 4 splits
    assert _plan(1, (7, 7, 512, 512, 3, 1, 1)) == ck.FusedConvPlan(
        'wgmma', 64, 4)
    # a 1x1 conv from 64 channels has one chunk: nothing to split
    assert _plan(1, (56, 56, 64, 256, 1, 1, 0)).splits == 1
    # batch 8, 14x14 3x3: 13 x 4 tiles, 36 chunks: 3 splits would pass a
    # wave, so 2
    assert _plan(8, (14, 14, 256, 256, 3, 1, 1)) == ck.FusedConvPlan(
        'wgmma', 64, 2)
    # batch 128 fills the card everywhere
    assert all(_plan(128, key).splits == 1 for key in RESNET50_REGIONS)
    # fewer SMs: wider tiles, fewer splits
    assert _plan(8, (7, 7, 512, 512, 3, 1, 1), sms=32) == ck.FusedConvPlan(
        'wgmma', 128, 2)
    assert _plan(8, (7, 7, 512, 512, 3, 1, 1), sms=8) == ck.FusedConvPlan(
        'wgmma', 256, 1)


@pytest.mark.parametrize('case,variant,bn', [
    ((8, 16, 16, 3, 64, 7, 2, 3, torch.bfloat16, False), 'stem', 0),
    ((8, 16, 16, 5, 64, 3, 1, 1, torch.bfloat16, False), 'stem', 0),
    # the stem kernel's staged rows take W * Cin % 8 == 0, Cout % 8 == 0
    ((8, 14, 14, 3, 64, 7, 2, 3, torch.bfloat16, False), 'mma_sync', 0),
    ((8, 16, 16, 3, 60, 7, 2, 3, torch.bfloat16, False), 'mma_sync', 0),
    ((8, 14, 14, 32, 64, 3, 1, 1, torch.bfloat16, False), 'mma_sync', 0),
    ((8, 14, 14, 96, 64, 3, 1, 1, torch.bfloat16, False), 'mma_sync', 0),
    ((8, 14, 14, 64, 60, 1, 1, 0, torch.bfloat16, False), 'mma_sync', 0),
    # 81 taps: more than the kernel's arguments carry
    ((8, 14, 14, 64, 64, 9, 1, 4, torch.bfloat16, False), 'mma_sync', 0),
    ((8, 14, 14, 64, 64, 3, 1, 1, torch.bfloat16, True), 'fma', 0),
    ((8, 14, 14, 64, 64, 3, 1, 1, torch.float32, False), 'fma', 0),
    ((8, 14, 14, 64, 64, 3, 1, 1, torch.float32, True), 'fma', 0),
    ((8, 14, 14, 64, 64, 3, 1, 1, torch.bfloat16, False), 'wgmma', 64),
    ((8, 14, 14, 64, 8, 1, 1, 0, torch.bfloat16, False), 'wgmma', 64),
    ((64, 14, 14, 64, 72, 1, 1, 0, torch.bfloat16, False), 'wgmma', 128),
    ((64, 14, 14, 128, 136, 1, 1, 0, torch.bfloat16, False), 'wgmma', 256),
    ((8, 14, 14, 128, 4096, 1, 1, 0, torch.bfloat16, False), 'wgmma', 256),
    # too few rows for a half wave of wide tiles: 64-wide ones
    ((8, 14, 14, 64, 72, 1, 1, 0, torch.bfloat16, False), 'wgmma', 64),
    ((1, 14, 14, 128, 4096, 1, 1, 0, torch.bfloat16, False), 'wgmma', 64),
])
def test_plan_boundaries(case, variant, bn):
    N, H, W, cin, cout, k, s, p, dtype, dw = case
    plan = ck.fused_conv_plan(dtype, N, H, W, cin, cout, k, k, (s, s),
                              (p, p), dw, SMS)
    assert plan.variant == variant and plan.bn == bn
    if variant != 'wgmma':
        assert plan == ck.FusedConvPlan(variant, 0, 1)
    assert plan.variant in ck.FUSED_CONV_VARIANTS


def test_stem_shared_memory():
    """ResNet-50's stem stages 3 output rows' 7 input rows of 224 pixels
    between 8 zero pixels a side (16-byte aligned stores of 3-channel
    pixels); A and B span K = 147 padded to 160."""
    lda = 168
    assert ck._stem_smem_bytes(224, 3, 64, 7, 7, 112, 3) == \
        128 * lda * 2 + 64 * lda * 2 + 3 * 7 * (8 + 224 + 8) * 3 * 2
    # a narrow output spans more rows; a wide image can overflow a block
    assert ck._stem_smem_bytes(32, 3, 64, 7, 7, 16, 3) > \
        ck._stem_smem_bytes(32, 3, 64, 7, 7, 112, 3)
    assert ck._stem_smem_bytes(8192, 3, 64, 7, 7, 1, 3) is None


def test_plan_refuses_other_dtypes():
    with pytest.raises(TypeError):
        ck.fused_conv_plan(torch.float16, 1, 8, 8, 64, 64, 3, 3, (1, 1),
                           (1, 1), False, SMS)


# the plan's knobs untuned: (conv_max_bn, conv_max_splits)
UNTUNED = (256, 4)


def _launch_args(N, H, W, C, Cout, KH, KW, strides, pads, plan=None):
    """The kernel's arguments as the wrapper encodes them for a bf16 conv
    with the folded batch norm and relu (all but the pointers), and the
    plan they carry."""
    ho = (H + 2 * pads[0] - KH) // strides[0] + 1
    wo = (W + 2 * pads[1] - KW) // strides[1] + 1
    encoded, plan, _, _ = ck._encoded_launch(
        ('c', 'c'), (('affine', 0, 1), ('act', 'relu')),
        (N, H, W, C, Cout, KH, KW, ho, wo), tuple(strides), tuple(pads),
        False, torch.bfloat16, SMS, plan, UNTUNED)
    return ck._FusedConvArgs.from_buffer_copy(encoded), plan


def im2col_start(m0, args):
    """The start coordinate {w, h, n} of the im2col load of the tile whose
    first output pixel is m0 (flat over N * Ho * Wo), from the kernel's
    arguments as csrc/fused_conv.cu's producer computes it: that pixel's
    (0, 0) tap, lower + (wo, ho) * element strides, negative inside the
    padding."""
    n, rem = divmod(m0, args.Ho * args.Wo)
    ho, wo = divmod(rem, args.Wo)
    return (args.im2col_lower[0] + wo * args.im2col_stride[0],
            args.im2col_lower[1] + ho * args.im2col_stride[1], n)


def im2col_load_reference(x, lower, upper, element_strides, start, offsets,
                          c0, channels=64, pixels=128):
    """What one TMA im2col load fetches from NHWC ``x``, in plain PyTorch:
    ``pixels`` rows of ``channels`` channels from c0. The walk starts at
    ``start`` {w, h, n} and steps along W by the element stride; past
    size - 1 + upper it goes back to lower and steps along H, past that
    along N (lower, upper and the strides {w, h}). Each pixel is read at
    ``offsets`` {kw, kh} from its position; a read outside the image
    (padding, n >= N, a channel >= C) gives 0."""
    N, H, W, C = x.shape
    w, h, n = start
    ow, oh = offsets
    sw, sh = element_strides
    out = x.new_zeros(pixels, channels)
    hi_c = min(C, c0 + channels)
    for i in range(pixels):
        wi, hi = w + ow, h + oh
        if n < N and 0 <= hi < H and 0 <= wi < W and c0 < C:
            out[i, :hi_c - c0] = x[n, hi, wi, c0:hi_c]
        w += sw
        if w > W - 1 + upper[0]:
            w, h = lower[0], h + sh
            if h > H - 1 + upper[1]:
                h, n = lower[1], n + 1
    return out


def _unfold_taps(x, KH, KW, strides, pads):
    """[M, KH * KW, C]: tap (kh, kw) of each output pixel, from F.unfold."""
    N, H, W, C = x.shape
    cols = F.unfold(x.permute(0, 3, 1, 2), (KH, KW), padding=pads,
                    stride=strides)                  # [N, C * KH * KW, L]
    return cols.view(N, C, KH * KW, -1).permute(0, 3, 2, 1).reshape(
        -1, KH * KW, C)


@pytest.mark.parametrize('conv', [
    # (N, H, W, C, KH, KW, strides, pads)
    (3, 9, 9, 64, 1, 1, (1, 1), (0, 0)),      # 1x1 s1, M 243: ragged
    (2, 15, 13, 64, 1, 1, (2, 2), (0, 0)),    # 1x1 s2
    (3, 9, 11, 128, 3, 3, (1, 1), (1, 1)),    # 3x3 p1, 2 channel chunks
    (3, 13, 13, 64, 7, 7, (2, 2), (3, 3)),    # 7x7 s2 p3, M 147
    (1, 7, 7, 64, 3, 3, (1, 1), (1, 1)),      # batch 1, M 49 < 64
    (2, 10, 9, 64, 3, 3, (2, 1), (0, 1)),     # strides and pads per axis
])
def test_im2col_parameters_match_unfold(conv):
    """Each im2col load, parametrised by the launch arguments the kernel
    receives (corners, element strides, each tap's offsets, and from
    them the tile's start), fetches the rows of F.unfold: tap (kh, kw) of
    128 output pixels and 64 channels, zero past the image and past M."""
    N, H, W, C, KH, KW, strides, pads = conv
    rng = np.random.RandomState(sum(conv[:6]))
    x = torch.tensor(rng.randn(N, H, W, C).astype(np.float32))
    args, plan = _launch_args(N, H, W, C, 64, KH, KW, strides, pads)
    assert plan.variant == 'wgmma'
    M = N * args.Ho * args.Wo
    ref = _unfold_taps(x, KH, KW, strides, pads)
    ref = torch.cat([ref, ref.new_zeros(128, KH * KW, C)])  # rows past M
    lower, upper = tuple(args.im2col_lower), tuple(args.im2col_upper)
    elem = tuple(args.im2col_stride)
    taps = [tuple(args.im2col_taps[t]) for t in range(KH * KW)]
    assert (lower, upper, elem, tuple(taps)) == ck.fused_conv_im2col(
        KH, KW, strides, pads)
    for m0 in range(0, M, 128):
        start = im2col_start(m0, args)
        for t in sorted({0, len(taps) // 2, len(taps) - 1}):
            for c0 in range(0, C, 64):
                got = im2col_load_reference(x, lower, upper, elem, start,
                                            taps[t], c0)
                assert torch.equal(got, ref[m0:m0 + 128, t, c0:c0 + 64])


def test_im2col_corners():
    # 3x3 pad 1: an output's (0, 0) tap runs from -1 to size - 2
    assert ck.fused_conv_im2col(3, 3, (1, 1), (1, 1))[:2] == \
        ((-1, -1), (-1, -1))
    # 7x7 stride 2 pad 3
    assert ck.fused_conv_im2col(7, 7, (2, 2), (3, 3))[:3] == \
        ((-3, -3), (-3, -3), (2, 2))
    # 1x1 stride 2: the whole image, every other pixel; strides per axis
    assert ck.fused_conv_im2col(1, 1, (2, 2), (0, 0))[:3] == \
        ((0, 0), (0, 0), (2, 2))
    assert ck.fused_conv_im2col(3, 3, (2, 1), (0, 1))[2:] == \
        ((1, 2), ((0, 0), (1, 0), (2, 0), (0, 1), (1, 1), (2, 1), (0, 2),
                  (1, 2), (2, 2)))
    # the tile of output pixel 50 of 7x7 outputs, stride 2, pad 3
    args, _ = _launch_args(2, 13, 13, 64, 64, 7, 7, (2, 2), (3, 3))
    assert (args.Ho, args.Wo) == (7, 7)
    assert im2col_start(50, args) == (-1, -3, 1)


@pytest.mark.parametrize('N,key', [(1, (7, 7, 512, 512, 3, 1, 1)),
                                   (32, (7, 7, 512, 512, 3, 1, 1)),
                                   (8, (14, 14, 256, 1024, 1, 1, 0)),
                                   (32, (56, 56, 64, 256, 1, 1, 0))])
def test_split_k_workspace(N, key):
    """One f32 128 x bn tile and one int32 counter per output tile where
    K is split; nothing otherwise."""
    plan = _plan(N, key)
    M, cout = _out_rows(N, key), key[3]
    elems, counters = ck.fused_conv_workspace(plan, M, cout)
    tiles = -(-M // 128) * -(-cout // plan.bn)
    if plan.splits > 1:
        assert (elems, counters) == (tiles * 128 * plan.bn, tiles)
    else:
        assert (elems, counters) == (0, 0)
    assert ck.fused_conv_workspace(plan._replace(splits=1), M, cout) == \
        (0, 0)
    assert ck.fused_conv_workspace(ck.FusedConvPlan('mma_sync', 0, 1),
                                   M, cout) == (0, 0)


def test_kernel_arguments_carry_the_plan():
    """_FusedConvArgs mirrors FusedConvArgs of csrc/fused_conv.cu field
    for field: the plan, the SM count, the im2col parameters and the
    split-K buffers follow the stats slab."""
    names = [f[0] for f in ck._FusedConvArgs._fields_]
    assert names[names.index('stats'):] == [
        'stats', 'variant', 'bn', 'splits', 'sms', 'im2col_lower',
        'im2col_upper', 'im2col_stride', 'im2col_taps', 'workspace',
        'counters']
    src = open(ck._build.CSRC_DIR + '/fused_conv.cu').read()
    assert 'int variant, bn, splits, sms;' in src
    assert 'int im2col_lower[2], im2col_upper[2], im2col_stride[2];' in src
    assert 'int im2col_taps[kMaxTaps][2];' in src
    assert 'constexpr int kMaxTaps = %d;' % ck.FUSED_CONV_MAX_TAPS in src
    assert 'static int sms' not in src


@pytest.mark.parametrize('N,key', [(1, (7, 7, 512, 512, 3, 1, 1)),
                                   (32, (56, 56, 64, 256, 1, 1, 0)),
                                   (1, (224, 224, 3, 64, 7, 2, 3))])
def test_encoded_launch_carries_the_plan(N, key):
    """The encoded arguments carry the plan's variant, width and splits,
    the SM count and the shape; a plan given overrides the wrapper's, and
    the encoding is made once per distinct launch."""
    H, W, cin, cout, k, s, p = key
    args, plan = _launch_args(N, H, W, cin, cout, k, k, (s, s), (p, p))
    assert plan == _plan(N, key)
    assert (ck.FUSED_CONV_VARIANTS[args.variant], args.bn, args.splits,
            args.sms) == tuple(plan) + (SMS,)
    assert (args.N, args.H, args.Cin, args.Cout, args.KH, args.sh,
            args.ph, args.is_bf16) == (N, H, cin, cout, k, s, p, 1)
    forced = ck.FusedConvPlan('mma_sync', 0, 1)
    args, plan = _launch_args(N, H, W, cin, cout, k, k, (s, s), (p, p),
                              plan=forced)
    assert plan == forced and args.variant == 1
    hits = ck._encoded_launch.cache_info().hits
    _launch_args(N, H, W, cin, cout, k, k, (s, s), (p, p), plan=forced)
    assert ck._encoded_launch.cache_info().hits == hits + 1
