"""The fused conv kernel's host plan, on the CPU: the variant and tiling
``cuda_kernels.fused_conv_plan`` picks at every ResNet-50 region shape
and at the boundaries, the TMA im2col load's parameters as the kernel
receives them (``cuda_kernels.fused_conv_im2col`` in the encoded launch
arguments; the load emulated in torch by ``im2col_load_reference`` and
held against ``F.unfold``), and the split-K workspace. The kernel itself
runs only on the card (tests/test_torch_cuda_kernels.py)."""
import weakref

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
    # the stem kernel's staged rows take W * Cin % 8 == 0, Cout % 8 == 0;
    # mma_sync's tile covers Cout 60 and 64 at 64 columns
    ((8, 14, 14, 3, 64, 7, 2, 3, torch.bfloat16, False), 'mma_sync', 64),
    ((8, 16, 16, 3, 60, 7, 2, 3, torch.bfloat16, False), 'mma_sync', 64),
    ((8, 14, 14, 32, 64, 3, 1, 1, torch.bfloat16, False), 'mma_sync', 64),
    ((8, 14, 14, 96, 64, 3, 1, 1, torch.bfloat16, False), 'mma_sync', 64),
    ((8, 14, 14, 64, 60, 1, 1, 0, torch.bfloat16, False), 'mma_sync', 64),
    # 81 taps: more than the kernel's arguments carry
    ((8, 14, 14, 64, 64, 9, 1, 4, torch.bfloat16, False), 'mma_sync', 64),
    # depthwise in either dtype: the depthwise kernel; any other f32
    # conv: three TF32 products
    ((8, 14, 14, 64, 64, 3, 1, 1, torch.bfloat16, True), 'depthwise', 0),
    ((8, 14, 14, 64, 64, 3, 1, 1, torch.float32, False), 'tf32', 64),
    ((8, 14, 14, 64, 64, 3, 1, 1, torch.float32, True), 'depthwise', 0),
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
    if variant in ('stem', 'depthwise'):
        assert plan == ck.FusedConvPlan(variant, 0, 1)
    elif variant != 'wgmma':
        # at most 1,568 output rows: no tile fills a wave of 132 SMs, so
        # all 4 warps share K and a block takes 16 rows
        assert plan.splits == 4 and ck.mma_tile_rows(plan) == 16
    assert plan.variant in ck.FUSED_CONV_VARIANTS


# (N, H, W, Cin, Cout, K, stride, pad, dtype, emit_stats) -> (variant,
# bn, splits, rows a block): the tf32 and mma_sync kernels' tile width
# follows Cout (f32: 16, 32, 64; bf16: Cout rounded up to 8, at most 64),
# a block's rows rise as it narrows (128 up to 32 columns, 64 wider, at
# splits 1), and the fewest warps share K that still give a wave of 132
# SMs (2 waves in f32, 4 in bf16 where the input rows are staged; the
# stats form keeps whole 64-row slots and shares K among 2 sets of 4
# warps where its blocks fall short of a wave); mnist's, ResNet-32's and
# VGG-16's regions among them
MMA_PLANS = [
    # mnist's first conv (staged rows): Cout 20 at batch 32 and 64
    ((32, 28, 28, 1, 20, 5, 1, 0, torch.float32, False), ('tf32', 32, 2, 64)),
    ((64, 28, 28, 1, 20, 5, 1, 0, torch.float32, False),
     ('tf32', 32, 1, 128)),
    ((32, 28, 28, 1, 20, 5, 1, 0, torch.bfloat16, False),
     ('mma_sync', 24, 4, 32)),
    ((64, 28, 28, 1, 20, 5, 1, 0, torch.bfloat16, False),
     ('mma_sync', 24, 2, 64)),
    # its second: Cout 50, 2,048 rows in 16-row tiles, 128 blocks
    ((32, 12, 12, 20, 50, 5, 1, 0, torch.float32, False), ('tf32', 64, 4, 16)),
    ((32, 12, 12, 20, 50, 5, 1, 0, torch.bfloat16, False),
     ('mma_sync', 56, 4, 16)),
    # ResNet-32 at batch 128: Cout 16, 32 (stride 2), 64
    ((128, 32, 32, 16, 16, 3, 1, 1, torch.float32, False),
     ('tf32', 16, 1, 128)),
    ((128, 32, 32, 16, 16, 3, 1, 1, torch.bfloat16, True),
     ('mma_sync', 16, 1, 128)),
    ((128, 32, 32, 16, 32, 3, 2, 1, torch.float32, True),
     ('tf32', 32, 1, 128)),
    ((128, 8, 8, 64, 64, 3, 1, 1, torch.float32, False), ('tf32', 64, 2, 32)),
    ((128, 8, 8, 64, 64, 3, 1, 1, torch.float32, True), ('tf32', 64, 2, 64)),
    # ResNet-32 served at batch 1: no tile fills a wave
    ((1, 32, 32, 16, 16, 3, 1, 1, torch.float32, False), ('tf32', 16, 4, 32)),
    # wider than 64: 64 columns; VGG-16's 2x2 stage at batch 32
    ((32, 2, 2, 512, 512, 3, 1, 1, torch.float32, False), ('tf32', 64, 4, 16)),
    ((32, 2, 2, 512, 512, 3, 1, 1, torch.float32, True), ('tf32', 64, 2, 64)),
    ((8, 14, 14, 32, 200, 3, 1, 1, torch.bfloat16, False),
     ('mma_sync', 64, 2, 32)),
    # 3 and 1 input channels: staged rows
    ((32, 32, 32, 3, 64, 3, 1, 1, torch.float32, False), ('tf32', 64, 1, 64)),
    ((4, 9, 9, 1, 8, 3, 1, 1, torch.bfloat16, False), ('mma_sync', 8, 4, 32)),
]


@pytest.mark.parametrize('case,want', MMA_PLANS)
def test_mma_plan_width_rows_and_splits(case, want):
    N, H, W, cin, cout, k, s, p, dtype, stats = case
    plan = ck.fused_conv_plan(dtype, N, H, W, cin, cout, k, k, (s, s),
                              (p, p), False, SMS, emit_stats=stats)
    assert tuple(plan) + (ck.mma_tile_rows(plan, stats),) == want
    assert plan.bn == ck.mma_tile_width(dtype, cout) >= min(cout, 64)
    # no split-K buffers: the warps' partials meet in shared memory
    ho, wo = (H + 2 * p - k) // s + 1, (W + 2 * p - k) // s + 1
    assert ck.fused_conv_workspace(plan, N * ho * wo, cout) == (0, 0)
    # the same conv depthwise takes the depthwise kernel
    if cin == cout:
        assert ck.fused_conv_plan(dtype, N, H, W, cin, cout, k, k, (s, s),
                                  (p, p), True, SMS, emit_stats=stats) == \
            ck.FusedConvPlan('depthwise', 0, 1)


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
def test_mma_plan_caps_splits(dtype):
    """conv_max_splits caps the warps that share K; the stats form never
    takes a block of fewer rows than one slot of its slab, and shares K
    among at most 2 sets of 4 warps."""
    args = (dtype, 32, 12, 12, 24, 50, 5, 5, (1, 1), (0, 0), False, SMS)
    assert ck.fused_conv_plan(*args, max_splits=1).splits == 1
    assert ck.fused_conv_plan(*args, max_splits=2).splits == 2
    assert ck.fused_conv_plan(*args).splits == 4
    plan = ck.fused_conv_plan(*args, emit_stats=True)
    assert plan.splits == 2 and ck.mma_tile_rows(plan, True) == 64
    assert ck.fused_conv_plan(*args, max_splits=1,
                              emit_stats=True).splits == 1


def test_mma_staged_rows_shared_memory():
    """The staged path holds the tap table, the block's rows of w and the
    input rows its pixels span; a row too wide for a block raises."""
    # mnist's second conv in bf16, 16-row tiles: 3 output rows of 5 input
    # rows of 12 x 20 channels; w's 56 rows of K 500; tap table 500 ints
    assert ck._mma_staged_smem_bytes(torch.bfloat16, 12, 20, 5, 5, 8, 0, 56,
                                     16) == \
        2000 + 64 * 500 * 2 + 3 * 5 * 12 * 20 * 2
    # f32, Cin 3, pad 1: rows padded to 4 pixels a side (16-byte stores);
    # less than the 64 x 64 f32 output tile that follows them
    staged = 112 + 64 * 27 * 4 + 3 * 3 * (4 + 32 + 4) * 3 * 4
    assert staged < 64 * 68 * 4 == ck._mma_staged_smem_bytes(
        torch.float32, 32, 3, 3, 3, 32, 1, 64, 64)
    assert ck._mma_staged_smem_bytes(torch.float32, 30000, 3, 3, 3, 30000, 1,
                                     64, 16) is None
    with pytest.raises(ValueError, match='shared memory'):
        ck.fused_conv_plan(torch.float32, 1, 8, 30000, 3, 64, 3, 3, (1, 1),
                           (1, 1), False, SMS)


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
    encoded, plan, _, _, _ = ck._encoded_launch(
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
    """_FusedConvArgs mirrors FusedConvArgs of csrc/fused_conv.cuh field
    for field: the plan, the SM count, the im2col parameters and the
    split-K buffers follow the stats slab; the variants are numbered as
    FUSED_CONV_VARIANTS names them."""
    names = [f[0] for f in ck._FusedConvArgs._fields_]
    assert names[names.index('stats'):] == [
        'stats', 'variant', 'bn', 'splits', 'sms', 'im2col_lower',
        'im2col_upper', 'im2col_stride', 'im2col_taps', 'workspace',
        'counters', 'dw_rows', 'dw_strips', 'dw_chans', 'dw_blocks',
        'dw_bufs']
    src = open(ck._build.CSRC_DIR + '/fused_conv.cuh').read()
    assert 'int variant, bn, splits, sms;' in src
    assert 'int dw_rows, dw_strips, dw_chans, dw_blocks, dw_bufs;' in src
    assert 'int im2col_lower[2], im2col_upper[2], im2col_stride[2];' in src
    assert 'int im2col_taps[kMaxTaps][2];' in src
    assert 'constexpr int kMaxTaps = %d;' % ck.FUSED_CONV_MAX_TAPS in src
    assert 'static int sms' not in src
    enum = src[src.index('enum Variant {'):].split('}')[0]
    names = [v.split('=')[0].strip() for v in
             enum.split('{')[1].split(',')]
    assert names == ['k' + ''.join(p.title() for p in v.split('_'))
                     for v in ck.FUSED_CONV_VARIANTS]


def test_split_k_buffers_outlive_the_launch(monkeypatch):
    """The split-K counters and workspace are alive when the launch is
    queued, as they are where a graph capture makes fresh counters that
    no cache holds: a buffer freed before the launch would be handed to
    the stats slab allocated after it, and the kernel would write the
    moments over the turn counters (a wait that never ends)."""
    made, seen = [], []

    def counters(device, n):
        t = torch.zeros(n, dtype=torch.int32)   # not cached, as in capture
        made.append(weakref.ref(t))
        return t

    def launch(lib, fn_name, args, device, what):
        a = ck._FusedConvArgs.from_address(args[0])
        seen.append((a.splits, made[-1]() is not None and
                     made[-1]().data_ptr() == a.counters, a.workspace != 0))
    monkeypatch.setattr(ck, '_on_card', lambda t, what: True)
    monkeypatch.setattr(ck, '_launch', launch)
    monkeypatch.setattr(ck, '_sm_count', lambda index: SMS)
    monkeypatch.setattr(torch.cuda, 'current_device', lambda: 0)
    monkeypatch.setattr(ck, '_split_k_counters', counters)
    x = torch.zeros(32, 4, 4, 256, dtype=torch.bfloat16)
    w = torch.zeros(512, 3, 3, 256, dtype=torch.bfloat16)
    ck._fused_conv_launch(x, w, (), (), (), (1, 1), (1, 1), False,
                          emit_stats=True)
    assert seen == [(3, True, True)]


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


# ---- the depthwise kernel's tile --------------------------------------------------
# MobileNet-v1's 13 depthwise 3x3 layers at 224 (H, W, C, stride), batch 32
MOBILENET_DW = [(112, 112, 32, 1), (112, 112, 64, 2), (56, 56, 128, 1),
                (56, 56, 128, 2), (28, 28, 256, 1), (28, 28, 256, 2)] + \
    [(14, 14, 512, 1)] * 5 + [(14, 14, 512, 2), (7, 7, 1024, 1)]
# (N, H, W, C, K, stride, pad): ragged C (24, 40, 6, 12), H and W 7, 9 and
# 11, 5x5 at stride 2, no padding, a 7x7 image of 1024 channels
DEPTHWISE_SHAPES = [(2, 9, 9, 24, 3, 1, 1), (3, 11, 7, 40, 3, 1, 1),
                    (3, 7, 7, 40, 3, 2, 1), (2, 11, 11, 24, 5, 2, 2),
                    (2, 9, 11, 40, 5, 2, 2), (2, 9, 11, 6, 3, 1, 1),
                    (2, 7, 9, 12, 3, 2, 1), (2, 7, 7, 1024, 3, 1, 1),
                    (2, 30, 30, 64, 3, 1, 0), (1, 64, 512, 16, 7, 1, 3)] + \
    [(32, H, W, C, 3, s, 1) for H, W, C, s in sorted(set(MOBILENET_DW))]


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('shape', DEPTHWISE_SHAPES)
def test_depthwise_plan_and_tile(dtype, shape):
    """Every depthwise shape takes the depthwise kernel in both forms, and
    its tile fits the kernel: at most 256 threads, channels in 4-channel
    groups (8 in bf16 where TMA loads the halo), a TMA box of at most 256
    along each dimension, a ring of 2 to 4 halo buffers, the block's
    shared memory, at most one block a tile, and the stats slab's slots
    one a block."""
    N, H, W, C, k, s, p = shape
    for stats in (False, True):
        assert ck.fused_conv_plan(dtype, N, H, W, C, C, k, k, (s, s),
                                  (p, p), True, SMS, emit_stats=stats) == \
            ck.FusedConvPlan('depthwise', 0, 1)
    tile = ck.depthwise_tile(dtype, N, H, W, C, k, k, (s, s), (p, p), SMS)
    e = 2 if dtype == torch.bfloat16 else 4
    ho, wo = (H + 2 * p - k) // s + 1, (W + 2 * p - k) // s + 1
    cols = tile.strips * ck._DW_COLS
    assert tile.chans % 4 == 0 and 4 <= tile.chans <= 256
    if C * e % 16 == 0:
        assert tile.chans * e % 16 == 0
    assert tile.chans // 4 * tile.rows * tile.strips <= ck._DW_THREADS
    assert (tile.rows - 1) * s + k <= 256 and (cols - 1) * s + k <= 256
    assert tile.rows <= ho and cols < wo + ck._DW_COLS
    assert 2 <= tile.bufs <= ck._DW_MAX_BUFS
    assert ck.depthwise_smem_bytes(dtype, C, k, k, (s, s), tile.rows,
                                   tile.strips, tile.chans, tile.bufs) <= \
        ck.FUSED_CONV_SMEM
    tiles = N * -(-ho // tile.rows) * -(-wo // cols)
    assert 1 <= tile.blocks <= tiles
    assert -(-C // tile.chans) <= 65535
    assert ck.fused_conv_slots(ck.FusedConvPlan('depthwise', 0, 1),
                               N * ho * wo, tile) == tile.blocks


def test_depthwise_mobilenet_tiles_fill_blocks():
    """At MobileNet-v1's stride-1 layers a block runs at least 128
    threads, and at every layer the blocks fill the SMs at least once."""
    for dtype in (torch.float32, torch.bfloat16):
        for H, W, C, s in MOBILENET_DW:
            tile = ck.depthwise_tile(dtype, 32, H, W, C, 3, 3, (s, s),
                                     (1, 1), SMS)
            threads = tile.chans // 4 * tile.rows * tile.strips
            assert s == 2 or threads >= 128, (dtype, H, C, tile)
            assert tile.blocks * -(-C // tile.chans) >= SMS, (dtype, H, C,
                                                              tile)


def test_depthwise_kernel_constants_mirror_the_source():
    """The tile's constants are the kernel's (csrc
    fused_conv_depthwise.cu), and the encoded launch carries the tile."""
    src = open(ck._build.CSRC_DIR + '/fused_conv_depthwise.cu').read()
    assert 'constexpr int kDwCols = %d;' % ck._DW_COLS in src
    assert 'constexpr int kDwThreads = %d;' % ck._DW_THREADS in src
    assert 'constexpr int kDwBox = %d;' % ck._DW_BOX in src
    assert 'constexpr int kDwMaxBufs = %d;' % ck._DW_MAX_BUFS in src
    assert 'fused_conv_depthwise.cu' in ck._build.KERNELS['fused_conv'][0]
    N, H, W, C, k, s, p = 32, 56, 56, 128, 3, 2, 1
    ho = wo = 28
    for dtype in (torch.float32, torch.bfloat16):
        encoded, plan, workspace, slots, _ = ck._encoded_launch(
            ('c', 'c'), (('affine', 0, 1), ('act', 'relu')),
            (N, H, W, C, C, k, k, ho, wo), (s, s), (p, p), True, dtype,
            SMS, None, UNTUNED, True)
        args = ck._FusedConvArgs.from_buffer_copy(encoded)
        tile = ck.depthwise_tile(dtype, N, H, W, C, k, k, (s, s), (p, p),
                                 SMS)
        assert plan == ck.FusedConvPlan('depthwise', 0, 1)
        assert ck.FUSED_CONV_VARIANTS[args.variant] == 'depthwise'
        assert (args.dw_rows, args.dw_strips, args.dw_chans,
                args.dw_blocks, args.dw_bufs) == tuple(tile)
        assert slots == tile.blocks and workspace == (0, 0)
