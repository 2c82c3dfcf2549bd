"""The f32 fused conv's product scheme, on the CPU: csrc/fused_conv.cu's
tf32 kernel runs every f32 conv that is not depthwise on the tensor cores
as three TF32 products, each operand split as hi = tf32(x), lo = tf32(x -
hi) (cvt.rna: to nearest, ties away from zero, 10 mantissa bits) and the
conv taken as a_hi b_hi + a_hi b_lo + a_lo b_hi with f32 sums, a_lo b_lo
dropped. Emulated here in torch (tests only), at the region shapes the
kernel serves: mnist's K of 25 and 500, ResNet-32's 144 and 576, VGG-16's
4,608. The scheme must hold the f32 conv's limit (chip_smoke.py's
CONV_TOL['float32'], per element against the conv in f64) and stay within
2x the plain f32 conv's max error against f64; one TF32 product must fail
that limit. The kernel itself runs only on the card
(tests/test_torch_cuda_kernels.py, chip_smoke.py)."""
import numpy as np
import pytest
import torch
import torch.nn.functional as F

# |err| <= rel * |f64| + abs * rms(f64), per element (chip_smoke.py)
CONV_TOL_F32 = (1e-5, 1e-4)
F64_WITNESS = 2.0

# (N, H, W, Cin, Cout, K, pad): K = KH * KW * Cin of 25 (mnist's first
# conv), 500 (its second), 144 and 576 (ResNet-32's 16- and 64-channel 3x3
# convs), 4,608 (VGG-16's 512-channel 3x3), at small N
SHAPES = {
    'mnist_k25': (4, 12, 12, 1, 20, 5, 0),
    'mnist_k500': (2, 12, 12, 20, 50, 5, 0),
    'resnet32_k144': (2, 16, 16, 16, 16, 3, 1),
    'resnet32_k576': (2, 8, 8, 64, 64, 3, 1),
    'vgg16_k4608': (2, 4, 4, 512, 64, 3, 1),
}


def tf32_rna(x):
    """f32 ``x`` rounded to TF32 as cvt.rna.tf32.f32 does: to 10
    mantissa bits, to nearest, ties away from zero (finite inputs)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def split_tf32(x):
    hi = tf32_rna(x)
    return hi, tf32_rna(x - hi)


def _operands(shape, seed):
    N, H, W, cin, cout, k, _ = shape
    rng = np.random.RandomState(seed)
    x = rng.randn(N, cin, H, W).astype('float32')
    w = (rng.randn(cout, cin, k, k) * np.sqrt(2.0 / (k * k * cin))).astype(
        'float32')
    return torch.from_numpy(x), torch.from_numpy(w)


def _im2col(x, w, pad):
    """A [N * L, K] and B [K, Cout] of the conv as a product, K in
    unfold's (cin, kh, kw) order (any order: the sums are over K)."""
    k = w.shape[-1]
    cols = F.unfold(x, k, padding=pad)                 # [N, K, L]
    a = cols.transpose(1, 2).reshape(-1, cols.shape[1])
    return a, w.reshape(w.shape[0], -1).t()


def three_tf32_conv(x, w, pad):
    """The conv as the tf32 kernel computes it: a_hi b_hi + a_hi b_lo +
    a_lo b_hi, each product exact in f32 (11 significant bits a factor),
    summed in f32."""
    a, b = _im2col(x, w, pad)
    a_hi, a_lo = split_tf32(a)
    b_hi, b_lo = split_tf32(b)
    return (a_lo @ b_hi + a_hi @ b_lo) + a_hi @ b_hi


def one_tf32_conv(x, w, pad):
    """One TF32 product (what cuDNN's TF32 mode computes): the control."""
    a, b = _im2col(x, w, pad)
    return tf32_rna(a) @ tf32_rna(b)


def _f64(x, w, pad):
    a, b = _im2col(x.double(), w.double(), pad)
    return a @ b


def _over_limit(got, exact):
    rel, abs_ = CONV_TOL_F32
    limit = rel * exact.abs() + abs_ * exact.square().mean().sqrt()
    return ((got.double() - exact).abs() / limit).max().item()


def test_tf32_rounding_is_cvt_rna():
    """Ten mantissa bits, to nearest, ties away from zero; lo is the rest
    of x to ~2^-22 of it."""
    half = 2.0 ** -11
    x = torch.tensor([1 + half, -(1 + half), 1 + half / 2, 1 + 3 * half / 2],
                     dtype=torch.float32)
    assert tf32_rna(x).tolist() == [1 + 2 * half, -(1 + 2 * half), 1.0,
                                    1 + 2 * half]
    v = torch.from_numpy(np.random.RandomState(1).randn(4096).astype(
        'float32'))
    hi, lo = split_tf32(v)
    assert not (hi.view(torch.int32) & 0x1FFF).any()
    assert not (lo.view(torch.int32) & 0x1FFF).any()
    err = (v.double() - hi.double() - lo.double()).abs()
    assert torch.all(err <= 2.0 ** -22 * v.double().abs())


@pytest.mark.parametrize('shape', sorted(SHAPES))
def test_three_tf32_products_hold_the_f32_limit(shape):
    """Per element within CONV_TOL_F32 of the f64 conv, and its max error
    at most F64_WITNESS times the plain f32 conv's (F.conv2d on the CPU)."""
    x, w = _operands(SHAPES[shape], seed=len(shape))
    pad = SHAPES[shape][-1]
    exact = _f64(x, w, pad)
    got = three_tf32_conv(x, w, pad)
    assert _over_limit(got, exact) <= 1
    plain = F.conv2d(x, w, padding=pad)
    plain = plain.permute(0, 2, 3, 1).reshape(-1, w.shape[0])
    err = (got.double() - exact).abs().max().item()
    assert err <= F64_WITNESS * (plain.double() - exact).abs().max().item()


@pytest.mark.parametrize('shape', sorted(SHAPES))
def test_one_tf32_product_fails_the_limit(shape):
    """The control: one TF32 product of the same operands breaks the
    f32 limit at every shape, so the limit sees what the split buys."""
    x, w = _operands(SHAPES[shape], seed=len(shape))
    pad = SHAPES[shape][-1]
    assert _over_limit(one_tf32_conv(x, w, pad), _f64(x, w, pad)) > 1


def test_the_emulated_product_is_the_conv():
    """The im2col product in f64 is F.conv2d's conv (the layout the
    emulation sums over)."""
    x, w = _operands(SHAPES['resnet32_k144'], seed=3)
    got = _f64(x, w, 1)
    want = F.conv2d(x.double(), w.double(), padding=1)
    assert torch.allclose(got, want.permute(0, 2, 3, 1).reshape(got.shape),
                          rtol=0, atol=1e-12)
