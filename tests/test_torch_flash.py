"""The port's flash attention (paddle_tpu_torch/ops/cuda_kernels.py)
against the JAX package's (paddle_tpu/ops/pallas_kernels.py).

On the CPU the port's wrapper runs its plain PyTorch version; the JAX
side runs the Pallas kernel body in interpret mode, as
tests/test_pallas.py does, or its plain reference where the shape has
no 128-aligned block. Inputs are made with numpy from a seed; both
sides run in f32. Tolerance atol = rtol = 1e-5 (f32 sums in another
order).
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from paddle_tpu.ops import pallas_kernels as pk
from paddle_tpu_torch.ops import cuda_kernels as ck

TOL = dict(atol=1e-5, rtol=1e-5)


def _qkv(B, T, H, D, seed):
    rng = np.random.RandomState(seed)
    return [rng.randn(B, T, H, D).astype('float32') for _ in range(3)]


def _torch(arrs):
    return [torch.from_numpy(a) for a in arrs]


@pytest.mark.parametrize('D', [32, 64])
@pytest.mark.parametrize('causal', [True, False])
def test_plain_flash_matches_pallas_interpret(D, causal):
    qkv = _qkv(2, 256, 2, D, seed=D + causal)
    j_out, j_lse = pk.flash_attention_with_lse(
        *[jnp.asarray(a) for a in qkv], causal=causal, block_q=128,
        block_k=128, interpret=True)
    t_out, t_lse = ck.flash_attention_with_lse(*_torch(qkv), causal=causal)
    assert t_out.shape == (2, 256, 2, D) and t_lse.shape == (2, 2, 256)
    np.testing.assert_allclose(t_out.numpy(), np.asarray(j_out), **TOL)
    np.testing.assert_allclose(t_lse.numpy(), np.asarray(j_lse), **TOL)


@pytest.mark.parametrize('causal', [True, False])
def test_plain_flash_ragged_matches_reference(causal):
    qkv = _qkv(2, 200, 2, 64, seed=7)
    j_out, j_lse = pk.attention_reference_with_lse(
        *[jnp.asarray(a) for a in qkv], causal=causal)
    t_out, t_lse = ck.flash_attention_with_lse(*_torch(qkv), causal=causal)
    np.testing.assert_allclose(t_out.numpy(), np.asarray(j_out), **TOL)
    np.testing.assert_allclose(t_lse.numpy(), np.asarray(j_lse), **TOL)


def test_cpu_tensors_take_the_plain_version_without_counting():
    ck.reset_launch_counts()
    q, k, v = _torch(_qkv(1, 64, 2, 32, seed=3))
    out = ck.flash_attention(q, k, v)
    ref, _ = ck.flash_attention_reference_with_lse(q, k, v)
    assert torch.equal(out, ref)
    assert ck.LAUNCHES['flash_attn_fwd'] == 0


def test_plain_flash_bf16_rounds_probs_like_jax():
    # the bf16 path casts probabilities to the input dtype before the
    # product with v, as the JAX reference does
    qkv = _qkv(1, 128, 2, 32, seed=5)
    j_out, j_lse = pk.attention_reference_with_lse(
        *[jnp.asarray(a, dtype=jnp.bfloat16) for a in qkv], causal=True)
    t_out, t_lse = ck.flash_attention_reference_with_lse(
        *[t.to(torch.bfloat16) for t in _torch(qkv)], causal=True)
    assert t_out.dtype == torch.bfloat16
    np.testing.assert_allclose(t_lse.numpy(), np.asarray(j_lse),
                               atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(t_out.float().numpy(),
                               np.asarray(j_out.astype(jnp.float32)),
                               atol=1e-2, rtol=1e-2)


@pytest.mark.parametrize('case', ['head_dim', 'dtype', 'shape', 'strided',
                                  'rank'])
def test_kernel_input_checks_raise(case):
    q, k, v = _torch(_qkv(1, 64, 2, 64, seed=9))
    if case == 'head_dim':
        q = k = v = torch.zeros(1, 64, 2, 48)
    elif case == 'dtype':
        q, k, v = (t.half() for t in (q, k, v))
    elif case == 'shape':
        k = k[:, :32].contiguous()
    elif case == 'strided':
        q = torch.zeros(1, 64, 2, 128)[..., :64]
    elif case == 'rank':
        q, k, v = (t.reshape(1, 64, 128) for t in (q, k, v))
    with pytest.raises((ValueError, TypeError)):
        ck._check_flash_inputs(q, k, v)


# the kernel variant the wrapper picks: wgmma (TMA, rings of tiles) for bf16
# at D 64 and 128, mma.sync for bf16 at D 32, scalar FMA for f32
@pytest.mark.parametrize('dtype, D, variant', [
    (torch.bfloat16, 32, 'mma_sync'), (torch.bfloat16, 64, 'wgmma'),
    (torch.bfloat16, 128, 'wgmma'), (torch.float32, 32, 'fma'),
    (torch.float32, 64, 'fma'), (torch.float32, 128, 'fma')])
def test_fwd_variant_for_each_dtype_and_head_dim(dtype, D, variant):
    assert ck.flash_variant(dtype, D) == variant


def test_every_input_the_checks_let_through_has_a_variant():
    for dtype in (torch.bfloat16, torch.float32):
        for D in ck.FLASH_HEAD_DIMS:
            q = torch.zeros(1, 8, 2, D, dtype=dtype)
            ck._check_flash_inputs(q, q, q)
            assert ck.flash_variant(dtype, D) in ck._FWD_VARIANT_CODES


@pytest.mark.parametrize('dtype, D', [(torch.float16, 64),
                                      (torch.bfloat16, 48),
                                      (torch.float32, 256)])
def test_fwd_variant_refuses_what_no_kernel_takes(dtype, D):
    with pytest.raises(ValueError):
        ck.flash_variant(dtype, D)
