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
                           'flash_attn_bwd_dq': 0, 'flash_attn_bwd_dkv': 0}
    assert out.shape == (1,) and abs(float(out[0]) - 6.24) < 1.0
    for n in params:
        assert not torch.equal(scope.raw(n), before[n]), n
