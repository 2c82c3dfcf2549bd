"""The port's flash-attention backward (paddle_tpu_torch/ops/cuda_kernels.py)
against the JAX package's (paddle_tpu/ops/pallas_kernels.py).

On the CPU the port's wrappers run the plain backward (the kernels'
decomposition: p recomputed from lse, ds = p (dp - delta)); the JAX side
runs its Pallas backward kernels in interpret mode, on the merged route
and on the two-pass route (``pk._MERGED_BWD``), or ``jax.grad`` of its
plain reference where the shape has no 128-aligned block. Inputs are made
with numpy from a seed and both sides run in f32; tolerance atol = rtol =
1e-5 (f32 sums in another order).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.ops import pallas_kernels as pk
from paddle_tpu_torch.ops import cuda_kernels as ck

TOL = dict(atol=1e-5, rtol=1e-5)


def _arrays(B, T, H, D, seed, scale=0.5):
    rng = np.random.RandomState(seed)
    return [(rng.randn(B, T, H, D) * scale).astype('float32')
            for _ in range(4)]


def _torch(arrs, grad=False):
    return [torch.from_numpy(a).requires_grad_(grad) for a in arrs]


def _close(got, ref):
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(r), **TOL)


@pytest.mark.parametrize('merged', [True, False])
@pytest.mark.parametrize('causal', [True, False])
@pytest.mark.parametrize('D', [32, 64])
def test_plain_bwd_matches_pallas_interpret(monkeypatch, D, causal, merged):
    q, k, v, do = _arrays(2, 256, 2, D, seed=D + 2 * causal + merged)
    monkeypatch.setattr(pk, '_MERGED_BWD', [merged])
    jax.clear_caches()   # the route is read while tracing

    def attn(q, k, v):
        return pk.flash_attention(q, k, v, causal=causal, block_q=128,
                                  block_k=128, interpret=True)

    _, vjp = jax.vjp(attn, *[jnp.asarray(a) for a in (q, k, v)])
    j_grads = vjp(jnp.asarray(do))
    jax.clear_caches()

    tq, tk, tv, tdo = _torch([q, k, v, do])
    out, lse = ck.flash_attention_with_lse(tq, tk, tv, causal)
    t_grads = ck.flash_attention_bwd(tq, tk, tv, out, lse, tdo, causal)
    _close(t_grads, j_grads)
    # every kernel's wrapper takes the plain version on the CPU
    delta = ck.flash_bwd_delta(out, tdo)
    _close(ck.flash_bwd_dkvdq(tq, tk, tv, tdo, lse, delta, causal),
           j_grads)
    _close((ck.flash_bwd_dq(tq, tk, tv, tdo, lse, delta, causal),) +
           ck.flash_bwd_dkv(tq, tk, tv, tdo, lse, delta, causal), j_grads)


@pytest.mark.parametrize('causal', [True, False])
def test_lse_cotangent_matches_jax_grad(causal):
    """Gradients flow through both outputs of flash_attention_with_lse:
    the lse cotangent folds into delta, as in pk._flash_lse_bwd."""
    q, k, v, go = _arrays(2, 256, 2, 64, seed=7 + causal)
    gl = (np.random.RandomState(9).randn(2, 2, 256) * 0.1).astype('float32')

    def loss(q, k, v):
        o, l = pk.flash_attention_with_lse(q, k, v, causal=causal,
                                           block_q=128, block_k=128,
                                           interpret=True)
        return jnp.sum(o * go) + jnp.sum(l * gl)

    j_grads = jax.grad(loss, argnums=(0, 1, 2))(
        *[jnp.asarray(a) for a in (q, k, v)])
    leaves = _torch([q, k, v], grad=True)
    o, l = ck.flash_attention_with_lse(*leaves, causal=causal)
    t_loss = (o * torch.from_numpy(go)).sum() + \
        (l * torch.from_numpy(gl)).sum()
    _close(torch.autograd.grad(t_loss, leaves), j_grads)


@pytest.mark.parametrize('causal', [True, False])
def test_ragged_bwd_matches_jax_grad_of_reference(causal):
    """T = 200 has no 128-aligned block: JAX differentiates its plain
    reference; the port's plain backward must agree."""
    q, k, v, go = _arrays(2, 200, 2, 64, seed=11)
    gl = (np.random.RandomState(12).randn(2, 2, 200) * 0.1).astype(
        'float32')

    def loss(q, k, v):
        o, l = pk.attention_reference_with_lse(q, k, v, causal=causal)
        return jnp.sum(o * go) + jnp.sum(l * gl)

    j_grads = jax.grad(loss, argnums=(0, 1, 2))(
        *[jnp.asarray(a) for a in (q, k, v)])
    leaves = _torch([q, k, v], grad=True)
    o, l = ck.flash_attention_with_lse(*leaves, causal=causal)
    t_loss = (o * torch.from_numpy(go)).sum() + \
        (l * torch.from_numpy(gl)).sum()
    _close(torch.autograd.grad(t_loss, leaves), j_grads)


@pytest.mark.parametrize('causal', [True, False])
def test_autograd_function_gradcheck(causal):
    rng = np.random.RandomState(3)
    leaves = [torch.from_numpy(rng.randn(1, 9, 2, 4)).requires_grad_()
              for _ in range(3)]
    assert torch.autograd.gradcheck(
        lambda q, k, v: ck.flash_attention_with_lse(q, k, v, causal),
        leaves, eps=1e-6, atol=1e-7)


def test_bf16_plain_bwd_rounds_like_jax():
    """The plain backward casts p to do's dtype and ds to q's before the
    gradient products, as the Pallas kernels do: in bf16 it tracks the
    JAX interpret-mode backward to bf16 precision."""
    q, k, v, do = _arrays(1, 256, 2, 64, seed=5)
    bf = [jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)]
    _, vjp = jax.vjp(lambda q, k, v: pk.flash_attention(
        q, k, v, block_q=128, block_k=128, interpret=True), *bf)
    j_grads = vjp(jnp.asarray(do, jnp.bfloat16))
    tq, tk, tv, tdo = (t.to(torch.bfloat16) for t in _torch([q, k, v, do]))
    out, lse = ck.flash_attention_with_lse(tq, tk, tv)
    t_grads = ck.flash_attention_bwd(tq, tk, tv, out, lse, tdo)
    for g, r in zip(t_grads, j_grads):
        assert g.dtype == torch.bfloat16
        r = np.asarray(r.astype(jnp.float32))
        err = np.abs(g.float().numpy() - r).max() / np.abs(r).max()
        assert err < 2e-2


def test_cpu_tensors_launch_nothing():
    ck.reset_launch_counts()
    leaves = _torch(_arrays(1, 64, 2, 32, seed=4)[:3], grad=True)
    out, lse = ck.flash_attention_with_lse(*leaves)
    torch.autograd.grad(out.sum() + lse.sum(), leaves)
    q, k, v = (t.detach() for t in leaves)
    delta = ck.flash_bwd_delta(out.detach(), q)
    ck.flash_bwd_dkvdq(q, k, v, q, lse.detach(), delta)
    ck.flash_bwd_dq(q, k, v, q, lse.detach(), delta)
    ck.flash_bwd_dkv(q, k, v, q, lse.detach(), delta)
    assert all(n == 0 for n in ck.LAUNCHES.values()), ck.LAUNCHES


@pytest.mark.parametrize('case', ['do_shape', 'do_dtype', 'lse_dtype',
                                  'delta_shape', 'do_strided',
                                  'delta_strided', 'head_dim'])
def test_bwd_input_checks_raise(case):
    q, k, v, do = _torch(_arrays(1, 64, 2, 64, seed=9))
    lse = torch.zeros(1, 2, 64)
    delta = torch.zeros(1, 2, 64)
    if case == 'do_shape':
        do = do[:, :32].contiguous()
    elif case == 'do_dtype':
        do = do.to(torch.bfloat16)
    elif case == 'lse_dtype':
        lse = lse.double()
    elif case == 'delta_shape':
        delta = torch.zeros(1, 64, 2)
    elif case == 'do_strided':
        do = torch.zeros(1, 64, 2, 128)[..., :64]
    elif case == 'delta_strided':
        delta = torch.zeros(1, 64, 2).transpose(1, 2)
    elif case == 'head_dim':
        q = k = v = do = torch.zeros(1, 64, 2, 48)
    with pytest.raises((ValueError, TypeError)):
        ck._check_flash_bwd_inputs(q, k, v, do, lse, delta)


# the merged backward's variant and query tile (the unit of its dq
# counters) for each (dtype, D): the wgmma kernel takes 64 queries a step
@pytest.mark.parametrize('dtype, D, variant, q_tile', [
    (torch.bfloat16, 32, 'mma_sync', 32), (torch.bfloat16, 64, 'wgmma', 64),
    (torch.bfloat16, 128, 'wgmma', 64), (torch.float32, 32, 'fma', 32),
    (torch.float32, 64, 'fma', 32), (torch.float32, 128, 'fma', 32)])
def test_merged_variant_and_query_tile(dtype, D, variant, q_tile):
    assert ck.flash_variant(dtype, D) == variant
    assert ck._merged_q_tile(torch.empty(1, 8, 1, D, dtype=dtype)) == q_tile


@pytest.mark.parametrize('dtype, D', [(torch.float16, 64),
                                      (torch.bfloat16, 96)])
def test_merged_backward_refuses_what_no_kernel_takes(dtype, D):
    q = torch.empty(1, 8, 1, D, dtype=dtype)
    with pytest.raises(ValueError):
        ck.flash_bwd_counters(q)
    with pytest.raises(ValueError):
        ck.merged_bwd_bytes(q)


# (B, H, T, D, dtype) -> the counter buffer: one int32 per (b*h, query
# tile), 64-query tiles for the wgmma kernel, 32 for the others
@pytest.mark.parametrize('B, H, T, D, dtype, shape', [
    (1, 1, 1, 128, torch.bfloat16, (1, 1)),
    (2, 3, 130, 64, torch.bfloat16, (6, 3)),
    (4, 8, 2048, 128, torch.bfloat16, (32, 32)),
    (16, 8, 2000, 128, torch.bfloat16, (128, 32)),
    (2, 3, 130, 64, torch.float32, (6, 5)),
    (2, 2, 100, 32, torch.bfloat16, (4, 4))])
def test_counter_buffer_shape_and_dtype(B, H, T, D, dtype, shape):
    q = torch.empty(B, T, H, D, dtype=dtype)
    ctr = ck.flash_bwd_counters(q)
    assert tuple(ctr.shape) == shape
    assert ctr.dtype == torch.int32 and ctr.device == q.device
    assert not ctr.any()
    ck._check_counters(q, ctr)
    for bad in (ctr[:, :-1], ctr.long(), torch.zeros(shape[0] + 1,
                                                     shape[1],
                                                     dtype=torch.int32)):
        with pytest.raises(ValueError):
            ck._check_counters(q, bad)


@pytest.mark.parametrize('B, T, H, D', [(2, 128, 3, 64), (1, 130, 2, 128),
                                        (1, 1, 1, 64)])
def test_dq_tiles_in_register_order_map_back(B, T, H, D):
    """The wgmma kernel's dq buffer: per (b*h, 64-query tile), [consumer]
    [register][thread], register 4j + 2hi + lo of thread 32w + 4g + t
    holding query 16w + 8hi + g and column consumer * D/2 + 8j + 2t + lo."""
    rng = np.random.RandomState(T + D)
    dq = rng.randn(B, T, H, D).astype('float32')
    n_q = -(-T // 64)
    tiles = np.zeros((B, H, n_q, 2, D // 4, 128), 'float32')
    for cw in range(2):
        for r in range(D // 4):
            j, hi, lo = r // 4, (r // 2) % 2, r % 2
            for th in range(128):
                w, g, t = th // 32, (th % 32) // 4, th % 4
                col = cw * D // 2 + 8 * j + 2 * t + lo
                for it in range(n_q):
                    q = it * 64 + 16 * w + 8 * hi + g
                    if q < T:
                        tiles[:, :, it, cw, r, th] = dq[:, q, :, col]
    got = ck.dq_from_tiles(torch.from_numpy(tiles.reshape(-1)), B, T, H, D,
                           torch.float32)
    assert got.shape == (B, T, H, D) and got.is_contiguous()
    np.testing.assert_array_equal(got.numpy(), dq)


def test_cpu_tensors_take_the_plain_merged_backward_with_counters():
    ck.reset_launch_counts()
    q, k, v, do = _torch(_arrays(1, 64, 2, 64, seed=6))
    out, lse = ck.flash_attention_with_lse(q, k, v)
    delta = ck.flash_bwd_delta(out, do)
    got = ck.flash_bwd_dkvdq(q, k, v, do, lse, delta,
                             counters=ck.flash_bwd_counters(q))
    ref = ck.flash_bwd_reference(q, k, v, do, lse, delta)
    for g, r in zip(got, ref):
        assert torch.equal(g, r)
    assert all(n == 0 for n in ck.LAUNCHES.values()), ck.LAUNCHES


# what the merged kernel allocates for its f32 dq sums, which the route's
# byte cap reads: whole 64-query tiles for the wgmma variant. The
# flagship's long-context step (batch 5, seq 32768, 8 heads of 128) needs
# 640 MiB, past the 512 MiB cap. Computed from meta tensors: nothing is
# allocated.
@pytest.mark.parametrize('B, H, T, D, dtype, nbytes, over_cap', [
    (16, 8, 2048, 128, torch.bfloat16, 16 * 8 * 2048 * 128 * 4, False),
    (2, 3, 130, 64, torch.bfloat16, 2 * 3 * 192 * 64 * 4, False),
    (2, 3, 130, 64, torch.float32, 2 * 3 * 130 * 64 * 4, False),
    (2, 3, 130, 32, torch.bfloat16, 2 * 3 * 130 * 32 * 4, False),
    (5, 8, 32768, 128, torch.bfloat16, 640 * 2 ** 20, True)])
def test_merged_bwd_bytes(B, H, T, D, dtype, nbytes, over_cap):
    q = torch.empty(B, T, H, D, dtype=dtype, device='meta')
    assert ck.merged_bwd_bytes(q) == nbytes
    assert (nbytes > ck._MERGED_BWD_MAX_SLAB_BYTES) == over_cap


# flash_attention_bwd's route on the card, with every kernel wrapper
# stubbed (meta tensors, nothing allocated): the merged kernel at the
# flagship's training shape, the two-pass kernels at its long-context
# step, and with the merged route switched off
@pytest.mark.parametrize('B, T, merged_on, route', [
    (16, 2048, True, 'merged'), (5, 32768, True, 'two_pass'),
    (16, 2048, False, 'two_pass'), (4, 32768, True, 'merged')])
def test_flash_attention_bwd_routes_past_the_cap(monkeypatch, B, T,
                                                 merged_on, route):
    calls = []

    def stub(name, n_out):
        def fn(q, k, v, do, lse, delta, causal=True):
            calls.append(name)
            assert delta.shape == lse.shape == (B, 8, T)
            outs = tuple(torch.empty_like(q) for _ in range(n_out))
            return outs[0] if n_out == 1 else outs
        return fn

    monkeypatch.setattr(ck, '_on_card', lambda q, what: True)
    monkeypatch.setattr(ck, '_MERGED_BWD', [merged_on])
    monkeypatch.setattr(ck, 'flash_bwd_dkvdq', stub('dkvdq', 3))
    monkeypatch.setattr(ck, 'flash_bwd_dq', stub('dq', 1))
    monkeypatch.setattr(ck, 'flash_bwd_dkv', stub('dkv', 2))
    q = torch.empty(B, T, 8, 128, dtype=torch.bfloat16, device='meta')
    lse = torch.empty(B, 8, T, device='meta')
    grads = ck.flash_attention_bwd(q, q, q, q, lse, q)
    assert len(grads) == 3 and all(g.shape == q.shape for g in grads)
    assert sorted(calls) == (['dkvdq'] if route == 'merged' else
                             ['dkv', 'dq'])
