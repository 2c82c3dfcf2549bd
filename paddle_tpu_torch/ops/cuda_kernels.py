"""Hand-written CUDA kernels for the port's hot paths.

Counterpart of paddle_tpu/ops/pallas_kernels.py. Each kernel has:

- a wrapper that checks its inputs, allocates its outputs and launches
  the kernel on the current stream, counting the launch in
  ``LAUNCHES``;
- a plain PyTorch version of the same function, which the wrapper runs
  only for tensors that lie on the CPU, and against which the tests and
  ``chip_smoke.py`` hold the kernel.

A CUDA tensor always goes to the kernel: a build or launch failure
raises, it never falls back to the plain version.

Ported so far:

- ``flash_attention`` / ``flash_attention_with_lse``: the forward of
  ``pallas_kernels.py::_flash_kernel``, in ``csrc/flash_attn_fwd.cu``;
  differentiable through both outputs (``_FlashAttention``).
- ``flash_bwd_dkvdq``, ``flash_bwd_dq``, ``flash_bwd_dkv``: the backward
  kernels ``_flash_dkvdq_kernel`` (merged), ``_flash_dq_kernel`` and
  ``_flash_dkv_kernel`` (two-pass), in ``csrc/flash_attn_bwd.cu``;
  ``flash_attention_bwd`` routes between them as
  ``pallas_kernels._flash_bwd_pallas`` does.
"""
import math

import torch

from . import _build

# kernel name -> launches since the last reset; plain integers, bumped
# only where a kernel is launched
LAUNCHES = {'flash_attn_fwd': 0, 'flash_attn_bwd_dkvdq': 0,
            'flash_attn_bwd_dq': 0, 'flash_attn_bwd_dkv': 0}


def reset_launch_counts():
    for name in LAUNCHES:
        LAUNCHES[name] = 0


# ---- flash attention ------------------------------------------------------------
_NEG_INF = -1e30
FLASH_HEAD_DIMS = (32, 64, 128)


def _acc(x):
    """The accumulation dtype of the plain versions: half floats widen to
    f32; f32 (and f64, for gradcheck) stay as they are."""
    return x.float() if x.dtype in (torch.bfloat16, torch.float16) else x


def _causal_mask(T, device):
    pos = torch.arange(T, device=device)
    return pos[:, None] >= pos[None, :]


def flash_attention_reference_with_lse(q, k, v, causal=True):
    """Masked-softmax attention and per-row logsumexp, plain PyTorch.

    Mirrors ``pallas_kernels.attention_reference_with_lse``: q, k, v
    [B, T, H, D] -> (out [B, T, H, D] in q's dtype, lse [B, H, T] f32).
    Scores and lse are f32; the probabilities are cast to q's dtype
    before the product with v, which accumulates in f32.
    """
    scale = 1.0 / math.sqrt(q.shape[-1])
    s = torch.einsum('bqhd,bkhd->bhqk', _acc(q), _acc(k)) * scale
    if causal:
        s = s.masked_fill(~_causal_mask(q.shape[1], q.device), _NEG_INF)
    lse = torch.logsumexp(s, dim=-1)
    p = torch.exp(s - lse[..., None]).to(q.dtype)
    out = torch.einsum('bhqk,bkhd->bqhd', _acc(p), _acc(v))
    return out.to(q.dtype), lse


def _check_flash_inputs(q, k, v):
    if q.dim() != 4:
        raise ValueError("flash_attention expects [B, T, H, D] inputs, got "
                         "shape %s" % (tuple(q.shape),))
    for name, t in (('k', k), ('v', v)):
        if tuple(t.shape) != tuple(q.shape):
            raise ValueError("flash_attention: %s shape %s != q shape %s"
                             % (name, tuple(t.shape), tuple(q.shape)))
        if t.dtype != q.dtype:
            raise TypeError("flash_attention: %s dtype %s != q dtype %s"
                            % (name, t.dtype, q.dtype))
        if t.device != q.device:
            raise ValueError("flash_attention: %s on %s, q on %s"
                             % (name, t.device, q.device))
    if q.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError("flash_attention kernel takes bfloat16 or float32, "
                        "got %s" % q.dtype)
    if q.shape[-1] not in FLASH_HEAD_DIMS:
        raise ValueError("flash_attention kernel takes head dim in %s, got "
                         "%d" % (FLASH_HEAD_DIMS, q.shape[-1]))
    if q.shape[1] > 65535 * 64:
        raise ValueError("flash_attention kernel takes T <= %d, got %d"
                         % (65535 * 64, q.shape[1]))
    for name, t in (('q', q), ('k', k), ('v', v)):
        if not t.is_contiguous():
            raise ValueError("flash_attention: %s must be contiguous" % name)
        if t.data_ptr() % 16:
            raise ValueError("flash_attention: %s must be 16-byte aligned"
                             % name)


def _launch(lib, fn_name, args, q):
    """Call C entry point ``fn_name`` of kernel library ``lib`` on q's
    device and current stream; raise on a non-zero CUDA error."""
    fn = getattr(_build.load(lib), fn_name)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = fn(*args, stream)
    if rc != 0:
        B, T, H, D = q.shape
        raise RuntimeError("%s launch failed with CUDA error %d (B=%d T=%d "
                           "H=%d D=%d %s)" % (fn_name, rc, B, T, H, D,
                                              q.dtype))
    LAUNCHES[fn_name] += 1


def _on_card(q, what):
    """True for a CUDA tensor, False for a CPU one (the plain version
    runs); any other device raises."""
    if q.device.type == 'cpu':
        return False
    if q.device.type != 'cuda':
        raise ValueError("%s: no kernel for device %s" % (what, q.device))
    return True


def _flash_fwd(q, k, v, causal):
    if not _on_card(q, 'flash_attention'):
        return flash_attention_reference_with_lse(q, k, v, causal)
    _check_flash_inputs(q, k, v)
    B, T, H, D = q.shape
    out = torch.empty_like(q)
    lse = torch.empty((B, H, T), dtype=torch.float32, device=q.device)
    _launch('flash_attn_fwd', 'flash_attn_fwd',
            (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
             lse.data_ptr(), B, T, H, D, int(q.dtype == torch.bfloat16),
             int(bool(causal))), q)
    return out, lse


class _FlashAttention(torch.autograd.Function):
    """Flash attention with its backward on the backward kernels: the
    counterpart of ``pallas_kernels._flash_lse`` (a ``jax.custom_vjp``).
    Differentiable through both outputs; the lse cotangent folds into
    delta, as in ``_flash_lse_bwd``."""

    @staticmethod
    def forward(ctx, q, k, v, causal):
        out, lse = _flash_fwd(q, k, v, causal)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal = causal
        ctx.set_materialize_grads(False)
        return out, lse

    @staticmethod
    def backward(ctx, g_out, g_lse):
        q, k, v, out, lse = ctx.saved_tensors
        g_out = torch.zeros_like(out) if g_out is None else g_out.contiguous()
        dq, dk, dv = flash_attention_bwd(q, k, v, out, lse, g_out,
                                         ctx.causal, g_lse)
        return dq, dk, dv, None


def flash_attention_with_lse(q, k, v, causal=True):
    """Flash-attention forward. q, k, v [B, T, H, D] (bf16 or f32,
    contiguous, D in 32/64/128) -> (out [B, T, H, D], lse [B, H, T] f32).

    On the card this launches ``csrc/flash_attn_fwd.cu``; for CPU
    tensors it runs :func:`flash_attention_reference_with_lse`. Under
    autograd the gradient runs :func:`flash_attention_bwd`.
    """
    return _FlashAttention.apply(q, k, v, bool(causal))


def flash_attention(q, k, v, causal=True):
    """:func:`flash_attention_with_lse` without the lse."""
    return flash_attention_with_lse(q, k, v, causal)[0]


# ---- flash attention backward ---------------------------------------------------
# Routing, as pallas_kernels._MERGED_BWD / _MERGED_BWD_MAX_SLAB_BYTES: the
# merged kernel while what it allocates for dq (an f32 buffer of q's
# shape) stays under the cap, else the two-pass kernels. The two-pass
# route is the deterministic one: the merged kernel adds dq with atomics.
_MERGED_BWD = [True]
_MERGED_BWD_MAX_SLAB_BYTES = 512 * 1024 * 1024


def merged_bwd_bytes(q):
    """Bytes the merged kernel allocates for dq: [B, T, H, D] in f32."""
    return q.numel() * 4


def flash_bwd_delta(o, do, g_lse=None):
    """``delta = rowsum(do * o) - g_lse`` as [B, H, T] (f32 for bf16/f32
    inputs): plain PyTorch before the launch, as JAX computes it in XLA
    outside the kernels."""
    delta = (_acc(do) * _acc(o)).sum(-1).transpose(1, 2)
    if g_lse is not None:
        delta = delta - g_lse.to(delta.dtype)
    return delta.contiguous()


def flash_bwd_reference(q, k, v, do, lse, delta, causal=True):
    """Plain backward with the kernels' decomposition (not autograd of
    the forward): p recomputed from lse, ``ds = p * (dp - delta)``, then
    dv = p^T do, dk = ds^T q / sqrt(D), dq = ds k / sqrt(D), with p cast
    to do's dtype and ds to q's dtype before those products, which
    accumulate in f32. Returns (dq, dk, dv) in the inputs' dtypes."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    qa, ka, va, doa = _acc(q), _acc(k), _acc(v), _acc(do)
    s = torch.einsum('bqhd,bkhd->bhqk', qa, ka) * scale
    if causal:
        s = s.masked_fill(~_causal_mask(q.shape[1], q.device), _NEG_INF)
    p = torch.exp(s - lse[..., None].to(s.dtype))
    dp = torch.einsum('bqhd,bkhd->bhqk', doa, va)
    ds = p * (dp - delta[..., None].to(s.dtype))
    p_lp, ds_lp = _acc(p.to(do.dtype)), _acc(ds.to(q.dtype))
    dv = torch.einsum('bhqk,bqhd->bkhd', p_lp, doa)
    dk = torch.einsum('bhqk,bqhd->bkhd', ds_lp, qa) * scale
    dq = torch.einsum('bhqk,bkhd->bqhd', ds_lp, ka) * scale
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _check_flash_bwd_inputs(q, k, v, do, lse, delta):
    _check_flash_inputs(q, k, v)
    B, T, H, _ = q.shape
    if tuple(do.shape) != tuple(q.shape) or do.dtype != q.dtype:
        raise ValueError("flash_attention backward: do %s %s != q %s %s"
                         % (tuple(do.shape), do.dtype, tuple(q.shape),
                            q.dtype))
    for name, t in (('lse', lse), ('delta', delta)):
        if tuple(t.shape) != (B, H, T) or t.dtype != torch.float32:
            raise ValueError("flash_attention backward: %s must be [B, H, "
                             "T] = %s float32, got %s %s"
                             % (name, (B, H, T), tuple(t.shape), t.dtype))
    for name, t in (('do', do), ('lse', lse), ('delta', delta)):
        if t.device != q.device:
            raise ValueError("flash_attention backward: %s on %s, q on %s"
                             % (name, t.device, q.device))
        if not t.is_contiguous():
            raise ValueError("flash_attention backward: %s must be "
                             "contiguous" % name)
        if t.data_ptr() % 16:
            raise ValueError("flash_attention backward: %s must be 16-byte "
                             "aligned" % name)
    if T > 65535 * 32:
        raise ValueError("flash_attention backward kernels take T <= %d, "
                         "got %d" % (65535 * 32, T))


def _bwd_inputs(q, k, v, do, lse, delta):
    return (q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr())


def _bwd_dims(q, causal):
    B, T, H, D = q.shape
    return (B, T, H, D, int(q.dtype == torch.bfloat16), int(bool(causal)))


def flash_bwd_dkvdq(q, k, v, do, lse, delta, causal=True):
    """Merged backward (``_flash_dkvdq_kernel``): (dq, dk, dv) from one
    kv-major sweep; dq accumulates in an f32 buffer by atomics and is
    cast to q's dtype. CPU tensors run :func:`flash_bwd_reference`."""
    if not _on_card(q, 'flash_attention backward'):
        return flash_bwd_reference(q, k, v, do, lse, delta, causal)
    _check_flash_bwd_inputs(q, k, v, do, lse, delta)
    dq_acc = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    _launch('flash_attn_bwd', 'flash_attn_bwd_dkvdq',
            _bwd_inputs(q, k, v, do, lse, delta) +
            (dq_acc.data_ptr(), dk.data_ptr(), dv.data_ptr()) +
            _bwd_dims(q, causal), q)
    return dq_acc.to(q.dtype), dk, dv


def flash_bwd_dq(q, k, v, do, lse, delta, causal=True):
    """Two-pass dq (``_flash_dq_kernel``). CPU tensors run the plain
    version."""
    if not _on_card(q, 'flash_attention backward'):
        return flash_bwd_reference(q, k, v, do, lse, delta, causal)[0]
    _check_flash_bwd_inputs(q, k, v, do, lse, delta)
    dq = torch.empty_like(q)
    _launch('flash_attn_bwd', 'flash_attn_bwd_dq',
            _bwd_inputs(q, k, v, do, lse, delta) + (dq.data_ptr(),) +
            _bwd_dims(q, causal), q)
    return dq


def flash_bwd_dkv(q, k, v, do, lse, delta, causal=True):
    """Two-pass dk/dv (``_flash_dkv_kernel``). CPU tensors run the plain
    version."""
    if not _on_card(q, 'flash_attention backward'):
        return flash_bwd_reference(q, k, v, do, lse, delta, causal)[1:]
    _check_flash_bwd_inputs(q, k, v, do, lse, delta)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    _launch('flash_attn_bwd', 'flash_attn_bwd_dkv',
            _bwd_inputs(q, k, v, do, lse, delta) +
            (dk.data_ptr(), dv.data_ptr()) + _bwd_dims(q, causal), q)
    return dk, dv


def flash_attention_bwd(q, k, v, o, lse, do, causal=True, g_lse=None):
    """Gradients (dq, dk, dv) of flash attention, given its output ``o``,
    its ``lse``, the output cotangent ``do`` and optionally the lse
    cotangent ``g_lse`` [B, H, T]. Counterpart of
    ``pallas_kernels._flash_bwd_pallas``: merged kernel or two-pass
    kernels on the card, the plain backward for CPU tensors."""
    delta = flash_bwd_delta(o, do, g_lse)
    if not _on_card(q, 'flash_attention backward'):
        return flash_bwd_reference(q, k, v, do, lse, delta, causal)
    if _MERGED_BWD[0] and merged_bwd_bytes(q) <= _MERGED_BWD_MAX_SLAB_BYTES:
        return flash_bwd_dkvdq(q, k, v, do, lse, delta, causal)
    dk, dv = flash_bwd_dkv(q, k, v, do, lse, delta, causal)
    return flash_bwd_dq(q, k, v, do, lse, delta, causal), dk, dv
