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

Three choices on the card read the live tuning knobs of the calling
thread (``compiler.tuning.knobs()``, set by a program's tuning entry):
the flash backward's route (``flash_bwd_route``, taken in the forward,
where the entry is live), the fused conv's plan (``conv_max_bn``,
``conv_max_splits``) and the LSTM cell's batch rows a block
(``lstm_batch_tile``).

Ported so far:

- ``flash_attention`` / ``flash_attention_with_lse``: the forward of
  ``pallas_kernels.py::_flash_kernel``, in ``csrc/flash_attn_fwd.cu``
  (a variant per (dtype, D): ``flash_variant``); differentiable
  through both outputs (``_FlashAttention``).
- ``flash_bwd_dkvdq``, ``flash_bwd_dq``, ``flash_bwd_dkv``: the backward
  kernels ``_flash_dkvdq_kernel`` (merged), ``_flash_dq_kernel`` and
  ``_flash_dkv_kernel`` (two-pass), in ``csrc/flash_attn_bwd.cu``;
  ``flash_attention_bwd`` routes between them as
  ``pallas_kernels._flash_bwd_pallas`` does: the merged kernel while its
  f32 dq buffer stays under a cap, the two-pass kernels past it (long
  context). In bf16 at D 64 and 128 all three run on wgmma with TMA
  loads. Every route gives the same bits from run to run: the merged
  kernel adds its dq partials in a fixed order, counted in a scratch
  buffer (``flash_bwd_counters``); the two-pass kernels write each
  gradient once.
- ``fused_conv``: ``pallas_kernels.py::_fconv_kernel``, a conv or
  depthwise conv with its whole epilogue (folded batch norm, activations,
  residual and broadcast operands) applied on chip before one
  store, in ``csrc/fused_conv.cu``; differentiable through its plain
  version (``_FusedConv``), as ``_fconv_bwd`` differentiates
  ``_fconv_reference``. ``fused_conv_plan`` picks the kernel's variant
  and tiling (bf16 with Cin % 64 == 0: wgmma with TMA loads, K split
  across blocks and added in a fixed order where the tiles fall short of
  a wave of the card's SMs).
- ``fused_conv(..., emit_stats=True)``: the same kernel's stats form
  (``_fconv_kernel`` with ``emit_stats``), the conv and the per-channel
  sum and sum of squares of its f32 output for train-mode batch norm;
  differentiable through all three outputs (``_FusedConvStats``), the
  conv's gradients taken in x's dtype with f32 accumulation, as the JAX
  vjp takes them.
- ``fused_lstm_cell``: ``pallas_kernels.py::_lstm_cell_kernel``, one LSTM
  step (the recurrent product and the gates, gate order (c, i, f, o)) in
  ``csrc/lstm_cell.cu`` (wgmma with TMA loads; the f32 product as three
  TF32 products of operands split in the kernel); differentiable through
  ``_FusedLSTMCell``, whose backward is the vjp of the plain version from
  the saved inputs, as ``_lstm_cell_bwd`` is.
"""
import collections
import ctypes
import functools
import math
import threading

import torch
import torch.nn.functional as F

from . import _build
from .activations import ACTS, ACTS_P, BINS

# kernel name -> launches since the last reset; plain integers, bumped
# only where a kernel is launched
LAUNCHES = {'flash_attn_fwd': 0, 'flash_attn_bwd_dkvdq': 0,
            'flash_attn_bwd_dq': 0, 'flash_attn_bwd_dkv': 0,
            'fused_conv': 0, 'fused_conv_stats': 0, 'lstm_cell': 0}


# the fused conv's launches (both forms) by variant (FUSED_CONV_VARIANTS),
# bumped with LAUNCHES
FUSED_CONV_VARIANT_LAUNCHES = {'fma': 0, 'mma_sync': 0, 'wgmma': 0,
                               'stem': 0}

# the serving runtime's worker threads launch concurrently: every bump
# and reset of the counts above holds this lock, so no count is lost
_COUNT_LOCK = threading.Lock()


_TUNING = []


def _knobs():
    """This thread's live tuning knobs (compiler.tuning.knobs()). The
    compiler package imports this module, so tuning is imported at the
    first launch, not here."""
    if not _TUNING:
        from ..compiler import tuning
        _TUNING.append(tuning)
    return _TUNING[0].knobs()


def _count(counts, name):
    with _COUNT_LOCK:
        counts[name] += 1


def reset_launch_counts():
    with _COUNT_LOCK:
        for counts in (LAUNCHES, FUSED_CONV_VARIANT_LAUNCHES):
            for name in counts:
                counts[name] = 0


# ---- flash attention ------------------------------------------------------------
_NEG_INF = -1e30
FLASH_HEAD_DIMS = (32, 64, 128)
# the flash kernels' variant for (dtype, D), the same for the forward and
# the merged backward: wgmma (TMA, rings of tiles in shared memory) for
# bf16 at D 64 and 128, mma.sync for bf16 at D 32, scalar FMA for f32; and
# the forward's code for it in its C entry point (flash_attn_fwd.cu Variant)
FLASH_VARIANTS = {(torch.bfloat16, 32): 'mma_sync',
                  (torch.bfloat16, 64): 'wgmma',
                  (torch.bfloat16, 128): 'wgmma',
                  (torch.float32, 32): 'fma',
                  (torch.float32, 64): 'fma',
                  (torch.float32, 128): 'fma'}
_FWD_VARIANT_CODES = {'fma': 0, 'mma_sync': 1, 'wgmma': 2}


def flash_variant(dtype, D):
    """The flash kernels' variant for inputs of ``dtype`` and head dim
    ``D``; raises for what no variant takes."""
    try:
        return FLASH_VARIANTS[dtype, D]
    except KeyError:
        raise ValueError("flash_attention kernels have no variant for %s at "
                         "head dim %d" % (dtype, D)) from None


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


def _launch(lib, fn_name, args, device, what):
    """Call C entry point ``fn_name`` of kernel library ``lib`` on
    ``device`` and its current stream; raise on a non-zero CUDA error,
    naming ``what`` was launched."""
    fn = getattr(_build.load(lib), fn_name)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = fn(*args, stream)
    if rc != 0:
        raise RuntimeError("%s launch failed with CUDA error %d (%s)"
                           % (fn_name, rc, what))
    _count(LAUNCHES, fn_name)


def _flash_what(q):
    B, T, H, D = q.shape
    return 'B=%d T=%d H=%d D=%d %s' % (B, T, H, D, q.dtype)


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
             lse.data_ptr(), B, T, H, D,
             _FWD_VARIANT_CODES[flash_variant(q.dtype, D)],
             int(bool(causal))), q.device, _flash_what(q))
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
        # the route is taken here, under the caller's tuning entry:
        # autograd runs a CUDA backward on a thread of its own
        ctx.route = _knobs()['flash_bwd_route']
        ctx.set_materialize_grads(False)
        return out, lse

    @staticmethod
    def backward(ctx, g_out, g_lse):
        q, k, v, out, lse = ctx.saved_tensors
        g_out = torch.zeros_like(out) if g_out is None else g_out.contiguous()
        dq, dk, dv = flash_attention_bwd(q, k, v, out, lse, g_out,
                                         ctx.causal, g_lse, route=ctx.route)
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
# merged kernel while what it allocates for dq (merged_bwd_bytes) stays
# under the cap, else the two-pass kernels (the flagship's heads, H 8 and
# D 128, pass it above 131,072 tokens a step); the tuning knob
# flash_bwd_route='two_pass' takes the two-pass kernels under the cap
# too. Both routes are deterministic: the merged kernel adds dq in a
# fixed order, the two-pass kernels write each gradient once.
_MERGED_BWD = [True]
_MERGED_BWD_MAX_SLAB_BYTES = 512 * 1024 * 1024


def _merged_q_tile(q):
    """The merged kernel's query tile, the unit of its dq counters (the C
    side's merged_q_tile): 64 for the wgmma variant, else 32."""
    return 64 if flash_variant(q.dtype, q.shape[-1]) == 'wgmma' else 32


def _counters_shape(q):
    B, T, H, _ = q.shape
    return B * H, -(-T // _merged_q_tile(q))


def flash_bwd_counters(q):
    """The merged kernel's scratch: one int32 counter per (b*h, query
    tile), zeroed, on q's device. A block adds its dq partial of a query
    tile when the counter names its turn, then advances it."""
    return torch.zeros(_counters_shape(q), dtype=torch.int32,
                       device=q.device)


def merged_bwd_bytes(q):
    """Bytes the merged kernel allocates for its f32 dq sums: [B, T, H, D],
    or for the wgmma variant whole 64-query tiles ([B*H, ceil(T / 64),
    64 * D], :func:`dq_from_tiles`)."""
    B, T, H, D = q.shape
    if flash_variant(q.dtype, D) == 'wgmma':
        return B * H * -(-T // 64) * 64 * D * 4
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


def _check_counters(q, counters):
    want = _counters_shape(q)
    if (tuple(counters.shape) != want or counters.dtype != torch.int32 or
            counters.device != q.device or not counters.is_contiguous()):
        raise ValueError("flash_attention backward: counters must be a "
                         "contiguous int32 %s on %s, got %s %s on %s"
                         % (want, q.device, tuple(counters.shape),
                            counters.dtype, counters.device))


def dq_from_tiles(acc, B, T, H, D, dtype):
    """The wgmma merged kernel's dq sums -> dq [B, T, H, D] in ``dtype``.

    The kernel adds each (b*h, 64-query tile) partial as one contiguous
    tile of 64 * D f32 values kept in its registers' order: [consumer (2)]
    [register (D / 4)][thread (128)], where register 4 j + 2 hi + lo of
    thread 32 w + 4 g + t holds query 16 w + 8 hi + g and column
    consumer * D / 2 + 8 j + 2 t + lo (the wgmma accumulator layout)."""
    n_q = -(-T // 64)
    tiles = acc.view(B, H, n_q, 2, D // 16, 2, 2, 4, 8, 4)
    out = torch.empty((B, n_q * 64, H, D), dtype=dtype, device=acc.device)
    out.view(B, n_q, 4, 2, 8, H, 2, D // 16, 4, 2).copy_(
        tiles.permute(0, 2, 7, 5, 8, 1, 3, 4, 9, 6))
    return out if n_q * 64 == T else out[:, :T].contiguous()


def flash_bwd_dkvdq(q, k, v, do, lse, delta, causal=True, counters=None):
    """Merged backward (``_flash_dkvdq_kernel``): (dq, dk, dv) from one
    kv-major sweep; the blocks add their dq partials into an f32 buffer
    in a fixed order (:func:`flash_bwd_counters`, allocated here unless
    given), which is cast to q's dtype. CPU tensors run
    :func:`flash_bwd_reference`."""
    if not _on_card(q, 'flash_attention backward'):
        return flash_bwd_reference(q, k, v, do, lse, delta, causal)
    _check_flash_bwd_inputs(q, k, v, do, lse, delta)
    if counters is None:
        counters = flash_bwd_counters(q)
    _check_counters(q, counters)
    B, T, H, D = q.shape
    tiled = flash_variant(q.dtype, D) == 'wgmma'
    # every element is written (the first turn of each tile stores)
    dq_acc = torch.empty(merged_bwd_bytes(q) // 4 if tiled else q.shape,
                         dtype=torch.float32, device=q.device)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    _launch('flash_attn_bwd', 'flash_attn_bwd_dkvdq',
            _bwd_inputs(q, k, v, do, lse, delta) +
            (dq_acc.data_ptr(), dk.data_ptr(), dv.data_ptr(),
             counters.data_ptr()) + _bwd_dims(q, causal) +
            (_merged_q_tile(q),), q.device, _flash_what(q))
    if tiled:
        return dq_from_tiles(dq_acc, B, T, H, D, q.dtype), dk, dv
    return dq_acc.to(q.dtype), dk, dv


def flash_bwd_dq(q, k, v, do, lse, delta, causal=True):
    """Two-pass dq (``_flash_dq_kernel``): q-major, each dq element
    written once in q's dtype. CPU tensors run the plain version."""
    if not _on_card(q, 'flash_attention backward'):
        return flash_bwd_reference(q, k, v, do, lse, delta, causal)[0]
    _check_flash_bwd_inputs(q, k, v, do, lse, delta)
    dq = torch.empty_like(q)
    _launch('flash_attn_bwd', 'flash_attn_bwd_dq',
            _bwd_inputs(q, k, v, do, lse, delta) + (dq.data_ptr(),) +
            _bwd_dims(q, causal), q.device, _flash_what(q))
    return dq


def flash_bwd_dkv(q, k, v, do, lse, delta, causal=True):
    """Two-pass dk/dv (``_flash_dkv_kernel``): kv-major, each dk and dv
    element written once in k's dtype. CPU tensors run the plain
    version."""
    if not _on_card(q, 'flash_attention backward'):
        return flash_bwd_reference(q, k, v, do, lse, delta, causal)[1:]
    _check_flash_bwd_inputs(q, k, v, do, lse, delta)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    _launch('flash_attn_bwd', 'flash_attn_bwd_dkv',
            _bwd_inputs(q, k, v, do, lse, delta) +
            (dk.data_ptr(), dv.data_ptr()) + _bwd_dims(q, causal),
            q.device, _flash_what(q))
    return dk, dv


def flash_attention_bwd(q, k, v, o, lse, do, causal=True, g_lse=None,
                        route=None):
    """Gradients (dq, dk, dv) of flash attention, given its output ``o``,
    its ``lse``, the output cotangent ``do`` and optionally the lse
    cotangent ``g_lse`` [B, H, T]. Counterpart of
    ``pallas_kernels._flash_bwd_pallas``: merged kernel or two-pass
    kernels on the card, the plain backward for CPU tensors. ``route``
    ('merged' or 'two_pass'; None: the live ``flash_bwd_route`` knob)
    asks for a route; the merged kernel runs only under its cap."""
    delta = flash_bwd_delta(o, do, g_lse)
    if not _on_card(q, 'flash_attention backward'):
        return flash_bwd_reference(q, k, v, do, lse, delta, causal)
    if route is None:
        route = _knobs()['flash_bwd_route']
    if route not in ('merged', 'two_pass'):
        raise ValueError("flash_attention_bwd: route must be 'merged' or "
                         "'two_pass', got %r" % (route,))
    if route == 'merged' and _MERGED_BWD[0] and \
            merged_bwd_bytes(q) <= _MERGED_BWD_MAX_SLAB_BYTES:
        return flash_bwd_dkvdq(q, k, v, do, lse, delta, causal)
    dk, dv = flash_bwd_dkv(q, k, v, do, lse, delta, causal)
    return flash_bwd_dq(q, k, v, do, lse, delta, causal), dk, dv


# ---- fused conv + epilogue ------------------------------------------------------
# Stage and aux vocabulary, as pallas_kernels.py's fused_conv_epilogue
# takes it (NHWC):
#   stages: ('affine', i_mul, i_add), ('act', name), ('act_p', name,
#   params), ('scale', s, b, bias_after_scale), ('postmul', s),
#   ('bin', op_type, i_aux, swap)
#   aux kinds: 'c' [1, C] per channel, 'nc' [N, C] per sample and
#   channel, 't' [N, Ho, Wo, C] the whole output, 's' [1, 1] a scalar
FUSED_CONV_MAX_STAGES = 8
FUSED_CONV_MAX_AUX = 8
_AUX_KINDS = ('c', 'nc', 't', 's')
_STAGE_OPS = ('affine', 'act', 'act_p', 'scale', 'postmul', 'bin')
# output rows (pixels) per slot of the stats form's moment slab
# (csrc/fused_conv.cu kStatRows)
FUSED_CONV_STAT_ROWS = 64
_ACT_CODES = {n: i for i, n in enumerate(ACTS)}
_ACT_P_CODES = {n: i for i, n in enumerate(ACTS_P)}
_BIN_CODES = {n: i for i, n in enumerate(BINS)}


def _conv_out_hw(x, w, strides, pads, depthwise):
    kh, kw = (w.shape[0], w.shape[1]) if depthwise else (w.shape[1],
                                                          w.shape[2])
    return ((x.shape[1] + 2 * pads[0] - kh) // strides[0] + 1,
            (x.shape[2] + 2 * pads[1] - kw) // strides[1] + 1)


def apply_stage(y, st, fetch_aux):
    """One epilogue stage on an f32 value; ``fetch_aux(i)`` returns the
    i-th aux operand broadcast-shaped for ``y``. The plain version of
    ``csrc/fused_conv.cu``'s per-element stage interpreter, and of
    ``pallas_kernels._apply_stage``."""
    kind = st[0]
    if kind == 'affine':
        return y * fetch_aux(st[1]) + fetch_aux(st[2])
    if kind == 'act':
        return ACTS[st[1]](y)
    if kind == 'act_p':
        return ACTS_P[st[1]](y, *st[2])
    if kind == 'scale':
        s0, b0, after = st[1], st[2], st[3]
        return y * s0 + b0 if after else (y + b0) * s0
    if kind == 'postmul':
        return y * st[1]
    if kind == 'bin':
        b = fetch_aux(st[2])
        fn = BINS[st[1]]
        return fn(b, y) if st[3] else fn(y, b)
    raise ValueError('unknown epilogue stage %r' % (st,))


def aux_fetcher(aux, kinds):
    """``fetch_aux`` for :func:`apply_stage` on an NHWC value: the i-th
    aux operand in f32, shaped to broadcast against [N, Ho, Wo, C]."""
    def fetch_aux(i):
        o = aux[i].float()
        if kinds[i] == 't':
            return o
        if kinds[i] == 'nc':
            return o[:, None, None, :]
        if kinds[i] == 's':
            return o.reshape(())
        return o.reshape(1, 1, 1, -1)
    return fetch_aux


def fused_conv_reference(x, w, aux, kinds, stages, strides, pads,
                         depthwise, emit_stats=False):
    """Conv + epilogue, plain PyTorch: the counterpart of
    ``pallas_kernels._fconv_reference`` on unpadded operands.

    x [N, H, W, Cin] (NHWC); w [Cout, KH, KW, Cin], or [KH, KW, C] when
    ``depthwise``; ``aux`` per ``kinds`` as above. The conv runs in f32
    on the inputs' values (``F.conv2d``, exact products of bf16 inputs,
    f32 sums), every stage in f32, then one cast: y [N, Ho, Wo, Cout] in
    x's dtype. With ``emit_stats`` it returns (y, sum [Cout], sumsq
    [Cout]): the moments of the f32 conv before any stage and the cast.
    Differentiable by autograd.
    """
    xc = x.float().permute(0, 3, 1, 2)
    if depthwise:
        wc = w.float().permute(2, 0, 1).unsqueeze(1)
        groups = x.shape[3]
    else:
        wc = w.float().permute(0, 3, 1, 2)
        groups = 1
    y = F.conv2d(xc, wc, stride=tuple(strides), padding=tuple(pads),
                 groups=groups).permute(0, 2, 3, 1)
    moments = (y.sum((0, 1, 2)), (y * y).sum((0, 1, 2))) if emit_stats \
        else ()
    fetch_aux = aux_fetcher(aux, kinds)
    for st in stages:
        y = apply_stage(y, st, fetch_aux)
    y = y.to(x.dtype)
    return (y,) + moments if emit_stats else y


# the kernel's variants (csrc/fused_conv.cu Variant, in order): scalar FMA
# (f32, and every depthwise conv), mma.sync with cp.async loads (other
# bf16, and scalar loads where Cin % 8 != 0), wgmma with TMA loads (bf16,
# Cin % 64 == 0, Cout % 8 == 0) and the stem (bf16 with Cin % 8 != 0, the
# 7x7 stem's Cin = 3: its input rows staged in shared memory, mma.sync)
FUSED_CONV_VARIANTS = ('fma', 'mma_sync', 'wgmma', 'stem')
# the wgmma kernel: output rows a tile (a K chunk is 64 channels of one
# tap), most taps (KH * KW); shared memory a block may use
FUSED_CONV_TILE_ROWS = 128
FUSED_CONV_MAX_TAPS = 64
FUSED_CONV_SMEM = 232448
# K splits: one for every this many chunks (every split but the last adds
# its partial tile in its turn, one turn after another: a few
# microseconds each on the H100); at most the conv_max_splits knob
_SPLIT_CHUNKS = 12
_TILE_WIDTHS = (256, 128, 64)

FusedConvPlan = collections.namedtuple('FusedConvPlan', 'variant bn splits')


def _stem_smem_bytes(W, Cin, Cout, KH, KW, Wo, pw):
    """The stem kernel's shared memory (csrc/fused_conv.cu stem_layout),
    or None where it does not take the operands: the A and B tiles over
    K rounded up to 16, the input rows the 128 output pixels of a block
    span, each between zero columns that keep 16-byte stores aligned."""
    if (W * Cin) % 8 or Cout % 8:
        return None
    kp = -(-KH * KW * Cin // 16) * 16
    lda = kp + 8
    rows_out = -(-127 // Wo) + 1
    q = 8
    while q > 1 and (q // 2) * Cin % 8 == 0:
        q //= 2
    pl = -(-pw // q) * q
    pitch = (2 * pl + W) * Cin
    nbytes = (max(128 * lda * 2, 128 * 68 * 4) + 64 * lda * 2 +
              rows_out * KH * pitch * 2)
    return nbytes if nbytes <= FUSED_CONV_SMEM else None


def fused_conv_plan(dtype, N, H, W, Cin, Cout, KH, KW, strides, pads,
                    depthwise, sms, max_bn=None, max_splits=None):
    """The fused conv kernel's variant and tiling for these operands on a
    card of ``sms`` SMs: ``FusedConvPlan(variant, bn, splits)``.

    ``variant`` is one of FUSED_CONV_VARIANTS ('stem' where Cin % 8 != 0
    and the stem kernel takes the shape, else 'mma_sync'). For
    ``'wgmma'``, ``bn`` is the output tile's width: the widest of 256,
    128 and 64, at most ``max_bn``, that Cout needs (one tile covers all
    of Cout up to 256, so each input tile is read once) and that still
    gives half a wave of tiles, else 64 (the small-M convs); ``splits``
    the number of blocks that share an output tile's K: one for every
    _SPLIT_CHUNKS chunks of K, at most ``max_splits``, and no more than
    fill a wave. Other variants: (variant, 0, 1). ``max_bn`` and
    ``max_splits`` default to the live tuning knobs ``conv_max_bn`` and
    ``conv_max_splits`` (untuned: 256 and 4). The rule follows a sweep of
    (bn, splits) at ResNet-50's region shapes at batch 1, 8 and 32 on an
    H100 (PERF.md). The kernel sizes its ring of K chunks from bn.
    """
    if dtype not in (torch.bfloat16, torch.float32):
        raise TypeError("fused_conv kernel takes bfloat16 or float32, got "
                        "%s" % dtype)
    if max_bn is None or max_splits is None:
        live = _knobs()
        max_bn = live['conv_max_bn'] if max_bn is None else max_bn
        max_splits = live['conv_max_splits'] if max_splits is None \
            else max_splits
    if max_bn not in _TILE_WIDTHS or int(max_splits) < 1:
        raise ValueError("fused_conv_plan: max_bn must be one of %s and "
                         "max_splits at least 1, got %r and %r"
                         % (_TILE_WIDTHS, max_bn, max_splits))
    if dtype == torch.float32 or depthwise:
        return FusedConvPlan('fma', 0, 1)
    ho = (H + 2 * pads[0] - KH) // strides[0] + 1
    wo = (W + 2 * pads[1] - KW) // strides[1] + 1
    if Cin % 8 and _stem_smem_bytes(W, Cin, Cout, KH, KW, wo, pads[1]):
        return FusedConvPlan('stem', 0, 1)
    if Cin % 64 or Cout % 8 or KH * KW > FUSED_CONV_MAX_TAPS:
        return FusedConvPlan('mma_sync', 0, 1)
    m_tiles = -(-N * ho * wo // FUSED_CONV_TILE_ROWS)
    widest = min(64 if Cout <= 64 else 128 if Cout <= 128 else 256, max_bn)
    bn = next((b for b in (256, 128) if b <= widest and
               2 * m_tiles * -(-Cout // b) >= sms), 64)
    tiles = m_tiles * -(-Cout // bn)
    chunks = KH * KW * Cin // 64
    splits = max(1, min(chunks // _SPLIT_CHUNKS, int(max_splits),
                        sms // tiles))
    return FusedConvPlan('wgmma', bn, splits)


def fused_conv_workspace(plan, M, Cout):
    """(f32 elements of the split-K workspace, int32 counters) for a
    launch of ``plan`` with M output rows: one 128 x bn tile and one
    counter per output tile where K is split, else (0, 0)."""
    if plan.variant != 'wgmma' or plan.splits <= 1:
        return 0, 0
    tiles = -(-M // FUSED_CONV_TILE_ROWS) * -(-Cout // plan.bn)
    return tiles * FUSED_CONV_TILE_ROWS * plan.bn, tiles


def fused_conv_im2col(KH, KW, strides, pads):
    """The wgmma kernel's TMA im2col parameters for a conv of these taps,
    strides and pads, each {w, h}: (lower, upper, element_strides, taps).
    ``lower`` and ``upper`` bound the positions of an output pixel's
    (0, 0) tap to [lower, size - 1 + upper] along W and H; the load
    starts at output pixel (ho, wo)'s position lower + (wo, ho) *
    ``element_strides`` (the conv's strides), walks the box with those
    strides and reads tap t of each pixel at offsets ``taps[t]``, taps in
    K order. The kernel takes all four as they are."""
    (sh, sw), (ph, pw) = strides, pads
    lower = (-pw, -ph)
    upper = (pw - (KW - 1), ph - (KH - 1))
    taps = tuple((kw, kh) for kh in range(KH) for kw in range(KW))
    return lower, upper, (sw, sh), taps


@functools.lru_cache(maxsize=None)
def _sm_count(index):
    return torch.cuda.get_device_properties(index).multi_processor_count


# split-K counters: per (device, stream), zeroed when made and put back to
# 0 by each output tile's last turn, so the launches on one stream share
# them in order
_SPLIT_COUNTERS = {}


def _split_k_counters(device, n):
    """At least n int32 counters at 0 on ``device``, for a launch on its
    current stream. A graph capture that finds none large enough records
    a zeroed buffer of its own."""
    key = (device, torch.cuda.current_stream(device).cuda_stream)
    buf = _SPLIT_COUNTERS.get(key)
    if buf is None or buf.numel() < n:
        buf = torch.zeros(max(n, 1024), dtype=torch.int32, device=device)
        if not torch.cuda.is_current_stream_capturing():
            _SPLIT_COUNTERS[key] = buf
    return buf


class _FusedConvArgs(ctypes.Structure):
    """``FusedConvArgs`` of csrc/fused_conv.cu, field for field."""
    _fields_ = (
        [('x', ctypes.c_void_p), ('w', ctypes.c_void_p),
         ('out', ctypes.c_void_p),
         ('aux', ctypes.c_void_p * FUSED_CONV_MAX_AUX),
         ('aux_kind', ctypes.c_int * FUSED_CONV_MAX_AUX),
         ('aux_bf16', ctypes.c_int * FUSED_CONV_MAX_AUX),
         ('n_aux', ctypes.c_int)] +
        [(f, ctypes.c_int * FUSED_CONV_MAX_STAGES)
         for f in ('stage_op', 'stage_code', 'stage_a', 'stage_b')] +
        [(f, ctypes.c_float * FUSED_CONV_MAX_STAGES)
         for f in ('stage_p0', 'stage_p1')] +
        [(f, ctypes.c_int) for f in (
            'n_stages', 'N', 'H', 'W', 'Cin', 'Cout', 'KH', 'KW', 'sh', 'sw',
            'ph', 'pw', 'Ho', 'Wo', 'depthwise', 'is_bf16')] +
        [('stats', ctypes.c_void_p)] +
        [(f, ctypes.c_int) for f in ('variant', 'bn', 'splits', 'sms')] +
        [(f, ctypes.c_int * 2) for f in (
            'im2col_lower', 'im2col_upper', 'im2col_stride')] +
        [('im2col_taps', (ctypes.c_int * 2) * FUSED_CONV_MAX_TAPS),
         ('workspace', ctypes.c_void_p), ('counters', ctypes.c_void_p)])


def encode_epilogue(args, kinds, stages):
    """Write the stage list into ``args`` (a ``_FusedConvArgs``) as the
    kernel's opcodes: op, code (activation / binary op / bias order),
    two aux indices or flags, two float parameters."""
    if len(stages) > FUSED_CONV_MAX_STAGES or \
            len(kinds) > FUSED_CONV_MAX_AUX:
        raise ValueError("fused_conv kernel takes at most %d stages and %d "
                         "aux operands, got %d and %d" % (
                             FUSED_CONV_MAX_STAGES, FUSED_CONV_MAX_AUX,
                             len(stages), len(kinds)))
    for i, st in enumerate(stages):
        kind = st[0]
        code, a, b, p0, p1 = 0, 0, 0, 0.0, 0.0
        if kind == 'affine':
            a, b = st[1], st[2]
        elif kind == 'act':
            code = _ACT_CODES[st[1]]
        elif kind == 'act_p':
            code = _ACT_P_CODES[st[1]]
            params = tuple(st[2]) + (0.0, 0.0)
            p0, p1 = params[0], params[1]
        elif kind == 'scale':
            p0, p1, code = st[1], st[2], int(bool(st[3]))
        elif kind == 'postmul':
            p0 = st[1]
        elif kind == 'bin':
            code, a, b = _BIN_CODES[st[1]], st[2], int(bool(st[3]))
        else:
            raise ValueError('unknown epilogue stage %r' % (st,))
        if kind in ('affine', 'bin') and not (
                0 <= a < len(kinds) and (kind == 'bin' or
                                         0 <= b < len(kinds))):
            raise ValueError('epilogue stage %r names a missing aux '
                             'operand' % (st,))
        args.stage_op[i] = _STAGE_OPS.index(kind)
        args.stage_code[i] = code
        args.stage_a[i], args.stage_b[i] = a, b
        args.stage_p0[i], args.stage_p1[i] = p0, p1
    args.n_stages = len(stages)


@functools.lru_cache(maxsize=1024)
def _encoded_launch(kinds, stages, dims, strides, pads, depthwise, dtype,
                    sms, plan, conv_knobs):
    """A launch's arguments but its pointers, as ``_FusedConvArgs`` bytes,
    with its plan (``plan``, or :func:`fused_conv_plan`'s under
    ``conv_knobs`` = (max_bn, max_splits) where None), the split-K
    buffers' sizes (:func:`fused_conv_workspace`) and the launch's
    description for errors: encoded once per distinct shape, epilogue and
    knobs. ``dims``: (N, H, W, Cin, Cout, KH, KW, Ho, Wo)."""
    args = _FusedConvArgs()
    encode_epilogue(args, kinds, stages)
    for i, kind in enumerate(kinds):
        if kind not in _AUX_KINDS:
            raise ValueError("fused_conv: unknown aux kind %r" % (kind,))
        args.aux_kind[i] = _AUX_KINDS.index(kind)
    args.n_aux = len(kinds)
    N, H, W, cin, cout, kh, kw, ho, wo = dims
    (args.N, args.H, args.W, args.Cin, args.Cout, args.KH, args.KW,
     args.Ho, args.Wo) = dims
    args.sh, args.sw = strides
    args.ph, args.pw = pads
    args.depthwise = int(depthwise)
    args.is_bf16 = int(dtype == torch.bfloat16)
    if plan is None:
        plan = fused_conv_plan(dtype, N, H, W, cin, cout, kh, kw, strides,
                               pads, depthwise, sms, *conv_knobs)
    args.variant = FUSED_CONV_VARIANTS.index(plan.variant)
    args.bn, args.splits, args.sms = plan.bn, plan.splits, sms
    lower, upper, stride, taps = fused_conv_im2col(kh, kw, strides, pads)
    args.im2col_lower[:], args.im2col_upper[:] = lower, upper
    args.im2col_stride[:] = stride
    for t, offsets in enumerate(taps[:FUSED_CONV_MAX_TAPS]):
        args.im2col_taps[t][:] = offsets
    what = ('N=%d H=%d W=%d Cin=%d Cout=%d K=%dx%d stride=%s pad=%s %s%s, '
            '%s' % (N, H, W, cin, cout, kh, kw, strides, pads, dtype,
                    ' depthwise' if depthwise else '', plan))
    return (bytes(args), plan, fused_conv_workspace(plan, N * ho * wo, cout),
            what)


def _kernel_aux(x, aux, kinds, n, ho, wo, cout):
    """The aux operands as the kernel reads them: 'c', 'nc' and 's' in
    f32, 't' in f32 or bf16, each contiguous in its kind's shape."""
    shapes = {'c': (1, cout), 'nc': (n, cout), 't': (n, ho, wo, cout),
              's': (1, 1)}
    out = []
    for a, kind in zip(aux, kinds):
        if a.device != x.device:
            raise ValueError("fused_conv: aux on %s, x on %s"
                             % (a.device, x.device))
        if kind != 't' or a.dtype not in (torch.float32, torch.bfloat16):
            a = a.float()
        if tuple(a.shape) != shapes[kind]:
            a = a.reshape(shapes[kind])
        out.append(a.contiguous())
    return out


def _fused_conv_launch(x, w, aux, kinds, stages, strides, pads, depthwise,
                       emit_stats=False, plan=None):
    """Launch the kernel: y, or with ``emit_stats`` (y, slab), the slab
    [2, ceil(M / FUSED_CONV_STAT_ROWS), Cout] f32 of per-slot sums and
    sums of squares of the conv output (M = N * Ho * Wo). ``plan`` (a
    FusedConvPlan) overrides :func:`fused_conv_plan`'s; the kernel
    refuses one that does not take these operands."""
    if x.dim() != 4 or not x.is_contiguous():
        raise ValueError("fused_conv expects a contiguous NHWC x, got shape "
                         "%s" % (tuple(x.shape),))
    if x.dtype not in (torch.bfloat16, torch.float32) or w.dtype != x.dtype:
        raise TypeError("fused_conv kernel takes bfloat16 or float32 x and w "
                        "of one dtype, got %s and %s" % (x.dtype, w.dtype))
    if w.device != x.device or not w.is_contiguous():
        raise ValueError("fused_conv: w must be contiguous on x's device")
    N, H, W, cin = x.shape
    if depthwise:
        if w.dim() != 3 or w.shape[2] != cin:
            raise ValueError("fused_conv: depthwise w must be [KH, KW, %d], "
                             "got %s" % (cin, tuple(w.shape)))
        kh, kw, cout = w.shape[0], w.shape[1], cin
    else:
        if w.dim() != 4 or w.shape[3] != cin:
            raise ValueError("fused_conv: w must be [Cout, KH, KW, %d], got "
                             "%s" % (cin, tuple(w.shape)))
        cout, kh, kw = w.shape[0], w.shape[1], w.shape[2]
    ho, wo = _conv_out_hw(x, w, strides, pads, depthwise)
    if ho <= 0 or wo <= 0:
        raise ValueError("fused_conv: empty output %dx%d" % (ho, wo))
    if max(x.numel(), N * ho * wo * cout) >= 2 ** 31:
        raise ValueError("fused_conv kernel takes tensors under 2**31 "
                         "elements")
    for name, t in (('x', x), ('w', w)):
        if t.data_ptr() % 16:
            raise ValueError("fused_conv: %s must be 16-byte aligned" % name)
    sms = _sm_count(x.device.index if x.device.index is not None
                    else torch.cuda.current_device())
    # the live knobs are part of the cached encoding's key: a tuned run
    # never reuses another entry's plan
    live = _knobs()
    encoded, plan, (ws_elems, n_counters), what = _encoded_launch(
        tuple(kinds), tuple(stages), (N, H, W, cin, cout, kh, kw, ho, wo),
        tuple(strides), tuple(pads), bool(depthwise), x.dtype, sms, plan,
        (live['conv_max_bn'], live['conv_max_splits']))
    args = _FusedConvArgs.from_buffer_copy(encoded)
    aux = _kernel_aux(x, aux, kinds, N, ho, wo, cout)
    out = torch.empty((N, ho, wo, cout), dtype=x.dtype, device=x.device)
    args.x, args.w, args.out = x.data_ptr(), w.data_ptr(), out.data_ptr()
    for i, a in enumerate(aux):
        args.aux[i] = a.data_ptr()
        args.aux_bf16[i] = int(a.dtype == torch.bfloat16)
    workspace = counters = None
    if n_counters:
        # the first split's turn stores its partial, so the workspace needs
        # no zeroing. Both are held until the launch is queued: a buffer
        # freed before it (a graph capture's counters are not cached) is
        # handed to the next allocation, the stats slab, which the kernel
        # would then write over the counters
        workspace = torch.empty(ws_elems, dtype=torch.float32,
                                device=x.device)
        counters = _split_k_counters(x.device, n_counters)
        args.workspace = workspace.data_ptr()
        args.counters = counters.data_ptr()
    slab = None
    if emit_stats:
        slots = -(-N * ho * wo // FUSED_CONV_STAT_ROWS)
        slab = torch.empty((2, slots, cout), dtype=torch.float32,
                           device=x.device)
        args.stats = slab.data_ptr()
    _launch('fused_conv', 'fused_conv_stats' if emit_stats else 'fused_conv',
            (ctypes.addressof(args),), x.device, what)
    _count(FUSED_CONV_VARIANT_LAUNCHES, plan.variant)
    return out if slab is None else (out, slab)


class _FusedConv(torch.autograd.Function):
    """The kernel forward, with the gradient of the plain version (the
    counterpart of ``pallas_kernels._fconv``, whose ``_fconv_bwd``
    differentiates ``_fconv_reference``)."""

    @staticmethod
    def forward(ctx, meta, x, w, *aux):
        ctx.meta = meta
        ctx.save_for_backward(x, w, *aux)
        return _fused_conv_launch(x, w, aux, *meta)

    @staticmethod
    def backward(ctx, g):
        x, w, *aux = ctx.saved_tensors
        kinds, stages, strides, pads, depthwise = ctx.meta
        inputs = [t.detach().requires_grad_(need and t.is_floating_point())
                  for t, need in zip([x, w] + aux, ctx.needs_input_grad[1:])]
        wanted = [t for t in inputs if t.requires_grad]
        with torch.enable_grad():
            y = fused_conv_reference(inputs[0], inputs[1], inputs[2:],
                                     kinds, stages, strides, pads, depthwise)
            grads = iter(torch.autograd.grad(y, wanted, g) if wanted else ())
        return (None,) + tuple(next(grads) if t.requires_grad else None
                               for t in inputs)


# ---- the stats form -------------------------------------------------------------
def _stats_kernel(x, w, strides, pads, depthwise):
    """The stats form on the card: (y, sum, sumsq), the slab summed over
    its slots in f32 (as JAX sums its partials outside the kernel)."""
    y, slab = _fused_conv_launch(x, w, (), (), (), strides, pads, depthwise,
                                 emit_stats=True)
    return y, slab[0].sum(0), slab[1].sum(0)


def _stats_reference(x, w, strides, pads, depthwise):
    return fused_conv_reference(x, w, (), (), (), strides, pads, depthwise,
                                emit_stats=True)


def fused_conv_stats_backward(x, w, y, g_y, g_sum, g_sumsq, strides, pads,
                              depthwise, needs=(True, True)):
    """(dx, dw) of the stats form, the vjp of its plain composition: the
    cotangent of the f32 conv is ``g_y + g_sum[c] + 2 * conv * g_sumsq[c]``
    (the moments are sums over every output pixel), in f32, with the saved
    output ``y`` standing for the conv (it is the conv in f32; under AMP
    rounded to bf16, as the cotangent itself is before the bf16 gradient
    convs). It goes back to x's dtype and through the conv's input and
    weight gradients, accumulated in f32. ``needs`` says which of dx, dw
    to compute; a None cotangent adds nothing."""
    d = _acc(torch.zeros_like(y) if g_y is None else g_y)
    if g_sum is not None:
        d = d + g_sum
    if g_sumsq is not None:
        d = d + 2.0 * _acc(y) * g_sumsq
    xc = x.permute(0, 3, 1, 2)
    wc = w.permute(2, 0, 1).unsqueeze(1) if depthwise else \
        w.permute(0, 3, 1, 2)
    gx, gw, _ = torch.ops.aten.convolution_backward(
        d.to(x.dtype).permute(0, 3, 1, 2), xc, wc, None, list(strides),
        list(pads), [1, 1], False, [0, 0], x.shape[3] if depthwise else 1,
        [bool(needs[0]), bool(needs[1]), False])
    if gx is not None:
        gx = gx.permute(0, 2, 3, 1)
    if gw is not None:
        gw = gw[:, 0].permute(1, 2, 0) if depthwise else \
            gw.permute(0, 2, 3, 1)
    return gx, gw


class _FusedConvStats(torch.autograd.Function):
    """The stats form with its gradient through y and both moments: the
    counterpart of ``pallas_kernels._fconv`` with ``emit_stats``, whose
    ``_fconv_bwd`` is the vjp of ``_fconv_reference`` (XLA's conv vjp).
    ``forward(x, w, strides, pads, depthwise) -> (y, sum, sumsq)`` is the
    kernel on the card and the plain version on the CPU; a test may pass
    a deliberately wrong one as a control."""

    @staticmethod
    def forward(ctx, meta, forward, x, w):
        y, s, ss = forward(x, w, *meta)
        ctx.meta = meta
        ctx.save_for_backward(x, w, y)
        ctx.set_materialize_grads(False)
        return y, s, ss

    @staticmethod
    def backward(ctx, g_y, g_sum, g_sumsq):
        x, w, y = ctx.saved_tensors
        gx, gw = fused_conv_stats_backward(
            x, w, y, g_y, g_sum, g_sumsq, *ctx.meta,
            needs=ctx.needs_input_grad[2:4])
        return None, None, gx, gw


def fused_conv(x, w, aux, kinds, stages, strides, pads, depthwise,
               emit_stats=False):
    """Conv (or depthwise conv) + epilogue on NHWC operands -> y [N, Ho,
    Wo, Cout] in x's dtype; arguments as :func:`fused_conv_reference`.
    With ``emit_stats`` (no aux operands or stages): (y, sum [Cout],
    sumsq [Cout]), the moments of the f32 conv, in f32.

    On the card this launches ``csrc/fused_conv.cu`` (x and w bf16 or
    f32; unpadded, bounds-checked input; f32 accumulation; the stages
    on chip; one store), the stats form as ``fused_conv_stats``. For CPU
    tensors it runs :func:`fused_conv_reference`. Under autograd the
    gradient is the plain version's; the stats form's, on either device,
    is :func:`fused_conv_stats_backward` (``_FusedConvStats``).
    """
    strides, pads = tuple(strides), tuple(pads)
    if emit_stats and (aux or kinds or stages):
        raise ValueError("fused_conv: the stats form takes no epilogue "
                         "stages or aux operands")
    on_card = _on_card(x, 'fused_conv')
    grad = torch.is_grad_enabled() and any(
        t.requires_grad for t in [x, w] + list(aux))
    if emit_stats:
        forward = _stats_kernel if on_card else _stats_reference
        if not grad:
            return forward(x, w, strides, pads, bool(depthwise))
        return _FusedConvStats.apply((strides, pads, bool(depthwise)),
                                     forward, x, w)
    if not on_card:
        return fused_conv_reference(x, w, aux, kinds, stages, strides, pads,
                                    depthwise)
    if not grad:
        return _fused_conv_launch(x, w, aux, kinds, stages, strides, pads,
                                  depthwise)
    meta = (tuple(kinds), tuple(stages), strides, pads, bool(depthwise))
    return _FusedConv.apply(meta, x, w, *aux)


# ---- fused LSTM cell ------------------------------------------------------------
# Unlike the JAX wrapper, this one has no size cap: pallas_kernels.py
# skips the kernel when its operands pass 10 MiB, a limit of the TPU's
# VMEM and not part of the function. The card takes the kernel wherever
# ops/rnn_ops.py's fused_ok holds; the results are the same either way.
_LSTM_DTYPES = (torch.float32, torch.bfloat16, torch.float16)


def _lstm_acc(*ts):
    """The gate math's dtype: f32, or f64 where an operand is f64 (the
    plain version only, for gradient checks)."""
    return torch.float64 if any(t.dtype == torch.float64 for t in ts) \
        else torch.float32


def _lstm_dot_dtype(r_prev, w):
    """The recurrent product's operand dtype, as the Pallas kernel's
    ``dot_general`` takes it: bf16 when both operands are bf16, else
    their promotion, with fp16 upcast to f32 (the MXU has no fp16 path;
    the card's kernel has none either)."""
    if r_prev.dtype == torch.bfloat16 and w.dtype == torch.bfloat16:
        return torch.bfloat16
    return _lstm_acc(r_prev, w)


def lstm_cell_reference(xg, r_prev, c_prev, w):
    """One LSTM step, plain PyTorch. Mirrors
    ``pallas_kernels._lstm_cell_reference`` under the kernel's dtype
    contract: xg [B, 4H], r_prev and c_prev [B, H], w [H, 4H]; the
    product at the operands' precision (bf16 products are exact in f32)
    with f32 sums, the gates in f32, gate order (candidate, input,
    forget, output); h in r_prev's dtype, c in c_prev's."""
    acc = _lstm_acc(xg, r_prev, c_prev, w)
    dot = _lstm_dot_dtype(r_prev, w)
    g = xg.to(acc) + torch.matmul(r_prev.to(dot).to(acc),
                                  w.to(dot).to(acc))
    gc, gi, gf, go = g.chunk(4, dim=-1)
    c = torch.tanh(gc) * torch.sigmoid(gi) + \
        c_prev.to(acc) * torch.sigmoid(gf)
    h = torch.sigmoid(go) * torch.tanh(c)
    return h.to(r_prev.dtype), c.to(c_prev.dtype)


def lstm_cell_backward(xg, r_prev, c_prev, w, g_h, g_c):
    """(dxg, dr_prev, dc_prev, dw): the vjp of :func:`lstm_cell_reference`
    at the saved inputs, for the cotangents of h and c, in f32 (each
    gradient returned in its input's dtype). Written out by hand rather
    than through a second autograd graph: one recomputed product, the
    gate derivatives, and two products for dr_prev and dw. The
    counterpart of ``pallas_kernels._lstm_cell_bwd`` (``jax.vjp`` of the
    reference); JAX has no backward kernel for the cell."""
    acc = _lstm_acc(xg, r_prev, c_prev, w)
    dot = _lstm_dot_dtype(r_prev, w)
    r = r_prev.to(dot).to(acc)
    wa = w.to(dot).to(acc)
    gc, gi, gf, go = (xg.to(acc) + torch.matmul(r, wa)).chunk(4, dim=-1)
    cand, i, f, o = (torch.tanh(gc), torch.sigmoid(gi), torch.sigmoid(gf),
                     torch.sigmoid(go))
    cp = c_prev.to(acc)
    tc = torch.tanh(cand * i + cp * f)
    gh = g_h.to(acc)
    dc = g_c.to(acc) + gh * o * (1 - tc * tc)
    dg = torch.cat([dc * i * (1 - cand * cand), dc * cand * i * (1 - i),
                    dc * cp * f * (1 - f), gh * tc * o * (1 - o)], dim=-1)
    return (dg.to(xg.dtype), torch.matmul(dg, wa.t()).to(r_prev.dtype),
            (dc * f).to(c_prev.dtype), torch.matmul(r.t(), dg).to(w.dtype))


def _check_lstm_inputs(xg, r_prev, c_prev, w):
    if c_prev.dim() != 2:
        raise ValueError("fused_lstm_cell: c_prev must be [B, H], got %s"
                         % (tuple(c_prev.shape),))
    B, H = c_prev.shape
    for name, t, shape in (('xg', xg, (B, 4 * H)), ('r_prev', r_prev, (B, H)),
                           ('w', w, (H, 4 * H))):
        if tuple(t.shape) != shape:
            raise ValueError("fused_lstm_cell: %s shape %s, expected %s"
                             % (name, tuple(t.shape), shape))
        if t.device != c_prev.device:
            raise ValueError("fused_lstm_cell: %s on %s, c_prev on %s"
                             % (name, t.device, c_prev.device))
    for name, t in (('xg', xg), ('r_prev', r_prev), ('c_prev', c_prev),
                    ('w', w)):
        if t.dtype not in _LSTM_DTYPES:
            raise TypeError("fused_lstm_cell kernel takes float32, bfloat16 "
                            "or float16 operands; %s is %s" % (name, t.dtype))


# r_prev's and w's rows are read by TMA, whose row strides are multiples
# of 16 bytes: the kernel takes their depth in multiples of 8 elements
_LSTM_DEPTH_ALIGN = 8


def lstm_padded_depth(H):
    """Hp: H rounded up to a multiple of 8, the depth of the operands that
    the kernel's tensor maps read."""
    return -(-H // _LSTM_DEPTH_ALIGN) * _LSTM_DEPTH_ALIGN


def _aligned16(t):
    t = t.contiguous()
    return t.clone() if t.data_ptr() % 16 else t


def lstm_kernel_operands(r_prev, w, dot):
    """(r [B, Hp], w [Hp, 4Hp]) in ``dot``, contiguous and 16-byte aligned,
    as the kernel's TMA maps read them: the operands themselves (cast)
    where H is a multiple of 8, else copies padded with zeros, gate q of w
    at columns q * Hp. The zero rows and columns add nothing to the
    product."""
    H = r_prev.shape[1]
    Hp = lstm_padded_depth(H)
    r, wk = r_prev.to(dot), w.to(dot)
    if Hp != H:
        r = F.pad(r, (0, Hp - H))
        wk = F.pad(wk.reshape(H, 4, H), (0, Hp - H, 0, 0, 0, Hp - H)) \
            .reshape(Hp, 4 * Hp)
    return _aligned16(r), _aligned16(wk)


def _lstm_cell_kernel(xg, r_prev, c_prev, w, batch_tile=None):
    """The cell on the card: ``csrc/lstm_cell.cu``. Operands are promoted
    here, before the launch: the product's to :func:`_lstm_dot_dtype`
    (:func:`lstm_kernel_operands`), xg and c_prev to f32 (lossless). h
    comes out in r_prev's dtype and c in c_prev's (the kernel writes f32
    or bf16; fp16 is cast after). The f32 product runs on the tensor cores
    as three TF32 products. ``batch_tile``, the batch rows a block (None:
    the live ``lstm_batch_tile`` knob), is 0 for the launcher's rule from
    B and H, or 8, 16, 32 or 64; the launcher refuses any other value."""
    _check_lstm_inputs(xg, r_prev, c_prev, w)
    B, H = c_prev.shape
    dot = _lstm_dot_dtype(r_prev, w)
    r, wk = lstm_kernel_operands(r_prev, w, dot)
    x = xg.float()
    if x.stride(-1) != 1:
        x = x.contiguous()
    c0 = c_prev.float().contiguous()
    h_dt = torch.bfloat16 if r_prev.dtype == torch.bfloat16 \
        else torch.float32
    c_dt = torch.bfloat16 if c_prev.dtype == torch.bfloat16 \
        else torch.float32
    h = torch.empty((B, H), dtype=h_dt, device=c_prev.device)
    c = torch.empty((B, H), dtype=c_dt, device=c_prev.device)
    if batch_tile is None:
        batch_tile = _knobs()['lstm_batch_tile']
    if B and H:
        _launch('lstm_cell', 'lstm_cell',
                (x.data_ptr(), x.stride(0), r.data_ptr(), c0.data_ptr(),
                 wk.data_ptr(), h.data_ptr(), c.data_ptr(), B, H,
                 r.shape[1], int(dot == torch.bfloat16),
                 int(h_dt == torch.bfloat16), int(c_dt == torch.bfloat16),
                 int(batch_tile)),
                c_prev.device, 'B=%d H=%d %s batch_tile=%d'
                % (B, H, dot, batch_tile))
    return h.to(r_prev.dtype), c.to(c_prev.dtype)


class _FusedLSTMCell(torch.autograd.Function):
    """The cell with its gradient: the counterpart of
    ``pallas_kernels._lstm_cell`` (a ``jax.custom_vjp``).
    ``forward(xg, r_prev, c_prev, w) -> (h, c)`` is the kernel on the
    card and the plain version on the CPU; the backward is
    :func:`lstm_cell_backward` from the saved inputs on either device."""

    @staticmethod
    def forward(ctx, forward, xg, r_prev, c_prev, w):
        ctx.save_for_backward(xg, r_prev, c_prev, w)
        return forward(xg, r_prev, c_prev, w)

    @staticmethod
    def backward(ctx, g_h, g_c):
        return (None,) + lstm_cell_backward(*ctx.saved_tensors, g_h, g_c)


def fused_lstm_cell(xg, r_prev, c_prev, w):
    """One LSTM step -> (h [B, H] in r_prev's dtype, c [B, H] in c_prev's):
    the recurrent product and all gates in one launch of
    ``csrc/lstm_cell.cu`` on the card, :func:`lstm_cell_reference` for
    CPU tensors. A dtype or shape the kernel does not take raises on the
    card. Under autograd the gradient is :func:`lstm_cell_backward`
    (``_FusedLSTMCell``). Called from ops/rnn_ops.py::_lstm_scan for
    default-activation, peephole-free, unprojected LSTMs."""
    forward = _lstm_cell_kernel if _on_card(c_prev, 'fused_lstm_cell') \
        else lstm_cell_reference
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (xg, r_prev, c_prev, w)):
        return _FusedLSTMCell.apply(forward, xg, r_prev, c_prev, w)
    return forward(xg, r_prev, c_prev, w)
