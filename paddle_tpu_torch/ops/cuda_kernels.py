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
- ``fused_conv``: ``pallas_kernels.py::_fconv_kernel``, a conv or
  depthwise conv with its whole epilogue (folded batch norm, activations,
  residual and broadcast operands) applied on chip before one
  store, in ``csrc/fused_conv.cu``; differentiable through its plain
  version (``_FusedConv``), as ``_fconv_bwd`` differentiates
  ``_fconv_reference``.
"""
import ctypes
import functools
import math

import torch
import torch.nn.functional as F

from . import _build
from .activations import ACTS, ACTS_P, BINS

# kernel name -> launches since the last reset; plain integers, bumped
# only where a kernel is launched
LAUNCHES = {'flash_attn_fwd': 0, 'flash_attn_bwd_dkvdq': 0,
            'flash_attn_bwd_dq': 0, 'flash_attn_bwd_dkv': 0,
            'fused_conv': 0}


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
    LAUNCHES[fn_name] += 1


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
             lse.data_ptr(), B, T, H, D, int(q.dtype == torch.bfloat16),
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
            _bwd_dims(q, causal), q.device, _flash_what(q))
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
            _bwd_dims(q, causal), q.device, _flash_what(q))
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
            (dk.data_ptr(), dv.data_ptr()) + _bwd_dims(q, causal),
            q.device, _flash_what(q))
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


def fused_conv_reference(x, w, aux, kinds, stages, strides, pads,
                         depthwise):
    """Conv + epilogue, plain PyTorch: the counterpart of
    ``pallas_kernels._fconv_reference`` on unpadded operands.

    x [N, H, W, Cin] (NHWC); w [Cout, KH, KW, Cin], or [KH, KW, C] when
    ``depthwise``; ``aux`` per ``kinds`` as above. The conv runs in f32
    on the inputs' values (``F.conv2d``, exact products of bf16 inputs,
    f32 sums), every stage in f32, then one cast: y [N, Ho, Wo, Cout] in
    x's dtype. Differentiable by autograd.
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

    def fetch_aux(i):
        o = aux[i].float()
        if kinds[i] == 't':
            return o
        if kinds[i] == 'nc':
            return o[:, None, None, :]
        if kinds[i] == 's':
            return o.reshape(())
        return o.reshape(1, 1, 1, -1)

    for st in stages:
        y = apply_stage(y, st, fetch_aux)
    return y.to(x.dtype)


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
            'ph', 'pw', 'Ho', 'Wo', 'depthwise', 'is_bf16')])


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


@functools.lru_cache(maxsize=None)
def _encoded_epilogue(kinds, stages):
    """The stage list and aux kinds as ``_FusedConvArgs`` bytes, encoded
    once per distinct epilogue."""
    args = _FusedConvArgs()
    encode_epilogue(args, kinds, stages)
    for i, kind in enumerate(kinds):
        if kind not in _AUX_KINDS:
            raise ValueError("fused_conv: unknown aux kind %r" % (kind,))
        args.aux_kind[i] = _AUX_KINDS.index(kind)
    args.n_aux = len(kinds)
    return bytes(args)


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


def _fused_conv_launch(x, w, aux, kinds, stages, strides, pads, depthwise):
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
    args = _FusedConvArgs.from_buffer_copy(
        _encoded_epilogue(tuple(kinds), tuple(stages)))
    aux = _kernel_aux(x, aux, kinds, N, ho, wo, cout)
    out = torch.empty((N, ho, wo, cout), dtype=x.dtype, device=x.device)
    args.x, args.w, args.out = x.data_ptr(), w.data_ptr(), out.data_ptr()
    for i, a in enumerate(aux):
        args.aux[i] = a.data_ptr()
        args.aux_bf16[i] = int(a.dtype == torch.bfloat16)
    (args.N, args.H, args.W, args.Cin, args.Cout, args.KH, args.KW,
     args.Ho, args.Wo) = N, H, W, cin, cout, kh, kw, ho, wo
    args.sh, args.sw = strides
    args.ph, args.pw = pads
    args.depthwise = int(bool(depthwise))
    args.is_bf16 = int(x.dtype == torch.bfloat16)
    _launch('fused_conv', 'fused_conv', (ctypes.addressof(args),), x.device,
            'N=%d H=%d W=%d Cin=%d Cout=%d K=%dx%d stride=%s pad=%s %s%s'
            % (N, H, W, cin, cout, kh, kw, tuple(strides), tuple(pads),
               x.dtype, ' depthwise' if depthwise else ''))
    return out


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


def fused_conv(x, w, aux, kinds, stages, strides, pads, depthwise):
    """Conv (or depthwise conv) + epilogue on NHWC operands -> y [N, Ho,
    Wo, Cout] in x's dtype; arguments as :func:`fused_conv_reference`.

    On the card this launches ``csrc/fused_conv.cu`` (x and w bf16 or
    f32; unpadded, bounds-checked input; f32 accumulation; the stages
    on chip; one store). For CPU tensors it runs
    :func:`fused_conv_reference`. Under autograd the gradient is the
    plain version's.
    """
    strides, pads = tuple(strides), tuple(pads)
    if not _on_card(x, 'fused_conv'):
        return fused_conv_reference(x, w, aux, kinds, stages, strides, pads,
                                    depthwise)
    if not (torch.is_grad_enabled() and
            any(t.requires_grad for t in [x, w] + list(aux))):
        return _fused_conv_launch(x, w, aux, kinds, stages, strides, pads,
                                  depthwise)
    meta = (tuple(kinds), tuple(stages), strides, pads, bool(depthwise))
    return _FusedConv.apply(meta, x, w, *aux)
