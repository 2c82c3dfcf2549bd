#!/usr/bin/env python3
"""Smoke run of paddle_tpu_torch on one NVIDIA GPU (written for the H100).

    python3 chip_smoke.py [--seed N]

from the root of a checkout. Phases, each of which raises (and so exits
non-zero) on failure:

1. device: requires CUDA, prints the card's name and power limit, turns
   TF32 off for float32 matrix products and convolutions;
2. build: compiles every CUDA kernel of the port with nvcc, all at once,
   into build/torch_kernels/;
3. kernels: holds each kernel against its plain PyTorch version at the
   serving and training paths' shapes and times kernel, plain version,
   the PyTorch library call for the same function (a yardstick only) and
   the least time the card could take (bound): the flash forward, and
   the three flash backward kernels (merged; two-pass dq and dk/dv);
4. conv kernels: the fused conv kernel (csrc/fused_conv.cu) against its
   plain version at every distinct region shape of ResNet-50 at batch
   32, read from the program after the conv_epilogue_fuse pass, in bf16
   and f32, plus a depthwise shape, each aux kind, a swapped binary op
   and parametric activations, held per element; the kernel with the
   batch-norm shift dropped must fail that check at every shape; times
   kernel, plain version and cuDNN's conv alone (a yardstick only) as
   replays of a CUDA graph, and computes the bound;
5. serving: builds the flagship transformer at full width (6 layers,
   d_model 1024, 8 heads, d_ff 4096, vocab 8192, seq 2048) with random
   weights from the seed, saves it as an inference model, loads it into
   a fresh scope and answers requests of batch 1, 2 and 4 through
   Executor.run, counting kernel launches (forward only, no backward);
   one request is compared with the same program run on the plain
   attention, and two deliberately wrong attentions must fail that
   comparison;
6. ResNet-50 serving: ResNet-50 at full width (3 x 224 x 224, 1000
   classes) with random weights and batch-norm statistics from the seed,
   saved as an inference model, loaded into a fresh scope and served at
   batch 1, 8, 32, 1, 8, 32 through Executor.run and the compiler's
   conv_epilogue_fuse: exactly 53 fused conv launches and no fallback a
   request; a profile of one batch-32 request; one request compared with
   the same program on the plain fused conv, and two deliberately wrong
   kernels must fail that comparison;
7. training: the same flagship at full width and depth, Adam(1e-4)
   .minimize(loss), batch 16: warm-up steps, then timed steps through
   Executor.run on one fixed batch (ms per step, tokens/s), checking
   that the loss is finite and falls and that each step launches one
   forward and one merged backward kernel per layer; a torch.profiler
   trace of one step; one step on the two-pass backward route, whose
   gradients must match the merged route's;
8. gradients: at batch 2, every parameter gradient of one step on the
   kernels against the same step on the plain attention (autograd
   backward), by relative L2 error; two deliberately wrong backwards
   must fail that comparison;
9. summary: a JSON line of the kernels, the card line, and last the
   JSON result line.
"""
import argparse
import json
import os
import re
import subprocess
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))

# NVIDIA H100 SXM data sheet, dense: bf16 tensor cores, f32 without
# tensor cores, HBM3 bandwidth
PEAK_FLOPS = {'bfloat16': 989e12, 'float32': 67e12}
PEAK_BYTES = 3.35e12

FLAGSHIP = dict(vocab=8192, d_model=1024, n_heads=8, n_layers=6, d_ff=4096,
                seq=2048)
REQUEST_BATCHES = [1, 2, 4, 1, 2, 4]
TRAIN_BATCH, TRAIN_WARMUP, TRAIN_STEPS = 16, 2, 10   # bench.py:322, 337
GRAD_BATCH = 2

# kernel vs plain version (plain run in f32 from the same inputs)
TOL = {'bfloat16': {'out': 2e-2, 'lse': 1e-3},
       'float32': {'out': 1e-4, 'lse': 1e-4}}
# whole model, flash kernel vs plain attention, bf16 activations (AMP):
# the logits come out of a bf16 matmul and |logits| stays under 4 at
# these random weights, where one bf16 step is 2**-6; the limit is four
# such steps. Two wrong attentions run as controls and must fail it.
LOGITS_TOL = 4 * 2 ** -6  # max |logits difference|
TOP1_AGREEMENT = 0.95     # share of positions with the same argmax
# backward kernels vs the plain backward on the same inputs: max |err| <=
# tol * max(max |plain|, floor) per gradient and dtype. bf16 rounds p and
# ds before the products and writes bf16 gradients (2**-8 relative per
# rounding, over sums in another order); f32 only reorders f32 sums and
# the merged kernel's atomics. The floor covers gradients near 0, where
# the cancellation in dp - delta is what is left.
BWD_TOL = {'bfloat16': (2e-2, 1e-3), 'float32': (1e-4, 0.1)}
# whole-model gradients, per parameter, relative L2 error: merged vs
# two-pass route, and kernels vs the plain attention's autograd backward.
# Set from the sound readings on the H100 (PERF.md, Findings): merged vs
# two-pass read 5e-3 (atomics reorder dq's sums), the limit is 4x that;
# kernels vs the plain attention read 0.073, as far as the plain bf16
# attention itself is from an f32 one (bf16 rounding through six layers
# under AMP), and the limit is 2x that. The two wrong backwards read 1
# and more.
ROUTE_GRAD_TOL = 2e-2
PLAIN_GRAD_TOL = 0.15
# fused conv kernel vs its plain version on the same inputs, per element:
# |err| <= rel * |plain| + abs * rms(plain), (rel, abs) per dtype. Both
# sides sum the same products in f32 in another order, then bf16 rounds
# once: the two roundings differ by at most one step, 2**-7 of |plain|;
# the abs term holds the reordered sums where the output is near 0. A
# kernel with the batch-norm shift dropped must fail it at every shape.
CONV_TOL = {'bfloat16': (2 ** -7, 2 ** -8), 'float32': (1e-5, 1e-4)}
RESNET_BATCH = 32                      # the kernel phase's shapes
RESNET_REQUESTS = [1, 8, 32, 1, 8, 32]
RESNET_REGIONS = 53                    # fused_conv ops of ResNet-50
# whole ResNet-50, fused kernel vs the plain fused conv, bf16 activations
# (AMP), on one batch-32 request: max |logits difference| over max
# |plain logits|, and the share of images with the same top-1 class. Set
# from the sound reading on the H100 (PERF.md, Findings): 0.0316
# and 0.9375, as far as the plain fused conv itself is from its own run
# with f32 region outputs (0.055, 0.906): bf16 rounding between 53
# regions. The limits are 3x that max difference and 0.8 (six of the 32
# images may change class); the two wrong kernels read 0.92 / 0.03 and
# 265 / 0.
RESNET_LOGITS_TOL = 0.1
RESNET_TOP1 = 0.8


def check(cond, msg):
    if not cond:
        raise RuntimeError('chip_smoke: ' + msg)


def cuda_ms(fn, iters, warmup=2):
    import torch
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(fn, iters=10, reps=5):
    """The card's time for one call of ``fn``: ``iters`` calls captured
    in one CUDA graph, the graph replayed ``reps`` times between CUDA
    events. Unlike :func:`cuda_ms`, the host's launch cost is not
    counted, which matters for kernels of tens of microseconds."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):              # warm-up off the graph
        for _ in range(2):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    del graph
    return start.elapsed_time(end) / (reps * iters)


def flash_bound(B, H, T, D, dtype, causal):
    elem = 2 if dtype == 'bfloat16' else 4
    flops = (2 if causal else 4) * B * H * T * T * D
    nbytes = 4 * B * H * T * D * elem + 4 * B * H * T
    t_ops, t_bytes = flops / PEAK_FLOPS[dtype], nbytes / PEAK_BYTES
    return (max(t_ops, t_bytes) * 1e3,
            'operations' if t_ops >= t_bytes else 'bytes')


def phase_device():
    import torch
    check(torch.cuda.is_available(), 'CUDA is not available')
    card = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print('device: %s (torch %s, CUDA %s); TF32 off' % (
        torch.cuda.get_device_name(0), torch.__version__,
        torch.version.cuda), flush=True)
    return card


def phase_build():
    from paddle_tpu_torch.ops import _build
    t0 = time.perf_counter()
    built = _build.build_all()
    print('build: %s in %.1f s -> %s' % (sorted(built) or 'cached',
                                          time.perf_counter() - t0,
                                          _build.BUILD_DIR), flush=True)


def phase_kernels(seed):
    """Flash forward vs its plain version at the serving path's shapes
    (B*H = 8 and 32, T = 2048, D = 128, causal), plus a non-causal, a
    D = 64 and a ragged case, in bf16 and f32."""
    import torch
    import torch.nn.functional as F
    from paddle_tpu_torch.ops import cuda_kernels as ck
    cases = [(1, 8, 2048, 128, 'bfloat16', True),
             (4, 8, 2048, 128, 'bfloat16', True),
             (4, 8, 2048, 128, 'bfloat16', False),
             (4, 16, 2048, 64, 'bfloat16', True),
             (2, 8, 2000, 128, 'bfloat16', True),
             (1, 8, 2048, 128, 'float32', True),
             (4, 8, 2048, 128, 'float32', True)]
    gen = torch.Generator(device='cuda')
    gen.manual_seed(seed)
    results = {}
    for B, H, T, D, dt, causal in cases:
        dtype = getattr(torch, dt)
        q, k, v = (torch.randn(B, T, H, D, device='cuda', generator=gen)
                   .to(dtype) for _ in range(3))
        out, lse = ck.flash_attention_with_lse(q, k, v, causal)
        torch.cuda.synchronize()
        r_out, r_lse = ck.flash_attention_reference_with_lse(
            q.float(), k.float(), v.float(), causal)
        err_out = (out.float() - r_out).abs().max().item()
        err_lse = (lse - r_lse).abs().max().item()
        tol = TOL[dt]
        kernel_ms = cuda_ms(lambda: ck.flash_attention_with_lse(
            q, k, v, causal), iters=20)
        plain_ms = cuda_ms(lambda: ck.flash_attention_reference_with_lse(
            q, k, v, causal), iters=5, warmup=1)
        qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
        library_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=causal), iters=20)
        bound_ms, bound_by = flash_bound(B, H, T, D, dt, causal)
        print('kernel flash_attn_fwd B=%d H=%d T=%d D=%d %s causal=%s: '
              'max|out err| %.3g (tol %g) max|lse err| %.3g (tol %g); '
              'kernel_ms %.4f plain_ms %.4f library_ms %.4f bound_ms %.4f '
              '(%s)' % (B, H, T, D, dt, causal, err_out, tol['out'],
                        err_lse, tol['lse'], kernel_ms, plain_ms,
                        library_ms, bound_ms, bound_by), flush=True)
        check(err_out <= tol['out'] and err_lse <= tol['lse'],
              'flash_attn_fwd disagrees with its plain version at B=%d H=%d '
              'T=%d D=%d %s causal=%s' % (B, H, T, D, dt, causal))
        results[(B, H, T, D, dt, causal)] = dict(
            max_abs_err=max(err_out, err_lse), ms=kernel_ms,
            plain_ms=plain_ms, library_ms=library_ms, bound_ms=bound_ms,
            bound_by=bound_by)
    return results


def bwd_bound(B, H, T, D, dtype, causal, products, grads):
    """Least time for a backward kernel doing ``products`` T x T x D
    products (5 merged, 3 dq, 4 dk/dv; halved by the causal mask) and
    writing ``grads`` gradients: q, k, v, do, lse and delta read once."""
    elem = 2 if dtype == 'bfloat16' else 4
    flops = (1 if causal else 2) * products * B * H * T * T * D
    nbytes = (4 + grads) * B * H * T * D * elem + 2 * 4 * B * H * T
    t_ops, t_bytes = flops / PEAK_FLOPS[dtype], nbytes / PEAK_BYTES
    return (max(t_ops, t_bytes) * 1e3,
            'operations' if t_ops >= t_bytes else 'bytes')


def phase_bwd_kernels(seed):
    """The three flash backward kernels vs the plain backward at the
    training shape (B 16, H 8, T 2048, D 128, bf16, causal), at B 4 with
    both causal settings, at D 64, at a ragged T 2000, and in f32. Each
    case times the merged kernel, the two-pass kernels, the plain
    backward and SDPA's backward (autograd.grad of
    F.scaled_dot_product_attention), a yardstick only."""
    import torch
    import torch.nn.functional as F
    from paddle_tpu_torch.ops import cuda_kernels as ck
    cases = [(16, 8, 2048, 128, 'bfloat16', True),
             (4, 8, 2048, 128, 'bfloat16', True),
             (4, 8, 2048, 128, 'bfloat16', False),
             (4, 16, 2048, 64, 'bfloat16', True),
             (2, 8, 2000, 128, 'bfloat16', True),
             (4, 8, 2048, 128, 'float32', True)]
    gen = torch.Generator(device='cuda')
    gen.manual_seed(seed + 1)
    results = {}
    for B, H, T, D, dt, causal in cases:
        dtype = getattr(torch, dt)
        q, k, v, do = (torch.randn(B, T, H, D, device='cuda', generator=gen)
                       .to(dtype) for _ in range(4))
        with torch.no_grad():
            out, lse = ck.flash_attention_with_lse(q, k, v, causal)
        delta = ck.flash_bwd_delta(out, do)
        args = (q, k, v, do, lse, delta, causal)
        merged = ck.flash_bwd_dkvdq(*args)
        two_pass = (ck.flash_bwd_dq(*args),) + ck.flash_bwd_dkv(*args)
        torch.cuda.synchronize()
        ref = ck.flash_bwd_reference(*args)
        tol, floor = BWD_TOL[dt]
        errs, rel_l2, ok = {}, {}, True
        for route, got in (('merged', merged), ('two_pass', two_pass)):
            for name, g, r in zip(('dq', 'dk', 'dv'), got, ref):
                err = (g.float() - r.float()).abs().max().item()
                limit = tol * max(r.float().abs().max().item(), floor)
                errs[route, name] = err
                rel_l2[route, name] = ((g.float() - r.float()).norm() /
                                       r.float().norm()).item()
                ok = ok and err <= limit
        del ref, merged, two_pass
        merged_ms = cuda_ms(lambda: ck.flash_bwd_dkvdq(*args), iters=10)
        dq_ms = cuda_ms(lambda: ck.flash_bwd_dq(*args), iters=10)
        dkv_ms = cuda_ms(lambda: ck.flash_bwd_dkv(*args), iters=10)
        plain_ms = cuda_ms(lambda: ck.flash_bwd_reference(*args), iters=2,
                           warmup=1)
        qt, kt, vt = (t.transpose(1, 2).contiguous().requires_grad_()
                      for t in (q, k, v))
        o_sdpa = F.scaled_dot_product_attention(qt, kt, vt,
                                                is_causal=causal)
        do_t = do.transpose(1, 2).contiguous()
        library_ms = cuda_ms(lambda: torch.autograd.grad(
            o_sdpa, (qt, kt, vt), do_t, retain_graph=True), iters=10)
        del qt, kt, vt, o_sdpa, do_t
        bounds = {'merged': bwd_bound(B, H, T, D, dt, causal, 5, 3),
                  'dq': bwd_bound(B, H, T, D, dt, causal, 3, 1),
                  'dkv': bwd_bound(B, H, T, D, dt, causal, 4, 2)}
        print('kernel flash_attn_bwd B=%d H=%d T=%d D=%d %s causal=%s: '
              'max|err| merged dq %.3g dk %.3g dv %.3g, two-pass dq %.3g '
              'dk %.3g dv %.3g (tol %g x max(max|plain|, %g)); merged_ms '
              '%.4f (bound %.4f %s) dq_ms %.4f (bound %.4f) dkv_ms %.4f '
              '(bound %.4f) plain_ms %.4f library_ms %.4f' % (
                  B, H, T, D, dt, causal, errs['merged', 'dq'],
                  errs['merged', 'dk'], errs['merged', 'dv'],
                  errs['two_pass', 'dq'], errs['two_pass', 'dk'],
                  errs['two_pass', 'dv'], tol, floor, merged_ms,
                  bounds['merged'][0], bounds['merged'][1], dq_ms,
                  bounds['dq'][0], dkv_ms, bounds['dkv'][0], plain_ms,
                  library_ms), flush=True)
        print('kernel flash_attn_bwd   relative L2 vs plain: %s' % ', '.join(
            '%s %s %.3g' % (r, n, e) for (r, n), e in sorted(
                rel_l2.items())), flush=True)
        check(ok, 'flash backward kernels disagree with the plain backward '
              'at B=%d H=%d T=%d D=%d %s causal=%s' % (B, H, T, D, dt,
                                                      causal))
        common = dict(plain_ms=plain_ms, library_ms=library_ms)
        results[(B, H, T, D, dt, causal)] = {
            'flash_attn_bwd_dkvdq': dict(
                max_abs_err=max(errs['merged', n] for n in ('dq', 'dk',
                                                            'dv')),
                ms=merged_ms, bound_ms=bounds['merged'][0],
                bound_by=bounds['merged'][1], **common),
            'flash_attn_bwd_dq': dict(
                max_abs_err=errs['two_pass', 'dq'], ms=dq_ms,
                bound_ms=bounds['dq'][0], bound_by=bounds['dq'][1],
                **common),
            'flash_attn_bwd_dkv': dict(
                max_abs_err=max(errs['two_pass', 'dk'],
                                errs['two_pass', 'dv']),
                ms=dkv_ms, bound_ms=bounds['dkv'][0],
                bound_by=bounds['dkv'][1], **common)}
        del q, k, v, do, out, lse, delta, args
        torch.cuda.empty_cache()
    return results


def _feed(bs, seed):
    rng = np.random.RandomState(seed)
    return {'data': rng.randint(0, FLAGSHIP['vocab'],
                                (bs, FLAGSHIP['seq'])).astype('int64'),
            'pos': np.tile(np.arange(FLAGSHIP['seq'], dtype='int64'),
                           (bs, 1))}


def profile_run(run, label, top=8):
    """torch.profiler over one call of ``run``: the device's busy share
    of the host wall, and the kernels taking most device time."""
    import torch
    from torch.profiler import profile, ProfilerActivity
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    events = [e for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = sum(e.device_time for e in events)
    print('profile: %s %.2f ms host wall, %.2f ms device busy '
          '(%.1f%%, %d device events)' % (
              label, wall_us / 1e3, busy_us / 1e3, 100 * busy_us / wall_us,
              len(events)), flush=True)
    by_name, by_kind = {}, {}
    for e in events:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.device_time
        kind = _kernel_kind(e.name)
        by_kind[kind] = by_kind.get(kind, 0.0) + e.device_time
    print('profile:   by kind: %s' % ', '.join(
        '%s %.3f ms (%.1f%%)' % (k, us / 1e3, 100 * us / max(busy_us, 1e-9))
        for k, us in sorted(by_kind.items(), key=lambda kv: -kv[1])),
        flush=True)
    for name, us in sorted(by_name.items(), key=lambda kv: -kv[1])[:top]:
        print('profile:   %8.3f ms %5.1f%%  %s' % (
            us / 1e3, 100 * us / max(busy_us, 1e-9), name[:100]),
            flush=True)


def _kernel_kind(name):
    """A device kernel's kind, for the profile's split of device time."""
    flash = re.search(r'flash_\w+', name)
    if flash:
        return flash.group(0)
    if re.search(r'conv_(bf16|f32|depthwise)_kernel', name):
        return 'fused_conv'
    if 'pool' in name.lower():
        return 'pool'
    if 'memcpy htod' in name.lower():
        return 'copy to the card'
    for kind, keys in (('gemm', ('nvjet', 'gemm', 'xmma', 'cutlass')),
                       ('copy/cast', ('copy',)),
                       ('reduction', ('reduce', 'softmax', 'norm')),
                       ('elementwise', ('elementwise',))):
        if any(k in name.lower() for k in keys):
            return kind
    return 'other'


def phase_serving(seed):
    import torch
    import paddle_tpu_torch as pt
    from paddle_tpu_torch import io as pt_io
    from paddle_tpu_torch.models.fluid_transformer import transformer
    from paddle_tpu_torch.ops import cuda_kernels as ck, misc_ops

    t0 = time.perf_counter()
    main, startup = pt.Program(), pt.Program()
    startup.random_seed = seed
    with pt.unique_name.guard(), pt.program_guard(main, startup):
        _, _, _, logits = transformer(None, **FLAGSHIP)
    exe = pt.Executor()                       # CUDAPlace(0)
    init_scope = pt.Scope()
    exe.run(startup, scope=init_scope)
    os.makedirs(os.path.join(ROOT, 'build'), exist_ok=True)
    with tempfile.TemporaryDirectory(dir=os.path.join(ROOT, 'build')) as d:
        pt_io.save_inference_model(d, ['data', 'pos'], [logits], exe,
                                   main_program=main, scope=init_scope)
        del init_scope
        scope = pt.Scope()
        prog, feed_names, fetch_vars = pt_io.load_inference_model(
            d, exe, scope=scope)
    n_params = sum(v.numel() for k, v in scope.vars.items()
                   if isinstance(v, torch.Tensor))
    torch.cuda.synchronize()
    print('serving: flagship %s, %d parameters, built, saved and loaded in '
          '%.1f s; ops %s' % (FLAGSHIP, n_params, time.perf_counter() - t0,
                              sorted({op.type for op in
                                      prog.global_block().ops})),
          flush=True)

    def serve(bs, s):
        return exe.run(prog, feed=_feed(bs, s), fetch_list=fetch_vars,
                       scope=scope)[0]

    def serve_split(bs, s):
        """One request as a client sees it, split into the run (ops on
        the card, up to the f32 logits on the card) and the fetch (copy
        of the logits to a numpy array on the host)."""
        feed = _feed(bs, s)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        dev, = exe.run(prog, feed=feed, fetch_list=fetch_vars,
                       scope=scope, return_numpy=False)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        out = pt.executor.as_numpy(dev)
        return out, t1 - t0, time.perf_counter() - t1

    for bs in sorted(set(REQUEST_BATCHES)):   # warm-up: cuBLAS, allocator
        serve(bs, seed + 100)
    ck.reset_launch_counts()
    times, tokens = [], 0
    for i, bs in enumerate(REQUEST_BATCHES):
        before = ck.LAUNCHES['flash_attn_fwd']
        out, run_s, fetch_s = serve_split(bs, seed + i)
        n = ck.LAUNCHES['flash_attn_fwd'] - before
        times.append(run_s + fetch_s)
        tokens += bs * FLAGSHIP['seq']
        print('request %d: batch %d, %.2f ms (run %.2f ms, fetch %.2f ms), '
              '%d flash launches, logits %s' % (
                  i, bs, 1e3 * (run_s + fetch_s), 1e3 * run_s,
                  1e3 * fetch_s, n, out.shape), flush=True)
        check(out.shape == (bs, FLAGSHIP['seq'], FLAGSHIP['vocab']),
              'logits shape %s' % (out.shape,))
        check(np.isfinite(out).all(), 'non-finite logits')
        check(n == FLAGSHIP['n_layers'],
              'request %d launched flash_attn_fwd %d times, expected %d'
              % (i, n, FLAGSHIP['n_layers']))
    launches = dict(ck.LAUNCHES)
    check(launches['flash_attn_fwd'] > 0,
          'flash_attn_fwd was never launched on the serving path')
    for name, count in launches.items():
        check(name == 'flash_attn_fwd' or count == 0,
              'serving launched the backward kernel %s %d times'
              % (name, count))
    print('serving: %d requests, %.2f ms per request, %.1f tokens/s '
          '(host clock, logits fetched to host)' % (
              len(times), 1e3 * sum(times) / len(times),
              tokens / sum(times)), flush=True)
    feed4 = _feed(4, seed + 50)
    profile_run(lambda: exe.run(prog, feed=feed4, fetch_list=fetch_vars,
                                scope=scope, return_numpy=False),
                'batch-4 run')

    feed_seed = seed + 1
    kernel_logits = serve(2, feed_seed)
    with misc_ops.attention_for_testing():
        plain_logits = serve(2, feed_seed)

    def agreement(logits):
        return (float(np.abs(logits - plain_logits).max()),
                float((logits.argmax(-1) == plain_logits.argmax(-1)).mean()))

    diff, top1 = agreement(kernel_logits)
    print('serving: batch-2 logits, flash kernel vs plain attention: max '
          '|diff| %.4g (tol %g), max |logits| %.4g, top-1 agreement %.4f '
          '(min %g)' % (diff, LOGITS_TOL, float(np.abs(plain_logits).max()),
                        top1, TOP1_AGREEMENT), flush=True)
    check(diff <= LOGITS_TOL, 'logits differ from the plain path by %g'
          % diff)
    check(top1 >= TOP1_AGREEMENT, 'top-1 agreement %g' % top1)
    # controls: a wrong attention must fail the limits above
    controls = {
        'causal mask dropped': lambda q, k, v, causal:
            misc_ops.plain_attention(q, k, v, False),
        'K/V read from the next head': lambda q, k, v, causal:
            misc_ops.plain_attention(q, k.roll(1, 2), v.roll(1, 2), causal),
    }
    for name, fn in controls.items():
        with misc_ops.attention_for_testing(fn):
            c_diff, c_top1 = agreement(serve(2, feed_seed))
        print('serving: control, %s, vs plain attention: max |diff| %.4g, '
              'top-1 agreement %.4f' % (name, c_diff, c_top1), flush=True)
        check(c_diff > LOGITS_TOL or c_top1 < TOP1_AGREEMENT,
              'the whole-model limits do not catch a control: %s' % name)
    return launches


def _resnet_program(seed, is_test=False):
    """ResNet-50 at full width built with the port's layers: (main,
    startup, probabilities)."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.models.resnet import resnet_imagenet
    main, startup = pt.Program(), pt.Program()
    startup.random_seed = seed
    with pt.unique_name.guard(), pt.program_guard(main, startup):
        img = pt.layers.data(name='img', shape=[3, 224, 224],
                             dtype='float32')
        prob = resnet_imagenet(img, 1000, depth=50, is_test=is_test)
    return main, startup, prob


def resnet_regions():
    """The fused_conv regions of ResNet-50 after conv_epilogue_fuse, as
    {(H, W, Cin, Cout, K, stride, pad, stages): count}; stages name the
    epilogue as the lowering builds it (aux 0, 1: the folded batch norm;
    aux 2: the residual)."""
    import paddle_tpu_torch as pt
    main, _, prob = _resnet_program(0, is_test=True)
    opt = pt.compiler.optimize(main.prune([prob]), fetch_names=[prob.name])
    block = opt.global_block()
    regions = {}
    for op in block.ops:
        if op.type != 'fused_conv':
            continue
        (_, ins, _, attrs), rest = op.attrs['sub_ops'][0], \
            op.attrs['sub_ops'][1:]
        _, cin, h, w = block.var(ins['Input'][0]).shape
        cout, _, k, _ = block.var(ins['Filter'][0]).shape
        stages, cur = [], None
        for t, i, o, _ in rest:
            if t == 'batch_norm':
                stages.append(('affine', 0, 1))
                cur = o['Y'][0]
            elif t == 'elementwise_add':
                stages.append(('bin', t, 2, i['Y'][0] == cur))
                cur = o['Out'][0]
            else:
                stages.append(('act', t))
                cur = o['Out'][0]
        key = (h, w, cin, cout, k, attrs['strides'][0], attrs['paddings'][0],
               tuple(stages))
        regions[key] = regions.get(key, 0) + 1
    return regions


def _taps(size, k, s, p):
    """Along one axis of a conv: (input rows the outputs read, taps that
    land inside the input summed over the outputs). Padding taps read
    nothing and multiply nothing; a stride past the kernel skips rows."""
    out = (size + 2 * p - k) // s + 1
    rows = [o * s - p + i for o in range(out) for i in range(k)]
    inside = [r for r in rows if 0 <= r < size]
    return len(set(inside)), len(inside)


def conv_bound(x, w, aux, out, k, s, p, depthwise):
    """Least time for one fused conv on these tensors: its products
    (2 operations a tap inside the input, per output channel and input
    channel, one input channel a channel when depthwise) at the dtype's
    peak, or the bytes it must move over HBM, whichever is longer: the
    input pixels the conv reads, w, the aux operands and the output,
    each once."""
    N, H, W, cin = x.shape
    cout = out.shape[3]
    read_h, taps_h = _taps(H, k, s, p)
    read_w, taps_w = _taps(W, k, s, p)
    flops = 2 * N * cout * (1 if depthwise else cin) * taps_h * taps_w
    nbytes = (N * read_h * read_w * cin * x.element_size() +
              sum(t.numel() * t.element_size() for t in [w, out] + aux))
    dtype = str(x.dtype).replace('torch.', '')
    t_ops, t_bytes = flops / PEAK_FLOPS[dtype], nbytes / PEAK_BYTES
    return (max(t_ops, t_bytes) * 1e3,
            'operations' if t_ops >= t_bytes else 'bytes')


def conv_err_ratio(got, ref, dtype):
    """max over elements of |got - ref| / (rel |ref| + abs rms(ref)),
    CONV_TOL's (rel, abs) for the dtype: over 1 fails."""
    rel, abs_ = CONV_TOL[dtype]
    ref = ref.float()
    err = (got.float() - ref).abs()
    rms = ref.square().mean().sqrt()
    return (err / (rel * ref.abs() + abs_ * rms)).max().item()


def _conv_inputs(gen, dtype, N, H, W, cin, cout, k, s, p, depthwise, kinds):
    import torch
    dt = getattr(torch, dtype)

    def randn(*shape):
        return torch.randn(*shape, device='cuda', generator=gen)

    ho, wo = (H + 2 * p - k) // s + 1, (W + 2 * p - k) // s + 1
    x = randn(N, H, W, cin).to(dt)
    fan_in = k * k * (1 if depthwise else cin)
    w = (randn(*((k, k, cin) if depthwise else (cout, k, k, cin))) *
         (2.0 / fan_in) ** 0.5).to(dt)
    shapes = {'c': (1, cout), 'nc': (N, cout), 't': (N, ho, wo, cout),
              's': (1, 1)}
    # the folded batch norm: scale and shift at the scale of the conv's
    # output, so every channel's shift shows in it
    aux = [randn(1, cout).abs() + 0.5, randn(1, cout)]
    aux += [randn(*shapes[kd]).to(dt if kd == 't' else torch.float32)
            for kd in kinds[2:]]
    return x, w, aux


def phase_conv_kernels(seed):
    """The fused conv kernel vs its plain version at every distinct
    region shape of ResNet-50 at batch 32, and at extra cases, in bf16
    and f32. Returns the bf16 numbers summed over one batch-32 request
    (each shape times its count of regions)."""
    import torch
    import torch.nn.functional as F
    from paddle_tpu_torch.ops import cuda_kernels as ck
    regions = resnet_regions()
    check(sum(regions.values()) == RESNET_REGIONS,
          'ResNet-50 has %d fused_conv regions, expected %d'
          % (sum(regions.values()), RESNET_REGIONS))
    print('conv kernels: %d distinct region shapes over %d regions' % (
        len(regions), sum(regions.values())), flush=True)
    N = RESNET_BATCH
    cases = [(key, count, False) for key, count in sorted(regions.items())]
    # beyond ResNet-50: depthwise, each aux kind, a swapped binary op,
    # parametric activations
    extra = [
        ((56, 56, 128, 128, 3, 1, 1, (('affine', 0, 1), ('act', 'relu'))),
         True),
        ((28, 28, 128, 128, 3, 1, 1,
          (('affine', 0, 1), ('bin', 'elementwise_mul', 2, False),
           ('act', 'sigmoid'))), False),                       # 'nc'
        ((28, 28, 128, 128, 3, 1, 1,
          (('bin', 'elementwise_sub', 2, True), ('act_p', 'leaky_relu',
                                                 (0.1,)),
           ('act_p', 'swish', (1.3,)))), False),               # 's'
        ((28, 28, 128, 256, 1, 1, 0,
          (('affine', 0, 1), ('bin', 'elementwise_add', 2, False),
           ('act_p', 'relu6', (6.0,)))), False),               # 't', X
    ]
    extra_kinds = [('c', 'c'), ('c', 'c', 'nc'), ('c', 'c', 's'),
                   ('c', 'c', 't')]
    cases += [(key, 0, dw) for key, dw in extra]
    gen = torch.Generator(device='cuda')
    gen.manual_seed(seed + 2)
    totals = dict(ms=0.0, plain_ms=0.0, library_ms=0.0, bound_ms=0.0,
                  max_abs_err=0.0)
    bound_by = {}
    for idx, ((H, W, cin, cout, k, s, p, stages), count, dw) in \
            enumerate(cases):
        kinds = (('c', 'c', 't') if any(st[0] == 'bin' for st in stages)
                 else ('c', 'c')) if idx < len(regions) else \
            extra_kinds[idx - len(regions)]
        for dtype in ('bfloat16', 'float32'):
            x, w, aux = _conv_inputs(gen, dtype, N, H, W, cin, cout, k, s,
                                     p, dw, kinds)
            args = (x, w, aux, kinds, stages, (s, s), (p, p), dw)
            got = ck.fused_conv(*args)
            torch.cuda.synchronize()
            ref = ck.fused_conv_reference(*args)
            err = (got.float() - ref.float()).abs().max().item()
            ratio = conv_err_ratio(got, ref, dtype)
            bound_ms, by = conv_bound(x, w, aux, got, k, s, p, dw)
            # control: the kernel with the batch-norm shift dropped
            shift = [st[2] for st in stages if st[0] == 'affine']
            control = None
            if shift:
                bad_aux = list(aux)
                bad_aux[shift[0]] = torch.zeros_like(aux[shift[0]])
                control = conv_err_ratio(ck.fused_conv(
                    x, w, bad_aux, kinds, stages, (s, s), (p, p), dw), ref,
                    dtype)
            del got, ref
            # CUDA graphs: the host's launch cost would otherwise be part
            # of these 10-300 us calls
            kernel_ms = graph_ms(lambda: ck.fused_conv(*args))
            plain_ms = graph_ms(lambda: ck.fused_conv_reference(*args),
                                iters=3, reps=3)
            # cuDNN's conv alone on the same NHWC operands (channels-last
            # views), a yardstick never called by the port
            xc = x.permute(0, 3, 1, 2)
            wc = (w.permute(2, 0, 1).unsqueeze(1) if dw
                  else w.permute(0, 3, 1, 2))
            library_ms = graph_ms(lambda: F.conv2d(
                xc, wc, stride=s, padding=p, groups=cin if dw else 1))
            print('kernel fused_conv N=%d %dx%d Cin=%d Cout=%d K=%d s=%d '
                  'p=%d%s %s x%d [%s]: max|err| %.3g, err/limit %.3g '
                  '(shift dropped: %s); kernel_ms %.4f plain_ms %.4f '
                  'cudnn_ms %.4f bound_ms %.4f (%s)' % (
                      N, H, W, cin, cout, k, s, p,
                      ' depthwise' if dw else '', dtype, count,
                      ' '.join(st[0] if st[0] != 'act' else st[1]
                               for st in stages), err, ratio,
                      'n/a' if control is None else '%.3g' % control,
                      kernel_ms, plain_ms, library_ms, bound_ms, by),
                  flush=True)
            check(ratio <= 1, 'fused_conv disagrees with its plain version '
                  'at N=%d %dx%d Cin=%d Cout=%d K=%d s=%d %s' % (
                      N, H, W, cin, cout, k, s, dtype))
            check(control is None or control > 1, 'the per-shape limit does '
                  'not catch a dropped batch-norm shift at N=%d %dx%d Cin=%d '
                  'Cout=%d K=%d s=%d %s' % (N, H, W, cin, cout, k, s, dtype))
            if dtype == 'bfloat16' and count:
                totals['ms'] += count * kernel_ms
                totals['plain_ms'] += count * plain_ms
                totals['library_ms'] += count * library_ms
                totals['bound_ms'] += count * bound_ms
                totals['max_abs_err'] = max(totals['max_abs_err'], err)
                bound_by[by] = bound_by.get(by, 0.0) + count * bound_ms
            del x, w, aux, args, xc, wc
    totals['bound_by'] = max(bound_by, key=bound_by.get)
    print('conv kernels: one batch-%d request, bf16, summed over its %d '
          'regions: kernel %.4f ms, plain %.4f ms, cuDNN conv alone %.4f ms, '
          'bound %.4f ms (%s-bound regions hold %.1f%% of it)' % (
              N, RESNET_REGIONS, totals['ms'], totals['plain_ms'],
              totals['library_ms'], totals['bound_ms'], totals['bound_by'],
              100 * bound_by[totals['bound_by']] / totals['bound_ms']),
          flush=True)
    torch.cuda.empty_cache()
    return totals


def _wrong_conv(mode):
    """The fused conv kernel launched with a deliberately wrong epilogue
    (a control for the whole-model comparison)."""
    from paddle_tpu_torch.ops import cuda_kernels as ck

    def fn(x, w, aux, kinds, stages, strides, pads, depthwise):
        aux = list(aux)
        if mode == 'residual stage dropped':
            stages = tuple(st for st in stages if st[0] != 'bin')
        else:                                  # the next channel's affine
            for st in stages:
                if st[0] == 'affine':
                    aux[st[1]] = aux[st[1]].roll(-1, -1)
                    aux[st[2]] = aux[st[2]].roll(-1, -1)
        return ck.fused_conv(x, w, aux, kinds, stages, strides, pads,
                             depthwise)
    return fn


def _image_feed(bs, seed):
    rng = np.random.RandomState(seed)
    return {'img': rng.randn(bs, 3, 224, 224).astype('float32')}


def phase_resnet_serving(seed):
    """Serve ResNet-50 at full width from a saved inference model."""
    import torch
    import paddle_tpu_torch as pt
    from paddle_tpu_torch import io as pt_io
    from paddle_tpu_torch.compiler import passes
    from paddle_tpu_torch.ops import cuda_kernels as ck

    t0 = time.perf_counter()
    main, startup, prob = _resnet_program(seed)
    exe = pt.Executor()                       # CUDAPlace(0)
    init_scope = pt.Scope()
    exe.run(startup, scope=init_scope)
    # random batch-norm affine, and moving statistics as training would
    # leave them: the batch moments of each batch norm's input on one
    # batch of images (the train-mode program's SavedMean and
    # SavedVariance), so activations stay normalised through the 16
    # residual blocks and the logits tell images apart
    gen = torch.Generator(device='cuda')
    gen.manual_seed(seed + 3)
    bns = [op for op in main.global_block().ops if op.type == 'batch_norm']
    for op in bns:
        c = init_scope.raw(op.input('Scale')[0]).shape[0]
        init_scope.set_var(op.input('Scale')[0], torch.rand(
            c, device='cuda', generator=gen) + 0.5)
        init_scope.set_var(op.input('Bias')[0], torch.randn(
            c, device='cuda', generator=gen) * 0.1)
    moments = exe.run(main, feed=_image_feed(RESNET_BATCH, seed + 7),
                      fetch_list=[op.output(s)[0] for op in bns
                                  for s in ('SavedMean', 'SavedVariance')],
                      scope=init_scope, return_numpy=False)
    for op, mean, var in zip(bns, moments[::2], moments[1::2]):
        init_scope.set_var(op.input('Mean')[0], mean.float())
        init_scope.set_var(op.input('Variance')[0], var.float())
    os.makedirs(os.path.join(ROOT, 'build'), exist_ok=True)
    with tempfile.TemporaryDirectory(dir=os.path.join(ROOT, 'build')) as d:
        pt_io.save_inference_model(d, ['img'], [prob], exe,
                                   main_program=main, scope=init_scope)
        del init_scope
        scope = pt.Scope()
        prog, feed_names, fetch_vars = pt_io.load_inference_model(
            d, exe, scope=scope)
    block = prog.global_block()
    logits_name, = [op.input('X')[0] for op in block.ops
                    if op.type == 'softmax']
    n_params = sum(v.numel() for v in scope.vars.values()
                   if isinstance(v, torch.Tensor))
    torch.cuda.synchronize()
    print('resnet: ResNet-50 (3x224x224, 1000 classes), %d parameters and '
          'statistics, built, calibrated, saved and loaded in %.1f s; ops '
          '%s' % (
              n_params, time.perf_counter() - t0,
              sorted({op.type for op in block.ops})), flush=True)

    def serve(bs, s, fetch=None):
        return exe.run(prog, feed=_image_feed(bs, s),
                       fetch_list=fetch or fetch_vars, scope=scope)

    for bs in sorted(set(RESNET_REQUESTS)):   # warm-up: allocator
        serve(bs, seed + 100)
    ck.reset_launch_counts()
    passes.reset_fallback_counts()
    times, images = [], 0
    for i, bs in enumerate(RESNET_REQUESTS):
        feed = _image_feed(bs, seed + i)
        before = ck.LAUNCHES['fused_conv']
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        out, = exe.run(prog, feed=feed, fetch_list=fetch_vars, scope=scope)
        dt = time.perf_counter() - t1
        n = ck.LAUNCHES['fused_conv'] - before
        times.append(dt)
        images += bs
        print('resnet request %d: batch %d, %.2f ms, %.1f images/s, %d fused '
              'conv launches, fallbacks %s' % (i, bs, 1e3 * dt, bs / dt, n,
                                               passes.FALLBACKS), flush=True)
        check(out.shape == (bs, 1000), 'probabilities shape %s'
              % (out.shape,))
        check(np.isfinite(out).all(), 'non-finite probabilities')
        check(np.allclose(out.sum(1), 1.0, atol=1e-3),
              'probabilities do not sum to 1')
        check(n == RESNET_REGIONS, 'request %d launched fused_conv %d times, '
              'expected %d' % (i, n, RESNET_REGIONS))
        check(not passes.FALLBACKS, 'fused_conv fell back: %s'
              % passes.FALLBACKS)
    launches = dict(ck.LAUNCHES)
    for name, count in launches.items():
        check(name == 'fused_conv' or count == 0,
              'ResNet serving launched %s %d times' % (name, count))
    print('resnet: %d requests, %.2f ms per request, %.1f images/s (host '
          'clock, numpy images in, probabilities fetched to host)' % (
              len(times), 1e3 * sum(times) / len(times),
              images / sum(times)), flush=True)
    feed32 = _image_feed(RESNET_BATCH, seed + 50)
    profile_run(lambda: exe.run(prog, feed=feed32, fetch_list=fetch_vars,
                                scope=scope, return_numpy=False),
                'resnet batch-%d request' % RESNET_BATCH)

    fetch = [logits_name] + [v.name for v in fetch_vars]
    kernel_logits, _ = serve(RESNET_BATCH, seed + 1, fetch)
    with passes.conv_for_testing():
        plain_logits, _ = serve(RESNET_BATCH, seed + 1, fetch)
    scale = float(np.abs(plain_logits).max())

    def agreement(logits):
        return (float(np.abs(logits - plain_logits).max()) / scale,
                float((logits.argmax(-1) ==
                       plain_logits.argmax(-1)).mean()))

    diff, top1 = agreement(kernel_logits)
    print('resnet: batch-%d logits, fused kernel vs plain fused conv: max '
          '|diff| / max |logits| %.4g (tol %g), max |logits| %.4g, top-1 '
          'agreement %.4f (min %g)' % (RESNET_BATCH, diff, RESNET_LOGITS_TOL,
                                       scale, top1, RESNET_TOP1), flush=True)
    check(diff <= RESNET_LOGITS_TOL, 'ResNet logits differ from the plain '
          'path by %g of their scale' % diff)
    check(top1 >= RESNET_TOP1, 'ResNet top-1 agreement %g' % top1)
    # where the plain fused conv itself stands: the same request with each
    # region's output kept in f32 (no bf16 rounding between regions)
    with passes.conv_for_testing(
            lambda x, *rest: ck.fused_conv_reference(x.float(), *rest)):
        wide_logits, _ = serve(RESNET_BATCH, seed + 1, fetch)
    for name, got in (('fused kernel', kernel_logits),
                      ('plain fused conv', plain_logits)):
        print('resnet: %s vs the plain fused conv with f32 region outputs: '
              'max |diff| / max |logits| %.4g, top-1 agreement %.4f' % (
                  name, float(np.abs(got - wide_logits).max()) / scale,
                  float((got.argmax(-1) == wide_logits.argmax(-1)).mean())),
              flush=True)
    for name in ('residual stage dropped', "the next channel's BN affine"):
        with passes.conv_for_testing(_wrong_conv(name)):
            c_diff, c_top1 = agreement(serve(RESNET_BATCH, seed + 1,
                                             fetch)[0])
        print('resnet: control, %s, vs plain fused conv: max |diff| / max '
              '|logits| %.4g, top-1 agreement %.4f' % (name, c_diff, c_top1),
              flush=True)
        check(c_diff > RESNET_LOGITS_TOL or c_top1 < RESNET_TOP1,
              'the whole-model limits do not catch a control: %s' % name)
    del scope, prog
    torch.cuda.empty_cache()
    return launches


def _train_feed(bs, seed):
    """One fixed batch of tokens, labels and positions, on the card."""
    import torch
    rng = np.random.RandomState(seed)
    V, S = FLAGSHIP['vocab'], FLAGSHIP['seq']
    arrays = {'data': rng.randint(0, V, (bs, S)),
              'label': rng.randint(0, V, (bs, S, 1)),
              'pos': np.tile(np.arange(S), (bs, 1))}
    return {n: torch.tensor(a.astype('int64'), device='cuda')
            for n, a in arrays.items()}


def _snapshot(scope):
    import torch
    return {n: v.clone() for n, v in scope.vars.items()
            if isinstance(v, torch.Tensor)}


def _restore(scope, snap):
    for n, v in snap.items():
        scope.set_var(n, v.clone())


def _rel_l2(got, ref):
    """Relative L2 error per name: ||got - ref|| / ||ref||."""
    return {n: ((got[n].float() - ref[n].float()).norm() /
                ref[n].float().norm().clamp_min(1e-30)).item()
            for n in ref}


def phase_training(seed, card):
    """Train the flagship at full width and depth through
    Adam.minimize and Executor.run on one fixed batch of 16."""
    import torch
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.models.fluid_transformer import transformer
    from paddle_tpu_torch.ops import cuda_kernels as ck

    t0 = time.perf_counter()
    main, startup = pt.Program(), pt.Program()
    startup.random_seed = seed
    with pt.unique_name.guard(), pt.program_guard(main, startup):
        loss = transformer(None, **FLAGSHIP)[0]
        pt.optimizer.Adam(learning_rate=1e-4).minimize(loss)
    exe = pt.Executor()                       # CUDAPlace(0)
    scope = pt.Scope()
    exe.run(startup, scope=scope)
    grad_names = sorted(v.name for v in main.list_vars()
                        if v.name.endswith('@GRAD'))
    n_layers = FLAGSHIP['n_layers']
    feed = _train_feed(TRAIN_BATCH, seed + 7)
    torch.cuda.synchronize()
    print('training: flagship %s, batch %d, Adam(1e-4), %d parameters, %d '
          'ops, built and initialised in %.1f s' % (
              FLAGSHIP, TRAIN_BATCH, len(grad_names),
              len(main.global_block().ops), time.perf_counter() - t0),
          flush=True)

    losses = []
    torch.cuda.reset_peak_memory_stats()
    for _ in range(TRAIN_WARMUP):
        losses.append(float(exe.run(main, feed=feed, fetch_list=[loss],
                                    scope=scope)[0][0]))
    torch.cuda.synchronize()
    ck.reset_launch_counts()
    outs = []
    t0 = time.perf_counter()
    for _ in range(TRAIN_STEPS):
        out, = exe.run(main, feed=feed, fetch_list=[loss], scope=scope,
                       return_numpy=False)
        outs.append(out)
    torch.cuda.synchronize()
    outs[-1] = outs[-1].item()                # the last loss to the host
    dt = time.perf_counter() - t0
    launches = dict(ck.LAUNCHES)
    losses += [float(o) for o in outs]
    tokens = TRAIN_STEPS * TRAIN_BATCH * FLAGSHIP['seq']
    print('training: %d steps, %.2f ms per step, %.1f tokens/s (host clock, '
          'loss kept on the card, last loss copied to the host), peak '
          'memory %.2f GiB; %s' % (
              TRAIN_STEPS, 1e3 * dt / TRAIN_STEPS, tokens / dt,
              torch.cuda.max_memory_allocated() / 2 ** 30, card),
          flush=True)
    print('training: losses %s' % ', '.join('%.4f' % l for l in losses),
          flush=True)
    print('training: launches over the timed steps %s' % launches,
          flush=True)
    check(all(np.isfinite(losses)), 'non-finite training loss')
    check(losses[-1] < losses[0], 'the loss did not fall: %g -> %g'
          % (losses[0], losses[-1]))
    expect = {'flash_attn_fwd': n_layers * TRAIN_STEPS,
              'flash_attn_bwd_dkvdq': n_layers * TRAIN_STEPS,
              'flash_attn_bwd_dq': 0, 'flash_attn_bwd_dkv': 0,
              'fused_conv': 0}
    check(launches == expect, 'training launches %s, expected %s'
          % (launches, expect))
    profile_run(lambda: exe.run(main, feed=feed, fetch_list=[loss],
                                scope=scope, return_numpy=False),
                'training step')

    # one step on each backward route from the same state
    snap = _snapshot(scope)
    fetch = [loss] + grad_names

    def step_grads():
        _restore(scope, snap)
        ck.reset_launch_counts()
        vals = exe.run(main, feed=feed, fetch_list=fetch, scope=scope,
                       return_numpy=False)
        torch.cuda.synchronize()
        return dict(zip(grad_names, vals[1:])), dict(ck.LAUNCHES)

    merged, _ = step_grads()
    ck._MERGED_BWD[0] = False
    try:
        two_pass, route_launches = step_grads()
    finally:
        ck._MERGED_BWD[0] = True
    errs = _rel_l2(two_pass, merged)
    worst = max(errs, key=errs.get)
    print('training: two-pass route, one step: launches %s; gradients vs '
          'the merged route, max relative L2 %.3g (%s), median %.3g (tol '
          '%g)' % (route_launches, errs[worst], worst,
                   float(np.median(list(errs.values()))), ROUTE_GRAD_TOL),
          flush=True)
    expect = {'flash_attn_fwd': n_layers, 'flash_attn_bwd_dkvdq': 0,
              'flash_attn_bwd_dq': n_layers, 'flash_attn_bwd_dkv': n_layers,
              'fused_conv': 0}
    check(route_launches == expect, 'two-pass step launches %s, expected '
          '%s' % (route_launches, expect))
    check(errs[worst] <= ROUTE_GRAD_TOL, 'two-pass gradients differ from '
          'the merged route by %g (%s)' % (errs[worst], worst))
    _restore(scope, snap)
    del snap, merged, two_pass
    return dict(exe=exe, main=main, loss=loss, scope=scope,
                grad_names=grad_names, launches=launches,
                route_launches=route_launches)


def _wrong_backward(mode):
    """Attention with the kernels' forward and a deliberately wrong
    backward (a control for the whole-model gradient check)."""
    import torch
    from paddle_tpu_torch.ops import cuda_kernels as ck

    class WrongBackward(torch.autograd.Function):
        @staticmethod
        def forward(ctx, q, k, v, causal):
            out, lse = ck.flash_attention_with_lse(q, k, v, causal)
            ctx.save_for_backward(q, k, v, out, lse)
            ctx.causal = causal
            return out

        @staticmethod
        def backward(ctx, g):
            q, k, v, out, lse = ctx.saved_tensors
            dq, dk, dv = ck.flash_attention_bwd(q, k, v, out, lse,
                                                g.contiguous(), ctx.causal)
            if mode == 'dq dropped':
                dq = torch.zeros_like(dq)
            else:                              # dk/dv of the next head
                dk, dv = dk.roll(1, 2), dv.roll(1, 2)
            return dq, dk, dv, None

    return lambda q, k, v, causal: WrongBackward.apply(q, k, v, causal)


def phase_gradients(seed, trained):
    """Every parameter gradient of one batch-2 step on the kernels vs the
    same step on the plain attention (autograd backward)."""
    import torch
    from paddle_tpu_torch.ops import cuda_kernels as ck, misc_ops
    exe, main, scope = trained['exe'], trained['main'], trained['scope']
    grad_names = trained['grad_names']
    feed = _train_feed(GRAD_BATCH, seed + 9)
    snap = _snapshot(scope)

    def step_grads():
        _restore(scope, snap)
        vals = exe.run(main, feed=feed, fetch_list=grad_names, scope=scope,
                       return_numpy=False)
        torch.cuda.synchronize()
        return dict(zip(grad_names, vals))

    ck.reset_launch_counts()
    kernel = step_grads()
    n = FLAGSHIP['n_layers']
    check(ck.LAUNCHES['flash_attn_bwd_dkvdq'] == n,
          'gradient step launches %s' % ck.LAUNCHES)
    with misc_ops.attention_for_testing():
        plain = step_grads()
    errs = _rel_l2(kernel, plain)
    worst = max(errs, key=errs.get)
    print('gradients: batch %d, kernels vs plain attention (autograd '
          'backward), relative L2 per parameter: max %.3g (%s), median '
          '%.3g (tol %g)' % (GRAD_BATCH, errs[worst], worst,
                             float(np.median(list(errs.values()))),
                             PLAIN_GRAD_TOL), flush=True)
    check(errs[worst] <= PLAIN_GRAD_TOL, 'kernel gradients differ from the '
          'plain attention\'s by %g (%s)' % (errs[worst], worst))
    # where the plain attention itself stands: the same step on the plain
    # attention run in f32 (q, k, v widened, the output rounded back)
    with misc_ops.attention_for_testing(
            lambda q, k, v, causal: misc_ops.plain_attention(
                q.float(), k.float(), v.float(), causal).to(q.dtype)):
        wide = step_grads()
    for name, got in (('kernels', kernel), ('plain attention', plain)):
        w_errs = _rel_l2(got, wide)
        w_worst = max(w_errs, key=w_errs.get)
        print('gradients: %s vs the f32 plain attention: max relative L2 '
              '%.3g (%s), median %.3g' % (
                  name, w_errs[w_worst], w_worst,
                  float(np.median(list(w_errs.values())))), flush=True)
    for mode in ('dq dropped', 'dk/dv of the next head'):
        with misc_ops.attention_for_testing(_wrong_backward(mode)):
            c_errs = _rel_l2(step_grads(), plain)
        c_worst = max(c_errs, key=c_errs.get)
        print('gradients: control, %s, vs plain attention: max relative L2 '
              '%.3g (%s)' % (mode, c_errs[c_worst], c_worst), flush=True)
        check(c_errs[c_worst] > PLAIN_GRAD_TOL, 'the gradient limit does '
              'not catch a control: %s' % mode)
    _restore(scope, snap)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument('--seed', type=int, default=0)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print('chip_smoke: CUDA is not available', file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    card = phase_device()
    phase_build()
    kres = phase_kernels(args.seed)
    bres = phase_bwd_kernels(args.seed)
    conv = phase_conv_kernels(args.seed)
    launches = phase_serving(args.seed)
    resnet_launches = phase_resnet_serving(args.seed)
    trained = phase_training(args.seed, card)
    phase_gradients(args.seed, trained)
    # launches: each kernel's count over the path that drives it, read
    # right after that path ran from counts set to 0 (the flash forward:
    # the served requests plus the timed training steps; the fused conv:
    # the served ResNet requests)
    main_shape = kres[(4, 8, 2048, 128, 'bfloat16', True)]
    train_shape = bres[(TRAIN_BATCH, FLAGSHIP['n_heads'], FLAGSHIP['seq'],
                        FLAGSHIP['d_model'] // FLAGSHIP['n_heads'],
                        'bfloat16', True)]
    bwd_src = 'paddle_tpu_torch/csrc/flash_attn_bwd.cu'
    kernels = [dict(
        name='flash_attn_fwd', route='cuda',
        source='paddle_tpu_torch/csrc/flash_attn_fwd.cu',
        replaces='paddle_tpu/ops/pallas_kernels.py:85',
        launches=launches['flash_attn_fwd'] +
        trained['launches']['flash_attn_fwd'], **main_shape)]
    for name, line, count in (
            ('flash_attn_bwd_dkvdq', 310, trained['launches']),
            ('flash_attn_bwd_dq', 245, trained['route_launches']),
            ('flash_attn_bwd_dkv', 273, trained['route_launches'])):
        kernels.append(dict(
            name=name, route='cuda', source=bwd_src,
            replaces='paddle_tpu/ops/pallas_kernels.py:%d' % line,
            launches=count[name], **train_shape[name]))
    # the fused conv: its numbers summed over one batch-32 request's 53
    # regions (bf16, as the served model runs them)
    kernels.append(dict(
        name='fused_conv', route='cuda',
        source='paddle_tpu_torch/csrc/fused_conv.cu',
        replaces='paddle_tpu/ops/pallas_kernels.py:789',
        launches=resnet_launches['fused_conv'], **conv))
    print(json.dumps({'kernels': kernels}))
    print(card)
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
