#!/usr/bin/env python3
"""Smoke run of paddle_tpu_torch on one NVIDIA GPU (written for the H100).

    python3 chip_smoke.py [--seed N]
    python3 chip_smoke.py --sweep-conv   # the fused conv's plan sweep
    python3 chip_smoke.py --host-cost [--root DIR]   # the conv's and the
                                          # LSTM cell's host cost
    python3 chip_smoke.py --fetch-cost [--root DIR]  # the flagship's
                                          # logits copy and request, by thread
    python3 chip_smoke.py --serve-tuned CONFIG   # phase 6c's second
                                          # process (phase 6c runs it)

from the root of a checkout. Phases, each of which raises (and so exits
non-zero) on failure:

1. device: requires CUDA, prints the card's name and power limit, turns
   TF32 off for float32 matrix products and convolutions;
2. build: compiles every CUDA kernel of the port with nvcc, all at once,
   into build/torch_kernels/; then, from the built flash, fused conv and
   LSTM cell libraries, counts the wgmma (HGMMA) and TMA load (UTMALDG)
   instructions of each kernel in its SASS (cuobjdump) and fails if the
   bf16 flash forward, the bf16 merged backward, the two-pass backward
   (its dq pass and its dk/dv pass, D 64 and 128), the wgmma conv (at
   each tile width) or the LSTM cell (f32 and bf16, at each batch tile)
   has none of either or ptxas ignored setmaxnreg, or if the two-pass
   kernels spill, and prints ptxas's registers and spills for those
   kernels;
3. kernels: holds each kernel against its plain PyTorch version at the
   serving and training paths' shapes and times kernel, plain version,
   the PyTorch library call for the same function (a yardstick only) and
   the least time the card could take (bound): the flash forward (at the
   request shapes and the training shape, B*H 128), and the three flash
   backward kernels (merged; two-pass dq and dk/dv), each gradient per
   tensor, at the training shape and at the long-context shape of phase
   7b (B 5, H 8, T 32768, D 128), where the plain version's [T, T]
   scores fit for one (b, h) slice only: there the kernels are held
   against the plain version on that slice and the two-pass kernels
   against the merged kernel on the whole tensor; at each backward case
   two calls of the two-pass route and two of flash_attention_bwd (the
   default route) must give the same dq, dk and dv bit for bit, and two
   wrong kernels (dq with delta dropped, dk with dS unscaled) must fail
   the check; the backward kernels are timed as CUDA graph replays, and
   the merged kernel once more with counters that never make a block
   wait, the cost of adding dq in a fixed order;
4. conv kernels: the fused conv kernel (csrc/fused_conv.cu) against its
   plain version at every distinct region shape of ResNet-50 at batch
   32, read from the program after the conv_epilogue_fuse pass, in bf16
   and f32, plus a depthwise shape, each aux kind, a swapped binary op
   and parametric activations, held per element; the kernel with the
   batch-norm shift dropped must fail that check at every shape, and two
   bf16 calls must give the same bits; times kernel, plain version and
   cuDNN's conv alone (a yardstick only) as replays of a CUDA graph, and
   computes the bound; then the same checks in bf16 at batch 1, 8 and 128
   (K is split at the first two, which are timed too); sums per conv
   class (stem, 1x1 stride 1, 1x1 stride 2, 3x3) at batch 1, 8 and 32;
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
   conv_epilogue_fuse: exactly 53 fused conv launches (52 on the wgmma
   kernel, the stem on its own path) and no fallback a request; a
   profile of one batch-32 request; one request compared with
   the same program on the plain fused conv, and two deliberately wrong
   kernels must fail that comparison;
6b. serving runtime: both saved models (ResNet-50's fetching its logits
   and probabilities) loaded into one ModelServer(CUDAPlace(0)), every
   bucket warmed (flagship 1, 2, 4; ResNet-50 1 to 32), each bucket's
   request done before the next; then 4 client threads send a seeded mix
   at once, 5 rounds each (flagship rows 1, 2, 3, 4; ResNet-50 rows 1, 5,
   8, 17, 32):
   every answer within the serving limits of a direct Executor.run of the
   same rows (bits equal printed), each ResNet-50 answer bit-equal to a
   direct run of its rows padded to the bucket the server ran it at, no
   memo miss after the warm-up,
   exactly 6 flash forwards a flagship batch and 53 fused convs (52
   wgmma, the stem) a ResNet-50 batch the server ran, no fallback, no
   failed request, the breakers closed; p50 and p99 ms a request per
   bucket through the server and of the direct run at the same batch
   (100 requests each, one client);
   both models under conv_epilogue_fuse alone and under the default
   passes (bit-equal where no elementwise chain was absorbed into a
   conv; the count printed); ResNet-50 through an Inferencer with the
   batch norms folded: no batch_norm op, 53 fused conv launches a
   request, no fallback, its logits within the ResNet limit of the
   unfolded server's;
6c. autotuned serving: a fresh ModelServer(CUDAPlace(0)) on both saved
   models, its tuning cache at a temporary path, a journal installed:
   warmup(autotune=True) (flagship buckets 1, 2, 4; ResNet-50 1 to 32),
   each bucket's candidates with their ms, the winner and the search's
   seconds; 6b's mix under the tuned entries with 6b's checks (answers
   against direct runs under the same entry, exact launches, no
   fallback, no memo miss); the journal's cost on batch-1 requests
   (medians of 50, no journal against a journal); tools/trace_report.py
   and tools/obs_report.py on the journal, every request of the mix with
   a closed request -> queue -> batch -> pad -> run tree; p50 and p99 a
   request per bucket, tuned and at the baseline entry (100 each); a
   candidate made to fault through tuning/measure poisoned while the
   search goes on; a second process (--serve-tuned) on the same cache
   file and saved models: every entry preloaded, no search, its answers
   to one seeded request per bucket bit-equal to this process's;
15a. the fleet: both saved models through a fleet.Router over 3
   ModelServer(CUDAPlace(0)) replicas, each model ringed on 2, every
   bucket warmed; 4 clients, 3 rounds of 6b's mix; once a third is
   answered, the telemetry endpoint (found through its PTPU_TELEMETRY_DIR
   port file) scraped and strictly parsed, /health read (the router and
   every replica), then a replica holding both models killed abruptly
   with ResNet-50 requests parked on it: every future ends with an answer
   or a typed ServingError (none dropped, none untyped, none failed),
   router_requeued_total grows, exactly 6 flash forwards a flagship batch
   and 53 fused convs (52 wgmma, the stem) a ResNet-50 batch summed over
   every replica built (the batches the kill abandoned in flight
   included), no fallback; flagship answers within 6b's limits of a
   direct run, ResNet-50's bit-equal to a direct run padded to the bucket
   their replica used; p50 and p99 a model beside 6b's; the kill's flight
   bundle carries a health slot that tools/postmortem.py renders (with
   the port's flight module standing in for the JAX package's, whose
   name it imports); the supervisor's restart answers one request a
   bucket bit-equal to the replica's pre-kill answers; a rolling_swap of
   ResNet-50 to a re-saved copy under 2 clients fails nothing; a retire
   drops the replica's series from the scraped exposition; then ResNet-50
   alone behind an Autoscaler (min 1, max 3): a ramp of 8 clients scales
   it out within AUTOSCALE_OUT_S and idle brings it back to 1 within
   AUTOSCALE_IN_S; a PlacementBudget overcommit raises
   PlacementInfeasible naming hbm_bytes and leaves no placement; a shed
   storm breaches the shed-ratio SLO (burn rate over windows of 10 and 60
   s under the phase's clock), which recovers after the drain;
7. training: the same flagship at full width and depth, Adam(1e-4)
   .minimize(loss), batch 16: warm-up steps, then timed steps through
   Executor.run on one fixed batch (ms per step, tokens/s), checking
   that the loss is finite and falls and that each step launches one
   forward and one merged backward kernel per layer; a torch.profiler
   trace of one step; one step on the two-pass backward route, whose
   gradients must match the merged route's; the autotuner over
   flash_bwd_route at batch 16 (each route's ms a step and the winner,
   no winner asserted), then one step under the winner's route: exact
   launches for that route, gradients within ROUTE_GRAD_TOL of the
   other route's;
7b. long-context training: the same flagship at full width, 2 layers
   (the card's memory), at seq 32768 and batch 5 (163,840 tokens a step,
   where the merged kernel's f32 dq
   buffer passes the wrapper's cap, so the port takes the two-pass
   route by its own rule), Adam, AMP, one fixed batch: a warm-up step,
   then timed steps (ms per step, tokens/s, peak memory), the loss
   finite and falling, exactly one forward, one dq pass and one dk/dv
   pass per layer a step and no merged backward; a profile of one step
   with the two passes' share of the device time; one step's gradients
   against the same step on the merged route (its cap raised for that
   step), within ROUTE_GRAD_TOL;
8. gradients: at batch 2, every parameter gradient of one step on the
   kernels against the same step on the plain attention (autograd
   backward), by relative L2 error; two deliberately wrong backwards
   must fail that comparison;
9. stats kernels: the fused conv's stats form (train-mode batch norm:
   the conv and the per-channel sum and sum of squares of its f32
   output) against its plain version at every distinct region shape of
   the ResNet-50 training program at batch 32, in bf16 and f32, plus a
   depthwise shape: y per element, the moments per channel; the slab
   without its last slot must fail where M is not a multiple of it; two
   calls must give the same bits; the same at batch 1 and 8 in bf16
   (where K is split); then at batch 128 in bf16, the training step's
   shapes: checked the same way, and kernel, plain version and cuDNN's
   conv with two channel reductions (a yardstick only) timed per shape as
   replays of a CUDA graph, and summed over a batch-128 step's 53 regions
   and per conv class;
10. ResNet-50 training: full width (3 x 224 x 224, 1000 classes),
   cross_entropy, Momentum(0.01, 0.9).minimize, AMP, batch 128, one
   fixed batch: warm-up steps, then timed steps through Executor.run
   (ms per step, images/s, peak memory); the loss finite and falling,
   exactly 53 stats-form launches a step (52 on the wgmma kernel), no
   other fused conv and no fallback; a profile of one step;
11. ResNet-50 gradients: at batch 8, every parameter gradient and every
   moving statistic of one step on the kernel against the same step on
   the plain fused conv's forward (the same backward), by relative L2
   error, with AMP off (f32, fixed limits) and under AMP (bf16, limits
   relative to a witness: the plain forward in f64, rounded); a backward
   without the moments' cotangents and a kernel without its last row
   tile's moment partials must fail that comparison in both;
12. SE-ResNeXt-50 training: full width, batch 32, the same optimizer and
   AMP, warm-up then timed steps: exact stats-form launches and
   'groups' replays (its grouped 3x3 convs) a step, ms per step,
   images/s;
13. LSTM kernels: the fused LSTM cell (csrc/lstm_cell.cu: wgmma, TMA;
   f32 as three TF32 products) against its plain version at the sequence
   path's shape (B 256, H 512, f32), the served batches 1 and 32, (64,
   256), H 1000 and H 37, and with bf16 r_prev and w at B 256, 1 and 32,
   per element; f32, at each shape on LSTM_WITNESS_DRAWS draws of the
   inputs: the kernel's error against the plain cell in f64 at most 2x
   the plain f32 version's, and so the product's alone (read through
   saturated gates); two calls give the same bits; the cell at each
   forced batch tile (8, 16, 32, 64 rows a block) per element against
   the plain version, and tile 12 refused at launch; the real kernel fed
   c_prev zeroed, or xg with its input and
   forget chunks swapped, must fail the per-element check by far; kernel,
   plain version and a matmul with the gate math (a yardstick) timed as
   CUDA graph replays, and the bound of the kernel's route;
14. LSTM training: stacked_dynamic_lstm at full width (dict 10000, emb
   and hid 512, 3 layers) with use_peepholes=False, Momentum(0.01, 0.9)
   .minimize, AMP, batch 256 of 80 words (96 padded steps), one fixed
   batch: warm-up then timed steps (ms per step, words/s, peak memory),
   the loss finite and falling, exactly 288 lstm_cell launches a step, a
   profile of one step; then the benchmark's configuration (peepholes,
   the plain scan, no launch) for a few steps;
15. LSTM serving: the trained model saved with save_inference_model,
   loaded into a fresh scope and served at batch 1, 32 and 256 of 80
   words and one ragged batch, 288 launches a request; its probabilities
   against the plain cell's, and two controls that must fail; the
   autotuner over lstm_batch_tile at batch 32 and 256 (each tile's ms a
   request and the winner), then every tile forced: within the limits
   above, 288 launches a request, two calls bit-identical;
16. LSTM gradients: one batch-8 step on ragged lengths, the loss and
   every parameter gradient on the kernel against the plain cell, AMP
   off (a fixed limit) and on (a limit relative to a witness, the plain
   cell in f64); the two controls must fail both;
12b. analysis: the static verifier (analysis.verify_program, called
   directly) on every program the run builds (the flagship serving and
   training, ResNet-50 serving and training, SE-ResNeXt-50,
   stacked_dynamic_lstm, machine_translation, mnist and VGG-16 training
   and serving), each as built and after the default passes ran under
   the sanitizer (PassPipeline(verify=True)): no error, no exception,
   its ops and verify seconds printed; then through Executor.run on the
   card a rank-3 image feed must raise FeedInvalid and a conv whose
   filter takes 4 channels of a 3-channel image ProgramInvalid, with no
   kernel launched;
12c. mnist (benchmark/fluid/models.py:24-37: conv 20 and 50, 5x5, each
   with a 2x2 max pool, fc 10) and 12d. VGG-16 (:40-48, 3x32x32, 10
   classes; batch norm and dropout): Momentum(0.01, 0.9) at batch 32 on
   one fixed batch, f32 (AMP off) and bf16 (AMP), warm-up then timed
   steps: exact launches (mnist: 2 fused_conv a step, FMA in f32,
   mma.sync in bf16; VGG-16: 13 stats-form launches, FMA in f32, the
   stem and 12 wgmma in bf16), no fallback, finite losses; then 30 steps
   on one batch with dropout off, the mean of the last 5 losses under
   half the first; every
   region of one step held against its plain version per element (the
   stats form: y per element, the moments per channel; two calls
   bit-identical; the next channel's filters or a dropped last slot must
   fail) and timed (kernel, plain, cuDNN's conv alone, bound); the
   trained model saved for inference, loaded, its batch-32 logits
   against the plain fused conv in both precisions (the next channel's
   filters must fail), each served
   region held and timed the same way, and the model served through
   ModelServer(CUDAPlace(0)) at buckets 1-32 (every answer bit for bit
   against a direct run padded to its bucket; one launch a region a
   batch); VGG-16 also: a batch-32 step's gradients and moving
   statistics against the plain stats form with the dropout masks drawn
   from one seed on both paths and the plain step's ReLUs and max pools
   pinned to the kernel step's decisions (within 2x a witness, the plain
   forward in f64, rounded, in f32 and bf16; the unpinned distance and
   the decisions that differ printed), two wrong stats forms failing;
   each dropout
   mask's kept fraction within 5 sigma of 1 - p;
13b. the Fluid books (paddle_tpu_torch/models/books.py, the scripts of
   python/paddle/fluid/tests/book at their widths, f32 with TF32 off):
   every new op kernel of the slice (cast, squeeze, unsqueeze, transpose,
   one_hot, gather, top_k, accuracy, increment, expand,
   fill_constant_batch_size_like, the compare and logical ops, the
   reductions, the losses, prelu, maxout, matmul) in one program on the
   card and on the CPU on seeded inputs: the integer, bool and
   data-movement ops bit for bit, the float math within 1e-5 of its
   scale, matmul in f32 and in bf16 under AMP (2^-7), and the next
   seed's inputs failing those limits; then fit_a_line (SGD, batch 20),
   recognize_digits conv and MLP (Adam, batch 64), image_classification
   (resnet_cifar10 depth 32, Adam, batch 128, f32 and AMP) and word2vec
   (SGD, batch 32), each through DataFeeder and its reader
   (paddle_tpu_torch.batch, reader.shuffle) on its synthetic dataset:
   steps with the loss finite and falling under a limit a book that
   learning rates 0 and minus the script's must fail, the accuracy on
   the card equal to the host's from the probabilities, exact launches
   (recognize_digits 2 fused_conv a step, ResNet-32 33 stats-form; the
   regions counted from the program) and no fallback; one f32 step held
   against the same step on the CPU (loss and probabilities within 1e-4
   of their scale; the next batch and the parameters before training
   must fail); the book saved, loaded and served through
   ModelServer(CUDAPlace(0)) at
   buckets 1-32, each answer bit for bit against a direct run padded to
   its bucket, one launch a region a batch; every region of
   recognize_digits' batch-64 step, of ResNet-32's batch-128 step, of
   its inference form at batch 128 (f32 and bf16) and of both books'
   served buckets (a request padded to each bucket the server used, f32)
   held against its plain version and timed;
17. machine translation: full width (dict 8000, emb 256, hid 512, with
   peepholes), batch 64 of 24 words a side, a few Momentum steps (ms a
   step; no cell launch);
15b. the decode tier (after the control-flow phase 14b): DecodeEngine
   with attention_history_cell at the repo's widest recurrent widths
   (dict 30000, word and hidden 512, 256 positions; TF32 and AMP off) at
   16 slots, continuous and stop-and-wait, the paged cell
   (kvcache.stock_spec, 256 pages of 16 positions: the same 8 MiB of KV)
   at 16 and 48 slots, on 192 ragged sequences: tokens/s, steps, a
   profiled step's busy share and its host<->card copies' share; equal
   slot counts bit for bit; across slot counts, the first 16 sequences
   token by token against a one-slot oracle, a parting excused only
   where the oracle's top two probabilities lie within DECODE_TIE
   (excused partings printed); the paged cell fed kv_off shifted by one
   or its block tables reversed must fail both gates; then disaggregated
   prefill: a Router over 2 role='prefill' replicas
   (kvcache.PrefillServer) and a local paged engine of 48 slots, 32
   prompts of 8-64 tokens, one prefill replica killed after 8 are routed:
   no failure, the continuations against the oracle under the same rule,
   and one trace tree per request across the prefill -> decode hop
   (tools/trace_report.py);
18. summary: a JSON line of the kernels, the card line, and last the
   JSON result line.
"""
import argparse
import contextlib
import functools
import json
import math
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
_STARTED = time.perf_counter()

# NVIDIA H100 SXM data sheet, dense: bf16 tensor cores, f32 without
# tensor cores, HBM3 bandwidth
PEAK_FLOPS = {'bfloat16': 989e12, 'float32': 67e12, 'tf32': 495e12}
PEAK_BYTES = 3.35e12

FLAGSHIP = dict(vocab=8192, d_model=1024, n_heads=8, n_layers=6, d_ff=4096,
                seq=2048)
REQUEST_BATCHES = [1, 2, 4, 1, 2, 4]
TRAIN_BATCH, TRAIN_WARMUP, TRAIN_STEPS = 16, 2, 10   # bench.py:322, 337
TUNE_STEPS = 5             # timed steps a candidate when phases 7 and 15 tune
# phase 7b, long-context training: the flagship at full width at seq
# 32768, batch 5, 163,840 tokens a step, where the merged backward's f32
# dq buffer (640 MiB) passes the wrapper's 512 MiB cap, so the port takes
# the two-pass route by its own rule; a warm-up step, then timed steps.
# Depth cut from 6 to 2 by the card's memory (PERF.md, section 4): the
# lowering keeps a step's intermediates until its end, ~15 GB a layer
# here; depth 6, 4 and 3 ran out of the H100's 80 GB (peaks 77.11, 77.88
# and 76.45 GiB)
LONG_SEQ, LONG_BATCH, LONG_LAYERS = 32768, 5, 2
LONG_WARMUP, LONG_STEPS = 1, 3
LONG_CASE = (LONG_BATCH, FLAGSHIP['n_heads'], LONG_SEQ,
             FLAGSHIP['d_model'] // FLAGSHIP['n_heads'], 'bfloat16', True)
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
# two-pass read 5e-3 (the routes sum dq in other orders), the limit is 4x
# that;
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
# the conv kernel phase also checks every region shape at these batches
# (bf16), and times the served ones (batch 1 and 8, where the wgmma
# kernel splits K)
CONV_CHECK_BATCHES = (1, 8, 128)
CONV_TIMED_BATCHES = (1, 8)
RESNET_REQUESTS = [1, 8, 32, 1, 8, 32]
RESNET_REGIONS = 53                    # fused_conv ops of ResNet-50
# the fused conv's variants a request (or a training step) launches: the
# wgmma kernel for every region but the 7x7 stem (Cin 3)
RESNET_VARIANTS = {'fma': 0, 'mma_sync': 0, 'wgmma': 52, 'stem': 1}
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
# the stats form's moments vs the plain version's on the same inputs, per
# channel: |sum err| <= STATS_REL * sum |conv| and |sumsq err| <= STATS_REL
# * sum conv^2; y is held by CONV_TOL. Both sides sum the same products in
# f32 in another order; the bf16 kernel's tensor-core accumulation drifts
# further from IEEE sums than the f32 kernel's FMA. Set from the sound
# readings on the H100 (PERF.md, Findings): at most 8.0e-6 (bf16, sum of
# squares, the 7x7 3x3 convs with K = 4608) and 4.2e-7 (f32); the limits
# are 3.7x and 4.8x that. A slab without its last slot reads 3650-5530x
# the old 1e-5.
STATS_REL = {'bfloat16': 3e-5, 'float32': 2e-6}
STATS_CHECK_BATCH = 32                 # the stats phase's checked shapes
STATS_SMALL_BATCHES = (1, 8)           # checked too, bf16 (K splits)
RESNET_TRAIN_BATCH = 128               # bench.py:121
RESNET_TRAIN_WARMUP, RESNET_TRAIN_STEPS = 2, 10
RESNET_GRAD_BATCH = 8
SE_BATCH, SE_WARMUP, SE_STEPS = 32, 2, 3
# whole ResNet-50, gradients and moving statistics of one batch-8 step on
# the kernel vs the plain fused conv's forward (the same backward),
# relative L2 per tensor: the largest and the median over the gradients,
# the largest over the statistics. With AMP off (f32) the two forwards
# differ only in the order of their sums. Set from the sound reading on
# the H100 (PERF.md, Findings): 0.00701, 0.0033 and 1.03e-6 (a witness,
# the plain forward in f64 then rounded, reads 0.00342, 0.00117 and
# 1.02e-6); the limits are 4.3x, 3x and 9.7x that. The two wrong kernels
# read 30.1 / 2.01 (the moments' cotangents dropped) and 0.405 / 0.29 /
# 0.0331 (the last slot dropped).
RESNET_GRAD_F32 = (0.03, 0.01, 1e-5)
# under AMP (bf16) each is at most this many times the witness's: bf16
# rounding between 53 train-mode batch norms moves the gradients by as
# much for any order of the f32 sums. Read on the H100: the kernel 0.205,
# 0.159 and 9.35e-4, the witness 0.201, 0.154 and 9.17e-4; the wrong
# kernels 29.6 / 2.02, and statistics 0.0332 (18x the limit).
RESNET_GRAD_WITNESS = 2.0
# each residual branch's last batch-norm gamma is scaled by this at the
# start (Goyal et al., 2017): with gammas of 1, train-mode batch norm
# makes the random network's gradients explode with depth
RESIDUAL_GAMMA = 0.1
# the sequence path: stacked_dynamic_lstm at the benchmark's width
# (benchmark/fluid/models.py:70-104) with use_peepholes=False on its three
# LSTMs, batch 256 (bench.py:281), 80 words a sequence, padded to 96 steps
LSTM = dict(dict_size=10000, emb_dim=512, hid_dim=512, stacked_num=3)
LSTM_BATCH, LSTM_WORDS, LSTM_T_PAD = 256, 80, 96
LSTM_WARMUP, LSTM_STEPS, LSTM_PEEP_STEPS = 2, 10, 3
LSTM_LAUNCHES = LSTM['stacked_num'] * LSTM_T_PAD    # a step or a request
LSTM_GRAD_BATCH = 8
LSTM_SERVE_BATCHES = [1, 32, 256]
# machine_translation (models.py:106-146) at batch 64 (bench.py:262)
MT = dict(dict_size=8000, emb_dim=256, hid_dim=512)
MT_BATCH, MT_LEN, MT_WARMUP, MT_STEPS = 64, 24, 1, 3
# the LSTM cell kernel vs its plain version on the same inputs, per
# element: |err| <= rel * |plain| + abs * rms(plain), (rel, abs) by the
# dtype of the output. f32: the product as three TF32 products (each
# within ~2^-22 of the f32 one) with f32 sums in another order, then the
# same gate math; bf16 (h written in bf16): one bf16 rounding of h that
# may differ by one step. Read on the H100 (PERF.md, Findings): f32
# at most 0.17 of the limit, bf16 0.35. Two wrong-kernel controls
# (c_prev zeroed, xg's input and forget chunks swapped) read 1.3e5-3.9e5
# times the limit and must read past LSTM_CONTROL_MARGIN.
LSTM_CELL_TOL = {'float32': (1e-5, 1e-5), 'bfloat16': (2 ** -7, 2 ** -8)}
LSTM_CONTROL_MARGIN = 100
# f32: the kernel's three TF32 products drop w_lo r_lo (~2^-22 of each
# product) and its tensor cores truncate their adds within a chunk of 32;
# at every f32 shape, on LSTM_WITNESS_DRAWS draws of the inputs, its max
# |err| against the plain cell in f64 may be at most this many times the
# plain f32 version's, and so may its product's alone, read through
# saturated gates (_product_probe) against the product in f64
LSTM_F64_WITNESS = 2.0
LSTM_WITNESS_DRAWS = 3
# the product read through the gates: w scaled by this power of 2 (exact)
# keeps |g| under ~1e-4, where f32 tanh returns its argument
LSTM_PROBE_SCALE = 2.0 ** -16
# phase 13's (B, H, dtype of r_prev and w): the sequence path's shape, the
# served batches 1 and 32, a narrower layer, H 1000 (not a multiple of the
# 16-unit tile), H 37 (padded to 40 for the tensor maps), and bf16 at the
# training shape and the served batches
LSTM_TILES = (8, 16, 32, 64)          # the cell's batch rows a block
LSTM_TUNE_BATCHES = (32, 256)          # phase 15 tunes the served LSTM here
LSTM_KERNEL_SHAPES = ((256, 512, 'float32'), (1, 512, 'float32'),
                      (32, 512, 'float32'), (64, 256, 'float32'),
                      (7, 1000, 'float32'), (3, 37, 'float32'),
                      (256, 512, 'bfloat16'), (1, 512, 'bfloat16'),
                      (32, 512, 'bfloat16'))
# the loss and every parameter gradient of one batch-8 step on ragged
# lengths, kernel vs the plain cell (relative L2). With AMP off both run
# in f32 and differ in the order of their sums: read on the H100 (PERF.md,
# Findings) 0 and 3.2e-7, a witness (the plain cell in f64, rounded) 0
# and 3.6e-7; the limit is 30x that. Under AMP bf16 rounding in the fc
# products moves the gradients 2% for any order of the cell's sums (the
# kernel and the witness both read 0.0201): each limit is
# LSTM_GRAD_WITNESS times the witness's, and never below the f32 one. The
# controls read 0.96 and 0.11 in both.
LSTM_GRAD_F32 = 1e-5
LSTM_GRAD_WITNESS = 2.0
# served outputs, kernel vs the plain cell (AMP), over LSTM_PROBES probes
# of other words: the probabilities' max |diff| and the pooled last
# hidden state's max |diff| / max |state|, each at most LSTM_PROB_WITNESS
# times the witness's (the plain cell in f64) and never held below its
# floor. Under AMP the two logits are bf16, so any change of the cell's
# f32 rounding moves a probability only in steps of p (1 - p) times one
# bf16 step of a logit (3.05e-5 at the logits read): one probe reads 0,
# 1 or 2 such steps for either side. Read on the H100 with one probe
# (PERF.md, Findings): the kernel 3.05e-5 or 6.1e-5 and the witness
# 6.1e-5 in 9 runs, the witness 0 in 2 (where the kernel's one step
# failed the floor), so the limit takes the largest witness over several
# probes; the pooled state 0.0020 for both; the controls 0.00427 / 0.364
# (c_prev zeroed) and 1.22e-4 / 0.0144 (input and forget swapped: the
# two-class output at random weights leans little on the LSTM, the pooled
# state catches it)
LSTM_PROBES = 4
LSTM_PROB_WITNESS, LSTM_PROB_FLOOR = 2.0, (1e-5, 1e-6)


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


# the redesigned kernels: (library, a pattern of the kernel's mangled
# name, the number of its template instances, setmaxnreg's registers for
# a consumer and for a producer thread, whether a spill fails the run);
# each instance must contain wgmma (HGMMA) and TMA loads (UTMALDG): the
# flash kernels at D 64 and 128 (the kv-major backward merged, Lb1, and
# as the dk/dv pass, Lb0; the dq pass), the fused conv at tile widths 64,
# 128 and 256, the LSTM cell's f32 and bf16 kernels at 8, 16, 32 and 64
# batch rows a block
SASS_KERNELS = (
    ('flash_attn_fwd', r'flash_fwd_wgmma_kernel', 2, 240, 24, False),
    ('flash_attn_bwd', r'flash_bwd_wgmma_kernelILi\d+ELb1', 2, 240, 24,
     False),
    ('flash_attn_bwd', r'flash_bwd_wgmma_kernelILi\d+ELb0', 2, 240, 24,
     True),
    ('flash_attn_bwd', r'flash_bwd_dq_wgmma_kernel', 2, 240, 24, True),
    ('fused_conv', r'conv_wgmma_kernel', 3, 232, 40, False),
    ('lstm_cell', r'lstm_cell_', 8, 232, 40, False))


def _kernel_label(mangled):
    m = re.search(r'((?:flash_(?:fwd|bwd)|conv|lstm_cell)_\w+?_kernel)'
                  r'ILi(\d+)'
                  r'(?:ELb([01]))?', mangled)
    if not m:
        return mangled
    return '%s<%s%s>' % (m.group(1), m.group(2),
                         {'1': ', merged', '0': ', dk/dv'}.get(m.group(3),
                                                               ''))


def sass_counts(lib_path):
    """{kernel: (HGMMA, UTMALDG)} from the SASS of one built library."""
    tool = shutil.which('cuobjdump') or '/usr/local/cuda/bin/cuobjdump'
    res = subprocess.run([tool, '-sass', lib_path], capture_output=True,
                         text=True, timeout=300)
    check(res.returncode == 0, 'cuobjdump failed on %s: %s'
          % (lib_path, res.stderr[-2000:]))
    counts, name = {}, None
    for line in res.stdout.splitlines():
        if 'Function :' in line:
            name = line.split('Function :', 1)[1].strip()
            counts[name] = [0, 0]
        elif name is not None:
            counts[name][0] += 'HGMMA' in line
            counts[name][1] += 'UTMALDG' in line
    return {n: tuple(c) for n, c in counts.items()}


def ptxas_usage(log):
    """{kernel: (registers, spill store bytes, spill load bytes)} from a
    build log of ptxas -v."""
    usage, name, spill = {}, None, (0, 0)
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            name = m.group(1)
            continue
        m = re.search(r'(\d+) bytes spill stores, (\d+) bytes spill loads',
                      line)
        if m:
            spill = (int(m.group(1)), int(m.group(2)))
        m = re.search(r'Used (\d+) registers', line)
        if m and name is not None:
            usage[name] = (int(m.group(1)),) + spill
    return usage


def phase_sass():
    """The redesigned kernels run on the tensor cores and TMA: count HGMMA
    and UTMALDG in each kernel of the built flash, fused conv and LSTM cell
    libraries, fail if an instance of the bf16 flash forward, kv-major
    backward (merged and dk/dv pass) or dq pass (D 64 and 128), wgmma
    conv (tile widths 64, 128, 256) or LSTM cell (f32 and bf16, 8 to 64
    batch rows a block) has none of either, or a two-pass instance
    spills; print ptxas's registers and spills for them."""
    from paddle_tpu_torch.ops import _build
    for lib in sorted({row[0] for row in SASS_KERNELS}):
        rows = [row for row in SASS_KERNELS if row[0] == lib]
        counts = sass_counts(_build.library_path(lib))
        usage = ptxas_usage(_build.build_log(lib))
        row_of = {n: next((r for r in rows if re.search(r[1], n)), None)
                  for n in counts}
        for name, (hgmma, utmaldg) in sorted(counts.items()):
            regs, row = usage.get(name), row_of[name]
            print('sass: %s %s: %d HGMMA, %d UTMALDG%s' % (
                lib, _kernel_label(name), hgmma, utmaldg,
                '; ptxas: %d registers at entry (setmaxnreg: %d a consumer '
                'thread, %d a producer thread), spill stores %d B, spill '
                'loads %d B' % ((regs[0], row[3], row[4]) + regs[1:])
                if regs and row else ''), flush=True)
        # ptxas's notes on wgmma and setmaxnreg (C75xx: serialized wgmma,
        # setmaxnreg ignored)
        notes = [l.strip() for l in _build.build_log(lib).splitlines()
                 if 'C75' in l]
        for line in notes:
            print('sass: %s ptxas: %s' % (lib, line), flush=True)
        check(not any('setmaxnreg' in l for l in notes),
              '%s: ptxas ignored setmaxnreg' % lib)
        for row in rows:
            _, kernel, instances, _, _, no_spill = row
            ours = [n for n in counts if row_of[n] == row]
            check(len(ours) == instances, '%s: expected %d instances of '
                  'the %s kernel, found %s' % (lib, instances, kernel,
                                               ours))
            for name in ours:
                check(min(counts[name]) > 0, '%s has no %s' % (
                    _kernel_label(name),
                    'HGMMA' if counts[name][0] == 0 else 'UTMALDG'))
                check(name in usage, 'no ptxas report for %s' % name)
                check(not no_spill or usage[name][1:] == (0, 0),
                      '%s spills: %d B stored, %d B loaded' % (
                          (_kernel_label(name),) + usage[name][1:]))


def phase_kernels(seed):
    """Flash forward vs its plain version at the serving path's shapes
    (B*H = 8 and 32, T = 2048, D = 128, causal) and the training path's
    (B*H = 128), plus a non-causal, a D = 64 and a ragged case, in bf16
    and f32."""
    import torch
    import torch.nn.functional as F
    from paddle_tpu_torch.ops import cuda_kernels as ck
    cases = [(1, 8, 2048, 128, 'bfloat16', True),
             (4, 8, 2048, 128, 'bfloat16', True),
             (TRAIN_BATCH, 8, 2048, 128, 'bfloat16', True),
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
        print('kernel flash_attn_fwd (%s) B=%d H=%d T=%d D=%d %s causal=%s: '
              'max|out err| %.3g (tol %g) max|lse err| %.3g (tol %g); '
              'kernel_ms %.4f plain_ms %.4f library_ms %.4f bound_ms %.4f '
              '(%s)' % (ck.flash_variant(dtype, D), B, H, T, D, dt,
                        causal, err_out, tol['out'], err_lse, tol['lse'],
                        kernel_ms, plain_ms, library_ms, bound_ms,
                        bound_by), flush=True)
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


def _bwd_check(got, ref, dt, names=('dq', 'dk', 'dv')):
    """{name: (max |err|, limit)} of each gradient against ``ref``: the
    limit is tol * max(max |ref|, floor), BWD_TOL by dtype."""
    tol, floor = BWD_TOL[dt]
    out = {}
    for name, g, r in zip(names, got, ref):
        r = r.float()
        out[name] = ((g.float() - r).abs().max().item(),
                     tol * max(r.abs().max().item(), floor))
    return out


def _wrong_two_pass(args, D):
    """Two deliberately wrong two-pass kernels, made on the host: the dq
    pass fed delta dropped (zeros), and dk as it is without its dS scale
    (times sqrt(D)). [(name, index of the gradient, tensor)]."""
    import torch
    from paddle_tpu_torch.ops import cuda_kernels as ck
    q, k, v, do, lse, delta, causal = args
    return [('dq with delta dropped', 0,
             ck.flash_bwd_dq(q, k, v, do, lse, torch.zeros_like(delta),
                             causal)),
            ('dk with dS unscaled', 1,
             ck.flash_bwd_dkv(*args)[0] * math.sqrt(D))]


def phase_bwd_kernels(seed):
    """The three flash backward kernels vs the plain backward at the
    training shape (B 16, H 8, T 2048, D 128, bf16, causal), at B 4 with
    both causal settings, at D 64, at a ragged T 2000, in f32, and at the
    long-context training shape of phase 7b (B 5, T 32768), where the
    plain version runs on one (b, h) slice and the two-pass kernels are
    also held against the merged kernel on the whole tensor. Each case
    checks that two calls of the two-pass route and of the default route
    give the same bits and that two wrong two-pass kernels fail, and
    times the merged kernel (also with its fixed-order wait switched
    off) and the two-pass kernels as CUDA graph replays, the plain
    backward, and SDPA's backward (autograd.grad of
    F.scaled_dot_product_attention), a yardstick only."""
    import torch
    import torch.nn.functional as F
    from paddle_tpu_torch.ops import cuda_kernels as ck
    cases = [(16, 8, 2048, 128, 'bfloat16', True),
             (4, 8, 2048, 128, 'bfloat16', True),
             (4, 8, 2048, 128, 'bfloat16', False),
             (4, 16, 2048, 64, 'bfloat16', True),
             (2, 8, 2000, 128, 'bfloat16', True),
             (4, 8, 2048, 128, 'float32', True),
             LONG_CASE]
    gen = torch.Generator(device='cuda')
    gen.manual_seed(seed + 1)
    results = {}
    for B, H, T, D, dt, causal in cases:
        long = (B, H, T, D, dt, causal) == LONG_CASE
        dtype = getattr(torch, dt)
        q, k, v, do = (torch.randn(B, T, H, D, device='cuda', generator=gen)
                       .to(dtype) for _ in range(4))
        with torch.no_grad():
            out, lse = ck.flash_attention_with_lse(q, k, v, causal)
        delta = ck.flash_bwd_delta(out, do)
        args = (q, k, v, do, lse, delta, causal)
        merged = ck.flash_bwd_dkvdq(*args)
        two_pass = (ck.flash_bwd_dq(*args),) + ck.flash_bwd_dkv(*args)
        again = (ck.flash_bwd_dq(*args),) + ck.flash_bwd_dkv(*args)
        wrong = _wrong_two_pass(args, D)
        torch.cuda.synchronize()
        same = [torch.equal(a, b) for a, b in zip(two_pass, again)]
        del again
        if long:
            # the plain version's [T, T] scores fit for one (b, h) only
            bs, hs = B - 1, H - 1

            def view(t):
                return t[bs:bs + 1, :, hs:hs + 1]
            ref = ck.flash_bwd_reference(
                *[view(t).contiguous() for t in (q, k, v, do)],
                lse[bs:bs + 1, hs:hs + 1].contiguous(),
                delta[bs:bs + 1, hs:hs + 1].contiguous(), causal)
            vs_merged = _bwd_check(two_pass, merged, dt)
        else:
            def view(t):
                return t
            ref = ck.flash_bwd_reference(*args)
            vs_merged = {}
        checks = {('merged', n): e for n, e in _bwd_check(
            [view(t) for t in merged], ref, dt).items()}
        checks.update({('two_pass', n): e for n, e in _bwd_check(
            [view(t) for t in two_pass], ref, dt).items()})
        checks.update({('two-pass vs merged', n): e
                       for n, e in vs_merged.items()})
        controls = {name: _bwd_check([view(t)], [ref[i]], dt,
                                     names=(name,))[name]
                    for name, i, t in wrong}
        rel_l2 = {(r, n): ((view(g).float() - x.float()).norm() /
                           x.float().norm()).item()
                  for r, got in (('merged', merged), ('two_pass', two_pass))
                  for n, g, x in zip(('dq', 'dk', 'dv'), got, ref)}
        del ref, merged, two_pass, wrong
        # the default route, twice: dq, dk and dv the same bit for bit
        first = ck.flash_attention_bwd(q, k, v, out, lse, do, causal)
        second = ck.flash_attention_bwd(q, k, v, out, lse, do, causal)
        torch.cuda.synchronize()
        same_default = [torch.equal(a, b) for a, b in zip(first, second)]
        del first, second
        route = ('merged' if ck._MERGED_BWD[0] and ck.merged_bwd_bytes(q) <=
                 ck._MERGED_BWD_MAX_SLAB_BYTES else 'two-pass')
        print('kernel flash_attn_bwd   B=%d H=%d T=%d D=%d %s causal=%s: '
              'two-pass route twice: dq, dk, dv bit-identical %s; default '
              'route (%s) twice: %s' % (B, H, T, D, dt, causal, same,
                                        route, same_default), flush=True)
        check(all(same) and all(same_default), 'flash backward is not '
              'bit-reproducible at B=%d H=%d T=%d D=%d %s causal=%s: '
              'two-pass %s, default route %s' % (
                  B, H, T, D, dt, causal, same, same_default))
        # times: graph replays of the kernels (the merged kernel also with
        # counters that let every block add at once, its dq then summed in
        # no fixed order: the difference is what waiting for the fixed
        # order costs)
        iters, reps = (2, 3) if long else (10, 5)
        free = torch.full(ck.flash_bwd_counters(q).shape, 1 << 30,
                          dtype=torch.int32, device=q.device)
        merged_ms = graph_ms(lambda: ck.flash_bwd_dkvdq(*args), iters, reps)
        unordered_ms = graph_ms(lambda: ck.flash_bwd_dkvdq(
            *args, counters=free), iters, reps)
        del free
        dq_ms = graph_ms(lambda: ck.flash_bwd_dq(*args), iters, reps)
        dkv_ms = graph_ms(lambda: ck.flash_bwd_dkv(*args), iters, reps)
        if long:
            # the plain version over every (b, h) slice, one at a time
            def plain_all():
                for bi in range(B):
                    for hi in range(H):
                        ck.flash_bwd_reference(
                            *[t[bi:bi + 1, :, hi:hi + 1].contiguous()
                              for t in (q, k, v, do)],
                            lse[bi:bi + 1, hi:hi + 1].contiguous(),
                            delta[bi:bi + 1, hi:hi + 1].contiguous(),
                            causal)
            plain_ms = cuda_ms(plain_all, iters=1, warmup=0)
        else:
            plain_ms = cuda_ms(lambda: ck.flash_bwd_reference(*args),
                               iters=2, warmup=1)
        qt, kt, vt = (t.transpose(1, 2).contiguous().requires_grad_()
                      for t in (q, k, v))
        o_sdpa = F.scaled_dot_product_attention(qt, kt, vt,
                                                is_causal=causal)
        do_t = do.transpose(1, 2).contiguous()
        library_ms = cuda_ms(lambda: torch.autograd.grad(
            o_sdpa, (qt, kt, vt), do_t, retain_graph=True),
            iters=3 if long else 10)
        del qt, kt, vt, o_sdpa, do_t
        bounds = {'merged': bwd_bound(B, H, T, D, dt, causal, 5, 3),
                  'dq': bwd_bound(B, H, T, D, dt, causal, 3, 1),
                  'dkv': bwd_bound(B, H, T, D, dt, causal, 4, 2)}
        print('kernel flash_attn_bwd B=%d H=%d T=%d D=%d %s causal=%s: '
              'max|err| %s (limit tol %g x max(max|ref|, %g)%s); '
              'merged_ms %.4f (bound %.4f %s) dq_ms %.4f (bound %.4f) '
              'dkv_ms %.4f (bound %.4f) pair %.4f plain_ms %.4f%s '
              'library_ms %.4f (graph replays; plain and library: events)'
              % (B, H, T, D, dt, causal, ', '.join(
                  '%s %s %.3g (%.3g)' % (r, n, e, l)
                  for (r, n), (e, l) in checks.items()),
                 BWD_TOL[dt][0], BWD_TOL[dt][1],
                 ', ref: the (b, h) slice (%d, %d)' % (bs, hs)
                 if long else '', merged_ms, bounds['merged'][0],
                 bounds['merged'][1], dq_ms, bounds['dq'][0], dkv_ms,
                 bounds['dkv'][0], dq_ms + dkv_ms, plain_ms,
                 ' (every (b, h) slice in turn)' if long else '',
                 library_ms), flush=True)
        print('kernel flash_attn_bwd   merged_ms %.4f, with no block '
              'waiting for its turn %.4f: the fixed-order dq add costs %.1f%%'
              % (merged_ms, unordered_ms,
                 100 * (merged_ms - unordered_ms) / merged_ms), flush=True)
        print('kernel flash_attn_bwd   relative L2 vs plain: %s' % ', '.join(
            '%s %s %.3g' % (r, n, e) for (r, n), e in sorted(
                rel_l2.items())), flush=True)
        print('kernel flash_attn_bwd   controls: %s' % ', '.join(
            '%s max|err| %.3g (%.1fx the limit)' % (n, e, e / l)
            for n, (e, l) in controls.items()), flush=True)
        bad = [k for k, (e, l) in checks.items() if not e <= l]
        check(not bad, 'flash backward kernels disagree with the plain '
              'backward at B=%d H=%d T=%d D=%d %s causal=%s: %s' % (
                  B, H, T, D, dt, causal, bad))
        caught = [n for n, (e, l) in controls.items() if e > l]
        check(len(caught) == len(controls), 'the backward check does not '
              'catch a wrong kernel at B=%d H=%d T=%d D=%d %s causal=%s: '
              '%s' % (B, H, T, D, dt, causal,
                      sorted(set(controls) - set(caught))))

        def err(route, names):
            return max(checks[route, n][0] for n in names)
        common = dict(plain_ms=plain_ms, library_ms=library_ms)
        results[(B, H, T, D, dt, causal)] = {
            'flash_attn_bwd_dkvdq': dict(
                max_abs_err=err('merged', ('dq', 'dk', 'dv')),
                ms=merged_ms, bound_ms=bounds['merged'][0],
                bound_by=bounds['merged'][1], **common),
            'flash_attn_bwd_dq': dict(
                max_abs_err=err('two_pass', ('dq',)), ms=dq_ms,
                bound_ms=bounds['dq'][0], bound_by=bounds['dq'][1],
                **common),
            'flash_attn_bwd_dkv': dict(
                max_abs_err=err('two_pass', ('dk', 'dv')),
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
    of the host wall, and the kernels taking most device time. Returns
    ({kind: device us}, device busy us)."""
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
    return by_kind, busy_us


def _kernel_kind(name):
    """A device kernel's kind, for the profile's split of device time."""
    flash = re.search(r'flash_(?:fwd|bwd)_\w+?_kernel', name)
    if flash:
        # the kv-major backward <D, MERGED>: merged, or the dk/dv pass
        if flash.group(0) == 'flash_bwd_wgmma_kernel':
            merged = ', true>' in name or 'ELb1' in name
            return flash.group(0) + (' (merged)' if merged else
                                     ' (dk/dv pass)')
        return flash.group(0)
    if re.search(r'conv_(bf16|f32|depthwise|wgmma)_kernel', name):
        return 'fused_conv'
    if re.search(r'lstm_cell_(bf16|f32)_kernel', name):
        return 'lstm_cell'
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


def phase_serving(seed, artifacts):
    """5. Serve the flagship from a saved inference model; the artifact
    stays in ``artifacts`` for the serving runtime's phase."""
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
    d = artifacts['flagship'] = os.path.join(artifacts['dir'], 'flagship')
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
    opt, _ = pt.compiler.optimize(main.prune([prob]),
                                  fetch_names=[prob.name])
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


def conv_bound(x, w, aux, out, k, s, p, depthwise, extra_bytes=0):
    """Least time for one fused conv on these tensors: its products
    (2 operations a tap inside the input, per output channel and input
    channel, one input channel a channel when depthwise) at the dtype's
    peak, or the bytes it must move over HBM, whichever is longer: the
    input pixels the conv reads, w, the aux operands, the output and
    ``extra_bytes`` (the stats form's moments), each once."""
    N, H, W, cin = x.shape
    cout = out.shape[3]
    read_h, taps_h = _taps(H, k, s, p)
    read_w, taps_w = _taps(W, k, s, p)
    flops = 2 * N * cout * (1 if depthwise else cin) * taps_h * taps_w
    nbytes = (N * read_h * read_w * cin * x.element_size() + extra_bytes +
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


def conv_class(k, s, cin):
    """A ResNet-50 region's class for the per-class sums: the stem, 1x1
    stride 1, 1x1 stride 2, 3x3."""
    if cin % 8:
        return 'stem'
    return '1x1 s%d' % s if k == 1 else '%dx%d' % (k, k)


def print_classes(label, sums):
    """One line per conv class of {class: {'n': regions, key: ms}}."""
    for cls in sorted(sums):
        c = sums[cls]
        print('conv classes: %s, %s: %d regions, %s' % (
            label, cls, c['n'], ', '.join(
                '%s %.4f ms' % (k, c[k]) for k in c if k != 'n')),
            flush=True)


def _add_class(sums, cls, count, **ms):
    c = sums.setdefault(cls, {'n': 0})
    c['n'] += count
    for k, v in ms.items():
        c[k] = c.get(k, 0.0) + count * v


def phase_conv_kernels(seed):
    """The fused conv kernel vs its plain version at every distinct
    region shape of ResNet-50 at batch 32, and at extra cases, in bf16
    and f32; then at batch 1, 8 and 128 in bf16 (the first two are where
    the wgmma kernel splits K). Every bf16 case is launched twice and must
    give the same bits. Returns the bf16 numbers summed over one batch-32
    request (each shape times its count of regions)."""
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
    bound_by, classes = {}, {}

    def region_kinds(stages):
        return ('c', 'c', 't') if any(st[0] == 'bin' for st in stages) \
            else ('c', 'c')

    def check_case(x, w, aux, kinds, stages, s, p, dw, dtype, what):
        """Per element against the plain version, twice bit for bit
        (bf16), and the control with the batch-norm shift dropped: (max
        |err|, err / limit, the control's err / limit or None)."""
        args = (x, w, aux, kinds, stages, (s, s), (p, p), dw)
        got = ck.fused_conv(*args)
        same = dtype != 'bfloat16' or torch.equal(got, ck.fused_conv(*args))
        torch.cuda.synchronize()
        ref = ck.fused_conv_reference(*args)
        err = (got.float() - ref.float()).abs().max().item()
        ratio = conv_err_ratio(got, ref, dtype)
        shift = [st[2] for st in stages if st[0] == 'affine']
        control = None
        if shift:
            bad_aux = list(aux)
            bad_aux[shift[0]] = torch.zeros_like(aux[shift[0]])
            control = conv_err_ratio(ck.fused_conv(
                x, w, bad_aux, kinds, stages, (s, s), (p, p), dw), ref,
                dtype)
        check(same, 'fused_conv gave other bits on a second call at ' + what)
        check(ratio <= 1, 'fused_conv disagrees with its plain version at '
              + what)
        check(control is None or control > 1, 'the per-shape limit does not '
              'catch a dropped batch-norm shift at ' + what)
        return err, ratio, control

    for idx, ((H, W, cin, cout, k, s, p, stages), count, dw) in \
            enumerate(cases):
        kinds = region_kinds(stages) if idx < len(regions) else \
            extra_kinds[idx - len(regions)]
        for dtype in ('bfloat16', 'float32'):
            x, w, aux = _conv_inputs(gen, dtype, N, H, W, cin, cout, k, s,
                                     p, dw, kinds)
            args = (x, w, aux, kinds, stages, (s, s), (p, p), dw)
            what = 'N=%d %dx%d Cin=%d Cout=%d K=%d s=%d %s' % (
                N, H, W, cin, cout, k, s, dtype)
            err, ratio, control = check_case(x, w, aux, kinds, stages, s, p,
                                             dw, dtype, what)
            bound_ms, by = conv_bound(x, w, aux, x.new_empty(
                (N, (H + 2 * p - k) // s + 1, (W + 2 * p - k) // s + 1,
                 cout)), k, s, p, dw)
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
            plan = ck.fused_conv_plan(x.dtype, N, H, W, cin, cout, k, k,
                                      (s, s), (p, p), dw,
                                      ck._sm_count(x.device.index or 0))
            print('kernel fused_conv N=%d %dx%d Cin=%d Cout=%d K=%d s=%d '
                  'p=%d%s %s x%d [%s] %s: max|err| %.3g, err/limit %.3g '
                  '(shift dropped: %s); kernel_ms %.4f plain_ms %.4f '
                  'cudnn_ms %.4f bound_ms %.4f (%s)' % (
                      N, H, W, cin, cout, k, s, p,
                      ' depthwise' if dw else '', dtype, count,
                      ' '.join(st[0] if st[0] != 'act' else st[1]
                               for st in stages), _plan_label(plan), err,
                      ratio, 'n/a' if control is None else '%.3g' % control,
                      kernel_ms, plain_ms, library_ms, bound_ms, by),
                  flush=True)
            if dtype == 'bfloat16' and count:
                totals['ms'] += count * kernel_ms
                totals['plain_ms'] += count * plain_ms
                totals['library_ms'] += count * library_ms
                totals['bound_ms'] += count * bound_ms
                totals['max_abs_err'] = max(totals['max_abs_err'], err)
                bound_by[by] = bound_by.get(by, 0.0) + count * bound_ms
                _add_class(classes, conv_class(k, s, cin), count,
                           kernel=kernel_ms, cudnn=library_ms,
                           bound=bound_ms)
            del x, w, aux, args, xc, wc
    totals['bound_by'] = max(bound_by, key=bound_by.get)
    print('conv kernels: one batch-%d request, bf16, summed over its %d '
          'regions: kernel %.4f ms, plain %.4f ms, cuDNN conv alone %.4f ms, '
          'bound %.4f ms (%s-bound regions hold %.1f%% of it)' % (
              N, RESNET_REGIONS, totals['ms'], totals['plain_ms'],
              totals['library_ms'], totals['bound_ms'], totals['bound_by'],
              100 * bound_by[totals['bound_by']] / totals['bound_ms']),
          flush=True)
    print_classes('batch-%d request' % N, classes)

    # the served batches 1 and 8 (checked and timed: K splits act there)
    # and 128 (checked), bf16
    for n in CONV_CHECK_BATCHES:
        classes = {}
        for (H, W, cin, cout, k, s, p, stages), count in \
                sorted(regions.items()):
            kinds = region_kinds(stages)
            x, w, aux = _conv_inputs(gen, 'bfloat16', n, H, W, cin, cout, k,
                                     s, p, False, kinds)
            what = 'N=%d %dx%d Cin=%d Cout=%d K=%d s=%d bfloat16' % (
                n, H, W, cin, cout, k, s)
            err, ratio, control = check_case(x, w, aux, kinds, stages, s, p,
                                              False, 'bfloat16', what)
            plan = ck.fused_conv_plan(x.dtype, n, H, W, cin, cout, k, k,
                                      (s, s), (p, p), False,
                                      ck._sm_count(x.device.index or 0))
            timing = ''
            if n in CONV_TIMED_BATCHES:
                args = (x, w, aux, kinds, stages, (s, s), (p, p), False)
                kernel_ms = graph_ms(lambda: ck.fused_conv(*args))
                xc, wc = x.permute(0, 3, 1, 2), w.permute(0, 3, 1, 2)
                library_ms = graph_ms(lambda: F.conv2d(xc, wc, stride=s,
                                                       padding=p))
                bound_ms, by = conv_bound(x, w, aux, x.new_empty(
                    (n, (H + 2 * p - k) // s + 1, (W + 2 * p - k) // s + 1,
                     cout)), k, s, p, False)
                _add_class(classes, conv_class(k, s, cin), count,
                           kernel=kernel_ms, cudnn=library_ms,
                           bound=bound_ms)
                timing = '; kernel_ms %.4f cudnn_ms %.4f bound_ms %.4f ' \
                    '(%s)' % (kernel_ms, library_ms, bound_ms, by)
                del args, xc, wc
            print('kernel fused_conv N=%d %dx%d Cin=%d Cout=%d K=%d s=%d p=%d '
                  'bfloat16 x%d %s: err/limit %.3g (shift dropped: %s), two '
                  'calls bit-identical%s' % (
                      n, H, W, cin, cout, k, s, p, count, _plan_label(plan),
                      ratio, 'n/a' if control is None else '%.3g' % control,
                      timing), flush=True)
            del x, w, aux
        if classes:
            print_classes('batch-%d request' % n, classes)
        torch.cuda.empty_cache()
    torch.cuda.empty_cache()
    return totals


def _plan_label(plan):
    """A FusedConvPlan as a short label: variant, tile width, K
    splits."""
    if plan.variant != 'wgmma':
        return plan.variant
    return 'wgmma BN %d splits %d' % (plan.bn, plan.splits)


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


def phase_resnet_serving(seed, artifacts):
    """6. Serve ResNet-50 at full width from a saved inference model. A
    second artifact of the same model, fetching its logits and its
    probabilities, stays in ``artifacts`` for the serving runtime's
    phase."""
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
    softmax, = [op for op in main.global_block().ops
                if op.type == 'softmax']
    logits_var = main.global_block().var(softmax.input('X')[0])
    artifacts['resnet'] = os.path.join(artifacts['dir'], 'resnet')
    pt_io.save_inference_model(artifacts['resnet'], ['img'],
                               [logits_var, prob], exe, main_program=main,
                               scope=init_scope)
    with tempfile.TemporaryDirectory(dir=artifacts['dir']) as d:
        pt_io.save_inference_model(d, ['img'], [prob], exe,
                                   main_program=main, scope=init_scope)
        del init_scope
        scope = pt.Scope()
        prog, feed_names, fetch_vars = pt_io.load_inference_model(
            d, exe, scope=scope)
    block = prog.global_block()
    logits_name = logits_var.name
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
        variants = dict(ck.FUSED_CONV_VARIANT_LAUNCHES)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        out, = exe.run(prog, feed=feed, fetch_list=fetch_vars, scope=scope)
        dt = time.perf_counter() - t1
        n = ck.LAUNCHES['fused_conv'] - before
        variants = {v: c - variants[v]
                    for v, c in ck.FUSED_CONV_VARIANT_LAUNCHES.items()}
        times.append(dt)
        images += bs
        print('resnet request %d: batch %d, %.2f ms, %.1f images/s, %d fused '
              'conv launches (by variant %s), fallbacks %s' % (
                  i, bs, 1e3 * dt, bs / dt, n, variants, passes.FALLBACKS),
              flush=True)
        check(variants == RESNET_VARIANTS, 'request %d took the fused conv '
              'variants %s, expected %s' % (i, variants, RESNET_VARIANTS))
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


# ---- 6b. the serving runtime ------------------------------------------------------
# the buckets each model warms, the rows its clients send (a seeded mix,
# RUNTIME_CLIENTS threads at once, each sending it RUNTIME_ROUNDS times),
# the requests timed per bucket (enough for a p99 that is not the
# largest of a handful)
RUNTIME_BUCKETS = {'flagship': [1, 2, 4], 'resnet': [1, 2, 4, 8, 16, 32]}
RUNTIME_MIX = {'flagship': [1, 2, 3, 4], 'resnet': [1, 5, 8, 17, 32]}
RUNTIME_CLIENTS = 4
RUNTIME_ROUNDS = 5
RUNTIME_TIMED = 100
# the folded Inferencer (ResNet-50, batch 8). In f32 (AMP off) the fold
# only re-associates each batch norm's affine: its logits within 1e-4 of
# their scale of the unfolded model's (the whole-model parity tolerance).
# Under AMP the folded weights round to bf16 apart from the unfolded ones
# and the two drift apart through 53 regions (0.1258 of the logits'
# scale on an H100, past the serving limit of 0.1 that holds a kernel
# against its plain version on the same bf16 weights); so each is held
# against the f32 witness, the folded at most 2x as far from it as the
# unfolded, the rule for AMP limits elsewhere in this script
FOLD_F32_TOL = 1e-4
FOLD_WITNESS = 2.0


def _percentiles(samples):
    ms = np.asarray(samples) * 1e3
    return float(np.percentile(ms, 50)), float(np.percentile(ms, 99))


def _runtime_feed(name, rows, seed):
    return _feed(rows, seed) if name == 'flagship' else \
        _image_feed(rows, seed)


def _hold_to_direct(name, got, ref):
    """A served answer against the direct run of the same rows, by the
    serving limits: (max |diff| (ResNet: over max |logits|), top-1
    agreements, rows, bits equal)."""
    diff = float(np.abs(got - ref).max())
    if name == 'resnet':
        diff /= float(np.abs(ref).max())
    agree = int((got.argmax(-1) == ref.argmax(-1)).sum())
    return diff, agree, int(np.prod(ref.shape[:-1])), \
        bool(np.array_equal(got, ref))


def _check_agreement(label, name, holds):
    diff = max(h[0] for h in holds)
    top1 = sum(h[1] for h in holds) / float(sum(h[2] for h in holds))
    equal = sum(h[3] for h in holds)
    tol, min_top1 = (LOGITS_TOL, TOP1_AGREEMENT) if name == 'flagship' \
        else (RESNET_LOGITS_TOL, RESNET_TOP1)
    print('serving runtime: %s, %s: %d answers vs the direct run of the '
          'same rows: max |diff|%s %.4g (tol %g), top-1 agreement %.4f '
          '(min %g), bits equal in %d of %d' % (
              label, name, len(holds),
              ' / max |logits|' if name == 'resnet' else '', diff, tol,
              top1, min_top1, equal, len(holds)), flush=True)
    check(diff <= tol, '%s: %s answers differ from the direct run by %g'
          % (label, name, diff))
    check(top1 >= min_top1, '%s: %s top-1 agreement %g' % (label, name,
                                                          top1))
    return equal == len(holds)


def _absorbed(program, fetch_names):
    """Elementwise ops the default pipeline absorbs into fused_conv
    regions over conv_epilogue_fuse alone, and the regions that took
    them."""
    import paddle_tpu_torch as pt

    def regions(passes):
        opt, _ = pt.compiler.PassPipeline(passes).run(
            program, protected=fetch_names)
        return [op.attrs['fused_count'] for op in opt.global_block().ops
                if op.type == 'fused_conv']
    alone = regions(['conv_epilogue_fuse'])
    full = regions(list(pt.compiler.DEFAULT_PASSES))
    return sum(full) - sum(alone), sum(a != b for a, b in zip(alone, full))


def _bucket_entry(server, name, bucket):
    """The tuning entry the server's lowering of ``name`` at ``bucket``
    rows runs under (None: untuned)."""
    from paddle_tpu_torch.compiler import tuning
    from paddle_tpu_torch.executor import feed_signature
    m = server.registry.get(name)
    exe = server.executor
    sig = feed_signature(exe._prepare_feed(m.program,
                                           m.synthetic_feed(bucket)))
    return tuning.default_cache().lookup(
        m.program.fingerprint(), tuning.shape_signature(sig),
        tuning.backend(exe.device), count=False)


def _serve_mix(server, seed, card, label):
    """Phase 6b's seeded mix from RUNTIME_CLIENTS concurrent clients
    through ``server`` (warmed): every answer against a direct
    Executor.run of the same rows under the entry of the bucket the
    server ran it at (serving limits, bits equal counted), each ResNet-50
    answer also against a direct run of its rows padded to that bucket
    (bit for bit); exact launch counts a batch, no memo miss, no
    fallback, no failed request, closed breakers. Returns the launches
    and the requests' trace contexts."""
    import threading
    import torch
    from paddle_tpu_torch.compiler import passes, tuning
    from paddle_tpu_torch.ops import cuda_kernels as ck
    from paddle_tpu_torch.serving import next_pow2
    from paddle_tpu_torch.serving.bucketing import pad_feed
    exe = server.executor
    models = {name: server.registry.get(name) for name in RUNTIME_BUCKETS}

    def direct(name, feed, entry=None):
        m = models[name]
        with tuning.apply_entry(entry):
            return exe.run(m.program, feed=feed, fetch_list=m.fetch_vars,
                           scope=m.scope)

    # the seeded mix: each client sends every row count of both models
    # once a round, in its own order, and waits for each answer before
    # the next
    rng = np.random.RandomState(seed + 60)
    plans = []
    for k in range(RUNTIME_CLIENTS):
        plan = []
        for r in range(RUNTIME_ROUNDS):
            reqs = [(name, rows, seed + 10000 * r + 1000 * k + 10 * i + rows)
                    for name, mix in sorted(RUNTIME_MIX.items())
                    for i, rows in enumerate(mix)]
            plan += [reqs[i] for i in rng.permutation(len(reqs))]
        plans.append(plan)
    answers, requests, errors, lat = {}, {}, [], {}
    # the bucket each request ran at, as the worker padded its batch
    ran_at = {}
    real_run_batch = server._run_batch

    def run_batch(model, batch):
        rows = sum(r.n for r in batch)
        bucket = server.policy.bucket_for(rows) if model.batchable else rows
        for r in batch:
            ran_at[id(r)] = bucket
        return real_run_batch(model, batch)

    def client(plan):
        try:
            for name, rows, s in plan:
                t1 = time.perf_counter()
                req = server.submit(name, _runtime_feed(name, rows, s))
                out = req.result(timeout=600)
                lat.setdefault((name, next_pow2(rows)), []).append(
                    time.perf_counter() - t1)
                answers[(name, rows, s)] = out
                requests[(name, rows, s)] = req
        except Exception as e:                  # noqa: BLE001
            errors.append(e)

    server._run_batch = run_batch
    server.executor.reset_cache_info()
    before = dict(server.stats.model_batches)
    ck.reset_launch_counts()
    threads = [threading.Thread(target=client, args=(p,)) for p in plans]
    t1 = time.perf_counter()
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        torch.cuda.synchronize()
    finally:
        server._run_batch = real_run_batch
    dt = time.perf_counter() - t1
    launches = dict(ck.LAUNCHES)
    variants = dict(ck.FUSED_CONV_VARIANT_LAUNCHES)
    batches = {name: server.stats.model_batches.get(name, 0) -
               before.get(name, 0) for name in RUNTIME_BUCKETS}
    info = server.cache_info()
    stats = server.stats_dict()
    print('serving runtime: %s: %d clients, %d requests (%s rows of the '
          'flagship, %s of ResNet-50 each, %d rounds) in %.2f s; batches '
          '%s, by bucket %s, occupancy %.3f; memo after warm-up %s; '
          'launches %s; fused conv by variant %s; fallbacks %s; breakers %s'
          % (label, RUNTIME_CLIENTS, len(answers), RUNTIME_MIX['flagship'],
              RUNTIME_MIX['resnet'], RUNTIME_ROUNDS, dt, batches,
              stats['batches']['bucket_counts'],
              stats['batches']['occupancy'], info, launches, variants,
              passes.FALLBACKS,
              {n: server.breaker(n).state for n in RUNTIME_BUCKETS}),
          flush=True)
    check(not errors, 'a client failed: %r' % (errors[:1],))
    check(len(answers) == RUNTIME_CLIENTS * RUNTIME_ROUNDS * sum(
        len(m) for m in RUNTIME_MIX.values()), 'answers missing')
    check(stats['requests']['failed'] == 0 and
          stats['requests']['expired'] == 0 and
          stats['requests']['shed'] == 0, 'requests failed: %s'
          % stats['requests'])
    check(info.misses == 0, 'memo missed after warm-up: %s' % (info,))
    check(all(server.breaker(n).state == 'closed' for n in RUNTIME_BUCKETS),
          'a breaker opened')
    check(not passes.FALLBACKS, 'fused_conv fell back: %s'
          % passes.FALLBACKS)
    expect = dict.fromkeys(launches, 0)
    expect.update(flash_attn_fwd=FLAGSHIP['n_layers'] * batches['flagship'],
                  fused_conv=RESNET_REGIONS * batches['resnet'])
    check(launches == expect, '%s launches %s, expected %s (6 flash '
          'forwards a flagship batch, 53 fused convs a ResNet batch)'
          % (label, launches, expect))
    check(variants == {v: c * batches['resnet']
                       for v, c in RESNET_VARIANTS.items()},
          'fused conv variants %s over %d ResNet batches' % (
              variants, batches['resnet']))
    MIX_LATENCY[label] = lat
    for (name, bucket), samples in sorted(lat.items()):
        p50, p99 = _percentiles(samples)
        print('serving runtime: %s, %s, requests of bucket %d: %d, p50 '
              '%.2f ms, p99 %.2f ms; %s' % (label, name, bucket,
                                             len(samples), p50, p99, card),
              flush=True)
    # each answer against the direct run of its rows, one by one, under
    # the entry of the bucket it ran at; ResNet-50's also against its
    # rows padded to that bucket (same batch, same plans: same bits
    # unless the server path is at fault)
    entries = {}
    holds = {name: [] for name in RUNTIME_BUCKETS}
    padded_equal, padded_diff, unpadded_pow2 = 0, 0.0, [0, 0]
    for key, out in sorted(answers.items()):
        name, rows, s = key
        bucket = ran_at[id(requests[key])]
        if (name, bucket) not in entries:
            entries[(name, bucket)] = _bucket_entry(server, name, bucket)
        entry = entries[(name, bucket)]
        feed = _runtime_feed(name, rows, s)
        ref = direct(name, feed, entry)
        check(out[0].shape == ref[0].shape and np.isfinite(out[0]).all(),
              'answer %s' % (key,))
        holds[name].append(_hold_to_direct(name, out[0], ref[0]))
        if name != 'resnet':
            continue
        if rows == bucket:
            unpadded_pow2[0] += 1
            unpadded_pow2[1] += holds[name][-1][3]
        padded = direct(name, pad_feed(feed, rows, bucket,
                                       server.policy.pad_mode), entry)
        got = padded[0][:rows]
        padded_equal += bool(np.array_equal(out[0], got))
        padded_diff = max(padded_diff, float(np.abs(out[0] - got).max()))
    for name in RUNTIME_BUCKETS:
        _check_agreement(label, name, holds[name])
    n_resnet = len(holds['resnet'])
    print('serving runtime: %s, ResNet-50: %d of %d answers bit-equal to a '
          'direct run of their rows padded to the bucket the server ran '
          'them at (max |diff| %.3g); unpadded, the answers whose rows fill '
          'their bucket: %d of %d bit-equal' % (
              label, padded_equal, n_resnet, padded_diff, unpadded_pow2[1],
              unpadded_pow2[0]), flush=True)
    check(padded_equal == n_resnet, '%s: %d of %d ResNet-50 answers differ '
          'from the direct run padded to their bucket' % (
              label, n_resnet - padded_equal, n_resnet))
    return launches, [r.trace for r in requests.values()]


def phase_serving_runtime(seed, card, artifacts):
    """6b. Serve the flagship and ResNet-50 from their saved models
    through one ModelServer on the card: warm-up, a seeded mix from
    concurrent clients, latency per bucket, the pipeline's configurations
    and a folded Inferencer."""
    import threading
    import torch
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.compiler import passes
    from paddle_tpu_torch.core import amp
    from paddle_tpu_torch.models.resnet import resnet_imagenet
    from paddle_tpu_torch.ops import cuda_kernels as ck
    from paddle_tpu_torch.serving import ModelServer

    t0 = time.perf_counter()
    server = ModelServer(pt.CUDAPlace(0), max_batch_size=32)
    for name in RUNTIME_BUCKETS:
        server.load_model(name, artifacts[name])
    passes.reset_fallback_counts()
    warmed = {}
    for name, buckets in RUNTIME_BUCKETS.items():
        warmed.update(server.warmup(name, upto=buckets[-1]))
    check(warmed == RUNTIME_BUCKETS, 'warmed %s, expected %s'
          % (warmed, RUNTIME_BUCKETS))
    print('serving runtime: flagship and ResNet-50 loaded into one '
          'ModelServer(CUDAPlace(0)) and every bucket warmed (%s) in %.1f '
          's; pipeline %s; memo %s' % (
              warmed, time.perf_counter() - t0,
              pt.compiler.pipeline_signature(), server.cache_info()),
          flush=True)
    exe = server.executor
    models = {name: server.registry.get(name) for name in RUNTIME_BUCKETS}

    def direct(name, feed):
        m = models[name]
        return exe.run(m.program, feed=feed, fetch_list=m.fetch_vars,
                       scope=m.scope)

    launches, _ = _serve_mix(server, seed, card, 'concurrent mix')

    # latency per bucket: one client, then the direct run at the same
    # batch, each answer fetched to the host; beside them the worker's
    # own Executor.run (inside the server) and a direct run from a
    # thread of its own, to split the server's overhead
    worker_s = []
    real_exe_run = server._exe_run

    def timed_exe_run(model, feed):
        t1 = time.perf_counter()
        out = real_exe_run(model, feed)
        worker_s.append(time.perf_counter() - t1)
        return out
    server._exe_run = timed_exe_run

    def in_thread(fn):
        t = threading.Thread(target=fn)
        t1 = time.perf_counter()
        t.start()
        t.join()
        return time.perf_counter() - t1

    for name, buckets in RUNTIME_BUCKETS.items():
        for b in buckets:
            feed = _runtime_feed(name, b, seed + 70 + b)
            served, direct_s, threaded = [], [], []
            del worker_s[:]
            for i in range(RUNTIME_TIMED + 1):
                torch.cuda.synchronize()
                t1 = time.perf_counter()
                server.infer(name, feed, timeout=600)
                t2 = time.perf_counter()
                direct(name, feed)
                t3 = time.perf_counter()
                threaded.append(in_thread(lambda: direct(name, feed)))
                if i:                          # the first round warms up
                    served.append(t2 - t1)
                    direct_s.append(t3 - t2)
            (s50, s99), (d50, d99) = _percentiles(served), \
                _percentiles(direct_s)
            print('serving runtime: %s batch %d: server p50 %.2f ms, p99 '
                  '%.2f ms; direct Executor.run p50 %.2f ms, p99 %.2f ms; '
                  'server overhead at p50 %.2f ms (%d requests each); the '
                  "worker's Executor.run p50 %.2f ms, a direct run from "
                  'another thread p50 %.2f ms; %s' % (
                      name, b, s50, s99, d50, d99, s50 - d50, RUNTIME_TIMED,
                      _percentiles(worker_s[1:])[0],
                      _percentiles(threaded[1:])[0], card), flush=True)
    server._exe_run = real_exe_run

    # the pipeline: conv_epilogue_fuse alone against the default passes
    probe = {'flagship': _feed(2, seed + 80),
             'resnet': _image_feed(8, seed + 80)}
    outs = {}
    for label, pipeline in (('conv_epilogue_fuse', ['conv_epilogue_fuse']),
                            ('default', None)):
        pt.compiler.set_default_passes(pipeline)
        exe.reset_cache_info()
        outs[label] = {n: server.infer(n, f, timeout=600)
                       for n, f in probe.items()}
        print('serving runtime: pipeline %s: memo %s' % (
            pt.compiler.pipeline_signature(), exe.cache_info()), flush=True)
    for name in RUNTIME_BUCKETS:
        m = models[name]
        n_ops, n_regions = _absorbed(m.program, m.fetch_names)
        a, b = outs['conv_epilogue_fuse'][name], outs['default'][name]
        equal = all(np.array_equal(x, y) for x, y in zip(a, b))
        print('serving runtime: %s, conv_epilogue_fuse alone vs the default '
              'passes: %d elementwise ops absorbed into %d fused conv '
              'regions; outputs bit-equal: %s' % (name, n_ops, n_regions,
                                                  equal), flush=True)
        if n_ops == 0:
            check(equal, '%s: the exact passes changed the answer' % name)
        else:
            _check_agreement('pipelines', name, [_hold_to_direct(
                name, b[0], a[0])])
    check(not passes.FALLBACKS, 'fused_conv fell back: %s'
          % passes.FALLBACKS)
    # the unfolded model's logits under AMP (bf16) and in f32 (AMP off,
    # the witness for the fold below)
    resnet_ref = outs['default']['resnet'][0]
    amp.set_amp(False)
    try:
        resnet_f32 = direct('resnet', probe['resnet'])[0]
    finally:
        amp.set_amp(None)
    server.close(timeout=60)
    del server, models

    # ResNet-50 through an Inferencer with the batch norms folded
    def logits_func():
        img = pt.layers.data(name='img', shape=[3, 224, 224],
                             dtype='float32')
        resnet_imagenet(img, 1000, depth=50, is_test=True)
        block = pt.default_main_program().global_block()
        softmax, = [op for op in block.ops if op.type == 'softmax']
        return block.var(softmax.input('X')[0])

    inf = pt.Inferencer(logits_func, artifacts['resnet'],
                        place=pt.CUDAPlace(0), optimize_for_inference=True)
    types = [op.type for op in inf.inference_program.global_block().ops]
    inf.infer(probe['resnet'])                # warm-up
    ck.reset_launch_counts()
    folded, = inf.infer(probe['resnet'])
    inf_launches = dict(ck.LAUNCHES)
    amp.set_amp(False)
    try:
        folded_f32, = inf.infer(probe['resnet'])
    finally:
        amp.set_amp(None)
    print('serving runtime: Inferencer(optimize_for_inference=True), '
          'ResNet-50: %d batch_norm ops left, %d fused_conv ops; launches a '
          'request %s; fallbacks %s' % (
              types.count('batch_norm'), types.count('fused_conv'),
              inf_launches, passes.FALLBACKS), flush=True)
    check('batch_norm' not in types, 'the folded program keeps batch_norm')
    expect = dict.fromkeys(inf_launches, 0)
    expect['fused_conv'] = RESNET_REGIONS
    check(inf_launches == expect, 'folded Inferencer launches %s'
          % inf_launches)
    check(not passes.FALLBACKS, 'fused_conv fell back: %s'
          % passes.FALLBACKS)
    # the fold in f32: within the fold's drift of the unfolded logits
    scale = float(np.abs(resnet_f32).max())
    f32_diff = float(np.abs(folded_f32 - resnet_f32).max()) / scale
    print('serving runtime: folded Inferencer in f32 (AMP off) vs the '
          'unfolded model in f32: max |diff| / max |logits| %.4g (tol %g)'
          % (f32_diff, FOLD_F32_TOL), flush=True)
    check(f32_diff <= FOLD_F32_TOL, 'the fold moved the f32 logits by %g'
          % f32_diff)
    # under AMP the folded weights round to bf16 apart from the unfolded
    # ones: each held against the f32 witness, the fold at most
    # FOLD_WITNESS times as far from it as the unfolded model
    err_folded = float(np.abs(folded - resnet_f32).max()) / scale
    err_unfolded = float(np.abs(resnet_ref - resnet_f32).max()) / scale
    diff, agree, rows, equal = _hold_to_direct('resnet', folded, resnet_ref)
    print('serving runtime: under AMP, max |diff| / max |logits| against '
          'the f32 witness: folded Inferencer %.4g, unfolded server %.4g '
          '(ratio %.3f, max %g); folded vs unfolded %.4g (the serving '
          'limit %g), top-1 agreement %.4f (min %g)' % (
              err_folded, err_unfolded,
              err_folded / max(err_unfolded, 1e-30),
              FOLD_WITNESS, diff, RESNET_LOGITS_TOL, agree / float(rows),
              RESNET_TOP1), flush=True)
    check(err_folded <= FOLD_WITNESS * err_unfolded, 'the folded logits '
          'are %g from the f32 witness, the unfolded %g' % (
              err_folded, err_unfolded))
    check(agree / float(rows) >= RESNET_TOP1, 'folded top-1 agreement %g'
          % (agree / float(rows)))
    del inf
    return launches


# phase 6c: the autotuned server. Requests a timed batch-1 request count
# with and without a journal (medians of JOURNAL_COST_REQUESTS each, in two
# alternating halves); the fixed requests the second process answers too
JOURNAL_COST_REQUESTS = 50
SECOND_PROCESS_TIMEOUT = 300


def _fixed_requests(seed):
    """One seeded request per bucket of each model, served one at a
    time, so each runs at its own bucket in both processes."""
    return [(name, b, seed + 90 + b) for name, buckets in
            sorted(RUNTIME_BUCKETS.items()) for b in buckets]


def _named_report(report, cands):
    """A tuner's report (entry token -> ms) keyed by the entries."""
    from paddle_tpu_torch.compiler import tuning
    names = {tuning.entry_token(c) if c else 'baseline':
             json.dumps(c, sort_keys=True) for c in cands}
    return '; '.join('%s %s' % (names.get(t, t), v)
                     for t, v in report.items())


def _tuned_server(config, journal_path):
    """A fresh ModelServer(CUDAPlace(0)) on both saved models, the
    default tuning cache at ``config['cache']``, a journal installed at
    ``journal_path``; warmed with autotune=True, each model up to its
    last bucket. Returns (server, journal, warmed, seconds)."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch import observability as obs
    from paddle_tpu_torch.compiler import tuning
    from paddle_tpu_torch.serving import ModelServer
    tuning.set_default_cache(tuning.TuningCache(config['cache']))
    journal = obs.RunJournal(journal_path)
    obs.set_journal(journal)
    server = ModelServer(pt.CUDAPlace(0), max_batch_size=32)
    for name in RUNTIME_BUCKETS:
        server.load_model(name, config[name])
    t0 = time.perf_counter()
    warmed = {}
    for name, buckets in RUNTIME_BUCKETS.items():
        warmed.update(server.warmup(name, upto=buckets[-1], autotune=True))
    return server, journal, warmed, time.perf_counter() - t0


def _answer_fixed(server, seed):
    return {'%s-%d' % (name, rows): server.infer(
        name, _runtime_feed(name, rows, s), timeout=600)[0]
        for name, rows, s in _fixed_requests(seed)}


def serve_tuned(config_path):
    """The second process of phase 6c (``--serve-tuned CONFIG``): the same
    cache file and saved models, warm-up with autotune=True (every entry
    preloaded, so no search), then the fixed requests, whose answers it
    saves for the first process to compare bit for bit."""
    from paddle_tpu_torch import observability as obs
    with open(config_path) as f:
        config = json.load(f)
    server, journal, warmed, dt = _tuned_server(config, config['journal2'])
    answers = _answer_fixed(server, config['seed'])
    server.close(timeout=60)
    obs.set_journal(None)
    journal.close()
    np.savez(config['answers2'], **answers)
    print('second process: warmed %s with autotune=True in %.1f s; %d '
          'answers saved' % (warmed, dt, len(answers)), flush=True)
    return 0


def _span_trees(journal_path, traces):
    """tools/trace_report.py's trees of the journal: for each traced
    request, whether its tree (batch spans grafted through their links)
    is closed and holds request -> queue -> batch -> pad -> run."""
    sys.path.insert(0, os.path.join(ROOT, 'tools'))
    import trace_report
    store = trace_report.build_store([journal_path])
    unclosed = store.unclosed()
    missing = []
    for ctx in traces:
        sp = store.spans.get(ctx.span_id)
        names = set()
        if sp is not None and sp['closed']:
            names = {store.spans[i]['name']
                     for i in store.subtree_ids(ctx.span_id,
                                                follow_links=True)}
        want = ('serving/request', 'serving/queue', 'serving/batch',
                'serving/pad', 'serving/run')
        if not all(n in names for n in want):
            missing.append((ctx.span_id, sorted(names)))
    return store, unclosed, missing


def phase_autotuned_serving(seed, card, artifacts):
    """6c. A fresh ModelServer on both saved models with a tuning cache
    at a temporary path and a journal: warm-up with autotune=True, the
    winners; phase 6b's mix under the tuned entries; p50/p99 tuned and at
    the baseline entry; the journal's cost; a second process that finds
    every entry and searches nothing, with bit-equal answers; a poisoned
    candidate; the span trees through tools/trace_report.py and
    tools/obs_report.py."""
    import subprocess
    import torch
    import paddle_tpu_torch as pt
    from paddle_tpu_torch import observability as obs
    from paddle_tpu_torch.compiler import passes, tuning
    from paddle_tpu_torch.resilience import faultinject as fi

    work = os.path.join(artifacts['dir'], 'autotune')
    os.makedirs(work)
    config = dict(cache=os.path.join(work, 'tuning_cache.json'),
                  journal2=os.path.join(work, 'second.jsonl'),
                  answers2=os.path.join(work, 'second.npz'), seed=seed,
                  **{name: artifacts[name] for name in RUNTIME_BUCKETS})
    journal_path = os.path.join(work, 'first.jsonl')
    untuned_cache = tuning.default_cache()
    passes.reset_fallback_counts()
    server, journal, warmed, search_s = _tuned_server(config, journal_path)
    tuned_cache = tuning.default_cache()
    try:
        check(warmed == RUNTIME_BUCKETS, 'warmed %s' % (warmed,))
        journal.flush()
        records, _ = obs.read_journal(journal_path)
        ends = [r for r in records if r['ev'] == 'autotune' and
                r['phase'] == 'end']
        searches = [r['autotune_searches'] for r in records
                    if r['ev'] == 'serving_warmup']
        print('autotuned serving: warm-up with autotune=True of both models '
              '(%s) in %.1f s: %d searches, %d entries in %s; %s' % (
                  warmed, search_s, sum(searches), len(tuned_cache),
                  config['cache'], card), flush=True)
        by_model = {name: [r for r in ends if r['program'] == name]
                    for name in RUNTIME_BUCKETS}
        for name, buckets in RUNTIME_BUCKETS.items():
            check(len(by_model[name]) == len(buckets), '%s: %d searches for '
                  '%d buckets' % (name, len(by_model[name]), len(buckets)))
            m = server.registry.get(name)
            for bucket, r in zip(buckets, by_model[name]):
                entry = _bucket_entry(server, name, bucket)
                cands = tuning.Autotuner(pt.CUDAPlace(0)).candidates(
                    m.program, m.synthetic_feed(bucket))
                print('autotuned serving: %s bucket %d: candidates (ms a '
                      'run) %s; winner %s (%.3f ms); search %.2f s' % (
                          name, bucket, _named_report(r['report'], cands),
                          r['winner'] or 'baseline {}', r['best_ms'],
                          r['seconds']), flush=True)
                check(entry == r['winner'], '%s bucket %d: cached entry %s, '
                      'winner %s' % (name, bucket, entry, r['winner']))
                check(r['poisoned'] == 0, '%s bucket %d: a candidate '
                      'failed: %s' % (name, bucket, r['report']))

        # the mix under the tuned entries
        launches, traces = _serve_mix(server, seed, card, 'tuned mix')

        # the journal's cost: batch-1 requests without and with a journal
        cost = {}
        for name in RUNTIME_BUCKETS:
            feed = _runtime_feed(name, 1, seed + 95)
            server.infer(name, feed, timeout=600)
            times = {'off': [], 'on': []}
            for half in range(2):
                for mode in ('off', 'on'):
                    obs.set_journal(journal if mode == 'on' else None)
                    for _ in range(JOURNAL_COST_REQUESTS // 2):
                        t1 = time.perf_counter()
                        server.infer(name, feed, timeout=600)
                        times[mode].append(time.perf_counter() - t1)
            obs.set_journal(journal)
            cost[name] = {m: float(np.median(v)) * 1e3
                          for m, v in times.items()}
            print('autotuned serving: journal cost, %s batch 1: no journal '
                  '%.3f ms, journal installed %.3f ms (medians of %d, '
                  'alternating halves; %+.3f ms); %s' % (
                      name, cost[name]['off'], cost[name]['on'],
                      JOURNAL_COST_REQUESTS,
                      cost[name]['on'] - cost[name]['off'], card),
                  flush=True)

        # the span trees of the mix's requests, through the tools
        journal.flush()
        store, unclosed, missing = _span_trees(journal_path, traces)
        print('autotuned serving: trace_report: %d spans, %d traced '
              'requests of the mix, %d unclosed spans, %d requests without '
              'a closed request -> queue -> batch -> pad -> run tree' % (
                  len(store.spans), len(traces), len(unclosed),
                  len(missing)), flush=True)
        check(traces and all(t is not None for t in traces),
              'untraced requests in the mix')
        check(not unclosed and not missing, 'span trees: unclosed %s, '
              'incomplete %s' % (unclosed[:2], missing[:2]))
        for tool, args in (('trace_report.py', ['--kind', 'serving/request',
                                                '--json', '-']),
                           ('obs_report.py', ['--smoke', '--require',
                                              'serving']),
                           ('obs_report.py', ['--smoke', '--require',
                                              'autotune']),
                           ('obs_report.py', ['--smoke', '--require',
                                              'tracing'])):
            proc = subprocess.run(
                [sys.executable, os.path.join(ROOT, 'tools', tool),
                 journal_path] + args, capture_output=True, text=True,
                timeout=300)
            tail = proc.stdout.strip().splitlines()[-1:] or ['']
            print('autotuned serving: tools/%s %s: exit %d; %s' % (
                tool, ' '.join(args), proc.returncode, tail[0][:200]),
                flush=True)
            check(proc.returncode == 0, 'tools/%s %s failed: %s %s' % (
                tool, args, proc.stdout[-2000:], proc.stderr[-2000:]))

        # p50 and p99 a request per bucket, tuned and at the baseline
        # entry (no cache entry: the kernels' rules), in turns
        for name, buckets in RUNTIME_BUCKETS.items():
            for b in buckets:
                feed = _runtime_feed(name, b, seed + 70 + b)
                got = {}
                for label, cache in (('tuned', tuned_cache),
                                     ('baseline', untuned_cache)):
                    tuning.set_default_cache(cache)
                    samples = []
                    for i in range(RUNTIME_TIMED + 1):
                        torch.cuda.synchronize()
                        t1 = time.perf_counter()
                        server.infer(name, feed, timeout=600)
                        if i:                  # the first warms up
                            samples.append(time.perf_counter() - t1)
                    got[label] = _percentiles(samples)
                tuning.set_default_cache(tuned_cache)
                print('autotuned serving: %s batch %d (entry %s): tuned p50 '
                      '%.2f ms, p99 %.2f ms; baseline p50 %.2f ms, p99 %.2f '
                      'ms (%d requests each); %s' % (
                          name, b, _bucket_entry(server, name, b) or '{}',
                          got['tuned'][0], got['tuned'][1],
                          got['baseline'][0], got['baseline'][1],
                          RUNTIME_TIMED, card), flush=True)
        first = _answer_fixed(server, seed)

        # a candidate made to fault is poisoned and the search goes on
        m = server.registry.get('resnet')
        faulty = tuning.Autotuner(pt.CUDAPlace(0), cache=tuning.TuningCache(
            os.path.join(work, 'fault.json')), warmup=0, steps=1)
        with fi.fault_plan() as plan:
            plan.inject(fi.SITE_TUNING_MEASURE, at=[1])
            best, report = faulty.tune(m.program, m.synthetic_feed(1),
                                       m.fetch_vars, scope=m.scope,
                                       persist=False, name='resnet-fault')
        poisoned = [t for t, v in report.items() if isinstance(v, str)]
        print('autotuned serving: a fault injected at %s into the second '
              'candidate: report %s; winner %s' % (
                  fi.SITE_TUNING_MEASURE, _named_report(
                      report, faulty.candidates(m.program,
                                                m.synthetic_feed(1))),
                  best), flush=True)
        check(len(poisoned) == 1 and len(report) >= 3 and
              all(isinstance(v, float) for t, v in report.items()
                  if t not in poisoned), 'the faulted search: %s' % report)
    finally:
        server.close(timeout=60)
        obs.set_journal(None)
        journal.close()
        tuning.set_default_cache(untuned_cache)
    check(not passes.FALLBACKS, 'fused_conv fell back: %s'
          % passes.FALLBACKS)

    # a second process on the same cache file and saved models
    config_path = os.path.join(work, 'config.json')
    with open(config_path, 'w') as f:
        json.dump(config, f)
    t1 = time.perf_counter()
    proc = subprocess.run([sys.executable, os.path.abspath(__file__),
                           '--serve-tuned', config_path],
                          capture_output=True, text=True,
                          timeout=SECOND_PROCESS_TIMEOUT)
    print('autotuned serving: second process exited %d in %.1f s: %s' % (
        proc.returncode, time.perf_counter() - t1,
        proc.stdout.strip().splitlines()[-1:]), flush=True)
    check(proc.returncode == 0, 'the second process failed: %s' %
          proc.stderr[-3000:])
    records, malformed = obs.read_journal(config['journal2'])
    preloads = [r for r in records if r['ev'] == 'tuning_preload']
    searched = [r for r in records if r['ev'] == 'autotune']
    second = dict(np.load(config['answers2']))
    equal = [k for k in first if np.array_equal(first[k], second[k])]
    print('autotuned serving: second process: first tuning_preload %s; '
          '%d autotune events; answers bit-equal to the first process at '
          'the same bucket: %d of %d (%s)' % (
              {k: preloads[0][k] for k in ('entries', 'loaded')}
              if preloads else None, len(searched), len(equal), len(first),
              ', '.join(sorted(set(first) - set(equal))) or 'all'),
          flush=True)
    check(preloads and preloads[0]['loaded'] == preloads[0]['entries'] ==
          len(tuned_cache), 'the second process preloaded %s of %d entries'
          % (preloads[:1], len(tuned_cache)))
    check(not searched, 'the second process searched: %s' % searched[:1])
    check(sorted(second) == sorted(first) and len(equal) == len(first),
          'second-process answers differ: %s' % sorted(set(first) -
                                                       set(equal)))
    return launches


def _train_feed(bs, seed, seq=FLAGSHIP['seq']):
    """One fixed batch of tokens, labels and positions, on the card."""
    import torch
    rng = np.random.RandomState(seed)
    V, S = FLAGSHIP['vocab'], seq
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
    from paddle_tpu_torch.compiler import tuning
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
    expect = dict.fromkeys(launches, 0)
    expect.update(flash_attn_fwd=n_layers * TRAIN_STEPS,
                  flash_attn_bwd_dkvdq=n_layers * TRAIN_STEPS)
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
    expect = dict.fromkeys(route_launches, 0)
    expect.update(flash_attn_fwd=n_layers, flash_attn_bwd_dq=n_layers,
                  flash_attn_bwd_dkv=n_layers)
    check(route_launches == expect, 'two-pass step launches %s, expected '
          '%s' % (route_launches, expect))
    check(errs[worst] <= ROUTE_GRAD_TOL, 'two-pass gradients differ from '
          'the merged route by %g (%s)' % (errs[worst], worst))

    # the tuner over flash_bwd_route at this shape (a cache of its own),
    # then one step under the winner's route: no winner is asserted, the
    # two routes differ by less than a step's spread
    _restore(scope, snap)
    tuner = tuning.Autotuner(pt.CUDAPlace(0), cache=tuning.TuningCache(
        os.path.join(ROOT, 'build', 'phase7-tuning.json')), warmup=1,
        steps=TUNE_STEPS)
    t1 = time.perf_counter()
    best, report = tuner.tune(main, feed, [loss], scope=scope,
                              persist=False, name='flagship-train')
    route = best.get('flash_bwd_route', tuning.KNOB_DEFAULTS[
        'flash_bwd_route'])
    other = 'two_pass' if route == 'merged' else 'merged'
    print('training: tuned over flash_bwd_route at batch %d in %.1f s: '
          'candidates (ms a step, %d steps each) %s; winner %s (route %s); '
          '%s' % (TRAIN_BATCH, time.perf_counter() - t1, TUNE_STEPS,
                  _named_report(report, tuner.candidates(main, feed)),
                  best or 'baseline {}', route, card), flush=True)
    check(all(isinstance(v, float) for v in report.values()),
          'a route candidate failed: %s' % report)
    with tuning.apply_entry({'flash_bwd_route': route}):
        won, won_launches = step_grads()
    with tuning.apply_entry({'flash_bwd_route': other}):
        lost, _ = step_grads()
    errs = _rel_l2(won, lost)
    worst = max(errs, key=errs.get)
    expect = dict.fromkeys(won_launches, 0)
    if route == 'merged':
        expect.update(flash_attn_fwd=n_layers, flash_attn_bwd_dkvdq=n_layers)
    else:
        expect.update(flash_attn_fwd=n_layers, flash_attn_bwd_dq=n_layers,
                      flash_attn_bwd_dkv=n_layers)
    print('training: one step under the winner\'s route (%s): launches %s; '
          'gradients vs the %s route, max relative L2 %.3g (%s) (tol %g)'
          % (route, won_launches, other, errs[worst], worst,
             ROUTE_GRAD_TOL), flush=True)
    check(won_launches == expect, 'tuned step launches %s, expected %s'
          % (won_launches, expect))
    check(errs[worst] <= ROUTE_GRAD_TOL, 'the %s route\'s gradients differ '
          'from the %s route\'s by %g (%s)' % (route, other, errs[worst],
                                               worst))
    _restore(scope, snap)
    del snap, merged, two_pass, won, lost
    return dict(exe=exe, main=main, loss=loss, scope=scope,
                grad_names=grad_names, launches=launches,
                route_launches=route_launches)


def phase_long_training(seed, card):
    """7b. Train the flagship at full width at seq 32768 and batch 5
    through Adam.minimize and Executor.run on one fixed batch: the port
    takes the two-pass backward by its own rule."""
    import torch
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.models.fluid_transformer import transformer
    from paddle_tpu_torch.ops import cuda_kernels as ck

    cfg = dict(FLAGSHIP, seq=LONG_SEQ, n_layers=LONG_LAYERS)
    H, D = cfg['n_heads'], cfg['d_model'] // cfg['n_heads']
    slab = ck.merged_bwd_bytes(torch.empty(
        LONG_BATCH, LONG_SEQ, H, D, dtype=torch.bfloat16, device='meta'))
    check(ck._MERGED_BWD[0] and slab > ck._MERGED_BWD_MAX_SLAB_BYTES,
          'long context: the merged route would be taken (%d B of dq, cap '
          '%d B)' % (slab, ck._MERGED_BWD_MAX_SLAB_BYTES))
    t0 = time.perf_counter()
    main, startup = pt.Program(), pt.Program()
    startup.random_seed = seed + 3
    with pt.unique_name.guard(), pt.program_guard(main, startup):
        loss = transformer(None, **cfg)[0]
        pt.optimizer.Adam(learning_rate=1e-4).minimize(loss)
    exe = pt.Executor()                       # CUDAPlace(0)
    scope = pt.Scope()
    exe.run(startup, scope=scope)
    grad_names = sorted(v.name for v in main.list_vars()
                        if v.name.endswith('@GRAD'))
    feed = _train_feed(LONG_BATCH, seed + 11, LONG_SEQ)
    torch.cuda.synchronize()
    print('long context: flagship %s, batch %d (%d tokens a step), '
          'Adam(1e-4), AMP; the merged backward would take %d MiB of dq '
          '(cap %d MiB): the two-pass route; built in %.1f s' % (
              cfg, LONG_BATCH, LONG_BATCH * LONG_SEQ, slab >> 20,
              ck._MERGED_BWD_MAX_SLAB_BYTES >> 20,
              time.perf_counter() - t0), flush=True)

    losses = []
    torch.cuda.reset_peak_memory_stats()
    for _ in range(LONG_WARMUP):
        losses.append(float(exe.run(main, feed=feed, fetch_list=[loss],
                                    scope=scope)[0][0]))
    torch.cuda.synchronize()
    ck.reset_launch_counts()
    outs = []
    t0 = time.perf_counter()
    for _ in range(LONG_STEPS):
        out, = exe.run(main, feed=feed, fetch_list=[loss], scope=scope,
                       return_numpy=False)
        outs.append(out)
    torch.cuda.synchronize()
    outs[-1] = outs[-1].item()                # the last loss to the host
    dt = time.perf_counter() - t0
    launches = dict(ck.LAUNCHES)
    losses += [float(o) for o in outs]
    tokens = LONG_STEPS * LONG_BATCH * LONG_SEQ
    print('long context: %d steps, %.2f ms per step, %.1f tokens/s (host '
          'clock, loss kept on the card, last loss copied to the host), '
          'peak memory %.2f GiB; %s' % (
              LONG_STEPS, 1e3 * dt / LONG_STEPS, tokens / dt,
              torch.cuda.max_memory_allocated() / 2 ** 30, card),
          flush=True)
    print('long context: losses %s' % ', '.join('%.4f' % l for l in losses),
          flush=True)
    # the peak under the default passes (buffer_reuse releases each
    # value after its last reader) against one step under
    # conv_epilogue_fuse alone (the pipeline before the other passes
    # were ported) and one under the default passes less buffer_reuse
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    peaks = {pt.compiler.pipeline_signature(): peak}
    for passes in (['conv_epilogue_fuse'],
                   [p for p in pt.compiler.DEFAULT_PASSES
                    if p != 'buffer_reuse']):
        pt.compiler.set_default_passes(passes)
        try:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            exe.run(main, feed=feed, fetch_list=[loss], scope=scope,
                    return_numpy=False)
            torch.cuda.synchronize()
            peaks[pt.compiler.pipeline_signature()] = \
                torch.cuda.max_memory_allocated() / 2 ** 30
        finally:
            pt.compiler.set_default_passes(None)
    print('long context: peak memory by pipeline: %s; %s' % (
        ', '.join('%s %.2f GiB' % ('+'.join(k), v)
                  for k, v in peaks.items()), card), flush=True)
    print('long context: launches over the timed steps %s' % launches,
          flush=True)
    check(all(np.isfinite(losses)), 'non-finite long-context loss')
    check(losses[-1] < losses[0], 'the long-context loss did not fall: %g '
          '-> %g' % (losses[0], losses[-1]))
    n = cfg['n_layers'] * LONG_STEPS
    expect = dict.fromkeys(launches, 0)
    expect.update(flash_attn_fwd=n, flash_attn_bwd_dq=n,
                  flash_attn_bwd_dkv=n)
    check(launches == expect, 'long-context launches %s, expected %s'
          % (launches, expect))
    by_kind, busy_us = profile_run(
        lambda: exe.run(main, feed=feed, fetch_list=[loss], scope=scope,
                        return_numpy=False), 'long-context step')
    shares = {k: by_kind.get(k, 0.0) for k in (
        'flash_bwd_dq_wgmma_kernel', 'flash_bwd_wgmma_kernel (dk/dv pass)')}
    print('long context: the two passes\' share of the device time: dq '
          '%.3f ms (%.1f%%), dk/dv %.3f ms (%.1f%%), together %.1f%%' % (
              shares['flash_bwd_dq_wgmma_kernel'] / 1e3,
              100 * shares['flash_bwd_dq_wgmma_kernel'] / busy_us,
              shares['flash_bwd_wgmma_kernel (dk/dv pass)'] / 1e3,
              100 * shares['flash_bwd_wgmma_kernel (dk/dv pass)'] / busy_us,
              100 * sum(shares.values()) / busy_us), flush=True)
    check(min(shares.values()) > 0, 'the profile shows no two-pass kernel: '
          '%s' % sorted(by_kind))

    # one step's gradients on each route from the same state: the merged
    # route with its cap raised for that step (its dq buffer fits)
    snap = _snapshot(scope)

    def step_grads():
        _restore(scope, snap)
        ck.reset_launch_counts()
        vals = exe.run(main, feed=feed, fetch_list=grad_names, scope=scope,
                       return_numpy=False)
        torch.cuda.synchronize()
        return dict(zip(grad_names, vals)), dict(ck.LAUNCHES)

    two_pass, _ = step_grads()
    cap = ck._MERGED_BWD_MAX_SLAB_BYTES
    ck._MERGED_BWD_MAX_SLAB_BYTES = slab
    try:
        merged, route_launches = step_grads()
    finally:
        ck._MERGED_BWD_MAX_SLAB_BYTES = cap
    errs = _rel_l2(two_pass, merged)
    worst = max(errs, key=errs.get)
    print('long context: one step, two-pass vs the merged route (cap '
          'raised for the step, launches %s): max relative L2 %.3g (%s), '
          'median %.3g (tol %g)' % (
              route_launches, errs[worst], worst,
              float(np.median(list(errs.values()))), ROUTE_GRAD_TOL),
          flush=True)
    expect = dict.fromkeys(route_launches, 0)
    expect.update(flash_attn_fwd=cfg['n_layers'],
                  flash_attn_bwd_dkvdq=cfg['n_layers'])
    check(route_launches == expect, 'merged-route step launches %s, '
          'expected %s' % (route_launches, expect))
    check(errs[worst] <= ROUTE_GRAD_TOL, 'long-context two-pass gradients '
          'differ from the merged route by %g (%s)' % (errs[worst], worst))
    return dict(launches=launches)


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


# ---- training ResNet-50 through the fused conv's stats form ----------------------
def _train_program(seed, model='resnet_imagenet'):
    """The benchmark's training program at full width
    (benchmark/fluid/models.py:50-67: the model at 3 x 224 x 224 and 1000
    classes, cross_entropy, mean; Momentum(0.01, 0.9) as bench.py:74),
    built with the port's layers: (main, startup, loss)."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.models import resnet
    main, startup = pt.Program(), pt.Program()
    startup.random_seed = seed
    with pt.unique_name.guard(), pt.program_guard(main, startup):
        img = pt.layers.data(name='data', shape=[3, 224, 224],
                             dtype='float32')
        label = pt.layers.data(name='label', shape=[1], dtype='int64')
        predict = getattr(resnet, model)(img, class_dim=1000, depth=50)
        loss = pt.layers.mean(pt.layers.cross_entropy(input=predict,
                                                      label=label))
        pt.optimizer.Momentum(learning_rate=0.01, momentum=0.9).minimize(
            loss)
    return main, startup, loss


def train_regions(main, loss):
    """The fused_conv regions of a training program after
    conv_epilogue_fuse, as ({(H, W, Cin, Cout, K, stride, pad,
    depthwise): count} of those that take the stats form, the number of
    grouped-conv regions, which replay)."""
    import paddle_tpu_torch as pt
    opt, _ = pt.compiler.optimize(main, fetch_names=[loss.name])
    block = opt.global_block()
    regions, grouped = {}, 0
    for op in block.ops:
        if op.type != 'fused_conv':
            continue
        _, ins, _, attrs = op.attrs['sub_ops'][0]
        _, cin, h, w = block.var(ins['Input'][0]).shape
        cout, w_cin, k, _ = block.var(ins['Filter'][0]).shape
        groups = attrs.get('groups', 1) or 1
        dw = groups == cin and w_cin == 1
        if groups > 1 and not dw:
            grouped += 1
            continue
        key = (h, w, cin, cout, k, attrs['strides'][0], attrs['paddings'][0],
               dw)
        regions[key] = regions.get(key, 0) + 1
    return regions, grouped


def _stats_ratios(x, w, s, p, dw, y, ssum, ssq, dtype):
    """(y: max err / CONV_TOL's limit per element; sum, sumsq: max err /
    STATS_REL's limit per channel) against the plain version."""
    from paddle_tpu_torch.ops import cuda_kernels as ck
    conv, rs, rss = ck.fused_conv_reference(
        x.float(), w.float(), (), (), (), (s, s), (p, p), dw,
        emit_stats=True)
    rel = STATS_REL[dtype]
    abs_sum = conv.abs().sum((0, 1, 2))
    return (conv_err_ratio(y, conv.to(x.dtype), dtype),
            ((ssum - rs).abs() / (rel * abs_sum)).max().item(),
            ((ssq - rss).abs() / (rel * rss)).max().item(),
            (y.float() - conv.to(x.dtype).float()).abs().max().item())


def _check_stats_case(x, w, s, p, dw, dtype):
    """Hold the stats form at one shape against its plain version: y per
    element, the moments per channel; and the slab without its last slot
    (a kernel that drops the last row tile's partial), which must fail
    where M is not a multiple of the slot. Returns max |y err|."""
    import torch
    from paddle_tpu_torch.ops import cuda_kernels as ck
    rows = ck.FUSED_CONV_STAT_ROWS
    N, H, W, cin = x.shape
    y, slab = ck._fused_conv_launch(x, w, (), (), (), (s, s), (p, p), dw,
                                    emit_stats=True)
    y2, slab2 = ck._fused_conv_launch(x, w, (), (), (), (s, s), (p, p), dw,
                                      emit_stats=True)
    got = ck.fused_conv(x, w, (), (), (), (s, s), (p, p), dw,
                        emit_stats=True)
    torch.cuda.synchronize()
    same = torch.equal(y, y2) and torch.equal(slab, slab2)
    ratios = _stats_ratios(x, w, s, p, dw, *got, dtype)
    cout, M = y.shape[3], y.shape[0] * y.shape[1] * y.shape[2]
    control = None
    if M % rows:
        control = max(_stats_ratios(x, w, s, p, dw, y, slab[0, :-1].sum(0),
                                    slab[1, :-1].sum(0), dtype)[1:3])
    print('kernel fused_conv_stats N=%d %dx%d Cin=%d Cout=%d K=%d s=%d p=%d%s '
          '%s M=%d: y err/limit %.3g (max|err| %.3g), sum err/limit %.3g, '
          'sumsq err/limit %.3g (rel %g); last slot dropped: %s; two calls '
          'bit-identical: %s' % (
              N, H, W, cin, cout, w.shape[-2], s, p,
              ' depthwise' if dw else '', dtype, M, ratios[0], ratios[3],
              ratios[1], ratios[2], STATS_REL[dtype],
              'n/a (M %% %d == 0)' % rows if control is None
              else '%.3g' % control, same), flush=True)
    what = 'N=%d %dx%d Cin=%d Cout=%d s=%d %s' % (N, H, W, cin, cout, s,
                                                  dtype)
    check(same, 'fused_conv_stats gave other bits on a second call at '
          + what)
    check(max(ratios[:3]) <= 1, 'fused_conv_stats disagrees with its plain '
          'version at ' + what)
    check(control is None or control > 1, 'the moments\' limit does not '
          'catch a dropped last slot at ' + what)
    return ratios[3]


def phase_stats_kernels(seed, main, loss):
    """The stats form vs its plain version at every distinct region shape
    of the ResNet-50 training program (batch 32, bf16 and f32, and one
    depthwise shape), then at the training batch of 128 in bf16, checked
    again and timed per shape. Returns the numbers summed over one
    batch-128 step's regions."""
    import torch
    import torch.nn.functional as F
    from paddle_tpu_torch.ops import cuda_kernels as ck
    regions, grouped = train_regions(main, loss)
    check(sum(regions.values()) == RESNET_REGIONS and not grouped,
          'the ResNet-50 training program has %d stats-form regions and %d '
          'grouped ones, expected %d and 0' % (sum(regions.values()),
                                              grouped, RESNET_REGIONS))
    print('stats kernels: %d distinct region shapes over %d regions of the '
          'training program' % (len(regions), RESNET_REGIONS), flush=True)
    gen = torch.Generator(device='cuda')
    gen.manual_seed(seed + 4)
    N = STATS_CHECK_BATCH
    max_err = 0.0
    # off ResNet-50: a depthwise 3x3 stride 2 with a partial last slot
    cases = sorted(regions) + [(14, 14, 256, 256, 3, 2, 1, True)]
    for (H, W, cin, cout, k, s, p, dw) in cases:
        for dtype in ('bfloat16', 'float32'):
            x, w, _ = _conv_inputs(gen, dtype, N, H, W, cin, cout, k, s, p,
                                   dw, ('c', 'c'))
            err = _check_stats_case(x, w, s, p, dw, dtype)
            if dtype == 'bfloat16':
                max_err = max(max_err, err)
            del x, w
    # the small batches, where the wgmma kernel splits K (bf16)
    for n in STATS_SMALL_BATCHES:
        for (H, W, cin, cout, k, s, p, dw) in sorted(regions):
            x, w, _ = _conv_inputs(gen, 'bfloat16', n, H, W, cin, cout, k, s,
                                   p, dw, ('c', 'c'))
            max_err = max(max_err, _check_stats_case(x, w, s, p, dw,
                                                     'bfloat16'))
            del x, w
    torch.cuda.empty_cache()

    # checked and timed at the training batch, bf16 as AMP runs them
    N = RESNET_TRAIN_BATCH
    totals = dict(ms=0.0, plain_ms=0.0, library_ms=0.0, bound_ms=0.0,
                  max_abs_err=max_err)
    bound_by, classes = {}, {}
    for (H, W, cin, cout, k, s, p, dw), count in sorted(regions.items()):
        x, w, _ = _conv_inputs(gen, 'bfloat16', N, H, W, cin, cout, k, s, p,
                               dw, ('c', 'c'))
        max_err = max(max_err, _check_stats_case(x, w, s, p, dw,
                                                 'bfloat16'))
        args = (x, w, (), (), (), (s, s), (p, p), dw)
        y = ck.fused_conv(*args, emit_stats=True)[0]
        # the function's outputs: y and the two f32 moments [Cout]
        bound_ms, by = conv_bound(x, w, [], y, k, s, p, dw, 2 * 4 * cout)
        kernel_ms = graph_ms(lambda: ck.fused_conv(*args, emit_stats=True))
        plain_ms = graph_ms(lambda: ck.fused_conv_reference(
            *args, emit_stats=True), iters=3, reps=3)
        xc = x.permute(0, 3, 1, 2)
        wc = w.permute(0, 3, 1, 2)

        def library():
            c = F.conv2d(xc, wc, stride=s, padding=p).float()
            return c.sum((0, 2, 3)), (c * c).sum((0, 2, 3))
        library_ms = graph_ms(library)
        print('kernel fused_conv_stats N=%d %dx%d Cin=%d Cout=%d K=%d s=%d '
              'p=%d bf16 x%d: kernel_ms %.4f plain_ms %.4f cudnn+sums_ms '
              '%.4f bound_ms %.4f (%s)' % (N, H, W, cin, cout, k, s, p, count,
                                           kernel_ms, plain_ms, library_ms,
                                           bound_ms, by), flush=True)
        totals['ms'] += count * kernel_ms
        totals['plain_ms'] += count * plain_ms
        totals['library_ms'] += count * library_ms
        totals['bound_ms'] += count * bound_ms
        bound_by[by] = bound_by.get(by, 0.0) + count * bound_ms
        _add_class(classes, conv_class(k, s, cin), count, kernel=kernel_ms,
                   cudnn_and_sums=library_ms, bound=bound_ms)
        del x, w, y, args, xc, wc
    totals['bound_by'] = max(bound_by, key=bound_by.get)
    print('stats kernels: one batch-%d training step, bf16, summed over its '
          '%d regions: kernel %.4f ms, plain %.4f ms, cuDNN conv and two '
          'channel sums %.4f ms, bound %.4f ms (%s-bound regions hold %.1f%% '
          'of it)' % (N, RESNET_REGIONS, totals['ms'], totals['plain_ms'],
                      totals['library_ms'], totals['bound_ms'],
                      totals['bound_by'],
                      100 * bound_by[totals['bound_by']] / totals['bound_ms']),
          flush=True)
    print_classes('batch-%d training step, stats form' % N, classes)
    torch.cuda.empty_cache()
    return totals


def _image_train_feed(bs, seed):
    """One fixed batch of images and labels, made on the card."""
    import torch
    gen = torch.Generator(device='cuda')
    gen.manual_seed(seed)
    return {'data': torch.randn(bs, 3, 224, 224, device='cuda',
                                generator=gen),
            'label': torch.randint(0, 1000, (bs, 1), device='cuda',
                                   generator=gen)}


def phase_resnet_training(seed, card, main, startup, loss):
    """Train ResNet-50 at full width through Momentum.minimize and
    Executor.run on one fixed batch of 128."""
    import torch
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.compiler import passes
    from paddle_tpu_torch.ops import cuda_kernels as ck
    t0 = time.perf_counter()
    exe = pt.Executor()                       # CUDAPlace(0)
    scope = pt.Scope()
    exe.run(startup, scope=scope)
    feed = _image_train_feed(RESNET_TRAIN_BATCH, seed + 11)
    torch.cuda.synchronize()
    print('resnet training: ResNet-50 (3x224x224, 1000 classes), batch %d, '
          'Momentum(0.01, 0.9), AMP, %d ops, initialised in %.1f s'
          % (RESNET_TRAIN_BATCH, len(main.global_block().ops),
             time.perf_counter() - t0), flush=True)
    losses = []
    torch.cuda.reset_peak_memory_stats()
    for _ in range(RESNET_TRAIN_WARMUP):
        losses.append(float(exe.run(main, feed=feed, fetch_list=[loss],
                                    scope=scope)[0][0]))
    torch.cuda.synchronize()
    ck.reset_launch_counts()
    passes.reset_fallback_counts()
    outs = []
    t0 = time.perf_counter()
    for _ in range(RESNET_TRAIN_STEPS):
        out, = exe.run(main, feed=feed, fetch_list=[loss], scope=scope,
                       return_numpy=False)
        outs.append(out)
    torch.cuda.synchronize()
    outs[-1] = outs[-1].item()                # the last loss to the host
    dt = time.perf_counter() - t0
    launches = dict(ck.LAUNCHES)
    variants = dict(ck.FUSED_CONV_VARIANT_LAUNCHES)
    fallbacks = dict(passes.FALLBACKS)
    losses += [float(o) for o in outs]
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    print('resnet training: %d steps, %.2f ms per step, %.1f images/s (host '
          'clock, loss kept on the card, last loss copied to the host), peak '
          'memory %.2f GiB; %s' % (
              RESNET_TRAIN_STEPS, 1e3 * dt / RESNET_TRAIN_STEPS,
              RESNET_TRAIN_STEPS * RESNET_TRAIN_BATCH / dt, peak, card),
          flush=True)
    print('resnet training: losses %s' % ', '.join('%.4f' % l
                                                   for l in losses),
          flush=True)
    print('resnet training: launches over the timed steps %s (the stats '
          'form by variant %s), fallbacks %s' % (launches, variants,
                                                 fallbacks), flush=True)
    check(variants == {v: c * RESNET_TRAIN_STEPS
                       for v, c in RESNET_VARIANTS.items()},
          'ResNet-50 training took the fused conv variants %s' % variants)
    check(all(np.isfinite(losses)), 'non-finite ResNet-50 training loss')
    check(losses[-1] < losses[0], 'the ResNet-50 loss did not fall: %g -> %g'
          % (losses[0], losses[-1]))
    expect = {name: 0 for name in launches}
    expect['fused_conv_stats'] = RESNET_REGIONS * RESNET_TRAIN_STEPS
    check(launches == expect, 'ResNet-50 training launches %s, expected %s'
          % (launches, expect))
    check(not fallbacks, 'ResNet-50 training fell back: %s' % fallbacks)
    profile_run(lambda: exe.run(main, feed=feed, fetch_list=[loss],
                                scope=scope, return_numpy=False),
                'resnet training step')
    result = dict(launches=launches, ms=1e3 * dt / RESNET_TRAIN_STEPS,
                  peak_gib=peak)
    del scope, exe, feed, outs
    torch.cuda.empty_cache()
    return result


def _small_residual_gammas(main, scope):
    """Scale each residual branch's last batch-norm Scale (behind the Y
    operand of a block's elementwise_add, through an SE product) by
    RESIDUAL_GAMMA in ``scope``."""
    ops = main.global_block().ops
    producer = {n: op for op in ops for n in op.output_arg_names}
    for op in ops:
        bn = producer.get(op.input('Y')[0]) if op.type == 'elementwise_add' \
            else None
        if bn is not None and bn.type == 'elementwise_mul':
            bn = producer.get(bn.input('X')[0])
        if bn is not None and bn.type == 'batch_norm':
            name = bn.input('Scale')[0]
            scope.set_var(name, scope.raw(name) * RESIDUAL_GAMMA)


def _dropped_last_slot(x, w, strides, pads, depthwise):
    """The stats form's kernel with its last slot of moment partials
    dropped (a control)."""
    from paddle_tpu_torch.ops import cuda_kernels as ck
    y, slab = ck._fused_conv_launch(x, w, (), (), (), strides, pads,
                                    depthwise, emit_stats=True)
    return y, slab[0, :-1].sum(0), slab[1, :-1].sum(0)


def _moments_dropped():
    """The stats form's autograd Function with a backward that ignores
    the moments' cotangents (a control)."""
    from paddle_tpu_torch.ops import cuda_kernels as ck

    class MomentsDropped(ck._FusedConvStats):
        @staticmethod
        def backward(ctx, g_y, g_sum, g_sumsq):
            return ck._FusedConvStats.backward(ctx, g_y, None, None)
    return MomentsDropped


def _f64_witness(x, w, strides, pads, depthwise):
    """A stats-form forward that shows what rounding alone does: the conv
    and its moments in f64, then y rounded to x's dtype and the moments to
    f32. Like the kernel, it differs from the plain version (cuDNN's f32
    conv, f32 sums) only in how its sums round."""
    import torch.nn.functional as F
    xc = x.double().permute(0, 3, 1, 2)
    wc = w.double().permute(2, 0, 1).unsqueeze(1) if depthwise else \
        w.double().permute(0, 3, 1, 2)
    conv = F.conv2d(xc, wc, stride=tuple(strides), padding=tuple(pads),
                    groups=x.shape[3] if depthwise else 1).permute(0, 2, 3, 1)
    return (conv.to(x.dtype), conv.sum((0, 1, 2)).float(),
            (conv * conv).sum((0, 1, 2)).float())


def _stats_function(forward=None, function=None):
    """A fused conv for ``passes.conv_for_testing``: the stats form
    through ``function`` (the kernel's autograd Function by default, so
    with the kernel's backward) on ``forward`` (the plain version by
    default); against the kernel, only what is swapped differs."""
    from paddle_tpu_torch.ops import cuda_kernels as ck
    forward = forward or ck._stats_reference
    function = function or ck._FusedConvStats

    def conv(x, w, aux, kinds, stages, strides, pads, depthwise,
             emit_stats=False):
        if not emit_stats:
            return ck.fused_conv_reference(x, w, aux, kinds, stages, strides,
                                           pads, depthwise)
        return function.apply((tuple(strides), tuple(pads), bool(depthwise)),
                              forward, x, w)
    return conv


def _hold_gradients(label, main, scope, feed, regions, f32_limits,
                    witness_factor, reseed=None, fetch=(), pinned=None):
    """Every parameter gradient and moving statistic of one training step
    on the stats-form kernel against the same step on its plain forward
    (the same backward), relative L2 per tensor, in f32 and under AMP.
    With AMP off the two forwards differ only in the order of their f32
    sums: ``f32_limits`` (max and median gradient error, largest moving
    statistic's), or with None ``witness_factor`` times a witness of
    what rounding alone does (the plain forward in f64, rounded). Under
    AMP, bf16 rounding between the train-mode batch norms moves the
    gradients: the kernel is held to ``witness_factor`` times the
    witness. Two wrong stats forms must fail both. A gradient of zero but
    for rounding (a bias between a layer and its train-mode batch norm)
    is left out. With ``reseed`` the scope's generator is seeded alike
    before each step (the same dropout masks). With ``pinned`` =
    (program, pins), ``main``'s twin whose ReLUs and max pools take fed
    decisions (``_pin_switches``), every step but the kernel's runs the
    twin, fed the kernel step's own decisions: a value that rounding puts
    on the other side of a switch then moves no gradient. The unpinned
    plain step is printed beside it, with the decisions that differ.
    Returns the kernel step's values of ``fetch`` under AMP."""
    import torch
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.compiler import passes
    from paddle_tpu_torch.core import amp
    from paddle_tpu_torch.core.lowering import RNG_KEY
    from paddle_tpu_torch.ops import cuda_kernels as ck
    exe = pt.Executor()
    block = main.global_block()
    grad_names = sorted(v.name for v in main.list_vars()
                        if v.name.endswith('@GRAD'))
    stat_names = [op.output(s)[0] for op in block.ops
                  if op.type == 'batch_norm'
                  for s in ('MeanOut', 'VarianceOut')]
    fetch = list(fetch)
    pins = pinned[1] if pinned else []
    sources = sorted({x for _, x, _ in pins})
    # a bias added right before a train-mode batch norm: the batch mean
    # takes it back out, so its gradient is zero but for rounding
    bn_inputs = {op.input('X')[0] for op in block.ops
                 if op.type == 'batch_norm' and not op.attrs.get('is_test')}
    live = [n for n in grad_names if n not in {
        op.input('Y')[0] + '@GRAD' for op in block.ops
        if op.type == 'elementwise_add' and op.output('Out')[0] in bn_inputs}]
    snap = _snapshot(scope)

    def step(conv=None, decisions=None):
        """One step of ``main`` fetching the decisions' sources, or with
        ``decisions`` one step of the pinned twin fed them."""
        _restore(scope, snap)
        if reseed is not None:
            gen = torch.Generator(device='cuda')
            gen.manual_seed(reseed)
            scope.set_var(RNG_KEY, gen)
        program, names = main, grad_names + fetch + sources
        if decisions is not None:
            program, names = pinned[0], grad_names + fetch
        with passes.conv_for_testing(conv) if conv else \
                contextlib.nullcontext():
            vals = exe.run(program, feed=dict(feed, **(decisions or {})),
                           fetch_list=names, scope=scope, return_numpy=False)
        torch.cuda.synchronize()
        got = dict(zip(names, vals))
        got.update((n, scope.raw(n).clone()) for n in stat_names)
        return got

    def errors(got, ref):
        """(largest gradient error, its name, median gradient error,
        largest moving-statistic error)."""
        errs = _rel_l2({n: got[n] for n in live + stat_names},
                       {n: ref[n] for n in live + stat_names})
        worst = max(live, key=errs.get)
        return (errs[worst], worst,
                float(np.median([errs[n] for n in live])),
                max(errs[n] for n in stat_names))

    def differing(a, b):
        """The ReLU and the max-pool decisions of two unpinned steps that
        differ: ((relu, of), (pool, of))."""
        out = {}
        for kind, x, _ in pins:
            diff = (_decision(kind, a[x]) != _decision(kind, b[x])).float()
            if kind == 'pool':             # a window differs anywhere
                N, C, H, W = diff.shape
                diff = diff.reshape(N, C, H // 2, 2, W // 2, 2).amax((3, 5))
            n, total = int(diff.sum().item()), diff.numel()
            d, t = out.get(kind, (0, 0))
            out[kind] = (d + n, t + total)
        return out.get('relu', (0, 0)), out.get('pool', (0, 0))

    controls = (('backward without the moments\' cotangents',
                 _stats_function(ck._stats_kernel, _moments_dropped())),
                ('last row tile\'s partials dropped',
                 _stats_function(_dropped_last_slot)))
    for precision in ('f32', 'bf16'):
        amp.set_amp(precision == 'bf16')
        try:
            ck.reset_launch_counts()
            kernel = step()
            check(ck.LAUNCHES['fused_conv_stats'] == regions,
                  '%s gradient step launches %s' % (label, ck.LAUNCHES))
            decisions = {fed: _decision(kind, kernel[x])
                         for kind, x, fed in pins} if pinned else None
            plain = step(_stats_function(), decisions)
            same = all(torch.equal(kernel[n], plain[n]) for n in fetch)
            found = {'kernel': errors(kernel, plain),
                     'witness': errors(step(_stats_function(_f64_witness),
                                            decisions), plain)}
            for name, conv in controls:
                found[name] = errors(step(conv, decisions), plain)
            if pinned:
                free = step(_stats_function())
                unpinned = errors(kernel, free) + differing(kernel, free)
                del free
        finally:
            amp.set_amp(None)
        w = found['witness']
        if precision == 'f32' and f32_limits is not None:
            limits = f32_limits
            what = 'limits max %g, median %g, statistics %g' % limits
        else:
            limits = tuple(witness_factor * e for e in (w[0], w[2], w[3]))
            what = ('limits %gx the witness\'s: max %.3g, median %.3g, '
                    'statistics %.3g' % ((witness_factor,) + limits))
        for name in ['kernel', 'witness'] + [c for c, _ in controls]:
            print('%s gradients: %s (AMP %s), batch %d, %s vs plain fused '
                  'conv (same backward%s), relative L2 per tensor: %d '
                  'gradients (%d of zero but for rounding left out) max '
                  '%.3g (%s), median %.3g; moving statistics max %.3g (%s)'
                  % ((label, precision, 'on' if precision == 'bf16'
                      else 'off', feed['data'].shape[0], name,
                      ', the ReLUs and max pools pinned to the kernel '
                      'step\'s decisions' if pinned else '', len(live),
                      len(grad_names) - len(live)) + found[name] + (what,)),
                  flush=True)
        if pinned:
            print('%s gradients: %s, kernel vs plain fused conv, neither '
                  'pinned: max %.3g (%s), median %.3g, moving statistics '
                  'max %.3g; decisions that differ between the two steps: '
                  'ReLU %d of %d, max pool %d of %d (not checked)'
                  % ((label, precision) + unpinned[:4] + unpinned[4] +
                     unpinned[5]), flush=True)

        def within(e):
            return e[0] <= limits[0] and e[2] <= limits[1] and \
                e[3] <= limits[2]
        check(same, '%s: the fetched %s differ between the kernel and the '
              'plain step' % (label, fetch))
        check(within(found['kernel']), '%s gradients or moving statistics '
              '(%s) differ from the plain fused conv\'s' % (label, precision))
        for name, _ in controls:
            check(not within(found[name]), 'the %s %s gradient limits do '
                  'not catch a control: %s' % (label, precision, name))
    vals = {n: kernel[n] for n in fetch}
    del snap, kernel, plain
    torch.cuda.empty_cache()
    return vals


def phase_resnet_gradients(seed, main, startup, loss):
    """Every parameter gradient and moving statistic of one batch-8
    ResNet-50 step on the kernel vs the same step on the plain fused
    conv's forward (``_hold_gradients``: f32 limits RESNET_GRAD_F32,
    under AMP RESNET_GRAD_WITNESS times the f64 witness), its residual
    gammas small."""
    import paddle_tpu_torch as pt
    scope = pt.Scope()
    pt.Executor().run(startup, scope=scope)
    _small_residual_gammas(main, scope)
    _hold_gradients('resnet', main, scope,
                    _image_train_feed(RESNET_GRAD_BATCH, seed + 13),
                    RESNET_REGIONS, RESNET_GRAD_F32, RESNET_GRAD_WITNESS)


def phase_se_resnext_training(seed, card):
    """Train SE-ResNeXt-50 at full width, batch 32: its grouped 3x3 convs
    replay ('groups'), every other region takes the stats form."""
    import torch
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.compiler import passes
    from paddle_tpu_torch.ops import cuda_kernels as ck
    main, startup, loss = _train_program(seed, 'se_resnext')
    regions, grouped = train_regions(main, loss)
    n_stats = sum(regions.values())
    exe = pt.Executor()
    scope = pt.Scope()
    exe.run(startup, scope=scope)
    feed = _image_train_feed(SE_BATCH, seed + 17)
    losses = [float(exe.run(main, feed=feed, fetch_list=[loss],
                            scope=scope)[0][0]) for _ in range(SE_WARMUP)]
    torch.cuda.synchronize()
    ck.reset_launch_counts()
    passes.reset_fallback_counts()
    t0 = time.perf_counter()
    outs = [exe.run(main, feed=feed, fetch_list=[loss], scope=scope,
                    return_numpy=False)[0] for _ in range(SE_STEPS)]
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    losses += [float(o) for o in outs]
    launches, fallbacks = dict(ck.LAUNCHES), dict(passes.FALLBACKS)
    print('se_resnext training: SE-ResNeXt-50 (3x224x224, 1000 classes), '
          'batch %d, %d stats-form regions and %d grouped (replayed) a step; '
          '%d steps, %.2f ms per step, %.1f images/s (host clock); '
          'launches %s, fallbacks %s; losses %s; %s' % (
              SE_BATCH, n_stats, grouped, SE_STEPS, 1e3 * dt / SE_STEPS,
              SE_STEPS * SE_BATCH / dt, launches, fallbacks,
              ', '.join('%.4f' % l for l in losses), card), flush=True)
    check(all(np.isfinite(losses)), 'non-finite SE-ResNeXt-50 loss')
    expect = {name: 0 for name in launches}
    expect['fused_conv_stats'] = n_stats * SE_STEPS
    check(launches == expect, 'SE-ResNeXt-50 launches %s, expected %s'
          % (launches, expect))
    check(grouped == 16 and fallbacks == {'groups': grouped * SE_STEPS},
          'SE-ResNeXt-50 fallbacks %s, expected %d grouped replays a step'
          % (fallbacks, grouped))
    del scope, exe, feed, outs
    torch.cuda.empty_cache()
    return dict(launches=launches, ms=1e3 * dt / SE_STEPS)


# ---- 12b. the static analysis; 12c, 12d. mnist and VGG-16 ----------------
# benchmark/fluid/fluid_benchmark.py's default batch; the training steps
# a precision (warm-up, then timed); the served requests' rows (buckets
# 1 to BENCH_SERVE_MAX)
BENCH_BATCH = 32
BENCH_WARMUP, BENCH_STEPS = 2, 5
# fitting one batch with dropout off: the steps, and the mean of the last
# few losses against the first (the timed steps above keep the harness's
# dropout and are checked finite only: on one batch their loss need not
# fall within 7 steps)
BENCH_FIT_STEPS, BENCH_FIT_LAST, BENCH_FIT_RATIO = 30, 5, 0.5
BENCH_SERVE_MAX = 32
BENCH_REQUESTS = [1, 3, 8, 17, 32]
# fused_conv regions a step, request or served batch, and their kernel
# variants by precision: mnist's convs (Cin 1 and 20, Cout 20 and 50, 5x5)
# take the FMA kernel in f32 and mma.sync in bf16 (the stem refuses Cout %
# 8); VGG-16's stem (Cin 3) the stem kernel, its other twelve wgmma
BENCH_REGIONS = {'mnist': 2, 'vgg': 13}
BENCH_VARIANTS = {
    'mnist': {'float32': {'fma': 2}, 'bfloat16': {'mma_sync': 2}},
    'vgg': {'float32': {'fma': 13}, 'bfloat16': {'stem': 1, 'wgmma': 12}}}
# kernel vs plain fused conv, the served logits: max |diff| over max
# |logits|. f32 (AMP off): the same products summed in another order, a
# few ulps a layer; bf16 (AMP): each region's output rounds to bf16
# (2^-8), mnist through 2 regions and an fc, VGG-16 through 13 regions,
# 3 fc and 14 batch norms (ResNet-50's 53 regions take 0.1)
BENCH_LOGITS_TOL = {'mnist': {'float32': 1e-4, 'bfloat16': 2 ** -5},
                    'vgg': {'float32': 1e-4, 'bfloat16': 0.1}}
# VGG-16's gradients (one step at the harness's batch, the dropout masks
# drawn from one seed on both paths), relative L2 per tensor, in f32 and
# under AMP at most this many times a witness (the plain forward in f64,
# rounded). Every step but the kernel's is pinned to the kernel step's
# ReLU and max-pool decisions (``_pin_switches``): unpinned, rounding puts
# a few values on the other side of a switch and that element's gradient
# moves every earlier layer's (f32, batch 8: the kernel read 1.28e-3 on
# one beta's gradient against the witness's 8.69e-6, PERF.md, Findings)
VGG_GRAD_BATCH = BENCH_BATCH
VGG_GRAD_WITNESS = 2.0
# dropout's kept fraction, within this many standard deviations of 1 - p
DROPOUT_SIGMAS = 5


def _bench_program(name, seed, train=True, pins=None):
    """mnist or VGG-16 as benchmark/fluid/models.py:24-48 builds them,
    with the harness's Momentum(0.01, 0.9) when ``train``: (main,
    startup, loss, prediction). With a list ``pins`` the ReLUs and max
    pools are pinned (``_pin_switches``) before the backward is built and
    the fed decisions appended to it."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.models import benchmark as bm
    main, startup = pt.Program(), pt.Program()
    startup.random_seed = seed
    with pt.unique_name.guard(), pt.program_guard(main, startup):
        loss, pred = getattr(bm, name)()
        if pins is not None:
            pins.extend(_pin_switches(main))
        if train:
            bm.train(loss)
    return main, startup, loss, pred


def _pin_switches(main):
    """Make ``main`` take its ReLU and max-pool decisions from fed
    tensors: ``relu(x)`` becomes ``x * mask`` and a 2x2, stride-2 max
    pool ``4 * avg_pool(x * onehot)``, each fed as ``<out>@pin``. Both
    have the gradient of the op they replace wherever the fed decision
    is its own. Returns [(kind, the var the decision is read from in the
    unpinned program, the fed name)]."""
    import paddle_tpu_torch as pt
    block = main.global_block()
    pins, i = [], 0
    while i < len(block.ops):
        op = block.ops[i]
        kind = 'relu' if op.type == 'relu' else 'pool' if (
            op.type == 'pool2d' and op.attrs['pooling_type'] == 'max') \
            else None
        if kind is None:
            i += 1
            continue
        x, out = op.input('X')[0], op.output('Out')[0]
        fed = pt.layers.data(name=out + '@pin', shape=list(
            block.var(x).shape[1:]), dtype='float32')
        block.remove_op(i)
        if kind == 'relu':
            block.insert_op(i, type='elementwise_mul', inputs={
                'X': [x], 'Y': [fed.name]}, outputs={'Out': [out]},
                attrs={'axis': -1})
            pins.append((kind, out, fed.name))
            i += 1
            continue
        check([list(op.attrs[k]) for k in ('ksize', 'strides', 'paddings')]
              == [[2, 2], [2, 2], [0, 0]], 'pinning a max pool %s' % out)
        picked = block.create_var(name=out + '@picked',
                                  shape=block.var(x).shape, dtype='float32')
        mean = block.create_var(name=out + '@mean',
                                shape=block.var(out).shape, dtype='float32')
        block.insert_op(i, type='elementwise_mul', inputs={
            'X': [x], 'Y': [fed.name]}, outputs={'Out': [picked.name]},
            attrs={'axis': -1})
        block.insert_op(i + 1, type='pool2d', inputs={'X': [picked.name]},
                        outputs={'Out': [mean.name]},
                        attrs=dict(op.attrs, pooling_type='avg'))
        block.insert_op(i + 2, type='scale', inputs={'X': [mean.name]},
                        outputs={'Out': [out]},
                        attrs={'scale': 4.0, 'bias': 0.0})
        pins.append((kind, x, fed.name))
        i += 3
    return pins


def _decision(kind, x):
    """A ReLU's mask (x > 0), or the one-hot of each 2x2 window's first
    largest element (the max pool's pick), from ``x`` on the card, in
    f32."""
    import torch
    if kind == 'relu':
        return (x > 0).float()
    n, c, h, w = x.shape
    win = x.float().reshape(n, c, h // 2, 2, w // 2, 2).permute(
        0, 1, 2, 4, 3, 5).reshape(n, c, h // 2, w // 2, 4)
    onehot = torch.nn.functional.one_hot(win.argmax(-1), 4).float()
    return onehot.reshape(n, c, h // 2, w // 2, 2, 2).permute(
        0, 1, 2, 4, 3, 5).reshape(n, c, h, w).contiguous()


def _bench_feed(name, bs, seed):
    """One batch of images and labels, made on the card."""
    import torch
    from paddle_tpu_torch.models import benchmark as bm
    shape, classes = bm.IMAGE_SHAPES[name]
    gen = torch.Generator(device='cuda')
    gen.manual_seed(seed)
    return {'data': torch.randn((bs,) + shape, device='cuda',
                                generator=gen),
            'label': torch.randint(0, classes, (bs, 1), device='cuda',
                                   generator=gen)}


def _analysis_programs(seed):
    """Every program this run builds, as (label, program, feeds,
    fetches): the flagship's serving and training programs, ResNet-50
    (serving and training), SE-ResNeXt-50, stacked_dynamic_lstm,
    machine_translation, mnist and VGG-16 (training and their inference
    twins)."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.models.fluid_transformer import transformer
    progs = []
    for train in (False, True):
        main, startup = pt.Program(), pt.Program()
        with pt.unique_name.guard(), pt.program_guard(main, startup):
            loss, _, _, logits = transformer(None, **FLAGSHIP)
            if train:
                pt.optimizer.Adam(learning_rate=1e-4).minimize(loss)
        progs.append(('flagship %s' % ('training' if train else 'serving'),
                      main if train else main.prune([logits]),
                      ('data', 'label', 'pos') if train else ('data', 'pos'),
                      (loss if train else logits).name))
    main, _, prob = _resnet_program(seed, is_test=True)
    progs.append(('resnet50 serving', main.prune([prob]), ('img',),
                  prob.name))
    for model in ('resnet_imagenet', 'se_resnext'):
        main, _, loss = _train_program(seed, model)
        progs.append(('%s training' % model, main, ('data', 'label'),
                      loss.name))
    main, _, loss, _ = _lstm_program(seed, False)
    progs.append(('stacked_dynamic_lstm training', main, ('data', 'label'),
                  loss.name))
    main, startup = pt.Program(), pt.Program()
    with pt.unique_name.guard(), pt.program_guard(main, startup):
        loss = machine_translation(pt, **MT)
        pt.optimizer.Momentum(learning_rate=0.01, momentum=0.9).minimize(
            loss)
    progs.append(('machine_translation training', main,
                  ('data', 'trg', 'label'), loss.name))
    for name in ('mnist', 'vgg'):
        main, _, loss, pred = _bench_program(name, seed)
        progs.append(('%s training' % name, main, ('data', 'label'),
                      loss.name))
        progs.append(('%s serving' % name,
                      main.clone(for_test=True).prune([pred]), ('data',),
                      pred.name))
    return progs


def phase_analysis(seed):
    """12b. The static verifier, called directly, on every program this
    run builds, before and after the default passes run under the
    sanitizer (PassPipeline(verify=True)): no error, no exception. Then
    through Executor.run on the card: a feed of the wrong rank raises
    FeedInvalid and a mis-wired program ProgramInvalid, both before any
    kernel launch."""
    import torch
    import paddle_tpu_torch as pt
    import paddle_tpu_torch.analysis as A
    from paddle_tpu_torch.compiler import DEFAULT_PASSES
    from paddle_tpu_torch.compiler.pass_base import PassPipeline
    from paddle_tpu_torch.ops import cuda_kernels as ck
    ck.reset_launch_counts()
    for label, prog, feeds, fetch in _analysis_programs(seed):
        for stage in ('as built', 'after the default passes'):
            t0 = time.perf_counter()
            if stage != 'as built':
                prog, _ = PassPipeline(list(DEFAULT_PASSES), name='smoke',
                                       verify=True).run(prog,
                                                        protected=(fetch,))
            t_pass = time.perf_counter() - t0
            t0 = time.perf_counter()
            diags = A.verify_program(prog, feeds=feeds, fetch_names=(fetch,))
            dt = time.perf_counter() - t0
            errors = A.errors_of(diags)
            print('analysis: %s, %s: %d ops, verify %.4f s%s, %d errors, '
                  '%d diagnostics' % (
                      label, stage, len(prog.global_block().ops), dt,
                      '' if stage == 'as built' else
                      ', sanitized passes %.3f s' % t_pass, len(errors),
                      len(diags)), flush=True)
            check(not errors, 'the verifier finds errors in %s (%s):\n%s'
                  % (label, stage, A.format_diagnostics(errors)))
    exe = pt.Executor()                        # CUDAPlace(0)
    main, startup, loss, _ = _bench_program('mnist', seed)
    scope = pt.Scope()
    exe.run(startup, scope=scope)
    feed = _bench_feed('mnist', 4, seed)
    try:
        exe.run(main, feed=dict(feed, data=feed['data'][:, 0]),
                fetch_list=[loss], scope=scope)
        check(False, 'a rank-3 image feed was not refused')
    except A.FeedInvalid as e:
        print('analysis: a rank-3 image feed raised FeedInvalid: %s'
              % e.diagnostics[0].render(), flush=True)
    # a conv whose filter takes 4 channels of a 3-channel image (without
    # the verifier it reaches the fused conv)
    bad, bad_startup = pt.Program(), pt.Program()
    with pt.unique_name.guard(), pt.program_guard(bad, bad_startup):
        img = pt.layers.data(name='img', shape=[3, 32, 32], dtype='float32')
        out = pt.layers.conv2d(img, num_filters=16, filter_size=3,
                               act='relu')
    conv, = [op for op in bad.global_block().ops if op.type == 'conv2d']
    filt = bad.global_block().var(conv.input('Filter')[0])
    filt.shape = (16, 4, 3, 3)
    for v in bad.global_block().all_parameters():
        scope.set_var(v.name, torch.zeros(v.shape, device='cuda'))
    try:
        exe.run(bad, feed={'img': torch.zeros(2, 3, 32, 32, device='cuda')},
                fetch_list=[out], scope=scope)
        check(False, 'a mis-wired conv was not refused')
    except A.ProgramInvalid as e:
        print('analysis: a mis-wired conv raised ProgramInvalid: %s'
              % e.diagnostics[0].render(), flush=True)
        check(e.diagnostics[0].code == 'conv-channel-mismatch',
              'ProgramInvalid names %s' % e.diagnostics[0].code)
    check(not any(ck.LAUNCHES.values()), 'kernels launched before the '
          'analysis refused the run: %s' % ck.LAUNCHES)
    print('analysis: launches after both refusals %s' % ck.LAUNCHES,
          flush=True)
    del scope, exe


class _RegionRecorder(object):
    """A fused conv for ``passes.conv_for_testing`` that calls the
    kernel's wrapper and keeps each call's operands (detached copies),
    so each region can be held against its plain version at the shapes
    the main path gives it."""

    def __init__(self):
        self.calls = []

    def __call__(self, x, w, aux, kinds, stages, strides, pads, depthwise,
                 emit_stats=False):
        from paddle_tpu_torch.ops import cuda_kernels as ck
        self.calls.append((x.detach().clone(), w.detach().clone(),
                           tuple(a.detach().clone() for a in aux),
                           tuple(kinds), tuple(stages), tuple(strides),
                           tuple(pads), bool(depthwise), bool(emit_stats)))
        return ck.fused_conv(x, w, aux, kinds, stages, strides, pads,
                             depthwise, emit_stats=emit_stats)


def _rolled_filters(x, w, aux, kinds, stages, strides, pads, depthwise,
                    emit_stats=False):
    """The fused conv kernel with each output channel computed from the
    next channel's filter (a control)."""
    from paddle_tpu_torch.ops import cuda_kernels as ck
    return ck.fused_conv(x, w.roll(1, 0), aux, kinds, stages, strides, pads,
                         depthwise, emit_stats=emit_stats)


def _hold_regions(label, context, calls, totals, sum_dtypes=('bfloat16',),
                  dedupe=False):
    """Each recorded region against its plain version per element (the
    stats form: y per element, the moments per channel), twice bit for
    bit, a control that must fail (the inference form: the next output
    channel's filters; the stats form: the slab without its last slot
    where M is not a multiple of it), and kernel, plain
    version, cuDNN's conv alone and the bound timed. The regions of
    ``sum_dtypes`` (by default bf16, the card's default, AMP) add to
    ``totals['<form> <context>']`` (with more than one dtype,
    ``'<form> <context> <dtype>'``): {ms, plain_ms, library_ms,
    bound_ms, max_abs_err, regions}, one step's or one request's sums.
    With ``dedupe`` each distinct region is held and timed once and
    counted as often as it was recorded."""
    import torch
    import torch.nn.functional as F
    from paddle_tpu_torch.ops import cuda_kernels as ck
    groups = {}
    for c in calls:
        key = (tuple(c[0].shape), str(c[0].dtype), tuple(c[1].shape),
               tuple(tuple(a.shape) for a in c[2]), repr(c[3:])) \
            if dedupe else len(groups)
        groups.setdefault(key, [c, 0])[1] += 1
    for (x, w, aux, kinds, stages, st, pd, dw, stats), count in \
            groups.values():
        dtype = str(x.dtype).replace('torch.', '')
        N, H, W, cin = x.shape
        cout, k = w.shape[0], w.shape[1]
        args = (x, w, aux, kinds, stages, st, pd, dw)
        plan = ck.fused_conv_plan(x.dtype, N, H, W, cin, cout, k, k, st, pd,
                                  dw, ck._sm_count(x.device.index or 0))
        if stats:
            err = _check_stats_case(x, w, st[0], pd[0], dw, dtype)
            call = lambda: ck.fused_conv(*args, emit_stats=True)  # noqa
            plain = lambda: ck.fused_conv_reference(  # noqa
                *args, emit_stats=True)
            ratio = control = None
        else:
            got = ck.fused_conv(*args)
            same = torch.equal(got, ck.fused_conv(*args))
            ref = ck.fused_conv_reference(*args)
            err = (got.float() - ref.float()).abs().max().item()
            ratio = conv_err_ratio(got, ref, dtype)
            control = conv_err_ratio(_rolled_filters(*args), ref, dtype)
            what = '%s region N=%d %dx%d Cin=%d Cout=%d K=%d %s' % (
                label, N, H, W, cin, cout, k, dtype)
            check(same, 'fused_conv gave other bits on a second call at '
                  + what)
            check(ratio <= 1, 'fused_conv disagrees with its plain version '
                  'at ' + what)
            check(control > 1, 'the per-element limit does not catch '
                  'the next channel\'s filters at ' + what)
            call = lambda: ck.fused_conv(*args)  # noqa
            plain = lambda: ck.fused_conv_reference(*args)  # noqa
        out = x.new_empty((N, (H + 2 * pd[0] - k) // st[0] + 1,
                           (W + 2 * pd[1] - k) // st[1] + 1, cout))
        bound_ms, by = conv_bound(x, w, list(aux), out, k, st[0], pd[0], dw,
                                  extra_bytes=8 * cout if stats else 0)
        kernel_ms = graph_ms(call)
        plain_ms = graph_ms(plain, iters=3, reps=3)
        xc, wc = x.permute(0, 3, 1, 2), w.permute(0, 3, 1, 2)
        library_ms = graph_ms(lambda: F.conv2d(xc, wc, stride=st,
                                               padding=pd))
        print('kernel %s %s region%s N=%d %dx%d Cin=%d Cout=%d K=%d s=%d '
              'p=%d %s [%s] %s: max|err| %.3g%s; kernel_ms %.4f plain_ms %.4f '
              'cudnn_ms %.4f bound_ms %.4f (%s)' % (
                  'fused_conv_stats' if stats else 'fused_conv', label,
                  ' (x%d)' % count if count > 1 else '', N, H,
                  W, cin, cout, k, st[0], pd[0], dtype,
                  ' '.join(s[0] if s[0] != 'act' else s[1] for s in stages),
                  _plan_label(plan), err, '' if stats else
                  ', err/limit %.3g (next channel\'s filters: %.3g), two '
                  'calls bit-identical' % (ratio, control), kernel_ms,
                  plain_ms, library_ms, bound_ms, by), flush=True)
        if dtype not in sum_dtypes:
            continue
        t = totals.setdefault('%s %s%s' % (
            'fused_conv_stats' if stats else 'fused_conv', context,
            ' ' + dtype if len(sum_dtypes) > 1 else ''),
            dict(ms=0.0, plain_ms=0.0, library_ms=0.0, bound_ms=0.0,
                 max_abs_err=0.0, regions=0))
        t['ms'] += kernel_ms * count
        t['plain_ms'] += plain_ms * count
        t['library_ms'] += library_ms * count
        t['bound_ms'] += bound_ms * count
        t['max_abs_err'] = max(t['max_abs_err'], err)
        t['regions'] += count


def _bench_train(name, seed, card, precision):
    """Train ``name`` at BENCH_BATCH in one precision on one fixed batch:
    warm-up steps, then timed steps with the launches counted from 0;
    then one step recorded region by region. Returns (exe, main, scope,
    loss, pred, launches, calls)."""
    import torch
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.compiler import passes
    from paddle_tpu_torch.core import amp
    from paddle_tpu_torch.ops import cuda_kernels as ck
    dtype = 'bfloat16' if precision == 'bf16' else 'float32'
    main, startup, loss, pred = _bench_program(name, seed)
    exe = pt.Executor()                        # CUDAPlace(0)
    scope = pt.Scope()
    exe.run(startup, scope=scope)
    feed = _bench_feed(name, BENCH_BATCH, seed + 21)
    amp.set_amp(precision == 'bf16')
    try:
        losses = [float(exe.run(main, feed=feed, fetch_list=[loss],
                                scope=scope)[0][0])
                  for _ in range(BENCH_WARMUP)]
        torch.cuda.synchronize()
        ck.reset_launch_counts()
        passes.reset_fallback_counts()
        t0 = time.perf_counter()
        outs = [exe.run(main, feed=feed, fetch_list=[loss], scope=scope,
                        return_numpy=False)[0] for _ in range(BENCH_STEPS)]
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        launches = dict(ck.LAUNCHES)
        variants = {v: c for v, c in ck.FUSED_CONV_VARIANT_LAUNCHES.items()
                    if c}
        fallbacks = dict(passes.FALLBACKS)
        losses += [float(o.item()) for o in outs]
        recorder = _RegionRecorder()
        with passes.conv_for_testing(recorder):
            exe.run(main, feed=feed, fetch_list=[loss], scope=scope)
    finally:
        amp.set_amp(None)
    form = 'fused_conv_stats' if name == 'vgg' else 'fused_conv'
    print('%s training: batch %d, %s (AMP %s), %d steps, %.2f ms per step, '
          '%.1f images/s (host clock); losses %s; launches %s, the fused '
          'conv by variant %s, fallbacks %s; %s' % (
              name, BENCH_BATCH, precision, 'on' if precision == 'bf16'
              else 'off', BENCH_STEPS, 1e3 * dt / BENCH_STEPS,
              BENCH_STEPS * BENCH_BATCH / dt,
              ', '.join('%.4f' % l for l in losses), launches, variants,
              fallbacks, card), flush=True)
    expect = {n: 0 for n in launches}
    expect[form] = BENCH_REGIONS[name] * BENCH_STEPS
    check(launches == expect, '%s training launches %s, expected %s'
          % (name, launches, expect))
    check(variants == {v: c * BENCH_STEPS for v, c in
                       BENCH_VARIANTS[name][dtype].items()},
          '%s training took the fused conv variants %s' % (name, variants))
    check(not fallbacks, '%s training fell back: %s' % (name, fallbacks))
    check(all(np.isfinite(losses)), 'non-finite %s training loss' % name)
    check(len(recorder.calls) == BENCH_REGIONS[name] and all(
        c[-1] == (name == 'vgg') for c in recorder.calls),
        '%s training recorded %d regions' % (name, len(recorder.calls)))
    return exe, main, scope, loss, pred, launches, recorder.calls


def _bench_fit(name, seed, precision):
    """Fit one batch: BENCH_FIT_STEPS Momentum steps on one fixed batch
    with every dropout's probability set to 0, on the kernels; the mean
    of the last BENCH_FIT_LAST losses must be under BENCH_FIT_RATIO of
    the first."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.core import amp
    main, startup, loss, _ = _bench_program(name, seed)
    for op in main.global_block().ops:
        if op.type == 'dropout':
            op.attrs['dropout_prob'] = 0.0
    main._bump_version()
    exe = pt.Executor()
    scope = pt.Scope()
    exe.run(startup, scope=scope)
    feed = _bench_feed(name, BENCH_BATCH, seed + 25)
    amp.set_amp(precision == 'bf16')
    try:
        losses = [float(exe.run(main, feed=feed, fetch_list=[loss],
                                scope=scope)[0][0])
                  for _ in range(BENCH_FIT_STEPS)]
    finally:
        amp.set_amp(None)
    last = float(np.mean(losses[-BENCH_FIT_LAST:]))
    print('%s fits one batch: %s (AMP %s), %d steps, dropout off, losses '
          '%s; mean of the last %d %.4f, %.4f of the first (limit %g)' % (
              name, precision, 'on' if precision == 'bf16' else 'off',
              BENCH_FIT_STEPS, ', '.join('%.4f' % l for l in losses),
              BENCH_FIT_LAST, last, last / losses[0], BENCH_FIT_RATIO),
          flush=True)
    check(all(np.isfinite(losses)) and last < BENCH_FIT_RATIO * losses[0],
          '%s (%s) did not fit one batch: %g -> %g' % (
              name, precision, losses[0], last))


def _bench_serve(name, seed, exe, main, scope, pred, art_dir):
    """Save the trained model for inference (its logits and
    probabilities), load it, hold its logits against the plain fused
    conv in both precisions (the next channel's filters must fail), then
    serve it through ModelServer(CUDAPlace(0)) at its buckets, each
    answer bit for bit against a direct run padded to its bucket.
    Returns (the served batches' fused_conv launches, the recorded
    regions)."""
    import torch
    import paddle_tpu_torch as pt
    from paddle_tpu_torch import io as pt_io
    from paddle_tpu_torch.compiler import passes
    from paddle_tpu_torch.core import amp
    from paddle_tpu_torch.ops import cuda_kernels as ck
    from paddle_tpu_torch.serving.bucketing import pad_feed
    softmax = [op for op in main.global_block().ops
               if op.type == 'softmax'][-1]
    logits = main.global_block().var(softmax.input('X')[0])
    d = os.path.join(art_dir, name)
    pt_io.save_inference_model(d, ['data'], [logits, pred], exe,
                               main_program=main, scope=scope)
    load_scope = pt.Scope()
    prog, feed_names, fetch_vars = pt_io.load_inference_model(
        d, exe, scope=load_scope)
    images = _bench_feed(name, BENCH_BATCH, seed + 31)['data']

    def direct(rows, conv=None):
        with passes.conv_for_testing(conv) if conv else \
                contextlib.nullcontext():
            return exe.run(prog, feed={'data': images[:rows]},
                           fetch_list=fetch_vars, scope=load_scope)

    calls = []
    for precision in ('f32', 'bf16'):
        dtype = 'bfloat16' if precision == 'bf16' else 'float32'
        tol = BENCH_LOGITS_TOL[name][dtype]
        amp.set_amp(precision == 'bf16')
        try:
            ck.reset_launch_counts()
            got, prob = direct(BENCH_BATCH)
            n = ck.LAUNCHES['fused_conv']
            variants = {v: c for v, c in
                        ck.FUSED_CONV_VARIANT_LAUNCHES.items() if c}
            ref, _ = direct(BENCH_BATCH, ck.fused_conv_reference)
            recorder = _RegionRecorder()
            direct(BENCH_BATCH, recorder)
            calls += recorder.calls
            ctl, _ = direct(BENCH_BATCH, _rolled_filters)
        finally:
            amp.set_amp(None)
        scale = float(np.abs(ref).max())
        diff = float(np.abs(got - ref).max()) / scale
        c_diff = float(np.abs(ctl - ref).max()) / scale
        print('%s serving: batch-%d logits, %s (AMP %s), fused kernel vs '
              'plain fused conv: max |diff| / max |logits| %.4g (tol %g), '
              'top-1 agreement %.4f; control (the next channel\'s filters) '
              '%.4g; '
              '%d fused conv launches by variant %s' % (
                  name, BENCH_BATCH, precision,
                  'on' if precision == 'bf16' else 'off', diff, tol,
                  float((got.argmax(-1) == ref.argmax(-1)).mean()), c_diff,
                  n, variants), flush=True)
        check(diff <= tol, '%s %s logits differ from the plain fused conv '
              'by %g of their scale' % (name, precision, diff))
        check(c_diff > tol, 'the %s logits limit does not catch the next '
              'channel\'s filters' % name)
        check(n == BENCH_REGIONS[name] and variants ==
              BENCH_VARIANTS[name][dtype], '%s served %s with %d launches, '
              'variants %s' % (name, precision, n, variants))
        check(np.isfinite(prob).all() and np.allclose(prob.sum(1), 1.0,
                                                      atol=1e-3),
              '%s probabilities' % name)
    server = pt.serving.ModelServer(pt.CUDAPlace(0),
                                    max_batch_size=BENCH_SERVE_MAX)
    try:
        server.load_model(name, d)
        t0 = time.perf_counter()
        server.warmup(name)
        warm = time.perf_counter() - t0
        # each request alone is one batch at its rows' bucket: its
        # answer must equal a direct run of its rows padded to that
        # bucket, bit for bit (same batch, same plans)
        buckets = [server.policy.bucket_for(rows) for rows in BENCH_REQUESTS]
        refs = [[r[:rows] for r in exe.run(prog, feed=pad_feed(
            {'data': images[:rows].cpu().numpy()}, rows, bucket,
            server.policy.pad_mode), fetch_list=fetch_vars,
            scope=load_scope)] for rows, bucket in zip(BENCH_REQUESTS,
                                                       buckets)]
        ck.reset_launch_counts()
        passes.reset_fallback_counts()
        times, batches = [], 0
        for rows, bucket, ref in zip(BENCH_REQUESTS, buckets, refs):
            t0 = time.perf_counter()
            got = server.infer(name, {'data': images[:rows].cpu().numpy()})
            times.append(time.perf_counter() - t0)
            for g, r in zip(got, ref):
                check(g.shape == r.shape and np.array_equal(g, r),
                      '%s served %d rows (bucket %d) %.4g from a direct run '
                      'padded to the bucket' % (
                          name, rows, bucket, float(np.abs(g - r).max())
                          if g.shape == r.shape else float('nan')))
            batches += 1
        launches = ck.LAUNCHES['fused_conv']
        fallbacks = dict(passes.FALLBACKS)
    finally:
        server.close()
    print('%s serving: ModelServer(CUDAPlace(0)), buckets warmed in %.1f s, '
          'requests of %s rows (buckets %s): %s ms (host clock), every '
          'answer bit-equal to a direct run padded to its bucket; %d fused '
          'conv launches, fallbacks %s' % (
              name, warm, BENCH_REQUESTS, buckets, ', '.join(
                  '%.2f' % (1e3 * t) for t in times), launches, fallbacks),
          flush=True)
    check(launches == BENCH_REGIONS[name] * batches, '%s served %d batches '
          'with %d fused conv launches' % (name, batches, launches))
    check(not fallbacks, '%s serving fell back: %s' % (name, fallbacks))
    del load_scope, prog
    return launches, calls


def _vgg_gradients(seed):
    """A batch-32 VGG-16 step's gradients and moving statistics against
    the plain stats form (``_hold_gradients``: in f32 and under AMP
    VGG_GRAD_WITNESS times the f64 witness; every other step pinned to
    the kernel step's ReLU and max-pool decisions), the scope's generator
    seeded alike before each step so the dropout masks agree (checked);
    then each mask's kept fraction against 1 - p."""
    import paddle_tpu_torch as pt
    main, startup, loss, _ = _bench_program('vgg', seed)
    pins = []
    twin = _bench_program('vgg', seed, pins=pins)[0]
    scope = pt.Scope()
    pt.Executor().run(startup, scope=scope)
    dropouts = [op for op in main.global_block().ops
                if op.type == 'dropout']
    masks = _hold_gradients(
        'vgg', main, scope, _bench_feed('vgg', VGG_GRAD_BATCH, seed + 23),
        BENCH_REGIONS['vgg'], None, VGG_GRAD_WITNESS, reseed=seed + 29,
        fetch=[op.output('Mask')[0] for op in dropouts],
        pinned=(twin, pins))
    for op in dropouts:
        p, m = float(op.attrs['dropout_prob']), op.output('Mask')[0]
        mask = masks[m].float()
        kept = mask.mean().item()
        sigma = (p * (1 - p) / mask.numel()) ** 0.5
        print('vgg dropout: %s p %.1f, %d elements on the card, kept %.5f '
              '(1 - p %.5f, %.2f sigma)' % (m, p, mask.numel(), kept, 1 - p,
                                            abs(kept - (1 - p)) / sigma),
              flush=True)
        check(abs(kept - (1 - p)) <= DROPOUT_SIGMAS * sigma,
              'dropout %s kept %g, not 1 - p = %g' % (m, kept, 1 - p))
        check(bool(((mask == 0) | (mask == 1)).all()), 'a mask holds other '
              'values than 0 and 1')


def phase_bench_model(name, seed, card, art_dir):
    """12c, 12d. mnist or VGG-16 (benchmark/fluid/models.py:24-48) at the
    published widths: Momentum steps at batch 32 in f32 and under AMP
    (exact launches and variants, no fallback, finite losses; then one
    batch fitted with dropout off), every
    region of a training step and of a served request held against its
    plain version per element and timed; the trained model saved, loaded
    and served through ModelServer at its buckets; for VGG-16 the
    gradients against the plain path and the dropout masks. Returns the
    main paths' launches: {'fused_conv': training (mnist) and serving,
    'fused_conv_stats': training (VGG-16)} and the regions' totals."""
    import torch
    launches = {'fused_conv': 0, 'fused_conv_stats': 0}
    totals = {}
    for precision in ('f32', 'bf16'):
        exe, main, scope, loss, pred, counted, calls = _bench_train(
            name, seed, card, precision)
        _bench_fit(name, seed, precision)
        for n in launches:
            launches[n] += counted[n]
        _hold_regions('%s training' % name, 'training', calls, totals)
        del calls
    served, calls = _bench_serve(name, seed, exe, main, scope, pred, art_dir)
    launches['fused_conv'] += served
    _hold_regions('%s serving' % name, 'serving', calls, totals)
    del exe, scope, calls
    if name == 'vgg':
        _vgg_gradients(seed)
    for key, t in sorted(totals.items()):
        print('%s regions, %s, bf16 (AMP), one batch-%d step or request: %d '
              'regions, summed kernel %.4f ms, plain %.4f ms, cuDNN conv '
              'alone %.4f ms, bound %.4f ms; %s' % (
                  name, key, BENCH_BATCH, t['regions'], t['ms'],
                  t['plain_ms'], t['library_ms'], t['bound_ms'], card),
              flush=True)
    torch.cuda.empty_cache()
    return launches, totals


# ---- 13b: the Fluid books -----------------------------------------------------------
BOOK_NAMES = ('fit_a_line', 'recognize_digits_conv', 'recognize_digits_mlp',
              'image_classification', 'word2vec')
# training steps a run, each on the next batch of the book's reader; the
# limit: the mean of the last BOOK_WINDOW losses under BOOK_FALL of the
# mean of the first BOOK_WINDOW. Two controls must fail it: the same run
# at learning rate 0 and at minus the script's rate (on an H100 at these
# steps, PERF.md, Findings: fit_a_line 0.341 against 0.975 and 2.924;
# recognize_digits conv 0.0073 against 1.028 and 1.204, MLP 0.0035
# against 1.018 and 3.062; ResNet-32 0.499 (AMP 0.483) against 1.016 and
# 2.276; word2vec 0.807 against 0.997 and 1.196)
BOOK_STEPS = {'fit_a_line': 300, 'recognize_digits_conv': 40,
              'recognize_digits_mlp': 40, 'image_classification': 20,
              'word2vec': 600}
BOOK_WINDOW = 10
BOOK_FALL = {'fit_a_line': 0.6, 'recognize_digits_conv': 0.5,
             'recognize_digits_mlp': 0.5, 'image_classification': 0.7,
             'word2vec': 0.9}
# fused conv regions a step or a served batch: recognize_digits' two
# 5x5 convs (its batch norm follows a pool, outside any region);
# ResNet-32's 31 3x3 convs and 2 1x1 projections, each with its batch
# norm (the stats form in training)
BOOK_REGIONS = {'recognize_digits_conv': 2, 'image_classification': 33}
# one f32 step on the card (TF32 off) against the same step of the port
# on the CPU from the same parameters and feed: max |diff| over max
# |value| of the loss and of the probabilities (two f32 implementations
# of the same sums, a few ulps a layer through up to 33 batch norms)
BOOK_CPU_TOL = 1e-4
# every new op kernel, card against CPU on seeded inputs: the integer,
# bool and data-movement ops bit for bit; the float math max |diff| over
# max |value| at most this (f32, a few ulps); matmul in f32 (TF32 off)
# and in bf16 under AMP (operands and result rounded to bf16: 2^-7)
BOOK_OPS_TOL = {'float32': 1e-5, 'bfloat16': 2 ** -7}
BOOK_SERVE_MAX = 32
BOOK_REQUESTS = [1, 3, 8, 17, 32]
BOOK_LABELS = ('y', 'label', 'nextw')        # the feeds a request lacks


def _book_program(name, seed, learning_rate=None):
    """A book at the script's widths with its optimizer (another
    learning rate if given): (main, startup, Book)."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.models import books
    main, startup = pt.Program(), pt.Program()
    startup.random_seed = seed
    with pt.unique_name.guard(), pt.program_guard(main, startup):
        book = books.BOOKS[name]()
        if learning_rate is None:
            books.train(book)
        else:
            type(book.optimizer())(learning_rate=learning_rate).minimize(
                book.loss)
    return main, startup, book


def _book_batches(book, seed, batch_size=None):
    """The book's reader on its synthetic dataset, pass after pass, the
    shuffle seeded."""
    import random
    from paddle_tpu_torch.models import books
    random.seed(seed)
    reader = books.reader(book, batch_size)
    while True:
        for b in reader():
            yield b


def _book_ratio(losses):
    return float(np.mean(losses[-BOOK_WINDOW:]) /
                 np.mean(losses[:BOOK_WINDOW]))


def _book_train(name, seed, precision='f32', learning_rate=None,
                record=False):
    """Train a book on the card through its DataFeeder and reader:
    BOOK_STEPS steps (launches counted from 0 over them), the accuracy
    checked on the card each step against the host's from the fetched
    probabilities; with ``record`` one more step region by region."""
    import torch
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.compiler import passes
    from paddle_tpu_torch.core import amp
    from paddle_tpu_torch.ops import cuda_kernels as ck
    main, startup, book = _book_program(name, seed, learning_rate)
    exe = pt.Executor()                        # CUDAPlace(0)
    scope = pt.Scope()
    exe.run(startup, scope=scope)
    initial = _book_state(scope)
    feeder = pt.DataFeeder(feed_list=book.feeds, place=pt.CUDAPlace(0),
                           program=main)
    batches = _book_batches(book, seed + 1)
    fetch = [book.loss] + ([book.accuracy, book.prediction]
                           if book.accuracy is not None else [])
    label = book.feeds[-1].name
    amp.set_amp(precision == 'bf16')
    try:
        exe.run(main, feed=feeder.feed(next(batches)), fetch_list=fetch,
                scope=scope)                   # warm-up: not counted
        torch.cuda.synchronize()
        ck.reset_launch_counts()
        passes.reset_fallback_counts()
        losses, accs = [], []
        feeding = 0.0
        t0 = time.perf_counter()
        for _ in range(BOOK_STEPS[name]):
            t1 = time.perf_counter()
            feed = feeder.feed(next(batches))
            feeding += time.perf_counter() - t1
            out = exe.run(main, feed=feed, fetch_list=fetch, scope=scope)
            losses.append(float(out[0][0]))
            if book.accuracy is not None:
                host = float(np.mean(out[2].argmax(-1) ==
                                     feed[label].reshape(-1)))
                check(float(out[1][0]) == host, '%s: accuracy %g on the '
                      'card, %g from its probabilities' % (
                          name, float(out[1][0]), host))
                accs.append(float(out[1][0]))
        dt = time.perf_counter() - t0
        launches = dict(ck.LAUNCHES)
        variants = {v: c for v, c in ck.FUSED_CONV_VARIANT_LAUNCHES.items()
                    if c}
        fallbacks = dict(passes.FALLBACKS)
        busy = None
        if learning_rate is None:
            feed = feeder.feed(next(batches))
            _, busy_us = profile_run(
                lambda: exe.run(main, feed=feed, fetch_list=fetch,
                                scope=scope),
                'book %s step (%s)' % (name, precision), top=4)
            busy = busy_us / 1e3
        calls = []
        if record:
            recorder = _RegionRecorder()
            with passes.conv_for_testing(recorder):
                exe.run(main, feed=feeder.feed(next(batches)),
                        fetch_list=[book.loss], scope=scope)
            calls = recorder.calls
    finally:
        amp.set_amp(None)
    return dict(exe=exe, main=main, scope=scope, book=book, feeder=feeder,
                batches=batches, initial=initial, losses=losses, accs=accs,
                launches=launches, variants=variants, fallbacks=fallbacks,
                calls=calls, ms=1e3 * dt / BOOK_STEPS[name],
                feed_ms=1e3 * feeding / BOOK_STEPS[name], busy_ms=busy)


def _book_state(scope):
    """A scope's tensors as numpy arrays (its parameters, moving
    statistics, optimizer accumulators)."""
    return {n: v.detach().cpu().numpy() for n, v in scope.vars.items()
            if hasattr(v, 'detach')}


def _book_check_run(name, run, precision, card):
    """A main-path run: finite, falling losses; exact launches, no
    fallback."""
    losses, steps = run['losses'], BOOK_STEPS[name]
    ratio = _book_ratio(losses)
    bs = run['book'].batch_size
    print('book %s training: batch %d, %s (AMP %s), %d steps, %.2f ms a '
          'step (%.2f of it the reader and DataFeeder; one profiled step '
          'busy on the card %.3f ms), %.1f samples/s (host clock); losses '
          '%.4f .. %.4f, last %d over first %d: %.4f (limit %g)%s; launches '
          '%s, the fused conv by variant %s, fallbacks %s; %s' % (
              name, bs, precision, 'on' if precision == 'bf16' else 'off',
              steps, run['ms'], run['feed_ms'], run['busy_ms'],
              1e3 * bs / run['ms'], losses[0], losses[-1],
              BOOK_WINDOW, BOOK_WINDOW, ratio, BOOK_FALL[name],
              '; accuracy %.4f .. %.4f (on the card, equal to the host\'s '
              'from the probabilities every step)' % (
                  run['accs'][0], run['accs'][-1]) if run['accs'] else '',
              {n: c for n, c in run['launches'].items() if c},
              run['variants'], run['fallbacks'], card), flush=True)
    check(all(np.isfinite(losses)), 'non-finite %s loss' % name)
    check(ratio < BOOK_FALL[name], '%s (%s) loss did not fall: %.4f of '
          'the first' % (name, precision, ratio))
    expect = {n: 0 for n in run['launches']}
    if name in BOOK_REGIONS:
        form = 'fused_conv_stats' if name == 'image_classification' \
            else 'fused_conv'
        expect[form] = BOOK_REGIONS[name] * steps
    check(run['launches'] == expect, '%s training launches %s, expected %s'
          % (name, run['launches'], expect))
    check(sum(run['variants'].values()) == sum(expect.values()),
          '%s: the fused conv by variant %s' % (name, run['variants']))
    check(not run['fallbacks'], '%s fell back: %s' % (name,
                                                      run['fallbacks']))


def _book_controls(name, seed):
    """The falling-loss limit against the same run at learning rate 0
    and at minus the script's: both must fail it."""
    _, _, book = _book_program(name, seed)
    lr = book.optimizer()._learning_rate
    for label, rate in (('rate 0', 0.0), ('minus the rate', -lr)):
        losses = _book_train(name, seed, learning_rate=rate)['losses']
        ratio = _book_ratio(losses)
        print('book %s control (%s): last %d over first %d %.4f (limit %g, '
              'must fail)' % (name, label, BOOK_WINDOW, BOOK_WINDOW, ratio,
                              BOOK_FALL[name]), flush=True)
        check(not ratio < BOOK_FALL[name], 'the %s loss limit does not catch '
              'training at %s' % (name, label))


def _book_cpu_hold(name, run):
    """One f32 step on the card against the same step of the port on the
    CPU, from the card's parameters and one feed: loss and probabilities
    within BOOK_CPU_TOL of their scale; controls (the CPU step on the
    next batch, and from the parameters before training) must fail it."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch import io as pt_io
    from paddle_tpu_torch.core import amp
    book, main = run['book'], run['main']
    state = _book_state(run['scope'])
    feed = run['feeder'].feed(next(run['batches']))
    other = run['feeder'].feed(next(run['batches']))
    fetch = [book.loss, book.prediction]
    amp.set_amp(False)
    try:
        card_out = run['exe'].run(main, feed=feed, fetch_list=fetch,
                                  scope=run['scope'])

        def cpu(f, arrays):
            scope = pt.Scope()
            pt_io.params_from_numpy(scope, arrays, pt.CPUPlace())
            return pt.Executor(pt.CPUPlace()).run(main, feed=f,
                                                  fetch_list=fetch,
                                                  scope=scope)
        readings = {}
        for what, f, arrays in (
                ('same step', feed, state), ('next batch', other, state),
                ('untrained', feed, run['initial'])):
            readings[what] = [float(np.abs(c - r).max() /
                                    max(np.abs(r).max(), 1e-30))
                              for c, r in zip(card_out, cpu(f, arrays))]
    finally:
        amp.set_amp(None)
    print('book %s: one f32 step, card against CPU: loss %.3g, '
          'probabilities %.3g of their scale (limit %g); controls (loss, '
          'probabilities): next batch %s, the parameters before training %s'
          % (name, readings['same step'][0], readings['same step'][1],
             BOOK_CPU_TOL, ', '.join('%.3g' % r for r in
                                     readings['next batch']),
             ', '.join('%.3g' % r for r in readings['untrained'])),
          flush=True)
    check(max(readings['same step']) <= BOOK_CPU_TOL, '%s: the card\'s step '
          'differs from the CPU\'s by %s' % (name, readings['same step']))
    for what in ('next batch', 'untrained'):
        check(max(readings[what]) > BOOK_CPU_TOL, 'the %s CPU limit does '
              'not catch the %s' % (name, what))


def _book_serve(name, run, art_dir, record=False):
    """Save the trained book for inference (its probabilities), load it,
    serve it through ModelServer(CUDAPlace(0)) at its buckets in f32:
    each answer bit for bit against a direct run padded to its bucket,
    one launch a region a batch, no fallback. A book with fused conv
    regions then has a direct run padded to each bucket the server used
    recorded region by region (the served shapes, f32). With ``record``,
    a batch of the training batch's rows is recorded too, in f32 and in
    bf16 (AMP): the inference form at the training batch. Returns
    (fused_conv launches, {context: recorded calls})."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch import io as pt_io
    from paddle_tpu_torch.compiler import passes
    from paddle_tpu_torch.core import amp
    from paddle_tpu_torch.ops import cuda_kernels as ck
    from paddle_tpu_torch.serving.bucketing import pad_feed
    book, exe = run['book'], run['exe']
    names = [v.name for v in book.feeds if v.name not in BOOK_LABELS]
    d = os.path.join(art_dir, name)
    pt_io.save_inference_model(d, names, [book.prediction], exe,
                               main_program=run['main'], scope=run['scope'])
    load_scope = pt.Scope()
    prog, feed_names, fetch_vars = pt_io.load_inference_model(
        d, exe, scope=load_scope)
    check(feed_names == names, '%s saved feeds %s' % (name, feed_names))
    rows = max(BOOK_SERVE_MAX, book.batch_size)
    big = run['feeder'].feed(next(_book_batches(book, 97, rows)))
    feed = {n: big[n][:BOOK_SERVE_MAX] for n in names}
    calls = {}
    if record:
        for precision in ('f32', 'bf16'):
            amp.set_amp(precision == 'bf16')
            try:
                recorder = _RegionRecorder()
                with passes.conv_for_testing(recorder):
                    exe.run(prog, feed={n: big[n][:book.batch_size]
                                        for n in names},
                            fetch_list=fetch_vars, scope=load_scope)
                calls.setdefault('inference b%d' % book.batch_size,
                                 []).extend(recorder.calls)
            finally:
                amp.set_amp(None)
    amp.set_amp(False)
    server = pt.serving.ModelServer(pt.CUDAPlace(0),
                                    max_batch_size=BOOK_SERVE_MAX)
    try:
        server.load_model(name, d)
        server.warmup(name)
        buckets = [server.policy.bucket_for(r) for r in BOOK_REQUESTS]
        refs = [exe.run(prog, feed=pad_feed(
            {n: a[:r] for n, a in feed.items()}, r, b,
            server.policy.pad_mode), fetch_list=fetch_vars,
            scope=load_scope)[0][:r] for r, b in zip(BOOK_REQUESTS, buckets)]
        ck.reset_launch_counts()
        passes.reset_fallback_counts()
        times = []
        for r, b, ref in zip(BOOK_REQUESTS, buckets, refs):
            t0 = time.perf_counter()
            got, = server.infer(name, {n: a[:r] for n, a in feed.items()})
            times.append(time.perf_counter() - t0)
            check(got.shape == ref.shape and np.array_equal(got, ref),
                  '%s served %d rows (bucket %d) off a direct run padded to '
                  'the bucket' % (name, r, b))
            check(np.isfinite(got).all() and np.allclose(
                got.sum(-1), 1.0, atol=1e-4) if name != 'fit_a_line'
                else np.isfinite(got).all(), '%s answers' % name)
        launches = dict(ck.LAUNCHES)
        fallbacks = dict(passes.FALLBACKS)
        if name in BOOK_REGIONS:
            # the served shapes: one request padded to each bucket used
            for b in sorted(set(buckets)):
                r = BOOK_REQUESTS[buckets.index(b)]
                recorder = _RegionRecorder()
                with passes.conv_for_testing(recorder):
                    exe.run(prog, feed=pad_feed(
                        {n: a[:r] for n, a in feed.items()}, r, b,
                        server.policy.pad_mode), fetch_list=fetch_vars,
                        scope=load_scope)
                check(len(recorder.calls) == BOOK_REGIONS[name],
                      '%s recorded %d regions at bucket %d' % (
                          name, len(recorder.calls), b))
                calls['serving b%d' % b] = recorder.calls
    finally:
        server.close()
        amp.set_amp(None)
    served = launches['fused_conv']
    print('book %s serving: ModelServer(CUDAPlace(0)), f32, requests of %s '
          'rows (buckets %s): %s ms (host clock), every answer bit-equal '
          'to a direct run padded to its bucket; launches %s, fallbacks %s'
          % (name, BOOK_REQUESTS, buckets, ', '.join(
              '%.2f' % (1e3 * t) for t in times),
              {n: c for n, c in launches.items() if c}, fallbacks),
          flush=True)
    expect = {n: 0 for n in launches}
    expect['fused_conv'] = BOOK_REGIONS.get(name, 0) * len(BOOK_REQUESTS)
    check(launches == expect, '%s served with launches %s, expected %s'
          % (name, launches, expect))
    check(not fallbacks, '%s serving fell back: %s' % (name, fallbacks))
    return served, calls


def _book_ops_program(seed):
    """One program of the slice's new op kernels on seeded inputs:
    (main, startup, feed, exact fetch names, float fetch names, matmul
    fetch names, the names of few levels, which the next seed may
    repeat)."""
    import paddle_tpu_torch as pt
    L = pt.layers
    main, startup = pt.Program(), pt.Program()
    startup.random_seed = seed
    with pt.unique_name.guard(), pt.program_guard(main, startup):
        x = L.data(name='x', shape=[6, 8], dtype='float32')
        y = L.data(name='y', shape=[6, 8], dtype='float32')
        lab = L.data(name='lab', shape=[1], dtype='int64')
        idx = L.data(name='idx', shape=[7], dtype='int64',
                     append_batch_size=False)
        w = L.data(name='w', shape=[8, 16], dtype='float32',
                   append_batch_size=False)
        flat = L.reshape(x, [-1, 48])
        probs = L.sigmoid(x)
        acc = L.accuracy(input=flat, label=lab, k=3)
        acc_op = acc.block.ops[-1]
        correct, total = [acc.block.var(acc_op.output(s)[0])
                          for s in ('Correct', 'Total')]
        filled = L.fill_constant_batch_size_like(x, shape=[-1, 5],
                                                 dtype='float32', value=2.5)
        lab01 = L.floor(L.scale(probs, scale=2.0))
        values, indices = L.topk(flat, k=5)
        exact = [L.cast(L.scale(x, scale=3.0), 'int32'),
                 L.cast(L.scale(x, scale=3.0), 'int64'), L.cast(x, 'bool'),
                 L.squeeze(L.unsqueeze(x, axes=[1, 3]), axes=[1]),
                 L.transpose(x, perm=[2, 0, 1]),
                 L.one_hot(lab, depth=40), L.gather(flat, idx), values,
                 indices, acc, correct, total,
                 L.increment(lab, value=3.0, in_place=False),
                 L.expand(x, expand_times=[1, 2, 3]), filled,
                 L.reduce_max(x, dim=1), L.reduce_min(x, dim=[1, 2]),
            L.less_than(x, y), L.less_equal(x, y), L.greater_than(x, y),
            L.greater_equal(x, y), L.equal(x, L.floor(x)),
            L.not_equal(x, y)]
        a, b = L.less_than(x, y), L.greater_than(x, L.floor(y))
        exact += [L.logical_and(a, b), L.logical_or(a, b),
                  L.logical_xor(a, b), L.logical_not(a),
                  L.maxout(L.reshape(x, [-1, 6, 2, 4]), groups=2)]
        near = [L.reduce_mean(x, dim=-1), L.reduce_sum(x, dim=[0, 1]),
                L.reduce_prod(x, dim=2, keep_dim=True), L.reduce_mean(x),
                L.square_error_cost(input=x, label=y), L.smooth_l1(x, y),
                L.cos(x), L.sin(x),
                L.sigmoid_cross_entropy_with_logits(x=x, label=probs),
                L.hinge_loss(input=x, label=lab01),
                L.huber_loss(x, y, delta=0.5), L.log_loss(probs, lab01),
                L.rank_loss(lab01, x, y),
                L.margin_rank_loss(L.sign(y), x, y, margin=0.1),
                L.modified_huber_loss(x, lab01),
                L.squared_l2_distance(flat, L.reshape(y, [-1, 48])),
                L.squared_l2_norm(x), L.l1_norm(x),
                L.prelu(L.reshape(x, [-1, 6, 2, 4]), mode='channel')]
        mm = [L.matmul(x, w), L.matmul(x, y, transpose_y=True),
              L.matmul(w, w, transpose_x=True, alpha=0.5),
              L.matmul(L.reshape(x, [-1, 48]), L.reshape(y, [48, -1]))]
    rng = np.random.RandomState(seed)
    n = 16
    # zeros at random places (cast to bool, equal to its floor), labels
    # and indices past both ends (one_hot's zero rows, gather's NaN rows)
    feed = {'x': (rng.randn(n, 6, 8) * (rng.rand(n, 6, 8) > 0.2)).astype(
                'float32'),
            'y': rng.randn(n, 6, 8).astype('float32'),
            'lab': rng.randint(-2, 42, (n, 1)).astype('int64'),
            'idx': rng.randint(-n - 2, n + 2, 7).astype('int64'),
            'w': rng.randn(8, 16).astype('float32')}
    tie = rng.rand(n, 6, 8) < 0.3                   # ties for the compares
    feed['y'][tie] = feed['x'][tie]
    # fetches of a few levels, which another seed's inputs may repeat
    coarse = [v.name for v in (acc, correct, total, filled)]
    return (main, startup, feed, [v.name for v in exact],
            [v.name for v in near], [v.name for v in mm], coarse)


def _book_ops(seed, card):
    """Every new op kernel on the card against the CPU on seeded inputs,
    within BOOK_OPS_TOL (bit for bit where exact); the card's fetches
    against the CPU's on the next seed's inputs must fail, every one that
    depends on the inputs' values."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.core import amp
    main, startup, feed, exact, near, mm, coarse = _book_ops_program(seed)
    other = _book_ops_program(seed + 1)[2]

    def run(place, f, precision):
        amp.set_amp(precision == 'bf16')
        try:
            exe, scope = pt.Executor(place), pt.Scope()
            exe.run(startup, scope=scope)
            names = mm if precision == 'bf16' else exact + near + mm
            return dict(zip(names, exe.run(main, feed=f, fetch_list=names,
                                           scope=scope)))
        finally:
            amp.set_amp(None)

    def reading(got, ref, n, dtype):
        g, r = np.asarray(got[n]), np.asarray(ref[n])
        if g.shape != r.shape:
            return float('inf')
        if n in exact:
            same = np.array_equal(g, r, equal_nan=True) if \
                g.dtype.kind == 'f' else np.array_equal(g, r)
            return 0.0 if same else float('inf')
        return float(np.abs(g.astype('float64') - r).max() /
                     max(np.abs(r).max(), 1e-30))

    worst = {}
    for precision in ('f32', 'bf16'):
        dtype = 'bfloat16' if precision == 'bf16' else 'float32'
        card_out = run(pt.CUDAPlace(0), feed, precision)
        cpu_out = run(pt.CPUPlace(), feed, precision)
        ctl_out = run(pt.CPUPlace(), other, precision)
        for n in card_out:
            r = reading(card_out, cpu_out, n, dtype)
            c = reading(card_out, ctl_out, n, dtype)
            kind = 'exact' if n in exact else 'matmul %s' % precision \
                if n in mm else 'float'
            worst[kind] = max(worst.get(kind, 0.0), r)
            limit = 0.0 if n in exact else BOOK_OPS_TOL[dtype]
            check(r <= limit, 'op %s on the card: %g from the CPU (limit %g, '
                  '%s)' % (n, r, limit, precision))
            check(n in coarse or c > limit, 'op %s: the next seed\'s '
                  'inputs read %g, inside the limit' % (n, c))
    print('book ops: %d fetches of the new op kernels (%d exact, %d float, '
          '%d matmul), card against CPU on seeded inputs: worst %s (limits: '
          'exact, %g f32, %g bf16 matmul under AMP); the next seed\'s inputs '
          'fail every fetch but %d of few levels; %s' % (
              len(exact) + len(near) + len(mm), len(exact), len(near),
              len(mm), ', '.join('%s %.3g' % kv for kv in
                                 sorted(worst.items())),
              BOOK_OPS_TOL['float32'], BOOK_OPS_TOL['bfloat16'], len(coarse),
              card),
          flush=True)


def _count_regions(name, seed):
    """The fused conv regions of a book's training program after the
    default passes, counted from the program."""
    import paddle_tpu_torch as pt
    main, _, book = _book_program(name, seed)
    opt, _ = pt.compiler.optimize(main, fetch_names=[book.loss.name])
    return sum(op.type == 'fused_conv' for op in opt.global_block().ops)


def phase_books(seed, card, art_dir):
    """13b. The Fluid books at the scripts' widths, f32 (and ResNet-32
    under AMP as well): trained through DataFeeder and the readers on
    their synthetic datasets with falling losses (two controls fail the
    limit), accuracy on the card, one step held against the CPU, saved,
    loaded and served bit-equal to direct runs padded to their buckets,
    each served bucket's regions held against their plain versions,
    exact launches; every new op kernel on the card against the CPU.
    Returns the main paths' launches {'fused_conv': recognize_digits'
    training and both books' serving, 'fused_conv_stats': ResNet-32's
    training} and the regions' totals (f32 and bf16)."""
    import tempfile
    import torch
    import paddle_tpu_torch as pt
    t_phase = time.perf_counter()
    # the datasets read nothing outside the checkout: their synthetic
    # fallbacks, made from constant seeds
    os.environ['PADDLE_TPU_TORCH_DATA_HOME'] = tempfile.mkdtemp(dir=art_dir)
    _book_ops(seed, card)
    launches = {'fused_conv': 0, 'fused_conv_stats': 0}
    totals = {}
    for name in BOOK_NAMES:
        if name in BOOK_REGIONS:
            n = _count_regions(name, seed)
            print('book %s: %d fused conv regions in its training program '
                  'after the default passes' % (name, n), flush=True)
            check(n == BOOK_REGIONS[name], '%s has %d regions' % (name, n))
        precisions = ('f32', 'bf16') if name == 'image_classification' \
            else ('f32',)
        for precision in precisions:
            run = _book_train(name, seed, precision,
                              record=name in BOOK_REGIONS)
            _book_check_run(name, run, precision, card)
            for n in launches:
                launches[n] += run['launches'][n]
            if run['calls']:
                _hold_regions('book %s training' % name, '%s training'
                              % name, run['calls'], totals,
                              sum_dtypes=('float32', 'bfloat16'),
                              dedupe=True)
            if precision == 'f32':
                _book_controls(name, seed)
                _book_cpu_hold(name, run)
                served, calls = _book_serve(
                    name, run, art_dir, record=name == 'image_classification')
                launches['fused_conv'] += served
                for context, c in sorted(calls.items()):
                    _hold_regions('book %s %s' % (name, context), '%s %s'
                                  % (name, context), c, totals,
                                  sum_dtypes=('float32', 'bfloat16')
                                  if context.startswith('inference')
                                  else ('float32',), dedupe=True)
            del run
        torch.cuda.empty_cache()
    check(pt.dataset.is_synthetic(), 'a dataset read a real file')
    for key, t in sorted(totals.items()):
        print('book regions, %s: %d regions, summed kernel %.4f ms, plain '
              '%.4f ms, cuDNN conv alone %.4f ms, bound %.4f ms; %s' % (
                  key, t['regions'], t['ms'], t['plain_ms'],
                  t['library_ms'], t['bound_ms'], card), flush=True)
    print('phase 13b: %.1f s' % (time.perf_counter() - t_phase), flush=True)
    return launches, totals


# ---- the sequence path ------------------------------------------------------------
def stacked_dynamic_lstm(pkg, dict_size=10000, emb_dim=512, hid_dim=512,
                         stacked_num=3, use_peepholes=True):
    """benchmark/fluid/models.py:70-104 line for line, with the LSTMs'
    use_peepholes as an argument. Returns (loss, prediction)."""
    layers = pkg.layers
    data = layers.data(name='data', shape=[1], dtype='int64', lod_level=1)
    label = layers.data(name='label', shape=[1], dtype='int64')
    emb = layers.embedding(input=data, size=[dict_size, emb_dim])
    fc1 = layers.fc(input=emb, size=hid_dim * 4)
    lstm1, _ = layers.dynamic_lstm(input=fc1, size=hid_dim * 4,
                                   use_peepholes=use_peepholes)
    inputs = [fc1, lstm1]
    for _ in range(2, stacked_num + 1):
        fc = layers.fc(input=inputs, size=hid_dim * 4)
        lstm, _ = layers.dynamic_lstm(input=fc, size=hid_dim * 4,
                                      use_peepholes=use_peepholes)
        inputs = [fc, lstm]
    fc_last = layers.sequence_pool(input=inputs[0], pool_type='max')
    lstm_last = layers.sequence_pool(input=inputs[1], pool_type='max')
    prediction = layers.fc(input=[fc_last, lstm_last], size=2, act='softmax')
    cost = layers.cross_entropy(input=prediction, label=label)
    return layers.mean(x=cost), prediction


def machine_translation(pkg, dict_size=8000, emb_dim=256, hid_dim=512):
    """benchmark/fluid/models.py:106-146 line for line. Returns the
    loss."""
    layers = pkg.layers
    src = layers.data(name='data', shape=[1], dtype='int64', lod_level=1)
    trg = layers.data(name='trg', shape=[1], dtype='int64', lod_level=1)
    label = layers.data(name='label', shape=[1], dtype='int64', lod_level=1)
    src_emb = layers.embedding(input=src, size=[dict_size, emb_dim])
    enc_fc = layers.fc(input=src_emb, size=hid_dim * 4)
    enc, _ = layers.dynamic_lstm(input=enc_fc, size=hid_dim * 4)
    enc_last = layers.sequence_pool(input=enc, pool_type='last')
    trg_emb = layers.embedding(input=trg, size=[dict_size, emb_dim])
    dec_fc = layers.fc(input=trg_emb, size=hid_dim * 4)
    dec, _ = layers.dynamic_lstm(input=dec_fc, size=hid_dim * 4)
    ctx = layers.sequence_expand(x=enc_last, y=dec)
    merged = layers.fc(input=[dec, ctx], size=hid_dim, act='tanh')
    predict = layers.fc(input=merged, size=dict_size, act='softmax')
    cost = layers.cross_entropy(input=predict, label=label)
    return layers.mean(x=cost)


def _lstm_program(seed, use_peepholes):
    import paddle_tpu_torch as pt
    main, startup = pt.Program(), pt.Program()
    startup.random_seed = seed
    with pt.unique_name.guard(), pt.program_guard(main, startup):
        loss, prediction = stacked_dynamic_lstm(
            pt, use_peepholes=use_peepholes, **LSTM)
        pt.optimizer.Momentum(learning_rate=0.01, momentum=0.9).minimize(
            loss)
    return main, startup, loss, prediction


def _lstm_feed(lens, seed):
    """Word ids and labels as the benchmark's feed_fn makes them (one
    SequenceTensor of packed rows and lengths; numpy, on the host)."""
    import paddle_tpu_torch as pt
    rng = np.random.RandomState(seed)
    rows = rng.randint(0, LSTM['dict_size'], (int(sum(lens)), 1))
    return {'data': pt.create_lod_tensor(rows.astype('int64'), [list(lens)]),
            'label': rng.randint(0, 2, (len(lens), 1)).astype('int64')}


def lstm_bound(B, H, dot):
    """The least time for one cell on the kernel's route: f32 as three
    TF32 products of 2*B*H*4H operations at the tensor cores' TF32 peak,
    bf16 as one at the bf16 peak; or xg and c_prev (f32), r_prev and w
    (dot), h (dot) and c (f32) moved once."""
    e = 2 if dot == 'bfloat16' else 4
    products, peak = (1, 'bfloat16') if dot == 'bfloat16' else (3, 'tf32')
    flops = products * 2 * B * H * 4 * H
    nbytes = 4 * (B * 4 * H + 2 * B * H) + e * (2 * B * H + 4 * H * H)
    t_ops, t_bytes = flops / PEAK_FLOPS[peak], nbytes / PEAK_BYTES
    return (max(t_ops, t_bytes) * 1e3,
            'operations' if t_ops >= t_bytes else 'bytes')


def _cell_ratio(got, ref):
    """The largest |err| / (rel * |plain| + abs * rms(plain)) per element,
    by the output's dtype."""
    rel, abs_ = LSTM_CELL_TOL[str(ref.dtype).replace('torch.', '')]
    ref = ref.float()
    bound = rel * ref.abs() + abs_ * ref.pow(2).mean().sqrt()
    return ((got.float() - ref).abs() / bound).max().item()


def _library_cell(xg, r, c, w):
    """torch.matmul and the gate math in plain PyTorch: the yardstick of
    one library product plus PyTorch's elementwise passes."""
    import torch
    gc, gi, gf, go = (xg + torch.matmul(r, w)).chunk(4, dim=-1)
    c_new = torch.tanh(gc) * torch.sigmoid(gi) + c * torch.sigmoid(gf)
    return torch.sigmoid(go) * torch.tanh(c_new), c_new


def _cell_zero_c(xg, r, c, w):
    """Control: the real kernel with c_prev zeroed."""
    import torch
    from paddle_tpu_torch.ops import cuda_kernels as ck
    return ck.fused_lstm_cell(xg, r, torch.zeros_like(c), w)


def _cell_swap_if(xg, r, c, w):
    """Control: the real kernel with xg's input and forget chunks
    swapped."""
    import torch
    from paddle_tpu_torch.ops import cuda_kernels as ck
    gc, gi, gf, go = xg.chunk(4, dim=-1)
    return ck.fused_lstm_cell(torch.cat([gc, gf, gi, go], dim=-1), r, c, w)


def _cell_f64(xg, r, c, w):
    """Witness: the plain cell in f64, rounded back."""
    from paddle_tpu_torch.ops import cuda_kernels as ck
    h, c_new = ck.lstm_cell_reference(xg.double(), r.double(), c.double(),
                                      w.double())
    return h.to(r.dtype), c_new.to(c.dtype)


LSTM_CONTROLS = (('c_prev zeroed', _cell_zero_c),
                 ('input and forget chunks swapped', _cell_swap_if))


def _product_probe(r, w):
    """Inputs that make the cell return its recurrent product: xg 0 in the
    candidate gate, +-100 in the others (input and output gates 1, forget
    gate 0, exactly, in f32), c_prev 0, and per gate q a weight holding
    gate q's slice of ``w`` (times LSTM_PROBE_SCALE) in the candidate
    gate's columns, zeros elsewhere. Then c = tanh(g) = g, the product in
    f32 as the cell sums it (tanh returns its argument at |g| < ~1e-4).
    Returns (xg, c_prev, [w_q], [the product in f64, [B, H]]), q = 0..3."""
    import torch
    B, H = r.shape[0], w.shape[0]
    xg = torch.zeros(B, 4 * H, device=w.device)
    xg[:, H:2 * H], xg[:, 2 * H:3 * H], xg[:, 3 * H:] = 100, -100, 100
    c0 = torch.zeros(B, H, device=w.device)
    ws, exact = [], []
    for q in range(4):
        wq = torch.zeros_like(w)
        wq[:, :H] = w[:, q * H:(q + 1) * H] * LSTM_PROBE_SCALE
        ws.append(wq)
        exact.append(r.double() @ wq[:, :H].double())
    return xg, c0, ws, exact


def _lstm_f64_witness(ops):
    """(kernel, plain f32) max |err| against the plain cell in f64, and the
    same for the product alone (:func:`_product_probe`): each the largest
    over h and c, or over the four gates' slices."""
    import torch
    from paddle_tpu_torch.ops import cuda_kernels as ck
    w_h, w_c = ck.lstm_cell_reference(*(t.double() for t in ops))

    def cell_err(pair):
        return max((a.double() - b).abs().max().item()
                   for a, b in zip(pair, (w_h, w_c)))
    xg, c0, ws, exact = _product_probe(ops[1], ops[3])
    prod = [0.0, 0.0]
    for wq, want in zip(ws, exact):
        for i, cell in enumerate((ck.fused_lstm_cell,
                                  ck.lstm_cell_reference)):
            g = cell(xg, ops[1], c0, wq)[1]
            prod[i] = max(prod[i], (g.double() - want).abs().max().item())
        # the probe reads the plain version's own product, bit for bit
        check(torch.equal(g, torch.matmul(ops[1], wq)[:, :wq.shape[0]]),
              'the saturated gates do not return the plain product')
    return (cell_err(ck.fused_lstm_cell(*ops)),
            cell_err(ck.lstm_cell_reference(*ops))), tuple(prod)


def phase_lstm_kernels(seed):
    """The LSTM cell kernel (csrc/lstm_cell.cu) against its plain version
    at LSTM_KERNEL_SHAPES, per element; two wrong inputs to the real
    kernel must fail the check; f32, on LSTM_WITNESS_DRAWS draws of the
    inputs: its error against the plain cell in f64, and its product's
    against the product in f64, at most LSTM_F64_WITNESS times the plain
    f32 version's; two calls give the same bits. Times kernel, plain
    version and a matmul with the gate math (a yardstick) as CUDA-graph
    replays, TF32 off. Every reading is printed before the checks."""
    import torch
    from paddle_tpu_torch.ops import cuda_kernels as ck
    gen = torch.Generator(device='cuda')
    gen.manual_seed(seed + 500)

    def inputs(B, H, dt):
        return (torch.randn(B, 4 * H, device='cuda', generator=gen),
                torch.tanh(torch.randn(B, H, device='cuda',
                                       generator=gen)).to(dt),
                torch.randn(B, H, device='cuda', generator=gen),
                (torch.randn(H, 4 * H, device='cuda', generator=gen) /
                 H ** 0.5).to(dt))

    results, checks = {}, []
    for B, H, dot in LSTM_KERNEL_SHAPES:
        dt = getattr(torch, dot)
        ops = inputs(B, H, dt)
        ref_h, ref_c = ck.lstm_cell_reference(*ops)
        before = ck.LAUNCHES['lstm_cell']
        h, c_out = ck.fused_lstm_cell(*ops)
        h2, c2 = ck.fused_lstm_cell(*ops)
        torch.cuda.synchronize()
        check(ck.LAUNCHES['lstm_cell'] == before + 2,
              'lstm_cell did not launch at B %d H %d' % (B, H))
        check(h.dtype == dt and c_out.dtype == torch.float32,
              'lstm_cell output dtypes %s %s' % (h.dtype, c_out.dtype))
        same = torch.equal(h, h2) and torch.equal(c_out, c2)
        ratio = max(_cell_ratio(h, ref_h), _cell_ratio(c_out, ref_c))
        err = max((h.float() - ref_h.float()).abs().max().item(),
                  (c_out - ref_c).abs().max().item())
        controls = []
        for _, fn in LSTM_CONTROLS:
            ch, cc = fn(*ops)
            controls.append(max(_cell_ratio(ch, ref_h),
                                _cell_ratio(cc, ref_c)))
        witness = ''
        if dot == 'float32':
            # against f64: the three TF32 products must not cost accuracy
            # that f32 sums keep, on these inputs and on fresh draws
            draws = [_lstm_f64_witness(ops)] + [
                _lstm_f64_witness(inputs(B, H, dt))
                for _ in range(LSTM_WITNESS_DRAWS - 1)]
            witness = '; against f64 (kernel / plain f32, %d draws): cell ' \
                '%s; product %s' % (len(draws), ', '.join(
                    '%.3g / %.3g' % c for c, _ in draws), ', '.join(
                    '%.3g / %.3g' % p for _, p in draws))
            for what, i in (('cell', 0), ('product', 1)):
                for d in draws:
                    checks.append((
                        d[i][0] <= LSTM_F64_WITNESS * d[i][1],
                        'lstm_cell at B %d H %d: its %s is %.3g from f64, '
                        "over %gx the plain f32 version's %.3g" % (
                            B, H, what, d[i][0], LSTM_F64_WITNESS,
                            d[i][1])))
        bound, bound_by = lstm_bound(B, H, dot)
        res = dict(max_abs_err=err,
                   ms=graph_ms(lambda: ck.fused_lstm_cell(*ops)),
                   plain_ms=graph_ms(lambda: ck.lstm_cell_reference(*ops)),
                   library_ms=graph_ms(lambda: _library_cell(*ops)),
                   bound_ms=bound, bound_by=bound_by)
        results[(B, H, dot)] = res
        print('lstm kernels: B %d H %d %s: max |err| %.3g, %.3f of the '
              'per-element limit %s%s; two calls %s; controls (c_prev '
              'zeroed, i/f swapped) %.1f and %.1f x the limit; kernel %.4f '
              'ms, plain %.4f ms, matmul + gate math %.4f ms, bound %.4f ms '
              '(%s, %s)' % (
                  B, H, dot, err, ratio, LSTM_CELL_TOL[str(h.dtype)[6:]],
                  witness, 'bit-identical' if same else 'DIFFER',
                  controls[0], controls[1], res['ms'], res['plain_ms'],
                  res['library_ms'], bound, bound_by,
                  'bf16' if dot == 'bfloat16' else '3 TF32 products'),
              flush=True)
        # the batch rows a block forced to each of the kernel's tiles (the
        # lstm_batch_tile knob), each against the plain version
        forced = {}
        for tile in LSTM_TILES:
            th, tc = ck._lstm_cell_kernel(*ops, batch_tile=tile)
            forced[tile] = max(_cell_ratio(th, ref_h), _cell_ratio(tc, ref_c))
            checks.append((forced[tile] <= 1, 'lstm_cell at batch tile %d '
                           'differs from its plain version at B %d H %d %s: '
                           '%.3g of the limit' % (tile, B, H, dot,
                                                  forced[tile])))
        print('lstm kernels: B %d H %d %s, forced batch tiles: %s of the '
              'per-element limit' % (B, H, dot, ', '.join(
                  '%d: %.3f' % kv for kv in sorted(forced.items()))),
              flush=True)
        checks.append((same, 'two lstm_cell calls differ at B %d H %d %s'
                       % (B, H, dot)))
        checks.append((ratio <= 1, 'lstm_cell differs from its plain version '
                       'at B %d H %d %s: %.3g of the limit' % (B, H, dot,
                                                               ratio)))
        for (name, _), ctl in zip(LSTM_CONTROLS, controls):
            checks.append((ctl > LSTM_CONTROL_MARGIN, 'the lstm_cell check '
                           'does not catch a control (%s) by %dx at B %d H '
                           '%d %s: %.3g' % (name, LSTM_CONTROL_MARGIN, B, H,
                                            dot, ctl)))
    # a batch tile the kernel has no instance for is refused at launch
    try:
        ck._lstm_cell_kernel(*inputs(8, 64, torch.float32), batch_tile=12)
        refused = None
    except RuntimeError as e:
        refused = str(e)
    print('lstm kernels: batch tile 12: %s' % refused, flush=True)
    checks.append((refused is not None and 'CUDA error 1 ' in refused,
                   'lstm_cell took batch tile 12: %s' % refused))
    for ok, msg in checks:
        check(ok, msg)
    return results


def _words_per_s(steps, batch, dt):
    return steps * batch * LSTM_WORDS / dt


def _train_steps(exe, main, loss, feed, scope, warmup, steps):
    """Warm-up steps, then timed steps with the loss kept on the card;
    returns (losses, seconds of the timed steps, launches during them)."""
    import torch
    from paddle_tpu_torch.ops import cuda_kernels as ck
    losses = [float(exe.run(main, feed=feed, fetch_list=[loss],
                            scope=scope)[0][0]) for _ in range(warmup)]
    torch.cuda.synchronize()
    ck.reset_launch_counts()
    outs = []
    t0 = time.perf_counter()
    for _ in range(steps):
        out, = exe.run(main, feed=feed, fetch_list=[loss], scope=scope,
                       return_numpy=False)
        outs.append(out)
    torch.cuda.synchronize()
    outs[-1] = outs[-1].item()                # the last loss to the host
    dt = time.perf_counter() - t0
    return losses + [float(o) for o in outs], dt, dict(ck.LAUNCHES)


def phase_lstm_training(seed, card):
    """Train stacked_dynamic_lstm at full width through Momentum.minimize
    and Executor.run on one fixed batch of 256 sequences of 80 words:
    with use_peepholes=False (the kernel path), then the benchmark's own
    configuration (peepholes, the plain scan)."""
    import torch
    import paddle_tpu_torch as pt
    main, startup, loss, prediction = _lstm_program(seed, False)
    exe = pt.Executor()                       # CUDAPlace(0)
    scope = pt.Scope()
    exe.run(startup, scope=scope)
    # staged on the card once (as bench.py stages its feed)
    feed = exe._prepare_feed(main, _lstm_feed([LSTM_WORDS] * LSTM_BATCH,
                                              seed + 21))
    check(tuple(feed['data'].data.shape) == (LSTM_BATCH, LSTM_T_PAD, 1),
          'sequence feed padded to %s' % (tuple(feed['data'].data.shape),))
    torch.cuda.reset_peak_memory_stats()
    losses, dt, launches = _train_steps(exe, main, loss, feed, scope,
                                        LSTM_WARMUP, LSTM_STEPS)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    ms = 1e3 * dt / LSTM_STEPS
    print('lstm training: stacked_dynamic_lstm (dict %d, emb %d, hid %d, %d '
          'layers, use_peepholes=False), batch %d x %d words (padded to %d), '
          'Momentum(0.01, 0.9), AMP: %d steps, %.2f ms per step, %.0f words/s '
          '(host clock, loss kept on the card), peak memory %.2f GiB; %s' % (
              LSTM['dict_size'], LSTM['emb_dim'], LSTM['hid_dim'],
              LSTM['stacked_num'], LSTM_BATCH, LSTM_WORDS, LSTM_T_PAD,
              LSTM_STEPS, ms, _words_per_s(LSTM_STEPS, LSTM_BATCH, dt), peak,
              card), flush=True)
    print('lstm training: losses %s; launches over the timed steps %s' % (
        ', '.join('%.4f' % l for l in losses), launches), flush=True)
    check(all(np.isfinite(losses)), 'non-finite LSTM training loss')
    check(losses[-1] < losses[0], 'the LSTM loss did not fall: %g -> %g'
          % (losses[0], losses[-1]))
    expect = {name: 0 for name in launches}
    expect['lstm_cell'] = LSTM_LAUNCHES * LSTM_STEPS
    check(launches == expect, 'LSTM training launches %s, expected %s'
          % (launches, expect))
    profile_run(lambda: exe.run(main, feed=feed, fetch_list=[loss],
                                scope=scope, return_numpy=False),
                'lstm training step')
    result = dict(launches=launches, ms=ms, peak_gib=peak, main=main,
                  scope=scope, prediction=prediction)

    # the benchmark's own configuration: peepholes, the plain scan
    p_main, p_startup, p_loss, _ = _lstm_program(seed, True)
    p_scope = pt.Scope()
    exe.run(p_startup, scope=p_scope)
    p_losses, p_dt, p_launches = _train_steps(exe, p_main, p_loss, feed,
                                              p_scope, 1, LSTM_PEEP_STEPS)
    print('lstm training: with peepholes (the benchmark\'s configuration, '
          'the plain scan): %d steps, %.2f ms per step, %.0f words/s, losses '
          '%s, launches %s' % (
              LSTM_PEEP_STEPS, 1e3 * p_dt / LSTM_PEEP_STEPS,
              _words_per_s(LSTM_PEEP_STEPS, LSTM_BATCH, p_dt),
              ', '.join('%.4f' % l for l in p_losses), p_launches),
          flush=True)
    check(all(np.isfinite(p_losses)), 'non-finite peephole LSTM loss')
    check(not any(p_launches.values()), 'the peephole LSTM launched %s'
          % p_launches)
    result['peep_ms'] = 1e3 * p_dt / LSTM_PEEP_STEPS
    del p_scope, feed
    torch.cuda.empty_cache()
    return result


def phase_lstm_gradients(seed):
    """The loss and every parameter gradient of one batch-8 step on
    ragged lengths (1-80 words), the kernel against the plain cell (the
    same backward, through rnn_ops.lstm_cell_for_testing), relative L2:
    with AMP off against a fixed limit, under AMP against a witness (the
    plain cell in f64, rounded); two wrong-kernel controls must fail
    both."""
    import torch
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.core import amp
    from paddle_tpu_torch.ops import cuda_kernels as ck
    from paddle_tpu_torch.ops import rnn_ops
    main, startup, loss, _ = _lstm_program(seed + 1, False)
    exe = pt.Executor()
    scope = pt.Scope()
    exe.run(startup, scope=scope)
    rng = np.random.RandomState(seed + 31)
    lens = [LSTM_WORDS] + [int(n) for n in rng.randint(
        1, LSTM_WORDS + 1, LSTM_GRAD_BATCH - 1)]
    feed = exe._prepare_feed(main, _lstm_feed(lens, seed + 32))
    grad_names = sorted(v.name for v in main.list_vars()
                        if v.name.endswith('@GRAD'))
    names = ['loss'] + grad_names
    snap = _snapshot(scope)

    def step(cell=None):
        _restore(scope, snap)
        with rnn_ops.lstm_cell_for_testing(cell) if cell else \
                contextlib.nullcontext():
            vals = exe.run(main, feed=feed, fetch_list=[loss] + grad_names,
                           scope=scope, return_numpy=False)
        torch.cuda.synchronize()
        return dict(zip(names, vals))

    def errors(got, ref):
        errs = _rel_l2(got, ref)
        worst = max(grad_names, key=errs.get)
        return errs['loss'], errs[worst], worst

    for precision in ('f32', 'bf16'):
        amp.set_amp(precision == 'bf16')
        try:
            ck.reset_launch_counts()
            kernel = step()
            check(ck.LAUNCHES['lstm_cell'] == LSTM_LAUNCHES,
                  'gradient step launches %s' % ck.LAUNCHES)
            plain = step(ck.lstm_cell_reference)
            found = {'kernel': errors(kernel, plain),
                     'witness': errors(step(_cell_f64), plain)}
            for name, fn in LSTM_CONTROLS:
                found[name] = errors(step(fn), plain)
        finally:
            amp.set_amp(None)
        limit = (LSTM_GRAD_F32, LSTM_GRAD_F32)
        if precision == 'bf16':
            limit = tuple(max(LSTM_GRAD_WITNESS * e, f) for e, f in zip(
                found['witness'][:2], limit))
        for name, e in found.items():
            print('lstm gradients: %s (AMP %s), batch %d, lengths %s, %s vs '
                  'the plain cell: loss %.3g, gradients max %.3g (%s); '
                  'limits %.3g, %.3g' % (
                      precision, 'on' if precision == 'bf16' else 'off',
                      LSTM_GRAD_BATCH, lens, name, e[0], e[1], e[2],
                      limit[0], limit[1]), flush=True)
        k = found['kernel']
        check(k[0] <= limit[0] and k[1] <= limit[1], 'LSTM loss or gradients '
              '(%s) differ from the plain cell\'s' % precision)
        for name, _ in LSTM_CONTROLS:
            e = found[name]
            check(e[0] > limit[0] or e[1] > limit[1], 'the %s gradient '
                  'limits do not catch a control: %s' % (precision, name))
    del scope, snap, kernel, plain
    torch.cuda.empty_cache()


def phase_lstm_serving(seed, trained, card):
    """Save the trained use_peepholes=False model with
    save_inference_model(['data'], [prediction]), load it into a fresh
    scope and serve batches of 1, 32 and 256 sequences of 80 words, then
    a ragged batch, numpy in and probabilities out: exactly 288 kernel
    launches a request; the probabilities and the pooled last hidden
    state against the plain cell's (limits relative to a witness, the
    plain cell in f64), and two controls that must fail."""
    import torch
    import paddle_tpu_torch as pt
    from paddle_tpu_torch import io as pt_io
    from paddle_tpu_torch.compiler import tuning
    from paddle_tpu_torch.ops import cuda_kernels as ck
    from paddle_tpu_torch.ops import rnn_ops
    exe = pt.Executor()
    os.makedirs(os.path.join(ROOT, 'build'), exist_ok=True)
    with tempfile.TemporaryDirectory(dir=os.path.join(ROOT, 'build')) as d:
        pt_io.save_inference_model(d, ['data'], [trained['prediction']], exe,
                                   main_program=trained['main'],
                                   scope=trained['scope'])
        scope = pt.Scope()
        prog, feed_names, fetch_vars = pt_io.load_inference_model(
            d, exe, scope=scope)
    check(feed_names == ['data'], 'feeds %s' % feed_names)
    rng = np.random.RandomState(seed + 41)
    ragged = [int(n) for n in rng.randint(1, LSTM_WORDS + 1, 31)] + \
        [LSTM_WORDS]
    requests = [[LSTM_WORDS] * b for b in LSTM_SERVE_BATCHES] + [ragged]

    def serve(lens, s):
        return exe.run(prog, feed={'data': _lstm_feed(lens, s)['data']},
                       fetch_list=fetch_vars, scope=scope)[0]

    for lens in requests:                     # warm-up: allocator
        serve(lens, seed + 100)
    times, seqs = [], 0
    for i, lens in enumerate(requests):
        torch.cuda.synchronize()
        ck.reset_launch_counts()
        t1 = time.perf_counter()
        out = serve(lens, seed + i)
        dt = time.perf_counter() - t1
        n = ck.LAUNCHES['lstm_cell']
        times.append(dt)
        seqs += len(lens)
        print('lstm request %d: batch %d (%s words), %.2f ms, %.1f '
              'sequences/s, %d lstm_cell launches' % (
                  i, len(lens), 'ragged %d-%d' % (min(lens), max(lens))
                  if len(set(lens)) > 1 else lens[0], 1e3 * dt,
                  len(lens) / dt, n), flush=True)
        check(out.shape == (len(lens), 2), 'probabilities shape %s'
              % (out.shape,))
        check(np.isfinite(out).all() and np.allclose(out.sum(1), 1.0,
                                                     atol=1e-3),
              'probabilities not finite or not summing to 1')
        check(n == LSTM_LAUNCHES and sum(ck.LAUNCHES.values()) == n,
              'request %d launches %s, expected %d lstm_cell' % (
                  i, ck.LAUNCHES, LSTM_LAUNCHES))
    print('lstm serving: %d requests, %.2f ms per request, %.1f sequences/s '
          '(host clock, numpy ids in, probabilities fetched to the host)' % (
              len(times), 1e3 * sum(times) / len(times), seqs / sum(times)),
          flush=True)
    # the probabilities, and the last LSTM's hidden state max-pooled over
    # the steps (the served output at random weights leans little on it)
    pooled = [op.output('Out')[0] for op in prog.global_block().ops
              if op.type == 'sequence_pool'][-1]
    probe = [LSTM_WORDS] * 32 + ragged

    def outputs(feed_seed, cell=None):
        with rnn_ops.lstm_cell_for_testing(cell) if cell else \
                contextlib.nullcontext():
            return exe.run(prog, feed={'data': _lstm_feed(probe, feed_seed)[
                'data']}, fetch_list=[v.name for v in fetch_vars] + [pooled],
                scope=scope)

    # each reading: the largest over LSTM_PROBES probes (the probabilities
    # and the pooled state: the largest diff; argmax: the least agreement)
    names = ('kernel', 'witness') + tuple(n for n, _ in LSTM_CONTROLS)
    cells = (None, _cell_f64) + tuple(fn for _, fn in LSTM_CONTROLS)
    per_probe = {name: [] for name in names}
    for i in range(LSTM_PROBES):
        plain_p, plain_s = outputs(seed + 7 + i, ck.lstm_cell_reference)
        for name, cell in zip(names, cells):
            p, st = outputs(seed + 7 + i, cell)
            per_probe[name].append((
                float(np.abs(p - plain_p).max()),
                float(np.abs(st - plain_s).max() / np.abs(plain_s).max()),
                float((p.argmax(-1) == plain_p.argmax(-1)).mean())))
    found = {name: (max(e[0] for e in r), max(e[1] for e in r),
                    min(e[2] for e in r)) for name, r in per_probe.items()}
    limits = tuple(max(LSTM_PROB_WITNESS * e, floor) for e, floor in zip(
        found['witness'][:2], LSTM_PROB_FLOOR))
    for name, e in found.items():
        print('lstm serving: %d probes of batch %d, %s vs the plain cell: '
              'probabilities max |diff| %.3g (limit %.3g; by probe %s), '
              'pooled last hidden state max |diff| / max |state| %.3g '
              '(limit %.3g), argmax agreement %.4f' % (
                  LSTM_PROBES, len(probe), name, e[0], limits[0],
                  ' '.join('%.3g' % r[0] for r in per_probe[name]), e[1],
                  limits[1], e[2]), flush=True)
    k = found['kernel']
    check(k[0] <= limits[0] and k[1] <= limits[1], 'served outputs differ '
          'from the plain cell\'s: %s' % (k,))
    for name, _ in LSTM_CONTROLS:
        e = found[name]
        check(e[0] > limits[0] or e[1] > limits[1], 'the serving limits do '
              'not catch a control: %s' % name)

    # the tuner over lstm_batch_tile at the served batches 32 and 256 (a
    # cache of its own), then every tile forced: within the limits above
    # of the plain cell, 288 launches a request, two calls bit-equal
    tuner = tuning.Autotuner(pt.CUDAPlace(0), cache=tuning.TuningCache(
        os.path.join(ROOT, 'build', 'phase15-tuning.json')), warmup=1,
        steps=TUNE_STEPS)
    for b in LSTM_TUNE_BATCHES:
        lens = [LSTM_WORDS] * b
        feed = {'data': _lstm_feed(lens, seed + 60)['data']}
        t1 = time.perf_counter()
        best, report = tuner.tune(prog, feed, fetch_vars, scope=scope,
                                  persist=False, name='lstm-b%d' % b)
        print('lstm serving: tuned over lstm_batch_tile at batch %d in %.1f '
              's: candidates (ms a request, %d each) %s; winner %s; %s' % (
                  b, time.perf_counter() - t1, TUNE_STEPS, _named_report(
                      report, tuner.candidates(prog, feed)),
                  best or 'baseline {}', card), flush=True)
        check(all(isinstance(v, float) for v in report.values()),
              'an lstm tile candidate failed: %s' % report)
        fetch = [v.name for v in fetch_vars] + [pooled]
        with rnn_ops.lstm_cell_for_testing(ck.lstm_cell_reference):
            plain_p, plain_s = exe.run(prog, feed=feed, fetch_list=fetch,
                                       scope=scope)
        for tile in (0,) + LSTM_TILES:
            with tuning.apply_entry({'lstm_batch_tile': tile}):
                ck.reset_launch_counts()
                p, st = exe.run(prog, feed=feed, fetch_list=fetch,
                                scope=scope)
                n = ck.LAUNCHES['lstm_cell']
                p2, st2 = exe.run(prog, feed=feed, fetch_list=fetch,
                                  scope=scope)
            e = (float(np.abs(p - plain_p).max()),
                 float(np.abs(st - plain_s).max() / np.abs(plain_s).max()))
            same = np.array_equal(p, p2) and np.array_equal(st, st2)
            print('lstm serving: batch %d, lstm_batch_tile %d%s: %d '
                  'launches; vs the plain cell: probabilities max |diff| '
                  '%.3g (limit %.3g), pooled state %.3g (limit %.3g); two '
                  'calls %s' % (b, tile, ' (the rule)' if not tile else '',
                                n, e[0], limits[0], e[1], limits[1],
                                'bit-identical' if same else 'DIFFER'),
                  flush=True)
            check(n == LSTM_LAUNCHES, 'batch %d tile %d: %d launches' % (
                b, tile, n))
            check(e[0] <= limits[0] and e[1] <= limits[1], 'batch %d tile '
                  '%d: outputs differ from the plain cell\'s: %s' % (
                      b, tile, e))
            check(same, 'batch %d tile %d: two calls differ' % (b, tile))
    del scope, prog
    torch.cuda.empty_cache()


def phase_machine_translation(seed, card):
    """machine_translation (peepholes: the plain scan, no cell launch) at
    batch 64, 24 words a side, for a few Momentum steps."""
    import torch
    import paddle_tpu_torch as pt
    main, startup = pt.Program(), pt.Program()
    startup.random_seed = seed
    with pt.unique_name.guard(), pt.program_guard(main, startup):
        loss = machine_translation(pt, **MT)
        pt.optimizer.Momentum(learning_rate=0.01, momentum=0.9).minimize(
            loss)
    exe = pt.Executor()
    scope = pt.Scope()
    exe.run(startup, scope=scope)
    rng = np.random.RandomState(seed + 51)
    lens = [[MT_LEN] * MT_BATCH]
    feed = exe._prepare_feed(main, {
        n: pt.create_lod_tensor(rng.randint(
            0, MT['dict_size'], (MT_BATCH * MT_LEN, 1)).astype('int64'), lens)
        for n in ('data', 'trg', 'label')})
    losses, dt, launches = _train_steps(exe, main, loss, feed, scope,
                                        MT_WARMUP, MT_STEPS)
    print('machine translation: dict %d, emb %d, hid %d, batch %d x %d '
          'words a side, Momentum(0.01, 0.9), AMP: %d steps, %.2f ms per '
          'step, %.0f target words/s, losses %s, launches %s; %s' % (
              MT['dict_size'], MT['emb_dim'], MT['hid_dim'], MT_BATCH,
              MT_LEN, MT_STEPS, 1e3 * dt / MT_STEPS,
              MT_STEPS * MT_BATCH * MT_LEN / dt,
              ', '.join('%.6f' % l for l in losses), launches, card),
          flush=True)
    check(all(np.isfinite(losses)), 'non-finite machine translation loss')
    check(not any(launches.values()), 'machine translation launched %s'
          % launches)
    del scope, feed
    torch.cuda.empty_cache()
    return 1e3 * dt / MT_STEPS


# ---- phase 14b: control flow, tensor arrays, beam search and book 08 ------------
CF_TOL = 1e-5              # float math, card against CPU, of its scale
CF_GRAD_TOL = 1e-4         # the control-flow nets' forward and @GRAD
CF_LENS = (3, 1, 5, 2)     # the ops' sequences (the next seed's differ)
MT_BOOK_STEPS = 20         # book 08's timed steps through the DataFeeder
MT_FIT_STEPS = 20          # its steps on one fixed batch
# the least fall of book 08's loss over MT_FIT_STEPS steps on one batch at
# the script's rate: a third of the first reading (1.5e-3, the port on
# the CPU; the loss starts at ln 30000 = 10.3087); rates 0 and minus the
# script's read 0 and -2.3e-3 there
MT_FIT_FALL = 5e-4
MT_CPU_TOL = 1e-4          # one step, card against CPU, of their scale
MT_DECODE_REPS = 5         # timed decodes
# two candidates' scores this close (of their scale) at a beam step
# make the selection ambiguous: only there may the card's selection
# part from the CPU's
MT_DECODE_TIE = 1e-5
MT_DECODE_SKEW = 1e-3      # the control: the card's scores times 1 + this
# the trained book's 30000-way softmax is nearly flat: its deciding
# scores lie as close as 1.6e-6 of their scale (the port on the CPU,
# random parameters), so the gate excuses ties there; the decode is held
# once more with the output fc's weight and bias times this, where they
# lie 1.3e-3 .. 0.29 apart (the same runs) and the gate's controls must
# fail
MT_SHARPEN = 1e4
MT_BIG = dict(batch=32, beam=4)   # the decode timed at this size too


def _cf_ops_program(seed):
    """One forward program of the slice's op kernels on seeded inputs:
    (main, startup, feed, exact fetch names, float fetch names, the
    names of few levels, which the next seed may repeat)."""
    import paddle_tpu_torch as pt
    L = pt.layers
    rng = np.random.RandomState(seed)
    lens = list(rng.permutation(CF_LENS))
    main, startup = pt.Program(), pt.Program()
    startup.random_seed = seed
    with pt.unique_name.guard(), pt.program_guard(main, startup):
        x = L.data(name='x', shape=[4], dtype='float32', lod_level=1)
        ids = L.data(name='ids', shape=[1], dtype='int64', lod_level=1)
        d = L.data(name='d', shape=[4], dtype='float32')
        m = L.data(name='m', shape=[1], dtype='bool')
        img = L.data(name='img', shape=[2, 5, 6], dtype='float32')
        off = L.data(name='off', shape=[1], dtype='int64')
        ln = L.data(name='ln', shape=[1], dtype='int64')
        pre = L.data(name='pre', shape=[1], dtype='int64')
        cand = L.data(name='cand', shape=[3], dtype='int64')
        sc = L.data(name='sc', shape=[3], dtype='float32')
        # a While summing squares into an array it reads back
        i = L.fill_constant(shape=[1], dtype='int64', value=0)
        n = L.fill_constant(shape=[1], dtype='int64', value=4)
        acc = L.scale(d, scale=1.0)
        arr = L.array_write(acc, i)
        cond = L.less_than(x=i, y=n)
        with L.While(cond=cond).block():
            prev = L.array_read(arr, i)
            L.assign(L.elementwise_add(acc, L.elementwise_mul(prev, d)),
                     acc)
            L.increment(x=i, value=1, in_place=True)
            L.array_write(L.scale(prev, scale=0.5), i, array=arr)
            L.less_than(x=i, y=n, cond=cond)
        table = L.lod_rank_table(x)
        back = L.array_to_lod_tensor(L.lod_tensor_to_array(x, table), table)
        t, f = L.split_lod_tensor(input=d, mask=m)
        merged = L.merge_lod_tensor(in_true=L.scale(t, scale=2.0),
                                    in_false=L.scale(f, scale=-3.0), x=d,
                                    mask=m)
        lr = L.create_global_var(shape=[1], value=0.0, dtype='float32',
                                 persistable=True, name='cf_lr')
        step = L.reduce_sum(L.cast(m, 'float32'))
        with L.Switch() as switch:
            with switch.case(L.less_than(step, L.fill_constant(
                    shape=[1], dtype='float32', value=2.0))):
                L.assign(L.fill_constant(shape=[1], dtype='float32',
                                         value=0.1), lr)
            with switch.default():
                L.assign(L.fill_constant(shape=[1], dtype='float32',
                                         value=0.01), lr)
        block = main.current_block()
        erased = block.create_var(name='erased', dtype='int64', lod_level=1)
        block.append_op(type='sequence_erase', inputs={'X': [ids]},
                        outputs={'Out': [erased]}, attrs={'tokens': [2, 5]})
        sliced = block.create_var(name='sliced', dtype='float32',
                                  lod_level=1)
        block.append_op(type='sequence_slice', inputs={
            'X': [x], 'Offset': [off], 'Length': [ln]},
            outputs={'Out': [sliced]})
        sel_ids, sel_sc = L.beam_search(pre, cand, sc, beam_size=2,
                                        end_id=9)
        printed = L.Print(d, message='phase 14b print', first_n=1)
        exact = [L.array_length(arr), L.array_read(arr, n),
                 L.max_sequence_len(table), back,
                 L.reorder_lod_tensor_by_rank(x, table),
                 L.shrink_memory(x, i, table), merged, L.is_empty(d), lr,
                 L.sequence_reshape(x, new_dim=2),
                 L.lod_reset(x, target_lod=[0, 2, 3, 7, 11]),
                 L.sequence_concat([x, x]), erased, sliced,
                 L.sequence_expand(x=d, y=x),
                 L.im2sequence(img, filter_size=[2, 3], stride=[1, 2],
                               padding=[1, 0, 0, 1]),
                 sel_ids, sel_sc, sel_ids.parent_idx, printed]
        near = [acc, L.sequence_conv(input=x, num_filters=3,
                                     filter_size=3),
                L.row_conv(x, future_context_size=2)]
    rows = rng.randn(sum(lens), 4).astype('float32')
    B = len(lens)
    feed = {'x': pt.create_lod_tensor(rows, [lens]),
            'ids': pt.create_lod_tensor(rng.randint(0, 7, (
                sum(lens), 1)).astype('int64'), [lens]),
            'd': rng.randn(B, 4).astype('float32'),
            'm': rng.rand(B, 1) < 0.5,
            'img': rng.randn(B, 2, 5, 6).astype('float32'),
            'off': np.array([[rng.randint(0, l)] for l in lens], 'int64'),
            'pre': rng.randint(0, 12, (2 * B, 1)).astype('int64'),
            'cand': rng.randint(0, 12, (2 * B, 3)).astype('int64'),
            'sc': rng.randn(2 * B, 3).astype('float32')}
    feed['ln'] = np.array([[l - o[0]] for l, o in zip(lens, feed['off'])],
                          'int64')
    feed['pre'][0] = 9                          # a finished beam
    # the array's length, the longest sequence, is_empty and the Switch
    coarse = [exact[k].name for k in (0, 2, 7, 8)]
    return main, startup, feed, [v.name for v in exact], \
        [v.name for v in near], coarse


def _cf_nets(seed):
    """The control-flow nets, each a program with one step of its
    optimizer (SGD, and Adagrad for the DynamicRNN): IfElse, Switch,
    StaticRNN, DynamicRNN. {name: (main, startup, feed, fetch names)}:
    the fetches are the net's outputs, the loss, every @GRAD and, after
    the Adagrad step, the updated parameter and its moment."""
    import paddle_tpu_torch as pt
    L = pt.layers
    rng = np.random.RandomState(seed)
    lens = list(rng.permutation(CF_LENS))
    nets = {}

    def program(name, build, feed, opt=None):
        main, startup = pt.Program(), pt.Program()
        startup.random_seed = seed
        with pt.unique_name.guard(), pt.program_guard(main, startup):
            outs, loss = build()
            (opt or pt.optimizer.SGD(0.0)).minimize(loss)
        grads = sorted(v.name for v in main.list_vars()
                       if v.name.endswith('@GRAD'))
        # after the Adagrad step: the parameters and their moments
        extra = [v.name for v in main.list_vars() if v.persistable and
                 ('_moment' in v.name or opt is not None and
                  v.name in main.global_block().vars and
                  type(v).__name__ == 'Parameter')]
        nets[name] = (main, startup, feed, [o.name for o in outs] +
                      [loss.name] + grads + extra)

    def ifelse():
        x = L.data(name='x', shape=[4], dtype='float32')
        h = L.fc(input=x, size=4)
        cond = L.less_than(x=L.fill_constant(shape=[1], dtype='float32',
                                             value=0.0),
                           y=L.reduce_sum(h, dim=1, keep_dim=True))
        ie = L.IfElse(cond)
        with ie.true_block():
            ie.output(L.fc(input=ie.input(h), size=3, act='tanh'))
        with ie.false_block():
            ie.output(L.fc(input=ie.input(h), size=3, act='sigmoid'))
        out = ie()[0]
        return [out], L.mean(out)

    def switch():
        x = L.data(name='x', shape=[4], dtype='float32')
        h = L.fc(input=x, size=4, act='tanh')
        s = L.reduce_sum(h)
        scale = L.create_global_var(shape=[1], value=1.0, dtype='float32',
                                    persistable=True, name='sw_scale')
        with L.Switch() as sw:
            with sw.case(L.less_than(s, L.fill_constant(
                    shape=[1], dtype='float32', value=0.0))):
                L.assign(L.scale(s, scale=2.0), scale)
            with sw.default():
                L.assign(L.scale(s, scale=-0.5), scale)
        out = L.elementwise_mul(h, scale)
        return [out, scale], L.mean(out)

    def static_rnn():
        x = L.data(name='xs', shape=[4, 3], dtype='float32')
        rnn = L.StaticRNN()
        with rnn.step():
            x_t = rnn.step_input(x)
            mem = rnn.memory(shape=[-1, 3], batch_ref=x, init_value=0.0)
            h = L.fc(input=[x_t, mem], size=3, act='tanh')
            rnn.update_memory(mem, h)
            rnn.step_output(h)
        out = rnn()
        return [out], L.mean(out)

    def dynamic_rnn():
        x = L.data(name='seq', shape=[4], dtype='float32', lod_level=1)
        drnn = L.DynamicRNN()
        with drnn.block():
            x_t = drnn.step_input(x)
            mem = drnn.memory(shape=[3], value=0.0)
            h = L.fc(input=[x_t, mem], size=3, act='tanh')
            drnn.update_memory(mem, h)
            drnn.output(h)
        last = L.sequence_pool(drnn(), pool_type='last')
        return [last], L.mean(last)

    B = len(lens)
    program('IfElse', ifelse, {'x': rng.randn(B, 4).astype('float32')})
    program('Switch', switch, {'x': rng.randn(B, 4).astype('float32')})
    program('StaticRNN', static_rnn,
            {'xs': rng.randn(5, B, 3).astype('float32')})
    program('DynamicRNN', dynamic_rnn, {'seq': pt.create_lod_tensor(
        rng.randn(sum(lens), 4).astype('float32'), [lens])},
        opt=pt.optimizer.Adagrad(learning_rate=0.1))
    return nets


def _host_values(v):
    """A fetch as a list of host arrays: a sequence's data (packed rows
    for a packed one) and its lengths."""
    import paddle_tpu_torch as pt
    v = pt.executor.as_numpy(v) if not isinstance(v, np.ndarray) else v
    if isinstance(v, pt.SequenceTensor):
        if v.packed_mode:
            return [np.asarray(v.data), np.asarray(sum(v.lod(), []))]
        return [np.asarray(v.data), np.asarray(v.lengths)]
    return [np.asarray(v)]


def _reading(got, ref, exact):
    """0 where equal; the largest difference over the reference's
    largest magnitude for floats; inf where the shapes or exact values
    differ. A list is taken as ``_host_values`` already."""
    r = 0.0
    host = [v if isinstance(v, list) else _host_values(v)
            for v in (got, ref)]
    for g, w in zip(*host):
        if g.shape != w.shape:
            return float('inf')
        if exact or g.dtype.kind != 'f':
            if not np.array_equal(g, w):
                return float('inf')
            continue
        if g.size:
            r = max(r, float(np.abs(g.astype('float64') - w).max() /
                             max(np.abs(w).max(), 1e-30)))
    return r


def _run_on(place, main, startup, feed, fetch, state=None):
    """Run ``main`` on ``place`` in a fresh scope: the startup program,
    then ``state`` (numpy arrays by name) over it. Returns (fetches, the
    scope)."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch import io as pt_io
    exe, scope = pt.Executor(place), pt.Scope()
    exe.run(startup, scope=scope)
    if state:
        pt_io.params_from_numpy(scope, state, place)
    return exe.run(main, feed=feed, fetch_list=fetch, scope=scope,
                   return_numpy=False), scope


def _startup_state(startup):
    """The startup program's values, made once on the CPU, so the card
    and the CPU start from the same parameters (their generators
    differ)."""
    import paddle_tpu_torch as pt
    scope = pt.Scope()
    pt.Executor(pt.CPUPlace()).run(startup, scope=scope)
    return _book_state(scope)


class _DeviceWatch(object):
    """Every op kernel wrapped while it is active: after each op, every
    tensor the op wrote (SequenceTensor data, tensor-array elements
    included) must lie on the card. Counts ops and values checked."""

    def __init__(self):
        self.ops = self.values = 0
        self.off_card = []

    def _walk(self, val):
        import torch
        import paddle_tpu_torch as pt
        if isinstance(val, torch.Tensor):
            yield val
        elif isinstance(val, pt.SequenceTensor):
            for t in (val.data, val.lengths, val.sub_lengths):
                if t is not None:
                    yield t
        elif isinstance(val, dict):
            for e in val.get('list', ()) if 'list' in val else \
                    val.values():
                if e is not None:
                    yield from self._walk(e)

    def __enter__(self):
        from paddle_tpu_torch.core import lowering
        self._orig = lowering.get_kernel

        def get_kernel(op_type):
            kernel = self._orig(op_type)

            def watched(ctx):
                kernel(ctx)
                self.ops += 1
                for n in ctx.op.output_arg_names:
                    for t in self._walk(ctx.env.get(n)):
                        self.values += 1
                        if t.device.type != 'cuda':
                            self.off_card.append((op_type, n))
            return watched
        lowering.get_kernel = get_kernel
        return self

    def __exit__(self, *exc):
        from paddle_tpu_torch.core import lowering
        lowering.get_kernel = self._orig


def _beam_gap(ctx):
    """The smallest gap between two distinct candidate scores that
    decide this beam_search step on its inputs, over their scale: in
    the dynamic form the K-th and (K+1)-th of a source (the beams are
    re-sorted by row and id after), in the static form every place of
    the K taken (a beam's slot) and the K-th against the next; equal
    scores (a shared prefix's copies) are ordered alike on both
    devices and skipped. inf where nothing is decided."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.ops.common import unwrap
    K, end_id = int(ctx.attr('beam_size')), int(ctx.attr('end_id'))
    pre = ctx.input('pre_ids')
    sc = unwrap(ctx.input('scores')).detach().cpu().double().numpy()
    sc = sc.reshape(sc.shape[0], -1)
    groups = []
    if isinstance(pre, pt.SequenceTensor) and pre.packed_mode and \
            len(pre.offsets()) >= 2:
        offs = pre.offsets()
        high = [int(o) for o in offs[int(ctx.attr('level', 0))]]
        for lv in range(int(ctx.attr('level', 0)) + 1, len(offs)):
            high = [int(offs[lv][i]) for i in high]
        for a, b in zip(high[:-1], high[1:]):
            groups.append((np.sort(sc[a:b].ravel())[::-1], [K - 1]))
    else:
        ended = unwrap(pre).reshape(-1).cpu().numpy() == end_id
        rows = [sc[r, :1] if ended[r] else sc[r] for r in range(len(sc))]
        for b in range(len(rows) // K):
            groups.append((np.sort(np.concatenate(
                rows[b * K:(b + 1) * K]))[::-1], range(K)))
    gap = float('inf')
    for v, places in groups:
        for i in places:
            if i + 1 < len(v) and v[i] != v[i + 1]:
                gap = min(gap, (v[i] - v[i + 1]) / max(
                    abs(v[i]), abs(v[i + 1]), 1e-30))
    return gap


class _BeamTrace(object):
    """Every beam_search op of a run while it is active: what it
    selected (ids, parents and LoD, on the host) and its deciding gap
    (``_beam_gap``), in the order the steps ran."""

    def __init__(self):
        self.steps, self.gaps = [], []

    def __enter__(self):
        import paddle_tpu_torch as pt
        from paddle_tpu_torch.core import lowering
        self._orig = lowering.get_kernel

        def get_kernel(op_type):
            kernel = self._orig(op_type)
            if op_type != 'beam_search':
                return kernel

            def traced(ctx):
                gap = _beam_gap(ctx)
                kernel(ctx)
                sel = []
                for slot in ('selected_ids', 'parent_idx'):
                    for n in ctx.op.outputs.get(slot, ()):
                        v = ctx.env[n]
                        sel.append(pt.executor.as_numpy(v).tobytes()
                                   if not isinstance(v, pt.SequenceTensor)
                                   else (np.asarray(pt.executor.as_numpy(
                                       v).data).tobytes(), str(v.lod())))
                self.steps.append(tuple(sel))
                self.gaps.append(gap)
            return traced
        lowering.get_kernel = get_kernel
        return self

    def __exit__(self, *exc):
        from paddle_tpu_torch.core import lowering
        lowering.get_kernel = self._orig


def _decode_gate(got, ref, trace, ref_trace):
    """The card's decode (``got``: host ids and scores, ``trace``)
    against a reference run: where every step selected what the
    reference's did, ids and LoD must be equal and the scores within
    MT_DECODE_TIE of their scale; where the selections part, the
    reference's deciding scores at that step must lie within
    MT_DECODE_TIE (a tie neither device can be held to). (ok, text)."""
    n = min(len(trace.steps), len(ref_trace.steps))
    part = next((t for t in range(n)
                 if trace.steps[t] != ref_trace.steps[t]), None)
    if part is None and len(trace.steps) != len(ref_trace.steps):
        part = n
    if part is None:
        same = _reading(got[0], ref[0], True) == 0.0
        err = _reading(got[1], ref[1], False)
        return same and err <= MT_DECODE_TIE, (
            'every step selected alike (%d), ids and LoD %s, scores within '
            '%.3g' % (n, 'equal' if same else 'DIFFERENT', err))
    gap = ref_trace.gaps[part] if part < len(ref_trace.gaps) else \
        float('inf')
    return gap <= MT_DECODE_TIE, (
        'the selections part at step %d, where the reference\'s deciding '
        'scores lie %.3g apart' % (part, gap))


def _skewed(host):
    """Host scores times 1 + MT_DECODE_SKEW (the gate's control)."""
    return [host[0] * (1.0 + MT_DECODE_SKEW)] + host[1:]


def _gate_with_controls(label, got, ref, ctl, trace, ref_trace,
                        ctl_trace, controls=True):
    """``_decode_gate`` on the card's decode, then on two controls: the
    card's scores skewed by MT_DECODE_SKEW, and the reference run of
    other sources against the card's. With ``controls`` both must fail
    the gate; without (parameters whose candidates tie), the skew must
    fail where the card selected what the CPU did at every step, and
    the other sources' reading is printed only. Prints the reference's
    closest deciding gap and its steps within the limit."""
    ok, text = _decode_gate(got, ref, trace, ref_trace)
    skew_ok, skew_text = _decode_gate([got[0], _skewed(got[1])], ref,
                                      trace, ref_trace)
    ctl_ok, ctl_text = _decode_gate(ctl, ref, ctl_trace, ref_trace)
    close = sum(g <= MT_DECODE_TIE for g in ref_trace.gaps)
    print('%s: card against the CPU: %s (limit %g); the CPU\'s closest '
          'deciding scores %.3g apart over %d steps, %d within the limit; '
          'controls%s: scores times 1 + %g: %s; other sources: %s'
          % (label, text, MT_DECODE_TIE, min(ref_trace.gaps or [np.inf]),
             len(ref_trace.gaps), close,
             ' (must fail)' if controls else '', MT_DECODE_SKEW, skew_text,
             ctl_text), flush=True)
    check(ok, '%s: the card\'s decode differs from the CPU\'s: %s'
          % (label, text))
    if controls or trace.steps == ref_trace.steps:
        check(not skew_ok, '%s: the gate passes scores skewed by %g'
              % (label, MT_DECODE_SKEW))
    if controls:
        check(not ctl_ok, '%s: the gate passes the decode of other '
              'sources' % label)


def _cf_ops(seed, card):
    """(a) The ops on the card against the CPU, then the nets' forward
    and every @GRAD; each against the next seed's inputs, which must
    fail."""
    import torch
    import paddle_tpu_torch as pt
    main, startup, feed, exact, near, coarse = _cf_ops_program(seed)
    other = _cf_ops_program(seed + 1)[2]
    fetch = exact + near
    state = _startup_state(startup)
    with _DeviceWatch() as watch:
        card_out, _ = _run_on(pt.CUDAPlace(0), main, startup, feed, fetch,
                              state)
    cpu_out, _ = _run_on(pt.CPUPlace(), main, startup, feed, fetch, state)
    ctl_out, _ = _run_on(pt.CPUPlace(), main, startup, other, fetch, state)
    worst = {'exact': 0.0, 'float': 0.0}
    for n, g, r, c in zip(fetch, card_out, cpu_out, ctl_out):
        is_exact = n in exact
        limit = 0.0 if is_exact else CF_TOL
        reading = _reading(g, r, is_exact)
        worst['exact' if is_exact else 'float'] = max(
            worst['exact' if is_exact else 'float'], reading)
        check(reading <= limit, 'op %s on the card: %g from the CPU (limit '
              '%g)' % (n, reading, limit))
        check(n in coarse or _reading(g, c, is_exact) > limit, 'op %s: the '
              'next seed\'s inputs read inside the limit' % n)
    check(not watch.off_card, 'values off the card: %s' % watch.off_card)
    print('control-flow ops: %d fetches (%d exact, %d float) of While, the '
          'tensor arrays, the rank table, split/merge, Switch, is_empty, '
          'print, the sequence ops and the static beam_search, card against '
          'CPU: worst exact %g, float %.3g (limits: exact, %g); the next '
          'seed\'s inputs fail every fetch but %d of few levels; %d ops, %d '
          'values on the card, none off it; %s' % (
              len(fetch), len(exact), len(near), worst['exact'],
              worst['float'], CF_TOL, len(coarse), watch.ops, watch.values,
              card), flush=True)
    nets = _cf_nets(seed)
    others = _cf_nets(seed + 1)
    for name, (main, startup, feed, fetch) in sorted(nets.items()):
        state = _startup_state(startup)
        card_out, _ = _run_on(pt.CUDAPlace(0), main, startup, feed, fetch,
                              state)
        cpu_out, _ = _run_on(pt.CPUPlace(), main, startup, feed, fetch,
                             state)
        ctl_out, _ = _run_on(pt.CPUPlace(), main, startup,
                             others[name][2], fetch, state)
        readings = [_reading(g, r, False) for g, r in zip(card_out, cpu_out)]
        controls = [_reading(g, c, False) for g, c in zip(card_out, ctl_out)]
        print('control-flow net %s: forward, loss and %d @GRAD%s, card '
              'against CPU: worst %.3g (limit %g); the next seed\'s inputs '
              'read %.3g .. %.3g' % (
                  name, sum(n.endswith('@GRAD') for n in fetch),
                  ' and the Adagrad update' if name == 'DynamicRNN' else '',
                  max(readings), CF_GRAD_TOL, min(controls), max(controls)),
              flush=True)
        check(max(readings) <= CF_GRAD_TOL, '%s: card %g from the CPU' % (
            name, max(readings)))
        check(max(controls) > CF_GRAD_TOL, '%s: the next seed\'s inputs '
              'pass the limit' % name)
    torch.cuda.empty_cache()


CF_DECODE = dict(dict_size=30, word_dim=8, hidden_dim=16, topk_size=10)


def _cf_decodes(seed, card):
    """Both beam searches and both beam_search_decodes in book 08's small
    decode programs (CF_DECODE's widths, parameters from a CPU startup):
    held against the CPU by ``_gate_with_controls``, whose controls
    (skewed scores, the next seed's sources) must fail."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.models import books
    for dynamic in (True, False):
        main, startup = pt.Program(), pt.Program()
        startup.random_seed = seed
        with pt.unique_name.guard(), pt.program_guard(main, startup):
            _, ids, scores = (books.decode_dynamic if dynamic
                              else books.decode_static)(**CF_DECODE)
        state = _startup_state(startup)

        def feed(s):
            rng = np.random.RandomState(s)
            lens = [int(n) for n in rng.randint(2, 7, 3)]
            f = books.decode_init_feed(3) if dynamic else {}
            f['src_word_id'] = pt.create_lod_tensor(rng.randint(
                2, CF_DECODE['dict_size'], (sum(lens), 1)).astype('int64'),
                [lens])
            return f
        outs, traces = {}, {}
        for key, place, s in (('card', pt.CUDAPlace(0), seed),
                              ('cpu', pt.CPUPlace(), seed),
                              ('control', pt.CPUPlace(), seed + 1)):
            with _BeamTrace() as traces[key]:
                outs[key] = [_host_values(v) for v in _run_on(
                    place, main, startup, feed(s), [ids, scores],
                    state)[0]]
        _gate_with_controls(
            'control-flow %s beam search and decode (dict %d)' % (
                'dynamic' if dynamic else 'static',
                CF_DECODE['dict_size']), outs['card'], outs['cpu'],
            outs['control'], traces['card'], traces['cpu'],
            traces['control'])


def _mt_program(seed, learning_rate=None, **widths):
    """Book 08's training program at the script's widths (another
    learning rate if given)."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.models import books
    main, startup = pt.Program(), pt.Program()
    startup.random_seed = seed
    with pt.unique_name.guard(), pt.program_guard(main, startup):
        book = books.machine_translation(**widths)
        opt = book.optimizer()
        if learning_rate is not None:
            opt = pt.optimizer.Adagrad(learning_rate=learning_rate,
                                       regularization=opt.regularization)
        opt.minimize(book.loss)
    return main, startup, book


def _mt_fit(seed, batch, learning_rate=None):
    """MT_FIT_STEPS steps on one batch on the card: the losses."""
    import paddle_tpu_torch as pt
    main, startup, book = _mt_program(seed, learning_rate)
    exe, scope = pt.Executor(), pt.Scope()
    exe.run(startup, scope=scope)
    feed = pt.DataFeeder(feed_list=book.feeds, place=pt.CUDAPlace(0),
                         program=main).feed(batch)
    return [float(exe.run(main, feed=feed, fetch_list=[book.loss],
                          scope=scope)[0][0]) for _ in range(MT_FIT_STEPS)]


def _mt_train(seed, card):
    """(b) Book 08 trained on the card through DataFeeder and the wmt14
    reader: timed steps, peak memory, the fixed-batch fall and its
    controls, one step against the CPU. Returns the trained run."""
    import torch
    import paddle_tpu_torch as pt
    from paddle_tpu_torch import io as pt_io
    from paddle_tpu_torch.models import books
    main, startup, book = _mt_program(seed)
    exe, scope = pt.Executor(), pt.Scope()
    exe.run(startup, scope=scope)
    initial = _book_state(scope)
    feeder = pt.DataFeeder(feed_list=book.feeds, place=pt.CUDAPlace(0),
                           program=main)
    batches = _book_batches(book, seed + 1)
    first = next(batches)
    exe.run(main, feed=feeder.feed(first), fetch_list=[book.loss],
            scope=scope)                       # warm-up: not counted
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses, words = [], 0
    t0 = time.perf_counter()
    for _ in range(MT_BOOK_STEPS):
        b = next(batches)
        words += sum(len(s[1]) for s in b)
        out = exe.run(main, feed=feeder.feed(b), fetch_list=[book.loss],
                      scope=scope)
        losses.append(float(out[0][0]))
    dt = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2 ** 20
    feed = feeder.feed(next(batches))
    _, busy_us = profile_run(lambda: exe.run(
        main, feed=feed, fetch_list=[book.loss], scope=scope),
        'book 08 step', top=4)
    print('book 08 training: dict %d, word %d, hidden %d, batch %d, f32 '
          '(TF32 off), Adagrad(1e-4) with L2Decay(0.1), through DataFeeder '
          'and batch(wmt14.train(%d)): %d steps, %.2f ms a step, %.0f '
          'target words/s (host clock), one profiled step busy on the card '
          '%.3f ms, peak memory %.1f MiB; losses %.4f .. %.4f; %s' % (
              books.MT['dict_size'], books.MT['word_dim'],
              books.MT['hidden_dim'], book.batch_size,
              books.MT['dict_size'], MT_BOOK_STEPS, 1e3 * dt / MT_BOOK_STEPS,
              words / dt, busy_us / 1e3, peak, losses[0], losses[-1], card),
          flush=True)
    check(all(np.isfinite(losses)), 'non-finite book 08 loss')
    falls = {}
    for label, rate in (('script', None), ('rate 0', 0.0),
                        ('minus the rate', -1e-4)):
        fit = _mt_fit(seed, first, rate)
        check(all(np.isfinite(fit)), 'non-finite book 08 loss (%s)' % label)
        falls[label] = fit[0] - fit[-1]
    print('book 08 on one batch, %d steps: the loss falls %.3g at the '
          'script\'s rate (limit %g); controls (must fail): rate 0 %.3g, '
          'minus the rate %.3g' % (MT_FIT_STEPS, falls['script'], MT_FIT_FALL,
                                   falls['rate 0'], falls['minus the rate']),
          flush=True)
    check(falls['script'] >= MT_FIT_FALL, 'book 08 loss fell only %g'
          % falls['script'])
    for label in ('rate 0', 'minus the rate'):
        check(falls[label] < MT_FIT_FALL, 'the book 08 limit does not catch '
              'training at %s' % label)
    # one step against the CPU: loss and every @GRAD
    grads = sorted(v.name for v in main.list_vars()
                   if v.name.endswith('@GRAD'))
    fetch = [book.loss.name] + grads
    state = _book_state(scope)
    feed = feeder.feed(next(batches))
    card_out = exe.run(main, feed=feed, fetch_list=fetch, scope=scope)

    def cpu(arrays):
        s = pt.Scope()
        pt_io.params_from_numpy(s, arrays, pt.CPUPlace())
        return pt.Executor(pt.CPUPlace()).run(main, feed=feed,
                                              fetch_list=fetch, scope=s)
    same = [_reading(c, r, False) for c, r in zip(card_out, cpu(state))]
    before = [_reading(c, r, False) for c, r in zip(card_out,
                                                    cpu(initial))]
    print('book 08: one step, card against CPU: loss and %d @GRAD within '
          '%.3g of their scale (limit %g); control, the parameters before '
          'training: %.3g' % (len(grads), max(same), MT_CPU_TOL,
                              max(before)), flush=True)
    check(max(same) <= MT_CPU_TOL, 'book 08 step: card %g from the CPU'
          % max(same))
    check(max(before) > MT_CPU_TOL, 'the book 08 CPU limit does not catch '
          'the parameters before training')
    return dict(exe=exe, scope=scope, main=main, book=book, batches=batches,
                ms=1e3 * dt / MT_BOOK_STEPS, peak_mib=peak)


def _mt_src(batch):
    import paddle_tpu_torch as pt
    rows = [w for s in batch for w in s[0]]
    return pt.create_lod_tensor(np.asarray(rows, 'int64').reshape(-1, 1),
                                [[len(s[0]) for s in batch]])


def _mt_decode(seed, card, run, art_dir, dynamic):
    """(c, d) A decode of the trained parameters on the card against the
    port's CPU run of the same program, by ``_gate_with_controls`` (its
    controls: skewed scores and the next batch's sources). The dynamic
    decode runs from a saved and loaded inference model, and once more
    at MT_BIG's size, timed only."""
    import torch
    import paddle_tpu_torch as pt
    from paddle_tpu_torch import io as pt_io
    from paddle_tpu_torch.models import books
    from paddle_tpu_torch.ops import common as ops_common
    from paddle_tpu_torch.ops import control_flow_ops as cf
    label = 'dynamic' if dynamic else 'static'
    bs = run['book'].batch_size

    def build(beam=None):
        main, startup = pt.Program(), pt.Program()
        with pt.unique_name.guard(), pt.program_guard(main, startup):
            build_fn = books.decode_dynamic if dynamic else books.decode_static
            feeds, ids, scores = build_fn(beam_size=beam)
        return main, feeds, ids, scores

    main, feeds, ids, scores = build()
    exe, scope = run['exe'], run['scope']
    if dynamic:
        d = os.path.join(art_dir, 'book08_decode')
        pt_io.save_inference_model(d, [v.name for v in feeds],
                                   [ids, scores], exe, main_program=main,
                                   scope=scope)
        scope = pt.Scope()
        main, _, fetch = pt_io.load_inference_model(d, exe, scope=scope)
        check(len(main.blocks) == 2 and pt.executor.is_dynamic(main),
              'the loaded decode lost its While')
    else:
        fetch = [ids, scores]
    state = _book_state(scope)

    def feed_for(batch):
        f = books.decode_init_feed(len(batch)) if dynamic else {}
        f['src_word_id'] = _mt_src(batch)
        return f
    batch, other = next(run['batches']), next(run['batches'])
    exe.run(main, feed=feed_for(batch), fetch_list=fetch, scope=scope,
            return_numpy=False)                # warm-up
    torch.cuda.synchronize()
    syncs, iters = ops_common.HOST_SYNCS[0], cf.WHILE_ITERS[0]
    t0 = time.perf_counter()
    for _ in range(MT_DECODE_REPS):
        exe.run(main, feed=feed_for(batch), fetch_list=fetch, scope=scope,
                return_numpy=False)
    torch.cuda.synchronize()
    ms = 1e3 * (time.perf_counter() - t0) / MT_DECODE_REPS
    steps = (cf.WHILE_ITERS[0] - iters) / MT_DECODE_REPS
    per_step = (ops_common.HOST_SYNCS[0] - syncs) / MT_DECODE_REPS / steps
    with _DeviceWatch() as watch, _BeamTrace() as trace:
        got = [_host_values(v) for v in exe.run(
            main, feed=feed_for(batch), fetch_list=fetch, scope=scope,
            return_numpy=False)]
    check(not watch.off_card, 'book 08 %s decode: values off the card: %s'
          % (label, watch.off_card[:5]))

    def traced(on_card, params, b):
        s = pt.Scope()
        pt_io.params_from_numpy(
            s, params, pt.CUDAPlace(0) if on_card else pt.CPUPlace())
        with _BeamTrace() as tr:
            out = (exe if on_card else pt.Executor(pt.CPUPlace())).run(
                main, feed=feed_for(b), fetch_list=fetch, scope=s,
                return_numpy=False)
        return [_host_values(v) for v in out], tr
    cpu = functools.partial(traced, False)
    (ref, ref_trace), (ctl, ctl_trace) = cpu(state, batch), \
        cpu(state, other)
    print('book 08 %s decode (%s): batch %d, beam %d, topk %d, max length '
          '%d: %.2f ms a decode, %d decode steps, %.2f host syncs a step; '
          '%d ops, %d values on the card, none off it; %s'
          % (label, 'saved and loaded' if dynamic else 'direct', bs,
             books.MT['beam_size'], books.MT['topk_size'],
             books.MT['max_length'], ms, steps, per_step, watch.ops,
             watch.values, card), flush=True)
    _gate_with_controls('book 08 %s decode, trained parameters' % label,
                        got, ref, ctl, trace, ref_trace, ctl_trace,
                        controls=False)
    # the output fc sharpened: the candidates part, the controls must fail
    sharp = {k: v * MT_SHARPEN if k != 'vemb' and np.ndim(v) and
             v.shape[-1] == books.MT['dict_size'] else v
             for k, v in state.items()}
    got, trace = traced(True, sharp, batch)
    (ref, ref_trace), (ctl, ctl_trace) = cpu(sharp, batch), \
        cpu(sharp, other)
    _gate_with_controls('book 08 %s decode, output fc times %g'
                        % (label, MT_SHARPEN), got, ref, ctl, trace,
                        ref_trace, ctl_trace)
    # the static decode stops early once every beam has ended
    check(steps == books.MT['max_length'] or not dynamic and
          0 < steps <= books.MT['max_length'], 'book 08 %s decode ran %g '
          'steps' % (label, steps))
    res = dict(ms=ms, steps=steps, syncs=per_step)
    if dynamic:
        # MT_BIG: batch 32 at beam 4, timed only
        big, _, big_ids, big_scores = build(MT_BIG['beam'])
        src = [next(run['batches']) for _ in range(
            MT_BIG['batch'] // bs)]
        big_batch = [s for b in src for s in b]
        f = feed_for(big_batch)
        exe.run(big, feed=f, fetch_list=[big_ids, big_scores],
                scope=run['scope'], return_numpy=False)
        torch.cuda.synchronize()
        syncs, iters = ops_common.HOST_SYNCS[0], cf.WHILE_ITERS[0]
        t0 = time.perf_counter()
        for _ in range(MT_DECODE_REPS):
            exe.run(big, feed=feed_for(big_batch),
                    fetch_list=[big_ids, big_scores], scope=run['scope'],
                    return_numpy=False)
        torch.cuda.synchronize()
        res['big_ms'] = 1e3 * (time.perf_counter() - t0) / MT_DECODE_REPS
        big_steps = (cf.WHILE_ITERS[0] - iters) / MT_DECODE_REPS
        res['big_syncs'] = (ops_common.HOST_SYNCS[0] - syncs) / \
            MT_DECODE_REPS / big_steps
        print('book 08 dynamic decode, batch %d, beam %d (timed only): %.2f '
              'ms a decode, %d steps, %.2f host syncs a step; %s' % (
                  MT_BIG['batch'], MT_BIG['beam'], res['big_ms'], big_steps,
                  res['big_syncs'], card), flush=True)
    return res


def phase_control_flow(seed, card, art_dir):
    """14b. Control flow, tensor arrays and beam search: (a) every new op
    kernel on the card against the CPU (exact for integers, bools and
    data movement, CF_TOL for float math; IfElse, Switch, StaticRNN and
    DynamicRNN forward and every @GRAD within CF_GRAD_TOL), the next
    seed's inputs failing; (b) book 08 trained at the script's widths
    through the DataFeeder and the wmt14 reader, one step against the
    CPU; (c) its dynamic decode from a saved and loaded inference model,
    against the CPU; (d) its static [B*K] decode against the CPU; (e) no
    value of a decode off the card. TF32 off, AMP off throughout."""
    import tempfile
    import torch
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.core import amp
    t_phase = time.perf_counter()
    os.environ['PADDLE_TPU_TORCH_DATA_HOME'] = tempfile.mkdtemp(dir=art_dir)
    tf32 = torch.backends.cuda.matmul.allow_tf32, \
        torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    amp.set_amp(False)
    try:
        _cf_ops(seed, card)
        _cf_decodes(seed, card)
        run = _mt_train(seed, card)
        dyn = _mt_decode(seed, card, run, art_dir, dynamic=True)
        _mt_decode(seed, card, run, art_dir, dynamic=False)
    finally:
        amp.set_amp(None)
        torch.backends.cuda.matmul.allow_tf32, \
            torch.backends.cudnn.allow_tf32 = tf32
    check(pt.dataset.is_synthetic(), 'a dataset read a real file')
    del run
    torch.cuda.empty_cache()
    print('phase 14b: %.1f s' % (time.perf_counter() - t_phase), flush=True)
    return dyn


# phase 15a: the fleet. FLEET_* are its Router's replicas and ring width,
# its clients and rounds of 6b's mix, and each replica's admission limit
# (a queue that never fills under the mix or the ramp, and that the shed
# storm fills at once)
FLEET_REPLICAS = 3
FLEET_REPLICATION = 2
FLEET_CLIENTS = 4
FLEET_ROUNDS = 3
FLEET_QUEUE_DEPTH = 16
FLEET_KILL_AFTER = 1.0 / 3          # share of the mix answered before the kill
FLEET_RESTART_S = 180.0             # the supervisor's restart, at most
FLEET_SWAP_CLIENTS = 2
# the autoscaler on ResNet-50 alone: a ramp of clients sending batch-32
# requests must scale 1 replica out within AUTOSCALE_OUT_S; once they stop,
# idle must bring the fleet back to 1 within AUTOSCALE_IN_S
AUTOSCALE_MAX = 3
AUTOSCALE_CLIENTS = 8
AUTOSCALE_RAMP_S = 0.5              # one more client every this many s
AUTOSCALE_OUT_S = 60.0
AUTOSCALE_IN_S = 60.0
# the shed storm: requests a storm tick sends past the queue, and the
# shed-ratio SLO it must breach
SHED_STORM = 3 * FLEET_QUEUE_DEPTH
SHED_OBJECTIVE = 0.98
MIX_LATENCY = {}                    # _serve_mix's latencies, by its label


def _mix_plans(seed, clients, rounds):
    """Phase 6b's seeded mix: each client sends every row count of both
    models once a round, in its own order."""
    rng = np.random.RandomState(seed)
    plans = []
    for k in range(clients):
        plan = []
        for r in range(rounds):
            reqs = [(name, rows, seed + 10000 * r + 1000 * k + 10 * i + rows)
                    for name, mix in sorted(RUNTIME_MIX.items())
                    for i, rows in enumerate(mix)]
            plan += [reqs[i] for i in rng.permutation(len(reqs))]
        plans.append(plan)
    return plans


class _Shim(object):
    """tools/postmortem.py names the JAX package's flight recorder; the
    port's reads the same bundle schema. While this is entered, the
    import ``from paddle_tpu.observability import flight`` resolves to
    the port's module (no file of the JAX package is read)."""

    NAMES = ('paddle_tpu', 'paddle_tpu.observability',
             'paddle_tpu.observability.flight')

    def __enter__(self):
        import types
        from paddle_tpu_torch.observability import flight
        pkg = types.ModuleType(self.NAMES[0])
        sub = types.ModuleType(self.NAMES[1])
        sub.flight = flight
        pkg.observability = sub
        self.saved = {n: sys.modules.get(n) for n in self.NAMES}
        sys.modules.update(zip(self.NAMES, (pkg, sub, flight)))
        return self

    def __exit__(self, *exc):
        for name, mod in self.saved.items():
            if mod is None:
                sys.modules.pop(name, None)
            else:
                sys.modules[name] = mod
        sys.modules.pop('postmortem', None)
        return False


def _postmortem(path):
    """tools/postmortem.py's report of a bundle: (exit code, text)."""
    import contextlib
    import io
    sys.path.insert(0, os.path.join(ROOT, 'tools'))
    out = io.StringIO()
    with _Shim(), contextlib.redirect_stdout(out):
        import postmortem
        rc = postmortem.main([path])
    return rc, out.getvalue()


def _scrape(url, route):
    import urllib.request
    with urllib.request.urlopen(url + route, timeout=30) as resp:
        return resp.read().decode('utf-8')


def phase_fleet(seed, card, artifacts):
    """15a. The saved flagship and ResNet-50 served through a Router over
    three ModelServer(CUDAPlace(0)) replicas (each model on two), 4
    clients and 3 rounds of 6b's mix, one replica that holds both killed
    mid-load; the restart, a rolling swap, a retire, the telemetry
    endpoint, the autoscaler, a placement budget and a shed-ratio SLO."""
    import threading
    import torch
    import paddle_tpu_torch as pt
    from paddle_tpu_torch import fleet
    from paddle_tpu_torch import observability as obs
    from paddle_tpu_torch.compiler import passes, tuning
    from paddle_tpu_torch.observability import flight, telemetry
    from paddle_tpu_torch.ops import cuda_kernels as ck
    from paddle_tpu_torch.serving import ModelServer, ServingError
    from paddle_tpu_torch.serving.bucketing import pad_feed
    t_phase = time.perf_counter()
    art = artifacts['dir']
    reg = obs.default_registry()

    # the telemetry endpoint, found through its port file
    tdir = os.path.join(art, 'telemetry')
    fdir = os.path.join(art, 'flight')
    prev_tdir = os.environ.get(telemetry.TELEMETRY_DIR_ENV)
    os.environ[telemetry.TELEMETRY_DIR_ENV] = tdir
    try:
        tsrv = telemetry.serve_telemetry()
    finally:
        if prev_tdir is None:
            os.environ.pop(telemetry.TELEMETRY_DIR_ENV)
        else:
            os.environ[telemetry.TELEMETRY_DIR_ENV] = prev_tdir
    found = telemetry.scan_port_dir(tdir)
    check(found == {'host-%d' % os.getpid(): tsrv.port},
          'port file %s, endpoint on %d' % (found, tsrv.port))
    url = 'http://127.0.0.1:%d' % found['host-%d' % os.getpid()]
    prev_flight = flight.configure(fdir)

    # every server the factory builds records the bucket and the model
    # of each batch it runs (a restarted replica's too), and counts its
    # Executor runs while ``runs`` counts: a batch a kill abandoned in
    # flight launched its kernels, but its server never counts it
    servers, ran_at = [], {}
    runs = {'on': False}
    runs_lock = threading.Lock()

    def factory(rid):
        server = ModelServer(pt.CUDAPlace(0), max_batch_size=32,
                             max_queue_depth=FLEET_QUEUE_DEPTH)
        real, real_exe = server._run_batch, server._exe_run

        def run_batch(model, batch, server=server, real=real):
            rows = sum(r.n for r in batch)
            bucket = server.policy.bucket_for(rows) if model.batchable \
                else rows
            for r in batch:
                ran_at[id(r)] = (bucket, server, model)
            return real(model, batch)

        def exe_run(model, feed, real_exe=real_exe):
            with runs_lock:
                if runs['on']:
                    runs[model.name] = runs.get(model.name, 0) + 1
            return real_exe(model, feed)
        server._run_batch = run_batch
        server._exe_run = exe_run
        servers.append((rid, server))
        return server

    t0 = time.perf_counter()
    router = fleet.Router(factory, replicas=FLEET_REPLICAS,
                          replication=FLEET_REPLICATION, poll_interval=0.2,
                          warmup_on_load=False)
    for name in RUNTIME_BUCKETS:
        router.load_model(name, artifacts[name])
    for name, buckets in RUNTIME_BUCKETS.items():
        for rid in router.placement(name):
            router.replica(rid).server.warmup(name, upto=buckets[-1])
    place = {name: router.placement(name) for name in RUNTIME_BUCKETS}
    both = sorted(set(place['flagship']) & set(place['resnet']))
    check(both, 'no replica holds both models: %s' % place)
    victim = both[0]
    print('fleet: Router over %d ModelServer(CUDAPlace(0)) replicas, each '
          'model on %d (%s); loaded and warmed in %.1f s; telemetry on '
          'port %d found through %s; the replica to kill: %d' % (
              FLEET_REPLICAS, FLEET_REPLICATION, place,
              time.perf_counter() - t0, tsrv.port, tdir, victim),
          flush=True)

    # the victim's answers to one request per bucket, before the kill
    def bucket_answers(server):
        return {(name, b): server.infer(name, _runtime_feed(name, b,
                                                            seed + 90 + b),
                                        timeout=600)
                for name, buckets in RUNTIME_BUCKETS.items()
                for b in buckets}
    before_kill = bucket_answers(router.replica(victim).server)

    # the mix through the Router; the kill once a third is answered
    plans = _mix_plans(seed + 150, FLEET_CLIENTS, FLEET_ROUNDS)
    total = sum(len(p) for p in plans)
    answers, routed, typed, untyped, lat = {}, {}, [], [], {}
    done = [0]
    cond = threading.Condition()
    scraped = {}

    def client(plan):
        for name, rows, s in plan:
            t1 = time.perf_counter()
            try:
                rr = router.submit(name, _runtime_feed(name, rows, s))
                out = rr.result(timeout=600)
            except ServingError as e:
                typed.append(((name, rows, s), e))
            except Exception as e:              # noqa: BLE001
                untyped.append(((name, rows, s), e))
            else:
                lat.setdefault(name, []).append(time.perf_counter() - t1)
                answers[(name, rows, s)] = out
                routed[(name, rows, s)] = rr
            with cond:
                done[0] += 1
                cond.notify_all()

    def killer():
        with cond:
            cond.wait_for(lambda: done[0] >= total * FLEET_KILL_AFTER)
        scraped['metrics'] = _scrape(url, '/metrics')
        scraped['health'] = json.loads(_scrape(url, '/health'))
        # park ResNet-50 requests on the victim, so the kill has queued
        # work to fail (and the Router to requeue)
        server = router.replica(victim).server
        server.pause('resnet')
        give_up = time.monotonic() + 30
        while server.queue_depth('resnet') < 1 and \
                time.monotonic() < give_up:
            time.sleep(0.005)
        scraped['parked'] = server.queue_depth('resnet')
        router.kill_replica(victim, abrupt=True)
        scraped['killed_at'] = done[0]

    requeued0 = reg.counter('router_requeued_total').value
    passes.reset_fallback_counts()
    before = {id(s): dict(s.stats.model_batches) for _, s in servers}
    torch.cuda.synchronize()
    ck.reset_launch_counts()
    runs['on'] = True
    threads = [threading.Thread(target=client, args=(p,)) for p in plans]
    threads.append(threading.Thread(target=killer))
    t1 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    # a killed replica's abandoned worker finishes the batch it was in
    for _, s in servers:
        for w in list(s._abandoned):
            w.join(600)
    torch.cuda.synchronize()
    runs['on'] = False
    dt = time.perf_counter() - t1
    launches = dict(ck.LAUNCHES)
    variants = dict(ck.FUSED_CONV_VARIANT_LAUNCHES)
    batches = {name: sum(s.stats.model_batches.get(name, 0) -
                         before.get(id(s), {}).get(name, 0)
                         for _, s in servers) for name in RUNTIME_BUCKETS}
    abandoned = {name: runs.get(name, 0) - batches[name]
                 for name in RUNTIME_BUCKETS}
    requeued = reg.counter('router_requeued_total').value - requeued0
    requeues = sum(r.requeues for r in routed.values())
    print('fleet: %d clients, %d requests (%d rounds of 6b\'s mix) in %.2f '
          's; replica %d killed after %d answers with %d ResNet-50 requests '
          'parked on it; answered %d, typed errors %d, untyped %d; '
          'router_requeued_total +%d (requeues on the answered futures %d); '
          'batches counted by the replicas\' ServingStats %s over %d '
          'servers built, and batches the kill abandoned in flight %s; '
          'launches %s; fused conv by variant %s; fallbacks %s; %s' % (
              FLEET_CLIENTS, total, FLEET_ROUNDS, dt, victim,
              scraped['killed_at'], scraped['parked'], len(answers),
              len(typed), len(untyped), requeued, requeues, batches,
              len(servers), abandoned, launches, variants,
              passes.FALLBACKS, card), flush=True)
    for key, e in typed[:4] + untyped[:4]:
        print('fleet:   %s: %s: %s' % (key, type(e).__name__, e), flush=True)
    check(not untyped, 'untyped errors through the kill: %r' % (untyped[:2],))
    check(len(answers) + len(typed) == total, 'futures dropped: %d of %d '
          'ended' % (len(answers) + len(typed), total))
    check(not typed, 'requests failed through the kill: %r' % (typed[:2],))
    check(requeued > 0, 'the kill requeued nothing')
    check(not passes.FALLBACKS, 'fused_conv fell back: %s' % passes.FALLBACKS)
    check(all(0 <= n <= 1 for n in abandoned.values()), 'batches abandoned '
          'by the kill: %s (one in flight a model, at most)' % abandoned)
    ran = {name: batches[name] + abandoned[name] for name in RUNTIME_BUCKETS}
    expect = dict.fromkeys(launches, 0)
    expect.update(flash_attn_fwd=FLAGSHIP['n_layers'] * ran['flagship'],
                  fused_conv=RESNET_REGIONS * ran['resnet'])
    check(launches == expect, 'fleet launches %s, expected %s (6 flash '
          'forwards a flagship batch, 53 fused convs a ResNet-50 batch, '
          'summed over the replicas, abandoned batches included)'
          % (launches, expect))
    check(variants == {v: c * ran['resnet']
                       for v, c in RESNET_VARIANTS.items()},
          'fused conv variants %s over %d ResNet batches' % (
              variants, ran['resnet']))
    for name in RUNTIME_BUCKETS:
        mine = _percentiles(lat[name])
        theirs = [x for (n, _), xs in MIX_LATENCY.get('concurrent mix',
                                                      {}).items()
                  if n == name for x in xs]
        print('fleet: %s through the Router: p50 %.2f ms, p99 %.2f ms (%d '
              'requests); 6b\'s concurrent mix through one server: p50 '
              '%s ms, p99 %s ms (%d requests); %s' % (
                  name, mine[0], mine[1], len(lat[name]),
                  *(('%.2f' % v) for v in (_percentiles(theirs) if theirs
                                           else (float('nan'),) * 2)),
                  len(theirs), card), flush=True)

    # each answer against a direct run on the server that ran it, under
    # that bucket's entry; ResNet-50's also padded to the bucket, bit for
    # bit
    holds = {name: [] for name in RUNTIME_BUCKETS}
    padded_equal = 0
    for key, out in sorted(answers.items()):
        name, rows, s = key
        bucket, server, model = ran_at[id(routed[key]._req)]
        entry = _bucket_entry(server, name, bucket)
        feed = _runtime_feed(name, rows, s)
        with tuning.apply_entry(entry):
            ref = server.executor.run(model.program, feed=feed,
                                      fetch_list=model.fetch_vars,
                                      scope=model.scope)
            padded = None if name != 'resnet' else server.executor.run(
                model.program, feed=pad_feed(feed, rows, bucket,
                                             server.policy.pad_mode),
                fetch_list=model.fetch_vars, scope=model.scope)
        check(out[0].shape == ref[0].shape and np.isfinite(out[0]).all(),
              'answer %s' % (key,))
        holds[name].append(_hold_to_direct(name, out[0], ref[0]))
        if padded is not None:
            padded_equal += bool(np.array_equal(out[0], padded[0][:rows]))
    for name in RUNTIME_BUCKETS:
        _check_agreement('fleet', name, holds[name])
    print('fleet: ResNet-50: %d of %d answers bit-equal to a direct run of '
          'their rows padded to the bucket their replica ran them at' % (
              padded_equal, len(holds['resnet'])), flush=True)
    check(padded_equal == len(holds['resnet']), 'ResNet-50 answers differ '
          'from the padded direct run')

    # the telemetry read mid-load, and the kill's postmortem bundle
    meta, samples = telemetry.parse_exposition(scraped['metrics'])
    states = {s.labels.get('replica') for s in samples
              if s.name == 'fleet_replica_state'}
    providers = scraped['health']['providers']
    mine = providers.get('router-%x' % id(router), {})
    n_servers = sum(1 for p in providers if p.startswith('server-'))
    print('fleet: mid-load scrape: %d samples of %d metrics, strict parse '
          'ok; fleet_replica_state for replicas %s; /health: %d providers '
          '(router %s with replicas %s, %d servers)' % (
              len(samples), len(meta), sorted(states), len(providers),
              mine.get('status'), sorted(mine.get('replicas', {})),
              n_servers), flush=True)
    want_ids = {str(i) for i in range(FLEET_REPLICAS)}
    check(states >= want_ids, 'scraped replica states %s' % states)
    check(set(mine.get('replicas', {})) == want_ids and
          n_servers >= FLEET_REPLICAS, '/health lacks the router or a '
          'replica: %s' % sorted(providers))
    bundles = sorted(f for f in os.listdir(fdir) if 'replica_kill' in f)
    check(len(bundles) == 1, 'kill bundles %s' % bundles)
    bundle = flight.read_bundle(os.path.join(fdir, bundles[0]))
    health = bundle.get('health') or {}
    rc, text = _postmortem(os.path.join(fdir, bundles[0]))
    print('fleet: the kill\'s bundle %s: health slot %s with %d providers; '
          'tools/postmortem.py exit %d, %d lines:\n%s' % (
              bundles[0], health.get('status'),
              len(health.get('providers') or {}), rc,
              len(text.splitlines()),
              '\n'.join('fleet:   | ' + l for l in
                        text.splitlines()[:12])), flush=True)
    check(health.get('providers') and rc == 0 and 'health:' in text,
          'the kill bundle has no health slot, or postmortem failed')

    # the supervisor brings the victim back: its answers to one request
    # per bucket equal the pre-kill answers bit for bit
    give_up = time.monotonic() + FLEET_RESTART_S
    while time.monotonic() < give_up and not (
            router.replica(victim).state == fleet.ACTIVE and
            router.replica(victim).restarts >= 1):
        time.sleep(0.1)
    rep = router.replica(victim)
    check(rep.state == fleet.ACTIVE and rep.restarts >= 1,
          'replica %d not restarted: %s' % (victim, rep.state))
    after = bucket_answers(rep.server)
    same = sum(all(np.array_equal(a, b) for a, b in zip(after[k],
                                                        before_kill[k]))
               for k in before_kill)
    print('fleet: replica %d restarted by the supervisor (generation %d); '
          'its answers to one request per bucket bit-equal to the pre-kill '
          'answers in %d of %d buckets' % (victim, rep.generation, same,
                                           len(before_kill)), flush=True)
    check(same == len(before_kill), 'the restarted replica answers '
          'differently')

    # a rolling swap to a re-saved copy of ResNet-50 under 2 clients
    copy_dir = os.path.join(art, 'resnet_copy')
    exe = pt.Executor(pt.CUDAPlace(0))
    scope = pt.Scope()
    prog, feed_names, fetch_vars = pt.io.load_inference_model(
        artifacts['resnet'], exe, scope=scope)
    pt.io.save_inference_model(copy_dir, feed_names, fetch_vars, exe,
                               main_program=prog, scope=scope)
    del scope
    stop = threading.Event()
    swap_ok, swap_err = [0], []

    def swap_client(k):
        i = 0
        while not stop.is_set():
            rows = RUNTIME_MIX['resnet'][i % len(RUNTIME_MIX['resnet'])]
            try:
                router.infer('resnet', _image_feed(rows, seed + 300 + i),
                             timeout=600)
                swap_ok[0] += 1
            except Exception as e:              # noqa: BLE001
                swap_err.append(e)
            i += 1
    swappers = [threading.Thread(target=swap_client, args=(k,))
                for k in range(FLEET_SWAP_CLIENTS)]
    for t in swappers:
        t.start()
    t1 = time.perf_counter()
    swapped = router.rolling_swap('resnet', copy_dir)
    swap_s = time.perf_counter() - t1
    stop.set()
    for t in swappers:
        t.join()
    print('fleet: rolling_swap of ResNet-50 to a re-saved copy over '
          'replicas %s in %.2f s under %d clients: %d requests answered, %d '
          'failed' % (swapped, swap_s, FLEET_SWAP_CLIENTS, swap_ok[0],
                      len(swap_err)), flush=True)
    check(swapped == router.placement('resnet') and not swap_err and
          swap_ok[0] > 0, 'the rolling swap failed requests: %r'
          % (swap_err[:2],))

    # retire the killed replica: its series leave the scraped exposition
    router.retire_replica(victim)
    _, samples = telemetry.parse_exposition(_scrape(url, '/metrics'))
    left = sorted({s.name for s in samples
                   if s.labels.get('replica') == str(victim)})
    print('fleet: replica %d retired: series still labelled with it: %s; '
          'replicas %s' % (victim, left, sorted(router.stats()['replicas'])),
          flush=True)
    check(not left, 'the retired replica\'s series remain: %s' % left)
    router.close(timeout=60)
    flight.configure(prev_flight)
    del router, servers[:], ran_at
    torch.cuda.empty_cache()

    _autoscale(seed, card, artifacts)
    _budget_and_slo(seed, card, artifacts)
    tsrv.close()
    check(telemetry.scan_port_dir(tdir) == {}, 'the port file outlived '
          'the endpoint')
    print('phase 15a: %.1f s' % (time.perf_counter() - t_phase), flush=True)
    return launches


def _autoscale(seed, card, artifacts):
    """ResNet-50 alone behind an Autoscaler (min 1, max 3): a ramp of
    clients scales it out within AUTOSCALE_OUT_S; idle brings it back to
    one replica within AUTOSCALE_IN_S."""
    import threading
    import paddle_tpu_torch as pt
    from paddle_tpu_torch import fleet
    from paddle_tpu_torch.serving import ModelServer

    def factory(rid):
        return ModelServer(pt.CUDAPlace(0), max_batch_size=32,
                           max_queue_depth=FLEET_QUEUE_DEPTH)
    t0 = time.perf_counter()
    router = fleet.Router(factory, replicas=1, poll_interval=0.2)
    router.load_model('resnet', artifacts['resnet'])
    scaler = fleet.Autoscaler(router, min_replicas=1,
                              max_replicas=AUTOSCALE_MAX, high_queue=2.0,
                              low_queue=0.5, sustain=3, up_cooldown=3.0,
                              down_cooldown=3.0, interval=0.25)
    print('fleet: autoscaler: ResNet-50 on 1 replica, loaded and warmed in '
          '%.1f s; min 1, max %d, high queue 2, low 0.5, sustain 3 ticks of '
          '0.25 s, cooldowns 3 s' % (time.perf_counter() - t0,
                                     AUTOSCALE_MAX), flush=True)
    scaler.start()
    stop = threading.Event()
    served, failed = [0], []

    def client(k):
        feed = _image_feed(32, seed + 400 + k)   # made once: the host's
        while not stop.is_set():                 # draws would hold the load
            try:
                router.infer('resnet', feed, timeout=600)
                served[0] += 1
            except Exception as e:              # noqa: BLE001
                failed.append(e)
    clients = []
    t0 = time.perf_counter()
    out_s = None
    sizes = []
    while time.perf_counter() - t0 < AUTOSCALE_OUT_S:
        if len(clients) < AUTOSCALE_CLIENTS:
            clients.append(threading.Thread(target=client,
                                            args=(len(clients),)))
            clients[-1].start()
        n = len(router.stats()['replicas'])
        sizes.append(n)
        if n > 1 and out_s is None:
            out_s = time.perf_counter() - t0
        if n >= AUTOSCALE_MAX:
            break
        time.sleep(AUTOSCALE_RAMP_S)
    peak = max(sizes)
    stop.set()
    for t in clients:
        t.join()
    t1 = time.perf_counter()
    in_s = None
    while time.perf_counter() - t1 < AUTOSCALE_IN_S:
        if len(router.stats()['replicas']) == 1:
            in_s = time.perf_counter() - t1
            break
        time.sleep(0.1)
    scaler.stop()
    print('fleet: autoscaler: ramp to %d clients: scaled out after %s s '
          '(window %g s), peak %d replicas, %d requests answered, %d failed '
          '; idle: back to 1 replica after %s s (window %g s); scale-ups '
          '%d, scale-downs %d; %s' % (
              AUTOSCALE_CLIENTS, '%.2f' % out_s if out_s is not None
              else 'never', AUTOSCALE_OUT_S, peak, served[0], len(failed),
              '%.2f' % in_s if in_s is not None else 'never',
              AUTOSCALE_IN_S, scaler.scale_ups, scaler.scale_downs, card),
          flush=True)
    check(out_s is not None, 'the ramp did not scale out within %g s'
          % AUTOSCALE_OUT_S)
    check(in_s is not None, 'idle did not scale back to 1 within %g s'
          % AUTOSCALE_IN_S)
    check(not failed, 'requests failed under the autoscaler: %r'
          % (failed[:2],))
    router.close(timeout=60)


def _budget_and_slo(seed, card, artifacts):
    """A placement budget that ResNet-50 overcommits raises
    PlacementInfeasible and leaves no placement behind; a shed storm
    breaches the shed-ratio SLO, which recovers after the drain."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch import fleet
    from paddle_tpu_torch import observability as obs
    from paddle_tpu_torch.serving import ModelServer, ServerOverloaded

    def factory(rid):
        return ModelServer(pt.CUDAPlace(0), max_batch_size=32,
                           max_queue_depth=FLEET_QUEUE_DEPTH)
    with np.load(os.path.join(artifacts['resnet'],
                              pt.io.PARAMS_FILE)) as data:
        weights = int(sum(data[k].nbytes for k in data.files))
    router = fleet.Router(factory, replicas=1, supervise=False,
                          placement_budget=fleet.PlacementBudget(
                              hbm_bytes=weights // 2))
    try:
        router.load_model('resnet', artifacts['resnet'], hbm_bytes=weights)
        err = None
    except fleet.PlacementInfeasible as e:
        err = e
    print('fleet: PlacementBudget(hbm_bytes=%d) and ResNet-50 declaring its '
          '%d weight bytes: %s; placements %s, models on the replica %s' % (
              weights // 2, weights, '%s: %s' % (type(err).__name__, err)
              if err else 'loaded', router.models(),
              router.replica(0).server.models()), flush=True)
    check(err is not None and err.budget == 'hbm_bytes' and
          'hbm_bytes' in str(err) and router.models() == [] and
          router.replica(0).server.models() == [],
          'the overcommit was not refused cleanly')

    # the shed storm: the SLO engine on the process registry, under a
    # clock the phase advances (5 s a tick), windows 10 and 60 s
    router.close(timeout=60)
    router = fleet.Router(factory, replicas=1, supervise=False)
    router.load_model('resnet', artifacts['resnet'])
    server = router.replica(0).server
    now = [0.0]
    engine = obs.SLOEngine(
        [obs.SLO.ratio('shed', bad='serving_requests_shed_total',
                       total='serving_requests_submitted_total',
                       objective=SHED_OBJECTIVE)],
        windows=(10.0, 60.0), clock=lambda: now[0])
    feed = _image_feed(1, seed + 500)

    def clean_tick():
        for _ in range(FLEET_QUEUE_DEPTH):
            router.infer('resnet', feed, timeout=600)
        now[0] += 5.0
        return engine.tick()['shed']
    reports = [clean_tick() for _ in range(3)]
    # each storm tick parks a full queue on the paused replica and sends
    # SHED_STORM more, which shed; the queue is drained before the next
    parked, shed = 0, 0
    for _ in range(3):
        server.pause('resnet')
        held = []
        for _ in range(SHED_STORM):
            try:
                held.append(server.submit('resnet', feed))
            except ServerOverloaded:
                shed += 1
        now[0] += 5.0
        reports.append(engine.tick()['shed'])
        server.resume('resnet')
        for r in held:
            r.result(timeout=600)
        parked += len(held)
    storm = reports[-1]
    reports += [clean_tick() for _ in range(4)]
    print('fleet: shed-ratio SLO (objective %g, windows 10 and 60 s): burn '
          'rate by tick %s; breached after the storm (%d parked, %d shed): '
          '%s (burn %.2f); after the drain and 4 clean ticks: breached %s '
          '(burn %.2f, long window still %.2f)' % (
              SHED_OBJECTIVE, ['%.2f' % r['burn_rate'] for r in reports],
              parked, shed, storm['breached'], storm['burn_rate'],
              reports[-1]['breached'], reports[-1]['burn_rate'],
              reports[-1]['windows'][60.0]), flush=True)
    check(storm['breached'] and storm['burn_rate'] > 1.0 and shed > 0,
          'the shed storm did not breach the SLO')
    check(not reports[-1]['breached'], 'the SLO did not recover')
    router.close(timeout=60)


# phase 15b: the decode tier at the widest widths of the repo's recurrent
# models: book 08's dictionary (models/books.py), stacked_dynamic_lstm's
# embedding and hidden width (benchmark/fluid/models.py), a 256-token
# history in 16-token pages. The slotted engine and the paged one hold
# equal KV bytes: 16 slots x 256 positions, 256 pages x 16 positions.
DECODE = dict(dict_size=30000, word_dim=512, hidden=512, max_len=256,
              page_size=16)
DECODE_SLOTS = 16
DECODE_PAGED_SLOTS = 48
DECODE_PAGES = 256
DECODE_SEQS = 192
DECODE_ORACLE = 16               # the first sequences, decoded one by one
# a token may part across slot counts only where the oracle's top two
# probabilities lie within this relative gap, (p1 - p2) / p1: f32
# products of another row count round apart by a few ulps of the logits
DECODE_TIE = 1e-5
DECODE_PROMPTS = 32              # disaggregated prefill: prompts of
DECODE_PROMPT_LENS = (8, 64)     # 8-64 tokens,
DECODE_CONTINUE = 16             # each continued for 16 tokens
DECODE_KILL_AFTER = 8            # prompts routed before a prefill replica dies


def _decode_lengths(seed, n):
    """tools/fleet_bench.py's ragged pattern scaled by 8: randint(1, 7) x 8
    tokens, every eighth sequence half the history."""
    rng = np.random.RandomState(seed)
    lengths = [int(rng.randint(1, 7)) * 8 for _ in range(n)]
    for i in range(0, n, 8):
        lengths[i] = DECODE['max_len'] // 2
    firsts = [int(rng.randint(1, DECODE['dict_size'])) for _ in range(n)]
    return lengths, firsts


def _decode_run(eng, lengths, firsts):
    """Decode every sequence through ``eng`` at once; (tokens, wall s,
    stats)."""
    eng.decode(first_id=1, max_new_tokens=2, timeout=600)   # lowering
    s0 = eng.stats()
    t0 = time.perf_counter()
    reqs = [eng.submit(first_id=f, max_new_tokens=m)
            for f, m in zip(firsts, lengths)]
    outs = [r.result(timeout=900) for r in reqs]
    wall = time.perf_counter() - t0
    s1 = eng.stats()
    return outs, wall, {'steps': s1['steps'] - s0['steps'],
                        'tokens': s1['tokens'] - s0['tokens'],
                        'occupancy': (s1['slot_steps'] - s0['slot_steps']) /
                        float(max(1, (s1['steps'] - s0['steps']) * eng.slots))}


class _Top2(object):
    """A cell wrapper keeping each step's top two probabilities, fetched
    beside the engine's own outputs and read off each step's run with
    the requests the slots held then."""

    def __init__(self, cell):
        self.cell, self.var, self.steps = cell, None, []

    def __call__(self, *args):
        import paddle_tpu_torch as pt
        out = self.cell(*args)
        self.var, _ = pt.layers.topk(out[0], k=2)
        return out

    def attach(self, eng):
        eng._fetch.append(self.var)
        real = eng.executor.run

        def run(*args, **kw):
            outs = real(*args, **kw)
            self.steps.append((np.asarray(outs[-1]), [
                None if slot is None else slot.req for slot in eng._table]))
            return outs
        eng.executor.run = run

    def rows(self, reqs):
        """Each request's top-two rows, one a token, in step order."""
        out = {id(r): [] for r in reqs}
        for top, live in self.steps:
            for i, req in enumerate(live):
                if req is not None and id(req) in out:
                    out[id(req)].append(top[i])
        return [np.array(out[id(r)]) for r in reqs]


def _corrupt(eng, mode):
    """A wrong paged cell: the step program fed kv_off shifted by one, or
    every block-table row reversed."""
    real = eng.executor.run

    def run(program, feed=None, **kw):
        feed = dict(feed)
        if mode == 'kv_off + 1':
            feed['kv_off'] = feed['kv_off'] + 1
        else:
            feed['kv_table'] = np.ascontiguousarray(feed['kv_table'][:, ::-1])
        return real(program, feed=feed, **kw)
    eng.executor.run = run


def _gaps(rows):
    """The relative top-2 gap, (p1 - p2) / p1, at each token."""
    return [[float((t[0] - t[1]) / t[0]) for t in r] for r in rows]


def _decode_probe(top2, reqs, oracle_rows):
    """The top-1 probabilities a multi-slot engine gave the oracle's
    sequences against the one-slot oracle's, token for token:
    (tokens, bit-equal, max relative difference)."""
    n = same = 0
    worst = 0.0
    for got, want in zip(top2.rows(reqs), oracle_rows):
        k = min(len(got), len(want))
        a, b = got[:k, 0], want[:k, 0]
        n += k
        same += int((a.view(np.int32) == b.view(np.int32)).sum())
        if k:
            worst = max(worst, float(np.max(np.abs(a - b) / b)))
    return n, same, worst


def _tie_gate(got, want, gaps):
    """Token by token against the oracle: a parting is excused only at a
    step whose oracle top-2 gap is within DECODE_TIE, and that sequence is
    compared no further. (compared, excused, faults, first fault)."""
    compared = excused = faults = 0
    first = None
    for i, (g, w, gp) in enumerate(zip(got, want, gaps)):
        if len(g) != len(w):
            faults += 1
            first = first or (i, 'length %d, oracle %d' % (len(g), len(w)))
            continue
        for t in range(len(w)):
            compared += 1
            if g[t] == w[t]:
                continue
            if gp[t] <= DECODE_TIE:
                excused += 1
            else:
                faults += 1
                first = first or (i, 'step %d: %d, oracle %d (gap %.3g)'
                                  % (t, g[t], w[t], gp[t]))
            break
    return compared, excused, faults, first


def _profiled_step(eng, label, card):
    """One full step of ``eng`` (every slot live) run and fetched as the
    engine does, under torch.profiler: the device's busy share of the
    step's host wall and the host<->card copies' share."""
    import torch
    from torch.profiler import profile, ProfilerActivity
    S = eng.slots
    feed = {'dec_ids': np.ones((S, 1), np.int64),
            'dec_pos': np.full((S, 1), 3, np.int64)}
    for name, _, _ in eng.specs:
        feed['dec_state_%s' % name] = eng._states[name]
    if eng.admission == 'paged':
        P = eng.pool.page_size
        feed['kv_table'] = np.tile(np.arange(eng.max_pages, dtype=np.int64),
                                   (S, 1)) % eng.pool.num_pages
        feed['kv_page'] = np.zeros((S, 1), np.int64)
        feed['kv_off'] = np.full((S, 1), 3 % P, np.int64)
        for name, _, _ in eng.pool.specs:
            feed['kv_pool_%s' % name] = eng.pool.data[name]

    def step():
        outs = eng.executor.run(eng._main, feed=feed, fetch_list=eng._fetch,
                                scope=eng.scope)
        return [np.array(o) for o in outs]
    step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = [e for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(e.device_time for e in events) / 1e6
    copies = sum(e.device_time for e in events
                 if 'memcpy' in e.name.lower()) / 1e6
    nbytes = sum(np.asarray(v).nbytes for v in feed.values())
    # the host's side of the KV round trip, as the engine makes it each
    # step: the state and pool arrays to the card, back into fresh host
    # arrays, and the engine's copy of each (median of 5)
    kv = [v for k, v in feed.items() if k.startswith(('dec_state_',
                                                      'kv_pool_'))]
    trips, device = [], eng.executor.device
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        dev = [torch.from_numpy(np.ascontiguousarray(v)).to(device)
               for v in kv]
        back = [np.array(t.cpu().numpy()) for t in dev]
        trips.append(time.perf_counter() - t0)
    del dev, back
    trip = float(np.median(trips))
    print('decode: %s: a profiled step (%d slots live): %.3f ms host wall, '
          'device busy %.1f%%, host<->card copies on the device %.3f ms '
          '(%.1f%% of the wall; %.2f MiB fed, the same fetched back but the '
          'ids); the KV round trip on the host alone %.3f ms; %s' % (
              label, S, wall * 1e3, 100 * busy / wall, copies * 1e3,
              100 * copies / wall, nbytes / 2.0 ** 20, trip * 1e3, card),
          flush=True)
    return wall, busy, copies, trip


def phase_decode(seed, card, art_dir):
    """15b. The decode tier on the card: the slotted attention cell at 16
    slots (continuous, stop-and-wait), the paged cell at 16 and 48 slots
    over equal KV bytes, a one-slot oracle; bit for bit at equal slot
    counts, token by token with tie-excused partings across them, two
    wrong paged cells failing both; then disaggregated prefill through a
    Router of two prefill replicas, one killed mid-load, into a local
    paged engine. TF32 and AMP off: the gates hold f32 decodes."""
    import threading
    import torch
    import paddle_tpu_torch as pt
    import paddle_tpu_torch.kvcache as kvc
    from paddle_tpu_torch import fleet
    from paddle_tpu_torch import observability as obs
    from paddle_tpu_torch.core import amp
    t_phase = time.perf_counter()
    tf32 = torch.backends.cuda.matmul.allow_tf32, \
        torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    amp.set_amp(False)
    try:
        _decode_gates(seed, card)
        _disagg(seed, card, art_dir)
    finally:
        amp.set_amp(None)
        torch.backends.cuda.matmul.allow_tf32, \
            torch.backends.cudnn.allow_tf32 = tf32
    torch.cuda.empty_cache()
    print('phase 15b: %.1f s' % (time.perf_counter() - t_phase), flush=True)


def _decode_engines(seed):
    import paddle_tpu_torch as pt
    import paddle_tpu_torch.kvcache as kvc
    from paddle_tpu_torch import fleet
    D = DECODE

    def slotted(slots, admission='continuous', top2=False):
        cell, specs = fleet.attention_history_cell(
            D['dict_size'], word_dim=D['word_dim'], hidden=D['hidden'],
            max_len=D['max_len'])
        wrap = _Top2(cell) if top2 else None
        eng = fleet.DecodeEngine(wrap or cell, specs, slots=slots,
                                 max_len=D['max_len'], seed=seed,
                                 admission=admission,
                                 place=pt.CUDAPlace(0))
        if wrap is not None:
            wrap.attach(eng)
        return eng, wrap

    spec = kvc.stock_spec(D['dict_size'], word_dim=D['word_dim'],
                          hidden=D['hidden'], max_len=D['max_len'],
                          page_size=D['page_size'], num_pages=DECODE_PAGES,
                          seed=seed)

    def paged(slots, corrupt=None):
        eng, pool = kvc.make_paged_engine(spec, slots=slots,
                                          place=pt.CUDAPlace(0))
        if corrupt:
            _corrupt(eng, corrupt)
        return eng

    def paged_top2(slots):
        """make_paged_engine's engine, built by hand around a _Top2."""
        cell, state_specs, pool_specs = kvc.build_cell(spec)
        wrap = _Top2(cell)
        pool = kvc.PagePool(pool_specs, num_pages=DECODE_PAGES,
                            page_size=D['page_size'])
        eng = fleet.DecodeEngine(wrap, state_specs, slots=slots,
                                 max_len=D['max_len'], seed=seed,
                                 admission='paged', page_pool=pool,
                                 place=pt.CUDAPlace(0))
        wrap.attach(eng)
        return eng, wrap
    return slotted, paged, paged_top2, spec


def _decode_gates(seed, card):
    slotted, paged, paged_top2, spec = _decode_engines(seed)
    lengths, firsts = _decode_lengths(seed + 600, DECODE_SEQS)
    tokens = sum(lengths)
    runs, readings = {}, {}
    kv_bytes = {}
    for label, make in (
            ('slotted 16 continuous', lambda: slotted(DECODE_SLOTS)[0]),
            ('slotted 16 stop-and-wait',
             lambda: slotted(DECODE_SLOTS, 'stop_and_wait')[0]),
            ('paged 16', lambda: paged(DECODE_SLOTS)),
            ('paged 48', lambda: paged(DECODE_PAGED_SLOTS))):
        eng = make()
        outs, wall, st = _decode_run(eng, lengths, firsts)
        runs[label] = outs
        kv_bytes[label] = eng.pool.nbytes if eng.pool is not None else \
            eng._states['kv'].nbytes
        step = _profiled_step(eng, label, card)
        readings[label] = (wall, st, step)
        print('decode: %s: %d sequences, %d tokens in %.3f s: %.1f tokens/s, '
              '%d steps (%.3f ms a step), occupancy %.3f; KV %.1f MiB, its '
              'round trip %.1f%% of a step; %s' % (
                  label, len(lengths), st['tokens'], wall,
                  st['tokens'] / wall, st['steps'], 1e3 * wall / st['steps'],
                  st['occupancy'], kv_bytes[label] / 2.0 ** 20,
                  100 * step[3] / (wall / st['steps']), card), flush=True)
        check(st['tokens'] == tokens, '%s emitted %d tokens of %d'
              % (label, st['tokens'], tokens))
        eng.close()
    check(len(set(kv_bytes.values())) == 1, 'KV bytes differ: %s' % kv_bytes)
    # equal slot counts: bit for bit
    ref = runs['slotted 16 continuous']
    for label in ('slotted 16 stop-and-wait', 'paged 16'):
        equal = sum(np.array_equal(a, b) for a, b in zip(runs[label], ref))
        print('decode: %s against slotted 16 continuous: %d of %d sequences '
              'bit-equal' % (label, equal, len(ref)), flush=True)
        check(equal == len(ref), '%s parts from the slotted engine at the '
              'same slot count' % label)
    # across slot counts: the one-slot oracle, ties excused
    oracle, top2 = slotted(1, top2=True)
    o_lens, o_firsts = lengths[:DECODE_ORACLE], firsts[:DECODE_ORACLE]
    reqs = [oracle.submit(first_id=f, max_new_tokens=m)
            for f, m in zip(o_firsts, o_lens)]
    want = [r.result(timeout=900) for r in reqs]
    oracle.close()
    oracle_rows = top2.rows(reqs)
    gaps = _gaps(oracle_rows)
    # the probabilities themselves across slot counts: is a row's
    # rounding independent of the engine's row count?
    for label, make in (('slotted 16', lambda: slotted(DECODE_SLOTS,
                                                        top2=True)),
                        ('paged 48', lambda: paged_top2(DECODE_PAGED_SLOTS))):
        eng, probe = make()
        preqs = [eng.submit(first_id=f, max_new_tokens=m)
                 for f, m in zip(o_firsts, o_lens)]
        for r in preqs:
            r.result(timeout=900)
        eng.close()
        n, same, worst = _decode_probe(probe, preqs, oracle_rows)
        print('decode: rows across slot counts, %s against the one-slot '
              'oracle on %d sequences: top-1 probabilities bit-equal at %d '
              'of %d tokens, max relative difference %.3g' % (
                  label, DECODE_ORACLE, same, n, worst), flush=True)
    for label in ('slotted 16 continuous', 'paged 48'):
        compared, excused, faults, first = _tie_gate(
            runs[label][:DECODE_ORACLE], want, gaps)
        print('decode: %s against the one-slot oracle on %d sequences: %d '
              'tokens compared, %d partings excused (oracle top-2 gap <= %g), '
              '%d faults%s' % (label, DECODE_ORACLE, compared, excused,
                               DECODE_TIE, faults,
                               ' (first: %s)' % (first,) if first else ''),
              flush=True)
        check(faults == 0, '%s parts from the oracle: %s' % (label, first))
    # the controls: two wrong paged cells fail both gates
    o_ref = ref[:DECODE_ORACLE]
    for mode in ('kv_off + 1', 'block table reversed'):
        for slots in (DECODE_SLOTS, DECODE_PAGED_SLOTS):
            eng = paged(slots, corrupt=mode)
            outs, _, _ = _decode_run(eng, o_lens, o_firsts)
            eng.close()
            if slots == DECODE_SLOTS:
                equal = sum(np.array_equal(a, b) for a, b in zip(outs, o_ref))
                failed = equal < len(o_ref)
                what = '%d of %d bit-equal to slotted 16' % (equal,
                                                             len(o_ref))
            else:
                _, excused, faults, _ = _tie_gate(outs, want, gaps)
                failed = faults > 0
                what = '%d faults, %d excused against the oracle' % (
                    faults, excused)
            print('decode: control, paged %d with %s: %s: %s' % (
                slots, mode, what, 'fails, as it must' if failed
                else 'PASSES'), flush=True)
            check(failed, 'the control paged %d with %s passed its gate'
                  % (slots, mode))
    return want


def _disagg(seed, card, art_dir):
    """Disaggregated prefill: a Router over two role='prefill' replicas
    (PrefillServer on the card) and a local paged engine; 32 prompts of
    8-64 tokens, one prefill replica killed after 8 are routed."""
    import threading
    import paddle_tpu_torch as pt
    import paddle_tpu_torch.kvcache as kvc
    from paddle_tpu_torch import fleet
    from paddle_tpu_torch import observability as obs
    slotted, _, _, spec = _decode_engines(seed)
    rng = np.random.RandomState(seed + 700)
    lo, hi = DECODE_PROMPT_LENS
    plens = [int(rng.randint(lo, hi + 1)) for _ in range(DECODE_PROMPTS)]
    firsts = [int(rng.randint(1, DECODE['dict_size']))
              for _ in range(DECODE_PROMPTS)]
    # the oracle: each sequence decoded alone through prompt and
    # continuation; a prompt is the first id and the oracle's own prefix
    oracle, top2 = slotted(1, top2=True)
    total = [k - 1 + DECODE_CONTINUE for k in plens]
    reqs = [oracle.submit(first_id=f, max_new_tokens=n)
            for f, n in zip(firsts, total)]
    want = [r.result(timeout=900) for r in reqs]
    oracle.close()
    gaps = _gaps(top2.rows(reqs))
    # the prompt runs through the prefill replica's teacher-forced steps:
    # the oracle's tokens after it are the continuation
    prompts = [np.concatenate([[f], w[:k - 1]]).astype(np.int64)
               for f, w, k in zip(firsts, want, plens)]

    journal_path = os.path.join(art_dir, 'disagg.jsonl')
    journal = obs.RunJournal(journal_path)
    obs.set_journal(journal)
    try:
        router = fleet.Router(lambda rid: kvc.PrefillServer(pt.CUDAPlace(0)),
                              replicas=2, replication=2, poll_interval=0.2)
        router.register_prefill('prefill', spec)
        dec = kvc.DisaggregatedDecoder(router, 'prefill', spec,
                                       slots=DECODE_PAGED_SLOTS,
                                       place=pt.CUDAPlace(0))
        t0 = time.perf_counter()
        handles, results, errors = [], {}, []
        lock = threading.Lock()

        def finish(i, h):
            try:
                out = h.result(timeout=900)
            except Exception as e:              # noqa: BLE001
                with lock:
                    errors.append((i, e))
            else:
                with lock:
                    results[i] = out
        threads = []
        victim = None
        for i, prompt in enumerate(prompts):
            if i == DECODE_KILL_AFTER:
                victim = router.placement('prefill')[0]
                router.kill_replica(victim, abrupt=True)
            h = dec.submit(prompt, DECODE_CONTINUE)
            handles.append(h)
            threads.append(threading.Thread(target=finish, args=(i, h)))
            threads[-1].start()
        for t in threads:
            t.join()
        wall = time.perf_counter() - t0
        requeues = sum(h._routed.requeues for h in handles)
        traces = [h._span.context for h in handles]
        dec.close()
        router.close(timeout=60)
    finally:
        obs.set_journal(None)
        journal.close()
    got = [results.get(i, np.zeros(0, np.int64)) for i in range(len(prompts))]
    cont_want = [w[k - 1:] for w, k in zip(want, plens)]
    cont_gaps = [g[k - 1:] for g, k in zip(gaps, plens)]
    compared, excused, faults, first = _tie_gate(got, cont_want, cont_gaps)
    print('decode: disaggregated prefill: %d prompts of %d-%d tokens, each '
          'continued %d tokens, through 2 prefill replicas (replica %s killed '
          'after %d were routed; %d requeues) into a paged engine of %d '
          'slots in %.2f s; %d failed; against the one-slot oracle: %d tokens '
          'compared, %d partings excused, %d faults%s; %s' % (
              len(prompts), min(plens), max(plens), DECODE_CONTINUE, victim,
              DECODE_KILL_AFTER, requeues, DECODE_PAGED_SLOTS, wall,
              len(errors), compared, excused, faults,
              ' (first: %s)' % (first,) if first else '', card), flush=True)
    check(not errors, 'disaggregated requests failed: %r' % (errors[:2],))
    check(faults == 0, 'disaggregated decode parts from the oracle: %s'
          % (first,))
    # one trace tree across the prefill -> decode hop
    sys.path.insert(0, os.path.join(ROOT, 'tools'))
    import trace_report
    store = trace_report.build_store([journal_path])
    whole = 0
    for ctx in traces:
        names = {store.spans[i]['name'] for i in
                 store.subtree_ids(ctx.span_id, follow_links=True)} \
            if ctx is not None and ctx.span_id in store.spans else set()
        whole += all(n in names for n in (
            'kvcache/request', 'fleet/request', 'kvcache/prefill',
            'kvcache/transfer', 'decode/request'))
    print('decode: trace_report: %d spans, %d unclosed; %d of %d requests '
          'with one tree holding kvcache/request, fleet/request, '
          'kvcache/prefill, kvcache/transfer and decode/request' % (
              len(store.spans), len(store.unclosed()), whole, len(traces)),
          flush=True)
    check(whole == len(traces), 'a request lacks its tree across the hop')


def sweep_conv_plans(card):
    """The wgmma conv's time at every (tile width, K splits) at ResNet-50's
    non-stem region shapes at batch 1, 8 and 32 (bf16, the folded batch
    norm and relu), beside the plan's pick and cuDNN's conv: the data
    behind cuda_kernels.fused_conv_plan's rule. Not part of the smoke run
    (``--sweep-conv``)."""
    import torch
    import torch.nn.functional as F
    from paddle_tpu_torch.ops import cuda_kernels as ck
    stages = (('affine', 0, 1), ('act', 'relu'))
    sms = ck._sm_count(0)
    shapes = sorted({key[:7] for key in resnet_regions() if key[2] % 64 == 0})
    print('sweep: %s, %d SMs; ms per call (CUDA graph replays)' % (card, sms),
          flush=True)
    for n in (1, 8, 32):
        for (H, W, cin, cout, k, s, p) in shapes:
            x = torch.randn(n, H, W, cin, device='cuda').bfloat16()
            w = (torch.randn(cout, k, k, cin, device='cuda') *
                 (2.0 / (k * k * cin)) ** 0.5).bfloat16()
            aux = [torch.rand(1, cout, device='cuda') + 0.5,
                   torch.randn(1, cout, device='cuda')]
            args = (x, w, aux, ('c', 'c'), stages, (s, s), (p, p), False)
            pick = ck.fused_conv_plan(x.dtype, n, H, W, cin, cout, k, k,
                                      (s, s), (p, p), False, sms)
            times = {}
            for bn in (64, 128, 256):
                if bn > 64 and cout <= bn // 2:
                    continue
                for splits in (1, 2, 3, 4, 6, 8):
                    if splits <= k * k * cin // 64:
                        plan = ck.FusedConvPlan('wgmma', bn, splits)
                        times[bn, splits] = graph_ms(
                            lambda: ck._fused_conv_launch(*args, plan=plan))
            best = min(times, key=times.get)
            xc, wc = x.permute(0, 3, 1, 2), w.permute(0, 3, 1, 2)
            library_ms = graph_ms(lambda: F.conv2d(xc, wc, stride=s,
                                                   padding=p))
            print('sweep N=%d %dx%d Cin=%d Cout=%d K=%d s=%d: plan (%d, %d) '
                  '%.4f, best (%d, %d) %.4f, cudnn %.4f | %s' % (
                      n, H, W, cin, cout, k, s, pick.bn, pick.splits,
                      times[pick.bn, pick.splits], best[0], best[1],
                      times[best], library_ms, ' '.join(
                          '%d/%d %.4f' % (b, sp, t)
                          for (b, sp), t in sorted(times.items()))),
                  flush=True)
            del x, w, aux, args, xc, wc


HOST_COST_BATCHES = (1, 8)
HOST_COST_PASSES = 60      # timed passes over a request's 53 launches
HOST_COST_REQUESTS = 30    # timed requests a batch


def host_cost(card, root, seed):
    """The host's cost of the fused conv at ResNet-50's served batches:
    the wrapper's time per launch (``cuda_kernels.fused_conv`` over the
    53 regions of a request, the card never synchronised inside a pass,
    so the time is the host's; of it, the time in the C entry point) and
    a served request's time (Executor.run, images in, probabilities
    out), medians. ``root`` is the checkout whose package is measured: a
    second checkout (another commit) is compared in the same chip call.
    Not part of the smoke run (``--host-cost``)."""
    import torch
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.ops import cuda_kernels as ck
    print('host cost: %s, package from %s' % (card, root), flush=True)
    regions = resnet_regions()
    c_time = [0.0]
    launch = ck._launch

    def timed_launch(*a):
        t0 = time.perf_counter()
        launch(*a)
        c_time[0] += time.perf_counter() - t0

    ck._launch = timed_launch
    try:
        gen = torch.Generator(device='cuda')
        gen.manual_seed(seed)
        for n in HOST_COST_BATCHES:
            calls = []
            for (H, W, cin, cout, k, s, p, stages), count in \
                    sorted(regions.items()):
                residual = any(st[0] == 'bin' for st in stages)
                kinds = ('c', 'c', 't') if residual else ('c', 'c')
                x, w, aux = _conv_inputs(gen, 'bfloat16', n, H, W, cin, cout,
                                         k, s, p, False, kinds)
                calls += count * [(x, w, aux, kinds, stages, (s, s), (p, p),
                                   False)]
            passes, in_c = [], []
            with torch.no_grad():
                for i in range(5 + HOST_COST_PASSES):
                    c_time[0] = 0.0
                    t0 = time.perf_counter()
                    for args in calls:
                        ck.fused_conv(*args)
                    dt = time.perf_counter() - t0
                    torch.cuda.synchronize()
                    if i >= 5:
                        passes.append(dt)
                        in_c.append(c_time[0])
            host = float(np.median(passes))
            print('host cost: batch %d, fused_conv wrapper over a request\'s '
                  '%d launches: %.4f ms host (median of %d passes; min %.4f, '
                  'max %.4f), %.2f us a launch, of which %.2f us in the C '
                  'entry point' % (n, len(calls), 1e3 * host, len(passes),
                             1e3 * min(passes), 1e3 * max(passes),
                             1e6 * host / len(calls),
                             1e6 * float(np.median(in_c)) / len(calls)),
                  flush=True)
            del calls
    finally:
        ck._launch = launch

    main, startup, prob = _resnet_program(seed, is_test=True)
    exe = pt.Executor()
    scope = pt.Scope()
    exe.run(startup, scope=scope)
    for n in HOST_COST_BATCHES:
        feed = _image_feed(n, seed)
        times = []
        for i in range(5 + HOST_COST_REQUESTS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out, = exe.run(main, feed=feed, fetch_list=[prob], scope=scope)
            if i >= 5:
                times.append(time.perf_counter() - t0)
        check(out.shape == (n, 1000) and np.isfinite(out).all(),
              'ResNet-50 probabilities %s' % (out.shape,))
        med = float(np.median(times))
        print('host cost: batch %d, ResNet-50 request: %.4f ms (median of %d;'
              ' min %.4f, max %.4f), %.1f images/s' % (
                  n, 1e3 * med, len(times), 1e3 * min(times),
                  1e3 * max(times), n / med), flush=True)


HOST_COST_LSTM_BATCHES = (1, 32, 256)
HOST_COST_LSTM_PASSES = 30    # timed passes over a step's 288 launches


def host_cost_lstm(card, root, seed):
    """The host's cost of the LSTM cell on stacked_dynamic_lstm's path
    (H 512, f32): the wrapper's time per launch (``fused_lstm_cell`` over
    a step's 288 launches, 96 time steps of xg's [B, 96, 4H] sequence
    times 3 layers, each step's h and c fed to the next; the card never
    synchronised inside a pass, so the time is the host's; of it, the
    time in the C entry point) at B 1, 32 and 256, and a forward request
    of the model (Executor.run of the forward program at random weights,
    ids in, probabilities out) at those batches of 80 words, medians.
    ``root`` as in :func:`host_cost`. Not part of the smoke run
    (``--host-cost``)."""
    import torch
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.ops import cuda_kernels as ck
    print('host cost: %s, package from %s' % (card, root), flush=True)
    H, T = LSTM['hid_dim'], LSTM_T_PAD
    layers = LSTM['stacked_num']
    c_time = [0.0]
    launch = ck._launch

    def timed_launch(*a):
        t0 = time.perf_counter()
        launch(*a)
        c_time[0] += time.perf_counter() - t0

    ck._launch = timed_launch
    gen = torch.Generator(device='cuda')
    gen.manual_seed(seed)
    try:
        for B in HOST_COST_LSTM_BATCHES:
            xg = torch.randn(B, T, 4 * H, device='cuda', generator=gen)
            ws = [torch.randn(H, 4 * H, device='cuda', generator=gen) /
                  H ** 0.5 for _ in range(layers)]
            passes, in_c = [], []
            with torch.no_grad():
                for i in range(3 + HOST_COST_LSTM_PASSES):
                    h = torch.zeros(B, H, device='cuda')
                    c = torch.zeros(B, H, device='cuda')
                    torch.cuda.synchronize()
                    c_time[0] = 0.0
                    t0 = time.perf_counter()
                    for w in ws:
                        for t in range(T):
                            h, c = ck.fused_lstm_cell(xg[:, t], h, c, w)
                    dt = time.perf_counter() - t0
                    torch.cuda.synchronize()
                    if i >= 3:
                        passes.append(dt)
                        in_c.append(c_time[0])
            host, n = float(np.median(passes)), layers * T
            print('host cost: B %d, fused_lstm_cell wrapper over a step\'s '
                  '%d launches: %.4f ms host (median of %d passes; min '
                  '%.4f, max %.4f), %.2f us a launch, of which %.2f us in '
                  'the C entry point' % (
                      B, n, 1e3 * host, len(passes), 1e3 * min(passes),
                      1e3 * max(passes), 1e6 * host / n,
                      1e6 * float(np.median(in_c)) / n), flush=True)
            del xg, ws
    finally:
        ck._launch = launch

    main, startup = pt.Program(), pt.Program()
    startup.random_seed = seed
    with pt.unique_name.guard(), pt.program_guard(main, startup):
        _, prediction = stacked_dynamic_lstm(pt, use_peepholes=False, **LSTM)
    exe = pt.Executor()
    scope = pt.Scope()
    exe.run(startup, scope=scope)
    for B in HOST_COST_LSTM_BATCHES:
        feed = _lstm_feed([LSTM_WORDS] * B, seed)
        times = []
        for i in range(3 + HOST_COST_REQUESTS):
            torch.cuda.synchronize()
            ck.reset_launch_counts()
            t0 = time.perf_counter()
            out, = exe.run(main, feed=feed, fetch_list=[prediction],
                           scope=scope)
            if i >= 3:
                times.append(time.perf_counter() - t0)
        check(out.shape == (B, 2) and np.isfinite(out).all(),
              'stacked_dynamic_lstm probabilities %s' % (out.shape,))
        check(ck.LAUNCHES['lstm_cell'] == layers * T, 'launches %s'
              % ck.LAUNCHES)
        med = float(np.median(times))
        print('host cost: batch %d, stacked_dynamic_lstm forward request: '
              '%.4f ms (median of %d; min %.4f, max %.4f), %d lstm_cell '
              'launches' % (B, 1e3 * med, len(times), 1e3 * min(times),
                            1e3 * max(times), layers * T), flush=True)


FETCH_COST_BATCHES = (1, 2, 4)   # the flagship's f32 logits: 64-256 MiB
FETCH_COST_REPS = 20             # timed calls a case


def fetch_cost(card, root, seed):
    """Where a served flagship request's host time goes. First the copy
    of the f32 logits (64, 128 and 256 MiB at batch 1, 2, 4) from the
    card to the host, on the main thread and on a long-lived second
    thread (as the server's worker): into a fresh pageable tensor (what a
    fetch does), into a preallocated pageable one, into a preallocated
    pinned one, and a fresh host tensor written with no copy at all (the
    allocation and its page faults alone). Then phase 5's request (the
    saved model loaded, Executor.run, the logits fetched) at batch 1, 2,
    4 on both threads, under the package's default passes and, where the
    package has the pass pipeline, under conv_epilogue_fuse alone.
    Medians. ``root`` as for ``--host-cost``. Not part of the smoke run
    (``--fetch-cost``)."""
    import concurrent.futures
    import torch
    import paddle_tpu_torch as pt
    from paddle_tpu_torch import io as pt_io
    from paddle_tpu_torch.models.fluid_transformer import transformer
    print('fetch cost: %s, package from %s' % (card, root), flush=True)
    worker = concurrent.futures.ThreadPoolExecutor(1)
    threads = (('main', lambda fn: fn()),
               ('second', lambda fn: worker.submit(fn).result()))

    def report(label, on, fn):
        def once():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            return time.perf_counter() - t0
        on(once)                                # warm-up
        ms = 1e3 * np.asarray([on(once) for _ in range(FETCH_COST_REPS)])
        print('fetch cost: %s: median %.2f ms (min %.2f, max %.2f, %d '
              'calls)' % (label, float(np.median(ms)), ms.min(), ms.max(),
                          len(ms)), flush=True)

    shape = (FLAGSHIP['seq'], FLAGSHIP['vocab'])
    for b in FETCH_COST_BATCHES:
        src = torch.randn((b,) + shape, device='cuda')
        pageable = torch.zeros(src.shape)
        pinned = torch.zeros(src.shape, pin_memory=True)
        cases = (('fresh pageable (.cpu())', lambda: src.cpu()),
                 ('preallocated pageable', lambda: pageable.copy_(src)),
                 ('preallocated pinned', lambda: pinned.copy_(src)),
                 ('fresh host tensor written, no copy',
                  lambda: torch.empty(src.shape).fill_(1.0)))
        for tname, on in threads:
            for label, fn in cases:
                report('batch %d, %d MiB, %s thread, %s' % (
                    b, src.numel() * 4 >> 20, tname, label), on, fn)
        del src, pageable, pinned, cases

    main, startup = pt.Program(), pt.Program()
    startup.random_seed = seed
    with pt.unique_name.guard(), pt.program_guard(main, startup):
        _, _, _, logits = transformer(None, **FLAGSHIP)
    exe = pt.Executor()
    scope = pt.Scope()
    exe.run(startup, scope=scope)
    os.makedirs(os.path.join(ROOT, 'build'), exist_ok=True)
    with tempfile.TemporaryDirectory(dir=os.path.join(ROOT, 'build')) as d:
        pt_io.save_inference_model(d, ['data', 'pos'], [logits], exe,
                                   main_program=main, scope=scope)
        scope = pt.Scope()
        prog, _, fetch_vars = pt_io.load_inference_model(d, exe,
                                                         scope=scope)
    pipelines = [('default passes', None)]
    if hasattr(pt.compiler, 'set_default_passes'):
        pipelines.append(('conv_epilogue_fuse alone',
                          ['conv_epilogue_fuse']))
    for plabel, passes in pipelines:
        if hasattr(pt.compiler, 'set_default_passes'):
            pt.compiler.set_default_passes(passes)
        for b in FETCH_COST_BATCHES:
            feed = _feed(b, seed + b)

            def request():
                out, = exe.run(prog, feed=feed, fetch_list=fetch_vars,
                               scope=scope)
                check(out.shape == (b,) + shape, 'logits %s' % (out.shape,))
            for tname, on in threads:
                report('flagship request, batch %d, %s, %s thread' % (
                    b, plabel, tname), on, request)
    if hasattr(pt.compiler, 'set_default_passes'):
        pt.compiler.set_default_passes(None)
    worker.shutdown()


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument('--seed', type=int, default=0)
    ap.add_argument('--sweep-conv', action='store_true',
                    help='time the wgmma conv at every tile width and K '
                    'split at the ResNet-50 shapes, then stop')
    ap.add_argument('--host-cost', action='store_true',
                    help="time the fused conv and LSTM cell wrappers' host "
                    'cost, served ResNet-50 requests at batch 1 and 8 and '
                    'stacked_dynamic_lstm forward requests, then stop')
    ap.add_argument('--fetch-cost', action='store_true',
                    help="time the flagship's logits copy to the host and "
                    'its served request on the main thread and on a '
                    'second one, then stop')
    ap.add_argument('--root', default=ROOT,
                    help='with --host-cost or --fetch-cost: the checkout '
                    'whose package is measured (default: this one)')
    ap.add_argument('--serve-tuned', metavar='CONFIG',
                    help="phase 6c's second process (run by phase 6c)")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print('chip_smoke: CUDA is not available', file=sys.stderr)
        return 2
    root = os.path.abspath(args.root if args.host_cost or args.fetch_cost
                           else ROOT)
    sys.path.insert(0, root)
    card = phase_device()
    if args.serve_tuned:
        return serve_tuned(args.serve_tuned)
    phase_build()
    os.makedirs(os.path.join(ROOT, 'build'), exist_ok=True)
    with tempfile.TemporaryDirectory(dir=os.path.join(ROOT, 'build')) as d:
        # every phase runs on an empty tuning cache of its own (the
        # kernels' rules), never on a file under ~/.cache
        from paddle_tpu_torch import compiler
        if hasattr(compiler, 'tuning'):     # not in a checkout before it
            compiler.tuning.set_default_cache(compiler.tuning.TuningCache(
                os.path.join(d, 'tuning_cache.json')))
        return run_phases(args, card, root)


def run_phases(args, card, root):
    import torch
    if args.sweep_conv:
        sweep_conv_plans(card)
        return 0
    if args.host_cost:
        host_cost_lstm(card, root, args.seed)
        host_cost(card, root, args.seed)
        return 0
    if args.fetch_cost:
        fetch_cost(card, root, args.seed)
        return 0
    phase_sass()
    kres = phase_kernels(args.seed)
    bres = phase_bwd_kernels(args.seed)
    conv = phase_conv_kernels(args.seed)
    os.makedirs(os.path.join(ROOT, 'build'), exist_ok=True)
    with tempfile.TemporaryDirectory(dir=os.path.join(ROOT, 'build')) as d:
        artifacts = {'dir': d}
        launches = phase_serving(args.seed, artifacts)
        resnet_launches = phase_resnet_serving(args.seed, artifacts)
        runtime_launches = phase_serving_runtime(args.seed, card, artifacts)
        tuned_launches = phase_autotuned_serving(args.seed, card, artifacts)
        fleet_launches = phase_fleet(args.seed, card, artifacts)
    torch.cuda.empty_cache()
    trained = phase_training(args.seed, card)
    phase_gradients(args.seed, trained)
    # keep the counts, let the flagship's scope go
    trained = {k: trained[k] for k in ('launches', 'route_launches')}
    torch.cuda.empty_cache()
    long_trained = phase_long_training(args.seed, card)
    torch.cuda.empty_cache()
    r_main, r_startup, r_loss = _train_program(args.seed)
    stats = phase_stats_kernels(args.seed, r_main, r_loss)
    resnet_trained = phase_resnet_training(args.seed, card, r_main,
                                           r_startup, r_loss)
    phase_resnet_gradients(args.seed, r_main, r_startup, r_loss)
    phase_se_resnext_training(args.seed, card)
    del r_main, r_startup, r_loss
    torch.cuda.empty_cache()
    phase_analysis(args.seed)
    with tempfile.TemporaryDirectory(dir=os.path.join(ROOT, 'build')) as d:
        bench = {name: phase_bench_model(name, args.seed, card, d)
                 for name in ('mnist', 'vgg')}
    with tempfile.TemporaryDirectory(dir=os.path.join(ROOT, 'build')) as d:
        book_launches, book_totals = phase_books(args.seed, card, d)
    lstm = phase_lstm_kernels(args.seed)
    lstm_trained = phase_lstm_training(args.seed, card)
    phase_lstm_serving(args.seed, lstm_trained, card)
    lstm_launches = lstm_trained['launches']
    del lstm_trained
    phase_lstm_gradients(args.seed)
    phase_machine_translation(args.seed, card)
    with tempfile.TemporaryDirectory(dir=os.path.join(ROOT, 'build')) as d:
        phase_control_flow(args.seed, card, d)
    with tempfile.TemporaryDirectory(dir=os.path.join(ROOT, 'build')) as d:
        phase_decode(args.seed, card, d)
    # launches: each kernel's count over the path that drives it, read
    # right after that path ran from counts set to 0 (the flash forward:
    # the served requests, the serving runtime's concurrent mix, untuned
    # and tuned, the fleet's mix (15a), and the timed training steps at
    # both lengths; the merged
    # backward: the timed training steps; the two-pass backward: the timed
    # long-context steps, its numbers at their shape, the training
    # shape's beside them; the fused conv: the served ResNet requests,
    # the serving runtime's concurrent mix, untuned and tuned, and the
    # fleet's mix)
    main_shape = kres[(4, 8, 2048, 128, 'bfloat16', True)]
    train_shape = bres[(TRAIN_BATCH, FLAGSHIP['n_heads'], FLAGSHIP['seq'],
                        FLAGSHIP['d_model'] // FLAGSHIP['n_heads'],
                        'bfloat16', True)]
    long_shape = bres[LONG_CASE]
    bwd_src = 'paddle_tpu_torch/csrc/flash_attn_bwd.cu'
    kernels = [dict(
        name='flash_attn_fwd', route='cuda',
        source='paddle_tpu_torch/csrc/flash_attn_fwd.cu',
        replaces='paddle_tpu/ops/pallas_kernels.py:85',
        launches=launches['flash_attn_fwd'] +
        runtime_launches['flash_attn_fwd'] +
        tuned_launches['flash_attn_fwd'] + fleet_launches['flash_attn_fwd'] +
        trained['launches']['flash_attn_fwd'] +
        long_trained['launches']['flash_attn_fwd'], **main_shape)]
    kernels.append(dict(
        name='flash_attn_bwd_dkvdq', route='cuda', source=bwd_src,
        replaces='paddle_tpu/ops/pallas_kernels.py:310',
        launches=trained['launches']['flash_attn_bwd_dkvdq'],
        **train_shape['flash_attn_bwd_dkvdq']))
    for name, line in (('flash_attn_bwd_dq', 245),
                       ('flash_attn_bwd_dkv', 273)):
        kernels.append(dict(
            name=name, route='cuda', source=bwd_src,
            replaces='paddle_tpu/ops/pallas_kernels.py:%d' % line,
            launches=long_trained['launches'][name],
            training_shape=train_shape[name], **long_shape[name]))
    # the fused conv: its numbers summed over one batch-32 request's 53
    # regions (bf16, as the served model runs them); launches also over
    # mnist's timed training steps and both models' served batches, and
    # over recognize_digits' training steps and both conv books' served
    # batches (13b); their regions' sums beside
    def bench_totals(form):
        return {'%s %s' % (name, key.split()[1]): t
                for name, (_, totals) in sorted(bench.items())
                for key, t in sorted(totals.items())
                if key.split()[0] == form}
    def book_regions(form):
        return {key.split(' ', 1)[1]: t for key, t in
                sorted(book_totals.items()) if key.split()[0] == form}
    kernels.append(dict(
        name='fused_conv', route='cuda',
        source='paddle_tpu_torch/csrc/fused_conv.cu',
        replaces='paddle_tpu/ops/pallas_kernels.py:789',
        launches=resnet_launches['fused_conv'] +
        runtime_launches['fused_conv'] + tuned_launches['fused_conv'] +
        fleet_launches['fused_conv'] +
        sum(b['fused_conv'] for b, _ in bench.values()) +
        book_launches['fused_conv'],
        bench_regions=bench_totals('fused_conv'),
        book_regions=book_regions('fused_conv'), **conv))
    # its stats form: launches over the timed ResNet-50, VGG-16 and
    # ResNet-32 (13b, f32 and AMP) training steps, numbers summed over one
    # batch-128 ResNet-50 step's 53 regions (bf16), VGG-16's and
    # ResNet-32's regions' sums beside
    kernels.append(dict(
        name='fused_conv_stats', route='cuda',
        source='paddle_tpu_torch/csrc/fused_conv.cu',
        replaces='paddle_tpu/ops/pallas_kernels.py:789',
        launches=resnet_trained['launches']['fused_conv_stats'] +
        bench['vgg'][0]['fused_conv_stats'] +
        book_launches['fused_conv_stats'],
        bench_regions=bench_totals('fused_conv_stats'),
        book_regions=book_regions('fused_conv_stats'), **stats))
    # the LSTM cell: launches over the timed training steps of
    # stacked_dynamic_lstm, numbers at its shape (B 256, H 512, f32), and
    # its bf16 path's at the same shape (no main path launches it)
    kernels.append(dict(
        name='lstm_cell', route='cuda',
        source='paddle_tpu_torch/csrc/lstm_cell.cu',
        replaces='paddle_tpu/ops/pallas_kernels.py:633',
        launches=lstm_launches['lstm_cell'],
        bf16=lstm[(LSTM_BATCH, LSTM['hid_dim'], 'bfloat16')],
        **lstm[(LSTM_BATCH, LSTM['hid_dim'], 'float32')]))
    print('smoke: %.1f s since the process started' % (
        time.perf_counter() - _STARTED), flush=True)
    print(json.dumps({'kernels': kernels}))
    print(card)
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
