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
    python3 chip_smoke.py --phase19       # the kernels' build, then
                                          # phase 19 alone
    python3 chip_smoke.py --phase20       # the kernels' build, then
                                          # phase 20 alone
    python3 chip_smoke.py --phase21       # the kernels' build, then
                                          # phase 21 alone
    python3 chip_smoke.py --phase22       # the kernels' build, then
                                          # phase 22 alone
    python3 chip_smoke.py --phase24       # the kernels' build, then
                                          # phase 24 alone
    python3 chip_smoke.py --phase25       # the kernels' build, then
                                          # phase 25 alone
    python3 chip_smoke.py --crnn-switches # 24b's card and CPU steps'
                                          # max pool and ReLU choices

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
   steps: exact launches by variant (mnist: 2 fused_conv a step, tf32
   in f32, mma.sync in bf16; VGG-16: 13 stats-form launches, tf32 in
   f32, the stem and 12 wgmma in bf16), no fallback, finite losses; then
   30 steps
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
   by variant (recognize_digits 2 fused_conv a step, ResNet-32 33
   stats-form: tf32 in f32, under AMP the stem, 23 mma_sync and 9 wgmma;
   the regions counted from the program) and no fallback; one f32 step held
   against the same step on the CPU (loss and probabilities within 1e-4
   of their scale; the next batch and the parameters before training
   must fail); the book saved, loaded and served through
   ModelServer(CUDAPlace(0)) at
   buckets 1-32, each answer bit for bit against a direct run padded to
   its bucket, one launch a region a batch; every region of
   recognize_digits' batch-64 step, of ResNet-32's batch-128 step, of
   its inference form at batch 128 (f32 and bf16) and of both books'
   served buckets (a request padded to each bucket the server used, f32)
   held against its plain version and timed, every f32 one also within
   CONV_F64_WITNESS of the plain version's error against f64;
14a. machine translation: full width (dict 8000, emb 256, hid 512, with
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
16. training's front end (``phase_front_end``): 16a, mnist at batch
   32 in f32 (TF32 and AMP off), 3 steps with each of Adamax,
   DecayedAdagrad, Adadelta, RMSProp, Ftrl, Momentum under ModelAverage
   and Momentum with a WeightNormParamAttr fc, on the card and on the CPU
   from one numpy state: every parameter and accumulator read with
   fetch_var within 1e-4 of its scale, the averages too and the restore
   bit for bit, exactly 2 fused convs a step (the tf32 variant); the
   controls (Adamax with its beta1 power unadvanced, RMSProp with its
   epsilon outside the square root) must fail; 16b, the flagship at full
   width and depth, batch 16, Adam(noam_decay(1024, 4000)), 5 steps:
   the fetched LRs against the formula (1e-6), the counter at 5, Adam's
   first move at most lr_1 and at lr_1 within 1% where the f32 spacing
   resolves it, 6 flash forwards and 6 merged backwards a step; 16c,
   ResNet-50 at batch 128 with MSRA conv weights (each std within 3% of
   sqrt(2 / fan_in)) under Momentum(piecewise_decay([2, 4], [0.1, 0.01,
   0.001]), 0.9), 6 steps: the LR exactly stepped at the boundaries, 53
   stats-form launches a step; a truncated normal of 2^24 values within
   2 standard deviations; an init_on_cpu MSRA init bit-equal on the card
   and the CPU; 16d, book 06's two nets at the script's widths, batch
   128, 5 Adagrad steps on the card against the CPU (1e-4), no kernel
   launch (peephole LSTMs, sequence convs), saved and served through
   ModelServer(CUDAPlace(0)) at buckets 1-32 as batches of sequences,
   every answer bit-equal to a direct run padded to its bucket; each
   limit with two wrong controls that must fail it, the seconds of each
   sub-phase printed;
17. sparse rows, calc_gradient, books 05 and 07 (``phase_sparse_and_books``,
   constants SP_* at its head), each limit with two wrong controls that
   must fail it: 17a, stacked_dynamic_lstm at phase 14's widths without
   peepholes (the lstm_cell kernel) with its table is_sparse=True under
   set_sparse_fallback_threshold(0), f32 (TF32 and AMP off), 3 steps
   under each of SGD, Adagrad and Adam: every parameter, accumulator and
   loss card against CPU at batch 16 (max(1e-4, 3x the CPU against
   itself on a nudged table)); at batch 256 the sparse table against the
   dense path's (SGD and Adagrad after 3 steps, Adam after 1, 1e-5 of
   its scale; controls: a step short, a merge that drops duplicates),
   lazy Adam's untouched rows bit-equal to the initial table and the
   rows the last batch left out bit-equal to the step before (control:
   the dense path's), exactly 288 lstm_cell launches a step; 17b,
   word2vec at book 04's widths at dict 2^20 (a table of 2^25 elements,
   the threshold, so sparse without an override) against the dense path
   under SGD and Adam: ms a step, the table's update op's device ms,
   peak memory, a profile by kind; 17c, calc_gradient: the flagship's
   loss against its embedded tokens at batch 2 (the kernels against the
   plain attention, relative L2; two wrong backwards fail; 12 flash
   forwards, the forward before the marker and its replay, and 6 merged
   backwards), mnist's loss against its images through the fused conv
   card against CPU (4 launches), and a gradient penalty on an MLP
   against its closed form in f64, the CPU, and trained 3 SGD steps
   through both markers; 17d, books 05 (recommender_system) and 07
   (label_semantic_roles) at the scripts' widths, 3 steps card against
   CPU on the synthetic datasets (book 07's Viterbi paths parting only
   at near-ties, its ChunkEvaluator counts equal), a profiled step's
   busy share, then saved, loaded and served through
   ModelServer(CUDAPlace(0)) as batches of sequences (book 05 its
   rating, book 07 its crf_decoding path from books.srl_decode), every
   answer bit-equal to a direct run padded to its bucket;
19. the Fluid high-level Trainer and its training services
   (``phase_trainer``, constants TR_*, REMAT_*, AMP_ACT_*, F16_*,
   GUARD_* at its head), each limit with two wrong controls that must
   fail it: 19a, book 02's conv net at the script's widths through
   fluid.Trainer (Adam(0.001), batch 64, f32, cuDNN deterministic) with
   a checkpoint every 2 steps: a child process (``--trainer-child``)
   sent SIGTERM after its 4th step commits at the chunk boundary and
   exits 0, a fresh one resumes, and together they are bit-equal to an
   uninterrupted run (losses and every persistable; a step counter one
   off either way must fail), ms a step and exactly 2 ``tf32`` launches
   a step; save_params, then the Inferencer serves a batch equal to the
   Trainer's test program; 19b, the same Trainer with prefetch=2,
   steps_per_dispatch=4, sync_interval=4 bit-equal to the plain loop,
   trainer_host_wait_seconds p50 and ms a step of both; 19c, book 03's
   vgg_bn_drop (dropout and train-mode batch norm), batch 128, one step
   with and without memory_optimize: the loss, every @GRAD, every
   persistable after the step (the moving statistics updated once) and
   the Scope's generator states bit-equal, 13 stats-form fused convs
   against 26;
   then the flagship at full width and depth, batch 16, one step with
   and without memory_optimize (the loss and every @GRAD bit-equal, the
   largest difference printed; 12 flash forwards against 6; peak memory
   and ms a step), then the long
   context (seq 32768, batch 5) under it, one process a depth
   (``--long-remat``) from 6 down to the first that fits: its depth,
   peak, ms a step and exact launches; 19d, mnist's AMP steps with
   set_amp_act(True) and (False): the activations' dtypes, logits within
   the mnist bf16 limit, the same ``mma_sync`` launches; 19e, ResNet-50
   served at batch 8 from its Float16Transpiler'd f32 model, f32 in and
   out, logits within RESNET_LOGITS_TOL of the f32 model under AMP and
   bit-equal to the model with its persistables rounded to bf16, 53
   fused convs a request; 19f, check_nan_inf naming the first op on a
   poisoned feed, and the AnomalyGuard's skip_batch and
   rollback_to_checkpoint under the Trainer on a poisoned reader, steps,
   trips and parameters card against CPU;
20. the in-graph readers and the data path (``phase_readers``, constants
   RIO_* at its head): 20a, ResNet-50 at full width (3x224x224, 102
   classes, flowers'), Momentum(0.01, 0.9), AMP, batch 32, fed 16 batches
   of dataset.flowers.train() that convert_reader_to_recordio_files wrote
   into 2 PTRC files, through open_files -> double_buffer(CUDAPlace(0))
   -> read_file: every batch read_file hands over byte-equal to the
   DataFeeder's, in order; the 16 losses equal to 16 DataFeeder-fed steps
   from the same state (bit for bit, or within RIO_WITNESS_MARGIN of a
   second DataFeeder-fed run where that witness itself differs); the 17th
   run raises EOFException, again, and after reset() the first batch
   comes back; 53 stats-form fused convs a step; no copy to the card by
   the Executor for the reader's slots; the native recordio library built
   and used; ms a step with and without double_buffer and DataFeeder-fed;
   20b, stacked_dynamic_lstm at phase 14's widths without peepholes,
   batch 256, 4 steps from __seq__ records through double_buffer: the
   batches and their lengths byte-equal, the losses by 20a's rule, 288
   lstm_cell launches a step, no copy by the Executor; 20c, the profiler:
   ResNet-50 served at batch 8, 3 runs under profiler.profiler: the
   table's fused_conv calls equal to the launch counter (53 a run), its
   summed op time within the runs' wall time, save_profile's file through
   tools/timeline.py, the device trace written; one 20a step under it:
   one fwd_bwd(value_and_grad) event, every momentum op, no forward op;
   a ModelServer answering 4 requests under it: 4 serving/request calls;
   a run after stop_profiler records nothing; 20d,
   memory.max_memory_allocated() equal to torch's after 20a,
   memory_stats supported with the card's memory as bytes_limit, a native
   HostArena allocating, resetting and reporting its stats, and
   metrics.Accuracy over 20a's steps equal to the batch-weighted mean of
   the fetched accuracies; the phase's seconds and the script's;
21. the public names and the last op kernels (``phase_public_api``,
   constants OPS21_*, ALIAS_*, MOBILENET_* at its head): 21a, the 38 op
   kernels that slice 21 added (arg_max ... unpool; plain PyTorch, as
   paddle_tpu computes them in XLA) in ten programs, each at the
   reference tests' shapes and at one realistic width (DCGAN's
   conv2d_transpose 512 -> 256 at 4x4 -> 8x8, batch 64; nce at dict 2^17,
   width 512, batch 256, 10 pinned negatives; conv3d and pool3d at batch
   8, 64 x 16 x 56 x 56 ...), f32 with AMP off and cuDNN's TF32 at its
   default (on), card against CPU from the same parameters: every fetch
   and every parameter's @GRAD (at the reference shapes, and at DCGAN's,
   the 3-D convs' and nce's widths) within 1e-5 of the CPU's scale,
   integers exactly; controls: the next seed's inputs and parameters
   fail every fetch whose value they set, DCGAN's transposed conv and
   the wide grouped conv3d's filter gradient in cuDNN with TF32 on fail
   the f32 limit, arg_max taking the last tie and scatter taking
   the first of a repeated id fail the exact one; 21b, book 07 at the
   script's widths, its parameters (the pretrained 'emb' among them)
   written through scope.var(n) / find_var(n).get_tensor().set(np,
   CUDAPlace(0)), two SGD steps: the losses bit-equal to the same values
   through io.params_from_numpy where a second such run is (else within
   RIO_WITNESS_MARGIN of it, and why printed), and
   get_parameter_value_by_name('crfw') equal to the Scope's tensor;
   21c, book 02's conv net as a script on ``import paddle.fluid``
   (``paddle_alias.install()``) in a child process, 3 Adam steps at batch
   64, f32, cuDNN deterministic: its losses bit-equal to the same
   function on ``paddle_tpu_torch.fluid`` here (else the difference
   printed and held at 1e-5), exactly 2 ``tf32`` fused_conv launches a
   step in each, paddle.fluid the port's module and no jax or
   paddle_tpu module in the child; the phase's seconds;
22. MobileNet-v1 through the depthwise kernel (``phase_mobilenet``,
   constants MOBILENET_* at its head): 22a, the depthwise kernel
   (``csrc/fused_conv_depthwise.cu``) at MobileNet-v1's 13 depthwise 3x3
   layers (224, batch 32), f32 and bf16, in the inference form (folded
   batch norm, ReLU) and the stats form: each layer against its plain
   version (the moments too), twice bit for bit (the slab too), f32
   within 2x the plain version's error against f64, a control with the
   taps shifted by one and one with the slab's last slot dropped; kernel,
   plain, cuDNN (TF32 off; the stats form plus two channel sums) and
   bound ms per layer and summed, the kernel's registers and spills from
   ptxas; 22b, MobileNet-v1 (224, width 1.0, 1000 classes) saved, loaded
   and served through the Executor in f32 at batch 1, 8 and 32 and under
   AMP at 32, logits against the plain fused conv (f32 1e-4, AMP
   RESNET_LOGITS_TOL), 27 fused_conv launches a request, 13 of them
   depthwise; 3 Momentum(0.01, 0.9) steps at batch 32 in f32 and AMP,
   the losses within 2x an f64 witness of the plain path, one step's
   gradients and moving statistics by the ResNet rules
   (``_hold_gradients``), 27 stats-form launches a step, 13 depthwise;
   the taps-shifted control failing the logits and loss limits; the
   depthwise regions' share of a served request's op time from the
   profiler's op table; the phase's seconds;
24. the detection and CTC families, the observatory, the cold-start store
   and the C API (``phase_detection_ctc``, constants SSD_*, CRNN_*,
   CTC_*, COLDSTART_*, CAPI_CLIENT at its head): 24a, MobileNet-SSD (300,
   width 1.0, 21 classes, 1917 priors) trained 3 Momentum(0.001, 0.9)
   steps at batch 32 on LoD ground truth in f32 (the first loss against
   the plain fused conv within 2x an f64 witness, the taps-shifted
   control failing) and AMP, one step at batch 2 against the CPU, saved,
   loaded and served through detection_output at batch 1 and 8 (loc and
   scores against the plain path and, at batch 1, the CPU; the NMS against
   the CPU's on the same inputs; DetectionMAP streamed against
   detection_map_numpy), exactly 47 regions a step and a request (35 in
   the stats form, 13 depthwise, 12 heads), the 8 extra and 12 head
   regions held and timed; 24b, CRNN-CTC (1 x 48 x 512, 96 classes)
   trained 3 steps at batch 32, one step against the CPU, warpctc against
   ctc_loss in f64, the decode and distances exactly; 24c, the Trainer
   under the performance observatory (the fused conv's counted
   operations against a hand count, the gauges, /ledgers, the flight
   bundle, the tuner's bound); 24d, two child replicas warmed through the
   cold-start store (``--coldstart-child``), empty then filled, outputs
   bit-identical; 24e, a C program built with gcc serving the saved SSD
   model through the C API, its output the Executor's bit for bit; the
   phase's seconds;
25. data parallelism and ZeRO-2 (``phase_data_parallel``, constants DP_*
   at its head): ResNet-50 (full width, Momentum(0.01, 0.9)) trained
   DP_STEPS steps at the global batch 128 on one card; then two ranks
   (processes started with ``spawn``, a ``file://`` store, each joined
   within DP_JOIN_S) sharing the card through gloo (a ``smoke:`` line
   prints the backend and the rank-to-device map; gloo's native CUDA
   collectives probed and printed; with two or more cards the NCCL pair
   runs too, else a line says it did not) take the same steps through
   ParallelExecutor from the same parameters (the residual branches'
   last gammas at RESIDUAL_GAMMA), 64 rows each, under AMP (the main
   path): replicated, then ZeRO-2 (losses, parameters, velocities and
   moving statistics bit for bit against replicated), their distance
   from one card printed; then in f32 replicated and ZeRO-2 (bit for bit
   again) within DP_LOSS_LIMIT, DP_GRAD_LIMIT and DP_UPDATE_LIMIT of one
   card in f32, the control with per-rank batch-norm moments outside
   them; per-rank argument bytes (``compile_stats``) and velocity bytes
   (halved); a ParallelExecutor with no loss sharing the
   trained Scope serves 32 images (16 a rank) against one card on the
   same weights (RESNET_LOGITS_TOL, RESNET_TOP1); the served batch once
   more, one more AMP step and one more f32 step with their regions
   recorded, and rank 0 holds each recorded region against its plain
   version (the served batch's 53 in the inference form at 16 rows, bf16,
   the next channel's filters a control that must fail; the steps' 53 a
   step in the stats form at 64 rows, bf16 and f32), the batch norms'
   sums after the collective against the sum of both ranks'; exactly 53 stats-form launches a step and 53 fused_conv a
   served batch on each rank, no fallback; ms a step of one card and of
   two ranks sharing it; the phase's seconds;
26. summary: a JSON line of the kernels, the card line, and last the
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
# every f32 region (the tf32 kernel: three TF32 products, a_lo b_lo of
# ~2^-22 a product dropped, the tensor cores' truncating adds held to one
# k-step): its max |err| against the conv and its stages in f64 (y alone
# in the stats form) at most this many times the plain f32 version's
# (cuDNN's conv with TF32 off, f32 stages), as LSTM_F64_WITNESS holds the
# cell
CONV_F64_WITNESS = 2.0
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
RESNET_VARIANTS = {'depthwise': 0, 'mma_sync': 0, 'wgmma': 52, 'stem': 1,
                   'tf32': 0}
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
# further from IEEE sums than the f32 kernel's. Set from the sound
# readings on the H100 (PERF.md, Findings): at most 8.0e-6 (bf16, sum of
# squares, the 7x7 3x3 convs with K = 4608) and 4.2e-7 (f32, an FMA
# kernel then; the three-TF32-product kernel since reads at most 8.1e-7);
# the limits are 3.7x and 2.5x that. A slab without its last slot reads
# 3650-5530x the old 1e-5.
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


# the fused conv's mma.sync kernels: (library, a pattern of the kernel's
# mangled name, instances (tile widths: f32 16, 32, 64; bf16 8 to 64 in
# steps of 8), the sass_counts column that must be non-zero: TF32 or BF16
# HMMA)
SASS_HMMA = {'fused_conv': ((r'conv_tf32_kernel', 3, 2),
                            (r'conv_mma_sync_kernel', 8, 3))}


def _kernel_label(mangled):
    m = re.search(r'(?<=\d)((?:flash_(?:fwd|bwd)|conv|lstm_cell)_\w+?'
                  r'_kernel)ILi(\d+)'
                  r'(?:ELb([01]))?', mangled)
    if not m:
        return mangled
    return '%s<%s%s>' % (m.group(1), m.group(2),
                         {'1': ', merged', '0': ', dk/dv'}.get(m.group(3),
                                                               ''))


def sass_counts(lib_path):
    """{kernel: (HGMMA, UTMALDG, HMMA on TF32, HMMA on BF16)} from the
    SASS of one built library."""
    tool = shutil.which('cuobjdump') or '/usr/local/cuda/bin/cuobjdump'
    res = subprocess.run([tool, '-sass', lib_path], capture_output=True,
                         text=True, timeout=300)
    check(res.returncode == 0, 'cuobjdump failed on %s: %s'
          % (lib_path, res.stderr[-2000:]))
    counts, name = {}, None
    for line in res.stdout.splitlines():
        if 'Function :' in line:
            name = line.split('Function :', 1)[1].strip()
            counts[name] = [0, 0, 0, 0]
        elif name is not None:
            counts[name][0] += 'HGMMA' in line
            counts[name][1] += 'UTMALDG' in line
            hmma = re.search(r'\bHMMA\.\S+', line)
            counts[name][2] += bool(hmma) and 'TF32' in hmma.group(0)
            counts[name][3] += bool(hmma) and 'BF16' in hmma.group(0)
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
    spills; fail if an instance of the fused conv's mma.sync kernels
    holds no HMMA of its type (TF32 for the f32 kernel, BF16 for
    mma_sync); print ptxas's registers and spills for them."""
    from paddle_tpu_torch.ops import _build
    for lib in sorted({row[0] for row in SASS_KERNELS}):
        rows = [row for row in SASS_KERNELS if row[0] == lib]
        counts = sass_counts(_build.library_path(lib))
        usage = ptxas_usage(_build.build_log(lib))
        row_of = {n: next((r for r in rows if re.search(r[1], n)), None)
                  for n in counts}
        for name, (hgmma, utmaldg, tf32, bf16) in sorted(counts.items()):
            regs, row = usage.get(name), row_of[name]
            print('sass: %s %s: %d HGMMA, %d UTMALDG%s%s' % (
                lib, _kernel_label(name), hgmma, utmaldg,
                ', %d HMMA on TF32, %d on BF16%s' % (
                    tf32, bf16, '; ptxas: %d registers, spill stores %d B, '
                    'spill loads %d B' % regs if regs and not row else '')
                if tf32 or bf16 else '',
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
        # the fused conv's mma.sync kernels on the tensor cores: each f32
        # (tf32) instance's products in TF32 HMMA, each bf16 (mma_sync)
        # one's in BF16 HMMA, one instance a tile width
        for kernel, instances, col in SASS_HMMA.get(lib, ()):
            ours = [n for n in counts if re.search(kernel, n)]
            for name in ours:
                check(counts[name][col] > 0, '%s has no %s HMMA' % (
                    _kernel_label(name), 'TF32' if col == 2 else 'BF16'))
            check(len(ours) == instances, '%s: expected %d instances of %s, '
                  'found %d' % (lib, instances, kernel, len(ours)))
        for row in rows:
            _, kernel, instances, _, _, no_spill = row
            ours = [n for n in counts if row_of[n] == row]
            check(len(ours) == instances, '%s: expected %d instances of '
                  'the %s kernel, found %s' % (lib, instances, kernel,
                                               ours))
            for name in ours:
                check(min(counts[name][:2]) > 0, '%s has no %s' % (
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


def conv_bound(x, w, aux, out, k, s, p, depthwise, extra_bytes=0,
               ffma=False):
    """Least time for one fused conv on these tensors on the kernel's
    route: its products (2 operations a tap inside the input, per output
    channel and input channel, one input channel a channel when
    depthwise) at the route's peak, or the bytes it must move over HBM,
    whichever is longer: the input pixels the conv reads, w, the aux
    operands, the output and ``extra_bytes`` (the stats form's moments),
    each once. The f32 route (tf32, not depthwise) takes three TF32
    products at the tensor cores' TF32 peak, as ``lstm_bound`` does;
    with ``ffma`` one product at the CUDA cores' f32 peak instead (the
    bound of an FFMA kernel, printed beside)."""
    N, H, W, cin = x.shape
    cout = out.shape[3]
    read_h, taps_h = _taps(H, k, s, p)
    read_w, taps_w = _taps(W, k, s, p)
    flops = 2 * N * cout * (1 if depthwise else cin) * taps_h * taps_w
    nbytes = (N * read_h * read_w * cin * x.element_size() + extra_bytes +
              sum(t.numel() * t.element_size() for t in [w, out] + aux))
    dtype = str(x.dtype).replace('torch.', '')
    if dtype == 'float32' and not depthwise and not ffma:
        flops, dtype = 3 * flops, 'tf32'
    t_ops, t_bytes = flops / PEAK_FLOPS[dtype], nbytes / PEAK_BYTES
    return (max(t_ops, t_bytes) * 1e3,
            'operations' if t_ops >= t_bytes else 'bytes')


def conv_f64_errors(got, ref, x, w, aux, kinds, stages, strides, pads,
                    depthwise):
    """(max |got - exact|, max |ref - exact|), exact the conv and its
    stages in f64 on the same operands."""
    import torch.nn.functional as F
    from paddle_tpu_torch.ops import cuda_kernels as ck
    xc = x.double().permute(0, 3, 1, 2)
    wc = w.double().permute(2, 0, 1).unsqueeze(1) if depthwise else \
        w.double().permute(0, 3, 1, 2)
    exact = F.conv2d(xc, wc, stride=tuple(strides), padding=tuple(pads),
                     groups=x.shape[3] if depthwise else 1).permute(
                         0, 2, 3, 1)
    fetch = ck.aux_fetcher(aux, kinds)
    for st in stages:
        exact = ck.apply_stage(exact, st, lambda i: fetch(i).double())
    return tuple((t.double() - exact).abs().max().item() for t in (got, ref))


def check_f64_witness(got, ref, args, what, images=None):
    """Hold an f32 region to CONV_F64_WITNESS: returns its (kernel,
    plain) errors against f64; with ``images`` on the batch's first
    ``images`` images only (the conv and its per-sample operands sliced;
    the f64 conv of a whole ResNet-50 batch costs seconds)."""
    if images is not None:
        x, w, aux, kinds = args[:4]
        aux = [a[:images] if kind in ('nc', 't') else a
               for a, kind in zip(aux, kinds)]
        got, ref = got[:images], ref[:images]
        args = (x[:images], w, aux) + tuple(args[3:])
    errs = conv_f64_errors(got, ref, *args)
    check(errs[0] <= CONV_F64_WITNESS * errs[1], 'fused_conv at %s: %.3g '
          'from f64, more than %g x the plain f32 version\'s %.3g' % (
              what, errs[0], CONV_F64_WITNESS, errs[1]))
    return errs


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
        """Per element against the plain version, twice bit for bit, f32
        within CONV_F64_WITNESS, and the control with the batch-norm
        shift dropped: (max |err|, err / limit, the control's err / limit
        or None)."""
        args = (x, w, aux, kinds, stages, (s, s), (p, p), dw)
        got = ck.fused_conv(*args)
        same = torch.equal(got, ck.fused_conv(*args))
        torch.cuda.synchronize()
        ref = ck.fused_conv_reference(*args)
        err = (got.float() - ref.float()).abs().max().item()
        ratio = conv_err_ratio(got, ref, dtype)
        if dtype == 'float32':
            check_f64_witness(got, ref, args, what, images=1)
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
    """A FusedConvPlan as a short label: variant, tile width, K splits
    (wgmma: blocks that share K; tf32, mma_sync: a block's warps)."""
    if plan.variant in ('depthwise', 'stem'):
        return plan.variant
    return '%s BN %d splits %d' % plan


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
# the requests timed per bucket: the flagship's 50-150 ms requests, 15 of
# them, and ResNet-50's 30, and 3 rounds of the mix, so that the whole
# script stays inside its time limit with phase 24 (~100 s): it read
# 1089 s with 50 and 100 requests and 5 rounds (phases 6b and 6c 294 s of
# it), 931 s with 30 and 60; a p99 of 15 requests is their largest but
# one
RUNTIME_BUCKETS = {'flagship': [1, 2, 4], 'resnet': [1, 2, 4, 8, 16, 32]}
RUNTIME_MIX = {'flagship': [1, 2, 3, 4], 'resnet': [1, 5, 8, 17, 32]}
RUNTIME_CLIENTS = 4
RUNTIME_ROUNDS = 3
RUNTIME_TIMED = {'flagship': 15, 'resnet': 30}
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
            for i in range(RUNTIME_TIMED[name] + 1):
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
                      name, b, s50, s99, d50, d99, s50 - d50,
                      RUNTIME_TIMED[name],
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
                    for i in range(RUNTIME_TIMED[name] + 1):
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
                          RUNTIME_TIMED[name], card), flush=True)
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
                route_launches=route_launches,
                ms=1e3 * dt / TRAIN_STEPS)


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


def _check_stats_case(x, w, s, p, dw, dtype, witness_images=None):
    """Hold the stats form at one shape against its plain version: y per
    element, the moments per channel; and the slab without its last slot
    (a kernel that drops the last row tile's partial), which must fail
    where M is not a multiple of the slot; f32: y to CONV_F64_WITNESS
    (on the first ``witness_images`` images where given). Returns max |y
    err|."""
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
    witness = ''
    if dtype == 'float32':
        args = (x, w, (), (), (), (s, s), (p, p), dw)
        errs = check_f64_witness(
            y, ck.fused_conv_reference(*args), args,
            'the stats form N=%d %dx%d Cin=%d Cout=%d s=%d' % (
                N, H, W, cin, y.shape[3], s), images=witness_images)
        witness = '; y against f64: kernel %.3g, plain %.3g (limit %gx)' % (
            errs + (CONV_F64_WITNESS,))
    control = None
    # the depthwise kernel's slot is a block, and every block has outputs
    if dw or M % rows:
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
              else '%.3g' % control, same) + witness, flush=True)
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
            err = _check_stats_case(x, w, s, p, dw, dtype,
                                    witness_images=1)
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
# take the three-TF32-product kernel in f32 and mma.sync in bf16 (the stem
# refuses Cout % 8); VGG-16's 13 take tf32 in f32, and in bf16 its stem
# (Cin 3) the stem kernel, its other twelve wgmma
BENCH_REGIONS = {'mnist': 2, 'vgg': 13}
BENCH_VARIANTS = {
    'mnist': {'float32': {'tf32': 2}, 'bfloat16': {'mma_sync': 2}},
    'vgg': {'float32': {'tf32': 13}, 'bfloat16': {'stem': 1, 'wgmma': 12}}}
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
                  dedupe=False, timed=True):
    """Each recorded region against its plain version per element (the
    stats form: y per element, the moments per channel), twice bit for
    bit, a control that must fail (the inference form: the next output
    channel's filters; the stats form: the slab without its last slot
    where M is not a multiple of it), and kernel, plain
    version, cuDNN's conv alone and the bound timed; an f32 region is
    also held to CONV_F64_WITNESS and printed with the bound of an FFMA
    kernel beside its own. The regions of ``sum_dtypes`` (by default
    bf16, the card's default, AMP) add to ``totals['<form> <context>']``
    (with more than one dtype, ``'<form> <context> <dtype>'``) and to the
    same key followed by the kernel's variant: {ms, plain_ms,
    library_ms, bound_ms, max_abs_err, regions}, one step's or one
    request's sums. With ``dedupe`` each distinct region is held and
    timed once and counted as often as it was recorded. With ``timed``
    False the regions are held and not timed, and add to no total."""
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
                                  dw, ck._sm_count(x.device.index or 0),
                                  emit_stats=stats)
        witness = ''
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
            if dtype == 'float32':
                witness = '; against f64: kernel %.3g, plain %.3g (limit ' \
                    '%gx)' % (check_f64_witness(got, ref, args, what) +
                              (CONV_F64_WITNESS,))
            call = lambda: ck.fused_conv(*args)  # noqa
            plain = lambda: ck.fused_conv_reference(*args)  # noqa
        if not timed:
            print('kernel %s %s region%s N=%d %dx%d Cin=%d Cout=%d K=%d s=%d '
                  'p=%d %s [%s] %s: max|err| %.3g%s; held, not timed%s' % (
                      'fused_conv_stats' if stats else 'fused_conv', label,
                      ' (x%d)' % count if count > 1 else '', N, H, W, cin,
                      cout, k, st[0], pd[0], dtype, ' '.join(
                          s[0] if s[0] != 'act' else s[1] for s in stages),
                      _plan_label(plan), err, '' if stats else
                      ', err/limit %.3g (next channel\'s filters: %.3g), two '
                      'calls bit-identical' % (ratio, control), witness),
                  flush=True)
            continue
        out = x.new_empty((N, (H + 2 * pd[0] - k) // st[0] + 1,
                           (W + 2 * pd[1] - k) // st[1] + 1, cout))
        bound_ms, by = conv_bound(x, w, list(aux), out, k, st[0], pd[0], dw,
                                  extra_bytes=8 * cout if stats else 0)
        if dtype == 'float32' and not dw:
            witness += '; FFMA bound_ms %.4f (%s)' % conv_bound(
                x, w, list(aux), out, k, st[0], pd[0], dw,
                extra_bytes=8 * cout if stats else 0, ffma=True)
        kernel_ms = graph_ms(call)
        plain_ms = graph_ms(plain, iters=3, reps=3)
        xc, wc = x.permute(0, 3, 1, 2), w.permute(0, 3, 1, 2)
        library_ms = graph_ms(lambda: F.conv2d(xc, wc, stride=st,
                                               padding=pd))
        print('kernel %s %s region%s N=%d %dx%d Cin=%d Cout=%d K=%d s=%d '
              'p=%d %s [%s] %s: max|err| %.3g%s; kernel_ms %.4f plain_ms %.4f '
              'cudnn_ms %.4f bound_ms %.4f (%s)%s' % (
                  'fused_conv_stats' if stats else 'fused_conv', label,
                  ' (x%d)' % count if count > 1 else '', N, H,
                  W, cin, cout, k, st[0], pd[0], dtype,
                  ' '.join(s[0] if s[0] != 'act' else s[1] for s in stages),
                  _plan_label(plan), err, '' if stats else
                  ', err/limit %.3g (next channel\'s filters: %.3g), two '
                  'calls bit-identical' % (ratio, control), kernel_ms,
                  plain_ms, library_ms, bound_ms, by, witness), flush=True)
        if dtype not in sum_dtypes:
            continue
        key = '%s %s%s' % ('fused_conv_stats' if stats else 'fused_conv',
                           context, ' ' + dtype if len(sum_dtypes) > 1
                           else '')
        for total in (key, '%s %s' % (key, plan.variant)):
            t = totals.setdefault(total, dict(
                ms=0.0, plain_ms=0.0, library_ms=0.0, bound_ms=0.0,
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
        _hold_regions('%s training' % name, 'training', calls, totals,
                      sum_dtypes=('float32', 'bfloat16'))
        del calls
    served, calls = _bench_serve(name, seed, exe, main, scope, pred, art_dir)
    launches['fused_conv'] += served
    _hold_regions('%s serving' % name, 'serving', calls, totals,
                  sum_dtypes=('float32', 'bfloat16'))
    del exe, scope, calls
    if name == 'vgg':
        _vgg_gradients(seed)
    for key, t in sorted(totals.items()):
        print('%s regions, %s, one batch-%d step or request: %d regions, '
              'summed kernel %.4f ms, plain %.4f ms, cuDNN conv alone %.4f '
              'ms, bound %.4f ms; %s' % (
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
# ... by the fused conv's variant and precision: every f32 conv on the
# three-TF32-product kernel; ResNet-32 under AMP: its 3-channel stem on the
# stem kernel, the 23 convs from 16 and 32 channels on mma_sync, the 9
# from 64 on wgmma (served in f32)
BOOK_VARIANTS = {
    'recognize_digits_conv': {'f32': {'tf32': 2}},
    'image_classification': {'f32': {'tf32': 33},
                             'bf16': {'stem': 1, 'mma_sync': 23,
                                      'wgmma': 9}}}
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
    want = {v: c * steps for v, c in
            BOOK_VARIANTS.get(name, {}).get(precision, {}).items()}
    check(run['variants'] == want, '%s: the fused conv by variant %s, '
          'expected %s' % (name, run['variants'], want))
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
        variants = {v: c for v, c in ck.FUSED_CONV_VARIANT_LAUNCHES.items()
                    if c}
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
          'to a direct run padded to its bucket; launches %s, the fused '
          'conv by variant %s, fallbacks %s' % (
              name, BOOK_REQUESTS, buckets, ', '.join(
                  '%.2f' % (1e3 * t) for t in times),
              {n: c for n, c in launches.items() if c}, variants,
              fallbacks), flush=True)
    expect = {n: 0 for n in launches}
    expect['fused_conv'] = BOOK_REGIONS.get(name, 0) * len(BOOK_REQUESTS)
    check(launches == expect, '%s served with launches %s, expected %s'
          % (name, launches, expect))
    want = {v: c * len(BOOK_REQUESTS) for v, c in
            BOOK_VARIANTS.get(name, {}).get('f32', {}).items()}
    check(variants == want, '%s served the fused conv by variant %s, '
          'expected %s' % (name, variants, want))
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
                         stacked_num=3, use_peepholes=True, is_sparse=False,
                         data=None, label=None):
    """benchmark/fluid/models.py:70-104 line for line, with the LSTMs'
    use_peepholes and the table's is_sparse as arguments, and the words
    and labels given (a reader's slots) or declared as data. Returns
    (loss, prediction)."""
    layers = pkg.layers
    if data is None:
        data = layers.data(name='data', shape=[1], dtype='int64',
                           lod_level=1)
        label = layers.data(name='label', shape=[1], dtype='int64')
    emb = layers.embedding(input=data, size=[dict_size, emb_dim],
                           is_sparse=is_sparse)
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


# phase 16, training's front end: the new optimizers, the step counter
# and learning-rate schedules, the initializers and weight
# normalisation, and book 06, on the card. The limits, each printed
# beside its reading and each with two deliberately wrong controls that
# must fail it:
# 16a: card against CPU from the same numpy state and feeds, every
# parameter and accumulator (fetch_var) and the losses, max |diff| over
# max |value| a tensor, f32 (TF32 and AMP off). An update that divides
# the gradient by a small root amplifies the gradient's own f32
# rounding, which the card and the CPU sum in other orders, so each case
# is held against its own witness: the CPU against itself on images
# moved by each of FE_WITNESS_SCALES, the largest reading. Limit:
# max(FE_TOL, the roadmap's whole-model limit for f32, FE_WITNESS_FACTOR
# x the witness). Controls: Adamax with its beta1 power left unadvanced
# and RMSProp with its epsilon outside the square root (both on the
# card), each against its right case's limit
FE_TOL = 1e-4
FE_WITNESS_FACTOR = 3.0
FE_WITNESS_SCALES = tuple(np.float32(1 + e) for e in
                          (2 ** -22, -2 ** -22, 2 ** -21))
FE_STEPS = 3                       # 16a: steps each optimizer, batch 32
FE_BATCH = BENCH_BATCH
# 16a's settings, fixed before the first card run of the phase: each
# optimizer at its defaults but for the learning rate (Adagrad's is the
# reference's tests/test_optimizer.py:75), Momentum as the harness's
# (fluid_benchmark.py:46)
FE_OPTIMIZERS = {
    'Adagrad': lambda O: O.Adagrad(0.01),
    'Adamax': lambda O: O.Adamax(learning_rate=0.002),
    'DecayedAdagrad': lambda O: O.DecayedAdagrad(0.01),
    'Adadelta': lambda O: O.Adadelta(1.0),
    'RMSProp': lambda O: O.RMSProp(0.001, momentum=0.5),
    'Ftrl': lambda O: O.Ftrl(0.05, l1=1e-4, l2=1e-4),
    'Momentum': lambda O: O.Momentum(0.01, 0.9)}
# 16b: noam_decay(d_model, warmup) on the flagship, Adam, batch 16: step
# k's fetched LR against d^-0.5 min(k^-0.5, k warmup^-1.5) (relative);
# Adam's first step moves each weight by at most lr_1 (plus the f32
# spacing of the weight) and, among the weights whose f32 spacing is
# under FE_SPACING of lr_1, the largest move is lr_1 within FE_MOVE
FE_NOAM = (1024, 4000)
FE_NOAM_STEPS = 5
FE_LR_RTOL = 1e-6
FE_MOVE = 0.01
FE_SPACING = 0.005
# 16c: ResNet-50 at batch 128 (AMP) with MSRA conv weights and
# Momentum(piecewise_decay(...), 0.9): the LR at each step exactly the
# f32 value of its interval's; each conv weight's standard deviation
# within FE_STD of sqrt(2 / fan_in); a truncated_gaussian_random draw of
# FE_TRUNC values (mean 0, std 1) within 2 of its mean, its standard
# deviation within FE_TRUNC_STD of the law's (the normal cut at +-2:
# sqrt(1 - 4 phi(2) / (2 Phi(2) - 1)), 0.8796) and its mean within
# FE_TRUNC_MEAN of 0 (controls: a plain normal draw, the truncated draw
# at std 2, a uniform draw on [-2, 2]); a force_cpu (init_on_cpu) init
# bit-equal on the card and on the CPU
FE_PIECEWISE = ([2, 4], [0.1, 0.01, 0.001])
FE_RESNET_STEPS = 6
FE_STD = 0.03
FE_TRUNC = 1 << 24
FE_TRUNC_STD = 0.005              # ~30 standard errors at 2^24 values
FE_TRUNC_MEAN = 1e-3              # ~5 standard errors at 2^24 values
# 16d: book 06 at the script's widths, batch 128: FE_BOOK_STEPS steps on
# the card against the same steps on the CPU, each step's loss and
# probabilities, then the probabilities of a forward-only run on the
# last batch from each device's trained state, so that every update
# reaches a held number (FE_TOL, the books' rule of phase 13b; controls:
# the CPU one step late, the last batch from the parameters before
# training, and the forward-only run from the CPU's state before its last
# update). The trained state is printed beside, not held: Adagrad's
# first steps are sign-like, so a near-zero gradient's rounding moves a
# weight by a whole step (the CPU against itself at 8 and at 3 threads:
# the LSTM net's state 0.088 of its scale, its outputs 9.4e-6; the card:
# 0.0027 and 2.86e-6; PERF.md, Findings); served through
# ModelServer(CUDAPlace(0)), each answer bit-equal to a direct run padded
# to its bucket (controls: the direct run on the next requests' words,
# and from the parameters before training)
FE_BOOK_STEPS = 5
FE_BOOK_NETS = ('sentiment_conv', 'sentiment_lstm')
FE_SERVE_REPS = 5                  # timed requests a size


def _fe_reading(got, ref):
    """Max |diff| over max |ref| of each name in ``ref``; the largest."""
    out = {}
    for n, r in ref.items():
        g = np.asarray(got[n], dtype='float64')
        r = np.asarray(r, dtype='float64')
        out[n] = float('inf') if g.shape != r.shape else float(
            np.abs(g - r).max() / max(np.abs(r).max(), 1e-30)) \
            if r.size else 0.0
    return out


@contextlib.contextmanager
def _kernel_swapped(op_type, fn):
    """Run ``op_type`` on ``fn`` for the duration (a wrong control)."""
    from paddle_tpu_torch.core import registry
    saved = registry._KERNELS[op_type]
    registry._KERNELS[op_type] = fn
    try:
        yield
    finally:
        registry._KERNELS[op_type] = saved


def _rmsprop_eps_outside(ctx):
    """The RMSProp control: epsilon added after the square root."""
    import torch
    p, g = ctx.input('Param'), ctx.input('Grad')
    rho = ctx.attr('decay', 0.95)
    ms = rho * ctx.input('MeanSquare') + (1 - rho) * torch.square(g)
    mom = ctx.attr('momentum', 0.0) * ctx.input('Moment') + \
        ctx.input('LearningRate').reshape(()) * g / (
            torch.sqrt(ms) + ctx.attr('epsilon', 1e-6))
    ctx.set_output('ParamOut', p - mom)
    ctx.set_output('MeanSquareOut', ms)
    ctx.set_output('MomentOut', mom)


def _fe_mnist(seed, opt_name, weight_norm=False, drop_beta1_pow=False):
    """mnist (benchmark/fluid/models.py:24-37) with one optimizer; with
    ``weight_norm`` its fc weight-normalised (WeightNormParamAttr over
    the output axis); with ``drop_beta1_pow`` (a control) Adamax's
    beta1-power update left out. Returns (main, startup, loss, opt)."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.models import benchmark as bm
    main, startup = pt.Program(), pt.Program()
    startup.random_seed = seed
    with pt.unique_name.guard(), pt.program_guard(main, startup):
        if weight_norm:
            img = pt.layers.data(name='data', shape=[1, 28, 28],
                                 dtype='float32')
            label = pt.layers.data(name='label', shape=[1], dtype='int64')
            c = img
            for filters in (20, 50):
                c = pt.nets.simple_img_conv_pool(
                    input=c, filter_size=5, num_filters=filters,
                    pool_size=2, pool_stride=2, act='relu')
            pred = pt.layers.fc(input=c, size=10, act='softmax',
                                param_attr=pt.WeightNormParamAttr(dim=1))
            loss = pt.layers.mean(pt.layers.cross_entropy(input=pred,
                                                          label=label))
        else:
            loss, _ = bm.mnist()
        O = pt.optimizer
        opt = FE_OPTIMIZERS[opt_name](O)
        opt.minimize(loss)
    if drop_beta1_pow:
        block = main.global_block()
        name = opt._beta1_pow_acc.name
        block.ops = [op for op in block.ops if not (
            op.type == 'scale' and op.outputs['Out'] == [name])]
        main._bump_version()
    return main, startup, loss, opt


def _fe_train(main, loss, place, state, feeds, average=None):
    """FE_STEPS steps on ``place`` from ``state``: (every persistable by
    fetch_var, losses, ms a step over the steps after the first, the
    scope). With ``average`` (a ModelAverage factory) the average is
    updated after each step and applied at the end: its values come
    back under '<name>@AVG', and the restore is checked bit for bit."""
    import torch
    import paddle_tpu_torch as pt
    from paddle_tpu_torch import io as pt_io
    exe, scope = pt.Executor(place), pt.Scope()
    pt_io.params_from_numpy(scope, state, place)
    avg = average() if average is not None else None
    losses, times = [], []
    for f in feeds:
        t0 = time.perf_counter()
        losses.append(exe.run(main, feed=f, fetch_list=[loss],
                              scope=scope)[0])
        times.append(time.perf_counter() - t0)
        if avg is not None:
            with pt.program_guard(main):
                avg.update(scope)
    names = sorted(v.name for v in main.list_vars() if v.persistable)
    out = {n: pt.fetch_var(n, scope) for n in names}
    out['@LOSS'] = np.concatenate([np.ravel(l) for l in losses])
    if avg is not None:
        params = [p.name for p in main.global_block().all_parameters()]
        trained = {n: scope.raw(n) for n in params}
        with pt.scope_guard(scope), pt.program_guard(main):
            with avg.apply():
                for n in params:
                    out[n + '@AVG'] = pt.fetch_var(n, scope)
        check(all(scope.raw(n) is trained[n] for n in params) and all(
            np.array_equal(pt.fetch_var(n, scope), out[n]) for n in params),
            'ModelAverage.restore did not give back the trained tensors')
    if place.torch_device().type == 'cuda':
        torch.cuda.synchronize()
    return out, 1e3 * float(np.mean(times[1:])), scope


def _fe_optimizers(seed, card):
    """16a. Every new optimizer (and Momentum under ModelAverage, and an
    fc under WeightNormParamAttr) on mnist, card against CPU."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.compiler import passes
    from paddle_tpu_torch.ops import cuda_kernels as ck
    t0 = time.perf_counter()
    rng = np.random.RandomState(seed + 161)
    feeds = [{'data': rng.randn(FE_BATCH, 1, 28, 28).astype('float32'),
              'label': rng.randint(0, 10, (FE_BATCH, 1)).astype('int64')}
             for _ in range(FE_STEPS)]
    cases = [('Adagrad', {}), ('Adamax', {}), ('DecayedAdagrad', {}),
             ('Adadelta', {}), ('RMSProp', {}), ('Ftrl', {}),
             ('Momentum', {'average': True}),
             ('Momentum', {'weight_norm': True})]
    launches = dict.fromkeys(ck.LAUNCHES, 0)
    cpu_ref = {}
    for opt_name, kw in cases:
        label = opt_name + (' + ModelAverage' if kw.get('average') else
                            ' + WeightNormParamAttr' if
                            kw.get('weight_norm') else '')
        main, startup, loss, _ = _fe_mnist(seed, opt_name,
                                           kw.get('weight_norm', False))
        state = _startup_state(startup)
        average = (lambda: pt.optimizer.ModelAverage(
            0.15, min_average_window=2, max_average_window=10)) \
            if kw.get('average') else None
        ref, _, _ = _fe_train(main, loss, pt.CPUPlace(), state, feeds,
                              average)
        witness = max(max(_fe_reading(_fe_train(
            main, loss, pt.CPUPlace(), state,
            [dict(f, data=f['data'] * scale) for f in feeds],
            average)[0], ref).values()) for scale in FE_WITNESS_SCALES)
        limit = max(FE_TOL, FE_WITNESS_FACTOR * witness)
        ck.reset_launch_counts()
        passes.reset_fallback_counts()
        got, ms, _ = _fe_train(main, loss, pt.CUDAPlace(0), state, feeds,
                               average)
        step_launches = dict(ck.LAUNCHES)
        step_variants = {v: c for v, c in
                         ck.FUSED_CONV_VARIANT_LAUNCHES.items() if c}
        fallbacks = dict(passes.FALLBACKS)
        readings = _fe_reading(got, ref)
        worst = max(readings, key=readings.get)
        print('front end 16a: mnist, %s, batch %d, f32 (TF32 and AMP off), '
              '%d steps: %.2f ms a step after the first (host clock); %d '
              'tensors (parameters, accumulators, LR, losses%s) card against '
              'CPU, worst %.3g (%s; limit %.3g: max(%g, %g x the witness, the '
              'CPU against itself on images moved by 2^-22, -2^-22, 2^-21: '
              '%.3g)); launches %s, by variant %s, fallbacks %s; %s' % (
                  label, FE_BATCH, FE_STEPS, ms, len(readings),
                  ', averages' if average else '', readings[worst], worst,
                  limit, FE_TOL, FE_WITNESS_FACTOR, witness,
                  {n: c for n, c in step_launches.items() if c},
                  step_variants, fallbacks, card), flush=True)
        check(readings[worst] <= limit, '16a %s: the card differs from the '
              'CPU by %g (%s), limit %g' % (label, readings[worst], worst,
                                            limit))
        expect = dict.fromkeys(step_launches, 0)
        expect['fused_conv'] = BENCH_REGIONS['mnist'] * FE_STEPS
        check(step_launches == expect, '16a %s launches %s, expected %s'
              % (label, step_launches, expect))
        want = {v: c * FE_STEPS for v, c in
                BENCH_VARIANTS['mnist']['float32'].items()}
        check(step_variants == want, '16a %s: the fused conv by variant %s, '
              'expected %s' % (label, step_variants, want))
        check(step_variants == {v: c * FE_STEPS for v, c in BENCH_VARIANTS[
            'mnist']['float32'].items()}, '16a %s: the fused conv by variant '
              '%s' % (label, step_variants))
        check(not fallbacks, '16a %s fell back: %s' % (label, fallbacks))
        if kw.get('average'):
            moved = max(float(np.abs(got[n + '@AVG'] - got[n]).max())
                        for n in (p.name for p in
                                  main.global_block().all_parameters()))
            check(moved > 0, '16a: the average equals the trained weights')
        for n, c in step_launches.items():
            launches[n] += c
        cpu_ref[opt_name] = (ref, state, limit)
    # the controls, on the card, against the right CPU runs
    for label, opt_name, build_kw, swap in (
            ('Adamax, beta1 power unadvanced', 'Adamax',
             {'drop_beta1_pow': True}, None),
            ('RMSProp, epsilon outside the square root', 'RMSProp', {},
             ('rmsprop', _rmsprop_eps_outside))):
        main, _, loss, _ = _fe_mnist(seed, opt_name, **build_kw)
        ref, state, limit = cpu_ref[opt_name]
        if swap is None:
            got = _fe_train(main, loss, pt.CUDAPlace(0), state, feeds)[0]
        else:
            with _kernel_swapped(*swap):
                got = _fe_train(main, loss, pt.CUDAPlace(0), state,
                                feeds)[0]
        readings = _fe_reading(got, ref)
        worst = max(readings, key=readings.get)
        print('front end 16a control (%s): worst %.3g (%s), limit %.3g, must '
              'fail' % (label, readings[worst], worst, limit), flush=True)
        check(readings[worst] > limit, 'the 16a limit does not catch %s'
              % label)
    print('front end 16a: %.1f s' % (time.perf_counter() - t0), flush=True)
    return launches


def _noam(k):
    d, warm = FE_NOAM
    return d ** -0.5 * min(k ** -0.5, k * warm ** -1.5)


def _fe_lr_reading(got, want):
    return max(abs(g - w) / abs(w) for g, w in zip(got, want))


def _fe_flagship(seed, card):
    """16b. The flagship (phase 7's, full width and depth, batch 16)
    under Adam(noam_decay(1024, 4000))."""
    import torch
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.models.fluid_transformer import transformer
    from paddle_tpu_torch.ops import cuda_kernels as ck
    t0 = time.perf_counter()
    main, startup = pt.Program(), pt.Program()
    startup.random_seed = seed
    with pt.unique_name.guard(), pt.program_guard(main, startup):
        loss = transformer(None, **FLAGSHIP)[0]
        lr = pt.layers.noam_decay(*FE_NOAM)
        pt.optimizer.Adam(learning_rate=lr).minimize(loss)
    exe, scope = pt.Executor(), pt.Scope()
    exe.run(startup, scope=scope)
    params = [p.name for p in main.global_block().all_parameters()]
    before = {n: scope.raw(n).clone() for n in params}
    feed = _train_feed(TRAIN_BATCH, seed + 7)
    ck.reset_launch_counts()
    lrs, times, after1, after2 = [], [], None, None
    for k in range(1, FE_NOAM_STEPS + 1):
        t1 = time.perf_counter()
        out = exe.run(main, feed=feed, fetch_list=[loss, lr], scope=scope)
        times.append(time.perf_counter() - t1)
        lrs.append(float(np.ravel(out[1])[0]))
        if k == 1:
            after1 = {n: scope.raw(n).clone() for n in params}
        elif k == 2:
            after2 = {n: scope.raw(n).clone() for n in params}
    torch.cuda.synchronize()
    launches = dict(ck.LAUNCHES)
    counter = int(pt.fetch_var('@LR_DECAY_COUNTER@', scope)[0])
    want = [_noam(k) for k in range(1, FE_NOAM_STEPS + 1)]
    lr_read = _fe_lr_reading(lrs, want)
    ctl_warm = _fe_lr_reading(lrs, [FE_NOAM[0] ** -0.5 * min(
        k ** -0.5, k * (FE_NOAM[1] / 2) ** -1.5)
        for k in range(1, FE_NOAM_STEPS + 1)])
    ctl_off = _fe_lr_reading(lrs, [_noam(k + 1)
                                   for k in range(1, FE_NOAM_STEPS + 1)])

    def moves(a, b, lr_1):
        """(the largest move over lr_1 + the weight's f32 spacing, the
        largest move over lr_1 among the finely spaced weights)."""
        over, fine = 0.0, 0.0
        for n in params:
            old = a[n].float()
            d = (b[n].float() - old).abs()
            # the f32 spacing at each weight: 2^(e - 24) for |w| = m 2^e,
            # 0.5 <= m < 1
            spacing = torch.ldexp(torch.ones_like(old),
                                  torch.frexp(old)[1] - 24)
            over = max(over, float((d / (lr_1 + spacing)).max()))
            mask = spacing <= FE_SPACING * lr_1
            if bool(mask.any()):
                fine = max(fine, float(d[mask].max() / lr_1))
        return over, fine
    over, fine = moves(before, after1, lrs[0])
    ctl_two = moves(before, after2, lrs[0])          # two steps' move
    ctl_lr2 = moves(before, after1, lrs[1])          # against lr_2
    del before, after1, after2
    ms = 1e3 * float(np.mean(times[1:]))
    print('front end 16b: the flagship %s, batch %d, Adam(noam_decay%s), '
          '%d steps: %.2f ms a step after the first (host clock); LRs %s '
          'against the formula: %.3g '
          '(limit %g; controls: warm-up %d %.3g, one step late %.3g, must '
          'fail); the counter reads %d; the first step\'s largest move '
          'over lr_1 + spacing %.6f (limit 1), among finely spaced weights '
          '%.6f of lr_1 (limit 1 +- %g); controls: two steps %.4f / %.4f, '
          'against lr_2 %.4f / %.4f (must fail); launches %s; %s' % (
              FLAGSHIP, TRAIN_BATCH, FE_NOAM, FE_NOAM_STEPS, ms,
              ', '.join('%.6g' % l for l in lrs), lr_read, FE_LR_RTOL,
              FE_NOAM[1] // 2, ctl_warm, ctl_off, counter, over, fine,
              FE_MOVE, ctl_two[0], ctl_two[1], ctl_lr2[0], ctl_lr2[1],
              {n: c for n, c in launches.items() if c}, card), flush=True)
    check(lr_read <= FE_LR_RTOL, '16b: the noam LRs are off by %g' % lr_read)
    check(ctl_warm > FE_LR_RTOL and ctl_off > FE_LR_RTOL,
          '16b: the LR limit does not catch a wrong schedule')
    check(counter == FE_NOAM_STEPS, '16b: the counter reads %d' % counter)
    check(over <= 1.0 and abs(fine - 1.0) <= FE_MOVE,
          '16b: Adam\'s first step moved weights by %g / %g of lr_1'
          % (over, fine))
    for ctl in (ctl_two, ctl_lr2):
        check(not (ctl[0] <= 1.0 and abs(ctl[1] - 1.0) <= FE_MOVE),
              '16b: the move limit does not catch %s' % (ctl,))
    n_layers = FLAGSHIP['n_layers']
    expect = dict.fromkeys(launches, 0)
    expect.update(flash_attn_fwd=n_layers * FE_NOAM_STEPS,
                  flash_attn_bwd_dkvdq=n_layers * FE_NOAM_STEPS)
    check(launches == expect, '16b launches %s, expected %s'
          % (launches, expect))
    del scope, exe
    torch.cuda.empty_cache()
    print('front end 16b: %.1f s' % (time.perf_counter() - t0), flush=True)
    return launches, ms


def _fe_msra_convs(main, startup):
    """Give every conv2d filter of ``main`` the MSRA initializer in
    ``startup``, in place of its own init op. Returns {filter: (fan_in,
    fan_out)}."""
    import paddle_tpu_torch as pt
    block = startup.global_block()
    fans = {}
    for op in main.global_block().ops:
        if op.type == 'conv2d':
            name = op.inputs['Filter'][0]
            shape = main.global_block().var(name).shape
            fans[name] = (int(np.prod(shape[1:])),
                          int(shape[0] * np.prod(shape[2:])))
    ops = []
    for op in block.ops:
        out = op.outputs.get('Out', [None])[0]
        if out in fans:
            pt.initializer.MSRA()(block.var(out), block)
            ops.append(block.ops.pop())
        else:
            ops.append(op)
    block.ops = ops
    startup._bump_version()
    return fans


def _fe_resnet(seed, card):
    """16c. ResNet-50 under piecewise_decay with MSRA conv weights; the
    truncated normal and a force_cpu init."""
    import torch
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.compiler import passes
    from paddle_tpu_torch.models import resnet
    from paddle_tpu_torch.ops import cuda_kernels as ck
    t0 = time.perf_counter()
    main, startup = pt.Program(), pt.Program()
    startup.random_seed = seed
    with pt.unique_name.guard(), pt.program_guard(main, startup):
        img = pt.layers.data(name='data', shape=[3, 224, 224],
                             dtype='float32')
        label = pt.layers.data(name='label', shape=[1], dtype='int64')
        predict = resnet.resnet_imagenet(img, class_dim=1000, depth=50)
        loss = pt.layers.mean(pt.layers.cross_entropy(input=predict,
                                                      label=label))
        lr = pt.layers.piecewise_decay(*FE_PIECEWISE)
        pt.optimizer.Momentum(learning_rate=lr, momentum=0.9).minimize(loss)
    fans = _fe_msra_convs(main, startup)
    exe, scope = pt.Executor(), pt.Scope()
    exe.run(startup, scope=scope)

    def std_reading(target):
        return max(abs(float(scope.raw(n).float().std()) / target(*f) - 1)
                   for n, f in fans.items())
    std_read = std_reading(lambda fan_in, fan_out: (2.0 / fan_in) ** 0.5)
    ctl_lecun = std_reading(lambda fan_in, fan_out: (1.0 / fan_in) ** 0.5)
    ctl_out = std_reading(lambda fan_in, fan_out: (2.0 / fan_out) ** 0.5)
    feed = _image_train_feed(RESNET_TRAIN_BATCH, seed + 11)
    ck.reset_launch_counts()
    passes.reset_fallback_counts()
    lrs, losses, times = [], [], []
    for _ in range(FE_RESNET_STEPS):
        t1 = time.perf_counter()
        out = exe.run(main, feed=feed, fetch_list=[loss, lr], scope=scope)
        times.append(time.perf_counter() - t1)
        losses.append(float(np.ravel(out[0])[0]))
        lrs.append(np.float32(np.ravel(out[1])[0]))
    launches = dict(ck.LAUNCHES)
    fallbacks = dict(passes.FALLBACKS)

    def stepped(boundaries, values):
        return [np.float32(values[sum(k >= b for b in boundaries)])
                for k in range(FE_RESNET_STEPS)]
    lr_ok = lrs == stepped(*FE_PIECEWISE)
    ctl_shift = lrs == stepped([b + 1 for b in FE_PIECEWISE[0]],
                               FE_PIECEWISE[1])
    ctl_vals = lrs == stepped(FE_PIECEWISE[0], FE_PIECEWISE[1][::-1])
    del scope, exe
    torch.cuda.empty_cache()
    ms = 1e3 * float(np.mean(times[1:]))

    # the truncated normal at FE_TRUNC values against the law of a
    # standard normal cut at +-2, and its controls: a plain normal draw
    # of the same size, the truncated draw at std 2 and a uniform draw
    # on [-2, 2], each read against std 1's law
    def draw(op_type, **attrs):
        m, s = pt.Program(), pt.Program()
        m.random_seed = seed
        with pt.program_guard(m, s):
            v = m.global_block().create_var(name='v', shape=[FE_TRUNC],
                                            dtype='float32')
            m.global_block().append_op(
                type=op_type, outputs={'Out': v},
                attrs=dict(attrs, shape=[FE_TRUNC], dtype='float32',
                           seed=0))
        val, = pt.Executor().run(m, fetch_list=[v], scope=pt.Scope(),
                                 return_numpy=False)
        t = val.double()
        out = (float(t.abs().max()), float(t.std()), float(t.mean()))
        del val, t
        return out
    law_std = math.sqrt(1 - 4 * math.exp(-2) / math.sqrt(2 * math.pi)
                        / math.erf(2 / math.sqrt(2)))

    def trunc_ok(r):
        return (r[0] <= 2.0 and abs(r[1] / law_std - 1) <= FE_TRUNC_STD
                and abs(r[2]) <= FE_TRUNC_MEAN)
    trunc = draw('truncated_gaussian_random', mean=0.0, std=1.0)
    trunc_ctls = {
        'a plain normal draw': draw('gaussian_random', mean=0.0, std=1.0),
        'the draw at std 2': draw('truncated_gaussian_random', mean=0.0,
                                  std=2.0),
        'a uniform draw on [-2, 2]': draw('uniform_random', min=-2.0,
                                          max=2.0)}

    def trunc_text(r):
        return 'max |x| %.6f, std %.6f, mean %.3g' % r

    # a force_cpu init: the same bits on the card and on the CPU;
    # controls: the same init drawn on the card's generator, and the
    # force_cpu init under another program seed
    def forced(place, seed_, on_cpu=True):
        m, s = pt.Program(), pt.Program()
        s.random_seed = seed_
        with pt.unique_name.guard(), pt.program_guard(m, s):
            with (pt.initializer.init_on_cpu() if on_cpu
                  else contextlib.nullcontext()):
                pt.layers.create_parameter(
                    shape=[1024, 1024], dtype='float32', name='w',
                    default_initializer=pt.initializer.MSRA(uniform=False))
        sc = pt.Scope()
        pt.Executor(place).run(s, scope=sc)
        return pt.fetch_var('w', sc)
    forced_card = forced(pt.CUDAPlace(0), seed)
    forced_same = np.array_equal(forced_card, forced(pt.CPUPlace(), seed))
    ctl_card_gen = np.array_equal(forced(pt.CUDAPlace(0), seed, False),
                                  forced(pt.CPUPlace(), seed))
    ctl_seed = np.array_equal(forced_card, forced(pt.CPUPlace(), seed + 1))
    print('front end 16c: ResNet-50 (3x224x224, 1000 classes), MSRA conv '
          'weights, batch %d, AMP, Momentum(piecewise_decay%s, 0.9), %d '
          'steps: %.2f ms a step after the first (host clock); losses %s; '
          'LRs %s (exactly the intervals\' %s; controls: boundaries one '
          'step late %s, values reversed %s, must be False); %d conv '
          'weights\' std against sqrt(2 / fan_in): worst %.4f (limit %g; '
          'controls: sqrt(1 / fan_in) %.4f, sqrt(2 / fan_out) %.4f, must '
          'fail); launches %s, '
          'fallbacks %s; truncated normal, %d values: %s (limits: max |x| '
          '2, std within %g of %.6f, |mean| %g; controls, must fail: %s); '
          'a force_cpu MSRA init bit-equal on the '
          'card and the CPU: %s (controls: drawn on the card\'s generator '
          '%s, another seed %s, must be False); %s' % (
              RESNET_TRAIN_BATCH, FE_PIECEWISE, FE_RESNET_STEPS, ms,
              ', '.join('%.4f' % l for l in losses),
              ', '.join('%g' % l for l in lrs), lr_ok, ctl_shift, ctl_vals,
              len(fans), std_read, FE_STD, ctl_lecun, ctl_out,
              {n: c for n, c in launches.items() if c}, fallbacks, FE_TRUNC,
              trunc_text(trunc), FE_TRUNC_STD, law_std, FE_TRUNC_MEAN,
              '; '.join('%s %s' % (k, trunc_text(r))
                        for k, r in trunc_ctls.items()),
              forced_same, ctl_card_gen, ctl_seed, card), flush=True)
    check(lr_ok and not ctl_shift and not ctl_vals,
          '16c: the piecewise LRs %s' % lrs)
    check(std_read <= FE_STD and ctl_lecun > FE_STD and ctl_out > FE_STD,
          '16c: MSRA stds off by %g' % std_read)
    check(all(np.isfinite(losses)), '16c: non-finite loss')
    expect = dict.fromkeys(launches, 0)
    expect['fused_conv_stats'] = RESNET_REGIONS * FE_RESNET_STEPS
    check(launches == expect, '16c launches %s, expected %s'
          % (launches, expect))
    check(not fallbacks, '16c fell back: %s' % fallbacks)
    check(trunc_ok(trunc), '16c: the truncated normal draw %s'
          % trunc_text(trunc))
    check(not any(trunc_ok(r) for r in trunc_ctls.values()),
          '16c: the truncated normal limits do not catch their controls')
    check(forced_same and not ctl_card_gen and not ctl_seed,
          '16c: a force_cpu init differs between the card and the CPU')
    torch.cuda.empty_cache()
    print('front end 16c: %.1f s' % (time.perf_counter() - t0), flush=True)
    return launches, ms


def _fe_book(name, seed, card, art_dir):
    """16d, one net: FE_BOOK_STEPS steps on the card and on the CPU from
    one state, each step's loss and probabilities held, and a forward
    run's from each trained state (controls: the CPU one step late, the
    last batch from the parameters before training, the forward run
    from the CPU's state a step short), then saved and served at
    buckets 1-32 (controls: the
    direct run on the next requests' words, and from the parameters
    before training). Returns (ms a step, busy ms of a profiled step,
    {rows: p50 ms})."""
    import torch
    import paddle_tpu_torch as pt
    from paddle_tpu_torch import io as pt_io
    from paddle_tpu_torch.ops import cuda_kernels as ck
    from paddle_tpu_torch.serving.bucketing import pad_feed
    main, startup, book = _book_program(name, seed)
    state = _startup_state(startup)
    feeder = pt.DataFeeder(feed_list=book.feeds, place=pt.CPUPlace(),
                           program=main)
    batches = _book_batches(book, seed + 1)
    feeds = [feeder.feed(next(batches)) for _ in range(FE_BOOK_STEPS)]
    fetch = [book.loss, book.prediction]

    infer = main.clone(for_test=True).prune([book.prediction])

    def train(place, st, fs):
        exe, scope = pt.Executor(place), pt.Scope()
        pt_io.params_from_numpy(scope, st, place)
        outs, times = [], []
        for f in fs:
            t0 = time.perf_counter()
            outs.append(exe.run(main, feed=f, fetch_list=fetch,
                                scope=scope))
            times.append(time.perf_counter() - t0)
        return exe, scope, outs, (1e3 * float(np.mean(times[1:]))
                                  if len(times) > 1 else None)

    def forward(exe, scope):
        return exe.run(infer, feed=feeds[-1], fetch_list=[book.prediction],
                       scope=scope)[0]

    def reading(got, ref):
        return max(_fe_reading({'l': g, 'p': q}, {'l': r, 'p': w})[k]
                   for (g, q), (r, w) in zip(got, ref) for k in 'lp')
    ck.reset_launch_counts()
    exe, card_scope, card_out, ms = train(pt.CUDAPlace(0), state, feeds)
    launches = dict(ck.LAUNCHES)
    trained = _book_state(card_scope)
    # one more step, profiled, on a copy of the trained state
    prof_scope = pt.Scope()
    pt_io.params_from_numpy(prof_scope, trained, pt.CUDAPlace(0))
    _, busy_us = profile_run(
        lambda: exe.run(main, feed=feeds[-1], fetch_list=fetch,
                        scope=prof_scope), 'book %s step' % name, top=4)
    card_fwd = forward(exe, card_scope)
    cpu_exe, cpu_scope, cpu_out, _ = train(pt.CPUPlace(), state, feeds)
    cpu_fwd = forward(cpu_exe, cpu_scope)
    read = reading(card_out, cpu_out)
    fwd_read = _fe_reading({'p': card_fwd}, {'p': cpu_fwd})['p']
    ctl_late = reading(card_out[1:], cpu_out[:-1])
    ctl_untrained = reading(card_out[-1:], train(pt.CPUPlace(), state,
                                                 feeds[-1:])[2])
    short_exe, short_scope, _, _ = train(pt.CPUPlace(), state, feeds[:-1])
    ctl_short = _fe_reading({'p': card_fwd},
                            {'p': forward(short_exe, short_scope)})['p']
    del short_scope
    params = _fe_reading(trained, _book_state(cpu_scope))
    worst = max(params, key=params.get)
    print('front end 16d: book 06 %s, batch %d, f32 (TF32 and AMP off), '
          'Adagrad(0.002), %d steps: %.2f ms a step after the first (host '
          'clock), a profiled step %.3f ms busy on the card; losses %s; each '
          'step\'s loss and probabilities card against CPU: worst %.3g, '
          'the probabilities of a forward run on the last batch from each '
          'trained state %.3g (limit %g; controls: the CPU one step late '
          '%.3g, the last batch from the parameters before training %.3g, '
          'the forward run from the CPU\'s state before its last update '
          '%.3g, must fail); the trained state, not held: worst %.3g of its '
          'scale (%s); launches %s; %s' % (
              name, book.batch_size, FE_BOOK_STEPS, ms, busy_us / 1e3,
              ', '.join('%.4f' % float(np.ravel(o[0])[0])
                        for o in card_out), read, fwd_read, FE_TOL,
              ctl_late, ctl_untrained, ctl_short, params[worst], worst,
              {n: c for n, c in launches.items() if c}, card), flush=True)
    check(read <= FE_TOL and fwd_read <= FE_TOL, '16d %s: the card differs '
          'from the CPU by %g, %g after the last update' % (name, read,
                                                            fwd_read))
    check(ctl_late > FE_TOL and ctl_untrained > FE_TOL and
          ctl_short > FE_TOL,
          '16d %s: the CPU limit does not catch its controls' % name)
    check(not any(launches.values()), '16d %s launched %s (its LSTMs have '
          'peepholes, its convs are sequence convs)' % (name, launches))

    # saved, loaded, served at buckets 1-32
    d = os.path.join(art_dir, name)
    pt_io.save_inference_model(d, ['words'], [book.prediction], exe,
                               main_program=main, scope=card_scope)
    load_scope = pt.Scope()
    prog, _, fetch_vars = pt_io.load_inference_model(d, exe,
                                                     scope=load_scope)
    requests = _book_batches(book, 97, BOOK_SERVE_MAX)
    samples, other = next(requests), next(requests)
    untrained = pt.Scope()
    pt_io.params_from_numpy(untrained, state, pt.CUDAPlace(0))

    def direct(rows, r, b, scope):
        padded = pad_feed({'words': feeder.feed(rows[:r])['words']}, r, b,
                          server.policy.pad_mode)
        return exe.run(prog, feed=padded, fetch_list=fetch_vars,
                       scope=scope)[0][:r]
    server = pt.serving.ModelServer(pt.CUDAPlace(0),
                                    max_batch_size=BOOK_SERVE_MAX)
    equal, ctl_other, ctl_params, p50 = 0, 0, 0, {}
    try:
        server.load_model(name, d)
        for r in BOOK_REQUESTS:
            b = server.policy.bucket_for(r)
            ref = direct(samples, r, b, load_scope)
            words = {'words': feeder.feed(samples[:r])['words']}
            times = []
            for _ in range(FE_SERVE_REPS + 1):
                t0 = time.perf_counter()
                got, = server.infer(name, words)
                times.append(time.perf_counter() - t0)
                equal += int(got.shape == ref.shape and
                             np.array_equal(got, ref))
            p50[r] = 1e3 * float(np.median(times[1:]))
            ctl_other += int(np.array_equal(got, direct(other, r, b,
                                                        load_scope)))
            ctl_params += int(np.array_equal(got, direct(samples, r, b,
                                                         untrained)))
        buckets = [server.policy.bucket_for(r) for r in BOOK_REQUESTS]
    finally:
        server.close()
    n = len(BOOK_REQUESTS) * (FE_SERVE_REPS + 1)
    print('front end 16d: book 06 %s served through ModelServer(CUDAPlace('
          '0)), f32, requests of %s sequences (buckets %s): p50 %s ms (host '
          'clock, of %d each); %d of %d answers bit-equal to a direct run '
          'padded to the bucket (controls bit-equal, must be 0 of %d: the '
          'next requests\' words %d, the parameters before training %d)' % (
              name, BOOK_REQUESTS, buckets, ', '.join(
                  '%d rows %.2f' % kv for kv in sorted(p50.items())),
              FE_SERVE_REPS, equal, n, len(BOOK_REQUESTS), ctl_other,
              ctl_params), flush=True)
    check(equal == n, '16d %s: %d of %d served answers off a padded direct '
          'run' % (name, n - equal, n))
    check(ctl_other == 0 and ctl_params == 0, '16d %s: a serving control '
          'matched' % name)
    del card_scope, load_scope, untrained, prof_scope
    torch.cuda.empty_cache()
    return ms, busy_us / 1e3, p50


def phase_front_end(seed, card, art_dir, flagship_ms=None):
    """16. Training's front end on the card: every new optimizer on
    mnist against the CPU (16a), the flagship under noam_decay (16b;
    ``flagship_ms``: phase 7's ms a step, printed beside), ResNet-50
    under piecewise_decay with MSRA weights, the truncated normal and a
    host-drawn init (16c), book 06 trained against the CPU and served
    (16d). Returns the kernel launches of 16a-16c."""
    import torch
    from paddle_tpu_torch.core import amp
    t_phase = time.perf_counter()
    amp.set_amp(False)
    try:
        mnist_launches = _fe_optimizers(seed, card)
    finally:
        amp.set_amp(None)
    torch.cuda.empty_cache()
    flash_launches, noam_ms = _fe_flagship(seed, card)
    if flagship_ms is not None:
        print('front end 16b: %.2f ms a step under noam_decay against '
              'phase 7\'s %.2f at Adam(1e-4)' % (noam_ms, flagship_ms),
              flush=True)
    stats_launches, _ = _fe_resnet(seed, card)
    t0 = time.perf_counter()
    amp.set_amp(False)
    try:
        for name in FE_BOOK_NETS:
            _fe_book(name, seed, card, art_dir)
    finally:
        amp.set_amp(None)
    print('front end 16d: %.1f s' % (time.perf_counter() - t0), flush=True)
    print('phase 16: %.1f s' % (time.perf_counter() - t_phase), flush=True)
    total = dict.fromkeys(mnist_launches, 0)
    for part in (mnist_launches, flash_launches, stats_launches):
        for n, c in part.items():
            total[n] += c
    return total


# ---- phase 17: sparse rows, calc_gradient, books 05 and 07 ------------------------
# 17a: stacked_dynamic_lstm (phase 13's widths, use_peepholes=False, the
# lstm_cell kernel path) with its table is_sparse=True under
# set_sparse_fallback_threshold(0), SP_STEPS steps each under SGD,
# Adagrad and Adam, f32 (TF32 and AMP off)
SP_BATCH = LSTM_BATCH                  # 256 sequences of LSTM_WORDS words
SP_CPU_BATCH = 16                      # the card against the CPU here
SP_STEPS = 3
SP_CPU_STEPS = 2                       # steps of that comparison: the
                                       # CPU's steps are the phase's
                                       # slowest part
# rates at which 3 steps stay stable: Adagrad and Adam move every weight
# by about the rate on their first step, and Adagrad(0.01) sent this
# model's loss from 0.69 to 9.21 in 3 steps
SP_OPTS = (('SGD', 0.01), ('Adagrad', 1e-4), ('Adam', 1e-4))
SP_TOL = 1e-4                          # card vs CPU: max(SP_TOL, 3x witness)
SP_WITNESS_FACTOR = 3.0
SP_WITNESS_SCALES = tuple(np.float32(1 + e) for e in (2.0 ** -22,
                                                      -2.0 ** -22))
SP_DENSE_TOL = 1e-5                    # a sparse step against the dense
                                       # one from the same state, of the
                                       # table's largest magnitude (the
                                       # duplicate ids summed in another
                                       # order); run free, the steps after
                                       # the first part further: the LSTM
                                       # amplifies the rounding of each
# 17b: word2vec at book 04's widths at dict 2^20: a 2^20 x 32 table is
# 2^25 elements, the threshold itself, so is_sparse=True stays sparse
SP_W2V_DICT = 1 << 20
SP_W2V_WARMUP, SP_W2V_STEPS = 2, 5
# 17c: calc_gradient
SP_GRAD_BATCH = GRAD_BATCH             # the flagship's input gradient
SP_MNIST_BATCH = BENCH_BATCH
SP_GP = dict(inputs=64, hidden=128, batch=32, lam=0.5, lr=0.05, steps=3)
SP_GRAD_TOL = 1e-4                     # f32 card vs CPU, of the scale
SP_CLOSED_TOL = 1e-5                   # the penalty's gradient vs f64
# 17d: books 05 and 07 at the scripts' widths
SP_BOOK_STEPS = 3
SP_BOOK_TOL = 1e-4                     # f32 card vs CPU, of the scale
SP_TIE = 1e-5                          # a Viterbi parting is excused only
                                       # where the two paths' CPU scores
                                       # lie within this of their scale
SP_SERVE_REPS = 3


def _sp_lstm_program(seed, opt_name, lr, sparse):
    """stacked_dynamic_lstm (no peepholes) under ``opt_name``; its table
    sparse (the threshold set to 0 while it is built) or dense."""
    import paddle_tpu_torch as pt
    main, startup = pt.Program(), pt.Program()
    startup.random_seed = seed
    prev = pt.layers.nn.set_sparse_fallback_threshold(0)
    try:
        with pt.unique_name.guard(), pt.program_guard(main, startup):
            loss, _ = stacked_dynamic_lstm(pt, use_peepholes=False,
                                           is_sparse=sparse, **LSTM)
            getattr(pt.optimizer, opt_name)(learning_rate=lr).minimize(loss)
    finally:
        pt.layers.nn.set_sparse_fallback_threshold(prev)
    marker = [op for op in main.global_block().ops
              if op.type == 'backward_marker'][0]
    check(bool(marker.attrs['sparse']) is sparse, '17a: the sparse record '
          'is %s' % marker.attrs['sparse'])
    return main, startup, loss


def _sp_run(main, loss, place, state, feeds, table='embedding_0.w_0',
            states=None):
    """The steps from ``state``: (losses, the table after each step,
    every persistable at the end, ms a step after the first). With a
    list ``states``, the scope's state after each step is appended to
    it."""
    import torch
    import paddle_tpu_torch as pt
    from paddle_tpu_torch import io as pt_io
    exe, scope = pt.Executor(place), pt.Scope()
    pt_io.params_from_numpy(scope, state, place)
    losses, tables, times = [], [], []
    for f in feeds:
        t0 = time.perf_counter()
        losses.append(exe.run(main, feed=f, fetch_list=[loss],
                              scope=scope)[0])
        times.append(time.perf_counter() - t0)
        tables.append(pt.fetch_var(table, scope))
        if states is not None:
            states.append(_book_state(scope))
    if place.torch_device().type == 'cuda':
        torch.cuda.synchronize()
    out = {n: pt.fetch_var(n, scope) for n in sorted(
        v.name for v in main.list_vars() if v.persistable)
        if scope.raw(n) is not None}
    out.update(('loss %d' % i, l) for i, l in enumerate(losses))
    return losses, tables, out, (1e3 * float(np.mean(times[1:]))
                                 if len(times) > 1 else None)


def _merge_drops_duplicates(rows, ids):
    """The 17a control: one row kept per distinct id, the others dropped
    instead of summed."""
    import torch
    uids, inv = torch.unique(ids, return_inverse=True)
    first = torch.full((uids.shape[0],), rows.shape[0], dtype=torch.long,
                       device=ids.device)
    first.scatter_reduce_(0, inv, torch.arange(ids.shape[0],
                                               device=ids.device), 'amin')
    return rows[first], uids


def _sgd_drops_duplicates(ctx):
    """The 17a control for SGD: one row kept per distinct id and
    written, instead of every row added."""
    from paddle_tpu_torch.core.lowering import SparseRows
    from paddle_tpu_torch.ops import optim_ops
    p, g = ctx.input('Param'), ctx.input('Grad')
    if not isinstance(g, SparseRows):
        return optim_ops._sgd(ctx)
    agg, uids = _merge_drops_duplicates(*optim_ops._all_rows(g,
                                                             p.shape[1]))
    sel = uids.clamp(0, g.vocab - 1)
    ctx.set_output('ParamOut', optim_ops._scatter(
        p, uids, p[sel] - ctx.input('LearningRate').reshape(()) * agg,
        add=False))


@contextlib.contextmanager
def _duplicates_dropped(opt_name):
    """Run the sparse updates with duplicate ids dropped (the 17a
    controls): SGD's scatter, or Adagrad's and Adam's merge."""
    from paddle_tpu_torch.ops import optim_ops
    if opt_name == 'SGD':
        with _kernel_swapped('sgd', _sgd_drops_duplicates):
            yield
        return
    merge = optim_ops._merge_rows
    optim_ops._merge_rows = _merge_drops_duplicates
    try:
        yield
    finally:
        optim_ops._merge_rows = merge


@contextlib.contextmanager
def _rows_one_id_off():
    """Run the sparse updates with every row written one id further on
    (the 17a control of a scatter's index)."""
    from paddle_tpu_torch.ops import optim_ops
    scatter = optim_ops._scatter
    optim_ops._scatter = lambda p, ids, vals, add: scatter(
        p, (ids + 1) % p.shape[0], vals, add)
    try:
        yield
    finally:
        optim_ops._scatter = scatter


def _sp_table_reading(got, ref):
    return float(np.abs(got.astype('float64') - ref).max() /
                 max(np.abs(ref).max(), 1e-30))


def _sp_lstm(seed, card):
    """17a. Returns the lstm_cell launches of the sparse runs."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.ops import cuda_kernels as ck
    t0 = time.perf_counter()
    feeds = [_lstm_feed([LSTM_WORDS] * SP_BATCH, seed + 171 + i)
             for i in range(SP_STEPS)]
    cpu_feeds = [_lstm_feed([LSTM_WORDS] * SP_CPU_BATCH, seed + 181 + i)
                 for i in range(SP_CPU_STEPS)]
    touched = [np.unique(np.asarray(f['data'].data)) for f in feeds]
    untouched = np.setdiff1d(np.arange(LSTM['dict_size']),
                             np.concatenate(touched))
    resting = np.setdiff1d(np.concatenate(touched[:-1]), touched[-1])
    launches = 0
    for opt_name, lr in SP_OPTS:
        main, startup, loss = _sp_lstm_program(seed, opt_name, lr, True)
        d_main, _, d_loss = _sp_lstm_program(seed, opt_name, lr, False)
        state = _startup_state(startup)
        table0 = state['embedding_0.w_0']
        # the card against the CPU, at SP_CPU_BATCH
        ref = _sp_run(main, loss, pt.CPUPlace(), state, cpu_feeds)[2]
        witness = 0.0
        for scale in SP_WITNESS_SCALES:
            nudged = dict(state, **{'embedding_0.w_0': table0 * scale})
            witness = max(witness, max(_fe_reading(_sp_run(
                main, loss, pt.CPUPlace(), nudged, cpu_feeds)[2],
                ref).values()))
        limit = max(SP_TOL, SP_WITNESS_FACTOR * witness)
        got = _sp_run(main, loss, pt.CUDAPlace(0), state, cpu_feeds)[2]
        readings = _fe_reading(got, ref)
        worst = max(readings, key=readings.get)
        late = _fe_reading(_sp_run(main, loss, pt.CUDAPlace(0), state,
                                   cpu_feeds[1:] + cpu_feeds[:1])[2], ref)
        ctl_late = max(late.values())
        # sparse against dense on the card, at SP_BATCH
        ck.reset_launch_counts()
        s_losses, s_tables, _, s_ms = _sp_run(main, loss, pt.CUDAPlace(0),
                                              state, feeds)
        run_launches = dict(ck.LAUNCHES)
        launches += run_launches['lstm_cell']
        d_states = [state]
        d_losses, d_tables, _, d_ms = _sp_run(d_main, d_loss,
                                              pt.CUDAPlace(0), state, feeds,
                                              states=d_states)
        pending = []

        def later(cond, msg):
            pending.append((cond, msg))

        # each step from the dense path's state before it: the same
        # forward, the duplicate ids summed in another order (Adam's
        # lazy rows part from the dense path after its first step)
        steps = range(SP_STEPS if opt_name != 'Adam' else 1)

        def one_step(k):
            return _sp_run(main, loss, pt.CUDAPlace(0), d_states[k],
                           feeds[k:k + 1])[1][0]
        stepped = [one_step(k) for k in steps]
        with _duplicates_dropped(opt_name):
            dropped = [one_step(k) for k in steps]
        with _rows_one_id_off():
            off = [one_step(k) for k in steps]
        step_read = [_sp_table_reading(g, d_tables[k])
                     for k, g in zip(steps, stepped)]
        ctl = [('a step short', [_sp_table_reading(
                    d_states[k]['embedding_0.w_0'], d_tables[k])
                    for k in steps]),
               ('duplicates dropped', [_sp_table_reading(g, d_tables[k])
                                       for k, g in zip(steps, dropped)]),
               ('the rows written one id off', [
                   _sp_table_reading(g, d_tables[k])
                   for k, g in zip(steps, off)])]
        gate = 'each step\'s sparse table from the dense path\'s state '\
            'before it, against the dense step: %s (limit %g; controls, '\
            'the smallest of the steps: %s); run free from the start, '\
            'the sparse table against the dense one after each step %s, '\
            'the table\'s largest magnitude %.4g' % (
                ', '.join('%.3g' % r for r in step_read), SP_DENSE_TOL,
                ', '.join('%s %.3g' % (n, min(v)) for n, v in ctl),
                ', '.join('%.3g' % _sp_table_reading(a, b)
                          for a, b in zip(s_tables, d_tables)),
                np.abs(table0).max())
        later(max(step_read) <= SP_DENSE_TOL, '17a %s: a sparse step '
              'differs from the dense one by %g' % (opt_name,
                                                    max(step_read)))
        later(all(min(v) > SP_DENSE_TOL for _, v in ctl), '17a %s: the '
              'limit does not catch its controls %s' % (opt_name, ctl))
        if opt_name == 'Adam':
            still = np.array_equal(s_tables[-1][untouched],
                                   table0[untouched])
            rest = np.array_equal(s_tables[-1][resting],
                                  s_tables[-2][resting])
            ctl_dense = np.array_equal(d_tables[-1][resting],
                                       d_tables[-2][resting])
            ctl_still = np.array_equal(s_tables[-1][resting],
                                       table0[resting])
            gate += '; after step %d the %d rows no batch touched ' \
                'bit-equal to the initial table: %s (control: the rows the '\
                'last batch left out, must not be: %s); those %d rows '\
                'bit-equal to step %d\'s: %s (control: the dense path\'s, '\
                'must not be: %s)' % (SP_STEPS, len(untouched), still,
                                      ctl_still, len(resting), SP_STEPS - 1,
                                      rest, ctl_dense)
            later(len(untouched) > 0 and len(resting) > 0 and still and
                  rest, '17a Adam: lazy rows moved')
            later(not ctl_dense and not ctl_still, '17a Adam: the lazy '
                  'rows\' gates do not catch their controls')
        print('sparse 17a: stacked_dynamic_lstm %s, table is_sparse=True, '
              '%s, f32 (TF32 and AMP off): card against CPU at batch %d, '
              '%d tensors (parameters, accumulators, losses), worst %.3g '
              '(%s; limit %.3g: max(%g, %g x the witness, the CPU against '
              'itself on the table moved by +-2^-22: %.3g); control: the '
              'card a batch late %.3g, must fail); at batch %d: %.2f ms a '
              'step sparse, %.2f dense (host clock); losses %s sparse, %s '
              'dense; %s; lstm_cell launches %d (expected %d); %s' % (
                  LSTM, '%s(%g)' % (opt_name, lr), SP_CPU_BATCH,
                  len(readings), readings[worst], worst, limit, SP_TOL,
                  SP_WITNESS_FACTOR, witness, ctl_late, SP_BATCH, s_ms, d_ms,
                  ', '.join('%.5f' % float(np.ravel(l)[0])
                            for l in s_losses),
                  ', '.join('%.5f' % float(np.ravel(l)[0])
                            for l in d_losses), gate,
                  run_launches['lstm_cell'], LSTM_LAUNCHES * SP_STEPS,
                  card), flush=True)
        for cond, msg in pending:
            check(cond, msg)
        check(readings[worst] <= limit, '17a %s: the card differs from the '
              'CPU by %g (%s)' % (opt_name, readings[worst], worst))
        check(ctl_late > limit, '17a %s: the CPU limit does not catch a '
              'batch late' % opt_name)
        expect = dict.fromkeys(run_launches, 0)
        expect['lstm_cell'] = LSTM_LAUNCHES * SP_STEPS
        check(run_launches == expect, '17a %s launches %s, expected %s'
              % (opt_name, run_launches, expect))
    print('sparse 17a: %.1f s' % (time.perf_counter() - t0), flush=True)
    return launches


def _sp_word2vec(seed, card):
    """17b. word2vec at dict 2^20: the sparse path against the dense one
    (the threshold above the table) under SGD and Adam."""
    import torch
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.models import books
    from torch.profiler import profile, ProfilerActivity, record_function
    t0 = time.perf_counter()
    rng = np.random.RandomState(seed + 172)
    feeds = [{n: rng.randint(0, SP_W2V_DICT, (32, 1)).astype('int64')
              for n in ('firstw', 'secondw', 'thirdw', 'forthw', 'nextw')}
             for _ in range(SP_W2V_WARMUP + SP_W2V_STEPS + 1)]
    for opt_name in ('SGD', 'Adam'):
        for sparse in (True, False):
            prev = pt.layers.nn.set_sparse_fallback_threshold(
                pt.layers.nn._SPARSE_MIN_TABLE_ELEMS[0] if sparse else
                SP_W2V_DICT * 32 + 1)
            try:
                main, startup = pt.Program(), pt.Program()
                startup.random_seed = seed
                with pt.unique_name.guard(), pt.program_guard(main,
                                                              startup):
                    book = books.word2vec(dict_size=SP_W2V_DICT)
                    getattr(pt.optimizer, opt_name)(
                        learning_rate=0.001).minimize(book.loss)
            finally:
                pt.layers.nn.set_sparse_fallback_threshold(prev)
            marker = [op for op in main.global_block().ops
                      if op.type == 'backward_marker'][0]
            check(bool(marker.attrs['sparse']) is sparse, '17b: the record '
                  '%s' % marker.attrs['sparse'])
            exe, scope = pt.Executor(), pt.Scope()
            exe.run(startup, scope=scope)
            update = getattr(pt.ops.optim_ops, '_' + opt_name.lower())
            events = []

            def timed_update(ctx):
                # the table's update op alone: a profiler range and CUDA
                # events around it
                if ctx.op.inputs['Param'][0] != 'shared_w':
                    return update(ctx)
                ev = (torch.cuda.Event(enable_timing=True),
                      torch.cuda.Event(enable_timing=True))
                ev[0].record()
                with record_function('17b table update'):
                    update(ctx)
                ev[1].record()
                events.append(ev)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            losses, times = [], []
            with _kernel_swapped(opt_name.lower(), timed_update):
                for i, f in enumerate(feeds[:-1]):
                    t1 = time.perf_counter()
                    losses.append(float(np.ravel(exe.run(
                        main, feed=f, fetch_list=[book.loss],
                        scope=scope)[0])[0]))
                    if i >= SP_W2V_WARMUP:
                        times.append(time.perf_counter() - t1)
                torch.cuda.synchronize()
                peak = torch.cuda.max_memory_allocated() / 2 ** 30
                upd_ms = float(np.median([a.elapsed_time(b) for a, b in
                                          events[SP_W2V_WARMUP:]]))
                with profile(activities=[ProfilerActivity.CPU,
                                         ProfilerActivity.CUDA]) as prof:
                    exe.run(main, feed=feeds[-1], fetch_list=[book.loss],
                            scope=scope)
                    torch.cuda.synchronize()
            kernels = [e for e in prof.events()
                       if e.device_type == torch.autograd.DeviceType.CUDA]
            busy = sum(e.device_time for e in kernels) / 1e3
            rng_ms = sum(getattr(e, 'device_time_total', 0.0)
                         for e in prof.events()
                         if e.name == '17b table update') / 1e3
            by_kind = {}
            for e in kernels:
                k = _kernel_kind(e.name)
                by_kind[k] = by_kind.get(k, 0.0) + e.device_time / 1e3
            print('sparse 17b: word2vec (N 5, embedding 32, fc 256, the '
                  'shared table looked up 4 times) at dict %d (table %d '
                  'elements = %d MiB f32, threshold %d), batch 32, %s(0.001),'
                  ' %s path: %.2f ms a step (host clock, median of %d), the '
                  'table\'s update op %.4f ms on the card (CUDA events, '
                  'median) and %.4f ms in the profile\'s range, a profiled '
                  'step %.3f ms busy by kind %s; peak memory %.3f GiB; '
                  'losses %s; %s' % (
                      SP_W2V_DICT, SP_W2V_DICT * 32, SP_W2V_DICT * 32 * 4
                      >> 20, pt.layers.nn._SPARSE_MIN_TABLE_ELEMS[0],
                      opt_name, 'sparse' if sparse else 'dense',
                      1e3 * float(np.median(times)), len(times), upd_ms,
                      rng_ms, busy, ', '.join(
                          '%s %.3f' % kv for kv in sorted(
                              by_kind.items(), key=lambda kv: -kv[1])),
                      peak, ', '.join('%.4f' % l for l in losses), card),
                  flush=True)
            check(np.isfinite(losses).all(), '17b: non-finite loss')
            del exe, scope
            torch.cuda.empty_cache()
    print('sparse 17b: %.1f s' % (time.perf_counter() - t0), flush=True)


def _sp_flagship_input_grad(seed, card):
    """17c-i. The flagship's loss against its embedded tokens, kernels
    against the plain attention on the card."""
    import torch
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.models.fluid_transformer import transformer
    from paddle_tpu_torch.ops import cuda_kernels as ck, misc_ops
    main, startup = pt.Program(), pt.Program()
    startup.random_seed = seed
    with pt.unique_name.guard(), pt.program_guard(main, startup):
        loss = transformer(None, **FLAGSHIP)[0]
        emb = [op for op in main.global_block().ops
               if op.type == 'lookup_table'][0].outputs['Out'][0]
        g, = pt.calc_gradient(loss, main.global_block().var(emb))
    exe, scope = pt.Executor(), pt.Scope()
    exe.run(startup, scope=scope)
    feed = _train_feed(SP_GRAD_BATCH, seed + 173)

    def grad():
        out, = exe.run(main, feed=feed, fetch_list=[g], scope=scope,
                       return_numpy=False)
        torch.cuda.synchronize()
        return {'emb@GRAD': out}
    ck.reset_launch_counts()
    t0 = time.perf_counter()
    kernel = grad()
    ms = 1e3 * (time.perf_counter() - t0)
    launches = dict(ck.LAUNCHES)
    with misc_ops.attention_for_testing():
        plain = grad()
    err = _rel_l2(kernel, plain)['emb@GRAD']
    ctl = {}
    for mode in ('dq dropped', 'dk/dv of the next head'):
        with misc_ops.attention_for_testing(_wrong_backward(mode)):
            ctl[mode] = _rel_l2(grad(), plain)['emb@GRAD']
    n = FLAGSHIP['n_layers']
    print('calc_gradient 17c: the flagship %s, batch %d, AMP: d loss / d '
          'embedded tokens %s in %.2f ms (host clock, one run); kernels '
          'against the plain attention (autograd backward), relative L2 '
          '%.3g (limit %g; controls: %s, must fail); launches %s (the '
          'forward runs once before the marker and again in its replay); '
          '%s' % (FLAGSHIP, SP_GRAD_BATCH, tuple(kernel['emb@GRAD'].shape),
                  ms, err, PLAIN_GRAD_TOL, ', '.join(
                      '%s %.3g' % kv for kv in ctl.items()),
                  {k: c for k, c in launches.items() if c}, card),
          flush=True)
    check(bool(torch.isfinite(kernel['emb@GRAD']).all()) and
          float(kernel['emb@GRAD'].abs().max()) > 0, '17c: the flagship\'s '
          'input gradient')
    check(err <= PLAIN_GRAD_TOL, '17c: the flagship\'s input gradient '
          'differs from the plain attention\'s by %g' % err)
    check(all(c > PLAIN_GRAD_TOL for c in ctl.values()), '17c: the limit '
          'does not catch a wrong backward: %s' % ctl)
    expect = dict.fromkeys(launches, 0)
    expect.update(flash_attn_fwd=2 * n, flash_attn_bwd_dkvdq=n)
    check(launches == expect, '17c launches %s, expected %s'
          % (launches, expect))
    del scope, exe
    torch.cuda.empty_cache()
    return launches


def _sp_mnist_input_grad(seed, card):
    """17c-ii. mnist's loss against its images through the fused conv,
    card against CPU (f32, TF32 and AMP off)."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch import io as pt_io
    from paddle_tpu_torch.compiler import passes
    from paddle_tpu_torch.ops import cuda_kernels as ck
    main, startup, loss, _ = _bench_program('mnist', seed, train=False)
    with pt.program_guard(main, startup):
        g, = pt.calc_gradient(loss, main.global_block().var('data'))
    state = _startup_state(startup)
    rng = np.random.RandomState(seed + 174)
    feeds = [{'data': rng.randn(SP_MNIST_BATCH, 1, 28, 28).astype('float32'),
              'label': rng.randint(0, 10, (SP_MNIST_BATCH, 1)).astype(
                  'int64')} for _ in range(2)]

    def run(place, st, f):
        exe, scope = pt.Executor(place), pt.Scope()
        pt_io.params_from_numpy(scope, st, place)
        return exe.run(main, feed=f, fetch_list=[loss, g], scope=scope)
    ck.reset_launch_counts()
    passes.reset_fallback_counts()
    got = run(pt.CUDAPlace(0), state, feeds[0])
    launches = dict(ck.LAUNCHES)
    variants = {v: c for v, c in ck.FUSED_CONV_VARIANT_LAUNCHES.items()
                if c}
    ref = run(pt.CPUPlace(), state, feeds[0])
    reading = max(_fe_reading({'l': got[0], 'g': got[1]},
                              {'l': ref[0], 'g': ref[1]}).values())
    ctl_batch = _fe_reading({'g': got[1]}, {'g': run(
        pt.CPUPlace(), state, feeds[1])[1]})['g']
    moved = {n: v * np.float32(1.01) if v.dtype.kind == 'f' else v
             for n, v in state.items()}
    ctl_params = _fe_reading({'g': got[1]}, {'g': run(
        pt.CPUPlace(), moved, feeds[0])[1]})['g']
    print('calc_gradient 17c: mnist, batch %d, f32 (TF32 and AMP off): d '
          'loss / d images %s card against CPU %.3g of the scale (limit %g; '
          'controls: the next batch\'s images %.3g, the weights times 1.01 '
          '%.3g, must fail); launches %s by variant %s (2 regions before '
          'the marker and 2 in its replay), fallbacks %s; %s' % (
              SP_MNIST_BATCH, got[1].shape, reading, SP_GRAD_TOL, ctl_batch,
              ctl_params, {k: c for k, c in launches.items() if c},
              variants, dict(passes.FALLBACKS), card), flush=True)
    check(reading <= SP_GRAD_TOL, '17c: mnist\'s input gradient differs '
          'from the CPU\'s by %g' % reading)
    check(ctl_batch > SP_GRAD_TOL and ctl_params > SP_GRAD_TOL,
          '17c: the mnist limit does not catch its controls')
    expect = dict.fromkeys(launches, 0)
    expect['fused_conv'] = 2 * BENCH_REGIONS['mnist']
    check(launches == expect, '17c mnist launches %s, expected %s'
          % (launches, expect))
    want = {v: 2 * c for v, c in BENCH_VARIANTS['mnist']['float32'].items()}
    check(variants == want, '17c mnist: the fused conv by variant %s, '
          'expected %s' % (variants, want))
    check(not passes.FALLBACKS, '17c mnist fell back: %s'
          % passes.FALLBACKS)
    return launches


def _sp_penalty_program(seed, train):
    """An MLP x -> fc tanh -> fc 1 with its gradient against x (gp) and
    the gradient of sum(gp^2) against x (gg); with ``train`` the loss
    mean(out) + lam * mean(gp^2) under SGD."""
    import paddle_tpu_torch as pt
    L = pt.layers
    main, startup = pt.Program(), pt.Program()
    startup.random_seed = seed
    with pt.unique_name.guard(), pt.program_guard(main, startup):
        x = L.data(name='x', shape=[SP_GP['inputs']], dtype='float32')
        h = L.fc(input=x, size=SP_GP['hidden'], act='tanh')
        out = L.fc(input=h, size=1)
        gp, = pt.calc_gradient(L.reduce_sum(out), x)
        pen = L.reduce_sum(L.square(gp))
        gg, = pt.calc_gradient(pen, x)
        fetch = [out, gp, gg]
        if train:
            loss = L.elementwise_add(L.mean(out), L.scale(
                L.reduce_mean(L.square(gp)), scale=SP_GP['lam']))
            pt.optimizer.SGD(learning_rate=SP_GP['lr']).minimize(loss)
            fetch = [loss, gp] + ['%s@GRAD' % p.name for p in
                                  main.global_block().all_parameters()]
    return main, startup, fetch


def _sp_closed_penalty(x, w1, b1, w2, wrong_sign=False):
    """d sum(gp^2) / dx for f(x) = tanh(x W1 + b1) W2, in f64:
    gp = (W2^T * (1 - t^2)) W1^T; with ``wrong_sign`` (the control) the
    tanh's second derivative enters with the wrong sign."""
    x, w1, b1, w2 = (np.asarray(a, 'float64') for a in (x, w1, b1, w2))
    t = np.tanh(x @ w1 + b1)
    u = w2[:, 0] * (1 - t ** 2)                       # [N, H]
    gp = u @ w1.T                                     # [N, D]
    du = 2 * gp @ w1                                  # d P / d u
    dz = du * w2[:, 0] * (2 if wrong_sign else -2) * t * (1 - t ** 2)
    return gp, dz @ w1.T


def _sp_penalty(seed, card):
    """17c-iii. A gradient penalty (grad-of-grad) on an MLP: against the
    closed form and the CPU; then trained 3 SGD steps through the
    markers, card against CPU."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch import io as pt_io
    rng = np.random.RandomState(seed + 175)
    xs = [rng.randn(SP_GP['batch'], SP_GP['inputs']).astype('float32')
          for _ in range(SP_GP['steps'])]
    main, startup, fetch = _sp_penalty_program(seed, False)
    state = _startup_state(startup)

    def run(m, f, place, st, feeds):
        exe, scope = pt.Executor(place), pt.Scope()
        pt_io.params_from_numpy(scope, st, place)
        return [exe.run(m, feed={'x': x}, fetch_list=f, scope=scope)
                for x in feeds]
    (out, gp, gg), = run(main, fetch, pt.CUDAPlace(0), state, xs[:1])
    (_, c_gp, c_gg), = run(main, fetch, pt.CPUPlace(), state, xs[:1])
    # fc_0's weight and bias, fc_1's weight, in creation order
    w = [state[p.name] for p in main.global_block().all_parameters()][:3]
    want_gp, want_gg = _sp_closed_penalty(xs[0], *w)
    _, ctl_gg = _sp_closed_penalty(xs[0], *w, wrong_sign=True)

    def rel(a, b):
        return float(np.abs(np.asarray(a, 'float64') - b).max() /
                     max(np.abs(b).max(), 1e-30))
    closed = max(rel(gp, want_gp), rel(gg, want_gg))
    ctl_closed = rel(gg, ctl_gg)
    cpu = max(rel(gp, c_gp), rel(gg, c_gg))
    ctl_cpu = rel(gg, run(main, fetch, pt.CPUPlace(), state, xs[1:2])[0][2])
    t_main, t_startup, t_fetch = _sp_penalty_program(seed, True)
    t_state = _startup_state(t_startup)
    card_steps = run(t_main, t_fetch, pt.CUDAPlace(0), t_state, xs)
    cpu_steps = run(t_main, t_fetch, pt.CPUPlace(), t_state, xs)
    train = max(rel(a, b) for cs, ps in zip(card_steps, cpu_steps)
                for a, b in zip(cs, ps))
    ctl_train = max(rel(a, b) for cs, ps in zip(card_steps[1:],
                                                cpu_steps[:-1])
                    for a, b in zip(cs, ps))
    print('calc_gradient 17c: a gradient penalty on an MLP (%d -> %d tanh '
          '-> 1), batch %d, f32 (TF32 and AMP off): gp and d sum(gp^2) / dx '
          'against the closed form in f64 %.3g (limit %g; control: the '
          'tanh\'s curvature of the wrong sign %.3g, must fail), card against CPU %.3g '
          '(limit %g; control: the next batch %.3g); %d SGD steps on '
          'mean(out) + %g mean(gp^2) through both markers, loss, gp and '
          'both weight gradients card against CPU %.3g (control: the CPU a '
          'step late %.3g, must fail); losses %s; %s' % (
              SP_GP['inputs'], SP_GP['hidden'], SP_GP['batch'], closed,
              SP_CLOSED_TOL, ctl_closed, cpu, SP_GRAD_TOL, ctl_cpu,
              SP_GP['steps'], SP_GP['lam'], train, ctl_train,
              ', '.join('%.5f' % float(np.ravel(s[0])[0])
                        for s in card_steps), card), flush=True)
    check(closed <= SP_CLOSED_TOL and ctl_closed > SP_CLOSED_TOL,
          '17c: the penalty against its closed form %g (control %g)'
          % (closed, ctl_closed))
    check(cpu <= SP_GRAD_TOL and ctl_cpu > SP_GRAD_TOL, '17c: the penalty '
          'card against CPU %g (control %g)' % (cpu, ctl_cpu))
    check(train <= SP_GRAD_TOL and ctl_train > SP_GRAD_TOL, '17c: penalty '
          'training card against CPU %g (control %g)' % (train, ctl_train))


def _sp_rows(v):
    """A fetch as a list of rows: a sequence's with its padding cut."""
    import paddle_tpu_torch as pt
    if isinstance(v, pt.SequenceTensor):
        data, lens = np.asarray(v.data), np.asarray(v.lengths)
        return [data[b, :lens[b]] for b in range(len(lens))]
    return list(np.asarray(v))


def _sp_viterbi_score(em, trans, path):
    """A path's score under the emissions [T, S] and the transitions."""
    em, trans = np.asarray(em, 'float64'), np.asarray(trans, 'float64')
    s = trans[0, path[0]] + trans[1, path[-1]] + sum(
        em[t, p] for t, p in enumerate(path))
    return s + sum(trans[2 + a, b] for a, b in zip(path[:-1], path[1:]))


def _sp_book(name, seed, card, art_dir):
    """17d, one book: SP_BOOK_STEPS steps card against CPU from one
    state, then saved, loaded and served as sequences. Returns ms a step
    and the busy share of a profiled step."""
    import torch
    import paddle_tpu_torch as pt
    from paddle_tpu_torch import io as pt_io
    from paddle_tpu_torch.models import books
    from paddle_tpu_torch.serving.bucketing import pad_feed
    main, startup, book = _book_program(name, seed)
    state = _startup_state(startup)
    srl = name == 'label_semantic_roles'
    if srl:
        state['emb'] = books.srl_embedding()
        for v in book.evaluator.states:
            state[v.name] = np.zeros([1], 'int64')
    feeder = pt.DataFeeder(feed_list=book.feeds, place=pt.CPUPlace(),
                           program=main)
    batches = _book_batches(book, seed + 176)
    rows = [next(batches) for _ in range(SP_BOOK_STEPS + 1)]
    feeds = [feeder.feed(r) for r in rows]
    fetch = [book.loss, book.prediction]
    if srl:
        # the transitions after each step's update, which its decoding
        # read
        fetch += [book.decode, 'crfw'] + list(book.evaluator.metrics)

    def train(place, st, fs):
        exe, scope = pt.Executor(place), pt.Scope()
        pt_io.params_from_numpy(scope, st, place)
        outs, times = [], []
        for f in fs:
            t0 = time.perf_counter()
            outs.append(exe.run(main, feed=f, fetch_list=fetch,
                                scope=scope))
            times.append(time.perf_counter() - t0)
        return exe, scope, outs, (1e3 * float(np.mean(times[1:]))
                                  if len(times) > 1 else None)

    def dense(v):
        return np.asarray(v.to_dense_rows()) if isinstance(
            v, pt.SequenceTensor) else np.asarray(v)

    def reading(got, ref, upto):
        return max(max(_fe_reading(
            {i: dense(a) for i, a in enumerate(g[:upto])},
            {i: dense(b) for i, b in enumerate(r[:upto])}).values())
            for g, r in zip(got, ref))
    exe, card_scope, card_out, ms = train(pt.CUDAPlace(0), state,
                                          feeds[:SP_BOOK_STEPS])
    trained = _book_state(card_scope)
    prof_scope = pt.Scope()
    pt_io.params_from_numpy(prof_scope, trained, pt.CUDAPlace(0))
    _, busy_us = profile_run(
        lambda: exe.run(main, feed=feeds[-1], fetch_list=fetch,
                        scope=prof_scope), 'book %s step' % name, top=4)
    _, cpu_scope, cpu_out, _ = train(pt.CPUPlace(), state,
                                     feeds[:SP_BOOK_STEPS])
    read = reading(card_out, cpu_out, 2)
    ctl_late = reading(card_out[1:], cpu_out[:-1], 2)
    ctl_untrained = reading(card_out[-1:], train(
        pt.CPUPlace(), state, feeds[SP_BOOK_STEPS - 1:SP_BOOK_STEPS])[2], 2)
    extra = ''
    if srl:
        # the Viterbi paths: a parting excused only at a near-tie of the
        # two paths' scores under the CPU's emissions and transitions;
        # the evaluator's counts then equal
        parted, excused = 0, 0
        for c, p in zip(card_out, cpu_out):
            em = _sp_rows(p[1])
            for e, a, r in zip(em, _sp_rows(c[2]), _sp_rows(p[2])):
                if not np.array_equal(a, r):
                    parted += 1
                    sa = _sp_viterbi_score(e, p[3], a[:, 0])
                    sr = _sp_viterbi_score(e, p[3], r[:, 0])
                    excused += int(abs(sa - sr) <= SP_TIE * max(abs(sr),
                                                                1.0))
        counts = [int(np.ravel(pt.fetch_var(v.name, s))[0])
                  for s in (card_scope, cpu_scope)
                  for v in book.evaluator.states]
        n_st = len(book.evaluator.states)
        extra = '; Viterbi paths: %d sequences parted from the CPU\'s, %d '\
            'of them at a near-tie (within %g); ChunkEvaluator counts '\
            '(infer, label, correct) card %s, CPU %s' % (
                parted, excused, SP_TIE, counts[:n_st], counts[n_st:])
        check(parted == excused, '17d %s: %d Viterbi paths part from the '
              'CPU\'s away from a tie' % (name, parted - excused))
        check(parted or counts[:n_st] == counts[n_st:], '17d %s: the chunk '
              'counts differ: %s' % (name, counts))
    print('sparse 17d: book %s at the script\'s widths, batch %d, f32 (TF32 '
          'and AMP off), %d steps: %.2f ms a step after the first (host '
          'clock), a profiled step %.3f ms busy on the card; losses %s; the '
          'loss and the prediction of each step card against CPU %.3g '
          '(limit %g; controls: the CPU a step late %.3g, the last batch '
          'from the parameters before training %.3g, must fail)%s; %s' % (
              name, book.batch_size, SP_BOOK_STEPS, ms, busy_us / 1e3,
              ', '.join('%.4f' % float(np.ravel(o[0])[0])
                        for o in card_out), read, SP_BOOK_TOL, ctl_late,
              ctl_untrained, extra, card), flush=True)
    check(read <= SP_BOOK_TOL, '17d %s: the card differs from the CPU by %g'
          % (name, read))
    check(ctl_late > SP_BOOK_TOL and ctl_untrained > SP_BOOK_TOL,
          '17d %s: the CPU limit does not catch its controls' % name)

    # saved, loaded, served as sequences at buckets 1-32
    d = os.path.join(art_dir, name)
    names = [v.name for v in book.feeds if v.name not in
             BOOK_LABELS + ('score', 'target')]
    if srl:
        prog = pt.Program()
        with pt.unique_name.guard(), pt.program_guard(prog, pt.Program()):
            _, served = books.srl_decode()
    else:
        prog, served = main, book.prediction
    pt_io.save_inference_model(d, names, [served], exe, main_program=prog,
                               scope=card_scope)
    load_scope = pt.Scope()
    prog, _, fetch_vars = pt_io.load_inference_model(d, exe,
                                                     scope=load_scope)
    requests = _book_batches(book, 98, BOOK_SERVE_MAX)
    samples, other = next(requests), next(requests)

    def feed_of(rows_, r):
        f = feeder.feed(rows_[:r])
        return {n: f[n] for n in names}
    server = pt.serving.ModelServer(pt.CUDAPlace(0),
                                    max_batch_size=BOOK_SERVE_MAX)

    def direct(rows_, r, b):
        out = exe.run(prog, feed=pad_feed(feed_of(rows_, r), r, b,
                                          server.policy.pad_mode),
                      fetch_list=fetch_vars, scope=load_scope)[0]
        return _sp_rows(out)[:r]
    equal, ctl_other, n, p50 = 0, 0, 0, {}
    try:
        server.load_model(name, d)
        for r in BOOK_REQUESTS:
            b = server.policy.bucket_for(r)
            ref = direct(samples, r, b)
            times = []
            for _ in range(SP_SERVE_REPS + 1):
                t0 = time.perf_counter()
                got, = server.infer(name, feed_of(samples, r))
                times.append(time.perf_counter() - t0)
                got = _sp_rows(got)
                n += 1
                equal += int(len(got) == len(ref) and all(
                    np.array_equal(a, e) for a, e in zip(got, ref)))
            p50[r] = 1e3 * float(np.median(times[1:]))
            o = direct(other, r, b)
            ctl_other += int(len(o) == len(got) and all(
                np.array_equal(a, e) for a, e in zip(got, o)))
        buckets = [server.policy.bucket_for(r) for r in BOOK_REQUESTS]
    finally:
        server.close()
    print('sparse 17d: book %s served (%s) through ModelServer(CUDAPlace(0)),'
          ' f32, requests of %s rows of sequences (buckets %s): p50 %s ms '
          '(host clock, of %d each); %d of %d answers bit-equal to a direct '
          'run padded to the bucket (control: the next requests\' rows, '
          'bit-equal in %d of %d, must be 0)' % (
              name, served.name, BOOK_REQUESTS, buckets, ', '.join(
                  '%d rows %.2f' % kv for kv in sorted(p50.items())),
              SP_SERVE_REPS, equal, n, ctl_other, len(BOOK_REQUESTS)),
          flush=True)
    check(equal == n, '17d %s: %d of %d served answers off a padded direct '
          'run' % (name, n - equal, n))
    check(ctl_other == 0, '17d %s: the serving control matched' % name)
    del card_scope, load_scope, prof_scope, cpu_scope
    torch.cuda.empty_cache()
    return ms, busy_us / 1e3


def phase_sparse_and_books(seed, card, art_dir):
    """17. Sparse row gradients (17a: stacked_dynamic_lstm's table under
    SGD, Adagrad and Adam; 17b: word2vec at the threshold), calc_gradient
    (17c: through the flash kernels, the fused conv and a gradient
    penalty), books 05 and 07 trained and served (17d). Returns the
    kernel launches of its main paths: lstm_cell (17a's sparse runs),
    the flash forward and merged backward (17c's flagship) and the fused
    conv (17c's mnist)."""
    import torch
    from paddle_tpu_torch.core import amp
    t_phase = time.perf_counter()
    amp.set_amp(False)
    try:
        lstm = _sp_lstm(seed, card)
        torch.cuda.empty_cache()
        _sp_word2vec(seed, card)
    finally:
        amp.set_amp(None)
    t0 = time.perf_counter()
    launches = dict(_sp_flagship_input_grad(seed, card))
    amp.set_amp(False)
    try:
        for n, c in _sp_mnist_input_grad(seed, card).items():
            launches[n] += c
        _sp_penalty(seed, card)
        print('calc_gradient 17c: %.1f s' % (time.perf_counter() - t0),
              flush=True)
        t0 = time.perf_counter()
        for name in ('recommender_system', 'label_semantic_roles'):
            _sp_book(name, seed, card, art_dir)
        print('sparse 17d: %.1f s' % (time.perf_counter() - t0),
              flush=True)
    finally:
        amp.set_amp(None)
    launches['lstm_cell'] += lstm
    print('phase 17: %.1f s' % (time.perf_counter() - t_phase), flush=True)
    return launches


# ---- phase 19: the high-level Trainer and its training services ------------------
# 19a, 19b: book 02's conv net (books.recognize_digits_conv: conv 20 and 50,
# 5x5, 2x2 max pools, a batch norm between, fc 10 softmax) at the script's
# widths through fluid.Trainer, Adam(0.001), batch 64, f32 (TF32 and AMP
# off; cuDNN, which runs the fused conv's backward, set deterministic), one
# epoch of TR_STEPS batches of the synthetic mnist reader; checkpoints
# every TR_CKPT_EVERY steps, and a child process signalled with SIGTERM
# once TR_SIGTERM_AFTER steps have ended
TR_BATCH = 64
TR_STEPS = 16
TR_CKPT_EVERY = 2
TR_SIGTERM_AFTER = 4
TR_CHILD_TIMEOUT = 300
TR_PIPE = dict(prefetch=2, steps_per_dispatch=4, sync_interval=4)
# 19a's Inferencer against the Trainer's test program on one batch, the
# same kernels on the same parameters: max |diff| over max |prob|
TR_INFER_TOL = 1e-5
# 19c: the flagship at full width and depth, batch 16, Adam(1e-4), one
# step with memory_optimize against the same step without it: the loss
# and every @GRAD bit-equal (the recompute launches the same kernels on
# the same inputs; the largest relative L2 is printed either way)
REMAT_TIMED_STEPS = 3
# 19c, dropout and train-mode batch norm: book 03's vgg_bn_drop
# (models/vgg.py: 13 conv + batch-norm layers, 10 dropouts of 0.3-0.5, a
# batch norm between the fc layers) on CIFAR-10's 3x32x32, batch 128,
# Adam(0.001), f32: one step with memory_optimize against the same step
# without, from the same parameters and generator states: the loss,
# every @GRAD, every persistable after the step (moving statistics and
# Adam's moments included) and the Scope's generator states bit-equal
REMAT_VGG_BATCH = 128
# the long context (7b's shape, LONG_SEQ and LONG_BATCH) under
# memory_optimize, one process a depth from the flagship's 6 down to the
# first that fits; each a warm-up and REMAT_LONG_STEPS timed steps
REMAT_DEPTHS = (6, 5, 4, 3)
REMAT_LONG_STEPS = 2
REMAT_CHILD_TIMEOUT = 400
# 19d: mnist (benchmark/fluid/models.py:24-37) under AMP, batch 32,
# activations in bf16 against f32: the first step's logits within
# BENCH_LOGITS_TOL['mnist']['bfloat16'] of each other
AMP_ACT_STEPS = 3
# 19e: ResNet-50 at full width, f32 (its residual branches' last gammas
# scaled by RESIDUAL_GAMMA, as phases 10 and 11 start it; the moving
# statistics calibrated on one batch, as phase 6 does), served at batch 8
# from the model Float16Transpiler made bf16: logits within
# RESNET_LOGITS_TOL of the f32 model served under AMP, and within
# F16_WITNESS_TOL (max |diff| over max |logits|) of a witness, the f32
# model with every f32 persistable rounded to bf16 and back, served under
# AMP: the same values on the same kernels, so bit-equal is expected
F16_BATCH = 8
F16_REQUESTS = 5
F16_WITNESS_TOL = 2 ** -8
# 19f: book 01's fit_a_line (SGD(0.001), batch 20) through fluid.Trainer
# on a poisoned reader, card against CPU: steps and parameters
GUARD_STEPS = 6
GUARD_POISON = (2,)


def _tr_reader():
    import paddle_tpu_torch as pt
    return pt.batch(pt.reader.firstn(pt.dataset.mnist.train(),
                                     TR_BATCH * TR_STEPS), TR_BATCH)


def _tr_train_func(seed):
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.models import books
    pt.default_startup_program().random_seed = seed
    book = books.recognize_digits_conv()
    return [book.loss, book.accuracy]


def _digits_infer_func():
    """Book 02's conv net for inference, its batch norm in test mode,
    named as the Trainer names it."""
    import paddle_tpu_torch as pt
    L = pt.layers
    img = L.data(name='img', shape=[1, 28, 28], dtype='float32')
    c = pt.nets.simple_img_conv_pool(input=img, filter_size=5,
                                     num_filters=20, pool_size=2,
                                     pool_stride=2, act='relu')
    c = L.batch_norm(c, is_test=True)
    c = pt.nets.simple_img_conv_pool(input=c, filter_size=5,
                                     num_filters=50, pool_size=2,
                                     pool_stride=2, act='relu')
    return L.fc(input=c, size=10, act='softmax')


def _tr_run(seed, reader=None, lr=0.001, ckdir=None, echo=False,
            journal=None, **train_kw):
    """One Trainer from the seed's initial state over the mnist reader:
    (trainer, the losses of the steps it ran, its persistables, the
    EndStepEvents' host times and last the seconds of the whole
    train())."""
    import torch
    import paddle_tpu_torch as pt
    import paddle_tpu_torch.fluid as fluid
    tr = fluid.Trainer(lambda: _tr_train_func(seed),
                       fluid.optimizer.Adam(learning_rate=lr),
                       place=fluid.CUDAPlace(0))
    losses, stamps = [], []

    def handler(ev):
        if isinstance(ev, fluid.EndStepEvent):
            losses.append(ev.metrics[0])
            stamps.append(time.perf_counter())
            if echo:
                print('trainer-child: step %d' % len(losses), flush=True)

    cfg = None if ckdir is None else fluid.CheckpointConfig(
        checkpoint_dir=ckdir, step_interval=TR_CKPT_EVERY, backend='npz')
    ctx = pt.observability.journal(journal) if journal else \
        contextlib.nullcontext()
    with ctx:
        t0 = time.perf_counter()
        tr.train(1, handler, reader=reader or _tr_reader(),
                 feed_order=['img', 'label'], checkpoint_config=cfg,
                 **train_kw)
        torch.cuda.synchronize()
        stamps.append(time.perf_counter() - t0)   # the whole train()
    losses = np.asarray([float(l.reshape(-1)[0]) if isinstance(
        l, torch.Tensor) else float(np.asarray(l).ravel()[0])
        for l in losses], 'float32')
    state = {v.name: pt.fetch_var(v.name, tr.scope)
             for v in tr.train_program.list_vars()
             if v.persistable and isinstance(tr.scope.raw(v.name),
                                             torch.Tensor)}
    return tr, losses, state, stamps


def trainer_child(mode, ckdir, out, seed):
    """19a's second and third processes (``--trainer-child``): train
    from ``ckdir``'s checkpoints (resuming from the newest), echoing each
    step, and write the losses and persistables to ``out``. The first is
    signalled by its parent mid-epoch and commits at the chunk's end."""
    import torch
    from paddle_tpu_torch import compiler
    from paddle_tpu_torch.core import amp
    torch.backends.cudnn.deterministic = True
    amp.set_amp(False)
    os.makedirs(os.path.join(ROOT, 'build'), exist_ok=True)
    with tempfile.TemporaryDirectory(dir=os.path.join(ROOT, 'build')) as d:
        compiler.tuning.set_default_cache(compiler.tuning.TuningCache(
            os.path.join(d, 'tuning_cache.json')))
        _, losses, state, _ = _tr_run(seed, ckdir=ckdir, echo=True)
    np.savez(out, losses=losses, **state)
    print('trainer-child: %s done, %d steps' % (mode, len(losses)),
          flush=True)
    return 0


def _tr_kill_child(seed, ckdir, out):
    """Start the first child, send it SIGTERM once TR_SIGTERM_AFTER
    steps have ended, and wait for its exit: (return code, the steps it
    echoed)."""
    import signal
    import threading
    proc = subprocess.Popen(
        [sys.executable, os.path.join(ROOT, 'chip_smoke.py'),
         '--trainer-child', 'kill', ckdir, out, '--seed', str(seed)],
        cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True)
    timer = threading.Timer(TR_CHILD_TIMEOUT, proc.kill)
    timer.start()
    steps, tail = 0, []
    try:
        for line in proc.stdout:
            tail = (tail + [line.rstrip()])[-20:]
            if line.startswith('trainer-child: step '):
                steps = int(line.split()[-1])
                if steps == TR_SIGTERM_AFTER:
                    proc.send_signal(signal.SIGTERM)
        rc = proc.wait()
    finally:
        timer.cancel()
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    check(rc == 0, '19a: the signalled child exited %s: %s'
          % (rc, '\n'.join(tail)))
    return rc, steps


def _tr_child(seed, ckdir, out):
    proc = subprocess.run(
        [sys.executable, os.path.join(ROOT, 'chip_smoke.py'),
         '--trainer-child', 'resume', ckdir, out, '--seed', str(seed)],
        cwd=ROOT, capture_output=True, text=True, timeout=TR_CHILD_TIMEOUT)
    check(proc.returncode == 0, '19a: the resuming child failed: %s'
          % (proc.stdout[-2000:] + proc.stderr[-2000:]))


def _bits_equal(a, b):
    return set(a) == set(b) and all(
        np.array_equal(a[n], b[n]) for n in a)


def _journal_waits(path):
    """The step_end records' feed waits and step durations (seconds)."""
    import paddle_tpu_torch as pt
    recs, malformed = pt.observability.read_journal(path)
    check(malformed == 0, 'a malformed journal line in %s' % path)
    steps = [r for r in recs if r.get('ev') == 'step_end']
    return ([r['feed_wait'] for r in steps], [r['dur_s'] for r in steps])


def _phase19_trainer(seed, card, art_dir):
    """19a and 19b. Returns the fused conv launches of the in-process
    runs (the uninterrupted, the pipelined) and of the Inferencer."""
    import json as _json
    import shutil as _shutil
    import torch
    import paddle_tpu_torch as pt
    import paddle_tpu_torch.fluid as fluid
    from paddle_tpu_torch.core import amp
    from paddle_tpu_torch.ops import cuda_kernels as ck
    from paddle_tpu_torch.resilience import checkpoint as ckpt
    t0 = time.perf_counter()
    prev_det = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    amp.set_amp(False)
    try:
        ckdir = os.path.join(art_dir, 'ckpt')
        killed_out = os.path.join(art_dir, 'killed.npz')
        resumed_out = os.path.join(art_dir, 'resumed.npz')
        _, echoed = _tr_kill_child(seed, ckdir, killed_out)
        killed = dict(np.load(killed_out))
        state = pt.io.load_checkpoint_trainer_state(ckdir)
        print('trainer 19a: the child got SIGTERM after step %d, ran %d '
              'steps, exited 0 and committed at the chunk boundary: '
              'trainer_state %s' % (TR_SIGTERM_AFTER, len(killed['losses']),
                                    _json.dumps({k: v for k, v in
                                                 (state or {}).items()
                                                 if k != 'rng'})),
              flush=True)
        check(state is not None and state['global_step'] ==
              len(killed['losses']) and TR_SIGTERM_AFTER <=
              state['global_step'] < TR_STEPS and state['epoch'] == 0,
              '19a: the preemption commit %s is not mid-epoch at the '
              'last step run (%d)' % (state, len(killed['losses'])))
        # the controls' checkpoint dirs: copies whose newest serial's step
        # counter is one short (a step replayed) and one long (a batch
        # skipped)
        newest = max(pt.io._get_checkpoint_serials(ckdir))
        shifted = {}
        for label, delta in (('one step short', -1), ('one step long', 1)):
            d = shifted[label] = os.path.join(art_dir, 'ckpt%+d' % delta)
            _shutil.copytree(ckdir, d)
            serial_dir = pt.io._serial_dir(d, newest)
            manifest = ckpt.read_manifest(serial_dir)
            for k in ('step', 'global_step'):
                manifest['trainer_state'][k] += delta
            with open(os.path.join(serial_dir, ckpt.MANIFEST_FILENAME),
                      'w') as f:
                _json.dump(manifest, f)
        _tr_child(seed, ckdir, resumed_out)
        resumed = dict(np.load(resumed_out))
        t_children = time.perf_counter() - t0

        ck.reset_launch_counts()
        tr, losses, plain, stamps = _tr_run(seed)
        launches = dict(ck.LAUNCHES)
        variants = dict(ck.FUSED_CONV_VARIANT_LAUNCHES)
        step_ms = 1e3 * (stamps[-2] - stamps[1]) / (len(stamps) - 3)
        joined = np.concatenate([killed['losses'], resumed['losses']])
        res_state = {n: v for n, v in resumed.items() if n != 'losses'}
        bits = (np.array_equal(joined, losses) and
                _bits_equal(res_state, plain))
        print('trainer 19a: uninterrupted %d steps, %.2f ms a step (host '
              'clock, loss read each step), fused_conv launches %d, by '
              'variant %s; %s' % (len(losses), step_ms,
                                  launches['fused_conv'], variants, card),
              flush=True)
        print('trainer 19a: killed (%d) + resumed (%d) steps against the '
              'uninterrupted run: losses and %d persistables bit-equal: %s'
              % (len(killed['losses']), len(resumed['losses']), len(plain),
                 bits), flush=True)
        check(bits, '19a: the resumed run parts from the uninterrupted one')
        want = dict.fromkeys(launches, 0)
        want['fused_conv'] = BOOK_REGIONS['recognize_digits_conv'] * TR_STEPS
        check(launches == want, '19a: launches %s, expected %s'
              % (launches, want))
        want_v = dict.fromkeys(variants, 0)
        for v, c in BOOK_VARIANTS['recognize_digits_conv']['f32'].items():
            want_v[v] = c * TR_STEPS
        check(variants == want_v, '19a: variants %s, expected %s'
              % (variants, want_v))
        for label, d in sorted(shifted.items()):
            _, c_losses, c_state, _ = _tr_run(seed, ckdir=d)
            same = (np.array_equal(np.concatenate([killed['losses'],
                                                   c_losses]), losses)
                    and _bits_equal(c_state, plain))
            print('trainer 19a: control, resumed %s: %d steps, bit-equal %s'
                  % (label, len(c_losses), same), flush=True)
            check(not same, '19a: the resume check does not catch a control:'
                  ' %s' % label)

        # save_params, then the high-level Inferencer serves from them
        param_dir = os.path.join(art_dir, 'params')
        tr.save_params(param_dir)
        ck.reset_launch_counts()
        inf = fluid.Inferencer(_digits_infer_func, param_path=param_dir)
        batch = next(_tr_reader()())
        imgs = np.stack([s[0] for s in batch]).astype('float32').reshape(
            TR_BATCH, 1, 28, 28)
        served, = inf.infer({'img': imgs})
        infer_launches = ck.LAUNCHES['fused_conv']
        softmax = [op for op in tr.test_program.global_block().ops
                   if op.type == 'softmax'][-1]
        direct, = fluid.Executor(fluid.CUDAPlace(0)).run(
            tr.test_program, feed={'img': imgs},
            fetch_list=[softmax.output('Out')[0]], scope=tr.scope)
        err = np.abs(served - direct).max() / np.abs(direct).max()
        print('trainer 19a: Inferencer from save_params, batch %d: %s, '
              'against the Trainer\'s test program max |diff| / max |prob| '
              '%.3g (tol %g), bit-equal %s, %d fused_conv launches' % (
                  TR_BATCH, served.shape, err, TR_INFER_TOL,
                  np.array_equal(served, direct), infer_launches),
              flush=True)
        check(served.shape == (TR_BATCH, 10) and np.isfinite(served).all()
              and err <= TR_INFER_TOL, '19a: the Inferencer\'s answer')
        check(infer_launches == BOOK_REGIONS['recognize_digits_conv'],
              '19a: Inferencer launches %d' % infer_launches)
        print('trainer 19a: %.1f s (the two children %.1f s)' % (
            time.perf_counter() - t0, t_children), flush=True)

        # 19b: the pipelined loop against the plain one; the plain loop
        # timed again warm (19a's run was the process's first Trainer)
        t1 = time.perf_counter()
        jplain = os.path.join(art_dir, 'plain_warm.jsonl')
        _, w_losses, _, stamps = _tr_run(seed, journal=jplain)
        check(np.array_equal(w_losses, losses), '19b: the plain loop run '
              'twice gives other losses')
        ck.reset_launch_counts()
        jpipe = os.path.join(art_dir, 'pipe.jsonl')
        _, p_losses, p_state, p_stamps = _tr_run(seed, journal=jpipe,
                                                 **TR_PIPE)
        pipe_launches = ck.LAUNCHES['fused_conv']
        bits = np.array_equal(p_losses, losses) and \
            _bits_equal(p_state, plain)
        waits = {}
        for label, path in (('plain', jplain), ('pipelined', jpipe)):
            w, dur = _journal_waits(path)
            check(len(w) == TR_STEPS, '19b: %s journal steps %d'
                  % (label, len(w)))
            waits[label] = (1e3 * float(np.median(w)),
                            1e3 * float(np.median(dur)))
        print('trainer 19b: %s against prefetch=0, steps_per_dispatch=1: '
              'losses and %d persistables bit-equal: %s; '
              'trainer_host_wait_seconds p50 %.3f ms pipelined, %.3f ms '
              'plain; a step p50 %.2f ms pipelined, %.2f ms plain (journal '
              'step_end dur_s); train() %.1f ms pipelined, %.1f ms plain '
              '(%d steps, each its Trainer\'s first lowering included); '
              '%s' % (
                  TR_PIPE, len(plain), bits, waits['pipelined'][0],
                  waits['plain'][0], waits['pipelined'][1],
                  waits['plain'][1], 1e3 * p_stamps[-1], 1e3 * stamps[-1],
                  TR_STEPS, card), flush=True)
        check(bits, '19b: the pipelined run parts from the plain one')
        check(pipe_launches == want['fused_conv'], '19b: launches %d'
              % pipe_launches)
        swapped = list(_tr_reader()())
        swapped[5], swapped[6] = swapped[6], swapped[5]
        for label, kw in (('batches 5 and 6 swapped',
                           dict(reader=lambda: iter(swapped))),
                          ('Adam(0.0011)', dict(lr=0.0011))):
            _, c_losses, c_state, _ = _tr_run(seed, **dict(TR_PIPE, **kw))
            same = np.array_equal(c_losses, losses) and \
                _bits_equal(c_state, plain)
            print('trainer 19b: control, %s: bit-equal %s' % (label, same),
                  flush=True)
            check(not same, '19b: the pipeline check does not catch a '
                  'control: %s' % label)
        print('trainer 19b: %.1f s' % (time.perf_counter() - t1),
              flush=True)
    finally:
        torch.backends.cudnn.deterministic = prev_det
        amp.set_amp(None)
    return {'fused_conv': launches['fused_conv'] + pipe_launches +
            infer_launches}


def long_remat_child(depth, seed):
    """19c's long-context process (``--long-remat``): the flagship at
    full width, ``depth`` layers, at LONG_SEQ and LONG_BATCH under
    memory_optimize, a warm-up step and REMAT_LONG_STEPS timed steps.
    Prints one JSON line; exits 3 when the card runs out of memory."""
    import torch
    import paddle_tpu_torch as pt
    from paddle_tpu_torch import compiler
    from paddle_tpu_torch.models.fluid_transformer import transformer
    from paddle_tpu_torch.ops import cuda_kernels as ck
    cfg = dict(FLAGSHIP, seq=LONG_SEQ, n_layers=depth)
    os.makedirs(os.path.join(ROOT, 'build'), exist_ok=True)
    with tempfile.TemporaryDirectory(dir=os.path.join(ROOT, 'build')) as d:
        compiler.tuning.set_default_cache(compiler.tuning.TuningCache(
            os.path.join(d, 'tuning_cache.json')))
        main, startup = pt.Program(), pt.Program()
        startup.random_seed = seed + 3
        with pt.unique_name.guard(), pt.program_guard(main, startup):
            loss = transformer(None, **cfg)[0]
            pt.optimizer.Adam(learning_rate=1e-4).minimize(loss)
        pt.memory_optimize(main)
        exe = pt.Executor()
        scope = pt.Scope()
        try:
            exe.run(startup, scope=scope)
            feed = _train_feed(LONG_BATCH, seed + 11, LONG_SEQ)
            torch.cuda.reset_peak_memory_stats()
            losses = [float(exe.run(main, feed=feed, fetch_list=[loss],
                                    scope=scope)[0][0])]
            torch.cuda.synchronize()
            ck.reset_launch_counts()
            t0 = time.perf_counter()
            for _ in range(REMAT_LONG_STEPS):
                out, = exe.run(main, feed=feed, fetch_list=[loss],
                               scope=scope, return_numpy=False)
            losses.append(float(out.item()))
            dt = time.perf_counter() - t0
        except torch.cuda.OutOfMemoryError as e:
            print('long-remat: depth %d out of memory: %s'
                  % (depth, str(e).splitlines()[0]), flush=True)
            return 3
    print('long-remat: ' + json.dumps(dict(
        depth=depth, ms=1e3 * dt / REMAT_LONG_STEPS,
        peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
        losses=losses, launches=dict(ck.LAUNCHES))), flush=True)
    return 0


def _phase19_remat_dropout(seed, card):
    """19c's dropout and batch-norm net under memory_optimize. Returns
    the fused conv's stats-form launches of the two measured steps."""
    import torch
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.core import amp, lowering
    from paddle_tpu_torch.models.vgg import vgg16_bn_drop
    from paddle_tpu_torch.ops import cuda_kernels as ck
    t0 = time.perf_counter()
    main, startup = pt.Program(), pt.Program()
    startup.random_seed = seed
    with pt.unique_name.guard(), pt.program_guard(main, startup):
        img = pt.layers.data(name='pixel', shape=[3, 32, 32],
                             dtype='float32')
        label = pt.layers.data(name='label', shape=[1], dtype='int64')
        pred = vgg16_bn_drop(img, 10)
        loss = pt.layers.mean(pt.layers.cross_entropy(input=pred,
                                                      label=label))
        pt.optimizer.Adam(learning_rate=0.001).minimize(loss)
    remat = main.clone()
    pt.memory_optimize(remat)
    # the same program under memory_optimize with the first batch norm's
    # momentum 0.9 -> 0.91: only the moving statistics part
    momentum = remat.clone()
    next(op for op in momentum.global_block().ops
         if op.type == 'batch_norm').attrs['momentum'] = 0.91
    grad_names = sorted(v.name for v in main.list_vars()
                        if v.name.endswith('@GRAD'))
    stats = sorted(n for op in main.global_block().ops
                   if op.type == 'batch_norm'
                   for n in op.input('Mean') + op.input('Variance'))
    rng = np.random.RandomState(seed + 31)
    feed = {'pixel': torch.tensor(rng.randn(REMAT_VGG_BATCH, 3, 32, 32)
                                  .astype('float32'), device='cuda'),
            'label': torch.tensor(rng.randint(0, 10, (REMAT_VGG_BATCH, 1)),
                                  device='cuda')}
    prev_det = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    amp.set_amp(False)
    try:
        exe = pt.Executor()
        scope = pt.Scope()
        exe.run(startup, scope=scope)
        snap = _snapshot(scope)
        keys = (lowering.RNG_KEY, lowering.RNG_CPU_KEY)
        gens = {k: scope.raw(k).get_state() for k in keys}

        def step(prog, advance=False):
            _restore(scope, snap)
            for k, st in gens.items():
                scope.raw(k).set_state(st)
            if advance:
                g = scope.raw(lowering.RNG_KEY)
                torch.rand(1, generator=g, device=g.device)
            ck.reset_launch_counts()
            vals = exe.run(prog, feed=feed, fetch_list=[loss] + grad_names,
                           scope=scope, return_numpy=False)
            torch.cuda.synchronize()
            return (dict(zip(['loss'] + grad_names, vals)),
                    {n: scope.raw(n).clone() for n in snap},
                    {k: scope.raw(k).get_state() for k in keys},
                    dict(ck.LAUNCHES))

        def parted(a, b):
            """The names of a's fetches, persistables and generators that
            differ from b's."""
            return [[n for n in x if not torch.equal(x[n], y[n])]
                    for x, y in zip(a[:3], b[:3])]

        results = {}
        for label_, prog in (('plain', main), ('memory_optimize', remat)):
            step(prog)                                # the lowering
            results[label_] = step(prog)
        plain, rem = results['plain'], results['memory_optimize']
        moved = [n for n in stats if not torch.equal(plain[1][n], snap[n])]
        drew = [k for k in keys if not torch.equal(plain[2][k], gens[k])]
        diff = parted(rem, plain)
        pl, rl = plain[3]['fused_conv_stats'], rem[3]['fused_conv_stats']
        print('remat 19c: vgg_bn_drop (book 03), batch %d, f32, Adam(0.001)'
              ', one step with memory_optimize against without: loss and %d'
              ' @GRAD, %d persistables (%d moving statistics, %d moved by '
              'the step), generators (%s drew) bit-equal: %s (parted: %s); '
              'fused_conv_stats launches %d against %d; %s' % (
                  REMAT_VGG_BATCH, len(grad_names), len(snap), len(stats),
                  len(moved), drew, not any(diff), diff, rl, pl, card),
              flush=True)
        check(len(moved) == len(stats) and drew == [lowering.RNG_KEY],
              '19c: the plain step moved %d of %d statistics, generators '
              '%s' % (len(moved), len(stats), drew))
        check(not any(diff), '19c: memory_optimize parts the dropout and '
              'batch-norm step: %s' % (diff,))
        want = dict.fromkeys(plain[3], 0)
        want['fused_conv_stats'] = 13
        check(plain[3] == want, '19c: plain launches %s, expected %s'
              % (plain[3], want))
        want['fused_conv_stats'] = 26
        check(rem[3] == want, '19c: memory_optimize launches %s, expected '
              '%s' % (rem[3], want))
        for label_, c in (('the generator one draw further',
                           step(remat, advance=True)),
                          ("the first batch norm's momentum 0.91",
                           step(momentum))):
            c_diff = parted(c, plain)
            print('remat 19c: control, %s: parted fetches %d, persistables '
                  '%d, generators %d' % ((label_,) + tuple(
                      len(d) for d in c_diff)), flush=True)
            check(any(c_diff), '19c: the dropout and batch-norm check does '
                  'not catch a control: %s' % label_)
    finally:
        torch.backends.cudnn.deterministic = prev_det
        amp.set_amp(None)
    del scope, snap, results
    torch.cuda.empty_cache()
    print('remat 19c: vgg_bn_drop %.1f s' % (time.perf_counter() - t0),
          flush=True)
    return {'fused_conv_stats': pl + rl}


def _phase19_remat(seed, card):
    """19c. The flagship at batch 16 with and without memory_optimize,
    then the long context by depth. Returns the flash launches of the
    measured flagship steps and of the long-context process that fit."""
    import torch
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.models.fluid_transformer import transformer
    from paddle_tpu_torch.ops import cuda_kernels as ck, misc_ops
    t0 = time.perf_counter()
    main, startup = pt.Program(), pt.Program()
    startup.random_seed = seed
    with pt.unique_name.guard(), pt.program_guard(main, startup):
        loss = transformer(None, **FLAGSHIP)[0]
        pt.optimizer.Adam(learning_rate=1e-4).minimize(loss)
    remat = main.clone()
    pt.memory_optimize(remat)
    exe = pt.Executor()
    scope = pt.Scope()
    exe.run(startup, scope=scope)
    grad_names = sorted(v.name for v in main.list_vars()
                        if v.name.endswith('@GRAD'))
    feed = _train_feed(TRAIN_BATCH, seed + 7)
    snap = _snapshot(scope)
    n = FLAGSHIP['n_layers']

    def step(prog):
        _restore(scope, snap)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ck.reset_launch_counts()
        vals = exe.run(prog, feed=feed, fetch_list=[loss] + grad_names,
                       scope=scope, return_numpy=False)
        torch.cuda.synchronize()
        return (dict(zip(['loss'] + grad_names, vals)), dict(ck.LAUNCHES),
                torch.cuda.max_memory_allocated() / 2 ** 30)

    def ms(prog):
        _restore(scope, snap)
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(REMAT_TIMED_STEPS):
            exe.run(prog, feed=feed, fetch_list=[loss], scope=scope,
                    return_numpy=False)
        torch.cuda.synchronize()
        return 1e3 * (time.perf_counter() - t) / REMAT_TIMED_STEPS

    results = {}
    for label, prog in (('plain', main), ('memory_optimize', remat)):
        step(prog)                                 # the lowering, warm-up
        results[label] = step(prog) + (ms(prog),)
    (pg, pl, ppeak, pms), (rg, rl, rpeak, rms) = (results['plain'],
                                                  results['memory_optimize'])
    unequal = [k for k in pg if not torch.equal(pg[k], rg[k])]
    errs = _rel_l2(rg, pg)
    worst = max(errs, key=errs.get)
    readers = [op.type for op in main.global_block().ops
               if worst.replace('@GRAD', '') in op.input_arg_names]
    print('remat 19c: flagship %s, batch %d, Adam(1e-4): plain %.2f ms a '
          'step, peak %.2f GiB, launches %s; memory_optimize %.2f ms a '
          'step, peak %.2f GiB, launches %s; %s' % (
              FLAGSHIP, TRAIN_BATCH, pms, ppeak, pl, rms, rpeak, rl, card),
          flush=True)
    print('remat 19c: the loss and %d @GRAD with memory_optimize against '
          'without: %s; largest relative L2 %.3g (%s, read by %s; '
          'bit-equal required)'
          % (len(grad_names), 'bit-equal' if not unequal else
             '%d differ' % len(unequal), errs[worst], worst, readers),
          flush=True)
    check(not unequal, '19c: memory_optimize parts %d of the loss and '
          '@GRAD, the largest by %g (%s)' % (len(unequal), errs[worst],
                                            worst))
    want = dict.fromkeys(pl, 0)
    want.update(flash_attn_fwd=n, flash_attn_bwd_dkvdq=n)
    check(pl == want, '19c: plain launches %s, expected %s' % (pl, want))
    want = dict(want, flash_attn_fwd=2 * n)
    check(rl == want, '19c: memory_optimize launches %s, expected %s'
          % (rl, want))
    for mode in ('dq dropped', 'dk/dv of the next head'):
        with misc_ops.attention_for_testing(_wrong_backward(mode)):
            cg = step(remat)[0]
        c_errs = _rel_l2(cg, pg)
        c_worst = max(c_errs, key=c_errs.get)
        c_unequal = [k for k in pg if not torch.equal(pg[k], cg[k])]
        print('remat 19c: control, %s under memory_optimize: %d differ, '
              'max relative L2 %.3g (%s)' % (mode, len(c_unequal),
                                             c_errs[c_worst], c_worst),
              flush=True)
        check(c_unequal, '19c: the gradient check does not catch a '
              'control: %s' % mode)
    launches = {'flash_attn_fwd': pl['flash_attn_fwd'] +
                rl['flash_attn_fwd'],
                'flash_attn_bwd_dkvdq': pl['flash_attn_bwd_dkvdq'] +
                rl['flash_attn_bwd_dkvdq']}
    del main, remat, scope, snap, pg, rg, results
    torch.cuda.empty_cache()
    print('remat 19c: flagship %.1f s' % (time.perf_counter() - t0),
          flush=True)

    t1 = time.perf_counter()
    fit = None
    for depth in REMAT_DEPTHS:
        proc = subprocess.run(
            [sys.executable, os.path.join(ROOT, 'chip_smoke.py'),
             '--long-remat', str(depth), '--seed', str(seed)],
            cwd=ROOT, capture_output=True, text=True,
            timeout=REMAT_CHILD_TIMEOUT)
        lines = [l for l in proc.stdout.splitlines()
                 if l.startswith('long-remat: ')]
        print('remat 19c: long context, depth %d: exit %d, %s' % (
            depth, proc.returncode, lines[-1] if lines else
            proc.stderr[-500:]), flush=True)
        if proc.returncode == 3:
            continue
        check(proc.returncode == 0 and lines, '19c: the depth-%d process '
              'failed: %s' % (depth, proc.stderr[-2000:]))
        fit = json.loads(lines[-1][len('long-remat: '):])
        break
    check(fit is not None, '19c: no depth of %s fits' % (REMAT_DEPTHS,))
    d = fit['depth']
    steps = REMAT_LONG_STEPS
    print('remat 19c: long context (seq %d, batch %d, %d tokens a step) '
          'under memory_optimize: depth %d fits (phase 7b without it: %d), '
          'peak %.2f GiB, %.2f ms a step, losses %s; %s; %.1f s' % (
              LONG_SEQ, LONG_BATCH, LONG_SEQ * LONG_BATCH, d, LONG_LAYERS,
              fit['peak_gib'], fit['ms'], fit['losses'], card,
              time.perf_counter() - t1), flush=True)
    check(all(np.isfinite(fit['losses'])), '19c: a non-finite loss')
    want = dict.fromkeys(fit['launches'], 0)
    want.update(flash_attn_fwd=2 * d * steps, flash_attn_bwd_dq=d * steps,
                flash_attn_bwd_dkv=d * steps)
    check(fit['launches'] == want, '19c: long-context launches %s, '
          'expected %s' % (fit['launches'], want))
    for k in ('flash_attn_fwd', 'flash_attn_bwd_dq', 'flash_attn_bwd_dkv'):
        launches[k] = launches.get(k, 0) + fit['launches'][k]
    return launches


def _lowered_dtypes(exe, program, scope, feed, names):
    """The values ``names`` of ``program`` after the compiler's passes, in
    the dtype they flow in on the card (the Executor's fetches are f32)."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.core import lowering
    opt, _ = pt.compiler.optimize(program, fetch_names=names, scope=scope)
    state_names = sorted(v.name for v in opt.list_vars() if v.persistable
                         and scope.raw(v.name) is not None)
    fn = lowering.lower_block(opt, opt.global_block(), sorted(feed), names,
                              state_names, [], exe.device)
    state = {n: scope.raw(n) for n in state_names}
    state[lowering.RNG_KEY] = scope.raw(lowering.RNG_KEY)
    state[lowering.RNG_CPU_KEY] = scope.raw(lowering.RNG_CPU_KEY)
    got, _ = fn(feed, state)
    return [g.dtype for g in got]


def _phase19_amp_act(seed, card):
    """19d. mnist's AMP steps with activations in bf16 and in f32.
    Returns the fused conv launches."""
    import torch
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.compiler import passes
    from paddle_tpu_torch.core import amp
    from paddle_tpu_torch.ops import cuda_kernels as ck
    t0 = time.perf_counter()
    main, startup, loss, pred = _bench_program('mnist', seed)
    softmax = [op for op in main.global_block().ops
               if op.type == 'softmax'][-1]
    logits = softmax.input('X')[0]
    infer = main.clone(for_test=True).prune([logits])
    exe = pt.Executor()
    scope = pt.Scope()
    exe.run(startup, scope=scope)
    snap = _snapshot(scope)
    feed = _bench_feed('mnist', BENCH_BATCH, seed + 5)
    feed2 = _bench_feed('mnist', BENCH_BATCH, seed + 6)
    conv_outs = [op.output('Out')[0] for op in pt.compiler.optimize(
        infer, fetch_names=[logits])[0].global_block().ops
        if op.type == 'fused_conv']
    mul_outs = [op.output('Out')[0] for op in infer.global_block().ops
                if op.type == 'mul']
    runs = {}
    try:
        for act in (True, False):
            amp.set_amp_act(act)
            _restore(scope, snap)
            dtypes = _lowered_dtypes(exe, infer, scope, {'data':
                                                         feed['data']},
                                     conv_outs + mul_outs)
            ck.reset_launch_counts()
            first = None
            for _ in range(AMP_ACT_STEPS):
                out = exe.run(main, feed=feed, fetch_list=[loss, logits],
                              scope=scope, return_numpy=False)
                if first is None:
                    first = out[1].float()
            torch.cuda.synchronize()
            runs[act] = (dtypes, dict(ck.FUSED_CONV_VARIANT_LAUNCHES),
                         ck.LAUNCHES['fused_conv'], first,
                         float(out[0].reshape(-1)[0]))
        amp.set_amp_act(False)
        _restore(scope, snap)
        other = exe.run(main, feed=feed2, fetch_list=[logits], scope=scope,
                        return_numpy=False)[0].float()
        _restore(scope, snap)
        with passes.conv_for_testing(_rolled_filters):
            rolled = exe.run(main, feed=feed, fetch_list=[logits],
                             scope=scope, return_numpy=False)[0].float()
    finally:
        amp.set_amp_act(None)
    (d16, v16, n16, l16, loss16), (d32, v32, n32, l32, loss32) = \
        runs[True], runs[False]
    tol = BENCH_LOGITS_TOL['mnist']['bfloat16']

    def rel(a):
        return ((a - l16).abs().max() / l16.abs().max()).item()
    err = rel(l32)
    print('amp-act 19d: mnist, batch %d, %d AMP steps each: activations '
          '(the 2 conv regions, the fc) %s with set_amp_act(True), %s with '
          'set_amp_act(False); fused_conv variants %s and %s; last losses '
          '%.4f and %.4f; first step\'s logits, f32 against bf16 '
          'activations: max |diff| / max |logits| %.4g (tol %g); %s' % (
              BENCH_BATCH, AMP_ACT_STEPS, [str(d) for d in d16],
              [str(d) for d in d32], v16, v32, loss16, loss32, err, tol,
              card), flush=True)
    check(d16 == [torch.bfloat16] * len(d16) and
          d32 == [torch.float32] * len(d32) and len(d16) == 3,
          '19d: activation dtypes %s and %s' % (d16, d32))
    want = dict.fromkeys(v16, 0)
    want['mma_sync'] = BENCH_REGIONS['mnist'] * AMP_ACT_STEPS
    check(v16 == v32 == want and n16 == n32, '19d: variants %s and %s, '
          'expected %s' % (v16, v32, want))
    check(err <= tol and np.isfinite([loss16, loss32]).all(),
          '19d: the logits differ by %g' % err)
    for label, c in (('the next batch', other),
                     ("the next channel's filters", rolled)):
        print('amp-act 19d: control, %s: %.4g' % (label, rel(c)),
              flush=True)
        check(rel(c) > tol, '19d: the logits limit does not catch a '
              'control: %s' % label)
    print('amp-act 19d: %.1f s' % (time.perf_counter() - t0), flush=True)
    return {'fused_conv': n16 + n32}


def _phase19_float16(seed, card):
    """19e. ResNet-50 served at batch 8 from its Float16Transpiler'd f32
    model against the f32 model under AMP. Returns the fused conv
    launches of the transpiled requests."""
    import torch
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.compiler import passes
    from paddle_tpu_torch.ops import cuda_kernels as ck
    t0 = time.perf_counter()
    main, startup, prob = _resnet_program(seed)
    exe = pt.Executor()
    scope = pt.Scope()
    exe.run(startup, scope=scope)
    gen = torch.Generator(device='cuda')
    gen.manual_seed(seed + 3)
    bns = [op for op in main.global_block().ops if op.type == 'batch_norm']
    for op in bns:
        c = scope.raw(op.input('Scale')[0]).shape[0]
        scope.set_var(op.input('Scale')[0], torch.rand(
            c, device='cuda', generator=gen) + 0.5)
        scope.set_var(op.input('Bias')[0], torch.randn(
            c, device='cuda', generator=gen) * 0.1)
    base = _snapshot(scope)
    softmax, = [op for op in main.global_block().ops
                if op.type == 'softmax']
    logits = softmax.input('X')[0]
    f32_prog = main.clone(for_test=True)
    feed = _image_feed(F16_BATCH, seed + 21)

    def prepared(small_gammas):
        """A scope of the model, its residual gammas as phase 6 starts
        them or scaled by RESIDUAL_GAMMA, its moving statistics
        calibrated on one batch."""
        sc = pt.Scope()
        _restore(sc, base)
        if small_gammas:
            _small_residual_gammas(main, sc)
        moments = exe.run(main, feed=_image_feed(F16_BATCH, seed + 7),
                          fetch_list=[op.output(s)[0] for op in bns
                                      for s in ('SavedMean',
                                                'SavedVariance')],
                          scope=sc, return_numpy=False)
        for op, mean, var in zip(bns, moments[::2], moments[1::2]):
            sc.set_var(op.input('Mean')[0], mean.float())
            sc.set_var(op.input('Variance')[0], var.float())
        return sc

    def transpiled(sc):
        prog, hs = main.clone(for_test=True), pt.Scope()
        _restore(hs, _snapshot(sc))
        return prog, hs, pt.contrib.Float16Transpiler().transpile(
            prog, scope=hs)

    # a reading, not a gate: at phase 6's gammas the transpiled model's
    # logits leave RESNET_LOGITS_TOL, so the limit is held below at
    # RESIDUAL_GAMMA
    sc6 = prepared(False)
    ref6, = exe.run(f32_prog, feed=feed, fetch_list=[logits], scope=sc6)
    prog6, hs6, _ = transpiled(sc6)
    got6, = exe.run(prog6, feed=feed, fetch_list=[logits], scope=hs6)
    print('float16 19e: at phase 6\'s residual gammas, the transpiled '
          'logits against the f32 model under AMP, max |diff| / max '
          '|logits|: %.4g (RESNET_LOGITS_TOL %g; a reading, not a gate); '
          '%s' % (float(np.abs(got6 - ref6).max() / np.abs(ref6).max()),
                  RESNET_LOGITS_TOL, card), flush=True)
    del sc6, prog6, hs6
    scope = prepared(True)
    half_prog, half_scope, n_cast = transpiled(scope)
    rounded = pt.Scope()
    for n, v in scope.vars.items():
        if isinstance(v, torch.Tensor):
            rounded.set_var(n, v.to(torch.bfloat16).to(v.dtype)
                            if v.dtype == torch.float32 else v)
    ref, = exe.run(f32_prog, feed=feed, fetch_list=[logits], scope=scope)
    witness, = exe.run(f32_prog, feed=feed, fetch_list=[logits],
                       scope=rounded)
    times = []
    ck.reset_launch_counts()
    passes.reset_fallback_counts()
    for i in range(F16_REQUESTS):
        torch.cuda.synchronize()
        t = time.perf_counter()
        got, = exe.run(half_prog, feed=feed, fetch_list=[logits],
                       scope=half_scope)
        times.append(1e3 * (time.perf_counter() - t))
    launches = ck.LAUNCHES['fused_conv']
    variants = dict(ck.FUSED_CONV_VARIANT_LAUNCHES)
    fallbacks = dict(passes.FALLBACKS)
    ref_times = []
    for i in range(F16_REQUESTS):
        torch.cuda.synchronize()
        t = time.perf_counter()
        exe.run(f32_prog, feed=feed, fetch_list=[logits], scope=scope)
        ref_times.append(1e3 * (time.perf_counter() - t))
    weight = half_scope.raw(main.global_block().all_parameters()[0].name)

    def rel(a, b=ref):
        return float(np.abs(a - b).max() / np.abs(b).max())
    err, w_err = rel(got), rel(got, witness)
    print('float16 19e: ResNet-50 f32 model, %d persistables cast to %s by '
          'Float16Transpiler; batch %d, f32 in, %s out; logits, max |diff| '
          '/ max |logits|: against the f32 model under AMP %.4g (tol %g), '
          'against the witness (its persistables rounded to bf16) %.4g '
          '(tol %g, bit-equal %s); %d fused_conv a request, by variant %s, '
          'fallbacks %s; p50 %.2f ms a request transpiled, %.2f ms the f32 '
          'model under AMP; %s' % (
              n_cast, weight.dtype, F16_BATCH, got.dtype, err,
              RESNET_LOGITS_TOL, w_err, F16_WITNESS_TOL,
              np.array_equal(got, witness), launches // F16_REQUESTS,
              variants, fallbacks, float(np.median(times)),
              float(np.median(ref_times)), card), flush=True)
    check(weight.dtype == torch.bfloat16 and got.dtype == np.float32,
          '19e: weights %s, fetch %s' % (weight.dtype, got.dtype))
    check(err <= RESNET_LOGITS_TOL, '19e: the transpiled logits differ by '
          '%g' % err)
    check(w_err <= F16_WITNESS_TOL, '19e: the transpiled logits differ '
          'from the witness by %g' % w_err)
    check(launches == RESNET_REGIONS * F16_REQUESTS and not fallbacks,
          '19e: %d launches, fallbacks %s' % (launches, fallbacks))
    want = {v: c * F16_REQUESTS for v, c in RESNET_VARIANTS.items()}
    check(variants == want, '19e: variants %s, expected %s'
          % (variants, want))
    other, = exe.run(half_prog, feed=_image_feed(F16_BATCH, seed + 22),
                     fetch_list=[logits], scope=half_scope)
    with passes.conv_for_testing(_rolled_filters):
        rolled, = exe.run(half_prog, feed=feed, fetch_list=[logits],
                          scope=half_scope)
    for label, c in (('the next batch', other),
                     ("the next channel's filters", rolled)):
        print('float16 19e: control, %s: %.4g against the f32 model, %.4g '
              'against the witness' % (label, rel(c), rel(c, witness)),
              flush=True)
        check(rel(c) > RESNET_LOGITS_TOL and
              rel(c, witness) > F16_WITNESS_TOL, '19e: a logits limit does '
              'not catch a control: %s' % label)
    print('float16 19e: %.1f s' % (time.perf_counter() - t0), flush=True)
    return {'fused_conv': launches}


def _guard_reader(poison=GUARD_POISON):
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.resilience import faultinject
    return faultinject.nan_reader(pt.batch(pt.reader.firstn(
        pt.dataset.uci_housing.train(), 20 * GUARD_STEPS), 20), poison)


def _guard_run(place, param_dir, policy, ckdir=None, poison=GUARD_POISON):
    """fit_a_line through the Trainer on the poisoned reader, f32 on
    either device (AMP off): (each step's skip, the trips, the
    parameters)."""
    import paddle_tpu_torch as pt
    import paddle_tpu_torch.fluid as fluid
    from paddle_tpu_torch.core import amp
    from paddle_tpu_torch.models import books
    amp.set_amp(False)
    try:
        return _guarded_train(place, param_dir, policy, ckdir, poison)
    finally:
        amp.set_amp(None)


def _guarded_train(place, param_dir, policy, ckdir, poison):
    import paddle_tpu_torch as pt
    import paddle_tpu_torch.fluid as fluid
    from paddle_tpu_torch.models import books
    tr = fluid.Trainer(lambda: books.fit_a_line().loss,
                       fluid.optimizer.SGD(learning_rate=0.001),
                       param_path=param_dir, place=place)
    guard = fluid.AnomalyGuard(policy=policy)
    skipped = []
    cfg = None if ckdir is None else fluid.CheckpointConfig(
        checkpoint_dir=ckdir, step_interval=1, backend='npz')
    tr.train(1, lambda e: skipped.append(e.metrics is None) if isinstance(
        e, fluid.EndStepEvent) else None, reader=_guard_reader(poison),
        feed_order=['x', 'y'], anomaly_guard=guard, checkpoint_config=cfg)
    params = {p.name: pt.fetch_var(p.name, tr.scope)
              for p in tr.train_program.global_block().all_parameters()}
    return skipped, dict(guard.anomalies), params


def _phase19_guards(seed, card, art_dir):
    """19f. check_nan_inf on a poisoned feed; the AnomalyGuard's
    skip_batch and rollback_to_checkpoint under the Trainer, card
    against CPU."""
    import paddle_tpu_torch as pt
    import paddle_tpu_torch.fluid as fluid
    from paddle_tpu_torch.models import books
    from paddle_tpu_torch.ops import cuda_kernels as ck
    t0 = time.perf_counter()
    main, startup, loss, pred = _bench_program('mnist', seed)
    exe = pt.Executor()
    scope = pt.Scope()
    exe.run(startup, scope=scope)
    feed = _bench_feed('mnist', BENCH_BATCH, seed + 5)
    poisoned = dict(feed, data=feed['data'].clone())
    poisoned['data'][3, 0, 7, 7] = float('nan')
    opt, _ = pt.compiler.optimize(main, fetch_names=[loss.name])
    first = next(op for op in opt.global_block().ops
                 if 'data' in op.input_arg_names)
    want = "output '%s' of op '%s'" % (first.output_arg_names[0], first.type)
    snap = _snapshot(scope)
    raised = None
    with fluid.nan_guard():
        try:
            exe.run(main, feed=poisoned, fetch_list=[loss], scope=scope)
        except fluid.NanInfError as e:
            raised = str(e)
        _restore(scope, snap)
        clean, = exe.run(main, feed=feed, fetch_list=[loss], scope=scope)
    _restore(scope, snap)
    off, = exe.run(main, feed=poisoned, fetch_list=[loss], scope=scope)
    _restore(scope, snap)
    print('guards 19f: check_nan_inf on a feed with one NaN pixel: %r '
          '(the first op reading the feed: %s); a clean feed under the '
          'guard: loss %.4f; the poisoned feed without the guard: loss %s'
          % (raised, want, float(clean[0]), off[0]), flush=True)
    check(raised is not None and want in raised, '19f: check_nan_inf '
          'raised %r, expected it to name %s' % (raised, want))
    check(np.isfinite(clean).all(), '19f: the guard tripped on a clean feed')
    check(not np.isfinite(off).all(), '19f: the poisoned feed is finite '
          'without the guard')
    del main, scope, snap

    # the guard's policies under the Trainer, card against CPU from one
    # set of parameters
    tr = fluid.Trainer(lambda: books.fit_a_line().loss,
                       fluid.optimizer.SGD(learning_rate=0.001))
    param_dir = os.path.join(art_dir, 'guard_params')
    tr.save_params(param_dir)
    ck.reset_launch_counts()
    for policy in ('skip_batch', 'rollback_to_checkpoint'):
        got = {}
        for label, place in (('card', pt.CUDAPlace(0)),
                             ('cpu', pt.CPUPlace())):
            ckdir = os.path.join(art_dir, 'guard_%s_%s' % (policy, label)) \
                if policy != 'skip_batch' else None
            got[label] = _guard_run(place, param_dir, policy, ckdir)
        (cs, ca, cp), (hs, ha, hp) = got['card'], got['cpu']

        def gap(ps):
            return max(float(np.abs(ps[n] - hp[n]).max() /
                             max(np.abs(hp[n]).max(), 1e-30)) for n in hp)
        err = gap(cp)
        print('guards 19f: %s: card steps %s, trips %s; CPU steps %s, trips '
              '%s; parameters card against CPU %.3g (tol %g)' % (
                  policy, cs, ca, hs, ha, err, BOOK_CPU_TOL), flush=True)
        check(cs == hs and len(cs) == GUARD_STEPS and sum(cs) == len(
            GUARD_POISON) and ca == ha == {'feed_nan': len(GUARD_POISON)},
              '19f: %s: steps or trips differ' % policy)
        check(err <= BOOK_CPU_TOL and all(np.isfinite(v).all()
                                          for v in cp.values()),
              '19f: %s: card against CPU %g' % (policy, err))
        if policy == 'skip_batch':
            _, _, moved = _guard_run(pt.CPUPlace(), param_dir, policy,
                                     poison=(3,))
            _, _, unguarded = _guard_run(pt.CPUPlace(), param_dir,
                                         policy, poison=())
            for label, ps in (('the poison a step later', moved),
                              ('no poisoned step', unguarded)):
                print('guards 19f: control, %s: %.3g' % (label, gap(ps)),
                      flush=True)
                check(gap(ps) > BOOK_CPU_TOL, '19f: the parameter limit '
                      'does not catch a control: %s' % label)
    check(sum(ck.LAUNCHES.values()) == 0, '19f: fit_a_line launched %s'
          % ck.LAUNCHES)
    print('guards 19f: %.1f s' % (time.perf_counter() - t0), flush=True)


def phase_trainer(seed, card):
    """19. The Fluid high-level Trainer and its services on the card:
    checkpoint, SIGTERM and resume (19a), the pipelined loop (19b),
    memory_optimize (19c), the AMP activation setting (19d), the
    Float16Transpiler (19e), the guards (19f). Returns the kernel
    launches of its main paths."""
    import torch
    t_phase = time.perf_counter()
    launches = {}

    def add(part):
        for k, c in part.items():
            launches[k] = launches.get(k, 0) + c

    with tempfile.TemporaryDirectory(dir=os.path.join(ROOT, 'build')) as d:
        add(_phase19_trainer(seed, card, d))
        torch.cuda.empty_cache()
        add(_phase19_remat_dropout(seed, card))
        add(_phase19_remat(seed, card))
        torch.cuda.empty_cache()
        add(_phase19_amp_act(seed, card))
        add(_phase19_float16(seed, card))
        torch.cuda.empty_cache()
        _phase19_guards(seed, card, d)
    print('phase 19: %.1f s' % (time.perf_counter() - t_phase), flush=True)
    return launches


# ---- phase 20: the in-graph readers and the data path ----------------------------
# 20a: ResNet-50 (models/resnet.py resnet_imagenet, depth 50) at full width,
# 3x224x224, class_dim 102 (flowers' classes), Momentum(0.01, 0.9), AMP,
# batch 32, fed RIO_BATCHES batches of dataset.flowers.train() (its
# synthetic sampler) that recordio_writer.convert_reader_to_recordio_files
# wrote, RIO_PER_FILE batches a file, into 2 PTRC files, read through
# open_files -> double_buffer(CUDAPlace(0)) -> read_file. The reader-fed
# losses against DataFeeder-fed steps from the same state (cuDNN set
# deterministic): bit for bit where a witness, a second DataFeeder-fed run,
# is bit-equal to the first; else within RIO_WITNESS_MARGIN times the
# witness's largest difference
RIO_BATCH, RIO_BATCHES, RIO_PER_FILE, RIO_CLASSES = 32, 16, 8, 102
RIO_WITNESS_MARGIN = 2.0
# 20b: stacked_dynamic_lstm at phase 14's widths without peepholes, batch
# LSTM_BATCH, RIO_LSTM_STEPS batches of ragged sequences (RIO_LSTM_MIN to
# LSTM_WORDS words, padded to LSTM_T_PAD steps) from PTRC records whose word
# slot is tagged __seq__, through open_files -> double_buffer -> read_file
RIO_LSTM_STEPS, RIO_LSTM_MIN = 4, 40
# 20c: ResNet-50 (1000 classes, inference) served at batch RIO_PROF_BATCH
# through Executor.run, RIO_PROF_RUNS runs under the profiler; a
# ModelServer answering RIO_SERVER_REQUESTS requests under it
RIO_PROF_BATCH, RIO_PROF_RUNS, RIO_SERVER_REQUESTS = 8, 3, 4


class _PulledBatches(object):
    """Wraps an Executor's reader pull: keeps each batch a consuming run
    took from the reader (the values read_file hands the run)."""

    def __init__(self, exe, names):
        self.exe, self.names, self.batches = exe, names, []

    def __enter__(self):
        orig = self.exe._pull_program_readers

        def pull(program, feed, scope, consume=True, fetch_names=None):
            out = orig(program, feed, scope, consume=consume,
                       fetch_names=fetch_names)
            if consume and not all(n in feed for n in self.names):
                self.batches.append([out[n] for n in self.names])
            return out
        self.exe._pull_program_readers = pull
        return self

    def __exit__(self, *exc):
        del self.exe._pull_program_readers    # the class's method again
        return False


def _rio_bytes(v):
    """(dtype, shape, bytes) of a fed value, a sequence's data and
    lengths each; a tensor is read back from the card."""
    if hasattr(v, 'lengths') and v.lengths is not None:
        return (_rio_bytes(v.data), _rio_bytes(v.lengths))
    if hasattr(v, 'detach'):
        v = v.detach().cpu().numpy()
    v = np.ascontiguousarray(v)
    return (v.dtype.str, v.shape, v.tobytes())


def _rio_batches_gate(label, pulled, fed, names):
    check(len(pulled) == len(fed), '%s: read_file handed %d batches, the '
          'DataFeeder made %d' % (label, len(pulled), len(fed)))
    for i, (got, want) in enumerate(zip(pulled, fed)):
        for n, g in zip(names, got):
            check(_rio_bytes(g) == _rio_bytes(want[n]), '%s: batch %d slot '
                  '%s differs from the DataFeeder\'s' % (label, i, n))
    print('%s: %d batches from read_file byte-equal to the DataFeeder\'s, '
          'in order' % (label, len(pulled)), flush=True)


def _rio_losses_gate(label, reader, fed, witness):
    """The reader-fed losses against the DataFeeder-fed ones, with the
    witness rule of RIO_WITNESS_MARGIN."""
    r, f, w = (np.asarray(x, np.float64) for x in (reader, fed, witness))
    diff, wdiff = float(np.abs(r - f).max()), float(np.abs(w - f).max())
    print('%s: losses reader-fed %s; DataFeeder-fed %s; witness (a second '
          'DataFeeder-fed run) %s; max |reader - fed| %.3g, max |witness - '
          'fed| %.3g' % (label, ' '.join('%.6f' % x for x in r),
                         ' '.join('%.6f' % x for x in f),
                         ' '.join('%.6f' % x for x in w), diff, wdiff),
          flush=True)
    check(np.isfinite(r).all(), '%s: non-finite reader-fed loss' % label)
    if wdiff == 0:
        check(diff == 0, '%s: the reader-fed losses differ from the '
              'DataFeeder-fed ones by %g (the witness is bit-equal)'
              % (label, diff))
    else:
        check(diff <= RIO_WITNESS_MARGIN * wdiff, '%s: the reader-fed losses '
              'differ by %g, over %g times the witness\'s %g'
              % (label, diff, RIO_WITNESS_MARGIN, wdiff))


def _rio_steps(exe, main, fetch, scope, feeds=None, steps=None):
    """Runs of ``main``, one a feed of ``feeds``, or ``steps`` (default
    RIO_BATCHES) from its reader, the fetches kept on the card until the
    end; returns (the fetches of each run as host arrays, the runs'
    seconds)."""
    import torch
    from paddle_tpu_torch.executor import as_numpy
    if feeds is None:
        feeds = [None] * (RIO_BATCHES if steps is None else steps)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    outs = [exe.run(main, feed=f, fetch_list=fetch, scope=scope,
                    return_numpy=False) for f in feeds]
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    return [[as_numpy(v) for v in o] for o in outs], dt


def _rio_close(scope):
    """Stop every reader stream the scope holds (its prefetch worker)."""
    for st in scope.__dict__.pop('_reader_states', {}).values():
        st['iter'].close()


def _rio_resnet(seed, files, double_buffer):
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.models.resnet import resnet_imagenet
    main, startup = pt.Program(), pt.Program()
    startup.random_seed = seed
    with pt.unique_name.guard(), pt.program_guard(main, startup):
        L = pt.layers
        r = L.open_files(files, shapes=[[-1, 3, 224, 224], [-1, 1]],
                         lod_levels=[0, 0], dtypes=['float32', 'int64'])
        if double_buffer:
            r = L.double_buffer(r, place=pt.CUDAPlace(0))
        img, label = L.read_file(r)
        predict = resnet_imagenet(img, class_dim=RIO_CLASSES, depth=50)
        loss = L.mean(L.cross_entropy(input=predict, label=label))
        acc = L.accuracy(input=predict, label=label)
        pt.optimizer.Momentum(learning_rate=0.01, momentum=0.9).minimize(
            loss)
    return main, startup, r, [loss, acc]


def _phase20_resnet(seed, card, d):
    """20a, the profiled training step of 20c and the memory and metrics
    checks of 20d; returns the reader-fed steps' launches."""
    import torch
    import paddle_tpu_torch as pt
    from paddle_tpu_torch import executor as pexe
    from paddle_tpu_torch import memory, metrics, profiler, recordio_writer
    from paddle_tpu_torch.compiler import passes
    from paddle_tpu_torch.native import loader as native
    from paddle_tpu_torch.ops import cuda_kernels as ck
    t0 = time.perf_counter()
    py_batches = list(pt.batch(pt.reader.firstn(
        pt.dataset.flowers.train(), RIO_BATCH * RIO_BATCHES), RIO_BATCH)())
    files = [os.path.join(d, 'flowers-%05d.recordio' % i)
             for i in range(RIO_BATCHES // RIO_PER_FILE)]
    main, startup, reader, fetch = _rio_resnet(seed, files, True)
    names = [v.name for v in reader.feed_vars]
    feeder = pt.DataFeeder(feed_list=reader.feed_vars, place=pt.CUDAPlace(0),
                           program=main)
    fed = [feeder.feed(b) for b in py_batches]
    t_write = time.perf_counter()
    n = recordio_writer.convert_reader_to_recordio_files(
        os.path.join(d, 'flowers.recordio'), RIO_PER_FILE,
        lambda: iter(py_batches), feeder)
    t_write = time.perf_counter() - t_write
    check(n == RIO_BATCHES and all(os.path.exists(f) for f in files),
          'convert_reader_to_recordio_files wrote %d batches, files %s'
          % (n, sorted(os.listdir(d))))
    print('phase 20a: %d flowers batches of %d (3x224x224) made and '
          'converted in %.1f s; %d PTRC files, %d bytes, written in %.2f s'
          % (RIO_BATCHES, RIO_BATCH, time.perf_counter() - t0, len(files),
             sum(os.path.getsize(f) for f in files), t_write), flush=True)
    # the native library is built (g++) at its first use: here, outside
    # the timed steps
    t_build = time.perf_counter()
    check(native.available(), 'phase 20a: the native recordio library did '
          'not build: %s' % native.build_error())
    print('phase 20a: the native recordio library ready in %.2f s (%s)' % (
        time.perf_counter() - t_build, os.path.relpath(
            native.library_path(), ROOT)), flush=True)
    prev_det = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        exe, scope = pt.Executor(), pt.Scope()          # CUDAPlace(0)
        exe.run(startup, scope=scope)
        snap = _snapshot(scope)
        # DataFeeder-fed first: it lowers the program (the reader-fed runs
        # share the memo entry: the same feed names and shapes)
        copies0 = pexe.FEED_COPIES['host_to_device']
        f_out, f_dt = _rio_steps(exe, main, fetch, scope, fed)
        f_copies = pexe.FEED_COPIES['host_to_device'] - copies0
        _restore(scope, snap)
        ck.reset_launch_counts()
        passes.reset_fallback_counts()
        torch.cuda.reset_peak_memory_stats()
        reads0 = dict(native.READS)
        copies0 = pexe.FEED_COPIES['host_to_device']
        with _PulledBatches(exe, names) as pulled:
            r_out, r_dt = _rio_steps(exe, main, fetch, scope)
        launches = dict(ck.LAUNCHES)
        variants = dict(ck.FUSED_CONV_VARIANT_LAUNCHES)
        fallbacks = dict(passes.FALLBACKS)
        r_copies = pexe.FEED_COPIES['host_to_device'] - copies0
        reads = {k: native.READS[k] - reads0[k] for k in reads0}
        peak = torch.cuda.max_memory_allocated()
        mem_peak = memory.max_memory_allocated()
        _rio_batches_gate('phase 20a', pulled.batches, fed, names)
        del pulled
        for _ in range(2):                              # EOF is sticky
            try:
                exe.run(main, fetch_list=fetch, scope=scope)
                raise RuntimeError('chip_smoke: phase 20a: run %d did not '
                                   'raise EOFException' % (RIO_BATCHES + 1))
            except pt.core.EOFException:
                pass
        reader.reset()
        peek = exe._pull_program_readers(
            main, {}, scope, consume=False, fetch_names=[v.name
                                                         for v in fetch])
        check(all(_rio_bytes(peek[n]) == _rio_bytes(fed[0][n])
                  for n in names), 'phase 20a: the first batch after '
              'reset() differs from the first batch')
        print('phase 20a: run %d raised EOFException (twice); after reset() '
              'the first batch came back' % (RIO_BATCHES + 1), flush=True)
        # 20c: one training step under the profiler (it takes the peeked
        # batch): one fwd_bwd(value_and_grad) event, the momentum ops one
        # by one, nothing of the forward
        n_momentum = sum(op.type == 'momentum'
                         for op in main.global_block().ops)
        profiler.reset_profiler()
        with profiler.profiler('All', 'total',
                               trace_dir=os.path.join(d, 'trace_train')):
            exe.run(main, fetch_list=fetch, scope=scope)
        events = profiler.op_stats()
        print('phase 20c: a profiled training step: %s' % ', '.join(
            '%s %d calls %.3f ms' % (k, v['calls'], v['total_ms'])
            for k, v in sorted(events.items())), flush=True)
        check(events.get('fwd_bwd(value_and_grad)', {}).get('calls') == 1,
              'phase 20c: the training step has no single fwd_bwd event: '
              '%s' % sorted(events))
        check(events.get('momentum', {}).get('calls') == n_momentum > 0,
              'phase 20c: %s momentum calls, the program has %d momentum '
              'ops' % (events.get('momentum'), n_momentum))
        check('fused_conv' not in events and 'mul' not in events,
              'phase 20c: ops of the forward have events of their own: %s'
              % sorted(events))
        _rio_close(scope)
        _restore(scope, snap)
        w_out, w_dt = _rio_steps(exe, main, fetch, scope, fed)
        # without double_buffer: the Executor copies each batch to the card
        main_p, _, reader_p, fetch_p = _rio_resnet(seed, files, False)
        exe.run(main_p, feed=fed[0], fetch_list=fetch_p, scope=scope)
        _restore(scope, snap)
        copies0 = pexe.FEED_COPIES['host_to_device']
        p_out, p_dt = _rio_steps(exe, main_p, fetch_p, scope)
        p_copies = pexe.FEED_COPIES['host_to_device'] - copies0
        _rio_close(scope)
    finally:
        torch.backends.cudnn.deterministic = prev_det
    losses = {k: [float(o[0].ravel()[0]) for o in out]
              for k, out in (('r', r_out), ('f', f_out), ('w', w_out),
                             ('p', p_out))}
    _rio_losses_gate('phase 20a', losses['r'], losses['f'], losses['w'])
    print('phase 20a: without double_buffer the losses %s the reader-fed '
          'ones' % ('equal' if losses['p'] == losses['r'] else 'differ from'),
          flush=True)
    print('phase 20a: ResNet-50 (3x224x224, %d classes), batch %d, '
          'Momentum(0.01, 0.9), AMP: ms a step reader-fed with double_buffer '
          '%.2f, without %.2f, DataFeeder-fed %.2f (the witness run; the '
          'first, which lowered the program, %.2f); %s' % (
              RIO_CLASSES, RIO_BATCH, 1e3 * r_dt / RIO_BATCHES,
              1e3 * p_dt / RIO_BATCHES, 1e3 * w_dt / RIO_BATCHES,
              1e3 * f_dt / RIO_BATCHES, card), flush=True)
    print('phase 20a: the Executor\'s copies to the card: reader-fed with '
          'double_buffer %d, without %d, DataFeeder-fed %d; native reads '
          '%s; launches %s (by variant %s), fallbacks %s' % (
              r_copies, p_copies, f_copies, reads, launches, variants,
              fallbacks), flush=True)
    expect = {k: 0 for k in launches}
    expect['fused_conv_stats'] = RESNET_REGIONS * RIO_BATCHES
    check(launches == expect, 'phase 20a: launches %s, expected %s'
          % (launches, expect))
    check(not fallbacks, 'phase 20a: fell back: %s' % fallbacks)
    check(r_copies == 0, 'phase 20a: the Executor copied %d values to the '
          'card in the reader-fed steps' % r_copies)
    check(native.available() and reads == {'native': len(files),
                                            'python': 0},
          'phase 20a: the native recordio library was not used: reads %s, '
          'build error %s' % (reads, native.build_error()))
    # 20d: memory and metrics
    stats = memory.memory_stats()
    total = torch.cuda.get_device_properties(0).total_memory
    print('phase 20d: memory.max_memory_allocated() %d, '
          'torch.cuda.max_memory_allocated() %d (%.2f GiB); memory_stats '
          'bytes_limit %d, the card\'s total_memory %d, supported %s'
          % (mem_peak, peak, peak / 2 ** 30, stats.get('bytes_limit', 0),
             total, stats['supported']), flush=True)
    check(mem_peak == peak, 'phase 20d: memory.max_memory_allocated() %d, '
          'torch says %d' % (mem_peak, peak))
    check(stats['supported'] and stats.get('bytes_limit') ==
          torch.cuda.mem_get_info()[1],
          'phase 20d: memory_stats %s' % stats)
    arena = memory.HostArena(chunk_bytes=1 << 20)
    check(arena.native, 'phase 20d: HostArena is not native: %s'
          % native.build_error())
    a = arena.alloc((RIO_BATCH, 3, 224, 224), 'float32')
    a[...] = fed[0][names[0]]
    st = arena.stats()
    check(st['native'] and st['allocated'] >= a.nbytes and st['pinned'] in
          (True, False) and st['chunks'] >= 1, 'phase 20d: arena stats %s'
          % st)
    del a
    arena.reset()
    check(arena.stats()['allocated'] == 0, 'phase 20d: arena reset left %s'
          % arena.stats())
    arena.close()
    acc = metrics.Accuracy()
    for out in r_out:
        acc.update(value=out[1], weight=RIO_BATCH)
    want = sum(float(np.asarray(out[1]).sum()) * RIO_BATCH
               for out in r_out) / (RIO_BATCH * RIO_BATCHES)
    print('phase 20d: HostArena native, stats %s; metrics.Accuracy over the '
          'reader-fed steps %.6f, the batch-weighted mean %.6f'
          % (st, acc.eval(), want), flush=True)
    check(acc.eval() == want, 'phase 20d: metrics.Accuracy %r, the '
          'batch-weighted mean %r' % (acc.eval(), want))
    for f in files:
        os.remove(f)
    del scope, exe, snap, fed, py_batches
    torch.cuda.empty_cache()
    return {'fused_conv_stats': launches['fused_conv_stats']}


def _phase20_lstm(seed, card, d):
    """20b; returns the reader-fed steps' launches."""
    import torch
    import paddle_tpu_torch as pt
    from paddle_tpu_torch import executor as pexe, recordio_writer
    from paddle_tpu_torch.ops import cuda_kernels as ck
    rng = np.random.RandomState(seed + 20)
    batches = []
    for _ in range(RIO_LSTM_STEPS):
        lens = rng.randint(RIO_LSTM_MIN, LSTM_WORDS + 1, LSTM_BATCH)
        lens[0] = LSTM_WORDS
        batches.append([(rng.randint(0, LSTM['dict_size'], int(k)).tolist(),
                         int(rng.randint(0, 2))) for k in lens])
    path = os.path.join(d, 'lstm.recordio')
    main, startup = pt.Program(), pt.Program()
    startup.random_seed = seed
    with pt.unique_name.guard(), pt.program_guard(main, startup):
        L = pt.layers
        r = L.open_files([path], shapes=[[-1, 1], [-1, 1]],
                         lod_levels=[1, 0], dtypes=['int64', 'int64'])
        r = L.double_buffer(r, place=pt.CUDAPlace(0))
        words, label = L.read_file(r)
        loss, _ = stacked_dynamic_lstm(pt, use_peepholes=False, data=words,
                                       label=label, **LSTM)
        pt.optimizer.Momentum(learning_rate=0.01, momentum=0.9).minimize(
            loss)
    names = [v.name for v in r.feed_vars]
    feeder = pt.DataFeeder(feed_list=r.feed_vars, place=pt.CUDAPlace(0),
                           program=main)
    fed = [feeder.feed(b) for b in batches]
    check(recordio_writer.convert_reader_to_recordio_file(
        path, lambda: iter(batches), feeder) == RIO_LSTM_STEPS,
        'phase 20b: the recordio file holds the wrong count')
    exe, scope = pt.Executor(), pt.Scope()
    exe.run(startup, scope=scope)
    snap = _snapshot(scope)
    f_out, _ = _rio_steps(exe, main, [loss], scope, fed)
    _restore(scope, snap)
    ck.reset_launch_counts()
    copies0 = pexe.FEED_COPIES['host_to_device']
    with _PulledBatches(exe, names) as pulled:
        r_out, r_dt = _rio_steps(exe, main, [loss], scope,
                                 steps=RIO_LSTM_STEPS)
    launches = dict(ck.LAUNCHES)
    copies = pexe.FEED_COPIES['host_to_device'] - copies0
    _rio_batches_gate('phase 20b', pulled.batches, fed, names)
    lens_ok = all(isinstance(got[0], pt.SequenceTensor) and np.array_equal(
        got[0].lengths.cpu().numpy(), want[names[0]].lengths)
        for got, want in zip(pulled.batches, fed))
    check(lens_ok, 'phase 20b: the sequence lengths did not survive the '
          'round trip')
    del pulled
    _rio_close(scope)
    _restore(scope, snap)
    w_out, _ = _rio_steps(exe, main, [loss], scope, fed)
    losses = [[float(o[0].ravel()[0]) for o in out]
              for out in (r_out, f_out, w_out)]
    _rio_losses_gate('phase 20b', *losses)
    print('phase 20b: stacked_dynamic_lstm (dict %d, emb %d, hid %d, %d '
          'layers, no peepholes), batch %d of %d-%d words (padded to %d), '
          'from __seq__ records: lengths kept, %.2f ms a step reader-fed, '
          'the Executor\'s copies to the card %d, launches %s; %s' % (
              LSTM['dict_size'], LSTM['emb_dim'], LSTM['hid_dim'],
              LSTM['stacked_num'], LSTM_BATCH, RIO_LSTM_MIN, LSTM_WORDS,
              LSTM_T_PAD, 1e3 * r_dt / RIO_LSTM_STEPS, copies, launches,
              card), flush=True)
    expect = {k: 0 for k in launches}
    expect['lstm_cell'] = LSTM_LAUNCHES * RIO_LSTM_STEPS
    check(launches == expect, 'phase 20b: launches %s, expected %s'
          % (launches, expect))
    check(copies == 0, 'phase 20b: the Executor copied %d values to the '
          'card' % copies)
    del scope, exe, snap
    torch.cuda.empty_cache()
    return {'lstm_cell': launches['lstm_cell']}


def _phase20_profiler(seed, card, d):
    """20c: ResNet-50 served under the profiler, a ModelServer's spans,
    no record after stop_profiler; returns the served runs' launches."""
    import torch
    import paddle_tpu_torch as pt
    from paddle_tpu_torch import profiler
    from paddle_tpu_torch.ops import cuda_kernels as ck
    main, startup, prob = _resnet_program(seed, is_test=True)
    exe, scope = pt.Executor(), pt.Scope()
    exe.run(startup, scope=scope)
    feed = {'img': np.random.RandomState(seed + 22).randn(
        RIO_PROF_BATCH, 3, 224, 224).astype('float32')}
    exe.run(main, feed=feed, fetch_list=[prob], scope=scope)   # lowers
    ck.reset_launch_counts()
    profiler.reset_profiler()
    table = os.path.join(d, 'profile_table.txt')
    tdir = os.path.join(d, 'trace_serve')
    with profiler.profiler('All', 'total', table, trace_dir=tdir):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(RIO_PROF_RUNS):
            exe.run(main, feed=feed, fetch_list=[prob], scope=scope)
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    launches = dict(ck.LAUNCHES)
    events = profiler.op_stats()
    op_ms = sum(v['total_ms'] for v in events.values())
    print('phase 20c: ResNet-50 served at batch %d, %d runs under the '
          'profiler: %.2f ms wall, %.2f ms summed over the op table; '
          'fused_conv %s calls, %.3f ms; launches %s; %s' % (
              RIO_PROF_BATCH, RIO_PROF_RUNS, wall_ms, op_ms,
              events.get('fused_conv', {}).get('calls'),
              events.get('fused_conv', {}).get('total_ms', 0.0), launches,
              card), flush=True)
    check(events.get('fused_conv', {}).get('calls') ==
          launches['fused_conv'] == RESNET_REGIONS * RIO_PROF_RUNS,
          'phase 20c: the table\'s fused_conv calls %s, the launch counter '
          '%s' % (events.get('fused_conv'), launches))
    check(op_ms <= wall_ms, 'phase 20c: the op table sums %.3f ms, the runs '
          'took %.3f ms' % (op_ms, wall_ms))
    prof_path = profiler.save_profile(os.path.join(d, 'profile.json'))
    timeline = os.path.join(d, 'timeline.json')
    proc = subprocess.run([sys.executable, os.path.join(
        ROOT, 'tools', 'timeline.py'), '--profile_path', prof_path,
        '--timeline_path', timeline], capture_output=True, text=True)
    check(proc.returncode == 0, 'phase 20c: tools/timeline.py failed: %s'
          % proc.stderr[-2000:])
    with open(timeline) as f:
        slices = [e for e in json.load(f)['traceEvents'] if e['ph'] == 'X']
    check(sum(e['name'] == 'fused_conv' for e in slices) ==
          RESNET_REGIONS * RIO_PROF_RUNS, 'phase 20c: the timeline holds %d '
          'fused_conv slices' % sum(e['name'] == 'fused_conv'
                                    for e in slices))
    trace = profiler.trace_path()
    check(trace is not None and os.path.getsize(trace) > 0,
          'phase 20c: no device trace written (%s)' % trace)
    with open(trace) as f:
        kernels = sum(e.get('cat') == 'kernel' for e in
                      json.load(f).get('traceEvents', []))
    print('phase 20c: save_profile -> tools/timeline.py: %d slices; the '
          'device trace %s, %d bytes, %d kernel events' % (
              len(slices), os.path.basename(trace), os.path.getsize(trace),
              kernels), flush=True)
    before = profiler.op_stats()
    exe.run(main, feed=feed, fetch_list=[prob], scope=scope)
    check(profiler.op_stats() == before, 'phase 20c: a run after '
          'stop_profiler recorded events')
    with pt.serving.ModelServer(pt.CUDAPlace(0),
                                max_batch_size=RIO_PROF_BATCH) as server:
        server.register_model('resnet', main, ['img'], [prob], scope)
        server.infer('resnet', feed)
        profiler.reset_profiler()
        profiler.start_profiler('All', trace_dir=os.path.join(d, 'trace_srv'))
        for _ in range(RIO_SERVER_REQUESTS):
            server.infer('resnet', feed)
        profiler.stop_profiler()
    spans = profiler.serving_stats()
    print('phase 20c: a ModelServer under the profiler answered %d requests: '
          'spans %s' % (RIO_SERVER_REQUESTS, {k: v['calls'] for k, v in
                                              sorted(spans.items())}),
          flush=True)
    check(spans.get('serving/request', {}).get('calls') ==
          RIO_SERVER_REQUESTS, 'phase 20c: serving/request %s, %d requests'
          % (spans.get('serving/request'), RIO_SERVER_REQUESTS))
    del scope, exe
    torch.cuda.empty_cache()
    return {'fused_conv': launches['fused_conv']}


def phase_readers(seed, card):
    """20. The in-graph readers and the data path (20a, 20b), the
    profiler (20c), memory and metrics (20d). Returns the kernel launches
    of its main paths."""
    import torch
    t_phase = time.perf_counter()
    launches = {}
    with tempfile.TemporaryDirectory(dir=os.path.join(ROOT, 'build')) as d:
        launches.update(_phase20_resnet(seed, card, d))
        launches.update(_phase20_lstm(seed, card, d))
        launches.update(_phase20_profiler(seed, card, d))
    torch.cuda.empty_cache()
    print('phase 20: %.1f s; %.1f s since the process started' % (
        time.perf_counter() - t_phase, time.perf_counter() - _STARTED),
        flush=True)
    return launches


# 21a: the 38 op kernels of slice 21 (tensor, math, nn and misc ops with
# no hand-written kernel), card against the CPU in f32 with AMP off and
# cuDNN's TF32 at PyTorch's default (on: the transposed and 3-D convs turn
# it off for themselves), at the reference tests' shapes ('ref') and at
# one realistic width each ('wide'); the backward (every parameter's
# @GRAD of the sum of mean(out^2)) at 'ref' for every group and at 'wide'
# for DCGAN's conv2d_transpose, the 3-D convs and pools, and nce
OPS21_TOL = 1e-5          # max |card - CPU| / max |CPU|, f32; integers exact
OPS21_WIDE_GRADS = ('conv_t', 'conv3d', 'nce')
OPS21_SIZES = (False, True)                 # 'wide': False, then True
# 21b: book 07 (label_semantic_roles) at the script's widths, its
# parameters written through Scope.var / find_var().get_tensor().set,
# against the same values through io.params_from_numpy; OPS21_STEPS steps
OPS21_STEPS = 2
# 21c: book 02's conv net as a script on `import paddle.fluid`, in a child
# process: ALIAS_STEPS Adam steps at batch ALIAS_BATCH, f32 (AMP off),
# cuDNN deterministic, against the same function run in this process
ALIAS_STEPS, ALIAS_BATCH, ALIAS_TIMEOUT = 3, 64, 300
# book 02's conv net (book/test_recognize_digits.py, conv_net) written as
# a reference script writes it, against a ``fluid`` and a ``batch`` it is
# handed: 21c runs it in a child on ``import paddle.fluid`` and here on
# the port's own ``paddle_tpu_torch.fluid``
BOOK02_SCRIPT = '''
import numpy as np


def train(fluid, batch, place, steps, batch_size, seed=0):
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = seed
    with fluid.program_guard(main, startup):
        img = fluid.layers.data(name='img', shape=[1, 28, 28],
                                dtype='float32')
        label = fluid.layers.data(name='label', shape=[1], dtype='int64')
        conv_pool_1 = fluid.nets.simple_img_conv_pool(
            input=img, filter_size=5, num_filters=20, pool_size=2,
            pool_stride=2, act='relu')
        conv_pool_2 = fluid.nets.simple_img_conv_pool(
            input=conv_pool_1, filter_size=5, num_filters=50, pool_size=2,
            pool_stride=2, act='relu')
        prediction = fluid.layers.fc(input=conv_pool_2, size=10,
                                     act='softmax')
        loss = fluid.layers.cross_entropy(input=prediction, label=label)
        avg_loss = fluid.layers.mean(loss)
        fluid.optimizer.Adam(learning_rate=0.001).minimize(avg_loss)
    rng = np.random.RandomState(seed)
    samples = [(rng.rand(1, 28, 28).astype('float32') * 2 - 1,
                int(rng.randint(10))) for _ in range(steps * batch_size)]
    reader = batch(lambda: iter(samples), batch_size)
    feeder = fluid.DataFeeder(feed_list=[img, label], place=place)
    exe = fluid.Executor(place)
    losses = []
    with fluid.scope_guard(fluid.Scope()):
        exe.run(startup)
        for data in reader():
            out, = exe.run(main, feed=feeder.feed(data),
                           fetch_list=[avg_loss])
            losses.append(float(np.asarray(out).ravel()[0]))
    return losses
'''

# 21c's child: the alias installed first, then the script on
# ``import paddle.fluid``; prints its losses (as float.hex), the kernel
# launches and the modules JAX or paddle_tpu would have left
ALIAS_CHILD = '''
import json, os, sys
sys.path.insert(0, os.environ['CHIP_SMOKE_ROOT'])
import paddle_tpu_torch.paddle_alias as alias
alias.install()
from paddle_tpu_torch.compiler import tuning
tuning.set_default_cache(tuning.TuningCache(os.path.join(os.getcwd(),
                                                         'tuning.json')))
import torch
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
torch.backends.cudnn.deterministic = True
import paddle
import paddle.fluid as fluid
from paddle_tpu_torch.ops import cuda_kernels as ck
ns = {}
exec(os.environ['BOOK02_SCRIPT'], ns)
ck.reset_launch_counts()
losses = ns['train'](fluid, paddle.batch, fluid.CUDAPlace(0),
                     int(os.environ['ALIAS_STEPS']),
                     int(os.environ['ALIAS_BATCH']))
torch.cuda.synchronize()
print(json.dumps({
    'losses': [x.hex() for x in losses],
    'launches': dict(ck.LAUNCHES),
    'variants': dict(ck.FUSED_CONV_VARIANT_LAUNCHES),
    'same_fluid': fluid is sys.modules['paddle_tpu_torch.fluid'],
    'foreign': sorted(m for m in sys.modules if m == 'jax' or
                      m.startswith('jax.') or m == 'paddle_tpu' or
                      m.startswith('paddle_tpu.'))}))
'''


def _raw21(L, op_type, inputs, outs, attrs=None):
    """One ``op_type`` op through the LayerHelper; ``outs``: slot ->
    dtype; returns the output Variables in order."""
    helper = L.nn.LayerHelper(op_type)
    made = [(slot, helper.create_tmp_variable(dtype=dt))
            for slot, dt in outs.items()]
    helper.append_op(type=op_type, inputs=inputs,
                     outputs={s: [v] for s, v in made}, attrs=attrs or {})
    return [v for _, v in made]


def _out21(var, slot):
    op = var.block.ops[-1]
    return var.block.var(op.output(slot)[0])


def _ops21_group(group, wide, L, rng, feed, grads):
    """One group of 21a's ops: (exact outputs, float outputs, outputs the
    loss is made of, outputs whose value the inputs do not set). Feeds
    are drawn from ``rng`` into ``feed``; the differentiable inputs of
    the backward are parameters."""
    def data(name, arr, **kw):
        feed[name] = arr
        return L.data(name=name, shape=list(arr.shape),
                      dtype=str(arr.dtype), append_batch_size=False, **kw)

    def param(name, shape):
        return L.create_parameter(shape=list(shape), dtype='float32',
                                  name=name)

    def randn(*shape):
        return rng.randn(*shape).astype('float32')

    exact, near, loss_of, fixed = [], [], [], []
    if group == 'argmax_shape':
        shape = (256, 1000) if wide else (2, 3, 4)
        x = data('x', np.round(randn(*shape), 1))     # ties
        y = data('y', np.where(rng.rand(*shape) < 0.3, feed['x'],
                               randn(*shape)))
        exact += [L.argmax(x, axis=-1), L.argmin(x, axis=-1),
                  L.argmax(x, axis=0), L.argmin(x, axis=1)]
        sh, fl = (_raw21(L, 'shape', {'Input': x}, {'Out': 'int32'})[0],
                  _raw21(L, 'fill', {}, {'Out': 'float32'},
                         {'shape': [2, 3], 'dtype': 'float32',
                          'value': [0.5, 1.0, -2.0, 3.0, 4.0, 5.5]})[0])
        exact += [sh, fl]
        fixed += [sh, fl]
        exact += [_raw21(L, t, {'X': x}, {'Out': 'float32'})[0]
                  for t in ('fill_zeros_like', 'feed', 'fetch')]
        fixed.append(exact[-3])
        exact += [_raw21(L, 'compare', {'X': x, 'Y': y}, {'Out': 'bool'},
                         {'type': t})[0]
                  for t in ('less_than', 'less_equal', 'greater_than',
                            'greater_equal', 'equal', 'not_equal')]
    elif group == 'tensor':
        rows, cols = (4096, 1024) if wide else (3, 4)
        x = data('x', randn(rows, cols))
        n_ids = 8192 if wide else 3
        table = 100000 if wide else 5
        ids = rng.randint(0, table, n_ids).astype('int32')
        ids[-1] = ids[0]                                # a repeated id
        exact += [L.pad(x, paddings=[1, 2, 0, 3], pad_value=-1.5),
                  L.reverse(x, axis=[0, 1]),
                  _raw21(L, 'crop', {'X': x}, {'Out': 'float32'},
                         {'offsets': [1, 1], 'shape': [rows - 2,
                                                       cols - 1]})[0],
                  L.multiplex([x, data('x1', randn(rows, cols)),
                               data('x2', randn(rows, cols))],
                              data('ids3', rng.randint(
                                  0, 3, (rows, 1)).astype('int32'))),
                  L.scatter(data('t', randn(table, 64 if wide else 3)),
                            data('ids', ids),
                            data('upd', randn(n_ids, 64 if wide else 3)))]
        if grads:
            w, u = param('w', (rows, cols)), param('u', (rows, cols))
            sid = data('sid', np.array([2, 0, 2], 'int32'))
            loss_of += [L.pad(w, paddings=[1, 0, 2, 1], pad_value=0.5),
                        L.reverse(w, axis=[0, 1]),
                        _raw21(L, 'crop', {'X': w}, {'Out': 'float32'},
                               {'offsets': [1, 1], 'shape': [2, 2]})[0],
                        L.multiplex([w, u], data(
                            'mid', rng.randint(0, 2, (rows, 1))
                            .astype('int32'))),
                        L.scatter(w, sid, param('su', (3, cols)))]
    elif group == 'math':
        b, d = (256, 4096) if wide else (3, 5)
        x = data('x', randn(b, d))
        y = data('y', randn(b, d))
        near += [L.cumsum(x, axis=1), L.cumsum(x, axis=-1, reverse=True),
                 L.cumsum(x, axis=1, exclusive=True),
                 L.cumsum(x, axis=1, exclusive=True, reverse=True)]
        nrm = L.l2_normalize(x, axis=1)
        near += [nrm, _out21(nrm, 'Norm')]
        c4 = (32, 256, 28, 28) if wide else (2, 3, 2, 2)
        near.append(_raw21(L, 'norm', {'X': data('x4', randn(*c4)),
                                       'Scale': data('sc', randn(c4[1]))},
                           {'Out': 'float32'}, {'epsilon': 1e-10})[0])
        i, j, o = (256, 256, 32) if wide else (4, 3, 2)
        near += [_raw21(L, 'bilinear_tensor_product',
                        {'X': data('bx', randn(b, i)),
                         'Y': data('by', randn(b, j)),
                         'Weight': data('bw', randn(o, i, j)),
                         'Bias': data('bb', randn(1, o))},
                        {'Out': 'float32'})[0],
                 _raw21(L, 'conv_shift', {'X': x, 'Y': data(
                     'cy', randn(b, 33 if wide else 3))},
                     {'Out': 'float32'})[0],
                 _raw21(L, 'smooth_l1_loss', {'X': x, 'Y': y},
                        {'Out': 'float32', 'Diff': 'float32'},
                        {'sigma': 2.0})[0],
                 _raw21(L, 'minus', {'X': x, 'Y': y}, {'Out': 'float32'})[0]]
        if grads:
            w = param('w', (b, d))
            loss_of += [L.cumsum(w, axis=1, exclusive=True, reverse=True),
                        L.l2_normalize(w, axis=1),
                        _raw21(L, 'bilinear_tensor_product',
                               {'X': data('gx', randn(b, i)),
                                'Y': data('gy', randn(b, j)),
                                'Weight': param('gw', (o, i, j)),
                                'Bias': param('gb', (1, o))},
                               {'Out': 'float32'})[0],
                        _raw21(L, 'conv_shift', {'X': w, 'Y': param(
                            'gc', (b, 3))}, {'Out': 'float32'})[0],
                        _raw21(L, 'smooth_l1_loss', {'X': w, 'Y': y},
                               {'Out': 'float32', 'Diff': 'float32'})[0],
                        _raw21(L, 'minus', {'X': w, 'Y': x},
                               {'Out': 'float32'})[0]]
    elif group == 'conv_t':
        # DCGAN's generator layer: 512 -> 256 channels, 4x4 -> 8x8
        shape = (64, 512, 4, 4) if wide else (2, 3, 5, 4)
        kw = dict(num_filters=256, filter_size=4, stride=2, padding=1) \
            if wide else dict(num_filters=2, filter_size=3, stride=2,
                              padding=1, dilation=2)
        out = L.conv2d_transpose(data('x', randn(*shape)), **kw)
        near.append(out)
        if grads:
            loss_of.append(out)
    elif group == 'conv3d':
        n, c, dd, hw = (8, 64, 16, 56) if wide else (2, 4, 5, 6)
        x = data('x', randn(n, c, dd, hw, hw))
        co = 64 if wide else 6
        o = {'Output': 'float32'}
        near += [_raw21(L, 'conv3d', {'Input': x, 'Filter': data(
            'f', randn(co, c, 3, 3, 3) * 0.05)}, o,
            {'strides': [1, 1, 1], 'paddings': [1, 1, 1]})[0]]
        xt = data('xt', randn(n, c, dd // 2, hw // 2, hw // 2))
        near += [_raw21(L, 'conv3d_transpose', {'Input': xt, 'Filter': data(
            'ft', randn(c, co // 2, 2, 2, 2) * 0.1)}, o,
            {'strides': [2, 2, 2], 'paddings': [0, 0, 0]})[0]]
        near += [_raw21(L, 'pool3d', {'X': x}, {'Out': 'float32'},
                        dict(pooling_type=p, ksize=[k] * 3, strides=[2] * 3,
                             paddings=[pd] * 3))[0]
                 for p, k, pd in (('max', 2, 0), ('avg', 3, 1))]
        if grads:
            w = param('w', (n, c, dd, hw, hw))
            loss_of += [_raw21(L, 'conv3d', {'Input': w, 'Filter': param(
                'gf', (co, c // 2, 3, 3, 3))}, o,
                {'strides': [1, 2, 1], 'paddings': [1, 0, 1], 'groups': 2})[0],
                _raw21(L, 'conv3d_transpose', {'Input': w, 'Filter': param(
                    'gt', (c, co // 2, 2, 3, 2))}, o,
                    {'strides': [2, 1, 2], 'paddings': [1, 0, 0],
                     'groups': 2})[0]] + [
                _raw21(L, 'pool3d', {'X': w}, {'Out': 'float32'},
                       dict(pooling_type=p, ksize=[2, 3, 2], strides=[2, 2, 1],
                            paddings=[1, 0, 1]))[0] for p in ('max', 'avg')]
    elif group == 'nn':
        lshape = (64, 96, 55, 55) if wide else (2, 6, 3, 3)
        x = data('x', randn(*lshape))
        lrn = L.lrn(x, n=5, k=2.0, alpha=1e-4, beta=0.75)
        m = 4096 if wide else 12
        p = rng.rand(m).astype('float32')
        near += [lrn, _out21(lrn, 'MidOut'),
                 L.auc(data('p', np.stack([1 - p, p], 1)),
                       data('lab', rng.randint(0, 2, (m, 1)))),
                 L.bilinear_interp(data('bx', randn(
                     *((32, 256, 28, 28) if wide else (2, 2, 3, 4)))),
                     out_h=56 if wide else 5, out_w=56 if wide else 7)]
        classes = 1000 if wide else 5
        onehot = np.eye(classes, dtype='float32')[rng.randint(
            0, classes, m)]
        near += [L.label_smooth(data('oh', onehot), epsilon=0.1),
                 L.label_smooth(data('oh2', onehot), prior_dist=data(
                     'prior', np.full((classes,), 1.0 / classes, 'float32')),
                     epsilon=0.2)]
        dshape = (32, 1, 128, 128) if wide else (2, 1, 3, 4)
        near.append(L.dice_loss(L.sigmoid(data('dx', randn(*dshape))),
                                data('dm', (rng.rand(*dshape) > 0.5)
                                     .astype('float32'))))
        if grads:
            loss_of += [L.lrn(param('w', lshape), n=3, k=2.0, alpha=1e-2),
                        L.bilinear_interp(param('gb', (2, 2, 3, 4)),
                                          out_h=5, out_w=7),
                        L.label_smooth(data('gl', onehot[:2]),
                                       prior_dist=param('gp', (classes,)),
                                       epsilon=0.3),
                        L.dice_loss(L.sigmoid(param('gd', dshape)),
                                    data('gm', (rng.rand(*dshape) > 0.5)
                                         .astype('float32')))]
    elif group == 'nce':
        # dict 2^17, width 512, batch 256, 10 negatives pinned: the JAX
        # package's draws and the Scope's never agree
        b, dim, classes = (256, 512, 2 ** 17) if wide else (4, 6, 13)
        neg = rng.randint(0, classes, 10 if wide else 5).tolist()
        cost = L.nce(data('x', randn(b, dim)),
                     data('lab', rng.randint(0, classes, (b, 2))),
                     num_total_classes=classes, num_neg_samples=len(neg),
                     sample_weight=data('sw', rng.rand(b, 1)
                                        .astype('float32')))
        cost.block.ops[-1].attrs['custom_neg_classes'] = neg
        near += [cost, _out21(cost, 'SampleLogits')]
        exact.append(_out21(cost, 'SampleLabels'))
        if grads:
            loss_of.append(cost)
    elif group == 'pool_index':
        shape = (32, 64, 112, 112) if wide else (2, 3, 5, 6)
        x = data('x', np.round(randn(*shape) * 2))       # ties
        out, mask = L.max_pool2d_with_index(x, pool_size=2, pool_stride=2)
        out3, mask3 = L.max_pool2d_with_index(x, pool_size=3, pool_stride=2,
                                              pool_padding=1)
        near += [out, out3, L.unpool(out, mask, pool_size=2, pool_stride=2)]
        exact += [mask, mask3]
        sx = data('sx', randn(*((32, 256, 13, 13) if wide else (2, 3, 5, 7))))
        near += [L.spp(sx, pyramid_height=3, pool_type='max'),
                 L.spp(sx, pyramid_height=3, pool_type='avg')]
        if grads:
            w = param('w', (2, 3, 5, 7))
            o3, m3 = L.max_pool2d_with_index(w, pool_size=3, pool_stride=2,
                                             pool_padding=1)
            loss_of += [o3, L.unpool(o3, m3, pool_size=3, pool_stride=2,
                                     pool_padding=1),
                        L.spp(w, pyramid_height=3, pool_type='avg')]
    elif group == 'metrics':
        m, k, q = (4096, 10, 32) if wide else (12, 4, 2)
        idx = data('idx', rng.randint(0, k, (m, 1)))
        lab = data('mlab', rng.randint(0, k, (m, 1)))
        wts = data('wts', rng.rand(m, 1).astype('float32'))
        pr = {'BatchMetrics': 'float32', 'AccumMetrics': 'float32',
              'AccumStatesInfo': 'float32'}
        near += _raw21(L, 'precision_recall',
                       {'Indices': idx, 'Labels': lab, 'Weights': wts,
                        'StatesInfo': data('st', rng.rand(k, 4)
                                           .astype('float32') * 10)},
                       pr, {'class_number': k})
        pn = {'PositivePair': 'float32', 'NegativePair': 'float32',
              'NeutralPair': 'float32'}
        near += _raw21(L, 'positive_negative_pair',
                       {'Score': data('score', np.round(randn(m, 2))),
                        'Label': lab, 'Weight': wts,
                        'QueryID': data('qid', np.sort(rng.randint(
                            0, q, (m, 1)), 0))}, pn, {'column': 1})
    elif group == 'rnn':
        lens = [30, 17, 25, 9] * 8 if wide else [2, 4, 3]
        hid = 128 if wide else 2
        rows = sum(lens)

        def seq(name, width):
            feed[name] = (randn(rows, width) * 0.5, lens)
            return L.data(name=name, shape=[width], dtype='float32',
                          lod_level=1)
        outs = []
        for op_type, width in (('lstm', 4 * hid), ('lstmp', 4 * hid),
                               ('gru', 3 * hid)):
            x = seq('s_' + op_type, width)
            if op_type == 'gru':
                h = L.dynamic_gru(x, size=hid)
            elif op_type == 'lstm':
                h, _ = L.dynamic_lstm(x, size=4 * hid)
            else:
                h, _ = L.dynamic_lstmp(x, size=4 * hid, proj_size=hid // 2)
            h.block.ops[-1].type = op_type
            outs.append(h)
        near += outs
        if grads:
            loss_of += outs
    else:
        raise KeyError(group)
    return exact, near, loss_of, fixed


OPS21_GROUPS = ('argmax_shape', 'tensor', 'math', 'conv_t', 'conv3d', 'nn',
                'nce', 'pool_index', 'metrics', 'rnn')


def _ops21_program(group, wide, seed):
    """(main, startup, feed, exact names, float names, fixed names)."""
    import paddle_tpu_torch as pt
    L = pt.layers
    grads = not wide or group in OPS21_WIDE_GRADS
    rng = np.random.RandomState(seed)
    main, startup = pt.Program(), pt.Program()
    startup.random_seed = seed
    feed = {}
    with pt.unique_name.guard(), pt.program_guard(main, startup):
        exact, near, loss_of, fixed = _ops21_group(group, wide, L, rng, feed,
                                                   grads)
        if loss_of:
            loss = L.sums([L.mean(L.square(o)) for o in loss_of])
            pt.backward.append_backward(loss)
            near = near + [loss] + [
                main.global_block().var(p.name + '@GRAD')
                for p in main.global_block().all_parameters()]
    for n, v in list(feed.items()):
        if isinstance(v, tuple):       # a sequence: rows and lengths
            rows, lens = v
            feed[n] = ('seq', rows, [list(lens)])
    return (main, startup, feed, [v.name for v in exact],
            [v.name for v in near], {v.name for v in fixed})


def _ops21_feed(feed, place):
    import paddle_tpu_torch as pt
    return {n: pt.create_lod_tensor(v[1], v[2], place)
            if isinstance(v, tuple) else v for n, v in feed.items()}


def _ops21_run(place, main, startup, feed, names, state):
    import paddle_tpu_torch as pt
    from paddle_tpu_torch import io as pt_io
    exe, scope = pt.Executor(place), pt.Scope()
    exe.run(startup, scope=scope)
    pt_io.params_from_numpy(scope, state, place)
    out = exe.run(main, feed=_ops21_feed(feed, place), fetch_list=names,
                  scope=scope)
    return dict(zip(names, [np.asarray(o) for o in out]))


def _ops21_reading(got, ref, exact):
    """0 where equal (exact) or the f32 reading max |got - ref| / max
    |ref|, the scale taken over values below 1e30 (spp's max pools a
    bin of padding to finfo.min, as paddle_tpu does); inf where the
    shapes or the exact values differ."""
    g, r = np.asarray(got), np.asarray(ref)
    if g.shape != r.shape:
        return float('inf')
    if exact:
        return 0.0 if np.array_equal(g, r) else float('inf')
    a = np.abs(r.astype(np.float64))
    scale = a[a < 1e30].max() if (a < 1e30).any() else 0.0
    return float(np.abs(g.astype(np.float64) - r).max() / max(scale, 1e-30))


def _phase21_ops(seed, card):
    """21a. Returns the count of fetches held."""
    import torch
    import torch.nn.functional as F
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.core import amp
    amp.set_amp(False)
    prev_tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True      # PyTorch's default
    held = 0
    try:
        for group in OPS21_GROUPS:
            for wide in OPS21_SIZES:
                t0 = time.perf_counter()
                main, startup, feed, exact, near, fixed = _ops21_program(
                    group, wide, seed)
                state = _startup_state(startup)
                names = exact + near
                card_out = _ops21_run(pt.CUDAPlace(0), main, startup, feed,
                                      names, state)
                cpu_out = _ops21_run(pt.CPUPlace(), main, startup, feed,
                                     names, state)
                # the control: the next seed's inputs and parameters
                o_main, o_startup, other = _ops21_program(group, wide,
                                                          seed + 1)[:3]
                ctl_out = _ops21_run(pt.CPUPlace(), main, startup, other,
                                     names, _startup_state(o_startup))
                worst = {'exact': 0.0, 'f32': 0.0}
                ctl_min = {'exact': float('inf'), 'f32': float('inf')}
                for n in names:
                    kind = 'exact' if n in exact else 'f32'
                    limit = 0.0 if kind == 'exact' else OPS21_TOL
                    r = _ops21_reading(card_out[n], cpu_out[n], kind ==
                                       'exact')
                    check(np.isfinite(np.asarray(cpu_out[n], np.float64))
                          .all(), 'phase 21a: %s %s: %s not finite on the '
                          'CPU' % (group, 'wide' if wide else 'ref', n))
                    check(r <= limit, 'phase 21a: %s (%s) on the card reads '
                          '%g from the CPU (limit %g)' % (
                              n, group, r, limit))
                    worst[kind] = max(worst[kind], r)
                    if n not in fixed:
                        c = _ops21_reading(card_out[n], ctl_out[n],
                                           kind == 'exact')
                        check(c > limit, 'phase 21a: %s (%s): the next '
                              'seed\'s inputs read %g, inside the limit %g'
                              % (n, group, c, limit))
                        ctl_min[kind] = min(ctl_min[kind], c)
                held += len(names)
                print('phase 21a: %s %s: %d fetches (%d exact) card against '
                      'CPU, worst %s against limits exact and %g; the next '
                      'seed\'s inputs read at least %s (%d fixed outputs '
                      'exempt); %.1f s' % (
                          group, 'wide' if wide else 'ref', len(names),
                          len(exact), ', '.join('%s %.3g' % kv for kv in
                                                sorted(worst.items())),
                          OPS21_TOL, ', '.join('%s %.3g' % kv for kv in
                                               sorted(ctl_min.items())),
                          len(fixed), time.perf_counter() - t0), flush=True)
                del card_out, cpu_out, ctl_out, state
                torch.cuda.empty_cache()
        # the second control of each limit: what the port guards against
        # must fail it. f32: DCGAN's transposed conv in cuDNN with TF32
        # on (its default), called directly
        rng = np.random.RandomState(seed)
        x = rng.randn(64, 512, 4, 4).astype('float32')
        w = (rng.randn(512, 256, 4, 4) * 0.05).astype('float32')
        ref = F.conv_transpose2d(torch.from_numpy(x), torch.from_numpy(w),
                                 stride=2, padding=1).numpy()
        tf32 = F.conv_transpose2d(torch.from_numpy(x).cuda(),
                                  torch.from_numpy(w).cuda(), stride=2,
                                  padding=1).cpu().numpy()
        c_tf32 = _ops21_reading(tf32, ref, False)
        check(c_tf32 > OPS21_TOL, 'phase 21a: cuDNN with TF32 on reads '
              '%g, inside the f32 limit' % c_tf32)
        # and the backward: the filter gradient of the wide gradients'
        # grouped conv3d from one fixed output gradient, in cuDNN with
        # TF32 on, called directly (its input gradient, printed beside,
        # reads the same with TF32 off: cuDNN's algorithm for it at this
        # shape does not use TF32)
        xg = rng.randn(8, 64, 16, 56, 56).astype('float32')
        fg = rng.randn(64, 32, 3, 3, 3).astype('float32')
        gout = rng.randn(8, 64, 16, 27, 56).astype('float32')

        def conv3d_grads(dev):
            a = torch.from_numpy(xg).to(dev).requires_grad_()
            b = torch.from_numpy(fg).to(dev).requires_grad_()
            F.conv3d(a, b, stride=(1, 2, 1), padding=(1, 0, 1),
                     groups=2).backward(torch.from_numpy(gout).to(dev))
            return [t.grad.cpu().numpy() for t in (a, b)]
        c_bwd = [_ops21_reading(t, r, False) for t, r in
                 zip(conv3d_grads('cuda'), conv3d_grads('cpu'))]
        check(c_bwd[1] > OPS21_TOL, 'phase 21a: the conv3d filter '
              'gradient in cuDNN with TF32 on reads %g, inside the f32 '
              'limit' % c_bwd[1])
        del xg, gout
        # exact: ties broken the other way (arg_max's last maximum) and a
        # repeated scatter id whose first row wins
        ties = np.round(rng.randn(256, 1000), 1).astype('float32')
        tc = torch.from_numpy(ties).cuda()
        last = (ties.shape[1] - 1 - torch.flip(tc, [1]).argmax(1)).cpu()
        c_ties = _ops21_reading(last.numpy(), ties.argmax(1), True)
        ids = np.array([3, 1, 3], 'int64')
        upd = rng.randn(3, 4).astype('float32')
        first = np.zeros((5, 4), 'float32')
        first[ids[::-1]] = upd[::-1]
        last_wins = np.zeros((5, 4), 'float32')
        last_wins[ids] = upd
        c_first = _ops21_reading(first, last_wins, True)
        check(c_ties > 0 and c_first > 0, 'phase 21a: the tie controls do '
              'not fail the exact limit (%g, %g)' % (c_ties, c_first))
        print('phase 21a: %d fetches of the 38 ops held; controls: '
              'DCGAN\'s conv2d_transpose in cuDNN with TF32 on reads %.3g, '
              'the wide conv3d\'s filter gradient with TF32 on %.3g (its '
              'input gradient %.3g) (limit %g), arg_max taking the last tie and '
              'scatter taking the first of a repeated id read %s and %s '
              '(exact); %s' % (held, c_tf32, c_bwd[1], c_bwd[0], OPS21_TOL,
                               c_ties, c_first, card), flush=True)
    finally:
        torch.backends.cudnn.allow_tf32 = prev_tf32
        amp.set_amp(None)
    return held


def _phase21_binding(seed, card):
    """21b: book 07's parameters written through the live binding."""
    import torch
    import paddle_tpu_torch as pt
    from paddle_tpu_torch import io as pt_io
    from paddle_tpu_torch.models import books
    main, startup, book = _book_program('label_semantic_roles', seed)
    state = _startup_state(startup)
    state['emb'] = books.srl_embedding()
    for v in book.evaluator.states:     # slots the startup does not make
        state[v.name] = np.zeros([1], 'int64')
    gen = _book_batches(book, seed)
    batches = [next(gen) for _ in range(OPS21_STEPS)]
    feeder = pt.DataFeeder(feed_list=book.feeds, place=pt.CUDAPlace(0),
                           program=main)
    feeds = [feeder.feed(b) for b in batches]
    prev_det = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True

    def run(through_binding):
        exe, scope = pt.Executor(), pt.Scope()
        exe.run(startup, scope=scope)
        if through_binding:
            # find_var where the startup made the slot (book 07's
            # script: its 'emb'), scope.var where nothing did (the
            # evaluator's counts)
            for n, v in sorted(state.items()):
                (scope.find_var(n) or scope.var(n)).get_tensor().set(
                    v, pt.CUDAPlace(0))
        else:
            pt_io.params_from_numpy(scope, state, pt.CUDAPlace(0))
        losses = []
        with pt.scope_guard(scope):
            for f in feeds:
                out, = exe.run(main, feed=f, fetch_list=[book.loss])
                losses.append(float(np.asarray(out).ravel()[0]))
            crfw = pt_io.get_parameter_value_by_name('crfw', exe, main)
        return losses, crfw, scope

    try:
        bound, crfw, scope = run(True)
        loaded, _, _ = run(False)
        witness, _, _ = run(False)
    finally:
        torch.cuda.synchronize()
        torch.backends.cudnn.deterministic = prev_det
    raw = scope.raw('crfw')
    check(raw.is_cuda and str(raw.dtype) == 'torch.float32',
          'phase 21b: the set parameter is not an f32 tensor on the card')
    check(np.array_equal(crfw, raw.detach().cpu().numpy()),
          'phase 21b: get_parameter_value_by_name differs from the Scope\'s '
          'tensor')
    b, l, w = (np.asarray(x, np.float64) for x in (bound, loaded, witness))
    diff, wdiff = float(np.abs(b - l).max()), float(np.abs(w - l).max())
    print('phase 21b: book 07 (label_semantic_roles, hidden 512, depth 8), '
          '%d SGD steps at batch %d, parameters through find_var / '
          'scope.var(n).get_tensor().set(np, CUDAPlace(0)): losses %s; '
          'through params_from_numpy %s; a second params_from_numpy run '
          '(witness) %s; max |set - loaded| %.3g, max |witness - loaded| '
          '%.3g; get_parameter_value_by_name(\'crfw\') equal to the Scope\'s '
          'tensor; %s' % (
              OPS21_STEPS, book.batch_size, ' '.join(x.hex() for x in bound),
              ' '.join(x.hex() for x in loaded),
              ' '.join(x.hex() for x in witness), diff, wdiff, card),
          flush=True)
    check(np.isfinite(b).all(), 'phase 21b: a non-finite loss')
    if wdiff == 0:
        check(diff == 0, 'phase 21b: the losses through set differ by %g '
              'from params_from_numpy\'s (the witness is bit-equal)' % diff)
    else:
        print('phase 21b: not bit-equal: two params_from_numpy runs already '
              'part by %.3g (the sparse tables\' rows are added with atomics '
              'on the card)' % wdiff, flush=True)
        check(diff <= RIO_WITNESS_MARGIN * wdiff, 'phase 21b: the losses '
              'through set differ by %g, over %g times the witness\'s %g'
              % (diff, RIO_WITNESS_MARGIN, wdiff))
    del scope
    torch.cuda.empty_cache()


def _phase21_alias(seed, card):
    """21c; returns the fused conv launches of its two runs."""
    import torch
    import paddle_tpu_torch as pt
    import paddle_tpu_torch.fluid as ptf
    from paddle_tpu_torch.core import amp
    from paddle_tpu_torch.ops import cuda_kernels as ck
    env = dict(os.environ, CHIP_SMOKE_ROOT=ROOT, BOOK02_SCRIPT=BOOK02_SCRIPT,
               ALIAS_STEPS=str(ALIAS_STEPS), ALIAS_BATCH=str(ALIAS_BATCH),
               PADDLE_TPU_TORCH_AMP='0')
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=os.path.join(ROOT, 'build')) as d:
        proc = subprocess.run([sys.executable, '-c', ALIAS_CHILD], cwd=d,
                              env=env, capture_output=True, text=True,
                              timeout=ALIAS_TIMEOUT)
    child_s = time.perf_counter() - t0
    check(proc.returncode == 0, 'phase 21c: the child failed (%d): %s' % (
        proc.returncode, proc.stderr[-3000:]))
    child = json.loads(proc.stdout.strip().splitlines()[-1])
    ns = {}
    exec(BOOK02_SCRIPT, ns)
    prev_det = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    amp.set_amp(False)
    try:
        ck.reset_launch_counts()
        direct = ns['train'](ptf, pt.reader.batch, pt.CUDAPlace(0),
                             ALIAS_STEPS, ALIAS_BATCH)
        torch.cuda.synchronize()
        launches = dict(ck.LAUNCHES)
        variants = dict(ck.FUSED_CONV_VARIANT_LAUNCHES)
    finally:
        torch.backends.cudnn.deterministic = prev_det
        amp.set_amp(None)
    got = [float.fromhex(x) for x in child['losses']]
    same = got == direct
    print('phase 21c: book 02\'s conv net as a script on `import '
          'paddle.fluid` (paddle_alias.install()) in a child process, %d '
          'Adam steps at batch %d, f32: losses %s; a direct run of the port '
          '%s: %s; fused_conv launches in the child %d (by variant %s), in '
          'the direct run %d (%s); paddle.fluid is paddle_tpu_torch.fluid: '
          '%s; jax and paddle_tpu modules in the child: %s; the child %.1f s; '
          '%s' % (ALIAS_STEPS, ALIAS_BATCH, ' '.join(child['losses']),
                  ' '.join(x.hex() for x in direct),
                  'bit-equal' if same else 'NOT bit-equal',
                  child['launches']['fused_conv'], child['variants'],
                  launches['fused_conv'], variants, child['same_fluid'],
                  child['foreign'] or 'none', child_s, card), flush=True)
    check(child['same_fluid'], 'phase 21c: paddle.fluid is not the port\'s')
    check(not child['foreign'], 'phase 21c: the child imported %s'
          % child['foreign'])
    check(np.isfinite(got).all() and len(got) == ALIAS_STEPS,
          'phase 21c: the child\'s losses %s' % got)
    want = {k: 0 for k in child['launches']}
    want['fused_conv'] = 2 * ALIAS_STEPS
    check(child['launches'] == want and launches == want,
          'phase 21c: launches %s in the child, %s here; expected %s' % (
              child['launches'], launches, want))
    check(child['variants'].get('tf32') == 2 * ALIAS_STEPS and
          variants.get('tf32') == 2 * ALIAS_STEPS,
          'phase 21c: the fused conv ran the variants %s / %s, not tf32'
          % (child['variants'], variants))
    if not same:
        print('phase 21c: not bit-equal: max |child - direct| %.3g; both ran '
              'the same kernels in the same order, so the difference comes '
              'from a kernel that is not reproducible between processes'
              % max(abs(a - b) for a, b in zip(got, direct)), flush=True)
        check(max(abs(a - b) for a, b in zip(got, direct)) <= OPS21_TOL *
              max(abs(b) for b in direct), 'phase 21c: the child\'s losses '
              'part from the direct run\'s')
    return {'fused_conv': child['launches']['fused_conv'] +
            launches['fused_conv']}


def phase_public_api(seed, card):
    """21. The rest of the op kernels (21a), the live Scope binding
    (21b) and the ``paddle`` alias (21c). Returns the kernel launches of
    its main paths."""
    import torch
    t_phase = time.perf_counter()
    _phase21_ops(seed, card)
    _phase21_binding(seed, card)
    launches = _phase21_alias(seed, card)
    torch.cuda.empty_cache()
    print('phase 21: %.1f s; %.1f s since the process started' % (
        time.perf_counter() - t_phase, time.perf_counter() - _STARTED),
        flush=True)
    return launches


# ---- 22. MobileNet-v1 through the depthwise kernel -------------------------------
# 22a: the depthwise kernel at MobileNet-v1's 13 depthwise 3x3 convs (224
# input, batch MOBILENET_BATCH): ((H, W, C, stride), count), f32 and bf16,
# in the inference form (the batch norm folded, ReLU) and the stats form.
# Each layer within conv_err_ratio <= 1 of the plain version (the stats
# form's moments within STATS_REL), the same bits on a second call (the
# slab too), in f32 within CONV_F64_WITNESS times the plain f32 version's
# error against f64 (on the first MOBILENET_WITNESS_IMAGES images); timed
# against the plain version, cuDNN's grouped conv with TF32 off (the
# stats form: plus its two channel sums) and conv_bound. Controls: each
# channel's taps shifted by one must fail the inference limit, the slab
# without its last slot the moments' one
MOBILENET_DW = (((112, 112, 32, 1), 1), ((112, 112, 64, 2), 1),
                ((56, 56, 128, 1), 1), ((56, 56, 128, 2), 1),
                ((28, 28, 256, 1), 1), ((28, 28, 256, 2), 1),
                ((14, 14, 512, 1), 5), ((14, 14, 512, 2), 1),
                ((7, 7, 1024, 1), 1))
MOBILENET_BATCH = 32
MOBILENET_WITNESS_IMAGES = 4
# 22b: MobileNet-v1 (Howard et al. 2017, Table 1: 224 x 224, width
# multiplier 1.0, 1000 classes), random weights from the seed, through
# save_inference_model / load_inference_model and the Executor: served in
# f32 at MOBILENET_SERVE_BATCHES and under AMP (bf16) at MOBILENET_BATCH;
# the logits against the same program on the plain fused conv: f32 within
# MOBILENET_LOGITS_TOL (BENCH_LOGITS_TOL's f32 rule: the same sums in
# another order), AMP within RESNET_LOGITS_TOL and RESNET_TOP1. Trained
# MOBILENET_TRAIN_STEPS steps of Momentum(0.01, 0.9) at MOBILENET_BATCH in
# f32 and AMP, by phase_resnet_training's rule (finite losses that fall)
# and, in f32,
# the first step's loss (the forward alone, before any update) within
# MOBILENET_LOSS_WITNESS times the distance of a witness (the plain
# forward in f64, rounded) from the plain path's, at least
# MOBILENET_LOSS_FLOOR of it. The later steps' losses and AMP's are
# printed, not held: at random weights the gradients move by percents
# with rounding (27 train-mode batch norms, no residual path), and under
# AMP the taps-shifted control's first loss reads within bf16's rounding
# of the plain one (the loss at random weights barely depends on the
# features). The gradients and moving statistics of one step are held by
# _hold_gradients (RESNET_GRAD_WITNESS times the witness in both
# precisions). Exactly MOBILENET_DW_REGIONS depthwise launches a request
# (inference form) and a step (stats form) among MOBILENET_REGIONS
# fused_conv regions; controls: the taps shifted by one on the depthwise
# regions must fail the logits limits and the f32 first-loss limit.
# The depthwise regions' share of a served request's op time from the
# profiler's op table over MOBILENET_PROFILE_RUNS requests
MOBILENET = dict(size=224, classes=1000, scale=1.0)
MOBILENET_BLOCKS = (((32, 64, 1), (64, 128, 2), (128, 128, 1),
                     (128, 256, 2), (256, 256, 1), (256, 512, 2)) +
                    ((512, 512, 1),) * 5 + ((512, 1024, 2), (1024, 1024, 1)))
MOBILENET_SERVE_BATCHES = (1, 8, 32)
MOBILENET_LOGITS_TOL = 1e-4
MOBILENET_TRAIN_STEPS = 3
MOBILENET_LOSS_WITNESS = 2.0
MOBILENET_LOSS_FLOOR = 1e-6
MOBILENET_DW_REGIONS = 13
MOBILENET_REGIONS = 27
MOBILENET_PROFILE_RUNS = 3


def mobilenet_v1(layers, img, class_dim=1000, scale=1.0, is_test=False):
    """MobileNet-v1 (Howard et al. 2017, Table 1) on ``img`` (NCHW),
    written with ``layers`` (the port's, or paddle_tpu's: the CPU test
    builds both): a 3x3 stride-2 conv of 32 * ``scale`` filters, the 13
    depthwise-separable blocks of MOBILENET_BLOCKS (a 3x3
    conv2d(groups=C) and a 1x1 conv2d, each without bias, then
    batch_norm and relu), a global average pool2d and an fc with softmax
    over ``class_dim`` classes. Returns the probabilities."""
    def conv_bn(x, filters, size, stride, groups=1):
        conv = layers.conv2d(input=x, num_filters=filters, filter_size=size,
                             stride=stride, padding=(size - 1) // 2,
                             groups=groups, act=None, bias_attr=False)
        return layers.relu(layers.batch_norm(input=conv, is_test=is_test))

    x = conv_bn(img, int(32 * scale), 3, 2)
    for cin, cout, stride in MOBILENET_BLOCKS:
        x = conv_bn(x, int(cin * scale), 3, stride, groups=int(cin * scale))
        x = conv_bn(x, int(cout * scale), 1, 1)
    x = layers.pool2d(input=x, pool_type='avg', global_pooling=True)
    return layers.fc(input=x, size=class_dim, act='softmax')


def _shift_taps(w):
    """A depthwise w [KH, KW, C] with each channel's taps shifted by one
    (a control)."""
    kh, kw, c = w.shape
    return w.reshape(kh * kw, c).roll(1, 0).reshape(kh, kw, c)


def _taps_shifted_conv(x, w, aux, kinds, stages, strides, pads, depthwise,
                       emit_stats=False):
    """The fused conv kernel with each depthwise region's taps shifted by
    one (a control for the whole model, both forms)."""
    from paddle_tpu_torch.ops import cuda_kernels as ck
    return ck.fused_conv(x, _shift_taps(w) if depthwise else w, aux, kinds,
                         stages, strides, pads, depthwise, emit_stats)


def _every_tap_shifted_conv(x, w, aux, kinds, stages, strides, pads,
                            depthwise, emit_stats=False):
    """The fused conv kernel with every region's taps shifted by one, the
    dense convs' too (a control for a model with no depthwise region)."""
    from paddle_tpu_torch.ops import cuda_kernels as ck
    if depthwise:
        w = _shift_taps(w)
    else:
        cout, kh, kw, cin = w.shape
        w = w.reshape(cout, kh * kw, cin).roll(1, 1).reshape(cout, kh, kw,
                                                              cin)
    return ck.fused_conv(x, w, aux, kinds, stages, strides, pads, depthwise,
                         emit_stats)


def _dw_kernel_log():
    """The depthwise kernel's lines of the fused conv library's ptxas
    output: each instance's registers, shared memory and spills."""
    from paddle_tpu_torch.ops import _build
    lines = _build.build_log('fused_conv').splitlines()
    out = []
    for i, line in enumerate(lines):
        if 'conv_dw_kernel' in line and 'Compiling entry' in line:
            out.append(re.sub(r'.*(_Z\w+).*', r'\1', line) + ': ' + ' '.join(
                l.strip() for l in lines[i + 1:i + 5]
                if 'Used' in l or 'spill' in l))
    return out


def _phase22_kernel(seed, card):
    """22a: the depthwise kernel at MobileNet-v1's 13 layers, both
    dtypes and both forms, checked and timed. Returns {form: {dtype:
    totals}}."""
    import torch
    import torch.nn.functional as F
    from paddle_tpu_torch.ops import cuda_kernels as ck
    for line in _dw_kernel_log():
        print('phase 22a: ptxas %s' % line, flush=True)
    gen = torch.Generator(device='cuda')
    gen.manual_seed(seed + 22)
    stages = (('affine', 0, 1), ('act', 'relu'))
    kinds = ('c', 'c')
    N = MOBILENET_BATCH
    sms = ck._sm_count(0)
    sums = {'inference': {}, 'stats': {}}
    for dtype in ('float32', 'bfloat16'):
        tot = {form: dict(ms=0.0, plain_ms=0.0, library_ms=0.0, bound_ms=0.0,
                          max_abs_err=0.0, layers=0, bound_by={})
               for form in sums}
        for (H, W, C, s), count in MOBILENET_DW:
            x, w, aux = _conv_inputs(gen, dtype, N, H, W, C, C, 3, s, 1,
                                     True, kinds)
            args = (x, w, aux, kinds, stages, (s, s), (1, 1), True)
            what = '%dx%d C %d s %d %s' % (H, W, C, s, dtype)
            for stats in (False, True):
                plan = ck.fused_conv_plan(x.dtype, N, H, W, C, C, 3, 3,
                                          (s, s), (1, 1), True, sms,
                                          emit_stats=stats)
                check(plan.variant == 'depthwise', 'phase 22a: the plan '
                      'took %s at %s' % (plan.variant, what))
            tile = ck.depthwise_tile(x.dtype, N, H, W, C, 3, 3, (s, s),
                                     (1, 1), sms)
            # the inference form
            before = ck.FUSED_CONV_VARIANT_LAUNCHES['depthwise']
            got = ck.fused_conv(*args)
            same = torch.equal(got, ck.fused_conv(*args))
            torch.cuda.synchronize()
            check(ck.FUSED_CONV_VARIANT_LAUNCHES['depthwise'] == before + 2,
                  'phase 22a: the depthwise kernel was not launched at '
                  + what)
            ref = ck.fused_conv_reference(*args)
            err = (got.float() - ref.float()).abs().max().item()
            ratio = conv_err_ratio(got, ref, dtype)
            control = conv_err_ratio(ck.fused_conv(
                x, _shift_taps(w), *args[2:]), ref, dtype)
            witness = ''
            if dtype == 'float32':
                errs = check_f64_witness(got, ref, args, 'phase 22a ' + what,
                                         images=MOBILENET_WITNESS_IMAGES)
                witness = '; against f64: kernel %.3g, plain %.3g' % errs
            check(same, 'phase 22a: two calls gave other bits at ' + what)
            check(ratio <= 1, 'phase 22a: the depthwise kernel disagrees '
                  'with its plain version at ' + what)
            check(control > 1, 'phase 22a: the limit does not catch the '
                  'taps shifted by one at ' + what)
            kernel_ms = graph_ms(lambda: ck.fused_conv(*args))
            plain_ms = graph_ms(lambda: ck.fused_conv_reference(*args),
                                iters=3, reps=3)
            xc = x.permute(0, 3, 1, 2)
            wc = w.permute(2, 0, 1).unsqueeze(1)
            library_ms = graph_ms(lambda: F.conv2d(xc, wc, stride=s,
                                                   padding=1, groups=C))
            bound_ms, by = conv_bound(x, w, aux, got, 3, s, 1, True)
            print('phase 22a: depthwise %s x%d, %s: err/limit %.3g (max|err| '
                  '%.3g), taps shifted %.3g, two calls bit-identical %s%s; '
                  'kernel_ms %.4f plain_ms %.4f cudnn_ms %.4f bound_ms %.4f '
                  '(%s)' % (what, count, tile, ratio, err, control, same,
                            witness, kernel_ms, plain_ms, library_ms,
                            bound_ms, by), flush=True)
            t = tot['inference']
            for key, v in (('ms', kernel_ms), ('plain_ms', plain_ms),
                           ('library_ms', library_ms), ('bound_ms', bound_ms)):
                t[key] += count * v
            t['bound_by'][by] = t['bound_by'].get(by, 0.0) + count * bound_ms
            t['max_abs_err'] = max(t['max_abs_err'], err)
            t['layers'] += count
            del got, ref
            # the stats form: checked by _check_stats_case (two calls, the
            # moments, f32 against f64, the last slot dropped)
            before = ck.FUSED_CONV_VARIANT_LAUNCHES['depthwise']
            err = _check_stats_case(
                x, w, s, 1, True, dtype,
                MOBILENET_WITNESS_IMAGES if dtype == 'float32' else None)
            check(ck.FUSED_CONV_VARIANT_LAUNCHES['depthwise'] > before,
                  'phase 22a: the stats form did not launch the depthwise '
                  'kernel at ' + what)
            sargs = (x, w, (), (), (), (s, s), (1, 1), True)
            y = ck.fused_conv(*sargs, emit_stats=True)[0]
            bound_ms, by = conv_bound(x, w, [], y, 3, s, 1, True, 2 * 4 * C)
            kernel_ms = graph_ms(lambda: ck.fused_conv(*sargs,
                                                       emit_stats=True))
            plain_ms = graph_ms(lambda: ck.fused_conv_reference(
                *sargs, emit_stats=True), iters=3, reps=3)

            def library():
                c = F.conv2d(xc, wc, stride=s, padding=1, groups=C).float()
                return c.sum((0, 2, 3)), (c * c).sum((0, 2, 3))
            library_ms = graph_ms(library)
            print('phase 22a: depthwise stats form %s x%d: kernel_ms %.4f '
                  'plain_ms %.4f cudnn+sums_ms %.4f bound_ms %.4f (%s); '
                  'slab slots %d' % (what, count, kernel_ms, plain_ms,
                                     library_ms, bound_ms, by, tile.blocks),
                  flush=True)
            t = tot['stats']
            for key, v in (('ms', kernel_ms), ('plain_ms', plain_ms),
                           ('library_ms', library_ms), ('bound_ms', bound_ms)):
                t[key] += count * v
            t['bound_by'][by] = t['bound_by'].get(by, 0.0) + count * bound_ms
            t['max_abs_err'] = max(t['max_abs_err'], err)
            t['layers'] += count
            del x, w, aux, args, sargs, y, xc, wc
        for form, t in tot.items():
            check(t['layers'] == 13, 'phase 22a: %d layers' % t['layers'])
            t['bound_by'] = max(t['bound_by'], key=t['bound_by'].get)
            print('phase 22a: MobileNet-v1\'s 13 depthwise convs, batch %d, '
                  '%s, %s form, summed: kernel %.4f ms, plain %.4f ms, %s '
                  '%.4f ms, bound %.4f ms (%s): %.2fx the library call, '
                  '%.1f%% of the bound\'s speed; %s' % (
                      N, dtype, form, t['ms'], t['plain_ms'],
                      'cuDNN' if form == 'inference' else 'cuDNN + sums',
                      t['library_ms'], t['bound_ms'], t['bound_by'],
                      t['ms'] / t['library_ms'],
                      100 * t['bound_ms'] / t['ms'], card), flush=True)
            sums[form][dtype] = t
    torch.cuda.empty_cache()
    return sums


def _mobilenet_program(seed, size=None, is_test=False, train=False):
    """MobileNet-v1 built with the port's layers: (main, startup,
    probabilities, loss or None)."""
    import paddle_tpu_torch as pt
    main, startup = pt.Program(), pt.Program()
    startup.random_seed = seed
    size = size or MOBILENET['size']
    loss = None
    with pt.unique_name.guard(), pt.program_guard(main, startup):
        img = pt.layers.data(name='data', shape=[3, size, size],
                             dtype='float32')
        prob = mobilenet_v1(pt.layers, img, MOBILENET['classes'],
                            MOBILENET['scale'], is_test=is_test)
        if train:
            label = pt.layers.data(name='label', shape=[1], dtype='int64')
            loss = pt.layers.mean(pt.layers.cross_entropy(input=prob,
                                                          label=label))
            pt.optimizer.Momentum(learning_rate=0.01,
                                  momentum=0.9).minimize(loss)
    return main, startup, prob, loss


def _mobilenet_feed(bs, seed):
    rng = np.random.RandomState(seed)
    return {'data': rng.randn(bs, 3, MOBILENET['size'],
                              MOBILENET['size']).astype('float32')}


def _depthwise_flags(prog, fetch_names):
    """Whether each fused_conv region of ``prog`` (in the order the
    Executor runs them) is depthwise."""
    import paddle_tpu_torch as pt
    opt, _ = pt.compiler.optimize(prog, fetch_names=fetch_names)
    block = opt.global_block()
    flags = []
    for op in block.ops:
        if op.type != 'fused_conv':
            continue
        _, ins, _, attrs = op.attrs['sub_ops'][0]
        cin = block.var(ins['Input'][0]).shape[1]
        w_shape = block.var(ins['Filter'][0]).shape
        flags.append((attrs.get('groups', 1) or 1) == cin and
                     w_shape[1] == 1)
    return flags


def _phase22_serving(seed, card, d):
    """22b, served: MobileNet-v1 saved, loaded and served in f32 at
    MOBILENET_SERVE_BATCHES and under AMP at MOBILENET_BATCH, against the
    plain fused conv; the depthwise regions' share under the profiler.
    Returns the launches of the served requests."""
    import torch
    import paddle_tpu_torch as pt
    from paddle_tpu_torch import io as pt_io
    from paddle_tpu_torch import profiler
    from paddle_tpu_torch.compiler import passes
    from paddle_tpu_torch.core import amp
    from paddle_tpu_torch.ops import cuda_kernels as ck
    t0 = time.perf_counter()
    main, startup, prob, _ = _mobilenet_program(seed)
    exe = pt.Executor()
    init_scope = pt.Scope()
    exe.run(startup, scope=init_scope)
    # random batch-norm affine, and moving statistics as training would
    # leave them (the batch moments of one batch), as phase 6 does
    gen = torch.Generator(device='cuda')
    gen.manual_seed(seed + 23)
    bns = [op for op in main.global_block().ops if op.type == 'batch_norm']
    for op in bns:
        c = init_scope.raw(op.input('Scale')[0]).shape[0]
        init_scope.set_var(op.input('Scale')[0], torch.rand(
            c, device='cuda', generator=gen) + 0.5)
        init_scope.set_var(op.input('Bias')[0], torch.randn(
            c, device='cuda', generator=gen) * 0.1)
    moments = exe.run(main, feed=_mobilenet_feed(MOBILENET_BATCH, seed + 24),
                      fetch_list=[op.output(s)[0] for op in bns
                                  for s in ('SavedMean', 'SavedVariance')],
                      scope=init_scope, return_numpy=False)
    for op, mean, var in zip(bns, moments[::2], moments[1::2]):
        init_scope.set_var(op.input('Mean')[0], mean.float())
        init_scope.set_var(op.input('Variance')[0], var.float())
    softmax, = [op for op in main.global_block().ops
                if op.type == 'softmax']
    logits_var = main.global_block().var(softmax.input('X')[0])
    path = os.path.join(d, 'mobilenet')
    pt_io.save_inference_model(path, ['data'], [logits_var, prob], exe,
                               main_program=main, scope=init_scope)
    del init_scope, moments
    scope = pt.Scope()
    prog, feed_names, fetch_vars = pt_io.load_inference_model(path, exe,
                                                              scope=scope)
    check(feed_names == ['data'], 'phase 22b: feeds %s' % feed_names)
    fetch = [v.name for v in fetch_vars]
    flags = _depthwise_flags(prog, fetch)
    check(len(flags) == MOBILENET_REGIONS and
          sum(flags) == MOBILENET_DW_REGIONS, 'phase 22b: the served program '
          'has %d fused_conv regions, %d depthwise' % (len(flags),
                                                       sum(flags)))
    torch.cuda.synchronize()
    print('phase 22b: MobileNet-v1 (3x%dx%d, width %.1f, %d classes): %d '
          'fused_conv regions (%d depthwise), built, calibrated, saved and '
          'loaded in %.1f s' % (
              MOBILENET['size'], MOBILENET['size'], MOBILENET['scale'],
              MOBILENET['classes'], len(flags), sum(flags),
              time.perf_counter() - t0), flush=True)

    def serve(feed, conv=None):
        with passes.conv_for_testing(conv) if conv else \
                contextlib.nullcontext():
            return exe.run(prog, feed=feed, fetch_list=fetch, scope=scope)

    launches = {name: 0 for name in ck.LAUNCHES}
    depthwise = 0
    for precision, batches in (('f32', MOBILENET_SERVE_BATCHES),
                               ('bf16', (MOBILENET_BATCH,))):
        amp.set_amp(precision == 'bf16')
        try:
            for bs in batches:
                feed = _mobilenet_feed(bs, seed + bs)
                serve(feed)                          # warm-up: the memo
                torch.cuda.synchronize()
                ck.reset_launch_counts()
                passes.reset_fallback_counts()
                t1 = time.perf_counter()
                logits, out = serve(feed)
                dt = time.perf_counter() - t1
                got = dict(ck.LAUNCHES)
                variants = dict(ck.FUSED_CONV_VARIANT_LAUNCHES)
                fallbacks = dict(passes.FALLBACKS)
                plain, _ = serve(feed, _stats_function())
                shifted, _ = serve(feed, _taps_shifted_conv)
                scale = float(np.abs(plain).max())
                diff = float(np.abs(logits - plain).max()) / scale
                c_diff = float(np.abs(shifted - plain).max()) / scale
                top1 = float((logits.argmax(-1) == plain.argmax(-1)).mean())
                c_top1 = float((shifted.argmax(-1) ==
                                plain.argmax(-1)).mean())
                tol = MOBILENET_LOGITS_TOL if precision == 'f32' else \
                    RESNET_LOGITS_TOL
                min_top1 = 1.0 if precision == 'f32' else RESNET_TOP1
                print('phase 22b: served %s batch %d: %.2f ms (host clock, '
                      'numpy images in, logits and probabilities out); '
                      'launches %s, by variant %s, fallbacks %s; logits vs '
                      'the plain fused conv: max |diff| / max |logits| %.4g '
                      '(tol %g), top-1 agreement %.4f (min %g); control, '
                      'taps shifted: %.4g, %.4f' % (
                          precision, bs, 1e3 * dt, got, variants, fallbacks,
                          diff, tol, top1, min_top1, c_diff, c_top1),
                      flush=True)
                check(out.shape == (bs, MOBILENET['classes']) and
                      np.isfinite(out).all() and
                      np.allclose(out.sum(1), 1.0, atol=1e-3),
                      'phase 22b: bad probabilities at %s batch %d'
                      % (precision, bs))
                check(got['fused_conv'] == MOBILENET_REGIONS and
                      variants['depthwise'] == MOBILENET_DW_REGIONS and
                      sum(got.values()) == MOBILENET_REGIONS,
                      'phase 22b: a %s request launched %s (%s)'
                      % (precision, got, variants))
                check(not fallbacks, 'phase 22b: fell back: %s' % fallbacks)
                check(diff <= tol and top1 >= min_top1, 'phase 22b: %s '
                      'logits differ from the plain path by %g (top-1 %g)'
                      % (precision, diff, top1))
                check(c_diff > tol or c_top1 < min_top1, 'phase 22b: the '
                      '%s logits limits do not catch the taps shifted'
                      % precision)
                for name, c in got.items():
                    launches[name] += c
                depthwise += variants['depthwise']
        finally:
            amp.set_amp(None)
    # the depthwise regions' share of a served request's op time: the
    # profiler's op table times each op with a device sync after it
    feed = _mobilenet_feed(MOBILENET_BATCH, seed + 300)
    exe.run(prog, feed=feed, fetch_list=fetch, scope=scope)
    profiler.reset_profiler()
    ck.reset_launch_counts()
    with profiler.profiler('All', 'total', os.path.join(d, 'mb_table.txt'),
                           trace_dir=os.path.join(d, 'mb_trace')):
        for _ in range(MOBILENET_PROFILE_RUNS):
            exe.run(prog, feed=feed, fetch_list=fetch, scope=scope)
    prof = profiler.save_profile(os.path.join(d, 'mb_profile.json'))
    with open(prof) as f:
        events = json.load(f)['events']
    convs = [dur for name, _, dur in events if name == 'fused_conv']
    check(len(convs) == MOBILENET_REGIONS * MOBILENET_PROFILE_RUNS and
          ck.LAUNCHES['fused_conv'] == len(convs), 'phase 22b: %d fused_conv '
          'events under the profiler, %s launches' % (len(convs),
                                                       ck.LAUNCHES))
    dw_s = sum(dur for i, dur in enumerate(convs)
               if flags[i % MOBILENET_REGIONS])
    all_s = sum(dur for _, _, dur in events)
    table = profiler.op_stats()
    print('phase 22b: served f32 batch %d under the profiler, %d runs: op '
          'time %.3f ms a request, fused_conv %.3f ms (%d calls), its %d '
          'depthwise regions %.3f ms: %.1f%% of the op time; top ops %s; '
          '%s' % (
              MOBILENET_BATCH, MOBILENET_PROFILE_RUNS,
              1e3 * all_s / MOBILENET_PROFILE_RUNS,
              table['fused_conv']['total_ms'] / MOBILENET_PROFILE_RUNS,
              table['fused_conv']['calls'], MOBILENET_DW_REGIONS,
              1e3 * dw_s / MOBILENET_PROFILE_RUNS, 100 * dw_s / all_s,
              ', '.join('%s %.3f' % (k, v['total_ms'] / MOBILENET_PROFILE_RUNS)
                        for k, v in sorted(table.items(),
                                           key=lambda kv: -kv[1]['total_ms'])
                        [:5]), card), flush=True)
    del scope, prog, exe
    torch.cuda.empty_cache()
    return launches, depthwise


def _phase22_training(seed, card):
    """22b, trained: MOBILENET_TRAIN_STEPS Momentum steps at
    MOBILENET_BATCH in f32 and under AMP on the kernel, the plain stats
    form, the f64 witness and the control, from one start; then one
    step's gradients by _hold_gradients. Returns the launches of the
    kernel's steps."""
    import torch
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.compiler import passes
    from paddle_tpu_torch.core import amp
    from paddle_tpu_torch.ops import cuda_kernels as ck
    main, startup, _, loss = _mobilenet_program(seed + 1, train=True)
    regions, grouped = train_regions(main, loss)
    n_dw = sum(c for key, c in regions.items() if key[-1])
    check(sum(regions.values()) == MOBILENET_REGIONS and not grouped and
          n_dw == MOBILENET_DW_REGIONS, 'phase 22b: the training program has '
          '%d stats-form regions (%d depthwise) and %d grouped'
          % (sum(regions.values()), n_dw, grouped))
    exe = pt.Executor()
    scope = pt.Scope()
    exe.run(startup, scope=scope)
    feed = _image_train_feed(MOBILENET_BATCH, seed + 25)
    snap = _snapshot(scope)
    paths = (('kernel', None), ('plain', _stats_function()),
             ('witness', _stats_function(_f64_witness)),
             ('taps shifted', _taps_shifted_conv))
    launches = {name: 0 for name in ck.LAUNCHES}
    depthwise = 0
    for precision in ('f32', 'bf16'):
        losses = {}
        amp.set_amp(precision == 'bf16')
        try:
            for name, conv in paths:
                _restore(scope, snap)
                ck.reset_launch_counts()
                passes.reset_fallback_counts()
                outs, step_ms = [], []
                with passes.conv_for_testing(conv) if conv else \
                        contextlib.nullcontext():
                    for _ in range(MOBILENET_TRAIN_STEPS):
                        torch.cuda.synchronize()
                        t0 = time.perf_counter()
                        outs.append(exe.run(main, feed=feed,
                                            fetch_list=[loss], scope=scope,
                                            return_numpy=False)[0])
                        torch.cuda.synchronize()
                        step_ms.append(1e3 * (time.perf_counter() - t0))
                losses[name] = [float(o) for o in outs]
                if name == 'kernel':
                    got, fallbacks = dict(ck.LAUNCHES), dict(passes.FALLBACKS)
                    variants = dict(ck.FUSED_CONV_VARIANT_LAUNCHES)
                    print('phase 22b: trained %s, batch %d, %d steps: ms a '
                          'step (host clock, loss kept on the card) %s, the '
                          'first lowers; launches %s, by variant %s, '
                          'fallbacks %s; %s' % (
                              precision, MOBILENET_BATCH,
                              MOBILENET_TRAIN_STEPS,
                              ' '.join('%.2f' % v for v in step_ms), got,
                              variants, fallbacks, card), flush=True)
                    expect = {n: 0 for n in got}
                    expect['fused_conv_stats'] = (MOBILENET_REGIONS *
                                                  MOBILENET_TRAIN_STEPS)
                    check(got == expect and variants['depthwise'] ==
                          MOBILENET_DW_REGIONS * MOBILENET_TRAIN_STEPS,
                          'phase 22b: %s training launched %s (%s)'
                          % (precision, got, variants))
                    check(not fallbacks, 'phase 22b: training fell back: %s'
                          % fallbacks)
                    for n, c in got.items():
                        launches[n] += c
                    depthwise += variants['depthwise']
        finally:
            amp.set_amp(None)
        plain = np.array(losses['plain'])

        def dist(name):
            return np.abs(np.array(losses[name]) - plain) / np.abs(plain)
        limit = max(MOBILENET_LOSS_WITNESS * dist('witness')[0],
                    MOBILENET_LOSS_FLOOR)
        print('phase 22b: trained %s, losses: %s; relative distance from '
              'the plain path: kernel %s, witness %s, taps shifted %s; the '
              'first step\'s limit %s' % (
                  precision, '; '.join('%s %s' % (n, ' '.join(
                      '%.6f' % l for l in losses[n])) for n, _ in paths),
                  ' '.join('%.3g' % v for v in dist('kernel')),
                  ' '.join('%.3g' % v for v in dist('witness')),
                  ' '.join('%.3g' % v for v in dist('taps shifted')),
                  '%.3g' % limit if precision == 'f32'
                  else 'none (AMP: printed only)'), flush=True)
        check(np.isfinite(losses['kernel']).all() and
              losses['kernel'][-1] < losses['kernel'][0], 'phase 22b: the '
              '%s losses %s are not finite and falling'
              % (precision, losses['kernel']))
        if precision == 'f32':
            check(dist('kernel')[0] <= limit, 'phase 22b: the first f32 '
                  'loss parts from the plain path by %g' % dist('kernel')[0])
            check(dist('taps shifted')[0] > limit, 'phase 22b: the first '
                  'f32 loss limit does not catch the taps shifted')
    _restore(scope, snap)
    _hold_gradients('mobilenet', main, scope,
                    _image_train_feed(MOBILENET_BATCH, seed + 26),
                    MOBILENET_REGIONS, None, RESNET_GRAD_WITNESS)
    del scope, exe, snap
    torch.cuda.empty_cache()
    return launches, depthwise


def phase_mobilenet(seed, card):
    """22. The depthwise kernel at MobileNet-v1's layers (22a) and
    MobileNet-v1 served and trained through it (22b). Returns (22a's sums,
    the launches of 22b's main paths: fused_conv and fused_conv_stats,
    and the depthwise variant's in each form)."""
    import torch
    t_phase = time.perf_counter()
    sums = _phase22_kernel(seed, card)
    os.makedirs(os.path.join(ROOT, 'build'), exist_ok=True)
    with tempfile.TemporaryDirectory(dir=os.path.join(ROOT, 'build')) as d:
        served, dw_served = _phase22_serving(seed, card, d)
    trained, dw_trained = _phase22_training(seed, card)
    launches = {n: served[n] + trained[n] for n in served}
    launches['depthwise'] = dw_served
    launches['depthwise_stats'] = dw_trained
    torch.cuda.empty_cache()
    print('phase 22: %.1f s; %.1f s since the process started; launches %s'
          % (time.perf_counter() - t_phase, time.perf_counter() - _STARTED,
             launches), flush=True)
    return sums, launches


# 24a: MobileNet-SSD (PaddlePaddle/models, fluid/object_detection/
# mobilenet_ssd.py): 3 x 300 x 300 images, 21 classes (PASCAL VOC's 20
# and the background), a MobileNet-v1 base at width SSD['scale'] to
# module11 (19 x 19, after the five 512 blocks) and module13 (10 x 10),
# the extra blocks of SSD_EXTRAS (a 1x1 conv, then a 3x3 stride-2 conv,
# each with batch norm and ReLU: 5 x 5, 3 x 3, 2 x 2, 1 x 1), and
# multi_box_head over those six maps with SSD_HEAD's priors: 1917 priors,
# loc [N, 1917, 4], conf [N, 1917, 21]
SSD = dict(size=300, classes=21, scale=1.0)
SSD_EXTRAS = ((256, 512), (128, 256), (128, 256), (64, 128))
SSD_HEAD = dict(min_sizes=[60.0, 105.0, 150.0, 195.0, 240.0, 285.0],
                max_sizes=[[], 150.0, 195.0, 240.0, 285.0, 300.0],
                aspect_ratios=[[2.], [2., 3.], [2., 3.], [2., 3.], [2., 3.],
                               [2., 3.]],
                offset=0.5, flip=True, kernel_size=3, pad=1)
SSD_PRIORS = 1917
SSD_NMS = dict(nms_threshold=0.45, nms_top_k=400, keep_top_k=200,
               score_threshold=0.01)


def mobilenet_ssd(layers, img, num_classes=21, scale=1.0, is_test=False):
    """MobileNet-SSD on ``img`` (NCHW, square), written with ``layers``
    (the port's, or paddle_tpu's: the CPU test builds both): the base's
    convs without bias, each with batch_norm and relu, the extra blocks
    of SSD_EXTRAS, and multi_box_head (each head a conv2d with its
    bias) with SSD_HEAD's priors, their sizes scaled from a 300-pixel
    image to ``img``'s. Returns (loc, conf, prior boxes, variances)."""
    def conv_bn(x, filters, size, stride, groups=1):
        conv = layers.conv2d(input=x, num_filters=filters, filter_size=size,
                             stride=stride, padding=(size - 1) // 2,
                             groups=groups, act=None, bias_attr=False)
        return layers.relu(layers.batch_norm(input=conv, is_test=is_test))

    size = int(img.shape[-1])
    x = conv_bn(img, int(32 * scale), 3, 2)
    feats = []
    for i, (cin, cout, stride) in enumerate(MOBILENET_BLOCKS):
        x = conv_bn(x, int(cin * scale), 3, stride, groups=int(cin * scale))
        x = conv_bn(x, int(cout * scale), 1, 1)
        if i in (10, 12):                 # module11, module13
            feats.append(x)
    for c1, c2 in SSD_EXTRAS:
        x = conv_bn(conv_bn(x, int(c1 * scale), 1, 1), int(c2 * scale), 3, 2)
        feats.append(x)
    k = size / 300.0
    head = dict(SSD_HEAD)
    head['min_sizes'] = [m * k for m in head['min_sizes']]
    head['max_sizes'] = [[m * k for m in v] if isinstance(v, list)
                         else v * k for v in head['max_sizes']]
    return layers.multi_box_head(inputs=feats, image=img,
                                 num_classes=num_classes, base_size=size,
                                 **head)


def ssd_program(pkg, seed, size=None, scale=None, classes=None, train=False,
                lr=0.001, lod_gt=True, frozen_bn=False):
    """MobileNet-SSD built with ``pkg``'s layers: (main, startup, feed
    names, fetches). Training: ``ssd_loss`` of the LoD ground truth
    (``gt_box`` [4] and ``gt_label`` [1] at lod_level 1) summed, as the
    models repo's script does, under Momentum(lr, 0.9); fetches [loss,
    loc, conf]. Serving: the softmax of the confidences, transposed to
    [N, classes, priors], through detection_output with SSD_NMS; fetches
    [nmsed, loc, scores]. ``lod_gt=False`` declares a dense ground truth
    [G, 4] shared by the batch (the only batched form paddle_tpu's loss
    takes at any prior count: the CPU test's parity case); ``frozen_bn``
    trains with the batch norms on their moving statistics."""
    size = size or SSD['size']
    classes = classes or SSD['classes']
    main, startup = pkg.Program(), pkg.Program()
    startup.random_seed = seed
    L = pkg.layers
    with pkg.unique_name.guard(), pkg.program_guard(main, startup):
        img = L.data(name='image', shape=[3, size, size], dtype='float32')
        loc, conf, box, var = mobilenet_ssd(
            L, img, classes, SSD['scale'] if scale is None else scale,
            is_test=frozen_bn or not train)
        if train:
            lod = 1 if lod_gt else 0
            gt_box = L.data(name='gt_box', shape=[4], dtype='float32',
                            lod_level=lod)
            gt_label = L.data(name='gt_label', shape=[1], dtype='int32',
                              lod_level=lod)
            loss = L.reduce_sum(L.ssd_loss(loc, conf, gt_box, gt_label, box,
                                           var))
            pkg.optimizer.Momentum(learning_rate=lr,
                                   momentum=0.9).minimize(loss)
            return main, startup, ['image', 'gt_box', 'gt_label'], \
                [loss, loc, conf]
        scores = L.transpose(L.softmax(conf), perm=[0, 2, 1])
        nmsed = L.detection_output(loc, scores, box, var, **SSD_NMS)
    return main, startup, ['image'], [nmsed, loc, scores]


def ssd_ground_truth(rng, n, classes, max_boxes=4):
    """Per-image boxes and labels: 1 to ``max_boxes`` boxes an image
    inside the unit square (at least 0.1 wide), labels 1 .. classes-1.
    Returns (boxes, labels, lengths): packed rows and the LoD lengths."""
    lens = rng.randint(1, max_boxes + 1, n)
    total = int(lens.sum())
    xy = rng.uniform(0.0, 0.7, (total, 2))
    wh = rng.uniform(0.1, 0.3, (total, 2))
    boxes = np.concatenate([xy, np.minimum(xy + wh, 1.0)], 1)
    labels = rng.randint(1, classes, (total, 1))
    return boxes.astype('float32'), labels.astype('int32'), \
        [int(v) for v in lens]


# 24b: CRNN-CTC (PaddlePaddle/models, fluid/ocr_recognition/
# crnn_ctc_model.py): 1 x 48 x 512 strips, four conv groups (two 3x3
# convs with bias, batch norm and ReLU, then a 2x2 max pool) of
# CRNN['filters'], im2sequence with a (3, 1) filter (32 steps of 384),
# two fcs of 3 x CRNN['hidden'] into a forward and a reverse dynamic_gru
# (candidate ReLU), an fc to CRNN['classes'] + 1 and warpctc (blank
# CRNN['classes'], norm_by_times) summed, under Momentum(0.001, 0.9)
CRNN = dict(height=48, width=512, classes=95, filters=(16, 32, 64, 128),
            hidden=200)
CRNN_LABELS = (4, 20)           # the transcripts' lengths


def crnn_ctc(layers, images, classes=95, filters=(16, 32, 64, 128),
             hidden=200):
    """CRNN's encoder on ``images`` (NCHW) written with ``layers``:
    returns the LoD logits [T, classes + 1] a strip."""
    x = images
    for f in filters:
        for _ in range(2):
            x = layers.conv2d(input=x, num_filters=f, filter_size=3,
                              padding=1, act=None)
            x = layers.relu(layers.batch_norm(input=x))
        x = layers.pool2d(input=x, pool_size=2, pool_type='max',
                          pool_stride=2)
    seq = layers.im2sequence(input=x, filter_size=[int(x.shape[2]), 1],
                             stride=[1, 1])
    if not seq.shape:
        # paddle_tpu's layer leaves the rows' width undeclared
        seq.shape = (-1, int(x.shape[1]) * int(x.shape[2]))
    fc_1 = layers.fc(input=seq, size=hidden * 3, bias_attr=False)
    fc_2 = layers.fc(input=seq, size=hidden * 3, bias_attr=False)
    fwd = layers.dynamic_gru(input=fc_1, size=hidden,
                             candidate_activation='relu')
    bwd = layers.dynamic_gru(input=fc_2, size=hidden, is_reverse=True,
                             candidate_activation='relu')
    return layers.fc(input=[fwd, bwd], size=classes + 1)


def crnn_program(pkg, seed, height=None, width=None, classes=None,
                 filters=None, hidden=None, lr=0.001):
    """CRNN-CTC built with ``pkg``'s layers: (main, startup, test program,
    fetches): the summed loss, the logits, the greedy decode and the
    edit distance (``evaluator.EditDistance``) of the decode against the
    labels; the test program (cloned before the optimizer) has the same
    fetches. The label is ``label`` [1] int32 at lod_level 1."""
    c = dict(CRNN)
    c.update({k: v for k, v in dict(height=height, width=width,
                                    classes=classes, filters=filters,
                                    hidden=hidden).items() if v is not None})
    main, startup = pkg.Program(), pkg.Program()
    startup.random_seed = seed
    L = pkg.layers
    with pkg.unique_name.guard(), pkg.program_guard(main, startup):
        images = L.data(name='pixel', shape=[1, c['height'], c['width']],
                        dtype='float32')
        label = L.data(name='label', shape=[1], dtype='int32', lod_level=1)
        logits = crnn_ctc(L, images, c['classes'], c['filters'], c['hidden'])
        cost = L.warpctc(input=logits, label=label, blank=c['classes'],
                         norm_by_times=True)
        loss = L.reduce_sum(cost)
        decoded = L.ctc_greedy_decoder(input=logits, blank=c['classes'])
        evaluator = pkg.evaluator.EditDistance(
            input=decoded, label=L.cast(x=label, dtype='int64'))
        test = main.clone(for_test=True)
        pkg.optimizer.Momentum(learning_rate=lr, momentum=0.9).minimize(loss)
    return main, startup, test, [loss, logits, decoded,
                                 evaluator.metrics[0]], evaluator


def crnn_batch(rng, n, height, width, classes, lens=(4, 20)):
    """Strips and transcripts: random pixels, 4-20 labels a strip in
    [0, classes). Returns (images, packed labels, lengths)."""
    ls = rng.randint(lens[0], lens[1] + 1, n)
    images = rng.uniform(-1, 1, (n, 1, height, width)).astype('float32')
    labels = rng.randint(0, classes, (int(ls.sum()), 1)).astype('int32')
    return images, labels, [int(v) for v in ls]


# ---- 24. The detection and CTC families, the observatory, the cold-start
# store and the C API -------------------------------------------------------------
# 24a: MobileNet-SSD (SSD above) trained SSD_TRAIN_STEPS Momentum(0.001,
# 0.9) steps at SSD_BATCH on LoD ground truth (ssd_ground_truth) in f32
# on the kernel, the plain stats form, the f64 witness and the
# taps-shifted control from one start (the first loss held as phase 22b
# holds it: within MOBILENET_LOSS_WITNESS times the witness's distance
# from the plain path, at least MOBILENET_LOSS_FLOOR; the control must
# miss); 3 f32 steps at SSD_SMALL_LR from the same weights, whose summed
# loss must fall at each step (at 0.001 it rises: the step is too large
# for a sum over the batch's priors); then under AMP (the losses printed,
# not held, as in 22b; one more AMP step recorded and each of its 47
# regions held by _hold_regions at its own bf16 operands); one step at
# SSD_CPU_BATCH against the CPU (the loss to SSD_CPU_TOL). Saved, loaded
# and served in f32 through detection_output at SSD_SERVE_BATCHES: loc and
# scores against the plain fused conv (MOBILENET_LOGITS_TOL, the control
# must miss) and at batch 1 against the CPU (SSD_CPU_TOL); the NMS on the
# card against the CPU on the same loc and scores (each kept mask exact,
# labels exact, scores and boxes to SSD_NMS_TOL); evaluator.DetectionMAP
# streamed over the served batches, each batch's op and the stream's host
# state against detection_map_numpy. Exact launches a step and a request:
# the regions the passes form (47: 27 base, 8 extra, 12 heads; 13
# depthwise). The served batch-8 request's 8 extra and 12 head regions
# held and timed by _hold_regions (PERF.md 6l).
SSD_BATCH = 32
SSD_SERVE_BATCHES = (1, 8)
SSD_TRAIN_STEPS = 3
SSD_SMALL_LR = 1e-5             # the rate at which the summed loss falls
SSD_CPU_BATCH = 2
SSD_CPU_TOL = 1e-4              # f32 card vs CPU, of the largest |value|
SSD_NMS_TOL = 1e-5              # NMS scores and boxes, card vs CPU
SSD_REGIONS, SSD_STATS_REGIONS, SSD_DW_REGIONS = 47, 35, 13
# 24b: CRNN-CTC (CRNN above) trained CRNN_STEPS steps at CRNN_BATCH in
# f32 with transcripts of 4-20 labels, then one more step recorded and
# each of its 8 regions held by _hold_regions (f32, against f64 too);
# one step at CRNN_CPU_BATCH against the CPU (the loss to CRNN_LOSS_TOL;
# the gradients by relative L2, the
# median to CRNN_GRAD_MEDIAN and the largest to CRNN_GRAD_MAX: where
# rounding flips one of a 2x2 max pool's near-ties (or a ReLU at 0), the
# gradient goes to another element, and every gradient upstream of it
# moves by ~1/sqrt(N*H*W) of the layer, as phase 12d's VGG-16 showed; on
# the H100 at seed 0 one window of the second group's pool (of 196,608;
# a tie 1.5e-7 apart) flips, and the first two groups' gradients part by
# 2.5e-3 to 3.57e-3, the rest by ~1e-6 (PERF.md): CRNN_GRAD_MAX is twice
# the largest, and a control, the card's step with every conv's taps
# shifted, must exceed the three limits (its gradients part by 0.465 to
# 1.64 on the H100); the convs' biases, which a train-mode batch norm
# follows, have gradient 0 in exact arithmetic: within CRNN_BIAS_ABS of
# it on both sides); warpctc's loss and logits gradient against
# torch.nn.functional.ctc_loss in f64 on the same logits (CTC_WITNESS_TOL,
# CTC_GRAD_TOL of the largest |gradient|); the greedy decode and its edit
# distances on the card and the CPU from the same logits, exactly
CRNN_BATCH = 32
CRNN_STEPS = 3
CRNN_CPU_BATCH = 4
CRNN_LOSS_TOL = 1e-4
CRNN_GRAD_MEDIAN = 1e-4
CRNN_GRAD_MAX = 7e-3
CRNN_BIAS_ABS = 1e-5
CRNN_REGIONS = 8
CTC_WITNESS_TOL = 1e-5
CTC_GRAD_TOL = 1e-4
# 24c: the Trainer over SSD_TRAINER_STEPS SSD steps under
# perf.capture_scope: the ledger's fused conv operations against
# _conv_hand_count, the MFU and roofline gauges, /ledgers, the flight
# bundle's ledgers slot and the tuner's _ledger_bound. 24d: a child
# process (``--coldstart-child``) warms the saved SSD server (buckets up
# to COLDSTART_MAX_BATCH) from an empty store, a second from the filled
# one: outputs bit-identical. 24e: a C program (CAPI_CLIENT) serves the
# saved SSD model through the C API on the card: its output equals the
# Executor's bit for bit
SSD_TRAINER_STEPS = 2
COLDSTART_MAX_BATCH = 8
CAPI_CLIENT = r'''
#include <stdio.h>
#include <stdint.h>

extern void* ptpu_predictor_create(const char*);
extern int64_t ptpu_predictor_run_f32(void*, const char*, const float*,
                                      const int64_t*, int, int, float*,
                                      int64_t, int64_t*, int, int*);
extern void ptpu_predictor_destroy(void*);
extern const char* ptpu_last_error(void);

static float in[3 * 300 * 300];
static float out[200 * 6];

int main(int argc, char** argv) {
  void* p = ptpu_predictor_create(argv[1]);
  if (!p) { fprintf(stderr, "create: %s\n", ptpu_last_error()); return 1; }
  for (long long i = 0; i < 3 * 300 * 300; ++i)
    in[i] = (float)((i * 7919) % 1000) / 500.0f - 1.0f;
  int64_t shape[4] = {1, 3, 300, 300};
  int64_t out_shape[8];
  int out_ndim = 0;
  int64_t n = ptpu_predictor_run_f32(p, NULL, in, shape, 4, 0, out, 1200,
                                     out_shape, 8, &out_ndim);
  if (n < 0) { fprintf(stderr, "run: %s\n", ptpu_last_error()); return 2; }
  printf("COUNT=%lld NDIM=%d\n", (long long)n, out_ndim);
  for (int64_t i = 0; i < n; ++i) printf("%.9g ", out[i]);
  printf("\n");
  ptpu_predictor_destroy(p);
  return 0;
}
'''


def _capi_input():
    """CAPI_CLIENT's input, made the same way in numpy."""
    i = np.arange(3 * 300 * 300, dtype=np.int64)
    return (((i * 7919) % 1000).astype(np.float32) / np.float32(500.0) -
            np.float32(1.0)).reshape(1, 3, 300, 300)


def _ssd_feed(rng, n):
    import paddle_tpu_torch as pt
    boxes, labels, lens = ssd_ground_truth(rng, n, SSD['classes'])
    return {'image': rng.randn(n, 3, SSD['size'], SSD['size'])
            .astype('float32'),
            'gt_box': pt.create_lod_tensor(boxes, [lens]),
            'gt_label': pt.create_lod_tensor(labels, [lens])}


def _region_forms(prog, fetch_names):
    """Each fused_conv region of ``prog`` after the passes, in run order:
    (depthwise, fused with a batch norm)."""
    import paddle_tpu_torch as pt
    opt, _ = pt.compiler.optimize(prog, fetch_names=fetch_names)
    block = opt.global_block()
    out = []
    for op in block.ops:
        if op.type != 'fused_conv':
            continue
        _, ins, _, attrs = op.attrs['sub_ops'][0]
        cin = block.var(ins['Input'][0]).shape[1]
        dw = (attrs.get('groups', 1) or 1) == cin and \
            block.var(ins['Filter'][0]).shape[1] == 1
        out.append((bool(dw), 'batch_norm' in op.attrs['fused_types']))
    return out


def _conv_hand_count(prog, fetch_names, batch, train):
    """The operations of the program's fused_conv regions from the
    layers' static shapes: 2 a multiply-add of each region's conv (N * Ho
    * Wo * Cout * Cin/groups * KH * KW) and 1 an output element a fused
    stage; a training step three times (the forward and the backward's
    two products)."""
    import paddle_tpu_torch as pt
    opt, _ = pt.compiler.optimize(prog, fetch_names=fetch_names)
    block = opt.global_block()
    total = 0
    for op in block.ops:
        if op.type != 'fused_conv':
            continue
        _, ins, outs, _ = op.attrs['sub_ops'][0]
        _, cin_g, kh, kw = block.var(ins['Filter'][0]).shape
        _, c, ho, wo = block.var(outs['Output'][0]).shape
        out = batch * c * ho * wo
        total += 2 * out * cin_g * kh * kw + \
            (len(op.attrs['sub_ops']) - 1) * out
    return total * (3 if train else 1)


def _counted(fn):
    """``fn()`` with the launch counts set to 0 just before: (its
    result, the launches, the fused conv's by variant, the fallbacks)."""
    import torch
    from paddle_tpu_torch.compiler import passes
    from paddle_tpu_torch.ops import cuda_kernels as ck
    torch.cuda.synchronize()
    ck.reset_launch_counts()
    passes.reset_fallback_counts()
    out = fn()
    torch.cuda.synchronize()
    return (out, dict(ck.LAUNCHES), dict(ck.FUSED_CONV_VARIANT_LAUNCHES),
            dict(passes.FALLBACKS))


def _rel_max(a, b):
    a, b = np.asarray(a, 'float64'), np.asarray(b, 'float64')
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def _phase24_ssd_training(seed, card):
    """24a, trained. Returns (the scope after the f32 kernel steps, the
    launches of the kernel's steps: fused_conv, fused_conv_stats and the
    depthwise variant)."""
    import torch
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.compiler import passes
    from paddle_tpu_torch.core import amp
    main, startup, _, fetch = ssd_program(pt, seed, train=True)
    loss = fetch[0]
    forms = _region_forms(main, [loss.name])
    n_stats = sum(bn for _, bn in forms)
    n_dw = sum(dw for dw, _ in forms)
    print('phase 24a: MobileNet-SSD (3x%dx%d, width %.1f, %d classes, %d '
          'priors): the training program has %d fused_conv regions, %d in '
          'the stats form (the base and extra convs with their train-mode '
          'batch norms, %d of them depthwise) and %d in the inference form '
          '(the head convs, each fused with its bias add: no batch norm '
          'follows them)' % (SSD['size'], SSD['size'], SSD['scale'],
                             SSD['classes'], SSD_PRIORS, len(forms), n_stats,
                             n_dw, len(forms) - n_stats), flush=True)
    check((len(forms), n_stats, n_dw) == (SSD_REGIONS, SSD_STATS_REGIONS,
                                          SSD_DW_REGIONS),
          'phase 24a: the training program has %d regions, %d stats form, '
          '%d depthwise' % (len(forms), n_stats, n_dw))
    exe = pt.Executor()
    scope = pt.Scope()
    exe.run(startup, scope=scope)
    feed = _ssd_feed(np.random.RandomState(seed + 240), SSD_BATCH)
    snap = _snapshot(scope)
    paths = (('kernel', None), ('plain', _stats_function()),
             ('witness', _stats_function(_f64_witness)),
             ('taps shifted', _taps_shifted_conv))
    launches = {'fused_conv': 0, 'fused_conv_stats': 0, 'depthwise': 0}
    trained = None
    for precision in ('f32', 'bf16'):
        amp.set_amp(precision == 'bf16')
        losses = {}
        try:
            for name, conv in (paths if precision == 'f32' else paths[:1]):
                _restore(scope, snap)
                step_ms = []

                def steps(conv=conv, step_ms=step_ms):
                    outs = []
                    with passes.conv_for_testing(conv) if conv else \
                            contextlib.nullcontext():
                        for _ in range(SSD_TRAIN_STEPS):
                            torch.cuda.synchronize()
                            t0 = time.perf_counter()
                            outs.append(exe.run(main, feed=feed,
                                                fetch_list=[loss],
                                                scope=scope,
                                                return_numpy=False)[0])
                            torch.cuda.synchronize()
                            step_ms.append(1e3 * (time.perf_counter() - t0))
                    return [float(o) for o in outs]
                losses[name], got, variants, fallbacks = _counted(steps)
                if name != 'kernel':
                    continue
                print('phase 24a: trained %s, batch %d, %d steps: ms a step '
                      '(host clock, the loss kept on the card; the first '
                      'lowers) %s; losses %s; launches %s, by variant %s, '
                      'fallbacks %s; %s' % (
                          precision, SSD_BATCH, SSD_TRAIN_STEPS,
                          ' '.join('%.2f' % v for v in step_ms),
                          ' '.join('%.6f' % l for l in losses[name]), got,
                          {k: v for k, v in variants.items() if v},
                          fallbacks, card), flush=True)
                expect = {k: 0 for k in got}
                expect['fused_conv_stats'] = n_stats * SSD_TRAIN_STEPS
                expect['fused_conv'] = (len(forms) - n_stats) * \
                    SSD_TRAIN_STEPS
                check(got == expect and variants['depthwise'] ==
                      n_dw * SSD_TRAIN_STEPS, 'phase 24a: %s training '
                      'launched %s (%s), expected %s' % (
                          precision, got, variants, expect))
                check(not fallbacks, 'phase 24a: training fell back: %s'
                      % fallbacks)
                # printed, not held to fall: on one fixed batch at random
                # weights the summed loss's hard negatives change from step
                # to step (the plain path's losses are printed beside)
                check(np.isfinite(losses[name]).all(), 'phase 24a: the %s '
                      'losses %s are not finite' % (precision, losses[name]))
                for k in ('fused_conv', 'fused_conv_stats'):
                    launches[k] += got[k]
                launches['depthwise'] += variants['depthwise']
                if precision == 'f32':
                    trained = _snapshot(scope)
                else:
                    # one more AMP step recorded region by region: each
                    # region held against its plain version at the
                    # step's own operands (bf16; the 27 mma_sync and 75
                    # wgmma launches a 3-step run counts)
                    recorder = _RegionRecorder()
                    with passes.conv_for_testing(recorder):
                        exe.run(main, feed=feed, fetch_list=[loss],
                                scope=scope)
                    check(len(recorder.calls) == SSD_REGIONS, 'phase 24a: '
                          'an AMP step recorded %d regions'
                          % len(recorder.calls))
                    _hold_regions('ssd AMP training', 'ssd training',
                                  recorder.calls, {}, dedupe=True,
                                  timed=False)
                    del recorder
        finally:
            amp.set_amp(None)
        if precision != 'f32':
            continue
        plain = np.array(losses['plain'])

        def dist(name):
            return np.abs(np.array(losses[name]) - plain) / np.abs(plain)
        limit = max(MOBILENET_LOSS_WITNESS * dist('witness')[0],
                    MOBILENET_LOSS_FLOOR)
        print('phase 24a: trained f32, losses: %s; relative distance from '
              'the plain path: kernel %s, witness %s, taps shifted %s; the '
              'first step\'s limit %.3g' % (
                  '; '.join('%s %s' % (n, ' '.join('%.6f' % l for l in
                                                    losses[n]))
                            for n, _ in paths),
                  ' '.join('%.3g' % v for v in dist('kernel')),
                  ' '.join('%.3g' % v for v in dist('witness')),
                  ' '.join('%.3g' % v for v in dist('taps shifted')), limit),
              flush=True)
        check(dist('kernel')[0] <= limit, 'phase 24a: the first f32 loss '
              'parts from the plain path by %g' % dist('kernel')[0])
        check(dist('taps shifted')[0] > limit, 'phase 24a: the first f32 '
              'loss limit does not catch the taps shifted')
        # the summed loss at SSD_SMALL_LR from the same weights, on the
        # kernel: where the loss rises at 0.001, a step too large for a
        # sum over the batch's priors would fall at the smaller rate
        small, small_start, _, small_fetch = ssd_program(
            pt, seed, train=True, lr=SSD_SMALL_LR)
        s2 = pt.Scope()
        exe.run(small_start, scope=s2)
        for p in main.global_block().all_parameters():
            s2.set_var(p.name, snap[p.name].clone())
        amp.set_amp(False)
        try:
            small_losses = [float(exe.run(small, feed=feed,
                                          fetch_list=[small_fetch[0]],
                                          scope=s2)[0])
                            for _ in range(SSD_TRAIN_STEPS)]
        finally:
            amp.set_amp(None)
        print('phase 24a: trained f32 on the kernel at learning rate %g '
              'from the same weights: losses %s (at %g: %s)' % (
                  SSD_SMALL_LR, ' '.join('%.6f' % l for l in small_losses),
                  0.001, ' '.join('%.6f' % l for l in losses['kernel'])),
              flush=True)
        check(all(b < a for a, b in zip(small_losses, small_losses[1:])),
              'phase 24a: the loss at learning rate %g does not fall: %s'
              % (SSD_SMALL_LR, small_losses))
        del s2
    # one step at SSD_CPU_BATCH, card against CPU, from the start
    feed2 = _ssd_feed(np.random.RandomState(seed + 241), SSD_CPU_BATCH)
    state = {n: v.cpu().numpy() for n, v in snap.items()}
    got = []
    amp.set_amp(False)
    try:
        for place in (pt.CUDAPlace(0), pt.CPUPlace()):
            s = pt.Scope()
            for n, v in state.items():
                s.set_var(n, v)
            got.append(float(pt.Executor(place).run(
                main, feed=feed2, fetch_list=[loss], scope=s)[0]))
    finally:
        amp.set_amp(None)
    diff = abs(got[0] - got[1]) / abs(got[1])
    print('phase 24a: one f32 step at batch %d: loss card %.7f, CPU %.7f, '
          'relative %.3g (tol %g)' % (SSD_CPU_BATCH, got[0], got[1], diff,
                                       SSD_CPU_TOL), flush=True)
    check(diff <= SSD_CPU_TOL, 'phase 24a: the card\'s loss parts from the '
          'CPU\'s by %g' % diff)
    _restore(scope, trained)
    del snap, trained
    return scope, launches


def _detections(nmsed):
    """The valid rows (label >= 0) of each image of a [N, K, 6] output."""
    return [d[d[:, 0] >= 0] for d in np.asarray(nmsed)]


def _map_ground_truth(rng, dets):
    """Each image's ground truth [G, 5] (label, box): up to three of its
    detections, moved by up to 0.02, and one random box; so the mAP of
    random weights is not 0."""
    gts = []
    for d in dets:
        rows = [np.concatenate([[r[0]], np.clip(
            r[2:6] + rng.uniform(-0.02, 0.02, 4), 0, 1)]) for r in d[:3]]
        b, _, _ = ssd_ground_truth(rng, 1, SSD['classes'], max_boxes=1)
        rows.append(np.concatenate([[rng.randint(1, SSD['classes'])], b[0]]))
        gts.append(np.asarray(rows, 'float32'))
    return gts


def _phase24_ssd_serving(seed, card, d, scope):
    """24a, served, from the trained ``scope``. Returns (the saved
    model's directory, the served requests' launches, 6l's totals)."""
    import torch
    import paddle_tpu_torch as pt
    from paddle_tpu_torch import io as pt_io
    from paddle_tpu_torch.compiler import passes
    from paddle_tpu_torch.core import amp
    from paddle_tpu_torch.ops import detection_ops
    from paddle_tpu_torch.ops.detection_map_ref import detection_map_numpy
    smain, _, _, sfetch = ssd_program(pt, seed)
    exe = pt.Executor()
    path = os.path.join(d, 'ssd')
    pt_io.save_inference_model(path, ['image'], sfetch, exe,
                               main_program=smain, scope=scope)
    sscope = pt.Scope()
    prog, feeds, fetch_vars = pt_io.load_inference_model(path, exe,
                                                         scope=sscope)
    fetch = [v.name for v in fetch_vars]
    forms = _region_forms(prog, fetch)
    n_dw = sum(dw for dw, _ in forms)
    check(feeds == ['image'] and len(forms) == SSD_REGIONS and
          n_dw == SSD_DW_REGIONS, 'phase 24a: the served program has feeds '
          '%s, %d regions, %d depthwise' % (feeds, len(forms), n_dw))

    def serve(feed, conv=None, place_scope=None):
        with passes.conv_for_testing(conv) if conv else \
                contextlib.nullcontext():
            return exe.run(prog, feed=feed, fetch_list=fetch,
                           scope=place_scope or sscope)

    launches = {'fused_conv': 0, 'depthwise': 0}
    totals = {}
    rng = np.random.RandomState(seed + 242)
    served = []
    amp.set_amp(False)
    try:
        for bs in SSD_SERVE_BATCHES:
            feed = {'image': rng.randn(bs, 3, SSD['size'], SSD['size'])
                    .astype('float32')}
            serve(feed)                       # warm-up: the memo
            t0 = time.perf_counter()
            (nmsed, loc, scores), got, variants, fb = _counted(
                lambda: serve(feed))
            dt = time.perf_counter() - t0
            plain = serve(feed, _stats_function())
            shifted = serve(feed, _taps_shifted_conv)
            errs = [_rel_max(a, b) for a, b in ((loc, plain[1]),
                                                (scores, plain[2]))]
            ctrl = [_rel_max(a, b) for a, b in ((shifted[1], plain[1]),
                                                (shifted[2], plain[2]))]
            print('phase 24a: served f32 batch %d: %.2f ms (host clock, '
                  'numpy in, detections out, the decode and NMS included); '
                  '%d detections kept; launches %s, by variant %s, '
                  'fallbacks %s; loc and scores vs the plain fused conv: '
                  '%.3g %.3g (tol %g); control, taps shifted: %.3g %.3g; %s'
                  % (bs, 1e3 * dt, int((nmsed[..., 0] >= 0).sum()), got,
                     {k: v for k, v in variants.items() if v}, fb,
                     errs[0], errs[1], MOBILENET_LOGITS_TOL, ctrl[0],
                     ctrl[1], card), flush=True)
            check(got['fused_conv'] == SSD_REGIONS and
                  sum(got.values()) == SSD_REGIONS and
                  variants['depthwise'] == SSD_DW_REGIONS, 'phase 24a: a '
                  'request launched %s (%s)' % (got, variants))
            check(not fb, 'phase 24a: serving fell back: %s' % fb)
            check(max(errs) <= MOBILENET_LOGITS_TOL, 'phase 24a: loc or '
                  'scores part from the plain path by %s' % errs)
            check(max(ctrl) > MOBILENET_LOGITS_TOL, 'phase 24a: the limits '
                  'do not catch the taps shifted')
            check(nmsed.shape == (bs, SSD_NMS['keep_top_k'], 6) and
                  np.isfinite(nmsed).all(), 'phase 24a: detections %s'
                  % (nmsed.shape,))
            launches['fused_conv'] += got['fused_conv']
            launches['depthwise'] += variants['depthwise']
            served.append((feed, nmsed, loc, scores))
        # the 8 extra and 12 head regions of a batch-8 request, held and
        # timed (PERF.md 6l)
        recorder = _RegionRecorder()
        with passes.conv_for_testing(recorder):
            serve(served[-1][0])
        check(len(recorder.calls) == SSD_REGIONS, 'phase 24a: recorded %d '
              'regions' % len(recorder.calls))
        _hold_regions('ssd', 'ssd heads b8', recorder.calls[27:], totals,
                      sum_dtypes=('float32',), dedupe=True)
        del recorder
        # the card against the CPU: the whole request at batch 1
        cscope = pt.Scope()
        cexe = pt.Executor(pt.CPUPlace())
        cprog, _, _ = pt_io.load_inference_model(path, cexe, scope=cscope)
        cpu = cexe.run(cprog, feed=served[0][0], fetch_list=fetch,
                       scope=cscope)
        errs = [_rel_max(a, b) for a, b in zip(served[0][2:], cpu[1:])]
        print('phase 24a: served batch 1, card vs CPU: loc %.3g, scores '
              '%.3g (tol %g)' % (errs[0], errs[1], SSD_CPU_TOL), flush=True)
        check(max(errs) <= SSD_CPU_TOL, 'phase 24a: the card\'s loc or '
              'scores part from the CPU\'s by %s' % errs)
        # the NMS on the card against the CPU on the same decoded boxes
        # and scores: each kept mask exact, then the whole op
        _, _, loc8, scores8 = served[-1]
        dmain = pt.Program()
        with pt.unique_name.guard(), pt.program_guard(dmain, pt.Program()):
            lv = pt.layers.data(name='loc', shape=list(loc8.shape[1:]),
                                dtype='float32')
            sv = pt.layers.data(name='scores', shape=list(scores8.shape[1:]),
                                dtype='float32')
            pb = pt.layers.data(name='pb', shape=[SSD_PRIORS, 4],
                                dtype='float32', append_batch_size=False)
            pv = pt.layers.data(name='pv', shape=[SSD_PRIORS, 4],
                                dtype='float32', append_batch_size=False)
            dec = pt.layers.box_coder(pb, pv, lv,
                                      code_type='decode_center_size')
            nms = pt.layers.detection_output(lv, sv, pb, pv, **SSD_NMS)
        # multi_box_head's concats: loc, conf, then the priors and their
        # variances
        box_name = [op.output('Out')[0] for op in prog.global_block().ops
                    if op.type == 'concat'][2:4]
        priors = exe.run(prog, feed=served[-1][0], fetch_list=box_name,
                         scope=sscope)
        dfeed = {'loc': loc8, 'scores': scores8, 'pb': priors[0],
                 'pv': priors[1]}
        outs = [pt.Executor(place).run(dmain, feed=dfeed,
                                       fetch_list=[dec, nms],
                                       scope=pt.Scope())
                for place in (pt.CUDAPlace(0), pt.CPUPlace())]
        masks = [detection_ops.nms_keep(
            torch.as_tensor(scores8, device=dev),
            torch.as_tensor(o[0], device=dev), 0,
            SSD_NMS['nms_threshold'], SSD_NMS['nms_top_k'],
            SSD_NMS['score_threshold']).cpu().numpy()
            for o, dev in zip(outs, ('cuda', 'cpu'))]
        (g, c) = (outs[0][1], outs[1][1])
        nerr = float(np.abs(g[..., 1:] - c[..., 1:]).max())
        print('phase 24a: NMS at batch 8 (%d classes x %d priors, top %d, '
              'keep %d): card vs CPU on the same inputs: kept masks equal '
              '%s (%d kept), labels equal %s, scores and boxes max |diff| '
              '%.3g (tol %g)' % (
                  SSD['classes'], SSD_PRIORS, SSD_NMS['nms_top_k'],
                  SSD_NMS['keep_top_k'], np.array_equal(*masks),
                  int(masks[0].sum()), np.array_equal(g[..., 0], c[..., 0]),
                  nerr, SSD_NMS_TOL), flush=True)
        check(np.array_equal(*masks) and np.array_equal(g[..., 0],
                                                        c[..., 0]) and
              nerr <= SSD_NMS_TOL, 'phase 24a: the NMS on the card parts '
              'from the CPU\'s')
        # DetectionMAP streamed over the served batches
        emain, estart = pt.Program(), pt.Program()
        with pt.unique_name.guard(), pt.program_guard(emain, estart):
            dv = pt.layers.data(name='det', shape=[SSD_NMS['keep_top_k'], 6],
                                dtype='float32')
            lbl = pt.layers.data(name='gt_label', shape=[1],
                                 dtype='float32', lod_level=1)
            box = pt.layers.data(name='gt_box', shape=[4], dtype='float32',
                                 lod_level=1)
            ev = pt.evaluator.DetectionMAP(dv, lbl, box, class_num=SSD[
                'classes'], overlap_threshold=0.5)
            cur, _ = ev.get_map_var()
        escope = pt.Scope()
        mrng = np.random.RandomState(seed + 243)
        all_d, all_g, maps = [], [], []
        with pt.scope_guard(escope):
            exe.run(estart)
            ev.reset(exe)
            for _, nmsed, _, _ in served:
                dets = _detections(nmsed)
                gts = _map_ground_truth(mrng, dets)
                lens = [[len(g) for g in gts]]
                m = float(exe.run(emain, feed={
                    'det': nmsed,
                    'gt_label': pt.create_lod_tensor(
                        np.concatenate(gts)[:, :1], lens),
                    'gt_box': pt.create_lod_tensor(
                        np.concatenate(gts)[:, 1:], lens)},
                    fetch_list=[cur])[0][0])
                maps.append((m, detection_map_numpy(dets, gts)))
                ev.update_state(dets, gts)
                all_d += dets
                all_g += gts
            stream = float(ev.eval(exe)[0])
        want = detection_map_numpy(all_d, all_g)
        print('phase 24a: DetectionMAP over the served batches: each batch\'s '
              'op on the card vs detection_map_numpy %s; the stream %.6f vs '
              '%.6f' % (', '.join('%.6f/%.6f' % m for m in maps), stream,
                        want), flush=True)
        check(all(abs(a - b) <= 1e-5 for a, b in maps) and
              abs(stream - want) <= 1e-6 and want > 0, 'phase 24a: the mAP '
              'parts from detection_map_numpy')
    finally:
        amp.set_amp(None)
    del sscope, prog
    torch.cuda.empty_cache()
    return path, launches, totals


def _packed_rows(st):
    """The packed rows of a host SequenceTensor."""
    return np.concatenate([np.asarray(st.data)[b, :int(st.lengths[b])]
                           for b in range(len(st.lengths))])


class _CtcCtx(object):
    """The OpCtx a kernel reads, over a dict of values (24b calls the
    warpctc kernel on the card's own logits with autograd on)."""

    def __init__(self, inputs, attrs):
        self.inputs, self.attrs, self.outputs = inputs, attrs, {}
        self.op = type('op', (), {'type': 'warpctc'})

    def input(self, slot):
        return self.inputs.get(slot)

    def attr(self, name, default=None):
        return self.attrs.get(name, default)

    def set_output(self, slot, val):
        self.outputs[slot] = val

    def output_names(self, slot):
        return []


def _phase24_crnn(seed, card):
    """24b. Returns the launches of the timed steps."""
    import torch
    import torch.nn.functional as F
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.compiler import passes
    from paddle_tpu_torch.core import amp
    from paddle_tpu_torch.core.registry import get_kernel
    from paddle_tpu_torch.lod import SequenceTensor
    c = CRNN
    main, startup, _, fetch, ev = crnn_program(pt, seed)
    loss = fetch[0]
    forms = _region_forms(main, [loss.name])
    check(len(forms) == CRNN_REGIONS and all(bn for _, bn in forms),
          'phase 24b: the training program has regions %s' % forms)
    grads = [p.name + '@GRAD' for p in main.global_block().all_parameters()
             if p.trainable]
    exe = pt.Executor()
    scope = pt.Scope()
    exe.run(startup, scope=scope)
    with pt.scope_guard(scope):
        ev.reset(exe)
    rng = np.random.RandomState(seed + 244)

    def feed_of(n):
        images, labels, lens = crnn_batch(rng, n, c['height'], c['width'],
                                          c['classes'], CRNN_LABELS)
        return {'pixel': images, 'label': pt.create_lod_tensor(labels,
                                                               [lens])}
    snap = _snapshot(scope)
    amp.set_amp(False)
    try:
        # one step at CRNN_CPU_BATCH, card against CPU, from the start;
        # the card again with every conv's taps shifted, a control that
        # must fail the gradients' limits
        small = feed_of(CRNN_CPU_BATCH)
        state = {n: v.cpu().numpy() for n, v in snap.items()}
        res = []
        for place, conv in ((pt.CUDAPlace(0), None), (pt.CPUPlace(), None),
                            (pt.CUDAPlace(0), _every_tap_shifted_conv)):
            s = pt.Scope()
            for n, v in state.items():
                s.set_var(n, v)
            with pt.scope_guard(s):
                ev.reset(exe)
            with passes.conv_for_testing(conv) if conv else \
                    contextlib.nullcontext():
                res.append(pt.Executor(place).run(
                    main, feed=small, fetch_list=[loss] + grads, scope=s))

        def parted(got, ref):
            """(the loss's relative distance, each gradient's relative
            L2, the largest |gradient| of a conv's bias)."""
            ldiff = abs(float(got[0]) - float(ref[0])) / abs(float(ref[0]))
            gerr, berr = {}, 0.0
            for name, a, b in zip(grads, got[1:], ref[1:]):
                if name.startswith('conv2d_') and \
                        name.endswith('.w_1@GRAD'):
                    berr = max(berr, float(np.abs(a).max()),
                               float(np.abs(b).max()))
                    continue
                gerr[name] = float(np.linalg.norm(a - b) /
                                   max(np.linalg.norm(b), 1e-30))
            return ldiff, gerr, berr
        ldiff, gerr, berr = parted(res[0], res[1])
        cl, cgerr, _ = parted(res[2], res[1])
        worst = max(gerr, key=gerr.get)
        median = float(np.median(list(gerr.values())))
        cmedian = float(np.median(list(cgerr.values())))
        cworst = max(cgerr, key=cgerr.get)
        print('phase 24b: CRNN-CTC (1x%dx%d, filters %s, GRUs of %d, %d+1 '
              'classes): one f32 step at batch %d, card vs CPU: loss %.7f / '
              '%.7f (relative %.3g, tol %g); gradients by relative L2: the '
              'median %.3g (tol %g), the largest %s %.3g (tol %g), the next '
              '%s; the convs\' biases before a batch norm: max |grad| %.3g '
              '(tol %g); control, every conv\'s taps shifted: loss relative '
              '%.3g, gradients\' median %.3g, largest %s %.3g, smallest %.3g'
              % (c['height'], c['width'], c['filters'], c['hidden'],
                 c['classes'], CRNN_CPU_BATCH, float(res[0][0]),
                 float(res[1][0]), ldiff, CRNN_LOSS_TOL, median,
                 CRNN_GRAD_MEDIAN, worst, gerr[worst], CRNN_GRAD_MAX,
                 ', '.join('%s %.3g' % (n, e) for n, e in sorted(
                     gerr.items(), key=lambda kv: -kv[1])[1:4]),
                 berr, CRNN_BIAS_ABS, cl, cmedian, cworst, cgerr[cworst],
                 min(cgerr.values())), flush=True)
        check(ldiff <= CRNN_LOSS_TOL and median <= CRNN_GRAD_MEDIAN and
              gerr[worst] <= CRNN_GRAD_MAX and berr <= CRNN_BIAS_ABS,
              'phase 24b: the card\'s step parts from the CPU\'s')
        check(cl > CRNN_LOSS_TOL and cmedian > CRNN_GRAD_MEDIAN and
              cgerr[cworst] > CRNN_GRAD_MAX, 'phase 24b: the limits do not '
              'catch every conv\'s taps shifted')
        del res
        _restore(scope, snap)
        with pt.scope_guard(scope):
            ev.reset(exe)
        feed = feed_of(CRNN_BATCH)
        step_ms = []

        def steps():
            outs = []
            for _ in range(CRNN_STEPS):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                outs.append(exe.run(main, feed=feed, fetch_list=fetch,
                                    scope=scope))
                torch.cuda.synchronize()
                step_ms.append(1e3 * (time.perf_counter() - t0))
            return outs
        outs, got, variants, fb = _counted(steps)
        with pt.scope_guard(scope):
            mean_dist = float(ev.eval(exe)[0])
        # one more step recorded region by region: each of its 8 regions
        # held against its plain version at the step's own operands (f32,
        # against f64 too)
        recorder = _RegionRecorder()
        with passes.conv_for_testing(recorder):
            exe.run(main, feed=feed, fetch_list=[loss], scope=scope)
        check(len(recorder.calls) == CRNN_REGIONS, 'phase 24b: a step '
              'recorded %d regions' % len(recorder.calls))
        _hold_regions('crnn training', 'crnn training', recorder.calls, {},
                      sum_dtypes=('float32',), dedupe=True, timed=False)
        del recorder
        losses = [float(o[0]) for o in outs]
        print('phase 24b: trained f32, batch %d, %d steps: ms a step (host '
              'clock, the loss, logits, decode and distances fetched; the '
              'first lowers) %s; losses %s; EditDistance over the steps '
              '%.4f; launches %s, by variant %s, fallbacks %s; %s' % (
                  CRNN_BATCH, CRNN_STEPS, ' '.join('%.2f' % v
                                                   for v in step_ms),
                  ' '.join('%.5f' % l for l in losses), mean_dist, got,
                  {k: v for k, v in variants.items() if v}, fb, card),
              flush=True)
        expect = {k: 0 for k in got}
        expect['fused_conv_stats'] = CRNN_REGIONS * CRNN_STEPS
        check(got == expect and not fb and np.isfinite(losses).all(),
              'phase 24b: launches %s, losses %s' % (got, losses))
        # warpctc against ctc_loss in f64 on the last step's logits
        logits = outs[-1][1]
        lab = feed['label']
        x = torch.as_tensor(logits.data, device='cuda').requires_grad_(True)
        xl = torch.as_tensor(logits.lengths, device='cuda')
        ids = torch.as_tensor(np.asarray(lab.data), device='cuda')
        ll = torch.as_tensor(np.asarray(lab.lengths), device='cuda')
        ctx = _CtcCtx({'Logits': SequenceTensor(x, xl),
                       'Label': SequenceTensor(ids, ll)},
                      {'blank': c['classes'], 'norm_by_times': True})
        get_kernel('warpctc')(ctx)
        ours = ctx.outputs['Loss'][:, 0]
        ours.mean().backward()
        x64 = x.detach().double().requires_grad_(True)
        logp = torch.log_softmax(x64, -1).transpose(0, 1)
        targets = torch.cat([ids[b, :int(ll[b]), 0] for b in
                             range(ids.shape[0])]).long()
        wit = F.ctc_loss(logp, targets, xl.long(), ll.long(),
                         blank=c['classes'], reduction='none') / xl.double()
        wit.mean().backward()
        lerr = float(((ours.detach().double() - wit.detach()).abs() /
                      wit.detach().abs()).max())
        gerr = float((x.grad.double() - x64.grad).abs().max() /
                     x64.grad.abs().max())
        # the greedy decode and the distances on the card and the CPU from
        # the same logits
        dmain = pt.Program()
        with pt.unique_name.guard(), pt.program_guard(dmain, pt.Program()):
            lv = pt.layers.data(name='logits', shape=[c['classes'] + 1],
                                dtype='float32', lod_level=1)
            yv = pt.layers.data(name='label', shape=[1], dtype='int64',
                                lod_level=1)
            dec = pt.layers.ctc_greedy_decoder(lv, blank=c['classes'])
            dist, _ = pt.layers.edit_distance(dec, yv)
        packed = np.concatenate([logits.data[b, :int(logits.lengths[b])]
                                 for b in range(len(logits.lengths))])
        dfeed = {'logits': pt.create_lod_tensor(packed, [list(
            np.asarray(logits.lengths))]),
            'label': pt.create_lod_tensor(np.asarray(_packed_rows(lab),
                                                     'int64'),
                                          [list(np.asarray(lab.lengths))])}
        decs = [pt.Executor(place).run(dmain, feed=dfeed,
                                       fetch_list=[dec, dist],
                                       scope=pt.Scope())
                for place in (pt.CUDAPlace(0), pt.CPUPlace())]
        same = np.array_equal(np.asarray(decs[0][0]),
                              np.asarray(decs[1][0])) and \
            np.array_equal(decs[0][0].lengths, decs[1][0].lengths) and \
            np.array_equal(decs[0][1], decs[1][1])
        print('phase 24b: warpctc vs ctc_loss in f64 on the card\'s logits '
              '(%d strips, %d steps): loss relative %.3g (tol %g), logits '
              'gradient %.3g of its largest (tol %g); the greedy decode and '
              'its distances card vs CPU equal: %s (mean distance %.4f)' % (
                  x.shape[0], x.shape[1], lerr, CTC_WITNESS_TOL, gerr,
                  CTC_GRAD_TOL, same, float(np.mean(decs[0][1]))),
              flush=True)
        check(lerr <= CTC_WITNESS_TOL and gerr <= CTC_GRAD_TOL and same,
              'phase 24b: warpctc or the decode parts from its witness')
    finally:
        amp.set_amp(None)
    return got


def _phase24_observatory(seed, card, d):
    """24c."""
    import torch
    import urllib.request
    import paddle_tpu_torch as pt
    from paddle_tpu_torch import observability as obs
    from paddle_tpu_torch.compiler.tuning import Autotuner
    from paddle_tpu_torch.observability import flight, perf

    def train_func():
        img = pt.layers.data(name='image', shape=[3, SSD['size'],
                                                  SSD['size']],
                             dtype='float32')
        loc, conf, box, var = mobilenet_ssd(pt.layers, img, SSD['classes'],
                                            SSD['scale'])
        gt_box = pt.layers.data(name='gt_box', shape=[4], dtype='float32',
                                lod_level=1)
        gt_label = pt.layers.data(name='gt_label', shape=[1], dtype='int32',
                                  lod_level=1)
        return pt.layers.reduce_sum(pt.layers.ssd_loss(loc, conf, gt_box,
                                                       gt_label, box, var))
    rng = np.random.RandomState(seed + 245)

    def reader():
        for _ in range(SSD_TRAINER_STEPS):
            boxes, labels, lens = ssd_ground_truth(rng, SSD_BATCH,
                                                   SSD['classes'])
            off = np.cumsum([0] + lens)
            yield [(rng.randn(3, SSD['size'], SSD['size']).astype('float32'),
                    boxes[off[i]:off[i + 1]], labels[off[i]:off[i + 1]])
                   for i in range(SSD_BATCH)]

    perf.clear()
    trainer = pt.Trainer(train_func, pt.optimizer.Momentum(
        learning_rate=0.001, momentum=0.9), place=pt.CUDAPlace(0))
    t0 = time.perf_counter()
    with perf.capture_scope(True):
        trainer.train(num_epochs=1, event_handler=lambda e: None,
                      reader=reader, feed_order=['image', 'gt_box',
                                                 'gt_label'])
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    prog = trainer.train_program
    fp = prog.fingerprint()
    led = perf.get_ledger(fp)
    check(led is not None, 'phase 24c: the training step left no ledger')
    hand = _conv_hand_count(prog, [trainer.train_func_outputs[0].name],
                            SSD_BATCH, True)
    reg = obs.default_registry()
    mfu = reg.get('perf_mfu', program=fp)
    roof = reg.get('perf_roofline_bound', program=fp)
    srv = obs.serve_telemetry(port=0)
    try:
        with urllib.request.urlopen('http://127.0.0.1:%d/ledgers' % srv.port,
                                    timeout=30) as r:
            docs = json.loads(r.read())
    finally:
        srv.close()
    with open(flight.dump('phase24c', directory=d)) as f:
        bundle = json.load(f)
    bound = Autotuner._ledger_bound(prog)
    print('phase 24c: the Trainer, %d MobileNet-SSD steps at batch %d under '
          'capture (%.1f s, the lowering included): the ledger (%s): '
          '%.4g operations (the fused conv regions %.4g, hand count from '
          'the layers %.4g), %.4g bytes, arguments %.3g GB, outputs %.3g '
          'GB, peak above them %.3g GB; bounds %.3f ms operations, %.3f ms '
          'bytes (%s); measured %.2f ms a step (the dispatch wall); MFU '
          'gauge %s, roofline gauge %s; /ledgers %d ledger(s), the flight '
          'bundle %d; _ledger_bound %r; %s' % (
              SSD_TRAINER_STEPS, SSD_BATCH, dt, led.device_kind, led.flops,
              led.flops_by_type.get('fused_conv', 0), hand,
              led.bytes_accessed, led.argument_bytes / 1e9,
              led.output_bytes / 1e9, led.temp_bytes / 1e9,
              1e3 * led.compute_bound_s(), 1e3 * led.bandwidth_bound_s(),
              led.roofline_bound, led.measured_ms or 0.0,
              mfu.value if mfu else None, roof.value if roof else None,
              len(docs), len(bundle['ledgers'] or []), bound, card),
          flush=True)
    check(led.flops_by_type.get('fused_conv') == hand, 'phase 24c: the '
          'ledger counts %s fused conv operations, the hand count %d'
          % (led.flops_by_type.get('fused_conv'), hand))
    check(led.device_kind == torch.cuda.get_device_name(0) and
          led.temp_bytes > 0 and mfu is not None and mfu.value > 0 and
          abs(mfu.value - led.mfu()) <= 1e-12 and roof is not None and
          roof.value in (0.0, 1.0), 'phase 24c: the gauges or the memory')
    check(fp in [x['fp'] for x in docs] and
          fp in [x['fp'] for x in bundle['ledgers']] and
          bound == led.roofline_bound, 'phase 24c: /ledgers, the flight '
          'bundle or _ledger_bound misses the ledger')
    perf.clear()
    del trainer
    torch.cuda.empty_cache()


def _timed_preparation():
    """Wrap the steps of the Executor's memo miss (the verify, the prune,
    the passes, the lowering) and the store's load and save with wall
    clocks: returns the dict of their seconds, summed over the process."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch import analysis, compiler
    from paddle_tpu_torch import executor as pexe
    from paddle_tpu_torch.fleet import coldstart
    prep = dict(verify=0.0, prune=0.0, passes=0.0, lowering=0.0,
                store_load=0.0, store_save=0.0)

    def timed(key, fn):
        def wrapper(*a, **k):
            t0 = time.perf_counter()
            try:
                return fn(*a, **k)
            finally:
                prep[key] += time.perf_counter() - t0
        return wrapper
    for mod, name, key in ((analysis, 'verify_for_executor', 'verify'),
                           (compiler, 'optimize', 'passes'),
                           (pexe, 'lower_block', 'lowering'),
                           (coldstart.AotStore, 'load', 'store_load'),
                           (coldstart.AotStore, 'save', 'store_save')):
        setattr(mod, name, timed(key, getattr(mod, name)))
    pt.Executor._maybe_prune = staticmethod(timed(
        'prune', pt.Executor.__dict__['_maybe_prune'].__func__))
    return prep


def coldstart_child(model_dir, store_dir, out):
    """24d's child (``--coldstart-child``): a fresh ModelServer on the card
    warms the saved SSD model (buckets up to COLDSTART_MAX_BATCH) under
    the cold-start store at ``store_dir``, serves one batch of
    COLDSTART_MAX_BATCH, and writes its outputs, the store's counters,
    the warm-up's seconds and those of its memo miss's steps
    (``_timed_preparation``) to ``out`` (.npz)."""
    import torch
    import paddle_tpu_torch as pt
    from paddle_tpu_torch import compiler
    from paddle_tpu_torch.fleet import coldstart
    from paddle_tpu_torch.observability import default_registry
    prep = _timed_preparation()
    os.makedirs(os.path.join(ROOT, 'build'), exist_ok=True)
    with tempfile.TemporaryDirectory(dir=os.path.join(ROOT, 'build')) as d, \
            coldstart.cache_scope(store_dir):
        compiler.tuning.set_default_cache(compiler.tuning.TuningCache(
            os.path.join(d, 'tuning_cache.json')))
        image = np.random.RandomState(7).randn(
            COLDSTART_MAX_BATCH, 3, SSD['size'], SSD['size']).astype(
                'float32')
        with pt.serving.ModelServer(
                max_batch_size=COLDSTART_MAX_BATCH) as srv:
            srv.load_model('ssd', model_dir)
            t0 = time.perf_counter()
            warmed = srv.warmup('ssd')
            torch.cuda.synchronize()
            warm_s = time.perf_counter() - t0
            outs = srv.submit('ssd', {'image': image}).result(timeout=300)
        reg = default_registry()
        counts = {n: (reg.get(n).value if reg.get(n) else 0) for n in (
            'coldstart_hits_total', 'coldstart_misses_total',
            'coldstart_saves_total', 'coldstart_failures_total')}
    np.savez(out, warm_s=warm_s, buckets=np.asarray(warmed['ssd']),
             counts=json.dumps(counts), prep=json.dumps(prep),
             **{'out%d' % i: np.asarray(o) for i, o in enumerate(outs)})
    print('coldstart-child: warmed %s in %.3f s; %s; %s' % (
        warmed['ssd'], warm_s, counts, prep), flush=True)
    return 0


def _child_env(d):
    env = dict(os.environ)
    env['PYTHONPATH'] = os.pathsep.join(
        [ROOT] + [p for p in env.get('PYTHONPATH', '').split(os.pathsep)
                  if p])
    env['PADDLE_TPU_TORCH_TUNING_CACHE'] = os.path.join(d, 'child_tuning.json')
    env['PADDLE_TPU_TORCH_AMP'] = '0'
    return env


def _phase24_coldstart(model_dir, d, card):
    """24d."""
    store = os.path.join(d, 'aot_store')
    runs = []
    for label in ('empty store', 'filled store'):
        out = os.path.join(d, 'coldstart_%d.npz' % len(runs))
        t0 = time.perf_counter()
        r = subprocess.run([sys.executable, os.path.join(ROOT,
                                                         'chip_smoke.py'),
                            '--coldstart-child', model_dir, store, out],
                           capture_output=True, text=True, timeout=600,
                           env=_child_env(d))
        wall = time.perf_counter() - t0
        check(r.returncode == 0, 'phase 24d: the child on the %s exited %d: '
              '%s' % (label, r.returncode, r.stderr[-3000:]))
        with np.load(out) as z:
            runs.append((label, wall, float(z['warm_s']),
                         json.loads(str(z['counts'])),
                         [z['out%d' % i] for i in range(3)],
                         [int(b) for b in z['buckets']],
                         json.loads(str(z['prep']))))
    for label, wall, warm_s, counts, _, buckets, prep in runs:
        print('phase 24d: a fresh replica on the %s: warm-up of buckets %s '
              '%.3f s (the process %.1f s, its start and imports included), '
              'of it the memo miss\'s steps (wall): verify %.4f s, prune '
              '%.4f s, passes %.4f s, lowering %.4f s, store load %.4f s, '
              'store save %.4f s; store hits %d, misses %d, saves %d, '
              'failures %d; %s' % (
                  label, buckets, warm_s, wall, prep['verify'],
                  prep['prune'], prep['passes'], prep['lowering'],
                  prep['store_load'], prep['store_save'],
                  counts['coldstart_hits_total'],
                  counts['coldstart_misses_total'],
                  counts['coldstart_saves_total'],
                  counts['coldstart_failures_total'], card), flush=True)
    (_, _, _, c0, o0, _, _), (_, _, _, c1, o1, _, _) = runs
    same = all(np.array_equal(a, b) for a, b in zip(o0, o1))
    print('phase 24d: outputs of the two replicas bit-identical: %s' % same,
          flush=True)
    check(c0['coldstart_saves_total'] >= 1 and
          c0['coldstart_hits_total'] == 0 and
          c1['coldstart_hits_total'] >= 1 and
          c1['coldstart_saves_total'] == 0 and
          c1['coldstart_failures_total'] == 0 and same,
          'phase 24d: counters %s then %s, bit-identical %s' % (c0, c1, same))


def _phase24_capi(model_dir, d, card):
    """24e."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch import io as pt_io
    from paddle_tpu_torch.core import amp
    from paddle_tpu_torch.native import capi
    t0 = time.perf_counter()
    lib = capi.build()
    src = os.path.join(d, 'capi_client.c')
    exe_path = os.path.join(d, 'capi_client')
    with open(src, 'w') as f:
        f.write(CAPI_CLIENT)
    _, ldflags = capi.python_flags()
    r = subprocess.run(['gcc', src, '-o', exe_path, lib,
                        '-Wl,-rpath,' + os.path.dirname(lib)] + ldflags,
                       capture_output=True, text=True)
    check(r.returncode == 0, 'phase 24e: the C program did not build: %s'
          % r.stderr[-2000:])
    built = time.perf_counter() - t0
    t0 = time.perf_counter()
    r = subprocess.run([exe_path, model_dir], capture_output=True, text=True,
                       timeout=600, env=_child_env(d))
    ran = time.perf_counter() - t0
    check(r.returncode == 0, 'phase 24e: the C program exited %d: %s'
          % (r.returncode, r.stderr[-3000:]))
    lines = r.stdout.strip().splitlines()
    got = np.array([float(v) for v in lines[-1].split()], 'float32')
    amp.set_amp(False)
    try:
        exe = pt.Executor()
        scope = pt.Scope()
        prog, feeds, fetch = pt_io.load_inference_model(model_dir, exe,
                                                        scope=scope)
        want = exe.run(prog, feed={feeds[0]: _capi_input()},
                       fetch_list=fetch, scope=scope)[0]
    finally:
        amp.set_amp(None)
    same = got.shape == (want.size,) and np.array_equal(
        got.reshape(want.shape), want)
    print('phase 24e: the C program (gcc, linked to %s) served the saved '
          'MobileNet-SSD on the card: %s, %d detections kept; equal to the '
          'Executor\'s bit for bit: %s; built in %.1f s, ran in %.1f s (the '
          'interpreter\'s start and imports included); %s' % (
              os.path.basename(lib), lines[0], int((want[..., 0] >= 0)
                                                   .sum()), same, built, ran,
              card), flush=True)
    check(same, 'phase 24e: the C API\'s output parts from the Executor\'s')


def phase_detection_ctc(seed, card):
    """24. MobileNet-SSD trained and served (24a), CRNN-CTC trained and
    decoded (24b), the observatory (24c), the cold-start store (24d), the
    C API (24e). Returns (the launches of the main paths: fused_conv,
    fused_conv_stats and the depthwise variant in each form; 6l's
    totals)."""
    import torch
    t_phase = time.perf_counter()
    os.makedirs(os.path.join(ROOT, 'build'), exist_ok=True)
    with tempfile.TemporaryDirectory(dir=os.path.join(ROOT, 'build')) as d:
        scope, trained = _phase24_ssd_training(seed, card)
        _lap('24a_ssd_training')
        path, served, totals = _phase24_ssd_serving(seed, card, d, scope)
        del scope
        torch.cuda.empty_cache()
        _lap('24a_ssd_serving')
        crnn = _phase24_crnn(seed, card)
        _lap('24b_crnn_ctc')
        _phase24_observatory(seed, card, d)
        _lap('24c_observatory')
        _phase24_coldstart(path, d, card)
        _lap('24d_coldstart')
        _phase24_capi(path, d, card)
        _lap('24e_capi')
    launches = {'fused_conv': trained['fused_conv'] + served['fused_conv'],
                'fused_conv_stats': trained['fused_conv_stats'] +
                crnn['fused_conv_stats'],
                'depthwise': served['depthwise'],
                'depthwise_stats': trained['depthwise']}
    torch.cuda.empty_cache()
    print('phase 24: %.1f s; %.1f s since the process started; launches %s'
          % (time.perf_counter() - t_phase, time.perf_counter() - _STARTED,
             launches), flush=True)
    return launches, totals


# ---- 25. data parallelism and ZeRO-2 on two ranks ---------------------------------

DP_RANKS = 2                  # ranks of the data-parallel group
DP_STEPS = 3                  # Momentum(0.01, 0.9) steps at the global batch
DP_BATCH = RESNET_TRAIN_BATCH  # the global batch: 64 rows a rank
DP_SERVE_BATCH = 32           # the served batch: 16 rows a rank
DP_GROUP_TIMEOUT_S = 60       # the process group's collective timeout
DP_JOIN_S = 150               # each rank's join, at most
# two ranks against one card at the global batch, in f32 with cuDNN's
# deterministic algorithms (under AMP bf16 rounding alone parts the runs
# by about as much as the control, PERF.md, Findings), the residual
# branches' last batch-norm scales at RESIDUAL_GAMMA (at 1 a random
# ResNet-50 parts by rounding alone): the largest |loss difference| of
# the DP_STEPS steps, the relative L2 distance of the first step's
# gradients (its velocities) and of the trainable parameters' update
# after DP_STEPS steps. Set from the sound run on the H100 (PERF.md,
# Findings): 0, 6.23e-4 and 5.30e-4, the per-rank
# batch-norm control 4.07e-4, 0.0648 and 0.0628; the limits are 8-9x
# the sound gradients and update, 13x under the control's.
DP_LOSS_LIMIT = 1e-4
DP_GRAD_LIMIT = 5e-3
DP_UPDATE_LIMIT = 5e-3


def _dp_names(program):
    """The program's persistables that a step writes: parameters,
    velocities and the batch norms' moving statistics (not the learning
    rate)."""
    return sorted(v.name for v in program.list_vars()
                  if v.persistable and not v.name.startswith('learning_rate'))


def _dp_velocities(program):
    return [n for n in _dp_names(program) if '_velocity_' in n]


def _dp_rel(pairs):
    """The relative L2 distance of the first of each pair from the
    second, over all pairs."""
    num = sum(float(((a - b) ** 2).sum()) for a, b in pairs)
    den = sum(float((b ** 2).sum()) for _, b in pairs)
    return (num / max(den, 1e-30)) ** 0.5


def _gloo_cuda_probe(group):
    """Which collectives torch's gloo backend takes on CUDA tensors
    (each rank calls each with the same tensors, so a refusal is the same
    on every rank)."""
    import torch
    import torch.distributed as dist
    x = torch.ones(4, device=group.device)
    tries = {
        'all_reduce': lambda: dist.all_reduce(x.clone()),
        'broadcast': lambda: dist.broadcast(x.clone(), 0),
        'all_gather': lambda: dist.all_gather(
            [torch.empty_like(x) for _ in range(group.size)], x),
        'reduce_scatter': lambda: dist.reduce_scatter(
            torch.empty(4 // group.size, device=x.device),
            list(x.chunk(group.size))),
    }
    out = {}
    for name, fn in tries.items():
        try:
            fn()
            torch.cuda.synchronize()
            out[name] = 'native'
        except Exception as e:     # a refusal is the reading
            out[name] = 'refused (%s)' % str(e).splitlines()[0][:80]
    return out


@contextlib.contextmanager
def _per_rank_batch_norms():
    """The control: every batch norm takes the moments of its rank's own
    rows (the batch_norm kernel and the fused conv's train-mode region
    see no group), the per-rank answer the global batch must not give."""
    from paddle_tpu_torch.compiler import passes
    from paddle_tpu_torch.ops import nn_ops
    orig = nn_ops.batch_group, passes.batch_group
    nn_ops.batch_group = lambda ctx: None if ctx.op.type == 'batch_norm' \
        else orig[0](ctx)
    passes.batch_group = lambda ctx: None
    try:
        yield
    finally:
        nn_ops.batch_group, passes.batch_group = orig


def _dp_train(pt, seed, init, device, feed, zero_stage):
    """DP_STEPS steps of ResNet-50 through a ParallelExecutor from the
    state ``init``: (readings, the executor, its loss, its Scope)."""
    import torch
    main, _, loss = _train_program(seed)
    scope = pt.Scope()
    for n, t in init.items():
        scope.set_var(n, t.to(device))
    with pt.scope_guard(scope):
        pe = pt.ParallelExecutor(loss_name=loss.name, main_program=main,
                                 zero_stage=zero_stage)
    r = dict(velocity_bytes=sum(t.numel() * t.element_size() for n, t in
                                scope.vars.items() if '_velocity_' in n),
             argument_bytes=pe.compile_stats()['argument_bytes'],
             zero=dict((k, v) for k, v in pe._zero.items()
                       if not k.endswith('_names')),
             losses=[], ms=[])
    for step in range(DP_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r['losses'].append(float(pe.run(fetch_list=[loss.name],
                                        feed=feed)[0][0]))
        torch.cuda.synchronize()
        r['ms'].append(1e3 * (time.perf_counter() - t0))
        if step == 0:
            # the first step's gradients: its velocities, whole
            r['first'] = pe.global_state(_dp_velocities(main))
    r['state'] = pe.global_state(_dp_names(main))
    return r, pe, loss, scope


def _dp_rank(rank, world, d, sub, seed, cards):
    """One rank of phase 25 (a process of its own). The main path under
    AMP, as the card trains: the replicated and ZeRO-2 runs, the served
    batch, the served batch again and one more step, both recorded. Then
    in f32 (AMP off, where rounding alone moves a step's gradients
    little): replicated, ZeRO-2 and one more recorded step, and the
    per-rank batch-norm control. Rank 0 then compares, holds the
    recorded regions and writes the readings."""
    import torch
    sys.path.insert(0, ROOT)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    import paddle_tpu_torch as pt
    from paddle_tpu_torch import compiler
    from paddle_tpu_torch.compiler import passes
    from paddle_tpu_torch.core import amp
    from paddle_tpu_torch.ops import cuda_kernels as ck
    from paddle_tpu_torch.parallel import mesh
    compiler.tuning.set_default_cache(compiler.tuning.TuningCache(
        os.path.join(sub, 'tuning_r%d.json' % rank)))
    group = mesh.init_dp(rank, world, 'file://' + os.path.join(sub, 'store'),
                         timeout=DP_GROUP_TIMEOUT_S, device_count=cards)
    out = {'rank': rank, 'backend': group.backend,
           'device': str(group.device)}
    print('smoke: phase 25 rank %d of %d on %s, backend %s' % (
        rank, world, group.device, group.backend), flush=True)
    if group.backend == 'gloo':
        out['gloo_cuda'] = _gloo_cuda_probe(group)
    init = torch.load(os.path.join(d, 'init.pt'))
    feed = _image_train_feed(DP_BATCH, seed + 25)
    runs = {}
    recorders = {k: _RegionRecorder() for k in ('step', 'served', 'f32')}

    def recorded(tag):
        # rank 0 records its calls; rank 1 runs the same unrecorded
        return passes.conv_for_testing(recorders[tag]) if rank == 0 \
            else contextlib.nullcontext()
    sums = []
    try:
        ck.reset_launch_counts()
        passes.reset_fallback_counts()
        runs['replicated'] = _dp_train(pt, seed, init, group.device, feed,
                                       0)[0]
        torch.cuda.empty_cache()
        runs['zero2'], pe, loss, scope = _dp_train(pt, seed, init,
                                                   group.device, feed, 2)
        out['launches'] = dict(ck.LAUNCHES)
        out['variants'] = dict(ck.FUSED_CONV_VARIANT_LAUNCHES)
        out['fallbacks'] = dict(passes.FALLBACKS)
        # the served batch through a ParallelExecutor with no loss,
        # sharing the trained Scope: 16 rows a rank, gathered
        test_main, _, prob = _resnet_program(seed, is_test=True)
        serve = pt.ParallelExecutor(main_program=test_main,
                                    share_vars_from=pe)
        images = _image_feed(DP_SERVE_BATCH, seed + 26)
        ck.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        served = serve.run(fetch_list=[prob.name], feed=images)[0]
        torch.cuda.synchronize()
        out['serve_ms'] = 1e3 * (time.perf_counter() - t0)
        out['serve_launches'] = dict(ck.LAUNCHES)
        # the served batch again, rank 0's fused-conv calls recorded
        with recorded('served'):
            again = serve.run(fetch_list=[prob.name], feed=images)[0]
        out['served_again_equal'] = bool(np.array_equal(again, served))
        one = None
        if rank == 0:
            # one card on the same weights (no collective: rank 1 waits
            # in the next step's first one)
            one = pt.Executor(pt.CUDAPlace(group.device.index or 0)).run(
                test_main, feed=images, fetch_list=[prob], scope=scope)[0]
        # one more step, its fused-conv calls recorded and the batch
        # norms' sums before and after the collective kept
        orig = passes.global_sums

        def kept(g, *parts):
            res = orig(g, *parts)
            sums.append(([p.detach().float().cpu() for p in parts],
                         [r.detach().float().cpu() for r in res]))
            return res
        passes.global_sums = kept
        try:
            with recorded('step'):
                pe.run(fetch_list=[loss.name], feed=feed)
        finally:
            passes.global_sums = orig
        torch.save([s[0] for s in sums], os.path.join(
            sub, 'sums_r%d.pt' % rank))
        del pe, serve, scope
        torch.cuda.empty_cache()
        # f32 (cuDNN's deterministic algorithms, as one card's f32 run):
        # replicated, ZeRO-2 (and one more step, its fused-conv calls
        # recorded) and the control, each rank's batch norms over its own
        # rows
        amp.set_amp(False)
        torch.backends.cudnn.deterministic = True
        for mode, stage in (('replicated_f32', 0), ('zero2_f32', 2),
                            ('control_f32', 0)):
            with _per_rank_batch_norms() if mode.startswith('control') \
                    else contextlib.nullcontext():
                runs[mode], pe, loss, scope = _dp_train(
                    pt, seed, init, group.device, feed, stage)
            if mode == 'zero2_f32':
                with recorded('f32'):
                    pe.run(fetch_list=[loss.name], feed=feed)
            del pe, scope
            torch.cuda.empty_cache()
        torch.backends.cudnn.deterministic = False
        amp.set_amp(None)
    finally:
        mesh.shutdown_dp()
    for mode, r in runs.items():
        out[mode] = {k: v for k, v in r.items()
                     if k not in ('state', 'first')}
    if rank == 0:
        out.update(_dp_rank0_readings(d, sub, runs, sums, served, one,
                                      init, recorders))
    with open(os.path.join(sub, 'rank%d.json' % rank), 'w') as f:
        json.dump(out, f)


def _dp_rank0_readings(d, sub, runs, sums, served, one, init, recorders):
    """Rank 0, after the group is gone: ZeRO-2 against replicated bit for
    bit, each run against one card (under AMP and in f32), the served
    batch against one card's on the same weights, the sums against their
    collective, and the recorded regions (of the served batch, an AMP
    step and an f32 step) against their plain versions."""
    import torch
    out = {}
    for amp_tag in ('', '_f32'):
        rep = runs['replicated' + amp_tag]
        zero = runs['zero2' + amp_tag]
        out['bit_equal' + amp_tag] = bool(
            zero['losses'] == rep['losses'] and
            sorted(rep['state']) == sorted(zero['state']) and
            all(np.array_equal(rep['state'][n], zero['state'][n])
                for n in rep['state']))
        out['unequal' + amp_tag] = [
            n for n in rep['state'] if n in zero['state'] and
            not np.array_equal(rep['state'][n], zero['state'][n])][:5]
    refs = torch.load(os.path.join(d, 'single.pt'))
    host_init = {n: t.float().numpy() for n, t in init.items()}
    for mode, r in runs.items():
        ref = refs['f32' if mode.endswith('_f32') else 'amp']
        single = {n: t.float().numpy() for n, t in ref['state'].items()}
        first = {n: t.float().numpy() for n, t in ref['first'].items()}
        out['compared'] = len(set(r['state']) & set(single))
        out[mode + '_loss_gap'] = max(abs(a - b) for a, b in zip(
            r['losses'], ref['losses']))
        out[mode + '_grad_gap'] = _dp_rel([(r['first'][n], first[n])
                                           for n in first])
        out[mode + '_update_gap'] = _dp_rel([
            (r['state'][n] - host_init[n], single[n] - host_init[n])
            for n in ref['params'] if n in single])
    # the served batch against one card on the same (trained) weights
    out['served_shape'] = list(np.shape(served))
    out['served_gap'] = float(np.abs(served - one).max() /
                              np.abs(one).max())
    out['served_top1'] = float((served.argmax(1) == one.argmax(1)).mean())
    # the batch norms' sums: after the collective, rank 0's + rank 1's
    other = torch.load(os.path.join(sub, 'sums_r1.pt'))
    worst = 0.0
    for (mine, after), theirs in zip(sums, other):
        for a, b, s in zip(mine, theirs, after):
            worst = max(worst, float((a + b - s).abs().max()) /
                        max(float(s.abs().max()), 1e-30))
    out['sums'] = [len(sums), len(other)]
    out['sums_gap'] = worst
    held = {}
    for tag, rows in (('step', DP_BATCH), ('served', DP_SERVE_BATCH),
                      ('f32', DP_BATCH)):
        calls = recorders[tag].calls
        _hold_regions('dp rank 0 %s b%d' % (tag, rows // DP_RANKS), 'dp',
                      calls, {}, dedupe=True, timed=False)
        held[tag] = [len(calls), sum(c[8] for c in calls),
                     sorted({str(c[0].dtype).replace('torch.', '')
                             for c in calls})]
    out['held_regions'] = held
    return out


def _dp_spawn(d, sub, seed, cards):
    """The ranks of one group (``spawn``; a ``file://`` store in ``sub``),
    each joined within DP_JOIN_S: a rank that fails or is late fails the
    phase. Returns the ranks' readings."""
    import torch.multiprocessing as mp
    os.makedirs(sub, exist_ok=True)
    ctx = mp.start_processes(_dp_rank, args=(DP_RANKS, d, sub, seed, cards),
                             nprocs=DP_RANKS, join=False,
                             start_method='spawn')
    deadline = time.monotonic() + DP_JOIN_S
    try:
        while not ctx.join(timeout=5.0):
            check(time.monotonic() < deadline,
                  'phase 25: a rank did not finish in %d s' % DP_JOIN_S)
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
                p.join()
    out = []
    for r in range(DP_RANKS):
        with open(os.path.join(sub, 'rank%d.json' % r)) as f:
            out.append(json.load(f))
    return out


def _dp_report(label, ranks, single_ms, card):
    """Print one group's readings and hold them to the phase's limits;
    returns its main path's launches."""
    r0 = ranks[0]
    print('data parallel %s: backend %s, ranks on %s; gloo on CUDA '
          'tensors: %s' % (label, r0['backend'], [r['device'] for r in ranks],
                           r0.get('gloo_cuda', 'not used')), flush=True)
    for mode in ('replicated', 'zero2', 'replicated_f32', 'zero2_f32',
                 'control_f32'):
        print('data parallel %s %s: losses %s; against one card at batch '
              '%d: loss gap %.3g, first step\'s gradients %.3g, update '
              '%.3g%s' % (
                  label, mode, ', '.join('%.5f' % v for v in
                                         r0[mode]['losses']), DP_BATCH,
                  r0[mode + '_loss_gap'], r0[mode + '_grad_gap'],
                  r0[mode + '_update_gap'], '' if mode.endswith('_f32')
                  else ' (AMP: read, not held)'), flush=True)
    for mode in ('replicated', 'zero2', 'replicated_f32'):
        amp_tag = 'f32' if mode.endswith('_f32') else 'amp'
        two = max(np.mean(r[mode]['ms'][1:]) for r in ranks)
        print('data parallel %s %s: %.1f ms a step on %d ranks (%s; the '
              'first %.1f ms), one card %.1f ms a step (first %.1f); '
              'per-rank argument bytes %d, velocity bytes %d; %s' % (
                  label, mode, two, DP_RANKS,
                  'two ranks sharing one card through gloo'
                  if r0['backend'] == 'gloo' else 'a card a rank, NCCL',
                  max(r[mode]['ms'][0] for r in ranks),
                  np.mean(single_ms[amp_tag][1:]), single_ms[amp_tag][0],
                  r0[mode]['argument_bytes'], r0[mode]['velocity_bytes'],
                  card), flush=True)
    print('data parallel %s: ZeRO-2 %s under AMP, %s in f32; zero %s; '
          'served batch %s (%d rows a rank), %.1f ms, gap %.3g, top-1 '
          'agreement %.3f against one card on the same weights; '
          'batch-norm sums %s, after the collective against the sum of the '
          'ranks\' %.3g; regions held against their plain versions '
          '(recorded, of them stats form, dtypes) %s; launches %s / %s, '
          'serving %s, fallbacks %s' % (
              label, 'bit-equal to replicated' if r0['bit_equal']
              else 'differs from replicated: %s' % r0['unequal'],
              'bit-equal' if r0['bit_equal_f32']
              else 'differs: %s' % r0['unequal_f32'],
              r0['zero2']['zero'], r0['served_shape'],
              DP_SERVE_BATCH // DP_RANKS, r0['serve_ms'], r0['served_gap'],
              r0['served_top1'], r0['sums'], r0['sums_gap'],
              r0['held_regions'], [r['launches'] for r in ranks],
              [r['variants'] for r in ranks],
              [r['serve_launches'] for r in ranks],
              [r['fallbacks'] for r in ranks]), flush=True)
    check(r0['compared'] > 300, 'phase 25 compared only %d persistables'
          % r0['compared'])
    # bit for bit on the main path (AMP) and in f32 (under cuDNN's
    # deterministic algorithms: free to pick its algorithms, cuDNN parted
    # the stem's batch norm)
    check(r0['bit_equal'], 'ZeRO-2 is not bit-equal to replicated: %s'
          % r0['unequal'])
    check(r0['bit_equal_f32'], 'ZeRO-2 in f32 is not bit-equal to '
          'replicated: %s' % r0['unequal_f32'])
    limits = {'loss': DP_LOSS_LIMIT, 'grad': DP_GRAD_LIMIT,
              'update': DP_UPDATE_LIMIT}
    for mode in ('replicated_f32', 'zero2_f32'):
        over = {k: r0['%s_%s_gap' % (mode, k)] for k, v in limits.items()
                if r0['%s_%s_gap' % (mode, k)] > v}
        check(not over, '%s on %d ranks is outside the limits %s of one '
              'card: %s' % (mode, DP_RANKS, limits, over))
    check(any(r0['control_f32_%s_gap' % k] > v for k, v in limits.items()),
          'the per-rank batch-norm control is within the limits %s'
          % limits)
    check(r0['zero2']['velocity_bytes'] * DP_RANKS ==
          r0['replicated']['velocity_bytes'],
          'ZeRO-2 velocity bytes %d, replicated %d' % (
              r0['zero2']['velocity_bytes'],
              r0['replicated']['velocity_bytes']))
    check(r0['replicated']['argument_bytes'] -
          r0['zero2']['argument_bytes'] == r0['zero2']['velocity_bytes'],
          'ZeRO-2 cut the per-rank state by %d bytes, not half the '
          'velocities' % (r0['replicated']['argument_bytes'] -
                          r0['zero2']['argument_bytes']))
    check(r0['served_shape'] == [DP_SERVE_BATCH, 1000] and
          r0['served_gap'] <= RESNET_LOGITS_TOL and
          r0['served_top1'] >= RESNET_TOP1,
          'the served batch differs from one card: %s' % r0['served_gap'])
    check(r0['sums'] == [RESNET_REGIONS, RESNET_REGIONS] and
          r0['sums_gap'] <= 1e-6,
          'the batch-norm sums after the collective: %s, gap %.3g' % (
              r0['sums'], r0['sums_gap']))
    check(r0['held_regions'] == {
        'step': [RESNET_REGIONS, RESNET_REGIONS, ['bfloat16']],
        'served': [RESNET_REGIONS, 0, ['bfloat16']],
        'f32': [RESNET_REGIONS, RESNET_REGIONS, ['float32']]},
        'held the regions %s' % r0['held_regions'])
    for r in ranks:
        check(r['served_again_equal'], 'rank %d served the batch recorded '
              'other values' % r['rank'])
    stats = 0
    for r in ranks:
        check(not r['fallbacks'], 'phase 25 fell back: %s' % r['fallbacks'])
        expect = {n: 0 for n in r['launches']}
        expect['fused_conv_stats'] = RESNET_REGIONS * DP_STEPS * 2
        check(r['launches'] == expect, 'rank %d training launches %s, '
              'expected %s' % (r['rank'], r['launches'], expect))
        check(r['variants'] == {v: c * DP_STEPS * 2
                                for v, c in RESNET_VARIANTS.items()},
              'rank %d took the fused conv variants %s' % (
                  r['rank'], r['variants']))
        expect = {n: 0 for n in r['serve_launches']}
        expect['fused_conv'] = RESNET_REGIONS
        check(r['serve_launches'] == expect, 'rank %d serving launches %s'
              % (r['rank'], r['serve_launches']))
        stats += r['launches']['fused_conv_stats']
    return {'fused_conv_stats': stats,
            'fused_conv': sum(r['serve_launches']['fused_conv']
                              for r in ranks)}


def _dp_single(pt, seed, init, feed):
    """DP_STEPS steps on one card from the state ``init``: the
    readings."""
    import torch
    main, _, loss = _train_program(seed)
    exe = pt.Executor()
    scope = pt.Scope()
    for n, t in init.items():
        scope.set_var(n, t.to(exe.device))
    losses, ms = [], []
    for step in range(DP_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses.append(float(exe.run(main, feed=feed, fetch_list=[loss],
                                    scope=scope)[0][0]))
        torch.cuda.synchronize()
        ms.append(1e3 * (time.perf_counter() - t0))
        if step == 0:
            first = {n: scope.raw(n).detach().cpu().clone()
                     for n in _dp_velocities(main)}
    marker = [op for op in main.global_block().ops
              if op.type == 'backward_marker'][0]
    return {'losses': losses, 'ms': ms, 'first': first,
            'params': list(marker.attrs['params']),
            'state': {n: scope.raw(n).detach().cpu()
                      for n in _dp_names(main)}}


def phase_data_parallel(seed, card):
    """25. ResNet-50 (full width, Momentum(0.01, 0.9)) trained DP_STEPS
    steps at the global batch DP_BATCH on one card, then on DP_RANKS
    ranks through ParallelExecutor: under AMP replicated and ZeRO-2 (the
    main path), served at DP_SERVE_BATCH by a ParallelExecutor sharing
    the trained Scope; in f32 replicated, ZeRO-2 and the per-rank
    batch-norm control against one card in f32. Returns the main path's
    launches (the two-rank AMP steps and the served batch, both
    ranks)."""
    import torch
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.core import amp
    from paddle_tpu_torch.parallel import mesh
    t_phase = time.perf_counter()
    n_cards = torch.cuda.device_count()
    print('smoke: phase 25 backend %s, ranks to devices %s (%d card(s) '
          'shared: rank r on cuda:(r %% 1)); with a card a rank: backend %s,'
          ' %s' % (
              mesh.backend_for(DP_RANKS, 1),
              [str(mesh.device_for_rank(r, 1)) for r in range(DP_RANKS)], 1,
              mesh.backend_for(DP_RANKS, n_cards),
              [str(mesh.device_for_rank(r, n_cards))
               for r in range(DP_RANKS)]), flush=True)
    main, startup, _ = _train_program(seed)
    scope = pt.Scope()
    pt.Executor().run(startup, scope=scope)
    _small_residual_gammas(main, scope)
    init = {n: v.detach().cpu().clone() for n, v in scope.vars.items()
            if isinstance(v, torch.Tensor)}
    del scope
    feed = _image_train_feed(DP_BATCH, seed + 25)
    single = _dp_single(pt, seed, init, feed)
    amp.set_amp(False)
    torch.backends.cudnn.deterministic = True
    single_f32 = _dp_single(pt, seed, init, feed)
    torch.backends.cudnn.deterministic = False
    amp.set_amp(None)
    ms = {'amp': single['ms'], 'f32': single_f32['ms']}
    for tag, r in (('AMP', single), ('f32', single_f32)):
        print('data parallel: one card, batch %d (residual gammas %g), %s, '
              'losses %s, %.1f ms a step (first %.1f); %s' % (
                  DP_BATCH, RESIDUAL_GAMMA, tag, ', '.join(
                      '%.5f' % v for v in r['losses']),
                  np.mean(r['ms'][1:]), r['ms'][0], card), flush=True)
    del feed
    torch.cuda.empty_cache()
    os.makedirs(os.path.join(ROOT, 'build'), exist_ok=True)
    with tempfile.TemporaryDirectory(dir=os.path.join(ROOT, 'build')) as d:
        torch.save(init, os.path.join(d, 'init.pt'))
        torch.save({'amp': single, 'f32': single_f32},
                   os.path.join(d, 'single.pt'))
        del init, single, single_f32
        launches = _dp_report('shared card', _dp_spawn(
            d, os.path.join(d, 'shared'), seed, 1), ms, card)
        if n_cards >= DP_RANKS:
            _dp_report('nccl', _dp_spawn(d, os.path.join(d, 'nccl'), seed,
                                         n_cards), ms, card)
        else:
            print('data parallel: the NCCL pair was not run: %d card' %
                  n_cards, flush=True)
    print('phase 25: %.1f s; %.1f s since the process started; launches %s'
          % (time.perf_counter() - t_phase, time.perf_counter() - _STARTED,
             launches), flush=True)
    return launches


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


# the tf32 and mma_sync kernels' sweep: (N, H, W, Cin, Cout, K, stride,
# pad) of mnist's, recognize_digits', ResNet-32's and VGG-16's regions at
# their batches
SWEEP_MMA_SHAPES = (
    (32, 28, 28, 1, 20, 5, 1, 0), (64, 28, 28, 1, 20, 5, 1, 0),
    (1, 28, 28, 1, 20, 5, 1, 0), (32, 12, 12, 20, 50, 5, 1, 0),
    (64, 12, 12, 20, 50, 5, 1, 0), (1, 12, 12, 20, 50, 5, 1, 0),
    (128, 32, 32, 3, 16, 3, 1, 1), (128, 32, 32, 16, 16, 3, 1, 1),
    (32, 32, 32, 16, 16, 3, 1, 1), (1, 32, 32, 16, 16, 3, 1, 1),
    (128, 32, 32, 16, 32, 3, 2, 1), (128, 16, 16, 32, 32, 3, 1, 1),
    (32, 16, 16, 32, 32, 3, 1, 1), (1, 16, 16, 32, 32, 3, 1, 1),
    (128, 16, 16, 32, 64, 3, 2, 1), (128, 8, 8, 64, 64, 3, 1, 1),
    (32, 8, 8, 64, 64, 3, 1, 1), (1, 8, 8, 64, 64, 3, 1, 1),
    (32, 32, 32, 64, 64, 3, 1, 1), (32, 16, 16, 128, 128, 3, 1, 1),
    (32, 8, 8, 256, 256, 3, 1, 1), (32, 4, 4, 512, 512, 3, 1, 1),
    (32, 2, 2, 512, 512, 3, 1, 1))


def sweep_mma_plans(card):
    """The tf32 and mma_sync kernels' time at every count of warps that
    share K (1, 2, 4) at SWEEP_MMA_SHAPES in f32 and bf16 (the folded
    batch norm and relu), beside the plan's pick and cuDNN's conv: the
    data behind cuda_kernels.fused_conv_plan's rule for these routes.
    Not part of the smoke run (``--sweep-mma``)."""
    import torch
    import torch.nn.functional as F
    from paddle_tpu_torch.ops import cuda_kernels as ck
    stages = (('affine', 0, 1), ('act', 'relu'))
    sms = ck._sm_count(0)
    print('sweep: %s, %d SMs; ms per call (CUDA graph replays)' % (card, sms),
          flush=True)
    for dtype in (torch.float32, torch.bfloat16):
        for (n, H, W, cin, cout, k, s, p) in SWEEP_MMA_SHAPES:
            pick = ck.fused_conv_plan(dtype, n, H, W, cin, cout, k, k,
                                      (s, s), (p, p), False, sms)
            if pick.variant not in ('tf32', 'mma_sync'):
                continue
            x = torch.randn(n, H, W, cin, device='cuda').to(dtype)
            w = (torch.randn(cout, k, k, cin, device='cuda') *
                 (2.0 / (k * k * cin)) ** 0.5).to(dtype)
            aux = [torch.rand(1, cout, device='cuda') + 0.5,
                   torch.randn(1, cout, device='cuda')]
            args = (x, w, aux, ('c', 'c'), stages, (s, s), (p, p), False)
            times = {}
            for splits in (1, 2, 4):
                plan = pick._replace(splits=splits)
                times[splits] = graph_ms(
                    lambda: ck._fused_conv_launch(*args, plan=plan))
            xc, wc = x.permute(0, 3, 1, 2), w.permute(0, 3, 1, 2)
            library_ms = graph_ms(lambda: F.conv2d(xc, wc, stride=s,
                                                   padding=p))
            print('sweep %s N=%d %dx%d Cin=%d Cout=%d K=%d s=%d: plan %s, '
                  'splits 1 / 2 / 4 %.4f / %.4f / %.4f, cudnn %.4f' % (
                      str(dtype)[6:], n, H, W, cin, cout, k, s,
                      _plan_label(pick), times[1], times[2], times[4],
                      library_ms), flush=True)
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


def crnn_switches(card, seed):
    """``--crnn-switches``: 24b's card-against-CPU step at CRNN_CPU_BATCH
    again, with each max pool's and ReLU's input fetched from both: the
    2x2 windows whose chosen element differs (and the CPU's gap between
    their two largest), the ReLU inputs whose sign differs, and the
    gradients that part by more than 1e-4."""
    import torch
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.core import amp
    main, startup, _, fetch, ev = crnn_program(pt, seed)
    block = main.global_block()
    pools = [op.input('X')[0] for op in block.ops if op.type == 'pool2d']
    relus = [op.input('X')[0] for op in block.ops if op.type == 'relu']
    grads = [p.name + '@GRAD' for p in block.all_parameters() if p.trainable]
    exe = pt.Executor()
    scope = pt.Scope()
    exe.run(startup, scope=scope)         # the card's startup, as in 24b
    state = {n: v.cpu().numpy() for n, v in scope.vars.items()
             if isinstance(v, torch.Tensor)}
    images, labels, lens = crnn_batch(np.random.RandomState(seed + 244),
                                      CRNN_CPU_BATCH, CRNN['height'],
                                      CRNN['width'], CRNN['classes'],
                                      CRNN_LABELS)
    feed = {'pixel': images, 'label': pt.create_lod_tensor(labels, [lens])}
    res = []
    amp.set_amp(False)
    try:
        for place in (pt.CUDAPlace(0), pt.CPUPlace()):
            s = pt.Scope()
            for n, v in state.items():
                s.set_var(n, v)
            with pt.scope_guard(s):
                ev.reset(exe)
            res.append([np.asarray(v) for v in pt.Executor(place).run(
                main, feed=feed, fetch_list=pools + relus + grads,
                scope=s)])
    finally:
        amp.set_amp(None)

    def windows(x):
        n, c, h, w = x.shape
        return x.reshape(n, c, h // 2, 2, w // 2, 2).transpose(
            0, 1, 2, 4, 3, 5).reshape(n, c, h // 2, w // 2, 4)
    for i, name in enumerate(pools):
        a, b = windows(res[0][i]), windows(res[1][i])
        moved = a.argmax(-1) != b.argmax(-1)
        top2 = np.sort(b, -1)
        gaps = (top2[..., -1] - top2[..., -2])[moved]
        print('crnn-switches: max pool %d (%s, input %s): %d of %d windows '
              'chose another element, the CPU\'s gap between their two '
              'largest at most %.3g; %s' % (
                  i, name, res[1][i].shape, int(moved.sum()), moved.size,
                  float(gaps.max()) if moved.any() else 0.0, card),
              flush=True)
    for j, name in enumerate(relus):
        a, b = res[0][len(pools) + j], res[1][len(pools) + j]
        print('crnn-switches: relu %d (%s): %d inputs of another sign'
              % (j, name, int((np.sign(a) != np.sign(b)).sum())), flush=True)
    off = len(pools) + len(relus)
    for k, name in enumerate(grads):
        a, b = res[0][off + k], res[1][off + k]
        err = float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))
        if err > 1e-4:
            print('crnn-switches: %s parts by %.3g' % (name, err), flush=True)


def conv3d_grads(card, seed):
    """Where 21a's widest f32 readings come from: the wide conv3d
    group's fetches, card against CPU, the card's twice (cuDNN
    deterministic off, then on); the two filter gradients of its grouped
    convs, the card's and the CPU's each against an f64 reference made
    on the CPU from the same parameters; and the TF32-on backward
    control of 21a beside the same call with TF32 off."""
    import torch
    import torch.nn.functional as F
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.core import amp
    amp.set_amp(False)
    torch.backends.cudnn.allow_tf32 = True      # as 21a
    main, startup, feed, exact, near, fixed = _ops21_program('conv3d', True,
                                                            seed)
    state = _startup_state(startup)
    names = exact + near
    card1 = _ops21_run(pt.CUDAPlace(0), main, startup, feed, names, state)
    torch.backends.cudnn.deterministic = True
    card2 = _ops21_run(pt.CUDAPlace(0), main, startup, feed, names, state)
    torch.backends.cudnn.deterministic = False
    cpu = _ops21_run(pt.CPUPlace(), main, startup, feed, names, state)
    for n in names:
        print('conv3d-grads: %s %s: card %.3g, card (deterministic) %.3g, '
              'card against card %.3g; max |CPU| %.4g' % (
                  n, tuple(np.shape(cpu[n])),
                  _ops21_reading(card1[n], cpu[n], False),
                  _ops21_reading(card2[n], cpu[n], False),
                  _ops21_reading(card1[n], card2[n], False),
                  np.abs(np.asarray(cpu[n])).max()), flush=True)
    # the loss's terms of each filter: mean(out^2) of 21a's grouped conv3d
    # (filter gf) and conv3d_transpose (filter gt) of the parameter w
    w = torch.from_numpy(np.asarray(state['w'], np.float64))
    for name, conv in (
            ('gf', lambda x, k: F.conv3d(x, k, stride=(1, 2, 1),
                                         padding=(1, 0, 1), groups=2)),
            ('gt', lambda x, k: F.conv_transpose3d(
                x, k, stride=(2, 1, 2), padding=(1, 0, 0), groups=2))):
        k = torch.from_numpy(np.asarray(state[name], np.float64)
                             ).requires_grad_()
        out = conv(w, k)
        (out * out).mean().backward()
        ref, g = k.grad.numpy(), name + '@GRAD'
        print('conv3d-grads: %s against f64: card %.3g, CPU f32 %.3g; card '
              'against CPU %.3g' % (
                  g, _ops21_reading(card1[g], ref, False),
                  _ops21_reading(cpu[g], ref, False),
                  _ops21_reading(card1[g], cpu[g], False)), flush=True)
    rng = np.random.RandomState(seed)
    xg = rng.randn(8, 64, 16, 56, 56).astype('float32')
    fg = rng.randn(64, 32, 3, 3, 3).astype('float32')
    gout = rng.randn(8, 64, 16, 27, 56).astype('float32')

    def grads(dev, tf32):
        torch.backends.cudnn.allow_tf32 = tf32
        a = torch.from_numpy(xg).to(dev).requires_grad_()
        b = torch.from_numpy(fg).to(dev).requires_grad_()
        F.conv3d(a, b, stride=(1, 2, 1), padding=(1, 0, 1),
                 groups=2).backward(torch.from_numpy(gout).to(dev))
        return [t.grad.cpu().numpy() for t in (a, b)]
    ref = grads('cpu', False)
    for tf32 in (True, False):
        got = grads('cuda', tf32)
        print('conv3d-grads: the control with TF32 %s: input gradient %.3g, '
              'filter gradient %.3g' % (
                  'on' if tf32 else 'off',
                  _ops21_reading(got[0], ref[0], False),
                  _ops21_reading(got[1], ref[1], False)), flush=True)
    torch.backends.cudnn.allow_tf32 = False
    amp.set_amp(None)
    print('conv3d-grads: %s; %d CPU threads' % (card, torch.get_num_threads()),
          flush=True)


_LAPS = [_STARTED]


def _lap(name):
    """Prints the seconds the phase just run took."""
    now = time.perf_counter()
    print('smoke: phase_%s %.1f s; %.1f s since the process started' % (
        name, now - _LAPS[0], now - _STARTED), flush=True)
    _LAPS[0] = now


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument('--seed', type=int, default=0)
    ap.add_argument('--sweep-conv', action='store_true',
                    help='time the wgmma conv at every tile width and K '
                    'split at the ResNet-50 shapes, then stop')
    ap.add_argument('--sweep-mma', action='store_true',
                    help='time the tf32 and mma_sync convs at every count '
                    'of warps that share K at the books\' shapes, then '
                    'stop')
    ap.add_argument('--host-cost', action='store_true',
                    help="time the fused conv and LSTM cell wrappers' host "
                    'cost, served ResNet-50 requests at batch 1 and 8 and '
                    'stacked_dynamic_lstm forward requests, then stop')
    ap.add_argument('--fetch-cost', action='store_true',
                    help="time the flagship's logits copy to the host and "
                    'its served request on the main thread and on a '
                    'second one, then stop')
    ap.add_argument('--crnn-switches', action='store_true',
                    help="count the max pool windows and ReLUs whose choice "
                    "differs between 24b's card and CPU steps, then stop")
    ap.add_argument('--conv3d-grads', action='store_true',
                    help="read 21a's wide conv3d gradients against an f64 "
                    'reference and its TF32 control both ways, then stop')
    ap.add_argument('--root', default=ROOT,
                    help='with --host-cost or --fetch-cost: the checkout '
                    'whose package is measured (default: this one)')
    ap.add_argument('--serve-tuned', metavar='CONFIG',
                    help="phase 6c's second process (run by phase 6c)")
    ap.add_argument('--trainer-child', nargs=3,
                    metavar=('MODE', 'CKPT_DIR', 'OUT'),
                    help="phase 19a's second and third processes (run by "
                    'phase 19a)')
    ap.add_argument('--long-remat', type=int, metavar='DEPTH',
                    help="phase 19c's long-context process at one depth "
                    '(run by phase 19c)')
    ap.add_argument('--phase19', action='store_true',
                    help='build the kernels, run phase 19 alone, then stop')
    ap.add_argument('--phase20', action='store_true',
                    help='build the kernels, run phase 20 alone, then stop')
    ap.add_argument('--phase21', action='store_true',
                    help='build the kernels, run phase 21 alone, then stop')
    ap.add_argument('--phase22', action='store_true',
                    help='build the kernels, run phase 22 alone, then stop')
    ap.add_argument('--phase24', action='store_true',
                    help='build the kernels, run phase 24 alone, then stop')
    ap.add_argument('--phase25', action='store_true',
                    help='build the kernels, run phase 25 alone, then stop')
    ap.add_argument('--coldstart-child', nargs=3,
                    metavar=('MODEL_DIR', 'STORE_DIR', 'OUT'),
                    help="phase 24d's replicas (run by phase 24d)")
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
    if args.trainer_child:
        return trainer_child(*args.trainer_child, seed=args.seed)
    if args.long_remat:
        return long_remat_child(args.long_remat, args.seed)
    if args.coldstart_child:
        return coldstart_child(*args.coldstart_child)
    phase_build()
    _lap('build')
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
    if args.sweep_mma:
        sweep_mma_plans(card)
        return 0
    if args.host_cost:
        host_cost_lstm(card, root, args.seed)
        host_cost(card, root, args.seed)
        return 0
    if args.fetch_cost:
        fetch_cost(card, root, args.seed)
        return 0
    if args.phase19:
        phase_trainer(args.seed, card)
        return 0
    if args.phase20:
        os.makedirs(os.path.join(ROOT, 'build'), exist_ok=True)
        phase_readers(args.seed, card)
        return 0
    if args.phase21:
        os.makedirs(os.path.join(ROOT, 'build'), exist_ok=True)
        phase_public_api(args.seed, card)
        return 0
    if args.phase22:
        phase_mobilenet(args.seed, card)
        return 0
    if args.phase24:
        phase_detection_ctc(args.seed, card)
        return 0
    if args.phase25:
        phase_data_parallel(args.seed, card)
        return 0
    if args.crnn_switches:
        crnn_switches(card, args.seed)
        return 0
    if args.conv3d_grads:
        conv3d_grads(card, args.seed)
        return 0
    phase_sass()
    _lap('sass')
    kres = phase_kernels(args.seed)
    _lap('kernels')
    bres = phase_bwd_kernels(args.seed)
    _lap('bwd_kernels')
    conv = phase_conv_kernels(args.seed)
    _lap('conv_kernels')
    os.makedirs(os.path.join(ROOT, 'build'), exist_ok=True)
    with tempfile.TemporaryDirectory(dir=os.path.join(ROOT, 'build')) as d:
        artifacts = {'dir': d}
        launches = phase_serving(args.seed, artifacts)
        _lap('serving')
        resnet_launches = phase_resnet_serving(args.seed, artifacts)
        _lap('resnet_serving')
        runtime_launches = phase_serving_runtime(args.seed, card, artifacts)
        _lap('serving_runtime')
        tuned_launches = phase_autotuned_serving(args.seed, card, artifacts)
        _lap('autotuned_serving')
        fleet_launches = phase_fleet(args.seed, card, artifacts)
        _lap('fleet')
    torch.cuda.empty_cache()
    trained = phase_training(args.seed, card)
    _lap('training')
    phase_gradients(args.seed, trained)
    _lap('gradients')
    # keep the counts, let the flagship's scope go
    trained = {k: trained[k] for k in ('launches', 'route_launches', 'ms')}
    torch.cuda.empty_cache()
    long_trained = phase_long_training(args.seed, card)
    _lap('long_training')
    torch.cuda.empty_cache()
    r_main, r_startup, r_loss = _train_program(args.seed)
    stats = phase_stats_kernels(args.seed, r_main, r_loss)
    _lap('stats_kernels')
    resnet_trained = phase_resnet_training(args.seed, card, r_main,
                                           r_startup, r_loss)
    _lap('resnet_training')
    phase_resnet_gradients(args.seed, r_main, r_startup, r_loss)
    _lap('resnet_gradients')
    phase_se_resnext_training(args.seed, card)
    _lap('se_resnext_training')
    del r_main, r_startup, r_loss
    torch.cuda.empty_cache()
    phase_analysis(args.seed)
    _lap('analysis')
    with tempfile.TemporaryDirectory(dir=os.path.join(ROOT, 'build')) as d:
        bench = {name: phase_bench_model(name, args.seed, card, d)
                 for name in ('mnist', 'vgg')}
        _lap('bench_model')
    with tempfile.TemporaryDirectory(dir=os.path.join(ROOT, 'build')) as d:
        book_launches, book_totals = phase_books(args.seed, card, d)
        _lap('books')
    lstm = phase_lstm_kernels(args.seed)
    _lap('lstm_kernels')
    lstm_trained = phase_lstm_training(args.seed, card)
    _lap('lstm_training')
    phase_lstm_serving(args.seed, lstm_trained, card)
    _lap('lstm_serving')
    lstm_launches = lstm_trained['launches']
    del lstm_trained
    phase_lstm_gradients(args.seed)
    _lap('lstm_gradients')
    phase_machine_translation(args.seed, card)
    _lap('machine_translation')
    with tempfile.TemporaryDirectory(dir=os.path.join(ROOT, 'build')) as d:
        phase_control_flow(args.seed, card, d)
        _lap('control_flow')
    with tempfile.TemporaryDirectory(dir=os.path.join(ROOT, 'build')) as d:
        phase_decode(args.seed, card, d)
        _lap('decode')
    with tempfile.TemporaryDirectory(dir=os.path.join(ROOT, 'build')) as d:
        front = phase_front_end(args.seed, card, d, trained['ms'])
        _lap('front_end')
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(dir=os.path.join(ROOT, 'build')) as d:
        sparse = phase_sparse_and_books(args.seed, card, d)
        _lap('sparse_and_books')
    torch.cuda.empty_cache()
    trainer = phase_trainer(args.seed, card)
    _lap('trainer')
    readers = phase_readers(args.seed, card)
    _lap('readers')
    public = phase_public_api(args.seed, card)
    _lap('public_api')
    dw_sums, mobilenet = phase_mobilenet(args.seed, card)
    _lap('mobilenet')
    detection, ssd_totals = phase_detection_ctc(args.seed, card)
    _lap('detection_ctc')
    torch.cuda.empty_cache()
    dp = phase_data_parallel(args.seed, card)
    _lap('data_parallel')
    # launches: each kernel's count over the path that drives it, read
    # right after that path ran from counts set to 0 (the flash forward:
    # the served requests, the serving runtime's concurrent mix, untuned
    # and tuned, the fleet's mix (15a), and the timed training steps at
    # both lengths; the merged
    # backward: the timed training steps; the two-pass backward: the timed
    # long-context steps, its numbers at their shape, the training
    # shape's beside them; the fused conv: the served ResNet requests,
    # the serving runtime's concurrent mix, untuned and tuned, and the
    # fleet's mix; each also over phase 16's steps: the flagship's under
    # noam_decay, mnist's under each optimizer, ResNet-50's under
    # piecewise_decay; over phase 17's main paths: the flagship's
    # and mnist's input gradients, the sparse LSTM's steps; and over phase
    # 19's: the Trainer's recognize_digits steps (19a, 19b) and its
    # Inferencer, vgg_bn_drop's stats-form steps and the flagship's, each
    # with and without memory_optimize, and the long context's under it
    # (19c), mnist's AMP steps (19d), the transpiled ResNet-50's requests
    # (19e); and over phase 20's: ResNet-50's reader-fed steps (20a),
    # stacked_dynamic_lstm's (20b), ResNet-50's profiled requests (20c);
    # and over phase 21's: book 02's steps through the paddle alias in a
    # child process and in this one (21c); and over phase 22's:
    # MobileNet-v1's served requests and training steps (22b); and over
    # phase 24's: MobileNet-SSD's training steps (f32 and AMP) and served
    # requests (24a), CRNN-CTC's training steps (24b); and over phase
    # 25's: ResNet-50's steps on two ranks, replicated and ZeRO-2, and
    # its batch served on two ranks, both ranks' launches)
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
        long_trained['launches']['flash_attn_fwd'] +
        front['flash_attn_fwd'] + sparse['flash_attn_fwd'] +
        trainer['flash_attn_fwd'], **main_shape)]
    kernels.append(dict(
        name='flash_attn_bwd_dkvdq', route='cuda', source=bwd_src,
        replaces='paddle_tpu/ops/pallas_kernels.py:310',
        launches=trained['launches']['flash_attn_bwd_dkvdq'] +
        front['flash_attn_bwd_dkvdq'] + sparse['flash_attn_bwd_dkvdq'] +
        trainer['flash_attn_bwd_dkvdq'],
        **train_shape['flash_attn_bwd_dkvdq']))
    for name, line in (('flash_attn_bwd_dq', 245),
                       ('flash_attn_bwd_dkv', 273)):
        kernels.append(dict(
            name=name, route='cuda', source=bwd_src,
            replaces='paddle_tpu/ops/pallas_kernels.py:%d' % line,
            launches=long_trained['launches'][name] + trainer[name],
            training_shape=train_shape[name], **long_shape[name]))
    # the fused conv: its numbers summed over one batch-32 request's 53
    # regions (bf16, as the served model runs them); launches also over
    # mnist's timed training steps and both models' served batches, and
    # over recognize_digits' training steps and both conv books' served
    # batches (13b); their regions' sums beside
    def bench_totals(form):
        return {'%s %s' % (name, key.split(' ', 1)[1]): t
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
        book_launches['fused_conv'] + front['fused_conv'] +
        sparse['fused_conv'] + trainer['fused_conv'] +
        readers['fused_conv'] + public['fused_conv'] +
        mobilenet['fused_conv'] + detection['fused_conv'] +
        dp['fused_conv'],
        bench_regions=bench_totals('fused_conv'),
        book_regions=book_regions('fused_conv'),
        ssd_head_regions=ssd_totals, **conv))
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
        book_launches['fused_conv_stats'] + front['fused_conv_stats'] +
        trainer.get('fused_conv_stats', 0) + readers['fused_conv_stats'] +
        mobilenet['fused_conv_stats'] + detection['fused_conv_stats'] +
        dp['fused_conv_stats'],
        bench_regions=bench_totals('fused_conv_stats'),
        book_regions=book_regions('fused_conv_stats'), **stats))
    # the fused conv's depthwise kernel, both forms: launches over
    # MobileNet-v1's and MobileNet-SSD's served requests (inference form)
    # and training steps (stats form, 22b, 24a); numbers summed over its 13 depthwise layers at
    # batch 32 (22a), f32, bf16 beside
    for form, name, key in (('inference', 'fused_conv_depthwise',
                             'depthwise'),
                            ('stats', 'fused_conv_depthwise_stats',
                             'depthwise_stats')):
        f32, bf16 = (dict(dw_sums[form][dt])
                     for dt in ('float32', 'bfloat16'))
        for t in (f32, bf16):
            del t['layers']
        kernels.append(dict(
            name=name, route='cuda',
            source='paddle_tpu_torch/csrc/fused_conv_depthwise.cu',
            replaces='paddle_tpu/ops/pallas_kernels.py:807',
            launches=mobilenet[key] + detection[key], bf16=bf16, **f32))
    # the LSTM cell: launches over the timed training steps of
    # stacked_dynamic_lstm, numbers at its shape (B 256, H 512, f32), and
    # its bf16 path's at the same shape (no main path launches it)
    kernels.append(dict(
        name='lstm_cell', route='cuda',
        source='paddle_tpu_torch/csrc/lstm_cell.cu',
        replaces='paddle_tpu/ops/pallas_kernels.py:633',
        launches=lstm_launches['lstm_cell'] + sparse['lstm_cell'] +
        readers['lstm_cell'],
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
