"""paddle_tpu_torch — the port of paddle_tpu to PyTorch and CUDA (NVIDIA
Hopper).

It imports torch and numpy and nothing of paddle_tpu or JAX: the
modules without JAX in them (the IR, layers, helpers) are copied here
under the same names, trimmed to what the port covers, and the runtime
(lowering, Executor, ops, kernels) is rewritten on torch tensors.

Covered so far: serving a model from a saved inference model —
``io.load_inference_model`` then ``Executor.run`` — and training one —
``optimizer.Adam(...).minimize(loss)`` (or SGD, Momentum, Adagrad,
Adamax, DecayedAdagrad, Adadelta, RMSProp, Ftrl; a learning rate from
one of ``layers``' schedules; ``ModelAverage``) then one
``Executor.run`` per step — for the flagship transformer's op set, with
attention and its gradient on hand-written CUDA kernels
(``ops/cuda_kernels.py``, ``csrc/flash_attn_fwd.cu``,
``csrc/flash_attn_bwd.cu``); and serving and training ResNet and
SE-ResNeXt (``models/resnet.py``), whose conv + batch-norm + activation +
residual regions the compiler's ``conv_epilogue_fuse`` pass turns into
``fused_conv`` ops that run on a hand-written CUDA kernel
(``csrc/fused_conv.cu``; with a train-mode batch norm, its stats form);
and the sequence path: ``SequenceTensor`` feeds (``create_lod_tensor``),
the sequence ops and the recurrent layers (``dynamic_lstm``,
``dynamic_lstmp``, ``dynamic_gru``, ``gru_unit``, ``lstm_unit``), whose
peephole-free LSTM steps run on a hand-written CUDA kernel
(``csrc/lstm_cell.cu``).

Every ``Executor.run`` goes through the static analysis (``analysis``:
the raw feed checked, the program verified on a memo miss, as in
paddle_tpu), and ``PassPipeline(verify=True)`` runs the compiler's
passes under its sanitizer. The benchmark harness's mnist and VGG-16
(``models/benchmark.py``, ``nets``, ``models/vgg.py``) serve and train
on the fused conv kernel too.

Serving runs through the compiler's pass pipeline (``compiler``: the
default passes on every program the Executor runs, ``bn_fold`` for
inference) and the serving runtime: ``serving.ModelServer`` (saved
models, micro-batching, pow-2 buckets, deadlines, a circuit breaker and
a watchdog) and ``Inferencer``.

The data side of the Fluid books: ``DataFeeder`` (``data_feeder.py``),
the reader decorators (``reader``, ``batch``) and the datasets
(``dataset``: the books' and flowers, wmt16, sentiment, voc2012 and
mq2007, on files already in place or their deterministic synthetic
fallbacks); ``fluid`` is the fluid-compatible namespace. The in-graph
readers (``layers.open_files`` ... ``double_buffer`` ... ``read_file``)
read PTRC recordio files (``reader_io``, ``recordio_writer``, the
reference's layout in ``recordio_compat``) through a native C++ reader
(``native``, built with g++ at first use) into the Executor's feeds,
``double_buffer`` staging each batch on the card ahead of the step. The
``profiler`` (the per-op table, a torch.profiler device trace, the
serving spans), ``memory`` (device memory stats, the pinned
``HostArena``) and ``metrics`` are as in paddle_tpu. Sparse tables
(``embedding(is_sparse=True)``) train by their touched rows under SGD,
Adagrad and Adam; ``calc_gradient`` / ``gradients`` give gradients of
any targets for any inputs, differentiable again; the CRF family
(``linear_chain_crf``, ``crf_decoding``, ``chunk_eval``, the
``evaluator``'s ``ChunkEvaluator``) and ``cos_sim`` carry books 05 and
07.

Control flow (``While``, ``IfElse``, ``Switch``, ``StaticRNN``,
``DynamicRNN``, the tensor arrays) and beam search (static [B*K] and
the reference's dynamic LoD form, whose values are packed
``SequenceTensor`` rows) run on the card: book 08, machine_translation
(``models/books.py``), trains through a DynamicRNN and decodes by beam
search.

The serving tier: ``fleet`` (a ``Router`` over ModelServer replicas, its
supervisor and autoscaler, and the continuous-batching ``DecodeEngine``)
and ``kvcache`` (the paged KV pool, the paged attention cell, prefill
replicas and disaggregated decode), watched through
``observability.telemetry`` (a scrape endpoint, health providers) and
``observability.slo`` (burn rates). ``python -m
paddle_tpu_torch.tools.analyze_program`` runs the static analysis on a
builder file or a saved model.

Training's high-level API and its services: ``Trainer`` (events,
``test``, ``save_params``), atomic checkpoints with auto-resume and
preemption saves (``io.save_checkpoint``, ``resilience``), the
``AnomalyGuard`` policies, prefetch onto the card
(``reader.prefetch``), chained steps and lazy fetches
(``Executor.run_chained``, ``run(async_fetch=True)``),
``memory_optimize`` (checkpointed forward segments), the AMP activation
setting (``core.amp.set_amp_act``), the ``Float16Transpiler``
(``contrib``), the NaN/Inf guard (``check_nan_inf``), and the
``debugger``, ``graphviz``, ``net_drawer`` and ``concurrency`` helpers.

Entry points run on the card unless told otherwise: ``Executor()``,
``serving.ModelServer()``, ``Inferencer(...)``, ``fleet.DecodeEngine``,
``kvcache.PrefillEngine``, ``kvcache.make_paged_engine`` and
``Trainer(...)`` mean
``CUDAPlace(0)`` and raise where CUDA is absent; pass ``CPUPlace()`` to
run on the CPU.
"""
from . import framework, unique_name, initializer, param_attr  # noqa
from . import layers, ops, io, executor  # noqa
from . import backward, clip, optimizer, regularizer, compiler  # noqa
from . import average  # noqa
from .framework import (Program, Block, Variable, Operator, Parameter,  # noqa
                        default_startup_program, default_main_program,
                        program_guard, switch_startup_program,
                        switch_main_program, get_var)
from .core.places import CPUPlace, CUDAPlace, CUDAPinnedPlace  # noqa
from .executor import (Executor, Scope, VarBinding,  # noqa
                       global_scope, scope_guard, switch_scope, fetch_var)
from .param_attr import ParamAttr, WeightNormParamAttr  # noqa
from .lod import (SequenceTensor, create_lod_tensor,  # noqa
                  create_random_int_lodtensor)
from .backward import append_backward, calc_gradient, gradients  # noqa
from . import analysis, nets, resilience, serving  # noqa
from . import fleet, kvcache  # noqa
from .inferencer import Inferencer  # noqa
from .data_feeder import DataFeeder  # noqa
from . import reader, dataset, evaluator, metrics, profiler  # noqa
from . import memory, recordio_writer, reader_io, native, v2  # noqa
from .reader import batch  # noqa
from . import transpiler, contrib, debugger, concurrency  # noqa
from .trainer import (Trainer, BeginEpochEvent, EndEpochEvent,  # noqa
                      BeginStepEvent, EndStepEvent, CheckpointConfig)
from .parallel.transpiler import (InferenceTranspiler,  # noqa
                                  memory_optimize, release_memory)
from .parallel.parallel_executor import (ParallelExecutor,  # noqa
                                         ExecutionStrategy, BuildStrategy)
from .debugging import check_nan_inf, nan_guard, nan_checks_enabled  # noqa

# the reference's LoDTensor; SequenceTensor carries its imperative
# surface (set, set_lod, lod), as in paddle_tpu
LoDTensor = SequenceTensor
# a loose alias for scripts that touch fluid.Tensor, as in paddle_tpu
Tensor = SequenceTensor
