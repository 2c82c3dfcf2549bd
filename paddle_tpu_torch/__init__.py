"""paddle_tpu_torch — the port of paddle_tpu to PyTorch and CUDA (NVIDIA
Hopper).

It imports torch and numpy and nothing of paddle_tpu or JAX: the
modules without JAX in them (the IR, layers, helpers) are copied here
under the same names, trimmed to what the port covers, and the runtime
(lowering, Executor, ops, kernels) is rewritten on torch tensors.

Covered so far: serving a model from a saved inference model —
``io.load_inference_model`` then ``Executor.run`` — and training one —
``optimizer.Adam(...).minimize(loss)`` (or SGD, Momentum, Adagrad) then
one ``Executor.run`` per step — for the flagship transformer's op set, with
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
the reader decorators (``reader``, ``batch``) and the books' datasets
(``dataset``: uci_housing, mnist, cifar, imikolov, wmt14, on files
already in place or their deterministic synthetic fallbacks); ``fluid``
is the fluid-compatible namespace.

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

Entry points run on the card unless told otherwise: ``Executor()``,
``serving.ModelServer()``, ``Inferencer(...)``, ``fleet.DecodeEngine``,
``kvcache.PrefillEngine`` and ``kvcache.make_paged_engine`` mean
``CUDAPlace(0)`` and raise where CUDA is absent; pass ``CPUPlace()`` to
run on the CPU.
"""
from . import framework, unique_name, initializer, param_attr  # noqa
from . import layers, ops, io, executor  # noqa
from . import backward, clip, optimizer, regularizer, compiler  # noqa
from .framework import (Program, Block, Variable, Operator, Parameter,  # noqa
                        default_startup_program, default_main_program,
                        program_guard, switch_startup_program,
                        switch_main_program, get_var)
from .core.places import CPUPlace, CUDAPlace  # noqa
from .executor import (Executor, Scope, global_scope, scope_guard,  # noqa
                       switch_scope)
from .param_attr import ParamAttr  # noqa
from .lod import (SequenceTensor, create_lod_tensor,  # noqa
                  create_random_int_lodtensor)
from .backward import append_backward  # noqa
from . import analysis, nets, resilience, serving  # noqa
from . import fleet, kvcache  # noqa
from .inferencer import Inferencer  # noqa
from .data_feeder import DataFeeder  # noqa
from . import reader, dataset  # noqa
from .reader import batch  # noqa

# the reference's LoDTensor; SequenceTensor carries its imperative
# surface (set, set_lod, lod), as in paddle_tpu
LoDTensor = SequenceTensor
