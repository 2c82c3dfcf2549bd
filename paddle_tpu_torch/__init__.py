"""paddle_tpu_torch — the port of paddle_tpu to PyTorch and CUDA (NVIDIA
Hopper).

It imports torch and numpy and nothing of paddle_tpu or JAX: the
modules without JAX in them (the IR, layers, helpers) are copied here
under the same names, trimmed to what the port covers, and the runtime
(lowering, Executor, ops, kernels) is rewritten on torch tensors.

Covered so far: serving a model from a saved inference model —
``io.load_inference_model`` then ``Executor.run`` — and training one —
``optimizer.Adam(...).minimize(loss)`` (or SGD, Momentum) then one
``Executor.run`` per step — for the flagship transformer's op set, with
attention and its gradient on hand-written CUDA kernels
(``ops/cuda_kernels.py``, ``csrc/flash_attn_fwd.cu``,
``csrc/flash_attn_bwd.cu``); and serving ResNet (``models/resnet.py``),
whose conv + batch-norm + activation + residual regions the compiler's
``conv_epilogue_fuse`` pass turns into ``fused_conv`` ops that run on a
hand-written CUDA kernel (``csrc/fused_conv.cu``).

Entry points run on the card unless told otherwise: ``Executor()`` means
``CUDAPlace(0)`` and raises where CUDA is absent; pass ``CPUPlace()`` to
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
from .backward import append_backward  # noqa
