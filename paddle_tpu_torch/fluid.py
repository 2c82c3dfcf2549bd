"""``paddle_tpu_torch.fluid``: the fluid-compatible namespace.

Counterpart of paddle_tpu/fluid.py, trimmed to what the port has.
Reference scripts do ``import paddle.fluid as fluid``; with the port:
``import paddle_tpu_torch.fluid as fluid``.
"""
from . import (framework, layers, initializer, regularizer, clip,  # noqa
               optimizer, backward, unique_name, io, nets, param_attr,
               executor, compiler, resilience, serving, analysis)
from .framework import (Program, Block, Variable, Operator,  # noqa
                        default_startup_program, default_main_program,
                        program_guard, switch_startup_program,
                        switch_main_program, get_var)
from .core.places import CPUPlace, CUDAPlace  # noqa
from .executor import (Executor, Scope, global_scope, scope_guard,  # noqa
                       switch_scope)
from .backward import append_backward  # noqa
from .param_attr import ParamAttr  # noqa
from .data_feeder import DataFeeder  # noqa
from .lod import (SequenceTensor, create_lod_tensor,  # noqa
                  create_random_int_lodtensor)
from .clip import (ErrorClipByValue, GradientClipByValue,  # noqa
                   GradientClipByNorm, GradientClipByGlobalNorm)
from .inferencer import Inferencer  # noqa
from .serving import ModelServer  # noqa
LoDTensor = SequenceTensor
