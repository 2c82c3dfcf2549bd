"""``paddle_tpu_torch.fluid``: the fluid-compatible namespace.

Counterpart of paddle_tpu/fluid.py, trimmed to what the port has.
Reference scripts do ``import paddle.fluid as fluid``; with the port:
``import paddle_tpu_torch.fluid as fluid``.
"""
# An empty __path__ makes this module package-like, as paddle_tpu's
# facade: ``import paddle.fluid.layers`` under the port's ``paddle``
# alias (paddle_alias.py) gets past the parent-__path__ check
__path__ = []
from . import (framework, layers, initializer, regularizer, clip,  # noqa
               optimizer, backward, unique_name, io, nets, param_attr,
               executor, compiler, resilience, serving, analysis, average,
               evaluator, metrics, profiler, core)
from .framework import (Program, Block, Variable, Operator,  # noqa
                        default_startup_program, default_main_program,
                        program_guard, switch_startup_program,
                        switch_main_program, get_var)
from .core.places import CPUPlace, CUDAPlace, CUDAPinnedPlace  # noqa
from .executor import (Executor, Scope, VarBinding,  # noqa
                       global_scope, scope_guard, switch_scope, fetch_var)
from .backward import append_backward, calc_gradient, gradients  # noqa
from .param_attr import ParamAttr, WeightNormParamAttr  # noqa
from .initializer import init_on_cpu  # noqa
from .data_feeder import DataFeeder  # noqa
from .lod import (SequenceTensor, create_lod_tensor,  # noqa
                  create_random_int_lodtensor)
from .clip import (ErrorClipByValue, GradientClipByValue,  # noqa
                   GradientClipByNorm, GradientClipByGlobalNorm)
from .inferencer import Inferencer  # noqa
from .serving import ModelServer  # noqa
from . import transpiler, contrib, debugger, graphviz, net_drawer  # noqa
from . import concurrency  # noqa
from . import debugger as debuger  # noqa
from .parallel.transpiler import (InferenceTranspiler,  # noqa
                                  memory_optimize, release_memory)
from .parallel.parallel_executor import (ParallelExecutor,  # noqa
                                         ExecutionStrategy, BuildStrategy)
from .trainer import (Trainer, BeginEpochEvent, EndEpochEvent,  # noqa
                      BeginStepEvent, EndStepEvent, CheckpointConfig)
from .resilience import AnomalyGuard, AnomalyError  # noqa
from .debugging import (check_nan_inf, nan_guard,  # noqa
                        nan_checks_enabled, NanInfError)
from . import memory  # noqa
from .memory import (memory_stats, memory_allocated,  # noqa
                     max_memory_allocated, HostArena)
from . import recordio_writer  # noqa
from .recordio_writer import (convert_reader_to_recordio_file,  # noqa
                              convert_reader_to_recordio_files)
LoDTensor = SequenceTensor
Tensor = SequenceTensor
