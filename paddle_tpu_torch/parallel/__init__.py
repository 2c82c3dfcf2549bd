"""``paddle_tpu_torch.parallel``: counterpart of paddle_tpu/parallel,
trimmed to the program transpilers that run in one process
(``transpiler``: ``memory_optimize``, ``release_memory``,
``InferenceTranspiler``). The ParallelExecutor and the
DistributeTranspiler are ROADMAP Queue A item 6."""
from .transpiler import (InferenceTranspiler, memory_optimize,  # noqa
                         release_memory)

__all__ = ['InferenceTranspiler', 'memory_optimize', 'release_memory']
