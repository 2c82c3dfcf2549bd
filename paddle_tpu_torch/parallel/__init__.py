"""``paddle_tpu_torch.parallel``: counterpart of paddle_tpu/parallel.

- ``mesh``: the data-parallel group over ``torch.distributed``, one
  process per rank (``init_dp``, ``get_mesh``, the rank-to-device and
  backend rule);
- ``collective``: the collectives over it;
- ``parallel_executor``: ``ParallelExecutor`` (data parallelism and
  ZeRO-2 with the global-batch semantics), ``ExecutionStrategy``,
  ``BuildStrategy``;
- ``transpiler``: the program transpilers that run in one process
  (``memory_optimize``, ``release_memory``, ``InferenceTranspiler``).

The DistributeTranspiler (the pserver path) is ROADMAP Queue A item 6,
with multihost."""
from .mesh import get_mesh, set_mesh, init_dp, shutdown_dp  # noqa
from .parallel_executor import (ParallelExecutor,  # noqa
                                ExecutionStrategy, BuildStrategy)
from .transpiler import (InferenceTranspiler, memory_optimize,  # noqa
                         release_memory)

__all__ = ['get_mesh', 'set_mesh', 'init_dp', 'shutdown_dp',
           'ParallelExecutor', 'ExecutionStrategy', 'BuildStrategy',
           'InferenceTranspiler', 'memory_optimize', 'release_memory']
