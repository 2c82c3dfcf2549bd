"""The transpiler package facade (parity: python/paddle/fluid/
transpiler/); the implementations live in paddle_tpu_torch.parallel.
``distribute_transpiler`` waits for ROADMAP Queue A item 6."""
from ..parallel.transpiler import (InferenceTranspiler,  # noqa
                                   memory_optimize, release_memory)

__all__ = ['InferenceTranspiler', 'memory_optimize', 'release_memory']
