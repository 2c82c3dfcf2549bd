"""Parity: python/paddle/fluid/transpiler/memory_optimization_transpiler.py,
routed through the compiler's ``buffer_reuse`` pass and the
rematerialisation mark (paddle_tpu_torch.parallel.transpiler)."""
from ..parallel.transpiler import memory_optimize, release_memory  # noqa

__all__ = ['memory_optimize', 'release_memory']
