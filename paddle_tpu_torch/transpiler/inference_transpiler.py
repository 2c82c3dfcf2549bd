"""Parity: python/paddle/fluid/transpiler/inference_transpiler.py, routed
through the compiler's ``bn_fold`` pass with the same in-place
transpile(program, place, scope) signature."""
from ..parallel.transpiler import InferenceTranspiler  # noqa

__all__ = ['InferenceTranspiler']
