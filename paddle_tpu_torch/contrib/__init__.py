"""fluid.contrib: the float16 transpiler (half-precision inference)."""
from . import float16_transpiler  # noqa
from .float16_transpiler import Float16Transpiler  # noqa

__all__ = ['float16_transpiler', 'Float16Transpiler']
