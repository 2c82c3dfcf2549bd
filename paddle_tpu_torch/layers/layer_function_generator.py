"""Layer-function generation utilities.

Counterpart of paddle_tpu/layers/layer_function_generator.py (parity:
python/paddle/fluid/layers/layer_function_generator.py). The reference
generates layer functions from C++ OpProto metadata; here there is no
proto registry, so ``generate_layer_fn`` builds the same thin one-op
wrapper from the kernel registry's name (the machinery ``layers/ops.py``
uses for its generated surface).
"""
import functools
import warnings

from .ops import _gen_layer

__all__ = ['deprecated', 'generate_layer_fn', 'autodoc']


def deprecated(func_or_class):
    """Mark an API deprecated; warns on each use.
    Parity: layer_function_generator.py::deprecated."""

    @functools.wraps(func_or_class)
    def func_wrapper(*args, **kwargs):
        warnings.warn("%s is deprecated and will be removed in a later "
                      "release" % func_or_class.__name__,
                      DeprecationWarning, stacklevel=2)
        return func_or_class(*args, **kwargs)

    return func_wrapper


def generate_layer_fn(op_type):
    """A layer function appending one op of ``op_type``.
    Parity: layer_function_generator.py::generate_layer_fn (OpProto
    introspection replaced by the kernel registry's slot conventions)."""
    from ..core.registry import has_kernel
    if not has_kernel(op_type):
        raise ValueError("no registered kernel for op %r" % op_type)
    return _gen_layer(op_type)


def autodoc(comment=""):
    """Append the generated-layer docstring note to a function.
    Parity: layer_function_generator.py::autodoc."""

    def __impl__(func):
        func.__doc__ = ((func.__doc__ or "") +
                        "\n(Generated layer wrapper for op %r.%s)"
                        % (func.__name__, (" " + comment) if comment
                           else ""))
        return func

    return __impl__
