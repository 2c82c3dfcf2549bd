"""Runtime core: places, the op registry, AMP policy and the lowering
that runs a block on torch tensors."""
from .places import CPUPlace, CUDAPlace  # noqa
from . import registry  # noqa


class EOFException(Exception):
    """Raised when a program reader runs out of data (parity:
    paddle/fluid/framework/reader.h EOF semantics)."""
    pass


def __getattr__(name):
    # reference scripts reach runtime types through ``fluid.core``
    # (fluid.core.Scope()); resolved lazily, since the executor imports
    # this package
    if name == 'Scope':
        from ..executor import Scope
        return Scope
    if name == 'LoDTensor':
        from ..lod import SequenceTensor
        return SequenceTensor
    raise AttributeError(name)
