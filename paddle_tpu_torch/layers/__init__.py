"""Layers API. Counterpart of paddle_tpu/layers/__init__.py, trimmed to
the serving and training slices and the books."""
from . import ops
from .ops import *  # noqa
from . import nn
from .nn import *  # noqa
from . import io
from .io import *  # noqa
from . import tensor
from .tensor import *  # noqa
from . import control_flow
from .control_flow import *  # noqa
from . import metric
from .metric import *  # noqa
from . import math_op_patch  # noqa

__all__ = (ops.__all__ + nn.__all__ + io.__all__ + tensor.__all__ +
           control_flow.__all__ + metric.__all__)
