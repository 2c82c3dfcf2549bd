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
from . import learning_rate_scheduler
from .learning_rate_scheduler import *  # noqa
from . import device
from .device import *  # noqa
from . import detection
from .detection import *  # noqa
from . import math_op_patch  # noqa
from .math_op_patch import monkey_patch_variable  # noqa
from . import layer_function_generator
from .layer_function_generator import (deprecated, generate_layer_fn,  # noqa
                                       autodoc)

__all__ = (ops.__all__ + nn.__all__ + io.__all__ + tensor.__all__ +
           control_flow.__all__ + device.__all__ + detection.__all__ +
           metric.__all__ +
           learning_rate_scheduler.__all__)
