"""Op kernels. Importing this package registers every kernel of the
slice. Counterpart of paddle_tpu/ops/__init__.py."""
from . import tensor_ops, math_ops, nn_ops, misc_ops, optim_ops  # noqa
from . import cuda_kernels  # noqa
