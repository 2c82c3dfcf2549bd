"""Op kernels. Importing this package registers every kernel of the
slice. Counterpart of paddle_tpu/ops/__init__.py."""
from . import tensor_ops, math_ops, nn_ops, misc_ops, optim_ops  # noqa
from . import cuda_kernels, sequence_ops, rnn_ops  # noqa
from . import control_flow_ops, search_ops, crf_ops  # noqa
from . import detection_ops, ctc_ops  # noqa
from . import collective_ops, zero_ops  # noqa
