"""Elementwise math shared by the op kernels and the fused-conv epilogue.

Counterpart of the epilogue vocabulary of paddle_tpu/ops/pallas_kernels.py
(``_EPI_ACTS``, ``_EPI_ACTS_P``, ``_EPI_BIN``) and of the matching op
kernels of paddle_tpu/ops/math_ops.py, which compute the same functions.
Here one table serves both: ``math_ops`` registers an op kernel for each
entry, and the plain fused conv (``cuda_kernels.fused_conv_reference``)
applies the same functions as epilogue stages, so the two cannot
diverge. ``csrc/fused_conv.cu`` numbers the entries in this order.
"""
import torch

# activation name -> fn(x)
ACTS = {
    'sigmoid': torch.sigmoid,
    'logsigmoid': torch.nn.functional.logsigmoid,
    'exp': torch.exp,
    'relu': torch.relu,
    'tanh': torch.tanh,
    'tanh_shrink': lambda x: x - torch.tanh(x),
    'sqrt': torch.sqrt,
    'abs': torch.abs,
    'square': torch.square,
    'ceil': torch.ceil,
    'floor': torch.floor,
    'round': torch.round,
    'reciprocal': lambda x: 1.0 / x,
    'log': torch.log,
    'softplus': lambda x: torch.logaddexp(x, torch.zeros_like(x)),
    'softsign': lambda x: x / (torch.abs(x) + 1.0),
}

# parametric activation name -> fn(x, *params)
ACTS_P = {
    'brelu': lambda x, t_min, t_max: torch.clamp(x, t_min, t_max),
    'leaky_relu': lambda x, alpha: torch.where(x >= 0, x, alpha * x),
    'elu': lambda x, alpha: torch.where(x > 0, x, alpha * torch.expm1(x)),
    'relu6': lambda x, t: torch.clamp(x, 0.0, t),
    'soft_relu': lambda x, t: torch.log1p(torch.exp(torch.clamp(x, -t, t))),
    'hard_shrink': lambda x, t: torch.where(torch.abs(x) > t, x,
                                            torch.zeros_like(x)),
    'softshrink': lambda x, lam: torch.where(
        x > lam, x - lam, torch.where(x < -lam, x + lam,
                                      torch.zeros_like(x))),
    'pow': lambda x, f: torch.pow(x, f),
    'stanh': lambda x, a, b: b * torch.tanh(a * x),
    'thresholded_relu': lambda x, t: torch.where(x > t, x,
                                                 torch.zeros_like(x)),
    'hard_sigmoid': lambda x, s, o: torch.clamp(s * x + o, 0.0, 1.0),
    'swish': lambda x, beta: x * torch.sigmoid(beta * x),
    'clip': lambda x, lo, hi: torch.clamp(x, lo, hi),
}

# parametric activation -> ((attr, default), ...): the op's attrs in the
# order ACTS_P takes them (paddle_tpu/compiler/passes.py::_EPI_PARAM_ACTS)
PARAM_ATTRS = {
    'brelu': (('t_min', 0.0), ('t_max', 24.0)),
    'leaky_relu': (('alpha', 0.02),),
    'soft_relu': (('threshold', 40.0),),
    'elu': (('alpha', 1.0),),
    'relu6': (('threshold', 6.0),),
    'pow': (('factor', 1.0),),
    'stanh': (('scale_a', 2.0 / 3.0), ('scale_b', 1.7159)),
    'hard_shrink': (('threshold', 0.5),),
    'softshrink': (('lambda', 0.5),),
    'thresholded_relu': (('threshold', 1.0),),
    'hard_sigmoid': (('slope', 0.2), ('offset', 0.5)),
    'swish': (('beta', 1.0),),
    'clip': (('min', None), ('max', None)),
}

# binary elementwise op -> fn(x, y)
BINS = {
    'elementwise_add': torch.add,
    'elementwise_sub': torch.sub,
    'elementwise_mul': torch.mul,
    'elementwise_div': torch.div,
    'elementwise_max': torch.maximum,
    'elementwise_min': torch.minimum,
    'elementwise_pow': torch.pow,
}
