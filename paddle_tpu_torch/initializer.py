"""Parameter initializers.

Counterpart of paddle_tpu/initializer.py, trimmed to the initializers
the port's layers use. Each initializer appends an init op to
the startup program; the op's kernel draws from the scope's
``torch.Generator`` (seeded from ``program.random_seed``) unless the op
carries its own non-zero seed.
"""
import math

import numpy as np

__all__ = ['Constant', 'Normal', 'Xavier', 'ConstantInitializer',
           'NormalInitializer', 'XavierInitializer']


class Initializer(object):
    def __call__(self, var, block):
        raise NotImplementedError


class ConstantInitializer(Initializer):
    def __init__(self, value=0.0, force_cpu=False):
        self._value = value

    def __call__(self, var, block):
        return block.append_op(
            type='fill_constant', outputs={'Out': var},
            attrs={'shape': list(var.shape), 'dtype': var.dtype,
                   'value': float(self._value)})


class NormalInitializer(Initializer):
    def __init__(self, loc=0.0, scale=1.0, seed=0):
        self._mean, self._std, self._seed = loc, scale, seed

    def __call__(self, var, block):
        return block.append_op(
            type='gaussian_random', outputs={'Out': var},
            attrs={'shape': list(var.shape), 'dtype': var.dtype,
                   'mean': self._mean, 'std': self._std, 'seed': self._seed})


def _fan_in_out(var):
    shape = var.shape
    if len(shape) == 0:
        return 1, 1
    if len(shape) == 1:
        return shape[0], shape[0]
    if len(shape) == 2:
        return shape[0], shape[1]
    receptive = int(np.prod(shape[2:]))
    return shape[1] * receptive, shape[0] * receptive


class XavierInitializer(Initializer):
    def __init__(self, uniform=True, fan_in=None, fan_out=None, seed=0):
        self._uniform, self._fan_in = uniform, fan_in
        self._fan_out, self._seed = fan_out, seed

    def __call__(self, var, block):
        fan_in, fan_out = _fan_in_out(var)
        fan_in = self._fan_in if self._fan_in is not None else fan_in
        fan_out = self._fan_out if self._fan_out is not None else fan_out
        if self._uniform:
            limit = math.sqrt(6.0 / (fan_in + fan_out))
            return block.append_op(
                type='uniform_random', outputs={'Out': var},
                attrs={'shape': list(var.shape), 'dtype': var.dtype,
                       'min': -limit, 'max': limit, 'seed': self._seed})
        std = math.sqrt(2.0 / (fan_in + fan_out))
        return block.append_op(
            type='gaussian_random', outputs={'Out': var},
            attrs={'shape': list(var.shape), 'dtype': var.dtype,
                   'mean': 0.0, 'std': std, 'seed': self._seed})


Constant = ConstantInitializer
Normal = NormalInitializer
Xavier = XavierInitializer
