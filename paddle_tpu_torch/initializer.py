"""Parameter initializers.

Counterpart of paddle_tpu/initializer.py. Each initializer appends an
init op to the startup program; the op's kernel draws from the scope's
``torch.Generator`` (seeded from ``program.random_seed``) unless the op
carries its own non-zero seed. Under ``init_on_cpu()`` the random
initializers mark their op ``force_cpu``: it draws on the host, from a
host generator (the op's seed, else the scope's host generator, seeded
alike), and copies the values to the device, so a seeded init gives the
same values on the CPU and on the card.
"""
import contextlib
import math

import numpy as np

__all__ = ['Constant', 'Uniform', 'Normal', 'Xavier', 'MSRA', 'Bilinear',
           'force_init_on_cpu', 'init_on_cpu', 'ConstantInitializer',
           'UniformInitializer', 'NormalInitializer', 'XavierInitializer',
           'MSRAInitializer', 'BilinearInitializer']

_force_init_on_cpu_ = False


def force_init_on_cpu():
    return _force_init_on_cpu_


@contextlib.contextmanager
def init_on_cpu():
    global _force_init_on_cpu_
    prev = _force_init_on_cpu_
    _force_init_on_cpu_ = True
    try:
        yield
    finally:
        _force_init_on_cpu_ = prev


def _random_op(block, var, op_type, **attrs):
    attrs.update(shape=list(var.shape), dtype=var.dtype)
    if force_init_on_cpu():
        attrs['force_cpu'] = True
    return block.append_op(type=op_type, outputs={'Out': var}, attrs=attrs)


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


class UniformInitializer(Initializer):
    def __init__(self, low=-1.0, high=1.0, seed=0):
        self._low, self._high, self._seed = low, high, seed

    def __call__(self, var, block):
        return _random_op(block, var, 'uniform_random', min=self._low,
                          max=self._high, seed=self._seed)


class NormalInitializer(Initializer):
    def __init__(self, loc=0.0, scale=1.0, seed=0):
        self._mean, self._std, self._seed = loc, scale, seed

    def __call__(self, var, block):
        return _random_op(block, var, 'gaussian_random', mean=self._mean,
                          std=self._std, seed=self._seed)


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
            return _random_op(block, var, 'uniform_random', min=-limit,
                              max=limit, seed=self._seed)
        std = math.sqrt(2.0 / (fan_in + fan_out))
        return _random_op(block, var, 'gaussian_random', mean=0.0, std=std,
                          seed=self._seed)


class MSRAInitializer(Initializer):
    def __init__(self, uniform=True, fan_in=None, seed=0):
        self._uniform, self._fan_in, self._seed = uniform, fan_in, seed

    def __call__(self, var, block):
        fan_in, _ = _fan_in_out(var)
        fan_in = self._fan_in if self._fan_in is not None else fan_in
        if self._uniform:
            limit = math.sqrt(6.0 / fan_in)
            return _random_op(block, var, 'uniform_random', min=-limit,
                              max=limit, seed=self._seed)
        return _random_op(block, var, 'gaussian_random', mean=0.0,
                          std=math.sqrt(2.0 / fan_in), seed=self._seed)


class BilinearInitializer(Initializer):
    """The bilinear upsampling kernel of a conv_transpose weight
    [C_out, C_in, H, W], as one ``assign_value``."""

    def __call__(self, var, block):
        shape = var.shape
        if len(shape) != 4:
            raise ValueError("BilinearInitializer needs a 4-D parameter")
        weight = np.zeros(shape, dtype='float32')
        f = math.ceil(shape[3] / 2.0)
        c = (2 * f - 1 - f % 2) / (2.0 * f)
        for i in range(np.prod(shape[2:])):
            x = i % shape[3]
            y = (i // shape[3]) % shape[2]
            weight[:, :, int(y), int(x)] = \
                (1 - abs(x / f - c)) * (1 - abs(y / f - c))
        return block.append_op(
            type='assign_value', outputs={'Out': var},
            attrs={'shape': list(shape), 'dtype': var.dtype,
                   'values': weight.flatten().tolist()})


Constant = ConstantInitializer
Uniform = UniformInitializer
Normal = NormalInitializer
Xavier = XavierInitializer
MSRA = MSRAInitializer
Bilinear = BilinearInitializer
