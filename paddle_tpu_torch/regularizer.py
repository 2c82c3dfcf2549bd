"""Weight-decay regularizers.

Counterpart of paddle_tpu/regularizer.py: each appends penalty-gradient
ops after the backward marker, which read the parameter and add into its
``<param>@GRAD``.
"""
__all__ = ['append_regularization_ops', 'WeightDecayRegularizer', 'L1Decay',
           'L2Decay', 'L1DecayRegularizer', 'L2DecayRegularizer']


class WeightDecayRegularizer(object):
    def append_ops(self, param, grad, block):
        raise NotImplementedError


class L2DecayRegularizer(WeightDecayRegularizer):
    def __init__(self, regularization_coeff=0.0):
        self._coeff = regularization_coeff

    def append_ops(self, param, grad, block):
        decay = block.create_var(
            name=param.name + '_l2decay', shape=param.shape,
            dtype=param.dtype)
        block.append_op(type='scale', inputs={'X': param},
                        outputs={'Out': decay},
                        attrs={'scale': self._coeff})
        block.append_op(type='sum', inputs={'X': [grad, decay]},
                        outputs={'Out': grad})

    def __str__(self):
        return "L2Decay, regularization_coeff=%f" % self._coeff


class L1DecayRegularizer(WeightDecayRegularizer):
    def __init__(self, regularization_coeff=0.0):
        self._coeff = regularization_coeff

    def append_ops(self, param, grad, block):
        sign = block.create_var(name=param.name + '_l1sign',
                                shape=param.shape, dtype=param.dtype)
        decay = block.create_var(name=param.name + '_l1decay',
                                 shape=param.shape, dtype=param.dtype)
        block.append_op(type='sign', inputs={'X': param},
                        outputs={'Out': sign})
        block.append_op(type='scale', inputs={'X': sign},
                        outputs={'Out': decay},
                        attrs={'scale': self._coeff})
        block.append_op(type='sum', inputs={'X': [grad, decay]},
                        outputs={'Out': grad})

    def __str__(self):
        return "L1Decay, regularization_coeff=%f" % self._coeff


def append_regularization_ops(parameters_and_grads, regularization=None):
    """A parameter's own regularizer wins over the optimizer's."""
    for param, grad in parameters_and_grads:
        term = param.regularizer or regularization
        if grad is not None and term is not None:
            term.append_ops(param, grad, grad.block)
    return list(parameters_and_grads)


L1Decay = L1DecayRegularizer
L2Decay = L2DecayRegularizer
