"""ParamAttr and WeightNormParamAttr. Counterpart of
paddle_tpu/param_attr.py (no sharding annotation)."""
from .initializer import Constant
from .regularizer import WeightDecayRegularizer

__all__ = ['ParamAttr', 'WeightNormParamAttr']


class ParamAttr(object):
    def __init__(self, name=None, initializer=None, learning_rate=1.0,
                 regularizer=None, trainable=True, gradient_clip=None,
                 do_model_average=None):
        self.name = name
        self.initializer = initializer
        self.learning_rate = learning_rate
        self.regularizer = regularizer
        self.trainable = trainable
        self.gradient_clip = gradient_clip
        self.do_model_average = do_model_average

    def set_default_initializer(self, initializer):
        if initializer is None:
            if self.initializer is None:
                raise ValueError("ParamAttr.initializer is not set")
            return
        if self.initializer is not None:
            return
        self.initializer = initializer

    def set_default_bias_initializer(self):
        self.set_default_initializer(Constant(0.0))

    @staticmethod
    def to_attr(arg):
        if arg is None:
            return ParamAttr()
        elif isinstance(arg, (list, tuple)):
            return [ParamAttr.to_attr(a) for a in arg]
        elif isinstance(arg, ParamAttr):
            return arg
        elif isinstance(arg, str):
            return ParamAttr(name=arg)
        elif isinstance(arg, WeightDecayRegularizer):
            return ParamAttr(regularizer=arg)
        elif isinstance(arg, bool):
            # `bias_attr=False` disables the bias entirely
            return ParamAttr.to_attr(None) if arg else False
        else:
            return ParamAttr(initializer=arg)

    def to_kwargs(self):
        return {
            'name': self.name,
            'optimize_attr': {'learning_rate': self.learning_rate},
            'regularizer': self.regularizer,
            'trainable': self.trainable,
            'gradient_clip_attr': self.gradient_clip,
            'do_model_average': self.do_model_average,
        }


class WeightNormParamAttr(ParamAttr):
    """Weight normalisation, w = g * v / ||v|| (Salimans and Kingma,
    arXiv:1602.07868), the norm over every axis but ``dim`` (over all
    axes when ``dim`` is None).

    Given to fc or conv2d, it splits the weight into a direction ``v``
    (``<name>_v``, the weight's shape, the user's initializer) and a
    magnitude ``g`` (``<name>_g``, 1 on every axis but ``dim``, set to
    ||v|| by the startup program); both train, and the layer reads the
    recomposed w (``LayerHelper._create_weight_normalize``).
    ``params_with_weight_norm`` collects the recomposed Variables, as
    in paddle_tpu.
    """
    params_with_weight_norm = []

    def __init__(self, dim=None, **kwargs):
        super(WeightNormParamAttr, self).__init__(**kwargs)
        self.dim = dim
