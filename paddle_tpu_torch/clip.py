"""Gradient and error clipping.

Counterpart of paddle_tpu/clip.py: the same classes and attribute
plumbing (``set_gradient_clip``, a parameter's ``gradient_clip_attr``,
a variable's ``error_clip``). Gradient-clip ops append after the
backward marker; an error clip on an activation is applied by the
lowering as the backward passes through it.
"""
import copy

from . import framework, layers

__all__ = ['ErrorClipByValue', 'GradientClipByValue', 'GradientClipByNorm',
           'GradientClipByGlobalNorm', 'append_gradient_clip_ops',
           'error_clip_callback', 'set_gradient_clip']


class BaseErrorClipAttr(object):
    def append_clip_op(self, block, grad_name):
        raise NotImplementedError()


class ErrorClipByValue(BaseErrorClipAttr):
    def __init__(self, max, min=None):
        max = float(max)
        min = -max if min is None else float(min)
        self.max, self.min = max, min

    def append_clip_op(self, block, grad_name):
        block.append_op(type='clip', inputs={'X': [grad_name]},
                        outputs={'Out': [grad_name]},
                        attrs={'min': self.min, 'max': self.max})


def error_clip_callback(block, context):
    """append_backward callback: a parameter's own error clip clips its
    gradient after the marker."""
    error_clip = getattr(context['param'], 'error_clip', None)
    if error_clip is not None:
        error_clip.append_clip_op(block, context['grad'].name)


class BaseGradientClipAttr(object):
    def process_context(self, context, param, grad):
        pass

    def create_operators(self, param, grad):
        raise NotImplementedError()


class NullGradientClipAttr(BaseGradientClipAttr):
    def create_operators(self, param, grad):
        return param, grad


class GradientClipByValue(BaseGradientClipAttr):
    def __init__(self, max, min=None):
        max = float(max)
        min = -max if min is None else float(min)
        self.max, self.min = max, min

    def create_operators(self, param, grad):
        return param, layers.clip(x=grad, min=self.min, max=self.max)


class GradientClipByNorm(BaseGradientClipAttr):
    def __init__(self, clip_norm):
        self.clip_norm = clip_norm

    def create_operators(self, param, grad):
        return param, layers.clip_by_norm(x=grad, max_norm=self.clip_norm)


class GradientClipByGlobalNorm(BaseGradientClipAttr):
    def __init__(self, clip_norm, group_name="default_group"):
        self.clip_norm = clip_norm
        self.group_name = group_name

    def process_context(self, context, param, grad):
        if self.group_name not in context:
            context[self.group_name] = []
            context[self.group_name + "_clip_value"] = self.clip_norm
            context[self.group_name + "_clip"] = layers.fill_constant(
                shape=[1], dtype="float32", value=self.clip_norm)
        elif self.clip_norm != context[self.group_name + "_clip_value"]:
            raise ValueError("All parameters' 'clip_norm' of a same group "
                             "should be the same")
        local_norm = layers.reduce_sum(input=layers.pow(x=grad, factor=2.0))
        context[self.group_name].append(local_norm)
        self.context = context

    def create_operators(self, param, grad):
        group_scale_name = self.group_name + "_scale"
        if group_scale_name not in self.context:
            group_norm = layers.sums(input=self.context[self.group_name])
            group_norm = layers.sqrt(x=group_norm)
            clip_var = self.context[self.group_name + "_clip"]
            self.context[group_scale_name] = layers.elementwise_div(
                x=clip_var,
                y=layers.elementwise_max(x=clip_var, y=group_norm))
        return param, layers.elementwise_mul(
            x=grad, y=self.context[group_scale_name])


def set_gradient_clip(clip, param_list=None, program=None):
    if not isinstance(clip, BaseGradientClipAttr):
        raise TypeError("clip should be an instance of BaseGradientClipAttr")
    if program is None:
        program = framework.default_main_program()
    if param_list is None:
        param_list = program.global_block().all_parameters()
    if all(isinstance(elem, str) for elem in param_list):
        param_list = [program.global_block().var(elem)
                      for elem in param_list]
    if not all(isinstance(elem, framework.Parameter)
               for elem in param_list):
        raise TypeError("param_list should be a list of Parameter or "
                        "basestring(parameter's name)")
    for param in param_list:
        param.gradient_clip_attr = copy.deepcopy(clip)


def append_gradient_clip_ops(param_grad):
    context = dict()
    create_op_callbacks = []
    for p, g in param_grad:
        clip_attr = getattr(p, 'gradient_clip_attr', None)
        if clip_attr is None:
            clip_attr = NullGradientClipAttr()
        if not isinstance(clip_attr, BaseGradientClipAttr):
            raise TypeError("clip attribute should be an instance of "
                            "BaseGradientClipAttr")
        clip_attr.process_context(context=context, param=p, grad=g)
        create_op_callbacks.append(lambda p=p, g=g, c=clip_attr:
                                   c.create_operators(p, g))
    return [callback() for callback in create_op_callbacks]
