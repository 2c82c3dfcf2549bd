"""Learning-rate schedules as in-graph ops.

Counterpart of paddle_tpu/layers/learning_rate_scheduler.py, copied: each
schedule returns a Variable computed from the step counter
(``autoincreased_step_counter``, persistable, advanced once a run), which
the optimizer reads as its learning rate in the same step.
"""
from . import nn, tensor, ops

__all__ = ['exponential_decay', 'natural_exp_decay', 'inverse_time_decay',
           'polynomial_decay', 'piecewise_decay', 'noam_decay']


def _decay_step_counter(begin=0):
    counter = nn.autoincreased_step_counter(
        counter_name='@LR_DECAY_COUNTER@', begin=begin, step=1)
    return tensor.cast(counter, 'float32')


def noam_decay(d_model, warmup_steps):
    global_step = _decay_step_counter(1)
    a = global_step ** -0.5
    b = (warmup_steps ** -1.5) * global_step
    lr_value = (d_model ** -0.5) * ops.elementwise_min(a, b)
    return lr_value


def exponential_decay(learning_rate, decay_steps, decay_rate,
                      staircase=False):
    global_step = _decay_step_counter()
    div_res = global_step / decay_steps
    if staircase:
        div_res = ops.floor(div_res)
    decayed_lr = learning_rate * (decay_rate ** div_res)
    return decayed_lr


def natural_exp_decay(learning_rate, decay_steps, decay_rate,
                      staircase=False):
    global_step = _decay_step_counter()
    div_res = global_step / decay_steps
    if staircase:
        div_res = ops.floor(div_res)
    decayed_lr = learning_rate * ops.exp(-1 * decay_rate * div_res)
    return decayed_lr


def inverse_time_decay(learning_rate, decay_steps, decay_rate,
                       staircase=False):
    global_step = _decay_step_counter()
    div_res = global_step / decay_steps
    if staircase:
        div_res = ops.floor(div_res)
    decayed_lr = learning_rate / (1 + decay_rate * div_res)
    return decayed_lr


def polynomial_decay(learning_rate, decay_steps, end_learning_rate=0.0001,
                     power=1.0, cycle=False):
    global_step = _decay_step_counter()
    if cycle:
        div_res = ops.ceil(global_step / decay_steps)
        zero_var = tensor.fill_constant(shape=[1], dtype='float32',
                                        value=0.0)
        one_var = tensor.fill_constant(shape=[1], dtype='float32', value=1.0)
        # 1 - sign(|step|): exactly 1 at step 0, else 0 (branchless)
        is_zero = one_var - ops.sign(ops.abs(global_step))
        div_res = div_res + is_zero * (one_var - div_res)
        decay_steps_var = decay_steps * div_res
        frac = global_step / decay_steps_var
    else:
        decay_steps_var = tensor.fill_constant(shape=[1], dtype='float32',
                                               value=float(decay_steps))
        capped = ops.elementwise_min(global_step, decay_steps_var)
        frac = capped / decay_steps
    decayed_lr = (learning_rate - end_learning_rate) * \
        ((1 - frac) ** power) + end_learning_rate
    return decayed_lr


def piecewise_decay(boundaries, values):
    """Piecewise-constant LR: a branchless select over the static
    boundaries, as paddle_tpu builds it (no Switch, no host read)."""
    if len(values) - len(boundaries) != 1:
        raise ValueError("len(values) - len(boundaries) should be 1")
    global_step = _decay_step_counter()
    lr = tensor.fill_constant(shape=[1], dtype='float32',
                              value=float(values[-1]))
    # walk boundaries from the top so earlier intervals win
    for b, v in zip(reversed(boundaries), reversed(values[:-1])):
        boundary = tensor.fill_constant(shape=[1], dtype='float32',
                                        value=float(b))
        vv = tensor.fill_constant(shape=[1], dtype='float32', value=float(v))
        below = ops.elementwise_max(
            ops.sign(boundary - global_step),
            tensor.fill_constant(shape=[1], dtype='float32', value=0.0))
        lr = below * vv + (1.0 - below) * lr
    return lr
