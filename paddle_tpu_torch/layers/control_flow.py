"""Control-flow layers. Counterpart of paddle_tpu/layers/control_flow.py,
trimmed to ``increment`` and the compare layers: ``less_than`` and
``equal`` as there, and ``less_equal``, ``greater_than``,
``greater_equal`` and ``not_equal`` built the same way (paddle_tpu
reaches those op types through Variable's operators). ``While``,
``IfElse`` and the tensor arrays wait for their kernels (ROADMAP Queue
A, item 3)."""
from ..layer_helper import LayerHelper

__all__ = ['increment', 'less_than', 'less_equal', 'greater_than',
           'greater_equal', 'equal', 'not_equal']


def increment(x, value=1.0, in_place=True):
    helper = LayerHelper("increment", **{})
    if not in_place:
        out = helper.create_tmp_variable(dtype=x.dtype, shape=x.shape)
    else:
        out = x
    helper.append_op(type='increment', inputs={'X': [x]},
                     outputs={'Out': [out]}, attrs={'step': float(value)})
    return out


def _compare_layer(op_type):
    def layer(x, y, cond=None, **ignored):
        helper = LayerHelper(op_type, **{})
        if cond is None:
            cond = helper.create_tmp_variable(dtype='bool', shape=x.shape)
            cond.stop_gradient = True
        helper.append_op(type=op_type, inputs={'X': [x], 'Y': [y]},
                         outputs={'Out': [cond]})
        return cond
    layer.__name__ = op_type
    return layer


less_than = _compare_layer('less_than')
less_equal = _compare_layer('less_equal')
greater_than = _compare_layer('greater_than')
greater_equal = _compare_layer('greater_equal')
equal = _compare_layer('equal')
not_equal = _compare_layer('not_equal')
