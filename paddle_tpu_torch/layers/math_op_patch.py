"""Operator overloading on Variable.

Counterpart of paddle_tpu/layers/math_op_patch.py: ``+ - * / **`` and
the six comparisons on Variables build elementwise ops with ``axis=-1``;
a Python scalar operand, on either side, becomes a ``fill_constant`` of
shape [1] (or a ``fill_constant_batch_size_like`` of the Variable's
shape when its first dimension is the batch). ``-x`` is a ``scale`` by
-1 and ``x.astype(dtype)`` a ``cast``.

Since ``==`` builds an op, Variables hash by identity, and the port's
own code compares Variables with ``is`` or by name, never with ``==``
or ``in`` on a list.
"""
from ..framework import Variable
from ..layer_helper import LayerHelper

__all__ = ['monkey_patch_variable']


def monkey_patch_variable():
    def create_scalar(value, dtype):
        helper = LayerHelper('fill_constant', **{})
        var = helper.create_tmp_variable(dtype=dtype, shape=(1,))
        helper.append_op(type='fill_constant', outputs={'Out': [var]},
                         attrs={'shape': [1], 'dtype': dtype,
                                'value': float(value)})
        var.stop_gradient = True
        return var

    def create_tensor_with_batchsize(ref_var, value, dtype):
        helper = LayerHelper('fill_constant_batch_size_like', **{})
        var = helper.create_tmp_variable(dtype=dtype, shape=ref_var.shape)
        helper.append_op(type='fill_constant_batch_size_like',
                         inputs={'Input': [ref_var]},
                         outputs={'Out': [var]},
                         attrs={'shape': list(ref_var.shape),
                                'dtype': dtype, 'value': float(value)})
        var.stop_gradient = True
        return var

    def astype(self, dtype):
        helper = LayerHelper('cast', **{})
        out = helper.create_tmp_variable(dtype=dtype, shape=self.shape,
                                         lod_level=self.lod_level)
        helper.append_op(type='cast', inputs={'X': [self]},
                         outputs={'Out': [out]},
                         attrs={'in_dtype': self.dtype,
                                'out_dtype': dtype})
        return out

    def _elemwise_method_creator_(method_name, op_type, reverse=False):
        def __impl__(self, other_var):
            dtype = self.dtype
            if isinstance(other_var, (float, int)):
                if self.shape and self.shape[0] == -1:
                    other_var = create_tensor_with_batchsize(
                        self, other_var, dtype)
                else:
                    other_var = create_scalar(other_var, dtype)
            elif not isinstance(other_var, Variable):
                return NotImplemented
            lhs, rhs = (other_var, self) if reverse else (self, other_var)
            helper = LayerHelper(op_type, **{})
            out = helper.create_tmp_variable(
                dtype=dtype, shape=lhs.shape or rhs.shape,
                lod_level=max(lhs.lod_level, rhs.lod_level))
            helper.append_op(type=op_type,
                             inputs={'X': [lhs], 'Y': [rhs]},
                             outputs={'Out': [out]}, attrs={'axis': -1})
            return out
        __impl__.__name__ = method_name
        return __impl__

    Variable.astype = astype
    for method_name, op_type, reverse in (
            ("__add__", "elementwise_add", False),
            ("__radd__", "elementwise_add", False),
            ("__sub__", "elementwise_sub", False),
            ("__rsub__", "elementwise_sub", True),
            ("__mul__", "elementwise_mul", False),
            ("__rmul__", "elementwise_mul", False),
            ("__div__", "elementwise_div", False),
            ("__truediv__", "elementwise_div", False),
            ("__rdiv__", "elementwise_div", True),
            ("__rtruediv__", "elementwise_div", True),
            ("__pow__", "elementwise_pow", False),
            ("__rpow__", "elementwise_pow", True),
            ("__eq__", "equal", False),
            ("__ne__", "not_equal", False),
            ("__lt__", "less_than", False),
            ("__le__", "less_equal", False),
            ("__gt__", "greater_than", False),
            ("__ge__", "greater_equal", False)):
        setattr(Variable, method_name,
                _elemwise_method_creator_(method_name, op_type, reverse))

    def __neg__(self):
        helper = LayerHelper('scale', **{})
        out = helper.create_tmp_variable(dtype=self.dtype, shape=self.shape,
                                         lod_level=self.lod_level)
        helper.append_op(type='scale', inputs={'X': [self]},
                         outputs={'Out': [out]}, attrs={'scale': -1.0})
        return out

    Variable.__neg__ = __neg__
    # Variables hash by identity (needed since __eq__ builds ops)
    Variable.__hash__ = lambda self: id(self)


monkey_patch_variable()
