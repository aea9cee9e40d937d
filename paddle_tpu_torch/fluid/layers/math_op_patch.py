"""Operator overloading for Variable (+ - * / ** and comparisons with
scalars, numpy arrays and Variables).

Reference: python/paddle/fluid/layers/math_op_patch.py.  The ops are
the JAX package's: a scalar operand of + - * and of / on the right
becomes one scale op, any other operand a constant (fill_constant,
assign_value) under an elementwise or comparison op.
"""

import numpy as np

from ..framework import Variable
from ..layer_helper import LayerHelper

_COMPARE = ('less_than', 'less_equal', 'greater_than', 'greater_equal',
            'equal', 'not_equal')


def _scalar_op(x, other, op_type, reverse):
    """The scale op computing `x op other` for a Python scalar, or None
    where none does (a scalar divided by x)."""
    from . import ops
    v = float(other)
    if op_type == 'elementwise_add':
        return ops.scale(x, scale=1.0, bias=v)
    if op_type == 'elementwise_sub':
        return ops.scale(x, scale=-1.0 if reverse else 1.0,
                         bias=v if reverse else -v)
    if op_type == 'elementwise_mul':
        return ops.scale(x, scale=v)
    if op_type == 'elementwise_div' and not reverse:
        return ops.scale(x, scale=1.0 / v)
    return None


def binary(self, other, op_type, reverse=False):
    from . import tensor
    if isinstance(other, (int, float)):
        out = None if op_type in _COMPARE else \
            _scalar_op(self, other, op_type, reverse)
        if out is not None:
            return out
        other = tensor.fill_constant([1], self.dtype, float(other))
    elif isinstance(other, np.ndarray):
        other = tensor.assign(other)
    if not isinstance(other, Variable):
        raise TypeError('cannot apply %s to %r' % (op_type, other))
    x, y = (other, self) if reverse else (self, other)
    helper = LayerHelper(op_type)
    if op_type in _COMPARE:
        out = helper.create_variable_for_type_inference(
            'bool', stop_gradient=True)
    else:
        out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op(op_type, inputs={'X': x, 'Y': y},
                     outputs={'Out': out}, attrs={'axis': -1})
    return out
