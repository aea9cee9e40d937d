"""Tensor layers: the subset the learning-rate schedules, gradient
clipping, the CTR models and Variable's operators build.  Reference:
python/paddle/fluid/layers/tensor.py; each appends the ops the JAX
package's layers/tensor.py appends."""

import numpy as np

from .. import core
from ..framework import Variable
from ..layer_helper import LayerHelper

__all__ = ['assign', 'cast', 'concat', 'fill_constant', 'ones_like']


def assign(input, output=None):
    """A Variable copied (op assign), or a numpy value as a constant
    (op assign_value)."""
    helper = LayerHelper('assign')
    if isinstance(input, Variable):
        if output is None:
            output = helper.create_variable_for_type_inference(input.dtype)
        helper.append_op('assign', inputs={'X': input},
                         outputs={'Out': output})
        return output
    arr = np.asarray(input)
    if output is None:
        output = helper.create_variable_for_type_inference(str(arr.dtype))
    helper.append_op('assign_value', outputs={'Out': output},
                     attrs={'shape': list(arr.shape),
                            'dtype': str(arr.dtype),
                            'values': arr.flatten().tolist()})
    return output


def cast(x, dtype):
    helper = LayerHelper('cast')
    out = helper.create_variable_for_type_inference(core.dtype_name(dtype))
    helper.append_op('cast', inputs={'X': x}, outputs={'Out': out},
                     attrs={'out_dtype': core.dtype_name(dtype)})
    return out


def concat(input, axis=0, name=None):
    helper = LayerHelper('concat', name=name)
    out = helper.create_variable_for_type_inference(input[0].dtype)
    helper.append_op('concat', inputs={'X': list(input)},
                     outputs={'Out': out}, attrs={'axis': axis})
    return out


def fill_constant(shape, dtype, value, force_cpu=False, out=None):
    helper = LayerHelper('fill_constant')
    if out is None:
        out = helper.create_variable_for_type_inference(
            core.dtype_name(dtype))
    helper.append_op('fill_constant', outputs={'Out': out},
                     attrs={'shape': list(shape), 'dtype': dtype,
                            'value': float(value)})
    out.stop_gradient = True
    return out


def ones_like(x, out=None):
    helper = LayerHelper('ones_like')
    if out is None:
        out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op('fill_any_like', inputs={'X': x},
                     outputs={'Out': out}, attrs={'value': 1.0})
    return out
