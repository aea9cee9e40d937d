"""Tensor layers: the subset the learning-rate schedules, gradient
clipping, the CTR, NMT and recurrent models, the control-flow layers and
Variable's operators build.
Reference: python/paddle/fluid/layers/tensor.py; each appends the ops
the JAX package's layers/tensor.py (``shape``: its more_layers.py)
appends."""

import numpy as np

from .. import core
from ..framework import Variable
from ..layer_helper import LayerHelper

__all__ = ['assign', 'cast', 'concat', 'fill_constant',
           'fill_constant_batch_size_like', 'ones', 'zeros', 'ones_like',
           'zeros_like', 'create_parameter', 'shape', 'range', 'sums',
           'argmax']


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


def sums(input, out=None):
    """The sum of a list of variables (op sum)."""
    helper = LayerHelper('sum')
    if out is None:
        out = helper.create_variable_for_type_inference(input[0].dtype)
    helper.append_op('sum', inputs={'X': list(input)},
                     outputs={'Out': out})
    return out


def argmax(x, axis=0):
    helper = LayerHelper('arg_max')
    out = helper.create_variable_for_type_inference('int64',
                                                    stop_gradient=True)
    helper.append_op('arg_max', inputs={'X': x}, outputs={'Out': out},
                     attrs={'axis': axis})
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


def fill_constant_batch_size_like(input, shape, dtype, value,
                                  input_dim_idx=0, output_dim_idx=0):
    """A constant of `shape` whose dim output_dim_idx is input's dim
    input_dim_idx at run time (the batch)."""
    helper = LayerHelper('fill_constant_batch_size_like')
    out = helper.create_variable_for_type_inference(core.dtype_name(dtype))
    helper.append_op('fill_constant_batch_size_like',
                     inputs={'Input': input}, outputs={'Out': out},
                     attrs={'shape': list(shape), 'dtype': dtype,
                            'value': float(value),
                            'input_dim_idx': input_dim_idx,
                            'output_dim_idx': output_dim_idx})
    out.stop_gradient = True
    return out


def ones(shape, dtype='float32', force_cpu=False):
    return fill_constant(shape, dtype, 1.0)


def zeros(shape, dtype='float32', force_cpu=False):
    return fill_constant(shape, dtype, 0.0)


def zeros_like(x, out=None):
    helper = LayerHelper('zeros_like')
    if out is None:
        out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op('fill_zeros_like', inputs={'X': x},
                     outputs={'Out': out})
    return out


def create_parameter(shape, dtype, name=None, attr=None,
                     is_bias=False, default_initializer=None):
    """Reference layers/tensor.py create_parameter."""
    from ..param_attr import ParamAttr
    helper = LayerHelper('create_parameter')
    attr = attr or ParamAttr(name=name)
    return helper.create_parameter(attr, list(shape), dtype, is_bias,
                                   default_initializer)


def ones_like(x, out=None):
    helper = LayerHelper('ones_like')
    if out is None:
        out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op('fill_any_like', inputs={'X': x},
                     outputs={'Out': out}, attrs={'value': 1.0})
    return out


def shape(input, name=None):
    """The int32 vector of input's runtime shape."""
    helper = LayerHelper('shape', name=name)
    out = helper.create_variable_for_type_inference('int32')
    helper.append_op('shape', inputs={'Input': input}, outputs={'Out': out},
                     attrs={})
    return out


def range(start, end, step, dtype):
    """[start, end) by step; the python scalars are also stored as the
    op's __static__ attr, which its lowering requires."""
    helper = LayerHelper('range')
    s = fill_constant([1], dtype, start)
    e = fill_constant([1], dtype, end)
    st = fill_constant([1], dtype, step)
    out = helper.create_variable_for_type_inference(core.dtype_name(dtype))
    helper.append_op('range',
                     inputs={'Start': s, 'End': e, 'Step': st},
                     outputs={'Out': out},
                     attrs={'__static__': [float(start), float(end),
                                           float(step)]})
    out.stop_gradient = True
    return out
