"""Tensor layers: those of the JAX package's layers/tensor.py (the
learning-rate schedules', gradient clipping's, the CTR, NMT and
recurrent models', the control-flow layers' and Variable's operators',
and the sorting, finite-check, global-variable and identity layers).
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
           'argmax', 'argmin', 'argsort', 'create_global_var',
           'create_tensor', 'diag', 'eye', 'has_inf', 'has_nan', 'isfinite',
           'linspace', 'reverse', 'tensor_array_to_tensor']


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


def argmin(x, axis=0):
    helper = LayerHelper('arg_min')
    out = helper.create_variable_for_type_inference('int64',
                                                    stop_gradient=True)
    helper.append_op('arg_min', inputs={'X': x}, outputs={'Out': out},
                     attrs={'axis': axis})
    return out


def argsort(input, axis=-1, descending=False, name=None):
    """(the sorted values, their int64 indices)."""
    helper = LayerHelper('argsort', name=name)
    out = helper.create_variable_for_type_inference(input.dtype)
    ids = helper.create_variable_for_type_inference('int64',
                                                    stop_gradient=True)
    helper.append_op('argsort', inputs={'X': input},
                     outputs={'Out': out, 'Indices': ids},
                     attrs={'axis': axis, 'descending': descending})
    return out, ids


def create_global_var(shape, value, dtype, persistable=False,
                      force_cpu=False, name=None):
    """A global-block variable the startup program fills with value."""
    helper = LayerHelper('global_var', name=name)
    var = helper.create_global_variable(
        dtype=dtype, shape=tuple(shape), persistable=persistable,
        name=name or helper.name)
    sb = helper.startup_program.global_block()
    sb.create_var(name=var.name, shape=var.shape, dtype=var.dtype,
                  persistable=persistable)
    sb.append_op('fill_constant', outputs={'Out': var.name},
                 attrs={'shape': list(shape), 'dtype': dtype,
                        'value': float(value)})
    return var


def create_tensor(dtype, name=None, persistable=False):
    helper = LayerHelper('create_tensor', name=name)
    return helper.create_variable(name=helper.name, dtype=dtype,
                                  persistable=persistable, shape=())


def diag(diagonal):
    """The square matrix with the 1-D `diagonal` on its main diagonal."""
    helper = LayerHelper('diag')
    out = helper.create_variable_for_type_inference(diagonal.dtype)
    helper.append_op('diag', inputs={'Diagonal': diagonal},
                     outputs={'Out': out})
    return out


def eye(num_rows, num_columns=None, batch_shape=None, dtype='float32'):
    """An identity of num_rows x num_columns, tiled over batch_shape."""
    from . import nn as _nn
    helper = LayerHelper('eye')
    out = helper.create_variable_for_type_inference(dtype)
    helper.append_op('eye', outputs={'Out': out},
                     attrs={'num_rows': num_rows,
                            'num_columns': num_columns or -1,
                            'dtype': dtype}, infer_shape=False)
    out.shape = (num_rows, num_columns or num_rows)
    if batch_shape:
        for _ in batch_shape:
            out = _nn.unsqueeze(out, axes=[0])
        out = _nn.expand(out, expand_times=list(batch_shape) + [1, 1])
    return out


def _flag(op_type, x):
    helper = LayerHelper(op_type)
    out = helper.create_variable_for_type_inference('bool',
                                                    stop_gradient=True)
    helper.append_op(op_type, inputs={'X': [x]}, outputs={'Out': out})
    return out


def has_inf(x):
    return _flag('isinf', x)


def has_nan(x):
    return _flag('isnan', x)


def isfinite(x):
    return _flag('isfinite', x)


def linspace(start, stop, num, dtype='float32'):
    """`num` values from start to stop, through range (as the JAX
    package builds it)."""
    step = (float(stop) - float(start)) / max(int(num) - 1, 1)
    return range(start, float(stop) + step / 2, step, dtype)


def reverse(x, axis):
    helper = LayerHelper('reverse')
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op('flip', inputs={'X': x}, outputs={'Out': out},
                     attrs={'axis': [axis] if isinstance(axis, int)
                            else list(axis)})
    return out


def tensor_array_to_tensor(input, axis=1, name=None, use_stack=False):
    """(the array's items joined along axis, or stacked; int32 [n] of
    ones).  An array written only outside control flow records its
    static length, which the op reads; else it takes the capacity."""
    helper = LayerHelper('tensor_array_to_tensor', name=name)
    out = helper.create_variable_for_type_inference(input.dtype)
    idx = helper.create_variable_for_type_inference('int32')
    meta = getattr(input, '_tensor_array', None)
    length = 0 if (meta is None or meta.get('dynamic')) else \
        meta.get('static_len', 0)
    helper.append_op('tensor_array_to_tensor', inputs={'X': input},
                     outputs={'Out': out, 'OutIndex': idx},
                     attrs={'axis': axis, 'use_stack': use_stack,
                            'length': length},
                     infer_shape=False)
    return out, idx
