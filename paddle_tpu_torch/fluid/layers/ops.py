"""Unary, power, comparison and logical layers.  Reference:
python/paddle/fluid/layers/ops.py (generated there from the OpProtos);
here one generated layer per unary op the port lowers
(ops/activation_ops.py)."""

from ..layer_helper import LayerHelper

# the JAX package's list (its layers/ops.py), in its order
_UNARY = [
    'sigmoid', 'tanh', 'exp', 'relu', 'sqrt', 'rsqrt', 'abs', 'ceil',
    'floor', 'cos', 'sin', 'tan', 'acos', 'asin', 'atan', 'sinh', 'cosh',
    'round', 'reciprocal', 'square', 'softplus', 'softsign', 'log',
    'log2', 'log10', 'log1p', 'erf', 'sign', 'silu',
    'logsigmoid', 'tanh_shrink',
]
_COMPARE = ['equal', 'not_equal', 'less_than', 'less_equal', 'greater_than',
            'greater_equal']

__all__ = _UNARY + _COMPARE + ['scale', 'pow', 'logical_and', 'logical_or',
                               'logical_xor', 'logical_not', 'gelu', 'elu',
                               'relu6', 'swish', 'hard_sigmoid',
                               'hard_swish', 'cumsum']


def _make_unary(op_type):
    def layer(x, name=None):
        helper = LayerHelper(op_type, name=name)
        out = helper.create_variable_for_type_inference(x.dtype)
        helper.append_op(op_type, inputs={'X': x}, outputs={'Out': out})
        return out

    layer.__name__ = op_type
    layer.__doc__ = 'elementwise %s (lowering in ops/activation_ops.py)' \
        % op_type
    return layer


for _op in _UNARY:
    globals()[_op] = _make_unary(_op)


def scale(x, scale=1.0, bias=0.0, bias_after_scale=True, act=None,
          name=None):
    helper = LayerHelper('scale', name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op('scale', inputs={'X': x}, outputs={'Out': out},
                     attrs={'scale': float(scale), 'bias': float(bias),
                            'bias_after_scale': bias_after_scale})
    return helper.append_activation(out, act)


def pow(x, factor=1.0, name=None):
    helper = LayerHelper('pow', name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op('pow', inputs={'X': x}, outputs={'Out': out},
                     attrs={'factor': float(factor)})
    return out


def _unary_op(op_type, x, attrs, name):
    """A layer of one op from X to Out (of X's dtype) with `attrs`."""
    helper = LayerHelper(op_type, name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op(op_type, inputs={'X': x}, outputs={'Out': out},
                     attrs=attrs)
    return out


def gelu(x, approximate=False, name=None):
    return _unary_op('gelu', x, {'approximate': approximate}, name)


def elu(x, alpha=1.0, name=None):
    return _unary_op('elu', x, {'alpha': alpha}, name)


def relu6(x, threshold=6.0, name=None):
    return _unary_op('relu6', x, {'threshold': threshold}, name)


def swish(x, beta=1.0, name=None):
    return _unary_op('swish', x, {'beta': beta}, name)


def hard_sigmoid(x, slope=0.2, offset=0.5, name=None):
    """clip(slope * x + offset, 0, 1); slope 1/6 and offset 0.5 give
    MobileNetV3's h-sigmoid, relu6(x + 3) / 6."""
    return _unary_op('hard_sigmoid', x, {'slope': slope,
                                          'offset': offset}, name)


def hard_swish(x, threshold=6.0, scale=6.0, offset=3.0, name=None):
    return _unary_op('hard_swish', x, {'threshold': threshold,
                                        'scale': scale, 'offset': offset},
                     name)


def cumsum(x, axis=None, exclusive=None, reverse=None):
    """Only the attrs given are set (the op's defaults: the last axis,
    inclusive, forward)."""
    attrs = {}
    if axis is not None:
        attrs['axis'] = axis
    if exclusive is not None:
        attrs['exclusive'] = exclusive
    if reverse is not None:
        attrs['reverse'] = reverse
    return _unary_op('cumsum', x, attrs, None)


def _make_compare(op_type):
    def layer(x, y, cond=None, **unused):
        helper = LayerHelper(op_type)
        if cond is None:
            cond = helper.create_variable_for_type_inference(
                'bool', stop_gradient=True)
        helper.append_op(op_type, inputs={'X': x, 'Y': y},
                         outputs={'Out': cond})
        return cond

    layer.__name__ = op_type
    return layer


for _op in _COMPARE:
    globals()[_op] = _make_compare(_op)


def _logical(op, x, y, out=None, name=None):
    helper = LayerHelper(op, name=name)
    if out is None:
        out = helper.create_variable_for_type_inference(
            'bool', stop_gradient=True)
    helper.append_op(op, inputs={'X': x, 'Y': y}, outputs={'Out': out})
    return out


def logical_and(x, y, out=None, name=None):
    return _logical('logical_and', x, y, out, name)


def logical_or(x, y, out=None, name=None):
    return _logical('logical_or', x, y, out, name)


def logical_xor(x, y, out=None, name=None):
    return _logical('logical_xor', x, y, out, name)


def logical_not(x, out=None, name=None):
    helper = LayerHelper('logical_not', name=name)
    if out is None:
        out = helper.create_variable_for_type_inference(
            'bool', stop_gradient=True)
    helper.append_op('logical_not', inputs={'X': x}, outputs={'Out': out})
    return out
