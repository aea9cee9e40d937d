"""Unary, power, comparison and logical layers.  Reference:
python/paddle/fluid/layers/ops.py (generated there from the OpProtos);
here one generated layer per unary op the port lowers
(ops/activation_ops.py)."""

from ..layer_helper import LayerHelper

_UNARY = ['sigmoid', 'tanh', 'exp', 'relu', 'sqrt', 'floor', 'cos',
          'reciprocal', 'log', 'sign']
_COMPARE = ['equal', 'not_equal', 'less_than', 'less_equal', 'greater_than',
            'greater_equal']

__all__ = _UNARY + _COMPARE + ['scale', 'pow', 'logical_and', 'logical_or',
                               'logical_xor', 'logical_not']


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
