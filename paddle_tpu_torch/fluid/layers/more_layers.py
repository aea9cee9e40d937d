"""Layers of the JAX package's layers/more_layers.py that the port
lowers: elementwise_mod and elementwise_floordiv, which
BeamSearchDecoder.step builds.  Each appends the ops the JAX
package's layer appends (reference python/paddle/fluid/layers/nn.py)."""

from ..layer_helper import LayerHelper

__all__ = ['elementwise_mod', 'elementwise_floordiv']


def _simple(op_type, inputs, attrs=None, dtype=None, out_slot='Out',
            name=None, shape=None):
    helper = LayerHelper(op_type, name=name)
    first = next(iter(inputs.values()))
    first = first[0] if isinstance(first, list) else first
    out = helper.create_variable_for_type_inference(
        dtype or first.dtype)
    helper.append_op(op_type, inputs=inputs, outputs={out_slot: out},
                     attrs=attrs or {}, infer_shape=shape is None)
    if shape is not None:
        out.shape = tuple(shape)
    return out


def elementwise_mod(x, y, axis=-1, act=None, name=None):
    helper = LayerHelper('elementwise_mod', name=name)
    out = _simple('elementwise_mod', {'X': x, 'Y': y}, {'axis': axis},
                  name=name)
    return helper.append_activation(out, act)


def elementwise_floordiv(x, y, axis=-1, act=None, name=None):
    helper = LayerHelper('elementwise_floordiv', name=name)
    out = _simple('elementwise_floordiv', {'X': x, 'Y': y},
                  {'axis': axis}, name=name)
    return helper.append_activation(out, act)
