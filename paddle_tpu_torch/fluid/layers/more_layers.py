"""Layers of the JAX package's layers/more_layers.py that the port
lowers: elementwise_mod and elementwise_floordiv (which
BeamSearchDecoder.step builds), im2sequence, row_conv, sum,
filter_by_instag, lod_append and sampled_softmax_with_cross_entropy.
Each appends the ops the JAX package's layer appends (reference
python/paddle/fluid/layers/nn.py and loss.py)."""

from ..layer_helper import LayerHelper

__all__ = ['elementwise_mod', 'elementwise_floordiv', 'im2sequence',
           'row_conv', 'sum', 'filter_by_instag', 'lod_append',
           'sampled_softmax_with_cross_entropy']


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


def im2sequence(input, filter_size=1, stride=1, padding=0,
                input_image_size=None, out_stride=1, name=None):
    def _pair(v):
        return list(v) if isinstance(v, (list, tuple)) else [v, v]
    attrs = {'kernels': _pair(filter_size), 'strides': _pair(stride),
             'paddings': (_pair(padding) * 2 if
                          len(_pair(padding)) == 2 else list(padding))}
    return _simple('im2sequence', {'X': input}, attrs, name=name)


def row_conv(input, future_context_size, param_attr=None, act=None,
             name=None):
    helper = LayerHelper('row_conv', name=name)
    filter_shape = [future_context_size + 1, input.shape[-1]]
    w = helper.create_parameter(param_attr, filter_shape, input.dtype)
    out = _simple('row_conv', {'X': input, 'Filter': w}, name=name)
    return helper.append_activation(out, act)


def sum(x, name=None):
    xs = x if isinstance(x, (list, tuple)) else [x]
    return _simple('sum', {'X': list(xs)}, name=name)


def filter_by_instag(ins, ins_tag, filter_tag, is_lod=True):
    helper = LayerHelper('filter_by_instag')
    out = helper.create_variable_for_type_inference(ins.dtype)
    loss_weight = helper.create_variable_for_type_inference('float32')
    index_map = helper.create_variable_for_type_inference('int64')
    helper.append_op('filter_by_instag',
                     inputs={'Ins': ins, 'Ins_tag': ins_tag,
                             'Filter_tag': filter_tag},
                     outputs={'Out': out, 'LossWeight': loss_weight,
                              'IndexMap': index_map},
                     attrs={'is_lod': is_lod}, infer_shape=False)
    return out, loss_weight


def lod_append(x, level):
    """LoD levels are host metadata: appending one leaves the padded
    dense form as it is (the JAX package's lod_append)."""
    return x


def sampled_softmax_with_cross_entropy(logits, label, num_samples,
                                       num_true=1,
                                       remove_accidental_hits=True,
                                       use_customized_samples=False,
                                       customized_samples=None,
                                       customized_probabilities=None,
                                       seed=0):
    """sample_logits, then softmax_with_cross_entropy over the sampled
    logits (reference layers/loss.py)."""
    helper = LayerHelper('sample_logits')
    samples = helper.create_variable_for_type_inference('int64')
    probs = helper.create_variable_for_type_inference(logits.dtype)
    sampled_logits = helper.create_variable_for_type_inference(
        logits.dtype)
    sampled_label = helper.create_variable_for_type_inference('int64')
    helper.append_op('sample_logits',
                     inputs={'Logits': logits, 'Labels': label},
                     outputs={'Samples': samples,
                              'Probabilities': probs,
                              'SampledLogits': sampled_logits,
                              'SampledLabels': sampled_label},
                     attrs={'num_samples': num_samples,
                            'use_customized_samples':
                                use_customized_samples,
                            'remove_accidental_hits':
                                remove_accidental_hits,
                            'seed': seed}, infer_shape=False)
    b = logits.shape[0]
    sampled_logits.shape = (b, num_true + num_samples)
    sampled_label.shape = (b, num_true)
    from . import nn as _nn
    return _nn.softmax_with_cross_entropy(sampled_logits, sampled_label)
