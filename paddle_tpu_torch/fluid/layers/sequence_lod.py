"""Sequence layers on padded+mask batches.

Reference: python/paddle/fluid/layers/sequence_lod.py over LoD tensors.
As in the JAX package, sequences are [B, T, ...] with a mask [B, T]
(ops/sequence_ops.py); pass `mask=` (from layers.sequence_mask) where
the reference relied on implicit LoD.
"""
from ..layer_helper import LayerHelper


def sequence_mask(x, maxlen=None, dtype='int64'):
    helper = LayerHelper('sequence_mask')
    out = helper.create_variable_for_type_inference(dtype,
                                                    stop_gradient=True)
    helper.append_op('sequence_mask', inputs={'X': x},
                     outputs={'Y': out},
                     attrs={'maxlen': maxlen, 'out_dtype': dtype})
    return out


def _seq_op(op_type, x, mask, attrs, out_slots=('Out',),
            out_shape=None):
    helper = LayerHelper(op_type)
    inputs = {'X': x}
    if mask is not None:
        inputs['Mask'] = mask
    outs = {}
    for s in out_slots:
        outs[s] = helper.create_variable_for_type_inference(x.dtype)
    # LoD ops: build-time var shapes are the ragged rendering while the
    # runtime batch is padded [B,T,...] — shapes resolve at run time
    helper.append_op(op_type, inputs=inputs, outputs=outs, attrs=attrs,
                     infer_shape=False)
    outs[out_slots[0]].shape = tuple(x.shape) if out_shape is None \
        else tuple(out_shape)
    return outs[out_slots[0]]


def _pooled_shape(x):
    # sequence_pool reduces [B, T, D] -> [B, D]; build-time lod-style
    # shapes ([B, D] already) pass through
    return x.shape[:1] + x.shape[2:] if len(x.shape) >= 3 else x.shape


def sequence_pool(input, pool_type, mask=None, is_test=False):
    return _seq_op('sequence_pool', input, mask,
                   {'pooltype': pool_type.upper()},
                   out_slots=('Out', 'MaxIndex'),
                   out_shape=_pooled_shape(input))


def sequence_softmax(input, mask=None, use_cudnn=False, name=None):
    return _seq_op('sequence_softmax', input, mask, {})


def sequence_first_step(input, mask=None):
    return _seq_op('sequence_pool', input, mask,
                   {'pooltype': 'FIRST'}, out_slots=('Out', 'MaxIndex'),
                   out_shape=_pooled_shape(input))


def sequence_last_step(input, mask=None):
    return _seq_op('sequence_pool', input, mask,
                   {'pooltype': 'LAST'}, out_slots=('Out', 'MaxIndex'),
                   out_shape=_pooled_shape(input))


def sequence_expand(x, y, ref_level=-1, name=None):
    helper = LayerHelper('sequence_expand', name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op('sequence_expand', inputs={'X': x, 'Y': y},
                     outputs={'Out': out}, attrs={'ref_level': ref_level})
    return out


def sequence_reshape(input, new_dim):
    helper = LayerHelper('sequence_reshape')
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op('sequence_reshape', inputs={'X': input},
                     outputs={'Out': out}, attrs={'new_dim': new_dim})
    return out


def sequence_conv(input, num_filters, filter_size=3, filter_stride=1,
                  padding=True, mask=None, bias_attr=None,
                  param_attr=None, act=None, name=None):
    helper = LayerHelper('sequence_conv', param_attr=param_attr,
                         bias_attr=bias_attr, act=act, name=name)
    # last dim is the feature dim in both the LoD ([B,T,D] padded) and
    # the flattened ([B*T?,D]) build-time renderings
    d = input.shape[-1]
    w = helper.create_parameter(param_attr,
                                shape=[filter_size * d, num_filters],
                                dtype=input.dtype)
    inputs = {'X': input, 'Filter': w}
    if mask is not None:
        inputs['Mask'] = mask
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op('sequence_conv', inputs=inputs,
                     outputs={'Out': out},
                     attrs={'contextLength': filter_size,
                            'contextStart': -(filter_size // 2)},
                     infer_shape=False)
    out.shape = tuple(input.shape[:-1]) + (num_filters,)
    pre_act = helper.append_bias_op(out, dim_start=2, bias_attr=bias_attr)
    return helper.append_activation(pre_act, act)


def _multi_out(op_type, inputs, out_specs, attrs=None):
    helper = LayerHelper(op_type)
    outs = {}
    ret = []
    for slot, dt in out_specs:
        v = helper.create_variable_for_type_inference(dt)
        outs[slot] = v
        ret.append(v)
    helper.append_op(op_type, inputs=inputs, outputs=outs,
                     attrs=attrs or {})
    return ret[0] if len(ret) == 1 else tuple(ret)


def sequence_pad(x, pad_value, mask=None, maxlen=None, name=None):
    inputs = {'X': x, 'PadValue': pad_value}
    if mask is not None:
        inputs['Mask'] = mask
    return _multi_out('sequence_pad', inputs,
                      [('Out', x.dtype), ('Length', 'int64')])


def sequence_unpad(x, length, name=None):
    return _multi_out('sequence_unpad', {'X': x, 'Length': length},
                      [('Out', x.dtype), ('Mask', 'float32')])


def sequence_concat(input, masks=None, name=None):
    inputs = {'X': list(input)}
    if masks is not None:
        inputs['Mask'] = list(masks)
    return _multi_out('sequence_concat', inputs,
                      [('Out', input[0].dtype), ('Mask', 'float32')])


def sequence_slice(input, offset, length, name=None):
    return _multi_out('sequence_slice',
                      {'X': input, 'Offset': offset, 'Length': length},
                      [('Out', input.dtype), ('Mask', 'float32')])


def sequence_erase(input, tokens, mask=None, name=None):
    inputs = {'X': input}
    if mask is not None:
        inputs['Mask'] = mask
    return _multi_out('sequence_erase', inputs,
                      [('Out', input.dtype), ('Mask', 'float32')],
                      {'tokens': list(tokens)})


def sequence_enumerate(input, win_size, pad_value=0, mask=None,
                       name=None):
    inputs = {'X': input}
    if mask is not None:
        inputs['Mask'] = mask
    return _multi_out('sequence_enumerate', inputs,
                      [('Out', input.dtype)],
                      {'win_size': win_size, 'pad_value': pad_value})


def sequence_reverse(x, mask=None, name=None):
    inputs = {'X': x}
    if mask is not None:
        inputs['Mask'] = mask
    return _multi_out('sequence_reverse', inputs, [('Y', x.dtype)])


def sequence_expand_as(x, y, mask=None, name=None):
    inputs = {'X': x, 'Y': y}
    if mask is not None:
        inputs['Mask'] = mask
    return _multi_out('sequence_expand_as', inputs, [('Out', x.dtype)])


def sequence_scatter(input, index, updates, mask=None, name=None):
    inputs = {'X': input, 'Ids': index, 'Updates': updates}
    if mask is not None:
        inputs['Mask'] = mask
    return _multi_out('sequence_scatter', inputs, [('Out', input.dtype)])


def lod_reset(x, y=None, target_lod=None):
    inputs = {'X': x}
    attrs = {}
    if y is not None:
        inputs['Y'] = y
    else:
        attrs['target_lod'] = list(target_lod)
    return _multi_out('lod_reset', inputs,
                      [('Out', x.dtype), ('Mask', 'float32')], attrs)
