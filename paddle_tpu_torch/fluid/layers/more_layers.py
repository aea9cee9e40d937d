"""Layers of the JAX package's layers/more_layers.py that the port
lowers: elementwise_mod and elementwise_floordiv (which
BeamSearchDecoder.step builds), im2sequence, row_conv, sum,
filter_by_instag, lod_append, sampled_softmax_with_cross_entropy,
reduce_all / reduce_any, the random layers, strided_slice, expand_as,
pad2d, maxout, autoincreased_step_counter, instance_norm, group_norm,
temporal_shift, grid_sampler, the losses log_loss, huber_loss,
kldiv_loss and mse_loss, rank, size, gaussian_random_batch_size_like,
soft_relu and image_resize_short; adaptive_pool3d, crop, crop_tensor
and deformable_conv (ROADMAP Queue 1 item 11b-A);
add_position_encoding, continuous_value_model, data_norm, hash,
scatter_nd, similarity_focus, spectral_norm, unique and
unique_with_counts (item 11b-B); roi_align, prroi_pool and
deformable_roi_pooling (item 11b-C); and brelu, selu and stanh of its
layers/extras.py.
Each appends the ops the JAX package's layer appends (reference
python/paddle/fluid/layers/nn.py and loss.py)."""

import numpy as np

from .. import initializer as init
from ..layer_helper import LayerHelper
from ..param_attr import ParamAttr

__all__ = ['elementwise_mod', 'elementwise_floordiv', 'im2sequence',
           'row_conv', 'sum', 'filter_by_instag', 'lod_append',
           'sampled_softmax_with_cross_entropy', 'reduce_all',
           'reduce_any', 'uniform_random', 'uniform_random_batch_size_like',
           'gaussian_random', 'strided_slice', 'expand_as', 'pad2d',
           'maxout', 'autoincreased_step_counter', 'brelu', 'selu',
           'stanh', 'instance_norm', 'group_norm', 'temporal_shift',
           'grid_sampler', 'log_loss', 'huber_loss', 'kldiv_loss',
           'mse_loss', 'rank', 'size', 'gaussian_random_batch_size_like',
           'soft_relu', 'image_resize_short', 'adaptive_pool3d', 'crop',
           'crop_tensor', 'deformable_conv', 'add_position_encoding',
           'continuous_value_model', 'data_norm', 'hash', 'scatter_nd',
           'similarity_focus', 'spectral_norm', 'unique',
           'unique_with_counts', 'roi_align', 'prroi_pool',
           'deformable_roi_pooling']


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


def _bool_reduce(op_type, input, dim, keep_dim, name):
    return _simple(op_type, {'X': input},
                   {'dim': list(dim) if dim is not None else [],
                    'keep_dim': keep_dim, 'reduce_all': dim is None},
                   name=name)


def reduce_all(input, dim=None, keep_dim=False, name=None):
    return _bool_reduce('reduce_all', input, dim, keep_dim, name)


def reduce_any(input, dim=None, keep_dim=False, name=None):
    return _bool_reduce('reduce_any', input, dim, keep_dim, name)


def _random(op_type, shape, dtype, attrs, name):
    helper = LayerHelper(op_type, name=name)
    out = helper.create_variable_for_type_inference(dtype)
    attrs = dict(attrs, shape=list(shape), dtype=dtype)
    helper.append_op(op_type, outputs={'Out': out}, attrs=attrs,
                     infer_shape=False)
    out.shape = tuple(shape)
    return out


def uniform_random(shape, dtype='float32', min=-1.0, max=1.0, seed=0,
                   name=None):
    """In a main program drawn on the device from the counter hash under
    the device step (ops/tensor_ops.py), so a CUDA graph replays each
    step's own draws; in a startup program from the host generator, as
    the initializers draw."""
    return _random('uniform_random', shape, dtype,
                   {'min': float(min), 'max': float(max), 'seed': seed},
                   name)


def gaussian_random(shape, mean=0.0, std=1.0, seed=0, dtype='float32',
                    name=None):
    """Drawn as uniform_random: on the device in a main program, from the
    host generator in a startup program."""
    return _random('gaussian_random', shape, dtype,
                   {'mean': float(mean), 'std': float(std), 'seed': seed},
                   name)


def uniform_random_batch_size_like(input, shape, dtype='float32',
                                   input_dim_idx=0, output_dim_idx=0,
                                   min=-1.0, max=1.0, seed=0):
    return _simple('uniform_random_batch_size_like', {'Input': input},
                   {'shape': list(shape), 'dtype': dtype,
                    'input_dim_idx': input_dim_idx,
                    'output_dim_idx': output_dim_idx,
                    'min': float(min), 'max': float(max), 'seed': seed},
                   dtype=dtype)


def strided_slice(input, axes, starts, ends, strides, name=None):
    return _simple('strided_slice', {'Input': input},
                   {'axes': list(axes), 'starts': list(starts),
                    'ends': list(ends), 'strides': list(strides)},
                   name=name)


def expand_as(x, target_tensor, name=None):
    return _simple('expand_as', {'X': x, 'target_tensor': target_tensor},
                   name=name)


def pad2d(input, paddings=(0, 0, 0, 0), mode='constant', pad_value=0.0,
          data_format='NCHW', name=None):
    return _simple('pad2d', {'X': input},
                   {'paddings': list(paddings), 'mode': mode,
                    'pad_value': pad_value, 'data_format': data_format},
                   name=name)


def maxout(x, groups, name=None, axis=1):
    return _simple('maxout', {'X': x}, {'groups': groups, 'axis': axis},
                   name=name)


def brelu(x, t_min=0.0, t_max=24.0, name=None):
    return _simple('brelu', {'X': x}, {'t_min': t_min, 't_max': t_max},
                   name=name)


def selu(x, scale=None, alpha=None, name=None):
    attrs = {}
    if scale is not None:
        attrs['scale'] = scale
    if alpha is not None:
        attrs['alpha'] = alpha
    return _simple('selu', {'X': x}, attrs, name=name)


def stanh(x, scale_a=0.67, scale_b=1.7159, name=None):
    return _simple('stanh', {'X': x},
                   {'scale_a': scale_a, 'scale_b': scale_b}, name=name)


def autoincreased_step_counter(counter_name=None, begin=1, step=1):
    """The persistable int64 [1] counter `counter_name`, begin on the
    first run: the startup program fills begin - step and an increment
    op at the head of the main program adds step each run."""
    helper = LayerHelper('global_step_counter')
    name = counter_name or '@STEP_COUNTER@'
    block = helper.main_program.global_block()
    counter = block._find_var_recursive(name)
    if counter is None:
        counter = block.create_var(name=name, shape=(1,), dtype='int64',
                                   persistable=True)
        sb = helper.startup_program.global_block()
        sb.create_var(name=name, shape=(1,), dtype='int64',
                      persistable=True)
        sb.append_op('fill_constant', outputs={'Out': name},
                     attrs={'shape': [1], 'dtype': 'int64',
                            'value': float(begin - step)})
        block._prepend_op('increment', inputs={'X': counter},
                          outputs={'Out': counter},
                          attrs={'step': float(step)})
        counter.stop_gradient = True
    return counter


def instance_norm(input, epsilon=1e-5, param_attr=None, bias_attr=None,
                  name=None):
    helper = LayerHelper('instance_norm', name=name)
    c = input.shape[1]
    scale = helper.create_parameter(param_attr, [c], input.dtype,
                                    default_initializer=init.Constant(1.0))
    bias = helper.create_parameter(bias_attr, [c], input.dtype,
                                   is_bias=True)
    out, saved_mean, saved_var = (
        helper.create_variable_for_type_inference(input.dtype)
        for _ in range(3))
    helper.append_op('instance_norm',
                     inputs={'X': input, 'Scale': scale, 'Bias': bias},
                     outputs={'Y': out, 'SavedMean': saved_mean,
                              'SavedVariance': saved_var},
                     attrs={'epsilon': epsilon})
    return out


def group_norm(input, groups, epsilon=1e-5, param_attr=None,
               bias_attr=None, act=None, data_layout='NCHW', name=None):
    helper = LayerHelper('group_norm', name=name)
    c = input.shape[1 if data_layout == 'NCHW' else -1]
    scale = helper.create_parameter(param_attr, [c], input.dtype,
                                    default_initializer=init.Constant(1.0))
    bias = helper.create_parameter(bias_attr, [c], input.dtype,
                                   is_bias=True)
    out, mean, var = (helper.create_variable_for_type_inference(input.dtype)
                      for _ in range(3))
    helper.append_op('group_norm',
                     inputs={'X': input, 'Scale': scale, 'Bias': bias},
                     outputs={'Y': out, 'Mean': mean, 'Variance': var},
                     attrs={'epsilon': epsilon, 'groups': groups,
                            'data_layout': data_layout})
    return helper.append_activation(out, act)


def temporal_shift(x, seg_num, shift_ratio=0.25, name=None):
    # no shape inference: the dummy batch does not divide seg_num
    return _simple('temporal_shift', {'X': x},
                   {'seg_num': seg_num, 'shift_ratio': shift_ratio},
                   name=name, shape=x.shape)


def grid_sampler(x, grid, name=None):
    return _simple('grid_sampler', {'X': x, 'Grid': grid}, name=name)


def log_loss(input, label, epsilon=1e-4, name=None):
    return _simple('log_loss', {'Predicted': input, 'Labels': label},
                   {'epsilon': epsilon}, out_slot='Loss', name=name)


def huber_loss(input, label, delta, name=None):
    helper = LayerHelper('huber_loss', name=name)
    out = helper.create_variable_for_type_inference(input.dtype)
    resid = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op('huber_loss', inputs={'X': input, 'Y': label},
                     outputs={'Out': out, 'Residual': resid},
                     attrs={'delta': delta})
    return out


def kldiv_loss(x, target, reduction='mean', name=None):
    return _simple('kldiv_loss', {'X': x, 'Target': target},
                   {'reduction': reduction}, out_slot='Loss', name=name)


def mse_loss(input, label, name=None):
    return _simple('mse_loss', {'X': input, 'Y': label}, name=name)


def rank(input, name=None):
    return _simple('rank', {'Input': input}, dtype='int32', name=name)


def size(input, name=None):
    return _simple('size', {'Input': input}, dtype='int64', name=name)


def gaussian_random_batch_size_like(input, shape, input_dim_idx=0,
                                    output_dim_idx=0, mean=0.0, std=1.0,
                                    seed=0, dtype='float32'):
    """Drawn on the device from the counter hash under the device step,
    in any program (ops/misc_ops.py)."""
    return _simple('gaussian_random_batch_size_like', {'Input': input},
                   {'shape': list(shape), 'dtype': dtype,
                    'input_dim_idx': input_dim_idx,
                    'output_dim_idx': output_dim_idx,
                    'mean': float(mean), 'std': float(std), 'seed': seed},
                   dtype=dtype)


def soft_relu(x, threshold=40.0, name=None):
    return _simple('soft_relu', {'X': x}, {'threshold': threshold},
                   name=name)


def image_resize_short(input, out_short_len, resample='BILINEAR'):
    """image_resize with the shorter of H and W brought to
    out_short_len, the other scaled alike and rounded."""
    from . import nn as _nn
    h, w = input.shape[2], input.shape[3]
    scale = float(out_short_len) / float(min(h, w))
    return _nn.image_resize(input, out_shape=[int(round(h * scale)),
                                              int(round(w * scale))],
                            resample=resample)


def adaptive_pool3d(input, pool_size, pool_type='max',
                    require_index=False, name=None):
    return _simple('pool3d', {'X': input},
                   {'pooling_type': pool_type,
                    'ksize': list(pool_size) if isinstance(
                        pool_size, (list, tuple)) else [pool_size] * 3,
                    'adaptive': True}, name=name)


def crop(x, shape=None, offsets=None, name=None):
    attrs = {}
    if isinstance(shape, (list, tuple)):
        attrs['shape'] = list(shape)
    if isinstance(offsets, (list, tuple)):
        attrs['offsets'] = list(offsets)
    return _simple('crop', {'X': x}, attrs, name=name)


def crop_tensor(x, shape=None, offsets=None, name=None):
    ins = {'X': x}
    attrs = {}
    from ..framework import Variable
    if isinstance(shape, Variable):
        ins['Shape'] = shape
    elif shape is not None:
        attrs['shape'] = list(shape)
    if isinstance(offsets, Variable):
        ins['Offsets'] = offsets
    elif offsets is not None:
        attrs['offsets'] = list(offsets)
    return _simple('crop_tensor', ins, attrs, name=name)


def deformable_conv(input, offset, mask, num_filters, filter_size,
                    stride=1, padding=0, dilation=1, groups=1,
                    deformable_groups=1, im2col_step=1, param_attr=None,
                    bias_attr=None, modulated=True, name=None):
    helper = LayerHelper('deformable_conv', name=name)

    def _pair(v):
        return list(v) if isinstance(v, (list, tuple)) else [v, v]
    c_in = input.shape[1]
    fs = _pair(filter_size)
    w = helper.create_parameter(
        param_attr, [num_filters, c_in // groups] + fs, input.dtype)
    ins = {'Input': input, 'Offset': offset, 'Filter': w}
    if modulated and mask is not None:
        ins['Mask'] = mask
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op('deformable_conv' if modulated else
                     'deformable_conv_v1', inputs=ins,
                     outputs={'Output': out},
                     attrs={'strides': _pair(stride),
                            'paddings': _pair(padding),
                            'dilations': _pair(dilation),
                            'groups': groups,
                            'deformable_groups': deformable_groups,
                            'im2col_step': im2col_step},
                     infer_shape=False)
    if bias_attr is not False:
        out = helper.append_bias_op(out, dim_start=1, dim_end=2,
                                    bias_attr=bias_attr)
    return out


def add_position_encoding(input, alpha=1.0, beta=1.0, name=None):
    return _simple('add_position_encoding', {'X': input},
                   {'alpha': alpha, 'beta': beta}, name=name)


def continuous_value_model(input, cvm, use_cvm=True):
    return _simple('continuous_value_model',
                   {'X': input, 'CVM': cvm}, {'use_cvm': use_cvm})


def data_norm(input, act=None, epsilon=1e-5, param_attr=None,
              data_layout='NCHW', in_place=False, name=None,
              moving_mean_name=None, moving_variance_name=None,
              do_model_average_for_mean_and_var=False):
    helper = LayerHelper('data_norm', name=name)
    c = input.shape[-1]
    batch_size = helper.create_parameter(
        ParamAttr(name=name + '.batch_size' if name else None), [c],
        input.dtype, default_initializer=init.Constant(1e4))
    batch_sum = helper.create_parameter(
        ParamAttr(name=name + '.batch_sum' if name else None), [c],
        input.dtype, default_initializer=init.Constant(0.0))
    batch_square = helper.create_parameter(
        ParamAttr(name=name + '.batch_square_sum' if name else None),
        [c], input.dtype, default_initializer=init.Constant(1e4))
    out = helper.create_variable_for_type_inference(input.dtype)
    means = helper.create_variable_for_type_inference(input.dtype)
    scales = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op('data_norm',
                     inputs={'X': input, 'BatchSize': batch_size,
                             'BatchSum': batch_sum,
                             'BatchSquareSum': batch_square},
                     outputs={'Y': out, 'Means': means,
                              'Scales': scales},
                     attrs={'epsilon': epsilon})
    return helper.append_activation(out, act)


def hash(input, hash_size, num_hash=1, name=None):
    return _simple('hash', {'X': input},
                   {'mod_by': hash_size, 'num_hash': num_hash},
                   dtype='int32', name=name)


def scatter_nd(index, updates, shape, name=None):
    return _simple('scatter_nd', {'Index': index, 'Updates': updates},
                   {'shape': list(shape)}, dtype=updates.dtype,
                   name=name)


def similarity_focus(input, axis, indexes, name=None):
    return _simple('similarity_focus', {'X': input},
                   {'axis': axis, 'indexes': list(indexes)}, name=name)


def spectral_norm(weight, dim=0, power_iters=1, eps=1e-12, name=None):
    helper = LayerHelper('spectral_norm', name=name)
    h = weight.shape[dim]
    w = int(np.prod(weight.shape)) // h
    u = helper.create_parameter(
        ParamAttr(trainable=False), [h], weight.dtype,
        default_initializer=init.Normal(0.0, 1.0))
    v = helper.create_parameter(
        ParamAttr(trainable=False), [w], weight.dtype,
        default_initializer=init.Normal(0.0, 1.0))
    out = helper.create_variable_for_type_inference(weight.dtype)
    helper.append_op('spectral_norm',
                     inputs={'Weight': weight, 'U': u, 'V': v},
                     outputs={'Out': out},
                     attrs={'dim': dim, 'power_iters': power_iters,
                            'eps': eps})
    return out


def unique(x, dtype='int32'):
    helper = LayerHelper('unique')
    out = helper.create_variable_for_type_inference(x.dtype)
    index = helper.create_variable_for_type_inference(dtype)
    helper.append_op('unique', inputs={'X': x},
                     outputs={'Out': out, 'Index': index},
                     infer_shape=False)
    return out, index


def unique_with_counts(x, dtype='int32'):
    helper = LayerHelper('unique_with_counts')
    out = helper.create_variable_for_type_inference(x.dtype)
    index = helper.create_variable_for_type_inference(dtype)
    count = helper.create_variable_for_type_inference(dtype)
    helper.append_op('unique_with_counts', inputs={'X': x},
                     outputs={'Out': out, 'Index': index,
                              'Count': count},
                     infer_shape=False)
    return out, index, count


def roi_align(input, rois, pooled_height=1, pooled_width=1,
              spatial_scale=1.0, sampling_ratio=-1, name=None,
              rois_num=None):
    ins = {'X': input, 'ROIs': rois}
    if rois_num is not None:
        ins['RoisBatch'] = rois_num
    return _simple('roi_align', ins,
                   {'pooled_height': pooled_height,
                    'pooled_width': pooled_width,
                    'spatial_scale': spatial_scale,
                    'sampling_ratio': sampling_ratio}, name=name)


def prroi_pool(input, rois, spatial_scale=1.0, pooled_height=1,
               pooled_width=1, batch_roi_nums=None, name=None):
    ins = {'X': input, 'ROIs': rois}
    if batch_roi_nums is not None:
        ins['BatchRoINums'] = batch_roi_nums
    return _simple('prroi_pool', ins,
                   {'spatial_scale': spatial_scale,
                    'pooled_height': pooled_height,
                    'pooled_width': pooled_width}, name=name)


def deformable_roi_pooling(input, rois, trans, no_trans=False,
                           spatial_scale=1.0, group_size=(1, 1),
                           pooled_height=1, pooled_width=1,
                           part_size=None, sample_per_part=1,
                           trans_std=0.1, position_sensitive=False,
                           name=None):
    helper = LayerHelper('deformable_roi_pooling', name=name)
    out = helper.create_variable_for_type_inference(input.dtype)
    top = helper.create_variable_for_type_inference(input.dtype)
    ins = {'X': input, 'ROIs': rois}
    if not no_trans and trans is not None:
        ins['Trans'] = trans
    helper.append_op('deformable_roi_pooling', inputs=ins,
                     outputs={'Output': out, 'TopCount': top},
                     attrs={'spatial_scale': spatial_scale,
                            'pooled_height': pooled_height,
                            'pooled_width': pooled_width,
                            'trans_std': trans_std},
                     infer_shape=False)
    return out
