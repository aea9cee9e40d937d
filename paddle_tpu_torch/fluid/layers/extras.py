"""Layers of the JAX package's layers/extras.py that the port lowers:
the 3-D convolution and pooling, trilinear resize and pixel layers
(ROADMAP Queue 1 item 11b-A), the ranking, distillation and misc
losses and helpers (item 11b-B), and the RoI pools and detection
anchors (item 11b-C); its brelu, selu and stanh
are in layers/more_layers.py, and crop_tensor is more_layers.py's, as
in the JAX package's namespace.  Each appends the ops the JAX package's
layer appends (reference python/paddle/fluid/layers/nn.py, detection.py
and loss.py entries of the same names)."""

from ..layer_helper import LayerHelper

__all__ = ['conv3d', 'conv3d_transpose', 'pool3d', 'resize_trilinear',
           'pixel_shuffle', 'shuffle_channel', 'space_to_depth',
           'affine_channel', 'affine_grid', 'unfold', 'spp', 'rank_loss',
           'margin_rank_loss', 'hinge_loss', 'bpr_loss',
           'modified_huber_loss', 'teacher_student_sigmoid_loss',
           'center_loss', 'cvm', 'npair_loss', 'mean_iou', 'shard_index',
           'multiplex', 'bilinear_tensor_product', 'sampling_id',
           'random_crop', 'scatter_nd_add', 'pad_constant_like',
           'fsp_matrix', 'roi_pool', 'psroi_pool', 'anchor_generator',
           'density_prior_box', 'box_clip', 'bipartite_match']


def _simple(op_type, inputs, outputs_spec, attrs=None, dtype=None,
            name=None, infer_shape=True):
    helper = LayerHelper(op_type, name=name)
    outs = {}
    ret = []
    for slot, dt in outputs_spec:
        v = helper.create_variable_for_type_inference(dt)
        outs[slot] = v
        ret.append(v)
    helper.append_op(op_type, inputs=inputs, outputs=outs,
                     attrs=attrs or {}, infer_shape=infer_shape)
    return ret[0] if len(ret) == 1 else tuple(ret)


# ------------------------------------------------------------------ 3-D

def conv3d(input, num_filters, filter_size, stride=1, padding=0,
           dilation=1, groups=None, param_attr=None, bias_attr=None,
           act=None, name=None):
    helper = LayerHelper('conv3d', param_attr=param_attr,
                         bias_attr=bias_attr, act=act, name=name)
    groups = groups or 1
    fs = filter_size if isinstance(filter_size, (list, tuple)) \
        else [filter_size] * 3
    w = helper.create_parameter(
        param_attr,
        shape=[num_filters, input.shape[1] // groups] + list(fs),
        dtype=input.dtype)
    out = helper.create_variable_for_type_inference(input.dtype)
    st = stride if isinstance(stride, (list, tuple)) else [stride] * 3
    pd = padding if isinstance(padding, (list, tuple)) else [padding] * 3
    dl = dilation if isinstance(dilation, (list, tuple)) \
        else [dilation] * 3
    helper.append_op('conv3d', inputs={'Input': input, 'Filter': w},
                     outputs={'Output': out},
                     attrs={'strides': list(st), 'paddings': list(pd),
                            'dilations': list(dl), 'groups': groups})
    out = helper.append_bias_op(out, dim_start=1, dim_end=2,
                                bias_attr=bias_attr)
    return helper.append_activation(out, act)


def conv3d_transpose(input, num_filters, filter_size, stride=1, padding=0,
                     groups=None, param_attr=None, bias_attr=None,
                     act=None, name=None):
    helper = LayerHelper('conv3d_transpose', param_attr=param_attr,
                         bias_attr=bias_attr, act=act, name=name)
    groups = groups or 1
    fs = filter_size if isinstance(filter_size, (list, tuple)) \
        else [filter_size] * 3
    w = helper.create_parameter(
        param_attr,
        shape=[input.shape[1], num_filters // groups] + list(fs),
        dtype=input.dtype)
    out = helper.create_variable_for_type_inference(input.dtype)
    st = stride if isinstance(stride, (list, tuple)) else [stride] * 3
    pd = padding if isinstance(padding, (list, tuple)) else [padding] * 3
    helper.append_op('conv3d_transpose',
                     inputs={'Input': input, 'Filter': w},
                     outputs={'Output': out},
                     attrs={'strides': list(st), 'paddings': list(pd),
                            'groups': groups})
    return helper.append_activation(out, act)


def pool3d(input, pool_size=2, pool_type='max', pool_stride=None,
           pool_padding=0, global_pooling=False, name=None):
    ks = pool_size if isinstance(pool_size, (list, tuple)) \
        else [pool_size] * 3
    st = pool_stride or ks
    st = st if isinstance(st, (list, tuple)) else [st] * 3
    pd = pool_padding if isinstance(pool_padding, (list, tuple)) \
        else [pool_padding] * 3
    return _simple('pool3d', {'X': input}, [('Out', input.dtype)],
                   {'pooling_type': pool_type, 'ksize': list(ks),
                    'strides': list(st), 'paddings': list(pd),
                    'global_pooling': global_pooling}, name=name)


def resize_trilinear(input, out_shape, align_corners=True, name=None):
    d, h, w = out_shape
    return _simple('trilinear_interp', {'X': input},
                   [('Out', input.dtype)],
                   {'out_d': d, 'out_h': h, 'out_w': w,
                    'align_corners': align_corners}, name=name)


# ---------------------------------------------------------------- vision

def pixel_shuffle(x, upscale_factor, name=None):
    return _simple('pixel_shuffle', {'X': x}, [('Out', x.dtype)],
                   {'upscale_factor': upscale_factor}, name=name)


def shuffle_channel(x, group, name=None):
    return _simple('shuffle_channel', {'X': x}, [('Out', x.dtype)],
                   {'group': group}, name=name)


def space_to_depth(x, blocksize, name=None):
    return _simple('space_to_depth', {'X': x}, [('Out', x.dtype)],
                   {'blocksize': blocksize}, name=name)


def affine_channel(x, scale=None, bias=None, data_layout='NCHW',
                   name=None):
    return _simple('affine_channel',
                   {'X': x, 'Scale': scale, 'Bias': bias},
                   [('Out', x.dtype)], {'data_layout': data_layout},
                   name=name)


def affine_grid(theta, out_shape, name=None):
    inputs = {'Theta': theta}
    attrs = {}
    if hasattr(out_shape, 'name'):
        inputs['OutputShape'] = out_shape
    else:
        attrs['output_shape'] = list(out_shape)
    return _simple('affine_grid', inputs, [('Output', theta.dtype)],
                   attrs, name=name)


def unfold(x, kernel_sizes, strides=1, paddings=0, dilations=1,
           name=None):
    ks = kernel_sizes if isinstance(kernel_sizes, (list, tuple)) \
        else [kernel_sizes] * 2
    st = strides if isinstance(strides, (list, tuple)) else [strides] * 2
    pd = paddings if isinstance(paddings, (list, tuple)) \
        else [paddings] * 2
    dl = dilations if isinstance(dilations, (list, tuple)) \
        else [dilations] * 2
    return _simple('unfold', {'X': x}, [('Y', x.dtype)],
                   {'kernel_sizes': list(ks), 'strides': list(st),
                    'paddings': list(pd), 'dilations': list(dl)},
                   name=name)


def spp(input, pyramid_height=3, pool_type='max', name=None):
    return _simple('spp', {'X': input}, [('Out', input.dtype)],
                   {'pyramid_height': pyramid_height,
                    'pooling_type': pool_type}, name=name)


# ------------------------------------------------------ RoI pools

def roi_pool(input, rois, pooled_height=1, pooled_width=1,
             spatial_scale=1.0, rois_batch=None, name=None):
    inputs = {'X': input, 'ROIs': rois}
    if rois_batch is not None:
        inputs['RoisBatch'] = rois_batch
    out, argmax = _simple('roi_pool', inputs,
                          [('Out', input.dtype), ('Argmax', 'int64')],
                          {'pooled_height': pooled_height,
                           'pooled_width': pooled_width,
                           'spatial_scale': spatial_scale}, name=name)
    return out


def psroi_pool(input, rois, output_channels, spatial_scale,
               pooled_height, pooled_width, rois_batch=None, name=None):
    inputs = {'X': input, 'ROIs': rois}
    if rois_batch is not None:
        inputs['RoisBatch'] = rois_batch
    return _simple('psroi_pool', inputs, [('Out', input.dtype)],
                   {'output_channels': output_channels,
                    'spatial_scale': spatial_scale,
                    'pooled_height': pooled_height,
                    'pooled_width': pooled_width}, name=name)


# -------------------------------------------------------------- detection

def anchor_generator(input, anchor_sizes, aspect_ratios, stride,
                     variance=(0.1, 0.1, 0.2, 0.2), offset=0.5,
                     name=None):
    return _simple('anchor_generator', {'Input': input},
                   [('Anchors', input.dtype), ('Variances', input.dtype)],
                   {'anchor_sizes': list(anchor_sizes),
                    'aspect_ratios': list(aspect_ratios),
                    'stride': list(stride), 'variances': list(variance),
                    'offset': offset}, name=name)


def density_prior_box(input, image, fixed_sizes, fixed_ratios, densities,
                      variance=(0.1, 0.1, 0.2, 0.2), offset=0.5,
                      name=None):
    return _simple('density_prior_box', {'Input': input, 'Image': image},
                   [('Boxes', input.dtype), ('Variances', input.dtype)],
                   {'fixed_sizes': list(fixed_sizes),
                    'fixed_ratios': list(fixed_ratios),
                    'densities': list(densities),
                    'variances': list(variance), 'offset': offset},
                   name=name)


def box_clip(input, im_info, name=None):
    return _simple('box_clip', {'Input': input, 'ImInfo': im_info},
                   [('Output', input.dtype)], name=name)


def bipartite_match(dist_matrix, match_type='bipartite',
                    dist_threshold=0.5, name=None):
    return _simple('bipartite_match', {'DistMat': dist_matrix},
                   [('ColToRowMatchIndices', 'int32'),
                    ('ColToRowMatchDist', 'float32')],
                   {'match_type': match_type,
                    'dist_threshold': dist_threshold}, name=name,
                   infer_shape=False)


# ---------------------------------------------------------------- losses

def rank_loss(label, left, right, name=None):
    return _simple('rank_loss',
                   {'Label': label, 'Left': left, 'Right': right},
                   [('Out', left.dtype)], name=name)


def margin_rank_loss(label, left, right, margin=0.1, name=None):
    out, _ = _simple('margin_rank_loss',
                     {'Label': label, 'X1': left, 'X2': right},
                     [('Out', left.dtype), ('Activated', left.dtype)],
                     {'margin': margin}, name=name)
    return out


def hinge_loss(input, label, name=None):
    return _simple('hinge_loss', {'Logits': input, 'Labels': label},
                   [('Loss', input.dtype)], name=name)


def bpr_loss(input, label, name=None):
    return _simple('bpr_loss', {'X': input, 'Label': label},
                   [('Y', input.dtype)], name=name)


def modified_huber_loss(input, label, name=None):
    out, _ = _simple('modified_huber_loss', {'X': input, 'Y': label},
                     [('Out', input.dtype),
                      ('IntermediateVal', input.dtype)], name=name)
    return out


def teacher_student_sigmoid_loss(input, label, name=None):
    return _simple('teacher_student_sigmoid_loss',
                   {'X': input, 'Label': label}, [('Y', input.dtype)],
                   name=name)


def center_loss(input, label, num_classes, alpha=0.5, param_attr=None,
                update_center=True, name=None):
    helper = LayerHelper('center_loss', param_attr=param_attr, name=name)
    centers = helper.create_parameter(
        param_attr, shape=[num_classes, input.shape[-1]],
        dtype=input.dtype)
    loss = helper.create_variable_for_type_inference(input.dtype)
    diff = helper.create_variable_for_type_inference(input.dtype)
    new_c = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op('center_loss',
                     inputs={'X': input, 'Label': label,
                             'Centers': centers},
                     outputs={'Loss': loss, 'SampleCenterDiff': diff,
                              'CentersOut': new_c},
                     attrs={'alpha': alpha,
                            'need_update': update_center})
    return loss


def cvm(input, use_cvm=True, name=None):
    return _simple('cvm', {'X': input}, [('Y', input.dtype)],
                   {'use_cvm': use_cvm}, name=name)


def npair_loss(anchor, positive, labels, l2_reg=0.002):
    """Composed loss (reference layers/loss.py npair_loss): cross entropy
    over anchor·positiveᵀ similarities + L2 on embeddings."""
    from . import nn as _nn
    from . import ops as _ops
    batch = anchor.shape[0]
    sim = _nn.matmul(anchor, positive, transpose_y=True)
    prob = _nn.softmax(sim)
    ce = _nn.cross_entropy(prob, _nn.reshape(labels, [-1, 1]))
    l2 = _ops.scale(
        _nn.reduce_sum(_ops.square(anchor) + _ops.square(positive)),
        scale=l2_reg * 0.25 / batch)
    return _nn.elementwise_add(_nn.reduce_mean(ce), l2)


# ------------------------------------------------------------------ misc

def mean_iou(input, label, num_classes, name=None):
    return _simple('mean_iou', {'Predictions': input, 'Labels': label},
                   [('OutMeanIou', 'float32'), ('OutWrong', 'int32'),
                    ('OutCorrect', 'int32')],
                   {'num_classes': num_classes}, name=name,
                   infer_shape=False)


def shard_index(input, index_num, nshards, shard_id, ignore_value=-1,
                name=None):
    return _simple('shard_index', {'X': input}, [('Out', input.dtype)],
                   {'index_num': index_num, 'nshards': nshards,
                    'shard_id': shard_id, 'ignore_value': ignore_value},
                   name=name)


def multiplex(inputs, index, name=None):
    return _simple('multiplex', {'Ids': index, 'X': list(inputs)},
                   [('Out', inputs[0].dtype)], name=name)


def bilinear_tensor_product(x, y, size, param_attr=None, bias_attr=None,
                            act=None, name=None):
    helper = LayerHelper('bilinear_tensor_product', param_attr=param_attr,
                         bias_attr=bias_attr, act=act, name=name)
    w = helper.create_parameter(
        param_attr, shape=[size, x.shape[-1], y.shape[-1]],
        dtype=x.dtype)
    out = helper.create_variable_for_type_inference(x.dtype)
    inputs = {'X': x, 'Y': y, 'Weight': w}
    if bias_attr is not False:
        b = helper.create_parameter(bias_attr, shape=[size],
                                    dtype=x.dtype, is_bias=True)
        inputs['Bias'] = b
    helper.append_op('bilinear_tensor_product', inputs=inputs,
                     outputs={'Out': out})
    return helper.append_activation(out, act)


def sampling_id(x, min=0.0, max=1.0, seed=0, name=None):
    return _simple('sampling_id', {'X': x}, [('Out', 'int64')],
                   {'seed': seed}, name=name)


def random_crop(x, shape, seed=None, name=None):
    out, _ = _simple('random_crop', {'X': x},
                     [('Out', x.dtype), ('SeedOut', 'int64')],
                     {'shape': list(shape)}, name=name)
    return out


def scatter_nd_add(ref, index, updates, name=None):
    return _simple('scatter_nd_add',
                   {'X': ref, 'Index': index, 'Updates': updates},
                   [('Out', ref.dtype)], name=name)


def pad_constant_like(x, y, pad_value=0.0, name=None):
    return _simple('pad_constant_like', {'X': x, 'Y': y},
                   [('Out', y.dtype)], {'pad_value': pad_value},
                   name=name)


def fsp_matrix(x, y):
    return _simple('fsp', {'X': x, 'Y': y}, [('Out', x.dtype)])
