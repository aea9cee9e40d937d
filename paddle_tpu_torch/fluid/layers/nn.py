"""Neural-net layers: the subset BERT pretraining, the CTR models, the
image classifiers and gradient clipping build.  Reference:
python/paddle/fluid/layers/nn.py.

Each layer appends IR ops via LayerHelper exactly like the reference
(e.g. fc at layers/nn.py:207) and the JAX package, so both packages
build the same Program.
"""

import numpy as np

from ..initializer import Constant, Normal
from ..layer_helper import LayerHelper
from ..param_attr import ParamAttr

__all__ = ['fc', 'embedding', 'conv2d', 'pool2d', 'batch_norm',
           'layer_norm', 'dropout', 'softmax', 'log_softmax',
           'cross_entropy', 'matmul', 'elementwise_add', 'elementwise_sub',
           'elementwise_mul', 'elementwise_div', 'elementwise_min',
           'elementwise_max', 'reduce_sum', 'reshape', 'squeeze',
           'unsqueeze', 'transpose', 'stack', 'split', 'expand', 'gather',
           'softmax_with_cross_entropy',
           'sigmoid_cross_entropy_with_logits', 'mean', 'slice', 'topk',
           'accuracy', 'one_hot', 'label_smooth']


def fc(input, size, num_flatten_dims=1, param_attr=None, bias_attr=None,
       act=None, name=None):
    """Reference layers/nn.py:207."""
    helper = LayerHelper('fc', param_attr=param_attr, bias_attr=bias_attr,
                         act=act, name=name)
    inputs = input if isinstance(input, (list, tuple)) else [input]
    mul_results = []
    for inp in inputs:
        in_shape = inp.shape
        param_shape = [int(np.prod(in_shape[num_flatten_dims:]))] + [size]
        w = helper.create_parameter(param_attr, shape=param_shape,
                                    dtype=inp.dtype)
        tmp = helper.create_variable_for_type_inference(inp.dtype)
        helper.append_op('mul', inputs={'X': inp, 'Y': w},
                         outputs={'Out': tmp},
                         attrs={'x_num_col_dims': num_flatten_dims,
                                'y_num_col_dims': 1})
        mul_results.append(tmp)
    if len(mul_results) == 1:
        pre_bias = mul_results[0]
    else:
        pre_bias = helper.create_variable_for_type_inference(
            mul_results[0].dtype)
        helper.append_op('sum', inputs={'X': mul_results},
                         outputs={'Out': pre_bias})
    pre_act = helper.append_bias_op(pre_bias, dim_start=num_flatten_dims,
                                    bias_attr=bias_attr)
    return helper.append_activation(pre_act, act)


def embedding(input, size, is_sparse=False, is_distributed=False,
              padding_idx=None, param_attr=None, dtype='float32'):
    """Reference layers/nn.py embedding (lookup_table_v2)."""
    helper = LayerHelper('embedding', param_attr=param_attr)
    w = helper.create_parameter(param_attr, shape=list(size), dtype=dtype)
    out = helper.create_variable_for_type_inference(dtype)
    padding_idx = -1 if padding_idx is None else (
        padding_idx if padding_idx >= 0 else size[0] + padding_idx)
    helper.append_op('lookup_table_v2'
                     if (input.shape and input.shape[-1] != 1)
                     else 'lookup_table',
                     inputs={'W': w, 'Ids': input},
                     outputs={'Out': out},
                     attrs={'padding_idx': padding_idx,
                            'is_sparse': is_sparse,
                            'is_distributed': is_distributed})
    return out


def _pair_list(v):
    return [v, v] if isinstance(v, int) else list(v)


def conv2d(input, num_filters, filter_size, stride=1, padding=0, dilation=1,
           groups=None, param_attr=None, bias_attr=None, use_cudnn=True,
           act=None, name=None, data_format='NCHW'):
    """Reference layers/nn.py conv2d: an OIHW filter initialised
    Normal(0, sqrt(2 / fan_in)), depthwise_conv2d where groups equals
    both channel counts, the bias over the channel axis, then act."""
    helper = LayerHelper('conv2d', param_attr=param_attr,
                         bias_attr=bias_attr, act=act, name=name)
    groups = groups or 1
    channel_axis = 1 if data_format == 'NCHW' else 3
    num_channels = input.shape[channel_axis]
    filter_size = _pair_list(filter_size)
    filter_shape = [num_filters, num_channels // groups] + filter_size
    fan_in = (num_channels // groups) * int(np.prod(filter_size))
    w = helper.create_parameter(
        param_attr, shape=filter_shape, dtype=input.dtype,
        default_initializer=Normal(0.0, (2.0 / fan_in) ** 0.5))
    out = helper.create_variable_for_type_inference(input.dtype)
    depthwise = groups == num_channels and groups == num_filters and \
        groups > 1
    helper.append_op(
        'depthwise_conv2d' if depthwise else 'conv2d',
        inputs={'Input': input, 'Filter': w}, outputs={'Output': out},
        attrs={'strides': _pair_list(stride),
               'paddings': _pair_list(padding),
               'dilations': _pair_list(dilation),
               'groups': groups, 'data_format': data_format})
    pre_act = helper.append_bias_op(out, dim_start=channel_axis,
                                    dim_end=channel_axis + 1,
                                    bias_attr=bias_attr)
    return helper.append_activation(pre_act, act)


def pool2d(input, pool_size=-1, pool_type='max', pool_stride=1,
           pool_padding=0, global_pooling=False, use_cudnn=True,
           ceil_mode=False, exclusive=True, name=None, data_format='NCHW'):
    helper = LayerHelper('pool2d', name=name)
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op(
        'pool2d', inputs={'X': input}, outputs={'Out': out},
        attrs={'pooling_type': pool_type, 'ksize': _pair_list(pool_size),
               'strides': _pair_list(pool_stride),
               'paddings': _pair_list(pool_padding),
               'global_pooling': global_pooling, 'ceil_mode': ceil_mode,
               'exclusive': exclusive, 'data_format': data_format})
    return out


def batch_norm(input, act=None, is_test=False, momentum=0.9, epsilon=1e-5,
               param_attr=None, bias_attr=None, data_layout='NCHW',
               in_place=False, name=None, moving_mean_name=None,
               moving_variance_name=None,
               do_model_average_for_mean_and_var=False,
               use_global_stats=False):
    """Reference layers/nn.py batch_norm: scale (1) and bias (0)
    parameters, and the moving mean (0) and variance (1) as
    non-trainable persistable parameters that the op writes in place
    (MeanOut / VarianceOut)."""
    helper = LayerHelper('batch_norm', name=name)
    dtype = input.dtype
    channel_axis = 1 if data_layout == 'NCHW' else len(input.shape) - 1
    c = input.shape[channel_axis]
    scale = helper.create_parameter(param_attr, shape=[c], dtype=dtype,
                                    default_initializer=Constant(1.0))
    bias = helper.create_parameter(bias_attr, shape=[c], dtype=dtype,
                                   is_bias=True)
    mean = helper.create_parameter(
        ParamAttr(name=moving_mean_name, trainable=False),
        shape=[c], dtype=dtype, default_initializer=Constant(0.0))
    mean.stop_gradient = True
    variance = helper.create_parameter(
        ParamAttr(name=moving_variance_name, trainable=False),
        shape=[c], dtype=dtype, default_initializer=Constant(1.0))
    variance.stop_gradient = True
    out = helper.create_variable_for_type_inference(dtype)
    saved_mean = helper.create_variable_for_type_inference(
        dtype, stop_gradient=True)
    saved_var = helper.create_variable_for_type_inference(
        dtype, stop_gradient=True)
    helper.append_op(
        'batch_norm',
        inputs={'X': input, 'Scale': scale, 'Bias': bias, 'Mean': mean,
                'Variance': variance},
        outputs={'Y': out, 'MeanOut': mean, 'VarianceOut': variance,
                 'SavedMean': saved_mean, 'SavedVariance': saved_var},
        attrs={'momentum': momentum, 'epsilon': epsilon, 'is_test': is_test,
               'data_layout': data_layout,
               'use_global_stats': use_global_stats})
    return helper.append_activation(out, act)


def layer_norm(input, scale=True, shift=True, begin_norm_axis=1,
               epsilon=1e-5, param_attr=None, bias_attr=None, act=None,
               name=None):
    helper = LayerHelper('layer_norm', name=name)
    dtype = input.dtype
    norm_shape = [int(np.prod(input.shape[begin_norm_axis:]))]
    inputs = {'X': input}
    if scale:
        s = helper.create_parameter(param_attr, shape=norm_shape,
                                    dtype=dtype,
                                    default_initializer=Constant(1.0))
        inputs['Scale'] = s
    if shift:
        b = helper.create_parameter(bias_attr, shape=norm_shape,
                                    dtype=dtype, is_bias=True)
        inputs['Bias'] = b
    out = helper.create_variable_for_type_inference(dtype)
    mean = helper.create_variable_for_type_inference(dtype,
                                                     stop_gradient=True)
    var = helper.create_variable_for_type_inference(dtype,
                                                    stop_gradient=True)
    helper.append_op('layer_norm', inputs=inputs,
                     outputs={'Y': out, 'Mean': mean, 'Variance': var},
                     attrs={'epsilon': epsilon,
                            'begin_norm_axis': begin_norm_axis})
    return helper.append_activation(out, act)


def dropout(x, dropout_prob, is_test=False, seed=None, name=None,
            dropout_implementation='downgrade_in_infer'):
    helper = LayerHelper('dropout', name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    mask = helper.create_variable_for_type_inference(x.dtype,
                                                     stop_gradient=True)
    helper.append_op('dropout', inputs={'X': x},
                     outputs={'Out': out, 'Mask': mask},
                     attrs={'dropout_prob': dropout_prob, 'is_test': is_test,
                            'dropout_implementation':
                                dropout_implementation})
    return out


def softmax(input, use_cudnn=False, name=None, axis=-1):
    helper = LayerHelper('softmax', name=name)
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op('softmax', inputs={'X': input}, outputs={'Out': out},
                     attrs={'axis': axis})
    return out


def log_softmax(input, axis=-1, name=None):
    helper = LayerHelper('log_softmax', name=name)
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op('log_softmax', inputs={'X': input},
                     outputs={'Out': out}, attrs={'axis': axis})
    return out


def cross_entropy(input, label, soft_label=False, ignore_index=-100):
    helper = LayerHelper('cross_entropy')
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op('cross_entropy',
                     inputs={'X': input, 'Label': label},
                     outputs={'Y': out},
                     attrs={'soft_label': soft_label,
                            'ignore_index': ignore_index})
    return out


def matmul(x, y, transpose_x=False, transpose_y=False, alpha=1.0,
           name=None):
    helper = LayerHelper('matmul', name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op('matmul', inputs={'X': x, 'Y': y},
                     outputs={'Out': out},
                     attrs={'transpose_X': transpose_x,
                            'transpose_Y': transpose_y,
                            'alpha': float(alpha)})
    return out


def _elementwise(op_type, x, y, axis=-1, act=None, name=None):
    helper = LayerHelper(op_type, name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op(op_type, inputs={'X': x, 'Y': y},
                     outputs={'Out': out}, attrs={'axis': axis})
    return helper.append_activation(out, act)


def elementwise_add(x, y, axis=-1, act=None, name=None):
    return _elementwise('elementwise_add', x, y, axis, act, name)


def elementwise_sub(x, y, axis=-1, act=None, name=None):
    return _elementwise('elementwise_sub', x, y, axis, act, name)


def elementwise_mul(x, y, axis=-1, act=None, name=None):
    return _elementwise('elementwise_mul', x, y, axis, act, name)


def elementwise_div(x, y, axis=-1, act=None, name=None):
    return _elementwise('elementwise_div', x, y, axis, act, name)


def elementwise_min(x, y, axis=-1, act=None, name=None):
    return _elementwise('elementwise_min', x, y, axis, act, name)


def elementwise_max(x, y, axis=-1, act=None, name=None):
    return _elementwise('elementwise_max', x, y, axis, act, name)


def reduce_sum(input, dim=None, keep_dim=False, name=None):
    helper = LayerHelper('reduce_sum', name=name)
    out = helper.create_variable_for_type_inference(input.dtype)
    if dim is None:
        dim, reduce_all = [0], True
    else:
        dim = [dim] if isinstance(dim, int) else list(dim)
        reduce_all = False
    helper.append_op('reduce_sum', inputs={'X': input}, outputs={'Out': out},
                     attrs={'dim': dim, 'keep_dim': keep_dim,
                            'reduce_all': reduce_all})
    return out


def reshape(x, shape, actual_shape=None, act=None, inplace=False,
            name=None):
    helper = LayerHelper('reshape2', name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op('reshape2', inputs={'X': x}, outputs={'Out': out},
                     attrs={'shape': list(shape)})
    return helper.append_activation(out, act)


def squeeze(input, axes, name=None):
    helper = LayerHelper('squeeze2', name=name)
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op('squeeze2', inputs={'X': input}, outputs={'Out': out},
                     attrs={'axes': list(axes)})
    return out


def unsqueeze(input, axes, name=None):
    helper = LayerHelper('unsqueeze2', name=name)
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op('unsqueeze2', inputs={'X': input},
                     outputs={'Out': out}, attrs={'axes': list(axes)})
    return out


def transpose(x, perm, name=None):
    helper = LayerHelper('transpose2', name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op('transpose2', inputs={'X': x}, outputs={'Out': out},
                     attrs={'axis': list(perm)})
    return out


def stack(x, axis=0):
    helper = LayerHelper('stack')
    x = x if isinstance(x, (list, tuple)) else [x]
    out = helper.create_variable_for_type_inference(x[0].dtype)
    helper.append_op('stack', inputs={'X': list(x)}, outputs={'Y': out},
                     attrs={'axis': axis})
    return out


def split(input, num_or_sections, dim=-1, name=None):
    helper = LayerHelper('split', name=name)
    dim = dim if dim >= 0 else dim + len(input.shape)
    if isinstance(num_or_sections, int):
        num = num_or_sections
        sections = []
        n_out = num
    else:
        num = 0
        sections = list(num_or_sections)
        n_out = len(sections)
    outs = [helper.create_variable_for_type_inference(input.dtype)
            for _ in range(n_out)]
    helper.append_op('split', inputs={'X': input}, outputs={'Out': outs},
                     attrs={'axis': dim, 'num': num, 'sections': sections})
    return outs


def expand(x, expand_times, name=None):
    helper = LayerHelper('expand', name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op('expand', inputs={'X': x}, outputs={'Out': out},
                     attrs={'expand_times': list(expand_times)})
    return out


def gather(input, index, overwrite=True):
    helper = LayerHelper('gather')
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op('gather', inputs={'X': input, 'Index': index},
                     outputs={'Out': out})
    return out


def softmax_with_cross_entropy(logits, label, soft_label=False,
                               ignore_index=-100, numeric_stable_mode=True,
                               return_softmax=False, axis=-1):
    helper = LayerHelper('softmax_with_cross_entropy')
    softmax_out = helper.create_variable_for_type_inference(logits.dtype)
    loss = helper.create_variable_for_type_inference(logits.dtype)
    helper.append_op('softmax_with_cross_entropy',
                     inputs={'Logits': logits, 'Label': label},
                     outputs={'Softmax': softmax_out, 'Loss': loss},
                     attrs={'soft_label': soft_label,
                            'ignore_index': ignore_index, 'axis': axis})
    if return_softmax:
        return loss, softmax_out
    return loss


def sigmoid_cross_entropy_with_logits(x, label, ignore_index=-100,
                                      name=None, normalize=False):
    helper = LayerHelper('sigmoid_cross_entropy_with_logits', name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op('sigmoid_cross_entropy_with_logits',
                     inputs={'X': x, 'Label': label},
                     outputs={'Out': out},
                     attrs={'ignore_index': ignore_index,
                            'normalize': normalize})
    return out


def mean(x, name=None):
    helper = LayerHelper('mean', name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op('mean', inputs={'X': x}, outputs={'Out': out})
    return out


def slice(input, axes, starts, ends):
    helper = LayerHelper('slice')
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op('slice', inputs={'Input': input},
                     outputs={'Out': out},
                     attrs={'axes': list(axes), 'starts': list(starts),
                            'ends': list(ends), 'decrease_axis': []})
    return out


def topk(input, k, name=None):
    helper = LayerHelper('top_k', name=name)
    values = helper.create_variable_for_type_inference(input.dtype)
    indices = helper.create_variable_for_type_inference('int64',
                                                        stop_gradient=True)
    helper.append_op('top_k', inputs={'X': input},
                     outputs={'Out': values, 'Indices': indices},
                     attrs={'k': k})
    return values, indices


def accuracy(input, label, k=1, correct=None, total=None):
    """Reference layers/metric_op.py accuracy: top_k, then the share of
    rows whose label is among the k."""
    helper = LayerHelper('accuracy')
    topk_out, topk_indices = topk(input, k=k)
    acc_out = helper.create_variable_for_type_inference('float32',
                                                        stop_gradient=True)
    correct = correct or helper.create_variable_for_type_inference(
        'int32', stop_gradient=True)
    total = total or helper.create_variable_for_type_inference(
        'int32', stop_gradient=True)
    helper.append_op('accuracy',
                     inputs={'Out': topk_out, 'Indices': topk_indices,
                             'Label': label},
                     outputs={'Accuracy': acc_out, 'Correct': correct,
                              'Total': total})
    return acc_out


def one_hot(input, depth, allow_out_of_range=False):
    """f32 one-hot rows of `depth`; a trailing axis of size 1 on the ids
    is dropped first (the JAX package's rule), so [B, T] ids give
    [B, T, depth]."""
    helper = LayerHelper('one_hot')
    out = helper.create_variable_for_type_inference('float32')
    helper.append_op('one_hot', inputs={'X': input}, outputs={'Out': out},
                     attrs={'depth': depth})
    return out


def label_smooth(label, prior_dist=None, epsilon=0.1, dtype='float32',
                 name=None):
    helper = LayerHelper('label_smooth', name=name)
    out = helper.create_variable_for_type_inference(dtype)
    inputs = {'X': label}
    if prior_dist is not None:
        inputs['PriorDist'] = prior_dist
    helper.append_op('label_smooth', inputs=inputs, outputs={'Out': out},
                     attrs={'epsilon': float(epsilon)})
    return out
