"""Neural-net layers: the subset BERT pretraining, the CTR models, the
image classifiers, gradient clipping and ordinary Fluid scripts
(reductions, clipping, selection, padding, n-d indexing) build.  Reference:
python/paddle/fluid/layers/nn.py.

Each layer appends IR ops via LayerHelper exactly like the reference
(e.g. fc at layers/nn.py:207) and the JAX package, so both packages
build the same Program.
"""

import numpy as np

from ..initializer import Constant, Normal
from ..layer_helper import LayerHelper
from ..param_attr import ParamAttr
from .ops import _unary_op

__all__ = ['fc', 'embedding', 'conv2d', 'pool2d', 'batch_norm',
           'layer_norm', 'dropout', 'softmax', 'log_softmax',
           'cross_entropy', 'matmul', 'elementwise_add', 'elementwise_sub',
           'elementwise_mul', 'elementwise_div', 'elementwise_min',
           'elementwise_max', 'reduce_sum', 'reshape', 'squeeze',
           'unsqueeze', 'transpose', 'stack', 'split', 'expand', 'gather',
           'softmax_with_cross_entropy',
           'sigmoid_cross_entropy_with_logits', 'square_error_cost',
           'mean', 'slice', 'topk', 'accuracy', 'one_hot', 'label_smooth',
           'linear_chain_crf', 'crf_decoding', 'chunk_eval', 'cos_sim',
           'nce', 'hsigmoid', 'warpctc', 'ctc_greedy_decoder',
           'edit_distance', 'reduce_mean', 'reduce_max', 'reduce_min',
           'reduce_prod', 'elementwise_pow', 'mul', 'clip', 'clip_by_norm',
           'l2_normalize', 'flatten', 'where', 'cond_select', 'leaky_relu',
           'prelu', 'pad', 'gather_nd', 'scatter', 'unstack', 'dice_loss',
           'conv2d_transpose', 'adaptive_pool2d', 'auc', 'smooth_l1', 'lrn',
           'image_resize', 'resize_bilinear', 'resize_nearest']


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


def conv2d_transpose(input, num_filters, output_size=None, filter_size=None,
                     padding=0, stride=1, dilation=1, groups=None,
                     param_attr=None, bias_attr=None, use_cudnn=True,
                     act=None, name=None):
    """Reference layers/nn.py conv2d_transpose: a [in_c, num_filters /
    groups, kh, kw] filter, the bias over the channel axis, then act.
    As in the JAX package, output_size is not read: filter_size must be
    given."""
    helper = LayerHelper('conv2d_transpose', act=act, name=name)
    groups = groups or 1
    filter_shape = [input.shape[1], num_filters // groups] + \
        _pair_list(filter_size)
    w = helper.create_parameter(param_attr, shape=filter_shape,
                                dtype=input.dtype)
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op(
        'conv2d_transpose',
        inputs={'Input': input, 'Filter': w}, outputs={'Output': out},
        attrs={'strides': _pair_list(stride),
               'paddings': _pair_list(padding),
               'dilations': _pair_list(dilation), 'groups': groups})
    pre_act = helper.append_bias_op(out, dim_start=1, dim_end=2,
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


def adaptive_pool2d(input, pool_size, pool_type='max', name=None):
    """Pooling to a pool_size grid (reference operators/pool_op adaptive
    mode: window i spans [floor(i H / oh), ceil((i + 1) H / oh))); a
    [1, 1] grid is global pooling."""
    if list(pool_size) == [1, 1]:
        return pool2d(input, pool_type=pool_type, global_pooling=True,
                      name=name)
    helper = LayerHelper('pool2d', name=name)
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op('pool2d', inputs={'X': input}, outputs={'Out': out},
                     attrs={'pooling_type': pool_type,
                            'ksize': list(pool_size), 'adaptive': True},
                     infer_shape=False)
    if len(input.shape) == 4:
        out.shape = tuple(input.shape[:2]) + tuple(pool_size)
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


def _reduce(op_type, input, dim=None, keep_dim=False, name=None):
    helper = LayerHelper(op_type, name=name)
    out = helper.create_variable_for_type_inference(input.dtype)
    if dim is None:
        dim, reduce_all = [0], True
    else:
        dim = [dim] if isinstance(dim, int) else list(dim)
        reduce_all = False
    helper.append_op(op_type, inputs={'X': input}, outputs={'Out': out},
                     attrs={'dim': dim, 'keep_dim': keep_dim,
                            'reduce_all': reduce_all})
    return out


def reduce_sum(input, dim=None, keep_dim=False, name=None):
    return _reduce('reduce_sum', input, dim, keep_dim, name)


def reduce_mean(input, dim=None, keep_dim=False, name=None):
    return _reduce('reduce_mean', input, dim, keep_dim, name)


def reduce_max(input, dim=None, keep_dim=False, name=None):
    return _reduce('reduce_max', input, dim, keep_dim, name)


def reduce_min(input, dim=None, keep_dim=False, name=None):
    return _reduce('reduce_min', input, dim, keep_dim, name)


def reduce_prod(input, dim=None, keep_dim=False, name=None):
    return _reduce('reduce_prod', input, dim, keep_dim, name)


def elementwise_pow(x, y, axis=-1, act=None, name=None):
    return _elementwise('elementwise_pow', x, y, axis, act, name)


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


def square_error_cost(input, label):
    """Reference layers/nn.py square_error_cost: (input - label)^2."""
    helper = LayerHelper('square_error_cost')
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op('square_error_cost',
                     inputs={'X': input, 'Y': label},
                     outputs={'Out': out})
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


def auc(input, label, curve='ROC', num_thresholds=4095, topk=1,
        slide_steps=1):
    """Streaming ROC AUC of input [N, 2] (the positive class's column 1)
    against label: its float32 [num_thresholds + 1] bucket counts
    <name>_stat_pos / <name>_stat_neg are persistables the startup
    program fills with zeros and every step adds to.  Returns (auc, None,
    [stat_pos, stat_neg]), as the JAX layer does (no batch AUC)."""
    helper = LayerHelper('auc')
    stats = [helper.create_global_variable(
        persistable=True, dtype='float32', shape=[num_thresholds + 1],
        name=helper.name + suffix) for suffix in ('_stat_pos', '_stat_neg')]
    startup = helper.startup_program.global_block()
    for var in stats:
        sv = startup.create_var(name=var.name, shape=var.shape,
                                dtype=var.dtype, persistable=True)
        startup.append_op('fill_constant', outputs={'Out': sv},
                          attrs={'shape': list(var.shape), 'dtype': var.dtype,
                                 'value': 0.0})
    auc_out = helper.create_variable_for_type_inference(
        'float32', stop_gradient=True)
    helper.append_op('auc',
                     inputs={'Predict': input, 'Label': label,
                             'StatPos': stats[0], 'StatNeg': stats[1]},
                     outputs={'AUC': auc_out, 'StatPosOut': stats[0],
                              'StatNegOut': stats[1]},
                     attrs={'num_thresholds': num_thresholds})
    return auc_out, None, stats


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


# ---------------------------------------------------------------------------
# Structured prediction and language layers (reference layers/nn.py:
# linear_chain_crf, crf_decoding, chunk_eval, cos_sim, nce, hsigmoid,
# warpctc, ctc_greedy_decoder, edit_distance; the JAX package's
# layers/nn.py:774-965, op for op)
# ---------------------------------------------------------------------------

def linear_chain_crf(input, label, param_attr=None, length=None):
    """CRF negative log-likelihood over padded [B,T,D] emissions: the
    per-sequence cost [B,1].  The transition parameter is [D+2, D] (row 0
    start, row 1 end, the rest pairwise)."""
    helper = LayerHelper('linear_chain_crf', param_attr=param_attr)
    tag_num = input.shape[-1]
    trans = helper.create_parameter(param_attr,
                                    shape=[tag_num + 2, tag_num],
                                    dtype=input.dtype)
    ll = helper.create_variable_for_type_inference(input.dtype)
    alpha = helper.create_variable_for_type_inference(input.dtype)
    e_exps = helper.create_variable_for_type_inference(input.dtype)
    t_exps = helper.create_variable_for_type_inference(input.dtype)
    inputs = {'Emission': input, 'Transition': trans, 'Label': label}
    if length is not None:
        inputs['Length'] = length
    helper.append_op('linear_chain_crf', inputs=inputs,
                     outputs={'LogLikelihood': ll, 'Alpha': alpha,
                              'EmissionExps': e_exps,
                              'TransitionExps': t_exps},
                     infer_shape=False)
    return ll


def crf_decoding(input, param_attr, label=None, length=None):
    """Viterbi decode with the transition parameter named by
    `param_attr` (linear_chain_crf's); with `label`, each position's
    correctness 0/1."""
    helper = LayerHelper('crf_decoding')
    pname = param_attr.name if hasattr(param_attr, 'name') else param_attr
    trans = helper.main_program.global_block()._find_var_recursive(pname)
    if trans is None:
        raise ValueError('crf_decoding: transition parameter %r not found '
                         '(pass the ParamAttr used by linear_chain_crf)'
                         % pname)
    out = helper.create_variable_for_type_inference('int64')
    inputs = {'Emission': input, 'Transition': trans}
    if label is not None:
        inputs['Label'] = label
    if length is not None:
        inputs['Length'] = length
    helper.append_op('crf_decoding', inputs=inputs,
                     outputs={'ViterbiPath': out}, infer_shape=False)
    out.stop_gradient = True
    return out


def chunk_eval(input, label, chunk_scheme, num_chunk_types,
               excluded_chunk_types=None, seq_length=None):
    """Chunk precision, recall and F1, and the three counts (a host op)."""
    helper = LayerHelper('chunk_eval')
    precision = helper.create_variable_for_type_inference('float32')
    recall = helper.create_variable_for_type_inference('float32')
    f1 = helper.create_variable_for_type_inference('float32')
    n_infer = helper.create_variable_for_type_inference('int64')
    n_label = helper.create_variable_for_type_inference('int64')
    n_correct = helper.create_variable_for_type_inference('int64')
    inputs = {'Inference': input, 'Label': label}
    if seq_length is not None:
        inputs['SeqLength'] = seq_length
    helper.append_op('chunk_eval', inputs=inputs,
                     outputs={'Precision': precision, 'Recall': recall,
                              'F1-Score': f1, 'NumInferChunks': n_infer,
                              'NumLabelChunks': n_label,
                              'NumCorrectChunks': n_correct},
                     attrs={'chunk_scheme': chunk_scheme,
                            'num_chunk_types': num_chunk_types,
                            'excluded_chunk_types':
                                list(excluded_chunk_types or [])},
                     infer_shape=False)
    return precision, recall, f1, n_infer, n_label, n_correct


def cos_sim(X, Y):
    helper = LayerHelper('cos_sim')
    out = helper.create_variable_for_type_inference(X.dtype)
    xn = helper.create_variable_for_type_inference(X.dtype)
    yn = helper.create_variable_for_type_inference(X.dtype)
    helper.append_op('cos_sim', inputs={'X': X, 'Y': Y},
                     outputs={'Out': out, 'XNorm': xn, 'YNorm': yn},
                     infer_shape=False)
    return out


def nce(input, label, num_total_classes, sample_weight=None,
        param_attr=None, bias_attr=None, num_neg_samples=10, name=None,
        sampler='uniform', custom_dist=None, seed=0, is_sparse=False):
    """Noise-contrastive estimation loss; samplers uniform, log_uniform
    (Zipf) and custom_dist."""
    helper = LayerHelper('nce', param_attr=param_attr,
                         bias_attr=bias_attr, name=name)
    dim = input.shape[-1]
    w = helper.create_parameter(param_attr,
                                shape=[num_total_classes, dim],
                                dtype=input.dtype)
    cost = helper.create_variable_for_type_inference(input.dtype)
    s_logits = helper.create_variable_for_type_inference(input.dtype)
    s_labels = helper.create_variable_for_type_inference('int64')
    inputs = {'Input': input, 'Weight': w, 'Label': label}
    if bias_attr is not False:
        b = helper.create_parameter(bias_attr,
                                    shape=[num_total_classes],
                                    dtype=input.dtype, is_bias=True)
        inputs['Bias'] = b
    attrs = {'num_total_classes': num_total_classes,
             'num_neg_samples': num_neg_samples,
             'seed': seed, 'sampler': sampler}
    if custom_dist is not None:
        attrs['sampler'] = 'custom_dist'
        attrs['custom_dist'] = [float(p) for p in custom_dist]
    helper.append_op('nce', inputs=inputs,
                     outputs={'Cost': cost, 'SampleLogits': s_logits,
                              'SampleLabels': s_labels},
                     attrs=attrs, infer_shape=False)
    return cost


def hsigmoid(input, label, num_classes, param_attr=None, bias_attr=None,
             name=None):
    """Hierarchical sigmoid over the default complete binary tree."""
    helper = LayerHelper('hsigmoid', param_attr=param_attr,
                         bias_attr=bias_attr, name=name)
    dim = input.shape[-1]
    w = helper.create_parameter(param_attr, shape=[num_classes - 1, dim],
                                dtype=input.dtype)
    out = helper.create_variable_for_type_inference(input.dtype)
    pre_out = helper.create_variable_for_type_inference(input.dtype)
    inputs = {'X': input, 'W': w, 'Label': label}
    if bias_attr is not False:
        b = helper.create_parameter(bias_attr, shape=[num_classes - 1],
                                    dtype=input.dtype, is_bias=True)
        inputs['Bias'] = b
    helper.append_op('hierarchical_sigmoid', inputs=inputs,
                     outputs={'Out': out, 'PreOut': pre_out},
                     attrs={'num_classes': num_classes},
                     infer_shape=False)
    return out


def warpctc(input, label, blank=0, norm_by_times=False,
            input_length=None, label_length=None):
    """CTC loss on padded [B,T,V] logits."""
    helper = LayerHelper('warpctc')
    loss = helper.create_variable_for_type_inference(input.dtype)
    grad = helper.create_variable_for_type_inference(input.dtype)
    inputs = {'Logits': input, 'Label': label}
    if input_length is not None:
        inputs['LogitsLength'] = input_length
    if label_length is not None:
        inputs['LabelLength'] = label_length
    helper.append_op('warpctc', inputs=inputs,
                     outputs={'Loss': loss, 'WarpCTCGrad': grad},
                     attrs={'blank': blank, 'norm_by_times': norm_by_times},
                     infer_shape=False)
    return loss


def ctc_greedy_decoder(input, blank, input_length=None, padding_value=0):
    """Greedy CTC decode: argmax, merge repeats, drop blanks."""
    from .tensor import argmax
    helper = LayerHelper('ctc_greedy_decoder')
    amax = argmax(input, axis=-1)
    out = helper.create_variable_for_type_inference('int64')
    out_len = helper.create_variable_for_type_inference('int64')
    inputs = {'Input': amax}
    if input_length is not None:
        inputs['InputLength'] = input_length
    helper.append_op('ctc_align', inputs=inputs,
                     outputs={'Output': out, 'OutputLength': out_len},
                     attrs={'blank': blank, 'padding_value': padding_value},
                     infer_shape=False)
    return out, out_len


def edit_distance(input, label, normalized=True, ignored_tokens=None,
                  input_length=None, label_length=None):
    helper = LayerHelper('edit_distance')
    out = helper.create_variable_for_type_inference('float32')
    seq_num = helper.create_variable_for_type_inference('int64')
    inputs = {'Hyps': input, 'Refs': label}
    if input_length is not None:
        inputs['HypsLength'] = input_length
    if label_length is not None:
        inputs['RefsLength'] = label_length
    helper.append_op('edit_distance', inputs=inputs,
                     outputs={'Out': out, 'SequenceNum': seq_num},
                     attrs={'normalized': normalized,
                            'ignored_tokens': list(ignored_tokens or [])},
                     infer_shape=False)
    return out, seq_num


def mul(x, y, x_num_col_dims=1, y_num_col_dims=1, name=None):
    helper = LayerHelper('mul', name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op('mul', inputs={'X': x, 'Y': y}, outputs={'Out': out},
                     attrs={'x_num_col_dims': x_num_col_dims,
                            'y_num_col_dims': y_num_col_dims})
    return out


def clip(x, min, max, name=None):
    return _unary_op('clip', x, {'min': float(min), 'max': float(max)}, name)


def clip_by_norm(x, max_norm, name=None):
    return _unary_op('clip_by_norm', x, {'max_norm': float(max_norm)},
                     name)


def l2_normalize(x, axis, epsilon=1e-12, name=None):
    """x / sqrt(sum(x^2) over axis + epsilon) through the norm op."""
    helper = LayerHelper('l2_normalize', name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    norm = helper.create_variable_for_type_inference(x.dtype,
                                                     stop_gradient=True)
    helper.append_op('norm', inputs={'X': x},
                     outputs={'Out': out, 'Norm': norm},
                     attrs={'axis': 1 if axis is None else axis,
                            'epsilon': epsilon})
    return out


def flatten(x, axis=1, name=None):
    return _unary_op('flatten2', x, {'axis': axis}, name)


def where(condition, x, y):
    helper = LayerHelper('where')
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op('where',
                     inputs={'Condition': condition, 'X': x, 'Y': y},
                     outputs={'Out': out})
    return out


def cond_select(cond, true_val, false_val):
    return where(cond, true_val, false_val)


def leaky_relu(x, alpha=0.02, name=None):
    return _unary_op('leaky_relu', x, {'alpha': alpha}, name)


def prelu(x, mode, param_attr=None, name=None):
    """x where positive, else alpha * x, alpha a parameter (0.25) of
    shape [1] ('all'), [C] ('channel') or x.shape[1:] ('element')."""
    helper = LayerHelper('prelu', name=name)
    if mode == 'all':
        alpha_shape = [1]
    elif mode == 'channel':
        alpha_shape = [x.shape[1]]
    else:
        alpha_shape = list(x.shape[1:])
    alpha = helper.create_parameter(param_attr, shape=alpha_shape,
                                    dtype=x.dtype,
                                    default_initializer=Constant(0.25))
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op('prelu', inputs={'X': x, 'Alpha': alpha},
                     outputs={'Out': out}, attrs={'mode': mode})
    return out


def pad(x, paddings, pad_value=0.0, name=None):
    return _unary_op('pad', x, {'paddings': list(paddings),
                                 'pad_value': float(pad_value)}, name)


def gather_nd(input, index, name=None):
    helper = LayerHelper('gather_nd', name=name)
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op('gather_nd', inputs={'X': input, 'Index': index},
                     outputs={'Out': out})
    return out


def scatter(input, index, updates, name=None, overwrite=True):
    helper = LayerHelper('scatter', name=name)
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op('scatter',
                     inputs={'X': input, 'Ids': index, 'Updates': updates},
                     outputs={'Out': out}, attrs={'overwrite': overwrite})
    return out


def unstack(x, axis=0, num=None):
    helper = LayerHelper('unstack')
    num = num if num is not None else x.shape[axis]
    outs = [helper.create_variable_for_type_inference(x.dtype)
            for _ in range(num)]
    helper.append_op('unstack', inputs={'X': x}, outputs={'Y': outs},
                     attrs={'axis': axis, 'num': num})
    return outs


def smooth_l1(x, y, inside_weight=None, outside_weight=None, sigma=None):
    """The smooth_l1_loss op's per-sample sum (its weights not read, as
    in the JAX package)."""
    helper = LayerHelper('smooth_l1_loss')
    out = helper.create_variable_for_type_inference(x.dtype)
    diff = helper.create_variable_for_type_inference(x.dtype,
                                                     stop_gradient=True)
    helper.append_op('smooth_l1_loss', inputs={'X': x, 'Y': y},
                     outputs={'Out': out, 'Diff': diff},
                     attrs={'sigma': sigma or 1.0})
    return out


def lrn(input, n=5, k=1.0, alpha=1e-4, beta=0.75, name=None):
    """Cross-channel local response norm (reference layers/nn.py lrn
    over operators/lrn_op.cc)."""
    helper = LayerHelper('lrn', name=name)
    out = helper.create_variable_for_type_inference(input.dtype)
    mid = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op('lrn', inputs={'X': input},
                     outputs={'Out': out, 'MidOut': mid},
                     attrs={'n': n, 'k': k, 'alpha': alpha, 'beta': beta})
    return out


def image_resize(input, out_shape=None, scale=None, name=None,
                 resample='BILINEAR'):
    """bilinear_interp or nearest_interp to out_shape (or by scale); the
    op sets no align_corners, as in the JAX package."""
    helper = LayerHelper('interpolate', name=name)
    out = helper.create_variable_for_type_inference(input.dtype)
    attrs = {}
    if out_shape is not None:
        attrs['out_h'], attrs['out_w'] = int(out_shape[0]), int(out_shape[1])
    if scale is not None:
        attrs['scale'] = scale
    op = 'bilinear_interp' if resample.upper() == 'BILINEAR' \
        else 'nearest_interp'
    helper.append_op(op, inputs={'X': input}, outputs={'Out': out},
                     attrs=attrs)
    return out


def resize_bilinear(input, out_shape=None, scale=None, name=None):
    return image_resize(input, out_shape, scale, name, 'BILINEAR')


def resize_nearest(input, out_shape=None, scale=None, name=None):
    return image_resize(input, out_shape, scale, name, 'NEAREST')


def dice_loss(input, label, epsilon=1e-5):
    """1 - 2 |A n B| / (|A| + |B|) per example, averaged over the batch
    (reference python/paddle/fluid/layers/nn.py dice_loss)."""
    onehot = one_hot(label, depth=input.shape[-1])
    axes = list(range(1, len(input.shape)))
    overlap = reduce_sum(input * onehot, dim=axes)
    mass = reduce_sum(input, dim=axes) + reduce_sum(onehot, dim=axes)
    per_example = 1 - 2 * overlap / (mass + epsilon)
    return reduce_mean(per_example)
