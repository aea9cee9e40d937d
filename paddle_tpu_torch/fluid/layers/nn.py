"""Neural-net layers: the subset BERT pretraining builds.
Reference: python/paddle/fluid/layers/nn.py.

Each layer appends IR ops via LayerHelper exactly like the reference
(e.g. fc at layers/nn.py:207) and the JAX package, so both packages
build the same Program.  ``softmax``, ``matmul`` and ``transpose``
build their ops, but the port has no lowering for them yet: a program
holding one raises NotImplementedError in the executor.
"""

import numpy as np

from ..layer_helper import LayerHelper

__all__ = ['fc', 'embedding', 'layer_norm', 'dropout', 'softmax', 'matmul',
           'elementwise_add', 'reshape', 'unsqueeze', 'transpose', 'split',
           'softmax_with_cross_entropy', 'mean', 'slice']


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


def layer_norm(input, scale=True, shift=True, begin_norm_axis=1,
               epsilon=1e-5, param_attr=None, bias_attr=None, act=None,
               name=None):
    from ..initializer import Constant
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


def reshape(x, shape, actual_shape=None, act=None, inplace=False,
            name=None):
    helper = LayerHelper('reshape2', name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op('reshape2', inputs={'X': x}, outputs={'Out': out},
                     attrs={'shape': list(shape)})
    return helper.append_activation(out, act)


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
