"""The port's conv2d, depthwise_conv2d and pool2d lowerings against the
JAX package's, on the CPU: forward and the gradient of every floating
input (the registry's <type>_grad: jax.vjp on one side, torch.autograd
on the other), from the same seeded numpy inputs and cotangents.
Tolerances (tests/torch_image_cases.py): forward rtol 1e-5 with a floor
of 1e-5 of the largest output, gradients within 1e-4 of the largest.

Max pooling's gradient at a tie: over non-overlapping windows both
packages take the maximum as a chain of pairwise maxima over the
window's slices, which splits the cotangent evenly at each exact tie,
so tied windows hold bitwise.  Over overlapping windows the JAX
package's select_and_scatter and the port's F.max_pool2d each give the
whole cotangent to the window's first maximum; that too holds bitwise
on the tied input below.  Inputs are seeded normals (no ties) except
where a test makes ties on purpose.

The NHWC layout of conv2d, pool2d and batch_norm is also held through a
whole net: test_models.py's ResNet-18 at 32 x 32 in NHWC, 3 Momentum
steps in lockstep with the JAX package (its NCHW twin and the
tolerances: tests/test_torch_resnet.py, tests/torch_image_cases.py).
"""

import numpy as np
import pytest

import jax  # noqa: F401  (JAX on the CPU, as the conftest pins it)

import paddle_tpu.fluid as jfluid

import paddle_tpu_torch.fluid as tfluid

from torch_image_cases import (check_op, cotangents, grads_jax, grads_torch,
                               resnet18_lockstep, run_jax, run_torch,
                               same_block)

_R = np.random.RandomState(0)


def _f(*shape):
    return _R.randn(*shape).astype('float32')


# (id, op, input [N, C, H, W] or NHWC, filter OIHW, attrs)
CONV_CASES = [
    ('nchw_pad2', 'conv2d', _f(2, 3, 9, 8), _f(4, 3, 3, 3),
     {'strides': [1, 1], 'paddings': [1, 1], 'dilations': [1, 1],
      'groups': 1, 'data_format': 'NCHW'}),
    ('nchw_stride2_pad4', 'conv2d', _f(2, 3, 9, 8), _f(5, 3, 3, 2),
     {'strides': [2, 2], 'paddings': [1, 2, 0, 1], 'dilations': [1, 1],
      'groups': 1, 'data_format': 'NCHW'}),
    ('nchw_dilation_groups', 'conv2d', _f(2, 4, 11, 10), _f(6, 2, 3, 3),
     {'strides': [1, 2], 'paddings': [2, 1], 'dilations': [2, 1],
      'groups': 2, 'data_format': 'NCHW'}),
    ('nhwc_same_stride2', 'conv2d', _f(2, 9, 7, 3), _f(4, 3, 3, 3),
     {'strides': [2, 2], 'paddings': [0, 0], 'dilations': [1, 1],
      'groups': 1, 'data_format': 'NHWC', 'padding_algorithm': 'SAME'}),
    ('nchw_valid', 'conv2d', _f(1, 2, 7, 7), _f(3, 2, 5, 5),
     {'strides': [1, 1], 'paddings': [2, 2], 'dilations': [1, 1],
      'groups': 1, 'data_format': 'NCHW', 'padding_algorithm': 'VALID'}),
    ('nhwc_groups_pad4', 'conv2d', _f(2, 8, 8, 6), _f(6, 2, 3, 3),
     {'strides': [1, 1], 'paddings': [0, 1, 1, 2], 'dilations': [1, 1],
      'groups': 3, 'data_format': 'NHWC'}),
    ('depthwise', 'depthwise_conv2d', _f(2, 4, 8, 8), _f(4, 1, 3, 3),
     {'strides': [1, 1], 'paddings': [1, 1], 'dilations': [1, 1],
      'groups': 4, 'data_format': 'NCHW'}),
]


@pytest.mark.parametrize('case', CONV_CASES, ids=[c[0] for c in CONV_CASES])
def test_conv2d_matches_jax(case):
    _, op, x, w, attrs = case
    check_op(op, {'Input': [x], 'Filter': [w]}, attrs, seed=1)


POOL_CASES = [
    # LeNet's: 2 x 2, stride 2 (non-overlapping: the slice chain)
    ('max_2x2', _f(2, 3, 8, 8),
     {'pooling_type': 'max', 'ksize': [2, 2], 'strides': [2, 2],
      'paddings': [0, 0]}),
    # ResNet's stem: 3 x 3, stride 2, padding 1 (overlapping)
    ('max_3x3_s2_p1', _f(2, 3, 9, 10),
     {'pooling_type': 'max', 'ksize': [3, 3], 'strides': [2, 2],
      'paddings': [1, 1]}),
    ('max_pad4_nhwc', _f(2, 7, 6, 3),
     {'pooling_type': 'max', 'ksize': [3, 2], 'strides': [2, 1],
      'paddings': [0, 1, 1, 0], 'data_format': 'NHWC'}),
    ('max_same', _f(1, 2, 7, 9),
     {'pooling_type': 'max', 'ksize': [3, 3], 'strides': [2, 2],
      'paddings': [0, 0], 'padding_algorithm': 'SAME'}),
    ('avg_exclusive_pad', _f(2, 3, 7, 7),
     {'pooling_type': 'avg', 'ksize': [3, 3], 'strides': [2, 2],
      'paddings': [1, 1], 'exclusive': True}),
    ('avg_inclusive_pad4', _f(2, 3, 7, 6),
     {'pooling_type': 'avg', 'ksize': [3, 3], 'strides': [2, 2],
      'paddings': [1, 0, 0, 1], 'exclusive': False}),
    ('avg_same_nhwc', _f(2, 7, 5, 3),
     {'pooling_type': 'avg', 'ksize': [2, 3], 'strides': [2, 2],
      'paddings': [0, 0], 'padding_algorithm': 'SAME',
      'data_format': 'NHWC'}),
    ('global_avg_nhwc', _f(2, 5, 4, 6),
     {'pooling_type': 'avg', 'ksize': [1, 1], 'global_pooling': True,
      'data_format': 'NHWC'}),
    ('global_max', _f(2, 3, 5, 4),
     {'pooling_type': 'max', 'ksize': [1, 1], 'global_pooling': True}),
    ('adaptive_1x1_avg', _f(2, 3, 5, 4),
     {'pooling_type': 'avg', 'ksize': [1, 1], 'adaptive': True}),
    ('adaptive_grid_avg', _f(2, 3, 7, 5),
     {'pooling_type': 'avg', 'ksize': [3, 2], 'adaptive': True}),
    ('adaptive_grid_max_nhwc', _f(2, 7, 5, 3),
     {'pooling_type': 'max', 'ksize': [3, 2], 'adaptive': True,
      'data_format': 'NHWC'}),
]


@pytest.mark.parametrize('case', POOL_CASES, ids=[c[0] for c in POOL_CASES])
def test_pool2d_matches_jax(case):
    _, x, attrs = case
    check_op('pool2d', {'X': [x]}, attrs, seed=2)


def test_max_pool_gradient_at_ties():
    """Windows of equal values (relu's zeros, constants): the forward
    and the gradient are bitwise the JAX package's, over non-overlapping
    windows (the cotangent split along the maximum chain) and over
    overlapping ones (all to the first maximum)."""
    x = np.zeros((1, 2, 6, 6), 'float32')
    x[0, 0, :2, :2] = 1.5
    x[0, 1] = np.maximum(_f(6, 6), 0.0)
    for attrs in ({'pooling_type': 'max', 'ksize': [2, 2], 'strides': [2, 2],
                   'paddings': [0, 0]},
                  {'pooling_type': 'max', 'ksize': [3, 3], 'strides': [2, 2],
                   'paddings': [1, 1]}):
        ins = {'X': [x]}
        want = run_jax('pool2d', ins, attrs)
        got = run_torch('pool2d', ins, attrs)
        np.testing.assert_array_equal(got['Out'][0], want['Out'][0])
        cts = cotangents('pool2d', want, 3)
        gj = grads_jax('pool2d', ins, attrs, cts)['GRAD::X'][0]
        gt = grads_torch('pool2d', ins, attrs, cts)['GRAD::X'][0]
        np.testing.assert_array_equal(gt, gj)
    # the split along the chain max(max(max(a, b), c), d) of the tied
    # 2 x 2 window of 1.5: 1/8, 1/8, 1/4 and 1/2 of its cotangent
    attrs = {'pooling_type': 'max', 'ksize': [2, 2], 'strides': [2, 2],
             'paddings': [0, 0]}
    cts = cotangents('pool2d', run_jax('pool2d', ins, attrs), 3)
    g = grads_torch('pool2d', ins, attrs, cts)['GRAD::X'][0][0, 0, :2, :2]
    ct = cts['GRAD::Out'][0][0, 0, 0, 0]
    np.testing.assert_array_equal(
        g, ct * np.array([[0.125, 0.125], [0.25, 0.5]], 'float32'))


def test_conv_pool_layers_build_like_jax():
    """conv2d (bias over the channel axis, act, NCHW and NHWC, the
    depthwise op where groups equals both channel counts), pool2d and
    nets.simple_img_conv_pool / img_conv_group append the JAX
    package's ops, attributes and variables."""
    def build(fluid):
        main, startup = fluid.Program(), fluid.Program()
        main.random_seed = startup.random_seed = 3
        with fluid.unique_name.guard(), fluid.program_guard(main, startup):
            x = fluid.layers.data('x', shape=[4, 16, 16])
            y = fluid.nets.simple_img_conv_pool(
                x, num_filters=4, filter_size=3, pool_size=2,
                pool_stride=2, act='relu', conv_padding=1)
            y = fluid.layers.conv2d(y, 4, 3, padding=[1, 1], groups=4)
            y = fluid.nets.img_conv_group(
                y, [6, 6], pool_size=2, conv_act='relu',
                conv_with_batchnorm=True, conv_batchnorm_drop_rate=[0.0, 0.2],
                pool_stride=2, pool_type='avg')
            z = fluid.layers.data('z', shape=[8, 8, 3])
            z = fluid.layers.conv2d(z, 5, [3, 2], stride=2, padding=1,
                                    data_format='NHWC', act='relu')
            fluid.layers.pool2d(z, 3, 'max', 2, 1, data_format='NHWC')
            fluid.layers.pool2d(z, pool_type='avg', global_pooling=True,
                                data_format='NHWC')
        return main, startup
    jm, js = build(jfluid)
    tm, ts = build(tfluid)
    same_block(jm.to_dict()['blocks'][0], tm.to_dict()['blocks'][0])
    same_block(js.to_dict()['blocks'][0], ts.to_dict()['blocks'][0])
    types = [op.type for op in tm.global_block().ops]
    assert types.count('depthwise_conv2d') == 1
    assert types.count('batch_norm') == 2 and 'dropout' in types


def test_resnet18_nhwc_matches_jax():
    resnet18_lockstep('NHWC')
