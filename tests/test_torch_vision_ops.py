"""The dense-vision op types (ROADMAP Queue 1 item 11b-A: the JAX
package's ops/vision_ops.py but its ROI and anchor ops) on the CPU
against the JAX package's lowerings, from the same numpy inputs
(torch_attention_cases.check: the forward, and the gradient of every
floating input by torch.autograd against jax.vjp under cotangents drawn
from a seed no input is drawn from).

Tolerances: f32 forward within rtol FWD = 1e-5 plus 1e-5 of the
output's largest magnitude, gradients within GRAD = 1e-4 of theirs;
bitwise (tol 0) for the copies (pixel_shuffle, shuffle_channel,
space_to_depth's channel order, crop, crop_tensor, unfold's forward).
crop_tensor's and affine_grid's shape inputs, which the JAX lowering
reads on the host, raise in both executors.
"""

import numpy as np
import pytest

import paddle_tpu.fluid as jfluid
from paddle_tpu.ops import registry as jreg

import paddle_tpu_torch.fluid as tfluid
from paddle_tpu_torch.ops import registry as treg

from torch_attention_cases import check
from torch_image_cases import run_jax, run_torch

FWD = 1e-5
GRAD = 1e-4
CT_SEED = 97  # the cotangents' seed


def _x(*shape, seed=0, scale=1.0):
    return (np.random.RandomState(seed).randn(*shape) * scale).astype(
        'float32')


@pytest.mark.parametrize('attrs,in_c,groups', [
    ({'strides': [1, 1, 1], 'paddings': [1, 1, 1]}, 3, 1),
    ({'strides': [2, 1, 2], 'paddings': [0, 1, 2], 'dilations': [1, 2, 1],
      'groups': 2}, 4, 2),
    ({'strides': [2, 2, 1], 'padding_algorithm': 'SAME'}, 2, 1),
])
def test_conv3d(attrs, in_c, groups):
    check('conv3d', {'Input': [_x(2, in_c, 5, 6, 7, seed=1)],
                     'Filter': [_x(4, in_c // groups, 3, 3, 2, seed=2)]},
          attrs, FWD, GRAD, seed=CT_SEED)


def test_conv3d_transpose_ignores_groups_and_dilations():
    for attrs in ({'strides': [2, 2, 2], 'paddings': [1, 1, 1]},
                  {'strides': [1, 2, 1], 'paddings': [0, 1, 0],
                   'groups': 2, 'dilations': [2, 2, 2]}):
        check('conv3d_transpose',
              {'Input': [_x(2, 4, 3, 4, 3, seed=3)],
               'Filter': [_x(4, 3, 3, 2, 3, seed=4)]},
              attrs, FWD, GRAD, seed=CT_SEED)


@pytest.mark.parametrize('attrs', [
    {'pooling_type': 'max', 'ksize': [1, 2, 2], 'strides': [1, 2, 2]},
    {'pooling_type': 'max', 'ksize': [2, 2, 2], 'strides': [2, 2, 2],
     'paddings': [0, 1, 1]},
    {'pooling_type': 'max', 'ksize': [3, 3, 3], 'strides': [1, 2, 2],
     'paddings': [2, 1, 0]},
    {'pooling_type': 'avg', 'ksize': [2, 3, 2], 'strides': [1, 2, 2],
     'paddings': [1, 1, 0], 'exclusive': True},
    {'pooling_type': 'avg', 'ksize': [2, 2, 2], 'adaptive': True},
    {'pooling_type': 'max', 'global_pooling': True},
    {'pooling_type': 'avg', 'global_pooling': True},
])
def test_pool3d(attrs):
    check('pool3d', {'X': [_x(2, 3, 4, 6, 7, seed=5)]}, attrs, FWD, GRAD,
          seed=CT_SEED)


@pytest.mark.parametrize('align', [True, False])
def test_trilinear_interp(align):
    x = _x(2, 3, 3, 4, 5, seed=6)
    for attrs in ({'out_d': 5, 'out_h': 7, 'out_w': 9},
                  {'out_d': 2, 'out_h': 3, 'out_w': 2},
                  {'out_d': 3, 'out_h': 1, 'out_w': 8},
                  {'scale': 1.5}):
        check('trilinear_interp', {'X': [x]},
              dict(attrs, align_corners=align), FWD, GRAD, seed=CT_SEED)


def test_pixel_rearrangements_bitwise():
    check('pixel_shuffle', {'X': [_x(2, 12, 3, 4, seed=7)]},
          {'upscale_factor': 2}, 0, 0, seed=CT_SEED)
    check('shuffle_channel', {'X': [_x(2, 12, 3, 4, seed=7)]},
          {'group': 3}, 0, 0, seed=CT_SEED)
    x = _x(2, 3, 6, 4, seed=8)
    check('space_to_depth', {'X': [x]}, {'blocksize': 2}, 0, 0,
          seed=CT_SEED)
    out = run_torch('space_to_depth', {'X': [x]}, {'blocksize': 2})['Out'][0]
    # channel (i * b + j) * C + c holds x[c, b y + i, b x + j]
    np.testing.assert_array_equal(out[:, (1 * 2 + 0) * 3 + 2],
                                  x[:, 2, 1::2, 0::2])


def test_affine_channel_and_affine_grid():
    x = _x(2, 5, 3, 4, seed=9)
    for layout, shape in (('NCHW', x.shape), ('NHWC', (2, 3, 4, 5))):
        check('affine_channel', {'X': [x.reshape(shape)],
                                 'Scale': [_x(5, seed=10)],
                                 'Bias': [_x(5, seed=11)]},
              {'data_layout': layout}, FWD, GRAD, seed=CT_SEED)
    theta = _x(3, 2, 3, seed=12)
    for shape in ([3, 1, 5, 7], [3, 2, 1, 4]):
        check('affine_grid', {'Theta': [theta]}, {'output_shape': shape},
              FWD, GRAD, seed=CT_SEED)


def test_unfold():
    x = _x(2, 3, 7, 8, seed=13)
    for attrs in ({'kernel_sizes': [3, 3]},
                  {'kernel_sizes': [2, 3], 'strides': [2, 1],
                   'paddings': [1, 1], 'dilations': [1, 2]},
                  {'kernel_sizes': [3, 2], 'strides': [1, 2],
                   'paddings': [1, 0, 2, 1]}):
        check('unfold', {'X': [x]}, attrs, FWD, GRAD, seed=CT_SEED)
        got = run_torch('unfold', {'X': [x]}, attrs)['Y'][0]
        np.testing.assert_array_equal(
            got, run_jax('unfold', {'X': [x]}, attrs)['Y'][0])


def test_crop_and_crop_tensor():
    x = _x(3, 5, 6, seed=14)
    for op in ('crop', 'crop_tensor'):
        check(op, {'X': [x]}, {'shape': [2, -1, 3], 'offsets': [1, 0, 2]},
              0, 0, seed=CT_SEED)
        check(op, {'X': [x]}, {'shape': [3, 2, 0]}, 0, 0, seed=CT_SEED)


def test_shape_inputs_read_on_the_host_raise_in_both_executors():
    def build(fluid):
        x = fluid.layers.data('x', [4, 6], dtype='float32',
                              append_batch_size=False)
        off = fluid.layers.data('off', [2], dtype='int32',
                                append_batch_size=False)
        return fluid.layers.crop_tensor(x, shape=[2, 3], offsets=off)
    for fluid in (jfluid, tfluid):
        with fluid.unique_name.guard(), fluid.program_guard(
                fluid.Program(), fluid.Program()):
            with pytest.raises(Exception) as e:
                build(fluid)
            assert 'crop_tensor' in str(e.value)
    with pytest.raises(ValueError, match='affine_grid: OutputShape'):
        run_torch('affine_grid', {'Theta': [_x(1, 2, 3)],
                                  'OutputShape': [np.array([1, 1, 2, 2])]},
                  {})


def test_spp():
    for hw in ((7, 9), (8, 8)):
        x = _x(2, 3, *hw, seed=15)
        for ptype in ('max', 'avg'):
            check('spp', {'X': [x]}, {'pyramid_height': 3,
                                      'pooling_type': ptype},
                  FWD, GRAD, seed=CT_SEED)


@pytest.mark.parametrize('op,attrs,c,o,dg', [
    ('deformable_conv', {'strides': [1, 1], 'paddings': [1, 1]}, 4, 6, 1),
    ('deformable_conv', {'strides': [2, 1], 'paddings': [1, 0],
                         'dilations': [1, 2], 'groups': 2,
                         'deformable_groups': 2}, 4, 4, 2),
    ('deformable_conv_v1', {'strides': [1, 2], 'paddings': [0, 1],
                            'deformable_groups': 2}, 4, 3, 2),
])
def test_deformable_conv(op, attrs, c, o, dg):
    x = _x(2, c, 6, 7, seed=16)
    w = _x(o, c // attrs.get('groups', 1), 3, 3, seed=17, scale=0.3)
    st, pd = attrs['strides'], attrs['paddings']
    dl = attrs.get('dilations', [1, 1])
    oh = (6 + 2 * pd[0] - (dl[0] * 2 + 1)) // st[0] + 1
    ow = (7 + 2 * pd[1] - (dl[1] * 2 + 1)) // st[1] + 1
    # offsets up to 2.5 pixels, some taps sampled outside the map
    offset = np.random.RandomState(18).uniform(
        -2.5, 2.5, (2, 2 * dg * 9, oh, ow)).astype('float32')
    ins = {'Input': [x], 'Offset': [offset], 'Filter': [w]}
    if op == 'deformable_conv':
        ins['Mask'] = [np.random.RandomState(19).rand(
            2, dg * 9, oh, ow).astype('float32')]
    check(op, ins, dict(attrs, im2col_step=1), FWD, GRAD, seed=CT_SEED)


def test_shape_inference_as_the_jax_package():
    cases = [
        ('conv3d', {'Input': [((-1, 3, 16, 112, 112), 'float32')],
                    'Filter': [((64, 3, 3, 3, 3), 'float32')]},
         {'strides': [1, 1, 1], 'paddings': [1, 1, 1]}),
        ('conv3d', {'Input': [((-1, 2, 5, 6, 7), 'float32')],
                    'Filter': [((4, 2, 3, 3, 2), 'float32')]},
         {'strides': [2, 2, 1], 'padding_algorithm': 'SAME'}),
        ('conv3d_transpose', {'Input': [((-1, 4, 3, 4, 3), 'float32')],
                              'Filter': [((4, 3, 3, 2, 3), 'float32')]},
         {'strides': [2, 2, 2], 'paddings': [1, 1, 1]}),
        ('pool3d', {'X': [((-1, 512, 2, 7, 7), 'float32')]},
         {'pooling_type': 'max', 'ksize': [2, 2, 2], 'strides': [2, 2, 2],
          'paddings': [0, 1, 1]}),
        ('trilinear_interp', {'X': [((-1, 3, 4, 5, 6), 'float32')]},
         {'out_d': 8, 'out_h': 3, 'out_w': 7}),
        ('space_to_depth', {'X': [((-1, 3, 8, 6), 'float32')]},
         {'blocksize': 2}),
        ('pixel_shuffle', {'X': [((-1, 12, 3, 4), 'float32')]},
         {'upscale_factor': 2}),
        ('unfold', {'X': [((-1, 3, 7, 8), 'float32')]},
         {'kernel_sizes': [3, 2], 'strides': [1, 2],
          'paddings': [1, 0, 2, 1]}),
        ('spp', {'X': [((-1, 8, 13, 13), 'float32')]},
         {'pyramid_height': 3, 'pooling_type': 'max'}),
        ('affine_grid', {'Theta': [((-1, 2, 3), 'float32')]},
         {'output_shape': [4, 3, 5, 6]}),
        ('crop_tensor', {'X': [((-1, 5, 6), 'float32')]},
         {'shape': [-1, 2, 3], 'offsets': [0, 1, 2]}),
    ]
    for op, specs, attrs in cases:
        want = jreg.infer_shapes(op, specs, attrs)
        got = treg.infer_shapes(op, specs, attrs)
        assert got.keys() == want.keys(), op
        for s in want:
            assert [tuple(sh) for sh, _ in got[s]] == \
                [tuple(sh) for sh, _ in want[s]], (op, s)
