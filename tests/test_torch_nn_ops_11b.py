"""The op types of this slice (the JAX package's ops/nn_ops.py beyond
the port's first ones, `size` of ops/loss_ops.py, and `rank`,
`soft_relu` and `gaussian_random_batch_size_like` of ops/misc_ops.py)
on the CPU against the JAX package's lowerings, from the same numpy
inputs (torch_attention_cases.check: the forward, and the gradient of
every floating input by torch.autograd against jax.vjp under the same
seeded cotangents).

Tolerances: f32 forward within rtol FWD = 1e-5 plus 1e-5 of the
output's largest magnitude, gradients within GRAD = 1e-4 of theirs;
exact (tol 0) for the copies and shifts (temporal_shift, unpool) and
for every integer output (the indexed pools' Masks, size, rank); auc's
statistics bitwise and its AUC within FWD.  The device draws of
gaussian_random_batch_size_like (the port's counter hash, not jax
threefry) are held by their moments.
"""

import numpy as np
import pytest
import torch

from paddle_tpu.ops import registry as jreg

from paddle_tpu_torch.ops import registry as treg

from torch_attention_cases import check, close
from torch_image_cases import run_jax, run_torch

FWD = 1e-5
GRAD = 1e-4


def _x(*shape, seed=0, scale=1.0):
    return (np.random.RandomState(seed).randn(*shape) * scale).astype(
        'float32')


@pytest.mark.parametrize('attrs,in_c,out_cg', [
    ({'strides': [2, 2], 'paddings': [1, 1]}, 3, 4),
    ({'strides': [2, 1], 'paddings': [0, 2, 1, 0]}, 4, 3),
    ({'strides': [1, 2], 'paddings': [1, 0], 'groups': 2}, 4, 3),
    ({'strides': [2, 2], 'paddings': [2, 1, 0, 1], 'dilations': [2, 1],
      'groups': 2}, 6, 2),
    ({'dilations': [2, 3], 'paddings': [3, 3]}, 2, 5),
])
def test_conv2d_transpose(attrs, in_c, out_cg):
    check('conv2d_transpose', {'Input': [_x(2, in_c, 5, 6)],
                               'Filter': [_x(in_c, out_cg, 3, 3, seed=1)]},
          attrs, FWD, GRAD)


def test_depthwise_conv2d_transpose():
    for attrs in ({'strides': [2, 2], 'paddings': [1, 1], 'groups': 4},
                  {'strides': [1, 2], 'paddings': [0, 1],
                   'dilations': [2, 1]}):
        check('depthwise_conv2d_transpose',
              {'Input': [_x(2, 4, 5, 4)],
               'Filter': [_x(4, 1, 3, 2, seed=2)]}, attrs, FWD, GRAD)


def test_instance_and_group_norm():
    x = _x(3, 6, 4, 5, seed=7, scale=3.0) + 2.0
    check('instance_norm', {'X': [x], 'Scale': [_x(6, seed=1)],
                            'Bias': [_x(6, seed=2)]}, {'epsilon': 1e-5},
          FWD, GRAD)
    check('instance_norm', {'X': [x]}, {'epsilon': 1e-3}, FWD, GRAD)
    for g in (1, 2, 6):
        check('group_norm', {'X': [x], 'Scale': [_x(6, seed=1)],
                             'Bias': [_x(6, seed=2)]},
              {'groups': g, 'epsilon': 1e-5}, FWD, GRAD)
    check('group_norm', {'X': [_x(2, 4, 7, seed=8)]}, {'groups': 2}, FWD,
          GRAD)


def test_regression_losses():
    x, y = _x(6, 3), _x(6, 3, seed=1)
    for delta in (0.5, 1.0):
        check('huber_loss', {'X': [x], 'Y': [y]}, {'delta': delta}, FWD,
              GRAD)
    for sigma in (1.0, 3.0):
        check('smooth_l1_loss', {'X': [_x(4, 2, 3)], 'Y': [_x(4, 2, 3, seed=1)]},
              {'sigma': sigma}, FWD, GRAD)
    p = np.random.RandomState(2).uniform(0.05, 0.95, (8, 1)).astype(
        'float32')
    lab = (np.random.RandomState(3).rand(8, 1) > 0.5).astype('float32')
    check('log_loss', {'Predicted': [p], 'Labels': [lab]},
          {'epsilon': 1e-4}, FWD, GRAD)
    check('mse_loss', {'X': [x], 'Y': [y]}, {}, FWD, GRAD)


def test_kldiv_loss():
    x = _x(4, 5)
    t = np.abs(_x(4, 5, seed=1))
    t[0, :2] = 0.0   # the zero-target branch
    for red in ('mean', 'sum', 'batchmean', 'none'):
        check('kldiv_loss', {'X': [x], 'Target': [t]}, {'reduction': red},
              FWD, GRAD)


def test_auc_statistics_bitwise_over_steps():
    rng = np.random.RandomState(4)
    t = 255
    pos = np.zeros(t + 1, 'float32')
    neg = np.zeros(t + 1, 'float32')
    for step in range(3):
        p = rng.rand(200).astype('float32')
        if step == 1:   # both ends of the clip, and exact bucket edges
            p[:4] = [0.0, 1.0, 1.5, -0.2]
            p[4:8] = np.array([1, 2, 3, 4], 'float32') / t
        preds = np.stack([1 - p, p], 1)
        label = (rng.rand(200, 1) < p[:, None]).astype('int64')
        ins = {'Predict': [preds], 'Label': [label], 'StatPos': [pos],
               'StatNeg': [neg]}
        want = run_jax('auc', ins, {'num_thresholds': t})
        got = run_torch('auc', ins, {'num_thresholds': t})
        for s in ('StatPosOut', 'StatNegOut'):
            close(got[s][0], want[s][0], 0, s)
        close(got['AUC'][0], want['AUC'][0], FWD, 'AUC')
        pos, neg = want['StatPosOut'][0], want['StatNegOut'][0]
    assert pos.sum() + neg.sum() == 600


@pytest.mark.parametrize('cases', [
    # integer up, non-integer up
    [((4, 5), {'out_h': 8, 'out_w': 10}), ((4, 6), {'out_h': 7, 'out_w': 9})],
    # integer down, non-integer down
    [((8, 9), {'out_h': 4, 'out_w': 3}), ((7, 10), {'out_h': 3, 'out_w': 6})],
    # one axis unchanged, a scale
    [((6, 5), {'out_h': 9, 'out_w': 5}), ((4, 6), {'scale': 1.5})],
])
def test_interp(cases):
    for hw, attrs in cases:
        x = _x(2, 3, *hw)
        for op in ('bilinear_interp', 'nearest_interp', 'interp_nearest'):
            check(op, {'X': [x]}, dict(attrs, align_corners=True), FWD, GRAD)


def test_grid_sampler():
    x = _x(2, 3, 5, 6)
    grid = np.random.RandomState(5).uniform(-1.2, 1.2, (2, 4, 7, 2)).astype(
        'float32')
    grid[0, 0, 0] = [-1.0, 1.0]   # the corners
    grid[0, 0, 1] = [1.0, -1.0]
    check('grid_sampler', {'X': [x], 'Grid': [grid]}, {}, FWD, GRAD)


def test_temporal_shift_and_lrn():
    for ratio in (0.25, 0.125):
        check('temporal_shift', {'X': [_x(6, 8, 3, 2)]},
              {'seg_num': 3, 'shift_ratio': ratio}, 0, 0)
    x = _x(2, 7, 3, 4, scale=2.0)
    check('lrn', {'X': [x]}, {}, FWD, GRAD)
    check('lrn', {'X': [x]}, {'n': 4, 'k': 2.0, 'alpha': 1e-2,
                              'beta': 0.5}, FWD, GRAD)


def _ties(shape, seed=6):
    """Values on a coarse grid, so many windows hold ties."""
    return np.random.RandomState(seed).randint(-2, 3, shape).astype(
        'float32')


def test_max_pool2d_with_index():
    for attrs in ({'ksize': [2, 2]},
                  {'ksize': [3, 3], 'strides': [2, 2], 'paddings': [1, 1]},
                  {'ksize': [2, 3], 'strides': [1, 2], 'paddings': [0, 1]}):
        check('max_pool2d_with_index', {'X': [_ties((2, 3, 6, 7))]}, attrs,
              FWD, GRAD)
        check('max_pool2d_with_index', {'X': [_x(2, 3, 6, 7)]}, attrs,
              FWD, GRAD)


def test_max_pool3d_with_index():
    for attrs in ({'ksize': [2, 2, 2]},
                  {'ksize': [2, 3, 2], 'strides': [1, 2, 2],
                   'paddings': [0, 1, 1]}):
        check('max_pool3d_with_index', {'X': [_ties((2, 2, 4, 5, 4))]},
              attrs, FWD, GRAD)


def test_unpool_from_the_pool_mask():
    x = _x(2, 3, 6, 8)
    pooled = run_jax('max_pool2d_with_index', {'X': [x]}, {'ksize': [2, 2]})
    ins = {'X': [pooled['Out'][0]], 'Indices': [pooled['Mask'][0]]}
    check('unpool', ins, {'ksize': [2, 2], 'strides': [2, 2]}, 0, 0)
    check('unpool', ins, {'ksize': [2, 2], 'unpooled_size': [7, 9]}, 0, 0)


def test_conv_shift_and_soft_relu():
    check('conv_shift', {'X': [_x(3, 7)], 'Y': [_x(3, 3, seed=1)]}, {},
          FWD, GRAD)
    check('conv_shift', {'X': [_x(2, 5)], 'Y': [_x(2, 5, seed=1)]}, {},
          FWD, GRAD)
    x = _x(4, 6, scale=30.0)
    for t in (40.0, 5.0):
        check('soft_relu', {'X': [x]}, {'threshold': t}, FWD, GRAD)


def test_size_and_rank_exact():
    for shape in ((3, 4, 5), (7,), (2, 1, 1, 6)):
        ins = {'Input': [_x(*shape)]}
        want = run_jax('size', ins, {})['Out'][0]
        got = run_torch('size', ins, {})['Out'][0]
        assert got.dtype == np.int64 and got.shape == (1,)
        np.testing.assert_array_equal(got, want)
        want = run_jax('rank', ins, {})['Out'][0]
        got = run_torch('rank', ins, {})['Out'][0]
        assert got.dtype == want.dtype == np.int32 and got.shape == ()
        assert int(got) == int(want) == len(shape)


def test_gaussian_random_batch_size_like_draws():
    """Moments of 10^5 draws at 6 sigma of their sampling error; the
    shape rule as the JAX op's; another step draws anew, the same step
    again the same."""
    attrs = {'shape': [-1, 500], 'input_dim_idx': 1, 'output_dim_idx': 0,
             'mean': 2.0, 'std': 0.5, 'seed': 0, 'dtype': 'float32'}
    ins = {'Input': [_x(3, 200)]}
    want = run_jax('gaussian_random_batch_size_like', ins, attrs)['Out'][0]

    def draw(step):
        ctx = treg.LowerCtx(step=step, op_seed=11, device='cpu')
        return treg.get('gaussian_random_batch_size_like').run(
            ctx, {'Input': [torch.from_numpy(ins['Input'][0])]},
            attrs)['Out'][0].numpy()
    got = draw(1)
    assert got.shape == want.shape == (200, 500) and got.dtype == np.float32
    n = got.size
    assert abs(got.mean() - 2.0) < 6 * 0.5 / np.sqrt(n)
    assert abs(got.std() - 0.5) < 6 * 0.5 / np.sqrt(2 * n)
    assert abs(want.mean() - 2.0) < 6 * 0.5 / np.sqrt(n)
    np.testing.assert_array_equal(draw(1), got)
    assert not np.array_equal(draw(2), got)


def test_shape_inference_as_the_jax_package():
    cases = [
        ('conv2d_transpose', {'Input': [((-1, 4, 5, 6), 'float32')],
                              'Filter': [((4, 3, 3, 3), 'float32')]},
         {'strides': [2, 2], 'paddings': [1, 0, 2, 1], 'groups': 2}),
        ('bilinear_interp', {'X': [((-1, 3, 6, 5), 'float32')]},
         {'out_h': 12, 'out_w': 7}),
        ('nearest_interp', {'X': [((2, 3, 6, 5), 'float32')]},
         {'scale': 0.5}),
        ('max_pool2d_with_index', {'X': [((-1, 3, 7, 7), 'float32')]},
         {'ksize': [3, 3], 'strides': [2, 2], 'paddings': [1, 1]}),
        ('group_norm', {'X': [((-1, 6, 4, 4), 'float32')]}, {'groups': 3}),
        ('auc', {'Predict': [((-1, 2), 'float32')],
                 'Label': [((-1, 1), 'int64')],
                 'StatPos': [((4096,), 'float32')],
                 'StatNeg': [((4096,), 'float32')]}, {}),
        ('lrn', {'X': [((-1, 8, 5, 5), 'float32')]}, {}),
        ('unpool', {'X': [((2, 3, 3, 4), 'float32')],
                    'Indices': [((2, 3, 3, 4), 'int32')]},
         {'ksize': [2, 2]}),
    ]
    for op, specs, attrs in cases:
        want = jreg.infer_shapes(op, specs, attrs)
        got = treg.infer_shapes(op, specs, attrs)
        assert got.keys() == want.keys(), op
        for s in want:
            assert [tuple(sh) for sh, _ in got[s]] == \
                [tuple(sh) for sh, _ in want[s]], (op, s)
