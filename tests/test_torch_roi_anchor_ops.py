"""The RoI pools, anchors and box helpers of item 11b-C (the JAX
package's ops/vision_ops.py roi_pool, psroi_pool, prroi_pool,
anchor_generator, density_prior_box and box_clip, and ops/misc_ops.py
polygon_box_transform, target_assign and deformable_roi_pooling) on the
CPU against the JAX package's lowerings, from the same numpy inputs
(torch_attention_cases.check, cotangents from a seed no input is drawn
from).  bipartite_match, a host op, is in
tests/test_torch_detection_host_ops.py.

Tolerances: f32 forward within rtol FWD = 1e-5 plus 1e-5 of the
output's largest magnitude, gradients within GRAD = 1e-4 of theirs;
bitwise (tol 0) for the anchors and density priors (float32 numpy in
the JAX lowering's order of operations), roi_pool's forward (a copy of
each bin's largest pixel) and target_assign's integer rows.  roi_pool's
gradient on maps with many equal pixels holds the JAX rule for ties:
each of a bin's equal largest pixels gets an even share.
"""

import numpy as np
import pytest

from torch_attention_cases import check
from torch_image_cases import run_torch

FWD = 1e-5
GRAD = 1e-4
CT_SEED = 97  # the cotangents' seed


def _x(*shape, seed=0, scale=1.0):
    return (np.random.RandomState(seed).randn(*shape) * scale).astype(
        'float32')


def _rois(n, seed, lo=-4.0, hi=30.0, side=(0.5, 14.0)):
    rng = np.random.RandomState(seed)
    xy = rng.uniform(lo, hi, (n, 2))
    wh = rng.uniform(side[0], side[1], (n, 2))
    return np.concatenate([xy, xy + wh], 1).astype('float32')


BATCH = np.array([0, 1, 1, 0, 1, 0], 'int32')


@pytest.mark.parametrize('attrs', [
    {'pooled_height': 2, 'pooled_width': 3, 'spatial_scale': 0.5},
    {'pooled_height': 3, 'pooled_width': 3, 'spatial_scale': 0.25},
])
def test_roi_pool(attrs):
    """Rois partly and wholly outside the map (empty bins give 0)."""
    rois = _rois(6, 1)
    rois[5] = [40.0, 40.0, 60.0, 50.0]
    check('roi_pool', {'X': [_x(2, 3, 8, 9, seed=2)], 'ROIs': [rois],
                       'RoisBatch': [BATCH]}, attrs, 0, GRAD, seed=CT_SEED)
    out = run_torch('roi_pool', {'X': [_x(2, 3, 8, 9, seed=2)],
                                 'ROIs': [rois], 'RoisBatch': [BATCH]},
                    attrs)['Out'][0]
    assert (out[5] == 0).all()


def test_roi_pool_ties_share_the_gradient_evenly():
    x = np.random.RandomState(3).randint(0, 3, (2, 2, 8, 9)).astype(
        'float32')
    check('roi_pool', {'X': [x], 'ROIs': [_rois(6, 4, 0.0, 12.0)],
                       'RoisBatch': [BATCH]},
          {'pooled_height': 2, 'pooled_width': 2, 'spatial_scale': 0.5}, 0,
          GRAD, seed=CT_SEED)


@pytest.mark.parametrize('attrs,batch', [
    ({'pooled_height': 2, 'pooled_width': 3, 'output_channels': 2,
      'spatial_scale': 0.5}, True),
    ({'pooled_height': 3, 'pooled_width': 2, 'output_channels': 1,
      'spatial_scale': 1.0}, False),
])
def test_psroi_pool(attrs, batch):
    c = attrs['output_channels'] * attrs['pooled_height'] * \
        attrs['pooled_width']
    ins = {'X': [_x(2, c, 8, 9, seed=5)], 'ROIs': [_rois(6, 6)]}
    if batch:
        ins['RoisBatch'] = [BATCH]
    check('psroi_pool', ins, attrs, FWD, GRAD, seed=CT_SEED)


def test_prroi_pool():
    check('prroi_pool', {'X': [_x(2, 3, 8, 9, seed=7)],
                         'ROIs': [_rois(6, 8)], 'BatchRoINums': [BATCH]},
          {'pooled_height': 2, 'pooled_width': 3, 'spatial_scale': 0.5},
          FWD, GRAD, seed=CT_SEED)
    check('prroi_pool', {'X': [_x(1, 2, 6, 5, seed=9)],
                         'ROIs': [_rois(4, 10, 0.0, 10.0, (0.0, 4.0))]},
          {'pooled_height': 3, 'pooled_width': 2}, FWD, GRAD, seed=CT_SEED)


@pytest.mark.parametrize('attrs', [
    {'anchor_sizes': [32.0, 64.0, 128.0, 256.0, 512.0],
     'aspect_ratios': [0.5, 1.0, 2.0], 'stride': [16.0, 16.0],
     'variances': [1.0, 1.0, 1.0, 1.0]},
    {'anchor_sizes': [24.0], 'aspect_ratios': [0.7, 1.3],
     'stride': [8.0, 12.0], 'offset': 0.25},
])
def test_anchor_generator_bitwise(attrs):
    check('anchor_generator', {'Input': [_x(1, 2, 5, 7, seed=11)]}, attrs,
          0, seed=CT_SEED)


def test_density_prior_box_bitwise():
    check('density_prior_box', {'Input': [_x(1, 2, 4, 5, seed=12)],
                                'Image': [_x(1, 3, 64, 80, seed=13)]},
          {'fixed_sizes': [8.0, 16.0, 32.0], 'fixed_ratios': [1.0, 2.0],
           'densities': [4, 2, 1], 'variances': [0.1, 0.1, 0.2, 0.2]},
          0, seed=CT_SEED)
    check('density_prior_box', {'Input': [_x(1, 2, 3, 3, seed=14)],
                                'Image': [_x(1, 3, 30, 30, seed=15)]},
          {'fixed_sizes': [12.0], 'fixed_ratios': [0.5], 'densities': [3],
           'step_w': 9.0, 'step_h': 11.0, 'offset': 0.3}, 0, seed=CT_SEED)


def test_box_clip():
    boxes = _rois(8, 16, -10.0, 40.0, (1.0, 20.0)).reshape(2, 4, 4)
    check('box_clip', {'Input': [boxes],
                       'ImInfo': [np.array([[24.0, 30.0, 1.2],
                                            [20.0, 20.0, 1.0]], 'float32')]},
          {}, FWD, GRAD, seed=CT_SEED)


def test_polygon_box_transform():
    check('polygon_box_transform', {'Input': [_x(2, 8, 3, 4, seed=17)]}, {},
          FWD, GRAD, seed=CT_SEED)


def test_target_assign_float_rows_and_integer_rows():
    match = np.random.RandomState(18).randint(-1, 4, (2, 7)).astype('int32')
    match[0, :3] = 2                      # three priors on one row
    check('target_assign', {'X': [_x(2, 4, 3, seed=19)],
                            'MatchIndices': [match]},
          {'mismatch_value': 0.5}, FWD, GRAD, seed=CT_SEED)
    labels = np.random.RandomState(20).randint(0, 9, (2, 4, 1)).astype(
        'int32')
    check('target_assign', {'X': [labels], 'MatchIndices': [match]},
          {'mismatch_value': 0}, 0, seed=CT_SEED)


@pytest.mark.parametrize('trans,n_trans', [(True, 6), (True, 2),
                                           (False, 0)])
def test_deformable_roi_pooling(trans, n_trans):
    """Trans per roi, shared by rois k mod 2, and none."""
    ins = {'X': [_x(2, 3, 8, 9, seed=21)], 'ROIs': [_rois(6, 22)],
           'RoisBatch': [BATCH]}
    if trans:
        ins['Trans'] = [_x(n_trans, 2, 3, 3, seed=23)]
    check('deformable_roi_pooling', ins,
          {'pooled_height': 2, 'pooled_width': 3, 'spatial_scale': 0.5,
           'trans_std': 0.2}, FWD, GRAD, seed=CT_SEED)


def test_roi_pool_reads_windows_not_the_map():
    """A 200 x 300 map and 64 small rois: the JAX lowering's mask would
    hold R PH PW C H W = 1.5e9 values; the port gathers each bin's
    window (at most 2 x 2 pixels here) and matches a per-bin numpy max."""
    rng = np.random.RandomState(24)
    x = _x(1, 8, 200, 300, seed=25)
    xy = rng.uniform(0, 280, (64, 2))
    rois = np.concatenate([xy, xy + rng.uniform(1, 7, (64, 2))], 1).astype(
        'float32')
    out = run_torch('roi_pool', {'X': [x], 'ROIs': [rois]},
                    {'pooled_height': 7, 'pooled_width': 7})['Out'][0]
    r = np.round(rois)
    for k in (0, 17, 63):
        bh = max(r[k, 3] - r[k, 1] + 1, 1.0) / 7
        bw = max(r[k, 2] - r[k, 0] + 1, 1.0) / 7
        for i in range(7):
            for j in range(7):
                y0 = int(np.floor(np.float32(r[k, 1] + i * np.float32(bh))))
                y1 = int(np.ceil(np.float32(r[k, 1] + (i + 1) *
                                            np.float32(bh))))
                x0 = int(np.floor(np.float32(r[k, 0] + j * np.float32(bw))))
                x1 = int(np.ceil(np.float32(r[k, 0] + (j + 1) *
                                            np.float32(bw))))
                win = x[0, :, max(y0, 0):min(y1, 200), max(x0, 0):min(x1, 300)]
                np.testing.assert_array_equal(out[k, :, i, j],
                                              win.max(axis=(1, 2)))
