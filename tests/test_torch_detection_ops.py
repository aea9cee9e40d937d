"""The detection op types of the JAX package's ops/detection_ops.py and
box_decoder_and_assign (ROADMAP Queue 1 item 11b-C) on the CPU against
the JAX package's lowerings, from the same numpy inputs
(torch_attention_cases.check: the forward, and the gradient of every
floating input by torch.autograd against jax.vjp under cotangents drawn
from a seed no input is drawn from).

Tolerances: f32 forward within rtol FWD = 1e-5 plus 1e-5 of the
output's largest magnitude, gradients within GRAD = 1e-4 of theirs;
bitwise (tol 0) for the outputs the JAX lowering computes exactly:
prior_box (numpy), multiclass_nms (copies of the inputs picked by the
greedy NMS) and generate_proposals' picks.  The NMS cases are drawn so
that no IoU lies within 1e-6 of the threshold (``_far_from``), and hold
the JAX lowering's behaviour: a zero-area box has IoU 0 with itself and
is picked at every step, tied scores keep the lower index first, and
the rows past the last pick are padding.
"""

import numpy as np
import pytest

from torch_attention_cases import check, close
from torch_image_cases import run_jax, run_torch

FWD = 1e-5
GRAD = 1e-4
CT_SEED = 97  # the cotangents' seed


def _x(*shape, seed=0, scale=1.0):
    return (np.random.RandomState(seed).randn(*shape) * scale).astype(
        'float32')


def _boxes(n, seed, lo=0.0, hi=20.0, side=(1.0, 10.0)):
    rng = np.random.RandomState(seed)
    xy = rng.uniform(lo, hi, (n, 2))
    wh = rng.uniform(side[0], side[1], (n, 2))
    return np.concatenate([xy, xy + wh], 1).astype('float32')


def _iou64(a, b, offset=0.0):
    a, b = a.astype('float64'), b.astype('float64')
    lt = np.maximum(a[:, None, :2], b[None, :, :2])
    rb = np.minimum(a[:, None, 2:], b[None, :, 2:])
    inter = np.prod(np.maximum(rb - lt + offset, 0), -1)
    area = lambda x: np.prod(x[:, 2:] - x[:, :2] + offset, -1)  # noqa
    return inter / np.maximum(area(a)[:, None] + area(b)[None] - inter,
                              1e-30)


def _far_from(boxes, thr, offset=0.0):
    """Every pair of `boxes` at an IoU at least 1e-6 from thr (the NMS
    decisions cannot depend on the order of rounding)."""
    iou = _iou64(boxes, boxes, offset)
    np.fill_diagonal(iou, 0.0)
    assert np.abs(iou - thr).min() > 1e-6


@pytest.mark.parametrize('attrs', [
    {'min_sizes': [8.0, 16.0], 'max_sizes': [12.0, 24.0],
     'aspect_ratios': [2.0, 3.0], 'flip': True, 'clip': True},
    {'min_sizes': [60.0], 'aspect_ratios': [2.0, 2.0000001], 'flip': False,
     'step_w': 8.0, 'step_h': 6.0, 'offset': 0.25,
     'variances': [0.1, 0.2, 0.3, 0.4]},
])
def test_prior_box_bitwise(attrs):
    check('prior_box', {'Input': [_x(2, 3, 4, 5)],
                        'Image': [_x(2, 3, 40, 50, seed=1)]}, attrs, 0,
          seed=CT_SEED)


def test_box_coder_encode_and_decode():
    prior, target = _boxes(6, 2), _boxes(6, 3)
    var = np.abs(_x(6, 4, seed=4)) + 0.1
    check('box_coder', {'PriorBox': [prior], 'TargetBox': [target],
                        'PriorBoxVar': [var]},
          {'code_type': 'encode_center_size'}, FWD, GRAD, seed=CT_SEED)
    check('box_coder', {'PriorBox': [prior], 'TargetBox': [target]},
          {'code_type': 'encode_center_size', 'variance': [9.0] * 4}, FWD,
          GRAD, seed=CT_SEED)
    check('box_coder', {'PriorBox': [prior], 'PriorBoxVar': [var],
                        'TargetBox': [_x(3, 6, 4, seed=5, scale=0.5)]},
          {'code_type': 'decode_center_size'}, FWD, GRAD, seed=CT_SEED)


def test_iou_similarity():
    x, y = _boxes(5, 6), _boxes(7, 7)
    y[0] = x[0]                    # a pair that overlaps exactly
    check('iou_similarity', {'X': [x], 'Y': [y]}, {}, FWD, GRAD,
          seed=CT_SEED)


def test_yolo_box():
    check('yolo_box', {'X': [_x(2, 3 * (5 + 4), 4, 5, seed=8)],
                       'ImgSize': [np.array([[128, 160], [96, 120]],
                                            'int32')]},
          {'anchors': [10, 13, 16, 30, 33, 23], 'class_num': 4,
           'conf_thresh': 0.3, 'downsample_ratio': 32}, FWD, seed=CT_SEED)


def _nms_case(n, c, m, thr, seed):
    rng = np.random.RandomState(seed)
    boxes = np.stack([_boxes(m, seed + i, hi=30.0) for i in range(n)])
    for b in boxes:
        _far_from(b, thr)
    return {'BBoxes': [boxes],
            'Scores': [rng.rand(n, c, m).astype('float32')]}


@pytest.mark.parametrize('keep', [25, 200])
def test_multiclass_nms_bitwise(keep):
    ins = _nms_case(2, 3, 30, 0.4, seed=9)
    attrs = {'score_threshold': 0.5, 'nms_top_k': 20, 'keep_top_k': keep,
             'nms_threshold': 0.4}
    check('multiclass_nms', ins, attrs, 0, seed=CT_SEED)
    out = run_torch('multiclass_nms', ins, attrs)['Out'][0]
    assert out.shape == (2, min(keep, 3 * 20), 6)
    kept = out[..., 0] >= 0
    assert kept.all() if keep == 25 else 5 < kept.sum() < kept.size
    assert (out[~kept] == np.float32([-1, 0, 0, 0, 0, 0])).all()


def test_multiclass_nms_in_slices_of_pairs(monkeypatch):
    """The pairs' IoUs computed a few rows at a time, as at
    generate_proposals' 12,000 boxes."""
    from paddle_tpu_torch.ops import detection_ops
    monkeypatch.setattr(detection_ops, '_PAIRS', 50)
    check('multiclass_nms', _nms_case(2, 3, 30, 0.4, seed=9),
          {'score_threshold': 0.5, 'nms_top_k': 20, 'keep_top_k': 60,
           'nms_threshold': 0.4}, 0, seed=CT_SEED)


def test_multiclass_nms_zero_area_box_is_picked_every_step():
    """The JAX lowering's greedy loop: a zero-area box's IoU with itself
    is 0, so it never suppresses itself and comes out of every step."""
    ins = {'BBoxes': [np.array([[[0, 0, 10, 10], [5, 5, 5, 5],
                                 [50, 50, 60, 60]]], 'float32')],
           'Scores': [np.array([[[0.7, 0.9, 0.8]]], 'float32')]}
    attrs = {'score_threshold': 0.05, 'nms_top_k': 3, 'keep_top_k': 3,
             'nms_threshold': 0.5}
    check('multiclass_nms', ins, attrs, 0, seed=CT_SEED)
    out = run_torch('multiclass_nms', ins, attrs)['Out'][0]
    np.testing.assert_array_equal(
        out[0], np.tile(np.float32([0, 0.9, 5, 5, 5, 5]), (3, 1)))


def test_multiclass_nms_ties_and_nothing_above_the_threshold():
    boxes = np.array([[[0, 0, 1, 1], [2, 2, 3, 3], [4, 4, 5, 5],
                       [0, 0, 1, 1.2]]], 'float32')
    tied = {'BBoxes': [boxes], 'Scores': [np.full((1, 2, 4), 0.5,
                                                  'float32')]}
    attrs = {'score_threshold': 0.1, 'nms_top_k': 4, 'keep_top_k': 8,
             'nms_threshold': 0.5}
    check('multiclass_nms', tied, attrs, 0, seed=CT_SEED)
    out = run_torch('multiclass_nms', tied, attrs)['Out'][0][0]
    # class 0's boxes 0, 1, 2 (3 overlaps 0), then class 1's
    np.testing.assert_array_equal(out[:, 0], [0, 0, 0, 1, 1, 1, -1, -1])
    np.testing.assert_array_equal(out[:3, 2], [0, 2, 4])
    low = {'BBoxes': [boxes], 'Scores': [np.full((1, 2, 4), 0.05,
                                                 'float32')]}
    check('multiclass_nms', low, attrs, 0, seed=CT_SEED)
    assert (run_torch('multiclass_nms', low, attrs)['Out'][0][..., 0]
            == -1).all()


@pytest.mark.parametrize('attrs,batch', [
    ({'pooled_height': 2, 'pooled_width': 3, 'spatial_scale': 0.5,
      'sampling_ratio': 0}, True),
    ({'pooled_height': 3, 'pooled_width': 2, 'spatial_scale': 0.25,
      'sampling_ratio': 3}, False),
])
def test_roi_align(attrs, batch):
    rois = _boxes(5, 10, lo=-4.0, hi=30.0, side=(0.5, 14.0))
    ins = {'X': [_x(2, 3, 8, 9, seed=11)], 'ROIs': [rois]}
    if batch:
        ins['RoisBatch'] = [np.array([0, 1, 1, 0, 1], 'int32')]
    check('roi_align', ins, attrs, FWD, GRAD, seed=CT_SEED)


def _anchors(h, w, sizes, ratios, stride):
    return run_torch('anchor_generator', {'Input': [_x(1, 1, h, w)]}, {
        'anchor_sizes': sizes, 'aspect_ratios': ratios,
        'stride': [stride, stride], 'variances': [1.0] * 4})['Anchors'][0]


def test_generate_proposals_picks_bitwise():
    """Two images; the boxes are decoded with exp (XLA's and PyTorch's
    may round differently), so they are held within FWD and the picks
    by their order: the indices of the kept boxes and the padding."""
    anchors = _anchors(4, 5, [16.0, 32.0], [0.5, 1.0, 2.0], 16.0)
    rng = np.random.RandomState(12)
    ins = {'Scores': [rng.rand(2, 6, 4, 5).astype('float32')],
           'BboxDeltas': [_x(2, 24, 4, 5, seed=13, scale=0.3)],
           'ImInfo': [np.array([[64, 80, 1.0], [60, 72, 1.5]], 'float32')],
           'Anchors': [anchors], 'Variances': [np.ones_like(anchors)]}
    attrs = {'pre_nms_topN': 80, 'post_nms_topN': 75, 'nms_thresh': 0.5,
             'min_size': 4.0}
    want = run_jax('generate_proposals', ins, attrs)
    got = run_torch('generate_proposals', ins, attrs)
    for s in want:
        close(got[s][0], want[s][0], FWD, s)
    probs = got['RpnRoiProbs'][0][..., 0]
    np.testing.assert_array_equal(probs > 0, want['RpnRoiProbs'][0][..., 0]
                                  > 0)
    # fewer boxes survive than post_nms_topN: zero rows pad the rest
    n_kept = (probs > 0).sum(1)
    assert (n_kept < 75).all() and (n_kept > 3).all()
    assert (got['RpnRois'][0][probs == 0] == 0).all()
    for i in range(2):
        _far_from(got['RpnRois'][0][i, :n_kept[i]], 0.5, offset=1.0)


def test_sigmoid_focal_loss():
    rng = np.random.RandomState(14)
    for fg in (np.array([3], 'int32'), np.array([0], 'int32')):
        check('sigmoid_focal_loss',
              {'X': [_x(6, 4, seed=15)],
               'Label': [rng.randint(0, 5, (6, 1)).astype('int32')],
               'FgNum': [fg]}, {'gamma': 1.5, 'alpha': 0.3}, FWD, GRAD,
              seed=CT_SEED)


def test_yolov3_loss_with_boxes_sharing_a_cell():
    rng = np.random.RandomState(16)
    gt = np.zeros((2, 4, 4), 'float32')
    gt[:, :3, :2] = rng.uniform(0.05, 0.95, (2, 3, 2))
    gt[:, :3, 2:] = np.float32([0.3, 0.25])
    gt[0, 1, :2] = gt[0, 0, :2] + 0.01      # two boxes in one cell
    check('yolov3_loss', {'X': [_x(2, 2 * (5 + 3), 4, 4, seed=17)],
                          'GTBox': [gt],
                          'GTLabel': [rng.randint(0, 3, (2, 4)).astype(
                              'int32')]},
          {'anchors': [10, 13, 16, 30, 33, 23, 30, 61], 'anchor_mask': [1, 2],
           'class_num': 3, 'ignore_thresh': 0.5, 'downsample_ratio': 8},
          FWD, GRAD, seed=CT_SEED)


def test_ssd_loss():
    rng = np.random.RandomState(18)
    gt = np.stack([_boxes(3, 19, 0, 0.6, (0.1, 0.4)),
                   _boxes(3, 20, 0, 0.6, (0.1, 0.4))])
    gt[1, 2] = 0.0                            # a padding row
    check('ssd_loss', {'Location': [_x(2, 12, 4, seed=21, scale=0.3)],
                       'Confidence': [_x(2, 12, 5, seed=22)],
                       'GtBox': [gt],
                       'GtLabel': [rng.randint(1, 5, (2, 3)).astype('int32')],
                       'PriorBox': [_boxes(12, 23, 0, 0.6, (0.1, 0.4))]},
          {'overlap_threshold': 0.3, 'neg_pos_ratio': 2.0}, FWD, GRAD,
          seed=CT_SEED)


def test_box_decoder_and_assign():
    check('box_decoder_and_assign',
          {'PriorBox': [_boxes(5, 24)], 'TargetBox': [_x(5, 12, seed=25,
                                                        scale=0.3)],
           'BoxScore': [_x(5, 3, seed=26)]}, {'box_clip': 4.135}, FWD, GRAD,
          seed=CT_SEED)


def test_prior_box_shape_inference_gives_the_priors():
    """The port infers prior_box's [H, W, priors, 4] (fault 1 of the
    JAX package's layers, which declare no shape) on meta tensors."""
    from paddle_tpu_torch.ops import registry as treg
    out = treg.infer_shapes('prior_box', {
        'Input': [((-1, 8, 19, 19), 'float32')],
        'Image': [((-1, 3, 300, 300), 'float32')]},
        {'min_sizes': [60.0], 'aspect_ratios': [2.0], 'flip': True})
    assert out['Boxes'][0][0] == (19, 19, 3, 4)
