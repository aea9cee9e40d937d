"""Detection layers (the JAX package's layers/detection.py; reference
python/paddle/fluid/layers/detection.py over operators/detection/):
builders for ops/detection_ops.py, ops/vision_ops.py and
ops/detection_host_ops.py.  Results whose count depends on the data are
padded, as the lowerings give them (label -1 rows).

Each appends the ops, attributes and variables the JAX layer appends,
but where the JAX layer leaves a shape undeclared that a later layer
needs (it appends its ops with infer_shape=False), and the reference
infers one: prior_box infers [H, W, num_priors, 4], the host-op layers
declare their outputs' row counts -1 ([-1, 4] rois, [-1, 1] labels, as
the reference's InferShape), and multi_box_head takes each map's prior
count from its prior_box's shape (the JAX layer counts len(ratios) x
(2 with flip) + (1 with a max size), which leaves out the ratio-1 prior
that prior_box always adds).
"""

import numpy as np

from ..framework import Variable
from ..layer_helper import LayerHelper

__all__ = ['prior_box', 'box_coder', 'iou_similarity', 'yolo_box',
           'yolov3_loss', 'multiclass_nms', 'sigmoid_focal_loss',
           'generate_proposals', 'detection_output', 'multi_box_head',
           'ssd_loss', 'target_assign', 'polygon_box_transform',
           'rpn_target_assign', 'retinanet_target_assign',
           'retinanet_detection_output', 'generate_proposal_labels',
           'generate_mask_labels', 'distribute_fpn_proposals',
           'collect_fpn_proposals', 'locality_aware_nms',
           'roi_perspective_transform', 'box_decoder_and_assign']


def _mk(helper, dtype):
    return helper.create_variable_for_type_inference(dtype)


def _declare(*pairs):
    """Give a host op's outputs the shapes the reference infers (their
    row counts -1: they depend on the data)."""
    for var, shape in pairs:
        var.shape = tuple(shape)


def prior_box(input, image, min_sizes, max_sizes=None,
              aspect_ratios=(1.0,), variance=(0.1, 0.1, 0.2, 0.2),
              flip=False, clip=False, steps=(0.0, 0.0), offset=0.5,
              name=None, min_max_aspect_ratios_order=False):
    helper = LayerHelper('prior_box', name=name)
    boxes = _mk(helper, input.dtype)
    variances = _mk(helper, input.dtype)
    helper.append_op(
        'prior_box', inputs={'Input': input, 'Image': image},
        outputs={'Boxes': boxes, 'Variances': variances},
        attrs={'min_sizes': list(min_sizes),
               'max_sizes': list(max_sizes or []),
               'aspect_ratios': list(aspect_ratios),
               'variances': list(variance), 'flip': flip, 'clip': clip,
               'step_w': steps[0], 'step_h': steps[1], 'offset': offset,
               'min_max_aspect_ratios_order':
                   min_max_aspect_ratios_order})
    return boxes, variances


def box_coder(prior_box, prior_box_var, target_box,
              code_type='encode_center_size', box_normalized=True,
              name=None, axis=0):
    helper = LayerHelper('box_coder', name=name)
    out = _mk(helper, target_box.dtype)
    ins = {'PriorBox': prior_box, 'TargetBox': target_box}
    attrs = {'code_type': code_type, 'box_normalized': box_normalized,
             'axis': axis}
    if isinstance(prior_box_var, Variable):
        ins['PriorBoxVar'] = prior_box_var
    elif prior_box_var is not None:
        attrs['variance'] = list(prior_box_var)
    helper.append_op('box_coder', inputs=ins,
                     outputs={'OutputBox': out}, attrs=attrs,
                     infer_shape=False)
    return out


def iou_similarity(x, y, box_normalized=True, name=None):
    helper = LayerHelper('iou_similarity', name=name)
    out = _mk(helper, x.dtype)
    helper.append_op('iou_similarity', inputs={'X': x, 'Y': y},
                     outputs={'Out': out},
                     attrs={'box_normalized': box_normalized},
                     infer_shape=False)
    return out


def yolo_box(x, img_size, anchors, class_num, conf_thresh,
             downsample_ratio, clip_bbox=True, name=None):
    helper = LayerHelper('yolo_box', name=name)
    boxes = _mk(helper, x.dtype)
    scores = _mk(helper, x.dtype)
    helper.append_op('yolo_box',
                     inputs={'X': x, 'ImgSize': img_size},
                     outputs={'Boxes': boxes, 'Scores': scores},
                     attrs={'anchors': list(anchors),
                            'class_num': class_num,
                            'conf_thresh': conf_thresh,
                            'downsample_ratio': downsample_ratio,
                            'clip_bbox': clip_bbox},
                     infer_shape=False)
    return boxes, scores


def yolov3_loss(x, gt_box, gt_label, anchors, anchor_mask, class_num,
                ignore_thresh, downsample_ratio, gt_score=None,
                use_label_smooth=True, name=None):
    helper = LayerHelper('yolov3_loss', name=name)
    loss = _mk(helper, x.dtype)
    obj_mask = _mk(helper, x.dtype)
    gt_match = _mk(helper, 'int32')
    ins = {'X': x, 'GTBox': gt_box, 'GTLabel': gt_label}
    if gt_score is not None:
        ins['GTScore'] = gt_score
    helper.append_op('yolov3_loss', inputs=ins,
                     outputs={'Loss': loss,
                              'ObjectnessMask': obj_mask,
                              'GTMatchMask': gt_match},
                     attrs={'anchors': list(anchors),
                            'anchor_mask': list(anchor_mask),
                            'class_num': class_num,
                            'ignore_thresh': ignore_thresh,
                            'downsample_ratio': downsample_ratio,
                            'use_label_smooth': use_label_smooth},
                     infer_shape=False)
    return loss


def multiclass_nms(bboxes, scores, score_threshold, nms_top_k,
                   keep_top_k, nms_threshold=0.3, normalized=True,
                   nms_eta=1.0, background_label=0, name=None):
    helper = LayerHelper('multiclass_nms', name=name)
    out = _mk(helper, bboxes.dtype)
    helper.append_op('multiclass_nms',
                     inputs={'BBoxes': bboxes, 'Scores': scores},
                     outputs={'Out': out},
                     attrs={'score_threshold': score_threshold,
                            'nms_top_k': nms_top_k,
                            'keep_top_k': keep_top_k,
                            'nms_threshold': nms_threshold,
                            'normalized': normalized,
                            'nms_eta': nms_eta,
                            'background_label': background_label},
                     infer_shape=False)
    return out


def sigmoid_focal_loss(x, label, fg_num, gamma=2.0, alpha=0.25,
                       name=None):
    helper = LayerHelper('sigmoid_focal_loss', name=name)
    out = _mk(helper, x.dtype)
    helper.append_op('sigmoid_focal_loss',
                     inputs={'X': x, 'Label': label, 'FgNum': fg_num},
                     outputs={'Out': out},
                     attrs={'gamma': gamma, 'alpha': alpha},
                     infer_shape=False)
    return out


def generate_proposals(scores, bbox_deltas, im_info, anchors, variances,
                       pre_nms_top_n=6000, post_nms_top_n=1000,
                       nms_thresh=0.5, min_size=0.1, eta=1.0, name=None):
    helper = LayerHelper('generate_proposals', name=name)
    rois = _mk(helper, scores.dtype)
    roi_probs = _mk(helper, scores.dtype)
    helper.append_op('generate_proposals',
                     inputs={'Scores': scores,
                             'BboxDeltas': bbox_deltas,
                             'ImInfo': im_info, 'Anchors': anchors,
                             'Variances': variances},
                     outputs={'RpnRois': rois,
                              'RpnRoiProbs': roi_probs},
                     attrs={'pre_nms_topN': pre_nms_top_n,
                            'post_nms_topN': post_nms_top_n,
                            'nms_thresh': nms_thresh,
                            'min_size': min_size, 'eta': eta},
                     infer_shape=False)
    return rois, roi_probs


def detection_output(loc, scores, prior_box, prior_box_var,
                     background_label=0, nms_threshold=0.3,
                     nms_top_k=400, keep_top_k=200,
                     score_threshold=0.01, nms_eta=1.0):
    """decode (box_coder) + multiclass_nms, the reference's composite
    (layers/detection.py detection_output)."""
    from . import nn as _nn
    decoded = box_coder(prior_box, prior_box_var, loc,
                        code_type='decode_center_size')
    # scores [N, P, C] -> [N, C, P] for per-class NMS
    scores_t = _nn.transpose(scores, perm=[0, 2, 1])
    return multiclass_nms(decoded, scores_t, score_threshold,
                          nms_top_k, keep_top_k, nms_threshold,
                          background_label=background_label,
                          nms_eta=nms_eta)


def multi_box_head(inputs, image, base_size, num_classes, aspect_ratios,
                   min_ratio=None, max_ratio=None, min_sizes=None,
                   max_sizes=None, steps=None, step_w=None, step_h=None,
                   offset=0.5, variance=(0.1, 0.1, 0.2, 0.2), flip=True,
                   clip=False, kernel_size=1, pad=0, stride=1,
                   name=None, min_max_aspect_ratios_order=False):
    """SSD detection head (reference layers/detection.py
    multi_box_head): per-feature-map priors + conv loc/conf
    predictions, concatenated."""
    from . import nn as _nn
    from . import tensor as _t
    n_layer = len(inputs)
    if min_sizes is None:
        # reference ratio interpolation
        min_sizes, max_sizes = [], []
        step = int(np.floor((max_ratio - min_ratio) /
                            (n_layer - 2))) if n_layer > 2 else 100
        for ratio in range(min_ratio, max_ratio + 1, step):
            min_sizes.append(base_size * ratio / 100.0)
            max_sizes.append(base_size * (ratio + step) / 100.0)
        min_sizes = [base_size * 0.1] + min_sizes
        max_sizes = [base_size * 0.2] + max_sizes
    locs, confs, boxes, vars_ = [], [], [], []
    for i, x in enumerate(inputs):
        mins = min_sizes[i]
        maxs = max_sizes[i] if max_sizes else None
        ar = aspect_ratios[i] if isinstance(aspect_ratios[i],
                                            (list, tuple)) \
            else [aspect_ratios[i]]
        st = steps[i] if steps else (step_w[i] if step_w else 0.0,
                                     step_h[i] if step_h else 0.0)
        if not isinstance(st, (list, tuple)):
            st = (st, st)
        box, var = prior_box(
            x, image, [mins] if not isinstance(mins, (list, tuple))
            else list(mins),
            [maxs] if maxs and not isinstance(maxs, (list, tuple))
            else (list(maxs) if maxs else None),
            ar, variance, flip, clip, st, offset,
            min_max_aspect_ratios_order=min_max_aspect_ratios_order)
        num_px = box.shape[2]
        num_loc = num_px * 4
        num_conf = num_px * num_classes
        loc = _nn.conv2d(x, num_loc, kernel_size, padding=pad,
                         stride=stride)
        conf = _nn.conv2d(x, num_conf, kernel_size, padding=pad,
                          stride=stride)
        # [N, C, H, W] -> [N, H*W*px, 4|classes]
        loc = _nn.transpose(loc, perm=[0, 2, 3, 1])
        conf = _nn.transpose(conf, perm=[0, 2, 3, 1])
        loc = _nn.reshape(loc, shape=[0, -1, 4])
        conf = _nn.reshape(conf, shape=[0, -1, num_classes])
        locs.append(loc)
        confs.append(conf)
        boxes.append(_nn.reshape(box, shape=[-1, 4]))
        vars_.append(_nn.reshape(var, shape=[-1, 4]))
    mbox_locs = _t.concat(locs, axis=1)
    mbox_confs = _t.concat(confs, axis=1)
    box = _t.concat(boxes, axis=0)
    var = _t.concat(vars_, axis=0)
    return mbox_locs, mbox_confs, box, var


def ssd_loss(location, confidence, gt_box, gt_label, prior_box,
             prior_box_var=None, background_label=0, overlap_threshold=0.5,
             neg_pos_ratio=3.0, neg_overlap=0.5, loc_loss_weight=1.0,
             conf_loss_weight=1.0, match_type='per_prediction',
             mining_type='max_negative', normalize=True,
             sample_size=None):
    """SSD training loss (reference layers/detection.py ssd_loss) —
    one fused lowering (ops/detection_ops.py ssd_loss): per-prior
    best-gt IoU matching, smooth-L1 loc loss, softmax CE with negatives
    down-weighted at neg_pos_ratio (smooth surrogate of hard-negative
    mining).  location [N,P,4], confidence [N,P,C], gt_box [N,G,4]
    zero-padded dense, gt_label [N,G], prior_box [P,4]."""
    helper = LayerHelper('ssd_loss')
    loss = _mk(helper, location.dtype)
    variance = list(prior_box_var) if prior_box_var is not None and \
        not isinstance(prior_box_var, Variable) else [0.1, 0.1, 0.2, 0.2]
    helper.append_op('ssd_loss',
                     inputs={'Location': location,
                             'Confidence': confidence,
                             'GtBox': gt_box, 'GtLabel': gt_label,
                             'PriorBox': prior_box},
                     outputs={'Loss': loss},
                     attrs={'variance': variance,
                            'overlap_threshold': overlap_threshold,
                            'neg_pos_ratio': neg_pos_ratio,
                            'background_label': background_label},
                     infer_shape=False)
    return loss


def target_assign(input, matched_indices, negative_indices=None,
                  mismatch_value=None, name=None):
    helper = LayerHelper('target_assign', name=name)
    out = _mk(helper, input.dtype)
    out_wt = _mk(helper, input.dtype)
    helper.append_op('target_assign',
                     inputs={'X': input,
                             'MatchIndices': matched_indices},
                     outputs={'Out': out, 'OutWeight': out_wt},
                     attrs={'mismatch_value': mismatch_value or 0},
                     infer_shape=False)
    return out, out_wt


def polygon_box_transform(input, name=None):
    helper = LayerHelper('polygon_box_transform', name=name)
    out = _mk(helper, input.dtype)
    helper.append_op('polygon_box_transform', inputs={'Input': input},
                     outputs={'Out': out}, infer_shape=False)
    out.shape = input.shape
    return out


def rpn_target_assign(bbox_pred, cls_logits, anchor_box, anchor_var,
                      gt_boxes, is_crowd=None, im_info=None,
                      rpn_batch_size_per_im=256, rpn_straddle_thresh=0.0,
                      rpn_fg_fraction=0.5, rpn_positive_overlap=0.7,
                      rpn_negative_overlap=0.3, use_random=True):
    helper = LayerHelper('rpn_target_assign')
    loc_index = _mk(helper, 'int32')
    score_index = _mk(helper, 'int32')
    target_label = _mk(helper, 'int32')
    target_bbox = _mk(helper, anchor_box.dtype)
    bbox_inside_weight = _mk(helper, anchor_box.dtype)
    helper.append_op(
        'rpn_target_assign',
        inputs={'Anchor': anchor_box, 'GtBoxes': gt_boxes},
        outputs={'LocationIndex': loc_index,
                 'ScoreIndex': score_index,
                 'TargetLabel': target_label,
                 'TargetBBox': target_bbox,
                 'BBoxInsideWeight': bbox_inside_weight},
        attrs={'rpn_batch_size_per_im': rpn_batch_size_per_im,
               'rpn_positive_overlap': rpn_positive_overlap,
               'rpn_negative_overlap': rpn_negative_overlap,
               'rpn_fg_fraction': rpn_fg_fraction},
        infer_shape=False)
    _declare((loc_index, [-1]), (score_index, [-1]), (target_label, [-1, 1]),
             (target_bbox, [-1, 4]), (bbox_inside_weight, [-1, 4]))
    return (loc_index, score_index, target_label, target_bbox,
            bbox_inside_weight)


def retinanet_target_assign(bbox_pred, cls_logits, anchor_box,
                            anchor_var, gt_boxes, gt_labels, is_crowd,
                            im_info, num_classes=1,
                            positive_overlap=0.5,
                            negative_overlap=0.4):
    return rpn_target_assign(
        bbox_pred, cls_logits, anchor_box, anchor_var, gt_boxes,
        is_crowd, im_info,
        rpn_positive_overlap=positive_overlap,
        rpn_negative_overlap=negative_overlap) + (None,)


def retinanet_detection_output(bboxes, scores, im_info,
                               score_threshold=0.05, nms_top_k=1000,
                               keep_top_k=100, nms_threshold=0.3,
                               nms_eta=1.0):
    from . import tensor as _t
    from . import nn as _nn
    all_boxes = _t.concat(bboxes, axis=1) if isinstance(
        bboxes, (list, tuple)) else bboxes
    all_scores = _t.concat(scores, axis=1) if isinstance(
        scores, (list, tuple)) else scores
    scores_t = _nn.transpose(all_scores, perm=[0, 2, 1])
    return multiclass_nms(all_boxes, scores_t, score_threshold,
                          nms_top_k, keep_top_k, nms_threshold,
                          background_label=-1, nms_eta=nms_eta)


def generate_proposal_labels(rpn_rois, gt_classes, is_crowd, gt_boxes,
                             im_info, batch_size_per_im=256,
                             fg_fraction=0.25, fg_thresh=0.5,
                             bg_thresh_hi=0.5, bg_thresh_lo=0.0,
                             bbox_reg_weights=(0.1, 0.1, 0.2, 0.2),
                             class_nums=None, use_random=True,
                             is_cls_agnostic=False,
                             is_cascade_rcnn=False):
    helper = LayerHelper('generate_proposal_labels')
    rois = _mk(helper, rpn_rois.dtype)
    labels = _mk(helper, 'int32')
    bbox_targets = _mk(helper, rpn_rois.dtype)
    bbox_inside = _mk(helper, rpn_rois.dtype)
    bbox_outside = _mk(helper, rpn_rois.dtype)
    helper.append_op(
        'generate_proposal_labels',
        inputs={'RpnRois': rpn_rois, 'GtClasses': gt_classes,
                'GtBoxes': gt_boxes},
        outputs={'Rois': rois, 'LabelsInt32': labels,
                 'BboxTargets': bbox_targets,
                 'BboxInsideWeights': bbox_inside,
                 'BboxOutsideWeights': bbox_outside},
        attrs={'batch_size_per_im': batch_size_per_im,
               'fg_fraction': fg_fraction, 'fg_thresh': fg_thresh,
               'bg_thresh_hi': bg_thresh_hi,
               'bg_thresh_lo': bg_thresh_lo},
        infer_shape=False)
    _declare((rois, [-1, 4]), (labels, [-1, 1]), (bbox_targets, [-1, 4]),
             (bbox_inside, [-1, 4]), (bbox_outside, [-1, 4]))
    return rois, labels, bbox_targets, bbox_inside, bbox_outside


def generate_mask_labels(im_info, gt_classes, is_crowd, gt_segms, rois,
                         labels_int32, num_classes, resolution):
    helper = LayerHelper('generate_mask_labels')
    mask_rois = _mk(helper, rois.dtype)
    has_mask = _mk(helper, 'int32')
    mask_int32 = _mk(helper, 'int32')
    helper.append_op('generate_mask_labels',
                     inputs={'Rois': rois},
                     outputs={'MaskRois': mask_rois,
                              'RoiHasMaskInt32': has_mask,
                              'MaskInt32': mask_int32},
                     attrs={'resolution': resolution},
                     infer_shape=False)
    _declare((mask_rois, [-1, 4]), (has_mask, [-1, 1]),
             (mask_int32, [-1, resolution * resolution]))
    return mask_rois, has_mask, mask_int32


def distribute_fpn_proposals(fpn_rois, min_level, max_level, refer_level,
                             refer_scale, name=None):
    helper = LayerHelper('distribute_fpn_proposals', name=name)
    n = max_level - min_level + 1
    outs = [_mk(helper, fpn_rois.dtype) for _ in range(n)]
    restore = _mk(helper, 'int32')
    helper.append_op('distribute_fpn_proposals',
                     inputs={'FpnRois': fpn_rois},
                     outputs={'MultiFpnRois': outs,
                              'RestoreIndex': restore},
                     attrs={'min_level': min_level,
                            'max_level': max_level,
                            'refer_level': refer_level,
                            'refer_scale': refer_scale},
                     infer_shape=False)
    _declare(*[(v, [-1, 4]) for v in outs], (restore, [-1, 1]))
    return outs, restore


def collect_fpn_proposals(multi_rois, multi_scores, min_level, max_level,
                          post_nms_top_n, name=None):
    helper = LayerHelper('collect_fpn_proposals', name=name)
    out = _mk(helper, multi_rois[0].dtype)
    helper.append_op('collect_fpn_proposals',
                     inputs={'MultiLevelRois': list(multi_rois),
                             'MultiLevelScores': list(multi_scores)},
                     outputs={'FpnRois': out},
                     attrs={'post_nms_topN': post_nms_top_n},
                     infer_shape=False)
    _declare((out, [-1, 4]))
    return out


def locality_aware_nms(bboxes, scores, score_threshold, nms_top_k,
                       keep_top_k, nms_threshold=0.3, normalized=True,
                       nms_eta=1.0, background_label=-1, name=None):
    helper = LayerHelper('locality_aware_nms', name=name)
    out = _mk(helper, bboxes.dtype)
    helper.append_op('locality_aware_nms',
                     inputs={'BBoxes': bboxes, 'Scores': scores},
                     outputs={'Out': out},
                     attrs={'score_threshold': score_threshold,
                            'nms_top_k': nms_top_k,
                            'keep_top_k': keep_top_k,
                            'nms_threshold': nms_threshold,
                            'normalized': normalized},
                     infer_shape=False)
    _declare((out, [-1, 6]))
    return out


def roi_perspective_transform(input, rois, transformed_height,
                              transformed_width, spatial_scale=1.0):
    helper = LayerHelper('roi_perspective_transform')
    out = _mk(helper, input.dtype)
    helper.append_op('roi_perspective_transform',
                     inputs={'X': input, 'ROIs': rois},
                     outputs={'Out': out},
                     attrs={'transformed_height': transformed_height,
                            'transformed_width': transformed_width,
                            'spatial_scale': spatial_scale},
                     infer_shape=False)
    _declare((out, [-1, input.shape[1], transformed_height,
                    transformed_width]))
    return out


def box_decoder_and_assign(prior_box, prior_box_var, target_box,
                           box_score, box_clip, name=None):
    helper = LayerHelper('box_decoder_and_assign', name=name)
    decode = _mk(helper, target_box.dtype)
    assign = _mk(helper, target_box.dtype)
    helper.append_op('box_decoder_and_assign',
                     inputs={'PriorBox': prior_box,
                             'TargetBox': target_box,
                             'BoxScore': box_score},
                     outputs={'DecodeBox': decode,
                              'OutputAssignBox': assign},
                     attrs={'box_clip': box_clip}, infer_shape=False)
    return decode, assign
