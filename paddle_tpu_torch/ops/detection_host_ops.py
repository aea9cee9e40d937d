"""Detection ops whose outputs are sized by the data or drawn at random:
host ops, as the reference runs them on the CPU
(paddle/fluid/operators/detection/{rpn_target_assign,
retinanet_target_assign,generate_proposal_labels,generate_mask_labels,
distribute_fpn_proposals,collect_fpn_proposals,locality_aware_nms,
roi_perspective_transform}_op.cc), and the device op
box_decoder_and_assign (the JAX package's ops/detection_host_ops.py).

Each host op runs between the device units as ``fn(ctx, op, ins) ->
outs`` (ops/host_ops.py): its inputs read to numpy, the JAX package's
numpy code (the same calls, RandomState(seed) permutations and unstable
argsorts included, so every output is bitwise the JAX package's), its
outputs back on the op's device.  rpn_target_assign matches the anchors
and gt boxes of the whole batch at once, as the JAX package does.
"""

import numpy as np
import torch

from ..fluid import core
from .kernels.embedding import embedding_lookup
from .registry import register, register_host


def _arr(ins, slot, i=0):
    return np.asarray(core.to_numpy(ins[slot][i]))


def _outs(ctx, op, values):
    """{slot: [device tensors]} of the op's output slots that it names
    (a value list per slot), as the JAX package sets only those."""
    out = {}
    for slot, vals in values.items():
        names = op.output(slot)
        if names:
            out[slot] = [torch.as_tensor(np.ascontiguousarray(v),
                                         device=ctx.device)
                         for v in vals[:len(names)]]
    return out


def _iou_matrix(a, b):
    if len(a) == 0 or len(b) == 0:
        return np.zeros((len(a), len(b)), np.float32)
    ax1, ay1, ax2, ay2 = a[:, 0, None], a[:, 1, None], a[:, 2, None], \
        a[:, 3, None]
    bx1, by1, bx2, by2 = b[None, :, 0], b[None, :, 1], b[None, :, 2], \
        b[None, :, 3]
    iw = np.maximum(np.minimum(ax2, bx2) - np.maximum(ax1, bx1), 0)
    ih = np.maximum(np.minimum(ay2, by2) - np.maximum(ay1, by1), 0)
    inter = iw * ih
    ua = (ax2 - ax1) * (ay2 - ay1) + (bx2 - bx1) * (by2 - by1) - inter
    return (inter / np.maximum(ua, 1e-10)).astype(np.float32)


@register_host('rpn_target_assign', runs=True)
def rpn_target_assign(ctx, op, ins):
    """The RPN's training anchors: foreground at IoU >= the positive
    overlap with some gt box (and each gt box's best anchor), background
    below the negative overlap, each permuted by RandomState(seed) and
    cut to rpn_batch_size_per_im (fg_fraction of it foreground).
    LocationIndex and ScoreIndex index the anchors flattened [-1, 4];
    TargetBBox is each foreground anchor's best gt box."""
    anchors = _arr(ins, 'Anchor').reshape(-1, 4)
    gts = _arr(ins, 'GtBoxes').reshape(-1, 4)
    attrs = op.attrs
    pos_thr = attrs.get('rpn_positive_overlap', 0.7)
    neg_thr = attrs.get('rpn_negative_overlap', 0.3)
    batch = attrs.get('rpn_batch_size_per_im', 256)
    fg_frac = attrs.get('rpn_fg_fraction', 0.5)
    iou = _iou_matrix(anchors, gts)
    best = iou.max(axis=1) if iou.size else np.zeros(len(anchors))
    arg = iou.argmax(axis=1) if iou.size else np.zeros(len(anchors), int)
    fg = np.where(best >= pos_thr)[0]
    if iou.size:
        fg = np.union1d(fg, iou.argmax(axis=0))
    bg = np.where(best < neg_thr)[0]
    rng = np.random.RandomState(attrs.get('seed', 0))
    n_fg = min(len(fg), int(batch * fg_frac))
    fg = rng.permutation(fg)[:n_fg]
    n_bg = min(len(bg), batch - n_fg)
    bg = rng.permutation(bg)[:n_bg]
    tgt_label = np.concatenate([np.ones(len(fg)),
                                np.zeros(len(bg))]).astype(np.int32)
    tgt_bbox = gts[arg[fg]] if len(fg) else np.zeros((0, 4), np.float32)
    return _outs(ctx, op, {
        'LocationIndex': [fg.astype(np.int32)],
        'ScoreIndex': [np.concatenate([fg, bg]).astype(np.int32)],
        'TargetLabel': [tgt_label.reshape(-1, 1)],
        'TargetBBox': [tgt_bbox.astype(np.float32)],
        'BBoxInsideWeight': [np.ones_like(tgt_bbox, np.float32)]})


# RetinaNet's assign is the same IoU match in the JAX package
register_host('retinanet_target_assign', runs=True)(rpn_target_assign)


@register_host('generate_proposal_labels', runs=True)
def generate_proposal_labels(ctx, op, ins):
    """The RoI head's training rois: the proposals and the gt boxes as
    candidates, foreground at IoU >= fg_thresh with their best gt box,
    background in [bg_thresh_lo, bg_thresh_hi), permuted by
    RandomState(seed) and cut to batch_size_per_im (fg_fraction of it
    foreground); labels the best gt box's class (0 for background),
    BboxTargets its coordinates, both weights ones."""
    rois = _arr(ins, 'RpnRois').reshape(-1, 4)
    gt_classes = _arr(ins, 'GtClasses').reshape(-1)
    gt_boxes = _arr(ins, 'GtBoxes').reshape(-1, 4)
    attrs = op.attrs
    batch = attrs.get('batch_size_per_im', 256)
    fg_frac = attrs.get('fg_fraction', 0.25)
    fg_thr = attrs.get('fg_thresh', 0.5)
    bg_hi = attrs.get('bg_thresh_hi', 0.5)
    bg_lo = attrs.get('bg_thresh_lo', 0.0)
    cand = np.concatenate([rois, gt_boxes], axis=0)
    iou = _iou_matrix(cand, gt_boxes)
    best = iou.max(axis=1) if iou.size else np.zeros(len(cand))
    arg = iou.argmax(axis=1) if iou.size else np.zeros(len(cand), int)
    rng = np.random.RandomState(attrs.get('seed', 0))
    fg = np.where(best >= fg_thr)[0]
    bg = np.where((best < bg_hi) & (best >= bg_lo))[0]
    n_fg = min(len(fg), int(batch * fg_frac))
    fg = rng.permutation(fg)[:n_fg]
    n_bg = min(len(bg), batch - n_fg)
    bg = rng.permutation(bg)[:n_bg]
    keep = np.concatenate([fg, bg]).astype(int)
    labels = np.concatenate([gt_classes[arg[fg]],
                             np.zeros(len(bg))]).astype(np.int32)
    tgt = gt_boxes[arg[keep]].astype(np.float32)
    return _outs(ctx, op, {
        'Rois': [cand[keep].astype(np.float32)],
        'LabelsInt32': [labels.reshape(-1, 1)],
        'BboxTargets': [tgt], 'BboxInsideWeights': [np.ones_like(tgt)],
        'BboxOutsideWeights': [np.ones_like(tgt)]})


@register_host('generate_mask_labels', runs=True)
def generate_mask_labels(ctx, op, ins):
    """Mask R-CNN's mask targets as the JAX package renders them: the
    rois, a mask flag 1 for each, and an all-ones resolution^2 mask."""
    rois = _arr(ins, 'Rois').reshape(-1, 4)
    m = op.attrs.get('resolution', 14)
    n = len(rois)
    return _outs(ctx, op, {
        'MaskRois': [rois.astype(np.float32)],
        'RoiHasMaskInt32': [np.ones((n, 1), np.int32)],
        'MaskInt32': [np.ones((n, m * m), np.int32)]})


@register_host('distribute_fpn_proposals', runs=True)
def distribute_fpn_proposals(ctx, op, ins):
    """FPN's level of each roi, floor(log2(sqrt(area) / refer_scale +
    1e-6)) + refer_level clipped to [min_level, max_level]: the rois of
    each level (MultiFpnRois, one output a level) and RestoreIndex, the
    position of each roi in their concatenation."""
    rois = _arr(ins, 'FpnRois').reshape(-1, 4)
    attrs = op.attrs
    min_level = attrs.get('min_level', 2)
    max_level = attrs.get('max_level', 5)
    w = rois[:, 2] - rois[:, 0]
    h = rois[:, 3] - rois[:, 1]
    scale = np.sqrt(np.maximum(w * h, 1e-6))
    lvl = np.floor(np.log2(scale / attrs.get('refer_scale', 224) + 1e-6)) + \
        attrs.get('refer_level', 4)
    lvl = np.clip(lvl, min_level, max_level).astype(int)
    order, levels = [], []
    for level in range(min_level, max_level + 1):
        idx = np.where(lvl == level)[0]
        order.append(idx)
        levels.append(rois[idx].astype(np.float32))
    restore = np.argsort(np.concatenate(order)) if order else \
        np.zeros(0, int)
    return _outs(ctx, op, {
        'MultiFpnRois': levels,
        'RestoreIndex': [restore.astype(np.int32).reshape(-1, 1)]})


@register_host('collect_fpn_proposals', runs=True)
def collect_fpn_proposals(ctx, op, ins):
    """The rois of every level together, the post_nms_topN best by score
    (np.argsort of the negated scores, unstable, as the JAX package's)."""
    rois = [np.asarray(core.to_numpy(v)).reshape(-1, 4)
            for v in ins.get('MultiLevelRois', [])]
    scores = [np.asarray(core.to_numpy(v)).reshape(-1)
              for v in ins.get('MultiLevelScores', [])]
    all_rois = np.concatenate(rois, axis=0) if rois else \
        np.zeros((0, 4), np.float32)
    all_scores = np.concatenate(scores, axis=0) if scores else \
        np.zeros((0,), np.float32)
    n = min(op.attrs.get('post_nms_topN', 100), len(all_rois))
    keep = np.argsort(-all_scores)[:n]
    return _outs(ctx, op, {'FpnRois': [all_rois[keep].astype(np.float32)]})


@register_host('locality_aware_nms', runs=True)
def locality_aware_nms(ctx, op, ins):
    """The JAX package's rendering: the keep_top_k best boxes by score
    (unstable argsort) as rows (0, score, x1, y1, x2, y2); no merging or
    suppression."""
    bboxes = _arr(ins, 'BBoxes')
    scores = _arr(ins, 'Scores')
    keep_k = op.attrs.get('keep_top_k', 100)
    b = bboxes.reshape(-1, bboxes.shape[-1])
    s = scores.reshape(-1)
    n = min(len(b), keep_k if keep_k > 0 else len(b))
    keep = np.argsort(-s)[:n]
    out = np.concatenate([np.zeros((n, 1)), s[keep, None], b[keep][:, :4]],
                         axis=1)
    return _outs(ctx, op, {'Out': [out.astype(np.float32)]})


@register_host('roi_perspective_transform', runs=True)
def roi_perspective_transform(ctx, op, ins):
    """Each quad roi's bounding box (times spatial_scale) of image 0 of X
    resampled to transformed_height x transformed_width by nearest rows
    and columns of an even grid (zeros where the box is empty), as the
    JAX package renders the perspective warp."""
    x = _arr(ins, 'X')
    rois = _arr(ins, 'ROIs')
    oh = op.attrs.get('transformed_height', 8)
    ow = op.attrs.get('transformed_width', 8)
    spatial_scale = op.attrs.get('spatial_scale', 1.0)
    n, c = len(rois), x.shape[1]
    out = np.zeros((n, c, oh, ow), np.float32)
    pts = rois.reshape(n, -1)
    for i in range(n):
        xs = pts[i, 0::2] * spatial_scale
        ys = pts[i, 1::2] * spatial_scale
        x1, x2 = int(max(xs.min(), 0)), int(min(xs.max() + 1, x.shape[3]))
        y1, y2 = int(max(ys.min(), 0)), int(min(ys.max() + 1, x.shape[2]))
        if x2 <= x1 or y2 <= y1:
            continue
        patch = x[0, :, y1:y2, x1:x2]
        yy = np.clip((np.linspace(0, patch.shape[1] - 1, oh)).astype(int),
                     0, patch.shape[1] - 1)
        xx = np.clip((np.linspace(0, patch.shape[2] - 1, ow)).astype(int),
                     0, patch.shape[2] - 1)
        out[i] = patch[:, yy][:, :, xx]
    return _outs(ctx, op, {'Out': [out]})


@register('box_decoder_and_assign')
def box_decoder_and_assign(ctx, ins, attrs):
    """Each class's deltas TargetBox [N, 4 C] decoded on PriorBox [N, 4]
    (no variance, no clip: the JAX lowering's), DecodeBox [N, 4 C], and
    OutputAssignBox [N, 4] the box of each row's best-scoring class
    (BoxScore [N, C], first on ties), a row the embedding gather takes,
    so its gradient goes back by the sorted scatter-add."""
    prior = ins['PriorBox'][0]
    deltas = ins['TargetBox'][0]
    scores = ins['BoxScore'][0]
    pw = prior[:, 2] - prior[:, 0]
    ph = prior[:, 3] - prior[:, 1]
    px = prior[:, 0] + 0.5 * pw
    py = prior[:, 1] + 0.5 * ph
    n, c4 = deltas.shape
    c = c4 // 4
    d = deltas.reshape(n, c, 4)
    cx = px[:, None] + d[..., 0] * pw[:, None]
    cy = py[:, None] + d[..., 1] * ph[:, None]
    w = pw[:, None] * torch.exp(d[..., 2])
    h = ph[:, None] * torch.exp(d[..., 3])
    boxes = torch.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2],
                        -1)                                   # [N, C, 4]
    best = torch.argmax(scores[:, :c], 1)
    ids = torch.arange(n, device=prior.device) * c + best
    return {'DecodeBox': [boxes.reshape(n, c4)],
            'OutputAssignBox': [embedding_lookup(boxes.reshape(n * c, 4),
                                                 ids)]}
