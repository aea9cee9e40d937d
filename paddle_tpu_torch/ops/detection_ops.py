"""Detection op lowerings: SSD's prior boxes, box coding and loss, YOLOv3's
box decoding and loss, the greedy NMS of multiclass_nms and
generate_proposals, roi_align and the focal loss (the JAX package's
ops/detection_ops.py).

Reference: paddle/fluid/operators/detection/.  Outputs are fixed-size
as in the JAX package: multiclass_nms gives [N, keep_top_k, 6] rows with
label -1 padding, generate_proposals [N, post_nms_topN, 4] with zero
rows.  The NMS is the JAX package's greedy loop (``_nms``), batched over
images and classes: each of its steps takes the first maximum of the
alive scores and suppresses at IoU >= the threshold, a few tensor ops
with no host read, so a forward-only program that holds it can be
captured in a CUDA graph.  Sorting is stable (ties keep the lower index
first, as lax.top_k and jnp.argsort do).

No gradient adds floats with atomics: the rows that several outputs
read (roi_align's bilinear taps, yolov3_loss's per-box cells, ssd_loss's
matched gt boxes) are gathered by the embedding gather (K6 on the card),
whose gradient is the sorted scatter-add (K6b); a pick of one class per
row is a one-hot product.
"""

import math

import numpy as np
import torch
import torch.nn.functional as F

from .kernels.embedding import embedding_lookup
from .registry import device_constant, register


def _full(x, v, dtype=None):
    """A 0-d tensor of v beside x (a fill, which a capture records)."""
    return torch.full((), v, dtype=dtype or x.dtype, device=x.device)


def _maximum(x, v):
    """jnp.maximum(x, v) for a scalar v: a tie splits the gradient in
    halves, as JAX's does (torch.clamp gives it all to x)."""
    return torch.maximum(x, _full(x, v))


def _div(x, v):
    """x / v for a Python number v, a true division on the card too
    (there PyTorch multiplies by the reciprocal of a host scalar, which
    may round otherwise than the CPU's division)."""
    return x / _full(x, float(v))


def _const(values, like):
    """A float32 constant from the host on like's device."""
    return device_constant(np.asarray(values, np.float32), like.device)


def _one_hot(labels, n, dtype):
    """[..., n] rows with 1 at each label in [0, n) (zeros elsewhere, as
    jax.nn.one_hot gives for a label out of range)."""
    classes = torch.arange(n, device=labels.device)
    return (labels.unsqueeze(-1) == classes).to(dtype)


@register('prior_box', no_grad_out_slots=('Boxes', 'Variances'))
def prior_box(ctx, ins, attrs):
    """SSD priors [H, W, num_priors, 4] of Input's map over Image, and
    their variances: the JAX lowering's numpy computation (float64
    rounded to float32), so bitwise.  Ratio 1 always comes first, each
    other ratio once (and its inverse with flip), then sqrt(min * max)
    for each max size."""
    feat, image = ins['Input'][0], ins['Image'][0]
    h, w = feat.shape[2], feat.shape[3]
    ih, iw = image.shape[2], image.shape[3]
    min_sizes = [float(s) for s in attrs['min_sizes']]
    max_sizes = [float(s) for s in attrs.get('max_sizes', [])]
    ars = [1.0]
    for a in attrs.get('aspect_ratios', []):
        if all(abs(a - x) > 1e-6 for x in ars):
            ars.append(float(a))
            if attrs.get('flip', False):
                ars.append(1.0 / float(a))
    variances = attrs.get('variances', [0.1, 0.1, 0.2, 0.2])
    step_w = attrs.get('step_w', 0.0) or iw / w
    step_h = attrs.get('step_h', 0.0) or ih / h
    offset = attrs.get('offset', 0.5)
    boxes = []
    for ms in min_sizes:
        for ar in ars:
            boxes.append((ms * np.sqrt(ar) / 2.0, ms / np.sqrt(ar) / 2.0))
        for big in max_sizes:
            s = np.sqrt(ms * big)
            boxes.append((s / 2.0, s / 2.0))
    nb = len(boxes)
    gx, gy = np.meshgrid((np.arange(w) + offset) * step_w,
                         (np.arange(h) + offset) * step_h)
    out = np.zeros((h, w, nb, 4), np.float32)
    for i, (bw, bh) in enumerate(boxes):
        out[:, :, i, 0] = (gx - bw) / iw
        out[:, :, i, 1] = (gy - bh) / ih
        out[:, :, i, 2] = (gx + bw) / iw
        out[:, :, i, 3] = (gy + bh) / ih
    if attrs.get('clip', False):
        out = np.clip(out, 0.0, 1.0)
    var = np.tile(np.asarray(variances, np.float32), (h, w, nb, 1))
    return {'Boxes': [_const(out, feat)], 'Variances': [_const(var, feat)]}


def _center_size(b):
    """(w, h, cx, cy) of xyxy boxes [..., 4]."""
    bw = b[..., 2] - b[..., 0]
    bh = b[..., 3] - b[..., 1]
    return bw, bh, b[..., 0] + 0.5 * bw, b[..., 1] + 0.5 * bh


@register('box_coder')
def box_coder(ctx, ins, attrs):
    """Encode TargetBox [N, 4] against PriorBox [M, 4] (row for row,
    broadcast) or decode deltas [N, M, 4], with PriorBoxVar [M, 4]
    (ones without it; the `variance` attribute is not read, as in the
    JAX lowering)."""
    prior = ins['PriorBox'][0]
    target = ins['TargetBox'][0]
    pvar = ins['PriorBoxVar'][0] if ins.get('PriorBoxVar') else \
        torch.ones_like(prior)
    pw, ph, pcx, pcy = _center_size(prior)
    if attrs.get('code_type', 'encode_center_size') == 'encode_center_size':
        tw, th, tcx, tcy = _center_size(target)
        return {'OutputBox': [torch.stack([
            (tcx - pcx) / pw / pvar[:, 0], (tcy - pcy) / ph / pvar[:, 1],
            torch.log(tw / pw) / pvar[:, 2],
            torch.log(th / ph) / pvar[:, 3]], -1)]}
    t = target
    cx = t[..., 0] * pvar[:, 0] * pw + pcx
    cy = t[..., 1] * pvar[:, 1] * ph + pcy
    bw = torch.exp(t[..., 2] * pvar[:, 2]) * pw
    bh = torch.exp(t[..., 3] * pvar[:, 3]) * ph
    return {'OutputBox': [torch.stack([cx - bw / 2, cy - bh / 2,
                                       cx + bw / 2, cy + bh / 2], -1)]}


@register('iou_similarity')
def iou_similarity(ctx, ins, attrs):
    """[N, M] IoU of X [N, 4] and Y [M, 4] (1e-10 added to the union)."""
    x, y = ins['X'][0], ins['Y'][0]
    area_x = (x[:, 2] - x[:, 0]) * (x[:, 3] - x[:, 1])
    area_y = (y[:, 2] - y[:, 0]) * (y[:, 3] - y[:, 1])
    lt = torch.maximum(x[:, None, :2], y[None, :, :2])
    rb = torch.minimum(x[:, None, 2:], y[None, :, 2:])
    wh = _maximum(rb - lt, 0.0)
    inter = wh[..., 0] * wh[..., 1]
    return {'Out': [inter / (area_x[:, None] + area_y[None, :] - inter +
                             1e-10)]}


@register('yolo_box', no_grad_out_slots=('Boxes', 'Scores'))
def yolo_box(ctx, ins, attrs):
    """YOLOv3's boxes [N, A H W, 4] in image pixels and class scores
    [N, A H W, classes], both zero where the objectness is at most
    conf_thresh."""
    x = ins['X'][0]
    img_size = ins['ImgSize'][0]
    anchors = attrs['anchors']
    cls = attrs['class_num']
    n, _, h, w = x.shape
    na = len(anchors) // 2
    x = x.reshape(n, na, 5 + cls, h, w)
    gx = torch.arange(w, dtype=x.dtype, device=x.device)
    gy = torch.arange(h, dtype=x.dtype, device=x.device)
    bx = _div(torch.sigmoid(x[:, :, 0]) + gx, w)
    by = _div(torch.sigmoid(x[:, :, 1]) + gy[:, None], h)
    aw = _const(anchors[0::2], x).to(x.dtype)
    ah = _const(anchors[1::2], x).to(x.dtype)
    size = attrs.get('downsample_ratio', 32) * h
    bw = _div(torch.exp(x[:, :, 2]) * aw[None, :, None, None], size)
    bh = _div(torch.exp(x[:, :, 3]) * ah[None, :, None, None], size)
    conf = torch.sigmoid(x[:, :, 4])
    probs = torch.sigmoid(x[:, :, 5:]) * conf[:, :, None]
    keep = (conf > attrs.get('conf_thresh', 0.01)).to(x.dtype)
    imh = img_size[:, 0].to(torch.float32)[:, None]
    imw = img_size[:, 1].to(torch.float32)[:, None]
    boxes = torch.stack([(bx - bw / 2).reshape(n, -1) * imw,
                         (by - bh / 2).reshape(n, -1) * imh,
                         (bx + bw / 2).reshape(n, -1) * imw,
                         (by + bh / 2).reshape(n, -1) * imh], -1)
    boxes = boxes * keep.reshape(n, -1)[..., None]
    scores = (probs * keep[:, :, None]).permute(0, 1, 3, 4, 2)
    return {'Boxes': [boxes], 'Scores': [scores.reshape(n, -1, cls)]}


_PAIRS = 1 << 24    # box pairs a slice of _suppressions


def _suppressions(boxes, thr, offset):
    """[B, K, K] bool: row i holds the boxes that a pick of box i kills,
    IoU >= thr, each IoU computed as the JAX loop's iou_with(i) computes
    it (areas with `offset` added to the sides, 1e-10 added to the
    union), in slices of about _PAIRS pairs."""
    b, k = boxes.shape[:2]
    area = (boxes[..., 2] - boxes[..., 0] + offset) * \
        (boxes[..., 3] - boxes[..., 1] + offset)
    out = torch.empty((b, k, k), dtype=torch.bool, device=boxes.device)
    imgs = max(1, _PAIRS // max(1, k * k))
    rows = k if imgs > 1 else max(1, _PAIRS // max(1, k))
    for s in range(0, b, imgs):
        bx, ar = boxes[s:s + imgs], area[s:s + imgs]
        for r in range(0, k, rows):
            bi, ai = bx[:, r:r + rows], ar[:, r:r + rows]
            wh = torch.minimum(bx[:, None, :, 2:], bi[:, :, None, 2:]) - \
                torch.maximum(bx[:, None, :, :2], bi[:, :, None, :2])
            if offset:
                wh = wh + offset
            wh = wh.clamp_min(0.0)
            inter = wh[..., 0] * wh[..., 1]
            out[s:s + imgs, r:r + rows] = inter / (
                ar[:, None, :] + ai[:, :, None] - inter + 1e-10) >= thr
    return out


def _nms(boxes, scores, thr, keep_k, offset=0.0):
    """The JAX package's greedy NMS (_nms_single) over a batch: boxes
    [B, K, 4] and scores [B, K] (-inf where a box may not be picked) ->
    (idx [B, keep_k] int64, -1 past the last pick; valid [B, keep_k]).
    Each of keep_k steps picks the first maximum of the alive scores and
    kills every alive box whose IoU with it is at least thr (the IoUs
    of every pair computed once, _suppressions); a zero-area box has IoU
    0 with itself, so it stays alive and is picked again."""
    b = scores.shape[0]
    sup = _suppressions(boxes, thr, offset)
    alive = torch.ones_like(scores, dtype=torch.bool)
    ninf = _full(scores, -math.inf)
    none = torch.full((), -1, dtype=torch.int64, device=scores.device)
    picks, valids = [], []
    for _ in range(keep_k):
        best, i = torch.where(alive, scores, ninf).max(1, keepdim=True)
        valid = best > -math.inf                                  # [B, 1]
        row = sup.gather(1, i[..., None].expand(b, 1, sup.shape[2]))[:, 0]
        alive = alive & ~(row & valid)
        picks.append(torch.where(valid[:, 0], i[:, 0], none))
        valids.append(valid[:, 0])
    if not picks:
        return (torch.empty((b, 0), dtype=torch.int64, device=scores.device),
                torch.empty((b, 0), dtype=torch.bool, device=scores.device))
    return torch.stack(picks, 1), torch.stack(valids, 1)


def _top(scores, k):
    """(the k largest of each row, their indices), ties lower index
    first (lax.top_k's order)."""
    vals, idx = torch.sort(scores, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _take_rows(x, idx):
    """x [B, K, D] rows at idx [B, k] -> [B, k, D] (no gradient: the NMS
    outputs carry none)."""
    return x.gather(1, idx[..., None].expand(*idx.shape, x.shape[-1]))


@register('multiclass_nms', no_grad_out_slots=('Out',))
def multiclass_nms(ctx, ins, attrs):
    """[N, keep_top_k, 6] rows (label, score, x1, y1, x2, y2) of BBoxes
    [N, M, 4] by Scores [N, C, M]: for every class (background_label and
    nms_eta are not read, as in the JAX lowering) the nms_top_k best
    scores above score_threshold, greedy NMS at nms_threshold, then the
    picks of all classes ordered by score (stable), label -1 and zeros
    past them."""
    boxes, scores = ins['BBoxes'][0], ins['Scores'][0]
    n, c, m = scores.shape
    k = min(attrs.get('nms_top_k', 128), m)
    s = torch.where(scores > attrs.get('score_threshold', 0.05), scores,
                    _full(scores, -math.inf))
    top_s, top_i = _top(s, k)                              # [N, C, k]
    bb = _take_rows(boxes, top_i.reshape(n, c * k)).reshape(n * c, k, 4)
    top_s = top_s.reshape(n * c, k)
    idx, valid = _nms(bb, top_s, attrs.get('nms_threshold', 0.45), k)
    safe = idx.clamp_min(0)
    label = torch.arange(c, dtype=scores.dtype,
                         device=scores.device).repeat(n)[:, None]
    rows = torch.cat([
        torch.where(valid, label, _full(scores, -1.0))[..., None],
        torch.where(valid, top_s.gather(1, safe), _full(scores, 0.0))[
            ..., None],
        _take_rows(bb, safe) * valid[..., None].to(bb.dtype)], -1)
    rows = rows.reshape(n, c * k, 6)
    key = torch.where(rows[..., 0] >= 0, rows[..., 1],
                      _full(scores, -math.inf))
    order = torch.argsort(-key, dim=1, stable=True)
    keep = order[:, :attrs.get('keep_top_k', 100)]
    return {'Out': [_take_rows(rows, keep)]}


def _bilinear_rows(x, bi, ys, xs):
    """Bilinear taps of the JAX roi_align at sample points ys, xs
    ([R, ...], feature-map coordinates) of image bi [R] of x [N, C, H,
    W]: (ids [R, ..., 4] of x's channels-last rows, weights [R, ..., 4]).
    The lower neighbour is floor clipped into the map, the upper one a
    row or column further, clipped; the weights come from the clipped
    lower neighbour (so they leave [0, 1] outside the map, as the JAX
    lowering's do)."""
    n, c, h, w = x.shape
    y0 = torch.floor(ys).clamp(0, h - 1)
    x0 = torch.floor(xs).clamp(0, w - 1)
    y1 = (y0 + 1).clamp(0, h - 1)
    x1 = (x0 + 1).clamp(0, w - 1)
    ly, lx = ys - y0, xs - x0
    base = bi.reshape((-1,) + (1,) * (ys.dim() - 1)) * h
    ids = [(base + yy.long()) * w + xx.long()
           for yy, xx in ((y0, x0), (y1, x0), (y0, x1), (y1, x1))]
    wts = [(1 - ly) * (1 - lx), ly * (1 - lx), (1 - ly) * lx, ly * lx]
    return torch.stack(ids, -1), torch.stack(wts, -1)


def _rows_of(x):
    """x [N, C, H, W] as its channels-last rows [N H W, C]."""
    n, c, h, w = x.shape
    return x.permute(0, 2, 3, 1).reshape(n * h * w, c)


def _tap_mean(x, ids, wts):
    """The mean over S samples of 4 weighted bilinear taps each: ids,
    wts [..., S, 4] -> [..., C].  The rows come through the embedding
    gather; the weighted sum over the 4 S taps is one batched product
    (cuBLAS on the card: no atomics, the same sums every call)."""
    vals = embedding_lookup(_rows_of(x), ids)                # [..., S, 4, C]
    lead, t = ids.shape[:-2], ids.shape[-2] * 4
    w = _div(wts.to(vals.dtype), ids.shape[-2]).reshape(-1, 1, t)
    out = torch.matmul(w, vals.reshape(-1, t, vals.shape[-1]))
    return out.reshape(lead + (vals.shape[-1],))


def _roi_batch(ins, slot, rois):
    if ins.get(slot):
        return ins[slot][0].reshape(-1).long()
    return torch.zeros((rois.shape[0],), dtype=torch.int64,
                       device=rois.device)


@register('roi_align')
def roi_align(ctx, ins, attrs):
    """[R, C, PH, PW]: each bin the mean of sampling_ratio^2 bilinear
    samples (2 where the ratio is <= 0) of X [N, C, H, W] inside ROIs
    [R, 4] (xyxy times spatial_scale, sides at least 1), image RoisBatch
    [R] (0 without it).  The taps are rows of X channels-last through
    the embedding gather, so X's gradient adds by the sorted
    scatter-add."""
    x, rois = ins['X'][0], ins['ROIs'][0]
    bi = _roi_batch(ins, 'RoisBatch', rois)
    ph, pw = attrs.get('pooled_height', 7), attrs.get('pooled_width', 7)
    scale = attrs.get('spatial_scale', 1.0)
    s = attrs.get('sampling_ratio', 2)
    s = 2 if s <= 0 else s
    r = rois * scale
    x1, y1, x2, y2 = (r[:, i].reshape(-1, 1, 1, 1, 1) for i in range(4))
    bin_w = _div(_maximum(x2 - x1, 1.0), pw)
    bin_h = _div(_maximum(y2 - y1, 1.0), ph)
    ar = lambda k: torch.arange(k, dtype=x.dtype, device=x.device)  # noqa
    iy = (ar(ph).reshape(1, ph, 1, 1, 1) * bin_h + y1 +
          _div((ar(s).reshape(1, 1, 1, s, 1) + 0.5) * bin_h, s))
    ix = (ar(pw).reshape(1, 1, pw, 1, 1) * bin_w + x1 +
          _div((ar(s).reshape(1, 1, 1, 1, s) + 0.5) * bin_w, s))
    shape = (rois.shape[0], ph, pw, s, s)
    ids, wts = _bilinear_rows(x, bi, iy.expand(shape), ix.expand(shape))
    out = _tap_mean(x, ids.reshape(shape[:3] + (s * s, 4)),
                    wts.reshape(shape[:3] + (s * s, 4)))  # [R, PH, PW, C]
    return {'Out': [out.permute(0, 3, 1, 2)]}


@register('generate_proposals', no_grad_out_slots=('RpnRois',
                                                   'RpnRoiProbs'))
def generate_proposals(ctx, ins, attrs):
    """RPN proposals, dense: the anchors' deltas decoded (sides with +1,
    the exponent's argument clipped to +-10), clipped to the image, boxes
    narrower or lower than min_size * im_info[2] dropped, the
    pre_nms_topN best scores, greedy NMS (offset 1) to post_nms_topN
    rows [N, post_nms_topN, 4] and their scores [N, post_nms_topN, 1],
    zero past the last pick."""
    scores = ins['Scores'][0]
    deltas = ins['BboxDeltas'][0]
    im_info = ins['ImInfo'][0]
    anchors = ins['Anchors'][0].reshape(-1, 4)
    var = ins['Variances'][0].reshape(-1, 4) if ins.get('Variances') else \
        torch.ones_like(anchors)
    n = scores.shape[0]
    sc = scores.permute(0, 2, 3, 1).reshape(n, -1)
    dl = deltas.permute(0, 2, 3, 1).reshape(n, -1, 4)
    k = sc.shape[1]
    pre_n = min(int(attrs.get('pre_nms_topN', 6000)), k)
    post_n = min(int(attrs.get('post_nms_topN', 1000)), pre_n)
    aw = anchors[:, 2] - anchors[:, 0] + 1.0
    ah = anchors[:, 3] - anchors[:, 1] + 1.0
    ax = anchors[:, 0] + 0.5 * aw
    ay = anchors[:, 1] + 0.5 * ah
    cx = ax + dl[..., 0] * var[:, 0] * aw
    cy = ay + dl[..., 1] * var[:, 1] * ah
    bw = aw * torch.exp((dl[..., 2] * var[:, 2]).clamp(-10.0, 10.0))
    bh = ah * torch.exp((dl[..., 3] * var[:, 3]).clamp(-10.0, 10.0))
    boxes = torch.stack([cx - bw / 2, cy - bh / 2, cx + bw / 2,
                         cy + bh / 2], -1)                   # [N, K, 4]
    hi = torch.stack([im_info[:, 1] - 1, im_info[:, 0] - 1,
                      im_info[:, 1] - 1, im_info[:, 0] - 1], -1)[:, None]
    boxes = torch.minimum(boxes.clamp_min(0.0), hi)
    ms = (attrs.get('min_size', 0.1) * im_info[:, 2])[:, None]
    wide = boxes[..., 2] - boxes[..., 0] + 1.0
    tall = boxes[..., 3] - boxes[..., 1] + 1.0
    sc = torch.where((wide >= ms) & (tall >= ms), sc,
                     _full(sc, -math.inf))
    top_sc, idx = _top(sc, pre_n)
    top_boxes = _take_rows(boxes, idx)
    keep, valid = _nms(top_boxes, top_sc, attrs.get('nms_thresh', 0.5),
                       post_n, offset=1.0)
    safe = keep.clamp_min(0)
    rois = _take_rows(top_boxes, safe) * valid[..., None].to(boxes.dtype)
    probs = top_sc.gather(1, safe) * valid.to(top_sc.dtype)
    return {'RpnRois': [rois], 'RpnRoiProbs': [probs[..., None]]}


@register('sigmoid_focal_loss')
def sigmoid_focal_loss(ctx, ins, attrs):
    """RetinaNet's focal loss [N, C] of logits X against Label [N, 1] in
    [0, C] (0 the background: class c is label c + 1), over max(FgNum,
    1)."""
    x = ins['X'][0]
    label = ins['Label'][0].reshape(-1)
    fg = _maximum(ins['FgNum'][0].reshape(()).to(x.dtype), 1.0)
    gamma = attrs.get('gamma', 2.0)
    alpha = attrs.get('alpha', 0.25)
    tgt = _one_hot(label - 1, x.shape[1], x.dtype)
    p = torch.sigmoid(x)
    ce = -(tgt * F.logsigmoid(x) + (1 - tgt) * F.logsigmoid(-x))
    wt = tgt * alpha * torch.pow(1 - p, gamma) + \
        (1 - tgt) * (1 - alpha) * torch.pow(p, gamma)
    return {'Out': [wt * ce / fg]}


def _bce(logit, t):
    return -(t * F.logsigmoid(logit) + (1 - t) * F.logsigmoid(-logit))


@register('yolov3_loss', no_grad_out_slots=('ObjectnessMask',
                                            'GTMatchMask'))
def yolov3_loss(ctx, ins, attrs):
    """YOLOv3's loss [N] (the JAX package's dense form): each gt box
    [N, B, 4] (cx, cy, w, h in [0, 1], zero-padded) matched to its best
    anchor by width-height IoU, its cell's x, y, w, h and class logits
    scored where that anchor is one of anchor_mask's, objectness
    positive at the matched cells and negative where no gt overlaps the
    predicted box above ignore_thresh.  The matched cells' rows of X
    ([N A H W, 5 + classes], several boxes may share one) come through
    the embedding gather, so their gradient adds by the sorted
    scatter-add; the positive mask is an exact scatter-max."""
    x = ins['X'][0]
    gtbox = ins['GTBox'][0].to(torch.float32)
    gtlabel = ins['GTLabel'][0].long()
    anchors = np.asarray(attrs['anchors'], np.float32).reshape(-1, 2)
    mask_idx = [int(v) for v in attrs.get('anchor_mask',
                                          list(range(len(anchors))))]
    cls = attrs['class_num']
    ignore = attrs.get('ignore_thresh', 0.7)
    n, _, h, w = x.shape
    a = len(mask_idx)
    size = attrs.get('downsample_ratio', 32) * h
    p = x.reshape(n, a, 5 + cls, h, w)
    px, py, pw, ph, pobj = (p[:, :, i] for i in range(5))
    valid = (gtbox[:, :, 2] > 1e-8).to(torch.float32)
    gw = gtbox[:, :, 2] * size
    gh = gtbox[:, :, 3] * size
    aw, ah = _const(anchors[:, 0], x), _const(anchors[:, 1], x)
    inter = torch.minimum(gw[..., None], aw) * torch.minimum(gh[..., None],
                                                             ah)
    union = gw[..., None] * gh[..., None] + aw * ah - inter
    best = torch.argmax(inter / _maximum(union, 1e-10), -1)      # [N, B]
    match = torch.full_like(best, -1)
    for k, am in enumerate(mask_idx):
        match = torch.where(best == am, torch.full_like(best, k), match)
    mf = ((match >= 0) & (valid > 0)).to(torch.float32)
    gi = (gtbox[:, :, 0] * w).to(torch.int32).clamp(0, w - 1).long()
    gj = (gtbox[:, :, 1] * h).to(torch.int32).clamp(0, h - 1).long()
    tx = gtbox[:, :, 0] * w - gi.to(torch.float32)
    ty = gtbox[:, :, 1] * h - gj.to(torch.float32)
    bsafe = best.clamp(0, len(anchors) - 1)
    tw = torch.log(_maximum(gw / _maximum(aw[bsafe], 1e-8), 1e-9))
    th = torch.log(_maximum(gh / _maximum(ah[bsafe], 1e-8), 1e-9))
    scale = 2.0 - gtbox[:, :, 2] * gtbox[:, :, 3]
    # the matched cell's row of each gt box
    rows = p.permute(0, 1, 3, 4, 2).reshape(n * a * h * w, 5 + cls)
    cell = ((torch.arange(n, device=x.device)[:, None] * a +
             match.clamp_min(0)) * h + gj) * w + gi            # [N, B]
    sel = embedding_lookup(rows, cell)                    # [N, B, 5 + cls]
    loss_xy = (_bce(sel[..., 0], tx) + _bce(sel[..., 1], ty)) * scale * mf
    loss_wh = (torch.square(sel[..., 2] - tw) +
               torch.square(sel[..., 3] - th)) * 0.5 * scale * mf
    tgt_cls = _one_hot(gtlabel, cls, torch.float32)
    loss_cls = _bce(sel[..., 5:], tgt_cls).sum(-1) * mf
    ar = lambda k: torch.arange(k, dtype=x.dtype, device=x.device)  # noqa
    grid_x = _div(ar(w) + torch.sigmoid(px), w)
    grid_y = _div(ar(h)[:, None] + torch.sigmoid(py), h)
    am_w = aw[mask_idx].reshape(1, a, 1, 1)
    am_h = ah[mask_idx].reshape(1, a, 1, 1)
    bw = _div(torch.exp(pw) * am_w, size)
    bh = _div(torch.exp(ph) * am_h, size)
    g = gtbox[:, None, None, None]                          # [N,1,1,1,B,4]
    cx1, cy1, w1, h1 = (t[..., None] for t in (grid_x, grid_y, bw, bh))
    cx2, cy2, w2, h2 = g[..., 0], g[..., 1], g[..., 2], g[..., 3]
    left = torch.maximum(cx1 - w1 / 2, cx2 - w2 / 2)
    right = torch.minimum(cx1 + w1 / 2, cx2 + w2 / 2)
    top = torch.maximum(cy1 - h1 / 2, cy2 - h2 / 2)
    bottom = torch.minimum(cy1 + h1 / 2, cy2 + h2 / 2)
    i_ = _maximum(right - left, 0.0) * _maximum(bottom - top, 0.0)
    ious = i_ / _maximum(w1 * h1 + w2 * h2 - i_, 1e-10)
    best_iou = torch.amax(ious * valid[:, None, None, None, :], -1)
    pos = torch.zeros(n * a * h * w, dtype=torch.float32, device=x.device)
    pos = pos.scatter_reduce(0, cell.reshape(-1), mf.reshape(-1), 'amax')
    pos = pos.reshape(n, a, h, w)
    neg = (1 - pos) * (best_iou < ignore).to(torch.float32)
    loss_obj = (_bce(pobj, 1.0) * pos + _bce(pobj, 0.0) * neg).sum((1, 2, 3))
    loss = (loss_xy + loss_wh + loss_cls).sum(1) + loss_obj
    return {'Loss': [loss], 'ObjectnessMask': [pos - neg],
            'GTMatchMask': [match.to(torch.int32)]}


def _smooth_l1(x):
    ax = torch.abs(x)
    return torch.where(ax < 1.0, 0.5 * x * x, ax - 0.5)


@register('ssd_loss')
def ssd_loss(ctx, ins, attrs):
    """SSD's loss [N, 1], dense (the JAX package's form): each prior
    matched to its best-IoU valid gt box (first on ties), positive at
    IoU >= overlap_threshold; smooth-L1 of Location against the matched
    box encoded on the prior over `variance` at positives, and softmax
    cross entropy against the matched label (background_label at
    negatives, weighted 1 / neg_pos_ratio; NaN for a label past the
    classes), over max(positives, 1).  The
    matched gt rows (priors share gt boxes) come through the embedding
    gather, so GtBox's gradient adds by the sorted scatter-add."""
    loc = ins['Location'][0]
    conf = ins['Confidence'][0]
    gt = ins['GtBox'][0]
    labels = ins['GtLabel'][0]
    prior = ins['PriorBox'][0]
    variance = _const(attrs.get('variance', [0.1, 0.1, 0.2, 0.2]), loc).to(
        loc.dtype)
    overlap = attrs.get('overlap_threshold', 0.5)
    neg_ratio = attrs.get('neg_pos_ratio', 3.0)
    bg = attrs.get('background_label', 0)
    n, g = gt.shape[0], gt.shape[1]
    valid = ((gt[..., 2] - gt[..., 0]) * (gt[..., 3] - gt[..., 1])) > 1e-8
    gx1, gy1, gx2, gy2 = (gt[..., i, None] for i in range(4))
    px1, py1, px2, py2 = (prior[None, None, :, i] for i in range(4))
    iw = _maximum(torch.minimum(gx2, px2) - torch.maximum(gx1, px1), 0.0)
    ih = _maximum(torch.minimum(gy2, py2) - torch.maximum(gy1, py1), 0.0)
    inter = iw * ih
    ua = (gx2 - gx1) * (gy2 - gy1) + (px2 - px1) * (py2 - py1) - inter
    iou = inter / _maximum(ua, 1e-10) * valid[..., None]      # [N, G, P]
    best_iou, best_gt = iou.max(1)                              # [N, P]
    pos = (best_iou >= overlap).to(loc.dtype)
    ids = torch.arange(n, device=gt.device)[:, None] * g + best_gt
    matched = embedding_lookup(gt.reshape(n * g, 4), ids)      # [N, P, 4]
    pw, ph, pcx, pcy = _center_size(prior)
    mw = _maximum(matched[..., 2] - matched[..., 0], 1e-6)
    mh = _maximum(matched[..., 3] - matched[..., 1], 1e-6)
    mcx = matched[..., 0] + 0.5 * mw
    mcy = matched[..., 1] + 0.5 * mh
    target = torch.stack([(mcx - pcx) / pw, (mcy - pcy) / ph,
                          torch.log(mw / pw), torch.log(mh / ph)], -1)
    target = target / variance
    loc_l = _smooth_l1(loc - target).sum(-1) * pos
    lab = labels.reshape(n, g).long().gather(1, best_gt)
    lab = torch.where(best_iou >= overlap, lab, torch.full_like(lab, bg))
    logp = torch.log_softmax(conf, -1)
    ce = -(logp * _one_hot(lab, conf.shape[-1], logp.dtype)).sum(-1)
    # a label past the classes reads NaN, as take_along_axis fills it
    ce = torch.where((lab >= 0) & (lab < conf.shape[-1]), ce,
                     _full(ce, math.nan))
    conf_l = ce * pos + _div(ce * (1.0 - pos), neg_ratio)
    n_pos = _maximum(pos.sum(1), 1.0)
    return {'Loss': [((loc_l.sum(1) + conf_l.sum(1)) / n_pos)[:, None]]}
