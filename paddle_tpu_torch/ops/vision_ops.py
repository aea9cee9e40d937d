"""3-D convolution and pooling, trilinear resizing, pixel rearrangement,
affine channels and grids, unfold, crops, spatial pyramid pooling, the
deformable convolutions, the RoI pools and the detection anchors: the
op types of the JAX package's ops/vision_ops.py.

Reference: operators/{conv_cudnn,conv_transpose,pool,interpolate,
pixel_shuffle,shuffle_channel,space_to_depth,affine_channel,affine_grid,
unfold,crop_tensor,crop,spp,deformable_conv,deformable_conv_v1,roi_pool,
psroi_pool,prroi_pool}_op.* and detection/{anchor_generator,
density_prior_box,box_clip,bipartite_match}_op.*.
conv3d and conv3d_transpose go to cuDNN in full f32, as conv2d does
(nn_ops._Conv).  Every gradient that adds into shared elements adds
without float atomics: the deformable convolutions and the RoI pools
gather the feature map's rows (channels last) through the embedding
gather (K6), whose gradient is the sorted scatter-add (K6b);
trilinear_interp is three products with per-axis weight matrices.  The
JAX RoI pools compare every pixel of the map with every bin; here each
bin reads only its window of rows, so memory grows with the bins and
their windows, not with the map.
"""

import math

import numpy as np
import torch
import torch.nn.functional as F

from ..fluid import core
from .detection_ops import _const, _div, _maximum, _roi_batch, _tap_mean
from .kernels import common
from .kernels.embedding import (embedding_lookup, gather_kernel, gather_plain,
                                scatter_add)
from .nn_ops import _Conv, _axis_matrix, _conv_transpose, _same_pads
from .registry import register, register_host


def _triple(v):
    v = list(v) if isinstance(v, (list, tuple)) else [v]
    if len(v) == 1:
        v = v * 3
    return [int(i) for i in v]


def _host_input(op, ins, slot):
    """An op's input the JAX lowering reads as host values
    (np.asarray): under its executor's jit the input is traced and the
    run raises, and so does the port's, naming the op; the values come
    from attributes."""
    if ins.get(slot):
        raise ValueError(
            '%s: %s given as an input variable is read on the host, which '
            'neither the JAX package\'s executor (a traced value) nor the '
            'port (a device sync inside a captured step) does; give it as '
            'the attribute instead' % (op, slot))


@register('conv3d')
def conv3d(ctx, ins, attrs):
    """NCDHW Input, OIDHW Filter; strides, dilations, groups, 3
    symmetric paddings or padding_algorithm SAME (XLA's split: the odd
    element after)."""
    x = ins['Input'][0]
    w = ins['Filter'][0]
    strides = _triple(attrs.get('strides', [1, 1, 1]))
    dilations = _triple(attrs.get('dilations', [1, 1, 1]))
    groups = int(attrs.get('groups', 1) or 1)
    if attrs.get('padding_algorithm') == 'SAME':
        pads = [_same_pads(x.shape[2 + i], w.shape[2 + i], strides[i],
                           dilations[i]) for i in range(3)]
    else:
        pads = [(p, p) for p in _triple(attrs.get('paddings', [0, 0, 0]))]
    if all(a == b for a, b in pads):
        padding = [a for a, _ in pads]
    else:
        flat = []
        for a, b in reversed(pads):
            flat += [a, b]
        x, padding = F.pad(x, flat), [0, 0, 0]
    return {'Output': [_Conv.apply(x, w.to(x.dtype), strides, dilations,
                                   groups, False, padding)]}


@register('conv3d_transpose')
def conv3d_transpose(ctx, ins, attrs):
    """The JAX lowering (vision_ops.py:57-72): the lhs-dilated
    convolution by the flipped, in/out-swapped kernel, which ignores
    `groups` and `dilations` (one group: Output has Filter's dim 1
    channels) and output_size."""
    return {'Output': [_conv_transpose(
        ins['Input'][0], ins['Filter'][0],
        _triple(attrs.get('strides', [1, 1, 1])), [1, 1, 1], 1,
        [(p, p) for p in _triple(attrs.get('paddings', [0, 0, 0]))])]}


@register('pool3d')
def pool3d(ctx, ins, attrs):
    """Max or average over ksize windows at strides (default 2), padded
    symmetrically; global_pooling a reduction over D, H and W.  The
    average divides by the whole window, padding included, whatever
    `exclusive` says, and `adaptive` is ignored, as in the JAX lowering
    (vision_ops.py:76-95).  The max's gradient goes to each window's
    first maximum, as XLA's select_and_scatter sends it."""
    x = ins['X'][0]
    ptype = attrs.get('pooling_type', 'max')
    if attrs.get('global_pooling', False):
        red = torch.amax if ptype == 'max' else torch.mean
        return {'Out': [red(x, dim=(2, 3, 4), keepdim=True)]}
    ksize = _triple(attrs.get('ksize', [2, 2, 2]))
    strides = _triple(attrs.get('strides', [2, 2, 2]))
    p = _triple(attrs.get('paddings', [0, 0, 0]))
    inside = all(2 * pi <= k for pi, k in zip(p, ksize))
    if not inside:
        flat = []
        for pi in reversed(p):
            flat += [pi, pi]
        x = F.pad(x, flat, value=-float('inf') if ptype == 'max' else 0.0)
        p = [0, 0, 0]
    if ptype == 'max':
        return {'Out': [F.max_pool3d(x, ksize, strides, p)]}
    s = F.avg_pool3d(x, ksize, strides, p, divisor_override=1)
    return {'Out': [s / float(np.prod(ksize))]}


def _linspace32(start, stop, n):
    """jnp.linspace(start, stop, n) in float32: start (1 - t) + stop t at
    t = i / (n - 1), the last value stop."""
    f32 = np.float32
    if n == 1:
        return np.full(1, f32(start))
    t = np.arange(n, dtype=f32) / f32(n - 1)
    out = f32(start) * (f32(1.0) - t) + f32(stop) * t
    out[-1] = f32(stop)
    return out


def _trilinear_weights(m, n, align):
    """[m, n] float32: column j holds the linear-interpolation weights
    of output sample j over the m inputs, as
    jax.scipy.ndimage.map_coordinates(order=1, mode='nearest') takes
    them at the JAX lowering's coordinates (vision_ops.py:107-113):
    aligned corners (0 to m - 1 evenly, n > 1) or half-pixel centres
    clamped at 0; the lower neighbour floor(c) takes 1 - (c - floor(c)),
    the upper one the rest, both indices clamped into [0, m - 1]."""
    f32 = np.float32
    if align and n > 1:
        c = _linspace32(0.0, m - 1.0, n)
    else:
        ratio = f32(m / n)
        c = np.maximum((np.arange(n, dtype=f32) + f32(0.5)) * ratio -
                       f32(0.5), f32(0.0))
    lo = np.floor(c)
    up = (c - lo).astype(f32)
    w = np.zeros((m, n), f32)
    cols = np.arange(n)
    np.add.at(w, (np.clip(lo.astype(np.int64), 0, m - 1), cols),
              f32(1.0) - up)
    np.add.at(w, (np.clip(lo.astype(np.int64) + 1, 0, m - 1), cols), up)
    return w


@register('trilinear_interp')
def trilinear_interp(ctx, ins, attrs):
    """NCDHW X resized to (out_d, out_h, out_w) (or by `scale` where one
    is unset) by trilinear interpolation that honours align_corners
    (default True), as the JAX lowering samples it.  Each axis is a
    product with its weight matrix (``_trilinear_weights``), so the
    gradient is three products (no scatter)."""
    x = ins['X'][0]
    outs = [attrs.get('out_d'), attrs.get('out_h'), attrs.get('out_w')]
    if any(v is None or v <= 0 for v in outs):
        outs = [int(s * attrs.get('scale')) for s in x.shape[2:]]
    align = attrs.get('align_corners', True)
    out = x
    for axis, n in zip((2, 3, 4), outs):
        wm = _axis_matrix(_trilinear_weights(x.shape[axis], int(n), align),
                          x)
        out = torch.matmul(out.transpose(axis, 4), wm).transpose(axis, 4)
    return {'Out': [out]}


@register('pixel_shuffle')
def pixel_shuffle(ctx, ins, attrs):
    """[N, C r^2, H, W] -> [N, C, H r, W r], the JAX lowering's
    reshape and transpose (channel c r^2 + i r + j to row i, column j)."""
    x = ins['X'][0]
    r = int(attrs.get('upscale_factor', 1))
    n, c, h, w = x.shape
    oc = c // (r * r)
    out = x.reshape(n, oc, r, r, h, w).permute(0, 1, 4, 2, 5, 3)
    return {'Out': [out.reshape(n, oc, h * r, w * r)]}


@register('shuffle_channel')
def shuffle_channel(ctx, ins, attrs):
    """ShuffleNet's channel shuffle over `group` groups."""
    x = ins['X'][0]
    g = int(attrs.get('group', 1))
    n, c, h, w = x.shape
    return {'Out': [x.reshape(n, g, c // g, h, w).transpose(1, 2).reshape(
        n, c, h, w)]}


@register('space_to_depth')
def space_to_depth(ctx, ins, attrs):
    """[N, C, H, W] -> [N, C b^2, H / b, W / b] in the JAX lowering's
    channel order (transpose(0, 3, 5, 1, 2, 4): the block offset
    major, the input channel minor), not F.pixel_unshuffle's."""
    x = ins['X'][0]
    b = int(attrs.get('blocksize', 1))
    n, c, h, w = x.shape
    out = x.reshape(n, c, h // b, b, w // b, b).permute(0, 3, 5, 1, 2, 4)
    return {'Out': [out.reshape(n, c * b * b, h // b, w // b)]}


@register('affine_channel')
def affine_channel(ctx, ins, attrs):
    """x * Scale + Bias a channel (axis 1, or the last with NHWC)."""
    x = ins['X'][0]
    shape = (1, -1, 1, 1) if attrs.get('data_layout', 'NCHW') == 'NCHW' \
        else (1, 1, 1, -1)
    return {'Out': [x * ins['Scale'][0].reshape(shape) +
                    ins['Bias'][0].reshape(shape)]}


@register('affine_grid')
def affine_grid(ctx, ins, attrs):
    """Theta [N, 2, 3] -> the sampling grid [N, H, W, 2] of
    output_shape [N, C, H, W]: (x, y, 1) on an evenly spaced [-1, 1]
    grid times Theta's rows."""
    _host_input('affine_grid', ins, 'OutputShape')
    theta = ins['Theta'][0]
    _, _, h, w = [int(v) for v in attrs['output_shape']]
    gy, gx = np.meshgrid(_linspace32(-1.0, 1.0, h), _linspace32(-1.0, 1.0, w),
                         indexing='ij')
    base = _axis_matrix(np.stack([gx, gy, np.ones_like(gx)], -1), theta)
    grid = torch.einsum('hwk,njk->nhwj', base, theta)
    return {'Output': [grid.to(theta.dtype)]}


@register('unfold')
def unfold(ctx, ins, attrs):
    """im2col: [N, C, H, W] -> [N, C kh kw, L], channel major then the
    tap, as the JAX lowering stacks them; 2 or 4 paddings (top, left,
    bottom, right)."""
    x = ins['X'][0]
    k = [int(v) for v in attrs['kernel_sizes']]
    s = [int(v) for v in attrs.get('strides', [1, 1])]
    d = [int(v) for v in attrs.get('dilations', [1, 1])]
    p = [int(v) for v in attrs.get('paddings', [0, 0, 0, 0])]
    if len(p) == 2:
        p = p * 2
    if p[0] == p[2] and p[1] == p[3]:
        return {'Y': [F.unfold(x, k, d, [p[0], p[1]], s)]}
    return {'Y': [F.unfold(F.pad(x, (p[1], p[3], p[0], p[2])), k, d, 0, s)]}


@register('crop_tensor')
def crop_tensor(ctx, ins, attrs):
    """X[offsets : offsets + shape] (a shape entry of -1 or 0 keeps the
    dim); offsets and shape from the attributes (see _host_input)."""
    _host_input('crop_tensor', ins, 'Offsets')
    _host_input('crop_tensor', ins, 'Shape')
    x = ins['X'][0]
    offsets = [int(v) for v in attrs.get('offsets') or [0] * x.ndim]
    shape = [x.shape[i] if s in (-1, 0) else int(s)
             for i, s in enumerate(attrs['shape'])]
    return {'Out': [x[tuple(slice(o, o + s) for o, s in zip(offsets,
                                                           shape))]]}


@register('crop')
def crop(ctx, ins, attrs):
    return crop_tensor(ctx, ins, attrs)


@register('spp')
def spp(ctx, ins, attrs):
    """Spatial pyramid pooling: at level l, 2^l x 2^l bins of
    ceil-sized windows over the input padded (by -inf for max, zeros
    for the average, which divides by the whole window), flattened and
    concatenated over the levels."""
    x = ins['X'][0]
    levels = int(attrs.get('pyramid_height', 1))
    ptype = attrs.get('pooling_type', 'max')
    n, c, h, w = x.shape
    outs = []
    for lv in range(levels):
        bins = 2 ** lv
        kh, kw = -(-h // bins), -(-w // bins)
        ph, pw = (kh * bins - h + 1) // 2, (kw * bins - w + 1) // 2
        pad = (pw, kw * bins - w - pw, ph, kh * bins - h - ph)
        if ptype == 'max':
            o = F.max_pool2d(F.pad(x, pad, value=-float('inf')), (kh, kw),
                             (kh, kw))
        else:
            o = F.avg_pool2d(F.pad(x, pad), (kh, kw), (kh, kw),
                             divisor_override=1) / float(kh * kw)
        outs.append(o.reshape(n, -1))
    return {'Out': [torch.cat(outs, 1)]}


def _deformable_conv(ctx, ins, attrs, modulated):
    """Input [N, C, H, W], Offset [N, 2 dg K, OH, OW] ((dy, dx) a tap of
    each deformable group), Filter [O, C / groups, kh, kw], and for the
    modulated form Mask [N, dg K, OH, OW]: each tap sampled bilinearly at
    its learned offset (zero outside the map), scaled by its mask, then
    one contraction with the filter (JAX vision_ops.py:508-558).  The
    four neighbours of every tap are rows of Input in channels-last
    order, gathered by the embedding gather (K6 on the card), so the
    Input gradient adds the taps' cotangents by the sorted scatter-add
    (K6b), without float atomics."""
    x = ins['Input'][0]
    offset = ins['Offset'][0]
    w = ins['Filter'][0]
    groups = int(attrs.get('groups', 1) or 1)
    dg = int(attrs.get('deformable_groups', 1) or 1)
    sh, sw = attrs.get('strides', [1, 1])
    ph, pw = attrs.get('paddings', [0, 0])
    dh, dw = attrs.get('dilations', [1, 1])
    n, c, h, wd = x.shape
    o_c, _, kh, kw = w.shape
    k = kh * kw
    oh = (h + 2 * ph - (dh * (kh - 1) + 1)) // sh + 1
    ow = (wd + 2 * pw - (dw * (kw - 1) + 1)) // sw + 1
    cg = c // dg
    dev = x.device
    off = offset.reshape(n, dg, k, 2, oh, ow)
    taps = torch.arange(k, device=dev)
    ty = (taps // kw * dh).to(x.dtype).reshape(1, 1, k, 1, 1)
    tx = (taps % kw * dw).to(x.dtype).reshape(1, 1, k, 1, 1)
    by = (torch.arange(oh, device=dev) * sh - ph).to(x.dtype).reshape(
        1, 1, 1, oh, 1)
    bx = (torch.arange(ow, device=dev) * sw - pw).to(x.dtype).reshape(
        1, 1, 1, 1, ow)
    py = by + ty + off[:, :, :, 0]          # [N, dg, K, OH, OW]
    px = bx + tx + off[:, :, :, 1]
    y0, x0 = torch.floor(py), torch.floor(px)
    wy, wx = py - y0, px - x0
    # the row of (n, y, x, g) in Input as [N * H * W * dg, cg]
    rows = x.permute(0, 2, 3, 1).reshape(n * h * wd * dg, cg)
    base = torch.arange(n, device=dev).reshape(n, 1, 1, 1, 1) * (h * wd)
    grp = torch.arange(dg, device=dev).reshape(1, dg, 1, 1, 1)
    ids, weights = [], []
    for dy, fy in ((0, 1 - wy), (1, wy)):
        for dx, fx in ((0, 1 - wx), (1, wx)):
            yy, xx = y0 + dy, x0 + dx
            valid = ((yy >= 0) & (yy < h) & (xx >= 0) & (xx < wd)).to(
                x.dtype)
            yc = yy.clamp(0, h - 1).long()
            xc = xx.clamp(0, wd - 1).long()
            ids.append(((base + yc * wd + xc) * dg + grp))
            weights.append(fy * fx * valid)
    ids = torch.stack(ids)                   # [4, N, dg, K, OH, OW]
    vals = embedding_lookup(rows, ids)       # [4, N, dg, K, OH, OW, cg]
    cols = (vals * torch.stack(weights)[..., None]).sum(0)
    if modulated and ins.get('Mask'):
        cols = cols * ins['Mask'][0].reshape(n, dg, k, oh, ow)[..., None]
    # [N, OH OW, groups, C / groups, K] against [groups, O / groups,
    # C / groups, K]
    cols = cols.permute(0, 3, 4, 1, 5, 2).reshape(
        n, oh * ow, groups, c // groups, k)
    wg = w.reshape(groups, o_c // groups, c // groups, k)
    out = torch.einsum('npgck,gock->ngop', cols, wg.to(cols.dtype))
    return {'Output': [out.reshape(n, o_c, oh, ow)]}


@register('deformable_conv')
def deformable_conv(ctx, ins, attrs):
    return _deformable_conv(ctx, ins, attrs, modulated=True)


@register('deformable_conv_v1')
def deformable_conv_v1(ctx, ins, attrs):
    return _deformable_conv(ctx, ins, attrs, modulated=False)


# ----------------------------------------------------------------- RoI pools

def _gather_rows(rows, ids):
    if common.use_kernel(rows, ids):
        return gather_kernel(rows, ids)
    return gather_plain(rows, ids)


def _chunks(b, t, c):
    """Slices of b windows of t taps of c channels, each at most ~2^28
    gathered values."""
    step = max(1, (1 << 28) // max(1, t * c))
    return [slice(i, min(b, i + step)) for i in range(0, b, step)]


class _WindowMax(torch.autograd.Function):
    """out [B, C]: the largest of rows [V, C] at ids [B, T] where valid
    [B, T] (-inf for a window with no valid tap), through the embedding
    gather in slices of windows; the gradient goes evenly to every valid
    tap equal to its window's largest (as jnp.max's does), added into
    the rows by the sorted scatter-add.  Nothing of the gathered windows
    is kept: the backward gathers them again."""

    @staticmethod
    def forward(ctx, rows, ids, valid):
        b, t = ids.shape
        c = rows.shape[1]
        out = rows.new_empty((b, c))
        ninf = torch.full((), -math.inf, dtype=rows.dtype, device=rows.device)
        for sl in _chunks(b, t, c):
            vals = _gather_rows(rows, ids[sl].reshape(-1)).reshape(-1, t, c)
            out[sl] = torch.where(valid[sl, :, None], vals, ninf).amax(1)
        ctx.save_for_backward(rows, ids, valid, out)
        return out

    @staticmethod
    def backward(ctx, g):
        rows, ids, valid, out = ctx.saved_tensors
        b, t = ids.shape
        c = rows.shape[1]
        grad = None
        for sl in _chunks(b, t, c):
            vals = _gather_rows(rows, ids[sl].reshape(-1)).reshape(-1, t, c)
            hit = (vals == out[sl, None]) & valid[sl, :, None]
            cnt = hit.sum(1).clamp_min(1).to(g.dtype)
            part = hit.to(g.dtype) * (g[sl] / cnt)[:, None]
            add = scatter_add(rows.shape[0], ids[sl].reshape(-1),
                              part.reshape(-1, c))
            grad = add if grad is None else grad + add
        return grad, None, None


def _windows(lo, hi, size):
    """Integer windows [lo, hi) of pixels (lo, hi whole numbers as
    floats, [R, P]) cut to [0, size): (their first pixels [R, P] int64,
    lengths [R, P], and the longest, read on the host: the number of
    taps every window is gathered with)."""
    start = lo.clamp(0, size)
    length = (hi.clamp(0, size) - start).clamp_min(0).long()
    longest = int(length.max()) if length.numel() else 0
    return start.long(), length, longest


def _window_taps(bi, ys, ly, xs, lx, kh, kw, h, w, per_bin=None):
    """ids [R, PH, PW, kh kw] of the window pixels of every bin (rows of
    a channels-last map: per image, or per image and bin where per_bin
    = (ph, pw)) and their validity [R, PH, PW, kh kw]."""
    dev = ys.device
    ty = ys[:, :, None] + torch.arange(kh, device=dev)         # [R, PH, kh]
    tx = xs[:, :, None] + torch.arange(kw, device=dev)         # [R, PW, kw]
    vy = torch.arange(kh, device=dev) < ly[:, :, None]
    vx = torch.arange(kw, device=dev) < lx[:, :, None]
    ty, tx = ty.clamp(0, h - 1), tx.clamp(0, w - 1)
    r, ph, pw = ys.shape[0], ys.shape[1], xs.shape[1]
    img = bi.reshape(r, 1, 1, 1, 1)
    if per_bin is not None:
        img = (img * ph + torch.arange(ph, device=dev).reshape(
            1, ph, 1, 1, 1)) * pw + torch.arange(pw, device=dev).reshape(
                1, 1, pw, 1, 1)
    ids = (img * h + ty[:, :, None, :, None]) * w + tx[:, None, :, None, :]
    valid = vy[:, :, None, :, None] & vx[:, None, :, None, :]
    shape = (r, ph, pw, kh * kw)
    return ids.expand(r, ph, pw, kh, kw).reshape(shape), \
        valid.expand(r, ph, pw, kh, kw).reshape(shape)


@register('roi_pool', no_grad_out_slots=('Argmax',))
def roi_pool(ctx, ins, attrs):
    """Fast R-CNN's max pool [R, C, PH, PW] of X [N, C, H, W] over ROIs
    [R, 4] (xyxy times spatial_scale, rounded; sides + 1, at least 1) of
    image RoisBatch [R]: bin (i, j) the largest pixel of rows
    [floor(y1 + i h), ceil(y1 + (i + 1) h)) and the same columns inside
    the map, 0 where that is empty; Argmax zeros, as the JAX lowering
    gives.  The longest window is read on the host (a device sync)."""
    x, rois = ins['X'][0], ins['ROIs'][0]
    ph = int(attrs.get('pooled_height', 1))
    pw = int(attrs.get('pooled_width', 1))
    n, c, h, w = x.shape
    r = rois.shape[0]
    if x.device.type == 'meta':
        out = torch.empty((r, c, ph, pw), dtype=x.dtype, device='meta')
        return {'Out': [out], 'Argmax': [torch.empty(
            out.shape, dtype=torch.int64, device='meta')]}
    bi = _roi_batch(ins, 'RoisBatch', rois)
    q = torch.round(rois.detach() * attrs.get('spatial_scale', 1.0))
    x1, y1, x2, y2 = (q[:, i, None] for i in range(4))
    bin_h = _div(_maximum(y2 - y1 + 1, 1.0), ph)
    bin_w = _div(_maximum(x2 - x1 + 1, 1.0), pw)
    fi = torch.arange(ph, dtype=x.dtype, device=x.device)
    fj = torch.arange(pw, dtype=x.dtype, device=x.device)
    ys, ly, kh = _windows(torch.floor(y1 + fi * bin_h),
                          torch.ceil(y1 + (fi + 1) * bin_h), h)
    xs, lx, kw = _windows(torch.floor(x1 + fj * bin_w),
                          torch.ceil(x1 + (fj + 1) * bin_w), w)
    if kh == 0 or kw == 0:
        out = torch.zeros((r, ph, pw, c), dtype=x.dtype, device=x.device)
    else:
        ids, valid = _window_taps(bi, ys, ly, xs, lx, kh, kw, h, w)
        rows = x.permute(0, 2, 3, 1).reshape(n * h * w, c)
        mx = _WindowMax.apply(rows, ids.reshape(r * ph * pw, -1),
                              valid.reshape(r * ph * pw, -1))
        out = torch.where(torch.isfinite(mx), mx, torch.zeros_like(mx))
        out = out.reshape(r, ph, pw, c)
    out = out.permute(0, 3, 1, 2)
    return {'Out': [out],
            'Argmax': [torch.zeros(out.shape, dtype=torch.int64,
                                   device=x.device)]}


@register('psroi_pool')
def psroi_pool(ctx, ins, attrs):
    """R-FCN's position-sensitive average pool [R, output_channels, PH,
    PW]: output channel (c, i, j) averages input channel (c PH + i) PW
    + j over the pixels of bin (i, j) of the roi (xyxy times
    spatial_scale; sides at least 0.1), those at or past its top-left
    edge and before its bottom-right one, inside the map (0 where
    none).  The rows gathered are [N PH PW H W, output_channels]; the
    longest window is read on the host."""
    x, rois = ins['X'][0], ins['ROIs'][0]
    ph = int(attrs.get('pooled_height', 1))
    pw = int(attrs.get('pooled_width', 1))
    oc = int(attrs.get('output_channels'))
    n, c, h, w = x.shape
    r = rois.shape[0]
    if x.device.type == 'meta':
        return {'Out': [torch.empty((r, oc, ph, pw), dtype=x.dtype,
                                    device='meta')]}
    bi = _roi_batch(ins, 'RoisBatch', rois)
    q = rois.detach() * attrs.get('spatial_scale', 1.0)
    x1, y1, x2, y2 = (q[:, i, None] for i in range(4))
    bh = _div(_maximum(y2 - y1, 0.1), ph)
    bw = _div(_maximum(x2 - x1, 0.1), pw)
    fi = torch.arange(ph, dtype=x.dtype, device=x.device)
    fj = torch.arange(pw, dtype=x.dtype, device=x.device)
    ys, ly, kh = _windows(torch.ceil(y1 + fi * bh),
                          torch.ceil(y1 + (fi + 1) * bh), h)
    xs, lx, kw = _windows(torch.ceil(x1 + fj * bw),
                          torch.ceil(x1 + (fj + 1) * bw), w)
    cnt = (ly[:, :, None] * lx[:, None, :]).clamp_min(1).to(x.dtype)
    if kh == 0 or kw == 0:
        out = torch.zeros((r, ph, pw, oc), dtype=x.dtype, device=x.device)
    else:
        ids, valid = _window_taps(bi, ys, ly, xs, lx, kh, kw, h, w,
                                  per_bin=(ph, pw))
        rows = x.reshape(n, oc, ph, pw, h, w).permute(0, 2, 3, 4, 5, 1)
        vals = embedding_lookup(rows.reshape(-1, oc), ids)
        wts = valid.to(x.dtype) / cnt[..., None]
        out = torch.matmul(wts.reshape(-1, 1, kh * kw),
                           vals.reshape(-1, kh * kw, oc)).reshape(
                               r, ph, pw, oc)
    return {'Out': [out.permute(0, 3, 1, 2)]}


@register('prroi_pool')
def prroi_pool(ctx, ins, attrs):
    """Precise RoI pooling as the JAX lowering approximates it: each bin
    the mean of a 4 x 4 grid of bilinear samples (zero outside the map)
    of X [N, C, H, W] over ROIs [R, 4] (xyxy times spatial_scale, bins
    at least 1e-6) of image BatchRoINums [R].  The taps go through the
    embedding gather."""
    x, rois = ins['X'][0], ins['ROIs'][0]
    bi = _roi_batch(ins, 'BatchRoINums', rois)
    scale = attrs.get('spatial_scale', 1.0)
    p_h = int(attrs.get('pooled_height', 1))
    p_w = int(attrs.get('pooled_width', 1))
    ns = 4
    n, c, h, w = x.shape
    r = rois * scale
    x1, y1, x2, y2 = (r[:, i, None] for i in range(4))
    bw = _maximum(_div(x2 - x1, p_w), 1e-6)
    bh = _maximum(_div(y2 - y1, p_h), 1e-6)
    ar = lambda k: torch.arange(k, dtype=x.dtype, device=x.device)  # noqa
    frac = _div(ar(ns) + 0.5, ns)
    py = y1 + (ar(p_h)[:, None] + frac).reshape(-1) * bh     # [R, PH ns]
    px = x1 + (ar(p_w)[:, None] + frac).reshape(-1) * bw     # [R, PW ns]
    shape = (rois.shape[0], p_h * ns, p_w * ns)
    py = py[:, :, None].expand(shape)
    px = px[:, None, :].expand(shape)
    y0, x0 = torch.floor(py), torch.floor(px)
    wy, wx = py - y0, px - x0
    base = bi.reshape(-1, 1, 1) * h
    ids, wts = [], []
    for dy, fy in ((0, 1 - wy), (1, wy)):
        for dx, fx in ((0, 1 - wx), (1, wx)):
            yy, xx = y0 + dy, x0 + dx
            valid = ((yy >= 0) & (yy < h) & (xx >= 0) & (xx < w)).to(x.dtype)
            ids.append((base + yy.clamp(0, h - 1).long()) * w +
                       xx.clamp(0, w - 1).long())
            wts.append(fy * fx * valid)
    # [R, PH ns, PW ns, 4] -> each bin's ns^2 samples of 4 taps
    def per_bin(t):
        t = torch.stack(t, -1).reshape(shape[0], p_h, ns, p_w, ns, 4)
        return t.permute(0, 1, 3, 2, 4, 5).reshape(shape[0], p_h, p_w,
                                                   ns * ns, 4)
    out = _tap_mean(x, per_bin(ids), per_bin(wts))
    return {'Out': [out.permute(0, 3, 1, 2)]}


# -------------------------------------------------------------- anchors etc.

@register('anchor_generator', no_grad_out_slots=('Anchors', 'Variances'))
def anchor_generator(ctx, ins, attrs):
    """RPN anchors [H, W, A, 4] of Input's map (A = ratios x sizes, the
    ratio major) centred at (i + offset) stride, and their variances,
    computed in float32 as the JAX lowering computes them."""
    feat = ins['Input'][0]
    h, w = feat.shape[2], feat.shape[3]
    f32 = np.float32
    stride = [float(s) for s in attrs['stride']]
    offset = f32(attrs.get('offset', 0.5))
    cx = (np.arange(w, dtype=f32) + offset) * f32(stride[0])
    cy = (np.arange(h, dtype=f32) + offset) * f32(stride[1])
    gx, gy = np.meshgrid(cx, cy, indexing='xy')
    boxes = []
    for ratio in attrs['aspect_ratios']:
        for size in attrs['anchor_sizes']:
            aw = float(size) * np.sqrt(1.0 / float(ratio))
            ah = float(size) * np.sqrt(float(ratio))
            hw, hh = f32(0.5 * aw), f32(0.5 * ah)
            boxes.append(np.stack([gx - hw, gy - hh, gx + hw, gy + hh], -1))
    out = np.stack(boxes, 2)
    var = np.broadcast_to(np.asarray(attrs.get('variances',
                                               [0.1, 0.1, 0.2, 0.2]), f32),
                          out.shape)
    return {'Anchors': [_const(out, feat).to(feat.dtype)],
            'Variances': [_const(var, feat).to(feat.dtype)]}


@register('density_prior_box', no_grad_out_slots=('Boxes', 'Variances'))
def density_prior_box(ctx, ins, attrs):
    """Density priors [H, W, A, 4] of Input's map over Image: for each
    fixed size (with its density d) and ratio, a d x d grid of boxes
    inside each cell, clipped to [0, 1], in float32 as the JAX lowering
    computes them."""
    feat, image = ins['Input'][0], ins['Image'][0]
    h, w = feat.shape[2], feat.shape[3]
    ih, iw = image.shape[2], image.shape[3]
    f32 = np.float32
    step_w = attrs.get('step_w', 0.0) or iw / w
    step_h = attrs.get('step_h', 0.0) or ih / h
    offset = f32(attrs.get('offset', 0.5))
    cells = []
    for size, density in zip(attrs['fixed_sizes'], attrs['densities']):
        size, density = float(size), int(density)
        for ratio in attrs['fixed_ratios']:
            bw = size * np.sqrt(float(ratio))
            bh = size / np.sqrt(float(ratio))
            step = size / density
            for di in range(density):
                for dj in range(density):
                    cells.append((-size / 2.0 + step / 2.0 + dj * step,
                                  -size / 2.0 + step / 2.0 + di * step,
                                  bw, bh))
    cx = (np.arange(w, dtype=f32) + offset) * f32(step_w)
    cy = (np.arange(h, dtype=f32) + offset) * f32(step_h)
    gx, gy = np.meshgrid(cx, cy, indexing='xy')
    outs = [np.stack([(gx + f32(sx) - f32(bw / 2.0)) / f32(iw),
                      (gy + f32(sy) - f32(bh / 2.0)) / f32(ih),
                      (gx + f32(sx) + f32(bw / 2.0)) / f32(iw),
                      (gy + f32(sy) + f32(bh / 2.0)) / f32(ih)], -1)
            for sx, sy, bw, bh in cells]
    out = np.clip(np.stack(outs, 2), f32(0.0), f32(1.0))
    var = np.broadcast_to(np.asarray(attrs.get('variances',
                                               [0.1, 0.1, 0.2, 0.2]), f32),
                          out.shape)
    return {'Boxes': [_const(out, feat).to(feat.dtype)],
            'Variances': [_const(var, feat).to(feat.dtype)]}


@register('box_clip')
def box_clip(ctx, ins, attrs):
    """Boxes [..., 4] clipped into the first image of ImInfo [N, 3] (h,
    w, scale): x into [0, w / scale - 1], y into [0, h / scale - 1]."""
    boxes, im_info = ins['Input'][0], ins['ImInfo'][0]
    h = im_info[0, 0] / im_info[0, 2] - 1.0
    w = im_info[0, 1] / im_info[0, 2] - 1.0
    out = [torch.minimum(_maximum(boxes[..., i], 0.0), hi)
           for i, hi in enumerate((w, h, w, h))]
    return {'Output': [torch.stack(out, -1)]}


@register_host('bipartite_match', runs=True)
def bipartite_match(ctx, op, ins):
    """A host op (the reference runs it on the CPU too): greedy
    bipartite matching of DistMat [rows, cols], the largest remaining
    distance first, then with match_type 'per_prediction' each unmatched
    column to its best row at dist_threshold or more; the JAX package's
    Python loops, so bitwise."""
    dist = np.array(core.to_numpy(ins['DistMat'][0]), copy=True)
    rows, cols = dist.shape
    match_idx = np.full((1, cols), -1, np.int32)
    match_dist = np.zeros((1, cols), np.float32)
    used_rows = set()
    while len(used_rows) < min(rows, cols):
        best = -1.0
        bi = bj = -1
        for i in range(rows):
            if i in used_rows:
                continue
            for j in range(cols):
                if match_idx[0, j] != -1:
                    continue
                if dist[i, j] > best:
                    best, bi, bj = dist[i, j], i, j
        if bi < 0 or best <= 0:
            break
        match_idx[0, bj] = bi
        match_dist[0, bj] = best
        used_rows.add(bi)
    if op.attrs.get('match_type', 'bipartite') == 'per_prediction':
        thresh = op.attrs.get('dist_threshold', 0.5)
        for j in range(cols):
            if match_idx[0, j] == -1:
                i = int(np.argmax(dist[:, j]))
                if dist[i, j] >= thresh:
                    match_idx[0, j] = i
                    match_dist[0, j] = dist[i, j]
    return {'ColToRowMatchIndices': [torch.as_tensor(match_idx,
                                                     device=ctx.device)],
            'ColToRowMatchDist': [torch.as_tensor(match_dist,
                                                  device=ctx.device)]}
