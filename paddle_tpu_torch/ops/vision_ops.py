"""3-D convolution and pooling, trilinear resizing, pixel rearrangement,
affine channels and grids, unfold, crops, spatial pyramid pooling and
the deformable convolutions: the dense-vision op types of the JAX
package's ops/vision_ops.py (its ROI and anchor ops come with the
detection group, ROADMAP Queue 1 item 11b-C).

Reference: operators/{conv_cudnn,conv_transpose,pool,interpolate,
pixel_shuffle,shuffle_channel,space_to_depth,affine_channel,affine_grid,
unfold,crop_tensor,crop,spp,deformable_conv,deformable_conv_v1}_op.*.
conv3d and conv3d_transpose go to cuDNN in full f32, as conv2d does
(nn_ops._Conv).  Every gradient that adds into shared elements adds
without float atomics: the deformable convolutions gather their
bilinear taps through the embedding gather (K6), whose gradient is the
sorted scatter-add (K6b); trilinear_interp is three products with
per-axis weight matrices.
"""

import numpy as np
import torch
import torch.nn.functional as F

from .kernels.embedding import embedding_lookup
from .nn_ops import _Conv, _axis_matrix, _conv_transpose, _same_pads
from .registry import register


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
