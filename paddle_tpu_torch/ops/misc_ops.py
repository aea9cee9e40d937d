"""Ops that size themselves from their input's runtime length: the
Transformer's sinusoidal position encoding and the additive causal
bias (the JAX package's ops/misc_ops.py).  One Program then serves
every length bucket of a padded batch.  Beside them, two of the JAX
module's control-flow helpers (is_empty and reorder_lod_tensor_by_rank),
eye, tensor_array_to_tensor, rank, soft_relu,
gaussian_random_batch_size_like, add_position_encoding,
continuous_value_model, hash, scatter_nd, similarity_focus, the host
op unique and the detection helpers polygon_box_transform,
target_assign and deformable_roi_pooling (decayed_adagrad is with the
other updates in ops/optimizer_ops.py).

Reference: operators/add_position_encoding_op.cc computed the encoding
per LoD batch on the host.
"""

import numpy as np
import torch

from ..fluid import core
from . import loss_ops, tensor_ops
from .detection_ops import _div, _full, _maximum, _roi_batch
from .kernels.embedding import embedding_lookup
from .kernels.flash_attention import mul32
from .registry import _M32, register, register_host


@register('position_encoding')
def position_encoding(ctx, ins, attrs):
    """[B, T, D] -> [1, T, D]: sin(pos / 10000^(2 floor(i/2) / D)) at
    even i, cos at odd i.  Computed in f32 in the JAX package's order
    of operations (its angles are pos / power(10000, 2 floor(i/2) / D)
    with each step rounded to f32), never in f64 and rounded."""
    x = ins['X'][0]
    t, d = x.shape[1], attrs['d_model']
    dev = x.device
    pos = torch.arange(t, dtype=torch.float32, device=dev)[:, None]
    i = torch.arange(d, dtype=torch.float32, device=dev)[None, :]
    angle = pos / torch.pow(10000.0, (2.0 * torch.floor(i / 2.0)) / d)
    even = (torch.arange(d, device=dev) % 2 == 0)[None, :]
    pe = torch.where(even, torch.sin(angle), torch.cos(angle))
    return {'Out': [pe[None].to(x.dtype)]}


@register('causal_mask_like')
def causal_mask_like(ctx, ins, attrs):
    """[B, T, D] -> the additive causal bias [1, 1, T, T]: -1e9 above
    the diagonal, 0 on and below it."""
    x = ins['X'][0]
    t = x.shape[1]
    m = torch.triu(torch.full((t, t), -1e9, dtype=torch.float32,
                              device=x.device), diagonal=1)
    return {'Out': [m[None, None].to(x.dtype)]}


@register('is_empty')
def is_empty(ctx, ins, attrs):
    """Whether X has no element (a 0-d bool)."""
    x = ins['X'][0]
    return {'Out': [torch.full((), x.numel() == 0, dtype=torch.bool,
                               device=x.device)]}


@register('reorder_lod_tensor_by_rank')
def reorder_lod_tensor_by_rank(ctx, ins, attrs):
    """X's rows in the order RankTable holds (its dense rendering: the
    permutation's indices)."""
    return {'Out': [torch.index_select(
        ins['X'][0], 0, ins['RankTable'][0].reshape(-1).long())]}


@register('eye')
def eye(ctx, ins, attrs):
    """A num_rows x num_columns identity (square where num_columns is
    -1, 0 or missing)."""
    rows = int(attrs['num_rows'])
    cols = int(attrs.get('num_columns', -1) or -1)
    cols = rows if cols == -1 else cols
    return {'Out': [torch.eye(rows, cols, dtype=core.convert_dtype(
        attrs.get('dtype', 'float32')), device=ctx.device)]}


@register('tensor_array_to_tensor', no_grad_out_slots=('OutIndex',))
def tensor_array_to_tensor(ctx, ins, attrs):
    """The array's first `length` items (its capacity where the layer
    recorded no static length), concatenated along `axis`, or as the
    stack they are with use_stack; OutIndex is a 1 per item, as in the
    JAX package (misc_ops.py:207)."""
    arr = ins['X'][0]
    length = int(attrs.get('length', 0)) or arr.shape[0]
    arr = arr[:length]
    out = arr if attrs.get('use_stack', False) else \
        torch.cat(list(arr.unbind(0)), dim=attrs.get('axis', 0))
    return {'Out': [out], 'OutIndex': [torch.ones(
        (length,), dtype=torch.int32, device=arr.device)]}


@register('rank')
def rank(ctx, ins, attrs):
    """Input's number of dims, a 0-d int32 (JAX misc_ops.py:27)."""
    return {'Out': [torch.full((), ins['Input'][0].ndim, dtype=torch.int32,
                               device=ctx.device)]}


@register('soft_relu')
def soft_relu(ctx, ins, attrs):
    """log(1 + exp(clip(X, -threshold, threshold))) (reference
    activation_op.h SoftReluFunctor; JAX misc_ops.py:52)."""
    t = attrs.get('threshold', 40.0)
    return {'Out': [torch.log1p(torch.exp(torch.clamp(ins['X'][0], -t, t)))]}


@register('gaussian_random_batch_size_like')
def gaussian_random_batch_size_like(ctx, ins, attrs):
    """mean + std * a standard normal of `shape` whose dim
    output_dim_idx is Input's dim input_dim_idx (JAX misc_ops.py:59),
    drawn on the device from the counter hash under the device step
    (tensor_ops.normal_draws), as uniform_random_batch_size_like draws:
    a CUDA graph replays each step's own draws."""
    ref = ins['Input'][0]
    shape = [int(s) for s in attrs['shape']]
    shape[attrs.get('output_dim_idx', 0)] = \
        ref.shape[attrs.get('input_dim_idx', 0)]
    z = tensor_ops.normal_draws(ctx, attrs, tuple(shape), ref.device, 0x6B5)
    return {'Out': [(attrs.get('mean', 0.0) + attrs.get('std', 1.0) * z).to(
        core.convert_dtype(attrs.get('dtype', 'float32')))]}


@register('add_position_encoding')
def add_position_encoding(ctx, ins, attrs):
    """alpha X + beta enc for X [B, T, D] (D even): enc[t] the sines of
    t / 10000^(i / (D / 2)) then their cosines, in f32 in the JAX op's
    order of operations."""
    x = ins['X'][0]
    t, d = x.shape[1], x.shape[2]
    half = d // 2
    dev = x.device
    pos = torch.arange(t, dtype=torch.float32, device=dev)[:, None]
    div = torch.pow(10000.0, torch.arange(half, dtype=torch.float32,
                                          device=dev) / half)
    enc = torch.cat([torch.sin(pos / div), torch.cos(pos / div)], 1)
    return {'Out': [attrs.get('alpha', 1.0) * x +
                    attrs.get('beta', 1.0) * enc[None, :, :d].to(x.dtype)]}


@register('continuous_value_model')
def continuous_value_model(ctx, ins, attrs):
    """The name the layer emits for cvm (ops/loss_ops.py); its CVM input
    is not read, as in the JAX op.  The result goes to both Y (cvm's
    slot) and Out, the slot the layer names (the JAX op writes Y alone,
    so its layer's program has no value for its output)."""
    y = loss_ops.cvm(ctx, ins, attrs)['Y'][0]
    return {'Y': [y], 'Out': [y]}



@register('hash')
def hash_op(ctx, ins, attrs):
    """num_hash hashes of each id into [0, mod_by): the JAX package's
    multiply-xorshift mix of the id's low 32 bits (not the reference's
    xxhash), bit for bit: the uint32 products wrap at 2^32, taken in
    int64 halves (mul32).  Int32 [..., num_hash] a last-axis id, the
    last axis then flattened."""
    x = ins['X'][0].to(torch.int64) & _M32
    outs = []
    for i in range(int(attrs.get('num_hash', 1))):
        h = mul32(x, 2654435761 + 40503 * (i + 1))
        h = h ^ (h >> 16)
        h = mul32(h, 2246822519)
        h = h ^ (h >> 13)
        outs.append((h % int(attrs.get('mod_by', 1))).to(torch.int32))
    out = torch.stack(outs, -1)
    if x.dim() > 1:
        out = out.reshape(tuple(x.shape[:-1]) + (-1,))
    return {'Out': [out]}


@register('scatter_nd')
def scatter_nd(ctx, ins, attrs):
    """Zeros of `shape` with Updates added at Index's coordinates, as
    scatter_nd_add adds them."""
    upd = ins['Updates'][0]
    zeros = torch.zeros([int(s) for s in attrs['shape']], dtype=upd.dtype,
                        device=upd.device)
    return {'Out': [loss_ops._scatter_nd_add(zeros, ins['Index'][0], upd)]}


@register('similarity_focus')
def similarity_focus(ctx, ins, attrs):
    """X [B, C, H, W], axis 1: for each of `indexes`, 1 on the rows and
    columns of that channel's map holding its row or column maximum, the
    masks of the indexes merged by max and broadcast over C."""
    x = ins['X'][0]
    if attrs.get('axis', 1) != 1:
        raise ValueError('similarity_focus: axis=1 (channel) only, as in '
                         'the JAX op')
    mask = torch.zeros_like(x)
    for idx in attrs['indexes']:
        ch = x[:, idx].detach()
        m = (ch == ch.amax(2, keepdim=True)) | \
            (ch == ch.amax(1, keepdim=True))
        mask = torch.maximum(mask, m.to(x.dtype)[:, None].expand_as(x))
    return {'Out': [mask]}


@register_host('unique', runs=True)
def unique(ctx, op, ins):
    """A host op (the output's length depends on the data): X's sorted
    distinct values and each element's int32 position among them."""
    x = core.to_numpy(ins['X'][0]).reshape(-1)
    uniq, index = np.unique(x, return_inverse=True)
    outs = {'Out': [torch.as_tensor(uniq, device=ctx.device)]}
    if op.output('Index'):
        outs['Index'] = [torch.as_tensor(index.astype(np.int32),
                                         device=ctx.device)]
    return outs


@register('polygon_box_transform')
def polygon_box_transform(ctx, ins, attrs):
    """EAST's quad offsets [B, G, H, W] to coordinates: 4 times the
    pixel's x (even channels) or y (odd channels) minus the input."""
    x = ins['Input'][0]
    b, g, h, w = x.shape
    xs = torch.arange(w, dtype=x.dtype, device=x.device).expand(b, g, h, w)
    ys = torch.arange(h, dtype=x.dtype, device=x.device)[:, None].expand(
        b, g, h, w)
    even = (torch.arange(g, device=x.device) % 2 == 0)[None, :, None, None]
    return {'Out': [4 * torch.where(even, xs, ys) - x]}


@register('target_assign')
def target_assign(ctx, ins, attrs):
    """Out [N, P, K]: row MatchIndices[n, p] of X [N, M, K] where that
    index is >= 0, mismatch_value elsewhere; OutWeight 1 at the matched
    rows, 0 elsewhere.  A floating X's rows come through the embedding
    gather (two priors may take one row), so its gradient adds by the
    sorted scatter-add."""
    x = ins['X'][0]
    match = ins['MatchIndices'][0]
    n, m, k = x.shape
    idx = match.long().clamp_min(0)
    if x.is_floating_point():
        ids = torch.arange(n, device=x.device)[:, None] * m + idx
        got = embedding_lookup(x.reshape(n * m, k), ids)
    else:
        got = x.gather(1, idx[..., None].expand(n, idx.shape[1], k))
    matched = (match >= 0)[..., None]
    out = torch.where(matched, got, _full(x, attrs.get('mismatch_value', 0)))
    return {'Out': [out], 'OutWeight': [matched.to(x.dtype)]}


@register('deformable_roi_pooling')
def deformable_roi_pooling(ctx, ins, attrs):
    """Deformable RoI pooling as the JAX lowering renders it: bin (i, j)
    of roi k (xyxy times spatial_scale, bins at least 1 / pooled) one
    bilinear sample of X at the bin's centre moved by Trans[k mod T, :,
    i, j] times trans_std and the bin size, clipped into the map;
    TopCount ones.  The taps (rows of X channels-last) and each roi's
    offsets (rows of Trans) come through the embedding gather, so both
    gradients add by the sorted scatter-add."""
    x, rois = ins['X'][0], ins['ROIs'][0].reshape(-1, 4)
    bi = _roi_batch(ins, 'RoisBatch', rois)
    offs = ins.get('Trans', [None])[0]
    scale = attrs.get('spatial_scale', 1.0)
    size = attrs.get('pooled_size')
    ph = attrs.get('pooled_height', size[0] if isinstance(
        size, (list, tuple)) else 7)
    pw = attrs.get('pooled_width', ph)
    std = attrs.get('trans_std', 0.1)
    n, c, h, w = x.shape
    r = rois.shape[0]
    q = rois * scale
    x1, y1, x2, y2 = (q[:, i, None, None] for i in range(4))
    bw = _div(_maximum(x2 - x1, 1.0), pw)
    bh = _div(_maximum(y2 - y1, 1.0), ph)
    ar = lambda k: torch.arange(k, dtype=x.dtype, device=x.device)  # noqa
    ys = y1 + (ar(ph)[:, None] + 0.5) * bh                    # [R, PH, 1]
    xs = x1 + (ar(pw)[None, :] + 0.5) * bw                    # [R, 1, PW]
    if offs is not None and offs.dim() >= 4:
        t = offs.shape[0]
        rows = offs[:, :2, :ph, :pw].reshape(t, 2 * ph * pw)
        own = embedding_lookup(rows, torch.arange(r, device=x.device) % t)
        own = own.reshape(r, 2, ph, pw)
        ys = ys + own[:, 0] * std * bh
        xs = xs + own[:, 1] * std * bw
    else:
        ys, xs = ys.expand(r, ph, pw), xs.expand(r, ph, pw)
    yy = torch.minimum(_maximum(ys, 0.0), _full(ys, h - 1))
    xx = torch.minimum(_maximum(xs, 0.0), _full(xs, w - 1))
    y0, x0 = torch.floor(yy).long(), torch.floor(xx).long()
    y1i, x1i = (y0 + 1).clamp_max(h - 1), (x0 + 1).clamp_max(w - 1)
    wy, wx = yy - y0.to(x.dtype), xx - x0.to(x.dtype)
    base = bi.reshape(-1, 1, 1) * h
    ids = torch.stack([(base + a) * w + b for a, b in
                       ((y0, x0), (y1i, x0), (y0, x1i), (y1i, x1i))], -1)
    vals = embedding_lookup(x.permute(0, 2, 3, 1).reshape(n * h * w, c), ids)
    out = (vals[..., 0, :] * ((1 - wy) * (1 - wx))[..., None] +
           vals[..., 1, :] * (wy * (1 - wx))[..., None] +
           vals[..., 2, :] * ((1 - wy) * wx)[..., None] +
           vals[..., 3, :] * (wy * wx)[..., None])           # [R, PH, PW, C]
    out = out.permute(0, 3, 1, 2)
    return {'Output': [out], 'TopCount': [torch.ones_like(out).detach()]}
