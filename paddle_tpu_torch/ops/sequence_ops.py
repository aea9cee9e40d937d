"""Sequence op lowerings on the padded+mask representation.

Reference: paddle/fluid/operators/sequence_ops/ over LoD offsets
(framework/lod_tensor.h:52).  As in the JAX package (ops/sequence_ops.py),
a variable-length batch is padded to [B, T, ...] with an explicit float
mask [B, T]; every sequence op is a masked dense op, and the lengths
live in the mask (mask.sum(-1)) instead of LoD offset vectors.
"""

import numpy as np
import torch
import torch.nn.functional as F

from ..fluid import core
from .math_ops import _product
from .registry import device_constant, register


def _mask_of(ins, x):
    if ins.get('Mask'):
        return ins['Mask'][0]
    return torch.ones(x.shape[:2], device=x.device,
                      dtype=x.dtype if x.is_floating_point()
                      else torch.float32)


def _positions(t, like):
    return torch.arange(t, device=like.device)


def _lengths(mask):
    return mask.sum(dim=1).to(torch.int32)


def _take_rows(x, idx):
    """x [B, T, ...] gathered along axis 1 at idx [B, T'] (the JAX
    package's take_along_axis with the index broadcast over the
    trailing dims)."""
    idx = idx.long()
    if x.ndim == 2:
        return torch.gather(x, 1, idx)
    shape = tuple(idx.shape) + tuple(x.shape[2:])
    full = idx.reshape(tuple(idx.shape) + (1,) * (x.ndim - 2)).expand(shape)
    return torch.gather(x, 1, full)


def _expand_mask(m, ndim):
    while m.ndim < ndim:
        m = m.unsqueeze(-1)
    return m


@register('sequence_mask', no_grad_out_slots=('Y',))
def sequence_mask(ctx, ins, attrs):
    lengths = ins['X'][0]
    maxlen = attrs.get('maxlen', -1)
    if maxlen is None or maxlen < 0:
        raise ValueError('sequence_mask needs a static maxlen')
    dtype = core.convert_dtype(attrs.get('out_dtype', 'float32'))
    idx = _positions(int(maxlen), lengths)
    return {'Y': [(idx[None, :] < lengths.reshape(-1, 1)).to(dtype)]}


@register('sequence_pool', no_grad_out_slots=('MaxIndex',))
def sequence_pool(ctx, ins, attrs):
    """X [B,T,D] (+Mask [B,T]) -> Out [B,D].  MAX splits its gradient
    evenly between equal maxima (torch.amax), as jnp.max does."""
    x = ins['X'][0]
    mask = _mask_of(ins, x)
    ptype = attrs.get('pooltype', 'AVERAGE').upper()
    m = mask[:, :, None].to(x.dtype)
    if ptype == 'SUM':
        out = torch.sum(x * m, dim=1)
    elif ptype == 'AVERAGE':
        out = torch.sum(x * m, dim=1) / torch.clamp(torch.sum(m, dim=1),
                                                    min=1.0)
    elif ptype == 'SQRT':
        out = torch.sum(x * m, dim=1) / torch.sqrt(
            torch.clamp(torch.sum(m, dim=1), min=1.0))
    elif ptype == 'MAX':
        neg = torch.finfo(x.dtype).min
        out = torch.amax(torch.where(m > 0, x, torch.full_like(x, neg)),
                         dim=1)
    elif ptype == 'LAST':
        idx = torch.clamp(_lengths(mask) - 1, min=0)
        out = _take_rows(x, idx[:, None])[:, 0]
    elif ptype == 'FIRST':
        out = x[:, 0]
    else:
        raise ValueError('sequence_pool: unknown pooltype %s' % ptype)
    return {'Out': [out], 'MaxIndex': [torch.zeros(
        out.shape[:1], dtype=torch.int32, device=x.device)]}


@register('sequence_softmax')
def sequence_softmax(ctx, ins, attrs):
    x = ins['X'][0]  # [B, T]
    mask = _mask_of(ins, x)
    logits = torch.where(mask > 0, x, torch.full_like(x, -1e9))
    return {'Out': [F.softmax(logits, dim=-1) * mask.to(x.dtype)]}


@register('sequence_expand')
def sequence_expand(ctx, ins, attrs):
    """Padded semantics: X [B,1,D] or [B,D] repeated along Y's T."""
    x = ins['X'][0]
    t = ins['Y'][0].shape[1]
    if x.ndim == 2:
        return {'Out': [x[:, None, :].expand(x.shape[0], t, x.shape[1])]}
    return {'Out': [torch.repeat_interleave(x, t // x.shape[1], dim=1)]}


@register('sequence_reshape')
def sequence_reshape(ctx, ins, attrs):
    x = ins['X'][0]
    return {'Out': [x.reshape(x.shape[0], -1, attrs['new_dim'])]}


@register('sequence_conv')
def sequence_conv(ctx, ins, attrs):
    """Context-window conv over time: X [B,T,D], Filter
    [ctx_len*D, out_dim] (reference operators/sequence_ops/
    sequence_conv_op.cc, im2col style): the window's rows shifted in
    with zeros past either end, concatenated, times the filter."""
    x = ins['X'][0]
    w = ins['Filter'][0]
    ctx_len = attrs.get('contextLength', 3)
    ctx_start = attrs.get('contextStart', -(ctx_len // 2))
    t = x.shape[1]
    pos = _positions(t, x)
    cols = []
    for i in range(ctx_len):
        off = ctx_start + i
        shifted = torch.roll(x, -off, dims=1)
        m = (pos >= -off) if off < 0 else (pos < t - off)
        cols.append(shifted * m[None, :, None].to(x.dtype))
    out = _product(torch.cat(cols, dim=2), w)
    if ins.get('Mask'):
        out = out * ins['Mask'][0][:, :, None].to(out.dtype)
    return {'Out': [out]}


@register('im2sequence')
def im2sequence(ctx, ins, attrs):
    """Sliding-window patches as a sequence (operators/im2sequence_op.h):
    X [N,C,H,W] -> [N, OH*OW, C*kh*kw], channel-major patches."""
    x = ins['X'][0]
    kh, kw = attrs.get('kernels', [1, 1])
    sh, sw = attrs.get('strides', [1, 1])
    pads = attrs.get('paddings', [0, 0, 0, 0])
    pu, pl, pd, pr = (pads + pads)[:4] if len(pads) == 2 else pads
    x = F.pad(x, (pl, pr, pu, pd))
    patches = F.unfold(x, (kh, kw), stride=(sh, sw))  # [N, C*kh*kw, L]
    return {'Out': [patches.transpose(1, 2)]}


# LoD offset juggling as masked gathers / compactions on [B, T, ...]
# (reference operators/sequence_ops/ sequence_pad_op.cc,
# sequence_unpad_op.cc, sequence_concat_op.cc, sequence_slice_op.cc,
# sequence_erase_op.cc, sequence_enumerate_op.cc, sequence_reverse_op.h,
# sequence_expand_as_op.cc, sequence_scatter_op.cc, lod_reset_op.cc)

def _stable_compact(x, keep):
    """Each row's kept elements moved to its front in order; with the
    count kept per row."""
    order = torch.argsort((~keep).to(torch.int8), dim=1, stable=True)
    return _take_rows(x, order), keep.sum(dim=1).to(torch.int32)


def _mask_to(n, t, like):
    return (_positions(t, like)[None, :] < n[:, None]).to(torch.float32)


@register('sequence_pad', no_grad_out_slots=('Length',))
def sequence_pad(ctx, ins, attrs):
    """Masked-out steps filled with PadValue; the lengths beside."""
    x = ins['X'][0]
    mask = _mask_of(ins, x)
    if ins.get('PadValue'):
        pad = ins['PadValue'][0].reshape(()).to(x.dtype)
    else:
        pad = torch.full((), attrs.get('pad_value', 0.0), dtype=x.dtype,
                         device=x.device)
    out = torch.where(_expand_mask(mask, x.ndim) > 0, x, pad)
    return {'Out': [out], 'Length': [mask.sum(dim=1).to(torch.int64)]}


@register('sequence_unpad')
def sequence_unpad(ctx, ins, attrs):
    """Padded -> padded and the mask of Length: the ragged side of the
    reference op is the explicit mask."""
    x = ins['X'][0]
    length = ins['Length'][0].reshape(-1)
    return {'Out': [x], 'Mask': [_mask_to(length, x.shape[1], x)]}


@register('sequence_concat')
def sequence_concat(ctx, ins, attrs):
    """Each row's valid prefixes of all X, concatenated at its front."""
    xs = ins['X']
    masks = ins.get('Mask')
    if not masks or len(masks) != len(xs):
        masks = [torch.ones(x.shape[:2], device=x.device) for x in xs]
    cat = torch.cat(xs, dim=1)
    keep = torch.cat([m > 0 for m in masks], dim=1)
    out, n = _stable_compact(cat, keep)
    return {'Out': [out], 'Mask': [_mask_to(n, out.shape[1], out)]}


@register('sequence_slice')
def sequence_slice(ctx, ins, attrs):
    """Each row's [offset, offset+length) window at its front."""
    x = ins['X'][0]
    offset = ins['Offset'][0].reshape(-1).to(torch.int32)
    length = ins['Length'][0].reshape(-1).to(torch.int32)
    t = x.shape[1]
    pos = _positions(t, x)[None, :]
    src = torch.clamp(pos + offset[:, None], max=t - 1)
    g = _take_rows(x, src)
    mask = (pos < length[:, None]).to(torch.float32)
    return {'Out': [g * _expand_mask(mask, g.ndim).to(g.dtype)],
            'Mask': [mask]}


@register('sequence_erase', no_grad_out_slots=('Out', 'Mask'))
def sequence_erase(ctx, ins, attrs):
    """The given token ids removed from each row (int sequences)."""
    x = ins['X'][0]
    keep = _mask_of(ins, x) > 0
    for tok in attrs.get('tokens', []):
        keep = keep & (x != tok)
    out, n = _stable_compact(x, keep)
    new_mask = _mask_to(n, x.shape[1], x)
    return {'Out': [out * new_mask.to(out.dtype)], 'Mask': [new_mask]}


@register('sequence_enumerate', no_grad_out_slots=('Out',))
def sequence_enumerate(ctx, ins, attrs):
    """Sliding windows of win_size, pad_value past each row's end."""
    x = ins['X'][0]  # [B, T] int
    length = _lengths(_mask_of(ins, x))
    win = int(attrs['win_size'])
    b, t = x.shape
    idx = _positions(t, x)[None, :, None] + \
        _positions(win, x)[None, None, :]
    valid = idx < length[:, None, None]
    g = torch.gather(x[:, :, None].expand(b, t, win), 1,
                     torch.clamp(idx, max=t - 1).expand(b, t, win))
    return {'Out': [torch.where(valid, g, torch.full_like(
        g, attrs.get('pad_value', 0)))]}


@register('sequence_reverse')
def sequence_reverse(ctx, ins, attrs):
    """Each row's valid prefix reversed in place."""
    x = ins['X'][0]
    length = _lengths(_mask_of(ins, x))[:, None]
    pos = _positions(x.shape[1], x)[None, :]
    src = torch.where(pos < length, length - 1 - pos, pos)
    return {'Y': [_take_rows(x, src)]}


@register('sequence_expand_as')
def sequence_expand_as(ctx, ins, attrs):
    """Each row vector of X over Y's timeline, masked to Y's lengths."""
    x = ins['X'][0]  # [B, D]
    y = ins['Y'][0]  # [B, T, ...] or [B, T]
    mask = ins['Mask'][0] if ins.get('Mask') else torch.ones(
        y.shape[:2], device=y.device)
    out = x[:, None, :].expand(x.shape[0], y.shape[1], x.shape[1])
    return {'Out': [out * mask[..., None].to(out.dtype)]}


@register('sequence_scatter')
def sequence_scatter(ctx, ins, attrs):
    """The masked per-row Updates added into X at Ids."""
    x = ins['X'][0]  # [N] or [N, D]
    ids = ins['Ids'][0]  # [B, T]
    upd = ins['Updates'][0]  # [B, T] (+D)
    mask = _mask_of(ins, ids)
    m = mask.to(upd.dtype).reshape(tuple(mask.shape) +
                                   (1,) * (upd.ndim - 2))
    flat = (upd * m).reshape((-1,) + tuple(upd.shape[2:]))
    return {'Out': [x.index_add(0, ids.reshape(-1).long(), flat)]}


@register('lod_reset')
def lod_reset(ctx, ins, attrs):
    """New sequence boundaries: the mask of the target lengths."""
    x = ins['X'][0]
    if ins.get('Y'):
        length = ins['Y'][0].reshape(-1)
    else:
        length = device_constant(np.asarray(attrs['target_lod']),
                                 x.device)
    t = x.shape[1] if x.ndim > 1 else x.shape[0]
    return {'Out': [x], 'Mask': [_mask_to(length, t, x)]}
