"""Tensor creation / manipulation op lowerings, and feed/fetch.

Reference kernels: paddle/fluid/operators/{fill_constant,gaussian_random,
uniform_random,reshape,split,concat,cast,unsqueeze,lookup_table_v2}_op.cc|.cu,
operators/{fill_any_like,increment}_op.cc,
operators/controlflow/{feed,fetch}_op.cc.
"""

import numpy as np
import torch

from ..fluid import core
from .registry import register, register_host


def _x(ins, slot='X'):
    return ins[slot][0]


@register_host('feed')
def feed(ctx, ins, attrs):
    pass  # handled by Executor.run's feed dict


@register_host('fetch')
def fetch(ctx, ins, attrs):
    pass  # handled by Executor.run's fetch_list


@register('fill_constant')
def fill_constant(ctx, ins, attrs):
    shape = tuple(int(s) for s in attrs['shape'])
    value = attrs.get('value', 0.0)
    if attrs.get('str_value'):
        value = float(attrs['str_value'])
    return {'Out': [torch.full(shape, value,
                               dtype=core.convert_dtype(
                                   attrs.get('dtype', 'float32')),
                               device=ctx.device)]}


def _random_f32(ctx, shape, draw):
    """A float32 tensor of `shape` on the context's device, filled by
    `draw(tensor, generator)`; on the meta device (shape inference)
    nothing is drawn."""
    out = torch.empty(shape, dtype=torch.float32, device=ctx.device)
    if out.device.type != 'meta':
        draw(out, ctx.rng())
    return out


@register('uniform_random')
def uniform_random(ctx, ins, attrs):
    shape = tuple(int(s) for s in attrs['shape'])
    lo = attrs.get('min', -1.0)
    hi = attrs.get('max', 1.0)
    out = _random_f32(ctx, shape, lambda t, g: t.uniform_(lo, hi, generator=g))
    return {'Out': [out.to(core.convert_dtype(attrs.get('dtype',
                                                         'float32')))]}


@register('gaussian_random')
def gaussian_random(ctx, ins, attrs):
    shape = tuple(int(s) for s in attrs['shape'])
    mean = attrs.get('mean', 0.0)
    std = attrs.get('std', 1.0)
    out = _random_f32(ctx, shape,
                      lambda t, g: t.normal_(mean, std, generator=g))
    return {'Out': [out.to(core.convert_dtype(attrs.get('dtype',
                                                         'float32')))]}


def _resolve_shape(shape, x):
    """Paddle reshape semantics: 0 -> copy dim from x, -1 -> inferred."""
    shape = list(int(s) for s in shape)
    for i, s in enumerate(shape):
        if s == 0:
            shape[i] = x.shape[i]
    if -1 in shape:
        known = 1
        for s in shape:
            if s != -1:
                known *= s
        shape[shape.index(-1)] = int(np.prod(x.shape)) // known
    return tuple(shape)


@register('reshape2')
def reshape2(ctx, ins, attrs):
    # a view whenever the strides allow it: the split Q/K/V slices of
    # BERT's fused projection reach the attention kernel without a copy
    x = _x(ins)
    return {'Out': [x.reshape(_resolve_shape(attrs['shape'], x))]}


@register('split')
def split(ctx, ins, attrs):
    x = _x(ins)
    axis = attrs.get('axis', 0)
    num = attrs.get('num', 0)
    sections = list(attrs.get('sections', []))
    if sections:
        if -1 in sections:
            known = sum(s for s in sections if s != -1)
            sections[sections.index(-1)] = x.shape[axis] - known
    else:
        sections = [x.shape[axis] // num] * num
    return {'Out': list(torch.split(x, sections, dim=axis))}


@register('unsqueeze2')
def unsqueeze2(ctx, ins, attrs):
    x = _x(ins)
    for a in sorted(attrs['axes']):
        x = x.unsqueeze(a)
    return {'Out': [x]}


@register('lookup_table_v2')
def lookup_table_v2(ctx, ins, attrs):
    # the hand-written gather kernel on CUDA tensors, its plain
    # index_select version on the CPU (ops/kernels/embedding.py)
    from .kernels import embedding
    w = ins['W'][0]
    ids = ins['Ids'][0]
    padding_idx = attrs.get('padding_idx', -1)
    return {'Out': [embedding.embedding_lookup(w, ids, padding_idx)]}


@register('lookup_table')
def lookup_table(ctx, ins, attrs):
    # v1 requires ids shape [..., 1] (reference operators/lookup_table_op.cc)
    ids = ins['Ids'][0]
    if ids.ndim > 1 and ids.shape[-1] == 1:
        ids = ids.squeeze(-1)
    return lookup_table_v2(ctx, {'W': ins['W'], 'Ids': [ids]}, attrs)


@register('slice')
def slice_op(ctx, ins, attrs):
    """Reference operators/slice_op.cc: a view of x cut along `axes`;
    negative starts/ends count from the end."""
    x = ins['Input'][0]
    idx = [slice(None)] * x.ndim
    for ax, st, en in zip(attrs['axes'], attrs['starts'], attrs['ends']):
        dim = x.shape[ax]
        st = max(st + dim, 0) if st < 0 else min(st, dim)
        en = max(en + dim, 0) if en < 0 else min(en, dim)
        idx[ax] = slice(st, en)
    out = x[tuple(idx)]
    for ax in sorted(attrs.get('decrease_axis', []), reverse=True):
        out = out.squeeze(ax)
    return {'Out': [out]}


@register('fill_zeros_like')
def fill_zeros_like(ctx, ins, attrs):
    return {'Out': [torch.zeros_like(_x(ins))]}


@register('fill_any_like')
def fill_any_like(ctx, ins, attrs):
    return {'Out': [torch.full_like(_x(ins), attrs.get('value', 0.0))]}


@register('cast')
def cast(ctx, ins, attrs):
    return {'Out': [_x(ins).to(core.convert_dtype(attrs['out_dtype']))]}


@register('concat')
def concat(ctx, ins, attrs):
    return {'Out': [torch.cat(ins['X'], dim=attrs.get('axis', 0))]}


@register('increment')
def increment(ctx, ins, attrs):
    """The learning-rate schedules' step counter: X + step."""
    return {'Out': [_x(ins) + attrs.get('step', 1.0)]}
