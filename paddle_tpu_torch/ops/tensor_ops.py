"""Tensor creation / manipulation op lowerings, and feed/fetch.

Reference kernels: paddle/fluid/operators/{fill_constant,gaussian_random,
uniform_random,reshape,split,concat,cast,unsqueeze,squeeze,transpose,
expand,stack,gather,shape,range,one_hot,lookup_table_v2}_op.cc|.cu,
operators/{fill_any_like,increment}_op.cc,
operators/controlflow/{feed,fetch}_op.cc.  The shape ops return views
where the strides allow, as jnp's do under XLA.
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


# v1 op name (no XShape output), the same semantics
register('reshape')(reshape2)


@register('transpose2')
def transpose2(ctx, ins, attrs):
    return {'Out': [_x(ins).permute(*attrs['axis'])]}


register('transpose')(transpose2)


@register('squeeze2', no_grad_out_slots=('XShape',))
def squeeze2(ctx, ins, attrs):
    """Drops the listed axes that have size 1 (every size-1 axis when
    none is listed); an axis of another size stays."""
    x = _x(ins)
    axes = attrs.get('axes', [])
    if not axes:
        return {'Out': [x.squeeze()]}
    axes = tuple(a % x.ndim for a in axes if x.shape[a] == 1)
    return {'Out': [x.squeeze(axes) if axes else x]}


@register('squeeze')
def squeeze(ctx, ins, attrs):
    """Reference operators/squeeze_op.cc (v1: no XShape output)."""
    x = _x(ins)
    axes = attrs.get('axes', [])
    if axes:
        shape = [d for i, d in enumerate(x.shape)
                 if not (d == 1 and (i in axes or i - x.ndim in axes))]
    else:
        shape = [d for d in x.shape if d != 1]
    return {'Out': [x.reshape(shape)]}


@register('expand')
def expand(ctx, ins, attrs):
    """X repeated expand_times[i] times along axis i (jnp.tile's
    rule)."""
    return {'Out': [torch.tile(_x(ins), tuple(attrs['expand_times']))]}


@register('stack')
def stack(ctx, ins, attrs):
    return {'Y': [torch.stack(ins['X'], dim=attrs.get('axis', 0))]}


@register('gather')
def gather(ctx, ins, attrs):
    """X's slices at Index along `axis` (jnp.take): the result has
    Index's dims in place of that axis; a negative index counts from
    the end.  An index past either end raises (IndexError here, a
    device-side assert on the card)."""
    x = _x(ins)
    idx = ins['Index'][0]
    axis = attrs.get('axis', 0) % x.ndim
    n = x.shape[axis]
    flat = idx.reshape(-1).long()
    flat = torch.where(flat < 0, flat + n, flat)
    out = torch.index_select(x, axis, flat)
    return {'Out': [out.reshape(tuple(x.shape[:axis]) + tuple(idx.shape) +
                                tuple(x.shape[axis + 1:]))]}


@register('shape', no_grad_out_slots=('Out',))
def shape_op(ctx, ins, attrs):
    """Input's shape as an int32 vector."""
    return {'Out': [torch.tensor(tuple(ins['Input'][0].shape),
                                 dtype=torch.int32, device=ctx.device)]}


@register('range')
def range_op(ctx, ins, attrs):
    """[Start, End) by Step in Start's dtype.  The layer stores literal
    bounds as the attr __static__; the values np.arange gives for them
    are the JAX package's (jnp.arange of static bounds).  Bounds that
    are only tensors raise, as they do in the JAX package (XLA needs
    static sizes)."""
    if '__static__' not in attrs:
        raise NotImplementedError(
            'range with traced bounds is not supported; pass python '
            'scalars to layers.range')
    s, e, st = attrs['__static__']
    dtype = ins['Start'][0].dtype
    vals = np.arange(s, e, st, dtype=np.dtype(core.dtype_name(dtype)))
    return {'Out': [torch.as_tensor(vals, device=ctx.device)]}


@register('one_hot', no_grad_out_slots=('Out',))
def one_hot(ctx, ins, attrs):
    """f32 rows of `depth` with a 1 at each id (all 0 for an id outside
    [0, depth)), as jax.nn.one_hot gives them.  A trailing axis of size
    1 is dropped first, so [B, T] ids give [B, T, depth]."""
    x = _x(ins)
    if x.ndim > 1 and x.shape[-1] == 1:
        x = x.squeeze(-1)
    depth = int(attrs['depth'])
    cls = torch.arange(depth, dtype=x.dtype, device=x.device)
    return {'Out': [(x.unsqueeze(-1) == cls).to(torch.float32)]}


register('one_hot_v2', no_grad_out_slots=('Out',))(one_hot)


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


# v1 op name (no XShape output), the same semantics
register('unsqueeze')(unsqueeze2)


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


@register('assign')
def assign(ctx, ins, attrs):
    return {'Out': [_x(ins)]}


@register('assign_value')
def assign_value(ctx, ins, attrs):
    """A constant from the op's attrs: values (flat), shape, dtype."""
    dtype = core.convert_dtype(attrs.get('dtype', 'float32'))
    vals = torch.tensor(attrs['values'], dtype=dtype)
    return {'Out': [vals.reshape(tuple(int(s) for s in attrs['shape']))
                    .to(ctx.device)]}


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
