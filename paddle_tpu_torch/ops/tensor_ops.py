"""Tensor creation / manipulation op lowerings, and feed/fetch.

Reference kernels: paddle/fluid/operators/{fill_constant,gaussian_random,
uniform_random,reshape,split,concat,cast,unsqueeze,squeeze,transpose,
expand,stack,gather,shape,range,one_hot,lookup_table_v2,flatten,
strided_slice,expand_as,tile,unstack,gather_nd,scatter,cumsum,pad,pad2d,
where,where_index,diag,flip,roll,tril_triu,index_select,minus,
coalesce_tensor,shuffle_batch,truncated_gaussian_random}_op.cc|.cu,
operators/{fill_any_like,increment}_op.cc,
operators/controlflow/{feed,fetch}_op.cc.  The shape ops return views
where the strides allow, as jnp's do under XLA.
"""

import math

import numpy as np
import torch

from ..fluid import core
from .registry import device_constant, register, register_host


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


@register('fill_constant_batch_size_like')
def fill_constant_batch_size_like(ctx, ins, attrs):
    """A constant of `shape` whose dim output_dim_idx is Input's dim
    input_dim_idx (the batch)."""
    ref = _x(ins, 'Input')
    shape = list(attrs['shape'])
    shape[attrs.get('output_dim_idx', 0)] = \
        ref.shape[attrs.get('input_dim_idx', 0)]
    return {'Out': [torch.full(tuple(shape), attrs.get('value', 0.0),
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


@register('uniform_random', host_random=True)
def uniform_random(ctx, ins, attrs):
    """Uniform in [min, max): in a startup program from the host
    generator (``LowerCtx.host_draws``: the initializers' values), in
    any other program from the counter hash on the device (``_unit``),
    which a CUDA graph replays with each step's own draws."""
    shape = tuple(int(s) for s in attrs['shape'])
    lo = attrs.get('min', -1.0)
    hi = attrs.get('max', 1.0)
    if ctx.host_draws:
        out = _random_f32(ctx, shape,
                          lambda t, g: t.uniform_(lo, hi, generator=g))
    else:
        out = lo + (hi - lo) * _unit(ctx, attrs, shape, ctx.device, 0x0A1)
    return {'Out': [out.to(core.convert_dtype(attrs.get('dtype',
                                                         'float32')))]}


@register('gaussian_random', host_random=True)
def gaussian_random(ctx, ins, attrs):
    """mean + std * a standard normal, drawn as uniform_random's."""
    shape = tuple(int(s) for s in attrs['shape'])
    mean = attrs.get('mean', 0.0)
    std = attrs.get('std', 1.0)
    if ctx.host_draws:
        out = _random_f32(ctx, shape,
                          lambda t, g: t.normal_(mean, std, generator=g))
    else:
        out = mean + std * normal_draws(ctx, attrs, shape, ctx.device,
                                        0x6A1)
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
    return {'Out': [device_constant(
        np.array(ins['Input'][0].shape, dtype=np.int32), ctx.device)]}


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
    return {'Out': [device_constant(vals, ctx.device)]}


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


@register('recompute_barrier')
def recompute_barrier(ctx, ins, attrs):
    """The input of a span RecomputeOptimizer runs again in the backward
    (fluid/backward.py).  The JAX package makes it an
    optimization_barrier so XLA does not merge the span with the
    forward; PyTorch merges nothing, so it is the identity."""
    return {'Out': [_x(ins)]}


@register('assign_value')
def assign_value(ctx, ins, attrs):
    """A constant from the op's attrs: values (flat), shape, dtype."""
    dtype = core.convert_dtype(attrs.get('dtype', 'float32'))
    vals = torch.tensor(attrs['values'], dtype=dtype).reshape(
        tuple(int(s) for s in attrs['shape']))
    if dtype == torch.bfloat16:  # numpy has no bfloat16
        return {'Out': [vals.to(ctx.device)]}
    return {'Out': [device_constant(vals.numpy(), ctx.device)]}


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


# ---------------------------------------------------------------------------
# The tensor-array family (reference operators/controlflow/tensor_array_*,
# lod_tensor_to_array_op.cc, shrink_rnn_memory_op.cc, split_lod_tensor_op.cc,
# merge_lod_tensor_op.cc, select_input_op.cc, select_output_op.cc).  As in
# the JAX package (ops/tensor_ops.py:576-655), a LoDTensorArray of same-shaped
# items is one stacked tensor with the index on axis 0 (a created array has
# ARRAY_CAPACITY rows, fluid/layers/control_flow.py); an index past either
# end is clamped, as lax's dynamic slicing clamps it, and nothing reads it
# on the host, so a loop body that reads and writes arrays can be captured.
# ---------------------------------------------------------------------------


def _array_index(ins, n):
    return ins['I'][0].reshape(1).long().clamp(0, n - 1)


@register('write_to_array')
def write_to_array(ctx, ins, attrs):
    arr = ins['Array'][0]
    x = _x(ins).to(arr.dtype)
    return {'Out': [arr.index_copy(0, _array_index(ins, arr.shape[0]),
                                   x.unsqueeze(0))]}


@register('read_from_array')
def read_from_array(ctx, ins, attrs):
    arr = _x(ins)
    return {'Out': [arr.index_select(
        0, _array_index(ins, arr.shape[0])).squeeze(0)]}


@register('lod_tensor_to_array')
def lod_tensor_to_array(ctx, ins, attrs):
    """[B, T, ...] -> the time-major stack [T, B, ...] (the reference
    splits by the LoD rank table; padded+mask makes it a transpose)."""
    return {'Out': [_x(ins).transpose(0, 1)]}


@register('array_to_lod_tensor')
def array_to_lod_tensor(ctx, ins, attrs):
    return {'Out': [_x(ins).transpose(0, 1)]}


@register('shrink_rnn_memory')
def shrink_rnn_memory(ctx, ins, attrs):
    """The reference keeps the first rank_table[i] rows at step I; here
    the rows whose length (RankTable) is not past I are zeroed."""
    x = _x(ins)
    i = ins['I'][0].reshape(()).to(torch.int32)
    keep = (ins['RankTable'][0].to(torch.int32) > i).to(x.dtype)
    return {'Out': [x * keep.reshape((-1,) + (1,) * (x.ndim - 1))]}


@register('split_lod_tensor')
def split_lod_tensor(ctx, ins, attrs):
    """Both branches get the whole tensor, the other branch's rows
    zeroed."""
    x = _x(ins)
    m = ins['Mask'][0].reshape((-1,) + (1,) * (x.ndim - 1)).to(x.dtype)
    return {'OutTrue': [x * m], 'OutFalse': [x * (1 - m)]}


@register('merge_lod_tensor')
def merge_lod_tensor(ctx, ins, attrs):
    x_t = ins['InTrue'][0]
    m = ins['Mask'][0].reshape((-1,) + (1,) * (x_t.ndim - 1))
    return {'Out': [torch.where(m.bool(), x_t, ins['InFalse'][0])]}


@register('select_input')
def select_input(ctx, ins, attrs):
    """Out = X[Mask], the candidates stacked and indexed on the device."""
    xs = torch.stack(ins['X'])
    m = ins['Mask'][0].reshape(1).long().clamp(0, len(ins['X']) - 1)
    return {'Out': [xs.index_select(0, m).squeeze(0)]}


@register('select_output')
def select_output(ctx, ins, attrs):
    """X routed to branch Mask; the other branches read zeros."""
    x = _x(ins)
    m = ins['Mask'][0].reshape(())
    zeros = torch.zeros_like(x)
    return {'Out': [torch.where(m == k, x, zeros)
                    for k in range(attrs.get('branches', 2))]}


@register('while')
def while_op(ctx, ins, attrs):
    """Lowered by the executor (Executor._lower_while), which runs the
    sub-block; the entry names the op type."""
    raise RuntimeError('the while op is lowered by the executor, not the '
                       'registry')


@register('conditional_block')
def conditional_block_op(ctx, ins, attrs):
    """Lowered by the executor (Executor._lower_conditional_block)."""
    raise RuntimeError('conditional_block is lowered by the executor, not '
                       'the registry')


# ---------------------------------------------------------------------------
# The rest of the JAX package's ops/tensor_ops.py: flattening, strided and
# n-d indexing, scatter, tiling, cumulative sums, padding, selection,
# flips, the draws of the batch-size-like and truncated initializers and
# coalesce_tensor.
# ---------------------------------------------------------------------------


def _flatten_to_2d(x, axis):
    lead = int(np.prod(x.shape[:axis])) if axis > 0 else 1
    return x.reshape(lead, -1)


@register('flatten2')
def flatten2(ctx, ins, attrs):
    """X folded to 2-D at `axis` (dims before it make the rows)."""
    return {'Out': [_flatten_to_2d(_x(ins), attrs.get('axis', 1))]}


# v1 op name (no XShape output), the same semantics
register('flatten')(flatten2)


@register('flatten_contiguous_range')
def flatten_contiguous_range(ctx, ins, attrs):
    x = _x(ins)
    start = attrs.get('start_axis', 1)
    stop = attrs.get('stop_axis', -1) % x.ndim
    return {'Out': [x.reshape(tuple(x.shape[:start]) + (-1,) +
                              tuple(x.shape[stop + 1:]))]}


@register('strided_slice')
def strided_slice(ctx, ins, attrs):
    """X[start:end:stride] along each listed axis, Python's slice rule;
    a negative stride (which a torch view cannot take) gathers the
    indices the slice names."""
    x = ins['Input'][0]
    for ax, st, en, sd in zip(attrs['axes'], attrs['starts'], attrs['ends'],
                              attrs['strides']):
        s = slice(st, en, sd)
        if sd > 0:
            idx = [slice(None)] * x.ndim
            idx[ax] = s
            x = x[tuple(idx)]
        else:
            pick = torch.arange(*s.indices(x.shape[ax]), device=x.device)
            x = x.index_select(ax, pick)
    return {'Out': [x]}


@register('expand_as')
def expand_as(ctx, ins, attrs):
    """X tiled to target_tensor's shape (each dim target // X's)."""
    x = _x(ins)
    target = ins['target_tensor'][0]
    return {'Out': [torch.tile(x, tuple(t // s for t, s in
                                        zip(target.shape, x.shape)))]}


@register('tile')
def tile(ctx, ins, attrs):
    return {'Out': [torch.tile(_x(ins), tuple(attrs['repeat_times']))]}


@register('unstack')
def unstack(ctx, ins, attrs):
    return {'Y': list(torch.unbind(_x(ins), dim=attrs.get('axis', 0)))}


def _wrap(idx, n):
    """int64 indices with the negative ones counted from the end."""
    idx = idx.long()
    return torch.where(idx < 0, idx + n, idx)


@register('gather_nd')
def gather_nd(ctx, ins, attrs):
    """X at the leading coordinates Index[..., :k] (k = Index's last
    dim): Index.shape[:-1] + X.shape[k:]."""
    x = _x(ins)
    idx = ins['Index'][0].long()
    return {'Out': [x[tuple(_wrap(idx[..., i], x.shape[i])
                            for i in range(idx.shape[-1]))]]}


@register('scatter')
def scatter(ctx, ins, attrs):
    """X with the rows Ids replaced by Updates (overwrite) or Updates
    added to them."""
    x = _x(ins)
    ids = _wrap(ins['Ids'][0].reshape(-1), x.shape[0])
    upd = ins['Updates'][0].to(x.dtype)
    if attrs.get('overwrite', True):
        return {'Out': [x.index_copy(0, ids, upd)]}
    return {'Out': [x.index_add(0, ids, upd)]}


register('embedding')(lookup_table_v2)


@register('cumsum')
def cumsum(ctx, ins, attrs):
    """The running sum along `axis` (of the flattened X with `flatten`),
    from the end with `reverse`, each sum without its own element with
    `exclusive` (a zero first, the last sum dropped), in X's dtype as
    jnp.cumsum keeps it."""
    x = _x(ins)
    axis = attrs.get('axis', -1)
    if attrs.get('flatten', False):
        x, axis = x.reshape(-1), 0
    axis %= x.ndim
    if attrs.get('reverse', False):
        out = torch.flip(torch.cumsum(torch.flip(x, (axis,)), dim=axis,
                                      dtype=x.dtype), (axis,))
    else:
        out = torch.cumsum(x, dim=axis, dtype=x.dtype)
    if attrs.get('exclusive', False):
        pad = [0, 0] * (x.ndim - 1 - axis) + [1, 0]
        out = torch.nn.functional.pad(out, pad).narrow(axis, 0,
                                                       x.shape[axis])
    return {'Out': [out]}


def _pad_pairs(widths):
    """[(before, after)] per dim -> F.pad's flat list, last dim first."""
    out = []
    for lo, hi in reversed(widths):
        out += [lo, hi]
    return out


@register('pad')
def pad(ctx, ins, attrs):
    x = _x(ins)
    p = attrs['paddings']
    widths = [(p[2 * i], p[2 * i + 1]) for i in range(x.ndim)]
    return {'Out': [torch.nn.functional.pad(
        x, _pad_pairs(widths), value=attrs.get('pad_value', 0.0))]}


@register('pad2d')
def pad2d(ctx, ins, attrs):
    """H and W padded by [top, bottom, left, right]: a constant, or the
    reflection / edge values (replicate) of jnp.pad's modes."""
    x = _x(ins)
    p = attrs['paddings']
    mode = attrs.get('mode', 'constant')
    nhwc = attrs.get('data_format', 'NCHW') == 'NHWC'
    if nhwc:
        x = x.permute(0, 3, 1, 2)
    flat = [p[2], p[3], p[0], p[1]]
    if mode == 'constant':
        out = torch.nn.functional.pad(x, flat,
                                      value=attrs.get('pad_value', 0.0))
    else:
        out = torch.nn.functional.pad(
            x, flat, mode={'reflect': 'reflect', 'edge': 'replicate'}[mode])
    return {'Out': [out.permute(0, 2, 3, 1) if nhwc else out]}


@register('where')
def where(ctx, ins, attrs):
    cond = ins['Condition'][0]
    return {'Out': [torch.where(cond if cond.dtype == torch.bool
                                else cond != 0, ins['X'][0], ins['Y'][0])]}


@register('where_index', no_grad_out_slots=('Out',))
def where_index(ctx, ins, attrs):
    """The int64 coordinates [capacity, rank] of Condition's nonzero
    elements in row-major order, the rows past their count -1: the JAX
    package's capacity-padded form (tensor_ops.py:426), whose shape does
    not depend on the data.  The rows are placed by a running count on
    the device (no host read, so a CUDA graph can hold it).  Without a
    capacity the op raises, as there."""
    cap = attrs.get('capacity')
    if cap is None:
        raise NotImplementedError(
            'where_index has a data-dependent output shape; pass '
            "attrs={'capacity': K} for a [K, rank] result padded with -1 "
            'rows (mask on out[:, 0] >= 0), or use masking')
    cap = int(cap)
    cond = ins['Condition'][0]
    flat = (cond != 0).reshape(-1)
    n = flat.numel()
    pos = torch.cumsum(flat.long(), 0) - 1
    slot = torch.where(flat & (pos < cap), pos,
                       torch.full((), cap, dtype=torch.long,
                                  device=cond.device))
    src = torch.arange(n, dtype=torch.long, device=cond.device)
    picked = torch.full((cap + 1,), -1, dtype=torch.long, device=cond.device)
    picked = picked.scatter(0, slot, src)[:cap]
    coords, rest = [], picked
    for d in reversed(cond.shape):
        coords.append(torch.remainder(rest, d))
        rest = torch.div(rest, d, rounding_mode='floor')
    coords = torch.stack(coords[::-1], dim=1) if coords else \
        picked.new_zeros((cap, 0))
    return {'Out': [torch.where(picked[:, None] >= 0, coords,
                                torch.full((), -1, dtype=torch.long,
                                           device=cond.device))]}


@register('diag')
def diag(ctx, ins, attrs):
    """A square matrix with the 1-D Diagonal on its main diagonal."""
    return {'Out': [torch.diag(ins['Diagonal'][0])]}


def _axes(a):
    return (a,) if isinstance(a, int) else tuple(a)


@register('flip')
def flip(ctx, ins, attrs):
    return {'Out': [torch.flip(_x(ins), _axes(attrs['axis']))]}


@register('reverse')
def reverse(ctx, ins, attrs):
    """X flipped along each axis of `axis` (default [0])."""
    return {'Out': [torch.flip(_x(ins), _axes(attrs.get('axis', [0])))]}


@register('roll')
def roll(ctx, ins, attrs):
    """X rolled by `shifts` along `axis` (the flattened X without
    one)."""
    axis = attrs.get('axis')
    shifts = attrs['shifts']
    if not axis:
        x = _x(ins)
        shift = shifts if isinstance(shifts, int) else sum(shifts)
        return {'Out': [torch.roll(x.reshape(-1), shift).reshape(x.shape)]}
    return {'Out': [torch.roll(_x(ins), _axes(shifts), _axes(axis))]}


@register('tril_triu')
def tril_triu(ctx, ins, attrs):
    x = _x(ins)
    d = attrs.get('diagonal', 0)
    return {'Out': [torch.tril(x, d) if attrs.get('lower', True)
                    else torch.triu(x, d)]}


@register('index_select')
def index_select(ctx, ins, attrs):
    """X's slices at Index along `dim` (jnp.take, as the gather op)."""
    return gather(ctx, {'X': ins['X'], 'Index': ins['Index']},
                  {'axis': attrs.get('dim', 0)})


@register('minus')
def minus(ctx, ins, attrs):
    return {'Out': [ins['X'][0] - ins['Y'][0]]}


register('share_data')(assign)
register('split_byref')(split)


@register('coalesce_tensor', no_grad_out_slots=('FusedOutput',))
def coalesce_tensor(ctx, ins, attrs):
    """The inputs as they are (Output) and their flattened values end to
    end (FusedOutput), as the JAX package renders the reference's fused
    gradient buffer."""
    xs = ins['Input']
    return {'Output': list(xs),
            'FusedOutput': [torch.cat([v.reshape(-1) for v in xs])]}


# Draws of the ops below come from the dropout op's counter hash
# (kernels.dropout.hash_bits) under LowerCtx.sample_seed, the device step
# mixed in, so a CUDA graph replays each step's own draws; jax threefry's
# bits are not reproduced, and the tests hold the draws by statistics.

def _unit(ctx, attrs, shape, device, salt):
    """f32 draws in (0, 1) of `shape`: (the top 23 of the 24 hash bits +
    0.5) / 2^23, each exact in f32 and below 1 (with 24 bits, 2^24 - 0.5
    rounds to 2^24: a draw of 1, whose inverse normal CDF is inf)."""
    from .kernels import dropout as _hash
    seed = ctx.sample_seed(salt + int(attrs.get('seed', 0) or 0))
    bits = _hash.hash_bits(seed, shape, device) >> 1
    return (bits.to(torch.float32) + 0.5) * (2.0 ** -23)


def normal_draws(ctx, attrs, shape, device, salt, lo=None, hi=None):
    """f32 standard normal draws of `shape` by the inverse CDF of
    ``_unit``'s, truncated to [lo, hi] where both are given (the CDF's
    interval mapped onto (0, 1) first, as jax.random.truncated_normal
    draws them)."""
    u = _unit(ctx, attrs, shape, device, salt)
    if lo is not None:
        a, b = (0.5 * (1.0 + math.erf(v / math.sqrt(2.0))) for v in (lo, hi))
        u = a + u * (b - a)
    return math.sqrt(2.0) * torch.erfinv(2.0 * u - 1.0)


@register('truncated_gaussian_random')
def truncated_gaussian_random(ctx, ins, attrs):
    """mean + std * a standard normal truncated to [-2, 2]."""
    shape = tuple(int(s) for s in attrs['shape'])
    out = normal_draws(ctx, attrs, shape, ctx.device, 0x7A11, -2.0, 2.0)
    return {'Out': [(attrs.get('mean', 0.0) + attrs.get('std', 1.0) * out)
                    .to(core.convert_dtype(attrs.get('dtype', 'float32')))]}


@register('uniform_random_batch_size_like')
def uniform_random_batch_size_like(ctx, ins, attrs):
    """Uniform in [min, max) of `shape` whose dim output_dim_idx is
    Input's dim input_dim_idx."""
    ref = ins['Input'][0]
    shape = list(attrs['shape'])
    shape[attrs.get('output_dim_idx', 0)] = \
        ref.shape[attrs.get('input_dim_idx', 0)]
    lo, hi = attrs.get('min', -1.0), attrs.get('max', 1.0)
    u = _unit(ctx, attrs, tuple(shape), ref.device, 0x0B5)
    return {'Out': [(lo + (hi - lo) * u).to(
        core.convert_dtype(attrs.get('dtype', 'float32')))]}


@register('shuffle_batch', no_grad_out_slots=('ShuffleIdx', 'SeedOut'))
def shuffle_batch(ctx, ins, attrs):
    """X's rows in a random order (ShuffleIdx, int64): a stable sort of
    one hash draw per row; SeedOut is the op's seed, as in the JAX
    package."""
    from .kernels import dropout as _hash
    x = _x(ins)
    seed = ctx.sample_seed(0x5B + int(attrs.get('startup_seed', 0) or 0))
    keys = _hash.hash_bits(seed, (x.shape[0],), x.device)
    idx = torch.sort(keys, stable=True)[1]
    return {'Out': [x.index_select(0, idx)], 'ShuffleIdx': [idx],
            'SeedOut': [torch.full((1,), ctx.op_seed, dtype=torch.int32,
                                   device=x.device)]}
