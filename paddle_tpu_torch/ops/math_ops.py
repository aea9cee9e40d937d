"""Dense math, elementwise (+paddle axis broadcast), comparison,
reduction and clipping lowerings.

Reference kernels: paddle/fluid/operators/{mul,scale,sum,clip}_op.*,
operators/elementwise/, operators/controlflow/compare_op.*,
operators/reduce_ops/.  The products go to torch.matmul (cuBLAS in
full float32 unless the caller enables TF32), as the JAX package left
them to XLA.
"""

import numpy as np
import torch

from .registry import register


def _x(ins, slot='X'):
    return ins[slot][0]


@register('mul')
def mul(ctx, ins, attrs):
    """Reference operators/mul_op.cc: x flattened to 2-D by
    x_num_col_dims times y flattened by y_num_col_dims; x's trailing
    dims contract against the weight unfolded to match them."""
    x, y = ins['X'][0], ins['Y'][0]
    xn = attrs.get('x_num_col_dims', 1)
    yn = attrs.get('y_num_col_dims', 1)
    xs, ys = tuple(x.shape), tuple(y.shape)
    k = int(np.prod(xs[xn:]))
    n = int(np.prod(ys[yn:]))
    if x.dtype != y.dtype:
        ct = torch.promote_types(x.dtype, y.dtype)
        x, y = x.to(ct), y.to(ct)
    out = torch.matmul(x.reshape(-1, k), y.reshape(k, n))
    return {'Out': [out.reshape(xs[:xn] + ys[yn:])]}


@register('scale')
def scale(ctx, ins, attrs):
    x = _x(ins)
    s = attrs.get('scale', 1.0)
    b = attrs.get('bias', 0.0)
    if attrs.get('bias_after_scale', True):
        return {'Out': [x * s + b]}
    return {'Out': [(x + b) * s]}


def _bcast(x, y, axis):
    """Reference broadcast rule (operators/elementwise/elementwise_op.h):
    y's dims align to x starting at `axis` (default: trailing)."""
    if x.shape == y.shape:
        return x, y
    if y.ndim > x.ndim:
        y2, x2 = _bcast(y, x, axis)
        return x2, y2
    if axis is None or axis == -1:
        return x, y  # numpy trailing broadcast
    yshape = (1,) * axis + tuple(y.shape) + (1,) * (x.ndim - axis - y.ndim)
    return x, y.reshape(yshape)


def _ew(name, fn, no_grad_out_slots=()):
    @register(name, no_grad_out_slots=no_grad_out_slots)
    def op(ctx, ins, attrs, _fn=fn):
        x, y = _bcast(ins['X'][0], ins['Y'][0], attrs.get('axis', -1))
        return {'Out': [_fn(x, y)]}
    return op


# torch.minimum / maximum split the gradient evenly at ties, as the
# JAX package's jnp.minimum / maximum do
_ew('elementwise_add', lambda x, y: x + y)
_ew('elementwise_sub', lambda x, y: x - y)
_ew('elementwise_mul', lambda x, y: x * y)
_ew('elementwise_div', lambda x, y: x / y)
_ew('elementwise_min', torch.minimum)
_ew('elementwise_max', torch.maximum)

# comparisons (the learning-rate schedules'): a bool Out that carries
# no gradient
_ew('less_than', torch.lt, ('Out',))
_ew('greater_equal', torch.ge, ('Out',))


@register('reduce_sum')
def reduce_sum(ctx, ins, attrs):
    x = _x(ins)
    dims = tuple(range(x.ndim)) if attrs.get('reduce_all', False) else \
        tuple(a % x.ndim for a in attrs.get('dim', [0]))
    return {'Out': [torch.sum(x, dim=dims,
                              keepdim=attrs.get('keep_dim', False))]}


def _scalar(v, like):
    return torch.full((), float(v), dtype=like.dtype, device=like.device)


@register('clip')
def clip(ctx, ins, attrs):
    """jnp.clip's definition, maximum then minimum (so a gradient at a
    bound splits as the JAX package's does)."""
    x = _x(ins)
    return {'Out': [torch.minimum(torch.maximum(x, _scalar(attrs['min'], x)),
                                  _scalar(attrs['max'], x))]}


@register('clip_by_norm')
def clip_by_norm(ctx, ins, attrs):
    """x scaled by min(max_norm / ||x||, 1), ||x|| floored at 1e-12."""
    x = _x(ins)
    norm = torch.sqrt(torch.sum(x * x))
    scale = torch.minimum(
        attrs['max_norm'] / torch.maximum(norm, _scalar(1e-12, norm)),
        _scalar(1.0, norm))
    return {'Out': [x * scale]}


@register('squared_l2_norm')
def squared_l2_norm(ctx, ins, attrs):
    return {'Out': [torch.sum(_x(ins).float() ** 2).reshape(1)]}


@register('mean')
def mean(ctx, ins, attrs):
    return {'Out': [_x(ins).mean()]}


@register('sum')
def sum_op(ctx, ins, attrs):
    """Add N tensors in order (gradient aggregation). Reference
    operators/sum_op."""
    xs = ins['X']
    out = xs[0]
    for x in xs[1:]:
        out = out + x
    return {'Out': [out]}
