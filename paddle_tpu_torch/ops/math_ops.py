"""Dense math and elementwise (+paddle axis broadcast) lowerings.

Reference kernels: paddle/fluid/operators/{mul,scale}_op.*,
operators/elementwise/.  The products go to torch.matmul (cuBLAS in
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


@register('elementwise_add')
def elementwise_add(ctx, ins, attrs):
    x, y = _bcast(ins['X'][0], ins['Y'][0], attrs.get('axis', -1))
    return {'Out': [x + y]}


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
