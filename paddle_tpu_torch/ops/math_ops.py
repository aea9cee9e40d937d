"""Dense math, elementwise (+paddle axis broadcast), comparison,
reduction and clipping lowerings.

Reference kernels: paddle/fluid/operators/{matmul,mul,scale,sum,clip}_op.*,
operators/elementwise/, operators/controlflow/compare_op.*,
operators/reduce_ops/.  The products (mul, matmul, matmul_v2, bmm) go
to torch.matmul (cuBLAS) in full f32 on the card, forward and backward,
as the JAX package asks XLA for Precision.HIGHEST (``_product``).
"""

import contextlib

import numpy as np
import torch

from .registry import register


def _x(ins, slot='X'):
    return ins[slot][0]


@contextlib.contextmanager
def _f32_products():
    """cuBLAS without TF32, whatever torch.backends.cuda.matmul.
    allow_tf32 says; the flag is put back after."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


class _Matmul(torch.autograd.Function):
    """torch.matmul of x and y (both at least 2-D, batch dims
    broadcast) without TF32, whose backward also runs without it:
    autograd's own matmul backward reads the global flag when it runs,
    after the forward's context has closed.  Each gradient is summed
    over the batch dims its operand was broadcast along."""

    @staticmethod
    def forward(ctx, x, y):
        ctx.save_for_backward(x, y)
        with _f32_products():
            return torch.matmul(x, y)

    @staticmethod
    def backward(ctx, g):
        x, y = ctx.saved_tensors
        gx = gy = None
        with _f32_products():
            if ctx.needs_input_grad[0]:
                gx = torch.matmul(g, y.transpose(-1, -2)).sum_to_size(
                    x.shape)
            if ctx.needs_input_grad[1]:
                gy = torch.matmul(x.transpose(-1, -2), g).sum_to_size(
                    y.shape)
        return gx, gy


def _product(x, y):
    """torch.matmul of x and y in their promoted dtype.  Where
    torch.backends.cuda.matmul.allow_tf32 allows TF32 for an f32
    product on the card, it goes through _Matmul (a 1-D operand a row
    or a column vector, dropped from the result, as torch.matmul
    treats it), whose forward and backward turn TF32 off.  Otherwise
    torch.matmul runs as it is: PyTorch's default keeps f32 products
    in f32, and the custom Function's ~30 us of host time a product,
    forward and backward, stays off the eager path."""
    if x.dtype != y.dtype:
        ct = torch.promote_types(x.dtype, y.dtype)
        x, y = x.to(ct), y.to(ct)
    if not (x.is_cuda and x.dtype == torch.float32 and
            torch.backends.cuda.matmul.allow_tf32):
        return torch.matmul(x, y)
    out = _Matmul.apply(x.unsqueeze(0) if x.ndim == 1 else x,
                        y.unsqueeze(-1) if y.ndim == 1 else y)
    if y.ndim == 1:
        out = out.squeeze(-1)
    if x.ndim == 1:
        out = out.squeeze(-2)
    return out


@register('matmul')
def matmul(ctx, ins, attrs):
    """Reference operators/matmul_op.cc: X and Y transposed in their
    last two dims where asked (a 1-D operand is not), their product
    with batch dims broadcast, then scaled by alpha."""
    x, y = ins['X'][0], ins['Y'][0]
    if attrs.get('transpose_X', False) and x.ndim > 1:
        x = x.transpose(-1, -2)
    if attrs.get('transpose_Y', False) and y.ndim > 1:
        y = y.transpose(-1, -2)
    out = _product(x, y)
    alpha = attrs.get('alpha', 1.0)
    if alpha != 1.0:
        out = out * alpha
    return {'Out': [out]}


@register('matmul_v2')
def matmul_v2(ctx, ins, attrs):
    a = dict(attrs)
    a['transpose_X'] = attrs.get('trans_x', False)
    a['transpose_Y'] = attrs.get('trans_y', False)
    return matmul(ctx, ins, a)


@register('bmm')
def bmm(ctx, ins, attrs):
    return {'Out': [_product(ins['X'][0], ins['Y'][0])]}


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
    out = _product(x.reshape(-1, k), y.reshape(k, n))
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
_ew('elementwise_pow', torch.pow)

# comparisons (the learning-rate schedules' and Variable's operators):
# a bool Out that carries no gradient
_ew('equal', torch.eq, ('Out',))
_ew('not_equal', torch.ne, ('Out',))
_ew('less_than', torch.lt, ('Out',))
_ew('less_equal', torch.le, ('Out',))
_ew('greater_than', torch.gt, ('Out',))
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


@register('top_k', no_grad_out_slots=('Indices',))
def top_k(ctx, ins, attrs):
    """The k largest along the last axis, largest first, int64 Indices;
    equal values keep their order (lower index first), as
    jax.lax.top_k gives them, through a stable sort."""
    x = _x(ins)
    k = int(attrs.get('k', 1))
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return {'Out': [vals[..., :k]], 'Indices': [idx[..., :k]]}
