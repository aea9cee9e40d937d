"""Dense math, elementwise (+paddle axis broadcast), comparison,
reduction, clipping, finite-check, norm, sorting and linalg lowerings.

Reference kernels: paddle/fluid/operators/{matmul,mul,scale,sum,clip,
dot,isfinite,p_norm,arg_min_max,top_k,argsort,norm,cholesky,inverse}_op.*,
operators/elementwise/, operators/controlflow/compare_op.*,
operators/reduce_ops/.  The products (mul, matmul, matmul_v2, bmm) go
to torch.matmul (cuBLAS) in full f32 on the card, forward and backward,
as the JAX package asks XLA for Precision.HIGHEST (``_product``).
Under AMP (the ``__amp__`` mark of fluid.contrib.mixed_precision) mul,
matmul and matmul_v2 take bf16 operands, accumulate in f32 and give a
bf16 output, as the JAX package's lowerings do (math_ops.py:36-41,
78-80); bmm is not on the white list.
"""

import contextlib

import numpy as np
import torch

from .registry import register


def _x(ins, slot='X'):
    return ins[slot][0]


@contextlib.contextmanager
def _f32_products():
    """cuBLAS without TF32 for f32 products and without bf16 partial
    sums for bf16 ones (split-K reductions in f32, as XLA takes them),
    whatever torch.backends.cuda.matmul.allow_tf32 and
    allow_bf16_reduced_precision_reduction say; the flags are put back
    after."""
    flags = torch.backends.cuda.matmul
    prev = flags.allow_tf32, flags.allow_bf16_reduced_precision_reduction
    flags.allow_tf32 = False
    flags.allow_bf16_reduced_precision_reduction = False
    try:
        yield
    finally:
        flags.allow_tf32, flags.allow_bf16_reduced_precision_reduction = \
            prev


def _reduced(dtype):
    """True where the cuBLAS flags let a product of this dtype round
    below its accumulation: TF32 for f32, bf16 partial sums for bf16."""
    flags = torch.backends.cuda.matmul
    if dtype == torch.float32:
        return flags.allow_tf32
    if dtype == torch.bfloat16:
        return flags.allow_bf16_reduced_precision_reduction
    return False


class _Matmul(torch.autograd.Function):
    """torch.matmul of x and y (both at least 2-D, batch dims
    broadcast) without TF32 or bf16 partial sums, whose backward also
    runs without them: autograd's own matmul backward reads the global
    flags when it runs, after the forward's context has closed.  Each
    gradient is summed over the batch dims its operand was broadcast
    along."""

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


def _product(x, y, amp=False):
    """torch.matmul of x and y in their promoted dtype; with `amp` (an
    f32 or bf16 x) both in bf16, accumulated in f32, the output bf16.
    Where the cuBLAS flags let the product round below that on the card
    (``_reduced``: TF32 for f32, bf16 partial sums for bf16), it goes
    through _Matmul (a 1-D operand a row or a column vector, dropped
    from the result, as torch.matmul treats it), whose forward and
    backward turn them off.  Otherwise torch.matmul runs as it is:
    PyTorch's default keeps f32 products in f32, and the custom
    Function's ~30 us of host time a product, forward and backward,
    stays off the eager path."""
    if amp and x.dtype in (torch.float32, torch.bfloat16):
        x, y = x.to(torch.bfloat16), y.to(torch.bfloat16)
    elif x.dtype != y.dtype:
        ct = torch.promote_types(x.dtype, y.dtype)
        x, y = x.to(ct), y.to(ct)
    if not (x.is_cuda and _reduced(x.dtype)):
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
    out = _product(x, y, attrs.get('__amp__', False))
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
    out = _product(x.reshape(-1, k), y.reshape(k, n),
                   attrs.get('__amp__', False))
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
# the remainder takes the divisor's sign, and the quotient rounds down,
# as jnp.mod and jnp.floor_divide (BeamSearchDecoder's beam and token
# of a flat top-k index)
_ew('elementwise_mod', torch.remainder)
_ew('elementwise_floordiv',
    lambda x, y: torch.div(x, y, rounding_mode='floor'))

# comparisons (the learning-rate schedules' and Variable's operators):
# a bool Out that carries no gradient
_ew('equal', torch.eq, ('Out',))
_ew('not_equal', torch.ne, ('Out',))
_ew('less_than', torch.lt, ('Out',))
_ew('less_equal', torch.le, ('Out',))
_ew('greater_than', torch.gt, ('Out',))
_ew('greater_equal', torch.ge, ('Out',))


def _logical(name, fn, unary=False):
    @register(name, no_grad_out_slots=('Out',))
    def op(ctx, ins, attrs, _fn=fn, _u=unary):
        if _u:
            return {'Out': [_fn(ins['X'][0])]}
        return {'Out': [_fn(ins['X'][0], ins['Y'][0])]}
    return op


# the control-flow conditions' (Switch, the decoders' stop tests)
_logical('logical_and', torch.logical_and)
_logical('logical_or', torch.logical_or)
_logical('logical_xor', torch.logical_xor)
_logical('logical_not', torch.logical_not, unary=True)


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


@register('arg_max', no_grad_out_slots=('Out',))
def arg_max(ctx, ins, attrs):
    """int64 index of the largest value along `axis` (the first of equal
    ones, as jnp.argmax)."""
    axis = attrs.get('axis', -1)
    out = torch.argmax(_x(ins), dim=axis)
    if attrs.get('keepdims', False):
        out = out.unsqueeze(axis)
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


# ---------------------------------------------------------------------------
# The rest of the JAX package's ops/math_ops.py: the other reductions, the
# finite checks, norms, arg_min, sorting and the linalg extras
# ---------------------------------------------------------------------------


def _reduce_dims(x, attrs):
    """The reduced dims of a reduce_* op: every dim with reduce_all, else
    `dim` (default [0]) taken mod x's rank; () reduces nothing, as
    jnp's empty axis tuple."""
    if attrs.get('reduce_all', False):
        return tuple(range(x.ndim))
    return tuple(a % x.ndim for a in attrs.get('dim', [0]))


def _reduce(name, fn, int_out=False):
    """Register reduce op `name`: fn(x, dims, keepdim) over the op's dims
    (``_reduce_dims``), the JAX package's ``_reduce`` (math_ops.py:259).
    A bool result (reduce_all / reduce_any) carries no gradient."""
    @register(name, no_grad_out_slots=('Out',) if int_out else ())
    def op(ctx, ins, attrs, _fn=fn):
        x = _x(ins)
        dims = _reduce_dims(x, attrs)
        keep = attrs.get('keep_dim', False)
        if not dims:
            return {'Out': [x.bool() if int_out else x]}
        return {'Out': [_fn(x, dims, keep)]}
    return op


def _all(x, dims, keep):
    out = x.bool()
    for d in sorted(dims, reverse=True):
        out = out.all(dim=d, keepdim=keep)
    return out


def _any(x, dims, keep):
    out = x.bool()
    for d in sorted(dims, reverse=True):
        out = out.any(dim=d, keepdim=keep)
    return out


def _prod(x, dims, keep):
    for d in sorted(dims, reverse=True):
        x = torch.prod(x, dim=d, keepdim=keep)
    return x


# amax / amin split the gradient evenly among equal maxima, as the
# gradient of jnp.max / jnp.min does
_reduce('reduce_mean', lambda x, d, k: torch.mean(x, dim=d, keepdim=k))
_reduce('reduce_max', lambda x, d, k: torch.amax(x, dim=d, keepdim=k))
_reduce('reduce_min', lambda x, d, k: torch.amin(x, dim=d, keepdim=k))
_reduce('reduce_prod', _prod)
_reduce('reduce_all', _all, int_out=True)
_reduce('reduce_any', _any, int_out=True)


@register('dot')
def dot(ctx, ins, attrs):
    """sum(X * Y) over the last axis, kept for 1-D inputs."""
    x, y = ins['X'][0], ins['Y'][0]
    return {'Out': [torch.sum(x * y, dim=-1, keepdim=x.ndim == 1)]}


def _flag(ctx, xs, test, combine, start):
    """One 0-d bool over every input: `combine` of `test` reduced over
    each, from `start` (the JAX package's isfinite / isinf / isnan,
    math_ops.py:139: a flag, not an elementwise mask)."""
    out = torch.full((), start, dtype=torch.bool,
                     device=xs[0].device if xs else ctx.device)
    for x in xs:
        out = combine(out, test(x))
    return out


@register('isfinite', no_grad_out_slots=('Out',))
def isfinite(ctx, ins, attrs):
    """Whether every element of every input is finite."""
    return {'Out': [_flag(ctx, ins['X'], lambda x: torch.isfinite(x).all(),
                          torch.logical_and, True)]}


@register('isinf', no_grad_out_slots=('Out',))
def isinf(ctx, ins, attrs):
    """Whether any element of any input is infinite."""
    return {'Out': [_flag(ctx, ins['X'], lambda x: torch.isinf(x).any(),
                          torch.logical_or, False)]}


@register('isnan', no_grad_out_slots=('Out',))
def isnan(ctx, ins, attrs):
    """Whether any element of any input is NaN."""
    return {'Out': [_flag(ctx, ins['X'], lambda x: torch.isnan(x).any(),
                          torch.logical_or, False)]}


@register('p_norm')
def p_norm(ctx, ins, attrs):
    """(sum |x|^p over `axis`)^(1/p), the JAX expression in its order."""
    x = _x(ins)
    p = attrs.get('porder', 2.0)
    out = torch.sum(torch.abs(x) ** p, dim=attrs.get('axis', -1),
                    keepdim=attrs.get('keepdim', False)) ** (1.0 / p)
    return {'Out': [out]}


@register('arg_min', no_grad_out_slots=('Out',))
def arg_min(ctx, ins, attrs):
    """int64 index of the smallest value along `axis` (the first of
    equal ones, as jnp.argmin)."""
    return {'Out': [torch.argmin(_x(ins), dim=attrs.get('axis', -1))]}


# the JAX package's top_k_v2 is its top_k: the k largest along the last
# axis (its axis / largest attrs are not read)
register('top_k_v2', no_grad_out_slots=('Indices',))(top_k)


@register('argsort', no_grad_out_slots=('Indices',))
def argsort(ctx, ins, attrs):
    """Out sorted along `axis` and its int64 Indices: a stable sort of X
    (of -X when descending, so equal values keep their order, as
    jnp.argsort of -X gives them)."""
    x = _x(ins)
    axis = attrs.get('axis', -1)
    key = -x if attrs.get('descending', False) else x
    idx = torch.sort(key, dim=axis, stable=True)[1]
    return {'Out': [torch.take_along_dim(x, idx, dim=axis)],
            'Indices': [idx]}


@register('norm')
def norm(ctx, ins, attrs):
    """X / n with n = sqrt(sum(x * x) over `axis` + epsilon), kept as
    Norm."""
    x = _x(ins)
    n = torch.sqrt(torch.sum(x * x, dim=attrs.get('axis', -1), keepdim=True)
                   + attrs.get('epsilon', 1e-10))
    return {'Out': [x / n], 'Norm': [n]}


# the _ex forms report a failed factorization in `info` instead of
# checking it on the host, which would stop a CUDA graph capture
@register('cholesky')
def cholesky(ctx, ins, attrs):
    """The lower Cholesky factor of each (symmetric) matrix."""
    return {'Out': [torch.linalg.cholesky_ex(_x(ins)).L]}


@register('inverse')
def inverse(ctx, ins, attrs):
    return {'Output': [torch.linalg.inv_ex(ins['Input'][0]).inverse]}
