"""Activation and other unary op lowerings: every type of the JAX
package's ops/activation_ops.py.  Each is the JAX expression in its
order of operations (a clamp is a maximum then a minimum, as jnp.clip,
so a value on a breakpoint rounds and splits its gradient alike).
Reference: operators/activation_op.cc|.cu|.h."""

import torch
import torch.nn.functional as F

from .registry import register


def _unary(name, fn):
    @register(name)
    def op(ctx, ins, attrs, _fn=fn):
        return {'Out': [_fn(ins['X'][0])]}
    return op


# the JAX package's choices (ops/activation_ops.py): relu's gradient is
# 0 at 0, reciprocal is 1 / x
_unary('relu', torch.relu)
_unary('sigmoid', torch.sigmoid)
_unary('tanh', torch.tanh)
_unary('log', torch.log)
_unary('sqrt', torch.sqrt)
_unary('floor', torch.floor)
_unary('cos', torch.cos)
_unary('exp', torch.exp)
_unary('reciprocal', lambda x: 1.0 / x)
_unary('sign', torch.sign)
_unary('rsqrt', torch.rsqrt)


class _Abs(torch.autograd.Function):
    """|x| whose gradient at 0 is the incoming one (jnp.abs's: x >= 0
    takes the positive branch); torch.abs's is 0 there."""

    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return torch.abs(x)

    @staticmethod
    def backward(ctx, g):
        x, = ctx.saved_tensors
        return torch.where(x >= 0, g, -g)


_unary('abs', _Abs.apply)
_unary('ceil', torch.ceil)
# half to even, as jnp.round
_unary('round', torch.round)
_unary('sin', torch.sin)
_unary('tan', torch.tan)
_unary('acos', torch.acos)
_unary('asin', torch.asin)
_unary('atan', torch.atan)
_unary('sinh', torch.sinh)
_unary('cosh', torch.cosh)
_unary('log2', torch.log2)
_unary('log10', torch.log10)
_unary('log1p', torch.log1p)
_unary('square', torch.square)
_unary('erf', torch.erf)


def _softplus(x):
    """jax.nn.softplus: logaddexp(x, 0), with no threshold."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype,
                                          device=x.device))


_unary('softplus', _softplus)
_unary('softsign', lambda x: x / (torch.abs(x) + 1))
_unary('silu', lambda x: x * torch.sigmoid(x))
_unary('logsigmoid', lambda x: -_softplus(-x))
_unary('tanh_shrink', lambda x: x - torch.tanh(x))


def _clip(x, lo, hi):
    """jnp.clip(x, lo, hi): maximum with lo, then minimum with hi."""
    return torch.minimum(
        torch.maximum(x, torch.full((), lo, dtype=x.dtype, device=x.device)),
        torch.full((), hi, dtype=x.dtype, device=x.device))


def _zeros(x):
    return torch.zeros((), dtype=x.dtype, device=x.device)


@register('leaky_relu')
def leaky_relu(ctx, ins, attrs):
    x = ins['X'][0]
    return {'Out': [torch.where(x > 0, x, attrs.get('alpha', 0.02) * x)]}


@register('elu')
def elu(ctx, ins, attrs):
    """jax.nn.elu: x where positive, else alpha * expm1(x), its expm1
    taken at 0 where x is positive (no overflow in the dead branch)."""
    x = ins['X'][0]
    pos = x > 0
    safe = torch.where(pos, _zeros(x), x)
    return {'Out': [torch.where(pos, x, attrs.get('alpha', 1.0) *
                                torch.expm1(safe))]}


@register('relu6')
def relu6(ctx, ins, attrs):
    return {'Out': [_clip(ins['X'][0], 0.0, attrs.get('threshold', 6.0))]}


@register('hard_sigmoid')
def hard_sigmoid(ctx, ins, attrs):
    """clip(slope * x + offset, 0, 1)."""
    x = ins['X'][0]
    return {'Out': [_clip(attrs.get('slope', 0.2) * x +
                          attrs.get('offset', 0.5), 0.0, 1.0)]}


@register('hard_swish')
def hard_swish(ctx, ins, attrs):
    """x * clip(x + offset, 0, threshold) / scale, left to right."""
    x = ins['X'][0]
    t = attrs.get('threshold', 6.0)
    return {'Out': [x * _clip(x + attrs.get('offset', 3.0), 0.0, t) /
                    attrs.get('scale', 6.0)]}


@register('swish')
def swish(ctx, ins, attrs):
    x = ins['X'][0]
    return {'Out': [x * torch.sigmoid(attrs.get('beta', 1.0) * x)]}


@register('mish')
def mish(ctx, ins, attrs):
    x = ins['X'][0]
    return {'Out': [x * torch.tanh(_softplus(x))]}


@register('thresholded_relu')
def thresholded_relu(ctx, ins, attrs):
    x = ins['X'][0]
    return {'Out': [torch.where(x > attrs.get('threshold', 1.0), x,
                                _zeros(x))]}


@register('hard_shrink')
def hard_shrink(ctx, ins, attrs):
    x = ins['X'][0]
    return {'Out': [torch.where(torch.abs(x) > attrs.get('threshold', 0.5),
                                x, _zeros(x))]}


@register('soft_shrink')
def soft_shrink(ctx, ins, attrs):
    x = ins['X'][0]
    lam = attrs.get('lambda', 0.5)
    return {'Out': [torch.where(x > lam, x - lam,
                                torch.where(x < -lam, x + lam, _zeros(x)))]}


# the reference's REGISTER_OPERATOR name (operators/activation_op.cc)
register('softshrink')(soft_shrink)


@register('prelu')
def prelu(ctx, ins, attrs):
    """x where positive, else Alpha * x; mode 'channel' puts Alpha on
    axis 1, 'all' and 'element' broadcast it as it is."""
    x = ins['X'][0]
    alpha = ins['Alpha'][0]
    if attrs.get('mode', 'all') == 'channel':
        alpha = alpha.reshape((1, -1) + (1,) * (x.ndim - 2))
    return {'Out': [torch.where(x > 0, x, alpha * x)]}


@register('maxout')
def maxout(ctx, ins, attrs):
    """NCHW: the largest of each `groups` consecutive channels (amax,
    whose gradient splits among equal maxima as jnp.max's does)."""
    x = ins['X'][0]
    g = attrs['groups']
    n, c, h, w = x.shape
    return {'Out': [torch.amax(x.reshape(n, c // g, g, h, w), dim=2)]}


@register('selu')
def selu(ctx, ins, attrs):
    x = ins['X'][0]
    scale = attrs.get('scale', 1.0507009873554805)
    alpha = attrs.get('alpha', 1.6732632423543772)
    return {'Out': [scale * torch.where(x > 0, x, alpha * torch.expm1(x))]}


@register('stanh')
def stanh(ctx, ins, attrs):
    return {'Out': [attrs.get('scale_b', 1.7159) *
                    torch.tanh(attrs.get('scale_a', 0.67) * ins['X'][0])]}


@register('brelu')
def brelu(ctx, ins, attrs):
    return {'Out': [_clip(ins['X'][0], attrs.get('t_min', 0.0),
                          attrs.get('t_max', 24.0))]}


@register('gelu')
def gelu(ctx, ins, attrs):
    # the exact erf form unless the op asks for the tanh approximation,
    # as the JAX package defaults (approximate=False)
    approximate = 'tanh' if attrs.get('approximate', False) else 'none'
    return {'Out': [F.gelu(ins['X'][0], approximate=approximate)]}


@register('pow')
def pow_op(ctx, ins, attrs):
    return {'Out': [torch.pow(ins['X'][0], attrs.get('factor', 1.0))]}


@register('softmax')
def softmax(ctx, ins, attrs):
    """Statistics in f32 (f64 stays f64), the output in the input
    dtype, as the JAX package computes it."""
    x = ins['X'][0]
    xf = x if x.dtype == torch.float64 else x.float()
    return {'Out': [F.softmax(xf, dim=attrs.get('axis', -1)).to(x.dtype)]}


@register('log_softmax')
def log_softmax(ctx, ins, attrs):
    """In the input's dtype, as jax.nn.log_softmax computes it."""
    return {'Out': [F.log_softmax(ins['X'][0], dim=attrs.get('axis', -1))]}
