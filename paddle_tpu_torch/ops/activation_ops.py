"""Activation and other unary op lowerings: the BERT, CTR and image
models', the learning-rate schedules' and the regularizers'.
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
_unary('sqrt', torch.sqrt)
_unary('floor', torch.floor)
_unary('cos', torch.cos)
_unary('exp', torch.exp)
_unary('reciprocal', lambda x: 1.0 / x)
_unary('sign', torch.sign)


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
