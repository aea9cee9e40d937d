"""Optimizer update op lowerings.

Reference: paddle/fluid/operators/optimizers/adam_op.*.  An update
returns new tensors for ParamOut / Moment*Out, which the executor
writes back over the parameter and moment variables; the fused
multi-tensor ops (ops/kernels/fused_optimizer.py) update in place.
The expressions keep the JAX package's order (ops/optimizer_ops.py),
so every operation rounds alike.
"""

import torch

from .registry import register


def _lr(ins):
    return ins['LearningRate'][0].reshape(())


@register('adam')
def adam(ctx, ins, attrs):
    p = ins['Param'][0]
    g = ins['Grad'][0].float()
    m1 = ins['Moment1'][0]
    m2 = ins['Moment2'][0]
    b1p = ins['Beta1Pow'][0].reshape(())
    b2p = ins['Beta2Pow'][0].reshape(())
    b1 = attrs.get('beta1', 0.9)
    b2 = attrs.get('beta2', 0.999)
    eps = attrs.get('epsilon', 1e-8)
    lr = _lr(ins)
    m1_out = b1 * m1 + (1 - b1) * g
    m2_out = b2 * m2 + (1 - b2) * g * g
    lr_t = lr * torch.sqrt(1 - b2p * b2) / (1 - b1p * b1)
    p_out = p - (lr_t * m1_out / (torch.sqrt(m2_out) + eps)).to(p.dtype)
    return {'ParamOut': [p_out], 'Moment1Out': [m1_out],
            'Moment2Out': [m2_out],
            'Beta1PowOut': [(b1p * b1).reshape(ins['Beta1Pow'][0].shape)],
            'Beta2PowOut': [(b2p * b2).reshape(ins['Beta2Pow'][0].shape)]}


@register('adamw')
def adamw(ctx, ins, attrs):
    coeff = attrs.get('coeff', 0.01)
    out = adam(ctx, ins, attrs)
    p = ins['Param'][0]
    out['ParamOut'] = [out['ParamOut'][0] - _lr(ins) * coeff * p]
    return out


# The executor's run grouping lowers a contiguous run of same-hyper
# adam/adamw ops through one of these (every input slot carries the
# whole run's tensors, aligned by index): the multi-tensor kernel on
# CUDA tensors, the per-tensor lowerings above on the CPU.

@register('fused_adam')
def fused_adam(ctx, ins, attrs):
    from .kernels import fused_optimizer
    return fused_optimizer.apply('adam', ctx, ins, attrs)


@register('fused_adamw')
def fused_adamw(ctx, ins, attrs):
    from .kernels import fused_optimizer
    return fused_optimizer.apply('adamw', ctx, ins, attrs)
