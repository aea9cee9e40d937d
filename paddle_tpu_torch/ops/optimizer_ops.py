"""Optimizer update op lowerings.

Reference: paddle/fluid/operators/optimizers/{adam,lamb,adagrad}_op.*.
An update returns new tensors for ParamOut / Moment*Out, which the
executor writes back over the parameter and moment variables; the
fused multi-tensor ops (ops/kernels/fused_optimizer.py) and the sparse
embedding-row update (ops/kernels/embedding.py) update in place on the
GPU.
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


@register('lamb')
def lamb(ctx, ins, attrs):
    """LAMB (reference operators/optimizers/lamb_op.cc): the Adam
    direction plus decoupled weight decay, r, scaled per tensor by the
    trust ratio ||p|| / ||r|| (1 where either norm is 0)."""
    p = ins['Param'][0]
    g = ins['Grad'][0].float()
    m1 = ins['Moment1'][0]
    m2 = ins['Moment2'][0]
    b1p = ins['Beta1Pow'][0].reshape(())
    b2p = ins['Beta2Pow'][0].reshape(())
    b1 = attrs.get('beta1', 0.9)
    b2 = attrs.get('beta2', 0.999)
    eps = attrs.get('epsilon', 1e-6)
    wd = attrs.get('weight_decay', 0.01)
    lr = _lr(ins)
    m1_out = b1 * m1 + (1 - b1) * g
    m2_out = b2 * m2 + (1 - b2) * g * g
    mhat = m1_out / (1 - b1p * b1)
    vhat = m2_out / (1 - b2p * b2)
    r = mhat / (torch.sqrt(vhat) + eps) + wd * p.float()
    pn = torch.sqrt(torch.sum(p.float() ** 2))
    rn = torch.sqrt(torch.sum(r ** 2))
    trust = torch.where((pn > 0) & (rn > 0), pn / rn, torch.ones_like(pn))
    p_out = p - (lr * trust * r).to(p.dtype)
    return {'ParamOut': [p_out], 'Moment1Out': [m1_out],
            'Moment2Out': [m2_out],
            'Beta1PowOut': [(b1p * b1).reshape(ins['Beta1Pow'][0].shape)],
            'Beta2PowOut': [(b2p * b2).reshape(ins['Beta2Pow'][0].shape)]}


@register('adagrad')
def adagrad(ctx, ins, attrs):
    p = ins['Param'][0]
    g = ins['Grad'][0]
    mom = ins['Moment'][0]
    eps = attrs.get('epsilon', 1e-6)
    m_out = mom + g * g
    p_out = p - _lr(ins) * g / (torch.sqrt(m_out) + eps)
    return {'ParamOut': [p_out], 'MomentOut': [m_out]}


# The executor's run grouping lowers a contiguous run of same-hyper
# adam/adamw/lamb ops through one of these (every input slot carries the
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


@register('fused_lamb')
def fused_lamb(ctx, ins, attrs):
    from .kernels import fused_optimizer
    return fused_optimizer.apply('lamb', ctx, ins, attrs)


@register('fused_emb_update')
def fused_emb_update(ctx, ins, attrs):
    """Adagrad over the embedding rows a lookup touched: Param / Moment
    [V, D], Ids [...], Grad ids.shape + [D] (the lookup's output
    gradient; no [V, D] gradient is built), LearningRate.
    AdagradOptimizer emits it in place of lookup_table(_v2)_grad +
    adagrad (fluid/optimizer.py)."""
    from .kernels import embedding
    return embedding.apply_update(ctx, ins, attrs)
