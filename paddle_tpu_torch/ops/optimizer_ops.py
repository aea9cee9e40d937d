"""Optimizer update op lowerings.

Reference: paddle/fluid/operators/optimizers/{sgd,momentum,adam,lamb,
adagrad,lars_momentum,adamax,adadelta,rmsprop,ftrl,dpsgd,proximal_gd}_op.*,
operators/dgc_op.h.
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


@register('sgd')
def sgd(ctx, ins, attrs):
    p = ins['Param'][0]
    g = ins['Grad'][0]
    return {'ParamOut': [p - _lr(ins) * g.to(p.dtype)]}


@register('momentum')
def momentum(ctx, ins, attrs):
    """v = mu * v + g; p - lr * v, or with use_nesterov
    p - (g + mu * v) * lr."""
    p = ins['Param'][0]
    g = ins['Grad'][0]
    v = ins['Velocity'][0]
    mu = attrs.get('mu', 0.9)
    lr = _lr(ins)
    v_out = mu * v + g
    if attrs.get('use_nesterov', False):
        p_out = p - (g + mu * v_out) * lr
    else:
        p_out = p - lr * v_out
    return {'ParamOut': [p_out], 'VelocityOut': [v_out]}


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


@register('lars_momentum')
def lars_momentum(ctx, ins, attrs):
    """LARS: momentum with the layer-wise rate
    lr * coeff * ||p|| / (||g|| + decay * ||p|| + eps) (lr where
    ||p|| is 0), weight decay added to the gradient."""
    p = ins['Param'][0]
    g = ins['Grad'][0]
    v = ins['Velocity'][0]
    mu = attrs.get('mu', 0.9)
    coeff = attrs.get('lars_coeff', 0.001)
    decay = attrs.get('lars_weight_decay', 0.0005)
    eps = attrs.get('epsilon', 0.0)
    lr = _lr(ins)
    pn = torch.sqrt(torch.sum(p.float() ** 2))
    gn = torch.sqrt(torch.sum(g.float() ** 2))
    local_lr = torch.where(pn > 0, lr * coeff * pn /
                           (gn + decay * pn + eps), lr)
    v_out = mu * v + local_lr * (g + decay * p)
    return {'ParamOut': [p - v_out], 'VelocityOut': [v_out]}


@register('adamax')
def adamax(ctx, ins, attrs):
    p = ins['Param'][0]
    g = ins['Grad'][0]
    m = ins['Moment'][0]
    b1p = ins['Beta1Pow'][0].reshape(())
    b1 = attrs.get('beta1', 0.9)
    b2 = attrs.get('beta2', 0.999)
    eps = attrs.get('epsilon', 1e-8)
    m_out = b1 * m + (1 - b1) * g
    n_out = torch.maximum(b2 * ins['InfNorm'][0], torch.abs(g) + eps)
    lr_t = _lr(ins) / (1 - b1p)
    return {'ParamOut': [p - lr_t * m_out / n_out], 'MomentOut': [m_out],
            'InfNormOut': [n_out]}


@register('adadelta')
def adadelta(ctx, ins, attrs):
    p = ins['Param'][0]
    g = ins['Grad'][0]
    avg_sq_u = ins['AvgSquaredUpdate'][0]
    rho = attrs.get('rho', 0.95)
    eps = attrs.get('epsilon', 1e-6)
    g2 = rho * ins['AvgSquaredGrad'][0] + (1 - rho) * g * g
    upd = -torch.sqrt((avg_sq_u + eps) / (g2 + eps)) * g
    u2 = rho * avg_sq_u + (1 - rho) * upd * upd
    return {'ParamOut': [p + upd], 'AvgSquaredGradOut': [g2],
            'AvgSquaredUpdateOut': [u2]}


@register('rmsprop')
def rmsprop(ctx, ins, attrs):
    """ms = rho * ms + (1 - rho) * g^2; mom = mu * mom + lr * g /
    sqrt(ms + eps) (centered: sqrt(ms - mg^2 + eps) with the mean
    gradient mg, written only then); p - mom."""
    p = ins['Param'][0]
    g = ins['Grad'][0]
    rho = attrs.get('decay', 0.95)
    eps = attrs.get('epsilon', 1e-6)
    mu = attrs.get('momentum', 0.0)
    lr = _lr(ins)
    ms_out = rho * ins['MeanSquare'][0] + (1 - rho) * g * g
    mom = ins['Moment'][0]
    if attrs.get('centered', False):
        mg_out = rho * ins['MeanGrad'][0] + (1 - rho) * g
        mom_out = mu * mom + lr * g / torch.sqrt(ms_out - mg_out * mg_out
                                                 + eps)
        return {'ParamOut': [p - mom_out], 'MomentOut': [mom_out],
                'MeanSquareOut': [ms_out], 'MeanGradOut': [mg_out]}
    mom_out = mu * mom + lr * g / torch.sqrt(ms_out + eps)
    return {'ParamOut': [p - mom_out], 'MomentOut': [mom_out],
            'MeanSquareOut': [ms_out]}


@register('ftrl')
def ftrl(ctx, ins, attrs):
    p = ins['Param'][0]
    g = ins['Grad'][0]
    sq = ins['SquaredAccumulator'][0]
    l1 = attrs.get('l1', 0.0)
    l2 = attrs.get('l2', 0.0)
    lr_power = attrs.get('lr_power', -0.5)
    lr = _lr(ins)
    new_sq = sq + g * g
    if lr_power == -0.5:
        sigma = (torch.sqrt(new_sq) - torch.sqrt(sq)) / lr
    else:
        sigma = (new_sq ** -lr_power - sq ** -lr_power) / lr
    lin_out = ins['LinearAccumulator'][0] + g - sigma * p
    if lr_power == -0.5:
        denom = torch.sqrt(new_sq) / lr + 2 * l2
    else:
        denom = new_sq ** -lr_power / lr + 2 * l2
    # jnp.clip(lin, -l1, l1): a maximum, then a minimum
    pre = torch.minimum(torch.maximum(lin_out, torch.full_like(lin_out, -l1)),
                        torch.full_like(lin_out, l1)) - lin_out
    return {'ParamOut': [pre / denom], 'SquaredAccumOut': [new_sq],
            'LinearAccumOut': [lin_out]}


@register('dpsgd')
def dpsgd(ctx, ins, attrs):
    """Differentially private SGD: the gradient scaled to norm at most
    `clip`, plus sigma * clip * normal noise.  The noise is drawn from
    the counter hash (tensor_ops.normal_draws under
    LowerCtx.sample_seed), not jax threefry."""
    from .tensor_ops import normal_draws
    p = ins['Param'][0]
    g = ins['Grad'][0]
    clip = attrs.get('clip', 10.0)
    sigma = attrs.get('sigma', 1.0)
    gn = torch.sqrt(torch.sum(g * g))
    g = g / torch.clamp(gn / clip, min=1.0)
    noise = sigma * clip * normal_draws(ctx, attrs, tuple(g.shape),
                                        g.device, 0xD95).to(g.dtype)
    return {'ParamOut': [p - _lr(ins) * (g + noise)]}


@register('proximal_gd')
def proximal_gd(ctx, ins, attrs):
    p = ins['Param'][0]
    g = ins['Grad'][0]
    l1 = attrs.get('l1', 0.0)
    l2 = attrs.get('l2', 0.0)
    lr = _lr(ins)
    prox = p - lr * g
    if l1 > 0:
        p_out = (torch.sign(prox) *
                 torch.clamp(torch.abs(prox) - lr * l1, min=0.0) /
                 (1.0 + lr * l2))
    else:
        p_out = prox / (1.0 + lr * l2)
    return {'ParamOut': [p_out]}


@register('dgc')
def dgc(ctx, ins, attrs):
    """Deep Gradient Compression (reference operators/dgc_op.h): u = m *
    u + g; v = v + u; the entries with |v| at least the k-th largest
    |v| (k = max(1, n * (1 - sparsity_ratio))) are sent (EncodeGrad,
    GradOut) and cleared from u and v, the rest kept locally.  The
    threshold is the same value whichever sort finds it, so the result
    is exact."""
    g = ins['Grad'][0]
    m = attrs.get('m', 0.9)
    n = g.numel()
    k = max(1, int(n * (1.0 - attrs.get('sparsity_ratio', 0.999))))
    u_new = m * ins['U'][0] + g
    v_new = ins['V'][0] + u_new
    thr = torch.topk(torch.abs(v_new.reshape(-1)), k)[0][-1]
    mask = (torch.abs(v_new) >= thr).to(g.dtype)
    encoded = v_new * mask
    return {'EncodeGrad': [encoded], 'UOut': [u_new * (1 - mask)],
            'VOut': [v_new * (1 - mask)], 'GradOut': [encoded]}


@register('decayed_adagrad')
def decayed_adagrad(ctx, ins, attrs):
    """moment = decay * moment + (1 - decay) * g^2; p - lr * g /
    (sqrt(moment) + eps)."""
    p = ins['Param'][0]
    g = ins['Grad'][0]
    decay = attrs.get('decay', 0.95)
    eps = attrs.get('epsilon', 1e-6)
    m_out = decay * ins['Moment'][0] + (1.0 - decay) * g * g
    return {'ParamOut': [p - _lr(ins) * g / (torch.sqrt(m_out) + eps)],
            'MomentOut': [m_out]}


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
