"""Normalization, dropout and loss lowerings.

Reference: operators/{layer_norm,dropout,softmax_with_cross_entropy,
sigmoid_cross_entropy_with_logits}_op.*
"""

import numpy as np
import torch
import torch.nn.functional as F

from .registry import register


@register('layer_norm')
def layer_norm(ctx, ins, attrs):
    """Y normalized over the dims from begin_norm_axis on, with the
    per-row Mean and Variance side outputs; statistics in f32, Y in the
    input dtype (the JAX package's policy)."""
    x = ins['X'][0]
    eps = attrs.get('epsilon', 1e-5)
    begin = attrs.get('begin_norm_axis', 1)
    shape = tuple(x.shape)
    lead = int(np.prod(shape[:begin]))
    x2 = x.reshape(lead, -1).float()
    scale = ins['Scale'][0].reshape(-1).float() if ins.get('Scale') else None
    bias = ins['Bias'][0].reshape(-1).float() if ins.get('Bias') else None
    y = F.layer_norm(x2, (x2.shape[1],), scale, bias, eps)
    var, mean = torch.var_mean(x2, dim=1, correction=0)
    return {'Y': [y.to(x.dtype).reshape(shape)],
            'Mean': [mean], 'Variance': [var]}


@register('dropout', no_grad_out_slots=('Mask',))
def dropout(ctx, ins, attrs):
    """Reference operators/dropout_op.cc.  The keep mask draws from the
    context's generator, keyed on (program seed, op seed, step), so a
    replay of the op (its grad op) draws the same mask; it does not
    reproduce the JAX package's threefry bits."""
    x = ins['X'][0]
    p = attrs.get('dropout_prob', 0.5)
    impl = attrs.get('dropout_implementation', 'downgrade_in_infer')
    if attrs.get('is_test', False):
        out = x if impl == 'upscale_in_train' else x * (1.0 - p)
        return {'Out': [out], 'Mask': [torch.ones_like(x)]}
    if x.device.type == 'meta':
        return {'Out': [torch.empty_like(x)], 'Mask': [torch.empty_like(x)]}
    keep = torch.rand(x.shape, generator=ctx.rng(),
                      device=x.device) < (1.0 - p)
    mask = keep.to(x.dtype)
    if impl == 'upscale_in_train':
        out = torch.where(keep, x / max(1.0 - p, 1e-8), torch.zeros_like(x))
    else:
        out = x * mask
    return {'Out': [out], 'Mask': [mask]}


@register('softmax_with_cross_entropy')
def softmax_with_cross_entropy(ctx, ins, attrs):
    """Hard-label softmax cross entropy along `axis` (reference
    operators/softmax_with_cross_entropy_op.cc): Loss keeps the logits'
    rank with a size-1 class dim and is 0 where the label equals
    ignore_index; Softmax is the probabilities.  Computed in f32."""
    logits = ins['Logits'][0]
    label = ins['Label'][0]
    ax = attrs.get('axis', -1) % logits.ndim
    ignore_index = int(attrs.get('ignore_index', -100))
    if attrs.get('soft_label', False):
        raise NotImplementedError('soft_label softmax_with_cross_entropy is '
                                  'not ported yet')
    lab = label if label.ndim == logits.ndim else label.unsqueeze(ax)
    lf = logits.float()
    lse = torch.logsumexp(lf, dim=ax, keepdim=True)
    valid = lab != ignore_index
    lab_safe = torch.where(valid, lab, torch.zeros_like(lab)).long()
    picked = torch.gather(lf, ax, lab_safe) - lse
    loss = torch.where(valid, -picked, torch.zeros_like(picked))
    softmax = torch.exp(lf - lse)
    return {'Softmax': [softmax.to(logits.dtype)],
            'Loss': [loss.to(logits.dtype)]}


@register('sigmoid_cross_entropy_with_logits')
def sigmoid_cross_entropy_with_logits(ctx, ins, attrs):
    """The stable form max(x, 0) - x * label + log1p(exp(-|x|)), 0
    where the label equals ignore_index; with `normalize`, divided by
    the count of the other labels (at least 1)."""
    x = ins['X'][0]
    label = ins['Label'][0]
    ignore_index = attrs.get('ignore_index', -100)
    loss = (torch.maximum(x, torch.zeros_like(x)) - x * label +
            torch.log1p(torch.exp(-torch.abs(x))))
    mask = label != ignore_index
    loss = torch.where(mask, loss, torch.zeros_like(loss))
    if attrs.get('normalize', False):
        loss = loss / torch.clamp(torch.sum(mask.to(x.dtype)), min=1.0)
    return {'Out': [loss]}
