"""Convolution, pooling, normalization, dropout, loss and metric
lowerings.

Reference: operators/{conv_cudnn,pool,batch_norm,layer_norm,dropout,
softmax_with_cross_entropy,cross_entropy,label_smooth,
sigmoid_cross_entropy_with_logits}_op.*, operators/metrics/accuracy_op.*.
Convolutions go to cuDNN in full f32 (the JAX package's
FLAGS_conv_precision 'highest' default), as the JAX package left them
to XLA's conv_general_dilated.
"""

import contextlib

import numpy as np
import torch
import torch.nn.functional as F

from .registry import register


def _pair(v):
    if isinstance(v, (list, tuple)):
        return [int(a) for a in v]
    return [int(v), int(v)]


def _same_pads(size, k, stride, dilation=1):
    """XLA's 'SAME' split: ceil(size / stride) outputs, the padding
    they need, the odd element after."""
    out = -(-size // stride)
    total = max((out - 1) * stride + (k - 1) * dilation + 1 - size, 0)
    return (total // 2, total - total // 2)


def _explicit_pads(paddings):
    """[(top, bottom), (left, right)] of 2 or 4 paddings."""
    p = _pair(paddings)
    if len(p) == 2:
        return [(p[0], p[0]), (p[1], p[1])]
    if len(p) == 4:
        return [(p[0], p[1]), (p[2], p[3])]
    raise ValueError('bad paddings %s' % (paddings,))


def _pad_hw(x, pads, value=0.0):
    """x [N, C, H, W] padded by pads [(top, bottom), (left, right)]."""
    (t, b), (l, r) = pads
    if t == b == l == r == 0:
        return x
    return F.pad(x, (l, r, t, b), value=value)


@contextlib.contextmanager
def _f32_convs(x):
    """cuDNN without TF32 for an f32 convolution on the card, whatever
    torch.backends.cudnn.allow_tf32 says (it defaults to True); the
    flag is put back after."""
    if not (x.is_cuda and x.dtype == torch.float32):
        yield
        return
    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = prev


class _Conv2d(torch.autograd.Function):
    """F.conv2d on NCHW x and OIHW w, unpadded, whose backward also runs
    without TF32 (autograd's own convolution backward reads the global
    flag when it runs, after the forward's context has closed).  The
    weight gradient comes back contiguous, as the fused optimizer
    kernels take it."""

    @staticmethod
    def forward(ctx, x, w, stride, dilation, groups):
        ctx.save_for_backward(x, w)
        ctx.conf = (stride, dilation, groups)
        with _f32_convs(x):
            return F.conv2d(x, w, None, stride, 0, dilation, groups)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        stride, dilation, groups = ctx.conf
        with _f32_convs(x):
            gx, gw, _ = torch.ops.aten.convolution_backward(
                g, x, w, None, stride, [0, 0], dilation, False, [0, 0],
                groups, [ctx.needs_input_grad[0], ctx.needs_input_grad[1],
                         False])
        return (gx, None if gw is None else gw.contiguous(), None, None,
                None)


@register('conv2d')
def conv2d(ctx, ins, attrs):
    """Reference operators/conv_cudnn_op.cu: Input NCHW or NHWC, Filter
    always OIHW (the layer contract); groups, strides, dilations; 2 or
    4 explicit paddings or padding_algorithm SAME / VALID.  NHWC runs as
    an NCHW view in channels-last memory, so cuDNN takes its NHWC
    kernels and no copy is made."""
    x = ins['Input'][0]
    w = ins['Filter'][0]
    strides = _pair(attrs.get('strides', [1, 1]))
    dilations = _pair(attrs.get('dilations', [1, 1]))
    groups = int(attrs.get('groups', 1) or 1)
    nhwc = attrs.get('data_format', 'NCHW') not in ('NCHW', 'AnyLayout')
    xc = x.permute(0, 3, 1, 2) if nhwc else x
    algo = attrs.get('padding_algorithm', 'EXPLICIT')
    if algo == 'VALID':
        pads = [(0, 0), (0, 0)]
    elif algo == 'SAME':
        pads = [_same_pads(xc.shape[2 + i], w.shape[2 + i], strides[i],
                           dilations[i]) for i in range(2)]
    else:
        pads = _explicit_pads(attrs.get('paddings', [0, 0]))
    out = _Conv2d.apply(_pad_hw(xc, pads), w.to(x.dtype), strides,
                        dilations, groups)
    return {'Output': [out.permute(0, 2, 3, 1) if nhwc else out]}


@register('depthwise_conv2d')
def depthwise_conv2d(ctx, ins, attrs):
    return conv2d(ctx, ins, attrs)


def _max_pool_slices(x, k, s, pads):
    """Max pooling of NCHW x over non-overlapping windows as an
    elementwise maximum over the kh * kw strided slices of the
    -inf-padded input: the JAX package's rendering (ops/nn_ops.py
    _max_pool_slices), whose gradient splits the cotangent evenly at
    each pairwise tie, as torch.maximum's does."""
    h, w = x.shape[2], x.shape[3]
    oh = (h + pads[0][0] + pads[0][1] - k[0]) // s[0] + 1
    ow = (w + pads[1][0] + pads[1][1] - k[1]) // s[1] + 1
    xp = _pad_hw(x, pads, -float('inf'))
    out = None
    for i in range(k[0]):
        for j in range(k[1]):
            sl = xp[:, :, i:i + (oh - 1) * s[0] + 1:s[0],
                    j:j + (ow - 1) * s[1] + 1:s[1]]
            out = sl if out is None else torch.maximum(out, sl)
    return out


def _adaptive_max(x, oh, ow):
    """Window (i, j) spans rows [floor(i H / oh), ceil((i + 1) H / oh))
    and the same in W (reference operators/pool_op.h AdaptStart /
    AdaptEnd); a max over each, whose gradient splits at ties as the
    JAX package's jnp.max does."""
    h, w = x.shape[2], x.shape[3]
    rows = []
    for i in range(oh):
        hs, he = (i * h) // oh, -(-((i + 1) * h) // oh)
        cols = [torch.amax(x[:, :, hs:he, (j * w) // ow:
                             -(-((j + 1) * w) // ow)], dim=(2, 3))
                for j in range(ow)]
        rows.append(torch.stack(cols, dim=-1))
    return torch.stack(rows, dim=-2)


@register('pool2d')
def pool2d(ctx, ins, attrs):
    """Reference operators/pool_op.*: max or average; global_pooling
    (and adaptive with ksize [1, 1]) a reduction over H and W; adaptive
    over a general grid; explicit paddings or SAME; `exclusive` average
    divides by the window's unpadded count where explicit padding
    reaches in, else by kh * kw (SAME included, as in the JAX package).
    Max pooling over non-overlapping windows is the JAX package's
    slice-and-maximum chain (ties split the gradient); overlapping
    windows go to F.max_pool2d, whose gradient goes to the window's
    first maximum, as XLA's select_and_scatter does."""
    x = ins['X'][0]
    ptype = attrs.get('pooling_type', 'max')
    ksize = _pair(attrs.get('ksize', [2, 2]))
    strides = _pair(attrs.get('strides', [2, 2]))
    nhwc = attrs.get('data_format', 'NCHW') not in ('NCHW', 'AnyLayout')
    xc = x.permute(0, 3, 1, 2) if nhwc else x
    adaptive = attrs.get('adaptive', False)
    if attrs.get('global_pooling', False) or adaptive and ksize == [1, 1]:
        red = torch.amax if ptype == 'max' else torch.mean
        out = red(xc, dim=(2, 3), keepdim=True)
    elif adaptive:
        out = (_adaptive_max(xc, *ksize) if ptype == 'max' else
               F.adaptive_avg_pool2d(xc, ksize))
    else:
        same = attrs.get('padding_algorithm') == 'SAME'
        if same:
            pads = [_same_pads(xc.shape[2 + i], ksize[i], strides[i])
                    for i in range(2)]
        else:
            pads = _explicit_pads(attrs.get('paddings', [0, 0]))
        if ptype == 'max':
            if all(s >= k for s, k in zip(strides, ksize)):
                out = _max_pool_slices(xc, ksize, strides, pads)
            elif all(p[0] == p[1] and 2 * p[0] <= k
                     for p, k in zip(pads, ksize)):
                out = F.max_pool2d(xc, ksize, strides,
                                   [p[0] for p in pads])
            else:
                out = F.max_pool2d(_pad_hw(xc, pads, -float('inf')),
                                   ksize, strides)
        else:
            s = F.avg_pool2d(_pad_hw(xc, pads), ksize, strides,
                             divisor_override=1)
            if attrs.get('exclusive', True) and not same and \
                    any(p != (0, 0) for p in pads):
                ones = torch.ones_like(xc[:1, :1])
                cnt = F.avg_pool2d(_pad_hw(ones, pads), ksize, strides,
                                   divisor_override=1)
                out = s / cnt
            else:
                out = s / float(ksize[0] * ksize[1])
    return {'Out': [out.permute(0, 2, 3, 1) if nhwc else out]}


@register('batch_norm', no_grad_out_slots=('MeanOut', 'VarianceOut',
                                           'SavedMean', 'SavedVariance'))
def batch_norm(ctx, ins, attrs):
    """Reference operators/batch_norm_op.cc, as the JAX package computes
    it.  MeanOut / VarianceOut are the program's Mean / Variance
    variables (written in place): momentum * running + (1 - momentum) *
    batch, the variance unbiased by n / (n - 1).  SavedVariance is
    rsqrt(var + epsilon).  With is_test or use_global_stats the running
    statistics normalize and stay as they are.  Statistics in f32 (f64
    inputs stay in f64): the batch's second moment is taken about the
    first batch element's per-channel mean (a shift with no gradient),
    so |mean| >> std does not cancel; half-precision inputs take the
    raw sums."""
    x = ins['X'][0]
    scale, bias = ins['Scale'][0], ins['Bias'][0]
    mean, var = ins['Mean'][0], ins['Variance'][0]
    eps = attrs.get('epsilon', 1e-5)
    momentum = attrs.get('momentum', 0.9)
    use_global = attrs.get('use_global_stats', False) or \
        attrs.get('is_test', False)
    layout = attrs.get('data_layout', 'NCHW')
    caxis = 1 if layout in ('NCHW', 'AnyLayout') else x.ndim - 1
    red = tuple(i for i in range(x.ndim) if i != caxis)
    bshape = tuple(x.shape[caxis] if i == caxis else 1
                   for i in range(x.ndim))
    xf = x if x.dtype == torch.float64 else x.float()
    cnt = float(np.prod([x.shape[i] for i in red]))
    if use_global:
        m, v = mean, var
    elif x.dtype in (torch.bfloat16, torch.float16):
        m = torch.sum(xf, dim=red) / cnt
        v = torch.clamp(torch.sum(xf * xf, dim=red) / cnt - m * m, min=0.0)
    else:
        shift = torch.mean(xf.narrow(red[0], 0, 1), dim=red).detach()
        xs = xf - shift.reshape(bshape)
        d = torch.sum(xs, dim=red) / cnt
        m = shift + d
        v = torch.clamp(torch.sum(xs * xs, dim=red) / cnt - d * d, min=0.0)
    inv = torch.rsqrt(v.to(xf.dtype) + eps)
    y = (xf - m.reshape(bshape)) * inv.reshape(bshape)
    y = y * scale.reshape(bshape) + bias.reshape(bshape)
    if use_global:
        mean_out, var_out, saved_m = mean, var, mean
    else:
        unbiased = v * (cnt / max(cnt - 1.0, 1.0))
        mean_out = momentum * mean + (1.0 - momentum) * m
        var_out = momentum * var + (1.0 - momentum) * unbiased
        saved_m = m
    return {'Y': [y.to(x.dtype)], 'MeanOut': [mean_out],
            'VarianceOut': [var_out], 'SavedMean': [saved_m],
            'SavedVariance': [inv]}


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
    """Softmax cross entropy along `axis` (reference
    operators/softmax_with_cross_entropy_op.cc): Loss keeps the logits'
    rank with a size-1 class dim; Softmax is the probabilities.  A hard
    Label picks one class a row (Loss 0 where it equals ignore_index),
    computed in f32 (f64 logits in f64).  A soft Label (soft_label)
    weights every class: Loss = -sum(Label * log_softmax(logits)) with
    the log-softmax in f32 and Softmax = exp of it, as the JAX package
    computes it."""
    logits = ins['Logits'][0]
    label = ins['Label'][0]
    ax = attrs.get('axis', -1) % logits.ndim
    ignore_index = int(attrs.get('ignore_index', -100))
    if attrs.get('soft_label', False):
        logp = F.log_softmax(logits.float(), dim=ax)
        loss = -torch.sum(label * logp, dim=ax, keepdim=True)
        return {'Softmax': [torch.exp(logp).to(logits.dtype)],
                'Loss': [loss.to(logits.dtype)]}
    lab = label if label.ndim == logits.ndim else label.unsqueeze(ax)
    lf = logits if logits.dtype == torch.float64 else logits.float()
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


@register('label_smooth')
def label_smooth(ctx, ins, attrs):
    """Reference operators/label_smooth_op.cc: (1 - eps) * X plus eps
    spread evenly over the last axis' classes, or eps * PriorDist."""
    x = ins['X'][0]
    eps = attrs.get('epsilon', 0.1)
    if ins.get('PriorDist'):
        return {'Out': [(1 - eps) * x + eps * ins['PriorDist'][0]]}
    return {'Out': [(1 - eps) * x + eps / x.shape[-1]]}


@register('cross_entropy')
def cross_entropy(ctx, ins, attrs):
    """Reference operators/cross_entropy_op.cc: X holds probabilities
    (clipped at 1e-20 before the log); a hard Label [N, 1] or [N] picks
    one per row, 0 where it equals ignore_index; a soft label weights
    every class.  Y is [N, 1]."""
    x = ins['X'][0]
    label = ins['Label'][0]
    logx = torch.log(torch.clamp(x, min=1e-20))
    if attrs.get('soft_label', False):
        return {'Y': [-torch.sum(label * logx, dim=-1, keepdim=True)]}
    ignore_index = int(attrs.get('ignore_index', -100))
    lab = label
    if lab.ndim == x.ndim and lab.shape[-1] == 1:
        lab = lab.squeeze(-1)
    lab = lab.unsqueeze(-1)
    ignored = lab == ignore_index
    picked = torch.gather(logx, -1,
                          torch.where(ignored, torch.zeros_like(lab),
                                      lab).long())
    return {'Y': [torch.where(ignored, torch.zeros_like(picked), -picked)]}


@register('cross_entropy2', no_grad_out_slots=('XShape', 'MatchX'))
def cross_entropy2(ctx, ins, attrs):
    y = cross_entropy(ctx, ins, attrs)['Y'][0]
    return {'Y': [y], 'MatchX': [y], 'XShape': [y]}


@register('accuracy', no_grad_out_slots=('Accuracy', 'Correct', 'Total'))
def accuracy(ctx, ins, attrs):
    """Reference operators/metrics/accuracy_op.cc: the share of rows
    whose label is among the top-k Indices [N, k].  Accuracy f32,
    Correct and Total int32, all 0-d."""
    idx = ins['Indices'][0]
    label = ins['Label'][0]
    if label.ndim == 1:
        label = label[:, None]
    correct = torch.sum(torch.any(idx == label, dim=1).float())
    total = idx.shape[0]
    return {'Accuracy': [correct / total],
            'Correct': [correct.to(torch.int32)],
            'Total': [torch.tensor(total, dtype=torch.int32,
                                   device=idx.device)]}
