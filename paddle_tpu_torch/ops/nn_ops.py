"""Convolution, pooling, normalization, dropout, loss, metric,
resizing and sampling lowerings: the JAX package's ops/nn_ops.py.

Reference: operators/{conv_cudnn,conv_transpose,pool,pool_with_index,
unpool,batch_norm,layer_norm,instance_norm,group_norm,lrn,dropout,
softmax_with_cross_entropy,cross_entropy,label_smooth,
sigmoid_cross_entropy_with_logits,huber_loss,smooth_l1_loss,log_loss,
kldiv_loss,interpolate,grid_sampler,temporal_shift,conv_shift}_op.*,
operators/metrics/{accuracy,auc}_op.*.
Convolutions go to cuDNN in full f32 (the JAX package's
FLAGS_conv_precision 'highest' default), as the JAX package left them
to XLA's conv_general_dilated; under AMP (the ``__amp__`` mark) in bf16,
input and output.  Normalizations keep their statistics in f32 and give
their output in the input dtype; softmax_with_cross_entropy under the
AMP black rule gives an f32 Loss.
"""

import contextlib

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

from ..distributed import wire
from .kernels import dropout as dropout_k
from .registry import device_constant, register


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


class _Conv(torch.autograd.Function):
    """F.conv2d / F.conv3d on NC(D)HW x and OI(D)HW w with symmetric
    `padding` a spatial dim (with `transposed`, the transposed
    convolution of a [in_c, out_c / groups, *k] w, unpadded), whose
    backward also runs without TF32 (autograd's own convolution
    backward reads the global flag when it runs, after the forward's
    context has closed).  The weight gradient comes back contiguous, as
    the fused optimizer kernels take it."""

    @staticmethod
    def forward(ctx, x, w, stride, dilation, groups, transposed=False,
                padding=None):
        nd = w.dim() - 2
        padding = list(padding or [0] * nd)
        ctx.save_for_backward(x, w)
        ctx.conf = (stride, dilation, groups, transposed, padding)
        with _f32_convs(x):
            if transposed:
                fn = F.conv_transpose2d if nd == 2 else F.conv_transpose3d
                return fn(x, w, None, stride, 0, 0, groups, dilation)
            fn = F.conv2d if nd == 2 else F.conv3d
            return fn(x, w, None, stride, padding, dilation, groups)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        stride, dilation, groups, transposed, padding = ctx.conf
        with _f32_convs(x):
            gx, gw, _ = torch.ops.aten.convolution_backward(
                g, x, w, None, stride, padding, dilation, transposed,
                [0] * len(padding), groups, [ctx.needs_input_grad[0],
                                             ctx.needs_input_grad[1], False])
        return (gx, None if gw is None else gw.contiguous(), None, None,
                None, None, None)


@register('conv2d')
def conv2d(ctx, ins, attrs):
    """Reference operators/conv_cudnn_op.cu: Input NCHW or NHWC, Filter
    always OIHW (the layer contract); groups, strides, dilations; 2 or
    4 explicit paddings or padding_algorithm SAME / VALID.  NHWC runs as
    an NCHW view in channels-last memory, so cuDNN takes its NHWC
    kernels and no copy is made.  Under ``__amp__`` an f32 or bf16 input
    and the filter run in bf16 and the output is bf16 (cuDNN
    accumulates in f32), the JAX package's AMP convolution
    (nn_ops.py:73-90); otherwise the filter takes the input's dtype."""
    x = ins['Input'][0]
    w = ins['Filter'][0]
    if attrs.get('__amp__') and x.dtype in (torch.float32, torch.bfloat16):
        x = x.to(torch.bfloat16)
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
    out = _Conv.apply(_pad_hw(xc, pads), w.to(x.dtype), strides,
                        dilations, groups)
    return {'Output': [out.permute(0, 2, 3, 1) if nhwc else out]}


@register('depthwise_conv2d')
def depthwise_conv2d(ctx, ins, attrs):
    return conv2d(ctx, ins, attrs)


def _conv_transpose(x, w, strides, dilations, groups, pads):
    """The transposed convolution of NC(D)HW x by w [in_c, out_c /
    groups, *k] (the gradient of the convolution with respect to its
    input), its full output cropped by pads [(before, after)] a spatial
    dim: the JAX package's lhs-dilated convolution by the flipped
    kernel, padded by k_eff - 1 - pad on each side.  No output padding
    (the JAX op ignores output_size)."""
    out = _Conv.apply(x, w.to(x.dtype), strides, dilations, groups, True)
    return out[(slice(None), slice(None)) + tuple(
        slice(a, out.shape[2 + i] - b) for i, (a, b) in enumerate(pads))]


@register('conv2d_transpose')
def conv2d_transpose(ctx, ins, attrs):
    """Reference operators/conv_transpose_op.cc, as the JAX package
    computes it (ops/nn_ops.py:99-135): strides, dilations, groups, 2
    symmetric or 4 asymmetric paddings (cropped after a transposed
    convolution, which takes symmetric padding only)."""
    return {'Output': [_conv_transpose(
        ins['Input'][0], ins['Filter'][0],
        _pair(attrs.get('strides', [1, 1])),
        _pair(attrs.get('dilations', [1, 1])),
        int(attrs.get('groups', 1) or 1),
        _explicit_pads(attrs.get('paddings', [0, 0])))]}


@register('depthwise_conv2d_transpose')
def depthwise_conv2d_transpose(ctx, ins, attrs):
    """A transposed convolution of one group a channel (Filter [in_c, 1,
    kh, kw]); the JAX lowering (:957) pads by the first two paddings
    symmetrically."""
    x = ins['Input'][0]
    p = _pair(attrs.get('paddings', [0, 0]))
    groups = int(attrs.get('groups', x.shape[1]) or x.shape[1])
    return {'Output': [_conv_transpose(
        x, ins['Filter'][0], _pair(attrs.get('strides', [1, 1])),
        _pair(attrs.get('dilations', [1, 1])), groups,
        [(p[0], p[0]), (p[1], p[1])])]}


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


_BN_SIDE_OUTS = ('MeanOut', 'VarianceOut', 'SavedMean', 'SavedVariance')


@register('batch_norm', no_grad_out_slots=_BN_SIDE_OUTS)
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
    raw sums.

    In data parallel the batch is the global batch, as in the JAX
    package's one computation: the shift is the global first element's
    (rank 0's, broadcast), the sums are all-reduced with a gradient
    (wire.all_reduce_sum_grad, so the backward's per-channel sums are
    global too) and n is the global count.  A collective program
    (``_collective_dp``) normalizes each rank by its own rows."""
    rep = ctx.data_parallel()
    return _batch_norm(ins, attrs, None if rep is None else rep.group)


def _batch_norm(ins, attrs, group, raw=False):
    """batch_norm over the rows of every rank of `group` (None: this
    rank's), from raw sums with `raw` (sync_batch_norm's form)."""
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
    if group is not None:
        cnt *= dist.get_world_size(group)

    def sums(a, b):
        if group is None:
            return a, b
        return wire.all_reduce_sum_grad(torch.stack([a, b]), group).unbind(0)

    if use_global:
        m, v = mean, var
    elif raw or x.dtype in (torch.bfloat16, torch.float16):
        s1, s2 = sums(torch.sum(xf, dim=red), torch.sum(xf * xf, dim=red))
        m = s1 / cnt
        v = s2 / cnt - m * m
        if not raw:
            v = torch.clamp(v, min=0.0)
    else:
        shift = torch.mean(xf.narrow(red[0], 0, 1), dim=red).detach()
        if group is not None:
            shift = wire.broadcast(shift, group, 0)
        xs = xf - shift.reshape(bshape)
        s1, s2 = sums(torch.sum(xs, dim=red), torch.sum(xs * xs, dim=red))
        d = s1 / cnt
        m = shift + d
        v = torch.clamp(s2 / cnt - d * d, min=0.0)
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


@register('sync_batch_norm', no_grad_out_slots=_BN_SIDE_OUTS)
def sync_batch_norm(ctx, ins, attrs):
    """Reference operators/sync_batch_norm_op.cu (ncclAllReduce of the
    partial sums); the JAX package's lowering.  In a collective program
    (``_collective_dp``) with a group of more than one rank the raw
    per-channel sums are all-reduced over the group with a gradient
    (the JAX package's psum inside shard_map) and n is the global
    count; otherwise it is batch_norm (global in data parallel)."""
    group = ctx.group if ctx.mode == 'collective' else None
    if attrs.get('is_test', False) or \
            attrs.get('use_global_stats', False) or group is None or \
            dist.get_world_size(group) == 1:
        return batch_norm(ctx, ins, attrs)
    return _batch_norm(ins, attrs, group, raw=True)


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
    """Reference operators/dropout_op.cc.  The keep mask is a counter
    hash of each element's index (``kernels.dropout.hash_keep``) under a
    seed keyed on (program seed, op seed, step, and the rank in data
    parallel) and read from the device (``LowerCtx.dropout_op_seed``),
    so a replay of the op (its grad op) and a replayed CUDA graph draw
    the same mask as the eager step, and ranks draw different ones; it
    does not reproduce the JAX package's threefry bits.  On the card Out
    comes from one kernel (csrc/dropout_mask.cu), which writes Mask too
    where something reads it (``LowerCtx.writes``: a fetch, a later op,
    a persistable Mask); otherwise the result has no Mask, as XLA never
    materialises an unread output.  The gradient computes the keep bits
    again from the seed (``kernels.dropout._Dropout``)."""
    x = ins['X'][0]
    p = attrs.get('dropout_prob', 0.5)
    impl = attrs.get('dropout_implementation', 'downgrade_in_infer')
    write_mask = ctx.writes('Mask')
    if attrs.get('is_test', False):
        out = x if impl == 'upscale_in_train' else x * (1.0 - p)
        mask = torch.ones_like(x) if write_mask else None
    elif x.device.type == 'meta':
        out = torch.empty_like(x)
        mask = torch.empty_like(x) if write_mask else None
    else:
        out, mask = dropout_k.dropout(x, ctx.dropout_op_seed(), p,
                                      impl == 'upscale_in_train', write_mask)
    return {'Out': [out]} if mask is None else {'Out': [out], 'Mask': [mask]}


@register('softmax_with_cross_entropy')
def softmax_with_cross_entropy(ctx, ins, attrs):
    """Softmax cross entropy along `axis` (reference
    operators/softmax_with_cross_entropy_op.cc): Loss keeps the logits'
    rank with a size-1 class dim; Softmax is the probabilities.  A hard
    Label picks one class a row (Loss 0 where it equals ignore_index),
    computed in f32 (f64 logits in f64).  A soft Label (soft_label)
    weights every class: Loss = -sum(Label * log_softmax(logits)) with
    the log-softmax in f32 and Softmax = exp of it, as the JAX package
    computes it.  Softmax is in the logits' dtype; so is Loss, but under
    the AMP black rule (``__amp_black__`` or ``__amp_black_out__``)
    half-precision logits give an f32 Loss, taken before any rounding
    (JAX: nn_ops.py:562-577)."""
    logits = ins['Logits'][0]
    label = ins['Label'][0]
    ax = attrs.get('axis', -1) % logits.ndim
    ignore_index = int(attrs.get('ignore_index', -100))
    loss_dtype = logits.dtype
    if (attrs.get('__amp_black__') or attrs.get('__amp_black_out__')) and \
            logits.dtype in (torch.bfloat16, torch.float16):
        loss_dtype = torch.float32
    if attrs.get('soft_label', False):
        logp = F.log_softmax(logits.float(), dim=ax)
        loss = -torch.sum(label * logp, dim=ax, keepdim=True)
        return {'Softmax': [torch.exp(logp).to(logits.dtype)],
                'Loss': [loss.to(loss_dtype)]}
    lab = label if label.ndim == logits.ndim else label.unsqueeze(ax)
    lf = logits if logits.dtype == torch.float64 else logits.float()
    lse = torch.logsumexp(lf, dim=ax, keepdim=True)
    valid = lab != ignore_index
    lab_safe = torch.where(valid, lab, torch.zeros_like(lab)).long()
    picked = torch.gather(lf, ax, lab_safe) - lse
    loss = torch.where(valid, -picked, torch.zeros_like(picked))
    softmax = torch.exp(lf - lse)
    return {'Softmax': [softmax.to(logits.dtype)],
            'Loss': [loss.to(loss_dtype)]}


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


@register('square_error_cost')
def square_error_cost(ctx, ins, attrs):
    """(X - Y)^2 elementwise, the loss of layers.square_error_cost (one
    op, as the JAX package lowers it: nn_ops.py:621)."""
    d = ins['X'][0] - ins['Y'][0]
    return {'Out': [d * d]}


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
            'Total': [torch.full((), total, dtype=torch.int32,
                                 device=idx.device)]}


@register('row_conv')
def row_conv(ctx, ins, attrs):
    """Lookahead convolution (operators/row_conv_op.cc, DeepSpeech2):
    out[b, t] = sum_{j < context} x[b, t + j] * w[j], past the end
    zero.  X [B,T,D], Filter [context, D]."""
    x = ins['X'][0]
    w = ins['Filter'][0]
    t = x.shape[1]
    xp = F.pad(x, (0, 0, 0, w.shape[0] - 1))
    return {'Out': [sum(xp[:, j:j + t] * w[j] for j in range(w.shape[0]))]}


# ---------------------------------------------------------------------------
# The rest of the JAX package's ops/nn_ops.py: the per-sample norms, the
# regression and divergence losses, auc, resizing and sampling, lrn, the
# indexed max pools and unpool, conv_shift.
# ---------------------------------------------------------------------------


def _f32(x):
    return x if x.dtype == torch.float64 else x.float()


def _channel_shape(x):
    return (1, x.shape[1]) + (1,) * (x.ndim - 2)


@register('instance_norm', no_grad_out_slots=('SavedMean', 'SavedVariance'))
def instance_norm(ctx, ins, attrs):
    """Each sample's channels normalized over their spatial dims
    (reference operators/instance_norm_op.cc; JAX :417): statistics in
    f32, Y in the input dtype; SavedMean and SavedVariance [N, C] are
    the mean and the (biased) variance, as the JAX op gives them."""
    x = ins['X'][0]
    eps = attrs.get('epsilon', 1e-5)
    xf = _f32(x)
    var, mean = torch.var_mean(xf, dim=tuple(range(2, x.ndim)),
                               correction=0, keepdim=True)
    y = (xf - mean) * torch.rsqrt(var + eps)
    if ins.get('Scale'):
        y = y * ins['Scale'][0].to(xf.dtype).reshape(_channel_shape(x))
        y = y + ins['Bias'][0].to(xf.dtype).reshape(_channel_shape(x))
    n, c = x.shape[0], x.shape[1]
    return {'Y': [y.to(x.dtype)], 'SavedMean': [mean.reshape(n, c)],
            'SavedVariance': [var.reshape(n, c)]}


@register('group_norm', no_grad_out_slots=('Mean', 'Variance'))
def group_norm(ctx, ins, attrs):
    """Channels split into `groups`, each sample's group normalized over
    its channels and spatial dims (reference operators/group_norm_op.cc;
    JAX :441; channels on axis 1 whatever data_layout says, as there):
    Mean and Variance [N, groups], the mean and the biased variance."""
    x = ins['X'][0]
    g = int(attrs['groups'])
    eps = attrs.get('epsilon', 1e-5)
    n, c = x.shape[0], x.shape[1]
    xs = _f32(x).reshape((n, g, c // g) + tuple(x.shape[2:]))
    var, mean = torch.var_mean(xs, dim=tuple(range(2, xs.ndim)),
                               correction=0, keepdim=True)
    y = ((xs - mean) * torch.rsqrt(var + eps)).reshape(x.shape)
    if ins.get('Scale'):
        y = y * ins['Scale'][0].to(y.dtype).reshape(_channel_shape(x))
    if ins.get('Bias'):
        y = y + ins['Bias'][0].to(y.dtype).reshape(_channel_shape(x))
    return {'Y': [y.to(x.dtype)], 'Mean': [mean.reshape(n, g)],
            'Variance': [var.reshape(n, g)]}


@register('huber_loss', no_grad_out_slots=('Residual',))
def huber_loss(ctx, ins, attrs):
    """0.5 r^2 where |r| <= delta, else delta (|r| - delta / 2), with
    the residual r = Y - X."""
    x, y = ins['X'][0], ins['Y'][0]
    delta = attrs.get('delta', 1.0)
    r = y - x
    a = torch.abs(r)
    loss = torch.where(a <= delta, 0.5 * r * r, delta * (a - 0.5 * delta))
    return {'Out': [loss], 'Residual': [r]}


@register('smooth_l1_loss', no_grad_out_slots=('Diff',))
def smooth_l1_loss(ctx, ins, attrs):
    """Per sample, the sum over the other dims of 0.5 (sigma d)^2 where
    |d| < 1 / sigma^2, else |d| - 0.5 / sigma^2, d = X - Y (the JAX op
    reads no InsideWeight / OutsideWeight)."""
    x, y = ins['X'][0], ins['Y'][0]
    s2 = attrs.get('sigma', 1.0) ** 2
    d = x - y
    a = torch.abs(d)
    loss = torch.where(a < 1.0 / s2, 0.5 * d * d * s2, a - 0.5 / s2)
    return {'Out': [torch.sum(loss, dim=tuple(range(1, x.ndim)),
                              keepdim=True)], 'Diff': [d]}


@register('log_loss')
def log_loss(ctx, ins, attrs):
    p, label = ins['Predicted'][0], ins['Labels'][0]
    eps = attrs.get('epsilon', 1e-4)
    return {'Loss': [-label * torch.log(p + eps) -
                     (1 - label) * torch.log(1 - p + eps)]}


@register('kldiv_loss')
def kldiv_loss(ctx, ins, attrs):
    """target (log target - X) where target > 0, else 0; reduced by
    'mean' (the default), 'sum', 'batchmean' or 'none'."""
    x, target = ins['X'][0], ins['Target'][0]
    out = target * (torch.log(torch.clamp(target, min=1e-20)) - x)
    out = torch.where(target > 0, out, torch.zeros_like(out))
    red = attrs.get('reduction', 'mean')
    if red == 'mean':
        out = torch.mean(out)
    elif red == 'sum':
        out = torch.sum(out)
    elif red == 'batchmean':
        out = torch.sum(out) / x.shape[0]
    return {'Loss': [out]}


@register('mse_loss')
def mse_loss(ctx, ins, attrs):
    d = ins['X'][0] - ins['Y'][0]
    return {'Out': [torch.mean(d * d)]}


@register('auc', no_grad_out_slots=('AUC', 'StatPosOut', 'StatNegOut'))
def auc(ctx, ins, attrs):
    """Streaming ROC AUC over threshold buckets (reference
    operators/metrics/auc_op.h; JAX :703): the positive probability
    Predict[:, 1] falls in bucket clip(int(p T), 0, T); StatPos /
    StatNeg (float32 [T + 1], the program's persistables, written in
    place, so they accumulate across steps and CUDA-graph replays) count
    the positive and negative labels a bucket.  Each step adds whole
    numbers: while a bucket's count is below 2^24 every partial sum is
    exact in float32, so the index_add (atomic adds on the card, in any
    order) is bitwise the JAX package's scatter-add.  AUC is the
    trapezoid area over the reversed cumulative sums (exact as well),
    the rates divided by max(total, 1)."""
    preds = ins['Predict'][0]
    label = ins['Label'][0].reshape(-1)
    stat_pos, stat_neg = ins['StatPos'][0], ins['StatNeg'][0]
    t = int(attrs.get('num_thresholds', 4095))
    bucket = torch.clamp((preds[:, 1] * t).to(torch.int32), 0, t).long()
    pos = (label > 0).to(stat_pos.dtype)
    stat_pos = stat_pos.index_add(0, bucket, pos)
    stat_neg = stat_neg.index_add(0, bucket, 1 - pos)
    tp = torch.cumsum(stat_pos.flip(0), 0)
    fp = torch.cumsum(stat_neg.flip(0), 0)
    tpr = tp / torch.clamp(tp[-1], min=1)
    fpr = fp / torch.clamp(fp[-1], min=1)
    area = torch.sum((fpr[1:] - fpr[:-1]) * (tpr[1:] + tpr[:-1]) * 0.5)
    return {'AUC': [area], 'StatPosOut': [stat_pos],
            'StatNegOut': [stat_neg]}


def _resize_hw(x, attrs):
    h, w = x.shape[2], x.shape[3]
    oh, ow = attrs.get('out_h', h), attrs.get('out_w', w)
    scale = attrs.get('scale', 0)
    if scale:
        oh, ow = int(h * scale), int(w * scale)
    return int(oh), int(ow)


def _bilinear_weights(m, n):
    """[m, n] float32: jax.image.scale_and_translate's weights of a
    bilinear resize of an axis from m to n samples (jax.image.resize,
    antialias on): sample j sits at (j + 0.5) m / n - 0.5 and takes the
    triangle kernel, widened by m / n when that is above 1 (down-sampling
    low-passes), each column normalized to sum 1 and zeroed where the
    sample lies outside the input.  Computed in float32 in JAX's order;
    for up-sampling it is plain half-pixel bilinear with the edges
    clamped."""
    f32 = np.float32
    inv = f32(1.0 / (n / m))
    sample = (np.arange(n, dtype=f32) + f32(0.5)) * inv - f32(0.5)
    x = np.abs(sample[None, :] - np.arange(m, dtype=f32)[:, None]) / \
        np.maximum(inv, f32(1.0))
    w = np.maximum(f32(0.0), f32(1.0) - x)
    total = np.sum(w, axis=0, keepdims=True, dtype=f32)
    w = np.where(np.abs(total) > 1000.0 * np.finfo(f32).eps,
                 w / np.where(total != 0, total, f32(1.0)), f32(0.0))
    inside = (sample >= -0.5) & (sample <= m - 0.5)
    return np.where(inside[None, :], w, f32(0.0)).astype(f32)


def _axis_matrix(values, x):
    if x.device.type == 'meta':
        return torch.empty(values.shape, dtype=x.dtype, device='meta')
    return device_constant(values, x.device).to(x.dtype)


@register('bilinear_interp')
def bilinear_interp(ctx, ins, attrs):
    """NCHW X resized to (out_h, out_w) (or by `scale`) as
    jax.image.resize(method='bilinear') computes it (JAX :760): half-pixel
    centres, antialiased when down-sampling, align_corners and
    align_mode ignored (as in the JAX package; Fluid 1.6 defaults to
    align_corners=True).  Each resized axis is a product with its weight
    matrix (``_bilinear_weights``), so the gradient is two products too
    (no scatter); an axis of unchanged size is left as it is."""
    x = ins['X'][0]
    oh, ow = _resize_hw(x, attrs)
    out = x
    if oh != x.shape[2]:
        wh = _axis_matrix(_bilinear_weights(x.shape[2], oh), x)
        out = torch.matmul(out.transpose(2, 3), wh).transpose(2, 3)
    if ow != x.shape[3]:
        out = torch.matmul(out, _axis_matrix(
            _bilinear_weights(x.shape[3], ow), x))
    return {'Out': [out]}


def _nearest_index(m, n, device):
    """The source index of each of n samples resized from m, as
    jax.image.resize(method='nearest') computes it in float32:
    floor((j + 0.5) m / n)."""
    j = torch.arange(n, dtype=torch.float32, device=device)
    return torch.clamp(torch.floor((j + 0.5) * m / n), max=m - 1).long()


class _NearestResize(torch.autograd.Function):
    """Rows `ih` and columns `iw` of NCHW x; the gradient sums the
    cotangent into each source pixel by two products with the one-hot
    selection matrices (deterministic, where index_select's backward
    adds with atomics on the card)."""

    @staticmethod
    def forward(ctx, x, ih, iw):
        ctx.save_for_backward(ih, iw)
        ctx.hw = x.shape[2], x.shape[3]
        return x.index_select(2, ih).index_select(3, iw)

    @staticmethod
    def backward(ctx, g):
        ih, iw = ctx.saved_tensors
        h, w = ctx.hw
        sh = F.one_hot(ih, h).to(g.dtype)   # [oh, h]
        sw = F.one_hot(iw, w).to(g.dtype)   # [ow, w]
        gx = torch.matmul(torch.matmul(g, sw).transpose(2, 3), sh)
        return gx.transpose(2, 3), None, None


@register('interp_nearest')
@register('nearest_interp')
def nearest_interp(ctx, ins, attrs):
    """NCHW X resized to (out_h, out_w) (or by `scale`) by nearest
    neighbour with jax.image.resize's half-pixel rounding (JAX
    :746-747; F.interpolate's 'nearest' floors j m / n instead, its
    'nearest-exact' multiplies by a rounded m / n), align_corners
    ignored."""
    x = ins['X'][0]
    oh, ow = _resize_hw(x, attrs)
    if x.device.type == 'meta':
        return {'Out': [x.new_empty(x.shape[:2] + (oh, ow))]}
    ih = _nearest_index(x.shape[2], oh, x.device)
    iw = _nearest_index(x.shape[3], ow, x.device)
    return {'Out': [_NearestResize.apply(x, ih, iw)]}


@register('grid_sampler')
def grid_sampler(ctx, ins, attrs):
    """Bilinear sampling of X [N, C, H, W] at Grid [N, Hg, Wg, 2]
    (x, y in [-1, 1], corners aligned: -1 and 1 are the outer pixels'
    centres), neighbours outside the image contributing zero
    (reference operators/grid_sampler_op.cc; JAX :773): F.grid_sample
    with align_corners=True and zero padding, gradients to X and Grid.
    Output and Out are the same tensor, as in the JAX op."""
    out = F.grid_sample(ins['X'][0], ins['Grid'][0], mode='bilinear',
                        padding_mode='zeros', align_corners=True)
    return {'Output': [out], 'Out': [out]}


@register('temporal_shift')
def temporal_shift(ctx, ins, attrs):
    """TSM's shift of X [N * seg_num, C, H, W] along the segments: the
    first C * shift_ratio channels from the previous segment, the next
    as many from the following one, zeros at the ends."""
    x = ins['X'][0]
    seg = int(attrs['seg_num'])
    ratio = attrs.get('shift_ratio', 0.25)
    nt, c, h, w = x.shape
    xr = x.reshape(nt // seg, seg, c, h, w)
    c1, c2 = int(c * ratio), int(c * 2 * ratio)
    pre = torch.cat([torch.zeros_like(xr[:, :1, :c1]), xr[:, :-1, :c1]], 1)
    post = torch.cat([xr[:, 1:, c1:c2], torch.zeros_like(xr[:, :1, c1:c2])],
                     1)
    return {'Out': [torch.cat([pre, post, xr[:, :, c2:]], 2).reshape(
        nt, c, h, w)]}


@register('lrn', no_grad_out_slots=('MidOut',))
def lrn(ctx, ins, attrs):
    """Cross-channel local response norm (reference operators/lrn_op.cc;
    JAX :834): MidOut = k + alpha * (the sum of squares over n channels
    about each one), Out = X * MidOut^-beta.  alpha multiplies the sum
    itself (F.local_response_norm divides it by n)."""
    x = ins['X'][0]
    n = int(attrs.get('n', 5))
    k, alpha = attrs.get('k', 1.0), attrs.get('alpha', 1e-4)
    beta = attrs.get('beta', 0.75)
    half = n // 2
    pad = F.pad(x * x, (0, 0, 0, 0, half, half))
    acc = sum(pad[:, i:i + x.shape[1]] for i in range(n))
    mid = k + alpha * acc
    return {'Out': [x * torch.pow(mid, -beta)], 'MidOut': [mid]}


def _indexed_max_pool(x, ksize, strides, pads):
    """Max pooling of x [N, C, *spatial] over windows `ksize` at `strides`
    (1 to 3 spatial dims, padded by `pads` with the dtype's finfo.min):
    (Out, Mask), Mask the int32 flat index over the unpadded spatial
    dims of each window's first maximum (the JAX package's
    _pool_patches + argmax).  The window is taken by unfold, so Out's
    gradient splits evenly among a window's ties (amax), as jnp.max's
    does, and overlapping windows add up."""
    nd = len(ksize)
    spatial = tuple(x.shape[2:])
    neg = torch.finfo(x.dtype).min
    flat = []
    for p in reversed(pads):
        flat += [p, p]
    xp = F.pad(x, flat, value=neg) if any(pads) else x
    for d in range(nd):
        xp = xp.unfold(2 + d, ksize[d], strides[d])
    outs = tuple(xp.shape[2:2 + nd])
    patches = xp.reshape(tuple(xp.shape[:2 + nd]) + (-1,))
    out = torch.amax(patches, dim=-1)
    am = torch.argmax(patches, dim=-1)
    # the tap's offset in each window dim, then its unpadded coordinate
    index = torch.zeros_like(am)
    rem = am
    for d in reversed(range(nd)):
        tap = rem % ksize[d]
        rem = rem // ksize[d]
        shape = [1] * nd
        shape[d] = outs[d]
        base = torch.arange(outs[d], device=x.device).reshape(shape) * \
            strides[d] - pads[d]
        stride = int(np.prod(spatial[d + 1:]))
        index = index + (base + tap) * stride
    return out, index.to(torch.int32)


@register('max_pool2d_with_index', no_grad_out_slots=('Mask',))
def max_pool2d_with_index(ctx, ins, attrs):
    """Reference operators/pool_with_index_op.cc (JAX :877): max pooling
    and the flat h * w index of each window's first maximum (Mask, int32),
    which unpool reads."""
    ksize = _pair(attrs.get('ksize', [2, 2]))
    out, mask = _indexed_max_pool(
        ins['X'][0], ksize, _pair(attrs.get('strides', ksize)),
        _pair(attrs.get('paddings', [0, 0])))
    return {'Out': [out], 'Mask': [mask]}


@register('max_pool3d_with_index', no_grad_out_slots=('Mask',))
def max_pool3d_with_index(ctx, ins, attrs):
    """The NCDHW form (JAX :895): Mask the flat d * h * w index."""
    ksize = [int(k) for k in attrs.get('ksize', [2, 2, 2])]
    out, mask = _indexed_max_pool(
        ins['X'][0], ksize,
        [int(s) for s in attrs.get('strides', ksize)],
        [int(p) for p in attrs.get('paddings', [0, 0, 0])])
    return {'Out': [out], 'Mask': [mask]}


@register('unpool')
def unpool(ctx, ins, attrs):
    """Reference operators/unpool_op.cc (JAX :934): X's values put back
    at the flat positions Indices names (max_pool2d_with_index's Mask)
    of a zero map of unpooled_size, or of (in - 1) * stride - 2 * pad +
    ksize."""
    x = ins['X'][0]
    if attrs.get('unpooled_size'):
        oh, ow = (int(v) for v in attrs['unpooled_size'])
    else:
        kh, kw = _pair(attrs.get('ksize', [2, 2]))
        sh, sw = _pair(attrs.get('strides', [kh, kw]))
        ph, pw = _pair(attrs.get('paddings', [0, 0]))
        oh = (x.shape[2] - 1) * sh - 2 * ph + kh
        ow = (x.shape[3] - 1) * sw - 2 * pw + kw
    n, c = x.shape[:2]
    idx = ins['Indices'][0].reshape(n, c, -1).long()
    out = x.new_zeros((n, c, oh * ow)).scatter(2, idx, x.reshape(n, c, -1))
    return {'Out': [out.reshape(n, c, oh, ow)]}


@register('conv_shift')
def conv_shift(ctx, ins, attrs):
    """Circular convolution (reference operators/conv_shift_op.cc; JAX
    :1034): out[b, i] = sum_j X[b, (i + j - M // 2) mod N] Y[b, j]."""
    x, y = ins['X'][0], ins['Y'][0]
    half = y.shape[1] // 2
    return {'Out': [sum(torch.roll(x, half - j, 1) * y[:, j:j + 1]
                        for j in range(y.shape[1]))]}
