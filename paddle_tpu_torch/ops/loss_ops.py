"""Ranking, regression and distillation losses and small misc ops: the
JAX package's ops/loss_ops.py.

Reference: operators/{rank_loss,margin_rank_loss,hinge_loss,bpr_loss,
modified_huber_loss,teacher_student_sigmoid_loss,center_loss,cvm,fsp,
l1_norm,mean_iou,shard_index,size,multiplex,bilinear_tensor_product,
sampling_id,scatter_nd_add,pad_constant_like,spectral_norm,data_norm,
random_crop,unique_with_counts}_op.*.
No float adds into shared rows with atomics on the card: center_loss
gathers its centers through the embedding gather (K6, whose gradient
is the sorted scatter-add K6b) and sums its update by the sorted
scatter-add; scatter_nd_add adds its updates by the sorted scatter-add
and takes their gradient by the gather.  The draws of sampling_id and
random_crop come from the counter hash under ``LowerCtx.sample_seed``
(the device step), as the port's other sampling ops draw: held to the
JAX package's threefry draws by their statistics only.
"""

import numpy as np
import torch
import torch.nn.functional as F

from ..fluid import core
from .kernels import embedding as emb_k
from .lang_ops import _softplus
from .registry import register, register_host
from .tensor_ops import _unit


@register('rank_loss')
def rank_loss(ctx, ins, attrs):
    """RankNet: softplus(Left - Right) - Label (Left - Right)."""
    d = ins['Left'][0] - ins['Right'][0]
    return {'Out': [_softplus(d) - ins['Label'][0] * d]}


@register('margin_rank_loss', no_grad_out_slots=('Activated',))
def margin_rank_loss(ctx, ins, attrs):
    """relu(-Label (X1 - X2) + margin), Label in {-1, 1}; Activated the
    0/1 mask of a positive margin."""
    x1 = ins['X1'][0]
    val = -ins['Label'][0] * (x1 - ins['X2'][0]) + attrs.get('margin', 0.0)
    return {'Out': [F.relu(val)], 'Activated': [(val > 0).to(x1.dtype)]}


@register('hinge_loss')
def hinge_loss(ctx, ins, attrs):
    """relu(1 - (2 Labels - 1) Logits), Labels in {0, 1}."""
    return {'Loss': [F.relu(1.0 - (2.0 * ins['Labels'][0] - 1.0) *
                            ins['Logits'][0])]}


@register('bpr_loss')
def bpr_loss(ctx, ins, attrs):
    """Bayesian personalized ranking: the mean over the other columns j
    of softplus(X[i, j] - X[i, label_i]), as [N, 1]."""
    x = ins['X'][0]
    label = ins['Label'][0].reshape(-1).long()
    c = x.shape[1]
    oh = F.one_hot(label, c).to(x.dtype)
    pos = (x * oh).sum(1, keepdim=True)
    return {'Y': [(_softplus(x - pos) * (1.0 - oh)).sum(
        1, keepdim=True) / (c - 1)]}


@register('modified_huber_loss', no_grad_out_slots=('IntermediateVal',))
def modified_huber_loss(ctx, ins, attrs):
    """v = (2 Y - 1) X: -4 v below -1, (1 - v)^2 below 1, else 0."""
    x = ins['X'][0]
    val = (2.0 * ins['Y'][0] - 1.0) * x
    zero = torch.zeros_like(val)
    loss = torch.where(val < -1.0, -4.0 * val,
                       torch.where(val < 1.0, (1.0 - val) ** 2, zero))
    return {'Out': [loss], 'IntermediateVal': [val]}


@register('teacher_student_sigmoid_loss')
def teacher_student_sigmoid_loss(ctx, ins, attrs):
    """The CTR distillation loss: the click cross entropy (z = 0 below
    label -1 and in [0, 1), z = 1 in [-1, 0) and from 1), plus the
    teacher's soft cross entropy at q = label (label - 1 from 1) where
    label >= 0."""
    x = ins['X'][0]
    label = ins['Label'][0]
    tail = torch.log1p(torch.exp(-torch.abs(x)))
    ce0 = F.relu(x) + tail
    ce1 = ce0 - x
    q = torch.where(label < 1.0, label, label - 1.0)
    teacher = F.relu(x) - x * q + tail
    return {'Y': [torch.where(label < -1.0, ce0, torch.where(
        label < 0.0, ce1, torch.where(label < 1.0, ce0 + teacher,
                                      ce1 + teacher)))]}


@register('center_loss',
          no_grad_out_slots=('SampleCenterDiff', 'CentersOut'))
def center_loss(ctx, ins, attrs):
    """0.5 ||X - Centers[label]||^2 a sample, and with need_update the
    updated centers Centers + rate * (the class's summed differences) /
    (1 + its count) (CentersOut; rate CenterUpdateRate or alpha).  The
    centers are gathered by the embedding gather and the sums added by
    the sorted scatter-add: fixed order, no atomics."""
    x = ins['X'][0]
    label = ins['Label'][0].reshape(-1).long()
    centers = ins['Centers'][0]
    rate = ins['CenterUpdateRate'][0].reshape(()) \
        if ins.get('CenterUpdateRate') else attrs.get('alpha', 0.5)
    diff = x - emb_k.embedding_lookup(centers, label)
    loss = 0.5 * (diff * diff).sum(1, keepdim=True)
    new = centers
    if centers.device.type == 'meta':
        new = torch.empty_like(centers)
    elif attrs.get('need_update', True):
        k = centers.shape[0]
        with torch.no_grad():
            d = diff.detach()
            counts = emb_k.scatter_add(k, label, torch.ones_like(d[:, :1]))
            sums = emb_k.scatter_add(k, label, d)
            new = centers.detach() + rate * sums / (1.0 + counts)
    return {'Loss': [loss], 'SampleCenterDiff': [diff],
            'CentersOut': [new]}


@register('cvm')
def cvm(ctx, ins, attrs):
    """The CTR show / click transform: log(show + 1) and log(click + 1)
    - log(show + 1) in front of the rest (use_cvm), or the rest alone."""
    x = ins['X'][0]
    if not attrs.get('use_cvm', True):
        return {'Y': [x[:, 2:]]}
    show = torch.log(x[:, 0:1] + 1.0)
    clk = torch.log(x[:, 1:2] + 1.0) - show
    return {'Y': [torch.cat([show, clk, x[:, 2:]], 1)]}


@register('fsp')
def fsp(ctx, ins, attrs):
    """The flow of solution procedure matrix: X [B, C1, H, W], Y [B, C2,
    H, W] -> X Y^T / (H W), [B, C1, C2]."""
    x, y = ins['X'][0], ins['Y'][0]
    b, c1, h, w = x.shape
    return {'Out': [torch.matmul(x.reshape(b, c1, h * w), y.reshape(
        b, y.shape[1], h * w).transpose(1, 2)) / (h * w)]}


@register('l1_norm')
def l1_norm(ctx, ins, attrs):
    return {'Out': [torch.abs(ins['X'][0]).sum().reshape(1)]}


def _counts(idx, n):
    """[n] int64: how often each of 0..n-1 occurs in idx (others not
    counted), by integer adds (exact in any order)."""
    idx = idx.reshape(-1)
    slot = torch.where((idx >= 0) & (idx < n), idx, torch.full_like(idx, n))
    return torch.zeros(n + 1, dtype=torch.int64, device=idx.device) \
        .scatter_add_(0, slot, torch.ones_like(slot))[:n]


@register('mean_iou',
          no_grad_out_slots=('OutMeanIou', 'OutWrong', 'OutCorrect'))
def mean_iou(ctx, ins, attrs):
    """Per-class IOU = correct / (predicted + labelled - correct), its
    mean over the classes present; OutWrong and OutCorrect int32 counts
    a class."""
    pred = ins['Predictions'][0].reshape(-1).long()
    label = ins['Labels'][0].reshape(-1).long()
    n = int(attrs['num_classes'])
    correct = _counts(torch.where(pred == label, pred,
                                  torch.full_like(pred, n)), n)
    pred_cnt, label_cnt = _counts(pred, n), _counts(label, n)
    f = torch.float32
    denom = (pred_cnt + label_cnt - correct).to(f)
    present = denom > 0
    iou = torch.where(present, correct.to(f) / torch.clamp(denom, min=1.0),
                      torch.zeros_like(denom))
    miou = iou.sum() / torch.clamp(present.to(f).sum(), min=1.0)
    return {'OutMeanIou': [miou.reshape(1)],
            'OutWrong': [(pred_cnt + label_cnt - 2 * correct).to(
                torch.int32)],
            'OutCorrect': [correct.to(torch.int32)]}


@register('shard_index', no_grad_out_slots=('Out',))
def shard_index(ctx, ins, attrs):
    """A global id's id in shard shard_id (ids // shard_size ==
    shard_id), else ignore_value; shard_size = ceil(index_num /
    nshards)."""
    x = ins['X'][0]
    size = (int(attrs['index_num']) + int(attrs['nshards']) - 1) // \
        int(attrs['nshards'])
    return {'Out': [torch.where(x // size == int(attrs['shard_id']),
                                x % size, torch.full_like(
                                    x, attrs.get('ignore_value', -1)))]}


@register('multiplex')
def multiplex(ctx, ins, attrs):
    """Row b of X[Ids[b]]."""
    ids = ins['Ids'][0].reshape(-1).long()
    xs = torch.stack(ins['X'], 0)
    idx = ids.reshape((1, -1) + (1,) * (xs.dim() - 2)).expand(
        (1,) + tuple(xs.shape[1:]))
    return {'Out': [torch.gather(xs, 0, idx)[0]]}


@register('bilinear_tensor_product')
def bilinear_tensor_product(ctx, ins, attrs):
    """out[b, k] = X_b Weight_k Y_b^T (+ Bias)."""
    out = torch.einsum('bm,kmn,bn->bk', ins['X'][0], ins['Weight'][0],
                       ins['Y'][0])
    if ins.get('Bias'):
        out = out + ins['Bias'][0].reshape(1, -1)
    return {'Out': [out]}


@register('sampling_id', no_grad_out_slots=('Out',))
def sampling_id(ctx, ins, attrs):
    """A column a row drawn with probability proportional to its value
    (floored at 1e-20, as the JAX op's log does): the first column whose
    running sum passes a uniform draw times the row's sum.  int64."""
    x = ins['X'][0]
    q = torch.clamp(x.detach(), min=1e-20)
    run = torch.cumsum(q, -1)
    u = _unit(ctx, attrs, tuple(x.shape[:-1]) + (1,), x.device, 0x5A3)
    idx = (run < u * run[..., -1:]).sum(-1)
    return {'Out': [torch.clamp(idx, max=x.shape[-1] - 1).to(torch.int64)]}


class _RowScatterAdd(torch.autograd.Function):
    """[nrows, D] with g's rows summed at ids by the sorted scatter-add;
    its gradient is the gather of the cotangent's rows at ids."""

    @staticmethod
    def forward(ctx, nrows, ids, g):
        ctx.save_for_backward(ids)
        return emb_k.scatter_add(nrows, ids, g)

    @staticmethod
    def backward(ctx, gout):
        (ids,) = ctx.saved_tensors
        return None, None, emb_k.embedding_lookup(gout.contiguous(), ids)


def _scatter_nd_add(x, index, updates):
    """x with updates added at the first index.shape[-1] coordinates in
    index (negative ones counted from the end, those outside x
    dropped, as the JAX op's .at[].add)."""
    k = index.shape[-1]
    lead = tuple(x.shape[:k])
    index = index.long().reshape(-1, k)
    dims = torch.tensor(lead, dtype=torch.int64, device=x.device) \
        if x.device.type != 'meta' else None
    if dims is None:
        return x.clone()
    index = torch.where(index < 0, index + dims, index)
    valid = ((index >= 0) & (index < dims)).all(1)
    strides = torch.tensor([int(np.prod(lead[i + 1:])) for i in range(k)],
                           dtype=torch.int64, device=x.device)
    rows = torch.where(valid, (index * strides).sum(1),
                       torch.zeros_like(valid, dtype=torch.int64))
    width = int(np.prod(x.shape[k:]))
    upd = updates.reshape(-1, width)
    upd = torch.where(valid[:, None], upd, torch.zeros_like(upd))
    nrows = int(np.prod(lead))
    return x + _RowScatterAdd.apply(nrows, rows, upd).reshape(x.shape)


@register('scatter_nd_add')
def scatter_nd_add(ctx, ins, attrs):
    """X with Updates added at Index's coordinates (Index [..., k] names
    X's first k dims), duplicates summed in sorted order."""
    return {'Out': [_scatter_nd_add(ins['X'][0], ins['Index'][0],
                                    ins['Updates'][0])]}


@register('pad_constant_like')
def pad_constant_like(ctx, ins, attrs):
    """Y padded at the end of each dim up to X's shape with pad_value."""
    x, y = ins['X'][0], ins['Y'][0]
    flat = []
    for xd, yd in reversed(list(zip(x.shape, y.shape))):
        flat += [0, int(xd) - int(yd)]
    return {'Out': [F.pad(y, flat, value=attrs.get('pad_value', 0.0))]}


@register('spectral_norm')
def spectral_norm(ctx, ins, attrs):
    """Weight / sigma, sigma = u^T W v after power_iters (at least one)
    power iterations from U and V (each normalized by max(norm, eps)) on
    Weight with `dim` first and the rest flattened; u and v carry no
    gradient and are not written back, as in the JAX op."""
    w = ins['Weight'][0]
    dim = attrs.get('dim', 0)
    eps = attrs.get('eps', 1e-12)
    perm = [dim] + [i for i in range(w.dim()) if i != dim]
    mat = w.permute(perm).reshape(w.shape[dim], -1)
    u = ins['U'][0].reshape(-1)
    v = ins['V'][0].reshape(-1)
    with torch.no_grad():
        m = mat.detach()
        for _ in range(max(int(attrs.get('power_iters', 1)), 1)):
            v = torch.mv(m.t(), u)
            v = v / torch.clamp(torch.linalg.vector_norm(v), min=eps)
            u = torch.mv(m, v)
            u = u / torch.clamp(torch.linalg.vector_norm(u), min=eps)
    sigma = torch.dot(u, torch.mv(mat, v))
    return {'Out': [w / sigma]}


@register('data_norm', no_grad_out_slots=('Means', 'Scales'))
def data_norm(ctx, ins, attrs):
    """(X - BatchSum / BatchSize) * sqrt(BatchSize / max(BatchSquareSum -
    BatchSize mean^2, epsilon)), a column; the statistics are the
    layer's parameters, so their gradients go to the optimizer as in the
    JAX package."""
    x = ins['X'][0]
    bsize = ins['BatchSize'][0].reshape(-1)
    bsum = ins['BatchSum'][0].reshape(-1)
    bsqr = ins['BatchSquareSum'][0].reshape(-1)
    means = bsum / bsize
    scales = torch.sqrt(bsize / torch.clamp(
        bsqr - bsize * means * means, min=attrs.get('epsilon', 1e-4)))
    return {'Y': [(x - means[None, :]) * scales[None, :]],
            'Means': [means], 'Scales': [scales]}


@register('random_crop', no_grad_out_slots=('Out', 'SeedOut'))
def random_crop(ctx, ins, attrs):
    """Each sample's window of the trailing len(shape) dims at starts
    drawn uniformly in [0, full - s] (the counter hash under the device
    step); SeedOut a zero int64 [1], as the JAX op gives it."""
    x = ins['X'][0]
    shape = [int(s) for s in attrs['shape']]
    k, nd = len(shape), x.dim()
    u = _unit(ctx, attrs, (x.shape[0], k), x.device, 0x3C5)
    out = x
    for i, s in enumerate(shape):
        axis = nd - k + i
        full = x.shape[axis]
        start = torch.clamp((u[:, i] * (full - s + 1)).long(), max=full - s)
        idx = start[:, None] + torch.arange(s, device=x.device)[None, :]
        view = [x.shape[0]] + [1] * (nd - 1)
        view[axis] = s
        idx = idx.reshape(view).expand(
            tuple(out.shape[:axis]) + (s,) + tuple(out.shape[axis + 1:]))
        out = torch.gather(out, axis, idx)
    return {'Out': [out], 'SeedOut': [torch.zeros(
        (1,), dtype=torch.int64, device=x.device)]}


@register_host('unique_with_counts', runs=True)
def unique_with_counts(ctx, op, ins):
    """A host op (the output's length depends on the data): X's sorted
    distinct values, each element's int32 position among them (Index)
    and each value's int32 count (Count)."""
    x = core.to_numpy(ins['X'][0]).reshape(-1)
    uniq, index, counts = np.unique(x, return_inverse=True,
                                    return_counts=True)
    dev = ctx.device
    outs = {'Out': [torch.as_tensor(uniq, device=dev)]}
    if op.output('Index'):
        outs['Index'] = [torch.as_tensor(index.astype(np.int32), device=dev)]
    if op.output('Count'):
        outs['Count'] = [torch.as_tensor(counts.astype(np.int32),
                                         device=dev)]
    return outs


@register('size', no_grad_out_slots=('Out',))
def size(ctx, ins, attrs):
    """Input's element count as an int64 [1] (the reference's dtype,
    which the layer declares; the JAX package, with x64 off, holds it in
    int32)."""
    return {'Out': [torch.full((1,), ins['Input'][0].numel(),
                               dtype=torch.int64, device=ctx.device)]}
