"""Embedding row gather, its backward (the sorted scatter-add) and the
sparse Adagrad row update: the hand-written CUDA kernels
(csrc/embedding_gather.cu, csrc/embedding_scatter.cu,
csrc/embedding_update.cu), their plain PyTorch versions, and the
``torch.autograd.Function`` that joins the first two.
"""

import ctypes

import torch

from . import common

SOURCE = 'embedding_gather.cu'
SCATTER_SOURCE = 'embedding_scatter.cu'
UPDATE_SOURCE = 'embedding_update.cu'

common.register_kernel(
    'embedding_lookup',
    source=SOURCE,
    plain='ops.kernels.embedding.gather_plain (index_select of clipped ids)',
    replaces='paddle_tpu/ops/pallas/embedding.py:60 _gather_kernel',
    doc='one warp per row, 16-byte vectors, ids clipped in the kernel',
    op_types=('lookup_table', 'lookup_table_v2'))

common.register_kernel(
    'embedding_scatter_add',
    source=SCATTER_SOURCE,
    plain='ops.kernels.embedding.scatter_add_plain (stable sort, then '
          'each run of equal ids summed left to right)',
    replaces='paddle_tpu/ops/pallas/embedding.py:65 _scatter_kernel',
    doc='one block per (run of equal sorted ids, 256 columns), the run '
        'summed in sorted order; no atomics',
    op_types=('lookup_table_grad', 'lookup_table_v2_grad'))

common.register_kernel(
    'embedding_update',
    source=UPDATE_SOURCE,
    plain='ops.kernels.embedding.update_plain (stable sort, each run of '
          'equal ids summed left to right, Adagrad on those rows)',
    replaces='paddle_tpu/ops/pallas/embedding.py:165 _update_kernel',
    doc='a group of lanes per run of equal sorted ids, the run summed in '
        'sorted order, Adagrad applied once per touched row in place; no '
        'atomics',
    op_types=('fused_emb_update',))


def gather_plain(w, ids):
    """[V, D] rows at ids clipped into [0, V-1] -> [n, D]."""
    return w.index_select(0, ids.clamp(0, w.shape[0] - 1))


def gather_kernel(w, ids):
    """The CUDA kernel: w [V, D] and ids [n] (int64 or int32) on one
    CUDA device -> [n, D] in w's dtype, bitwise equal to gather_plain."""
    if w.dim() != 2 or ids.dim() != 1:
        raise ValueError('gather_kernel takes w [V, D] and ids [n], got %s '
                         'and %s' % (tuple(w.shape), tuple(ids.shape)))
    if ids.dtype not in (torch.int64, torch.int32):
        raise TypeError('ids must be int64 or int32, got %s' % ids.dtype)
    if w.device != ids.device:
        raise ValueError('w on %s, ids on %s' % (w.device, ids.device))
    w = w.contiguous()
    ids = ids.contiguous()
    n = ids.shape[0]
    out = torch.empty((n, w.shape[1]), dtype=w.dtype, device=w.device)
    lib = common.library(SOURCE)
    fn = lib.embedding_gather
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                   ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong,
                   ctypes.c_longlong, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    with torch.cuda.device(w.device):
        err = fn(w.data_ptr(), ids.data_ptr(), ids.element_size(),
                 out.data_ptr(), n, w.shape[0],
                 w.shape[1] * w.element_size(), common.stream_ptr(w.device))
    common.check_launch('embedding_lookup', lib, err)
    return out


def _sorted(nrows, ids):
    """(sorted ids, their positions) of ids clipped into [0, nrows-1],
    by a stable sort, so equal ids keep their order."""
    ids = ids.reshape(-1).to(torch.int64).clamp(0, nrows - 1)
    return torch.sort(ids, stable=True)


def _run_sums(nrows, ids, g):
    """(distinct ids, their summed rows) of g's rows at ids clipped into
    [0, nrows-1]: the rows of each id added in sorted (stable) order,
    left to right, as the kernels sum them."""
    sids, order = _sorted(nrows, ids)
    sg = g.index_select(0, order)
    uniq, counts = torch.unique_consecutive(sids, return_counts=True)
    starts = torch.cumsum(counts, 0) - counts
    acc = sg.index_select(0, starts)
    for r in range(1, int(counts.max()) if counts.numel() else 0):
        live = (counts > r).nonzero().squeeze(1)
        acc[live] = acc[live] + sg.index_select(0, starts[live] + r)
    return uniq, acc


def scatter_add_plain(nrows, ids, g):
    """[nrows, D] zeros with g's rows summed at ids (clipped into
    [0, nrows-1]), duplicates in sorted order as in the kernel,
    bitwise."""
    uniq, acc = _run_sums(nrows, ids, g)
    out = torch.zeros((nrows, g.shape[1]), dtype=g.dtype, device=g.device)
    out[uniq] = acc
    return out


def scatter_add_kernel(nrows, ids, g):
    """The CUDA kernel: ids [n] (any integer type) and g [n, D] f32 on
    one CUDA device -> [nrows, D] f32, bitwise equal to
    scatter_add_plain.  The stable sort runs before the kernel, as in
    the JAX package."""
    if g.dim() != 2 or ids.numel() != g.shape[0]:
        raise ValueError('scatter_add_kernel takes ids [n] and g [n, D], '
                         'got %s and %s' % (tuple(ids.shape),
                                            tuple(g.shape)))
    if g.dtype != torch.float32:
        raise TypeError('the scatter-add kernel takes f32 rows, got %s'
                        % g.dtype)
    if ids.device != g.device:
        raise ValueError('ids on %s, g on %s' % (ids.device, g.device))
    sids, order = _sorted(nrows, ids)
    g = g.contiguous()
    out = torch.zeros((nrows, g.shape[1]), dtype=g.dtype, device=g.device)
    lib = common.library(SCATTER_SOURCE)
    fn = lib.embedding_scatter_add
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_longlong] * 2 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    with torch.cuda.device(g.device):
        err = fn(sids.data_ptr(), order.data_ptr(), g.data_ptr(),
                 out.data_ptr(), g.shape[0], g.shape[1],
                 common.stream_ptr(g.device))
    common.check_launch('embedding_scatter_add', lib, err)
    return out


def scatter_add(nrows, ids, g):
    """[nrows, D] with g's rows summed at ids (duplicates accumulate in
    sorted order): the kernel for CUDA tensors, the plain version for
    CPU tensors."""
    if common.use_kernel(ids, g):
        return scatter_add_kernel(nrows, ids, g)
    return scatter_add_plain(nrows, ids, g)


class _Lookup(torch.autograd.Function):
    """Row gather whose backward is the sorted scatter-add."""

    @staticmethod
    def forward(ctx, w, ids):
        ctx.save_for_backward(ids)
        ctx.nrows = w.shape[0]
        if common.use_kernel(w, ids):
            return gather_kernel(w, ids)
        return gather_plain(w, ids)

    @staticmethod
    def backward(ctx, g):
        (ids,) = ctx.saved_tensors
        return scatter_add(ctx.nrows, ids, g), None


def embedding_lookup(w, ids, padding_idx=-1):
    """[V, D] row gather for arbitrary-rank integer ids ->
    ids.shape + (D,).  Out-of-range ids clip into [0, V-1] (the JAX
    package's rule); rows whose id equals padding_idx come out zero,
    masked outside the kernel (so their cotangents are zero before the
    scatter-add)."""
    d = w.shape[1]
    out = _Lookup.apply(w, ids.reshape(-1))
    out = out.reshape(tuple(ids.shape) + (d,))
    if padding_idx is not None and padding_idx >= 0:
        out = out.masked_fill((ids == padding_idx).unsqueeze(-1), 0)
    return out


# ------------------------------------------------- sparse Adagrad rows

def update_plain(w, mom, ids, g, lr, epsilon):
    """(w_out, m_out), new tensors: Adagrad over the rows of w [V, D]
    and mom [V, D] that ids [n] (clipped into [0, V-1]) name, with
    g [n, D]'s rows of each id summed in sorted order first
    (m += acc^2; w -= lr * acc / (sqrt(m) + epsilon)); every other row
    copied unchanged.  Bitwise what update_kernel writes in place."""
    uniq, acc = _run_sums(w.shape[0], ids, g)
    m_new = mom.index_select(0, uniq) + acc * acc
    w_new = w.index_select(0, uniq) - lr.reshape(()) * acc / (
        torch.sqrt(m_new) + epsilon)
    w_out, m_out = w.clone(), mom.clone()
    w_out[uniq] = w_new
    m_out[uniq] = m_new
    return w_out, m_out


def update_kernel(w, mom, ids, g, lr, epsilon):
    """The CUDA kernel: update_plain's function on one CUDA device,
    written into w and mom in place (untouched rows are not read).
    w, mom [V, D] f32 contiguous, ids [n] integer, g [n, D] f32, lr one
    f32.  The stable sort runs before the kernel."""
    if w.dim() != 2 or mom.shape != w.shape or g.dim() != 2 or \
            g.shape[1] != w.shape[1] or ids.numel() != g.shape[0]:
        raise ValueError('update_kernel takes w and mom [V, D], ids [n] and '
                         'g [n, D], got %s, %s, %s and %s'
                         % (tuple(w.shape), tuple(mom.shape),
                            tuple(ids.shape), tuple(g.shape)))
    for name, x in (('w', w), ('mom', mom), ('g', g), ('lr', lr)):
        if x.dtype != torch.float32 or x.device != w.device:
            raise TypeError('the embedding update kernel takes f32 tensors '
                            'on one device; %s has %s on %s'
                            % (name, x.dtype, x.device))
    if not (w.is_contiguous() and mom.is_contiguous()):
        raise ValueError('the embedding update kernel updates contiguous '
                         'tables in place')
    if lr.numel() != 1 or ids.device != w.device:
        raise ValueError('lr must hold one value and ids lie on %s'
                         % w.device)
    sids, order = _sorted(w.shape[0], ids)
    g = g.contiguous()
    lib = common.library(UPDATE_SOURCE)
    fn = lib.embedding_adagrad_update
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_longlong] * 2 + [
        ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    with torch.cuda.device(w.device):
        err = fn(sids.data_ptr(), order.data_ptr(), g.data_ptr(),
                 lr.data_ptr(), w.data_ptr(), mom.data_ptr(), g.shape[0],
                 g.shape[1], float(epsilon), common.stream_ptr(w.device))
    common.check_launch('embedding_update', lib, err)
    return w, mom


def apply_update(ctx, ins, attrs):
    """The fused_emb_update lowering: Param [V, D], Moment [V, D], Ids
    [...], Grad ids.shape + [D], LearningRate -> ParamOut, MomentOut.
    As in the JAX package (ops/pallas/embedding.py apply_update), ids of
    a v1 lookup_table ([..., 1]) are aligned to Grad's leading dims and
    the gradient rows of padding_idx are zeroed first (the padding row
    then takes a zero step).  On CUDA tensors the kernel updates Param
    and Moment in place; on the CPU the plain version returns new
    tensors."""
    w = ins['Param'][0]
    mom = ins['Moment'][0]
    ids = ins['Ids'][0]
    g = ins['Grad'][0]
    epsilon = attrs.get('epsilon', 1e-6)
    padding_idx = attrs.get('padding_idx', -1)
    d = w.shape[1]
    if tuple(ids.shape) != tuple(g.shape[:-1]):
        ids = ids.reshape(g.shape[:-1])
    if padding_idx is not None and padding_idx >= 0:
        g = g.masked_fill((ids == padding_idx).unsqueeze(-1), 0)
    flat_ids = ids.reshape(-1)
    flat_g = g.reshape(-1, d).to(w.dtype)
    lr = ins['LearningRate'][0]
    if common.use_kernel(w, mom, flat_ids, flat_g):
        w_out, m_out = update_kernel(w, mom, flat_ids, flat_g, lr, epsilon)
    else:
        w_out, m_out = update_plain(w, mom, flat_ids, flat_g, lr, epsilon)
    return {'ParamOut': [w_out], 'MomentOut': [m_out]}
