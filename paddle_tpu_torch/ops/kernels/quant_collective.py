"""The block-scaled int8 all-reduce (K8): the hand-written CUDA kernels
of its element phases (csrc/quant_collective.cu), their plain PyTorch
versions, and ``quant_allreduce``, which puts them around the wire.

``quantize_blocks`` and ``dequant_reduce_requant`` follow the device
rule of every kernel here: CUDA tensors launch the kernel, CPU tensors
take the plain version.  Both kernels are bitwise their plain versions
and the JAX package's (see the source's header for the two places
where that means computing what XLA compiles, not what the JAX source
writes: the scale's reciprocal multiply and the reduce's fused
multiply-adds).
"""

import ctypes

import numpy as np
import torch
import torch.nn.functional as F

from . import common
from ...distributed import wire

SOURCE = 'quant_collective.cu'
# the scale is absmax times the f32 reciprocal of 127: the JAX package
# writes absmax / 127.0, which XLA compiles into this product
INV127 = float(np.float32(1.0) / np.float32(127.0))

common.register_kernel(
    'quant_quantize',
    source=SOURCE,
    plain='ops.kernels.quant_collective.quantize_plain (absmax * f32(1/127) '
          'scale per row, round half to even, clamp to +-127)',
    replaces='paddle_tpu/ops/pallas/quant_collective.py:76 _quant_kernel',
    doc='one warp per block row: shuffle absmax, IEEE divide, rintf',
    op_types=('c_allreduce_sum', 'c_allreduce_fused'))

common.register_kernel(
    'quant_reduce',
    source=SOURCE,
    plain='ops.kernels.quant_collective.dequant_reduce_requant_plain (the '
          'ranks summed in rank order by fused multiply-adds, then '
          'quantize_plain)',
    replaces='paddle_tpu/ops/pallas/quant_collective.py:100 _reduce_kernel',
    doc='16 lanes per chunk row, 16-byte vectors of the first two shards '
        'loaded before their sums: dequantize and sum the n shards in rank '
        'order, requantize from the same registers',
    op_types=('c_allreduce_sum', 'c_allreduce_fused'))


# ------------------------------------------------------------- plain

def quantize_plain(flat2):
    """[rows, block] f32 -> ([rows, block] int8, [rows, 1] f32): per row
    s = max|x| * f32(1/127) (1 for an all-zero row), q = clip(round(x /
    s), -127, 127), rounding half to even."""
    s = flat2.abs().amax(dim=-1, keepdim=True) * INV127
    s = torch.where(s > 0, s, torch.ones_like(s))
    q = torch.clamp(torch.round(flat2 / s), -127, 127).to(torch.int8)
    return q, s


def dequant_reduce_requant_plain(qt, st):
    """([n, cb, block] int8, [n, cb, 1] f32) -> ([cb, block] int8,
    [cb, 1] f32): the dequantized shards summed in rank order as the
    fused multiply-adds acc = fma(q_r, s_r, acc), then requantized.
    Each fma is computed in f64 and rounded once to f32: q_r * s_r is
    exact in f64 (7 + 24 bits), so the f64 sum is exact, and the result
    the fma's, wherever the ranks' scales of a block lie within 2^21 of
    each other."""
    acc = qt[0].to(torch.float32) * st[0]
    for r in range(1, qt.shape[0]):
        acc = (acc.to(torch.float64) + qt[r].to(torch.float64) *
               st[r].to(torch.float64)).to(torch.float32)
    return quantize_plain(acc)


# ------------------------------------------------------------ kernels

def _fn(name, argtypes):
    lib = common.library(SOURCE)
    fn = getattr(lib, name)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return lib, fn


def quantize_kernel(flat2):
    """The CUDA kernel: [rows, block] f32 on a card -> ([rows, block]
    int8, [rows, 1] f32), bitwise equal to quantize_plain."""
    if flat2.dim() != 2 or flat2.dtype != torch.float32:
        raise TypeError('quantize_kernel takes [rows, block] f32, got %s %s'
                        % (tuple(flat2.shape), flat2.dtype))
    rows, block = flat2.shape
    if block < 8:
        raise ValueError('quant block %d < 8' % block)
    x = flat2.contiguous()
    q = torch.empty((rows, block), dtype=torch.int8, device=x.device)
    s = torch.empty((rows, 1), dtype=torch.float32, device=x.device)
    lib, fn = _fn('quant_quantize', [ctypes.c_void_p] * 3 + [
        ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p])
    with torch.cuda.device(x.device):
        err = fn(x.data_ptr(), q.data_ptr(), s.data_ptr(), rows, block,
                 common.stream_ptr(x.device))
    common.check_launch('quant_quantize', lib, err)
    return q, s


def reduce_kernel(qt, st):
    """The CUDA kernel: [n, cb, block] int8 and [n, cb, 1] f32 on one
    card -> ([cb, block] int8, [cb, 1] f32), bitwise equal to
    dequant_reduce_requant_plain."""
    if qt.dim() != 3 or qt.dtype != torch.int8:
        raise TypeError('reduce_kernel takes [n, cb, block] int8, got %s %s'
                        % (tuple(qt.shape), qt.dtype))
    n, cb, block = qt.shape
    if tuple(st.shape) != (n, cb, 1) or st.dtype != torch.float32:
        raise TypeError('reduce_kernel scales must be [%d, %d, 1] f32, got '
                        '%s %s' % (n, cb, tuple(st.shape), st.dtype))
    if block < 8:
        raise ValueError('quant block %d < 8' % block)
    if qt.device != st.device:
        raise ValueError('shards on %s, scales on %s' % (qt.device,
                                                         st.device))
    qt, st = qt.contiguous(), st.contiguous()
    qr = torch.empty((cb, block), dtype=torch.int8, device=qt.device)
    sr = torch.empty((cb, 1), dtype=torch.float32, device=qt.device)
    lib, fn = _fn('quant_reduce', [ctypes.c_void_p] * 4 + [
        ctypes.c_int, ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p])
    with torch.cuda.device(qt.device):
        err = fn(qt.data_ptr(), st.data_ptr(), qr.data_ptr(), sr.data_ptr(),
                 n, cb, block, common.stream_ptr(qt.device))
    common.check_launch('quant_reduce', lib, err)
    return qr, sr


# ------------------------------------------------------------ wrappers

def quantize_blocks(flat2):
    """[rows, block] f32 -> ([rows, block] int8, [rows, 1] f32 scales)."""
    if common.use_kernel(flat2):
        return quantize_kernel(flat2)
    return quantize_plain(flat2)


def dequant_reduce_requant(qt, st):
    """([n, cb, block] int8, [n, cb, 1] f32) -> the requantized sum over
    the n shards ([cb, block] int8, [cb, 1] f32)."""
    if common.use_kernel(qt, st):
        return reduce_kernel(qt, st)
    return dequant_reduce_requant_plain(qt, st)


def quant_allreduce(x, group, n, block):
    """The quantized all-reduce of `x` over the `n` ranks of `group`
    (the JAX package's quant_allreduce_fused): pad the flat f32 payload
    to n chunks of whole blocks, quantize, all_to_all the int8 shards
    and their scales, reduce each chunk, all_gather the requantized
    chunks and dequantize (plain PyTorch, as the JAX package leaves it
    to XLA).  Every rank gets the same result."""
    orig_shape, orig_dtype = x.shape, x.dtype
    flat = x.to(torch.float32).reshape(-1)
    size = flat.numel()
    chunk = -(-size // n)
    chunk = -(-chunk // block) * block
    total = chunk * n
    if total > size:
        flat = F.pad(flat, (0, total - size))
    cb = chunk // block
    qv, s = quantize_blocks(flat.reshape(n * cb, block))
    qt = wire.all_to_all(qv.reshape(n, cb, block), group)
    st = wire.all_to_all(s.reshape(n, cb, 1), group)
    qr, sr = dequant_reduce_requant(qt, st)
    qg = wire.all_gather(qr, group)
    sg = wire.all_gather(sr, group)
    out = (qg.to(torch.float32) * sg).reshape(-1)[:size]
    return out.reshape(orig_shape).to(orig_dtype)
