"""The dropout op's forward and its gradient as CUDA kernels
(csrc/dropout_mask.cu), their plain PyTorch versions (``hash_keep`` and
the op's formula) and the ``torch.autograd.Function`` that joins them.

The keep mask is a counter hash of each element's index under a seed on
the device: element i of the flattened input keeps where the murmur3
finalizer of (i * 0x9E3779B1) ^ seed has its top 24 bits below
round((1 - p) * 2**24).  Out is, in the input's dtype,

- ``upscale_in_train``: where(keep, x / max(1 - p, 1e-8), 0), an IEEE
  division in f32 (bf16 inputs divided in f32 and rounded once), so a
  dropped NaN gives 0;
- ``downgrade_in_infer``: x * mask, a multiply, so NaN * 0 stays NaN;

and Mask is the keep mask in the input's dtype, written only where the
caller asks for it (the op's lowering asks where something reads Mask).
The gradient is the same formula over dOut: the backward keeps the 0-d
seed, not Mask, and computes the keep bits again (``dropout_grad_kernel``
on the card, ``dropout_grad_plain`` on the CPU), bit for bit what
autograd gives for the plain formula.
"""

import ctypes

import torch

from . import common

SOURCE = 'dropout_mask.cu'

common.register_kernel(
    'dropout',
    source=SOURCE,
    plain='ops.kernels.dropout.dropout_plain (hash_keep, then the op\'s '
          'formula in PyTorch ops)',
    replaces='none (the JAX dropout op draws jax.random.bernoulli inside '
             'the XLA step, paddle_tpu/ops/nn_ops.py:464-479: no Pallas '
             'kernel)',
    doc='one pass over 16-byte vectors of X in one wave of blocks: the '
        'counter hash, Out, and Mask only where it is read, the seed read '
        'from device memory',
    op_types=('dropout',))

common.register_kernel(
    'dropout_grad',
    source=SOURCE,
    plain='ops.kernels.dropout.dropout_grad_plain (hash_keep, then the '
          'op\'s formula over dOut in PyTorch ops)',
    replaces='none (the gradient of the JAX dropout op is XLA\'s, '
             'paddle_tpu/ops/nn_ops.py:464-479: no Pallas kernel)',
    doc='one pass over 16-byte vectors of dOut: the keep bits computed '
        'again from the seed the forward saved, dX written',
    op_types=('dropout',))

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _i32(c):
    """The int32 with the bits of the uint32 constant c."""
    return c - (1 << 32) if c >= 1 << 31 else c


def keep_threshold(rate):
    """The 24-bit keep threshold of dropout rate `rate`."""
    return int(round((1.0 - float(rate)) * (1 << 24)))


def _count(shape):
    n = 1
    for s in shape:
        n *= int(s)
    if n >= 1 << 31:
        raise ValueError('dropout over %d elements: the counter hash '
                         'indexes them in int32' % n)
    return n


def hash_bits(seed, shape, device):
    """[shape] int32 in [0, 2**24): the top 24 bits of the murmur3
    finalizer of (i * 0x9E3779B1) ^ seed for element i, a uint32.
    `seed` is a 0-d int64 tensor in [0, 2**32) on `device`, so the bits
    are a function of device values alone (a CUDA graph replays them
    with the step of each replay).  The arithmetic is int32 with
    two's-complement wraparound, as PyTorch's integer kernels give it on
    the CPU and the card alike (the int64 seed's conversion keeps its low
    32 bits); right shifts are masked to be logical."""
    n = _count(shape)
    h = torch.arange(n, dtype=torch.int32, device=device) * \
        _i32(0x9E3779B1)
    h ^= seed.to(torch.int32)
    h ^= (h >> 16) & 0xFFFF
    h *= _i32(0x7FEB352D)
    h ^= (h >> 15) & 0x1FFFF
    h *= _i32(0x846CA68B)
    h ^= (h >> 16) & 0xFFFF
    return ((h >> 8) & 0xFFFFFF).reshape(tuple(shape))


def hash_keep(seed, shape, rate, device):
    """[shape] bool keep mask of the dropout op: element i keeps where
    its ``hash_bits`` are below the keep threshold of 1 - rate."""
    return hash_bits(seed, shape, device) < keep_threshold(rate)


def _scale(rate, like):
    """max(1 - rate, 1e-8) as a 0-d tensor of the op's arithmetic type
    (f64 for f64 inputs, else f32) on `like`'s device: a tensor, not a
    Python number, so the card divides by it (PyTorch multiplies by the
    reciprocal of a host scalar there)."""
    dt = torch.float64 if like.dtype == torch.float64 else torch.float32
    return torch.full((), max(1.0 - float(rate), 1e-8), dtype=dt,
                      device=like.device)


def dropout_plain(x, seed, rate, upscale):
    """(Out, Mask) of the dropout op in PyTorch ops: the kernel's plain
    version and the CPU path."""
    return apply_keep(x, hash_keep(seed, x.shape, rate, x.device), rate,
                      upscale)


def apply_keep(x, keep, rate, upscale):
    """(Out, Mask) of the dropout op from its bool keep mask."""
    mask = keep.to(x.dtype)
    if upscale:
        s = _scale(rate, x)
        out = torch.where(keep, (x.to(s.dtype) / s).to(x.dtype),
                          torch.zeros_like(x))
    else:
        out = x * mask
    return out, mask


def _check(x, seed, what):
    """Raise on what the kernels do not take: x f32 or bf16, and the 0-d
    int64 seed on x's device."""
    if x.dtype not in _DTYPES:
        raise TypeError('the dropout %s takes f32 or bf16, got %s'
                        % (what, x.dtype))
    if seed.dim() != 0 or seed.dtype != torch.int64 or \
            seed.device != x.device:
        raise ValueError('seed must be a 0-d int64 tensor on %s, got %s %s '
                         'on %s' % (x.device, tuple(seed.shape), seed.dtype,
                                    seed.device))


def dropout_kernel(x, seed, rate, upscale, write_mask=True):
    """The forward kernel: x (f32 or bf16, copied first when it is not
    contiguous) and the 0-d int64 seed on one CUDA device -> (Out, Mask),
    bitwise equal to dropout_plain; Mask is None, and not written, unless
    `write_mask`."""
    _check(x, seed, 'kernel')
    n = _count(x.shape)
    x = x.contiguous()
    out = torch.empty_like(x)
    mask = torch.empty_like(x) if write_mask else None
    lib = common.library(SOURCE)
    fn = lib.dropout_mask
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p,
                   ctypes.c_uint, ctypes.c_float, ctypes.c_int,
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int
    with torch.cuda.device(x.device):
        err = fn(x.data_ptr(), out.data_ptr(),
                 None if mask is None else mask.data_ptr(), n,
                 _DTYPES[x.dtype], seed.data_ptr(), keep_threshold(rate),
                 max(1.0 - float(rate), 1e-8), int(bool(upscale)),
                 common.stream_ptr(x.device))
    common.check_launch('dropout', lib, err)
    return out, mask


def dropout_grad_kernel(g, seed, rate, upscale):
    """The gradient kernel: dOut `g` (f32 or bf16, copied first when it
    is not contiguous) and the forward's 0-d int64 seed on one CUDA
    device -> dX, the keep bits computed again; bitwise equal to
    dropout_grad_plain."""
    _check(g, seed, 'gradient kernel')
    n = _count(g.shape)
    g = g.contiguous()
    dx = torch.empty_like(g)
    lib = common.library(SOURCE)
    fn = lib.dropout_grad
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
                   ctypes.c_int, ctypes.c_void_p, ctypes.c_uint,
                   ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    with torch.cuda.device(g.device):
        err = fn(g.data_ptr(), dx.data_ptr(), n, _DTYPES[g.dtype],
                 seed.data_ptr(), keep_threshold(rate),
                 max(1.0 - float(rate), 1e-8), int(bool(upscale)),
                 common.stream_ptr(g.device))
    common.check_launch('dropout_grad', lib, err)
    return dx


def dropout_grad(g, mask, rate, upscale):
    """The gradient of Out with respect to X from the op's Mask."""
    if upscale:
        s = _scale(rate, g)
        return torch.where(mask != 0, (g.to(s.dtype) / s).to(g.dtype),
                           torch.zeros_like(g))
    return g * mask


def dropout_grad_plain(g, seed, rate, upscale):
    """The gradient kernel's plain version and the CPU path: the keep
    bits of `seed` (hash_keep), then dropout_grad's formula."""
    keep = hash_keep(seed, g.shape, rate, g.device)
    return dropout_grad(g, keep.to(g.dtype), rate, upscale)


class _Dropout(torch.autograd.Function):
    """The op's forward and gradient: the kernels for CUDA tensors, the
    plain versions for CPU ones.  The backward keeps the 0-d seed, not
    Mask."""

    @staticmethod
    def forward(ctx, x, seed, rate, upscale, write_mask):
        if common.use_kernel(x, seed):
            out, mask = dropout_kernel(x, seed, rate, upscale, write_mask)
        else:
            out, mask = dropout_plain(x, seed, rate, upscale)
            if not write_mask:
                mask = None
        ctx.save_for_backward(seed)
        ctx.rate, ctx.upscale = rate, upscale
        if mask is not None:
            ctx.mark_non_differentiable(mask)
        return out, mask

    @staticmethod
    def backward(ctx, g, _):
        seed, = ctx.saved_tensors
        if common.use_kernel(g, seed):
            dx = dropout_grad_kernel(g, seed, ctx.rate, ctx.upscale)
        else:
            dx = dropout_grad_plain(g, seed, ctx.rate, ctx.upscale)
        return dx, None, None, None, None


def dropout(x, seed, rate, upscale, write_mask=True):
    """(Out, Mask) of the dropout op in training, differentiable in x:
    the kernels for a CUDA tensor, the plain versions for a CPU one.
    Mask is None unless `write_mask`."""
    return _Dropout.apply(x, seed, float(rate), bool(upscale),
                          bool(write_mask))
