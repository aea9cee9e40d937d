"""The multi-tensor finite check (csrc/finite_check.cu) and its plain
PyTorch version: one byte per tensor, 1 where every element is finite.

``FLAGS_check_nan_inf`` collects the floating values a step writes and
checks them in one launch at the end of the step (fluid/executor.py
``_raise_non_finite``; inside a CUDA graph, in the graph), so the host
reads one buffer of verdicts a step.  A tensor whose elements do not
fill one dense range of memory is checked through a contiguous copy;
one that does (a permuted or contiguous tensor) is read in place, in
storage order: the verdict does not depend on the order.
"""

import ctypes

import numpy as np
import torch

from . import common

SOURCE = 'finite_check.cu'

common.register_kernel(
    'finite_check',
    source=SOURCE,
    plain='ops.kernels.finite_check.finite_check_plain (torch.stack of '
          'isfinite(t).all() per tensor)',
    replaces='none (the JAX package reduces isfinite inside its XLA '
             'segment, paddle_tpu/fluid/executor.py:2578 _check_nan_inf: '
             'no Pallas kernel)',
    doc='one launch over a device table of tensors: a block per 16384 '
        'elements of one tensor, 16-byte loads, exponent-bit tests, a '
        'byte per tensor cleared by any block that finds a non-finite '
        'element',
    op_types=())

# the element kinds the kernel reads
KINDS = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2,
         torch.float64: 3}
CHUNK = 16384  # elements a block checks (finite_check.cu kChunk)

_SIGNED = False


def finite_check_plain(tensors, device=None):
    """uint8 [len(tensors)]: 1 where the tensor is all finite."""
    if not tensors:
        return torch.ones(0, dtype=torch.uint8, device=device)
    return torch.stack([torch.isfinite(t).all() for t in tensors]).to(
        torch.uint8)


def _lib():
    global _SIGNED
    lib = common.library(SOURCE)
    if not _SIGNED:
        p = ctypes.c_void_p
        lib.finite_check_launch.argtypes = [p, ctypes.c_int,
                                            ctypes.c_longlong, p, p]
        lib.finite_check_launch.restype = ctypes.c_int
        lib.finite_check_chunk.restype = ctypes.c_longlong
        if lib.finite_check_chunk() != CHUNK:
            raise RuntimeError('finite_check.cu checks %d elements a block, '
                               'the wrapper %d' % (lib.finite_check_chunk(),
                                                   CHUNK))
        _SIGNED = True
    return lib


def dense(t):
    """Whether `t`'s elements fill one range of memory without overlap
    (contiguous in some order of its dimensions)."""
    expect = 1
    for stride, size in sorted((st, sz) for st, sz in zip(t.stride(), t.shape)
                               if sz != 1):
        if stride != expect:
            return False
        expect *= size
    return True


def table(tensors):
    """(rows, blocks, kept): the kernel's [N, 4] int64 table (pointer,
    elements, kind, first block), the blocks of the launch and the
    contiguous copies it reads, which must live until it has run."""
    rows = np.zeros((len(tensors), 4), dtype=np.int64)
    kept, first = [], 0
    for i, t in enumerate(tensors):
        kind = KINDS.get(t.dtype)
        if kind is None:
            raise TypeError('finite_check takes f32, bf16, f16 and f64 '
                            'tensors, not %s' % t.dtype)
        if not dense(t):
            t = t.contiguous()
            kept.append(t)
        n = t.numel()
        rows[i] = (t.data_ptr() if n else 0, n, kind, first)
        first += -(-n // CHUNK)
    return rows, first, kept


def finite_check(tensors, device=None):
    """uint8 [len(tensors)] on the tensors' device: 1 where every element
    of the tensor is finite (an empty tensor is).  CUDA tensors launch
    the kernel, CPU tensors take the plain version."""
    tensors = [t.detach() for t in tensors]
    if not tensors:
        return finite_check_plain(tensors, device)
    if not common.use_kernel(*tensors):
        return finite_check_plain(tensors)
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev:
            raise ValueError('finite_check: tensors on %s and %s'
                             % (dev, t.device))
    rows, blocks, kept = table(tensors)
    out = torch.ones(len(tensors), dtype=torch.uint8, device=dev)
    if blocks == 0:
        return out
    rows_dev = common.upload(rows, dev)
    lib = _lib()
    err = lib.finite_check_launch(ctypes.c_void_p(rows_dev.data_ptr()),
                                  len(tensors), blocks,
                                  ctypes.c_void_p(out.data_ptr()),
                                  common.stream_ptr(dev))
    common.check_launch('finite_check', lib, err)
    del kept
    return out
