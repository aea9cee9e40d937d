"""CUDA graph conditional nodes (csrc/graph_cond.cu): the kernel that
sets a conditional node's handle from a condition tensor on the device,
and the host calls that add a WHILE or IF node to the graph being
captured and capture its body.

fluid/cuda_graph.py (``while_node``, ``if_node``) drives them while a
forward-only while or a conditional_block is captured.  The plain
version is the executor's host loop and branch
(fluid/executor.py ``_lower_while`` / ``_lower_conditional_block``),
which reads the condition on the host: there is no handle outside a
capture, so nothing here runs on the CPU.  Conditional nodes need CUDA
12.3 or later in both the driver and the runtime (``versions``).  Every
failure here raises ``ConditionalNodeError``, which a capture passes on
rather than running the step eagerly: on the card a while or a
conditional_block never falls back to the host loop.
"""

import ctypes

import torch

from . import common

SOURCE = 'graph_cond.cu'

common.register_kernel(
    'graph_cond',
    source=SOURCE,
    plain='the host-read loop and branch of fluid/executor.py '
          '_lower_while / _lower_conditional_block',
    replaces='none (the JAX package lowers while / conditional_block to '
             'lax.while_loop / lax.cond inside the XLA step, '
             'paddle_tpu/fluid/executor.py:553, :735: no Pallas kernel)',
    doc='one thread reads the 0-d condition and calls '
        'cudaGraphSetConditional; the host code adds the WHILE / IF node '
        'and captures its body into the node\'s body graph',
    op_types=())

# the condition's element kind, as the kernel reads it
_KINDS = {torch.bool: 0, torch.uint8: 0, torch.int8: 0, torch.int32: 1,
          torch.int64: 2, torch.float32: 3, torch.float64: 4,
          torch.float16: 5, torch.bfloat16: 5}

# the body's capture mode: cudaStreamCaptureModeGlobal, torch.cuda.graph's
# default for the graph the node is added to
_CAPTURE_MODE_GLOBAL = 0

_SIGNED = False
# the versions passed require_conditional_nodes
_SUPPORTED = False


class ConditionalNodeError(RuntimeError):
    """A conditional node could not be built, added to the graph being
    captured or launched: the capture raises it on, and no step runs
    the host loop in its place."""


def _lib():
    global _SIGNED
    try:
        lib = common.library(SOURCE)
    except Exception as e:
        raise ConditionalNodeError('graph_cond: %s did not build or load: '
                                   '%s: %s' % (SOURCE, type(e).__name__,
                                               e)) from e
    if not _SIGNED:
        p, u64 = ctypes.c_void_p, ctypes.c_ulonglong
        lib.graph_cond_versions.argtypes = [ctypes.POINTER(ctypes.c_int)] * 2
        lib.graph_cond_handle.argtypes = [p, ctypes.POINTER(u64)]
        lib.graph_cond_set.argtypes = [u64, p, ctypes.c_int, p]
        lib.graph_cond_node.argtypes = [p, u64, ctypes.c_int, p,
                                        ctypes.c_int]
        lib.graph_cond_end.argtypes = [p]
        for fn in (lib.graph_cond_versions, lib.graph_cond_handle,
                   lib.graph_cond_set, lib.graph_cond_node,
                   lib.graph_cond_end):
            fn.restype = ctypes.c_int
        _SIGNED = True
    return lib


def _check(lib, err, what):
    if err != 0:
        lib.cuda_error_string.argtypes = [ctypes.c_int]
        lib.cuda_error_string.restype = ctypes.c_char_p
        raise ConditionalNodeError('graph_cond %s failed: CUDA error %d '
                                   '(%s)' % (
            what, err, lib.cuda_error_string(err).decode()))


def versions():
    """(driver, runtime) CUDA versions, as 1000 * major + 10 * minor."""
    lib = _lib()
    d, r = ctypes.c_int(0), ctypes.c_int(0)
    _check(lib, lib.graph_cond_versions(ctypes.byref(d), ctypes.byref(r)),
           'version query')
    return d.value, r.value


def require_conditional_nodes():
    """Raise unless both the driver and the runtime have conditional
    nodes (CUDA 12.3)."""
    global _SUPPORTED
    if _SUPPORTED:
        return
    d, r = versions()
    if min(d, r) < 12030:
        raise ConditionalNodeError(
            'CUDA graph conditional nodes need CUDA 12.3 or later in the '
            'driver and the runtime; this process has driver %d, runtime '
            '%d' % (d, r))
    _SUPPORTED = True


def create_handle(stream):
    """A conditional handle in the graph being captured on `stream`,
    reset to 0 at each launch of the graph."""
    lib = _lib()
    h = ctypes.c_ulonglong(0)
    _check(lib, lib.graph_cond_handle(ctypes.c_void_p(stream.cuda_stream),
                                      ctypes.byref(h)), 'handle')
    return h.value


def set_cond(handle, pred):
    """Launch the kernel that sets `handle` from the condition tensor
    `pred` (its first element, non-zero as bool() of it) on the current
    stream."""
    if not pred.is_cuda:
        raise ConditionalNodeError('graph_cond: the condition must lie on '
                                   'the card, not on %s' % pred.device)
    kind = _KINDS.get(pred.dtype)
    if kind is None:
        raise ConditionalNodeError('graph_cond: a %s condition'
                                   % pred.dtype)
    if pred.numel() < 1:
        raise ConditionalNodeError('graph_cond: an empty condition')
    lib = _lib()
    err = lib.graph_cond_set(ctypes.c_ulonglong(handle),
                             ctypes.c_void_p(pred.data_ptr()), kind,
                             common.stream_ptr(pred.device))
    try:
        common.check_launch('graph_cond', lib, err)
    except RuntimeError as e:
        raise ConditionalNodeError(str(e)) from e


def begin_body(stream, handle, is_while, body_stream):
    """Add a WHILE (`is_while`) or IF node on `handle` after the work
    captured on `stream` so far, make it the capture's one dependency,
    and begin capturing `body_stream` into the node's body graph."""
    lib = _lib()
    _check(lib, lib.graph_cond_node(
        ctypes.c_void_p(stream.cuda_stream), ctypes.c_ulonglong(handle),
        1 if is_while else 0, ctypes.c_void_p(body_stream.cuda_stream),
        _CAPTURE_MODE_GLOBAL), 'node')


def end_body(body_stream):
    """End the capture of a conditional node's body on `body_stream`."""
    lib = _lib()
    _check(lib, lib.graph_cond_end(ctypes.c_void_p(body_stream.cuda_stream)),
           'body capture end')
