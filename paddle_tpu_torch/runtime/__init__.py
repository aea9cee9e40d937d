"""The native MultiSlot feeder (ctypes over a library g++ builds from
datafeed.cc at first use; JAX: runtime/__init__.py:45-101 and
runtime/datafeed.cc).

Reference native components being replaced: framework/data_feed.* (C++
multithreaded readers), framework/channel.h,
operators/reader/lod_tensor_blocking_queue.h.

Build: ``g++ -O2 -std=c++17 -fPIC -pthread -shared`` compiles
datafeed.cc into ``<checkout>/build/torch_runtime/libptfeed-<source
hash>.so`` (or ``FLAGS_torch_runtime_build_dir``), written to a
temporary name of the process and thread and renamed into place, so
processes and threads building at once (test workers) never load a
torn file; it never writes inside the package.  Nothing is built at
import.
"""

import ctypes
import hashlib
import os
import subprocess
import threading

import torch

from ..fluid.flags import get_flag

_DIR = os.path.dirname(os.path.abspath(__file__))
_SOURCE = os.path.join(_DIR, 'datafeed.cc')
_CHECKOUT = os.path.dirname(os.path.dirname(_DIR))
CXX_FLAGS = ('-O2', '-std=c++17', '-fPIC', '-pthread', '-shared')
_lib = None


def build_dir():
    return get_flag('FLAGS_torch_runtime_build_dir') or os.path.join(
        _CHECKOUT, 'build', 'torch_runtime')


def library_path():
    digest = hashlib.sha1(' '.join(CXX_FLAGS).encode())
    with open(_SOURCE, 'rb') as f:
        digest.update(f.read())
    return os.path.join(build_dir(),
                        'libptfeed-%s.so' % digest.hexdigest()[:12])


def build():
    """The feeder library's path, built first when it is missing."""
    path = library_path()
    if os.path.exists(path):
        return path
    os.makedirs(build_dir(), exist_ok=True)
    tmp = '%s.tmp-%d-%d' % (path, os.getpid(), threading.get_ident())
    try:
        out = subprocess.run(
            [os.environ.get('CXX', 'g++')] + list(CXX_FLAGS) +
            ['-o', tmp, _SOURCE], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, timeout=300)
        if out.returncode != 0:
            raise RuntimeError('g++ failed for %s:\n%s' % (
                _SOURCE, out.stdout.decode(errors='replace')))
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return path


def _load():
    global _lib
    if _lib is not None:
        return _lib
    lib = ctypes.CDLL(build())
    lib.ptfeed_create.restype = ctypes.c_void_p
    lib.ptfeed_create.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, ctypes.c_char_p,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_uint64]
    lib.ptfeed_next.restype = ctypes.c_int
    lib.ptfeed_next.argtypes = [ctypes.c_void_p,
                                ctypes.POINTER(ctypes.c_void_p)]
    lib.ptfeed_dense_dim.restype = ctypes.c_int
    lib.ptfeed_dense_dim.argtypes = [ctypes.c_void_p]
    lib.ptfeed_sparse_dim.restype = ctypes.c_int
    lib.ptfeed_sparse_dim.argtypes = [ctypes.c_void_p]
    lib.ptfeed_destroy.argtypes = [ctypes.c_void_p]
    _lib = lib
    return lib


class MultiSlotDataFeed(object):
    """Native multithreaded MultiSlot-format feeder.

    slots: [(name, 'dense'|'sparse', dim)]: dense slots are float
    vectors of exactly `dim`; sparse slots are id lists padded/truncated
    to `dim` with -1.  Each batch is {name: CPU tensor [n, dim]} (f32
    dense, int64 sparse), n <= batch_size; with `pin` the tensors are
    pinned host memory, which the feeder writes directly."""

    def __init__(self, files, slots, batch_size, nthreads=4,
                 shuffle_buffer=0, seed=0, pin=False):
        lib = _load()
        self._lib = lib
        self.slots = list(slots)
        self.batch_size = batch_size
        self._pin = bool(pin)
        arr = (ctypes.c_char_p * len(files))(
            *[f.encode() for f in files])
        spec = ','.join('%s:%s:%d' % s for s in slots).encode()
        self._h = lib.ptfeed_create(arr, len(files), spec, batch_size,
                                    nthreads, shuffle_buffer, seed)

    def __iter__(self):
        return self

    def __next__(self):
        bufs = [torch.empty((self.batch_size, dim),
                            dtype=torch.float32 if kind == 'dense'
                            else torch.int64, pin_memory=self._pin)
                for _, kind, dim in self.slots]
        ptrs = (ctypes.c_void_p * len(bufs))(*[b.data_ptr() for b in bufs])
        n = self._lib.ptfeed_next(self._h, ptrs)
        if n == 0:
            raise StopIteration
        return {name: b[:n] for (name, _, _), b in zip(self.slots, bufs)}

    def close(self):
        if self._h:
            self._lib.ptfeed_destroy(self._h)
            self._h = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
