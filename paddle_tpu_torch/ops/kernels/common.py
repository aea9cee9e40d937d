"""Shared plumbing for the CUDA kernel library: the kernel registry with
per-kernel launch counters, the device dispatch rule, and the build of
each kernel's shared library from the sources in ``csrc/``.

Dispatch rule: a wrapper launches its kernel for every CUDA tensor and
runs its plain PyTorch version only for a tensor on the CPU (or the
meta device, for graph-build shape inference).  There are no size
floors and no quiet fallback: a build or launch failure raises.
``FLAGS_torch_kernels_plain`` is a test-only switch that sends CUDA
tensors to the plain versions too, so a whole path can be held against
its plain twin on the card.

Launch counts: each wrapper counts its launch at Python time
(``launches``).  While a CUDA graph is captured (fluid/cuda_graph.py)
the launches go into the graph's manifest instead
(``recording_launches``), and each replay adds the manifest to a count
of its own (``add_replays``, ``replayed``): a replay runs no wrapper,
so what it launched is known from its capture, not measured.

Host data a kernel reads (the optimizer kernels' pointer tables) goes
to the device through ``upload``: queued from pinned memory on the
current stream, or, while a graph is captured, into a buffer allocated
on the stream the graph replays on (outside the graph's memory pool,
whose blocks the graph's own kernels reuse) and filled once after the
capture: a captured copy would read host memory that is freed after it.

Build: ``nvcc -O3 -gencode=arch=compute_90a,code=sm_90a`` compiles each
``csrc/<name>.cu`` into ``<build dir>/<name>-<source hash>.so``, a
library with a plain C interface loaded through ctypes; a source may
add flags of its own (``SOURCE_FLAGS``), and the hash covers the shared
``csrc/*.cuh`` headers.  The kernels build at first use; ``build()``
starts every missing build at once.
"""

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess

import numpy as np
import torch

from ...fluid.flags import get_flag

CSRC_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), 'csrc')
_CHECKOUT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__)))))

NVCC_FLAGS = ('-O3', '-gencode=arch=compute_90a,code=sm_90a', '-std=c++17',
              '-shared', '-Xcompiler', '-fPIC')
# flags of one source on top of NVCC_FLAGS: the optimizer kernels and
# K8 round every operation as their plain versions' separate kernels do
SOURCE_FLAGS = {'fused_adam.cu': ('--fmad=false',),
                'fused_lamb.cu': ('--fmad=false',),
                'embedding_update.cu': ('--fmad=false',),
                'quant_collective.cu': ('--fmad=false',)}

# kernel registry: name -> descriptor (source, plain version, TPU kernel
# it replaces, op types it serves, launch count).  Populated by each
# kernel module at import.
KERNELS = {}

_LIBS = {}  # source name -> ctypes.CDLL


def register_kernel(name, source, plain, replaces, doc='', op_types=()):
    """Declare a kernel: ``source`` is its file under csrc/, ``plain``
    names its plain PyTorch version (the CPU path and the reference it
    is held against), ``replaces`` the Pallas kernel it ports."""
    if not plain:
        raise ValueError('kernel %r must declare its plain version'
                         % (name,))
    KERNELS[name] = {'source': source, 'plain': plain,
                     'replaces': replaces, 'doc': doc,
                     'op_types': tuple(op_types), 'launches': 0,
                     'replayed': 0}
    return name


def kernels():
    return {k: dict(v) for k, v in KERNELS.items()}


def covering_kernel(op_types):
    """Name of the registered kernel whose declared ``op_types``
    coverage subsumes every type in `op_types`, or None: fluid.opprof's
    'already served by a kernel' cross-reference (JAX:
    ops/pallas/common.py:70).  Deterministic: first match in sorted
    registry order.  Each kernel declares only the op types whose runs
    it launches for in this package: a run the port serves with torch
    ops (the unfused attention chain, a lone optimizer op) stays
    uncovered, where the JAX package may name a kernel."""
    ts = set(op_types)
    if not ts:
        return None
    for name in sorted(KERNELS):
        cover = set(KERNELS[name].get('op_types') or ())
        if cover and ts <= cover:
            return name
    return None


class Recording(object):
    """What the capture of a CUDA graph recorded: ``launches``, its
    launch manifest {kernel: launches} (a launch into a capturing stream
    does not run, so it is counted at each replay: add_replays), and
    ``uploads``, (device buffer, host array) for each ``upload`` made
    during it, the buffers allocated on ``stream``, the stream the graph
    replays on, for the capturer to fill once after the capture."""

    __slots__ = ('launches', 'uploads', 'stream')

    def __init__(self, stream):
        self.launches = {}
        self.uploads = []
        self.stream = stream


# the Recording of the CUDA graph being captured, or None
_recording = None


def count_launch(name):
    if _recording is not None:
        _recording.launches[name] = _recording.launches.get(name, 0) + 1
    else:
        KERNELS[name]['launches'] += 1


@contextlib.contextmanager
def recording_launches(stream=None):
    """Inside, launches go into the yielded Recording instead of the
    counters, and uploads into buffers allocated on `stream` (a CUDA
    graph's capture, which replays on `stream`)."""
    global _recording
    saved, _recording = _recording, Recording(stream)
    try:
        yield _recording
    finally:
        _recording = saved


@contextlib.contextmanager
def sub_recording():
    """Inside, launches go into the yielded Recording of their own (the
    body of a conditional node, which runs a number of times a replay
    that only the replay knows); uploads go where the enclosing
    capture's go."""
    global _recording
    parent = _recording
    _recording = Recording(parent.stream)
    _recording.uploads = parent.uploads
    try:
        yield _recording
    finally:
        _recording = parent


def recording():
    """The Recording of the CUDA graph being captured, or None."""
    return _recording


def upload(array, device):
    """The host numpy `array` on `device`, for a kernel to read: a copy
    queued from pinned memory on the current stream, or, during a
    capture, a buffer allocated on the recording's stream, which the
    capturer fills before the first replay."""
    array = np.ascontiguousarray(array)
    if _recording is None:
        return torch.from_numpy(array).pin_memory().to(device,
                                                        non_blocking=True)
    with torch.cuda.stream(_recording.stream):
        buf = torch.empty(array.shape, device=device,
                          dtype=torch.from_numpy(array[:0]).dtype)
    _recording.uploads.append((buf, array.copy()))
    return buf


def add_replays(manifest):
    """Count a replay of a captured graph: its manifest's launches, as
    replayed launches."""
    for name, n in manifest.items():
        KERNELS[name]['replayed'] += n


def launches(name):
    return KERNELS[name]['launches']


def replayed(name):
    return KERNELS[name]['replayed']


def reset_launches():
    for info in KERNELS.values():
        info['launches'] = 0
        info['replayed'] = 0


def report():
    """Per-kernel registration, launch and replayed-launch counts
    (empty when nothing has launched)."""
    out = {name: {'source': info['source'], 'plain': info['plain'],
                  'replaces': info['replaces'],
                  'op_types': list(info['op_types']),
                  'launches': info['launches'],
                  'replayed': info['replayed']}
           for name, info in sorted(KERNELS.items())
           if info['launches'] or info['replayed']}
    return {'kernels': out} if out else {}


def use_kernel(*tensors):
    """True: launch the CUDA kernel; False: run the plain version.
    Every tensor must lie on one device type; CUDA tensors launch the
    kernel (unless the test-only plain switch is on), CPU and meta
    tensors take the plain version, anything else raises."""
    kinds = {t.device.type for t in tensors if t is not None}
    if len(kinds) != 1:
        raise ValueError('kernel inputs on mixed devices: %s'
                         % sorted(kinds))
    kind = kinds.pop()
    if kind == 'cuda':
        return not get_flag('FLAGS_torch_kernels_plain', False)
    if kind in ('cpu', 'meta'):
        return False
    raise ValueError('no kernel or plain version for device %r' % kind)


# ---------------------------------------------------------------- build

def build_dir():
    return get_flag('FLAGS_torch_kernel_build_dir') or os.path.join(
        _CHECKOUT, 'build', 'torch_kernels')


def _nvcc():
    for home in (os.environ.get('CUDA_HOME'), os.environ.get('CUDA_PATH')):
        if home and os.path.exists(os.path.join(home, 'bin', 'nvcc')):
            return os.path.join(home, 'bin', 'nvcc')
    found = shutil.which('nvcc')
    if found:
        return found
    if os.path.exists('/usr/local/cuda/bin/nvcc'):
        return '/usr/local/cuda/bin/nvcc'
    raise RuntimeError('nvcc not found (set CUDA_HOME): the CUDA kernels '
                       'are built from ops/kernels/csrc at first use')


def _flags(source):
    return list(NVCC_FLAGS) + list(SOURCE_FLAGS.get(source, ()))


def _lib_path(source):
    src = os.path.join(CSRC_DIR, source)
    digest = hashlib.sha1(' '.join(_flags(source)).encode())
    headers = sorted(n for n in os.listdir(CSRC_DIR) if n.endswith('.cuh'))
    for path in [src] + [os.path.join(CSRC_DIR, n) for n in headers]:
        with open(path, 'rb') as f:
            digest.update(f.read())
    stem = os.path.splitext(source)[0]
    return src, os.path.join(build_dir(), '%s-%s.so'
                             % (stem, digest.hexdigest()[:12]))


def build(sources=None):
    """Compile every missing library among `sources` (default: every
    registered kernel's), one nvcc process per source, all started
    together.  Raises with the compiler's output if one fails."""
    if sources is None:
        sources = sorted({k['source'] for k in KERNELS.values()})
    os.makedirs(build_dir(), exist_ok=True)
    procs = []
    try:
        for source in sources:
            src, lib = _lib_path(source)
            if os.path.exists(lib):
                continue
            tmp = '%s.tmp-%d' % (lib, os.getpid())
            cmd = [_nvcc()] + _flags(source) + ['-o', tmp, src]
            procs.append((source, lib, tmp, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)))
        failed = []
        for source, lib, tmp, p in procs:
            out, _ = p.communicate()
            if p.returncode != 0:
                failed.append('%s:\n%s' % (source, out.decode(errors='replace')))
            else:
                os.replace(tmp, lib)
        if failed:
            raise RuntimeError('nvcc failed for ' + '\n'.join(failed))
    finally:
        for _, _, tmp, p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
            if os.path.exists(tmp):
                os.unlink(tmp)


def library(source):
    """The loaded ctypes library built from csrc/`source`."""
    lib = _LIBS.get(source)
    if lib is None:
        _, path = _lib_path(source)
        if not os.path.exists(path):
            build([source])
        lib = _LIBS[source] = ctypes.CDLL(path)
    return lib


def check_launch(name, lib, err, count=True):
    """Raise if the C launcher in `lib` returned a CUDA error; count
    the launch otherwise (unless `count` is false: a launcher that is
    one step of a kernel's launch)."""
    if err != 0:
        lib.cuda_error_string.argtypes = [ctypes.c_int]
        lib.cuda_error_string.restype = ctypes.c_char_p
        raise RuntimeError('%s kernel launch failed: CUDA error %d (%s)' % (
            name, err, lib.cuda_error_string(err).decode()))
    if count:
        count_launch(name)


def stream_ptr(device):
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)
