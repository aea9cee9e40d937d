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

Build: ``nvcc -O3 -gencode=arch=compute_90a,code=sm_90a`` compiles each
``csrc/<name>.cu`` into ``<build dir>/<name>-<source hash>.so``, a
library with a plain C interface loaded through ctypes; a source may
add flags of its own (``SOURCE_FLAGS``), and the hash covers the shared
``csrc/*.cuh`` headers.  The kernels build at first use; ``build()``
starts every missing build at once.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess

import torch

from ...fluid.flags import get_flag

CSRC_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), 'csrc')
_CHECKOUT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__)))))

NVCC_FLAGS = ('-O3', '-gencode=arch=compute_90a,code=sm_90a', '-std=c++17',
              '-shared', '-Xcompiler', '-fPIC')
# flags of one source on top of NVCC_FLAGS: the optimizer kernels round
# every operation as their plain versions' separate kernels do
SOURCE_FLAGS = {'fused_adam.cu': ('--fmad=false',),
                'fused_lamb.cu': ('--fmad=false',),
                'embedding_update.cu': ('--fmad=false',)}

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
                     'op_types': tuple(op_types), 'launches': 0}
    return name


def kernels():
    return {k: dict(v) for k, v in KERNELS.items()}


def count_launch(name):
    KERNELS[name]['launches'] += 1


def launches(name):
    return KERNELS[name]['launches']


def reset_launches():
    for info in KERNELS.values():
        info['launches'] = 0


def report():
    """Per-kernel registration and launch counts (empty when nothing
    has launched)."""
    out = {name: {'source': info['source'], 'plain': info['plain'],
                  'replaces': info['replaces'],
                  'op_types': list(info['op_types']),
                  'launches': info['launches']}
           for name, info in sorted(KERNELS.items()) if info['launches']}
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


def check_launch(name, lib, err):
    """Raise if the C launcher in `lib` returned a CUDA error; count
    the launch otherwise."""
    if err != 0:
        lib.cuda_error_string.argtypes = [ctypes.c_int]
        lib.cuda_error_string.restype = ctypes.c_char_p
        raise RuntimeError('%s kernel launch failed: CUDA error %d (%s)' % (
            name, err, lib.cuda_error_string(err).decode()))
    count_launch(name)


def stream_ptr(device):
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)
