"""The redesigned multi-tensor Adam (K4: 16-byte vectors staged in
registers, tiles cut at each tensor's 16-byte offset, scalar heads and
tails) and K8's dequant-reduce-requant (16 lanes a row, 16-byte vectors,
sums kept in registers for the requantize) against their plain PyTorch
versions on the card, bitwise, at the edge cases of their designs:
contiguous views at element offsets 1, 2 and 3, pointers of one tensor
at different offsets, sizes 1, 3, 5, 8191 and 8193, a run of 200 tiny
tensors, per-tensor learning rates and beta powers; blocks 8, 9, 200,
256, 1024 and 4096 at n = 1, 2, 3 and 8, an all-zero row, a row whose
absmax is its last element, one row, and shards that do not start on
16 bytes; and the reduce's quotient (the row scale's reciprocal and
one fused correction) against the IEEE quotient.  Marked `cuda`: every
test skips where torch has no CUDA device.  Run on a GPU machine with

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_*.py

This file imports torch and the port only.
"""

import ctypes
import subprocess

import numpy as np
import pytest
import torch

from paddle_tpu_torch.ops.kernels import common
from paddle_tpu_torch.ops.kernels import fused_optimizer as opt_k
from paddle_tpu_torch.ops.kernels import quant_collective as qc_k

pytestmark = pytest.mark.cuda

SLOTS = ('Param', 'Grad', 'Moment1', 'Moment2', 'LearningRate', 'Beta1Pow',
         'Beta2Pow')
ATTRS = {'adam': {'beta1': 0.9, 'beta2': 0.999, 'epsilon': 1e-8},
         'adamw': {'beta1': 0.85, 'beta2': 0.99, 'epsilon': 1e-6,
                   'coeff': 0.02}}
# element offsets of (param, grad, moment1, moment2) in their buffers
ALIGNED = (0, 0, 0, 0)
# (name, sizes, offsets cycled over the tensors)
ADAM_CASES = [
    ('views at offsets 1, 2, 3', [5000, 8193, 3, 8191, 30522, 1],
     [(1, 1, 1, 1), (2, 2, 2, 2), (3, 3, 3, 3), (1, 0, 2, 3)]),
    ('sizes 1, 3, 5, 8191, 8193', [1, 3, 5, 8191, 8193, 768 * 3072],
     [ALIGNED]),
    ('200 tiny tensors', [1 + (7 * i) % 40 for i in range(200)],
     [ALIGNED, (1, 1, 1, 1), ALIGNED, (3, 0, 3, 3)]),
]


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')
    return torch.device('cuda', 0)


def _gen(dev, seed):
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    return g


def _view(values, offset):
    """`values` copied into a contiguous view at element `offset` of a
    larger buffer."""
    buf = torch.zeros(values.numel() + 4, device=values.device)
    out = buf[offset:offset + values.numel()]
    out.copy_(values)
    return out


def _adam_inputs(dev, sizes, offsets, seed):
    """The run's tensors, each with its own learning rate and beta
    powers (step i + 1)."""
    g = _gen(dev, seed)
    ins = {k: [] for k in SLOTS}
    for i, n in enumerate(sizes):
        off = offsets[i % len(offsets)]
        vals = (torch.randn(n, generator=g, device=dev),
                torch.randn(n, generator=g, device=dev),
                torch.randn(n, generator=g, device=dev) * 0.1,
                torch.rand(n, generator=g, device=dev))
        for slot, v, o in zip(SLOTS[:4], vals, off):
            ins[slot].append(_view(v, o))
        ins['LearningRate'].append(torch.full((1,), 1e-3 * (1 + i % 7),
                                              device=dev))
        ins['Beta1Pow'].append(torch.full((1,), 0.9 ** (i + 1), device=dev))
        ins['Beta2Pow'].append(torch.full((1,), 0.999 ** (i + 1),
                                          device=dev))
    return ins


@pytest.mark.parametrize('kind', ['adam', 'adamw'])
@pytest.mark.parametrize('case', range(len(ADAM_CASES)))
def test_fused_adam_edge_cases_bitwise(dev, kind, case):
    """One counted launch over the run; parameters and both moments
    bitwise the per-tensor lowering (the library is built with
    --fmad=false), the buffers around each view untouched."""
    _, sizes, offsets = ADAM_CASES[case]
    ins = _adam_inputs(dev, sizes, offsets, 3 + case)
    before = [x._base.clone() for x in ins['Param']]
    want = opt_k.apply_plain(kind, None, ins, ATTRS[kind])
    launches = common.launches('fused_adam')
    got = opt_k.apply(kind, None, ins, ATTRS[kind])
    assert common.launches('fused_adam') == launches + 1
    torch.cuda.synchronize()
    for slot in ('ParamOut', 'Moment1Out', 'Moment2Out'):
        for x, y in zip(got[slot], want[slot]):
            assert torch.equal(x, y), slot
    for x, b in zip(ins['Param'], before):
        o = x.storage_offset()
        assert torch.equal(x._base[:o], b[:o])
        assert torch.equal(x._base[o + x.numel():], b[o + x.numel():])


def _shards(dev, n, cb, block, seed):
    """[n, cb, block] int8 codes and [n, cb, 1] scales as the quantize
    gives them (row scales spread over five decades); row 1 all zero on
    every rank, row 2's absmax in its last element."""
    g = _gen(dev, seed)
    x = torch.randn(n * cb, block, generator=g, device=dev) * (
        10.0 ** torch.randint(-3, 2, (n * cb, 1), generator=g, device=dev))
    qt, st = qc_k.quantize_plain(x)
    qt, st = qt.reshape(n, cb, block), st.reshape(n, cb, 1)
    if cb > 2:
        qt[:, 1] = 0
        st[:, 1] = 1.0
        qt[:, 2] = qt[:, 2].clamp(-100, 100)
        qt[:, 2, -1] = 127
    return qt, st


def _check_reduce(qt, st):
    launches = common.launches('quant_reduce')
    qr, sr = qc_k.reduce_kernel(qt, st)
    assert common.launches('quant_reduce') == launches + 1
    pqr, psr = qc_k.dequant_reduce_requant_plain(qt, st)
    torch.cuda.synchronize()
    assert torch.equal(qr, pqr) and torch.equal(sr, psr), tuple(qt.shape)
    return qr, sr


@pytest.mark.parametrize('block', [8, 9, 200, 256, 1024, 4096])
def test_quant_reduce_blocks_and_ranks_bitwise(dev, block):
    """Every block the flag allows the kernel's two ways (16-byte
    vectors where rows start on 16 bytes, else bytes; rows past 256
    summed again from a second read), n = 1, 2, 3, 8, one row and 37
    rows."""
    for n in (1, 2, 3, 8):
        for cb in (1, 37):
            qt, st = _shards(dev, n, cb, block, block * 100 + n * 10 + cb)
            qr, sr = _check_reduce(qt, st)
            if cb > 2:
                assert sr[1].item() == 1.0 and not qr[1].any()
                assert qr[2, -1].abs().item() == 127


def test_quant_reduce_shards_off_16_bytes(dev):
    """Shards and codes that do not start on 16 bytes (a view at byte 1
    of its buffer) take the byte loop at block 256."""
    qt, st = _shards(dev, 2, 37, 256, 5)
    buf = torch.zeros(qt.numel() + 16, dtype=torch.int8, device=dev)
    view = buf[1:1 + qt.numel()].view(qt.shape)
    view.copy_(qt)
    assert view.data_ptr() % 16 == 1 and view.is_contiguous()
    qr, sr = _check_reduce(view, st)
    assert torch.equal(qr, qc_k.reduce_kernel(qt, st)[0])


# every a whose quotient a / s lies in [1/4, 128), both signs, at each
# scale s: the reduce's quotient (csrc/quant_collective.cu store_codes,
# kFast) against the IEEE a / s, bit for bit
_QUOTIENT_SWEEP = r"""
#include <cuda_runtime.h>
#include <stdint.h>
__global__ void sweep(const float* scales, unsigned long long* bad) {
  const float s = scales[blockIdx.y];
  const float y = __frcp_rn(s);
  const uint32_t lo = __float_as_uint(s * 0.25f);
  const uint32_t hi = __float_as_uint(s * 128.0f);
  unsigned long long n = 0;
  for (uint32_t u = lo + blockIdx.x * blockDim.x + threadIdx.x; u < hi;
       u += gridDim.x * blockDim.x) {
    for (int sign = 0; sign < 2; ++sign) {
      const float a = sign ? -__uint_as_float(u) : __uint_as_float(u);
      const float q0 = a * y;
      const float q = fmaf(fmaf(-s, q0, a), y, q0);
      n += __float_as_uint(q) != __float_as_uint(a / s);
    }
  }
  atomicAdd(bad, n);
}
extern "C" int run_sweep(const float* scales, int n, unsigned long long* bad) {
  sweep<<<dim3(264, n), 256>>>(scales, bad);
  return (int)cudaDeviceSynchronize();
}
"""


def test_quant_reduce_quotient_is_the_ieee_quotient(dev, tmp_path):
    """The reduce divides a row by its scale s in [2^-64, 2^64] through
    y = RN(1/s) and one fused correction.  Its codes can change only
    where a / s lies in [1/4, 128) (a smaller quotient rounds to 0
    either way; |a| <= the row's absmax keeps it under 127.0001), so
    every such a, both signs, is held against the IEEE division at 4096
    scales: mantissas 1, 1 + 2^-23, 2 - 2^-23, 1.5, 4/3 and random ones,
    at exponent 0 (the correction scales by powers of 2 in that range)
    and a few at 2^-64 and 2^63."""
    src = tmp_path / 'quotient_sweep.cu'
    src.write_text(_QUOTIENT_SWEEP)
    lib = tmp_path / 'quotient_sweep.so'
    out = subprocess.run(
        [common._nvcc()] + list(common.NVCC_FLAGS) + ['--fmad=false', '-o',
                                                      str(lib), str(src)],
        capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr
    sweep = ctypes.CDLL(str(lib)).run_sweep
    sweep.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
    sweep.restype = ctypes.c_int
    rs = np.random.RandomState(9)
    mant = [0, 1, 0x7fffff, 0x400000, 0x2aaaab] + list(
        rs.randint(0, 1 << 23, 4096 - 5))
    exps = [127] * (4096 - 16) + [127 - 64] * 8 + [127 + 63] * 8
    bits = np.array([(e << 23) | m for e, m in zip(exps, mant)],
                    dtype=np.uint32)
    scales = torch.from_numpy(bits.view(np.float32).copy()).to(dev)
    bad = torch.zeros(1, dtype=torch.int64, device=dev)
    assert sweep(scales.data_ptr(), scales.numel(), bad.data_ptr()) == 0
    assert bad.item() == 0
