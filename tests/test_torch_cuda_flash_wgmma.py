"""The bf16 route of the flash-attention kernels on the card: the wgmma
and TMA helpers (csrc/hopper_wgmma.cuh) alone, then the forward (K1)
and backward (K2) against their plain bf16 versions at ragged T, causal
masks, D = 32, 64 and 128, the strided views of a fused [B, T, 3, H, D]
projection, a batch whose keys are all masked and dropout at head offset
48, and the built libraries' SASS.

Tolerances, both sides from the same bf16 inputs: the plain version
rounds the unnormalized P relative to each row's maximum, the kernel
relative to the running maximum of the key tiles seen so far, so a P
element may round to the neighbouring bf16 value (2^-8 relative), and
the f32 sums run in another order; O, dQ, dK and dV are rounded once to
bf16.  O and the gradients within 2e-2 of max(1, max|plain|), lse (f32,
from the unrounded P) within 1e-4, the bias cotangent (f32) within 2e-2
of max(1, max|plain|); the rows of a fully masked batch exactly 0; the
dropout keep mask bitwise the plain hash; a second launch bitwise the
first (no atomics), also when launched from another thread.  The wgmma
probe's products are exact in f32 up to the order of the k-sums: 1e-5
of their largest magnitude.

Marked `cuda`: every test skips where torch has no CUDA device.  Run on
a GPU machine with

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_*.py

This file imports torch and the port only.
"""

import ctypes
import os
import shutil
import subprocess
import threading

import pytest
import torch

from paddle_tpu_torch.ops.kernels import common
from paddle_tpu_torch.ops.kernels import flash_attention as fa_k

pytestmark = pytest.mark.cuda

RATE = 0.1
O_TOL = 2e-2
LSE_TOL = 1e-4
GRAD_TOL = 2e-2
PROBE_TOL = 1e-5
BF16 = torch.bfloat16


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device('cuda', 0)


def _gen(dev, seed):
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    return g


@pytest.mark.parametrize('d', [32, 64, 128])
def test_wgmma_probe_matches_matmul(dev, d):
    """One block: X, Y, V [64, D] loaded by TMA with the flash kernels'
    swizzle; S = X Y^T (both operands K-major in shared memory) and O =
    bf16(P) V (P from registers, V MN-major) against torch.matmul in
    f32."""
    g = _gen(dev, d)
    x, y, v = [torch.randn(64, d, generator=g, device=dev).to(BF16)
               for _ in range(3)]
    p = torch.randn(64, 64, generator=g, device=dev)
    s = torch.full((64, 64), float('nan'), device=dev)
    o = torch.full((64, d), float('nan'), device=dev)
    lib = common.library(fa_k.FWD_SOURCE)
    fn = lib.hopper_wgmma_probe
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    err = fn(x.data_ptr(), y.data_ptr(), v.data_ptr(), p.data_ptr(),
             s.data_ptr(), o.data_ptr(), d, common.stream_ptr(dev))
    common.check_launch('flash_attention', lib, err, count=False)
    torch.cuda.synchronize()
    want_s = torch.matmul(x.float(), y.float().t())
    want_o = torch.matmul(p.to(BF16).float(), v.float())
    for got, want in ((s, want_s), (o, want_o)):
        assert torch.isfinite(got).all()
        assert (got - want).abs().max().item() <= \
            PROBE_TOL * want.abs().max().item()


def _inputs(dev, seed, b, t, h, d, bias_kind):
    """q, k, v as the strided views of one fused [B, T, 3, H, D] bf16
    projection, a padding bias (or None; 'row_masked': batch 0's keys
    all -inf), dO and the lse cotangent."""
    g = _gen(dev, seed)
    qkv = torch.randn(b, t, 3, h, d, generator=g, device=dev).to(BF16)
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    bias = None
    if bias_kind is not None:
        lens = torch.randint(max(1, t // 4), t + 1, (b,), generator=g,
                             device=dev)
        bias = torch.where(torch.arange(t, device=dev)[None, :] <
                           lens[:, None], 0.0, -10000.0)
        if bias_kind == 'row_masked':
            bias[0] = float('-inf')
    do = torch.randn(b, t, h, d, generator=g, device=dev).to(BF16)
    dlse = torch.randn(b, h, t, generator=g, device=dev)
    return q, k, v, bias, do, dlse


CASES = [
    # b, t, h, d, causal, rate, bias, head offset
    (2, 100, 4, 64, False, RATE, 'pad', 0),
    (2, 200, 4, 32, False, 0.0, 'pad', 0),
    (2, 500, 4, 128, False, RATE, 'pad', 0),
    (2, 300, 4, 64, True, 0.0, 'pad', 0),
    (3, 200, 4, 128, True, RATE, None, 0),
    (2, 200, 4, 64, False, RATE, 'row_masked', 0),
    (2, 512, 4, 64, False, RATE, 'pad', 48),
]


def _rel(got, want):
    return (got.float() - want.float()).abs().max().item() / max(
        1.0, want.float().abs().max().item())


@pytest.mark.parametrize('b,t,h,d,causal,rate,bias_kind,g_off', CASES)
def test_forward_matches_plain(dev, b, t, h, d, causal, rate, bias_kind,
                               g_off):
    q, k, v, bias, _, _ = _inputs(dev, t + d, b, t, h, d, bias_kind)
    assert q.stride(1) == 3 * h * d  # the fused projection's own views
    o, lse = fa_k.flash_attention_kernel(q, k, v, causal, bias, rate, 91,
                                         g_off)
    o2, lse2 = fa_k.flash_attention_kernel(q, k, v, causal, bias, rate, 91,
                                           g_off)
    po, plse = fa_k.flash_attention_plain(q, k, v, causal, bias, rate, 91,
                                          g_off)
    torch.cuda.synchronize()
    assert torch.equal(o, o2) and torch.equal(lse, lse2)
    assert o.dtype == BF16 and lse.dtype == torch.float32
    assert _rel(o, po) <= O_TOL
    assert (lse - plse).abs().max().item() <= LSE_TOL
    if bias_kind == 'row_masked':
        assert o[0].abs().max().item() == 0.0


@pytest.mark.parametrize('b,t,h,d,causal,rate,bias_kind,g_off', CASES)
def test_backward_matches_plain(dev, b, t, h, d, causal, rate, bias_kind,
                                g_off):
    q, k, v, bias, do, dlse = _inputs(dev, 7 * t + d, b, t, h, d,
                                      bias_kind)
    grads = bias is not None
    o, lse = fa_k.flash_attention_kernel(q, k, v, causal, bias, rate, 17,
                                         g_off)
    got, again = [fa_k.flash_attention_bwd_kernel(
        q, k, v, bias, o, lse, do, dlse, causal, rate, 17, grads, g_off)
        for _ in range(2)]
    want = fa_k.flash_attention_bwd_plain(q, k, v, bias, do, dlse, causal,
                                          rate, 17, grads, g_off)
    torch.cuda.synchronize()
    for name, x, y, w in zip(('dq', 'dk', 'dv', 'dbias'), got, again, want):
        if w is None:
            assert x is None
            continue
        assert torch.equal(x, y), name
        assert x.dtype == w.dtype, name
        assert _rel(x, w) <= GRAD_TOL, name
    if bias_kind == 'row_masked':
        assert all(x[0].abs().max().item() == 0.0 for x in got[:3])


def test_dropout_keep_mask_is_the_hash(dev):
    """The bf16 forward's keep mask at head offset 48, read back: with Q
    = K = 0 every open key gets p = 1/64, the bias opens one 64-key window
    at a time and V is one-hot over it, so O[q, j] > 0 exactly where
    (q, window + j) is kept."""
    b, t, h, seed, g_off = 2, 200, 4, 0x9E3779B9, 48
    z = torch.zeros(b, t, h, 64, dtype=BF16, device=dev)
    keep = torch.empty(b, h, t, t, dtype=torch.bool, device=dev)
    for k0 in range(0, t, 64):
        w = min(64, t - k0)
        bias = torch.full((b, t), float('-inf'), device=dev)
        bias[:, k0:k0 + w] = 0.0
        v = torch.zeros(b, t, h, 64, dtype=BF16, device=dev)
        v[:, k0:k0 + w, :, :w] = torch.eye(w, dtype=BF16,
                                           device=dev)[None, :, None, :]
        o, _ = fa_k.flash_attention_kernel(z, z, v, False, bias, RATE, seed,
                                           g_off)
        keep[:, :, :, k0:k0 + w] = (o[..., :w] > 0).permute(0, 2, 1, 3)
    want = fa_k.dropout_keep_plain(seed, b, h, t, t, RATE, dev, g_off)
    torch.cuda.synchronize()
    assert torch.equal(keep, want)


def test_launch_from_another_thread(dev):
    """The bf16 kernels configured on this thread launch from a new one
    (autograd runs the backward on a worker thread): the tensor maps
    are encoded with the device's context made current there."""
    q, k, v, bias, do, dlse = _inputs(dev, 5, 2, 128, 4, 64, 'pad')
    o, lse = fa_k.flash_attention_kernel(q, k, v, False, bias, RATE, 3)
    want = fa_k.flash_attention_bwd_kernel(q, k, v, bias, o, lse, do, dlse,
                                           False, RATE, 3, True)
    got = {}

    def run():
        try:
            got['o'] = fa_k.flash_attention_kernel(q, k, v, False, bias,
                                                   RATE, 3)[0]
            got['grads'] = fa_k.flash_attention_bwd_kernel(
                q, k, v, bias, o, lse, do, dlse, False, RATE, 3, True)
        except Exception as e:  # re-raised on this thread below
            got['error'] = e

    worker = threading.Thread(target=run)
    worker.start()
    worker.join()
    if 'error' in got:
        raise got['error']
    torch.cuda.synchronize()
    assert torch.equal(got['o'], o)
    assert all(torch.equal(x, y) for x, y in zip(got['grads'], want))


def _cuobjdump():
    for home in (os.environ.get('CUDA_HOME'), '/usr/local/cuda'):
        if home and os.path.exists(os.path.join(home, 'bin', 'cuobjdump')):
            return os.path.join(home, 'bin', 'cuobjdump')
    return shutil.which('cuobjdump')


def test_sass_runs_wgmma_on_tma_tiles(dev):
    """The built K1 and K2 libraries hold warpgroup products (HGMMA) and
    TMA tile loads (UTMALDG), and no bf16 mma.sync (HMMA.16816) is left:
    the f32 route's products are TF32 m16n8k8 (HMMA.1688)."""
    tool = _cuobjdump()
    if tool is None:
        pytest.skip('no cuobjdump in the CUDA toolkit')
    for source in (fa_k.FWD_SOURCE, fa_k.BWD_SOURCE):
        common.library(source)
        sass = subprocess.run([tool, '-sass', common._lib_path(source)[1]],
                              capture_output=True, text=True,
                              check=True).stdout
        assert 'HGMMA' in sass, source
        assert 'UTMALDG' in sass, source
        assert 'HMMA.16816' not in sass, source
