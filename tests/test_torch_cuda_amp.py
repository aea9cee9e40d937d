"""The bf16 route of the flash-attention kernels (K1, K2: wgmma bf16
products, P and dS rounded to bf16 where they enter a product) against
their plain bf16 versions on the card, over T, D in (32, 64, 128),
causal, dropout, a padding bias, fully masked rows and a head offset.

Tolerances, both sides from the same bf16 inputs: the plain version
rounds the unnormalized P relative to each row's maximum, the kernel
relative to the running maximum of the key tiles seen so far, so a P
element may round to the neighbouring bf16 value (2^-8 relative), and
the f32 sums run in another order; O, dQ, dK and dV are rounded once to
bf16.  O and the gradients within 2e-2 of max(1, max|plain|), lse
(f32, from the unrounded P) within 1e-4, the bias cotangent (f32)
within 2e-2 of max(1, max|plain|).  A second launch is bitwise the first (no atomics).

Marked `cuda`: every test skips where torch has no CUDA device.  Run on
a GPU machine with

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_*.py

This file imports torch and the port only.
"""

import math

import pytest
import torch

from paddle_tpu_torch.ops.kernels import common
from paddle_tpu_torch.ops.kernels import flash_attention as fa_k

pytestmark = pytest.mark.cuda

RATE = 0.1
O_TOL = 2e-2
LSE_TOL = 1e-4
GRAD_TOL = 2e-2
BF16 = torch.bfloat16


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device('cuda', 0)


def _inputs(dev, seed, b, t, h, d, bias_kind):
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    qkv = torch.randn(b, t, 3 * h * d, generator=g, device=dev).to(BF16)
    q, k, v = [x.reshape(b, t, h, d) for x in qkv.split(h * d, dim=2)]
    bias = None
    if bias_kind is not None:
        bias = torch.where(torch.rand(b, t, generator=g, device=dev) < 0.2,
                           -10000.0, 0.0)
        if bias_kind == 'row_masked':
            bias[0] = float('-inf')
    do = torch.randn(b, t, h, d, generator=g, device=dev).to(BF16)
    dlse = torch.randn(b, h, t, generator=g, device=dev)
    return q, k, v, bias, do, dlse


CASES = [
    # b, t, h, d, causal, rate, bias, head offset
    (2, 300, 4, 32, False, RATE, 'pad', 0),
    (2, 512, 4, 64, False, RATE, 'pad', 48),
    (2, 300, 4, 128, True, 0.0, 'pad', 0),
    (2, 65, 4, 64, False, 0.0, None, 0),
    (2, 200, 4, 64, False, RATE, 'row_masked', 0),
    (2, 1, 4, 64, False, 0.0, None, 0),
    (1, 333, 2, 128, False, RATE, None, 7),
    (3, 96, 4, 32, True, RATE, 'pad', 0),
]


@pytest.mark.parametrize('b,t,h,d,causal,rate,bias_kind,g_off', CASES)
def test_bf16_forward_matches_plain(dev, b, t, h, d, causal, rate,
                                    bias_kind, g_off):
    q, k, v, bias, _, _ = _inputs(dev, 5, b, t, h, d, bias_kind)
    before = common.launches('flash_attention')
    (o, lse), (o2, lse2) = [fa_k.flash_attention_kernel(
        q, k, v, causal, bias, rate, 13, g_off) for _ in range(2)]
    assert common.launches('flash_attention') == before + 2
    po, plse = fa_k.flash_attention_plain(q, k, v, causal, bias, rate, 13,
                                          g_off)
    torch.cuda.synchronize()
    assert o.dtype == BF16 and lse.dtype == torch.float32
    assert torch.equal(o, o2) and torch.equal(lse, lse2)
    assert (o.float() - po.float()).abs().max().item() <= O_TOL * max(
        1.0, po.float().abs().max().item())
    assert (lse - plse).abs().max().item() <= LSE_TOL
    if bias_kind == 'row_masked':
        assert o[0].abs().max().item() == 0.0
        assert (lse[0] - math.log(1e-20)).abs().max().item() <= LSE_TOL


@pytest.mark.parametrize('b,t,h,d,causal,rate,bias_kind,g_off', CASES)
def test_bf16_backward_matches_plain(dev, b, t, h, d, causal, rate,
                                     bias_kind, g_off):
    q, k, v, bias, do, dlse = _inputs(dev, 3, b, t, h, d, bias_kind)
    o, lse = fa_k.flash_attention_kernel(q, k, v, causal, bias, rate, 11,
                                         g_off)
    grad_bias = bias is not None
    before = common.launches('flash_attention_bwd')
    got, again = [fa_k.flash_attention_bwd_kernel(
        q, k, v, bias, o, lse, do, dlse, causal, rate, 11, grad_bias,
        g_off) for _ in range(2)]
    assert common.launches('flash_attention_bwd') == before + 2
    want = fa_k.flash_attention_bwd_plain(q, k, v, bias, do, dlse, causal,
                                          rate, 11, grad_bias, g_off)
    torch.cuda.synchronize()
    for x, x2, y in zip(got, again, want):
        if y is None:
            assert x is None
            continue
        assert x.dtype == y.dtype and torch.equal(x, x2)
        assert (x.float() - y.float()).abs().max().item() <= GRAD_TOL * max(
            1.0, y.float().abs().max().item())
    assert all(x.dtype == BF16 for x in got[:3])
    if bias_kind == 'row_masked':
        assert all(x[0].abs().max().item() == 0.0 for x in got[:3])


def test_bf16_autograd_launches_both_kernels(dev):
    """flash_attention on bf16 CUDA tensors: one forward and one backward
    launch, bf16 gradients, the f32 bias cotangent cast to the bias."""
    q, k, v, bias, do, _ = _inputs(dev, 7, 2, 128, 4, 64, 'pad')
    leaves = [x.detach().requires_grad_() for x in (q, k, v)]
    f0, b0 = (common.launches('flash_attention'),
              common.launches('flash_attention_bwd'))
    o = fa_k.flash_attention(*leaves, key_bias=bias, dropout_rate=RATE,
                             dropout_seed=3)
    o.backward(do)
    assert common.launches('flash_attention') == f0 + 1
    assert common.launches('flash_attention_bwd') == b0 + 1
    assert o.dtype == BF16 and all(x.grad.dtype == BF16 for x in leaves)


@pytest.mark.parametrize('bad', [None, 'nan', 'inf', '-inf'])
def test_check_finite_and_unscale_verdict_on_the_card(dev, bad):
    """The verdict over many gradients on the card (a multi-tensor
    max-abs pass) is true exactly where one element of one gradient is
    inf or nan, wherever it lies in a large tensor; Out is X / scale or
    all zeros (exact)."""
    from paddle_tpu_torch.ops import registry
    g = torch.Generator(device=dev)
    g.manual_seed(2)
    xs = [torch.randn(n, generator=g, device=dev) * 100
          for n in (3, 70000, 1 << 20, 5)]
    if bad is not None:
        xs[2][654321] = float(bad)
    scale = torch.full((1,), 1024.0, device=dev)
    out = registry.get('check_finite_and_unscale').run(
        registry.LowerCtx(0, device=dev), {'X': xs, 'Scale': [scale]}, {})
    found = out['FoundInfinite'][0]
    assert found.is_cuda and found.dtype == torch.bool
    assert found.item() == (bad is not None)
    for x, u in zip(xs, out['Out']):
        want = torch.zeros_like(x) if bad is not None else x / scale
        assert torch.equal(u, want)
