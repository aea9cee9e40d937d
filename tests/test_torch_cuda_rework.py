"""The redesigned flash-attention forward and backward (3xTF32
tensor-core products, cp.async tiles) and embedding scatter-add
(one-block radix sort, run pass, long runs streamed over 32-column
slices) against their plain PyTorch versions on the card, at the edge
cases of their designs: head dims 32 and 128, one query, a key past a
tile, dropout, bf16 (held against the plain bf16 versions),
fully masked rows, a second launch bitwise the
first; runs longer than a 128-row stage that start mid-chunk, D = 16,
100 and 1, one id, and more ids than the one-block sort takes.
Marked `cuda`: every test skips where torch has no CUDA device.  Run on
a GPU machine with

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_*.py

This file imports torch and the port only.
"""

import math

import pytest
import torch

from paddle_tpu_torch.ops.kernels import common
from paddle_tpu_torch.ops.kernels import embedding as emb_k
from paddle_tpu_torch.ops.kernels import flash_attention as fa_k

pytestmark = pytest.mark.cuda

RATE = 0.1
TOL = 1e-4


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device('cuda', 0)


def _gen(dev, seed=0):
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    return g


@pytest.mark.parametrize('b,t,h,d,causal,rate,dtype,masked', [
    (2, 300, 4, 32, False, RATE, torch.float32, False),
    (2, 300, 4, 128, False, RATE, torch.float32, False),
    (2, 1, 4, 64, False, 0.0, torch.float32, False),
    (2, 65, 4, 64, False, RATE, torch.float32, False),
    (2, 200, 4, 64, False, RATE, torch.float32, True),
    (2, 300, 4, 32, False, 0.0, torch.bfloat16, False),
    (2, 512, 4, 64, False, RATE, torch.bfloat16, False),
    (2, 300, 4, 128, True, 0.0, torch.bfloat16, False),
])
def test_forward_edge_cases_match_plain(dev, b, t, h, d, causal, rate, dtype,
                                        masked):
    """O and lse within 1e-4 of the plain forward; a second launch is
    bitwise the first.  bf16 (the bf16 route, bf16 products with P
    rounded to bf16 as the Pallas kernel rounds it): O within 2e-2 of
    max(1, max|plain|) of the plain bf16 version, which rounds P at the
    row's maximum where the kernel rounds it at the running maximum, and
    lse within 1e-4.  masked: batch 0's keys all -inf, so its rows give
    O = 0 exactly and lse = log(1e-20)."""
    g = _gen(dev, 5)
    qkv = torch.randn(b, t, 3 * h * d, generator=g, device=dev).to(dtype)
    q, k, v = [x.reshape(b, t, h, d) for x in qkv.split(h * d, dim=2)]
    bias = torch.where(torch.rand(b, t, generator=g, device=dev) < 0.2,
                       -10000.0, 0.0)
    if masked:
        bias[0] = float('-inf')
    before = common.launches('flash_attention')
    (o, lse), (o2, lse2) = [fa_k.flash_attention_kernel(
        q, k, v, causal, bias, rate, 13) for _ in range(2)]
    assert common.launches('flash_attention') == before + 2
    po, plse = fa_k.flash_attention_plain(q, k, v, causal, bias, rate, 13)
    torch.cuda.synchronize()
    assert o.dtype == dtype and torch.equal(o, o2) and torch.equal(lse, lse2)
    assert (lse - plse).abs().max().item() <= TOL
    if dtype == torch.float32:
        assert (o - po).abs().max().item() <= TOL
    else:
        assert (o.float() - po.float()).abs().max().item() <= 2e-2 * max(
            1.0, po.float().abs().max().item())
    if masked:
        assert o[0].abs().max().item() == 0.0
        assert (lse[0] - math.log(1e-20)).abs().max().item() <= TOL


@pytest.mark.parametrize('b,t,h,d,causal,rate,dtype,masked', [
    (2, 300, 3, 32, False, RATE, torch.float32, False),
    (2, 512, 4, 128, False, RATE, torch.float32, False),
    (2, 300, 4, 64, True, RATE, torch.bfloat16, False),
    (2, 200, 4, 64, False, 0.0, torch.float32, True),
])
def test_backward_edge_cases_match_plain(dev, b, t, h, d, causal, rate,
                                         dtype, masked):
    """1e-4 * max(1, max|plain|) against the plain backward; a second
    launch is bitwise the first.  bf16 (the bf16 route: bf16 products,
    P and dS rounded to bf16 as the Pallas kernel rounds them): within
    2e-2 * max(1, max|plain|) of the plain bf16 backward, which takes
    the same rounding points (sums in another order, P from the
    forward's lse)."""
    g = _gen(dev, 3)
    qkv = torch.randn(b, t, 3 * h * d, generator=g, device=dev).to(dtype)
    q, k, v = [x.reshape(b, t, h, d) for x in qkv.split(h * d, dim=2)]
    bias = torch.where(torch.rand(b, t, generator=g, device=dev) < 0.2,
                       -10000.0, 0.0)
    if masked:
        bias[0] = float('-inf')
    do = torch.randn(b, t, h, d, generator=g, device=dev).to(dtype)
    dlse = torch.randn(b, h, t, generator=g, device=dev)
    o, lse = fa_k.flash_attention_kernel(q, k, v, causal, bias, rate, 11)
    before = common.launches('flash_attention_bwd')
    got, again = [fa_k.flash_attention_bwd_kernel(
        q, k, v, bias, o, lse, do, dlse, causal, rate, 11, bias_grad=True)
        for _ in range(2)]
    assert common.launches('flash_attention_bwd') == before + 2
    want = fa_k.flash_attention_bwd_plain(
        q, k, v, bias, do, dlse, causal, rate, 11, bias_grad=True)
    tol = TOL if dtype == torch.float32 else 2e-2
    torch.cuda.synchronize()
    for x, x2, y in zip(got, again, want):
        assert torch.equal(x, x2) and x.dtype == y.dtype
        assert (x.float() - y.float()).abs().max().item() <= tol * max(
            1.0, y.float().abs().max().item())
    if masked:
        assert all(x[0].abs().max().item() == 0.0 for x in got[:3])


def _skewed(g, dev, rows, n):
    ids = torch.randint(0, rows, (n,), generator=g, device=dev)
    ids[5:900] = 3
    return ids


@pytest.mark.parametrize('case', ['mid_chunk_long_run', 'd16', 'd100', 'd1',
                                  'one_id', 'past_one_block_sort'])
def test_scatter_add_edge_cases_bitwise(dev, case):
    g = _gen(dev, 4)
    d = 768
    if case == 'mid_chunk_long_run':
        # a run of 1500 rows (over 11 stages of 128) from sorted position 37
        rows = 50
        ids = torch.randint(0, 7, (3000,), generator=g, device=dev)
        ids[37:1537] = 7
        ids[1537:] = torch.randint(8, 50, (1463,), generator=g, device=dev)
    elif case in ('d16', 'd100', 'd1'):
        # 41 x 1 floats: a table of no whole number of 16-byte vectors
        rows, d = 41 if case == 'd1' else 40, int(case[1:])
        ids = _skewed(g, dev, rows, 2000)
    elif case == 'one_id':
        rows, ids = 10, torch.tensor([4], device=dev)
    else:
        rows = 1000
        ids = torch.randint(-5, 1005, (12288,), generator=g,
                            device=dev).to(torch.int32)
    grad = torch.randn(ids.numel(), d, generator=g, device=dev)
    before = common.launches('embedding_scatter_add')
    got = emb_k.scatter_add_kernel(rows, ids, grad)
    assert common.launches('embedding_scatter_add') == before + 1
    assert torch.equal(got, emb_k.scatter_add_plain(rows, ids, grad))
