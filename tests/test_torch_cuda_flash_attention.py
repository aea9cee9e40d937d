"""The port's flash-attention CUDA kernel against its plain PyTorch
version, on the card.  Marked `cuda`: every test skips where torch has
no CUDA device.  Run the card-only kernel tests on a GPU machine with

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_*.py

(--noconftest: the suite's conftest imports JAX, which the GPU machine
need not have).  This file imports torch and the port only.
"""

import pytest
import torch

from paddle_tpu_torch.ops.kernels import common
from paddle_tpu_torch.ops.kernels import flash_attention as fa_k

pytestmark = pytest.mark.cuda


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


@pytest.mark.parametrize('dtype,tol', [(torch.float32, 1e-4),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize('b,t,h,d,causal,bias', [
    (2, 512, 12, 64, False, 'pad'),
    (1, 200, 3, 64, False, 'pad'),
    (2, 1, 2, 64, False, None),
    (1, 333, 2, 128, True, 'pad'),
    (3, 96, 4, 32, True, None),
    (2, 130, 2, 64, False, 'row_masked'),
])
def test_flash_attention_kernel_matches_plain(dev, dtype, tol, b, t, h, d,
                                              causal, bias):
    # bf16 tolerance: both sides take bf16 products from the same bf16
    # inputs, round P to bf16 before P V (the plain version at the row's
    # maximum, the kernel at the running one) and O once (8 mantissa
    # bits)
    g = _gen(dev)
    q, k, v = [torch.randn(b, t, h, d, generator=g, device=dev).to(dtype)
               for _ in range(3)]
    kb = None
    if bias is not None:
        kb = torch.where(torch.rand(b, t, generator=g, device=dev) < 0.3,
                         -10000.0, 0.0)
        if bias == 'row_masked':
            kb[1] = float('-inf')
    before = common.launches('flash_attention')
    o, lse = fa_k.flash_attention_kernel(q, k, v, causal, kb)
    assert common.launches('flash_attention') == before + 1
    po, plse = fa_k.flash_attention_plain(q, k, v, causal, kb)
    torch.cuda.synchronize()
    assert o.dtype == dtype and lse.dtype == torch.float32
    assert (o.float() - po.float()).abs().max().item() <= tol
    assert (lse - plse).abs().max().item() <= 1e-4
    if bias == 'row_masked':
        assert torch.all(o[1] == 0)


def test_flash_attention_public_entry_launches_on_cuda(dev):
    g = _gen(dev, 1)
    qkv = torch.randn(2, 64, 3 * 4 * 64, generator=g, device=dev)
    q, k, v = [x.reshape(2, 64, 4, 64) for x in qkv.split(256, dim=2)]
    before = common.launches('flash_attention')
    o = fa_k.flash_attention(q, k, v)
    assert common.launches('flash_attention') == before + 1
    torch.testing.assert_close(o, fa_k.flash_attention_plain(q, k, v)[0],
                               atol=1e-4, rtol=0)
    with pytest.raises(ValueError, match='needs a dropout_seed'):
        fa_k.flash_attention(q, k, v, dropout_rate=0.1)
