"""The kernels of the data-parallel slice on the card: the flash
attention forward and backward (K1, K2) with a head-index offset, and
the multi-tensor Adam (K4) over row slices, as a rank of
``with_data_parallel`` launches them.  Marked `cuda`: every test skips
where torch has no CUDA device.  Run on a GPU machine with

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_*.py

This file imports torch and the port only.
"""

import pytest
import torch

from paddle_tpu_torch.ops.kernels import flash_attention as fa_k
from paddle_tpu_torch.ops.kernels import fused_optimizer as opt_k

pytestmark = pytest.mark.cuda

RATE = 0.1
SEED = 0x9E3779B9 ^ 4242


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')
    return torch.device('cuda', 0)


def _gen(dev, seed=0):
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    return g


@pytest.mark.parametrize('b,t,h,d', [(4, 512, 12, 64), (2, 130, 3, 32)])
def test_flash_kernels_with_offset_are_the_full_batch_rows(dev, b, t, h, d):
    """Rank r of 2 (local batch b / 2, offset r * b / 2 * h): O, lse and
    every gradient bitwise the full batch's rows."""
    g = _gen(dev)
    q, k, v, do = [torch.randn(b, t, h, d, generator=g, device=dev)
                   for _ in range(4)]
    bias = torch.where(torch.rand(b, t, generator=g, device=dev) < 0.2,
                       -10000.0, 0.0)
    o, lse = fa_k.flash_attention_kernel(q, k, v, False, bias, RATE, SEED)
    grads = fa_k.flash_attention_bwd_kernel(q, k, v, bias, o, lse, do, None,
                                            False, RATE, SEED, True)
    half = b // 2
    for r in range(2):
        rows = slice(r * half, (r + 1) * half)
        off = r * half * h
        po, plse = fa_k.flash_attention_kernel(
            q[rows], k[rows], v[rows], False, bias[rows], RATE, SEED, off)
        assert torch.equal(po, o[rows]) and torch.equal(plse, lse[rows])
        part = fa_k.flash_attention_bwd_kernel(
            q[rows], k[rows], v[rows], bias[rows], po, plse, do[rows], None,
            False, RATE, SEED, True, off)
        for got, want in zip(part, grads):
            assert torch.equal(got, want[rows])
    # the offset is in the mask: rank 1's rows without it differ
    wrong, _ = fa_k.flash_attention_kernel(
        q[half:], k[half:], v[half:], False, bias[half:], RATE, SEED)
    assert not torch.equal(wrong, o[half:])


def test_fused_adam_over_row_slices_is_the_whole_update(dev):
    """One K4 launch over rank 1's rows of the even tensors and the odd
    tensors whole (the sharded optimizer state's run) updates those
    rows bitwise as one launch over the whole tensors does."""
    g = _gen(dev, 1)
    shapes = [(30522, 768), (768,), (3, 768), (2, 768), (512, 768)]
    whole = []
    for s in shapes:
        p = torch.randn(s, generator=g, device=dev)
        gr = torch.randn(s, generator=g, device=dev) * 1e-2
        m1 = torch.randn(s, generator=g, device=dev) * 1e-3
        m2 = torch.rand(s, generator=g, device=dev) * 1e-4
        whole.append((p, gr, m1, m2))
    lr = torch.full((1,), 1e-3, device=dev)
    b1p = torch.full((1,), 0.9 ** 3, device=dev)
    b2p = torch.full((1,), 0.999 ** 3, device=dev)
    attrs = {'beta1': 0.9, 'beta2': 0.999, 'epsilon': 1e-6}

    def run(tensors):
        ins = {'Param': [t[0] for t in tensors],
               'Grad': [t[1] for t in tensors],
               'Moment1': [t[2] for t in tensors],
               'Moment2': [t[3] for t in tensors],
               'LearningRate': [lr] * len(tensors),
               'Beta1Pow': [b1p] * len(tensors),
               'Beta2Pow': [b2p] * len(tensors)}
        opt_k.apply_kernel('adam', ins, attrs)

    ref = [tuple(x.clone() for x in t) for t in whole]
    run(ref)
    shard = []
    for p, gr, m1, m2 in whole:
        n = p.shape[0]
        if n > 1 and n % 2 == 0:
            rows = slice(n // 2, n)
            shard.append((p[rows], gr[rows], m1[rows].clone(),
                          m2[rows].clone()))
        else:
            shard.append((p, gr, m1.clone(), m2.clone()))
    run(shard)
    for (sp, _, sm1, sm2), (rp, _, rm1, rm2) in zip(shard, ref):
        n = rp.shape[0]
        rows = slice(n // 2, n) if n > 1 and n % 2 == 0 else slice(0, n)
        assert torch.equal(sp, rp[rows])
        assert torch.equal(sm1, rm1[rows]) and torch.equal(sm2, rm2[rows])
