"""K8, the quantized all-reduce's quantize and dequant-reduce-requant
kernels, against their plain PyTorch versions on the card: bitwise, at
the shapes BERT-base data-parallel training gives them on 2 ranks (the
30522 x 768 table gradient, a 768 x 3072 weight gradient, the fused
bucket of the 101 small gradients) and at block 64 and 8 ranks.
Marked `cuda`: every test skips where torch has no CUDA device.  Run on
a GPU machine with

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_*.py

This file imports torch and the port only.
"""

import pytest
import torch
import torch.distributed as dist

from paddle_tpu_torch.fluid import flags
from paddle_tpu_torch.ops.kernels import common
from paddle_tpu_torch.ops.kernels import quant_collective as qc

pytestmark = pytest.mark.cuda

# (elements of the gradient, ranks, block)
CASES = [(30522 * 768, 2, 256), (768 * 3072, 2, 256), (124418, 2, 256),
         (1000003, 2, 64), (4 * 1000003, 8, 256)]


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')
    return torch.device('cuda', 0)


def _grad(dev, numel, seed):
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    x = torch.randn(numel, generator=g, device=dev) * 1e-3
    x[1000:1512] = 0.0            # all-zero blocks
    x[5000:5256] *= 1e4           # a block of large values
    return x


def _blocks(x, n, block):
    chunk = -(-x.numel() // n)
    chunk = -(-chunk // block) * block
    return torch.nn.functional.pad(x, (0, chunk * n - x.numel())).reshape(
        -1, block)


@pytest.mark.parametrize('numel,n,block', CASES)
def test_quantize_is_bitwise_plain(dev, numel, n, block):
    rows = _blocks(_grad(dev, numel, 0), n, block)
    before = common.launches('quant_quantize')
    q, s = qc.quantize_blocks(rows)
    assert common.launches('quant_quantize') == before + 1
    pq, ps = qc.quantize_plain(rows)
    torch.cuda.synchronize()
    assert q.dtype == torch.int8 and s.shape == (rows.shape[0], 1)
    assert torch.equal(q, pq) and torch.equal(s, ps)


@pytest.mark.parametrize('numel,n,block', CASES)
def test_reduce_is_bitwise_plain(dev, numel, n, block):
    shards = [qc.quantize_plain(_blocks(_grad(dev, numel, r), n, block))
              for r in range(n)]
    cb = shards[0][0].shape[0] // n
    # rank 0's chunk: block 0 of every rank's shards
    qt = torch.stack([q.reshape(n, cb, block)[0] for q, _ in shards])
    st = torch.stack([s.reshape(n, cb, 1)[0] for _, s in shards])
    before = common.launches('quant_reduce')
    qr, sr = qc.dequant_reduce_requant(qt, st)
    assert common.launches('quant_reduce') == before + 1
    pqr, psr = qc.dequant_reduce_requant_plain(qt, st)
    torch.cuda.synchronize()
    assert torch.equal(qr, pqr) and torch.equal(sr, psr)


def test_quant_allreduce_is_bitwise_the_plain_path(dev):
    """The whole all-reduce on a one-rank group, kernels against plain
    versions (FLAGS_torch_kernels_plain), on the card."""
    dist.init_process_group('gloo', store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        x = _grad(dev, 768 * 3072, 3).reshape(768, 3072)
        got = qc.quant_allreduce(x, dist.group.WORLD, 1, 256)
        flags.set_flags({'FLAGS_torch_kernels_plain': True})
        try:
            want = qc.quant_allreduce(x, dist.group.WORLD, 1, 256)
        finally:
            flags.set_flags({'FLAGS_torch_kernels_plain': False})
        torch.cuda.synchronize()
        assert got.device == x.device and torch.equal(got, want)
        step = x.abs().max().item() / 127
        assert (got - x).abs().max().item() <= step
    finally:
        dist.destroy_process_group()
