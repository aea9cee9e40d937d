"""The kernels of the port's training slice against their plain
PyTorch versions, on the card: the flash-attention forward's dropout
branch, the flash-attention backward, the embedding scatter-add and the
multi-tensor Adam, and a small training step that launches them.
Marked `cuda`: every test skips where torch has no CUDA device.  Run on
a GPU machine with

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_*.py

This file imports torch and the port only.
"""

import numpy as np
import pytest
import torch

import paddle_tpu_torch.fluid as fluid
from paddle_tpu_torch.models import bert
from paddle_tpu_torch.ops.kernels import common
from paddle_tpu_torch.ops.kernels import embedding as emb_k
from paddle_tpu_torch.ops.kernels import flash_attention as fa_k
from paddle_tpu_torch.ops.kernels import fused_optimizer as opt_k

pytestmark = pytest.mark.cuda

RATE = 0.1


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


def _qkv(g, b, t, h, d, dev):
    qkv = torch.randn(b, t, 3 * h * d, generator=g, device=dev)
    return [x.reshape(b, t, h, d) for x in qkv.split(h * d, dim=2)]


@pytest.mark.parametrize('b,t,h,d', [(2, 512, 12, 64), (1, 300, 3, 64),
                                     (2, 130, 2, 128), (3, 77, 2, 32)])
def test_dropout_forward_matches_plain(dev, b, t, h, d):
    g = _gen(dev)
    q, k, v = _qkv(g, b, t, h, d, dev)
    bias = torch.where(torch.rand(b, t, generator=g, device=dev) < 0.2,
                       -10000.0, 0.0)
    before = common.launches('flash_attention')
    o, lse = fa_k.flash_attention_kernel(q, k, v, False, bias, RATE, 99)
    assert common.launches('flash_attention') == before + 1
    po, plse = fa_k.flash_attention_plain(q, k, v, False, bias, RATE, 99)
    torch.cuda.synchronize()
    assert (o - po).abs().max().item() <= 1e-4
    assert (lse - plse).abs().max().item() <= 1e-4


def test_dropout_keep_mask_read_back_bitwise(dev):
    """Q = K = 0 and a bias opening one 64-key window make every open
    key's probability 1/64; V one-hot over the window reads the keep
    bits out of O."""
    b, t, h, seed = 2, 200, 3, 12345
    z = torch.zeros(b, t, h, 64, device=dev)
    keep = torch.empty(b, h, t, t, dtype=torch.bool, device=dev)
    for k0 in range(0, t, 64):
        w = min(64, t - k0)
        bias = torch.full((b, t), float('-inf'), device=dev)
        bias[:, k0:k0 + w] = 0.0
        v = torch.zeros(b, t, h, 64, device=dev)
        v[:, k0:k0 + w, :, :w] = torch.eye(w, device=dev)[None, :, None, :]
        o, _ = fa_k.flash_attention_kernel(z, z, v, False, bias, RATE, seed)
        keep[:, :, :, k0:k0 + w] = (o[..., :w] > 0).permute(0, 2, 1, 3)
    want = fa_k.dropout_keep_plain(seed, b, h, t, t, RATE, dev)
    assert torch.equal(keep, want)


@pytest.mark.parametrize('b,t,h,d,causal,rate,grads', [
    (2, 512, 12, 64, False, RATE, False),
    (2, 300, 4, 64, False, RATE, True),
    (2, 200, 4, 128, True, 0.0, True),
    (1, 64, 2, 32, False, 0.0, False),
])
def test_backward_matches_autograd_of_plain(dev, b, t, h, d, causal, rate,
                                            grads):
    g = _gen(dev, 1)
    q, k, v = _qkv(g, b, t, h, d, dev)
    bias = torch.where(torch.rand(b, t, generator=g, device=dev) < 0.2,
                       -10000.0, 0.0)
    do = torch.randn(b, t, h, d, generator=g, device=dev)
    dlse = torch.randn(b, h, t, generator=g, device=dev) if grads else None
    o, lse = fa_k.flash_attention_kernel(q, k, v, causal, bias, rate, 7)
    before = common.launches('flash_attention_bwd')
    got = fa_k.flash_attention_bwd_kernel(q, k, v, bias, o, lse, do, dlse,
                                          causal, rate, 7, bias_grad=grads)
    assert common.launches('flash_attention_bwd') == before + 1
    want = fa_k.flash_attention_bwd_plain(q, k, v, bias, do, dlse, causal,
                                          rate, 7, bias_grad=grads)
    torch.cuda.synchronize()
    for x, y in zip(got, want):
        if y is None:
            assert x is None
            continue
        assert (x - y).abs().max().item() <= 1e-4 * max(
            1.0, y.abs().max().item())


@pytest.mark.parametrize('rows', [30522, 512, 2])
def test_scatter_add_bitwise(dev, rows):
    g = _gen(dev, 2)
    n = 4096
    ids = torch.randint(0, rows, (n,), generator=g, device=dev)
    if rows == 2:
        ids.zero_()
    ids[:4] = torch.tensor([-3, rows, rows - 1, 0], device=dev)
    grad = torch.randn(n, 768, generator=g, device=dev)
    before = common.launches('embedding_scatter_add')
    got = emb_k.scatter_add_kernel(rows, ids, grad)
    assert common.launches('embedding_scatter_add') == before + 1
    assert torch.equal(got, emb_k.scatter_add_plain(rows, ids, grad))


@pytest.mark.parametrize('kind,attrs', [
    ('adam', {'beta1': 0.9, 'beta2': 0.999, 'epsilon': 1e-8}),
    ('adamw', {'beta1': 0.85, 'beta2': 0.99, 'epsilon': 1e-6,
               'coeff': 0.02})])
def test_fused_adam_matches_per_tensor_plain(dev, kind, attrs):
    g = _gen(dev, 3)
    shapes = [(768, 30522), (30522,), (3, 5, 7), (1,), (768, 768)]
    ins = {'Param': [], 'Grad': [], 'Moment1': [], 'Moment2': [],
           'LearningRate': [], 'Beta1Pow': [], 'Beta2Pow': []}
    for i, s in enumerate(shapes):
        ins['Param'].append(torch.randn(s, generator=g, device=dev))
        ins['Grad'].append(torch.randn(s, generator=g, device=dev))
        ins['Moment1'].append(torch.randn(s, generator=g, device=dev))
        ins['Moment2'].append(torch.rand(s, generator=g, device=dev))
        ins['LearningRate'].append(torch.full((1,), 1e-3 * (i + 1),
                                              device=dev))
        ins['Beta1Pow'].append(torch.full((1,), 0.9 ** (i + 1), device=dev))
        ins['Beta2Pow'].append(torch.full((1,), 0.999 ** (i + 1),
                                          device=dev))
    want = opt_k.apply_plain(kind, None, ins, attrs)
    before = common.launches('fused_adam')
    got = opt_k.apply(kind, None, ins, attrs)
    assert common.launches('fused_adam') == before + 1
    torch.cuda.synchronize()
    # the library is built with --fmad=false: bitwise
    for slot in ('ParamOut', 'Moment1Out', 'Moment2Out'):
        for x, y in zip(got[slot], want[slot]):
            assert torch.equal(x, y), slot


def test_small_training_step_launches_every_kernel(dev):
    cfg = bert.BertConfig(vocab_size=1000, hidden=128, layers=2, heads=2,
                          intermediate=256, max_pos=128)
    cfg.flash_min_len = 0
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = 5
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        _, _, loss = bert.build_pretrain(cfg, seq_len=128)
        fluid.optimizer.Adam(learning_rate=1e-5, epsilon=1e-6).minimize(loss)
    batch = bert.synthetic_batch(cfg, 2, 128, np.random.RandomState(0))
    exe, scope = fluid.Executor(fluid.CUDAPlace(0)), fluid.Scope()
    with fluid.scope_guard(scope):
        exe.run(startup)
        common.reset_launches()
        (out,) = exe.run(main, feed=batch, fetch_list=[loss])
    assert np.isfinite(out)
    assert {k: common.launches(k) for k in common.KERNELS} == {
        'flash_attention': 2, 'flash_attention_bwd': 2,
        'embedding_lookup': 3, 'embedding_scatter_add': 3, 'fused_adam': 1,
        'embedding_update': 0, 'fused_lamb': 0, 'quant_quantize': 0,
        'quant_reduce': 0,
        # the 2 layers' 2 hidden dropouts and the embeddings' one, forward
        # and gradient
        'dropout': 5, 'dropout_grad': 5, 'finite_check': 0, 'graph_cond': 0}
