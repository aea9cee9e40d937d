"""The kernels of the port's LAMB and sparse-Adagrad slice against their
plain PyTorch versions, on the card: the multi-tensor LAMB (K5) and the
embedding-row Adagrad update (K7), and small LAMB and Wide&Deep
training steps that launch them.  Marked `cuda`: every test skips where
torch has no CUDA device.  Run on a GPU machine with

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_*.py

Both libraries are built with --fmad=false: LAMB's moments and the
whole row update are bitwise the plain versions'; LAMB's parameters
differ only through the trust ratio's norms, summed in another order,
and are held to rtol 2e-6 / atol 3e-7 (the JAX package's bound between
its fused kernel and its dense chain).  This file imports torch and the
port only.
"""

import numpy as np
import pytest
import torch

import paddle_tpu_torch.fluid as fluid
from paddle_tpu_torch.models import bert
from paddle_tpu_torch.models import wide_deep
from paddle_tpu_torch.ops.kernels import common
from paddle_tpu_torch.ops.kernels import embedding as emb_k
from paddle_tpu_torch.ops.kernels import fused_optimizer as opt_k

pytestmark = pytest.mark.cuda

LAMB = {'beta1': 0.9, 'beta2': 0.999, 'epsilon': 1e-6, 'weight_decay': 0.01}


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device('cuda', 0)


def _gen(dev, seed=0):
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    return g


def _lamb_ins(dev, shapes, zero_grad=()):
    g = _gen(dev, 1)
    ins = {k: [] for k in ('Param', 'Grad', 'Moment1', 'Moment2',
                           'LearningRate', 'Beta1Pow', 'Beta2Pow')}
    for i, s in enumerate(shapes):
        zg = i in zero_grad
        ins['Param'].append(torch.randn(s, generator=g, device=dev))
        ins['Grad'].append(torch.zeros(s, device=dev) if zg else
                           torch.randn(s, generator=g, device=dev) * 1e-2)
        ins['Moment1'].append(torch.zeros(s, device=dev) if zg else
                              torch.randn(s, generator=g, device=dev) * 1e-3)
        ins['Moment2'].append(torch.zeros(s, device=dev) if zg else
                              torch.rand(s, generator=g, device=dev) * 1e-4)
        ins['LearningRate'].append(torch.full((1,), 1e-3 * (i % 3 + 1),
                                              device=dev))
        ins['Beta1Pow'].append(torch.full((1,), 0.9 ** (i + 1), device=dev))
        ins['Beta2Pow'].append(torch.full((1,), 0.999 ** (i + 1),
                                          device=dev))
    return ins


def _clone(ins):
    return {k: [x.clone() for x in v] for k, v in ins.items()}


@pytest.mark.parametrize('case', ['mixed', 'zero_grad_no_decay', 'large'])
def test_fused_lamb_matches_per_tensor_plain(dev, case):
    shapes = [(33, 47), (128,), (1,), (5, 8, 13), (8193,), (257,)]
    attrs, zero = dict(LAMB), ()
    if case == 'zero_grad_no_decay':
        attrs['weight_decay'], zero = 0.0, (1, 2)
    elif case == 'large':
        shapes = [(30522, 768), (768,), (3072, 768), (1,)]
    ins = _lamb_ins(dev, shapes, zero)
    want = opt_k.apply_plain('lamb', None, _clone(ins), attrs)
    runs = []
    for _ in range(2):  # twice from the same state: the same bits
        got = _clone(ins)
        before = common.launches('fused_lamb')
        opt_k.apply_kernel('lamb', got, attrs)
        assert common.launches('fused_lamb') == before + 1
        runs.append(got)
    torch.cuda.synchronize()
    for slot, out in (('Moment1', 'Moment1Out'), ('Moment2', 'Moment2Out')):
        for a, b in zip(runs[0][slot], want[out]):
            assert torch.equal(a, b), slot
    for a, b in zip(runs[0]['Param'], want['ParamOut']):
        torch.testing.assert_close(a, b, rtol=2e-6, atol=3e-7)
    for a, b in zip(runs[0]['Param'], runs[1]['Param']):
        assert torch.equal(a, b)
    for i in zero:  # trust 1 and a zero step
        assert torch.equal(runs[0]['Param'][i], ins['Param'][i])


@pytest.mark.parametrize('rows,d,n,hot', [(1000001, 16, 106496, False),
                                          (1000, 16, 106496, False),
                                          (1000001, 1, 106496, False),
                                          (512, 768, 4096, False),
                                          (64, 16, 8192, True)])
def test_embedding_update_bitwise(dev, rows, d, n, hot):
    g = _gen(dev, 2)
    w = torch.randn(rows, d, generator=g, device=dev)
    m = torch.rand(rows, d, generator=g, device=dev)
    ids = torch.zeros(n, dtype=torch.int64, device=dev) if hot else \
        torch.randint(0, rows, (n,), generator=g, device=dev)
    ids[:6] = torch.tensor([3, 3, -7, rows, rows + 9, rows - 1], device=dev)
    grad = torch.randn(n, d, generator=g, device=dev)
    lr = torch.full((1,), 0.05, device=dev)
    want_w, want_m = emb_k.update_plain(w, m, ids, grad, lr, 1e-6)
    got_w, got_m = w.clone(), m.clone()
    before = common.launches('embedding_update')
    emb_k.update_kernel(got_w, got_m, ids, grad, lr, 1e-6)
    assert common.launches('embedding_update') == before + 1
    torch.cuda.synchronize()
    assert torch.equal(got_w, want_w)
    assert torch.equal(got_m, want_m)


def test_fused_emb_update_op_zeroes_padding_rows(dev):
    g = _gen(dev, 3)
    w = torch.randn(600, 16, generator=g, device=dev)
    m = torch.rand(600, 16, generator=g, device=dev)
    ids = torch.randint(0, 40, (128, 26, 1), generator=g, device=dev)
    ins = {'Param': [w.clone()], 'Moment': [m.clone()], 'Ids': [ids],
           'Grad': [torch.randn(128, 26, 16, generator=g, device=dev)],
           'LearningRate': [torch.full((1,), 0.1, device=dev)]}
    attrs = {'epsilon': 1e-6, 'padding_idx': 7}
    got = emb_k.apply_update(None, ins, attrs)
    plain = {k: [x.clone() for x in v] for k, v in ins.items()}
    plain['Param'], plain['Moment'] = [w.clone()], [m.clone()]
    fluid.set_flags({'FLAGS_torch_kernels_plain': True})
    try:
        want = emb_k.apply_update(None, plain, attrs)
    finally:
        fluid.set_flags({'FLAGS_torch_kernels_plain': False})
    torch.cuda.synchronize()
    assert got['ParamOut'][0] is ins['Param'][0]  # in place
    for slot in ('ParamOut', 'MomentOut'):
        assert torch.equal(got[slot][0], want[slot][0])
    assert torch.equal(got['ParamOut'][0][7], w[7])
    assert torch.equal(got['ParamOut'][0][100:], w[100:])


def test_small_lamb_training_step_launches_one_run(dev):
    cfg = bert.BertConfig(vocab_size=1000, hidden=128, layers=2, heads=2,
                          intermediate=256, max_pos=128)
    cfg.flash_min_len = 0
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = 5
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        _, _, loss = bert.build_pretrain(cfg, seq_len=128)
        lr = fluid.layers.linear_lr_warmup(
            fluid.layers.polynomial_decay(1e-3, 100, 0.0), 2, 0.0, 1e-3)
        fluid.optimizer.Lamb(
            lr, grad_clip=fluid.clip.GradientClipByGlobalNorm(1.0)
        ).minimize(loss)
    batch = bert.synthetic_batch(cfg, 2, 128, np.random.RandomState(0))
    exe, scope = fluid.Executor(fluid.CUDAPlace(0)), fluid.Scope()
    with fluid.scope_guard(scope):
        exe.run(startup)
        for _ in range(2):
            common.reset_launches()
            (out,) = exe.run(main, feed=batch, fetch_list=[loss])
            assert np.isfinite(out)
            assert {k: common.launches(k) for k in common.KERNELS} == {
                'flash_attention': 2, 'flash_attention_bwd': 2,
                'embedding_lookup': 3, 'embedding_scatter_add': 3,
                'fused_adam': 0, 'fused_lamb': 1, 'embedding_update': 0}


def test_small_wide_deep_step_launches_the_row_update(dev):
    cfg = wide_deep.WideDeepConfig(sparse_feature_dim=5000)
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = 5
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        _, _, loss = wide_deep.build(cfg)
        fluid.optimizer.Adagrad(1e-3, epsilon=1e-6).minimize(loss)
    batch = wide_deep.synthetic_batch(cfg, 256, np.random.RandomState(0))
    exe, scope = fluid.Executor(fluid.CUDAPlace(0)), fluid.Scope()
    losses = []
    with fluid.scope_guard(scope):
        exe.run(startup)
        for _ in range(3):
            common.reset_launches()
            losses.append(float(exe.run(main, feed=batch,
                                        fetch_list=[loss])[0]))
            assert {k: common.launches(k) for k in common.KERNELS} == {
                'flash_attention': 0, 'flash_attention_bwd': 0,
                'embedding_lookup': 2, 'embedding_scatter_add': 0,
                'fused_adam': 0, 'fused_lamb': 0, 'embedding_update': 2}
    assert np.all(np.isfinite(losses)) and losses[-1] < losses[0]
