"""The dropout op's redesigned kernels on the card (csrc/dropout_mask.cu):
the forward without Mask and the gradient from the saved seed.  Marked
`cuda`: every test skips where torch has no CUDA device.  Run the
card-only tests on a GPU machine with

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_*.py

This file imports torch and the port only.

- the gradient kernel bitwise the gradient from the saved Mask
  (``dropout_grad``, the PyTorch chain it replaces): f32 and bf16, both
  implementations, p 0.1 / 0 / 1, NaN, +-inf and -0 among the
  gradients, an odd count, one element, a non-contiguous gradient, a
  second launch bitwise the first;
- the forward without Mask gives the forward's Out bits and no Mask,
  one counted launch, the 16-byte and the element-by-element paths;
- no fallback: the gradient kernel raises on an f64 gradient and on a
  seed off the gradient's device; the autograd Function's backward
  launches the gradient kernel once and runs no PyTorch chain;
- a seeded BERT-tiny training step on the card: the same loss and
  state bit for bit with a Mask fetched and without, the peak memory no
  higher without, and its CUDA-graph replay bitwise its eager step with
  launches + replayed launches of both dropout kernels the eager ones.
"""

import numpy as np
import pytest
import torch

import paddle_tpu_torch.fluid as fluid
from paddle_tpu_torch.models import bert
from paddle_tpu_torch.ops.kernels import common
from paddle_tpu_torch.ops.kernels import dropout as dk

pytestmark = pytest.mark.cuda

RATE = 0.1


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')
    return torch.device('cuda', 0)


def _bits(t):
    t = t.contiguous()
    return t.view(torch.int16 if t.element_size() == 2 else torch.int32)


def _t(dev, shape, dtype, seed):
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    x = torch.randn(*shape, generator=g, device=dev)
    special = torch.tensor([float('nan'), float('inf'), -float('inf'),
                            -0.0], device=dev)[:x.numel()]
    x.view(-1)[:special.numel()] = special
    return x.to(dtype)


@pytest.mark.parametrize('p', [0.1, 0.0, 1.0])
@pytest.mark.parametrize('upscale', [True, False])
@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
def test_grad_kernel_is_the_grad_from_the_mask(dev, dtype, upscale, p):
    seed = torch.tensor(2 ** 32 - 7, device=dev)
    for shape in ((8, 512, 768), (3, 5, 7), (1,)):
        g = _t(dev, shape, dtype, 1)
        before = common.launches('dropout_grad')
        dx = dk.dropout_grad_kernel(g, seed, p, upscale)
        dx2 = dk.dropout_grad_kernel(g, seed, p, upscale)
        assert common.launches('dropout_grad') == before + 2
        mask = dk.hash_keep(seed, shape, p, dev).to(dtype)
        want = dk.dropout_grad(g, mask, p, upscale)
        torch.cuda.synchronize()
        assert dx.dtype == dtype
        assert torch.equal(_bits(dx), _bits(want)), shape
        assert torch.equal(_bits(dx), _bits(dx2)), shape


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
def test_forward_without_mask_and_views(dev, dtype):
    seed = torch.tensor(91, device=dev)
    for shape in ((8, 512, 768), (7, 13, 33), (2,)):
        x = _t(dev, shape, dtype, 2)
        before = common.launches('dropout')
        out, none = dk.dropout_kernel(x, seed, RATE, True, False)
        assert none is None and common.launches('dropout') == before + 1
        want, _ = dk.dropout_plain(x, seed, RATE, True)
        assert torch.equal(_bits(out), _bits(want)), shape
    g = torch.randn(64, 64, 2049, device=dev).to(dtype)
    for view in (g[..., 1:], g.view(-1)[1:1 + 64 * 64 * 2048]):
        dx = dk.dropout_grad_kernel(view, seed, RATE, True)
        mask = dk.hash_keep(seed, view.shape, RATE, dev).to(dtype)
        assert torch.equal(_bits(dx), _bits(dk.dropout_grad(
            view.contiguous(), mask, RATE, True)))


def test_no_fallback_and_one_backward_launch(dev):
    seed = torch.tensor(5, device=dev)
    with pytest.raises(TypeError, match='f32 or bf16'):
        dk.dropout_grad_kernel(torch.ones(8, device=dev,
                                          dtype=torch.float64), seed, RATE,
                               True)
    with pytest.raises(ValueError, match='seed'):
        dk.dropout_grad_kernel(torch.ones(8, device=dev), torch.tensor(5),
                               RATE, True)
    x = torch.randn(4, 33, 65, device=dev, requires_grad=True)
    g = torch.randn(4, 33, 65, device=dev)
    out, mask = dk.dropout(x, seed, RATE, True, False)
    assert mask is None
    before = {k: common.launches(k) for k in ('dropout', 'dropout_grad')}
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        got, = torch.autograd.grad(out, x, g)
    assert common.launches('dropout_grad') == before['dropout_grad'] + 1
    assert common.launches('dropout') == before['dropout']
    names = {e.key for e in prof.key_averages()}
    assert not names & {'aten::where', 'aten::ne', 'aten::div'}, names
    keep = dk.hash_keep(seed, x.shape, RATE, dev)
    assert torch.equal(got, dk.dropout_grad(g, keep.float(), RATE, True))


def test_bert_tiny_step_with_and_without_mask_and_replayed(dev):
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = 3
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        _, _, loss = bert.build_pretrain(bert.TINY, seq_len=64)
        fluid.optimizer.Adam(learning_rate=1e-3).minimize(loss)
    feed = bert.synthetic_batch(bert.TINY, 8, 64, np.random.RandomState(0))
    drops = [op for op in main.global_block().ops if op.type == 'dropout']
    masks = [op.output('Mask')[0] for op in drops]
    params = sorted(p.name for p in main.all_parameters())
    runs = {}
    for case, extra in (('without', []), ('with', masks)):
        exe, scope = fluid.Executor(fluid.CUDAPlace(0)), fluid.Scope()
        with fluid.scope_guard(scope):
            exe.run(startup)
            plan = exe._get_plan(main, feed, [loss.name] + extra)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            common.reset_launches()
            out = exe._run_graphed(plan, main, feed, [loss.name] + extra,
                                   scope, False, graphs=False)
            torch.cuda.synchronize()
            peak = torch.cuda.max_memory_allocated()
            eager = {k: common.launches(k) for k in ('dropout',
                                                     'dropout_grad')}
            assert eager == {'dropout': len(drops),
                             'dropout_grad': len(drops)}
            state = [scope.find_var(p).clone() for p in params]
        runs[case] = (out[0].clone(), state, peak)
        if case == 'with':
            assert len(out) == 1 + len(drops)
            for m in out[1:]:
                assert set(torch.unique(m).tolist()) <= {0.0, 1.0}
    (la, sa, pa), (lb, sb, pb) = runs['without'], runs['with']
    assert torch.equal(la, lb)
    assert all(torch.equal(a, b) for a, b in zip(sa, sb))
    assert pa <= pb
    # three runs of the default path (eager, capture + replay, replay)
    # from one state against eager steps from the same state
    exe, scope = fluid.Executor(fluid.CUDAPlace(0)), fluid.Scope()
    ref_exe, ref_scope = fluid.Executor(fluid.CUDAPlace(0)), fluid.Scope()
    with fluid.scope_guard(scope):
        exe.run(startup)
    with fluid.scope_guard(ref_scope):
        ref_exe.run(startup)
    for p in params:
        ref_scope.find_var(p).copy_(scope.find_var(p))
    for step in range(3):
        with fluid.scope_guard(scope):
            common.reset_launches()
            got = exe.run(main, feed=feed, fetch_list=[loss],
                          return_numpy=False)[0].clone()
            ran = {k: common.launches(k) + common.replayed(k)
                   for k in ('dropout', 'dropout_grad')}
        with fluid.scope_guard(ref_scope):
            plan = ref_exe._get_plan(main, feed, [loss.name])
            want = ref_exe._run_graphed(plan, main, feed, [loss.name],
                                        ref_scope, False, graphs=False)[0]
        assert ran == {'dropout': len(drops), 'dropout_grad': len(drops)}
        assert torch.equal(got, want), step
    for p in params:
        assert torch.equal(scope.find_var(p), ref_scope.find_var(p)), p
