"""The image-classification slice on the card: f32 convolutions computed
in f32 whatever torch.backends.cudnn.allow_tf32 says, the slice's
lowerings on the card against the same lowerings on the CPU, and a
LeNet-5 + Adam step that launches the multi-tensor Adam kernel once.
Marked `cuda`: every test skips where torch has no CUDA device.  Run on
a GPU machine with

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_*.py

This file imports torch and the port only.
"""

import numpy as np
import pytest
import torch

import paddle_tpu_torch.fluid as fluid
from paddle_tpu_torch.dataset import mnist
from paddle_tpu_torch.models import lenet
from paddle_tpu_torch.ops import registry
from paddle_tpu_torch.ops.kernels import common

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')
    return torch.device('cuda', 0)


def _run(op, ins, attrs, device):
    ctx = registry.LowerCtx(step=1, op_seed=0, device=device)
    return registry.get(op).run(
        ctx, {s: [x.to(device) for x in v] for s, v in ins.items()}, attrs)


def _grads(op, ins, attrs, cts, device):
    ctx = registry.LowerCtx(step=1, op_seed=0, device=device)
    g = {s: [x.to(device) for x in v] for s, v in ins.items()}
    g.update({s: [x.to(device) for x in v] for s, v in cts.items()})
    return registry.get(op + '_grad').run(ctx, g, attrs)


def _rel(a, b):
    a, b = a.double().cpu(), b.double().cpu()
    return ((a - b).abs().max() / b.abs().max().clamp_min(1e-30)).item()


@pytest.mark.parametrize('nhwc', [False, True])
def test_f32_conv_is_f32_with_tf32_allowed(dev, nhwc):
    """With torch.backends.cudnn.allow_tf32 True, conv2d's output and
    both gradients agree with a float64 computation to 1e-4 of their
    largest magnitude (f32 sums of up to 6272 terms land near 1e-5;
    TF32 keeps 10 mantissa bits, about 1e-3), and the flag is True again
    afterwards.  F.conv2d itself under the same flag is measured beside
    it and printed."""
    g = torch.Generator().manual_seed(0)
    x = torch.randn(8, 64, 28, 28, generator=g)
    w = torch.randn(64, 64, 3, 3, generator=g) * 0.05
    attrs = {'strides': [1, 1], 'paddings': [1, 1], 'dilations': [1, 1],
             'groups': 1, 'data_format': 'NHWC' if nhwc else 'NCHW'}
    if nhwc:
        x = x.permute(0, 2, 3, 1).contiguous()
    ins = {'Input': [x], 'Filter': [w]}
    ct = torch.randn(8, 64, 28, 28, generator=g)
    if nhwc:
        ct = ct.permute(0, 2, 3, 1).contiguous()
    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True
    try:
        out = _run('conv2d', ins, attrs, dev)['Output'][0]
        grads = _grads('conv2d', ins, attrs, {'GRAD::Output': [ct]}, dev)
        torch.cuda.synchronize()
        assert torch.backends.cudnn.allow_tf32
    finally:
        torch.backends.cudnn.allow_tf32 = prev
    ins64 = {'Input': [x.double()], 'Filter': [w.double()]}
    want = _run('conv2d', ins64, attrs, 'cpu')['Output'][0]
    want_g = _grads('conv2d', ins64, attrs, {'GRAD::Output': [ct.double()]},
                    'cpu')
    torch.backends.cudnn.allow_tf32 = True
    try:
        xc = x.to(dev).permute(0, 3, 1, 2) if nhwc else x.to(dev)
        raw = torch.nn.functional.conv2d(xc, w.to(dev), padding=1)
        raw = raw.permute(0, 2, 3, 1) if nhwc else raw
        torch.cuda.synchronize()
    finally:
        torch.backends.cudnn.allow_tf32 = prev
    print('conv2d vs float64, allow_tf32 True: the port %.2e, F.conv2d '
          '%.2e' % (_rel(out, want), _rel(raw, want)))
    assert _rel(out, want) <= 1e-4
    for slot in ('GRAD::Input', 'GRAD::Filter'):
        assert _rel(grads[slot][0], want_g[slot][0]) <= 1e-4, slot


CASES = [
    ('pool2d_max_overlap', 'pool2d', {'X': [(4, 8, 15, 15)]},
     {'pooling_type': 'max', 'ksize': [3, 3], 'strides': [2, 2],
      'paddings': [1, 1]}),
    ('pool2d_max_2x2', 'pool2d', {'X': [(4, 8, 16, 16)]},
     {'pooling_type': 'max', 'ksize': [2, 2], 'strides': [2, 2],
      'paddings': [0, 0]}),
    ('pool2d_avg_global', 'pool2d', {'X': [(4, 8, 7, 7)]},
     {'pooling_type': 'avg', 'ksize': [1, 1], 'global_pooling': True}),
    ('batch_norm_train', 'batch_norm',
     {'X': [(8, 16, 14, 14)], 'Scale': [(16,)], 'Bias': [(16,)],
      'Mean': [(16,)], 'Variance': [(16,)]},
     {'momentum': 0.9, 'epsilon': 1e-5, 'is_test': False,
      'data_layout': 'NCHW'}),
    ('conv2d_grouped', 'conv2d', {'Input': [(4, 32, 14, 14)],
                                  'Filter': [(32, 1, 3, 3)]},
     {'strides': [2, 2], 'paddings': [1, 1], 'dilations': [1, 1],
      'groups': 32, 'data_format': 'NCHW'}),
    ('softmax', 'softmax', {'X': [(16, 1000)]}, {'axis': -1}),
]


@pytest.mark.parametrize('case', CASES, ids=[c[0] for c in CASES])
def test_lowering_on_card_matches_cpu(dev, case):
    """Forward (rtol 1e-5, floor 1e-5 of the largest) and gradients
    (1e-4 of the largest) of the card's lowering against the CPU's on
    the same inputs."""
    _, op, shapes, attrs = case
    g = torch.Generator().manual_seed(1)
    ins = {s: [torch.randn(*sh, generator=g) for sh in v]
           for s, v in shapes.items()}
    if op == 'batch_norm':
        ins['X'][0] = ins['X'][0] * 2 + 3
        ins['Variance'][0] = ins['Variance'][0].abs() + 0.5
    want = _run(op, ins, attrs, 'cpu')
    got = _run(op, ins, attrs, dev)
    for s, vals in want.items():
        for a, b in zip(got[s], vals):
            scale = b.abs().max().item()
            torch.testing.assert_close(a.cpu(), b, rtol=1e-5,
                                       atol=1e-5 * scale)
    skip = registry.get(op).no_grad_out_slots
    cts = {'GRAD::' + s: [torch.randn(v[0].shape, generator=g)]
           for s, v in want.items() if s not in skip}
    gw = _grads(op, ins, attrs, cts, 'cpu')
    gg = _grads(op, ins, attrs, cts, dev)
    for s in gw:
        assert _rel(gg[s][0], gw[s][0]) <= 1e-4, s


def test_lenet_adam_launches_k4_once_a_step(dev):
    """LeNet-5 + Adam on CUDAPlace(0): one fused_adam launch a step,
    the loss falls over 3 steps; with SGD no kernel of the port."""
    imgs, labels = mnist._synthetic(64, 0)
    feed = {'img': imgs.reshape(-1, 1, 28, 28), 'label': labels[:, None]}
    for opt, want in (('adam', 1), ('sgd', 0)):
        main, startup = fluid.Program(), fluid.Program()
        main.random_seed = startup.random_seed = 1
        with fluid.unique_name.guard(), fluid.program_guard(main, startup):
            _, _, loss, _ = lenet.build()
            (fluid.optimizer.Adam(1e-3) if opt == 'adam' else
             fluid.optimizer.SGD(0.01)).minimize(loss)
        exe = fluid.Executor(fluid.CUDAPlace(0))
        losses = []
        with fluid.scope_guard(fluid.Scope()):
            exe.run(startup)
            for _ in range(3):
                common.reset_launches()
                losses.append(float(exe.run(main, feed=feed,
                                            fetch_list=[loss])[0]))
                # from the second step on, replayed in a CUDA graph
                ran = {k: common.launches(k) + common.replayed(k)
                       for k in common.KERNELS}
                assert ran['fused_adam'] == want
                assert sum(ran.values()) == want
        assert np.isfinite(losses).all() and losses[-1] < losses[0]
