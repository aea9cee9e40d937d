"""The attention chain below seq 512 on the card (phase 11 of
chip_smoke.py at small sizes): f32 products computed in f32 whatever
torch.backends.cuda.matmul.allow_tf32 says, forward and backward; the
slice's ops on the card against the same ops on the CPU; BERT at seq 128
served and trained and the Transformer trained on CUDAPlace(0) against
CPUPlace() from the same state, with the kernels each step launches.
Marked `cuda`: every test skips where torch has no CUDA device.  Run on
a GPU machine with

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_*.py

This file imports torch and the port only.
"""

import numpy as np
import pytest
import torch

import paddle_tpu_torch.fluid as fluid
from paddle_tpu_torch import weights
from paddle_tpu_torch.inference import AnalysisConfig, create_paddle_predictor
from paddle_tpu_torch.models import bert, transformer
from paddle_tpu_torch.ops import registry
from paddle_tpu_torch.ops.kernels import common

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')
    return torch.device('cuda', 0)


def _run(op, ins, attrs, device, grad=None):
    """The op's outputs on `device` and, with `grad` (cotangents of its
    first output), the gradients of its floating inputs."""
    ctx = registry.LowerCtx(step=1, op_seed=0, device=device)
    ins = {s: [x.to(device).requires_grad_(x.is_floating_point())
               for x in v] for s, v in ins.items()}
    with torch.enable_grad():
        outs = registry.get(op).run(ctx, ins, attrs)
        if grad is None:
            return outs, None
        xs = [x for v in ins.values() for x in v if x.requires_grad]
        first = next(iter(outs.values()))[0]
        return outs, torch.autograd.grad(first, xs, grad.to(device))


def _rel(a, b):
    a, b = a.detach().double().cpu(), b.detach().double().cpu()
    return ((a - b).abs().max() / b.abs().max().clamp_min(1e-30)).item()


def test_f32_matmul_is_f32_with_tf32_allowed(dev):
    """With allow_tf32 True, the attention scores' matmul and both its
    gradients agree with float64 to 1e-5 of their largest magnitude (f32
    sums of 64 and 128 terms land near 1e-6; TF32 keeps 10 mantissa
    bits, about 1e-3), and the flag is True again afterwards."""
    g = torch.Generator().manual_seed(0)
    x = torch.randn(4, 12, 128, 64, generator=g)
    y = torch.randn(4, 12, 128, 64, generator=g)
    ct = torch.randn(4, 12, 128, 128, generator=g)
    attrs = {'transpose_Y': True, 'alpha': 0.125}
    want, wgrads = _run('matmul', {'X': [x.double()], 'Y': [y.double()]},
                        attrs, 'cpu', ct.double())
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        got, grads = _run('matmul', {'X': [x], 'Y': [y]}, attrs, dev, ct)
        torch.cuda.synchronize()
        assert torch.backends.cuda.matmul.allow_tf32 is True
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    errs = [_rel(got['Out'][0], want['Out'][0])] + [
        _rel(a, b) for a, b in zip(grads, wgrads)]
    print('matmul rel errors against float64 (out, dX, dY):', errs)
    assert max(errs) <= 1e-5, errs


def _soft(g, *shape):
    p = torch.rand(*shape, generator=g)
    return p / p.sum(-1, keepdim=True)


def test_slice_ops_on_the_card_match_the_cpu(dev):
    """Exact ops bitwise; sums and transcendental functions within 1e-5
    of the largest magnitude; position_encoding at length 256 within 2
    ulps of its largest angle (255) plus 2 ulps of 1, the f32 rounding
    of the power and the sine that the card's libraries may place
    elsewhere."""
    g = torch.Generator().manual_seed(1)
    f = lambda *s: torch.randn(*s, generator=g)  # noqa: E731
    cases = [
        ('transpose2', {'X': [f(2, 3, 4, 5)]}, {'axis': [0, 2, 1, 3]}, 0),
        ('squeeze2', {'X': [f(2, 1, 3, 1)]}, {'axes': [1, 3]}, 0),
        ('expand', {'X': [f(2, 1, 3)]}, {'expand_times': [1, 4, 2]}, 0),
        ('stack', {'X': [f(2, 3), f(2, 3)]}, {'axis': 1}, 0),
        ('gather', {'X': [f(6, 3)], 'Index': [torch.tensor([0, 5, -1])]},
         {}, 0),
        ('one_hot', {'X': [torch.tensor([[1, 3], [9, -1]])]}, {'depth': 9},
         0),
        ('label_smooth', {'X': [f(3, 5)]}, {'epsilon': 0.1}, 0),
        ('causal_mask_like', {'X': [f(2, 9, 4)]}, {}, 0),
        ('log_softmax', {'X': [f(3, 4, 7) * 5]}, {'axis': -1}, 1e-5),
        ('softmax_with_cross_entropy',
         {'Logits': [f(3, 4, 700) * 3], 'Label': [_soft(g, 3, 4, 700)]},
         {'soft_label': True}, 1e-5),
        ('position_encoding', {'X': [f(1, 256, 512)]}, {'d_model': 512},
         2.0 ** -23 * (2 * 255 + 2)),
    ]
    for op, ins, attrs, tol in cases:
        want, _ = _run(op, ins, attrs, 'cpu')
        got, _ = _run(op, ins, attrs, dev)
        for s in want:
            for a, b in zip(got[s], want[s]):
                a = a.detach().cpu()
                assert a.shape == b.shape and a.dtype == b.dtype, (op, s)
                if tol == 0:
                    assert torch.equal(a, b.detach()), (op, s)
                elif op == 'position_encoding':
                    err = (a - b).abs().max().item()
                    print('position_encoding card vs CPU:', err)
                    assert err <= tol, err
                else:
                    assert _rel(a, b) <= tol, (op, s, _rel(a, b))


def _counted(fn):
    """(fn(), the launches it ran): at the wrappers, and replayed in a
    CUDA graph (a training step's second run on and)."""
    common.reset_launches()
    out = fn()
    torch.cuda.synchronize()
    ran = {k: common.launches(k) + common.replayed(k)
           for k in common.KERNELS}
    return out, {k: n for k, n in ran.items() if n}


def _train_step(build, feeds, places):
    """Each place's losses over `feeds` from the CPU's startup values,
    and the card's launches a step."""
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = 5
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        loss = build()
        fluid.optimizer.Adam(learning_rate=1e-3, epsilon=1e-6).minimize(loss)
    names = weights.startup_names(startup)
    state = None
    losses, launched = {}, []
    for place in places:
        exe, scope = fluid.Executor(place), fluid.Scope()
        with fluid.scope_guard(scope):
            exe.run(startup)
            if state is None:
                state = weights.numpy_state(scope, names)
            weights.load_numpy_params(scope, state, place, startup)
            losses[str(place)] = []
            for feed in feeds:
                out, counts = _counted(lambda: exe.run(
                    main, feed=feed, fetch_list=[loss]))
                losses[str(place)].append(float(out[0]))
                if place != fluid.CPUPlace():
                    launched.append(counts)
    return losses, launched


def test_bert_seq128_steps_on_the_card(dev):
    cfg = bert.BertConfig(vocab_size=1000, hidden=64, layers=2, heads=4,
                          intermediate=128, max_pos=128, dropout=0.0)
    rng = np.random.RandomState(0)
    feeds = [bert.synthetic_batch(cfg, 4, 128, rng) for _ in range(2)]
    losses, launched = _train_step(
        lambda: bert.build_pretrain(cfg, 128)[2], feeds,
        [fluid.CPUPlace(), fluid.CUDAPlace(0)])
    cpu, card = losses.values()
    np.testing.assert_allclose(card, cpu, rtol=1e-5)
    assert launched == [{'embedding_lookup': 3, 'embedding_scatter_add': 3,
                         'fused_adam': 1}] * 2


def test_transformer_steps_on_the_card(dev):
    """Two steps at length 16, then one of the 8 bucket on the same
    Program."""
    cfg = transformer.TransformerConfig(
        src_vocab=500, tgt_vocab=500, d_model=64, heads=4, ffn=128,
        enc_layers=2, dec_layers=2, dropout=0.0)
    rng = np.random.RandomState(0)
    feeds = [transformer.synthetic_batch(cfg, 4, 16, 16, rng)
             for _ in range(2)]
    feeds.append(transformer.synthetic_batch(cfg, 4, 8, 8, rng))
    losses, launched = _train_step(
        lambda: transformer.build(cfg, src_len=16, tgt_len=16)[2], feeds,
        [fluid.CPUPlace(), fluid.CUDAPlace(0)])
    cpu, card = losses.values()
    np.testing.assert_allclose(card, cpu, rtol=1e-5)
    assert launched == [{'embedding_lookup': 2, 'embedding_scatter_add': 2,
                         'fused_adam': 1}] * 3


def test_seq128_serving_on_the_card(dev, tmp_path):
    cfg = bert.BertConfig(vocab_size=1000, hidden=64, layers=2, heads=4,
                          intermediate=128, max_pos=128)
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = 5
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        feeds, enc, _ = bert.build_pretrain(cfg, 128, is_test=True)
    names = ['src_ids', 'pos_ids', 'sent_ids', 'input_mask']
    exe = fluid.Executor(fluid.CPUPlace())
    with fluid.scope_guard(fluid.Scope()):
        exe.run(startup)
        fluid.io.save_inference_model(str(tmp_path), names, [enc], exe,
                                      main_program=main)
    cpu_cfg = AnalysisConfig(str(tmp_path))
    cpu_cfg.disable_gpu()
    cpu = create_paddle_predictor(cpu_cfg)
    card = create_paddle_predictor(AnalysisConfig(str(tmp_path)))
    feed = bert.encoder_batch(cfg, 8, 128, np.random.RandomState(1),
                              pad_to=100)
    inputs = [feed[n] for n in names]
    got, counts = _counted(lambda: card.run(inputs)[0].data)
    want = cpu.run(inputs)[0].data
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    assert counts == {'embedding_lookup': 3}
