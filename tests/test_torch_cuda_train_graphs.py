"""Training steps replayed from CUDA graphs on the card
(fluid/cuda_graph.py), at small sizes: BERT (2 layers, hidden 64, 2
heads of 32, seq 64, flash_min_len 0 so attention is K1/K2 with attention
dropout 0.1, hidden dropout 0.1) with Adam in f32 and under AMP (K1/K2
on their bf16 route), the Transformer (2 + 2 layers, d_model 64,
dropout 0.1) with Adam, LeNet-5 with Adam, and two conv + batch-norm
blocks with Momentum (the running statistics updated in place).

- 4 steps through ``Executor.run`` (the first eager on the capture
  stream, the second captured and replayed, two more replays) are
  bitwise 4 eager steps of the cached plan (``Executor._run_graphed``
  with graphs=False) from the same state and step: every loss and
  every startup variable, and the executor's step; the launches at the wrappers plus the replayed launches
  are the eager steps' launches, kernel by kernel; one capture, three
  replays, nothing refused; the scope's tensors are the same objects;
- the dropout op's hash and the attention seed on the card are bitwise
  the CPU's;
- a replay at another ``exe._step`` draws other attention masks, and
  a replay at the same step the same ones, bitwise the eager step;
- ``Executor.warmup`` captures a training step ahead of the first run
  and leaves the state as it found it.

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
from paddle_tpu_torch.dataset import mnist
from paddle_tpu_torch.fluid import compile_cache
from paddle_tpu_torch.fluid import executor
from paddle_tpu_torch.models import bert
from paddle_tpu_torch.models import lenet
from paddle_tpu_torch.models import transformer
from paddle_tpu_torch.ops.kernels import common

pytestmark = pytest.mark.cuda

SEQ = 64
STEPS = 4


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')
    torch.backends.cudnn.deterministic = True
    yield torch.device('cuda', 0)
    torch.backends.cudnn.deterministic = False


def _program(build, seed=7):
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = seed
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        loss = build()
    return main, startup, loss


def _bert(amp, hidden_dropout=0.1):
    cfg = bert.BertConfig(vocab_size=1000, hidden=64, layers=2, heads=2,
                          intermediate=128, max_pos=SEQ,
                          dropout=hidden_dropout, attn_dropout=0.1)
    cfg.flash_min_len = 0

    def build():
        _, _, loss = bert.build_pretrain(cfg, seq_len=SEQ)
        opt = fluid.optimizer.Adam(1e-3, epsilon=1e-6)
        if amp:
            opt = fluid.contrib.mixed_precision.decorate(
                opt, use_dynamic_loss_scaling=True)
        opt.minimize(loss)
        return loss
    main, startup, loss = _program(build)
    return main, startup, loss, bert.synthetic_batch(
        cfg, 4, SEQ, np.random.RandomState(0))


def _nmt():
    cfg = transformer.TransformerConfig(
        src_vocab=500, tgt_vocab=500, d_model=64, heads=4, ffn=128,
        enc_layers=2, dec_layers=2, dropout=0.1, max_len=64)

    def build():
        _, _, loss = transformer.build(cfg, src_len=16, tgt_len=16)
        fluid.optimizer.Adam(1e-3, epsilon=1e-6).minimize(loss)
        return loss
    main, startup, loss = _program(build)
    return main, startup, loss, transformer.synthetic_batch(
        cfg, 8, 16, 16, np.random.RandomState(0))


def _lenet():
    def build():
        _, _, loss, _ = lenet.build()
        fluid.optimizer.Adam(1e-3).minimize(loss)
        return loss
    main, startup, loss = _program(build)
    imgs, labels = mnist._synthetic(16, 0)
    return main, startup, loss, {'img': imgs.reshape(-1, 1, 28, 28),
                                 'label': labels.reshape(-1, 1)}


def _convnet():
    """Two conv + batch-norm blocks with Momentum: the running
    statistics are state the graph updates in place."""
    def build():
        img = fluid.layers.data('img', shape=[3, 16, 16], dtype='float32')
        label = fluid.layers.data('label', shape=[1], dtype='int64')
        h = img
        for ch in (8, 16):
            h = fluid.layers.batch_norm(fluid.layers.conv2d(h, ch, 3),
                                        act='relu')
        logits = fluid.layers.fc(fluid.layers.pool2d(h, 2), 10)
        loss = fluid.layers.mean(fluid.layers.softmax_with_cross_entropy(
            logits, label))
        fluid.optimizer.Momentum(0.1, 0.9).minimize(loss)
        return loss
    main, startup, loss = _program(build)
    rng = np.random.RandomState(0)
    return main, startup, loss, {
        'img': rng.rand(16, 3, 16, 16).astype('float32'),
        'label': rng.randint(0, 10, (16, 1)).astype('int64')}


PATHS = {'bert_f32': lambda: _bert(False), 'bert_amp': lambda: _bert(True),
         'transformer': _nmt, 'lenet': _lenet, 'convnet_bn': _convnet}


def _stat(name):
    return compile_cache.counter_value('executor/' + name)


def _run(exe, program, feed, fetch_list, graphs=True):
    """Executor.run, or with graphs=False its path without the CUDA
    graph: the cached plan run op by op."""
    if graphs:
        return exe.run(program, feed=feed, fetch_list=fetch_list)
    fetch = executor._fetch_names(fetch_list)
    plan = exe._get_plan(program, feed, fetch)
    return exe._run_graphed(plan, program, feed, fetch,
                            fluid.global_scope(), True, graphs=False)


def _side(exe, scope, path, start, step0, graphs):
    """STEPS steps from `start` (written in place) at executor step
    step0: (losses, state after, launches, replayed launches)."""
    main, _, loss, feed = path
    for n, v in start.items():
        scope.find_var(n).copy_(v)
    exe._step = step0
    common.reset_launches()
    losses = [_run(exe, main, feed, [loss], graphs)[0]
              for _ in range(STEPS)]
    assert exe._step == step0 + STEPS
    torch.cuda.synchronize()
    state = {n: scope.find_var(n).clone() for n in start}
    return (losses, state,
            {k: common.launches(k) for k in common.KERNELS},
            {k: common.replayed(k) for k in common.KERNELS})


@pytest.mark.parametrize('name', sorted(PATHS))
def test_replayed_steps_are_bitwise_eager(dev, name):
    path = PATHS[name]()
    main, startup = path[0], path[1]
    names = weights.startup_names(startup)
    exe, scope = fluid.Executor(fluid.CUDAPlace(0)), fluid.Scope()
    with fluid.scope_guard(scope):
        exe.run(startup)
        held = {n: scope.find_var(n) for n in names}
        start = {n: v.clone() for n, v in held.items()}
        step0 = exe._step
        e_loss, e_state, e_launch, e_replay = _side(
            exe, scope, path, start, step0, False)
        stats = {k: _stat(k) for k in ('graph_captures', 'graph_replays',
                                       'graph_refused', 'graph_stale')}
        g_loss, g_state, g_launch, g_replay = _side(
            exe, scope, path, start, step0, True)
        assert all(scope.find_var(n) is v for n, v in held.items())
    assert {k: _stat(k) - v for k, v in stats.items()} == {
        'graph_captures': 1, 'graph_replays': STEPS - 1,
        'graph_refused': 0, 'graph_stale': 0}
    for a, b in zip(e_loss, g_loss):
        assert np.array_equal(a, b)
    assert e_loss[0] != e_loss[-1]
    for n in names:
        assert torch.equal(e_state[n], g_state[n]), n
    assert not any(e_replay.values())
    for k in common.KERNELS:
        assert g_launch[k] + g_replay[k] == e_launch[k], k
    if name.startswith('bert'):
        assert e_launch['flash_attention'] == STEPS * 2
        assert g_replay['flash_attention_bwd'] == (STEPS - 1) * 2
    if name != 'convnet_bn':  # Momentum: no kernel of the port
        assert e_launch['fused_adam'] == STEPS
        assert g_replay['fused_adam'] == STEPS - 1


def test_device_draws_are_the_cpus(dev):
    """The dropout op's hash and the attention seed computed on the card
    are bitwise the CPU's, seeds and steps past 2**31 included."""
    from paddle_tpu_torch.ops import registry
    from paddle_tpu_torch.ops.kernels import dropout
    for seed in (0, 5, 2 ** 31 - 1, 2 ** 31, 2 ** 32 - 1):
        got = dropout.hash_keep(torch.tensor(seed, device=dev), (96, 77),
                                 0.1, dev)
        want = dropout.hash_keep(torch.tensor(seed), (96, 77), 0.1, 'cpu')
        assert torch.equal(got.cpu(), want), seed
    for step in (1, 2 ** 31 + 9, 2 ** 32 + 5):
        got = registry.LowerCtx(step, 7, device=dev).dropout_seed({})
        want = registry.LowerCtx(step, 7).dropout_seed({})
        assert got.is_cuda and int(got) == int(want), step


def test_a_replay_draws_the_masks_of_its_step(dev):
    path = _bert(False, hidden_dropout=0.0)
    main, startup, loss, feed = path
    names = weights.startup_names(startup)
    exe, scope = fluid.Executor(fluid.CUDAPlace(0)), fluid.Scope()
    with fluid.scope_guard(scope):
        exe.run(startup)
        start = {n: scope.find_var(n).clone() for n in names}

        def step_at(k, graphs):
            for n, v in start.items():
                scope.find_var(n).copy_(v)
            exe._step = k - 1
            return _run(exe, main, feed, [loss], graphs)[0]

        eager = {k: step_at(k, False) for k in (5, 6, 2 ** 31 + 3)}
        for _ in range(2):  # the first run, then the capture
            step_at(9, True)
        replays = _stat('graph_replays')
        for k in (5, 6, 2 ** 31 + 3, 5):
            assert np.array_equal(step_at(k, True), eager[k]), k
        assert _stat('graph_replays') == replays + 4
    assert not np.array_equal(eager[5], eager[6])
    assert not np.array_equal(eager[5], eager[2 ** 31 + 3])


def test_warmup_captures_a_training_step_and_keeps_the_state(dev):
    main, startup, loss, feed = _lenet()
    names = weights.startup_names(startup)
    exe, scope = fluid.Executor(fluid.CUDAPlace(0)), fluid.Scope()
    with fluid.scope_guard(scope):
        exe.run(startup)
        held = {n: scope.find_var(n) for n in names}
        start = {n: v.clone() for n, v in held.items()}
        step = exe._step
        res = exe.warmup(main, [{k: (v.shape, v.dtype)
                                 for k, v in feed.items()}], [loss])
        assert len(res.captured) == 1 and res.skipped == []
        assert exe._step == step
        for n, v in held.items():
            assert scope.find_var(n) is v and torch.equal(v, start[n]), n
        captures, replays = _stat('graph_captures'), _stat('graph_replays')
        got = exe.run(main, feed=feed, fetch_list=[loss])[0]
        assert _stat('graph_captures') == captures
        assert _stat('graph_replays') == replays + 1
        after = {n: v.clone() for n, v in held.items()}
    exe2, scope2 = fluid.Executor(fluid.CUDAPlace(0)), fluid.Scope()
    with fluid.scope_guard(scope2):
        exe2.run(startup)
        for n, v in start.items():
            scope2.find_var(n).copy_(v)
        exe2._step = step
        want = _run(exe2, main, feed, [loss], graphs=False)[0]
        for n in names:
            assert torch.equal(scope2.find_var(n), after[n]), n
    assert np.array_equal(got, want)
