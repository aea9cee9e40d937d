"""Control flow under CUDA graphs on the card, with phase 15's LSTM
seq2seq (models/seq2seq.py) at TINY widths with dropout 0.2, batch 4,
source length 7 and target length 5:

- 4 training steps through ``Executor.run`` (the first eager on the
  capture stream, the second captured with its bounded, masked While
  inside and replayed, two more replays) are bitwise 4 eager steps of
  the cached plan from the same state and executor step: every loss
  and every startup variable; one capture, three replays, nothing
  refused; the launches at the wrappers plus the replayed launches
  are the eager steps' (K6, K6b, K4 and the dropout kernels), kernel by
  kernel;
- the BeamSearchDecoder decode (no while: dynamic_decode unrolls) is
  captured, and its replays are bitwise its eager run;
- the book's decode, a forward-only While, is captured with a CUDA
  graph WHILE node (its condition read on the device each trip), and
  its replays are bitwise its eager host loop.

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
from paddle_tpu_torch.fluid import compile_cache
from paddle_tpu_torch.models import seq2seq
from paddle_tpu_torch.ops.kernels import common

pytestmark = pytest.mark.cuda

CFG = seq2seq.TINY._replace(dropout=0.2)
B, S, T = 4, 7, 5
STEPS = 4


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')
    yield torch.device('cuda', 0)


def _program(build, seed=7):
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = seed
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        out = build()
    return main, startup, out


def _train():
    loss = seq2seq.build_train(fluid, CFG, B, S, T)
    fluid.optimizer.Adam(
        1e-3, grad_clip=fluid.clip.GradientClipByGlobalNorm(5.0)).minimize(
            loss)
    return loss


def _stats():
    return {k: compile_cache.counter_value('executor/' + k)
            for k in ('graph_captures', 'graph_replays', 'graph_refused',
                      'graph_stale')}


def _eager(exe, program, feed, fetch):
    plan = exe._get_plan(program, feed, fetch)
    return exe._run_graphed(plan, program, feed, fetch,
                            fluid.global_scope(), True, graphs=False)


def _batch(seed=0):
    return seq2seq.synthetic_batch(CFG, B, S, T, np.random.RandomState(seed))


def test_training_steps_replay_bitwise_with_the_while_inside(dev):
    main, startup, loss = _program(_train)
    names = weights.startup_names(startup)
    feed = _batch()
    exe, scope = fluid.Executor(fluid.CUDAPlace(0)), fluid.Scope()
    sides = []
    with fluid.scope_guard(scope):
        exe.run(startup)
        start = {n: scope.find_var(n).clone() for n in names}
        step0 = exe._step
        for graphs in (False, True):
            for n, v in start.items():
                scope.find_var(n).copy_(v)
            exe._step = step0
            common.reset_launches()
            before = _stats()
            if graphs:
                losses = [exe.run(main, feed=feed, fetch_list=[loss])[0]
                          for _ in range(STEPS)]
            else:
                losses = [_eager(exe, main, feed, [loss.name])[0]
                          for _ in range(STEPS)]
            torch.cuda.synchronize()
            sides.append({
                'losses': losses,
                'state': {n: scope.find_var(n).clone() for n in names},
                'ran': {k: common.launches(k) + common.replayed(k)
                        for k in common.KERNELS},
                'stats': {k: v - before[k] for k, v in _stats().items()}})
    eager, graphed = sides
    assert graphed['stats'] == {'graph_captures': 1,
                                'graph_replays': STEPS - 1,
                                'graph_refused': 0, 'graph_stale': 0}
    for a, b in zip(eager['losses'], graphed['losses']):
        assert np.array_equal(a, b)
    assert np.isfinite(eager['losses']).all()
    for n in names:
        assert torch.equal(eager['state'][n], graphed['state'][n]), n
    assert graphed['ran'] == eager['ran']
    want = {'embedding_lookup': 2, 'embedding_scatter_add': 2,
            'fused_adam': 1, 'dropout': 1, 'dropout_grad': 1}
    assert eager['ran'] == {k: STEPS * want.get(k, 0)
                            for k in common.KERNELS}


def _decode(build):
    train = _program(_train)
    main, _, outs = _program(lambda: build(fluid, CFG, B, S))
    feed = {k: _batch(1)[k] for k in ('src', 'src_len')}
    fetch = [v.name for v in outs]
    exe, scope = fluid.Executor(fluid.CUDAPlace(0)), fluid.Scope()
    with fluid.scope_guard(scope):
        exe.run(train[1])
        before = _stats()
        eager = _eager(exe, main, feed, fetch)
        runs = [exe.run(main, feed=feed, fetch_list=fetch)
                for _ in range(3)]
        plan = exe._get_plan(main, feed, fetch)
    return eager, runs, plan, {k: v - before[k] for k, v in _stats().items()}


def test_beam_decode_replays_bitwise(dev):
    eager, runs, plan, stats = _decode(seq2seq.build_beam_decode)
    assert plan.no_graph is None
    assert stats['graph_captures'] == 1 and stats['graph_replays'] == 2
    for run in runs:
        for a, b in zip(eager, run):
            assert np.array_equal(a, b)


def test_host_read_while_is_refused_with_its_reason(dev):
    # the While reads its condition on the device now, in a WHILE node:
    # captured once, replayed twice, bitwise its eager host loop
    eager, runs, plan, stats = _decode(seq2seq.build_while_decode)
    assert plan.no_graph is None
    assert stats['graph_captures'] == 1 and stats['graph_replays'] == 2
    for run in runs:
        for a, b in zip(eager, run):
            assert np.array_equal(a, b)
