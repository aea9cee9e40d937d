"""The core slice on the card (ops/{math,activation,tensor,optimizer,
misc}_ops.py, the optimizer classes, models/mobilenet_v3.py):

- where_index (capacity-padded) in a program replayed from a CUDA
  graph: no host read, the replay bitwise the eager run and the CPU;
- cholesky and inverse (the _ex forms: no host sync) captured;
- MobileNetV3 TINY with RMSProp + L2 + EMA: step 3 replayed from its
  graph, bitwise the same step run eagerly from the same state;
- Lookahead's gated sync and ModelAverage's apply / restore around a
  captured step: the graph stays valid (apply / restore write into the
  scope's tensors), the replays bitwise eager.

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
from paddle_tpu_torch.fluid import compile_cache, core
from paddle_tpu_torch.models import lenet
from paddle_tpu_torch.models import mobilenet_v3 as mnv3

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')
    saved = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    yield torch.device('cuda', 0)
    torch.backends.cudnn.deterministic = saved


def _graphs():
    return {k: compile_cache.counter_value('executor/' + k)
            for k in ('graph_captures', 'graph_replays', 'graph_refused')}


def _eager(exe, program, feed, fetch):
    names = [getattr(f, 'name', f) for f in fetch]
    plan = exe._get_plan(program, feed, names)
    return exe._run_graphed(plan, program, feed, names, fluid.global_scope(),
                            True, graphs=False)


def _forward(build, feed):
    """(the card's 3 runs from the graph path, its eager run, the CPU's
    run, graph counter moves) of a forward program."""
    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        fetch = build()
    out = {}
    for key, place in (('card', fluid.CUDAPlace(0)),
                       ('cpu', fluid.CPUPlace())):
        with fluid.scope_guard(fluid.Scope()):
            exe = fluid.Executor(place)
            exe.run(startup)
            before = _graphs()
            runs = [exe.run(main, feed=feed, fetch_list=fetch)
                    for _ in range(3)]
            moved = {k: v - before[k] for k, v in _graphs().items()}
            out[key] = (runs, _eager(exe, main, feed, fetch), moved)
    return out


def test_where_index_replays_without_a_host_read(dev):
    def build():
        x = fluid.layers.data('x', [64], dtype='float32')
        cond = fluid.layers.greater_than(x, fluid.layers.zeros_like(x))
        helper = fluid.layer_helper.LayerHelper('where_index')
        idx = helper.create_variable_for_type_inference('int64')
        helper.append_op('where_index', inputs={'Condition': cond},
                         outputs={'Out': idx}, attrs={'capacity': 600})
        return [idx]
    x = np.random.RandomState(0).randn(16, 64).astype('float32')
    out = _forward(build, {'x': x})
    runs, eager, moved = out['card']
    assert moved['graph_captures'] == 1 and moved['graph_replays'] == 2
    want = np.argwhere(x > 0)
    for r in runs + [eager, out['cpu'][1]]:
        got = np.asarray(r[0])
        assert got.shape == (600, 2)
        np.testing.assert_array_equal(got[:len(want)], want)
        assert (got[len(want):] == -1).all()


def test_linalg_ops_capture(dev):
    def build():
        a = fluid.layers.data('a', [8, 8], dtype='float32',
                              append_batch_size=False)
        helper = fluid.layer_helper.LayerHelper('linalg')
        chol = helper.create_variable_for_type_inference('float32')
        inv = helper.create_variable_for_type_inference('float32')
        helper.append_op('cholesky', inputs={'X': a}, outputs={'Out': chol})
        helper.append_op('inverse', inputs={'Input': a},
                         outputs={'Output': inv})
        return [chol, inv]
    r = np.random.RandomState(1).randn(8, 8)
    a = (r @ r.T + 8 * np.eye(8)).astype('float32')
    out = _forward(build, {'a': a})
    runs, eager, moved = out['card']
    assert moved['graph_captures'] == 1 and moved['graph_refused'] == 0
    for r in runs[1:]:
        for g, w in zip(r, eager):
            np.testing.assert_array_equal(g, w)
    for g, w in zip(eager, out['cpu'][1]):
        np.testing.assert_allclose(g, w, rtol=1e-5,
                                   atol=1e-5 * np.abs(w).max())


def _train_three(main, startup, loss, feeds):
    """Three steps on the card through Executor.run (step 3 a replay),
    then step 3 again eagerly from the state before it: (replayed loss
    and state, eager loss and state)."""
    names = weights.startup_names(startup)
    with fluid.scope_guard(fluid.Scope()):
        scope = fluid.global_scope()
        exe = fluid.Executor(fluid.CUDAPlace(0))
        exe.run(startup)
        for feed in feeds[:2]:
            exe.run(main, feed=feed, fetch_list=[loss])
        before = {n: core.as_array(scope.find_var(n)).clone() for n in names}
        step = exe._step
        moved = _graphs()
        replay = exe.run(main, feed=feeds[2], fetch_list=[loss])[0]
        moved = {k: v - moved[k] for k, v in _graphs().items()}
        after = {n: core.as_array(scope.find_var(n)).clone() for n in names}
        for n, v in before.items():
            core.as_array(scope.find_var(n)).copy_(v)
        exe._step = step
        eager = _eager(exe, main, feeds[2], [loss])[0]
        again = {n: core.as_array(scope.find_var(n)) for n in names}
    assert moved['graph_replays'] == 1 and moved['graph_refused'] == 0
    return (replay, after), (eager, again)


def _assert_bitwise(a, b):
    np.testing.assert_array_equal(a[0], b[0])
    for n in a[1]:
        assert torch.equal(a[1][n], b[1][n]), n


def test_mobilenet_v3_tiny_replays_bitwise_eager(dev):
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = 5
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        _, _, loss, _ = mnv3.build_train(fluid, mnv3.TINY)
    rng = np.random.RandomState(0)
    feeds = [mnv3.synthetic_batch(mnv3.TINY, rng)] * 3
    replay, eager = _train_three(main, startup, loss, feeds)
    _assert_bitwise(replay, eager)
    assert any(n.endswith('.ema') and replay[1][n].abs().max() > 0
               for n in replay[1])


def _lenet(opt):
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = 3
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        _, _, loss, _ = lenet.build()
        extra = opt(fluid.optimizer, loss)
    r = np.random.RandomState(2)
    feeds = [{'img': r.randn(8, 1, 28, 28).astype('float32'),
              'label': r.randint(0, 10, (8, 1)).astype('int64')}
             for _ in range(3)]
    return main, startup, loss, feeds, extra


def test_lookahead_replays_bitwise_eager(dev):
    """k = 3: the replayed step 3 is the sync step."""
    main, startup, loss, feeds, _ = _lenet(
        lambda o, loss: o.LookaheadOptimizer(o.SGD(0.01), k=3).minimize(
            loss))
    replay, eager = _train_three(main, startup, loss, feeds)
    _assert_bitwise(replay, eager)


def test_model_average_apply_restore_keep_the_graph(dev):
    main, startup, loss, feeds, avg = _lenet(
        lambda o, loss: (o.Momentum(0.01, 0.9).minimize(loss),
                         o.ModelAverage(0.15))[1])
    params = [p.name for p in main.all_parameters() if p.trainable]
    with fluid.scope_guard(fluid.Scope()):
        scope = fluid.global_scope()
        exe = fluid.Executor(fluid.CUDAPlace(0))
        exe.run(startup)
        for feed in feeds:
            exe.run(main, feed=feed, fetch_list=[loss])
        ptrs = [core.as_array(scope.find_var(n)).data_ptr() for n in params]
        base = {n: core.as_array(scope.find_var(n)).clone() for n in params}
        with avg.apply():
            for n in params:
                assert not torch.equal(core.as_array(scope.find_var(n)),
                                       base[n])
        assert ptrs == [core.as_array(scope.find_var(n)).data_ptr()
                        for n in params]
        for n in params:
            assert torch.equal(core.as_array(scope.find_var(n)), base[n])
        before = _graphs()
        exe.run(main, feed=feeds[0], fetch_list=[loss])
        moved = {k: v - before[k] for k, v in _graphs().items()}
    assert moved['graph_replays'] == 1 and moved['graph_captures'] == 0
