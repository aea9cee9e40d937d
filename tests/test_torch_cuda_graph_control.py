"""CUDA graph conditional nodes, pipelines and the in-graph finite check on
the card (fluid/cuda_graph.py, ops/kernels/graph_cond.py and
finite_check.py), at tiny sizes:

- a forward-only while replays as a WHILE node and a cond as an IF node
  (both branches from one graph), a cond inside a while as nested
  nodes, and a Switch learning-rate schedule over 5 training steps: each
  run bitwise its eager run, one capture, and the kernel's launches
  counted per trip;
- a branch that faults where it runs (a gather past the table's end)
  never runs while its condition is false: not at the first run, which
  builds it in a graph it throws away, nor in the replays; a cond that
  carries gradients, whose untaken branch is non-finite, keeps its unit
  eager and its steps bitwise and finite;
- the auto-bucketed while's steps replay after the device-side trip
  count, bitwise the eager steps;
- a pipeline around a host load: a load of new values in place is
  honoured by the next replay, a load that replaces the tensor makes the
  later unit's graph stale, which then runs eagerly and is captured
  again;
- a Print pipeline (``compile(allow_host=True)``) and a training
  CompiledStep replay bitwise their eager steps, the caller's state
  untouched;
- ``finite_check`` is bitwise its plain version on 1, 7 and 300 tensors
  of mixed dtypes; under FLAGS_check_nan_inf a replayed step launches it
  once and raises on an inf parameter naming the eager step's variables.

Marked `cuda`: every test skips where torch has no CUDA device.  Run on
a GPU machine with

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_*.py

This file imports torch and the port only.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import paddle_tpu_torch.fluid as fluid
from paddle_tpu_torch import weights
from paddle_tpu_torch.fluid import compile_cache
from paddle_tpu_torch.fluid import flags
from paddle_tpu_torch.ops.kernels import common
from paddle_tpu_torch.ops.kernels import finite_check

pytestmark = pytest.mark.cuda


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


def _stats():
    return {k: compile_cache.counter_value('executor/' + k)
            for k in ('graph_captures', 'graph_replays', 'graph_refused',
                      'graph_stale')}


def _eager(exe, program, feed, fetch, scope=None):
    plan = exe._get_plan(program, feed, fetch)
    return exe._run_graphed(plan, program, feed, fetch,
                            scope or fluid.global_scope(), True,
                            graphs=False)


def _loop():
    layers = fluid.layers
    x = layers.data('x', shape=[16], dtype='float32',
                    append_batch_size=False)
    n = layers.data('n', shape=[1], dtype='int64', append_batch_size=False)
    w = layers.create_parameter([16, 16], 'float32', name='w_loop')
    i = layers.fill_constant([1], 'int64', 0)
    acc = layers.fill_constant([1, 16], 'float32', 1.0)
    c = layers.less_than(i, n)
    wh = layers.While(c)
    with wh.block():
        h = layers.tanh(layers.matmul(acc, w))
        layers.assign(layers.elementwise_add(h, x), acc)
        layers.increment(i)
        layers.assign(layers.less_than(i, n), c)
    return [acc, i]


def _nested():
    layers = fluid.layers
    x = layers.data('x', shape=[16], dtype='float32',
                    append_batch_size=False)
    n = layers.data('n', shape=[1], dtype='int64', append_batch_size=False)
    two = layers.fill_constant([1], 'int64', 2)
    zero = layers.fill_constant([1], 'int64', 0)
    i = layers.fill_constant([1], 'int64', 0)
    acc = layers.fill_constant([16], 'float32', 1.0)
    c = layers.less_than(i, n)
    wh = layers.While(c)
    with wh.block():
        even = layers.equal(layers.elementwise_mod(i, two), zero)
        doubled = layers.cond(even, lambda: layers.scale(acc, scale=0.5),
                              lambda: layers.tanh(acc))
        layers.assign(layers.elementwise_add(doubled, x), acc)
        layers.increment(i)
        layers.assign(layers.less_than(i, n), c)
    return [acc, i]


def _replays_bitwise(build, feeds, runs=3):
    """Each feed `runs` times through Executor.run and once eagerly;
    returns (the graph stats moved, the kernels ran by the graph runs)."""
    main, startup, out = _program(build)
    fetch = [v.name for v in out]
    exe, scope = fluid.Executor(fluid.CUDAPlace(0)), fluid.Scope()
    with fluid.scope_guard(scope):
        exe.run(startup)
        before = _stats()
        common.reset_launches()
        for feed in feeds:
            want = _eager(exe, main, feed, fetch)
            for _ in range(runs):
                got = exe.run(main, feed=feed, fetch_list=fetch)
                for a, b in zip(want, got):
                    assert np.array_equal(a, b)
        ran = {k: common.launches(k) + common.replayed(k)
               for k in common.KERNELS}
    return {k: v - before[k] for k, v in _stats().items()}, ran


def test_while_node_replays_bitwise(dev):
    x = np.random.RandomState(0).randn(16).astype('float32') * 0.1
    feeds = [{'x': x, 'n': np.array([n], 'int64')} for n in (5, 0, 9)]
    stats, ran = _replays_bitwise(_loop, feeds[:1])
    assert stats == {'graph_captures': 1, 'graph_replays': 2,
                     'graph_refused': 0, 'graph_stale': 0}
    # the handle set before the node, then once at the end of each trip
    assert ran['graph_cond'] == 2 * (1 + 5)
    stats, _ = _replays_bitwise(_loop, feeds)
    assert stats['graph_captures'] == 1 and stats['graph_refused'] == 0


def test_if_node_takes_either_branch_from_one_graph(dev):
    def build():
        layers = fluid.layers
        x = layers.data('x', shape=[8], dtype='float32')
        s = layers.reduce_sum(x)
        zero = layers.fill_constant([1], 'float32', 0.0)
        return [layers.cond(layers.greater_than(s, zero),
                            lambda: layers.scale(x, scale=2.0),
                            lambda: layers.tanh(x))]
    rng = np.random.RandomState(1)
    pos = np.abs(rng.randn(4, 8)).astype('float32')
    stats, ran = _replays_bitwise(build, [{'x': pos}, {'x': -pos},
                                          {'x': pos}])
    assert stats['graph_captures'] == 1 and stats['graph_refused'] == 0
    assert stats['graph_replays'] == 8 and ran['graph_cond'] > 0


def test_nested_cond_in_while(dev):
    x = np.random.RandomState(2).randn(16).astype('float32')
    stats, ran = _replays_bitwise(
        _nested, [{'x': x, 'n': np.array([5], 'int64')}])
    assert stats['graph_captures'] == 1 and stats['graph_refused'] == 0
    # a replay: the WHILE's handle 1 + 5 times, the IF's 5 times
    assert ran['graph_cond'] == 2 * (1 + 5 + 5)


def _lr_train():
    layers = fluid.layers
    x = layers.data('x', shape=[8], dtype='float32')
    loss = layers.mean(layers.fc(x, 4))
    lr = layers.create_global_var(shape=[1], value=0.0, dtype='float32',
                                  persistable=True, name='sched_lr')
    gs = layers.learning_rate_scheduler._global_step_counter()
    switch = layers.Switch()
    with switch.case(gs < 3):
        layers.assign(1e-2 * (gs / 3), lr)
    with switch.default():
        layers.assign(layers.polynomial_decay(1e-2, 5, 0.0, 1.0), lr)
    fluid.optimizer.Adam(lr).minimize(loss)
    return [loss, lr]


def _steps(build, feed, steps, graphs):
    main, startup, out = _program(build)
    fetch = [v.name for v in out]
    names = weights.startup_names(startup)
    exe, scope = fluid.Executor(fluid.CUDAPlace(0)), fluid.Scope()
    got, states = [], []
    with fluid.scope_guard(scope):
        exe.run(startup)
        for _ in range(steps):
            got.append(exe.run(main, feed=feed, fetch_list=fetch) if graphs
                       else _eager_step(exe, main, feed, fetch))
            states.append({n: scope.find_var(n).clone() for n in names})
    return got, states


def _eager_step(exe, main, feed, fetch):
    plan = exe._get_plan(main, feed, fetch)
    return exe._run_graphed(plan, main, feed, fetch, fluid.global_scope(),
                            True, graphs=False)


def test_switch_schedule_steps_replay_bitwise(dev):
    feed = {'x': np.random.RandomState(3).randn(4, 8).astype('float32')}
    before = _stats()
    graphed = _steps(_lr_train, feed, 5, True)
    assert _stats()['graph_captures'] == before['graph_captures'] + 1
    eager = _steps(_lr_train, feed, 5, False)
    for a, b in zip(graphed[0], eager[0]):
        assert all(np.array_equal(u, v) for u, v in zip(a, b))
    for a, b in zip(graphed[1], eager[1]):
        assert all(torch.equal(a[n], b[n]) for n in a)
    rates = [float(r[1].ravel()[0]) for r in graphed[0]]
    assert rates[0] == 0.0 and rates[2] > rates[1] > 0 and \
        rates[3] > rates[4]


def _bucket():
    layers = fluid.layers
    x = layers.data('x', shape=[2, 4], dtype='float32',
                    append_batch_size=False)
    x.stop_gradient = False
    w = layers.create_parameter([4], 'float32', name='w_b')
    i = layers.fill_constant([1], 'float32', 0)
    n = layers.fill_constant([1], 'float32', 3)
    acc = layers.fill_constant([2, 4], 'float32', 0.0)
    cond = layers.less_than(i, n)
    wh = layers.While(cond)
    with wh.block():
        layers.assign(layers.elementwise_add(
            layers.elementwise_mul(acc, w), x), acc)
        layers.increment(i)
        layers.assign(layers.less_than(i, n), cond)
    loss = layers.mean(acc)
    fluid.optimizer.SGD(0.1).minimize(loss)
    return [loss]


def test_bucketed_while_steps_replay_after_the_device_count(dev):
    feed = {'x': np.random.RandomState(4).randn(2, 4).astype('float32')}
    before = _stats()
    graphed = _steps(_bucket, feed, 4, True)
    moved = {k: v - before[k] for k, v in _stats().items()}
    assert moved['graph_refused'] == 0 and moved['graph_captures'] == 2
    eager = _steps(_bucket, feed, 4, False)
    for a, b in zip(graphed[1], eager[1]):
        assert all(torch.equal(a[n], b[n]) for n in a)


def _load_pipeline(path):
    def build():
        layers = fluid.layers
        x = layers.data('x', shape=[4], dtype='float32')
        y = layers.scale(x, scale=2.0)
        block = fluid.default_main_program().global_block()
        w = block.create_var(name='w_loaded', shape=[4, 4],
                             dtype='float32', persistable=True)
        block.append_op('load', inputs={}, outputs={'Out': [w]},
                        attrs={'file_path': path})
        return [layers.matmul(y, w)]
    return build


def test_a_load_between_units_is_honoured_and_a_new_tensor_is_stale(
        dev, tmp_path):
    path = str(tmp_path / 'w')
    rng = np.random.RandomState(5)
    x = rng.randn(3, 4).astype('float32')
    main, startup, (z,) = _program(_load_pipeline(path))
    exe, scope = fluid.Executor(fluid.CUDAPlace(0)), fluid.Scope()
    with fluid.scope_guard(scope):
        exe.run(startup)
        for k in range(3):
            w = rng.randn(4, 4).astype('float32')
            np.save(path + '.npy', w)
            got = exe.run(main, feed={'x': x}, fetch_list=[z])[0]
            np.testing.assert_allclose(got, (2 * x) @ w, rtol=1e-6)
        stale = _stats()['graph_stale']
        w64 = rng.randn(4, 4)
        np.save(path + '.npy', w64)      # f64: a new tensor in the scope
        exe.run(main, feed={'x': x}, fetch_list=[z])
        assert _stats()['graph_stale'] == stale + 1
        np.save(path + '.npy', w)
        got = exe.run(main, feed={'x': x}, fetch_list=[z])[0]
        np.testing.assert_allclose(got, (2 * x) @ w, rtol=1e-6)


def test_print_pipeline_and_training_compiled_step(dev, capsys):
    def build():
        x = fluid.layers.data('x', shape=[8], dtype='float32')
        loss = fluid.layers.mean(fluid.layers.fc(x, 4, act='relu'))
        fluid.optimizer.Adam(1e-2).minimize(loss)
        return [loss]
    feed = {'x': np.random.RandomState(6).randn(4, 8).astype('float32')}
    main, startup, (loss,) = _program(build)
    names = weights.startup_names(startup)
    exe, scope = fluid.Executor(fluid.CUDAPlace(0)), fluid.Scope()
    with fluid.scope_guard(scope):
        exe.run(startup)
        start = {n: scope.find_var(n).clone() for n in names}
        step = exe.compile(main, feed_names=['x'], fetch_names=[loss])
        state = {n: scope.find_var(n) for n in step.state_names}
        held = {n: v.clone() for n, v in state.items()}
        data = {n: scope.find_var(n) for n in step.input_names if n != 'x'}
        outs = []
        for k in range(4):
            outs.append(step(k + 1, state, dict(data, x=feed['x'])))
            state = {n: outs[-1].get(n, v) for n, v in state.items()}
        assert all(torch.equal(scope.find_var(n), held[n]) for n in held)
        before = _stats()
        want = []
        for k in range(4):
            exe._step = k
            want.append(_eager_step(exe, main, feed, [loss.name])[0])
        for o, w in zip(outs, want):
            assert np.array_equal(o[loss.name].cpu().numpy(), w)
        for n in step.state_names:
            assert torch.equal(state[n], scope.find_var(n)), n
        for n, v in start.items():
            scope.find_var(n).copy_(v)
    with fluid.program_guard(main):
        fluid.layers.Print(loss, message='loss')
    exe2, scope2 = fluid.Executor(fluid.CUDAPlace(0)), fluid.Scope()
    with fluid.scope_guard(scope2):
        exe2.run(startup)
        for n, v in start.items():
            scope2.find_var(n).copy_(v)
        pipe = exe2.compile(main, feed_names=['x'], fetch_names=[loss],
                            allow_host=True)
        capsys.readouterr()
        got = [pipe(feed)[0] for _ in range(4)]
        assert capsys.readouterr().out.count('loss') >= 4
    assert _stats()['graph_captures'] >= before['graph_captures'] + 1
    for a, b in zip(got, want):
        assert np.array_equal(a, b)


def _mixed(n, seed):
    g = torch.Generator().manual_seed(seed)
    out = []
    for k in range(n):
        dtype = (torch.float32, torch.bfloat16, torch.float16)[k % 3]
        size = (5, 0, 1, 16384, 16385, 70001)[k % 6]
        t = torch.randn(size, generator=g).to(dtype)
        if size and k % 4 == 1:
            t[(k * 7919) % size] = (float('inf'), float('nan'),
                                    -float('inf'))[k % 3]
        t = t.cuda()
        out.append(t[1:] if size > 2 and k % 5 == 2 else t)
    return out


@pytest.mark.parametrize('n', [1, 7, 300])
def test_finite_check_is_its_plain_version(dev, n):
    ts = _mixed(n, n)
    before = common.launches('finite_check')
    got = finite_check.finite_check(ts)
    want = finite_check.finite_check_plain(ts)
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), want.cpu())
    assert common.launches('finite_check') == before + 1


@pytest.fixture
def nan_check():
    flags.set_flags({'FLAGS_check_nan_inf': True})
    yield
    flags.set_flags({'FLAGS_check_nan_inf': False})


def test_nan_check_in_the_graph_raises_as_the_eager_step(dev, nan_check):
    def build():
        x = fluid.layers.data('x', shape=[8], dtype='float32')
        h = fluid.layers.fc(x, 4, bias_attr=False)
        return [h, fluid.layers.mean(fluid.layers.relu(h))]
    feed = {'x': np.abs(np.random.RandomState(7).randn(4, 8)).astype(
        'float32')}
    errs = []
    for graphs in (True, False):
        main, startup, out = _program(build)
        fetch = [v.name for v in out]
        exe, scope = fluid.Executor(fluid.CUDAPlace(0)), fluid.Scope()
        with fluid.scope_guard(scope):
            exe.run(startup)
            before = common.launches('finite_check') + \
                common.replayed('finite_check')
            for _ in range(3):
                exe.run(main, feed=feed, fetch_list=fetch) if graphs else \
                    _eager_step(exe, main, feed, fetch)
            assert common.launches('finite_check') + \
                common.replayed('finite_check') == before + 3
            w = main.all_parameters()[0].name
            scope.find_var(w).fill_(float('inf'))
            with pytest.raises(FloatingPointError) as e:
                exe.run(main, feed=feed, fetch_list=fetch) if graphs else \
                    _eager_step(exe, main, feed, fetch)
        errs.append(str(e.value).splitlines()[0])
    assert errs[0].split('(step')[0] == errs[1].split('(step')[0]


_FAULTING_BRANCH = """
import sys
import numpy as np
import paddle_tpu_torch.fluid as fluid
from paddle_tpu_torch.fluid import compile_cache
main, startup = fluid.Program(), fluid.Program()
with fluid.unique_name.guard(), fluid.program_guard(main, startup):
    layers = fluid.layers
    x = layers.data('x', shape=[4, 8], dtype='float32',
                    append_batch_size=False)
    idx = layers.data('idx', shape=[2], dtype='int64',
                      append_batch_size=False)
    flag = layers.data('flag', shape=[1], dtype='float32',
                       append_batch_size=False)
    zero = layers.fill_constant([1], 'float32', 0.0)
    out = layers.cond(layers.greater_than(flag, zero),
                      lambda: layers.gather(x, idx),
                      lambda: layers.slice(x, axes=[0], starts=[0],
                                           ends=[2]))
xv = np.arange(32, dtype='float32').reshape(4, 8)
feed = {'x': xv, 'idx': np.array([100, 200], 'int64'),
        'flag': np.array([float(sys.argv[1])], 'float32')}
exe = fluid.Executor(fluid.CUDAPlace(0))
with fluid.scope_guard(fluid.Scope()):
    exe.run(startup)
    for _ in range(4):
        got, = exe.run(main, feed=feed, fetch_list=[out.name])
        assert np.array_equal(got, xv[:2]), got
print('captures', compile_cache.counter_value('executor/graph_captures'),
      'replays', compile_cache.counter_value('executor/graph_replays'))
"""


def _faulting_branch(flag):
    """The faulting-branch program's 4 runs in a process of its own (a
    device-side assert ends the process's CUDA context)."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=root)
    return subprocess.run([sys.executable, '-c', _FAULTING_BRANCH,
                           str(flag)], cwd=root, env=env,
                          capture_output=True, text=True, timeout=600)


def test_an_untaken_branch_that_would_fault_never_runs(dev):
    taken = _faulting_branch(1.0)
    assert taken.returncode != 0     # the gather past the end faults
    untaken = _faulting_branch(-1.0)
    assert untaken.returncode == 0, untaken.stderr[-2000:]
    assert untaken.stdout.split()[-4:] == ['captures', '1', 'replays', '3']


def _guarded_log():
    layers = fluid.layers
    x = layers.data('x', shape=[8], dtype='float32')
    w = layers.create_parameter(
        [8], 'float32', name='w_guard',
        default_initializer=fluid.initializer.Constant(0.5))
    h = layers.elementwise_mul(x, w)
    zero = layers.fill_constant([1], 'float32', 0.0)
    out = layers.cond(layers.greater_than(layers.reduce_sum(h), zero),
                      lambda: layers.log(h),
                      lambda: layers.scale(h, scale=-1.0))
    loss = layers.mean(out)
    fluid.optimizer.SGD(0.1).minimize(loss)
    return [loss]


def test_a_cond_that_carries_gradients_keeps_its_unit_eager(dev):
    feed = {'x': -np.abs(np.random.RandomState(9).randn(4, 8)).astype(
        'float32') - 0.1}
    before = _stats()
    got, states = _steps(_guarded_log, feed, 4, True)
    moved = {k: v - before[k] for k, v in _stats().items()}
    want, eager = _steps(_guarded_log, feed, 4, False)
    for a, b in zip(got, want):
        assert np.array_equal(a[0], b[0])
    for a, b in zip(states, eager):
        assert all(torch.equal(a[n], b[n]) for n in a)
        assert all(torch.isfinite(a[n]).all() for n in a)
    assert moved['graph_captures'] == 0
    main, _, out = _program(_guarded_log)
    plan = fluid.Executor(fluid.CUDAPlace(0))._get_plan(
        main, feed, [out[0].name])
    assert 'carries gradients' in plan.no_graph
