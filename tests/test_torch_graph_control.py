"""Control flow without host reads (fluid/executor.py, fluid/cuda_graph.py),
on the CPU: what the CUDA graph conditional nodes and the device-side
auto-bucket stand on, against the JAX package.

- a learning rate that PaddlePaddle LARK's BERT ``linear_warmup_decay``
  writes with ``fluid.layers.Switch`` (linear warmup over 3 steps, then
  ``polynomial_decay`` to 0) steps across the warmup boundary as the JAX
  package's same program does (rel 1e-7) and as the numpy formula says;
- forward-only, auto-bucketed and bounded whiles, conditional_blocks
  (Switch, cond, case, IfElse) and host ops give no capture refusal; a
  host op inside a loop body is refused by name (``_host_control``); a
  failure at a conditional node is raised, any other capture failure
  kept as the reason (``cuda_graph._refused``);
- the auto-bucket's trip count before the step
  (``Executor._count_trips``) stamps the JAX package's bucket, and
  writes nothing to the scope;
- the loop-state buffers of a WHILE node (``cuda_graph._assign_carry``)
  take a swap of two carries and refuse a shape change; a nested
  cond-in-while program nests two levels (``control_depth``) and runs
  as the JAX package's; the first run's warm-up of a false branch
  changes no result.

The nodes themselves need a card: tests/test_torch_cuda_graph_control.py.
"""

import numpy as np
import pytest

import jax  # noqa: F401  (JAX on the CPU, as the conftest pins it)

import paddle_tpu.fluid as jfluid

import torch

import paddle_tpu_torch.fluid as tfluid
from paddle_tpu_torch import weights
from paddle_tpu_torch.fluid import cuda_graph
from paddle_tpu_torch.fluid import executor as texecutor
from paddle_tpu_torch.ops.kernels import graph_cond

from torch_program_cases import assert_runs_close, build_both, run_both

PEAK, WARMUP, TOTAL = 1e-4, 3, 10


def linear_warmup_decay(fluid, learning_rate, warmup_steps,
                        num_train_steps):
    """PaddlePaddle LARK's BERT optimization.py ``linear_warmup_decay``
    (Switch over the global step).  The extra read of the rate before
    the Switch makes it an input of the JAX package's segment, whose
    conditional_block carries only the loop state an op read first."""
    layers = fluid.layers
    lr = layers.create_global_var(shape=[1], value=0.0, dtype='float32',
                                  persistable=True,
                                  name='scheduled_learning_rate')
    layers.scale(lr, scale=1.0)
    global_step = layers.learning_rate_scheduler._global_step_counter()
    switch = layers.Switch()
    with switch.case(global_step < warmup_steps):
        layers.assign(learning_rate * (global_step / warmup_steps), lr)
    with switch.default():
        layers.assign(layers.polynomial_decay(
            learning_rate=learning_rate, decay_steps=num_train_steps,
            end_learning_rate=0.0, power=1.0, cycle=False), lr)
    return lr


def _lr_prog(fluid):
    x = fluid.layers.data('x', shape=[4], dtype='float32')
    loss = fluid.layers.mean(fluid.layers.fc(x, 1))
    lr = linear_warmup_decay(fluid, PEAK, WARMUP, TOTAL)
    fluid.optimizer.SGD(lr).minimize(loss)
    return [lr, loss]


def _numpy_rate(step):
    """The rate of 1-based step `step` in float32: the global step is
    step - 1."""
    gs = np.float32(step - 1)
    if gs < WARMUP:
        return np.float32(PEAK) * (gs / np.float32(WARMUP))
    frac = np.float32(min(gs, TOTAL)) * np.float32(1.0 / TOTAL)
    return np.float32(1.0) - frac


def test_switch_learning_rate_crosses_the_warmup_boundary():
    progs = build_both(_lr_prog)
    feeds = [{'x': np.full((2, 4), 0.5, 'float32')}] * 6
    out = run_both(progs, feeds)
    rates = {k: [float(np.asarray(step[0]).ravel()[0]) for step in v]
             for k, v in out.items()}
    np.testing.assert_allclose(rates['torch'], rates['jax'], rtol=1e-7)
    for k, got in enumerate(rates['torch'][:WARMUP]):
        assert got == float(_numpy_rate(k + 1))
    for k in range(WARMUP, 6):
        np.testing.assert_allclose(rates['torch'][k],
                                   PEAK * float(_numpy_rate(k + 1)),
                                   rtol=1e-6)
    r = rates['torch']
    assert r[0] < r[1] < r[2] and r[3] > r[4] > r[5]
    main = progs['torch'][0]
    plan = texecutor._build_plan(main, [v.name for v in progs['torch'][2]])
    assert plan.no_graph is None
    assert sum(op.type == 'conditional_block'
               for op in main.global_block().ops) == 2


def _while_prog(fluid, max_trip_count=None, grad=True):
    layers = fluid.layers
    x = layers.data('x', shape=[2, 4], dtype='float32',
                    append_batch_size=False)
    x.stop_gradient = False
    w = layers.create_parameter(
        [4], 'float32', name='w_loop',
        default_initializer=fluid.initializer.Constant(1.5))
    i = layers.fill_constant([1], 'float32', 0)
    n = layers.fill_constant([1], 'float32', 3)
    acc = layers.fill_constant([2, 4], 'float32', 0.0)
    cond = layers.less_than(i, n)
    wh = layers.While(cond, max_trip_count=max_trip_count)
    with wh.block():
        layers.assign(layers.elementwise_add(
            layers.elementwise_mul(acc, w), x), acc)
        layers.increment(i)
        layers.assign(layers.less_than(i, n), cond)
    loss = layers.mean(acc)
    if grad:
        fluid.backward.append_backward(loss)
    return [loss]


def _cond_prog(fluid):
    layers = fluid.layers
    x = layers.data('x', shape=[4], dtype='float32')
    s = layers.reduce_sum(x)
    zero = layers.fill_constant([1], 'float32', 0.0)
    return [layers.cond(layers.greater_than(s, zero),
                        lambda: layers.scale(x, scale=2.0),
                        lambda: layers.scale(x, scale=-1.0))]


def _nested_prog(fluid):
    """A cond inside a forward-only while: acc doubles on even trips,
    then adds x."""
    layers = fluid.layers
    x = layers.data('x', shape=[4], dtype='float32',
                    append_batch_size=False)
    i = layers.fill_constant([1], 'int64', 0)
    n = layers.fill_constant([1], 'int64', 5)
    two = layers.fill_constant([1], 'int64', 2)
    zero = layers.fill_constant([1], 'int64', 0)
    acc = layers.fill_constant([4], 'float32', 1.0)
    c = layers.less_than(i, n)
    wh = layers.While(c)
    with wh.block():
        even = layers.equal(layers.elementwise_mod(i, two), zero)
        doubled = layers.cond(even, lambda: layers.scale(acc, scale=2.0),
                              lambda: layers.scale(acc, scale=1.0))
        layers.assign(layers.elementwise_add(doubled, x), acc)
        layers.increment(i)
        layers.assign(layers.less_than(i, n), c)
    return [acc, i]


def _plan(progs):
    main, _, fetch = progs['torch']
    return texecutor._build_plan(main, [getattr(v, 'name', v)
                                        for v in fetch])


@pytest.mark.parametrize('case', ['forward_while', 'bucket_while',
                                  'bounded_while', 'cond', 'nested',
                                  'switch'])
def test_no_capture_refusal_without_host_reads(case):
    build = {'forward_while': lambda f: _while_prog(f, None, grad=False),
             'bucket_while': lambda f: _while_prog(f, None),
             'bounded_while': lambda f: _while_prog(f, 4),
             'cond': _cond_prog, 'nested': _nested_prog,
             'switch': _lr_prog}[case]
    plan = _plan(build_both(build))
    assert plan.no_graph is None
    assert all(u.no_graph is None for u in plan.units if not u.host)


def test_a_host_op_in_a_loop_body_is_refused_by_name():
    def build(fluid):
        layers = fluid.layers
        x = layers.data('x', shape=[4], dtype='float32')
        y = layers.scale(x, scale=2.0)
        layers.Print(y, message='top')      # a host unit: no refusal
        i = layers.fill_constant([1], 'int64', 0)
        n = layers.fill_constant([1], 'int64', 2)
        c = layers.less_than(i, n)
        wh = layers.While(c)
        with wh.block():
            layers.Print(i, message='trip')
            layers.increment(i)
            layers.assign(layers.less_than(i, n), c)
        return [layers.scale(y, scale=3.0), i]
    plan = _plan(build_both(build))
    device = [u for u in plan.units if not u.host]
    why = [u.no_graph for u in device if u.no_graph]
    assert len(why) == 1 and 'op while' in why[0] and \
        'host op print inside its body' in why[0]
    assert plan.no_graph == why[0] or len(device) > 1
    assert texecutor._host_control(
        [op for op in plan.ops if op.type == 'while'][0]) == why[0]


def test_bucket_count_stamps_the_jax_packages_bucket():
    progs = build_both(lambda f: _while_prog(f, None))
    xv = np.random.RandomState(0).randn(2, 4).astype('float32')
    out = run_both(progs, [{'x': xv}])
    assert_runs_close(out, 1e-5)
    jbucket = [op.attrs['max_trip_count'] for op in
               progs['jax'][0].global_block().ops if op.type == 'while']
    main, startup, fetch = progs['torch']
    plan = texecutor._build_plan(main, [v.name for v in fetch])
    for op in plan.buckets:
        op.attrs['max_trip_count'] = None
    exe = tfluid.Executor(tfluid.CPUPlace())
    scope = tfluid.Scope()
    with tfluid.scope_guard(scope):
        exe.run(startup)
        before = {n: scope.find_var(n).clone()
                  for n in weights.startup_names(startup)}
        trips = exe._count_trips(plan, main, {'x': xv}, scope,
                                 exe._step + 1)
        assert all(torch.equal(scope.find_var(n), v)
                   for n, v in before.items())
    assert trips == [3]
    assert [cuda_graph._bucket(t) for t in trips] == jbucket == [4]


def test_carry_buffers_take_a_swap_and_refuse_a_shape_change():
    a, b = torch.arange(3.0), torch.arange(3.0) + 10
    bufs = cuda_graph._carry_buffers({'a': a, 'b': b})
    cuda_graph._assign_carry(bufs, {'a': bufs['b'], 'b': bufs['a']})
    assert torch.equal(bufs['a'], b) and torch.equal(bufs['b'], a)
    same = bufs['a']
    cuda_graph._assign_carry(bufs, {'a': same * 2, 'b': bufs['b']})
    assert bufs['a'] is same and torch.equal(same, b * 2)
    with pytest.raises(RuntimeError, match='changes its shape'):
        cuda_graph._assign_carry(bufs, {'a': torch.zeros(4)})


def test_nested_cond_in_while_runs_as_the_jax_package():
    progs = build_both(_nested_prog)
    out = run_both(progs, [{'x': np.array([1., -2., 0.5, 3.], 'float32')}])
    assert_runs_close(out, 1e-6)
    acc, i = out['torch'][0]
    want = np.ones(4, 'float32')
    for k in range(5):
        want = want * (2.0 if k % 2 == 0 else 1.0) + \
            np.array([1., -2., 0.5, 3.], 'float32')
    np.testing.assert_array_equal(acc, want)
    assert int(np.asarray(i).ravel()[0]) == 5
    main = progs['torch'][0]
    assert cuda_graph.control_depth(main, main.global_block().ops) == 2


def test_warming_a_false_branch_changes_no_result():
    """The first run's warm-up never runs the untaken branch (on the card
    it captures it into a graph it throws away; on the CPU it has
    nothing to build)."""
    main, startup, fetch = build_both(_cond_prog)['torch']
    names = [v.name for v in fetch]
    outs, bodies = [], []
    for warm in (False, True):
        exe = tfluid.Executor(tfluid.CPUPlace())
        ran = []
        body = exe._body
        exe._body = lambda sub, *a: ran.append(sub) or body(sub, *a)
        with tfluid.scope_guard(tfluid.Scope()):
            exe.run(startup)
            exe._warm_branches = warm
            outs.append([exe.run(main, feed={'x': -np.ones((2, 4),
                                                           'float32')},
                                 fetch_list=names)[0]])
        bodies.append(len(ran))
    np.testing.assert_array_equal(outs[0][0], outs[1][0])
    np.testing.assert_array_equal(outs[0][0], np.ones((2, 4), 'float32'))
    # the true branch is the conditional_block's (the false one runs
    # inline before it): untaken either way
    assert bodies == [0, 0]


def test_condition_kinds_cover_the_condition_ops():
    """Every dtype a condition op writes (the compare and logical ops'
    bool, a float or int counter) has a kind the kernel reads."""
    for dtype in (torch.bool, torch.int32, torch.int64, torch.float32,
                  torch.float64, torch.float16, torch.bfloat16,
                  torch.uint8, torch.int8):
        assert dtype in graph_cond._KINDS
    with pytest.raises(graph_cond.ConditionalNodeError, match='on the card'):
        graph_cond.set_cond(0, torch.ones(1, dtype=torch.bool))


def test_a_conditional_node_failure_is_raised_not_run_eagerly():
    """A capture that fails at a conditional node raises: the card has
    no fallback to the host loop.  Any other failure is kept as the
    reason and the signature runs eagerly."""
    with pytest.raises(graph_cond.ConditionalNodeError, match='12.3'):
        cuda_graph._refused(graph_cond.ConditionalNodeError(
            'conditional nodes need CUDA 12.3'))
    why = cuda_graph._refused(RuntimeError('operation not permitted when '
                                           'stream is capturing'))
    assert why.startswith('the capture failed: RuntimeError: operation')


def test_the_jax_package_keeps_the_bucket_item():
    """The JAX package counts the bucket between its segments; the port
    keeps the item in its split and runs both sides as one unit."""
    jmain, _, jfetch = build_both(lambda f: _while_prog(f, None))['jax']
    items = jfluid.Executor(jfluid.CPUPlace())._get_plan(
        jmain, ('x',), tuple(v.name for v in jfetch))
    kinds = [it[0] if isinstance(it, tuple) else 'segment' for it in items]
    plan = _plan(build_both(lambda f: _while_prog(f, None)))
    assert [k for k, _ in plan.items] == kinds
    assert [u.host for u in plan.units] == [False]
