"""Control flow in the port against the JAX package, on the CPU: while
(forward only, bounded and masked with gradients, unbounded with the
auto-bucket), cond / conditional_block with gradients, case,
switch_case, Switch, IfElse, StaticRNN, DynamicRNN and the tensor
arrays, each program built by one function with either package's
`fluid` and run from the JAX package's startup state
(torch_program_cases).  The counterparts of tests/test_control_flow_grad.py
hold the port to the same analytic values as the JAX package's tests
and to the JAX package itself.

Tolerance: 1e-5 of each value's largest magnitude (rtol 1e-5 too), for
the f32 sums of a loop computed in another order (XLA's against
PyTorch's); integer and boolean values bitwise.  The per-op grad path
(while_grad run again from the saved entries) and the whole-program
grad (autograd through the loop as it ran) agree within the same 1e-5.
"""

import numpy as np
import pytest

import paddle_tpu_torch.fluid as tfluid
from paddle_tpu_torch.fluid import executor as texecutor

from torch_program_cases import (assert_runs_close, build_both, run_both,
                                 same_program)

TOL = 1e-5
WV = 1.5


def _while_prog(fluid, max_trip_count=4, fetch_acc_grad=False):
    layers = fluid.layers
    x = layers.data('x', shape=[2, 4], dtype='float32',
                    append_batch_size=False)
    x.stop_gradient = False
    w = layers.create_parameter(
        [4], 'float32', name='w_loop',
        default_initializer=fluid.initializer.Constant(WV))
    i = layers.fill_constant([1], 'float32', 0)
    n = layers.fill_constant([1], 'float32', 3)
    acc = layers.fill_constant([2, 4], 'float32', 0.0)
    cond = layers.less_than(i, n)
    wh = layers.While(cond, max_trip_count=max_trip_count)
    with wh.block():
        t = layers.elementwise_mul(acc, w)
        layers.assign(layers.elementwise_add(t, x), acc)
        layers.increment(i)
        layers.assign(layers.less_than(i, n), cond)
    loss = layers.mean(acc)
    fluid.backward.append_backward(loss)
    gmap = fluid.default_main_program()._grad_name_map
    fetch = [loss, gmap['x'], gmap['w_loop']]
    return fetch + [gmap[acc.name]] if fetch_acc_grad else fetch


def _x(seed):
    return np.random.RandomState(seed).randn(2, 4).astype('float32')


def _plan(main, fetch):
    return texecutor._build_plan(main, [getattr(v, 'name', v)
                                        for v in fetch])


@pytest.mark.parametrize('max_trip_count', [4, None])
def test_while_grad_analytic(max_trip_count):
    # acc_{k+1} = acc_k * w + x, acc_0 = 0, 3 trips: acc_3 = x (w^2+w+1)
    progs = build_both(lambda f: _while_prog(f, max_trip_count))
    same_program(progs['jax'][0], progs['torch'][0])
    xv = _x(0)
    out = run_both(progs, [{'x': xv}])
    assert_runs_close(out, TOL)
    loss, dx, dw = out['torch'][0]
    k = WV ** 2 + WV + 1
    np.testing.assert_allclose(loss, (xv * k).mean(), rtol=1e-5)
    np.testing.assert_allclose(dx, np.full((2, 4), k / 8), rtol=1e-5)
    np.testing.assert_allclose(dw, (xv * (2 * WV + 1)).sum(0) / 8,
                               rtol=1e-4)
    plan = _plan(progs['torch'][0], progs['torch'][2])
    assert plan.kind == 'wpg'
    if max_trip_count is None:
        # the auto-bucket's count of 3 trips rounded up to 4, on the
        # forward while and its grad
        ops = progs['torch'][0].global_block().ops
        assert [o.attrs['max_trip_count'] for o in ops
                if o.type in ('while', 'while_grad')] == [4, 4]


def test_while_grad_numeric():
    progs = build_both(_while_prog)
    main, startup, fetch = progs['torch']
    xv = _x(1)
    with tfluid.scope_guard(tfluid.Scope()):
        exe = tfluid.Executor(tfluid.CPUPlace())
        exe.run(startup)
        _, dx = exe.run(main, feed={'x': xv}, fetch_list=fetch[:2])
        eps = 1e-3
        for idx in [(0, 0), (1, 2)]:
            xp, xm = xv.copy(), xv.copy()
            xp[idx] += eps
            xm[idx] -= eps
            lp, = exe.run(main, feed={'x': xp}, fetch_list=fetch[:1])
            lm, = exe.run(main, feed={'x': xm}, fetch_list=fetch[:1])
            np.testing.assert_allclose(dx[idx], (lp - lm) / (2 * eps),
                                       rtol=2e-2, atol=1e-4)


def test_while_grad_per_op_path_matches_whole_program_grad():
    """Fetching the loop state's own gradient keeps the step off the
    whole-program grad: while_grad runs the masked loop again from the
    saved entries under autograd, with the same gradients."""
    progs = build_both(lambda f: _while_prog(f, 4, fetch_acc_grad=True))
    plan = _plan(progs['torch'][0], progs['torch'][2])
    assert plan.kind == 'per_op'
    out = run_both(progs, [{'x': _x(2)}])
    assert_runs_close(out, TOL)
    wpg = run_both(build_both(_while_prog), [{'x': _x(2)}])
    for got, want in zip(out['torch'][0][:3], wpg['torch'][0]):
        np.testing.assert_allclose(got, want, rtol=TOL, atol=1e-7)


def test_while_grad_unbounded_data_dependent_trips():
    """The trip count depends on a fed value: each step counts its trips,
    runs the bucket that covers them, and never truncates."""
    def build(fluid):
        layers = fluid.layers
        x = layers.data('x', shape=[2, 4], dtype='float32',
                        append_batch_size=False)
        x.stop_gradient = False
        n = layers.data('n', shape=[1], dtype='float32',
                        append_batch_size=False)
        i = layers.fill_constant([1], 'float32', 0)
        acc = layers.fill_constant([2, 4], 'float32', 0.0)
        cond = layers.less_than(i, n)
        wh = layers.While(cond)
        with wh.block():
            layers.assign(layers.elementwise_add(
                layers.scale(acc, scale=0.5), x), acc)
            layers.increment(i)
            layers.assign(layers.less_than(i, n), cond)
        loss = layers.mean(acc)
        fluid.backward.append_backward(loss)
        return [loss, fluid.default_main_program()._grad_name_map['x']]

    xv = _x(1)
    trips = (3, 4, 7, 2, 16)
    out = run_both(build_both(build), [
        {'x': xv, 'n': np.array([float(t)], 'float32')} for t in trips])
    assert_runs_close(out, TOL)
    for t, (lossv, dx) in zip(trips, out['torch']):
        s = sum(0.5 ** j for j in range(t))
        np.testing.assert_allclose(lossv, (xv * s).mean(), rtol=1e-5)
        np.testing.assert_allclose(dx, np.full((2, 4), s / 8), rtol=1e-5)


def test_while_grad_unbounded_write_only_carry():
    """A body that writes a parent variable it never reads: its value
    before the loop is still the carry's entry."""
    def build(fluid):
        layers = fluid.layers
        x = layers.data('x', shape=[2, 4], dtype='float32',
                        append_batch_size=False)
        x.stop_gradient = False
        i = layers.fill_constant([1], 'float32', 0)
        n = layers.fill_constant([1], 'float32', 3)
        acc = layers.fill_constant([2, 4], 'float32', 0.0)
        y = layers.fill_constant([2, 4], 'float32', 0.0)
        cond = layers.less_than(i, n)
        wh = layers.While(cond)
        with wh.block():
            layers.assign(layers.elementwise_add(acc, x), acc)
            layers.assign(layers.scale(acc, scale=2.0), y)
            layers.increment(i)
            layers.assign(layers.less_than(i, n), cond)
        loss = layers.elementwise_add(layers.mean(acc), layers.mean(y))
        fluid.backward.append_backward(loss)
        return [loss, fluid.default_main_program()._grad_name_map['x']]

    xv = _x(2)
    out = run_both(build_both(build), [{'x': xv}])
    assert_runs_close(out, TOL)
    lossv, dx = out['torch'][0]
    np.testing.assert_allclose(lossv, 9 * xv.mean(), rtol=1e-5)
    np.testing.assert_allclose(dx, np.full((2, 4), 9 / 8.0), rtol=1e-5)


def test_while_early_exit_masking():
    # 8 masked trips for 3 real ones: the extra trips add nothing
    progs = build_both(lambda f: _while_prog(f, 8))
    out = run_both(progs, [{'x': np.ones((2, 4), 'float32')}])
    assert_runs_close(out, TOL)
    k = WV ** 2 + WV + 1
    np.testing.assert_allclose(out['torch'][0][0], k, rtol=1e-5)
    np.testing.assert_allclose(out['torch'][0][1], np.full((2, 4), k / 8),
                               rtol=1e-5)


def test_while_truncation_poisons_with_nan():
    progs = build_both(lambda f: _while_prog(f, 2))
    out = run_both(progs, [{'x': np.ones((2, 4), 'float32')}])
    for key in ('jax', 'torch'):
        assert not np.isfinite(out[key][0][0]).all(), key


def _cond_prog(fluid, pred_value):
    layers = fluid.layers
    x = layers.data('x', shape=[2, 4], dtype='float32',
                    append_batch_size=False)
    x.stop_gradient = False
    w = layers.create_parameter(
        [4], 'float32', name='w_cond',
        default_initializer=fluid.initializer.Constant(2.0))
    pred = layers.fill_constant([1], 'bool', pred_value)
    out = layers.cond(
        pred, lambda: layers.elementwise_mul(layers.scale(x, scale=3.0), w),
        lambda: layers.elementwise_mul(x, w))
    loss = layers.mean(out)
    fluid.backward.append_backward(loss)
    gmap = fluid.default_main_program()._grad_name_map
    return [loss, gmap['x'], gmap['w_cond']]


@pytest.mark.parametrize('pred_value', [True, False])
def test_cond_grad(pred_value):
    progs = build_both(lambda f: _cond_prog(f, pred_value))
    same_program(progs['jax'][0], progs['torch'][0])
    xv = _x(2)
    out = run_both(progs, [{'x': xv}])
    assert_runs_close(out, TOL)
    k = 3.0 if pred_value else 1.0
    np.testing.assert_allclose(out['torch'][0][0], (k * xv * 2.0).mean(),
                               rtol=1e-5)
    np.testing.assert_allclose(out['torch'][0][1], np.full((2, 4), k / 4),
                               rtol=1e-5)


def test_while_training_parity_with_unrolled():
    """A layers.While training loop gives the losses of the same program
    unrolled, and the JAX package's."""
    steps = 3

    def build(use_while):
        def fn(fluid):
            layers = fluid.layers
            x = layers.data('x', shape=[4, 6], dtype='float32',
                            append_batch_size=False)
            y = layers.data('y', shape=[4, 6], dtype='float32',
                            append_batch_size=False)
            w = layers.create_parameter(
                [6, 6], 'float32', name='w_rnn',
                default_initializer=fluid.initializer.Constant(0.05))
            h = layers.fill_constant([4, 6], 'float32', 0.0)
            if use_while:
                i = layers.fill_constant([1], 'float32', 0)
                n = layers.fill_constant([1], 'float32', steps)
                cond = layers.less_than(i, n)
                wh = layers.While(cond, max_trip_count=steps + 1)
                with wh.block():
                    layers.assign(layers.tanh(layers.elementwise_add(
                        layers.matmul(h, w), x)), h)
                    layers.increment(i)
                    layers.assign(layers.less_than(i, n), cond)
            else:
                for _ in range(steps):
                    h = layers.tanh(layers.elementwise_add(
                        layers.matmul(h, w), x))
            d = layers.elementwise_sub(h, y)
            loss = layers.mean(layers.elementwise_mul(d, d))
            fluid.optimizer.SGD(0.5).minimize(loss)
            return [loss]
        return fn

    rng = np.random.RandomState(7)
    feed = {'x': rng.randn(4, 6).astype('float32'),
            'y': rng.randn(4, 6).astype('float32')}
    looped = run_both(build_both(build(True)), [feed] * 5)
    unrolled = run_both(build_both(build(False)), [feed] * 5)
    assert_runs_close(looped, TOL)
    got = [r[0] for r in looped['torch']]
    np.testing.assert_allclose(got, [r[0] for r in unrolled['torch']],
                               rtol=1e-5)
    assert got[-1] < got[0]


def test_while_forward_nested_and_arrays():
    """A forward-only while (its condition read each trip) holding a
    nested while, writing a tensor array at its counter; array_read,
    array_length after it."""
    def build(fluid):
        layers = fluid.layers
        x = layers.data('x', shape=[3], dtype='float32',
                        append_batch_size=False)
        arr = layers.create_array('float32')
        i = layers.fill_constant([1], 'int64', 0)
        n = layers.fill_constant([1], 'int64', 4)
        acc = layers.assign(x)
        layers.array_write(acc, i, array=arr)
        cond = layers.less_than(i, n)
        outer = layers.While(cond)
        with outer.block():
            j = layers.fill_constant([1], 'int64', 0)
            m = layers.fill_constant([1], 'int64', 2)
            c2 = layers.less_than(j, m)
            inner = layers.While(c2)
            with inner.block():
                layers.assign(layers.scale(acc, scale=0.5, bias=1.0), acc)
                layers.increment(j)
                layers.assign(layers.less_than(j, m), c2)
            layers.increment(i)
            layers.array_write(acc, i, array=arr)
            layers.assign(layers.less_than(i, n), cond)
        two = layers.fill_constant([1], 'int64', 2)
        return [acc, layers.array_read(arr, two), arr, i]

    progs = build_both(build)
    same_program(progs['jax'][0], progs['torch'][0])
    # the forward-only whiles become WHILE nodes in a capture
    assert _plan(progs['torch'][0], progs['torch'][2]).no_graph is None
    out = run_both(progs, [{'x': np.array([1., -2., 8.], 'float32')}])
    assert_runs_close(out, TOL)
    acc, row2, arr, i = out['torch'][0]
    assert int(i[0]) == 4 and arr.shape == (64, 3)
    np.testing.assert_allclose(row2, arr[2])


def test_capture_plans_name_what_reads_the_host():
    """A bounded while and an auto-bucketed one (counted on the device
    before the step) may be captured; a conditional_block that carries
    gradients (a graph would run its untaken branch) and a host op in a
    loop body keep their unit off CUDA graphs, named."""
    bounded = build_both(lambda f: _while_prog(f, 4))['torch']
    assert _plan(bounded[0], bounded[2]).no_graph is None
    bucket = build_both(lambda f: _while_prog(f, None))['torch']
    plan = _plan(bucket[0], bucket[2])
    assert plan.no_graph is None and len(plan.buckets) == 1
    assert [k for k, _ in plan.items] == ['segment', 'bucket', 'segment']
    cond = build_both(lambda f: _cond_prog(f, True))['torch']
    why = _plan(cond[0], cond[2]).no_graph
    assert 'conditional_block' in why and 'carries gradients' in why

    def printing(fluid):
        layers = fluid.layers
        i = layers.fill_constant([1], 'int64', 0)
        n = layers.fill_constant([1], 'int64', 3)
        c = layers.less_than(i, n)
        wh = layers.While(c)
        with wh.block():
            layers.Print(i, message='trip')
            layers.increment(i)
            layers.assign(layers.less_than(i, n), c)
        return [i]
    main, _, fetch = build_both(printing)['torch']
    why = _plan(main, fetch).no_graph
    assert 'host op print inside its body' in why and 'while' in why


def test_case_and_switch_case():
    def build(fluid):
        layers = fluid.layers
        k = layers.data('k', shape=[1], dtype='int64',
                        append_batch_size=False)
        x = layers.data('x', shape=[3], dtype='float32',
                        append_batch_size=False)
        one = layers.fill_constant([1], 'int64', 1)
        two = layers.fill_constant([1], 'int64', 2)
        out_case = layers.case(
            [(layers.less_than(k, one), lambda: layers.scale(x, 2.0)),
             (layers.less_than(k, two), lambda: layers.scale(x, 3.0))],
            default=lambda: layers.scale(x, 4.0))
        out_switch = layers.switch_case(
            k, {0: lambda: layers.scale(x, -1.0),
                2: lambda: layers.scale(x, 10.0)},
            default=lambda: layers.exp(x))
        return [out_case, out_switch]

    xv = np.array([0.5, -1.0, 2.0], 'float32')
    progs = build_both(build)
    same_program(progs['jax'][0], progs['torch'][0])
    out = run_both(progs, [{'k': np.array([v], 'int64'), 'x': xv}
                           for v in (0, 1, 2, 3)])
    assert_runs_close(out, TOL)
    np.testing.assert_allclose(out['torch'][2][0], 4.0 * xv)
    np.testing.assert_allclose(out['torch'][2][1], 10.0 * xv)


def test_switch_piecewise():
    """Switch's cases in order, the first that holds wins (the
    learning-rate schedules' builder)."""
    def build(fluid):
        layers = fluid.layers
        step = layers.data('step', shape=[1], dtype='float32',
                           append_batch_size=False)
        lr = layers.fill_constant([1], 'float32', 0.0)
        b1 = layers.fill_constant([1], 'float32', 10.0)
        b2 = layers.fill_constant([1], 'float32', 20.0)
        sw = layers.Switch()
        with sw.case(layers.less_than(step, b1)):
            layers.assign(layers.fill_constant([1], 'float32', 1.0), lr)
        with sw.case(layers.less_than(step, b2)):
            layers.assign(layers.fill_constant([1], 'float32', 0.5), lr)
        with sw.default():
            layers.assign(layers.fill_constant([1], 'float32', 0.1), lr)
        return [lr]

    out = run_both(build_both(build), [
        {'step': np.array([s], 'float32')} for s in (3., 15., 40.)])
    assert_runs_close(out, TOL)
    assert [float(r[0][0]) for r in out['torch']] == \
        [1.0, 0.5, np.float32(0.1)]


def test_ifelse_rows():
    def build(fluid):
        layers = fluid.layers
        x = layers.data('x', shape=[4], dtype='float32')
        x.stop_gradient = False
        zero = layers.fill_constant([1], 'float32', 0.0)
        c = layers.greater_than(layers.reduce_sum(x, dim=[1], keep_dim=True),
                                zero)
        ie = layers.IfElse(c)
        with ie.true_block():
            ie.output(layers.fc(ie.input(x), 3, act='tanh'))
        with ie.false_block():
            ie.output(layers.fc(ie.input(x), 3))
        out = ie()[0]
        loss = layers.mean(out)
        fluid.backward.append_backward(loss)
        return [out, fluid.default_main_program()._grad_name_map['x']]

    rng = np.random.RandomState(3)
    out = run_both(build_both(build),
                   [{'x': rng.randn(5, 4).astype('float32')}])
    assert_runs_close(out, TOL)


def _rnn_prog(fluid, dynamic):
    layers = fluid.layers
    x = layers.data('x', shape=[5, 3], dtype='float32')
    x.stop_gradient = False
    h0 = layers.data('h0', shape=[4], dtype='float32')
    h0.stop_gradient = False
    rnn = layers.DynamicRNN() if dynamic else layers.StaticRNN()
    with (rnn.block() if dynamic else rnn.step()):
        xt = rnn.step_input(x)
        mem = rnn.memory(init=h0)
        h = layers.fc(layers.concat([xt, mem], axis=1), 4, act='tanh')
        rnn.update_memory(mem, h)
        rnn.step_output(h)
    hs = rnn()
    loss = layers.mean(hs)
    fluid.backward.append_backward(loss)
    gmap = fluid.default_main_program()._grad_name_map
    return [hs, loss, gmap['x'], gmap['h0']]


@pytest.mark.parametrize('dynamic', [False, True])
def test_static_and_dynamic_rnn(dynamic):
    progs = build_both(lambda f: _rnn_prog(f, dynamic))
    same_program(progs['jax'][0], progs['torch'][0])
    rng = np.random.RandomState(4)
    out = run_both(progs, [{'x': rng.randn(2, 5, 3).astype('float32'),
                            'h0': rng.randn(2, 4).astype('float32')}])
    assert_runs_close(out, TOL)
    assert out['torch'][0][0].shape == (2, 5, 4)


def test_conditional_block_without_gradient_and_is_empty():
    """A conditional_block that carries no gradient (its outputs keep
    their values when Cond is false), beside is_empty."""
    def build(fluid):
        layers = fluid.layers
        x = layers.data('x', shape=[3], dtype='float32',
                        append_batch_size=False)
        flag = layers.data('flag', shape=[1], dtype='bool',
                           append_batch_size=False)
        y = layers.assign(x)
        cb = layers.ConditionalBlock(flag)
        with cb.block():
            layers.assign(layers.scale(x, 5.0), y)
        return [y, layers.is_empty(x)]

    xv = np.array([1., 2., 3.], 'float32')
    out = run_both(build_both(build), [
        {'x': xv, 'flag': np.array([f])} for f in (True, False)])
    assert_runs_close(out, TOL)
    np.testing.assert_allclose(out['torch'][0][0], 5 * xv)
    np.testing.assert_allclose(out['torch'][1][0], xv)
    assert not out['torch'][0][1]
