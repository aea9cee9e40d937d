"""The port's segmented plans and CompiledPipeline (fluid/executor.py
``_plan_items``, ``_Unit``, ``CompiledPipeline``) and its training
CompiledStep against the JAX package's, on the CPU.

- the plan of a program with print, save / load, py_func, an
  auto-bucketed while or a forward-only while splits into the JAX
  package's segments: the same count and the same host op types in
  the same order (``Executor._get_plan``'s items);
- ``Executor.compile(allow_host=True)`` gives a CompiledPipeline whose
  fetches, printed text, saved files, run counters and errors are the
  JAX package's (ports of tests/test_fastpath.py:124, :272, :293,
  tests/test_control_flow_grad.py:208, tests/test_stub_closures.py:133
  and tests/test_health.py:371): floats within rel 1e-6, the rest
  exact; a fed name that an earlier segment rewrote is fed again to
  the next (the JAX package's feed precedence);
- a training CompiledStep of a 2-layer BERT takes 2 steps from the JAX
  package's startup state (``weights.numpy_state``) as the JAX
  CompiledStep does: losses within rel 1e-5, the state within 1e-5 of
  the state's largest magnitude, and the caller's state bitwise
  untouched.

On the CPU every unit runs eagerly; tests/test_torch_cuda_graph_control.py
replays the units from CUDA graphs on the card.
"""

import os

import numpy as np
import pytest

import jax  # noqa: F401  (JAX on the CPU, as the conftest pins it)

import paddle_tpu.fluid as jfluid
from paddle_tpu.fluid import executor as jexecutor
from paddle_tpu.fluid import monitor as jmonitor
from paddle_tpu.models import bert as jbert

import torch

import paddle_tpu_torch.fluid as tfluid
from paddle_tpu_torch import weights
from paddle_tpu_torch.fluid import executor as texecutor
from paddle_tpu_torch.fluid import monitor as tmonitor
from paddle_tpu_torch.fluid import trace as ttrace
from paddle_tpu_torch.models import bert as tbert

BOTH = (jfluid, tfluid)
XV = np.random.RandomState(1).randn(2, 4).astype('float32')


def _build(fluid, body, seed=2):
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = seed
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        out = body(fluid)
    return main, startup, out


def _print_prog(fluid):
    x = fluid.layers.data('x', shape=[4], dtype='float32')
    y = fluid.layers.scale(x, scale=2.0)
    fluid.layers.Print(y, message='y')
    return [fluid.layers.scale(y, scale=3.0)]


def _py_func_prog(fluid):
    x = fluid.layers.data('x', shape=[4], dtype='float32')
    y = fluid.layers.scale(x, scale=2.0)
    out = fluid.default_main_program().current_block().create_var(
        name='py_out', shape=[-1, 4], dtype='float32')
    fluid.layers.py_func(lambda a: a + 1.0, y, out)
    return [fluid.layers.scale(out, scale=3.0)]


def _save_load_prog(path):
    def body(fluid):
        x = fluid.layers.data('x', shape=[4], dtype='float32')
        y = fluid.layers.scale(x, scale=2.0)
        block = fluid.default_main_program().global_block()
        block.append_op('save', inputs={'X': [y]}, outputs={},
                        attrs={'file_path': path})
        # the load rewrites what the save read: the save runs first
        block.append_op('load', inputs={}, outputs={'Out': [y]},
                        attrs={'file_path': path})
        return [fluid.layers.elementwise_add(
            fluid.layers.scale(y, scale=3.0), x)]
    return body


def _while_prog(max_trip_count, grad=True):
    """acc_{k+1} = acc_k * w + x over 3 trips (the JAX package's
    tests/test_control_flow_grad.py program)."""
    def body(fluid):
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
            t = layers.elementwise_mul(acc, w)
            layers.assign(layers.elementwise_add(t, x), acc)
            layers.increment(i)
            layers.assign(layers.less_than(i, n), cond)
        loss = layers.mean(acc)
        if grad:
            fluid.backward.append_backward(loss)
        return [loss]
    return body


def _jax_items(main, feed, fetch):
    plan = jfluid.Executor(jfluid.CPUPlace())._get_plan(
        main, tuple(sorted(feed)), tuple(fetch))
    return [('segment',) if isinstance(it, jexecutor._Segment)
            else (it[0], it[1].type) for it in plan]


def _port_items(main, fetch):
    plan = texecutor._build_plan(main, list(fetch))
    return [('segment',) if kind == 'segment'
            else (kind, plan.ops[i].type) for kind, i in plan.items]


@pytest.mark.parametrize('case', ['print', 'save_load', 'py_func',
                                  'bucket_while', 'forward_while'])
def test_segment_split_is_the_jax_packages(case, tmp_path):
    body = {'print': _print_prog, 'py_func': _py_func_prog,
            'save_load': _save_load_prog(str(tmp_path / 'y')),
            'bucket_while': _while_prog(None),
            'forward_while': _while_prog(None, grad=False)}[case]
    items = []
    for fluid in BOTH:
        main, _, out = _build(fluid, body)
        fetch = [v.name for v in out]
        items.append(_jax_items(main, ['x'], fetch) if fluid is jfluid
                     else _port_items(main, fetch))
    assert items[0] == items[1]
    segments = sum(it == ('segment',) for it in items[1])
    # the print is deferred past the scale after it: one segment
    assert segments == {'print': 1, 'save_load': 2, 'py_func': 2,
                        'bucket_while': 2, 'forward_while': 1}[case]


def _pipe_steps(fluid, body, runs, feed=None, allow_host=True):
    main, startup, out = _build(fluid, body)
    exe = fluid.Executor(fluid.CPUPlace())
    with fluid.scope_guard(fluid.Scope()):
        exe.run(startup)
        pipe = exe.compile(main, feed_names=('x',),
                           fetch_names=[v.name for v in out],
                           allow_host=allow_host)
        got = [[np.asarray(v) for v in pipe(feed or {'x': XV})]
               for _ in range(runs)]
    return pipe, got


def test_py_func_pipeline_holds_the_jax_package():
    """tests/test_fastpath.py:124, its CompiledPipeline half: a py_func
    between two device segments."""
    out = {}
    for fluid in BOTH:
        pipe, got = _pipe_steps(fluid, _py_func_prog, 3)
        assert pipe.host_op_types == ['py_func']
        out[fluid] = got
    for j, t in zip(out[jfluid], out[tfluid]):
        np.testing.assert_allclose(t[0], j[0], rtol=1e-6)
    np.testing.assert_allclose(out[tfluid][-1][0], (XV * 2 + 1) * 3,
                               rtol=1e-6)


def test_save_then_load_between_segments(tmp_path):
    """A save and a load between two device segments: the file the
    port saved is the JAX package's, and the loaded value is used."""
    out, files = {}, {}
    for fluid in BOTH:
        path = str(tmp_path / fluid.__name__.split('.')[0])
        pipe, got = _pipe_steps(fluid, _save_load_prog(path), 2)
        assert pipe.host_op_types == ['save', 'load']
        out[fluid] = got
        files[fluid] = np.load(path + '.npy')
    np.testing.assert_array_equal(files[tfluid], files[jfluid])
    np.testing.assert_allclose(out[tfluid][-1][0], out[jfluid][-1][0],
                               rtol=1e-6)
    np.testing.assert_allclose(out[tfluid][-1][0], XV * 7, rtol=1e-6)


def _tiny_train(fluid):
    x = fluid.layers.data('x', shape=[4], dtype='float32')
    h = fluid.layers.fc(x, 8, act='relu')
    loss = fluid.layers.mean(fluid.layers.fc(h, 1))
    fluid.optimizer.SGD(0.1).minimize(loss)
    return [loss]


def test_device_resident_roundtrip_run_pipeline_saveload(tmp_path):
    """tests/test_fastpath.py:124: train through run, save a parameter
    through a save program, clobber it, load it back through a load
    program, and keep training."""
    losses, start = {}, None
    for fluid in BOTH:
        main, startup, (loss,) = _build(fluid, _tiny_train)
        pname = main.all_parameters()[0].name
        path = str(tmp_path / (fluid.__name__.split('.')[0] + '_w'))
        save_p, load_p = fluid.Program(), fluid.Program()
        save_p.global_block().append_op(
            'save', inputs={'X': [pname]}, attrs={'file_path': path})
        load_p.global_block().append_op(
            'load', outputs={'Out': [pname]}, attrs={'file_path': path})
        scope = fluid.Scope()
        with fluid.scope_guard(scope):
            exe = fluid.Executor(fluid.CPUPlace())
            exe.run(startup)
            if start is None:
                start = weights.numpy_state(
                    scope, weights.startup_names(startup))
            else:
                weights.load_numpy_params(scope, start, fluid.CPUPlace(),
                                          startup)
            feed = {'x': np.tile(XV, (2, 1))}
            for _ in range(2):
                exe.run(main, feed=feed, fetch_list=[])
            trained = np.asarray(fluid.core.as_array(
                scope.find_var(pname))).copy()
            exe.run(save_p)
            assert os.path.exists(path + '.npy')
            scope.set_var(pname, np.zeros(trained.shape, 'float32'))
            exe.run(load_p)
            np.testing.assert_array_equal(
                np.asarray(fluid.core.as_array(scope.find_var(pname))),
                trained)
            losses[fluid] = float(np.asarray(exe.run(
                main, feed=feed, fetch_list=[loss])[0]).ravel()[0])
    assert np.isfinite(losses[tfluid])
    np.testing.assert_allclose(losses[tfluid], losses[jfluid], rtol=1e-6)


def test_compiled_pipeline_records_run_counters():
    """tests/test_fastpath.py:272."""
    for fluid, mon in ((jfluid, jmonitor), (tfluid, tmonitor)):
        main, startup, out = _build(fluid, _print_prog)
        exe = fluid.Executor(fluid.CPUPlace())
        with fluid.scope_guard(fluid.Scope()):
            pipe = exe.compile(main, feed_names=('x',),
                               fetch_names=[out[0].name], allow_host=True)
            calls0 = mon.counter_value('executor/run_calls')
            secs0 = (mon.histogram_value('executor/run_seconds') or
                     {'count': 0})['count']
            pipe({'x': XV})
            pipe({'x': XV})
            assert mon.counter_value('executor/run_calls') == calls0 + 2
            assert mon.histogram_value(
                'executor/run_seconds')['count'] == secs0 + 2


def test_fed_state_shared_across_segments_is_fed_again():
    """tests/test_fastpath.py:293: a fed name each of two segments
    increments starts from the fed value in each (feed precedence), so
    the second increment sees 0, not the first segment's write."""
    def body(fluid):
        c = fluid.layers.data('c', shape=[4], dtype='float32')
        c.stop_gradient = True
        fluid.layers.increment(c, value=1.0)
        probe = fluid.default_main_program().current_block().create_var(
            name='host_probe', shape=[-1, 4], dtype='float32')
        fluid.layers.py_func(lambda a: a, c, probe)
        fluid.layers.increment(c, value=2.0)
        return [c]
    out = {}
    for fluid in BOTH:
        main, startup, (c,) = _build(fluid, body)
        exe = fluid.Executor(fluid.CPUPlace())
        with fluid.scope_guard(fluid.Scope()):
            for _ in range(2):
                got, = exe.run(main, feed={'c': np.zeros((1, 4),
                                                         'float32')},
                               fetch_list=[c])
        out[fluid] = np.asarray(got)
    np.testing.assert_array_equal(out[tfluid], out[jfluid])
    np.testing.assert_array_equal(out[tfluid], 2.0)


def test_unbounded_while_compile_refusal_names_the_cause():
    """tests/test_control_flow_grad.py:208: the auto-bucketed while is
    named in the refusal, and allow_host=True compiles a pipeline with
    no host ops that advances the step once a call."""
    got = {}
    for fluid in BOTH:
        main, startup, (loss,) = _build(fluid, _while_prog(None))
        exe = fluid.Executor(fluid.CPUPlace())
        with pytest.raises(ValueError, match='max_trip_count'):
            exe.compile(main, feed_names=('x',), fetch_names=(loss.name,))
        pipe = exe.compile(main, feed_names=('x',),
                           fetch_names=(loss.name,), allow_host=True)
        assert pipe.host_op_types == []
        scope = fluid.Scope()
        with fluid.scope_guard(scope):
            exe.run(startup)
            step0 = exe._step
            got[fluid], = pipe({'x': XV}, scope=scope)
            assert exe._step == step0 + 1
    want = (XV * (1.5 ** 2 + 1.5 + 1)).mean()
    np.testing.assert_allclose(float(np.asarray(got[tfluid]).ravel()[0]),
                               want, rtol=1e-5)
    np.testing.assert_allclose(np.asarray(got[tfluid]),
                               np.asarray(got[jfluid]), rtol=1e-6)


def test_print_pipeline_prints_the_jax_packages_text(capsys):
    """tests/test_stub_closures.py:133: a print splits the program, the
    one-function compile refuses it naming the segments, the pipeline
    prints what the JAX package prints and fetches x * 6."""
    out, printed = {}, {}
    for fluid in BOTH:
        main, _, (z,) = _build(fluid, _print_prog)
        exe = fluid.Executor(fluid.CPUPlace())
        with pytest.raises(ValueError, match='single-segment'):
            exe.compile(main, feed_names=('x',), fetch_names=(z.name,))
        pipe = exe.compile(main, feed_names=('x',), fetch_names=(z.name,),
                           allow_host=True)
        assert pipe.host_op_types == ['print']
        capsys.readouterr()
        with fluid.scope_guard(fluid.Scope()):
            out[fluid], = pipe({'x': XV})
        printed[fluid] = capsys.readouterr().out
    np.testing.assert_allclose(np.asarray(out[tfluid]), XV * 6.0, rtol=1e-6)
    assert printed[tfluid] == printed[jfluid] and 'y' in printed[tfluid]


def test_pipeline_checks_name_the_cause():
    """Fetches the program does not write and feeds it does not read
    are refused with the JAX package's words."""
    for fluid in BOTH:
        main, _, (z,) = _build(fluid, _print_prog)
        exe = fluid.Executor(fluid.CPUPlace())
        with pytest.raises(ValueError, match='not produced by the program'):
            exe.compile(main, feed_names=('x',), fetch_names=('nope',),
                        allow_host=True)
        with pytest.raises(ValueError, match='not read by the program'):
            exe.compile(main, feed_names=('tpyo',), fetch_names=(z.name,),
                        allow_host=True)


def test_pipeline_dispatch_failure_dumps():
    """tests/test_health.py:371: a segment that fails dumps the flight
    recorder once."""
    def body(fluid):
        x = fluid.layers.data('x', shape=[8], dtype='float32')
        h = fluid.layers.fc(x, 8, act='relu')
        mid = fluid.default_main_program().current_block().create_var(
            name='hmid', shape=[-1, 8], dtype='float32')
        fluid.layers.py_func(lambda a: a, h, mid)
        return [fluid.layers.reduce_mean(fluid.layers.fc(mid, 4))]
    main, startup, (loss,) = _build(tfluid, body)
    ttrace.enable(buffer_steps=4)
    try:
        with tfluid.scope_guard(tfluid.Scope()):
            exe = tfluid.Executor(tfluid.CPUPlace())
            exe.run(startup)
            pipe = exe.compile(main, feed_names=['x'],
                               fetch_names=[loss.name], allow_host=True)
            d0 = tmonitor.counter_value('trace/dumps_written')
            with pytest.raises(Exception):
                pipe(feed={'x': np.ones((4, 7), 'float32')})
            assert tmonitor.counter_value('trace/dumps_written') == d0 + 1
    finally:
        ttrace.disable()
        ttrace.reset()


def test_print_in_a_training_step_keeps_its_numbers():
    """A print of the loss in a training step: a host unit after the
    whole-program grad's; the pipeline's steps are bitwise Executor.run's
    on the program without the print, and the JAX package's within rel
    1e-6."""
    def body(with_print):
        def build(fluid):
            x = fluid.layers.data('x', shape=[4], dtype='float32')
            h = fluid.layers.fc(x, 8, act='relu')
            loss = fluid.layers.mean(fluid.layers.fc(h, 1))
            if with_print:
                fluid.layers.Print(loss, message='loss')
            fluid.optimizer.SGD(0.1).minimize(loss)
            return [loss]
        return build
    feed = {'x': np.tile(XV, (2, 1))}
    out, start = {}, None
    for fluid, with_print in ((jfluid, True), (tfluid, True),
                              (tfluid, False)):
        main, startup, (loss,) = _build(fluid, body(with_print))
        exe = fluid.Executor(fluid.CPUPlace())
        with fluid.scope_guard(fluid.Scope()):
            exe.run(startup)
            names = weights.startup_names(startup)
            if start is None:
                start = weights.numpy_state(fluid.global_scope(), names)
            else:
                weights.load_numpy_params(fluid.global_scope(), start,
                                          fluid.CPUPlace(), startup)
            run = exe.compile(main, feed_names=('x',),
                              fetch_names=(loss.name,),
                              allow_host=True) if with_print else \
                (lambda f: exe.run(main, feed=f, fetch_list=[loss]))
            out[(fluid, with_print)] = [float(np.asarray(run(feed)[0]))
                                        for _ in range(3)]
    plan = texecutor._build_plan(main, [loss.name])
    assert plan.kind == 'wpg'
    assert out[(tfluid, True)] == out[(tfluid, False)]
    np.testing.assert_allclose(out[(tfluid, True)], out[(jfluid, True)],
                               rtol=1e-6)


def _bert(fluid, mod):
    cfg = mod.BertConfig(vocab_size=1000, hidden=64, layers=2, heads=4,
                         intermediate=128, max_pos=32, dropout=0.0,
                         attn_dropout=0.0)
    cfg.flash_min_len = 0
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = 7
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        _, _, loss = mod.build_pretrain(cfg, seq_len=32)
        fluid.optimizer.Adam(learning_rate=1e-3, epsilon=1e-6).minimize(loss)
    batch = mod.synthetic_batch(cfg, 2, 32, np.random.RandomState(0))
    return main, startup, loss, batch


def test_training_compiled_step_holds_the_jax_package():
    """2 calls of a 2-layer BERT's training CompiledStep, each from the
    state the last one returned, from the JAX package's startup state."""
    jmain, jstartup, jloss, batch = _bert(jfluid, jbert)
    tmain, tstartup, tloss, _ = _bert(tfluid, tbert)
    names = weights.startup_names(tstartup)
    feeds = list(batch)
    with jfluid.scope_guard(jfluid.Scope()):
        jexe = jfluid.Executor(jfluid.CPUPlace())
        jexe.run(jstartup)
        start = weights.numpy_state(jfluid.global_scope(), names)
        jstep = jexe.compile(jmain, feed_names=feeds,
                             fetch_names=[jloss.name])
        scope = jfluid.global_scope()
        state = {n: fluid_value(scope, n) for n in jstep.state_names}
        data = {n: fluid_value(scope, n) for n in jstep.input_names
                if n not in batch}
        jlosses = []
        for k in range(2):
            out = jstep(k + 1, state, dict(data, **batch))
            jlosses.append(float(np.asarray(out[jloss.name]).ravel()[0]))
            state = {n: out.get(n, v) for n, v in state.items()}
        jfinal = {n: np.asarray(v) for n, v in state.items()}
    with tfluid.scope_guard(tfluid.Scope()):
        texe = tfluid.Executor(tfluid.CPUPlace())
        texe.run(tstartup)
        scope = tfluid.global_scope()
        weights.load_numpy_params(scope, start, tfluid.CPUPlace(), tstartup)
        tstep = texe.compile(tmain, feed_names=feeds,
                             fetch_names=[tloss.name])
        assert sorted(tstep.state_names) == sorted(jstep.state_names)
        state = {n: scope.find_var(n) for n in tstep.state_names}
        data = {n: scope.find_var(n) for n in tstep.input_names
                if n not in batch}
        tlosses = []
        for k in range(2):
            held = {n: v.clone() for n, v in state.items()}
            out = tstep(k + 1, state, dict(data, **batch))
            assert all(torch.equal(state[n], held[n]) for n in state)
            tlosses.append(float(out[tloss.name].reshape(-1)[0]))
            state = {n: out.get(n, v) for n, v in state.items()}
    np.testing.assert_allclose(tlosses, jlosses, rtol=1e-5)
    scale = max(float(np.abs(v).max()) for v in jfinal.values())
    for n, v in jfinal.items():
        assert np.abs(state[n].numpy() - v).max() <= 1e-5 * scale, n


def fluid_value(scope, name):
    return jfluid.core.as_array(scope.find_var(name))
