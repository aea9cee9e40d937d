"""The port's host ops (ops/host_ops.py) and the executor's handling of
them (fluid/executor.py) against the JAX package's, on the CPU.

- save, save_combine, load, load_combine, print and py_func inside
  Programs run by both packages' executors: save writes the JAX
  package's ``.npy`` bytes; save_combine the JAX package's ``.npz``
  members byte for byte (the zip headers carry the write time, so the
  members are compared); the loads, print's output and py_func's
  results equal the JAX package's (elementwise f32 ops only, so
  bitwise);
- the read-only host ops are deferred past later device ops in the
  order the JAX executor defers them, so a print between the forward
  and the backward keeps the whole-program grad, whose gradients are
  then bitwise the program's without the print;
- a plan holding a host op is never captured in a CUDA graph, and the
  refusal names the op; Executor.compile still refuses such a program,
  naming the ROADMAP item where CompiledPipeline waits.
"""

import os
import zipfile

import numpy as np
import pytest

import jax  # noqa: F401  (JAX on the CPU, as the conftest pins it)

import paddle_tpu.fluid as jfluid

import paddle_tpu_torch.fluid as tfluid
from paddle_tpu_torch.fluid import executor as texecutor

X = np.random.RandomState(0).randn(4, 3).astype('float32')


def _program(fluid, body):
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = 1
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        x = fluid.layers.data('x', shape=[3], dtype='float32')
        out = body(fluid, main.global_block(), x)
    return main, startup, out


def _run(fluid, main, startup, fetch, feed=None):
    with fluid.scope_guard(fluid.Scope()):
        exe = fluid.Executor(fluid.CPUPlace())
        exe.run(startup)
        return [np.asarray(v) for v in exe.run(
            main, feed={'x': X} if feed is None else feed,
            fetch_list=fetch)]


def _both(tmp_path, body, fetch_names):
    out = {}
    for fluid in (jfluid, tfluid):
        d = str(tmp_path / fluid.__name__)
        main, startup, res = _program(fluid, lambda f, b, x: body(f, b, x,
                                                                  d))
        out[fluid] = (d, _run(fluid, main, startup, fetch_names(res)))
    return out[jfluid], out[tfluid]


def _save_body(fluid, block, x, d):
    y = fluid.layers.scale(x, scale=2.0, bias=1.0)
    block.append_op('save', inputs={'X': [y]}, outputs={},
                    attrs={'file_path': os.path.join(d, 'sub', 'y')})
    return y


def test_save_writes_the_jax_packages_file(tmp_path):
    (jd, jout), (td, tout) = _both(tmp_path, _save_body, lambda y: [y])
    assert np.array_equal(tout[0], jout[0])
    with open(os.path.join(jd, 'sub', 'y.npy'), 'rb') as a, \
            open(os.path.join(td, 'sub', 'y.npy'), 'rb') as b:
        assert a.read() == b.read()


def _save_combine_body(fluid, block, x, d):
    y = fluid.layers.scale(x, scale=-3.0)
    block.append_op('save_combine', inputs={'X': [x, y]}, outputs={},
                    attrs={'file_path': os.path.join(d, 'both')})
    return y


def test_save_combine_writes_the_jax_packages_members(tmp_path):
    (jd, _), (td, _) = _both(tmp_path, _save_combine_body, lambda y: [y])
    with zipfile.ZipFile(os.path.join(jd, 'both.npz')) as a, \
            zipfile.ZipFile(os.path.join(td, 'both.npz')) as b:
        assert a.namelist() == b.namelist() == ['x.npy', 'scale_0.tmp_0.npy']
        for n in a.namelist():
            assert a.read(n) == b.read(n), n


@pytest.mark.parametrize('combined', [False, True])
def test_loads_read_what_the_jax_package_reads(tmp_path, combined):
    w = np.random.RandomState(1).randn(4, 3).astype('float32')
    path = str(tmp_path / 'w')
    if combined:
        np.savez(path + '.npz', w=w, v=-w)
    else:
        np.save(path + '.npy', w)
    got = []
    for fluid in (jfluid, tfluid):
        def body(f, block, x):
            wv = block.create_var(name='w', shape=[-1, 3], dtype='float32')
            vv = block.create_var(name='v', shape=[-1, 3], dtype='float32')
            if combined:
                block.append_op('load_combine', inputs={},
                                outputs={'Out': [wv, vv]},
                                attrs={'file_path': path},
                                infer_shape=False)
                return f.layers.elementwise_add(
                    f.layers.elementwise_add(x, wv), vv)
            f.layers.load(wv, path)
            return f.layers.elementwise_mul(x, wv)
        main, startup, out = _program(fluid, body)
        got.append(_run(fluid, main, startup, [out])[0])
    assert np.array_equal(got[0], got[1])


def test_print_prints_what_the_jax_package_prints(capsys):
    printed = []
    for fluid in (jfluid, tfluid):
        main, startup, out = _program(fluid, lambda f, b, x: f.layers.Print(
            f.layers.scale(x, scale=0.5), message='half:'))
        capsys.readouterr()
        got = _run(fluid, main, startup, [out])[0]
        printed.append(capsys.readouterr().out)
        assert np.array_equal(got, X * np.float32(0.5))
    assert printed[0] == printed[1]
    assert printed[1].startswith('half: scale_0.tmp_0 [[')


def test_py_func_gives_the_jax_packages_results():
    got = []
    for fluid in (jfluid, tfluid):
        def body(f, block, x):
            a = block.create_var(name='a', shape=[-1, 3], dtype='float32')
            b = block.create_var(name='b', shape=[-1, 3], dtype='float32')
            f.layers.py_func(lambda v: (np.tanh(v), v[::-1] * 2), x, [a, b])
            return f.layers.elementwise_add(a, b)
        main, startup, out = _program(fluid, body)
        got.append(_run(fluid, main, startup, [out, 'a'])[0:2])
    for j, t in zip(*got):
        assert np.array_equal(j, t)


def _train(fluid, with_print):
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = 4
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        x = fluid.layers.data('x', shape=[3], dtype='float32')
        h = fluid.layers.fc(x, size=5, act='relu')
        if with_print:
            h = fluid.layers.Print(h, message='h')
        loss = fluid.layers.mean(fluid.layers.fc(h, size=1))
        fluid.optimizer.SGD(0.5).minimize(loss)
    return main, startup, loss


def test_deferral_is_the_jax_executors_and_keeps_the_whole_program_grad(
        capsys):
    jmain, _, _ = _train(jfluid, True)
    tmain, tstart, tloss = _train(tfluid, True)
    jorder = [op.type for op in jfluid.Executor(
        jfluid.CPUPlace())._defer_readonly_host_ops(jmain.global_block().ops)]
    torder = [op.type for op in texecutor._defer_readonly_host_ops(
        tmain.global_block().ops)]
    assert torder == jorder and torder[-1] == 'print'
    assert [op.type for op in tmain.global_block().ops].index('print') < \
        torder.index('mean')
    grads = [tmain._grad_name_map[p.name] for p in tmain.all_parameters()]
    exe = tfluid.Executor(tfluid.CPUPlace())
    plan = exe._get_plan(tmain, {'x': X}, [tloss.name] + grads)
    assert plan.kind == 'wpg'
    # the deferred print is a host unit after the whole-program grad's
    assert plan.no_graph is None
    assert [u.host for u in plan.units] == [False, True]
    outs = []
    for main, start, loss in ((tmain, tstart, tloss), _train(tfluid, False)):
        assert [p.name for p in main.all_parameters()] == \
            [p.name for p in tmain.all_parameters()]
        capsys.readouterr()
        outs.append(_run(tfluid, main, start, [loss] + grads))
        printed = capsys.readouterr().out
        assert printed.count('h fc_0.tmp_2') == (1 if main is tmain else 0)
    for a, b in zip(*outs):
        assert np.array_equal(a, b)


def test_a_save_is_placed_before_the_op_that_rewrites_its_read():
    main, _, _ = _program(tfluid, lambda f, b, x: None)
    block = main.global_block()
    with tfluid.program_guard(main):
        y = tfluid.layers.scale(block.var('x'), scale=2.0)
        block.append_op('save', inputs={'X': [y]}, outputs={},
                        attrs={'file_path': 'y'})
        z = tfluid.layers.scale(block.var('x'), scale=3.0)
        block.append_op('assign', inputs={'X': [z]}, outputs={'Out': [y]})
        tfluid.layers.scale(z, scale=4.0)
    order = [op.type for op in texecutor._defer_readonly_host_ops(
        block.ops)]
    assert order == ['scale', 'scale', 'save', 'assign', 'scale']


def test_compile_refuses_host_ops_naming_where_the_pipeline_waits():
    main, startup, y = _program(tfluid, lambda f, b, x: f.layers.Print(
        f.layers.scale(x, scale=2.0)))
    exe = tfluid.Executor(tfluid.CPUPlace())
    pipe = exe.compile(main, ['x'], [y], allow_host=True)
    assert isinstance(pipe, texecutor.CompiledPipeline)
    assert pipe.host_op_types == ['print']
    with pytest.raises(ValueError, match='single-segment.*print'):
        exe.compile(main, ['x'], [y])
    plan = exe._get_plan(main, {'x': X}, [y.name])
    assert plan.kind == 'forward' and plan.no_graph is None
    assert [u.host for u in plan.units] == [False, True]
